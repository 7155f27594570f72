"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy arrays for comparison.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from stoix_tpu.ops import scan_kernels as jax_scan_kernels


@contextlib.contextmanager
def _pallas_tpu_compiler_params() -> Iterator[None]:
    """The reference kernel spells its compiler params `pltpu.TPUCompilerParams`;
    newer JAX releases name the class `pltpu.CompilerParams`. Where only the
    new name exists, alias it for the duration of the call so the reference
    kernel runs in interpret mode unchanged."""
    missing = not hasattr(pltpu, "TPUCompilerParams")
    if missing:
        pltpu.TPUCompilerParams = pltpu.CompilerParams
    try:
        yield
    finally:
        if missing:
            del pltpu.TPUCompilerParams


def pallas_interpret(w, d, init, block_t: int = 128) -> np.ndarray:
    """The JAX package's Pallas recurrence kernel in interpret mode, as
    tests/test_scan_kernels.py runs it on the CPU."""
    with _pallas_tpu_compiler_params():
        out = jax_scan_kernels.pallas_linear_recurrence_reverse(
            jnp.asarray(w), jnp.asarray(d), jnp.asarray(init), block_t=block_t, interpret=True
        )
    return np.asarray(out.astype(jnp.float32) if out.dtype == jnp.bfloat16 else out)


def t(x, dtype=None) -> torch.Tensor:
    """A CPU tensor copy of a numpy (or JAX) array."""
    array = np.asarray(x)
    if array.dtype == jnp.bfloat16:
        return torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
    out = torch.from_numpy(array.copy())
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """A numpy float view of a torch tensor (bfloat16 widened to float32)."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def observations(seed: int, batch: int, obs_dim: int, num_actions: int, mask=None):
    """The same random Observation for both packages: (jax, torch)."""
    from stoix_tpu.envs.types import Observation as JaxObservation
    from stoix_tpu_torch.envs.types import Observation as TorchObservation

    rng = np.random.default_rng(seed)
    view = rng.normal(size=(batch, obs_dim)).astype(np.float32)
    action_mask = (
        np.ones((batch, num_actions), np.float32) if mask is None
        else np.broadcast_to(np.asarray(mask, np.float32), (batch, num_actions)).copy()
    )
    steps = np.zeros((batch,), np.int32)
    return (
        JaxObservation(jnp.asarray(view), jnp.asarray(action_mask), jnp.asarray(steps)),
        TorchObservation(t(view), t(action_mask), t(steps)),
    )


def paired_networks(
    obs_dim: int, num_actions: int, layer_sizes=(32, 32), use_layer_norm: bool = False,
    activation: str = "silu", seed: int = 0,
):
    """flax and torch actor/critic pairs carrying IDENTICAL parameters.

    Returns (jax_actor, jax_actor_params, jax_critic, jax_critic_params,
    torch_actor, torch_critic); the flax params are the flax init from `seed`,
    loaded into the torch modules with utils.params.load_flax_params."""
    import jax

    from stoix_tpu.networks import base as jbase, heads as jheads, inputs as jinputs
    from stoix_tpu.networks import torso as jtorso
    from stoix_tpu_torch.networks import base as tbase, heads as theads, inputs as tinputs
    from stoix_tpu_torch.networks import torso as ttorso
    from stoix_tpu_torch.utils.params import load_flax_params

    def jax_torso():
        return jtorso.MLPTorso(tuple(layer_sizes), activation=activation,
                               use_layer_norm=use_layer_norm)

    def torch_torso():
        return ttorso.MLPTorso(obs_dim, tuple(layer_sizes), activation=activation,
                               use_layer_norm=use_layer_norm)

    jax_actor = jbase.FeedForwardActor(
        action_head=jheads.CategoricalHead(num_actions=num_actions), torso=jax_torso(),
        input_layer=jinputs.ObservationInput(),
    )
    jax_critic = jbase.FeedForwardCritic(
        critic_head=jheads.ScalarCriticHead(), torso=jax_torso(),
        input_layer=jinputs.ObservationInput(),
    )
    dummy, _ = observations(0, 1, obs_dim, num_actions)
    actor_key, critic_key = jax.random.split(jax.random.PRNGKey(seed))
    actor_params = jax.tree.map(np.asarray, jax_actor.init(actor_key, dummy))
    critic_params = jax.tree.map(np.asarray, jax_critic.init(critic_key, dummy))

    hidden = int(layer_sizes[-1])
    torch_actor = tbase.FeedForwardActor(
        theads.CategoricalHead(num_actions, hidden), torch_torso(), tinputs.ObservationInput()
    )
    torch_critic = tbase.FeedForwardCritic(
        theads.ScalarCriticHead(hidden), torch_torso(), tinputs.ObservationInput()
    )
    load_flax_params(torch_actor, actor_params)
    load_flax_params(torch_critic, critic_params)
    return jax_actor, actor_params, jax_critic, critic_params, torch_actor, torch_critic


def to_flax_params(params, flax_like):
    """A port `{name: tensor}` parameter dict laid out as the flax tree
    `flax_like` (numpy leaves, kernels transposed back to [in, out])."""
    from stoix_tpu_torch.utils.params import flax_path_to_torch

    def build(tree, prefix):
        out = {}
        for key, value in tree.items():
            path = prefix + (str(key),)
            if isinstance(value, dict):
                out[key] = build(value, path)
            else:
                name, transpose = flax_path_to_torch(path)
                array = params[name].detach().cpu().numpy()
                out[key] = array.T if transpose else array
        return out

    if set(flax_like) == {"params"}:
        return {"params": build(flax_like["params"], ())}
    return build(flax_like, ())
