"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy arrays for comparison.
"""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from stoix_tpu.ops import scan_kernels as jax_scan_kernels

# The port's CPU tests run torch on one intra-op thread. The suite runs
# several pytest-xdist workers side by side, and torch's default of one thread
# a core in each oversubscribes the host: one small learning run once took
# 438.6 s there against 16.7 s alone. Every torch test module imports this
# one, so the pin holds in every worker. `host_threads` gives a test back the
# host's default (ROADMAP C11's test of the multi-threaded float32 route).
HOST_THREADS = torch.get_num_threads()
torch.set_num_threads(1)


@contextlib.contextmanager
def host_threads():
    """Run the body at the host's default intra-op thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(HOST_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# The reference kernel spells its compiler params `pltpu.TPUCompilerParams`;
# newer JAX releases name the class `pltpu.CompilerParams`. Where only the new
# name exists, alias it once, at import, so the reference kernel runs in
# interpret mode unchanged. An alias held only around one call would make
# other tests of the process pass or fail by their order: the jitted kernel's
# trace is cached, and a later call at the same shapes reuses it.
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams


def pallas_interpret(w, d, init, block_t: int = 128) -> np.ndarray:
    """The JAX package's Pallas recurrence kernel in interpret mode, as
    tests/test_scan_kernels.py runs it on the CPU."""
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
    `flax_like` (numpy leaves, kernels transposed back to [in, out] and every
    leaf reshaped to its flax shape)."""
    from stoix_tpu_torch.utils.params import flax_path_to_torch

    def build(tree, prefix):
        out = {}
        for key, value in tree.items():
            path = prefix + (str(key),)
            if isinstance(value, dict):
                out[key] = build(value, path)
            else:
                name, is_kernel = flax_path_to_torch(path)
                array = params[name].detach().cpu().numpy()
                out[key] = (array.T if is_kernel else array).reshape(np.shape(value))
        return out

    if set(flax_like) == {"params"}:
        return {"params": build(flax_like["params"], ())}
    return build(flax_like, ())


def flax_window_networks(num_actions: int, window: int, num_layers: int, num_heads: int,
                         head_dim: int, ffn_dim: int):
    """The JAX package's ff_trans_ppo actor and critic (defined inside its
    `learner_setup`, stoix_tpu/systems/ppo/anakin/ff_trans_ppo.py:255-276),
    rebuilt here module for module so a test can init and apply them."""
    import flax.linen as nn

    from stoix_tpu.networks import heads as jheads
    from stoix_tpu.networks.attention import TransformerTorso

    def make_torso():
        return TransformerTorso(num_layers=num_layers, num_heads=num_heads, head_dim=head_dim,
                                ffn_dim=ffn_dim, max_timesteps=window)

    class WindowActor(nn.Module):
        @nn.compact
        def __call__(self, ctx):  # [..., W, F]
            x = make_torso()(ctx.reshape((-1,) + ctx.shape[-2:]))
            x = x[:, -1].reshape(ctx.shape[:-2] + (x.shape[-1],))
            return jheads.CategoricalHead(num_actions=num_actions)(x)

    class WindowCritic(nn.Module):
        @nn.compact
        def __call__(self, ctx):
            x = make_torso()(ctx.reshape((-1,) + ctx.shape[-2:]))
            x = x[:, -1].reshape(ctx.shape[:-2] + (x.shape[-1],))
            return jheads.ScalarCriticHead()(x)

    return WindowActor(), WindowCritic()


def paired_window_networks(obs_dim: int, num_actions: int, window: int = 4, num_layers: int = 2,
                           num_heads: int = 2, head_dim: int = 8, ffn_dim: int = 32,
                           seed: int = 0):
    """flax and torch window actor/critic pairs carrying IDENTICAL parameters:
    (jax_actor, jax_actor_params, jax_critic, jax_critic_params, torch_actor,
    torch_critic)."""
    import jax

    from stoix_tpu_torch.networks.attention import TransformerTorso
    from stoix_tpu_torch.networks.heads import CategoricalHead, ScalarCriticHead
    from stoix_tpu_torch.systems.ppo.anakin.ff_trans_ppo import WindowActor, WindowCritic
    from stoix_tpu_torch.utils.params import load_flax_params

    jax_actor, jax_critic = flax_window_networks(num_actions, window, num_layers, num_heads,
                                                 head_dim, ffn_dim)
    dummy = jax.numpy.zeros((1, window, obs_dim))
    actor_key, critic_key = jax.random.split(jax.random.PRNGKey(seed))
    actor_params = jax.tree.map(np.asarray, jax_actor.init(actor_key, dummy))
    critic_params = jax.tree.map(np.asarray, jax_critic.init(critic_key, dummy))

    def torso():
        return TransformerTorso(obs_dim, num_layers, num_heads, head_dim, ffn_dim, window)

    width = num_heads * head_dim
    torch_actor = WindowActor(torso(), CategoricalHead(num_actions, width))
    torch_critic = WindowCritic(torso(), ScalarCriticHead(width))
    load_flax_params(torch_actor, actor_params)
    load_flax_params(torch_critic, critic_params)
    return jax_actor, actor_params, jax_critic, critic_params, torch_actor, torch_critic


@contextlib.contextmanager
def fed_normals(draws):
    """Within the body, `jax.random.normal` returns the arrays of `draws`
    (numpy, consumed in call order) instead of drawing from its key: the JAX
    package's NoisyLinear then runs on the standard normals a test also gives
    the port. Under `jax.jit` the arrays enter as constants at trace time,
    where the calls happen in the same order."""
    import jax

    queue = list(draws)
    original = jax.random.normal

    def normal(key, shape=(), dtype=None):
        value = queue.pop(0)
        assert tuple(value.shape) == tuple(shape), (value.shape, shape)
        return jnp.asarray(value)

    jax.random.normal = normal
    try:
        yield queue
    finally:
        jax.random.normal = original


def noise_draws(module, seed: int):
    """(numpy draws for `fed_normals`, the same as the port's noise list) for
    the noisy layers of a port module, from a numpy seed."""
    from stoix_tpu_torch.networks.layers import noisy_layers

    rng = np.random.default_rng(seed)
    draws = [rng.normal(size=size).astype(np.float32) for layer in noisy_layers(module)
             for size in (layer.in_features, layer.features)]
    pairs = [(torch.from_numpy(draws[i]), torch.from_numpy(draws[i + 1]))
             for i in range(0, len(draws), 2)]
    return draws, pairs
