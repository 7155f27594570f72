"""Two SPO update epochs of the PyTorch port (stoix_tpu_torch/systems/spo/
ff_spo.py::SPOUpdate) at `update_batch_size` 1 and 2 against the JAX
package's own `_update_epoch` (from its learner's closure, under vmap over
"batch" and "data") on the same [B, L] sequences, with terminations and
truncations and the targets perturbed off the online params, on CartPole and
Pendulum at a small width: losses 1e-5 relative, params and duals 1e-5
absolute; one B1 GAE call an epoch (batch-major, every replica's batch)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.systems.spo import ff_spo as jax_spo
from stoix_tpu_torch import envs
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.spo import ff_spo
from test_torch_az import jax_learner, replica
from test_torch_continuous import _count_b1_calls
from test_torch_spo import ROOTS, SMALL, compose, port_networks
from torch_parity import n, t, to_flax_params


def sequences(seed, batch, seq_len, env, num_particles, continuous):
    """[B, L] stored SPO steps with terminations and truncations."""
    rng = np.random.default_rng(seed)
    lead = (batch, seq_len)
    template = env.observation_value()

    def obs():
        return {"agent_view": rng.normal(size=lead + tuple(template.agent_view.shape)
                                         ).astype(np.float32),
                "action_mask": np.ones(lead + tuple(template.action_mask.shape), np.float32),
                "step_count": np.zeros(lead, np.int32)}

    done = (rng.random(lead) < 0.1).astype(np.float32)
    weights = rng.random(lead + (num_particles,)).astype(np.float32)
    if continuous:
        width = int(np.asarray(env.action_value()).shape[-1])
        actions = rng.uniform(-1.9, 1.9, lead + (num_particles, width)).astype(np.float32)
        action = actions[:, :, 0]
    else:
        actions = rng.integers(0, env.num_actions, lead + (num_particles,)).astype(np.int32)
        action = actions[:, :, 0]
    return {
        "done": done, "truncated": ((rng.random(lead) < 0.15) & (done == 0)).astype(np.float32),
        "action": action, "particle_actions": actions,
        "particle_weights": weights / weights.sum(-1, keepdims=True),
        "particle_advs": rng.normal(0.0, 2.0, lead + (num_particles,)).astype(np.float32),
        "reward": rng.normal(size=lead).astype(np.float32), "obs": obs(), "next_obs": obs(),
    }


def as_jax(seq):
    as_obs = lambda o: JaxObservation(*(o[k] for k in JaxObservation._fields))  # noqa: E731
    return {**seq, "obs": as_obs(seq["obs"]), "next_obs": as_obs(seq["next_obs"])}


def as_port(seq):
    as_obs = lambda o: Observation(*(t(o[k]) for k in Observation._fields))  # noqa: E731
    return {**{k: t(v) for k, v in seq.items() if k not in ("obs", "next_obs")},
            "obs": as_obs(seq["obs"]), "next_obs": as_obs(seq["next_obs"])}


def perturbed_targets(jparams, seed):
    """The JAX params with each target moved off its online copy."""
    rng = np.random.default_rng(seed)

    def move(tree):
        return jax.tree.map(lambda x: jnp.asarray(
            np.asarray(x) + rng.normal(0.0, 0.05, np.shape(x)).astype(np.float32)), tree)

    return jparams._replace(
        actor_params=jparams.actor_params._replace(target=move(jparams.actor_params.online)),
        critic_params=jparams.critic_params._replace(target=move(jparams.critic_params.online)))


def jax_epochs(update_step, jparams, jopts, seqs, epochs):
    """The JAX package's own `_update_epoch` on the given sequences, under
    vmap over "batch" and "data": [(params, metrics)] an epoch."""
    update_epoch = inspect.getclosurevars(update_step).nonlocals["_update_epoch"]
    u = len(seqs)
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs)[None], *trees)  # noqa: E731
    carry = (stack([jparams] * u), stack([jopts] * u), stack([as_jax(s) for s in seqs]),
             jax.random.split(jax.random.PRNGKey(11), u)[None])
    fn = jax.jit(jax.vmap(jax.vmap(update_epoch, axis_name="batch"), axis_name="data"))
    out = []
    for _ in range(epochs):
        carry, metrics = fn(carry, None)
        out.append((carry[0], jax.tree.map(np.asarray, metrics)))
    return out


@pytest.mark.parametrize("update_batch", [1, 2])
@pytest.mark.parametrize("system", list(ROOTS))
def test_update_epochs_match_the_jax_update_epoch(system, update_batch, monkeypatch):
    overrides = [f"arch.update_batch_size={update_batch}", "arch.total_num_envs=8",
                 "system.multistep_impl=pallas", "system.total_buffer_size=1024",
                 "system.total_batch_size=12", "system.num_particles=6",
                 "system.ent_coef=0.01", "system.actor_lr=1e-3", "system.critic_lr=1e-3"]
    cfg, jcfg = compose(system, SMALL + overrides)
    jsetup, update_step = jax_learner(jax_spo, "get_learner_fn", 4, jcfg, monkeypatch)
    jstate = jsetup.learner_state
    jparams = perturbed_targets(replica(jstate.params), 5)
    jopts = replica(jstate.opt_states)
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    continuous = ff_spo.is_continuous(env)
    seqs = [sequences(60 + u, 6, 8, env, 6, continuous) for u in range(update_batch)]
    want = jax_epochs(update_step, jparams, jopts, seqs, 2)

    actor, critic, params = port_networks(env, cfg, jparams)
    optims = ff_spo.make_optimizers(cfg)
    update = ff_spo.SPOUpdate((ff_ppo.make_apply_fn(actor), ff_ppo.make_apply_fn(critic)),
                              optims, cfg, continuous)
    opt = ff_spo.SPOOptStates(
        optims[0].init(params.actor_params.online), optims[1].init(params.critic_params.online),
        optims[2].init({"log_temperature": params.log_temperature,
                        "log_alpha": params.log_alpha}))
    params, opts = [params] * update_batch, [opt] * update_batch
    batches = [as_port(s) for s in seqs]
    calls = _count_b1_calls(monkeypatch)
    for wparams, wmetrics in want:
        params, opts, metrics = update(params, opts, batches)
        for key in ("policy_loss", "temperature", "kl", "entropy", "value_loss"):
            np.testing.assert_allclose(n(metrics[key]).reshape(update_batch), wmetrics[key][0],
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        for u in range(update_batch):
            for side in ("actor_params", "critic_params"):
                for part in ("online", "target"):
                    like = getattr(getattr(wparams, side), part)
                    got = to_flax_params(getattr(getattr(params[u], side), part),
                                         jax.tree.map(lambda x: x[0, u], like))
                    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(like)):
                        np.testing.assert_allclose(g, np.asarray(w)[0, u], rtol=0, atol=1e-5,
                                                   err_msg=f"{side}.{part}")
            for dual in ("log_temperature", "log_alpha"):
                np.testing.assert_allclose(n(getattr(params[u], dual)),
                                           np.asarray(getattr(wparams, dual))[0, u], rtol=0,
                                           atol=1e-5, err_msg=dual)
    assert calls == {"gae": 2, "generic": 0}
