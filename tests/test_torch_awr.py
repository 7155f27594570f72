"""Anakin AWR of the PyTorch port (stoix_tpu_torch/systems/awr: ff_awr and
ff_awr_continuous) against the JAX package's, on the CPU, at a small width
(MLPs of 16 x 16).

1. One update epoch (twice, the second reading Adam's moments) on explicit
   [B, L] sequence batches with terminations, from the same flax params,
   against JAX ff_awr.py's `_update_epoch` after its sample (:76-111: the
   critic's values, `lambda_returns(batch_major=True)`, the weights
   min(exp(A / beta), 20), both losses over the first L - 1 steps, `pmean`
   over "batch", clip + Adam eps 1e-5) under `jax.vmap(axis_name="batch")`,
   jitted, for the Categorical head and the tanh-Gaussian one, at
   `update_batch_size` 1 and 2: losses and the mean weight 1e-5 relative
   (absolute floor 1e-6), params 1e-5 absolute. Under
   `multistep_impl=pallas` each epoch calls B1's generic entry exactly once
   (every replica's batch in one call; on the CPU its plain version) and
   its GAE entry never, and no tensor that requires grad reaches it.
2. The rollout stores obs, action (int32 or float32), reward and discount
   as [E, T] trajectories, no info; each system runs its default config to
   a finite return at the sweep's budget with `epochs` generic calls an
   update; IdentityGame above 8.0 at the overrides where the JAX package
   returns 10.0 (64 envs, T = 8, 32 768 steps); `system.update_guard` is
   refused naming the key (C18).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.ops.multistep import lambda_returns as jax_lambda_returns
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.kernels import linear_recurrence
from stoix_tpu_torch.systems.awr import ff_awr, ff_awr_continuous
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from stoix_tpu_torch.utils.training import ClipAdam
from test_torch_continuous import _count_b1_calls, _paired_actor_critic
from torch_parity import n, t, to_flax_params

ROOTS = {"ff_awr": "default/anakin/default_ff_awr.yaml",
         "ff_awr_continuous": "default/anakin/default_ff_awr_continuous.yaml"}
MODULES = {"ff_awr": ff_awr, "ff_awr_continuous": ff_awr_continuous}
SEQ, BATCH = 8, 12


def sequences(seed, obs_dim, action_dim, discrete):
    rng = np.random.default_rng(seed)
    lead = (BATCH, SEQ)
    return {
        "obs": {"agent_view": rng.normal(size=lead + (obs_dim,)).astype(np.float32),
                "action_mask": np.ones(lead + (action_dim if discrete else 1,), np.float32),
                "step_count": np.zeros(lead, np.int32)},
        "action": (rng.integers(0, action_dim, lead).astype(np.int32) if discrete else
                   rng.uniform(-1.9, 1.9, lead + (action_dim,)).astype(np.float32)),
        "reward": (rng.normal(size=lead) * 0.02).astype(np.float32),
        "discount": (rng.random(lead) > 0.15).astype(np.float32),
    }


def jax_epochs(ja, jap, jc, jcp, seqs, cfg, epochs):
    """JAX ff_awr.py's `_update_epoch` body on given sequences, under
    vmap("batch") over the replicas' batches; losses [epochs, U, 3] (actor,
    mean weight, value) and the final (actor, critic) params."""
    s = cfg.system
    make_optim = lambda lr: optax.chain(optax.clip_by_global_norm(float(s.max_grad_norm)),
                                        optax.adam(lr, eps=1e-5))
    aopt, copt = make_optim(float(s.actor_lr)), make_optim(float(s.critic_lr))
    gamma, lam = float(s.gamma), float(s.gae_lambda)
    beta, w_max = float(s.awr_beta), float(s.weight_clip)

    def epoch(params, states, seq):
        obs = JaxObservation(*(seq["obs"][k] for k in JaxObservation._fields))
        values = jc.apply(params[1], obs)
        returns = jax_lambda_returns(seq["reward"][:, :-1], gamma * seq["discount"][:, :-1],
                                     values[:, 1:], lam, batch_major=True)
        adv = returns - values[:, :-1]
        head = jax.tree.map(lambda x: x[:, :-1], obs)

        def actor_loss_fn(p):
            log_prob = ja.apply(p, head).log_prob(seq["action"][:, :-1])
            weights = jnp.minimum(jnp.exp(jax.lax.stop_gradient(adv) / beta), w_max)
            loss = -jnp.mean(weights * log_prob)
            return loss, (loss, jnp.mean(weights))

        def critic_loss_fn(p):
            loss = 0.5 * jnp.mean((jc.apply(p, head) - jax.lax.stop_gradient(returns)) ** 2)
            return loss, loss

        ag, (la, mw) = jax.grad(actor_loss_fn, has_aux=True)(params[0])
        cg, vl = jax.grad(critic_loss_fn, has_aux=True)(params[1])
        ag, cg = jax.lax.pmean((ag, cg), axis_name="batch")
        au, a_s = aopt.update(ag, states[0])
        cu, c_s = copt.update(cg, states[1])
        return ((optax.apply_updates(params[0], au), optax.apply_updates(params[1], cu)),
                (a_s, c_s), jnp.stack([la, mw, vl]))

    step = jax.jit(jax.vmap(epoch, axis_name="batch"))
    u = len(seqs)
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *seqs)
    params = jax.tree.map(lambda x: jnp.stack([x] * u), (jap, jcp))
    states = jax.tree.map(lambda x: jnp.stack([x] * u), (aopt.init(jap), copt.init(jcp)))
    losses = []
    for _ in range(epochs):
        params, states, loss = step(params, states, batch)
        losses.append(np.asarray(loss))
    return np.stack(losses), jax.tree.map(lambda x: np.asarray(x)[0], params)


def port_sequences(seq):
    return {"obs": Observation(*(t(seq["obs"][k]) for k in Observation._fields)),
            **{k: t(seq[k]) for k in ("action", "reward", "discount")}}


@pytest.mark.parametrize("update_batch", [1, 2])
@pytest.mark.parametrize("system", list(ROOTS))
def test_update_epochs_match_jax_composition(system, update_batch, monkeypatch):
    discrete = system == "ff_awr"
    overrides = ["system.actor_lr=1e-3", "system.critic_lr=1e-3", "system.multistep_impl=pallas"]
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS[system], overrides)
    jcfg = jax_config.compose(jax_config.default_config_dir(), ROOTS[system], overrides)
    obs_dim, action_dim = 5, 3 if discrete else 2
    ja, jap, jc, jcp, ta, tc = _paired_actor_critic(discrete, obs_dim, action_dim, 6)
    seqs = [sequences(20 + u, obs_dim, action_dim, discrete) for u in range(update_batch)]
    want_losses, (want_ap, want_cp) = jax_epochs(ja, jap, jc, jcp, seqs, jcfg, 2)

    optims = tuple(ClipAdam(float(cfg.system[k]), float(cfg.system.max_grad_norm), eps=1e-5)
                   for k in ("actor_lr", "critic_lr"))
    update = ff_awr.AWRUpdate(ff_ppo.make_apply_fn(ta), ff_ppo.make_apply_fn(tc), optims, cfg)
    params = ActorCriticParams({k: v.detach() for k, v in ta.named_parameters()},
                               {k: v.detach() for k, v in tc.named_parameters()})
    opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                               optims[1].init(params.critic_params))
    params, opts = [params] * update_batch, [opt] * update_batch
    batches = [port_sequences(s) for s in seqs]
    original = linear_recurrence.linear_recurrence_reverse

    def no_grad_inputs(weight, delta, init):
        assert not (weight.requires_grad or delta.requires_grad or init.requires_grad)
        assert weight.shape == (SEQ - 1, BATCH * update_batch)
        return original(weight, delta, init)

    monkeypatch.setattr(linear_recurrence, "linear_recurrence_reverse", no_grad_inputs)
    calls = _count_b1_calls(monkeypatch)
    got = []
    for _ in range(2):
        params, opts, metrics = update(params, opts, batches)
        got.append(np.stack([n(metrics[k]) for k in ("actor_loss", "mean_weight",
                                                     "value_loss")], -1))
    assert calls == {"gae": 0, "generic": 2}
    np.testing.assert_allclose(np.stack(got).reshape(want_losses.shape), want_losses, rtol=1e-5,
                               atol=1e-6)
    assert float(want_losses[..., 1].max()) > 1.5  # the weights do vary
    for got_p, want_p in ((params[0].actor_params, want_ap), (params[0].critic_params, want_cp)):
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5),
                     to_flax_params(got_p, want_p), want_p)


SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "system.rollout_length=8",
         "logger.use_console=False", "system.total_buffer_size=4096",
         "system.total_batch_size=32", "system.multistep_impl=pallas"]


@pytest.mark.parametrize("system", list(ROOTS))
def test_rollout_stores_sequences_without_info(system):
    discrete = system == "ff_awr"
    cfg = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), ROOTS[system],
        SWEEP + (["env=identity_game"] if discrete else [])), 1)
    setup = ff_awr.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 3)
    state, traj = setup.learn.rollout(setup.learner_state)
    buffer = state.buffer_state
    assert set(buffer.experience) == {"obs", "action", "reward", "discount"}
    assert buffer.experience["action"].dtype == (torch.int32 if discrete else torch.float32)
    assert buffer.num_added == 8 and buffer.experience["reward"].shape[:1] == (16,)
    assert torch.equal(buffer.experience["reward"][:, :8], traj["reward"].T)
    assert "info" in traj


@pytest.mark.parametrize("system", list(ROOTS))
def test_each_system_runs_at_the_sweep_budget_with_one_generic_call_an_epoch(system,
                                                                            monkeypatch):
    calls = _count_b1_calls(monkeypatch)
    extra = ["env=identity_game"] if system == "ff_awr" else []
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS[system], SWEEP + extra)
    assert np.isfinite(MODULES[system].run_experiment(cfg, device="cpu"))
    assert calls == {"gae": 0, "generic": 2048 // (16 * 8) * 4}


def test_awr_learns_identity_game():
    import chip_smoke

    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS["ff_awr"],
                             chip_smoke.AWR_IDENTITY)
    assert ff_awr.run_experiment(cfg, device="cpu") > chip_smoke.PG_THRESHOLD


def test_update_guard_the_reference_ignores_is_refused_naming_the_key():
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS["ff_awr"],
                             SWEEP + ["system.update_guard=skip"])
    with pytest.raises(NotImplementedError, match="system.update_guard"):
        ff_awr.run_experiment(cfg, device="cpu")
