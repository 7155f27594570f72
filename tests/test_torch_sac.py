"""Anakin SAC of the PyTorch port (stoix_tpu_torch/systems/sac/ff_sac.py)
against the JAX package's, on the CPU, at a small width (MLPs of 16 x 16 on
Pendulum).

1. `update_from_batch` from the JAX package's own flax params (the critics'
   target perturbed), `init_alpha` 0.5, on explicit batches, against the
   package's own `update_from_batch` (from its `learner_setup`) under
   `jax.vmap(axis_name="batch")` and `jax.vmap(axis_name="data")`, jitted,
   with the same two standard-normal draws a step fed to both packages (the
   JAX package's `next_key` and `actor_key` draws, in that order); two
   steps, with `autotune_alpha` on (the temperature's plain Adam, eps 1e-8)
   and off (alpha fixed, `alpha_loss` 0), at `update_batch_size` 1 and 2:
   losses and alpha 1e-5 relative, params and `log_alpha` 1e-5 absolute.
2. A resume after window 1 is bitwise the unbroken run, `log_alpha` and
   its Adam state carried; `system.update_guard` is refused naming the key
   (C18); the system runs to a finite return at the sweep's budget.
"""

import os

import numpy as np
import pytest
import torch

from stoix_tpu_torch.base_types import OnlineAndTarget
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ddpg import ff_ddpg
from stoix_tpu_torch.systems.sac import ff_sac
from stoix_tpu_torch.utils import config as config_lib
from test_torch_ddpg import (
    BATCH, SMALL, SWEEP, as_port, assert_metrics, assert_params, batch_pair, configs,
    jax_steps, jax_system, perturbed, port_networks,
)
from torch_parity import n

METRICS = ("q_loss", "mean_q", "actor_loss", "entropy", "alpha_loss", "alpha")


@pytest.mark.parametrize("update_batch", [1, 2])
@pytest.mark.parametrize("autotune", [True, False])
def test_update_from_batch_matches_jax(autotune, update_batch, monkeypatch):
    overrides = [f"arch.update_batch_size={update_batch}", f"system.autotune_alpha={autotune}",
                 "system.init_alpha=0.5", "system.alpha_lr=1e-2"]
    cfg, jcfg = configs("ff_sac", overrides)
    jupdate, _, jparams, jopt = jax_system("ff_sac", jcfg, monkeypatch)
    jparams = jparams._replace(q_params=jparams.q_params._replace(
        target=perturbed(jparams.q_params.target, 2)))
    pairs = [batch_pair(seed) for seed in range(5, 5 + update_batch)]
    rng = np.random.default_rng(9)
    normals = [[rng.normal(size=(BATCH, 1)).astype(np.float32) for _ in range(2)]
               for _ in range(2)]
    want = jax_steps(jupdate, jparams, jopt, [p[0] for p in pairs], normals)

    actor, q_network, _ = port_networks("ff_sac", cfg, jparams.actor_params,
                                        jparams.q_params.online)
    optims = ff_sac.make_optimizers(cfg)
    update = ff_sac.SACUpdate(ff_ddpg.make_apply(actor), ff_ddpg.make_apply(q_network), optims,
                              cfg)
    actor_p = as_port(jparams.actor_params, actor)
    q_online = as_port(jparams.q_params.online, q_network)
    log_alpha = ff_sac.initial_log_alpha(cfg, torch.device("cpu"))
    assert float(log_alpha) == float(np.asarray(jparams.log_alpha))
    params = ff_sac.SACParams(actor_p, OnlineAndTarget(
        q_online, as_port(jparams.q_params.target, q_network)), log_alpha)
    opt = ff_sac.SACOptStates(optims[0].init(actor_p), optims[1].init(q_online),
                              optims[2].init({"log_alpha": log_alpha}))
    params, opts = [params] * update_batch, [opt] * update_batch
    batches = [p[1] for p in pairs]
    for step, (wparams, _, wmetrics) in enumerate(want):
        noise = tuple(torch.from_numpy(x) for x in normals[step])
        params, opts, metrics = update.step(params, opts, batches, [noise] * update_batch)
        for u in range(update_batch):
            assert_metrics(metrics, wmetrics, u, METRICS)
    if not autotune:
        assert float(metrics["alpha_loss"].abs().max()) == 0.0
    for u in range(update_batch):
        assert_params(params[u].actor_params, wparams.actor_params, jparams.actor_params, u)
        assert_params(params[u].q_params.online, wparams.q_params.online,
                      jparams.q_params.online, u)
        assert_params(params[u].q_params.target, wparams.q_params.target,
                      jparams.q_params.online, u)
        np.testing.assert_allclose(n(params[u].log_alpha), np.asarray(wparams.log_alpha)[0, u],
                                   rtol=0, atol=1e-5)
    moved = float(params[0].log_alpha) != float(log_alpha)
    assert moved == autotune and opts[0].alpha_opt_state.count == (2 if autotune else 0)


def test_sac_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    window = 2 * 8 * 8

    def run(uid, windows, extra=()):
        config = config_lib.compose(
            config_lib.default_config_dir(), "default/anakin/default_ff_sac.yaml", SMALL + [
                "system.rollout_length=8", "system.epochs=2", "system.warmup_steps=4",
                "system.alpha_lr=1e-2", "arch.num_eval_episodes=4", "logger.use_console=False",
                "logger.checkpointing.save_model=true",
                f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                "logger.checkpointing.save_args.max_to_keep=~",
                f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * window}",
                *extra])
        ff_sac.run_experiment(config, device="cpu")

    run("unbroken", 2)
    run("first", 1)
    run("resumed", 1, ["logger.checkpointing.load_model=true",
                       "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == window
    load = lambda uid: torch.load(  # noqa: E731
        os.path.join(tmp_path, "checkpoints", uid, "ff_sac", str(2 * window), "state.pt"),
        weights_only=True)
    unbroken, resumed = load("unbroken"), load("resumed")
    assert unbroken.keys() == resumed.keys()
    for key, value in unbroken.items():
        other = resumed[key]
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, other), key
        elif isinstance(value, dict):
            assert torch.equal(value["generator_state"], other["generator_state"]), key
        else:
            assert value == other, key
    assert float(unbroken["params/log_alpha"]) != 0.0
    assert unbroken["opt_states/alpha_opt_state/count"] == 2 * 2 * 2


def test_update_guard_the_reference_ignores_is_refused_naming_the_key():
    cfg, _ = configs("ff_sac", ["system.update_guard=halt"])
    with pytest.raises(NotImplementedError, match="system.update_guard"):
        ff_sac.run_experiment(cfg, device="cpu")


def test_sac_runs_to_a_finite_return_at_the_sweep_budget():
    cfg = config_lib.compose(config_lib.default_config_dir(), "default/anakin/default_ff_sac.yaml",
                             SWEEP)
    assert np.isfinite(ff_sac.run_experiment(cfg, device="cpu"))
