"""Anakin PPO of the PyTorch port against the JAX package, as a whole.

1. One update step from identical parameters, a fixed numpy trajectory and
   explicit per-epoch permutations, against the JAX package's own functions
   composed in stoix_tpu/systems/ppo/anakin/ff_ppo.py's order (bootstrap
   critic pass, GAE, epochs x minibatches of loss + grad + clip + Adam).
   Tolerances (float32): advantages/targets 1e-6 absolute (see
   test_torch_multistep.py), minibatch losses 1e-5 relative, updated params
   1e-5 absolute — gradients reduce in another order than XLA's.
2. IdentityGame learns to a return above 8.0 on the CPU (the JAX package's
   oracle, tests/test_ff_ppo.py).
3. `multistep_impl=pallas` trains bitwise like `scan` on the CPU.
4. The package imports nothing of JAX or of the JAX package.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.ops import losses as jlosses
from stoix_tpu.ops.multistep import truncated_generalized_advantage_estimation as jax_gae
from stoix_tpu.utils import config as jax_config
from stoix_tpu.utils.timestep_checker import check_total_timesteps as jax_check_total_timesteps
from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams, PPOTransition
from stoix_tpu_torch.envs.types import Observation as TorchObservation
from stoix_tpu_torch.kernels import linear_recurrence
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from stoix_tpu_torch.utils.training import ClipAdam
from torch_parity import n, paired_networks, t, to_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDENTITY_OVERRIDES = [  # tests/test_ff_ppo.py::test_ppo_learns_identity_game
    "env=identity_game",
    "arch.total_num_envs=64",
    "arch.total_timesteps=65536",
    "arch.num_evaluation=1",
    "arch.num_eval_episodes=32",
    "arch.evaluation_greedy=True",
    "arch.absolute_metric=False",
    "system.rollout_length=16",
    "system.epochs=4",
    "logger.use_console=False",
]


def make_config(overrides):
    return config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_ppo.yaml", overrides
    )


def _trajectory(seed, t_len, n_envs, obs_dim, num_actions):
    rng = np.random.default_rng(seed)

    def obs():
        return {"agent_view": rng.normal(size=(t_len, n_envs, obs_dim)).astype(np.float32),
                "action_mask": np.ones((t_len, n_envs, num_actions), np.float32),
                "step_count": np.zeros((t_len, n_envs), np.int32)}

    done = rng.uniform(size=(t_len, n_envs)) < 0.1
    return {
        "obs": obs(), "next_obs": obs(),
        "action": rng.integers(0, num_actions, size=(t_len, n_envs)).astype(np.int32),
        "reward": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "value": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "log_prob": np.log(rng.uniform(0.2, 0.8, size=(t_len, n_envs))).astype(np.float32),
        "done": done,
        "truncated": (rng.uniform(size=(t_len, n_envs)) < 0.1) & ~done,
    }


def _jax_update(ja, jap, jc, jcp, traj, permutations, cfg):
    """ff_ppo.py:345-400 on the JAX side, with explicit permutations."""
    from stoix_tpu.envs.types import Observation

    s = cfg.system
    as_obs = lambda o: Observation(*(jnp.asarray(o[k]) for k in Observation._fields))
    obs, next_obs = as_obs(traj["obs"]), as_obs(traj["next_obs"])
    v_t = jc.apply(jcp, next_obs)
    d_t = s.gamma * (1.0 - jnp.asarray(traj["done"]).astype(jnp.float32))
    advantages, targets = jax_gae(
        jnp.asarray(traj["reward"]) * 1.0, d_t, s.gae_lambda,
        v_tm1=jnp.asarray(traj["value"]), v_t=v_t,
        truncation_t=jnp.asarray(traj["truncated"]).astype(jnp.float32),
        standardize_advantages=True, impl="scan",
    )

    def actor_loss(params, obs, action, old_log_prob, gae):
        dist = ja.apply(params, obs)
        loss_actor = jlosses.ppo_clip_loss(dist.log_prob(action), old_log_prob, gae, s.clip_eps)
        entropy = dist.entropy().mean()
        return loss_actor - s.ent_coef * entropy, (loss_actor, entropy)

    def critic_loss(params, obs, targets, old_value):
        value_loss = jlosses.clipped_value_loss(jc.apply(params, obs), old_value, targets,
                                                s.clip_eps)
        return s.vf_coef * value_loss, value_loss

    make_optim = lambda: optax.chain(optax.clip_by_global_norm(float(s.max_grad_norm)),
                                     optax.adam(float(s.actor_lr), eps=1e-5))
    actor_optim, critic_optim = make_optim(), make_optim()
    actor_grad = jax.jit(jax.grad(actor_loss, has_aux=True))
    critic_grad = jax.jit(jax.grad(critic_loss, has_aux=True))
    actor_step, critic_step = jax.jit(actor_optim.update), jax.jit(critic_optim.update)
    a_state, c_state = actor_optim.init(jap), critic_optim.init(jcp)
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]),
                        (obs, jnp.asarray(traj["action"]), jnp.asarray(traj["log_prob"]),
                         jnp.asarray(traj["value"]), advantages, targets))
    losses = []
    for perm in permutations:
        mbs = jax.tree.map(lambda x: jnp.take(x, jnp.asarray(perm), axis=0).reshape(
            (s.num_minibatches, -1) + x.shape[1:]), flat)
        for i in range(s.num_minibatches):
            mb_obs, mb_act, mb_lp, mb_val, mb_adv, mb_tgt = jax.tree.map(lambda x: x[i], mbs)
            a_grads, (loss_actor, entropy) = actor_grad(jap, mb_obs, mb_act, mb_lp, mb_adv)
            c_grads, value_loss = critic_grad(jcp, mb_obs, mb_tgt, mb_val)
            updates, a_state = actor_step(a_grads, a_state)
            jap = optax.apply_updates(jap, updates)
            updates, c_state = critic_step(c_grads, c_state)
            jcp = optax.apply_updates(jcp, updates)
            losses.append([float(loss_actor), float(value_loss), float(entropy)])
    return np.asarray(advantages), np.asarray(targets), np.asarray(losses), jap, jcp


def test_one_update_step_matches_jax_composition():
    cfg = make_config(["system.epochs=2", "system.num_minibatches=4", "system.actor_lr=1.0e-3",
                       "system.critic_lr=1.0e-3", "arch.num_updates_per_eval=1"])
    t_len, n_envs, obs_dim, num_actions = 8, 16, 6, 3
    ja, jap, jc, jcp, ta, tc = paired_networks(obs_dim, num_actions, (32, 32), seed=4)
    traj = _trajectory(0, t_len, n_envs, obs_dim, num_actions)
    perms = [np.random.default_rng(10 + e).permutation(t_len * n_envs) for e in range(2)]

    want_adv, want_tgt, want_losses, want_ap, want_cp = _jax_update(
        ja, jap, jc, jcp, traj, perms, cfg)

    actor_params = {k: v.detach() for k, v in ta.named_parameters()}
    critic_params = {k: v.detach() for k, v in tc.named_parameters()}
    optims = tuple(ClipAdam(1e-3, cfg.system.max_grad_norm, eps=1e-5) for _ in range(2))
    learner = ff_ppo.get_learner_fn(
        None, (ff_ppo.make_apply_fn(ta), ff_ppo.make_apply_fn(tc)), optims, cfg)
    as_obs = lambda o: TorchObservation(*(t(o[k]) for k in TorchObservation._fields))
    transition = PPOTransition(
        done=t(traj["done"]), truncated=t(traj["truncated"]), action=t(traj["action"]),
        value=t(traj["value"]), reward=t(traj["reward"]), log_prob=t(traj["log_prob"]),
        obs=as_obs(traj["obs"]), next_obs=as_obs(traj["next_obs"]), info={},
    )
    result = learner.update(
        ActorCriticParams(actor_params, critic_params),
        ActorCriticOptStates(optims[0].init(actor_params), optims[1].init(critic_params)),
        transition, permutations=[torch.from_numpy(p) for p in perms],
    )

    np.testing.assert_allclose(n(result.advantages), want_adv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(n(result.targets), want_tgt, rtol=0, atol=1e-6)
    got_losses = np.stack([n(result.loss_info[k]).reshape(-1)
                           for k in ("actor_loss", "value_loss", "entropy")], axis=1)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=1e-7)
    pairs = ((result.params.actor_params, want_ap), (result.params.critic_params, want_cp))
    for got, want in pairs:
        got_tree = to_flax_params(got, want)
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5),
                     got_tree, want)
        # The update really moved the params.
        moved = jax.tree.map(lambda g, w0: float(np.abs(g - w0).max()), got_tree,
                             jap if got is result.params.actor_params else jcp)
        assert max(jax.tree.leaves(moved)) > 1e-4


def test_ppo_learns_identity_game_on_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs several workers side by side
    try:
        final_return = ff_ppo.run_experiment(make_config(IDENTITY_OVERRIDES), device="cpu")
    finally:
        torch.set_num_threads(threads)
    # Optimal is 10.0; an unwired learner scores ~2.5 (random over 4 actions).
    assert final_return > 8.0, f"PPO failed to learn IdentityGame: {final_return}"
    assert runner.LAST_RUN_STATS["device"] == "cpu"


@pytest.mark.parametrize("overrides", [
    [],
    ["arch.total_timesteps=100000", "arch.num_evaluation=7"],
    ["arch.num_updates=3", "arch.num_evaluation=5"],
    ["arch.total_num_envs=64", "system.rollout_length=8", "arch.total_timesteps=65536"],
])
def test_timestep_accounting_matches_jax(overrides):
    port = check_total_timesteps(make_config(overrides), 1)
    ref = jax_check_total_timesteps(jax_config.compose(
        jax_config.default_config_dir(), "default/anakin/default_ff_ppo.yaml", overrides), 1)
    for key in ("num_updates", "total_timesteps", "num_evaluation", "num_updates_per_eval",
                "num_envs_per_shard"):
        assert port.arch[key] == ref.arch[key], key


def test_tiny_run_counts_timesteps_and_windows():
    cfg = make_config(["env=identity_game", "arch.total_num_envs=8", "arch.num_updates=4",
                       "arch.num_evaluation=2", "arch.num_eval_episodes=4",
                       "system.rollout_length=4", "system.num_minibatches=2",
                       "logger.use_console=False"])
    final_return = ff_ppo.run_experiment(cfg, device="cpu")
    assert np.isfinite(final_return)
    history = runner.LAST_RUN_STATS["history"]
    assert [r["t"] for r in history if r["event"] == "evaluator"] == [64, 128]
    assert [r["t"] for r in history if r["event"] == "absolute"] == [128]
    assert cfg.arch.total_timesteps == 128
    assert len(runner.LAST_RUN_STATS["window_seconds"]) == 2


def test_pallas_trains_bitwise_like_scan_on_cpu():
    outcomes = {}
    before = [c.launches for c in linear_recurrence.COUNTERS]
    for impl in ("scan", "pallas"):
        cfg = check_total_timesteps(make_config([
            "arch.total_num_envs=32", "arch.num_updates=2", "arch.num_evaluation=1",
            "system.rollout_length=8", "system.num_minibatches=2",
            f"system.multistep_impl={impl}"]), 1)
        env, _ = envs.make(cfg)
        setup = ff_ppo.learner_setup(env, cfg, torch.device("cpu"), seed=3)
        state, traj = setup.learn.rollout(setup.learner_state)
        result = setup.learn.update(state.params, state.opt_states, traj, state.generator)
        outcomes[impl] = (result.advantages, result.params)
    assert torch.equal(outcomes["scan"][0], outcomes["pallas"][0])
    for part in range(2):
        for k, v in outcomes["scan"][1][part].items():
            assert torch.equal(v, outcomes["pallas"][1][part][k]), k
    # The CPU takes the plain versions: no kernel launched.
    assert [c.launches for c in linear_recurrence.COUNTERS] == before


def test_entry_point_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ff_ppo.run_experiment(make_config(["env=identity_game", "arch.total_num_envs=8"]))


@pytest.mark.parametrize("override,key", [
    # Anakin colocates every role; only the Sebulba runner splits them.
    ("arch.roles.learn.device_ids=[0]", "arch.roles"),
    # The integrity, preflight, fault, telemetry, fleet and HTTP layers run
    # (tests/test_torch_resilience.py, test_torch_integrity.py,
    # test_torch_opsplane.py, test_torch_fleet.py, test_torch_httpz.py);
    # what stays refused: the compile cache (A19c) and the serving faults
    # (A18).
    ("arch.compile_cache.enabled=true", "arch.compile_cache.enabled"),
    ("arch.fault_spec=swap_poison", "swap_poison"),
])
def test_unported_knobs_raise_naming_the_key(override, key):
    cfg = make_config(["env=identity_game", "arch.total_num_envs=8", "arch.num_updates=1",
                       "arch.num_evaluation=1", override])
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        ff_ppo.run_experiment(cfg, device="cpu")


@pytest.mark.parametrize("override", [
    "arch.fleet.enabled=true", "logger.telemetry.http.enabled=true",
    # Armed past the run's last window: accepted, and never fires.
    "arch.fault_spec=host_loss:5"])
def test_the_layers_across_hosts_run_on_ff_ppo(override, tmp_path, monkeypatch):
    from stoix_tpu_torch import observability
    from stoix_tpu_torch.resilience import faultinject

    monkeypatch.chdir(tmp_path)
    cfg = make_config(["env=identity_game", "arch.total_num_envs=8", "arch.num_updates=1",
                       "arch.num_evaluation=1", override])
    try:
        assert np.isfinite(ff_ppo.run_experiment(cfg, device="cpu"))
        assert runner.LAST_RUN_STATS["resilience"]["fleet"] is ("fleet" in override)
        assert (observability.get_ops_server() is not None) is ("http" in override)
        assert (faultinject.get_plan() is not None) is ("host_loss" in override)
    finally:
        observability.shutdown()
        faultinject.reset()


def test_port_imports_nothing_of_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stoix_tpu_torch\n"
        "for m in pkgutil.walk_packages(stoix_tpu_torch.__path__, 'stoix_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'chex', 'orbax') or k == 'stoix_tpu' "
        "or k.startswith('stoix_tpu.'))\n"
        "print(len([k for k in sys.modules if k.startswith('stoix_tpu_torch')]), bad)\n"
        "slice8 = ['buffers.buffers', 'systems.off_policy_core', 'kernels.flash_attention_wide',\n"
        "          'kernels.attention_common',\n"
        "          *('systems.q_learning.' + m for m in ('q_family', 'ff_dqn', 'ff_ddqn',\n"
        "            'ff_dqn_reg', 'ff_mdqn', 'ff_c51', 'ff_qr_dqn', 'ff_pqn'))]\n"
        "assert all('stoix_tpu_torch.' + m in sys.modules for m in slice8)\n"
        "slice10 = ['networks.cells', *('systems.ppo.anakin.' + m for m in (\n"
        "    'ff_ppo_continuous', 'ff_ppo_penalty', 'ff_ppo_penalty_continuous',\n"
        "    'ff_dpo_continuous', 'rec_ppo'))]\n"
        "assert all('stoix_tpu_torch.' + m in sys.modules for m in slice10)\n"
        "slice12 = ['networks.layers', 'networks.dueling', 'ops.value_transforms',\n"
        "           'systems.q_learning.ff_rainbow', 'systems.q_learning.rec_r2d2']\n"
        "assert all('stoix_tpu_torch.' + m in sys.modules for m in slice12)\n"
        "slice13 = ['systems.' + m for m in ('ddpg.ff_ddpg', 'ddpg.ff_td3', 'ddpg.ff_d4pg',\n"
        "           'sac.ff_sac', 'vpg.ff_reinforce', 'vpg.ff_reinforce_continuous',\n"
        "           'awr.ff_awr', 'awr.ff_awr_continuous')]\n"
        "assert all('stoix_tpu_torch.' + m in sys.modules for m in slice13)\n"
        "slice16 = ['networks.disco', 'systems.spo.ff_spo', 'systems.spo.ff_spo_continuous',\n"
        "           'systems.disco.update_rule', 'systems.disco.ff_disco103']\n"
        "assert all('stoix_tpu_torch.' + m in sys.modules for m in slice16)\n"
        "slice18 = ['envs.' + m for m in ('rigid_body', 'locomotion', 'snake', 'game2048',\n"
        "           'doorkey')]\n"
        "assert all('stoix_tpu_torch.' + m in sys.modules for m in slice18)\n"
        "slice19 = ['utils.timing', 'observability.health', 'observability.trace',\n"
        "           'resilience.supervisor', 'parallel.roles', 'sebulba.core', 'envs.factory',\n"
        "           'envs.cvec', 'systems.ppo.sebulba.ff_ppo',\n"
        "           'systems.impala.sebulba.ff_impala',\n"
        "           'systems.impala.sebulba.ff_impala_shared_torso']\n"
        "assert all('stoix_tpu_torch.' + m in sys.modules for m in slice19)\n"
        "slice21 = ['parallel.gossip', 'parallel.tp', 'envs.gymnasium_adapter',\n"
        "           'envs.envpool_adapter']\n"
        "assert all('stoix_tpu_torch.' + m in sys.modules for m in slice21)\n"
        "slice22 = ['resilience.' + m for m in ('exit_codes', 'preemption', 'watchdog',\n"
        "           'integrity', 'preflight')] + ['observability.' + m for m in (\n"
        "           'flightrec', 'goodput', 'trace', 'trace_export', 'exporters', 'sink',\n"
        "           'introspect')]\n"
        "assert all('stoix_tpu_torch.' + m in sys.modules for m in slice22)\n"
        "slice24 = ['population.' + m for m in ('hparams', 'pbt', 'runner', 'elastic')]\n"
        "assert all('stoix_tpu_torch.' + m in sys.modules for m in slice24)\n"
        "assert 'gymnasium' not in sys.modules and 'envpool' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120, check=True)
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 30
    assert bad == "[]", bad
