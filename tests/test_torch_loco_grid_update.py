"""The update steps of the new envs' paths against the JAX package's
compositions, on the CPU:

1. One ff_ppo_continuous update on Ant (27-dim observations, 8 actions on
   [-1, 1], the tanh-Gaussian head) from a rollout of the port's Ant env,
   against test_torch_continuous.py's composition of the JAX package's
   functions (bootstrap critic, GAE, epochs x minibatches of loss, grad,
   clip and Adam), from the same flax init and explicit permutations.
2. One masked ff_ppo update on Snake (the flattened 6x6x5 grid, 4 actions
   whose reverse is masked) from a rollout of the port's Snake env, against
   test_torch_ff_ppo.py's composition (the JAX Categorical head takes the
   same masks).
   Each under `system.multistep_impl=pallas`: GAE is exactly one call of B1's
   GAE entry (its plain version on the CPU). Losses 1e-5 relative, params
   1e-5 absolute, advantages and targets 1e-6 absolute.
3. The card's paths at the JAX sweep's budget on the CPU: ff_ppo_continuous
   on Ant, Hopper, Walker2d and HalfCheetah and ff_ppo on Snake, 2048 and
   DoorKey (one GAE call an update); ff_sac on Ant, and ff_dqn, ff_c51 and
   ff_dqn with cnn_dqn on Snake (no B1 call); each finite.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.networks import base as jbase, heads as jheads, inputs as jinputs
from stoix_tpu.networks import torso as jtorso
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams, PPOTransition
from stoix_tpu_torch.envs import snake
from stoix_tpu_torch.envs.types import Observation, restart, tree_select
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from test_torch_continuous import _count_b1_calls, _jax_update as jax_continuous_update
from test_torch_ff_ppo import _jax_update as jax_discrete_update
from torch_parity import n, t, to_flax_params

UPDATE = ["system.epochs=2", "system.num_minibatches=2", "system.actor_lr=1.0e-3",
          "system.critic_lr=1.0e-3", "system.multistep_impl=pallas",
          "arch.num_updates_per_eval=1", "network.actor_network.pre_torso.layer_sizes=[16,16]",
          "network.critic_network.pre_torso.layer_sizes=[16,16]"]


def _rollout(env, t_len, num_envs, seed, act, start=None):
    """A [T, E] trajectory of the port's env: observations, next observations
    (before any reset), actions `act(timestep, rng)`, rewards, terminations
    and truncations; an ended env restarts from a fresh reset. `start(state)`
    gives the first (state, timestep) in place of the reset's."""
    generator, rng = torch.Generator().manual_seed(seed), np.random.default_rng(seed)
    state, ts = env.reset(generator, num_envs)
    if start is not None:
        state, ts = start(state)
    keys = ("obs", "next_obs", "action", "reward", "done", "truncated")
    out = {k: [] for k in keys}
    for _ in range(t_len):
        action = act(ts, rng)
        nstate, nts = env.step(state, action)
        out["obs"].append(ts.observation)
        out["next_obs"].append(nts.observation)
        out["action"].append(action)
        out["reward"].append(nts.reward)
        out["done"].append(nts.discount == 0.0)
        out["truncated"].append(nts.last() & (nts.discount != 0.0))
        fresh_state, fresh_ts = env.reset(generator, num_envs)
        state = tree_select(nts.last(), fresh_state, nstate)
        ts = tree_select(nts.last(), fresh_ts, nts)
    stack = lambda xs: np.stack([n(x) for x in xs])  # noqa: E731
    traj = {k: stack(out[k]) for k in ("action", "reward", "done", "truncated")}
    for k in ("obs", "next_obs"):
        traj[k] = {f: stack([getattr(o, f) for o in out[k]]) for f in Observation._fields}
    traj["value"] = rng.normal(size=traj["reward"].shape).astype(np.float32)
    return traj


def _flat(traj):
    """Flatten each observation's view past [T, E] (the flatten wrapper's)."""
    for k in ("obs", "next_obs"):
        view = traj[k]["agent_view"]
        traj[k]["agent_view"] = view.reshape(view.shape[:2] + (-1,))
    return traj


def _jax_obs(o):
    return JaxObservation(*(jnp.asarray(o[k]) for k in JaxObservation._fields))


def _port_transition(traj):
    as_obs = lambda o: Observation(*(t(o[k]) for k in Observation._fields))  # noqa: E731
    return PPOTransition(done=t(traj["done"]), truncated=t(traj["truncated"]),
                         action=t(traj["action"]), value=t(traj["value"]),
                         reward=t(traj["reward"]), log_prob=t(traj["log_prob"]),
                         obs=as_obs(traj["obs"]), next_obs=as_obs(traj["next_obs"]), info={})


def _flax_pair(head, obs_dim, action_dim, seed):
    ja = jbase.FeedForwardActor(action_head=head, torso=jtorso.MLPTorso((16, 16)),
                                input_layer=jinputs.ObservationInput())
    jc = jbase.FeedForwardCritic(critic_head=jheads.ScalarCriticHead(),
                                 torso=jtorso.MLPTorso((16, 16)),
                                 input_layer=jinputs.ObservationInput())
    dummy = JaxObservation(jnp.zeros((1, obs_dim)), jnp.ones((1, action_dim)),
                           jnp.zeros((1,), jnp.int32))
    ka, kc = jax.random.split(jax.random.PRNGKey(seed))
    return (ja, jax.tree.map(np.asarray, ja.init(ka, dummy)),
            jc, jax.tree.map(np.asarray, jc.init(kc, dummy)))


def _port_update(cfg, env, jap, jcp, traj, perms):
    ta, tc = ff_ppo.build_networks(env, cfg, torch.Generator().manual_seed(0))
    load_flax_params(ta, jap)
    load_flax_params(tc, jcp)
    params = ActorCriticParams({k: v.detach() for k, v in ta.named_parameters()},
                               {k: v.detach() for k, v in tc.named_parameters()})
    optims = ff_ppo.make_optimizers(cfg)
    opt = ActorCriticOptStates(optims[0].init(params.actor_params),
                               optims[1].init(params.critic_params))
    learner = ff_ppo.get_learner_fn(None, (ff_ppo.make_apply_fn(ta), ff_ppo.make_apply_fn(tc)),
                                    optims, cfg)
    return learner.update(params, opt, _port_transition(traj),
                          permutations=[torch.from_numpy(p) for p in perms])


def _check(result, want_adv, want_losses, want_ap, want_cp, jap):
    got_adv = n(result.advantages).reshape(want_adv.shape)
    np.testing.assert_allclose(got_adv, want_adv, rtol=0, atol=1e-6)
    got_losses = np.stack([n(result.loss_info[k]).reshape(-1)
                           for k in ("actor_loss", "value_loss", "entropy")], axis=-1)
    np.testing.assert_allclose(got_losses, np.asarray(want_losses).reshape(got_losses.shape),
                               rtol=1e-5, atol=1e-7)
    for got, want in ((result.params.actor_params, want_ap),
                      (result.params.critic_params, want_cp)):
        got_tree = to_flax_params(got, want)
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5),
                     got_tree, want)
    moved = jax.tree.map(lambda g, w0: float(np.abs(g - np.asarray(w0)).max()),
                         to_flax_params(result.params.actor_params, jap), jap)
    assert max(jax.tree.leaves(moved)) > 1e-4


def test_ff_ppo_continuous_update_on_ant_matches_jax_with_one_gae_call(monkeypatch):
    root = "default/anakin/default_ff_ppo_continuous.yaml"
    overrides = ["env=ant", "env.kwargs.max_steps=3"] + UPDATE
    cfg = config_lib.compose(config_lib.default_config_dir(), root, overrides)
    jcfg = jax_config.compose(jax_config.default_config_dir(), root, overrides)
    env, _ = envs.make(cfg)
    ja, jap, jc, jcp = _flax_pair(
        jheads.NormalAffineTanhDistributionHead(8, minimum=-1.0, maximum=1.0), 27, 8, seed=5)
    traj = _rollout(env, 4, 8, 0, lambda ts, rng: torch.from_numpy(
        rng.uniform(-1, 1, (8, 8)).astype(np.float32)))
    traj["log_prob"] = np.asarray(ja.apply(jap, _jax_obs(traj["obs"])).log_prob(
        jnp.asarray(traj["action"])))
    assert traj["truncated"].any()  # the step limit of 3 inside 4 steps
    perms = [np.random.default_rng(10 + e).permutation(32) for e in range(2)]
    want_adv, want_losses, (want_ap, want_cp) = jax_continuous_update(
        ja, jap, jc, jcp, traj, [[p] for p in perms], jcfg, None, 1)
    calls = _count_b1_calls(monkeypatch)
    result = _port_update(cfg, env, jap, jcp, traj, perms)
    assert calls == {"gae": 1, "generic": 0}
    _check(result, want_adv[0], want_losses, want_ap, want_cp, jap)


def test_masked_ff_ppo_update_on_snake_matches_jax_with_one_gae_call(monkeypatch):
    overrides = ["env=snake", "env.kwargs.max_steps=5"] + UPDATE
    cfg = config_lib.compose(config_lib.default_config_dir(), "default/anakin/default_ff_ppo.yaml",
                             overrides)
    env, _ = envs.make(cfg)
    ja, jap, jc, jcp = _flax_pair(jheads.CategoricalHead(num_actions=4), 180, 4, seed=6)

    def act(ts, rng):  # uniform over the legal actions
        return torch.from_numpy(np.array([rng.choice(np.flatnonzero(m))
                                          for m in n(ts.observation.action_mask)]))

    raw = snake.Snake(6, 6, max_steps=5)

    def long_snakes(state):
        """Every other env starts 3 long, heading right along row 2: its
        reverse (left) is masked."""
        body, length, fruit = state.body.clone(), state.length.clone(), state.fruit.clone()
        body[::2, :3] = torch.tensor([[2, 2], [2, 1], [2, 0]])
        length[::2] = 3
        fruit[::2] = torch.tensor([5, 5])
        state = state._replace(body=body, length=length, heading=torch.ones_like(length),
                               fruit=fruit)
        ts = restart(raw._grid_obs(state), 8, torch.device("cpu"))
        ts.extras["truncation"] = torch.zeros((8,), dtype=torch.bool)
        return state, ts

    traj = _flat(_rollout(raw, 8, 8, 1, act, start=long_snakes))
    assert (traj["obs"]["action_mask"] == 0).any()  # the reverse is masked
    traj["log_prob"] = np.asarray(ja.apply(jap, _jax_obs(traj["obs"])).log_prob(
        jnp.asarray(traj["action"])))
    perms = [np.random.default_rng(20 + e).permutation(64) for e in range(2)]
    want_adv, want_tgt, want_losses, want_ap, want_cp = jax_discrete_update(
        ja, jap, jc, jcp, traj, perms, cfg)
    calls = _count_b1_calls(monkeypatch)
    result = _port_update(cfg, env, jap, jcp, traj, perms)
    assert calls == {"gae": 1, "generic": 0}
    np.testing.assert_allclose(n(result.targets), want_tgt, rtol=0, atol=1e-6)
    _check(result, want_adv, want_losses, want_ap, want_cp, jap)


SWEEP = ["arch.total_num_envs=8", "arch.num_evaluation=1", "arch.num_eval_episodes=4",
         "arch.absolute_metric=False", "arch.total_timesteps=~", "arch.num_updates=2",
         "logger.use_console=False"]
PATHS = {
    # label: (system module, root, overrides, B1 GAE calls an update)
    "ant_ppo": ("ppo.anakin.ff_ppo_continuous", "ff_ppo_continuous",
                ["env=ant", "env.kwargs.max_steps=12", "system.normalize_observations=true",
                 "system.rollout_length=4", "system.multistep_impl=pallas"], 1),
    "hopper_ppo": ("ppo.anakin.ff_ppo_continuous", "ff_ppo_continuous",
                   ["env=hopper", "env.kwargs.max_steps=12", "system.rollout_length=4",
                    "system.multistep_impl=pallas"], 1),
    "walker2d_ppo": ("ppo.anakin.ff_ppo_continuous", "ff_ppo_continuous",
                     ["env=walker2d", "env.kwargs.max_steps=12", "system.rollout_length=4",
                      "system.multistep_impl=pallas"], 1),
    "halfcheetah_ppo": ("ppo.anakin.ff_ppo_continuous", "ff_ppo_continuous",
                        ["env=halfcheetah", "env.kwargs.max_steps=12",
                         "system.rollout_length=4", "system.multistep_impl=pallas"], 1),
    "ant_sac": ("sac.ff_sac", "ff_sac", ["env=ant", "env.kwargs.max_steps=12",
                                         "system.warmup_steps=4", "system.rollout_length=2",
                                         "system.epochs=2", "system.total_batch_size=16"], 0),
    "snake_ppo": ("ppo.anakin.ff_ppo", "ff_ppo",
                  ["env=snake", "system.rollout_length=8", "system.multistep_impl=pallas"], 1),
    "game2048_ppo": ("ppo.anakin.ff_ppo", "ff_ppo", ["env=game_2048", "system.rollout_length=8",
                                                     "system.multistep_impl=pallas"], 1),
    "doorkey_ppo": ("ppo.anakin.ff_ppo", "ff_ppo", ["env=doorkey", "system.rollout_length=8",
                                                    "system.multistep_impl=pallas"], 1),
    "snake_dqn": ("q_learning.ff_dqn", "ff_dqn", ["env=snake"], 0),
    "snake_c51": ("q_learning.ff_c51", "ff_c51", ["env=snake"], 0),
    "snake_cnn_dqn": ("q_learning.ff_dqn", "ff_dqn",
                      ["env=snake", "network=cnn_dqn", "env.wrapper.flatten_observation=false"],
                      0),
}


@pytest.mark.parametrize("label", list(PATHS))
def test_path_runs_on_cpu_with_its_b1_calls(label, monkeypatch):
    module, root, overrides, gae = PATHS[label]
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             f"default/anakin/default_{root}.yaml", overrides + SWEEP)
    calls = _count_b1_calls(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        final_return = importlib.import_module(
            f"stoix_tpu_torch.systems.{module}").run_experiment(cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(final_return)
    assert calls == {"gae": 2 * gae, "generic": 0}
