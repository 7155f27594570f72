"""Population training in the PyTorch port (stoix_tpu_torch/population)
against the JAX package's (stoix_tpu/population, tests/test_population.py).

Inputs are made with numpy from a seed and go through both packages: the
hparam lifting and its refusals, truncation selection, the PBT step and the
quarantine on a toy population fed JAX's coins, and the member fingerprints,
exactly; one population update at P = 2 with lifted hparams against JAX's
learner composition under `jax.vmap` over the members (losses 1e-5
relative, params 1e-5 absolute, advantages 1e-6). The runs are the port's
own: P = 1 against the plain ff_ppo run bit for bit, the P = 8 IdentityGame
run with PBT held to the JAX test's assertions, a resume against the
unbroken run bit for bit, and on two gloo ranks the members spread over the
"pop" axis (bit for bit the population on one rank) and the fleet's rescue
store restored with every rank-bound member leaf each rank's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stoix_tpu.ops import losses as jlosses
from stoix_tpu.ops.multistep import truncated_generalized_advantage_estimation as jax_gae
from stoix_tpu.population import hparams as jax_hparams
from stoix_tpu.population import pbt as jax_pbt
from stoix_tpu.population.runner import PopulationState as JaxPopulationState
from stoix_tpu.systems.ppo.anakin.ff_ppo import PPOLearnerState as JaxLearnerState
from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams, PPOTransition
from stoix_tpu_torch.envs.types import Observation as TorchObservation
from stoix_tpu_torch.population import hparams as hparams_lib
from stoix_tpu_torch.population import pbt as pbt_lib
from stoix_tpu_torch.population import runner as prun
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.checkpointing import flatten_state
from stoix_tpu_torch.utils.training import ClipAdam
from torch_parity import n, paired_networks, t, to_flax_params

ROOT = "default/population/default_ff_ppo.yaml"
BASE_OVERRIDES = [  # tests/test_population.py's
    "env=identity_game",
    "arch.total_num_envs=16",
    "arch.num_updates=4",
    "arch.total_timesteps=~",
    "arch.num_evaluation=2",
    "arch.num_eval_episodes=8",
    "arch.absolute_metric=False",
    "system.rollout_length=4",
    "system.epochs=1",
    "system.num_minibatches=2",
    "logger.use_console=False",
]
LIFTED_DEFAULTS = {  # every liftable learner scalar at its config value
    "system.ent_coef": 0.01, "system.actor_lr": 3.0e-4, "system.critic_lr": 3.0e-4,
    "system.gamma": 0.99, "system.clip_eps": 0.2, "system.gae_lambda": 0.95,
    "system.vf_coef": 0.5, "system.reward_scale": 1.0,
}
PBT_ON = {"enabled": True, "interval": 2, "quantile": 0.25, "perturb_scale": 0.2}


def compose(extra=(), size=None, hparams=None, pbt=None, root=ROOT):
    cfg = config_lib.compose(config_lib.default_config_dir(), root,
                             BASE_OVERRIDES + list(extra))
    if size is not None:
        config_lib._set_dotted(cfg, "arch.population.size", size)
    if hparams:
        config_lib._set_dotted(cfg, "arch.population.hparams", hparams)
    if pbt:
        config_lib._set_dotted(cfg, "arch.population.pbt", pbt)
    return cfg


def snapshot(tree):
    """Host copies of every leaf, generators as their states."""
    out = {}
    for path, leaf in flatten_state(tree):
        if isinstance(leaf, torch.Generator):
            leaf = leaf.get_state()
        out["/".join(path)] = leaf.detach().cpu().clone() if isinstance(leaf, torch.Tensor) \
            else leaf
    return out


def assert_same(got, want, label=""):
    assert sorted(got) == sorted(want), label
    for key, value in want.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(got[key], value), f"{label}{key}"
        else:
            assert got[key] == value, f"{label}{key}"


def record_population(cfg, device="cpu"):
    trajectory = []

    def setup(env, config, dev, seed):
        built = prun.population_setup(env, config, dev, seed)
        inner = built.learn

        def learn(state):
            out = inner(state)
            trajectory.append(snapshot(out.learner_state))
            return out

        return built._replace(learn=learn)

    final = runner.run_anakin_experiment(cfg, setup, device, outer_axes=("pop",))
    return trajectory, final


def record_plain(cfg):
    trajectory = []

    def setup(env, config, dev, seed):
        built = ff_ppo.learner_setup(env, config, dev, seed)
        inner = built.learn

        def learn(state):
            out = inner(state)
            trajectory.append(snapshot(out.learner_state))
            return out

        return built._replace(learn=learn)

    runner.run_anakin_experiment(cfg, setup, "cpu", outer_axes=("group",))
    return trajectory


# ------------------------------------------------------------ hparams


LIFT_CASES = {
    "lists_and_scalars": {"size": 4, "hparams": {"system.ent_coef": [0.0, 0.01, 0.02, 0.03],
                                                  "system.actor_lr": 3e-4,
                                                  "arch.seed": [1, 2, 3, 4]}},
    "every_key": {"size": 2, "hparams": {k: [0.1, 0.7] if k != "arch.seed" else 5
                                          for k in jax_hparams.LIFTABLE_HPARAMS}},
    "empty": {"size": 3},
    "not_liftable": {"size": 2, "hparams": {"system.epochs": [1, 2]}},
    "wrong_length": {"size": 3, "hparams": {"system.ent_coef": [0.0, 0.1]}},
    "zero_size": {"size": 0},
}


@pytest.mark.parametrize("case", sorted(LIFT_CASES))
def test_lift_hparams_equals_the_jax_package(case):
    config = {"arch": {"population": LIFT_CASES[case]}}
    try:
        want = jax_hparams.lift_hparams(config)
    except jax_hparams.PopulationConfigError as error:
        with pytest.raises(hparams_lib.PopulationConfigError) as got:
            hparams_lib.lift_hparams(config)
        assert str(got.value) == str(error)
        return
    size, arrays = hparams_lib.lift_hparams(config)
    assert size == want[0] and sorted(arrays) == sorted(want[1])
    for name, values in want[1].items():
        assert arrays[name].dtype == values.dtype and arrays[name].tobytes() == values.tobytes()
    assert hparams_lib.learner_hparams(arrays).keys() == jax_hparams.learner_hparams(
        want[1]).keys()
    assert hparams_lib.LIFTABLE_HPARAMS == jax_hparams.LIFTABLE_HPARAMS
    assert hparams_lib.PERTURBABLE == jax_hparams.PERTURBABLE


# ------------------------------------------------------------ selection


SELECTION_CASES = [
    ([10.0, 2.0, 8.0, 1.0, 5.0, 7.0, 3.0, 9.0], 0.25),
    ([1.0, np.nan, 2.0, 3.0], 0.25),
    ([np.inf, -np.inf, np.nan, 0.0, 0.0, 0.0, np.inf, -1.0], 0.25),
    ([np.inf, -np.inf, np.nan, 0.0, 0.0, 0.0, np.inf, -1.0], 0.5),
    ([1.0] * 8, 0.25),
    ([np.nan] * 6, 0.34),
    ([3.0, -np.inf, 3.0, np.nan, 2.0, 2.0, 2.0, 7.0, np.inf, 1.0], 0.1),
    ([5.0], 0.25),
]


@pytest.mark.parametrize("fitness,quantile", SELECTION_CASES)
def test_truncation_selection_equals_the_jax_package(fitness, quantile):
    fitness = np.asarray(fitness, np.float32)
    want_src, want_bottom = jax_pbt.truncation_selection(jnp.asarray(fitness), len(fitness),
                                                         quantile)
    src, bottom = pbt_lib.truncation_selection(torch.from_numpy(fitness), len(fitness), quantile)
    assert src.tolist() == np.asarray(want_src).tolist()
    assert bottom.tolist() == np.asarray(want_bottom).tolist()


# ------------------------------------------------------------ the PBT step on a toy state


def toy_arrays(pop_size=8, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.arange(pop_size, dtype=np.float32)
    return {
        "w": rng.normal(size=(pop_size, 3)).astype(np.float32),
        "b": rng.normal(size=(pop_size, 2)).astype(np.float32),
        "v": 100.0 + idx[:, None] * np.ones((pop_size, 2), np.float32),
        "mu": 0.5 * idx[:, None] * np.ones((pop_size, 3), np.float32),
        "nu": 0.25 * idx,
        "count": np.arange(pop_size, dtype=np.int64) + 3,
        "key": np.tile(np.arange(pop_size, dtype=np.uint32)[:, None, None, None], (1, 1, 1, 2)),
        "stream": rng.integers(0, 256, size=(pop_size, 16)).astype(np.uint8),
        "idx": idx,
        "ent_coef": (0.01 * (idx + 1.0)).astype(np.float32),
        "actor_lr": (1e-4 * (idx + 1.0)).astype(np.float32),
        "fitness": np.asarray([10.0, 2.0, 8.0, 1.0, 5.0, 7.0, 3.0, 9.0], np.float32),
    }


def jax_toy(a, updates_done=2):
    j = jnp.asarray
    members = JaxLearnerState(
        params=ActorCriticParams({"w": j(a["w"]), "b": j(a["b"])}, {"v": j(a["v"])}),
        opt_states=ActorCriticOptStates({"mu": j(a["mu"]), "count": j(a["count"])},
                                        {"nu": j(a["nu"])}),
        key=j(a["key"]), env_state={"s": j(a["idx"])}, timestep={"t": j(a["idx"])},
        obs_stats={"mean": j(a["idx"])}, kl_beta=j(a["idx"]),
    )
    return JaxPopulationState(
        members=members, hparams={"ent_coef": j(a["ent_coef"]), "actor_lr": j(a["actor_lr"])},
        fitness=j(a["fitness"]), updates_done=jnp.asarray(updates_done, jnp.int32),
        pbt_key=jax.random.PRNGKey(123), exploit_total=jnp.asarray(0, jnp.int32),
    )


def port_toy(a, updates_done=2):
    c = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    members = ff_ppo.PPOLearnerState(
        params=ActorCriticParams({"w": c(a["w"]), "b": c(a["b"])}, {"v": c(a["v"])}),
        opt_states=ActorCriticOptStates({"mu": c(a["mu"]), "count": c(a["count"])},
                                        {"nu": c(a["nu"])}),
        generator=c(a["stream"]), env_state={"s": c(a["idx"])}, timestep={"t": c(a["idx"])},
        obs_stats={"mean": c(a["idx"])}, kl_beta=c(a["idx"]),
    )
    return prun.PopulationState(
        members=members, hparams={"ent_coef": c(a["ent_coef"]), "actor_lr": c(a["actor_lr"])},
        fitness=c(a["fitness"]), updates_done=updates_done,
        pbt_generator=torch.Generator().manual_seed(7), exploit_total=0,
    )


def jax_coins(state, pop_size):
    """The coins JAX's pbt step draws (its key path, pbt.py:113, 99-101)."""
    _, hp_key, _ = jax.random.split(state.pbt_key, 3)
    return {name: torch.from_numpy(np.array(
        jax.random.bernoulli(jax.random.fold_in(hp_key, i), 0.5, (pop_size,))))
        for i, name in enumerate(sorted(state.hparams))}


def assert_rows_equal(port_tree, jax_tree):
    got = [n(x) for x in pbt_lib._sorted_leaves(port_tree)]
    want = [np.asarray(x) for x in jax.tree.leaves(jax_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.tobytes() == w.astype(g.dtype).tobytes()


@pytest.mark.parametrize("updates_done", [0, 2, 3, 4])
def test_pbt_step_equals_the_jax_package_fed_its_coins(updates_done):
    a = toy_arrays()
    settings = jax_pbt.PBTSettings(enabled=True, interval=2, quantile=0.25, perturb_scale=0.2)
    jstate = jax_toy(a, updates_done)
    want = jax.jit(jax_pbt.make_pbt_step(settings, 8))(jstate)
    pstate = port_toy(a, updates_done)
    got = pbt_lib.make_pbt_step(pbt_lib.PBTSettings(*settings), 8)(pstate,
                                                                    coins=jax_coins(jstate, 8))
    for field in ("params", "opt_states", "obs_stats", "kl_beta", "env_state", "timestep"):
        assert_rows_equal(getattr(got.members, field), getattr(want.members, field))
    for name in want.hparams:  # exact float32 products
        assert n(got.hparams[name]).tobytes() == np.asarray(want.hparams[name]).tobytes(), name
    assert n(got.fitness).tobytes() == np.asarray(want.fitness).tobytes()
    assert got.exploit_total == int(want.exploit_total)
    # The step streams: fresh exactly where JAX resamples its keys.
    resampled = [not np.array_equal(np.asarray(want.members.key)[i], a["key"][i])
                 for i in range(8)]
    fresh = [not torch.equal(got.members.generator[i], pstate.members.generator[i])
             for i in range(8)]
    assert fresh == resampled
    assert any(fresh) == (updates_done in (2, 4))


def test_perturb_hparams_equals_the_jax_package():
    a = toy_arrays()
    jstate = jax_toy(a)
    coins = jax_coins(jstate, 8)
    src = np.array([0, 7, 2, 0, 4, 5, 1, 7], np.int32)
    do = np.array([False, True, False, True, False, False, True, False])
    _, hp_key, _ = jax.random.split(jstate.pbt_key, 3)
    want = jax_pbt.perturb_hparams(jstate.hparams, jnp.asarray(src), jnp.asarray(do), hp_key,
                                   0.3)
    got = pbt_lib.perturb_hparams(port_toy(a).hparams, torch.from_numpy(src.astype(np.int64)),
                                  torch.from_numpy(do), coins, 0.3)
    for name in want:
        assert n(got[name]).tobytes() == np.asarray(want[name]).tobytes(), name


def test_member_fingerprints_and_quarantine_equal_the_jax_package():
    a = toy_arrays(seed=3)
    jstate, pstate = jax_toy(a), port_toy(a)
    want = np.asarray(jax_pbt.member_fingerprints(jstate.members.params))
    got = pbt_lib.member_fingerprints(pstate.members.params)
    assert got.dtype == np.uint32 and got.tolist() == want.tolist()
    assert len(set(got.tolist())) == 8
    same = ActorCriticParams(*(
        {k: torch.cat([v[:5], v[2:3], v[6:]]) for k, v in side.items()}
        for side in pstate.members.params))
    prints = pbt_lib.member_fingerprints(same)
    assert prints[5] == prints[2]
    quarantine = jax.jit(lambda s, c: jax_pbt.quarantine_members(s, c, 8))
    for corrupt_members in ([4], [0, 7], [0, 1, 2, 3, 4, 5, 6]):
        corrupt = np.zeros(8, bool)
        corrupt[corrupt_members] = True
        healed = quarantine(jstate, jnp.asarray(corrupt))
        mine = pbt_lib.quarantine_members(port_toy(a), torch.from_numpy(corrupt), 8)
        for field in ("params", "opt_states", "obs_stats", "kl_beta", "env_state"):
            assert_rows_equal(getattr(mine.members, field), getattr(healed.members, field))
        for name in healed.hparams:
            assert n(mine.hparams[name]).tobytes() == np.asarray(healed.hparams[name]).tobytes()
        assert n(mine.fitness).tobytes() == np.asarray(healed.fitness).tobytes()
        fresh = [not torch.equal(mine.members.generator[i], pstate.members.generator[i])
                 for i in range(8)]
        assert fresh == corrupt.tolist()


# ------------------------------------------------------------ one population update at P = 2


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


def _jax_members_update(ja, jc, params, hp, trajs, perms, cfg):
    """The JAX package's per-member update (ff_ppo.py:345-400 with traced
    hparams, `u * (-lr)` after scale_by_adam) under jax.vmap over members."""
    from stoix_tpu.envs.types import Observation

    s = cfg.system
    clip = optax.clip_by_global_norm(float(s.max_grad_norm))
    actor_optim = optax.chain(clip, optax.scale_by_adam(eps=1e-5))
    critic_optim = optax.chain(clip, optax.scale_by_adam(eps=1e-5) if "critic_lr" in hp
                               else optax.adam(float(s.critic_lr), eps=1e-5))

    def member(actor_params, critic_params, hp, traj, perms):
        # The JAX package's ff_ppo.py:114-121: a lifted scalar, else the config's.
        get = lambda name: hp.get(name, float(s.get(name, 1.0)))  # noqa: E731
        clip_eps, vf_coef = get("clip_eps"), get("vf_coef")
        as_obs = lambda o: Observation(*(o[k] for k in Observation._fields))  # noqa: E731
        obs, next_obs = as_obs(traj["obs"]), as_obs(traj["next_obs"])
        d_t = get("gamma") * (1.0 - traj["done"].astype(jnp.float32))
        advantages, targets = jax_gae(
            traj["reward"] * get("reward_scale"), d_t, get("gae_lambda"), v_tm1=traj["value"],
            v_t=jc.apply(critic_params, next_obs),
            truncation_t=traj["truncated"].astype(jnp.float32),
            standardize_advantages=True, impl="scan")

        def actor_loss(p, obs, action, old_log_prob, gae):
            dist = ja.apply(p, obs)
            loss = jlosses.ppo_clip_loss(dist.log_prob(action), old_log_prob, gae, clip_eps)
            entropy = dist.entropy().mean()
            return loss - get("ent_coef") * entropy, (loss, entropy)

        def critic_loss(p, obs, targets, old_value):
            value_loss = jlosses.clipped_value_loss(jc.apply(p, obs), old_value, targets,
                                                    clip_eps)
            return vf_coef * value_loss, value_loss

        a_state, c_state = actor_optim.init(actor_params), critic_optim.init(critic_params)
        flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]),
                            (obs, traj["action"], traj["log_prob"], traj["value"], advantages,
                             targets))
        def minibatch(carry, idx):  # epoch e's minibatch i is perms[e][i·B:(i + 1)·B]
            actor_params, critic_params, a_state, c_state = carry
            mb_obs, mb_act, mb_lp, mb_val, mb_adv, mb_tgt = jax.tree.map(
                lambda x: jnp.take(x, idx, axis=0), flat)
            a_grads, (loss_actor, entropy) = jax.grad(actor_loss, has_aux=True)(
                actor_params, mb_obs, mb_act, mb_lp, mb_adv)
            c_grads, value_loss = jax.grad(critic_loss, has_aux=True)(
                critic_params, mb_obs, mb_tgt, mb_val)
            updates, a_state = actor_optim.update(a_grads, a_state)
            updates = jax.tree.map(lambda u: u * (-get("actor_lr")), updates)
            actor_params = optax.apply_updates(actor_params, updates)
            updates, c_state = critic_optim.update(c_grads, c_state)
            if "critic_lr" in hp:
                updates = jax.tree.map(lambda u: u * (-hp["critic_lr"]), updates)
            critic_params = optax.apply_updates(critic_params, updates)
            return ((actor_params, critic_params, a_state, c_state),
                    jnp.stack([loss_actor, value_loss, entropy]))

        (actor_params, critic_params, _, _), losses = jax.lax.scan(
            minibatch, (actor_params, critic_params, a_state, c_state),
            perms.reshape(perms.shape[0] * s.num_minibatches, -1))
        return advantages, targets, losses, actor_params, critic_params

    return jax.jit(jax.vmap(member))(params[0], params[1], hp, trajs, perms)


MEMBER_HPARAMS = {  # two members' lifted scalars, each case at values off the config's
    "ent_lambda_actor_lr": {"system.ent_coef": [0.01, 0.05], "system.gae_lambda": [0.95, 0.8],
                            "system.actor_lr": [1e-3, 3e-3]},
    "the_other_five": {"system.clip_eps": [0.1, 0.3], "system.vf_coef": [0.25, 0.7],
                       "system.gamma": [0.9, 0.97], "system.reward_scale": [0.5, 2.0],
                       "system.critic_lr": [1e-3, 5e-4]},
}


@pytest.mark.parametrize("lifted", sorted(MEMBER_HPARAMS))
def test_population_update_at_two_members_matches_jax_under_vmap(monkeypatch, lifted):
    cfg = config_lib.compose(config_lib.default_config_dir(), ROOT, [
        "system.epochs=2", "system.num_minibatches=4", "arch.num_updates_per_eval=1"])
    config_lib._set_dotted(cfg, "arch.population.size", 2)
    config_lib._set_dotted(cfg, "arch.population.hparams", MEMBER_HPARAMS[lifted])
    t_len, n_envs, obs_dim, num_actions = 8, 16, 6, 3
    pairs = [paired_networks(obs_dim, num_actions, (32, 32), seed=4 + p) for p in range(2)]
    trajs = [_trajectory(p, t_len, n_envs, obs_dim, num_actions) for p in range(2)]
    perms = np.stack([[np.random.default_rng(10 + 2 * p + e).permutation(t_len * n_envs)
                       for e in range(2)] for p in range(2)])
    size, arrays = hparams_lib.lift_hparams(cfg)
    ja, jc = pairs[0][0], pairs[0][2]
    stack = lambda *xs: jnp.stack(xs)  # noqa: E731
    want = _jax_members_update(
        ja, jc, (jax.tree.map(stack, pairs[0][1], pairs[1][1]),
                 jax.tree.map(stack, pairs[0][3], pairs[1][3])),
        {k: jnp.asarray(v) for k, v in arrays.items()},
        jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *trajs),
        jnp.asarray(perms), cfg)

    gae_calls = []
    real_gae = ff_ppo.truncated_generalized_advantage_estimation

    def counted(*args, **kwargs):
        gae_calls.append(args[2])
        return real_gae(*args, **kwargs)

    monkeypatch.setattr(ff_ppo, "truncated_generalized_advantage_estimation", counted)
    ta, tc = pairs[0][4], pairs[0][5]
    optims = tuple(ClipAdam(float(cfg.system.actor_lr), cfg.system.max_grad_norm, eps=1e-5)
                   for _ in range(2))
    learner = prun.PopulationLearner(
        None, (ff_ppo.make_apply_fn(ta), ff_ppo.make_apply_fn(tc)), optims, cfg, layout=None)
    state = prun.PopulationState(None, {k: torch.from_numpy(v) for k, v in arrays.items()},
                                 torch.zeros(size), 0, None, 0)
    as_obs = lambda o: TorchObservation(*(t(o[k]) for k in TorchObservation._fields))  # noqa
    for p, hparams in enumerate(learner.member_hparams(state)):
        member = learner.member_learner(hparams)
        actor = {k: v.detach() for k, v in pairs[p][4].named_parameters()}
        critic = {k: v.detach() for k, v in pairs[p][5].named_parameters()}
        traj = trajs[p]
        result = member.update(
            ActorCriticParams(actor, critic),
            ActorCriticOptStates(member.actor_optim.init(actor), member.critic_optim.init(critic)),
            PPOTransition(done=t(traj["done"]), truncated=t(traj["truncated"]),
                          action=t(traj["action"]), value=t(traj["value"]),
                          reward=t(traj["reward"]), log_prob=t(traj["log_prob"]),
                          obs=as_obs(traj["obs"]), next_obs=as_obs(traj["next_obs"]), info={}),
            permutations=[torch.from_numpy(x) for x in perms[p]])
        w_adv, w_tgt, w_losses, w_actor, w_critic = (jax.tree.map(lambda x: x[p], part)
                                                     for part in want)
        np.testing.assert_allclose(n(result.advantages), w_adv, rtol=0, atol=1e-6)
        np.testing.assert_allclose(n(result.targets), w_tgt, rtol=0, atol=1e-6)
        got_losses = np.stack([n(result.loss_info[k]).reshape(-1)
                               for k in ("actor_loss", "value_loss", "entropy")], axis=1)
        np.testing.assert_allclose(got_losses, np.asarray(w_losses), rtol=1e-5, atol=1e-7)
        for got, w in ((result.params.actor_params, w_actor),
                       (result.params.critic_params, w_critic)):
            jax.tree.map(lambda g, x: np.testing.assert_allclose(g, np.asarray(x), rtol=0,
                                                                 atol=1e-5),
                         to_flax_params(got, w), w)
        for name, value in hparams.items():
            held = (getattr(member, f"{name.split('_')[0]}_optim").learning_rate
                    if name.endswith("_lr") else getattr(member, name))
            assert held == float(arrays[name][p]) == value, name
    # One GAE call a member, each at the member's float32 lambda.
    assert gae_calls == ([float(v) for v in arrays["gae_lambda"]] if "gae_lambda" in arrays
                         else [float(cfg.system.gae_lambda)] * 2)


# ------------------------------------------------------------ runs


@pytest.mark.parametrize("lifted", [False, True])
def test_population_of_one_is_the_plain_run_bit_for_bit(lifted):
    plain = record_plain(config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_ppo.yaml", BASE_OVERRIDES))
    pop, _ = record_population(compose(hparams=LIFTED_DEFAULTS if lifted else None))
    assert len(plain) == len(pop) == 2
    for window, (a, b) in enumerate(zip(plain, pop)):
        members = {k[len("members/"):]: v for k, v in b.items() if k.startswith("members/")}
        assert sorted(members) == sorted(a)
        for key, value in a.items():
            if value is None:
                assert members[key] is None, key
                continue
            row = members[key][0]
            if isinstance(value, torch.Tensor):
                assert torch.equal(row, value), f"window {window}: {key}"
            else:
                assert int(row) == value, f"window {window}: {key}"
        assert b["updates_done"] == window + 1 and b["exploit_total"] == 0


def test_p8_identity_run_with_pbt_holds_the_jax_tests_assertions():
    ent = [0.001 * (i + 1) for i in range(8)]
    traj, final = record_population(compose(
        ["arch.num_updates=4", "arch.num_evaluation=4"], size=8,
        hparams={"system.ent_coef": ent}, pbt=PBT_ON))
    assert len(traj) == 4 and np.isfinite(final)
    params = [{k: v for k, v in w.items() if k.startswith("members/params/")} for w in traj]

    def dup_pairs(leaves):
        return {(i, j) for i in range(8) for j in range(i + 1, 8)
                if all(torch.equal(v[i], v[j]) for v in leaves.values())}

    assert len(dup_pairs(params[1])) >= 2, "window 2 fired: clones expected"
    assert len(dup_pairs(params[3])) >= 2, "window 4 fired: clones expected"
    assert not dup_pairs(params[0]), "window 1: no selection yet"
    assert not dup_pairs(params[2]), "window 3: clones must have diverged"
    assert traj[-1]["exploit_total"] == 4
    for fire in (1, 3):
        prev = traj[fire - 1]["hparams/ent_coef"].numpy()
        new = traj[fire]["hparams/ent_coef"].numpy()
        allowed = set(prev.tolist())
        for factor in (np.float32(0.8), np.float32(1.2)):
            allowed |= set((prev * factor).tolist())
        changed = [float(v) for v, p in zip(new, prev) if v != p]
        assert changed and all(v in allowed for v in changed), (changed, sorted(allowed))
    fitness = traj[-1]["fitness"]
    assert fitness.shape == (8,) and torch.isfinite(fitness).all()


def test_run_population_experiment_fills_its_stats():
    final = prun.run_population_experiment(
        compose(size=2, hparams={"system.ent_coef": [0.0, 0.02]}, pbt=PBT_ON), device="cpu")
    stats = prun.LAST_POPULATION_STATS
    assert np.isfinite(final) and runner.LAST_RUN_STATS["device"] == "cpu"
    assert stats["population_size"] == 2 and stats["pbt_enabled"] is True
    assert stats["windows"] == 2 and stats["pbt_exploits"] == 1
    assert len(stats["member_fitness"]) == 2 and len(stats["hparams"]["ent_coef"]) == 2


def test_resume_continues_the_unbroken_run_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    common = ["arch.num_updates=4", "arch.num_evaluation=4",
              "logger.checkpointing.save_model=true",
              "logger.checkpointing.save_args.max_to_keep=~"]
    kwargs = dict(size=4, hparams={"system.ent_coef": [0.001, 0.002, 0.003, 0.004]},
                  pbt=PBT_ON)
    whole, _ = record_population(compose(
        common + ["logger.checkpointing.save_args.checkpoint_uid=whole"], **kwargs))
    monkeypatch.setenv("STOIX_TPU_FAULT", "sigterm:1")
    try:
        stopped, _ = record_population(compose(
            common + ["logger.checkpointing.save_args.checkpoint_uid=stopped"], **kwargs))
    finally:
        monkeypatch.delenv("STOIX_TPU_FAULT")
    assert runner.LAST_RUN_STATS["resilience"]["preempted"] and len(stopped) == 2
    resumed, _ = record_population(compose(
        ["arch.num_updates=2", "arch.num_evaluation=2",
         "logger.checkpointing.load_model=true",
         "logger.checkpointing.load_args.checkpoint_uid=stopped"], **kwargs))
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == 2 * 4 * 16
    for window, (a, b) in enumerate(zip(resumed, whole[2:])):
        assert_same(a, b, f"resumed window {window}: ")
    assert whole[-1]["exploit_total"] == 2 and whole[-1]["updates_done"] == 4


# ------------------------------------------------------------ refusals and the entry point


REFUSALS = {  # (root, overrides, lifted hparams, what the message names)
    "no_pop_axis": ("default/anakin/default_ff_ppo.yaml", [], None, "'pop' mesh axis"),
    "integrity": (ROOT, ["arch.integrity.enabled=true"], None, "integrity"),
    "fused_eval": (ROOT, ["arch.fused_eval=true"], None, "fused_eval"),
    "decayed_lr": (ROOT, ["system.decay_learning_rates=true"], {"system.actor_lr": 1e-3},
                   "decay_learning_rates"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_carry_the_jax_packages_messages(case):
    from stoix_tpu.population import runner as jax_runner
    from stoix_tpu.utils import config as jax_config

    root, overrides, hparams, match = REFUSALS[case]
    with pytest.raises(hparams_lib.PopulationConfigError, match=match) as got:
        prun.run_population_experiment(compose(overrides, hparams=hparams, root=root),
                                       device="cpu")
    if case == "no_pop_axis":
        want = ("population training needs a 'pop' mesh axis; arch.mesh declares "
                "{'data': 1} — compose with arch=population (or add pop to arch.mesh)")
    elif case == "decayed_lr":
        want = ("system.decay_learning_rates cannot combine with a lifted "
                "actor_lr/critic_lr: per-member learning rates are flat scalars")
    else:
        mesh = type("Mesh", (), {"axis_names": ("pop", "data"), "shape": {"pop": 1, "data": 1}})
        jax_cfg = jax_config.compose(jax_config.default_config_dir(), root,
                                     BASE_OVERRIDES + overrides)
        with pytest.raises(jax_hparams.PopulationConfigError) as jax_error:
            jax_runner._validate_population_config(jax_cfg, mesh)
        want = str(jax_error.value)
    assert str(got.value) == want


def test_pop_axis_needs_its_ranks_and_other_systems_refuse_it_naming_the_key():
    cfg = compose(["arch.mesh.pop=2", "arch.mesh.data=1"], size=2)
    with pytest.raises(ValueError, match=r"arch\.mesh\.pop=2, arch\.mesh\.data=1"):
        prun.run_population_experiment(cfg, device="cpu")
    plain = config_lib.compose(config_lib.default_config_dir(),
                               "default/anakin/default_ff_ppo.yaml",
                               BASE_OVERRIDES + ["arch.mesh.pop=1"])
    with pytest.raises(NotImplementedError, match=r"arch\.mesh\.pop"):
        ff_ppo.run_experiment(plain, device="cpu")
    runner.check_ported_arch(compose(), outer_axes=("pop",))


def test_entry_point_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        prun.run_population_experiment(compose(size=2))
    monkeypatch.setattr("sys.argv", ["runner", "env=identity_game"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        prun.main()


# ------------------------------------------------------------ members over ranks


RANKS_RUN = dict(overrides=BASE_OVERRIDES + ["arch.num_updates=4", "arch.num_evaluation=4"],
                 size=4, hparams={"system.ent_coef": [0.001, 0.002, 0.003, 0.004]},
                 pbt={"enabled": True, "interval": 1, "quantile": 0.5, "perturb_scale": 0.2})


RESCUE = dict(overrides=BASE_OVERRIDES, size=4,
              hparams={"system.ent_coef": [0.001, 0.002, 0.003, 0.004]})


def one_process_rescue_store(directory):
    """A one-process population's rescue store after one window: its path
    and the state it holds, by tree path."""
    from torch_population_worker import population_config, save_rescue, state_leaves

    from stoix_tpu_torch import envs
    from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps

    cfg = check_total_timesteps(population_config(RESCUE["overrides"], RESCUE["size"],
                                                  RESCUE["hparams"]), 1)
    env, _ = envs.make(cfg)
    setup = prun.population_setup(env, cfg, torch.device("cpu"), 5)
    state = setup.learn(setup.learner_state).learner_state
    save_rescue(state, directory)
    return str(directory), state_leaves(state)


@pytest.fixture(scope="module")
def one_and_two_ranks(tmp_path_factory):
    """The population on one rank and over two (`pop = 2`), a refused size,
    and the rescue stores of two ranks under `data = 2` and `pop = 2`
    restored at the same world, with a one-process store restored over two."""
    from torch_population_worker import population_run
    from torch_ring_worker import spawn_ranks

    root = tmp_path_factory.mktemp("population_ranks")
    one = population_run(None, cwd=str(root / "one"), **RANKS_RUN)
    one_store = one_process_rescue_store(root / "one_store")
    over_two = RANKS_RUN["overrides"] + ["arch.mesh.pop=2", "arch.mesh.data=1"]
    two = spawn_ranks([
        ("pop2", "population_run", dict(RANKS_RUN, overrides=over_two, cwd=str(root / "two"))),
        ("odd", "population_refusal", dict(overrides=over_two, size=3, cwd=str(root / "odd"))),
        ("rescue_data2", "population_rescue", dict(RESCUE, axes={"pop": 1, "data": 2},
                                                   cwd=str(root / "rescue_data2"),
                                                   one_store=one_store[0])),
        ("rescue_pop2", "population_rescue", dict(RESCUE, axes={"pop": 2, "data": 1},
                                                  cwd=str(root / "rescue_pop2"))),
    ], 2, root)
    return {"one": one, "two": two, "one_store": one_store, "root": root}


def test_members_over_two_ranks_are_the_population_on_one_bit_for_bit(one_and_two_ranks):
    one, two = one_and_two_ranks["one"], one_and_two_ranks["two"]
    ranks = [rank["pop2"] for rank in two]
    assert len(one["windows"]) == 4
    crossed = 0
    for window, whole in enumerate(one["windows"]):
        for rank, run in enumerate(ranks):
            part = run["windows"][window]
            assert sorted(part) == sorted(whole)
            for key, value in whole.items():
                want = value[2 * rank:2 * rank + 2] if key.startswith("members/") else value
                assert part[key].tobytes() == want.tobytes(), f"window {window} rank {rank} {key}"
        params = [v for k, v in whole.items() if k.startswith("members/params/")]
        crossed += sum(1 for i in range(4) for j in range(i + 1, 4)
                       if i // 2 != j // 2 and all(np.array_equal(v[i], v[j]) for v in params))
    # A source on one rank copied into a member of the other: the exchange ran.
    assert crossed >= 1
    assert [run["final_return"] for run in ranks] == [one["final_return"]] * 2
    for run in ranks:
        assert run["stats"] == one["stats"]


def test_a_size_that_does_not_divide_over_the_pop_ranks_is_refused(one_and_two_ranks):
    two = one_and_two_ranks["two"]
    # The JAX package's message (stoix_tpu/population/runner.py:112-116).
    assert [rank["odd"] for rank in two] == [
        "arch.population.size (3) must divide over the pop mesh axis (2 shard(s))"] * 2


# ------------------------------------------------------------ rescue stores over ranks


def _assert_rank_bound(run, rank, own, label):
    """Every leaf under the `own` subtrees is this rank's fresh value; every
    other is the saved one of rank 0 (the store's)."""
    for key, value in run["fresh"].items():
        mine = any(key == p or key.startswith(f"{p}/") for p in own)
        want = value if mine else run["saved0"][key]
        assert run[label][key].tobytes() == want.tobytes(), f"rank {rank} {label} {key}"


@pytest.mark.parametrize("axes", ["data2", "pop2"])
def test_a_population_rescue_store_restores_each_ranks_own_members(one_and_two_ranks, axes):
    ranks = [dict(rank[f"rescue_{axes}"]) for rank in one_and_two_ranks["two"]]
    own = (("members/env_state", "members/timestep", "members/generator") if axes == "data2"
           else ("members",))
    saved = ranks[0]["saved"]
    partial = sorted(k for k in saved if any(k == p or k.startswith(f"{p}/") for p in own))
    for run in ranks:
        assert partial and run["partial"] == partial, (
            sorted(set(run["partial"]) ^ set(partial)))
    if axes == "data2":  # the replicas agree on everything but their own
        assert all(ranks[1]["saved"][k].tobytes() == v.tobytes() for k, v in saved.items()
                   if k not in partial)
    # Each rank's own rows differ from the other's: the check below can fail.
    assert any(ranks[0]["fresh"][k].tobytes() != ranks[1]["fresh"][k].tobytes()
               for k in partial)
    for rank, run in enumerate(ranks):
        run["saved0"] = saved
        _assert_rank_bound(run, rank, own, "restored")
    if axes == "pop2":
        # Its members are not in the store: a resize refuses, naming the key.
        from stoix_tpu_torch.population import elastic
        from stoix_tpu_torch.resilience import fleet
        from stoix_tpu_torch.resilience.elastic import ElasticResizeError

        path = one_and_two_ranks["root"] / "rescue_pop2" / "rescue"
        raw, _ = fleet._read_emergency(str(path))
        assert elastic.resize_arrays(raw, 4) is raw
        with pytest.raises(ElasticResizeError, match=r"arch\.mesh\.pop"):
            elastic.resize_arrays(raw, 2)


@pytest.mark.parametrize("store", ["from_one", "checkpoint_from_one"])
def test_a_one_process_population_store_restores_over_two_data_ranks(one_and_two_ranks, store):
    _, stored = one_and_two_ranks["one_store"]
    own = ("members/env_state", "members/timestep", "members/generator")
    for rank, rank_runs in enumerate(one_and_two_ranks["two"]):
        run = dict(rank_runs["rescue_data2"], saved0=stored)
        _assert_rank_bound(run, rank, own, store)
        if store == "checkpoint_from_one":  # the topology-elastic restore
            report = run["elastic_restore"]
            assert (report["saved_world"], report["world"], report["step"]) == (1, 2, 64)
            kept = {entry.split(" ")[0] for entry in report["reinitialized"]}
            assert kept == {k for k in stored if any(k == p or k.startswith(f"{p}/")
                                                     for p in own)}
