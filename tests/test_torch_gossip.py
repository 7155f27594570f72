"""Gossip-averaged learner groups of the PyTorch port (parallel/gossip.py,
the grouped ff_ppo learner and the runner's rounds) against the JAX package
on the CPU.

1. `mixing_matrix` for every topology at G = 2, 3, 5 (w = 0.4, 0.5, 1.0)
   against the JAX package's: bitwise; random_peer fed the shift JAX's
   in-graph draw made for the round. The port's own shift stream is
   deterministic per (seed, round), in [1, G), and varies with the round.
2. One mixing round of stacked params (`_mix_leaf`) against `jax.jit` of
   the JAX package's: bitwise (the port states XLA's order, one fused
   multiply-add a term, `mix_row`); integer leaves pass through.
3. The refusals of tests/test_gossip.py::test_settings_refusals and
   ::test_grouped_config_refusals, and the config trees of the gossip root
   and of `arch=gossip` against the JAX package's.
4. On gloo ranks (tests/torch_ring_worker.py; G = 2 x D = 1 on 2 ranks, with
   the optimizer states mixed, and G = 2 x D = 2 on 4): one grouped update
   on each rank's own trajectory and permutations, then its round, against
   the JAX composition of ff_ppo's update under `shard_map` over the
   ("group", "data") mesh of the first 2 or 4 virtual devices, followed by
   `jax.jit` of the JAX package's `build_gossip_plan(...).step` on the
   [G]-stacked states: losses 1e-5 relative with an absolute floor of 1e-6
   (a clip loss near zero is a float32 mean of terms a hundred times
   larger, as REINFORCE's in tests/test_torch_data_parallel.py), params and
   Adam moments 1e-5
   absolute, before and after the round; every gradient all-reduce on the
   rank's group's data subgroup only (none at D = 1 crosses a group).
5. The G = 1 run bitwise the plain Anakin run (tests/test_gossip.py::
   test_single_group_bit_identical_to_lockstep's pin), with no round and
   JAX's `LAST_RUN_STATS["gossip"]`; `None` on a lockstep run.
6. Two-group runs on 2 ranks: ring w = 0.5 mixes every window, the groups'
   params differ before each round and their mean is preserved by it
   (1e-6 relative, 1e-7 absolute: float32 mixing); all_pairs w = 1 reaches
   consensus (bitwise); `gossip_s` in the phases; other Anakin systems
   refuse `arch.mesh.group`, naming it.
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.ops import losses as jlosses
from stoix_tpu.ops.multistep import truncated_generalized_advantage_estimation as jax_gae
from stoix_tpu.parallel import create_mesh as jax_create_mesh
from stoix_tpu.parallel import gossip as jgossip
from stoix_tpu.parallel.mesh import shard_map
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch.parallel import gossip, mesh_shape
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo, ff_trans_ppo
from stoix_tpu_torch.utils import config as config_lib
from test_torch_config import _assert_mirrors
from test_torch_ff_ppo import _trajectory, make_config
from torch_parity import paired_networks, to_flax_params
from torch_ring_worker import spawn_ranks

GOSSIP_ROOT = "default/gossip/default_ff_ppo.yaml"
PLAIN_ROOT = "default/anakin/default_ff_ppo.yaml"
BASE_OVERRIDES = [  # tests/test_gossip.py's
    "env=identity_game", "arch.total_num_envs=16", "arch.num_updates=4",
    "arch.total_timesteps=~", "arch.num_evaluation=2", "arch.num_eval_episodes=8",
    "arch.absolute_metric=False", "system.rollout_length=4", "system.epochs=1",
    "system.num_minibatches=2", "logger.use_console=False",
]
T_LEN, ENVS, OBS_DIM, ACTIONS, HIDDEN = 8, 8, 6, 3, (32, 32)
PPO = ["system.epochs=1", "system.num_minibatches=2", "system.actor_lr=1.0e-3",
       "system.critic_lr=1.0e-3", "arch.num_updates_per_eval=1"]


def _settings(topology, w, seed=7):
    return jgossip.GossipSettings(True, 1, topology, w, False, seed)


# ---------------------------------------------------------------- the matrix and the mix


@pytest.mark.parametrize("topology", gossip.TOPOLOGIES)
@pytest.mark.parametrize("num_groups", [2, 3, 5])
def test_mixing_matrix_matches_jax(topology, num_groups):
    for w in (0.4, 0.5, 1.0):
        for round_idx in range(2):
            want = np.asarray(jgossip.mixing_matrix(_settings(topology, w), num_groups,
                                                    jnp.asarray(round_idx, jnp.int32)))
            shift = None
            if topology == "random_peer":
                # The shift JAX drew: where row 0 puts its edge weight.
                off = want[0].copy()
                off[0] = 0.0 if w < 1.0 else off[0]
                shift = int(np.argmax(off))
            got = gossip.mixing_matrix(gossip.GossipSettings(*_settings(topology, w)),
                                       num_groups, shift)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_allclose(got.sum(0).numpy(), 1.0, atol=1e-6)
            np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-6)


def test_random_peer_shift_stream_is_deterministic_and_varies():
    shifts = [gossip.random_peer_shift(7, r, 5) for r in range(16)]
    assert shifts == [gossip.random_peer_shift(7, r, 5) for r in range(16)]
    assert all(1 <= s < 5 for s in shifts) and len(set(shifts)) > 1
    assert gossip.random_peer_shift(0, 3, 2) == 1
    with pytest.raises(gossip.GossipError, match="shift"):
        gossip.mixing_matrix(gossip.GossipSettings(*_settings("random_peer", 0.5)), 3)


@pytest.mark.parametrize("topology", gossip.TOPOLOGIES)
@pytest.mark.parametrize("num_groups", [2, 3, 5])
def test_mix_leaf_is_bitwise_the_jitted_jax_mix(topology, num_groups):
    matrix = np.asarray(jgossip.mixing_matrix(_settings(topology, 0.3), num_groups,
                                              jnp.asarray(1, jnp.int32)))
    leaf = (np.random.default_rng(num_groups).normal(size=(num_groups, 3, 257)) * 3
            ).astype(np.float32)
    want = np.asarray(jax.jit(jgossip._mix_leaf)(jnp.asarray(matrix), jnp.asarray(leaf)))
    got = gossip._mix_leaf(torch.from_numpy(matrix), torch.from_numpy(leaf))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mix_leaf_passes_integers_through():
    matrix = torch.full((2, 2), 0.5)
    count = torch.tensor([[3], [3]], dtype=torch.int32)
    out = gossip._mix_leaf(matrix, count)
    assert out.dtype == torch.int32 and torch.equal(out, count)
    floats = torch.tensor([[2.0], [4.0]])
    assert torch.equal(gossip._mix_leaf(matrix, floats), torch.tensor([[3.0], [3.0]]))


# ---------------------------------------------------------------- refusals and configs


def _cfg_with_gossip(**gossip_over):
    cfg = config_lib.compose(config_lib.default_config_dir(), GOSSIP_ROOT, BASE_OVERRIDES)
    for k, v in gossip_over.items():
        config_lib._set_dotted(cfg, f"arch.gossip.{k}", v)
    return cfg


def test_settings_refusals():
    for over, match in ((dict(interval=0), "interval"), (dict(topology="star"), "topology"),
                        (dict(mixing_weight=0.0), "mixing_weight"),
                        (dict(mixing_weight=1.5), "mixing_weight")):
        with pytest.raises(gossip.GossipError, match=match):
            gossip.settings_from_config(_cfg_with_gossip(**over))


def test_grouped_config_refusals():
    cfg_plain = config_lib.compose(config_lib.default_config_dir(), PLAIN_ROOT, BASE_OVERRIDES)
    config_lib._set_dotted(cfg_plain, "arch.gossip", {"enabled": True})
    with pytest.raises(gossip.GossipError, match="'group' mesh axis"):
        gossip.build_gossip_plan(cfg_plain, {"data": 1})
    with pytest.raises(gossip.GossipError, match="'group' mesh axis"):
        gossip.validate_grouped_config(cfg_plain, {"data": 1})
    cfg_off = _cfg_with_gossip(enabled=False)
    with pytest.raises(gossip.GossipError, match="WITHOUT exchanging"):
        gossip.validate_grouped_config(cfg_off, {"group": 2, "data": 1})
    for key, match in (("arch.integrity.enabled", "integrity"), ("arch.fused_eval", "fused_eval")):
        cfg_bad = _cfg_with_gossip()
        config_lib._set_dotted(cfg_bad, key, True)
        with pytest.raises(gossip.GossipError, match=match):
            gossip.validate_grouped_config(cfg_bad, {"group": 1, "data": 1})
    # Through the system: fused_eval refused at setup, as JAX's learner_setup.
    cfg_fused = config_lib.compose(config_lib.default_config_dir(), GOSSIP_ROOT,
                                   BASE_OVERRIDES + ["arch.fused_eval=True"])
    with pytest.raises(gossip.GossipError, match="fused_eval"):
        ff_ppo.run_experiment(cfg_fused, device="cpu")


@pytest.mark.parametrize("root,overrides", [
    (GOSSIP_ROOT, []), (GOSSIP_ROOT, ["arch.mesh.group=2", "env=identity_game"]),
    (PLAIN_ROOT, ["arch=gossip"]),
])
def test_gossip_config_trees_mirror_the_jax_package(root, overrides):
    _assert_mirrors(root, overrides)


@pytest.mark.parametrize("override,key", [
    # host_stall, preflight, the fleet and the HTTP ops plane run (the
    # straggler drill below, the next test, tests/test_torch_fleet.py's
    # gossip drill); the compile cache stays refused.
    ("arch.compile_cache.enabled=true", "arch.compile_cache.enabled"),
])
def test_gossip_root_refuses_the_unported_layers(override, key):
    cfg = config_lib.compose(config_lib.default_config_dir(), GOSSIP_ROOT,
                             BASE_OVERRIDES + [override])
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        ff_ppo.run_experiment(cfg, device="cpu")


@pytest.mark.parametrize("override", [
    # Armed past the run's last window: accepted, and never fires.
    "arch.fault_spec=host_loss:99", "logger.telemetry.http.enabled=true"])
def test_gossip_root_runs_the_layers_across_hosts(override, tmp_path, monkeypatch):
    from stoix_tpu_torch import observability
    from stoix_tpu_torch.resilience import faultinject

    monkeypatch.chdir(tmp_path)
    cfg = config_lib.compose(config_lib.default_config_dir(), GOSSIP_ROOT,
                             BASE_OVERRIDES + ["arch.fleet.enabled=true", override])
    try:
        assert np.isfinite(ff_ppo.run_experiment(cfg, device="cpu"))
        assert runner.LAST_RUN_STATS["resilience"]["fleet"] is True
        assert (observability.get_ops_server() is not None) is ("http" in override)
    finally:
        observability.shutdown()
        faultinject.reset()


def test_mesh_shape_takes_the_group_axis_in_jax_order():
    # Rank r sits in group r // D (row-major over ("group", "data")).
    assert mesh_shape({"group": 2, "data": -1}, 4) == {"group": 2, "data": 2}
    assert list(mesh_shape({"group": -1, "data": 2}, 6)) == ["group", "data"]
    with pytest.raises(ValueError, match="not divisible"):
        mesh_shape({"group": 3, "data": -1}, 4)


def test_other_anakin_systems_refuse_the_group_axis():
    cfg = ff_trans_ppo_config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_trans_ppo.yaml",
        ["env=identity_game", "arch.total_num_envs=8", "arch=gossip"])
    assert ff_trans_ppo_config.arch.mesh.group == 1
    with pytest.raises(NotImplementedError, match=r"arch\.mesh\.group"):
        ff_trans_ppo.run_experiment(cfg, device="cpu")


# ---------------------------------------------------------------- one group in one process


def _record(root, extra=()):
    traj = []
    setup_fn = ff_ppo.learner_setup

    def setup(*args, **kwargs):
        out = setup_fn(*args, **kwargs)
        learn = out.learn

        def recorded(state):
            result = learn(state)
            traj.append({k: v.clone() for side in result.learner_state.params
                         for k, v in side.items()})
            return result

        return out._replace(learn=recorded)

    ff_ppo.learner_setup = setup
    try:
        cfg = config_lib.compose(config_lib.default_config_dir(), root,
                                 BASE_OVERRIDES + list(extra))
        final_return = ff_ppo.run_experiment(cfg, device="cpu")
    finally:
        ff_ppo.learner_setup = setup_fn
    return final_return, traj, dict(runner.LAST_RUN_STATS)


def test_single_group_bit_identical_to_lockstep():
    plain_return, plain, plain_stats = _record(PLAIN_ROOT)
    assert plain_stats["gossip"] is None
    grouped_return, grouped, stats = _record(GOSSIP_ROOT)
    assert stats["gossip"] == {"num_groups": 1, "interval": 1, "topology": "ring",
                               "mixing_weight": 0.5, "average_opt_states": False, "rounds": 0}
    assert "gossip_s" not in stats["phase_breakdown"]
    assert stats["mesh"] == {"group": 1, "data": 1}
    assert len(plain) == len(grouped) == 2 and grouped_return == plain_return
    for a, b in zip(plain, grouped):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------- groups on gloo ranks


def _update_inputs(world):
    nets = paired_networks(OBS_DIM, ACTIONS, HIDDEN, seed=4)
    per = [_trajectory(30 + r, T_LEN, ENVS, OBS_DIM, ACTIONS) for r in range(world)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *per)  # [N, T, E, ...]
    rng = np.random.default_rng(9)
    perms = np.stack([[[rng.permutation(T_LEN * ENVS)]]
                      for _ in range(world)])  # [N, epochs = 1, 1, T.E]
    return nets, per, stacked, perms


def _update_job(name, groups, data, extra=()):
    (_, _, _, _, ta, tc), per, _, perms = _update_inputs(groups * data)
    numpy = lambda module: {k: v.detach().numpy() for k, v in module.named_parameters()}  # noqa
    return (name, "gossip_update", dict(
        axes={"group": groups, "data": data},
        overrides=PPO + [f"arch.mesh.group={groups}", *extra], obs_dim=OBS_DIM,
        num_actions=ACTIONS, hidden=HIDDEN, actor_params=numpy(ta), critic_params=numpy(tc),
        trajs=per, perms=perms))


def _run_job(name, root_dir, extra):
    return (name, "gossip_run", dict(root=GOSSIP_ROOT, overrides=[
        *BASE_OVERRIDES, "arch.mesh.group=2", *extra], cwd=str(root_dir / name)))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("gossip_2")
    jobs = [_update_job("g2d1", 2, 1, ["arch.gossip.average_opt_states=true"]),
            _run_job("ring", root, []),
            _run_job("all_pairs", root, ["arch.gossip.topology=all_pairs",
                                         "arch.gossip.mixing_weight=1.0"]),
            _run_job("host_stall", root, ["arch.fault_spec=host_stall:1"])]
    return spawn_ranks(jobs, 2, root)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return spawn_ranks([_update_job("g2d2", 2, 2)], 4, tmp_path_factory.mktemp("gossip_4"))


class _State(NamedTuple):
    """What the JAX gossip step reads and replaces of a learner state."""

    params: Any
    opt_states: Any


def _adam(state):
    """The ScaleByAdamState inside an optax chain's state."""
    if hasattr(state, "mu"):
        return state
    for child in state if isinstance(state, tuple) else ():
        found = _adam(child)
        if found is not None:
            return found
    return None


def _jax_grouped_update(nets, stacked, perms, groups, data, average_opt_states):
    """ff_ppo's update under shard_map over ("group", "data") (its pmean
    over "data" stays within the group), then the JAX package's gossip step
    on the [G]-stacked params and optimizer states."""
    ja, jap, jc, jcp, _, _ = nets
    s = make_config(PPO).system
    mesh = jax_create_mesh({"group": groups, "data": data},
                           devices=jax.devices()[:groups * data])
    make_optim = lambda: optax.chain(optax.clip_by_global_norm(float(s.max_grad_norm)),  # noqa
                                     optax.adam(float(s.actor_lr), eps=1e-5))
    actor_optim, critic_optim = make_optim(), make_optim()
    as_obs = lambda o: JaxObservation(*(o[k] for k in JaxObservation._fields))  # noqa: E731

    def actor_loss(params, obs, action, old_log_prob, gae):
        dist = ja.apply(params, obs)
        loss_actor = jlosses.ppo_clip_loss(dist.log_prob(action), old_log_prob, gae, s.clip_eps)
        return loss_actor - s.ent_coef * dist.entropy().mean(), loss_actor

    def critic_loss(params, obs, targets, old_value):
        value_loss = jlosses.clipped_value_loss(jc.apply(params, obs), old_value, targets,
                                                s.clip_eps)
        return s.vf_coef * value_loss, value_loss

    def shard(traj, perm):
        traj = jax.tree.map(lambda x: x[0], traj)
        perm = perm[0][:, 0]  # [epochs, T.E]
        obs, next_obs = as_obs(traj["obs"]), as_obs(traj["next_obs"])
        advantages, targets = jax_gae(
            traj["reward"], s.gamma * (1.0 - traj["done"].astype(jnp.float32)), s.gae_lambda,
            v_tm1=traj["value"], v_t=jc.apply(jcp, next_obs),
            truncation_t=traj["truncated"].astype(jnp.float32), standardize_advantages=True,
            impl="scan")
        flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]),
                            (obs, traj["action"], traj["log_prob"], traj["value"], advantages,
                             targets))
        ap, cp = jap, jcp
        a_state, c_state = actor_optim.init(ap), critic_optim.init(cp)
        actor_losses, value_losses = [], []
        for epoch in range(int(s.epochs)):
            mbs = jax.tree.map(lambda x: jnp.take(x, perm[epoch], axis=0).reshape(
                (int(s.num_minibatches), -1) + x.shape[1:]), flat)
            for i in range(int(s.num_minibatches)):
                mb_obs, mb_act, mb_lp, mb_val, mb_adv, mb_tgt = jax.tree.map(lambda x: x[i], mbs)
                a_grads, a_loss = jax.grad(actor_loss, has_aux=True)(ap, mb_obs, mb_act, mb_lp,
                                                                     mb_adv)
                c_grads, v_loss = jax.grad(critic_loss, has_aux=True)(cp, mb_obs, mb_tgt, mb_val)
                a_grads = jax.lax.pmean(a_grads, axis_name="data")
                c_grads = jax.lax.pmean(c_grads, axis_name="data")
                actor_losses.append(a_loss)
                value_losses.append(v_loss)
                updates, a_state = actor_optim.update(a_grads, a_state)
                ap = optax.apply_updates(ap, updates)
                updates, c_state = critic_optim.update(c_grads, c_state)
                cp = optax.apply_updates(cp, updates)
        out = ((ap, cp), (a_state, c_state), jnp.stack(actor_losses), jnp.stack(value_losses))
        return jax.tree.map(lambda x: x[None], out)

    spec = P(("group", "data"))
    params, opts, actor_losses, value_losses = jax.jit(shard_map(
        shard, mesh=mesh, in_specs=(spec, spec), out_specs=spec, check_vma=False))(
        stacked, perms)
    # One group's copy (the data ranks of a group hold the same state), a
    # fresh array: the JAX step donates its input.
    per_group = lambda tree: jax.tree.map(lambda x: jnp.array(x[::data], copy=True),  # noqa
                                          tree)

    cfg = jax_config.compose(jax_config.default_config_dir(), GOSSIP_ROOT,
                             PPO + [f"arch.mesh.group={groups}",
                                    f"arch.gossip.average_opt_states={average_opt_states}"])
    plan = jgossip.build_gossip_plan(cfg, mesh)
    mixed = plan.step(_State(per_group(params), per_group(opts)), jnp.asarray(0, jnp.int32))
    return {"params": params, "opts": opts, "actor_losses": actor_losses,
            "value_losses": value_losses, "mixed_params": mixed.params,
            "mixed_opts": mixed.opt_states}


def _check_update(results, name, groups, data, average_opt_states):
    nets, _, stacked, perms = _update_inputs(groups * data)
    want = _jax_grouped_update(nets, stacked, perms, groups, data, average_opt_states)
    template = nets[1], nets[3]
    for rank, result in enumerate(results):
        got = result[name]
        g = rank // data
        assert got["group"] == (g, groups)
        assert got["data_group_ranks"] == tuple(range(g * data, (g + 1) * data))
        # Every all-reduce of the update runs over this rank's data subgroup,
        # one a minibatch (epochs x minibatches): none crosses a group.
        assert got["reduce_ranks"] == [got["data_group_ranks"]] * 2
        for key, ref in (("actor_loss", want["actor_losses"]),
                         ("value_loss", want["value_losses"])):
            np.testing.assert_allclose(got["losses"][key].reshape(-1), np.asarray(ref)[rank],
                                       rtol=1e-5, atol=1e-6, err_msg=key)

        def close(port_side, jax_tree, index, side):
            port_tree = to_flax_params({k: torch.from_numpy(v) for k, v in port_side.items()},
                                       template[side])
            jax.tree.map(lambda a, b: np.testing.assert_allclose(
                a, np.asarray(b)[index], rtol=0, atol=1e-5), port_tree, jax_tree)

        for side in (0, 1):
            close(got["params"][side], want["params"][side], rank, side)
            close(got["mixed_params"][side], want["mixed_params"][side], g, side)
            for moment in ("mu", "nu"):
                port_opt = got["opt"][side]
                close(getattr(port_opt, moment), getattr(_adam(want["opts"][side]), moment),
                      rank, side)
                mixed = got["mixed_opt"][side]
                jax_mixed = _adam(want["mixed_opts"][side])
                close(getattr(mixed, moment), getattr(jax_mixed, moment), g, side)
            assert got["mixed_opt"][side].count == got["opt"][side].count == 2
        if not average_opt_states:
            for side in (0, 1):
                for moment in ("mu", "nu"):
                    assert all(np.array_equal(a, b) for a, b in zip(
                        getattr(got["mixed_opt"][side], moment).values(),
                        getattr(got["opt"][side], moment).values()))


def test_two_groups_of_one_rank_match_jax(two_ranks):
    _check_update(two_ranks, "g2d1", 2, 1, True)


def test_two_groups_of_two_ranks_match_jax(four_ranks):
    _check_update(four_ranks, "g2d2", 2, 2, False)


def _leaves(params):
    return [v for side in params for v in side.values()]


def test_two_group_run_mixes_and_preserves_group_mean(two_ranks):
    runs = [r["ring"] for r in two_ranks]
    for run in runs:
        assert run["stats_gossip"] == {"num_groups": 2, "interval": 1, "topology": "ring",
                                       "mixing_weight": 0.5, "average_opt_states": False,
                                       "rounds": 2}
        assert "gossip_s" in run["phases"] and run["mesh"] == {"group": 2, "data": 1}
        assert run["rounds_counted"] == 2  # stoix_tpu_gossip_rounds_total
        assert len(run["learn"]) == len(run["gossip"]) == 2
        # Each rank is a group of one: its data collectives reduce over itself.
        assert all(len(ranks) == 1 for ranks in run["reduce_ranks"])
    # Every rank reads the same metrics (its wall clock aside).
    assert [[{k: v for k, v in record.items() if k != "steps_per_second"}
             for record in run["history"]] for run in runs] == [[
        {k: v for k, v in record.items() if k != "steps_per_second"}
        for record in runs[0]["history"]]] * 2
    for window in range(2):
        pre = [_leaves(run["learn"][window]) for run in runs]
        post = [_leaves(run["gossip"][window]) for run in runs]
        assert any(not np.array_equal(a, b) for a, b in zip(*pre)), "groups identical"
        for a0, a1, b0, b1 in zip(*pre, *post):
            np.testing.assert_allclose((b0 + b1) / 2, (a0 + a1) / 2, rtol=1e-6, atol=1e-7)


def test_two_group_run_survives_host_stall(two_ranks):
    """The straggler drill (the JAX package's
    tests/test_gossip.py::test_two_group_run_survives_host_stall): two groups
    under `host_stall:1` complete (the stall is a delay, never a deadlock),
    dispatch every round, and the fault counter rises by one on each rank."""
    for run in (r["host_stall"] for r in two_ranks):
        assert len(run["learn"]) == 2 and len(run["gossip"]) == 2
        assert run["stats_gossip"]["rounds"] == 2 and run["rounds_counted"] == 2
        assert run["faults_injected"] == 1 and run["preempted"] is False
        assert run["stall_s"] >= 1.0  # the goodput ledger charged the sleep


def test_all_pairs_full_weight_reaches_consensus(two_ranks):
    runs = [r["all_pairs"] for r in two_ranks]
    assert all(run["stats_gossip"]["rounds"] == 2 for run in runs)
    for window in range(2):
        for a, b in zip(*(_leaves(run["gossip"][window]) for run in runs)):
            np.testing.assert_array_equal(a, b)


def test_lockstep_run_reports_no_gossip():
    _record(PLAIN_ROOT)
    assert runner.LAST_RUN_STATS["gossip"] is None
    assert "gossip_s" not in runner.LAST_RUN_STATS["phase_breakdown"]
