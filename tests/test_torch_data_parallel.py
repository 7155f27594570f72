"""Data-parallel Anakin training of the PyTorch port (one process a shard,
`torch.distributed` over gloo on the CPU) against the JAX package's
`shard_map` over the mesh's "data" axis on the first N of the 8 virtual
devices (tests/conftest.py).

Ranks are spawned once per group size (tests/torch_ring_worker.py, jobs in
tests/torch_dp_worker.py): one group of 2 runs every 2-rank job, one of 4
the 4-rank update step.

1. One ff_ppo update step (GAE, then epochs x minibatches of clip + Adam) on
   N = 2 and N = 4 ranks, and at U = 2 x N = 2, each rank on its own
   trajectory with its own permutations, against the JAX composition of
   ff_ppo.py's order with `pmean` over "batch" then "data"
   (stoix_tpu/systems/ppo/anakin/ff_ppo.py:239-264):
   - the data-mean gradients of every minibatch against JAX's pmean of the
     same local gradients: bitwise at N = 2 (a two-term sum commutes, and
     halving is exact), within 1e-6 of the largest local gradient at N = 4
     (gloo's summation order is not XLA's);
   - one gradient all-reduce a minibatch, and the same params on every rank;
   - the params after the step against the JAX composition: 1e-5 absolute, as
     the one-process step (tests/test_torch_ff_ppo.py).
2. The observation statistics folded over 2 ranks and U = 2 replicas against
   stoix_tpu/ops/running_statistics.py::update with axis_names=("batch",
   "data"): the count exact, the rest 1e-6 relative to each statistic's
   largest entry (tests/test_torch_running_statistics.py's bar).
3. One ff_dqn update (twice) on 2 ranks against JAX's `pmean_grads`
   composition: the loss 1e-5 relative, online and target params 1e-5
   absolute; and the buffer sized over N x U as
   stoix_tpu/systems/off_policy_core.py:67-71 sizes it.
4. C14: 2 ranks under the default `arch.mesh.data=-1` form one 2-shard run
   (`total_num_envs / 2` envs a rank, identical params on both after the
   run); only rank 0 logs and writes the store's metrics; a 2-rank resume
   after window 1 is bitwise the unbroken 2-rank run, every rank's state;
   restoring a 2-rank store in one process raises, naming both counts.
5. The learning oracle: ff_ppo on IdentityGame over 2 ranks at the JAX
   test's config (tests/test_ff_ppo.py: 64 envs) returns above 8.0.
7. One ff_rainbow and one rec_r2d2 update epoch (twice) on 2 ranks, each on
   its own PrioritisedSample (the same noise draws on both, as JAX's one
   trace feeds every shard), against their compositions under `shard_map`
   over "data" with `pmean_grads`: losses and new priorities 1e-5 relative,
   online and target params 1e-5 absolute, the importance weights
   normalised by each shard's own batch maximum; and each rank's
   prioritised buffer sized over N x U as `trajectory_buffer_sizing` sizes
   it.
6. parallel/mesh.py's `shard_leading_axis`, `fetch_global` and `replicate`
   on 2 ranks: a rank's slice, the slices gathered back, rank 0's copy
   (exact).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stoix_tpu import envs as jax_envs
from stoix_tpu.base_types import OnlineAndTarget as JaxOnlineAndTarget
from stoix_tpu.base_types import Transition as JaxTransition
from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.ops import losses as jlosses
from stoix_tpu.ops import running_statistics as jrs
from stoix_tpu.ops.multistep import truncated_generalized_advantage_estimation as jax_gae
from stoix_tpu.parallel import create_mesh as jax_create_mesh
from stoix_tpu.parallel.mesh import shard_map
from stoix_tpu.systems import off_policy_core as jcore
from stoix_tpu.systems.q_learning import ff_dqn as jax_dqn
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch.utils import checkpointing
from test_torch_ff_ppo import IDENTITY_OVERRIDES, _trajectory, make_config
from test_torch_q_ops import paired_q_networks
import test_torch_r2d2
import test_torch_rainbow
from torch_parity import paired_networks, to_flax_params
from torch_ring_worker import spawn_ranks

T_LEN, ENVS, OBS_DIM, ACTIONS, HIDDEN = 8, 8, 6, 3, (32, 32)  # ENVS: a replica's, on a rank
PPO = ["system.epochs=2", "system.num_minibatches=2", "system.actor_lr=1.0e-3",
       "system.critic_lr=1.0e-3", "arch.num_updates_per_eval=1"]
Q_OBS, Q_BATCH = 5, 32
MESH_ARRAY = np.arange(24, dtype=np.float32).reshape(6, 4)
DQN = ["env=identity_game", "arch.total_num_envs=16", "system.total_buffer_size=4096",
       "system.total_batch_size=64"]
WINDOW = 2 * 4 * 8  # global steps a window: 2 updates of 4 steps x 8 envs
TINY = ["env=identity_game", "arch.total_num_envs=8", "arch.num_updates_per_eval=2",
        "arch.num_eval_episodes=4", "arch.absolute_metric=False", "system.rollout_length=4",
        "system.epochs=2", "system.num_minibatches=2", "logger.use_console=False",
        "system.normalize_observations=true", "arch.update_batch_size=2",
        "system.update_guard=skip", "system.fused_update=true",
        "logger.checkpointing.save_model=true",
        "logger.checkpointing.save_args.max_to_keep=~"]


def _windows(windows, uid, extra=()):
    return TINY + [f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * WINDOW}",
                   f"logger.checkpointing.save_args.checkpoint_uid={uid}", *extra]


# ---------------------------------------------------------------- inputs


def _ppo_inputs(world, update_batch):
    """The flax and port networks, each rank's [T, U.E] trajectory (port
    layout) and [U, T, E] one (JAX layout), and each rank's permutations
    [epochs, U, T.E]."""
    nets = paired_networks(OBS_DIM, ACTIONS, HIDDEN, seed=4)
    per = [[_trajectory(10 * r + u, T_LEN, ENVS, OBS_DIM, ACTIONS) for u in range(update_batch)]
           for r in range(world)]
    port = [jax.tree.map(lambda *xs: np.concatenate(xs, axis=1), *row) for row in per]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *[
        jax.tree.map(lambda *ys: np.stack(ys), *row) for row in per])  # [N, U, T, E, ...]
    rng = np.random.default_rng(7)
    perms = np.stack([[[rng.permutation(T_LEN * ENVS) for _ in range(update_batch)]
                       for _ in range(2)] for _ in range(world)])  # [N, epochs, U, T.E]
    return nets, port, stacked, perms


def _ppo_job(world, update_batch):
    (_, _, _, _, ta, tc), port, _, perms = _ppo_inputs(world, update_batch)
    numpy = lambda module: {k: v.detach().numpy() for k, v in module.named_parameters()}  # noqa
    return (f"ppo_u{update_batch}", "ppo_step", dict(
        overrides=PPO + [f"arch.update_batch_size={update_batch}"], obs_dim=OBS_DIM,
        num_actions=ACTIONS, hidden=HIDDEN, actor_params=numpy(ta), critic_params=numpy(tc),
        trajs=port, perms=perms))


def _stats_batches(world):
    rng = np.random.default_rng(3)
    return [[(rng.normal(size=(4, 2, 3, 5)) * 2.0 + 0.5).astype(np.float32) for _ in range(2)]
            for _ in range(world)]  # rank, fold: [T, U, E, F]


def _q_batch(seed):
    rng = np.random.default_rng(seed)

    def obs():
        return {"agent_view": rng.normal(size=(Q_BATCH, Q_OBS)).astype(np.float32),
                "action_mask": np.ones((Q_BATCH, ACTIONS), np.float32),
                "step_count": np.zeros((Q_BATCH,), np.int32)}

    return {"obs": obs(), "next_obs": obs(),
            "action": rng.integers(0, ACTIONS, Q_BATCH).astype(np.int32),
            "reward": (rng.normal(size=Q_BATCH) * 3).astype(np.float32),
            "done": rng.random(Q_BATCH) < 0.2,
            "info": {"episode_return": np.zeros(Q_BATCH, np.float32),
                     "episode_length": np.zeros(Q_BATCH, np.int32),
                     "is_terminal_step": np.zeros(Q_BATCH, bool)}}


def _q_networks():
    jax_net, online, torch_net = paired_q_networks("dqn", seed=1)
    dummy = JaxObservation(jnp.zeros((1, Q_OBS)), jnp.ones((1, ACTIONS)),
                           jnp.zeros((1,), jnp.int32))
    target = jax.tree.map(np.asarray, jax_net.init(jax.random.PRNGKey(2), dummy))
    port_online = {k: v.detach().numpy().copy() for k, v in torch_net.named_parameters()}
    from stoix_tpu_torch.utils.params import load_flax_params

    load_flax_params(torch_net, target)
    port_target = {k: v.detach().numpy().copy() for k, v in torch_net.named_parameters()}
    return jax_net, online, target, port_online, port_target


RAINBOW = ["env=identity_game", "system.q_lr=1e-3"]
R2D2 = ["env=identity_game", *test_torch_r2d2.SEQ]
BUFFERS = ["arch.total_num_envs=16", "system.total_buffer_size=4096",
           "system.total_batch_size=64"]


def _sequence_inputs(system):
    """(flax net, online, target, the port's numpy online and target, the
    [epoch][rank] samples, the [epoch] noise draws (numpy, JAX's order) and
    the same as port pairs) of a 2-rank update of `system`."""
    if system == "ff_rainbow":
        jax_net, online, target, torch_net, port_online, port_target = (
            test_torch_rainbow.paired_rainbow_networks())
        samples = [[test_torch_rainbow._sample(100 + 10 * epoch + rank) for rank in range(2)]
                   for epoch in range(2)]
        draws, pairs = [], []
        for epoch in range(2):
            epoch_draws, epoch_pairs = [], []
            for k in range(3):
                d, p = test_torch_rainbow.noise_draws(torch_net, seed=200 + 10 * epoch + k)
                epoch_draws += d
                epoch_pairs.append([(a.numpy(), b.numpy()) for a, b in p])
            draws.append(epoch_draws)
            pairs.append(epoch_pairs)
    else:
        jax_net, online, target, torch_net, port_online, port_target = (
            test_torch_r2d2.paired_networks("gru"))
        samples = [[test_torch_r2d2._sample(100 + 10 * epoch + rank, "gru") for rank in range(2)]
                   for epoch in range(2)]
        draws, pairs = [[] for _ in range(2)], None
    numpy = lambda p: {k: v.numpy() for k, v in p.items()}  # noqa: E731
    return jax_net, online, target, numpy(port_online), numpy(port_target), samples, draws, pairs


def _sequence_job(system):
    _, _, _, online, target, samples, _, pairs = _sequence_inputs(system)
    kwargs = dict(system=system, overrides=RAINBOW if system == "ff_rainbow" else R2D2,
                  online=online, target=target, samples=samples)
    if pairs is not None:
        kwargs["noise"] = pairs
    return system, "sequence_step", kwargs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp2")
    _, _, _, port_online, port_target = _q_networks()
    run_dir = str(root / "runs")
    jobs = [
        ("mesh_helpers", "mesh_helpers", {"x": MESH_ARRAY}),
        _ppo_job(2, 1),
        _ppo_job(2, 2),
        ("statistics", "statistics", {"batches": _stats_batches(2)}),
        ("dqn", "dqn_step", dict(overrides=DQN, obs_dim=Q_OBS, num_actions=ACTIONS,
                                 online=port_online, target=port_target,
                                 batches=[_q_batch(5), _q_batch(6)])),
        ("unbroken", "run", dict(system="ff_ppo", cwd=run_dir, overrides=_windows(
            2, "unbroken", ["logger.use_console=True", "logger.use_json=True",
                            f"logger.base_exp_path={root / 'results'}"]))),
        ("first", "run", dict(system="ff_ppo", cwd=run_dir, overrides=_windows(1, "first"))),
        ("resumed", "run", dict(system="ff_ppo", cwd=run_dir, overrides=_windows(1, "resumed", [
            "logger.checkpointing.load_model=true",
            "logger.checkpointing.load_args.checkpoint_uid=first"]))),
        *((f"{uid}_state", "saved_state", dict(
            store=os.path.join(run_dir, "checkpoints", uid, "ff_ppo"), step=2 * WINDOW))
          for uid in ("unbroken", "resumed")),
        ("oracle", "run", dict(system="ff_ppo", cwd=run_dir, overrides=IDENTITY_OVERRIDES)),
        _sequence_job("ff_rainbow"),
        _sequence_job("rec_r2d2"),
        *((f"{system}_buffer", "sequence_buffer", dict(
            system=system, overrides=["env=identity_game", *BUFFERS]))
          for system in ("ff_rainbow", "rec_r2d2")),
    ]
    return root, spawn_ranks(jobs, 2, root)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp4")
    return spawn_ranks([_ppo_job(4, 1)], 4, root)


# ---------------------------------------------------------------- JAX side


def _jax_ppo_update(nets, stacked, perms, world, update_batch):
    """ff_ppo.py's update step under shard_map over "data" and vmap over
    "batch": each replica's params after the step and its data-mean
    gradients of every minibatch, leaves [N, U, ...]."""
    ja, jap, jc, jcp, _, _ = nets
    s = make_config(PPO).system
    mesh = jax_create_mesh({"data": world}, devices=jax.devices()[:world])
    make_optim = lambda: optax.chain(optax.clip_by_global_norm(float(s.max_grad_norm)),  # noqa
                                     optax.adam(float(s.actor_lr), eps=1e-5))
    actor_optim, critic_optim = make_optim(), make_optim()
    as_obs = lambda o: JaxObservation(*(o[k] for k in JaxObservation._fields))  # noqa: E731

    def actor_loss(params, obs, action, old_log_prob, gae):
        dist = ja.apply(params, obs)
        loss_actor = jlosses.ppo_clip_loss(dist.log_prob(action), old_log_prob, gae, s.clip_eps)
        return loss_actor - s.ent_coef * dist.entropy().mean()

    def critic_loss(params, obs, targets, old_value):
        return s.vf_coef * jlosses.clipped_value_loss(jc.apply(params, obs), old_value, targets,
                                                      s.clip_eps)

    def data_mean(grads):
        return jax.lax.pmean(jax.lax.pmean(grads, axis_name="batch"), axis_name="data")

    def replica(traj, perm):  # one replica's [T, E] trajectory, perm [epochs, T.E]
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
        means = []
        for epoch in range(int(s.epochs)):
            mbs = jax.tree.map(lambda x: jnp.take(x, perm[epoch], axis=0).reshape(
                (int(s.num_minibatches), -1) + x.shape[1:]), flat)
            for i in range(int(s.num_minibatches)):
                mb_obs, mb_act, mb_lp, mb_val, mb_adv, mb_tgt = jax.tree.map(lambda x: x[i], mbs)
                a_grads = data_mean(jax.grad(actor_loss)(ap, mb_obs, mb_act, mb_lp, mb_adv))
                c_grads = data_mean(jax.grad(critic_loss)(cp, mb_obs, mb_tgt, mb_val))
                means.append((a_grads, c_grads))
                updates, a_state = actor_optim.update(a_grads, a_state)
                ap = optax.apply_updates(ap, updates)
                updates, c_state = critic_optim.update(c_grads, c_state)
                cp = optax.apply_updates(cp, updates)
        return (ap, cp), means

    def shard(traj, perm):
        out = jax.vmap(replica, axis_name="batch")(
            jax.tree.map(lambda x: x[0], traj), jnp.swapaxes(perm[0], 0, 1))
        return jax.tree.map(lambda x: x[None], out)

    return jax.jit(shard_map(shard, mesh=mesh, in_specs=(P("data"), P("data")),
                             out_specs=P("data"), check_vma=False))(stacked, perms)


def _jax_data_mean(local, world, update_batch):
    """JAX's pmean over "batch" then "data" of the ranks' local gradients
    (leaves [N, U, ...]), leaves [N, U, ...]."""
    mesh = jax_create_mesh({"data": world}, devices=jax.devices()[:world])

    def shard(g):
        mean = jax.vmap(lambda x: jax.lax.pmean(jax.lax.pmean(x, "batch"), "data"),
                        axis_name="batch")
        return jax.tree.map(lambda x: x[None], mean(jax.tree.map(lambda x: x[0], g)))

    return jax.jit(shard_map(shard, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                             check_vma=False))(local)


def _check_ppo_step(results, world, update_batch):
    nets, _, stacked, perms = _ppo_inputs(world, update_batch)
    (want_ap, want_cp), _ = _jax_ppo_update(nets, stacked, perms, world, update_batch)
    job = f"ppo_u{update_batch}"
    steps = len(results[0][job]["means"])
    assert steps == 2 * 2  # epochs x minibatches
    for i in range(steps):
        # Each rank's replicas' local gradients of minibatch i, [N, U] leaves.
        local = jax.tree.map(lambda *xs: np.stack(xs), *[
            jax.tree.map(lambda *ys: np.stack(ys), *(
                r[job]["local"][i * update_batch + u] for u in range(update_batch)))
            for r in results])
        want = _jax_data_mean(local, world, update_batch)
        for rank, result in enumerate(results):
            got = result[job]["means"][i]
            for side in range(2):
                for name, value in got[side].items():
                    expect = np.asarray(want[side][name][rank, 0])
                    if world == 2:
                        np.testing.assert_array_equal(value, expect, err_msg=name)
                    else:
                        scale = float(np.abs(local[side][name]).max())
                        np.testing.assert_allclose(value, expect, rtol=0, atol=1e-6 * scale,
                                                   err_msg=name)
    for rank, result in enumerate(results):
        # One gradient all-reduce a minibatch; the same params on every rank.
        assert result[job]["allreduces"] == steps
        for side, want in ((0, want_ap), (1, want_cp)):
            got = {}
            for name, value in result[job]["params"][side].items():
                np.testing.assert_array_equal(value, results[0][job]["params"][side][name])
                if update_batch > 1:  # the [U] replicas are identical
                    assert all(np.array_equal(value[0], value[u]) for u in range(update_batch))
                    value = value[0]
                got[name] = torch.from_numpy(value)
            got_tree = to_flax_params(got, jax.tree.map(lambda x: x[0, 0], want))
            jax.tree.map(lambda g, w: np.testing.assert_allclose(
                g, np.asarray(w)[rank, 0], rtol=0, atol=1e-5), got_tree, want)


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("update_batch", [1, 2])
def test_ppo_step_on_two_ranks_matches_shard_map(two_ranks, update_batch):
    _check_ppo_step(two_ranks[1], 2, update_batch)


def test_ppo_step_on_four_ranks_matches_shard_map(four_ranks):
    _check_ppo_step(four_ranks, 4, 1)


def test_statistics_over_ranks_match_the_psum_over_batch_and_data(two_ranks):
    batches = _stats_batches(2)
    mesh = jax_create_mesh({"data": 2}, devices=jax.devices()[:2])

    def shard(folds):
        def replica(fold_batches):  # [folds, T, E, F]
            state = jrs.init_state(jnp.zeros((5,), jnp.float32))
            for b in range(fold_batches.shape[0]):
                state = jrs.update(state, fold_batches[b], axis_names=("batch", "data"),
                                   std_min_value=5e-4, std_max_value=5e4)
            return state

        # [1, folds, T, U, E, F] -> the replicas' [U, folds, T, E, F]
        per_replica = jnp.moveaxis(folds[0], 2, 0)
        return jax.tree.map(lambda x: x[None], jax.vmap(replica, axis_name="batch")(
            per_replica))

    want = jax.jit(shard_map(shard, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                             check_vma=False))(np.asarray(batches))
    for rank, result in enumerate(two_ranks[1]):
        got = result["statistics"]
        assert float(got["count"]) == 2 * 2 * (4 * 2 * 3)  # folds x ranks x [T, U, E]
        np.testing.assert_array_equal(got["count"], np.asarray(want.count)[rank, 0])
        for name in ("mean", "summed_variance", "std"):
            expect = np.asarray(getattr(want, name))[rank, 0]
            np.testing.assert_allclose(got[name], expect, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(expect).max()), err_msg=name)


def test_dqn_step_on_two_ranks_matches_pmean_grads(two_ranks):
    jcfg = jax_config.compose(jax_config.default_config_dir(),
                              "default/anakin/default_ff_dqn.yaml", DQN)
    jax_net, online, target, _, _ = _q_networks()
    optim = optax.chain(optax.clip_by_global_norm(float(jcfg.system.max_grad_norm)),
                        optax.adam(float(jcfg.system.q_lr), eps=1e-5))
    tau = float(jcfg.system.tau)
    mesh = jax_create_mesh({"data": 2}, devices=jax.devices()[:2])

    def as_batch(b):
        obs = lambda o: JaxObservation(*(o[k] for k in JaxObservation._fields))  # noqa: E731
        return JaxTransition(obs(b["obs"]), b["action"], b["reward"], b["done"],
                             obs(b["next_obs"]), b["info"])

    def update(params, opt_state, batch):
        def loss(o):
            return jax_dqn.dqn_loss(o, params.target, batch, jax_net.apply, jcfg)

        (value, _), grads = jax.value_and_grad(loss, has_aux=True)(params.online)
        grads = jcore.pmean_grads(grads)
        updates, opt_state = optim.update(grads, opt_state)
        new_online = optax.apply_updates(params.online, updates)
        return JaxOnlineAndTarget(new_online, optax.incremental_update(new_online, params.target,
                                                                       tau)), opt_state, value

    def shard(batch):
        def replica(b):
            params, opt_state, losses = JaxOnlineAndTarget(online, target), optim.init(online), []
            for _ in range(2):
                params, opt_state, value = update(params, opt_state, as_batch(b))
                losses.append(value)
            return params, jnp.stack(losses)

        out = jax.vmap(replica, axis_name="batch")(jax.tree.map(lambda x: x[0][None], batch))
        return jax.tree.map(lambda x: x[None], out)

    stacked = jax.tree.map(lambda *xs: np.stack(xs), _q_batch(5), _q_batch(6))
    want_params, want_losses = jax.jit(shard_map(shard, mesh=mesh, in_specs=P("data"),
                                                 out_specs=P("data"), check_vma=False))(stacked)
    # The buffers as the JAX package sizes them over the 2 data shards.
    jenv, _ = jax_envs.make(jcfg)
    jbuffer, jstate = jcore.build_buffer(jenv, jcfg, mesh, discrete_actions=True)
    jsample = jbuffer.sample(jstate, jax.random.PRNGKey(0)).experience
    for rank, result in enumerate(two_ranks[1]):
        got = result["dqn"]
        np.testing.assert_allclose(got["losses"], np.asarray(want_losses)[rank, 0], rtol=1e-5)
        for side, name in ((0, "online"), (1, "target")):
            got_tree = to_flax_params({k: torch.from_numpy(v) for k, v in got[name].items()},
                                      online)
            want_tree = jax.tree.map(lambda x: np.asarray(x)[rank, 0], want_params[side])
            jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=0, atol=1e-5),
                         got_tree, want_tree)
        assert got["buffer_length"] == jstate.experience.reward.shape[0] == 4096 // 2
        assert got["sample_size"] == jsample.reward.shape[0] == 64 // 2


def test_two_ranks_under_the_default_mesh_form_one_run(two_ranks):
    root, results = two_ranks
    for rank, result in enumerate(results):
        run = result["unbroken"]
        assert run["mesh"] == {"data": 2}
        assert run["num_envs_per_rank"] == 8 // 2
        # Every rank keeps the same global metrics (its wall clock aside).
        assert [{k: v for k, v in record.items() if k != "steps_per_second"}
                for record in run["history"]] == [
            {k: v for k, v in record.items() if k != "steps_per_second"}
            for record in results[0]["unbroken"]["history"]]
        state = result["unbroken_state"]
        for key, value in state.items():
            if key.startswith(("params/", "opt_states/", "obs_stats/")):
                np.testing.assert_array_equal(value, results[0]["unbroken_state"][key],
                                              err_msg=key)
    # Each rank's own leaves differ (its envs and generators).
    assert not np.array_equal(results[0]["unbroken_state"]["generator/0"],
                              results[1]["unbroken_state"]["generator/0"])
    # Only rank 0 prints, writes the JSON log and the store's metrics.
    logs = [(root / f"rank{r}.log").read_text() for r in range(2)]
    assert "[EVALUATOR" in logs[0] and "[EVALUATOR" not in logs[1]
    json_logs = [os.path.join(d, f) for d, _, files in os.walk(root / "results") for f in files]
    assert [os.path.basename(p) for p in json_logs] == ["metrics.json"]
    store = root / "runs" / "checkpoints" / "unbroken" / "ff_ppo"
    assert sorted(os.listdir(store)) == sorted([str(WINDOW), str(2 * WINDOW), "metadata.json"])
    assert sorted(os.listdir(store / str(2 * WINDOW))) == [
        "metrics.json", "state.0-of-2.pt", "state.1-of-2.pt"]


def test_two_rank_resume_is_bitwise_the_unbroken_run(two_ranks):
    root, results = two_ranks
    for result in results:
        assert result["resumed"]["restored_step"] == WINDOW
        unbroken, resumed = result["unbroken_state"], result["resumed_state"]
        assert unbroken.keys() == resumed.keys()
        for key, value in unbroken.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(value, resumed[key], err_msg=key)
            else:
                assert value == resumed[key], key
    # One process cannot restore what two saved (elastic re-placement is not ported).
    loader = checkpointing.Checkpointer("ff_ppo", rel_dir=str(root / "runs" / "checkpoints"),
                                        checkpoint_uid="unbroken")
    with pytest.raises(ValueError, match=r"saved by 2 process\(es\) and this run has 1"):
        loader.restore(None)


def test_ppo_learns_identity_game_over_two_ranks(two_ranks):
    returns = [r["oracle"]["return"] for r in two_ranks[1]]
    assert returns[0] == returns[1]  # the gathered, global evaluation
    assert returns[0] > 8.0, f"2-rank PPO failed to learn IdentityGame: {returns[0]}"
    assert two_ranks[1][1]["oracle"]["num_envs_per_rank"] == 32


def test_mesh_helpers_shard_gather_and_replicate(two_ranks):
    for rank, result in enumerate(two_ranks[1]):
        got = result["mesh_helpers"]
        np.testing.assert_array_equal(got["shard"], MESH_ARRAY[3 * rank:3 * (rank + 1)])
        np.testing.assert_array_equal(got["gathered"], MESH_ARRAY)
        np.testing.assert_array_equal(got["gathered_last"], MESH_ARRAY.T)
        np.testing.assert_array_equal(got["replicated"], MESH_ARRAY)


@pytest.mark.parametrize("system", ["ff_rainbow", "rec_r2d2"])
def test_sequence_replay_step_on_two_ranks_matches_shard_map(two_ranks, system):
    root = "default/anakin/default_" + system + ".yaml"
    jcfg = jax_config.compose(jax_config.default_config_dir(), root,
                              RAINBOW if system == "ff_rainbow" else R2D2)
    jax_net, online, target, _, _, samples, draws, _ = _sequence_inputs(system)
    module = test_torch_rainbow if system == "ff_rainbow" else test_torch_r2d2
    optim = optax.chain(optax.clip_by_global_norm(float(jcfg.system.max_grad_norm)),
                        optax.adam(float(jcfg.system.q_lr), eps=1e-5))
    update = module._jax_update(jax_net, jcfg, optim, axes=("batch", "data"))
    mesh = jax_create_mesh({"data": 2}, devices=jax.devices()[:2])

    def shard(seqs, probs):
        def replica(seq, prob):
            params, opt_state = JaxOnlineAndTarget(online, target), optim.init(online)
            losses, priorities = [], []
            for epoch in range(2):
                (params, opt_state), (loss, prio) = update(
                    params, opt_state, jax.tree.map(lambda x: x[epoch], seq), prob[epoch],
                    draws[epoch])
                losses.append(loss)
                priorities.append(prio)
            return params, jnp.stack(losses), jnp.stack(priorities)

        out = jax.vmap(replica, axis_name="batch")(
            jax.tree.map(lambda x: x[0][None], seqs), probs[0][None])
        return jax.tree.map(lambda x: x[None], out)

    # [rank, epoch, ...] inputs, split over "data".
    seqs = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jax.tree.map(lambda *ys: jnp.stack(ys), *[
            module._jax_experience(samples[epoch][rank][0]) for epoch in range(2)])
        for rank in range(2)])
    probs = jnp.stack([jnp.stack([jnp.asarray(samples[epoch][rank][1]) for epoch in range(2)])
                       for rank in range(2)])
    want_params, want_losses, want_prio = jax.jit(shard_map(
        shard, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P("data"),
        check_vma=False))(seqs, probs)
    for rank, result in enumerate(two_ranks[1]):
        got = result[system]
        np.testing.assert_allclose(got["losses"], np.asarray(want_losses)[rank, 0], rtol=1e-5)
        np.testing.assert_allclose(np.stack(got["priorities"]), np.asarray(want_prio)[rank, 0],
                                   rtol=1e-5, atol=1e-6)
        for side, name in ((0, "online"), (1, "target")):
            got_tree = to_flax_params({k: torch.from_numpy(v) for k, v in got[name].items()},
                                      online)
            want_tree = jax.tree.map(lambda x: np.asarray(x)[rank, 0], want_params[side])
            jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=0, atol=1e-5),
                         got_tree, want_tree)
    # Both ranks end with the same params: one data-mean gradient an epoch.
    for name in ("online", "target"):
        for key, value in two_ranks[1][0][system][name].items():
            np.testing.assert_array_equal(value, two_ranks[1][1][system][name][key])
    # Each rank's buffer, sized over the 2 data shards as the JAX package sizes it.
    jbuffer_cfg = jax_config.compose(jax_config.default_config_dir(), root,
                                     ["env=identity_game", *BUFFERS])
    min_length = (2 * int(jbuffer_cfg.system.rollout_length) if system == "ff_rainbow" else
                  2 * (int(jbuffer_cfg.system.burn_in_length) +
                       int(jbuffer_cfg.system.train_length)))
    local_envs, batch, length = jcore.trajectory_buffer_sizing(jbuffer_cfg, mesh, min_length)
    period = 1 if system == "ff_rainbow" else int(jbuffer_cfg.system.period)
    for result in two_ranks[1]:
        got = result[f"{system}_buffer"]
        assert got["reward"] == (local_envs, length) and local_envs == 16 // 2
        assert got["priorities"] == (local_envs, length // period)
        assert got["sample_batch"] == batch == 64 // 2
