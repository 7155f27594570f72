"""Anakin MPO of the PyTorch port (stoix_tpu_torch/systems/mpo: ff_mpo,
ff_mpo_continuous) against the JAX package's, on the CPU, at a small width
(MLPs of 16 x 16).

1. Two update epochs on explicit [B, L] sequence batches (terminations,
   behaviour log-probs on both sides of the target's), from the JAX
   package's own flax params with both targets perturbed away from their
   online copies, against JAX ff_mpo.py's own `_update_epoch` (taken from
   its `learner_fn`'s closure, its buffer's sample handing back the given
   sequences) under `jax.vmap(axis_name="batch")` in
   `jax.vmap(axis_name="data")`, jitted, the continuous losses fed the JAX
   package's own `jax.random` draws from the replicas' keys as standard
   normals; for the Categorical policy (the discrete Q critic on the
   actor's input layer, read through its preferences) and the tanh-Gaussian
   one, at `update_batch_size` 1 and 2: losses 1e-5 relative, params and
   duals 1e-5 absolute, and one call of B1's generic entry an epoch over
   [L - 2, U.B] with no gradient demanded of it.
2. The rollout stores the acting (online) policy's log-prob of each action;
   the update draws its normals from the replicas' generators after their
   samples; a resume after window 1 is bitwise the unbroken run (the duals
   and their Adam state carried); `system.update_guard` is refused naming
   the key (C19); each system at tests/test_systems_sweep.py's budget (the
   continuous one at 16 x 16 with 16 samples); IdentityGame above 8.0 where
   the JAX package returns 10.0.
"""

import inspect
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu import envs as jax_envs
from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.parallel.mesh import create_mesh
from stoix_tpu.systems.mpo import ff_mpo as jax_mpo
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import OnlineAndTarget
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.kernels import linear_recurrence
from stoix_tpu_torch.systems import anakin, runner
from stoix_tpu_torch.systems.ddpg import ff_ddpg
from stoix_tpu_torch.systems.mpo import ff_mpo, ff_mpo_continuous
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from stoix_tpu_torch.utils.tree import tree_map
from test_torch_continuous import _count_b1_calls
from test_torch_ddpg import perturbed
from test_torch_vmpo import SMALL
from torch_parity import n, t, to_flax_params

ROOTS = {"ff_mpo": "default/anakin/default_ff_mpo.yaml",
         "ff_mpo_continuous": "default/anakin/default_ff_mpo_continuous.yaml"}
MODULES = {"ff_mpo": ff_mpo, "ff_mpo_continuous": ff_mpo_continuous}
BUFFER = ["system.total_buffer_size=4096", "system.total_batch_size=32"]
SWEEP = ["arch.total_num_envs=16", "arch.total_timesteps=2048", "arch.num_evaluation=1",
         "arch.num_eval_episodes=8", "arch.absolute_metric=False", "system.rollout_length=8",
         "logger.use_console=False", "system.multistep_impl=pallas"] + BUFFER
BATCH, SEQ, SAMPLES = 6, 7, 4
METRICS = ("q_loss", "mean_q", "policy_loss", "temperature", "kl")


def jax_learner(jcfg, monkeypatch):
    """JAX ff_mpo.py's own `_update_epoch`, built by its `get_learner_fn`
    from the networks and optimizers its `learner_setup` makes on a
    one-device mesh, with a buffer whose sample hands back its state (the
    given sequences); and its first replica's initial params and optimizer
    states."""
    captured = {}
    original = jax_mpo.get_learner_fn

    def capture(env, networks, update_fns, buffer, config, continuous):
        captured.update(args=(env, networks, update_fns), continuous=continuous)
        return original(env, networks, update_fns, buffer, config, continuous)

    monkeypatch.setattr(jax_mpo, "get_learner_fn", capture)
    env, _ = jax_envs.make(jcfg)
    mesh = create_mesh({"data": 1}, jax.devices()[:1])
    setup = jax_mpo.learner_setup(env, jcfg, mesh, jax.random.PRNGKey(3))
    given = SimpleNamespace(sample=lambda state, key: SimpleNamespace(experience=state))
    learn = original(*captured["args"], given, jcfg, captured["continuous"])
    update_step = inspect.getclosurevars(learn).nonlocals["_update_step"]
    update_epoch = inspect.getclosurevars(update_step).nonlocals["_update_epoch"]
    first = jax.tree.map(lambda x: np.asarray(x)[0], (setup.learner_state.params,
                                                      setup.learner_state.opt_states))
    return update_epoch, first[0], first[1]


def sequences(seed, env, continuous):
    """[B, L] sequences with terminations, each step's behaviour log-prob
    scattered around the policy's."""
    rng = np.random.default_rng(seed)
    obs_value = env.observation_value()
    obs_dim = int(obs_value.agent_view.shape[-1])
    mask_dim = int(obs_value.action_mask.shape[-1])
    lead = (BATCH, SEQ)
    return {
        "obs": {"agent_view": rng.normal(size=lead + (obs_dim,)).astype(np.float32),
                "action_mask": np.ones(lead + (mask_dim,), np.float32),
                "step_count": np.zeros(lead, np.int32)},
        "action": (rng.uniform(-1.9, 1.9, lead + (1,)).astype(np.float32) if continuous else
                   rng.integers(0, mask_dim, lead).astype(np.int32)),
        "log_prob": (rng.normal(-1.6 if continuous else -0.7, 0.5, lead)).astype(np.float32),
        "reward": rng.normal(size=lead).astype(np.float32),
        "discount": (rng.random(lead) > 0.15).astype(np.float32),
    }


def jax_sequences(seq):
    return {**seq, "obs": JaxObservation(*(seq["obs"][k] for k in JaxObservation._fields))}


def port_sequences(seq):
    return {**{k: t(v) for k, v in seq.items() if k != "obs"},
            "obs": Observation(*(t(seq["obs"][k]) for k in Observation._fields))}


def jax_normals(key, action_dim):
    """The JAX epoch's draws from one replica's key: (the next key, the
    critic's [N, B, L, A] and the policy's [N, B.L, A] standard normals)."""
    key, _, critic_key, policy_key = jax.random.split(key, 4)

    def draws(k, shape):
        return np.asarray(jax.vmap(lambda s: jax.random.normal(s, shape))(
            jax.random.split(k, SAMPLES)))

    return key, (draws(critic_key, (BATCH, SEQ, action_dim)),
                 draws(policy_key, (BATCH * SEQ, action_dim)))


def jax_epochs(update_epoch, jparams, jopt, seqs, keys, epochs):
    u = len(seqs)
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs)[None], *trees)  # noqa: E731
    carry = (stack([jparams] * u), stack([jopt] * u), stack([jax_sequences(s) for s in seqs]),
             jnp.stack(keys)[None])
    fn = jax.jit(jax.vmap(jax.vmap(update_epoch, axis_name="batch"), axis_name="data"))
    out = []
    for _ in range(epochs):
        carry, metrics = fn(carry, None)
        out.append((carry[0], jax.tree.map(np.asarray, metrics)))
    return out


def assert_close(got, want, like, u):
    for g, w in zip(jax.tree.leaves(to_flax_params(got, like)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w)[0, u], rtol=0, atol=1e-5)


@pytest.mark.parametrize("update_batch", [1, 2])
@pytest.mark.parametrize("system", list(ROOTS))
def test_update_epochs_match_jax_update_epoch(system, update_batch, monkeypatch):
    continuous = system == "ff_mpo_continuous"
    overrides = SMALL + [f"arch.update_batch_size={update_batch}", "arch.total_num_envs=8",
                         f"system.num_samples={SAMPLES}", f"system.sample_sequence_length={SEQ}",
                         "system.total_buffer_size=1024", "system.total_batch_size=32",
                         "system.multistep_impl=pallas"]
    cfg = check_total_timesteps(config_lib.compose(config_lib.default_config_dir(),
                                                   ROOTS[system], overrides), 1)
    jcfg = jax_config.compose(jax_config.default_config_dir(), ROOTS[system], overrides)
    update_epoch, jparams, jopt = jax_learner(jcfg, monkeypatch)
    actor, q = jparams.actor_params, jparams.q_params
    jparams = jparams._replace(actor_params=actor._replace(target=perturbed(actor.target, 1)),
                               q_params=q._replace(target=perturbed(q.target, 2)))
    env, _ = envs.make(cfg)
    cfg.system.action_dim = env.num_actions
    seqs = [sequences(20 + u, env, continuous) for u in range(update_batch)]
    keys = list(jax.random.split(jax.random.PRNGKey(11), update_batch))
    want = jax_epochs(update_epoch, jparams, jopt, seqs, keys, 2)

    actor, q_network = ff_mpo.build_networks(env, cfg, torch.Generator(), continuous)

    def as_port(network, flax_params):
        load_flax_params(network, flax_params)
        return {k: v.detach().clone() for k, v in network.named_parameters()}

    params = ff_mpo.MPOParams(
        OnlineAndTarget(as_port(actor, jparams.actor_params.online),
                        as_port(actor, jparams.actor_params.target)),
        OnlineAndTarget(as_port(q_network, jparams.q_params.online),
                        as_port(q_network, jparams.q_params.target)),
        t(jparams.log_temperature), t(jparams.log_alpha))
    optims = ff_mpo.make_optimizers(cfg)
    update = ff_mpo.MPOUpdate(ff_ddpg.make_apply(actor), ff_ddpg.make_apply(q_network), optims,
                              cfg, continuous)
    opt = ff_mpo.MPOOptStates(
        optims[0].init(params.actor_params.online), optims[1].init(params.q_params.online),
        optims[2].init(ff_mpo.dual_params(params.log_temperature, params.log_alpha)))
    params, opts = [params] * update_batch, [opt] * update_batch
    batches = [port_sequences(s) for s in seqs]

    original = linear_recurrence.linear_recurrence_reverse

    def no_grad_inputs(weight, delta, init):
        assert not (weight.requires_grad or delta.requires_grad or init.requires_grad)
        assert weight.shape == (SEQ - 2, BATCH * update_batch)
        return original(weight, delta, init)

    monkeypatch.setattr(linear_recurrence, "linear_recurrence_reverse", no_grad_inputs)
    calls = _count_b1_calls(monkeypatch)
    for wparams, wmetrics in want:
        noises = [None] * update_batch
        if continuous:
            drawn = [jax_normals(k, 1) for k in keys]
            keys = [k for k, _ in drawn]
            noises = [tuple(map(t, normals)) for _, normals in drawn]
        params, opts, metrics = update.step(params, opts, batches, noises)
        for key in METRICS:
            got = n(metrics[key]).reshape((update_batch,) + wmetrics[key].shape[2:])
            np.testing.assert_allclose(got, wmetrics[key][0], rtol=1e-5, atol=1e-7, err_msg=key)
        for u in range(update_batch):
            for pair, like in (("actor_params", jparams.actor_params.online),
                               ("q_params", jparams.q_params.online)):
                for side in ("online", "target"):
                    assert_close(getattr(getattr(params[u], pair), side),
                                 getattr(getattr(wparams, pair), side), like, u)
            for name in ("log_temperature", "log_alpha"):
                np.testing.assert_allclose(n(getattr(params[u], name)),
                                           np.asarray(getattr(wparams, name))[0, u], rtol=0,
                                           atol=1e-5)
    assert calls == {"gae": 0, "generic": 2}
    assert opts[0].dual_opt_state.count == 2 and opts[0].q_opt_state.count == 2


def small_config(system, extra=()):
    overrides = SMALL + ["system.num_samples=16"] if system == "ff_mpo_continuous" else []
    extra = ["env=identity_game"] + list(extra) if system == "ff_mpo" else list(extra)
    return check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), ROOTS[system], overrides + SWEEP + extra), 1)


@pytest.mark.parametrize("system", list(ROOTS))
def test_rollout_stores_the_acting_policys_log_prob(system):
    continuous = system == "ff_mpo_continuous"
    cfg = small_config(system)
    setup = ff_mpo.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 3)
    state, traj = setup.learn.rollout(setup.learner_state)
    buffer = state.buffer_state
    assert set(buffer.experience) == {"obs", "action", "log_prob", "reward", "discount"}
    assert buffer.experience["action"].dtype == (torch.float32 if continuous else torch.int32)
    assert buffer.num_added == 8 and "info" in traj
    actor_apply = setup.learn.update_from_batch.actor_apply
    online = state.params.actor_params.online
    want = torch.stack([actor_apply(online, tree_map(lambda x: x[i], traj["obs"]))
                        .log_prob(traj["action"][i]) for i in range(8)])
    assert torch.equal(traj["log_prob"], want)
    assert torch.equal(buffer.experience["log_prob"][:, :8], want.T)


def test_update_draws_its_normals_after_the_sample_from_the_replicas_generators():
    cfg = small_config("ff_mpo_continuous", ["arch.update_batch_size=2"])
    setup = ff_mpo.learner_setup(envs.make(cfg)[0], cfg, torch.device("cpu"), 5)
    state, _ = setup.learn.rollout(setup.learner_state)
    update = setup.learn.update_from_batch
    generators = list(state.generator)
    copies = [torch.Generator().set_state(g.get_state()) for g in generators]
    batches = [setup.learn.buffer.sample(b, g).experience
               for b, g in zip(state.buffer_state, copies)]
    for g, c in zip(generators, copies):
        g.set_state(c.get_state())
    noises = [update.draw_noise(b, c) for b, c in zip(batches, copies)]
    seq = int(cfg.system.sample_sequence_length)
    assert noises[0][0].shape == (16, 16, seq, 1) and noises[0][1].shape == (16, 16 * seq, 1)
    assert not torch.equal(noises[0][0], noises[1][0])
    params = anakin.split_replicas(state.params, 2)
    opts = anakin.split_replicas(state.opt_states, 2)
    got = update(params, opts, batches, generators)
    want = update.step(params, opts, batches, noises)
    for g, w in zip(jax.tree.leaves(got[0], is_leaf=torch.is_tensor),
                    jax.tree.leaves(want[0], is_leaf=torch.is_tensor)):
        assert torch.equal(g, w)


def test_mpo_resume_after_window_one_is_bitwise_the_unbroken_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    window = 2 * 8 * 8

    def run(uid, windows, extra=()):
        config = config_lib.compose(
            config_lib.default_config_dir(), ROOTS["ff_mpo"], SMALL + [
                "env=identity_game", "arch.total_num_envs=8", "system.rollout_length=8",
                "system.epochs=3", "system.total_buffer_size=1024", "system.total_batch_size=16",
                "arch.num_eval_episodes=4", "logger.use_console=False",
                "logger.checkpointing.save_model=true",
                f"logger.checkpointing.save_args.checkpoint_uid={uid}",
                "logger.checkpointing.save_args.max_to_keep=~",
                f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * window}",
                *extra])
        ff_mpo.run_experiment(config, device="cpu")

    run("unbroken", 2)
    run("first", 1)
    run("resumed", 1, ["logger.checkpointing.load_model=true",
                       "logger.checkpointing.load_args.checkpoint_uid=first"])
    assert runner.LAST_RUN_STATS["resilience"]["restored_step"] == window
    load = lambda uid: torch.load(  # noqa: E731
        os.path.join(tmp_path, "checkpoints", uid, "ff_mpo", str(2 * window), "state.pt"),
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
    assert unbroken["opt_states/dual_opt_state/count"] == 2 * 2 * 3
    assert float(unbroken["params/log_temperature"]) != 3.0


@pytest.mark.parametrize("system", list(ROOTS))
def test_update_guard_the_reference_ignores_is_refused_naming_the_key(system):
    with pytest.raises(NotImplementedError, match="system.update_guard"):
        MODULES[system].run_experiment(small_config(system, ["system.update_guard=halt"]),
                                       device="cpu")


@pytest.mark.parametrize("system", list(ROOTS))
def test_each_system_runs_at_the_sweep_budget_with_one_generic_call_an_epoch(system,
                                                                            monkeypatch):
    calls = _count_b1_calls(monkeypatch)
    cfg = small_config(system)
    assert np.isfinite(MODULES[system].run_experiment(cfg, device="cpu"))
    assert calls == {"gae": 0, "generic": 2048 // (16 * 8) * int(cfg.system.epochs)}


def test_mpo_learns_identity_game():
    import chip_smoke

    cfg = config_lib.compose(config_lib.default_config_dir(), ROOTS["ff_mpo"],
                             chip_smoke.MPO_IDENTITY)
    assert ff_mpo.run_experiment(cfg, device="cpu") > chip_smoke.MPO_THRESHOLD
