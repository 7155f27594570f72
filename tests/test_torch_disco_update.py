"""Anakin ff_disco103 of the PyTorch port (stoix_tpu_torch/systems/disco/
ff_disco103.py) against the JAX package's, on the CPU, at a small width
(MLP 16 x 16, LSTM 8, 11 bins on [-10, 10]); the JAX learner's meta-params
come from a local npz (no download is ever tried: `urlretrieve` raises).

1. (The rollout fed the JAX package's action draws, the sweep's runs, a
   resume and the refusals are in tests/test_torch_disco_sweep.py.)
2. The update at `update_batch_size` 1 and 2, in both rule modes, from one
   [T, E] trajectory with terminal steps, against the JAX package's own
   `_update_epoch` twice under vmap over "batch" and "data", fed the
   permutations its keys draw: losses 1e-5 relative, params and the
   meta-state's EMA params 1e-5 absolute, its update count exact; no B1
   call.
"""

import inspect
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.networks.disco import DiscoAgentOutput as JaxOutput
from stoix_tpu.systems.disco import ff_disco103 as jax_disco
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch import envs
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.networks.disco import DiscoAgentOutput
from stoix_tpu_torch.systems.disco import ff_disco103, update_rule
from stoix_tpu_torch.systems.disco.update_rule import MetaState
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps
from test_torch_az import jax_learner, replica
from test_torch_continuous import _count_b1_calls
from torch_parity import n, t, to_flax_params

ROOT = "default/anakin/default_ff_disco103.yaml"
SMALL = ["network.agent_network.shared_torso.layer_sizes=[16,16]",
         "network.agent_network.action_conditional_torso.lstm_size=8", "system.num_bins=11",
         "system.vmax=10.0"]


@pytest.fixture(autouse=True)
def no_download(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a test tried a download")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def meta_file(tmp_path, seed=5):
    """A meta-params npz for the configs' rule (A = 2, 11 bins), in the
    layout both packages read (tests/test_torch_disco.py holds it both ways)."""
    rule = update_rule.DiscoUpdateRule(num_actions=2, num_bins=11, vmax=10.0, mode="meta")
    path = tmp_path / "meta.npz"
    np.savez(path, **update_rule.flatten_meta_params(
        rule.init_params(torch.Generator().manual_seed(seed))))
    return str(path)


def compose(overrides, tmp_path):
    overrides = overrides + [f"system.meta_params_path={meta_file(tmp_path)}"]
    cfg = check_total_timesteps(config_lib.compose(config_lib.default_config_dir(), ROOT,
                                                   overrides), 1)
    return cfg, jax_config.compose(jax_config.default_config_dir(), ROOT, overrides)


def port_learner(cfg, jparams):
    """The port's learner on the CPU and the JAX package's params in its layout."""
    env, _ = envs.make(cfg)
    setup = ff_disco103.learner_setup(env, cfg, torch.device("cpu"), 3)
    network = ff_disco103.build_network(env, cfg, torch.Generator(), int(cfg.system.num_bins))
    load_flax_params(network, jparams)
    return setup, {k: v.detach().clone() for k, v in network.named_parameters()}


def stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs)[None], *trees)


def trajectory(seed, t_len, n_envs, num_bins):
    rng = np.random.default_rng(seed)
    lead = (t_len, n_envs)
    done = rng.random(lead) < 0.15
    heads = {"logits": (2,), "q": (2, num_bins), "y": (num_bins,), "z": (2, num_bins),
             "aux_pi": (2, 2)}
    return {
        "done": done, "truncated": (rng.random(lead) < 0.1) & ~done,
        "action": rng.integers(0, 2, lead).astype(np.int32),
        "reward": rng.normal(0.5, 1.0, lead).astype(np.float32),
        "obs": {"agent_view": rng.normal(size=lead + (4,)).astype(np.float32),
                "action_mask": np.ones(lead + (2,), np.float32),
                "step_count": np.zeros(lead, np.int32)},
        "agent_out": {k: rng.normal(size=lead + s).astype(np.float32) for k, s in heads.items()},
    }


def as_jax(traj):
    return jax_disco.DiscoTransition(
        done=traj["done"], truncated=traj["truncated"], action=traj["action"],
        reward=traj["reward"],
        obs=JaxObservation(*(traj["obs"][k] for k in JaxObservation._fields)), info={},
        agent_out=JaxOutput(**traj["agent_out"]))


def as_port(traj):
    return ff_disco103.DiscoTransition(
        done=t(traj["done"]), truncated=t(traj["truncated"]), action=t(traj["action"]),
        reward=t(traj["reward"]),
        obs=Observation(*(t(traj["obs"][k]) for k in Observation._fields)), info={},
        agent_out=DiscoAgentOutput(**{k: t(v) for k, v in traj["agent_out"].items()}))


def jax_permutations(key, epochs, minibatches, num_envs):
    """The envs' permutation of each epoch from a replica's key
    (`_update_epoch` splits off the shuffle key, each minibatch one more)."""
    perms = []
    for _ in range(epochs):
        key, shuffle_key = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(shuffle_key, num_envs)))
        for _ in range(minibatches):
            key, _ = jax.random.split(key)
    return perms


@pytest.mark.parametrize("mode", ["grounded", "meta"])
@pytest.mark.parametrize("update_batch", [1, 2])
def test_update_fed_jax_permutations_matches_the_jax_update_epochs(update_batch, mode,
                                                                  monkeypatch, tmp_path):
    cfg, jcfg = compose(SMALL + [f"arch.update_batch_size={update_batch}",
                                 "arch.total_num_envs=16", "system.rollout_length=6",
                                 f"system.rule_mode={mode}", "system.lr=3e-3",
                                 "system.max_abs_update=0.05"], tmp_path)
    jsetup, update_step = jax_learner(jax_disco, "get_learner_fn", None, jcfg, monkeypatch)
    update_epoch = inspect.getclosurevars(update_step).nonlocals["_update_epoch"]
    jparams, jopts = replica(jsetup.learner_state.params), replica(jsetup.learner_state.opt_states)
    jmeta = replica(jsetup.learner_state.meta_state)
    rng = np.random.default_rng(3)
    jmeta = jmeta._replace(target_params=jax.tree.map(
        lambda x: x + rng.normal(0.0, 0.05, np.shape(x)).astype(np.float32),
        jmeta.target_params))
    e_u = 16 // update_batch
    trajs = [trajectory(40 + u, 6, e_u, 11) for u in range(update_batch)]
    keys = jax.random.split(jax.random.PRNGKey(21), update_batch)
    carry = (stack([jparams] * update_batch), stack([jopts] * update_batch),
             stack([as_jax(x) for x in trajs]), stack([jmeta] * update_batch), keys[None])
    fn = jax.jit(jax.vmap(jax.vmap(update_epoch, axis_name="batch"), axis_name="data"))
    want = []
    for _ in range(2):
        carry, logs = fn(carry, None)
        want.append((carry[0], carry[3], jax.tree.map(np.asarray, logs)))

    setup, params = port_learner(cfg, jparams)
    meta_state = MetaState(port_learner(cfg, jmeta.target_params)[1],
                           torch.tensor(0, dtype=torch.int32))
    broadcast = ff_disco103.anakin.broadcast_to_update_batch
    traj = as_port(jax.tree.map(lambda *xs: np.concatenate(xs, 1), *trajs))
    minibatches = int(cfg.system.num_minibatches)
    perms = [jax_permutations(k, 2, minibatches, e_u) for k in keys]
    perms = [t(np.stack([p[epoch] for p in perms])) if update_batch > 1 else t(perms[0][epoch])
             for epoch in range(2)]
    calls = _count_b1_calls(monkeypatch)
    params, _, meta, metrics = setup.learn.update(
        broadcast(params, update_batch), broadcast(setup.learn.optim.init(params), update_batch),
        broadcast(meta_state, update_batch), traj, permutations=perms)
    assert calls == {"gae": 0, "generic": 0}
    for epoch, (_, _, wlogs) in enumerate(want):
        for key in ("loss_pi", "loss_q", "loss_y"):
            got = n(metrics[key][epoch]).reshape(minibatches, update_batch).T  # [U, M]
            np.testing.assert_allclose(got, wlogs[key][0], rtol=1e-5, atol=1e-6, err_msg=key)
    wparams, wmeta, _ = want[-1]
    for u, (p, m) in enumerate(zip(ff_disco103.anakin.split_replicas(params, update_batch),
                                   ff_disco103.anakin.split_replicas(meta, update_batch))):
        for got, tree in ((p, wparams), (m.target_params, wmeta.target_params)):
            like = jax.tree.map(lambda x: np.asarray(x)[0, u], tree)
            for g, w in zip(jax.tree.leaves(to_flax_params(got, like)), jax.tree.leaves(like)):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        assert int(m.num_updates) == int(np.asarray(wmeta.num_updates)[0, u]) == 2 * minibatches
