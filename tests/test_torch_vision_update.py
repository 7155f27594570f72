"""The vision paths of the port's systems against the JAX package's
compositions, on image observations from a numpy seed:

1. One ff_ppo update step with network=cnn on MinAtar Breakout's 10x10x4
   boards, and one with network=visual_resnet, each against the JAX package's
   composition (test_torch_ff_ppo.py::_jax_update: the bootstrap critic pass,
   GAE, epochs x minibatches of loss, grad, clip and Adam) from the same flax
   init and explicit permutations. The port builds its networks through
   `ff_ppo.build_networks` from the config (the conv torsos take the
   observation's shape) and runs `system.multistep_impl=pallas`: GAE is one
   call of B1's GAE entry, on the CPU its plain version. Losses 1e-5
   relative, params 1e-5 absolute (gradients reduce in another order than
   XLA's); advantages and targets 1e-6 absolute.
2. One ff_dqn `update_from_batch` with network=cnn_dqn (two steps, so the
   second reads Adam's moments and a moved target): the loss 1e-5 relative,
   online and target params 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoix_tpu.base_types import OnlineAndTarget as JaxOnlineAndTarget
from stoix_tpu.base_types import Transition as JaxTransition
from stoix_tpu.envs.types import Observation as JaxObservation
from stoix_tpu.networks import base as jbase, heads as jheads, inputs as jinputs
from stoix_tpu.networks import resnet as jresnet, torso as jtorso
from stoix_tpu.systems.q_learning import ff_dqn as jax_dqn
from stoix_tpu.utils import config as jax_config
from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import (
    ActorCriticOptStates, ActorCriticParams, OnlineAndTarget, PPOTransition, Transition,
)
from stoix_tpu_torch.envs.types import Observation
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.q_learning import ff_dqn, q_family
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.params import load_flax_params
from stoix_tpu_torch.utils.training import ClipAdam
from test_torch_ff_ppo import _jax_update as jax_ppo_update
from test_torch_q_family import _jax_optim, _jax_update as jax_q_update
from torch_parity import n, t, to_flax_params

BOARD, ACTIONS = (10, 10, 4), 3


def _boards(rng, lead):
    """MinAtar-like observations: binary 10x10x4 boards."""
    return {"agent_view": rng.integers(0, 2, size=lead + BOARD).astype(np.float32),
            "action_mask": np.ones(lead + (ACTIONS,), np.float32),
            "step_count": np.zeros(lead, np.int32)}


def _trajectory(seed, t_len, n_envs):
    rng = np.random.default_rng(seed)
    done = rng.uniform(size=(t_len, n_envs)) < 0.1
    return {
        "obs": _boards(rng, (t_len, n_envs)), "next_obs": _boards(rng, (t_len, n_envs)),
        "action": rng.integers(0, ACTIONS, size=(t_len, n_envs)).astype(np.int32),
        "reward": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "value": rng.normal(size=(t_len, n_envs)).astype(np.float32),
        "log_prob": np.log(rng.uniform(0.2, 0.8, size=(t_len, n_envs))).astype(np.float32),
        "done": done,
        "truncated": (rng.uniform(size=(t_len, n_envs)) < 0.1) & ~done,
    }


def _jax_torso(pre_torso_cfg):
    kwargs = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in pre_torso_cfg.items() if k != "_target_"}
    cls = pre_torso_cfg["_target_"].rsplit(".", 1)[1]
    return (jresnet.VisualResNetTorso if cls == "VisualResNetTorso" else jtorso.CNNTorso)(**kwargs)


def _dummy_obs():
    return JaxObservation(jnp.zeros((1,) + BOARD), jnp.ones((1, ACTIONS)),
                          jnp.zeros((1,), jnp.int32))


PPO_OVERRIDES = ["env=breakout_jax", "system.epochs=2", "system.num_minibatches=2",
                 "system.actor_lr=1.0e-3", "system.critic_lr=1.0e-3",
                 "system.multistep_impl=pallas"]


@pytest.mark.parametrize("network", ["cnn", "visual_resnet"])
def test_ppo_update_step_on_boards_matches_jax_composition(network):
    overrides = PPO_OVERRIDES + [f"network={network}"]
    cfg = config_lib.compose(config_lib.default_config_dir(),
                             "default/anakin/default_ff_ppo.yaml",
                             overrides + ["arch.num_updates_per_eval=1"])
    jcfg = jax_config.compose(jax_config.default_config_dir(),
                              "default/anakin/default_ff_ppo.yaml", overrides)
    net = jcfg.network
    ja = jbase.FeedForwardActor(action_head=jheads.CategoricalHead(num_actions=ACTIONS),
                                torso=_jax_torso(net.actor_network.pre_torso),
                                input_layer=jinputs.ObservationInput())
    jc = jbase.FeedForwardCritic(critic_head=jheads.ScalarCriticHead(),
                                 torso=_jax_torso(net.critic_network.pre_torso),
                                 input_layer=jinputs.ObservationInput())
    ka, kc = jax.random.split(jax.random.PRNGKey(7))
    jap = jax.tree.map(np.asarray, ja.init(ka, _dummy_obs()))
    jcp = jax.tree.map(np.asarray, jc.init(kc, _dummy_obs()))
    env, _ = envs.make(cfg)
    ta, tc = ff_ppo.build_networks(env, cfg, torch.Generator().manual_seed(0))
    load_flax_params(ta, jap)
    load_flax_params(tc, jcp)

    t_len, n_envs = 4, 8
    traj = _trajectory(0, t_len, n_envs)
    perms = [np.random.default_rng(10 + e).permutation(t_len * n_envs) for e in range(2)]
    want_adv, want_tgt, want_losses, want_ap, want_cp = jax_ppo_update(
        ja, jap, jc, jcp, traj, perms, jcfg)

    actor_params = {k: v.detach() for k, v in ta.named_parameters()}
    critic_params = {k: v.detach() for k, v in tc.named_parameters()}
    optims = tuple(ClipAdam(1e-3, cfg.system.max_grad_norm, eps=1e-5) for _ in range(2))
    learner = ff_ppo.get_learner_fn(
        None, (ff_ppo.make_apply_fn(ta), ff_ppo.make_apply_fn(tc)), optims, cfg)
    as_obs = lambda o: Observation(*(t(o[k]) for k in Observation._fields))
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
    for got, want, before in ((result.params.actor_params, want_ap, jap),
                              (result.params.critic_params, want_cp, jcp)):
        got_tree = to_flax_params(got, want)
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5),
                     got_tree, want)
        moved = jax.tree.map(lambda g, w0: float(np.abs(g - w0).max()), got_tree, before)
        assert max(jax.tree.leaves(moved)) > 1e-4


def _q_batch(seed, size=16):
    rng = np.random.default_rng(seed)
    o, o2 = _boards(rng, (size,)), _boards(rng, (size,))
    fields = dict(action=rng.integers(0, ACTIONS, size).astype(np.int32),
                  reward=rng.normal(size=size).astype(np.float32),
                  done=rng.random(size) < 0.2)
    info = {"episode_return": np.zeros(size, np.float32),
            "episode_length": np.zeros(size, np.int32),
            "is_terminal_step": np.zeros(size, bool)}
    fields_in = ("action", "reward", "done")
    as_jax = lambda x: JaxObservation(*(jnp.asarray(x[k]) for k in JaxObservation._fields))
    as_port = lambda x: Observation(*(t(x[k]) for k in Observation._fields))
    return (JaxTransition(as_jax(o), *(jnp.asarray(fields[k]) for k in fields_in), as_jax(o2),
                          jax.tree.map(jnp.asarray, info)),
            Transition(as_port(o), *(t(fields[k]) for k in fields_in), as_port(o2),
                       {k: t(v) for k, v in info.items()}))


def test_dqn_update_from_batch_with_cnn_dqn_matches_jax():
    overrides = ["env=breakout_jax", "network=cnn_dqn"]
    root = "default/anakin/default_ff_dqn.yaml"
    cfg = config_lib.compose(config_lib.default_config_dir(), root, overrides)
    jcfg = jax_config.compose(jax_config.default_config_dir(), root, overrides)
    jax_net = jbase.FeedForwardActor(
        action_head=jheads.DiscreteQNetworkHead(
            action_dim=ACTIONS, epsilon=float(jcfg.system.evaluation_epsilon)),
        torso=_jax_torso(jcfg.network.actor_network.pre_torso),
        input_layer=jinputs.ObservationInput())
    online = jax.tree.map(np.asarray, jax_net.init(jax.random.PRNGKey(1), _dummy_obs()))
    target = jax.tree.map(np.asarray, jax_net.init(jax.random.PRNGKey(2), _dummy_obs()))
    env, _ = envs.make(cfg)
    torch_net = q_family.build_q_network(env, cfg, torch.Generator().manual_seed(0))
    load_flax_params(torch_net, target)
    port_target = {k: v.detach().clone() for k, v in torch_net.named_parameters()}
    load_flax_params(torch_net, online)
    port_online = {k: v.detach().clone() for k, v in torch_net.named_parameters()}

    jbatch, tbatch = _q_batch(3)
    optim = _jax_optim(jcfg)
    update = jax.jit(jax_q_update(jax_dqn.dqn_loss, jax_net.apply, jcfg, optim))
    params, state = JaxOnlineAndTarget(online, target), optim.init(online)
    port_optim = ClipAdam(float(cfg.system.q_lr), float(cfg.system.max_grad_norm), eps=1e-5)
    update_fn = q_family.QUpdate(ff_dqn.dqn_loss, q_family.make_q_apply(torch_net), port_optim,
                                 cfg)
    tparams = [OnlineAndTarget(port_online, port_target)]
    topt = [port_optim.init(port_online)]
    for _ in range(2):
        (params, state), loss = update(params, state, jbatch)
        tparams, topt, info = update_fn(tparams, topt, [tbatch])
        np.testing.assert_allclose(n(info["q_loss"]), np.asarray(loss), rtol=1e-5)
    for got, want in ((tparams[0].online, params.online), (tparams[0].target, params.target)):
        got_tree = to_flax_params(got, online)
        for g, w in zip(jax.tree.leaves(got_tree), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
