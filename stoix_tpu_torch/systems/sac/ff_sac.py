"""Anakin SAC (counterpart of stoix_tpu/systems/sac/ff_sac.py): a squashed-
Gaussian actor (NormalAffineTanhDistributionHead on [lo, hi]), twin Q(s, a)
critics with online and target copies, and a learned temperature
`log_alpha`, on ff_ddpg's buffers, warm-up and learner.

`update_from_batch` on each replica's batch (ff_sac.py:126-185), with two
standard-normal draws [B, A] from the replica's generator (the JAX package's
`next_key` and `actor_key`):

  1. the target r + gamma (1 - done) (min_twins Q_target(s', a') - alpha log
     pi(a'|s')), a' and its log-prob from the actor on the first draw;
  2. the critics' clip + Adam step on mean((Q(s, a) - target)^2) and their
     Polyak update;
  3. the actor's clip + Adam step on mean(alpha log pi(a|s) - min_twins
     Q(s, a)) against the updated online critics, a from the second draw;
  4. under `autotune_alpha` the temperature's step on
     -mean(log_alpha (log pi + target_entropy)), with PLAIN Adam (eps 1e-8,
     no clip, the constant `alpha_lr`, as `optax.adam(alpha_lr)`);
     otherwise alpha stays and `alpha_loss` is 0.

Every gradient is averaged over the replicas, then the data ranks. The
actor has no target copy, and the evaluator takes replica 0's actor params.
The JAX ff_sac does not read `system.update_guard`; the port refuses it
(ROADMAP C18).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from stoix_tpu_torch import envs
from stoix_tpu_torch.base_types import OnlineAndTarget, Transition
from stoix_tpu_torch.systems import anakin, off_policy_core as core
from stoix_tpu_torch.systems.ddpg import ff_ddpg
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import ClipAdam, apply_updates, incremental_update


class SACParams(NamedTuple):
    actor_params: Dict[str, torch.Tensor]
    q_params: OnlineAndTarget
    log_alpha: torch.Tensor  # float32 scalar (one a replica under update_batch_size)


class SACOptStates(NamedTuple):
    actor_opt_state: Any
    q_opt_state: Any
    alpha_opt_state: Any


def build_networks(env: envs.Environment, config: Any, generator: torch.Generator):
    """(actor, q_network, (lo, hi)): the squashed-Gaussian actor on [lo, hi]
    and twin Q(s, a) critics."""
    from stoix_tpu_torch.networks.base import MultiNetwork

    lo, hi = ff_ddpg.action_bounds(env)
    actor = ff_ddpg.build_actor(env, config, generator, minimum=lo, maximum=hi)
    q_network = MultiNetwork([ff_ddpg.build_critic(env, config, generator) for _ in range(2)])
    return actor, q_network, (lo, hi)


class SACUpdate:
    """`update_from_batch` of SAC over lists of one entry a replica:
    `update(params, opt_states, batches, generators)` draws each replica's
    two normals and hands them to `step`, which a test can call with its own."""

    def __init__(self, actor_apply, q_apply, optims: Tuple[ClipAdam, ClipAdam, ClipAdam],
                 config: Any):
        self.actor_apply, self.q_apply = actor_apply, q_apply
        self.actor_optim, self.q_optim, self.alpha_optim = optims
        self.gamma = float(config.system.gamma)
        self.tau = float(config.system.tau)
        self.action_dim = int(config.system.action_dim)
        scale = float(config.system.get("target_entropy_scale", 1.0))
        self.target_entropy = scale * -self.action_dim
        self.autotune = bool(config.system.get("autotune_alpha", True))
        self.data_group = anakin.data_group()

    def draw_noise(self, batch: Transition, generator: Optional[torch.Generator]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = (batch.reward.shape[0], self.action_dim)
        return tuple(torch.randn(shape, generator=generator, device=batch.reward.device)
                     for _ in range(2))

    def __call__(self, params: List[SACParams], opt_states: List[SACOptStates],
                 batches: List[Transition],
                 generators: Optional[Sequence[torch.Generator]] = None):
        generators = [None] * len(batches) if generators is None else generators
        return self.step(params, opt_states, batches,
                         [self.draw_noise(b, g) for b, g in zip(batches, generators)])

    def targets(self, params: SACParams, batch: Transition, noise: torch.Tensor) -> torch.Tensor:
        next_action, next_log_prob = self.actor_apply(
            params.actor_params, batch.next_obs).sample_and_log_prob(noise=noise)
        q_next = torch.amin(self.q_apply(params.q_params.target, batch.next_obs, next_action),
                            dim=-1)
        alpha = torch.exp(params.log_alpha)
        d_t = ff_ddpg.discounts(batch, self.gamma)
        return batch.reward + d_t * (q_next - alpha * next_log_prob)

    def q_loss(self, q_online, batch: Transition, target: torch.Tensor):
        q_pred = self.q_apply(q_online, batch.obs, batch.action)  # [B, 2]
        loss = torch.mean((q_pred - target[:, None]) ** 2)
        return loss, {"q_loss": loss, "mean_q": torch.mean(q_pred)}

    def actor_loss(self, actor_params, q_online, log_alpha: torch.Tensor, obs: Any,
                   noise: torch.Tensor):
        action, log_prob = self.actor_apply(actor_params, obs).sample_and_log_prob(noise=noise)
        q = torch.amin(self.q_apply(q_online, obs, action), dim=-1)
        loss = torch.mean(torch.exp(log_alpha) * log_prob - q)
        return loss, (log_prob, {"actor_loss": loss, "entropy": -torch.mean(log_prob)})

    def alpha_loss(self, alpha_params: Dict[str, torch.Tensor], log_prob: torch.Tensor):
        log_alpha = alpha_params["log_alpha"]
        loss = -torch.mean(log_alpha * (log_prob + self.target_entropy).detach())
        return loss, {"alpha_loss": loss, "alpha": torch.exp(log_alpha)}

    def _apply(self, optim: ClipAdam, grads, params: List[Dict[str, torch.Tensor]],
               opt_states: List[Any]):
        new_params, new_opts = [], []
        for p, opt in zip(params, opt_states):
            updates, opt = optim.update(grads, opt)
            new_params.append(apply_updates(p, updates))
            new_opts.append(opt)
        return new_params, new_opts

    def step(self, params: List[SACParams], opt_states: List[SACOptStates],
             batches: List[Transition], noises: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        group = self.data_group
        # 1-2. The critics.
        with torch.no_grad():
            targets = [self.targets(p, b, n[0]) for p, b, n in zip(params, batches, noises)]
        per = [core.value_and_grad(self.q_loss, p.q_params.online, b, t)
               for p, b, t in zip(params, batches, targets)]
        q_online, q_opts = self._apply(self.q_optim, core.pmean_grads([g for g, _ in per], group),
                                       [p.q_params.online for p in params],
                                       [o.q_opt_state for o in opt_states])
        q_params = [OnlineAndTarget(online, incremental_update(online, p.q_params.target,
                                                               self.tau))
                    for online, p in zip(q_online, params)]
        metrics = [dict(m) for _, m in per]
        # 3. The actor, against the updated critics.
        actor_per = [core.value_and_grad(self.actor_loss, p.actor_params, q, p.log_alpha, b.obs,
                                         n[1])
                     for p, q, b, n in zip(params, q_online, batches, noises)]
        actor_params, actor_opts = self._apply(
            self.actor_optim, core.pmean_grads([g for g, _ in actor_per], group),
            [p.actor_params for p in params], [o.actor_opt_state for o in opt_states])
        for m, (_, (_, actor_metrics)) in zip(metrics, actor_per):
            m.update(actor_metrics)
        # 4. The temperature.
        if self.autotune:
            alpha_per = [core.value_and_grad(self.alpha_loss, {"log_alpha": p.log_alpha}, lp)
                         for p, (_, (lp, _)) in zip(params, actor_per)]
            alphas, alpha_opts = self._apply(
                self.alpha_optim, core.pmean_grads([g for g, _ in alpha_per], group),
                [{"log_alpha": p.log_alpha} for p in params],
                [o.alpha_opt_state for o in opt_states])
            log_alphas = [a["log_alpha"] for a in alphas]
            for m, (_, alpha_metrics) in zip(metrics, alpha_per):
                m.update(alpha_metrics)
        else:
            log_alphas = [p.log_alpha for p in params]
            alpha_opts = [o.alpha_opt_state for o in opt_states]
            for m, p in zip(metrics, params):
                m.update({"alpha_loss": torch.zeros((), device=p.log_alpha.device),
                          "alpha": torch.exp(p.log_alpha)})
        new_params = [SACParams(a, q, la) for a, q, la in zip(actor_params, q_params, log_alphas)]
        new_opts = [SACOptStates(a, q, al) for a, q, al in zip(actor_opts, q_opts, alpha_opts)]
        return new_params, new_opts, ff_ddpg.join_metrics(metrics)


def make_optimizers(config: Any) -> Tuple[ClipAdam, ClipAdam, ClipAdam]:
    """The actor's and the critics' clip + Adam (eps 1e-5), and the
    temperature's plain Adam (eps 1e-8, no clip, constant `alpha_lr`)."""
    actor_optim, q_optim = ff_ddpg.make_optimizers(config)
    return actor_optim, q_optim, ClipAdam(float(config.system.get("alpha_lr", 3e-4)), None,
                                          eps=1e-8)


def initial_log_alpha(config: Any, device: torch.device) -> torch.Tensor:
    """log(`init_alpha`) in float32, as `jnp.log` of the float32 value."""
    value = np.log(np.float32(float(config.system.get("init_alpha", 1.0))))
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def learner_setup(env: envs.Environment, config: Any, device: torch.device, seed: int):
    """The networks (initialised on the CPU from `seed`, then moved to
    `device`), the three optimizers, the buffers, the learner and its
    initial state; returns (setup, warmup)."""
    ff_ddpg.refuse_ignored_knobs(config, "ff_sac")
    config.system.action_dim = env.num_actions
    init_seed, env_seed, step_seed = anakin.make_seeds(seed, 3)
    actor, q_network, _ = build_networks(
        env, config, anakin.make_generator(init_seed, torch.device("cpu")))
    actor.to(device)
    q_network.to(device)
    actor_apply, q_apply = ff_ddpg.make_apply(actor), ff_ddpg.make_apply(q_network)
    optims = make_optimizers(config)
    actor_p, q_p = ff_ddpg.detached_params(actor), ff_ddpg.detached_params(q_network)
    log_alpha = initial_log_alpha(config, device)
    params = SACParams(actor_p, OnlineAndTarget(q_p, q_p), log_alpha)
    opt_states = SACOptStates(optims[0].init(actor_p), optims[1].init(q_p),
                              optims[2].init({"log_alpha": log_alpha}))

    def act_in_env(params: SACParams, observation: Any, generator: torch.Generator,
                   buffer_state: Any = None) -> torch.Tensor:
        return actor_apply(params.actor_params, observation).sample(generator)

    return ff_ddpg.assemble_setup(
        env, config, device, env_seed, step_seed, params, opt_states,
        SACUpdate(actor_apply, q_apply, optims, config), act_in_env, actor_apply,
        lambda p: p.actor_params)


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return ff_ddpg.run_off_policy_experiment(config, learner_setup, device)


def main() -> float:
    import sys

    config = config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_sac.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
