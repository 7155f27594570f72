"""Sebulba IMPALA (counterpart of stoix_tpu/systems/impala/sebulba/ff_impala.py):
an off-policy actor-critic with V-trace corrections (Espeholt et al. 2018) on
the Sebulba runner of systems/ppo/sebulba/ff_ppo.py.

The actors' stored log-probs are the behaviour policy. One learn step over
the learner devices' [T, E/n] shards, in the JAX package's order: with
`system.normalize_observations` the PPO learner's normalisation and folded
statistics; with `system.normalize_rewards` the rewards normalised by the
WHOLE batch's mean and std (the means over the shards, the JAX package's
pmean over "data"); then the env axis cut into `num_minibatches`
contiguous env-minibatches [T, E/(n m)] (each V-trace sees whole
trajectories), and for each one: every shard's policy, values and bootstrap
values, V-trace over [T, E/(n m)] in ONE call of the batched
`ops/multistep.py::vtrace_td_error_and_advantage` (the shards side by side
where they share a device: one launch of B1's generic entry under
`system.multistep_impl: pallas`), the loss `pg + vf_coef value - ent_coef
entropy`, its gradients summed over the shards (the JAX package's
arithmetic, ROADMAP C25; the metrics are the shards' means), the guard, and
a clip + Adam step of each network. One pass over the batch: `system.epochs` only
sets the learning-rate decay's horizon (utils/training.py), as in the JAX
package.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import torch

from stoix_tpu_torch.base_types import ActorCriticOptStates, ActorCriticParams, PPOTransition
from stoix_tpu_torch.ops import vtrace_td_error_and_advantage
from stoix_tpu_torch.observability import annotate
from stoix_tpu_torch.resilience import guards
from stoix_tpu_torch.systems.ppo.sebulba.ff_ppo import (
    CoreLearnerState,
    _cat_shards,
    _leaf_copies,
    _split_shards,
    normalized_shards,
    run_experiment as _run,
    same_device,
    shard_mean,
    shard_sum,
)
from stoix_tpu_torch.sebulba.core import place
from stoix_tpu_torch.utils import config as config_lib
from stoix_tpu_torch.utils.training import apply_updates


def split_env_minibatches(traj: PPOTransition, num_minibatches: int) -> List[PPOTransition]:
    """[T, E] -> `num_minibatches` contiguous env slices [T, E/m], time kept
    whole, as the JAX package's [m, T, E/m] split."""
    return [PPOTransition(*parts) for parts in zip(*(
        x.chunk(num_minibatches, dim=1) if isinstance(x, torch.Tensor) else
        _chunk_tree(x, num_minibatches) for x in traj))]


def _chunk_tree(tree: Any, m: int) -> List[Any]:
    if hasattr(tree, "_fields"):
        return [type(tree)(*parts) for parts in zip(*(_chunk_tree(x, m) for x in tree))]
    if isinstance(tree, dict):
        keys = list(tree)
        return [dict(zip(keys, parts)) for parts in zip(*(_chunk_tree(tree[k], m) for k in keys))
                ] if keys else [{} for _ in range(m)]
    return list(tree.chunk(m, dim=1))


def maybe_normalize_rewards(shards: Sequence[PPOTransition], config: Any,
                            devices: Sequence[torch.device]) -> List[PPOTransition]:
    """With `system.normalize_rewards`: every shard's rewards normalised by
    the whole batch's statistics (each shard's mean and mean square averaged
    over the shards, the JAX package's pmean over "data"), so the scaling
    does not depend on the learner device count."""
    if not bool(config.system.get("normalize_rewards", False)):
        return list(shards)
    home = devices[0]
    r_mean = shard_mean([s.reward.mean() for s in shards], home)
    r_sq = shard_mean([(s.reward ** 2).mean() for s in shards], home)
    r_std = torch.sqrt(torch.clamp(r_sq - r_mean ** 2, min=0.0))
    scale = float(config.system.get("reward_scale", 1.0))
    eps = float(config.system.get("reward_eps", 1e-8))
    return [s._replace(reward=scale * (s.reward - r_mean.to(d)) / (r_std.to(d) + eps))
            for s, d in zip(shards, devices)]


class ImpalaLearnStep:
    """`step(state, shards) -> (state, metrics)`: one Sebulba IMPALA update
    (the JAX package's `get_impala_learn_step` under `shard_map`). With
    `shared`, the actor and critic params are one tree (the shared torso):
    its gradients take the actor's optimizer alone, both slots stay equal
    and the critic's optimizer state is carried as it is, with no guard."""

    def __init__(self, actor_apply: Callable, critic_apply: Callable, optims: Tuple[Any, Any],
                 config: Any, learner_devices: Sequence[torch.device], shared: bool = False):
        self.actor_apply, self.critic_apply = actor_apply, critic_apply
        self.actor_optim, self.critic_optim = optims
        self.config = config
        self.devices = [torch.device(d) for d in learner_devices]
        self.shared = shared
        system = config.system
        self.gamma = float(system.gamma)
        self.lam = float(system.get("vtrace_lambda", 1.0))
        self.clip_rho = float(system.get("clip_rho_threshold", 1.0))
        self.clip_pg_rho = float(system.get("clip_pg_rho_threshold", 1.0))
        self.vf_coef = float(system.get("vf_coef", 0.5))
        self.ent_coef = float(system.get("ent_coef", 0.01))
        self.normalize_obs = bool(system.get("normalize_observations", False))
        self.num_minibatches = int(system.get("num_minibatches", 1))
        self.multistep_impl = str(system.get("multistep_impl", "scan"))
        self.guard_mode = "off" if shared else guards.resolve_mode(config)

    def prepare(self, state: CoreLearnerState, shards: Sequence[PPOTransition]):
        """(the normalised shards, the new statistics)."""
        shards, obs_stats = normalized_shards(shards, state.obs_stats, self.devices,
                                              self.normalize_obs)
        return maybe_normalize_rewards(shards, self.config, self.devices), obs_stats

    def _forward(self, params: ActorCriticParams, mb: PPOTransition):
        """One shard's leaf params, policy log-probs, values, bootstrap values,
        entropy and the V-trace inputs."""
        with torch.enable_grad():
            if self.shared:
                actor_params = critic_params = _leaf_copies(params.actor_params)
                leaves = actor_params
            else:
                actor_params = _leaf_copies(params.actor_params)
                critic_params = _leaf_copies(params.critic_params)
                leaves = {**{("a", k): v for k, v in actor_params.items()},
                          **{("c", k): v for k, v in critic_params.items()}}
            policy = self.actor_apply(actor_params, mb.obs)
            online_log_prob = policy.log_prob(mb.action)  # [T, e]
            values = self.critic_apply(critic_params, mb.obs)  # [T, e]
            bootstrap = self.critic_apply(critic_params, mb.next_obs)  # [T, e]
            entropy = policy.entropy().mean()
        rhos = torch.exp(online_log_prob.detach() - mb.log_prob)
        d_t = self.gamma * (1.0 - mb.done.to(torch.float32))
        vtrace_in = (values.detach(), bootstrap.detach(), mb.reward, d_t, rhos)
        return leaves, online_log_prob, values, entropy, rhos, vtrace_in

    def forward_and_vtrace(self, params: ActorCriticParams, batches: Sequence[PPOTransition]):
        """Every shard's forward (`_forward`) on its minibatch, and its V-trace
        (errors, policy-gradient advantages) from one call over the shards
        where they share a device."""
        forwards = [self._forward(place(params, d), mb)
                    for mb, d in zip(batches, self.devices)]
        inputs = [f[5] for f in forwards]
        if same_device(self.devices):
            # The shards' columns are independent: one V-trace call over all.
            groups = [tuple(_cat_shards(xs) for xs in zip(*inputs))]
        else:
            groups = inputs
        outs = [vtrace_td_error_and_advantage(*g, self.lam, self.clip_rho, self.clip_pg_rho,
                                              impl=self.multistep_impl)[:2] for g in groups]
        if same_device(self.devices):
            widths = [mb.reward.shape[1] for mb in batches]
            outs = list(zip(*(_split_shards(x, widths) for x in outs[0])))
        return forwards, outs

    @annotate("impala_minibatch")
    def minibatch(self, params: ActorCriticParams, opt_states: ActorCriticOptStates,
                  batches: Sequence[PPOTransition]):
        home = self.devices[0]
        forwards, outs = self.forward_and_vtrace(params, batches)
        grads, terms = [], []
        for (leaves, online_log_prob, values, entropy, rhos, _), (errors, pg_adv) in zip(
                forwards, outs):
            with torch.enable_grad():
                pg_loss = -torch.mean(pg_adv * online_log_prob)
                value_targets = (errors + values).detach()
                value_loss = 0.5 * torch.mean((values - value_targets) ** 2)
                total = pg_loss + self.vf_coef * value_loss - self.ent_coef * entropy
                flat = torch.autograd.grad(total, list(leaves.values()))
            grads.append(dict(zip(leaves, flat)))
            terms.append({"total": total.detach(), "actor_loss": pg_loss.detach(),
                          "value_loss": value_loss.detach(), "entropy": entropy.detach(),
                          "mean_rho": torch.mean(rhos)})
        grads = shard_sum(grads, home)
        metrics = shard_mean(terms, home)
        total_loss = metrics.pop("total")
        if self.shared:
            updates, actor_opt = self.actor_optim.update(grads, opt_states.actor_opt_state)
            shared = apply_updates(params.actor_params, updates)
            return (ActorCriticParams(shared, shared),
                    ActorCriticOptStates(actor_opt, opt_states.critic_opt_state), metrics)
        actor_grads = {k: g for (side, k), g in grads.items() if side == "a"}
        critic_grads = {k: g for (side, k), g in grads.items() if side == "c"}
        actor_updates, actor_opt = self.actor_optim.update(actor_grads, opt_states.actor_opt_state)
        critic_updates, critic_opt = self.critic_optim.update(critic_grads,
                                                              opt_states.critic_opt_state)
        new = (ActorCriticParams(apply_updates(params.actor_params, actor_updates),
                                 apply_updates(params.critic_params, critic_updates)),
               ActorCriticOptStates(actor_opt, critic_opt))
        if self.guard_mode != "off":
            new, guard_metrics = guards.guard_update(
                self.guard_mode, new=new, old=(params, opt_states), loss=total_loss,
                grads=(actor_grads, critic_grads))
            metrics.update(guard_metrics)
        return new[0], new[1], metrics

    def __call__(self, state: CoreLearnerState, shards: Sequence[PPOTransition]):
        shards, obs_stats = self.prepare(state, shards)
        per_shard = [split_env_minibatches(s, self.num_minibatches) for s in shards]
        params, opt_states = state.params, state.opt_states
        per_minibatch: List[Dict[str, torch.Tensor]] = []
        for batches in zip(*per_shard):
            params, opt_states, metrics = self.minibatch(params, opt_states, batches)
            per_minibatch.append(metrics)
        # skipped_updates is a count (the host sums it into the registry
        # counter); every other metric is the minibatches' mean.
        metrics = {k: (torch.stack([m[k] for m in per_minibatch]).sum() if k == "skipped_updates"
                       else torch.stack([m[k] for m in per_minibatch]).mean())
                   for k in per_minibatch[0]}
        return CoreLearnerState(params, opt_states, state.generator, obs_stats), metrics


def get_impala_learn_step(actor_apply, critic_apply, optims, config,
                          learner_devices) -> ImpalaLearnStep:
    return ImpalaLearnStep(actor_apply, critic_apply, optims, config, learner_devices)


def impala_refusals(config: Any) -> None:
    """Sebulba IMPALA reads every key of its system config."""


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return _run(config, device, learn_step_builder=get_impala_learn_step,
                refusals=impala_refusals)


def main() -> float:
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/sebulba/default_ff_impala.yaml", sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
