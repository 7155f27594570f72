"""Sebulba IMPALA with a shared torso (counterpart of
stoix_tpu/systems/impala/sebulba/ff_impala_shared_torso.py): ONE network, a
torso under a PolicyValueHead, serves both the policy and the value.

It runs as two views over the same module (`SharedView`): the actor view
returns the distribution, the critic view the value, and both views' params
are the same tensors (flax's `net/...` tree, kept as `net.*`). The V-trace
loss of ff_impala.py updates them once through the actor's optimizer; both
param slots stay equal and the critic's optimizer state is carried as it is.
This learner has no divergence guard, as in the JAX package, so
`system.update_guard` is refused (ROADMAP C24).
"""

from __future__ import annotations

import sys
from typing import Any, Union

import torch
from torch import nn

from stoix_tpu_torch.resilience import guards
from stoix_tpu_torch.systems import anakin
from stoix_tpu_torch.systems.impala.sebulba.ff_impala import ImpalaLearnStep
from stoix_tpu_torch.systems.ppo.sebulba.ff_ppo import run_experiment as _run
from stoix_tpu_torch.utils import config as config_lib


class SharedView(nn.Module):
    """A view over a shared actor-critic module selecting one of its two
    outputs (0: the distribution, 1: the value)."""

    def __init__(self, net: nn.Module, index: int):
        super().__init__()
        self.net = net
        self.index = int(index)

    def forward(self, observation: Any) -> Any:
        return self.net(observation)[self.index]


def build_shared_networks(config: Any, env: Any, generator: torch.Generator):
    """(actor view, critic view) over one FeedForwardActorCritic: the
    network config's actor torso and input layer, a Categorical head and a
    scalar critic head; the weights draw from `generator`, torso first."""
    from stoix_tpu_torch.networks.base import FeedForwardActorCritic
    from stoix_tpu_torch.networks.heads import CategoricalHead, PolicyValueHead, ScalarCriticHead

    net_cfg = config.network.actor_network
    input_layer = config_lib.instantiate(net_cfg.input_layer)
    torso = config_lib.instantiate(
        net_cfg.pre_torso, generator=generator,
        **anakin.torso_input_kwargs(net_cfg.pre_torso, input_layer(env.observation_value())))
    shared = FeedForwardActorCritic(
        shared_head=PolicyValueHead(
            action_head=CategoricalHead(env.num_actions, torso.output_dim, generator),
            critic_head=ScalarCriticHead(torso.output_dim, generator)),
        torso=torso, input_layer=input_layer)
    return SharedView(shared, 0), SharedView(shared, 1)


def get_shared_impala_learn_step(actor_apply, critic_apply, optims, config,
                                 learner_devices) -> ImpalaLearnStep:
    return ImpalaLearnStep(actor_apply, critic_apply, optims, config, learner_devices,
                           shared=True)


def shared_refusals(config: Any) -> None:
    """ROADMAP C24: the JAX shared-torso learner has no guard, so it never
    reads `system.update_guard`."""
    mode = guards.resolve_mode(config)
    if mode != "off":
        raise NotImplementedError(
            f"system.update_guard={mode}: the JAX package's Sebulba ff_impala_shared_torso "
            "never reads it (ROADMAP C24)")


def run_experiment(config: Any, device: Union[str, torch.device] = "cuda") -> float:
    return _run(config, device, learn_step_builder=get_shared_impala_learn_step,
                networks_builder=build_shared_networks, refusals=shared_refusals)


def main() -> float:
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/sebulba/default_ff_impala_shared_torso.yaml",
                                sys.argv[1:])
    return run_experiment(config)


if __name__ == "__main__":
    main()
