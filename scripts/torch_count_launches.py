#!/usr/bin/env python3
"""Predict the device launches of an Anakin ff_ppo env step, rollout and
update step from the CPU: `torch.profiler` counts the aten calls that would
each launch a kernel on the card (the leaf calls, less the ones that only
make views or allocate), for the config's networks and env at a small env
count (the count of launches does not depend on it).

    python3 scripts/torch_count_launches.py [--envs 16] [overrides ...]

e.g. `env=breakout_pixel_jax network=cnn_atari system.multistep_impl=pallas`.
B1's plain GAE on the CPU is a Python loop over T; it is counted as the one
launch it is on the card. A convolution or a matmul is counted as one launch,
where cuDNN and cuBLAS may take two or three. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stoix_tpu_torch import envs  # noqa: E402
from stoix_tpu_torch.kernels import linear_recurrence  # noqa: E402
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo  # noqa: E402
from stoix_tpu_torch.utils import config as config_lib  # noqa: E402
from stoix_tpu_torch.utils.timestep_checker import check_total_timesteps  # noqa: E402

# aten calls that make a view, allocate or read metadata: no kernel on the card.
NO_KERNEL = {
    "aten::view", "aten::reshape", "aten::_reshape_alias", "aten::expand", "aten::permute",
    "aten::t", "aten::transpose", "aten::unsqueeze", "aten::squeeze", "aten::select",
    "aten::slice", "aten::as_strided", "aten::detach", "aten::detach_", "aten::alias",
    "aten::empty", "aten::empty_like", "aten::empty_strided", "aten::resize_", "aten::unbind",
    "aten::split", "aten::split_with_sizes", "aten::chunk", "aten::lift_fresh",
    "aten::result_type", "aten::contiguous", "aten::to", "aten::numpy_T", "aten::unflatten",
    "aten::flatten", "aten::view_as", "aten::expand_as", "aten::broadcast_tensors",
    "aten::is_nonzero", "aten::_unsafe_view", "aten::set_", "aten::resolve_conj",
    "aten::resolve_neg", "aten::narrow", "aten::movedim", "aten::size", "aten::stride",
}


def count(fn) -> dict:
    """The would-be launches of one call of `fn`, and the most frequent."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    events = [e for e in prof.events() if e.name.startswith("aten::")]
    leaves = [e for e in events if not any(c.name.startswith("aten::") for c in e.cpu_children)]
    names = Counter(e.name for e in leaves if e.name not in NO_KERNEL)
    return {"launches": sum(names.values()), "top": names.most_common(12)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--envs", type=int, default=16)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args()
    torch.set_num_threads(1)
    config = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), "default/anakin/default_ff_ppo.yaml",
        args.overrides + [f"arch.total_num_envs={args.envs}", "logger.use_console=False"]), 1)
    env, _ = envs.make(config)
    setup = ff_ppo.learner_setup(env, config, torch.device("cpu"), int(config.arch.seed))
    learner = setup.learn
    state, _ = learner.update_step(setup.learner_state)  # warm-up
    plain_gae = linear_recurrence.plain_truncated_gae

    def one_gae_launch(*a, **k):  # the card's one launch in place of the CPU's loop
        with torch.profiler.record_function("b1_gae"):
            return plain_gae(*a, **k)

    linear_recurrence.plain_truncated_gae = one_gae_launch
    try:
        action = torch.ones((args.envs,), dtype=torch.int64)
        out = {"overrides": args.overrides, "envs": args.envs,
               "env_step": count(lambda: learner.env.step(state.env_state, action)),
               "rollout": count(lambda: learner.rollout(state)),
               "update_step": count(lambda: learner.update_step(state))}
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            learner.update_step(state)
        gae = [e for e in prof.events() if e.name == "b1_gae"]
        inside = sum(1 for g in gae for e in prof.events() if e.name.startswith("aten::")
                     and g.time_range.start <= e.time_range.start <= g.time_range.end
                     and not any(c.name.startswith("aten::") for c in e.cpu_children)
                     and e.name not in NO_KERNEL)
        out["update_step"]["launches"] += len(gae) - inside
        out["gae_calls_an_update"] = len(gae)
    finally:
        linear_recurrence.plain_truncated_gae = plain_gae
    print(json.dumps(out))


if __name__ == "__main__":
    main()
