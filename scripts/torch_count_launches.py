#!/usr/bin/env python3
"""Predict the device launches of an Anakin ff_ppo (or ff_ppo_continuous)
env step, rollout and update step from the CPU: `torch.profiler` counts the
aten calls that would each launch a kernel on the card (the leaf calls, less
the ones that only make views or allocate), for the config's networks and env
at a small env count (the count of launches does not depend on it).

    python3 scripts/torch_count_launches.py [--system ff_ppo_continuous] [--envs 16] \
        [overrides ...]

e.g. `env=breakout_pixel_jax network=cnn_atari system.multistep_impl=pallas`,
or `--system ff_ppo_continuous env=ant system.multistep_impl=pallas`.
Calls that are one launch on the card and several on the CPU are counted as
one (`ONE_LAUNCH`): B1's plain GAE (a Python loop over T on the CPU), the
rigid-body engine's fused multiply-add (`fma_f32` in float64 on the CPU, one
`addcmul` on the card) and its square root (through float64 on the CPU). A
convolution or a matmul is counted as one launch, where cuDNN and cuBLAS may
take two or three. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from collections import Counter

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stoix_tpu_torch import envs  # noqa: E402
from stoix_tpu_torch.envs import rigid_body  # noqa: E402
from stoix_tpu_torch.kernels import linear_recurrence  # noqa: E402
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo, ff_ppo_continuous  # noqa: E402
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


# (module, function, label): one launch on the card, several calls on the CPU.
ONE_LAUNCH = ((linear_recurrence, "plain_truncated_gae", "b1_gae"),
              (rigid_body, "fused_multiply_add", "rigid_body_fma"),
              (rigid_body, "sqrt", "rigid_body_sqrt"))
SYSTEMS = {"ff_ppo": ff_ppo, "ff_ppo_continuous": ff_ppo_continuous}


def _is_launch(event) -> bool:
    return (event.name.startswith("aten::") and event.name not in NO_KERNEL
            and not any(c.name.startswith("aten::") for c in event.cpu_children))


def count(fn) -> dict:
    """The would-be launches of one call of `fn` (each ONE_LAUNCH region one
    launch), the most frequent, and the ONE_LAUNCH regions by label."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    events = list(prof.events())
    labels = {label for _, _, label in ONE_LAUNCH}
    regions = sorted((e for e in events if e.name in labels), key=lambda e: e.time_range.start)
    starts = [r.time_range.start for r in regions]

    def inside(event) -> bool:  # the regions run one after another
        i = bisect.bisect_right(starts, event.time_range.start) - 1
        return i >= 0 and event.time_range.start <= regions[i].time_range.end

    names = Counter(e.name for e in events if _is_launch(e) and not inside(e))
    names.update(r.name for r in regions)
    return {"launches": sum(names.values()), "top": names.most_common(12),
            "one_launch_regions": dict(Counter(r.name for r in regions))}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--system", default="ff_ppo", choices=sorted(SYSTEMS))
    parser.add_argument("--envs", type=int, default=16)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args()
    torch.set_num_threads(1)
    module = SYSTEMS[args.system]
    config = check_total_timesteps(config_lib.compose(
        config_lib.default_config_dir(), f"default/anakin/default_{args.system}.yaml",
        args.overrides + [f"arch.total_num_envs={args.envs}", "logger.use_console=False"]), 1)
    env, _ = envs.make(config)
    setup = module.learner_setup(env, config, torch.device("cpu"), int(config.arch.seed))
    learner = setup.learn
    state, _ = learner.update_step(setup.learner_state)  # warm-up
    originals = [(m, name, getattr(m, name)) for m, name, _ in ONE_LAUNCH]

    def as_one_launch(fn, label):
        def wrapped(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return wrapped

    for (m, name, fn), (_, _, label) in zip(originals, ONE_LAUNCH):
        setattr(m, name, as_one_launch(fn, label))
    try:
        action = env.action_value().expand((args.envs,) + tuple(env.action_value().shape))
        out = {"system": args.system, "overrides": args.overrides, "envs": args.envs,
               "env_step": count(lambda: learner.env.step(state.env_state, action)),
               "rollout": count(lambda: learner.rollout(state)),
               "update_step": count(lambda: learner.update_step(state))}
        out["gae_calls_an_update"] = out["update_step"]["one_launch_regions"].get("b1_gae", 0)
    finally:
        for m, name, fn in originals:
            setattr(m, name, fn)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
