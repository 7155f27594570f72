#!/usr/bin/env python3
"""The port's initial weights at two torch intra-op thread counts
(ROADMAP C28): the default Anakin ff_ppo networks (CartPole, MLP 256x256)
built from one seed on the CPU, once at each thread count, leaf by leaf.

    python3 scripts/torch_init_threads.py [--threads 1 8] [--seed 0]

Prints one JSON line: the thread counts, the torch version, and each leaf
whose values differ with its largest absolute difference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from stoix_tpu_torch import envs  # noqa: E402
from stoix_tpu_torch.systems import anakin  # noqa: E402
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo  # noqa: E402
from stoix_tpu_torch.utils import config as config_lib  # noqa: E402


def initial_weights(config, seed: int, threads: int) -> dict:
    torch.set_num_threads(threads)
    env, _ = envs.make(config)
    config.system.action_dim = env.num_actions
    generator = anakin.make_generator(seed, torch.device("cpu"))
    actor, critic = ff_ppo.build_networks(env, config, generator)
    return {f"{side}/{k}": v.detach().clone()
            for side, net in (("actor", actor), ("critic", critic))
            for k, v in net.named_parameters()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--threads", type=int, nargs=2, default=[1, 8])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/anakin/default_ff_ppo.yaml", [])
    a, b = (initial_weights(config, args.seed, n) for n in args.threads)
    differing = {k: float((a[k] - b[k]).abs().max()) for k in a if not torch.equal(a[k], b[k])}
    print(json.dumps({"threads": args.threads, "seed": args.seed, "torch": torch.__version__,
                      "leaves": len(a), "differing": differing}))


if __name__ == "__main__":
    main()
