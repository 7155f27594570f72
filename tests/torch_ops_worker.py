"""One gloo rank of a two-process Anakin ff_ppo run with the integrity
sentinel on (tests/test_torch_integrity.py). Imports no JAX.

    python tests/torch_ops_worker.py RANK WORLD STORE_DIR OUT_JSON [OVERRIDES...]

Each rank runs twice in its own working directory's parent (STORE_DIR):
first a healthy run (its integrity and resilience stats go to OUT_JSON),
then the same run with `bitflip:1`, whose StateCorruptionError the
sentinel's excepthook turns into exit code 88.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from stoix_tpu_torch.resilience import faultinject
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.utils import config as config_lib


def main(rank: int, world: int, store_dir: str, out: str, overrides: list) -> None:
    torch.set_num_threads(1)
    os.chdir(store_dir)

    def run(uid: str, fault: str = None) -> float:
        cfg = config_lib.compose(config_lib.default_config_dir(),
                                 "default/anakin/default_ff_ppo.yaml", [
            *overrides, f"arch.distributed.coordinator_address=file://{store_dir}/pg_store",
            f"arch.distributed.num_processes={world}", f"arch.distributed.process_id={rank}",
            f"logger.checkpointing.save_args.checkpoint_uid={uid}",
            *([f"arch.fault_spec={fault}"] if fault else [])])
        return ff_ppo.run_experiment(cfg, device="cpu")

    final = run("healthy")
    with open(out, "w") as f:
        json.dump({"return": final, "integrity": runner.LAST_RUN_STATS["integrity"],
                   "resilience": runner.LAST_RUN_STATS["resilience"]}, f)
    faultinject.reset()
    run("flipped", "bitflip:1")  # exits 88 through the sentinel's excepthook


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5:])
