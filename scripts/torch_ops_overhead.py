#!/usr/bin/env python3
"""What the operations layer costs on Anakin ff_ppo's main path, on one CUDA
card at the default config's full width (CartPole, 1024 envs, T=16, 4 epochs
x 4 minibatches, MLP 256x256, multistep_impl=pallas, update_guard=skip, a
checkpoint every window).

    python3 scripts/torch_ops_overhead.py [--rounds 3] [--windows 4] \
        [--updates-per-window 10] [--out PATH]

Three arms, run in one process, each round in the reverse order of the one
before (off, on, probe; probe, on, off; ...), after one discarded run that
builds the kernels:

  off    every switch of the operations layer off;
  on     preflight (the probe child, the watchdogs, the memory gate),
         integrity (fingerprints every window), telemetry;
  probe  as on, with the determinism probe every window (it replays window
         0 before every later window).

Per arm, over every window but window 0 of every run: the runner's learn
env-steps/s (`LAST_RUN_STATS["steps_per_second"]`: the learn dispatch to its
device synchronize) and the loop's seconds a window (between the flight
recorder's consecutive "window" events: learn, probe, fingerprints,
evaluation, log and checkpoint), each as median, min and max; and each run's
wall seconds (set-up included). Every run's final state must be bitwise the
first run's. Prints one JSON object, with the card's `nvidia-smi` name and
power limit, and writes it to --out (default
results/torch_ops_overhead.json).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stoix_tpu_torch.observability import flightrec  # noqa: E402
from stoix_tpu_torch.systems import runner  # noqa: E402
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo  # noqa: E402
from stoix_tpu_torch.utils import checkpointing  # noqa: E402
from stoix_tpu_torch.utils import config as config_lib  # noqa: E402

ON = ["arch.preflight.enabled=true", "arch.integrity.enabled=true",
      "logger.telemetry.enabled=true"]
ARMS = {"off": [], "on": ON, "probe": ON + ["arch.integrity.determinism_probe_interval=1"]}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def run(uid: str, extra: list, windows: int, per_window: int) -> dict:
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/anakin/default_ff_ppo.yaml", [
        f"arch.num_updates={windows * per_window}", f"arch.num_evaluation={windows}",
        "arch.num_eval_episodes=16", "system.multistep_impl=pallas",
        "system.update_guard=skip", "logger.use_console=False",
        "logger.checkpointing.save_model=true", "logger.checkpointing.save_args.max_to_keep=~",
        f"logger.checkpointing.save_args.checkpoint_uid={uid}",
        f"logger.base_exp_path={os.getcwd()}/results_{uid}", *extra])
    start = time.perf_counter()
    ff_ppo.run_experiment(config, device="cuda")
    seconds = time.perf_counter() - start
    stats = runner.LAST_RUN_STATS
    marks = [e["unix_time"] for e in flightrec.get_flight_recorder().events()
             if e["kind"] == "window"]
    final = windows * per_window * 16 * 1024
    state = torch.load(os.path.join("checkpoints", uid, "ff_ppo", str(final),
                                    checkpointing.STATE_FILE), weights_only=True)
    return {"learn_sps": list(stats["steps_per_second"][1:]),
            "loop_s": [b - a for a, b in zip(marks, marks[1:])],
            "run_s": seconds, "state": state,
            "probe_runs": stats["integrity"]["probe_runs"] if stats["integrity"]["enabled"]
            else 0}


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(v, b[k]) if isinstance(v, torch.Tensor) else
        torch.equal(v["generator_state"], b[k]["generator_state"]) if isinstance(v, dict)
        else v == b[k] for k, v in a.items())


def summary(values: list) -> dict:
    return {"median": statistics.median(values), "min": min(values), "max": max(values),
            "n": len(values)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--windows", type=int, default=4)
    parser.add_argument("--updates-per-window", type=int, default=10)
    parser.add_argument("--out", default="results/torch_ops_overhead.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = os.path.abspath(args.out)
    smi = card()
    samples = {arm: {"learn_sps": [], "loop_s": [], "run_s": [], "probe_runs": []}
               for arm in ARMS}
    order = []
    with tempfile.TemporaryDirectory(prefix="ops_overhead_") as tmp, contextlib.chdir(tmp):
        run("warm", [], 1, 1)  # builds the kernels; discarded
        reference = None
        arms = list(ARMS)
        for round_idx in range(args.rounds):
            for arm in (arms if round_idx % 2 == 0 else arms[::-1]):
                uid = f"{arm}{round_idx}"
                got = run(uid, ARMS[arm], args.windows, args.updates_per_window)
                if reference is None:
                    reference = got["state"]
                elif not same(got["state"], reference):
                    raise AssertionError(f"{uid}: final state differs from the first run's")
                for key in ("learn_sps", "loop_s"):
                    samples[arm][key].extend(got[key])
                samples[arm]["run_s"].append(got["run_s"])
                samples[arm]["probe_runs"].append(got["probe_runs"])
                order.append(uid)
    record = {
        "script": "scripts/torch_ops_overhead.py", "card": smi, "order": order,
        "windows": args.windows, "updates_per_window": args.updates_per_window,
        "env_steps_per_window": args.updates_per_window * 16 * 1024,
        "final_states_bitwise_equal": True,
        "arms": {arm: {"learn_env_steps_per_s": summary(s["learn_sps"]),
                       "loop_s_per_window": summary(s["loop_s"]),
                       "run_s": summary(s["run_s"]), "probe_runs": s["probe_runs"],
                       "raw": {k: s[k] for k in ("learn_sps", "loop_s", "run_s")}}
                 for arm, s in samples.items()}}
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k != "arms"}))
    print(json.dumps({arm: {k: v for k, v in a.items() if k != "raw"}
                      for arm, a in record["arms"].items()}))


if __name__ == "__main__":
    main()
