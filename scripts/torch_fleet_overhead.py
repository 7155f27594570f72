#!/usr/bin/env python3
"""What the fleet layer and the HTTP ops plane cost on Anakin ff_ppo's main
path, over two gloo ranks on one CUDA card at the default config's full
width (CartPole, 1024 envs over the ranks, T=16, 4 epochs x 4 minibatches,
MLP 256x256, multistep_impl=pallas, a checkpoint every window).

    python3 scripts/torch_fleet_overhead.py [--rounds 3] [--windows 4] \
        [--updates-per-window 10] [--out PATH]

Two arms, both ranks running them in the same order, each round in the
reverse order of the one before (off, on; on, off; ...), after one
discarded run that builds the kernels; every run forms a fresh gloo group
on a TCP store of its own:

  off    the fleet and the HTTP ops plane off;
  on     `arch.fleet.enabled` (heartbeats, the flag and wall in the
         window's gather, the rescue snapshot's host copy a window) and
         `logger.telemetry.http.enabled` (the ops server and the fleet
         aggregator).

Per arm, over every window but window 0 of every run and both ranks: the
runner's learn env-steps/s (`LAST_RUN_STATS["steps_per_second"]`) and the
loop's seconds a window (the flight recorder's consecutive "window"
events), each as median, min and max; each run's wall seconds; and, on,
the host copy's device ms a window. Every run's final state must be
bitwise the first run's, rank by rank. Prints one JSON object with the
card's `nvidia-smi` name and power limit, and writes it to --out (default
results/torch_fleet_overhead.json).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.torch_ops_overhead import card, same, summary  # noqa: E402
from stoix_tpu_torch.observability import flightrec  # noqa: E402
from stoix_tpu_torch.systems import runner  # noqa: E402
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo  # noqa: E402
from stoix_tpu_torch.utils import checkpointing  # noqa: E402
from stoix_tpu_torch.utils import config as config_lib  # noqa: E402

RANKS = 2
ON = ["arch.fleet.enabled=true", "arch.fleet.heartbeat_interval_s=0.5",
      "arch.fleet.heartbeat_timeout_s=60", "arch.fleet.monitor_poll_s=0.5",
      "arch.fleet.exit_grace_s=5", "logger.telemetry.http.enabled=true",
      "logger.telemetry.http.aggregate_interval_s=0.5"]
ARMS = {"off": [], "on": ON}


def free_port() -> int:
    with contextlib.closing(socket.socket()) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def group(port: int, rank: int) -> list:
    """A fresh gloo group of the two ranks on a TCP store at `port`; the
    overrides naming it, which the fleet's store reads."""
    if dist.is_initialized():
        dist.destroy_process_group()
    address = f"tcp://127.0.0.1:{port}"
    dist.init_process_group("gloo", init_method=address, world_size=RANKS, rank=rank)
    return [f"arch.distributed.coordinator_address={address}",
            f"arch.distributed.num_processes={RANKS}", f"arch.distributed.process_id={rank}"]


def run(uid: str, extra: list, windows: int, per_window: int, rank: int) -> dict:
    config = config_lib.compose(config_lib.default_config_dir(),
                                "default/anakin/default_ff_ppo.yaml", [
        f"arch.num_updates={windows * per_window}", f"arch.num_evaluation={windows}",
        "arch.num_eval_episodes=16", "system.multistep_impl=pallas",
        "logger.use_console=False", "logger.checkpointing.save_model=true",
        "logger.checkpointing.save_args.max_to_keep=~",
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
                                    checkpointing.state_file(rank, RANKS)), weights_only=True)
    return {"learn_sps": list(stats["steps_per_second"][1:]),
            "loop_s": [b - a for a, b in zip(marks, marks[1:])], "run_s": seconds,
            "copy_ms": list((stats.get("fleet_rescue") or {}).get("copy_ms") or [])[1:],
            "state": state}


def rank_main(args) -> None:
    """One rank: the warm run, then every round's arms; its samples to
    OUT{rank}.json in the working directory."""
    torch.cuda.set_device(0)
    os.chdir(args.tmp)
    ports = iter(int(p) for p in args.ports.split(","))
    samples = {arm: {"learn_sps": [], "loop_s": [], "run_s": [], "copy_ms": []} for arm in ARMS}
    order = []
    run("warm", group(next(ports), args.rank), 1, 1, args.rank)  # builds the kernels
    reference = None
    arms = list(ARMS)
    for round_idx in range(args.rounds):
        for arm in (arms if round_idx % 2 == 0 else arms[::-1]):
            uid = f"{arm}{round_idx}"
            got = run(uid, group(next(ports), args.rank) + ARMS[arm], args.windows,
                      args.updates_per_window, args.rank)
            if reference is None:
                reference = got["state"]
            elif not same(got["state"], reference):
                raise AssertionError(f"rank {args.rank}, {uid}: final state differs from the "
                                     "first run's")
            for key in ("learn_sps", "loop_s", "copy_ms"):
                samples[arm][key].extend(got[key])
            samples[arm]["run_s"].append(got["run_s"])
            order.append(uid)
    dist.destroy_process_group()
    with open(f"out{args.rank}.json", "w") as f:
        json.dump({"samples": samples, "order": order}, f)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--windows", type=int, default=4)
    parser.add_argument("--updates-per-window", type=int, default=10)
    parser.add_argument("--out", default="results/torch_fleet_overhead.json")
    parser.add_argument("--timeout", type=float, default=800.0)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--tmp", help=argparse.SUPPRESS)
    parser.add_argument("--ports", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.rank is not None:
        rank_main(args)
        return
    out = os.path.abspath(args.out)
    smi = card()
    ports = ",".join(str(free_port()) for _ in range(1 + 2 * args.rounds))
    with tempfile.TemporaryDirectory(prefix="fleet_overhead_") as tmp:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   "--tmp", tmp, "--ports", ports, "--rounds", str(args.rounds),
                                   "--windows", str(args.windows), "--updates-per-window",
                                   str(args.updates_per_window)]) for r in range(RANKS)]
        deadline = time.monotonic() + args.timeout
        try:
            for proc in procs:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if any(proc.returncode for proc in procs):
            raise SystemExit(f"ranks exited {[proc.returncode for proc in procs]}")
        ranks = [json.load(open(os.path.join(tmp, f"out{r}.json"))) for r in range(RANKS)]
    pooled = {arm: {key: [v for r in ranks for v in r["samples"][arm][key]]
                    for key in ("learn_sps", "loop_s", "run_s", "copy_ms")} for arm in ARMS}
    record = {
        "script": "scripts/torch_fleet_overhead.py", "card": smi, "ranks": RANKS,
        "order": ranks[0]["order"], "windows": args.windows,
        "updates_per_window": args.updates_per_window,
        "env_steps_per_window": args.updates_per_window * 16 * 1024,
        "final_states_bitwise_equal": True,
        "arms": {arm: {"learn_env_steps_per_s": summary(s["learn_sps"]),
                       "loop_s_per_window": summary(s["loop_s"]),
                       "run_s": summary(s["run_s"]),
                       "host_copy_ms": summary(s["copy_ms"]) if s["copy_ms"] else None,
                       "raw": {r: ranks[r]["samples"][arm] for r in range(RANKS)}}
                 for arm, s in pooled.items()}}
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k != "arms"}))
    print(json.dumps({arm: {k: v for k, v in a.items() if k != "raw"}
                      for arm, a in record["arms"].items()}))


if __name__ == "__main__":
    main()
