"""One gloo rank of the fleet drills of the PyTorch port (tests/test_torch_fleet.py,
tests/test_torch_elastic.py). Imports no JAX.

    python tests/torch_fleet_worker.py RANK WORLD DIR OUT JOB[,JOB...]

Each job runs in DIR with a `file://` store of its own (the process group is
formed anew for it), and its record joins OUT (JSON, rewritten after every
job). The jobs, at the resilience tests' tiny ff_ppo (identity_game, 8 envs
over the ranks, 2 updates a window):

  sigterm      fleet and HTTP on; rank 1 under `sigterm:0`: both ranks stop
               at window 1 and save.
  gossip       the same over two gossip learner groups (`arch.mesh.group=2`):
               the flag rides the episode gather over every group's rank.
  sebulba      Sebulba ff_ppo with the fleet on; rank 1 sends itself SIGTERM
               at window 1's vote: both stop at window 2.
  restore_1to2 the one-process store under DIR/one_rank restored over two
               ranks (the state the first learn step receives goes to
               OUT.restore_1to2.RANK.pt) and trained one window.
  shrink       fleet on, `shrink:0`: exit 89 with the resize request (last).
  host_loss    fleet on with short deadlines, rank 1 under `host_loss:2`:
               rank 1 freezes, rank 0 exits 87 (last).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

from stoix_tpu_torch.resilience import faultinject, fleet
from stoix_tpu_torch.systems import runner
from stoix_tpu_torch.systems.ppo.anakin import ff_ppo
from stoix_tpu_torch.systems.ppo.sebulba import ff_ppo as sebulba_ppo
from stoix_tpu_torch.utils import config as config_lib

ANAKIN_ROOT = "default/anakin/default_ff_ppo.yaml"
SEBULBA_ROOT = "default/sebulba/default_ff_ppo.yaml"
GOSSIP_ROOT = "default/gossip/default_ff_ppo.yaml"
WINDOW = 2 * 4 * 8  # env steps a window: 2 updates of 4 steps x 8 envs
TINY = ["env=identity_game", "arch.total_num_envs=8", "arch.num_updates_per_eval=2",
        "arch.num_eval_episodes=4", "arch.absolute_metric=False", "system.rollout_length=4",
        "system.epochs=1", "system.num_minibatches=2", "logger.use_console=False",
        "system.multistep_impl=pallas"]
SEBULBA_TINY = ["env=identity_game", "arch.total_num_envs=8", "arch.total_timesteps=3072",
                "arch.num_evaluation=3", "arch.num_eval_episodes=4", "system.rollout_length=8",
                "logger.use_console=False", "arch.actor.device_ids=[0]",
                "arch.learner.device_ids=[0]", "arch.evaluator_device_id=0"]
# The fleet with deadlines no healthy CPU run comes near; host_loss's own are short.
FLEET = ["arch.fleet.enabled=true", "arch.fleet.heartbeat_interval_s=0.5",
         "arch.fleet.heartbeat_timeout_s=60", "arch.fleet.monitor_poll_s=0.5",
         "arch.fleet.exit_grace_s=5", "arch.fleet.barrier_deadline_s=60"]
SHORT_DEADLINES = ["arch.fleet.heartbeat_timeout_s=3", "arch.fleet.monitor_poll_s=0.5",
                   "arch.fleet.exit_grace_s=2"]
SAVE = ["logger.checkpointing.save_model=true", "logger.checkpointing.save_args.max_to_keep=~"]


def anakin_config(windows: int, extra: list, root: str = ANAKIN_ROOT):
    return config_lib.compose(config_lib.default_config_dir(), root, TINY + list(extra) + [
        f"arch.num_evaluation={windows}", f"arch.total_timesteps={windows * WINDOW}"])


def run_capturing_first_state(config):
    """ff_ppo through the runner on the CPU; returns (final return, the
    state the first learn step received, i.e. the restored one)."""
    captured = []

    def setup(env, cfg, device, seed):
        built = ff_ppo.learner_setup(env, cfg, device, seed)
        learn = built.learn

        def capturing_learn(state):
            if not captured:
                captured.append(state)
            return learn(state)

        return built._replace(learn=capturing_learn)

    final = runner.run_anakin_experiment(config, setup, "cpu", outer_axes=("group",))
    return final, captured[0]


def replicated_leaves(state) -> dict:
    from stoix_tpu_torch.utils.checkpointing import flatten_state

    return {"/".join(p): leaf.clone() for p, leaf in flatten_state(state)
            if p[0] in ("params", "opt_states", "obs_stats", "kl_beta")
            and isinstance(leaf, torch.Tensor)}


def job(name: str, rank: int, world: int, root: str, out: str) -> dict:
    dist_keys = [f"arch.distributed.coordinator_address=file://{root}/store_{name}",
                 f"arch.distributed.num_processes={world}", f"arch.distributed.process_id={rank}"]
    if name == "sigterm":
        fault = ["arch.fault_spec=sigterm:0"] if rank == 1 else []
        config = anakin_config(3, FLEET + SAVE + dist_keys + fault + [
            "logger.checkpointing.save_args.checkpoint_uid=fleet_sigterm",
            "logger.telemetry.http.enabled=true", "logger.telemetry.http.aggregate_interval_s=0.5",
            f"arch.fleet.emergency_dir={root}/emergency_sigterm"])
        ff_ppo.run_experiment(config, device="cpu")
        stats = runner.LAST_RUN_STATS
        return {"windows": len(stats["window_seconds"]), "resilience": stats["resilience"],
                "rescue": stats["fleet_rescue"]}
    if name == "gossip":
        fault = ["arch.fault_spec=sigterm:0"] if rank == 1 else []
        config = anakin_config(3, FLEET + dist_keys + fault + ["arch.mesh.group=2"],
                               root=GOSSIP_ROOT)
        ff_ppo.run_experiment(config, device="cpu")
        stats = runner.LAST_RUN_STATS
        return {"windows": len(stats["window_seconds"]), "resilience": stats["resilience"],
                "gossip_rounds": stats["gossip"]["rounds"]}
    if name == "sebulba":
        if rank == 1:
            agree = fleet.FleetCoordinator.agree_at_window

            def agree_after_sigterm(self, window_idx, timeout_s=None):
                if window_idx == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                    time.sleep(0.2)  # the handler runs at the next bytecode
                return agree(self, window_idx, timeout_s)

            fleet.FleetCoordinator.agree_at_window = agree_after_sigterm
        config = config_lib.compose(config_lib.default_config_dir(), SEBULBA_ROOT,
                                    SEBULBA_TINY + FLEET + dist_keys)
        sebulba_ppo.run_experiment(config, device="cpu")
        stats = sebulba_ppo.LAST_RUN_STATS
        return {"learn_steps": stats["learn_steps"], "decisions": stats["fleet_decisions"],
                "resilience": stats["resilience"]}
    if name == "restore_1to2":
        config = anakin_config(1, SAVE + dist_keys + [
            "logger.checkpointing.load_model=true",
            f"logger.checkpointing.load_args.load_path={root}/one_rank/checkpoints",
            "logger.checkpointing.load_args.checkpoint_uid=one",
            "logger.checkpointing.save_args.checkpoint_uid=two"])
        _, state = run_capturing_first_state(config)
        torch.save(replicated_leaves(state), f"{out}.restore_1to2.{rank}.pt")
        return {"resilience": runner.LAST_RUN_STATS["resilience"]}
    if name == "shrink":
        config = anakin_config(3, FLEET + SAVE + dist_keys + [
            "arch.fault_spec=shrink:0", "logger.checkpointing.save_args.checkpoint_uid=shrink",
            f"arch.fleet.emergency_dir={root}/emergency_shrink/r{rank}"])
        ff_ppo.run_experiment(config, device="cpu")
        raise AssertionError("shrink:0 returned")
    if name == "host_loss":
        fault = ["arch.fault_spec=host_loss:2"] if rank == 1 else []
        config = anakin_config(4, FLEET + SHORT_DEADLINES + dist_keys + fault + [
            f"arch.fleet.emergency_dir={root}/emergency_loss"])
        ff_ppo.run_experiment(config, device="cpu")
        raise AssertionError("host_loss:2 returned")
    raise ValueError(f"unknown job {name!r}")


def main(rank: int, world: int, root: str, out: str, jobs: list) -> None:
    torch.set_num_threads(1)
    os.chdir(root)
    record = {}
    for name in jobs:
        if dist.is_initialized():
            dist.destroy_process_group()
        faultinject.reset()
        record[name] = job(name, rank, world, root, out)
        with open(out, "w") as f:
            json.dump(record, f)
    if dist.is_initialized():
        dist.destroy_process_group()



# ---------------------------------------------------------------- the tests' side


def spawn(root: str, jobs: str, world: int = 2) -> list:
    """Start the ranks of `jobs` in `root` (this module as a script, no JAX
    in them), each in a session of its own, so a rank that host_loss stops
    is never a stopped member of the caller's process group; returns
    [(process, log path), ...] in rank order."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               STOIX_TPU_FAULT="")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    ranks = []
    for rank in range(world):
        log = os.path.join(root, f"rank{rank}.log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank), str(world), root,
                 os.path.join(root, f"out{rank}.json"), jobs],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=repo, start_new_session=True)
        ranks.append((proc, log))
    return ranks


def stopped(pid: int) -> bool:
    """Whether process `pid` is stopped (SIGSTOP)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] == "T"
    except OSError:
        return False


def finish(ranks: list, timeout: float) -> list:
    """Each rank's exit code once all exit (or `timeout` passes: the rest are
    killed, a stopped one included), and their logs."""
    deadline = time.monotonic() + timeout
    for proc, _ in ranks:
        try:
            proc.wait(timeout=max(0.1, deadline - time.monotonic()))
        except Exception:  # noqa: BLE001 -- killed below, its code reports it
            pass
    for proc, _ in ranks:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return [proc.returncode for proc, _ in ranks], [open(log).read() for _, log in ranks]


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5].split(","))
