"""Checkpointing of the learner state with `torch.save` and `torch.load`
(counterpart of stoix_tpu/utils/checkpointing.py's Checkpointer and
`checkpointer_from_config`).

The JAX package's directory layout and keys: a store is
`<rel_dir>/<checkpoint_uid>/<model_name>/` (the uid a time stamp when the
config names none) with one directory a saved step, `<step>/state.pt` and
`<step>/metrics.json`, and the config with `checkpointer_version` in
`metadata.json`. The save policy is orbax's as the JAX package configures it:
a step is saved when the store is empty or the step is a multiple of
`save_interval_steps`; a save then keeps the `max_to_keep` steps with the
best episode return (all when None, ties to the newer step) and every step
that is a multiple of `keep_period`.

What is saved is the whole learner state, by its tree paths: every tensor
(params, optimizer moments, observation statistics, β, env state, timestep)
as a CPU copy, every plain value (the optimizer's host step count), and the
state of every `torch.Generator` it holds, CUDA generators included, so a run
restored from step t continues bit for bit as the unbroken run did. A restore
fills a freshly built state of the same structure (the template): tensors
are checked for shape and dtype and moved to the template's device, and each
generator takes its saved state in place. Files are written to a temporary
name and renamed, so a store never holds half a step.

Over N data-parallel processes each rank's state holds its own leaves (env
state, timestep, generators, buffers) beside replicated ones, so each rank
writes its whole state to `<step>/state.<rank>-of-<N>.pt` (one process
keeps `state.pt`), in a store that every rank sees (one host, or a shared
file system). The coordinator alone writes the metadata; after a barrier
it alone writes `metrics.json` and prunes, and a second barrier holds every rank until it is
done, so each rank's next save decision reads the same store. A restore
reads the rank's own file; a step saved by another number of processes
raises, naming both counts.

Not ported (ROADMAP A19): the fleet's emergency stores (a `load_path` that
names one raises, naming `arch.fleet`), topology-elastic re-placement, the
per-leaf digests and the fallback walk past a corrupt step.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

# 3.0 is the JAX package's (PPOLearnerState carries kl_beta). A major version
# that differs refuses to restore.
CHECKPOINTER_VERSION = 3.0
STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
METADATA_FILE = "metadata.json"
FLEET_MANIFEST = "fleet_manifest.json"  # stoix_tpu/resilience/fleet.py::MANIFEST_NAME

Path = Tuple[str, ...]


def state_file(rank: int, world: int) -> str:
    """The file of rank `rank`'s state in a step saved by `world` processes."""
    return STATE_FILE if world == 1 else f"state.{rank}-of-{world}.pt"


def saved_world(step_dir: str) -> Optional[int]:
    """How many processes saved the complete step in `step_dir`; None when
    it is incomplete. One process renames `state.pt` into place last; several
    write `metrics.json` last, after every rank's file."""
    if os.path.isfile(os.path.join(step_dir, STATE_FILE)):
        return 1
    if not os.path.isfile(os.path.join(step_dir, METRICS_FILE)):
        return None
    counts = {int(name.split("-of-")[1][:-len(".pt")]) for name in os.listdir(step_dir)
              if name.startswith("state.") and name.endswith(".pt") and "-of-" in name}
    return counts.pop() if len(counts) == 1 else None


def _children(tree: Any) -> Optional[Iterator[Tuple[str, Any]]]:
    if hasattr(tree, "_fields"):
        return ((name, getattr(tree, name)) for name in tree._fields)
    if isinstance(tree, dict):
        return ((str(key), value) for key, value in tree.items())
    if isinstance(tree, (list, tuple)):
        return ((str(i), value) for i, value in enumerate(tree))
    return None


def flatten_state(tree: Any, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) for every leaf: tensors, generators and plain values."""
    children = None if isinstance(tree, (torch.Tensor, torch.Generator)) else _children(tree)
    if children is None:
        yield prefix, tree
        return
    for name, child in children:
        yield from flatten_state(child, prefix + (name,))


def _saveable(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().clone()
    if isinstance(leaf, torch.Generator):
        return {"generator_state": leaf.get_state()}
    return leaf


def is_fleet_store(path: Any) -> bool:
    """Whether `path` holds a fleet emergency store (its manifest, or
    per-survivor `p<N>/` subdirectories holding one)."""
    if not path or not os.path.isdir(str(path)):
        return False
    if os.path.isfile(os.path.join(str(path), FLEET_MANIFEST)):
        return True
    return any(os.path.isfile(os.path.join(str(path), entry, FLEET_MANIFEST))
               for entry in os.listdir(str(path)))


class Checkpointer:
    def __init__(
        self,
        model_name: str,
        metadata: Optional[dict] = None,
        rel_dir: str = "checkpoints",
        checkpoint_uid: Optional[str] = None,
        save_interval_steps: int = 1,
        max_to_keep: Optional[int] = 1,
        keep_period: Optional[int] = None,
    ):
        uid = checkpoint_uid if checkpoint_uid is not None else time.strftime("%Y%m%d%H%M%S")
        self.directory = os.path.abspath(os.path.join(rel_dir, str(uid), model_name))
        self._save_interval_steps = int(save_interval_steps)
        self._max_to_keep = None if max_to_keep is None else int(max_to_keep)
        self._keep_period = None if keep_period is None else int(keep_period)
        self._metadata = dict(metadata or {})
        self._metadata["checkpointer_version"] = CHECKPOINTER_VERSION
        initialized = dist.is_available() and dist.is_initialized()
        self._rank = dist.get_rank() if initialized else 0
        self._world = dist.get_world_size() if initialized else 1

    # ------------------------------------------------------------ the store

    def all_steps(self) -> List[int]:
        """Ascending steps with a complete checkpoint on disk."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and saved_world(os.path.join(self.directory, name)) is not None)

    def get_metadata(self) -> dict:
        with open(os.path.join(self.directory, METADATA_FILE)) as f:
            return json.load(f)

    def check_version(self) -> None:
        saved = float(self.get_metadata().get("checkpointer_version", CHECKPOINTER_VERSION))
        if int(saved) != int(CHECKPOINTER_VERSION):
            raise ValueError(
                f"Checkpoint major version {saved} incompatible with {CHECKPOINTER_VERSION}")

    def should_save(self, timestep: int) -> bool:
        """Whether a save at `timestep` is taken: the store's first, or a
        multiple of `save_interval_steps`."""
        return not self.all_steps() or int(timestep) % self._save_interval_steps == 0

    def _episode_return(self, step: int) -> float:
        with open(os.path.join(self.directory, str(step), METRICS_FILE)) as f:
            return float(json.load(f)["episode_return"])

    def _prune(self) -> None:
        steps = self.all_steps()
        keep = set()
        if self._max_to_keep is None:
            keep.update(steps)
        else:
            ranked = sorted(steps, key=lambda step: (self._episode_return(step), step))
            keep.update(ranked[len(ranked) - self._max_to_keep:] if self._max_to_keep else [])
        if self._keep_period:
            keep.update(step for step in steps if step % self._keep_period == 0)
        for step in steps:
            if step not in keep:
                step_dir = os.path.join(self.directory, str(step))
                for name in os.listdir(step_dir):
                    os.unlink(os.path.join(step_dir, name))
                os.rmdir(step_dir)

    # ------------------------------------------------------------ save and restore

    def save(self, timestep: int, state: Any, episode_return: float = 0.0,
             force: bool = False) -> bool:
        """Write `state` as step `timestep` when the policy takes it (always
        with `force`); returns whether it was written. Synchronous: the files
        are complete on return. Over several processes every rank calls it
        with its own state and the same `episode_return`."""
        if not force and not self.should_save(timestep):
            return False
        step_dir = os.path.join(self.directory, str(int(timestep)))
        os.makedirs(step_dir, exist_ok=True)
        metadata_path = os.path.join(self.directory, METADATA_FILE)
        if self._rank == 0 and not os.path.exists(metadata_path):
            _write_json(metadata_path, self._metadata)
        payload = {"/".join(path): _saveable(leaf) for path, leaf in flatten_state(state)}
        name = state_file(self._rank, self._world)
        tmp = os.path.join(step_dir, name + ".tmp")
        torch.save(payload, tmp)
        metrics = {"episode_return": float(episode_return), "step": int(timestep)}
        if self._world == 1:
            _write_json(os.path.join(step_dir, METRICS_FILE), metrics)
            os.replace(tmp, os.path.join(step_dir, STATE_FILE))
            self._prune()
            return True
        os.replace(tmp, os.path.join(step_dir, name))
        dist.barrier()  # every rank's file is in place
        if self._rank == 0:
            _write_json(os.path.join(step_dir, METRICS_FILE), metrics)
            self._prune()
        dist.barrier()  # the store is whole again before any rank reads it
        return True

    def restore(self, template: Any, timestep: Optional[int] = None) -> Tuple[Any, int]:
        """The saved state at `timestep` (the latest when None) in the
        structure of `template`; returns (state, step). Generators in the
        template take their saved states in place."""
        steps = self.all_steps()
        if timestep is not None:
            if int(timestep) not in steps:
                raise FileNotFoundError(
                    f"No checkpoint at timestep {timestep} under {self.directory}; "
                    f"available steps: {steps or '[]'}")
            step = int(timestep)
        elif steps:
            step = steps[-1]
        else:
            raise FileNotFoundError(f"No checkpoints under {self.directory}")
        step_dir = os.path.join(self.directory, str(step))
        world = saved_world(step_dir)
        if world != self._world:
            raise ValueError(
                f"checkpoint step {step} under {self.directory} was saved by {world} "
                f"process(es) and this run has {self._world}: restoring under another "
                "number of processes (elastic re-placement) is not ported")
        saved = torch.load(os.path.join(step_dir, state_file(self._rank, self._world)),
                           map_location="cpu", weights_only=True)
        paths = {"/".join(path) for path, _ in flatten_state(template)}
        if paths != set(saved):
            raise ValueError(
                f"checkpoint step {step} under {self.directory} does not match the learner "
                f"state: missing {sorted(paths - set(saved))[:5]}, "
                f"unexpected {sorted(set(saved) - paths)[:5]}")
        return _fill(template, saved, ()), step


def _fill(template: Any, saved: Dict[str, Any], prefix: Path) -> Any:
    key = "/".join(prefix)
    if isinstance(template, torch.Tensor):
        value = saved[key]
        if not isinstance(value, torch.Tensor) or (value.shape, value.dtype) != (
                template.shape, template.dtype):
            raise ValueError(f"checkpoint leaf {key}: expected a {template.dtype} tensor of "
                             f"shape {tuple(template.shape)}")
        return value.to(template.device)
    if isinstance(template, torch.Generator):
        template.set_state(saved[key]["generator_state"])
        return template
    children = _children(template)
    if children is None:
        return saved[key]
    values = [_fill(child, saved, prefix + (name,)) for name, child in children]
    if hasattr(template, "_fields"):
        return type(template)(*values)
    if isinstance(template, dict):
        return dict(zip(template.keys(), values))
    return type(template)(values)


def _write_json(path: str, data: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, default=str)
    os.replace(tmp, path)


def checkpointer_from_config(config: Any, model_name: str) -> Optional[Checkpointer]:
    """The saving Checkpointer of `logger.checkpointing.save_args`, or None
    when `save_model` is off."""
    ckpt_cfg = config.logger.checkpointing
    if not ckpt_cfg.get("save_model", False):
        return None
    save_args = ckpt_cfg.get("save_args") or {}
    return Checkpointer(
        model_name=model_name,
        metadata=config.to_dict() if hasattr(config, "to_dict") else None,
        checkpoint_uid=save_args.get("checkpoint_uid"),
        save_interval_steps=int(save_args.get("save_interval_steps", 1)),
        max_to_keep=save_args.get("max_to_keep", 1),
        keep_period=save_args.get("keep_period"),
    )


def loader_from_config(config: Any, model_name: str) -> Checkpointer:
    """The restoring Checkpointer of `logger.checkpointing.load_args`
    (`load_path`, default "checkpoints", and `checkpoint_uid`)."""
    load_args = config.logger.checkpointing.get("load_args") or {}
    load_path = load_args.get("load_path")
    if is_fleet_store(load_path):
        raise NotImplementedError(
            f"logger.checkpointing.load_args.load_path={load_path!r} is a fleet emergency "
            "store; restoring one (arch.fleet) is not ported")
    return Checkpointer(model_name=model_name, rel_dir=load_path or "checkpoints",
                        checkpoint_uid=load_args.get("checkpoint_uid"))
