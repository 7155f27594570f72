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
reads the rank's own file.

A step saved by another number of processes restores too (the topology-
elastic restore, as the JAX package's `_restore_resharded`): every rank
reads rank 0's file as host leaves keyed by tree path (`read_host_leaves`),
checks their digests against rank 0's sidecar, and places them into its
template by path (`place_host_leaves`). The replicated leaves (params,
optimizer state, statistics) come back bit for bit; a rank's own fields
(`integrity.per_rank_fields`: generators, env state, timestep, buffers) keep
the template's fresh values and are reported, with the count placed
("[checkpoint] elastic restore ... re-placed N leaf(s)";
`last_elastic_restore`).

Every save also records each leaf's sha256 digest (its tensor's bytes, a
generator's state) in a `_digests.json` sidecar at the store's root
(`_digests.<rank>-of-<N>.json` for each rank of several), and a restore
checks what it read before it fills the template: the same tree paths,
shapes and dtypes ('structure'), finite float leaves wherever the template's
are finite, bfloat16 included ('non_finite'), and the recorded digests
('digest'). A restore of the latest step walks from the newest step to the
oldest past every step that fails, an unreadable file included (its reason
the type of the exception `torch.load` raised), and records each rejection
in `last_restore_report`; an explicit `timestep` never falls back, and a
missing one lists the steps there are. The `ckpt_corrupt` fault overwrites
the saved step's files after a save (resilience/faultinject.py).

A fleet emergency store (resilience/fleet.py) restores through
`fleet.restore_emergency`, the same placement.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from stoix_tpu_torch.observability import get_logger
from stoix_tpu_torch.resilience import faultinject, integrity
from stoix_tpu_torch.resilience.errors import CheckpointIntegrityError

# 3.0 is the JAX package's (PPOLearnerState carries kl_beta). A major version
# that differs refuses to restore.
CHECKPOINTER_VERSION = 3.0
STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
METADATA_FILE = "metadata.json"
DIGEST_SIDECAR = "_digests.json"

Path = Tuple[str, ...]


def state_file(rank: int, world: int) -> str:
    """The file of rank `rank`'s state in a step saved by `world` processes."""
    return STATE_FILE if world == 1 else f"state.{rank}-of-{world}.pt"


def digest_file(rank: int, world: int) -> str:
    """The digest sidecar of rank `rank` in a store saved by `world` processes."""
    return DIGEST_SIDECAR if world == 1 else f"_digests.{rank}-of-{world}.json"


def saved_digest_record(store_dir: str, rank: int = 0,
                        world: int = 1) -> Dict[int, Dict[str, str]]:
    """Per-step digest records of a store's sidecar ({} when absent)."""
    try:
        with open(os.path.join(str(store_dir), digest_file(rank, world))) as f:
            data = json.load(f)
        return {int(step): {str(k): str(v) for k, v in (record or {}).items()}
                for step, record in (data.get("steps") or {}).items()}
    except (OSError, ValueError):
        return {}


def payload_digests(payload: Dict[str, Any]) -> Dict[str, str]:
    """The sha256 of every tensor and generator state of a saved payload."""
    digests = {}
    for key, value in payload.items():
        if isinstance(value, dict) and "generator_state" in value:
            value = value["generator_state"]
        if isinstance(value, torch.Tensor):
            digests[key] = integrity.leaf_digest(value)
    return digests


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


def _keystr(key: Path) -> str:
    return "/".join(key)


def _as_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, dict) and "generator_state" in value:
        value = value["generator_state"]
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.array(value, order="C"))  # a 0-d array stays 0-d


def place_host_leaves(
    raw_by_path: Dict[Path, Any],
    template: Any,
    step: int,
    allow_missing: bool = False,
    keep: Any = (),
) -> Tuple[Any, int, List[str], List[Path]]:
    """Place host leaves (numpy arrays, CPU tensors, generator states) into
    `template`'s structure and devices, matching by tree path: the placement
    half of the topology-elastic restore, shared with the fleet's emergency
    restore (as the JAX package's function of the same name).

    Returns (tree, matched_count, reinitialized_descriptions,
    reinitialized_keys). A shape mismatch is topology-dependent state and
    keeps the template's value; a dtype mismatch raises
    CheckpointIntegrityError (corruption, not topology). A missing leaf
    raises unless `allow_missing`; zero matched leaves always raises (that is
    another state, not another topology). `keep` names paths that keep the
    template's value whatever the store holds (a rank's own fields under
    another number of processes). A template generator takes its saved state
    in place; a plain value (the optimizer's step count) takes the saved one;
    None stays None."""
    keep = {tuple(k) for k in keep}
    reinitialized: List[str] = []
    reinitialized_keys: List[Path] = []
    matched = 0

    def reinit(key: Path, why: str, ref: Any) -> Any:
        reinitialized.append(f"{_keystr(key)} ({why})")
        reinitialized_keys.append(key)
        return ref

    def place(ref: Any, key: Path) -> Any:
        nonlocal matched
        if ref is None:
            return None
        children = None if isinstance(ref, (torch.Tensor, torch.Generator, np.ndarray)) \
            else _children(ref)
        if children is not None:
            values = [place(child, key + (name,)) for name, child in children]
            if hasattr(ref, "_fields"):
                return type(ref)(*values)
            if isinstance(ref, dict):
                return dict(zip(ref.keys(), values))
            return type(ref)(values)
        if key in keep:
            return reinit(key, "a rank's own state, kept the template's", ref)
        if key not in raw_by_path:
            if allow_missing:
                return reinit(key, "absent from the store", ref)
            raise CheckpointIntegrityError(
                step, f"leaf {_keystr(key)} missing from the checkpoint (resharded restore "
                "matches by tree-path)")
        value = raw_by_path[key]
        if isinstance(ref, torch.Generator):
            saved = _as_tensor(value)
            want = ref.get_state()
            if saved.dtype != want.dtype:
                raise CheckpointIntegrityError(
                    step, f"dtype mismatch at {_keystr(key)}: saved {saved.dtype} vs "
                    f"template {want.dtype}")
            if saved.shape != want.shape:
                return reinit(key, f"saved {tuple(saved.shape)} vs template "
                                   f"{tuple(want.shape)}", ref)
            ref.set_state(saved.clone())
            matched += 1
            return ref
        if isinstance(ref, torch.Tensor):
            arr = _as_tensor(value)
            if arr.dtype != ref.dtype:
                raise CheckpointIntegrityError(
                    step, f"dtype mismatch at {_keystr(key)}: saved {arr.dtype} vs template "
                    f"{ref.dtype}")
            if arr.shape != ref.shape:
                return reinit(key, f"saved {tuple(arr.shape)} vs template "
                                   f"{tuple(ref.shape)}", ref)
            matched += 1
            return arr.to(device=ref.device, copy=True)
        arr = np.asarray(value)
        ref_arr = np.asarray(ref)
        if arr.dtype != ref_arr.dtype:
            raise CheckpointIntegrityError(
                step, f"dtype mismatch at {_keystr(key)}: saved {arr.dtype} vs template "
                f"{ref_arr.dtype}")
        if arr.shape != ref_arr.shape:
            return reinit(key, f"saved {arr.shape} vs template {ref_arr.shape}", ref)
        matched += 1
        if isinstance(ref, np.ndarray):
            return arr.copy()
        return type(ref)(arr.item()) if isinstance(ref, (bool, int, float)) else arr.item()

    tree = place(template, ())
    if matched == 0:
        raise CheckpointIntegrityError(
            step, "resharded restore matched ZERO leaves by shape — this is a different "
            "state entirely, not a topology change")
    return tree, matched, reinitialized, reinitialized_keys


def read_host_leaves(store_dir: str, step: int) -> Dict[Path, Any]:
    """One saved step's leaves on the host, keyed by tree path: rank 0's
    file of the step, whatever number of processes saved it (tensors as CPU
    tensors, generators as {"generator_state": tensor}, plain values as they
    are). The read half of the topology-elastic restore."""
    step_dir = os.path.join(store_dir, str(step))
    world = saved_world(step_dir)
    if world is None:
        raise FileNotFoundError(f"no complete checkpoint at {step_dir}")
    payload = torch.load(os.path.join(step_dir, state_file(0, world)), map_location="cpu",
                         weights_only=True)
    return {tuple(key.split("/")) if key else (): value for key, value in payload.items()}


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
        # The typed rejections of the latest restore's fallback walk:
        # [{"step", "reason", "error"}, ...].
        self.last_restore_report: List[Dict[str, str]] = []
        # What the latest restore under another number of processes placed
        # and kept (None when it read this world's own files).
        self.last_elastic_restore: Optional[Dict[str, Any]] = None

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
            keep.update(ranked[max(0, len(ranked) - self._max_to_keep):] if self._max_to_keep
                        else [])
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
        self._record_digests(int(timestep), payload)
        name = state_file(self._rank, self._world)
        tmp = os.path.join(step_dir, name + ".tmp")
        torch.save(payload, tmp)
        metrics = {"episode_return": float(episode_return), "step": int(timestep)}
        if self._world == 1:
            _write_json(os.path.join(step_dir, METRICS_FILE), metrics)
            os.replace(tmp, os.path.join(step_dir, STATE_FILE))
            self._prune()
        else:
            os.replace(tmp, os.path.join(step_dir, name))
            dist.barrier()  # every rank's file is in place
            if self._rank == 0:
                _write_json(os.path.join(step_dir, METRICS_FILE), metrics)
                self._prune()
            dist.barrier()  # the store is whole again before any rank reads it
        if faultinject.consume_ckpt_corrupt():
            faultinject.corrupt_checkpoint_files(step_dir)
        return True

    def _record_digests(self, timestep: int, payload: Dict[str, Any]) -> None:
        """Record the payload's per-leaf digests for `timestep` in this rank's
        sidecar (read-modify-write; steps no longer on disk dropped). A
        failed write only leaves the step unverified, so it is logged."""
        path = os.path.join(self.directory, digest_file(self._rank, self._world))
        try:
            record = saved_digest_record(self.directory, self._rank, self._world)
            record[timestep] = payload_digests(payload)
            on_disk = set(self.all_steps()) | {timestep}
            _write_json(path, {"steps": {str(step): record[step] for step in sorted(record)
                                         if step in on_disk}})
        except OSError as exc:
            get_logger("stoix_tpu_torch.checkpoint").warning(
                "[checkpoint] could not record the digest sidecar for step %d (%s) — this "
                "step will restore without digest verification", timestep, exc)

    def restore(self, template: Any, timestep: Optional[int] = None) -> Tuple[Any, int]:
        """The saved state at `timestep` (the latest valid one when None) in
        the structure of `template`; returns (state, step). Generators in the
        template take their saved states in place, once a step has passed
        every check. Without `timestep` the walk goes from the newest step to
        the oldest past every step that fails, each rejection in
        `last_restore_report` with its typed reason; an explicit `timestep`
        never falls back."""
        self.last_restore_report = []
        self.last_elastic_restore = None
        steps = self.all_steps()
        if timestep is not None:
            if int(timestep) not in steps:
                raise FileNotFoundError(
                    f"No checkpoint at timestep {timestep} under {self.directory}; "
                    f"available steps: {steps or '[]'}")
            candidates = [int(timestep)]
        elif steps:
            candidates = steps[::-1]
        else:
            raise FileNotFoundError(f"No checkpoints under {self.directory}")
        log = get_logger("stoix_tpu_torch.checkpoint")
        last_error: Optional[Exception] = None
        for step in candidates:
            try:
                world = saved_world(os.path.join(self.directory, str(step)))
                if world != self._world:
                    return self._restore_elastic(step, template, world), step
                saved = self._read_step(step)
                self._validate(saved, template, step)
                self._verify_digests(saved, step)
                return _fill(template, saved, ()), step
            except Exception as exc:  # every failure means: try the next-newest
                if timestep is not None:
                    raise
                last_error = exc
                reason = getattr(exc, "kind", None) or type(exc).__name__
                self.last_restore_report.append(
                    {"step": str(step), "reason": str(reason), "error": str(exc)})
                log.warning("[checkpoint] step %d unusable [reason: %s] (%s: %s) — falling "
                            "back to the next-newest checkpoint", step, reason,
                            type(exc).__name__, exc)
        raise CheckpointIntegrityError(
            candidates[-1],
            f"no valid checkpoint among steps {candidates} under {self.directory}; last "
            f"error: {type(last_error).__name__}: {last_error}")

    def _restore_elastic(self, step: int, template: Any, world: int) -> Any:
        """A step saved by `world` processes into this run of `self._world`:
        rank 0's leaves outside a rank's own fields pass the same-world gate
        (`_validate` against the template without those fields, then
        `_verify_digests` against rank 0's sidecar) and are placed by tree
        path; a rank's own fields keep the template's values. Generators are
        set only once every check passed."""
        log = get_logger("stoix_tpu_torch.checkpoint")
        log.info("[checkpoint] step %d saved by %d process(es), this run has %d — taking the "
                 "elastic (resharding) restore path", step, world, self._world)
        own = integrity.per_rank_fields(template)
        shared = {"/".join(k): v for k, v in read_host_leaves(self.directory, step).items()
                  if not integrity.is_rank_bound(k, own)}
        self._validate(shared, template, step, skip=own)
        self._verify_digests(shared, step, rank=0, world=world)
        keep = [path for path, _ in flatten_state(template) if integrity.is_rank_bound(path, own)]
        restored, matched, reinitialized, _ = place_host_leaves(
            {tuple(k.split("/")): v for k, v in shared.items()}, template, step, keep=keep)
        log.warning(
            "[checkpoint] elastic restore of step %d re-placed %d leaf(s) onto the new mesh; "
            "%d topology-dependent leaf(s) kept their template initialization: %s",
            step, matched, len(reinitialized), "; ".join(reinitialized))
        self.last_elastic_restore = {"step": int(step), "saved_world": int(world),
                                     "world": self._world, "matched": int(matched),
                                     "reinitialized": list(reinitialized)}
        return restored

    def _read_step(self, step: int) -> Dict[str, Any]:
        return torch.load(os.path.join(self.directory, str(step),
                                       state_file(self._rank, self._world)),
                          map_location="cpu", weights_only=True)

    @staticmethod
    def _validate(saved: Dict[str, Any], template: Any, step: int, skip: Any = ()) -> None:
        """The integrity gate on a read payload: the template's tree paths
        outside the subtrees `skip` names (a rank's own), each tensor's shape
        and dtype ('structure'), and every float tensor finite wherever the
        template's is ('non_finite')."""
        leaves = dict(("/".join(path), leaf) for path, leaf in flatten_state(template)
                      if not integrity.is_rank_bound(path, skip))
        if set(leaves) != set(saved):
            raise CheckpointIntegrityError(
                step, f"the saved tree does not match the learner state: missing "
                f"{sorted(set(leaves) - set(saved))[:5]}, unexpected "
                f"{sorted(set(saved) - set(leaves))[:5]}", kind="structure")
        for key, ref in leaves.items():
            value = saved[key]
            if isinstance(ref, torch.Generator):
                if not (isinstance(value, dict) and isinstance(
                        value.get("generator_state"), torch.Tensor)):
                    raise CheckpointIntegrityError(step, f"leaf {key} is not a generator's "
                                                   "state", kind="structure")
                continue
            if not isinstance(ref, torch.Tensor):
                continue
            if not isinstance(value, torch.Tensor) or (value.shape, value.dtype) != (
                    ref.shape, ref.dtype):
                raise CheckpointIntegrityError(
                    step, f"leaf {key}: expected a {ref.dtype} tensor of shape "
                    f"{tuple(ref.shape)}", kind="structure")
            if (value.is_floating_point() and not bool(torch.isfinite(value).all())
                    and bool(torch.isfinite(ref).all())):
                raise CheckpointIntegrityError(
                    step, f"non-finite values in leaf {key} (template expects finite values "
                    "here)", kind="non_finite")

    def _verify_digests(self, saved: Dict[str, Any], step: int, rank: Optional[int] = None,
                        world: Optional[int] = None) -> None:
        """Each leaf of `saved` against the digest that rank `rank` of
        `world` (default: this process's) recorded at save time; a mismatch
        is bit-rot ('digest'). No record for the step: skipped. `_validate`
        has already held `saved` to the template's paths."""
        record = saved_digest_record(self.directory,
                                     self._rank if rank is None else rank,
                                     self._world if world is None else world).get(step) or {}
        if not record:
            return
        got = payload_digests(saved)
        mismatched = sorted(key for key, want in record.items()
                            if key in saved and got.get(key) != want)
        if mismatched:
            raise CheckpointIntegrityError(
                step, f"sha256 digest mismatch on {len(mismatched)} leaf(s) — the bytes on "
                f"disk are not the bytes that were saved (bit-rot or tampering): "
                f"{', '.join(mismatched[:5])}{'...' if len(mismatched) > 5 else ''}",
                kind="digest")


def _fill(template: Any, saved: Dict[str, Any], prefix: Path) -> Any:
    key = "/".join(prefix)
    if isinstance(template, torch.Tensor):
        return saved[key].to(template.device)
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
    (`load_path`, default "checkpoints", and `checkpoint_uid`). A `load_path`
    that holds a fleet emergency store is the runner's to restore
    (fleet.restore_emergency), as the JAX runner does."""
    load_args = config.logger.checkpointing.get("load_args") or {}
    return Checkpointer(model_name=model_name, rel_dir=load_args.get("load_path") or "checkpoints",
                        checkpoint_uid=load_args.get("checkpoint_uid"))
