"""State-integrity sentinel (counterpart of stoix_tpu/resilience/integrity.py).

After every gradient all-reduce the replicated part of the learner state
(params, optimizer state, observation statistics, β) is bit-identical on
every rank. A flaky core or a flipped memory bit makes finite-but-wrong
values that no divergence guard can see, and the invariant makes them cheap
to catch: any disagreement between ranks proves corruption.

  * Replica fingerprints: each rank folds each replicated state group to a
    uint32 (`fingerprint_leaves`, bitwise the JAX package's fold of the same
    bytes); the ranks exchange their [G] fingerprints in one all-gather a
    window (`parallel.process_allgather`), and the host compares them. A
    disagreement raises `StateCorruptionError` naming the deviating rank(s)
    (the minority against a strict majority; with no strict majority, as
    with two ranks, every rank), before that window's checkpoint is saved.
  * Quarantine: the verdict is appended to `arch.integrity.quarantine_file`
    with the overrides that resume from the run's store, a flight record is
    dumped beside it, and the sentinel's excepthook turns the uncaught error
    into exit code 88 (`EXIT_CODE_STATE_CORRUPTION`).
  * Determinism probe (`determinism_probe_interval` N > 0): the state going
    into window 0 is copied (every tensor and every generator's state), its
    window-0 fingerprints are the reference, and every N windows the copy is
    replayed through the learn step and its fingerprints compared bitwise: a
    wrong-math core is caught even in one process.

A rank in the port holds its own copy of every leaf, so which leaves are
replicas is decided from the learner state's fields (`replicated_group_specs`):
every top-level field but the per-rank ones (generators, env state,
timestep, buffers). The group names are the JAX package's for the same
state.

The fingerprint of a group runs as one pass over all its bytes on the
state's device (a concatenation, an elementwise mix in int64 masked to 32
bits, and one segment sum a leaf); the [L] per-leaf sums come to the host,
which folds them in the JAX package's order. Integer sums do not depend on
their order, so a fingerprint of CUDA tensors equals the CPU's.

This module also holds the per-leaf sha256 digests of the checkpoint
sidecar (`leaf_digest`, `digest_arrays`, `verify_digests`). Everything sits
behind `arch.integrity.enabled` (off: no work, the same host loop).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from stoix_tpu_torch.observability import flightrec, get_logger, get_registry
from stoix_tpu_torch.parallel.distributed import process_allgather
from stoix_tpu_torch.resilience.errors import StateCorruptionError
from stoix_tpu_torch.resilience.exit_codes import EXIT_CODE_STATE_CORRUPTION

_GOLDEN = 0x9E3779B9  # 32-bit golden-ratio constant (position/group salt)
_MASK = 0xFFFFFFFF
# Top-level fields of a learner state that each rank holds for itself: its
# generators, its envs' state and last steps (the recurrent systems' carries
# and flags, ff_trans_ppo's context window and last action) and its buffer.
PER_RANK_FIELDS = ("generator", "generators", "key", "env_state", "timestep", "buffer_state",
                   "buffer", "done", "truncated", "hstates", "window", "action")


# ---------------------------------------------------------------------------
# Digests (the checkpoint sidecar)
# ---------------------------------------------------------------------------


def leaf_digest(arr: Any) -> str:
    """sha256 hex digest of a leaf's raw bytes in C order, bfloat16 included
    (the JAX package's for the same bytes). A numpy array is hashed as it
    is, as the JAX package hashes a host array."""
    if isinstance(arr, np.ndarray):
        return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
    return hashlib.sha256(_leaf_bytes_tensor(arr).cpu().numpy().tobytes()).hexdigest()


def digest_arrays(arrays: Dict[str, Any]) -> Dict[str, str]:
    """Per-leaf digest record for a {key: array or tensor} mapping."""
    return {key: leaf_digest(arr) for key, arr in arrays.items()}


def verify_digests(arrays: Dict[str, Any], record: Dict[str, str]) -> List[str]:
    """Keys present in both `arrays` and `record` whose bytes no longer match
    the recorded digest (empty: verified). A key missing on either side is
    the caller's verdict."""
    return sorted(key for key, want in record.items()
                  if key in arrays and leaf_digest(arrays[key]) != want)


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------


class IntegritySettings(NamedTuple):
    """Resolved `arch.integrity` block (defaults applied)."""

    enabled: bool
    determinism_probe_interval: int
    quarantine_file: str


def settings_from_config(config: Any) -> IntegritySettings:
    cfg = (config.get("arch") or {}).get("integrity") or {}
    return IntegritySettings(
        enabled=bool(cfg.get("enabled", False)),
        determinism_probe_interval=int(cfg.get("determinism_probe_interval", 0) or 0),
        quarantine_file=str(
            cfg.get("quarantine_file") or os.path.join("checkpoints", "quarantine.json")),
    )


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 words in [0, 2^32): the low 32 bits
    of a wrapped int64 product are the uint32 product's."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _MASK
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _MASK
    return x ^ (x >> 16)


def _fmix32_int(x: int) -> int:
    """`_fmix32` of one host int."""
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _MASK
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _MASK
    return x ^ (x >> 16)


def _leaf_bytes_tensor(leaf: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """A leaf's bytes as a flat uint8 tensor (little-endian; bool as one byte
    a value), on the leaf's device."""
    x = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.ascontiguousarray(leaf))
    if device is not None:
        x = x.to(device)
    x = x.detach().contiguous().reshape(-1)
    return x if x.dtype == torch.uint8 else x.view(torch.uint8)


def _leaf_words(leaf: Any) -> torch.Tensor:
    """A leaf's raw bits as a flat int64 word vector, one word a byte (the
    JAX package's uint32 words)."""
    return _leaf_bytes_tensor(leaf).to(torch.int64)


def _premix(sizes: Sequence[int], device: torch.device,
            leaf_indices: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-byte salt mix `fmix32(position + leaf_salt)` and the segment
    (leaf) of every byte, for leaves of `sizes` bytes; they depend on the
    sizes alone. A leaf's salt is from its index in its group
    (`leaf_indices`, default 0, 1, ...)."""
    parts, segments = [], []
    leaf_indices = range(len(sizes)) if leaf_indices is None else leaf_indices
    for segment, (leaf_idx, size) in enumerate(zip(leaf_indices, sizes)):
        position = torch.arange(size, dtype=torch.int64, device=device)
        leaf_salt = ((leaf_idx + 1) * _GOLDEN) & _MASK
        parts.append(_fmix32((position + leaf_salt) & _MASK))
        segments.append(torch.full((size,), segment, dtype=torch.int64, device=device))
    empty = torch.zeros(0, dtype=torch.int64, device=device)
    return (torch.cat(parts) if parts else empty), (torch.cat(segments) if segments else empty)


def leaf_sums(leaves: Sequence[Any], premix: torch.Tensor, segments: torch.Tensor) -> torch.Tensor:
    """The device half of a fingerprint: each leaf's sum of mixed words, an
    int64 [L] tensor on the leaves' device (each sum is below 2^63)."""
    device = premix.device
    words = torch.cat([_leaf_bytes_tensor(leaf, device) for leaf in leaves]) if leaves else (
        torch.zeros(0, dtype=torch.uint8, device=device))
    mixed = _fmix32(words.to(torch.int64) ^ premix)
    return torch.zeros(len(leaves), dtype=torch.int64, device=device).index_add_(
        0, segments, mixed)


def fold_sums(sums: Sequence[int], sizes: Sequence[int], salt: int = 0) -> int:
    """The host half: the JAX package's fold over leaves,
    acc = fmix32(((acc + sum) mod 2^32) ^ size)."""
    acc = salt & _MASK
    for total, size in zip(sums, sizes):
        acc = _fmix32_int(((acc + int(total)) & _MASK) ^ (int(size) & _MASK))
    return acc


def fingerprint_leaves(leaves: Sequence[Any], salt: int = 0) -> int:
    """Fold a list of leaves (tensors or numpy arrays) to ONE uint32
    fingerprint, bitwise the JAX package's `fingerprint_leaves` of the same
    bytes. Each byte is salted by its position and its leaf's index before
    the avalanche mix, so a flip is seen wherever it lands and two identical
    flips at different positions cannot cancel."""
    tensors = [_leaf_bytes_tensor(leaf) for leaf in leaves]
    device = tensors[0].device if tensors else torch.device("cpu")
    sizes = [t.numel() for t in tensors]
    premix, segments = _premix(sizes, device)
    sums = leaf_sums(tensors, premix, segments).tolist()
    return fold_sums(sums, sizes, salt)


def _state_fields(state: Any) -> List[Tuple[str, Any]]:
    if hasattr(state, "_fields"):
        return [(name, getattr(state, name)) for name in state._fields]
    if isinstance(state, dict):
        return sorted(state.items())
    return [("state", state)]


def _contains_generator(tree: Any) -> bool:
    if isinstance(tree, torch.Generator):
        return True
    if isinstance(tree, dict):
        return any(_contains_generator(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_contains_generator(v) for v in tree)
    return False


def per_rank_fields(state: Any) -> set:
    """The subtrees of a learner state that each rank holds for itself, as
    slash-joined tree paths: those the state declares
    (`state.rank_bound_paths()`, a population's nested member fields), else
    its top-level fields in `PER_RANK_FIELDS` or holding a generator; empty
    for a state that is not a record. The topology-elastic restore and the
    fleet's rescue snapshot keep these rank-bound (`is_rank_bound`)."""
    declared = getattr(state, "rank_bound_paths", None)
    if callable(declared):
        return set(declared())
    if not (hasattr(state, "_fields") or isinstance(state, dict)):
        return set()
    return {str(name) for name, subtree in _state_fields(state)
            if name in PER_RANK_FIELDS or _contains_generator(subtree)}


def is_rank_bound(path: Sequence[str], own: set) -> bool:
    """Whether the leaf at tree path `path` lies in one of the subtrees
    `own` names (`per_rank_fields`)."""
    return any("/".join(path[:i]) in own for i in range(1, len(path) + 1))


def _tensor_leaves(tree: Any) -> List[torch.Tensor]:
    from stoix_tpu_torch.utils.tree import tree_leaves

    return tree_leaves(tree)


def replicated_group_specs(template: Any) -> List[Tuple[str, int]]:
    """The replicated state groups of a learner state: each top-level field
    (NamedTuple) or key (dict) that holds at least one tensor and is not a
    rank's own (`PER_RANK_FIELDS`, or a subtree holding a generator), with
    its tensor count. A state that is not a record is one group, 'state'."""
    groups = []
    for name, subtree in _state_fields(template):
        if name in PER_RANK_FIELDS or _contains_generator(subtree):
            continue
        count = len(_tensor_leaves(subtree))
        if count:
            groups.append((str(name), count))
    return groups


def _group_subtree(state: Any, name: str) -> Any:
    if hasattr(state, "_fields"):
        return getattr(state, name)
    if isinstance(state, dict):
        return state[name]
    return state


class Fingerprinter:
    """The fingerprint of one state structure's replicated groups, its salt
    mix built once (`bind`) for the state's device and leaf sizes."""

    def __init__(self, template: Any):
        self.groups = replicated_group_specs(template)
        if not self.groups:
            raise ValueError(
                "state has no replicated tensor leaves to fingerprint: arch.integrity cannot "
                "guard a state with no replicated groups")
        leaves = self._leaves(template)
        self.device = leaves[0].device
        self.sizes = [leaf.numel() * leaf.element_size() for leaf in leaves]
        in_group = [i for _, count in self.groups for i in range(count)]
        self.premix, self.segments = _premix(self.sizes, self.device, in_group)

    @property
    def group_names(self) -> List[str]:
        return [name for name, _ in self.groups]

    def _leaves(self, state: Any) -> List[torch.Tensor]:
        leaves = []
        for name, count in self.groups:
            group = _tensor_leaves(_group_subtree(state, name))
            if len(group) != count:
                raise ValueError(f"state group {name!r} holds {len(group)} tensors, bound {count}")
            leaves.extend(group)
        return leaves

    def __call__(self, state: Any) -> Dict[str, int]:
        """{group: this rank's uint32 fingerprint}: one pass on the device,
        one copy of the [L] sums to the host."""
        leaves = self._leaves(state)
        sums = leaf_sums(leaves, self.premix, self.segments).tolist()
        out, start = {}, 0
        for group_idx, (name, count) in enumerate(self.groups):
            salt = ((group_idx + 1) * _GOLDEN) & _MASK
            out[name] = fold_sums(sums[start:start + count], self.sizes[start:start + count], salt)
            start += count
        return out


def gather_fingerprints(local: Dict[str, int]) -> Dict[str, np.ndarray]:
    """{group: [world] uint32 vector}, entry r rank r's fingerprint (one
    all-gather of the [G] values; a single process keeps its own)."""
    names = list(local)
    rows = process_allgather([local[name] for name in names])
    return {name: np.asarray([row[g] for row in rows], np.uint32) for g, name in enumerate(names)}


def tree_copy(tree: Any, memo: Optional[Dict[int, Any]] = None) -> Any:
    """A copy of a learner state that nothing the run does later can touch:
    every tensor cloned, every generator a new one in the same state. An
    object the state holds in two places (the env's resets drawing from the
    learner's generator) stays one object in the copy."""
    memo = {} if memo is None else memo
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        if id(tree) not in memo:
            if isinstance(tree, torch.Tensor):
                memo[id(tree)] = tree.clone()
            else:
                memo[id(tree)] = torch.Generator(device=tree.device)
                memo[id(tree)].set_state(tree.get_state())
        return memo[id(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_copy(v, memo) for v in tree))
    if isinstance(tree, dict):
        return {k: tree_copy(v, memo) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_copy(v, memo) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# Sentinel
# ---------------------------------------------------------------------------


class StateIntegritySentinel:
    """One run's integrity checking: the fingerprints, the host verdicts,
    the determinism probe, the quarantine record and the exit-code
    excepthook. Made by `sentinel_from_config`; `bind` once the state
    exists, `deactivate` in the host loop's finally."""

    def __init__(self, settings: IntegritySettings):
        self.settings = settings
        self._fingerprinter: Optional[Fingerprinter] = None
        self.group_names: List[str] = []
        self._device_order: List[Tuple[int, int]] = []  # (device, process) of each entry
        self._lock = threading.Lock()
        self._checks = 0
        self._overhead_s = 0.0
        self._probe_runs = 0
        self._probe_input: Optional[Any] = None
        self._probe_ref: Optional[Dict[str, np.ndarray]] = None
        self._resume_overrides: List[str] = []
        self._corruption: Optional[StateCorruptionError] = None
        self._prev_excepthook: Optional[Callable] = None
        self._log = get_logger("stoix_tpu_torch.resilience")

    # -- lifecycle -----------------------------------------------------------
    def bind(self, state_template: Any, world: int = 1) -> "StateIntegritySentinel":
        """Build the fingerprint for this state structure; entry r of every
        gathered vector is rank r (its device and its process)."""
        self._fingerprinter = Fingerprinter(state_template)
        self.group_names = self._fingerprinter.group_names
        self._device_order = [(rank, rank) for rank in range(int(world))]
        probe_note = (f", determinism probe every {self.settings.determinism_probe_interval} "
                      "window(s)" if self.probe_enabled else "")
        self._log.info("[integrity] sentinel armed: fingerprinting %s across %d rank(s)%s",
                       "+".join(self.group_names), len(self._device_order), probe_note)
        return self

    def install_excepthook(self) -> None:
        """Turn an uncaught StateCorruptionError into exit code 88 for a
        supervisor, after the previous hook has printed it."""
        prev = sys.excepthook
        self._prev_excepthook = prev

        def hook(exc_type, exc, tb):
            prev(exc_type, exc, tb)
            if isinstance(exc, StateCorruptionError):
                # os._exit skips every finally: the exit path itself leaves
                # the evidence.
                flightrec.dump_flight_record(
                    None, reason=f"state corruption: uncaught {exc_type.__name__}",
                    exit_code=EXIT_CODE_STATE_CORRUPTION)
                sys.stderr.flush()
                os._exit(EXIT_CODE_STATE_CORRUPTION)

        self._hook = hook
        sys.excepthook = hook

    def deactivate(self) -> None:
        """Restore the excepthook unless a corruption verdict was recorded
        (the error propagating out of the host loop is what the hook must
        turn into exit code 88), and only while the installed hook is ours."""
        if (self._corruption is None and self._prev_excepthook is not None
                and sys.excepthook is getattr(self, "_hook", None)):
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None

    # -- resume/quarantine ----------------------------------------------------
    def set_resume_info(self, store_directory: str) -> None:
        """The overrides a relaunch needs to restore the newest verified step
        of this run's store (`<rel_dir>/<uid>/<model>`)."""
        directory = os.path.abspath(str(store_directory))
        uid_dir = os.path.dirname(directory)
        self._resume_overrides = [
            "logger.checkpointing.load_model=true",
            f"logger.checkpointing.load_args.load_path={os.path.dirname(uid_dir)}",
            f"logger.checkpointing.load_args.checkpoint_uid={os.path.basename(uid_dir)}",
        ]

    def _record_quarantine(self, err: StateCorruptionError) -> None:
        """Append the verdict to the quarantine file (read-modify-write, on
        the coordinator: every rank reaches the same verdict) with the resume
        overrides, then dump the flight record beside it."""
        from stoix_tpu_torch.parallel.distributed import is_coordinator

        path = self.settings.quarantine_file
        if is_coordinator():
            entry = {
                "kind": err.kind, "groups": err.groups, "devices": err.devices,
                "processes": err.processes, "window": err.window, "step": err.step,
                "detail": err.detail, "unix_time": time.time(),
            }
            try:
                record = {"quarantined": [], "resume_overrides": []}
                if os.path.isfile(path):
                    with open(path) as f:
                        loaded = json.load(f)
                    if isinstance(loaded, dict):
                        record.update(loaded)
                record.setdefault("quarantined", []).append(entry)
                record["resume_overrides"] = list(self._resume_overrides)
                os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(record, f, indent=1)
                os.replace(tmp, path)
                self._log.error("[integrity] quarantine record written to %s (process(es) %s, "
                                "device(s) %s)", path, err.processes, err.devices)
            except (OSError, ValueError) as exc:
                self._log.error("[integrity] could not write quarantine record to %s: %s",
                                path, exc)
        flightrec.get_flight_recorder().record(
            "quarantine", corruption=err.kind, window=err.window, step=err.step,
            processes=list(err.processes), devices=list(err.devices))
        flightrec.dump_flight_record(
            os.path.dirname(os.path.abspath(path)),
            reason=f"state corruption: {err.kind} at window {err.window}",
            exit_code=EXIT_CODE_STATE_CORRUPTION)

    def _corruption_found(self, err: StateCorruptionError) -> StateCorruptionError:
        self._corruption = err
        get_registry().counter(
            "stoix_tpu_integrity_corruptions_total",
            "Silent-corruption verdicts raised by the state-integrity sentinel",
        ).inc(labels={"kind": err.kind})
        self._record_quarantine(err)
        self._log.error("[integrity] %s", err)
        return err

    # -- fingerprints ---------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.settings.enabled

    @property
    def probe_enabled(self) -> bool:
        return self.settings.determinism_probe_interval > 0

    def fingerprints(self, state: Any) -> Dict[str, np.ndarray]:
        """{group: [world] uint32 vector} of `state`: this rank's
        fingerprints, gathered from every rank."""
        t0 = time.perf_counter()
        out = gather_fingerprints(self._fingerprinter(state))
        with self._lock:
            self._overhead_s += time.perf_counter() - t0
        return out

    def verify(self, payload: Dict[str, Any], window_idx: int,
               step: int) -> Optional[StateCorruptionError]:
        """Compare a gathered payload's entries. All equal: None. Any
        disagreement: the typed error naming the deviating rank(s) (the
        minority against a strict majority; every rank without one), with
        the quarantine record written."""
        t0 = time.perf_counter()
        bad_groups: List[str] = []
        deviant_positions: set = set()
        details: List[str] = []
        for name in self.group_names:
            vec = np.asarray(payload[name]).reshape(-1)
            values, counts = np.unique(vec, return_counts=True)
            if len(values) <= 1:
                continue
            bad_groups.append(name)
            if int(counts.max()) * 2 <= vec.size:
                # No strict majority: corruption is proven, the culprit is
                # undecidable, and naming the smaller fingerprint would blame
                # a healthy rank half the time. Name every rank.
                deviant_positions.update(range(vec.size))
                details.append(
                    f"{name}: no majority fingerprint ("
                    + ", ".join(f"device {self._device_order[i][0]}={int(vec[i]):#010x}"
                                for i in range(vec.size))
                    + ") — replicas disagree but the corrupt one is undecidable at this "
                    "replica count")
                continue
            majority = values[int(np.argmax(counts))]
            deviants = np.nonzero(vec != majority)[0]
            deviant_positions.update(int(i) for i in deviants)
            details.append(
                f"{name}: majority fingerprint {int(majority):#010x} on {int(counts.max())}/"
                f"{vec.size} device(s), deviating "
                + ", ".join(f"device {self._device_order[i][0]}={int(vec[i]):#010x}"
                            for i in deviants))
        with self._lock:
            self._checks += 1
            self._overhead_s += time.perf_counter() - t0
        if not bad_groups:
            return None
        return self._corruption_found(StateCorruptionError(
            kind="replica_mismatch", groups=bad_groups,
            devices=sorted({self._device_order[i][0] for i in deviant_positions}),
            processes=sorted({self._device_order[i][1] for i in deviant_positions}),
            window=window_idx, step=step, detail="; ".join(details)))

    # -- determinism probe ----------------------------------------------------
    def capture_probe_input(self, state: Any) -> None:
        """Record the replay input, generators included: a copy of the state
        going into window 0 (Anakin), or of update 0's learn-step arguments
        (Sebulba: the state and its batch). The first capture wins."""
        if self.probe_enabled and self._probe_input is None:
            self._probe_input = tree_copy(state)

    def record_probe_reference(self, payload: Dict[str, Any]) -> None:
        """The reference: the gathered fingerprints of learn(probe input),
        taken from the run's own step (window 0, or Sebulba's update 0)."""
        if self.probe_enabled and self._probe_ref is None:
            self._probe_ref = {name: np.array(np.asarray(payload[name]), copy=True)
                               for name in self.group_names}

    def should_probe(self, window_idx: int) -> bool:
        interval = self.settings.determinism_probe_interval
        return (self.probe_enabled and window_idx > 0 and window_idx % interval == 0
                and self._probe_input is not None and self._probe_ref is not None)

    def run_probe(self, learn_fn: Callable[[Any], Any]) -> Optional[StateCorruptionError]:
        """Replay the recorded input through `learn_fn` (on a fresh copy) and
        compare its fingerprints bitwise with the reference."""
        replay = learn_fn(tree_copy(self._probe_input))
        got = self.fingerprints(getattr(replay, "learner_state", replay))
        with self._lock:
            self._probe_runs += 1
        mismatched = [name for name in self.group_names
                      if not np.array_equal(got[name], self._probe_ref[name])]
        if not mismatched:
            return None
        return self._corruption_found(StateCorruptionError(
            kind="determinism", groups=mismatched,
            devices=[d for d, _ in self._device_order],
            processes=sorted({p for _, p in self._device_order}),
            window=-1, step=-1,
            detail="; ".join(f"{name}: replay {got[name].tolist()} != recorded "
                             f"{self._probe_ref[name].tolist()}" for name in mismatched)))

    # -- reporting ------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """LAST_RUN_STATS["integrity"] of this run (the JAX keys)."""
        with self._lock:
            return {"enabled": True, "fingerprint_checks": self._checks,
                    "overhead_s": round(self._overhead_s, 6), "probe_runs": self._probe_runs}


def disabled_stats() -> Dict[str, Any]:
    """The stats with the sentinel off."""
    return {"enabled": False, "fingerprint_checks": 0, "overhead_s": 0.0, "probe_runs": 0}


def sentinel_from_config(config: Any) -> Optional[StateIntegritySentinel]:
    """A sentinel when `arch.integrity.enabled`, else None (no work)."""
    settings = settings_from_config(config)
    if not settings.enabled:
        return None
    return StateIntegritySentinel(settings)


def read_quarantine(path: str) -> Dict[str, Any]:
    """The quarantine record at `path` ({} when absent or unreadable)."""
    try:
        with open(path) as f:
            loaded = json.load(f)
        return loaded if isinstance(loaded, dict) else {}
    except (OSError, ValueError):
        return {}


def corruption_resume_overrides(quarantine_file: str) -> List[str]:
    """The resume overrides of the latest corruption verdict ([] when the run
    had no checkpoint store: a relaunch then starts fresh)."""
    return [str(o) for o in read_quarantine(quarantine_file).get("resume_overrides") or []]
