"""The topology-elastic resize protocol (counterpart of
stoix_tpu/resilience/elastic.py: the same request file, overrides, messages
and exit code).

  * **The resize request** (`resize_request.json`, beside the fleet
    emergency store): the hand-off from a dying run to a supervising
    launcher, naming the action (shrink or grow), the device counts on both
    sides and the config overrides the relaunch needs (re-derived mesh
    axes). `resize_exit` writes it with the emergency snapshot and a flight
    record, then exits EXIT_CODE_ELASTIC_RESIZE (89), which a supervisor
    tells apart from a partition (87).
  * **Topology re-derivation** (`topology_overrides`, `survivor_overrides`):
    `arch.mesh` is re-derived for the devices present through
    `roles.elastic_mesh_axes` and validated through
    `roles.resolve_assignments`; explicit `arch.roles` device ids that no
    longer fit fall back to `arch.roles=~`. Pure host logic.

The port's Anakin runner spans one device a process, so its device count is
the process count. For a population run `resize_overrides` adds the
population's re-placement overrides (population/elastic.py). The
supervising launcher's relaunch loop belongs to ROADMAP A19c.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from stoix_tpu_torch.observability import flightrec, get_logger
from stoix_tpu_torch.parallel import roles as roles_lib
from stoix_tpu_torch.resilience.exit_codes import EXIT_CODE_ELASTIC_RESIZE

RESIZE_REQUEST_NAME = "resize_request.json"

RESIZE_ACTIONS = ("shrink", "grow")


class ElasticResizeError(ValueError):
    """A resize that cannot be satisfied (below one device, bad action,
    un-rescalable mesh axes)."""


def plan_resize(action: str, device_count: int) -> int:
    """The target device count for a resize fault: shrink halves, grow
    doubles — the preemption granularity of slice-sized allocations. Refuses
    a shrink below one device with the typed error (the run should die as a
    plain failure, not loop relaunching an impossible topology)."""
    if action not in RESIZE_ACTIONS:
        raise ElasticResizeError(
            f"unknown resize action {action!r}; known: {', '.join(RESIZE_ACTIONS)}"
        )
    if device_count < 1:
        raise ElasticResizeError(
            f"cannot resize from {device_count} device(s)"
        )
    if action == "shrink":
        target = device_count // 2
        if target < 1:
            raise ElasticResizeError(
                f"cannot shrink below one device (currently {device_count})"
            )
        return target
    return device_count * 2


def topology_overrides(config: Any, device_count: int) -> List[str]:
    """Config overrides that re-derive the mesh for `device_count` devices
    via `roles.elastic_mesh_axes`, validated through
    `roles.resolve_assignments` against the new count. When explicit
    `arch.roles` device ids no longer fit the survivors, the roles block is
    dropped (`arch.roles=~`) so assignment re-derives from the architecture
    name instead of replaying the dead topology. Pure host logic."""
    arch = dict((config.get("arch") if config is not None else None) or {})
    axes = roles_lib.elastic_mesh_axes(
        dict(arch.get("mesh") or {"data": -1}), device_count
    )
    candidate: Dict[str, Any] = {
        "arch": {
            "architecture_name": arch.get("architecture_name", "anakin"),
            "mesh": dict(axes),
            "roles": arch.get("roles"),
        }
    }
    overrides: List[str] = []
    try:
        roles_lib.resolve_assignments(candidate, device_count=device_count)
    except roles_lib.MeshRolesError:
        # Explicit role assignments pin device ids from the old topology;
        # re-derive instead. If even the derived assignment cannot fit, the
        # error propagates — an impossible topology must refuse, not relaunch.
        candidate["arch"]["roles"] = None
        roles_lib.resolve_assignments(candidate, device_count=device_count)
        overrides.append("arch.roles=~")
    overrides.extend(f"arch.mesh.{name}={size}" for name, size in axes.items())
    return overrides


def survivor_overrides(
    device_count: int, overrides: Optional[List[str]] = None
) -> List[str]:
    """The rc-87 elastic path's topology re-derivation, for the supervising
    launcher (which holds no composed config — only the job's override list).
    Any `arch.mesh.*=` / `arch.roles=` overrides already on the job are
    parsed into a minimal config so the re-derivation starts from what the
    dead incarnation actually ran with."""
    axes: Dict[str, int] = {}
    explicit_roles = False
    for entry in overrides or []:
        key, _, value = str(entry).partition("=")
        if key.startswith("arch.mesh."):
            try:
                axes[key[len("arch.mesh."):]] = int(value)
            except ValueError:
                continue
        elif key == "arch.roles" and value not in ("~", "null", ""):
            explicit_roles = True
    config = {"arch": {"mesh": axes or None, "roles": None}}
    derived = topology_overrides(config, device_count)
    if explicit_roles and "arch.roles=~" not in derived:
        derived.insert(0, "arch.roles=~")
    return derived


def write_resize_request(
    directory: str,
    *,
    action: str,
    from_devices: int,
    target_devices: int,
    window: int,
    step: int,
    platform: str,
    overrides: Optional[List[str]] = None,
) -> str:
    """Atomically write the resize hand-off next to the emergency store;
    returns the request path."""
    os.makedirs(directory, exist_ok=True)
    request = {
        "format": 1,
        "action": str(action),
        "from_devices": int(from_devices),
        "target_devices": int(target_devices),
        "window": int(window),
        "step": int(step),
        "platform": str(platform),
        "overrides": list(overrides or []),
        "unix_time": time.time(),
    }
    path = os.path.join(directory, RESIZE_REQUEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(request, f, indent=1)
    os.replace(tmp, path)
    return path


def read_resize_request(directory: str) -> Optional[Dict[str, Any]]:
    """The pending resize request under `directory`, or None."""
    try:
        with open(os.path.join(str(directory), RESIZE_REQUEST_NAME)) as f:
            request = json.load(f)
    except (OSError, ValueError):
        return None
    return request if isinstance(request, dict) else None


def consume_resize_request(directory: str) -> Optional[Dict[str, Any]]:
    """One-shot read for the supervising launcher: the request is removed so
    a LATER rc-89 (the grow leg of a soak cycle) is always answered by ITS
    OWN request, never a stale one."""
    request = read_resize_request(directory)
    if request is not None:
        try:
            os.remove(os.path.join(str(directory), RESIZE_REQUEST_NAME))
        except OSError:
            pass
    return request


def resize_overrides(config: Any, target_devices: int) -> List[str]:
    """Everything a relaunch at `target_devices` needs beyond the restore
    overrides: the re-derived mesh axes, plus, for population runs, the
    population re-placement overrides (`arch.population.size` scaled with
    the device ratio, population/elastic.py). A population spread over
    ranks (`arch.mesh.pop` above 1) is refused, naming the key: each rank's
    members are its own and its rescue store does not hold them."""
    arch = dict((config.get("arch") if config is not None else None) or {})
    pop_cfg = dict(arch.get("population") or {})
    population = int(pop_cfg.get("size", 1) or 1) > 1
    if population:
        from stoix_tpu_torch.parallel import process_count

        pop_axis = int(dict(arch.get("mesh") or {}).get("pop", 1))
        if pop_axis > 1 or (pop_axis == -1 and process_count() > 1):
            raise ElasticResizeError(
                f"cannot resize a population spread over arch.mesh.pop={pop_axis}: each "
                "rank's members are its own and the rescue store does not hold them; "
                "relaunch at the same topology")
    overrides = topology_overrides(config, target_devices)
    if population:
        from stoix_tpu_torch.population import elastic as population_elastic

        overrides.extend(
            population_elastic.population_resize_overrides(
                config, target_devices=target_devices
            )
        )
    return overrides


def resize_exit(
    action: str,
    *,
    config: Any,
    window_idx: int,
    step: int,
    fleet_coord: Any = None,
    device_count: int,
    platform: str,
) -> None:
    """The rc-89 exit protocol (never returns): secure the emergency
    snapshot, write the resize request naming the target topology and the
    relaunch overrides, dump a flight record, hard-exit 89. The snapshot and
    both files are on disk before the exit, because `os._exit` runs no
    finally blocks. `device_count` is this run's devices (the Anakin runner's
    processes, one device each) and `platform` their type ("cuda", "cpu")."""
    log = get_logger("stoix_tpu_torch.resilience")
    from_devices = int(device_count)
    target_devices = plan_resize(action, from_devices)
    overrides = resize_overrides(config, target_devices)
    emergency_dir = str(
        dict(dict(config.get("arch") or {}).get("fleet") or {}).get(
            "emergency_dir", os.path.join("checkpoints", "fleet_emergency")
        )
    )
    if fleet_coord is not None:
        try:
            saved = fleet_coord.emergency_save()
        # The hand-off is written even when the rescue save fails.
        except Exception as exc:  # noqa: BLE001
            saved = None
            log.error("[elastic] emergency save failed: %s", exc)
        if saved is None:
            log.warning(
                "[elastic] no rescue snapshot secured — the relaunch will "
                "restore the newest digest-verified checkpoint instead"
            )
    else:
        log.warning(
            "[elastic] resize without a fleet coordinator (arch.fleet."
            "enabled=false): no emergency snapshot — the relaunch restores "
            "the newest digest-verified checkpoint"
        )
    request_path = write_resize_request(
        emergency_dir,
        action=action,
        from_devices=from_devices,
        target_devices=target_devices,
        window=window_idx,
        step=step,
        platform=str(platform),
        overrides=overrides,
    )
    reason = (
        f"elastic {action}: {from_devices} -> {target_devices} device(s) "
        f"at window {window_idx} (step {step})"
    )
    log.warning(
        "[elastic] %s — request at %s, exiting %d for the elastic supervisor",
        reason, request_path, EXIT_CODE_ELASTIC_RESIZE,
    )
    flightrec.get_flight_recorder().record(
        "elastic_resize",
        action=action,
        window=window_idx,
        step=step,
        from_devices=from_devices,
        target_devices=target_devices,
    )
    flightrec.dump_flight_record(
        emergency_dir, reason=reason, exit_code=EXIT_CODE_ELASTIC_RESIZE
    )
    sys.stderr.flush()
    os._exit(EXIT_CODE_ELASTIC_RESIZE)
