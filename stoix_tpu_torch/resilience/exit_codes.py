"""The process exit-code registry (counterpart of
stoix_tpu/resilience/exit_codes.py: the same codes, names, meanings and
supervision notes, record for record).

Every deliberate non-zero exit of the port names one constant declared
here: the watchdog's hard exit on a wedged stage (86), the fleet's partition
exit (87), the integrity sentinel's corruption verdict (88) and the resize
protocol's exit (89). A supervisor reads one registry for both packages.
Standard library only: the registry is importable without torch.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

# 0 and 1 keep their POSIX meanings.
EXIT_CODE_OK = 0
# An uncaught exception, or a crash that is final: never relaunch.
EXIT_CODE_FAILURE = 1
# A command-line usage error (argparse's convention).
EXIT_CODE_USAGE = 2
# The watchdog (resilience/watchdog.py) shot a main thread wedged in native
# code past its stage deadline: retry is reasonable.
EXIT_CODE_STALL = 86
# A fleet peer died and this host secured its emergency checkpoint
# (resilience/fleet.py).
EXIT_CODE_FLEET_PARTITION = 87
# The integrity sentinel proved silent state corruption and recorded the
# offender in the quarantine file (resilience/integrity.py).
EXIT_CODE_STATE_CORRUPTION = 88
# A deliberate topology resize (resilience/elastic.py).
EXIT_CODE_ELASTIC_RESIZE = 89


class ExitCode(NamedTuple):
    code: int
    name: str
    meaning: str
    supervision: str  # what a supervising launcher should do with it


_RECORDS: "tuple[ExitCode, ...]" = (
    ExitCode(
        EXIT_CODE_OK,
        "EXIT_CODE_OK",
        "clean finish, or coordinated graceful preemption",
        "none (resume via the regular checkpoint if preempted)",
    ),
    ExitCode(
        EXIT_CODE_FAILURE,
        "EXIT_CODE_FAILURE",
        "crash (traceback), or a `host_loss` victim finishing the job",
        "none — a bug, not a fleet event",
    ),
    ExitCode(
        EXIT_CODE_USAGE,
        "EXIT_CODE_USAGE",
        "CLI usage error (bad flags, unknown rule ids, conflicting modes)",
        "none — fix the invocation",
    ),
    ExitCode(
        EXIT_CODE_STALL,
        "EXIT_CODE_STALL",
        "watchdog shot a wedged backend (§2.4)",
        "retry is reasonable; not a fleet event",
    ),
    ExitCode(
        EXIT_CODE_FLEET_PARTITION,
        "EXIT_CODE_FLEET_PARTITION",
        "peer died, local-shard emergency checkpoint secured",
        "`--supervise N`: relaunch at the surviving topology with "
        "`load_model=true load_args.load_path=<emergency_dir>`",
    ),
    ExitCode(
        EXIT_CODE_STATE_CORRUPTION,
        "EXIT_CODE_STATE_CORRUPTION",
        "the integrity sentinel proved silent state corruption; offender "
        "recorded in the quarantine file (§2.9)",
        "`--supervise N`: relaunch with the quarantine record's resume "
        "overrides, restoring the newest digest-verified checkpoint",
    ),
    ExitCode(
        EXIT_CODE_ELASTIC_RESIZE,
        "EXIT_CODE_ELASTIC_RESIZE",
        "deliberate topology resize: emergency snapshot secured and "
        "`resize_request.json` names the target device count (§2.14)",
        "`--supervise N --elastic`: relaunch at the requested topology with "
        "the emergency restore overrides; without `--elastic` it is final",
    ),
)

# A collision would mean two subsystems claiming one integer: checked over
# the record tuple, before a dict could silently drop a duplicate.
_codes = [record.code for record in _RECORDS]
_names = [record.name for record in _RECORDS]
if len(set(_codes)) != len(_codes):  # pragma: no cover - guarded by tests
    raise RuntimeError(f"duplicate exit codes in registry: {sorted(_codes)}")
if len(set(_names)) != len(_names):  # pragma: no cover - guarded by tests
    raise RuntimeError(f"duplicate exit-code names in registry: {_names}")

REGISTRY: Dict[int, ExitCode] = {record.code: record for record in _RECORDS}
