"""Fault-tolerance layer (counterpart of stoix_tpu/resilience): the typed
errors, the exit-code registry (`exit_codes`), the update guard (`guards`),
fault injection (`faultinject`), graceful preemption (`preemption`), the
deadline watchdogs (`watchdog`), the launch preflight (`preflight`), the
state-integrity sentinel (`integrity`), Sebulba's actor supervisor
(`supervisor`), the fleet across processes (`fleet`) and the resize protocol
(`elastic`)."""

from stoix_tpu_torch.resilience.errors import (
    BackendUnavailableError,
    CheckpointIntegrityError,
    CompileStallError,
    ComponentFailure,
    ConfigValidationError,
    DivergenceError,
    EvaluatorStallError,
    InjectedFault,
    PreflightError,
    ResourcePreflightError,
    StateCorruptionError,
)
from stoix_tpu_torch.resilience.preemption import PreemptionHandler
from stoix_tpu_torch.resilience.watchdog import Watchdog

__all__ = ["BackendUnavailableError", "CheckpointIntegrityError", "CompileStallError",
           "ComponentFailure", "ConfigValidationError", "DivergenceError",
           "EvaluatorStallError", "InjectedFault", "PreemptionHandler", "PreflightError",
           "ResourcePreflightError", "StateCorruptionError", "Watchdog"]
