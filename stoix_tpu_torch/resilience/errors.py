"""Typed failures (counterpart of stoix_tpu/resilience/errors.py).

Only `ConfigValidationError` is ported so far: `parallel/distributed.py`
raises it for a half-configured multi-process launch. This module imports
nothing from the rest of the package.
"""

from __future__ import annotations


class ConfigValidationError(RuntimeError):
    """Config cross-validation (arch × system × network × env) failed before
    any device work. Carries ALL findings, not just the first, so one preflight
    run fixes the whole config."""

    def __init__(self, findings: list):
        self.findings = list(findings)
        lines = "\n".join(f"  - {f}" for f in self.findings)
        super().__init__(
            f"config validation failed with {len(self.findings)} finding(s):\n{lines}"
        )
