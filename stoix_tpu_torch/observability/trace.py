"""Span and annotation seams (counterpart of
stoix_tpu/observability/trace.py's `span` and `annotate`).

The JAX package records host spans only while `logger.telemetry.enabled` is
on; the port refuses that key (utils/logger.py), so here both seams record
nothing: `span(name, **args)` is an empty context manager and
`annotate(name)` returns its function unchanged. The call sites mirror the
JAX package's, so a later port of the trace recorder fills them in.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable


def span(name: str, **args: Any):
    """A host phase's span: records nothing (telemetry is not ported)."""
    del name, args
    return contextlib.nullcontext()


def annotate(name: str) -> Callable[[Callable], Callable]:
    """A taxonomy tag for a learner function: returns it unchanged."""
    del name
    return lambda fn: fn
