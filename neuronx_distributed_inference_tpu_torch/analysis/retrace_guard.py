"""Retrace guard: fail when a steady-state run builds a new program
(counterpart of the reference's ``analysis/retrace_guard.py``).

The reference runs a FIXED set of ahead-of-time compiled programs, one per
bucket; a silent re-trace in the decode loop recompiles mid-serve and
breaks the latency model without changing any output. The port's programs
are CUDA graphs, one per runner key (``runtime/model_runner.py``): here "a
trace" is the first run of a key, which captures its graph (on the CPU, or
with ``cuda_graphs=False``, the same first run without the capture, so the
seal behaves the same everywhere). The runners call :func:`note_trace` at
that point. Two consumers:

- :class:`RetraceGuard`: a context manager that records every trace inside
  its scope and (by default) raises :class:`RetraceError` on exit if any
  happened. A steady-state run wrapped in one proves that nothing was
  captured after warmup.
- *Sealing*: ``SubModelRunner.seal()`` / ``MixedStepRunner.seal()``
  (driven by ``Config.retrace_guard`` or ``NXDI_TPU_RETRACE_GUARD=1`` after
  ``warmup()``) arm the runner so that any later trace of a sealed program
  raises immediately, before the capture, even outside a guard scope.
"""

from __future__ import annotations

import os
from typing import List, Optional

__all__ = [
    "RetraceError",
    "RetraceGuard",
    "add_trace_listener",
    "guard_enabled",
    "note_trace",
    "remove_trace_listener",
]

_ACTIVE: List["RetraceGuard"] = []
# listeners called as fn(tag, sealed) on EVERY observed trace, forbidden
# post-seal ones included (counted before the RetraceError raises)
_LISTENERS: List = []


def add_trace_listener(fn) -> None:
    """Register ``fn(tag: str, sealed: bool)`` to observe every trace."""
    if fn not in _LISTENERS:
        _LISTENERS.append(fn)


def remove_trace_listener(fn) -> None:
    if fn in _LISTENERS:
        _LISTENERS.remove(fn)


class RetraceError(RuntimeError):
    """A program was built (a graph captured) where the contract forbids it."""


def guard_enabled(config=None) -> bool:
    """Config/env switch for post-warmup sealing (satisfied by either)."""
    if config is not None and getattr(config, "retrace_guard", False):
        return True
    return os.environ.get("NXDI_TPU_RETRACE_GUARD", "").lower() in ("1", "true")


def note_trace(tag: str, sealed: bool = False) -> None:
    """Record that the program ``tag`` is being built right now (a runner
    calls it once per new key, before the capture). Raises when the owning
    runner is sealed; otherwise the trace is recorded into every active
    :class:`RetraceGuard`."""
    for g in _ACTIVE:
        g.traces.append(tag)
    for listener in _LISTENERS:
        listener(tag, sealed)
    if sealed:
        raise RetraceError(
            f"{tag}: a new program (graph capture) after warmup()/seal(): a "
            f"steady-state capture breaks the fixed-program latency contract. A "
            f"new bucket, batch or pass length reached a sealed runner (or "
            f"warmup missed a bucket); check the call that triggered this."
        )


class RetraceGuard:
    """Context manager: collect (and by default forbid) traces in scope.

    ``allowed`` traces are tolerated before failing; ``fail=False`` makes
    it a pure observer (inspect ``.traces``)."""

    def __init__(self, fail: bool = True, allowed: int = 0):
        self.fail = fail
        self.allowed = allowed
        self.traces: List[str] = []

    def __enter__(self) -> "RetraceGuard":
        _ACTIVE.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> Optional[bool]:
        _ACTIVE.remove(self)
        if exc_type is None and self.fail and len(self.traces) > self.allowed:
            raise RetraceError(
                f"{len(self.traces)} trace(s) inside a RetraceGuard scope "
                f"(allowed {self.allowed}): {self.traces}: steady state must "
                f"replay the warmed programs."
            )
        return None
