"""Byte accounting for storage IO, with per-task attribution.

Counterpart of ``cubed_tpu/observability/accounting.py``. The storage layer
calls ``record_bytes_read`` / ``record_bytes_written`` on every chunk
transfer, with the bytes as stored. Attribution rules:

- Inside an active **task scope** (``task_scope()``, entered by
  ``execute_with_stats`` around every task body), bytes accumulate on the
  scope object and ride back in the task's stats dict to its
  ``TaskEndEvent``.
- Outside any task scope (the device executor's whole-array preloads and
  flushes, plan-level metadata), bytes go straight to the process registry.

The two paths are exclusive by construction, so summing task-event bytes
into the registry (``callback._ComputeAggregator``) never double-counts.

A bounded per-store breakdown (``store_totals()``) is kept either way;
past ``MAX_TRACKED_STORES`` stores it aggregates under ``"<other>"``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from . import clock
from .metrics import get_registry

#: cap on per-store breakdown entries (plans create one temp store per
#: intermediate array; an unbounded dict would grow with every plan)
MAX_TRACKED_STORES = 128

#: cap on spans buffered per task: a pathological task (thousands of chunk
#: reads) must not ship a megabyte of span payload with its result — excess
#: spans drop with a count, surfaced as the ``spans_dropped`` counter
MAX_TASK_SPANS = 128

#: operator override for span recording ("1" forces it on everywhere, "0"
#: off; also how a compute's arming reaches child processes)
SPANS_ENV_VAR = "CUBED_TPU_TORCH_TASK_SPANS"

#: process-global arming state (None = defer to env/default-off). Span
#: recording is opt-in per compute: ``Plan.execute`` arms it only while a
#: ``TraceCollector`` is attached, so an unobserved compute records no span
#: dicts and ships no span payload with its tasks
_spans_armed: Optional[bool] = None

_tls = threading.local()

_store_lock = threading.Lock()
_store_totals: Dict[str, list] = {}

#: a human-readable label for THIS process (None for the client) — stamped
#: on task stats so merged traces can give each worker its own lane and
#: look up its clock offset
_process_label: Optional[str] = None


def set_process_label(label: Optional[str]) -> None:
    global _process_label
    _process_label = label


def get_process_label() -> Optional[str]:
    return _process_label


def spans_enabled() -> bool:
    """Whether ``scope_span`` records anything (env > armed > off)."""
    env = os.environ.get(SPANS_ENV_VAR)
    if env:
        return env == "1"
    if _spans_armed is not None:
        return _spans_armed
    return False


def spans_wire() -> bool:
    """The client's resolved arming, attached to every fleet task message
    so pre-started workers record spans exactly when the client collects
    them (and stop when it doesn't)."""
    return spans_enabled()


def arm_spans_from_wire(armed) -> None:
    """Fleet-worker side: mirror the arming a task message carried."""
    global _spans_armed
    _spans_armed = None if armed is None else bool(armed)


class spans_scoped:
    """Arm span recording for a ``with`` block (``Plan.execute`` uses this
    while a trace collector is attached); ``None`` is a no-op. With
    ``export_env`` the env var is set so child processes spawned inside
    the block inherit the arming, unless the operator already set it, in
    which case their override passes through untouched."""

    def __init__(self, armed: Optional[bool] = None, export_env: bool = False):
        self._armed = armed
        self._export_env = export_env

    def __enter__(self):
        if self._armed is None:
            return None
        global _spans_armed
        self._prev = _spans_armed
        self._prev_env = os.environ.get(SPANS_ENV_VAR)
        _spans_armed = bool(self._armed)
        if self._export_env and self._armed and self._prev_env is None:
            os.environ[SPANS_ENV_VAR] = "1"
        return self._armed

    def __exit__(self, *exc) -> None:
        if self._armed is None:
            return
        global _spans_armed
        _spans_armed = self._prev
        if self._export_env:
            if self._prev_env is None:
                os.environ.pop(SPANS_ENV_VAR, None)
            else:
                os.environ[SPANS_ENV_VAR] = self._prev_env


class TaskScope:
    """Accumulates IO (and named event counts) attributed to one task body."""

    __slots__ = (
        "bytes_read",
        "bytes_written",
        "chunks_read",
        "chunks_written",
        "virtual_bytes_read",
        "counters",
        "spans",
        "spans_dropped",
    )

    def __init__(self):
        self.bytes_read = 0
        self.bytes_written = 0
        self.chunks_read = 0
        self.chunks_written = 0
        self.virtual_bytes_read = 0
        #: named counts recorded inside this scope, riding the stats dict
        #: exactly like the byte counters
        self.counters: Dict[str, int] = {}
        #: bounded buffer of spans recorded inside this task body (storage
        #: reads and writes, kernel apply), measured on THIS process's
        #: clock and shipped back in the stats dict like the byte counters
        #: (merged by observability/collect.py)
        self.spans: list = []
        self.spans_dropped = 0

    def add_span(
        self, name: str, start: float, end: float, cat: str = "span", **attrs
    ) -> None:
        if len(self.spans) >= MAX_TASK_SPANS:
            self.spans_dropped += 1
            return
        span = {"name": name, "ts": start, "dur": max(0.0, end - start),
                "cat": cat}
        if attrs:
            span["attrs"] = attrs
        self.spans.append(span)

    def stats(self) -> dict:
        return {
            "bytes_read": self.bytes_read,
            "bytes_written": self.bytes_written,
            "chunks_read": self.chunks_read,
            "chunks_written": self.chunks_written,
            "virtual_bytes_read": self.virtual_bytes_read,
            "counters": dict(self.counters),
            "spans": list(self.spans),
            "spans_dropped": self.spans_dropped,
        }


class task_scope:
    """Context manager establishing a per-task accounting scope.

    Scopes nest (a task body running a nested compute): each byte is
    attributed to the INNERMOST scope only, never folded outward — the
    inner task's event already carries those bytes into client-side
    aggregation, so folding them into the outer task's stats as well would
    count them twice.
    """

    def __enter__(self) -> TaskScope:
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._scope = TaskScope()
        stack.append(self._scope)
        return self._scope

    def __exit__(self, *exc) -> None:
        _tls.stack.pop()


def current_scope() -> Optional[TaskScope]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class scope_span:
    """Time a block of code as a span on the current task scope.

    A no-op (no timestamps taken, nothing allocated beyond this object)
    when no task scope is active — metadata/plan-level IO stays unspanned —
    or when span recording is disarmed (``spans_enabled``): a compute with
    no trace collector attached pays nothing for span bookkeeping.
    The ``attrs`` dict is mutable until exit, so callers can attach
    results measured inside the block (byte counts, retry counts). A block
    that raises still records its span, closed at the raise instant with
    ``error=True`` — failures are when the trace matters most.
    """

    __slots__ = ("name", "cat", "attrs", "_scope", "_start")

    def __init__(self, name: str, cat: str = "span", **attrs):
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self._scope: Optional[TaskScope] = None

    def __enter__(self) -> "scope_span":
        self._scope = current_scope() if spans_enabled() else None
        if self._scope is not None:
            self._start = clock.now()
        return self

    def __exit__(self, exc_type, *exc) -> None:
        scope = self._scope
        if scope is None:
            return
        if exc_type is not None:
            self.attrs["error"] = True
            self.attrs["error_type"] = exc_type.__name__
        scope.add_span(
            self.name, self._start, clock.now(), cat=self.cat, **self.attrs
        )


def _track_store(store: str, read: int, written: int) -> None:
    key = str(store)
    with _store_lock:
        entry = _store_totals.get(key)
        if entry is None:
            if len(_store_totals) >= MAX_TRACKED_STORES:
                key = "<other>"
                entry = _store_totals.get(key)
            if entry is None:
                entry = _store_totals[key] = [0, 0]
        entry[0] += read
        entry[1] += written


def record_bytes_read(store: str, n: int) -> None:
    scope = current_scope()
    if scope is not None:
        scope.bytes_read += n
        scope.chunks_read += 1
    else:
        reg = get_registry()
        reg.counter("bytes_read").inc(n)
        reg.counter("chunks_read").inc()
    _track_store(store, n, 0)


def record_bytes_written(store: str, n: int) -> None:
    scope = current_scope()
    if scope is not None:
        scope.bytes_written += n
        scope.chunks_written += 1
    else:
        reg = get_registry()
        reg.counter("bytes_written").inc(n)
        reg.counter("chunks_written").inc()
    _track_store(store, 0, n)


def record_scoped_counter(name: str, n: int = 1) -> None:
    """Count a named event with per-task attribution.

    Inside a task scope the count rides the task's stats dict and the
    compute aggregator folds it into the registry; outside any scope it
    goes straight to the process registry."""
    scope = current_scope()
    if scope is not None:
        scope.counters[name] = scope.counters.get(name, 0) + n
    else:
        get_registry().counter(name).inc(n)


def record_virtual_read(n: int) -> None:
    """A read served by a virtual (never-materialized) array: logical bytes,
    no IO — tracked separately from ``bytes_read`` so that stays an IO
    number, but scope-attributed like real IO."""
    scope = current_scope()
    if scope is not None:
        scope.virtual_bytes_read += n
    else:
        get_registry().counter("virtual_bytes_read").inc(n)


def store_totals() -> Dict[str, dict]:
    """Per-store {bytes_read, bytes_written} seen by THIS process."""
    with _store_lock:
        return {
            k: {"bytes_read": r, "bytes_written": w}
            for k, (r, w) in _store_totals.items()
        }


def reset_store_totals() -> None:
    with _store_lock:
        _store_totals.clear()
