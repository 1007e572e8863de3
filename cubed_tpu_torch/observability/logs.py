"""Correlated structured logging: every log line attributable to its task.

Counterpart of ``cubed_tpu/observability/logs.py``. Three contextvars --
``compute_id``, ``op``, ``chunk`` -- are set where the work happens
(``Plan.execute`` around a compute, ``execute_with_stats`` around a task
body), so a record emitted under them joins back to the compute, op and
chunk that produced it. A child process inherits the compute id through
``CUBED_TPU_TORCH_COMPUTE_ID``.

- :class:`ContextFilter` injects ``record.compute_id`` / ``record.op`` /
  ``record.chunk``;
- :class:`StructuredFormatter` writes one JSON object per line;
- :class:`RecentRecordsHandler` keeps a bounded ring of the last records,
  installed once per process on the ``cubed_tpu_torch`` logger.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import threading
from collections import deque
from contextlib import contextmanager
from typing import Optional

#: how the compute id crosses the spawn boundary into child processes
COMPUTE_ID_ENV_VAR = "CUBED_TPU_TORCH_COMPUTE_ID"

compute_id_var: contextvars.ContextVar = contextvars.ContextVar(
    "cubed_tpu_torch_compute_id", default=None
)
op_var: contextvars.ContextVar = contextvars.ContextVar(
    "cubed_tpu_torch_op", default=None
)
chunk_var: contextvars.ContextVar = contextvars.ContextVar(
    "cubed_tpu_torch_chunk", default=None
)


def current_compute_id() -> Optional[str]:
    """The active compute id: contextvar first, spawn-time env second."""
    cid = compute_id_var.get()
    if cid is not None:
        return cid
    return os.environ.get(COMPUTE_ID_ENV_VAR) or None


#: serializes env-var export/restore across concurrently running computes
_env_export_lock = threading.Lock()
#: compute ids currently exported by a LIVE scope in this process — so an
#: exiting scope can tell a live sibling's id (restore it) from a dead
#: one (drop it) when exits happen out of order
_live_exports: set = set()
#: every id any scope in this process ever exported — a "previous" value
#: NOT in here came from outside (an operator/parent-process pin) and is
#: always restorable
_ever_exported: set = set()


@contextmanager
def compute_scope(compute_id: str, export_env: bool = False):
    """Bind the compute id for a block (and, with ``export_env``, for every
    child process spawned inside it).

    The contextvar is per-thread, so concurrent computes on different
    threads see only their own id. The env
    export is inherently process-global: concurrent exporters are
    last-writer-wins (children spawned meanwhile inherit whichever id is
    current), but exit is guarded two ways — a scope only touches the
    variable if it still holds ITS OWN id, and it only restores the
    previous value when that value is still a live scope's export (or an
    external pin); a finished sibling's id is dropped, never resurrected.
    """
    token = compute_id_var.set(compute_id)
    with _env_export_lock:
        prev_env = os.environ.get(COMPUTE_ID_ENV_VAR)
        if export_env:
            os.environ[COMPUTE_ID_ENV_VAR] = compute_id
            _live_exports.add(compute_id)
            if len(_ever_exported) >= 4096:
                # bounded: after a reset, an out-of-order exit degrades to
                # the old restore-the-previous behavior at worst
                _ever_exported.clear()
                _ever_exported.update(_live_exports)
            _ever_exported.add(compute_id)
    try:
        yield
    finally:
        compute_id_var.reset(token)
        if export_env:
            with _env_export_lock:
                _live_exports.discard(compute_id)
                if os.environ.get(COMPUTE_ID_ENV_VAR) == compute_id:
                    restorable = prev_env is not None and (
                        prev_env in _live_exports
                        or prev_env not in _ever_exported
                    )
                    if restorable:
                        os.environ[COMPUTE_ID_ENV_VAR] = prev_env
                    else:
                        os.environ.pop(COMPUTE_ID_ENV_VAR, None)


@contextmanager
def task_context(op: Optional[str] = None, chunk: Optional[str] = None,
                 compute_id: Optional[str] = None):
    """Bind op/chunk (and optionally compute id) around one task body."""
    tokens = []
    if compute_id is not None:
        tokens.append((compute_id_var, compute_id_var.set(compute_id)))
    if op is not None:
        tokens.append((op_var, op_var.set(op)))
    if chunk is not None:
        tokens.append((chunk_var, chunk_var.set(chunk)))
    try:
        yield
    finally:
        for var, token in reversed(tokens):
            var.reset(token)


class ContextFilter(logging.Filter):
    """Inject the correlation contextvars into every record that passes."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.compute_id = current_compute_id() or "-"
        record.op = op_var.get() or "-"
        record.chunk = chunk_var.get() or "-"
        return True


class StructuredFormatter(logging.Formatter):
    """One JSON object per line; joinable against the merged trace."""

    def format(self, record: logging.LogRecord) -> str:
        return json.dumps(_record_to_dict(record), default=str)


def _record_to_dict(record: logging.LogRecord) -> dict:
    out = {
        "ts": record.created,
        "level": record.levelname,
        "logger": record.name,
        "message": record.getMessage(),
        "compute_id": getattr(record, "compute_id", None)
        or current_compute_id() or "-",
        "op": getattr(record, "op", None) or op_var.get() or "-",
        "chunk": getattr(record, "chunk", None) or chunk_var.get() or "-",
        "pid": record.process,
    }
    if record.exc_info and record.exc_info[0] is not None:
        out["exc_type"] = record.exc_info[0].__name__
    return out


class RecentRecordsHandler(logging.Handler):
    """Bounded ring buffer of structured records (the last-N log window).
    Never raises into the logging call."""

    def __init__(self, capacity: int = 500):
        super().__init__()
        self._records: deque = deque(maxlen=capacity)
        self.addFilter(ContextFilter())

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._records.append(_record_to_dict(record))
        except Exception:
            pass  # an observer must never fail the caller

    def records(self, n: Optional[int] = None) -> list:
        items = list(self._records)
        return items if n is None else items[-n:]


_install_lock = threading.Lock()
_ring: Optional[RecentRecordsHandler] = None


def install(capacity: int = 500) -> RecentRecordsHandler:
    """Attach the ring handler to the ``cubed_tpu_torch`` logger (idempotent).

    Records from every ``cubed_tpu_torch.*`` module logger propagate
    here, whatever handlers the application configured.
    """
    global _ring
    with _install_lock:
        if _ring is None:
            _ring = RecentRecordsHandler(capacity=capacity)
            logging.getLogger("cubed_tpu_torch").addHandler(_ring)
        return _ring


def recent_records(n: Optional[int] = None) -> list:
    """The last structured records captured in this process ([] before
    :func:`install` has run)."""
    return _ring.records(n) if _ring is not None else []


def basic_structured_config(level: int = logging.INFO) -> None:
    """Convenience: root handler emitting JSON lines with correlation ids
    (what the fleet worker entry point uses with ``--log-json``)."""
    handler = logging.StreamHandler()
    handler.setFormatter(StructuredFormatter())
    handler.addFilter(ContextFilter())
    root = logging.getLogger()
    root.addHandler(handler)
    root.setLevel(level)
