"""Durable, bounded run-history archive: the cross-run memory.
Counterpart of ``cubed_tpu/observability/runhistory.py``.

``analyze()`` explains one compute and forgets it; the ``TimeSeriesStore``
dies with the process. The run archive is what survives: an append-only
``runs.jsonl`` (under ``Spec(run_history=path)`` for plain computes; the
service's per-request records, :func:`record_request`, come with the
service) holding one
compact record per finished compute / service request — compute id,
tenant, the plan's structural fingerprint, wall clock, the ``analyze()``
bucket decomposition, metrics-delta highlights, and the
deadline/shed/error outcome.

The fingerprint is ``service/cache.py:structural_fingerprint``'s. A plan
that holds a tensor on the card (a block function whose closure captured
a CUDA tensor) is hashed from a copy of its bytes on the host, made only
here, when the archive is armed; the bytes copied are counted in
``fingerprint_device_bytes``.

Three consumers stand on it:

- **SLOs** (``observability/slo.py``): per-tenant error budgets are
  recomputed from the archive fold on service start, so a restart (or a
  SIGKILL) never resets a burned budget;
- **regression attribution** (``python -m cubed_tpu_torch.regress`` /
  ``analyze(baseline=...)``): a baseline record with the same plan
  fingerprint is diffed bucket-by-bucket to name what got slower;
- **operators**: the archive is plain JSONL — ``jq`` away.

Durability discipline mirrors ``runtime/journal.py``: records are
appended whole-line with an fsync, the loader tolerates a torn final
line (a crash mid-append costs exactly that line), and appends never
raise into the compute path. The archive is BOUNDED: when the active
file passes ``max_bytes`` it rotates to ``runs.jsonl.1`` (one previous
generation retained — worst case on disk is ~2x the bound), and the
loader folds the previous generation first so history stays contiguous
across a rotation.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .metrics import get_registry

logger = logging.getLogger(__name__)

#: archive file name under the run-history / service directory
RUNS_FILENAME = "runs.jsonl"

#: default rotation bound for the active file (env override below); one
#: rotated generation is kept, so the archive occupies <= ~2x this
DEFAULT_MAX_ARCHIVE_BYTES = 8 * 1024 * 1024

MAX_BYTES_ENV_VAR = "CUBED_TPU_TORCH_RUN_HISTORY_MAX_BYTES"

#: digest size caps: a record must stay compact (the archive is read
#: whole on every fold)
MAX_PER_OP = 16
MAX_STRAGGLERS = 5


def archive_path(history_dir: str) -> str:
    return os.path.join(history_dir, RUNS_FILENAME)


def _resolve_max_bytes(max_bytes: Optional[int]) -> int:
    if max_bytes is not None:
        return int(max_bytes)
    raw = os.environ.get(MAX_BYTES_ENV_VAR)
    if raw:
        try:
            return int(raw)
        except ValueError:
            logger.warning(
                "ignoring non-integer %s=%r", MAX_BYTES_ENV_VAR, raw
            )
    return DEFAULT_MAX_ARCHIVE_BYTES


class RunHistory:
    """Append-only, size-rotated ``runs.jsonl`` writer.

    Same contract as :class:`~cubed_tpu_torch.runtime.journal.ComputeJournal`:
    ``append`` never raises (a full disk degrades observability, it must
    not fail the compute), every record is flushed + fsync'd before
    ``append`` returns, and a reader may fold the file at any moment."""

    def __init__(self, history_dir: str, max_bytes: Optional[int] = None):
        self.history_dir = history_dir
        self.path = archive_path(history_dir)
        self.max_bytes = max(4096, _resolve_max_bytes(max_bytes))
        self._lock = threading.Lock()
        self._file = None
        try:
            os.makedirs(history_dir, exist_ok=True)
            self._file = open(self.path, "ab")
        except OSError:
            logger.exception(
                "could not open run archive %s; records will be dropped",
                self.path,
            )

    def append(self, record: Dict[str, Any], fsync: bool = True) -> bool:
        """Write one record (with rotation); True when it landed."""
        if self._file is None:
            return False
        record.setdefault("ts", time.time())
        try:
            line = json.dumps(record, default=str) + "\n"
        except (TypeError, ValueError):
            logger.exception("unserializable run-history record dropped")
            return False
        data = line.encode()
        with self._lock:
            try:
                if self._file.tell() + len(data) > self.max_bytes:
                    self._rotate_locked()
                self._file.write(data)
                self._file.flush()
                if fsync:
                    os.fsync(self._file.fileno())
            except (OSError, ValueError):
                logger.exception(
                    "run-history append failed (%s)", self.path
                )
                return False
        get_registry().counter("run_history_appends").inc()
        return True

    def _rotate_locked(self) -> None:
        """Active file -> ``runs.jsonl.1`` (replacing any previous
        generation), then reopen fresh. Bounds the archive at ~2x
        ``max_bytes`` while keeping at least one full generation of
        history for the SLO fold and baseline search."""
        try:
            self._file.close()
        except OSError:
            pass
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            logger.exception("run-history rotation failed (%s)", self.path)
        self._file = open(self.path, "ab")
        get_registry().counter("run_history_rotations").inc()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


#: open writers, one per directory — the service and Plan.execute share
#: a handle so rotation bookkeeping stays coherent within a process
_histories: Dict[str, RunHistory] = {}
_histories_lock = threading.Lock()


def history_for(history_dir: str, max_bytes: Optional[int] = None) -> RunHistory:
    key = os.path.abspath(history_dir)
    with _histories_lock:
        h = _histories.get(key)
        if h is None or h._file is None:
            h = RunHistory(history_dir, max_bytes=max_bytes)
            _histories[key] = h
        return h


def load_runs(history_dir: str) -> Tuple[List[dict], int]:
    """Fold the archive: ``(records, bad_lines)``, oldest first.

    Reads the rotated generation (``runs.jsonl.1``) before the active
    file so history is contiguous across a rotation. Torn-line tolerant:
    a line that does not parse (the crash-interrupted tail, a truncated
    rotation boundary) is counted and skipped — it costs only itself."""
    records: List[dict] = []
    bad = 0
    path = archive_path(history_dir)
    for p in (path + ".1", path):
        try:
            with open(p, "rb") as f:
                data = f.read()
        except OSError:
            continue
        for raw in data.splitlines():
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw)
            except (ValueError, UnicodeDecodeError):
                bad += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                bad += 1
    if bad:
        get_registry().counter("run_history_bad_lines").inc(bad)
    return records, bad


# ----------------------------------------------------------------------
# record assembly
# ----------------------------------------------------------------------


_METRIC_HIGHLIGHTS = (
    "tasks_completed", "task_retries", "task_errors", "bytes_read",
    "bytes_written", "peer_bytes_fetched", "stragglers_detected",
    "store_throttled",
)


def _metrics_digest(stats: Optional[dict]) -> Optional[dict]:
    if not isinstance(stats, dict):
        return None
    out = {}
    for k in _METRIC_HIGHLIGHTS:
        v = stats.get(k)
        if isinstance(v, (int, float)) and v:
            out[k] = v
    return out or None


def _analysis_digest(data: dict) -> dict:
    """The compact slice of an ``analyze()`` report a record carries:
    the bucket attribution, a bounded per-op busy digest, and the top
    stragglers (op + worker + slowdown factor)."""
    per_op = {}
    rows = sorted(
        (data.get("per_op") or {}).items(),
        key=lambda kv: -(kv[1].get("busy_s") or 0.0),
    )[:MAX_PER_OP]
    for name, row in rows:
        per_op[name] = {
            "busy_s": round(row.get("busy_s") or 0.0, 6),
            "tasks": row.get("tasks"),
            "stragglers": row.get("stragglers"),
            "buckets": {
                k: round(v, 6)
                for k, v in (row.get("buckets") or {}).items()
                if v and v > 1e-6
            },
        }
    stragglers = [
        {
            "op": s.get("op"),
            "worker": s.get("worker"),
            "factor": (
                round(s["factor"], 3)
                if isinstance(s.get("factor"), (int, float)) else None
            ),
            "duration_s": (
                round(s["duration_s"], 6)
                if isinstance(s.get("duration_s"), (int, float)) else None
            ),
        }
        for s in (data.get("stragglers") or [])[:MAX_STRAGGLERS]
    ]
    return {
        "buckets": {
            k: round(v, 6)
            for k, v in (data.get("attribution") or {}).items()
            if v and v > 1e-6
        },
        "attribution_coverage": data.get("attribution_coverage"),
        "per_op": per_op,
        "stragglers": stragglers,
    }


def record_compute(
    history_dir: str,
    *,
    compute_id: str,
    dag=None,
    error: Optional[BaseException] = None,
    stats: Optional[dict] = None,
    collector=None,
    wall_clock_s: Optional[float] = None,
    tenant: Optional[str] = None,
) -> Optional[dict]:
    """Assemble + append one compute record; returns the record (or
    None when nothing could be written). Never raises — archive failure
    must not fail the compute that just finished."""
    try:
        rec: Dict[str, Any] = {
            "kind": "compute",
            "ts": time.time(),
            "compute_id": compute_id,
            "ok": error is None,
            "error": type(error).__name__ if error is not None else None,
        }
        if tenant is not None:
            rec["tenant"] = tenant
        if dag is not None:
            try:
                from ..service.cache import structural_fingerprint

                fp, _ = structural_fingerprint(dag)
                rec["fingerprint"] = fp
            except Exception:
                rec["fingerprint"] = None
        if collector is not None:
            try:
                from .analytics import analyze

                data = analyze(collector).to_dict()
                rec.update(_analysis_digest(data))
                if wall_clock_s is None:
                    wall_clock_s = data.get("wall_clock_s")
            except Exception:
                # an empty trace (zero-task compute) or a collector that
                # failed mid-flight: the record still lands, just without
                # the bucket decomposition
                logger.debug(
                    "run-history: no analysis for %s", compute_id,
                    exc_info=True,
                )
        if wall_clock_s is not None:
            rec["wall_clock_s"] = round(float(wall_clock_s), 6)
        digest = _metrics_digest(stats)
        if digest:
            rec["metrics"] = digest
        history_for(history_dir).append(rec)
        return rec
    except Exception:
        logger.exception("run-history record assembly failed")
        return None


def record_request(
    history_dir: str,
    *,
    request_id: str,
    tenant: str,
    status: str,
    latency_s: Optional[float] = None,
    fingerprint: Optional[str] = None,
    compute_id: Optional[str] = None,
    error: Optional[str] = None,
    deadline_missed: bool = False,
    shed: bool = False,
    request_class: Optional[str] = None,
) -> Optional[dict]:
    """One service-request record (the SLO fold's raw material)."""
    try:
        rec: Dict[str, Any] = {
            "kind": "request",
            "ts": time.time(),
            "request_id": request_id,
            "tenant": tenant,
            "status": status,
            "ok": status == "completed",
        }
        if latency_s is not None:
            rec["latency_s"] = round(float(latency_s), 6)
        if fingerprint is not None:
            rec["fingerprint"] = fingerprint
        if compute_id is not None:
            rec["compute_id"] = compute_id
        if error is not None:
            rec["error"] = error
        if deadline_missed:
            rec["deadline_missed"] = True
        if shed:
            rec["shed"] = True
        if request_class is not None:
            rec["request_class"] = request_class
        history_for(history_dir).append(rec)
        return rec
    except Exception:
        logger.exception("run-history request record failed")
        return None


def find_baseline(
    records: List[dict],
    fingerprint: Optional[str],
    before_ts: Optional[float] = None,
    exclude_compute_id: Optional[str] = None,
) -> Optional[dict]:
    """Latest OK compute record matching ``fingerprint`` (strictly
    earlier than ``before_ts`` when given) — the regression baseline."""
    best = None
    for rec in records:
        if rec.get("kind") != "compute" or not rec.get("ok"):
            continue
        if exclude_compute_id and rec.get("compute_id") == exclude_compute_id:
            continue
        if fingerprint is not None and rec.get("fingerprint") != fingerprint:
            continue
        if before_ts is not None and (rec.get("ts") or 0) >= before_ts:
            continue
        if not rec.get("buckets"):
            continue  # a record without a decomposition cannot be diffed
        if best is None or (rec.get("ts") or 0) > (best.get("ts") or 0):
            best = rec
    return best
