"""Durable compute journal: what a compute did, on disk, so a client that
dies mid-compute can be resumed from it.

Counterpart of ``cubed_tpu/runtime/journal.py`` (its writer, callback and
loader; the fleet coordinator's control log and rendezvous come with the
fleet):

- an **append-only JSONL file** (``Spec(journal="/path/to/file.jsonl")``),
  one record per line, written by a :class:`JournalCallback` riding the
  ordinary compute-lifecycle events, so every executor journals alike;
- **fsync'd completion records**: a ``complete`` line is durable before
  anything depends on it (dispatch and decision lines are flushed, not
  fsync'd one by one);
- the **torn-line-tolerant loader** of the integrity manifests
  (``storage/integrity.py``): a crash mid-append tears at most the final
  line, which :func:`load_journal` skips; a lost record costs a re-run,
  never a wrong result;
- the **decision ring** mirrored while the journal is open
  (``observability.collect.add_decision_sink``): retries, quarantines,
  admission steps and the scheduler's mode land in the file too.

Resume (``compute(resume_from_journal=path)``) skips a task only when the
integrity scan verifies every output chunk of it **and** the journal
recorded it complete (``pipeline.ResumeState(journal=...)``): the journal
narrows the skip set, never widens it, so the result equals an
uninterrupted run's bit for bit. Re-runs append to the same file; the
loader folds every run's completions.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

from ..observability.metrics import get_registry
from .types import Callback

logger = logging.getLogger(__name__)

JOURNAL_VERSION = 1


class ComputeJournal:
    """Append-only JSONL writer with fsync'd load-bearing records.

    Thread-safe: task events come from the completion loop while decision
    mirrors come from any thread. ``append`` after ``close`` is a silent
    no-op (a late decision must not reopen the file)."""

    def __init__(self, path: str):
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()

    def append(self, kind: str, fsync: bool = True, **fields) -> bool:
        """Append one record; True once it is written (and, with ``fsync``,
        durable). Never raises: a full disk costs resume granularity, it
        must not fail the compute."""
        record = {"kind": kind, "t": time.time()}
        record.update(fields)
        try:
            line = (json.dumps(record, default=str) + "\n").encode()
        except (TypeError, ValueError):
            logger.warning("unserializable journal record dropped: %r", kind)
            return False
        with self._lock:
            if self._f is None:
                return False
            try:
                self._f.write(line)
                self._f.flush()
                if fsync:
                    os.fsync(self._f.fileno())
            except OSError as e:
                logger.warning("journal append failed (%s): %s", kind, e)
                return False
        get_registry().counter("journal_appends").inc()
        return True

    def close(self) -> None:
        with self._lock:
            f, self._f = self._f, None
        if f is None:
            return
        try:
            f.flush()
            os.fsync(f.fileno())
        except OSError:
            pass
        try:
            f.close()
        except OSError:
            pass


class JournalCallback(Callback):
    """Journals a compute's lifecycle through the callback events.

    ``compute_start`` records the plan's shape (tasks by op),
    ``dispatch``/``complete`` each task by ``(op, chunk key)``, ``decision``
    mirrors the decision ring, and ``compute_end`` seals the run. Attached
    by ``Plan.execute`` when ``Spec(journal=...)`` names a path. The device
    executor's units report no chunk key: their ``complete`` records carry
    none, and a resume does not count them."""

    def __init__(self, path: str):
        self.path = str(path)
        self._journal: Optional[ComputeJournal] = None
        self._sink_registered = False

    def on_compute_start(self, event) -> None:
        from ..observability.collect import add_decision_sink
        from .pipeline import iter_op_nodes

        self._journal = ComputeJournal(self.path)
        ops = {name: d["primitive_op"].num_tasks for name, d in iter_op_nodes(event.dag)}
        self._journal.append(
            "compute_start", version=JOURNAL_VERSION, compute_id=getattr(event, "compute_id", None),
            resume=bool(getattr(event, "resume", None)), tasks_total=sum(ops.values()), ops=ops,
        )
        add_decision_sink(self._on_decision)
        self._sink_registered = True
        logger.info("journaling compute to %s", self.path)

    def _on_decision(self, entry: dict) -> None:
        j = self._journal
        if j is not None:
            fields = dict(entry)
            # the ring's "kind" (retry, quarantine, ...) moves to "decision":
            # "kind" is the journal's own record type
            fields["decision"] = fields.pop("kind", None)
            j.append("decision", fsync=False, **fields)

    def on_task_start(self, event) -> None:
        j = self._journal
        if j is not None:
            j.append("dispatch", fsync=False, op=event.array_name, key=event.chunk_key, attempt=event.attempt)

    def on_task_end(self, event) -> None:
        j = self._journal
        if j is not None:
            # the load-bearing record: durable before the client can crash
            j.append("complete", op=event.array_name, key=event.chunk_key)

    def on_compute_end(self, event) -> None:
        from ..observability.collect import remove_decision_sink

        if self._sink_registered:
            remove_decision_sink(self._on_decision)
            self._sink_registered = False
        j = self._journal
        if j is not None:
            err = getattr(event, "error", None)
            j.append("compute_end", status="failed" if err is not None else "completed",
                     error=f"{type(err).__name__}: {err}" if err is not None else None)
            j.close()
            self._journal = None


def load_journal(path: str) -> dict:
    """Fold a journal file into a resume frontier.

    Returns ``{"path", "meta" (the latest compute_start record), "completed"
    (set of (op, chunk key)), "decisions" (list), "complete" (True when the
    latest run sealed with status completed), "dispatches", "bad_lines"}``.
    A torn or undecodable line is skipped and costs only its own record."""
    with open(path, "rb") as f:
        raw = f.read()
    meta: dict = {}
    completed: set = set()
    decisions: list = []
    complete = False
    dispatches = 0
    bad_lines = 0
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
            if not isinstance(doc, dict):
                raise ValueError("not an object")
        except (ValueError, UnicodeDecodeError):
            bad_lines += 1
            continue
        kind = doc.get("kind")
        if kind == "compute_start":
            meta = doc
            complete = False  # a new run opened; the previous seal is moot
        elif kind == "complete":
            op, key = doc.get("op"), doc.get("key")
            if isinstance(op, str) and isinstance(key, str):
                completed.add((op, key))
        elif kind == "dispatch":
            dispatches += 1
        elif kind == "decision":
            decisions.append(doc)
        elif kind == "compute_end":
            complete = doc.get("status") == "completed"
    if bad_lines:
        logger.warning("journal %s: skipped %d undecodable line(s) (their tasks will re-run)", path, bad_lines)
    return {"path": str(path), "meta": meta, "completed": completed, "decisions": decisions,
            "complete": complete, "dispatches": dispatches, "bad_lines": bad_lines}
