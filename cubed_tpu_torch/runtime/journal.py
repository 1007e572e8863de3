"""Durable compute journal: what a compute did, on disk, so a client that
dies mid-compute can be resumed from it.

Counterpart of ``cubed_tpu/runtime/journal.py``: the compute journal's
writer, callback and loader, and the fleet coordinator's control log and
rendezvous advertisement (live coordinator failover, below):

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


# ----------------------------------------------------------------------
# control-plane snapshot log (live coordinator failover)
# ----------------------------------------------------------------------

CONTROL_VERSION = 1
CONTROL_FILE = "control.jsonl"
RENDEZVOUS_FILE = "rendezvous.json"

#: bound on decision records retained by ``load_control`` — the successor
#: replays these into its decision ring for the stitched two-epoch
#: timeline; an unbounded replay would let a long-lived prior epoch flood
#: the successor's bounded ring
CONTROL_DECISIONS_KEEP = 100


def control_log_path(control_dir: str) -> str:
    return os.path.join(str(control_dir), CONTROL_FILE)


def rendezvous_path(control_dir: str) -> str:
    return os.path.join(str(control_dir), RENDEZVOUS_FILE)


class ControlLog:
    """The coordinator's epoch-stamped control-plane snapshot.

    A minimal, bounded record of the fleet's control state — registered
    workers + their session tokens, the per-task dispatch frontier, chunk
    locations, and the connectivity decision mirror — appended under the
    same journal discipline as :class:`ComputeJournal` (append-only JSONL,
    load-bearing records fsync'd, torn-line-tolerant fold). A successor
    coordinator pointed at the same ``control_dir`` folds this file with
    :func:`load_control` and re-adopts the running fleet instead of
    cold-starting one; the sibling ``rendezvous.json`` (atomic whole-file
    replace) advertises the live epoch + address so workers that lost
    their socket can find the successor.
    """

    def __init__(self, control_dir: str):
        self.dir = str(control_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.path = control_log_path(self.dir)
        self._journal = ComputeJournal(self.path)

    # -- load-bearing (fsync'd) records --------------------------------

    def record_epoch(self, epoch: int, addr) -> bool:
        """One fsync'd line per coordinator incarnation: the epoch fence
        everything else hangs off. Durable before the rendezvous file
        advertises it."""
        return self._journal.append(
            "epoch", version=CONTROL_VERSION, epoch=int(epoch),
            addr=list(addr),
        )

    def record_worker(self, name: str, token: str, nthreads: int,
                      peer_addr=None, address=None, pid=None) -> bool:
        """A registered worker + its session token — what a successor
        needs to recognize the reconnect handshake as a resume, not an
        impostor."""
        return self._journal.append(
            "worker", name=name, token=token, nthreads=int(nthreads or 1),
            peer_addr=list(peer_addr) if peer_addr else None,
            address=list(address) if address else None,
            pid=pid,
        )

    def record_worker_gone(self, name: str) -> bool:
        return self._journal.append("worker_gone", name=name)

    # -- frontier records (flushed, not individually fsync'd: losing one
    # costs at most one idempotent re-run, never correctness) -----------

    def record_dispatch(self, task_id: int, tag, worker: str) -> None:
        self._journal.append(
            "dispatch", fsync=False, task_id=int(task_id),
            tag=list(tag) if tag else None, worker=worker,
        )

    def record_done(self, task_id: int) -> None:
        self._journal.append("done", fsync=False, task_id=int(task_id))

    def record_chunk_locations(self, worker: str, produced) -> None:
        for item in produced or ():
            try:
                store, key, nbytes = item[0], item[1], int(item[2])
            except (TypeError, IndexError, ValueError):
                continue
            self._journal.append(
                "chunk_loc", fsync=False, worker=worker,
                store=str(store), key=str(key), nbytes=nbytes,
            )

    def record_decision(self, epoch: int, entry: dict) -> None:
        fields = dict(entry)
        fields["decision"] = fields.pop("kind", None)
        self._journal.append(
            "decision", fsync=False, epoch=int(epoch), **fields
        )

    # -- the successor advertisement -----------------------------------

    def advertise(self, epoch: int, addr) -> None:
        write_rendezvous(self.dir, epoch, addr)

    def close(self) -> None:
        self._journal.close()


def write_rendezvous(control_dir: str, epoch: int, addr) -> None:
    """Atomically (re)write the rendezvous advertisement: the live
    coordinator's epoch + dial address. Workers re-read this file inside
    their reconnect loop; a torn write must never be observable, hence
    write-tmp + rename."""
    path = rendezvous_path(control_dir)
    doc = {"epoch": int(epoch), "addr": list(addr), "t": time.time()}
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        logger.warning("could not write rendezvous file %s: %s", path, e)


def read_rendezvous(path: str) -> Optional[dict]:
    """The current advertisement, or None (missing/garbage file — the
    reconnect loop just keeps dialing its last-known address)."""
    try:
        with open(path, "r") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    epoch = doc.get("epoch")
    addr = doc.get("addr")
    if not isinstance(epoch, int) or not (
        isinstance(addr, (list, tuple)) and len(addr) == 2
    ):
        return None
    return {"epoch": epoch, "addr": (str(addr[0]), int(addr[1]))}


def load_control(path: str) -> dict:
    """Fold a control log into the successor's adoption state.

    Returns ``{"epoch" (latest recorded, -1 when none — a fresh dir),
    "addr", "workers" ({name: record}), "inflight" ({task_id: {"tag",
    "worker"}}), "chunk_locations" ([{worker, store, key, nbytes}]),
    "decisions" (bounded, newest last), "bad_lines"}``. Same torn-line
    tolerance as every journal: a lost ``done`` line means one idempotent
    task re-runs; a lost ``worker`` line means one worker re-registers
    fresh instead of resuming."""
    epoch = -1
    addr = None
    workers: dict = {}
    inflight: dict = {}
    chunk_locations: list = []
    decisions: list = []
    bad_lines = 0
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        raw = b""
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
        if kind == "epoch":
            e = doc.get("epoch")
            if isinstance(e, int):
                epoch = max(epoch, e)
                addr = doc.get("addr")
        elif kind == "worker":
            name = doc.get("name")
            if isinstance(name, str) and isinstance(doc.get("token"), str):
                workers[name] = doc
        elif kind == "worker_gone":
            name = doc.get("name")
            workers.pop(name, None)
            inflight = {
                tid: rec for tid, rec in inflight.items()
                if rec.get("worker") != name
            }
        elif kind == "dispatch":
            tid = doc.get("task_id")
            if isinstance(tid, int):
                inflight[tid] = {
                    "tag": doc.get("tag"), "worker": doc.get("worker"),
                }
        elif kind == "done":
            inflight.pop(doc.get("task_id"), None)
        elif kind == "chunk_loc":
            chunk_locations.append(doc)
        elif kind == "decision":
            decisions.append(doc)
    if bad_lines:
        logger.warning(
            "control log %s: skipped %d undecodable line(s)", path, bad_lines,
        )
    return {
        "path": str(path),
        "epoch": epoch,
        "addr": addr,
        "workers": workers,
        "inflight": inflight,
        "chunk_locations": chunk_locations,
        "decisions": decisions[-CONTROL_DECISIONS_KEEP:],
        "bad_lines": bad_lines,
    }
