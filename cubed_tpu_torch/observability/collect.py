"""Whole-compute trace collection: one clock-aligned Perfetto timeline.

Counterpart of ``cubed_tpu/observability/collect.py``. ``TraceCollector``
is a callback that merges, for one compute:

- **the lifecycle** -- the compute span, one span per operation;
- **task spans** -- every task's body plus the sub-spans its task scope
  buffered where it ran (storage reads and writes, kernel apply --
  ``accounting.TaskScope.add_span``), shipped back in the task stats dict;
  failed attempts ship their buffer on the exception itself
  (``record_failed_task``) and out-of-band repairs hand theirs to a ring
  (``record_repair_spans``), so both still land on the timeline. Span
  recording is armed only while a collector is attached (or
  ``CUBED_TPU_TORCH_TASK_SPANS=1``): unobserved computes record nothing;
- **scheduler decisions** (``record_decision``) -- the device executor's
  segment memory aborts, the device profiler's start and stop, device
  memory readings, failed tasks -- as instants on a ``scheduler`` lane;
- **memory samples** (``record_sample``) as Perfetto counter tracks on a
  ``memory`` lane;
- **the dispatch profiler's samples** (``dispatchprofile.py``), when it was
  armed for the compute, as instants on a ``dispatch profile`` lane.

For the analytics (``analytics.analyze``) a collector also keeps the
compute's op-level dependency skeleton (:meth:`TraceCollector.op_graph`,
from the finalized DAG at compute start) and finds the chunk-level edges
the dataflow scheduler recorded (:func:`record_chunk_graph`,
:meth:`TraceCollector.chunk_graph`).

Task timestamps from another process are **clock-aligned** before export:
a handshake offset when the executor stats carry one per worker, else a
min-skew estimate from the shipping latency of the process's own results;
in-process tasks need none. Each process gets its own lane.

``export()`` writes ``trace-<compute_id>.json``.

The decision, sample and out-of-band rings are process-global (bounded
deques), with the same known limitation as the metrics registry: computes
running concurrently in one process see each other's entries.
"""

from __future__ import annotations

import logging
import os
import statistics
import threading
import time
from collections import deque
from typing import Optional

from . import clock, logs
from .events import EventLogCallback
from .metrics import get_registry
from .tracer import Tracer

logger = logging.getLogger(__name__)

#: bounded process-global rings (see module docstring)
MAX_DECISIONS = 4096
MAX_SAMPLES = 4096
MAX_OOB_TASKS = 1024
#: chunk graphs retained for post-compute analytics (one per recent
#: compute) and the per-graph task bound — a million-task graph must not
#: pin a million edge lists in the ring; truncation is counted, not silent
MAX_CHUNK_GRAPHS = 4
MAX_GRAPH_TASKS = 50_000

_ring_lock = threading.Lock()
_decisions: deque = deque(maxlen=MAX_DECISIONS)
_samples: deque = deque(maxlen=MAX_SAMPLES)
#: out-of-band task records: failed attempts (salvaged off the exception)
#: and repairs — work with no TaskEndEvent to ride, merged into the trace
#: at export like the decision ring
_oob_tasks: deque = deque(maxlen=MAX_OOB_TASKS)
#: chunk-level dependency edges per recent compute (the dataflow scheduler
#: records them while spans are armed); the flight recorder embeds them in
#: its manifest so ``analytics.analyze`` can walk the true critical path
_chunk_graphs: deque = deque(maxlen=MAX_CHUNK_GRAPHS)


#: consumers of decision entries beyond the bounded ring: the compute
#: journal (runtime/journal.py) registers here, so a crashed client still
#: leaves the decision timeline on disk
_decision_sinks: list = []


def add_decision_sink(fn) -> None:
    """Register a callable receiving every decision entry (a plain dict)."""
    with _ring_lock:
        if fn not in _decision_sinks:
            _decision_sinks.append(fn)


def remove_decision_sink(fn) -> None:
    with _ring_lock:
        try:
            _decision_sinks.remove(fn)
        except ValueError:
            pass


def record_decision(kind: str, **attrs) -> None:
    """Record one scheduler/controller decision (timestamped, correlated).

    Cheap (a dict append under a lock) and bounded; called from the
    executors and the device profiler callbacks. Each sink gets a copy; a
    sink that raises is logged and never fails the decision's site."""
    entry = {"ts": clock.now(), "kind": kind}
    cid = logs.current_compute_id()
    if cid is not None:
        entry["compute_id"] = cid
    if attrs:
        entry.update(attrs)
    with _ring_lock:
        _decisions.append(entry)
        sinks = list(_decision_sinks)
    for fn in sinks:
        try:
            fn(dict(entry))
        except Exception:
            logger.exception("decision sink failed")


def record_sample(**attrs) -> None:
    """Record one memory reading (``rss`` and ``pressure`` become counter
    tracks; a ``worker`` key gives it a lane of its own)."""
    entry = {"ts": clock.now()}
    entry.update(attrs)
    with _ring_lock:
        _samples.append(entry)


def record_failed_task(op, chunk, attempt, exc) -> None:
    """Salvage a failed attempt's span buffer for the merged trace.

    A raising task never produces a ``TaskEndEvent``, but
    ``execute_with_stats`` attaches the task scope's stats (spans, timing,
    pid/worker label) to the exception before it propagates (the attribute
    survives pickling). The sequential executor calls this once per failed
    task, so the failing attempt lands on its lane with ``error=True``. A
    no-op for exceptions carrying no stats (spans disarmed, or a failure
    outside the task body)."""
    stats = getattr(exc, "cubed_tpu_torch_task_stats", None)
    if not isinstance(stats, dict):
        return
    dropped = stats.get("spans_dropped") or 0
    if dropped:
        get_registry().counter("spans_dropped").inc(dropped)
    entry = {
        "ts": clock.now(),
        "op": op,
        "chunk": chunk,
        "attempt": attempt,
        "start": stats.get("function_start_tstamp"),
        "end": stats.get("function_end_tstamp"),
        "pid": stats.get("pid"),
        "worker": stats.get("worker"),
        "spans": stats.get("spans") or [],
        "error_type": stats.get("error_type") or type(exc).__name__,
        #: emit a task-level error span at merge, not just the sub-spans
        "task": True,
    }
    with _ring_lock:
        _oob_tasks.append(entry)


def record_repair_spans(chunk, store, scope_stats: dict) -> None:
    """Ship an out-of-band repair's span buffer to the trace.

    A repair runs in its own task scope but has no task event to ride, so
    its spans (a ``recompute_repair`` wrapper plus the storage IO inside
    it) are handed straight to this ring. Only the sub-spans are merged
    (``task=False``): the wrapper span already brackets the whole repair."""
    spans = scope_stats.get("spans") or []
    if not spans:
        return  # spans disarmed: nothing to place on the trace
    from .accounting import get_process_label

    entry = {
        "ts": clock.now(),
        "op": "recompute_repair",
        "chunk": chunk,
        "store": store,
        "attempt": 0,
        "start": None,
        "end": None,
        "pid": os.getpid(),
        "worker": get_process_label(),
        "spans": spans,
        "task": False,
    }
    with _ring_lock:
        _oob_tasks.append(entry)


def decisions_since(t0: float) -> list:
    with _ring_lock:
        return [d for d in _decisions if d["ts"] >= t0]


def samples_since(t0: float) -> list:
    with _ring_lock:
        return [s for s in _samples if s["ts"] >= t0]


def oob_tasks_since(t0: float) -> list:
    with _ring_lock:
        return [t for t in _oob_tasks if t["ts"] >= t0]


def record_chunk_graph(edges: dict, compute_id: Optional[str] = None) -> None:
    """Retain one compute's chunk-level dependency edges for analytics.

    ``edges`` maps ``"<op>\\t<chunk>"`` task keys to lists of the task keys
    they depend on (``ChunkGraph.edges_by_key``). Graphs beyond
    ``MAX_GRAPH_TASKS`` tasks are truncated to the bound (counted in
    ``chunk_graph_tasks_truncated``): the analytics fall back to the
    op-graph approximation for the missing tail."""
    if compute_id is None:
        compute_id = logs.current_compute_id()
    truncated = 0
    if len(edges) > MAX_GRAPH_TASKS:
        truncated = len(edges) - MAX_GRAPH_TASKS
        edges = dict(list(edges.items())[:MAX_GRAPH_TASKS])
        get_registry().counter("chunk_graph_tasks_truncated").inc(truncated)
        logger.warning(
            "chunk graph for compute %s exceeds the %d-task analytics "
            "bound; %d task(s) truncated (critical-path extraction falls "
            "back to op-level edges for them)",
            compute_id, MAX_GRAPH_TASKS, truncated,
        )
    entry = {
        "ts": clock.now(),
        "compute_id": compute_id,
        "edges": edges,
        "truncated": truncated,
    }
    with _ring_lock:
        _chunk_graphs.append(entry)


def chunk_graph_for(
    compute_id: Optional[str] = None, since: Optional[float] = None,
) -> Optional[dict]:
    """The most recent recorded chunk graph matching ``compute_id`` (or,
    when None, the newest one recorded at/after ``since``); None when the
    compute ran without the dataflow scheduler or unobserved."""
    with _ring_lock:
        entries = list(_chunk_graphs)
    for entry in reversed(entries):
        if compute_id is not None and entry["compute_id"] == compute_id:
            return entry["edges"]
    if compute_id is not None and since is None:
        return None
    for entry in reversed(entries):
        # graphs recorded outside a compute scope (a scheduler driven
        # directly): the newest graph in the window
        if entry["compute_id"] is None and (
            since is None or entry["ts"] >= since
        ):
            return entry["edges"]
    return None


def op_dependencies(dag) -> dict:
    """``op -> sorted producing ops`` of a plan's (port) ``Dag``: an op's
    predecessors through its input arrays, ops without a primitive op
    left out."""
    nodes = dag.nodes

    def real_op(name) -> bool:
        d = nodes[name]
        return d.get("type") == "op" and d.get("primitive_op") is not None

    graph = {}
    for name in nodes:
        if not real_op(name):
            continue
        preds = set()
        for pred in dag.predecessors(name):
            if nodes[pred].get("type") == "op":
                if real_op(pred):
                    preds.add(pred)
                continue
            preds.update(p for p in dag.predecessors(pred) if real_op(p))
        graph[name] = sorted(preds)
    return graph


class TraceCollector(EventLogCallback):
    """Merge lifecycle spans, task spans, decisions and memory samples into
    a single clock-aligned Perfetto trace for one compute.

    Parameters
    ----------
    trace_dir : str | None
        Directory to write ``trace-<compute_id>.json`` into at compute end
        (None disables the automatic export; ``export()`` still works).
    straggler_factor / straggler_min_s / straggler_min_tasks
        Live straggler watch: once an op has ``straggler_min_tasks``
        completed tasks, any task slower than ``straggler_factor`` x the
        op's rolling median (and ``straggler_min_s``) is flagged as it
        lands — a structured warning, the ``stragglers_detected`` counter,
        and a ``scheduler`` instant in the trace.
    max_task_records
        Bound on retained per-task records; overflow is counted and
        reported, never silent.
    offset_threshold_s
        Minimum magnitude for a latency-estimated clock offset to be
        applied (same-host processes share a clock; sub-threshold
        estimates are measurement noise, not skew).
    """

    def __init__(
        self,
        trace_dir: Optional[str] = ".",
        straggler_factor: float = 3.0,
        straggler_min_s: float = 0.05,
        straggler_min_tasks: int = 5,
        max_task_records: int = 100_000,
        offset_threshold_s: float = 0.05,
    ):
        super().__init__()
        self.trace_dir = trace_dir
        self.straggler_factor = straggler_factor
        self.straggler_min_s = straggler_min_s
        self.straggler_min_tasks = straggler_min_tasks
        self.max_task_records = max_task_records
        self.offset_threshold_s = offset_threshold_s
        self.compute_id: str = "unknown"
        self.executor_stats: Optional[dict] = None
        self.error = None
        self.trace_path: Optional[str] = None
        self._t0: float = 0.0
        self._records: list[dict] = []
        self.records_dropped = 0
        self._peaks: dict[str, int] = {}
        self._durations: dict[str, deque] = {}
        #: worker/pid key -> smallest observed (result-receipt - worker-end)
        #: delta, the latency-bounded clock-offset estimate
        self._raw_offsets: dict[str, float] = {}
        #: op -> sorted producing-op names, captured from the finalized dag
        #: at compute start: the op-level skeleton analytics falls back to
        #: when no chunk graph was recorded
        self._op_graph: dict[str, list] = {}
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------

    def on_compute_start(self, event) -> None:
        super().on_compute_start(event)
        cid = getattr(event, "compute_id", None)
        self.compute_id = cid or f"c-pid{os.getpid()}-{int(time.time())}"
        self.executor_stats = None
        self.error = None
        self.trace_path = None
        self._t0 = time.time()
        self._records = []
        self.records_dropped = 0
        self._peaks = {}
        self._durations = {}
        self._raw_offsets = {}
        self._op_graph = {}
        try:
            self._op_graph = op_dependencies(event.dag)
        except Exception:  # introspection must never fail a compute
            logger.exception("op-graph capture failed; analytics degrades")

    def op_graph(self) -> dict:
        """``op -> [producing op, ...]`` for the compute's finalized dag."""
        return {k: list(v) for k, v in self._op_graph.items()}

    def chunk_graph(self) -> Optional[dict]:
        """This compute's recorded chunk-level edges (dataflow scheduler,
        spans armed), or None — see :func:`chunk_graph_for`."""
        return chunk_graph_for(self.compute_id, since=self._t0)

    def on_task_end(self, event) -> None:
        # deliberately NOT super(): fold into bounded records instead of
        # retaining every TaskEndEvent (EventLogCallback keeps them all)
        start = event.function_start_tstamp
        end = event.function_end_tstamp
        if start is None or end is None:
            return
        if event.peak_measured_mem_end is not None:
            peak = self._peaks.get(event.array_name, 0)
            if event.peak_measured_mem_end > peak:
                self._peaks[event.array_name] = event.peak_measured_mem_end
        dropped = getattr(event, "spans_dropped", None)
        if dropped:
            get_registry().counter("spans_dropped").inc(dropped)
        rec = {
            "op": event.array_name,
            "chunk": event.chunk_key,
            "attempt": event.attempt,
            "executor": event.executor,
            "start": start,
            "end": end,
            "pid": getattr(event, "pid", None),
            "worker": getattr(event, "worker", None),
            "spans": getattr(event, "spans", None) or [],
            "spans_dropped": dropped or 0,
            # the task's dispatch ledger (runtime/types.py; None until the
            # fleet fills it)
            "dispatch": getattr(event, "dispatch", None),
        }
        with self._lock:
            if len(self._records) >= self.max_task_records:
                self.records_dropped += 1
            else:
                self._records.append(rec)
            self._note_offset(rec, event.task_result_tstamp)
        self._straggler_watch(rec)

    def on_compute_end(self, event) -> None:
        super().on_compute_end(event)
        self.executor_stats = getattr(event, "executor_stats", None)
        self.error = getattr(event, "error", None)
        if self.records_dropped:
            logger.warning(
                "trace collector dropped %d task record(s) beyond the "
                "%d-record bound; the exported trace is truncated",
                self.records_dropped, self.max_task_records,
            )
        if self.trace_dir is not None:
            try:
                self.trace_path = self.export()
            except OSError:
                logger.exception(
                    "failed to export merged trace for compute %s",
                    self.compute_id,
                )

    # -- clock alignment -----------------------------------------------

    @staticmethod
    def _offset_key(rec: dict) -> str:
        if rec.get("worker"):
            return str(rec["worker"])
        if rec.get("pid") and rec["pid"] != os.getpid():
            return f"pid-{rec['pid']}"
        return "client"

    def _note_offset(self, rec: dict, result_tstamp) -> None:
        key = self._offset_key(rec)
        if key == "client":
            return
        if result_tstamp is None or rec["end"] is None:
            return
        # result receipt (client clock) minus task end (worker clock) =
        # true offset + shipping latency; the minimum over many tasks
        # approaches the true offset from above
        raw = result_tstamp - rec["end"]
        prev = self._raw_offsets.get(key)
        if prev is None or raw < prev:
            self._raw_offsets[key] = raw

    def clock_offsets(self) -> dict:
        """Per-worker clock corrections applied at export: seconds to ADD
        to that process's timestamps to land on the client timeline, with
        the estimate's source (``handshake``/``latency``/``local``)."""
        out: dict = {"client": {"offset": 0.0, "source": "local"}}
        workers = (self.executor_stats or {}).get("workers") or {}
        keys = set(self._raw_offsets)
        with self._lock:
            for rec in self._records:
                keys.add(self._offset_key(rec))
        for rec in oob_tasks_since(self._t0):
            # failed attempts off a process that never completed a task
            # still need its correction looked up
            keys.add(self._offset_key(rec))
        for key in keys:
            if key == "client":
                continue
            row = workers.get(key) if isinstance(workers, dict) else None
            handshake = (row or {}).get("clock_offset")
            if handshake is not None:
                out[key] = {
                    "offset": float(handshake),
                    "rtt": (row or {}).get("clock_rtt"),
                    "source": "handshake",
                }
                continue
            raw = self._raw_offsets.get(key)
            if raw is not None and abs(raw) >= self.offset_threshold_s:
                out[key] = {"offset": float(raw), "source": "latency"}
            else:
                out[key] = {"offset": 0.0, "source": "local"}
        return out

    # -- straggler watch -----------------------------------------------

    def _straggler_watch(self, rec: dict) -> None:
        dur = rec["end"] - rec["start"]
        dq = self._durations.get(rec["op"])
        if dq is None:
            dq = self._durations[rec["op"]] = deque(maxlen=512)
        if len(dq) >= self.straggler_min_tasks:
            median = statistics.median(dq)
            if dur > max(self.straggler_min_s, self.straggler_factor * median):
                get_registry().counter("stragglers_detected").inc()
                record_decision(
                    "straggler",
                    op=rec["op"],
                    chunk=rec["chunk"],
                    duration_s=round(dur, 6),
                    op_median_s=round(median, 6),
                    worker=rec.get("worker") or rec.get("pid"),
                )
                logger.warning(
                    "straggler: task %s of %s took %.3fs (%.1fx the op "
                    "median %.3fs) on %s",
                    rec["chunk"], rec["op"], dur,
                    dur / median if median else float("inf"), median,
                    rec.get("worker") or rec.get("pid") or "client",
                )
        dq.append(dur)

    def stragglers(self, top: int = 10) -> list[dict]:
        """Post-hoc straggler table over ALL retained records: tasks slower
        than ``straggler_factor`` x their op's full-compute median."""
        with self._lock:
            records = list(self._records)
        by_op: dict[str, list] = {}
        for r in records:
            by_op.setdefault(r["op"], []).append(r)
        out = []
        for op, recs in by_op.items():
            durs = [r["end"] - r["start"] for r in recs]
            if len(durs) < 2:
                continue
            median = statistics.median(durs)
            for r, d in zip(recs, durs):
                if d > max(self.straggler_min_s, self.straggler_factor * median):
                    out.append(
                        {
                            "op": op,
                            "chunk": r["chunk"],
                            "duration_s": d,
                            "op_median_s": median,
                            "factor": d / median if median else None,
                            "worker": r.get("worker") or r.get("pid"),
                        }
                    )
        out.sort(key=lambda s: -(s["factor"] or 0))
        return out[:top]

    # -- export ----------------------------------------------------------

    def peak_measured_mem_by_op(self) -> dict[str, int]:
        return dict(self._peaks)

    def merged_tracer(self) -> Tracer:
        """Build the merged, clock-aligned event set as a :class:`Tracer`."""
        tr = Tracer(max_events=2_000_000)
        end_default = self.end_tstamp or time.time()
        if self.start_tstamp is not None:
            attrs = {"compute_id": self.compute_id}
            if self.error is not None:
                attrs["error"] = True
                attrs["error_type"] = type(self.error).__name__
            tr.add_complete(
                "compute", self.start_tstamp, end_default, lane="compute",
                cat="compute", **attrs,
            )
        for name, timing in self.op_timings.items():
            if timing.start_tstamp is None:
                continue
            tr.add_complete(
                name, timing.start_tstamp,
                timing.end_tstamp or end_default,
                lane="operations", cat="operation",
                num_tasks=timing.num_tasks,
            )
        offsets = {k: v["offset"] for k, v in self.clock_offsets().items()}

        def lane_of(rec: dict) -> str:
            if rec.get("worker"):
                return f"worker {rec['worker']}"
            if rec.get("pid") and rec["pid"] != os.getpid():
                return f"worker pid-{rec['pid']}"
            return "client tasks"

        def add_sub_spans(rec: dict, lane: str, off: float) -> None:
            for s in rec["spans"]:
                attrs = dict(s.get("attrs") or {})
                attrs["chunk_of_task"] = rec["chunk"]
                tr.add_complete(
                    s["name"], s["ts"] + off, s["ts"] + s["dur"] + off,
                    lane=lane, cat=s.get("cat", "span"), **attrs,
                )

        with self._lock:
            records = list(self._records)
        for rec in records:
            off = offsets.get(self._offset_key(rec), 0.0)
            lane = lane_of(rec)
            extra = {}
            if rec.get("dispatch"):
                extra["dispatch"] = rec["dispatch"]
            tr.add_complete(
                rec["op"], rec["start"] + off, rec["end"] + off,
                lane=lane, cat="task", chunk=rec["chunk"],
                attempt=rec["attempt"], executor=rec["executor"],
                **extra,
            )
            add_sub_spans(rec, lane, off)
        for rec in oob_tasks_since(self._t0):
            # failed attempts and repairs: no TaskEndEvent ever
            # fired for these, so they merge straight off the ring —
            # clock-corrected and lane-assigned exactly like completions
            off = offsets.get(self._offset_key(rec), 0.0)
            lane = lane_of(rec)
            if rec.get("task") and rec.get("start") is not None:
                tr.add_complete(
                    rec["op"], rec["start"] + off,
                    (rec.get("end") or rec["start"]) + off,
                    lane=lane, cat="task", chunk=rec["chunk"],
                    attempt=rec["attempt"], error=True,
                    error_type=rec.get("error_type"),
                )
            add_sub_spans(rec, lane, off)
        for d in decisions_since(self._t0):
            attrs = {k: v for k, v in d.items() if k not in ("ts", "kind")}
            tr.instant(d["kind"], lane="scheduler", ts=d["ts"], **attrs)
        from .dispatchprofile import profile_for

        prof = profile_for(self.compute_id)
        if prof is not None:
            # the dispatch profiler's leaf reservoir as instants, aligned
            # with the task lanes the client dispatched
            for ts, leaf in prof.lane_samples():
                tr.instant(leaf, lane="dispatch profile", ts=ts)
        for s in samples_since(self._t0):
            # samples that carry a worker name get their own memory lane
            mlane = (
                f"memory {s['worker']}" if s.get("worker") else "memory"
            )
            if s.get("rss") is not None:
                tr.add_counter("rss_bytes", s["ts"], s["rss"], lane=mlane)
            if s.get("pressure") is not None:
                tr.add_counter(
                    "mem_pressure", s["ts"], s["pressure"], lane=mlane
                )
        return tr

    def export(self, path: Optional[str] = None) -> str:
        """Write the merged Perfetto trace; returns the path written."""
        if path is None:
            path = os.path.join(
                self.trace_dir or ".", f"trace-{self.compute_id}.json"
            )
        return self.merged_tracer().export_chrome(path)
