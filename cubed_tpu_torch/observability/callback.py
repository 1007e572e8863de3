"""Observability callbacks: the tracer bridge and the compute aggregator.

Counterpart of ``cubed_tpu/observability/callback.py``.
``TracingCallback`` turns the executor lifecycle (compute / operation /
task events) into tracer spans and exports a Perfetto-loadable
``trace.json`` at compute end. Task spans use the timestamps measured where
the task ran. On the device executor an op's task span is host time around
its queued launches (apportioned by task count within a segment), not
device time: that is the device profiler's (``profiler.py``).

``_ComputeAggregator`` is attached to every compute by ``Plan.execute``: it
folds per-task stats (completion counts, storage bytes measured inside task
scopes) into the process metrics registry and builds the per-op summary
that ``ComputeEndEvent.executor_stats`` carries.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from ..runtime.types import Callback, TaskEndEvent
from .events import EventLogCallback
from .metrics import get_registry
from .tracer import Tracer

logger = logging.getLogger(__name__)

#: RSS-growth attribution is allocator-granular (arena growth, page
#: faults, first-task lazy imports can add ~20 MB): a per-task delta
#: within this many bytes of the projection is measurement noise, not a
#: mis-modelled op — don't flag it. Real mis-modelling at production chunk
#: sizes (hundreds of MB) clears this easily.
_MEM_OVER_NOISE_FLOOR = 64 * 1024 * 1024


class TracingCallback(Callback):
    """Record one tracer span per task/operation/compute; export on end.

    Parameters
    ----------
    trace_path : str | None
        Where to write the Chrome-trace/Perfetto JSON at compute end
        (default ``trace.json``; None disables export).
    jsonl_path : str | None
        Stream every finished span to this JSONL file as it happens.
    tracer : Tracer | None
        Use an existing tracer instead of creating one.
    """

    def __init__(
        self,
        trace_path: Optional[str] = "trace.json",
        jsonl_path: Optional[str] = None,
        tracer: Optional[Tracer] = None,
    ):
        self.trace_path = trace_path
        self._owns_tracer = tracer is None
        self.tracer = tracer if tracer is not None else Tracer(jsonl_path=jsonl_path)
        self.last_executor_stats: Optional[dict] = None
        self._compute_start: Optional[float] = None
        self._op_starts: dict[str, float] = {}
        self._op_num_tasks: dict[str, int] = {}

    def on_compute_start(self, event) -> None:
        from ..core.plan import iter_op_nodes

        if self._owns_tracer:
            # a reused callback starts each compute's trace fresh (a shared
            # tracer is the caller's to manage — they may want one timeline)
            self.tracer.clear()
        self._compute_start = time.time()
        self._op_starts = {}
        self._op_num_tasks = {}
        n_ops = sum(1 for _ in iter_op_nodes(event.dag))
        self.tracer.instant("compute_start", lane="compute", ops=n_ops)

    def on_operation_start(self, event) -> None:
        self._op_starts[event.name] = time.time()
        self._op_num_tasks[event.name] = event.num_tasks

    def on_operation_end(self, event) -> None:
        start = self._op_starts.pop(event.name, None)
        if start is None:
            return
        self.tracer.add_complete(
            event.name,
            start,
            time.time(),
            lane="operations",
            cat="operation",
            num_tasks=event.num_tasks or self._op_num_tasks.get(event.name, 0),
        )

    def on_task_start(self, event) -> None:
        self.tracer.instant(
            f"start:{event.array_name}",
            lane=f"op:{event.array_name}",
            chunk=event.chunk_key,
            attempt=event.attempt,
            backup=event.backup,
        )

    def on_task_end(self, event: TaskEndEvent) -> None:
        now = time.time()
        start = event.function_start_tstamp or event.task_create_tstamp or now
        end = event.function_end_tstamp or event.task_result_tstamp or now
        attrs = {
            "op": event.array_name,
            "chunk": event.chunk_key,
            "attempt": event.attempt,
            "executor": event.executor,
            "num_tasks": event.num_tasks,
        }
        if event.peak_measured_mem_end is not None:
            attrs["peak_measured_mem"] = event.peak_measured_mem_end
        if event.bytes_read:
            attrs["bytes_read"] = event.bytes_read
        if event.bytes_written:
            attrs["bytes_written"] = event.bytes_written
        self.tracer.add_complete(
            event.array_name,
            start,
            end,
            lane=f"op:{event.array_name}",
            cat="task",
            **attrs,
        )

    def on_compute_end(self, event) -> None:
        self.last_executor_stats = getattr(event, "executor_stats", None)
        if self._compute_start is not None:
            self.tracer.add_complete(
                "compute",
                self._compute_start,
                time.time(),
                lane="compute",
                cat="compute",
            )
        if self.trace_path is not None:
            try:
                self.tracer.export_chrome(self.trace_path)
            except OSError:
                logger.exception("failed to export trace to %s", self.trace_path)
        self.tracer.close()


class _ComputeAggregator(EventLogCallback):
    """Internal per-compute metrics aggregation (attached by Plan.execute).

    A view over the same event stream every observer shares
    (:class:`EventLogCallback` collects plan rows and op timings) that
    additionally folds per-task stats into the process registry — the ONLY
    place task-scope storage bytes (measured where the task ran) enter the
    registry.

    Because it rides on EVERY compute, it must stay O(ops), not O(tasks):
    task events are folded into per-op dict aggregates on arrival, never
    retained (``self.events`` stays empty, unlike user-facing event logs).
    """

    def __init__(self):
        super().__init__()
        self.registry = get_registry()
        self._tasks: dict[str, int] = {}
        self._bytes_read: dict[str, int] = {}
        self._bytes_written: dict[str, int] = {}
        self._peaks: dict[str, int] = {}
        #: per-op max of the memory guard's per-task reading
        #: (``TaskEndEvent.guard_mem_peak`` of an event with a chunk key: on
        #: a CUDA device the allocator's peak over the task's start or its
        #: RSS growth, the larger)
        self._guard_peaks: dict[str, int] = {}

    # note: no on_task_start override — the tasks_started counter lives in
    # runtime.utils.fire_task_start, so executors can skip building start
    # events entirely when nothing observes them

    def on_task_end(self, event: TaskEndEvent) -> None:
        # deliberately NOT super(): fold incrementally instead of retaining
        # the event (a million-task compute must not hold a million events)
        reg = self.registry
        name = event.array_name
        reg.counter("tasks_completed").inc(event.num_tasks)
        self._tasks[name] = self._tasks.get(name, 0) + event.num_tasks
        if event.bytes_read:
            reg.counter("bytes_read").inc(event.bytes_read)
            self._bytes_read[name] = (
                self._bytes_read.get(name, 0) + event.bytes_read
            )
        if event.bytes_written:
            reg.counter("bytes_written").inc(event.bytes_written)
            self._bytes_written[name] = (
                self._bytes_written.get(name, 0) + event.bytes_written
            )
        if event.chunks_read:
            reg.counter("chunks_read").inc(event.chunks_read)
        if event.chunks_written:
            reg.counter("chunks_written").inc(event.chunks_written)
        if event.virtual_bytes_read:
            reg.counter("virtual_bytes_read").inc(event.virtual_bytes_read)
        if event.counters:
            # named scope counts measured where the task ran
            for cname, n in event.counters.items():
                if n:
                    reg.counter(cname).inc(n)
        if event.peak_measured_mem_end is not None:
            self._peaks[name] = max(
                self._peaks.get(name, 0), event.peak_measured_mem_end
            )
        if event.guard_mem_peak is not None and event.chunk_key is not None:
            # a task's own reading: the device executor's events carry the
            # reading of a whole segment or eager op (no chunk key), which
            # is no task's and is not judged against a task's projection
            self._guard_peaks[name] = max(
                self._guard_peaks.get(name, 0), event.guard_mem_peak
            )

    def peak_measured_mem_by_op(self) -> dict[str, int]:
        # the base class derives this from retained events; we keep it live
        return dict(self._peaks)

    def on_operation_end(self, event) -> None:
        super().on_operation_end(event)
        timing = self.op_timings.get(event.name)
        if timing is not None and timing.wall_clock is not None:
            self.registry.histogram("op_wall_clock_s").observe(
                timing.wall_clock
            )

    def summary(self) -> dict:
        """The ``per_op`` block for ``executor_stats``: one row per op that
        ran, joining event-stream aggregates with the plan projections."""
        rows = {r["array_name"]: r for r in self.projected_vs_measured()}
        per_op = {}
        for name, timing in self.op_timings.items():
            row = rows.get(name, {})
            guard_peak = self._guard_peaks.get(name)
            projected = row.get("projected_mem", 0)
            per_op[name] = {
                "tasks": self._tasks.get(name, 0),
                "wall_clock_s": timing.wall_clock,
                "projected_mem": projected,
                "peak_measured_mem": row.get("peak_measured_mem"),
                "bytes_read": self._bytes_read.get(name, 0),
                "bytes_written": self._bytes_written.get(name, 0),
                "mem_utilization": row.get("projected_mem_utilization"),
                # the memory guard's per-task attribution: the only
                # measured number comparable to projected_mem (VmHWM-based
                # peak_measured_mem carries the whole process footprint)
                "guard_peak_mem": guard_peak,
                "mem_over_projected": bool(
                    guard_peak is not None
                    and projected
                    and guard_peak > projected + _MEM_OVER_NOISE_FLOOR
                ),
            }
        return {"per_op": per_op} if per_op else {}

    def on_compute_end(self, event) -> None:
        super().on_compute_end(event)
        # surface mis-modelled extra_projected_mem without anyone having to
        # open the Perfetto trace: one line naming every op whose measured
        # per-task peak exceeded its plan-time projection. Read from the
        # per_op rows executor_stats carries (Plan.execute put this
        # aggregator's summary there), so the warning and the
        # mem_over_projected flag can never disagree
        per_op = (getattr(event, "executor_stats", None) or {}).get("per_op")
        if per_op is None:
            per_op = self.summary().get("per_op", {})
        over = [
            f"{name} (measured {row['guard_peak_mem']} > "
            f"projected {row['projected_mem']})"
            for name, row in per_op.items()
            if row.get("mem_over_projected")
        ]
        if over:
            logger.warning(
                "memory projection exceeded for %d op(s): %s — consider "
                "raising extra_projected_mem for these ops (or allowed_mem/"
                "rechunking if the guard also fired)",
                len(over), "; ".join(sorted(over)),
            )
