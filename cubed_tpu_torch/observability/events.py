"""A single ordered event stream for one compute.

Counterpart of ``cubed_tpu/observability/events.py``. ``EventLogCallback``
is the shared base for every observer that needs the compute's history: it
captures the plan's projections at compute start, the full task-event list,
and per-operation start/end timing. The extensions (``HistoryCallback``,
``TimelineVisualizationCallback``) are thin views over this one stream.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from ..runtime.types import Callback, TaskEndEvent


@dataclass
class PlanRow:
    """Plan-time projection for one op (from the finalized dag)."""

    array_name: str
    op_name: str
    projected_mem: int
    reserved_mem: int
    num_tasks: int


@dataclass
class OpTiming:
    name: str
    num_tasks: int = 0
    start_tstamp: Optional[float] = None
    end_tstamp: Optional[float] = None

    @property
    def wall_clock(self) -> Optional[float]:
        if self.start_tstamp is None or self.end_tstamp is None:
            return None
        return self.end_tstamp - self.start_tstamp


class EventLogCallback(Callback):
    """Collects the full lifecycle of one compute.

    Attributes after (or during) a compute:

    - ``plan``: list of :class:`PlanRow` (one per op node)
    - ``events``: list of :class:`TaskEndEvent` in completion order
    - ``op_timings``: dict op name -> :class:`OpTiming`
    - ``start_tstamp`` / ``end_tstamp``: compute bounds (client clock)
    """

    def __init__(self):
        self.plan: list[PlanRow] = []
        self.events: list[TaskEndEvent] = []
        self.op_timings: dict[str, OpTiming] = {}
        self.start_tstamp: Optional[float] = None
        self.end_tstamp: Optional[float] = None

    # -- lifecycle -----------------------------------------------------

    def on_compute_start(self, event) -> None:
        self.plan = []
        self.events = []
        self.op_timings = {}
        self.start_tstamp = time.time()
        self.end_tstamp = None
        from ..core.plan import iter_op_nodes

        for name, d in iter_op_nodes(event.dag):
            op = d["primitive_op"]
            self.plan.append(
                PlanRow(
                    array_name=name,
                    op_name=d.get("op_name", ""),
                    projected_mem=op.projected_mem,
                    reserved_mem=op.reserved_mem,
                    num_tasks=op.num_tasks,
                )
            )

    def on_operation_start(self, event) -> None:
        self.op_timings[event.name] = OpTiming(
            name=event.name,
            num_tasks=event.num_tasks,
            start_tstamp=time.time(),
        )

    def on_operation_end(self, event) -> None:
        timing = self.op_timings.get(event.name)
        if timing is None:
            timing = self.op_timings[event.name] = OpTiming(name=event.name)
        timing.end_tstamp = time.time()

    def on_task_end(self, event: TaskEndEvent) -> None:
        self.events.append(event)

    def on_compute_end(self, event) -> None:
        self.end_tstamp = time.time()

    # -- derived views ---------------------------------------------------

    def peak_measured_mem_by_op(self) -> dict[str, int]:
        peaks: dict[str, int] = {}
        for e in self.events:
            if e.peak_measured_mem_end is not None:
                peaks[e.array_name] = max(
                    peaks.get(e.array_name, 0), e.peak_measured_mem_end
                )
        return peaks

    def projected_vs_measured(self) -> list[dict]:
        """Join plan projections against measured peaks per op."""
        peaks = self.peak_measured_mem_by_op()
        rows = []
        for r in self.plan:
            peak = peaks.get(r.array_name)
            # a PlanRow holds scalars only: a shallow copy of its fields is
            # what ``dataclasses.asdict`` gives, without its deep copy (this
            # runs on every compute, through the aggregator's summary)
            row = dict(vars(r))
            row["peak_measured_mem"] = peak
            row["projected_mem_utilization"] = (
                peak / r.projected_mem if peak and r.projected_mem else None
            )
            rows.append(row)
        return rows
