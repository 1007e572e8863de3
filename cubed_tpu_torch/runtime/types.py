"""Executor protocol and observability event types.

Counterpart of ``cubed_tpu/runtime/types.py``. The callback lifecycle,
fired by every executor (``Plan.execute`` fires the compute events):

    on_compute_start(ComputeStartEvent)
      on_operation_start(OperationStartEvent)      # per op
        on_task_start(TaskStartEvent)              # per task (or op, batched)
        on_task_end(TaskEndEvent)                  # per completed task
      on_operation_end(OperationEndEvent)          # per op
    on_compute_end(ComputeEndEvent)                # carries executor_stats

The task events carry every field of the reference's;
``TaskEndEvent.guard_mem_peak`` is the memory guard's reading
(``runtime/memory.py``), and ``dispatch`` stays None until the fleet is
ported (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Sequence

logger = logging.getLogger(__name__)


class DagExecutor:
    """Protocol for plan executors: map each op's task function over its tasks."""

    @property
    def name(self) -> str:
        raise NotImplementedError

    def execute_dag(self, dag, callbacks=None, array_names=None, resume=None, spec=None, **kwargs) -> None:
        raise NotImplementedError


@dataclass
class TaskStartEvent:
    """A task (or a retry/backup attempt of one) has been submitted."""

    array_name: str
    num_tasks: int = 1
    #: the task's chunk key (stringified mappable item), when known
    chunk_key: Optional[str] = None
    #: 0 for the first attempt, incremented per retry
    attempt: int = 0
    #: True when this is a speculative straggler backup of a running task
    backup: bool = False


@dataclass
class TaskEndEvent:
    """Metrics for a completed task."""

    array_name: str
    num_tasks: int = 1
    task_create_tstamp: Optional[float] = None
    function_start_tstamp: Optional[float] = None
    function_end_tstamp: Optional[float] = None
    task_result_tstamp: Optional[float] = None
    peak_measured_mem_start: Optional[int] = None
    peak_measured_mem_end: Optional[int] = None
    #: the task's chunk key (stringified mappable item), when known
    chunk_key: Optional[str] = None
    #: which attempt produced this result (0 = first try)
    attempt: int = 0
    #: name of the executor that ran the task
    executor: Optional[str] = None
    #: storage bytes moved by THIS task, measured where it ran (worker-side
    #: for remote executors) — see observability/accounting.py
    bytes_read: Optional[int] = None
    bytes_written: Optional[int] = None
    chunks_read: Optional[int] = None
    chunks_written: Optional[int] = None
    #: logical bytes served by virtual (never-materialized) arrays — not IO
    virtual_bytes_read: Optional[int] = None
    #: named event counts recorded inside this task's scope (see
    #: observability/accounting.py ``record_scoped_counter``), measured
    #: where the task ran and folded into the registry like bytes
    counters: Optional[dict] = None
    #: the memory guard's reading of this task (bytes): on a CUDA device the
    #: larger of the allocator's peak over the task's start and its RSS
    #: growth, else RSS growth (plus any injected spike); on the device
    #: executor, the segment's or eager op's; None while the guard is off
    guard_mem_peak: Optional[int] = None
    #: spans recorded inside this task's body (storage IO, kernel apply),
    #: measured on the executing process's clock — see
    #: ``observability/accounting.py`` (bounded buffer) and
    #: ``observability/collect.py`` (clock-aligned merge)
    spans: Optional[list] = None
    #: spans beyond the per-task buffer bound, dropped where the task ran
    spans_dropped: Optional[int] = None
    #: pid of the process that executed the task (lane + clock identity)
    pid: Optional[int] = None
    #: fleet worker name when the task ran on a named worker, else None
    worker: Optional[str] = None
    #: the task's control-plane dispatch ledger (client-clock stamps of its
    #: dispatch); None until the fleet is ported (ROADMAP Queue 1 item 11)
    dispatch: Optional[dict] = None


class Callback:
    """Observer protocol for compute lifecycle events.

    Callback exceptions are swallowed and logged by ``callbacks_on`` — a
    broken observer can never fail a compute.
    """

    def on_compute_start(self, event) -> None:
        """Called when the computation is about to start; event has .dag, .resume."""

    def on_compute_end(self, event) -> None:
        """Called when the computation has finished; event has .dag, .executor_stats."""

    def on_operation_start(self, event) -> None:
        """Called when an op begins; event has .name and .num_tasks."""

    def on_operation_end(self, event) -> None:
        """Called when all of an op's tasks have finished."""

    def on_task_start(self, event: TaskStartEvent) -> None:
        """Called when a task attempt is submitted for execution."""

    def on_task_end(self, event: TaskEndEvent) -> None:
        """Called when one or more tasks of an op finish."""


@dataclass
class ComputeStartEvent:
    dag: object
    resume: Optional[bool] = None
    #: unique id for this compute (``Plan.execute`` mints one); correlates
    #: traces and structured logs
    compute_id: Optional[str] = None


@dataclass
class ComputeEndEvent:
    dag: object
    #: merged stats for this compute: the executor's own path counters
    #: (``CudaExecutor.stats``), the metrics registry's delta over the
    #: compute (tasks, bytes and chunks read and written) and the per-op
    #: summary (``per_op``) -- None if nothing reported
    executor_stats: Optional[dict] = None
    #: the compute's id (matches the start event's)
    compute_id: Optional[str] = None
    #: the exception that failed the compute, or None on success (the event
    #: still fires on failure; the exception propagates to the caller)
    error: Optional[BaseException] = None


@dataclass
class OperationStartEvent:
    name: str
    num_tasks: int = 0


@dataclass
class OperationEndEvent:
    name: str
    num_tasks: int = 0


def callbacks_on(callbacks: Optional[Sequence[Callback]], method: str, event) -> None:
    """Dispatch ``event`` to every callback's ``method``, swallowing (and
    logging) observer exceptions so a broken callback can't fail a compute."""
    if not callbacks:
        return
    for cb in callbacks:
        fn = getattr(cb, method, None)
        if fn is None:
            continue
        try:
            fn(event)
        except Exception:
            logger.exception(
                "callback %r raised in %s; continuing", cb, method
            )
