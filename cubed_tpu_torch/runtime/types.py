"""Executor protocol and the callback events the executors fire.

Counterpart of ``cubed_tpu/runtime/types.py``, trimmed to the events and
fields the port's executors fire:

    on_operation_start(OperationStartEvent)      # per op
      on_task_start(TaskStartEvent)              # per task (or op, batched)
      on_task_end(TaskEndEvent)                  # per completed task
    on_operation_end(OperationEndEvent)          # per op

The compute-level events and the rest of the observability subsystem are
not ported yet.
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
    """One or more tasks of an op have been submitted."""

    array_name: str
    num_tasks: int = 1


@dataclass
class TaskEndEvent:
    """Metrics for one or more completed tasks of an op."""

    array_name: str
    num_tasks: int = 1
    task_create_tstamp: Optional[float] = None
    function_start_tstamp: Optional[float] = None
    function_end_tstamp: Optional[float] = None
    task_result_tstamp: Optional[float] = None
    #: name of the executor that ran the tasks
    executor: Optional[str] = None


@dataclass
class OperationStartEvent:
    name: str
    num_tasks: int = 0


@dataclass
class OperationEndEvent:
    name: str
    num_tasks: int = 0


class Callback:
    """Observer protocol for compute lifecycle events. Exceptions raised by a
    callback are logged and swallowed by :func:`callbacks_on`."""

    def on_operation_start(self, event: OperationStartEvent) -> None:
        """Called when an op begins."""

    def on_operation_end(self, event: OperationEndEvent) -> None:
        """Called when all of an op's tasks have finished."""

    def on_task_start(self, event: TaskStartEvent) -> None:
        """Called when tasks are submitted for execution."""

    def on_task_end(self, event: TaskEndEvent) -> None:
        """Called when one or more tasks of an op finish."""


def callbacks_on(callbacks: Optional[Sequence[Callback]], method: str, event) -> None:
    """Dispatch *event* to every callback's *method*, logging and swallowing
    observer exceptions so a broken callback cannot fail a compute."""
    if not callbacks:
        return
    for cb in callbacks:
        fn = getattr(cb, method, None)
        if fn is None:
            continue
        try:
            fn(event)
        except Exception:
            logger.exception("callback %r raised in %s; continuing", cb, method)
