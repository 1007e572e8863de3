"""Executor helpers. Counterpart of ``cubed_tpu/runtime/utils.py``, trimmed
to :func:`fire_task_start` (the metrics registry is not ported)."""

from __future__ import annotations

from .types import TaskStartEvent, callbacks_on


def fire_task_start(callbacks, array_name: str, num_tasks: int = 1) -> None:
    """Fire ``on_task_start`` for *num_tasks* submitted tasks of an op."""
    if callbacks:
        callbacks_on(callbacks, "on_task_start", TaskStartEvent(array_name, num_tasks))
