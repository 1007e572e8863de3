"""Speculative straggler-backup policy.

Counterpart of ``cubed_tpu/runtime/backup.py``: launch a duplicate of a
running task when enough peers have completed and this task is an outlier
(more than three times the median completed duration). Safe because tasks
are idempotent and chunk writes are atomic (``storage/store.py`` writes a
temporary file, fsyncs it and renames it into place).
"""

from __future__ import annotations

from typing import Dict, TypeVar

T = TypeVar("T")

#: policy constants (the reference's values)
MIN_TASKS_STARTED = 10
MIN_COMPLETED_FRACTION = 0.5
SLOWDOWN_FACTOR = 3.0


def should_launch_backup(
    task: T,
    now: float,
    start_times: Dict[T, float],
    end_times: Dict[T, float],
    min_tasks: int = MIN_TASKS_STARTED,
    min_completed_fraction: float = MIN_COMPLETED_FRACTION,
    slow_factor: float = SLOWDOWN_FACTOR,
) -> bool:
    """True when *task* has run longer than ``slow_factor`` times the median
    duration of the tasks completed so far, once ``min_tasks`` have started
    and ``min_completed_fraction`` of them have ended."""
    if len(start_times) < min_tasks:
        return False
    if len(end_times) < min_completed_fraction * len(start_times):
        return False
    durations = sorted(end_times[t] - start_times[t] for t in end_times if t in start_times)
    if not durations:
        return False
    median = durations[len(durations) // 2]
    return now - start_times[task] > slow_factor * median
