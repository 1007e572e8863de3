"""The port's speculative-backup policy held against the JAX package's on the
same start and end times (counterpart of tests/runtime/test_backup.py), and
the threaded map's one backup per input."""

from __future__ import annotations

import concurrent.futures

import pytest

from cubed_tpu.runtime.backup import should_launch_backup as ref_should_launch_backup
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime.backup import should_launch_backup


def both(*args):
    """The port's answer, asserted equal to the reference's."""
    mine = should_launch_backup(*args)
    assert mine == ref_should_launch_backup(*args)
    return mine


def test_not_enough_started():
    assert not both(4, 100.0, {i: 0.0 for i in range(5)}, {i: 1.0 for i in range(4)})


def test_not_enough_completed():
    assert not both(19, 100.0, {i: 0.0 for i in range(20)}, {i: 1.0 for i in range(5)})


def test_not_slow_enough():
    # median duration 1.0; a task at 2.5x is under the 3x threshold
    assert not both(19, 2.5, {i: 0.0 for i in range(20)}, {i: 1.0 for i in range(15)})


def test_backup_launched_for_straggler():
    assert both(19, 3.5, {i: 0.0 for i in range(20)}, {i: 1.0 for i in range(15)})


def test_zero_duration_tasks_make_any_elapsed_task_a_straggler():
    start = {i: 0.0 for i in range(20)}
    end = {i: 0.0 for i in range(15)}
    assert both(19, 0.001, start, end)
    assert not both(19, 0.0, start, end)


def test_single_task_op_never_launches_backup():
    assert not both(0, 1e9, {0: 0.0}, {})
    assert not both(0, 1e9, {0: 0.0}, {0: 5.0})


def test_no_completed_durations_never_launches_backup():
    assert not both(19, 1e9, {i: 0.0 for i in range(20)}, {})


def test_end_times_without_start_times_ignored():
    end = {i: 1.0 for i in range(15)}
    end[99] = 0.0  # no matching start: must not count in the median
    assert both(19, 3.5, {i: 0.0 for i in range(20)}, end)


@pytest.mark.parametrize("now", [0.5, 2.9, 3.1, 7.0])
@pytest.mark.parametrize("n_done", [9, 10, 11])
def test_policy_equals_the_reference_over_a_grid(now, n_done):
    start = {i: 0.1 * (i % 3) for i in range(20)}
    end = {i: start[i] + 0.5 + 0.1 * i for i in range(n_done)}
    both(19, now, start, end)


def test_map_unordered_backs_up_each_task_at_most_once(monkeypatch):
    """Once a task has a backup twin the policy is not asked again for it,
    and each launch counts ``speculative_backups``."""
    import cubed_tpu_torch.runtime.executors.python_async as pa

    monkeypatch.setattr(pa, "should_launch_backup", lambda *a: True)

    class SlowThenDonePool:
        """The first submissions stay pending; all complete once backups exist."""

        def __init__(self):
            self.futs = []

        def submit(self, fn, *args, **kwargs):
            f = concurrent.futures.Future()
            self.futs.append(f)
            if len(self.futs) >= 4:  # 2 originals + 2 backups
                for g in self.futs:
                    if not g.done():
                        g.set_result((None, {}))
            return f

    before = get_registry().snapshot()
    pool = SlowThenDonePool()
    pa.map_unordered(pool, lambda x: x, [0, 1], use_backups=True, array_name="op")
    assert len(pool.futs) == 4
    assert get_registry().snapshot_delta(before).get("speculative_backups", 0) == 2
