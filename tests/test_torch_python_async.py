"""The port's threaded executor held against the JAX package's: the map's
retries, backups and batching (counterpart of
tests/runtime/test_python_async.py), the executor on the same seeded plans
under both schedulers (values bit for bit in float64, the plans' task and op
counts and projected memory, the tasks run), the registry's names, and the
generation-parallel mode (``test_executor_features.test_compute_arrays_in_parallel``)."""

from __future__ import annotations

import concurrent.futures
import logging
import os
from functools import partial

import numpy as np
import pytest

import cubed_tpu as ct_ref
import cubed_tpu.array_api as ref_xp
import cubed_tpu_torch as ct
import cubed_tpu_torch.array_api as xp
from cubed_tpu.runtime.executors.python_async import AsyncPythonDagExecutor as RefAsyncPythonDagExecutor
from cubed_tpu_torch.backend_array_api import set_device
from cubed_tpu_torch.runtime.create import create_executor
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor, map_unordered

from .runtime.utils import check_invocation_counts, deterministic_failure, read_int_from_file


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    yield


def run_test(function, inputs, retries=2, use_backups=False, batch_size=None):
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        map_unordered(pool, function, inputs, retries=retries, use_backups=use_backups, batch_size=batch_size)


# -- the map (tests/runtime/test_python_async.py) -------------------------


def test_success(tmp_path):
    run_test(partial(deterministic_failure, str(tmp_path), {}), list(range(10)))
    check_invocation_counts(str(tmp_path), {}, 10)


def test_retries_successful(tmp_path):
    timing_map = {0: [-1], 1: [-1, -1]}
    run_test(partial(deterministic_failure, str(tmp_path), timing_map), list(range(10)))
    check_invocation_counts(str(tmp_path), timing_map, 10)


def test_retries_failure(tmp_path):
    timing_map = {0: [-1, -1, -1]}  # fails all 3 attempts
    with pytest.raises(RuntimeError, match="Deliberately fail"):
        run_test(partial(deterministic_failure, str(tmp_path), timing_map), list(range(10)))
    check_invocation_counts(str(tmp_path), timing_map, 10, retries=2, expected_invocation_counts_overrides={0: 3})


def test_stragglers_launch_backups(tmp_path):
    run_test(partial(deterministic_failure, str(tmp_path), {9: [1000]}), list(range(10)), use_backups=True)
    assert read_int_from_file(os.path.join(str(tmp_path), "9")) >= 1


def test_batch(tmp_path):
    run_test(partial(deterministic_failure, str(tmp_path), {}), list(range(10)), batch_size=3)
    check_invocation_counts(str(tmp_path), {}, 10)


def test_batch_streams_iterator_inputs():
    """With batch_size and no array_names, inputs are pulled a batch at a
    time, never further ahead of the work."""
    done, pulled = [], []

    def gen():
        for i in range(12):
            assert len(pulled) - len(done) <= 3, (len(pulled), len(done))
            pulled.append(i)
            yield i

    def work(i, config=None):
        done.append(i)
        return i

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        map_unordered(pool, work, gen(), batch_size=3)
    assert sorted(done) == list(range(12))
    assert pulled == list(range(12))


def test_backup_twin_completing_with_winner_same_batch(monkeypatch):
    """A task and its backup twin land in one wait batch: the winner's cancel
    loop removes the twin, and the done loop skips it."""
    import cubed_tpu_torch.runtime.executors.python_async as pa

    monkeypatch.setattr(pa, "should_launch_backup", lambda *a: True)

    class TwinPool:
        def __init__(self):
            self.futs = []

        def submit(self, fn, *args, **kwargs):
            f = concurrent.futures.Future()
            self.futs.append(f)
            if len(self.futs) == 2:  # the backup twin just launched
                for g in self.futs:
                    g.set_result((None, {}))
            return f

    pool = TwinPool()
    map_unordered(pool, lambda x: x, [0], use_backups=True, array_name="op")
    assert len(pool.futs) == 2


def test_executor_end_to_end_with_failures(tmp_path):
    calls = {"n": 0, "failed": False}
    an = np.arange(16.0).reshape(4, 4)
    a = ct.from_array(an, chunks=(2, 2), spec=ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB"))

    def flaky(x):
        calls["n"] += 1
        if not calls["failed"]:
            calls["failed"] = True
            raise RuntimeError("transient")
        return x + 1

    b = ct.map_blocks(flaky, a, dtype=a.dtype)
    np.testing.assert_allclose(b.compute(executor=AsyncPythonDagExecutor(retries=2)), an + 1)
    assert calls["n"] >= 5  # 4 tasks and at least 1 retry


# -- the executor on the same plans as the reference's ---------------------


class _Tasks:
    """Counts ended tasks by op kind (the op name less its counter)."""

    def __init__(self):
        self.by_op: dict = {}

    def on_task_end(self, event):
        kind = event.array_name.rsplit("-", 1)[0]
        self.by_op[kind] = self.by_op.get(kind, 0) + event.num_tasks


def _build(pkg, mod, spec, kind, data):
    arrays = [pkg.from_array(d, chunks=(4, 4), spec=spec) for d in data]
    a, b = arrays
    if kind == "elementwise":
        return mod.multiply(mod.add(a, 1.0), b)
    if kind == "reduction":
        return mod.sum(mod.add(a, b), axis=0)
    if kind == "rechunk":
        return mod.add(a, b).rechunk((16, 2)) * 2.0
    return mod.matmul(a, b)


@pytest.mark.parametrize("scheduler", ["dataflow", "oplevel"])
@pytest.mark.parametrize("kind", ["elementwise", "reduction", "rechunk", "matmul"])
def test_threaded_values_and_plans_equal_the_reference(tmp_path, kind, scheduler):
    """The port's threaded result equals its sequential one bit for bit, and
    the reference's threaded result bit for bit in float64 (matmul's within
    rtol 1e-14: torch's and XLA's CPU products sum in different orders); the
    plans have the same tasks, ops and projected memory; the same tasks
    ran."""
    rng = np.random.default_rng(7)
    data = [rng.random((16, 16)), rng.random((16, 16))]
    spec = ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="100MB", scheduler=scheduler)
    ref_spec = ct_ref.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="100MB", scheduler=scheduler)
    p = _build(ct, xp, spec, kind, data)
    r = _build(ct_ref, ref_xp, ref_spec, kind, data)
    plan = p.plan._finalize(array_names=(p.name,))
    ref_plan = r.plan._finalize(array_names=(r.name,))
    assert (plan.num_tasks(), plan.num_ops(), plan.max_projected_mem()) == \
        (ref_plan.num_tasks(), ref_plan.num_ops(), ref_plan.max_projected_mem())
    tasks, ref_tasks = _Tasks(), _Tasks()
    got = p.compute(executor=AsyncPythonDagExecutor(max_workers=4), callbacks=[tasks])
    want = r.compute(executor=RefAsyncPythonDagExecutor(max_workers=4), callbacks=[ref_tasks])
    assert got.dtype == want.dtype == np.float64
    if kind == "matmul":
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, p.compute(executor=PythonDagExecutor()))
    assert tasks.by_op == ref_tasks.by_op


def test_registry_names_the_threaded_executor():
    for name in ("threads", "async-python"):
        ex = create_executor(name, {"max_workers": 3})
        assert isinstance(ex, AsyncPythonDagExecutor) and ex.max_workers == 3 and ex.name == "threads"


def test_sequential_notes_an_explicit_dataflow_request(tmp_path, caplog):
    """The sequential executor keeps op order; an explicit dataflow request
    is noted, a defaulted one is not."""
    an = np.arange(16.0).reshape(4, 4)
    for scheduler, noted in ((None, False), ("dataflow", True)):
        caplog.clear()
        spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="100MB", scheduler=scheduler)
        with caplog.at_level(logging.DEBUG, logger="cubed_tpu_torch.runtime.executors.python"):
            np.testing.assert_array_equal(xp.add(ct.from_array(an, chunks=(2, 2), spec=spec), 1.0).compute(),
                                          an + 1.0)
        assert any("keeps op-level ordering" in r.getMessage() for r in caplog.records) is noted


def test_compute_arrays_in_parallel(tmp_path):
    an = np.arange(16.0).reshape(4, 4)
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="100MB", scheduler="oplevel")
    a = ct.from_array(an, chunks=(2, 2), spec=spec)
    ex = AsyncPythonDagExecutor(compute_arrays_in_parallel=True)
    rb, rc = ct.compute(xp.add(a, 1), xp.multiply(a, 2), executor=ex)
    np.testing.assert_array_equal(rb, an + 1)
    np.testing.assert_array_equal(rc, an * 2)


def test_launch_counts_hold_under_a_thread_stress():
    """The kernel wrappers' counts change under one lock: 32 threads adding
    to them under a 1 us switch interval lose no update."""
    import sys
    import threading

    from cubed_tpu_torch.kernels import _build
    from cubed_tpu_torch.kernels.region_sum import region_sum

    before = region_sum.launches, dict(region_sum.paths)
    delta = {("region_sum", None): 1, ("region_sum", "rows"): 1}

    def worker():
        for _ in range(500):
            _build.add_launch_counts(delta)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert region_sum.launches - before[0] == 32 * 500
    assert region_sum.paths["rows"] - before[1]["rows"] == 32 * 500
    with _build.COUNT_LOCK:
        region_sum.launches, region_sum.paths["rows"] = before[0], before[1]["rows"]
