"""The port's TCP fleet under faults and through its lifecycle, each case
on a fleet of its own: a worker SIGKILLed mid-compute (its tasks requeued,
the value equal to the JAX package's), every worker dead, the registry's
``"distributed"`` name, a worker started out of band, task timeouts
rerouted, resume on a fresh fleet after the first one died, the workers'
bounded blob caches, and graceful drains (requeued free; a zero grace
abandons at once). The worker kill and the drain end with the port's
invariant auditor over their journal, control log and work dir.
Counterpart of the fault and lifecycle cases of
tests/runtime/test_distributed.py (its autoscaler cases are in
test_torch_autoscale.py and test_torch_distributed.py)."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as xp  # noqa: E402
from cubed_tpu_torch.observability.collect import TraceCollector  # noqa: E402
from cubed_tpu_torch.observability.metrics import get_registry  # noqa: E402
from cubed_tpu_torch.runtime.distributed import (  # noqa: E402
    Coordinator,
    NoWorkersError,
    WorkerDrainedError,
    WorkerLostError,
    run_worker,
)
from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor, _worker_env  # noqa: E402
from cubed_tpu_torch.runtime.executors.python_async import map_unordered  # noqa: E402

from . import _torch_fleet  # noqa: E402
from ._torch_chaos import invariant_audit  # noqa: E402,F401
from .runtime.utils import read_int_from_file  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clean_process():
    before = _torch_fleet.snapshot()
    _torch_fleet.reset_process_state()
    yield
    _torch_fleet.reset_process_state()
    assert _torch_fleet.leftovers(before) == {"children": [], "listening": []}


class _Count(ct.Callback):
    def __init__(self):
        self.value = 0

    def on_task_end(self, event):
        self.value += 1


@pytest.fixture()
def spec(tmp_path):
    return ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB")


def test_distributed_survives_worker_kill(tmp_path, invariant_audit):
    an = np.arange(400, dtype=np.float64).reshape(20, 20)
    ref = float(rxp.sum(rxp.add(*[cubed_tpu.from_array(an, chunks=(2, 2), spec=cubed_tpu.Spec(
        work_dir=str(tmp_path / "ref"), allowed_mem="500MB"))] * 2)).compute())
    journal, control_dir = str(tmp_path / "kill.journal.jsonl"), str(tmp_path / "ctrl")
    spec = ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB", journal=journal)
    ex = DistributedDagExecutor(n_local_workers=2, retries=3, control_dir=control_dir)
    try:
        ex._ensure_fleet()
        a = ct.from_array(an, chunks=(2, 2), spec=spec)  # 100 tasks an op
        victim = ex._procs[0]
        fired = {}

        class KillOnFirstTask(ct.Callback):
            def on_task_end(self, event):
                if not fired:
                    fired["t"] = time.time()
                    os.kill(victim.pid, signal.SIGKILL)

        result = float(xp.sum(xp.add(a, a)).compute(executor=ex, callbacks=[KillOnFirstTask()]))
        assert result == ref == 2 * an.sum()
        assert fired and ex._coordinator.n_workers == 1
        assert ex._coordinator.stats["workers_lost"] == 1
    finally:
        ex.close()
    # the killed worker's re-dispatched tasks show its release (worker_gone)
    invariant_audit(journal=journal, control_dir=control_dir, work_dir=str(tmp_path / "port"))


def test_distributed_all_workers_dead_raises(spec):
    ex = DistributedDagExecutor(n_local_workers=1, retries=1)
    try:
        ex._ensure_fleet()
        for p in ex._procs:
            os.kill(p.pid, signal.SIGKILL)
        deadline = time.time() + 10
        while ex._coordinator.n_workers > 0 and time.time() < deadline:
            time.sleep(0.05)
        a = ct.from_array(np.ones((4, 4), dtype=np.float64), chunks=(2, 2), spec=spec)
        with pytest.raises((NoWorkersError, WorkerLostError)):
            xp.sum(a).compute(executor=ex)
    finally:
        ex.close()


def test_distributed_by_name(tmp_path):
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", executor_name="distributed",
                   executor_options=dict(n_local_workers=2))
    a = ct.from_array(np.ones((6, 6)), chunks=(3, 3), spec=spec)
    try:
        assert float(xp.sum(a).compute()) == 36.0
        assert spec.executor.name == "distributed"
    finally:
        spec.executor.close()


def test_distributed_out_of_band_worker(spec):
    """A fixed listen address and a worker started by hand, as on another
    host, with its device named on the command line."""
    ex = DistributedDagExecutor(listen="127.0.0.1:0", n_local_workers=0, min_workers=1, worker_start_timeout=60)
    proc = None
    try:
        err = {}

        def start():
            try:
                ex._ensure_fleet()
            except Exception as e:  # surfaced below
                err["e"] = e

        t = threading.Thread(target=start)
        t.start()
        deadline = time.time() + 15
        while ex.coordinator_address is None and time.time() < deadline:
            time.sleep(0.05)
        assert ex.coordinator_address is not None
        proc = subprocess.Popen([sys.executable, "-m", "cubed_tpu_torch.runtime.worker", ex.coordinator_address,
                                 "--threads", "2", "--name", "hostB", "--device", "cpu"], env=_worker_env())
        t.join(timeout=60)
        assert not err, err
        an = np.arange(36, dtype=np.float64).reshape(6, 6)
        a = ct.from_array(an, chunks=(3, 3), spec=spec)
        assert float(xp.sum(xp.multiply(a, 3.0)).compute(executor=ex)) == 3 * an.sum()
        assert set(ex.stats["worker_reports"]) == {"hostB"}
    finally:
        ex.close()
        if proc is not None:
            proc.wait(timeout=20)


def test_distributed_task_timeout_reroutes(tmp_path):
    """A task stuck on a hung worker times out at the coordinator; the retry
    elsewhere succeeds (its second invocation returns at once)."""
    path = tmp_path / "counts"
    path.mkdir()
    timing_map = {0: [60000]}
    ex = DistributedDagExecutor(n_local_workers=2, task_timeout=5.0, retries=2, use_backups=False)
    try:
        coord = ex._ensure_fleet()
        map_unordered(_torch_fleet.CoordPool(coord), _torch_fleet.FaultTask(str(path), timing_map), list(range(3)),
                      retries=2, use_backups=False)
        assert read_int_from_file(str(path / "0")) == 2  # timed out once
        assert coord.stats["task_timeouts"] >= 1
    finally:
        ex.close()


def test_distributed_resume_after_fleet_failure(spec):
    """A plan that dies with its whole fleet resumes on a fresh fleet,
    skipping the ops whose stores are complete."""
    an = np.arange(144, dtype=np.float64).reshape(12, 12)
    a = ct.from_array(an, chunks=(3, 3), spec=spec)
    c = xp.add(xp.add(a, 1.0), 1.0)
    ex1 = DistributedDagExecutor(n_local_workers=1, retries=0)
    seen = {"n": 0}

    class KillFleetMidway(ct.Callback):
        def on_task_end(self, event):
            seen["n"] += 1
            if seen["n"] == 20:  # op b's 16 tasks done, two of op c's
                for p in ex1._procs:
                    os.kill(p.pid, signal.SIGKILL)

    try:
        with pytest.raises(Exception):
            c.compute(executor=ex1, callbacks=[KillFleetMidway()], optimize_graph=False)
    finally:
        ex1.close()
    assert seen["n"] >= 20
    counter = _Count()
    with DistributedDagExecutor(n_local_workers=2) as ex2:
        result = c.compute(executor=ex2, callbacks=[counter], optimize_graph=False, resume=True)
    np.testing.assert_array_equal(result, an + 2.0)
    assert counter.value < 32, counter.value


def test_distributed_blob_eviction_self_heals(spec, monkeypatch):
    """A worker whose decoded-blob cache holds one op evicts at every new
    op; ``blob_dropped`` makes the coordinator re-ship the bytes."""
    monkeypatch.setenv("CUBED_TPU_TORCH_WORKER_BLOB_CAP", "1")
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    with DistributedDagExecutor(n_local_workers=1, worker_threads=1) as ex:
        a = ct.from_array(an, chunks=(4, 4), spec=spec)
        r1 = float(xp.sum(a).compute(executor=ex))
        r2 = float(xp.sum(xp.add(a, 1.0)).compute(executor=ex))
        r3 = float(xp.mean(xp.multiply(a, 2.0)).compute(executor=ex))
        r4 = float(xp.sum(a).compute(executor=ex))
    assert r1 == r4 == an.sum()
    assert r2 == (an + 1.0).sum()
    assert r3 == pytest.approx((an * 2.0).mean(), rel=1e-12)


def test_distributed_graceful_drain_requeues_free(tmp_path, invariant_audit):
    """A drain mid-compute loses no chunk; the abandoned tasks requeue
    without drawing the retry budget; the drain shows in the snapshot and
    in the merged trace, and the artifacts audit clean."""
    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    journal, control_dir = str(tmp_path / "drain.journal.jsonl"), str(tmp_path / "ctrl")
    spec = ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB", journal=journal)
    ex = DistributedDagExecutor(n_local_workers=2, control_dir=control_dir)
    before = get_registry().snapshot()
    try:
        coord = ex._ensure_fleet()
        a = ct.from_array(an, chunks=(4, 4), spec=spec)  # 16 slow tasks
        r = ct.map_blocks(_torch_fleet.SlowAdd(0.4), a, dtype=np.float64)
        seen = {"n": 0}

        class DrainMidOp(ct.Callback):
            def on_task_end(self, event):
                seen["n"] += 1
                if seen["n"] == 3:
                    coord.request_drain("local-0", grace_s=0.05, reason="scale_down")

        collector = TraceCollector(trace_dir=str(tmp_path))
        result = r.compute(executor=ex, callbacks=[DrainMidOp(), collector])
        np.testing.assert_array_equal(result, an + 1.0)
        snap = coord.stats_snapshot()
        assert snap["drains_completed"] == 1, snap
        assert snap["tasks_abandoned_on_drain"] >= 1, snap
        assert snap["workers_lost"] == 0, snap
        row = snap["workers"]["local-0"]
        assert row["drained"] is True and "drained" in row["reason"], row
        delta = get_registry().snapshot_delta(before)
        assert delta.get("worker_loss_requeues", 0) >= 1, delta
        assert delta.get("task_retries", 0) == 0, delta
        assert delta.get("drains_completed", 0) == 1, delta
        with open(collector.trace_path) as f:
            trace = f.read()
        assert "worker_drain_requested" in trace and "worker_drained" in trace
        json.loads(trace)
    finally:
        ex.close()
    invariant_audit(journal=journal, control_dir=control_dir, work_dir=str(tmp_path / "port"))


def test_drain_with_zero_grace_abandons_at_once():
    """``grace_s=0`` abandons the task in flight at once (not after the
    worker's default grace, nor after the task's own two seconds)."""
    coord = Coordinator("127.0.0.1", 0)
    host, port = coord.address
    t = threading.Thread(target=run_worker, args=(f"{host}:{port}",),
                         kwargs=dict(nthreads=1, name="w-0", drain_grace_s=10.0), daemon=True)
    try:
        t.start()
        coord.wait_for_workers(1, timeout=30)
        fut = coord.submit(None, _torch_fleet.SlowAdd(2.0), 1.0)
        time.sleep(0.5)
        t0 = time.monotonic()
        assert coord.request_drain("w-0", grace_s=0.0, reason="scale_down")
        with pytest.raises(WorkerDrainedError):
            fut.result(timeout=5)
        assert time.monotonic() - t0 < 1.5
        deadline = time.time() + 10
        while time.time() < deadline and coord.n_workers > 0:
            time.sleep(0.02)
        assert coord.stats_snapshot()["drains_completed"] == 1 and coord.n_workers == 0
    finally:
        coord.close()
        t.join(timeout=10)
        _torch_fleet.reset_process_state()
