"""The chaos cases of tests/runtime/test_chaos.py that need threads, a pool or
a fleet (its single-process cases are in test_torch_faults.py), on the port:
storage flakiness on the threaded executor and the process pool, a worker
crash and a spot preemption with the autoscaler's backfill on the fleet,
programming errors failing fast end to end and across the wire; and
``python -m cubed_tpu_torch.chaos --seed N``, the campaign CLI, end to end.
Each end-to-end value is bitwise-correct, as in the JAX package.
"""

from __future__ import annotations

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as xp  # noqa: E402
from cubed_tpu_torch.observability.metrics import get_registry  # noqa: E402
from cubed_tpu_torch.runtime import faults  # noqa: E402
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor  # noqa: E402
from cubed_tpu_torch.runtime.resilience import RetryPolicy  # noqa: E402

from . import _torch_fleet  # noqa: E402
from ._torch_chaos import invariant_audit, pinned_names  # noqa: E402,F401
from .runtime.utils import read_int_from_file  # noqa: E402

pytestmark = pytest.mark.chaos

CHAOS_STORAGE = dict(seed=42, storage_read_failure_rate=0.1, storage_write_failure_rate=0.15, task_failure_rate=0.1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _clean_process():
    before = _torch_fleet.snapshot()
    _torch_fleet.reset_process_state()
    yield
    _torch_fleet.reset_process_state()
    assert _torch_fleet.leftovers(before) == {"children": [], "listening": []}


class _StatsCapture:
    stats: dict = {}

    def on_compute_end(self, event):
        self.stats = event.executor_stats or {}


def _policy():
    return RetryPolicy(retries=6, backoff_base=0.01, seed=0)


def test_chaos_threaded_storage_flakiness_bitwise_correct(tmp_path, invariant_audit):  # noqa: F811
    """The JAX package's case with 10 retries a task where it has 6: every
    attempt of a task rolls three seeded sites (the task 0.1, its target's
    ``.zarray`` read 0.1, its chunk write 0.15), so an attempt fails with
    probability 0.31, and the ``.zarray`` rolls are one occurrence sequence
    that the pool's threads consume in whatever order they run. At these
    pinned names chunk (3, 3)'s own task and write rolls need exactly 7
    attempts: with 6 retries the compute then fails whenever the threads
    hand one of those attempts a failing ``.zarray`` roll (about half the
    runs in one process; the reference's twin fails in whole runs for this
    reason). 10 retries leave a task's exhaustion at 0.31^11."""
    journal = str(tmp_path / "chaos.journal.jsonl")
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", journal=journal, fault_injection=CHAOS_STORAGE)
    an = np.arange(400, dtype=np.float64).reshape(20, 20)
    cap = _StatsCapture()
    with pinned_names(40_000):
        a = ct.from_array(an, chunks=(2, 2), spec=spec)  # 100 chunks
        result = xp.add(a, 1.0).compute(
            executor=AsyncPythonDagExecutor(retry_policy=RetryPolicy(retries=10, backoff_base=0.01, seed=0)),
            callbacks=[cap])
    np.testing.assert_array_equal(result, an + 1.0)
    assert cap.stats.get("faults_injected", 0) > 0, cap.stats
    assert cap.stats.get("task_retries", 0) > 0, cap.stats
    assert (cap.stats.get("retry_backoff_s") or {}).get("count", 0) == cap.stats["task_retries"]
    invariant_audit(journal=journal, work_dir=str(tmp_path), metrics=cap.stats)


def test_chaos_multiprocess_storage_flakiness(tmp_path, monkeypatch):
    # env-var activation: spawned pool workers inherit the armed injector
    monkeypatch.setenv(faults.FAULTS_ENV_VAR,
                       faults.FaultConfig(seed=42, storage_write_failure_rate=0.2).to_env_json())
    from cubed_tpu_torch.runtime.executors.multiprocess import MultiprocessDagExecutor

    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    an = np.arange(100, dtype=np.float64).reshape(10, 10)
    cap = _StatsCapture()
    with pinned_names(41_000):
        a = ct.from_array(an, chunks=(2, 2), spec=spec)  # 25 chunks
        result = xp.add(a, 3.0).compute(executor=MultiprocessDagExecutor(max_workers=2, retry_policy=_policy()),
                                        callbacks=[cap])
    np.testing.assert_array_equal(result, an + 3.0)
    # injections happen worker-side; the retries they force are client-side
    assert cap.stats.get("task_retries", 0) > 0, cap.stats


def test_chaos_distributed_worker_crash_mid_compute(tmp_path, monkeypatch, invariant_audit):  # noqa: F811
    """Storage flakiness plus one injected worker hard-exit: in-flight tasks
    fail with WorkerLostError and requeue onto the survivor for free, and the
    result is still bitwise-correct."""
    from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor

    monkeypatch.setenv(faults.FAULTS_ENV_VAR, faults.FaultConfig(
        seed=7, storage_write_failure_rate=0.1, worker_crash_names=("local-0",), worker_crash_after_tasks=2,
    ).to_env_json())
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    before = get_registry().snapshot()
    control_dir = str(tmp_path / "ctrl")
    ex = DistributedDagExecutor(n_local_workers=2, control_dir=control_dir, retry_policy=_policy())
    try:
        ex._ensure_fleet()
        a = ct.from_array(an, chunks=(2, 2), spec=spec)  # 64 tasks per op
        result = xp.add(a, 1.0).compute(executor=ex, callbacks=[_StatsCapture()])
        np.testing.assert_array_equal(result, an + 1.0)
        assert ex._coordinator.stats["workers_lost"] >= 1
        assert ex._coordinator.n_workers >= 1  # the survivor carried it
        delta = get_registry().snapshot_delta(before)
        assert delta.get("worker_loss_requeues", 0) >= 1, delta
        departed = ex._coordinator.stats_snapshot()["workers"]
        assert any("exitcode 137" in str(row.get("reason", "")) and "likely OOM-killed" in str(row.get("reason", ""))
                   for row in departed.values()), departed
    finally:
        ex.close()
    invariant_audit(control_dir=control_dir, work_dir=str(tmp_path), metrics=delta)


def test_chaos_spot_preemption_autoscaler_backfills_sublinear(tmp_path):
    """About 30% of the fleet is spot-preempted mid-compute (seeded SIGTERM,
    drain notice, hard kill), the autoscaler backfills, and the compute
    lands bitwise with wall clock under 2x the no-fault run's."""
    from cubed_tpu_torch.observability import collect
    from cubed_tpu_torch.runtime.autoscale import AutoscalePolicy
    from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor

    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    delay = 0.25  # 64 tasks x 0.25 s / 3 workers, about 5 s of fleet work

    def run(workdir, fault_kwargs):
        spec = ct.Spec(work_dir=str(workdir), allowed_mem="500MB", fault_injection=fault_kwargs or None)
        a = ct.from_array(an, chunks=(2, 2), spec=spec)  # 64 tasks
        r = ct.map_blocks(_torch_fleet.SlowAdd(delay), a, dtype=np.float64)
        ex = DistributedDagExecutor(
            n_local_workers=3,
            autoscale_policy=AutoscalePolicy(min_workers=3, max_workers=4, interval_s=0.25,
                                             idle_rounds_before_down=10**6, cooldown_down_s=3600),
            retry_policy=_policy(),
        )
        try:
            coord = ex._ensure_fleet()
            t0 = time.monotonic()
            result = r.compute(executor=ex)
            elapsed = time.monotonic() - t0
            np.testing.assert_array_equal(result, an + 1.0)
            snap = coord.stats_snapshot()
            snap["autoscale"] = dict(ex._autoscaler.stats) if ex._autoscaler is not None else {}
            if fault_kwargs:
                # a replacement still starting registers within the wait
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    snap = coord.stats_snapshot()
                    snap["autoscale"] = dict(ex._autoscaler.stats)
                    if any(row.get("alive") for name, row in snap["workers"].items()
                           if name in ("local-3", "local-4")):
                        break
                    time.sleep(0.1)
            return elapsed, snap
        finally:
            ex.close()

    base_elapsed, _ = run(tmp_path / "base", None)
    t_ring = time.time()
    fault_elapsed, snap = run(tmp_path / "fault", dict(seed=12, worker_preempt_rate=0.34,
                                                       worker_preempt_after_tasks=2, preempt_notice_s=0.8))
    assert snap["workers_preempted"] >= 1, snap
    assert snap["drains_completed"] >= 1, snap
    assert snap["autoscale"]["workers_scaled_up"] >= 1, snap
    assert any(row.get("alive") for name, row in snap["workers"].items() if name in ("local-3", "local-4")), \
        snap["workers"]
    assert len([row for row in snap["workers"].values() if row.get("drained")]) >= 1, snap["workers"]
    assert fault_elapsed < 2.0 * base_elapsed, (
        f"preempted run took {fault_elapsed:.2f}s vs {base_elapsed:.2f}s no-fault: degradation is not sub-linear")
    kinds = {d["kind"] for d in collect.decisions_since(t_ring)}
    assert {"worker_draining", "worker_drained", "scale_up"} <= kinds, kinds


def test_chaos_nonretryable_fails_fast_end_to_end(tmp_path):
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(np.ones((4, 4)), chunks=(2, 2), spec=spec)
    calls = {}
    lock = threading.Lock()

    def bad(x):
        with lock:
            calls["n"] = calls.get("n", 0) + 1
        raise ValueError("wrong units")

    r = ct.map_blocks(bad, a, dtype=np.float64)
    with pytest.raises(ValueError, match="wrong units"):
        r.compute(executor=AsyncPythonDagExecutor(retries=5))
    # each of the 4 chunk tasks ran at most once (the plan-time trace of
    # map_blocks' batchable hint calls it on a meta tensor once more)
    assert calls["n"] <= 5


def test_chaos_remote_programming_error_fails_fast(tmp_path):
    """The fleet ships the remote exception's class name, so a remote
    TypeError fails fast instead of burning retries on reruns."""
    from cubed_tpu_torch.runtime.distributed import RemoteTaskError
    from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor

    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(np.ones((4, 4)), chunks=(2, 2), spec=spec)
    path = tmp_path / "counts"
    path.mkdir()
    task = _torch_fleet.CountingTypeError(str(path))
    with DistributedDagExecutor(n_local_workers=1) as ex:
        r = ct.map_blocks(task, a, dtype=np.float64)
        with pytest.raises(RemoteTaskError, match="TypeError"):
            r.compute(executor=ex, retries=5)
    total = sum(read_int_from_file(str(path / str(i))) for i in range(8))
    assert 1 <= total <= 4  # at most once per chunk task, never retried


@pytest.mark.parametrize("seed", [2, 3])
def test_chaos_cli_seed_runs_a_generated_schedule(tmp_path, seed):
    """``python -m cubed_tpu_torch.chaos --seed N``: the schedule the JAX
    package generates for N, run bitwise and auditor-clean, exit 0 (seed 2
    on threads, seed 3 on a fleet with spot preemption)."""
    from cubed_tpu.runtime.campaign import CampaignRunner as RefRunner

    env = dict(os.environ, CUBED_TPU_TORCH_DEVICE="cpu")
    proc = subprocess.run([sys.executable, "-m", "cubed_tpu_torch.chaos", "--seed", str(seed), "--base-dir",
                           str(tmp_path)], capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == RefRunner(str(tmp_path)).generate(seed).describe()
    assert lines[1].startswith("PASS [ok]"), lines
    assert json.dumps(sorted(os.listdir(tmp_path))) == "[]"  # a passing run leaves no scratch
