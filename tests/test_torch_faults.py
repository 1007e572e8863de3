"""Fault injection in the port, held against the JAX package's: the same
decisions for the same seeds, and the single-process half of
tests/runtime/test_chaos.py on the sequential executor (storage flakiness,
fail-fast, backoff spacing, the retry budget, stragglers, storage-layer read
retries, write litter), each compute also run on the JAX package."""

from __future__ import annotations

import json
import os
import random
import time

import numpy as np
import pytest

import cubed_tpu as ct_ref
import cubed_tpu.array_api as ref_xp
import cubed_tpu_torch as ct
import cubed_tpu_torch.array_api as xp
from cubed_tpu.observability.accounting import task_scope as ref_task_scope
from cubed_tpu.runtime import faults as ref_faults
from cubed_tpu.runtime.executors.python import PythonDagExecutor as RefPythonDagExecutor
from cubed_tpu.runtime.resilience import RetryPolicy as RefRetryPolicy
from cubed_tpu_torch.backend_array_api import set_device
from cubed_tpu_torch.observability.accounting import task_scope
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime import faults
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor
from cubed_tpu_torch.runtime.resilience import RetryBudgetExceededError, RetryPolicy

pytestmark = pytest.mark.chaos

CHAOS_STORAGE = dict(seed=42, storage_read_failure_rate=0.1, storage_write_failure_rate=0.15, task_failure_rate=0.1)


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    yield
    faults.deactivate()


class _StatsCapture:
    stats: dict = {}

    def on_compute_end(self, event):
        self.stats = event.executor_stats or {}


def _spec(pkg, tmp_path, **fault_kwargs):
    return pkg.Spec(work_dir=str(tmp_path), allowed_mem="500MB", fault_injection=fault_kwargs or None)


# -- decisions ----------------------------------------------------------------

_SITES = ("storage_read", "storage_write", "storage_throttle", "storage_corrupt", "task", "task_mem_spike")


def _walk(inj, triples, scope):
    """Each (site, key) decision of *triples* in order through *inj*."""
    out = []
    with scope():
        for site, key in triples:
            if site == "storage_read":
                out.append(inj.storage_read_fault(key))
            elif site == "storage_write":
                out.append(inj.storage_write_fault(key))
            elif site == "storage_throttle":
                out.append(inj.storage_throttle_fault(key))
            elif site == "storage_corrupt":
                corrupted = inj.storage_corrupt_fault(key, b"0123456789abcdef" * 4)
                out.append(None if corrupted is None else bytes(corrupted))
            elif site == "task":
                try:
                    inj.task_fault(key)
                    out.append(False)
                except Exception as e:
                    out.append(type(e).__name__)
            else:
                out.append(inj.task_mem_spike(key))
    return out


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_same_config_and_keys_decide_as_the_reference(seed):
    """A few thousand (site, key, occurrence) triples: each key comes back
    several times, so occurrences past the first are walked too."""
    cfg = dict(seed=seed, storage_read_failure_rate=0.2, storage_write_failure_rate=0.3,
               storage_throttle_rate=0.1, storage_corrupt_rate=0.25, task_failure_rate=0.15,
               straggler_rate=0.0, task_mem_spike_rate=0.4, task_mem_spike_bytes=12345)
    rng = random.Random(seed)
    keys = [f"array-{i:03d}.zarr/{i % 5}.{i % 3}" for i in range(60)] + [f"('op-{i}', {i}, 0)" for i in range(20)]
    triples = [(rng.choice(_SITES), rng.choice(keys)) for _ in range(3000)]
    mine = _walk(faults.FaultInjector(faults.FaultConfig(**cfg)), triples, task_scope)
    theirs = _walk(ref_faults.FaultInjector(ref_faults.FaultConfig(**cfg)), triples, ref_task_scope)
    assert mine == theirs
    assert any(m not in (False, None, 0) for m in mine)


def test_every_config_field_round_trips_between_the_packages():
    cfg = faults.FaultConfig(seed=3, storage_corrupt_rate=0.05, worker_hang_names=("a", "b"),
                             partition_worker_names=("c",), task_fatal_chunk_keys=("0.1",), peer_drop_rate=0.5)
    raw = cfg.to_env_json()
    assert ref_faults.FaultConfig.from_dict(json.loads(raw)).to_env_json() == raw
    assert faults.FaultConfig.from_dict(json.loads(raw)) == cfg
    assert cfg.any_enabled == ref_faults.FaultConfig.from_dict(json.loads(raw)).any_enabled


# -- end to end, sequential -----------------------------------------------------


def test_chaos_sequential_storage_flakiness(tmp_path):
    an = np.arange(144, dtype=np.float64).reshape(12, 12)
    results = {}
    for pkg, mod, ex in ((ct, xp, PythonDagExecutor(retry_policy=RetryPolicy(retries=6, backoff_base=0.0, seed=0))),
                         (ct_ref, ref_xp, RefPythonDagExecutor(
                             retry_policy=RefRetryPolicy(retries=6, backoff_base=0.0, seed=0)))):
        spec = _spec(pkg, tmp_path / pkg.__name__, **CHAOS_STORAGE)
        a = pkg.from_array(an, chunks=(2, 2), spec=spec)  # 36 chunks
        cap = _StatsCapture()
        results[pkg.__name__] = mod.multiply(a, 2.0).compute(executor=ex, callbacks=[cap])
        assert cap.stats.get("faults_injected", 0) > 0, cap.stats
        assert cap.stats.get("task_retries", 0) > 0, cap.stats
    np.testing.assert_array_equal(results["cubed_tpu_torch"], an * 2.0)
    np.testing.assert_array_equal(results["cubed_tpu_torch"], results["cubed_tpu"])


def test_chaos_nonretryable_fails_fast_exactly_one_attempt(tmp_path):
    """A deterministic programming error gets exactly one attempt, with
    retries configured: no retry, no backoff."""
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(np.ones((4, 4)), chunks=(2, 2), spec=spec)
    calls = {"n": 0}

    def bad(x):
        calls["n"] += 1
        raise TypeError("deterministic bug")

    r = ct.map_blocks(bad, a, dtype=np.float64)
    calls["n"] = 0  # map_blocks traces its function once at plan time
    before = get_registry().snapshot()
    with pytest.raises(TypeError, match="deterministic bug"):
        r.compute(executor=PythonDagExecutor(retry_policy=RetryPolicy(retries=5, backoff_base=0.2)))
    assert calls["n"] == 1
    delta = get_registry().snapshot_delta(before)
    assert delta.get("task_failfast", 0) == 1
    assert delta.get("task_retries", 0) == 0
    assert (delta.get("retry_backoff_s") or {}).get("count", 0) == 0


def test_chaos_retries_spaced_by_exponential_backoff(tmp_path):
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(np.ones((2,)), chunks=(2,), spec=spec)
    times = []

    def flaky(x):
        times.append(time.monotonic())
        if len(times) <= 2:
            raise OSError(f"transient {len(times)}")
        return x

    r = ct.map_blocks(flaky, a, dtype=np.float64)
    times.clear()  # map_blocks traces its function once at plan time
    before = get_registry().snapshot()
    policy = RetryPolicy(retries=3, backoff_base=0.02, backoff_multiplier=2.0, jitter="none")
    r.compute(executor=PythonDagExecutor(retry_policy=policy))
    assert len(times) == 3
    assert times[1] - times[0] >= 0.02 - 0.005, times
    assert times[2] - times[1] >= 0.04 - 0.005, times
    bo = get_registry().snapshot_delta(before).get("retry_backoff_s") or {}
    assert bo.get("count") == 2
    assert abs(bo.get("sum", 0) - 0.06) < 1e-6


def test_chaos_retry_budget_bounds_systemic_outage(tmp_path):
    """Every task failing transiently aborts after the compute-wide budget,
    not after n_tasks * retries attempts."""
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(np.ones((12,)), chunks=(1,), spec=spec)
    calls = {"n": 0}

    def always_down(x):
        calls["n"] += 1
        raise OSError("store is down")

    r = ct.map_blocks(always_down, a, dtype=np.float64)
    calls["n"] = 0  # map_blocks traces its function once at plan time
    policy = RetryPolicy(retries=10, backoff_base=0.0, budget_factor=0.02, budget_min=4)
    with pytest.raises(RetryBudgetExceededError, match="retry budget"):
        r.compute(executor=PythonDagExecutor(retry_policy=policy))
    # the sequential executor stops at its first task: one attempt and the
    # whole budget's retries, far below its retries=10
    limit = policy.new_budget(r.plan.num_tasks()).limit
    assert limit < policy.retries
    assert calls["n"] == 1 + limit


def test_chaos_injected_stragglers_complete(tmp_path):
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    spec = _spec(ct, tmp_path, seed=1, straggler_rate=0.3, straggler_delay_s=0.01)
    a = ct.from_array(an, chunks=(2, 2), spec=spec)  # 16 tasks
    cap = _StatsCapture()
    result = xp.add(a, 5.0).compute(callbacks=[cap])
    np.testing.assert_array_equal(result, an + 5.0)
    assert cap.stats.get("faults_injected_straggler", 0) >= 1, cap.stats


def test_chaos_transient_chunk_read_retried_at_storage_layer(tmp_path):
    """A flaky chunk read is absorbed by the storage layer's own in-place
    retry instead of failing the task (the same seeded decisions as the
    reference's: its first read of "arr/0" fails, the retry passes)."""
    from cubed_tpu.storage.store import open_zarr_array as ref_open
    from cubed_tpu_torch.storage.store import open_zarr_array

    deltas = []
    for opener, scoped, scope, reg in (
        (open_zarr_array, faults.scoped, task_scope, get_registry),
        (ref_open, ref_faults.scoped, ref_task_scope, __import__(
            "cubed_tpu.observability.metrics", fromlist=["get_registry"]).get_registry),
    ):
        arr = opener(str(tmp_path / opener.__module__ / "arr"), mode="a", shape=(4,), dtype=np.float64, chunks=(4,))
        arr[:] = np.arange(4.0)
        before = reg().snapshot()
        with scoped({"seed": 9, "storage_read_failure_rate": 0.9}):
            with scope():
                out = arr[:]
        np.testing.assert_array_equal(out, np.arange(4.0))
        delta = reg().snapshot_delta(before)
        deltas.append((delta.get("storage_read_retries", 0), delta.get("faults_injected_storage_read", 0)))
    assert deltas[0] == deltas[1]
    assert deltas[0][0] >= 1 and deltas[0][1] >= 1


def test_chaos_write_faults_leave_tmp_litter_that_resume_ignores(tmp_path):
    """Injected write failures litter partial .tmp files; resume accounting
    never counts them as chunks."""
    spec = _spec(ct, tmp_path, seed=3, storage_write_failure_rate=0.3, storage_write_leaves_tmp=True)
    an = np.arange(100, dtype=np.float64).reshape(10, 10)
    a = ct.from_array(an, chunks=(2, 2), spec=spec)  # 25 chunks
    b = xp.add(a, 1.0)
    result = b.compute(executor=PythonDagExecutor(retry_policy=RetryPolicy(retries=6, backoff_base=0.0, seed=0)))
    np.testing.assert_array_equal(result, an + 1.0)
    tmps = [f for _, _, names in os.walk(str(tmp_path)) for f in names if f.endswith(".tmp")]
    assert tmps, "expected injected write failures to leave .tmp litter"
    from cubed_tpu_torch.storage.store import open_zarr_array

    for root, _, names in os.walk(str(tmp_path)):
        if ".zarray" in names:
            arr = open_zarr_array(root, mode="r")
            assert arr.nchunks_initialized <= arr.nchunks
    # a resumed compute trusts every written chunk and runs no task of b
    assert b.plan.num_tasks(resume=True) == 1  # the create-arrays task
