"""The runtime memory guard in the port, held against the JAX package's:
RESOURCE classification, the guard's modes, its config and activation, the
admission controller, the sequential executor's outcomes, counters and
decisions under seeded memory spikes, and the threaded executor degrading
under them (counterpart of the sequential, threaded and unit cases of
tests/runtime/test_memory_guard.py). The guard's device reading under
concurrency is driven here through a fake allocator, in interleavings of
two and four tasks; its reading of the card's allocator is tested in
tests/test_torch_cuda.py."""

from __future__ import annotations

import contextlib
import itertools
import json
import pickle
import time

import numpy as np
import pytest
import torch

import cubed_tpu as ct_ref
import cubed_tpu.array_api as ref_xp
import cubed_tpu_torch as ct
import cubed_tpu_torch.array_api as xp
from cubed_tpu.observability import collect as ref_collect
from cubed_tpu.observability.metrics import get_registry as ref_registry
from cubed_tpu.runtime import faults as ref_faults
from cubed_tpu.runtime import memory as ref_memory
from cubed_tpu.runtime.executors.python import PythonDagExecutor as RefPythonDagExecutor
from cubed_tpu_torch.backend_array_api import set_device
from cubed_tpu_torch.observability import collect
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime import faults, memory
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor
from cubed_tpu_torch.runtime.memory import (
    AdmissionController,
    MemoryGuardConfig,
    MemoryGuardExceededError,
    task_guard,
)
from cubed_tpu_torch.runtime.resilience import Classification, RetryPolicy


@pytest.fixture(autouse=True)
def _guard_env(monkeypatch):
    set_device("cpu")
    monkeypatch.delenv(memory.MEMORY_GUARD_ENV_VAR, raising=False)
    monkeypatch.delenv(ref_memory.MEMORY_GUARD_ENV_VAR, raising=False)
    # unarmed at each start: two computes of an earlier test on two threads
    # that leave their arming scopes out of order leave one armed (ROADMAP
    # Queue 3 item 6)
    memory.deactivate()
    ref_memory.deactivate()
    yield
    memory.stop_sampler()
    faults.deactivate()


# -- classification ------------------------------------------------------


@pytest.mark.parametrize("exc", [
    MemoryError(),
    MemoryError("out of memory"),
    MemoryGuardExceededError("over budget", chunk_key="k", measured=100, allowed=50),
    torch.OutOfMemoryError("CUDA out of memory"),
])
def test_memory_failures_classify_resource(exc):
    cls = RetryPolicy().classify(exc)
    assert cls is Classification.RESOURCE
    if not isinstance(exc, (MemoryGuardExceededError, torch.OutOfMemoryError)):
        assert ref_faults is not None and \
            __import__("cubed_tpu.runtime.resilience", fromlist=["RetryPolicy"]).RetryPolicy().classify(exc).name \
            == "RESOURCE"


def test_guard_error_survives_pickling():
    e = MemoryGuardExceededError("task k measured 100 > 50", chunk_key="k", measured=100, allowed=50, op_name="op-x")
    e2 = pickle.loads(pickle.dumps(e))
    assert isinstance(e2, MemoryGuardExceededError)
    assert (e2.chunk_key, e2.measured, e2.allowed, e2.op_name) == ("k", 100, 50, "op-x")
    assert e2.wire_payload == ref_memory.MemoryGuardExceededError(
        "x", chunk_key="k", measured=100, allowed=50, op_name="op-x").wire_payload
    assert RetryPolicy().classify(e2) is Classification.RESOURCE


# -- config / activation -------------------------------------------------


def test_guard_config_roundtrip_and_validation():
    cfg = MemoryGuardConfig(mode="enforce", allowed_mem=123)
    raw = cfg.to_env_json()
    assert MemoryGuardConfig.from_dict(json.loads(raw)) == cfg
    # the JSON round-trips between the packages
    assert ref_memory.MemoryGuardConfig.from_dict(json.loads(raw)).to_env_json() == raw
    with pytest.raises(ValueError, match="invalid memory_guard mode"):
        MemoryGuardConfig(mode="nope")
    with pytest.raises(ValueError, match="unknown MemoryGuardConfig fields"):
        MemoryGuardConfig.from_dict({"mode": "off", "bogus": 1})
    assert not MemoryGuardConfig(mode="off", allowed_mem=100).enabled
    assert not MemoryGuardConfig(mode="enforce", allowed_mem=0).enabled
    assert MemoryGuardConfig(mode="enforce", allowed_mem=1).enabled


def test_scoped_arming_and_env_operator_override(monkeypatch):
    import os

    assert memory.MEMORY_GUARD_ENV_VAR == "CUBED_TPU_TORCH_MEMORY_GUARD"
    assert memory.get_guard_config() is None
    with memory.scoped("enforce", allowed_mem=100, export_env=True):
        cfg = memory.get_guard_config()
        assert cfg is not None and cfg.mode == "enforce" and cfg.allowed_mem == 100
        assert memory.MEMORY_GUARD_ENV_VAR in os.environ
    assert memory.get_guard_config() is None
    monkeypatch.setenv(memory.MEMORY_GUARD_ENV_VAR, MemoryGuardConfig(mode="off", allowed_mem=5).to_env_json())
    with memory.scoped("enforce", allowed_mem=100, export_env=True):
        assert memory.get_guard_config().mode == "off"
    assert memory.get_guard_config().mode == "off"
    monkeypatch.setenv(memory.MEMORY_GUARD_ENV_VAR, "off")
    assert memory.get_guard_config().mode == "off"


def test_bare_mode_env_inherits_armed_allowed_mem(monkeypatch):
    monkeypatch.setenv(memory.MEMORY_GUARD_ENV_VAR, "enforce")
    with memory.scoped("observe", allowed_mem=777):
        cfg = memory.get_guard_config()
        assert cfg.mode == "enforce" and cfg.allowed_mem == 777 and cfg.enabled
    cfg = memory.get_guard_config()
    assert cfg.mode == "enforce" and not cfg.enabled
    monkeypatch.setenv(memory.MEMORY_GUARD_ENV_VAR, "strict")
    with pytest.raises(ValueError, match="invalid memory_guard mode"):
        memory.get_guard_config()


def test_spec_memory_guard_validation(tmp_path):
    assert ct.Spec(work_dir=str(tmp_path), memory_guard="enforce").memory_guard == "enforce"
    assert ct.Spec(work_dir=str(tmp_path)).memory_guard is None
    with pytest.raises(ValueError, match="invalid memory_guard"):
        ct.Spec(work_dir=str(tmp_path), memory_guard="strict")


def test_guard_off_is_noop():
    with memory.scoped("off", allowed_mem=1):
        with task_guard("k", injected_bytes=10**12) as g:
            pass
        assert g.measured is None and g.stats() == {}
        assert not memory._tasks
    with task_guard("k", injected_bytes=10**12) as g:
        pass
    assert g.stats() == {}


# -- the per-task guard (needs /proc) ------------------------------------


@pytest.mark.mem
def test_observe_mode_counts_and_warns(caplog):
    before = get_registry().snapshot()
    with memory.scoped("observe", allowed_mem=1024):
        with caplog.at_level("WARNING", logger="cubed_tpu_torch.runtime.memory"):
            with task_guard("chunk-0", injected_bytes=10 * 1024 * 1024) as g:
                pass
    assert g.measured is not None and g.measured >= 10 * 1024 * 1024
    assert g.stats()["guard_mem_peak"] == g.measured
    assert g.device_measured is None  # the CPU: no allocator reading
    assert memory.last_readings()["measured"] == g.measured
    assert get_registry().snapshot_delta(before).get("mem_guard_soft_exceeded", 0) == 1
    assert any("memory guard (observe)" in r.message for r in caplog.records)


@pytest.mark.mem
def test_enforce_mode_raises_with_measured_and_allowed():
    with memory.scoped("enforce", allowed_mem=1024):
        with pytest.raises(MemoryGuardExceededError) as ei:
            with task_guard("chunk-1", injected_bytes=10 * 1024 * 1024):
                pass
    e = ei.value
    assert e.chunk_key == "chunk-1" and e.measured >= 10 * 1024 * 1024 and e.allowed == 1024
    assert "allowed_mem" in str(e)


@pytest.mark.mem
def test_enforce_never_masks_the_body_error():
    with memory.scoped("enforce", allowed_mem=1):
        with pytest.raises(ValueError, match="body failed"):
            with task_guard("chunk-2", injected_bytes=10**9):
                raise ValueError("body failed")


@pytest.mark.mem
def test_guard_measures_real_allocation(monkeypatch):
    """No injection: a task allocating well past allowed_mem is caught by
    RSS-growth sampling. The task maps and touches 60 MB of pages of its
    own: a heap allocation can reuse free memory that earlier tests left
    resident in this process, and then the process's RSS does not grow."""
    import mmap

    from cubed_tpu_torch.runtime.utils import execute_with_stats

    monkeypatch.delenv(memory.MEMORY_GUARD_ENV_VAR, raising=False)

    def hog(_m, config=None):
        big = mmap.mmap(-1, 60 * 1024 * 1024)  # ~60 MB of fresh pages
        for offset in range(0, len(big), mmap.PAGESIZE):
            big[offset] = 1
        time.sleep(0.08)  # a few sampler periods
        return big

    with memory.scoped("enforce", allowed_mem=16 * 1024 * 1024):
        with pytest.raises(MemoryGuardExceededError):
            execute_with_stats(hog, 0)


@pytest.mark.mem
def test_guard_stats_ride_task_end_event():
    from cubed_tpu_torch.runtime.utils import execute_with_stats

    with memory.scoped("observe", allowed_mem=10**12):
        _, stats = execute_with_stats(lambda m, config=None: m, 7)
    assert stats["guard_mem_peak"] >= 0


def test_sampler_stops_and_restarts():
    with memory.scoped("observe", allowed_mem=10**12):
        with task_guard("k"):
            pass
    memory.stop_sampler()
    assert memory._sampler_thread is None
    with memory.scoped("observe", allowed_mem=10**12):
        with task_guard("k") as g:
            pass
    assert g.measured is not None


# -- admission controller ------------------------------------------------


def _admission_trace(controller_cls):
    c = controller_cls()
    out = [c.limit, c.has_slot(64)]
    c.step_down(8)
    out.append(c.limit)
    c.step_down(4)
    out.append(c.limit)
    for n in (2, 4, 8, 16, 32):
        for _ in range(n):
            c.on_success(True)
        out.append(c.limit)
    return out


def test_admission_stepdown_then_multiplicative_restore():
    before = get_registry().snapshot()
    mine = _admission_trace(AdmissionController)
    assert mine[:4] == [None, True, 4, 2]
    assert mine[-1] is None
    assert mine == _admission_trace(ref_memory.AdmissionController)
    delta = get_registry().snapshot_delta(before)
    assert delta.get("mem_pressure_stepdowns", 0) == 2
    assert delta.get("mem_pressure_restores", 0) >= 2


def test_admission_pressure_does_not_restore():
    c = AdmissionController()
    c.step_down(8)
    assert c.limit == 4
    for _ in range(16):
        c.on_success(False)
    assert c.limit == 4


def test_admission_floor_is_one():
    c = AdmissionController()
    c.step_down(1)
    c.step_down(1)
    assert c.limit == 1
    assert c.has_slot(0) and not c.has_slot(1)


# -- the sequential executor ---------------------------------------------


def test_sequential_resource_exhaustion_is_actionable(tmp_path):
    def always_oom(x):
        raise MemoryError("cannot allocate")

    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(np.ones((4, 4)), chunks=(2, 2), spec=spec)
    r = ct.map_blocks(always_oom, a, dtype=np.float64)
    with pytest.raises(MemoryGuardExceededError, match="allowed_mem") as ei:
        r.compute(executor=PythonDagExecutor(retries=1))
    assert "even at concurrency 1" in str(ei.value)


def test_sequential_card_out_of_memory_is_actionable(tmp_path):
    """A CUDA out-of-memory (raised here as torch's class) classifies
    RESOURCE: retried, then the actionable abort."""
    calls = {"n": 0}

    def card_oom(x):
        calls["n"] += 1
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB")

    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(np.ones((4, 4)), chunks=(2, 2), spec=spec)
    r = ct.map_blocks(card_oom, a, dtype=np.float64)
    calls["n"] = 0  # map_blocks traces its function once at plan time
    before = get_registry().snapshot()
    with pytest.raises(MemoryGuardExceededError, match="OutOfMemoryError") as ei:
        r.compute(executor=PythonDagExecutor(retries=2, retry_policy=RetryPolicy(retries=2, backoff_base=0.0)))
    assert isinstance(ei.value.__cause__, torch.OutOfMemoryError)
    assert calls["n"] == 3
    assert get_registry().snapshot_delta(before).get("task_resource_failures", 0) == 3


@contextlib.contextmanager
def _pinned_names(base: int):
    """Pin both packages' plan-name counters to *base*, so the same plan
    built in each has the same array names, and so the same task keys
    (which the injector hashes)."""
    import cubed_tpu.utils as ref_utils
    import cubed_tpu_torch.utils as utils

    saved = (utils.sym_counter, ref_utils.sym_counter)
    utils.sym_counter = itertools.count(base)
    ref_utils.sym_counter = itertools.count(base)
    try:
        yield
    finally:
        used = max(next(utils.sym_counter), next(ref_utils.sym_counter)) - base
        utils.sym_counter = itertools.count(next(saved[0]) + used)
        ref_utils.sym_counter = itertools.count(next(saved[1]) + used)


SPIKE = dict(seed=11, task_mem_spike_rate=0.5, task_mem_spike_bytes=600_000_000)


def _spiked_run(pkg, mod, executor, registry, collect_mod, tmp_path, mode, base):
    """One package's run of the spiked plan, in a fresh work dir at the same
    path (the create-arrays task's key names its stores' paths)."""
    import shutil

    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    work = tmp_path / "work"
    shutil.rmtree(work, ignore_errors=True)
    with _pinned_names(base):
        spec = pkg.Spec(work_dir=str(work), allowed_mem="500MB", memory_guard=mode, fault_injection=SPIKE)
        b = mod.add(pkg.from_array(an, chunks=(2, 2), spec=spec), 1.0)
    t0 = __import__(f"{pkg.__name__}.observability.clock", fromlist=["now"]).now()
    before = registry().snapshot()
    try:
        result, error = b.compute(executor=executor), None
    except Exception as e:  # the enforce outcome
        result, error = None, e
    delta = registry().snapshot_delta(before)
    decisions = [(d["kind"], d.get("chunk") or d.get("op"), d.get("classification"))
                 for d in collect_mod.decisions_since(t0)
                 if d["kind"] in ("guard_soft_exceeded", "task_failed", "retry")]
    counters = {k: delta.get(k, 0) for k in (
        "faults_injected_task_mem_spike", "mem_guard_soft_exceeded", "mem_guard_hard_exceeded",
        "task_resource_failures", "task_retries", "mem_guard_aborts")}
    return result, error, counters, decisions


@pytest.mark.mem
@pytest.mark.parametrize("mode", ["observe", "enforce"])
def test_spiked_outcomes_counters_and_decisions_equal_the_reference(tmp_path, mode, monkeypatch):
    import cubed_tpu.core.plan as ref_plan
    import cubed_tpu_torch.core.plan as plan

    # one context id for both packages' temp stores, so both plans' task
    # keys are equal
    monkeypatch.setattr(plan, "CONTEXT_ID", "ctx-guard-parity")
    monkeypatch.setattr(ref_plan, "CONTEXT_ID", "ctx-guard-parity")
    kw = dict(retries=3, backoff_base=0.0, seed=0)
    mine = _spiked_run(ct, xp, PythonDagExecutor(retry_policy=RetryPolicy(**kw)), get_registry, collect,
                       tmp_path, mode, 880_000_000)
    ref_policy = __import__("cubed_tpu.runtime.resilience", fromlist=["RetryPolicy"]).RetryPolicy(**kw)
    theirs = _spiked_run(ct_ref, ref_xp, RefPythonDagExecutor(retry_policy=ref_policy), ref_registry, ref_collect,
                         tmp_path, mode, 880_000_000)
    assert (mine[0] is None) == (theirs[0] is None)
    if mine[0] is not None:
        np.testing.assert_array_equal(mine[0], theirs[0])
    assert type(mine[1]).__name__ == type(theirs[1]).__name__
    assert mine[2] == theirs[2]
    assert mine[3] == theirs[3]
    assert mine[2]["faults_injected_task_mem_spike"] > 0
    if mode == "observe":
        assert mine[2]["mem_guard_soft_exceeded"] > 0 and mine[1] is None
    else:
        assert mine[2]["mem_guard_hard_exceeded"] > 0


@pytest.mark.chaos
def test_chaos_guard_off_ignores_spikes(tmp_path):
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", memory_guard="off",
                   fault_injection=dict(seed=5, task_mem_spike_rate=1.0, task_mem_spike_bytes=10**12))
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    a = ct.from_array(an, chunks=(2, 2), spec=spec)

    class Cap:
        stats: dict = {}

        def on_compute_end(self, event):
            self.stats = event.executor_stats or {}

    cap = Cap()
    np.testing.assert_array_equal(xp.add(a, 1.0).compute(callbacks=[cap]), an + 1.0)
    assert cap.stats.get("mem_guard_hard_exceeded", 0) == 0
    assert cap.stats.get("mem_guard_soft_exceeded", 0) == 0


def test_per_op_summary_flags_mem_over_projected():
    from cubed_tpu_torch.observability.callback import _ComputeAggregator
    from cubed_tpu_torch.observability.events import PlanRow
    from cubed_tpu_torch.runtime.types import OperationEndEvent, OperationStartEvent, TaskEndEvent

    agg = _ComputeAggregator()
    agg.plan = [PlanRow(array_name="op-big", op_name="add", projected_mem=1_000_000, reserved_mem=0, num_tasks=1)]
    agg.on_operation_start(OperationStartEvent("op-big", 1))
    # a task's own reading (it names its chunk); the device executor's
    # per-op events carry a whole unit's reading and no chunk key
    agg.on_task_end(TaskEndEvent(array_name="op-big", chunk_key="('op-big', 0)", guard_mem_peak=500_000_000))
    agg.on_task_end(TaskEndEvent(array_name="op-big", guard_mem_peak=900_000_000))
    agg.on_operation_end(OperationEndEvent("op-big", 1))
    row = agg.summary()["per_op"]["op-big"]
    assert row["guard_peak_mem"] == 500_000_000 and row["mem_over_projected"] is True


def test_task_mem_spike_rolls_are_seeded_and_per_occurrence():
    cfg = dict(seed=3, task_mem_spike_rate=0.5, task_mem_spike_bytes=123)
    rolls = [faults.FaultInjector(faults.FaultConfig(**cfg)).task_mem_spike("k") for _ in range(1)]
    inj = faults.FaultInjector(faults.FaultConfig(**cfg))
    ref_inj = ref_faults.FaultInjector(ref_faults.FaultConfig(**cfg))
    rolls = [inj.task_mem_spike("k") for _ in range(32)]
    assert rolls == [ref_inj.task_mem_spike("k") for _ in range(32)]
    assert 0 in rolls and 123 in rolls
    assert faults.FaultInjector(faults.FaultConfig(seed=3)).task_mem_spike("k") == 0


def test_a_failed_compute_frees_its_task_blocks_without_a_collection(tmp_path):
    """A compute that fails leaves no reference cycle holding the failed
    task's blocks (on the card, its device memory) until the next garbage
    collection: the card's out-of-memory check reads ``memory_allocated``
    back at its value before the compute right after the abort."""
    import gc
    import weakref

    blocks = []

    def card_oom(x):
        if x.numel() and not getattr(x, "is_meta", False):
            blocks.append(weakref.ref(x))
            raise torch.OutOfMemoryError("CUDA out of memory")
        return x

    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    r = ct.map_blocks(card_oom, ct.random.random((8, 8), chunks=4, spec=spec), dtype=np.float64)
    blocks.clear()  # map_blocks traces its function once at plan time
    enabled = gc.isenabled()
    gc.disable()
    try:
        with pytest.raises(MemoryGuardExceededError):
            r.compute(executor=PythonDagExecutor(retries=1))
        assert len(blocks) == 2 and all(ref() is None for ref in blocks)
    finally:
        if enabled:
            gc.enable()


# -- the threaded executor under seeded spikes ------------------------------


class _StatsCapture:
    stats: dict = {}

    def on_compute_end(self, event):
        self.stats = event.executor_stats or {}


THREADED_SPIKE = dict(seed=11, task_mem_spike_rate=0.25, task_mem_spike_bytes=600_000_000)


@pytest.mark.chaos
@pytest.mark.mem
def test_chaos_threaded_mem_spikes_degrade_and_complete(tmp_path):
    """About one attempt in four spikes over the budget: the threaded
    executor steps admission down, throttles, and completes; the result
    equals the reference's threaded run of the same seeded plan bit for bit
    (thread order varies which attempts spike, so the counts are not
    compared between the packages)."""
    from cubed_tpu.runtime.executors.python_async import AsyncPythonDagExecutor as RefAsyncPythonDagExecutor
    from cubed_tpu.runtime.resilience import RetryPolicy as RefRetryPolicy

    an = np.arange(400, dtype=np.float64).reshape(20, 20)
    results = {}
    cap = _StatsCapture()
    for name, pkg, mod, ex in (
        ("port", ct, xp, AsyncPythonDagExecutor(retry_policy=RetryPolicy(retries=6, backoff_base=0.005, seed=0))),
        ("ref", ct_ref, ref_xp, RefAsyncPythonDagExecutor(
            retry_policy=RefRetryPolicy(retries=6, backoff_base=0.005, seed=0))),
    ):
        with _pinned_names(900_000_000):
            spec = pkg.Spec(work_dir=str(tmp_path / name), allowed_mem="500MB", fault_injection=THREADED_SPIKE,
                            memory_guard="enforce")
            arr = mod.add(pkg.from_array(an, chunks=(2, 2), spec=spec), 1.0)  # 100 tasks
        results[name] = arr.compute(executor=ex, callbacks=[cap] if name == "port" else None)
    np.testing.assert_array_equal(results["port"], results["ref"])
    np.testing.assert_array_equal(results["port"], an + 1.0)
    for counter in ("faults_injected_task_mem_spike", "mem_guard_hard_exceeded", "mem_pressure_stepdowns",
                    "tasks_throttled"):
        assert cap.stats.get(counter, 0) > 0, (counter, cap.stats)


@pytest.mark.chaos
@pytest.mark.mem
def test_chaos_unfixable_over_memory_op_aborts_promptly(tmp_path):
    """Every attempt spikes: admission degrades to one task in flight, then
    the compute aborts with the actionable error, in fewer attempts than
    plain retries would take."""
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", memory_guard="enforce",
                   fault_injection=dict(seed=5, task_mem_spike_rate=1.0, task_mem_spike_bytes=600_000_000))
    a = ct.from_array(np.arange(64, dtype=np.float64).reshape(8, 8), chunks=(2, 2), spec=spec)  # 16 tasks
    n_tasks, retries = 16, 6
    cap = _StatsCapture()
    with pytest.raises(MemoryGuardExceededError, match="allowed_mem"):
        xp.add(a, 1.0).compute(
            executor=AsyncPythonDagExecutor(retry_policy=RetryPolicy(retries=retries, backoff_base=0.005, seed=0)),
            callbacks=[cap])
    assert cap.stats.get("tasks_started", 0) < n_tasks * (retries + 1), cap.stats
    assert cap.stats.get("mem_guard_aborts", 0) >= 1, cap.stats


@pytest.mark.chaos
def test_chaos_guard_off_ignores_spikes_threaded(tmp_path):
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", memory_guard="off",
                   fault_injection=dict(seed=5, task_mem_spike_rate=1.0, task_mem_spike_bytes=10**12))
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    cap = _StatsCapture()
    result = xp.add(ct.from_array(an, chunks=(2, 2), spec=spec), 1.0).compute(
        executor=AsyncPythonDagExecutor(), callbacks=[cap])
    np.testing.assert_array_equal(result, an + 1.0)
    for counter in ("mem_guard_hard_exceeded", "mem_guard_soft_exceeded", "mem_pressure_stepdowns"):
        assert cap.stats.get(counter, 0) == 0, (counter, cap.stats)


# -- the device reading under concurrency, on a fake allocator ---------------


class FakeAllocator:
    """A caching allocator's byte counts (current and peak since the last
    reset), and for each task in flight the reset-based reading the guard
    took when it reset the statistics at every task: its peak over its own
    start, less that start."""

    def __init__(self):
        self.current = self.peak = self.true_peak = 0
        self.resets = 0
        self.own = {}  # task -> [bytes it holds, most it held]
        self.windows = {}  # task -> [start, peak since its start]

    def stats(self, dev):
        return {"allocated": {"current": self.current, "peak": self.peak},
                "reserved": {"current": self.current, "peak": self.peak}}

    def reset(self, dev):
        self.peak = self.current
        self.resets += 1

    def enter(self, task):
        self.own[task] = [0, 0]
        self.windows[task] = [self.current, self.current]

    def alloc(self, task, n):
        self.current += n
        self.peak = max(self.peak, self.current)
        self.true_peak = max(self.true_peak, self.current)
        self.own[task][0] += n
        self.own[task][1] = max(self.own[task][1], self.own[task][0])
        for w in self.windows.values():
            w[1] = max(w[1], self.current)

    def free(self, task, n):
        self.current -= n
        self.own[task][0] -= n

    def reset_based(self, task) -> int:
        start, peak = self.windows[task]
        return peak - start


@pytest.fixture
def fake_card(monkeypatch):
    fake = FakeAllocator()
    monkeypatch.setattr(memory, "_guard_device", lambda: torch.device("cuda", 0))
    monkeypatch.setattr(memory, "_allocator_stats", fake.stats)
    monkeypatch.setattr(memory, "_reset_peaks", fake.reset)
    monkeypatch.setattr(memory, "_capturing", lambda: False)
    monkeypatch.setattr(memory, "_read_rss", lambda max_age_s=0.0: None)  # the device reading alone
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(memory, "_windows", {})
    monkeypatch.setattr(memory, "_device_fold", {})
    fake.current = 1000  # blocks held before any task (resident arrays)
    fake.peak = fake.true_peak = 1000
    with memory.scoped("observe", allowed_mem=10**12):
        yield fake


def _schedule(rng, n_tasks: int, steps: int = 4) -> list:
    """A random interleaving of *n_tasks* tasks' events: each enters, makes
    *steps* allocations or frees of its own blocks, and exits, in order."""
    events = {t: ["enter"] + [("alloc" if rng.random() < 0.6 else "free") for _ in range(steps)] + ["exit"]
              for t in range(n_tasks)}
    order = []
    while events:
        t = int(rng.choice(sorted(events)))
        order.append((t, events[t].pop(0)))
        if not events[t]:
            del events[t]
    return order


def _drive(fake, order, rng) -> dict:
    """Run *order* through task guards; each task's (reading, reset-based
    reading, own growth)."""
    guards, out = {}, {}
    for t, event in order:
        if event == "enter":
            fake.enter(t)
            guards[t] = memory.task_guard(f"t{t}", observe_only=True).__enter__()
        elif event == "alloc":
            fake.alloc(t, int(rng.integers(1, 5)) * 256)
        elif event == "free":
            held = fake.own[t][0]
            if held:
                fake.free(t, int(rng.integers(1, held // 256 + 1)) * 256)
        else:
            fake.free(t, fake.own[t][0])
            g = guards.pop(t)
            g.__exit__(None, None, None)
            out[t] = (g.device_measured, fake.reset_based(t), fake.own[t][1])
            del fake.windows[t]
    return out


@pytest.mark.parametrize("seed", range(6))
def test_guard_at_one_task_in_flight_equals_the_reset_based_reading(fake_card, seed):
    rng = np.random.default_rng(seed)
    order = [(t, e) for t in range(4) for e in ["enter", "alloc", "free", "alloc", "alloc", "exit"]]
    readings = _drive(fake_card, order, rng)
    assert all(reading == reset_based for reading, reset_based, _own in readings.values()), readings
    assert fake_card.resets == 4  # each task opened its own window
    assert memory.device_peaks()["allocated"] == fake_card.true_peak


@pytest.mark.parametrize("n_tasks", [2, 4])
@pytest.mark.parametrize("seed", range(8))
def test_guard_under_concurrency_never_reads_below_a_tasks_own_growth(fake_card, n_tasks, seed):
    """Interleaved tasks: each reading is at least the task's own growth and
    at least its reset-based reading (the window's peak covers its own
    interval); the compute-level peak keeps the true peak."""
    rng = np.random.default_rng(100 * n_tasks + seed)
    readings = _drive(fake_card, _schedule(rng, n_tasks), rng)
    assert len(readings) == n_tasks
    for t, (reading, reset_based, own) in readings.items():
        assert reading >= own, (t, readings)
        assert reading >= reset_based, (t, readings)
    assert memory.device_peaks()["allocated"] == fake_card.true_peak
    assert memory._windows[0][0] == 0  # every task left its window


def test_guard_reading_when_another_task_frees_under_it(fake_card):
    """Task 0 holds 4 KiB when task 1 starts, then frees it; task 1 then
    allocates 2 KiB. Task 1's reading is at least its own 2 KiB (a reading
    from its own start would be 0: the window's base is the bytes allocated
    when the first task in flight started)."""
    fake = fake_card
    rng = np.random.default_rng(0)
    fake.enter(0)
    g0 = memory.task_guard("t0", observe_only=True).__enter__()
    fake.alloc(0, 4096)
    fake.enter(1)
    g1 = memory.task_guard("t1", observe_only=True).__enter__()
    fake.free(0, 4096)
    g0.__exit__(None, None, None)
    fake.alloc(1, 2048)
    fake.free(1, 2048)
    g1.__exit__(None, None, None)
    assert g0.device_measured == 4096
    assert g1.device_measured >= 2048
    assert fake.resets == 1
    del rng


def test_guard_on_the_card_is_per_thread_and_opens_one_window(fake_card):
    """Two threads' guards in flight at once share one window, and each
    thread's ``last_readings`` is its own task's."""
    import threading

    fake = fake_card
    entered, release = threading.Barrier(2), threading.Event()
    seen = {}

    def task(t, nbytes):
        with memory.task_guard(f"t{t}", observe_only=True):
            fake.current += nbytes
            fake.peak = max(fake.peak, fake.current)
            entered.wait()
            release.wait(5)
        seen[t] = memory.last_readings()["key"]

    threads = [threading.Thread(target=task, args=(t, 512 * (t + 1))) for t in range(2)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 5
    while memory._windows.get(0, [0])[0] < 2 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert memory._windows[0][0] == 2  # both in flight in one window
    release.set()
    for th in threads:
        th.join(5)
    assert seen == {0: "t0", 1: "t1"}
    assert fake.resets == 1


def test_guard_windows_under_a_thread_stress(fake_card):
    """16 threads, each entering and leaving 40 guards with allocations in
    between, under a 1 us switch interval: every reading is at least its
    task's own growth, every window closes, and the compute-level peak
    holds the true peak (a lost update to the window count would leave it
    open or reset it under a task in flight)."""
    import sys
    import threading

    fake = fake_card
    lock = threading.Lock()
    failures: list = []

    def alloc(n):
        with lock:
            fake.current += n
            fake.peak = max(fake.peak, fake.current)
            fake.true_peak = max(fake.true_peak, fake.current)

    def worker(t):
        rng = np.random.default_rng(t)
        for _ in range(40):
            with memory.task_guard(f"t{t}", observe_only=True) as g:
                held = int(rng.integers(1, 8)) * 512
                alloc(held)
                alloc(-held)
            if g.device_measured < held:
                failures.append((t, g.device_measured, held))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert failures == []
    assert memory._windows[0][0] == 0
    assert memory.device_peaks()["allocated"] == fake.true_peak
