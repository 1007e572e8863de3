"""The runtime memory guard in the port, held against the JAX package's:
RESOURCE classification, the guard's modes, its config and activation, the
admission controller, and the sequential executor's outcomes, counters and
decisions under seeded memory spikes (counterpart of the sequential and unit
cases of tests/runtime/test_memory_guard.py). The guard's device reading
(the card's allocator) is tested in tests/test_torch_cuda.py."""

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
def test_guard_measures_real_allocation():
    """No injection: a task allocating well past allowed_mem is caught by
    RSS-growth sampling."""
    from cubed_tpu_torch.runtime.utils import execute_with_stats

    def hog(_m, config=None):
        big = np.ones(60 * 1024 * 1024 // 8, dtype=np.float64)  # ~60 MB
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
