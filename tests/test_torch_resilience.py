"""The port's resilience layer held against the JAX package's: classification,
backoff, the retry budget and the deterministic fault injector
(counterpart of tests/runtime/test_resilience.py), plus the card's two error
rules (a CUDA out-of-memory classifies RESOURCE; a CUDA error that poisons
the context FAIL_FAST), tested on the CPU by raising torch's classes."""

from __future__ import annotations

import os
from concurrent.futures.process import BrokenProcessPool

import pytest
import torch

from cubed_tpu.observability.accounting import task_scope as ref_task_scope
from cubed_tpu.runtime import faults as ref_faults
from cubed_tpu.runtime import resilience as ref
from cubed_tpu_torch.backend_array_api import set_device
from cubed_tpu_torch.observability.accounting import task_scope
from cubed_tpu_torch.runtime import faults
from cubed_tpu_torch.runtime.faults import FaultConfig, FaultInjector
from cubed_tpu_torch.runtime.resilience import (
    Classification,
    RetryBudget,
    RetryPolicy,
    resolve_policy,
)


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    yield


def _both(make):
    """The classification of the same exception in both packages (each
    package's own classes where the exception is one of its types)."""
    return RetryPolicy().classify(make(torch_side=True)), ref.RetryPolicy().classify(make(torch_side=False))


# -- classification ------------------------------------------------------


@pytest.mark.parametrize(
    "exc",
    [
        TypeError("bad arg"),
        AssertionError("invariant"),
        ValueError("deterministic"),
        KeyError("missing"),
        IndexError("oob"),
        ZeroDivisionError(),
        NotImplementedError(),
        AttributeError("nope"),
    ],
)
def test_programming_errors_fail_fast(exc):
    assert RetryPolicy().classify(exc) is Classification.FAIL_FAST
    assert ref.RetryPolicy().classify(exc).name == "FAIL_FAST"


@pytest.mark.parametrize(
    "name",
    ["oserror", "reset", "timeout", "runtime", "injected_io", "injected_task"],
)
def test_transient_errors_retry(name):
    def make(torch_side):
        mod = faults if torch_side else ref_faults
        return {
            "oserror": OSError("io blip"),
            "reset": ConnectionResetError(),
            "timeout": TimeoutError("slow"),
            "runtime": RuntimeError("unknown user error"),
            "injected_io": mod.FaultInjectedIOError("injected"),
            "injected_task": mod.FaultInjectedTaskError("injected"),
        }[name]

    mine, theirs = _both(make)
    assert mine is Classification.RETRY
    assert theirs.name == mine.name


def test_worker_loss_requeues():
    # the fleet's WorkerLostError comes with the fleet; the classifications,
    # REQUEUE and its per-task cap among them, are the reference's
    assert {c.name: c.value for c in Classification} == {c.name: c.value for c in ref.Classification}
    assert RetryPolicy().max_requeues == ref.RetryPolicy().max_requeues


def test_broken_pool_requeues_not_retries():
    exc = BrokenProcessPool("pool died")
    assert RetryPolicy().classify(exc) is Classification.REQUEUE
    assert ref.RetryPolicy().classify(exc) is ref.Classification.REQUEUE


def test_fail_fast_covers_subclasses():
    class MyValueError(ValueError):
        pass

    assert RetryPolicy().classify(MyValueError()) is Classification.FAIL_FAST
    assert ref.RetryPolicy().classify(MyValueError()).name == "FAIL_FAST"


def test_remote_error_classified_by_shipped_type_name():
    # the fleet's RemoteTaskError is not ported; the type-name tables the
    # wire classification reads are, and equal the reference's
    from cubed_tpu.runtime.memory import RESOURCE_TYPE_NAMES as REF_RESOURCE
    from cubed_tpu_torch.runtime.memory import RESOURCE_TYPE_NAMES

    assert ref.FAIL_FAST_TYPE_NAMES == __import__(
        "cubed_tpu_torch.runtime.resilience", fromlist=["FAIL_FAST_TYPE_NAMES"]
    ).FAIL_FAST_TYPE_NAMES
    assert RESOURCE_TYPE_NAMES == REF_RESOURCE | {"OutOfMemoryError"}


@pytest.mark.parametrize("make", [
    lambda: torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    lambda: torch.cuda.OutOfMemoryError("CUDA out of memory"),
    lambda: MemoryError(),
])
def test_card_out_of_memory_classifies_resource(make):
    assert RetryPolicy().classify(make()) is Classification.RESOURCE


@pytest.mark.parametrize("make", [
    lambda: torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
    lambda: RuntimeError("CUDA error: an illegal memory access was encountered\nCUDA kernel errors might be "
                         "asynchronously reported at some other API call"),
    lambda: RuntimeError("CUDA error: device-side assert triggered"),
])
def test_sticky_cuda_error_fails_fast(make):
    exc = make()
    assert RetryPolicy().classify(exc) is Classification.FAIL_FAST
    # the reference, which knows no card, would retry the plain forms
    if type(exc) is RuntimeError:
        assert ref.RetryPolicy().classify(exc).name == "RETRY"


# -- backoff -------------------------------------------------------------


def test_backoff_grows_exponentially_and_caps():
    kw = dict(backoff_base=0.1, backoff_multiplier=2.0, backoff_max=1.0, jitter="none")
    mine = [RetryPolicy(**kw).backoff_delay(n) for n in (1, 2, 3, 4, 5)]
    assert mine == [0.1, 0.2, 0.4, 0.8, 1.0]
    assert mine == [ref.RetryPolicy(**kw).backoff_delay(n) for n in (1, 2, 3, 4, 5)]


def test_full_jitter_bounded_and_seeded():
    p1 = RetryPolicy(backoff_base=0.1, jitter="full", seed=7)
    p2 = ref.RetryPolicy(backoff_base=0.1, jitter="full", seed=7)
    d1 = [p1.backoff_delay(n % 5 + 1) for n in range(40)]
    d2 = [p2.backoff_delay(n % 5 + 1) for n in range(40)]
    assert d1 == d2  # same seed, the same delays in both packages
    assert all(0.0 <= d <= p1.backoff_ceiling(n % 5 + 1) for n, d in enumerate(d1))
    assert len(set(d1)) > 1


def test_bad_jitter_rejected():
    with pytest.raises(ValueError, match="jitter"):
        RetryPolicy(jitter="decorrelated")


# -- budget --------------------------------------------------------------


def test_budget_sizing_and_exhaustion():
    for n in (0, 1, 7, 100, 921):
        assert RetryPolicy(retries=2, budget_factor=0.5, budget_min=3).new_budget(n).limit == \
            ref.RetryPolicy(retries=2, budget_factor=0.5, budget_min=3).new_budget(n).limit
    b2 = RetryPolicy(retries=2, budget_factor=0.5, budget_min=3).new_budget(1)
    assert b2.limit == 3
    assert all(b2.consume() for _ in range(3))
    assert not b2.consume()
    assert b2.remaining == 0


def test_budget_disabled():
    b = RetryPolicy(budget_factor=None).new_budget(1000)
    assert b.limit is None
    assert all(b.consume() for _ in range(10_000))
    assert RetryBudget(None).remaining is None


def test_resolve_policy_prefers_explicit_policy():
    p = RetryPolicy(retries=7)
    assert resolve_policy(p, 1) is p
    assert resolve_policy(None, 4).retries == 4
    assert resolve_policy(None, None).retries == ref.resolve_policy(None, None).retries == 2


# -- fault injector ------------------------------------------------------


def _roll_series(inj, n=32):
    return [inj.storage_write_fault(f"chunk-{i}") for i in range(n)]


def test_injector_deterministic_and_seed_sensitive():
    cfg = dict(seed=3, storage_write_failure_rate=0.3)
    with task_scope():
        rolls1 = _roll_series(FaultInjector(FaultConfig(**cfg)))
        rolls2 = _roll_series(FaultInjector(FaultConfig(**cfg)))
        other = _roll_series(FaultInjector(FaultConfig(seed=4, storage_write_failure_rate=0.3)))
    with ref_task_scope():
        theirs = _roll_series(ref_faults.FaultInjector(ref_faults.FaultConfig(**cfg)))
    assert rolls1 == rolls2 == theirs
    assert rolls1 != other


def test_injector_retry_rolls_fresh_decision():
    inj = FaultInjector(FaultConfig(seed=0, storage_write_failure_rate=0.5))
    with task_scope():
        first = {k: inj.storage_write_fault(k) for k in map(str, range(64))}
        failed = [k for k, hit in first.items() if hit]
        assert failed
        for k in failed:
            assert any(not inj.storage_write_fault(k) for _ in range(8)), f"key {k} never recovered"


def test_injector_inactive_outside_task_scope():
    inj = FaultInjector(FaultConfig(seed=0, storage_write_failure_rate=1.0))
    assert not inj.storage_write_fault("k")
    with task_scope():
        assert inj.storage_write_fault("k")


def test_env_activation_round_trip(monkeypatch):
    cfg = FaultConfig(seed=9, task_failure_rate=0.25, worker_crash_names=("w0",))
    monkeypatch.setenv(faults.FAULTS_ENV_VAR, cfg.to_env_json())
    inj = faults.get_injector()
    assert inj is not None and inj.config == cfg
    # the JSON round-trips between the packages, every field
    assert ref_faults.FaultConfig.from_dict(__import__("json").loads(cfg.to_env_json())).to_env_json() == \
        cfg.to_env_json()
    monkeypatch.delenv(faults.FAULTS_ENV_VAR)
    assert faults.get_injector() is None
    assert faults.FAULTS_ENV_VAR == "CUBED_TPU_TORCH_FAULTS"


def test_env_all_rates_zero_is_inactive(monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV_VAR, FaultConfig(seed=1).to_env_json())
    assert faults.get_injector() is None


def test_unknown_config_field_rejected():
    with pytest.raises(ValueError, match="unknown FaultConfig fields"):
        FaultConfig.from_dict({"storge_write_failure_rate": 0.1})


def test_scoped_activation_restores(monkeypatch):
    monkeypatch.delenv(faults.FAULTS_ENV_VAR, raising=False)
    assert faults.get_injector() is None
    with faults.scoped({"seed": 1, "task_failure_rate": 0.5}, export_env=True):
        assert faults.get_injector() is not None
        assert os.environ.get(faults.FAULTS_ENV_VAR)
    assert faults.get_injector() is None
    assert faults.FAULTS_ENV_VAR not in os.environ


def test_scoped_none_is_noop():
    with faults.scoped(None) as inj:
        assert inj is None


def test_wire_config_round_trip(monkeypatch):
    # the fleet's wire (it carries the armed config to each task) comes with
    # the fleet; the armed config serializes as the reference's does
    monkeypatch.delenv(faults.FAULTS_ENV_VAR, raising=False)
    with faults.scoped(FaultConfig(seed=5, task_failure_rate=0.5)) as inj:
        assert faults.get_injector() is inj
        raw = inj.config.to_env_json()
    with ref_faults.scoped(ref_faults.FaultConfig(seed=5, task_failure_rate=0.5)):
        assert ref_faults.wire_config() == raw
    assert faults.get_injector() is None


def test_worker_tick_one_shot():
    # the fleet's worker sites come with the fleet: their fields arm an
    # injector, which injects nothing at the port's live sites
    cfg = FaultConfig(seed=0, worker_crash_names=("local-0",), worker_crash_after_tasks=3)
    assert cfg.any_enabled and ref_faults.FaultConfig(**{"seed": 0, "worker_crash_names": ("local-0",),
                                                          "worker_crash_after_tasks": 3}).any_enabled
    inj = FaultInjector(cfg)
    with task_scope():
        assert not any(inj.storage_write_fault(f"k{i}") or inj.storage_read_fault(f"k{i}") for i in range(50))
        for i in range(50):
            inj.task_fault(f"k{i}")
        assert all(inj.task_mem_spike(f"k{i}") == 0 for i in range(50))
