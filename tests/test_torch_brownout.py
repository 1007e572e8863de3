"""Store-brownout tolerance in the port, held against the JAX package's
(counterpart of tests/storage/test_brownout.py, less the cases that need the
fleet's remote errors, its analytics buckets or the distributed executor):
THROTTLE classification, the per-store breaker's pacing and recovery, and
the chaos proof on the threaded executor: a seeded brownout completes bit
for bit with the breaker engaged and draws fewer task retries than with it
off."""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import numpy as np
import pytest

import cubed_tpu as ct_ref
from cubed_tpu.runtime.executors.python_async import AsyncPythonDagExecutor as RefAsyncPythonDagExecutor
from cubed_tpu.runtime.faults import FaultInjectedThrottleError as RefFaultInjectedThrottleError
from cubed_tpu.runtime.resilience import RetryPolicy as RefRetryPolicy
from cubed_tpu.storage import health as ref_health
import cubed_tpu_torch as ct
from cubed_tpu_torch.backend_array_api import set_device
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime import faults
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor
from cubed_tpu_torch.runtime.faults import FaultInjectedThrottleError
from cubed_tpu_torch.runtime.resilience import Classification, RetryPolicy
from cubed_tpu_torch.storage import health

pytestmark = pytest.mark.chaos

BROWNOUT = dict(seed=23, storage_throttle_rate=0.25)


@pytest.fixture(autouse=True)
def _fresh_breakers():
    set_device("cpu")
    health.reset_breakers()
    ref_health.reset_breakers()
    yield
    health.reset_breakers()
    ref_health.reset_breakers()
    faults.deactivate()


# -- classification ------------------------------------------------------

SHAPES = [
    (OSError("503 SlowDown"), True),
    (OSError("HTTP 429 Too Many Requests"), True),
    (ConnectionError("rate limit exceeded, retry later"), True),
    (OSError("connection reset by peer"), False),
    (ValueError("503"), False),  # not IO-shaped
    (OSError("/tmp/tmp429ab/chunk 0.0 missing"), False),  # digits in a path
    (OSError("HTTP 503: Service Unavailable"), True),
]


def test_is_throttle_error_shapes():
    for exc, throttle in SHAPES:
        assert health.is_throttle_error(exc) is throttle, exc
        assert ref_health.is_throttle_error(exc) is throttle, exc
    assert health.is_throttle_error(FaultInjectedThrottleError("injected store throttle (503 SlowDown)"))
    assert ref_health.is_throttle_error(RefFaultInjectedThrottleError("injected store throttle (503 SlowDown)"))


def test_throttle_classification_local():
    policy = RetryPolicy()
    assert policy.classify(OSError("SlowDown")) is Classification.THROTTLE
    assert policy.classify(FaultInjectedThrottleError("injected store throttle")) is Classification.THROTTLE
    assert policy.classify(OSError("connection reset")) is Classification.RETRY
    ref_policy = RefRetryPolicy()
    for exc in (OSError("SlowDown"), OSError("connection reset")):
        assert policy.classify(exc).name == ref_policy.classify(exc).name


# -- the breaker -----------------------------------------------------------


def _halve_and_restore(module) -> list:
    b = module.StoreHealthBreaker("s3://unit")
    b.PROBE_IDLE_S = 0.05
    b.STEP_COOLDOWN_S = 0.0
    trail = []
    for _ in range(8):
        b.acquire()
    trail.append(b.state)
    delay = b.on_throttle()
    assert 0 < delay <= 1.0
    trail += [b.state, b._limit]
    b.on_throttle()
    trail.append(b._limit)
    for _ in range(8):
        b.release()
    time.sleep(0.06)
    trail.append(b.state)
    for _ in range(64):
        b.on_success()
    trail += [b.state, b._limit]
    return trail


def test_breaker_halves_and_restores_to_unbounded():
    trail = _halve_and_restore(health)
    assert trail == ["closed", "open", 4, 2, "half_open", "closed", None]
    assert trail == _halve_and_restore(ref_health)


def test_breaker_acquire_blocks_until_release():
    b = health.StoreHealthBreaker("s3://block")
    b.STEP_COOLDOWN_S = 0.0
    b.acquire()
    b.on_throttle()  # limit 1 while one IO is in flight
    assert b._limit == 1
    acquired = threading.Event()

    def second():
        b.acquire()
        acquired.set()
        b.release()

    t = threading.Thread(target=second, daemon=True)
    t.start()
    assert not acquired.wait(0.2), "a second IO ran past a limit of 1"
    b.release()
    assert acquired.wait(2.0)
    t.join(timeout=2.0)


def test_breaker_env_off_disables_pacing(monkeypatch):
    assert health.BREAKER_ENV_VAR == "CUBED_TPU_TORCH_STORE_BREAKER"
    monkeypatch.setenv(health.BREAKER_ENV_VAR, "off")
    assert not health.breaker_enabled()
    monkeypatch.setenv(health.BREAKER_ENV_VAR, "")
    assert health.breaker_enabled()


# -- chaos on the threaded executor ----------------------------------------


@contextlib.contextmanager
def _pinned_names(base: int):
    """Both packages' plan-name counters pinned (the injector hashes the
    array names in chunk keys)."""
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


def _brownout_run(tmp_path, name: str, base: int, pkg=ct):
    """One seeded brownout compute on 4 threads: (result, metrics delta)."""
    an = np.arange(400, dtype=np.float64).reshape(20, 20)
    with _pinned_names(base):
        spec = pkg.Spec(work_dir=str(tmp_path / name), allowed_mem="500MB", fault_injection=BROWNOUT)
        b = pkg.from_array(an, chunks=(2, 2), spec=spec) * 2.0  # 100 chunks
    if pkg is ct:
        before = get_registry().snapshot()
        result = b.compute(executor=AsyncPythonDagExecutor(
            max_workers=4, retry_policy=RetryPolicy(retries=6, backoff_base=0.01, seed=0)))
        return result, get_registry().snapshot_delta(before)
    return b.compute(executor=RefAsyncPythonDagExecutor(
        max_workers=4, retry_policy=RefRetryPolicy(retries=6, backoff_base=0.01, seed=0))), None


def test_chaos_brownout_completes_bitwise_with_breaker_engaged(tmp_path):
    an = np.arange(400, dtype=np.float64).reshape(20, 20)
    result, delta = _brownout_run(tmp_path, "on", base=41_000)
    np.testing.assert_array_equal(result, an * 2.0)
    np.testing.assert_array_equal(result, _brownout_run(tmp_path, "ref", base=41_000, pkg=ct_ref)[0])
    assert delta.get("store_throttled", 0) > 0, delta
    assert delta.get("store_breaker_trips", 0) > 0, delta


def test_chaos_breaker_draws_strictly_less_budget_than_off(tmp_path, monkeypatch):
    """Same seed, same names: with the breaker, throttles are absorbed by
    paced retries in place; without it each one that surfaces costs a task
    retry from the compute's budget."""
    an = np.arange(400, dtype=np.float64).reshape(20, 20)
    monkeypatch.setenv(health.BREAKER_ENV_VAR, "off")
    result_off, delta_off = _brownout_run(tmp_path, "off", base=42_000)
    np.testing.assert_array_equal(result_off, an * 2.0)
    health.reset_breakers()
    monkeypatch.delenv(health.BREAKER_ENV_VAR, raising=False)
    result_on, delta_on = _brownout_run(tmp_path, "on", base=42_000)
    np.testing.assert_array_equal(result_on, an * 2.0)
    draw_off, draw_on = delta_off.get("task_retries", 0), delta_on.get("task_retries", 0)
    assert draw_off > 0, delta_off
    assert draw_on < draw_off, (draw_on, draw_off)
    assert delta_on.get("store_throttled", 0) > 0
