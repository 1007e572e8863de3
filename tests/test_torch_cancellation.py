"""Deadlines and cooperative cancellation in the port, held against the JAX
package's: the token, its errors and classification, the per-compute
registry, deadline aborts and explicit cancels on the sequential and the
threaded executors with resume after them (counterpart of the sequential and
threaded cases of tests/runtime/test_cancellation.py), and the device
executor's aborts at op and segment boundaries, whose path counters equal
``JaxExecutor``'s."""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import pytest

import cubed_tpu as ct_ref
import cubed_tpu.array_api as ref_xp
import cubed_tpu_torch as ct
import cubed_tpu_torch.array_api as xp
from cubed_tpu.runtime import cancellation as ref_cancel
from cubed_tpu.runtime.executors import jax as jax_executor_module
from cubed_tpu.runtime.executors.jax import JaxExecutor
from cubed_tpu_torch.backend_array_api import set_device
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime import cancellation as cancel_mod
from cubed_tpu_torch.runtime.cancellation import (
    CancellationToken,
    ComputeCancelledError,
    ComputeDeadlineExceededError,
)
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor
from cubed_tpu_torch.runtime.resilience import Classification, RetryPolicy
from cubed_tpu_torch.runtime.types import Callback

pytestmark = pytest.mark.chaos

#: every task sleeps this long: enough to cancel mid-compute, short enough
#: to keep the suite's waits in tens of milliseconds
SLOW = dict(seed=5, straggler_rate=1.0, straggler_delay_s=0.02)


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    yield


def _slow_spec(tmp_path, **overrides):
    return ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", fault_injection=dict(SLOW, **overrides))


# -- token units ---------------------------------------------------------


def test_token_deadline_expiry_and_remaining():
    tok = CancellationToken(deadline_s=0.03)
    assert not tok.cancelled
    assert 0 < tok.remaining() <= 0.03
    time.sleep(0.04)
    assert tok.expired and tok.cancelled
    with pytest.raises(ComputeDeadlineExceededError):
        tok.check()


def test_token_tightens_never_loosens_deadline():
    tok = CancellationToken(deadline_s=100.0)
    tok.set_deadline(0.05)
    assert tok.remaining() <= 0.05
    tok.set_deadline(500.0)
    assert tok.remaining() <= 0.06


def test_token_explicit_cancel_fires_callbacks_once():
    tok = CancellationToken()
    fired = []
    tok.on_abort(lambda: fired.append(1))
    tok.cancel("test")
    tok.cancel("again")
    tok.notify_abort()
    assert fired == [1]
    with pytest.raises(ComputeCancelledError) as ei:
        tok.check()
    assert not isinstance(ei.value, ComputeDeadlineExceededError)
    tok.on_abort(lambda: fired.append(2))
    assert fired == [1, 2]


def test_explicit_cancel_wins_over_later_expiry():
    for cls in (CancellationToken, ref_cancel.CancellationToken):
        tok = cls(deadline_s=0.02)
        tok.cancel("operator asked")
        time.sleep(0.03)
        err = tok.error()
        assert type(err).__name__ == "ComputeCancelledError"


def test_check_current_ignores_env_compute_id(monkeypatch):
    from cubed_tpu_torch.observability import logs as obs_logs

    tok = CancellationToken()
    cancel_mod.register_compute("c-env-leak", tok)
    try:
        tok.cancel("other tenant's cancel")
        monkeypatch.setenv(obs_logs.COMPUTE_ID_ENV_VAR, "c-env-leak")
        assert obs_logs.compute_id_var.get() is None
        cancel_mod.check_current()  # must not raise
        token_ctx = obs_logs.compute_id_var.set("c-env-leak")
        try:
            with pytest.raises(ComputeCancelledError):
                cancel_mod.check_current()
        finally:
            obs_logs.compute_id_var.reset(token_ctx)
    finally:
        cancel_mod.unregister_compute("c-env-leak")
    assert not cancel_mod._any_tokens


def test_errors_picklable_and_typed():
    for cls in (ComputeCancelledError, ComputeDeadlineExceededError):
        e = pickle.loads(pickle.dumps(cls("m", compute_id="c9", reason="r")))
        assert isinstance(e, cls) and e.compute_id == "c9" and e.reason == "r"
    assert issubclass(ComputeDeadlineExceededError, ComputeCancelledError)
    assert [c.__name__ for c in ComputeDeadlineExceededError.__mro__[:3]] == \
        [c.__name__ for c in ref_cancel.ComputeDeadlineExceededError.__mro__[:3]]


def test_classification_cancelled_locally_and_across_the_wire():
    # the fleet's wire comes with the fleet; locally both errors are CANCELLED
    policy = RetryPolicy()
    assert policy.classify(ComputeCancelledError("x")) is Classification.CANCELLED
    assert policy.classify(ComputeDeadlineExceededError("x")) is Classification.CANCELLED


def test_abort_counts_and_records_as_the_reference():
    from cubed_tpu.observability.metrics import get_registry as ref_registry

    deltas = []
    for mod, reg in ((cancel_mod, get_registry), (ref_cancel, ref_registry)):
        before = reg().snapshot()
        dead = mod.CancellationToken(deadline_s=0.0)
        assert type(mod.abort(dead)).__name__ == "ComputeDeadlineExceededError"
        tok = mod.CancellationToken()
        tok.cancel("asked")
        assert type(mod.abort(tok)).__name__ == "ComputeCancelledError"
        delta = reg().snapshot_delta(before)
        deltas.append((delta.get("deadline_aborts", 0), delta.get("cancellations", 0)))
    assert deltas[0] == deltas[1] == (1, 1)


# -- the sequential executor ----------------------------------------------


def test_deadline_sequential(tmp_path):
    spec = _slow_spec(tmp_path)
    b = xp.ones((16, 16), chunks=(4, 4), spec=spec) + 1  # 16 tasks of 0.02 s
    before = get_registry().snapshot()
    t0 = time.monotonic()
    with pytest.raises(ComputeDeadlineExceededError):
        b.compute(executor=PythonDagExecutor(), deadline_s=0.1)
    assert time.monotonic() - t0 < 0.1 + 1.0
    assert get_registry().snapshot_delta(before).get("deadline_aborts", 0) >= 1


class _CancelAfter(Callback):
    """Cancels *token* once *n* tasks of an op named *prefix*... have ended."""

    def __init__(self, token, n, prefix="op-"):
        self.token, self.n, self.prefix, self.seen = token, n, prefix, 0

    def on_task_end(self, event):
        if event.array_name.startswith(self.prefix) and event.array_name != "create-arrays":
            self.seen += event.num_tasks
            if self.seen >= self.n:
                self.token.cancel("client asked")


def test_cancel_sequential_zero_retry_draw(tmp_path):
    b = xp.ones((16, 16), chunks=(4, 4), spec=_slow_spec(tmp_path)) * 3
    tok = CancellationToken()
    before = get_registry().snapshot()
    with pytest.raises(ComputeCancelledError) as ei:
        b.compute(executor=PythonDagExecutor(retries=3), cancellation=tok, callbacks=[_CancelAfter(tok, 5)])
    assert not isinstance(ei.value, ComputeDeadlineExceededError)
    delta = get_registry().snapshot_delta(before)
    assert delta.get("cancellations", 0) >= 1
    assert delta.get("task_retries", 0) == 0, delta


def test_cancelled_compute_resumes_bitwise_sequential(tmp_path):
    """Cancel after 7 of 16 tasks, then resume: exactly the other 9 run, and
    the result equals an uninterrupted run's, bit for bit."""
    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    a = ct.from_array(an, chunks=(4, 4), spec=ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB"))
    b = xp.sqrt(a) * 3.0
    tok = CancellationToken()
    with pytest.raises(ComputeCancelledError):
        b.compute(cancellation=tok, callbacks=[_CancelAfter(tok, 7)])
    pending = b.plan.num_tasks(resume=True)
    assert pending == 1 + 9

    class Count(Callback):
        n = 0

        def on_task_end(self, event):
            Count.n += event.num_tasks

    res = b.compute(resume=True, callbacks=[Count()])
    assert Count.n == pending
    ref_spec = ct_ref.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB")
    expected = (ref_xp.sqrt(ct_ref.from_array(an, chunks=(4, 4), spec=ref_spec)) * 3.0).compute()
    np.testing.assert_array_equal(res, expected)
    np.testing.assert_array_equal(res, np.sqrt(an) * 3.0)


# -- the threaded executor -------------------------------------------------


def test_deadline_threaded(tmp_path):
    """16 tasks of 0.15 s on 4 threads (about 0.6 s of work) against a 0.2 s
    deadline: the dispatch loop aborts within a task and a wake-up."""
    b = xp.ones((16, 16), chunks=(4, 4), spec=_slow_spec(tmp_path, straggler_delay_s=0.15)) + 1
    before = get_registry().snapshot()
    t0 = time.monotonic()
    with pytest.raises(ComputeDeadlineExceededError):
        b.compute(executor=AsyncPythonDagExecutor(max_workers=4), deadline_s=0.2)
    assert time.monotonic() - t0 < 0.2 + 1.5
    assert get_registry().snapshot_delta(before).get("deadline_aborts", 0) >= 1


def test_cancel_threaded_zero_retry_draw(tmp_path):
    b = xp.ones((16, 16), chunks=(4, 4), spec=_slow_spec(tmp_path)) * 3
    tok = CancellationToken()
    before = get_registry().snapshot()
    t0 = time.monotonic()
    with pytest.raises(ComputeCancelledError) as ei:
        b.compute(executor=AsyncPythonDagExecutor(max_workers=4, retries=3), cancellation=tok,
                  callbacks=[_CancelAfter(tok, 5)])
    assert not isinstance(ei.value, ComputeDeadlineExceededError)
    assert time.monotonic() - t0 < 3.0
    delta = get_registry().snapshot_delta(before)
    assert delta.get("cancellations", 0) >= 1
    assert delta.get("task_retries", 0) == 0, delta


def test_cancelled_compute_resumes_bitwise_threaded(tmp_path):
    """Cancel a threaded compute after 5 task ends, then resume: only the
    remainder runs, as the plan's introspection says, and the result equals
    the reference's bit for bit."""
    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB",
                   fault_injection=dict(seed=5, straggler_rate=1.0, straggler_delay_s=0.05))
    b = xp.sqrt(ct.from_array(an, chunks=(4, 4), spec=spec)) + 7.0
    tok = CancellationToken()
    with pytest.raises(ComputeCancelledError):
        b.compute(executor=AsyncPythonDagExecutor(max_workers=2), cancellation=tok, callbacks=[_CancelAfter(tok, 5)])
    pending = b.plan.num_tasks(resume=True)
    assert 1 < pending < 1 + 16

    class Count(Callback):
        n = 0

        def on_task_end(self, event):
            Count.n += event.num_tasks

    before = get_registry().snapshot()
    res = b.compute(executor=AsyncPythonDagExecutor(max_workers=2), resume=True, callbacks=[Count()])
    assert Count.n == pending
    assert get_registry().snapshot_delta(before).get("tasks_skipped_resume", 0) == 1 + 16 - pending
    ref_spec = ct_ref.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB")
    np.testing.assert_array_equal(res, (ref_xp.sqrt(ct_ref.from_array(an, chunks=(4, 4), spec=ref_spec)) + 7.0)
                                  .compute())


# -- the device executor, against JaxExecutor ----------------------------


class _CancelAtOpEnd(Callback):
    def __init__(self, token, nth):
        self.token, self.nth, self.ended = token, nth, 0

    def on_operation_end(self, event):
        self.ended += 1
        if self.ended == self.nth:
            self.token.cancel("client asked")


def _vorticity_product(pkg, mod, spec):
    a, b, x, y = [pkg.random.random((20, 18, 16), chunks=8, spec=spec) for _ in range(4)]
    return mod.mean(a[1:] * x[1:] + b[1:] * y[1:])


@pytest.mark.parametrize("nth", [1, 3])
def test_device_executor_cancel_counters_equal_the_jax_executor(tmp_path, nth):
    """A cancel at the end of the nth op aborts at the next op or segment
    boundary on both executors: the same error, the same path counters, and
    nothing of the unfinished compute flushed to the output's store."""
    import random

    counters = {}
    for name, pkg, mod, ex in (("port", ct, xp, CudaExecutor()), ("ref", ct_ref, ref_xp, JaxExecutor())):
        jax_executor_module._STRUCT_CACHE.clear()
        random.seed(3)
        v = _vorticity_product(pkg, mod, pkg.Spec(work_dir=str(tmp_path / name), allowed_mem="500MB"))
        tok = ref_cancel.CancellationToken() if name == "ref" else CancellationToken()
        with pytest.raises(Exception) as ei:
            v.compute(executor=ex, cancellation=tok, callbacks=[_CancelAtOpEnd(tok, nth)])
        assert type(ei.value).__name__ == "ComputeCancelledError"
        counters[name] = dict(ex.stats)
        out = v.zarray_maybe_lazy.store
        assert not os.path.exists(out) or not [f for f in os.listdir(out) if not f.startswith(".")]
    paths = ("whole_array_hits", "whole_concat_hits", "batched_ops", "chunked_ops", "eager_ops", "eager_fallbacks",
             "batched_errors")
    assert {c: counters["port"].get(c, 0) for c in paths} == {c: counters["ref"].get(c, 0) for c in paths}


def test_device_executor_deadline_aborts_at_a_boundary(tmp_path):
    import random

    random.seed(4)
    v = _vorticity_product(ct, xp, ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB"))
    ex = CudaExecutor()
    before = get_registry().snapshot()
    with pytest.raises(ComputeDeadlineExceededError):
        v.compute(executor=ex, deadline_s=0.0)
    assert get_registry().snapshot_delta(before).get("deadline_aborts", 0) == 1
    assert sum(ex.stats.values()) == 0  # aborted before the first op
    # the next compute in the same process, with no deadline, completes
    random.seed(4)
    w = _vorticity_product(ct, xp, ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB"))
    assert np.isfinite(float(w.compute(executor=CudaExecutor())))
