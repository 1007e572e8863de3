"""Service-level deadlines and cancellation: submit(deadline_s=) enforces
an end-to-end SLO, RequestHandle.cancel() reaches running computes, and
close() stays bounded against wedged requests; one deadline story's states
and typed errors held against the JAX package's. Counterpart of
tests/service/test_deadline.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import time

import numpy as np
import pytest

import cubed_tpu_torch as ct
import cubed_tpu_torch.array_api as xp
from cubed_tpu_torch.runtime.cancellation import (
    ComputeCancelledError,
    ComputeDeadlineExceededError,
)
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor
from cubed_tpu_torch.service import ComputeService
from cubed_tpu_torch.service.service import CANCELLED, FAILED, RequestCancelledError
from ._torch_chaos import clean_process  # noqa: E402,F401

pytestmark = pytest.mark.chaos


def _slow_array(tmp_path, delay_s=0.3, seed=5, shape=(16, 16), chunks=(4, 4)):
    spec = ct.Spec(
        work_dir=str(tmp_path), allowed_mem="500MB",
        fault_injection=dict(
            seed=seed, straggler_rate=1.0, straggler_delay_s=delay_s
        ),
    )
    return xp.ones(shape, chunks=chunks, spec=spec) + 1


def _service(**kwargs):
    return ComputeService(
        executor=AsyncPythonDagExecutor(max_workers=2), **kwargs
    ).start()


def test_submit_deadline_fails_running_request_with_typed_error(tmp_path):
    svc = _service()
    try:
        h = svc.submit(_slow_array(tmp_path), tenant="slo", deadline_s=0.6)
        with pytest.raises(ComputeDeadlineExceededError):
            h.result(timeout=30)
        assert h.status() == FAILED
    finally:
        svc.close(timeout=10)


def test_submit_deadline_expired_while_queued_fails_at_admission(tmp_path):
    # a deadline that passes before the request ever runs: the request
    # fails with the typed error without consuming fleet time. One slot,
    # so the blocker pins admission while the deadline expires; distinct
    # shapes so the two queries can never coalesce
    svc = _service(max_concurrent=1)
    try:
        blocker = svc.submit(_slow_array(tmp_path), tenant="a")
        h = svc.submit(
            _slow_array(tmp_path / "b", seed=6, shape=(8, 8)), tenant="a",
            deadline_s=0.05,
        )
        with pytest.raises(ComputeDeadlineExceededError):
            h.result(timeout=60)
        assert h.status() == FAILED
        blocker.result(timeout=60)
    finally:
        svc.close(timeout=10)


def test_cancel_running_request_completes_cancelled(tmp_path):
    svc = _service()
    try:
        h = svc.submit(_slow_array(tmp_path), tenant="gold")
        # wait until it is genuinely RUNNING
        deadline = time.monotonic() + 10
        while h.status() != "running" and time.monotonic() < deadline:
            time.sleep(0.02)
        assert h.status() == "running"
        t0 = time.monotonic()
        assert h.cancel()
        with pytest.raises(RequestCancelledError):
            h.result(timeout=15)
        assert h.status() == CANCELLED
        assert time.monotonic() - t0 < 5.0
        snap = svc.stats_snapshot()
        assert snap["tenants"]["gold"]["cancelled"] == 1
    finally:
        svc.close(timeout=10)


def test_cancel_running_durable_request_is_sealed(tmp_path):
    from cubed_tpu_torch.service.durability import load_requests

    sdir = str(tmp_path / "svc")
    svc = _service(service_dir=sdir)
    try:
        h = svc.submit(_slow_array(tmp_path / "w"), tenant="t")
        deadline = time.monotonic() + 10
        while h.status() != "running" and time.monotonic() < deadline:
            time.sleep(0.02)
        assert h.cancel()
        with pytest.raises(RequestCancelledError):
            h.result(timeout=15)
    finally:
        svc.close(timeout=10)
    # the cancel was sealed durably: a restarted service on the same dir
    # has nothing to recover for this tenant
    pending = load_requests(sdir)
    assert not any(pending.values()), pending


def test_close_is_bounded_by_cancellation(tmp_path):
    # a compute that would run ~13s on 2 threads: close(timeout=1) must
    # not wait it out — the token cancels it and close returns promptly
    svc = _service()
    h = svc.submit(
        _slow_array(tmp_path, delay_s=0.8, shape=(16, 16), chunks=(2, 2)),
        tenant="wedge",
    )
    deadline = time.monotonic() + 10
    while h.status() != "running" and time.monotonic() < deadline:
        time.sleep(0.02)
    t0 = time.monotonic()
    svc.close(timeout=1.0)
    elapsed = time.monotonic() - t0
    assert elapsed < 10.0, f"close took {elapsed:.1f}s"
    assert h.done()
    assert h.status() in (CANCELLED, FAILED)


def test_deadline_survives_service_recovery(tmp_path):
    # the SLO is part of the durable contract: a request recovered after
    # an outage keeps its ABSOLUTE deadline, and one whose deadline
    # passed during the outage fails typed at admission
    sdir = str(tmp_path / "svc")
    svc1 = _service(service_dir=sdir, max_concurrent=1)
    blocker = svc1.submit(_slow_array(tmp_path / "w1"), tenant="t")
    h = svc1.submit(
        _slow_array(tmp_path / "w2", seed=7, shape=(8, 8)), tenant="t",
        deadline_s=0.5,
    )
    rid = h.request_id
    # close while h is still queued: its accepted record stays unsealed
    svc1.close(timeout=0.2)
    time.sleep(0.6)  # the deadline passes "during the outage"
    svc2 = _service(service_dir=sdir)
    try:
        h2 = svc2.handle(rid)
        assert h2 is not None, "recovery did not re-enqueue the request"
        with pytest.raises(ComputeDeadlineExceededError):
            h2.result(timeout=30)
        assert h2.status() == FAILED
    finally:
        svc2.close(timeout=10)


def test_coalesced_follower_cancel_leaves_leader_running(tmp_path):
    # follower cancel must not tear down the leader's execution
    svc = _service(max_concurrent=2)
    try:
        arr = _slow_array(tmp_path, delay_s=0.25)
        leader = svc.submit(arr, tenant="a")
        # leadership is first-to-execute: wait until the leader runs
        # before submitting the coalescing follower
        deadline = time.monotonic() + 10
        while leader.status() != "running" and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.3)
        follower = svc.submit(arr, tenant="b")
        deadline = time.monotonic() + 10
        while follower.status() != "running" and (
            time.monotonic() < deadline
        ):
            time.sleep(0.02)
        follower.cancel()
        with pytest.raises(
            (RequestCancelledError, ComputeCancelledError)
        ):
            follower.result(timeout=15)
        value = leader.result(timeout=60)
        np.testing.assert_array_equal(value, np.full((16, 16), 2.0))
    finally:
        svc.close(timeout=10)


@pytest.fixture(scope="module", autouse=True)
def _clean_process(clean_process):
    yield


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------


def _deadline_story(pkg, ns, service_mod, executor, work):
    """A running request past its deadline, a queued one whose deadline
    passes in the queue, and a cancelled one, in *pkg*: each outcome's
    state, error type and the tenant's row."""
    def slow(name, seed, shape=(16, 16)):
        spec = pkg.Spec(work_dir=os.path.join(work, name), allowed_mem="500MB",
                        fault_injection=dict(seed=seed, straggler_rate=1.0, straggler_delay_s=0.3))
        return ns.ones(shape, chunks=(4, 4), spec=spec) + 1

    svc = service_mod.ComputeService(executor=executor, max_concurrent=1).start()
    try:
        late = svc.submit(slow("a", 5), tenant="slo", deadline_s=0.6)
        queued = svc.submit(slow("b", 6, (8, 8)), tenant="slo", deadline_s=0.05)
        cancelled = svc.submit(slow("c", 7, (12, 12)), tenant="slo")
        cancelled.cancel()
        out = []
        for h in (late, queued, cancelled):
            try:
                h.result(timeout=60)
                err = None
            except Exception as e:  # noqa: BLE001 — the outcome is compared
                err = type(e).__name__
            out.append((h.status(), err))
        row = svc.stats_snapshot()["tenants"]["slo"]
        return out, {k: row[k] for k in ("accepted", "completed", "failed", "cancelled")}
    finally:
        svc.close(timeout=10)


def test_deadline_outcomes_match_the_jax_package(tmp_path):
    """The same deadline and cancel story ends in the JAX package's states,
    typed errors and tenant counts."""
    import cubed_tpu
    import cubed_tpu.array_api as rxp
    import cubed_tpu.service as ref_service
    from cubed_tpu.runtime.executors.python_async import AsyncPythonDagExecutor as RefAsync

    import cubed_tpu_torch.service as service

    ours = _deadline_story(ct, xp, service, AsyncPythonDagExecutor(max_workers=2), str(tmp_path / "port"))
    theirs = _deadline_story(cubed_tpu, rxp, ref_service, RefAsync(max_workers=2), str(tmp_path / "ref"))
    assert ours == theirs
    assert ours[0] == [("failed", "ComputeDeadlineExceededError")] * 2 + [("cancelled", "RequestCancelledError")]
