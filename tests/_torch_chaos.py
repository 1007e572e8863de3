"""Shared pieces of the port's service, failover and audit tests.

``invariant_audit`` is the port's counterpart of the fixture of the same
name in ``tests/conftest.py``: the port's auditor over whatever durable
artifacts a test's compute left (journal, control log, work dir, metrics
delta), asserting the report clean. A test module imports it by name.
``pinned_names`` pins both packages' plan-name counters around a seeded
run, so the injector hashes the same task keys in any file order.
``clean_process`` resets what a service or fleet test may leave armed in
this process (the injector, the peer config, the guard's sampler, the
overload level) and checks that no child process or listening socket is
left at the end of the module.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import pytest

from . import _torch_fleet


@pytest.fixture
def invariant_audit():
    from cubed_tpu_torch.runtime.audit import InvariantAuditor

    def _audit(journal=None, control_dir=None, work_dir=None, metrics=None, expect_success=True):
        report = InvariantAuditor(journal=journal, control_dir=control_dir, work_dir=work_dir, metrics=metrics,
                                  expect_success=expect_success).audit()
        assert report.ok, report.render()
        assert report.checked, "auditor was given nothing to audit"
        return report

    return _audit


@contextlib.contextmanager
def pinned_names(base: int):
    """Both packages' plan-name counters pinned at *base*; afterwards each
    resumes past what either used."""
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


def reset_process_state() -> None:
    """:func:`_torch_fleet.reset_process_state`, no overload level left
    published in either package, and the JAX package's guard, injector and
    integrity mode disarmed: its arming scopes save and restore the armed
    value, so its concurrent computes (a service's requests) that exit out
    of order can leave one armed (the port's keep a stack of live scopes,
    ``cubed_tpu_torch/runtime/arming.py``)."""
    import cubed_tpu.runtime.faults as ref_faults
    import cubed_tpu.runtime.memory as ref_memory
    import cubed_tpu.service.overload as ref_overload
    import cubed_tpu.storage.integrity as ref_integrity
    from cubed_tpu_torch.service import overload

    _torch_fleet.reset_process_state()
    ref_memory.deactivate()
    ref_integrity.activate(None)
    ref_faults.deactivate()
    for ladder in (overload, ref_overload):
        with ladder._live_lock:
            ladder._live_levels.clear()


def join_service_threads(timeout: float = 60.0) -> list:
    """Wait for every compute service thread of this process to end (a
    request a closed service cancelled may still be unwinding, and its
    arming scopes restore what they saved when it does); the threads still
    alive after *timeout*."""
    deadline = time.monotonic() + timeout
    for t in threading.enumerate():
        if t.name.startswith(("service-run-", "service-dispatch")):
            t.join(max(0.0, deadline - time.monotonic()))
    return [t.name for t in threading.enumerate() if t.name.startswith(("service-run-", "service-dispatch"))]


@pytest.fixture(scope="module")
def clean_process():
    before = _torch_fleet.snapshot()
    reset_process_state()
    yield
    lingering = join_service_threads()
    reset_process_state()
    assert lingering == []
    assert _torch_fleet.leftovers(before) == {"children": [], "listening": []}
