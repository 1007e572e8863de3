"""Arming scopes of concurrent computes (``cubed_tpu_torch/runtime/arming.py``).

Two computes on two threads (a service's requests) arm the memory guard, the
fault injector, the integrity mode and the peer-transfer client config for
their durations, and exit in any order. While one scope is live its config
is armed; once both have exited nothing is, the environment variables that
carry a config to child processes included. The JAX package saves and
restores the armed value per scope (process-global by its service's own
documentation), which leaves a finished compute's config armed after
out-of-order exits; the port keeps a stack of live scopes per kind.
"""

from __future__ import annotations

import os
import threading

import pytest

from cubed_tpu_torch.runtime import faults, memory, transfer
from cubed_tpu_torch.storage import integrity


def _memory(tag: int):
    return memory.scoped(mode="observe", allowed_mem=1_000_000 * tag, export_env=True)


def _memory_armed():
    cfg = memory.get_guard_config()
    return None if cfg is None else cfg.allowed_mem // 1_000_000


def _faults(tag: int):
    return faults.scoped(faults.FaultConfig(seed=tag, task_failure_rate=0.0), export_env=True)


def _faults_armed():
    inj = faults.get_injector()
    return None if inj is None else inj.config.seed


_MODES = {1: "write", 2: "verify"}


def _integrity(tag: int):
    return integrity.scoped(_MODES[tag], export_env=True)


def _integrity_armed():
    mode = os.environ.get(integrity.INTEGRITY_ENV_VAR) or integrity._active_mode
    return None if mode is None else {v: k for k, v in _MODES.items()}[mode]


def _transfer(tag: int):
    return transfer.client_scoped(True, transfer.PeerConfig(enabled=True, locate_timeout_s=float(tag)))


def _transfer_armed():
    cfg = transfer._client_config
    return None if cfg is None else int(cfg.locate_timeout_s)


KINDS = {
    "memory_guard": (_memory, _memory_armed, memory.MEMORY_GUARD_ENV_VAR),
    "fault_injector": (_faults, _faults_armed, faults.FAULTS_ENV_VAR),
    "integrity": (_integrity, _integrity_armed, integrity.INTEGRITY_ENV_VAR),
    "peer_transfer": (_transfer, _transfer_armed, None),
}


@pytest.fixture(autouse=True)
def _disarmed():
    def disarm():
        memory.deactivate()
        faults.deactivate()
        integrity.activate(None, export_env=True)
        transfer._client_config = None

    disarm()
    yield
    disarm()


class _Compute(threading.Thread):
    """A thread that enters a scope, reports, and exits when told to."""

    def __init__(self, scope):
        super().__init__(daemon=True)
        self.scope = scope
        self.entered = threading.Event()
        self.leave = threading.Event()
        self.left = threading.Event()
        self.error = None

    def run(self):
        try:
            with self.scope:
                self.entered.set()
                assert self.leave.wait(30)
        except BaseException as e:  # noqa: BLE001 - reported to the test
            self.error = e
        finally:
            self.entered.set()
            self.left.set()


def _leave(t: _Compute) -> None:
    t.leave.set()
    assert t.left.wait(30)
    t.join(30)
    assert not t.is_alive() and t.error is None, t.error


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("first_out", ["a", "b"])
def test_out_of_order_exits_leave_nothing_armed(kind, first_out):
    make, armed, env_var = KINDS[kind]
    assert armed() is None
    a, b = _Compute(make(1)), _Compute(make(2))
    a.start()
    assert a.entered.wait(30)
    assert armed() == 1
    b.start()
    assert b.entered.wait(30)
    assert armed() == 2  # the newest live scope
    if first_out == "a":
        _leave(a)
        assert armed() == 2  # b is live and stays armed
        _leave(b)
    else:
        _leave(b)
        assert armed() == 1  # a is live: its config is armed again
        _leave(a)
    assert armed() is None
    if env_var is not None:
        assert env_var not in os.environ


@pytest.mark.parametrize("kind", ["memory_guard", "integrity"])
def test_operator_env_var_passes_through_concurrent_scopes(kind, monkeypatch):
    make, _, env_var = KINDS[kind]
    operator = memory.MemoryGuardConfig(mode="observe", allowed_mem=9_000_000).to_env_json() \
        if kind == "memory_guard" else "off"
    monkeypatch.setenv(env_var, operator)
    a, b = _Compute(make(1)), _Compute(make(2))
    a.start()
    assert a.entered.wait(30)
    b.start()
    assert b.entered.wait(30)
    assert os.environ[env_var] == operator
    _leave(a)
    _leave(b)
    assert os.environ[env_var] == operator


def test_a_scope_restores_what_was_armed_before_it():
    memory.activate(memory.MemoryGuardConfig(mode="observe", allowed_mem=7_000_000))
    with _memory(1):
        assert _memory_armed() == 1
    assert _memory_armed() == 7
