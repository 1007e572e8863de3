"""Autoscaler policy-loop units, driven by ``Autoscaler.tick`` against a
fake coordinator and factory, so every decision (backfill, hysteresis,
cooldowns, straggler pressure, the memory-pressure veto, graceful
scale-down) is asserted without subprocesses or timing races; one scripted
story's decisions held against the JAX package's autoscaler tick for tick.
Real fleets with the autoscaler run in test_torch_distributed.py and
test_torch_isolation.py. Counterpart of tests/runtime/test_autoscale.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import pytest

from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime.autoscale import (
    Autoscaler,
    AutoscalePolicy,
    WorkerFactory,
)
from ._torch_chaos import clean_process  # noqa: E402,F401


class FakeCoordinator:
    def __init__(self):
        self.workers: dict = {}  # name -> row
        self.drained: list = []

    def add(self, name, outstanding=0, nthreads=1, pressured=False,
            draining=False):
        self.workers[name] = dict(
            name=name, outstanding=outstanding, nthreads=nthreads,
            pressured=pressured, draining=draining,
        )

    def load_view(self):
        return [dict(row) for row in self.workers.values()]

    def request_drain(self, name, grace_s=30.0, reason="scale_down"):
        if name not in self.workers:
            return False
        self.workers[name]["draining"] = True
        self.drained.append((name, reason))
        return True


class FakeFactory(WorkerFactory):
    def __init__(self, coordinator):
        self.coordinator = coordinator
        self.started: list = []
        self.stopped: list = []
        self._next = 0

    def start_worker(self):
        name = f"w-{self._next}"
        self._next += 1
        self.started.append(name)
        return name

    def stop_worker(self, name):
        self.stopped.append(name)
        self.coordinator.workers.pop(name, None)


def mk(policy=None, initial=2, pending=None, coordinator=None):
    coord = coordinator or FakeCoordinator()
    factory = FakeFactory(coord)
    scaler = Autoscaler(
        coord, factory=factory,
        policy=policy or AutoscalePolicy(min_workers=1, max_workers=4),
        initial_workers=initial, pending_workers=pending,
    )
    return coord, factory, scaler


def test_backfill_replaces_lost_workers_immediately():
    coord, factory, scaler = mk(initial=3)
    coord.add("a"), coord.add("b"), coord.add("c")
    scaler.tick()
    assert factory.started == []  # fleet healthy: nothing to do
    del coord.workers["b"]  # preempted/crashed
    scaler.tick()
    assert len(factory.started) == 1  # replaced without any cooldown
    assert scaler.stats["workers_scaled_up"] == 1
    # the spawn is pending: no double-backfill while it boots
    scaler.tick()
    assert len(factory.started) == 1


def test_pending_spawn_that_registers_then_dies_is_backfilled():
    """A replacement that joins and is immediately preempted must read as
    a hole again, not as still-pending capacity (the bug class: pending
    entries only cleared against *currently*-live names)."""
    coord, factory, scaler = mk(initial=2)
    coord.add("a")
    scaler.tick()  # backfills one
    name = factory.started[0]
    coord.add(name)
    scaler.tick()  # registered: pending settled
    del coord.workers[name]  # ...and instantly preempted
    scaler.tick()
    assert len(factory.started) == 2


def test_pending_spawn_that_dies_before_registering_is_backfilled():
    """A spawn preempted mid-boot never registers, so the ever-joined set
    can't settle it; the factory's spawn_failed probe must reopen the slot
    immediately instead of stalling for spawn_pending_timeout_s."""
    coord, factory, scaler = mk(initial=2, pending=["a", "b"])
    dead = set()
    factory.spawn_failed = lambda name: name in dead
    coord.add("a")
    scaler.tick()
    assert factory.started == []  # "b" still booting: not damage yet
    dead.add("b")  # SIGTERMed before it ever joined
    scaler.tick()
    assert len(factory.started) == 1  # slot reopened and backfilled now
    assert scaler.stats["workers_scaled_up"] == 1


def test_initial_pending_workers_suppress_startup_backfill():
    coord, factory, scaler = mk(initial=2, pending=["a", "b"])
    scaler.tick()  # nothing registered yet: still booting, not damage
    assert factory.started == []
    coord.add("a"), coord.add("b")
    scaler.tick()
    assert factory.started == []


def test_scale_up_on_queue_depth_with_cooldown():
    policy = AutoscalePolicy(
        min_workers=1, max_workers=4, scale_up_queue_per_thread=4.0,
        cooldown_up_s=3600.0,
    )
    coord, factory, scaler = mk(policy=policy, initial=2)
    coord.add("a", outstanding=10), coord.add("b", outstanding=10)
    scaler.tick()
    assert len(factory.started) == 1 and scaler.desired == 3
    coord.add(factory.started[0], outstanding=0)
    scaler.tick()  # still loaded, but inside the up-cooldown
    assert len(factory.started) == 1
    scaler._last_up = -1e9  # cooldown elapsed
    scaler.tick()
    assert len(factory.started) == 2 and scaler.desired == 4
    # max_workers is a hard ceiling
    coord.add(factory.started[1], outstanding=0)
    scaler._last_up = -1e9
    scaler.tick()
    assert scaler.desired == 4 and len(factory.started) == 2


def test_scale_up_vetoed_under_memory_pressure():
    policy = AutoscalePolicy(min_workers=1, max_workers=4)
    coord, factory, scaler = mk(policy=policy, initial=2)
    coord.add("a", outstanding=20, pressured=True)
    coord.add("b", outstanding=20, pressured=True)
    scaler.tick()
    assert factory.started == []  # more workers would deepen the pressure
    assert scaler.desired == 2


def test_straggler_pressure_triggers_scale_up():
    policy = AutoscalePolicy(
        min_workers=1, max_workers=4, straggler_pressure=2
    )
    coord, factory, scaler = mk(policy=policy, initial=2)
    coord.add("a", outstanding=1), coord.add("b", outstanding=1)
    scaler.tick()
    assert factory.started == []  # shallow queue, no stragglers
    get_registry().counter("stragglers_detected").inc(2)
    scaler.tick()
    assert len(factory.started) == 1  # backups need somewhere to run


def test_idle_fleet_ignores_foreign_straggler_detections():
    """stragglers_detected is process-global: detections from some OTHER
    compute running in the same client process must not scale an idle
    fleet (a straggler on this fleet implies in-flight work here)."""
    policy = AutoscalePolicy(
        min_workers=1, max_workers=4, straggler_pressure=2
    )
    coord, factory, scaler = mk(policy=policy, initial=2)
    coord.add("a", outstanding=0), coord.add("b", outstanding=0)
    scaler.tick()
    get_registry().counter("stragglers_detected").inc(5)  # someone else's
    scaler.tick()
    assert factory.started == []  # no work here: not our stragglers


def test_scale_down_needs_sustained_idleness_then_drains_gracefully():
    policy = AutoscalePolicy(
        min_workers=1, max_workers=4, idle_rounds_before_down=3,
        cooldown_down_s=0.0, drain_grace_s=7.5,
    )
    coord, factory, scaler = mk(policy=policy, initial=3)
    coord.add("a", outstanding=0)
    coord.add("b", outstanding=1)
    coord.add("c", outstanding=0)
    scaler.tick(), scaler.tick()
    assert coord.drained == []  # hysteresis: 2 idle rounds are not enough
    scaler.tick()
    assert len(coord.drained) == 1
    name, reason = coord.drained[0]
    assert name in ("a", "c") and reason == "scale_down"  # least-loaded
    assert scaler.desired == 2
    assert factory.stopped == [name]  # reap follows the drain request
    assert scaler.stats["workers_scaled_down"] == 1


def test_overcapacity_above_desired_is_reconciled_down():
    """A fleet whose LIVE count exceeds the steering target (out-of-band
    joiners, or workers started above the ceiling) must be drained toward
    ``desired`` once idle — previously scale-down was gated purely on
    ``desired > min_workers``, so desired at min left overcapacity
    running forever."""
    policy = AutoscalePolicy(
        min_workers=1, max_workers=4, idle_rounds_before_down=1,
        cooldown_down_s=0.0,
    )
    coord = FakeCoordinator()
    scaler = Autoscaler(coord, factory=None, policy=policy, initial_workers=1)
    assert scaler.desired == 1
    for n in ("a", "b", "c"):  # three out-of-band workers join
        coord.add(n)
    scaler.tick()  # idle round
    scaler.tick()
    assert len(coord.drained) >= 1  # overcapacity shrinks toward desired
    assert scaler.desired == 1  # ...without pushing desired below target


def test_policy_rejects_min_above_max():
    with pytest.raises(ValueError, match="min_workers=5 exceeds"):
        AutoscalePolicy(min_workers=5, max_workers=2)


def test_executor_rejects_unsatisfiable_max_workers():
    from cubed_tpu_torch.runtime.executors.distributed import (
        DistributedDagExecutor,
    )

    with pytest.raises(ValueError, match="max_workers=2 is below"):
        DistributedDagExecutor(n_local_workers=4, max_workers=2)


def test_scale_down_never_goes_below_min_workers():
    policy = AutoscalePolicy(
        min_workers=2, max_workers=4, idle_rounds_before_down=1,
        cooldown_down_s=0.0,
    )
    coord, factory, scaler = mk(policy=policy, initial=2)
    coord.add("a"), coord.add("b")
    for _ in range(5):
        scaler.tick()
    assert coord.drained == [] and scaler.desired == 2


def test_factory_none_skips_spawns_but_still_drains():
    """Listen-mode fleets (out-of-band workers) have no factory: the
    autoscaler cannot spawn, but graceful scale-down still works."""
    policy = AutoscalePolicy(
        min_workers=1, max_workers=4, idle_rounds_before_down=1,
        cooldown_down_s=0.0,
    )
    coord = FakeCoordinator()
    scaler = Autoscaler(coord, factory=None, policy=policy, initial_workers=3)
    coord.add("a"), coord.add("b"), coord.add("c")
    del coord.workers["b"]
    scaler.tick()  # a hole, but nothing to spawn with: no crash
    assert scaler.stats["workers_scaled_up"] == 0
    scaler.tick()
    assert len(coord.drained) == 1  # idle fleet still shrinks


def test_start_stop_runs_policy_loop():
    import time

    policy = AutoscalePolicy(min_workers=1, max_workers=2, interval_s=0.02)
    coord, factory, scaler = mk(policy=policy, initial=1)
    coord.add("a")
    scaler.start()
    try:
        deadline = time.monotonic() + 5
        while (
            scaler.stats["autoscaler_ticks"] < 3
            and time.monotonic() < deadline
        ):
            time.sleep(0.01)
        assert scaler.stats["autoscaler_ticks"] >= 3
    finally:
        scaler.stop()
    ticks = scaler.stats["autoscaler_ticks"]
    time.sleep(0.1)
    assert scaler.stats["autoscaler_ticks"] == ticks  # loop actually stopped


def test_scale_up_with_live_surplus_spawns_only_the_shortfall():
    """Out-of-band joiners above the old desired already serve the new
    target: a scale-up step must spawn ``desired - n_active``, not the
    full step (previously a 5th worker was spawned when 4 live workers
    already covered desired=4, only for the overcapacity reconciler to
    drain it again)."""
    policy = AutoscalePolicy(
        min_workers=1, max_workers=8, scale_up_queue_per_thread=4.0,
    )
    coord, factory, scaler = mk(policy=policy, initial=3)
    for n in ("a", "b", "c", "d"):  # one more live than desired=3
        coord.add(n, outstanding=10)
    scaler.tick()
    assert scaler.desired == 4  # demand raised the steering target...
    assert factory.started == []  # ...but live surplus already covers it


def test_start_arms_backfill_grace_only_with_a_factory():
    """Without a factory (listen-mode, out-of-band workers) nothing can be
    backfilled: arming the coordinator's backfill grace would only convert
    a fast, actionable NoWorkersError into a pointless multi-second stall
    per submit attempt."""
    policy = AutoscalePolicy(min_workers=1, max_workers=4, interval_s=60.0)

    coord = FakeCoordinator()
    coord.backfill_grace_s = 0.0
    scaler = Autoscaler(coord, factory=None, policy=policy)
    scaler.start()
    try:
        assert coord.backfill_grace_s == 0.0  # no factory: left unarmed
    finally:
        scaler.stop()

    coord2 = FakeCoordinator()
    coord2.backfill_grace_s = 0.0
    coord2.add("a")
    _, factory, scaler2 = mk(policy=policy, initial=1, coordinator=coord2)
    scaler2.start()
    try:
        assert coord2.backfill_grace_s == policy.spawn_pending_timeout_s
    finally:
        scaler2.stop()
    assert coord2.backfill_grace_s == 0.0  # stop() disarms


def test_malformed_drain_grace_env_falls_back(monkeypatch):
    """A malformed CUBED_TPU_TORCH_DRAIN_GRACE_S must not crash every worker at
    argparse construction (the fleet would fail to boot with only a
    wait_for_workers timeout as the diagnostic)."""
    from cubed_tpu_torch.runtime.worker import _env_seconds

    def _default_drain_grace():
        return _env_seconds("CUBED_TPU_TORCH_DRAIN_GRACE_S", 10.0)

    monkeypatch.setenv("CUBED_TPU_TORCH_DRAIN_GRACE_S", "30s")
    assert _default_drain_grace() == 10.0
    monkeypatch.setenv("CUBED_TPU_TORCH_DRAIN_GRACE_S", "2.5")
    assert _default_drain_grace() == 2.5
    monkeypatch.delenv("CUBED_TPU_TORCH_DRAIN_GRACE_S")
    assert _default_drain_grace() == 10.0


def test_worker_factory_abstract_contract():
    f = WorkerFactory()
    with pytest.raises(NotImplementedError):
        f.start_worker()
    with pytest.raises(NotImplementedError):
        f.stop_worker("x")


@pytest.fixture(scope="module", autouse=True)
def _clean_process(clean_process):
    yield


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------


def _autoscale_story(autoscaler_cls, policy_cls):
    """One scripted fleet story (a loss, a registration, a burst of load, a
    pressured fleet, idleness) ticked through *autoscaler_cls*: the
    spawns, drains, reaps and stats after every tick."""
    coord = FakeCoordinator()
    factory = FakeFactory(coord)
    policy = policy_cls(min_workers=1, max_workers=4, cooldown_up_s=0.0, cooldown_down_s=0.0,
                        idle_rounds_before_down=2, scale_up_queue_per_thread=2.0)
    scaler = autoscaler_cls(coord, factory=factory, policy=policy, initial_workers=2, pending_workers=["a", "b"])

    def load(n):
        for row in coord.workers.values():
            row["outstanding"] = n

    script = [
        lambda: (coord.add("a"), coord.add("b")),
        lambda: coord.workers.pop("b"),
        lambda: coord.add(factory.started[-1]),
        lambda: load(5),
        lambda: [coord.add(n, outstanding=5) for n in factory.started if n not in coord.workers],
        lambda: [row.update(pressured=True) for row in coord.workers.values()],
        lambda: load(9),
        lambda: ([coord.add(n) for n in factory.started if n not in coord.workers], load(0)),
        lambda: None, lambda: None, lambda: None, lambda: None, lambda: None,
    ]
    story = []
    for step in script:
        step()
        scaler.tick()
        story.append((list(factory.started), list(factory.stopped), list(coord.drained), scaler.desired,
                      {k: v for k, v in scaler.stats.items() if k != "autoscaler_ticks"}))
    return story


def test_scale_decisions_match_the_jax_package():
    """The same scripted story drives the port's autoscaler to the JAX
    package's backfills, scale-ups, vetoes, drains and reaps, tick for
    tick."""
    from cubed_tpu.runtime.autoscale import Autoscaler as RefAutoscaler
    from cubed_tpu.runtime.autoscale import AutoscalePolicy as RefPolicy

    ours = _autoscale_story(Autoscaler, AutoscalePolicy)
    assert ours == _autoscale_story(RefAutoscaler, RefPolicy)
    assert ours[-1][1] and ours[-1][4]["workers_scaled_up"] >= 2  # the story spawned and retired workers
