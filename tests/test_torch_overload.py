"""The overload ladder, deadline-feasibility admission and tenant circuit
breakers, from units to a poison-tenant flood on a live fleet and a
SIGKILLed service; the ladder's levels and the breakers' states held
against the JAX package's on one scripted run. Counterpart of
tests/service/test_overload.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import cubed_tpu_torch as ct
from cubed_tpu_torch.observability.collect import decisions_since
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.service import (
    ComputeService,
    CostEstimator,
    DeadlineInfeasibleError,
    OverloadPolicy,
    ServiceOverloadedError,
    TenantBreaker,
)
from cubed_tpu_torch.service.overload import (
    L0_NORMAL,
    L1_SHED_OPTIONAL,
    L2_SHED_LOAD,
    L3_EMERGENCY,
    OverloadController,
    current_overload_level,
    sheds_optional_work,
)
from ._torch_chaos import clean_process, invariant_audit  # noqa: E402,F401


@pytest.fixture()
def spec(tmp_path):
    return ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")


AN = np.arange(16, dtype=np.float64).reshape(4, 4)


def _build(spec, k=1.0, delay=0.0):
    def kernel(x, _k=k, _d=delay):
        if _d:
            time.sleep(_d)
        return x + _k

    a = ct.from_array(AN, chunks=(2, 2), spec=spec)
    return ct.map_blocks(kernel, a, dtype=np.float64)


def _build_bad(spec):
    def boom(x):
        raise ValueError("kernel exploded")

    a = ct.from_array(AN, chunks=(2, 2), spec=spec)
    return ct.map_blocks(boom, a, dtype=np.float64)


# ----------------------------------------------------------------------
# ladder units
# ----------------------------------------------------------------------


def _controller(**policy_kwargs):
    t = [1000.0]
    pol = OverloadPolicy(
        tick_interval_s=0.0, down_dwell_s=1.0, **policy_kwargs
    )
    ctl = OverloadController(pol, clock=lambda: t[0])
    return ctl, t


def test_ladder_steps_up_immediately_and_down_one_level_per_dwell():
    ctl, t = _controller(queue_l1=2, queue_l2=4, queue_l3=8)
    try:
        t0 = time.time()
        assert ctl.tick(0) == L0_NORMAL
        # overload response is immediate: straight to the justified level
        assert ctl.tick(9) == L3_EMERGENCY
        assert ctl.transitions == 1
        # recovery is deliberate: nothing before the dwell...
        assert ctl.tick(0) == L3_EMERGENCY  # arms the exit clock
        t[0] += 0.5
        assert ctl.tick(0) == L3_EMERGENCY
        # ...then exactly one level per dwell window
        t[0] += 0.6
        assert ctl.tick(0) == L2_SHED_LOAD
        assert ctl.tick(0) == L2_SHED_LOAD  # fresh dwell after each step
        t[0] += 1.1
        assert ctl.tick(0) == L1_SHED_OPTIONAL
        ctl.tick(0)
        t[0] += 1.1
        assert ctl.tick(0) == L0_NORMAL
        assert ctl.transitions == 4
        # every transition is a decision-ring record
        levels = [
            d for d in decisions_since(t0) if d["kind"] == "overload_level"
        ]
        assert len(levels) == 4
        assert levels[0]["to_level"] == L3_EMERGENCY
        assert levels[0]["queue_depth"] == 9
    finally:
        ctl.close()


def test_ladder_hysteresis_does_not_flap_around_a_threshold():
    """A queue sawtoothing between the exit and enter thresholds holds
    the level it reached: entering needs >= enter, leaving needs the
    queue below enter * exit_fraction for a whole dwell."""
    ctl, t = _controller(queue_l1=10, queue_l2=100, queue_l3=1000)
    try:
        assert ctl.tick(10) == L1_SHED_OPTIONAL
        for i in range(20):  # oscillate 6..9 — above exit (5), below enter
            t[0] += 0.3
            assert ctl.tick(6 + (i % 4)) == L1_SHED_OPTIONAL
        assert ctl.transitions == 1
    finally:
        ctl.close()


def test_deadline_miss_rate_drives_l2():
    ctl, t = _controller(queue_l2=1000, miss_min_samples=4)
    try:
        # below the sample floor the signal stays silent (cold start)
        for _ in range(3):
            ctl.note_completion(True)
        assert ctl.miss_rate() == 0.0
        assert ctl.tick(0) == L0_NORMAL
        ctl.note_completion(True)
        assert ctl.miss_rate() == 1.0
        t[0] += 0.1
        assert ctl.tick(0) == L2_SHED_LOAD
        # completions age out of the window
        t[0] += ctl.policy.miss_window_s + 1
        assert ctl.miss_rate() == 0.0
    finally:
        ctl.close()


def test_sheds_optional_work_reflects_live_controllers():
    base = current_overload_level()
    ctl, _ = _controller(queue_l1=1)
    try:
        assert ctl.tick(5) >= L1_SHED_OPTIONAL
        assert sheds_optional_work()
        assert current_overload_level() >= L1_SHED_OPTIONAL
    finally:
        ctl.close()
    # closing unpublishes: the module-level view falls back to the rest
    assert current_overload_level() == base


def test_retry_after_hint_is_bounded():
    ctl, _ = _controller()
    try:
        assert ctl.retry_after_s(0) >= ctl.policy.retry_after_min_s
        assert ctl.retry_after_s(10**6) == ctl.policy.retry_after_max_s
        # a known drain rate scales the estimate
        assert ctl.retry_after_s(10, drain_rate_s=2.0) == 20.0
    finally:
        ctl.close()


# ----------------------------------------------------------------------
# breaker + estimator units
# ----------------------------------------------------------------------


def test_breaker_trips_on_consecutive_failures_and_probes_half_open():
    t = [0.0]
    b = TenantBreaker("t", threshold=2, cooldown_s=10.0, clock=lambda: t[0])
    assert b.check() is None
    assert b.on_failure() is False  # 1 strike: below threshold
    b.on_success()  # success resets the streak
    assert b.strikes == 0
    assert b.on_failure() is False
    assert b.on_failure() is True  # tripped
    assert b.state == TenantBreaker.OPEN and b.is_open
    retry = b.check()
    assert retry is not None and 9.0 <= retry <= 10.0
    t[0] = 5.0
    assert 4.0 <= b.check() <= 5.0  # counts down the cooldown
    # cooldown elapsed: half-open admits exactly ONE probe
    t[0] = 10.5
    assert b.check() is None
    assert b.state == TenantBreaker.HALF_OPEN
    assert b.check() is not None  # second caller: probe slot taken
    # a probe that died of something else hands the slot back
    b.abort_probe()
    assert b.check() is None
    # a failed probe re-opens a fresh cooldown
    assert b.on_failure() is True
    assert b.state == TenantBreaker.OPEN
    t[0] = 21.0
    assert b.check() is None  # half-open again
    b.on_success()
    assert b.state == TenantBreaker.CLOSED and b.strikes == 0
    assert not b.is_open


def test_breaker_state_is_durable_and_half_open_reloads_open(tmp_path):
    path = str(tmp_path / "breaker.json")
    t = [0.0]
    b = TenantBreaker("t", threshold=1, cooldown_s=50.0, state_path=path,
                      clock=lambda: t[0])
    assert b.on_failure() is True
    # a fresh process (same path) comes back OPEN with the strike record
    t2 = [10.0]
    b2 = TenantBreaker("t", threshold=1, cooldown_s=50.0, state_path=path,
                       clock=lambda: t2[0])
    assert b2.state == TenantBreaker.OPEN and b2.strikes == 1
    assert b2.check() is not None
    # die while HALF_OPEN: the in-flight probe resolved nothing, so the
    # reload is conservative — OPEN, not half-open
    t2[0] = 60.1
    assert b2.check() is None and b2.state == TenantBreaker.HALF_OPEN
    b3 = TenantBreaker("t", threshold=1, cooldown_s=50.0, state_path=path,
                       clock=lambda: 60.2)
    assert b3.state == TenantBreaker.OPEN


def test_cost_estimator_fails_open_cold_and_tracks_per_tenant():
    est = CostEstimator()
    assert est.estimate_s("a", 100) is None  # cold: no estimate at all
    assert est.estimate_s("a", None) is None
    est.observe("a", 10, 5.0)  # 0.5 s/task
    assert est.seconds_per_task("a") == pytest.approx(0.5)
    assert est.estimate_s("a", 100) == pytest.approx(50.0)
    # an unseen tenant falls back to the global rate
    assert est.estimate_s("never-seen", 100) == pytest.approx(50.0)
    # zero/empty observations are ignored
    est.observe("a", 0, 5.0)
    est.observe("a", 10, 0.0)
    assert est.seconds_per_task("a") == pytest.approx(0.5)


# ----------------------------------------------------------------------
# service submit gates
# ----------------------------------------------------------------------

#: forces the named level regardless of load (and never steps down)
def _forced_level_policy(level):
    kw = dict(tick_interval_s=0.0, down_dwell_s=3600.0, queue_l1=10**6,
              queue_l2=10**6, queue_l3=10**6)
    if level >= L1_SHED_OPTIONAL:
        kw["queue_l1"] = 0
    if level >= L2_SHED_LOAD:
        kw["queue_l2"] = 0
    if level >= L3_EMERGENCY:
        kw["queue_l3"] = 0
    return OverloadPolicy(**kw)


def test_l3_sheds_every_submit_with_retry_after(spec):
    t0 = time.time()
    with ComputeService(
        max_concurrent=1, plan_cache=False, result_cache=False,
        overload_policy=_forced_level_policy(L3_EMERGENCY),
    ) as svc:
        for req_class in ("batch", "interactive"):
            with pytest.raises(ServiceOverloadedError) as ei:
                svc.submit(_build(spec), tenant="t", request_class=req_class)
            assert ei.value.retry_after_s >= 1.0
        snap = svc.stats_snapshot()
        assert snap["overload"]["level"] == L3_EMERGENCY
        assert snap["overload"]["requests_shed"] >= 2
        assert snap["tenants"]["t"]["shed"] == 2
        assert snap["tenants"]["t"]["accepted"] == 0
    sheds = [d for d in decisions_since(t0) if d["kind"] == "request_shed"]
    assert len(sheds) >= 2
    assert all(s["reason"] == "overload_level" for s in sheds[:2])


def test_l2_sheds_batch_but_admits_interactive(spec):
    with ComputeService(
        max_concurrent=1, plan_cache=False, result_cache=False,
        overload_policy=_forced_level_policy(L2_SHED_LOAD),
    ) as svc:
        with pytest.raises(ServiceOverloadedError):
            svc.submit(_build(spec), tenant="t")  # batch is the default
        h = svc.submit(
            _build(spec, k=3.0), tenant="t", request_class="interactive"
        )
        np.testing.assert_array_equal(h.result(120), AN + 3.0)


def test_overload_env_kill_switch(spec, monkeypatch):
    monkeypatch.setenv("CUBED_TPU_TORCH_OVERLOAD", "off")
    with ComputeService(
        max_concurrent=1, plan_cache=False, result_cache=False,
        overload_policy=_forced_level_policy(L3_EMERGENCY),
    ) as svc:
        assert svc.overload is None
        h = svc.submit(_build(spec, k=2.0), tenant="t")  # nothing sheds
        np.testing.assert_array_equal(h.result(120), AN + 2.0)
        assert svc.stats_snapshot()["overload"]["enabled"] is False


def test_invalid_request_class_rejected(spec):
    with ComputeService(max_concurrent=1) as svc:
        with pytest.raises(ValueError, match="request_class"):
            svc.submit(_build(spec), request_class="best-effort")


# ----------------------------------------------------------------------
# breakers through the service
# ----------------------------------------------------------------------


def test_tenant_breaker_trips_sheds_and_probe_recloses(spec):
    t0 = time.time()
    before = get_registry().snapshot()
    # built up front: the port traces a block function at plan time, which
    # must not eat into the 0.4 s cooldown measured below
    shed_probe, good, probe = _build(spec), _build(spec, k=5.0), _build(spec, k=6.0)
    with ComputeService(
        max_concurrent=1, plan_cache=False, result_cache=False,
        breaker_threshold=2, breaker_cooldown_s=0.4,
    ) as svc:
        for _ in range(2):
            h = svc.submit(_build_bad(spec), tenant="bad")
            with pytest.raises(ValueError):
                h.result(120)
        # tripped: the tenant's submits shed with a retry-after, and the
        # shed itself is NOT a strike (no self-amplification)
        with pytest.raises(ServiceOverloadedError) as ei:
            svc.submit(shed_probe, tenant="bad")
        assert ei.value.retry_after_s is not None
        snap = svc.stats_snapshot()
        assert snap["tenants"]["bad"]["breaker"]["state"] == "open"
        assert snap["tenants"]["bad"]["breaker"]["strikes"] == 2
        assert snap["tenants"]["bad"]["shed"] == 1
        assert "bad" in snap["overload"]["breakers_open"]
        # an innocent tenant is untouched by its neighbor's breaker
        h = svc.submit(good, tenant="good")
        np.testing.assert_array_equal(h.result(120), AN + 5.0)
        # cooldown over: the half-open probe admits ONE request, and its
        # success re-closes the breaker
        time.sleep(0.5)
        h = svc.submit(probe, tenant="bad")
        np.testing.assert_array_equal(h.result(120), AN + 6.0)
        snap = svc.stats_snapshot()
        assert snap["tenants"]["bad"]["breaker"]["state"] == "closed"
        assert snap["overload"]["breakers_open"] == []
    delta = get_registry().snapshot_delta(before)
    assert delta.get("tenant_breaker_trips", 0) >= 1
    trips = [
        d for d in decisions_since(t0)
        if d["kind"] == "tenant_breaker" and d.get("state") == "open"
    ]
    assert trips and trips[0]["tenant"] == "bad"


# ----------------------------------------------------------------------
# deadline feasibility + the typed-rejection journal round trip
# ----------------------------------------------------------------------


def _warm_and_poison_estimator(svc, spec, tenant="t"):
    """Warm the plan cache with one real run, then teach the estimator a
    ruinous seconds-per-task rate so any deadline is infeasible."""
    h = svc.submit(
        _build(spec, k=1.0), tenant=tenant, request_class="interactive"
    )
    np.testing.assert_array_equal(h.result(120), AN + 1.0)
    for _ in range(16):  # EWMA converges near 100 s/task
        svc.estimator.observe(tenant, 1, 100.0)
    return h


def test_deadline_infeasible_requests_shed_at_admission(spec, tmp_path):
    t0 = time.time()
    sdir = str(tmp_path / "svc")
    with ComputeService(
        max_concurrent=1, result_cache=False, service_dir=sdir,
        recover=False,
        overload_policy=_forced_level_policy(L2_SHED_LOAD),
    ) as svc:
        _warm_and_poison_estimator(svc, spec)
        # cold-tenant fail-open proof rode the warm call: it had no
        # estimate yet and ran to completion at L2

        # live leg: an infeasible deadline sheds with the typed error
        h = svc.submit(
            _build(spec, k=1.0), tenant="t", request_class="interactive",
            deadline_s=5.0,
        )
        with pytest.raises(DeadlineInfeasibleError) as ei:
            h.result(120)
        live_err = ei.value
        assert live_err.retry_after_s is not None
        assert h.status() == "failed"
        sheds = [
            d for d in decisions_since(t0)
            if d["kind"] == "request_shed"
            and d.get("reason") == "deadline_infeasible"
        ]
        assert sheds and sheds[0]["estimated_s"] > sheds[0]["remaining_s"]

        # the typed rejection is sealed STRUCTURED in the durable journal
        from cubed_tpu_torch.service.durability import REQUESTS_FILE, _raw_records

        recs = _raw_records(os.path.join(sdir, "t", REQUESTS_FILE))
        done = [
            r for r in recs
            if r.get("kind") == "done" and r["request_id"] == h.request_id
        ]
        assert done and done[0]["error_type"] == "DeadlineInfeasibleError"
        assert done[0]["retry_after_s"] == pytest.approx(
            live_err.retry_after_s
        )


def test_recovered_request_sheds_with_the_same_typed_rejection(
    spec, tmp_path
):
    """The satellite-6 regression, recovered leg: a request accepted (and
    journalled) before a crash carries its deadline AND fingerprint
    through the journal round trip, so the restarted service sheds it
    with the same typed error — which ``result()`` raises, retry-after
    intact."""
    from cubed_tpu_torch.service.durability import TenantRequestJournal

    sdir = str(tmp_path / "svc")
    with ComputeService(
        max_concurrent=1, result_cache=False, service_dir=sdir,
        recover=False,
        overload_policy=_forced_level_policy(L2_SHED_LOAD),
    ) as svc:
        warm = _warm_and_poison_estimator(svc, spec)
        fp = svc._requests[warm.request_id].fingerprint
        assert fp is not None
        # fake the crashed predecessor's journal: an accepted, unsealed
        # request with a deadline it can no longer meet (the exact records
        # submit() writes)
        j = TenantRequestJournal(sdir, "t2")
        j.record_accepted(
            "req-recovered-1", _build(spec, k=1.0), fingerprint=fp,
            deadline_epoch=time.time() + 5.0,
        )
        j.close()
        assert svc.recover() == 1
        h = svc.handle("req-recovered-1")
        assert h is not None
        with pytest.raises(DeadlineInfeasibleError) as ei:
            h.result(120)
        assert ei.value.retry_after_s is not None


# ----------------------------------------------------------------------
# SIGKILL mid-flood: recovery without re-admitting poison
# ----------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_KILL_SCRIPT = r"""
import json, sys, time
import numpy as np
sys.path.insert(0, {repo!r})
import cubed_tpu_torch as ct
from cubed_tpu_torch.service import ComputeService, ServiceOverloadedError
from cubed_tpu_torch.service.overload import OverloadPolicy

mode = sys.argv[1]
work_dir = {work_dir!r}
sdir = {sdir!r}
state_path = {state!r}
N = {n_requests!r}

AN = np.arange(64, dtype=np.float64).reshape(8, 8)
spec = ct.Spec(work_dir=work_dir, allowed_mem="500MB")


def build(k, delay=0.06):
    def kernel(x, _k=float(k), _d=delay):
        time.sleep(_d)
        return x + _k

    a = ct.from_array(AN, chunks=(2, 2), spec=spec)  # 16 tasks
    return ct.map_blocks(kernel, a, dtype=np.float64)


def build_bad():
    def boom(x):
        raise ValueError("poison tenant kernel")

    a = ct.from_array(AN, chunks=(4, 4), spec=spec)
    return ct.map_blocks(boom, a, dtype=np.float64)


if mode == "run":
    svc = ComputeService(
        max_concurrent=1, service_dir=sdir, recover=False,
        plan_cache=False, result_cache=False,
        breaker_threshold=2, breaker_cooldown_s=600.0,
        overload_policy=OverloadPolicy(
            queue_l1=1, queue_l2=2, queue_l3=1000,
            tick_interval_s=0.0, down_dwell_s=600.0,
        ),
    ).start()
    # trip the poison tenant's breaker (2 consecutive failures)
    for _ in range(2):
        h = svc.submit(build_bad(), tenant="poison")
        try:
            h.result(120)
        except ValueError:
            pass
    # flood alpha (interactive rides through L2) until the ladder is up
    idmap = {{}}
    for i in range(N):
        idmap[str(i)] = svc.submit(
            build(i), tenant="alpha", request_class="interactive"
        ).request_id
    snap = svc.stats_snapshot()
    with open(state_path + ".tmp", "w") as f:
        json.dump({{
            "idmap": idmap,
            "level": snap["overload"]["level"],
            "breaker": snap["tenants"]["poison"]["breaker"],
        }}, f)
    import os as _os
    _os.replace(state_path + ".tmp", state_path)
    svc.wait_idle(timeout=600)  # parent SIGKILLs us mid-flood
else:
    with open(state_path) as f:
        state = json.load(f)
    svc = ComputeService(
        max_concurrent=2, service_dir=sdir,
        breaker_threshold=2, breaker_cooldown_s=600.0,
    ).start()
    try:
        ok = svc.wait_idle(timeout=300)
        report = {{"idle": bool(ok), "results": {{}}}}
        for k, rid in state["idmap"].items():
            h = svc.handle(rid)
            if h is None:
                report["results"][k] = "missing"
            elif h.status() != "done":
                report["results"][k] = h.status()
            else:
                report["results"][k] = (
                    "correct"
                    if np.array_equal(h.result(10), AN + float(k))
                    else "WRONG"
                )
        snap = svc.stats_snapshot()["tenants"]
        report["recovered"] = (snap.get("alpha") or {{}}).get("recovered", 0)
        # the poison tenant must STAY rejected: its breaker record is
        # durable, and a SIGKILL must not hand it a fresh admission streak
        try:
            svc.submit(build(0.0), tenant="poison")
            report["poison_submit"] = "ADMITTED"
        except ServiceOverloadedError as e:
            report["poison_submit"] = "shed"
            report["poison_retry_after"] = e.retry_after_s
        print(json.dumps(report), flush=True)
    finally:
        svc.close()
"""


@pytest.mark.chaos
def test_chaos_sigkill_mid_flood_recovers_without_readmitting_poison(
    tmp_path,
):
    """SIGKILL the service while L2 is active with a tripped tenant
    breaker: the restart recovers every accepted request bitwise-correct,
    and the poison tenant's next submit is rejected straight from the
    durable breaker record."""
    from cubed_tpu_torch.service.durability import REQUESTS_FILE, _raw_records

    n_requests = 6
    sdir = str(tmp_path / "svc")
    state = str(tmp_path / "state.json")
    script = _KILL_SCRIPT.format(
        repo=REPO, work_dir=str(tmp_path), sdir=sdir, state=state,
        n_requests=n_requests,
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    requests_jsonl = os.path.join(sdir, "alpha", REQUESTS_FILE)

    proc = subprocess.Popen(
        [sys.executable, "-c", script, "run"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    killed = False
    try:
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None:
            if os.path.isfile(state) and os.path.isfile(requests_jsonl):
                done = sum(
                    1 for r in _raw_records(requests_jsonl)
                    if r.get("kind") == "done"
                )
                if 1 <= done < n_requests:
                    os.killpg(proc.pid, signal.SIGKILL)
                    killed = True
                    break
            time.sleep(0.05)
        proc.wait(timeout=30)
        assert killed, (
            f"flood drained before the kill landed (rc={proc.returncode}): "
            f"{proc.stderr.read()[-2000:]}"
        )
    finally:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(timeout=30)

    with open(state) as f:
        st = json.load(f)
    # the kill landed with the ladder genuinely up and the breaker open
    assert st["level"] >= L2_SHED_LOAD, st
    assert st["breaker"]["state"] == "open", st
    assert os.path.isfile(os.path.join(sdir, "poison", "breaker.json"))

    records = _raw_records(requests_jsonl)
    accepted = {
        r["request_id"] for r in records if r.get("kind") == "accepted"
    }
    done = {r["request_id"] for r in records if r.get("kind") == "done"}
    assert len(accepted) == n_requests and 0 < len(done) < n_requests

    out = subprocess.run(
        [sys.executable, "-c", script, "recover"], env=env,
        capture_output=True, text=True, timeout=400,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["idle"] is True
    pending = accepted - done
    assert report["recovered"] == len(pending)
    for k, rid in st["idmap"].items():
        if rid in pending:
            assert report["results"][k] == "correct", (k, report)
    # the durable breaker record survived the SIGKILL: poison stays out
    assert report["poison_submit"] == "shed", report
    assert report["poison_retry_after"] and report["poison_retry_after"] > 0


# ----------------------------------------------------------------------
# the live-fleet acceptance proof
# ----------------------------------------------------------------------


@pytest.mark.chaos
def test_chaos_overload_flood_with_poison_tenant_on_live_fleet(
    tmp_path, monkeypatch, invariant_audit,
):
    """2x flood plus a poison tenant on a real 2-worker fleet: the poison
    request fails with a PoisonTaskError naming its op+chunk within the
    strike budget, zero workers are permanently lost (the autoscaler
    backfills every kill), the innocent tenant keeps >= 0.8 of its
    deadlines, the ladder's transitions land in the decision ring, and
    the post-hoc invariant audit is clean."""
    from cubed_tpu_torch.runtime import faults
    from cubed_tpu_torch.runtime.executors.distributed import (
        DistributedDagExecutor,
    )
    from cubed_tpu_torch.runtime.resilience import PoisonTaskError, RetryPolicy

    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    an = np.arange(144, dtype=np.float64).reshape(12, 12)

    def build(k, delay=0.05):
        def kernel(x, _k=float(k), _d=delay):
            time.sleep(_d)
            return x + _k

        a = ct.from_array(an, chunks=(3, 3), spec=spec)  # 16 tasks
        return ct.map_blocks(kernel, a, dtype=np.float64)

    # the poison request: a SINGLE-chunk array whose one blockwise task
    # is named in task_fatal_chunk_keys — with worker_threads=1 the kill
    # can never take an innocent in-flight task down with it
    pn = np.arange(16, dtype=np.float64).reshape(4, 4)
    psrc = ct.from_array(pn, chunks=(4, 4), spec=spec)
    poison_arr = ct.map_blocks(
        lambda x: x + 1.0, psrc, dtype=np.float64
    )
    poison_key = str((poison_arr.name, 0, 0))
    monkeypatch.setenv(
        faults.FAULTS_ENV_VAR,
        faults.FaultConfig(
            seed=11, task_fatal_chunk_keys=(poison_key,)
        ).to_env_json(),
    )

    t0 = time.time()
    control_dir = str(tmp_path / "ctrl")
    ex = DistributedDagExecutor(
        n_local_workers=2, min_workers=2, max_workers=3, autoscale=True,
        control_dir=control_dir,
        retry_policy=RetryPolicy(
            retries=2, backoff_base=0.05, seed=0, max_requeues=2
        ),
    )
    try:
        ex._ensure_fleet()
        with ComputeService(
            executor=ex, max_concurrent=2, plan_cache=True,
            result_cache=False, breaker_threshold=3,
            breaker_cooldown_s=5.0,
            overload_policy=OverloadPolicy(
                queue_l1=2, queue_l2=4, queue_l3=1000,
                tick_interval_s=0.02, down_dwell_s=30.0,
            ),
        ) as svc:
            h_poison = svc.submit(poison_arr, tenant="poison")
            flood_handles, flood_shed = [], 0
            for i in range(10):
                try:
                    flood_handles.append(svc.submit(build(i), tenant="flood"))
                except ServiceOverloadedError as e:
                    assert e.retry_after_s is not None
                    flood_shed += 1
                time.sleep(0.03)  # let the ladder tick between submits
            slo_handles = []
            for i in range(5):
                slo_handles.append(svc.submit(
                    build(100 + i), tenant="slo", deadline_s=90.0,
                    request_class="interactive",
                ))
                time.sleep(0.03)

            # the poison request is convicted within its strike budget,
            # naming the culprit op and chunk
            with pytest.raises(PoisonTaskError) as ei:
                h_poison.result(240)
            assert ei.value.chunk == poison_key
            assert ei.value.attempts <= 3  # K = max_requeues + 1

            # innocent tenants ride through: every accepted flood request
            # completes, and the deadline tenant meets >= 0.8 of its SLOs
            for i, h in enumerate(flood_handles):
                np.testing.assert_array_equal(h.result(240), an + float(i))
            met = 0
            for i, h in enumerate(slo_handles):
                try:
                    np.testing.assert_array_equal(
                        h.result(240), an + float(100 + i)
                    )
                    met += 1
                except Exception:
                    pass
            assert met / len(slo_handles) >= 0.8

            # the ladder genuinely engaged under the flood
            snap = svc.stats_snapshot()
            assert snap["overload"]["transitions"] >= 1, snap["overload"]
            level_records = [
                d for d in decisions_since(t0)
                if d["kind"] == "overload_level"
            ]
            assert level_records, "no ladder transitions in the ring"
            quarantines = [
                d for d in decisions_since(t0)
                if d["kind"] == "poison_quarantine"
            ]
            assert quarantines and quarantines[0]["chunk"] == poison_key

        # zero workers PERMANENTLY lost: kills happened, and the
        # autoscaler backfilled the fleet to its floor
        assert ex._coordinator.stats["workers_lost"] >= 1
        deadline = time.time() + 60
        while time.time() < deadline and ex._coordinator.n_workers < 2:
            time.sleep(0.25)
        assert ex._coordinator.n_workers >= 2, (
            f"fleet not backfilled: {ex._coordinator.n_workers} worker(s)"
        )
    finally:
        ex.close()
    # survived the flood AND never did anything illegal along the way
    invariant_audit(
        control_dir=control_dir, work_dir=str(tmp_path),
        expect_success=False,
    )


@pytest.fixture(scope="module", autouse=True)
def _clean_process(clean_process):
    yield


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------


def test_ladder_and_breaker_decisions_match_the_jax_package():
    """One scripted run of queue depths, deadline misses and a clock steps
    the port's ladder through the JAX package's levels tick for tick, and a
    scripted failure/success/clock run walks both breakers through the same
    states, strikes and retry-after hints."""
    from cubed_tpu.service.overload import OverloadController as RefController
    from cubed_tpu.service.overload import OverloadPolicy as RefPolicy
    from cubed_tpu.service.overload import TenantBreaker as RefBreaker

    t = [1000.0]
    kw = dict(tick_interval_s=0.0, down_dwell_s=1.0, queue_l1=2, queue_l2=4, queue_l3=8, miss_min_samples=2)
    ours = OverloadController(OverloadPolicy(**kw), clock=lambda: t[0])
    theirs = RefController(RefPolicy(**kw), clock=lambda: t[0])
    script = [(0, 0.0, None), (9, 0.1, None), (0, 0.5, None), (0, 0.6, None), (3, 0.2, None), (0, 1.1, True),
              (0, 0.0, True), (1, 1.2, False), (0, 1.1, None), (5, 0.3, None), (2, 2.0, None), (0, 1.5, None)]
    try:
        for depth, dt, missed in script:
            t[0] += dt
            if missed is not None:
                ours.note_completion(missed)
                theirs.note_completion(missed)
            assert ours.tick(depth) == theirs.tick(depth)
            assert ours.snapshot() == theirs.snapshot()
            assert ours.retry_after_s(depth) == theirs.retry_after_s(depth)
    finally:
        ours.close()
        theirs.close()
    c = [0.0]
    breakers = (TenantBreaker("t", threshold=2, cooldown_s=3.0, clock=lambda: c[0]),
                RefBreaker("t", threshold=2, cooldown_s=3.0, clock=lambda: c[0]))
    for step, dt in [("check", 0), ("fail", 0), ("ok", 0), ("fail", 0), ("fail", 0), ("check", 1), ("check", 2.5),
                     ("check", 0), ("abort", 0), ("check", 0), ("fail", 0), ("check", 4), ("ok", 0), ("check", 0)]:
        c[0] += dt
        out = []
        for b in breakers:
            out.append({"check": b.check, "fail": b.on_failure, "ok": b.on_success, "abort": b.abort_probe}[step]())
            out.append((b.snapshot(), b.is_open))
        assert out[0:2] == out[2:4], (step, out)
