"""The port's alert engine (``cubed_tpu_torch/observability/alerts.py``): the
counterparts of tests/observability/test_alerts.py. The rule and engine
cases feed the same series into the JAX package's store and rules and the
port's and compare every evaluation and firing; the chaos case burns the
retry budget with the port's seeded storage faults on its threads executor
and finds the firing in the decision ring, the flight-recorder bundle and
the diagnose report (rendered by both packages from the port's bundle)."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu_torch as ct  # noqa: E402
from cubed_tpu import diagnose as ref_diagnose  # noqa: E402
from cubed_tpu.observability import alerts as ref_alerts  # noqa: E402
from cubed_tpu.observability import timeseries as ref_ts  # noqa: E402
from cubed_tpu_torch import diagnose as port_diagnose  # noqa: E402
from cubed_tpu_torch.observability import alerts as port_alerts  # noqa: E402
from cubed_tpu_torch.observability import export  # noqa: E402
from cubed_tpu_torch.observability import timeseries as port_ts  # noqa: E402
from cubed_tpu_torch.observability.collect import decisions_since  # noqa: E402
from cubed_tpu_torch.observability.flightrecorder import FlightRecorder, load_bundle  # noqa: E402
from cubed_tpu_torch.observability.metrics import get_registry  # noqa: E402
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor  # noqa: E402

PAIRS = ((ref_alerts, ref_ts), (port_alerts, port_ts))


def _evaluate(make_rule, points, nows):
    """Evaluate a rule over a store holding *points* ``(name, value, ts,
    labels)`` at each of *nows*, in both packages; the port's results, after
    asserting they equal the reference's."""
    out = []
    for a, t in PAIRS:
        store = t.TimeSeriesStore()
        for name, value, ts, labels in points:
            store.record(name, value, ts=ts, labels=labels)
        rule = make_rule(a)
        out.append([rule.evaluate(store, now) for now in nows])
    assert out[1] == out[0]
    return out[1]


def test_threshold_rule_latest_value():
    rule = lambda a: a.ThresholdRule("mem", metric="fleet_pressured_fraction", threshold=0.5)  # noqa: E731
    assert _evaluate(rule, [], [100.0]) == [None]
    assert _evaluate(rule, [("fleet_pressured_fraction", 0.25, 99.0, None)], [100.0]) == [None]
    (details,) = _evaluate(rule, [("fleet_pressured_fraction", 0.25, 99.0, None),
                                  ("fleet_pressured_fraction", 0.5, 100.0, None)], [100.0])
    assert details["value"] == 0.5 and details["threshold"] == 0.5


def test_threshold_rule_rate_mode():
    rule = lambda a: a.ThresholdRule("stragglers", metric="stragglers_detected", rate=True,  # noqa: E731
                                     threshold=0.2, window_s=30.0)
    pts = [("stragglers_detected", 0, 70.0, None), ("stragglers_detected", 1, 80.0, None)]
    assert _evaluate(rule, pts, [80.0]) == [None]
    (details,) = _evaluate(rule, pts + [("stragglers_detected", 7, 90.0, None)], [90.0])
    assert details["value"] >= 0.2


def test_threshold_rule_ignores_frozen_series():
    rule = lambda a: a.ThresholdRule("mem", metric="fleet_pressured_fraction", threshold=0.5)  # noqa: E731
    stale = 100.0 + port_alerts.ThresholdRule.STALE_AFTER_S + 1
    fresh, frozen = _evaluate(rule, [("fleet_pressured_fraction", 0.9, 100.0, None)], [105.0, stale])
    assert fresh is not None and frozen is None


def test_threshold_rule_rejects_bad_comparison():
    for a, _ in PAIRS:
        with pytest.raises(ValueError):
            a.ThresholdRule("x", metric="m", threshold=1, comparison="==")


def test_burn_rate_rule():
    rule = lambda a: a.BurnRateRule("retry_burn", counter="task_retries", budget=100,  # noqa: E731
                                    burn_frac=0.1, window_s=60.0)
    pts = [("task_retries", 0, 0.0, None), ("task_retries", 5, 30.0, None)]
    assert _evaluate(rule, pts, [30.0]) == [None]
    (details,) = _evaluate(rule, pts + [("task_retries", 12, 40.0, None)], [40.0])
    assert details["value"] == 12 and details["threshold"] == 10.0


@pytest.mark.parametrize("shape", ["progressing", "stalled", "never_completed", "just_filled", "empty"])
def test_stall_rule_fires_only_on_sustained_stall(shape):
    pts = []
    if shape in ("progressing", "stalled", "never_completed"):
        for t in range(0, 40, 5):
            pts.append(("queue_depth", 4, float(t), None))
            if shape != "never_completed":
                pts.append(("tasks_completed", t if shape == "progressing" else 7, float(t), None))
    elif shape == "just_filled":
        pts = [("queue_depth", 4, 38.0, None), ("queue_depth", 4, 39.0, None),
               ("tasks_completed", 7, 38.0, None), ("tasks_completed", 7, 39.0, None)]
    (details,) = _evaluate(lambda a: a.StallRule("stall", window_s=30.0), pts, [39.0])
    assert (details is not None) == (shape in ("stalled", "never_completed"))


def test_default_rules_cover_the_documented_shapes():
    port = [(r.name, r.severity, type(r).__name__) for r in port_alerts.default_rules()]
    ref = [(r.name, r.severity, type(r).__name__) for r in ref_alerts.default_rules()]
    assert port == ref
    assert {n for n, _, _ in port} == {
        "retry_budget_burn", "fleet_memory_pressure", "straggler_rate", "queue_depth_stall",
        "peer_fetch_fallback_spike", "tenant_starvation", "store_brownout", "dispatch_saturation",
        "overload_shedding", "tenant_breaker_open", "slo_fast_burn", "slo_slow_burn",
    }


def test_tenant_starvation_rule_fires_per_tenant():
    now = 1000.0
    pts = []
    for i in range(40):
        ts = now - 40 + i
        pts += [("tenant_queued", 3, ts, {"tenant": "starved"}), ("tenant_completed", 7, ts, {"tenant": "starved"}),
                ("tenant_queued", 5, ts, {"tenant": "busy"}), ("tenant_completed", i, ts, {"tenant": "busy"})]
    (firing,) = _evaluate(lambda a: a.TenantStarvationRule(window_s=30.0), pts, [now])
    assert firing["tenants"] == ["starved"] and firing["metric"] == "tenant_queued"


def test_tenant_starvation_needs_the_whole_window():
    now = 1000.0
    rule = lambda a: a.TenantStarvationRule(window_s=30.0)  # noqa: E731
    fresh = [("tenant_queued", 4, now - 5 + i, {"tenant": "new"}) for i in range(5)]
    assert _evaluate(rule, fresh, [now]) == [None]
    wedged = [("tenant_queued", 4, now - 40 + i, {"tenant": "wedged"}) for i in range(40)]
    (firing,) = _evaluate(rule, wedged, [now])
    assert firing["tenants"] == ["wedged"]


def test_dispatch_saturation_rule_matches_reference():
    now = 100.0
    pts = [(name, v, now - 20 + i, None) for i in range(21)
           for name, v in (("dispatch_utilization", 0.95), ("queue_depth", 10 + i))]
    (firing,) = _evaluate(lambda a: a.DispatchSaturationRule(), pts, [now])
    assert firing["metric"] == "dispatch_utilization" and firing["queue_depth"] == 30


# ---------------------------------------------------------------------------
# engine semantics
# ---------------------------------------------------------------------------


def _engine(a, t, frac, ts=100.0, cooldown_s=60.0, extra=()):
    store = t.TimeSeriesStore()
    store.record("fleet_pressured_fraction", frac, ts=ts)
    rules = list(extra) + [a.ThresholdRule("mem", metric="fleet_pressured_fraction", threshold=0.5)]
    return store, a.AlertEngine(store, rules=rules, cooldown_s=cooldown_s)


def _strip(firings):
    return [{k: v for k, v in f.items()} for f in firings]


def test_engine_fires_on_rising_edge_and_counts():
    out = []
    for a, t in PAIRS:
        _, engine = _engine(a, t, 0.75)
        out.append((_strip(engine.tick(now=100.0)), engine.active(), _strip(engine.recent())))
    assert out[1] == out[0]
    fired, active, recent = out[1]
    assert [f["rule"] for f in fired] == ["mem"] and fired[0]["value"] == 0.75
    assert active == ["mem"] and recent[-1]["rule"] == "mem"
    # the port's firing lands in its own counter and decision ring
    reg = get_registry()
    before = reg.snapshot()
    _, engine = _engine(port_alerts, port_ts, 0.75)
    engine.tick(now=100.0)
    assert reg.snapshot_delta(before).get("alerts_fired") == 1
    ring = [d for d in decisions_since(0) if d["kind"] == "alert_fired"]
    assert ring and ring[-1]["rule"] == "mem"


def test_engine_cooldown_suppresses_sustained_condition():
    out = []
    for a, t in PAIRS:
        store, engine = _engine(a, t, 0.9)
        counts = [len(engine.tick(now=100.0))]
        for ts, frac in ((101.0, 0.9), (161.0, 0.9), (162.0, 0.1), (163.0, 0.9)):
            store.record("fleet_pressured_fraction", frac, ts=ts)
            counts.append(len(engine.tick(now=ts)))
        out.append(counts)
    assert out[1] == out[0] == [1, 0, 1, 0, 1]


def test_engine_survives_a_broken_rule():
    out = []
    for a, t in PAIRS:
        class _Broken(a.ThresholdRule):
            def evaluate(self, store, now):
                raise RuntimeError("boom")

        _, engine = _engine(a, t, 0.9, extra=[_Broken("broken", metric="x", threshold=1)])
        out.append([f["rule"] for f in engine.tick(now=100.0)])
    assert out[1] == out[0] == ["mem"]


def test_format_alert_row_matches_reference():
    firing = {"severity": "critical", "rule": "retry_budget_burn", "metric": "task_retries", "value": 12,
              "threshold": 10.0}
    assert port_alerts.format_alert_row(firing) == ref_alerts.format_alert_row(firing)
    assert port_alerts.format_alert_row({}) == ref_alerts.format_alert_row({})


# ---------------------------------------------------------------------------
# chaos: a seeded retry burn on the port's threads executor
# ---------------------------------------------------------------------------


def test_chaos_retry_burn_fires_alert_into_ring_bundle_and_diagnose(tmp_path, monkeypatch):
    export.shutdown()
    monkeypatch.delenv(export.TELEMETRY_PORT_ENV_VAR, raising=False)
    spec = ct.Spec(work_dir=str(tmp_path / "work"), allowed_mem="500MB", telemetry_port=0,
                   fault_injection={"storage_read_failure_rate": 0.25, "seed": 7})
    fr = FlightRecorder(bundle_dir=str(tmp_path / "bundles"), always=True)
    an = np.arange(144.0).reshape(12, 12)
    a = ct.from_array(an, chunks=(3, 3), spec=spec)
    r = ct.map_blocks(lambda x: x + 2.0, a, dtype=np.float64)
    retries_before = get_registry().snapshot().get("task_retries", 0)
    try:
        result = np.asarray(r.compute(callbacks=[fr], executor=AsyncPythonDagExecutor()))
        np.testing.assert_array_equal(result, an + 2.0)
        rt = export.get_runtime()
        assert rt is not None, "telemetry never armed"
        rt.alert_engine.rules = [port_alerts.BurnRateRule("retry_budget_burn", counter="task_retries", budget=10,
                                                          burn_frac=0.1, window_s=300.0)]
        rt.alert_engine._state = {"retry_budget_burn": {"active": False, "last_fired": 0.0}}
        retries = get_registry().snapshot().get("task_retries", 0)
        assert retries - retries_before > 0, "seeded flakiness produced no retries"
        rt.store.record("task_retries", retries_before, ts=time.time() - 30.0)
        rt.sampler.sample_once()
        assert [f["rule"] for f in rt.alert_engine.recent()] == ["retry_budget_burn"]
        assert rt.alert_engine.active() == ["retry_budget_burn"]
        ring = [d for d in decisions_since(0) if d["kind"] == "alert_fired" and d["rule"] == "retry_budget_burn"]
        assert ring, "alert firing missing from the decision ring"
        bundle = load_bundle(fr.dump())
        manifest = bundle["manifest"]
        assert any(x.get("rule") == "retry_budget_burn" for x in manifest.get("alerts") or [])
        assert any(s["name"] == "task_retries" for s in manifest.get("timeseries") or [])
        report = port_diagnose.render_report(bundle)
        assert "alerts" in report and "retry_budget_burn" in report and "timeseries:" in report
        assert report == ref_diagnose.render_report(bundle)
    finally:
        export.shutdown()
