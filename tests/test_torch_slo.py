"""The port's SLOs (``cubed_tpu_torch/observability/slo.py``): the
counterparts of tests/observability/test_slo.py. Every case runs the same
objectives and the same request outcomes through the JAX package's board
and the port's and compares their status rows exactly (burn arithmetic,
budgets, SLI counts, latency quantiles). The compute service is not ported
yet, so the service cases drive the sampler, the alert rules, the
Prometheus export and the top panel from a stand-in registered through
``timeseries.register_service`` whose ``stats_snapshot`` carries the board's
rows, as the reference service's does; the archive fold after a killed
service waits for the service."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import time  # noqa: E402

import pytest  # noqa: E402

from cubed_tpu import top as ref_top  # noqa: E402
from cubed_tpu.observability import alerts as ref_alerts  # noqa: E402
from cubed_tpu.observability import export as ref_export  # noqa: E402
from cubed_tpu.observability import slo as ref_slo  # noqa: E402
from cubed_tpu.observability import timeseries as ref_ts  # noqa: E402
from cubed_tpu_torch import top as port_top  # noqa: E402
from cubed_tpu_torch.observability import alerts as port_alerts  # noqa: E402
from cubed_tpu_torch.observability import export as port_export  # noqa: E402
from cubed_tpu_torch.observability import slo as port_slo  # noqa: E402
from cubed_tpu_torch.observability import timeseries as port_ts  # noqa: E402

SLO_MODS = (ref_slo, port_slo)


def _both(fn):
    """``fn(slo_module)`` for the reference and the port; the two results."""
    return [fn(m) for m in SLO_MODS]


def _board(mod, **fields):
    fields = fields or {"latency_s": 1.0, "availability_objective": 0.99}
    return mod.SloBoard({"t": mod.SloSpec("t", **fields)})


# ---------------------------------------------------------------------------
# spec + env parsing
# ---------------------------------------------------------------------------


def test_spec_requires_at_least_one_objective():
    for mod in SLO_MODS:
        with pytest.raises(ValueError, match="latency_s and/or"):
            mod.SloSpec("a")
    ref, port = _both(lambda m: (m.SloSpec("a", latency_s=2.0).to_dict(),
                                 m.SloSpec("a", availability_objective=0.999).to_dict()))
    assert port == ref


def test_spec_validates_objective_bounds():
    for mod in SLO_MODS:
        with pytest.raises(ValueError, match="must be in"):
            mod.SloSpec("a", latency_s=2.0, latency_objective=1.0)
        with pytest.raises(ValueError, match="must be in"):
            mod.SloSpec("a", availability_objective=0.0)
        with pytest.raises(ValueError, match="window_s must be positive"):
            mod.SloSpec("a", latency_s=1.0, window_s=0)


def test_spec_from_value_rejects_unknown_fields():
    for mod in SLO_MODS:
        with pytest.raises(ValueError, match="unknown SLO field"):
            mod.SloSpec.from_value("a", {"latency_s": 2.0, "typo_field": 1})
        spec = mod.SloSpec.from_value("a", {"latency_s": 2.0})
        assert spec.latency_s == 2.0
        assert mod.SloSpec.from_value("a", spec) is spec
        with pytest.raises(ValueError, match="must be an SloSpec"):
            mod.SloSpec.from_value("a", 3)


def test_parse_slos_env(monkeypatch):
    assert port_slo.SLOS_ENV_VAR == "CUBED_TPU_TORCH_SERVICE_SLOS"
    for mod in SLO_MODS:
        monkeypatch.delenv(mod.SLOS_ENV_VAR, raising=False)
        assert mod.parse_slos_env() is None
        monkeypatch.setenv(mod.SLOS_ENV_VAR, '{"t": {"latency_s": 2.0}}')
        assert mod.parse_slos_env()["t"]["latency_s"] == 2.0
        # malformed values are logged and ignored, never fatal
        monkeypatch.setenv(mod.SLOS_ENV_VAR, "{not json")
        assert mod.parse_slos_env() is None
        monkeypatch.setenv(mod.SLOS_ENV_VAR, '{"t": {"bogus": 1}}')
        assert mod.parse_slos_env() is None
        monkeypatch.delenv(mod.SLOS_ENV_VAR)


def test_board_resolve_env_wins_per_tenant(monkeypatch):
    for mod in SLO_MODS:
        monkeypatch.setenv(mod.SLOS_ENV_VAR, '{"a": {"latency_s": 9.0}}')
        board = mod.SloBoard.resolve({"a": {"latency_s": 1.0}, "b": {"latency_s": 2.0}})
        assert board.spec_for("a").latency_s == 9.0  # env override
        assert board.spec_for("b").latency_s == 2.0
        assert board.tenants == ["a", "b"]
        monkeypatch.delenv(mod.SLOS_ENV_VAR)
        assert mod.SloBoard.resolve(None) is None


# ---------------------------------------------------------------------------
# SLI / burn-rate math: the same outcomes, the same rows
# ---------------------------------------------------------------------------


def _run(records, now, **fields):
    def one(mod):
        board = _board(mod, **fields)
        for tenant, ok, latency, ts in records:
            board.record(tenant, ok=ok, latency_s=latency, ts=ts)
        return board.status(now=now)

    ref, port = _both(one)
    assert port == ref
    return port


def test_empty_window_is_healthy_not_paging():
    row = _run([], now=1000.0)["t"]
    assert row["events"] == 0
    assert row["budget_remaining"] == 1.0
    assert all(v == 0.0 for v in row["burn"].values())
    assert not row["fast_burn"] and not row["slow_burn"]


def test_all_good_traffic_burns_nothing():
    row = _run([("t", True, 0.1, 1000.0 + i) for i in range(50)], now=1100.0)["t"]
    assert row["burn"]["5m"] == 0.0
    assert row["budget_remaining"] == 1.0
    assert row["good_fraction"] == 1.0


def test_latency_misses_and_failures_both_burn_latency_budget():
    row = _run([("t", True, 5.0, 1000.0), ("t", False, 0.1, 1001.0), ("t", True, 0.1, 1002.0)],
               now=1003.0)["t"]
    assert row["events"] == 3
    assert row["latency_bad"] == 2
    assert row["availability_bad"] == 1
    assert row["burn"]["5m"] == pytest.approx((2 / 3) / 0.01, rel=1e-3)
    assert row["budget_remaining"] == 0.0
    assert row["latency"]["count"] == 3


def test_burn_1x_means_spending_exactly_the_budget():
    records = [("t", True, None, 1000.0 + i) for i in range(99)] + [("t", False, None, 1099.0)]
    row = _run(records, now=1100.0, availability_objective=0.99)["t"]
    assert row["burn"]["5m"] == pytest.approx(1.0, rel=1e-6)
    assert row["budget_remaining"] == pytest.approx(0.0, abs=1e-6)


def test_windows_forget_old_badness():
    records = [("t", False, None, 1000.0)] + [("t", True, None, 5000.0 + i) for i in range(10)]
    row = _run(records, now=5000.0 + port_slo.BURN_WINDOWS["5m"], availability_objective=0.99)["t"]
    assert row["burn"]["5m"] == 0.0  # the 5m window no longer sees it
    assert row["burn"]["3d"] > 0.0   # the compliance window still does


@pytest.mark.parametrize("n_bad", [0, 1, 3, 20, 60])
def test_burn_windows_and_thresholds_match_reference(n_bad):
    """A seeded mix of outcomes across every burn window; fast and slow burn
    flags flip where the reference's do."""
    import random

    rng = random.Random(n_bad)
    records = []
    for i in range(200):
        ts = 1000.0 + rng.uniform(0, 4 * 86400.0)
        bad = i < n_bad
        records.append(("t", not bad or rng.random() < 0.5, rng.choice([0.2, 3.0]) if bad else 0.2, ts))
    rows = _run(sorted(records, key=lambda r: r[3]), now=1000.0 + 4 * 86400.0, latency_s=1.0,
                latency_objective=0.95, availability_objective=0.99)
    assert set(rows["t"]["burn"]) == set(port_slo.BURN_WINDOWS)


def test_record_for_unconfigured_tenant_is_ignored():
    rows = _run([("stranger", False, 9.0, 1000.0)], now=1001.0)
    assert "stranger" not in rows
    assert rows["t"]["events"] == 0


def test_fold_skips_ineligible_and_malformed_records():
    records = [
        {"kind": "request", "tenant": "t", "status": "completed", "ok": True, "latency_s": 0.1, "ts": 1000.0},
        {"kind": "request", "tenant": "t", "status": "failed", "ok": False, "ts": 1001.0},
        {"kind": "request", "tenant": "t", "status": "shed", "ts": 1002.0},
        {"kind": "request", "tenant": "t", "status": "cancelled", "ts": 1003.0},
        {"kind": "request", "tenant": "other", "status": "completed", "ok": True, "ts": 1004.0},
        {"kind": "compute", "tenant": "t", "ts": 1005.0},
        {"kind": "request", "tenant": "t", "status": "completed", "ok": True},  # no ts
    ]

    def one(mod):
        board = _board(mod)
        return board.fold(records), board.status(now=1010.0)

    ref, port = _both(one)
    assert port == ref
    folded, rows = port
    assert folded == 2
    assert rows["t"]["events"] == 2 and rows["t"]["availability_bad"] == 1


def test_fold_from_the_port_archive(tmp_path):
    """Request records written by the port's run archive fold into a board
    as the reference's archive records do."""
    from cubed_tpu_torch.observability import runhistory

    for i, status in enumerate(("completed", "failed", "shed", "completed")):
        runhistory.record_request(str(tmp_path), request_id=f"r{i}", tenant="t", status=status,
                                  latency_s=0.5 * (i + 1))
    records, bad = runhistory.load_runs(str(tmp_path))
    assert bad == 0

    def one(mod):
        board = _board(mod)
        return board.fold(records), board.status()["t"]["events"]

    ref, port = _both(one)
    assert port == ref == (3, 3)


# ---------------------------------------------------------------------------
# the burn-rate alert rule
# ---------------------------------------------------------------------------


def _store_with_burns(ts_mod, now, fast=20.0, slow=20.0):
    store = ts_mod.TimeSeriesStore()
    labels = {"tenant": "t"}
    store.record("slo_burn_5m", fast, ts=now, labels=labels)
    store.record("slo_burn_1h", fast, ts=now, labels=labels)
    store.record("slo_burn_6h", slow, ts=now, labels=labels)
    store.record("slo_burn_3d", slow, ts=now, labels=labels)
    return store


@pytest.mark.parametrize("fast,slow", [(20.0, 20.0), (14.4, 0.5), (10.0, 1.0), (0.0, 0.0)])
def test_slo_burn_rules_fire_as_the_reference(fast, slow):
    now = 1000.0
    out = []
    for a, t in ((ref_alerts, ref_ts), (port_alerts, port_ts)):
        rules = [a.SloBurnRateRule("fast", "1h", "5m", ref_slo.FAST_BURN_THRESHOLD),
                 a.SloBurnRateRule("slow", "3d", "6h", ref_slo.SLOW_BURN_THRESHOLD)]
        out.append([r.evaluate(_store_with_burns(t, now, fast, slow), now) for r in rules])
    assert out[1] == out[0]
    assert (out[1][0] is not None) == (fast >= 14.4)


def test_slo_burn_rule_requires_both_windows():
    now = 1000.0
    for a, t in ((ref_alerts, ref_ts), (port_alerts, port_ts)):
        rule = a.SloBurnRateRule("fast", "1h", "5m", port_slo.FAST_BURN_THRESHOLD)
        assert rule.evaluate(_store_with_burns(t, now), now)["tenants"] == ["t"]
        store = t.TimeSeriesStore()
        store.record("slo_burn_1h", 20.0, ts=now, labels={"tenant": "t"})
        store.record("slo_burn_5m", 0.0, ts=now, labels={"tenant": "t"})
        assert rule.evaluate(store, now) is None


def test_slo_burn_rule_ignores_stale_series():
    now = 1000.0
    for a, t in ((ref_alerts, ref_ts), (port_alerts, port_ts)):
        rule = a.SloBurnRateRule("fast", "1h", "5m", port_slo.FAST_BURN_THRESHOLD)
        assert rule.evaluate(_store_with_burns(t, now - 60.0), now) is None


def test_default_rules_ship_both_slo_burn_rules():
    rules = {r.name: r for r in port_alerts.default_rules()}
    assert rules["slo_fast_burn"].severity == "critical"
    assert rules["slo_slow_burn"].severity == "warning"
    assert rules["slo_fast_burn"].threshold == port_slo.FAST_BURN_THRESHOLD


# ---------------------------------------------------------------------------
# a service's board through the sampler, the rules, /metrics and top
# ---------------------------------------------------------------------------


class _StandInService:
    """What the sampler and /snapshot.json read of a live service: its
    ``stats_snapshot`` (tenants and SLO rows) and ``closed``."""

    def __init__(self, board):
        self.board = board
        self.closed = False

    def stats_snapshot(self):
        return {"tenants": {}, "queue_depth": 0, "running": 0, "slots": 1, "slo": self.board.status()}


def _bad_service(mod, ts_mod, n=6):
    """A tenant that can never meet its microsecond latency objective."""
    board = mod.SloBoard({"alpha": mod.SloSpec("alpha", latency_s=1e-6, availability_objective=0.999)})
    for i in range(n):
        board.record("alpha", ok=True, latency_s=0.01 * (i + 1))
    svc = _StandInService(board)
    ts_mod.register_service(svc)
    return svc


def _service_case(check):
    out = []
    for mod, ts_mod, a, e, t in ((ref_slo, ref_ts, ref_alerts, ref_export, ref_top),
                                 (port_slo, port_ts, port_alerts, port_export, port_top)):
        svc = _bad_service(mod, ts_mod)
        try:
            out.append(check(svc, ts_mod, a, e, t))
        finally:
            svc.closed = True
            ts_mod.unregister_service(svc)
    return out


def test_service_snapshot_carries_slo_state():
    ref, port = _service_case(lambda svc, ts_mod, *_: ts_mod.service_view()["slo"]["alpha"])
    assert port["events"] == ref["events"] == 6
    assert port["latency_bad"] == 6 and port["budget_remaining"] == 0.0
    assert port["fast_burn"] and port["slow_burn"]
    assert port["latency"]["p99_s"] > 0
    assert {k: v for k, v in port.items() if k != "latency"} == {k: v for k, v in ref.items() if k != "latency"}


def test_sampler_series_fire_both_burn_alerts():
    """board -> sampler slo_* series -> default rules -> firings, on the
    first engine tick, in both packages."""
    def check(svc, ts_mod, a, *_):
        store = ts_mod.TimeSeriesStore()
        ts_mod.TelemetrySampler(store).sample_once()
        names = {name for name, labels, _v in store.latest_series() if labels.get("tenant") == "alpha"}
        return names, {f["rule"] for f in a.AlertEngine(store).tick()}

    (ref_names, ref_fired), (names, fired) = _service_case(check)
    assert names == ref_names
    for expected in ("slo_burn_5m", "slo_burn_1h", "slo_burn_6h", "slo_burn_3d", "slo_budget_remaining",
                     "slo_events_total", "slo_bad_total", "slo_request_latency_p50", "slo_request_latency_p99"):
        assert expected in names, expected
    assert fired == ref_fired
    assert {"slo_fast_burn", "slo_slow_burn"} <= fired


def test_metrics_export_regroups_latency_quantiles_as_summary():
    def check(svc, ts_mod, a, e, t):
        store = ts_mod.TimeSeriesStore()
        ts_mod.TelemetrySampler(store).sample_once()
        return e.prometheus_text(store=store)

    ref, port = _service_case(check)
    assert "# TYPE cubed_tpu_torch_slo_request_latency summary" in port
    assert 'quantile="0.99"' in port and 'tenant="alpha"' in port
    assert "slo_request_latency_p99{" not in port
    fams = [ln.split()[2].replace("cubed_tpu_torch_", "", 1) for ln in port.splitlines() if ln.startswith("# TYPE")]
    ref_fams = [ln.split()[2].replace("cubed_tpu_", "", 1) for ln in ref.splitlines() if ln.startswith("# TYPE")]
    assert [f for f in fams if f.startswith("slo_")] == [f for f in ref_fams if f.startswith("slo_")]


def test_top_panel_renders_slo_rows():
    def check(svc, ts_mod, a, e, t):
        return t.render({"ts": time.time(), "metrics": {}, "service": ts_mod.service_view()})

    ref, port = _service_case(check)
    assert "SLO" in port and "alpha" in port and "FAST BURN" in port
    slo_rows = [ln for ln in port.splitlines() if ln.startswith("alpha")]
    assert slo_rows == [ln for ln in ref.splitlines() if ln.startswith("alpha")]
