"""``python -m cubed_tpu_torch.top``: the counterparts of
tests/observability/test_top.py. Every frame is rendered by both packages'
``top`` from the same snapshot and compared line for line once the header's
program name is set aside; the reference's checked-in
``tests/observability/fixtures/snapshot.json`` is read as data. The live
case serves the port's telemetry on an ephemeral loopback port, stopped in
a ``finally``."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import time  # noqa: E402

from cubed_tpu import top as ref_top  # noqa: E402
from cubed_tpu_torch import top  # noqa: E402
from cubed_tpu_torch.observability.export import TelemetryRuntime  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "observability", "fixtures", "snapshot.json")


def _snapshot(ts=None):
    ts = ts or time.time()
    return {
        "ts": ts,
        "metrics": {"tasks_completed": 42, "alerts_fired": 2},
        "fleet": {
            "workers_live": 2, "workers_pressured": 1, "workers_disconnected": 0,
            "workers": {
                "local-0": {"alive": True, "connected": True, "pressured": False, "nthreads": 2, "outstanding": 1,
                            "tasks_sent": 20, "rss": 150 * 2**20, "peer_cache": {"bytes": 32 * 2**20},
                            "clock_offset": 0.002, "metrics": {"peer_hits": 9, "peer_misses": 1}},
                "local-1": {"alive": True, "connected": False, "pressured": True, "nthreads": 2, "outstanding": 0,
                            "tasks_sent": 22, "rss": None, "peer_cache": None, "clock_offset": None,
                            "metrics": None},
            },
        },
        "computes": [
            {"compute_id": "c-done", "tasks_done": 8, "tasks_total": 8, "status": "succeeded",
             "started_at": ts - 60, "ended_at": ts - 30},
            {"compute_id": "c-live", "tasks_done": 30, "tasks_total": 100, "status": "running",
             "started_at": ts - 10, "ended_at": None},
        ],
        "alerts": [{"ts": ts - 5, "rule": "fleet_memory_pressure", "severity": "critical",
                    "metric": "fleet_pressured_fraction", "value": 0.5, "threshold": 0.5}],
        "alerts_active": ["fleet_memory_pressure"],
        "series": [{"name": "compute_tasks_done", "labels": {"compute": "c-live"},
                    "points": [[ts - 10, 0], [ts - 5, 15], [ts, 30]]}],
    }


def _render(snap) -> str:
    frame = top.render(snap)
    assert frame.replace("cubed_tpu_torch.top", "cubed_tpu.top", 1) == ref_top.render(snap)
    return frame


def _service(cost=False):
    gold = {"weight": 2.0, "queued": 3, "running": 1, "completed": 10, "failed": 0, "throttled": 0,
            "plan_cache_hits": 2, "result_cache_hits": 3}
    if cost:
        gold["cost"] = {"task_seconds": 12.5, "bytes_read": 1_000_000, "bytes_written": 2_000_000,
                        "peer_bytes": 0, "retries": 1}
    return {"tenants": {"gold": gold, "free": {"weight": 1.0, "queued": 7, "running": 0, "completed": 4,
                                               "failed": 1, "throttled": 5, "plan_cache_hits": 0,
                                               "result_cache_hits": 0}},
            "queue_depth": 10, "running": 1, "slots": 2, "throttling": True}


def test_render_fleet_table_progress_and_alerts():
    frame = _render(_snapshot())
    assert frame.startswith("cubed_tpu_torch.top")
    assert "local-0" in frame and "local-1" in frame and "disconnected" in frame
    assert "157.3 MB" in frame and "1/2" in frame and "90%" in frame
    assert "c-live" in frame and "30/100" in frame and "30%" in frame
    assert "tasks/s" in frame and "ETA" in frame and "succeeded" in frame
    assert "fleet_memory_pressure" in frame and "critical" in frame and "ALERTS (1 active)" in frame


def test_render_tenant_panel():
    snap = _snapshot()
    snap["service"] = _service()
    frame = _render(snap)
    assert "TENANTS" in frame and "THROTTLING" in frame and "gold" in frame and "50%" in frame
    assert "TENANTS" not in _render(_snapshot())


def test_render_cost_panel():
    snap = _snapshot()
    snap["service"] = _service(cost=True)
    frame = _render(snap)
    assert "COST" in frame and "TASK-SEC" in frame and "12.50" in frame and "2.0 MB" in frame
    del snap["service"]["tenants"]["gold"]["cost"]
    assert "COST" not in _render(snap)


def test_render_dispatch_panel():
    snap = _snapshot()
    snap["dispatch"] = {"dispatch_utilization": 0.93, "dispatch_capacity_estimate": 410.0,
                        "dispatch_serialize_s": 1.5, "dispatch_send_s": 0.25, "dispatch_lock_wait_s": 0.01,
                        "frames": {"sent": {"task": [100, 2048]}, "recv": {"result": [99, 4096]}}}
    frame = _render(snap)
    assert "DISPATCH  utilization 93%" in frame and "frames sent: task 100" in frame


def test_main_snapshot_offline_mode(capsys):
    assert top.main(["--snapshot", FIXTURE]) == 0
    out = capsys.readouterr().out
    assert ref_top.main(["--snapshot", FIXTURE]) == 0
    assert out.replace("cubed_tpu_torch.top", "cubed_tpu.top", 1) == capsys.readouterr().out
    assert "cubed_tpu_torch.top" in out and "local-0" in out and "TENANTS" in out and "gold" in out
    assert "COST" in out and "184.25" in out and "c-8e3fcfe019" in out and "1620/3240" in out
    assert "fleet_memory_pressure" in out


def test_main_snapshot_missing_file(capsys):
    assert top.main(["--snapshot", "/nonexistent/snap.json"]) == 2
    assert "cannot read snapshot" in capsys.readouterr().err


def test_render_empty_snapshot_is_graceful():
    frame = _render({"ts": time.time(), "metrics": {}, "fleet": {}, "computes": [], "alerts": [], "series": []})
    assert "no live workers" in frame and "(none tracked)" in frame and "(none fired)" in frame


def test_render_eta_formats():
    for v, want in ((None, "-"), (30, "30s"), (90, "1m30s"), (4000, "1h06m"), (-1, "-")):
        assert top._fmt_eta(v) == ref_top._fmt_eta(v) == want


def test_series_rate_uses_trailing_window():
    snap = _snapshot(ts=1000.0)
    assert top._series_rate(snap, "compute_tasks_done", {"compute": "c-live"}, window_s=30.0) == 3.0
    assert top._series_rate(snap, "missing", {}) is None


def test_main_once_renders_from_live_endpoint(capsys):
    rt = TelemetryRuntime(port=0)
    rt.start()
    try:
        rt.sampler.sample_once()
        assert top.main([f"127.0.0.1:{rt.port}", "--once"]) == 0
        out = capsys.readouterr().out
        assert "cubed_tpu_torch.top" in out and "WORKER" in out and "COMPUTES" in out and "ALERTS" in out
    finally:
        rt.stop()


def test_main_unreachable_endpoint_fails_with_hint(capsys):
    assert top.main(["127.0.0.1:9", "--once"]) == 2
    err = capsys.readouterr().err
    assert "cannot reach telemetry endpoint" in err and "CUBED_TPU_TORCH_TELEMETRY_PORT" in err
