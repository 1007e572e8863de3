"""The port's telemetry endpoints (``cubed_tpu_torch/observability/
export.py``): the counterparts of tests/observability/test_export.py. The
exposition cases render the same registry and store contents with both
packages and compare the text line for line once the metric prefix
(``cubed_tpu_`` against ``cubed_tpu_torch_``) and the help text's package
name are set aside; the endpoint cases serve on an ephemeral loopback port
and every server is stopped in a ``finally``. The reference's live scrape
of a distributed fleet becomes a live scrape of a threads-executor compute
and of a device-executor compute (the fleet comes with ROADMAP Queue 1
item 11c)."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json  # noqa: E402
import re  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu_torch as ct  # noqa: E402
from cubed_tpu.observability import export as ref_export  # noqa: E402
from cubed_tpu.observability import metrics as ref_metrics  # noqa: E402
from cubed_tpu.observability import timeseries as ref_ts  # noqa: E402
from cubed_tpu_torch import top  # noqa: E402
from cubed_tpu_torch.observability import export  # noqa: E402
from cubed_tpu_torch.observability import metrics as port_metrics  # noqa: E402
from cubed_tpu_torch.observability import timeseries as port_ts  # noqa: E402
from cubed_tpu_torch.observability.export import (  # noqa: E402
    TELEMETRY_PORT_ENV_VAR,
    TelemetryRuntime,
    escape_label_value,
    prometheus_text,
    resolve_port,
    sanitize_metric_name,
)
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor  # noqa: E402

P = "cubed_tpu_torch_"

_SAMPLE_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\\\|\\\"|\\n)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\\\|\\\"|\\n)*\")*\})?"
    r" -?[0-9.eE+naif]+$"
)


def parse_exposition(text: str) -> dict:
    """Strict parse: every line a comment or a valid sample of a family
    with a TYPE line; {sample name with labels: value}."""
    samples, types = {}, {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            assert kind in ("counter", "gauge", "summary", "histogram"), line
            types[name] = kind
        else:
            assert _SAMPLE_LINE.match(line), f"malformed sample line: {line!r}"
            key, _, value = line.rpartition(" ")
            samples[key] = float(value)
    for key in samples:
        base = key.split("{")[0]
        assert any(base == n or base.startswith(n + "_") or n.startswith(base) for n in types), key
    return samples


def _both_texts(fill) -> str:
    """``fill(metrics module, timeseries module)`` -> (registry, store),
    rendered by both packages; the port's text, after comparing it with the
    reference's modulo the prefix."""
    texts = []
    for e, m, t in ((ref_export, ref_metrics, ref_ts), (export, port_metrics, port_ts)):
        reg, store = fill(m, t)
        texts.append(e.prometheus_text(registry=reg, store=store))
    ref, port = texts
    assert port.replace(P, "cubed_tpu_").replace("cubed_tpu_torch ", "cubed_tpu ") == ref
    return port


def test_metric_name_sanitization():
    for name in ("foo.bar-baz", "a b/c", "9lives", "already_fine:total"):
        assert sanitize_metric_name(name) == ref_export.sanitize_metric_name(name)
    assert sanitize_metric_name("9lives") == "_9lives"


def test_label_value_escaping():
    for v in ('say "hi"', "back\\slash", "two\nlines"):
        assert escape_label_value(v) == ref_export.escape_label_value(v)
    assert escape_label_value("two\nlines") == "two\\nlines"


def test_prometheus_text_help_type_and_values():
    def fill(m, t):
        reg = m.MetricsRegistry()
        reg.counter("tasks_completed").inc(12)
        reg.gauge("queue_depth").set(4)
        reg.histogram("op_wall_clock_s").observe(0.5)
        reg.histogram("op_wall_clock_s").observe(1.5)
        return reg, None

    text = _both_texts(fill)
    samples = parse_exposition(text)
    assert samples[P + "tasks_completed"] == 12 and samples[P + "queue_depth"] == 4
    assert samples[P + "queue_depth_max"] == 4
    assert samples[P + "op_wall_clock_s_count"] == 2 and samples[P + "op_wall_clock_s_sum"] == 2.0
    assert f'{P}op_wall_clock_s{{quantile="0.99"}}' in samples
    assert f"# TYPE {P}tasks_completed counter" in text and f"# TYPE {P}op_wall_clock_s summary" in text


def test_prometheus_text_sanitizes_weird_names_and_labels():
    def fill(m, t):
        reg = m.MetricsRegistry()
        reg.counter("weird.name-with/stuff").inc(1)
        store = t.TimeSeriesStore()
        store.record("worker_rss_bytes", 7, ts=1.0, labels={"worker": 'host:1 "quoted"\nnewline'})
        return reg, store

    samples = parse_exposition(_both_texts(fill))
    assert samples[P + "weird_name_with_stuff"] == 1
    labelled = [k for k in samples if k.startswith(P + "worker_rss_bytes{")]
    assert labelled and '\\"quoted\\"' in labelled[0] and "\\n" in labelled[0]


def test_scrape_twice_counters_are_monotonic():
    reg = port_metrics.MetricsRegistry()
    reg.counter("tasks_completed").inc(3)
    reg.counter("task_retries").inc(1)
    first = parse_exposition(prometheus_text(registry=reg))
    reg.counter("tasks_completed").inc(5)
    second = parse_exposition(prometheus_text(registry=reg))
    for name, kind in reg.kinds().items():
        if kind == "counter":
            assert second[P + name] >= first[P + name]
    assert second[P + "tasks_completed"] == 8


def test_labelled_store_series_export_latest_sample():
    def fill(m, t):
        store = t.TimeSeriesStore()
        store.record("worker_outstanding", 1, ts=1.0, labels={"worker": "w0"})
        store.record("worker_outstanding", 4, ts=2.0, labels={"worker": "w0"})
        store.record("compute_tasks_done", 9, ts=2.0, labels={"compute": "c-1"})
        return m.MetricsRegistry(), store

    samples = parse_exposition(_both_texts(fill))
    assert samples[f'{P}worker_outstanding{{worker="w0"}}'] == 4
    assert samples[f'{P}compute_tasks_done{{compute="c-1"}}'] == 9


def test_fleet_aggregates_export_and_families_stay_unique():
    def fill(m, t):
        reg = m.MetricsRegistry()
        reg.gauge("worker_rss_bytes").set(111)
        reg.counter("tasks_completed").inc(5)
        reg.histogram("op_wall_clock_s").observe(0.5)
        store = t.TimeSeriesStore()
        for name, v, labels in (("fleet_pressured_fraction", 0.5, None), ("fleet_workers_live", 4, None),
                                ("tasks_completed", 5, None), ("op_wall_clock_s_count", 1, None),
                                ("worker_rss_bytes", 222, {"worker": "w0"})):
            store.record(name, v, ts=1.0, labels=labels)
        return reg, store

    text = _both_texts(fill)
    samples = parse_exposition(text)
    assert samples[P + "fleet_pressured_fraction"] == 0.5 and samples[P + "fleet_workers_live"] == 4
    assert samples[P + "worker_rss_bytes"] == 111 and samples[f'{P}worker_rss_bytes{{worker="w0"}}'] == 222
    type_lines = [ln for ln in text.splitlines() if ln.startswith("# TYPE ")]
    assert len(type_lines) == len(set(type_lines))
    assert not any("op_wall_clock_s_count" in ln for ln in type_lines)


def test_resolve_port_precedence(monkeypatch):
    assert TELEMETRY_PORT_ENV_VAR == "CUBED_TPU_TORCH_TELEMETRY_PORT"
    monkeypatch.delenv(TELEMETRY_PORT_ENV_VAR, raising=False)
    assert resolve_port(None) is None
    spec = ct.Spec(telemetry_port=9100)
    assert resolve_port(spec) == 9100
    monkeypatch.setenv(TELEMETRY_PORT_ENV_VAR, "9200")
    assert resolve_port(spec) == 9200
    for off in ("off", ""):
        monkeypatch.setenv(TELEMETRY_PORT_ENV_VAR, off)
        assert resolve_port(spec) is None
    for bad in ("not-a-port", "70000"):
        monkeypatch.setenv(TELEMETRY_PORT_ENV_VAR, bad)
        with pytest.raises(ValueError):
            resolve_port(spec)


def test_spec_validates_telemetry_port():
    assert ct.Spec(telemetry_port=0).telemetry_port == 0
    assert ct.Spec().telemetry_port is None
    for bad in (-1, 99999):
        with pytest.raises(ValueError):
            ct.Spec(telemetry_port=bad)
    with pytest.raises(ValueError):
        ct.Spec(run_history=3)
    assert ct.Spec(dispatch_profile=1).dispatch_profile is True
    assert ct.Spec(run_history="/x").run_history == "/x"


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


@pytest.fixture
def runtime():
    rt = TelemetryRuntime(port=0)
    rt.start()
    try:
        yield rt
    finally:
        rt.stop()


def test_endpoints_serve_metrics_healthz_snapshot(runtime):
    runtime.sampler.sample_once()
    code, body, headers = _get(runtime.port, "/metrics")
    assert code == 200 and headers["Content-Type"].startswith("text/plain")
    parse_exposition(body)
    assert P + "telemetry_samples" in body
    code, body, _ = _get(runtime.port, "/healthz")
    health = json.loads(body)
    assert code == 200 and health["status"] in ("ok", "degraded") and health["last_sample_age_s"] is not None
    assert set(health) == set(ref_export.TelemetryRuntime(port=0).health()[0])
    code, body, _ = _get(runtime.port, "/snapshot.json")
    snap = json.loads(body)
    assert code == 200 and set(snap) == set(ref_export.TelemetryRuntime(port=0).snapshot())
    assert _get(runtime.port, "/nope")[0] == 404


def test_healthz_reports_stale_sampler_as_503():
    rt = TelemetryRuntime(port=0)
    rt.start()
    try:
        rt.sampler.stop()
        rt.sampler.last_sample_ts = time.time() - 60.0
        code, body, _ = _get(rt.port, "/healthz")
        assert code == 503 and json.loads(body)["status"] == "stale"
    finally:
        rt.stop()


def test_bind_host_defaults_to_loopback_and_env_knob(monkeypatch):
    monkeypatch.delenv(export.TELEMETRY_HOST_ENV_VAR, raising=False)
    for host in (None, "127.0.0.1"):
        if host:
            monkeypatch.setenv(export.TELEMETRY_HOST_ENV_VAR, host)
        rt = TelemetryRuntime(port=0)
        rt.start()
        try:
            assert rt.server.server_address[0] == "127.0.0.1"
            assert _get(rt.port, "/healthz")[0] in (200, 503)
        finally:
            rt.stop()


def test_ensure_started_is_idempotent_singleton():
    export.shutdown()
    try:
        rt1 = export.ensure_started(0)
        assert export.ensure_started(0) is rt1 and export.get_runtime() is rt1
        assert export.ensure_started(12345) is rt1
    finally:
        export.shutdown()
    assert export.get_runtime() is None


@pytest.mark.parametrize("executor", ["threads", "device"])
def test_live_compute_serves_metrics_healthz_and_top(tmp_path, executor):
    """Telemetry armed by the Spec, scraped while a compute runs and after
    it: valid exposition, progress to tasks_total, and a top frame."""
    export.shutdown()
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", telemetry_port=0)
    an = np.arange(64.0).reshape(8, 8)
    a = ct.from_array(an, chunks=(2, 2), spec=spec)

    def slow(x):
        time.sleep(0.02)
        return x + 1.0

    r = ct.map_blocks(slow, a, dtype=np.float64)
    ex = AsyncPythonDagExecutor() if executor == "threads" else CudaExecutor()
    box: dict = {}

    def compute():
        try:
            box["value"] = np.asarray(r.compute(executor=ex))
        except BaseException as e:
            box["error"] = e

    t = threading.Thread(target=compute)
    try:
        t.start()
        deadline = time.monotonic() + 30
        rt = None
        while rt is None and time.monotonic() < deadline:
            rt = export.get_runtime()
            time.sleep(0.01)
        assert rt is not None, "telemetry never armed"
        code, body, _ = _get(rt.port, "/metrics")
        assert code == 200
        parse_exposition(body)
        t.join(timeout=120)
        assert not t.is_alive() and "error" not in box, box.get("error")
        np.testing.assert_array_equal(box["value"], an + 1.0)
        rt.sampler.sample_once()
        samples = parse_exposition(_get(rt.port, "/metrics")[1])
        assert samples.get(P + "tasks_completed", 0) >= 16
        assert json.loads(_get(rt.port, "/healthz")[1])["workers_live"] == 0
        snap = json.loads(_get(rt.port, "/snapshot.json")[1])
        assert any(c["status"] == "succeeded" and c["tasks_done"] == c["tasks_total"] == 17
                   for c in snap["computes"]), snap["computes"]
        frame = top.render(top.fetch_snapshot(f"127.0.0.1:{rt.port}"))
        assert "succeeded" in frame and "17/17" in frame
    finally:
        t.join(timeout=120)
        export.shutdown()
