"""The port's metrics registry, byte accounting and structured logs
(``cubed_tpu_torch/observability/{metrics,accounting,logs}.py``): the
counterparts of tests/observability/test_metrics.py and test_logs.py, and
parity with the JAX package's registry: the same increments give equal
``snapshot``, ``snapshot_delta`` and ``merge_snapshots``."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json  # noqa: E402
import logging  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as xp  # noqa: E402
from cubed_tpu.observability import metrics as reference_metrics  # noqa: E402
from cubed_tpu_torch.observability import clock, logs  # noqa: E402
from cubed_tpu_torch.observability import metrics as port_metrics  # noqa: E402
from cubed_tpu_torch.observability.accounting import (  # noqa: E402
    record_bytes_read,
    record_bytes_written,
    store_totals,
    task_scope,
)
from cubed_tpu_torch.observability.metrics import (  # noqa: E402
    RESERVOIR_SIZE,
    MetricsRegistry,
    get_registry,
    merge_snapshots,
)


def test_counter_gauge_histogram_snapshot():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set(7)
    reg.gauge("g").set(3)
    reg.histogram("h").observe(1.0)
    reg.histogram("h").observe(3.0)
    snap = reg.snapshot()
    assert snap["c"] == 5
    assert snap["g"] == 3 and snap["g_max"] == 7
    assert snap["h"]["count"] == 2 and snap["h"]["sum"] == 4.0
    assert snap["h"]["mean"] == 2.0 and snap["h"]["min"] == 1.0


def test_snapshot_delta_windows_counters_and_high_water_marks():
    reg = MetricsRegistry()
    reg.counter("c").inc(10)
    reg.gauge("g").set(5)
    reg.histogram("h").observe(2.0)
    before = reg.snapshot()
    reg.counter("c").inc(3)
    reg.gauge("g").set(9)
    reg.histogram("h").observe(4.0)
    delta = reg.snapshot_delta(before)
    assert delta["c"] == 3
    assert "g" not in delta  # an instantaneous value is not per-window
    assert delta["g_max"] == 9  # this window raised the high-water mark
    assert delta["h"]["count"] == 1 and delta["h"]["sum"] == 4.0
    assert "min" not in delta["h"] and "max" not in delta["h"]
    before2 = reg.snapshot()
    reg.gauge("g").set(2)
    assert "g_max" not in reg.snapshot_delta(before2)


def test_merge_snapshots_adds_counters_folds_histograms_maxes_gauges():
    a = {"c": 2, "g": 3, "g_max": 5, "h": {"count": 1, "sum": 1.0, "min": 1.0, "max": 1.0}}
    b = {"c": 3, "g": 9, "g_max": 9, "h": {"count": 2, "sum": 7.0, "min": 2.0, "max": 5.0}}
    m = merge_snapshots(a, b)
    assert m["c"] == 5
    assert m["g"] == 9 and m["g_max"] == 9
    assert m["h"]["count"] == 3 and m["h"]["sum"] == 8.0
    assert m["h"]["min"] == 1.0 and m["h"]["max"] == 5.0


def test_report_renders_all_metrics():
    reg = MetricsRegistry()
    reg.counter("tasks_completed").inc(12)
    reg.histogram("op_wall_clock_s").observe(0.25)
    text = reg.report()
    assert "tasks_completed" in text and "12" in text
    assert "op_wall_clock_s" in text and "count=1" in text
    assert MetricsRegistry().report() == "(no metrics recorded)"


def test_reset_clears_everything():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.reset()
    assert reg.snapshot() == {}


def test_kinds_names_every_metric():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.gauge("g").set(1)
    reg.histogram("h").observe(1.0)
    assert reg.kinds() == {"c": "counter", "g": "gauge", "h": "histogram"}


def test_histogram_quantiles_exact_under_reservoir_size():
    h = MetricsRegistry().histogram("lat")
    for i in range(100):
        h.observe(float(i))
    s = h.summary()
    assert abs(s["p50"] - 49.5) <= 1
    assert abs(s["p95"] - 94.0) <= 1
    assert abs(s["p99"] - 98.0) <= 1


def test_histogram_quantiles_estimate_long_streams_bounded():
    h = MetricsRegistry().histogram("lat")
    for i in range(20 * RESERVOIR_SIZE):
        h.observe(float(i % 1000))
    assert len(h._reservoir) == RESERVOIR_SIZE
    s = h.summary()
    assert 350 <= s["p50"] <= 650
    assert 850 <= s["p95"] <= 1000
    assert 900 <= s["p99"] <= 1000
    assert s["count"] == 20 * RESERVOIR_SIZE


def test_histogram_quantiles_empty_and_single():
    reg = MetricsRegistry()
    assert reg.histogram("h").quantiles() == {}
    assert reg.snapshot() == {"h": {"count": 0, "sum": 0.0, "min": None, "max": None, "mean": None}}
    reg.histogram("h").observe(3.5)
    s = reg.snapshot()["h"]
    assert s["p50"] == s["p95"] == s["p99"] == 3.5


def test_histogram_quantiles_deterministic_per_name():
    a, b = MetricsRegistry(), MetricsRegistry()
    for i in range(5000):
        a.histogram("h").observe(float(i))
        b.histogram("h").observe(float(i))
    assert a.histogram("h")._reservoir == b.histogram("h")._reservoir


def test_quantiles_stay_out_of_windowed_deltas():
    reg = MetricsRegistry()
    reg.histogram("h").observe(1.0)
    before = reg.snapshot()
    reg.histogram("h").observe(2.0)
    delta = reg.snapshot_delta(before)
    assert "p50" not in delta["h"] and "p99" not in delta["h"]


def test_snapshot_delta_counts_dropped_gauges():
    reg = MetricsRegistry()
    reg.counter("c").inc(1)
    reg.gauge("g1").set(5)
    reg.gauge("g2").set(7)
    delta = reg.snapshot_delta(reg.snapshot())
    # counted for the NEXT window: this delta is not perturbed by its own
    # bookkeeping
    assert "gauges_dropped_in_delta" not in delta
    assert reg.snapshot()["gauges_dropped_in_delta"] == 2
    delta2 = reg.snapshot_delta(reg.snapshot())
    assert reg.snapshot()["gauges_dropped_in_delta"] == 4
    assert "g1" not in delta2 and "g2" not in delta2


def test_snapshot_delta_logs_dropped_gauge_once_per_key(caplog):
    reg = MetricsRegistry()
    reg.gauge("queue_depth").set(3)
    with caplog.at_level(logging.INFO, logger="cubed_tpu_torch.observability.metrics"):
        reg.snapshot_delta(reg.snapshot())
        reg.snapshot_delta(reg.snapshot())
    notes = [r for r in caplog.records
             if "queue_depth" in r.getMessage() and "dropped from deltas" in r.getMessage()]
    assert len(notes) == 1


def test_get_registry_is_the_ports_own():
    assert get_registry() is not reference_metrics.get_registry()
    assert get_registry() is get_registry()


def _increments(module):
    """One sequence of counter, gauge and histogram updates on a fresh
    registry of *module*; returns its snapshots and delta."""
    reg = module.MetricsRegistry()
    reg.counter("tasks_completed").inc(3)
    reg.gauge("queue_depth").set(4)
    for v in (0.5, 0.25, 2.0):
        reg.histogram("op_wall_clock_s").observe(v)
    before = reg.snapshot()
    reg.counter("tasks_completed").inc(7)
    reg.counter("bytes_written").inc(4096)
    reg.gauge("queue_depth").set(9)
    reg.gauge("queue_depth").set(1)
    for i in range(2 * module.RESERVOIR_SIZE):
        reg.histogram("op_wall_clock_s").observe(float(i % 97))
    after = reg.snapshot()
    delta = reg.snapshot_delta(before)
    return before, after, delta, reg.snapshot()


def test_snapshots_deltas_and_merges_equal_the_reference_registrys():
    ours, theirs = _increments(port_metrics), _increments(reference_metrics)
    assert ours == theirs
    before, after, delta, _ = ours
    assert merge_snapshots(before, after) == reference_metrics.merge_snapshots(before, after)
    assert merge_snapshots(after, delta) == reference_metrics.merge_snapshots(after, delta)


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------


def test_task_scope_captures_bytes_and_registry_untouched():
    before = get_registry().snapshot()
    with task_scope() as scope:
        record_bytes_read("s1", 100)
        record_bytes_written("s1", 50)
    assert scope.bytes_read == 100 and scope.chunks_read == 1
    assert scope.bytes_written == 50 and scope.chunks_written == 1
    delta = get_registry().snapshot_delta(before)
    assert delta.get("bytes_read", 0) == 0
    assert delta.get("bytes_written", 0) == 0


def test_unscoped_io_goes_to_registry():
    before = get_registry().snapshot()
    record_bytes_read("s2", 30)
    record_bytes_written("s2", 70)
    delta = get_registry().snapshot_delta(before)
    assert delta["bytes_read"] >= 30
    assert delta["bytes_written"] >= 70


def test_nested_scopes_attribute_to_innermost_only():
    with task_scope() as outer:
        record_bytes_read("s", 10)
        with task_scope() as inner:
            record_bytes_read("s", 5)
        assert inner.bytes_read == 5
        record_bytes_read("s", 2)
    assert outer.bytes_read == 12


def test_zarr_store_read_write_accounted(tmp_path):
    from cubed_tpu_torch.storage.store import open_zarr_array

    store = str(tmp_path / "a.zarr")
    arr = open_zarr_array(store, mode="w", shape=(4, 4), dtype=np.float64, chunks=(2, 2))
    before = get_registry().snapshot()
    arr[:, :] = np.arange(16.0).reshape(4, 4)
    np.testing.assert_array_equal(arr[:, :], np.arange(16.0).reshape(4, 4))
    delta = get_registry().snapshot_delta(before)
    # 4 chunks x 2x2 f64 = 128 bytes each way (uncompressed store); the
    # metadata document is not a chunk
    assert delta["bytes_written"] >= 128 and delta["bytes_read"] >= 128
    assert delta["chunks_written"] >= 4 and delta["chunks_read"] >= 4
    totals = store_totals()
    entry = totals.get(store) or totals.get("<other>")
    assert entry["bytes_written"] >= 128 and entry["bytes_read"] >= 128


def test_zarr_store_counts_equal_the_reference_stores(tmp_path):
    """The same writes and reads, partial chunks and ragged edges included,
    move the same bytes and chunks, as stored, in both packages' stores."""
    from cubed_tpu.observability.accounting import task_scope as reference_task_scope
    from cubed_tpu.storage.store import open_zarr_array as reference_open
    from cubed_tpu_torch.storage.store import open_zarr_array

    counts = []
    for label, opener, scope_cls in (("ref", reference_open, reference_task_scope),
                                     ("port", open_zarr_array, task_scope)):
        arr = opener(str(tmp_path / f"{label}.zarr"), mode="w", shape=(7, 5), dtype=np.float64, chunks=(3, 2))
        with scope_cls() as scope:
            arr[:, :] = np.arange(35.0).reshape(7, 5)
            arr[1:4, 1:3] = -1.0
            out = arr[2:7, ::2]
        counts.append((scope.bytes_read, scope.bytes_written, scope.chunks_read, scope.chunks_written, out))
    (*ref, ref_out), (*port, port_out) = counts
    assert port == ref
    np.testing.assert_array_equal(port_out, ref_out)


# ---------------------------------------------------------------------------
# structured logs
# ---------------------------------------------------------------------------


def test_compute_scope_binds_contextvar_and_env(monkeypatch):
    monkeypatch.delenv(logs.COMPUTE_ID_ENV_VAR, raising=False)
    assert logs.COMPUTE_ID_ENV_VAR == "CUBED_TPU_TORCH_COMPUTE_ID"
    assert logs.current_compute_id() is None
    with logs.compute_scope("c-123", export_env=True):
        assert logs.current_compute_id() == "c-123"
        assert os.environ[logs.COMPUTE_ID_ENV_VAR] == "c-123"
        with logs.compute_scope("c-nested"):
            assert logs.current_compute_id() == "c-nested"
        assert logs.current_compute_id() == "c-123"
    assert logs.current_compute_id() is None
    assert logs.COMPUTE_ID_ENV_VAR not in os.environ


def test_env_fallback_is_how_child_processes_inherit(monkeypatch):
    monkeypatch.setenv(logs.COMPUTE_ID_ENV_VAR, "c-from-env")
    assert logs.current_compute_id() == "c-from-env"


def test_task_context_binds_op_and_chunk():
    with logs.task_context(op="op-a", chunk="1.2", compute_id="c-t"):
        assert logs.op_var.get() == "op-a"
        assert logs.chunk_var.get() == "1.2"
        assert logs.current_compute_id() == "c-t"
    assert logs.op_var.get() is None and logs.chunk_var.get() is None


def test_context_filter_injects_fields():
    record = logging.LogRecord("cubed_tpu_torch.x", logging.WARNING, __file__, 1, "msg", (), None)
    with logs.task_context(op="op-b", chunk="0.0", compute_id="c-f"):
        assert logs.ContextFilter().filter(record) is True
    assert (record.compute_id, record.op, record.chunk) == ("c-f", "op-b", "0.0")


def test_structured_formatter_emits_parseable_json():
    record = logging.LogRecord("cubed_tpu_torch.y", logging.ERROR, __file__, 1, "it %s", ("broke",), None)
    with logs.task_context(op="op-c", chunk="3", compute_id="c-j"):
        line = logs.StructuredFormatter().format(record)
    doc = json.loads(line)
    assert doc["message"] == "it broke"
    assert doc["level"] == "ERROR"
    assert (doc["compute_id"], doc["op"], doc["chunk"]) == ("c-j", "op-c", "3")
    assert doc["pid"] == os.getpid()


def test_ring_handler_captures_correlated_records():
    ring = logs.install(capacity=500)
    with logs.task_context(op="op-ring", chunk="7", compute_id="c-ring"):
        logging.getLogger("cubed_tpu_torch.tests.ring").warning("ring me")
    recs = [r for r in ring.records() if r["message"] == "ring me"]
    assert recs and recs[-1]["compute_id"] == "c-ring" and recs[-1]["op"] == "op-ring"
    assert logs.recent_records(5)


def test_ring_is_bounded():
    ring = logs.RecentRecordsHandler(capacity=3)
    logger = logging.Logger("standalone")
    logger.addHandler(ring)
    for i in range(10):
        logger.warning("m%d", i)
    assert [r["message"] for r in ring.records()] == ["m7", "m8", "m9"]


def test_compute_log_lines_carry_the_compute_id(tmp_path):
    """A record emitted from a task body during a real compute carries that
    compute's id and the task's op and chunk."""
    ring = logs.install()
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    an = np.arange(16.0).reshape(4, 4)
    a = ct.from_array(an, chunks=(2, 2), spec=spec)
    probe = logging.getLogger("cubed_tpu_torch.tests.probe")

    def noisy(x):
        probe.warning("inside a task")
        return x + 1

    result = ct.map_blocks(noisy, xp.add(a, 1), dtype=a.dtype).compute()
    np.testing.assert_allclose(result, an + 2)
    # the function also runs once at plan time, on meta tensors, to learn
    # whether it batches: that record belongs to no compute and no task
    recs = [r for r in ring.records() if r["message"] == "inside a task" and r["chunk"] != "-"]
    assert len(recs) == 4  # one per chunk
    assert all(r["compute_id"].startswith("c-") for r in recs)
    assert len({r["compute_id"] for r in recs}) == 1
    assert logs.current_compute_id() is None


def test_clock_skew_from_env(monkeypatch):
    monkeypatch.setenv(clock.SKEW_ENV_VAR, '{"w1": 2.5}')
    try:
        assert clock.configure_from_env("w1") == 2.5
        assert abs(clock.now() - 2.5 - time.time()) < 0.5
        monkeypatch.setenv(clock.SKEW_ENV_VAR, "[1]")
        with pytest.raises(ValueError):
            clock.skew_for("w1")
    finally:
        clock.set_skew(0.0)
    assert clock.get_skew() == 0.0
