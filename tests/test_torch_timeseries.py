"""The port's time-series store, telemetry sampler and compute progress
(``cubed_tpu_torch/observability/timeseries.py``): the counterparts of
tests/observability/test_timeseries.py. The store cases apply the same
writes to both packages' stores and compare every read; the sampler cases
give both samplers the same registry contents and compare the stores they
fill. The fleet hooks are driven with the reference test's stand-in
coordinator (the port's fleet comes with ROADMAP Queue 1 item 11c); the
progress callback folds the device executor's one-event-per-op task counts
to ``tasks_total`` as the reference's does ``JaxExecutor``'s. Every sampler
thread is stopped in a ``finally``."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import gc  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.observability import metrics as ref_metrics  # noqa: E402
from cubed_tpu.observability import timeseries as ref_ts  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.core.plan import Dag  # noqa: E402
from cubed_tpu_torch.observability import metrics as port_metrics  # noqa: E402
from cubed_tpu_torch.observability import timeseries as port_ts  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402

TS = (ref_ts, port_ts)


def _same(fn):
    """``fn(timeseries module)`` in both packages; the port's result."""
    ref, port = (fn(m) for m in TS)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------


def test_store_record_latest_and_window():
    def run(m):
        s = m.TimeSeriesStore()
        for i in range(5):
            s.record("m", i, ts=1000.0 + i)
        return s.latest("m"), s.window("m", 2.5, now=1004.0), s.window("missing", 10, now=1000.0), s.latest("x")

    latest, pts, missing, none = _same(run)
    assert latest == 4 and [v for _, v in pts] == [2, 3, 4] and missing == [] and none is None


def test_store_labels_are_distinct_series():
    def run(m):
        s = m.TimeSeriesStore()
        s.record("rss", 1, ts=1.0, labels={"worker": "a"})
        s.record("rss", 2, ts=1.0, labels={"worker": "b"})
        return s.latest("rss", labels={"worker": "a"}), s.latest("rss", labels={"worker": "b"}), s.labelled_latest()

    a, b, labelled = _same(run)
    assert (a, b) == (1, 2) and len(labelled) == 2


def test_store_ring_is_bounded_per_series():
    def run(m):
        s = m.TimeSeriesStore(capacity=10)
        for i in range(100):
            s.record("m", i, ts=float(i))
        return s.window("m", 1e9, now=100.0)

    pts = _same(run)
    assert len(pts) == 10 and pts[-1][1] == 99


def test_store_series_cap_evicts_stalest_for_new():
    reg = port_metrics.get_registry()
    before = reg.snapshot()

    def run(m):
        s = m.TimeSeriesStore(max_series=3)
        for i in range(6):
            s.record("m", 1, ts=float(i), labels={"worker": f"w{i}"})
        return s.series(), s.series_evicted

    series, evicted = _same(run)
    assert {labels["worker"] for _, labels, _ in series} == {"w3", "w4", "w5"} and evicted == 3
    assert reg.snapshot_delta(before).get("timeseries_series_evicted", 0) >= 3


def test_store_rate_from_cumulative_counter():
    def run(m):
        s = m.TimeSeriesStore()
        s.record("c", 10, ts=100.0)
        s.record("c", 30, ts=110.0)
        out = [s.rate("c", 60, now=110.0)]
        s.record("c", 0, ts=120.0)
        out.append(s.rate("c", 60, now=120.0))
        s2 = m.TimeSeriesStore()
        s2.record("c", 1, ts=1.0)
        return out + [s2.rate("c", 60, now=1.0)]

    assert _same(run) == [2.0, 0.0, None]


def test_store_ignores_non_numeric_values():
    def run(m):
        s = m.TimeSeriesStore()
        s.record("m", "not-a-number", ts=1.0)
        s.record("m", None, ts=1.0)
        s.record("m", True, ts=2.0)
        return s.latest("m"), s.window("m", 10, now=2.0)

    assert _same(run) == (1, [(2.0, 1.0)])


def test_store_to_dict_windows_and_bounds():
    def run(m):
        s = m.TimeSeriesStore()
        for i in range(50):
            s.record("m", i, ts=1000.0 + i, labels={"worker": "a"})
        return s.to_dict(window_s=20.0, max_points=5, now=1049.0)

    rows = _same(run)
    assert len(rows) == 1 and rows[0]["labels"] == {"worker": "a"} and len(rows[0]["points"]) == 5
    assert rows[0]["points"][-1][1] == 49


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def test_sampler_records_registry_counters_gauges_histograms(monkeypatch):
    out = []
    for m, metrics_mod in ((ref_ts, ref_metrics), (port_ts, port_metrics)):
        reg = metrics_mod.MetricsRegistry()
        reg.counter("tasks_completed").inc(7)
        reg.gauge("queue_depth").set(3)
        reg.histogram("op_wall_clock_s").observe(0.5)
        monkeypatch.setattr(m, "get_registry", lambda reg=reg: reg)
        store = m.TimeSeriesStore()
        sampler = m.TelemetrySampler(store)
        sampler.sample_once(now=100.0)
        assert reg.snapshot().get("telemetry_samples") == 1 and sampler.last_sample_ts == 100.0
        out.append(sorted((n, v) for n, _, v in store.latest_series()))
    assert out[1] == out[0]
    got = dict(out[1])
    assert got["tasks_completed"] == 7 and got["queue_depth"] == 3
    assert got["op_wall_clock_s_count"] == 1 and got["op_wall_clock_s_sum"] == 0.5
    assert got["op_wall_clock_s_p50"] == 0.5


class _FakeCoordinator:
    """The coordinator surface the sampler and fleet_view read."""

    def __init__(self):
        self._closed = threading.Event()

    def load_view(self):
        return [{"name": "w0", "draining": False, "pressured": True, "connected": True, "outstanding": 2,
                 "nthreads": 1},
                {"name": "w1", "draining": False, "pressured": False, "connected": True, "outstanding": 1,
                 "nthreads": 1}]

    def stats_snapshot(self):
        return {"workers": {
            "w0": {"alive": True, "connected": True, "pressured": True, "rss": 1024, "peer_cache": {"bytes": 10},
                   "metrics": {"worker_tasks_executed": 5}},
            "w1": {"alive": True, "connected": True, "pressured": False, "rss": 2048, "peer_cache": None,
                   "metrics": None}}}


def test_sampler_records_fleet_series_per_worker_and_aggregate():
    """The hook 11c's coordinator calls: a registered fleet's rows become
    per-worker and aggregate series, as the reference's do."""
    coord = _FakeCoordinator()
    port_ts.register_fleet(coord)
    try:
        store = port_ts.TimeSeriesStore()
        port_ts.TelemetrySampler(store).sample_once(now=50.0)
        assert store.latest("fleet_workers_live") == 2
        assert store.latest("fleet_workers_pressured") == 1
        assert store.latest("fleet_pressured_fraction") == 0.5
        assert store.latest("fleet_queue_depth") == 3
        assert store.latest("worker_rss_bytes", labels={"worker": "w0"}) == 1024
        assert store.latest("worker_outstanding", labels={"worker": "w1"}) == 1
        assert store.latest("fleet_worker_tasks_executed", labels={"worker": "w0"}) == 5
        view = port_ts.fleet_view()
        assert view["workers_live"] == 2 and view["workers_pressured"] == 1 and "w0" in view["workers"]
    finally:
        port_ts.unregister_fleet(coord)
    assert port_ts.live_fleets() == []


def test_fleet_registration_is_weak_and_close_aware():
    coord = _FakeCoordinator()
    port_ts.register_fleet(coord)
    assert coord in port_ts.live_fleets()
    coord._closed.set()
    assert coord not in port_ts.live_fleets()
    port_ts.unregister_fleet(coord)
    coord2 = _FakeCoordinator()
    port_ts.register_fleet(coord2)
    del coord2
    gc.collect()
    assert port_ts.live_fleets() == []


def test_fleet_aggregates_decay_to_zero_after_fleet_closes():
    coord = _FakeCoordinator()
    port_ts.register_fleet(coord)
    store = port_ts.TimeSeriesStore()
    sampler = port_ts.TelemetrySampler(store)
    try:
        sampler.sample_once(now=50.0)
        assert store.latest("fleet_pressured_fraction") == 0.5
    finally:
        coord._closed.set()
        port_ts.unregister_fleet(coord)
    sampler.sample_once(now=51.0)
    assert store.latest("fleet_pressured_fraction") == 0.0
    assert store.latest("fleet_workers_live") == 0


# ---------------------------------------------------------------------------
# compute progress
# ---------------------------------------------------------------------------


class _Event:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class _Op:
    def __init__(self, n):
        self.num_tasks = n


def _fake_dag(num_tasks):
    dag = Dag()
    dag.add_node("op-a", type="op", primitive_op=_Op(num_tasks))
    return dag


def test_compute_progress_callback_tracks_done_total_and_status():
    with port_ts._computes_lock:
        port_ts._computes.clear()
    cb = port_ts.ComputeProgressCallback()
    cb.on_compute_start(_Event(compute_id="c-test", dag=_fake_dag(3)))
    row = port_ts.compute_progress()[-1]
    assert (row["compute_id"], row["tasks_total"], row["status"]) == ("c-test", 3, "running")
    for _ in range(2):
        cb.on_task_end(_Event())
    cb.on_task_end(_Event(num_tasks=5))
    assert port_ts.compute_progress()[-1]["tasks_done"] == 7
    cb.on_compute_end(_Event(error=None))
    row = port_ts.compute_progress()[-1]
    assert row["status"] == "succeeded" and row["ended_at"] is not None
    cb2 = port_ts.ComputeProgressCallback()
    cb2.on_compute_start(_Event(compute_id="c-fail", dag=_fake_dag(1)))
    cb2.on_compute_end(_Event(error=RuntimeError("boom")))
    assert port_ts.compute_progress()[-1]["status"] == "failed"


def test_compute_progress_feeds_sampler_series():
    with port_ts._computes_lock:
        port_ts._computes.clear()
    cb = port_ts.ComputeProgressCallback()
    cb.on_compute_start(_Event(compute_id="c-live", dag=_fake_dag(10)))
    cb.on_task_end(_Event())
    store = port_ts.TimeSeriesStore()
    port_ts.TelemetrySampler(store).sample_once(now=10.0)
    assert store.latest("compute_tasks_done", labels={"compute": "c-live"}) == 1
    assert store.latest("compute_tasks_total", labels={"compute": "c-live"}) == 10
    cb.on_compute_end(_Event(error=None))
    port_ts.TelemetrySampler(store).sample_once(now=11.0)
    assert len(store.window("compute_tasks_done", 100, labels={"compute": "c-live"}, now=11.0)) == 1


@pytest.mark.parametrize("executor", ["device", "sequential"])
def test_compute_progress_folds_every_executor_to_its_total(tmp_path, executor):
    """A real compute: tasks done equals tasks total at the end, on the
    device executor (one event per op carrying ``num_tasks``) as on
    ``JaxExecutor``, and on the sequential executors of both packages."""
    rows = []
    for m, pkg, xp, ex in ((ref_ts, cubed_tpu, rxp, JaxExecutor() if executor == "device" else None),
                           (port_ts, ct, pxp, CudaExecutor() if executor == "device" else None)):
        spec = pkg.Spec(work_dir=str(tmp_path / pkg.__name__), allowed_mem="500MB")
        a, b = [pkg.from_array(np.random.default_rng(i).random((12, 10)), chunks=(4, 5), spec=spec)
                for i in range(2)]
        cb = m.ComputeProgressCallback()
        xp.mean(a[1:] * b[1:]).compute(executor=ex, callbacks=[cb])
        rows.append(m.compute_progress()[-1])
    assert rows[1]["tasks_done"] == rows[1]["tasks_total"] == rows[0]["tasks_total"] == rows[0]["tasks_done"]
    assert rows[1]["status"] == rows[0]["status"] == "succeeded"


def test_sampler_thread_lifecycle():
    store = port_ts.TimeSeriesStore()
    sampler = port_ts.TelemetrySampler(store, interval_s=0.05)
    for _ in range(2):  # a stopped sampler restarts cleanly
        sampler.last_sample_ts = None
        sampler.start()
        try:
            deadline = time.monotonic() + 5.0
            while sampler.last_sample_ts is None and time.monotonic() < deadline:
                time.sleep(0.02)
            assert sampler.last_sample_ts is not None and sampler.alive
            assert [t.name for t in threading.enumerate()].count("telemetry-sampler") == 1
        finally:
            sampler.stop()
        assert not sampler.alive
