"""The port's TCP fleet held against the JAX package, on one module-scoped
fleet of two local workers (two task slots each): values against the JAX
package's sequential executor (a lambda, a closure and a partial among the
shipped functions), op blobs shipped once per worker across computes,
generation parallelism, remote errors and an undeserializable blob, the
dataflow scheduler bit for bit against the sequential executor, and the
workers' heartbeats folding their counters into the coordinator. Cheap
units: the zero-worker diagnostics, the heartbeat delta. The autoscaler's
options, the control log and the compute service each run a compute. Counterpart of tests/runtime/test_distributed.py (its fault and
lifecycle cases are in test_torch_distributed_faults.py)."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import functools  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as xp  # noqa: E402
from cubed_tpu.runtime.distributed import heartbeat_metrics_delta as ref_heartbeat_metrics_delta  # noqa: E402
from cubed_tpu_torch.observability.metrics import MetricsRegistry, get_registry  # noqa: E402
from cubed_tpu_torch.runtime.distributed import (  # noqa: E402
    HEARTBEAT_DELTA_MAX_KEYS,
    Coordinator,
    NoWorkersError,
    RemoteTaskError,
    heartbeat_metrics_delta,
)
from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor  # noqa: E402

from . import _torch_fleet  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clean_process():
    before = _torch_fleet.snapshot()
    _torch_fleet.reset_process_state()
    yield
    _torch_fleet.reset_process_state()
    assert _torch_fleet.leftovers(before) == {"children": [], "listening": []}


@pytest.fixture(scope="module")
def fleet():
    ex = DistributedDagExecutor(n_local_workers=2, worker_threads=2)
    try:
        yield ex
    finally:
        ex.close()


class _Count(ct.Callback):
    def __init__(self):
        self.value = 0

    def on_task_end(self, event):
        self.value += 1


def _specs(tmp_path, **kw):
    return (cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB", **kw),
            ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB", **kw))


def test_distributed_end_to_end(tmp_path, fleet):
    an = np.arange(100, dtype=np.float64).reshape(10, 10)
    rs, ps = _specs(tmp_path)
    ref = float(rxp.sum(rxp.add(cubed_tpu.from_array(an, chunks=(4, 4), spec=rs),
                                cubed_tpu.from_array(an, chunks=(4, 4), spec=rs))).compute())
    a = ct.from_array(an, chunks=(4, 4), spec=ps)
    counter = _Count()
    result = float(xp.sum(xp.add(a, a)).compute(executor=fleet, callbacks=[counter]))
    assert result == ref == (an + an).sum()
    assert counter.value > 0
    reports = fleet.stats["worker_reports"]
    assert set(reports) == {"local-0", "local-1"} and {r["device"] for r in reports.values()} == {"cpu"}


def test_distributed_fused_closures_lambda_partial(tmp_path, fleet):
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    k = 0.25
    rs, ps = _specs(tmp_path)
    vals = []
    for pkg, nxp, spec, ex in ((cubed_tpu, rxp, rs, None), (ct, xp, ps, fleet)):
        a = pkg.from_array(an, chunks=(4, 4), spec=spec)
        b = pkg.map_blocks(lambda x: x - k, a, dtype=np.float64)
        c = pkg.map_blocks(functools.partial(np.multiply, 3.0), b, dtype=np.float64)
        r = nxp.mean(nxp.add(nxp.multiply(c, 2.0), a))
        vals.append(float(r.compute(executor=ex)) if ex is not None else float(r.compute()))
    assert vals[1] == pytest.approx(vals[0], rel=1e-12)


def test_distributed_reused_across_computes_and_blob_cache(tmp_path, fleet):
    an = np.ones((8, 8), dtype=np.float64)
    a = ct.from_array(an, chunks=(4, 4), spec=_specs(tmp_path)[1])
    before = dict(fleet._coordinator.stats)
    r1 = float(xp.sum(a).compute(executor=fleet))
    sent_after_first = fleet._coordinator.stats["blobs_sent"] - before["blobs_sent"]
    r2 = float(xp.sum(xp.add(a, a)).compute(executor=fleet))
    assert r1 == an.sum() and r2 == 2 * an.sum()
    stats = fleet._coordinator.stats
    tasks = stats["tasks_sent"] - before["tasks_sent"]
    blobs = stats["blobs_sent"] - before["blobs_sent"]
    assert sent_after_first >= 1 and tasks >= blobs
    assert blobs < tasks  # each (op, worker) pair ships its blob once


def test_distributed_generation_parallelism(tmp_path, fleet):
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    ps = _specs(tmp_path, scheduler="oplevel")[1]
    a = ct.from_array(an, chunks=(4, 4), spec=ps)
    b = ct.from_array(2 * an, chunks=(4, 4), spec=ps)
    result = float(xp.sum(xp.add(a, b)).compute(executor=fleet, compute_arrays_in_parallel=True))
    assert result == (an + 2 * an).sum()


def test_distributed_remote_exception_propagates(tmp_path, fleet):
    a = ct.from_array(np.ones((4, 4)), chunks=(2, 2), spec=_specs(tmp_path)[1])

    def boom(x):
        raise ValueError("task failed on purpose")

    r = ct.map_blocks(boom, a, dtype=np.float64)
    with pytest.raises(RemoteTaskError, match="task failed on purpose") as info:
        r.compute(executor=fleet, retries=0)
    assert info.value.remote_type == "ValueError"


def test_distributed_undeserializable_blob_fails_task_not_worker(tmp_path, fleet):
    a = ct.from_array(np.ones((4, 4)), chunks=(2, 2), spec=_specs(tmp_path)[1])
    poison = _torch_fleet.UnloadableOnWorker()

    def needs_missing_dep(x):
        return x + (0.0 if poison is None else 0.0)

    r = ct.map_blocks(needs_missing_dep, a, dtype=np.float64)
    with pytest.raises(RemoteTaskError, match="dependency missing"):
        r.compute(executor=fleet, retries=0)
    assert fleet._coordinator.n_workers == 2  # the fleet survived
    assert float(xp.sum(a).compute(executor=fleet)) == 16.0


def test_distributed_vorticity_dataflow_bitwise_and_reference(tmp_path, fleet):
    """The main path's plan, cut, on the fleet under the dataflow
    scheduler: bit for bit the port's sequential value, the JAX package's
    at rtol 1e-12, every task run once."""
    rs, ps = _specs(tmp_path)
    out = []
    for pkg, nxp, spec in ((cubed_tpu, rxp, rs), (ct, xp, ps)):
        rng = np.random.default_rng(5)
        a, b, x, y = [pkg.from_array(rng.random((12, 10, 8)), chunks=(4, 5, 4), spec=spec) for _ in range(4)]
        out.append(nxp.mean(a[1:] * x[1:] + b[1:] * y[1:]))
    ref, v = out
    counter = _Count()
    got = float(v.compute(executor=fleet, callbacks=[counter]))
    assert got == float(v.compute())
    assert got == pytest.approx(float(ref.compute()), rel=1e-12)
    assert counter.value == v.plan._finalize().num_tasks() == ref.plan._finalize().num_tasks()


def test_fleet_heartbeats_fold_worker_metrics_into_coordinator(tmp_path, fleet):
    an = np.arange(64.0).reshape(8, 8)
    a = ct.from_array(an, chunks=(2, 2), spec=_specs(tmp_path)[1])
    r = ct.map_blocks(_torch_fleet.inc_one, a, dtype=np.float64)
    reg = get_registry()
    before = reg.snapshot()
    coord = fleet._coordinator
    start = (coord.stats_snapshot().get("fleet_metrics") or {}).get("worker_tasks_executed", 0)
    np.testing.assert_array_equal(np.asarray(r.compute(executor=fleet)), an + 1.0)
    deadline = time.monotonic() + 15
    total = 0
    while time.monotonic() < deadline:
        snap = coord.stats_snapshot()
        total = (snap.get("fleet_metrics") or {}).get("worker_tasks_executed", 0) - start
        if total >= 17:  # 16 map tasks and the create-arrays bootstrap
            break
        time.sleep(0.2)
    assert total >= 17, snap.get("fleet_metrics")
    per_worker = [(w.get("metrics") or {}).get("worker_tasks_executed", 0)
                  for w in snap["workers"].values() if w.get("alive")]
    assert sum(per_worker) == total + start
    assert all(v > 0 for v in per_worker)
    assert reg.snapshot_delta(before).get("heartbeat_metric_deltas", 0) >= 2


def test_heartbeat_metrics_delta_is_bounded_numeric_and_nonzero():
    from cubed_tpu.observability.metrics import MetricsRegistry as RefMetricsRegistry

    out = []
    for registry_cls, delta_fn in ((MetricsRegistry, heartbeat_metrics_delta),
                                   (RefMetricsRegistry, ref_heartbeat_metrics_delta)):
        reg = registry_cls()
        reg.counter("worker_tasks_executed").inc(3)
        reg.counter("untouched").inc(0)
        reg.gauge("peer_cache_bytes").set(123)
        reg.histogram("op_wall_clock_s").observe(0.5)
        delta, snap = delta_fn(reg, {})
        delta2, _ = delta_fn(reg, snap)
        for i in range(2 * HEARTBEAT_DELTA_MAX_KEYS):
            reg.counter(f"m{i:04d}").inc()
        delta3, _ = delta_fn(reg, snap)
        out.append((delta, delta2, delta3))
    (delta, delta2, delta3), ref = out
    assert (delta, delta2, delta3) == ref
    assert delta == {"worker_tasks_executed": 3}
    assert set(delta2) == {"gauges_dropped_in_delta"}
    assert len([k for k in delta3 if k != "heartbeat_delta_keys_dropped"]) <= HEARTBEAT_DELTA_MAX_KEYS
    assert delta3["heartbeat_delta_keys_dropped"] > 0


def test_no_workers_error_is_actionable():
    coord = Coordinator("127.0.0.1", 0)
    try:
        with pytest.raises(NoWorkersError) as ei:
            coord.submit(None, lambda x: x, 0)
        msg = str(ei.value)
        host, port = coord.address
        assert "no live workers" in msg and f"{host}:{port}" in msg
        assert "cubed_tpu_torch.runtime.worker" in msg and "no worker ever connected" in msg
        with pytest.raises(TimeoutError) as ei2:
            coord.wait_for_workers(2, timeout=0.2)
        m2 = str(ei2.value)
        assert "0 of 2" in m2 and "0.2" in m2 and "0 ever joined" in m2
        assert "cubed_tpu_torch.runtime.worker" in m2
    finally:
        coord.close()


def test_compute_with_zero_workers_fails_fast(tmp_path):
    ex = DistributedDagExecutor(listen="127.0.0.1:0", n_local_workers=0, min_workers=0)
    try:
        a = ct.from_array(np.ones((4, 4)), chunks=(2, 2), spec=_specs(tmp_path)[1])
        with pytest.raises(NoWorkersError, match="zero live workers"):
            xp.sum(a).compute(executor=ex)
    finally:
        ex.close()


def _autoscale_kwargs(name):
    from cubed_tpu_torch.runtime.autoscale import AutoscalePolicy

    return {"autoscale": {"autoscale": True}, "max_workers": {"max_workers": 2},
            "autoscale_policy": {"autoscale_policy": AutoscalePolicy(min_workers=1, max_workers=2, interval_s=0.2)}}[name]


@pytest.mark.parametrize("name", ["autoscale", "max_workers", "autoscale_policy"])
def test_autoscale_options_run_a_compute(tmp_path, name):
    """Each of the autoscaler's constructor options starts the policy loop
    over a local fleet, and a compute runs through it to the JAX package's
    value."""
    an = np.arange(64.0).reshape(8, 8)
    rs, ps = _specs(tmp_path)
    ref = cubed_tpu.map_blocks(lambda x: x + 1.0, cubed_tpu.from_array(an, chunks=(4, 4), spec=rs),
                               dtype=np.float64).compute()
    ex = DistributedDagExecutor(n_local_workers=1, **_autoscale_kwargs(name))
    try:
        got = ct.map_blocks(_torch_fleet.inc_one, ct.from_array(an, chunks=(4, 4), spec=ps),
                            dtype=np.float64).compute(executor=ex)
        np.testing.assert_array_equal(got, ref)
        assert ex._autoscaler is not None and ex.stats["autoscale"]["autoscaler_ticks"] >= 0
    finally:
        ex.close()
    assert ex._autoscaler is None


def test_control_dir_writes_a_control_log(tmp_path):
    """``control_dir=`` arms the control plane: epoch 0 is recorded and
    advertised, the worker's registration and the dispatch frontier land
    in the log, and every dispatch there is done (the close records the
    worker gone)."""
    from cubed_tpu_torch.runtime.journal import control_log_path, load_control, read_rendezvous, rendezvous_path

    control = str(tmp_path / "control")
    an = np.arange(64.0).reshape(8, 8)
    ex = DistributedDagExecutor(n_local_workers=1, control_dir=control)
    try:
        got = ct.map_blocks(_torch_fleet.inc_one, ct.from_array(an, chunks=(4, 4), spec=_specs(tmp_path)[1]),
                            dtype=np.float64).compute(executor=ex)
        np.testing.assert_array_equal(got, an + 1.0)
        addr = ex._coordinator.address
    finally:
        ex.close()
    import json

    kinds = [json.loads(line)["kind"] for line in open(control_log_path(control))]
    assert kinds[0] == "epoch" and "worker" in kinds
    assert kinds.count("done") >= kinds.count("dispatch") >= 4  # untagged tasks record only their done
    folded = load_control(control_log_path(control))
    assert folded["epoch"] == 0 and folded["inflight"] == {} and folded["bad_lines"] == 0
    assert read_rendezvous(rendezvous_path(control)) == {"epoch": 0, "addr": (str(addr[0]), int(addr[1]))}


def test_the_service_computes_on_the_fleet(tmp_path, fleet):
    """``cubed_tpu_torch.service.ComputeService`` serves a request on the
    fleet, to the JAX package's service's value."""
    import cubed_tpu.service as ref_service
    from cubed_tpu.runtime.executors.python_async import AsyncPythonDagExecutor as RefAsync
    from cubed_tpu_torch.service import ComputeService

    an = np.arange(64.0).reshape(8, 8)
    rs, ps = _specs(tmp_path)
    with ref_service.ComputeService(executor=RefAsync()) as svc:
        ref = svc.submit(cubed_tpu.map_blocks(lambda x: x + 1.0, cubed_tpu.from_array(an, chunks=(4, 4), spec=rs),
                                              dtype=np.float64), tenant="t").result(timeout=120)
    with ComputeService(executor=fleet) as svc:
        h = svc.submit(ct.map_blocks(_torch_fleet.inc_one, ct.from_array(an, chunks=(4, 4), spec=ps),
                                     dtype=np.float64), tenant="t")
        np.testing.assert_array_equal(h.result(timeout=120), ref)
        assert svc.stats_snapshot()["tenants"]["t"]["completed"] == 1


def test_a_live_fleet_feeds_the_telemetry_sampler(tmp_path, fleet):
    """The coordinator registers itself with the telemetry sampler: its
    per-worker and aggregate series and ``fleet_view`` read the live fleet,
    and a closed coordinator leaves the registry."""
    from cubed_tpu_torch.observability.timeseries import TelemetrySampler, TimeSeriesStore, fleet_view, live_fleets

    an = np.arange(64.0).reshape(8, 8)
    a = ct.from_array(an, chunks=(2, 2), spec=_specs(tmp_path)[1])
    ct.map_blocks(_torch_fleet.inc_one, a, dtype=np.float64).compute(executor=fleet)
    assert fleet._coordinator in live_fleets()
    store = TimeSeriesStore()
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        TelemetrySampler(store).sample_once(now=time.time())
        if all(store.latest("worker_rss_bytes", labels={"worker": w}) for w in ("local-0", "local-1")):
            break
        time.sleep(0.2)
    assert store.latest("fleet_workers_live") == 2
    assert store.latest("fleet_queue_depth") == 0
    for w in ("local-0", "local-1"):
        assert store.latest("worker_rss_bytes", labels={"worker": w}) > 0
        assert store.latest("worker_outstanding", labels={"worker": w}) == 0
    view = fleet_view()
    assert view["workers_live"] >= 2 and {"local-0", "local-1"} <= set(view["workers"])
    coord = Coordinator("127.0.0.1", 0)
    assert coord in live_fleets()
    coord.close()
    assert coord not in live_fleets()
