"""Live telemetry: a bounded time-series pipeline over the metrics.
Counterpart of ``cubed_tpu/observability/timeseries.py``.

Metrics snapshots, traces and flight-recorder bundles are post-hoc:
readable after the compute ends. This module is the *live* layer:

- :class:`TimeSeriesStore` — a bounded ring of ``(timestamp, value)``
  points per ``(metric, labels)`` series. Fixed memory: ``capacity``
  points per series, ``max_series`` series (at the cap the stalest
  series is evicted for the new one, counted in
  ``timeseries_series_evicted`` — never silent).

- :class:`TelemetrySampler` — a ~1s daemon thread that samples the
  process metrics registry into the store (counters ride as cumulative
  values; ``rate()`` derives per-second rates on read) and per-compute
  progress (tasks done/total) from :class:`ComputeProgressCallback`. It
  reads the registry only: it adds no reading of the card. Each tick also
  evaluates the alert engine (``observability/alerts.py``).

The fleet's coordinator (``runtime/distributed.py``) registers itself with
:func:`register_fleet` while it lives, and the sampler derives the
per-worker and fleet-aggregate series from its ``stats_snapshot`` as the
reference does. A started ``service.ComputeService`` registers itself with
:func:`register_service`; the sampler derives the per-tenant series
(``tenant_queued``/``tenant_running``/``tenant_completed``, the
``tenant_cost_*`` fold) and the ``slo_*`` series from its
``stats_snapshot``, which stay quiet while no service is live.

The HTTP endpoints over this store (``/metrics``, ``/healthz``,
``/snapshot.json``) and the arming precedence live in
``observability/export.py``; the terminal dashboard is
``python -m cubed_tpu_torch.top``.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

from ..runtime.types import Callback
from .metrics import get_registry

logger = logging.getLogger(__name__)

#: points retained per series (~10 minutes at the 1s default interval)
DEFAULT_CAPACITY = 600
#: distinct (name, labels) series retained; overflow is counted
DEFAULT_MAX_SERIES = 2048

#: bound on how many numeric metric keys one sampler tick records from a
#: registry snapshot — a runaway metric namespace must not grow the store
MAX_SAMPLED_METRICS = 512


def _label_key(labels: Optional[dict]) -> Tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class TimeSeriesStore:
    """Bounded in-memory time series: ``(name, labels) -> ring of points``.

    Thread-safe; writers are the sampler and the coordinator heartbeat
    path, readers are the HTTP endpoints, the alert engine, the dashboard
    and the flight recorder.
    """

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        max_series: int = DEFAULT_MAX_SERIES,
    ):
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        #: (name, label_key) -> (labels dict, deque[(ts, value)])
        self._series: "OrderedDict[Tuple, Tuple[dict, deque]]" = OrderedDict()
        self.series_evicted = 0

    # -- writing -------------------------------------------------------

    def record(
        self, name: str, value, ts: Optional[float] = None,
        labels: Optional[dict] = None,
    ) -> None:
        """Append one point. Non-numeric values are ignored (the sampler
        feeds raw snapshots; histogram dicts are decomposed by the caller).

        At the series cap the STALEST series (oldest last point) is
        evicted to admit the new one — a long-lived service endpoint
        churns labelled dimensions forever (per-compute progress,
        autoscaler-churned worker names), and dropping the NEW series
        would starve exactly the live computes/workers an operator is
        watching. Evictions are counted (``timeseries_series_evicted``),
        never silent."""
        if isinstance(value, bool):
            value = int(value)
        elif not isinstance(value, (int, float)):
            return
        if ts is None:
            ts = time.time()
        key = (name, _label_key(labels))
        evicted = False
        with self._lock:
            entry = self._series.get(key)
            if entry is None:
                if len(self._series) >= self.max_series:
                    stalest = min(
                        self._series,
                        key=lambda k: (
                            self._series[k][1][-1][0]
                            if self._series[k][1] else 0.0
                        ),
                    )
                    del self._series[stalest]
                    self.series_evicted += 1
                    evicted = True
                entry = (dict(labels or {}), deque(maxlen=self.capacity))
                self._series[key] = entry
            entry[1].append((float(ts), float(value)))
        if evicted:
            get_registry().counter("timeseries_series_evicted").inc()
            if self.series_evicted == 1:
                logger.warning(
                    "time-series store reached its %d-series bound; "
                    "stalest series are evicted for new ones (counted in "
                    "timeseries_series_evicted)", self.max_series,
                )

    def forget(self, name: str, labels: Optional[dict] = None) -> None:
        """Drop one series (e.g. a finished compute's progress gauges)."""
        with self._lock:
            self._series.pop((name, _label_key(labels)), None)

    # -- reading -------------------------------------------------------

    def latest(self, name: str, labels: Optional[dict] = None):
        """The most recent value of a series, or None."""
        pt = self.latest_point(name, labels=labels)
        return None if pt is None else pt[1]

    def latest_point(self, name: str, labels: Optional[dict] = None):
        """The most recent ``(ts, value)`` of a series, or None — the
        timestamp lets alert rules treat a FROZEN series (its writer is
        gone) as no-data instead of evaluating a stale reading forever."""
        with self._lock:
            entry = self._series.get((name, _label_key(labels)))
            if entry is None or not entry[1]:
                return None
            return entry[1][-1]

    def window(
        self, name: str, seconds: float, labels: Optional[dict] = None,
        now: Optional[float] = None,
    ) -> list:
        """Points of one series within the trailing window, oldest first."""
        if now is None:
            now = time.time()
        t0 = now - seconds
        with self._lock:
            entry = self._series.get((name, _label_key(labels)))
            if entry is None:
                return []
            return [(ts, v) for ts, v in entry[1] if ts >= t0]

    def rate(
        self, name: str, seconds: float, labels: Optional[dict] = None,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Per-second increase of a cumulative counter series over the
        trailing window (clamped at 0 — a process restart resets counters,
        which must read as "no progress", not a negative rate). None with
        fewer than two points in the window."""
        pts = self.window(name, seconds, labels=labels, now=now)
        if len(pts) < 2:
            return None
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return None
        return max(0.0, (v1 - v0) / (t1 - t0))

    def series(self) -> list:
        """``[(name, labels, n_points), ...]`` for every retained series."""
        with self._lock:
            return [
                (name, dict(entry[0]), len(entry[1]))
                for (name, _k), entry in self._series.items()
            ]

    def labelled_latest(self) -> list:
        """``[(name, labels, latest_value), ...]`` for every LABELLED
        series (per-worker / per-compute dimensions) — what the Prometheus
        exposition exports beside the registry's unlabelled metrics."""
        return [row for row in self.latest_series() if row[1]]

    def latest_series(self) -> list:
        """``[(name, labels, latest_value), ...]`` for every series —
        labels empty for unlabelled ones (fleet aggregates like
        ``fleet_pressured_fraction``, which exist only here, not in the
        registry)."""
        out = []
        with self._lock:
            for (name, _k), (labels, ring) in self._series.items():
                if ring:
                    out.append((name, dict(labels), ring[-1][1]))
        return out

    def to_dict(
        self, window_s: Optional[float] = None, max_points: int = 240,
        now: Optional[float] = None,
    ) -> list:
        """JSON-serializable dump: one ``{name, labels, points}`` row per
        series, each series bounded to its trailing ``max_points`` (within
        ``window_s`` when given) — what ``/snapshot.json`` and the
        flight-recorder bundle embed."""
        if now is None:
            now = time.time()
        t0 = None if window_s is None else now - window_s
        out = []
        with self._lock:
            items = list(self._series.items())
        for (name, _k), (labels, ring) in items:
            pts = list(ring)
            if t0 is not None:
                pts = [p for p in pts if p[0] >= t0]
            pts = pts[-max_points:]
            if not pts:
                continue
            out.append({
                "name": name,
                "labels": dict(labels),
                "points": [[round(ts, 3), v] for ts, v in pts],
            })
        return out


# ----------------------------------------------------------------------
# fleet + compute registration (what the sampler samples)
# ----------------------------------------------------------------------

#: live Coordinators (weak: a closed/garbage fleet must never pin itself
#: into the telemetry loop); registered by Coordinator.__init__
_fleets: "weakref.WeakSet" = weakref.WeakSet()
_fleets_lock = threading.Lock()


def register_fleet(coordinator) -> None:
    with _fleets_lock:
        _fleets.add(coordinator)


def unregister_fleet(coordinator) -> None:
    with _fleets_lock:
        _fleets.discard(coordinator)


def live_fleets() -> list:
    with _fleets_lock:
        return [c for c in _fleets if not c._closed.is_set()]


#: live ComputeServices (weak, like fleets); registered by
#: ComputeService.start — the sampler derives the per-tenant series
#: (tenant_queued/tenant_running/tenant_completed, labelled by tenant)
#: and /snapshot.json's "service" section from these
_services: "weakref.WeakSet" = weakref.WeakSet()
_services_lock = threading.Lock()


def register_service(service) -> None:
    with _services_lock:
        _services.add(service)


def unregister_service(service) -> None:
    with _services_lock:
        _services.discard(service)


def live_services() -> list:
    with _services_lock:
        return [s for s in _services if not s.closed]


def service_view() -> Optional[dict]:
    """Merged per-tenant service table for ``/snapshot.json`` and the
    dashboard; None while no service is live."""
    views = []
    for svc in live_services():
        try:
            views.append(svc.stats_snapshot())
        except Exception:
            continue
    if not views:
        return None
    if len(views) == 1:
        return views[0]
    # 2+ live services: the tenant/queue aggregates still merge (the
    # TENANTS panel reads one table), but the per-service identity —
    # service_dir, cache stats, SLO board — must NOT be nulled away the
    # moment a second service starts: each view keeps its own row under
    # "services", and the slo boards merge per tenant (tenant names are
    # already the services' own namespaces)
    merged = {
        "tenants": {}, "queue_depth": 0, "running": 0, "slots": 0,
        "throttling": any(v.get("throttling") for v in views),
        "durable": any(v.get("durable") for v in views),
        "slo": {},
        "services": [
            {
                "service_dir": v.get("service_dir"),
                "durable": v.get("durable"),
                "plan_cache": v.get("plan_cache"),
                "result_cache": v.get("result_cache"),
                "queue_depth": v.get("queue_depth"),
                "running": v.get("running"),
                "slots": v.get("slots"),
                "throttling": v.get("throttling"),
            }
            for v in views
        ],
    }
    for v in views:
        merged["tenants"].update(v.get("tenants") or {})
        merged["queue_depth"] += v.get("queue_depth") or 0
        merged["running"] += v.get("running") or 0
        merged["slots"] += v.get("slots") or 0
        merged["slo"].update(v.get("slo") or {})
    if not merged["slo"]:
        merged["slo"] = None
    return merged


#: active (and a few recent) computes: compute_id -> progress dict
_computes_lock = threading.Lock()
_computes: "OrderedDict[str, dict]" = OrderedDict()
MAX_TRACKED_COMPUTES = 16


def compute_progress() -> list:
    """Progress rows for the dashboard/endpoints, newest last."""
    with _computes_lock:
        return [dict(row) for row in _computes.values()]


class ComputeProgressCallback(Callback):
    """Tracks one compute's tasks done/total for the live endpoints.

    Attached by ``Plan.execute`` whenever telemetry is armed; the sampler
    turns the numbers into ``compute_tasks_done`` / ``compute_tasks_total``
    series (labelled by compute id) from which the dashboard derives task
    rate and ETA."""

    def __init__(self):
        self._compute_id: Optional[str] = None

    def on_compute_start(self, event) -> None:
        from ..runtime.pipeline import iter_op_nodes

        cid = getattr(event, "compute_id", None) or "unknown"
        self._compute_id = cid
        total = 0
        try:
            total = sum(
                d["primitive_op"].num_tasks
                for _, d in iter_op_nodes(event.dag)
            )
        except Exception:  # introspection must never fail a compute
            pass
        with _computes_lock:
            _computes[cid] = {
                "compute_id": cid,
                "started_at": time.time(),
                "tasks_done": 0,
                "tasks_total": total,
                "status": "running",
                "ended_at": None,
            }
            while len(_computes) > MAX_TRACKED_COMPUTES:
                _computes.popitem(last=False)

    def on_task_end(self, event) -> None:
        cid = self._compute_id
        if cid is None:
            return
        # the device executor emits ONE event covering an op's whole task
        # batch — num_tasks carries the real count (cf. the metrics
        # callback's tasks_completed fold)
        n = getattr(event, "num_tasks", 1) or 1
        with _computes_lock:
            row = _computes.get(cid)
            if row is not None:
                row["tasks_done"] += n

    def on_compute_end(self, event) -> None:
        cid = self._compute_id
        if cid is None:
            return
        failed = getattr(event, "error", None) is not None
        with _computes_lock:
            row = _computes.get(cid)
            if row is not None:
                row["status"] = "failed" if failed else "succeeded"
                row["ended_at"] = time.time()
        self._compute_id = None
        # release the finished compute's progress series promptly: the
        # dashboard only reads series for RUNNING computes, and a
        # long-lived endpoint must not let per-compute labels accumulate
        # toward the store's series cap
        from .export import get_runtime

        runtime = get_runtime()
        if runtime is not None:
            labels = {"compute": cid}
            runtime.store.forget("compute_tasks_done", labels=labels)
            runtime.store.forget("compute_tasks_total", labels=labels)


# ----------------------------------------------------------------------
# the sampler
# ----------------------------------------------------------------------


class TelemetrySampler:
    """~1s daemon loop: registry + fleet + compute progress -> the store.

    Counters are recorded cumulatively (rates derive on read), gauges as
    readings, histograms as ``<name>_count`` / ``<name>_sum`` plus their
    estimated quantiles. Per-worker dimensions come from every registered
    coordinator's worker table (heartbeat-fed); per-compute dimensions
    from :class:`ComputeProgressCallback`. Each tick ends by evaluating
    the alert engine, so alert latency is one sampling interval."""

    def __init__(
        self,
        store: TimeSeriesStore,
        interval_s: float = 1.0,
        alert_engine=None,
    ):
        self.store = store
        self.interval_s = max(0.05, float(interval_s))
        self.alert_engine = alert_engine
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_sample_ts: Optional[float] = None
        self._skip_logged = False
        #: once any fleet registered, the aggregate series keep recording
        #: (as zeros) after it closes — stale non-zero readings must decay
        self._saw_fleet = False

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()  # a stopped sampler must be restartable
        self._thread = threading.Thread(
            target=self._loop, name="telemetry-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    @property
    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                # the telemetry loop must never die of one bad tick
                logger.exception("telemetry sampler tick failed")

    # -- one tick ------------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> None:
        """One sampling tick (public so tests and the sampler share one
        code path; the thread just calls this every interval)."""
        if now is None:
            now = time.time()
        reg = get_registry()
        self._sample_registry(reg, now)
        self._sample_fleets(now)
        self._sample_computes(now)
        self._sample_services(now)
        reg.counter("telemetry_samples").inc()
        self.last_sample_ts = now
        if self.alert_engine is not None:
            try:
                self.alert_engine.tick(now=now)
            except Exception:
                logger.exception("alert engine tick failed")

    def _sample_registry(self, reg, now: float) -> None:
        snap = reg.snapshot()
        recorded = 0
        skipped = 0
        for k in sorted(snap):
            if recorded >= MAX_SAMPLED_METRICS:
                # deterministic starvation of the alphabetically-late tail
                # — counted like every other bound in this layer, so a
                # metric silently missing from the series store has a
                # visible cause
                skipped += 1
                continue
            v = snap[k]
            if isinstance(v, dict):  # histogram summary
                self.store.record(f"{k}_count", v.get("count"), ts=now)
                self.store.record(f"{k}_sum", v.get("sum"), ts=now)
                recorded += 2
                for label in ("p50", "p95", "p99"):
                    if v.get(label) is not None:
                        self.store.record(f"{k}_{label}", v[label], ts=now)
                        recorded += 1
            elif k.endswith("_max"):
                continue  # lifetime high-water marks: not a time series
            elif isinstance(v, (int, float)):
                self.store.record(k, v, ts=now)
                recorded += 1
        if skipped:
            reg.counter("telemetry_metrics_skipped").inc(skipped)
            if not self._skip_logged:
                self._skip_logged = True
                logger.warning(
                    "telemetry sampler: registry namespace exceeds the "
                    "%d-metric per-tick budget; %d metric(s) skipped "
                    "(counted in telemetry_metrics_skipped)",
                    MAX_SAMPLED_METRICS, skipped,
                )

    def _sample_fleets(self, now: float) -> None:
        live = pressured = queue = 0
        n_fleets = 0
        for coord in live_fleets():
            n_fleets += 1
            try:
                rows = coord.load_view()
                workers = coord.stats_snapshot().get("workers") or {}
            except Exception:
                continue
            for row in rows:
                live += 1
                if row.get("pressured"):
                    pressured += 1
                queue += row.get("outstanding") or 0
                labels = {"worker": row["name"]}
                self.store.record(
                    "worker_outstanding", row.get("outstanding"), ts=now,
                    labels=labels,
                )
                self.store.record(
                    "worker_connected", 1 if row.get("connected") else 0,
                    ts=now, labels=labels,
                )
                self.store.record(
                    "worker_pressured", 1 if row.get("pressured") else 0,
                    ts=now, labels=labels,
                )
                wrow = workers.get(row["name"]) or {}
                if wrow.get("rss") is not None:
                    self.store.record(
                        "worker_rss_bytes", wrow["rss"], ts=now,
                        labels=labels,
                    )
                cache = wrow.get("peer_cache")
                if isinstance(cache, dict):
                    self.store.record(
                        "worker_peer_cache_bytes", cache.get("bytes"),
                        ts=now, labels=labels,
                    )
                metrics = wrow.get("metrics")
                if isinstance(metrics, dict):
                    # per-worker cumulative counters accumulated from the
                    # heartbeat snapshot_delta payloads: the ones the
                    # dashboard reads per worker (counted where the work
                    # ran — runtime/distributed.py folds them into each
                    # worker's registry)
                    for k in (
                        "worker_tasks_executed", "worker_task_errors",
                        "peer_hits", "peer_misses", "peer_chunks_served",
                    ):
                        if isinstance(metrics.get(k), (int, float)):
                            self.store.record(
                                f"fleet_{k}", metrics[k], ts=now,
                                labels=labels,
                            )
        if n_fleets:
            self._saw_fleet = True
        if self._saw_fleet:
            # keep recording (real zeros) after the last fleet closes: a
            # frozen last-known reading >=0.5 would hold a pressure alert
            # active forever in the long-lived telemetry singleton
            self.store.record("fleet_workers_live", live, ts=now)
            self.store.record("fleet_workers_pressured", pressured, ts=now)
            self.store.record(
                "fleet_pressured_fraction",
                (pressured / live) if live else 0.0, ts=now,
            )
            self.store.record("fleet_queue_depth", queue, ts=now)

    def _sample_services(self, now: float) -> None:
        """Per-tenant series from every live ComputeService: queue depth
        and running count as gauges, completions as a cumulative counter —
        what the ``tenant_starvation`` alert rule and the dashboard's
        TENANTS panel read."""
        for svc in live_services():
            try:
                snap = svc.stats_snapshot()
            except Exception:
                continue
            for tenant, row in (snap.get("tenants") or {}).items():
                labels = {"tenant": tenant}
                self.store.record(
                    "tenant_queued", row.get("queued"), ts=now, labels=labels,
                )
                self.store.record(
                    "tenant_running", row.get("running"), ts=now,
                    labels=labels,
                )
                self.store.record(
                    "tenant_completed", row.get("completed"), ts=now,
                    labels=labels,
                )
                self.store.record(
                    "tenant_throttled_total", row.get("throttled"), ts=now,
                    labels=labels,
                )
                # the tenant_cost_* family: cumulative consumption per
                # tenant (task-seconds, store/peer bytes, retry draw) from
                # the service's _CostTracker fold — what a quota/billing
                # story reads off /metrics
                cost = row.get("cost") or {}
                self.store.record(
                    "tenant_cost_task_seconds", cost.get("task_seconds"),
                    ts=now, labels=labels,
                )
                self.store.record(
                    "tenant_cost_bytes_read", cost.get("bytes_read"),
                    ts=now, labels=labels,
                )
                self.store.record(
                    "tenant_cost_bytes_written", cost.get("bytes_written"),
                    ts=now, labels=labels,
                )
                self.store.record(
                    "tenant_cost_peer_bytes", cost.get("peer_bytes"),
                    ts=now, labels=labels,
                )
                self.store.record(
                    "tenant_cost_retries", cost.get("retries"),
                    ts=now, labels=labels,
                )
            # the slo_* family: per-tenant board rows (burn rate per
            # window, budget remaining, SLI counts, latency quantiles) —
            # what the slo_fast_burn / slo_slow_burn rules watch and the
            # summary-convention /metrics quantile export reads
            for tenant, row in (snap.get("slo") or {}).items():
                labels = {"tenant": tenant}
                burn = row.get("burn") or {}
                for wlabel in ("5m", "1h", "6h", "3d"):
                    self.store.record(
                        f"slo_burn_{wlabel}", burn.get(wlabel), ts=now,
                        labels=labels,
                    )
                self.store.record(
                    "slo_budget_remaining", row.get("budget_remaining"),
                    ts=now, labels=labels,
                )
                self.store.record(
                    "slo_events_total", row.get("events"), ts=now,
                    labels=labels,
                )
                self.store.record(
                    "slo_bad_total", row.get("bad"), ts=now, labels=labels,
                )
                lat = row.get("latency") or {}
                for q in ("p50", "p95", "p99"):
                    self.store.record(
                        f"slo_request_latency_{q}", lat.get(f"{q}_s"),
                        ts=now, labels=labels,
                    )

    def _sample_computes(self, now: float) -> None:
        for row in compute_progress():
            if row.get("status") != "running":
                continue
            labels = {"compute": row["compute_id"]}
            self.store.record(
                "compute_tasks_done", row["tasks_done"], ts=now,
                labels=labels,
            )
            self.store.record(
                "compute_tasks_total", row["tasks_total"], ts=now,
                labels=labels,
            )


def fleet_view() -> dict:
    """Point-in-time fleet table for ``/snapshot.json`` / ``/healthz`` /
    the dashboard: per-worker rows from every live coordinator, plus the
    aggregate counts the health verdict is made of."""
    workers: Dict[str, dict] = {}
    live = pressured = disconnected = 0
    epoch = 0
    for coord in live_fleets():
        try:
            snap = coord.stats_snapshot()
        except Exception:
            continue
        epoch = max(epoch, int(snap.get("epoch") or 0))
        for name, row in (snap.get("workers") or {}).items():
            if not row.get("alive"):
                continue
            live += 1
            if row.get("pressured"):
                pressured += 1
            if not row.get("connected", True):
                disconnected += 1
            workers[name] = row
    return {
        "workers": workers,
        "workers_live": live,
        "workers_pressured": pressured,
        "workers_disconnected": disconnected,
        # the control-plane epoch (max across fleets): bumps on every
        # coordinator takeover, so a dashboard reading 1+ knows this
        # fleet was adopted by a successor at least once
        "epoch": epoch,
        "fleets": len(live_fleets()),
    }


def dispatch_view() -> Optional[dict]:
    """Point-in-time control-plane view for ``/snapshot.json`` and the
    ``cubed_tpu_torch.top`` DISPATCH panel: the dispatch loop's self-accounted
    utilization/capacity gauges (registry) plus per-message-type frame
    and byte counts from every live coordinator's link. None when
    nothing dispatch-shaped has been recorded yet."""
    from .metrics import get_registry

    snap = get_registry().snapshot()
    out: dict = {}
    for key in (
        "dispatch_utilization", "dispatch_capacity_estimate",
        "dispatch_submit_s", "dispatch_serialize_s", "dispatch_send_s",
        "dispatch_unpickle_s", "dispatch_release_s",
        "dispatch_lock_wait_s", "dispatch_sched_hook_s",
        "coord_frames_sent", "coord_frames_recv",
        "coord_frame_bytes_sent", "coord_frame_bytes_recv",
    ):
        if key in snap:
            out[key] = snap[key]
    frames: Dict[str, dict] = {}
    for coord in live_fleets():
        try:
            fsnap = coord.stats_snapshot().get("frames") or {}
        except Exception:
            continue
        for direction, rows in fsnap.items():
            agg = frames.setdefault(direction, {})
            for mtype, (count, nbytes) in rows.items():
                cur = agg.setdefault(mtype, [0, 0])
                cur[0] += count
                cur[1] += nbytes
    if frames:
        out["frames"] = frames
    return out or None
