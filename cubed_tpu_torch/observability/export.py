"""Live telemetry endpoints: ``/metrics``, ``/healthz``, ``/snapshot.json``.
Counterpart of ``cubed_tpu/observability/export.py``; the port binds
``127.0.0.1`` unless ``CUBED_TPU_TORCH_TELEMETRY_HOST`` names another host.

A stdlib-HTTP daemon thread over the telemetry pipeline
(``observability/timeseries.py``), armed the same way integrity and the
memory guard are: the ``CUBED_TPU_TORCH_TELEMETRY_PORT`` env var (operator
override, wins) > ``Spec(telemetry_port=...)`` > off. Port ``0`` binds an
ephemeral port (tests, multiple fleets per host); the env value ``off``
disables telemetry even when a Spec asks for it.

- ``GET /metrics`` — Prometheus text exposition (format 0.0.4) of the
  process metrics registry plus the fleet/compute series the sampler
  maintains: counters, gauges (+ ``_max`` high-water marks), histogram
  ``_count``/``_sum`` with p50/p95/p99 quantile samples, and per-worker /
  per-compute labelled series. Metric names are sanitized
  (``[^a-zA-Z0-9_:]`` -> ``_``) and prefixed ``cubed_tpu_torch_``; label values
  are escaped per the exposition spec.
- ``GET /healthz`` — JSON fleet liveness: sampler freshness, live /
  pressured / disconnected worker counts, running computes, active
  alerts. 200 while the sampler is fresh, 503 once it goes stale (the
  probe a front-door load balancer points at).
- ``GET /snapshot.json`` — the dashboard feed: metrics snapshot, fleet
  table, compute progress, recent alert firings, and a bounded dump of
  every time series (what ``python -m cubed_tpu_torch.top`` renders).

``Plan.execute`` calls :func:`maybe_start` per compute; the runtime is a
process-global singleton that persists once armed (a service endpoint
outlives any one compute — exactly the lifecycle a scrape target needs).
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .alerts import AlertEngine
from .metrics import get_registry
from .timeseries import (
    TelemetrySampler,
    TimeSeriesStore,
    compute_progress,
    dispatch_view,
    fleet_view,
    service_view,
)

logger = logging.getLogger(__name__)

#: env var naming the telemetry port (operator override: wins over
#: ``Spec(telemetry_port=...)``; ``off``/empty disables; ``0`` = ephemeral)
TELEMETRY_PORT_ENV_VAR = "CUBED_TPU_TORCH_TELEMETRY_PORT"

#: env var naming the bind host. Default ``127.0.0.1``: the endpoint is
#: loopback-only until an operator names an interface (``0.0.0.0`` for a
#: remote scraper)
TELEMETRY_HOST_ENV_VAR = "CUBED_TPU_TORCH_TELEMETRY_HOST"
DEFAULT_BIND_HOST = "127.0.0.1"

#: every exported metric name carries the namespace prefix
METRIC_PREFIX = "cubed_tpu_torch_"

#: /healthz reports degraded once the sampler is this stale (seconds)
HEALTH_STALE_S = 10.0

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
_LEADING_DIGIT = re.compile(r"^[0-9]")


def sanitize_metric_name(name: str) -> str:
    """A Prometheus-legal metric name: dots/dashes/anything illegal become
    underscores, and a leading digit gains an underscore prefix."""
    name = _NAME_SANITIZE.sub("_", str(name))
    if _LEADING_DIGIT.match(name):
        name = "_" + name
    return name


def escape_label_value(value) -> str:
    """Escape a label value per the text exposition format: backslash,
    double-quote, and newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{sanitize_metric_name(k)}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def prometheus_text(
    registry=None, store: Optional[TimeSeriesStore] = None,
) -> str:
    """Render the registry (and the store's labelled fleet/compute series)
    as Prometheus text exposition format 0.0.4.

    Counters keep their registered names (sanitized + prefixed) so the
    docs inventory, ``snapshot()`` keys and scrape labels all agree;
    histograms export as summaries (``_count``/``_sum`` + quantile
    samples)."""
    if registry is None:
        registry = get_registry()
    snap = registry.snapshot()
    kinds = registry.kinds()
    lines: list = []

    # store series, split: labelled samples merge into their registry
    # family (one TYPE line per family — duplicating metadata is a
    # conformance violation), unlabelled store-only series (the fleet
    # aggregates the sampler derives: fleet_pressured_fraction, ...) get
    # their own gauge families below
    labelled_by_name: dict = {}
    store_only: dict = {}
    if store is not None:
        hist_suffixes = ("_count", "_sum", "_p50", "_p95", "_p99")
        for name, labels, value in store.latest_series():
            if labels:
                labelled_by_name.setdefault(name, []).append((labels, value))
            elif name not in kinds and not any(
                name.endswith(sfx)
                and kinds.get(name[: -len(sfx)]) == "histogram"
                for sfx in hist_suffixes
            ):
                # registry names and histogram-derived mirrors already
                # export through their own families; only genuinely
                # store-only series add a family here
                store_only[name] = value

    def emit(name, kind, help_text, samples):
        """One metric family: HELP + TYPE + its samples."""
        full = METRIC_PREFIX + sanitize_metric_name(name)
        lines.append(f"# HELP {full} {help_text}")
        lines.append(f"# TYPE {full} {kind}")
        for suffix, labels, value in samples:
            if value is None:
                continue
            lines.append(
                f"{full}{suffix}{_fmt_labels(labels)} {_fmt_value(value)}"
            )

    for name in sorted(kinds):
        kind = kinds[name]
        extra = [
            ("", labels, v)
            for labels, v in labelled_by_name.pop(name, [])
        ]
        if kind == "counter":
            emit(
                name, "counter",
                f"cubed_tpu_torch counter {name}",
                [("", None, snap.get(name))] + extra,
            )
        elif kind == "gauge":
            emit(
                name, "gauge",
                f"cubed_tpu_torch gauge {name} (current value)",
                [("", None, snap.get(name))] + extra,
            )
            emit(
                f"{name}_max", "gauge",
                f"cubed_tpu_torch gauge {name} (lifetime high-water mark)",
                [("", None, snap.get(f"{name}_max"))],
            )
        elif kind == "histogram":
            summary = snap.get(name)
            if not isinstance(summary, dict):
                continue
            full = METRIC_PREFIX + sanitize_metric_name(name)
            lines.append(
                f"# HELP {full} cubed_tpu_torch histogram {name} "
                "(summary: count/sum + estimated quantiles)"
            )
            lines.append(f"# TYPE {full} summary")
            for q, label in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                v = summary.get(label)
                if v is not None:
                    lines.append(
                        f'{full}{{quantile="{q}"}} {_fmt_value(v)}'
                    )
            lines.append(f"{full}_count {_fmt_value(summary.get('count', 0))}")
            lines.append(f"{full}_sum {_fmt_value(summary.get('sum', 0.0))}")

    # labelled quantile mirrors (the sampler's <base>_p50/_p95/_p99
    # series, e.g. the per-tenant slo_request_latency family): regroup
    # into ONE summary-convention family per base name with
    # {quantile="..."} labels — the shape Prometheus tooling expects for
    # estimated quantiles — instead of three disjoint gauge families.
    # Only when the base name has no registry family of its own (a
    # registry histogram already exports its summary above).
    quantile_suffixes = (("_p50", "0.5"), ("_p95", "0.95"), ("_p99", "0.99"))
    summary_groups: dict = {}
    plain_labelled: dict = {}
    for name, samples in labelled_by_name.items():
        base = None
        q = None
        for sfx, qv in quantile_suffixes:
            if name.endswith(sfx) and name[: -len(sfx)]:
                base, q = name[: -len(sfx)], qv
                break
        if base is None or base in kinds or base in labelled_by_name:
            plain_labelled[name] = samples
            continue
        group = summary_groups.setdefault(base, [])
        for labels, v in samples:
            group.append((dict(labels or {}, quantile=q), v))
    for base in sorted(summary_groups):
        emit(
            base, "summary",
            f"cubed_tpu_torch telemetry series {base} "
            "(estimated quantiles, latest samples)",
            [("", labels, v) for labels, v in summary_groups[base]],
        )
    # remaining labelled fleet/compute series whose name has no registry
    # family: one gauge family each, latest sample per label set
    for name in sorted(plain_labelled):
        emit(
            name, "gauge",
            f"cubed_tpu_torch telemetry series {name} (latest sample)",
            [("", labels, v) for labels, v in plain_labelled[name]],
        )
    # unlabelled store-only series: the sampler-derived fleet aggregates
    for name in sorted(store_only):
        emit(
            name, "gauge",
            f"cubed_tpu_torch telemetry series {name} (latest sample)",
            [("", None, store_only[name])],
        )
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------
# the HTTP endpoint
# ----------------------------------------------------------------------


class TelemetryRuntime:
    """The process-global telemetry singleton: store + sampler + alert
    engine + HTTP server. Built by :func:`ensure_started`."""

    def __init__(self, port: int, interval_s: float = 1.0,
                 rules: Optional[list] = None):
        self.store = TimeSeriesStore()
        self.alert_engine = AlertEngine(self.store, rules=rules)
        self.sampler = TelemetrySampler(
            self.store, interval_s=interval_s, alert_engine=self.alert_engine
        )
        self.requested_port = port
        self.server: Optional[ThreadingHTTPServer] = None
        self.port: Optional[int] = None
        self._server_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        runtime = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:  # no stderr chatter
                pass

            def do_GET(self) -> None:
                get_registry().counter("telemetry_http_requests").inc()
                try:
                    if self.path.startswith("/metrics"):
                        body = prometheus_text(store=runtime.store).encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                        code = 200
                    elif self.path.startswith("/healthz"):
                        payload, code = runtime.health()
                        body = json.dumps(payload).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/snapshot.json"):
                        body = json.dumps(
                            runtime.snapshot(), default=str
                        ).encode()
                        ctype = "application/json"
                        code = 200
                    else:
                        body = b"not found (try /metrics, /healthz, /snapshot.json)\n"
                        ctype = "text/plain"
                        code = 404
                except Exception:
                    logger.exception("telemetry endpoint %s failed", self.path)
                    body = b"internal error\n"
                    ctype = "text/plain"
                    code = 500
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (ConnectionError, OSError):
                    pass  # scraper went away mid-reply

        bind_host = (
            os.environ.get(TELEMETRY_HOST_ENV_VAR, "").strip()
            or DEFAULT_BIND_HOST
        )
        self.server = ThreadingHTTPServer(
            (bind_host, self.requested_port), Handler
        )
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self._server_thread = threading.Thread(
            target=self.server.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="telemetry-http",
            daemon=True,
        )
        self._server_thread.start()
        self.sampler.start()
        logger.info(
            "telemetry endpoint live on port %d (/metrics /healthz "
            "/snapshot.json)", self.port,
        )

    def stop(self) -> None:
        self.sampler.stop()
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None
        t = self._server_thread
        if t is not None:
            t.join(timeout=2.0)
        self._server_thread = None

    # -- endpoint payloads ---------------------------------------------

    def health(self) -> tuple:
        """(payload, status_code) for /healthz."""
        now = time.time()
        last = self.sampler.last_sample_ts
        stale = last is None or (now - last) > HEALTH_STALE_S
        fleet = fleet_view()
        computes = compute_progress()
        running = [c for c in computes if c.get("status") == "running"]
        status = "ok"
        if stale:
            status = "stale"
        elif fleet["workers_live"] and (
            fleet["workers_pressured"] * 2 >= fleet["workers_live"]
        ):
            status = "degraded"
        payload = {
            "status": status,
            "sampler_alive": self.sampler.alive,
            "last_sample_age_s": (
                round(now - last, 3) if last is not None else None
            ),
            "workers_live": fleet["workers_live"],
            "workers_pressured": fleet["workers_pressured"],
            "workers_disconnected": fleet["workers_disconnected"],
            "fleets": fleet["fleets"],
            "computes_running": len(running),
            "alerts_active": self.alert_engine.active(),
        }
        return payload, (503 if stale else 200)

    def snapshot(self) -> dict:
        """The /snapshot.json payload (also what the dashboard renders)."""
        return {
            "ts": time.time(),
            "port": self.port,
            "metrics": get_registry().snapshot(),
            "fleet": fleet_view(),
            "service": service_view(),
            "dispatch": dispatch_view(),
            "computes": compute_progress(),
            "alerts": self.alert_engine.recent(),
            "alerts_active": self.alert_engine.active(),
            "series": self.store.to_dict(window_s=300.0),
        }


# ----------------------------------------------------------------------
# arming (env > Spec > off), process-global singleton
# ----------------------------------------------------------------------

_runtime_lock = threading.Lock()
_runtime: Optional[TelemetryRuntime] = None


def resolve_port(spec=None) -> Optional[int]:
    """The effective telemetry port: ``CUBED_TPU_TORCH_TELEMETRY_PORT`` env var
    (operator override — ``off``/empty disables even a Spec-armed
    endpoint) > ``Spec(telemetry_port=...)`` > None (off). ``0`` means an
    ephemeral port. Malformed env values raise loudly — a typo silently
    disabling the operator's telemetry would be worse than an error."""
    raw = os.environ.get(TELEMETRY_PORT_ENV_VAR)
    if raw is not None:
        raw = raw.strip()
        if raw == "" or raw.lower() == "off":
            return None
        try:
            port = int(raw)
        except ValueError:
            raise ValueError(
                f"invalid {TELEMETRY_PORT_ENV_VAR}={raw!r}: expected an "
                "integer port (0 = ephemeral) or 'off'"
            )
        if port < 0 or port > 65535:
            raise ValueError(
                f"invalid {TELEMETRY_PORT_ENV_VAR}={raw!r}: port out of range"
            )
        return port
    port = getattr(spec, "telemetry_port", None)
    return None if port is None else int(port)


def get_runtime() -> Optional[TelemetryRuntime]:
    """The live runtime, or None while telemetry is unarmed."""
    return _runtime


def ensure_started(port: int) -> TelemetryRuntime:
    """Start (or return) the process-global telemetry runtime.

    Idempotent: the first call binds the endpoint and starts the sampler;
    later calls return the same runtime even if they ask for a different
    port (the endpoint is a process-level resource — one scrape target per
    process, logged when a conflicting port is requested)."""
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            if port not in (0, _runtime.requested_port, _runtime.port):
                logger.warning(
                    "telemetry already serving on port %s; ignoring "
                    "request for port %s (one endpoint per process)",
                    _runtime.port, port,
                )
            return _runtime
        rt = TelemetryRuntime(port)
        rt.start()
        _runtime = rt
        return rt


def maybe_start(spec=None) -> Optional[TelemetryRuntime]:
    """Arm telemetry for a compute when the resolved config asks for it.

    Called by ``Plan.execute``; returns the runtime (started now or
    earlier) or None when telemetry is off. Never raises for server
    trouble — a busy port must not fail a compute (it logs and runs
    unobserved instead). A malformed env config DOES raise
    (``resolve_port``): a typo silently disabling the operator's
    telemetry would be worse than an error."""
    port = resolve_port(spec)
    if port is None:
        return None
    try:
        return ensure_started(port)
    except OSError as e:
        logger.error(
            "telemetry endpoint failed to bind port %s (%s); compute "
            "proceeds without live telemetry", port, e,
        )
        return None


def shutdown() -> None:
    """Stop and discard the runtime (tests; normal processes let the
    daemon threads die with the interpreter)."""
    global _runtime
    with _runtime_lock:
        rt = _runtime
        _runtime = None
    if rt is not None:
        rt.stop()
