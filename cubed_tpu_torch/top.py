"""Live fleet dashboard: ``python -m cubed_tpu_torch.top [host:port]``.

Renders the telemetry endpoint's ``/snapshot.json`` (armed via
``Spec(telemetry_port=...)`` or ``CUBED_TPU_TORCH_TELEMETRY_PORT``) as a
refreshing terminal view (counterpart of ``cubed_tpu/top.py``; the
TENANTS, COST and SLO panels read a live ``ComputeService``'s rows):

- a **fleet table** — one row per worker: connectivity, draining/
  pressured flags, RSS, load (outstanding/threads), lifetime tasks,
  peer-cache footprint and hit rate;
- a **COST panel** — per-tenant consumption when a multi-tenant service
  is live: task-seconds, store bytes read/written, peer bytes, retry
  draw (the service's ``_CostTracker`` fold, also exported as the
  ``tenant_cost_*`` series on ``/metrics``);
- a **DISPATCH panel** — the control plane's saturation flight deck:
  dispatch-loop utilization, estimated tasks/sec capacity, queue depth,
  cumulative serialize/send/lock-wait costs, and per-message-type frame
  counts on the coordinator link;
- **compute progress** — tasks done/total with a live task rate and ETA
  (rate from the ``compute_tasks_done`` series' trailing window);
- **recent alerts** — the alert engine's last firings, active ones
  flagged.

``--once`` prints a single refresh and exits (scripts, tests);
``--interval`` sets the refresh period; ``--snapshot <file>`` renders a
saved ``/snapshot.json`` offline (no live fleet needed) and exits. The
endpoint defaults to ``127.0.0.1:$CUBED_TPU_TORCH_TELEMETRY_PORT``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional
from urllib.request import urlopen

from .observability.alerts import format_alert_row
from .utils import memory_repr

#: ANSI clear-screen + cursor-home (suppressed when stdout is not a tty)
_CLEAR = "\x1b[2J\x1b[H"


def fetch_snapshot(endpoint: str, timeout: float = 5.0) -> dict:
    """GET ``http://<endpoint>/snapshot.json`` and parse it."""
    if "://" not in endpoint:
        endpoint = f"http://{endpoint}"
    with urlopen(f"{endpoint}/snapshot.json", timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _series_rate(snapshot: dict, name: str, labels: dict,
                 window_s: float = 30.0) -> Optional[float]:
    """Per-second rate of one dumped series over its trailing window."""
    for row in snapshot.get("series") or []:
        if row.get("name") != name or row.get("labels") != labels:
            continue
        pts = row.get("points") or []
        now = snapshot.get("ts") or time.time()
        pts = [p for p in pts if p[0] >= now - window_s]
        if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
            return None
        return max(0.0, (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0]))
    return None


def _fmt_mem(v) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    return memory_repr(int(v))


def _fmt_eta(seconds) -> str:
    if seconds is None or seconds != seconds or seconds < 0:
        return "-"
    seconds = int(seconds)
    if seconds >= 3600:
        return f"{seconds // 3600}h{(seconds % 3600) // 60:02d}m"
    if seconds >= 60:
        return f"{seconds // 60}m{seconds % 60:02d}s"
    return f"{seconds}s"


def _worker_hit_rate(row: dict) -> str:
    metrics = row.get("metrics") or {}
    hits = metrics.get("peer_hits") or 0
    misses = metrics.get("peer_misses") or 0
    if not hits and not misses:
        return "-"
    return f"{hits / (hits + misses):.0%}"


def render(snapshot: dict, width: int = 100) -> str:
    """One dashboard frame from a ``/snapshot.json`` payload."""
    out: list = []
    ts = snapshot.get("ts")
    stamp = (
        time.strftime("%H:%M:%S", time.localtime(ts))
        if isinstance(ts, (int, float)) else "-"
    )
    fleet = snapshot.get("fleet") or {}
    metrics = snapshot.get("metrics") or {}
    out.append(
        f"cubed_tpu_torch.top  {stamp}  epoch {fleet.get('epoch', 0)}  "
        f"workers {fleet.get('workers_live', 0)} "
        f"({fleet.get('workers_pressured', 0)} pressured, "
        f"{fleet.get('workers_disconnected', 0)} disconnected)  "
        f"tasks_completed {metrics.get('tasks_completed', 0)}  "
        f"alerts_fired {metrics.get('alerts_fired', 0)}"
    )
    out.append("=" * width)

    # -- deadlines / cancellation / store health -----------------------
    breaker = {0: "closed", 1: "half-open", 2: "OPEN"}.get(
        metrics.get("store_breaker_state"), "closed"
    )
    out.append(
        f"TIME & STORE  cancellations {metrics.get('cancellations', 0)}  "
        f"deadline_aborts {metrics.get('deadline_aborts', 0)}  "
        f"store_throttled {metrics.get('store_throttled', 0)}  "
        f"breaker {breaker}"
    )
    out.append("")

    # -- control plane: the dispatch-saturation flight deck ------------
    dispatch = snapshot.get("dispatch") or {}
    util = dispatch.get(
        "dispatch_utilization", metrics.get("dispatch_utilization")
    )
    if dispatch or util is not None:
        util_s = f"{util:.0%}" if isinstance(util, (int, float)) else "-"
        cap = dispatch.get(
            "dispatch_capacity_estimate",
            metrics.get("dispatch_capacity_estimate"),
        )
        cap_s = f"{cap:.0f}/s" if isinstance(cap, (int, float)) else "-"
        depth = metrics.get("queue_depth", 0)
        out.append(
            f"DISPATCH  utilization {util_s}  capacity ~{cap_s}  "
            f"queue_depth {depth}  "
            f"serialize {dispatch.get('dispatch_serialize_s', 0):.2f}s  "
            f"send {dispatch.get('dispatch_send_s', 0):.2f}s  "
            f"lock_wait {dispatch.get('dispatch_lock_wait_s', 0):.2f}s"
        )
        frames = dispatch.get("frames") or {}
        for direction in ("sent", "recv"):
            rows = frames.get(direction)
            if not rows:
                continue
            parts = [
                f"{mtype} {count} ({_fmt_mem(nbytes)})"
                for mtype, (count, nbytes) in sorted(
                    rows.items(), key=lambda kv: -kv[1][0]
                )[:5]
            ]
            out.append(f"  frames {direction}: " + "  ".join(parts))
        out.append("")

    # -- fleet table ---------------------------------------------------
    workers = (fleet.get("workers") or {})
    out.append(
        f"{'WORKER':<16}{'STATE':<14}{'EPOCH':>6}{'RSS':>10}{'LOAD':>8}"
        f"{'TASKS':>8}{'CACHE':>10}{'HIT%':>6}  CLOCK"
    )
    if not workers:
        out.append("  (no live workers — is a fleet running?)")
    for name in sorted(workers):
        row = workers[name]
        state = "up"
        if not row.get("connected", True):
            state = "disconnected"
        elif row.get("draining"):
            state = "draining"
        elif row.get("pressured"):
            state = "pressured"
        nthreads = row.get("nthreads") or 1
        load = f"{row.get('outstanding', 0)}/{nthreads}"
        cache = row.get("peer_cache") or {}
        off = row.get("clock_offset")
        clock = f"{off:+.3f}s" if isinstance(off, (int, float)) else "-"
        epoch = row.get("epoch")
        epoch_s = str(epoch) if isinstance(epoch, int) else "-"
        out.append(
            f"{name:<16}{state:<14}{epoch_s:>6}"
            f"{_fmt_mem(row.get('rss')):>10}"
            f"{load:>8}{row.get('tasks_sent', 0):>8}"
            f"{_fmt_mem(cache.get('bytes')):>10}"
            f"{_worker_hit_rate(row):>6}  {clock}"
        )
    out.append("")

    # -- tenants (multi-tenant service front door) ---------------------
    service = snapshot.get("service") or {}
    tenants = service.get("tenants") or {}
    overload = service.get("overload") or {}
    if overload.get("enabled") or overload.get("breakers_open"):
        level = overload.get("level", 0)
        name = overload.get("name", "normal")
        breakers = overload.get("breakers_open") or []
        out.append(
            f"OVERLOAD  L{level} ({name})  "
            f"shed {overload.get('requests_shed', 0)}  "
            f"transitions {overload.get('transitions', 0)}  "
            f"miss-rate {overload.get('miss_rate', 0.0):.0%}  "
            "breakers open "
            f"{','.join(breakers) if breakers else '-'}"
        )
        out.append("")
    if tenants:
        throttle = " THROTTLING" if service.get("throttling") else ""
        out.append(
            f"TENANTS  ({service.get('running', 0)} running / "
            f"{service.get('slots', '?')} slots, queue "
            f"{service.get('queue_depth', 0)}{throttle})"
        )
        out.append(
            f"{'TENANT':<16}{'WEIGHT':>7}{'QUEUED':>8}{'RUN':>5}"
            f"{'DONE':>7}{'FAIL':>6}{'CACHE%':>8}{'THROTTLED':>11}"
        )
        for name in sorted(tenants):
            row = tenants[name]
            done = row.get("completed") or 0
            hits = (
                (row.get("plan_cache_hits") or 0)
                + (row.get("result_cache_hits") or 0)
            )
            cache = f"{hits / done:.0%}" if done else "-"
            out.append(
                f"{name:<16}{row.get('weight', 1):>7.1f}"
                f"{row.get('queued', 0):>8}{row.get('running', 0):>5}"
                f"{done:>7}{row.get('failed', 0):>6}{cache:>8}"
                f"{row.get('throttled', 0):>11}"
            )
        out.append("")

        # -- per-tenant cost accounting --------------------------------
        costs = {
            name: row.get("cost")
            for name, row in tenants.items()
            if isinstance(row.get("cost"), dict)
        }
        if costs:
            out.append("COST  (per-tenant consumption, cumulative)")
            out.append(
                f"{'TENANT':<16}{'TASK-SEC':>10}{'READ':>11}"
                f"{'WRITTEN':>11}{'PEER':>11}{'RETRIES':>9}"
            )
            for name in sorted(costs):
                cost = costs[name]
                secs = cost.get("task_seconds")
                secs_s = (
                    f"{secs:.2f}" if isinstance(secs, (int, float)) else "-"
                )
                out.append(
                    f"{name:<16}{secs_s:>10}"
                    f"{_fmt_mem(cost.get('bytes_read')):>11}"
                    f"{_fmt_mem(cost.get('bytes_written')):>11}"
                    f"{_fmt_mem(cost.get('peer_bytes')):>11}"
                    f"{cost.get('retries', 0):>9}"
                )
            out.append("")

    # -- per-tenant SLOs (error budget + multi-window burn rates) ------
    slo = service.get("slo") or {}
    if slo:
        out.append("SLO  (error budget + burn rates; burn 1.0 = on pace)")
        out.append(
            f"{'TENANT':<16}{'OBJECTIVE':>16}{'P99':>9}{'GOOD%':>8}"
            f"{'BUDGET':>8}{'5m':>7}{'1h':>7}{'6h':>7}{'3d':>7}  STATE"
        )
        for name in sorted(slo):
            row = slo[name]
            spec_row = row.get("spec") or {}
            if spec_row.get("latency_s") is not None:
                objective = (
                    f"p{spec_row.get('latency_objective', 0) * 100:.0f}"
                    f"<{spec_row['latency_s']:g}s"
                )
            elif spec_row.get("availability_objective") is not None:
                objective = (
                    f"avail{spec_row['availability_objective'] * 100:g}%"
                )
            else:
                objective = "-"
            lat = row.get("latency") or {}
            p99 = lat.get("p99_s")
            p99_s = f"{p99:.3f}s" if isinstance(p99, (int, float)) else "-"
            good = row.get("good_fraction")
            good_s = f"{good:.1%}" if isinstance(good, (int, float)) else "-"
            budget = row.get("budget_remaining")
            budget_s = (
                f"{budget:.0%}" if isinstance(budget, (int, float)) else "-"
            )
            burn = row.get("burn") or {}

            def _b(k):
                v = burn.get(k)
                return f"{v:.1f}" if isinstance(v, (int, float)) else "-"

            state = "OK"
            if row.get("fast_burn"):
                state = "FAST BURN"
            elif row.get("slow_burn"):
                state = "SLOW BURN"
            out.append(
                f"{name:<16}{objective:>16}{p99_s:>9}{good_s:>8}"
                f"{budget_s:>8}{_b('5m'):>7}{_b('1h'):>7}{_b('6h'):>7}"
                f"{_b('3d'):>7}  {state}"
            )
        out.append("")

    # -- compute progress ----------------------------------------------
    out.append("COMPUTES")
    computes = snapshot.get("computes") or []
    if not computes:
        out.append("  (none tracked)")
    for row in computes[-5:]:
        done = row.get("tasks_done") or 0
        total = row.get("tasks_total") or 0
        # retries/backup twins can complete more attempts than the plan
        # has tasks: clamp so the bar (and percentage) never overflow
        frac = min(1.0, done / total) if total else 0.0
        bar_w = 24
        filled = min(bar_w, int(round(frac * bar_w)))
        bar = "#" * filled + "-" * (bar_w - filled)
        rate = _series_rate(
            snapshot, "compute_tasks_done",
            {"compute": row.get("compute_id")},
        )
        eta = None
        if rate and total:
            eta = (total - done) / rate
        status = row.get("status") or "?"
        line = (
            f"  {row.get('compute_id', '?'):<16}[{bar}] "
            f"{done}/{total} ({frac:.0%}) {status}"
        )
        if status == "running":
            line += (
                f"  {rate:.1f} tasks/s  ETA {_fmt_eta(eta)}"
                if rate else "  rate - ETA -"
            )
        out.append(line)
    out.append("")

    # -- alerts --------------------------------------------------------
    active = set(snapshot.get("alerts_active") or [])
    alerts = snapshot.get("alerts") or []
    out.append(f"ALERTS ({len(active)} active)")
    if not alerts:
        out.append("  (none fired)")
    for firing in alerts[-8:]:
        fts = firing.get("ts")
        fstamp = (
            time.strftime("%H:%M:%S", time.localtime(fts))
            if isinstance(fts, (int, float)) else "-"
        )
        flag = "*" if firing.get("rule") in active else " "
        out.append(f" {flag}{fstamp} {format_alert_row(firing)}")
    return "\n".join(out) + "\n"


def default_endpoint() -> str:
    port = os.environ.get("CUBED_TPU_TORCH_TELEMETRY_PORT", "").strip()
    if not port or port in ("0", "off"):
        port = "9090"
    return f"127.0.0.1:{port}"


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cubed_tpu_torch.top", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "endpoint", nargs="?", default=None,
        help="telemetry endpoint host:port (default "
        "127.0.0.1:$CUBED_TPU_TORCH_TELEMETRY_PORT)",
    )
    parser.add_argument(
        "--interval", type=float, default=2.0,
        help="refresh period in seconds (default 2)",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="render one frame and exit",
    )
    parser.add_argument(
        "--snapshot", metavar="FILE", default=None,
        help="render a saved /snapshot.json file offline and exit "
        "(no live endpoint needed — post-mortems, tests, CI)",
    )
    args = parser.parse_args(argv)
    if args.snapshot:
        try:
            with open(args.snapshot) as f:
                snapshot = json.load(f)
        except (OSError, ValueError) as e:
            print(
                f"cannot read snapshot file {args.snapshot!r}: {e}",
                file=sys.stderr,
            )
            return 2
        sys.stdout.write(render(snapshot))
        return 0
    endpoint = args.endpoint or default_endpoint()
    while True:
        try:
            snapshot = fetch_snapshot(endpoint)
        except Exception as e:
            print(
                f"cannot reach telemetry endpoint {endpoint}: {e}\n"
                "arm it with Spec(telemetry_port=...) or "
                "CUBED_TPU_TORCH_TELEMETRY_PORT on the client process",
                file=sys.stderr,
            )
            return 2
        frame = render(snapshot)
        if args.once:
            sys.stdout.write(frame)
            return 0
        sys.stdout.write((_CLEAR if sys.stdout.isatty() else "") + frame)
        sys.stdout.flush()
        try:
            time.sleep(max(0.2, args.interval))
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
