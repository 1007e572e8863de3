"""Read a flight-recorder bundle: ``python -m cubed_tpu_torch.diagnose <bundle>``.

Prints the post-mortem a human wants first: what failed (op + chunk +
error), the slowest ops, the top stragglers, the retry/quarantine/guard
decision timeline, and per-worker clock skew. The bundle is the directory
``FlightRecorder`` wrote (``bundle-<compute_id>/``). Counterpart of
``cubed_tpu/diagnose.py``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from .observability.flightrecorder import load_bundle


def _fmt_s(v) -> str:
    return f"{v:.3f}s" if isinstance(v, (int, float)) else "-"


def _section(title: str) -> str:
    return f"\n== {title} " + "=" * max(1, 60 - len(title))


#: decision kinds grouped into the timelines the report prints (every kind
#: here has a record_decision call site; fail-fasts are task_failed rows
#: with classification=fail_fast)
_TIMELINE_GROUPS = {
    "retries": ("retry", "requeue", "backup", "task_failed", "pool_rebuild"),
    "integrity": ("recompute", "quarantine"),
    "memory guard": ("admission_step_down", "admission_restore",
                     "guard_soft_exceeded", "device_memory"),
    "stragglers": ("straggler",),
    "scheduling": ("scheduler_mode", "dataflow_graph", "dispatch_early"),
    # the control plane's connection lifecycle: partitions, reconnects,
    # lease expiries, impostor rejections, and the drain/scale events that
    # change fleet membership
    "connectivity": ("worker_disconnected", "worker_reconnected",
                     "lease_expired", "worker_rejected",
                     "worker_drain_requested", "worker_draining",
                     "worker_drained", "scale_up", "scale_down",
                     "spawn_died", "coordinator_takeover"),
    # the p2p data plane: per-compute arming, locality-preferred
    # dispatches, and peer-fetch store fallbacks (runtime/transfer.py)
    "data movement": ("peer_transfer", "placement_locality",
                      "peer_fallback"),
    # seeded chaos: every fault the injector fired (runtime/faults.py) —
    # a repro bundle names what was injected, where, and when
    "injected faults": ("fault_injected",),
    # the live-telemetry alert engine's firings (observability/alerts.py);
    # the dedicated "alerts" section above prints the same rows with their
    # severities — this keeps them in timeline context with everything else
    "alerts": ("alert_fired",),
    # the overload ladder's transitions, what it shed at admission, the
    # per-tenant circuit breakers, and poison-request quarantines
    # (service/overload.py + the executors' quarantine path)
    "overload": ("overload_level", "request_shed", "tenant_breaker",
                 "poison_quarantine"),
}

#: the data-movement section's metric rows (manifest metrics snapshot);
#: printed only when the compute actually moved bytes peer-to-peer
_DATA_MOVEMENT_METRICS = (
    ("peer_hits", "reads served from a worker chunk cache (local or peer)"),
    ("peer_misses", "peer-path reads that went to the store"),
    ("peer_bytes_fetched", "bytes fetched worker-to-worker"),
    ("store_read_bytes_saved", "store read bytes the caches saved"),
    ("peer_fetch_fallbacks", "located fetches that fell back to the store"),
    ("peer_locate_requests", "chunk_locate RPCs answered"),
    ("placement_locality_hits", "dispatches placed for input locality"),
    ("cache_evictions", "worker cache evictions (LRU + pressure)"),
)


def _merge_intervals(intervals: list) -> list:
    """Coalesce [start, end) intervals into a sorted disjoint union."""
    out: list = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _intersection_s(a: list, b: list) -> float:
    """Total length of the intersection of two disjoint interval unions."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def op_overlap_rows(trace: Optional[dict]) -> list:
    """Per-op overlap with its predecessors, from the bundle's task spans.

    For each op (in first-task-start order): how long its tasks ran
    CONCURRENTLY with tasks of any earlier-starting op. Under the
    op-level scheduler this is ~0 by construction; under
    ``scheduler="dataflow"`` it is the barrier time the scheduler won
    back — the post-mortem proof the overlap actually happened."""
    events = [
        e for e in ((trace or {}).get("traceEvents") or [])
        if e.get("ph") == "X" and e.get("cat") == "task"
        and e.get("dur") is not None
    ]
    by_op: dict = {}
    for e in events:
        s = e["ts"] / 1e6
        by_op.setdefault(e.get("name"), []).append((s, s + e["dur"] / 1e6))
    order = sorted(by_op, key=lambda op: min(s for s, _ in by_op[op]))
    rows = []
    earlier: list = []
    for op in order:
        iv = _merge_intervals(by_op[op])
        busy = sum(e - s for s, e in iv)
        rows.append({
            "op": op,
            "tasks": len(by_op[op]),
            "busy_s": busy,
            "overlap_s": _intersection_s(iv, earlier),
        })
        earlier = _merge_intervals(earlier + iv)
    return rows


def render_report(bundle: dict, timeline_limit: int = 20) -> str:
    m = bundle["manifest"]
    out = []
    out.append(f"compute {m.get('compute_id')}  [{m.get('status')}]  "
               f"wall clock {_fmt_s(m.get('wall_clock_s'))}  "
               f"({m.get('created_at')})")

    err = m.get("error")
    if err:
        out.append(_section("failure"))
        if not isinstance(err, dict):
            # tolerate degenerate/older manifests that stored a bare string
            err = {"type": "error", "message": str(err)}
        where = ""
        if err.get("op") or err.get("chunk"):
            where = f" in op {err.get('op')} chunk {err.get('chunk')}"
        out.append(f"{err.get('type')}: {err.get('message')}{where}")
        failures = m.get("failing_tasks") or []
        for f in failures[-5:]:
            out.append(
                f"  task_failed op={f.get('op')} chunk={f.get('chunk')} "
                f"attempt={f.get('attempt')} error={f.get('error_type')}: "
                f"{str(f.get('error'))[:120]}"
            )

    ops = sorted(
        (m.get("op_wall_clock") or {}).items(),
        key=lambda kv: -(kv[1] or 0),
    )
    if ops:
        out.append(_section("slowest ops"))
        plan = {r.get("array_name"): r for r in (m.get("plan") or [])}
        for name, wall in ops[:10]:
            row = plan.get(name, {})
            util = row.get("projected_mem_utilization")
            out.append(
                f"  {name:<28} {_fmt_s(wall):>10}  tasks={row.get('num_tasks', '-'):<6} "
                f"projected_mem={row.get('projected_mem', '-')} "
                f"peak={row.get('peak_measured_mem', '-')}"
                + (f" ({util:.0%} of projection)" if util else "")
            )

    # bundles written before the live-telemetry layer existed carry no
    # "alerts"/"timeseries" keys at all — every section here treats a
    # missing artifact as empty, never as an error (regression-tested in
    # tests/observability/test_analytics.py)
    alerts = m.get("alerts") or []
    if alerts:
        from .observability.alerts import format_alert_row

        out.append(_section(f"alerts ({len(alerts)} fired)"))
        t0 = alerts[0].get("ts", 0)
        for a in alerts[-timeline_limit:]:
            out.append(
                f"  +{(a.get('ts', 0) - t0):8.3f}s {format_alert_row(a)}"
            )

    # per-tenant SLO posture at bundle time, from the bundled time-series
    # dump (the sampler publishes slo_* series whenever a service with SLO
    # specs is live) — last point per series, grouped by tenant
    slo_rows: dict = {}
    for s in m.get("timeseries") or []:
        name = s.get("name") or ""
        tenant = (s.get("labels") or {}).get("tenant")
        points = s.get("points") or []
        if name.startswith("slo_") and tenant and points:
            slo_rows.setdefault(tenant, {})[name] = points[-1][1]
    if slo_rows:
        out.append(_section("SLOs (at bundle time)"))
        for tenant, row in sorted(slo_rows.items()):
            budget = row.get("slo_budget_remaining")
            out.append(
                f"  {tenant:<20} budget "
                + (f"{budget:>6.0%}" if isinstance(budget, (int, float))
                   else "     -")
                + "  burn "
                + " ".join(
                    f"{w}={row[f'slo_burn_{w}']:.1f}"
                    for w in ("5m", "1h", "6h", "3d")
                    if isinstance(row.get(f"slo_burn_{w}"), (int, float))
                )
                + (
                    f"  p99 {_fmt_s(row.get('slo_request_latency_p99'))}"
                    if row.get("slo_request_latency_p99") is not None
                    else ""
                )
            )

    stragglers = m.get("stragglers") or []
    if stragglers:
        out.append(_section("top stragglers"))
        for s in stragglers:
            out.append(
                f"  {s.get('op')} chunk={s.get('chunk')} "
                f"{_fmt_s(s.get('duration_s'))} "
                f"({(s.get('factor') or 0):.1f}x op median "
                f"{_fmt_s(s.get('op_median_s'))}) on {s.get('worker')}"
            )

    overlap = op_overlap_rows(bundle.get("trace"))
    if len(overlap) >= 2:
        mode_rows = [
            d for d in (m.get("decisions") or [])
            if d.get("kind") == "scheduler_mode"
        ]
        mode = mode_rows[-1].get("mode") if mode_rows else None
        out.append(_section(
            "per-op overlap" + (f" (scheduler={mode})" if mode else "")
        ))
        total = 0.0
        for r in overlap:
            pct = r["overlap_s"] / r["busy_s"] if r["busy_s"] else 0.0
            total += r["overlap_s"]
            out.append(
                f"  {r['op']:<28} tasks={r['tasks']:<6} "
                f"busy {_fmt_s(r['busy_s']):>10}  "
                f"ran concurrently with predecessors "
                f"{_fmt_s(r['overlap_s'])} ({pct:.0%})"
            )
        out.append(
            f"  total cross-op overlap: {_fmt_s(total)}"
            + ("  (op barrier held: no overlap)" if total < 1e-6 else "")
        )

    metrics = m.get("metrics") or {}
    if any(metrics.get(name) for name, _ in _DATA_MOVEMENT_METRICS):
        out.append(_section("data movement (peer-to-peer)"))
        hits = metrics.get("peer_hits") or 0
        misses = metrics.get("peer_misses") or 0
        if hits or misses:
            out.append(
                f"  peer hit rate {hits / max(hits + misses, 1):.0%} "
                f"({hits} hits / {misses} store reads on the peer path)"
            )
        for name, caption in _DATA_MOVEMENT_METRICS:
            v = metrics.get(name)
            if v:
                out.append(f"  {name:<26} {v:>12}  {caption}")

    # chaos runs: the per-site injection counters, so the bundle states
    # up front how much seeded failure the compute absorbed (the per-event
    # detail follows in the "injected faults" timeline)
    if metrics.get("faults_injected"):
        out.append(_section(
            f"injected faults ({metrics['faults_injected']} total)"
        ))
        for name in sorted(metrics):
            if name.startswith("faults_injected_") and metrics[name]:
                out.append(
                    f"  {name[len('faults_injected_'):]:<26} "
                    f"{metrics[name]:>8}"
                )

    decisions = m.get("decisions") or []
    for title, kinds in _TIMELINE_GROUPS.items():
        rows = [d for d in decisions if d.get("kind") in kinds]
        if not rows:
            continue
        out.append(_section(f"{title} timeline ({len(rows)} events)"))
        t0 = rows[0].get("ts", 0)
        for d in rows[-timeline_limit:]:
            extra = " ".join(
                f"{k}={v}" for k, v in d.items()
                if k not in ("ts", "kind", "compute_id")
            )
            out.append(f"  +{(d.get('ts', 0) - t0):8.3f}s {d.get('kind'):<20} {extra}")

    prof = m.get("dispatch_profile")
    if prof:
        out.append(_section(
            f"dispatch (coordinator self-profile, {prof.get('samples', 0)} "
            f"samples @ {prof.get('hz', '?')}Hz)"
        ))
        for s in (prof.get("top_stacks") or [])[:8]:
            frac = s.get("fraction")
            frac_s = f"{frac:.0%}" if isinstance(frac, (int, float)) else "-"
            out.append(
                f"  {frac_s:>5} {s.get('thread')}: {s.get('leaf')}"
            )
        if prof.get("overflow"):
            out.append(
                f"  NOTE: {prof['overflow']} sample(s) beyond the "
                "folded-stack cap were counted but not retained"
            )
        out.append(
            f"  full collapsed stacks: profile-{m.get('compute_id')}.folded "
            "(feed to flamegraph.pl / speedscope)"
        )

    offsets = m.get("clock_offsets") or {}
    skewed = {k: v for k, v in offsets.items() if k != "client"}
    if skewed:
        out.append(_section("per-worker clock skew"))
        for name, row in sorted(skewed.items()):
            rtt = row.get("rtt")
            out.append(
                f"  {name:<20} offset {row.get('offset', 0):+0.6f}s "
                f"({row.get('source')})"
                + (f" rtt {rtt * 1e3:.1f}ms" if rtt else "")
            )

    trace = bundle.get("trace")
    if trace:
        n = len(trace.get("traceEvents") or [])
        out.append(_section("artifacts"))
        out.append(f"  trace.json: {n} events — open at https://ui.perfetto.dev")
        out.append(f"  logs.jsonl: {len(bundle.get('logs') or [])} structured records")
        series = m.get("timeseries")
        if series:
            npts = sum(len(s.get("points") or []) for s in series)
            out.append(
                f"  timeseries: {len(series)} series / {npts} points "
                "sampled over the compute window (manifest.json)"
            )
    dropped = m.get("task_records_dropped")
    if dropped:
        out.append(f"  NOTE: {dropped} task record(s) beyond the retention "
                   "bound were dropped; the trace is truncated")
    return "\n".join(out) + "\n"


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cubed_tpu_torch.diagnose", description=__doc__
    )
    parser.add_argument(
        "bundle", help="flight-recorder bundle directory (or its manifest.json)"
    )
    parser.add_argument(
        "--timeline-limit", type=int, default=20,
        help="max events shown per decision timeline (default 20)",
    )
    parser.add_argument(
        "--analyze", action="store_true",
        help="append the ANALYZE report: dependency-weighted critical "
        "path + wall-clock attribution (kernel/storage/peer/queue/retry/"
        "straggler buckets) from the bundle's trace",
    )
    parser.add_argument(
        "--history", default=None,
        help="run-history directory (runs.jsonl): append the REGRESSION "
        "section diffing this bundle's compute against its archived "
        "baseline (same plan fingerprint)",
    )
    args = parser.parse_args(argv)
    try:
        bundle = load_bundle(args.bundle)
    except (OSError, ValueError) as e:
        print(f"cannot read bundle {args.bundle!r}: {e}", file=sys.stderr)
        return 2
    sys.stdout.write(render_report(bundle, timeline_limit=args.timeline_limit))
    if args.analyze:
        from .observability.analytics import analyze

        sys.stdout.write(_section("analysis") + "\n")
        try:
            sys.stdout.write(analyze(bundle).render())
        except (ValueError, KeyError) as e:
            # an old/partial bundle (no trace.json, no task spans) still
            # renders the base report — analysis degrades with a note
            sys.stdout.write(f"analysis unavailable: {e}\n")
    if args.history:
        from .observability.analytics import regression_diff, render_regression
        from .observability.runhistory import find_baseline, load_runs

        sys.stdout.write(_section("regression") + "\n")
        records, _bad = load_runs(args.history)
        compute_id = (bundle.get("manifest") or {}).get("compute_id")
        current = next(
            (
                r for r in reversed(records)
                if r.get("kind") == "compute"
                and r.get("compute_id") == compute_id
            ),
            None,
        )
        baseline = find_baseline(
            records,
            current.get("fingerprint") if current else None,
            before_ts=current.get("ts") if current else None,
            exclude_compute_id=compute_id,
        ) if current else None
        if current is None or not current.get("buckets"):
            sys.stdout.write(
                f"no diffable archive record for {compute_id!r} under "
                f"{args.history!r}\n"
            )
        elif baseline is None:
            sys.stdout.write(
                "no comparable baseline in the archive (same fingerprint, "
                "earlier, OK, with a decomposition)\n"
            )
        else:
            sys.stdout.write(render_regression(
                regression_diff(baseline, current)
            ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
