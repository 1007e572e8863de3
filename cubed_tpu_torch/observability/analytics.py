"""Compute analytics: EXPLAIN for plans, ANALYZE for finished computes.

The paper's promise is a *predicted* bound (projected memory, task counts)
and the stack records rich *measured* reality (clock-aligned task spans,
chunk-graph edges, per-worker series). This module joins the two into the
questions an operator actually asks:

- **EXPLAIN** (:func:`explain`, ``plan.explain()``, ``python -m
  cubed_tpu_torch.explain``) renders the finalized plan *before* execution:
  per-op task counts, projected memory against ``allowed_mem``, predicted
  bytes read/written (how many of those read bytes are peer-eligible —
  reads of intermediate arrays the p2p data plane can serve — and the
  predicted all-to-all shuffle volume of each rechunk stage when p2p is
  armed), the fusion outcome (ops before vs after optimization), and the
  scheduler/barrier decisions the dataflow scheduler would make
  (chunk-structured ops — blockwise AND rechunk — vs conservative
  op-level barriers, chunk-level edge count).

- **ANALYZE** (:func:`analyze`, ``python -m cubed_tpu_torch.diagnose <bundle>
  --analyze``) consumes a flight-recorder bundle (or a live
  ``TraceCollector``) and answers "where did the wall clock go": it walks
  the **critical path** — the dependency-weighted chain of task spans that
  gated the compute's end — using the chunk-level edges the dataflow
  scheduler recorded (``ChunkGraph.edges_by_key``), falling back to the
  op-level dependency skeleton, and decomposes the wall clock into
  attribution buckets::

      kernel | storage_read | storage_write | peer_fetch | shuffle
      | retry | ready_wait | dispatch_overhead | queue_wait
      | straggler_excess | uninstrumented | other

  The decomposition is exact by construction (segments tile the
  ``[compute start, compute end]`` interval), so the buckets always sum to
  the measured wall clock. When a task carries a dispatch ledger
  (per-task control-plane stamps on the task-stats channel), the
  pre-start gap splits into ``ready_wait`` (no worker capacity — real
  fleet backpressure) vs ``dispatch_overhead`` (the coordinator itself was
  busy serializing/sending — the scaling cliff); tasks without a ledger
  keep the whole gap in the legacy ``queue_wait`` bucket, so old traces
  analyze unchanged. The report also flags the top-k bottleneck
  tasks on the path and projected-vs-measured divergences (memory
  projections exceeded, wall-clock concentration far above an op's task
  share).

Counterpart of ``cubed_tpu/observability/analytics.py``. EXPLAIN's
peer-eligible and predicted shuffle bytes follow the fleet's peer data
plane (``runtime/transfer.py``) as a compute would arm it
(``Spec(peer_transfer=)``, ``CUBED_TPU_TORCH_P2P``, else on), as in the
reference. The compute service's per-tenant cost accounting
(``service/service.py``) folds the same task events. ANALYZE accepts the device executor's computes,
whose task spans are one per op covering its ``num_tasks`` tasks, as the
reference accepts its ``JaxExecutor``'s.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
from typing import Any, Callable, Dict, List, Optional

from ..utils import memory_repr

logger = logging.getLogger(__name__)

#: sub-span name -> attribution bucket. ``integrity_verify`` folds into
#: ``storage_read`` (it is part of the verified read path);
#: ``retry_sleep``/``recompute_repair`` both count as retry overhead;
#: ``shuffle_fetch`` (peer fetches inside a rechunk task's exchange
#: window — whole-chunk or sub-chunk ranged) gets its own ``shuffle``
#: bucket so the all-to-all's data movement is visible as such instead of
#: blending into generic peer/storage time.
SPAN_BUCKETS = {
    "kernel_apply": "kernel",
    "storage_read": "storage_read",
    "integrity_verify": "storage_read",
    "storage_write": "storage_write",
    "peer_fetch": "peer_fetch",
    "shuffle_fetch": "shuffle",
    "retry_sleep": "retry",
    "recompute_repair": "retry",
    # brownout time: waiting for a breaker IO slot + paced in-place
    # throttle retries (storage/health.py) — kept out of storage_read/
    # write so "the store was slow" and "the store told us to slow down"
    # are distinguishable in the attribution
    "throttle_wait": "throttle_wait",
}

#: every attribution bucket, in render order. ``ready_wait`` /
#: ``dispatch_overhead`` are the ledger-informed split of a task's
#: pre-start gap; ``queue_wait`` remains the undifferentiated gap for
#: tasks that shipped no dispatch ledger (old traces, local executors
#: without stamps)
BUCKETS = (
    "kernel", "storage_read", "storage_write", "peer_fetch", "shuffle",
    "retry", "throttle_wait", "ready_wait", "dispatch_overhead",
    "queue_wait", "straggler_excess", "uninstrumented", "other",
)

#: tasks at or below this duration are resume/cache-satisfied zero-width
#: intervals (chunk-granular resume marks them done without running
#: anything): excluded from op medians and per-op busy statistics, where
#: a flood of zeros would drag the median to ~0 and flag every REAL task
#: a straggler (see tests/observability/test_analytics.py)
_ZERO_WIDTH_S = 1e-6

#: straggler thresholds (match TraceCollector's live-watch defaults)
STRAGGLER_FACTOR = 3.0
STRAGGLER_MIN_S = 0.05

#: plan-row ``peak_measured_mem`` is VmHWM — the WHOLE process footprint,
#: not per-task attribution — so a memory divergence is only flagged when
#: the projection itself clears this floor (same rationale as the
#: aggregator's ``_MEM_OVER_NOISE_FLOOR``); the guard-attributed per-task
#: numbers (``mem_over_projected``) carry their own floor already
MEM_DIVERGENCE_FLOOR = 64 * 1024 * 1024


def _fmt_mem(v) -> str:
    if not isinstance(v, (int, float)) or not v:
        return "-"
    return memory_repr(int(v))


def _save_json(path: str, data: dict) -> str:
    """Atomic JSON dump shared by both report types."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, default=str)
    os.replace(tmp, path)
    return path


# ----------------------------------------------------------------------
# EXPLAIN
# ----------------------------------------------------------------------


class ExplainReport:
    """A finalized plan rendered as predictions: what will run, how much
    memory it is allowed to take, which bytes move where. ``str()`` /
    :meth:`render` give the human view, :meth:`to_dict` the JSON one,
    :meth:`save`/:meth:`load` round-trip it for the
    ``python -m cubed_tpu_torch.explain`` CLI."""

    def __init__(self, data: dict):
        self.data = data

    def to_dict(self) -> dict:
        return self.data

    def save(self, path: str) -> str:
        return _save_json(path, self.data)

    @classmethod
    def load(cls, path: str) -> "ExplainReport":
        with open(path) as f:
            return cls(json.load(f))

    def render(self) -> str:
        return render_explain(self.data)

    def __str__(self) -> str:
        return self.render()


def _op_source_arrays(dag, name: str, nodes: dict) -> list:
    """Array-node predecessors of an op (the arrays its tasks read)."""
    out = []
    for pred in dag.predecessors(name):
        d = nodes[pred]
        if d.get("type") == "array" and d.get("target") is not None:
            out.append((pred, d["target"]))
    return out


def _is_intermediate(dag, array_name: str, nodes: dict) -> bool:
    """True when the array is produced by a real op in this plan — the
    reads the p2p data plane can serve from worker chunk caches."""
    for producer in dag.predecessors(array_name):
        d = nodes[producer]
        if d.get("type") == "op" and d.get("primitive_op") is not None:
            return True
    return False


def explain_finalized(
    finalized, spec=None, ops_before: Optional[int] = None,
) -> ExplainReport:
    """Build an :class:`ExplainReport` from a ``FinalizedPlan``."""
    from ..runtime.dataflow import build_chunk_graph, resolve_scheduler
    from ..runtime.pipeline import iter_op_nodes
    from ..runtime.transfer import resolve_peer_transfer

    dag = finalized.dag
    nodes = dag.nodes
    scheduler = resolve_scheduler(spec)
    # the fleet's peer data plane, as a compute on it would arm it (env >
    # Spec > on): the bytes it could serve from peers' caches
    peer = resolve_peer_transfer(spec)

    graph = None
    try:
        graph = build_chunk_graph(dag)
    except Exception:
        logger.exception("explain: chunk-graph construction failed")
    barrier_ops = set(graph.barrier_ops) if graph is not None else set()
    op_kinds = graph.op_kind if graph is not None else {}
    n_edges = (
        sum(len(d) for d in graph.dependencies.values())
        if graph is not None else None
    )
    try:
        from ..primitive.blockwise import apply_blockwise
    except Exception:  # pragma: no cover - blockwise always importable
        apply_blockwise = None

    rows: List[dict] = []
    total_read = total_written = total_peer = total_shuffle = 0
    for name in dag.topological_sort():
        d = nodes[name]
        if d.get("type") != "op" or d.get("primitive_op") is None:
            continue
        op = d["primitive_op"]
        targets = op.target_arrays or (
            [op.target_array] if op.target_array is not None else []
        )
        bytes_written = sum(
            int(getattr(t, "nbytes", 0) or 0) for t in targets
        )
        bytes_read = peer_eligible = 0
        for arr_name, target in _op_source_arrays(dag, name, nodes):
            nbytes = int(getattr(target, "nbytes", 0) or 0)
            bytes_read += nbytes
            if _is_intermediate(dag, arr_name, nodes):
                peer_eligible += nbytes
        pipeline = op.pipeline
        # the chunk graph's own classification when it built (rechunk is
        # chunk-structured via its shuffle edges); the blockwise check is
        # only the degraded fallback for an unbuildable graph
        kind = op_kinds.get(name)
        if kind is not None:
            structured = kind != "barrier"
        else:
            structured = (
                pipeline is not None
                and apply_blockwise is not None
                and pipeline.function is apply_blockwise
            )
        #: predicted all-to-all exchange volume of a rechunk stage — its
        #: INTERMEDIATE source bytes, i.e. what the peer data plane can
        #: actually route worker-to-worker when armed (a first stage
        #: reading a client-written source array still reads the store,
        #: so counting it would fake a predicted-vs-measured gap)
        shuffle_bytes = (
            peer_eligible
            if peer and kind == "rechunk" else 0
        )
        rows.append({
            "op": name,
            "kind": d.get("op_name") or "",
            "tasks": op.num_tasks,
            "projected_mem": op.projected_mem,
            "allowed_mem": op.allowed_mem,
            "bytes_written": bytes_written,
            "bytes_read": bytes_read,
            "peer_eligible_bytes": peer_eligible if peer else 0,
            "shuffle_bytes": shuffle_bytes,
            "chunk_structured": structured,
            "barrier": name in barrier_ops,
        })
        total_read += bytes_read
        total_written += bytes_written
        total_shuffle += shuffle_bytes
        if peer:
            total_peer += peer_eligible
    n_ops = sum(1 for _ in iter_op_nodes(dag))
    # the create-arrays metadata bootstrap is injected at finalization, so
    # it must not read as "fusion added an op" in the before/after diff
    n_real_ops = sum(
        1 for name, _ in iter_op_nodes(dag) if name != "create-arrays"
    )

    allowed = getattr(spec, "allowed_mem", None)
    if allowed is None:
        allowed = max((r["allowed_mem"] for r in rows), default=0)
    data = {
        "kind": "explain",
        "scheduler": scheduler,
        "peer_transfer": bool(peer),
        "ops": rows,
        "totals": {
            "ops": n_ops,
            "arrays": finalized.num_arrays(),
            "tasks": finalized.num_tasks(),
            "max_projected_mem": finalized.max_projected_mem(),
            "allowed_mem": allowed,
            "bytes_written": total_written,
            "bytes_read": total_read,
            "peer_eligible_bytes": total_peer,
            "predicted_shuffle_bytes": total_shuffle,
        },
        "barriers": {
            "ops": sorted(barrier_ops),
            "chunk_edges": n_edges,
        },
        "fusion": (
            {"ops_before": ops_before, "ops_after": n_real_ops}
            if ops_before is not None else None
        ),
    }
    return ExplainReport(data)


def explain(
    plan, spec=None, optimize_graph: bool = True,
    optimize_function: Optional[Callable] = None,
    array_names: Optional[tuple] = None,
) -> ExplainReport:
    """EXPLAIN a :class:`~cubed_tpu_torch.core.plan.Plan` (or an already
    finalized one): finalize it exactly like ``execute`` would and report
    the predictions — see the module docstring."""
    if hasattr(plan, "_finalize"):
        from ..runtime.pipeline import iter_op_nodes

        ops_before = sum(1 for _ in iter_op_nodes(plan.dag))
        finalized = plan._finalize(
            optimize_graph, optimize_function, array_names
        )
        return explain_finalized(finalized, spec=spec, ops_before=ops_before)
    return explain_finalized(plan, spec=spec)


def render_explain(data: dict) -> str:
    """The human EXPLAIN view (what the CLI prints)."""
    out: List[str] = []
    totals = data.get("totals") or {}
    out.append(
        f"EXPLAIN  {totals.get('ops', '?')} ops / "
        f"{totals.get('arrays', '?')} arrays / "
        f"{totals.get('tasks', '?')} tasks   scheduler="
        f"{data.get('scheduler')}  peer_transfer="
        f"{'on' if data.get('peer_transfer') else 'off'}"
    )
    proj = totals.get("max_projected_mem")
    allowed = totals.get("allowed_mem")
    frac = (
        f" ({proj / allowed:.0%} of allowed_mem)"
        if isinstance(proj, (int, float)) and allowed else ""
    )
    shuffle_total = totals.get("predicted_shuffle_bytes")
    out.append(
        f"projected mem {_fmt_mem(proj)} vs allowed {_fmt_mem(allowed)}"
        f"{frac}; predicted IO: read {_fmt_mem(totals.get('bytes_read'))}, "
        f"write {_fmt_mem(totals.get('bytes_written'))}, peer-eligible "
        f"{_fmt_mem(totals.get('peer_eligible_bytes'))}"
        + (
            f", shuffle {_fmt_mem(shuffle_total)}"
            if shuffle_total else ""
        )
    )
    fusion = data.get("fusion")
    if fusion and fusion.get("ops_before") is not None:
        before, after = fusion["ops_before"], fusion["ops_after"]
        out.append(
            f"fusion: {before} op(s) before optimization -> {after} after"
            + (
                f" ({before - after} fused away)"
                if isinstance(before, int) and isinstance(after, int)
                and before > after else ""
            )
        )
    barriers = data.get("barriers") or {}
    edges = barriers.get("chunk_edges")
    if edges is not None:
        bops = barriers.get("ops") or []
        out.append(
            f"dataflow: {edges} chunk-level edge(s); "
            + (
                f"{len(bops)} op-level barrier(s): {', '.join(bops[:6])}"
                + ("..." if len(bops) > 6 else "")
                if bops else "no op-level barriers"
            )
        )
    out.append("")
    out.append(
        f"{'OP':<30}{'KIND':<16}{'TASKS':>7}{'PROJ MEM':>11}"
        f"{'READ':>11}{'WRITE':>11}  SCHED"
    )
    for r in data.get("ops") or []:
        sched = "barrier" if r.get("barrier") else (
            "chunked" if r.get("chunk_structured") else "op-level"
        )
        out.append(
            f"{r.get('op', '?'):<30}{(r.get('kind') or ''):<16}"
            f"{r.get('tasks', 0):>7}{_fmt_mem(r.get('projected_mem')):>11}"
            f"{_fmt_mem(r.get('bytes_read')):>11}"
            f"{_fmt_mem(r.get('bytes_written')):>11}  {sched}"
        )
    return "\n".join(out) + "\n"


# ----------------------------------------------------------------------
# ANALYZE
# ----------------------------------------------------------------------


class AnalysisReport:
    """Post-compute wall-clock attribution + critical path. ``str()`` /
    :meth:`render` give the human view, :meth:`to_dict` the JSON one."""

    def __init__(self, data: dict):
        self.data = data

    def to_dict(self) -> dict:
        return self.data

    @property
    def wall_clock_s(self) -> Optional[float]:
        return self.data.get("wall_clock_s")

    @property
    def attribution(self) -> dict:
        return self.data.get("attribution") or {}

    @property
    def critical_path(self) -> list:
        return self.data.get("critical_path") or []

    @property
    def bottlenecks(self) -> list:
        return self.data.get("bottlenecks") or []

    def save(self, path: str) -> str:
        return _save_json(path, self.data)

    def render(self) -> str:
        return render_analysis(self.data)

    def __str__(self) -> str:
        return self.render()


def _trace_tables(trace: dict) -> tuple:
    """Parse a chrome trace into (tasks, spans, lanes, bounds).

    Timestamps come back in *seconds* on the trace's own (relative)
    timeline; ``bounds`` is the compute span when present, else the task
    envelope."""
    events = (trace or {}).get("traceEvents") or []
    lanes: Dict[int, str] = {}
    tasks: List[dict] = []
    spans: List[dict] = []
    compute_bounds = None
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            lanes[e.get("tid")] = (e.get("args") or {}).get("name")
            continue
        if e.get("ph") != "X" or e.get("dur") is None:
            continue
        args = e.get("args") or {}
        start = e["ts"] / 1e6
        end = start + e["dur"] / 1e6
        cat = e.get("cat")
        if cat == "compute":
            compute_bounds = (start, end)
        elif cat == "task":
            tasks.append({
                "op": e.get("name"),
                "chunk": args.get("chunk"),
                "start": start,
                "end": end,
                "dur": end - start,
                "tid": e.get("tid"),
                "attempt": args.get("attempt") or 0,
                "error": bool(args.get("error")),
                # the control-plane dispatch ledger, when one rode the
                # task event (collect.merged_tracer attaches it)
                "dispatch": args.get("dispatch"),
            })
        elif cat in (
            "storage", "kernel", "integrity", "retry", "transfer",
            "repair", "span",
        ):
            spans.append({
                "name": e.get("name"),
                "start": start,
                "end": end,
                "tid": e.get("tid"),
                "chunk": args.get("chunk_of_task"),
            })
    if compute_bounds is None and tasks:
        compute_bounds = (
            min(t["start"] for t in tasks), max(t["end"] for t in tasks)
        )
    return tasks, spans, lanes, compute_bounds


def _attach_spans(tasks: List[dict], spans: List[dict]) -> None:
    """Associate sub-spans with their task record: same lane (tid), the
    task's chunk key, and time containment (small epsilon for clock
    granularity). Each task gains a ``"spans"`` list."""
    eps = 2e-3
    index: Dict[tuple, List[dict]] = {}
    for t in tasks:
        t["spans"] = []
        index.setdefault((t["tid"], t["chunk"]), []).append(t)
    for s in spans:
        candidates = index.get((s["tid"], s["chunk"]))
        if not candidates:
            continue
        best = None
        for t in candidates:
            if s["start"] >= t["start"] - eps and s["end"] <= t["end"] + eps:
                if best is None or t["dur"] < best["dur"]:
                    best = t  # smallest containing task (retried chunks)
        if best is not None:
            best["spans"].append(s)


def _op_medians(tasks: List[dict]) -> Dict[str, float]:
    by_op: Dict[str, List[float]] = {}
    for t in tasks:
        if t["dur"] <= _ZERO_WIDTH_S:
            # resume/cache-satisfied zero-width interval: not a real
            # execution — letting it into the median would drag an op's
            # baseline toward zero and mark every genuine task a straggler
            continue
        by_op.setdefault(t["op"], []).append(t["dur"])
    return {
        op: statistics.median(durs) for op, durs in by_op.items() if durs
    }


def _is_straggler(t: dict, medians: Dict[str, float]) -> bool:
    median = medians.get(t["op"])
    if median is None:
        return False
    return t["dur"] > max(STRAGGLER_MIN_S, STRAGGLER_FACTOR * median)


def _interior_buckets(t: dict) -> Dict[str, float]:
    """A task's instrumented interior: seconds per bucket from its
    sub-spans, clipped so their total never exceeds the task duration."""
    out: Dict[str, float] = {}
    for s in t.get("spans") or []:
        bucket = SPAN_BUCKETS.get(s["name"])
        if bucket is None:
            continue
        out[bucket] = out.get(bucket, 0.0) + max(0.0, s["end"] - s["start"])
    total = sum(out.values())
    if total > t["dur"] > 0:
        scale = t["dur"] / total
        out = {k: v * scale for k, v in out.items()}
    return out


def _critical_path(
    tasks: List[dict],
    chunk_edges: Optional[dict],
    op_graph: Optional[dict],
) -> tuple:
    """Walk backwards from the last-finishing task through its gating
    dependencies. Returns ``(chain oldest-first, source)`` where source
    names which edge set drove the walk."""
    completed = [t for t in tasks if not t["error"]]
    if not completed:
        return [], "none"
    # one record per (op, chunk): the FIRST successful completion is the
    # one that released dependents
    by_key: Dict[str, dict] = {}
    for t in completed:
        key = f"{t['op']}\t{t['chunk']}"
        prev = by_key.get(key)
        if prev is None or t["end"] < prev["end"]:
            by_key[key] = t
    by_op: Dict[str, List[dict]] = {}
    for t in by_key.values():
        by_op.setdefault(t["op"], []).append(t)

    source = "heuristic"
    if chunk_edges:
        source = "chunk_graph"
    elif op_graph:
        source = "op_graph"

    def gate_of(t: dict) -> Optional[dict]:
        key = f"{t['op']}\t{t['chunk']}"
        if chunk_edges is not None and key in chunk_edges:
            deps = [
                by_key[k] for k in chunk_edges[key] if k in by_key
            ]
            if deps:
                return max(deps, key=lambda d: d["end"])
            return None  # a source task: the chain head
        if op_graph:
            preds = op_graph.get(t["op"]) or []
            deps = [d for p in preds for d in by_op.get(p, [])]
            if deps:
                return max(deps, key=lambda d: d["end"])
            if t["op"] in op_graph:
                return None  # known source op
        # heuristic: the latest task that finished before this one started
        candidates = [
            c for c in by_key.values()
            if c is not t and c["end"] <= t["start"] + 1e-9
        ]
        if not candidates:
            return None
        return max(candidates, key=lambda c: c["end"])

    last = max(by_key.values(), key=lambda t: t["end"])
    chain = [last]
    seen = {id(last)}
    cur = last
    while True:
        gate = gate_of(cur)
        if gate is None or id(gate) in seen:
            break
        chain.append(gate)
        seen.add(id(gate))
        cur = gate
    chain.reverse()
    return chain, source


def _decompose(
    chain: List[dict], bounds: tuple, medians: Dict[str, float],
) -> tuple:
    """Tile ``[t_start, t_end]`` with the chain's segments and attribute
    each to a bucket. Returns ``(attribution, path_rows)``; the buckets
    sum to the wall clock exactly (segments partition the interval)."""
    t_start, t_end = bounds
    attribution = {b: 0.0 for b in BUCKETS}
    rows: List[dict] = []
    cursor = t_start
    for t in chain:
        queue_wait = max(0.0, t["start"] - cursor)
        # ledger-informed split of the pre-start gap: the coordinator's
        # measured per-task cost (submit_cost_s wraps the whole inline
        # Coordinator.submit; serialize/send/lock-wait are its pieces) is
        # dispatch_overhead, the remainder is ready_wait — genuine fleet
        # backpressure. No ledger -> the whole gap stays queue_wait.
        disp = t.get("dispatch") or None
        dispatch_cost = None
        if disp:
            dispatch_cost = disp.get("submit_cost_s")
            if dispatch_cost is None:
                parts = [
                    disp.get(k)
                    for k in ("serialize_s", "send_s", "lock_wait_s")
                ]
                parts = [
                    p for p in parts if isinstance(p, (int, float))
                ]
                dispatch_cost = sum(parts) if parts else None
        if dispatch_cost is not None:
            dispatch_overhead = min(queue_wait, max(0.0, dispatch_cost))
            ready_wait = queue_wait - dispatch_overhead
            attribution["dispatch_overhead"] += dispatch_overhead
            attribution["ready_wait"] += ready_wait
        else:
            dispatch_overhead = ready_wait = None
            attribution["queue_wait"] += queue_wait
        eff_start = max(t["start"], cursor)
        counted = max(0.0, min(t["end"], t_end) - eff_start)
        scale = (counted / t["dur"]) if t["dur"] > 0 else 0.0
        interior = {
            k: v * scale for k, v in _interior_buckets(t).items()
        }
        uninstrumented = max(0.0, counted - sum(interior.values()))
        buckets = dict(interior)
        buckets["uninstrumented"] = uninstrumented
        straggler = _is_straggler(t, medians)
        excess = 0.0
        if straggler:
            median = medians.get(t["op"]) or 0.0
            excess = min(counted, max(0.0, t["dur"] - median) * scale)
            # carve the excess out of the largest interior buckets — for a
            # sleeping/overloaded task that time sits inside kernel_apply
            # (or uninstrumented), and reporting it as normal kernel time
            # would hide exactly the signal ANALYZE exists to surface
            remaining = excess
            for k in sorted(buckets, key=lambda k: -buckets[k]):
                take = min(buckets[k], remaining)
                buckets[k] -= take
                remaining -= take
                if remaining <= 1e-12:
                    break
            buckets["straggler_excess"] = excess - remaining
        for k, v in buckets.items():
            attribution[k] = attribution.get(k, 0.0) + v
        row = {
            "op": t["op"],
            "chunk": t["chunk"],
            "worker": t.get("worker"),
            "start_s": round(t["start"] - t_start, 6),
            "duration_s": round(t["dur"], 6),
            # queue_wait_s is always the FULL pre-start gap (bottleneck
            # ranking keys on it regardless of whether a ledger split it)
            "queue_wait_s": round(queue_wait, 6),
            "straggler": straggler,
            "straggler_excess_s": round(excess, 6) if straggler else 0.0,
            "buckets": {k: round(v, 6) for k, v in buckets.items() if v},
        }
        if dispatch_overhead is not None:
            row["dispatch_overhead_s"] = round(dispatch_overhead, 6)
            row["ready_wait_s"] = round(ready_wait, 6)
        rows.append(row)
        cursor = max(cursor, t["end"])
    attribution["other"] += max(0.0, t_end - cursor)
    return {k: round(v, 6) for k, v in attribution.items()}, rows


def _per_op_rows(
    tasks: List[dict], medians: Dict[str, float], manifest: dict,
) -> Dict[str, dict]:
    """Busy-time attribution over ALL completed tasks, per op (the
    whole-fleet view beside the critical path's wall-clock view)."""
    per_op: Dict[str, dict] = {}
    op_wall = manifest.get("op_wall_clock") or {}
    for t in tasks:
        if t["error"] or t["dur"] <= _ZERO_WIDTH_S:
            # zero-width (resume-satisfied) intervals carry no busy time
            # and no spans: keep them out of the bucket statistics
            continue
        row = per_op.setdefault(t["op"], {
            "tasks": 0, "busy_s": 0.0, "stragglers": 0,
            "buckets": {},
        })
        row["tasks"] += 1
        row["busy_s"] += t["dur"]
        if _is_straggler(t, medians):
            row["stragglers"] += 1
        for k, v in _interior_buckets(t).items():
            row["buckets"][k] = row["buckets"].get(k, 0.0) + v
    for op, row in per_op.items():
        interior = sum(row["buckets"].values())
        row["buckets"]["uninstrumented"] = max(
            0.0, row["busy_s"] - interior
        )
        row["buckets"] = {
            k: round(v, 6) for k, v in row["buckets"].items() if v
        }
        row["busy_s"] = round(row["busy_s"], 6)
        row["wall_clock_s"] = op_wall.get(op)
    return per_op


def _divergences(
    manifest: dict, per_op: Dict[str, dict], explain_data: Optional[dict],
) -> List[dict]:
    """Projected-vs-measured gaps worth a look."""
    out: List[dict] = []
    stats = manifest.get("executor_stats") or {}
    stats_per_op = stats.get("per_op") or {}
    for row in manifest.get("plan") or []:
        name = row.get("array_name")
        util = row.get("projected_mem_utilization")
        projected = row.get("projected_mem") or 0
        if (
            isinstance(util, (int, float)) and util > 1.0
            and projected > MEM_DIVERGENCE_FLOOR
        ):
            out.append({
                "op": name,
                "kind": "memory",
                "note": (
                    f"measured peak {_fmt_mem(row.get('peak_measured_mem'))}"
                    f" exceeded projection "
                    f"{_fmt_mem(row.get('projected_mem'))} "
                    f"({util:.0%} utilization)"
                ),
            })
    for name, row in stats_per_op.items():
        if row.get("mem_over_projected"):
            out.append({
                "op": name,
                "kind": "memory",
                "note": (
                    f"guard-attributed peak "
                    f"{_fmt_mem(row.get('guard_peak_mem'))} over projection "
                    f"{_fmt_mem(row.get('projected_mem'))}"
                ),
            })
    total_busy = sum(r["busy_s"] for r in per_op.values()) or 0.0
    total_tasks = sum(r["tasks"] for r in per_op.values()) or 0
    if total_busy and total_tasks:
        for name, row in per_op.items():
            busy_share = row["busy_s"] / total_busy
            task_share = row["tasks"] / total_tasks
            if busy_share > 2.0 * task_share and row["busy_s"] > 0.5:
                out.append({
                    "op": name,
                    "kind": "wall_clock",
                    "note": (
                        f"{busy_share:.0%} of busy time from "
                        f"{task_share:.0%} of tasks"
                        + (
                            f" ({row['stragglers']} straggler(s))"
                            if row["stragglers"] else ""
                        )
                    ),
                })
    if explain_data:
        predicted = {
            r["op"]: r for r in (explain_data.get("ops") or [])
        }
        for name, row in stats_per_op.items():
            pred = predicted.get(name)
            if not pred:
                continue
            pb, mb = pred.get("bytes_written"), row.get("bytes_written")
            if pb and mb and (mb > 2 * pb or mb * 2 < pb):
                out.append({
                    "op": name,
                    "kind": "bytes",
                    "note": (
                        f"measured write {_fmt_mem(mb)} vs predicted "
                        f"{_fmt_mem(pb)}"
                    ),
                })
    return out


def _looks_like_bundle(obj: Any) -> bool:
    return isinstance(obj, dict) and "manifest" in obj


def _collector_bundle(collector) -> dict:
    """An in-memory bundle from a live ``TraceCollector`` (or subclass):
    ANALYZE without ever touching disk."""
    if hasattr(collector, "manifest"):
        manifest = collector.manifest()
    else:
        from .collect import decisions_since

        manifest = {
            "compute_id": collector.compute_id,
            "status": (
                "failed" if collector.error is not None else "succeeded"
            ),
            "wall_clock_s": (
                collector.end_tstamp - collector.start_tstamp
                if collector.end_tstamp and collector.start_tstamp
                else None
            ),
            "op_wall_clock": {
                name: t.wall_clock
                for name, t in collector.op_timings.items()
            },
            "plan": collector.projected_vs_measured(),
            "executor_stats": collector.executor_stats,
            "stragglers": collector.stragglers(),
            "op_graph": collector.op_graph(),
            "chunk_graph": collector.chunk_graph(),
            "decisions": decisions_since(collector._t0),
        }
    return {
        "manifest": manifest,
        "trace": {
            "traceEvents": collector.merged_tracer().chrome_events()
        },
    }


def _resolve_target(target, bundle_dir: Optional[str]) -> dict:
    """Turn any accepted ``analyze`` target into a bundle dict."""
    from .flightrecorder import FLIGHT_RECORDER_ENV_VAR, load_bundle

    if _looks_like_bundle(target):
        return target
    if hasattr(target, "merged_tracer"):
        return _collector_bundle(target)
    if isinstance(target, str):
        if os.path.exists(target):
            return load_bundle(target)
        # a compute id: find its bundle under bundle_dir / the operator's
        # flight-recorder dir / the conventional default
        for base in (
            bundle_dir,
            os.environ.get(FLIGHT_RECORDER_ENV_VAR),
            "flight-recorder",
        ):
            if not base:
                continue
            candidate = os.path.join(base, f"bundle-{target}")
            if os.path.exists(candidate):
                return load_bundle(candidate)
        raise FileNotFoundError(
            f"no bundle found for {target!r} (looked for a path and for "
            f"bundle-{target} under the flight-recorder directories)"
        )
    raise TypeError(
        f"analyze() expects a bundle dir/path, a compute id, a loaded "
        f"bundle dict, or a TraceCollector — got {type(target).__name__}"
    )


def analyze(
    target,
    bundle_dir: Optional[str] = None,
    explain_report: Optional[ExplainReport] = None,
    top_k: int = 5,
    baseline=None,
) -> AnalysisReport:
    """ANALYZE a finished compute: critical path + wall-clock attribution.

    ``target`` may be a flight-recorder bundle directory (or its
    ``manifest.json``), a compute id (searched under ``bundle_dir``, the
    ``CUBED_TPU_TORCH_FLIGHT_RECORDER`` directory, then ``./flight-recorder``),
    an already-loaded bundle dict, or a live
    :class:`~cubed_tpu_torch.observability.collect.TraceCollector` /
    ``FlightRecorder``. Pass the plan's :class:`ExplainReport` as
    ``explain_report`` to also diff predicted bytes against measured.

    ``baseline`` (a run-history compute record from
    :func:`~cubed_tpu_torch.observability.runhistory.load_runs` /
    ``find_baseline``, or a prior :class:`AnalysisReport` / its data
    dict) adds a ``regression`` section: the bucket-by-bucket and per-op
    diff against that earlier run of the same plan
    (:func:`regression_diff`).
    """
    bundle = _resolve_target(target, bundle_dir)
    manifest = bundle.get("manifest") or {}
    trace = bundle.get("trace")
    if not trace or not (trace.get("traceEvents") or []):
        raise ValueError(
            "bundle has no trace (trace.json missing or empty) — ANALYZE "
            "needs the merged task spans; attach a TraceCollector or "
            "FlightRecorder to the compute"
        )
    tasks, spans, lanes, bounds = _trace_tables(trace)
    if not tasks or bounds is None:
        raise ValueError("trace contains no task spans to analyze")
    for t in tasks:
        lane = lanes.get(t["tid"]) or ""
        t["worker"] = lane.replace("worker ", "") if lane.startswith(
            "worker "
        ) else None
    _attach_spans(tasks, spans)
    medians = _op_medians([t for t in tasks if not t["error"]])

    chunk_edges = manifest.get("chunk_graph") or None
    op_graph = manifest.get("op_graph") or None
    chain, source = _critical_path(tasks, chunk_edges, op_graph)
    attribution, path_rows = _decompose(chain, bounds, medians)
    wall = bounds[1] - bounds[0]
    covered = sum(attribution.values())
    per_op = _per_op_rows(tasks, medians, manifest)
    bottlenecks = sorted(
        path_rows,
        key=lambda r: -(r["queue_wait_s"] + r["duration_s"]),
    )[:top_k]

    data = {
        "kind": "analysis",
        "compute_id": manifest.get("compute_id"),
        "status": manifest.get("status"),
        "wall_clock_s": round(wall, 6),
        "attribution": attribution,
        "attribution_coverage": round(covered / wall, 4) if wall else None,
        "critical_path": path_rows,
        "critical_path_source": source,
        "bottlenecks": bottlenecks,
        "per_op": per_op,
        "divergences": _divergences(
            manifest, per_op,
            explain_report.to_dict() if explain_report else None,
        ),
        "stragglers": manifest.get("stragglers") or [],
        "tasks_analyzed": len(tasks),
    }
    if baseline is not None:
        data["regression"] = regression_diff(baseline, data)
    return AnalysisReport(data)


# ----------------------------------------------------------------------
# cross-run regression attribution
# ----------------------------------------------------------------------

#: a run is only called regressed when it is at least this much slower
#: than its baseline — sub-10% wall-clock wiggle is scheduling noise on
#: small computes, not a regression worth naming
REGRESSION_RATIO = 1.10


def _normalize_run(obj) -> Dict[str, Any]:
    """One shape for both comparands: ``{compute_id, ts, wall_clock_s,
    buckets, per_op}``. Accepts a run-history compute record (``buckets``
    / ``per_op`` keys), an :class:`AnalysisReport`, or its data dict
    (``attribution`` / ``per_op`` keys)."""
    if isinstance(obj, AnalysisReport):
        obj = obj.to_dict()
    if not isinstance(obj, dict):
        raise TypeError(
            "regression comparand must be a run-history record, an "
            f"AnalysisReport, or its data dict — got {type(obj).__name__}"
        )
    buckets = obj.get("buckets")
    if buckets is None:
        buckets = obj.get("attribution") or {}
    per_op = {}
    for name, row in (obj.get("per_op") or {}).items():
        if isinstance(row, dict):
            per_op[name] = {
                "busy_s": float(row.get("busy_s") or 0.0),
                "buckets": {
                    k: float(v)
                    for k, v in (row.get("buckets") or {}).items()
                    if isinstance(v, (int, float))
                },
            }
    return {
        "compute_id": obj.get("compute_id"),
        "ts": obj.get("ts"),
        "wall_clock_s": obj.get("wall_clock_s"),
        "buckets": {
            k: float(v) for k, v in buckets.items()
            if isinstance(v, (int, float))
        },
        "per_op": per_op,
        "stragglers": obj.get("stragglers") or [],
    }


def regression_diff(baseline, current) -> Dict[str, Any]:
    """Name what got slower: the bucket-by-bucket / per-op diff between
    two runs of the same plan.

    Both arguments go through :func:`_normalize_run` (archive records
    and live ``analyze()`` data are interchangeable). Each bucket/op row
    carries its absolute delta and its share of the total slowdown;
    ``culprits`` ranks the buckets that account for the wall-clock
    growth, and worker names ride along from the current run's straggler
    digest so "which bucket" can often be narrowed to "which worker"."""
    base = _normalize_run(baseline)
    cur = _normalize_run(current)
    base_wall = base.get("wall_clock_s")
    cur_wall = cur.get("wall_clock_s")
    delta_wall = (
        cur_wall - base_wall
        if isinstance(base_wall, (int, float))
        and isinstance(cur_wall, (int, float)) else None
    )
    ratio = (
        cur_wall / base_wall
        if isinstance(delta_wall, (int, float)) and base_wall else None
    )

    bucket_rows = []
    names = [b for b in BUCKETS if b in base["buckets"] or b in cur["buckets"]]
    names += sorted(
        (set(base["buckets"]) | set(cur["buckets"])) - set(names)
    )
    slowdown = delta_wall if isinstance(delta_wall, (int, float)) else None
    for name in names:
        b = base["buckets"].get(name, 0.0)
        c = cur["buckets"].get(name, 0.0)
        d = c - b
        row = {
            "bucket": name,
            "baseline_s": round(b, 6),
            "current_s": round(c, 6),
            "delta_s": round(d, 6),
        }
        if slowdown and slowdown > 0 and d > 0:
            row["share_of_slowdown"] = round(min(d / slowdown, 1.0), 4)
        bucket_rows.append(row)
    bucket_rows.sort(key=lambda r: -r["delta_s"])

    op_rows = []
    for name in set(base["per_op"]) | set(cur["per_op"]):
        b = base["per_op"].get(name, {"busy_s": 0.0, "buckets": {}})
        c = cur["per_op"].get(name, {"busy_s": 0.0, "buckets": {}})
        d = c["busy_s"] - b["busy_s"]
        deltas = {
            k: c["buckets"].get(k, 0.0) - b["buckets"].get(k, 0.0)
            for k in set(b["buckets"]) | set(c["buckets"])
        }
        grew = max(deltas.items(), key=lambda kv: kv[1])[0] if deltas else None
        op_rows.append({
            "op": name,
            "baseline_busy_s": round(b["busy_s"], 6),
            "current_busy_s": round(c["busy_s"], 6),
            "delta_s": round(d, 6),
            "grew_bucket": grew if deltas and deltas[grew] > 1e-6 else None,
        })
    op_rows.sort(key=lambda r: -r["delta_s"])

    culprits = [
        r["bucket"] for r in bucket_rows
        if r["delta_s"] > 1e-6 and (
            slowdown is None or slowdown <= 0
            or r["delta_s"] >= 0.05 * slowdown
        )
    ][:3]
    workers = sorted({
        s.get("worker") for s in cur["stragglers"]
        if isinstance(s, dict) and s.get("worker")
    })
    return {
        "baseline_compute_id": base.get("compute_id"),
        "baseline_ts": base.get("ts"),
        "current_compute_id": cur.get("compute_id"),
        "wall_clock": {
            "baseline_s": base_wall,
            "current_s": cur_wall,
            "delta_s": (
                round(delta_wall, 6)
                if isinstance(delta_wall, (int, float)) else None
            ),
            "ratio": round(ratio, 4) if ratio is not None else None,
        },
        "regressed": bool(ratio is not None and ratio >= REGRESSION_RATIO),
        "buckets": bucket_rows,
        "ops": op_rows,
        "culprits": culprits,
        "straggler_workers": workers,
    }


def render_regression(reg: dict) -> str:
    """The human regression view (``python -m cubed_tpu_torch.regress`` and
    ``diagnose --analyze`` print this)."""
    out: List[str] = []
    wc = reg.get("wall_clock") or {}
    ratio = wc.get("ratio")
    verdict = (
        "REGRESSED" if reg.get("regressed")
        else "no regression" if ratio is not None else "incomparable"
    )
    out.append(
        f"REGRESSION  {reg.get('current_compute_id')} vs baseline "
        f"{reg.get('baseline_compute_id')}  [{verdict}]"
    )
    b, c = wc.get("baseline_s"), wc.get("current_s")
    if isinstance(b, (int, float)) and isinstance(c, (int, float)):
        out.append(
            f"  wall clock {b:.3f}s -> {c:.3f}s  "
            f"({'+' if c >= b else ''}{c - b:.3f}s, "
            f"{ratio:.2f}x)" if ratio is not None
            else f"  wall clock {b:.3f}s -> {c:.3f}s"
        )
    rows = [
        r for r in (reg.get("buckets") or []) if abs(r["delta_s"]) > 1e-6
    ]
    if rows:
        out.append("  bucket deltas (current - baseline):")
        for r in rows[:8]:
            share = r.get("share_of_slowdown")
            share_s = f"  {share:>5.0%} of slowdown" if share else ""
            out.append(
                f"    {r['bucket']:<18}{r['baseline_s']:>9.3f}s ->"
                f"{r['current_s']:>9.3f}s  "
                f"{'+' if r['delta_s'] >= 0 else ''}"
                f"{r['delta_s']:.3f}s{share_s}"
            )
    culprits = reg.get("culprits") or []
    if culprits:
        out.append(f"  culprit bucket(s): {', '.join(culprits)}")
    ops = [
        r for r in (reg.get("ops") or []) if abs(r["delta_s"]) > 1e-6
    ]
    if ops:
        out.append("  op deltas (busy time):")
        for r in ops[:6]:
            grew = f"  [{r['grew_bucket']}]" if r.get("grew_bucket") else ""
            out.append(
                f"    {r['op']:<28}{r['baseline_busy_s']:>9.3f}s ->"
                f"{r['current_busy_s']:>9.3f}s  "
                f"{'+' if r['delta_s'] >= 0 else ''}"
                f"{r['delta_s']:.3f}s{grew}"
            )
    workers = reg.get("straggler_workers") or []
    if workers:
        out.append(f"  straggling worker(s): {', '.join(map(str, workers))}")
    return "\n".join(out) + "\n"


def render_analysis(data: dict, path_limit: int = 12) -> str:
    """The human ANALYZE view (``diagnose --analyze`` prints this)."""
    out: List[str] = []
    wall = data.get("wall_clock_s")
    out.append(
        f"ANALYZE  compute {data.get('compute_id')}  "
        f"[{data.get('status')}]  wall clock "
        f"{wall:.3f}s" if isinstance(wall, (int, float))
        else f"ANALYZE  compute {data.get('compute_id')}"
    )
    attribution = data.get("attribution") or {}
    if attribution and isinstance(wall, (int, float)) and wall:
        out.append("")
        out.append("wall-clock attribution (critical-path decomposition):")
        for bucket in BUCKETS:
            v = attribution.get(bucket) or 0.0
            if v < 1e-6:
                continue
            bar = "#" * max(1, int(round(30 * v / wall)))
            out.append(
                f"  {bucket:<18}{v:>9.3f}s {v / wall:>5.0%}  {bar}"
            )
    path = data.get("critical_path") or []
    if path:
        out.append("")
        out.append(
            f"critical path ({len(path)} task(s), source="
            f"{data.get('critical_path_source')}):"
        )
        shown = path if len(path) <= path_limit else (
            path[: path_limit // 2] + [None] + path[-path_limit // 2:]
        )
        for r in shown:
            if r is None:
                out.append(f"  ... {len(path) - path_limit} more ...")
                continue
            flag = "  STRAGGLER" if r.get("straggler") else ""
            out.append(
                f"  +{r['start_s']:8.3f}s {r['op']:<28} "
                f"chunk={str(r.get('chunk'))[:28]:<30} "
                f"wait {r['queue_wait_s']:6.3f}s  run "
                f"{r['duration_s']:6.3f}s{flag}"
            )
    bottlenecks = data.get("bottlenecks") or []
    if bottlenecks:
        out.append("")
        out.append("top bottleneck tasks (path contribution):")
        for r in bottlenecks:
            contrib = r["queue_wait_s"] + r["duration_s"]
            out.append(
                f"  {r['op']:<28} chunk={str(r.get('chunk'))[:28]:<30} "
                f"{contrib:6.3f}s"
                + (" STRAGGLER" if r.get("straggler") else "")
            )
    per_op = data.get("per_op") or {}
    if per_op:
        out.append("")
        out.append("per-op busy-time attribution (all workers):")
        ranked = sorted(
            per_op.items(), key=lambda kv: -kv[1]["busy_s"]
        )
        for name, row in ranked[:10]:
            top = sorted(
                row["buckets"].items(), key=lambda kv: -kv[1]
            )[:3]
            top_s = ", ".join(f"{k} {v:.3f}s" for k, v in top)
            out.append(
                f"  {name:<28} tasks={row['tasks']:<6} busy "
                f"{row['busy_s']:8.3f}s  [{top_s}]"
            )
    divergences = data.get("divergences") or []
    if divergences:
        out.append("")
        out.append("projected-vs-measured divergences:")
        for d in divergences:
            out.append(f"  [{d.get('kind')}] {d.get('op')}: {d.get('note')}")
    reg = data.get("regression")
    if reg:
        out.append("")
        out.append(render_regression(reg).rstrip("\n"))
    return "\n".join(out) + "\n"
