"""Chunk-granular dataflow scheduling: no barrier between ops.

Counterpart of ``cubed_tpu/runtime/dataflow.py``, built on the port's own
DAG (``core/plan.Dag``) where the reference walks networkx. The op-level
model (``pipeline.visit_nodes``) runs a plan op by op: every task of op N
ends before any task of op N+1 starts, so one slow chunk holds up the next
op. But a blockwise op's ``block_function`` maps each output chunk key to
the input chunk keys it reads, and tasks talk only through whole-chunk,
idempotent storage writes. This module turns that into a scheduler:

- :func:`build_chunk_graph` expands the op-level DAG into a chunk-level
  task graph: one node per task, each with the set of tasks it depends on,
  from the op's ``block_function`` or, for a rechunk copy stage, from the
  region-overlap index math (``pipeline.rechunk_task_reads``: a source
  chunk to the target tasks that read it, so rechunk is no barrier). An op
  without chunk-level structure (``create-arrays``, any pipeline whose task
  body is not ``apply_blockwise``) is a conservative op-level barrier.
- :class:`DataflowScheduler` drives a whole compute through one
  ``map_unordered`` call, whose ``dependencies`` hold each task back until
  its own input chunks are written: a downstream task dispatches the
  moment its inputs land, while the rest of the upstream op still runs.

Retries, speculative backups, RECOMPUTE repair and admission control apply
unchanged: the dataflow path is the same ``map_unordered``. Chunk-granular
resume marks satisfied tasks done before dispatch (``pending_mappable``).

Mode: the ``CUBED_TPU_TORCH_SCHEDULER`` env var (the operator's override)
wins over ``Spec(scheduler=...)``; the default is ``"dataflow"``, and
``"oplevel"`` is the escape hatch, also what a defaulted scheduler falls
back to when the caller set ``batch_size`` (dataflow cannot batch). The
sequential executor and the device executor keep op order.

Counters: ``tasks_dispatched_early`` (tasks dispatched while an upstream op
of theirs still had unfinished tasks: the overlap) and ``op_barrier_waits``
(tasks gated by a conservative op-level barrier, the ``create-arrays``
bootstrap excluded). While span recording is armed (a trace collector is
attached), ``start`` also hands the chunk-level edges to
``observability.collect.record_chunk_graph``, so ``analytics.analyze`` walks
the true critical path instead of the op-barrier approximation.
"""

from __future__ import annotations

import logging
import os
import time
from collections.abc import Iterator
from typing import Any, Dict, List, Optional, Set

from ..observability.metrics import get_registry
from .pipeline import (
    ResumeState,
    _task_chunk_key,
    already_computed,
    is_rechunk_pipeline,
    is_region_item,
    iter_op_nodes,
    pending_mappable,
    rechunk_task_reads,
    rechunk_task_writes,
    region_identity,
)
from .types import OperationEndEvent, OperationStartEvent, callbacks_on

logger = logging.getLogger(__name__)

MODES = ("oplevel", "dataflow")
DEFAULT_MODE = "dataflow"
SCHEDULER_ENV_VAR = "CUBED_TPU_TORCH_SCHEDULER"

#: the metadata bootstrap op (``Plan._finalize``'s lazy arrays); it gates
#: every other op by design, so it counts in no barrier metric
CREATE_ARRAYS_OP = "create-arrays"


def _validate(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"invalid scheduler mode {mode!r}; expected one of {MODES}")
    return mode


def requested_scheduler(spec: Any = None) -> Optional[str]:
    """The explicitly requested mode (env > Spec), or None when the caller
    left it defaulted. A malformed env value raises: a typo must not fall
    back to another mode silently."""
    raw = os.environ.get(SCHEDULER_ENV_VAR)
    if raw:
        return _validate(raw)
    s = getattr(spec, "scheduler", None)
    if s is not None:
        return _validate(s)
    return None


def resolve_scheduler(spec: Any = None) -> str:
    """The effective mode: env > Spec > default."""
    explicit = requested_scheduler(spec)
    return explicit if explicit is not None else DEFAULT_MODE


def effective_scheduler(spec: Any = None, batch_size=None) -> str:
    """The mode the threaded executor runs: :func:`resolve_scheduler`, except
    that a defaulted dataflow yields to an explicit ``batch_size`` and runs
    op-level (dataflow has one dependency index space and cannot batch); an
    explicit dataflow request wins, and the executor warns."""
    scheduler = resolve_scheduler(spec)
    if scheduler == "dataflow" and batch_size and requested_scheduler(spec) is None:
        return "oplevel"
    return scheduler


def record_scheduler_mode(mode: str, executor: Optional[str] = None) -> None:
    """The resolved mode on the ``scheduler_mode`` gauge and the decision
    ring."""
    from ..observability.collect import record_decision

    get_registry().gauge("scheduler_mode").set(1 if mode == "dataflow" else 0)
    record_decision("scheduler_mode", mode=mode, executor=executor)


def _iter_keys(structure) -> Iterator[tuple]:
    """Every chunk key in a (nested or lazy) block-function value: plain
    keys, nested lists (contracted axes), ``PredKeys`` (fused predecessors,
    a list) and iterators (tree-reduce reads), as ``blockwise._read_keys``
    walks them. The structure is built anew for this walk, so consuming its
    iterators is safe."""
    from ..primitive.blockwise import _is_key

    if structure is None:
        return
    if _is_key(structure):
        yield structure
        return
    if isinstance(structure, (list, tuple, Iterator)):
        for entry in structure:
            yield from _iter_keys(entry)
    # anything else (a scalar baked into the structure) reads no chunk


def _store_of(target) -> str:
    return str(getattr(target, "store", "") or "")


def task_hint_key(m) -> str:
    """A task's identity within its op: the dotted output chunk key of a
    blockwise item, the region identity of a rechunk region."""
    if is_region_item(m):
        return region_identity(m)
    return _task_chunk_key(m)


def task_tag(name: str, m):
    """The durable ``(op, chunk key)`` identity of one dispatched task, or
    None for an item with no chunk-shaped identity (a create-arrays item).
    It is derived from the plan alone, so two builds of the same plan tag
    the same task alike."""
    if not isinstance(m, (tuple, list)):
        return None
    try:
        return (name, task_hint_key(m))
    except Exception:
        return None


class ChunkGraph:
    """The chunk-level task graph of one finalized plan.

    ``items[i]`` is ``(op_name, task_input)``; ``dependencies[i]`` the item
    indices that must complete before item *i* may dispatch (absent:
    dispatch at once). ``op_order`` keeps topological op order;
    ``op_num_tasks``/``op_pending`` are each op's task count and the tasks
    it has in the graph after resume's skips."""

    def __init__(self) -> None:
        self.items: List[tuple] = []
        self.array_names: List[str] = []
        self.dependencies: Dict[int, Set[int]] = {}
        self.op_order: List[str] = []
        self.op_num_tasks: Dict[str, int] = {}
        self.op_pending: Dict[str, int] = {}
        #: op -> upstream ops with tasks in this graph (create-arrays too:
        #: overlapping the bootstrap is not "early")
        self.op_upstream: Dict[str, Set[str]] = {}
        self.pipelines: Dict[str, Any] = {}
        #: op -> "blockwise" (key function walked), "rechunk" (region
        #: overlaps) or "barrier" (no chunk-level structure)
        self.op_kind: Dict[str, str] = {}
        #: item index -> the (store, chunk key) pairs the task reads
        self.reads: Dict[int, tuple] = {}
        #: tasks gated by a conservative op-level barrier (the bootstrap's
        #: excluded)
        self.barrier_tasks: int = 0
        #: ops that became barriers
        self.barrier_ops: List[str] = []

    def edges_by_key(self) -> Dict[str, list]:
        """Each task's dependency edges keyed ``"<op>\\t<chunk_key(m)>"``
        (the executors' task key, ``utils.chunk_key``), values sorted."""
        from .utils import chunk_key

        keys: List[Optional[str]] = [None] * len(self.items)

        def key_for(idx: int) -> str:
            k = keys[idx]
            if k is None:
                op, m = self.items[idx]
                k = keys[idx] = f"{op}\t{chunk_key(m)}"
            return k

        out: Dict[str, list] = {}
        for idx in range(len(self.items)):
            deps = self.dependencies.get(idx)
            out[key_for(idx)] = [key_for(d) for d in sorted(deps)] if deps else []
        return out


def _op_predecessor_ops(dag, name: str) -> Set[str]:
    """The ops producing *name*'s inputs: an array predecessor resolves to
    the op that writes it; an op-to-op edge (create-arrays) passes."""
    nodes = dag.nodes
    out: Set[str] = set()
    for pred in dag.predecessors(name):
        if nodes[pred].get("type") == "op":
            out.add(pred)
        else:
            out.update(p for p in dag.predecessors(pred) if nodes[p].get("type") == "op")
    return out


def build_chunk_graph(dag, resume: Optional[bool] = None, state: Optional[ResumeState] = None) -> ChunkGraph:
    """Expand an op-level DAG into a :class:`ChunkGraph`.

    Resume composes as on the op-level path: ops whose outputs all verify
    are left out (``already_computed``), a partly complete op contributes
    its pending tasks only (``pending_mappable``), and a dependency on a
    chunk that already verifies is born satisfied."""
    from ..primitive.blockwise import apply_blockwise

    g = ChunkGraph()
    nodes = dag.nodes
    if resume and state is None:
        state = ResumeState(quarantine=True)

    # store -> producing op, over every op (an input produced by an op that
    # resume left out is a satisfied dependency)
    store_to_op: Dict[str, str] = {}
    for name, d in iter_op_nodes(dag):
        op = d["primitive_op"]
        for t in op.target_arrays or ([op.target_array] if op.target_array is not None else []):
            store = _store_of(t)
            if store:
                store_to_op[store] = name

    chunk_structured: Dict[str, bool] = {}
    #: chunk-structured op -> {chunk key -> item index} over its whole
    #: mappable (None: satisfied by resume)
    key_index: Dict[str, Dict[str, Optional[int]]] = {}
    op_item_indices: Dict[str, List[int]] = {}

    order = [name for name in dag.topological_sort()
             if nodes[name].get("type") == "op" and nodes[name].get("primitive_op") is not None
             and not already_computed(name, dag, nodes, resume, state)]

    for name in order:
        node = nodes[name]
        primitive_op = node["primitive_op"]
        pipeline = primitive_op.pipeline
        mappable = list(pending_mappable(name, node, resume, state)[0])
        if pipeline.function is apply_blockwise:
            kind = "blockwise"
        elif is_rechunk_pipeline(pipeline):
            kind = "rechunk"
        else:
            kind = "barrier"
        structured = kind != "barrier"
        chunk_structured[name] = structured
        g.op_kind[name] = kind
        g.op_order.append(name)
        g.op_num_tasks[name] = primitive_op.num_tasks
        g.op_pending[name] = len(mappable)
        g.pipelines[name] = pipeline

        def out_keys_of(m, kind=kind, pipeline=pipeline) -> list:
            # a rechunk region writes every target chunk it covers (each
            # target chunk has exactly one producing task)
            if kind == "rechunk":
                return rechunk_task_writes(m, pipeline.config)
            return [_task_chunk_key(m)]

        indices: List[int] = []
        keys: Dict[str, Optional[int]] = {}
        if structured:
            for m in pipeline.mappable:
                for k in out_keys_of(m):
                    keys[k] = None  # satisfied unless pending
        for m in mappable:
            idx = len(g.items)
            g.items.append((name, m))
            g.array_names.append(name)
            indices.append(idx)
            if structured:
                for k in out_keys_of(m):
                    keys[k] = idx
        op_item_indices[name] = indices
        key_index[name] = keys

    in_graph = set(g.op_order)

    for name in g.op_order:
        pipeline = g.pipelines[name]
        upstream = {p for p in _op_predecessor_ops(dag, name) if p in in_graph and g.op_pending[p]}
        g.op_upstream[name] = upstream
        #: producers that are barriers for this op's tasks: op-to-op edges
        #: (create-arrays) and every unstructured producer
        barrier_producers = {p for p in upstream if not chunk_structured.get(p, False)}

        def add_deps(idx: int, deps: Set[int]) -> None:
            if deps:
                g.dependencies.setdefault(idx, set()).update(deps)

        if not chunk_structured[name]:
            # no chunk-level structure: each task waits for every pending
            # predecessor task
            barrier: Set[int] = set()
            for p in upstream:
                barrier.update(op_item_indices[p])
            n_gated = len(op_item_indices[name]) if barrier else 0
            if n_gated and any(p != CREATE_ARRAYS_OP for p in upstream):
                g.barrier_tasks += n_gated
                g.barrier_ops.append(name)
            for idx in op_item_indices[name]:
                add_deps(idx, barrier)
            continue

        barrier_base: Set[int] = set()
        for p in barrier_producers:
            barrier_base.update(op_item_indices[p])
        non_bootstrap_barrier = any(p != CREATE_ARRAYS_OP for p in barrier_producers)
        if non_bootstrap_barrier:
            g.barrier_ops.append(name)

        def iter_reads(m, name=name, pipeline=pipeline):
            """(store, chunk key) pairs a task reads: the block function's
            keys, or a rechunk region's source chunks."""
            if g.op_kind[name] == "rechunk":
                yield from rechunk_task_reads(m, pipeline.config)
                return
            for key in _iter_keys(pipeline.config.block_function(m)):
                proxy = pipeline.config.reads_map.get(key[0])
                if proxy is None:
                    raise KeyError(key[0])
                yield _store_of(proxy.array), _task_chunk_key(key)

        covered_ops: Set[str] = set()
        for idx in op_item_indices[name]:
            _, m = g.items[idx]
            deps = set(barrier_base)
            reads: List[tuple] = []
            if non_bootstrap_barrier:
                g.barrier_tasks += 1
            try:
                for store, key_str in iter_reads(m):
                    reads.append((store, key_str))
                    producer = store_to_op.get(store)
                    if producer is None or producer not in in_graph:
                        continue  # a source array, or an op resume left out
                    covered_ops.add(producer)
                    if not chunk_structured[producer]:
                        continue  # in barrier_base already
                    entry = key_index[producer].get(key_str)
                    if entry is None:
                        if key_str in key_index[producer]:
                            continue  # satisfied by resume
                        # the key functions disagree: a barrier on that
                        # producer rather than a read of an unordered chunk
                        logger.warning("dataflow: task %s of %s reads unknown chunk %s of %s; degrading that "
                                       "edge to an op barrier", _task_chunk_key(m), name, key_str, producer)
                        deps.update(op_item_indices[producer])
                    else:
                        deps.add(entry)
            except Exception:
                # a block function that cannot be walked: op-level
                # semantics for this one task
                logger.warning("dataflow: could not derive chunk deps for task %s of %s; using an op-level "
                               "barrier", _task_chunk_key(m), name, exc_info=True)
                for p in upstream:
                    deps.update(op_item_indices[p])
                if not non_bootstrap_barrier and any(p != CREATE_ARRAYS_OP for p in upstream):
                    g.barrier_tasks += 1
                reads = []
            if reads:
                g.reads[idx] = tuple(dict.fromkeys(reads))
            add_deps(idx, deps)

        # a pending producer the walk never saw: the block function under-
        # reports its reads, so barrier on it (conservative, still correct)
        for p in upstream:
            if chunk_structured.get(p, False) and p not in covered_ops:
                logger.warning("dataflow: op %s never referenced producer %s in its block function; adding an "
                               "op-level barrier on it", name, p)
                for idx in op_item_indices[name]:
                    g.dependencies.setdefault(idx, set()).update(op_item_indices[p])

    return g


class DataflowScheduler:
    """Drives one compute's chunk graph through a single unordered map.

    The executor builds one, calls :meth:`start`, runs ``map_unordered``
    over :attr:`items` with :attr:`dependencies` and the :meth:`on_submit`
    and :meth:`on_done` hooks, then calls :meth:`finish`. The hooks are
    idempotent per item, so no op event fires twice."""

    def __init__(self, dag, resume=None, state=None, callbacks=None):
        self.callbacks = callbacks
        self.graph = build_chunk_graph(dag, resume=resume, state=state)
        self._pending = dict(self.graph.op_pending)
        self._submitted: Set[int] = set()
        self._done: Set[int] = set()
        self._started_ops: Set[str] = set()
        self._ended_ops: Set[str] = set()
        self._early_noted_ops: Set[str] = set()

    @property
    def items(self) -> List[tuple]:
        return self.graph.items

    @property
    def array_names(self) -> List[str]:
        return self.graph.array_names

    @property
    def dependencies(self) -> Dict[int, Set[int]]:
        return self.graph.dependencies

    @property
    def pipelines(self) -> Dict[str, Any]:
        return self.graph.pipelines

    def locality_hints(self) -> Dict[tuple, tuple]:
        """``(op, output chunk key) -> ((store, input chunk key), ...)`` for
        every task whose reads the graph walk resolved: what the fleet's
        dispatch scores workers by (input bytes already in their chunk
        caches). Keyed by (op, chunk), as the fleet's pool adapter sees
        ``(op, task input)`` items, not indices."""
        out: Dict[tuple, tuple] = {}
        for idx, reads in self.graph.reads.items():
            op, m = self.graph.items[idx]
            out[(op, task_hint_key(m))] = reads
        return out

    @property
    def completed(self) -> Set[int]:
        """The live set of completed item indices: a process pool's re-run
        after a crash passes it as ``completed_inputs``, and resumes where
        the broken pool stopped."""
        return self._done

    def start(self) -> None:
        """Land the graph's shape on the metrics and the decision ring, and
        close the ops with nothing to run. An op's start event fires at its
        first dispatch: under dataflow its lifetime is first dispatch to
        last completion."""
        from ..observability import accounting
        from ..observability.collect import record_chunk_graph, record_decision

        if self.graph.barrier_tasks:
            get_registry().counter("op_barrier_waits").inc(self.graph.barrier_tasks)
        if accounting.spans_enabled():
            record_chunk_graph(self.graph.edges_by_key())
        record_decision("dataflow_graph", ops=len(self.graph.op_order), tasks=len(self.graph.items),
                        barrier_ops=[o for o in self.graph.barrier_ops if o != CREATE_ARRAYS_OP][:16],
                        barrier_tasks=self.graph.barrier_tasks)
        for name in self.graph.op_order:
            if self._pending[name] == 0:
                self._start_op(name)
                self._end_op(name)

    def on_submit(self, i: int) -> None:
        """First-dispatch hook: the op's start event, and a count of tasks
        dispatched while an upstream op still has unfinished tasks. It runs
        on the dispatch loop: its time counts in ``dispatch_sched_hook_s``."""
        t_hook = time.perf_counter()
        try:
            self._on_submit(i)
        finally:
            get_registry().counter("dispatch_sched_hook_s").inc(time.perf_counter() - t_hook)

    def _on_submit(self, i: int) -> None:
        op = self.graph.array_names[i]
        self._start_op(op)
        if i in self._submitted:
            return
        self._submitted.add(i)
        if any(self._pending.get(p, 0) > 0 for p in self.graph.op_upstream[op]):
            get_registry().counter("tasks_dispatched_early").inc()
            if op not in self._early_noted_ops:
                # one ring entry per op: when it first overlapped upstream
                self._early_noted_ops.add(op)
                from ..observability.collect import record_decision

                _, m = self.graph.items[i]
                record_decision("dispatch_early", op=op, chunk=task_hint_key(m),
                                upstream_pending=sum(self._pending.get(p, 0) for p in self.graph.op_upstream[op]))

    def on_done(self, i: int) -> None:
        t_hook = time.perf_counter()
        try:
            if i in self._done:
                return
            self._done.add(i)
            op = self.graph.array_names[i]
            self._pending[op] -= 1
            if self._pending[op] == 0:
                self._end_op(op)
        finally:
            get_registry().counter("dispatch_sched_hook_s").inc(time.perf_counter() - t_hook)

    def _start_op(self, name: str) -> None:
        if name not in self._started_ops:
            self._started_ops.add(name)
            callbacks_on(self.callbacks, "on_operation_start",
                         OperationStartEvent(name, self.graph.op_num_tasks[name]))

    def _end_op(self, name: str) -> None:
        if name not in self._ended_ops:
            self._ended_ops.add(name)
            callbacks_on(self.callbacks, "on_operation_end", OperationEndEvent(name, self.graph.op_num_tasks[name]))

    def finish(self) -> None:
        """Balance the op events (a failed compute may leave ops open or
        never started; observers still get a start and an end for each)."""
        for name in self.graph.op_order:
            self._start_op(name)
            self._end_op(name)
