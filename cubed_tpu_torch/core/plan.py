"""The lazy whole-operation DAG.

Counterpart of ``cubed_tpu/core/plan.py``. Nodes alternate between *op*
nodes (carrying a PrimitiveOperation) and *array* nodes (carrying a Zarr
target); data never flows through the graph, each op reads chunks of its
inputs from storage and writes chunks of its output. The JAX package keeps
the graph in networkx; here :class:`Dag` is a small multigraph in plain dicts
with the few operations the planner, the optimizer and the executor use.
:meth:`Plan.execute` runs a compute's lifecycle: its id, the compute events,
the metrics registry's delta and the per-op summary (``executor_stats``).
"""

from __future__ import annotations

import inspect
import logging
import os
import tempfile
import time
import uuid
from typing import Callable, Iterator, Optional

from ..observability import accounting, logs
from ..observability.callback import _ComputeAggregator
from ..observability.collect import TraceCollector
from ..observability.metrics import get_registry
from ..primitive.types import CubedPipeline, PrimitiveOperation
from ..runtime.pipeline import ResumeState, already_computed, iter_op_nodes, pending_mappable
from ..runtime.types import ComputeEndEvent, ComputeStartEvent, callbacks_on
from ..storage.zarr import LazyZarrArray
from ..utils import extract_stack_summaries, gensym, join_path  # noqa: F401  (gensym re-exported for the modules that build plans)

logger = logging.getLogger(__name__)

#: unique run id for this client process; work_dir data lives under it
CONTEXT_ID = os.environ.get("CUBED_TPU_TORCH_CONTEXT_ID") or f"cubed-{uuid.uuid4().hex[:10]}"


def new_temp_path(name: str, spec=None) -> str:
    """A unique storage path for an intermediate array in the work_dir."""
    work_dir = spec.work_dir if spec is not None and spec.work_dir else tempfile.gettempdir()
    return join_path(join_path(work_dir, CONTEXT_ID), f"{name}.zarr")


class Dag:
    """A directed multigraph: named nodes with attribute dicts, and edges
    counted per (source, target) pair. Iteration follows insertion order."""

    def __init__(self):
        self.nodes: dict[str, dict] = {}
        self._succ: dict[str, dict[str, int]] = {}
        self._pred: dict[str, dict[str, int]] = {}

    def add_node(self, node: str, /, **attrs) -> None:
        if node in self.nodes:
            self.nodes[node].update(attrs)
            return
        self.nodes[node] = dict(attrs)
        self._succ[node] = {}
        self._pred[node] = {}

    def add_edge(self, u: str, v: str) -> None:
        for n in (u, v):
            if n not in self.nodes:
                self.add_node(n)
        self._succ[u][v] = self._succ[u].get(v, 0) + 1
        self._pred[v][u] = self._pred[v].get(u, 0) + 1

    def remove_node(self, name: str) -> None:
        for s in self._succ.pop(name):
            del self._pred[s][name]
        for p in self._pred.pop(name):
            del self._succ[p][name]
        del self.nodes[name]

    def __contains__(self, name) -> bool:
        return name in self.nodes

    def predecessors(self, name: str) -> list[str]:
        return list(self._pred[name])

    def successors(self, name: str) -> list[str]:
        return list(self._succ[name])

    def out_degree(self, name: str) -> int:
        return sum(self._succ[name].values())

    def number_of_edges(self, u: str, v: str) -> int:
        return self._succ[u].get(v, 0)

    def edges(self) -> Iterator[tuple[str, str]]:
        """Every edge as (source, target), a pair once for each of its edges."""
        for u, succ in self._succ.items():
            for v, k in succ.items():
                for _ in range(k):
                    yield u, v

    def copy(self) -> "Dag":
        """A new graph with copies of every attribute dict (values shared)."""
        new = Dag()
        new.nodes = {n: dict(d) for n, d in self.nodes.items()}
        new._succ = {n: dict(s) for n, s in self._succ.items()}
        new._pred = {n: dict(p) for n, p in self._pred.items()}
        return new

    @classmethod
    def compose(cls, *dags: "Dag") -> "Dag":
        """The union of *dags*, sharing nodes by name (later attributes win,
        edge counts of a pair are the largest any graph has)."""
        out = cls()
        for dag in dags:
            for n, d in dag.nodes.items():
                out.add_node(n, **d)
            for u, succ in dag._succ.items():
                for v, k in succ.items():
                    if out.number_of_edges(u, v) < k:
                        out._succ[u][v] = k
                        out._pred[v][u] = k
        return out

    def topological_sort(self) -> list[str]:
        """Kahn's algorithm, ready nodes taken in insertion order."""
        indeg = {n: len(p) for n, p in self._pred.items()}
        ready = [n for n in self.nodes if indeg[n] == 0]
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for s in self._succ[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(order) != len(self.nodes):
            raise ValueError("plan graph has a cycle")
        return order


class Plan:
    """A deferred computation: a DAG of whole-array operations."""

    def __init__(self, dag: Dag):
        self.dag = dag

    @classmethod
    def _new(
        cls,
        name,
        op_name: str,
        target,
        primitive_op: Optional[PrimitiveOperation] = None,
        hidden: bool = False,
        *source_arrays,
    ) -> "Plan":
        """A plan adding one op (and its output array, or arrays when *name*
        and *target* are lists) to the union of the source arrays' plans."""
        dag = arrays_to_dag(*source_arrays)
        frame = inspect.currentframe()
        op_node = gensym(f"op-{op_name}")
        names = list(name) if isinstance(name, (list, tuple)) else [name]
        targets = list(target) if isinstance(name, (list, tuple)) else [target]
        dag.add_node(
            op_node,
            name=op_node,
            type="op",
            op_display_name=f"{op_name}\n" + "\n".join(names),
            op_name=op_name,
            primitive_op=primitive_op,
            hidden=hidden,
            # the caller's frames, for visualize's tooltips and labels
            stack_summaries=extract_stack_summaries(frame.f_back if frame else None),
        )
        for n, t in zip(names, targets):
            dag.add_node(n, name=n, type="array", target=t, hidden=hidden)
            dag.add_edge(op_node, n)
        for x in source_arrays:
            dag.add_edge(x.name, op_node)
        return Plan(dag)

    def _finalize(self, optimize_graph: bool = True, optimize_function: Optional[Callable] = None,
                  array_names=None) -> "FinalizedPlan":
        """The plan as it runs: optimized by *optimize_function* (default: the
        fusion of ``multiple_inputs_optimize_dag``) unless *optimize_graph*
        is false, the arrays in *array_names* kept as outputs, with its
        create-arrays op."""
        dag = self.optimize(optimize_function, array_names).dag if optimize_graph else self.dag
        return FinalizedPlan(create_lazy_zarr_arrays(dag.copy()))

    def optimize(self, optimize_function: Optional[Callable] = None, array_names=None) -> "Plan":
        """This plan rewritten by *optimize_function* (a function of a graph
        and ``array_names``), by default ``multiple_inputs_optimize_dag``."""
        from .optimization import multiple_inputs_optimize_dag

        if optimize_function is None:
            optimize_function = multiple_inputs_optimize_dag
        return Plan(optimize_function(self.dag.copy(), array_names=array_names))

    def num_tasks(self, optimize_graph: bool = True, optimize_function=None, resume=None) -> int:
        return self._finalize(optimize_graph, optimize_function).num_tasks(resume=resume)

    def num_arrays(self, optimize_graph: bool = True, optimize_function=None) -> int:
        return self._finalize(optimize_graph, optimize_function).num_arrays()

    def max_projected_mem(self, optimize_graph: bool = True, optimize_function=None, resume=None) -> int:
        """The largest memory any task of the plan is projected to need."""
        return self._finalize(optimize_graph, optimize_function).max_projected_mem(resume=resume)

    def total_nbytes_written(self, optimize_graph: bool = True, optimize_function=None) -> int:
        return self._finalize(optimize_graph, optimize_function).total_nbytes_written()

    def explain(self, spec=None, optimize_graph=True, optimize_function=None, array_names=None):
        """EXPLAIN this plan before it runs: finalize it as ``execute`` would
        and report per-op task counts, projected memory against
        ``allowed_mem``, predicted bytes read and written, the fusion outcome
        and the scheduler's barrier decisions, an
        :class:`~cubed_tpu_torch.observability.analytics.ExplainReport`
        (``print()`` it, ``.to_dict()`` it, or ``.save(path)`` for
        ``python -m cubed_tpu_torch.explain``)."""
        from ..observability.analytics import explain as _explain

        return _explain(self, spec=spec, optimize_graph=optimize_graph, optimize_function=optimize_function,
                        array_names=array_names)

    def visualize(self, filename="cubed", format=None, rankdir="TB", optimize_graph=True,
                  optimize_function=None, show_hidden=False):
        """Write the finalized plan as DOT to ``filename.dot`` and, where a
        graphviz ``dot`` program is installed, render it; returns the path
        written last (``core/visualization.py``)."""
        from .visualization import visualize_dag

        finalized = self._finalize(optimize_graph, optimize_function)
        return visualize_dag(finalized.dag, filename=filename, format=format, rankdir=rankdir,
                             show_hidden=show_hidden)

    def execute(
        self, executor=None, callbacks=None, optimize_graph=True, array_names=None, spec=None,
        optimize_function=None, resume: Optional[bool] = None, deadline_s: Optional[float] = None,
        cancellation=None, resume_from_journal: Optional[str] = None, finalized=None, **kwargs,
    ) -> None:
        """Finalize the plan and run it on *executor* (default: the
        sequential ``PythonDagExecutor``), as one compute: a compute id, a
        ``_ComputeAggregator`` beside *callbacks*, ``on_compute_start``,
        the executor under the compute's log scope (and span recording,
        armed while a ``TraceCollector`` is attached), and, even when the
        compute fails, ``on_compute_end`` with ``executor_stats`` (the
        executor's own ``stats``, the registry's delta over the compute and
        the per-op summary) and the error.

        The reliability layers are armed for the compute's duration, as in
        the reference (``cubed_tpu/core/plan.py:222-441``): the spec's
        ``fault_injection``, ``integrity`` and ``memory_guard`` (with its
        ``allowed_mem``), each exported to the env; and a cancellation
        token, *cancellation* or one minted for ``deadline_s`` (which
        tightens a given token), registered under the compute id and passed
        to the executor. ``resume=True`` skips the tasks (on the device
        executor the ops) whose outputs all verify. ``Spec(journal=path)``
        attaches a ``runtime.journal.JournalCallback`` writing the compute's
        tasks and decisions there; ``resume_from_journal=path`` resumes,
        skipping only what both verifies and the journal recorded complete.

        Observability is armed as in the reference
        (``cubed_tpu/core/plan.py:283-335,367-402,466-480``): live telemetry
        (``observability/export.py``, env > ``Spec(telemetry_port=)``), with
        a ``ComputeProgressCallback`` when it runs; a ``FlightRecorder`` when
        ``CUBED_TPU_TORCH_FLIGHT_RECORDER`` names a directory and no
        collector is attached; ``Spec(run_history=)`` reuses the attached
        collector (or attaches one) and appends the compute's record after
        ``on_compute_end``, fingerprinting the pre-finalize plan; the
        dispatch profiler around the executor (env >
        ``Spec(dispatch_profile=)``).

        ``finalized`` runs a plan finalized earlier (the compute service's
        plan cache) and skips optimization and lazy-array creation; the
        caller answers for the structural match that makes this sound."""
        from ..runtime import cancellation as cancel_mod
        from ..runtime import faults, memory
        from ..storage import integrity

        if executor is None:
            from ..runtime.executors.python import PythonDagExecutor

            executor = PythonDagExecutor()
        cancel_token = cancellation
        if deadline_s is not None:
            if cancel_token is None:
                cancel_token = cancel_mod.CancellationToken()
            cancel_token.set_deadline(deadline_s)
        if cancel_token is not None:
            kwargs["cancellation"] = cancel_token
        if resume_from_journal is not None:
            # the journal's completions intersect the integrity scan (the
            # executors build their ResumeState from it)
            from ..runtime.journal import load_journal

            resume = True
            kwargs["journal"] = load_journal(resume_from_journal)
        if finalized is None:
            finalized = self._finalize(optimize_graph, optimize_function, array_names)
        dag = finalized.dag
        compute_id = f"c-{uuid.uuid4().hex[:10]}"
        aggregator = _ComputeAggregator()
        all_callbacks = list(callbacks) if callbacks else []
        all_callbacks.append(aggregator)
        journal_path = getattr(spec, "journal", None)
        if journal_path:
            from ..runtime.journal import JournalCallback

            all_callbacks.append(JournalCallback(journal_path))
        from ..observability import dispatchprofile
        from ..observability import export as telemetry_export
        from ..observability.flightrecorder import FLIGHT_RECORDER_ENV_VAR, FlightRecorder
        from ..observability.timeseries import ComputeProgressCallback

        if telemetry_export.maybe_start(spec) is not None:
            all_callbacks.append(ComputeProgressCallback())
        recorder_dir = os.environ.get(FLIGHT_RECORDER_ENV_VAR)
        if recorder_dir and not any(isinstance(cb, TraceCollector) for cb in all_callbacks):
            # two collectors would double-count spans_dropped and the
            # straggler watch: an attached one suppresses the recorder
            all_callbacks.append(FlightRecorder(bundle_dir=recorder_dir))
        # the run record's buckets need the merged task spans: an attached
        # collector is reused, else one is attached
        run_history_dir = getattr(spec, "run_history", None)
        run_collector = None
        if run_history_dir:
            run_collector = next((cb for cb in all_callbacks if isinstance(cb, TraceCollector)), None)
            if run_collector is None:
                run_collector = TraceCollector(trace_dir=None)
                all_callbacks.append(run_collector)
        run_started_at = time.monotonic()
        metrics_before = get_registry().snapshot()
        callbacks_on(all_callbacks, "on_compute_start", ComputeStartEvent(dag, resume, compute_id=compute_id))
        if cancel_token is not None:
            cancel_mod.register_compute(compute_id, cancel_token)
        compute_error: Optional[BaseException] = None
        try:
            # span recording is armed only while a collector merges the
            # spans; None leaves an operator's CUBED_TPU_TORCH_TASK_SPANS as
            # it is. A None spec setting leaves its layer to the env var or
            # its default; no spec at all arms no memory guard (no budget)
            armed = True if any(isinstance(cb, TraceCollector) for cb in all_callbacks) else None
            with logs.compute_scope(compute_id, export_env=True), \
                    accounting.spans_scoped(armed, export_env=True), \
                    faults.scoped(getattr(spec, "fault_injection", None), export_env=True), \
                    integrity.scoped(getattr(spec, "integrity", None), export_env=True), \
                    memory.scoped(getattr(spec, "memory_guard", None),
                                  allowed_mem=getattr(spec, "allowed_mem", None), export_env=True), \
                    dispatchprofile.profile_scoped(spec, compute_id):
                executor.execute_dag(dag, callbacks=all_callbacks, array_names=array_names, resume=resume,
                                     spec=spec, **kwargs)
        except BaseException as e:
            compute_error = e
            raise
        finally:
            if cancel_token is not None:
                cancel_mod.unregister_compute(compute_id)
            # the end event fires even when the compute fails; assembling
            # its stats never masks the executor's own exception. Where an
            # executor counter shares a name with a registry metric, the
            # per-compute registry value wins
            stats: dict = {}
            try:
                executor_own = getattr(executor, "stats", None)
                if executor_own:
                    stats.update(dict(executor_own))
                stats.update(get_registry().snapshot_delta(metrics_before))
                stats.update(aggregator.summary())
            except Exception:
                logger.exception("failed to assemble executor_stats; reporting partial stats (%d keys)",
                                 len(stats))
            callbacks_on(all_callbacks, "on_compute_end", ComputeEndEvent(
                dag, executor_stats=stats or None, compute_id=compute_id, error=compute_error))
            if run_history_dir:
                # after on_compute_end, so the collector's trace is sealed;
                # the pre-finalize dag, whose intermediates' paths the
                # fingerprint masks. The append never raises
                from ..observability import runhistory

                runhistory.record_compute(run_history_dir, compute_id=compute_id, dag=self.dag,
                                          error=compute_error, stats=stats, collector=run_collector,
                                          wall_clock_s=time.monotonic() - run_started_at)
            # the error's traceback holds this frame: a reference to the
            # error from here would keep both, and every block a failed
            # task's frames hold (on the card too), until a garbage
            # collection
            compute_error = None


class FinalizedPlan:
    """An optimized DAG with its lazy arrays' creation op, ready to run."""

    def __init__(self, dag: Dag):
        self.dag = dag

    def num_tasks(self, resume=None) -> int:
        """Task count, chunk-granular under ``resume``: a partly complete op
        counts only its pending tasks, as the sequential executor would run
        them. The scan is read-only (no quarantine, no metrics)."""
        state = ResumeState(count=False) if resume else None
        total = 0
        for name in self.dag.topological_sort():
            if already_computed(name, self.dag, self.dag.nodes, resume, state):
                continue
            node = self.dag.nodes[name]
            if resume:
                _, skipped = pending_mappable(name, node, resume, state, record=False)
                total += node["primitive_op"].num_tasks - skipped
            else:
                total += node["primitive_op"].num_tasks
        return total

    def num_arrays(self) -> int:
        return sum(1 for d in self.dag.nodes.values() if d.get("type") == "array")

    def num_ops(self) -> int:
        return sum(1 for _ in iter_op_nodes(self.dag))

    def max_projected_mem(self, resume=None) -> int:
        """Peak projected memory over the ops a compute would run; under
        ``resume`` an op whose outputs all verify drops out."""
        state = ResumeState(count=False) if resume else None
        mems = [
            self.dag.nodes[name]["primitive_op"].projected_mem
            for name in self.dag.topological_sort()
            if not already_computed(name, self.dag, self.dag.nodes, resume, state)
        ]
        return max(mems) if mems else 0

    def total_nbytes_written(self) -> int:
        """Bytes of every array the plan writes to storage (uncompressed)."""
        return sum(
            d["target"].nbytes
            for d in self.dag.nodes.values()
            if d.get("type") == "array" and isinstance(d.get("target"), LazyZarrArray)
        )

    def explain(self, spec=None):
        """EXPLAIN this already-finalized plan (see ``Plan.explain``)."""
        from ..observability.analytics import explain_finalized

        return explain_finalized(self, spec=spec)


def create_lazy_zarr_arrays(dag: Dag) -> Dag:
    """Add one first op that writes the metadata of every lazy target."""
    targets = [
        d["target"]
        for d in dag.nodes.values()
        if d.get("type") == "array" and isinstance(d.get("target"), LazyZarrArray)
    ]
    if not targets:
        return dag
    op_node = "create-arrays"
    pipeline = CubedPipeline(create_zarr_array, op_node, targets, None)
    primitive_op = PrimitiveOperation(
        pipeline=pipeline,
        source_array_names=[],
        target_array=None,
        projected_mem=0,
        allowed_mem=0,
        reserved_mem=0,
        num_tasks=len(targets),
        fusable=False,
    )
    others = [name for name, _ in iter_op_nodes(dag)]
    dag.add_node(
        op_node, name=op_node, type="op", op_display_name=f"{op_node}\n{len(targets)} arrays", op_name=op_node,
        primitive_op=primitive_op, hidden=False, stack_summaries=[],
    )
    for name in others:
        dag.add_edge(op_node, name)
    return dag


def arrays_to_dag(*arrays) -> Dag:
    """Union of the plans of the given arrays (sharing nodes by name)."""
    from .array import check_array_specs

    check_array_specs(arrays)
    return Dag.compose(*[a.plan.dag for a in arrays if hasattr(a, "plan")])


def arrays_to_plan(*arrays) -> Plan:
    return Plan(arrays_to_dag(*arrays))


def create_zarr_array(lazy_array: LazyZarrArray, config=None) -> None:
    """Task body of the create-arrays op."""
    lazy_array.create()
