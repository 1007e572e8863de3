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

import logging
import os
import tempfile
import uuid
from typing import Iterator, Optional

from ..observability import accounting, logs
from ..observability.callback import _ComputeAggregator
from ..observability.collect import TraceCollector
from ..observability.metrics import get_registry
from ..primitive.types import CubedPipeline, PrimitiveOperation
from ..runtime.types import ComputeEndEvent, ComputeStartEvent, callbacks_on
from ..storage.zarr import LazyZarrArray
from ..utils import gensym, join_path  # noqa: F401  (gensym re-exported for plan builders)

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


def iter_op_nodes(dag: Dag) -> Iterator[tuple[str, dict]]:
    """(name, node data) of every op node that carries real work."""
    for name, d in dag.nodes.items():
        if d.get("type") == "op" and d.get("primitive_op") is not None:
            yield name, d


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
        op_node = gensym(f"op-{op_name}")
        names = list(name) if isinstance(name, (list, tuple)) else [name]
        targets = list(target) if isinstance(name, (list, tuple)) else [target]
        dag.add_node(
            op_node,
            name=op_node,
            type="op",
            op_name=op_name,
            primitive_op=primitive_op,
            hidden=hidden,
        )
        for n, t in zip(names, targets):
            dag.add_node(n, name=n, type="array", target=t, hidden=hidden)
            dag.add_edge(op_node, n)
        for x in source_arrays:
            dag.add_edge(x.name, op_node)
        return Plan(dag)

    def _finalize(self, optimize_graph: bool = True, array_names=None) -> "FinalizedPlan":
        """The plan as it runs: fused (unless *optimize_graph* is false; the
        arrays in *array_names* are kept as outputs), with its create-arrays op."""
        from .optimization import multiple_inputs_optimize_dag

        dag = self.dag.copy()
        if optimize_graph:
            dag = multiple_inputs_optimize_dag(dag, array_names=array_names)
        return FinalizedPlan(create_lazy_zarr_arrays(dag))

    def num_tasks(self, optimize_graph: bool = True) -> int:
        return self._finalize(optimize_graph).num_tasks()

    def max_projected_mem(self, optimize_graph: bool = True) -> int:
        """The largest memory any task of the plan is projected to need."""
        return self._finalize(optimize_graph).max_projected_mem()

    def execute(
        self, executor=None, callbacks=None, optimize_graph=True, array_names=None, spec=None,
    ) -> None:
        """Finalize the plan and run it on *executor* (default: the
        sequential ``PythonDagExecutor``), as one compute: a compute id, a
        ``_ComputeAggregator`` beside *callbacks*, ``on_compute_start``,
        the executor under the compute's log scope (and span recording,
        armed while a ``TraceCollector`` is attached), and, even when the
        compute fails, ``on_compute_end`` with ``executor_stats`` (the
        executor's own ``stats``, the registry's delta over the compute and
        the per-op summary) and the error. The reference's journal,
        telemetry, flight recorder, run history, faults, integrity, memory
        guard and dispatch profiler are not ported (ROADMAP Queue 1)."""
        if executor is None:
            from ..runtime.executors.python import PythonDagExecutor

            executor = PythonDagExecutor()
        dag = self._finalize(optimize_graph, array_names).dag
        compute_id = f"c-{uuid.uuid4().hex[:10]}"
        aggregator = _ComputeAggregator()
        all_callbacks = list(callbacks) if callbacks else []
        all_callbacks.append(aggregator)
        metrics_before = get_registry().snapshot()
        callbacks_on(all_callbacks, "on_compute_start", ComputeStartEvent(dag, compute_id=compute_id))
        compute_error: Optional[BaseException] = None
        try:
            # span recording is armed only while a collector merges the
            # spans; None leaves an operator's CUBED_TPU_TORCH_TASK_SPANS as
            # it is
            armed = True if any(isinstance(cb, TraceCollector) for cb in all_callbacks) else None
            with logs.compute_scope(compute_id, export_env=True), \
                    accounting.spans_scoped(armed, export_env=True):
                executor.execute_dag(dag, callbacks=all_callbacks, array_names=array_names, spec=spec)
        except BaseException as e:
            compute_error = e
            raise
        finally:
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


class FinalizedPlan:
    """An optimized DAG with its lazy arrays' creation op, ready to run."""

    def __init__(self, dag: Dag):
        self.dag = dag

    def num_tasks(self) -> int:
        return sum(d["primitive_op"].num_tasks for _, d in iter_op_nodes(self.dag))

    def num_ops(self) -> int:
        return sum(1 for _ in iter_op_nodes(self.dag))

    def max_projected_mem(self) -> int:
        mems = [d["primitive_op"].projected_mem for _, d in iter_op_nodes(self.dag)]
        return max(mems) if mems else 0


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
        op_node, name=op_node, type="op", op_name=op_node,
        primitive_op=primitive_op, hidden=False,
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
