"""The port's chunk-granular dataflow scheduler held against the JAX
package's (counterpart of tests/runtime/test_dataflow.py, less its
process-pool, fleet and diagnose cases): mode resolution, the chunk graph's
edges (key for key against the reference's on five plan kinds), dependency
gating in the map, the overlap proof, chaos bit for bit, a repair mid-overlap,
and resume across the chunk-level frontier."""

from __future__ import annotations

import ast
import concurrent.futures
import contextlib
import glob
import itertools
import os
import threading
import time

import numpy as np
import pytest

import cubed_tpu as ct_ref
import cubed_tpu.array_api as ref_xp
import cubed_tpu_torch as ct
import cubed_tpu_torch.array_api as xp
from cubed_tpu.core.ops import general_blockwise as ref_general_blockwise
from cubed_tpu.core.plan import arrays_to_plan as ref_arrays_to_plan
from cubed_tpu.runtime.dataflow import build_chunk_graph as ref_build_chunk_graph
from cubed_tpu.runtime.executors.python_async import AsyncPythonDagExecutor as RefAsyncPythonDagExecutor
from cubed_tpu_torch.backend_array_api import set_device
from cubed_tpu_torch.core.ops import general_blockwise
from cubed_tpu_torch.core.plan import arrays_to_plan
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime import faults, pipeline
from cubed_tpu_torch.runtime.dataflow import (
    DEFAULT_MODE,
    SCHEDULER_ENV_VAR,
    build_chunk_graph,
    effective_scheduler,
    resolve_scheduler,
)
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor, map_unordered
from cubed_tpu_torch.runtime.pipeline import _task_chunk_key
from cubed_tpu_torch.runtime.resilience import RetryPolicy
from cubed_tpu_torch.runtime.types import Callback


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    set_device("cpu")
    monkeypatch.delenv(SCHEDULER_ENV_VAR, raising=False)
    yield
    faults.deactivate()


def _dataflow_spec(tmp_path, **kwargs):
    return ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", scheduler="dataflow", **kwargs)


def _finalized_dag(arr):
    return arrays_to_plan(arr)._finalize(optimize_graph=False).dag


class TaskCounter(Callback):
    def __init__(self):
        self.value = 0

    def on_task_end(self, event):
        self.value += event.num_tasks


class _StatsCapture:
    stats: dict = {}

    def on_compute_end(self, event):
        self.stats = event.executor_stats or {}


def _by_op(g) -> dict:
    by_op: dict = {}
    for idx, (name, _m) in enumerate(g.items):
        by_op.setdefault(name, []).append(idx)
    return by_op


# -- mode resolution -----------------------------------------------------


def test_resolve_scheduler_default_and_spec(tmp_path):
    assert resolve_scheduler(None) == DEFAULT_MODE == "dataflow"
    assert resolve_scheduler(ct.Spec(work_dir=str(tmp_path), scheduler="oplevel")) == "oplevel"
    assert resolve_scheduler(_dataflow_spec(tmp_path)) == "dataflow"
    # a defaulted dataflow yields to batch_size, an explicit one wins
    assert effective_scheduler(None, batch_size=4) == "oplevel"
    assert effective_scheduler(_dataflow_spec(tmp_path), batch_size=4) == "dataflow"


def test_resolve_scheduler_env_wins(tmp_path, monkeypatch):
    assert SCHEDULER_ENV_VAR == "CUBED_TPU_TORCH_SCHEDULER"
    monkeypatch.setenv(SCHEDULER_ENV_VAR, "oplevel")
    assert resolve_scheduler(_dataflow_spec(tmp_path)) == "oplevel"
    monkeypatch.setenv(SCHEDULER_ENV_VAR, "dataflow")
    assert resolve_scheduler(None) == "dataflow"


def test_resolve_scheduler_invalid_raises(monkeypatch):
    with pytest.raises(ValueError, match="invalid scheduler"):
        ct.Spec(scheduler="chunkwise")
    with pytest.raises(ValueError, match="journal must be a file path"):
        ct.Spec(journal=1)
    monkeypatch.setenv(SCHEDULER_ENV_VAR, "bogus")
    with pytest.raises(ValueError, match="invalid scheduler"):
        resolve_scheduler(None)


# -- the chunk graph -----------------------------------------------------


def test_chunk_graph_elementwise_one_to_one(tmp_path):
    """Each task of an elementwise consumer depends on exactly the matching
    chunk's task of its producer, besides the create-arrays bootstrap."""
    a = ct.from_array(np.arange(64, dtype=np.float64).reshape(8, 8), chunks=(2, 2), spec=_dataflow_spec(tmp_path))
    g = build_chunk_graph(_finalized_dag(xp.multiply(xp.add(a, 1.0), 2.0)))
    assert g.op_order[0] == "create-arrays"
    op1, op2 = g.op_order[1], g.op_order[2]
    by_op = _by_op(g)
    create_idxs = set(by_op["create-arrays"])
    op1_key_to_idx = {_task_chunk_key(g.items[i][1]): i for i in by_op[op1]}
    assert len(by_op[op1]) == len(by_op[op2]) == 16
    for idx in by_op[op2]:
        assert g.dependencies[idx] - create_idxs == {op1_key_to_idx[_task_chunk_key(g.items[idx][1])]}
    assert g.barrier_tasks == 0


def test_chunk_graph_reduction_fan_in(tmp_path):
    """A tree reduction fans in: a task of some stage depends on several
    producer chunks, and one such stage consumes its producer whole."""
    a = ct.from_array(np.arange(256, dtype=np.float64).reshape(16, 16), chunks=(2, 2), spec=_dataflow_spec(tmp_path))
    g = build_chunk_graph(_finalized_dag(xp.sum(xp.add(a, 1.0))))
    by_op = _by_op(g)
    create_idxs = set(by_op["create-arrays"])
    fan_in = []
    for producer in g.op_order[1:]:
        p_idxs = set(by_op[producer])
        for consumer in g.op_order[2:]:
            if consumer == producer:
                continue
            per_task = [(g.dependencies.get(i, set()) - create_idxs) & p_idxs for i in by_op[consumer]]
            consumed = set().union(*per_task) if per_task else set()
            if consumed and max(len(d) for d in per_task) >= 2:
                fan_in.append(consumed == p_idxs)
    assert fan_in and any(fan_in)


def test_chunk_graph_rechunk_is_chunked(tmp_path):
    """A rechunk task depends on exactly the producer tasks its region
    overlaps, its consumers on the covering rechunk task only, and nothing
    is a barrier."""
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="700KB", scheduler="dataflow")
    a = ct.from_array(np.arange(128 * 128, dtype=np.float64).reshape(128, 128), chunks=(32, 128), spec=spec)
    c = xp.add(ct.rechunk(xp.add(a, 1.0), (128, 32)), 5.0)
    g = build_chunk_graph(_finalized_dag(c))
    by_op = _by_op(g)
    rechunk_ops = [n for n, k in g.op_kind.items() if k == "rechunk"]
    assert rechunk_ops and g.barrier_tasks == 0 and g.barrier_ops == []
    create_idxs = set(by_op["create-arrays"])
    add_key_to_idx = {_task_chunk_key(g.items[i][1]): i for i in by_op[g.op_order[1]]}
    first = rechunk_ops[0]
    assert len(by_op[first]) > 1, "consolidated into one task"
    for idx in by_op[first]:
        _, m = g.items[idx]
        expected = {add_key_to_idx[key] for _s, key in pipeline.rechunk_task_reads(m, g.pipelines[first].config)}
        assert g.dependencies[idx] - create_idxs == expected
        assert g.reads[idx]
    last = rechunk_ops[-1]
    cover = {key: i for i in by_op[last]
             for key in pipeline.rechunk_task_writes(g.items[i][1], g.pipelines[last].config)}
    for idx in by_op[g.op_order[-1]]:
        assert g.dependencies[idx] - create_idxs == {cover[_task_chunk_key(g.items[idx][1])]}


def _stores(work_dir) -> list:
    return sorted(os.path.dirname(p) for p in glob.glob(f"{work_dir}/*/*.zarr/.zarray"))


def test_chunk_graph_resume_satisfies_deps(tmp_path):
    """After a full compute, one final chunk deleted: a one-task graph whose
    dependency on the (complete) producer is born satisfied."""
    spec = _dataflow_spec(tmp_path)
    an = np.arange(100, dtype=np.float64).reshape(10, 10)
    c = xp.multiply(xp.add(ct.from_array(an, chunks=(2, 2), spec=spec), 1.0), 2.0)
    np.testing.assert_array_equal(c.compute(optimize_graph=False), (an + 1.0) * 2.0)
    stores = _stores(spec.work_dir)
    assert len(stores) == 2
    os.unlink(os.path.join(stores[-1], "3.3"))
    g = build_chunk_graph(_finalized_dag(c), resume=True)
    chunk_items = [i for i, (name, _m) in enumerate(g.items) if name != "create-arrays"]
    assert len(chunk_items) == 1
    create_idxs = {i for i, (name, _m) in enumerate(g.items) if name == "create-arrays"}
    assert g.dependencies.get(chunk_items[0], set()) <= create_idxs


@contextlib.contextmanager
def _pinned_names(base: int):
    """Both packages' plan-name counters pinned to *base*, so one plan built
    in each has the same op and array names."""
    import cubed_tpu.utils as ref_utils
    import cubed_tpu_torch.utils as utils

    saved = (utils.sym_counter, ref_utils.sym_counter)
    utils.sym_counter = itertools.count(base)
    ref_utils.sym_counter = itertools.count(base)
    try:
        yield
    finally:
        used = max(next(utils.sym_counter), next(ref_utils.sym_counter)) - base
        utils.sym_counter = itertools.count(next(saved[0]) + used)
        ref_utils.sym_counter = itertools.count(next(saved[1]) + used)


def _edge_plan(pkg, mod, spec, kind, an):
    if kind == "blockwise":
        return mod.multiply(mod.add(pkg.from_array(an, chunks=(4, 4), spec=spec), 1.0), 2.0)
    if kind == "tree_reduction":
        return mod.sum(mod.add(pkg.from_array(an, chunks=(2, 2), spec=spec), 1.0))
    if kind == "rechunk":
        # region overlaps: (4, 16) rows to (16, 3) columns, neither dividing
        # the other
        return mod.add(pkg.rechunk(mod.add(pkg.from_array(an, chunks=(4, 16), spec=spec), 1.0), (16, 3)), 5.0)
    a = pkg.from_array(an, chunks=(4, 4), spec=spec)
    if kind == "multi_output":
        gb = general_blockwise if pkg is ct else ref_general_blockwise
        p, d = gb(lambda x: (x + 1.0, x * 2.0), lambda k: ((a.name, *k[1:]),), a, shape=a.shape,
                  dtype=[a.dtype, a.dtype], chunks=a.chunks, op_name="two_out")
        return mod.add(p, d)
    # the create-arrays barrier: a plan whose every op waits on the bootstrap
    return mod.negative(a)


@pytest.mark.parametrize("kind", ["blockwise", "tree_reduction", "rechunk", "multi_output", "create_arrays"])
def test_chunk_graph_edges_equal_the_reference_key_for_key(tmp_path, monkeypatch, kind):
    import cubed_tpu.core.plan as ref_plan
    import cubed_tpu_torch.core.plan as plan

    monkeypatch.setattr(plan, "CONTEXT_ID", "ctx-edges")
    monkeypatch.setattr(ref_plan, "CONTEXT_ID", "ctx-edges")
    an = np.random.default_rng(3).random((16, 16))
    with _pinned_names(770_000_000):
        p = _edge_plan(ct, xp, ct.Spec(work_dir=str(tmp_path), allowed_mem="100MB"), kind, an)
    with _pinned_names(770_000_000):
        r = _edge_plan(ct_ref, ref_xp, ct_ref.Spec(work_dir=str(tmp_path), allowed_mem="100MB"), kind, an)
    g = build_chunk_graph(arrays_to_plan(p)._finalize(optimize_graph=False).dag)
    rg = ref_build_chunk_graph(ref_arrays_to_plan(r)._finalize(optimize_graph=False).dag)
    edges = g.edges_by_key()
    assert edges == rg.edges_by_key()
    assert g.op_kind == rg.op_kind and g.barrier_tasks == rg.barrier_tasks
    assert sum(map(len, edges.values())) > 0
    if kind == "rechunk":
        assert "rechunk" in g.op_kind.values()


# -- dependency gating in the map -----------------------------------------


def test_map_unordered_dependencies_enforce_order():
    order: list = []
    lock = threading.Lock()

    def fn(i):
        with lock:
            order.append(i)
        time.sleep(0.01)
        return i

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        map_unordered(pool, fn, list(range(6)), dependencies={0: {4}, 1: {4}, 2: {4}, 4: {5}})
    pos = {i: order.index(i) for i in range(6)}
    assert pos[5] < pos[4] and all(pos[4] < pos[i] for i in (0, 1, 2))


def test_map_unordered_dependency_cycle_raises():
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        with pytest.raises(RuntimeError, match="dataflow deadlock"):
            map_unordered(pool, lambda i: i, [0, 1], dependencies={0: {1}, 1: {0}})


def test_map_unordered_completed_inputs_resume():
    ran: list = []
    lock = threading.Lock()

    def fn(i):
        with lock:
            ran.append(i)
        return i

    done_hook: list = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        map_unordered(pool, fn, list(range(4)), dependencies={3: {0, 1}}, completed_inputs={0, 1},
                      on_input_done=done_hook.append)
    assert sorted(ran) == [2, 3] and sorted(done_hook) == [2, 3]


def test_map_unordered_dependencies_reject_batching():
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        with pytest.raises(ValueError, match="mutually"):
            map_unordered(pool, lambda i: i, [0, 1], batch_size=1, dependencies={1: {0}})


# -- the overlap proof ---------------------------------------------------


class _SlowBlock:
    """Block (0, 0) sleeps; every other block is instant."""

    def __init__(self, delay_s: float):
        self.delay_s = delay_s

    def __call__(self, x, block_id=None):
        if block_id == (0, 0):
            time.sleep(self.delay_s)
        return x + 1.0


class _LifecycleWatch(Callback):
    def __init__(self):
        self.task_starts: dict = {}
        self.op_ends: dict = {}

    def on_task_start(self, event):
        self.task_starts.setdefault(event.array_name, []).append(time.time())

    def on_operation_end(self, event):
        self.op_ends[event.name] = time.time()


def test_dataflow_overlap_downstream_starts_before_upstream_ends(tmp_path):
    """With one slow chunk upstream, a downstream task starts while the
    upstream op still runs, and the result equals the reference's threaded
    one bit for bit."""
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    a = ct.from_array(an, chunks=(2, 2), spec=_dataflow_spec(tmp_path))
    c = xp.add(ct.map_blocks(_SlowBlock(0.4), a, dtype=np.float64), 1.0)
    watch = _LifecycleWatch()
    before = get_registry().snapshot()
    result = c.compute(executor=AsyncPythonDagExecutor(), callbacks=[watch], optimize_graph=False)
    np.testing.assert_array_equal(result, an + 2.0)
    assert get_registry().snapshot_delta(before).get("tasks_dispatched_early", 0) >= 1
    ops = [op for op in watch.op_ends if op != "create-arrays"]
    assert len(ops) == 2
    upstream = min(ops, key=lambda op: min(watch.task_starts[op]))
    downstream = [op for op in ops if op != upstream][0]
    assert min(watch.task_starts[downstream]) < watch.op_ends[upstream] - 0.15
    ra = ct_ref.from_array(an, chunks=(2, 2), spec=ct_ref.Spec(work_dir=str(tmp_path / "ref"),
                                                                allowed_mem="500MB", scheduler="dataflow"))
    rc = ref_xp.add(ct_ref.map_blocks(_SlowBlock(0.0), ra, dtype=np.float64), 1.0)
    np.testing.assert_array_equal(result, rc.compute(executor=RefAsyncPythonDagExecutor(), optimize_graph=False))


def test_dataflow_env_var_drives_overlap(tmp_path, monkeypatch):
    monkeypatch.setenv(SCHEDULER_ENV_VAR, "dataflow")
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    a = ct.from_array(an, chunks=(2, 2), spec=ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB"))
    before = get_registry().snapshot()
    result = xp.multiply(xp.add(a, 1.0), 2.0).compute(executor=AsyncPythonDagExecutor(), optimize_graph=False)
    np.testing.assert_array_equal(result, (an + 1.0) * 2.0)
    assert get_registry().snapshot_delta(before).get("tasks_dispatched_early", 0) >= 1


# -- chaos ----------------------------------------------------------------

CHAOS = dict(seed=42, storage_read_failure_rate=0.08, storage_write_failure_rate=0.12, task_failure_rate=0.08)


@pytest.mark.chaos
def test_dataflow_chaos_threaded_bitwise_correct(tmp_path):
    """Seeded faults under the dataflow scheduler: the store equals the
    fault-free sequential one bit for bit (thread order varies which tasks
    a fault hits, so the fault counts are not compared)."""
    an = np.arange(400, dtype=np.float64).reshape(20, 20)
    clean = xp.multiply(xp.add(ct.from_array(an, chunks=(2, 2), spec=_dataflow_spec(tmp_path / "clean")), 1.0), 2.0)
    expected = clean.compute(executor=PythonDagExecutor(), optimize_graph=False)
    a = ct.from_array(an, chunks=(2, 2), spec=_dataflow_spec(tmp_path / "chaos", fault_injection=CHAOS))
    cap = _StatsCapture()
    result = xp.multiply(xp.add(a, 1.0), 2.0).compute(
        executor=AsyncPythonDagExecutor(retry_policy=RetryPolicy(retries=6, backoff_base=0.01, seed=0)),
        callbacks=[cap], optimize_graph=False)
    np.testing.assert_array_equal(result, expected)
    assert cap.stats.get("faults_injected", 0) > 0 and cap.stats.get("task_retries", 0) > 0, cap.stats


class _CorruptFirstChunkTask(Callback):
    """Flips a byte in the chunk written by the first completed chunk task
    (an upstream one). Task-end callbacks fire before the loop releases
    dependents, so its reader has not read it yet."""

    def __init__(self, work_dir: str):
        self.work_dir = work_dir
        self.corrupted = None

    def on_task_end(self, event):
        if self.corrupted is not None or event.array_name == "create-arrays":
            return
        try:
            key = ast.literal_eval(event.chunk_key)
        except (ValueError, SyntaxError):
            return
        paths = glob.glob(f"{self.work_dir}/*/{key[0]}.zarr/{'.'.join(str(i) for i in key[1:])}")
        if not paths:
            return
        with open(paths[0], "r+b") as f:
            data = bytearray(f.read())
            data[3] ^= 0xFF
            f.seek(0)
            f.write(data)
        self.corrupted = paths[0]


@pytest.mark.chaos
def test_dataflow_chaos_corruption_recompute_mid_overlap(tmp_path):
    """A corrupt intermediate chunk found while its op still runs: its reader
    triggers RECOMPUTE of that producing task, the frontier keeps flowing,
    and the result is bit for bit right."""
    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    a = ct.from_array(an, chunks=(2, 2), spec=_dataflow_spec(tmp_path, integrity="verify"))
    c = xp.multiply(ct.map_blocks(_SlowBlock(0.4), a, dtype=np.float64), 2.0)
    corruptor = _CorruptFirstChunkTask(str(tmp_path))
    before = get_registry().snapshot()
    result = c.compute(executor=AsyncPythonDagExecutor(retry_policy=RetryPolicy(retries=4, backoff_base=0.01, seed=0)),
                       callbacks=[corruptor], optimize_graph=False)
    np.testing.assert_array_equal(result, (an + 1.0) * 2.0)
    assert corruptor.corrupted is not None
    delta = get_registry().snapshot_delta(before)
    assert delta.get("chunks_corrupt_detected", 0) >= 1, delta
    assert delta.get("chunks_recomputed", 0) >= 1, delta
    assert delta.get("tasks_dispatched_early", 0) >= 1, delta


# -- resume across the chunk-level frontier -------------------------------


def test_dataflow_resume_chunk_granular_frontier(tmp_path):
    """One intermediate and one other final chunk deleted: the resumed
    compute runs the two producing tasks and create-arrays, as the plan's
    introspection says."""
    spec = _dataflow_spec(tmp_path)
    an = np.arange(100, dtype=np.float64).reshape(10, 10)
    c = xp.multiply(xp.add(ct.from_array(an, chunks=(2, 2), spec=spec), 1.0), 2.0)
    np.testing.assert_array_equal(c.compute(optimize_graph=False), (an + 1.0) * 2.0)
    inter_store, final_store = _stores(spec.work_dir)
    os.unlink(os.path.join(inter_store, "1.1"))
    os.unlink(os.path.join(final_store, "2.2"))
    plan_tasks = arrays_to_plan(c).num_tasks(optimize_graph=False, resume=True)
    before = get_registry().snapshot()
    counter = TaskCounter()
    result = c.compute(executor=AsyncPythonDagExecutor(), optimize_graph=False, resume=True, callbacks=[counter])
    np.testing.assert_array_equal(result, (an + 1.0) * 2.0)
    assert get_registry().snapshot_delta(before).get("tasks_skipped_resume") == 48
    assert counter.value == 4 == plan_tasks


def test_dataflow_resume_dependency_on_missing_upstream_chunk(tmp_path):
    """The same chunk missing in both stores: the final task waits on its
    producer's re-run (a live cross-op edge in the resumed frontier)."""
    spec = _dataflow_spec(tmp_path)
    an = np.arange(100, dtype=np.float64).reshape(10, 10)
    c = xp.multiply(xp.add(ct.from_array(an, chunks=(2, 2), spec=spec), 1.0), 2.0)
    np.testing.assert_array_equal(c.compute(optimize_graph=False), (an + 1.0) * 2.0)
    inter_store, final_store = _stores(spec.work_dir)
    os.unlink(os.path.join(inter_store, "1.1"))
    os.unlink(os.path.join(final_store, "1.1"))
    g = build_chunk_graph(_finalized_dag(c), resume=True)
    chunk_items = [i for i, (name, _m) in enumerate(g.items) if name != "create-arrays"]
    assert len(chunk_items) == 2
    up_idx, down_idx = chunk_items
    create_idxs = {i for i, (name, _m) in enumerate(g.items) if name == "create-arrays"}
    assert g.array_names[up_idx] != g.array_names[down_idx]
    assert g.dependencies.get(down_idx, set()) - create_idxs == {up_idx}
    counter = TaskCounter()
    result = c.compute(executor=AsyncPythonDagExecutor(), optimize_graph=False, resume=True, callbacks=[counter])
    np.testing.assert_array_equal(result, (an + 1.0) * 2.0)
    assert counter.value == 4
