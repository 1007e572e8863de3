"""The compute lifecycle of the port (``Plan.execute``, the executors' events,
``executor_stats``, the tracing callbacks and the extensions): the
counterparts of tests/observability/test_lifecycle.py (without the
distributed executor), and parity with the JAX package on one plan built in
both: the reference test's two-op pipeline and a small vorticity, (50, 45,
40) / 10. Ops are matched by ``op_name`` and their order of first
appearance. The sequential executors must give the same event sequence and
equal task, byte and chunk counts; ``CudaExecutor`` (chunks on the CPU) and
``JaxExecutor`` the same event sequence, path counters, ``tasks_completed``
and flush bytes; both the same ``(cat, name)`` multiset in the merged
trace. Observers must not change the device executor's route."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import collections  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.observability import TraceCollector as ReferenceTraceCollector  # noqa: E402
from cubed_tpu.runtime import types as reference_types  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu.runtime.executors.python import PythonDagExecutor as ReferencePythonDagExecutor  # noqa: E402
from cubed_tpu_torch.observability import (  # noqa: E402
    DeviceMemoryCallback,
    TorchProfilerCallback,
    TraceCollector,
    TracingCallback,
)
from cubed_tpu_torch.runtime import types as port_types  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor  # noqa: E402
from cubed_tpu_torch.runtime.types import Callback  # noqa: E402

#: the device executor's path counters, each equal to the reference's
PATH_COUNTERS = ("whole_array_hits", "whole_concat_hits", "batched_ops", "chunked_ops", "eager_ops",
                 "rechunk_alias", "rechunk_virtual")
#: the counts the sequential executors of both packages must agree on
IO_COUNTS = ("tasks_completed", "bytes_read", "bytes_written", "chunks_read", "chunks_written")


def _op_names(dag) -> dict:
    """node name -> op_name of every op node, for a networkx graph or the
    port's ``Dag``."""
    items = dag.nodes(data=True) if callable(dag.nodes) else dag.nodes.items()
    return {n: d.get("op_name") for n, d in items if d.get("type") == "op"}


def _recorder(types_mod):
    class LifecycleRecorder(types_mod.Callback):
        """Every lifecycle event in order, ops named ``op_name#k`` (k: the
        order of the op's first event among ops of its ``op_name``)."""

        def __init__(self):
            self.calls = []
            self.names = {}
            self.num_tasks = {}

        def canonical(self, name):
            if name not in self.names:
                kind = self._op_names.get(name, name)
                self.names[name] = f"{kind}#{sum(v.startswith(kind + '#') for v in self.names.values())}"
            return self.names[name]

        def on_compute_start(self, event):
            self._op_names = _op_names(event.dag)
            self.compute_id = event.compute_id
            self.calls.append(("compute_start", None))

        def on_operation_start(self, event):
            self.calls.append(("operation_start", self.canonical(event.name)))
            self.num_tasks[self.canonical(event.name)] = event.num_tasks

        def on_task_start(self, event):
            self.calls.append(("task_start", self.canonical(event.array_name)))

        def on_task_end(self, event):
            self.calls.append(("task_end", self.canonical(event.array_name)))

        def on_operation_end(self, event):
            self.calls.append(("operation_end", self.canonical(event.name)))

        def on_compute_end(self, event):
            self.calls.append(("compute_end", None))
            self.executor_stats = event.executor_stats
            self.error = event.error
            self.end_compute_id = event.compute_id

    return LifecycleRecorder


PortRecorder = _recorder(port_types)
ReferenceRecorder = _recorder(reference_types)


def _two_op_pipeline(pkg, xp, spec):
    """A chain whose intermediate round-trips through Zarr when unfused."""
    an = np.arange(64.0).reshape(8, 8)
    a = pkg.from_array(an, chunks=(4, 4), spec=spec)
    return xp.add(xp.add(a, 1), 1)


def _vorticity(pkg, xp, spec):
    a, b, x, y = [pkg.random.random((50, 45, 40), chunks=10, spec=spec) for _ in range(4)]
    return xp.mean(xp.add(xp.multiply(a[1:], x[1:]), xp.multiply(b[1:], y[1:])))


PLANS = {"two_op": _two_op_pipeline, "vorticity": _vorticity}


@pytest.fixture
def spec(tmp_path):
    return cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB", reserved_mem=0)


def _trace_multiset(path, names: dict, compute_id: str):
    """(cat, name) of the events of a merged trace that belong to the compute
    *compute_id*, ops canonically named, and the lanes they lie on. The
    decision and sample rings are process-global: a sampler or a fleet left
    running by another test in this process records into them too, and a
    decision recorded in another thread takes the running compute's id from
    the environment. So memory samples (counter tracks; the reference's
    memory guard and fleet heartbeats record them, and neither is ported)
    and decisions (instants; these plans make none, and
    tests/test_torch_collect.py holds their merge against the reference's)
    are left out."""
    doc = json.load(open(path))["traceEvents"]
    lane_of = {e["tid"]: e["args"]["name"] for e in doc if e["ph"] == "M"}
    kept = [e for e in doc if e["ph"] != "M" and e.get("cat") not in ("counter", "instant")]
    assert all(e["args"]["compute_id"] == compute_id for e in kept if e.get("cat") == "compute")
    counts = collections.Counter((e.get("cat"), names.get(e["name"], e["name"])) for e in kept)
    return counts, {lane_of[e["tid"]] for e in kept}


def _run(pkg, xp, build, executor, tmp_path, label, seed=11, optimize_graph=True):
    """Compute *build* on *executor* with a recorder and a trace collector
    (its straggler watch off: it flags by wall clock); returns (value,
    recorder, collector)."""
    reference = pkg is cubed_tpu
    kw = dict(memory_guard="off") if reference else {}  # the guard and its samples are not ported
    spec = pkg.Spec(work_dir=str(tmp_path / label), allowed_mem="500MB", reserved_mem=0, **kw)
    random.seed(seed)
    arr = build(pkg, xp, spec)
    rec = (ReferenceRecorder if reference else PortRecorder)()
    col = (ReferenceTraceCollector if reference else TraceCollector)(
        trace_dir=str(tmp_path / f"{label}-trace"), straggler_min_s=1e9)
    if isinstance(executor, JaxExecutor):
        jax_executor_module._STRUCT_CACHE.clear()  # trace anew, so its path counters fire
    value = arr.compute(executor=executor, callbacks=[rec, col], optimize_graph=optimize_graph)
    return np.asarray(value), rec, col


# ---------------------------------------------------------------------------
# the reference test's counterparts
# ---------------------------------------------------------------------------


def _executors():
    return [PythonDagExecutor(), CudaExecutor()]


@pytest.mark.parametrize("executor", _executors(), ids=lambda e: e.name)
def test_full_lifecycle_order_and_stats(spec, executor):
    target = _two_op_pipeline(cubed_tpu_torch, pxp, spec)
    rec = PortRecorder()
    result = target.compute(callbacks=[rec], executor=executor, optimize_graph=False)
    np.testing.assert_allclose(result, np.arange(64.0).reshape(8, 8) + 2)
    kinds = [k for k, _ in rec.calls]
    assert kinds[0] == "compute_start" and kinds[-1] == "compute_end"
    starts = [n for k, n in rec.calls if k == "operation_start"]
    ends = [n for k, n in rec.calls if k == "operation_end"]
    assert sorted(starts) == sorted(ends) and len(starts) >= 3
    for name in starts:
        assert rec.calls.index(("operation_start", name)) < rec.calls.index(("operation_end", name))
    assert kinds.count("task_start") >= kinds.count("task_end") > 0
    assert rec.compute_id.startswith("c-") and rec.end_compute_id == rec.compute_id
    assert rec.error is None
    stats = rec.executor_stats
    assert stats["tasks_completed"] == stats["tasks_started"] == 10
    assert stats["bytes_written"] > 0  # the output chunks, on either executor
    if executor.name == "single-threaded":
        assert stats["bytes_read"] > 0  # the second op reads the intermediate
    else:
        assert stats["eager_ops"] == 1 and stats["whole_array_hits"] == 2
    some_op = next(v for k, v in stats["per_op"].items() if k != "create-arrays")
    assert some_op["tasks"] > 0 and some_op["wall_clock_s"] >= 0


@pytest.mark.parametrize("executor", _executors(), ids=lambda e: e.name)
def test_trace_json_loads_with_task_attribution(spec, executor, tmp_path):
    target = _two_op_pipeline(cubed_tpu_torch, pxp, spec)
    trace_path = str(tmp_path / "trace.json")
    jsonl_path = str(tmp_path / "events.jsonl")
    cb = TracingCallback(trace_path=trace_path, jsonl_path=jsonl_path)
    result = target.compute(callbacks=[cb], executor=executor, optimize_graph=False)
    np.testing.assert_allclose(result, np.arange(64.0).reshape(8, 8) + 2)
    events = json.load(open(trace_path))["traceEvents"]
    tasks = [e for e in events if e.get("cat") == "task"]
    # one span per task event, with op/chunk/attempt/executor attribution;
    # the device executor reports each op as one event of its task count
    assert sum(e["args"]["num_tasks"] for e in tasks) == cb.last_executor_stats["tasks_completed"]
    for e in tasks:
        assert e["ph"] == "X" and e["dur"] >= 0
        assert e["args"]["op"] and e["args"]["attempt"] == 0
        assert e["args"]["executor"] == executor.name
        assert (e["args"]["chunk"] is not None) == (executor.name == "single-threaded")
    assert [e for e in events if e.get("cat") == "operation"]
    assert [e for e in events if e.get("cat") == "compute"]
    lines = [json.loads(line) for line in open(jsonl_path).read().splitlines()]
    assert len([line for line in lines if line.get("cat") == "task"]) == len(tasks)


def test_cuda_executor_stats_include_metrics(spec):
    target = _two_op_pipeline(cubed_tpu_torch, pxp, spec)
    rec = PortRecorder()
    ex = CudaExecutor()
    np.testing.assert_allclose(target.compute(callbacks=[rec], executor=ex), np.arange(64.0).reshape(8, 8) + 2)
    stats = rec.executor_stats
    # the executor's counters and the registry's delta in one dict
    # the two adds fuse into one op, batched
    assert {c: stats.get(c) for c in ("eager_ops", "batched_ops")} == {"eager_ops": 1, "batched_ops": 1}
    assert stats["tasks_completed"] == 5  # create-arrays' one, the fused op's four
    assert stats["bytes_written"] == 512 and stats["chunks_written"] == 4  # the flush, outside any task
    kinds = [k for k, _ in rec.calls]
    assert "operation_end" in kinds and "task_start" in kinds


def test_reused_tracing_callback_starts_fresh_per_compute(spec, tmp_path):
    trace_path = str(tmp_path / "trace.json")
    cb = TracingCallback(trace_path=trace_path)
    an = np.ones((4, 4))
    float(pxp.sum(cubed_tpu_torch.from_array(an, chunks=(2, 2), spec=spec)).compute(callbacks=[cb]))
    float(pxp.sum(cubed_tpu_torch.from_array(2 * an, chunks=(2, 2), spec=spec)).compute(callbacks=[cb]))
    doc = json.load(open(trace_path))
    tasks = [e for e in doc["traceEvents"] if e.get("cat") == "task"]
    assert len(tasks) == cb.last_executor_stats["tasks_completed"]
    assert len([e for e in doc["traceEvents"] if e.get("cat") == "compute"]) == 1


@pytest.mark.parametrize("executor", _executors(), ids=lambda e: e.name)
def test_failed_compute_still_fires_compute_end_and_exports_trace(spec, tmp_path, executor):
    trace_path = str(tmp_path / "trace.json")
    cb = TracingCallback(trace_path=trace_path)
    rec = PortRecorder()
    col = TraceCollector(trace_dir=str(tmp_path / "merged"))
    a = cubed_tpu_torch.from_array(np.ones((4, 4)), chunks=(2, 2), spec=spec)

    def boom(x):
        if x.device.type != "meta":  # the plan-time trace runs on meta tensors
            raise ValueError("task failure")
        return x

    r = cubed_tpu_torch.map_blocks(boom, a, dtype=np.float64)
    with pytest.raises(ValueError, match="task failure"):
        r.compute(callbacks=[cb, rec, col], executor=executor)
    assert cb.last_executor_stats is not None
    assert isinstance(json.load(open(trace_path))["traceEvents"], list)
    assert rec.calls[-1] == ("compute_end", None)
    assert isinstance(rec.error, ValueError)
    doc = json.load(open(col.trace_path))["traceEvents"]
    compute = [e for e in doc if e.get("cat") == "compute"]
    assert compute and compute[0]["args"]["error_type"] == "ValueError"
    if executor.name == "single-threaded":
        # the failed task lands on the trace with its spans (storage reads)
        failed = [e for e in doc if e.get("cat") == "task" and e["args"].get("error")]
        assert failed and failed[0]["args"]["error_type"] == "ValueError"
        assert any(e["name"] == "task_failed" and e["args"]["error_type"] == "ValueError" for e in doc)


def test_broken_callback_cannot_fail_compute(spec):
    class Broken(Callback):
        def on_compute_start(self, event):
            raise RuntimeError("observer bug")

        def on_operation_start(self, event):
            raise RuntimeError("observer bug")

        def on_task_end(self, event):
            raise RuntimeError("observer bug")

        def on_compute_end(self, event):
            raise RuntimeError("observer bug")

    a = cubed_tpu_torch.from_array(np.ones((4, 4)), chunks=(2, 2), spec=spec)
    assert float(pxp.sum(a).compute(callbacks=[Broken()])) == 16.0
    assert float(pxp.sum(a).compute(callbacks=[Broken()], executor=CudaExecutor())) == 16.0


def test_history_projected_vs_measured_join_on_new_stream(spec, tmp_path):
    from cubed_tpu_torch.extensions.history import HistoryCallback

    history = HistoryCallback(history_dir=str(tmp_path / "history"))
    target = _two_op_pipeline(cubed_tpu_torch, pxp, spec)
    result = target.compute(callbacks=[history], executor=PythonDagExecutor(), optimize_graph=False)
    np.testing.assert_allclose(result, np.arange(64.0).reshape(8, 8) + 2)
    rows = history.stats()
    compute_rows = [r for r in rows if r["op_name"] != "create-arrays"]
    assert len(compute_rows) == 2
    for r in compute_rows:  # projections from the plan, peaks from the events
        assert r["projected_mem"] > 0
        assert r["peak_measured_mem"] is not None
        assert r["projected_mem_utilization"] is not None
    assert history.op_timings
    assert all(t.wall_clock is not None and t.wall_clock >= 0 for t in history.op_timings.values())
    written = sorted(os.listdir(tmp_path / "history"))
    assert [f.split("-")[0] for f in written] == ["events", "plan", "stats"]


def test_timeline_writes_a_plot_or_its_csv(spec, tmp_path):
    from cubed_tpu_torch.extensions.timeline import TimelineVisualizationCallback

    cb = TimelineVisualizationCallback(plots_dir=str(tmp_path / "plots"), format="svg")
    _two_op_pipeline(cubed_tpu_torch, pxp, spec).compute(callbacks=[cb], optimize_graph=False)
    assert len(cb.events) == 10
    (written,) = os.listdir(tmp_path / "plots")
    assert written.endswith(("_timeline.svg", "_timeline.csv"))


@pytest.mark.parametrize("executor", _executors(), ids=lambda e: e.name)
def test_tqdm_progress_bars_open_and_close_once_per_op(spec, executor, monkeypatch):
    from cubed_tpu_torch.extensions import tqdm as tqdm_ext

    closed = collections.Counter()

    class CountingBar(tqdm_ext._PlainBar):
        def close(self):
            closed[self.desc] += 1

    bar = tqdm_ext.TqdmProgressBar()
    monkeypatch.setattr(bar, "on_compute_start", lambda event: setattr(bar, "_tqdm", None))
    monkeypatch.setattr(tqdm_ext, "_PlainBar", CountingBar)
    result = _two_op_pipeline(cubed_tpu_torch, pxp, spec).compute(
        callbacks=[bar], executor=executor, optimize_graph=False)
    np.testing.assert_allclose(result, np.arange(64.0).reshape(8, 8) + 2)
    assert len(bar.bars) == 3  # create-arrays + two adds
    assert all(b.n == b.total for b in bar.bars.values())
    # closed at the op's end and again at the compute's end, like the reference
    assert closed == {name: 2 for name in bar.bars}


def test_tqdm_progress_bar_with_tqdm(spec):
    from cubed_tpu_torch.extensions.tqdm import TqdmProgressBar

    pytest.importorskip("tqdm")
    bar = TqdmProgressBar(file=None, disable=True)
    _two_op_pipeline(cubed_tpu_torch, pxp, spec).compute(callbacks=[bar], optimize_graph=False)
    assert len(bar.bars) >= 3


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_sequential_executors_agree_with_the_reference(tmp_path, plan):
    ref_value, ref, ref_col = _run(cubed_tpu, rxp, PLANS[plan], ReferencePythonDagExecutor(), tmp_path, "ref")
    value, ours, col = _run(cubed_tpu_torch, pxp, PLANS[plan], PythonDagExecutor(), tmp_path, "port")
    np.testing.assert_array_equal(value, ref_value)
    assert ours.calls == ref.calls
    assert ours.num_tasks == ref.num_tasks
    # a count no task moved is absent (the two-op plan reads no store)
    assert {k: ours.executor_stats.get(k, 0) for k in IO_COUNTS} == \
        {k: ref.executor_stats.get(k, 0) for k in IO_COUNTS}
    assert ours.executor_stats["virtual_bytes_read"] == ref.executor_stats["virtual_bytes_read"]
    assert sorted(ours.canonical(k) for k in ours.executor_stats["per_op"]) == \
        sorted(ref.canonical(k) for k in ref.executor_stats["per_op"])
    assert {ours.canonical(k): v["tasks"] for k, v in ours.executor_stats["per_op"].items()} == \
        {ref.canonical(k): v["tasks"] for k, v in ref.executor_stats["per_op"].items()}
    counts, lanes = _trace_multiset(col.trace_path, ours.names, ours.compute_id)
    ref_counts, ref_lanes = _trace_multiset(ref_col.trace_path, ref.names, ref.compute_id)
    assert counts == ref_counts
    assert lanes == ref_lanes
    assert counts[("storage", "storage_read")] == ours.executor_stats.get("chunks_read", 0)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_device_executor_agrees_with_the_jax_executor(tmp_path, plan):
    ref_value, ref, ref_col = _run(cubed_tpu, rxp, PLANS[plan], JaxExecutor(), tmp_path, "ref")
    value, ours, col = _run(cubed_tpu_torch, pxp, PLANS[plan], CudaExecutor(), tmp_path, "port")
    np.testing.assert_allclose(value, ref_value, rtol=1e-12, atol=0)
    assert ours.calls == ref.calls
    assert ours.num_tasks == ref.num_tasks
    stats, ref_stats = ours.executor_stats, ref.executor_stats
    assert {c: stats.get(c, 0) for c in PATH_COUNTERS} == {c: ref_stats.get(c, 0) for c in PATH_COUNTERS}
    assert stats["tasks_completed"] == ref_stats["tasks_completed"]
    assert stats["bytes_written"] == ref_stats["bytes_written"] > 0  # the output's flush
    assert stats["chunks_written"] == ref_stats["chunks_written"]
    assert sorted(ours.canonical(k) for k in stats["per_op"]) == sorted(ref.canonical(k) for k in ref_stats["per_op"])
    counts, lanes = _trace_multiset(col.trace_path, ours.names, ours.compute_id)
    ref_counts, ref_lanes = _trace_multiset(ref_col.trace_path, ref.names, ref.compute_id)
    assert counts == ref_counts
    assert lanes == ref_lanes


class _KeyRecorder(CudaExecutor):
    """A CudaExecutor that records each segment's structural key, computed
    as ``_run_segment`` computes it, when the segment runs."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.keys = []

    def _run(self, ops, dag, resident, budget, requested, callbacks, in_segment):
        if in_segment and ops:
            produced = self._produced(ops)
            keep_list = [k for k in self._segment_keep(ops, dag, requested) if k in produced]
            hoisted_arrays = self._hoisted_arrays(ops)
            self.keys.append(self._structural_key(ops, dag, self._segment_inputs(ops, resident), resident,
                                                  keep_list, hoisted_arrays, torch.device("cpu")))
        super()._run(ops, dag, resident, budget, requested, callbacks, in_segment)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_observers_do_not_change_the_device_route(tmp_path, plan):
    """Path counters, values and structural keys are the same with and
    without a TraceCollector (and the other observers) attached."""
    runs = []
    for observed in (False, True, False):
        spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / str(len(runs))), allowed_mem="500MB")
        random.seed(5)
        arr = PLANS[plan](cubed_tpu_torch, pxp, spec)
        ex = _KeyRecorder()
        callbacks = [TraceCollector(trace_dir=str(tmp_path / "trace")), TracingCallback(trace_path=None),
                     DeviceMemoryCallback(), TorchProfilerCallback(log_dir=str(tmp_path / "profile"))] \
            if observed else None
        runs.append((np.asarray(arr.compute(executor=ex, callbacks=callbacks)), dict(ex.stats), ex.keys))
    (plain, stats, keys), (seen, seen_stats, seen_keys), (again, _, keys_again) = runs
    np.testing.assert_array_equal(seen, plain)
    np.testing.assert_array_equal(again, plain)
    assert seen_stats == stats
    assert keys and None not in keys
    # the store paths differ from run to run, the key masks them
    assert seen_keys == keys == keys_again
    assert os.listdir(tmp_path / "trace") and os.listdir(tmp_path / "profile")
