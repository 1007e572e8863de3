"""The port's device executor (``CudaExecutor``, here with chunks on the CPU)
against the JAX package's ``JaxExecutor`` on the same seeded plans, and
against the port's sequential ``PythonDagExecutor``.

Elementwise results must be equal bit for bit. Reductions may differ in the
order of their float64 sums only (the device executor combines a region of
blocks in one sum), so they agree within rtol 1e-12. The plans mirror
tests/test_plan_fusion.py.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.core.ops import map_direct  # noqa: E402
from cubed_tpu_torch.kernels import fma_sum as fma_sum_module  # noqa: E402
from cubed_tpu_torch.runtime.create import create_executor  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor  # noqa: E402
from cubed_tpu_torch.runtime.types import Callback  # noqa: E402
from cubed_tpu_torch.utils import get_item  # noqa: E402

REDUCTION_RTOL = 1e-12
DEVICE_MEM = 64_000_000


def _an(shape, seed=0):
    return np.random.default_rng(seed).random(shape)


def _chain(pkg, xp, spec):
    a = pkg.from_array(_an((8, 8)), chunks=(4, 4), spec=spec)
    b = pkg.from_array(_an((8, 8), 1), chunks=(4, 4), spec=spec)
    return xp.add(xp.multiply(a, 2.0), b)


def _sum_all(pkg, xp, spec):
    return xp.sum(pkg.from_array(_an((20, 20)), chunks=(4, 4), spec=spec))


def _mean_all(pkg, xp, spec):
    return xp.mean(pkg.from_array(_an((10, 10)), chunks=(3, 3), spec=spec))


def _mean_axis0(pkg, xp, spec):
    return xp.mean(pkg.from_array(_an((20, 20)), chunks=(4, 4), spec=spec), axis=0)


def _sum_axis0(pkg, xp, spec):
    return xp.sum(pkg.from_array(_an((20, 20)), chunks=(4, 4), spec=spec), axis=0)


def _ragged_index(pkg, xp, spec):
    a = pkg.from_array(_an((19, 13)), chunks=(5, 4), spec=spec)
    return xp.sum(a[1:, ::2])


def _ragged_index_scaled(pkg, xp, spec):
    a = pkg.from_array(_an((19, 13)), chunks=(5, 4), spec=spec)
    return xp.multiply(a[1:, ::2], 2.0)


def _addsum(pkg, xp, spec):
    a = pkg.random.random((500, 500), chunks=100, spec=spec)
    b = pkg.random.random((500, 500), chunks=100, spec=spec)
    return xp.sum(xp.add(a, b))


def _vorticity(pkg, xp, spec):
    a, b, x, y = [pkg.random.random((50, 45, 40), chunks=10, spec=spec) for _ in range(4)]
    return xp.mean(xp.add(xp.multiply(a[1:], x[1:]), xp.multiply(b[1:], y[1:])))


def _vorticity_sum(pkg, xp, spec):
    a, b, x, y = [pkg.random.random((30, 25, 20), chunks=10, spec=spec) for _ in range(4)]
    return xp.sum(xp.add(xp.multiply(a[1:], x[1:]), xp.multiply(b[1:], y[1:])))


def _vorticity_float32(pkg, xp, spec):
    a, b, x, y = [
        xp.astype(pkg.random.random((30, 25, 20), chunks=10, spec=spec), xp.float32) for _ in range(4)
    ]
    return xp.mean(xp.add(xp.multiply(a[1:], x[1:]), xp.multiply(b[1:], y[1:])))


ELEMENTWISE = {"chain": _chain, "ragged_index_scaled": _ragged_index_scaled}
REDUCTIONS = {
    "sum_all": _sum_all, "mean_all": _mean_all, "mean_axis0": _mean_axis0,
    "sum_axis0": _sum_axis0, "ragged_index": _ragged_index, "addsum": _addsum,
    "vorticity": _vorticity, "vorticity_sum": _vorticity_sum,
}


def _run_all(tmp_path, build, seed=7):
    """(reference on JaxExecutor, its executor; port on CudaExecutor, its
    executor; port on PythonDagExecutor), all from the same seeds."""
    ref_ex, port_ex = JaxExecutor(), CudaExecutor(device_mem=DEVICE_MEM)
    jax_executor_module._STRUCT_CACHE.clear()  # trace anew, so its path counters fire
    random.seed(seed)
    ref = build(cubed_tpu, rxp, cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB"))
    ref_value = np.asarray(ref.compute(executor=ref_ex))
    port_spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB")
    random.seed(seed)
    port_value = build(cubed_tpu_torch, pxp, port_spec).compute(executor=port_ex)
    random.seed(seed)
    seq_value = build(cubed_tpu_torch, pxp, port_spec).compute(executor=PythonDagExecutor())
    return ref_value, ref_ex, port_value, port_ex, seq_value


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_elementwise_matches_jax_executor_bitwise(tmp_path, name):
    ref, _, got, ex, seq = _run_all(tmp_path, ELEMENTWISE[name])
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, seq)
    assert ex.stats["eager_fallbacks"] == 0


@pytest.mark.parametrize("name", sorted(REDUCTIONS))
def test_reductions_match_jax_executor(tmp_path, name):
    ref, _, got, ex, seq = _run_all(tmp_path, REDUCTIONS[name])
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=REDUCTION_RTOL, atol=0)
    np.testing.assert_allclose(got, seq, rtol=REDUCTION_RTOL, atol=0)
    assert ex.stats["eager_fallbacks"] == 0


def test_unfused_elementwise_op_takes_the_whole_array_path(tmp_path):
    *_, ex, _ = _run_all(tmp_path, _ragged_index_scaled)
    assert ex.stats["whole_array_hits"] == 1
    assert ex.stats["whole_array_errors"] == ex.stats["whole_select_errors"] == 0


def test_vorticity_paths_match_the_reference_executor(tmp_path):
    _, ref_ex, _, ex, _ = _run_all(tmp_path, _vorticity)
    # the reference batches what the port runs block by block
    assert ex.stats["chunked_ops"] == ref_ex.stats["batched_ops"] + ref_ex.stats["chunked_ops"]
    assert ex.stats["eager_ops"] == ref_ex.stats["eager_ops"] == 1
    for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors"):
        assert ex.stats[counter] == 0


@pytest.fixture
def fma_calls(monkeypatch):
    """Counts the plain fma_sum calls (the wrapper's CPU route)."""
    calls = []
    plain = fma_sum_module.fma_sum_plain

    def counting(*args):
        calls.append(tuple(args[0].shape))
        return plain(*args)

    monkeypatch.setattr(fma_sum_module, "fma_sum_plain", counting)
    return calls


@pytest.mark.parametrize("build", [_vorticity, _vorticity_sum, _vorticity_float32],
                         ids=["mean", "sum", "float32"])
def test_fused_multiply_add_reduction_goes_through_fma_sum_once_per_block(tmp_path, fma_calls, build):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    random.seed(3)
    got = build(cubed_tpu_torch, pxp, spec).compute(executor=CudaExecutor())
    nblocks = 100 if build is _vorticity else 18  # (49, 45, 40) or (29, 25, 20) in chunks of 10
    assert len(fma_calls) == nblocks
    assert (5, 5, 10) in fma_calls or (9, 5, 10) in fma_calls  # ragged edge blocks too
    random.seed(3)
    seq = build(cubed_tpu_torch, pxp, spec).compute(executor=PythonDagExecutor())
    np.testing.assert_allclose(got, seq, rtol=REDUCTION_RTOL if build is not _vorticity_float32 else 1e-6)


def test_other_reductions_do_not_take_fma_sum(tmp_path, fma_calls):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    random.seed(4)
    a, b, x = [cubed_tpu_torch.random.random((20, 20, 20), chunks=10, spec=spec) for _ in range(3)]
    ex = CudaExecutor()
    for expr in (pxp.mean(a * x + b), pxp.mean(a * x + b * x, axis=0), pxp.mean(a + x * b)):
        expr.compute(executor=ex)
        assert ex.stats["eager_fallbacks"] == 0
    assert fma_calls == []


def _stores_with_chunks(root) -> set:
    return {
        os.path.normpath(d) for d, _, files in os.walk(root)
        if d.endswith(".zarr") and any(f != ".zarray" for f in files)
    }


def test_only_the_requested_output_reaches_storage(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    random.seed(5)
    result = _vorticity(cubed_tpu_torch, pxp, spec)
    result.compute(executor=CudaExecutor())
    assert _stores_with_chunks(tmp_path) == {os.path.normpath(result.zarray_maybe_lazy.store)}


def test_lru_spill_gives_the_same_result(tmp_path):
    """A budget smaller than one random array (50*45*40*8 = 720,000 B) spills
    least recently used arrays to storage; readers then read the store."""
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "spill"), allowed_mem="500MB")
    random.seed(6)
    result = _vorticity(cubed_tpu_torch, pxp, spec)
    spilled = result.compute(executor=CudaExecutor(device_mem=500_000))
    assert len(_stores_with_chunks(tmp_path / "spill")) > 1
    random.seed(6)
    resident = _vorticity(cubed_tpu_torch, pxp, spec).compute(executor=CudaExecutor())
    np.testing.assert_allclose(spilled, resident, rtol=REDUCTION_RTOL, atol=0)


def test_executor_is_reachable_by_spec_and_name(tmp_path):
    for spec in (
        cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB", executor=CudaExecutor()),
        cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB", executor_name="cuda"),
        cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB", executor_name="cuda",
                             executor_options={"device_mem": "1MB"}),
    ):
        a = cubed_tpu_torch.from_array(_an((6, 6)), chunks=3, spec=spec)
        assert isinstance(spec.executor, CudaExecutor)
        np.testing.assert_allclose(float(pxp.sum(a).compute()), _an((6, 6)).sum(), rtol=REDUCTION_RTOL)
        assert spec.executor.stats["chunked_ops"] >= 1
    assert create_executor("cuda").name == "cuda"
    assert create_executor("python").name == "single-threaded"
    with pytest.raises(ValueError, match="Unrecognized executor name"):
        create_executor("jax")


def test_residency_budget_defaults():
    import torch

    spec = cubed_tpu_torch.Spec(device_mem="2MB")
    assert CudaExecutor(device_mem="1MB")._budget(spec, torch.device("cpu")) == 1_000_000
    assert CudaExecutor()._budget(spec, torch.device("cpu")) == 2_000_000
    assert CudaExecutor()._budget(None, torch.device("cpu")) == 8 * 2**30


def test_resume_is_not_ported(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(_an((4, 4)), chunks=2, spec=spec)
    plan = pxp.sum(a).plan._finalize()
    with pytest.raises(NotImplementedError):
        CudaExecutor().execute_dag(plan.dag, resume=True)


def test_task_end_events_partition_each_run_of_ops(tmp_path):
    events, ops = [], []

    class Capture(Callback):
        def on_operation_start(self, event):
            ops.append(event.name)

        def on_task_end(self, event):
            events.append(event)

    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    random.seed(8)
    _vorticity(cubed_tpu_torch, pxp, spec).compute(executor=CudaExecutor(), callbacks=[Capture()])
    assert [e.array_name for e in events] == ops
    assert all(e.executor == "cuda" for e in events)
    segment = events[1:]  # create-arrays runs alone; every other op joins one segment
    for prev, nxt in zip(segment, segment[1:]):
        assert prev.function_end_tstamp == pytest.approx(nxt.function_start_tstamp)
    assert sum(e.num_tasks for e in segment) == sum(
        d["primitive_op"].num_tasks for n, d in
        _vorticity(cubed_tpu_torch, pxp, spec).plan._finalize().dag.nodes.items()
        if d.get("primitive_op") is not None and n != "create-arrays"
    )


def test_sequential_executor_fires_one_task_end_per_task(tmp_path):
    ends, op_ends = [], []

    class Capture(Callback):
        def on_task_end(self, event):
            ends.append(event)

        def on_operation_end(self, event):
            op_ends.append(event)

    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    result = _sum_all(cubed_tpu_torch, pxp, spec)
    result.compute(callbacks=[Capture()])
    plan = result.plan._finalize(array_names=(result.name,))
    assert len(ends) == plan.num_tasks() and len(op_ends) == plan.num_ops()
    assert all(e.executor == "single-threaded" and e.num_tasks == 1 for e in ends)


# ---------------------------------------------------------------------------
# resident map_direct fast paths, driven by task bodies that declare them
# ---------------------------------------------------------------------------


class _Identity:
    """Reads its output block from the one side input: merge_chunks' contract."""

    resident_identity = True

    def __init__(self, chunks):
        self.chunks = chunks

    def __call__(self, block, x, block_id=None):
        return x[get_item(self.chunks, block_id)]


class _ConcatRows:
    """Reads its output block from the side inputs stacked along axis 0."""

    whole_concat = 0

    def __init__(self, chunks):
        self.chunks = chunks

    def __call__(self, block, *xs, block_id=None):
        rows, cols = get_item(self.chunks, block_id)
        whole = np.concatenate([x[...] for x in xs], axis=0)
        return whole[rows, cols]


@pytest.mark.parametrize("body, counter", [(_Identity, None), (_ConcatRows, "whole_concat_hits")])
def test_resident_map_direct_fast_paths(tmp_path, body, counter):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = cubed_tpu_torch.from_array(_an((6, 4)), chunks=(3, 2), spec=spec) * 2.0
    b = cubed_tpu_torch.from_array(_an((6, 4), 1), chunks=(3, 2), spec=spec) * 3.0
    srcs = (a,) if body is _Identity else (a, b)
    shape = (6 * len(srcs), 4)
    chunks = ((3,) * (2 * len(srcs)), (2, 2))
    out = map_direct(body(chunks), *srcs, shape=shape, dtype=np.float64, chunks=chunks,
                     extra_projected_mem=0)
    ex = CudaExecutor()
    got = out.compute(executor=ex)
    np.testing.assert_array_equal(got, out.compute(executor=PythonDagExecutor()))
    np.testing.assert_array_equal(got, np.concatenate([_an((6, 4)) * 2.0, _an((6, 4), 1) * 3.0][: len(srcs)]))
    assert ex.stats["chunked_ops"] == 0 and ex.stats["eager_fallbacks"] == 0
    if counter:
        assert ex.stats[counter] == 1


class _RowsReversed:
    """Declares a selection the resident path does not take (an integer
    array), so the op must fall back to its task body and count it."""

    def __init__(self, n, chunks):
        self.whole_select = (list(range(n - 1, -1, -1)), (0, 4, 1))
        self.chunks = chunks

    def __call__(self, block, x, block_id=None):
        rows, cols = get_item(self.chunks, block_id)
        return x[...][::-1][rows, cols]


def test_a_failed_whole_select_check_falls_back_and_counts(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = cubed_tpu_torch.from_array(_an((6, 4)), chunks=(3, 2), spec=spec) * 2.0
    chunks = ((3, 3), (2, 2))
    out = map_direct(_RowsReversed(6, chunks), a, shape=(6, 4), dtype=np.float64, chunks=chunks,
                     extra_projected_mem=0)
    ex = CudaExecutor()
    np.testing.assert_array_equal(out.compute(executor=ex), (_an((6, 4)) * 2.0)[::-1])
    assert ex.stats["whole_select_errors"] == ex.stats["eager_fallbacks"] == 1


def test_storage_sources_are_preloaded_once(tmp_path, monkeypatch):
    preloads = []
    preload = CudaExecutor._preload

    def spy(self, arr, resident, budget):
        preloads.append((arr.store, preload(self, arr, resident, budget)))
        return preloads[-1][1]

    monkeypatch.setattr(CudaExecutor, "_preload", spy)
    x = _an((30, 20), 8)
    store = str(tmp_path / "x.zarr")
    cubed_tpu.to_zarr(cubed_tpu.from_array(x, chunks=(7, 6), spec=cubed_tpu.Spec(
        work_dir=str(tmp_path / "ref"), allowed_mem="100MB")), store)
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="100MB")
    arr = cubed_tpu_torch.from_zarr(store, spec=spec)
    ex = CudaExecutor()
    got = (pxp.sum(arr * 2.0, axis=0) + pxp.sum(arr, axis=0)).compute(executor=ex)
    np.testing.assert_allclose(got, (x * 2.0).sum(axis=0) + x.sum(axis=0), rtol=REDUCTION_RTOL)
    assert ex.stats["eager_fallbacks"] == 0
    assert preloads == [(store, True)]
    # a budget too small for the source leaves it in storage; blocks are read from there
    ex = CudaExecutor(device_mem=1000)
    got = (pxp.sum(arr * 2.0, axis=0) + pxp.sum(arr, axis=0)).compute(executor=ex)
    np.testing.assert_allclose(got, (x * 2.0).sum(axis=0) + x.sum(axis=0), rtol=REDUCTION_RTOL)
    assert preloads[1:] == [(store, False)]
