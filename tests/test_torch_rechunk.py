"""The port's rechunk (the primitive, ``rechunk``, ``merge_chunks``,
``unify_chunks`` and the device executor's rechunk-as-alias) against the JAX
package on the CPU: the same seeded inputs, the same plans (ops, tasks,
write chunks and projected memory, exactly), the same values (float64
copies bit for bit; reductions within rtol 1e-12), and on ``CudaExecutor``
(chunks on the CPU) the path counters of ``JaxExecutor``, ``rechunk_alias``
and ``rechunk_virtual`` included.

Counterparts of tests/primitive/test_rechunk.py, the rechunk, merge and
unify tests of tests/test_core.py and tests/test_plan_fusion.py's
``test_fused_rechunk_alias``.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import math  # noqa: E402
import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.primitive import rechunk as ref_rechunk  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu.storage.store import open_zarr_array as ref_open_zarr  # noqa: E402
from cubed_tpu_torch.core.ops import unify_chunks  # noqa: E402
from cubed_tpu_torch.primitive import rechunk as port_rechunk  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor  # noqa: E402
from cubed_tpu_torch.storage.store import open_zarr_array as port_open_zarr  # noqa: E402

REDUCTION_RTOL = 1e-12

#: the path counters the two device executors share, the rechunk's included
PATH_COUNTERS = ("whole_array_hits", "batched_ops", "chunked_ops", "eager_ops", "rechunk_alias", "rechunk_virtual")


# ---------------------------------------------------------------------------
# the primitive: both packages' rechunk over Zarr stores
# ---------------------------------------------------------------------------


def _primitive_both(tmp_path, an, source_chunks, target_chunks, allowed_mem):
    """The reference's and the port's copy ops for one rechunk, each over
    its own source store holding *an*; each op's (tasks, write chunks,
    projected memory) must agree."""
    out = []
    for tag, mod, open_zarr in (("ref", ref_rechunk, ref_open_zarr), ("port", port_rechunk, port_open_zarr)):
        store = str(tmp_path / f"{tag}-src.zarr")
        src = open_zarr(store, mode="w", shape=an.shape, dtype=an.dtype, chunks=source_chunks)
        src[...] = an
        out.append(mod.rechunk(
            src, source_chunks=source_chunks, target_chunks=target_chunks, allowed_mem=allowed_mem,
            reserved_mem=0, target_store=str(tmp_path / f"{tag}-dst.zarr"),
            temp_store=str(tmp_path / f"{tag}-tmp.zarr"),
        ))
    ref_ops, port_ops = out
    assert [(o.num_tasks, o.write_chunks, o.projected_mem) for o in port_ops] == [
        (o.num_tasks, o.write_chunks, o.projected_mem) for o in ref_ops]
    return ref_ops, port_ops


def _execute(op, create):
    create(op.target_array)
    for m in op.pipeline.mappable:
        op.pipeline.function(m, config=op.pipeline.config)


def _run_both(ref_ops, port_ops):
    for op in ref_ops:
        _execute(op, lambda t: t.create(mode="a"))
    for op in port_ops:
        _execute(op, lambda t: t.create())
    return ref_ops[-1].target_array.open(), port_ops[-1].target_array.open()


def test_rechunk_direct(tmp_path):
    an = np.arange(100.0).reshape(10, 10)
    ref_ops, port_ops = _primitive_both(tmp_path, an, (2, 10), (10, 2), 10**7)
    assert len(port_ops) == 1
    ref_out, out = _run_both(ref_ops, port_ops)
    np.testing.assert_array_equal(out[...], an)
    np.testing.assert_array_equal(out[...], ref_out[...])
    assert out.chunks == ref_out.chunks == (10, 2)


def test_rechunk_staged(tmp_path):
    an = np.arange(900.0).reshape(30, 30)
    # a tight budget: the region covering a (2, 30) write is the whole array
    ref_ops, port_ops = _primitive_both(tmp_path, an, (30, 2), (2, 30), 20000)
    assert len(port_ops) == 2
    _, out = _run_both(ref_ops, port_ops)
    np.testing.assert_array_equal(out[...], an)
    assert out.chunks == (2, 30)
    assert all(op.projected_mem <= 20000 for op in port_ops)


def test_rechunk_allowed_mem_exceeded(tmp_path):
    src = port_open_zarr(str(tmp_path / "src.zarr"), mode="w", shape=(100, 100), dtype=np.float64,
                         chunks=(100, 1))
    with pytest.raises(ValueError, match="exceeds allowed_mem"):
        port_rechunk.rechunk(
            src, source_chunks=(100, 1), target_chunks=(1, 100), allowed_mem=2000, reserved_mem=0,
            target_store=str(tmp_path / "dst.zarr"), temp_store=str(tmp_path / "tmp.zarr"),
        )


@pytest.mark.parametrize("shape, source, target, max_mem, staged", [
    ((100, 100), (10, 100), (100, 10), 10**7, False),
    ((1000, 1000), (1000, 1), (1, 1000), 100_000, True),
], ids=["direct_when_fits", "staged_when_tight"])
def test_rechunking_plan(shape, source, target, max_mem, staged):
    got = port_rechunk.rechunking_plan(shape=shape, source_chunks=source, target_chunks=target,
                                       itemsize=8, max_mem=max_mem)
    assert got == ref_rechunk.rechunking_plan(shape=shape, source_chunks=source, target_chunks=target,
                                              itemsize=8, max_mem=max_mem)
    assert got[1] == ((1, 1) if staged else None)


def test_rechunk_ragged(tmp_path):
    an = np.arange(35.0).reshape(7, 5)
    ref_ops, port_ops = _primitive_both(tmp_path, an, (3, 2), (2, 4), 10**6)
    _, out = _run_both(ref_ops, port_ops)
    np.testing.assert_array_equal(out[...], an)


def test_multistage_plan_beats_min_intermediate_on_transpose():
    shape, src, tgt, max_mem = (1000, 1000), (1000, 1), (1, 1000), 200_000
    seq = port_rechunk.multistage_rechunking_plan(shape, src, tgt, 8, max_mem)
    assert seq == ref_rechunk.multistage_rechunking_plan(shape, src, tgt, 8, max_mem)
    assert seq is not None and len(seq) > 2
    io_geo = sum(port_rechunk._copy_io_ops(shape, a, b) for a, b in zip(seq, seq[1:]))
    io_min = port_rechunk._copy_io_ops(shape, src, (1, 1)) + port_rechunk._copy_io_ops(shape, (1, 1), tgt)
    assert io_geo * 10 < io_min
    for a, b in zip(seq, seq[1:]):
        assert port_rechunk._covering_bytes(shape, b, a, 8) + math.prod(b) * 8 <= max_mem


def test_multistage_rechunk_end_to_end(tmp_path):
    an = np.arange(64.0 * 64).reshape(64, 64)
    ref_ops, port_ops = _primitive_both(tmp_path, an, (64, 2), (2, 64), 40_000)
    assert len(port_ops) >= 2
    _, out = _run_both(ref_ops, port_ops)
    np.testing.assert_array_equal(out[...], an)
    assert out.chunks == (2, 64)


# ---------------------------------------------------------------------------
# the core plan: both packages on both of the port's executors
# ---------------------------------------------------------------------------


def _an(shape, seed=0):
    return np.random.default_rng(seed).random(shape)


def _plan_stats(x):
    plan = x.plan._finalize(array_names=(x.name,))
    return plan.num_tasks(), plan.num_ops(), plan.max_projected_mem()


def _run_all(tmp_path, build, allowed_mem="500MB", reserved_mem=0, seed=7):
    """(reference value, its JaxExecutor, port value on CudaExecutor, that
    executor, port value on the sequential executor); the plans of both
    packages must agree in tasks, ops and projected memory."""
    jax_executor_module._STRUCT_CACHE.clear()  # trace anew, so its path counters fire
    ref_ex, port_ex = JaxExecutor(), CudaExecutor()
    random.seed(seed)
    ref = build(cubed_tpu, rxp, cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem=allowed_mem,
                                              reserved_mem=reserved_mem))
    port_spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem=allowed_mem,
                                     reserved_mem=reserved_mem)
    random.seed(seed)
    port = build(cubed_tpu_torch, pxp, port_spec)
    assert _plan_stats(port) == _plan_stats(ref)
    ref_value = np.asarray(ref.compute(executor=ref_ex))
    port_value = port.compute(executor=port_ex)
    random.seed(seed)
    seq_value = build(cubed_tpu_torch, pxp, port_spec).compute(executor=PythonDagExecutor())
    return ref_value, ref_ex, port_value, port_ex, seq_value


def _check(tmp_path, build, exact=True, **kw):
    ref, ref_ex, got, ex, seq = _run_all(tmp_path, build, **kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    for value in (got, seq):
        if exact:
            np.testing.assert_array_equal(value, ref)
        else:
            np.testing.assert_allclose(value, ref, rtol=REDUCTION_RTOL, atol=0)
    assert {c: ex.stats[c] for c in PATH_COUNTERS} == {c: ref_ex.stats[c] for c in PATH_COUNTERS}
    assert ex.stats["eager_fallbacks"] == 0
    return ex


def _rechunk(pkg, xp, spec):
    a = pkg.from_array(np.arange(36.0).reshape(6, 6), chunks=(2, 2), spec=spec)
    b = a.rechunk((3, 3))
    assert b.chunksize == (3, 3)
    return b


def _rechunk_staged(pkg, xp, spec):
    a = pkg.from_array(np.arange(900.0).reshape(30, 30), chunks=(30, 2), spec=spec)
    return a.rechunk((2, 30))


def _merge_chunks(pkg, xp, spec):
    a = pkg.from_array(np.arange(100.0).reshape(10, 10), chunks=(2, 2), spec=spec)
    b = pkg.merge_chunks(a, (4, 4))
    assert b.chunksize == (4, 4)
    return b


def _unify_applies(pkg, xp, spec):
    an = np.arange(36.0).reshape(6, 6)
    return xp.add(pkg.from_array(an, chunks=(2, 3), spec=spec), pkg.from_array(an, chunks=(3, 2), spec=spec))


def _unify_misaligned_1d(n):
    def build(pkg, xp, spec):
        an = np.arange(float(n))
        return xp.add(pkg.from_array(an, chunks=(3,), spec=spec), pkg.from_array(an, chunks=(2,), spec=spec))

    return build


def _unify_misaligned_2d_with_broadcast(pkg, xp, spec):
    a = pkg.from_array(np.arange(30.0).reshape(6, 5), chunks=(4, 3), spec=spec)
    b = pkg.from_array(np.arange(5.0), chunks=(2,), spec=spec)
    return xp.multiply(a, b)


def test_rechunk(tmp_path):
    _check(tmp_path, _rechunk)


def test_rechunk_staged_plan(tmp_path):
    # a tight budget forces the two-pass rechunk through an intermediate
    ex = _check(tmp_path, _rechunk_staged, allowed_mem=20000)
    assert ex.stats["rechunk_virtual"] == 1 and ex.stats["rechunk_alias"] == 1


def test_merge_chunks(tmp_path):
    _check(tmp_path, _merge_chunks)


def test_unify_chunks_applies(tmp_path):
    _check(tmp_path, _unify_applies)


@pytest.mark.parametrize("n", [5, 6, 7])
def test_unify_chunks_misaligned_1d(tmp_path, n):
    _check(tmp_path, _unify_misaligned_1d(n))


def test_unify_chunks_misaligned_2d_with_broadcast(tmp_path):
    _check(tmp_path, _unify_misaligned_2d_with_broadcast)


def test_unify_chunks_extent_mismatch_raises(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(np.arange(6.0), chunks=(3,), spec=spec)
    b = cubed_tpu_torch.from_array(np.arange(7.0), chunks=(2,), spec=spec)
    with pytest.raises(ValueError):
        pxp.add(a, b)
    with pytest.raises(ValueError, match="do not align"):
        unify_chunks(a, (0,), b, (0,))


def test_from_array_of_an_array_raises(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(np.arange(6.0), chunks=(3,), spec=spec)
    with pytest.raises(ValueError, match="use rechunk"):
        cubed_tpu_torch.from_array(a)


def test_from_array_of_a_store_rechunks_it(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    an = _an((12, 10))
    z = port_open_zarr(str(tmp_path / "src.zarr"), mode="w", shape=an.shape, dtype=an.dtype, chunks=(4, 10))
    z[...] = an
    a = cubed_tpu_torch.from_array(z, chunks=(12, 5), spec=spec)
    assert a.chunksize == (12, 5)
    np.testing.assert_array_equal(a.compute(), an)
    ex = CudaExecutor()
    np.testing.assert_array_equal(a.compute(executor=ex), an)
    # the store is loaded before the segment and the copy aliases it
    assert ex.stats["segment_preloads"] == 1 and ex.stats["rechunk_alias"] == 1


def _fused_rechunk_alias(pkg, xp, spec):
    a = pkg.from_array(np.arange(64, dtype=np.float64).reshape(8, 8), chunks=(2, 8), spec=spec)
    return xp.sum(a.rechunk((8, 2)))


def test_fused_rechunk_alias(tmp_path):
    ex = _check(tmp_path, _fused_rechunk_alias, exact=False)
    assert ex.stats["rechunk_virtual"] == 1


def _random_rechunk_mean(pkg, xp, spec):
    """config 5's time-contiguous pattern, cut to size: a random array
    rechunked so the first axis is one chunk, then a mean over it."""
    a = pkg.random.random((40, 36, 32), chunks=8, spec=spec)
    return xp.mean(a.rechunk((40, 6, 4)), axis=0)


@pytest.mark.parametrize("allowed_mem, n_copies", [(1_000_000, 1), (77_000, 2), (241_000, 3)])
def test_rechunk_of_a_resident_array_is_an_alias(tmp_path, allowed_mem, n_copies):
    """Each copy op of a direct, a two-pass and a multistage rechunk of a
    resident array aliases it: no chunk of an intermediate store is written."""
    ex = _check(tmp_path, _random_rechunk_mean, exact=False, allowed_mem=allowed_mem)
    assert ex.stats["rechunk_alias"] == n_copies
    random.seed(7)
    x = _random_rechunk_mean(cubed_tpu_torch, pxp, cubed_tpu_torch.Spec(work_dir=str(tmp_path / "alone"),
                                                                       allowed_mem=allowed_mem))
    plan = x.plan._finalize(array_names=(x.name,))
    copies = [name for name, d in plan.dag.nodes.items() if d.get("op_name") == "rechunk"]
    assert len(copies) == n_copies
    # the intermediate stages are hidden arrays
    assert [plan.dag.nodes[plan.dag.successors(c)[0]]["hidden"] for c in copies] == [True] * (n_copies - 1) + [False]
    x.compute(executor=CudaExecutor())
    stored = [root for root, _, files in os.walk(tmp_path / "alone")
              if root.endswith(".zarr") and any(f != ".zarray" for f in files)]
    assert stored == [os.path.normpath(x.zarray_maybe_lazy.store)]  # the output's store alone


def test_rechunk_of_a_store_too_large_for_the_budget_copies_on_the_host(tmp_path):
    """A storage source past half the budget takes the bounded host copy
    (the spill path); the value is the sequential executor's."""
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    an = _an((16, 12))
    z = port_open_zarr(str(tmp_path / "src.zarr"), mode="w", shape=an.shape, dtype=an.dtype, chunks=(4, 12))
    z[...] = an
    x = pxp.sum(cubed_tpu_torch.from_array(z, chunks=(16, 3), spec=spec), axis=0)
    ex = CudaExecutor(device_mem=an.nbytes - 8)
    np.testing.assert_allclose(x.compute(executor=ex), an.sum(axis=0), rtol=REDUCTION_RTOL)
    # the store did not fit, so it was not loaded before the segment (on a
    # card the segment then fails its pre-check and runs op by op)
    assert ex.stats["segment_preloads"] == 0 and ex.stats["rechunk_copies"] == 1
    assert ex.stats["rechunk_alias"] == ex.stats["rechunk_loads"] == 0


def test_rechunk_of_a_store_outside_a_segment_loads_it_whole(tmp_path):
    """With ``fuse_plan=False`` no segment preloads the store, so the copy op
    reads it itself: whole onto the device, as it fits in half the budget."""
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    an = _an((16, 12))
    z = port_open_zarr(str(tmp_path / "src.zarr"), mode="w", shape=an.shape, dtype=an.dtype, chunks=(4, 12))
    z[...] = an
    x = pxp.sum(cubed_tpu_torch.from_array(z, chunks=(16, 3), spec=spec), axis=0)
    ex = CudaExecutor(fuse_plan=False)
    np.testing.assert_allclose(x.compute(executor=ex), an.sum(axis=0), rtol=REDUCTION_RTOL)
    assert ex.stats["rechunk_loads"] == 1
    assert ex.stats["segment_preloads"] == ex.stats["rechunk_copies"] == ex.stats["rechunk_alias"] == 0


#: the three plans of config 5's rechunk (``mean(rechunk(a, (500, 45, 40)),
#: axis=0)``, a of (500, 450, 400) f64 chunked 100) under three budgets:
#: (copy ops, their tasks, their write chunks)
FULL_SIZE_PLANS = {
    "2GB": (1, [5], [(500, 90, 400)]),
    "500MB": (3, [108, 128, 100], [(171, 77, 74), (292, 59, 54), (500, 45, 40)]),
    "200MB": (2, [500, 100], [(100, 45, 40), (500, 45, 40)]),
}


@pytest.mark.parametrize("allowed_mem", sorted(FULL_SIZE_PLANS))
def test_full_size_rechunk_plans_match_the_jax_package(tmp_path, allowed_mem):
    def copies(pkg, xp):
        random.seed(1)
        spec = pkg.Spec(work_dir=str(tmp_path), allowed_mem=allowed_mem)
        a = pkg.random.random((500, 450, 400), chunks=100, spec=spec)
        x = xp.mean(a.rechunk((500, 45, 40)), axis=0)
        plan = x.plan._finalize(array_names=(x.name,))
        nodes = plan.dag.nodes.items() if pkg is cubed_tpu_torch else plan.dag.nodes(data=True)
        ops = [d["primitive_op"] for _, d in nodes if d.get("op_name") == "rechunk"]
        return (plan.num_tasks(), plan.num_ops(), plan.max_projected_mem(),
                [(o.num_tasks, o.write_chunks, o.projected_mem) for o in ops])

    got = copies(cubed_tpu_torch, pxp)
    assert got == copies(cubed_tpu, rxp)
    n, tasks, writes = FULL_SIZE_PLANS[allowed_mem]
    assert (len(got[3]), [t for t, _, _ in got[3]], [w for _, w, _ in got[3]]) == (n, tasks, writes)
