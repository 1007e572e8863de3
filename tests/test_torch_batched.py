"""The device executor's batched dispatch and segment bookkeeping
(cubed_tpu_torch/runtime/executors/cuda.py), on the CPU.

- The general batched route (every uniform-grid op under ``torch.func.vmap``)
  on ragged grids: values equal to the sequential executor's and the JAX
  package's (bitwise for elementwise ops, rtol 1e-12 for reductions, whose
  float64 sums may be taken in another order), with the reference's path
  counters.
- The batching rules of the hand kernels' custom ops (``region_sum``,
  Philox, and ``sqrt``, which is numpy on the CPU) against their plain
  versions, and ``fma_sum_blocks``' geometry replayed as its kernel runs it.
- The structural key of a segment, the hoisted Philox keys, the memory
  pre-check and the accounting of cached graphs' bytes. Capture and replay
  themselves need a card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.backend_array_api import nxp as jax_nxp  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.backend_array_api import nxp  # noqa: E402
from cubed_tpu_torch.kernels import _geometry  # noqa: E402
from cubed_tpu_torch.kernels.fma_sum import fma_sum_blocks, fma_sum_blocks_plain, fma_sum_plain  # noqa: E402
from cubed_tpu_torch.kernels.philox_uniform import (  # noqa: E402
    HoistedKeys,
    block_keys,
    hoisted,
    philox_blocks,
    philox_keys,
    philox_uniform_blocks,
)
from cubed_tpu_torch.kernels.region_sum import region_sum  # noqa: E402
from cubed_tpu_torch.random import _random_blocks  # noqa: E402
from cubed_tpu_torch.runtime.executors import cuda as cuda_module  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor  # noqa: E402
from cubed_tpu_torch.runtime.pipeline import visit_nodes  # noqa: E402

REDUCTION_RTOL = 1e-12
vmap = torch.func.vmap


def _an(shape, seed=0):
    return np.random.default_rng(seed).random(shape)


# ---------------------------------------------------------------------------
# the general route on ragged grids
# ---------------------------------------------------------------------------


def _ragged_chain(pkg, xp, spec):
    # (22, 12) in (5, 4): buckets (5, 4) x 12 and (2, 4) x 3
    a = pkg.from_array(_an((22, 12)), chunks=(5, 4), spec=spec)
    b = pkg.from_array(_an((22, 12), 1), chunks=(5, 4), spec=spec)
    return xp.add(xp.multiply(a, 2.0), xp.sqrt(b))


def _ragged_mean_axis0(pkg, xp, spec):
    return xp.mean(pkg.from_array(_an((22, 12), 2), chunks=(5, 4), spec=spec), axis=0)


def _ragged_sum_axis1(pkg, xp, spec):
    return xp.sum(pkg.from_array(_an((12, 22), 3), chunks=(4, 5), spec=spec), axis=1)


def _ragged_addsum(pkg, xp, spec):
    # random ops fused into the add and the sum: (52, 40) in 10s
    a = pkg.random.random((52, 40), chunks=10, spec=spec)
    b = pkg.random.random((52, 40), chunks=10, spec=spec)
    return xp.sum(xp.add(a, b))


def _ragged_random_mean(pkg, xp, spec):
    # a 3-D mean over axis 0 of a fused random op: grid views with kept
    # in-block axes
    a = pkg.random.random((21, 12, 10), chunks=(5, 4, 5), spec=spec)
    return xp.mean(xp.multiply(a, a), axis=0)


PLANS = {
    "chain": (_ragged_chain, True), "mean_axis0": (_ragged_mean_axis0, False),
    "sum_axis1": (_ragged_sum_axis1, False), "addsum": (_ragged_addsum, False),
    "random_mean": (_ragged_random_mean, False),
}


def _three_ways(tmp_path, build, seed=11):
    jax_executor_module._STRUCT_CACHE.clear()
    ref_ex, ex = JaxExecutor(), CudaExecutor()
    random.seed(seed)
    ref = np.asarray(build(cubed_tpu, rxp, cubed_tpu.Spec(work_dir=str(tmp_path / "ref"),
                                                          allowed_mem="500MB")).compute(executor=ref_ex))
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB")
    random.seed(seed)
    got = build(cubed_tpu_torch, pxp, spec).compute(executor=ex)
    random.seed(seed)
    seq = build(cubed_tpu_torch, pxp, spec).compute(executor=PythonDagExecutor())
    return ref, ref_ex, got, ex, seq


@pytest.mark.parametrize("name", sorted(PLANS))
def test_vmap_route_on_ragged_grids_matches_sequential_and_reference(tmp_path, name):
    build, elementwise = PLANS[name]
    ref, ref_ex, got, ex, seq = _three_ways(tmp_path, build)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if elementwise:
        np.testing.assert_array_equal(got, seq)
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, seq, rtol=REDUCTION_RTOL, atol=0)
        np.testing.assert_allclose(got, ref, rtol=REDUCTION_RTOL, atol=0)
    assert ex.stats["batched_ops"] == ref_ex.stats["batched_ops"] >= 1
    assert ex.stats["chunked_ops"] == ref_ex.stats["chunked_ops"]
    assert ex.stats["eager_fallbacks"] == ex.stats["batched_errors"] == 0


def test_a_function_not_declared_batchable_counts_a_failed_check(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = cubed_tpu_torch.from_array(_an((8, 8)), chunks=(4, 4), spec=spec)

    def plus_one(x):
        # numpy on the block's values: it does not run under torch.func.vmap,
        # so map_blocks' plan-time trace declares it not batchable
        return torch.from_numpy(x.numpy() + 1)

    got = cubed_tpu_torch.map_blocks(plus_one, a, dtype=a.dtype).compute(executor=(ex := CudaExecutor()))
    np.testing.assert_array_equal(got, _an((8, 8)) + 1)
    assert ex.stats["batched_errors"] == ex.stats["eager_fallbacks"] == 1
    assert ex.stats["batched_ops"] == 0 and ex.stats["chunked_ops"] == 1


def test_a_torch_function_given_to_map_blocks_batches_like_the_reference(tmp_path):
    """``map_blocks(lambda x: x + 1)`` runs under torch.func.vmap, so the
    plan-time trace declares it batchable: one batched call, as JaxExecutor."""

    def build(pkg, xp, spec):
        return pkg.map_blocks(lambda x: x + 1, pkg.from_array(_an((8, 8)), chunks=(4, 4), spec=spec),
                              dtype=np.float64)

    ref, ref_ex, got, ex, seq = _three_ways(tmp_path, build)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(seq, ref)
    assert ex.stats["batched_ops"] == ref_ex.stats["batched_ops"] == 1
    assert ex.stats["batched_errors"] == ex.stats["eager_fallbacks"] == 0


def test_bucket_grids_follow_the_output_axes():
    # (3, 2) output blocks, a leaf read at the same coordinates and one
    # broadcast along axis 1
    out = np.array(list(np.ndindex(3, 2)), dtype=np.int64)
    leaves = [[("x", i, j), ("y", 0, j), ("t", 0, 0)] for i, j in out]
    levels, sizes, per_leaf = CudaExecutor._bucket_plan(list(range(6)), out, leaves)
    assert levels == [0, 1] and sizes == [3, 2]
    assert per_leaf == [[0, 1], [None, 1], [None, None]]
    # a bucket of one block, or whose leaves never vary, does not batch
    assert CudaExecutor._bucket_plan([0], out, leaves) is None
    assert CudaExecutor._bucket_plan(list(range(6)), out, [[("t", 0, 0)]] * 6) is None


class _Strided:
    """A resident array's strides, without its bytes (the bucket checks read
    metadata only)."""

    def __init__(self, strides):
        self._strides = tuple(strides)

    def stride(self):
        return self._strides


def _grid_bucket(shape, chunks):
    """(plan, tasks, out_coords, task_leaves) of one bucket: a grid of
    equal blocks read at the output's coordinates."""
    grid = [n // c for n, c in zip(shape, chunks)]
    out = np.array(list(np.ndindex(*grid)), dtype=np.int64)
    leaves = [[("x", *c)] for c in out.tolist()]
    tasks = list(range(len(out)))
    return CudaExecutor._bucket_plan(tasks, out, leaves), tasks, out, leaves


def test_bucket_tile_keeps_every_piece_within_32_bit_reach():
    # a resident float32 (50000, 50000) array summed in (1000, 1000) blocks:
    # the bucket's grid view reaches 2.5e9 elements, past the kernels' 32 bits
    shape, chunks = (50000, 50000), (1000, 1000)
    plan, tasks, out, leaves = _grid_bucket(shape, chunks)
    arr = cubed_tpu_torch.storage.virtual.VirtualEmptyArray(shape, np.float32, chunks)
    metas = [(arr, cuda_module._chunkset(shape, chunks))]
    out_sets = [cuda_module._chunkset((50, 50), (1, 1))]
    wholes = {id(arr): _Strided((50000, 1))}
    tile = CudaExecutor._bucket_tile(plan, tasks, metas, leaves, out_sets, out, wholes, 10**12)
    assert tile == [42, 50]
    reach = (tile[0] * 1000 - 1) * 50000 + tile[1] * 1000 - 1
    assert reach < _geometry.INDEX_LIMIT <= 50000 * 50000 - 1
    pieces = list(cuda_module._tiles(tasks, plan[1], tile))
    assert [sizes for _, sizes in pieces] == [[42, 50], [8, 50]]
    assert sorted(t for piece, _ in pieces for t in piece) == tasks  # every block once, in C order
    assert pieces[1][0][:2] == [42 * 50, 42 * 50 + 1]
    # a budget's room cuts it further; one block that does not fit: None
    assert CudaExecutor._bucket_tile(plan, tasks, metas, leaves, out_sets, out, wholes, 5 * 10**6) == [1, 5]
    assert CudaExecutor._bucket_tile(plan, tasks, metas, leaves, out_sets, out, wholes, 10**6 - 1) is None


def test_bucket_tile_cuts_a_stacked_philox_fill_past_32_bits():
    # addsum at (50000, 50000) / 1000: the fused random op's rule would fill
    # 2.5e9 elements in one launch; no input is resident
    shape, chunks = (50000, 50000), (1000, 1000)
    plan, tasks, out, _ = _grid_bucket(shape, chunks)
    template = cubed_tpu_torch.storage.virtual.VirtualEmptyArray(shape, np.float64, chunks)
    seeds = cubed_tpu_torch.storage.virtual.VirtualOffsetsArray((50, 50), base=7)
    leaves = [[("t", *c), ("o", *c)] for c in out.tolist()]
    plan = CudaExecutor._bucket_plan(tasks, out, leaves)
    metas = [(template, cuda_module._chunkset(shape, chunks)), (seeds, cuda_module._chunkset((50, 50), (1, 1)))]
    out_sets = [cuda_module._chunkset((50, 50), (1, 1))]
    tile = CudaExecutor._bucket_tile(plan, tasks, metas, leaves, out_sets, out, {}, 10**12)
    assert tile == [42, 50] and 42 * 50 * 10**6 < _geometry.INDEX_LIMIT < 43 * 50 * 10**6
    # blocks of rank 5 under five vmap levels: past region_sum's eight axes
    plan5, tasks5, out5, leaves5 = _grid_bucket((4, 2, 2, 2, 2), (2, 1, 1, 1, 1))
    arr5 = cubed_tpu_torch.storage.virtual.VirtualEmptyArray((4, 2, 2, 2, 2), np.float64, (2, 1, 1, 1, 1))
    metas5 = [(arr5, cuda_module._chunkset((4, 2, 2, 2, 2), (2, 1, 1, 1, 1)))]
    out5_sets = [cuda_module._chunkset((2, 2, 2, 2, 2), (1,) * 5)]
    assert CudaExecutor._bucket_tile(plan5, tasks5, metas5, leaves5, out5_sets, out5, {}, 10**12) is None


def _sum_of_slice(tmp_path, name, executor):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / name), allowed_mem="500MB")
    a = cubed_tpu_torch.from_array(_an((41, 40), 9), chunks=(10, 10), spec=spec)
    return float(pxp.sum(a[1:]).compute(executor=executor))


def test_vmap_route_cuts_a_bucket_whose_view_passes_the_index_limit(tmp_path, monkeypatch):
    want = _sum_of_slice(tmp_path, "whole", ex_whole := CudaExecutor())
    from cubed_tpu_torch.kernels import region_sum as region_module

    calls = []
    plain = region_module.region_sum_plain

    def counting(x, ax, keep):
        calls.append(x)
        return plain(x, ax, keep)

    monkeypatch.setattr(region_module, "region_sum_plain", counting)
    # the [1:] view's bucket of (4, 4) blocks reaches element 1599: with a
    # limit of 1000 it runs as two pieces of (2, 4) blocks
    monkeypatch.setattr(_geometry, "INDEX_LIMIT", 1000)
    got = _sum_of_slice(tmp_path, "cut", ex := CudaExecutor())
    np.testing.assert_allclose(got, want, rtol=REDUCTION_RTOL)
    np.testing.assert_allclose(got, _an((41, 40), 9)[1:].sum(), rtol=REDUCTION_RTOL)
    assert ex.stats["batched_ops"] == ex_whole.stats["batched_ops"] >= 1
    assert ex.stats["batched_errors"] == ex.stats["eager_fallbacks"] == 0
    pieces = [x for x in calls if x.ndim == 4]  # grid views: two grid axes, two block axes
    assert [tuple(x.shape) for x in pieces] == [(2, 4, 10, 10)] * 2
    assert all(sum((n - 1) * st for n, st in zip(x.shape, x.stride())) < 1000 for x in pieces)


def test_fusion_rule_past_32_bits_counts_a_failed_check_and_runs_block_by_block(tmp_path, monkeypatch):
    random.seed(12)
    want = float(_vorticity(_spec(tmp_path, "whole")).compute(executor=CudaExecutor()))
    assert _geometry.fma_blocks_fit((499, 450, 400), [(180000, 400, 1)] * 4, (100, 100, 100))
    assert not _geometry.fma_blocks_fit((2**16, 2**16), [(2**16, 1)] * 4, (1024, 1024))
    assert not _geometry.fma_blocks_fit((2,) * 5, [(16, 8, 4, 2, 1)] * 4, (1,) * 5)
    # the [1:] views of (30, 25, 20) reach element 14499; the random arrays
    # hold 15000 elements
    monkeypatch.setattr(_geometry, "INDEX_LIMIT", 14000)
    random.seed(12)
    got = float(_vorticity(_spec(tmp_path, "cut")).compute(executor=(ex := CudaExecutor())))
    np.testing.assert_allclose(got, want, rtol=REDUCTION_RTOL)
    # four random ops past one launch, and the fused reduction
    assert ex.stats["batched_errors"] == ex.stats["eager_fallbacks"] == 5
    assert ex.stats["batched_ops"] == 0


def test_rank_five_ops_fail_their_checks_from_metadata_and_run_chunked(tmp_path):
    # a random op of rank 5 is past the whole-array fill's four axes, and the
    # sum of its [1:] view would hand region_sum a grid view of ten axes:
    # both fail their checks before they run, and the ops run chunked
    spec = _spec(tmp_path, "rank5")
    random.seed(13)
    a = cubed_tpu_torch.random.random((5, 4, 4, 4, 4), chunks=2, spec=spec)
    got = float(pxp.sum(a[1:]).compute(executor=(ex := CudaExecutor())))
    random.seed(13)
    root = random.getrandbits(30)
    want = np.empty((5, 4, 4, 4, 4))
    for k, idx in enumerate(np.ndindex(3, 2, 2, 2, 2)):
        sel = tuple(slice(2 * i, 2 * i + 2) for i in idx)
        shape = want[sel].shape
        want[sel] = np.random.Generator(np.random.Philox(seed=root + k)).random(shape)
    np.testing.assert_allclose(got, want[1:].sum(), rtol=REDUCTION_RTOL)
    assert ex.stats["batched_errors"] == ex.stats["eager_fallbacks"] == 2


def test_philox_rule_takes_blocks_of_any_rank():
    # the stacked fill is an (n, size) grid of (1, size) blocks, so a block
    # of rank 5 fits one launch
    like = torch.zeros((), dtype=torch.float64).expand(2, 3, 2, 2, 3)
    seeds = torch.tensor([5, 9], dtype=torch.int64).reshape(2, 1, 1, 1, 1, 1)
    got = vmap(lambda s: philox_blocks(like, s))(seeds)
    assert got.shape == (2, 2, 3, 2, 2, 3)
    for i, seed in enumerate((5, 9)):
        want = np.random.Generator(np.random.Philox(seed=seed)).random((2, 3, 2, 2, 3))
        np.testing.assert_array_equal(got[i].numpy().view(np.uint64), want.view(np.uint64))
    p = _geometry.blocks_plan((2, 72), (72, 1), (1, 72), 0)
    assert p.items == 2 and p.vector_edge


# ---------------------------------------------------------------------------
# batching rules of the custom ops
# ---------------------------------------------------------------------------


def _grid_view(base, nb, chunks):
    """(nb..., chunks...) blocks of *base*, one strided view."""
    st = base.stride()
    return base.as_strided(tuple(nb) + tuple(chunks), tuple(c * s for c, s in zip(chunks, st)) + st)


@pytest.mark.parametrize("axes", [(0, 1, 2), (0,), (1, 2), (2,)])
def test_region_sum_rule_reduces_a_grid_view_in_one_call(monkeypatch, axes):
    from cubed_tpu_torch.kernels import region_sum as region_module

    base = torch.from_numpy(_an((50, 45, 40), 4))[1:]  # a [1:] view, as the index leaves it
    view = _grid_view(base, (4, 4, 4), (10, 10, 10))
    calls = []
    plain = region_module.region_sum_plain

    def counting(x, ax, keep):
        calls.append((tuple(x.shape), tuple(ax), x.data_ptr() == view.data_ptr()))
        return plain(x, ax, keep)

    monkeypatch.setattr(region_module, "region_sum_plain", counting)
    got = vmap(vmap(vmap(lambda b: region_sum(b, axes))))(view)
    # one call of the op's body, on the whole grid view, in place, the grid
    # axes kept
    assert calls == [((4, 4, 4, 10, 10, 10), tuple(a + 3 for a in axes), True)]
    want = plain(view, tuple(a + 3 for a in axes))
    torch.testing.assert_close(got, want, rtol=REDUCTION_RTOL, atol=0)
    for idx in [(0, 0, 0), (3, 2, 1)]:
        block = base[tuple(slice(10 * i, 10 * i + 10) for i in idx)]
        torch.testing.assert_close(got[idx], plain(block, axes), rtol=REDUCTION_RTOL, atol=0)


def test_philox_rule_fills_a_bucket_like_numpy():
    like = torch.zeros((), dtype=torch.float64).expand(7, 5)
    seeds = torch.arange(6, dtype=torch.int64).reshape(2, 3, 1, 1) + 2**30 - 2
    got = vmap(vmap(lambda s: philox_blocks(like, s)))(seeds)
    assert got.shape == (2, 3, 7, 5)
    for i, j in np.ndindex(2, 3):
        want = np.random.Generator(np.random.Philox(seed=int(seeds[i, j, 0, 0]))).random((7, 5))
        np.testing.assert_array_equal(got[i, j].numpy().view(np.uint64), want.view(np.uint64))
    # a batched template is read at one block; unbatched seeds give one block
    assert torch.equal(vmap(lambda t, s: philox_blocks(t, s), in_dims=(0, None))(
        like.expand(3, 7, 5), seeds[0, 0]), got[0, 0].expand(3, 7, 5))


def test_sqrt_rule_is_numpy_correctly_rounded():
    x = torch.from_numpy(_an((6, 100), 5) * 1e3)
    np.testing.assert_array_equal(vmap(nxp.sqrt)(x).numpy(), np.sqrt(x.numpy()))
    np.testing.assert_array_equal(np.asarray(jax_nxp.sqrt(x.numpy())), vmap(nxp.sqrt)(x).numpy())


# ---------------------------------------------------------------------------
# fma_sum_blocks: the plain version and the kernel's geometry
# ---------------------------------------------------------------------------


def _c_strides(shape):
    out, s = [], 1
    for n in reversed(shape):
        out.append(s)
        s *= n
    return tuple(reversed(out))


# name: (shape of the views, base shape, chunks, tile units, itemsize)
FMA_BLOCK_CASES = {
    "main-path-slice": ((49, 45, 40), (50, 45, 40), (10, 10, 10), _geometry.FMA_TILE, 8),
    "split-tiles": ((49, 45, 40), (50, 45, 40), (10, 10, 10), 96, 8),
    "odd-inner": ((13, 11, 7), (14, 11, 7), (4, 5, 3), 16, 8),
    "float32": ((21, 16), (22, 16), (8, 8), 8, 4),
    "one-d": ((1000,), (1001,), (300,), 64, 8),
    "four-d": ((5, 6, 4, 6), (6, 6, 4, 6), (2, 4, 3, 4), 8, 8),
}


@pytest.mark.parametrize("case", sorted(FMA_BLOCK_CASES))
def test_fma_sum_blocks_plan_reads_each_element_once_in_its_own_block(case):
    shape, base_shape, chunks, tile, itemsize = FMA_BLOCK_CASES[case]
    strides = _c_strides(base_shape)
    offset = strides[0]  # the [1:] view starts one row in
    p = _geometry.fma_blocks_plan(shape, [strides] * 4, chunks, [offset * itemsize] * 4, itemsize, tile)
    blocks, items, offsets = _geometry.fma_blocks_walk(torch, p)
    view = torch.arange(int(np.prod(base_shape)), dtype=torch.int64).as_strided(shape, strides, offset)
    for off in offsets:
        assert torch.equal(torch.sort(off + offset).values, torch.sort(view.reshape(-1)).values)
    # each element's block is the block that holds it (C order of the grid)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    coords = np.unravel_index((offsets[0] + offset).numpy(), base_shape)
    coords = [coords[0] - 1, *coords[1:]]
    owner = np.ravel_multi_index(tuple(c // ch for c, ch in zip(coords, chunks)), grid)
    np.testing.assert_array_equal(blocks.numpy(), owner)
    # per-block tickets: every block draws per_block of them, one per item
    per_block = p.per_block[0]
    assert p.items == p.blocks * per_block == int(np.prod(grid)) * per_block
    assert set(np.unique(items.numpy() // per_block)) <= set(range(p.blocks))
    assert p.paths[1] == ("one_cta" if per_block == 1 else "split")


def test_fma_sum_blocks_vector_path_needs_every_block_row_aligned():
    base = _c_strides((50, 45, 40))
    assert _geometry.fma_blocks_plan((49, 45, 40), [base] * 4, (10,) * 3, [1800 * 8] * 4, 8).vector == 2
    # an odd chunk along the rows, a misaligned input, a strided row: scalar
    assert _geometry.fma_blocks_plan((49, 45, 40), [base] * 4, (10, 10, 5), [1800 * 8] * 4, 8).vector == 1
    assert _geometry.fma_blocks_plan((49, 45, 40), [base] * 4, (10,) * 3, [1800 * 8, 8, 0, 0], 8).vector == 1
    assert _geometry.fma_blocks_plan((49, 45, 20), [(1800, 40, 2)] * 4, (10,) * 3, [0] * 4, 8).vector == 1
    p = _geometry.fma_blocks_plan((499, 450, 400), [(180000, 400, 1)] * 4, (100,) * 3, [180000 * 8] * 4, 8)
    assert (p.vector, p.blocks, p.per_block[0]) == (2, 100, -(-50 * 100 * 100 // _geometry.FMA_TILE))
    assert len(p.params()) == 3 * 4 * 3 + 4 * 4 + 3 + 2
    with pytest.raises(ValueError, match="32 bits"):
        _geometry.fma_blocks_plan((2**16, 2**16), [(2**16, 1)] * 4, (1024, 1024), [0] * 4, 8)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fma_sum_blocks_plain_is_fma_sum_plain_per_block(dtype):
    base = [torch.from_numpy(_an((22, 13, 9), s)).to(dtype) for s in range(4)]
    ts = [t[1:] for t in base]
    got = fma_sum_blocks(*ts, (5, 4, 9))  # a CPU tensor: the plain version
    assert got.shape == (5, 4, 1) and got.dtype == torch.float64
    assert torch.equal(got, fma_sum_blocks_plain(*ts, (5, 4, 9)))
    for idx in np.ndindex(5, 4, 1):
        sel = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, (5, 4, 9)))
        assert torch.equal(got[idx].reshape(1, 1, 1), fma_sum_plain(*[t[sel] for t in ts]))
    # the JAX package's sum of the same terms, per block
    a, x, b, y = [t.numpy() for t in ts]
    terms = (a * x + b * y).astype(np.float64)
    want = np.asarray(jax_nxp.sum(terms[:5, :4, :9]))
    np.testing.assert_allclose(float(got[0, 0, 0]), float(want), rtol=REDUCTION_RTOL)


# ---------------------------------------------------------------------------
# segments: the structural key, hoisted keys, the pre-check, graph bytes
# ---------------------------------------------------------------------------


def _vorticity(spec, shape=(30, 25, 20), chunks=10, op="add", axis=None, dtype=None, scale=None):
    a, b, x, y = [cubed_tpu_torch.random.random(shape, chunks=chunks, spec=spec) for _ in range(4)]
    if dtype is not None:
        a, b, x, y = [pxp.astype(t, dtype) for t in (a, b, x, y)]
    combine = {"add": pxp.add, "subtract": pxp.subtract}[op]
    expr = combine(pxp.multiply(a[1:], x[1:]), pxp.multiply(b[1:], y[1:]))
    if scale is not None:
        expr = pxp.multiply(expr, scale)
    return pxp.mean(expr, axis=axis)


def _segment(result):
    """(executor, the plan's segment of ops, dag, requested stores)."""
    dag = result.plan._finalize(array_names=(result.name,)).dag
    ex = CudaExecutor()
    ops = [(n, d) for n, d in visit_nodes(dag) if ex._classify(d["primitive_op"]) == "segment"]
    return ex, ops, dag, {result.zarray_maybe_lazy.store}


def _skey(result):
    ex, ops, dag, requested = _segment(result)
    keep = ex._segment_keep(ops, dag, requested)
    keep_list = [k for k in keep if k in ex._produced(ops)]
    return ex._structural_key(ops, dag, [], {}, keep_list, ex._hoisted_arrays(ops), torch.device("cpu"))


def _spec(tmp_path, name):
    return cubed_tpu_torch.Spec(work_dir=str(tmp_path / name), allowed_mem="500MB")


def test_structural_key_is_shared_across_seeds_and_work_dirs(tmp_path):
    random.seed(1)
    k1 = _skey(_vorticity(_spec(tmp_path, "one")))
    random.seed(2)
    k2 = _skey(_vorticity(_spec(tmp_path, "two")))
    assert k1 is not None and k1 == k2


@pytest.mark.parametrize("change", [
    dict(shape=(30, 25, 21)), dict(chunks=(10, 10, 5)), dict(dtype=np.float32), dict(axis=0),
    dict(op="subtract"), dict(scale=2.0),
], ids=["shape", "chunks", "dtype", "axis", "function", "constant"])
def test_structural_key_differs_where_the_graph_would(tmp_path, change):
    random.seed(1)
    base = _skey(_vorticity(_spec(tmp_path, "base"), scale=3.0 if "scale" in change else None))
    random.seed(1)
    other = _skey(_vorticity(_spec(tmp_path, "other"), **change))
    assert base is not None and other is not None and base != other


def test_structural_key_is_none_for_what_it_cannot_describe(tmp_path):
    spec = _spec(tmp_path, "lock")
    a = cubed_tpu_torch.from_array(_an((8, 8)), chunks=4, spec=spec)
    import threading

    lock = threading.Lock()

    def with_lock(x):
        with lock:
            return x + 1

    assert _skey(cubed_tpu_torch.map_blocks(with_lock, a, dtype=a.dtype)) is None


def test_hoisted_seeds_are_every_block_of_each_random_array(tmp_path):
    random.seed(3)
    result = _vorticity(_spec(tmp_path, "seeds"))
    ex, ops, _, _ = _segment(result)
    arrays = ex._hoisted_arrays(ops)
    assert len(arrays) == 4 and all(a.shape == (3, 3, 2) for a in arrays)
    seeds = ex._seeds(arrays)
    assert list(seeds) == [a.base + k for a in arrays for k in range(18)]


def test_hoisted_keys_equal_the_eager_paths():
    seeds = 2**30 - 5 + np.arange(40, dtype=np.int64)
    table = HoistedKeys(seeds, "cpu")
    table.upload()
    np.testing.assert_array_equal(table.lookup(seeds).numpy().view(np.uint64), philox_keys(seeds))
    grid = seeds.reshape(5, 8)[1:4, 2:5]  # a bucket of a ragged grid: an affine grid of rows
    np.testing.assert_array_equal(table.lookup(grid).numpy().view(np.uint64), philox_keys(grid.reshape(-1)))
    # the whole-array form draws the same bits from the table as without it
    with hoisted(table):
        got = _random_blocks((40, 7), (5, 7), int(seeds[8]), "cpu")
        assert isinstance(block_keys(seeds[:3]), torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), _random_blocks((40, 7), (5, 7), int(seeds[8]), "cpu").numpy())
    # a replay for new seeds refills the same rows
    table.fill(seeds + 1000)
    table.upload()
    np.testing.assert_array_equal(table.device.numpy().view(np.uint64), philox_keys(seeds + 1000))
    with pytest.raises(KeyError):
        table.lookup(np.array([1, 2]))
    with pytest.raises(ValueError):
        table.fill(seeds[:3])


def test_blocks_kernel_takes_device_keys_like_host_keys():
    keys = philox_keys(np.arange(6))
    f64 = dict(dtype=torch.float64)
    a = philox_uniform_blocks(torch.empty((6, 4), **f64), (1, 4), keys)
    b = philox_uniform_blocks(torch.empty((6, 4), **f64), (1, 4), torch.from_numpy(keys.view(np.int64)))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="int64 keys"):
        philox_uniform_blocks(torch.empty((6, 4), **f64), (1, 4), torch.zeros((5, 2), dtype=torch.int64))


def test_precheck_aborts_a_segment_that_would_not_fit(tmp_path):
    random.seed(4)
    result = _vorticity(_spec(tmp_path, "fit"))
    ex, ops, _, _ = _segment(result)
    out_bytes = sum(int(np.prod(w.array.shape)) * np.dtype(w.array.dtype).itemsize
                    for _, d in ops for w in d["primitive_op"].pipeline.config.writes)
    assert ex._segment_fits(ops, {}, out_bytes)
    assert not ex._segment_fits(ops, {}, out_bytes - 1)
    resident = {"other": cuda_module._Resident(torch.zeros(10, dtype=torch.float64), None)}  # 80 B
    assert not ex._segment_fits(ops, resident, out_bytes + 79)


def test_precheck_needs_every_storage_source_resident(tmp_path):
    x = _an((30, 20), 8)
    store = str(tmp_path / "x.zarr")
    cubed_tpu.to_zarr(cubed_tpu.from_array(x, chunks=(7, 6), spec=cubed_tpu.Spec(
        work_dir=str(tmp_path / "ref"), allowed_mem="100MB")), store)
    arr = cubed_tpu_torch.from_zarr(store, spec=_spec(tmp_path, "port"))
    ex, ops, _, _ = _segment(pxp.sum(arr * 2.0, axis=0))
    assert not ex._segment_fits(ops, {}, 10**9)
    resident = {}
    assert ex._preload(ex._segment_sources(ops)[0], resident, 10**9)
    assert ex._segment_fits(ops, resident, 10**9)


def test_segment_keeps_only_what_is_read_after_it_or_requested(tmp_path):
    random.seed(5)
    result = _vorticity(_spec(tmp_path, "keep"))
    ex, ops, dag, requested = _segment(result)
    keep = ex._segment_keep(ops, dag, requested)
    assert set(keep) == requested  # every other output is read inside the segment


class _FakeGraph:
    def __init__(self, nbytes, device="cuda:0"):
        self.nbytes = nbytes
        self.device = device


def test_graph_pool_bytes_are_read_from_the_allocator_snapshot():
    segments = [
        {"total_size": 2 << 20, "segment_pool_id": (0, 7)},
        {"total_size": 4 << 20, "segment_pool_id": (0, 7)},
        {"total_size": 8 << 20, "segment_pool_id": (0, 0)},
        {"total_size": 1 << 20},
    ]
    assert cuda_module._pool_bytes(segments, (0, 7)) == 6 << 20
    assert cuda_module._pool_bytes(segments, (0, 9)) == 0


def test_cached_graphs_stay_within_the_budget_least_recently_used_first():
    cache = cuda_module._GraphCache()
    assert cache.put("a", _FakeGraph(40), limit=100)
    assert cache.put("b", _FakeGraph(40), limit=100)
    assert cache.get("a") is not None  # a is now the most recently used
    assert cache.put("c", _FakeGraph(40), limit=100)  # drops b, the least recently used
    assert list(cache.entries) == ["a", "c"] and cache.nbytes("cuda:0") == 80
    assert not cache.put("d", _FakeGraph(150), limit=100)  # larger than the budget: not cached
    assert cache.put("e", _FakeGraph(10, "cuda:1"), limit=15)  # another card's budget
    cache.shrink("cuda:0", 50, keep="a")
    assert list(cache.entries) == ["a", "e"]


def test_precheck_drops_stale_graphs_before_it_aborts(tmp_path, monkeypatch):
    # two plan shapes' graphs whose pools together pass the budget beside
    # this segment's outputs: the other shape's goes, this one's stays
    monkeypatch.setattr(cuda_module, "_GRAPHS", cache := cuda_module._GraphCache())
    random.seed(4)
    ex, ops, _, _ = _segment(_vorticity(_spec(tmp_path, "graphs")))
    out_bytes = sum(int(np.prod(w.array.shape)) * np.dtype(w.array.dtype).itemsize
                    for _, d in ops for w in d["primitive_op"].pipeline.config.writes)
    cpu = torch.device("cpu")
    cache.put("other", _FakeGraph(600, cpu), limit=10**9)
    cache.put("this", _FakeGraph(400, cpu), limit=10**9)
    assert ex._segment_fits(ops, {}, out_bytes + 500, cpu, skey="this")
    assert list(cache.entries) == ["this"]
    # this segment's own graph is never dropped for it: it does not fit
    assert not ex._segment_fits(ops, {}, out_bytes + 399, cpu, skey="this")
    assert list(cache.entries) == ["this"]


class _Target:
    dtype = np.dtype(np.float64)


def test_admit_drops_cached_graphs_before_resident_arrays_spill(monkeypatch):
    monkeypatch.setattr(cuda_module, "_GRAPHS", cache := cuda_module._GraphCache())
    cpu = torch.device("cpu")
    cache.put("old", _FakeGraph(800, cpu), limit=10**9)
    cache.put("new", _FakeGraph(800, cpu), limit=10**9)
    ex = CudaExecutor()
    resident = {}
    for name in ("a", "b"):  # 800 B each: 1600 B of arrays beside 1600 B of graphs
        ex._admit(resident, name, torch.zeros(100, dtype=torch.float64), _Target(), 3200)
    assert list(resident) == ["a", "b"] and list(cache.entries) == ["old", "new"]
    # a third array: the least recently used graph goes, no array spills
    ex._admit(resident, "c", torch.zeros(100, dtype=torch.float64), _Target(), 3200)
    assert list(resident) == ["a", "b", "c"] and list(cache.entries) == ["new"]
    ex._admit(resident, "d", torch.zeros(100, dtype=torch.float64), _Target(), 3200)
    assert list(resident) == ["a", "b", "c", "d"] and not cache.entries
    # with no graph left, the least recently used array spills
    ex._admit(resident, "e", torch.zeros(100, dtype=torch.float64), _Target(), 3200)
    assert list(resident) == ["b", "c", "d", "e"]


def test_fuse_plan_false_runs_every_op_on_its_own(tmp_path):
    random.seed(6)
    spec = _spec(tmp_path, "nofuse")
    ex = CudaExecutor(fuse_plan=False)
    got = _vorticity(spec).compute(executor=ex)
    random.seed(6)
    want = _vorticity(spec).compute(executor=CudaExecutor())
    np.testing.assert_array_equal(got, want)
    assert ex.stats["eager_ops"] == ex.stats["batched_ops"] + ex.stats["chunked_ops"] + 1 + 4
    assert ex.stats["segments_traced"] == 0
