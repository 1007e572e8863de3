"""How the reduction kernels split their work (cubed_tpu_torch/kernels/_geometry.py),
on the CPU.

The CUDA kernels run only on the card, but every choice they act on is made
in pure Python before the launch: merged axes, per-input strides, the layout,
the vector or scalar path, the grid, the reduced units each CTA takes, the
partials and the 32-bit check. Here each plan is replayed as the kernels run
it (``_geometry.walk``: the elements each CTA's threads load, step by step),
and every element of every input must be read exactly once, by the CTA of
its own output. The gathered elements, summed per output, must equal the
JAX package's ``nxp.sum`` of the same numpy input: within 1e-12 of the sum
of magnitudes for float64 (and for fma_sum's float64 terms), 1e-6 for
float32, exactly for int64. The kernels themselves are held against their
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cubed_tpu.backend_array_api import nxp  # noqa: E402
from cubed_tpu_torch.kernels import _geometry  # noqa: E402
from cubed_tpu_torch.kernels import fma_sum as fma_mod  # noqa: E402
from cubed_tpu_torch.kernels import region_sum as region_mod  # noqa: E402

MAIN = (180000, 400, 1)  # strides of a block view of a (499, 450, 400) array
TOL = {np.float64: 1e-12, np.float32: 1e-6}
ITEMSIZE = {np.float64: 8, np.float32: 4, np.int64: 8}


def _c_strides(shape):
    out, s = [], 1
    for n in reversed(shape):
        out.append(s)
        s *= n
    return tuple(reversed(out))


def _data(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int64:
        return rng.integers(-(10**15), 10**15, size=shape, dtype=np.int64)
    return (rng.random(shape) * 100 - 50).astype(dtype)


def _view_offsets(shape, strides):
    """Element offset of each element of a strided view, in C order."""
    off = torch.zeros(shape, dtype=torch.int64)
    for d, (n, s) in enumerate(zip(shape, strides)):
        idx = torch.arange(n, dtype=torch.int64) * s
        off = off + idx.reshape([n if k == d else 1 for k in range(len(shape))])
    return off.reshape(-1)


def _read_once(offsets, shape, strides):
    """The C-order index, in the view, of each offset read; asserts that the
    offsets read are the view's own, each exactly once."""
    want = _view_offsets(shape, strides)
    assert offsets.numel() == want.numel()
    got_sorted, _ = torch.sort(offsets)
    want_sorted, order = torch.sort(want)
    assert torch.equal(got_sorted, want_sorted), "an element is read twice or not at all"
    return order[torch.searchsorted(want_sorted, offsets)]


# name: (shape, strides, pointer offset in bytes, dtype, reduced axes)
REGION_CASES = {
    "main-path-view": ((100, 100, 100), MAIN, 0, np.float64, None),
    "main-path-view-misaligned": ((100, 100, 100), MAIN, 8, np.float64, None),
    "ragged-view": ((99, 50, 100), MAIN, 0, np.float64, None),
    "contiguous-block": ((100, 100, 100), None, 0, np.float64, None),
    "strided-view-axis0": ((100, 100, 100), MAIN, 0, np.float64, (0,)),
    "strided-view-axes12": ((100, 100, 100), MAIN, 0, np.float64, (1, 2)),
    "combine-sized": ((5, 5, 4), None, 0, np.float64, None),
    "combine-view": ((4, 1, 4), (20, 4, 1), 0, np.float64, None),
    "combine-axis0": ((5, 5, 4), None, 0, np.float64, (0,)),
    "size0-all": ((0, 5), None, 0, np.float64, None),
    "size0-kept": ((3, 0), None, 0, np.float64, (1,)),
    "size1": ((1,), None, 0, np.float64, None),
    "float32-rows-of-100": ((99, 37, 100), (4000, 100, 1), 0, np.float32, None),
    "float32-rows-axis1": ((99, 37, 100), (4000, 100, 1), 0, np.float32, (1,)),
    "int64-rows": ((37, 20, 8), None, 0, np.int64, (2,)),
    "int64-columns-split": ((300, 40), None, 0, np.int64, (0,)),
    "transposed": ((30, 40), (1, 30), 0, np.float64, (1,)),
    "interleaved": ((6, 7, 8, 9), None, 0, np.float64, (0, 2)),
}


@pytest.mark.parametrize("case", sorted(REGION_CASES))
def test_region_sum_plan_reads_each_element_once_and_sums_like_the_jax_package(case):
    shape, strides, ptr, dtype, axes = REGION_CASES[case]
    strides = strides or _c_strides(shape)
    p = _geometry.plan(shape, [strides], [4096 + ptr], ITEMSIZE[dtype], axes)
    keep_shape = tuple(1 if axes is None or d in axes else n for d, n in enumerate(shape))
    assert p.outputs == int(np.prod(keep_shape))
    x = _data(shape, dtype, seed=len(case))
    out_elem, (offsets,) = _geometry.walk(torch, p, 1)
    if p.grid == 0 or x.size == 0:
        assert out_elem.numel() == 0
        return
    idx = _read_once(offsets, shape, strides)
    # each element goes to the CTA of its own output
    own = torch.arange(p.outputs).reshape(keep_shape).expand(shape).reshape(-1)
    assert torch.equal(out_elem, own[idx])
    vals = torch.from_numpy(x.reshape(-1))[idx]
    acc = torch.int64 if dtype == np.int64 else torch.float64
    sums = torch.zeros(p.outputs, dtype=acc).index_add_(0, out_elem, vals.to(acc)).numpy()
    ref = np.asarray(nxp.sum(nxp.asarray(x), axis=axes, keepdims=True)).reshape(-1)
    if dtype == np.int64:
        np.testing.assert_array_equal(sums, ref)
    else:
        scale = np.sum(np.abs(x.astype(np.float64)), axis=axes, keepdims=True).reshape(-1)
        assert np.all(np.abs(sums - ref.astype(np.float64)) <= TOL[dtype] * scale)


def test_main_path_block_view_plan():
    # four (100, 100, 100) float64 views of (499, 450, 400) arrays, as the
    # device executor's chunked path passes them to fma_sum (a grid of one
    # block): 500,000 double2 units; one block alone takes tiles of 2048
    # units, so 245 CTAs (about two per SM of an H100) each write a partial,
    # which the block's last CTA sums
    p = _geometry.fma_blocks_plan((100, 100, 100), [MAIN] * 4, (100, 100, 100), [0] * 4, 8)
    assert p.vector == 2 and p.blocks == 1
    assert p.strides == ((0, 180000, 400, 2),) * 4
    assert (p.tile_units, p.per_block[0], p.items) == (2048, 245, 245)
    assert p.paths == ("vector", "split")
    # many blocks keep the full tile
    p = _geometry.fma_blocks_plan((499, 450, 400), [(180000, 400, 1)] * 4, (100,) * 3, [0] * 4, 8)
    assert (p.tile_units, p.per_block[0], p.items) == (_geometry.FMA_TILE, 123, 12300)


def test_contiguous_block_merges_to_one_axis():
    p = _geometry.plan((100, 100, 100), [_c_strides((100, 100, 100))], [0], 8)
    assert p.reduced.sizes == (500000,) and p.reduced.strides == ((2,),)


def test_combine_sized_input_takes_one_cta_and_no_partials():
    p = _geometry.plan((5, 5, 4), [_c_strides((5, 5, 4))], [0], 8)
    assert (p.grid, p.threads, p.splits, p.partials, p.tickets) == (1, 32, 1, 0, 0)
    assert p.paths == ("rows", "vector", "one_cta")


@pytest.mark.parametrize(
    "strides, ptr, itemsize, vector",
    [
        (MAIN, 0, 8, 2),
        (MAIN, 8, 8, 1),  # base not 16-byte aligned
        ((180000, 401, 1), 0, 8, 1),  # a row start not 16-byte aligned
        ((180000, 400, 2), 0, 8, 1),  # innermost stride not 1
        (MAIN, 0, 4, 4),  # float32: float4 loads
        ((180000, 402, 1), 0, 4, 1),
    ],
)
def test_vector_path_needs_unit_stride_and_16_byte_rows(strides, ptr, itemsize, vector):
    assert _geometry.plan((10, 10, 100), [strides], [ptr], itemsize).vector == vector


def test_vector_path_needs_every_input_aligned():
    strides = [MAIN] * 4
    assert _geometry.plan((10, 10, 100), strides, [0, 16, 32, 48], 8).vector == 2
    assert _geometry.plan((10, 10, 100), strides, [0, 16, 40, 48], 8).vector == 1
    assert _geometry.plan((10, 10, 98), strides, [0] * 4, 4).vector == 1  # 98 % 4


def test_axes_merge_only_where_every_input_is_contiguous():
    shape = (4, 5, 6)
    c = _c_strides(shape)
    assert _geometry.plan(shape, [c, c], [0, 0], 8).reduced.sizes == (60,)
    p = _geometry.plan(shape, [c, (60, 6, 1)], [0, 0], 8)  # second input: rows of a wider array
    assert p.reduced.sizes == (4, 15)  # rows of 30, in double2 units
    assert p.reduced.strides == ((30, 2), (60, 2))


def test_region_sum_columns_layout_splits_the_reduced_extent():
    p = _geometry.plan((100, 100, 100), [MAIN], [0], 8, (0,))
    assert p.layout == "columns" and p.vector == 2
    assert p.kept.sizes == (100, 50) and p.kept.strides == ((400, 2),)
    assert p.reduced.sizes == (100,) and p.reduced.strides == ((180000,),)
    tiles = -(-p.out_units // p.threads)
    assert (p.out_units, p.threads, tiles) == (5000, 256, 20)
    assert p.grid == tiles * p.splits and p.splits > 1
    assert (p.partials, p.tickets) == (p.splits * 10000, tiles)
    assert p.partials < 100 * 100 * 100  # far less than a copy of the input


@pytest.mark.parametrize(
    "shape, strides, itemsize",
    [
        ((2, 2), (2**31, 1), 8),  # an offset past 32 bits
        ((2**16, 2**15 + 1), None, 8),  # more elements than an int counts
        ((2, 2**30), (2**30 + 2**15, 1), 8),
    ],
)
def test_plan_refuses_offsets_past_32_bits(shape, strides, itemsize):
    with pytest.raises(ValueError, match="32 bits"):
        _geometry.plan(shape, [strides or _c_strides(shape)], [0], itemsize)


def test_plan_refuses_more_than_four_merged_axes_of_a_role():
    """Four merged axes of a role take the narrow index; five to eight (a
    grid view of blocks) the wide one; more are refused."""
    # a view taking 3 of every 4 along each axis: no two axes merge
    with pytest.raises(ValueError, match="at most 8"):
        _geometry.plan((3,) * 18, [_c_strides((4,) * 18)], [0], 8, tuple(range(0, 18, 2)))
    p = _geometry.plan((3,) * 8, [_c_strides((4,) * 8)], [0], 8, (0, 2, 4, 6))
    assert len(p.kept.sizes) == len(p.reduced.sizes) == 4 and p.dims == 4
    p = _geometry.plan((3,) * 10, [_c_strides((4,) * 10)], [0], 8, (0, 2, 4, 6, 8))
    assert len(p.kept.sizes) == len(p.reduced.sizes) == 5 and p.dims == 8
    assert len(p.params()) == 2 * (3 * 8 + 8) + 5


def test_region_sum_plan_takes_grid_views_past_four_kept_axes():
    """A grid view (nb0, nb1, nb2, c0, c1, c2) of a [1:] slice reduced over
    its first in-block axis keeps five unmergeable axes: the wide index.
    The replay reads every element once, in its own output."""
    shape, strides = (4, 4, 4, 10, 10, 10), (18000, 400, 10, 1800, 40, 1)
    p = _geometry.plan(shape, [strides], [1800 * 8], 8, (3,))
    assert p.dims == 8 and len(p.kept.sizes) == 5 and p.layout == "columns"
    out, (offsets,) = _geometry.walk(torch, p)
    view = torch.arange(50 * 45 * 40, dtype=torch.int64).as_strided(shape, strides, 1800)
    want = view.movedim(3, -1).reshape(-1, 10)  # output element -> its 10 inputs
    assert torch.equal(torch.sort(offsets + 1800).values, torch.sort(want.reshape(-1)).values)
    for o in (0, 17, 1023, 6399):
        assert torch.equal(torch.sort(offsets[out == o] + 1800).values, torch.sort(want[o]).values)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 100, 255, 256, 257, 4095, 10**6, 2**30 - 1, 2**30, 2**31 - 1])
def test_fast_division_matches_floor_division(d):
    rng = np.random.default_rng(d)
    i = torch.from_numpy(np.concatenate([
        np.array([0, 1, d - 1, d, d + 1, 2 * d - 1, 2**31 - 1, 2**31 - 2]) % 2**31,
        rng.integers(0, 2**31, size=10_000),
    ]).astype(np.int64))
    assert torch.equal(_geometry.fast_div(i, d), i // d)
    assert _geometry.fast_divmod(d)[0] < 2**32


def test_params_lay_out_the_geometry_for_the_c_entry_points():
    p = _geometry.plan((100, 100, 100), [MAIN], [0], 8)
    params = p.params()
    assert len(params) == 2 * (12 + 4) + 5
    kept, red = params[:16], params[16:32]
    assert kept[:4] == [1, 1, 1, 1] and kept[12:] == [0] * 4
    assert red[:4] == [1, 100, 100, 50]
    assert red[4:8] == [0] + [_geometry.fast_divmod(n)[0] for n in (100, 100, 50)]
    assert red[12:16] == [0, 180000, 400, 2]
    assert params[32:] == [1, 500000, 264, 1894, 1]


def test_wrappers_plan_from_their_tensors_metadata():
    base = torch.zeros((12, 9, 8), dtype=torch.float64)
    v = base[1:10, 2:7, 0:8]
    assert region_mod.plan(v, (0,)) == _geometry.plan(
        (9, 5, 8), [(72, 8, 1)], [v.data_ptr()], 8, (0,))
    ts = [v, v, base[2:11, 3:8, 0:8], v]
    assert fma_mod.blocks_plan(*ts, (9, 5, 8)) == _geometry.fma_blocks_plan(
        (9, 5, 8), [(72, 8, 1)] * 4, (9, 5, 8), [t.data_ptr() for t in ts], 8)


# name: (shape, the inputs' strides, their pointer offsets in bytes, dtype)
FMA_CASES = {
    "main-path-view": ((100, 100, 100), [MAIN] * 4, [0] * 4, np.float64),
    "ragged-view": ((99, 50, 100), [MAIN] * 4, [0] * 4, np.float64),
    "contiguous-block": ((100, 100, 100), [None] * 4, [0] * 4, np.float64),
    "mixed-strides": ((20, 30, 40), [None, MAIN, (1200, 40, 1), MAIN], [0, 16, 32, 0], np.float64),
    "one-input-misaligned": ((20, 30, 40), [MAIN] * 4, [0, 0, 8, 0], np.float64),
    "float32-rows-of-100": ((99, 37, 100), [(4000, 100, 1)] * 4, [0] * 4, np.float32),
    "combine-sized": ((5, 5, 4), [None] * 4, [0] * 4, np.float64),
    "size0": ((0, 5), [None] * 4, [0] * 4, np.float64),
    "size1": ((1,), [None] * 4, [0] * 4, np.float64),
}


@pytest.mark.parametrize("case", sorted(FMA_CASES))
def test_fma_sum_plan_reads_each_element_once_and_sums_like_the_jax_package(case):
    # fma_sum is fma_sum_blocks on a grid of one block
    shape, strides, ptrs, dtype = FMA_CASES[case]
    strides = [s or _c_strides(shape) for s in strides]
    rng = np.random.default_rng(len(case))
    a, x, b, y = [(rng.random(shape) * 2 - 1).astype(dtype) for _ in range(4)]
    if a.size == 0:  # nothing to read: no launch, a zero
        aligned = tuple(q % 16 == 0 for q in ptrs)
        assert fma_mod._launch_plan(shape, tuple(strides), shape, aligned, ITEMSIZE[dtype], 132)[1] is None
        return
    p = _geometry.fma_blocks_plan(shape, strides, shape, [4096 + q for q in ptrs], ITEMSIZE[dtype])
    assert p.blocks == 1 and p.items >= 1
    blocks, _, offsets = _geometry.fma_blocks_walk(torch, p)
    assert torch.equal(blocks, torch.zeros_like(blocks))
    vals = []
    for t, st, off in zip((a, x, b, y), strides, offsets):
        vals.append(torch.from_numpy(t.reshape(-1))[_read_once(off, shape, st)])
    ga, gx, gb, gy = vals
    got = float((ga * gx + gb * gy).to(torch.float64).sum())
    ref = float(nxp.sum(nxp.asarray(a) * nxp.asarray(x) + nxp.asarray(b) * nxp.asarray(y),
                        dtype=nxp.float64))
    scale = float(np.sum(np.abs((a * x).astype(np.float64))) + np.sum(np.abs((b * y).astype(np.float64))))
    assert abs(got - ref) <= TOL[dtype] * scale
