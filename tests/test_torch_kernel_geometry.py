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


# ---------------------------------------------------------------------------
# sort_block / argsort_block: the tile sort and its merge passes
# ---------------------------------------------------------------------------

SORT_ITEMSIZES = (8, 4, 2, 1)


def _tile(inner, itemsize, mode="values"):
    return _geometry.sort_plan(1, 1 << 20, inner, itemsize, mode).tile


def _walk_items(p, lane_groups):
    """Work items of *p* in the given lane groups, every tile and outer index."""
    o, lg, kt = np.meshgrid(np.arange(p.outer), np.asarray(lane_groups), np.arange(p.tiles_n), indexing="ij")
    return torch.from_numpy(((o * p.lane_groups + lg) * p.tiles_n + kt).reshape(-1))


def _check_sort_walk(p, items=None):
    """Replay *p*: each launch writes every element of the walked lanes
    exactly once; the tile sort's tiles and each pass's pairs lie inside
    their lane, each pair is two runs of the pass's width that the launch
    before it left sorted (a tile, or a pair of the pass before)."""
    launches = _geometry.sort_walk(torch, p)
    assert len(launches) == p.launches
    outer, n, inner = p.outer, p.n, p.inner
    if items is None:
        expected = torch.arange(outer * n * inner)
    else:
        lg = torch.unique(torch.div(items // p.tiles_n, 1, rounding_mode="floor") % p.lane_groups)
        lanes = torch.cat([torch.arange(g * p.lanes, min((g + 1) * p.lanes, inner)) for g in lg.tolist()])
        o = torch.arange(outer)
        k = torch.arange(n)
        expected = ((o[:, None, None] * n + k[None, :, None]) * inner + lanes[None, None, :]).reshape(-1)
        keep = torch.isin(launches[0][1], items)
        launches = [tuple(t[keep] for t in launch) for launch in launches]
    segments = None
    for j, (offsets, row, starts, ends) in enumerate(launches):
        # every element of the walked lanes exactly once
        assert torch.equal(torch.sort(offsets).values, torch.sort(expected).values)
        pos = offsets // inner % n
        assert bool(((starts <= pos) & (pos < ends)).all()) and bool((ends <= n).all())
        assert bool((starts % p.tile == 0).all())
        lane = offsets // (n * inner) * inner + offsets % inner
        if j == 0:
            assert bool((ends - starts <= p.tile).all())
            assert bool(((pos - starts) < p.tile).all())
        else:
            w = p.widths[j - 1]
            assert bool((starts % (2 * w) == 0).all())
            # the two runs of each pair were segments the launch before sorted
            mid = torch.clamp(starts + w, max=n)
            run_start = torch.where(pos < mid, starts, mid)
            run_end = torch.where(pos < mid, mid, ends)
            got = set(zip(lane.tolist(), run_start.tolist(), run_end.tolist()))
            assert got <= segments
        # a work item's outputs: at most `tile` positions of at most `lanes`
        # lanes, one pair (or tile) per lane
        per_item = torch.unique(torch.stack([row, starts]), dim=1)
        assert per_item.shape[1] == torch.unique(row).numel()
        segments = set(zip(lane.tolist(), starts.tolist(), ends.tolist()))


@pytest.mark.parametrize("itemsize", SORT_ITEMSIZES)
@pytest.mark.parametrize("inner", [1, 7])
@pytest.mark.parametrize("n_at", ["1", "T-1", "T", "T+1", "3T+5", "16384"])
def test_sort_plan_walks_every_element_once_a_launch(itemsize, inner, n_at):
    t = _tile(inner, itemsize)
    n = {"1": 1, "T-1": t - 1, "T": t, "T+1": t + 1, "3T+5": 3 * t + 5, "16384": 16384}[n_at]
    for mode in _geometry.SORT_MODES:
        p = _geometry.sort_plan(2, n, inner, itemsize, mode)
        assert p.tiles == 2 * p.lane_groups * p.tiles_n > 0
        assert p.launches == (1 if n <= p.tile else 1 + int(np.ceil(np.log2(np.ceil(n / p.tile)))))
        assert max(p.tile_smem, p.merge_smem) <= _geometry.SORT_SMEM_TARGET <= _geometry.SORT_SMEM_LIMIT
        if mode == "values" or n <= 4 * t:  # the walks of the other modes differ only in their tiles
            _check_sort_walk(p)


@pytest.mark.parametrize("n_at", ["1", "T-1", "T", "T+1", "3T+5"])
def test_sort_plan_walks_wide_blocks_lane_group_by_lane_group(n_at):
    """inner 65536 (a (512, 256, 256) block along axis 0): the walk of the
    first and the last lane groups."""
    inner = 65536
    t = _tile(inner, 8)
    n = {"1": 1, "T-1": t - 1, "T": t, "T+1": t + 1, "3T+5": 3 * t + 5}[n_at]
    p = _geometry.sort_plan(1, n, inner, 8, "values")
    assert p.lanes == 16 and p.lane_groups == inner // 16
    _check_sort_walk(p, _walk_items(p, [0, p.lane_groups - 1]))


def test_sort_plan_main_path_blocks_take_one_launch():
    """The order-statistics phase's blocks: sort and top-k (512, 256, 256),
    the argsort network's shrunk chunk (171, 256, 256), float64 along axis
    0: one launch of 4096 tiles of 512 (256) x 16 lanes, 64 KB of values;
    16384 steps in one chunk: the tile sort and five merge passes."""
    for mode in ("values", "argsort"):
        p = _geometry.sort_plan(1, 512, 65536, 8, mode)
        assert (p.tile, p.lanes, p.tiles, p.launches, p.widths) == (512, 16, 4096, 1, ())
        assert p.tile_smem == 16 * 513 * 8 + 2 * _geometry._round16(16 * 514 * 2)
    p = _geometry.sort_plan(1, 171, 65536, 8, "pairs")
    assert (p.tile, p.lanes, p.launches) == (256, 16, 1)
    p = _geometry.sort_plan(1, 16384, 256, 8, "values")
    assert (p.tile, p.lanes, p.launches, p.widths) == (512, 16, 6, (512, 1024, 2048, 4096, 8192))


@pytest.mark.parametrize("itemsize", SORT_ITEMSIZES)
def test_sort_plan_shared_memory_fits_every_dtype_and_mode(itemsize):
    for mode in _geometry.SORT_MODES:
        for inner in (1, 2, 7, 16, 33, 65536):
            for n in (1, 8, 100, 4096, 1 << 20):
                p = _geometry.sort_plan(3, n, inner, itemsize, mode)
                assert p.tile >= _geometry.SORT_ITEMS and p.tile & (p.tile - 1) == 0
                assert p.lanes & (p.lanes - 1) == 0 and p.lanes <= 32
                # rows of 128 bytes, or of every lane there is
                assert p.lanes * itemsize >= min(128, 32 * itemsize) or p.lanes >= inner
                assert p.tile_smem <= _geometry.SORT_SMEM_LIMIT and p.merge_smem <= _geometry.SORT_SMEM_LIMIT
                assert p.smem <= _geometry.SORT_SMEM_TARGET
                assert p.tile < 2 * max(n, _geometry.SORT_ITEMS) or p.smem > _geometry.SORT_SMEM_TARGET // 2


@pytest.mark.parametrize("itemsize", SORT_ITEMSIZES)
def test_sort_plan_regions_are_aligned_and_disjoint(itemsize):
    """The offsets the kernels take (``SORT_REGIONS``): each region 16-byte
    aligned, after the one before it, and every region a kernel uses (its
    elements as csrc/merge_sort.cu indexes them) within its shared memory."""
    for mode, code in _geometry.SORT_MODES.items():
        for inner, n in ((1, 100), (7, 5000), (65536, 512), (256, 16384)):
            p = _geometry.sort_plan(1, n, inner, itemsize, mode)
            rows = p.lanes * (p.tile + 1)
            order = p.lanes * (p.tile + 2) * 2
            idx = rows * 8 if code == 1 else 0
            kernels = [("tile", p.tile_regions, p.tile_smem)]
            if p.widths:
                kernels.append(("merge", p.merge_regions, p.merge_smem))
            for kernel, regions, smem in kernels:
                r = dict(zip(_geometry.SORT_REGIONS, regions))
                assert all(v % 16 == 0 for v in regions) and smem % 16 == 0
                assert idx <= r["vals"] and r["vals"] + rows * itemsize <= r["pos"] <= r["ord0"]
                if kernel == "tile":
                    assert r["ord0"] + order <= r["ord1"] and r["ord1"] + order <= smem
                else:
                    assert r["pos"] + (p.lanes * p.tile * 4 if code == 2 else 0) <= r["ord0"] == r["ord1"]
                    assert r["ord0"] + order <= r["splits"] and r["splits"] + 2 * p.lanes * 8 <= smem


def test_sort_plan_vector_loads_need_a_contiguous_aligned_lane():
    assert _geometry.sort_plan(4, 1000, 1, 4, "values", 4096).vector == 4
    assert _geometry.sort_plan(2, 20000, 1, 2, "values", 4096).vector == 8
    assert _geometry.sort_plan(4, 1000, 1, 4, "values", 4104).vector == 1  # the base not 16-byte aligned
    assert _geometry.sort_plan(4, 1001, 1, 4, "values", 4096).vector == 1  # a lane's start not aligned
    assert _geometry.sort_plan(1, 1001, 1, 4, "values", 4096).vector == 4  # one lane: its start is the base
    assert _geometry.sort_plan(4, 1000, 2, 4, "values", 4096).vector == 1  # lanes not contiguous


def test_sort_plan_of_a_vmapped_batch_and_of_nothing():
    """A vmapped call's batch axes lead the lanes: outer grows, one launch
    set sorts every example; an empty block plans no launch."""
    one = _geometry.sort_plan(1, 171, 4096, 8, "argsort")
    batch = _geometry.sort_plan(5, 171, 4096, 8, "argsort")
    assert batch.tiles == 5 * one.tiles and batch.launches == one.launches == 1
    _check_sort_walk(_geometry.sort_plan(5, 37, 9, 8, "argsort"))
    for shape in ((0, 5, 3), (4, 0, 3), (4, 5, 0)):
        p = _geometry.sort_plan(*shape, 8, "values")
        assert p.tiles == 0 and p.launches == 0 and _geometry.sort_walk(torch, p) == []


def test_sort_plan_segments_compose_to_the_jax_packages_sort(monkeypatch):
    """Sorting each tile of the walk, then each pass's pair of runs, with the
    JAX package's ``nxp.sort`` gives its sort of the whole lane, and the
    port's ``sort_block`` on the CPU: the tiles and pairs cover the lanes as
    a merge sort must (tiles forced small: several passes)."""
    monkeypatch.setattr(_geometry, "SORT_SMEM_TARGET", 2000)
    from cubed_tpu_torch.kernels import merge_sort as ms

    rng = np.random.default_rng(7)
    shape = (3, 150, 5)
    a = rng.integers(0, 20, shape).astype(np.float64)
    a[rng.random(shape) < 0.1] = np.nan
    p = _geometry.sort_plan(*shape, 8, "values")
    assert len(p.widths) >= 2
    flat = a.reshape(-1).copy()
    for offsets, _, starts, _ in _geometry.sort_walk(torch, p):
        lane = (offsets // (shape[1] * shape[2])) * shape[2] + offsets % shape[2]
        keys = np.stack([lane.numpy(), starts.numpy()])
        for key in np.unique(keys, axis=1).T:
            sel = np.sort(offsets.numpy()[(keys[0] == key[0]) & (keys[1] == key[1])])
            flat[sel] = np.asarray(nxp.sort(nxp.asarray(flat[sel])))
    want = np.asarray(nxp.sort(nxp.asarray(a), axis=1))
    np.testing.assert_array_equal(flat.reshape(shape), want)
    np.testing.assert_array_equal(ms.sort_block(torch.from_numpy(a), 1).numpy(), want)


def test_sort_plan_refuses_what_the_kernels_cannot_index():
    with pytest.raises(ValueError, match="32 bits"):
        _geometry.sort_plan(1, 2**31, 1, 1, "values")
    with pytest.raises(ValueError, match="mode"):
        _geometry.sort_plan(1, 8, 1, 8, "descending")


@pytest.mark.parametrize("itemsize", SORT_ITEMSIZES)
@pytest.mark.parametrize("inner", [1, 7, 65536])
def test_sort_plan_launches_one_tile_sort_then_a_pass_a_doubling(itemsize, inner):
    t = _tile(inner, itemsize)
    for n in (1, t - 1, t, t + 1, 3 * t + 5, 16384):
        for mode in _geometry.SORT_MODES:
            p = _geometry.sort_plan(1, n, inner, itemsize, mode)
            assert p.launches == (1 if n <= p.tile else 1 + int(np.ceil(np.log2(np.ceil(n / p.tile)))))
            assert p.widths == tuple(p.tile << k for k in range(p.launches - 1))
            assert p.smem <= _geometry.SORT_SMEM_LIMIT


# ---------------------------------------------------------------------------
# merge_split: a tiled merge-path pass over a pair of sorted blocks
# ---------------------------------------------------------------------------


def _split_tile(inner, itemsize, mode="values"):
    return _geometry.split_plan(1, 1 << 20, inner, itemsize, mode).tile


def _check_split_walk(p, take_low):
    """Replay *p*: every output element written exactly once; each work item
    owns at most ``tile`` positions of at most ``lanes`` lanes of one outer
    index, merging the same merged range for each of its lanes: the kept
    half's positions ``[d0, d0 + tn)``, ``d0`` its first output plus ``n``
    for the high half."""
    offsets, item, start, end = _geometry.split_walk(torch, p, take_low)
    outer, n, inner = p.outer, p.n, p.inner
    assert torch.equal(torch.sort(offsets).values, torch.arange(outer * n * inner))
    o = offsets // (n * inner)
    pos = offsets // inner % n
    low = torch.as_tensor(take_low).reshape(-1)[o]
    merged = pos + torch.where(low, 0, n)
    assert bool(((start <= merged) & (merged < end)).all())
    assert bool((end - start <= p.tile).all()) and bool(((start - torch.where(low, 0, n)) % p.tile == 0).all())
    # one range and one outer index a work item, its lanes neighbours
    for t in (start, end, o, torch.div(offsets % inner, p.lanes, rounding_mode="floor")):
        per_item = torch.unique(torch.stack([item, t]), dim=1)
        assert per_item.shape[1] == torch.unique(item).numel()
    assert item.max() < p.tiles


@pytest.mark.parametrize("itemsize", SORT_ITEMSIZES)
@pytest.mark.parametrize("inner", [1, 3, 20])
@pytest.mark.parametrize("n_at", ["1", "T-1", "T", "T+1", "3T+5"])
def test_split_plan_walks_every_output_once_for_either_half(itemsize, inner, n_at, monkeypatch):
    """Lanes within a tile and past it (the tile forced small so the walk
    stays short), ``inner`` of 1, below ``lanes`` and not a multiple of it;
    each lane group keeping the low or the high half."""
    monkeypatch.setattr(_geometry, "SPLIT_SMEM_TARGET", 6000)
    t = _split_tile(inner, itemsize)
    n = {"1": 1, "T-1": t - 1, "T": t, "T+1": t + 1, "3T+5": 3 * t + 5}[n_at]
    for mode in _geometry.SPLIT_MODES:
        p = _geometry.split_plan(4, n, inner, itemsize, mode)
        assert p.tiles == 4 * p.lane_groups * p.tiles_n > 0 and p.launches == 1
        assert p.tiles_n == -(-n // p.tile)
        _check_split_walk(p, torch.tensor([True, False, False, True]))


def test_split_plan_main_path_pairs_take_one_launch():
    """The order-statistics phase's rounds, float64 along axis 0: sort's
    (512, 256, 256) pair is 8192 items of 256 x 16 lanes (two along each
    lane group's kept half, four CTAs an SM); argsort's (171, 256, 256)
    pairs with indices 8192 items of 128 x 16; a vmapped batch of 4 pairs is
    one launch of 4x the items."""
    p = _geometry.split_plan(1, 512, 65536, 8, "values")
    assert (p.tile, p.lanes, p.sector, p.tiles_n, p.tiles, p.launches) == (256, 16, 4, 2, 8192, 1)
    assert 4 * p.smem <= 233472 - 4 * 1024
    p = _geometry.split_plan(1, 171, 65536, 8, "pairs")
    assert (p.tile, p.lanes, p.sector, p.tiles_n, p.tiles, p.launches) == (128, 16, 4, 2, 8192, 1)
    assert 4 * p.smem <= 233472 - 4 * 1024
    batch = _geometry.split_plan(4, 512, 65536, 8, "values")
    assert batch.tiles == 4 * 8192 and batch.launches == 1
    offsets, item, start, end = _geometry.split_walk(torch, _geometry.split_plan(4, 5, 33, 8, "values"),
                                                     torch.tensor([True, False, True, False]))
    assert torch.equal(torch.sort(offsets).values, torch.arange(4 * 5 * 33))
    assert torch.equal(torch.unique(start), torch.tensor([0, 5]))


@pytest.mark.parametrize("itemsize", SORT_ITEMSIZES)
def test_split_plan_shared_memory_fits_every_dtype_and_mode(itemsize):
    for mode in _geometry.SPLIT_MODES:
        for inner in (1, 2, 7, 16, 33, 65536):
            for n in (1, 8, 100, 171, 512, 4096, 1 << 20):
                p = _geometry.split_plan(3, n, inner, itemsize, mode)
                assert p.tile >= _geometry.SORT_ITEMS and p.tile & (p.tile - 1) == 0
                assert p.lanes & (p.lanes - 1) == 0 and p.lanes <= 32
                assert p.lanes * itemsize >= min(128, 32 * itemsize) or p.lanes >= inner
                # a sector group: a power of two of lanes, 32 bytes of a row or every lane
                assert p.sector & (p.sector - 1) == 0 and p.lanes % p.sector == 0
                assert p.sector * itemsize == min(32, p.lanes * itemsize) or p.sector == p.lanes
                assert p.smem <= _geometry.SPLIT_SMEM_TARGET <= _geometry.SORT_SMEM_LIMIT
                # the largest tile that fits, up to what the lane needs
                assert p.tile >= n or _geometry.split_layout(2 * p.tile, p.lanes, p.sector, itemsize,
                                                             p.mode)[1] > _geometry.SPLIT_SMEM_TARGET
                assert p.tile < 2 * max(n, _geometry.SORT_ITEMS)


@pytest.mark.parametrize("itemsize", SORT_ITEMSIZES)
def test_split_plan_regions_are_aligned_and_disjoint(itemsize):
    """The offsets the kernel takes (``SORT_REGIONS``): the carried indices
    at 0, then the values, each lane's two splits, four int32 a sector group
    and the CTA's loads, each 16-byte aligned and within the CTA's shared
    memory."""
    for mode, code in _geometry.SPLIT_MODES.items():
        for inner, n in ((1, 100), (7, 5000), (20, 171), (65536, 512), (65536, 171)):
            p = _geometry.split_plan(1, n, inner, itemsize, mode)
            r = dict(zip(_geometry.SORT_REGIONS, p.regions))
            rows = p.lanes * (p.tile + 1)
            assert all(v % 16 == 0 for v in p.regions) and p.smem % 16 == 0
            assert (rows * 8 if code == 1 else 0) <= r["vals"]
            assert r["vals"] + rows * itemsize <= r["splits"] == r["pos"] == r["ord0"] == r["ord1"]
            assert p.lanes // p.sector <= _geometry.SPLIT_MAX_GROUPS
            assert r["splits"] + 2 * p.lanes * 8 + (4 * _geometry.SPLIT_MAX_GROUPS + 1) * 4 <= p.smem


def test_split_plan_segments_compose_to_the_jax_packages_round(monkeypatch):
    """Each walked segment filled from the JAX package's sort of the
    concatenated pair (``_block_sort.py:220``; with indices its
    ``_pair_order``) gives the package's round, low half or high by lane
    group, and the port's ``merge_split`` on the CPU: tiles forced small,
    so a kept half spans several work items."""
    monkeypatch.setattr(_geometry, "SPLIT_SMEM_TARGET", 3000)
    from cubed_tpu.array_api._block_sort import _pair_order
    from cubed_tpu_torch.kernels import merge_sort as ms

    rng = np.random.default_rng(11)
    shape, axis = (4, 150, 5), 1
    n = shape[axis]

    def sorted_block(seed_shift):
        a = rng.integers(0, 20, shape).astype(np.float64)
        a[rng.random(shape) < 0.1] = np.nan
        a[rng.random(shape) < 0.05] = -0.0
        i = rng.permutation(a.size).reshape(shape) + seed_shift
        order = np.asarray(_pair_order(nxp.asarray(a), nxp.asarray(i), axis))
        return np.take_along_axis(a, order, axis), np.take_along_axis(i, order, axis)

    (x, xi), (y, yi) = sorted_block(0), sorted_block(10**6)
    low = np.array([True, False, False, True])
    for pairs in (False, True):
        mv, mi = np.concatenate([x, y], axis), np.concatenate([xi, yi], axis)
        if pairs:
            order = np.asarray(_pair_order(nxp.asarray(mv), nxp.asarray(mi), axis))
            merged, merged_i = np.take_along_axis(mv, order, axis), np.take_along_axis(mi, order, axis)
        else:
            merged, merged_i = np.asarray(nxp.sort(nxp.asarray(mv), axis=axis)), None
        want = np.where(low[:, None, None], merged[:, :n], merged[:, n:])
        p = _geometry.split_plan(4, n, 5, 8, "pairs" if pairs else "values")
        assert p.tiles_n >= 3
        offsets, item, start, end = _geometry.split_walk(torch, p, torch.from_numpy(low))
        got = np.full(x.size, -1.0)
        lane = (offsets // (n * 5)) * 5 + offsets % 5
        keys = np.stack([lane.numpy(), start.numpy()])
        flat_merged = merged.transpose(0, 2, 1).reshape(-1, 2 * n)  # lanes (o * inner + l) of 2n
        for key in np.unique(keys, axis=1).T:
            sel = np.sort(offsets.numpy()[(keys[0] == key[0]) & (keys[1] == key[1])])
            got[sel] = flat_merged[key[0], key[1]:key[1] + sel.size]
        np.testing.assert_array_equal(got.reshape(shape), want)
        tl = torch.from_numpy(low)[:, None, None]
        if pairs:
            mine = ms.merge_split(*(torch.from_numpy(t) for t in (x, y)), tl, axis, torch.from_numpy(xi),
                                  torch.from_numpy(yi))
            np.testing.assert_array_equal(mine[0].numpy(), want)
            np.testing.assert_array_equal(mine[1].numpy(), np.where(low[:, None, None], merged_i[:, :n],
                                                                   merged_i[:, n:]))
        else:
            np.testing.assert_array_equal(ms.merge_split(torch.from_numpy(x), torch.from_numpy(y), tl, axis).numpy(),
                                          want)


def test_split_plan_refuses_what_the_kernel_cannot_index():
    with pytest.raises(ValueError, match="32 bits"):
        _geometry.split_plan(1, 2**31, 1, 1, "values")
    with pytest.raises(ValueError, match="mode"):
        _geometry.split_plan(1, 8, 1, 8, "argsort")
    for shape in ((0, 5, 3), (4, 0, 3), (4, 5, 0)):
        p = _geometry.split_plan(*shape, 8, "values")
        assert p.tiles == 0 and p.launches == 0
        assert all(t.numel() == 0 for t in _geometry.split_walk(torch, p, torch.ones(max(1, shape[0]),
                                                                                      dtype=torch.bool)))


def _order_key(v) -> tuple:
    """The kernels' order key (``Order<T>::key``): NaN after every number,
    all NaNs equal, -0.0 equal to 0.0."""
    v = float(v)
    return (1, 0.0) if v != v else (0, v + 0.0)


def _split_kernel_model(x, y, xi, yi, flags, p, threads=256):
    """merge_split_kernel (csrc/merge_sort.cu) replayed work item by work
    item: the merge-path split searches (all the CTA's threads over the ends
    not known, ``probes`` places a round, the ballot's prefix taken), each
    sector group's rows and where its loads start, the loads into each
    lane's shared-memory segments (every slot filled once), and the merge
    of the segments by (key, [index,] place). Returns (out, out indices, the
    elements the loads cover: each group's rows times its lanes, the
    sectors asked of device memory)."""
    n, inner, tile, lanes, sector = p.n, p.inner, p.tile, p.lanes, p.sector
    lane_shift, sector_shift = lanes.bit_length() - 1, sector.bit_length() - 1
    groups = lanes >> sector_shift
    xf, yf = x.reshape(-1), y.reshape(-1)
    pairs = xi is not None
    xif, yif = (xi.reshape(-1), yi.reshape(-1)) if pairs else (None, None)
    out, outi = np.zeros_like(xf), np.zeros(xf.shape, dtype=np.int64)
    written = np.zeros(xf.shape, dtype=bool)
    covered = 0
    for b in range(p.tiles):
        kt, rest = b % p.tiles_n, b // p.tiles_n
        lg, o = rest % p.lane_groups, rest // p.lane_groups
        k0, l0 = kt * tile, lg * lanes
        tn, cn = min(tile, n - k0), min(lanes, inner - l0)
        d0 = (0 if flags[o] else n) + k0
        base = o * n * inner + l0
        splits = [0] * (2 * lanes)
        skip = int(d0 == 0)
        ends = 2 - skip - int(d0 + tn == 2 * n)
        probes = min(32, threads >> (lane_shift + ends - 1))
        if skip + ends < 2:
            splits[lanes:] = [n] * lanes
        for search in range(ends * lanes):
            c, which = search & (lanes - 1), skip + (search >> lane_shift)
            d = d0 + (tn if which else 0)
            lo, hi = (max(0, d - n), min(d, n)) if c < cn else (0, 0)
            while lo < hi:
                span = hi - lo
                first = []
                for me in range(probes):
                    m = lo + span * (me + 1) // (probes + 1)
                    px, py = base + m * inner + c, base + (d - 1 - m) * inner + c
                    xk, yk = _order_key(xf[px]), _order_key(yf[py])
                    first.append(not (yk < xk or (pairs and yk == xk and yif[py] < xif[px])))
                t = sum(first)
                assert first == [True] * t + [False] * (probes - t)  # a prefix: the ballot's count
                lo, hi = (lo + span * t // (probes + 1) + 1 if t else lo,
                          lo + span * (t + 1) // (probes + 1) if t < probes else hi)
            splits[which * lanes + c] = lo
        rows, start = [], 0
        for g in range(groups):
            cs = range(g << sector_shift, min(cn, (g + 1) << sector_shift))
            if len(cs):
                i0s, i1s = [splits[c] for c in cs], [splits[lanes + c] for c in cs]
                nrx, nry = max(i1s) - min(i0s), tn + max(i0s) - min(i1s)
                rows.append((min(i0s), nrx, d0 - max(i0s), start))
                covered += (nrx + nry) * len(cs)
            else:
                nrx = nry = 0
                rows.append((0, 0, 0, start))
            start += (nrx + nry) << sector_shift
        seg_v, seg_i = [None] * (lanes * (tile + 1)), [None] * (lanes * (tile + 1))
        for e in range(start):
            g = sum(1 for k in range(1, groups) if e >= rows[k][3])
            r = e - rows[g][3]
            c = (g << sector_shift) + (r & (sector - 1))
            r >>= sector_shift
            if c >= cn:
                continue
            i0, i1 = splits[c], splits[lanes + c]
            in_x = r < rows[g][1]
            q = rows[g][0] + r if in_x else rows[g][2] + r - rows[g][1]
            s0, s1 = (i0, i1) if in_x else (d0 - i0, d0 + tn - i1)
            assert 0 <= q < n
            if s0 <= q < s1:
                slot = c * (tile + 1) + q - s0 + (0 if in_x else i1 - i0)
                assert seg_v[slot] is None
                gi = base + q * inner + c
                seg_v[slot] = xf[gi] if in_x else yf[gi]
                seg_i[slot] = (xif[gi] if in_x else yif[gi]) if pairs else 0
        for c in range(cn):
            lane = range(c * (tile + 1), c * (tile + 1) + tn)
            assert all(seg_v[s] is not None for s in lane)
            order = sorted(lane, key=lambda s: (_order_key(seg_v[s]), seg_i[s], s))
            for k, s in enumerate(order):
                g = base + (k0 + k) * inner + c
                assert not written[g]
                written[g] = True
                out[g], outi[g] = seg_v[s], seg_i[s]
    assert written.all()
    return out.reshape(x.shape), outi.reshape(x.shape), covered


def _split_model_pair(shape, axis, dtype, pairs, seed):
    from cubed_tpu_torch.kernels import merge_sort as ms

    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(2):
        if np.dtype(dtype).kind == "f":
            a = (rng.integers(0, 7, shape) * 0.5).astype(dtype)
            a[rng.random(shape) < 0.1] = np.nan
            a[rng.random(shape) < 0.05] = -0.0
        else:
            a = rng.integers(-3, 4, shape).astype(dtype)
        i = torch.from_numpy(rng.integers(0, 4, shape))
        t = torch.from_numpy(a)
        blocks.append(ms.sort_block_plain(t, axis, i) if pairs else (ms.sort_block_plain(t, axis), None))
    return blocks


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("shape, axis, dtype", [((37, 5, 3), 0, np.float64), ((6, 4, 65), 2, np.float64),
                                                ((33, 70), 0, np.float32), ((41, 9), 0, np.int64),
                                                ((5, 130), 1, np.uint8), ((1, 4), 0, np.float64),
                                                ((3, 50, 40), 1, np.float64), ((70, 20), 0, np.int8),
                                                ((2, 77), 1, np.float32)])
def test_split_kernel_model_equals_the_plain_merge_split(shape, axis, dtype, pairs, monkeypatch):
    """The kernel's algorithm replayed in Python over the plan's work items
    (tiles forced small for the wider cases, so lanes span several items,
    each with its own searches) equals merge_split_plain bit for bit, each
    lane group keeping its own half: NaN, -0.0 and ties (of (value, index)
    with pairs) included; every shared-memory slot filled once."""
    from cubed_tpu_torch.kernels import merge_sort as ms

    if shape[axis] >= 40:
        monkeypatch.setattr(_geometry, "SPLIT_SMEM_TARGET", 2500)
    (x, xi), (y, yi) = _split_model_pair(shape, axis, dtype, pairs, seed=sum(shape))
    outer, n, inner = int(np.prod(shape[:axis])), shape[axis], int(np.prod(shape[axis + 1:]))
    p = _geometry.split_plan(outer, n, inner, np.dtype(dtype).itemsize, "pairs" if pairs else "values")
    flags = torch.from_numpy(np.random.default_rng(n).random(shape[:axis] + (1,) * (len(shape) - axis)) < 0.5)
    for f in (flags, ~flags):
        low = ms._flags(f, shape, axis)[0].numpy()
        got, goti, _ = _split_kernel_model(x.numpy(), y.numpy(), xi.numpy() if pairs else None,
                                           yi.numpy() if pairs else None, low, p)
        want = ms.merge_split_plain(x, y, f, axis, xi, yi)
        want, wanti = want if pairs else (want, None)
        assert got.tobytes() == want.numpy().tobytes()
        if pairs:
            np.testing.assert_array_equal(goti, wanti.numpy())


def test_split_kernel_model_reads_little_past_the_kept_half():
    """On uniform random lanes (512 of 64 float64, argsort's 171 with
    indices) the sector groups' unions of rows cover at most 20% past the
    kept half's n elements a lane, either half (the spread of the splits
    within a sector: about 10% at the plan's tiles, two along a lane)."""
    rng = np.random.default_rng(0)
    for n, pairs in ((512, False), (171, True)):
        x, y = (np.sort(rng.random((n, 64)), axis=0) for _ in range(2))
        xi = rng.permutation(n * 64).reshape(n, 64) if pairs else None
        yi = xi + n * 64 if pairs else None
        p = _geometry.split_plan(1, n, 64, 8, "pairs" if pairs else "values")
        for low in (True, False):
            _, _, covered = _split_kernel_model(x, y, xi, yi, np.array([low]), p)
            assert n * 64 <= covered <= 1.2 * n * 64
