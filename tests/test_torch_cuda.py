"""The port's CUDA kernels and main path on the card (skipped without one:
a CUDA kernel has no CPU mode). Run on a GPU machine without JAX with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest`` because tests/conftest.py imports JAX).
"""

import random

import numpy as np
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(100, 100, 100), (99, 100, 100), (7,)])
def test_philox_kernel_bit_exact(cuda, shape):
    import torch

    from cubed_tpu_torch.kernels.philox_uniform import philox_key, philox_uniform

    before = philox_uniform.launches
    out = philox_uniform(torch.empty(shape, dtype=torch.float64, device=cuda), philox_key(31))
    ref = np.random.Generator(np.random.Philox(seed=31)).random(shape)
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint64), ref.view(np.uint64))
    assert philox_uniform.launches == before + 1


#: (shape, chunks) of the batched Philox kernel: the main path's array,
#: ragged edges, a last extent not a multiple of 4, 1-D, size 0, full blocks
#: on 16-byte stores beside a scalar edge, 4-D
PHILOX_BLOCK_CASES = [
    ((500, 450, 400), (100, 100, 100)),
    ((13, 11), (4, 5)),
    ((7,), (3,)),
    ((0, 5), (2, 2)),
    ((8, 14), (4, 8)),
    ((50, 45, 40), (10, 10, 20)),
    ((2, 3, 4, 5), (1, 2, 3, 4)),
]


def _numpy_blocks(shape, chunks, seeds) -> np.ndarray:
    """numpy's per-block streams, assembled: block k (C order) draws from
    Philox(seed=seeds[k])."""
    from cubed_tpu_torch.chunks import blockdims_from_blockshape

    out = np.empty(shape, dtype=np.float64)
    chunkset = blockdims_from_blockshape(shape, chunks)
    for k, idx in enumerate(np.ndindex(*[len(c) for c in chunkset])):
        sel = tuple(slice(sum(c[:i]), sum(c[:i + 1])) for c, i in zip(chunkset, idx))
        out[sel] = np.random.Generator(np.random.Philox(seed=int(seeds[k]))).random(out[sel].shape)
    return out


@pytest.mark.parametrize("shape, chunks", PHILOX_BLOCK_CASES,
                         ids=["x".join(map(str, s)) for s, _ in PHILOX_BLOCK_CASES])
def test_philox_blocks_kernel_bit_exact(cuda, shape, chunks):
    import torch

    from cubed_tpu_torch.kernels.philox_uniform import (
        philox_keys, philox_uniform, philox_uniform_blocks, philox_uniform_blocks_plain,
    )

    nblocks = int(np.prod([-(-s // c) if s else 1 for s, c in zip(shape, chunks)]))
    seeds = 2**30 - 3 + np.arange(nblocks, dtype=np.int64)
    keys = philox_keys(seeds)
    before = philox_uniform.launches
    got = philox_uniform_blocks(torch.empty(shape, dtype=torch.float64, device=cuda), chunks, keys)
    assert philox_uniform.launches == before + (1 if got.numel() else 0)
    again = philox_uniform_blocks(torch.empty(shape, dtype=torch.float64, device=cuda), chunks, keys)
    assert torch.equal(got, again)
    assert torch.equal(got, philox_uniform_blocks_plain(shape, chunks, keys, device=cuda))
    ref = _numpy_blocks(shape, chunks, seeds)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64), ref.view(np.uint64))


@pytest.mark.parametrize("shape", [(100, 100, 100), (13, 11), (7,)])
def test_philox_blocks_kernel_on_one_block_matches_the_per_block_kernel(cuda, shape):
    """A grid of one block (as chip_smoke.py times it beside the per-block
    kernel): the same stream as the per-block kernel's."""
    import torch

    from cubed_tpu_torch.kernels.philox_uniform import philox_keys, philox_uniform, philox_uniform_blocks

    keys = philox_keys([2**32 + 5])
    got = philox_uniform_blocks(torch.empty(shape, dtype=torch.float64, device=cuda), shape, keys)
    block = philox_uniform(torch.empty(shape, dtype=torch.float64, device=cuda), tuple(int(k) for k in keys[0]))
    assert torch.equal(got, block)
    ref = np.random.Generator(np.random.Philox(seed=2**32 + 5)).random(shape)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64), ref.view(np.uint64))


@pytest.mark.parametrize("layout", ["column-view", "misaligned"])
def test_philox_blocks_kernel_writes_strided_outputs_in_place(cuda, layout):
    import torch

    from cubed_tpu_torch.kernels.philox_uniform import philox_keys, philox_uniform, philox_uniform_blocks

    shape, chunks = (64, 48), (16, 16)
    if layout == "column-view":
        base = torch.full((64, 80), -1.0, dtype=torch.float64, device=cuda)
        out = base[:, 16:64]
    else:
        base = torch.full((64 * 48 + 1,), -1.0, dtype=torch.float64, device=cuda)
        out = base[1:].view(shape)
    seeds = 77 + np.arange(12, dtype=np.int64)
    before = dict(philox_uniform.paths)
    philox_uniform_blocks(out, chunks, philox_keys(seeds))
    taken = {k for k, v in philox_uniform.paths.items() if v > before[k]}
    assert taken == {"batched", "vector" if layout == "column-view" else "scalar"}
    ref = _numpy_blocks(shape, chunks, seeds)
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint64), ref.view(np.uint64))
    if layout == "column-view":  # the columns outside the view stay as they were
        assert bool((base[:, :16] == -1.0).all()) and bool((base[:, 64:] == -1.0).all())
    else:
        assert float(base[0]) == -1.0


def test_random_on_device_executor_is_one_launch_per_op(cuda, tmp_path):
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.kernels.philox_uniform import philox_uniform
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    random.seed(5)
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a, b, x, y = [ct.random.random((50, 45, 40), chunks=10, spec=spec) for _ in range(4)]
    ex = CudaExecutor()
    before, paths = philox_uniform.launches, dict(philox_uniform.paths)
    got = float(xp.mean(a[1:] * x[1:] + b[1:] * y[1:]).compute(executor=ex))
    assert philox_uniform.launches == before + 4
    assert philox_uniform.paths["batched"] == paths["batched"] + 4
    assert philox_uniform.paths["block"] == paths["block"]
    # the four random ops and the fused reduction (fma_sum_blocks)
    assert ex.stats["batched_ops"] == 5 and ex.stats["eager_fallbacks"] == 0
    random.seed(5)
    a, b, x, y = [ct.random.random((50, 45, 40), chunks=10, spec=spec) for _ in range(4)]
    np.testing.assert_allclose(got, float(xp.mean(a[1:] * x[1:] + b[1:] * y[1:]).compute()), rtol=1e-12)


@pytest.mark.parametrize("axis", [None, (0,), (1, 2)])
@pytest.mark.parametrize("dtype", ["float64", "float32", "int64"])
def test_region_sum_kernel_matches_plain(cuda, dtype, axis):
    import torch

    from cubed_tpu_torch.kernels.region_sum import region_sum, region_sum_plain

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(5)
    if dt == torch.int64:
        x = torch.randint(-(10**12), 10**12, (99, 37, 101), generator=g, device=cuda)
    else:
        x = torch.rand((99, 37, 101), generator=g, device=cuda, dtype=torch.float64).to(dt)
    got = region_sum(x, axis)
    assert torch.equal(got, region_sum(x, axis))
    plain = region_sum_plain(x, axis)
    if dt == torch.int64:
        assert torch.equal(got, plain)
    else:
        rtol = 1e-12 if dt == torch.float64 else 1e-6
        torch.testing.assert_close(got, plain, rtol=rtol, atol=0)


def test_vorticity_on_card_matches_cpu(cuda, tmp_path):
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch import backend_array_api

    def run(device):
        backend_array_api.set_device(device)
        try:
            random.seed(3)
            spec = ct.Spec(work_dir=str(tmp_path / device), allowed_mem="500MB")
            a, b, x, y = [ct.random.random((50, 45, 40), chunks=10, spec=spec) for _ in range(4)]
            return float(xp.mean(a[1:] * x[1:] + b[1:] * y[1:]).compute())
        finally:
            backend_array_api.set_device(None)

    np.testing.assert_allclose(run("cuda"), run("cpu"), rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("view", [False, True], ids=["contiguous", "block-view"])
def test_fma_sum_kernel_matches_plain(cuda, dtype, view):
    import torch

    from cubed_tpu_torch.kernels.fma_sum import fma_sum, fma_sum_blocks, fma_sum_plain

    g = torch.Generator(device=cuda).manual_seed(9)
    shape = (199, 150, 120) if view else (99, 100, 50)
    ts = [torch.rand(shape, generator=g, device=cuda, dtype=torch.float64).to(getattr(torch, dtype))
          for _ in range(4)]
    if view:  # a ragged block of a resident array, as the device executor passes it
        ts = [t[100:199, 50:150, 70:120] for t in ts]
    before = fma_sum_blocks.launches
    got = fma_sum(*ts)
    assert fma_sum_blocks.launches == before + 1
    assert torch.equal(got, fma_sum(*ts))
    a, x, b, y = ts
    scale = float((a * x).double().abs().sum() + (b * y).double().abs().sum())
    assert got.shape == (1, 1, 1) and got.dtype == torch.float64
    assert float((got - fma_sum_plain(*ts)).abs().max()) <= 1e-12 * scale


def test_vorticity_on_device_executor_matches_sequential(cuda, tmp_path):
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.kernels.fma_sum import fma_sum_blocks
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    def run(executor):
        random.seed(4)
        spec = ct.Spec(work_dir=str(tmp_path / type(executor).__name__), allowed_mem="500MB")
        a, b, x, y = [ct.random.random((50, 45, 40), chunks=10, spec=spec) for _ in range(4)]
        return float(xp.mean(a[1:] * x[1:] + b[1:] * y[1:]).compute(executor=executor))

    ex = CudaExecutor()
    before = fma_sum_blocks.launches
    got = run(ex)
    # every block of the fused reduction in one launch, none block by block
    assert fma_sum_blocks.launches == before + 1
    assert ex.stats["eager_fallbacks"] == 0
    np.testing.assert_allclose(got, run(None), rtol=1e-12)


# the reduction kernels on the cases their geometry is planned for (see
# tests/test_torch_kernel_geometry.py): views of a (499, 450, 400) array as
# the device executor passes them, contiguous blocks, combine-sized inputs,
# sizes 0 and 1


@pytest.fixture(scope="module")
def bases():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(11)
    f64 = torch.rand((499, 450, 400), generator=g, device="cuda", dtype=torch.float64) * 100 - 50
    return {
        "float64": f64,
        "float32": f64.to(torch.float32),
        "int64": torch.randint(-(10**12), 10**12, (499, 450, 400), generator=g, device="cuda"),
    }


# name: (input from the base of its dtype, reduced axes)
REGION_CASES = {
    "main-path-view": (lambda b: b[100:200, 200:300, 0:100], None),
    "main-path-view-misaligned": (lambda b: b[100:200, 200:300, 1:101], None),
    "ragged-view": (lambda b: b[400:499, 400:450, 300:400], None),
    "contiguous-block": (lambda b: b[:100, :100, :100].contiguous(), None),
    "strided-view-axis0": (lambda b: b[100:200, 200:300, 0:100], (0,)),
    "strided-view-axes12": (lambda b: b[100:200, 200:300, 0:100], (1, 2)),
    "combine-sized": (lambda b: b[:5, :5, :4].contiguous(), None),
    "combine-axis0": (lambda b: b[:5, :5, :4].contiguous(), (0,)),
    "size0": (lambda b: b[:0, :5, 0], None),
    "size0-kept": (lambda b: b[:3, :0, 0], (1,)),
    "size1": (lambda b: b[:1, 0, 0], None),
    "rows-axis1": (lambda b: b[:50, :100, :100].reshape(500, 1000), (1,)),
}


@pytest.mark.parametrize("dtype", ["float64", "float32", "int64"])
@pytest.mark.parametrize("case", sorted(REGION_CASES))
def test_region_sum_kernel_cases(bases, case, dtype):
    import torch

    from cubed_tpu_torch.kernels.region_sum import region_sum, region_sum_plain

    make, axes = REGION_CASES[case]
    x = make(bases[dtype])
    before = region_sum.launches
    got = region_sum(x, axes)
    assert region_sum.launches == before + (1 if got.numel() else 0)
    assert torch.equal(got, region_sum(x, axes))
    plain = region_sum_plain(x, axes)
    assert got.shape == plain.shape and got.dtype == plain.dtype
    if dtype == "int64":
        assert torch.equal(got, plain)
    else:
        scale = region_sum_plain(x.double().abs(), axes)
        rtol = 1e-12 if dtype == "float64" else 1e-6
        assert bool(((got.double() - plain.double()).abs() <= rtol * scale).all())


def test_region_sum_takes_every_path(bases):
    from cubed_tpu_torch.kernels.region_sum import region_sum

    before = dict(region_sum.paths)
    for case in sorted(REGION_CASES):
        make, axes = REGION_CASES[case]
        region_sum(make(bases["float64"]), axes)
    # the float32 route (compute_dtype="float32") counts in paths too
    make, axes = REGION_CASES["main-path-view"]
    region_sum(make(bases["float32"]), axes)
    taken = {k: region_sum.paths[k] - before[k] for k in before}
    assert all(taken.values()), taken


def test_region_sum_axis0_of_a_strided_view_allocates_no_input_sized_buffer(bases):
    import torch

    from cubed_tpu_torch.kernels.region_sum import region_sum

    x = bases["float64"][100:200, 200:300, 0:100]
    region_sum(x, (0,))  # first use: the stream's ticket counters
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    region_sum(x, (0,))
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - start < x.numel() * x.element_size() // 4


# name: the four inputs, from the base of their dtype
FMA_CASES = {
    "main-path-view": lambda b: [b[100 * k:100 * k + 100, 200:300, 0:100] for k in range(4)],
    "ragged-view": lambda b: [b[100 * k + 99:100 * k + 198, 400:450, 300:400] for k in range(4)],
    "misaligned-view": lambda b: [b[100 * k:100 * k + 100, 200:300, 1:101] for k in range(4)],
    "contiguous-block": lambda b: [b[100 * k:100 * k + 100, :100, :100].contiguous() for k in range(4)],
    "combine-sized": lambda b: [b[k, :5, :4].contiguous() for k in range(4)],
    "size0": lambda b: [b[:0, :5, 0]] * 4,
    "size1": lambda b: [b[k:k + 1, 0, 0] for k in range(4)],
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(FMA_CASES))
def test_fma_sum_kernel_cases(bases, case, dtype):
    import torch

    from cubed_tpu_torch.kernels.fma_sum import fma_sum, fma_sum_blocks, fma_sum_plain

    a, x, b, y = FMA_CASES[case](bases[dtype])
    before = fma_sum_blocks.launches
    got = fma_sum(a, x, b, y)
    # one fma_sum_blocks launch on a grid of one block; none for no element
    assert fma_sum_blocks.launches == before + (1 if a.numel() else 0)
    assert torch.equal(got, fma_sum(a, x, b, y))
    scale = float((a * x).double().abs().sum() + (b * y).double().abs().sum())
    assert float((got - fma_sum_plain(a, x, b, y)).abs().max()) <= 1e-12 * scale


def test_fma_sum_takes_every_path(bases):
    from cubed_tpu_torch.kernels.fma_sum import fma_sum, fma_sum_blocks

    before = dict(fma_sum_blocks.paths)
    for case in sorted(FMA_CASES):
        fma_sum(*FMA_CASES[case](bases["float64"]))
    # the float32 route (compute_dtype="float32") counts in paths too
    fma_sum(*FMA_CASES["main-path-view"](bases["float32"]))
    taken = {k: fma_sum_blocks.paths[k] - before[k] for k in before}
    assert all(taken.values()), taken


# ---------------------------------------------------------------------------
# fma_sum_blocks, the batching rules, and segments replayed as CUDA graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, chunks, dtype, view", [
    ((50, 45, 40), (10, 10, 10), "float64", True),
    ((50, 45, 40), (10, 10, 10), "float32", True),
    ((37, 29, 13), (8, 7, 5), "float64", False),
    ((200, 100, 100), (50, 100, 100), "float64", True),
], ids=["ragged-views", "float32", "odd", "split-tiles"])
def test_fma_sum_blocks_kernel_matches_plain_and_per_block(cuda, shape, chunks, dtype, view):
    import torch

    from cubed_tpu_torch.kernels.fma_sum import fma_sum, fma_sum_blocks, fma_sum_blocks_plain

    g = torch.Generator(device=cuda).manual_seed(13)
    ts = [torch.rand(shape, generator=g, device=cuda, dtype=torch.float64).to(getattr(torch, dtype))
          for _ in range(4)]
    if view:
        ts = [t[1:] for t in ts]
    before = fma_sum_blocks.launches
    got = fma_sum_blocks(*ts, chunks)
    assert fma_sum_blocks.launches == before + 1
    assert torch.equal(got, fma_sum_blocks(*ts, chunks))
    scale = fma_sum_blocks_plain(*[t.abs() for t in ts], chunks)
    assert bool(((got - fma_sum_blocks_plain(*ts, chunks)).abs() <= 1e-12 * scale).all())
    sel = tuple(slice(0, c) for c in chunks)
    assert float((got[(0,) * len(chunks)] - fma_sum(*[t[sel] for t in ts]).reshape(())).abs()) <= 1e-12 * float(
        scale[(0,) * len(chunks)])


def test_batching_rules_launch_once_per_bucket(cuda):
    import torch

    from cubed_tpu_torch.kernels.philox_uniform import philox_blocks, philox_uniform
    from cubed_tpu_torch.kernels.region_sum import region_sum, region_sum_plain

    vmap = torch.func.vmap
    base = torch.rand((50, 45, 40), device=cuda, dtype=torch.float64)[1:]
    st = base.stride()
    grid = base.as_strided((4, 4, 4, 10, 10, 10), tuple(10 * s for s in st) + st)
    for axes in [(0, 1, 2), (0,)]:
        before = region_sum.launches
        got = vmap(vmap(vmap(lambda b, axes=axes: region_sum(b, axes))))(grid)
        assert region_sum.launches == before + 1
        torch.testing.assert_close(got, region_sum_plain(grid, tuple(a + 3 for a in axes)), rtol=1e-12, atol=0)
    like = torch.zeros((), dtype=torch.float64, device=cuda).expand(6, 7)
    seeds = torch.arange(12, dtype=torch.int64).reshape(3, 4, 1, 1) + 99
    before = philox_uniform.launches
    got = vmap(vmap(lambda s: philox_blocks(like, s)))(seeds)
    assert philox_uniform.launches == before + 1
    want = np.random.Generator(np.random.Philox(seed=99 + 6)).random((6, 7))
    np.testing.assert_array_equal(got[1, 2].cpu().numpy().view(np.uint64), want.view(np.uint64))


def test_segment_is_captured_once_and_replayed_for_new_seeds(cuda, tmp_path):
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.kernels.fma_sum import fma_sum_blocks
    from cubed_tpu_torch.kernels.philox_uniform import philox_uniform
    from cubed_tpu_torch.runtime.executors.cuda import _GRAPHS, CudaExecutor

    def build(seed, work):
        random.seed(seed)
        spec = ct.Spec(work_dir=str(tmp_path / work), allowed_mem="500MB")
        a, b, x, y = [ct.random.random((40, 35, 30), chunks=10, spec=spec) for _ in range(4)]
        return xp.mean(a[1:] * x[1:] + b[1:] * y[1:])

    ex = CudaExecutor()
    for i, seed in enumerate((21, 22, 23, 24)):
        before = philox_uniform.launches, fma_sum_blocks.launches
        got = float(build(seed, f"cuda-{seed}").compute(executor=ex))
        # a replay counts the launches its graph holds
        assert (philox_uniform.launches - before[0], fma_sum_blocks.launches - before[1]) == (4, 1)
        want = float(build(seed, f"seq-{seed}").compute())
        np.testing.assert_allclose(got, want, rtol=1e-12)
        assert ex.stats["segments_traced"] == 1
        # the first sighting runs op by op, the second captures and replays,
        # later ones replay
        assert ex.stats["segments_compiled"] == (1 if i == 1 else 0)
        assert ex.stats["segment_struct_hits"] == (1 if i >= 2 else 0)
        # 48 blocks: one combine level, then the aggregate
        assert (ex.stats["batched_ops"], ex.stats["chunked_ops"], ex.stats["eager_ops"]) == (5, 2, 1)
        # the graph's pool, read from the allocator, holds the four random arrays
        if i:
            assert ex.stats["segment_hbm_footprint"] >= 4 * 40 * 35 * 30 * 8
        else:
            assert ex.stats["segment_hbm_footprint"] == 0
    import torch

    assert _GRAPHS.nbytes(torch.device("cuda", torch.cuda.current_device())) > 0


def _blockwise_oracle(torch, shape, chunks, root, device, drop_first_row):
    """The float64 sum of ``random(shape, chunks)`` with root seed *root*
    (without its first row, if *drop_first_row*): numpy's per-block Philox
    streams, drawn on the card by the per-block kernel (held to numpy bit
    for bit above)."""
    from cubed_tpu_torch.chunks import blockdims_from_blockshape
    from cubed_tpu_torch.kernels.philox_uniform import philox_key, philox_uniform

    chunkset = blockdims_from_blockshape(shape, chunks)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for k, idx in enumerate(np.ndindex(*[len(c) for c in chunkset])):
        block = philox_uniform(torch.empty([c[i] for c, i in zip(chunkset, idx)], dtype=torch.float64,
                                           device=device), philox_key(root + k))
        total += (block[1:] if drop_first_row and idx[0] == 0 else block).sum()
    return float(total)


def test_batched_route_cuts_buckets_past_32_bit_indices(cuda, tmp_path):
    # a bucket whose grid view reaches past 2**31 elements: the [1:] view of
    # a resident (65537, 32768) array in (8192, 8192) blocks, and the fused
    # random+sum of a (65536, 32768) array, whose Philox rule would fill
    # 2**31 elements in one launch. The route checks each kernel's reach from
    # metadata and cuts the bucket; a whole-array random fill past 32 bits
    # fails its check and runs chunked.
    import torch

    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.kernels.region_sum import region_sum
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    chunks = (8192, 8192)
    for shape, slice_first_row in (((65537, 32768), True), ((65536, 32768), False)):
        random.seed(7)
        spec = ct.Spec(work_dir=str(tmp_path / str(shape[0])), allowed_mem="8GB")  # 512 MB blocks
        a = ct.random.random(shape, chunks=chunks, spec=spec)
        result = xp.sum(a[1:] if slice_first_row else a)
        ex = CudaExecutor()
        before = region_sum.launches
        got = float(result.compute(executor=ex))
        random.seed(7)
        root = random.getrandbits(30)
        want = _blockwise_oracle(torch, shape, chunks, root, cuda, slice_first_row)
        np.testing.assert_allclose(got, want, rtol=1e-12)
        assert ex.stats["batched_ops"] >= 1
        # the unfused random op of the first plan is past one launch's reach
        assert ex.stats["batched_errors"] == ex.stats["eager_fallbacks"] == (1 if slice_first_row else 0)
        # one bucket of 8 x 4 blocks in pieces: more than one launch
        assert region_sum.launches - before >= 2
        del a, result, ex
        torch.cuda.empty_cache()


def test_capture_reserves_the_ticket_counters_its_kernels_need(cuda, tmp_path):
    # 2048 blocks of fma_sum_blocks, each split in two tiles: 2048 ticket
    # counters, more than a stream gets first; the capture (second compute)
    # reserves them on its stream beforehand, and replays stay right
    import torch

    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.kernels.fma_sum import fma_sum_blocks
    from cubed_tpu_torch.random import _random_blocks
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    def build(seed, work):
        random.seed(seed)
        spec = ct.Spec(work_dir=str(tmp_path / work), allowed_mem="500MB")
        a, b, x, y = [ct.random.random((641, 160, 160), chunks=(10, 20, 48), spec=spec) for _ in range(4)]
        return xp.sum(a[1:] * x[1:] + b[1:] * y[1:])

    ex = CudaExecutor()
    for i, seed in enumerate((31, 32, 33)):
        before = dict(fma_sum_blocks.paths)
        got = float(build(seed, f"cuda-{seed}").compute(executor=ex))
        assert fma_sum_blocks.paths["split"] == before["split"] + 1
        random.seed(seed)
        roots = [random.getrandbits(30) for _ in range(4)]
        ts = [_random_blocks((641, 160, 160), (10, 20, 48), r, cuda)[1:] for r in roots]
        want = float((ts[0] * ts[2] + ts[1] * ts[3]).sum())
        np.testing.assert_allclose(got, want, rtol=1e-12)
        assert ex.stats["segments_compiled"] == (1 if i == 1 else 0)
        assert ex.stats["segment_struct_hits"] == (1 if i == 2 else 0)


def test_random_op_of_rank_five_runs_block_by_block_in_a_segment(cuda, tmp_path):
    # in a segment a random block draws its key from the hoisted table
    # through the Philox op, which lays any block out as one row of a
    # (blocks, elements) grid; computed twice, so the second compute
    # captures the segment and replays it
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    ex = CudaExecutor()
    for i, seed in enumerate((41, 42)):
        random.seed(seed)
        spec = ct.Spec(work_dir=str(tmp_path / str(seed)), allowed_mem="500MB")
        a = ct.random.random((5, 4, 4, 4, 4), chunks=2, spec=spec)
        got = float(xp.sum(a[1:]).compute(executor=ex))
        random.seed(seed)
        root = random.getrandbits(30)
        want = np.empty((5, 4, 4, 4, 4))
        for k, idx in enumerate(np.ndindex(3, 2, 2, 2, 2)):
            sel = tuple(slice(2 * j, 2 * j + 2) for j in idx)
            want[sel] = np.random.Generator(np.random.Philox(seed=root + k)).random(want[sel].shape)
        np.testing.assert_allclose(got, want[1:].sum(), rtol=1e-12)
        # the whole-array fill (four axes at most) and the sum's ten-axis
        # grid view fail their checks from metadata
        assert ex.stats["batched_errors"] == ex.stats["eager_fallbacks"] == 2
        assert ex.stats["segments_compiled"] == i


#: a module global read by a chunk function (``_scale_by_k``)
K = 2.0


def _scale_by_k(x):
    return x * K


def test_a_new_global_value_is_not_replayed_from_an_old_graph(cuda, tmp_path):
    """The second compute captures ``sum(map_blocks(_scale_by_k, a))``'s
    segment with K = 2; the third, with K = 3, must not replay it."""
    global K
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    an = np.random.default_rng(0).random((64, 48))
    ex = CudaExecutor()
    try:
        for i, k in enumerate((2.0, 2.0, 3.0, 3.0)):
            K = k
            spec = ct.Spec(work_dir=str(tmp_path / str(i)), allowed_mem="100MB")
            x = xp.sum(ct.map_blocks(_scale_by_k, ct.from_array(an, chunks=(16, 16), spec=spec),
                                     dtype=np.float64))
            np.testing.assert_allclose(float(x.compute(executor=ex)), float(np.sum(an * k)), rtol=1e-12)
            # K = 3 is a new structural key: a first sighting, then its capture
            assert ex.stats["segments_compiled"] == (1 if i in (1, 3) else 0)
            assert ex.stats["segment_struct_hits"] == 0
    finally:
        K = 2.0


class Cfg:
    """A user's settings class, read by a chunk function as ``Cfg.factor``."""

    factor = 2.0


def _scale_by_cfg(x):
    return x * Cfg.factor


def test_a_new_class_attribute_is_not_replayed_from_an_old_graph(cuda, tmp_path):
    """The second compute captures ``sum(map_blocks(_scale_by_cfg, a))``'s
    segment with ``Cfg.factor`` 2; the third, with 3, must not replay it."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    an = np.random.default_rng(0).random((64, 48))
    ex = CudaExecutor()
    try:
        for i, k in enumerate((2.0, 2.0, 3.0, 3.0)):
            Cfg.factor = k
            spec = ct.Spec(work_dir=str(tmp_path / str(i)), allowed_mem="100MB")
            x = xp.sum(ct.map_blocks(_scale_by_cfg, ct.from_array(an, chunks=(16, 16), spec=spec),
                                     dtype=np.float64))
            np.testing.assert_allclose(float(x.compute(executor=ex)), float(np.sum(an * k)), rtol=1e-12)
            assert ex.stats["segments_compiled"] == (1 if i in (1, 3) else 0)
            assert ex.stats["segment_struct_hits"] == 0
    finally:
        Cfg.factor = 2.0


def test_segment_holding_a_rechunk_is_captured_and_replayed(cuda, tmp_path):
    """``mean(rechunk(a), axis=0)``: the copy op aliases the resident random
    array inside the segment; captured on the second compute, replayed with
    new seeds on the third and fourth, each equal to the sequential executor."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    def build(seed, work):
        random.seed(seed)
        spec = ct.Spec(work_dir=str(tmp_path / work), allowed_mem="500MB")
        return xp.mean(ct.random.random((60, 45, 40), chunks=15, spec=spec).rechunk((60, 9, 8)), axis=0)

    ex = CudaExecutor()
    for i, seed in enumerate((31, 32, 33, 34)):
        got = build(seed, f"cuda-{seed}").compute(executor=ex)
        np.testing.assert_allclose(got, build(seed, f"seq-{seed}").compute(), rtol=1e-12)
        assert ex.stats["rechunk_alias"] == 1 and ex.stats["segments_traced"] == 1
        assert ex.stats["segments_compiled"] == (1 if i == 1 else 0)
        assert ex.stats["segment_struct_hits"] == (1 if i >= 2 else 0)


def test_sum_of_matmul_equals_numpy(cuda, tmp_path):
    """BASELINE config 4 at a small size: ``sum(matmul(a, b))``."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    an, bn = np.random.default_rng(1).random((400, 300)), np.random.default_rng(2).random((300, 200))
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    x = xp.sum(ct.from_array(an, chunks=100, spec=spec) @ ct.from_array(bn, chunks=100, spec=spec))
    want = float(np.sum(an @ bn))
    ex = CudaExecutor()
    np.testing.assert_allclose(float(x.compute(executor=ex)), want, rtol=1e-12)
    np.testing.assert_allclose(float(x.compute()), want, rtol=1e-12)
    assert ex.stats["batched_ops"] >= 1 and ex.stats["eager_fallbacks"] == 0


# ---------------------------------------------------------------------------
# compute_dtype="float32": the float32 Philox entry points, the f32 main path,
# and matmul_precision on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape, offset", [((100, 100, 100), 0), ((99, 100, 101), 0), ((7,), 0), ((1001,), 1)],
                         ids=["100^3", "99x100x101", "7", "1001-misaligned"])
def test_philox_f32_kernel_is_the_rounded_float64_stream(cuda, shape, offset):
    """The per-block float32 entry point: numpy's float64 stream rounded to
    float32, bit for bit, on a 16-byte aligned output (float4 stores) and on
    one 4 bytes off (scalar stores)."""
    import torch

    from cubed_tpu_torch.kernels.philox_uniform import philox_key, philox_uniform, philox_uniform_plain

    n = int(np.prod(shape))
    base = torch.full((n + offset,), -1.0, dtype=torch.float32, device=cuda)
    out = base[offset:].view(shape)
    before = dict(philox_uniform.paths)
    philox_uniform(out, philox_key(2**30 + 1))
    assert philox_uniform.paths["block_f32"] == before["block_f32"] + 1
    ref = np.random.Generator(np.random.Philox(seed=2**30 + 1)).random(shape).astype(np.float32)
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint32), ref.view(np.uint32))
    assert torch.equal(out.reshape(-1), philox_uniform_plain(n, philox_key(2**30 + 1), device=cuda,
                                                              dtype=torch.float32))
    if offset:
        assert float(base[0]) == -1.0


@pytest.mark.parametrize("shape, chunks", PHILOX_BLOCK_CASES,
                         ids=["x".join(map(str, s)) for s, _ in PHILOX_BLOCK_CASES])
def test_philox_blocks_f32_kernel_is_the_rounded_float64_stream(cuda, shape, chunks):
    import torch

    from cubed_tpu_torch.kernels.philox_uniform import (
        philox_keys, philox_uniform, philox_uniform_blocks, philox_uniform_blocks_plain,
    )

    nblocks = int(np.prod([-(-s // c) if s else 1 for s, c in zip(shape, chunks)]))
    seeds = 2**30 - 3 + np.arange(nblocks, dtype=np.int64)
    keys = philox_keys(seeds)
    before = dict(philox_uniform.paths)
    got = philox_uniform_blocks(torch.empty(shape, dtype=torch.float32, device=cuda), chunks, keys)
    assert philox_uniform.paths["batched_f32"] == before["batched_f32"] + (1 if got.numel() else 0)
    assert torch.equal(got, philox_uniform_blocks_plain(shape, chunks, keys, device=cuda, dtype=torch.float32))
    ref = _numpy_blocks(shape, chunks, seeds).astype(np.float32)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("layout", ["column-view", "misaligned", "rows-of-50"])
def test_philox_blocks_f32_kernel_writes_strided_outputs_in_place(cuda, layout):
    """float4 stores where every row and block origin is 16-byte aligned,
    scalar stores where not (a float32 row of 50 elements is 200 bytes)."""
    import torch

    from cubed_tpu_torch.kernels.philox_uniform import philox_keys, philox_uniform, philox_uniform_blocks

    shape, chunks = (64, 48), (16, 16)
    width = {"column-view": 80, "misaligned": 48, "rows-of-50": 50}[layout]
    base = torch.full((64 * width + 1,), -1.0, dtype=torch.float32, device=cuda)
    if layout == "column-view":
        out = base[: 64 * width].view(64, width)[:, 16:64]
    elif layout == "misaligned":
        out = base[1:].view(shape)
    else:
        out = base[: 64 * width].view(64, width)[:, 2:50]
    seeds = 77 + np.arange(12, dtype=np.int64)
    before = dict(philox_uniform.paths)
    philox_uniform_blocks(out, chunks, philox_keys(seeds))
    taken = {k for k, v in philox_uniform.paths.items() if v > before[k]}
    assert taken == {"batched", "batched_f32", "vector" if layout == "column-view" else "scalar"}
    ref = _numpy_blocks(shape, chunks, seeds).astype(np.float32)
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint32), ref.view(np.uint32))


def test_vorticity_f32_on_the_card_matches_the_cpu(cuda, tmp_path):
    """compute_dtype="float32" on the card: the float32 Philox kernel once per
    random array, fma_sum_blocks on float32 inputs, the declared float64
    back; the value within 1e-6 of the same compute on the CPU (the plain
    versions) and within the reference's float32 bound of float64."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch import backend_array_api
    from cubed_tpu_torch.kernels.fma_sum import fma_sum_blocks
    from cubed_tpu_torch.kernels.philox_uniform import philox_uniform
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    def run(device, compute_dtype="float32"):
        backend_array_api.set_device(device)
        try:
            random.seed(3)
            spec = ct.Spec(work_dir=str(tmp_path / f"{device}-{compute_dtype}"), allowed_mem="500MB")
            a, b, x, y = [ct.random.random((50, 45, 40), chunks=10, spec=spec) for _ in range(4)]
            return xp.mean(a[1:] * x[1:] + b[1:] * y[1:]).compute(executor=CudaExecutor(compute_dtype=compute_dtype))
        finally:
            backend_array_api.set_device(None)

    before, fma = dict(philox_uniform.paths), dict(fma_sum_blocks.paths)
    got = run("cuda")
    assert philox_uniform.paths["batched_f32"] == before["batched_f32"] + 4
    assert sum(fma_sum_blocks.paths.values()) > sum(fma.values())
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, run("cpu"), rtol=1e-6)
    np.testing.assert_allclose(got, run("cuda", None), rtol=1e-4, atol=16 * 4 * 90000 * float(np.finfo(np.float32).eps))


def _round_bits(x32, drop):
    bits = x32.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + ((1 << (drop - 1)) - 1) + ((bits >> drop) & 1)) & ~np.uint64((1 << drop) - 1)
    return bits.astype(np.uint32).view(np.float32)


def _mode_model(a, b, mode):
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    if mode == "tensorfloat32":
        return _round_bits(a32, 13).astype(np.float64) @ _round_bits(b32, 13)
    if mode == "bfloat16":
        return _round_bits(a32, 16).astype(np.float64) @ _round_bits(b32, 16)
    if mode == "bfloat16_3x":
        ah, bh = _round_bits(a32, 16).astype(np.float64), _round_bits(b32, 16).astype(np.float64)
        al, bl = _round_bits(a32 - ah.astype(np.float32), 16), _round_bits(b32 - bh.astype(np.float32), 16)
        return ah @ bh + ah @ bl + al @ bh
    return a32.astype(np.float64) @ b32


@pytest.mark.parametrize("mode", [None, "float32", "tensorfloat32", "bfloat16", "bfloat16_3x"])
def test_matmul_precision_modes_on_the_card(cuda, tmp_path, mode):
    """Each mode's per-block product on the card (batched under vmap: the
    custom op's rule, bmm with a float32 output) against its exact model at
    rtol 1e-6, and against the plain version; torch's global switches
    untouched."""
    import torch

    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch import contraction
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    rng = np.random.default_rng(8)
    an, bn = rng.random((256, 192)), rng.random((192, 128))
    switches = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(an, chunks=(64, 64), spec=spec)
    b = ct.from_array(bn, chunks=(64, 64), spec=spec)
    ex = CudaExecutor(compute_dtype="float32", matmul_precision=mode)
    got = xp.matmul(a, b).compute(executor=ex)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()) == switches
    np.testing.assert_allclose(got, _mode_model(an, bn, mode), rtol=1e-6)
    if mode in contraction.REDUCED:
        x = torch.from_numpy(an.astype(np.float32)).to(cuda)
        y = torch.from_numpy(bn.astype(np.float32)).to(cuda)
        with contraction.precision(mode):
            kernel = contraction.matmul(x, y)
        torch.testing.assert_close(kernel, contraction.matmul_plain(x, y, mode), rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", ["float32", "highest", "default"])
def test_a_full_float32_mode_refuses_a_process_that_turned_tf32_on(cuda, mode):
    """A mode that cannot run as specified raises: it never silently becomes
    TF32 because the process turned torch's global switch on."""
    import torch

    from cubed_tpu_torch import contraction

    x = torch.ones((8, 8), device=cuda)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with contraction.precision(mode), pytest.raises(RuntimeError, match="TF32"):
            contraction.matmul(x, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    with contraction.precision(mode):
        assert torch.equal(contraction.matmul(x, x), torch.full((8, 8), 8.0, device=cuda))


#: a substring of each hand kernel's name in a torch.profiler trace
KERNEL_RECORDS = {"philox_uniform": "philox_", "region_sum": "region_sum_", "fma_sum_blocks": "fma_blocks_kernel"}


def test_observers_leave_the_device_route_and_values_as_they_are(cuda, tmp_path, monkeypatch):
    """A small vorticity, cold, capturing and warm, with a TraceCollector,
    the torch.profiler callback and the device memory callback attached:
    values bit for bit, path counters, captures and launches as an
    unobserved series' (each series with a graph cache of its own), and each
    compute's profiler trace names the three hand kernels."""
    import json
    import os
    from collections import OrderedDict

    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.kernels.fma_sum import fma_sum_blocks
    from cubed_tpu_torch.kernels.philox_uniform import philox_uniform
    from cubed_tpu_torch.kernels.region_sum import region_sum
    from cubed_tpu_torch.observability import DeviceMemoryCallback, TorchProfilerCallback, TraceCollector
    from cubed_tpu_torch.runtime.executors import cuda as cuda_module

    wrappers = {"philox_uniform": philox_uniform, "region_sum": region_sum, "fma_sum_blocks": fma_sum_blocks}

    def series(observed: bool) -> list:
        monkeypatch.setattr(cuda_module, "_GRAPHS", cuda_module._GraphCache())
        monkeypatch.setattr(cuda_module, "_SEEN", OrderedDict())
        ex = cuda_module.CudaExecutor()
        runs = []
        for seed in (31, 32, 33):
            random.seed(seed)
            spec = ct.Spec(work_dir=str(tmp_path / f"{observed}-{seed}"), allowed_mem="500MB")
            a, b, x, y = [ct.random.random((40, 35, 30), chunks=10, spec=spec) for _ in range(4)]
            v = xp.mean(a[1:] * x[1:] + b[1:] * y[1:])
            cbs = [TraceCollector(trace_dir=str(tmp_path / "trace")),
                   TorchProfilerCallback(log_dir=str(tmp_path / "profile")), DeviceMemoryCallback()] \
                if observed else None
            before = {k: w.launches for k, w in wrappers.items()}
            value = np.asarray(v.compute(executor=ex, callbacks=cbs))
            tasks = v.plan._finalize(array_names=(v.name,)).num_tasks()
            runs.append((value, dict(ex.stats), {k: w.launches - before[k] for k, w in wrappers.items()}, cbs, tasks))
        return runs

    plain, seen = series(False), series(True)
    assert [r[1].get("segments_compiled", 0) for r in seen] == [0, 1, 0]
    for (value, stats, launches, _, _), (seen_value, seen_stats, seen_launches, (col, prof, mem), tasks) in zip(
            plain, seen):
        np.testing.assert_array_equal(seen_value, value)
        assert seen_stats == stats
        assert seen_launches == launches
        assert col.executor_stats["tasks_completed"] == tasks
        events = json.load(open(prof.trace_path))["traceEvents"]
        names = [e["name"] for e in events if e.get("cat") == "kernel"]
        for key, record in KERNEL_RECORDS.items():
            assert any(record in n for n in names), key
        assert mem.samples and all(s["bytes_in_use"] is not None for s in mem.samples)
        assert os.path.exists(col.trace_path)


def _an_array(ct, spec):
    return ct.random.random((300, 200), chunks=(100, 50), spec=spec)


#: Array API plans whose device routes a CUDA graph capture must hold: a
#: virtual constant filled on the card, block offsets made on the card
#: (arange, linspace, eye, an arg reduction fused with its random input),
#: whole-array selects (a negative step, an integer array), a device
#: concat, views of resident side inputs (flip), the scans
ARRAY_API_PLANS = {
    "zeros_add": lambda ct, xp, s: xp.add(_an_array(ct, s), xp.zeros((300, 200), chunks=(100, 50), spec=s)),
    "arange_linspace": lambda ct, xp, s: xp.add(xp.arange(0, 3000, 1.5, chunks=400, spec=s),
                                                xp.linspace(0, 1, 2000, chunks=400, spec=s)),
    "eye": lambda ct, xp, s: xp.multiply(xp.eye(300, 200, k=3, chunks=(100, 50), spec=s), _an_array(ct, s)),
    "argmax": lambda ct, xp, s: xp.argmax(_an_array(ct, s), axis=0),
    "selects": lambda ct, xp, s: _an_array(ct, s)[::-3, [199, 0, 7, 7]] * 2.0,
    "flip_concat_roll": lambda ct, xp, s: xp.roll(
        xp.concat([xp.flip(a := _an_array(ct, s), axis=1), a], axis=0), 17, axis=0),
    "var_cumulative_sum": lambda ct, xp, s: xp.cumulative_sum(
        xp.add(xp.var(a := _an_array(ct, s), axis=1, keepdims=True), a), axis=1),
    "where_ones": lambda ct, xp, s: xp.where(xp.greater(a := _an_array(ct, s), 0.5), a, xp.ones_like(a)),
}


@pytest.mark.parametrize("name", sorted(ARRAY_API_PLANS))
def test_array_api_plans_capture_and_replay_on_the_card(cuda, tmp_path, name):
    """Three computes on one device executor (op by op, capture and replay,
    replay), each with its own seeds, equal to the sequential executor's."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    ex = CudaExecutor()
    for seed in (41, 42, 43):
        values = []
        for executor in (ex, None):
            random.seed(seed)
            spec = ct.Spec(work_dir=str(tmp_path / f"{seed}-{executor is None}"), allowed_mem="500MB")
            values.append(ARRAY_API_PLANS[name](ct, xp, spec).compute(executor=executor))
        got, want = values
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors"):
            assert ex.stats[counter] == 0, counter


# -- the order-statistics slice ----------------------------------------------


def test_integer_matmul_is_exact_on_the_card(cuda, tmp_path):
    """torch's CUDA GEMMs take no integer dtype: an integer product on the
    card goes to the exact route (contraction.integer_matmul), on the
    sequential and the device executor, equal to numpy's."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    rng = np.random.default_rng(0)
    for dtype in (np.int32, np.int64):
        an = rng.integers(0, 1001, (120, 300)).astype(dtype)
        bn = rng.integers(0, 1001, (300, 90)).astype(dtype)
        spec = ct.Spec(work_dir=str(tmp_path / np.dtype(dtype).name), allowed_mem="500MB")
        a = ct.from_array(an, chunks=(50, 100), spec=spec)
        b = ct.from_array(bn, chunks=(100, 40), spec=spec)
        for executor in (None, CudaExecutor()):
            got = xp.matmul(a, b).compute(executor=executor)
            assert got.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(got, an @ bn)
        # values past 2**53 in their products: a float GEMM would round them
        big = np.array([[2**31 - 1, 3], [5, 2**31 - 7]], dtype=np.int64)
        bb = ct.from_array(big, chunks=(1, 2), spec=spec)
        np.testing.assert_array_equal(xp.matmul(bb, bb).compute(executor=CudaExecutor()), big @ big)


def _order_data(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        a = (rng.integers(0, 7, shape) * 0.5).astype(dtype)
        a[rng.random(shape) < 0.1] = np.nan
        a[rng.random(shape) < 0.05] = -0.0
        return a
    info = np.iinfo(dtype)
    return np.array([info.min, info.max, 0, 1, 2, 3], dtype=dtype)[rng.integers(0, 6, shape)]


def _bits(t) -> np.ndarray:
    """A tensor's elements as integers of their width: equal bit for bit,
    a float's -0.0 and NaN payloads included."""
    a = t.cpu().numpy()
    return a.view({8: np.int64, 4: np.int32}[a.itemsize]) if a.dtype.kind == "f" else a


#: lanes past a sort tile: (n, axis) recipes resolved against the values
#: sort's plan for the dtype (_geometry.sort_plan's tile T): T + 1 and 3T + 5
#: along axis 0 beside 20 lanes (not a multiple of a tile's lane count), and
#: along the innermost axis
PAST_TILE = {"tile+1": (1, 0), "3tile+5": (3, 5)}


def _order_case(shape, axis, dtype):
    """A (shape, axis) parameter, or a PAST_TILE recipe ("tile+1", 0) /
    ("tile+1", -1) resolved for *dtype*."""
    if not isinstance(shape, str):
        return shape, axis
    from cubed_tpu_torch.kernels import _geometry

    inner = 20 if axis == 0 else 1
    times, plus = PAST_TILE[shape]
    n = times * _geometry.sort_plan(1, 1 << 20, inner, np.dtype(dtype).itemsize, "values").tile + plus
    return ((n, inner), 0) if axis == 0 else ((3, n), 1)


@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "int32", "int16", "int8", "uint8"])
@pytest.mark.parametrize("shape, axis", [((37,), 0), ((5, 33, 7), 1), ((64, 3, 4), 0), ((3, 4, 65), 2),
                                         ((4, 1000), 1), ("tile+1", 0), ("3tile+5", 0), ("tile+1", -1),
                                         ("3tile+5", -1)])
def test_order_backend_functions_match_their_plain_versions(cuda, dtype, shape, axis):
    """nxp.sort, argsort, sort_pairs and the merge-split on the card equal
    their plain versions on the CPU bit for bit: NaN last, -0.0 equal to
    0.0 (each keeps its bits), ties in their first order, the dtype's
    extremes; lanes within a tile and past it (merge passes), along axis 0
    and along the innermost axis."""
    import torch

    from cubed_tpu_torch.backend_array_api import nxp
    from cubed_tpu_torch.kernels import merge_sort as ms

    shape, axis = _order_case(shape, axis, dtype)
    a = torch.from_numpy(_order_data(shape, np.dtype(dtype)))
    b = torch.from_numpy(_order_data(shape, np.dtype(dtype), seed=1))
    idx = torch.from_numpy(np.random.default_rng(2).permutation(a.numel()).reshape(shape))
    np.testing.assert_array_equal(_bits(nxp.sort(a.to(cuda), axis=axis)),
                                  _bits(torch.sort(a, dim=axis, stable=True).values))
    np.testing.assert_array_equal(nxp.argsort(a.to(cuda), axis=axis).cpu(),
                                  np.argsort(a.numpy(), axis=axis, kind="stable"))
    got = nxp.sort_pairs(a.to(cuda), idx.to(cuda), axis)
    want = ms.sort_block_plain(a, axis, idx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    sa, sb = ms.sort_block_plain(a, axis), ms.sort_block_plain(b, axis)
    (pa, ia), (pb, ib) = ms.sort_block_plain(a, axis, idx), ms.sort_block_plain(b, axis, idx)
    flags = torch.from_numpy(np.random.default_rng(3).random(shape[:axis] + (1,) * (len(shape) - axis)) < 0.5)
    for f in (flags, ~flags):  # each lane group's low half, then its high half
        np.testing.assert_array_equal(_bits(ms.merge_split(sa.to(cuda), sb.to(cuda), f.to(cuda), axis)),
                                      _bits(ms.merge_split_plain(sa, sb, f, axis)))
        got = ms.merge_split(*(t.to(cuda) for t in (pa, pb)), f.to(cuda), axis, ia.to(cuda), ib.to(cuda))
        for g, w in zip(got, ms.merge_split_plain(pa, pb, f, axis, ia, ib)):
            np.testing.assert_array_equal(_bits(g), _bits(w))


def _split_pair(shape, axis, dtype, kind, seed):
    """Two blocks sorted along *axis*, with int64 indices (few distinct:
    ties of (value, index)): mixed data (NaN, -0.0, ties, extremes); lanes
    of equal keys whose bits differ (x -0.0 or a NaN with a payload, y 0.0
    or the default NaN); or x wholly below or above y."""
    import torch

    from cubed_tpu_torch.kernels import merge_sort as ms

    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if kind == "mixed":
        a, b = _order_data(shape, dt, seed), _order_data(shape, dt, seed + 1)
    elif kind == "equal keys":
        if dt.kind == "f":
            bits = {8: np.int64, 4: np.int32}[dt.itemsize]
            nan = np.array(np.nan, dtype=dt)
            payload = (nan.view(bits) + 1).view(dt)
            lane_shape = tuple(1 if d == axis else k for d, k in enumerate(shape))
            odd = (np.arange(int(np.prod(lane_shape))) % 2 == 0).reshape(lane_shape)
            a = np.where(odd, payload, np.full(shape, -0.0, dtype=dt))
            b = np.where(odd, nan, np.zeros(shape, dtype=dt))
        else:
            a, b = np.full(shape, 3, dtype=dt), np.full(shape, 3, dtype=dt)
    else:
        lo = rng.integers(0, 10, shape).astype(dt)
        a, b = (lo, lo + 20) if kind == "x below y" else (lo + 20, lo)
    ia, ib = (torch.from_numpy(rng.integers(0, 4, shape)) for _ in range(2))
    a, b = torch.from_numpy(np.ascontiguousarray(a)), torch.from_numpy(np.ascontiguousarray(b))
    return ms.sort_block_plain(a, axis), ms.sort_block_plain(b, axis), ms.sort_block_plain(a, axis, ia), \
        ms.sort_block_plain(b, axis, ib)


@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "int32", "int16", "int8", "uint8"])
@pytest.mark.parametrize("n_at", ["171", "tile+1", "3tile+5"])
@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("kind", ["mixed", "equal keys", "x below y", "x above y"])
def test_merge_split_matches_its_plain_version_over_its_tiles(cuda, dtype, n_at, axis, kind):
    """merge_split on the card equals its plain version on the CPU bit for
    bit, the low half and the high half, values and pairs: lanes of 171
    steps, of its tile plus one and of three tiles plus five
    (``_geometry.split_plan``'s tile: several work items along a lane, each
    with its own splits), along axis 0 beside 20 lanes (ragged lane
    groups) and along the innermost axis (inner 1, three lane groups, each
    its own flag); one launch a call."""
    import torch

    from cubed_tpu_torch.kernels import _geometry
    from cubed_tpu_torch.kernels import merge_sort as ms

    inner = 20 if axis == 0 else 1
    t = _geometry.split_plan(1, 1 << 20, inner, np.dtype(dtype).itemsize, "values").tile
    n = {"171": 171, "tile+1": t + 1, "3tile+5": 3 * t + 5}[n_at]
    shape, axis = ((n, inner), 0) if axis == 0 else ((3, n), 1)
    sa, sb, (pa, ia), (pb, ib) = _split_pair(shape, axis, dtype, kind, seed=n)
    flags = torch.from_numpy(np.random.default_rng(n).random(shape[:axis] + (1,) * (2 - axis)) < 0.5)
    for f in (flags, ~flags):
        before = ms.merge_split.launches
        got = ms.merge_split(sa.to(cuda), sb.to(cuda), f.to(cuda), axis)
        got_p = ms.merge_split(pa.to(cuda), pb.to(cuda), f.to(cuda), axis, ia.to(cuda), ib.to(cuda))
        assert ms.merge_split.launches - before == 2
        np.testing.assert_array_equal(_bits(got), _bits(ms.merge_split_plain(sa, sb, f, axis)))
        for g, w in zip(got_p, ms.merge_split_plain(pa, pb, f, axis, ia, ib)):
            np.testing.assert_array_equal(_bits(g), _bits(w))


def test_merge_split_vmapped_is_one_launch_with_a_flag_an_example(cuda):
    """A vmapped merge-split (the device executor's batched round): the
    batch's examples become lane groups of one launch, each reading its own
    flag; the phase's (512, 256, 256) pair takes two CTAs a lane group."""
    import torch

    from cubed_tpu_torch.kernels import _geometry
    from cubed_tpu_torch.kernels import merge_sort as ms

    shape = (_geometry.split_plan(1, 1 << 20, 20, 8, "values").tile + 1, 20)
    pairs = [_split_pair(shape, 0, "float64", "mixed", seed=k) for k in range(4)]
    flags = torch.tensor([True, False, False, True])
    sa, sb = (torch.stack([p[k] for p in pairs]).to(cuda) for k in (0, 1))
    pa, ia, pb, ib = (torch.stack([p[k][j] for p in pairs]).to(cuda) for k in (2, 3) for j in (0, 1))
    before = ms.merge_split.launches
    got = torch.func.vmap(lambda a, b, f: ms.merge_split(a, b, f, 0))(sa, sb, flags.to(cuda))
    got_p = torch.func.vmap(lambda a, b, i, j, f: ms.merge_split(a, b, f, 0, i, j))(pa, pb, ia, ib, flags.to(cuda))
    assert ms.merge_split.launches - before == 2
    for k, p in enumerate(pairs):
        np.testing.assert_array_equal(_bits(got[k]), _bits(ms.merge_split_plain(p[0], p[1], flags[k], 0)))
        want = ms.merge_split_plain(p[2][0], p[3][0], flags[k], 0, p[2][1], p[3][1])
        np.testing.assert_array_equal(_bits(got_p[0][k]), _bits(want[0]))
        np.testing.assert_array_equal(got_p[1][k].cpu(), want[1])
    p = _geometry.split_plan(1, 512, 65536, 8, "values")
    assert (p.tile, p.lanes, p.tiles_n, p.launches) == (256, 16, 2, 1)


@pytest.mark.parametrize("where", ["tile+1", "3tile+5"])
def test_sort_kernels_launch_as_their_plan_says(cuda, where):
    """A sort, a sort with indices and an argsort of float64 lanes past the
    tile count the plan's launches (the tile sort and its merge passes); a
    block of (512, 256, 256) along axis 0 is one launch each; vmapped blocks
    sort as one batch of lanes, equal to each block's own sort."""
    import torch

    from cubed_tpu_torch.kernels import _geometry
    from cubed_tpu_torch.kernels import merge_sort as ms

    shape, axis = _order_case(where, 0, "float64")
    cases = [(shape, 0), ((512, 256, 256), 0)]
    for shape, axis in cases:
        a = torch.rand(shape, dtype=torch.float64, device=cuda)
        outer, n, inner = int(np.prod(shape[:axis])), shape[axis], int(np.prod(shape[axis + 1:]))
        for mode, call in (("values", lambda: ms.sort_block(a, axis)),
                           ("pairs", lambda: ms.sort_block(a, axis, torch.zeros_like(a, dtype=torch.int64))),
                           ("argsort", lambda: ms.argsort_block(a, axis))):
            wrapper = ms.argsort_block if mode == "argsort" else ms.sort_block
            before = wrapper.launches
            call()
            plan = _geometry.sort_plan(outer, n, inner, 8, mode)
            assert wrapper.launches - before == plan.launches
            assert plan.launches == (1 if n <= plan.tile else 1 + int(np.ceil(np.log2(np.ceil(n / plan.tile)))))
        if shape == (512, 256, 256):
            assert _geometry.sort_plan(outer, n, inner, 8, "values").launches == 1
            assert _geometry.sort_plan(outer, n, inner, 8, "argsort").launches == 1
    batch = torch.rand((3, 512, 16, 16), dtype=torch.float64, device=cuda)
    before = ms.argsort_block.launches
    got = torch.func.vmap(lambda t: ms.argsort_block(t, 0))(batch)
    assert ms.argsort_block.launches - before == _geometry.sort_plan(3, 512, 16 * 16, 8, "argsort").launches == 1
    for k in range(3):
        np.testing.assert_array_equal(got[k].cpu(), ms.argsort_block_plain(batch[k].cpu(), 0))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_on_the_card_places_nan_and_promotes(cuda, side):
    import torch

    from cubed_tpu_torch.backend_array_api import nxp

    a = np.array([-1.0, -0.0, 1.0, 2.0, 2.0, np.nan])
    v = np.array([np.nan, 0.0, -0.0, 2.0, 5.0, -2.0, np.inf, -np.inf])
    got = nxp.searchsorted(torch.from_numpy(a).to(cuda), torch.from_numpy(v).to(cuda), side=side)
    np.testing.assert_array_equal(got.cpu(), np.searchsorted(a, v, side=side))
    ai = np.arange(0, 40, 3, dtype=np.int32)
    got = nxp.searchsorted(torch.from_numpy(ai).to(cuda), torch.from_numpy(v).to(cuda), side=side)
    np.testing.assert_array_equal(got.cpu(), np.searchsorted(ai, v, side=side))
    vf = v.astype(np.float32)
    got = nxp.searchsorted(torch.from_numpy(a.astype(np.float32)).to(cuda), torch.from_numpy(vf).to(cuda), side=side)
    np.testing.assert_array_equal(got.cpu(), np.searchsorted(a.astype(np.float32), vf, side=side))


def test_histogram_on_the_card_matches_numpy(cuda):
    """The last edge closed, NaN and values outside in no bin; counts exact;
    weighted counts within 1e-12 of numpy's per bin (the atomics add in any
    order); more than one piece of the block (2**18 elements)."""
    import torch

    from cubed_tpu_torch.backend_array_api import nxp

    x = np.random.default_rng(4).standard_normal(600_000)
    x[::97] = np.nan
    x[:5] = [2.0, -2.0, 2.5, -3.0, 0.0]
    edges = np.linspace(-2, 2, 17)
    counts, _ = nxp.histogram(torch.from_numpy(x).to(cuda), torch.from_numpy(edges).to(cuda))
    np.testing.assert_array_equal(counts.cpu(), np.histogram(x, bins=edges)[0])
    w = np.abs(np.nan_to_num(x)) + 1.0
    counts, _ = nxp.histogram(torch.from_numpy(x).to(cuda), torch.from_numpy(edges).to(cuda),
                              torch.from_numpy(w).to(cuda))
    np.testing.assert_allclose(counts.cpu(), np.histogram(x, bins=edges, weights=w)[0], rtol=1e-12)


def test_nan_reductions_on_the_card(cuda):
    import torch

    from cubed_tpu_torch.backend_array_api import nxp

    x = _order_data((40, 30), np.float64)
    t = torch.from_numpy(x).to(cuda)
    np.testing.assert_allclose(nxp.nansum(t, axis=0).cpu(), np.nansum(x, axis=0), rtol=1e-12)
    np.testing.assert_array_equal(nxp.nanmax(t, axis=1).cpu(), np.nan_to_num(np.nanmax(x, axis=1), nan=-np.inf))
    np.testing.assert_array_equal(nxp.nanmin(t, axis=1).cpu(), np.nan_to_num(np.nanmin(x, axis=1), nan=np.inf))


def test_bitonic_round_captured_and_replayed_with_a_new_offset(cuda):
    """One argsort round (its pair kernel: block offsets read as data)
    captured into a CUDA graph, then replayed after its offset tensor is
    refilled with another block's: the replay keeps the other half of the
    merge, as the plain version does."""
    import torch

    from cubed_tpu_torch.kernels import merge_sort as ms

    numblocks, axis, size, stride = (4, 2), 0, 4, 1
    from cubed_tpu_torch.core.ops import block_index_from_offset

    def pair(v, vp, i, ip, off):
        bi = block_index_from_offset(off, axis, numblocks)
        take_low = ((bi & size) == 0) == ((bi & stride) == 0)
        return ms.merge_split(v, vp, take_low, axis, i, ip)

    rng = np.random.default_rng(5)
    shape = (64, 9)
    v, vp = [ms.sort_block_plain(torch.from_numpy(rng.random(shape)), 0) for _ in range(2)]
    i = torch.arange(v.numel()).reshape(shape)
    ip = i + v.numel()
    args = [t.to(cuda) for t in (v, vp, i, ip)]
    off = torch.zeros((1, 1), dtype=torch.int64, device=cuda)  # block (0, 0): keeps the low half
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        pair(*args, off)  # loads the kernels outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_v, out_i = pair(*args, off)
    graph.replay()
    torch.cuda.synchronize()
    for offset, low in ((0, True), (2, False)):  # block (1, 0): the upper of its pair keeps the high half
        off.fill_(offset)
        graph.replay()
        torch.cuda.synchronize()
        want = ms.merge_split_plain(v, vp, torch.tensor(low), axis, i, ip)
        np.testing.assert_array_equal(out_v.cpu(), want[0])
        np.testing.assert_array_equal(out_i.cpu(), want[1])


def test_network_sort_captured_and_replayed_on_the_card(cuda, tmp_path, monkeypatch):
    """argsort and sort through the forced network on one device executor,
    three computes with their own seeds (op by op, capture and replay,
    replay), each equal to numpy's: the rounds batched, no failed check."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    monkeypatch.setenv("CUBED_TPU_TORCH_SORT_NETWORK", "force")
    for op in ("sort", "argsort"):
        ex = CudaExecutor()
        for k, seed in enumerate((51, 52, 53)):
            random.seed(seed)
            spec = ct.Spec(work_dir=str(tmp_path / f"{op}-{seed}"), allowed_mem="500MB")
            a = ct.random.random((200, 30), chunks=(25, 15), spec=spec)
            got = getattr(xp, op)(a, axis=0).compute(executor=ex)
            an = a.compute()
            want = np.sort(an, axis=0) if op == "sort" else np.argsort(an, axis=0, kind="stable")
            np.testing.assert_array_equal(got, want)
            assert (ex.stats["segments_compiled"] > 0) == (k == 1), dict(ex.stats)
            assert (ex.stats["segment_struct_hits"] > 0) == (k == 2), dict(ex.stats)
            for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors"):
                assert ex.stats[counter] == 0, counter


def test_a_captured_graph_keeps_the_device_constants_it_reads(cuda, tmp_path, monkeypatch):
    """A forced network argsort captured (its partner blocks gathered by
    block permutations, device constants), then more than the constant
    cache's LIMIT others read and the freed memory taken by tensors of
    zeros, then replayed: the graph kept its permutations, so the replay
    still equals numpy's."""
    import torch

    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch import device_constants
    from cubed_tpu_torch.runtime.executors import cuda as cx

    monkeypatch.setenv("CUBED_TPU_TORCH_SORT_NETWORK", "force")
    # no graph of an earlier test is replayed here: this one captures its own
    monkeypatch.setattr(cx, "_GRAPHS", cx._GraphCache())
    monkeypatch.setattr(cx, "_SEEN", type(cx._SEEN)())
    ex = cx.CudaExecutor()
    junk = []
    for k, seed in enumerate((61, 62, 63)):
        if k == 2:
            pinned = [t for g in cx._GRAPHS.entries.values() for t in g.constants]
            assert pinned, "the captured rounds read no device constant"
            for n in range(device_constants.LIMIT + 1):
                device_constants.constant(np.arange(n, n + 7), cuda)
            cached = {id(entry[1]) for entry in device_constants._CACHE.values()}
            assert not any(id(t) in cached for t in pinned)
            del pinned
            junk = [torch.zeros(64, dtype=torch.int64, device=cuda) for _ in range(4096)]
        random.seed(seed)
        spec = ct.Spec(work_dir=str(tmp_path / f"argsort-{seed}"), allowed_mem="500MB")
        a = ct.random.random((200, 30), chunks=(25, 15), spec=spec)
        got = xp.argsort(a, axis=0).compute(executor=ex)
        np.testing.assert_array_equal(got, np.argsort(a.compute(), axis=0, kind="stable"))
        assert (ex.stats["segment_struct_hits"] > 0) == (k == 2), dict(ex.stats)
    del junk


# -- results written to Zarr, the stencils, normal/randint --------------------


def _laplacian(b):
    import torch

    return (torch.roll(b, 1, 1) + torch.roll(b, -1, 1)) + (torch.roll(b, 1, 2) + torch.roll(b, -1, 2)) - 4.0 * b


ZARR_STENCIL_PLANS = {
    "stencil_periodic": lambda ct, xp, s: ct.map_overlap(
        _laplacian, ct.random.random((30, 45, 40), chunks=(10, 20, 15), spec=s), depth=(0, 1, 1),
        boundary="periodic"),
    "stencil_reflect_untrimmed": lambda ct, xp, s: ct.map_overlap(
        _laplacian, xp.multiply(ct.random.random((30, 45, 40), chunks=(10, 20, 15), spec=s), 2.0),
        depth=(1, 2, 1), boundary="reflect", trim=False),
    "normal_scaled": lambda ct, xp, s: ct.random.normal((40, 30), mean=10.0, stddev=3.0, chunks=(10, 12), spec=s),
    "randint_padded": lambda ct, xp, s: xp.pad(ct.random.randint(-5, 5, (40, 30), chunks=(10, 12), spec=s),
                                              ((2, 1), (0, 3)), mode="edge"),
}


@pytest.mark.parametrize("name", sorted(ZARR_STENCIL_PLANS))
def test_zarr_stencil_plans_on_the_card(cuda, tmp_path, name):
    """Three computes on one device executor (a segment's first sighting,
    its capture unless it draws on the host, a replay), each with its own
    seeds, equal to the sequential executor's; the host draws never
    captured."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    ex = CudaExecutor()
    for seed in (51, 52, 53):
        values = []
        for executor in (ex, None):
            random.seed(seed)
            spec = ct.Spec(work_dir=str(tmp_path / f"{seed}-{executor is None}"), allowed_mem="500MB")
            values.append(ZARR_STENCIL_PLANS[name](ct, xp, spec).compute(executor=executor))
        got, want = values
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors"):
            assert ex.stats[counter] == 0, counter
        if name.startswith(("normal", "randint")):
            assert ex.stats["segments_compiled"] == 0 and ex.stats["segment_struct_hits"] == 0


def test_compressed_to_zarr_from_a_resident_stencil_on_the_card(cuda, tmp_path):
    """to_zarr of a stencil of a resident array with zlib: the input read as
    a view (its store never written), the output written through the codec,
    equal to the sequential executor's store."""
    import os

    import cubed_tpu_torch as ct
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.storage.store import open_zarr_array

    stores = []
    for executor in (CudaExecutor(), None):
        random.seed(61)
        spec = ct.Spec(work_dir=str(tmp_path / f"work-{executor is None}"), allowed_mem="500MB")
        a = ct.random.random((30, 45, 40), chunks=(10, 20, 15), spec=spec)
        lap = ct.map_overlap(_laplacian, a, depth=(0, 1, 1), boundary="periodic")
        stores.append(str(tmp_path / f"out-{executor is None}.zarr"))
        ct.to_zarr(lap, stores[-1], executor=executor, compressor={"id": "zlib", "level": 1})
        if executor is not None:
            assert not os.path.exists(a.zarray_maybe_lazy.store)
    got, want = (open_zarr_array(s, "r") for s in stores)
    assert got.compressor == {"id": "zlib", "level": 1}
    np.testing.assert_array_equal(got[...], want[...])


# -- einsum, fft and linalg ----------------------------------------------------


def _spd_plan(ct, xp, s, batch=6, n=8):
    """A stack of SPD matrices made on the card, B B^T / n + n I (one (60,
    60) matrix in (20, 20) blocks with *batch* None)."""
    if batch is None:
        b = ct.random.random((n, n), chunks=(20, 20), spec=s)
        eye = xp.eye(n, dtype=xp.float64, chunks=(20, 20), spec=s)
    else:
        b = ct.random.random((batch, n, n), chunks=(2, n, n), spec=s)
        eye = xp.eye(n, dtype=xp.float64, spec=s)
    return xp.add(xp.divide(xp.matmul(b, xp.matrix_transpose(b)), float(n)), xp.multiply(eye, float(n)))


def _tall(ct, s):
    return ct.random.random((120, 8), chunks=(30, 8), spec=s)


#: einsum, fft and linalg plans on random inputs: each solver on the batched
#: route, TSQR's three stages (stage 3 reads its block offsets on the card),
#: the blocked Cholesky's panels and its one-write assembly; (plan, captured?)
LINALG_FFT_PLANS = {
    "einsum_covariance": (lambda ct, xp, s: xp.einsum("tyx,tyx->yx", ct.random.random((20, 9, 8), chunks=(5, 3, 4),
                                                                                      spec=s),
                                                      ct.random.random((20, 9, 8), chunks=(5, 3, 4), spec=s)), True),
    "einsum_int64": (lambda ct, xp, s: xp.einsum("ij,jk->ik", ct.random.randint(-9, 9, (40, 30), chunks=(10, 10),
                                                                                spec=s),
                                                 ct.random.randint(-9, 9, (30, 20), chunks=(10, 10), spec=s)), False),
    "rfft_power": (lambda ct, xp, s: xp.mean(xp.square(xp.abs(xp.fft.rfft(
        ct.random.random((64, 12, 10), chunks=(16, 6, 5), spec=s), axis=0))), axis=(1, 2)), True),
    "rfftn_irfftn": (lambda ct, xp, s: xp.fft.irfftn(xp.fft.rfftn(
        ct.random.random((10, 12, 16), chunks=(5, 6, 8), spec=s), axes=(1, 2)), s=(12, 16), axes=(1, 2)), True),
    "tsqr_q": (lambda ct, xp, s: xp.linalg.qr(_tall(ct, s)).Q, True),
    "svdvals": (lambda ct, xp, s: xp.linalg.svdvals(_tall(ct, s)), False),
    "cholesky": (lambda ct, xp, s: xp.linalg.cholesky(_spd_plan(ct, xp, s)), True),
    "solve": (lambda ct, xp, s: xp.linalg.solve(_spd_plan(ct, xp, s), ct.random.random((6, 8, 1), chunks=(2, 8, 1),
                                                                                       spec=s)), True),
    "inv": (lambda ct, xp, s: xp.linalg.inv(_spd_plan(ct, xp, s)), True),
    "slogdet": (lambda ct, xp, s: xp.linalg.slogdet(_spd_plan(ct, xp, s)).logabsdet, True),
    "det": (lambda ct, xp, s: xp.linalg.det(_spd_plan(ct, xp, s)), True),
    "eigh": (lambda ct, xp, s: xp.linalg.eigh(_spd_plan(ct, xp, s)).eigenvalues, True),
    "svd": (lambda ct, xp, s: xp.linalg.svd(_tall(ct, s), full_matrices=False).S, False),
    "blocked_cholesky": (lambda ct, xp, s: xp.linalg.cholesky(_spd_plan(ct, xp, s, batch=None, n=60)), True),
}


@pytest.mark.parametrize("name", sorted(LINALG_FFT_PLANS))
def test_linalg_fft_plans_capture_or_run_op_by_op_on_the_card(cuda, tmp_path, name):
    """Three computes on one device executor, each with its own seeds, equal
    to the sequential executor's: a plan whose solvers capture is captured
    at its second compute and replayed at its third; one holding a solver
    that synchronises the host (svd, svdvals) or host draws (randint) runs
    op by op every time; no failed check."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    build, captured = LINALG_FFT_PLANS[name]
    mem = 100_000 if name == "blocked_cholesky" else "500MB"
    ex = CudaExecutor()
    for k, seed in enumerate((71, 72, 73)):
        values = []
        for executor in (ex, None):
            random.seed(seed)
            spec = ct.Spec(work_dir=str(tmp_path / f"{seed}-{executor is None}"), allowed_mem=mem)
            values.append(build(ct, xp, spec).compute(executor=executor))
        got, want = values
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)
        for counter in ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors"):
            assert ex.stats[counter] == 0, counter
        if captured and k:
            assert ex.stats["segments_compiled" if k == 1 else "segment_struct_hits"] >= 1, dict(ex.stats)
        elif not captured:
            assert ex.stats["segments_compiled"] == 0 and ex.stats["segment_struct_hits"] == 0, dict(ex.stats)
    if name in ("svd", "svdvals"):
        assert ex.stats["segments_uncapturable"] >= 1


def test_an_fft_segment_captures_after_the_cufft_plan_cache_is_cleared(cuda, tmp_path):
    """The cache filled by the first (op by op) compute and cleared before
    the second: the capture makes its plan and captures cleanly; the replay
    of the third compute agrees."""
    import torch

    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    ex = CudaExecutor()
    for k, seed in enumerate((81, 82, 83)):
        random.seed(seed)
        spec = ct.Spec(work_dir=str(tmp_path / str(seed)), allowed_mem="500MB")
        a = ct.random.random((64, 12, 10), chunks=(16, 6, 5), spec=spec)
        f = xp.fft.rfft(a, axis=0)
        if k == 1:
            torch.backends.cuda.cufft_plan_cache[cuda.index or 0].clear()
            assert torch.backends.cuda.cufft_plan_cache[cuda.index or 0].size == 0
        got = f.compute(executor=ex)
        np.testing.assert_allclose(got, np.fft.rfft(a.compute(), axis=0), rtol=1e-12, atol=1e-12)
        assert ex.stats["segments_compiled"] == (1 if k == 1 else 0), dict(ex.stats)
        assert ex.stats["eager_fallbacks"] == 0


def test_integer_einsum_is_exact_on_the_card(cuda, tmp_path):
    """torch.einsum of int64 CUDA tensors reaches an integer GEMM that torch's
    CUDA build lacks: the block contraction takes the exact product route."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    rng = np.random.default_rng(9)
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    for sub, shapes, chunks in (("ij,jk->ik", [(60, 50), (50, 40)], [(20, 25), (25, 20)]),
                                ("abc,cd,be->ade", [(3, 4, 5), (5, 6), (4, 2)], [(1, 2, 5), (5, 3), (2, 2)])):
        data = [rng.integers(-2**40, 2**40, s) for s in shapes]
        arrays = [ct.from_array(d, chunks=c, spec=spec) for d, c in zip(data, chunks)]
        for executor in (None, CudaExecutor()):
            np.testing.assert_array_equal(xp.einsum(sub, *arrays).compute(executor=executor), np.einsum(sub, *data))


@pytest.mark.parametrize("mode", ["bfloat16", "bfloat16_3x", "tensorfloat32", "float32"])
def test_float32_einsum_rounds_as_the_mode_says_on_the_card(cuda, tmp_path, mode):
    """A float32 einsum under each ``matmul_precision`` mode: its block
    contraction against ``contraction.matmul_plain`` (the operands rounded
    as the mode says, float32 sums), and the plan against its exact model."""
    import torch

    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch import contraction
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    rng = np.random.default_rng(10)
    an, bn = rng.random((256, 192)), rng.random((192, 128))
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(an, chunks=(64, 64), spec=spec)
    b = ct.from_array(bn, chunks=(64, 64), spec=spec)
    got = xp.einsum("ij,jk->ik", a, b).compute(executor=CudaExecutor(compute_dtype="float32", matmul_precision=mode))
    np.testing.assert_allclose(got, _mode_model(an, bn, mode), rtol=1e-6)
    if mode in contraction.REDUCED:
        x = torch.from_numpy(an.astype(np.float32)).to(cuda)
        y = torch.from_numpy(bn.astype(np.float32)).to(cuda)
        with contraction.precision(mode):
            block = contraction.einsum("ij,jk->ik", x, y)
        torch.testing.assert_close(block, contraction.matmul_plain(x, y, mode), rtol=1e-6, atol=0)


def test_solver_failures_give_the_jax_packages_pattern_on_the_card(cuda, tmp_path):
    """cholesky of a matrix that is not positive definite: NaN on and below
    the diagonal, 0 above, the batch's others unaffected; inv and solve of a
    singular matrix: the LU's infinities; nothing raises, on both executors."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    an = np.array([[[4., 2, 0], [2, 3, 1], [0, 1, 2]], [[1., 2, 3], [2, 1, 0], [3, 0, 1]]])
    sn = np.array([[[1., 2], [2, 4]], [[2., 1], [1, 2]]])
    a = ct.from_array(an, chunks=(1, 3, 3), spec=spec)
    s = ct.from_array(sn, chunks=(1, 2, 2), spec=spec)
    for executor in (None, CudaExecutor()):
        lo = xp.linalg.cholesky(a).compute(executor=executor)
        np.testing.assert_allclose(lo[0], np.linalg.cholesky(an[0]), atol=1e-12)
        np.testing.assert_array_equal(np.isnan(lo[1]), np.tril(np.ones((3, 3), bool)))
        np.testing.assert_array_equal(np.triu(lo[1], 1), 0)
        inv = xp.linalg.inv(s).compute(executor=executor)
        np.testing.assert_array_equal(inv[0], [[-np.inf, np.inf], [np.inf, -np.inf]])
        np.testing.assert_allclose(inv[1], np.linalg.inv(sn[1]), rtol=1e-12)
        x = xp.linalg.solve(s, ct.from_array(np.ones((2, 2, 1)), chunks=(1, 2, 1), spec=spec)).compute(
            executor=executor)
        np.testing.assert_array_equal(x[0], [[-np.inf], [np.inf]])
        np.testing.assert_allclose(x[1], np.linalg.solve(sn[1], np.ones((2, 1))), rtol=1e-12)


def test_tsqr_on_the_card_reads_its_offsets_on_the_device(cuda, tmp_path):
    """TSQR's stage 3 on the batched route: each panel's rows of Q2 picked by
    a device index from its block offset; Q R equals the input and Q's
    columns are orthonormal."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    random.seed(91)
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    x = ct.random.random((4096, 32), chunks=(512, 32), spec=spec)
    an = x.compute()
    q, r = xp.linalg.qr(x)
    ex = CudaExecutor()
    qn = q.compute(executor=ex)
    # the panels with their random input, and stage 3, each one batched op
    assert ex.stats["batched_ops"] == 2 and ex.stats["batched_errors"] == 0, dict(ex.stats)
    rn = r.compute(executor=CudaExecutor())
    np.testing.assert_allclose(qn @ rn, an, atol=1e-10)
    np.testing.assert_allclose(qn.T @ qn, np.eye(32), atol=1e-10)


# -- the memory guard and reliability on the card ---------------------------


def test_guard_reads_the_allocator_for_one_task(cuda):
    """The guard's device reading of a task that allocates a known tensor:
    the allocator's peak over the task's start, at least the tensor's bytes
    (rounded up to the allocator's block) and no more than one block above."""
    import torch

    from cubed_tpu_torch.runtime import memory

    nbytes = 48 * 2**20
    with memory.scoped("observe", allowed_mem=10**12):
        with memory.task_guard("k") as g:
            t = torch.empty(nbytes // 8, dtype=torch.float64, device=cuda)
            t.fill_(1.0)
            del t
    assert nbytes <= g.device_measured <= nbytes + 2 * 2**20
    assert g.measured == max(g.device_measured, g.host_measured or 0)
    assert memory.last_readings()["device"] == g.device_measured


def test_the_peak_fold_survives_the_guards_reset(cuda):
    """A compute-level peak reading (``memory.device_peaks``) still sees a
    large allocation after a later guard reset the allocator's peak."""
    import torch

    from cubed_tpu_torch.runtime import memory

    memory.reset_device_peaks()
    base = torch.cuda.memory_allocated()  # what earlier tests still hold
    big = 256 * 2**20
    with memory.scoped("observe", allowed_mem=10**12):
        with memory.task_guard("big"):
            t = torch.empty(big // 8, dtype=torch.float64, device=cuda)
            del t
        with memory.task_guard("small"):  # resets the allocator's peak
            s = torch.empty(1024, dtype=torch.float64, device=cuda)
            del s
    assert torch.cuda.max_memory_allocated() < base + big  # the reset happened
    peaks = memory.device_peaks()
    assert peaks["allocated"] >= base + big and peaks["reserved"] >= big


def test_a_cuda_out_of_memory_classifies_resource(cuda):
    import gc

    import torch

    from cubed_tpu_torch.runtime.resilience import Classification, RetryPolicy

    # earlier tests' cyclic garbage may hold a small tensor on the card; a
    # collection the OOM's exception triggers would free it between the
    # two readings, so collect it first
    gc.collect()
    before = torch.cuda.memory_allocated()
    with pytest.raises(torch.OutOfMemoryError) as ei:
        torch.empty(1 << 50, dtype=torch.uint8, device=cuda)
    assert RetryPolicy().classify(ei.value) is Classification.RESOURCE
    assert torch.cuda.memory_allocated() == before


def test_no_guard_inside_a_capture_and_a_guarded_segment_replays(cuda, tmp_path):
    """The guard refuses to run inside a capture; the device executor's
    guard sits outside it, so a captured segment under the default observe
    mode is captured and replayed, and every op's task event carries the
    guard's allocator reading."""
    import torch

    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime import memory
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.runtime.types import Callback

    with memory.scoped("observe", allowed_mem=10**12):
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        x = torch.zeros(16, device=cuda)
        torch.cuda.synchronize()
        with pytest.raises(RuntimeError, match="capture"):
            with torch.cuda.graph(graph, stream=stream):
                y = x + 1
                with memory.task_guard("inside"):
                    pass
        del y
    torch.cuda.synchronize()

    class Peaks(Callback):
        def __init__(self):
            self.peaks = []

        def on_task_end(self, event):
            self.peaks.append(event.guard_mem_peak)

    ex = CudaExecutor()
    for i, seed in enumerate((31, 32, 33)):
        random.seed(seed)
        spec = ct.Spec(work_dir=str(tmp_path / f"w{seed}"), allowed_mem="500MB")
        a, b, x, y = [ct.random.random((40, 35, 30), chunks=10, spec=spec) for _ in range(4)]
        peaks = Peaks()
        value = float(xp.mean(a[1:] * x[1:] + b[1:] * y[1:]).compute(executor=ex, callbacks=[peaks]))
        assert np.isfinite(value)
        assert peaks.peaks and all(p is not None and p >= 0 for p in peaks.peaks)
        assert ex.stats["segments_compiled"] == (1 if i == 1 else 0)
        assert ex.stats["segment_struct_hits"] == (1 if i == 2 else 0)


def test_op_granular_resume_on_the_card(cuda, tmp_path):
    """The to-Zarr product: with its store whole a resume skips the product
    op (the random ops, which persisted nothing, run again); with one chunk
    corrupt the scan quarantines it, the op re-runs, and the store verifies."""
    import cubed_tpu_torch as ct
    from cubed_tpu_torch.core.ops import _store_op
    from cubed_tpu_torch.observability.metrics import get_registry
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    store = str(tmp_path / "product.zarr")
    random.seed(41)
    spec = ct.Spec(work_dir=str(tmp_path / "w"), allowed_mem="500MB")
    a, b, x, y = [ct.random.random((40, 35, 30), chunks=10, spec=spec) for _ in range(4)]
    out = _store_op(a[1:] * x[1:] + b[1:] * y[1:], store)
    out.compute(executor=CudaExecutor())
    expected = ct.from_zarr(store).compute()
    ex = CudaExecutor()
    out.compute(executor=ex, resume=True)
    assert ex.stats["batched_ops"] == 4
    with open(f"{store}/1.0.1", "r+b") as f:
        f.seek(9)
        byte = f.read(1)
        f.seek(9)
        f.write(bytes([byte[0] ^ 0xFF]))
    before = get_registry().snapshot()
    ex = CudaExecutor()
    out.compute(executor=ex, resume=True)
    assert ex.stats["batched_ops"] == 5
    assert get_registry().snapshot_delta(before).get("chunks_quarantined", 0) == 1
    np.testing.assert_array_equal(ct.from_zarr(store).compute(), expected)
    valid, corrupt, verified = ct.from_zarr(store).zarray.verify_chunks(quarantine=False)
    assert verified and not corrupt


def _synced_guard_readings(monkeypatch):
    """Each guarded unit's device reading (the guard reads the allocator
    without synchronizing) recorded beside the synchronized reading at the
    same points: ``(key, reading, synchronized reading)`` per unit."""
    import torch

    from cubed_tpu_torch.runtime import memory

    start_inner, end_inner, exit_inner = memory._start_device_reading, memory._end_device_reading, \
        memory.task_guard.__exit__
    state, rows = {}, []

    def start(dev):
        base = start_inner(dev)
        torch.cuda.synchronize(dev)
        state["start"] = torch.cuda.memory_allocated(dev)
        state["base_equal"] = base == state["start"]
        return base

    def end(dev, base):
        reading = end_inner(dev, base)
        torch.cuda.synchronize(dev)
        state["synced"] = torch.cuda.max_memory_allocated(dev) - state["start"]
        return reading

    def exit_(self, *exc):
        try:
            return exit_inner(self, *exc)
        finally:
            if self.device_measured is not None:
                rows.append((self._key, self.device_measured, state["synced"], state["base_equal"]))

    monkeypatch.setattr(memory, "_start_device_reading", start)
    monkeypatch.setattr(memory, "_end_device_reading", end)
    monkeypatch.setattr(memory.task_guard, "__exit__", exit_)
    return rows


def test_guard_readings_without_a_synchronize_equal_the_synchronized_ones(cuda, tmp_path, monkeypatch):
    """Every segment's and eager op's ``guard_mem_peak`` on the device
    executor (cold, capturing, replayed; every op eager, a cuBLAS product in
    the matmul's) equals the reset-based reading a synchronize before each
    read gives, and so does a unit that frees a block used on a side
    stream (``record_stream``) before it allocates another."""
    import torch

    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.runtime import memory
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.runtime.types import Callback

    class Peaks(Callback):
        def __init__(self):
            self.peaks = []

        def on_task_end(self, event):
            self.peaks.append(event.guard_mem_peak)

    rows = _synced_guard_readings(monkeypatch)
    ex = CudaExecutor()
    for seed in (51, 52, 53):
        random.seed(seed)
        spec = ct.Spec(work_dir=str(tmp_path / f"w{seed}"), allowed_mem="500MB")
        a, b, x, y = [ct.random.random((40, 35, 30), chunks=10, spec=spec) for _ in range(4)]
        peaks = Peaks()
        xp.mean(a[1:] * x[1:] + b[1:] * y[1:]).compute(executor=ex, callbacks=[peaks])
        assert set(peaks.peaks) <= {r for _, r, _, _ in rows}
    assert any(k.startswith("segment:") for k, _, _, _ in rows)
    random.seed(54)
    spec = ct.Spec(work_dir=str(tmp_path / "mm"), allowed_mem="500MB")
    m = xp.sum(xp.matmul(*[ct.random.random((512, 512), chunks=256, spec=spec) for _ in range(2)]))
    before = len(rows)
    m.compute(executor=CudaExecutor(fuse_plan=False))
    # every op its own eager unit: create-arrays, the two random arrays, the
    # product (a blockwise op) and the sum's reductions
    eager = [k for k, _, _, _ in rows[before:]]
    assert len(eager) >= 5 and all(k.startswith("eager:") for k in eager), eager
    with memory.scoped("observe", allowed_mem=10**12):
        with memory.task_guard("record_stream", observe_only=True):
            x = torch.ones(2**22, dtype=torch.float64, device=cuda)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                y = x * 2.0
            x.record_stream(side)
            del x
            z = torch.full((2**22,), 3.0, dtype=torch.float64, device=cuda)
            del z
            torch.cuda.current_stream().wait_stream(side)
            del y
    assert rows[-1][0] == "record_stream" and rows[-1][1] >= 2 * 2**25
    assert [row for row in rows if row[1] != row[2] or not row[3]] == []


def test_threaded_executor_on_the_card_equals_the_sequential(cuda, tmp_path):
    """Vorticity's plan on 4 threads, both schedulers: the value bit for bit
    the sequential executor's, the kernels launched as often."""
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.kernels.philox_uniform import philox_uniform
    from cubed_tpu_torch.kernels.region_sum import region_sum
    from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor

    def run(executor, scheduler=None):
        random.seed(61)
        spec = ct.Spec(work_dir=str(tmp_path / str(scheduler)), allowed_mem="500MB", scheduler=scheduler)
        a, b, x, y = [ct.random.random((40, 35, 30), chunks=10, spec=spec) for _ in range(4)]
        philox_uniform.launches = region_sum.launches = 0
        value = float(xp.mean(a[1:] * x[1:] + b[1:] * y[1:]).compute(executor=executor))
        return value.hex(), philox_uniform.launches, region_sum.launches

    sequential = run(None)
    assert sequential[1] == 4 * 4 * 4 * 3
    for scheduler in ("dataflow", "oplevel"):
        assert run(AsyncPythonDagExecutor(max_workers=4), scheduler) == sequential


#: (B, S_q, S_k, H, D, q_offset, k_offset) of flash_block's card checks:
#: ragged sequence ends, D of 8, 64, 100 and 256, a block whose keys the
#: causal mask hides from the first queries (rows fully masked) and one it
#: hides entirely, and the main path's slot-step shape cut in depth
FLASH_CASES = [
    (1, 64, 64, 2, 64, 0, 0),
    (2, 100, 70, 3, 8, 0, 0),
    (1, 130, 130, 2, 256, 130, 0),
    (1, 96, 96, 4, 100, 0, 40),
    (1, 64, 64, 1, 128, 0, 64),
    (1, 4096, 4096, 2, 128, 4096, 0),
]


def _flash_inputs(torch, cuda, case, dtype):
    B, S_q, S_k, H, D, q_off, k_off = case
    gen = torch.Generator(device="cpu").manual_seed(sum(case))
    q, k, v = (torch.randn((B, s, H, D), generator=gen).to(cuda, dtype) for s in (S_q, S_k, S_k))
    o = torch.randn((B, H, S_q, D), generator=gen).to(cuda)
    l = torch.rand((B, H, S_q), generator=gen).to(cuda) + 0.5
    m = torch.randn((B, H, S_q), generator=gen).to(cuda)
    m[..., : S_q // 4] = -torch.inf  # rows that have seen no key yet
    l[..., : S_q // 4] = 0.0
    o[..., : S_q // 4, :] = 0.0
    return q, k, v, o, l, m


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_block_kernel_matches_plain_step(cuda, case, causal):
    """float32 arithmetic in another order than the plain step's: 2e-5
    relative to the output's scale, 1e-6 on l and m."""
    import torch

    from cubed_tpu_torch.kernels.flash_block import flash_block, flash_block_plain

    q, k, v, o, l, m = _flash_inputs(torch, cuda, case, torch.float32)
    want = [t.clone() for t in (o, l, m)]
    kw = dict(q_offset=case[5], k_offset=case[6], causal=causal, scale=case[4] ** -0.5)
    flash_block_plain(q, k, v, *want, **kw)
    before = flash_block.launches
    flash_block(q, k, v, o, l, m, **kw)
    torch.cuda.synchronize()
    assert flash_block.launches == before + 1
    assert torch.equal(torch.isneginf(m), torch.isneginf(want[2]))
    fin = ~torch.isneginf(want[2])
    torch.testing.assert_close(m[fin], want[2][fin], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(l, want[1], rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(o, want[0], rtol=2e-5, atol=2e-5 * float(want[0].abs().max()))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_flash_block_kernel_half_inputs(cuda, dtype):
    import torch

    from cubed_tpu_torch.kernels.flash_block import flash_block, flash_block_plain

    q, k, v, o, l, m = _flash_inputs(torch, cuda, (1, 100, 90, 2, 64, 0, 0), getattr(torch, dtype))
    want = [t.clone() for t in (o, l, m)]
    kw = dict(q_offset=0, k_offset=0, causal=True, scale=0.125)
    flash_block_plain(q, k, v, *want, **kw)
    flash_block(q, k, v, o, l, m, **kw)
    torch.testing.assert_close(o, want[0], rtol=2e-5, atol=2e-5 * float(want[0].abs().max()))


def test_flash_block_on_the_card_raises_rather_than_falls_back(cuda):
    import torch

    from cubed_tpu_torch.kernels.flash_block import flash_block

    q = torch.zeros((1, 8, 1, 300), device=cuda)
    acc = (torch.zeros((1, 1, 8, 300), device=cuda), torch.zeros((1, 1, 8), device=cuda),
           torch.zeros((1, 1, 8), device=cuda))
    before = flash_block.launches
    with pytest.raises(ValueError, match="over 256"):
        flash_block(q, q, q, *acc, q_offset=0, k_offset=0, causal=False, scale=1.0)
    q64 = torch.zeros((1, 8, 1, 8), dtype=torch.float64, device=cuda)
    acc = (torch.zeros((1, 1, 8, 8), device=cuda), acc[1], acc[2])
    with pytest.raises(TypeError, match="kernel takes"):
        flash_block(q64, q64, q64, *acc, q_offset=0, k_offset=0, causal=False, scale=1.0)
    assert flash_block.launches == before


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_on_the_card(cuda, causal):
    """A ring of 4 slots on one card against dense attention: 2e-5, the
    JAX package's own tolerance; then a causal gradient at 2e-4."""
    import torch

    from cubed_tpu_torch.kernels.flash_block import flash_block
    from cubed_tpu_torch.parallel.mesh import make_mesh
    from cubed_tpu_torch.parallel.ring_attention import dense_attention, ring_attention

    mesh = make_mesh(shape=(4,), axis_names=("seq",), devices=[cuda] * 4)
    gen = torch.Generator(device="cpu").manual_seed(3)
    q, k, v = (torch.randn((2, 256, 2, 64), generator=gen).to(cuda).requires_grad_() for _ in range(3))
    before = flash_block.launches
    out = ring_attention(q, k, v, mesh=mesh, causal=causal)
    assert flash_block.launches == before + 16
    torch.testing.assert_close(out.gather(), dense_attention(q, k, v, causal=causal), rtol=0, atol=2e-5)
    grads = torch.autograd.grad((out.gather() ** 2).sum(), (q, k, v))
    want = torch.autograd.grad((dense_attention(q, k, v, causal=causal) ** 2).sum(), (q, k, v))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-4)
