"""Batched block generation (``kernels/philox_uniform.py``:
``philox_keys``, ``philox_uniform_blocks``; ``kernels/_geometry.py``:
``blocks_plan``, ``blocks_walk``), on the CPU.

- ``philox_keys`` derives every block key of an op at once; it must equal
  numpy's own ``Philox(seed).state`` key bit for bit.
- ``philox_uniform_blocks_plain`` (the CPU route of the batched kernel) must
  equal the JAX package's ``random`` array bit for bit, with the stdlib
  generator seeded alike.
- The batched CUDA kernel runs only on the card, but its work split is
  planned in pure Python: ``blocks_walk`` replays it store by store, and
  every element must be written exactly once, by the right block, counter
  and word. A plan with its tile division, its edge clamp or its
  vector-or-scalar choice broken must fail that replay.
- The device executor takes the batched route for ``random`` as the
  reference's ``JaxExecutor`` does, bitwise equal; a random op fused into
  its consumer does not.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import dataclasses  # noqa: E402
import itertools  # noqa: E402
import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.chunks import blockdims_from_blockshape  # noqa: E402
from cubed_tpu_torch.kernels import _geometry  # noqa: E402
from cubed_tpu_torch.kernels.philox_uniform import (  # noqa: E402
    philox_key,
    philox_keys,
    philox_uniform,
    philox_uniform_blocks,
    philox_uniform_blocks_plain,
)
from cubed_tpu_torch.random import _random_block, _random_blocks  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402

# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

#: 10,003 seeds: a run from 0, a run across 2**30 (root seeds are 30-bit, so
#: block seeds cross it), a batch straddling 2**32 (one and two entropy
#: words), and 2**63 and 2**64 - 1
KEY_SEEDS = np.concatenate([
    np.arange(0, 4000, dtype=np.uint64),
    np.uint64(2**30 - 2000) + np.arange(4000, dtype=np.uint64),
    np.uint64(2**32 - 1000) + np.arange(2000, dtype=np.uint64),
    np.array([2**63, 2**63 + 1, 2**64 - 1], dtype=np.uint64),
])


def _numpy_key(seed: int) -> np.ndarray:
    return np.random.Philox(seed=int(seed)).state["state"]["key"]


def test_philox_keys_equal_numpy_for_ten_thousand_seeds():
    keys = philox_keys(KEY_SEEDS)
    assert keys.shape == (KEY_SEEDS.size, 2) and keys.dtype == np.uint64
    ref = np.stack([_numpy_key(s) for s in KEY_SEEDS])
    np.testing.assert_array_equal(keys, ref)


@pytest.mark.parametrize("seeds", [
    np.arange(5, dtype=np.int64),                      # int64, as VirtualOffsetsArray holds them
    [2**32 - 1, 2**32],                                # Python ints, one and two words
    [2**64, 2**64 + 7, 5, 2**130 + 3],                 # past 64 bits: three and five words
    np.array([], dtype=np.int64),
], ids=["int64", "straddle-2**32", "past-64-bits", "empty"])
def test_philox_keys_group_seeds_by_word_count(seeds):
    keys = philox_keys(seeds)
    ref = np.array([_numpy_key(s) for s in seeds], dtype=np.uint64).reshape(-1, 2)
    np.testing.assert_array_equal(keys, ref)


def test_philox_key_is_philox_keys_of_one_seed():
    for seed in (0, 2**30 + 17, 2**32 + 5):
        assert philox_key(seed) == tuple(int(k) for k in _numpy_key(seed))


@pytest.mark.parametrize("bad, error", [([-1], ValueError), ([0.5], TypeError)])
def test_philox_keys_reject_what_numpy_rejects(bad, error):
    with pytest.raises(error):
        philox_keys(bad)


# ---------------------------------------------------------------------------
# the plain batched version against the JAX package
# ---------------------------------------------------------------------------

#: (shape, chunks): ragged edges, a last extent not a multiple of 4, 1-D, a
#: size-0 array, a grid whose full blocks take 16-byte stores and whose edge
#: does not, 4-D, one block
CASES = [
    ((13, 11), (4, 5)),
    ((7,), (3,)),
    ((0, 5), (2, 2)),
    ((20, 30), (10, 7)),
    ((9, 10, 11), (4, 4, 4)),
    ((8, 14), (4, 8)),
    ((12, 16), (5, 8)),
    ((2, 3, 4, 5), (1, 2, 3, 4)),
    ((50, 45, 40), (10, 10, 20)),
    ((8, 8), (8, 8)),
]
IDS = ["x".join(map(str, s)) + "/" + "x".join(map(str, c)) for s, c in CASES]


def _chunkset(shape, chunks):
    return blockdims_from_blockshape(shape, chunks)


def _nblocks(shape, chunks) -> int:
    return int(np.prod([len(c) for c in _chunkset(shape, chunks)]))


def _root_and_reference(tmp_path, shape, chunks, seed):
    """The JAX package's random array, and the root seed it drew."""
    random.seed(seed)
    root = random.getrandbits(30)
    random.seed(seed)
    spec = cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="100MB")
    ref = np.asarray(cubed_tpu.random.random(shape, chunks=chunks, spec=spec).compute())
    return root, ref


@pytest.mark.parametrize("shape, chunks", CASES, ids=IDS)
def test_plain_blocks_equal_the_jax_package_bitwise(tmp_path, shape, chunks):
    root, ref = _root_and_reference(tmp_path, shape, chunks, seed=sum(shape) + 3)
    keys = philox_keys(root + np.arange(_nblocks(shape, chunks), dtype=np.int64))
    got = philox_uniform_blocks_plain(shape, chunks, keys).numpy()
    assert got.shape == ref.shape == shape and got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.uint64), ref.view(np.uint64))


@pytest.mark.parametrize("shape, chunks", CASES, ids=IDS)
def test_batched_cpu_route_equals_per_block_route(shape, chunks):
    """``_random_blocks`` (the executor's batched route) against the block
    function it stands for, applied block by block."""
    root = 12345
    whole = _random_blocks(shape, chunks, root, torch.device("cpu"))
    chunkset = _chunkset(shape, chunks)
    for k, idx in enumerate(itertools.product(*(range(len(c)) for c in chunkset))):
        sel = tuple(slice(sum(c[:i]), sum(c[:i + 1])) for c, i in zip(chunkset, idx))
        bshape = tuple(c[i] for c, i in zip(chunkset, idx))
        block = _random_block(torch.empty(bshape, dtype=torch.float64), np.full((1,) * len(shape), root + k))
        assert torch.equal(whole[sel], block)


def test_blocks_wrapper_checks_its_arguments():
    out = torch.empty((6, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="keys"):
        philox_uniform_blocks(out, (3, 2), philox_keys(np.arange(3)))
    with pytest.raises(ValueError, match="float64"):
        philox_uniform_blocks(out.half(), (3, 2), philox_keys(np.arange(4)))
    with pytest.raises(ValueError, match="chunks"):
        philox_uniform_blocks(out, (3,), philox_keys(np.arange(2)))


def test_cpu_route_counts_no_launch():
    before, paths = philox_uniform.launches, dict(philox_uniform.paths)
    philox_uniform_blocks(torch.empty((6, 4), dtype=torch.float64), (3, 2), philox_keys(np.arange(4)))
    assert philox_uniform.launches == before and philox_uniform.paths == paths


# ---------------------------------------------------------------------------
# the work split, replayed store by store
# ---------------------------------------------------------------------------


def _c_strides(shape):
    out, s = [], 1
    for n in reversed(shape):
        out.append(s)
        s *= n
    return tuple(reversed(out))


def _expected(shape, chunks):
    """(block, counter, word) of each element, in C order of the array."""
    blk, ctr, wd = (np.empty(shape, np.int64) for _ in range(3))
    chunkset = _chunkset(shape, chunks)
    for b, idx in enumerate(itertools.product(*(range(len(c)) for c in chunkset))):
        sel = tuple(slice(sum(c[:i]), sum(c[:i + 1])) for c, i in zip(chunkset, idx))
        j = np.arange(int(np.prod([c[i] for c, i in zip(chunkset, idx)]))).reshape(blk[sel].shape)
        blk[sel], ctr[sel], wd[sel] = b, j // 4, j % 4
    return blk.reshape(-1), ctr.reshape(-1), wd.reshape(-1)


def _replay_matches(p, shape, strides, chunks) -> bool:
    """Whether the replay of *p* writes each element of the strided output
    exactly once, with its own block, counter and word."""
    off, blk, ctr, wd = _geometry.blocks_walk(torch, p)
    n = int(np.prod(shape))
    if off.numel() != n:
        return False
    grid = np.indices(shape).reshape(len(shape), -1) if shape else np.zeros((0, 1), np.int64)
    want_off = (np.asarray(strides)[:, None] * grid).sum(axis=0) if n else np.zeros(0, np.int64)
    order = torch.argsort(off).numpy()
    want_order = np.argsort(want_off, kind="stable")
    if not np.array_equal(off.numpy()[order], want_off[want_order]):
        return False
    eb, ec, ew = _expected(shape, chunks)
    return all(np.array_equal(got.numpy()[order], want[want_order])
               for got, want in ((blk, eb), (ctr, ec), (wd, ew)))


#: (shape, strides or None for C order, address): C-order outputs, a
#: column view of a wider array (16-byte aligned rows), a misaligned base,
#: a last axis of stride 2
LAYOUTS = [(s, c, None, 0) for s, c in CASES] + [
    ((8, 16), (4, 8), (24, 1), 256),
    ((8, 16), (4, 8), None, 8),
    ((6, 8), (3, 4), (16, 2), 0),
]
LAYOUT_IDS = IDS + ["column-view", "misaligned", "last-stride-2"]


def _plan(shape, chunks, strides, ptr, **kw):
    return _geometry.blocks_plan(shape, strides or _c_strides(shape), chunks, ptr, **kw)


@pytest.mark.parametrize("shape, chunks, strides, ptr", LAYOUTS, ids=LAYOUT_IDS)
def test_block_plan_replay_writes_every_element_once(shape, chunks, strides, ptr):
    p = _plan(shape, chunks, strides, ptr, sms=3)
    assert _replay_matches(p, shape, strides or _c_strides(shape), chunks)
    assert p.grid == min(p.items, 3 * _geometry.PHILOX_CTAS_PER_SM)


def test_block_plan_store_paths():
    vector = _plan((40, 32), (20, 16), None, 0)
    assert (vector.vector_full, vector.vector_edge, vector.paths) == (True, True, ("vector",))
    mixed = _plan((8, 14), (4, 8), None, 0)  # edge blocks are 6 wide
    assert (mixed.vector_full, mixed.vector_edge, mixed.paths) == (True, False, ("vector", "scalar"))
    for strides, ptr in [(None, 8), ((16, 2), 0), ((9, 1), 0)]:
        assert _plan((6, 8), (3, 4), strides, ptr).paths == ("scalar",)


def test_main_path_plan_takes_16_byte_stores_everywhere():
    p = _plan((500, 450, 400), (100, 100, 100), None, 0, sms=132, ctas_per_sm=3)
    assert (p.vector_full, p.vector_edge) == (True, True)
    assert p.per_block[0] == -(-250_000 // _geometry.PHILOX_TILE) and p.items == 100 * p.per_block[0]
    assert p.grid == 396
    assert [d for d, _, _ in p.edges] == [1, 100, 50, 100]


@pytest.mark.parametrize("shape, chunks, strides, ptr", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("itemsize", [8, 4], ids=["f64", "f32"])
def test_block_plan_vector_stores_are_16_byte_aligned(shape, chunks, strides, ptr, itemsize):
    """Every counter a 16-byte store writes starts on a 16-byte boundary, for
    float64 (two double2) and float32 (one float4) outputs alike; the replay
    still writes every element once."""
    p = _plan(shape, chunks, strides, ptr, itemsize=itemsize)
    assert _replay_matches(p, shape, strides or _c_strides(shape), chunks)
    off, blk, _, wd = _geometry.blocks_walk(torch, p)
    nb_last = p.numblocks[-1][0]
    vector = torch.where(blk % nb_last == nb_last - 1, p.vector_edge, p.vector_full)
    starts = off[vector & (wd == 0)]
    assert ((ptr + starts * itemsize) % 16 == 0).all()


def test_block_plan_store_paths_of_float32_outputs():
    """A float32 row of 16 bytes is 4 elements: row strides and block origins
    along the last axis must be multiples of 4, not of 2."""
    assert _plan((40, 32), (20, 16), None, 0, itemsize=4).paths == ("vector",)
    # rows 18 elements apart: 144 B (float64, aligned), 72 B (float32, not)
    assert _plan((6, 8), (3, 4), (18, 1), 0, itemsize=8).paths == ("vector",)
    assert _plan((6, 8), (3, 4), (18, 1), 0, itemsize=4).paths == ("scalar",)
    # the edge block starts 6 elements in: 48 B (aligned), 24 B (not)
    f64, f32 = (_plan((4, 10), (4, 6), None, 0, itemsize=n) for n in (8, 4))
    assert (f64.vector_full, f64.vector_edge) == (False, True)
    assert (f32.vector_full, f32.vector_edge) == (False, False)
    main = _plan((500, 450, 400), (100, 100, 100), None, 0, sms=132, ctas_per_sm=3, itemsize=4)
    assert (main.vector_full, main.vector_edge) == (True, True)


def _mutations(p):
    """Plans with one piece of the split broken."""
    d = p.per_block[0]
    yield "tile division", dataclasses.replace(p, per_block=(d, *_geometry.fast_divmod(d + 1)))
    yield "items per block", dataclasses.replace(p, per_block=_geometry._div(d - 1) if d > 1 else (1, 0, 0),
                                                 items=p.items - p.items // d if d > 1 else p.items - 1)
    yield "edge clamp", dataclasses.replace(p, edges=p.chunks)
    yield "vector choice", dataclasses.replace(p, vector_full=True, vector_edge=True)


@pytest.mark.parametrize("shape, chunks", [((13, 11), (4, 5)), ((9, 10, 11), (4, 4, 4)), ((8, 14), (4, 8))],
                         ids=["13x11/4x5", "9x10x11/4", "8x14/4x8"])
def test_broken_block_plans_fail_the_replay(shape, chunks):
    p = _plan(shape, chunks, None, 0)
    strides = _c_strides(shape)
    assert _replay_matches(p, shape, strides, chunks)
    broken = [name for name, q in _mutations(p) if _replay_matches(q, shape, strides, chunks)]
    assert broken == []


def test_block_plan_checks_32_bit_offsets_and_rank():
    with pytest.raises(ValueError, match="32 bits"):
        _plan((2**16, 2**15), (1024, 1024), None, 0)
    with pytest.raises(ValueError, match="rank"):
        _plan((2,) * 5, (1,) * 5, None, 0)
    assert _geometry.blocks_fit((500, 450, 400)) and not _geometry.blocks_fit((2**16, 2**15))
    assert not _geometry.blocks_fit((2,) * 5)


# ---------------------------------------------------------------------------
# the device executor's batched route
# ---------------------------------------------------------------------------


def _ref_and_port(tmp_path, build, seed, device_mem=None):
    """(reference value on JaxExecutor, its executor, port value on
    CudaExecutor, its executor), from the same seeds."""
    jax_executor_module._STRUCT_CACHE.clear()
    ref_ex, port_ex = JaxExecutor(), CudaExecutor(device_mem=device_mem)
    random.seed(seed)
    ref = build(cubed_tpu, rxp, cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB"))
    ref_value = np.asarray(ref.compute(executor=ref_ex))
    random.seed(seed)
    port = build(cubed_tpu_torch, pxp, cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB"))
    return ref_value, ref_ex, port.compute(executor=port_ex), port_ex


@pytest.mark.parametrize("shape, chunks", [((50, 45, 40), 10), ((13, 11), (4, 5)), ((7,), 3)],
                         ids=["50x45x40/10", "13x11/4x5", "7/3"])
def test_random_on_the_device_executor_equals_jax_executor_bitwise(tmp_path, shape, chunks):
    def build(pkg, xp, spec):
        return pkg.random.random(shape, chunks=chunks, spec=spec)

    ref, _, got, ex = _ref_and_port(tmp_path, build, seed=21)
    np.testing.assert_array_equal(got.view(np.uint64), ref.view(np.uint64))
    # one launch for the whole array, ragged grids included
    assert ex.stats["batched_ops"] == 1
    assert ex.stats["chunked_ops"] == 0 and ex.stats["eager_fallbacks"] == 0


def test_fused_random_ops_keep_the_chunked_route(tmp_path):
    """addsum: both random ops fuse into the add and the sum's first step. A
    fused function does not inherit the ``batched`` hint, so the fused op
    does not take the whole-array Philox form; it takes the general batched
    route, as the reference batches it (its random leaves under vmap go to
    the Philox batching rule), and the combines stay chunked."""
    def build(pkg, xp, spec):
        a = pkg.random.random((50, 50), chunks=10, spec=spec)
        b = pkg.random.random((50, 50), chunks=10, spec=spec)
        return xp.sum(xp.add(a, b))

    ref, ref_ex, got, ex = _ref_and_port(tmp_path, build, seed=22)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    assert ex.stats["batched_ops"] == ref_ex.stats["batched_ops"] == 1
    assert ex.stats["eager_fallbacks"] == 0
    assert ex.stats["chunked_ops"] == ref_ex.stats["chunked_ops"] >= 1


def test_a_random_array_over_the_budget_counts_a_fallback(tmp_path):
    def build(pkg, xp, spec):
        return pkg.random.random((30, 20), chunks=10, spec=spec)

    ref, _, got, ex = _ref_and_port(tmp_path, build, seed=23, device_mem=30 * 20 * 8 - 1)
    np.testing.assert_array_equal(got, ref)
    assert ex.stats["batched_ops"] == 0
    assert ex.stats["batched_errors"] == ex.stats["eager_fallbacks"] == 1
    assert ex.stats["chunked_ops"] == 1


def test_a_one_block_random_array_is_not_batched(tmp_path):
    def build(pkg, xp, spec):
        return pkg.random.random((6, 5), chunks=10, spec=spec)

    ref, ref_ex, got, ex = _ref_and_port(tmp_path, build, seed=24)
    np.testing.assert_array_equal(got, ref)
    assert ex.stats["batched_ops"] == ref_ex.stats["batched_ops"] == 0
    assert ex.stats["chunked_ops"] == 1 and ex.stats["eager_fallbacks"] == 0
