"""``map_overlap`` and ``pad`` of the port, held against the JAX package.

The counterparts of ``tests/test_map_overlap.py`` and of the pad cases of
``tests/test_histogram.py``, and beside them the same plans built in both
packages (``tests/_torch_parity.py``): the plans' tasks, ops and projected
memory, the values on the sequential and the device executor, and
``CudaExecutor``'s path counters against ``JaxExecutor``'s, with every
failed check 0. The stencils sum rolls in the same order in both packages,
so float64 values agree to rtol 1e-12 (the same sums, which XLA may fuse)
and int64 values exactly; pads only move values and are exact. The counters
agree: the reference flushes a resident input before its tasks read it and
the port hands it over as a view on the card, but neither counts that.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402

from ._torch_parity import parity, plan_of, specs  # noqa: E402

BOUNDARIES = [
    ("reflect", "symmetric", {}),
    ("nearest", "edge", {}),
    ("periodic", "wrap", {}),
    (0.0, "constant", {"constant_values": 0.0}),
    (2.5, "constant", {"constant_values": 2.5}),
]


def _roll(pkg):
    if pkg is cubed_tpu:
        return lambda b, shift, axis: jnp.roll(b, shift, axis)
    return lambda b, shift, axis: torch.roll(b, shift, axis)


def _smooth(pkg, divide=True):
    """The nine-point box average (sum, for integers) of a 2-d block."""
    roll = _roll(pkg)

    def smooth(b):
        total = None
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                term = roll(roll(b, i, 0), j, 1)
                total = term if total is None else total + term
        return total / 9.0 if divide else total

    return smooth


def _expected(an, npmode, depth=1, divide=True, **kw):
    pe = np.pad(an, depth, mode=npmode, **kw)
    n, m = an.shape
    total = None
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            term = pe[depth + i:n + depth + i, depth + j:m + depth + j]
            total = term if total is None else total + term
    return total / 9.0 if divide else total


def _ident(b):
    return b


# ---------------------------------------------------------------------------
# the reference test's counterparts (tests/test_map_overlap.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("boundary,npmode,kw", BOUNDARIES, ids=[str(b[0]) for b in BOUNDARIES])
def test_map_overlap_boundaries(tmp_path, boundary, npmode, kw):
    an = np.random.default_rng(0).standard_normal((40, 40))
    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.map_overlap(_smooth(pkg), a, depth=1, boundary=boundary),
                    an, chunks=(10, 10))
    np.testing.assert_allclose(got, _expected(an, npmode, **kw), rtol=1e-12, atol=1e-12)


def test_map_overlap_depth_forms(tmp_path):
    an = np.random.default_rng(1).standard_normal((24, 18))
    for depth in (2, {0: 1}, (2, 0), {-1: 1}):
        got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.map_overlap(_ident, a, depth=depth), an, chunks=(8, 6))
        np.testing.assert_array_equal(got, an)
    a = cubed_tpu_torch.from_array(an, chunks=(8, 6), spec=specs(tmp_path)[1])
    for kwargs, error in (
        (dict(depth=-1), ValueError),
        (dict(depth=100), ValueError),
        (dict(depth=1, boundary="bogus"), ValueError),
        (dict(depth={2: 1}), IndexError),
        (dict(depth=(1, 2, 3)), ValueError),
    ):
        with pytest.raises(error):
            cubed_tpu_torch.map_overlap(_ident, a, **kwargs)
        with pytest.raises(error):
            cubed_tpu.map_overlap(_ident, cubed_tpu.from_array(an, chunks=(8, 6), spec=specs(tmp_path)[0]),
                                  **kwargs)


def test_map_overlap_ragged_chunks(tmp_path):
    an = np.random.default_rng(2).standard_normal((23, 17))
    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.map_overlap(_smooth(pkg), a, depth=1), an, chunks=(7, 5))
    np.testing.assert_allclose(got, _expected(an, "symmetric"), rtol=1e-12, atol=1e-12)


def test_map_overlap_on_device_executor(tmp_path):
    an = np.random.default_rng(3).standard_normal((20, 20))
    spec = specs(tmp_path)[1]
    a = cubed_tpu_torch.from_array(an, chunks=(5, 5), spec=spec)
    got = cubed_tpu_torch.map_overlap(_smooth(cubed_tpu_torch), a, depth=1).compute(executor=CudaExecutor())
    np.testing.assert_allclose(got, _expected(an, "symmetric"), rtol=1e-12, atol=1e-12)


def test_map_overlap_trim_false_grows_chunks(tmp_path):
    an = np.arange(48, dtype=np.float64).reshape(8, 6)
    a = cubed_tpu_torch.from_array(an, chunks=(4, 3), spec=specs(tmp_path)[1])
    r = cubed_tpu_torch.map_overlap(_ident, a, depth=1, boundary="nearest", trim=False)
    assert r.chunks == ((6, 6), (5, 5))
    assert r.shape == (12, 10)
    got = r.compute()
    pe = np.pad(an, 1, mode="edge")
    for bi, r0 in enumerate((0, 4)):
        for bj, c0 in enumerate((0, 3)):
            np.testing.assert_array_equal(got[bi * 6:(bi + 1) * 6, bj * 5:(bj + 1) * 5], pe[r0:r0 + 6, c0:c0 + 5])
    r2 = cubed_tpu_torch.map_overlap(_ident, a, depth={0: 2}, trim=False)
    assert r2.chunks == ((8, 8), (3, 3))
    assert r2.shape == (16, 6)
    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.map_overlap(_ident, a, depth=1, boundary="nearest", trim=False),
                    an, chunks=(4, 3))


def test_map_overlap_1d_diffusion_step(tmp_path):
    an = np.random.default_rng(4).standard_normal(1000)

    def step(pkg):
        roll = _roll(pkg)
        return lambda b: b + 0.1 * (roll(b, 1, 0) - 2 * b + roll(b, -1, 0))

    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.map_overlap(step(pkg), a, depth=1, boundary="periodic"),
                    an, chunks=(100,))
    expect = an + 0.1 * (np.roll(an, 1) - 2 * an + np.roll(an, -1))
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# every boundary with trim both ways, float64 and int64, ragged chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trim", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "int64"])
@pytest.mark.parametrize("boundary,npmode,kw", BOUNDARIES, ids=[str(b[0]) for b in BOUNDARIES])
def test_map_overlap_matrix(tmp_path, boundary, npmode, kw, dtype, trim):
    rng = np.random.default_rng(5)
    an = rng.standard_normal((13, 11)) if dtype == "float64" else rng.integers(-50, 50, (13, 11))
    divide = dtype == "float64"

    def build(xp, pkg, a):
        return pkg.map_overlap(_smooth(pkg, divide), a, depth=(1, 2), boundary=boundary, trim=trim)

    got, ref = parity(tmp_path, build, an, chunks=(5, 4))
    assert got.dtype == np.dtype(dtype)
    if trim:
        # depth 2 along axis 1, the stencil reaching one element: the
        # reference's np.pad with the input's dtype (a constant cast to it)
        pe = np.pad(an, ((1, 1), (2, 2)), mode=npmode, **kw)
        want = None
        for i in (-1, 0, 1):
            for j in (-1, 0, 1):
                term = pe[1 + i:14 + i, 2 + j:13 + j]
                want = term if want is None else want + term
        want = want / 9.0 if divide else want
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        assert got.shape == (13 + 3 * 2, 11 + 3 * 4)


def test_map_overlap_projected_memory_is_the_reference_formula(tmp_path):
    """The extra memory is exactly 4 * prod(chunksize + 2 * depth) *
    max(itemsize): here against the same op at depth 0."""
    an = np.zeros((20, 30), dtype=np.int32)
    rs, ps = specs(tmp_path)

    def projected(depth):
        p = cubed_tpu_torch.map_overlap(_ident, cubed_tpu_torch.from_array(an, chunks=(6, 7), spec=ps),
                                        depth=depth, dtype=np.float64)
        r = cubed_tpu.map_overlap(_ident, cubed_tpu.from_array(an, chunks=(6, 7), spec=rs), depth=depth,
                                  dtype=np.float64)
        assert plan_of(p) == plan_of(r)
        return plan_of(p)[2]

    # the wider itemsize is the output's float64
    assert projected((2, 3)) - projected(0) == 4 * ((6 + 4) * (7 + 6) - 6 * 7) * 8


def test_map_overlap_reads_a_resident_input_on_the_card_without_a_flush(tmp_path):
    """On CudaExecutor the map_overlap task body reads its resident input as
    a view (``device_reads``): the input's store is never written."""
    an = np.random.default_rng(6).standard_normal((12, 15))
    spec = specs(tmp_path)[1]
    a = cubed_tpu_torch.from_array(an, chunks=(4, 5), spec=spec)
    b = pxp.multiply(a, 2.0)
    out = cubed_tpu_torch.map_overlap(_smooth(cubed_tpu_torch), b, depth=1, boundary="periodic")
    ex = CudaExecutor()
    got = out.compute(executor=ex)
    np.testing.assert_allclose(got, _expected(an * 2.0, "wrap"), rtol=1e-12, atol=1e-12)
    assert not os.path.exists(b.zarray_maybe_lazy.store)
    assert ex.stats["chunked_ops"] == 1 and ex.stats["eager_fallbacks"] == 0
    # the sequential executor writes it, as every intermediate
    out.compute()
    assert os.path.exists(b.zarray_maybe_lazy.store)


@pytest.mark.parametrize("dtype", [np.int8, np.uint16, np.int32, np.float32, np.bool_])
def test_halo_padding_takes_every_dtype(dtype):
    from cubed_tpu_torch.backend_array_api import numpy_array_to_backend_array
    from cubed_tpu_torch.core.ops import _pad_halo

    an = (np.arange(12).reshape(3, 4) % 5).astype(dtype)
    pads = [(2, 1), (1, 3)]
    t = numpy_array_to_backend_array(an)
    for boundary, mode, fill in (("reflect", "symmetric", None), ("nearest", "edge", None)):
        got = _pad_halo(t, pads, boundary, fill)
        np.testing.assert_array_equal(np.asarray(got).astype(dtype), np.pad(an, pads, mode=mode))
    cast = np.zeros((), dtype=dtype)
    cast[()] = 1.0
    got = _pad_halo(t, pads, 1.0, cast.item())
    np.testing.assert_array_equal(np.asarray(got).astype(dtype), np.pad(an, pads, constant_values=cast))


# ---------------------------------------------------------------------------
# pad (tests/test_histogram.py:118-163)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pw", [0, 2, (1, 3), ((1, 2), (0, 3)), [(2, 0), 1], ((0, 0), (0, 0))])
@pytest.mark.parametrize("mode", ["constant", "edge"])
def test_pad_against_np_pad(tmp_path, pw, mode):
    an = np.arange(24.0).reshape(4, 6)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.pad(a, pw, mode=mode), an, chunks=(2, 3))
    np.testing.assert_array_equal(got, np.pad(an, [(w, w) if isinstance(w, int) else w for w in pw]
                                              if isinstance(pw, list) else pw, mode=mode))


@pytest.mark.parametrize("dtype", ["int64", "float32", "bool"])
def test_pad_constant_values_and_dtypes(tmp_path, dtype):
    an = (np.arange(30).reshape(5, 6) % 4).astype(dtype)
    value = True if dtype == "bool" else 9
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.pad(a, ((2, 1), (1, 2)), constant_values=value), an,
                    chunks=(2, 4))
    np.testing.assert_array_equal(got, np.pad(an, ((2, 1), (1, 2)), constant_values=value))
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.pad(a, 2, mode="edge"), an, chunks=(2, 4))
    np.testing.assert_array_equal(got, np.pad(an, 2, mode="edge"))


def test_pad_validation(tmp_path):
    a = cubed_tpu_torch.from_array(np.arange(24.0).reshape(4, 6), chunks=(2, 3), spec=specs(tmp_path)[1])
    with pytest.raises(NotImplementedError):
        pxp.pad(a, 1, mode="reflect")
    with pytest.raises(ValueError):
        pxp.pad(a, -1)
    with pytest.raises(ValueError):
        pxp.pad(a, ((1, 1),))
    with pytest.raises(ValueError):
        pxp.pad(a, (1, 2, 3))
    empty = cubed_tpu_torch.from_array(np.zeros((0, 3)), chunks=(1, 3), spec=specs(tmp_path)[1])
    with pytest.raises(ValueError, match="empty axis"):
        pxp.pad(empty, 1, mode="edge")


def test_broadcast_of_an_edge_row_on_the_device_executor(tmp_path):
    """An edge pad broadcasts a one-row slice: no input follows the row axis
    of the output's grid, so its blocks are computed once and repeated (the
    batched route used to hand torch.func.vmap a level with no input)."""
    an = np.arange(24.0).reshape(4, 6)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.broadcast_to(a[0:1], (3, 6)), an, chunks=(2, 3))
    np.testing.assert_array_equal(got, np.broadcast_to(an[0:1], (3, 6)))


def test_pad_keeps_chunk_granularity(tmp_path):
    an = np.arange(1000.0)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.pad(a, 1), an, chunks=(250,))
    p = pxp.pad(cubed_tpu_torch.from_array(an, chunks=(250,), spec=specs(tmp_path)[1]), 1)
    assert p.numblocks[0] <= 6, p.chunks
    np.testing.assert_array_equal(got, np.pad(an, 1))
