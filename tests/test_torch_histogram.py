"""The port's chunked histogram, ``cov``/``corrcoef`` and ``linalg``'s
``diagonal``/``trace`` against the JAX package's, on the CPU, case for case
as ``tests/test_histogram.py`` (and ``tests/test_linalg.py``'s diagonal and
trace cases) hold the reference: plans (tasks, ops, projected memory),
values against numpy and the reference, and ``CudaExecutor``'s path
counters against ``JaxExecutor``'s, every failed check 0
(``tests/_torch_parity.py``).

Tolerances: counts exact; unweighted edges and densities rtol 1e-12;
weighted counts rtol 1e-12 against the reference (each block's weights add
in one order on the CPU; on the card ``index_add_``'s atomics add them in
any order) and atol 1e-10 against numpy (its cumulative sums round
differently), as the reference's tests hold it; ``cov``/``corrcoef`` rtol
1e-12 against the reference, atol 1e-10 against numpy.
"""

import numpy as np
import pytest

import cubed_tpu_torch
import cubed_tpu_torch.array_api as pxp

from ._torch_parity import parity, specs


def _counts(out):
    return out[0]


def _edges(out):
    return out[1]


def test_histogram_implicit_range_lazy_minmax(tmp_path):
    an = np.random.default_rng(0).standard_normal(5000)
    hx, ex = np.histogram(an, bins=16)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.histogram(a, bins=16), an, chunks=(500,), pick=_edges,
                    executors=False)
    np.testing.assert_allclose(got, ex, atol=1e-12)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.histogram(a, bins=16), an, chunks=(500,), pick=_counts)
    np.testing.assert_array_equal(got, hx)


def test_histogram_range_edges_weights_density(tmp_path):
    an = np.random.default_rng(1).standard_normal(3000)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.histogram(a, bins=8, range=(-2, 2)), an, chunks=(400,),
                    pick=_counts, executors=False)
    np.testing.assert_array_equal(got, np.histogram(an, bins=8, range=(-2, 2))[0])
    edges = np.linspace(-3, 3, 13)
    got, _ = parity(tmp_path, lambda xp, pkg, a, w: xp.histogram(a, bins=edges, weights=w), an, np.abs(an),
                    chunks=(400,), pick=_counts)
    np.testing.assert_allclose(got, np.histogram(an, bins=edges, weights=np.abs(an))[0], atol=1e-10)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.histogram(a, bins=edges, density=True), an, chunks=(400,),
                    pick=_counts, executors=False)
    np.testing.assert_allclose(got, np.histogram(an, bins=edges, density=True)[0], atol=1e-12)


def test_histogram_2d_input_and_degenerate(tmp_path):
    an = np.random.default_rng(2).standard_normal((40, 30))
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.histogram(a, bins=5), an, chunks=(10, 10), pick=_counts,
                    executors=False)
    np.testing.assert_array_equal(got, np.histogram(an, bins=5)[0])
    # all-equal values: numpy's +-0.5 fix-up of a degenerate range
    cn = np.full(64, 3.0)
    got, _ = parity(tmp_path, lambda xp, pkg, c: xp.histogram(c, bins=4), cn, chunks=(16,), pick=_counts,
                    executors=False)
    np.testing.assert_array_equal(got, np.histogram(cn, bins=4)[0])
    got, _ = parity(tmp_path, lambda xp, pkg, c: xp.histogram(c, bins=4), cn, chunks=(16,), pick=_edges,
                    executors=False)
    np.testing.assert_allclose(got, np.histogram(cn, bins=4)[1], atol=1e-12)


def test_histogram_on_the_device_executor(tmp_path):
    an = np.random.default_rng(3).standard_normal(2000)
    an[::97] = np.nan  # outside every bin with explicit edges, as numpy
    edges = np.linspace(-3, 3, 10)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.histogram(a, bins=edges), an, chunks=(250,), pick=_counts)
    np.testing.assert_array_equal(got, np.histogram(an, bins=edges)[0])


def test_histogram_last_bin_closed_and_outside(tmp_path):
    """A value on the last edge counts in the last bin; below the first or
    above the last edge, in none."""
    an = np.array([0.0, 0.5, 1.0, 1.0, -0.1, 1.1, 0.25, 0.75])
    edges = [0.0, 0.25, 0.5, 1.0]
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.histogram(a, bins=edges), an, chunks=(3,), pick=_counts)
    np.testing.assert_array_equal(got, np.histogram(an, bins=edges)[0])


def test_histogram_validation(tmp_path):
    ps = specs(tmp_path)[1]
    a = cubed_tpu_torch.from_array(np.ones(8), chunks=(4,), spec=ps)
    with pytest.raises(ValueError):
        pxp.histogram(a, bins=0)
    with pytest.raises(ValueError):
        pxp.histogram(a, bins=[3.0, 2.0, 1.0])  # not monotonic
    with pytest.raises(ValueError):
        pxp.histogram(a, bins=4, range=(2, 1))
    w = cubed_tpu_torch.from_array(np.ones(5), chunks=(5,), spec=ps)
    with pytest.raises(ValueError, match="weights"):
        pxp.histogram(a, bins=4, weights=w)


def test_cov_corrcoef(tmp_path):
    mn = np.random.default_rng(4).standard_normal((4, 300))
    got, _ = parity(tmp_path, lambda xp, pkg, m: xp.cov(m), mn, chunks=(2, 50))
    np.testing.assert_allclose(got, np.cov(mn), atol=1e-10)
    got, _ = parity(tmp_path, lambda xp, pkg, m: xp.cov(m, rowvar=False), mn, chunks=(2, 50), executors=False)
    np.testing.assert_allclose(got, np.cov(mn, rowvar=False), atol=1e-10)
    got, _ = parity(tmp_path, lambda xp, pkg, m: xp.corrcoef(m), mn, chunks=(2, 50))
    np.testing.assert_allclose(got, np.corrcoef(mn), atol=1e-10)
    got, _ = parity(tmp_path, lambda xp, pkg, m: xp.cov(m, ddof=0), mn, chunks=(2, 50), executors=False)
    np.testing.assert_allclose(got, np.cov(mn, ddof=0), atol=1e-10)


@pytest.mark.parametrize("offset", [0, 1, -2])
def test_diagonal_trace(tmp_path, offset):
    an = np.arange(30, dtype=np.float64).reshape(5, 6)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.linalg.diagonal(a, offset=offset), an, chunks=(2, 2),
                    executors=offset == 1)
    np.testing.assert_array_equal(got, np.diagonal(an, offset=offset))
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.linalg.trace(a, offset=offset), an, chunks=(2, 2),
                    executors=False)
    assert float(got) == np.trace(an, offset=offset)


def test_diagonal_with_nonfinite_and_bool(tmp_path):
    # inf and NaN off the diagonal must not poison it (where, not a product)
    an = np.array([[1.0, np.inf], [np.nan, 4.0]])
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.linalg.diagonal(a), an, chunks=(2, 2), executors=False)
    np.testing.assert_array_equal(got, [1.0, 4.0])
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.linalg.trace(a), an, chunks=(2, 2), executors=False)
    assert float(got) == 5.0
    bn = np.array([[True, False], [True, True]])
    got, _ = parity(tmp_path, lambda xp, pkg, b: xp.linalg.diagonal(b), bn, chunks=(2, 2), executors=False)
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, np.diagonal(bn))


def test_diagonal_out_of_range_offset_is_empty(tmp_path):
    an = np.ones((3, 4))
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.linalg.diagonal(a, offset=10), an, chunks=(3, 4),
                    executors=False)
    assert got.shape == (0,)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.linalg.trace(a, offset=10), an, chunks=(3, 4), executors=False)
    assert float(got) == 0.0


def test_linalg_exports_only_what_is_ported():
    import cubed_tpu.array_api as rxp

    assert pxp.linalg.__all__ == rxp.linalg.__all__
