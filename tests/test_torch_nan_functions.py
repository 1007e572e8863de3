"""The port's NaN-aware reductions (``cubed_tpu_torch.nanmean``,
``nansum``, ``nanmax``, ``nanmin``) against the JAX package's, on the CPU,
case for case as ``tests/test_nan_functions.py`` holds the reference: plans
(tasks, ops, projected memory), values against numpy and the reference,
and ``CudaExecutor``'s path counters against ``JaxExecutor``'s, every failed
check 0 (``tests/_torch_parity.py``).

Tolerances: sums and means rtol 1e-12 against the reference (against
numpy the default rtol 1e-7, as the reference's tests hold it); extrema
and integers exact; float32 rtol 1e-6.
"""

import warnings

import numpy as np
import pytest

import cubed_tpu_torch

from ._torch_parity import parity, specs

NANS = np.array([[1.0, np.nan, 3.0], [np.nan, 5.0, 6.0]])


@pytest.mark.parametrize("axis", [None, 0])
def test_nansum(tmp_path, axis):
    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nansum(a, axis=axis), NANS, chunks=(1, 2))
    np.testing.assert_allclose(got, np.nansum(NANS, axis=axis))


@pytest.mark.parametrize("axis", [None, 1])
def test_nanmean(tmp_path, axis):
    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nanmean(a, axis=axis), NANS, chunks=(1, 2))
    np.testing.assert_allclose(got, np.nanmean(NANS, axis=axis))


def test_nanmean_all_nan_block(tmp_path):
    an = np.array([[np.nan, np.nan], [1.0, 2.0]])
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nanmean(a, axis=1), an, chunks=(1, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        np.testing.assert_allclose(got, np.nanmean(an, axis=1))


def test_nansum_int_passthrough(tmp_path):
    an = np.arange(6)
    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nansum(a), an, chunks=3)
    assert int(got) == an.sum()


def test_nanmax_nanmin(tmp_path):
    an = np.array([[1.0, np.nan, 3.0], [np.nan, np.nan, np.nan], [-2.0, 5.0, np.nan]])
    # the port is warning-free: computed outside any suppression
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got_max1, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nanmax(a, axis=1), an, chunks=(2, 2))
        got_min0, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nanmin(a, axis=0), an, chunks=(2, 2),
                             executors=False)
        got_max, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nanmax(a), an, chunks=(2, 2), executors=False)
        got_min, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nanmin(a), an, chunks=(2, 2), executors=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        np.testing.assert_array_equal(got_max1, np.nanmax(an, axis=1))
        np.testing.assert_array_equal(got_min0, np.nanmin(an, axis=0))
        assert float(got_max) == np.nanmax(an) and float(got_min) == np.nanmin(an)


def test_nanmax_all_nan_region_is_nan(tmp_path):
    an = np.full((4, 4), np.nan)
    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nanmax(a, axis=0), an, chunks=(2, 2), executors=False)
    assert np.isnan(got).all()


def test_nanmax_int_dtype(tmp_path):
    an = np.arange(12, dtype=np.int32).reshape(3, 4)
    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nanmax(a, axis=0), an, chunks=(2, 2))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, an.max(axis=0))


def test_nanmax_rejects_complex(tmp_path):
    a = cubed_tpu_torch.from_array(np.ones((2, 2), dtype=np.complex64), chunks=(2, 2), spec=specs(tmp_path)[1])
    with pytest.raises(TypeError):
        cubed_tpu_torch.nanmax(a)


def test_nanmin_multichunk_on_the_device_executor(tmp_path):
    rng = np.random.default_rng(0)
    an = rng.uniform(-10, 10, (9, 8))
    an[rng.uniform(size=an.shape) < 0.3] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nanmin(a, axis=1), an, chunks=(3, 3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        np.testing.assert_array_equal(got, np.nanmin(an, axis=1))


def test_nanmax_int64_exact_above_2_53(tmp_path):
    an = np.array([2**53 + 1, 5], dtype=np.int64)
    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nanmax(a), an, chunks=(2,), executors=False)
    assert int(got) == 2**53 + 1


def test_nanmax_empty_raises(tmp_path):
    a = cubed_tpu_torch.from_array(np.empty((0,), dtype=np.float64), chunks=(1,), spec=specs(tmp_path)[1])
    with pytest.raises(ValueError, match="zero-size"):
        cubed_tpu_torch.nanmax(a)


def test_nan_functions_float32(tmp_path):
    an = np.random.default_rng(1).standard_normal((7, 5)).astype(np.float32)
    an[an > 1.0] = np.nan
    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nanmean(a, axis=0), an, chunks=(3, 2), rtol=1e-6)
    np.testing.assert_allclose(got, np.nanmean(an, axis=0), rtol=1e-6)
    got, _ = parity(tmp_path, lambda xp, pkg, a: pkg.nansum(a, axis=1), an, chunks=(3, 2), rtol=1e-6,
                    executors=False)
    np.testing.assert_allclose(got, np.nansum(an, axis=1), rtol=1e-5)
