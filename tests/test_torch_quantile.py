"""The port's exact quantiles against the JAX package's, on the CPU, case
for case as ``tests/test_quantile.py`` holds the reference (its top-k cases
are in ``test_torch_sorting.py``): ``quantile`` and ``median`` (a sort, then
static slices interpolated), ``nanquantile`` and ``nanmedian`` (a sort, then
gathered slices at each lane's count of valid elements). Each case
compares plans (tasks, ops, projected memory), values against numpy and
the reference, and ``CudaExecutor``'s path counters against
``JaxExecutor``'s, every failed check 0 (``tests/_torch_parity.py``).

Tolerances: the reference and the port rtol 1e-12 (interpolations round
alike; NaN equal to NaN); against numpy atol 1e-12, as the reference's
tests hold it.
"""

import warnings

import numpy as np
import pytest

import cubed_tpu_torch
import cubed_tpu_torch.array_api as pxp

from ._torch_parity import parity, specs


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0])
def test_quantile_matches_numpy(tmp_path, q):
    an = np.random.default_rng(0).standard_normal((6, 101))
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.quantile(a, q, axis=1), an, chunks=(2, 25), executors=q == 0.9)
    np.testing.assert_allclose(got, np.quantile(an, q, axis=1), atol=1e-12)


@pytest.mark.parametrize("method", ["lower", "higher", "nearest"])
def test_quantile_methods(tmp_path, method):
    an = np.random.default_rng(1).standard_normal(53)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.quantile(a, 0.37, axis=0, method=method), an, chunks=(10,),
                    executors=False)
    np.testing.assert_allclose(float(got), np.quantile(an, 0.37, method=method), atol=1e-12)


def test_median_axis_none_and_keepdims(tmp_path):
    an = np.random.default_rng(2).standard_normal((5, 8))
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.median(a), an, chunks=(2, 3), executors=False)
    np.testing.assert_allclose(float(got), np.median(an), atol=1e-12)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.median(a, axis=1, keepdims=True), an, chunks=(2, 3),
                    executors=False)
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got, np.median(an, axis=1, keepdims=True), atol=1e-12)
    a = cubed_tpu_torch.from_array(an, chunks=(2, 3), spec=specs(tmp_path)[1])
    assert pxp.quantile(a, 0.5, keepdims=True).shape == (1, 1)


def test_quantile_axis_larger_than_memory(tmp_path):
    """The sorted axis exceeds allowed_mem: the sort network carries it
    (the reference's case, at 120000 elements under 400 kB, is marked slow;
    this one is cut to 40000 under 200 kB)."""
    an = np.random.default_rng(3).standard_normal(40_000)
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.quantile(a, 0.75, axis=0), an, chunks=(5_000,),
                    allowed_mem=200_000, executors=False)
    np.testing.assert_allclose(float(got), np.quantile(an, 0.75), atol=1e-12)


def test_quantile_network_on_the_device_executor(tmp_path, monkeypatch):
    """The reference's quantile on its JaxExecutor, with the sort forced
    through the network in both packages: the rounds batched, counters
    equal."""
    monkeypatch.setenv("CUBED_TPU_SORT_NETWORK", "force")
    monkeypatch.setenv("CUBED_TPU_TORCH_SORT_NETWORK", "force")
    an = np.random.default_rng(4).standard_normal((4, 64))
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.quantile(a, 0.5, axis=1), an, chunks=(2, 16))
    np.testing.assert_allclose(got, np.quantile(an, 0.5, axis=1), atol=1e-10)


def test_quantile_validation(tmp_path):
    ps = specs(tmp_path)[1]
    a = cubed_tpu_torch.from_array(np.ones(5), chunks=(5,), spec=ps)
    with pytest.raises(ValueError):
        pxp.quantile(a, 1.5)
    with pytest.raises(TypeError):
        pxp.quantile(a, [0.5])
    with pytest.raises(ValueError):
        pxp.quantile(a, 0.5, method="bogus")
    ai = cubed_tpu_torch.from_array(np.ones(5, dtype=np.int32), chunks=(5,), spec=ps)
    with pytest.raises(TypeError):
        pxp.quantile(ai, 0.5)


def test_quantile_nan_propagates(tmp_path):
    an = np.array([1.0, np.nan, 3.0, 2.0, 5.0])
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.quantile(a, 0.5, axis=0), an, chunks=(2,), executors=False)
    assert np.isnan(float(got))
    bn = np.array([[1.0, np.nan, 3.0], [4.0, 5.0, 6.0]])
    got, _ = parity(tmp_path, lambda xp, pkg, b: xp.median(b, axis=1), bn, chunks=(1, 2))
    assert np.isnan(got[0]) and got[1] == 5.0
    b = cubed_tpu_torch.from_array(bn, chunks=(1, 2), spec=specs(tmp_path)[1])
    with pytest.raises(IndexError):
        pxp.quantile(b, 0.5, axis=5)


def test_nanquantile_matches_numpy(tmp_path):
    rng = np.random.default_rng(5)
    an = rng.standard_normal((6, 60))
    an[an > 1.2] = np.nan
    an[3] = np.nan  # an all-NaN row
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for q in (0.0, 0.3, 0.9, 1.0):
            got, _ = parity(tmp_path, lambda xp, pkg, a: xp.nanquantile(a, q, axis=1), an, chunks=(2, 15),
                            executors=False)
            np.testing.assert_allclose(got, np.nanquantile(an, q, axis=1), atol=1e-12, equal_nan=True)
        got, _ = parity(tmp_path, lambda xp, pkg, a: xp.nanmedian(a, axis=0), an, chunks=(2, 15), executors=False)
        np.testing.assert_allclose(got, np.nanmedian(an, axis=0), atol=1e-12, equal_nan=True)
        got, _ = parity(tmp_path, lambda xp, pkg, a: xp.nanmedian(a), an, chunks=(2, 15), executors=False)
        assert np.isclose(float(got), np.nanmedian(an))
    a = cubed_tpu_torch.from_array(an, chunks=(2, 15), spec=specs(tmp_path)[1])
    assert pxp.nanquantile(a, 0.5, axis=1, keepdims=True).shape == (6, 1)


def test_nanquantile_on_the_device_executor(tmp_path):
    an = np.random.default_rng(6).standard_normal((4, 32))
    an[0, :5] = np.nan
    got, _ = parity(tmp_path, lambda xp, pkg, a: xp.nanquantile(a, 0.5, axis=1), an, chunks=(2, 8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_allclose(got, np.nanquantile(an, 0.5, axis=1), atol=1e-10, equal_nan=True)
