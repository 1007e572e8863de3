"""The plain versions of the port's hand-written kernels, on the CPU.

The CUDA kernels are held against these on the card (chip_smoke.py and
tests/test_torch_cuda.py); here the plain versions are held against numpy:
the Philox stream bit for bit, the region sum within float64 rounding
(rtol 1e-12; float32 within rtol 1e-6 of numpy's float64 sum, int64 exact).
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cubed_tpu_torch.kernels.philox_uniform import (  # noqa: E402
    philox_key,
    philox_uniform,
    philox_uniform_plain,
)
from cubed_tpu_torch.kernels.region_sum import region_sum, region_sum_plain  # noqa: E402

SEEDS = [0, 1, 7, 123456789, 2**30 - 1, 2**30 + 12345]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 1001, 40_003])
def test_plain_philox_matches_numpy_bitwise(seed, n):
    ref = np.random.Generator(np.random.Philox(seed=seed)).random(n)
    got = philox_uniform_plain(n, philox_key(seed)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.uint64), ref.view(np.uint64))


@pytest.mark.parametrize("shape", [(10, 10, 10), (9, 10, 7), (13,), (3, 1, 5)])
def test_philox_wrapper_on_cpu_fills_block_and_does_not_count(shape):
    seed = 424242
    before = philox_uniform.launches
    out = torch.empty(shape, dtype=torch.float64)
    assert philox_uniform(out, philox_key(seed)) is out
    ref = np.random.Generator(np.random.Philox(seed=seed)).random(shape)
    np.testing.assert_array_equal(out.numpy().view(np.uint64), ref.view(np.uint64))
    assert philox_uniform.launches == before


def test_philox_wrapper_rejects_wrong_dtype():
    with pytest.raises(ValueError):
        philox_uniform(torch.empty(4, dtype=torch.float16), philox_key(0))


def test_philox_key_is_numpy_seedsequence_key():
    for seed in SEEDS:
        key = np.random.Philox(seed=seed).state["state"]["key"]
        assert philox_key(seed) == (int(key[0]), int(key[1]))


AXES = [None, (0,), (1, 2), (2,), (0, 2)]
SHAPES = [(10, 11, 12), (1, 7, 3), (33, 1, 5)]


def _data(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int64:
        return rng.integers(-(10**15), 10**15, size=shape, dtype=np.int64)
    return (rng.random(shape) * 100 - 50).astype(dtype)


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_plain_region_sum_matches_numpy(dtype, shape, axis):
    x = _data(shape, dtype, seed=sum(shape))
    got = region_sum_plain(torch.from_numpy(x), axis).numpy()
    assert got.dtype == dtype
    if dtype == np.int64:
        np.testing.assert_array_equal(got, np.sum(x, axis=axis, keepdims=True))
    elif dtype == np.float64:
        np.testing.assert_allclose(got, np.sum(x, axis=axis, keepdims=True), rtol=1e-12)
    else:
        ref = np.sum(x.astype(np.float64), axis=axis, keepdims=True)
        np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("keepdims", [True, False])
def test_region_sum_wrapper_on_cpu_is_plain_and_does_not_count(keepdims):
    x = torch.from_numpy(_data((6, 5, 4), np.float64, seed=3))
    before = region_sum.launches
    got = region_sum(x, (0, 2), keepdims=keepdims)
    assert torch.equal(got, region_sum_plain(x, (0, 2), keepdims=keepdims))
    assert got.shape == ((1, 5, 1) if keepdims else (5,))
    assert region_sum.launches == before


def test_region_sum_rejects_other_dtypes():
    with pytest.raises(TypeError):
        region_sum(torch.ones(3, dtype=torch.int32))
