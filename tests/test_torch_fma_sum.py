"""fma_sum's plain version against numpy, and its wrapper's contract on
the CPU (on the card it is one launch of the fma_sum_blocks kernel, held
against the plain version in tests/test_torch_cuda.py and chip_smoke.py).

The products and their sum round alike in every version; only the order of
the float64 sum differs, so results agree within 1e-12 of the sum of the
terms' magnitudes.
"""

import numpy as np
import pytest
import torch

from cubed_tpu_torch.kernels.fma_sum import fma_sum, fma_sum_blocks, fma_sum_plain


def _numpy_fma_sum(a, x, b, y) -> float:
    return float(np.sum((a * x + b * y).astype(np.float64), dtype=np.float64))


def _scale(a, x, b, y) -> float:
    return float(np.sum(np.abs((a * x).astype(np.float64))) + np.sum(np.abs((b * y).astype(np.float64))))


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random(shape) * 2 - 1).astype(dtype) for _ in range(4)]


CASES = {
    "block": lambda: [torch.from_numpy(v) for v in _inputs((10, 10, 10), np.float64)],
    "ragged": lambda: [torch.from_numpy(v) for v in _inputs((9, 10, 5), np.float64)],
    # block views of a larger array, as the device executor passes them
    "strided-view": lambda: [torch.from_numpy(v)[1:10, 2:7, 3:8] for v in _inputs((12, 9, 8), np.float64)],
    "step-view": lambda: [torch.from_numpy(v)[::2, 1::3] for v in _inputs((9, 13), np.float64)],
    "rank4": lambda: [torch.from_numpy(v) for v in _inputs((3, 4, 5, 6), np.float64)],
    "size1": lambda: [torch.from_numpy(v) for v in _inputs((1,), np.float64)],
    "size7": lambda: [torch.from_numpy(v) for v in _inputs((7,), np.float64)],
    "size0": lambda: [torch.from_numpy(v) for v in _inputs((0, 4), np.float64)],
    "float32": lambda: [torch.from_numpy(v) for v in _inputs((9, 10, 5), np.float32)],
    "float32-view": lambda: [torch.from_numpy(v)[2:, :7] for v in _inputs((11, 9, 4), np.float32)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_numpy(case):
    a, x, b, y = CASES[case]()
    got = fma_sum_plain(a, x, b, y)
    assert got.dtype == torch.float64
    assert tuple(got.shape) == (1,) * a.ndim
    arrs = [t.numpy() for t in (a, x, b, y)]
    assert abs(float(got.reshape(-1)[0]) - _numpy_fma_sum(*arrs)) <= 1e-12 * _scale(*arrs)


@pytest.mark.parametrize("case", ["block", "strided-view", "float32", "size0"])
def test_wrapper_takes_the_plain_version_for_cpu_tensors_without_counting(case):
    ts = CASES[case]()
    before = fma_sum_blocks.launches
    assert torch.equal(fma_sum(*ts), fma_sum_plain(*ts))
    assert fma_sum_blocks.launches == before


def test_plain_rounds_products_like_the_unfused_chain():
    # float32 products and their sum are rounded in float32 before the
    # float64 sum, as torch's multiply/multiply/add chain rounds them
    a, x, b, y = [torch.from_numpy(v) for v in _inputs((50, 40), np.float32, seed=3)]
    chain = torch.add(torch.multiply(a, x), torch.multiply(b, y))
    assert torch.equal(fma_sum_plain(a, x, b, y), chain.to(torch.float64).sum(dim=(0, 1), keepdim=True))


@pytest.mark.parametrize(
    "bad, error",
    [
        (lambda t: [t, t, t, t[:, :2]], ValueError),  # shapes differ
        (lambda t: [t, t, t, t.float()], TypeError),  # dtypes differ
        (lambda t: [t.long()] * 4, TypeError),  # not a float dtype
        (lambda t: [t.reshape(1, 1, 1, 3, 3)] * 4, ValueError),  # rank 5
        (lambda t: [t.to("meta")] * 4, ValueError),  # neither CPU nor CUDA
    ],
    ids=["shape", "dtype", "int64", "rank5", "meta-device"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    t = torch.ones((3, 3), dtype=torch.float64)
    with pytest.raises(error):
        fma_sum(*bad(t))
