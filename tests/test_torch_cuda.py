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

    from cubed_tpu_torch.kernels.fma_sum import fma_sum, fma_sum_plain

    g = torch.Generator(device=cuda).manual_seed(9)
    shape = (199, 150, 120) if view else (99, 100, 50)
    ts = [torch.rand(shape, generator=g, device=cuda, dtype=torch.float64).to(getattr(torch, dtype))
          for _ in range(4)]
    if view:  # a ragged block of a resident array, as the device executor passes it
        ts = [t[100:199, 50:150, 70:120] for t in ts]
    before = fma_sum.launches
    got = fma_sum(*ts)
    assert fma_sum.launches == before + 1
    assert torch.equal(got, fma_sum(*ts))
    a, x, b, y = ts
    scale = float((a * x).double().abs().sum() + (b * y).double().abs().sum())
    assert got.shape == (1, 1, 1) and got.dtype == torch.float64
    assert float((got - fma_sum_plain(*ts)).abs().max()) <= 1e-12 * scale


def test_vorticity_on_device_executor_matches_sequential(cuda, tmp_path):
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.kernels.fma_sum import fma_sum
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor

    def run(executor):
        random.seed(4)
        spec = ct.Spec(work_dir=str(tmp_path / type(executor).__name__), allowed_mem="500MB")
        a, b, x, y = [ct.random.random((50, 45, 40), chunks=10, spec=spec) for _ in range(4)]
        return float(xp.mean(a[1:] * x[1:] + b[1:] * y[1:]).compute(executor=executor))

    ex = CudaExecutor()
    before = fma_sum.launches
    got = run(ex)
    assert fma_sum.launches == before + 100
    assert ex.stats["eager_fallbacks"] == 0
    np.testing.assert_allclose(got, run(None), rtol=1e-12)
