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

    from cubed_tpu_torch.kernels.fma_sum import fma_sum, fma_sum_plain

    a, x, b, y = FMA_CASES[case](bases[dtype])
    before = fma_sum.launches
    got = fma_sum(a, x, b, y)
    assert fma_sum.launches == before + 1
    assert torch.equal(got, fma_sum(a, x, b, y))
    scale = float((a * x).double().abs().sum() + (b * y).double().abs().sum())
    assert float((got - fma_sum_plain(a, x, b, y)).abs().max()) <= 1e-12 * scale


def test_fma_sum_takes_every_path(bases):
    from cubed_tpu_torch.kernels.fma_sum import fma_sum

    before = dict(fma_sum.paths)
    for case in sorted(FMA_CASES):
        fma_sum(*FMA_CASES[case](bases["float64"]))
    taken = {k: fma_sum.paths[k] - before[k] for k in before}
    assert all(taken.values()), taken
