"""The port against the JAX package on the CPU: the same plans, the same
numpy/stdlib-seeded inputs, computed by both.

Elementwise results must be equal bit for bit (+, -, *, / and sqrt are
correctly rounded in both). Reductions may differ in the order of summation
only, so they agree within rtol 1e-12 (float64). Plans must match in task
count, op count and projected memory.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402

REDUCTION_RTOL = 1e-12


def _specs(tmp_path, allowed_mem="500MB"):
    return (
        cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem=allowed_mem),
        cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem=allowed_mem),
    )


def _both(tmp_path, build, seed=99):
    """Build the same expression in both packages from the same seeds;
    returns (reference result, port result)."""
    ref_spec, port_spec = _specs(tmp_path)
    random.seed(seed)
    ref = build(cubed_tpu, rxp, ref_spec)
    random.seed(seed)
    port = build(cubed_tpu_torch, pxp, port_spec)
    return np.asarray(ref.compute()), port.compute()


def _addsum(pkg, xp, spec):
    a = pkg.random.random((50, 50), chunks=10, spec=spec)
    b = pkg.random.random((50, 50), chunks=10, spec=spec)
    return xp.sum(xp.add(a, b))


def _vorticity(pkg, xp, spec, shape=(50, 45, 40), chunks=10):
    a, b, x, y = [pkg.random.random(shape, chunks=chunks, spec=spec) for _ in range(4)]
    return xp.mean(xp.add(xp.multiply(a[1:], x[1:]), xp.multiply(b[1:], y[1:])))


def _chain(pkg, xp, spec):
    a = pkg.random.random((23, 31), chunks=(10, 8), spec=spec)
    b = pkg.random.random((23, 31), chunks=(10, 8), spec=spec)
    return xp.sqrt(xp.abs(xp.subtract(xp.multiply(a, b), xp.divide(b, a + 1.0)))) * 2.0 - a


def _mean_axis0(pkg, xp, spec):
    a = pkg.random.random((30, 25, 12), chunks=(7, 10, 5), spec=spec)
    return xp.mean(a, axis=0)


@pytest.mark.parametrize(
    "build", [_addsum, _vorticity, _mean_axis0], ids=["addsum", "vorticity", "mean_axis0"]
)
def test_reductions_match_jax_package(tmp_path, build):
    ref, got = _both(tmp_path, build)
    assert got.dtype == ref.dtype
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=REDUCTION_RTOL, atol=0)


def test_elementwise_chain_matches_jax_package_bitwise(tmp_path):
    ref, got = _both(tmp_path, _chain)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize(
    "key",
    [
        (slice(1, None), slice(2, 15, 3)),
        (Ellipsis, 3),
        (4, slice(1, 7)),
        (slice(None, None, 5),),
        (-1, -2),
    ],
    ids=["slice-step", "ellipsis-int", "int-slice", "step-only", "negative-ints"],
)
def test_slices_match_jax_package_bitwise(tmp_path, key):
    def build(pkg, xp, spec):
        a = pkg.random.random((21, 17), chunks=(5, 4), spec=spec)
        return a[key]

    ref, got = _both(tmp_path, build)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_unported_index_kinds_raise(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.random.random((10, 10), chunks=5, spec=spec)
    # a boolean array, and a second integer array, as the JAX package refuses them
    for key in [(np.arange(10) < 5,), ([1, 2], [1, 2])]:
        with pytest.raises(NotImplementedError):
            a[key]


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_from_array_sum_matches_jax_package(tmp_path, dtype):
    x = (np.random.default_rng(5).random((40, 30)) * 1000).astype(dtype)
    ref_spec, port_spec = _specs(tmp_path)
    ref = np.asarray(rxp.sum(cubed_tpu.from_array(x, chunks=(10, 7), spec=ref_spec), axis=1).compute())
    got = pxp.sum(cubed_tpu_torch.from_array(x, chunks=(10, 7), spec=port_spec), axis=1).compute()
    assert got.dtype == ref.dtype
    if dtype == np.int64:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=REDUCTION_RTOL if dtype == np.float64 else 1e-6)


def test_vorticity_plan_at_full_size_matches(tmp_path):
    """BASELINE config 5's plan, built (not computed) in both packages."""
    ref_spec, port_spec = _specs(tmp_path, allowed_mem="2GB")
    shape, chunks = (500, 450, 400), 100
    ref = _vorticity(cubed_tpu, rxp, ref_spec, shape, chunks)
    port = _vorticity(cubed_tpu_torch, pxp, port_spec, shape, chunks)
    ref_plan = ref.plan._finalize(array_names=(ref.name,))
    port_plan = port.plan._finalize(array_names=(port.name,))
    assert port_plan.num_tasks() == ref_plan.num_tasks() == 921
    assert port_plan.num_ops() == ref_plan.num_ops() == 13
    assert port_plan.max_projected_mem() == ref_plan.max_projected_mem() == 80_000_000


def test_too_small_allowed_mem_raises_when_op_is_built(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="1MB")
    with pytest.raises(ValueError, match="exceeds allowed_mem"):
        cubed_tpu_torch.random.random((1000, 1000), chunks=500, spec=spec)


def test_from_zarr_reads_store_written_by_jax_package(tmp_path):
    x = np.random.default_rng(8).random((30, 20))
    ref_spec, port_spec = _specs(tmp_path)
    store = str(tmp_path / "x.zarr")
    cubed_tpu.to_zarr(cubed_tpu.from_array(x, chunks=(7, 6), spec=ref_spec), store)
    arr = cubed_tpu_torch.from_zarr(store, spec=port_spec)
    assert arr.shape == x.shape and arr.chunksize == (7, 6)
    np.testing.assert_array_equal(arr.compute(), x)
    ref = float(rxp.sum(cubed_tpu.from_zarr(store, spec=ref_spec)).compute())
    got = float(pxp.sum(arr).compute())
    np.testing.assert_allclose(got, ref, rtol=REDUCTION_RTOL)
