"""The port's ``prod``, ``var``/``std``, cumulative scans, searching and
utility functions against the JAX package's, on the CPU: the same seeded
inputs through both, computed on the port's sequential executor and on
``CudaExecutor`` (chunks on the CPU), the plans compared (tasks, ops,
projected memory) and ``CudaExecutor``'s path counters against
``JaxExecutor``'s (every failed check at 0).

Tolerances: reductions of floats rtol 1e-12; scans of floats atol
``n * eps * max|x|`` along the scanned axis of length n (``torch.cumsum``
adds in another order than XLA); integers, bools and indices exact; dtype
and shape exact.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402

REDUCTION_RTOL = 1e-12
PATH_COUNTERS = ("whole_array_hits", "whole_concat_hits", "batched_ops", "chunked_ops", "eager_ops",
                 "rechunk_alias", "rechunk_virtual")
FAILED_CHECKS = ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors")


def _x(dtype=np.float64, shape=(13, 10), seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        return rng.integers(1, 4, shape).astype(dtype)
    if np.dtype(dtype) == bool:
        return rng.random(shape) < 0.7
    return (rng.random(shape) + 0.5).astype(dtype)


def _plan(arr):
    plan = arr.plan._finalize(array_names=(arr.name,))
    return plan.num_tasks(), plan.num_ops(), plan.max_projected_mem()


def _run(tmp_path, call, data, chunks=(4, 3), scan_axis=None):
    rs = cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="100MB")
    ps = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="100MB")
    r = call(rxp, cubed_tpu.from_array(data, chunks=chunks, spec=rs))
    p = call(pxp, cubed_tpu_torch.from_array(data, chunks=chunks, spec=ps))
    assert _plan(p) == _plan(r)
    ref = np.asarray(r.compute())
    jax_executor_module._STRUCT_CACHE.clear()
    rex, pex = JaxExecutor(), CudaExecutor()
    r.compute(executor=rex)
    for got in (p.compute(), p.compute(executor=pex)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(got, ref)
        elif scan_axis is not None:
            n = data.shape[scan_axis]
            atol = n * np.finfo(ref.dtype).eps * np.max(np.abs(ref))
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5 if ref.dtype == np.float32 else REDUCTION_RTOL)
    assert {c: pex.stats[c] for c in PATH_COUNTERS} == {c: rex.stats.get(c, 0) for c in PATH_COUNTERS}
    assert {c: pex.stats[c] for c in FAILED_CHECKS} == dict.fromkeys(FAILED_CHECKS, 0)
    return ref


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32, np.uint8, np.int64, np.complex128])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_prod(tmp_path, dtype, axis):
    data = _x(dtype) if dtype != np.complex128 else _x() + 0.1j * _x(seed=1)
    ref = _run(tmp_path, lambda xp, a: xp.prod(a, axis=axis), data)
    if np.dtype(dtype).kind != "u":
        np.testing.assert_allclose(ref, np.prod(data, axis=axis), rtol=1e-5 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("func", ["var", "std"])
@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, False), (1, True), ((0, 1), True)])
@pytest.mark.parametrize("correction", [0.0, 1.0])
def test_var_std(tmp_path, func, axis, keepdims, correction):
    data = _x()
    ref = _run(tmp_path, lambda xp, a: getattr(xp, func)(a, axis=axis, keepdims=keepdims, correction=correction),
               data)
    np.testing.assert_allclose(ref, getattr(np, func)(data, axis=axis, keepdims=keepdims, ddof=correction),
                               rtol=1e-12)


def test_var_float32(tmp_path):
    _run(tmp_path, lambda xp, a: xp.var(a, axis=0), _x(np.float32))


@pytest.mark.parametrize("func", ["cumulative_sum", "cumulative_prod"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("include_initial", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.int32, np.uint16])
def test_cumulative(tmp_path, func, axis, include_initial, dtype):
    data = _x(dtype) if func == "cumulative_sum" else _x(dtype) if dtype != np.float64 else _x() * 0.5 + 0.7
    ref = _run(tmp_path, lambda xp, a: getattr(xp, func)(a, axis=axis, include_initial=include_initial),
               data, scan_axis=axis)
    npf = np.cumsum if func == "cumulative_sum" else np.cumprod
    expected = npf(data, axis=axis, dtype=ref.dtype)
    if include_initial:
        lead = np.full(tuple(1 if d == axis else s for d, s in enumerate(data.shape)),
                       0 if func == "cumulative_sum" else 1, dtype=ref.dtype)
        expected = np.concatenate([lead, expected], axis=axis)
    if ref.dtype.kind == "f":
        np.testing.assert_allclose(ref, expected, rtol=1e-12)
    else:
        np.testing.assert_array_equal(ref, expected)


def test_cumulative_sum_1d_and_dtype(tmp_path):
    _run(tmp_path, lambda xp, a: xp.cumulative_sum(a, dtype=xp.float32), _x(shape=(29,)), chunks=(6,),
         scan_axis=0)
    for xp, pkg in ((rxp, cubed_tpu), (pxp, cubed_tpu_torch)):
        with pytest.raises(ValueError):
            xp.cumulative_sum(pkg.from_array(_x(), chunks=4))
        with pytest.raises(TypeError):
            xp.cumulative_sum(pkg.from_array(_x(bool), chunks=4), axis=0)


def _ties_and_nans():
    x = np.random.default_rng(4).integers(0, 5, (13, 10)).astype(np.float64)
    x[3, 4] = x[9, 2] = np.nan
    return x


@pytest.mark.parametrize("func", ["argmax", "argmin"])
@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, False), (1, True), (None, True)])
@pytest.mark.parametrize("data", ["float", "ties_nans", "int8"])
def test_argmax_argmin(tmp_path, func, axis, keepdims, data):
    x = {"float": _x(), "ties_nans": _ties_and_nans(), "int8": _x(np.int8)}[data]
    ref = _run(tmp_path, lambda xp, a: getattr(xp, func)(a, axis=axis, keepdims=keepdims), x)
    expected = getattr(np, func)(x, axis=axis, keepdims=keepdims)
    np.testing.assert_array_equal(ref, expected)


def test_argmax_refuses_uint64_and_complex(tmp_path):
    for xp, pkg in ((rxp, cubed_tpu), (pxp, cubed_tpu_torch)):
        with pytest.raises(TypeError):
            xp.argmax(pkg.from_array(_x(np.complex128) + 0j, chunks=4))
    with pytest.raises(TypeError):
        pxp.argmax(cubed_tpu_torch.from_array(_x(np.uint64), chunks=4))


@pytest.mark.parametrize("case", ["arrays", "scalar_mix", "broadcast", "int"])
def test_where(tmp_path, case):
    x, y = _x(), _x(seed=1)

    def call(xp, a):
        if case == "arrays":
            return xp.where(a > 1.0, a, xp.negative(a))
        if case == "scalar_mix":
            return xp.where(a > 1.0, a, xp.zeros_like(a))
        if case == "broadcast":
            return xp.where(a[:, :1] > 1.0, a, a[0])
        return xp.where(a > 1.0, xp.astype(a, xp.int16), xp.astype(a, xp.int32))

    ref = _run(tmp_path, call, x)
    assert ref.shape == x.shape
    del y


@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, True), (1, False)])
def test_count_nonzero(tmp_path, axis, keepdims):
    x = np.random.default_rng(2).integers(0, 3, (13, 10)).astype(np.float64)
    ref = _run(tmp_path, lambda xp, a: xp.count_nonzero(a, axis=axis, keepdims=keepdims), x)
    np.testing.assert_array_equal(ref, np.count_nonzero(x, axis=axis, keepdims=keepdims))


@pytest.mark.parametrize("func", ["all", "any"])
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("dtype", [bool, np.int8, np.float64])
def test_all_any(tmp_path, func, axis, dtype):
    x = np.random.default_rng(7).random((13, 10)) < (0.97 if func == "all" else 0.03)
    x = x.astype(dtype)
    ref = _run(tmp_path, lambda xp, a: getattr(xp, func)(a, axis=axis), x)
    np.testing.assert_array_equal(ref, getattr(np, func)(x, axis=axis))


def test_all_any_of_empty(tmp_path):
    for xp, pkg in ((rxp, cubed_tpu), (pxp, cubed_tpu_torch)):
        spec = pkg.Spec(work_dir=str(tmp_path / xp.__name__), allowed_mem="100MB")
        e = pkg.from_array(np.zeros((0, 3)), spec=spec)
        assert bool(xp.all(e).compute()) is True and bool(xp.any(e).compute()) is False


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("ends", ["none", "prepend", "append", "both"])
def test_diff(tmp_path, axis, n, ends):
    x = _x()

    def call(xp, a):
        kw = {}
        if ends in ("prepend", "both"):
            kw["prepend"] = a[:2] if axis == 0 else a[:, :2]
        if ends in ("append", "both"):
            kw["append"] = a[-1:] if axis == 0 else a[:, -1:]
        return xp.diff(a, axis=axis, n=n, **kw)

    ref = _run(tmp_path, call, x)
    kw = {}
    if ends in ("prepend", "both"):
        kw["prepend"] = x[:2] if axis == 0 else x[:, :2]
    if ends in ("append", "both"):
        kw["append"] = x[-1:] if axis == 0 else x[:, -1:]
    np.testing.assert_allclose(ref, np.diff(x, axis=axis, n=n, **kw), rtol=1e-15)


def test_nonzero_and_unique_are_refused(tmp_path):
    a = cubed_tpu_torch.from_array(_x(), chunks=4)
    for name in ["nonzero", "unique_all", "unique_counts", "unique_inverse", "unique_values"]:
        with pytest.raises(NotImplementedError):
            getattr(rxp, name)(cubed_tpu.from_array(_x(), chunks=4))
        with pytest.raises(NotImplementedError):
            getattr(pxp, name)(a)


def test_statistical_refusals_match(tmp_path):
    for call in (lambda xp, a: xp.var(xp.astype(a, xp.int32)), lambda xp, a: xp.prod(a > 1),
                 lambda xp, a: xp.std(xp.astype(a, xp.complex128))):
        with pytest.raises(TypeError):
            call(rxp, cubed_tpu.from_array(_x(), chunks=4))
        with pytest.raises(TypeError):
            call(pxp, cubed_tpu_torch.from_array(_x(), chunks=4))


def _block_sums(a, axis=None, keepdims=True):
    return a.sum(axis=axis, keepdims=keepdims)


def _doubled(a):
    return a * 2.0


def test_reduction_aggregate_over_a_plain_intermediate(tmp_path):
    """``core.ops.reduction`` with an ``aggregate_func`` and no structured
    intermediate: the aggregate maps over the combined blocks."""
    from cubed_tpu.core.ops import reduction as ref_reduction
    from cubed_tpu_torch.core.ops import reduction as port_reduction

    x = _x()

    def call(xp, a):
        reduce = ref_reduction if xp is rxp else port_reduction
        return reduce(a, _block_sums, aggregate_func=_doubled, axis=0, dtype=np.float64)

    ref = _run(tmp_path, call, x)
    np.testing.assert_allclose(ref, 2.0 * x.sum(axis=0), rtol=1e-12)
