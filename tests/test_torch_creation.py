"""The port's creation functions, data type functions and constants against
the JAX package's, on the CPU: the same calls in both, computed on the
port's sequential executor and on ``CudaExecutor`` (chunks on the CPU), with
the plans compared (tasks, ops, projected memory).

Tolerances: integers, bools and every constant array exact; float64 values
of ``arange``/``linspace``/``eye`` exact against the reference (the same
per-block formula in float64), and within 1 ulp of numpy's at the ends of
ragged blocks; dtype and shape exact.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402


def _specs(tmp_path):
    return (cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="100MB"),
            cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="100MB"))


def _plan(arr):
    plan = arr.plan._finalize(array_names=(arr.name,))
    return plan.num_tasks(), plan.num_ops(), plan.max_projected_mem()


def _same(ref_arr, port_arr, exact=True):
    assert _plan(port_arr) == _plan(ref_arr)
    ref = np.asarray(ref_arr.compute())
    ex = CudaExecutor()
    for got in (port_arr.compute(), port_arr.compute(executor=ex)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref) if exact else np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert ex.stats["eager_fallbacks"] == 0
    return ref


ARANGE = [
    ((10,), {"chunks": 3}),
    ((2, 17, 3), {"chunks": 2}),
    ((17, 2, -3), {"chunks": 4}),
    ((0.0, 1.0, 0.1), {"chunks": 3}),
    ((-2.5, 4.0, 0.75), {"chunks": 2}),
    ((5,), {"dtype": np.float32, "chunks": 2}),
    ((3, 40, 7), {"dtype": np.int32, "chunks": 5}),
    ((1,), {"chunks": 3}),
]


@pytest.mark.parametrize("args,kw", ARANGE, ids=[str(a) for a, _ in ARANGE])
def test_arange(tmp_path, args, kw):
    rs, ps = _specs(tmp_path)
    ref = _same(rxp.arange(*args, spec=rs, **kw), pxp.arange(*args, spec=ps, **kw))
    expected = np.arange(*args, dtype=kw.get("dtype"))
    assert ref.dtype == expected.dtype
    np.testing.assert_allclose(ref, expected, rtol=1e-15, atol=1e-15)


LINSPACE = [
    ((0, 1), {"num": 11, "chunks": 4}),
    ((-3.0, 7.5), {"num": 23, "chunks": 5}),
    ((0, 1), {"num": 10, "endpoint": False, "chunks": 3}),
    ((2, 2), {"num": 1, "chunks": 1}),
    ((1, 0), {"num": 9, "chunks": 2, "dtype": np.float32}),
]


@pytest.mark.parametrize("args,kw", LINSPACE, ids=[str(i) for i in range(len(LINSPACE))])
def test_linspace(tmp_path, args, kw):
    rs, ps = _specs(tmp_path)
    ref = _same(rxp.linspace(*args, spec=rs, **kw), pxp.linspace(*args, spec=ps, **kw))
    expected = np.linspace(*args, num=kw["num"], endpoint=kw.get("endpoint", True), dtype=kw.get("dtype"))
    # the last element is stop exactly; the ends of the ragged blocks
    # within a rounding of numpy's
    if kw.get("endpoint", True) and kw["num"] > 1:
        assert ref[-1] == expected[-1]
    np.testing.assert_allclose(ref, expected, rtol=1e-6 if kw.get("dtype") else 1e-14, atol=1e-15)


EYE = [((5,), {"chunks": 2}), ((7, 4), {"k": 1, "chunks": 3}), ((4, 9), {"k": -2, "chunks": (3, 4)}),
       ((6,), {"k": 6, "dtype": np.int64, "chunks": 4})]


@pytest.mark.parametrize("args,kw", EYE, ids=[str(i) for i in range(len(EYE))])
def test_eye(tmp_path, args, kw):
    rs, ps = _specs(tmp_path)
    ref = _same(rxp.eye(*args, spec=rs, **kw), pxp.eye(*args, spec=ps, **kw))
    np.testing.assert_array_equal(ref, np.eye(*args, k=kw.get("k", 0), dtype=kw.get("dtype", float)))


CONSTANTS = [
    ("zeros", ((7, 5),), {"chunks": 3}),
    ("ones", ((7, 5),), {"chunks": (2, 5), "dtype": np.int32}),
    ("full", ((4, 6), 2.5), {"chunks": 4}),
    ("full", ((9,), 7), {"chunks": 4}),
    ("full", ((3, 3), True), {"chunks": 2}),
    ("full", ((5,), 2**64 - 3), {"chunks": 2, "dtype": np.uint64}),
    ("zeros", ((),), {}),
]


@pytest.mark.parametrize("name,args,kw", CONSTANTS, ids=[f"{c[0]}{i}" for i, c in enumerate(CONSTANTS)])
def test_constant_arrays(tmp_path, name, args, kw):
    rs, ps = _specs(tmp_path)
    r = getattr(rxp, name)(*args, spec=rs, **kw)
    p = getattr(pxp, name)(*args, spec=ps, **kw)
    assert type(p.zarray_maybe_lazy).__name__ == "VirtualFullArray"
    ref = _same(r, p)
    np.testing.assert_array_equal(ref, getattr(np, name)(*args, dtype=kw.get("dtype")))


def test_empty_and_like_functions(tmp_path):
    rs, ps = _specs(tmp_path)
    ra = cubed_tpu.from_array(np.arange(12.0).reshape(3, 4), chunks=2, spec=rs)
    pa = cubed_tpu_torch.from_array(np.arange(12.0).reshape(3, 4), chunks=2, spec=ps)
    for name, kw in [("zeros_like", {}), ("ones_like", {"dtype": np.int8}), ("full_like", {"fill_value": 4.0})]:
        _same(getattr(rxp, name)(ra, **kw), getattr(pxp, name)(pa, **kw))
    for r, p in [(rxp.empty((5, 3), chunks=2, spec=rs), pxp.empty((5, 3), chunks=2, spec=ps)),
                 (rxp.empty_like(ra), pxp.empty_like(pa)),
                 (rxp.empty_virtual_array((4,), chunks=2, spec=rs), pxp.empty_virtual_array((4,), chunks=2, spec=ps))]:
        assert (p.shape, p.dtype, p.chunks) == (r.shape, r.dtype, r.chunks)
        assert p.compute().shape == r.shape


@pytest.mark.parametrize("indexing", ["ij", "xy"])
def test_meshgrid(tmp_path, indexing):
    rs, ps = _specs(tmp_path)
    xs = [np.linspace(0, 1, 5), np.arange(3.0), np.array([2.0, 4.0])]
    rg = rxp.meshgrid(*[cubed_tpu.from_array(x, chunks=2, spec=rs) for x in xs], indexing=indexing)
    pg = pxp.meshgrid(*[cubed_tpu_torch.from_array(x, chunks=2, spec=ps) for x in xs], indexing=indexing)
    for r, p, expected in zip(rg, pg, np.meshgrid(*xs, indexing=indexing)):
        np.testing.assert_array_equal(_same(r, p), expected)


@pytest.mark.parametrize("func", ["tril", "triu"])
@pytest.mark.parametrize("k", [-1, 0, 2])
def test_tril_triu(tmp_path, func, k):
    rs, ps = _specs(tmp_path)
    x = np.random.default_rng(3).random((7, 6))
    ref = _same(getattr(rxp, func)(cubed_tpu.from_array(x, chunks=(3, 4), spec=rs), k=k),
                getattr(pxp, func)(cubed_tpu_torch.from_array(x, chunks=(3, 4), spec=ps), k=k))
    np.testing.assert_array_equal(ref, getattr(np, func)(x, k=k))


def test_asarray_and_from_dlpack(tmp_path):
    rs, ps = _specs(tmp_path)
    x = np.arange(10, dtype=np.int16)
    _same(rxp.asarray(x, chunks=3, spec=rs), pxp.asarray(x, chunks=3, spec=ps))
    _same(rxp.from_dlpack(x, chunks=4, spec=rs), pxp.from_dlpack(x, chunks=4, spec=ps))
    for bad in [dict(copy=False), dict(device="cpu")]:
        with pytest.raises(ValueError):
            rxp.from_dlpack(x, **bad)
        with pytest.raises(ValueError):
            pxp.from_dlpack(x, **bad)
    with pytest.raises(TypeError):
        pxp.from_dlpack([1, 2])


DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float32", "float64",
          "complex64", "complex128", "bool"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_finfo_iinfo_report_the_declared_dtype(dtype):
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        r, p = rxp.iinfo(dt), pxp.iinfo(dt)
        assert (p.bits, p.max, p.min, p.dtype) == (r.bits, r.max, r.min, r.dtype) == (
            np.iinfo(dt).bits, np.iinfo(dt).max, np.iinfo(dt).min, dt)
        with pytest.raises(ValueError):
            pxp.finfo(dt)
    elif dt.kind in "fc":
        r, p = rxp.finfo(dt), pxp.finfo(dt)
        assert (p.bits, p.eps, p.max, p.min, p.smallest_normal, p.dtype) == (
            r.bits, r.eps, r.max, r.min, r.smallest_normal, r.dtype)
    for kind in ["bool", "signed integer", "unsigned integer", "integral", "real floating",
                 "complex floating", "numeric", ("integral", "bool"), dt, np.dtype("float64")]:
        assert pxp.isdtype(dt, kind) == rxp.isdtype(dt, kind)


def test_isdtype_refuses_unknown_kinds():
    with pytest.raises(ValueError):
        rxp.isdtype(np.float64, "fancy")
    with pytest.raises(ValueError):
        pxp.isdtype(np.float64, "fancy")


def test_constants_and_the_device_placeholder(tmp_path):
    for name in ["e", "inf", "nan", "newaxis", "pi"]:
        r, p = getattr(rxp, name), getattr(pxp, name)
        assert (r is None and p is None) or (np.isnan(r) and np.isnan(p)) or r == p
    _, ps = _specs(tmp_path)
    a = pxp.ones((3,), chunks=2, spec=ps)
    assert a.to_device(a.device) is a
    with pytest.raises(ValueError):
        a.to_device(a.device, stream=1)
    assert a.__array_namespace__() is pxp
    assert a.__array_namespace__(api_version="2022.12") is pxp
    with pytest.raises(ValueError):
        a.__array_namespace__(api_version="1999.01")
