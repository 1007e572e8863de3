"""The port's elementwise functions and Array operators against the JAX
package's, on the CPU: the same seeded numpy inputs through both, on the
port's sequential executor and on ``CudaExecutor`` (chunks on the CPU).

Tolerances: integers and bools exact; float64 and complex128 rtol 1e-12;
float32 and complex64 rtol 1e-5 (the transcendental functions of torch and
XLA may round differently in the last place). Dtype and shape are exact.
Every dtype the reference's dtype table admits is run, uint16, uint32 and
uint64 (carried in signed types) included; a dtype it refuses must raise
the same error type in both. uint64 is refused by the port where its
carrier's order or conversions differ (``UINT64_REFUSED``).
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import operator  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402

BOOL = ["bool"]
SIGNED = ["int8", "int16", "int32", "int64"]
UNSIGNED = ["uint8", "uint16", "uint32", "uint64"]
INTEGER = SIGNED + UNSIGNED
REAL_FLOATING = ["float32", "float64"]
COMPLEX = ["complex64", "complex128"]
FLOATING = REAL_FLOATING + COMPLEX
REAL_NUMERIC = REAL_FLOATING + INTEGER
NUMERIC = FLOATING + INTEGER
ALL = NUMERIC + BOOL

#: name -> the dtypes the reference admits (elementwise_functions.py's _check)
UNARY = {
    "abs": NUMERIC, "acos": FLOATING, "acosh": FLOATING, "asin": FLOATING, "asinh": FLOATING,
    "atan": FLOATING, "atanh": FLOATING, "bitwise_invert": INTEGER + BOOL, "ceil": REAL_NUMERIC,
    "conj": NUMERIC, "cos": FLOATING, "cosh": FLOATING, "exp": FLOATING, "expm1": FLOATING,
    "floor": REAL_NUMERIC, "imag": COMPLEX, "isfinite": NUMERIC, "isinf": NUMERIC, "isnan": NUMERIC,
    "log": FLOATING, "log1p": FLOATING, "log2": FLOATING, "log10": FLOATING, "logical_not": BOOL,
    "negative": NUMERIC, "positive": NUMERIC, "real": COMPLEX, "reciprocal": FLOATING, "round": NUMERIC,
    "sign": NUMERIC, "signbit": REAL_FLOATING, "sin": FLOATING, "sinh": FLOATING, "sqrt": FLOATING,
    "square": NUMERIC, "tan": FLOATING, "tanh": FLOATING, "trunc": REAL_NUMERIC,
}
BINARY = {
    "add": NUMERIC, "atan2": REAL_FLOATING, "bitwise_and": INTEGER + BOOL,
    "bitwise_left_shift": INTEGER, "bitwise_or": INTEGER + BOOL, "bitwise_right_shift": INTEGER,
    "bitwise_xor": INTEGER + BOOL, "copysign": REAL_FLOATING, "divide": FLOATING, "equal": ALL,
    "floor_divide": REAL_NUMERIC, "greater": REAL_NUMERIC, "greater_equal": REAL_NUMERIC,
    "hypot": REAL_FLOATING, "less": REAL_NUMERIC, "less_equal": REAL_NUMERIC,
    "logaddexp": REAL_FLOATING, "logical_and": BOOL, "logical_or": BOOL, "logical_xor": BOOL,
    "maximum": REAL_NUMERIC, "minimum": REAL_NUMERIC, "multiply": NUMERIC, "nextafter": REAL_FLOATING,
    "not_equal": ALL, "pow": NUMERIC, "remainder": REAL_NUMERIC, "subtract": NUMERIC,
}
#: uint64 rides in int64: the port refuses what its order, division or
#: conversion to floats would get wrong past 2**63
UINT64_REFUSED = {
    "abs", "sign", "floor_divide", "remainder", "pow", "maximum", "minimum", "greater",
    "greater_equal", "less", "less_equal", "divide", "reciprocal",
}

SHAPE, CHUNKS = (6, 8), (3, 4)  # one block shape: each function compiles once in the reference


def _data(dtype: str, seed: int, name: str = "", second: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt == bool:
        return rng.random(SHAPE) < 0.5
    if dt.kind in "iu":
        info = np.iinfo(dt)
        if name.startswith("bitwise_") and name.endswith("shift") and second:
            return rng.integers(0, info.bits, SHAPE).astype(dt)
        if name == "pow" and second:
            return rng.integers(0, 4, SHAPE).astype(dt)
        lo, hi = (info.min, info.max) if name.startswith("bitwise") or name in ("add", "multiply") else (
            max(info.min, -40), min(info.max, 40))
        out = rng.integers(lo, hi, SHAPE, dtype=dt, endpoint=True)
        if name in ("floor_divide", "remainder") and second:
            out[0, :3] = 0  # the divisor zero whose value is pinned to the reference's
        return out
    x = rng.standard_normal(SHAPE) * 3
    if name in ("floor_divide", "remainder", "sign", "copysign", "nextafter", "isfinite", "isinf", "isnan"):
        x.flat[:7] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -1.5]
    if dt.kind == "c":
        x = x + 1j * rng.standard_normal(SHAPE)
    return x.astype(dt)


def _arrays(tmp_path, datas):
    rspec = cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="100MB")
    pspec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="100MB")
    return ([cubed_tpu.from_array(d, chunks=CHUNKS, spec=rspec) for d in datas],
            [cubed_tpu_torch.from_array(d, chunks=CHUNKS, spec=pspec) for d in datas])


def _check_same(ref_arr, port_arr):
    ref = np.asarray(ref_arr.compute())
    for got in (port_arr.compute(), port_arr.compute(executor=CudaExecutor())):
        assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype, got.shape, ref.shape)
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(got, ref)
        else:
            rtol = 1e-5 if ref.dtype in (np.float32, np.complex64) else 1e-12
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


def _cases(table):
    return [(name, dt) for name, dts in sorted(table.items()) for dt in dts]


def _refusals(table):
    return [(name, dt) for name, dts in sorted(table.items()) for dt in ALL if dt not in dts]


@pytest.mark.parametrize("name,dtype", _cases(UNARY))
def test_unary_matches_jax_package(tmp_path, name, dtype):
    (r,), (p,) = _arrays(tmp_path, [_data(dtype, 1, name)])
    if dtype == "uint64" and name in UINT64_REFUSED:
        getattr(rxp, name)(r)
        with pytest.raises(TypeError):
            getattr(pxp, name)(p)
        return
    _check_same(getattr(rxp, name)(r), getattr(pxp, name)(p))


@pytest.mark.parametrize("name,dtype", _cases(BINARY))
def test_binary_matches_jax_package(tmp_path, name, dtype):
    (r1, r2), (p1, p2) = _arrays(tmp_path, [_data(dtype, 1, name), _data(dtype, 2, name, second=True)])
    if dtype == "uint64" and name in UINT64_REFUSED:
        getattr(rxp, name)(r1, r2)
        with pytest.raises(TypeError):
            getattr(pxp, name)(p1, p2)
        return
    _check_same(getattr(rxp, name)(r1, r2), getattr(pxp, name)(p1, p2))


@pytest.mark.parametrize("name,dtype", _refusals(UNARY))
def test_unary_refusals_match(tmp_path, name, dtype):
    (r,), (p,) = _arrays(tmp_path, [_data(dtype, 1)])
    with pytest.raises(Exception) as ref_err:
        getattr(rxp, name)(r)
    with pytest.raises(type(ref_err.value)):
        getattr(pxp, name)(p)


@pytest.mark.parametrize("name,dtype", _refusals(BINARY))
def test_binary_refusals_match(tmp_path, name, dtype):
    (r1, r2), (p1, p2) = _arrays(tmp_path, [_data(dtype, 1), _data(dtype, 2)])
    with pytest.raises(Exception) as ref_err:
        getattr(rxp, name)(r1, r2)
    with pytest.raises(type(ref_err.value)):
        getattr(pxp, name)(p1, p2)


#: mixed pairs promoted by the spec's table; the unsigned carriers meet
#: signed types of each width
MIXED = [("int8", "uint8"), ("uint16", "int32"), ("uint32", "int64"), ("uint8", "uint32"),
         ("float32", "float64"), ("int16", "uint16"), ("complex64", "float64")]


@pytest.mark.parametrize("name", ["add", "multiply", "subtract", "bitwise_xor", "floor_divide", "remainder"])
@pytest.mark.parametrize("pair", MIXED, ids=["-".join(p) for p in MIXED])
def test_mixed_dtypes_promote_as_the_reference(tmp_path, name, pair):
    if name in ("bitwise_xor", "floor_divide", "remainder") and "complex64" in pair:
        return
    if name == "bitwise_xor" and "float32" in pair:
        return
    (r1, r2), (p1, p2) = _arrays(tmp_path, [_data(pair[0], 3, name), _data(pair[1], 4, name, second=True)])
    _check_same(getattr(rxp, name)(r1, r2), getattr(pxp, name)(p1, p2))


OPERATORS = {
    "__add__": (operator.add, NUMERIC), "__sub__": (operator.sub, NUMERIC),
    "__mul__": (operator.mul, NUMERIC), "__truediv__": (operator.truediv, FLOATING),
    "__floordiv__": (operator.floordiv, REAL_NUMERIC), "__mod__": (operator.mod, REAL_NUMERIC),
    "__pow__": (operator.pow, NUMERIC), "__and__": (operator.and_, INTEGER + BOOL),
    "__or__": (operator.or_, INTEGER + BOOL), "__xor__": (operator.xor, INTEGER + BOOL),
    "__lshift__": (operator.lshift, INTEGER), "__rshift__": (operator.rshift, INTEGER),
    "__lt__": (operator.lt, REAL_NUMERIC), "__le__": (operator.le, REAL_NUMERIC),
    "__gt__": (operator.gt, REAL_NUMERIC), "__ge__": (operator.ge, REAL_NUMERIC),
    "__eq__": (operator.eq, ALL), "__ne__": (operator.ne, ALL),
}
_OP_FUNC = {"__floordiv__": "floor_divide", "__mod__": "remainder", "__pow__": "pow",
            "__lshift__": "bitwise_left_shift", "__rshift__": "bitwise_right_shift",
            "__lt__": "less", "__le__": "less_equal", "__gt__": "greater", "__ge__": "greater_equal"}
#: dtypes run for each operator (one of each kind keeps the file quick)
OPERATOR_DTYPES = ["bool", "int8", "int64", "uint8", "uint16", "uint32", "uint64", "float32", "float64",
                   "complex128"]


def _scalar_for(dtype: str, name: str):
    dt = np.dtype(dtype)
    if dt == bool:
        return True
    if dt.kind in "iu":
        return 3 if name not in ("__floordiv__", "__mod__") else 4
    return 2.5 if dt.kind == "f" else 1.5 + 0.5j


@pytest.mark.parametrize("name,dtype", [(n, d) for n in sorted(OPERATORS) for d in OPERATOR_DTYPES
                                        if d in OPERATORS[n][1]])
def test_operators_match_jax_package(tmp_path, name, dtype):
    op, _ = OPERATORS[name]
    func = _OP_FUNC.get(name, "")
    (r1, r2), (p1, p2) = _arrays(tmp_path, [_data(dtype, 5, func), _data(dtype, 6, func, second=True)])
    if dtype == "uint64" and func in UINT64_REFUSED:
        with pytest.raises(TypeError):
            op(p1, p2)
        return
    s = _scalar_for(dtype, name)
    _check_same(op(r1, r2), op(p1, p2))
    _check_same(op(r1, s), op(p1, s))
    if name not in ("__lt__", "__le__", "__gt__", "__ge__", "__eq__", "__ne__"):
        _check_same(op(s, r1), op(s, p1))  # the reflected form


@pytest.mark.parametrize("dtype", ["bool", "int16", "uint16", "uint32", "uint64"])
def test_invert_matches_jax_package(tmp_path, dtype):
    (r,), (p,) = _arrays(tmp_path, [_data(dtype, 7, "bitwise_invert")])
    _check_same(~r, ~p)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int8", "uint8"])
@pytest.mark.parametrize("bounds", [(3, 30), (None, 20), (5, None), ("array", "array")])
def test_clip_matches_jax_package(tmp_path, dtype, bounds):
    (r, rlo, rhi), (p, plo, phi) = _arrays(tmp_path, [_data(dtype, 8), _data(dtype, 9) - 1, _data(dtype, 10) + 1])
    if bounds == ("array", "array"):
        _check_same(rxp.clip(r, rlo, rhi), pxp.clip(p, plo, phi))
    else:
        lo, hi = bounds
        if np.dtype(dtype).kind == "f":
            lo, hi = (None if b is None else float(b) for b in (lo, hi))
        _check_same(rxp.clip(r, lo, hi), pxp.clip(p, lo, hi))


def test_clip_refusals_match(tmp_path):
    (r,), (p,) = _arrays(tmp_path, [_data("int8", 1)])
    for bad in (2.5, 1000, np.ones(3)):
        with pytest.raises(TypeError):
            rxp.clip(r, bad)
        with pytest.raises(TypeError):
            pxp.clip(p, bad)


def test_uint64_logical_right_shift_and_wrap(tmp_path):
    """``>>`` of uint64 is logical (int64's is arithmetic), ``<<`` and
    ``~`` keep every bit, and values past 2**63 survive."""
    x = np.array([2**63, 2**64 - 1, 12345, 2**63 + 7, 1, 0, 2**40], dtype=np.uint64)
    s = np.array([3, 63, 0, 1, 62, 5, 8], dtype=np.uint64)
    rspec = cubed_tpu.Spec(work_dir=str(tmp_path / "r"), allowed_mem="100MB")
    pspec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "p"), allowed_mem="100MB")
    r = [cubed_tpu.from_array(a, chunks=3, spec=rspec) for a in (x, s)]
    p = [cubed_tpu_torch.from_array(a, chunks=3, spec=pspec) for a in (x, s)]
    for func in ("bitwise_right_shift", "bitwise_left_shift", "bitwise_and", "bitwise_xor"):
        _check_same(getattr(rxp, func)(*r), getattr(pxp, func)(*p))
    _check_same(rxp.bitwise_invert(r[0]), pxp.bitwise_invert(p[0]))
    np.testing.assert_array_equal(pxp.bitwise_right_shift(*p).compute(), x >> s)
