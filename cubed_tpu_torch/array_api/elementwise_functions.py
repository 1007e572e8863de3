"""Array-API elementwise functions. Counterpart of
``cubed_tpu/array_api/elementwise_functions.py``: the same dtype checks and
result dtypes, then ``elemwise(nxp.<f>)``.

Where numpy, torch and the JAX package disagree, the port gives the JAX
package's values (``backend_array_api``): a float ``floor_divide`` by zero
is nan, an integer ``floor_divide`` by zero has every bit set and an integer
``remainder`` by zero is 0; ``sign(nan)`` is nan. Unsigned types wider than
8 bits ride in signed carriers: results are wrapped back into the declared
width (``core.ops.elemwise``), and ``>>`` of uint64 is a logical shift.
uint64's order, division and conversion to floats stay refused."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..backend_array_api import floor_divide_unsigned, logical_right_shift64, nxp
from ..core.ops import elemwise
from .dtypes import (
    _all_dtypes,
    _boolean_dtypes,
    _complex_floating_dtypes,
    _floating_dtypes,
    _integer_dtypes,
    _integer_or_boolean_dtypes,
    _numeric_dtypes,
    _real_floating_dtypes,
    _real_numeric_dtypes,
    _unsigned_integer_dtypes,
    complex64,
    complex128,
    float32,
    float64,
    promote_types,
    uint64,
)


def _check(x, dtypes, fname):
    if x.dtype not in dtypes:
        raise TypeError(f"Unsupported dtype {x.dtype} in {fname}")


def _unary(nxp_func, x, dtypes, fname, result_dtype=None):
    _check(x, dtypes, fname)
    return elemwise(nxp_func, x, dtype=result_dtype or x.dtype)


def _promote_pair(x1, x2):
    """Promote a Python scalar operand to a 0-d array of the other's kind."""
    from ..core.array import CoreArray

    if isinstance(x1, CoreArray) and not isinstance(x2, CoreArray):
        x2 = x1._promote_scalar(x2)
    elif isinstance(x2, CoreArray) and not isinstance(x1, CoreArray):
        x1 = x2._promote_scalar(x1)
    if x1 is None or x2 is None:
        raise TypeError("unsupported operand type")
    return x1, x2


def _binary(nxp_func, x1, x2, dtypes, fname, result_dtype=None):
    x1, x2 = _promote_pair(x1, x2)
    _check(x1, dtypes, fname)
    _check(x2, dtypes, fname)
    return elemwise(nxp_func, x1, x2, dtype=result_dtype or promote_types(x1.dtype, x2.dtype))


def _float_of(dtype):
    return {complex64: float32, complex128: float64}.get(dtype, dtype)


def _bool(nxp_func, x, dtypes, fname):
    return _unary(nxp_func, x, dtypes, fname, result_dtype=np.dtype(np.bool_))


def _compare(nxp_func, x1, x2, dtypes, fname):
    return _binary(nxp_func, x1, x2, dtypes, fname, result_dtype=np.dtype(np.bool_))


def _rounding(nxp_func, x, dtypes, fname):
    _check(x, dtypes, fname)
    if x.dtype in _integer_dtypes:
        return x  # an integer is its own floor, ceiling, rounding and truncation
    return elemwise(nxp_func, x, dtype=x.dtype)


def abs(x, /):  # noqa: A001
    _check(x, _numeric_dtypes, "abs")
    return elemwise(nxp.abs, x, dtype=_float_of(x.dtype))


def acos(x, /):
    return _unary(nxp.acos, x, _floating_dtypes, "acos")


def acosh(x, /):
    return _unary(nxp.acosh, x, _floating_dtypes, "acosh")


def add(x1, x2, /):
    return _binary(nxp.add, x1, x2, _numeric_dtypes, "add")


def asin(x, /):
    return _unary(nxp.asin, x, _floating_dtypes, "asin")


def asinh(x, /):
    return _unary(nxp.asinh, x, _floating_dtypes, "asinh")


def atan(x, /):
    return _unary(nxp.atan, x, _floating_dtypes, "atan")


def atan2(x1, x2, /):
    return _binary(nxp.atan2, x1, x2, _real_floating_dtypes, "atan2")


def atanh(x, /):
    return _unary(nxp.atanh, x, _floating_dtypes, "atanh")


def bitwise_and(x1, x2, /):
    return _binary(nxp.bitwise_and, x1, x2, _integer_or_boolean_dtypes, "bitwise_and")


def bitwise_invert(x, /):
    return _unary(nxp.bitwise_invert, x, _integer_or_boolean_dtypes, "bitwise_invert")


def bitwise_left_shift(x1, x2, /):
    return _binary(nxp.bitwise_left_shift, x1, x2, _integer_dtypes, "bitwise_left_shift")


def bitwise_or(x1, x2, /):
    return _binary(nxp.bitwise_or, x1, x2, _integer_or_boolean_dtypes, "bitwise_or")


def bitwise_right_shift(x1, x2, /):
    x1, x2 = _promote_pair(x1, x2)
    if promote_types(x1.dtype, x2.dtype) == uint64:
        # int64's >> is arithmetic: uint64 needs a logical shift
        return _binary(logical_right_shift64, x1, x2, _integer_dtypes, "bitwise_right_shift")
    return _binary(nxp.bitwise_right_shift, x1, x2, _integer_dtypes, "bitwise_right_shift")


def bitwise_xor(x1, x2, /):
    return _binary(nxp.bitwise_xor, x1, x2, _integer_or_boolean_dtypes, "bitwise_xor")


def ceil(x, /):
    return _rounding(nxp.ceil, x, _real_numeric_dtypes, "ceil")


def clip(x, /, min=None, max=None):  # noqa: A002
    """Bounds are scalars or arrays, None for no bound; the result has x's
    dtype, and the bounds take part by value only."""
    from ..core.array import CoreArray

    _check(x, _real_numeric_dtypes, "clip")
    if min is None and max is None:
        return x
    args = [x]
    bounds = []
    for bound in (min, max):
        if bound is None or isinstance(bound, CoreArray):
            if bound is not None:
                if bound.dtype not in _real_numeric_dtypes:
                    raise TypeError("clip bounds must be real numeric")
                args.append(bound)
            bounds.append(bound if bound is None else "array")
        elif isinstance(bound, (int, float, np.integer, np.floating)):
            if x.dtype.kind in "iu":
                # a bound with no exact value in x's dtype would truncate or wrap
                if isinstance(bound, (float, np.floating)) and not (
                    math.isfinite(bound) and float(bound) == int(bound)
                ):
                    raise TypeError(f"clip: float bound without an exact integer value on an integer array "
                                    f"would truncate (got {bound!r} for {x.dtype})")
                info = np.iinfo(x.dtype)
                if not (info.min <= int(bound) <= info.max):
                    raise TypeError(f"clip: bound not representable in the array's dtype would wrap (got "
                                    f"{bound!r} for {x.dtype}, valid range [{info.min}, {info.max}])")
                bound = int(bound)
            bounds.append(bound)
        else:
            raise TypeError("clip bounds must be None, real scalars, or cubed arrays; "
                            f"got {type(bound).__name__} (wrap with from_array/asarray)")
    lo_spec, hi_spec = bounds

    def _clip(a, *arrays):
        arrays = list(arrays)
        lo = arrays.pop(0) if lo_spec == "array" else lo_spec
        hi = arrays.pop(0) if hi_spec == "array" else hi_spec
        out = a
        if lo is not None:
            out = nxp.maximum(out, lo.to(a.dtype)) if isinstance(lo, torch.Tensor) else out.clamp(min=lo)
        if hi is not None:
            out = nxp.minimum(out, hi.to(a.dtype)) if isinstance(hi, torch.Tensor) else out.clamp(max=hi)
        return out

    return elemwise(_clip, *args, dtype=x.dtype)


def conj(x, /):
    return _unary(nxp.conj, x, _numeric_dtypes, "conj")


def copysign(x1, x2, /):
    return _binary(nxp.copysign, x1, x2, _real_floating_dtypes, "copysign")


def cos(x, /):
    return _unary(nxp.cos, x, _floating_dtypes, "cos")


def cosh(x, /):
    return _unary(nxp.cosh, x, _floating_dtypes, "cosh")


def divide(x1, x2, /):
    x1, x2 = _promote_pair(x1, x2)
    dtype = promote_types(x1.dtype, x2.dtype)
    if dtype in _integer_or_boolean_dtypes:
        dtype = float64
    return _binary(nxp.divide, x1, x2, _floating_dtypes, "divide", result_dtype=dtype)


def equal(x1, x2, /):
    return _compare(nxp.equal, x1, x2, _all_dtypes, "equal")


def exp(x, /):
    return _unary(nxp.exp, x, _floating_dtypes, "exp")


def expm1(x, /):
    return _unary(nxp.expm1, x, _floating_dtypes, "expm1")


def floor(x, /):
    return _rounding(nxp.floor, x, _real_numeric_dtypes, "floor")


def floor_divide(x1, x2, /):
    x1, x2 = _promote_pair(x1, x2)
    return _binary(floor_divide_for(promote_types(x1.dtype, x2.dtype)), x1, x2, _real_numeric_dtypes,
                   "floor_divide")


def floor_divide_for(dtype):
    """The element function of ``//`` for a result of *dtype*: an unsigned
    one's zero divisor gives every bit set, a signed one's XLA's value."""
    return floor_divide_unsigned if np.dtype(dtype) in _unsigned_integer_dtypes else nxp.floor_divide


def greater(x1, x2, /):
    return _compare(nxp.greater, x1, x2, _real_numeric_dtypes, "greater")


def greater_equal(x1, x2, /):
    return _compare(nxp.greater_equal, x1, x2, _real_numeric_dtypes, "greater_equal")


def hypot(x1, x2, /):
    return _binary(nxp.hypot, x1, x2, _real_floating_dtypes, "hypot")


def imag(x, /):
    _check(x, _complex_floating_dtypes, "imag")
    return elemwise(nxp.imag, x, dtype=_float_of(x.dtype))


def isfinite(x, /):
    return _bool(nxp.isfinite, x, _numeric_dtypes, "isfinite")


def isinf(x, /):
    return _bool(nxp.isinf, x, _numeric_dtypes, "isinf")


def isnan(x, /):
    return _bool(nxp.isnan, x, _numeric_dtypes, "isnan")


def less(x1, x2, /):
    return _compare(nxp.less, x1, x2, _real_numeric_dtypes, "less")


def less_equal(x1, x2, /):
    return _compare(nxp.less_equal, x1, x2, _real_numeric_dtypes, "less_equal")


def log(x, /):
    return _unary(nxp.log, x, _floating_dtypes, "log")


def log1p(x, /):
    return _unary(nxp.log1p, x, _floating_dtypes, "log1p")


def log2(x, /):
    return _unary(nxp.log2, x, _floating_dtypes, "log2")


def log10(x, /):
    return _unary(nxp.log10, x, _floating_dtypes, "log10")


def logaddexp(x1, x2, /):
    return _binary(nxp.logaddexp, x1, x2, _real_floating_dtypes, "logaddexp")


def logical_and(x1, x2, /):
    return _binary(nxp.logical_and, x1, x2, _boolean_dtypes, "logical_and")


def logical_not(x, /):
    return _unary(nxp.logical_not, x, _boolean_dtypes, "logical_not")


def logical_or(x1, x2, /):
    return _binary(nxp.logical_or, x1, x2, _boolean_dtypes, "logical_or")


def logical_xor(x1, x2, /):
    return _binary(nxp.logical_xor, x1, x2, _boolean_dtypes, "logical_xor")


def maximum(x1, x2, /):
    return _binary(nxp.maximum, x1, x2, _real_numeric_dtypes, "maximum")


def minimum(x1, x2, /):
    return _binary(nxp.minimum, x1, x2, _real_numeric_dtypes, "minimum")


def multiply(x1, x2, /):
    return _binary(nxp.multiply, x1, x2, _numeric_dtypes, "multiply")


def negative(x, /):
    return _unary(nxp.negative, x, _numeric_dtypes, "negative")


def nextafter(x1, x2, /):
    return _binary(nxp.nextafter, x1, x2, _real_floating_dtypes, "nextafter")


def not_equal(x1, x2, /):
    return _compare(nxp.not_equal, x1, x2, _all_dtypes, "not_equal")


def positive(x, /):
    return _unary(nxp.positive, x, _numeric_dtypes, "positive")


def pow(x1, x2, /):  # noqa: A001
    return _binary(nxp.pow, x1, x2, _numeric_dtypes, "pow")


def real(x, /):
    _check(x, _complex_floating_dtypes, "real")
    return elemwise(nxp.real, x, dtype=_float_of(x.dtype))


def reciprocal(x, /):
    return _unary(nxp.reciprocal, x, _floating_dtypes, "reciprocal")


def remainder(x1, x2, /):
    return _binary(nxp.remainder, x1, x2, _real_numeric_dtypes, "remainder")


def round(x, /):  # noqa: A001
    return _rounding(nxp.round, x, _numeric_dtypes, "round")


def sign(x, /):
    return _unary(nxp.sign, x, _numeric_dtypes, "sign")


def signbit(x, /):
    return _bool(nxp.signbit, x, _real_floating_dtypes, "signbit")


def sin(x, /):
    return _unary(nxp.sin, x, _floating_dtypes, "sin")


def sinh(x, /):
    return _unary(nxp.sinh, x, _floating_dtypes, "sinh")


def sqrt(x, /):
    return _unary(nxp.sqrt, x, _floating_dtypes, "sqrt")


def square(x, /):
    return _unary(nxp.square, x, _numeric_dtypes, "square")


def subtract(x1, x2, /):
    return _binary(nxp.subtract, x1, x2, _numeric_dtypes, "subtract")


def tan(x, /):
    return _unary(nxp.tan, x, _floating_dtypes, "tan")


def tanh(x, /):
    return _unary(nxp.tanh, x, _floating_dtypes, "tanh")


def trunc(x, /):
    return _rounding(nxp.trunc, x, _real_numeric_dtypes, "trunc")
