"""NaN-aware reductions (extensions beyond the standard): ``nanmean``,
``nansum``, ``nanmax`` and ``nanmin``.

Counterpart of ``cubed_tpu/nan_functions.py``, with the same plans.
``nanmean`` carries an {n, total} intermediate counting only the non-NaN
elements, ``nanmax``/``nanmin`` an {m, n} one (the extremum over the
NaN-masked values, and the count that makes an all-NaN region NaN). Every
sum here calls ``nxp.sum`` (``nxp.nansum`` fills NaNs with 0 first), so the
region-sum kernel on the card.
"""

from __future__ import annotations

import functools

import numpy as np

from .array_api.dtypes import (
    _numeric_dtypes,
    _real_numeric_dtypes,
    _signed_integer_dtypes,
    _unsigned_integer_dtypes,
    complex64,
    float32,
    int64,
    uint64,
)
from .backend_array_api import nxp
from .core.ops import reduction


def _count_not_nan(a, axis=None, keepdims=True):
    return nxp.sum(nxp.astype(nxp.logical_not(nxp.isnan(a)), np.int64), axis=axis, keepdims=keepdims)


def nanmean(x, /, *, axis=None, keepdims=False, split_every=None):
    """The mean ignoring NaNs (an all-NaN region gives NaN)."""
    return reduction(
        x, _nanmean_func, combine_func=_nanmean_combine, aggregate_func=_nanmean_aggregate, axis=axis,
        intermediate_dtype=np.dtype([("n", np.int64), ("total", np.float64)]), dtype=x.dtype,
        keepdims=keepdims, split_every=split_every,
    )


def _nanmean_func(a, axis=None, keepdims=True, **kw):
    n = _count_not_nan(a, axis=axis, keepdims=keepdims)
    total = _nansum_arr(a, axis=axis, keepdims=keepdims, dtype=np.float64)
    return {"n": n, "total": total}


def _nanmean_combine(a, axis=None, keepdims=True, **kw):
    n = nxp.sum(a["n"], axis=axis, keepdims=keepdims)
    total = nxp.sum(a["total"], axis=axis, keepdims=keepdims)
    return {"n": n, "total": total}


def _nanmean_aggregate(a):
    # an all-NaN region gives NaN, as numpy.nanmean (without its warning)
    n = nxp.astype(a["n"], np.float64)
    valid = n > 0
    return nxp.where(valid, nxp.divide(a["total"], nxp.where(valid, n, nxp.asarray(1.0, dtype=np.float64))),
                     nxp.asarray(np.nan, dtype=np.float64))


def nansum(x, /, *, axis=None, dtype=None, keepdims=False, split_every=None):
    """The sum ignoring NaNs."""
    if x.dtype not in _numeric_dtypes:
        raise TypeError("Only numeric dtypes are allowed in nansum")
    if dtype is None:
        if x.dtype in _signed_integer_dtypes:
            dtype = int64
        elif x.dtype in _unsigned_integer_dtypes:
            dtype = uint64
        elif x.dtype == float32:
            dtype = float32
        elif x.dtype == complex64:
            dtype = complex64
        else:
            dtype = x.dtype
    dtype = np.dtype(dtype)
    return reduction(
        x, _nansum_arr, combine_func=_sum_arr, axis=axis, intermediate_dtype=dtype, dtype=dtype,
        keepdims=keepdims, split_every=split_every, extra_func_kwargs=dict(dtype=dtype),
    )


def _nansum_arr(a, axis=None, keepdims=True, dtype=None, **kw):
    return nxp.nansum(a, axis=axis, keepdims=keepdims, dtype=dtype)


def _sum_arr(a, axis=None, keepdims=True, dtype=None, **kw):
    return nxp.sum(a, axis=axis, keepdims=keepdims, dtype=dtype)


for _f in (_nanmean_func, _nanmean_combine, _nanmean_aggregate, _nansum_arr, _sum_arr):
    _f.batchable = True


def nanmax(x, /, *, axis=None, keepdims=False, split_every=None):
    """The maximum ignoring NaNs (an all-NaN region gives NaN, warning-free)."""
    return _nan_extremum(x, axis, keepdims, split_every, op="max")


def nanmin(x, /, *, axis=None, keepdims=False, split_every=None):
    """The minimum ignoring NaNs (an all-NaN region gives NaN, warning-free)."""
    return _nan_extremum(x, axis, keepdims, split_every, op="min")


def _nan_extremum(x, axis, keepdims, split_every, *, op):
    if x.dtype not in _real_numeric_dtypes:
        raise TypeError(f"Only real numeric dtypes are allowed in nan{op}")
    reduced = tuple(range(x.ndim)) if axis is None else (axis,) if isinstance(axis, int) else tuple(axis)
    if any(x.shape[ax % x.ndim] == 0 for ax in reduced):
        raise ValueError(f"zero-size array to reduction operation nan{op}")
    if np.dtype(x.dtype).kind in "iub":
        # integers hold no NaN: a plain exact extremum (the float64 {m, n}
        # fields would lose int64 values above 2**53)
        from .array_api.statistical_functions import max as _xmax
        from .array_api.statistical_functions import min as _xmin

        f = _xmax if op == "max" else _xmin
        return f(x, axis=axis, keepdims=keepdims, split_every=split_every)

    func = functools.partial(_nan_extremum_func, op=op)
    combine = functools.partial(_nan_extremum_combine, op=op)
    func.batchable = combine.batchable = True
    return reduction(
        x, func, combine_func=combine, aggregate_func=_nan_extremum_aggregate, axis=axis,
        intermediate_dtype=np.dtype([("m", np.float64), ("n", np.int64)]), dtype=x.dtype,
        keepdims=keepdims, split_every=split_every,
    )


def _nan_extremum_func(a, axis=None, keepdims=True, op="max", **kw):
    n = _count_not_nan(a, axis=axis, keepdims=keepdims)
    reducer = nxp.nanmax if op == "max" else nxp.nanmin
    m = reducer(nxp.astype(a, np.float64), axis=axis, keepdims=keepdims)
    return {"m": m, "n": n}


def _nan_extremum_combine(a, axis=None, keepdims=True, op="max", **kw):
    reducer = nxp.max if op == "max" else nxp.min
    return {"m": reducer(a["m"], axis=axis, keepdims=keepdims), "n": nxp.sum(a["n"], axis=axis, keepdims=keepdims)}


def _nan_extremum_aggregate(a):
    return nxp.where(a["n"] > 0, a["m"], nxp.asarray(np.nan, dtype=np.float64))


_nan_extremum_aggregate.batchable = True
