"""Array-API statistical functions of the slice: ``sum`` and ``mean``.

Counterpart of ``cubed_tpu/array_api/statistical_functions.py``. ``mean``
carries ``{n, total}`` pytree intermediates, each field a plain array
written by multi-output ops. Every sum here (``_sum_with_dtype``,
``_mean_func``, ``_mean_combine``) calls ``nxp.sum``, which sends float64,
float32 and int64 tensors to the region-sum kernel.
"""

from __future__ import annotations

import numpy as np

from ..backend_array_api import nxp
from ..core.ops import reduction
from .dtypes import (
    _numeric_dtypes,
    _real_floating_dtypes,
    _signed_integer_dtypes,
    _unsigned_integer_dtypes,
    int64,
    uint64,
)


def sum(x, /, *, axis=None, dtype=None, keepdims=False, split_every=None):  # noqa: A001
    if x.dtype not in _numeric_dtypes:
        raise TypeError("Only numeric dtypes are allowed in sum")
    if dtype is None:
        if x.dtype in _signed_integer_dtypes:
            dtype = int64
        elif x.dtype in _unsigned_integer_dtypes:
            dtype = uint64
        else:
            dtype = x.dtype
    dtype = np.dtype(dtype)
    return reduction(
        x,
        _sum_with_dtype,
        combine_func=_sum_with_dtype,
        axis=axis,
        intermediate_dtype=dtype,
        dtype=dtype,
        keepdims=keepdims,
        split_every=split_every,
        extra_func_kwargs=dict(dtype=dtype),
    )


def _sum_with_dtype(a, axis=None, keepdims=False, dtype=None):
    return nxp.sum(a, axis=axis, keepdims=keepdims, dtype=dtype)


# what the function computes, read from plan metadata by the device
# executor's fusion rule (runtime/executors/cuda.py)
_sum_with_dtype.reduce_kind = "sum"


def _mean_intermediate_dtype(x_dtype):
    return np.dtype([("n", np.int64), ("total", np.float64)])


def mean(x, /, *, axis=None, keepdims=False, split_every=None):
    if x.dtype not in _real_floating_dtypes:
        raise TypeError("Only real floating-point dtypes are allowed in mean")
    return reduction(
        x,
        _mean_func,
        combine_func=_mean_combine,
        aggregate_func=_mean_aggregate,
        axis=axis,
        intermediate_dtype=_mean_intermediate_dtype(x.dtype),
        dtype=x.dtype,
        keepdims=keepdims,
        split_every=split_every,
    )


def _numel(x, axis=None, dtype=np.float64):
    """Number of elements along axis, broadcast to the reduced shape."""
    n = 1
    for ax in axis:
        n *= x.shape[ax]
    reduced_shape = tuple(1 if ax in axis else s for ax, s in enumerate(x.shape))
    return nxp.broadcast_to(nxp.asarray(n, dtype=dtype), reduced_shape)


def _mean_func(a, axis=None, keepdims=True, **kwargs):
    n = _numel(a, axis=axis, dtype=np.int64)
    total = nxp.sum(a, axis=axis, keepdims=keepdims, dtype=np.float64)
    return {"n": n, "total": total}


_mean_func.reduce_kind = "mean"


def _mean_combine(a, axis=None, keepdims=True, **kwargs):
    n = nxp.sum(a["n"], axis=axis, keepdims=keepdims)
    total = nxp.sum(a["total"], axis=axis, keepdims=keepdims)
    return {"n": n, "total": total}


def _mean_aggregate(a):
    return nxp.divide(a["total"], a["n"])
