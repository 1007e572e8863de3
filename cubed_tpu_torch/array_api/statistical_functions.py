"""Array-API statistical functions: ``max``, ``min``, ``sum``, ``prod``,
``mean``, ``var``, ``std``, ``cumulative_sum`` and ``cumulative_prod``.

Counterpart of ``cubed_tpu/array_api/statistical_functions.py``. ``mean``
carries ``{n, total}`` and ``var``/``std`` ``{n, mu, M2}`` pytree
intermediates (a parallel Welford combine), each field a plain array
written by multi-output ops. Every sum here calls ``nxp.sum`` (``var``'s
block mean too: ``nxp.mean`` is a sum and a divide), which sends float64,
float32 and int64 tensors to the region-sum kernel. ``max``, ``min`` and
``prod`` are tree reductions with ``torch.amax``/``torch.amin``/
``torch.prod`` (the JAX package computes them with ``jnp`` calls, outside
any Pallas kernel). The scans are a per-block scan plus a carry: each
block's total, an exclusive scan of the totals in one block, and the carry
added (multiplied) in. ``torch.cumsum`` sums in another order than numpy
and XLA, so scans agree to a tolerance that grows with the length.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..backend_array_api import nxp
from ..core.ops import general_blockwise, rechunk, reduction
from .dtypes import (
    _numeric_dtypes,
    _real_floating_dtypes,
    _real_numeric_dtypes,
    _signed_integer_dtypes,
    _unsigned_integer_dtypes,
    int64,
    uint64,
)


def max(x, /, *, axis=None, keepdims=False, split_every=None):  # noqa: A001
    if x.dtype not in _real_numeric_dtypes:
        raise TypeError("Only real numeric dtypes are allowed in max")
    _refuse_uint64_order(x, "max")
    return reduction(x, _max_func, axis=axis, dtype=x.dtype, keepdims=keepdims, split_every=split_every)


def min(x, /, *, axis=None, keepdims=False, split_every=None):  # noqa: A001
    if x.dtype not in _real_numeric_dtypes:
        raise TypeError("Only real numeric dtypes are allowed in min")
    _refuse_uint64_order(x, "min")
    return reduction(x, _min_func, axis=axis, dtype=x.dtype, keepdims=keepdims, split_every=split_every)


def _refuse_uint64_order(x, name):
    # uint64 rides in int64 (backend_array_api), whose order differs past 2**63
    if x.dtype == uint64:
        raise TypeError(f"{name} of uint64 is not supported by cubed_tpu_torch")


def _max_func(a, axis=None, keepdims=False):
    return nxp.max(a, axis=axis, keepdims=keepdims)


def _min_func(a, axis=None, keepdims=False):
    return nxp.min(a, axis=axis, keepdims=keepdims)


_max_func.batchable = _min_func.batchable = True


def sum(x, /, *, axis=None, dtype=None, keepdims=False, split_every=None):  # noqa: A001
    if x.dtype not in _numeric_dtypes:
        raise TypeError("Only numeric dtypes are allowed in sum")
    dtype = np.dtype(_default_dtype(x.dtype) if dtype is None else dtype)
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
# executor's fusion rule (runtime/executors/cuda.py); and that it runs
# under torch.func.vmap, read by its batched route
_sum_with_dtype.reduce_kind = "sum"
_sum_with_dtype.batchable = True


def _default_dtype(x_dtype):
    """The result dtype of sum, prod and the scans: integers widen to 64
    bits of their signedness; everything else keeps its dtype."""
    if x_dtype in _signed_integer_dtypes:
        return int64
    if x_dtype in _unsigned_integer_dtypes:
        return uint64
    return x_dtype


def prod(x, /, *, axis=None, dtype=None, keepdims=False, split_every=None):
    if x.dtype not in _numeric_dtypes:
        raise TypeError("Only numeric dtypes are allowed in prod")
    dtype = np.dtype(_default_dtype(x.dtype) if dtype is None else dtype)
    return reduction(
        x,
        _prod_with_dtype,
        combine_func=_prod_with_dtype,
        axis=axis,
        intermediate_dtype=dtype,
        dtype=dtype,
        keepdims=keepdims,
        split_every=split_every,
        extra_func_kwargs=dict(dtype=dtype),
    )


def _prod_with_dtype(a, axis=None, keepdims=False, dtype=None):
    return nxp.prod(a, axis=axis, keepdims=keepdims, dtype=dtype)


_prod_with_dtype.batchable = True


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
_mean_func.batchable = True


def _mean_combine(a, axis=None, keepdims=True, **kwargs):
    n = nxp.sum(a["n"], axis=axis, keepdims=keepdims)
    total = nxp.sum(a["total"], axis=axis, keepdims=keepdims)
    return {"n": n, "total": total}


def _mean_aggregate(a):
    return nxp.divide(a["total"], a["n"])


_mean_aggregate.batchable = True


def _var_intermediate_dtype(x_dtype):
    return np.dtype([("n", np.int64), ("mu", np.float64), ("M2", np.float64)])


def var(x, /, *, axis=None, correction=0.0, keepdims=False, split_every=None):
    """Variance by a parallel Welford (Chan et al.) combine."""
    if x.dtype not in _real_floating_dtypes:
        raise TypeError("Only real floating-point dtypes are allowed in var")
    aggregate = functools.partial(_var_aggregate, correction=correction)
    aggregate.batchable = True
    return reduction(
        x,
        _var_func,
        combine_func=_var_combine,
        aggregate_func=aggregate,
        axis=axis,
        intermediate_dtype=_var_intermediate_dtype(x.dtype),
        dtype=x.dtype,
        keepdims=keepdims,
        split_every=split_every,
    )


def _var_func(a, axis=None, keepdims=True, **kwargs):
    n = _numel(a, axis=axis, dtype=np.int64)
    mu = nxp.mean(a, axis=axis, keepdims=keepdims, dtype=np.float64)
    d = nxp.subtract(a, mu)
    M2 = nxp.sum(d.mul_(d), axis=axis, keepdims=keepdims, dtype=np.float64)  # squared in place: one block less
    return {"n": n, "mu": mu, "M2": M2}


def _var_combine(a, axis=None, keepdims=True, **kwargs):
    # merges over every reduced axis at once: the device executor's region
    # combine hands a multi-axis region of blocks in one call
    n, mu, M2 = a["n"], a["mu"], a["M2"]
    total_n = nxp.sum(n, axis=axis, keepdims=True)
    new_mu = nxp.divide(nxp.sum(nxp.multiply(mu, n), axis=axis, keepdims=True), total_n)
    # M2 = sum(M2_i) + sum(n_i * (mu_i - mu)^2)
    new_M2 = nxp.sum(M2, axis=axis, keepdims=True) + nxp.sum(
        nxp.multiply(n, nxp.square(nxp.subtract(mu, new_mu))), axis=axis, keepdims=True
    )
    return {"n": total_n, "mu": new_mu, "M2": new_M2}


def _var_aggregate(a, correction=0.0):
    return nxp.divide(a["M2"], nxp.subtract(a["n"].to(a["M2"].dtype), correction))


_var_func.batchable = True


def std(x, /, *, axis=None, correction=0.0, keepdims=False, split_every=None):
    from .elementwise_functions import sqrt

    return sqrt(var(x, axis=axis, correction=correction, keepdims=keepdims, split_every=split_every))


def cumulative_sum(x, /, *, axis=None, dtype=None, include_initial=False):
    return _cumulative(x, axis, dtype, include_initial, scan=nxp.cumsum, reduce_fn=_sum_with_dtype, identity=0)


def cumulative_prod(x, /, *, axis=None, dtype=None, include_initial=False):
    return _cumulative(x, axis, dtype, include_initial, scan=nxp.cumprod, reduce_fn=_prod_with_dtype, identity=1)


def _cumulative(x, axis, dtype, include_initial, *, scan, reduce_fn, identity):
    if x.dtype not in _numeric_dtypes:
        raise TypeError("Only numeric dtypes are allowed in cumulative scans")
    if axis is None:
        if x.ndim > 1:
            raise ValueError("axis must be specified for multi-dimensional cumulative scans")
        axis = 0
    if not -x.ndim <= axis < x.ndim:
        raise IndexError(f"axis {axis} out of bounds for ndim {x.ndim}")
    axis = axis % x.ndim
    dtype = np.dtype(_default_dtype(x.dtype) if dtype is None else dtype)
    chunkset = x.chunks
    nb = len(chunkset[axis])

    # 1. each block's inclusive scan
    def _local(a):
        return scan(a, axis, dtype)

    _local.batchable = True
    local = general_blockwise(_local, _same_block(x.name), x, shape=x.shape, dtype=dtype, chunks=chunkset,
                              op_name="cumulative-local")
    if nb > 1:
        # 2a. each block's total: the grid with size-1 blocks on the axis
        def _totals(a):
            return reduce_fn(a, axis=(axis,), keepdims=True, dtype=dtype)

        _totals.batchable = True
        totals_chunks = tuple((1,) * nb if d == axis else chunkset[d] for d in range(x.ndim))
        totals_shape = tuple(nb if d == axis else s for d, s in enumerate(x.shape))
        totals = general_blockwise(_totals, _same_block(x.name), x, shape=totals_shape, dtype=dtype,
                                   chunks=totals_chunks, op_name="cumulative-totals")
        # 2b. the exclusive scan of the totals, the axis in one block
        gathered = rechunk(totals, tuple(nb if d == axis else x.chunksize[d] for d in range(x.ndim)))

        def _exclusive(t):
            # the inclusive scan shifted one place, the identity first (no
            # subtract or divide: exact for wrapped unsigned sums and for
            # products holding zeros)
            incl = scan(t, axis, dtype)
            head = incl.narrow(axis, 0, 1)
            return nxp.concatenate([torch.full_like(head, identity), incl.narrow(axis, 0, incl.shape[axis] - 1)],
                                   axis=axis)

        _exclusive.batchable = True
        excl = general_blockwise(_exclusive, _same_block(gathered.name), gathered, shape=totals_shape,
                                 dtype=dtype, chunks=gathered.chunks, op_name="cumulative-exclusive")
        offsets = rechunk(excl, tuple(1 if d == axis else x.chunksize[d] for d in range(x.ndim)))

        # 3. out block i = local block i (+ or *) carry block i
        l_name, o_name = local.name, offsets.name

        def _block_function(out_key):
            coords = out_key[1:]
            return ((l_name, *coords), (o_name, *coords))

        local = general_blockwise(_combine_add if identity == 0 else _combine_mul, _block_function, local,
                                  offsets, shape=x.shape, dtype=dtype, chunks=chunkset,
                                  op_name="cumulative-combine")
    if include_initial:
        from .creation_functions import full
        from .manipulation_functions import concat

        lead = full(tuple(1 if d == axis else s for d, s in enumerate(x.shape)), identity, dtype=dtype,
                    spec=x.spec)
        return concat([lead, local], axis=axis)
    return local


def _same_block(name):
    def block_function(out_key):
        return ((name, *out_key[1:]),)

    return block_function


def _combine_add(a, o):
    return nxp.add(a, o)


def _combine_mul(a, o):
    return nxp.multiply(a, o)


_combine_add.batchable = _combine_mul.batchable = True
