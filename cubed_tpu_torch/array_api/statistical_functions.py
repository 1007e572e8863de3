"""Array-API statistical functions: ``max``, ``min``, ``sum``, ``prod``,
``mean``, ``var``, ``std``, ``cumulative_sum`` and ``cumulative_prod``; and
the order statistics beyond the standard: ``quantile``, ``median``,
``nanquantile``, ``nanmedian`` (a sort, then static or gathered slices),
``histogram`` (per-block counts summed through the tree), ``cov`` and
``corrcoef``.

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


# ---------------------------------------------------------------------------
# order statistics: quantile, median, their NaN forms, histogram, cov,
# corrcoef (the JAX package's statistical_functions.py:420-809)
# ---------------------------------------------------------------------------


def _check_quantile_args(x, q, fname):
    if not isinstance(q, (int, float)) or isinstance(q, bool):
        raise TypeError(f"{fname}: q must be a python float in [0, 1]")
    q = float(q)
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"{fname}: q must be in [0, 1]")
    if x.dtype not in _real_floating_dtypes:
        raise TypeError(f"Only real floating-point dtypes are allowed in {fname}")
    return q


def _check_quantile_axis(x, axis, fname):
    if not -x.ndim <= axis < x.ndim:
        raise IndexError(f"{fname}: axis {axis} is out of bounds for array of dimension {x.ndim}")
    axis = axis % x.ndim
    if x.shape[axis] == 0:
        raise ValueError(f"{fname} of an empty axis")
    return axis


def quantile(x, q, /, *, axis=None, keepdims=False, method="linear"):
    """The exact quantile along an axis: the axis runs through the sort
    (the network where it is larger than ``allowed_mem``), and the quantile
    is two STATIC slices of the sorted axis interpolated elementwise. ``q``
    a python float in [0, 1]; ``method`` "linear" (numpy's default),
    "lower", "higher" or "nearest". Any NaN along the axis makes the lane's
    quantile NaN, as numpy's."""
    from .creation_functions import asarray
    from .elementwise_functions import add, isnan, multiply
    from .manipulation_functions import expand_dims, flatten, squeeze
    from .searching_functions import where
    from .sorting_functions import sort

    q = _check_quantile_args(x, q, "quantile")
    if method not in ("linear", "lower", "higher", "nearest"):
        raise ValueError(f"quantile: unsupported method {method!r}")

    if axis is None:
        out = quantile(flatten(x), q, axis=0, method=method)
        if keepdims:
            for _ in range(x.ndim):
                out = expand_dims(out, axis=0)
        return out

    axis = _check_quantile_axis(x, axis, "quantile")
    n = x.shape[axis]

    pos = q * (n - 1)
    lo = int(np.floor(pos))
    hi = int(np.ceil(pos))
    frac = pos - lo
    if method == "lower":
        hi, frac = lo, 0.0
    elif method == "higher":
        lo, frac = hi, 0.0
    elif method == "nearest":
        lo = hi = int(round(pos))
        frac = 0.0

    s = sort(x, axis=axis)
    sel_lo = tuple(slice(lo, lo + 1) if d == axis else slice(None) for d in range(x.ndim))
    out = s[sel_lo]
    if hi != lo:
        sel_hi = tuple(slice(hi, hi + 1) if d == axis else slice(None) for d in range(x.ndim))
        w = asarray(frac, dtype=x.dtype, spec=x.spec)
        one_minus = asarray(1.0 - frac, dtype=x.dtype, spec=x.spec)
        out = add(multiply(out, one_minus), multiply(s[sel_hi], w))

    # the sort parks NaNs at the END of the axis, so the last element alone
    # tells whether any NaN exists: one static slice, not a second pass
    sel_last = tuple(slice(n - 1, n) if d == axis else slice(None) for d in range(x.ndim))
    has_nan = isnan(s[sel_last])
    out = where(has_nan, asarray(float("nan"), dtype=x.dtype, spec=x.spec), out)
    return out if keepdims else squeeze(out, axis=axis)


def median(x, /, *, axis=None, keepdims=False):
    """The exact median: :func:`quantile` at 0.5."""
    return quantile(x, 0.5, axis=axis, keepdims=keepdims)


def histogram(x, /, *, bins=10, range=None, weights=None, density=False):
    """Chunked histogram (numpy's semantics): ``(counts, edges)``. ``bins``
    an int (with an optional ``range``) or a sequence of edges; without a
    ``range`` the data's min and max are computed lazily in the plan (one
    {lo, hi} field tree). Per-block partial counts (``nxp.histogram``) sum
    through the reduction tree, so ``x`` may exceed ``allowed_mem``. As in
    the JAX package, NaN data with an implicit range gives NaN edges (a
    lazy plan cannot raise on values); with explicit edges a NaN falls
    outside every bin, as numpy's."""
    from ..core.ops import _aggregate_fields, general_blockwise, reduction_fields
    from .creation_functions import arange, asarray
    from .data_type_functions import astype
    from .elementwise_functions import add, divide, greater, multiply, subtract
    from .manipulation_functions import flatten
    from .searching_functions import where
    from .utility_functions import diff

    if x.dtype not in _real_floating_dtypes:
        raise TypeError("Only real floating-point dtypes are allowed in histogram")
    flat = flatten(x)
    wflat = None
    if weights is not None:
        if weights.shape != x.shape:
            raise ValueError("histogram: weights must match x's shape")
        wflat = flatten(weights)
        if wflat.chunks != flat.chunks:
            wflat = wflat.rechunk(flat.chunksize)

    spec = x.spec
    f64 = np.dtype(np.float64)
    if np.ndim(bins) == 0:
        nbins = int(bins)
        if nbins <= 0:
            raise ValueError("histogram: bins must be positive")
        if range is not None:
            lo_v, hi_v = float(range[0]), float(range[1])
            if not lo_v <= hi_v:
                raise ValueError("histogram: range must be increasing")
            if lo_v == hi_v:
                lo_v, hi_v = lo_v - 0.5, hi_v + 0.5
            # exact endpoints (numpy's linspace): the max sample lands IN the
            # closed last bin
            edges = asarray(np.linspace(lo_v, hi_v, nbins + 1), spec=spec)
        else:
            parts = reduction_fields(flat, _extent_func, _extent_combine, axis=(0,),
                                     fields={"lo": f64, "hi": f64})
            names = ["lo", "hi"]
            lo = _aggregate_fields(parts, _take_lo, f64, names)
            hi = _aggregate_fields(parts, _take_hi, f64, names)
            degenerate = greater(hi, lo)
            half = asarray(0.5, dtype=f64, spec=spec)
            lo = where(degenerate, lo, subtract(lo, half))
            hi = where(degenerate, hi, add(hi, half))
            # lo*(1-t) + hi*t with t = i/nbins: the first and last edges are
            # lo and hi EXACTLY (lo + i*step can round the last edge below
            # the data's max, dropping it from the closed last bin)
            t = divide(arange(nbins + 1, dtype=f64, spec=spec), asarray(float(nbins), dtype=f64, spec=spec))
            one = asarray(1.0, dtype=f64, spec=spec)
            edges = add(multiply(lo, subtract(one, t)), multiply(hi, t))
    else:
        edges_np = np.asarray(bins, dtype=np.float64)
        if edges_np.ndim != 1 or edges_np.size < 2:
            raise ValueError("histogram: bins edges must be 1-d with >= 2")
        if np.any(np.diff(edges_np) < 0):
            raise ValueError("histogram: bins edges must be monotonic")
        nbins = edges_np.size - 1
        edges = asarray(edges_np, spec=spec)

    if len(edges.chunks[0]) > 1:
        edges = edges.rechunk((nbins + 1,))

    nb = flat.numblocks[0]
    out_dtype = f64 if wflat is not None or density else np.dtype(np.int64)
    flat_name, edges_name = flat.name, edges.name
    w_name = wflat.name if wflat is not None else None

    def bf(out_key):
        i = out_key[1]
        keys = [(flat_name, i), (edges_name, 0)]
        if w_name is not None:
            keys.append((w_name, i))
        return tuple(keys)

    def _hist_block(xb, eb, *maybe_w):
        wb = maybe_w[0] if maybe_w else None
        counts, _ = nxp.histogram(xb, bins=eb, weights=wb)
        return nxp.reshape(nxp.astype(counts, out_dtype), (1, -1))

    _hist_block.batchable = True
    args = [flat, edges] + ([wflat] if wflat is not None else [])
    partial = general_blockwise(
        _hist_block, bf, *args,
        shape=(nb, nbins), dtype=out_dtype, chunks=((1,) * nb, (nbins,)), op_name="histogram_partial",
    )
    counts = sum(partial, axis=0, dtype=out_dtype)

    if density:
        widths = diff(edges)
        total = sum(astype(counts, f64))
        counts = divide(astype(counts, f64), multiply(total, widths))
    return counts, edges


def _extent_func(a, axis=None, keepdims=True, **kwargs):
    return {
        "lo": nxp.astype(nxp.min(a, axis=axis, keepdims=keepdims), np.float64),
        "hi": nxp.astype(nxp.max(a, axis=axis, keepdims=keepdims), np.float64),
    }


def _extent_combine(a, axis=None, keepdims=True, **kwargs):
    return {
        "lo": nxp.min(a["lo"], axis=axis, keepdims=keepdims),
        "hi": nxp.max(a["hi"], axis=axis, keepdims=keepdims),
    }


def _take_lo(d):
    return d["lo"]


def _take_hi(d):
    return d["hi"]


_extent_func.batchable = _take_lo.batchable = _take_hi.batchable = True


def cov(m, /, *, rowvar=True, ddof=1):
    """The covariance matrix of chunked observations (numpy's semantics):
    centering, then one blockwise contraction, so the observation axis may
    exceed ``allowed_mem``."""
    from .creation_functions import asarray
    from .elementwise_functions import divide
    from .linear_algebra_functions import matmul, matrix_transpose

    if m.ndim != 2:
        raise ValueError("cov requires a 2-d array")
    if m.dtype not in _real_floating_dtypes:
        raise TypeError("Only real floating-point dtypes are allowed in cov")
    x = m if rowvar else matrix_transpose(m)
    n_obs = x.shape[1]
    if n_obs - ddof <= 0:
        raise ValueError("cov: not enough observations for ddof")
    centered = _subtract_mean(x, axis=1)
    return divide(
        matmul(centered, matrix_transpose(centered)),
        asarray(float(n_obs - ddof), dtype=x.dtype, spec=x.spec),
    )


def _subtract_mean(x, axis):
    from .elementwise_functions import subtract

    return subtract(x, mean(x, axis=axis, keepdims=True))


def corrcoef(m, /, *, rowvar=True):
    """The correlation matrix from :func:`cov` (numpy's semantics)."""
    from .elementwise_functions import clip, divide, sqrt
    from .linalg import diagonal

    c = cov(m, rowvar=rowvar, ddof=1)
    d = sqrt(diagonal(c))
    # rounding can push perfectly correlated entries past 1; numpy clips
    return clip(divide(c, _outer_like(d)), min=-1.0, max=1.0)


def _outer_like(d):
    from .elementwise_functions import multiply
    from .manipulation_functions import expand_dims

    return multiply(expand_dims(d, axis=1), expand_dims(d, axis=0))


def nanquantile(x, q, /, *, axis=None, keepdims=False):
    """The exact quantile ignoring NaNs (numpy.nanquantile's semantics,
    linear interpolation). The sorted axis parks NaNs at its END, so each
    lane's count of valid elements gives COMPUTED gather positions, taken
    with ``take_along_axis`` (chunked, memory-bounded); all shapes stay
    static. An all-NaN lane gives NaN."""
    from .creation_functions import asarray
    from .data_type_functions import astype
    from .elementwise_functions import add, floor, isnan, logical_not, multiply, subtract
    from .indexing_functions import take_along_axis
    from .manipulation_functions import concat, expand_dims, flatten, squeeze
    from .searching_functions import where
    from .sorting_functions import sort

    q = _check_quantile_args(x, q, "nanquantile")
    if axis is None:
        out = nanquantile(flatten(x), q, axis=0)
        if keepdims:
            for _ in range(x.ndim):
                out = expand_dims(out, axis=0)
        return out

    axis = _check_quantile_axis(x, axis, "nanquantile")
    i64, f64 = np.dtype(np.int64), np.dtype(np.float64)

    s = sort(x, axis=axis)
    # valid (non-NaN) count per lane, kept as a size-1 axis
    n_valid = sum(astype(logical_not(isnan(x)), i64), axis=axis, keepdims=True)
    nf = astype(n_valid, f64)
    qk = asarray(q, dtype=f64, spec=x.spec)
    one = asarray(1.0, dtype=f64, spec=x.spec)
    pos = multiply(qk, subtract(nf, one))  # q * (n_valid - 1)
    zero = asarray(0.0, dtype=f64, spec=x.spec)
    # n_valid == 0 gives pos = -q: clamped (the all-NaN overwrite below
    # decides the lane's value either way)
    pos = where(pos < zero, zero, pos)
    lo_f = floor(pos)
    frac = astype(subtract(pos, lo_f), x.dtype)
    lo_i = astype(lo_f, i64)
    one_i = asarray(1, dtype=i64, spec=x.spec)
    hi_i = where(add(lo_i, one_i) < n_valid, add(lo_i, one_i), lo_i)
    # ONE streamed gather for both bounds (take_along_axis reads every
    # chunk of the sorted axis per output block)
    both = take_along_axis(s, concat([lo_i, hi_i], axis=axis), axis=axis)
    sel_lo = tuple(slice(0, 1) if d == axis else slice(None) for d in range(x.ndim))
    sel_hi = tuple(slice(1, 2) if d == axis else slice(None) for d in range(x.ndim))
    v_lo, v_hi = both[sel_lo], both[sel_hi]
    out = add(multiply(v_lo, subtract(asarray(1.0, dtype=x.dtype, spec=x.spec), frac)), multiply(v_hi, frac))
    # all-NaN lanes: no valid data, NaN
    out = where(n_valid < asarray(1, dtype=i64, spec=x.spec), asarray(float("nan"), dtype=x.dtype, spec=x.spec),
                out)
    return out if keepdims else squeeze(out, axis=axis)


def nanmedian(x, /, *, axis=None, keepdims=False):
    """The exact median ignoring NaNs (see :func:`nanquantile`)."""
    return nanquantile(x, 0.5, axis=axis, keepdims=keepdims)
