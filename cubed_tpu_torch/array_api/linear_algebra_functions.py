"""Array-API linear algebra: ``matmul``, ``tensordot``, ``vecdot``, ``outer``
and ``matrix_transpose``.

Counterpart of ``cubed_tpu/array_api/linear_algebra_functions.py``, with the
same plans. ``matmul`` and ``tensordot`` are blockwise contractions that keep
each contracted axis as a size-1 axis of one block per contracted block,
then sum it away with the port's ``sum`` machinery (``nxp.sum``, so the
region-sum kernel on the card). The per-block product is ``nxp.matmul`` /
``nxp.tensordot`` (cuBLAS on the card, through torch), as the JAX package's
is ``jnp.matmul``, outside any Pallas kernel; a float32 product runs at the
device executor's ``matmul_precision`` (``cubed_tpu_torch/contraction.py``),
on the batched route too.
"""

from __future__ import annotations

import numpy as np

from ..backend_array_api import nxp
from ..core.ops import blockwise, elemwise, reduction
from .data_type_functions import result_type
from .dtypes import _numeric_dtypes
from .manipulation_functions import _squeeze_axes, expand_dims, permute_dims


def matmul(x1, x2, /):
    if x1.dtype not in _numeric_dtypes or x2.dtype not in _numeric_dtypes:
        raise TypeError("Only numeric dtypes are allowed in matmul")
    if x1.ndim == 0 or x2.ndim == 0:
        raise ValueError("matmul does not support 0-d arrays")

    x1_is_1d = x1.ndim == 1
    x2_is_1d = x2.ndim == 1
    if x1_is_1d:
        x1 = expand_dims(x1, axis=0)
    if x2_is_1d:
        x2 = expand_dims(x2, axis=x2.ndim)
    if x1.shape[-1] != x2.shape[-2]:
        raise ValueError("arrays must be aligned for matmul")
    dtype = result_type(x1, x2)

    # symbols: the batch axes (broadcast), then i, j and k, the contracted
    # axis, kept as a size-1 axis between i and j
    nb = max(x1.ndim, x2.ndim) - 2
    i_sym, j_sym, k_sym = nb, nb + 1, nb + 2
    x1_ind = tuple(range(nb - (x1.ndim - 2), nb)) + (i_sym, k_sym)
    x2_ind = tuple(range(nb - (x2.ndim - 2), nb)) + (k_sym, j_sym)
    out_ind = tuple(range(nb)) + (i_sym, k_sym, j_sym)

    # the per-block product materialises before the k-sum consumes it and
    # the write copies it once more: three output blocks beyond the model,
    # as the JAX package prices it
    batch_chunk = 1
    for p in range(nb):
        c1 = x1.chunksize[x1.ndim - 3 - p] if x1.ndim - 3 - p >= 0 else 1
        c2 = x2.chunksize[x2.ndim - 3 - p] if x2.ndim - 3 - p >= 0 else 1
        batch_chunk *= max(c1, c2)
    out_block_elems = batch_chunk * x1.chunksize[-2] * x2.chunksize[-1]

    out = blockwise(
        _matmul_block, out_ind, x1, x1_ind, x2, x2_ind,
        dtype=dtype,
        adjust_chunks={k_sym: 1},
        extra_projected_mem=3 * out_block_elems * np.dtype(dtype).itemsize,
    )
    out = _sum_contraction(out, axis=nb + 1)
    if x1_is_1d:
        out = _squeeze_axes(out, ((out.ndim - 2) % out.ndim,))
    if x2_is_1d:
        out = _squeeze_axes(out, ((out.ndim - 1) % out.ndim,))
    return out


def _matmul_block(a, b):
    # batch + (i, j), with the size-1 contraction axis between i and j
    return nxp.expand_dims(nxp.matmul(a, b), axis=-2)


_matmul_block.batchable = True


def _sum_contraction(x, axis):
    return reduction(
        x, _sum_keep, combine_func=_sum_keep, axis=axis,
        intermediate_dtype=x.dtype, dtype=x.dtype, keepdims=False,
    )


def _sum_keep(a, axis=None, keepdims=True, **kw):
    return nxp.sum(a, axis=axis, keepdims=keepdims)


# a sum (read by the device executor's fusion rule) that runs under
# torch.func.vmap (read by its batched route)
_sum_keep.reduce_kind = "sum"
_sum_keep.batchable = True


def matrix_transpose(x, /):
    if x.ndim < 2:
        raise ValueError("x must be at least 2-dimensional")
    return permute_dims(x, tuple(range(x.ndim - 2)) + (x.ndim - 1, x.ndim - 2))


def outer(x1, x2, /):
    if x1.ndim != 1 or x2.ndim != 1:
        raise ValueError("outer requires 1-d arrays")
    return blockwise(_outer_block, (0, 1), x1, (0,), x2, (1,), dtype=result_type(x1, x2))


def _outer_block(a, b):
    return nxp.multiply(a[:, None], b[None, :])


_outer_block.batchable = True


def tensordot(x1, x2, /, *, axes=2):
    if x1.dtype not in _numeric_dtypes or x2.dtype not in _numeric_dtypes:
        raise TypeError("Only numeric dtypes are allowed in tensordot")
    if isinstance(axes, (int, np.integer)):
        axes = (tuple(range(x1.ndim - axes, x1.ndim)), tuple(range(axes)))
    ax1, ax2 = axes
    if isinstance(ax1, (int, np.integer)):
        ax1 = (ax1,)
    if isinstance(ax2, (int, np.integer)):
        ax2 = (ax2,)
    ax1 = tuple(a % x1.ndim for a in ax1)
    ax2 = tuple(a % x2.ndim for a in ax2)
    if len(ax1) != len(ax2):
        raise ValueError("tensordot axes must have the same length")
    dtype = result_type(x1, x2)

    # symbols: x1's free axes, x2's free axes, then the contracted ones
    free1 = [d for d in range(x1.ndim) if d not in ax1]
    free2 = [d for d in range(x2.ndim) if d not in ax2]
    sym1 = {d: i for i, d in enumerate(free1)}
    sym2 = {d: len(free1) + i for i, d in enumerate(free2)}
    c_syms = []
    for i, (a1, a2) in enumerate(zip(ax1, ax2)):
        s = len(free1) + len(free2) + i
        sym1[a1] = sym2[a2] = s
        c_syms.append(s)
    x1_ind = tuple(sym1[d] for d in range(x1.ndim))
    x2_ind = tuple(sym2[d] for d in range(x2.ndim))
    # the contracted axes stay as size-1 axes between the free ones, then
    # are summed away
    out_ind = tuple(sym1[d] for d in free1) + tuple(c_syms) + tuple(sym2[d] for d in free2)

    out_block_elems = 1
    for d in free1:
        out_block_elems *= x1.chunksize[d]
    for d in free2:
        out_block_elems *= x2.chunksize[d]
    out = blockwise(
        _TensordotBlock(ax1, ax2, len(free1), len(ax1)), out_ind, x1, x1_ind, x2, x2_ind,
        dtype=dtype,
        adjust_chunks={s: 1 for s in c_syms},
        extra_projected_mem=3 * out_block_elems * np.dtype(dtype).itemsize,
    )
    for _ in range(len(ax1)):
        out = _sum_contraction(out, axis=len(free1))
    return out


class _TensordotBlock:
    """One block's tensordot, the contracted axes kept as size-1 axes."""

    __name__ = "tensordot_block"
    batchable = True

    def __init__(self, ax1, ax2, n_free1, n_c):
        self.ax1 = ax1
        self.ax2 = ax2
        self.n_free1 = n_free1
        self.n_c = n_c

    def __call__(self, a, b):
        out = nxp.tensordot(a, b, axes=(self.ax1, self.ax2))
        for _ in range(self.n_c):
            out = nxp.expand_dims(out, axis=self.n_free1)
        return out


def vecdot(x1, x2, /, *, axis=-1):
    from .elementwise_functions import multiply
    from .statistical_functions import sum as _sum

    if np.dtype(x1.dtype).kind == "c":
        x1 = elemwise(nxp.conj, x1, dtype=x1.dtype)
    return _sum(multiply(x1, x2), axis=axis)
