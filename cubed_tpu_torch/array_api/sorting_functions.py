"""Array-API sorting functions: ``sort``, ``argsort``, ``searchsorted``,
``topk`` and ``argtopk``.

Counterpart of ``cubed_tpu/array_api/sorting_functions.py``, with the same
plans. Two regimes:

- the axis in one chunk: the sort is one blockwise kernel (the merge-sort
  kernel on the card, ``kernels/merge_sort.py``);
- a multi-chunk axis: a bitonic merge-split network over chunks
  (``_block_sort``), every task merging exactly two chunks, so an axis
  LARGER than ``allowed_mem`` sorts. Descending uses the global flip
  identities, so the network only ever sorts ascending.

The order is numpy's and XLA's: stable, NaN last, -0.0 equal to 0.0;
descending is the flip identity (values descending, ties in their first
order), as the JAX package's. uint64 rides in int64 (``backend_array_api``),
whose order differs past 2**63, so its sorts and searches are refused at
plan time.
"""

from __future__ import annotations

import os

import numpy as np

from ..backend_array_api import nxp
from ..core.ops import map_blocks
from .dtypes import _real_numeric_dtypes, uint64

#: the routing switch: ``auto`` (the memory heuristic), ``force`` (every
#: multi-chunk axis through the network, uncoarsened) or ``off`` (the
#: single-chunk path only)
NETWORK_ENV_VAR = "CUBED_TPU_TORCH_SORT_NETWORK"


def _normalize_axis(x, axis: int) -> int:
    if x.ndim == 0:
        raise ValueError("sorting requires at least one dimension")
    if not (-x.ndim <= axis < x.ndim):
        raise IndexError(f"axis {axis} is out of bounds for array of dimension {x.ndim}")
    return axis % x.ndim


def _refuse_uint64(x, name):
    if x.dtype == uint64:
        raise TypeError(f"{name} of uint64 is not supported by cubed_tpu_torch")


def _use_network(x, axis: int, out_itemsize: int | None = None) -> bool:
    """The multi-chunk network only where the single-chunk slab would strain
    the memory bound: a slab well inside ``allowed_mem`` sorts as ONE
    kernel, faster than O(log^2 m) merge rounds. The "fits" test is the
    planner's blockwise bound (``reserved + 2*input + 2*output``) over the
    single-chunk path's two ops, the rechunk to one chunk and the sort
    kernel (output at *out_itemsize*, int64 for argsort), so ``auto`` never
    routes to a plan the planner rejects. ``CUBED_TPU_TORCH_SORT_NETWORK``
    overrides (see :data:`NETWORK_ENV_VAR`)."""
    if x.numblocks[axis] <= 1 or x.shape[axis] <= 1:
        return False
    mode = _network_mode()
    if mode == "force":
        return True
    if mode == "off":
        return False
    slab_elems = x.shape[axis]
    for d in range(x.ndim):
        if d != axis:
            slab_elems *= x.chunksize[d]
    in_bytes = slab_elems * x.dtype.itemsize
    out_bytes = slab_elems * (out_itemsize or x.dtype.itemsize)
    projected = x.spec.reserved_mem + max(
        4 * in_bytes,  # rechunk to one chunk along the axis
        2 * in_bytes + 2 * out_bytes,  # the sort/argsort kernel itself
    )
    return projected > x.spec.allowed_mem


def _network_mode() -> str:
    return os.environ.get(NETWORK_ENV_VAR, "auto")


def _single_chunk_along(x, axis: int):
    if x.numblocks[axis] == 1:
        return x
    chunks = tuple(x.shape[d] if d == axis else x.chunksize[d] for d in range(x.ndim))
    return x.rechunk(chunks)


def sort(x, /, *, axis=-1, descending=False, stable=True):
    if x.dtype not in _real_numeric_dtypes:
        raise TypeError("Only real numeric dtypes are allowed in sort")
    _refuse_uint64(x, "sort")
    axis = _normalize_axis(x, axis)

    if _use_network(x, axis):
        from ._block_sort import block_sort

        out = block_sort(x, axis, coarsen=_network_mode() == "auto")
        if descending:
            from .manipulation_functions import flip

            out = flip(out, axis=axis)
        return out

    x = _single_chunk_along(x, axis)

    def _sort_chunk(a):
        out = nxp.sort(a, axis=axis)
        return nxp.flip(out, axis=axis) if descending else out

    _sort_chunk.batchable = True
    return map_blocks(_sort_chunk, x, dtype=x.dtype)


def argsort(x, /, *, axis=-1, descending=False, stable=True):
    if x.dtype not in _real_numeric_dtypes:
        raise TypeError("Only real numeric dtypes are allowed in argsort")
    _refuse_uint64(x, "argsort")
    axis = _normalize_axis(x, axis)

    if _use_network(x, axis, out_itemsize=8):
        from ..core.ops import elemwise
        from ._block_sort import block_argsort

        coarsen = _network_mode() == "auto"
        if not descending:
            return block_argsort(x, axis, coarsen=coarsen)
        # the stable-descending identity, applied globally:
        # argsort_desc(x) = flip(m-1 - argsort_asc(flip(x)))
        from .manipulation_functions import flip

        m = x.shape[axis]
        idx_r = block_argsort(flip(x, axis=axis), axis, coarsen=coarsen)

        def _mirror(i):
            return nxp.astype(m - 1 - i, np.int64)

        _mirror.batchable = True
        mapped = elemwise(_mirror, idx_r, dtype=np.dtype(np.int64))
        return flip(mapped, axis=axis)

    x = _single_chunk_along(x, axis)

    def _argsort_chunk(a):
        return nxp.astype(_stable_argsort_kernel(a, axis, descending), np.int64)

    _argsort_chunk.batchable = True
    return map_blocks(_argsort_chunk, x, dtype=np.dtype(np.int64))


def searchsorted(x1, x2, /, *, side="left", sorter=None):
    """Insertion indices of ``x2`` into the sorted 1-d ``x1`` (the 2023.12
    standard). When ``x1`` fits one task it rechunks to one chunk and the
    search is blockwise over ``x2``'s grid; when it does not (the memory
    heuristic of :func:`sort`), ``index(v) = sum_i searchsorted(x1_chunk_i,
    v)`` for either side, so the plan is per-(chunk, block) partial counts
    summed through the reduction tree."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if x1.ndim != 1:
        raise ValueError("searchsorted requires x1 to be one-dimensional")
    if x1.dtype not in _real_numeric_dtypes or x2.dtype not in _real_numeric_dtypes:
        raise TypeError("Only real numeric dtypes are allowed in searchsorted")
    _refuse_uint64(x1, "searchsorted")
    _refuse_uint64(x2, "searchsorted")
    if sorter is not None:
        if np.dtype(sorter.dtype).kind not in "iu":
            raise TypeError("sorter must be of integer type")
        if sorter.ndim != 1 or sorter.shape[0] != x1.shape[0]:
            raise ValueError(f"sorter.shape must equal x1.shape; got {sorter.shape} for x1 of shape {x1.shape}")
        from .indexing_functions import take

        x1 = take(x1, sorter)

    from ..core.ops import general_blockwise

    if _use_network(x1, 0, out_itemsize=8):
        return _searchsorted_partial_counts(x1, x2, side)

    x1 = _single_chunk_along(x1, 0)
    n1, n2 = x1.name, x2.name

    def _block_function(out_key):
        return ((n1, 0), (n2, *out_key[1:]))

    def _search_block(a1, a2):
        return nxp.astype(nxp.searchsorted(a1, a2, side=side), np.int64)

    _search_block.batchable = True
    return general_blockwise(
        _search_block, _block_function, x1, x2,
        shape=x2.shape, dtype=np.dtype(np.int64), chunks=x2.chunks if x2.ndim else (), op_name="searchsorted",
    )


def _searchsorted_partial_counts(x1, x2, side):
    """Memory-bounded searchsorted: per-(x1-chunk, x2-block) counts, summed
    over the x1-chunk axis through the reduction tree (``sum``: the
    region-sum kernel on the card)."""
    from ..core.ops import general_blockwise

    m = x1.numblocks[0]
    n1, n2 = x1.name, x2.name

    def _block_function(out_key):
        i = out_key[1]
        return ((n1, i), (n2, *out_key[2:]))

    def _partial_block(a1, a2):
        counts = nxp.astype(nxp.searchsorted(a1, a2, side=side), np.int64)
        return nxp.reshape(counts, (1,) + tuple(a2.shape))

    _partial_block.batchable = True
    partials = general_blockwise(
        _partial_block, _block_function, x1, x2,
        shape=(m,) + tuple(x2.shape), dtype=np.dtype(np.int64),
        chunks=((1,) * m,) + tuple(x2.chunks if x2.ndim else ()), op_name="searchsorted_partials",
    )
    from .statistical_functions import sum as _sum

    return _sum(partials, axis=0)


def _stable_argsort_kernel(a, axis: int, descending: bool):
    """Stable in-kernel argsort along ``axis``, either direction, for every
    real dtype. Descending never negates the keys (negation wraps unsigned
    integers and ``INT_MIN``): the flip identity
    ``argsort_desc(x) = flip(m-1 - argsort_asc(flip(x)))`` gives values
    descending, ties in first-appearance order."""
    if not descending:
        return nxp.argsort(a, axis=axis, stable=True)
    m = a.shape[axis]
    idx_r = nxp.argsort(nxp.flip(a, axis=axis), axis=axis, stable=True)
    return nxp.flip(m - 1 - idx_r, axis=axis)


def _pad_sentinel(dtype, descending: bool):
    """The least-competitive value of ``dtype`` for a top-k pad slot: one
    that can never beat a real element (``±inf`` only exists for floats)."""
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return info.min if descending else info.max
    if dt.kind == "b":
        return not descending
    return -np.inf if descending else np.inf


def _topk_args(x, k, axis, fname):
    if not isinstance(k, (int, np.integer)) or isinstance(k, bool) or k == 0:
        raise ValueError(f"{fname}: k must be a non-zero integer")
    axis = _normalize_axis(x, axis)
    if abs(int(k)) > x.shape[axis]:
        raise ValueError(f"{fname}: |k|={abs(int(k))} exceeds axis length {x.shape[axis]}")
    _refuse_uint64(x, fname)
    return int(k), axis


def _topk_impl(x, k, axis, want_indices):
    """Shared topk/argtopk engine. Fast path (k << n): ONE pass over the
    data, each block keeping its local top |k| (global indices carried
    alongside by a traced-offset multi-output op), then one task merging
    the nb*|k| survivors. Where the survivors would strain the memory bound
    (or the axis is one chunk anyway): the sort network and a static slice.
    Ties go by index, as the reference's stable order puts them."""
    from ..core.ops import _offsets_array_for, block_index_from_offset, general_blockwise

    kk, desc = abs(k), k > 0
    n = x.shape[axis]
    nb = x.numblocks[axis]
    survivors = nb * kk
    itemsize = np.dtype(x.dtype).itemsize
    allowed = x.spec.allowed_mem or (2**63)
    other = 1
    for d in range(x.ndim):
        if d != axis:
            other *= x.chunksize[d]
    merge_bytes = survivors * other * (itemsize + 8) * 4

    if nb == 1 or survivors >= n or merge_bytes > allowed:
        # network fallback: full sort then a static slice
        s = argsort(x, axis=axis, descending=desc) if want_indices else sort(x, axis=axis, descending=desc)
        sel = tuple(slice(0, kk) if d == axis else slice(None) for d in range(x.ndim))
        return s[sel]

    c = x.chunksize[axis]
    numblocks = x.numblocks
    sentinel = _pad_sentinel(x.dtype, desc)
    offsets = _offsets_array_for(x)
    x_name, off_name = x.name, offsets.name

    def bf_local(out_key):
        return ((x_name, *out_key[1:]), (off_name, *out_key[1:]))

    def _local_topk(block, off):
        bi = block_index_from_offset(off, axis, numblocks)
        order = _stable_argsort_kernel(block, axis, desc)
        ln = block.shape[axis]
        if ln >= kk:
            order = order.narrow(axis, 0, kk)
        vals = nxp.take_along_axis(block, order, axis=axis)
        idxs = nxp.astype(order + bi * c, np.int64)
        if ln >= kk:
            return vals, idxs
        pad_shape = tuple(kk - ln if d == axis else block.shape[d] for d in range(block.ndim))
        pad_v = nxp.full(pad_shape, sentinel, dtype=x.dtype)
        pad_i = nxp.full(pad_shape, -1, dtype=np.int64)
        return nxp.concatenate([vals, pad_v], axis=axis), nxp.concatenate([idxs, pad_i], axis=axis)

    _local_topk.traced_offsets = True
    _local_topk.batchable = True
    out_shape = tuple(nb * kk if d == axis else s for d, s in enumerate(x.shape))
    out_chunks = tuple((kk,) * nb if d == axis else ch for d, ch in enumerate(x.chunks))
    vals, idxs = general_blockwise(
        _local_topk, bf_local, x, offsets,
        shape=[out_shape, out_shape], dtype=[x.dtype, np.dtype(np.int64)], chunks=out_chunks,
        op_name="topk_local",
    )

    # one merge task over the nb*kk survivors
    v_name, i_name = vals.name, idxs.name

    def bf_merge(out_key):
        coords = out_key[1:]
        return (
            [(v_name, *coords[:axis], j, *coords[axis + 1:]) for j in range(nb)],
            [(i_name, *coords[:axis], j, *coords[axis + 1:]) for j in range(nb)],
        )

    def _merge_topk(v_blocks, i_blocks):
        v = nxp.concatenate(list(v_blocks), axis=axis)
        i = nxp.concatenate(list(i_blocks), axis=axis)
        order = _stable_argsort_kernel(v, axis, desc).narrow(axis, 0, kk)
        if want_indices:
            return nxp.take_along_axis(i, order, axis=axis)
        return nxp.take_along_axis(v, order, axis=axis)

    _merge_topk.batchable = True
    final_shape = tuple(kk if d == axis else s for d, s in enumerate(x.shape))
    final_chunks = tuple((kk,) if d == axis else ch for d, ch in enumerate(x.chunks))
    return general_blockwise(
        _merge_topk, bf_merge, vals, idxs,
        shape=final_shape, dtype=np.dtype(np.int64) if want_indices else x.dtype, chunks=final_chunks,
        num_input_blocks=(nb, nb), extra_projected_mem=2 * merge_bytes, op_name="topk_merge",
    )


def topk(x, k, /, *, axis=-1):
    """The ``k`` largest (k>0) or smallest (k<0) values along ``axis``,
    sorted accordingly (dask.array.topk semantics). One pass over the data
    when k << n (per-block top-k + one merge of the nb*|k| survivors); the
    sort network + a static slice otherwise."""
    k, axis = _topk_args(x, k, axis, "topk")
    return _topk_impl(x, k, axis, want_indices=False)


def argtopk(x, k, /, *, axis=-1):
    """Indices of the ``k`` largest (k>0) / smallest (k<0) values along
    ``axis`` (see :func:`topk`)."""
    k, axis = _topk_args(x, k, axis, "argtopk")
    return _topk_impl(x, k, axis, want_indices=True)
