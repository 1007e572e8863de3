"""Array-API indexing functions. Counterpart of
``cubed_tpu/array_api/indexing_functions.py``: ``take`` is an integer-array
index; ``take_along_axis`` streams x's blocks along the axis through each
output block, one at a time, so an axis larger than ``allowed_mem`` gathers
within the bound. numpy's ``take_along_axis`` is ``torch.take_along_dim``,
which takes int64 indices."""

from __future__ import annotations

import numpy as np
import torch

from ..core.ops import general_blockwise
from .dtypes import _integer_dtypes


def take(x, indices, /, *, axis=None):
    if axis is None:
        if x.ndim != 1:
            raise ValueError("axis must be specified for multi-dimensional take")
        axis = 0
    axis = axis % x.ndim
    return x[(slice(None),) * axis + (indices,)]


def take_along_axis(x, indices, /, *, axis=-1):
    """Values of x along *axis* at per-position *indices*. The output has
    the chunk grid of *indices*; each output block takes x's blocks along
    the axis one at a time, gathering the positions each holds. An index
    out of range is clamped to the nearest block edge (the standard leaves
    it unspecified; no plan-time check can see data)."""
    if x.ndim == 0:
        raise ValueError("take_along_axis requires at least 1 dimension")
    if indices.dtype not in _integer_dtypes:
        raise TypeError("indices must have an integer dtype")
    if indices.ndim != x.ndim:
        raise ValueError(f"indices must have the same rank as x ({indices.ndim} != {x.ndim})")
    axis = axis % x.ndim
    try:
        out_nonaxis = [
            np.broadcast_shapes((indices.shape[d],), (x.shape[d],))[0] if d != axis else None
            for d in range(x.ndim)
        ]
    except ValueError:
        raise ValueError("indices shape must be broadcast-compatible with x except along axis; "
                         f"got {indices.shape} vs {x.shape} (axis={axis})") from None
    from .manipulation_functions import broadcast_to

    x_target = tuple(x.shape[axis] if d == axis else out_nonaxis[d] for d in range(x.ndim))
    idx_target = tuple(indices.shape[axis] if d == axis else out_nonaxis[d] for d in range(x.ndim))
    if tuple(x.shape) != x_target:
        x = broadcast_to(x, x_target)
    if tuple(indices.shape) != idx_target:
        indices = broadcast_to(indices, idx_target)
    # each output block pairs with the x blocks of its off-axis coordinates
    target = tuple(indices.chunks[d] if d == axis else x.chunks[d] for d in range(x.ndim))
    if indices.chunks != target:
        indices = indices.rechunk(target)

    n = x.shape[axis]
    sizes = [int(c) for c in x.chunks[axis]]
    starts = np.cumsum([0] + sizes[:-1]).tolist()
    m = len(sizes)
    idx_name, x_name = indices.name, x.name

    def block_function(out_key):
        coords = out_key[1:]
        x_keys = [(x_name, *(j if d == axis else c for d, c in enumerate(coords))) for j in range(m)]
        return ((idx_name, *coords), iter(x_keys))

    def gather_kernel(idx_chunk, x_iter):
        # index arithmetic in int64: a narrow index dtype would overflow
        idxn = idx_chunk.to(torch.int64)
        idxn = torch.where(idxn < 0, idxn + n, idxn)
        acc = None
        for j, xb in enumerate(x_iter):
            lo, size = starts[j], sizes[j]
            gathered = torch.take_along_dim(xb, (idxn - lo).clamp(0, size - 1), dim=axis)
            if acc is None:
                acc = gathered
            else:
                acc = torch.where((idxn >= lo) & (idxn < lo + size), gathered, acc)
        return acc

    gather_kernel.__name__ = "take_along_axis"
    out_chunk = tuple(indices.chunksize[d] if d == axis else x.chunksize[d] for d in range(x.ndim))
    # streamed temporaries: the clamped positions (int64), the gathered
    # values, the mask and the where copy
    extra = 2 * int(np.prod(out_chunk)) * x.dtype.itemsize + 2 * int(np.prod(out_chunk)) * 8
    return general_blockwise(
        gather_kernel, block_function, indices, x,
        shape=indices.shape, dtype=x.dtype, chunks=indices.chunks,
        extra_projected_mem=extra, num_input_blocks=(1, m), op_name="take_along_axis",
    )
