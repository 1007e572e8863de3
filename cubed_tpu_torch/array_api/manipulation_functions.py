"""Array-API manipulation functions. Counterpart of
``cubed_tpu/array_api/manipulation_functions.py``, trimmed to
``expand_dims`` and ``permute_dims`` (the contractions of
``linear_algebra_functions`` are built on them) and ``squeeze`` (which
reductions use to drop their reduced axes)."""

from __future__ import annotations

import numpy as np

from ..backend_array_api import nxp
from ..core.ops import blockwise, general_blockwise


def expand_dims(x, /, *, axis=0):
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    out_ndim = x.ndim + len(axis)
    axis = tuple(ax % out_ndim for ax in axis)

    def _expand(chunk):
        return nxp.expand_dims(chunk, axis=axis)

    _expand.batchable = True
    return blockwise(
        _expand,
        tuple(range(out_ndim)),
        x,
        tuple(i for i in range(out_ndim) if i not in axis),
        dtype=x.dtype,
        new_axes={ax: 1 for ax in axis},
        align_arrays=False,
    )


def permute_dims(x, /, axes=None):
    if axes is None:
        axes = tuple(range(x.ndim))[::-1]
    if len(axes) != x.ndim:
        raise ValueError("axes don't match array")
    axes = tuple(axes)

    def _transpose(chunk):
        return nxp.permute_dims(chunk, axes)

    _transpose.batchable = True
    return blockwise(
        _transpose,
        axes,
        x,
        tuple(range(x.ndim)),
        dtype=x.dtype,
        extra_projected_mem=x.chunkmem,  # a C-order copy of the transposed chunk
    )


def squeeze(x, /, axis=None):
    if axis is None:
        axis = tuple(i for i, s in enumerate(x.shape) if s == 1)
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    axis = tuple(ax % x.ndim for ax in axis)
    if any(x.shape[ax] != 1 for ax in axis):
        raise ValueError(f"cannot squeeze axes {axis} of shape {x.shape}")
    return _squeeze_axes(x, axis)


def _squeeze_axes(x, axis: tuple[int, ...]):
    """Drop single-block size-1 axes via an explicit 1:1 block mapping."""
    if not axis:
        return x
    axis = tuple(sorted(ax % x.ndim for ax in axis))
    keep = [i for i in range(x.ndim) if i not in axis]
    x_name = x.name

    def block_function(out_key):
        it = iter(out_key[1:])
        return ((x_name, *(0 if i in axis else next(it) for i in range(x.ndim))),)

    def _sq(chunk):
        return nxp.squeeze(chunk, axis=axis)

    _sq.__name__ = "squeeze"
    _sq.batchable = True
    return general_blockwise(
        _sq, block_function, x,
        shape=tuple(x.shape[i] for i in keep),
        dtype=x.dtype,
        chunks=tuple(x.chunks[i] for i in keep),
        op_name="squeeze",
    )
