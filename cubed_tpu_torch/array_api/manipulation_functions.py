"""Array-API manipulation functions. Counterpart of
``cubed_tpu/array_api/manipulation_functions.py``, trimmed to ``squeeze``
(which reductions use to drop their reduced axes)."""

from __future__ import annotations

import numpy as np

from ..backend_array_api import nxp
from ..core.ops import general_blockwise


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
