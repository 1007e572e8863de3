"""Array-API utility functions. Counterpart of
``cubed_tpu/array_api/utility_functions.py``: ``all``/``any`` are tree
reductions; ``diff`` subtracts two shifted slices, once per order, after an
optional concat of ``prepend`` and ``append``."""

from __future__ import annotations

import numpy as np

from ..backend_array_api import nxp
from ..core.ops import reduction


def all(x, /, *, axis=None, keepdims=False, split_every=None):  # noqa: A001
    if x.size == 0:
        from .creation_functions import asarray

        return asarray(True, dtype=np.bool_, spec=x.spec)
    return reduction(x, _all_fn, axis=axis, dtype=np.dtype(np.bool_), keepdims=keepdims, split_every=split_every)


def any(x, /, *, axis=None, keepdims=False, split_every=None):  # noqa: A001
    if x.size == 0:
        from .creation_functions import asarray

        return asarray(False, dtype=np.bool_, spec=x.spec)
    return reduction(x, _any_fn, axis=axis, dtype=np.dtype(np.bool_), keepdims=keepdims, split_every=split_every)


def _all_fn(a, axis=None, keepdims=True, **kw):
    return nxp.all(a, axis=axis, keepdims=keepdims)


def _any_fn(a, axis=None, keepdims=True, **kw):
    return nxp.any(a, axis=axis, keepdims=keepdims)


_all_fn.batchable = _any_fn.batchable = True


def diff(x, /, *, axis=-1, n=1, prepend=None, append=None):
    """The n-th discrete difference along *axis*."""
    if x.ndim == 0:
        raise ValueError("diff requires at least one dimension")
    if n < 0:
        raise ValueError("n must be non-negative")
    axis = axis % x.ndim
    parts = [p for p in (prepend, x, append) if p is not None]
    if len(parts) > 1:
        from .manipulation_functions import concat

        x = concat(parts, axis=axis)
    from .elementwise_functions import subtract

    for _ in range(n):
        lo = tuple(slice(1, None) if d == axis else slice(None) for d in range(x.ndim))
        hi = tuple(slice(None, -1) if d == axis else slice(None) for d in range(x.ndim))
        x = subtract(x[lo], x[hi])
    return x
