"""Array-API searching functions. Counterpart of
``cubed_tpu/array_api/searching_functions.py``: ``argmax``/``argmin`` are
index-and-value tree reductions (``core.ops.arg_reduction``) that return the
first extremum on ties and the first NaN where there is one, as numpy and
the JAX package do; ``count_nonzero`` is a ``sum`` of the non-zero mask, so
on the card its sums are ``region_sum`` launches. ``nonzero`` is refused."""

from __future__ import annotations

import numpy as np

from ..backend_array_api import nxp
from ..core.ops import arg_reduction, elemwise
from .data_type_functions import result_type
from .dtypes import _real_numeric_dtypes, uint64
from .manipulation_functions import flatten


def argmax(x, /, *, axis=None, keepdims=False, split_every=None):
    if x.dtype not in _real_numeric_dtypes:
        raise TypeError("Only real numeric dtypes are allowed in argmax")
    return _arg_reduce(x, nxp.argmax, nxp.max, axis, keepdims, "argmax")


def argmin(x, /, *, axis=None, keepdims=False, split_every=None):
    if x.dtype not in _real_numeric_dtypes:
        raise TypeError("Only real numeric dtypes are allowed in argmin")
    return _arg_reduce(x, nxp.argmin, nxp.min, axis, keepdims, "argmin")


def _arg_reduce(x, arg_func, val_func, axis, keepdims, name):
    if x.dtype == uint64:
        # uint64 rides in int64 (backend_array_api), whose order differs past 2**63
        raise TypeError(f"{name} of uint64 is not supported by cubed_tpu_torch")
    orig_ndim = x.ndim
    if axis is None:
        x = flatten(x)
        axis = 0
    out = arg_reduction(x, arg_func, val_func, axis=axis, dtype=np.dtype(np.int64))
    if keepdims:
        from .manipulation_functions import expand_dims

        if orig_ndim != x.ndim:
            # axis=None keeps every axis as a singleton
            return expand_dims(out, axis=tuple(range(orig_ndim)))
        return expand_dims(out, axis=axis % x.ndim)
    return out


def where(condition, x1, x2, /):
    return elemwise(nxp.where, condition, x1, x2, dtype=result_type(x1, x2))


def count_nonzero(x, /, *, axis=None, keepdims=False, split_every=None):
    """The number of non-zero elements: a ``sum`` of the ``x != 0`` mask."""
    from .data_type_functions import astype
    from .dtypes import int64
    from .statistical_functions import sum as _sum

    mask = elemwise(_nonzero, x, dtype=np.dtype(np.bool_))
    return _sum(astype(mask, int64), axis=axis, keepdims=keepdims, split_every=split_every)


def _nonzero(a):
    return a != 0


def nonzero(x, /):
    """Refused: the output shape depends on the data, which a lazy plan of
    static shapes cannot express. ``where`` and ``count_nonzero`` cover the
    uses whose shapes are static."""
    raise NotImplementedError(
        "nonzero has a data-dependent output shape, which a lazy, "
        "statically-shaped plan cannot express. Use where(cond, a, b) "
        "for selection, count_nonzero for counting, or compute the "
        "array and call numpy's nonzero on the result."
    )
