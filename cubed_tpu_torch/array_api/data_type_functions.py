"""Array-API data type functions. Counterpart of
``cubed_tpu/array_api/data_type_functions.py``, trimmed to ``astype``,
``can_cast`` and ``result_type``."""

from __future__ import annotations

import numpy as np

from ..backend_array_api import nxp
from ..core.ops import map_blocks
from .dtypes import promote_types


def astype(x, dtype, /, *, copy: bool = True):
    dtype = np.dtype(dtype)
    if not copy and dtype == x.dtype:
        return x
    if x.dtype == np.uint64 and dtype.kind in "fc":
        # uint64 rides in int64 (backend_array_api): values past 2**63 would
        # convert as negative numbers
        raise TypeError("astype from uint64 to a floating dtype is not supported by cubed_tpu_torch")

    def _astype(a, astype_dtype=None):
        return nxp.astype(a, astype_dtype)

    _astype.batchable = True

    return map_blocks(_astype, x, dtype=dtype, astype_dtype=dtype)


def can_cast(from_, to, /) -> bool:
    from_ = np.dtype(from_.dtype if hasattr(from_, "dtype") else from_)
    to = np.dtype(to)
    try:
        return promote_types(from_, to) == to
    except TypeError:
        return False


def result_type(*arrays_and_dtypes):
    """Array-API type promotion (no value-based promotion)."""
    dtypes = [
        np.dtype(a.dtype) if hasattr(a, "dtype") else np.dtype(a)
        for a in arrays_and_dtypes
        if not (isinstance(a, (int, float, complex)) and not hasattr(a, "dtype"))
    ]
    if not dtypes:
        raise ValueError("at least one array or dtype is required")
    t = dtypes[0]
    for other in dtypes[1:]:
        t = promote_types(t, other)
    return t
