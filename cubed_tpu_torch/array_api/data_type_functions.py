"""Array-API data type functions. Counterpart of
``cubed_tpu/array_api/data_type_functions.py``. ``finfo`` and ``iinfo``
report the declared dtype (numpy's), never the signed carrier that holds
uint16, uint32 and uint64 chunks on the device."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..backend_array_api import nxp
from ..core.ops import map_blocks
from .dtypes import (
    _boolean_dtypes,
    _complex_floating_dtypes,
    _integer_dtypes,
    _numeric_dtypes,
    _real_floating_dtypes,
    _signed_integer_dtypes,
    _unsigned_integer_dtypes,
    promote_types,
)


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


@dataclass
class finfo_object:
    bits: int
    eps: float
    max: float
    min: float
    smallest_normal: float
    dtype: np.dtype


@dataclass
class iinfo_object:
    bits: int
    max: int
    min: int
    dtype: np.dtype


def finfo(type, /) -> finfo_object:  # noqa: A002
    fi = np.finfo(np.dtype(getattr(type, "dtype", type)))
    return finfo_object(fi.bits, float(fi.eps), float(fi.max), float(fi.min), float(fi.smallest_normal), fi.dtype)


def iinfo(type, /) -> iinfo_object:  # noqa: A002
    dt = np.dtype(getattr(type, "dtype", type))
    ii = np.iinfo(dt)
    return iinfo_object(ii.bits, int(ii.max), int(ii.min), dt)


_KINDS = {
    "bool": _boolean_dtypes,
    "signed integer": _signed_integer_dtypes,
    "unsigned integer": _unsigned_integer_dtypes,
    "integral": _integer_dtypes,
    "real floating": _real_floating_dtypes,
    "complex floating": _complex_floating_dtypes,
    "numeric": _numeric_dtypes,
}


def isdtype(dtype, kind) -> bool:
    if isinstance(kind, tuple):
        return any(isdtype(dtype, k) for k in kind)
    dtype = np.dtype(dtype)
    if isinstance(kind, str):
        if kind not in _KINDS:
            raise ValueError(f"Unrecognized data type kind: {kind!r}")
        return dtype in _KINDS[kind]
    return dtype == np.dtype(kind)


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
