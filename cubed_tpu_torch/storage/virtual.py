"""Virtual arrays: inputs that are never materialized in storage but plug into
the chunk-read path. Counterpart of ``cubed_tpu/storage/virtual.py``. A read
counts its logical bytes as ``virtual_bytes_read`` (no IO)."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..chunks import blockdims_from_blockshape
from ..observability.accounting import record_virtual_read
from ..utils import broadcast_trick

#: Arrays at or under this size may be kept in memory and shipped with the plan
MAX_IN_MEMORY_BYTES = 1_000_000


def _normalize_key(key, shape):
    if not isinstance(key, tuple):
        key = (key,)
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - (len(key) - 1)) + key[i + 1 :]
    key = key + (slice(None),) * (len(shape) - len(key))
    return tuple(
        slice(*k.indices(s)) if isinstance(k, slice) else slice(int(k), int(k) + 1)
        for k, s in zip(key, shape)
    )


class _VirtualBase:
    shape: tuple[int, ...]
    dtype: np.dtype
    chunks: tuple[int, ...]

    def chunkset(self):
        return blockdims_from_blockshape(self.shape, self.chunks)

    def open(self):
        return self


class VirtualEmptyArray(_VirtualBase):
    """Uninitialized array; reads return a stride-0 broadcast (no allocation)."""

    def __init__(self, shape: Sequence[int], dtype: Any, chunks: Sequence[int]):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.chunks = tuple(int(c) for c in chunks) if self.shape else ()

    def __getitem__(self, key) -> np.ndarray:
        sel = _normalize_key(key, self.shape)
        shape = tuple(max(0, s.stop - s.start) for s in sel)
        out = broadcast_trick(np.empty)(shape, dtype=self.dtype)
        record_virtual_read(int(np.prod(shape or (1,))) * self.dtype.itemsize)
        return out


class VirtualFullArray(_VirtualBase):
    """Constant-valued array (``full``, ``zeros``, ``ones``); reads return a
    stride-0 broadcast of one element. The device executor fills it on the
    card instead of reading it."""

    def __init__(self, shape: Sequence[int], dtype: Any, chunks: Sequence[int], fill_value):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.chunks = tuple(int(c) for c in chunks) if self.shape else ()
        self.fill_value = fill_value

    def __getitem__(self, key) -> np.ndarray:
        sel = _normalize_key(key, self.shape)
        shape = tuple(max(0, s.stop - s.start) for s in sel)
        out = broadcast_trick(np.full)(shape, self.fill_value, dtype=self.dtype)
        record_virtual_read(int(np.prod(shape or (1,))) * self.dtype.itemsize)
        return out

    @property
    def oindex(self):
        return _ConstantOIndex(self)


class _ConstantOIndex:
    """Orthogonal indexing of a constant array: only the shape is selected."""

    def __init__(self, array):
        self.array = array

    def __getitem__(self, key) -> np.ndarray:
        a = self.array
        shape = tuple(len(ix) for ix in oindex_lists(key, a.shape))
        record_virtual_read(int(np.prod(shape or (1,))) * a.dtype.itemsize)
        return broadcast_trick(np.full)(shape, a.fill_value, dtype=a.dtype)


def oindex_lists(key, shape) -> list:
    """Per-axis integer positions of an orthogonal selection (slices, with
    any step, or integer arrays; negative positions count from the end)."""
    if not isinstance(key, tuple):
        key = (key,)
    key = key + (slice(None),) * (len(shape) - len(key))
    out = []
    for k, s in zip(key, shape):
        if isinstance(k, slice):
            out.append(np.arange(*k.indices(s)))
        else:
            arr = np.atleast_1d(np.asarray(k)).astype(np.int64)
            out.append(np.where(arr < 0, arr + s, arr))
    return out


class VirtualOffsetsArray(_VirtualBase):
    """Maps each (1,...,1)-shaped chunk to ``base +`` its linear block offset.

    The hidden input of ``map_blocks`` calls that need ``block_id``, and the
    seed input of ``random`` (``base`` is the root seed). Its chunks are host
    metadata and stay numpy arrays on the read path: they are never copied to
    the device.
    """

    def __init__(self, shape: Sequence[int], base: int = 0):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(np.int64)
        self.chunks = (1,) * len(self.shape)
        self.base = int(base)

    def __getitem__(self, key) -> np.ndarray:
        sel = _normalize_key(key, self.shape)
        if any(s.stop - s.start != 1 for s in sel):
            raise IndexError("VirtualOffsetsArray must be read one block at a time")
        idx = tuple(s.start for s in sel)
        offset = int(np.ravel_multi_index(idx, self.shape)) if self.shape else 0
        record_virtual_read(self.dtype.itemsize)
        return np.full((1,) * len(self.shape), self.base + offset, dtype=self.dtype)


class VirtualInMemoryArray(_VirtualBase):
    """A small literal array carried with the plan (for ``asarray``)."""

    def __init__(self, array: np.ndarray, chunks: Sequence[int]):
        if array.nbytes > MAX_IN_MEMORY_BYTES:
            raise ValueError(
                f"Size of in memory array is {array.nbytes} which exceeds maximum "
                f"of {MAX_IN_MEMORY_BYTES}. Consider loading the array from "
                "storage using `from_array`."
            )
        self.array = np.asarray(array)
        self.shape = self.array.shape
        self.dtype = self.array.dtype
        self.chunks = tuple(int(c) for c in chunks) if self.shape else ()

    def __getitem__(self, key) -> np.ndarray:
        out = self.array[key]
        record_virtual_read(getattr(out, "nbytes", 0))
        return out

    @property
    def oindex(self):
        return _InMemoryOIndex(self)


class _InMemoryOIndex:
    def __init__(self, array: VirtualInMemoryArray):
        self.array = array

    def __getitem__(self, key) -> np.ndarray:
        out = self.array.array[np.ix_(*oindex_lists(key, self.array.shape))]
        record_virtual_read(out.nbytes)
        return out


def virtual_empty(shape, *, dtype, chunks) -> VirtualEmptyArray:
    return VirtualEmptyArray(shape, dtype, chunks)


def virtual_full(shape, fill_value, *, dtype, chunks) -> VirtualFullArray:
    return VirtualFullArray(shape, dtype, chunks, fill_value)


def virtual_offsets(shape) -> VirtualOffsetsArray:
    return VirtualOffsetsArray(shape)


def virtual_in_memory(array, chunks) -> VirtualInMemoryArray:
    return VirtualInMemoryArray(array, chunks)
