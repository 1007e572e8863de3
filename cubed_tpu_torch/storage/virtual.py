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


def virtual_empty(shape, *, dtype, chunks) -> VirtualEmptyArray:
    return VirtualEmptyArray(shape, dtype, chunks)


def virtual_offsets(shape) -> VirtualOffsetsArray:
    return VirtualOffsetsArray(shape)


def virtual_in_memory(array, chunks) -> VirtualInMemoryArray:
    return VirtualInMemoryArray(array, chunks)
