"""Lazy Zarr arrays: metadata is written only when the plan's ``create-arrays``
op runs. Counterpart of ``cubed_tpu/storage/zarr.py``."""

from __future__ import annotations

from math import prod
from typing import Any, Optional, Sequence

import numpy as np

from ..chunks import blockdims_from_blockshape
from .store import ZarrV2Array, open_zarr_array


class LazyZarrArray:
    """A Zarr array template that has not yet been written to storage."""

    def __init__(
        self,
        store: str,
        shape: Sequence[int],
        dtype: Any,
        chunks: Sequence[int],
        fill_value: Any = None,
        storage_options: Optional[dict] = None,
    ):
        self.store = str(store)
        self.storage_options = storage_options
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.chunks = tuple(int(c) for c in chunks)
        self.fill_value = fill_value

    @property
    def nbytes(self) -> int:
        return (prod(self.shape) if self.shape else 1) * self.dtype.itemsize

    def chunkset(self) -> tuple[tuple[int, ...], ...]:
        return blockdims_from_blockshape(self.shape, self.chunks)

    def create(self) -> ZarrV2Array:
        """Write the array metadata, or open the metadata already there (its
        compressor included, as ``to_zarr`` stamps it), keeping chunks a
        previous run wrote."""
        return open_zarr_array(
            self.store, mode="a", shape=self.shape, dtype=self.dtype,
            chunks=self.chunks, fill_value=self.fill_value, storage_options=self.storage_options,
        )

    def open(self) -> ZarrV2Array:
        return open_zarr_array(self.store, mode="r", storage_options=self.storage_options)

    def __repr__(self) -> str:
        return f"LazyZarrArray<{self.store}, shape={self.shape}, dtype={self.dtype}, chunks={self.chunks}>"


def lazy_empty(shape, *, dtype, chunks, store, storage_options=None) -> LazyZarrArray:
    return LazyZarrArray(store, shape, dtype, chunks, storage_options=storage_options)


def open_if_lazy_zarr_array(array):
    """Resolve a LazyZarrArray to its concrete store; pass others through."""
    if isinstance(array, LazyZarrArray):
        return array.open()
    return array
