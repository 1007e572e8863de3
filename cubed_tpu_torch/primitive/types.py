"""Shared primitive-layer types. Counterpart of ``cubed_tpu/primitive/types.py``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

from ..storage.zarr import open_if_lazy_zarr_array


@dataclass
class CubedPipeline:
    """An op's payload: a task function mapped over a task-input iterable."""

    function: Callable
    name: str
    mappable: Iterable
    config: Any


@dataclass
class PrimitiveOperation:
    """Metadata and the pipeline of one primitive operation."""

    pipeline: CubedPipeline
    source_array_names: list
    target_array: Any
    projected_mem: int
    allowed_mem: int
    reserved_mem: int
    num_tasks: int
    fusable: bool = True
    write_chunks: Optional[tuple] = None
    #: all output arrays of a multi-output op (primary first); None for
    #: ordinary single-output ops
    target_arrays: Optional[list] = None


class CubedArrayProxy:
    """A concrete, lazy or virtual array as a task reads or writes it:
    ``open()`` resolves a LazyZarrArray to its store when the task runs."""

    def __init__(self, array: Any, chunks: tuple):
        self.array = array
        self.chunks = tuple(chunks)

    def open(self):
        return open_if_lazy_zarr_array(self.array)

    def __repr__(self) -> str:
        return f"CubedArrayProxy({self.array!r}, chunks={self.chunks})"


@dataclass
class CubedCopySpec:
    """A copy op's payload (a rechunk stage): the region a task reads from
    ``read`` is written to the same region of ``write``."""

    read: CubedArrayProxy
    write: CubedArrayProxy


class MemoryModeller:
    """Models peak memory of an alloc/free sequence (bounds fused ops)."""

    def __init__(self) -> None:
        self.current_mem = 0
        self.peak_mem = 0

    def allocate(self, num_bytes: int) -> None:
        self.current_mem += num_bytes
        self.peak_mem = max(self.peak_mem, self.current_mem)

    def free(self, num_bytes: int) -> None:
        self.current_mem -= num_bytes
        self.peak_mem = max(self.peak_mem, self.current_mem)
