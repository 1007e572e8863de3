"""The rechunk primitive: change an array's chunking without changing its
shape or dtype, under the plan-time memory bound.

Counterpart of ``cubed_tpu/primitive/rechunk.py``, with the same planner, so
both packages plan a rechunk into the same copy ops: copy directly when the
source region covering one write chunk fits the budget; otherwise stage
through intermediate arrays, either the elementwise minimum of source and
target chunks (two bounded passes) or a geometric sequence of stages,
whichever needs fewer IO operations. Write chunks are consolidated up to the
budget to cut task counts.

A task copies one region from storage to storage (:func:`copy_read_to_write`).
The device executor aliases a resident source instead and copies nothing
(``runtime/executors/cuda.py``); this path remains its spill path.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np

from ..chunks import blockdims_from_blockshape
from ..storage.zarr import LazyZarrArray, lazy_empty
from ..utils import gensym, get_item, memory_repr
from .types import CubedArrayProxy, CubedCopySpec, CubedPipeline, PrimitiveOperation


def copy_read_to_write(chunk_key, *, config: CubedCopySpec) -> None:
    """Task body: read one region of the source and write it to the target.
    The tasks of one op write disjoint regions, each a whole number of the
    target's chunks (or the array's edge), so no two tasks share a chunk."""
    data = config.read.open()[chunk_key]
    config.write.open()[chunk_key] = data


class ChunkKeys:
    """The regions of the write-chunk grid, as tuples of slices, in C order."""

    def __init__(self, shape: tuple[int, ...], write_chunks: tuple[int, ...]):
        self.shape = shape
        self.write_chunks = write_chunks

    def __iter__(self):
        chunkset = blockdims_from_blockshape(self.shape, self.write_chunks)
        for idx in itertools.product(*(range(len(c)) for c in chunkset)):
            yield get_item(chunkset, idx)

    def __len__(self):
        chunkset = blockdims_from_blockshape(self.shape, self.write_chunks)
        return math.prod(len(c) for c in chunkset)


def _covering_bytes(
    shape: tuple[int, ...],
    region_chunks: tuple[int, ...],
    source_chunks: tuple[int, ...],
    itemsize: int,
) -> int:
    """Worst-case bytes of the source-chunk-aligned region covering one
    region_chunks-sized write region."""
    total = itemsize
    for s, r, c in zip(shape, region_chunks, source_chunks):
        covered = min(s, (math.ceil((r - 1) / c) + 1) * c)
        total *= max(1, covered)
    return total


def _consolidate_chunks(
    shape: tuple[int, ...],
    chunks: tuple[int, ...],
    itemsize: int,
    max_mem: int,
) -> tuple[int, ...]:
    """Grow chunks (last axis first) while staying under max_mem, keeping each
    grown chunk an exact multiple of the original (so region writes stay
    aligned to the original chunk grid)."""
    chunks = [int(c) for c in chunks]
    for axis in reversed(range(len(chunks))):
        base = chunks[axis]
        while True:
            candidate = list(chunks)
            grown = min(shape[axis], chunks[axis] * 2)
            # keep multiples of the base chunk unless the axis is spanned
            if grown != shape[axis]:
                grown = (grown // base) * base
            if grown == chunks[axis]:
                break
            candidate[axis] = grown
            if math.prod(candidate) * itemsize > max_mem:
                break
            chunks = candidate
    return tuple(chunks)


def _stage_chunks(
    shape: tuple[int, ...],
    source_chunks: tuple[int, ...],
    target_chunks: tuple[int, ...],
    t: float,
) -> tuple[int, ...]:
    """Geometric interpolation between source and target chunk shapes at
    fraction *t*."""
    out = []
    for s, r, w in zip(shape, source_chunks, target_chunks):
        c = round(math.exp(math.log(r) * (1 - t) + math.log(w) * t))
        out.append(max(1, min(s, int(c))))
    return tuple(out)


def _copy_io_ops(
    shape: tuple[int, ...],
    read_chunks: tuple[int, ...],
    write_chunks: tuple[int, ...],
) -> int:
    """IO operations of one copy pass: a write per task, plus the worst-case
    count of source chunks a task's region straddles."""
    tasks = math.prod(max(1, math.ceil(s / w)) for s, w in zip(shape, write_chunks))
    reads_per_task = math.prod(
        min(math.ceil(s / r), math.ceil((w - 1) / r) + 1)
        for s, r, w in zip(shape, read_chunks, write_chunks)
    )
    return tasks * (1 + reads_per_task)


def _copy_feasible(
    shape: tuple[int, ...],
    read_chunks: tuple[int, ...],
    write_chunks: tuple[int, ...],
    itemsize: int,
    max_mem: int,
) -> bool:
    """The one memory rule of a direct copy pass, shared by both planners and
    mirrored (with the factors of 2) by :func:`_copy_op`'s plan-time check."""
    return (
        _covering_bytes(shape, write_chunks, read_chunks, itemsize)
        + math.prod(write_chunks) * itemsize
        <= max_mem
    )


def _plan_io_ops(shape: tuple[int, ...], seq: list[tuple[int, ...]]) -> int:
    """Total IO operations of a staged chunking sequence."""
    return sum(_copy_io_ops(shape, a, b) for a, b in zip(seq, seq[1:]))


def multistage_rechunking_plan(
    shape: tuple[int, ...],
    source_chunks: tuple[int, ...],
    target_chunks: tuple[int, ...],
    itemsize: int,
    max_mem: int,
    max_stages: int = 8,
) -> Optional[list[tuple[int, ...]]]:
    """A sequence of chunkings [source, c_1, .., c_n, target] whose every
    adjacent pair is a feasible direct copy, with the fewest IO operations
    over 0 to *max_stages* geometric stages; None when none is feasible."""
    best: Optional[list[tuple[int, ...]]] = None
    best_io = None
    for n_stages in range(0, max_stages + 1):
        seq = [tuple(source_chunks)]
        for k in range(1, n_stages + 1):
            c = _stage_chunks(shape, source_chunks, target_chunks, k / (n_stages + 1))
            if c != seq[-1]:
                seq.append(c)
        if tuple(target_chunks) != seq[-1]:
            seq.append(tuple(target_chunks))
        if any(not _copy_feasible(shape, a, b, itemsize, max_mem) for a, b in zip(seq, seq[1:])):
            continue
        io = _plan_io_ops(shape, seq)
        if best_io is None or io < best_io:
            best, best_io = seq, io
    return best


def rechunking_plan(
    shape: tuple[int, ...],
    source_chunks: tuple[int, ...],
    target_chunks: tuple[int, ...],
    itemsize: int,
    max_mem: int,
) -> tuple[tuple[int, ...], Optional[tuple[int, ...]], tuple[int, ...]]:
    """(read_chunks, int_chunks, write_chunks) of a bounded rechunk;
    int_chunks is None when one direct copy pass suffices."""
    # direct: write at target granularity, reading the covering source region
    write_chunks = tuple(min(t, s) for t, s in zip(target_chunks, shape))
    if _copy_feasible(shape, source_chunks, write_chunks, itemsize, max_mem):
        # grow write chunks while the (recomputed) covering read still fits
        grown = write_chunks
        while True:
            candidate = _consolidate_chunks(shape, grown, itemsize, 2 * math.prod(grown) * itemsize)
            if candidate == grown:
                break
            if not _copy_feasible(shape, source_chunks, candidate, itemsize, max_mem):
                break
            grown = candidate
        # grown write chunks must stay aligned to the target chunk grid
        if all(g % t == 0 or g == s for g, t, s in zip(grown, write_chunks, shape)):
            write_chunks = grown
        return source_chunks, None, write_chunks

    # staged: an intermediate at the elementwise minimum; both passes fit
    int_chunks = tuple(min(s, t) for s, t in zip(source_chunks, target_chunks))
    return source_chunks, int_chunks, tuple(min(t, s) for t, s in zip(target_chunks, shape))


def _copy_op(
    source,
    target: LazyZarrArray,
    write_chunks: tuple[int, ...],
    allowed_mem: int,
    reserved_mem: int,
    source_chunks: tuple[int, ...],
) -> PrimitiveOperation:
    shape = tuple(target.shape)
    isz = target.dtype.itemsize
    read_bytes = _covering_bytes(shape, write_chunks, source_chunks, isz)
    write_bytes = math.prod(write_chunks) * isz if write_chunks else isz
    projected_mem = reserved_mem + 2 * read_bytes + 2 * write_bytes
    if projected_mem > allowed_mem:
        raise ValueError(
            f"Projected rechunk memory ({memory_repr(projected_mem)}) exceeds "
            f"allowed_mem ({memory_repr(allowed_mem)}), including "
            f"reserved_mem ({memory_repr(reserved_mem)})"
        )
    spec = CubedCopySpec(
        read=CubedArrayProxy(source, source_chunks),
        write=CubedArrayProxy(target, tuple(target.chunks)),
    )
    keys = ChunkKeys(shape, write_chunks)
    return PrimitiveOperation(
        pipeline=CubedPipeline(copy_read_to_write, gensym("rechunk"), keys, spec),
        source_array_names=[],
        target_array=target,
        projected_mem=projected_mem,
        allowed_mem=allowed_mem,
        reserved_mem=reserved_mem,
        num_tasks=len(keys),
        fusable=False,
        write_chunks=write_chunks,
    )


def rechunk(
    source,
    source_chunks: tuple[int, ...],
    target_chunks: tuple[int, ...],
    allowed_mem: int,
    reserved_mem: int,
    target_store: str,
    temp_store: Optional[str] = None,
) -> list[PrimitiveOperation]:
    """Rechunk *source* to *target_chunks* as a chain of bounded copy ops:
    one for a direct copy, more for a staged one (intermediate stores at
    *temp_store*, then ``{temp_store}-s{k}`` for stage k)."""
    shape = tuple(source.shape)
    dtype = source.dtype
    isz = np.dtype(dtype).itemsize

    # the factor-of-4 headroom is the JAX package's (compressed and
    # uncompressed copies of a read and a write)
    max_mem = (allowed_mem - reserved_mem) // 4
    _, int_chunks, write_chunks = rechunking_plan(
        shape, tuple(source_chunks), tuple(target_chunks), isz, max_mem
    )
    eff_target = tuple(min(t, s) for t, s in zip(target_chunks, shape))
    target = lazy_empty(shape, dtype=dtype, chunks=eff_target if shape else (), store=target_store)

    if int_chunks is None:
        return [_copy_op(source, target, write_chunks, allowed_mem, reserved_mem, tuple(source_chunks))]
    if temp_store is None:
        raise ValueError("temp_store required for staged rechunk")

    # the min-intermediate two passes or a geometric multistage plan,
    # whichever needs fewer IO operations
    min_seq = [tuple(source_chunks), int_chunks, eff_target]
    seq = multistage_rechunking_plan(shape, tuple(source_chunks), eff_target, isz, max_mem)
    if seq is None or len(seq) <= 2 or _plan_io_ops(shape, seq) >= _plan_io_ops(shape, min_seq):
        seq = min_seq

    ops = []
    prev_arr, prev_chunks = source, tuple(source_chunks)
    for k, stage in enumerate(seq[1:], start=1):
        if k == len(seq) - 1:
            arr = target
        else:
            arr = lazy_empty(shape, dtype=dtype, chunks=stage,
                             store=temp_store if k == 1 else f"{temp_store}-s{k}")
        ops.append(_copy_op(prev_arr, arr, stage, allowed_mem, reserved_mem, prev_chunks))
        prev_arr, prev_chunks = arr, stage
    return ops
