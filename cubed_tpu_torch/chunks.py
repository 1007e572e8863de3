"""Chunk normalization. Counterpart of ``cubed_tpu/chunks.py``, trimmed to
``normalize_chunks`` (with ``"auto"`` sizing), the block-shape helpers and
``reshape_rechunk``."""

from __future__ import annotations

from math import prod
from typing import Any, Sequence

import numpy as np

from .utils import convert_to_bytes, itemsize

#: Default target bytes per chunk when chunks="auto"
DEFAULT_CHUNK_BYTES = 128 * 1024 * 1024


def blockdims_from_blockshape(
    shape: Sequence[int], chunkshape: Sequence[int]
) -> tuple[tuple[int, ...], ...]:
    """Expand a single chunk shape into per-dim tuples of block sizes."""
    if len(shape) != len(chunkshape):
        raise ValueError(f"shape {shape} and chunk shape {chunkshape} differ in rank")
    out = []
    for s, c in zip(shape, chunkshape):
        s, c = int(s), int(c)
        if s == 0:
            out.append((0,))
            continue
        if c <= 0:
            raise ValueError(f"Chunk size must be positive, got {c}")
        c = min(c, s)
        blocks = (c,) * (s // c)
        if s % c:
            blocks = blocks + (s % c,)
        out.append(blocks)
    return tuple(out)


def normalize_chunks(
    chunks: Any,
    shape: tuple[int, ...],
    dtype: Any = None,
    limit: int | str | None = None,
) -> tuple[tuple[int, ...], ...]:
    """Normalize any accepted chunks argument to a tuple-of-tuples of block sizes:
    an int, a byte-string limit, ``"auto"``, a tuple mixing ints / ``-1`` /
    ``None`` / ``"auto"`` / explicit per-dim tuples, or a dict by axis."""
    ndim = len(shape)
    if chunks is None:
        chunks = "auto"
    if isinstance(chunks, dict):
        chunks = tuple(chunks.get(i, "auto") for i in range(ndim))
    if isinstance(chunks, (int, np.integer, float)):
        chunks = (int(chunks),) * ndim
    if isinstance(chunks, str):
        if chunks.lower() != "auto":
            limit = convert_to_bytes(chunks)
        chunks = ("auto",) * ndim
    chunks = tuple(chunks)
    if len(chunks) != ndim:
        raise ValueError(f"chunks {chunks} do not match array rank {ndim}")

    norm: list[Any] = []
    for i, c in enumerate(chunks):
        if c is None or (isinstance(c, (int, np.integer)) and int(c) == -1):
            norm.append(shape[i])
        elif isinstance(c, str) and c.lower() == "auto":
            norm.append("auto")
        elif isinstance(c, (int, np.integer)):
            norm.append(int(c))
        elif isinstance(c, (tuple, list)):
            t = tuple(int(x) for x in c)
            if sum(t) != shape[i]:
                raise ValueError(
                    f"explicit chunks {t} for axis {i} do not sum to extent {shape[i]}"
                )
            norm.append(t)
        else:
            raise ValueError(f"Unrecognized chunks element {c!r}")

    if any(c == "auto" for c in norm):
        norm = _auto_chunks(norm, shape, dtype, limit)

    return tuple(
        c if isinstance(c, tuple) else blockdims_from_blockshape((shape[i],), (c,))[0]
        for i, c in enumerate(norm)
    )


def _auto_chunks(norm, shape, dtype, limit):
    """Resolve ``"auto"`` markers so chunk bytes approach the byte limit."""
    if dtype is None:
        raise ValueError("dtype must be known to use chunks='auto'")
    limit_bytes = convert_to_bytes(limit) if limit is not None else DEFAULT_CHUNK_BYTES
    isize = itemsize(dtype)
    fixed_elems = 1
    for c in norm:
        if c != "auto":
            fixed_elems *= max(c) if isinstance(c, tuple) else int(c)
    auto_axes = [i for i, c in enumerate(norm) if c == "auto"]
    budget = max(1, limit_bytes // max(1, isize * fixed_elems))
    remaining = sorted(auto_axes, key=lambda i: shape[i])
    sizes: dict[int, int] = {}
    while remaining:
        per_axis = max(1, int(round(budget ** (1.0 / len(remaining)))))
        axis = remaining[0]
        if shape[axis] <= per_axis:
            sizes[axis] = max(1, shape[axis])
            budget = max(1, budget // max(1, shape[axis]))
            remaining.pop(0)
        else:
            for ax in remaining:
                sizes[ax] = max(1, min(shape[ax], per_axis))
            remaining = []
    for i in auto_axes:
        norm[i] = sizes[i]
    return norm


def numblocks(chunks: tuple[tuple[int, ...], ...]) -> tuple[int, ...]:
    return tuple(len(c) for c in chunks)


def reshape_rechunk(inshape: tuple, outshape: tuple, inchunks: tuple) -> tuple:
    """A reshape factored into (the chunks to rechunk the input to, the
    output's chunks), so that input and output blocks map one to one.

    Runs of input dims are matched to runs of output dims of equal element
    count; within a run the slowest-varying dim keeps its chunking (one
    block if its blocks do not land on whole output rows) and the faster
    dims are whole."""
    if prod(inshape) != prod(outshape):
        raise ValueError(f"cannot reshape {inshape} -> {outshape}")
    groups = []
    i = j = 0
    while i < len(inshape) or j < len(outshape):
        gi, gj = [i], [j]
        pi = inshape[i] if i < len(inshape) else 1
        pj = outshape[j] if j < len(outshape) else 1
        i += 1
        j += 1
        while pi != pj:
            if pi < pj:
                if i >= len(inshape):
                    raise ValueError("cannot align reshape groups")
                pi *= inshape[i]
                gi.append(i)
                i += 1
            else:
                if j >= len(outshape):
                    raise ValueError("cannot align reshape groups")
                pj *= outshape[j]
                gj.append(j)
                j += 1
        while i < len(inshape) and inshape[i] == 1:  # absorb trailing 1s
            gi.append(i)
            i += 1
        while j < len(outshape) and outshape[j] == 1:
            gj.append(j)
            j += 1
        groups.append((gi, gj))

    rechunk_to: list = [None] * len(inshape)
    outchunks: list = [None] * len(outshape)
    for gi, gj in groups:
        lead_in, rest_in = gi[0], gi[1:]
        lead_out, rest_out = gj[0], gj[1:]
        if len(gi) == 1 and len(gj) == 1:
            rechunk_to[lead_in] = inchunks[lead_in]
            outchunks[lead_out] = inchunks[lead_in]
            continue
        for k in rest_in:
            rechunk_to[k] = (inshape[k],) if inshape[k] > 0 else (0,)
        factor = prod(inshape[k] for k in rest_in)
        rest_out_elems = prod(outshape[k] for k in rest_out)
        lead_chunks = inchunks[lead_in]
        if not all((b * factor) % rest_out_elems == 0 for b in lead_chunks):
            lead_chunks = (inshape[lead_in],) if inshape[lead_in] > 0 else (0,)
        rechunk_to[lead_in] = lead_chunks
        outchunks[lead_out] = tuple((b * factor) // rest_out_elems for b in lead_chunks)
        for k in rest_out:
            outchunks[k] = (outshape[k],) if outshape[k] > 0 else (0,)
    return tuple(rechunk_to), tuple(outchunks)
