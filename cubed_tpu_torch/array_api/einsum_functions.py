"""Chunked ``einsum``, beyond the standard.

Counterpart of ``cubed_tpu/array_api/einsum_functions.py``, with the same
plan: one n-ary blockwise op contracts block by block, each contracted
label kept as a size-1 axis (``adjust_chunks``), then a tree reduction
sums over the contracted axes (``sum``: the ``region_sum`` kernel on the
card for float64, float32 and int64). Shared labels align their chunk
grids through the blockwise core's ``unify_chunks``. A block's contraction
is ``contraction.einsum``: ``torch.einsum``, or, for float32 operands under
the device executor's reduced ``matmul_precision`` modes and for integers on
the card, batched products through ``contraction.matmul`` (the rounding of
each mode; integers exact).

Not supported (``NotImplementedError``): ellipsis, and a label repeated
within one operand (a block's trace or diagonal does not compose across a
chunk grid without a gather).
"""

from __future__ import annotations

import numpy as np

from .. import contraction
from ..backend_array_api import nxp
from ..core.ops import blockwise
from .data_type_functions import result_type
from .dtypes import _numeric_dtypes

__all__ = ["einsum"]


def _parse(subscripts: str, n_operands: int):
    subscripts = subscripts.replace(" ", "")
    if "..." in subscripts:
        raise NotImplementedError("einsum: ellipsis is not supported")
    if "->" in subscripts:
        lhs, out_labels = subscripts.split("->")
        explicit = True
    else:
        lhs, out_labels, explicit = subscripts, "", False
    in_labels = lhs.split(",")
    if len(in_labels) != n_operands:
        raise ValueError(f"einsum: {len(in_labels)} operand subscripts for {n_operands} operands")
    for labels in in_labels:
        if not labels.isalpha() and labels != "":
            raise ValueError(f"einsum: invalid subscript {labels!r}")
        if len(set(labels)) != len(labels):
            raise NotImplementedError(
                "einsum: repeated labels within one operand (diagonal/trace) are not supported"
            )
    counts: dict = {}
    for labels in in_labels:
        for ch in labels:
            counts[ch] = counts.get(ch, 0) + 1
    if not explicit:
        out_labels = "".join(sorted(ch for ch, c in counts.items() if c == 1))
    if len(set(out_labels)) != len(out_labels):
        raise ValueError("einsum: repeated output labels")
    for ch in out_labels:
        if ch not in counts:
            raise ValueError(f"einsum: output label {ch!r} not in inputs")
    contracted = sorted(ch for ch in counts if ch not in out_labels)
    return in_labels, out_labels, contracted


class _EinsumBlock:
    """One block's contraction to the output labels, in the requested dtype
    (numpy's ``einsum(dtype=)``: an int32 product must not overflow before a
    float64 cast; only blocks of another dtype are cast), then a size-1 axis
    appended per contracted label."""

    batchable = True

    def __init__(self, subscripts, kernel_spec, dtype, n_contracted):
        self.__name__ = f"einsum[{subscripts}]"
        self.kernel_spec = kernel_spec
        self.dtype = dtype
        self.n_contracted = n_contracted

    def __call__(self, *blocks):
        res = contraction.einsum(self.kernel_spec, *[nxp.astype(b, self.dtype) for b in blocks])
        for _ in range(self.n_contracted):
            res = nxp.expand_dims(res, axis=res.ndim)
        return res


def einsum(subscripts, /, *operands, dtype=None):
    """The Einstein summation over chunked arrays: ``einsum("ij,jk->ik", a,
    b)`` and the like; any number of operands, batch labels, several
    contractions (``"abc,cd,be->ae"``), implicit output. Memory-bounded as
    every op is: the contraction runs per block and sums through the
    reduction tree."""
    if not operands:
        raise ValueError("einsum requires at least one operand")
    for op in operands:
        if op.dtype not in _numeric_dtypes:
            raise TypeError("Only numeric dtypes are allowed in einsum")
    in_labels, out_labels, contracted = _parse(subscripts, len(operands))
    extents: dict = {}
    for labels, op in zip(in_labels, operands):
        if len(labels) != op.ndim:
            raise ValueError(f"einsum: subscript {labels!r} does not match operand with {op.ndim} dimensions")
        for ch, size in zip(labels, op.shape):
            if extents.setdefault(ch, size) != size:
                raise ValueError(f"einsum: label {ch!r} has inconsistent sizes {extents[ch]} and {size}")

    if dtype is None:
        dtype = result_type(*operands)
    dtype = np.dtype(dtype)

    sym = {ch: i for i, ch in enumerate(out_labels + "".join(contracted))}
    out_ind = tuple(sym[ch] for ch in out_labels) + tuple(sym[ch] for ch in contracted)
    block = _EinsumBlock(subscripts, ",".join(in_labels) + "->" + out_labels, dtype, len(contracted))

    blockwise_args = []
    for labels, op in zip(in_labels, operands):
        blockwise_args.extend([op, tuple(sym[ch] for ch in labels)])

    # the contraction's temporaries, priced as matmul's three output blocks
    # (the block result materialises before the fusable sum consumes it,
    # and the write copies it), plus a widened copy of each input block of
    # another dtype (held beside the original while the block is cast)
    label_chunk: dict = {}
    for labels, op in zip(in_labels, operands):
        for ch, c in zip(labels, op.chunksize):
            label_chunk[ch] = max(label_chunk.get(ch, 1), c)
    out_block_elems = 1
    for ch in out_labels:
        out_block_elems *= label_chunk[ch]
    contraction_extra = 3 * out_block_elems * dtype.itemsize
    for labels, op in zip(in_labels, operands):
        if np.dtype(op.dtype) != dtype:
            in_elems = 1
            for ch in labels:
                in_elems *= label_chunk[ch]
            contraction_extra += in_elems * dtype.itemsize

    out = blockwise(
        block,
        out_ind,
        *blockwise_args,
        dtype=dtype,
        adjust_chunks={sym[ch]: 1 for ch in contracted},
        extra_projected_mem=contraction_extra,
    )

    if contracted:
        from .statistical_functions import sum as xp_sum

        axes = tuple(range(len(out_labels), len(out_labels) + len(contracted)))
        out = xp_sum(out, axis=axes, dtype=dtype)
    return out
