"""Scale-out sort: a bitonic merge-split network over chunks.

Counterpart of ``cubed_tpu/array_api/_block_sort.py``, with the same plans
(ops, names, tasks, projected memory). The single-chunk sort needs the whole
sorted axis in one task, so it cannot sort an axis bigger than
``allowed_mem``; the network can: every task merges exactly two chunks.

1. pad the axis with sentinels (NaN for floats, sorted last; the dtype's
   maximum for integers) to ``m2 * c`` elements, ``m2`` the next power of
   two of the chunk count, every chunk ``c`` long;
2. sort each chunk (for argsort the pairs (value, index) in the NaN-aware
   lexicographic order, which makes every key distinct, so the network's
   output order is the stable argsort's);
3. run the ``log2(m2) * (log2(m2) + 1) / 2`` merge-split rounds;
4. slice the first ``n`` elements back off.

Each round is ONE ``general_blockwise`` op (multi-output for argsort:
values and indices from one merge), its kernel the same for every block:
whether a block keeps the low or the high half of its pair's merge is read
from the block's offset as data (``traced_offsets``), so the device
executor batches a round under ``torch.func.vmap``.

The kernels are the hand-written merge kernels (``kernels/merge_sort.py``):
the local round a merge sort of each lane, a merge round one merge-split of
two sorted blocks. Where the reference concatenates the pair and sorts it
whole (``jnp.sort``/``jnp.lexsort``), this merges the two sorted halves, so a
task holds its two blocks and its output (with indices, two more of each),
inside the projection the reference prices for its sort: 2 input, 2 output
and 3 temporary value blocks a merge (7), and for argsort 9 int64 index
blocks beside them.

Cost: ``1 + log2(m)(log2(m) + 1)/2`` rounds for ``m`` chunk columns, each
touching every element; ``auto`` routing therefore coarsens the axis to the
largest pair-merge that fits ``allowed_mem`` first
(:func:`_coarsen_for_network`).
"""

from __future__ import annotations

import math

import numpy as np

from ..backend_array_api import nxp
from ..core.ops import _offsets_array_for, block_index_from_offset, general_blockwise
from ..kernels.merge_sort import merge_split

__all__ = ["block_sort", "block_argsort"]


def _axis_fill(dtype: np.dtype):
    """Sentinel that sorts after every real value of ``dtype``."""
    if dtype.kind == "f":
        return np.nan
    return np.iinfo(dtype).max


def _max_network_chunk(x, axis: int, with_idx: bool) -> int:
    """Largest equal axis-chunk size whose pair-merge op fits allowed_mem:
    the pair round's projection (7 value blocks; with indices 9 int64 index
    blocks beside them), less a slack for the offsets array and rounding."""
    lane = 1
    for d in range(x.ndim):
        if d != axis:
            lane *= x.chunksize[d]
    per_elem = 7 * np.dtype(x.dtype).itemsize + (9 * 8 if with_idx else 0)
    budget = x.spec.allowed_mem - x.spec.reserved_mem - 65536
    return max(1, budget // (lane * per_elem))


def _coarsen_for_network(x, axis: int, with_idx: bool):
    """Resize the sort axis chunks to the largest merge that fits before
    building the network: rounds scale as log2(m)(log2(m) + 1)/2, so fewer,
    larger chunks save quadratically in the log. Skipped when the chunks are
    already within 2x of the best or the padded chunk count would not drop.
    A chunk LARGER than the feasible merge must shrink (the pair op would
    fail its plan-time bound): to ``ceil(c/k)`` with ``k = ceil(c/c_max)``,
    so each target chunk is covered by one source chunk."""
    c = x.chunksize[axis]
    c_max = _max_network_chunk(x, axis, with_idx)
    if c <= c_max < 2 * c:
        return x
    if c_max > c:
        n = x.shape[axis]
        m2_now = 1 << max(0, math.ceil(math.log2(max(1, -(-n // c)))))
        m2_new = 1 << max(0, math.ceil(math.log2(max(1, -(-n // c_max)))))
        if m2_new >= m2_now:
            return x
        c_new = c_max
    else:
        c_new = -(-c // -(-c // c_max))  # aligned split of the source chunk
    target = tuple(c_new if d == axis else x.chunksize[d] for d in range(x.ndim))
    return x.rechunk(target)


def _pad_and_equalize(x, axis: int):
    """Pad ``x``'s sort axis to m2*c (m2 a power of two) equal-c chunks.

    Returns (padded, c, m2, n)."""
    from . import creation_functions as cf
    from . import manipulation_functions as mf

    n = x.shape[axis]
    c = x.chunksize[axis]
    m2 = 1 << max(0, math.ceil(math.log2(max(1, -(-n // c)))))
    n_pad = m2 * c
    if n_pad != n:
        pad_shape = tuple(n_pad - n if d == axis else s for d, s in enumerate(x.shape))
        pad_chunks = tuple(c if d == axis else x.chunksize[d] for d in range(x.ndim))
        pad = cf.full(pad_shape, _axis_fill(x.dtype), dtype=x.dtype, chunks=pad_chunks, spec=x.spec)
        x = mf.concat([x, pad], axis=axis)
    if x.chunks[axis] != (c,) * m2:
        target = tuple(c if d == axis else x.chunksize[d] for d in range(x.ndim))
        x = x.rechunk(target)
    return x, c, m2, n


def _pair_order(vals, idxs, axis: int):
    """The pairs (value, index) along *axis* in their NaN-aware
    lexicographic order (non-NaN values by value, then index; NaNs last, by
    index): ``(values, indices)`` sorted, by the merge-sort kernel with the
    indices carried (the reference's ``nxp.lexsort`` of ``(idx, value,
    isnan)`` and two gathers, in one sort)."""
    return nxp.sort_pairs(vals, idxs, axis)


def _round_ops(val, idx, *, axis, size, stride, local=False):
    """One network round: returns (val', idx'), ONE general_blockwise op
    (multi-output when ``idx`` is given) running the pair merge once.
    ``idx`` is None for a values-only sort. ``local`` is the round-0
    within-chunk sort (no partner)."""
    numblocks = val.numblocks
    offsets = _offsets_array_for(val)
    o_name = offsets.name
    v_name = val.name
    i_name = idx.name if idx is not None else None

    def block_function(out_key):
        coords = tuple(out_key[1:])
        pcoords = tuple((b ^ stride) if d == axis else b for d, b in enumerate(coords))
        keys = [(v_name, *coords)]
        if not local:
            keys.append((v_name, *pcoords))
        if i_name is not None:
            keys.append((i_name, *coords))
            if not local:
                keys.append((i_name, *pcoords))
        keys.append((o_name, *coords))
        return tuple(keys)

    def take_low(off):
        """Whether this block keeps the low half of its pair's merge: in an
        ascending run of the network (``bi & size == 0``) the lower block of
        the pair does, in a descending one the upper."""
        bi = block_index_from_offset(off, axis, numblocks)
        ascending = (bi & size) == 0
        low_pos = (bi & stride) == 0
        return ascending == low_pos

    def merged_halves(chunks):
        """-> (values, indices or None) of this block's round."""
        if local:
            if i_name is None:
                (v, off) = chunks
                return nxp.sort(v, axis=axis), None
            (v, i, off) = chunks
            return _pair_order(v, i, axis)
        if i_name is None:
            (v, vp, off) = chunks
            return merge_split(v, vp, take_low(off), axis), None
        (v, vp, i, ip, off) = chunks
        return merge_split(v, vp, take_low(off), axis, i, ip)

    def val_kernel(*chunks):
        return merged_halves(chunks)[0]

    def pair_kernel(*chunks):
        return merged_halves(chunks)

    for k in (val_kernel, pair_kernel):
        k.traced_offsets = True
        k.batchable = True
    val_kernel.__name__ = "bitonic_merge_values"
    pair_kernel.__name__ = "bitonic_merge_pair"

    c = val.chunksize[axis]
    lane = c
    for d in range(val.ndim):
        if d != axis:
            lane *= val.chunksize[d]
    block_v = lane * np.dtype(val.dtype).itemsize
    block_i = lane * 8  # int64 indices
    # the reference's kernel temporaries beyond the modeller's input/output
    # accounting: the 2-chunk concat buffer plus its sorted copy, less the
    # output block already counted (local rounds: one sorted copy); pair
    # rounds add the index concat and reorder and the order array
    if i_name is None:
        extra = block_v if local else 3 * block_v
    elif local:
        extra = block_v + 3 * block_i
    else:
        extra = 3 * block_v + 5 * block_i

    # each unique input array is passed once; the per-task block count (2
    # reads of val/idx per merge) is declared via num_input_blocks
    uniq = [val] + ([idx] if idx is not None else []) + [offsets]
    per_task = 1 if local else 2
    nb_map = {offsets.name: 1, val.name: per_task}
    if idx is not None:
        nb_map[idx.name] = per_task

    if idx is None:
        new_val = general_blockwise(
            val_kernel, block_function, *uniq,
            shape=val.shape, dtype=val.dtype, chunks=val.chunks,
            extra_projected_mem=extra,
            num_input_blocks=tuple(nb_map[a.name] for a in uniq),
            op_name="bitonic_round" if not local else "bitonic_local_sort",
        )
        return new_val, None
    # one multi-output op: the merge runs ONCE and feeds both arrays
    new_val, new_idx = general_blockwise(
        pair_kernel, block_function, *uniq,
        shape=val.shape, dtype=[val.dtype, np.dtype(np.int64)], chunks=val.chunks,
        extra_projected_mem=extra,
        num_input_blocks=tuple(nb_map[a.name] for a in uniq),
        op_name="bitonic_pair" if not local else "bitonic_local_pair",
    )
    return new_val, new_idx


def _iota_along(x, axis: int):
    """Global positions along ``axis``, broadcast to x's grid (int64)."""
    numblocks = x.numblocks
    c = x.chunksize[axis]
    offsets = _offsets_array_for(x)
    x_name, o_name = x.name, offsets.name

    def block_function(out_key):
        coords = tuple(out_key[1:])
        return ((x_name, *coords), (o_name, *coords))

    def _iota_block(chunk, offset):
        bi = block_index_from_offset(offset, axis, numblocks)
        local = nxp.arange(chunk.shape[axis], dtype=np.int64) + bi * c
        shape = tuple(chunk.shape[axis] if d == axis else 1 for d in range(chunk.ndim))
        return nxp.astype(nxp.broadcast_to(nxp.reshape(local, shape), chunk.shape), np.int64)

    _iota_block.traced_offsets = True
    _iota_block.batchable = True
    _iota_block.__name__ = "iota_along"

    return general_blockwise(
        _iota_block, block_function, x, offsets,
        shape=x.shape, dtype=np.dtype(np.int64), chunks=x.chunks, op_name="iota_along",
    )


def _network(val, idx, axis: int):
    """Local sort + full bitonic merge schedule over ``m2`` chunk columns."""
    m2 = val.numblocks[axis]
    val, idx = _round_ops(val, idx, axis=axis, size=0, stride=0, local=True)
    size = 2
    while size <= m2:
        stride = size // 2
        while stride >= 1:
            val, idx = _round_ops(val, idx, axis=axis, size=size, stride=stride)
            stride //= 2
        size *= 2
    return val, idx


def _slice_back(arr, axis: int, n: int):
    sel = tuple(slice(0, n) if d == axis else slice(None) for d in range(arr.ndim))
    return arr[sel]


def block_sort(x, axis: int, coarsen: bool = True):
    """Ascending multi-chunk sort along ``axis`` (memory-bounded)."""
    if coarsen:
        x = _coarsen_for_network(x, axis, with_idx=False)
    padded, c, m2, n = _pad_and_equalize(x, axis)
    val, _ = _network(padded, None, axis)
    return _slice_back(val, axis, n)


def block_argsort(x, axis: int, coarsen: bool = True):
    """Ascending stable multi-chunk argsort along ``axis`` (int64)."""
    if coarsen:
        x = _coarsen_for_network(x, axis, with_idx=True)
    padded, c, m2, n = _pad_and_equalize(x, axis)
    idx0 = _iota_along(padded, axis)
    _, idx = _network(padded, idx0, axis)
    return _slice_back(idx, axis, n)
