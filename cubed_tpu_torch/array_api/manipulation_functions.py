"""Array-API manipulation functions. Counterpart of
``cubed_tpu/array_api/manipulation_functions.py`` (``pad`` waits for a later
slice), with the same plans: ``concat`` and ``flip`` read their sources
through ``map_direct`` (``concat`` declares ``whole_concat``, which the
device executor takes as one ``torch.cat`` of resident sources), ``roll``
is a concat of two slices rechunked back, ``reshape`` a rechunk and a
one-to-one block reshape, ``repeat`` an expand, broadcast and reshape, and
``tile`` a concat of references to one array. numpy's ``repeat`` is
``torch.repeat_interleave`` and its ``tile`` is ``Tensor.repeat``; neither
torch call is used, since each block is computed as the JAX package
computes it."""

from __future__ import annotations

import itertools
from math import prod

import numpy as np

from ..backend_array_api import numpy_array_to_backend_array, nxp
from ..chunks import normalize_chunks, reshape_rechunk
from ..core.ops import blockwise, general_blockwise, map_direct, rechunk, unify_chunks
from ..utils import block_id_to_offset, chunk_memory, offset_to_block_id


def expand_dims(x, /, *, axis=0):
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    out_ndim = x.ndim + len(axis)
    axis = tuple(ax % out_ndim for ax in axis)

    def _expand(chunk):
        return nxp.expand_dims(chunk, axis=axis)

    _expand.batchable = True
    return blockwise(
        _expand,
        tuple(range(out_ndim)),
        x,
        tuple(i for i in range(out_ndim) if i not in axis),
        dtype=x.dtype,
        new_axes={ax: 1 for ax in axis},
        align_arrays=False,
    )


def permute_dims(x, /, axes=None):
    if axes is None:
        axes = tuple(range(x.ndim))[::-1]
    if len(axes) != x.ndim:
        raise ValueError("axes don't match array")
    axes = tuple(axes)

    def _transpose(chunk):
        return nxp.permute_dims(chunk, axes)

    _transpose.batchable = True
    return blockwise(
        _transpose,
        axes,
        x,
        tuple(range(x.ndim)),
        dtype=x.dtype,
        extra_projected_mem=x.chunkmem,  # a C-order copy of the transposed chunk
    )


def squeeze(x, /, axis=None):
    if axis is None:
        axis = tuple(i for i, s in enumerate(x.shape) if s == 1)
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    axis = tuple(ax % x.ndim for ax in axis)
    if any(x.shape[ax] != 1 for ax in axis):
        raise ValueError(f"cannot squeeze axes {axis} of shape {x.shape}")
    return _squeeze_axes(x, axis)


def _squeeze_axes(x, axis: tuple[int, ...]):
    """Drop single-block size-1 axes via an explicit 1:1 block mapping."""
    if not axis:
        return x
    axis = tuple(sorted(ax % x.ndim for ax in axis))
    keep = [i for i in range(x.ndim) if i not in axis]
    x_name = x.name

    def block_function(out_key):
        it = iter(out_key[1:])
        return ((x_name, *(0 if i in axis else next(it) for i in range(x.ndim))),)

    def _sq(chunk):
        return nxp.squeeze(chunk, axis=axis)

    _sq.__name__ = "squeeze"
    _sq.batchable = True
    return general_blockwise(
        _sq, block_function, x,
        shape=tuple(x.shape[i] for i in keep),
        dtype=x.dtype,
        chunks=tuple(x.chunks[i] for i in keep),
        op_name="squeeze",
    )


def broadcast_arrays(*arrays):
    out_shape = np.broadcast_shapes(*[a.shape for a in arrays])
    return tuple(broadcast_to(a, out_shape) for a in arrays)


def broadcast_to(x, /, shape, *, chunks=None):
    shape = tuple(shape)
    if x.shape == shape and chunks is None:
        return x
    ndim_new = len(shape) - x.ndim
    if ndim_new < 0 or any(new != old and old != 1 for new, old in zip(shape[ndim_new:], x.shape)):
        raise ValueError(f"cannot broadcast shape {x.shape} to shape {shape}")
    if chunks is None:
        # leading new dims and broadcast dims get chunk size 1
        chunks = tuple((1,) * s for s in shape[:ndim_new]) + tuple(
            bd if old > 1 else ((1,) * new if new > 0 else (0,))
            for bd, old, new in zip(x.chunks, x.shape, shape[ndim_new:])
        )
    else:
        chunks = normalize_chunks(chunks, shape, dtype=x.dtype)
        for bd_new, bd_old, old in zip(chunks[ndim_new:], x.chunks, x.shape):
            if old > 1 and bd_new != bd_old:
                raise ValueError("cannot broadcast chunks: non-broadcast dimension chunks "
                                 f"must be unchanged, got {bd_new} expected {bd_old}")
    from .creation_functions import empty_virtual_array

    # blockwise against an empty template with the output grid
    template = empty_virtual_array(shape, dtype=x.dtype, chunks=chunks, spec=x.spec, hidden=True)
    out_ind = tuple(range(len(shape)))

    def _bcast(template_chunk, x_chunk):
        return nxp.broadcast_to(x_chunk, template_chunk.shape)

    _bcast.batchable = True
    return blockwise(_bcast, out_ind, template, out_ind, x, out_ind[ndim_new:], dtype=x.dtype, align_arrays=False)


def concat(arrays, /, *, axis=0):
    """Concatenate along an axis: each output block gathers its pieces from
    the sources (map_direct)."""
    if not arrays:
        raise ValueError("Need at least one array to concat")
    arrays = list(arrays)
    if axis is None:
        arrays = [flatten(a) for a in arrays]
        axis = 0
    ndim = arrays[0].ndim
    axis = axis % ndim
    from .data_type_functions import result_type

    dtype = result_type(*arrays)
    arrays = [_astype_maybe(a, dtype) for a in arrays]
    # align the chunking off the axis; a symbol of its own per array on it
    inds = []
    for i, a in enumerate(arrays):
        ind = list(range(a.ndim))
        ind[axis] = -(i + 1)
        inds.append(tuple(ind))
    _, arrays = unify_chunks(*itertools.chain(*zip(arrays, inds)))

    shape = list(arrays[0].shape)
    shape[axis] = sum(a.shape[axis] for a in arrays)
    shape = tuple(shape)
    # along the axis the largest source chunk: a thin first part must not
    # make the whole output thin
    chunksize = list(arrays[0].chunksize)
    chunksize[axis] = max(a.chunksize[axis] for a in arrays)
    chunksize = tuple(chunksize)
    chunks = normalize_chunks(chunksize, shape, dtype=dtype)
    offsets = np.cumsum([0] + [a.shape[axis] for a in arrays]).tolist()
    out_chunks_axis = chunks[axis]

    def _read_concat_chunk(block, *zarrays, block_id=None):
        start = sum(out_chunks_axis[: block_id[axis]])
        stop = start + out_chunks_axis[block_id[axis]]
        pieces = []
        for i, za in enumerate(zarrays):
            lo, hi = offsets[i], offsets[i + 1]
            s, e = max(start, lo), min(stop, hi)
            if s >= e:
                continue
            sel = tuple(
                slice(s - lo, e - lo) if ax == axis
                else slice(sum(chunks[ax][: block_id[ax]]), sum(chunks[ax][: block_id[ax] + 1]))
                for ax in range(ndim)
            )
            pieces.append(numpy_array_to_backend_array(za[sel]))
        return pieces[0] if len(pieces) == 1 else nxp.concatenate(pieces, axis=axis)

    # the device executor concatenates resident sources in one call
    _read_concat_chunk.whole_concat = axis
    _read_concat_chunk.device_reads = True
    return map_direct(
        _read_concat_chunk, *arrays, shape=shape, dtype=dtype, chunks=chunks,
        extra_projected_mem=2 * chunk_memory(dtype, chunksize),
    )


def _astype_maybe(a, dtype):
    if a.dtype == dtype:
        return a
    from .data_type_functions import astype

    return astype(a, dtype)


def flatten(x, /):
    return reshape(x, (-1,))


def flip(x, /, *, axis=None):
    """Reverse along the given axes: each output block reads the mirrored
    region of its source (map_direct) and flips it."""
    if axis is None:
        axis = tuple(range(x.ndim))
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    axis = tuple(ax % x.ndim for ax in axis)
    chunks, shape = x.chunks, x.shape

    def _read_flipped(block, zarray, block_id=None):
        sel = []
        for ax in range(x.ndim):
            start = sum(chunks[ax][: block_id[ax]])
            stop = start + chunks[ax][block_id[ax]]
            # output [start, stop) is input [size - stop, size - start)
            sel.append(slice(shape[ax] - stop, shape[ax] - start) if ax in axis else slice(start, stop))
        return nxp.flip(numpy_array_to_backend_array(zarray[tuple(sel)]), axis=axis)

    _read_flipped.device_reads = True
    return map_direct(_read_flipped, x, shape=shape, dtype=x.dtype, chunks=chunks,
                      extra_projected_mem=2 * x.chunkmem)


def moveaxis(x, source, destination, /):
    if isinstance(source, (int, np.integer)):
        source = (source,)
    if isinstance(destination, (int, np.integer)):
        destination = (destination,)
    source = tuple(s % x.ndim for s in source)
    destination = tuple(d % x.ndim for d in destination)
    order = [n for n in range(x.ndim) if n not in source]
    for dest, src in sorted(zip(destination, source)):
        order.insert(dest, src)
    return permute_dims(x, tuple(order))


def repeat(x, repeats, /, *, axis=0):
    """Repeat each element *repeats* times along *axis*: an expand, a
    broadcast and a reshape."""
    if not isinstance(repeats, (int, np.integer)):
        raise NotImplementedError("repeat only supports int repeats")
    repeats = int(repeats)
    shape = x.shape
    axis = axis % x.ndim
    expanded = expand_dims(x, axis=axis + 1)
    bshape = shape[: axis + 1] + (repeats,) + shape[axis + 1 :]
    bchunks = expanded.chunks[: axis + 1] + ((repeats,),) + expanded.chunks[axis + 2 :]
    b = broadcast_to(expanded, bshape, chunks=bchunks)
    return reshape(b, shape[:axis] + (shape[axis] * repeats,) + shape[axis + 1 :])


def reshape(x, /, shape, *, copy=None):
    shape = tuple(shape)
    if any(s == -1 for s in shape):
        known = prod(s for s in shape if s != -1)
        shape = tuple(x.size // known if s == -1 else s for s in shape)
    if prod(shape) != x.size:
        raise ValueError(f"cannot reshape array of size {x.size} into shape {shape}")
    if shape == x.shape:
        return x
    return _reshape_via_rechunk(x, shape)


def _reshape_via_rechunk(x, shape):
    """A rechunk that makes the blocks map one to one, then each block
    reshaped to its output block."""
    if x.ndim == 0:
        x2, outchunks = x, tuple((s,) for s in shape)
    else:
        rechunk_to, outchunks = reshape_rechunk(x.shape, shape, x.chunks)
        x2 = rechunk(x, tuple(rechunk_to))
    in_numblocks = tuple(len(c) for c in x2.chunks) if x2.ndim else ()
    out_numblocks = tuple(len(c) for c in outchunks)
    x2_name = x2.name

    def block_function(out_key):
        offset = block_id_to_offset(out_key[1:], out_numblocks) if out_numblocks else 0
        return ((x2_name, *(offset_to_block_id(offset, in_numblocks) if in_numblocks else ())),)

    return general_blockwise(
        _ReshapeFn(outchunks), block_function, x2, shape=shape, dtype=x.dtype, chunks=outchunks,
        op_name="reshape", fusable=False,  # needs block_id, which fused functions do not pass
    )


class _ReshapeFn:
    """Reshapes a chunk to its output block's shape; ``needs_block_id``
    asks the executor for the output block's coordinates."""

    __name__ = "reshape_chunk"
    needs_block_id = True

    def __init__(self, outchunks):
        self.outchunks = outchunks

    def __call__(self, chunk, block_id=None):
        return nxp.reshape(chunk, tuple(c[b] for c, b in zip(self.outchunks, block_id)))


def roll(x, /, shift, *, axis=None):
    """Roll elements along axes: per axis a concat of two slices
    (``x[n-s:]``, ``x[:n-s]``), then a rechunk back to x's grid."""
    if axis is None:
        return reshape(roll(flatten(x), shift, axis=0), x.shape)
    if isinstance(shift, (int, np.integer)):
        shift = (int(shift),)
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    if len(shift) != len(axis):
        raise ValueError("shift and axis must have the same length")
    shifts: dict = {}
    for ax, s in zip(axis, shift):  # repeated axes accumulate, as in numpy
        shifts[ax % x.ndim] = shifts.get(ax % x.ndim, 0) + int(s)
    out = x
    for ax, s in sorted(shifts.items()):
        n = x.shape[ax]
        if not n or s % n == 0:
            continue
        s %= n
        hi = tuple(slice(n - s, None) if d == ax else slice(None) for d in range(x.ndim))
        lo = tuple(slice(0, n - s) if d == ax else slice(None) for d in range(x.ndim))
        out = concat([out[hi], out[lo]], axis=ax)
    if out is not x and out.chunks != x.chunks:
        out = out.rechunk(x.chunksize)
    return out


def stack(arrays, /, *, axis=0):
    """Stack along a new axis: each output block is one source block with
    the axis added."""
    if not arrays:
        raise ValueError("Need at least one array to stack")
    arrays = list(arrays)
    if len({a.shape for a in arrays}) > 1:
        raise ValueError("all input arrays must have the same shape for stack")
    from .data_type_functions import result_type

    dtype = result_type(*arrays)
    arrays = [_astype_maybe(a, dtype) for a in arrays]
    _, arrays = unify_chunks(*itertools.chain(*zip(arrays, [tuple(range(a.ndim)) for a in arrays])))
    old_shape = arrays[0].shape
    axis = axis % (len(old_shape) + 1)
    shape = old_shape[:axis] + (len(arrays),) + old_shape[axis:]
    chunks = arrays[0].chunks[:axis] + ((1,) * len(arrays),) + arrays[0].chunks[axis:]
    names = [a.name for a in arrays]

    def block_function(out_key):
        coords = out_key[1:]
        return ((names[coords[axis]], *coords[:axis], *coords[axis + 1 :]),)

    def _stack_chunk(chunk):
        return nxp.expand_dims(chunk, axis=axis)

    _stack_chunk.__name__ = "stack"
    _stack_chunk.batchable = True
    return general_blockwise(_stack_chunk, block_function, *arrays, shape=shape, dtype=dtype, chunks=chunks,
                             op_name="stack")


def unstack(x, /, *, axis=0):
    """x split along *axis* into a tuple of arrays, each an integer index."""
    if x.ndim == 0:
        raise ValueError("unstack requires at least one dimension")
    axis = axis % x.ndim
    return tuple(x[(slice(None),) * axis + (i,)] for i in range(x.shape[axis]))


def tile(x, repetitions, /):
    """x repeated ``repetitions[d]`` times along each dim: a concat of
    references to the same array per tiled dim, so nothing is duplicated in
    the plan."""
    reps = tuple(int(r) for r in repetitions)
    if any(r < 0 for r in reps):
        raise ValueError("repetitions must be non-negative")
    out = x
    if len(reps) > x.ndim:
        out = expand_dims(out, axis=tuple(range(len(reps) - x.ndim)))
    elif len(reps) < x.ndim:
        reps = (1,) * (x.ndim - len(reps)) + reps
    for d, r in enumerate(reps):
        if r == 0:
            out = out[tuple(slice(0, 0) if dd == d else slice(None) for dd in range(out.ndim))]
        elif r > 1:
            out = concat([out] * r, axis=d)
    return out
