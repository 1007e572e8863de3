"""Whole-array operations, built on the blockwise primitive.

Counterpart of ``cubed_tpu/core/ops.py``, trimmed to the slice the port
runs: ``from_array``, ``from_zarr``, ``blockwise``/``general_blockwise``,
``elemwise``, ``map_blocks``/``map_direct``, ``index`` (basic indexing)
and the tree ``reduction`` with its pytree-field variant (mean's
``{n, total}``). Rechunk is not ported: an op that would need one
raises ``NotImplementedError``.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional, Sequence

import numpy as np

from ..backend_array_api import numpy_array_to_backend_array, nxp
from ..chunks import normalize_chunks
from ..primitive.blockwise import (
    blockwise as primitive_blockwise,
    general_blockwise as primitive_general_blockwise,
)
from ..spec import Spec, spec_from_config
from ..storage.store import open_zarr_array
from ..storage.virtual import (
    MAX_IN_MEMORY_BYTES,
    virtual_empty,
    virtual_in_memory,
    virtual_offsets,
)
from ..utils import chunk_memory, get_item, offset_to_block_id, to_chunksize
from .array import CoreArray, check_array_specs
from .plan import Dag, Plan, gensym, new_temp_path


def _spec_of(*arrays, spec=None) -> Spec:
    if spec is not None:
        return spec
    found = check_array_specs([a for a in arrays if isinstance(a, CoreArray)])
    return found if found is not None else spec_from_config(None)


def new_array(name, target, spec, plan) -> "CoreArray":
    from ..array_api.array_object import Array

    return Array(name, target, spec, plan)


def _scalar_int(x) -> int:
    """The single value of a one-element host array or tensor."""
    return int(x.reshape(-1)[0])


# ---------------------------------------------------------------------------
# Creation from storage
# ---------------------------------------------------------------------------


def from_array(x, chunks="auto", spec=None) -> "CoreArray":
    """Create an array from an in-memory numpy array: a small one rides the
    plan as a virtual array; a larger one is sliced per output chunk by a
    map_blocks whose closure carries it. (Stores open with ``from_zarr``.)
    """
    if isinstance(x, CoreArray):
        raise ValueError("Array is already a cubed_tpu_torch array")
    spec = spec_from_config(spec)
    x = np.asarray(x)
    outchunks = normalize_chunks(chunks, x.shape, dtype=x.dtype)
    if x.nbytes <= MAX_IN_MEMORY_BYTES:
        name = gensym("array")
        target = virtual_in_memory(x, to_chunksize(outchunks) if x.shape else ())
        return new_array(name, target, spec, Plan._new(name, "from_array", target))

    def _from_array_chunk(chunk, block_id=None):
        return numpy_array_to_backend_array(x[get_item(outchunks, block_id)])

    _from_array_chunk.__name__ = "from_array"
    _from_array_chunk.host_data_nbytes = x.nbytes
    return map_blocks(
        _from_array_chunk,
        empty_virtual_array(x.shape, dtype=x.dtype, chunks=outchunks, spec=spec),
        dtype=x.dtype,
    )


def from_zarr(store, path=None, spec=None) -> "CoreArray":
    """Load an array from an existing local Zarr v2 store (no data read)."""
    spec = spec_from_config(spec)
    name = gensym("from-zarr")
    target = open_zarr_array(store if path is None else f"{store}/{path}", mode="r")
    return new_array(name, target, spec, Plan._new(name, "from_zarr", target))


# ---------------------------------------------------------------------------
# Blockwise (core wrapper)
# ---------------------------------------------------------------------------


def blockwise(
    func: Callable,
    out_ind: Sequence,
    *args,  # pairs of (array, indices)
    dtype=None,
    adjust_chunks: Optional[dict] = None,
    align_arrays: bool = True,
    extra_projected_mem: int = 0,
    fusable: bool = True,
    shape_invariant: bool = False,
    **kwargs,
) -> CoreArray:
    arrays = list(args[0::2])
    inds = [tuple(i) if i is not None else None for i in args[1::2]]
    spec = _spec_of(*arrays)
    if align_arrays:
        _check_aligned(arrays, inds)

    # chunking of each index symbol: the most blocks wins, ties go to the
    # larger extent (a size-1 dim broadcasts and must not set the chunking)
    chunkss: dict = {}
    for a, ind in zip(arrays, inds):
        if ind is None:
            continue
        for sym, c in zip(ind, a.chunks):
            prev = chunkss.get(sym)
            if prev is None or len(c) > len(prev) or (len(c) == len(prev) and sum(c) > sum(prev)):
                chunkss[sym] = c

    chunks_out = []
    for sym in out_ind:
        c = chunkss[sym]
        if adjust_chunks and sym in adjust_chunks:
            adj = adjust_chunks[sym]
            c = (adj,) * len(c) if isinstance(adj, int) else tuple(adj)
        chunks_out.append(tuple(c))
    chunks_out = tuple(chunks_out)
    shape = tuple(sum(c) for c in chunks_out)

    multi, names, target_store = _alloc_output_names_stores(dtype, spec)
    prim_args = []
    for a, ind in zip(arrays, inds):
        prim_args.extend([a.zarray_maybe_lazy, ind])
    op = primitive_blockwise(
        func,
        tuple(out_ind),
        *prim_args,
        allowed_mem=spec.allowed_mem,
        reserved_mem=spec.reserved_mem,
        target_store=target_store,
        shape=[shape] * len(dtype) if multi else shape,
        dtype=dtype,
        chunks=chunks_out,
        in_names=[a.name for a in arrays],
        out_name=names if multi else names[0],
        extra_projected_mem=extra_projected_mem,
        fusable=fusable,
        shape_invariant=shape_invariant,
        **kwargs,
    )
    return _wrap_op_outputs(op, getattr(func, "__name__", "blockwise"), spec, arrays, names)


def _check_aligned(arrays, inds) -> None:
    """Inputs sharing an index symbol must share its chunking (or broadcast
    from a single size-1 block): aligning them needs rechunk, not ported."""
    seen: dict = {}
    for a, ind in zip(arrays, inds):
        if ind is None:
            continue
        for sym, c in zip(ind, a.chunks):
            if sum(c) == 1 and len(c) == 1:
                continue
            if seen.setdefault(sym, c) != c:
                raise NotImplementedError(
                    f"inputs are chunked differently along {sym!r} "
                    f"({seen[sym]} vs {c}); rechunk is not ported"
                )


def general_blockwise(
    func: Callable,
    block_function: Callable,
    *arrays,
    shape,
    dtype,
    chunks,
    extra_projected_mem: int = 0,
    num_input_blocks=None,
    fusable: bool = True,
    op_name: str = "general_blockwise",
):
    """Apply an explicit block function. Multi-output: ``dtype`` (and
    ``shape``) as lists; ``func`` returns a tuple of arrays per task."""
    spec = _spec_of(*arrays)
    multi, names, target_store = _alloc_output_names_stores(dtype, spec)
    if multi:
        shapes = (
            list(shape) if shape and isinstance(shape[0], (list, tuple))
            else [tuple(shape)] * len(dtype)
        )
        chunks = normalize_chunks(chunks, shapes[0], dtype=dtype[0])
        out_name = names
        shape_arg = [tuple(s) for s in shapes]
    else:
        chunks = normalize_chunks(chunks, shape, dtype=dtype)
        out_name = names[0]
        shape_arg = tuple(shape)
    op = primitive_general_blockwise(
        func,
        block_function,
        *[a.zarray_maybe_lazy for a in arrays],
        allowed_mem=spec.allowed_mem,
        reserved_mem=spec.reserved_mem,
        target_store=target_store,
        shape=shape_arg,
        dtype=dtype,
        chunks=chunks,
        in_names=[a.name for a in arrays],
        out_name=out_name,
        extra_projected_mem=extra_projected_mem,
        num_input_blocks=num_input_blocks,
        fusable=fusable,
    )
    return _wrap_op_outputs(op, op_name, spec, arrays, names)


def _alloc_output_names_stores(dtype, spec):
    """(multi?, output names, temp store path(s)) for an op's output(s)."""
    multi = isinstance(dtype, (list, tuple))
    names = [gensym("array") for _ in dtype] if multi else [gensym("array")]
    stores = [new_temp_path(n, spec) for n in names]
    return multi, names, stores if multi else stores[0]


def _wrap_op_outputs(op, op_label: str, spec, arrays, names):
    """Plan node(s) and array(s) for a finished primitive op: a tuple for a
    multi-output op, a single array otherwise."""
    if op.target_arrays is not None:
        plan = Plan._new(names, op_label, op.target_arrays, op, False, *arrays)
        return tuple(new_array(n, t, spec, plan) for n, t in zip(names, op.target_arrays))
    plan = Plan._new(names[0], op_label, op.target_array, op, False, *arrays)
    return new_array(names[0], op.target_array, spec, plan)


# ---------------------------------------------------------------------------
# Elementwise and map operations
# ---------------------------------------------------------------------------


def elemwise(func: Callable, *args: CoreArray, dtype=None) -> CoreArray:
    """Apply an elementwise function with broadcasting. The chunk function
    carries ``elementwise``, the name of *func* (``"add"``, ``"multiply"``,
    ...), which the device executor's fusion rule reads."""
    if dtype is None:
        raise ValueError("dtype must be specified for elemwise")
    shapes = [getattr(a, "shape", ()) for a in args]
    np.broadcast_shapes(*shapes)  # raises ValueError on incompatible shapes
    out_ndim = max((len(s) for s in shapes), default=0)
    blockwise_args = []
    for a in args:
        # trailing dims align rightmost (broadcasting); 0-d arrays use ()
        blockwise_args.extend([a, tuple(range(getattr(a, "ndim", 0)))[::-1]])

    def elementwise_chunk(*chunks):
        return func(*chunks)

    elementwise_chunk.__name__ = elementwise_chunk.elementwise = getattr(func, "__name__", "elemwise")
    return blockwise(
        elementwise_chunk, tuple(range(out_ndim))[::-1], *blockwise_args, dtype=dtype,
        shape_invariant=True,
    )


def map_blocks(func: Callable, *args, dtype=None, chunks=None, **kwargs) -> CoreArray:
    """Apply a function to corresponding blocks; *chunks* (normalized, one
    tuple per dim) sets the output chunking. A *func* with a ``block_id``
    parameter gets each block's index, read from a hidden offsets array.
    Other keyword arguments go to *func*."""
    arrays = [a for a in args if isinstance(a, CoreArray)]
    if len(arrays) != len(args):
        raise ValueError("non-array positional args not supported; use kwargs")
    x = arrays[0]
    in_ndim = x.ndim
    out_ind = list(range(in_ndim))
    adjust_chunks = None if chunks is None else {i: tuple(c) for i, c in enumerate(chunks)}

    blockwise_args = []
    for a in arrays:
        blockwise_args.extend([a, tuple(range(a.ndim))])

    if "block_id" in _func_argnames(func):
        offsets = _offsets_array_for(x)
        numblocks = x.numblocks

        def func_with_block_id(*chunk_args, **kw):
            *real, offset = chunk_args
            return func(*real, block_id=offset_to_block_id(_scalar_int(offset), numblocks), **kw)

        func_with_block_id.__name__ = getattr(func, "__name__", "map_blocks")
        # the offset -> block_id conversion runs on the host
        func_with_block_id.host_block_id = True
        for attr in ("side_inputs", "whole_select", "resident_identity", "whole_concat",
                     "host_data_nbytes"):
            if hasattr(func, attr):
                setattr(func_with_block_id, attr, getattr(func, attr))
        blockwise_args.extend([offsets, tuple(range(in_ndim))])
        return blockwise(
            func_with_block_id, tuple(out_ind), *blockwise_args, dtype=dtype,
            adjust_chunks=adjust_chunks, align_arrays=False, **kwargs,
        )
    return blockwise(
        func, tuple(out_ind), *blockwise_args, dtype=dtype, adjust_chunks=adjust_chunks, **kwargs,
    )


def _offsets_array_for(x: CoreArray):
    """An array wrapping a VirtualOffsetsArray matching x's block grid."""
    offsets = virtual_offsets(x.numblocks)
    name = gensym("block-ids")
    return new_array(name, offsets, x.spec, Plan._new(name, "block_ids", offsets))


def _func_argnames(func) -> tuple:
    import inspect

    try:
        return tuple(inspect.signature(func).parameters)
    except (TypeError, ValueError):
        return ()


def empty_virtual_array(shape, dtype=np.float64, chunks="auto", spec=None, hidden=True) -> CoreArray:
    spec = spec_from_config(spec)
    outchunks = normalize_chunks(chunks, shape, dtype=dtype)
    target = virtual_empty(shape, dtype=dtype, chunks=to_chunksize(outchunks) if shape else ())
    name = gensym("empty")
    return new_array(name, target, spec, Plan._new(name, "empty", target, None, hidden))


def map_direct(
    func: Callable,
    *args: CoreArray,
    shape,
    dtype,
    chunks,
    extra_projected_mem: int,
    spec=None,
) -> CoreArray:
    """Map a function over blocks of a new array, with side-input access to
    whole source arrays. Not fusable: side-input reads are outside the
    blockwise memory model.

    The chunk function declares its ``side_inputs``, so the device executor
    writes resident side inputs to storage before the tasks read them, and
    passes on a task body's ``whole_select``, ``resident_identity`` or
    ``whole_concat``, which let that executor compute the op on resident
    arrays instead."""
    from ..storage.zarr import open_if_lazy_zarr_array

    spec = _spec_of(*args, spec=spec)
    nc = normalize_chunks(chunks, shape, dtype=dtype)
    out = empty_virtual_array(shape, dtype=dtype, chunks=nc, spec=spec, hidden=True)
    side_arrays = [a.zarray_maybe_lazy for a in args]

    def new_func(block, block_id=None):
        return func(block, *[open_if_lazy_zarr_array(s) for s in side_arrays], block_id=block_id)

    new_func.__name__ = getattr(func, "__name__", "map_direct")
    new_func.side_inputs = side_arrays
    for attr in ("whole_select", "resident_identity", "whole_concat"):
        if hasattr(func, attr):
            setattr(new_func, attr, getattr(func, attr))
    mapped = map_blocks(
        new_func, out, dtype=dtype, chunks=nc,
        extra_projected_mem=extra_projected_mem, fusable=False,
    )
    # record the side inputs as dependencies, so they are computed first
    op_node = mapped.plan.dag.predecessors(mapped.name)[0]
    dag = Dag.compose(*[a.plan.dag for a in args], mapped.plan.dag)
    for a in args:
        dag.add_edge(a.name, op_node)
    mapped.plan = Plan(dag)
    return mapped


# ---------------------------------------------------------------------------
# Indexing
# ---------------------------------------------------------------------------


def index(x: CoreArray, key) -> CoreArray:
    """Basic indexing: ints, slices with positive steps, and Ellipsis.
    ``None`` (new axes), negative steps and array indices are not ported."""
    if not isinstance(key, tuple):
        key = (key,)
    if not all(k is Ellipsis or isinstance(k, (slice, int, np.integer)) for k in key):
        raise NotImplementedError("only ints, slices and Ellipsis index a cubed_tpu_torch array")
    n_consuming = sum(1 for k in key if k is not Ellipsis)
    if n_consuming > x.ndim:
        raise IndexError(f"too many indices for array with {x.ndim} dimensions")
    n_ellipsis = sum(1 for k in key if k is Ellipsis)
    if n_ellipsis > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    if n_ellipsis:
        i = next(i for i, k in enumerate(key) if k is Ellipsis)
        key = key[:i] + (slice(None),) * (x.ndim - n_consuming) + key[i + 1 :]
    key = key + (slice(None),) * (x.ndim - len(key))

    # every axis as a resolved (start, stop, step); an int keeps a length-1
    # axis here and is squeezed away afterwards
    int_axes = []
    selections = []
    for ax, k in enumerate(key):
        size = x.shape[ax]
        if isinstance(k, slice):
            start, stop, step = k.indices(size)
            if step < 0:
                raise NotImplementedError("negative slice steps are not ported")
        else:
            start = int(k) + (size if k < 0 else 0)
            if not (0 <= start < size):
                raise IndexError(f"index {k} out of bounds for axis {ax} (size {size})")
            stop, step = start + 1, 1
            int_axes.append(ax)
        selections.append((start, stop, step))
    out_shape = tuple(max(0, -(-(stop - start) // step)) for start, stop, step in selections)

    if all(s == (0, n, 1) for s, n in zip(selections, x.shape)):
        result = x
    else:
        # output keeps the input chunksize (regular chunks)
        out_chunksize = tuple(
            min(cs, osh) if osh > 0 else 1 for cs, osh in zip(x.chunksize, out_shape)
        )
        out_chunks = normalize_chunks(out_chunksize, out_shape, dtype=x.dtype)
        result = map_direct(
            _IndexRead(out_chunks, selections),
            x,
            shape=out_shape,
            dtype=x.dtype,
            chunks=out_chunks,
            extra_projected_mem=x.chunkmem + chunk_memory(x.dtype, out_chunksize),
        )
    if int_axes:
        from ..array_api.manipulation_functions import _squeeze_axes

        result = _squeeze_axes(result, tuple(int_axes))
    return result


class _IndexRead:
    """Task body for index: read this output block's strided selection.

    A slice moves data and computes nothing, so its block stays on the host
    between the two stores instead of crossing to the card and back.
    ``whole_select``, the global (start, stop, step) of every axis, lets the
    device executor take the whole index as one view of a resident array."""

    __name__ = "index"

    def __init__(self, out_chunks, selections):
        self.out_chunks = out_chunks
        self.whole_select = selections

    def __call__(self, block, zarray, block_id=None):
        sel = []
        for bid, chunks_ax, (s0, _, step) in zip(block_id, self.out_chunks, self.whole_select):
            start = sum(chunks_ax[:bid])
            sel.append(slice(s0 + start * step, s0 + (start + chunks_ax[bid]) * step, step))
        return zarray[tuple(sel)]


# ---------------------------------------------------------------------------
# Reductions (tree formulation)
# ---------------------------------------------------------------------------


def reduction(
    x: CoreArray,
    func: Callable,
    combine_func: Optional[Callable] = None,
    aggregate_func: Optional[Callable] = None,
    axis=None,
    intermediate_dtype=None,
    dtype=None,
    keepdims: bool = False,
    split_every: Optional[int] = None,
    extra_func_kwargs: Optional[dict] = None,
) -> CoreArray:
    """Tree reduction: a per-block partial reduce, then rounds of bounded
    combines until one block remains per reduced axis, then an optional
    aggregate."""
    if combine_func is None:
        combine_func = func
    if axis is None:
        axis = tuple(range(x.ndim))
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    axis = tuple(ax % x.ndim for ax in axis)
    if intermediate_dtype is None:
        intermediate_dtype = dtype
    kw = dict(extra_func_kwargs or {})
    split = split_every or 4
    fields = _fields_of(intermediate_dtype)
    if fields is None and aggregate_func is not None:
        raise NotImplementedError("an aggregate needs a structured intermediate_dtype here")
    if fields is not None:
        if aggregate_func is None:
            raise ValueError("structured intermediate_dtype requires aggregate_func")
        # pytree intermediates ride as one plain array per field, produced by
        # multi-output ops
        parts = reduction_fields(
            x, func, combine_func, axis=axis, fields=fields,
            split_every=split, extra_func_kwargs=kw,
        )
        result = _aggregate_fields(parts, aggregate_func, dtype, list(fields))
    else:
        inds = tuple(range(x.ndim))
        result = blockwise(
            _InitialReduce(func, axis, kw),
            inds, x, inds,
            dtype=intermediate_dtype,
            adjust_chunks={i: 1 for i in range(x.ndim) if i in axis},
        )
        while any(result.numblocks[ax] > 1 for ax in axis):
            result = partial_reduce(
                result,
                _StreamingCombine(combine_func, axis, kw),
                split_every={ax: split for ax in axis},
                dtype=intermediate_dtype,
            )
    if not keepdims:
        from ..array_api.manipulation_functions import _squeeze_axes

        result = _squeeze_axes(result, axis)
    if dtype is not None and result.dtype != np.dtype(dtype):
        from ..array_api.data_type_functions import astype

        result = astype(result, dtype)
    return result


class _InitialReduce:
    """The per-block reduce of a reduction tree, over *axis* with every axis
    kept. With *fields* it returns one chunk per field of the {field: chunk}
    pytree, in that order. ``reduce_kind`` is *func*'s tag (``"sum"``,
    ``"mean"``), which the device executor's fusion rule reads."""

    def __init__(self, func: Callable, axis: tuple, kw: dict, fields: Optional[list] = None):
        self.func = func
        self.axis = axis
        self.kw = kw
        self.fields = fields
        self.reduce_kind = getattr(func, "reduce_kind", None)

    def __call__(self, chunk):
        out = self.func(chunk, axis=self.axis, keepdims=True, **self.kw)
        return out if self.fields is None else tuple(out[k] for k in self.fields)


class _StreamingCombine:
    """Combine a group of blocks along the reduced axes, streaming: one
    concat buffer however large the group. ``combine_region`` combines one
    contiguous region of blocks in one call, which the device executor
    takes when the group's blocks are resident."""

    __name__ = "partial_reduce"

    def __init__(self, combine_func, axis: tuple, kw: dict):
        self.combine_func = combine_func
        self.axis = axis
        self.kw = kw
        self.reduce_kind = getattr(combine_func, "reduce_kind", None)

    def __call__(self, chunks_iter):
        acc = None
        for chunk in chunks_iter:
            if acc is None:
                acc = chunk
            else:
                merged = _concat_pytree(acc, chunk, self.axis[0])
                acc = self.combine_func(merged, axis=self.axis, keepdims=True, **self.kw)
        return acc

    def combine_region(self, region):
        return self.combine_func(region, axis=self.axis, keepdims=True, **self.kw)


def _concat_pytree(a, b, axis: int):
    if isinstance(a, dict):
        return {k: _concat_pytree(a[k], b[k], axis) for k in a}
    return nxp.concat([a, b], axis=axis)


def _group_ranges(out_coords, split_every: dict, in_numblocks) -> list:
    """Per-axis input block ranges that output block *out_coords* combines."""
    ranges = []
    for i, bi in enumerate(out_coords):
        if i in split_every:
            start = bi * split_every[i]
            ranges.append(range(start, min(start + split_every[i], in_numblocks[i])))
        else:
            ranges.append(range(bi, bi + 1))
    return ranges


def partial_reduce(x: CoreArray, func: Callable, split_every: dict, dtype=None) -> CoreArray:
    """One tree level: combine groups of blocks along the reduced axes. The
    block function yields an iterator of input keys, so a task streams its
    chunks one at a time."""
    chunks = tuple(
        (1,) * math.ceil(len(c) / split_every[i]) if i in split_every else c
        for i, c in enumerate(x.chunks)
    )
    in_numblocks = x.numblocks
    x_name = x.name

    def block_function(out_key):
        ranges = _group_ranges(out_key[1:], split_every, in_numblocks)
        return (iter((x_name, *idx) for idx in itertools.product(*ranges)),)

    return general_blockwise(
        func,
        block_function,
        x,
        shape=tuple(sum(c) for c in chunks),
        dtype=dtype if dtype is not None else x.dtype,
        chunks=chunks,
        extra_projected_mem=2 * x.chunkmem,  # accumulator + concat buffer
        num_input_blocks=(max(split_every.values()),),
        fusable=False,
        op_name="partial_reduce",
    )


def reduction_fields(
    x: CoreArray,
    func: Callable,
    combine_func: Callable,
    *,
    axis: tuple,
    fields: dict,
    split_every: int = 4,
    extra_func_kwargs: Optional[dict] = None,
):
    """The pytree-field reduction tree without the final aggregate."""
    kw = dict(extra_func_kwargs or {})
    parts = _multi_field_map(
        x,
        _InitialReduce(func, axis, kw, list(fields)),
        fields,
        chunks=tuple(
            (1,) * x.numblocks[i] if i in axis else c for i, c in enumerate(x.chunks)
        ),
        op_name="initial_reduce",
    )
    while any(parts[0].numblocks[ax] > 1 for ax in axis):
        parts = partial_reduce_multi(
            parts,
            _StreamingCombineMulti(combine_func, axis, kw, list(fields)),
            split_every={ax: split_every for ax in axis},
            fields=fields,
        )
    return parts


def _fields_of(intermediate_dtype) -> Optional[dict]:
    """{field name -> plain dtype} for a structured dtype, else None."""
    if intermediate_dtype is None:
        return None
    dt = np.dtype(intermediate_dtype)
    if dt.fields is None:
        return None
    return {name: dt.fields[name][0] for name in dt.names}


def _multi_field_map(x: CoreArray, kernel: Callable, fields: dict, chunks, op_name: str) -> tuple:
    """One multi-output op mapping *kernel* (returning one chunk per field)
    1:1 over x's blocks; each field becomes a plain array output."""
    names = list(fields)
    x_name = x.name

    def block_function(out_key):
        return ((x_name, *out_key[1:]),)

    shape = tuple(sum(c) for c in chunks)
    return general_blockwise(
        kernel, block_function, x,
        shape=[shape] * len(names),
        dtype=[fields[k] for k in names],
        chunks=chunks,
        op_name=op_name,
    )


def partial_reduce_multi(parts: Sequence[CoreArray], combiner: Callable, split_every: dict,
                         fields: dict) -> tuple:
    """One tree level over pytree intermediates held as N field arrays."""
    x0 = parts[0]
    chunks = tuple(
        (1,) * math.ceil(len(c) / split_every[i]) if i in split_every else c
        for i, c in enumerate(x0.chunks)
    )
    in_numblocks = x0.numblocks
    part_names = [p.name for p in parts]

    def block_function(out_key):
        idxs = list(itertools.product(*_group_ranges(out_key[1:], split_every, in_numblocks)))
        return tuple(iter([(pn, *idx) for idx in idxs]) for pn in part_names)

    shape = tuple(sum(c) for c in chunks)
    return general_blockwise(
        combiner,
        block_function,
        *parts,
        shape=[shape] * len(parts),
        dtype=[fields[k] for k in fields],
        chunks=chunks,
        extra_projected_mem=2 * sum(p.chunkmem for p in parts),
        num_input_blocks=(max(split_every.values()),) * len(parts),
        fusable=False,
        op_name="partial_reduce",
    )


class _StreamingCombineMulti:
    """Multi-field :class:`_StreamingCombine`: streams N zipped block
    iterators, reassembling the {field: chunk} pytree at each step."""

    __name__ = "partial_reduce"

    def __init__(self, combine_func, axis: tuple, kw: dict, names: list):
        self.combine_func = combine_func
        self.axis = axis
        self.kw = kw
        self.names = names

    def __call__(self, *iters):
        acc = None
        for vals in zip(*iters):
            d = dict(zip(self.names, vals))
            if acc is None:
                acc = d
            else:
                merged = _concat_pytree(acc, d, self.axis[0])
                acc = self.combine_func(merged, axis=self.axis, keepdims=True, **self.kw)
        return tuple(acc[k] for k in self.names)

    def combine_region(self, *regions):
        out = self.combine_func(dict(zip(self.names, regions)), axis=self.axis, keepdims=True, **self.kw)
        return tuple(out[k] for k in self.names)


def _aggregate_fields(parts: Sequence[CoreArray], aggregate_func: Callable, dtype, names: list) -> CoreArray:
    """Final aggregate over N field arrays -> one plain array (1:1 blocks)."""
    inds = tuple(range(parts[0].ndim))

    def agg_kernel(*chunks):
        return aggregate_func(dict(zip(names, chunks)))

    agg_kernel.__name__ = getattr(aggregate_func, "__name__", "aggregate")
    args = []
    for p in parts:
        args.extend([p, inds])
    return blockwise(agg_kernel, inds, *args, dtype=dtype)
