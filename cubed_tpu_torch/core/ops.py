"""Whole-array operations, built on the blockwise and rechunk primitives.

Counterpart of ``cubed_tpu/core/ops.py``, trimmed to the part the port
runs: ``from_array``, ``from_zarr``, ``blockwise``/``general_blockwise``
(inputs chunked differently are unified by ``unify_chunks``, which
rechunks them), ``elemwise``, ``map_blocks`` (with ``drop_axis``,
``new_axis``, and a block's offset as data for a function that
``supports_offset``)/``map_direct``, ``index`` (ints, slices
of any step, ``None`` and one integer array), ``rechunk``,
``merge_chunks``, the tree ``reduction`` (an aggregate over a plain or a
pytree-field intermediate: mean's ``{n, total}``) and ``arg_reduction``,
``to_zarr``/``store`` (an identity blockwise into the user's store, which
fuses with its producer) and ``map_overlap`` (the stencil: each task reads
its block and the halo, and pads at the array's boundary).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..backend_array_api import (
    logical_right_shift64,
    numpy_array_to_backend_array,
    nxp,
    to_torch_dtype,
    wrap_unsigned,
)
from ..chunks import normalize_chunks
from ..primitive.blockwise import (
    blockwise as primitive_blockwise,
    general_blockwise as primitive_general_blockwise,
)
from ..primitive.rechunk import rechunk as primitive_rechunk
from ..spec import Spec, spec_from_config
from ..storage.store import ZarrV2Array, open_zarr_array
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
    """Create an array from an in-memory numpy array or an open Zarr array.
    A Zarr array is wrapped in place (no data read) and rechunked when
    *chunks* differ from its own; a small numpy array rides the plan as a
    virtual array; a larger one is sliced per output chunk by a map_blocks
    whose closure carries it."""
    if isinstance(x, CoreArray):
        raise ValueError("Array is already a cubed_tpu_torch array - use rechunk instead of from_array")
    spec = spec_from_config(spec)
    if isinstance(x, ZarrV2Array):
        name = gensym("from-array")
        arr = new_array(name, x, spec, Plan._new(name, "from_array", x))
        outchunks = normalize_chunks(chunks, x.shape, dtype=x.dtype)
        if to_chunksize(outchunks) != tuple(x.chunks):
            arr = rechunk(arr, outchunks)
        return arr
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


def from_zarr(store, path=None, spec=None, storage_options=None) -> "CoreArray":
    """Load an array from an existing Zarr v2 store (no data read): a local
    path, or a URL opened through fsspec with *storage_options* (else the
    spec's)."""
    spec = spec_from_config(spec)
    name = gensym("from-zarr")
    target = open_zarr_array(store if path is None else f"{store}/{path}", mode="r",
                             storage_options=storage_options or (spec.storage_options if spec else None))
    return new_array(name, target, spec, Plan._new(name, "from_zarr", target))


def to_zarr(x: CoreArray, store, path=None, executor=None, storage_options=None, compressor=None,
            **kwargs) -> None:
    """Compute the array and write it to a new Zarr store (eagerly): a local
    path, or a URL opened through fsspec with *storage_options*.

    ``compressor`` is a Zarr v2 compressor config (``{"id": "zlib",
    "level": 1}``; the stdlib codecs zlib, gzip, bz2 and lzma). The target's
    metadata is stamped first, so every chunk write goes through the codec:
    the plan's lazy target opens existing metadata rather than replacing it.
    The stored result is not read back (the JAX package's ``to_zarr`` reads
    it and drops it).
    """
    from .array import execute

    target = str(store) if path is None else f"{store}/{path}"
    if compressor is not None:
        open_zarr_array(target, mode="w", shape=x.shape, dtype=x.dtype, chunks=x.chunksize if x.ndim else (),
                        compressor=compressor, storage_options=storage_options)
    execute(_store_op(x, target, storage_options), executor=executor, **kwargs)


def store(sources, targets, executor=None, **kwargs) -> None:
    """Compute several arrays into several stores, in one plan (nothing is
    read back)."""
    from .array import execute

    if isinstance(sources, CoreArray):
        sources, targets = [sources], [targets]
    execute(*[_store_op(s, t) for s, t in zip(sources, targets)], executor=executor, **kwargs)


def _store_op(x: CoreArray, store, storage_options=None) -> CoreArray:
    def _identity(a):
        return a

    _identity.batchable = True
    # an identity blockwise into an explicit target store; it fuses with
    # its producer, which then writes the store itself
    return blockwise(
        _identity, tuple(range(x.ndim))[::-1], x, tuple(range(x.ndim))[::-1], dtype=x.dtype,
        target_store=str(store), storage_options=storage_options, shape_invariant=True,
    )


# ---------------------------------------------------------------------------
# Blockwise (core wrapper)
# ---------------------------------------------------------------------------


def blockwise(
    func: Callable,
    out_ind: Sequence,
    *args,  # pairs of (array, indices)
    dtype=None,
    adjust_chunks: Optional[dict] = None,
    new_axes: Optional[dict] = None,
    align_arrays: bool = True,
    extra_projected_mem: int = 0,
    target_store=None,
    storage_options=None,
    fusable: bool = True,
    shape_invariant: bool = False,
    **kwargs,
) -> CoreArray:
    """Apply *func* across blocks matched by index notation. The output goes
    to *target_store* where one is given (a local path, or a URL opened
    through fsspec with *storage_options*, else the spec's), else to a
    temporary store in the work dir."""
    arrays = list(args[0::2])
    inds = [tuple(i) if i is not None else None for i in args[1::2]]
    spec = _spec_of(*arrays)
    if align_arrays:
        _, arrays = unify_chunks(*itertools.chain(*zip(arrays, inds)))

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
    for sym, size in (new_axes or {}).items():
        chunkss[sym] = tuple(size) if isinstance(size, (tuple, list)) else (size,)

    chunks_out = []
    for sym in out_ind:
        c = chunkss[sym]
        if adjust_chunks and sym in adjust_chunks:
            adj = adjust_chunks[sym]
            c = (int(adj),) * len(c) if isinstance(adj, (int, np.integer)) else tuple(adj)
        chunks_out.append(tuple(c))
    chunks_out = tuple(chunks_out)
    shape = tuple(sum(c) for c in chunks_out)

    multi, names, target_store = _alloc_output_names_stores(dtype, spec, target_store)
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
        storage_options=storage_options or spec.storage_options,
        **kwargs,
    )
    return _wrap_op_outputs(op, getattr(func, "__name__", "blockwise"), spec, arrays, names)


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
    ``shape``) as lists; ``func`` returns a tuple of arrays per task.
    ``chunks`` may then be a list, one entry per output, each normalized
    against its own shape (the outputs must share one block grid)."""
    spec = _spec_of(*arrays)
    multi, names, target_store = _alloc_output_names_stores(dtype, spec)
    if multi:
        shapes = (
            list(shape) if shape and isinstance(shape[0], (list, tuple))
            else [tuple(shape)] * len(dtype)
        )
        if isinstance(chunks, list):
            if len(chunks) != len(dtype):
                raise ValueError(
                    "per-output chunks list must have one entry per "
                    f"output; got {len(chunks)} for {len(dtype)} outputs"
                )
            chunks = [normalize_chunks(c, s, dtype=dt) for c, s, dt in zip(chunks, shapes, dtype)]
        else:
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
        storage_options=spec.storage_options,
    )
    return _wrap_op_outputs(op, op_name, spec, arrays, names)


def _alloc_output_names_stores(dtype, spec, target_store=None):
    """(multi?, output names, store path(s)) for an op's output(s): the
    *target_store* given (a list of one per output for a multi-output op),
    else temporary paths."""
    multi = isinstance(dtype, (list, tuple))
    names = [gensym("array") for _ in dtype] if multi else [gensym("array")]
    if target_store is None:
        stores = [new_temp_path(n, spec) for n in names]
        return multi, names, stores if multi else stores[0]
    if multi and isinstance(target_store, str):
        raise TypeError("multi-output ops require target_store to be a list (one store per output) or None")
    return multi, names, target_store


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

    dtype = np.dtype(dtype)
    if any(np.dtype(getattr(a, "dtype", float)) == np.uint64 for a in args) and func not in _UINT64_CARRIED:
        raise TypeError(f"{getattr(func, '__name__', func)} of uint64 is not supported by cubed_tpu_torch "
                        "(uint64 rides in int64, whose order and conversions differ past 2**63)")

    if dtype in (np.dtype(np.uint16), np.dtype(np.uint32)):

        def elementwise_chunk(*chunks):
            return wrap_unsigned(func(*chunks), dtype)
    else:

        def elementwise_chunk(*chunks):
            return func(*chunks)

    elementwise_chunk.__name__ = elementwise_chunk.elementwise = getattr(func, "__name__", "elemwise")
    # every nxp elementwise function runs under torch.func.vmap
    elementwise_chunk.batchable = True
    return blockwise(
        elementwise_chunk, tuple(range(out_ndim))[::-1], *blockwise_args, dtype=dtype,
        shape_invariant=True,
    )


#: elementwise functions whose int64 result has the bits of the uint64 one
_UINT64_CARRIED = (
    nxp.add, nxp.subtract, nxp.multiply, nxp.negative, nxp.positive, nxp.square, nxp.equal, nxp.not_equal,
    nxp.bitwise_and, nxp.bitwise_or, nxp.bitwise_xor, nxp.bitwise_invert, nxp.bitwise_left_shift,
    logical_right_shift64, nxp.isfinite, nxp.isinf, nxp.isnan, nxp.where, nxp.conj,
)


def map_blocks(func: Callable, *args, dtype=None, chunks=None, drop_axis=None, new_axis=None,
               **kwargs) -> CoreArray:
    """Apply a function to corresponding blocks; *chunks* (one entry per
    output dim: a size or a tuple of sizes) sets the output chunking,
    *drop_axis* removes input axes and *new_axis* inserts output axes. A
    *func* with a ``block_id`` parameter gets each block's index, read from
    a hidden offsets array; one that declares ``supports_offset`` gets the
    block's linear ``offset`` and the grid's ``numblocks`` instead, as data
    (a tensor under ``torch.func.vmap``), so it batches. Other keyword
    arguments go to *func*."""
    arrays = [a for a in args if isinstance(a, CoreArray)]
    if len(arrays) != len(args):
        raise ValueError("non-array positional args not supported; use kwargs")
    drop_axis = [drop_axis] if isinstance(drop_axis, (int, np.integer)) else list(drop_axis or [])
    new_axis = [new_axis] if isinstance(new_axis, (int, np.integer)) else list(new_axis or [])
    x = arrays[0]
    in_ndim = x.ndim
    out_ind = [i for i in range(in_ndim) if i not in drop_axis]
    sym = in_ndim
    for ax in sorted(new_axis):  # a new symbol at each new axis
        out_ind.insert(ax, sym)
        sym += 1

    adjust_chunks = None
    new_axes = {}
    if chunks is not None:
        adjust_chunks = {}
        for pos, s in enumerate(out_ind):
            c = chunks[pos]
            size = int(c) if isinstance(c, (int, np.integer)) else tuple(c)
            if pos in new_axis:
                new_axes[s] = size
            else:
                adjust_chunks[s] = size
    else:
        new_axes = {out_ind[ax]: 1 for ax in new_axis}

    blockwise_args = []
    for a in arrays:
        blockwise_args.extend([a, tuple(range(a.ndim))])

    if "block_id" in _func_argnames(func) or getattr(func, "supports_offset", False):
        offsets = _offsets_array_for(x)
        numblocks = x.numblocks
        if getattr(func, "supports_offset", False):

            def func_with_block_id(*chunk_args, **kw):
                *real, offset = chunk_args
                return func(*real, offset=offset, numblocks=numblocks, **kw)

            # the block's offset reaches the function as data: it batches
            func_with_block_id.traced_offsets = True
            func_with_block_id.batchable = getattr(func, "batchable", False)
        else:

            def func_with_block_id(*chunk_args, **kw):
                *real, offset = chunk_args
                return func(*real, block_id=offset_to_block_id(_scalar_int(offset), numblocks), **kw)

            # the offset -> block_id conversion runs on the host
            func_with_block_id.host_block_id = True
        func_with_block_id.__name__ = getattr(func, "__name__", "map_blocks")
        for attr in ("side_inputs", "whole_select", "resident_identity", "whole_concat", "device_reads",
                     "host_data_nbytes"):
            if hasattr(func, attr):
                setattr(func_with_block_id, attr, getattr(func, attr))
        blockwise_args.extend([offsets, tuple(range(in_ndim))])
        return blockwise(
            func_with_block_id, tuple(out_ind), *blockwise_args, dtype=dtype,
            adjust_chunks=adjust_chunks, new_axes=new_axes or None, align_arrays=False, **kwargs,
        )
    blocks = [(a.chunksize, a.dtype) for a in arrays]
    return blockwise(
        _declare_batchable(func, blocks, kwargs), tuple(out_ind), *blockwise_args, dtype=dtype,
        adjust_chunks=adjust_chunks, new_axes=new_axes or None, **kwargs,
    )


def _declare_batchable(func: Callable, blocks, kwargs: dict) -> Callable:
    """*func* with its ``batchable`` hint (it runs under ``torch.func.vmap``;
    the device executor's batched route reads it), decided once at plan time
    from metadata: *func* traced under ``torch.func.vmap`` on meta tensors,
    two stacked blocks of each input's chunk shape and dtype (*blocks*), with
    *kwargs*. A function that declares the hint itself keeps it."""
    if hasattr(func, "batchable"):
        return func
    try:
        args = [torch.empty((2, *shape), dtype=to_torch_dtype(dt), device="meta") for shape, dt in blocks]
        torch.func.vmap(lambda *chunks: func(*chunks, **kwargs))(*args)
        batchable = True
    except Exception:
        # whatever stops the trace (host code, data-dependent shapes, an op
        # without a meta kernel) means the op does not batch: the device
        # executor then counts a failed batched check and runs it chunked
        batchable = False

    def declared(*chunks, **kw):
        return func(*chunks, **kw)

    declared.__name__ = getattr(func, "__name__", "map_blocks")
    declared.batchable = batchable
    return declared


def _offsets_array_for(x: CoreArray):
    """An array wrapping a VirtualOffsetsArray matching x's block grid."""
    offsets = virtual_offsets(x.numblocks)
    name = gensym("block-ids")
    return new_array(name, offsets, x.spec, Plan._new(name, "block_ids", offsets))


def block_index_from_offset(off, axis: int, numblocks: tuple):
    """The *axis* block index of a block from its linear offset (a chunk of
    a VirtualOffsetsArray, read as data): the row-major decode, a device
    expression, so offset-seeded kernels run under ``torch.func.vmap``
    (the sort network's merge routing and its positions)."""
    stride = math.prod(numblocks[axis + 1:])
    return (off.reshape(-1)[0] // stride) % numblocks[axis]


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


#: store -> a device view of a resident side input, while the device
#: executor runs a map_direct op's task bodies on arrays it holds on the card
_SIDE_VIEWS: contextvars.ContextVar = contextvars.ContextVar("cubed_tpu_torch_side_views", default=None)


@contextlib.contextmanager
def side_input_views(views: dict):
    """Within this block, a map_direct task body reads the side inputs whose
    store is in *views* from those objects (each with ``[...]`` and
    ``.oindex[...]``, as a Zarr array has) instead of from storage."""
    token = _SIDE_VIEWS.set(views)
    try:
        yield
    finally:
        _SIDE_VIEWS.reset(token)


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
    arrays instead. A task body that declares ``device_reads`` takes
    tensors from its reads (it passes them through
    ``numpy_array_to_backend_array``): that executor then hands it its
    resident side inputs as views on the card (:func:`side_input_views`)
    and writes nothing to storage."""
    from ..storage.zarr import open_if_lazy_zarr_array

    spec = _spec_of(*args, spec=spec)
    nc = normalize_chunks(chunks, shape, dtype=dtype)
    out = empty_virtual_array(shape, dtype=dtype, chunks=nc, spec=spec, hidden=True)
    side_arrays = [a.zarray_maybe_lazy for a in args]

    def new_func(block, block_id=None):
        views = _SIDE_VIEWS.get()
        opened = [
            views[k] if views and (k := str(getattr(s, "store", id(s)))) in views else open_if_lazy_zarr_array(s)
            for s in side_arrays
        ]
        return func(block, *opened, block_id=block_id)

    new_func.__name__ = getattr(func, "__name__", "map_direct")
    new_func.side_inputs = side_arrays
    for attr in ("whole_select", "resident_identity", "whole_concat", "device_reads"):
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


def map_overlap(func: Callable, x: CoreArray, *, depth, boundary="reflect", dtype=None,
                trim: bool = True) -> CoreArray:
    """Map *func* over blocks extended by *depth* halo elements on each side:
    the chunked stencil (dask.array.map_overlap's semantics).

    Each task reads its block and the halo from the source in one region
    read, pads at the array's boundary by *boundary* (``"reflect"``, which
    includes the edge element as numpy's ``symmetric`` does, ``"nearest"``,
    ``"periodic"``, or a number, cast to the input's dtype), applies *func*
    to the extended block and, with *trim*, cuts *depth* off the result;
    without it the output's chunks grow by ``2 * depth``. A task's memory is
    its block and halo, priced into the plan. *depth* is an int, a per-axis
    sequence, or a dict of axis (negative allowed) to depth.

    The task body takes tensors from its reads (``device_reads``): on the
    device executor it reads a resident input as a view on the card, and the
    halo is built there by slices and ``torch.cat``, for every dtype."""
    if dtype is None:
        dtype = x.dtype
    if isinstance(depth, (int, np.integer)):
        depths = [int(depth)] * x.ndim
    elif isinstance(depth, dict):
        norm = {}
        for ax, d in depth.items():
            if not -x.ndim <= ax < x.ndim:
                raise IndexError(f"map_overlap: depth axis {ax} is out of bounds for array of dimension {x.ndim}")
            norm[ax % x.ndim] = int(d)
        depths = [norm.get(ax, 0) for ax in range(x.ndim)]
    else:
        depths = [int(d) for d in depth]
        if len(depths) != x.ndim:
            raise ValueError(f"depth has {len(depths)} entries for {x.ndim} axes")
    if any(d < 0 for d in depths):
        raise ValueError("map_overlap: depth must be non-negative")
    if any(d > s for d, s in zip(depths, x.shape)):
        raise ValueError("map_overlap: depth exceeds the array extent")
    fill = None
    if not isinstance(boundary, str):
        # np.pad's cast: the constant assigned into the input's dtype
        cast = np.zeros((), dtype=x.dtype)
        cast[()] = float(boundary)
        fill = cast.item()
    elif boundary not in ("reflect", "nearest", "periodic"):
        raise ValueError(f"map_overlap: unsupported boundary {boundary!r}")

    chunks, shape, ndim = x.chunks, x.shape, x.ndim
    periodic = boundary == "periodic"

    def _read_overlap(block, zarray, block_id=None):
        if periodic:
            # a wrapped halo comes from the far end of the array: the
            # window's positions along an axis are at most three runs mod n,
            # and the block is stitched from the product of the runs
            runs = []
            for ax in range(ndim):
                start = sum(chunks[ax][: block_id[ax]])
                lo, hi = start - depths[ax], start + chunks[ax][block_id[ax]] + depths[ax]
                n_ax = shape[ax]
                ax_runs = [slice(n_ax + lo, n_ax)] if lo < 0 else []
                ax_runs.append(slice(max(0, lo), min(n_ax, hi)))
                if hi > n_ax:
                    ax_runs.append(slice(0, hi - n_ax))
                runs.append(ax_runs)

            def rec(ax, prefix):
                if ax == ndim:
                    return numpy_array_to_backend_array(zarray[tuple(prefix)])
                parts = [rec(ax + 1, prefix + [s]) for s in runs[ax]]
                return torch.cat(parts, dim=ax) if len(parts) > 1 else parts[0]

            data = rec(0, [])
        else:
            sel, pads = [], []
            for ax in range(ndim):
                start = sum(chunks[ax][: block_id[ax]])
                lo, hi = start - depths[ax], start + chunks[ax][block_id[ax]] + depths[ax]
                sel.append(slice(max(0, lo), min(shape[ax], hi)))
                pads.append((max(0, -lo), max(0, hi - shape[ax])))
            data = _pad_halo(numpy_array_to_backend_array(zarray[tuple(sel)]), pads, boundary, fill)
        out = func(data)
        if trim:
            out = out[tuple(slice(depths[ax], out.shape[ax] - depths[ax] or None) for ax in range(ndim))]
        return out

    _read_overlap.__name__ = getattr(func, "__name__", "map_overlap")
    _read_overlap.device_reads = True

    halo_elems = math.prod(x.chunksize[ax] + 2 * depths[ax] for ax in range(ndim))
    # the read and its padded copy are in the input's dtype, func's result in
    # the output's: priced at the wider of the two
    extra = 4 * halo_elems * max(np.dtype(x.dtype).itemsize, np.dtype(dtype).itemsize)
    if trim:
        out_shape, out_chunks = shape, chunks
    else:
        # the untrimmed result keeps its halo: every output block is the
        # extended block, so the grid stays and each chunk grows by 2 * depth
        out_chunks = tuple(tuple(c + 2 * depths[ax] for c in chunks[ax]) for ax in range(ndim))
        out_shape = tuple(sum(c) for c in out_chunks)
    return map_direct(
        _read_overlap, x, shape=out_shape, dtype=np.dtype(dtype), chunks=out_chunks,
        extra_projected_mem=extra, spec=x.spec,
    )


def _pad_halo(data: torch.Tensor, pads, boundary, fill) -> torch.Tensor:
    """*data* padded by *pads* (a (before, after) pair per axis) as np.pad
    pads it: ``constant`` with *fill* (where *fill* is not None), ``edge``
    for ``"nearest"``, ``symmetric`` for ``"reflect"``. By slices and
    ``torch.cat``, which take every dtype (torch's own ``pad`` has no
    symmetric mode and refuses integer tensors)."""
    for ax, (lo, hi) in enumerate(pads):
        if not lo and not hi:
            continue
        n = data.shape[ax]

        def side(width, at_start):
            if fill is not None:
                size = list(data.shape)
                size[ax] = width
                return torch.full(size, fill, dtype=data.dtype, device=data.device)
            if boundary == "nearest":
                edge = data.narrow(ax, 0 if at_start else n - 1, 1)
                return edge.expand(*[width if d == ax else s for d, s in enumerate(data.shape)])
            # symmetric: the edge element included, mirrored (width <= n,
            # since depth never exceeds the array's extent)
            return torch.flip(data.narrow(ax, 0 if at_start else n - width, width), dims=(ax,))

        parts = ([side(lo, True)] if lo else []) + [data] + ([side(hi, False)] if hi else [])
        data = torch.cat(parts, dim=ax)
    return data


# ---------------------------------------------------------------------------
# Indexing
# ---------------------------------------------------------------------------


def index(x: CoreArray, key) -> CoreArray:
    """Orthogonal (outer) indexing: ints, slices (any step), Ellipsis,
    ``None`` (a new axis) and one integer-array index (a lazy one is
    computed first). A boolean array index is refused, as the JAX package
    refuses it."""
    if not isinstance(key, tuple):
        key = (key,)
    n_consuming = sum(1 for k in key if k is not None and k is not Ellipsis)
    if n_consuming > x.ndim:
        raise IndexError(f"too many indices for array with {x.ndim} dimensions")
    # `Ellipsis in key` would compare array entries elementwise
    n_ellipsis = sum(1 for k in key if k is Ellipsis)
    if n_ellipsis > 1:
        raise IndexError("an index can only have a single ellipsis ('...')")
    if n_ellipsis:
        i = next(i for i, k in enumerate(key) if k is Ellipsis)
        key = key[:i] + (slice(None),) * (x.ndim - n_consuming) + key[i + 1 :]
    key = key + (slice(None),) * (x.ndim - sum(1 for k in key if k is not None))

    # where each None goes in the output: slices and arrays keep an axis,
    # ints drop theirs, each None inserts one (after the squeeze)
    newaxis_positions = []
    out_pos = 0
    for k in key:
        if k is None:
            newaxis_positions.append(out_pos)
            out_pos += 1
        elif not isinstance(k, (int, np.integer)):
            out_pos += 1
    key = tuple(
        np.asarray(k.compute()) if isinstance(k, CoreArray)
        else np.asarray(k) if isinstance(k, (list, np.ndarray)) else k
        for k in key if k is not None
    )
    if sum(1 for k in key if isinstance(k, np.ndarray)) > 1:
        raise NotImplementedError("Only one integer array index is allowed")

    # every axis as a resolved (start, stop, step) or an integer array; an
    # int keeps a length-1 axis here and is squeezed away afterwards
    int_axes = []
    selections = []
    for ax, k in enumerate(key):
        size = x.shape[ax]
        if isinstance(k, slice):
            selections.append(k.indices(size))
        elif isinstance(k, (int, np.integer)):
            start = int(k) + (size if k < 0 else 0)
            if not (0 <= start < size):
                raise IndexError(f"index {k} out of bounds for axis {ax} (size {size})")
            selections.append((start, start + 1, 1))  # a view on the card
            int_axes.append(ax)
        elif isinstance(k, np.ndarray):
            if k.dtype == bool:
                raise NotImplementedError("boolean array indexing is not supported")
            selections.append(np.where(k < 0, k + size, k).astype(np.int64))
        else:
            raise IndexError(f"unsupported index {k!r}")
    out_shape = tuple(len(range(*s)) if isinstance(s, tuple) else len(s) for s in selections)

    if out_shape == x.shape and all(isinstance(s, tuple) and s == (0, n, 1) for s, n in zip(selections, x.shape)):
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
    for pos in newaxis_positions:
        from ..array_api.manipulation_functions import expand_dims

        result = expand_dims(result, axis=pos)
    return result


class _IndexRead:
    """Task body for index: read this output block's selection.

    A selection moves data and computes nothing, so a block read from
    storage stays on the host between the two stores instead of crossing to
    the card and back. ``whole_select``, the global (start, stop, step) or
    integer array of every axis, lets the device executor take the whole
    index from a resident array on the card."""

    __name__ = "index"
    device_reads = True

    def __init__(self, out_chunks, selections):
        self.out_chunks = out_chunks
        self.whole_select = selections

    def __call__(self, block, zarray, block_id=None):
        sel = []
        for bid, chunks_ax, s in zip(block_id, self.out_chunks, self.whole_select):
            start = sum(chunks_ax[:bid])
            stop = start + chunks_ax[bid]
            if isinstance(s, tuple):
                s0, _, step = s
                hi = s0 + stop * step
                # a stop of -1 means "walked past index 0"; as a slice bound
                # it would wrap to the end
                sel.append(slice(s0 + start * step, None if hi < 0 else hi, step))
            else:
                sel.append(s[start:stop])
        if all(isinstance(s, slice) and s.step > 0 for s in sel):
            return zarray[tuple(sel)]
        return zarray.oindex[tuple(sel)]


# ---------------------------------------------------------------------------
# Rechunking
# ---------------------------------------------------------------------------


def rechunk(x: CoreArray, chunks, target_store=None) -> CoreArray:
    """Change the chunking of *x* without changing its shape: one bounded
    copy op, or a chain of them through hidden intermediate arrays."""
    if isinstance(chunks, dict):
        chunks = tuple(chunks.get(i, x.chunksize[i]) for i in range(x.ndim))
    if isinstance(chunks, (int, np.integer)):
        chunks = (int(chunks),) * x.ndim
    norm = normalize_chunks(chunks, x.shape, dtype=x.dtype)
    target_chunksize = to_chunksize(norm) if x.shape else ()
    if target_chunksize == x.chunksize:
        return x

    spec = x.spec
    name = gensym("array")
    if target_store is None:
        target_store = new_temp_path(name, spec)
    ops = primitive_rechunk(
        x.zarray_maybe_lazy,
        source_chunks=x.chunksize,
        target_chunks=target_chunksize,
        allowed_mem=spec.allowed_mem,
        reserved_mem=spec.reserved_mem,
        target_store=target_store,
        temp_store=new_temp_path(f"{name}-int", spec),
        storage_options=spec.storage_options,
    )
    prev = x
    for i, op in enumerate(ops):
        last = i == len(ops) - 1
        nm = name if last else gensym("array")
        plan = Plan._new(nm, "rechunk", op.target_array, op, not last, prev)
        prev = new_array(nm, op.target_array, spec, plan)
    return prev


def merge_chunks(x: CoreArray, chunks) -> CoreArray:
    """Coalesce chunks: each target chunk must be a whole number of the
    current ones (or span its axis)."""
    target_chunksize = tuple(chunks)
    if len(target_chunksize) != x.ndim:
        raise ValueError(f"chunks {chunks} must have {x.ndim} dimensions")
    if any(t % c != 0 and t != s for t, c, s in zip(target_chunksize, x.chunksize, x.shape)):
        raise ValueError(
            f"merge_chunks: target chunks {chunks} must be a multiple of the "
            f"current chunks {x.chunksize}"
        )
    target_chunks = normalize_chunks(target_chunksize, x.shape, dtype=x.dtype)
    return map_direct(
        _MergedChunkRead(target_chunks),
        x,
        shape=x.shape,
        dtype=x.dtype,
        chunks=target_chunks,
        extra_projected_mem=chunk_memory(x.dtype, to_chunksize(target_chunks)) + x.chunkmem,
    )


class _MergedChunkRead:
    """Task body for merge_chunks: read this output block's region.
    ``resident_identity`` tells the device executor the values pass through
    unchanged (chunking is metadata of a resident array)."""

    __name__ = "merge_chunks"
    resident_identity = True
    device_reads = True

    def __init__(self, target_chunks):
        self.target_chunks = target_chunks

    def __call__(self, block, zarray, block_id=None):
        return numpy_array_to_backend_array(zarray[get_item(self.target_chunks, block_id)])


def unify_chunks(*args):
    """Align the chunking of arrays that share index symbols, rechunking
    where it differs. *args* are (array, indices) pairs; returns (the
    chunking of each symbol, the arrays). Along a symbol, differing
    chunkings of one extent unify to the smallest chunk size (regular, so
    every input can rechunk to it, and each task's memory stays bounded); a
    single size-1 block broadcasts."""
    arrays = list(args[0::2])
    inds = list(args[1::2])

    chunkss: dict = {}
    for a, ind in zip(arrays, inds):
        if ind is None:
            continue
        for sym, c, extent in zip(ind, a.chunks, a.shape):
            if sum(c) == 1 and len(c) == 1:
                chunkss.setdefault(sym, c)  # broadcast candidate
            elif sym not in chunkss or sum(chunkss[sym]) == 1:
                chunkss[sym] = c
            else:
                prev = chunkss[sym]
                if sum(prev) != sum(c):
                    raise ValueError(
                        f"Chunks do not align for symbol {sym!r}: "
                        f"{prev} vs {c} (extents {sum(prev)} != {sum(c)})"
                    )
                if c != prev:
                    chunkss[sym] = normalize_chunks((min(prev[0], c[0]),), (extent,), dtype=a.dtype)[0]

    unified = []
    for a, ind in zip(arrays, inds):
        if ind is None:
            unified.append(a)
            continue
        target = tuple(
            chunkss[sym] if sum(chunkss[sym]) == a.shape[dim] else a.chunks[dim]
            for dim, sym in enumerate(ind)
        )
        unified.append(rechunk(a, target) if target != a.chunks else a)
    return chunkss, unified


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
        if aggregate_func is not None:
            result = map_blocks(functools.partial(_apply_aggregate, aggregate_func=aggregate_func), result,
                                dtype=dtype)
    if not keepdims:
        from ..array_api.manipulation_functions import _squeeze_axes

        result = _squeeze_axes(result, axis)
    if dtype is not None and result.dtype != np.dtype(dtype):
        from ..array_api.data_type_functions import astype

        result = astype(result, dtype)
    return result


def _apply_aggregate(chunk, *, aggregate_func):
    return aggregate_func(chunk)


class _InitialReduce:
    """The per-block reduce of a reduction tree, over *axis* with every axis
    kept. With *fields* it returns one chunk per field of the {field: chunk}
    pytree, in that order. ``reduce_kind`` is *func*'s tag (``"sum"``,
    ``"mean"``), which the device executor's fusion rule reads;
    ``batchable`` is *func*'s (it runs under ``torch.func.vmap``), which its
    batched route reads."""

    def __init__(self, func: Callable, axis: tuple, kw: dict, fields: Optional[list] = None):
        self.func = func
        self.axis = axis
        self.kw = kw
        self.fields = fields
        self.reduce_kind = getattr(func, "reduce_kind", None)
        self.batchable = getattr(func, "batchable", False)

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
    agg_kernel.batchable = getattr(aggregate_func, "batchable", False)
    args = []
    for p in parts:
        args.extend([p, inds])
    return blockwise(agg_kernel, inds, *args, dtype=dtype)


def arg_reduction(x: CoreArray, func: Callable, cmp_func: Callable, axis=None, dtype=np.int64) -> CoreArray:
    """argmin/argmax along *axis* by an {i, v} tree reduction with absolute
    indices: two plain arrays (int64 indices and values) from multi-output
    ops. Each block's first index along *axis* is worked out from the
    block's linear offset, read as data, so the initial op batches."""
    if axis is None:
        raise ValueError("arg_reduction requires an axis (flatten first)")
    axis = int(axis) % x.ndim
    numblocks = x.numblocks
    stride = math.prod(numblocks[axis + 1:])
    step = x.chunksize[axis]  # regular chunks: block b starts at b * step
    offsets = _offsets_array_for(x)
    x_name, o_name = x.name, offsets.name
    out_chunks = tuple((1,) * numblocks[i] if i == axis else x.chunks[i] for i in range(x.ndim))
    shape = tuple(sum(c) for c in out_chunks)

    def block_function(out_key):
        coords = out_key[1:]
        return ((x_name, *coords), (o_name, *coords))

    def arg_initial(chunk, offset):
        if isinstance(offset, torch.Tensor):
            off = offset.reshape(-1)[0]
        else:
            off = _scalar_int(np.asarray(offset))
        start = (off // stride) % numblocks[axis] * step
        # the axis made innermost first: on the card torch reduces an outer
        # dim through a buffer of (value, index) pairs about four blocks in
        # size, past the task's projected memory; the copy is one block
        inner = chunk.movedim(axis, -1).contiguous()
        i = func(inner, axis=-1, keepdims=True).movedim(-1, axis)
        return i.to(torch.int64) + start, cmp_func(inner, axis=-1, keepdims=True).movedim(-1, axis)

    arg_initial.traced_offsets = True
    arg_initial.batchable = True

    fields = {"i": np.dtype(np.int64), "v": np.dtype(x.dtype)}
    parts = general_blockwise(
        arg_initial, block_function, x, offsets,
        shape=[shape, shape], dtype=[fields["i"], fields["v"]], chunks=out_chunks, op_name="arg_initial",
    )

    def arg_combine(d, axis=None, keepdims=True):
        ax = axis[0] if isinstance(axis, tuple) else axis
        local = func(d["v"], axis=ax, keepdims=True)
        return {"i": nxp.take_along_axis(d["i"], local, axis=ax), "v": cmp_func(d["v"], axis=ax, keepdims=True)}

    arg_combine.__name__ = "arg_combine"
    while parts[0].numblocks[axis] > 1:
        parts = partial_reduce_multi(
            parts, _StreamingCombineMulti(arg_combine, (axis,), {}, list(fields)),
            split_every={axis: 4}, fields=fields,
        )
    result = parts[0]
    if result.dtype != np.dtype(dtype):
        from ..array_api.data_type_functions import astype

        result = astype(result, dtype)
    from ..array_api.manipulation_functions import _squeeze_axes

    return _squeeze_axes(result, (axis,))
