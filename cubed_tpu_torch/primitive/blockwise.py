"""The blockwise primitive: apply a function to corresponding blocks of inputs,
producing one output block per task.

Counterpart of ``cubed_tpu/primitive/blockwise.py``. ``blockwise`` compiles
index notation into a *block function* mapping an output chunk key to the
input chunk keys it reads; ``general_blockwise`` wires read/write proxies,
computes the plan-time projected memory and raises if it exceeds
``allowed_mem``. Fusion composes block functions and chunk functions, so a
fused chain is one per-chunk function whose intermediates never reach storage.

Chunks are read from storage as numpy and cross to the chunk device as torch
tensors; results cross back to numpy to be written. Offsets chunks (block ids
and random seeds) are host metadata and stay numpy.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..backend_array_api import (
    backend_array_to_numpy_array,
    numpy_array_to_backend_array,
)
from ..chunks import blockdims_from_blockshape
from ..chunks import numblocks as chunks_to_numblocks
from ..observability.accounting import scope_span
from ..storage.virtual import VirtualOffsetsArray
from ..storage.zarr import lazy_empty
from ..utils import chunk_memory, gensym, get_item, memory_repr, to_chunksize
from .types import CubedArrayProxy, CubedPipeline, MemoryModeller, PrimitiveOperation


@dataclass
class BlockwiseSpec:
    """How to compute one output block of a blockwise op.

    ``block_function`` maps an output chunk key ``(name, i, j, ...)`` to a
    tuple with one entry per function argument: an input chunk key, a nested
    list of keys (contracted dims), or an iterator of keys (streaming reads
    for tree reductions). ``function`` consumes the chunks in that structure
    and returns the output chunk, or a tuple of chunks for a multi-output op
    (``writes_rest`` non-empty).
    """

    block_function: Callable[..., Any]
    function: Callable[..., Any]
    function_nargs: int
    num_input_blocks: tuple[int, ...]
    reads_map: Dict[str, CubedArrayProxy]
    write: CubedArrayProxy
    #: True when ``function`` commutes with chunking (elementwise and
    #: broadcasting kernels): applied to whole arrays it gives what it gives
    #: per chunk. The device executor then runs it once on whole resident
    #: arrays.
    shape_invariant: bool = False
    writes_rest: tuple = ()

    @property
    def writes(self) -> tuple:
        return (self.write, *self.writes_rest)


def get_chunk(arr, chunkset, block_idx: tuple[int, ...]):
    """Read one chunk of an opened array as a tensor on the chunk device."""
    chunk = arr[get_item(chunkset, block_idx)]
    if isinstance(arr, VirtualOffsetsArray):
        return chunk
    return numpy_array_to_backend_array(chunk)


def _read_keys(structure, config: BlockwiseSpec):
    """Resolve a (nested / lazy) structure of chunk keys into chunks; a fused
    predecessor's keys are read when it runs (:class:`_DeferredPredArgs`)."""
    if isinstance(structure, PredKeys):
        return _DeferredPredArgs(structure, config)
    if isinstance(structure, (list, tuple)) and not _is_key(structure):
        return [_read_keys(item, config) for item in structure]
    if isinstance(structure, Iterator):
        return (_read_keys(item, config) for item in structure)
    name, block_idx = structure[0], tuple(structure[1:])
    proxy = config.reads_map[name]
    arr = proxy.open()
    chunkset = blockdims_from_blockshape(arr.shape, proxy.chunks) if arr.shape else ()
    return get_chunk(arr, chunkset, block_idx)


def _is_key(obj) -> bool:
    return (
        isinstance(obj, tuple)
        and len(obj) >= 1
        and isinstance(obj[0], str)
        and all(isinstance(i, (int, np.integer)) for i in obj[1:])
    )


def apply_blockwise(out_key: tuple, *, config: BlockwiseSpec) -> None:
    """Task body: read input chunks, apply the (fused) function, write."""
    out_name, out_coords = out_key[0], tuple(out_key[1:])
    args = [_read_keys(entry, config) for entry in config.block_function(out_key)]
    # the function gets its own span (the storage spans are around it), so
    # a merged trace separates compute time from IO time per task
    with scope_span("kernel_apply", cat="kernel", op=out_name):
        if getattr(config.function, "needs_block_id", False):
            result = config.function(*args, block_id=out_coords)
        else:
            result = config.function(*args)
    if config.writes_rest:
        writes = config.writes
        if not isinstance(result, (tuple, list)) or len(result) != len(writes):
            raise ValueError(
                f"multi-output kernel must return {len(writes)} arrays, "
                f"got {type(result).__name__}"
            )
        for proxy, res in zip(writes, result):
            _write_chunk(proxy, out_coords, res)
    else:
        _write_chunk(config.write, out_coords, result)


def _write_chunk(write: CubedArrayProxy, out_coords: tuple, result) -> None:
    """Write one output chunk through a proxy (plain or structured dtype)."""
    target = write.open()
    chunkset = blockdims_from_blockshape(target.shape, write.chunks) if target.shape else ()
    out_sel = get_item(chunkset, out_coords) if target.shape else ()
    if isinstance(result, dict):
        fields = {k: backend_array_to_numpy_array(v) for k, v in result.items()}
        rec = np.empty(next(iter(fields.values())).shape, dtype=target.dtype)
        for k in target.dtype.names:
            rec[k] = fields[k]
        target[out_sel] = rec
    else:
        target[out_sel] = backend_array_to_numpy_array(result)


# ---------------------------------------------------------------------------
# Index-notation compiler
# ---------------------------------------------------------------------------


def make_blockwise_function(
    out_name: str,
    out_ind: Sequence,
    argpairs: Sequence[tuple[str, Sequence]],
    numblocks: Dict[str, tuple[int, ...]],
) -> Callable[[tuple], tuple]:
    """Compile index notation into a block function.

    Each argument gets the input key(s) whose coordinates match the output's
    by index symbol. Symbols in an argument but not in the output (contracted)
    expand to nested lists over all their blocks. An argument with a single
    block along a dim broadcasts (its coordinate clamps to 0).
    """
    dims: Dict[Any, int] = {}
    for name, ind in argpairs:
        if ind is None:
            continue
        for sym, nb in zip(ind, numblocks[name]):
            dims[sym] = max(dims.get(sym, nb), nb)
    for sym in out_ind:
        dims.setdefault(sym, 1)

    def block_function(out_key: tuple) -> tuple:
        out_coords = dict(zip(out_ind, out_key[1:]))
        entries = []
        for name, ind in argpairs:
            if ind is None:
                entries.append(None)
                continue
            contracted = list(dict.fromkeys(s for s in ind if s not in out_coords))

            def build(sym_values: Dict, rem: List):
                if not rem:
                    coords = []
                    for axis, s in enumerate(ind):
                        c = out_coords.get(s, sym_values.get(s, 0))
                        if numblocks[name][axis] == 1:
                            c = 0
                        coords.append(int(c))
                    return (name, *coords)
                sym = rem[0]
                return [build({**sym_values, sym: v}, rem[1:]) for v in range(dims[sym])]

            entries.append(build({}, contracted))
        return tuple(entries)

    return block_function


# ---------------------------------------------------------------------------
# Primitive constructors
# ---------------------------------------------------------------------------


def blockwise(
    func: Callable,
    out_ind: Sequence,
    *args: Any,  # pairs of (array, indices)
    allowed_mem: int,
    reserved_mem: int,
    target_store: str,
    shape: tuple[int, ...],
    dtype: Any,
    chunks: tuple,
    in_names: Optional[List[str]] = None,
    out_name: Optional[str] = None,
    extra_projected_mem: int = 0,
    fusable: bool = True,
    shape_invariant: bool = False,
    storage_options: Optional[dict] = None,
    **func_kwargs,
) -> PrimitiveOperation:
    """Apply *func* across blocks of inputs matched by index notation."""
    arrays = args[0::2]
    inds = args[1::2]
    if in_names is None:
        in_names = [f"in_{i}" for i in range(len(arrays))]
    numblocks = {
        name: chunks_to_numblocks(_array_chunkset(arr)) for name, arr in zip(in_names, arrays)
    }
    block_function = make_blockwise_function(
        out_name or "out", out_ind, list(zip(in_names, inds)), numblocks
    )
    if func_kwargs:

        def function(*chunk_args):
            return func(*chunk_args, **func_kwargs)

        function.__name__ = getattr(func, "__name__", "function")
        function.batchable = getattr(func, "batchable", False)
    else:
        function = func
    return general_blockwise(
        function,
        block_function,
        *arrays,
        allowed_mem=allowed_mem,
        reserved_mem=reserved_mem,
        target_store=target_store,
        shape=shape,
        dtype=dtype,
        chunks=chunks,
        in_names=in_names,
        out_name=out_name,
        extra_projected_mem=extra_projected_mem,
        fusable=fusable,
        shape_invariant=shape_invariant,
        storage_options=storage_options,
    )


def _array_chunkset(arr) -> tuple[tuple[int, ...], ...]:
    if hasattr(arr, "chunkset"):
        return arr.chunkset()
    chunks = arr.chunks
    if chunks and isinstance(chunks[0], tuple):
        return chunks
    return blockdims_from_blockshape(arr.shape, chunks)


def general_blockwise(
    function: Callable,
    block_function: Callable,
    *arrays: Any,
    allowed_mem: int,
    reserved_mem: int,
    target_store: Any,
    shape: Any,
    dtype: Any,
    chunks: tuple,
    in_names: Optional[List[str]] = None,
    out_name: Any = None,
    extra_projected_mem: int = 0,
    num_input_blocks: Optional[tuple[int, ...]] = None,
    fusable: bool = True,
    shape_invariant: bool = False,
    storage_options: Optional[dict] = None,
) -> PrimitiveOperation:
    """Build a PrimitiveOperation for an explicit block function.

    Multi-output: pass ``dtype``, ``shape``, ``target_store`` and ``out_name``
    as lists, one entry per output, all outputs on ONE block grid; ``function``
    then returns a tuple of arrays, and the op carries ``target_arrays``.
    Outputs may have chunk sizes of their own (``chunks`` a list of each
    output's normalized chunks) as long as their block grids agree: TSQR's
    panel op writes Q blocks ``(c, n)`` and R blocks ``(n, n)`` on one
    ``(b, 1)`` grid.
    """
    multi = isinstance(dtype, (list, tuple))
    if multi:
        n_out = len(dtype)
        if not (isinstance(shape, (list, tuple)) and shape and isinstance(shape[0], (list, tuple))):
            raise TypeError("multi-output general_blockwise requires a list of per-output shapes")
        if not isinstance(target_store, (list, tuple)) or not isinstance(out_name, (list, tuple)):
            raise TypeError("multi-output general_blockwise requires list-valued target_store and out_name")
        shapes = [tuple(s) for s in shape]
        stores = list(target_store)
        out_names = list(out_name)
        dtypes = list(dtype)
        if not (len(shapes) == len(stores) == len(out_names) == n_out):
            raise ValueError("multi-output lists must have equal length")
        if isinstance(chunks, list):  # per-output chunks
            if len(chunks) != n_out:
                raise ValueError("per-output chunks list must have one entry per output")
            chunks_list = [tuple(c) for c in chunks]
        else:
            chunks_list = [chunks] * n_out
        chunksizes = [to_chunksize(c) if s else () for c, s in zip(chunks_list, shapes)]
        nbs = {
            chunks_to_numblocks(blockdims_from_blockshape(s, cs))
            for s, cs in zip(shapes, chunksizes)
        }
        if len(nbs) != 1:
            raise ValueError(f"multi-output arrays must share one block grid; got {sorted(nbs)}")
        chunks = chunks_list[0]  # output 0 defines the mappable grid
    else:
        shapes = [tuple(shape)]
        stores = [target_store]
        out_names = [out_name or gensym("array")]
        dtypes = [dtype]
        chunksizes = [to_chunksize(chunks) if shapes[0] else ()]
    if in_names is None:
        in_names = [f"in_{i}" for i in range(len(arrays))]

    target_arrays = [
        lazy_empty(s, dtype=dt, chunks=cs, store=st, storage_options=storage_options)
        for s, dt, cs, st in zip(shapes, dtypes, chunksizes, stores)
    ]
    reads_map = {
        name: CubedArrayProxy(arr, _proxy_chunks(arr)) for name, arr in zip(in_names, arrays)
    }
    writes = [CubedArrayProxy(t, cs) for t, cs in zip(target_arrays, chunksizes)]

    # plan-time memory bound: each input chunk counts twice (storage buffer +
    # device array) and each output twice (device result + write buffer),
    # exactly as the JAX package counts it
    projected_mem = reserved_mem + extra_projected_mem
    for name, arr in zip(in_names, arrays):
        projected_mem += 2 * chunk_memory(arr.dtype, reads_map[name].chunks)
    for dt, cs in zip(dtypes, chunksizes):
        projected_mem += 2 * chunk_memory(dt, cs)
    if projected_mem > allowed_mem:
        raise ValueError(
            f"Projected blockwise memory ({memory_repr(projected_mem)}) exceeds "
            f"allowed_mem ({memory_repr(allowed_mem)}), including "
            f"reserved_mem ({memory_repr(reserved_mem)})"
        )

    nb_out = chunks_to_numblocks(chunks)
    mappable = [(out_names[0], *idx) for idx in itertools.product(*(range(n) for n in nb_out))]
    if not mappable:
        mappable = [(out_names[0],)]

    spec = BlockwiseSpec(
        block_function=block_function,
        function=function,
        function_nargs=len(arrays),
        num_input_blocks=num_input_blocks or (1,) * len(arrays),
        reads_map=reads_map,
        write=writes[0],
        shape_invariant=shape_invariant,
        writes_rest=tuple(writes[1:]),
    )
    return PrimitiveOperation(
        pipeline=CubedPipeline(apply_blockwise, gensym("blockwise"), mappable, spec),
        source_array_names=list(in_names),
        target_array=target_arrays[0],
        projected_mem=projected_mem,
        allowed_mem=allowed_mem,
        reserved_mem=reserved_mem,
        num_tasks=len(mappable),
        fusable=fusable,
        write_chunks=chunksizes[0],
        target_arrays=target_arrays if multi else None,
    )


def _proxy_chunks(arr) -> tuple[int, ...]:
    chunks = arr.chunks
    if chunks and isinstance(chunks[0], tuple):
        return to_chunksize(chunks)
    return tuple(chunks)


# ---------------------------------------------------------------------------
# Fusion
# ---------------------------------------------------------------------------


class PredKeys(list):
    """The key structure of a fused predecessor's argument list."""


class PredArgs(list):
    """The resolved-chunk counterpart of :class:`PredKeys`."""


class _DeferredPredArgs(PredArgs):
    """A fused predecessor's chunk keys in a task body, read only when the
    predecessor runs (:func:`_evaluate`), so a fused task holds one
    predecessor's inputs at a time: the sort network's fused rounds call a
    predecessor once for a block and once for its partner, which the plan's
    memory model counts once."""

    def __init__(self, structure, config: BlockwiseSpec):
        super().__init__()
        self.structure = structure
        self.config = config

    def read(self) -> PredArgs:
        return PredArgs([_read_keys(item, self.config) for item in self.structure])


def is_fuse_candidate(op: PrimitiveOperation) -> bool:
    """An op is fusable iff its task body is ``apply_blockwise``."""
    return op.pipeline.function is apply_blockwise


def can_fuse_pipelines(op1: PrimitiveOperation, op2: PrimitiveOperation) -> bool:
    if op1.target_arrays is not None:
        # a multi-output predecessor's other outputs still need writing
        return False
    if is_fuse_candidate(op1) and is_fuse_candidate(op2):
        return op1.fusable and op2.fusable and op1.num_tasks == op2.num_tasks
    return False


def _substitute(entry, pred_spec: BlockwiseSpec):
    """Replace every chunk key in *entry* with the predecessor's key structure."""
    if isinstance(entry, list):
        return [_substitute(e, pred_spec) for e in entry]
    if isinstance(entry, Iterator):
        return (_substitute(e, pred_spec) for e in entry)
    return PredKeys(pred_spec.block_function(entry))


def _evaluate(arg, pred_function: Callable):
    """Apply the predecessor function wherever reads were substituted."""
    if isinstance(arg, _DeferredPredArgs):
        return pred_function(*arg.read())
    if isinstance(arg, PredArgs):
        return pred_function(*arg)
    if isinstance(arg, list):
        return [_evaluate(a, pred_function) for a in arg]
    if isinstance(arg, Iterator):
        return (_evaluate(a, pred_function) for a in arg)
    return arg


def fuse_multiple(
    op: PrimitiveOperation,
    *predecessor_ops: Optional[PrimitiveOperation],
) -> PrimitiveOperation:
    """Fuse *op* with any subset of its argument-producing predecessors:
    ``predecessor_ops[i]`` produces op's i-th argument, or is None."""
    spec: BlockwiseSpec = op.pipeline.config
    preds = list(predecessor_ops) + [None] * (spec.function_nargs - len(predecessor_ops))
    pred_specs = [p.pipeline.config if p is not None else None for p in preds]
    pred_functions = [ps.function if ps is not None else None for ps in pred_specs]

    def fused_block_function(out_key):
        structure = spec.block_function(out_key)
        return tuple(
            entry if pspec is None else _substitute(entry, pspec)
            for entry, pspec in zip(structure, pred_specs)
        )

    def fused_function(*args, **kw):
        evaluated = [
            arg if pf is None else _evaluate(arg, pf)
            for arg, pf in zip(args, pred_functions)
        ]
        return spec.function(*evaluated, **kw)

    # the fused expression, kept as plan metadata: the op's own function and,
    # per argument, the fused predecessor's function (None for a plain read)
    fused_function.root_function = spec.function
    fused_function.arg_functions = tuple(pred_functions)
    # executor routing hints survive fusion: a fused kernel is host-bound if
    # any component is
    components = [spec.function] + [pf for pf in pred_functions if pf is not None]
    fused_function.host_block_id = any(getattr(f, "host_block_id", False) for f in components)
    fused_function.host_data_nbytes = sum(getattr(f, "host_data_nbytes", 0) for f in components)
    # every offsets-reading kernel carries host_block_id or traced_offsets
    fused_function.traced_offsets = (
        any(getattr(f, "traced_offsets", False) for f in components) and not fused_function.host_block_id
    )
    if getattr(spec.function, "needs_block_id", False):
        fused_function.needs_block_id = True

    # reads: the op's unfused reads plus every fused predecessor's reads
    fused_outputs = {id(p.target_array) for p in preds if p is not None}
    reads_map: Dict[str, CubedArrayProxy] = {}
    source_names: list[str] = []
    for name, proxy in spec.reads_map.items():
        if id(proxy.array) not in fused_outputs:
            reads_map[name] = proxy
            source_names.append(name)
    seen_preds = set()
    num_input_blocks: list[int] = []
    for i, (p, pspec) in enumerate(zip(preds, pred_specs)):
        if pspec is None:
            if i < len(spec.num_input_blocks):
                num_input_blocks.append(spec.num_input_blocks[i])
            continue
        if id(p) in seen_preds:
            continue
        seen_preds.add(id(p))
        reads_map.update(pspec.reads_map)
        source_names.extend(p.source_array_names)
        nib = spec.num_input_blocks[i] if i < len(spec.num_input_blocks) else 1
        num_input_blocks.extend(n * nib for n in pspec.num_input_blocks)

    # memory model: predecessors run one after another inside the fused task,
    # each leaving its output chunk live until the consuming function runs
    modeller = MemoryModeller()
    unique_preds = list({id(p): p for p in preds if p is not None}.values())
    for p in unique_preds:
        working = p.projected_mem - p.reserved_mem
        retained = 2 * chunk_memory(p.target_array.dtype, p.write_chunks or ())
        modeller.allocate(working)
        modeller.free(working - retained)
    modeller.allocate(op.projected_mem - op.reserved_mem)
    projected_mem = op.reserved_mem + modeller.peak_mem

    fused_spec = BlockwiseSpec(
        block_function=fused_block_function,
        function=fused_function,
        function_nargs=spec.function_nargs,
        num_input_blocks=tuple(num_input_blocks) or spec.num_input_blocks,
        reads_map=reads_map,
        write=spec.write,
        shape_invariant=spec.shape_invariant
        and all(ps is None or ps.shape_invariant for ps in pred_specs),
        writes_rest=spec.writes_rest,
    )
    return PrimitiveOperation(
        pipeline=CubedPipeline(apply_blockwise, gensym("fused"), op.pipeline.mappable, fused_spec),
        source_array_names=source_names,
        target_array=op.target_array,
        projected_mem=projected_mem,
        allowed_mem=op.allowed_mem,
        reserved_mem=op.reserved_mem,
        num_tasks=op.num_tasks,
        fusable=True,
        write_chunks=op.write_chunks,
        target_arrays=op.target_arrays,
    )
