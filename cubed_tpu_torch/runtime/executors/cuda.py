"""The device executor: the plan's arrays stay resident on the card.

Counterpart of ``cubed_tpu/runtime/executors/jax.py:JaxExecutor``:

- **Residency.** Every op's output is kept as one whole tensor on the chunk
  device (``backend_array_api.get_device()``), keyed by its target store.
  Zarr is touched only at the edges of the plan: storage sources are read
  once, and only the requested outputs are written, at the end.
- **Whole-array path.** A shape-invariant op whose block mapping is 1:1 (with
  broadcasting) runs once on the whole resident inputs.
- **Batched path.** An op whose function names a ``batched`` form (block
  generation: ``random``) and reads only its virtual template and its seeds
  is computed whole by that form: the output is allocated once and every
  block is written in place by one kernel launch (``batched_ops``). Fused
  functions do not inherit the hint, so a random op fused into its consumer
  (addsum) stays on the chunked path, one launch per block.
- **Resident map_direct.** An index (``whole_select``) is a view of its
  resident source, a positive-step slice never copies; ``resident_identity``
  passes the value through and ``whole_concat`` concatenates on the device.
- **Chunked path.** Any other op runs per output block on block views of its
  resident inputs; a combine over a dense region of resident blocks runs as
  one call (``combine_region``). Blocks are copied into one output tensor as
  they come.
- **The fusion rule.** An initial ``sum`` or ``mean`` reduction fused with
  ``add(multiply(p, q), multiply(r, s))`` over plain reads goes, block by
  block, through the hand-written ``fma_sum`` kernel: the counterpart of what
  XLA makes of that fused segment under ``jax.jit``, where torch's eager ops
  would launch three elementwise kernels and write two temporaries per block.
  It is decided once per op from plan metadata, never from values.
- **Spill.** When residency would pass ``device_mem``, the least recently
  used arrays are written to their Zarr targets and dropped; their readers
  then read storage.

Ops are grouped into segments as the reference groups them for tracing, and a
segment runs op by op on resident tensors, as the reference's untraced branch
does. Not ported yet: batched dispatch of any other op (the reference vmaps
every uniform-grid op; here the fused reduction and the combines still run
block by block), segment tracing (to become CUDA-graph replay), rechunk,
meshes, ``compute_dtype`` and resume. No fast path is
wrapped in an ``except``: where one cannot run, a check says so, the op takes
the chunked path and ``eager_fallbacks`` counts it.
"""

from __future__ import annotations

import functools
import itertools
import math
import time
from collections import Counter
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ...backend_array_api import (
    backend_array_to_numpy_array,
    get_device,
    numpy_array_to_backend_array,
    to_torch_dtype,
)
from ...chunks import blockdims_from_blockshape
from ...core.ops import _InitialReduce
from ...core.plan import create_zarr_array
from ...kernels.fma_sum import fma_sum
from ...primitive.blockwise import BlockwiseSpec, PredArgs, PredKeys, _is_key, apply_blockwise, get_chunk
from ...storage.store import ZarrV2Array
from ...storage.virtual import VirtualEmptyArray, VirtualInMemoryArray, VirtualOffsetsArray
from ...storage.zarr import LazyZarrArray
from ...utils import convert_to_bytes, get_item
from ..pipeline import visit_nodes
from ..types import (
    DagExecutor,
    OperationEndEvent,
    OperationStartEvent,
    TaskEndEvent,
    callbacks_on,
)
from ..utils import fire_task_start

#: residency budget on a device that reports no memory size (the reference's)
_CPU_BUDGET = 8 * 2**30

#: a kernel closing over more host data than this runs outside segments
_HOST_DATA_LIMIT = 2**18

#: orders residents by last use (a clock could tie)
_use_clock = itertools.count()


class _Resident:
    """A resident array and its bookkeeping."""

    __slots__ = ("value", "nbytes", "last_used", "target")

    def __init__(self, value: torch.Tensor, nbytes: int, target):
        self.value = value
        self.nbytes = nbytes
        self.target = target
        self.touch()

    def touch(self) -> None:
        self.last_used = next(_use_clock)


def _value_nbytes(value: torch.Tensor) -> int:
    return value.numel() * value.element_size()


def _key(arr) -> str:
    return str(getattr(arr, "store", id(arr)))


@functools.lru_cache(maxsize=1024)
def _chunkset(shape: tuple, chunks: tuple) -> tuple:
    return blockdims_from_blockshape(shape, chunks) if shape else ()


def _carrier(shape, dtype) -> torch.Tensor:
    """A virtual empty block: one zero expanded with stride 0."""
    return torch.zeros((), dtype=to_torch_dtype(dtype), device=get_device()).expand(tuple(shape))


def _as_tensor(value) -> torch.Tensor:
    """A task body's result on the chunk device (an index task body reads
    storage and returns numpy)."""
    return numpy_array_to_backend_array(value) if isinstance(value, np.ndarray) else value


class CudaExecutor(DagExecutor):
    """Runs the plan with its arrays resident on the chunk device.

    Parameters
    ----------
    device_mem : int | str | None
        Residency budget in bytes. Default: the spec's ``device_mem``, else
        75% of the card's memory (8 GiB when the chunk device is the CPU).
    """

    def __init__(self, device_mem=None):
        self.device_mem = convert_to_bytes(device_mem)
        #: path counters of the last ``execute_dag``, under the reference's
        #: names: ``whole_array_hits``, ``whole_concat_hits``,
        #: ``batched_ops``, ``chunked_ops``, ``eager_ops`` and the failed
        #: checks ``whole_array_errors``, ``whole_select_errors``,
        #: ``batched_errors`` and ``eager_fallbacks`` (0 on the main path)
        self.stats: Counter = Counter()

    @property
    def name(self) -> str:
        return "cuda"

    def _budget(self, spec, dev: torch.device) -> int:
        if self.device_mem is not None:
            return self.device_mem
        if spec is not None and spec.device_mem is not None:
            return spec.device_mem
        if dev.type == "cuda":
            return int(torch.cuda.get_device_properties(dev).total_memory * 0.75)
        return _CPU_BUDGET

    def execute_dag(self, dag, callbacks=None, array_names=None, resume=None, spec=None, **kwargs) -> None:
        dev = get_device()
        self.stats = Counter()
        resident: Dict[str, _Resident] = {}
        budget = self._budget(spec, dev)
        requested = {
            d["target"].store
            for name, d in dag.nodes.items()
            if d.get("type") == "array"
            and isinstance(d.get("target"), (LazyZarrArray, ZarrV2Array))
            and (array_names is None or name in array_names)
        }
        segment: list = []
        for name, node in visit_nodes(dag, resume=resume):
            if self._classify(node["primitive_op"]) == "segment":
                segment.append((name, node))
                continue
            self._run(segment, resident, budget, requested, callbacks, in_segment=True)
            segment = []
            self.stats["eager_ops"] += 1
            self._run([(name, node)], resident, budget, requested, callbacks, in_segment=False)
        self._run(segment, resident, budget, requested, callbacks, in_segment=True)
        for store, res in list(resident.items()):
            if store in requested:
                self._flush(res)

    def _classify(self, primitive_op) -> str:
        """'segment' if the op computes from resident inputs alone, so it may
        join a segment; 'eager' otherwise. From plan metadata only."""
        pipeline = primitive_op.pipeline
        if pipeline.function is not apply_blockwise:
            return "eager"  # create-arrays: host metadata
        f = pipeline.config.function
        if getattr(f, "host_data_nbytes", 0) > _HOST_DATA_LIMIT:
            return "eager"  # a large from_array source
        side_inputs = getattr(f, "side_inputs", None)
        if side_inputs and not (
            (
                len(side_inputs) == 1
                and (getattr(f, "resident_identity", False) or getattr(f, "whole_select", None) is not None)
            )
            or getattr(f, "whole_concat", None) is not None
        ):
            return "eager"  # a map_direct whose task body reads storage
        return "segment"

    def _run(self, ops, resident, budget, requested, callbacks, in_segment: bool) -> None:
        """Run *ops* in order; their wall time is apportioned by task count."""
        if not ops:
            return
        t0 = time.time()
        for name, node in ops:
            num_tasks = node["primitive_op"].num_tasks
            callbacks_on(callbacks, "on_operation_start", OperationStartEvent(name, num_tasks))
            fire_task_start(callbacks, name, num_tasks=num_tasks)
        if in_segment:
            for arr in self._segment_sources(ops):
                self._preload(arr, resident, budget)
        for _, node in ops:
            op = node["primitive_op"]
            if op.pipeline.function is apply_blockwise:
                self._exec_blockwise(op, resident, budget)
            elif op.pipeline.function is create_zarr_array:
                # metadata only for arrays that are written; residency
                # replaces the rest
                for lazy in op.pipeline.mappable:
                    if lazy.store in requested:
                        lazy.create()
            else:
                for m in op.pipeline.mappable:
                    op.pipeline.function(m, config=op.pipeline.config)
        elapsed = time.time() - t0
        total_tasks = sum(node["primitive_op"].num_tasks for _, node in ops) or 1
        start = t0
        for name, node in ops:
            num_tasks = node["primitive_op"].num_tasks
            end = start + elapsed * (num_tasks / total_tasks)
            callbacks_on(callbacks, "on_task_end", TaskEndEvent(
                array_name=name, num_tasks=num_tasks, task_create_tstamp=start,
                function_start_tstamp=start, function_end_tstamp=end,
                task_result_tstamp=end, executor=self.name,
            ))
            callbacks_on(callbacks, "on_operation_end", OperationEndEvent(name, num_tasks))
            start = end

    def _segment_sources(self, ops) -> list:
        """The storage arrays the segment reads and does not itself produce."""
        produced = set()
        for _, node in ops:
            produced.update(_key(w.array) for w in node["primitive_op"].pipeline.config.writes)
        seen, sources = set(), []
        for _, node in ops:
            spec = node["primitive_op"].pipeline.config
            arrays = [p.array for p in spec.reads_map.values()]
            arrays += list(getattr(spec.function, "side_inputs", None) or [])
            for arr in arrays:
                key = _key(arr)
                if key in seen or key in produced or not isinstance(arr, (ZarrV2Array, LazyZarrArray)):
                    continue
                seen.add(key)
                sources.append(arr)
        return sources

    def _preload(self, arr, resident, budget) -> bool:
        """Read a whole storage array onto the device, if it exists, fits and
        is a plain (not structured) array."""
        key = _key(arr)
        if key in resident:
            return True
        try:
            concrete = arr.open() if isinstance(arr, LazyZarrArray) else arr
        except FileNotFoundError:
            return False
        if concrete.dtype.fields is not None or math.prod(concrete.shape) * concrete.dtype.itemsize > budget:
            return False
        data = concrete[...] if concrete.shape else concrete[()]
        self._admit(resident, key, numpy_array_to_backend_array(data), arr, budget)
        return True

    # ------------------------------------------------------------------

    def _exec_blockwise(self, op, resident, budget: int) -> None:
        spec: BlockwiseSpec = op.pipeline.config
        target = spec.write.array
        out_shape = tuple(target.shape)
        f = spec.function
        side_inputs = getattr(f, "side_inputs", None)
        if side_inputs:
            value = self._exec_resident_map_direct(f, side_inputs, resident, out_shape)
            if value is not None:
                self._admit(resident, _key(target), value, target, budget)
                return
            # the task body reads its side inputs from storage
            for arr in side_inputs:
                res = resident.get(_key(arr))
                if res is not None:
                    self._flush(res)

        value = None
        if spec.shape_invariant and not spec.writes_rest and not getattr(f, "needs_block_id", False):
            value = self._exec_whole(op, spec, resident, out_shape)
        if value is None and getattr(f, "batched", None) is not None and not getattr(f, "needs_block_id", False):
            value = self._exec_batched(op, spec, budget)
            if value is not None:
                self.stats["batched_ops"] += 1
        if value is None:
            value = self._exec_chunked(op, spec, resident)
            self.stats["chunked_ops"] += 1

        values = value if spec.writes_rest else (value,)
        for proxy, v in zip(spec.writes, values):
            t = proxy.array
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(
                    f"op produced shape {tuple(v.shape)}, target expects {tuple(t.shape)} "
                    "(kernel/block-function contract violation)"
                )
            self._admit(resident, _key(t), v, t, budget)

    def _exec_resident_map_direct(self, f, side_inputs, resident, out_shape) -> Optional[torch.Tensor]:
        """A map_direct op computed from its resident side inputs, or None."""
        wc_axis = getattr(f, "whole_concat", None)
        if wc_axis is not None:
            vals = [self._whole_value(arr, resident) for arr in side_inputs]
            if all(v is not None for v in vals):
                value = vals[0] if len(vals) == 1 else torch.cat(vals, dim=wc_axis)
                if tuple(value.shape) == out_shape:
                    self.stats["whole_concat_hits"] += 1
                    return value
        if len(side_inputs) != 1:
            return None
        res = resident.get(_key(side_inputs[0]))
        if res is None:
            return None
        if getattr(f, "resident_identity", False):
            res.touch()
            return res.value
        ws = getattr(f, "whole_select", None)
        if ws is None:
            return None
        value = self._apply_whole_select(res.value, ws)
        if value is None or tuple(value.shape) != out_shape:
            self.stats["whole_select_errors"] += 1
            self.stats["eager_fallbacks"] += 1
            return None
        res.touch()
        return value

    @staticmethod
    def _apply_whole_select(value: torch.Tensor, selections) -> Optional[torch.Tensor]:
        """Per-axis (start, stop, step) selections with positive steps as one
        view of *value*; None for any other selection."""
        if len(selections) != value.ndim or not all(
            isinstance(s, tuple) and len(s) == 3 and s[2] > 0 for s in selections
        ):
            return None
        return value[tuple(slice(*s) for s in selections)]

    def _whole_value(self, arr, resident) -> Optional[torch.Tensor]:
        """*arr* whole on the device, when it is resident or virtual."""
        res = resident.get(_key(arr))
        if res is not None:
            res.touch()
            return res.value
        if isinstance(arr, VirtualEmptyArray):
            return _carrier(arr.shape, arr.dtype)
        if isinstance(arr, VirtualInMemoryArray):
            return numpy_array_to_backend_array(arr.array)
        return None

    def _exec_whole(self, op, spec: BlockwiseSpec, resident, out_shape) -> Optional[torch.Tensor]:
        """The op's function applied once to its whole inputs, or None."""
        mapping = self._probe_one_to_one(spec, op)
        if mapping is None:
            return None
        inputs = self._whole_inputs(spec, resident)
        if inputs is None:
            return None
        value = spec.function(*[inputs[n] for n in mapping])
        if tuple(value.shape) != out_shape:
            self.stats["whole_array_errors"] += 1
            self.stats["eager_fallbacks"] += 1
            return None
        self.stats["whole_array_hits"] += 1
        return value

    def _whole_inputs(self, spec: BlockwiseSpec, resident) -> Optional[Dict[str, torch.Tensor]]:
        """Whole arrays for every input, from residency, virtual arrays or storage."""
        out = {}
        for name, proxy in spec.reads_map.items():
            arr = proxy.array
            value = self._whole_value(arr, resident)
            if value is None and isinstance(arr, (ZarrV2Array, LazyZarrArray)):
                try:
                    concrete = arr.open() if isinstance(arr, LazyZarrArray) else arr
                except FileNotFoundError:
                    return None
                value = numpy_array_to_backend_array(concrete[...] if concrete.shape else concrete[()])
            if value is None:
                return None  # block-id offsets have no whole-array meaning
            out[name] = value
        return out

    @staticmethod
    def _probe_one_to_one(spec: BlockwiseSpec, op) -> Optional[list[str]]:
        """The per-argument input names, when the block mapping is 1:1 (an
        input coordinate equals the output's, or is 0 on a broadcast axis)."""
        keys = list(itertools.islice(iter(op.pipeline.mappable), 0, 3))
        if not keys:
            return None
        names: Optional[list[str]] = None
        for out_key in keys:
            out_coords = out_key[1:]
            cur = []
            for entry in spec.block_function(out_key):
                if not (isinstance(entry, tuple) and entry and isinstance(entry[0], str)):
                    return None  # fused, contracted or streamed: not 1:1
                name, coords = entry[0], entry[1:]
                proxy = spec.reads_map.get(name)
                if proxy is None:
                    return None
                nb = tuple(len(c) for c in _chunkset(tuple(proxy.array.shape), proxy.chunks))
                oc = out_coords[len(out_coords) - len(coords):]
                for c, o, n in zip(coords, oc, nb):
                    if c != o and not (c == 0 and n == 1):
                        return None
                cur.append(name)
            if names is None:
                names = cur
            elif names != cur:
                return None
        return names

    # ------------------------------------------------------------------

    def _exec_batched(self, op, spec: BlockwiseSpec, budget: int) -> Optional[torch.Tensor]:
        """Every block of the op at once, by its function's ``batched`` form,
        or None. Taken, as the reference batches, for a grid of more than one
        block, when the op reads exactly a virtual empty template of its
        output's shape and the offsets array of its block grid (the seeds),
        both at the output block's coordinates, and the output fits the
        batched form and the residency budget. A failed check counts
        ``batched_errors`` and ``eager_fallbacks``; the op then runs chunked."""
        batched = spec.function.batched
        target = spec.write.array
        out_shape = tuple(target.shape)
        chunks = tuple(spec.write.chunks)
        chunkset = _chunkset(out_shape, chunks)
        if not out_shape or math.prod(len(c) for c in chunkset) <= 1:
            return None
        reads = spec.reads_map.items()
        templates = [(name, p.array) for name, p in reads if isinstance(p.array, VirtualEmptyArray)]
        seeds = [(name, p.array) for name, p in reads if isinstance(p.array, VirtualOffsetsArray)]
        first = next(iter(op.pipeline.mappable))
        coords = tuple(first[1:])
        if not (
            len(spec.reads_map) == 2 and len(templates) == len(seeds) == 1
            and tuple(templates[0][1].shape) == out_shape
            and tuple(seeds[0][1].shape) == tuple(len(c) for c in chunkset)
            and tuple(spec.block_function(first)) == ((templates[0][0], *coords), (seeds[0][0], *coords))
            and batched.fits(out_shape)
            and math.prod(out_shape) * np.dtype(target.dtype).itemsize <= budget
        ):
            self.stats["batched_errors"] += 1
            self.stats["eager_fallbacks"] += 1
            return None
        return batched(out_shape, chunks, seeds[0][1].base, get_device())

    def _exec_chunked(self, op, spec: BlockwiseSpec, resident):
        """Per-output-block execution on block views of resident inputs."""
        f = spec.function
        needs_block_id = getattr(f, "needs_block_id", False)
        region_fn = getattr(f, "combine_region", None)
        fma_block = self._fma_route(op)
        writes = spec.writes
        chunksets = [_chunkset(tuple(w.array.shape), w.chunks) for w in writes]
        single_block = math.prod(len(c) for c in chunksets[0]) == 1
        outs: list = [None] * len(writes)
        for out_key in op.pipeline.mappable:
            coords = tuple(out_key[1:])
            structure = spec.block_function(out_key)
            result = None
            if region_fn is not None and structure and all(isinstance(e, Iterator) for e in structure):
                # one contiguous region per argument, combined in one call
                keyss = [list(e) for e in structure]
                regions = [self._resolve_region(keys, spec, resident) for keys in keyss]
                if all(r is not None for r in regions):
                    result = region_fn(*regions)
                else:
                    structure = tuple(iter(keys) for keys in keyss)
            if result is None and fma_block is not None:
                result = fma_block(structure, resident)
            if result is None:
                args = [self._resolve(entry, spec, resident) for entry in structure]
                result = f(*args, block_id=coords) if needs_block_id else f(*args)
            results = result if spec.writes_rest else (result,)
            for j, (w, chunkset, v) in enumerate(zip(writes, chunksets, results)):
                v = _as_tensor(v)
                if single_block:
                    outs[j] = v
                    continue
                if outs[j] is None:
                    outs[j] = torch.empty(tuple(w.array.shape), dtype=v.dtype, device=v.device)
                outs[j][get_item(chunkset, coords)] = v
        return tuple(outs) if spec.writes_rest else outs[0]

    def _resolve_region(self, keys, spec: BlockwiseSpec, resident) -> Optional[torch.Tensor]:
        """The view of one resident array covering a dense group of its
        blocks, or None."""
        if not keys or len({k[0] for k in keys}) != 1:
            return None
        proxy = spec.reads_map.get(keys[0][0])
        if proxy is None:
            return None
        arr = proxy.array
        res = resident.get(_key(arr))
        if res is None or not arr.shape:
            return None
        res.touch()
        chunkset = _chunkset(tuple(arr.shape), proxy.chunks)
        coords = [tuple(k[1:]) for k in keys]
        ndim = len(arr.shape)
        los = [min(c[d] for c in coords) for d in range(ndim)]
        his = [max(c[d] for c in coords) for d in range(ndim)]
        if len(coords) != math.prod(h - lo + 1 for lo, h in zip(los, his)):
            return None  # not the full dense block range
        return res.value[tuple(
            slice(sum(chunkset[d][: los[d]]), sum(chunkset[d][: his[d] + 1])) for d in range(ndim)
        )]

    def _resolve(self, entry, spec: BlockwiseSpec, resident):
        """Resolve a key structure to blocks: views of resident arrays,
        virtual blocks made on the device, or chunks read from storage."""
        if isinstance(entry, PredKeys):
            return PredArgs([self._resolve(e, spec, resident) for e in entry])
        if isinstance(entry, (list, tuple)) and not _is_key(entry):
            return [self._resolve(e, spec, resident) for e in entry]
        if isinstance(entry, Iterator):
            return (self._resolve(e, spec, resident) for e in entry)
        name, coords = entry[0], tuple(entry[1:])
        proxy = spec.reads_map[name]
        arr = proxy.array
        chunkset = _chunkset(tuple(arr.shape), proxy.chunks)
        sel = get_item(chunkset, coords) if arr.shape else ()
        res = resident.get(_key(arr))
        if res is not None:
            res.touch()
            return res.value[sel]
        if isinstance(arr, VirtualEmptyArray):
            return _carrier(tuple(s.stop - s.start for s in sel), arr.dtype)
        if isinstance(arr, VirtualOffsetsArray):
            return np.asarray(arr[sel])  # host metadata: seeds and block ids
        opened = proxy.open()
        return get_chunk(opened, _chunkset(tuple(opened.shape), proxy.chunks), coords)

    # ------------------------------------------------------------------
    # the fusion rule: a fused multiply-add reduction goes to fma_sum
    # ------------------------------------------------------------------

    def _fma_route(self, op):
        """For an initial ``sum``/``mean`` over every axis of
        ``add(multiply(p, q), multiply(r, s))``, with p, q, r, s plain reads
        of one float dtype and one chunking, a function computing one block's
        result with ``fma_sum``; None for any other op."""
        spec: BlockwiseSpec = op.pipeline.config
        root = getattr(spec.function, "root_function", None)
        if not isinstance(root, _InitialReduce) or root.reduce_kind not in ("sum", "mean"):
            return None
        if root.reduce_kind == "mean" and sorted(root.fields or ()) != ["n", "total"]:
            return None
        (add_f,) = spec.function.arg_functions
        if getattr(getattr(add_f, "root_function", None), "elementwise", None) != "add":
            return None
        if [getattr(m, "elementwise", None) for m in add_f.arg_functions] != ["multiply", "multiply"]:
            return None
        mappable = iter(op.pipeline.mappable)
        structure = spec.block_function(next(mappable))
        if not (
            len(structure) == 1
            and isinstance(structure[0], PredKeys)
            and len(structure[0]) == 2
            and all(isinstance(m, PredKeys) and len(m) == 2 for m in structure[0])
            and all(_is_key(k) for m in structure[0] for k in m)
        ):
            return None
        proxies = [spec.reads_map[k[0]] for m in structure[0] for k in m]
        arrays = [p.array for p in proxies]
        if not (
            arrays[0].dtype in (np.dtype(np.float64), np.dtype(np.float32))
            and all(a.dtype == arrays[0].dtype and tuple(a.shape) == tuple(arrays[0].shape) for a in arrays)
            and all(p.chunks == proxies[0].chunks for p in proxies)
            and 0 < len(arrays[0].shape) <= 4
            and sorted(root.axis) == list(range(len(arrays[0].shape)))
        ):
            return None
        out_dtype = to_torch_dtype(spec.write.array.dtype)

        def fma_block(structure, resident):
            p, q, r, s = [self._resolve(k, spec, resident) for m in structure[0] for k in m]
            total = fma_sum(p, q, r, s)
            if root.reduce_kind == "sum":
                return total.to(out_dtype)
            fields = {"n": torch.full(total.shape, p.numel(), dtype=torch.int64, device=total.device),
                      "total": total}
            return tuple(fields[k] for k in root.fields)

        return fma_block

    # ------------------------------------------------------------------
    # residency bookkeeping
    # ------------------------------------------------------------------

    def _admit(self, resident, store: str, value: torch.Tensor, target, budget: int) -> None:
        """Make *value* the resident array of *store* (in the target's dtype,
        as a store write would), spilling others to stay in *budget*."""
        dtype = to_torch_dtype(target.dtype)
        if value.dtype != dtype:
            value = value.to(dtype)
        nbytes = _value_nbytes(value)
        self._evict(resident, budget - nbytes, exclude=store)
        resident[store] = _Resident(value, nbytes, target)

    def _evict(self, resident, budget: int, exclude: Optional[str] = None) -> None:
        """Write least recently used arrays to storage and drop them until
        the rest fit in *budget*."""
        total = sum(r.nbytes for r in resident.values())
        if total <= budget:
            return
        for store, res in sorted(resident.items(), key=lambda kv: kv[1].last_used):
            if store == exclude:
                continue
            self._flush(res)
            del resident[store]
            total -= res.nbytes
            if total <= budget:
                return

    @staticmethod
    def _flush(res: _Resident) -> None:
        """Write a resident array to its Zarr target, chunk by chunk."""
        target = res.target
        if isinstance(target, LazyZarrArray):
            concrete = target.create()
        elif isinstance(target, ZarrV2Array):
            concrete = target
        else:
            return
        shape = tuple(concrete.shape)
        if not shape:
            concrete[()] = backend_array_to_numpy_array(res.value)
            return
        chunkset = _chunkset(shape, tuple(concrete.chunks))
        for idx in itertools.product(*(range(len(c)) for c in chunkset)):
            sel = get_item(chunkset, idx)
            concrete[sel] = backend_array_to_numpy_array(res.value[sel])
