"""The device executor: the plan's arrays stay resident on the card.

Counterpart of ``cubed_tpu/runtime/executors/jax.py:JaxExecutor``:

- **Residency.** Every op's output is kept as one whole tensor on the chunk
  device (``backend_array_api.get_device()``), keyed by its target store.
  Zarr is touched only at the edges of the plan: storage sources are read
  once, and only the requested outputs are written, at the end.
- **Whole-array path.** A shape-invariant op whose block mapping is 1:1 (with
  broadcasting) runs once on the whole resident inputs.
- **Batched paths**, tried in this order, each counting ``batched_ops``:

  - an op whose function names a ``batched`` form (block generation:
    ``random``) and reads only its virtual template and its seeds is
    computed whole by that form: one kernel launch writes every block in
    place;
  - **the fusion rule**: an initial ``sum`` or ``mean`` fused with
    ``add(multiply(p, q), multiply(r, s))`` over plain reads of resident
    arrays goes, every block at once, through the hand-written
    ``fma_sum_blocks`` kernel (the counterpart of what XLA makes of that
    fused segment under ``jax.jit``). It is decided once per op from plan
    metadata, never from values;
  - **the general route** (the reference's ``_exec_batched``): an op of more
    than one task whose tasks share one key structure is cut into buckets
    by chunk shape (at most ``max(8, tasks // 4)``), and each bucket runs
    its function once under ``torch.func.vmap``, one level per grid axis
    the bucket spans. Inputs are views: a resident input's blocks in a
    bucket are one ``as_strided`` grid view, a virtual template the
    stride-0 carrier, seeds a host tensor. The hand kernels' batching rules
    (``region_sum``, Philox; custom ops) then launch once per bucket, or
    once per piece where a bucket is cut: each piece's grid views must
    index in 32 bits and have at most eight axes, and its intermediates
    (one of the piece's size per function of the op's tree) must fit the
    budget's room, all checked from metadata before the op runs. Outputs
    are written into the op's output, one strided copy per piece. The
    route is taken only when every leaf of the function tree declares
    itself ``batchable`` and one block fits; a failed check counts
    ``batched_errors`` and ``eager_fallbacks``, and the op runs chunked.
- **Resident map_direct.** An index (``whole_select``) is taken from its
  resident source on the device: a positive-step slice is a view, a
  negative step the positive slice then ``torch.flip`` (torch has no
  negative strides), an integer array ``index_select`` (its positions
  uploaded once a plan, never under a capture); ``resident_identity``
  passes the value through and ``whole_concat`` concatenates on the device
  (virtual sources made there). Any other map_direct (``flip``,
  ``map_overlap``) is an eager op whose task bodies, where they declare
  ``device_reads``, read
  their resident side inputs as views on the card: no side input is
  written to storage or crosses to the host.
- **Virtual constants** (``zeros``, ``ones``, ``full``) are filled on the
  device: one element expanded with stride 0 where a block is read, a
  filled tensor where one is made resident.
- **Rechunk is free** (the reference's ``_exec_rechunk``). A resident array
  is one whole tensor, so a rechunk's copy op admits the same tensor under
  its target's store and chunking (``rechunk_alias``); readers then slice it
  by the target's chunks. A virtual source is made on the device
  (``rechunk_virtual``). A storage source is loaded whole when it fits in
  half the budget, else copied region by region on the host (the spill
  path). A copy op joins a segment; the segment's storage sources are
  loaded before it runs (``segment_preloads``), and a segment whose source
  does not fit fails its pre-check and runs op by op, so no capture reads
  storage.
- **Chunked path.** Any other op runs per output block on block views of its
  resident inputs; a combine over a dense region of resident blocks runs as
  one call (``combine_region``); the fusion rule's op whose inputs are not
  all resident, or past one launch's 32-bit reach, takes ``fma_sum`` block
  by block (``fma_sum_blocks`` on a grid of one block). Blocks are copied
  into one output tensor as they come.
- **Spill.** When residency with the cached graphs' pools would pass
  ``device_mem``, cached graphs are dropped first (least recently used,
  never the running segment's), then the least recently used arrays are
  written to their Zarr targets and dropped; their readers then read
  storage.
- **Segments replayed as CUDA graphs** (``fuse_plan``, on a CUDA device).
  Ops are grouped into segments as the reference groups them for tracing.
  A segment that passes the memory pre-check (its resident inputs, every
  output and the cached graphs fit the budget, other segments' graphs
  dropped first; every storage source is resident; else
  ``segment_mem_aborts``) is keyed by a structural key of its plan
  metadata (:meth:`CudaExecutor._structural_key`: seeds and store paths
  masked; a plan it cannot describe, or whose ops draw blocks on the host
  (``host_draws``: ``random.normal``/``randint``) or make a library call
  that synchronises the host (``host_sync``: ``linalg.eigh``, ``svd``),
  runs op by op, uncaptured: ``segments_uncapturable``). At the
  key's first sighting the segment runs op by op, on the paths a capture
  takes, and nothing is captured: a plan computed once pays nothing for
  graphs. At its second it is captured into a ``torch.cuda.CUDAGraph``
  (``segments_compiled``), with the capture stream's ticket counters
  reserved for the most any launch has asked for, and replayed. A later
  compute of a structurally equal plan
  (``segment_struct_hits``) copies its resident inputs into the graph's
  static inputs, refills the graph's pinned Philox keys from its own seeds
  (one ``philox_keys`` pass) and replays the graph. Only the outputs that
  :meth:`CudaExecutor._segment_keep` names stay resident, cloned out of the
  graph's pool. Cached graphs' bytes (``segment_hbm_footprint``: the pool,
  read from the CUDA allocator, with the static buffers) count against
  ``device_mem``, least recently used graphs dropped first. A replay adds
  the launches its graph holds to the kernel wrappers' counts. On the CPU a
  segment runs op by op.
- **Residency counts storage, not names.** An alias (a rechunk's target), a
  view (an index) and their source hold one storage; it counts once against
  ``device_mem`` and spills only with the last name that holds it.
- **compute_dtype="float32"** (the reference's f32 ingestion, jax.py:122-158
  and :326-345): the whole DAG runs inside ``backend_array_api.narrowing``,
  thread-locally, restored on every exit. Every float64 chunk is float32
  (complex128 complex64), random blocks included (the Philox kernels'
  float32 entry points: the float64 stream rounded to the nearest float32,
  the reference's block bit for bit); residency holds and counts them at
  their narrowed size, and the store boundary (``_flush``, and so the value
  ``compute()`` returns) widens them back to the declared dtype. The plan
  (tasks, ops, projected memory) is the float64 plan. The reductions take
  their float32 routes (``fma_sum_blocks``, ``region_sum``), which
  accumulate in float64 where the reference's accumulate in float32: at
  least as exact, within the reference's documented bound. Integers are
  the one deliberate divergence: the reference's x64-off also narrows int64
  to int32, so ``sum`` of ``arange(10) * 2**40`` under
  ``JaxExecutor(compute_dtype="float32")`` returns 0; here integer and bool
  chunks keep their dtypes and the sum is exact (49478023249920). The
  reference's process-global warnings filter is not ported: torch warns of
  no truncation.
- **matmul_precision** (jax.py:159-176, :346-350): the per-block product of
  float32 operands runs at the mode (``contraction.precision``, a
  context-local scope for the whole DAG; no process-global torch switch is
  read or changed): bf16 or 3-pass bf16 on the tensor cores with float32
  sums, TF32-rounded operands in float32, or full float32. A float64
  product stays DGEMM. See ``cubed_tpu_torch/contraction.py``.
- **The structural key** folds in both options, so float32 and float64
  computes of one plan shape, or two precisions, never replay each other's
  graphs.
- **Observability** (the reference's): every op fires its operation and
  task events, each op one ``TaskEndEvent`` of its task count, stamped with
  host time after its launches are queued (a segment's wall time
  apportioned by task count); device time is the profiler callback's
  (``observability/profiler.py``). Every callback fires outside a capture.
  A segment memory abort records a ``cuda_segment_mem_abort`` decision.
  Preloads and the output's flush run outside any task scope, so their
  storage bytes go to the metrics registry (``observability/accounting.py``).

- **Reliability** (the reference's, ``jax.py:404-460`` and :620-660),
  all of it outside any CUDA graph capture or replay, at op and segment
  boundaries:
  - *Resume* is op-granular: an op whose persisted outputs all verify is
    skipped, a corrupt chunk is quarantined by the scan and its op re-run;
    an op that only feeds resident arrays cannot be skipped, nothing of it
    having been persisted.
  - *Cancellation*: the compute's token is checked at every op and segment
    boundary and before the outputs' flush; a replay is never interrupted
    and a cancelled compute flushes nothing of a segment it did not finish.
  - *The memory guard* wraps every segment and eager op in
    ``task_guard(..., observe_only=True)``: its reading (on the card, the
    allocator's peak over the unit's start) is each op's
    ``TaskEndEvent.guard_mem_peak``. It measures and never fails a unit,
    and this executor retries nothing, as ``JaxExecutor``.

Not ported yet: meshes and the compute journal. No fast path, capture or
kernel is wrapped in an ``except``: where one cannot run, a check says so and
the op takes the next path.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import math
import time
import types
from collections import Counter, OrderedDict
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ... import contraction, device_constants
from ...backend_array_api import (
    _to_carrier,
    backend_array_to_numpy_array,
    compute_numpy_dtype,
    get_device,
    narrowing,
    numpy_array_to_backend_array,
    nxp,
    to_torch_dtype,
)
from ...chunks import blockdims_from_blockshape
from ...core.ops import _InitialReduce, side_input_views
from ...core.plan import Plan, create_zarr_array
from ...kernels import _build, _geometry
from ...kernels.fma_sum import fma_sum, fma_sum_blocks
from ...kernels.philox_uniform import HoistedKeys, hoisted
from ...observability.collect import record_decision
from ...primitive.blockwise import (
    BlockwiseSpec,
    CubedArrayProxy,
    PredArgs,
    PredKeys,
    _is_key,
    apply_blockwise,
    get_chunk,
)
from ...primitive.rechunk import copy_read_to_write
from ...spec import Spec
from ...storage.store import ZarrV2Array
from ...storage.virtual import VirtualEmptyArray, VirtualFullArray, VirtualInMemoryArray, VirtualOffsetsArray
from ...storage.zarr import LazyZarrArray
from ...utils import convert_to_bytes, get_item
from ..cancellation import abort as cancel_abort
from ..memory import task_guard
from ..pipeline import ResumeState, visit_nodes
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

#: structural keys remembered from a first sighting (no graph is captured
#: for a plan computed once)
_SEEN_LIMIT = 1024

#: orders residents by last use (a clock could tie)
_use_clock = itertools.count()


class _Resident:
    """A resident array and its bookkeeping: the storage its value lives in
    (the key it counts by: an alias or a view shares its source's) and that
    storage's bytes."""

    __slots__ = ("value", "storage", "nbytes", "last_used", "target")

    def __init__(self, value: torch.Tensor, target):
        self.value = value
        storage = value.untyped_storage()
        self.storage = storage.data_ptr()
        self.nbytes = storage.nbytes()
        self.target = target
        self.touch()

    def touch(self) -> None:
        self.last_used = next(_use_clock)


def _held(residents) -> int:
    """Bytes that *residents* hold on the device: each storage once, however
    many names hold it."""
    return sum({r.storage: r.nbytes for r in residents}.values())


def _value_nbytes(value: torch.Tensor) -> int:
    return value.numel() * value.element_size()


def _key(arr) -> str:
    return str(getattr(arr, "store", id(arr)))


@functools.lru_cache(maxsize=1024)
def _chunkset(shape: tuple, chunks: tuple) -> tuple:
    return blockdims_from_blockshape(shape, chunks) if shape else ()


def _shape_at(chunkset, coords) -> tuple:
    return tuple(chunkset[d][c] for d, c in enumerate(coords))


def _starts_at(chunkset, coords) -> tuple:
    return tuple(sum(chunkset[d][:c]) for d, c in enumerate(coords))


def _carrier(shape, dtype, fill=0) -> torch.Tensor:
    """A virtual empty block (zeros) or a full one (*fill*): one element
    filled on the device, expanded with stride 0."""
    value = _to_carrier(np.asarray(fill, dtype=dtype)).item()  # an unsigned value in its carrier's range
    return torch.full((), value, dtype=to_torch_dtype(dtype), device=get_device()).expand(tuple(shape))


def _virtual_block(arr, shape) -> Optional[torch.Tensor]:
    """A block of a virtual empty or full array, made on the device."""
    if isinstance(arr, VirtualEmptyArray):
        return _carrier(shape, arr.dtype)
    if isinstance(arr, VirtualFullArray):
        return _carrier(shape, arr.dtype, arr.fill_value)
    return None


def _as_tensor(value) -> torch.Tensor:
    """A task body's result on the chunk device (an index task body reads
    storage and returns numpy)."""
    return numpy_array_to_backend_array(value) if isinstance(value, np.ndarray) else value


def _index_tensor(positions: np.ndarray, cached: bool, capturing: bool) -> torch.Tensor:
    """*positions* (an integer array) as an int64 tensor on the chunk
    device: *cached*, a device constant by the host array's identity (a
    whole-array index, read by later computes and captures of the same
    plan); else uploaded now, never under capture."""
    if cached:
        return device_constants.constant(positions, _indexed(get_device()), by_id=True)
    if capturing:
        raise RuntimeError("an index array first read under CUDA graph capture")
    return torch.as_tensor(np.asarray(positions, dtype=np.int64), device=get_device())


class _Permuted:
    """A leaf axis whose block coordinate is a permutation of a batch
    level's (the sort network's partner blocks, ``b ^ stride``): *level*, and
    *mapping* from the level's coordinate to the leaf's."""

    def __init__(self, level: int, mapping: dict):
        self.level = level
        self.mapping = mapping


def _level_of(entry) -> Optional[int]:
    """The batch level a leaf axis follows (directly or permuted), or None."""
    return entry.level if isinstance(entry, _Permuted) else entry


def _permutation_tensor(positions: np.ndarray) -> torch.Tensor:
    """A block permutation of a permuted leaf (or a permuted grid of block
    offsets) as an int64 device constant, keyed by its contents: uploaded
    outside any capture (a plan shape's first compute runs op by op) and
    read by later captures."""
    return device_constants.constant(positions, _indexed(get_device()))


def _select(value: torch.Tensor, selections, index) -> torch.Tensor:
    """*value* under per-axis selections, on its device: a (start, stop,
    step) triple or a slice (a negative step as the positive slice over the
    same elements, then ``torch.flip``: torch has no negative strides; a
    positive step is a view), or an integer array (``index_select``,
    *index* giving its positions as a device tensor)."""
    for ax, s in enumerate(selections):
        if isinstance(s, slice):
            s = s.indices(value.shape[ax])
        if isinstance(s, tuple):
            start, stop, step = s
            n = len(range(start, stop, step))
            lo = start if step > 0 else start + (n - 1) * step
            sl = slice(lo, lo + (n - 1) * abs(step) + 1, abs(step)) if n else slice(0, 0)
            value = value[(slice(None),) * ax + (sl,)]
            if step < 0 and n > 1:
                value = torch.flip(value, (ax,))
        else:
            value = torch.index_select(value, ax, index(s))
    return value


class _ResidentView:
    """A resident array as a map_direct task body reads it (``[...]`` and
    ``.oindex[...]``, as it reads a Zarr array), selected on the card: its
    blocks never cross to the host."""

    def __init__(self, value: torch.Tensor, target, capturing: bool):
        self.value = value
        self.shape = tuple(target.shape)
        self.dtype = target.dtype
        self.capturing = capturing

    def _index(self, positions) -> torch.Tensor:
        return _index_tensor(positions, cached=False, capturing=self.capturing)

    def __getitem__(self, key):
        key = key if isinstance(key, tuple) else (key,)
        if all(k is Ellipsis or isinstance(k, (int, np.integer))
               or (isinstance(k, slice) and (k.step or 1) > 0) for k in key):
            return self.value[key]
        return self.oindex[key]

    @property
    def oindex(self):
        return _ResidentOIndex(self)


class _ResidentOIndex:
    def __init__(self, view: _ResidentView):
        self.view = view

    def __getitem__(self, key):
        return _select(self.view.value, key if isinstance(key, tuple) else (key,), self.view._index)


def _nbytes_of(arr) -> int:
    """Bytes of *arr* on the device: at its narrowed size under the
    narrowing scope."""
    return math.prod(tuple(arr.shape)) * compute_numpy_dtype(arr.dtype).itemsize


def _op_reads(op) -> list:
    """The arrays an op reads: a copy op its source; a blockwise op its
    reads and side inputs."""
    config = op.pipeline.config
    if op.pipeline.function is copy_read_to_write:
        return [config.read.array]
    return [p.array for p in config.reads_map.values()] + list(getattr(config.function, "side_inputs", None) or [])


def _op_writes(op) -> tuple:
    """The write proxies of an op."""
    config = op.pipeline.config
    return (config.write,) if op.pipeline.function is copy_read_to_write else config.writes


# ---------------------------------------------------------------------------
# key structures of the batched route (the reference's _flatten_keys)
# ---------------------------------------------------------------------------


def _flatten_keys(structure):
    """(treedef, leaf keys) of a block function's result: a comparable nested
    template (``"leaf"`` for a key, ``("pred", ...)`` for a fused
    predecessor's arguments, ``("list", ...)`` for a contraction, under
    ``("args", ...)``), or (None, None) when it streams (an iterator)."""
    leaves: list = []

    def walk(node):
        if isinstance(node, PredKeys):
            children = tuple(walk(c) for c in node)
            return None if None in children else ("pred", children)
        if _is_key(node):
            leaves.append(node)
            return "leaf"
        if isinstance(node, (list, tuple)):
            children = tuple(walk(c) for c in node)
            return None if None in children else ("list", children)
        return None  # an iterator: streamed reads do not batch

    out = []
    for entry in structure:
        t = walk(entry)
        if t is None:
            return None, None
        out.append(t)
    return ("args", tuple(out)), leaves


def _unflatten_keys(treedef, flat: list) -> tuple:
    """The argument structure with values in place of keys: fused
    predecessors' groups as PredArgs, contractions as lists."""
    it = iter(flat)

    def build(t):
        if t == "leaf":
            return next(it)
        kind, children = t
        built = [build(c) for c in children]
        return PredArgs(built) if kind == "pred" else built

    return tuple(build(e) for e in treedef[1])


def _leaf_functions(f) -> Iterator:
    """The leaves of *f*'s function tree: a fused function's
    ``root_function`` and ``arg_functions``, down to unfused functions."""
    root = getattr(f, "root_function", None)
    if root is None:
        yield f
        return
    for g in (root, *f.arg_functions):
        if g is not None:
            yield from _leaf_functions(g)


def _repeated(f, n: int):
    """*f* with a new leading axis of *n* equal results (on each tensor of
    its output), as ``torch.func.vmap`` would give over *n* equal
    inputs; vmap itself refuses a level that no input follows."""

    def g(*args):
        return torch.utils._pytree.tree_map(lambda r: r.unsqueeze(0).expand(n, *r.shape), f(*args))

    return g


def _batchable(f) -> bool:
    """Whether every leaf of *f*'s function tree declares that it runs
    under ``torch.func.vmap`` (its ``batchable`` hint)."""
    return all(getattr(g, "batchable", False) for g in _leaf_functions(f))


def _tree_size(f) -> int:
    """Functions in *f*'s function tree, fused nodes included: each makes at
    most one intermediate of a bucket's size."""
    root = getattr(f, "root_function", None)
    if root is None:
        return 1
    return 1 + sum(_tree_size(g) for g in (root, *f.arg_functions) if g is not None)


def _tiles(tasks: list, sizes: list, tile: list):
    """(tasks, sizes) of each piece of a bucket (a dense grid of *sizes*
    blocks, *tasks* in C order) cut into pieces of at most *tile* blocks,
    each piece's tasks in C order."""
    index = np.arange(len(tasks)).reshape(sizes)
    for start in itertools.product(*(range(0, n, t) for n, t in zip(sizes, tile))):
        sel = tuple(slice(s, min(s + t, n)) for s, t, n in zip(start, tile, sizes))
        piece = index[sel]
        yield [tasks[i] for i in piece.reshape(-1)], list(piece.shape)


def _indexed(dev: torch.device) -> torch.device:
    """*dev* with its index, as the tensors made on it name it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _block_counts(chunkset, device) -> torch.Tensor:
    """Elements of each block of a regular grid (the last block along an
    axis may be shorter), as an int64 tensor of the grid's shape, made on
    the device from fills (no host copy: a captured graph may hold it)."""
    n = torch.ones((1,) * len(chunkset), dtype=torch.int64, device=device)
    for d, c in enumerate(chunkset):
        if any(x != c[0] for x in c[:-1]):
            raise ValueError(f"block counts of an irregular grid {chunkset}")
        e = torch.full((len(c),), c[0], dtype=torch.int64, device=device)
        if c[-1] != c[0]:
            e[-1:].fill_(c[-1])
        n = n * e.reshape([len(c) if k == d else 1 for k in range(len(chunkset))])
    return n


def _grid_view(value: torch.Tensor, chunkset, first: tuple, axes: list, sizes: list) -> torch.Tensor:
    """The blocks of *value* (blocked by *chunkset*) from block *first*
    along its axes *axes* (one per batch axis, outermost first, *sizes*
    blocks each) as one view: the batch axes, then the block's axes."""
    block = _shape_at(chunkset, first)
    starts = _starts_at(chunkset, first)
    st = value.stride()
    return value.as_strided(
        tuple(sizes) + block,
        tuple(block[d] * st[d] for d in axes) + tuple(st),
        value.storage_offset() + sum(s * t for s, t in zip(starts, st)),
    )


# ---------------------------------------------------------------------------
# the structural key of a segment (the reference's _structural_key, without
# cloudpickle): a description of everything that shapes the captured graph
# ---------------------------------------------------------------------------


class _Undescribable(Exception):
    pass


class _Describer:
    """Describes plan metadata as nested tuples of plain values: function
    trees by qualified name, code and closure values; arrays by shape, dtype
    and chunks; store paths by order-of-first-use tokens; the seeds of
    *masked* offsets arrays as ``"H"``. Raises :class:`_Undescribable` on
    any value it cannot describe."""

    _PLAIN = (type(None), bool, int, float, complex, str, bytes)

    def __init__(self, masked: set):
        self.masked = masked
        self.names: set = set()
        self.stores: dict = {}
        self.memo: dict = {}
        self.alive: list = []  # keeps described objects alive, so ids stay unique

    def store(self, path) -> str:
        return self.stores.setdefault(str(path), f"@{len(self.stores)}")

    def __call__(self, obj):
        if isinstance(obj, self._PLAIN):
            return obj if not isinstance(obj, float) else ("float", repr(obj))
        if obj is Ellipsis:
            return ("ellipsis",)  # a code constant of ``x[..., i]``
        if isinstance(obj, (np.generic,)):
            return ("np", str(obj.dtype), repr(obj.item()))
        if isinstance(obj, (np.dtype, torch.dtype, torch.device, slice, range)):
            return (type(obj).__name__, str(obj))
        i = self.memo.get(id(obj))
        if i is not None:
            return ("ref", i)
        self.memo[id(obj)] = len(self.memo)
        self.alive.append(obj)
        return self._describe(obj)

    def _describe(self, obj):
        if isinstance(obj, (list, tuple)):
            return (type(obj).__qualname__, tuple(self(v) for v in obj))
        if isinstance(obj, (set, frozenset)):
            return (type(obj).__qualname__, tuple(sorted((self(v) for v in obj), key=repr)))
        if isinstance(obj, dict):
            return ("dict", tuple((self(k), self(v)) for k, v in obj.items()))
        if isinstance(obj, np.ndarray):
            if obj.nbytes > _HOST_DATA_LIMIT or obj.dtype.hasobject:
                raise _Undescribable(f"a host array of {obj.nbytes} B")
            return ("ndarray", obj.shape, str(obj.dtype),
                    hashlib.sha256(np.ascontiguousarray(obj).tobytes()).hexdigest())
        if isinstance(obj, (LazyZarrArray, ZarrV2Array)):
            return ("zarr", self.store(obj.store), tuple(obj.shape), str(obj.dtype),
                    tuple(getattr(obj, "chunks", ()) or ()))
        if isinstance(obj, VirtualOffsetsArray):
            return ("offsets", obj.shape, "H" if id(obj) in self.masked else obj.base)
        if isinstance(obj, VirtualEmptyArray):
            return ("empty", obj.shape, str(obj.dtype), obj.chunks)
        if isinstance(obj, VirtualFullArray):
            return ("full", obj.shape, str(obj.dtype), obj.chunks, self(obj.fill_value))
        if isinstance(obj, VirtualInMemoryArray):
            return ("in_memory", obj.chunks, self(obj.array))
        if isinstance(obj, BlockwiseSpec):
            self.names.update(obj.reads_map)
            return ("spec", tuple((f, self(v)) for f, v in vars(obj).items()))
        if isinstance(obj, CubedArrayProxy):
            return ("proxy", self(obj.array), self(obj.chunks))
        if isinstance(obj, (Spec, Plan)):
            return ("meta",)  # resources and provenance: never part of the graph
        if isinstance(obj, types.FunctionType):
            closure = tuple(self(c.cell_contents) for c in obj.__closure__ or ())
            return ("function", obj.__module__, obj.__qualname__, self._code(obj.__code__),
                    self(obj.__defaults__), self(obj.__kwdefaults__), closure, self(dict(obj.__dict__)),
                    self._globals(obj))
        if isinstance(obj, type):
            return ("class", obj.__module__, obj.__qualname__, self._class_attrs(obj))
        if isinstance(obj, (staticmethod, classmethod)):
            return (type(obj).__name__, self(obj.__func__))
        if isinstance(obj, property):
            return ("property", self(obj.fget), self(obj.fset), self(obj.fdel))
        if isinstance(obj, types.MethodType):
            return ("method", self(obj.__self__), self(obj.__func__))
        if isinstance(obj, (types.BuiltinFunctionType, types.BuiltinMethodType, types.ModuleType)):
            return ("builtin", getattr(obj, "__module__", None), getattr(obj, "__qualname__", obj.__name__))
        if isinstance(obj, functools.partial):
            return ("partial", self(obj.func), self(obj.args), self(obj.keywords))
        if obj is nxp:
            return ("nxp",)
        qualname = getattr(obj, "_namespace", None), getattr(obj, "_name", None)
        if type(obj).__name__ == "CustomOpDef" and all(qualname):
            return ("custom_op", *qualname)
        if hasattr(obj, "__dict__") and type(obj).__module__.startswith("cubed_tpu_torch."):
            return ("object", type(obj).__module__, type(obj).__qualname__, self(dict(vars(obj))))
        raise _Undescribable(f"{type(obj).__module__}.{type(obj).__qualname__}")

    #: packages whose classes are described by name alone: their attributes
    #: are not a user's settings
    _LIBRARIES = ("builtins", "numpy", "torch", "cubed_tpu_torch")

    def _class_attrs(self, cls: type) -> tuple:
        """The attributes (dunders aside) of *cls* and of its bases, for a
        class outside the libraries: ``Cfg.K``, read when the chunk runs, is
        baked into a captured graph like a global (the reference's
        cloudpickle serialises a ``__main__`` class by value)."""
        return tuple(
            (c.__qualname__, self({k: v for k, v in vars(c).items() if not k.startswith("__")}))
            for c in cls.__mro__ if (c.__module__ or "").partition(".")[0] not in self._LIBRARIES)

    def _globals(self, fn: types.FunctionType) -> tuple:
        """The values of the module globals *fn*'s code (nested code
        included) names, for a function outside this package: a user's
        constant, read when the chunk runs, is baked into a captured graph,
        so a new value must give a new key (the reference's cloudpickle
        serialises a ``__main__`` function's globals by value). This
        package's own functions read no mutable globals."""
        if (fn.__module__ or "").startswith("cubed_tpu_torch."):
            return ()
        names: list = []
        stack = [fn.__code__]
        while stack:
            code = stack.pop()
            names += code.co_names
            stack += [c for c in code.co_consts if isinstance(c, types.CodeType)]
        g = fn.__globals__
        return tuple((n, self(g[n])) for n in sorted(set(names)) if n in g)

    def _code(self, code: types.CodeType):
        consts = tuple(self._code(c) if isinstance(c, types.CodeType) else self(c) for c in code.co_consts)
        return (code.co_name, hashlib.sha256(code.co_code).hexdigest(), consts, code.co_names)


def _tokenize(desc, names: set, tokens: dict):
    """*desc* with every string in *names* (the plan's generated names)
    replaced by a token in order of first appearance."""
    if isinstance(desc, str):
        return tokens.setdefault(desc, f"N{len(tokens)}") if desc in names else desc
    if isinstance(desc, tuple):
        return tuple(_tokenize(d, names, tokens) for d in desc)
    return desc


# ---------------------------------------------------------------------------
# captured segments
# ---------------------------------------------------------------------------


class _Graph:
    """A captured segment: the graph, its static inputs (in the order of its
    resident input keys), its hoisted Philox keys, the host-side arrays it
    read as device constants (this compute's literals, and the cached
    constants it read: the graph reads them by address, so it keeps them
    alive), the ticket counters its kernels use, its outputs (pool tensors,
    in keep order), the launches it holds, the executor's path counts of its
    ops, and its bytes on the card."""

    __slots__ = ("graph", "inputs", "keys", "uploads", "constants", "tickets", "outputs", "launches", "paths",
                 "nbytes", "device", "done")

    def __init__(self, graph, inputs, keys, uploads, constants, tickets, outputs, launches, paths, nbytes, device):
        self.graph = graph
        self.inputs = inputs
        self.keys = keys
        self.uploads = uploads
        self.constants = constants
        self.tickets = tickets  # the capture stream's ticket counters, kept alive
        self.outputs = outputs
        self.launches = launches
        self.paths = paths
        self.nbytes = nbytes
        self.device = device
        self.done = torch.cuda.Event()


class _GraphCache:
    """Captured segments by structural key, least recently used first. Their
    bytes count against the residency budget of the device they live on."""

    def __init__(self):
        self.entries: "OrderedDict[str, _Graph]" = OrderedDict()

    def get(self, key: str) -> Optional[_Graph]:
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def nbytes(self, device) -> int:
        return sum(e.nbytes for e in self.entries.values() if e.device == device)

    def shrink(self, device, limit: int, keep: Optional[str] = None) -> None:
        """Drop least recently used graphs of *device* (never *keep*) until
        their bytes are at most *limit*."""
        for key in list(self.entries):
            if self.nbytes(device) <= limit:
                return
            if key != keep and self.entries[key].device == device:
                del self.entries[key]

    def put(self, key: str, entry: _Graph, limit: int) -> bool:
        """Cache *entry* if it fits *limit*, dropping least recently used
        graphs of its device to make room beside it."""
        if entry.nbytes > limit:
            return False
        self.shrink(entry.device, limit - entry.nbytes)
        self.entries[key] = entry
        return True


#: captured segments of this process, shared by every CudaExecutor (as the
#: reference's _STRUCT_CACHE is)
_GRAPHS = _GraphCache()

#: structural keys of segments run once, op by op, and not captured: the
#: second sighting of a key captures its graph (least recent dropped first)
_SEEN: "OrderedDict[str, bool]" = OrderedDict()

#: one capture stream per device: the kernels' ticket counters are per
#: stream, and this stream's are reserved before each capture
_CAPTURE_STREAMS: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


def _pool_bytes(segments, pool_id) -> int:
    """Bytes of the CUDA allocator's segments that belong to graph pool
    *pool_id* (``torch.cuda.memory_snapshot()`` entries)."""
    return sum(s["total_size"] for s in segments if tuple(s.get("segment_pool_id", ())) == tuple(pool_id))


class CudaExecutor(DagExecutor):
    """Runs the plan with its arrays resident on the chunk device.

    Parameters
    ----------
    device_mem : int | str | None
        Residency budget in bytes. Default: the spec's ``device_mem``, else
        75% of the card's memory (8 GiB when the chunk device is the CPU).
        Cached graphs' bytes count against it too.
    fuse_plan : bool
        Group ops into segments, replayed as CUDA graphs on a card (the
        reference's ``fuse_plan``). False runs every op on its own.
    compute_dtype : str | None
        ``"float32"`` runs a float64 plan in float32 on the device (the
        reference's "f32 ingestion"): float64 chunks, random blocks included,
        are float32 inside the DAG and widen back to the declared dtype at
        the store boundary; integers stay exact (see the module docstring).
        The reference's documented error bound holds: each elementwise op
        adds relative error <= float32 eps (1.19e-7); a k-element tree sum,
        <= (log2(k) + chunks) * eps * sum|a| absolute. ``None`` and
        ``"float64"`` compute in the declared dtypes.
    matmul_precision : str | None
        The precision of float32 per-block products: ``"bfloat16"``,
        ``"bfloat16_3x"``, ``"tensorfloat32"``, or full float32 (``None``,
        ``"float32"``, ``"highest"``, ``"default"``); defined in
        ``cubed_tpu_torch/contraction.py``. Float64 products stay DGEMM, so
        combine it with ``compute_dtype="float32"`` for a float64 source.
    """

    def __init__(self, device_mem=None, fuse_plan: bool = True, compute_dtype: Optional[str] = None,
                 matmul_precision: Optional[str] = None):
        if compute_dtype not in (None, "float32", "float64"):
            raise ValueError(f"compute_dtype must be None, 'float32' or 'float64'; got {compute_dtype!r}")
        contraction.check_mode(matmul_precision)
        self.device_mem = convert_to_bytes(device_mem)
        self.fuse_plan = fuse_plan
        self.compute_dtype = compute_dtype
        self.matmul_precision = matmul_precision
        #: path counters of the last ``execute_dag``, under the reference's
        #: names: ``whole_array_hits``, ``whole_concat_hits``,
        #: ``batched_ops``, ``chunked_ops``, ``eager_ops``; the rechunk
        #: counters ``rechunk_alias`` and ``rechunk_virtual`` (the
        #: reference's), ``rechunk_loads`` and ``rechunk_copies`` (a storage
        #: source loaded whole, or copied on the host); the segment counters
        #: ``segments_traced``, ``segments_compiled``,
        #: ``segment_struct_hits``, ``segment_hbm_footprint``,
        #: ``segment_mem_aborts`` and ``segment_preloads`` (storage sources
        #: loaded before a segment runs); and the failed checks
        #: ``whole_array_errors``, ``whole_select_errors``, ``batched_errors``
        #: and ``eager_fallbacks`` (0 on the main path)
        self.stats: Counter = Counter()
        self._uploads: dict = {}
        #: a segment runs on the card: seeds come as tensors, keys from the
        #: segment's hoisted table (its op-by-op run and its capture alike)
        self._segment_mode = False
        #: a CUDA graph is being captured: no spill, no upload
        self._capturing = False
        #: op name -> stores dropped once it has run, in the running segment
        self._segment_deaths: Dict[str, list] = {}
        #: structural key of the segment being captured or replayed: its
        #: graph is not dropped to make room for the segment's own outputs
        self._graph_key: Optional[str] = None
        #: the running compute's cancellation token, if it has one
        self._cancellation = None

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
        # both scopes are this thread's (or task's) alone, and are restored
        # on every exit, a failing compute's included
        with narrowing(self.compute_dtype == "float32"), contraction.precision(self.matmul_precision):
            self._execute_dag(dag, callbacks, array_names, resume, spec, kwargs.get("cancellation"))

    def _execute_dag(self, dag, callbacks, array_names, resume, spec, cancellation=None) -> None:
        dev = get_device()
        self.stats = Counter()
        self._uploads = {}  # id of a VirtualInMemoryArray -> its device tensor
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
        self._cancellation = cancellation
        state = ResumeState(quarantine=True) if resume else None
        for name, node in visit_nodes(dag, resume=resume, state=state):
            self._check_cancelled()
            if self.fuse_plan and self._classify(node["primitive_op"]) == "segment":
                segment.append((name, node))
                continue
            self._run(segment, dag, resident, budget, requested, callbacks, in_segment=True)
            segment = []
            self.stats["eager_ops"] += 1
            self._run([(name, node)], dag, resident, budget, requested, callbacks, in_segment=False)
        self._run(segment, dag, resident, budget, requested, callbacks, in_segment=True)
        # the outputs are whole here: a compute cancelled before this point
        # flushes nothing of them
        self._check_cancelled()
        for store, res in list(resident.items()):
            if store in requested:
                self._flush(res)
        self._uploads = {}

    def _classify(self, primitive_op) -> str:
        """'segment' if the op computes from resident inputs alone, so it may
        join a segment; 'eager' otherwise. From plan metadata only."""
        pipeline = primitive_op.pipeline
        if pipeline.function is copy_read_to_write:
            return "segment"  # rechunk: an alias of a resident (or preloaded) source
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

    def _check_cancelled(self) -> None:
        """The cooperative abort at an op or segment boundary."""
        if self._cancellation is not None and self._cancellation.cancelled:
            raise cancel_abort(self._cancellation)

    def _run(self, ops, dag, resident, budget, requested, callbacks, in_segment: bool) -> None:
        """Run *ops* in order, under one observe-only memory guard (its
        reading is every op's ``guard_mem_peak``); their wall time is
        apportioned by task count."""
        if not ops:
            return
        self._check_cancelled()
        t0 = time.time()
        for name, node in ops:
            num_tasks = node["primitive_op"].num_tasks
            callbacks_on(callbacks, "on_operation_start", OperationStartEvent(name, num_tasks))
            fire_task_start(callbacks, name, num_tasks=num_tasks)
        unit = f"segment:{','.join(name for name, _ in ops)}" if in_segment else f"eager:{ops[0][0]}"
        # the guard's entry and exit synchronize and read the allocator:
        # both sit outside any capture or replay
        with task_guard(unit, observe_only=True) as guard:
            if in_segment:
                for arr in self._segment_sources(ops):
                    if _key(arr) not in resident and self._preload(arr, resident, budget):
                        self.stats["segment_preloads"] += 1
                self._segment_deaths = self._deaths(ops, self._segment_keep(ops, dag, requested))
            try:
                if in_segment and get_device().type == "cuda":
                    self._run_segment(ops, dag, resident, budget, requested)
                else:
                    self._run_ops(ops, resident, budget, requested)
            finally:
                self._segment_deaths = {}
        elapsed = time.time() - t0
        total_tasks = sum(node["primitive_op"].num_tasks for _, node in ops) or 1
        start = t0
        for name, node in ops:
            num_tasks = node["primitive_op"].num_tasks
            end = start + elapsed * (num_tasks / total_tasks)
            callbacks_on(callbacks, "on_task_end", TaskEndEvent(
                array_name=name, num_tasks=num_tasks, task_create_tstamp=start,
                function_start_tstamp=start, function_end_tstamp=end,
                task_result_tstamp=end, executor=self.name, guard_mem_peak=guard.measured,
            ))
            callbacks_on(callbacks, "on_operation_end", OperationEndEvent(name, num_tasks))
            start = end

    def _run_ops(self, ops, resident, budget, requested) -> None:
        """Run *ops* one after another on the resident arrays; in a segment,
        an array it produced is dropped once its last reader there has run,
        unless the segment keeps it (:meth:`_deaths`)."""
        for name, node in ops:
            op = node["primitive_op"]
            if op.pipeline.function is apply_blockwise:
                self._exec_blockwise(op, resident, budget)
            elif op.pipeline.function is copy_read_to_write:
                self._exec_rechunk(op, resident, budget)
            elif op.pipeline.function is create_zarr_array:
                # metadata only for arrays that are written; residency
                # replaces the rest
                for lazy in op.pipeline.mappable:
                    if lazy.store in requested:
                        lazy.create()
            else:
                for m in op.pipeline.mappable:
                    op.pipeline.function(m, config=op.pipeline.config)
            for store in self._segment_deaths.get(name, ()):
                resident.pop(store, None)

    def _deaths(self, ops, keep) -> Dict[str, list]:
        """op name -> the stores produced in the segment whose last reader in
        it is that op (or that no op reads), and that the segment does not
        keep (:meth:`_segment_keep`): dropped once the op has run, as XLA
        frees a program's dead buffers. A long chain (the sort network's
        rounds) then holds a few of its arrays at a time, and a capture's
        pool reuses their memory."""
        produced = self._produced(ops)
        last: Dict[str, str] = {}
        for name, node in ops:
            op = node["primitive_op"]
            for arr in _op_reads(op):
                if _key(arr) in produced:
                    last[_key(arr)] = name
            for w in _op_writes(op):
                last.setdefault(_key(w.array), name)
        deaths: Dict[str, list] = {}
        for store, name in last.items():
            if store not in keep:
                deaths.setdefault(name, []).append(store)
        return deaths

    def _live_peak(self, ops, resident) -> int:
        """The most bytes the segment's outputs hold at once, with the dead
        dropped (:meth:`_deaths`); an alias holds none, and the source of an
        alias is counted live to the end."""
        produced = self._produced(ops)
        sizes: Dict[str, int] = {}
        aliased: set = set()
        live = peak = 0
        for name, node in ops:
            op = node["primitive_op"]
            alias = self._aliases(op, resident, produced)
            if alias:
                aliased.add(_key(op.pipeline.config.read.array))
            for w in _op_writes(op):
                sizes[_key(w.array)] = 0 if alias else _nbytes_of(w.array)
                live += sizes[_key(w.array)]
            peak = max(peak, live)
            live -= sum(sizes.get(k, 0) for k in self._segment_deaths.get(name, ()) if k not in aliased)
        return peak

    def _segment_sources(self, ops) -> list:
        """The storage arrays the segment reads and does not itself produce."""
        produced = self._produced(ops)
        seen, sources = set(), []
        for arr in self._segment_reads(ops):
            key = _key(arr)
            if key in seen or key in produced or not isinstance(arr, (ZarrV2Array, LazyZarrArray)):
                continue
            seen.add(key)
            sources.append(arr)
        return sources

    @staticmethod
    def _segment_reads(ops) -> list:
        """Every array the segment's ops read, side inputs included, in order."""
        return [arr for _, node in ops for arr in _op_reads(node["primitive_op"])]

    @staticmethod
    def _produced(ops) -> set:
        return {_key(w.array) for _, node in ops for w in _op_writes(node["primitive_op"])}

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
        if concrete.dtype.fields is not None or _nbytes_of(concrete) > budget:
            return False
        data = concrete[...] if concrete.shape else concrete[()]
        self._admit(resident, key, numpy_array_to_backend_array(data), arr, budget)
        return True

    # ------------------------------------------------------------------
    # segments replayed as CUDA graphs
    # ------------------------------------------------------------------

    def _segment_fits(self, ops, resident, budget, dev=None, skey=None) -> bool:
        """The memory pre-check (the reference's, before tracing): the
        resident arrays, every output of the segment that takes memory of its
        own (not a rechunk's alias of a resident or produced source) and the
        cached graphs of *dev* fit *budget*, cached graphs other than *skey*'s
        dropped first, least recently used first; and every storage array the
        segment reads and does not produce is resident (a capture can neither
        read storage nor spill)."""
        produced = self._produced(ops)
        if not all(
            _key(arr) in resident or _key(arr) in produced
            for arr in self._segment_reads(ops) if isinstance(arr, (ZarrV2Array, LazyZarrArray))
        ):
            return False
        room = budget - _held(resident.values()) - self._live_peak(ops, resident)
        if dev is not None:
            _GRAPHS.shrink(dev, room, keep=skey)
            room -= _GRAPHS.nbytes(dev)
        return room >= 0

    @staticmethod
    def _aliases(op, resident, produced) -> bool:
        """Whether *op* is a rechunk copy that admits its source's tensor again
        (the source resident, or produced earlier in the segment)."""
        if op.pipeline.function is not copy_read_to_write:
            return False
        src = _key(op.pipeline.config.read.array)
        return src in resident or src in produced

    @staticmethod
    def _segment_keep(ops, dag, requested) -> Dict[str, object]:
        """store -> target for the segment's outputs that must stay: those
        read by ops outside the segment, or requested as plan outputs."""
        names = {name for name, _ in ops}
        keep: Dict[str, object] = {}
        for name, _ in ops:
            for arr_name in dag.successors(name):
                target = dag.nodes[arr_name].get("target")
                if target is None or not hasattr(target, "store"):
                    continue
                if target.store in requested or not set(dag.successors(arr_name)) <= names:
                    keep[str(target.store)] = target
        return keep

    def _segment_inputs(self, ops, resident) -> list:
        """Keys of the resident arrays the segment reads and does not
        produce, in order of first read (the same order in structurally
        equal plans)."""
        produced = self._produced(ops)
        keys = [_key(a) for a in self._segment_reads(ops)]
        return list(dict.fromkeys(k for k in keys if k in resident and k not in produced))

    def _hoisted_arrays(self, ops) -> list:
        """The seeded offsets arrays (random's seeds) the segment reads, in
        order of first appearance, whose every reader draws them through the
        hoisted keys."""
        honored: dict = {}
        arrays: dict = {}
        for _, node in ops:
            if node["primitive_op"].pipeline.function is not apply_blockwise:
                continue
            spec = node["primitive_op"].pipeline.config
            ok = any(getattr(g, "hoisted_seeds", False) for g in _leaf_functions(spec.function))
            for proxy in spec.reads_map.values():
                arr = proxy.array
                if isinstance(arr, VirtualOffsetsArray) and arr.base:
                    arrays.setdefault(id(arr), arr)
                    honored[id(arr)] = honored.get(id(arr), True) and ok
        return [a for i, a in arrays.items() if honored[i]]

    @staticmethod
    def _seeds(arrays) -> np.ndarray:
        """Every block seed of *arrays*, array after array, blocks in C order."""
        if not arrays:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate([a.base + np.arange(math.prod(a.shape), dtype=np.int64) for a in arrays])

    def _structural_key(self, ops, dag, in_keys, resident, keep_list, hoisted_arrays, dev) -> Optional[str]:
        """A fingerprint of everything that shapes the segment's graph: each
        op's function tree and block function (code, closure values), its
        reads and writes (store paths as order-of-first-use tokens, hoisted
        seeds masked), shapes, dtypes, chunks and task counts; the resident
        inputs, the kept outputs, the hoisted seed counts and the device.
        None when some value cannot be described: then the segment is
        captured anew and nothing is cached."""
        describe = _Describer({id(a) for a in hoisted_arrays})
        describe.names.update(str(n) for n in dag.nodes)
        payload = []
        try:
            for _, node in ops:
                op = node["primitive_op"]
                spec = op.pipeline.config
                if op.pipeline.function is copy_read_to_write:
                    payload.append(("copy", describe(spec), describe(op.pipeline.mappable)))
                    continue
                describe.names.update(str(k[0]) for k in itertools.islice(iter(op.pipeline.mappable), 1))
                payload.append(("op", describe(spec), op.num_tasks))
        except _Undescribable:
            return None
        payload.append(("inputs", tuple((describe.store(k), tuple(resident[k].value.shape),
                                         str(resident[k].value.dtype)) for k in in_keys)))
        payload.append(("keep", tuple(describe.store(k) for k in keep_list)))
        payload.append(("hoisted", tuple(a.shape for a in hoisted_arrays)))
        payload.append(("device", str(dev), torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""))
        # the options that change what the graph computes: the chunks' dtypes
        # and the contraction's precision
        payload.append(("compute", "float32" if self.compute_dtype == "float32" else "float64",
                        self.matmul_precision))
        canonical = _tokenize(tuple(payload), describe.names, {})
        return hashlib.sha256(repr(canonical).encode()).hexdigest()

    def _run_segment(self, ops, dag, resident, budget, requested) -> None:
        """Run a segment on the card: replay its cached graph; capture it and
        replay it at the second sighting of its structural key; run it op by
        op at the first, and when the pre-check fails."""
        dev = _indexed(get_device())
        keep = self._segment_keep(ops, dag, requested)
        produced = self._produced(ops)
        keep_list = [k for k in keep if k in produced]
        in_keys = self._segment_inputs(ops, resident)
        hoisted_arrays = self._hoisted_arrays(ops)
        seeds = self._seeds(hoisted_arrays)
        skey = self._structural_key(ops, dag, in_keys, resident, keep_list, hoisted_arrays, dev)
        if not self._segment_fits(ops, resident, budget, dev, skey):
            self.stats["segment_mem_aborts"] += 1
            record_decision("cuda_segment_mem_abort", segment=",".join(name for name, _ in ops))
            self._run_ops(ops, resident, budget, requested)
            return
        uncapturable = self._uncapturable(ops)
        if skey is None or np.unique(seeds).size != seeds.size or uncapturable:
            # a graph that no later compute could replay (its plan is not
            # described, or two blocks share a seed and so a key row) would
            # be captured for nothing; blocks drawn on the host, and a
            # library call that waits on the host, cannot be captured at all
            if uncapturable:
                self.stats["segments_uncapturable"] += 1
            self._run_ops(ops, resident, budget, requested)
            return
        self._graph_key = skey
        try:
            entry = _GRAPHS.get(skey)
            if entry is not None:
                self.stats["segment_struct_hits"] += 1
                self._replay(entry, in_keys, seeds, keep_list, keep, resident, budget)
            elif skey in _SEEN:
                del _SEEN[skey]
                entry = self._capture(ops, {k: resident[k] for k in in_keys}, seeds, keep_list, requested,
                                      resident, budget, dev)
                self.stats["segments_compiled"] += 1
                _GRAPHS.put(skey, entry, budget - _held(resident.values()))
                self._replay(entry, in_keys, seeds, keep_list, keep, resident, budget)
            else:
                # a first sighting: op by op, on the paths a capture takes
                # (seeds as tensors, keys from a hoisted table), so the
                # kernels it would launch are loaded and their ticket needs
                # recorded
                _SEEN[skey] = True
                while len(_SEEN) > _SEEN_LIMIT:
                    _SEEN.popitem(last=False)
                keys = HoistedKeys(seeds, dev)
                keys.upload()
                self._segment_mode = True
                try:
                    with hoisted(keys):
                        self._run_ops(ops, resident, budget, requested)
                finally:
                    self._segment_mode = False
                for store in produced:
                    if store not in keep and store in resident:
                        del resident[store]  # read only inside the segment
        finally:
            self._graph_key = None
        self.stats["segments_traced"] += 1
        if entry is not None:
            self.stats["segment_hbm_footprint"] = max(self.stats["segment_hbm_footprint"], entry.nbytes)

    @staticmethod
    def _uncapturable(ops) -> bool:
        """Whether an op of the segment cannot run under a CUDA graph
        capture: a function of its tree draws its blocks on the host
        (``host_draws``: ``normal``, ``randint``) or makes a library call
        that synchronises the host (``host_sync``: ``eigh``, ``svd``, whose
        ``torch.linalg`` calls check their ``info`` on the host)."""
        return any(
            getattr(g, "host_draws", False) or getattr(g, "host_sync", False)
            for _, node in ops if node["primitive_op"].pipeline.function is apply_blockwise
            for g in _leaf_functions(node["primitive_op"].pipeline.config.function)
        )

    def _capture(self, ops, inputs, seeds, keep_list, requested, resident, budget, dev) -> _Graph:
        """Capture the segment's ops into a CUDA graph. Everything a capture
        may not do is done first: the segment's first sighting ran it op by
        op on the same paths, so every kernel is built and loaded; the host
        arrays it reads are uploaded; the capture stream's ticket counters
        are reserved for the most any launch has asked for; the resident
        inputs are copied to static buffers; older graphs are dropped to
        make room for the pool; and the Philox keys of *seeds* are hoisted
        to a pinned buffer, which the graph's first node uploads. Launch
        counts made while capturing are taken back (nothing ran) and kept,
        to be added at each replay; so are the paths the ops took."""
        stream = _capture_stream(dev)
        for arr in self._segment_reads(ops):
            if isinstance(arr, VirtualInMemoryArray):
                self._upload(arr)
        for _, node in ops:
            # the integer-array selections of whole-array indexes
            f = getattr(node["primitive_op"].pipeline.config, "function", None)
            for sel in getattr(f, "whole_select", None) or ():
                if isinstance(sel, np.ndarray):
                    _index_tensor(sel, cached=True, capturing=False)
        with torch.cuda.stream(stream):
            tickets = _build.reserve_tickets(dev)
        held = _held(resident.values())
        # half the room beside the segment's outputs stays free of cached
        # graphs: its batched ops' intermediates (no graph is dropped while
        # capturing)
        _GRAPHS.shrink(dev, (budget - held - self._live_peak(ops, resident)) // 2)
        keys = HoistedKeys(seeds, dev)
        static = {k: res.value.clone() for k, res in inputs.items()}
        uploads = dict(self._uploads)
        before = _build.launch_counts()
        stats = Counter(self.stats)
        local = {k: _Resident(v, inputs[k].target) for k, v in static.items()}
        # the ops choose their paths against the room the op-by-op run had
        others = _held(r for k, r in resident.items() if k not in inputs)
        graph = torch.cuda.CUDAGraph()
        self._segment_mode = self._capturing = True
        try:
            with hoisted(keys), device_constants.recording() as constants, torch.cuda.graph(graph, stream=stream):
                keys.upload()
                self._run_ops(ops, local, budget - others, requested)
                outputs = [local[k].value for k in keep_list]
        finally:
            self._segment_mode = self._capturing = False
        after = _build.launch_counts()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        _build.add_launch_counts({k: -v for k, v in launches.items()})
        paths = self.stats - stats
        self.stats = stats
        pool = _pool_bytes(torch.cuda.memory_snapshot(), graph.pool())
        nbytes = pool + sum(_value_nbytes(v) for v in static.values()) + keys.nbytes
        return _Graph(graph, list(static.values()), keys, uploads, constants, tickets, outputs, launches, paths,
                      nbytes, dev)

    def _replay(self, entry: _Graph, in_keys, seeds, keep_list, keep, resident, budget) -> None:
        """Replay a cached graph for this plan: its static inputs refilled
        from the resident inputs, its pinned keys from this plan's seeds; the
        kept outputs cloned out of its pool."""
        entry.done.synchronize()  # the last replay's upload of the pinned keys has run
        entry.keys.fill(seeds)
        for k, static in zip(in_keys, entry.inputs):
            static.copy_(resident[k].value)
            resident[k].touch()
        entry.graph.replay()
        entry.done.record()
        _build.add_launch_counts(entry.launches)
        self.stats.update(entry.paths)
        for store, value in zip(keep_list, entry.outputs):
            self._admit(resident, store, value.clone(), keep[store], budget)

    # ------------------------------------------------------------------

    def _exec_rechunk(self, op, resident, budget) -> None:
        """A rechunk's copy op (the reference's ``_exec_rechunk``): a resident
        source is admitted again under the target's store (``rechunk_alias``;
        its chunking is the readers' metadata); a virtual one is made on the
        device (``rechunk_virtual``); a storage source is loaded whole when
        it fits in half the budget (``rechunk_loads``: an op outside a
        segment, as under ``fuse_plan=False``; a segment preloads its
        sources), else copied region by region on the host. A capture never
        gets this far with a storage source: the segment's pre-check
        requires every storage source resident."""
        config = op.pipeline.config
        src, dst = config.read.array, config.write.array
        res = resident.get(_key(src))
        if res is not None:
            res.touch()
            self.stats["rechunk_alias"] += 1
            self._admit(resident, _key(dst), res.value, dst, budget)
            return
        if isinstance(src, VirtualInMemoryArray):
            self.stats["rechunk_virtual"] += 1
            self._admit(resident, _key(dst), self._upload(src), dst, budget)
            return
        if isinstance(src, (VirtualEmptyArray, VirtualFullArray)):
            self.stats["rechunk_virtual"] += 1
            value = _virtual_block(src, tuple(src.shape)).contiguous()
            self._admit(resident, _key(dst), value, dst, budget)
            return
        if self._capturing:
            raise RuntimeError("a rechunk read storage under CUDA graph capture")
        opened = src.open() if isinstance(src, LazyZarrArray) else src
        if opened.dtype.fields is None and _nbytes_of(opened) < budget // 2:
            self.stats["rechunk_loads"] += 1
            data = opened[...] if opened.shape else opened[()]
            self._admit(resident, _key(dst), numpy_array_to_backend_array(data), dst, budget)
            return
        # the bounded host copy (the spill path), into a created target
        self.stats["rechunk_copies"] += 1
        if isinstance(dst, LazyZarrArray):
            dst.create()
        for m in op.pipeline.mappable:
            op.pipeline.function(m, config=config)

    def _exec_blockwise(self, op, resident, budget) -> None:
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
            # the task body reads its resident side inputs: on the card if
            # it takes tensors, else from storage
            views = {}
            for arr in side_inputs:
                res = resident.get(_key(arr))
                if res is None:
                    continue
                if getattr(f, "device_reads", False):
                    res.touch()
                    views[_key(arr)] = _ResidentView(res.value, arr, self._capturing)
                else:
                    self._flush(res)

        value = None
        no_block_id = not getattr(f, "needs_block_id", False) and not getattr(f, "host_block_id", False)
        if spec.shape_invariant and not spec.writes_rest and not getattr(f, "needs_block_id", False):
            value = self._exec_whole(op, spec, resident, out_shape)
        if value is None and no_block_id:
            if getattr(f, "batched", None) is not None:
                value = self._exec_batched(op, spec, budget)
            elif (route := self._fma_route(op)) is not None:
                value = self._exec_fma_blocks(route, spec, resident)
            else:
                value = self._exec_vmap(op, spec, resident, budget)
            if value is not None:
                self.stats["batched_ops"] += 1
        if value is None:
            with side_input_views(views if side_inputs else {}):
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

    def _apply_whole_select(self, value: torch.Tensor, selections) -> Optional[torch.Tensor]:
        """Per-axis selections (a (start, stop, step) triple or an integer
        array) applied to *value* on the card (:func:`_select`: positive
        steps as one view); None for a selection of another rank."""
        if len(selections) != value.ndim:
            return None
        return _select(value, selections, lambda positions: _index_tensor(positions, True, self._capturing))

    def _upload(self, arr: VirtualInMemoryArray) -> torch.Tensor:
        """A small literal array on the device, uploaded once per compute (a
        captured graph reads it as a constant)."""
        value = self._uploads.get(id(arr))
        if value is None:
            if self._capturing:
                raise RuntimeError("a host array first read under CUDA graph capture")
            value = self._uploads[id(arr)] = numpy_array_to_backend_array(arr.array)
        return value

    def _whole_value(self, arr, resident) -> Optional[torch.Tensor]:
        """*arr* whole on the device, when it is resident or virtual."""
        res = resident.get(_key(arr))
        if res is not None:
            res.touch()
            return res.value
        if isinstance(arr, VirtualInMemoryArray):
            return self._upload(arr)
        return _virtual_block(arr, tuple(arr.shape))

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
    # the batched paths
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
            and _nbytes_of(target) <= budget
        ):
            return self._failed_check("batched_errors")
        return batched(out_shape, chunks, seeds[0][1].base, get_device())

    def _exec_vmap(self, op, spec: BlockwiseSpec, resident, budget: int):
        """The general batched route (the reference's ``_exec_batched``): each
        bucket of tasks with one chunk-shape signature runs the op's function
        once under ``torch.func.vmap`` on grid views of its inputs, cut into
        pieces that the kernels and the budget take (:meth:`_bucket_tile`).
        None when the op does not batch (a 0-d output, one task, streamed or
        differing key structures, a ragged grid of too many buckets, a
        bucket whose inputs are all the same block, an input that is neither
        resident nor virtual); a failed metadata check (a function not
        declared batchable, a bucket that no piece of fits) also counts
        ``batched_errors`` and ``eager_fallbacks``."""
        out_shape = tuple(spec.write.array.shape)
        keys = list(op.pipeline.mappable)
        if not out_shape or len(keys) <= 1:
            return None
        structures = [spec.block_function(k) for k in keys]
        treedef, leaves0 = _flatten_keys(structures[0])
        if treedef is None:
            return None
        names = [k[0] for k in leaves0]
        task_leaves = [leaves0]
        for s in structures[1:]:
            td, leaves = _flatten_keys(s)
            if td != treedef or [k[0] for k in leaves] != names:
                return None  # the structure or a leaf's source varies across tasks
            task_leaves.append(leaves)
        metas = []
        for name in names:
            proxy = spec.reads_map.get(name)
            if proxy is None:
                return None
            metas.append((proxy.array, _chunkset(tuple(proxy.array.shape), proxy.chunks)))
        out_sets = [_chunkset(tuple(w.array.shape), w.chunks) for w in spec.writes]
        out_coords = np.array([k[1:] for k in keys], dtype=np.int64)
        buckets: Dict[tuple, list] = {}
        for t in range(len(keys)):
            sig = (_shape_at(out_sets[0], out_coords[t]),) + tuple(
                _shape_at(cs, k[1:]) for k, (_, cs) in zip(task_leaves[t], metas))
            buckets.setdefault(sig, []).append(t)
        if len(buckets) > max(8, len(keys) // 4):
            return None  # too ragged: batching would hardly help
        constant = {i for i, (arr, _) in enumerate(metas) if isinstance(arr, (VirtualEmptyArray, VirtualFullArray))}
        plans = [self._bucket_plan(tasks, out_coords, task_leaves, constant) for tasks in buckets.values()]
        if any(p is None for p in plans):
            return None
        wholes = {}
        for arr, _ in metas:
            if not isinstance(arr, (VirtualEmptyArray, VirtualFullArray, VirtualOffsetsArray)):
                value = self._whole_value(arr, resident)
                if value is None:
                    return None
                wholes[id(arr)] = value
        if not _batchable(spec.function):
            return self._failed_check("batched_errors")
        dev = _indexed(get_device())
        itemsize = max([8] + [np.dtype(a.dtype).itemsize for a, _ in metas]
                       + [np.dtype(w.array.dtype).itemsize for w in spec.writes])
        # each piece's intermediates: one per function of the op's tree, one
        # gathered copy per permuted leaf
        copies = max(sum(any(isinstance(e, _Permuted) for e in dims) for dims in plan[2]) for plan in plans)

        def cut():
            room = (budget - _held(resident.values()) - _GRAPHS.nbytes(dev)
                    - sum(_nbytes_of(w.array) for w in spec.writes))
            return [self._bucket_tile(plan, tasks, metas, task_leaves, out_sets, out_coords, wholes,
                                      room // ((_tree_size(spec.function) + copies) * itemsize))
                    for plan, tasks in zip(plans, buckets.values())]

        tiles = cut()
        whole = all(t is not None and list(t) == list(p[1]) for t, p in zip(tiles, plans))
        if not whole and not self._capturing and _GRAPHS.nbytes(dev):
            # cached graphs are a cache: dropped (least recently used, never
            # the running segment's) before an op is cut into pieces or fails
            _GRAPHS.shrink(dev, 0, keep=self._graph_key)
            tiles = cut()
        if any(t is None for t in tiles):
            return self._failed_check("batched_errors")
        fn = spec.function
        device_offsets = getattr(fn, "traced_offsets", False)

        def task(*flat):
            return fn(*_unflatten_keys(treedef, list(flat)))

        outs: list = [None] * len(spec.writes)
        for (levels, bucket_sizes, leaf_levels), bucket, tile in zip(plans, buckets.values(), tiles):
            for tasks, sizes in _tiles(bucket, bucket_sizes, tile):
                first = tuple(out_coords[tasks[0]])
                args, in_dims = [], []
                for i, ((arr, cs), dims) in enumerate(zip(metas, leaf_levels)):
                    value, dims_per_level = self._leaf(arr, cs, i, dims, tasks, task_leaves, len(levels),
                                                       sizes, wholes, device_offsets)
                    args.append(value)
                    in_dims.append(dims_per_level)
                batched = task
                for lvl in reversed(range(len(levels))):
                    level_dims = tuple(d[lvl] for d in in_dims)
                    if all(d is None for d in level_dims):
                        # no input varies along this level (a broadcast
                        # axis): its blocks are equal, computed once
                        batched = _repeated(batched, sizes[lvl])
                    else:
                        batched = torch.func.vmap(batched, in_dims=level_dims, out_dims=0)
                result = batched(*args)
                results = result if spec.writes_rest else (result,)
                for j, (w, cs, r) in enumerate(zip(spec.writes, out_sets, results)):
                    block = _shape_at(cs, first)
                    if tuple(r.shape) != tuple(sizes) + block:
                        return self._failed_check("batched_errors")
                    if outs[j] is None:
                        outs[j] = torch.empty(tuple(w.array.shape), dtype=r.dtype, device=r.device)
                    _grid_view(outs[j], cs, first, levels, sizes).copy_(r)
        return tuple(outs) if spec.writes_rest else outs[0]

    def _failed_check(self, counter: str) -> None:
        """Count a fast path's failed check; the op takes the next path."""
        self.stats[counter] += 1
        self.stats["eager_fallbacks"] += 1
        return None

    @staticmethod
    def _bucket_tile(plan, tasks, metas, task_leaves, out_sets, out_coords, wholes, max_elements):
        """The largest piece of a bucket that the hand kernels and the budget
        take, checked from metadata: ``(1, ..., 1, k, n_j+1, ...)`` blocks of
        the bucket's grid of ``n``. A piece fits when its grid views have at
        most eight axes (``region_sum``'s widest index), every resident
        input's grid view and the piece's largest tensor (its blocks of the
        largest input or output block, as a stacked Philox fill or an
        intermediate is) index in 32 bits, and that tensor, once for each
        function of the op's tree, fits the budget's room (*max_elements*
        elements of the widest dtype). None when one block does not fit."""
        levels, sizes, leaf_levels = plan
        first = tasks[0]
        blocks = [_shape_at(out_sets[j], out_coords[first]) for j in range(len(out_sets))]
        views = []
        for i, ((arr, cs), dims) in enumerate(zip(metas, leaf_levels)):
            block = _shape_at(cs, task_leaves[first][i][1:])
            blocks.append(block)
            # a permuted leaf is gathered by torch.index_select (64-bit
            # indices) into a copy of the piece's size
            if id(arr) in wholes and arr.shape and not any(isinstance(e, _Permuted) for e in dims):
                st = wholes[id(arr)].stride()
                followed = sorted((lvl, d) for d, lvl in enumerate(dims) if lvl is not None)
                views.append((block, st, followed))
        largest = max(math.prod(b) for b in blocks)
        rank = max(len(b) for b in blocks)

        def fits(tile) -> bool:
            elements = math.prod(tile) * largest
            if len(levels) + rank > _geometry.MAX_INDEX_DIMS or elements > max_elements:
                return False
            if elements >= _geometry.INDEX_LIMIT:
                return False
            return all(_geometry.index_fits(
                tuple(tile[lvl] for lvl, _ in followed) + block,
                [tuple(block[d] * st[d] for _, d in followed) + tuple(st)]) for block, st, followed in views)

        for j in range(len(sizes)):  # the largest k at the outermost level j that fits
            lo, hi = 0, sizes[j]
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if fits([1] * j + [mid] + list(sizes[j + 1:])):
                    lo = mid
                else:
                    hi = mid - 1
            if lo:
                return [1] * j + [lo] + list(sizes[j + 1:])
        return None

    @staticmethod
    def _bucket_plan(tasks, out_coords, task_leaves, constant=frozenset()):
        """(levels, sizes, per-leaf levels) of a bucket: the output axes it
        spans (one vmap level each, outermost first) and their block counts,
        and for each leaf, for each of its axes, the level it follows or None
        where it is constant. None when the bucket is not a dense grid of
        blocks, a leaf axis follows no level, or every leaf is the same block
        in every task or a virtual constant (leaves *constant*: their blocks
        are made, not read), as the reference does not batch such an op."""
        coords = out_coords[tasks]
        levels, sizes, ranges = [], [], []
        for a in range(coords.shape[1]):
            vals = np.unique(coords[:, a])
            if vals.size > 1:
                if vals[-1] - vals[0] + 1 != vals.size:
                    return None
                levels.append(a)
                sizes.append(int(vals.size))
                ranges.append(range(int(vals[0]), int(vals[-1]) + 1))
        if math.prod(sizes) != len(tasks) or not np.array_equal(
                coords[:, levels], np.array(list(itertools.product(*ranges)), dtype=np.int64).reshape(len(tasks), -1)):
            return None
        leaf_levels = []
        varies = False
        for i in range(len(task_leaves[tasks[0]])):
            lc = np.array([task_leaves[t][i][1:] for t in tasks], dtype=np.int64).reshape(len(tasks), -1)
            dims, used = [], set()
            for d in range(lc.shape[1]):
                col = lc[:, d]
                if (col == col[0]).all():
                    dims.append(None)
                    continue
                lvl = next((l for l, a in enumerate(levels) if np.array_equal(col, coords[:, a])), None)
                entry = lvl
                if lvl is None:
                    entry = CudaExecutor._permuted_level(col, coords, levels, used)
                    lvl = entry.level if entry is not None else None
                if lvl is None or lvl in used:
                    return None
                used.add(lvl)
                dims.append(entry)
                varies = varies or i not in constant
            leaf_levels.append(dims)
        return (levels, sizes, leaf_levels) if varies else None

    @staticmethod
    def _permuted_level(col, coords, levels, used) -> Optional[_Permuted]:
        """The level whose coordinate *col* (a leaf axis's block coordinate,
        task by task) is a one-to-one function of, or None."""
        for lvl, a in enumerate(levels):
            if lvl in used:
                continue
            mapping = {}
            for v, p in zip(coords[:, a].tolist(), col.tolist()):
                if mapping.setdefault(v, p) != p:
                    break
            else:
                if len(set(mapping.values())) == len(mapping):
                    return _Permuted(lvl, mapping)
        return None

    def _leaf(self, arr, chunkset, i, dims, tasks, task_leaves, nlevels, sizes, wholes, device_offsets=False):
        """Leaf *i*'s value for a bucket and its in_dims per vmap level: the
        carrier for a virtual template or constant, the seeds as a CPU int64
        tensor (on the device with *device_offsets*), a grid view of a whole
        tensor."""
        followed = sorted((_level_of(e), d) for d, e in enumerate(dims) if e is not None)
        per_level = [0 if any(lvl == l for lvl, _ in followed) else None for l in range(nlevels)]
        first = tuple(task_leaves[tasks[0]][i][1:])
        permuted = {d: e for d, e in enumerate(dims) if isinstance(e, _Permuted)}
        block = _virtual_block(arr, _shape_at(chunkset, first))
        if block is not None:
            return block, [None] * nlevels
        if permuted and not isinstance(arr, VirtualOffsetsArray):
            return self._permuted_leaf(arr, chunkset, first, followed, permuted, tasks, task_leaves, i, sizes,
                                       wholes), per_level
        if isinstance(arr, VirtualOffsetsArray) and device_offsets and not arr.base and not permuted:
            # block offsets read as data by the op's own function (arange's,
            # an arg reduction's): made on the device from the bucket's
            # grid, so a capture holds no host-to-device copy (a random
            # op's seeds, a seeded offsets array, stay on the host: Philox
            # keys them there)
            strides = [math.prod(arr.shape[d + 1:]) for d in range(len(arr.shape))]
            offsets = torch.full((), arr.base + (int(np.ravel_multi_index(first, arr.shape)) if arr.shape else 0),
                                 dtype=torch.int64, device=get_device())
            kept = [lvl for lvl in range(nlevels) if per_level[lvl] == 0]
            for pos, lvl in enumerate(kept):
                d = next(d for f_lvl, d in followed if f_lvl == lvl)
                step = torch.arange(sizes[lvl], dtype=torch.int64, device=offsets.device) * strides[d]
                offsets = offsets + step.reshape([-1 if q == pos else 1 for q in range(len(kept))])
            return offsets.reshape(tuple(sizes[lvl] for lvl in kept) + (1,) * len(arr.shape)), per_level
        if isinstance(arr, VirtualOffsetsArray):
            coords = np.array([task_leaves[t][i][1:] for t in tasks], dtype=np.int64).reshape(len(tasks), -1)
            flat = arr.base + (np.ravel_multi_index(tuple(coords.T), arr.shape) if arr.shape else 0)
            grid = np.broadcast_to(flat, (len(tasks),)).reshape(sizes)
            grid = grid[tuple(slice(None) if per_level[l] == 0 else 0 for l in range(nlevels))]
            seeds = np.array(grid, dtype=np.int64).reshape(grid.shape + (1,) * len(arr.shape))
            if device_offsets and not arr.base:
                # a permuted grid of block offsets read as data (a fused
                # partner's): uploaded once, by its contents
                return _permutation_tensor(seeds), per_level
            return torch.from_numpy(seeds), per_level
        value = wholes[id(arr)]
        if not arr.shape:
            return value, [None] * nlevels
        return _grid_view(value, chunkset, first, [d for _, d in followed],
                          [sizes[lvl] for lvl, _ in followed]), per_level

    def _permuted_leaf(self, arr, chunkset, first, followed, permuted, tasks, task_leaves, i, sizes, wholes):
        """A resident leaf some of whose axes follow a level permuted: the
        grid view over each permuted axis's span of blocks for the piece,
        then ``torch.index_select`` of the piece's blocks in level order (a
        copy of the piece's size; the positions uploaded once)."""
        value = wholes[id(arr)]
        coords = np.array([task_leaves[t][i][1:] for t in tasks], dtype=np.int64).reshape(len(tasks), -1)
        start = list(first)
        spans, picks = [], {}
        for pos, (lvl, d) in enumerate(followed):
            if d in permuted:
                col = coords[:, d]
                lo = int(col.min())
                start[d] = lo
                spans.append(int(col.max()) - lo + 1)
                # the leaf's block at each of the level's positions in the
                # piece (the level's coordinates ascending, as vmap stacks)
                inverse = {p: v for v, p in permuted[d].mapping.items()}
                level_values = sorted({inverse[p] for p in col.tolist()})
                picks[pos] = np.array([permuted[d].mapping[v] - lo for v in level_values], dtype=np.int64)
            else:
                spans.append(sizes[lvl])
        view = _grid_view(value, chunkset, tuple(start), [d for _, d in followed], spans)
        for pos, positions in picks.items():
            view = torch.index_select(view, pos, _permutation_tensor(positions))
        return view

    # ------------------------------------------------------------------
    # the fusion rule: a fused multiply-add reduction goes to fma_sum
    # ------------------------------------------------------------------

    def _fma_route(self, op):
        """For an initial ``sum``/``mean`` over every axis of
        ``add(multiply(p, q), multiply(r, s))``, with p, q, r, s plain reads
        of one float dtype and one chunking, each at the output block's
        coordinates in every task: (the reduction, the names of p, q, r, s);
        None for any other op."""
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
        names = None
        for out_key in op.pipeline.mappable:
            structure = spec.block_function(out_key)
            if not (
                len(structure) == 1
                and isinstance(structure[0], PredKeys)
                and len(structure[0]) == 2
                and all(isinstance(m, PredKeys) and len(m) == 2 for m in structure[0])
                and all(_is_key(k) and tuple(k[1:]) == tuple(out_key[1:]) for m in structure[0] for k in m)
            ):
                return None
            got = [k[0] for m in structure[0] for k in m]
            if names is None:
                names = got
            elif got != names:
                return None
        proxies = [spec.reads_map[n] for n in names]
        arrays = [p.array for p in proxies]
        if not (
            arrays[0].dtype in (np.dtype(np.float64), np.dtype(np.float32))
            and all(a.dtype == arrays[0].dtype and tuple(a.shape) == tuple(arrays[0].shape) for a in arrays)
            and all(p.chunks == proxies[0].chunks for p in proxies)
            and 0 < len(arrays[0].shape) <= 4
            and sorted(root.axis) == list(range(len(arrays[0].shape)))
        ):
            return None
        return root, names

    def _fma_fields(self, root, total: torch.Tensor, counts, out_dtype):
        """The reduction's output from its float64 totals: the sum, or mean's
        fields (*counts*: a callable giving ``n`` in *total*'s shape)."""
        if root.reduce_kind == "sum":
            return total.to(out_dtype)
        fields = {"n": counts(), "total": total}
        return tuple(fields[k] for k in root.fields)

    def _exec_fma_blocks(self, route, spec: BlockwiseSpec, resident):
        """Every block of the fused multiply-add reduction in one
        ``fma_sum_blocks`` launch on the whole resident inputs, or None when
        one of them is not resident (the op then runs block by block). When
        the launch cannot index the inputs in 32 bits, a failed check counts
        ``batched_errors`` and ``eager_fallbacks``."""
        root, names = route
        proxies = [spec.reads_map[n] for n in names]
        wholes = [self._whole_value(p.array, resident) for p in proxies]
        if any(w is None for w in wholes):
            return None
        chunks = tuple(proxies[0].chunks)
        if not _geometry.fma_blocks_fit(tuple(wholes[0].shape), [tuple(w.stride()) for w in wholes], chunks):
            return self._failed_check("batched_errors")
        total = fma_sum_blocks(*wholes, chunks)  # the (nb0, nb1, ...) grid: the output's shape
        chunkset = _chunkset(tuple(proxies[0].array.shape), chunks)
        return self._fma_fields(root, total, lambda: _block_counts(chunkset, total.device),
                                to_torch_dtype(spec.write.array.dtype))

    def _fma_block(self, route, spec: BlockwiseSpec):
        """The chunked path's form of the fusion rule: one block's result
        with ``fma_sum`` (``fma_sum_blocks`` on a grid of one block)."""
        root, _ = route
        out_dtype = to_torch_dtype(spec.write.array.dtype)

        def fma_block(structure, resident):
            p, q, r, s = [self._resolve(k, spec, resident) for m in structure[0] for k in m]
            total = fma_sum(p, q, r, s)
            return self._fma_fields(root, total, lambda: torch.full(
                total.shape, p.numel(), dtype=torch.int64, device=total.device), out_dtype)

        return fma_block

    # ------------------------------------------------------------------

    def _exec_chunked(self, op, spec: BlockwiseSpec, resident):
        """Per-output-block execution on block views of resident inputs."""
        f = spec.function
        needs_block_id = getattr(f, "needs_block_id", False)
        region_fn = getattr(f, "combine_region", None)
        route = self._fma_route(op)
        fma_block = self._fma_block(route, spec) if route is not None else None
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
        block = _virtual_block(arr, tuple(s.stop - s.start for s in sel))
        if block is not None:
            return block
        if isinstance(arr, VirtualOffsetsArray):
            # host metadata: seeds and block ids; a seed in a segment on the
            # card a host tensor, so a random block draws its key from the
            # hoisted table (a key passed by value would be baked into the graph)
            block = np.asarray(arr[sel])
            return torch.from_numpy(block) if self._segment_mode and arr.base else block
        if isinstance(arr, VirtualInMemoryArray):
            return self._upload(arr)[sel]
        opened = proxy.open()
        return get_chunk(opened, _chunkset(tuple(opened.shape), proxy.chunks), coords)

    # ------------------------------------------------------------------
    # residency bookkeeping
    # ------------------------------------------------------------------

    def _admit(self, resident, store: str, value: torch.Tensor, target, budget) -> None:
        """Make *value* the resident array of *store* (in the target's dtype,
        as a store write would, narrowed under the narrowing scope), within
        *budget* with the cached graphs of the device: graphs are dropped
        first (least recently used, never the running segment's), then
        others spill. A value whose storage is already resident (an alias, a
        view) adds no bytes."""
        dtype = to_torch_dtype(target.dtype)
        if value.dtype != dtype:
            value = value.to(dtype)
        res = _Resident(value, target)
        if not self._capturing:
            # cached graphs (for later computes) make room before resident
            # arrays (of this one) spill
            held = _held([r for k, r in resident.items() if k != store] + [res])
            _GRAPHS.shrink(value.device, budget - held, keep=self._graph_key)
            self._evict(resident, budget - _GRAPHS.nbytes(value.device), res, exclude=store)
        resident[store] = res

    def _evict(self, resident, budget: int, incoming: _Resident, exclude: str) -> None:
        """Spill least recently used storages until what stays resident, with
        *incoming* (to be admitted under *exclude*), fits in *budget*. A
        storage spills whole: every name that holds it is written to its
        target and dropped together, since dropping one name alone would
        free nothing; the storage *incoming* holds never spills."""

        def held() -> int:
            return _held([r for k, r in resident.items() if k != exclude] + [incoming])

        if held() <= budget:
            return
        names: Dict[int, list] = {}
        for store, res in resident.items():
            if store != exclude and res.storage != incoming.storage:
                names.setdefault(res.storage, []).append(store)
        for stores in sorted(names.values(), key=lambda ks: max(resident[k].last_used for k in ks)):
            for store in stores:
                self._flush(resident.pop(store))
            if held() <= budget:
                return

    @staticmethod
    def _flush(res: _Resident) -> None:
        """Write a resident array to its Zarr target, chunk by chunk, in the
        target's declared dtype (a narrowed value widens here)."""
        target = res.target
        if isinstance(target, LazyZarrArray):
            concrete = target.create()
        elif isinstance(target, ZarrV2Array):
            concrete = target
        else:
            return
        shape = tuple(concrete.shape)
        if not shape:
            concrete[()] = backend_array_to_numpy_array(res.value).astype(concrete.dtype)
            return
        chunkset = _chunkset(shape, tuple(concrete.chunks))
        for idx in itertools.product(*(range(len(c)) for c in chunkset)):
            sel = get_item(chunkset, idx)
            concrete[sel] = backend_array_to_numpy_array(res.value[sel]).astype(concrete.dtype)
