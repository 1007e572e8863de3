"""K4: the sort network's block kernels (``csrc/merge_sort.cu``).

- :func:`sort_block`: a stable ascending sort of every lane of a block along
  an axis, values alone or with int64 indices carried beside them (the pair
  (value, index) is then the key). The network's local round and the
  single-chunk ``sort``.
- :func:`argsort_block`: the stable ascending argsort along an axis (int64).
  The single-chunk ``argsort`` and top-k's per-block order.
- :func:`merge_split`: the network's compare-exchange: two sorted blocks
  merged, the low or the high half kept, per lane group, by ``take_low``.

The order is numpy's and XLA's: ascending, NaN after every number (all
NaNs equal), -0.0 equal to 0.0, equal values in their first order; the
original bits come out (a -0.0 or a NaN payload as it went in). The JAX
package computes these with ``jnp.sort``/``jnp.argsort``/``jnp.lexsort``
outside any Pallas kernel (``cubed_tpu/array_api/_block_sort.py:210``,
``:220``, ``sorting_functions.py:249``). On the card ``torch.sort`` takes
int64 indices beside its values, and a lane longer than 4096 elements
leaves its in-place sort of short lanes for CUB's segmented sort, with a
transposed copy of a non-innermost axis and CUB's scratch: a task then goes
past the memory its plan projects (``chip_smoke.py``'s sequential check
reads both bodies along a 16384-step axis). These kernels take none.

A sort or an argsort is a tile sort in shared memory (a CTA sorts ``tile``
positions of ``lanes`` neighbouring lanes, rows of contiguous elements in
and out: each warp sorts runs of 256 of a lane in registers by a bitonic
network, then merge-path merges in shared memory up to the tile), then,
for a lane longer than a tile, ``ceil(log2(ceil(n / tile)))`` merge passes
over sorted runs (a merge-path split per lane and CTA, both segments
merged in shared memory). The geometry is ``_geometry.sort_plan``; a
float64 block of (512, 256, 256) along axis 0 is one launch. A merge-split
is one launch too, a tiled merge-path pass (``_geometry.split_plan``): a
CTA owns ``tile`` consecutive outputs of the kept half of ``lanes``
neighbouring lanes, finds each lane's split of the pair at both ends of its
range by merge path, loads both segments into shared memory in rows (a
32-byte sector of neighbouring lanes at a time), merges there and writes
rows out; a (512, 256, 256) float64 pair is 8192 CTAs of 256 x 16, four an
SM. Task memory on the card: a lane within a tile, the input
and the output (argsort: its int64 positions); a longer lane, the input and
two buffers (with indices, two of each; argsort, two int64 position
buffers, its passes gathering each position's value from the input once a
pass); merge-split, the inputs and the output.

Every function takes any strided tensor (a non-contiguous one is copied
first) and has a ``torch.func.vmap`` batching rule (custom ops): the batch
axes become lanes of the same launches.

Bound on the H100: bytes, the block read once and the output written once
(3.35 TB/s); a merge-split's kept half is ``x[0:i] ++ y[0:n-i]`` (or the
other end), so one block read and one written, as a sort's.

The plain versions (``*_plain``) are ``torch.sort``/``torch.argsort`` with
``stable=True`` (the pair order by :func:`lexsort_plain`); the wrappers use
them only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build, _geometry

#: dtypes the kernels take, with the code their C entry points expect
DTYPES = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3, torch.int16: 4,
          torch.int8: 5, torch.uint8: 6}


def _check(x: torch.Tensor, what: str) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"{what} takes {sorted(str(d) for d in DTYPES)}, not {x.dtype}")


def _lanes(shape, axis: int) -> tuple[int, int, int]:
    return math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:])


def _batched(*ts) -> bool:
    return any(t is not None and torch._C._functorch.is_batchedtensor(t) for t in ts)


# ---------------------------------------------------------------------------
# sort_block
# ---------------------------------------------------------------------------


def sort_block(x: torch.Tensor, axis: int, idx: Optional[torch.Tensor] = None):
    """*x* sorted along *axis* (stable, NaN last); with *idx* (int64, x's
    shape) the pairs (value, index) sorted and ``(values, indices)``
    returned. A CUDA tensor goes to the kernel, a CPU tensor to the plain
    version."""
    _check(x, "sort_block")
    axis = int(axis) % x.ndim
    if idx is None:
        if _batched(x):
            return _sort_op(x, axis)
        return _sort(x, axis)
    if _batched(x, idx):
        return _sort_pairs_op(x, idx, axis)
    return _sort_pairs(x, idx, axis)


def _run_sort(x: torch.Tensor, axis: int, idx: Optional[torch.Tensor], mode: str):
    """One sort on the card: the tile sort, then the plan's merge passes.
    *mode*: ``values``, ``pairs`` (with *idx*) or ``argsort`` (returns the
    int64 positions)."""
    outer, n, inner = _lanes(tuple(x.shape), axis)
    x = x.contiguous()
    idx = idx.contiguous() if idx is not None else None
    p = _geometry.sort_plan(outer, n, inner, x.element_size(), mode, x.data_ptr())
    with_vals, with_idx = mode != "argsort", mode != "values"

    def buffers():
        return (torch.empty_like(x) if with_vals else None,
                torch.empty(x.shape, dtype=torch.int64, device=x.device) if with_idx else None)

    def result(v, i):
        return v if mode == "values" else i if mode == "argsort" else (v, i)

    if not p.tiles:
        return result(*buffers())
    lib = _kernel(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code, dtype = ctypes.c_int(p.mode), ctypes.c_int(DTYPES[x.dtype])
    shifts = (ctypes.c_int(p.tile.bit_length() - 1), ctypes.c_int(p.lanes.bit_length() - 1))
    work = (ctypes.c_longlong(p.tiles_n), ctypes.c_longlong(p.lane_groups), ctypes.c_longlong(p.tiles))
    counter = argsort_block if mode == "argsort" else sort_block
    bufs = [buffers()] + ([buffers()] if p.widths else [])
    with torch.cuda.device(x.device):
        out, outi = bufs[0]
        err = lib.sort_tiles(dtype, code, _ptr(x), _ptr(idx), _ptr(out), _ptr(outi), ctypes.c_longlong(n),
                             ctypes.c_longlong(inner), *shifts, ctypes.c_int(p.vector), *work, ctypes.c_int(p.grid),
                             _regions(p.tile_regions), ctypes.c_int(p.tile_smem), ctypes.c_int(bool(p.widths)),
                             ctypes.c_void_p(stream))
        _build.check(err, "sort_tiles")
        _counted(counter, mode)
        for k, w in enumerate(p.widths):
            (src, srci), (out, outi) = bufs[k % 2], bufs[1 - k % 2]
            err = lib.sort_merge(dtype, code, _ptr(x), _ptr(src), _ptr(srci), _ptr(out), _ptr(outi),
                                 ctypes.c_longlong(n), ctypes.c_longlong(inner), *shifts, *work, ctypes.c_longlong(w),
                                 ctypes.c_int(p.grid), _regions(p.merge_regions), ctypes.c_int(p.merge_smem),
                                 ctypes.c_int(k == len(p.widths) - 1), ctypes.c_void_p(stream))
            _build.check(err, "sort_merge")
            _counted(counter, mode)
    return result(out, outi)


def _counted(counter, mode: str) -> None:
    """One launch of a sort kernel, on its wrapper's count (and sort_block's
    path)."""
    with _build.COUNT_LOCK:
        counter.launches += 1
        if mode != "argsort":
            sort_block.paths[mode] += 1


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _regions(offsets) -> ctypes.Array:
    """The plan's shared-memory region offsets (``_geometry.SORT_REGIONS``)
    as the C array the sort kernels' entry points take."""
    return (ctypes.c_int * len(_geometry.SORT_REGIONS))(*offsets)


def _device_call(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); raises on any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{what}: unsupported device {x.device}")


def _sort(x, axis):
    if not _device_call(x, "sort_block"):
        return x.new_empty(x.shape) if x.device.type == "meta" else sort_block_plain(x, axis)
    return _run_sort(x, axis, None, "values")


def _sort_pairs(x, idx, axis):
    if not _device_call(x, "sort_block"):
        if x.device.type == "meta":
            return x.new_empty(x.shape), idx.new_empty(idx.shape)
        return sort_block_plain(x, axis, idx)
    return _run_sort(x, axis, idx.to(torch.int64), "pairs")


@torch.library.custom_op("cubed_tpu_torch::sort_block", mutates_args=())
def _sort_op(x: torch.Tensor, axis: int) -> torch.Tensor:
    return _sort(x, axis)


@_sort_op.register_fake
def _sort_fake(x, axis):
    return x.new_empty(x.shape)


@torch.library.register_vmap("cubed_tpu_torch::sort_block")
def _sort_vmap(info, in_dims, x, axis):
    (d, _) = in_dims
    if d is None:
        return _sort_op(x, axis), None
    return _sort_op(x.movedim(d, 0), axis + 1), 0


@torch.library.custom_op("cubed_tpu_torch::sort_block_pairs", mutates_args=())
def _sort_pairs_op(x: torch.Tensor, idx: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    return _sort_pairs(x, idx, axis)


@_sort_pairs_op.register_fake
def _sort_pairs_fake(x, idx, axis):
    return x.new_empty(x.shape), idx.new_empty(idx.shape)


def _front(ts, dims, size: int):
    """Each batched tensor's batch axis to the front, an unbatched one
    expanded along a new front axis of *size*."""
    return [t.movedim(d, 0) if d is not None else t.unsqueeze(0).expand((size,) + tuple(t.shape))
            for t, d in zip(ts, dims)]


@torch.library.register_vmap("cubed_tpu_torch::sort_block_pairs")
def _sort_pairs_vmap(info, in_dims, x, idx, axis):
    dx, di, _ = in_dims
    if dx is None and di is None:
        return _sort_pairs_op(x, idx, axis), (None, None)
    x, idx = _front([x, idx], [dx, di], info.batch_size)
    return _sort_pairs_op(x, idx, axis + 1), (0, 0)


def sort_block_plain(x: torch.Tensor, axis: int, idx: Optional[torch.Tensor] = None):
    """The plain version of :func:`sort_block`: ``torch.sort`` (stable), the
    pairs by :func:`lexsort_plain`."""
    if idx is None:
        return torch.sort(x, dim=axis, stable=True).values
    order = lexsort_plain([idx, x], axis)
    return torch.take_along_dim(x, order, dim=axis), torch.take_along_dim(idx.to(torch.int64), order, dim=axis)


def lexsort_plain(keys, axis: int) -> torch.Tensor:
    """numpy's ``lexsort`` along *axis* (the last key primary): stable sorts
    from the least significant key up. Memory: a permutation (int64), one
    gathered key and one stable sort's output and scratch at a time."""
    perm = None
    for key in keys:
        k = key if perm is None else torch.take_along_dim(key, perm, dim=axis)
        step = torch.sort(k, dim=axis, stable=True).indices
        perm = step if perm is None else torch.take_along_dim(perm, step, dim=axis)
    return perm


#: launches of the sort kernels (the tile sort and each merge pass) for
#: sort_block, by path: "values" or "pairs" (indices carried)
sort_block.launches = 0
sort_block.paths = {"values": 0, "pairs": 0}
_build.COUNTED.append(sort_block)


# ---------------------------------------------------------------------------
# argsort_block
# ---------------------------------------------------------------------------


def argsort_block(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The stable ascending argsort of *x* along *axis* (int64, NaN last). A
    CUDA tensor goes to the kernel, a CPU tensor to the plain version."""
    _check(x, "argsort_block")
    axis = int(axis) % x.ndim
    if _batched(x):
        return _argsort_op(x, axis)
    return _argsort(x, axis)


def _argsort(x, axis):
    if not _device_call(x, "argsort_block"):
        if x.device.type == "meta":
            return x.new_empty(x.shape, dtype=torch.int64)
        return argsort_block_plain(x, axis)
    return _run_sort(x, axis, None, "argsort")


@torch.library.custom_op("cubed_tpu_torch::argsort_block", mutates_args=())
def _argsort_op(x: torch.Tensor, axis: int) -> torch.Tensor:
    return _argsort(x, axis)


@_argsort_op.register_fake
def _argsort_fake(x, axis):
    return x.new_empty(x.shape, dtype=torch.int64)


@torch.library.register_vmap("cubed_tpu_torch::argsort_block")
def _argsort_vmap(info, in_dims, x, axis):
    (d, _) = in_dims
    if d is None:
        return _argsort_op(x, axis), None
    return _argsort_op(x.movedim(d, 0), axis + 1), 0


def argsort_block_plain(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The plain version of :func:`argsort_block`: ``torch.argsort``, stable."""
    return torch.argsort(x, dim=axis, stable=True)


#: launches of the sort kernels (the tile sort and each merge pass) for
#: argsort_block
argsort_block.launches = 0
argsort_block.paths = {}
_build.COUNTED.append(argsort_block)


# ---------------------------------------------------------------------------
# merge_split
# ---------------------------------------------------------------------------


def merge_split(x: torch.Tensor, y: torch.Tensor, take_low, axis: int, xi: Optional[torch.Tensor] = None,
                yi: Optional[torch.Tensor] = None):
    """The low (where *take_low*) or high half of the merge of *x*'s and
    *y*'s lanes along *axis*, both sorted ascending and of one shape: the
    values, or ``(values, indices)`` with the int64 indices *xi* and *yi*
    carried (the pair (value, index) then the key). *take_low* is a bool
    tensor broadcast against *x* (right-aligned); each lane group (the
    elements sharing their coordinates before *axis*) reads it where its
    coordinates from *axis* on are 0. A CUDA tensor goes to the kernel, a
    CPU tensor to the plain version."""
    _check(x, "merge_split")
    if x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError(f"merge_split takes two blocks of one shape and dtype, not {x.shape} {x.dtype} and "
                         f"{y.shape} {y.dtype}")
    axis = int(axis) % x.ndim
    take_low = torch.as_tensor(take_low, device=x.device)
    if xi is None:
        if _batched(x, y, take_low):
            return _split_op(x, y, take_low, axis)
        return _split(x, y, take_low, axis)
    if _batched(x, y, xi, yi, take_low):
        return _split_pairs_op(x, y, xi, yi, take_low, axis)
    return _split_pairs(x, y, xi, yi, take_low, axis)


def _flags(take_low: torch.Tensor, shape, axis: int) -> tuple[torch.Tensor, int]:
    """One flag per lane group: *take_low* right-aligned to *shape*, read at
    coordinate 0 from *axis* on, as (a 1-D bool or uint8 tensor, the stride
    between lane groups' flags). A view where the broadcast flags lie at one
    stride (one flag, or a vmapped batch's flag an example): no kernel runs
    for them; else a copy."""
    t = take_low.reshape((1,) * (len(shape) - take_low.ndim) + tuple(take_low.shape))
    t = t[(slice(None),) * axis + (slice(0, 1),) * (len(shape) - axis)]
    t = t.expand(tuple(shape[:axis]) + (1,) * (len(shape) - axis)).reshape(-1)
    if t.dtype not in (torch.bool, torch.uint8):
        t = t.to(torch.uint8)
    return t, t.stride(0) if t.numel() > 1 else 0


def _launch_split(x, y, xi, yi, take_low, axis):
    """One merge-split on the card: one launch of the plan's tiles
    (``_geometry.split_plan``)."""
    outer, n, inner = _lanes(tuple(x.shape), axis)
    x, y = x.contiguous(), y.contiguous()
    mode = "values" if xi is None else "pairs"
    out = torch.empty_like(x)
    outi = None
    if xi is not None:
        xi, yi = xi.to(torch.int64).contiguous(), yi.to(torch.int64).contiguous()
        outi = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    p = _geometry.split_plan(outer, n, inner, x.element_size(), mode)
    if not p.tiles:
        return out if xi is None else (out, outi)
    flags, flag_stride = _flags(take_low, tuple(x.shape), axis)
    lib = _kernel(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    shifts = [ctypes.c_int(v.bit_length() - 1) for v in (p.tile, p.lanes, p.sector)]
    with torch.cuda.device(x.device):
        err = lib.merge_split(ctypes.c_int(DTYPES[x.dtype]), ctypes.c_int(p.mode), _ptr(x), _ptr(y), _ptr(xi),
                              _ptr(yi), _ptr(flags), ctypes.c_longlong(flag_stride), _ptr(out), _ptr(outi),
                              ctypes.c_longlong(n), ctypes.c_longlong(inner), *shifts, ctypes.c_longlong(p.tiles_n),
                              ctypes.c_longlong(p.lane_groups), ctypes.c_longlong(p.tiles), ctypes.c_int(p.grid),
                              _regions(p.regions), ctypes.c_int(p.smem), ctypes.c_void_p(stream))
        _build.check(err, "merge_split")
        with _build.COUNT_LOCK:
            merge_split.launches += 1
            merge_split.paths[mode] += 1
    return out if xi is None else (out, outi)


def _split(x, y, take_low, axis):
    if not _device_call(x, "merge_split"):
        return x.new_empty(x.shape) if x.device.type == "meta" else merge_split_plain(x, y, take_low, axis)
    return _launch_split(x, y, None, None, take_low, axis)


def _split_pairs(x, y, xi, yi, take_low, axis):
    if not _device_call(x, "merge_split"):
        if x.device.type == "meta":
            return x.new_empty(x.shape), x.new_empty(x.shape, dtype=torch.int64)
        return merge_split_plain(x, y, take_low, axis, xi, yi)
    return _launch_split(x, y, xi, yi, take_low, axis)


def _lead(t: torch.Tensor, d, rank: int) -> torch.Tensor:
    """A batched flag's batch axis to the front, above the per-example
    rank's right alignment (so a 0-d flag per example becomes (B, 1, ...))."""
    t = t.movedim(d, 0)
    return t.reshape(t.shape[:1] + (1,) * (rank - (t.ndim - 1)) + t.shape[1:])


@torch.library.custom_op("cubed_tpu_torch::merge_split", mutates_args=())
def _split_op(x: torch.Tensor, y: torch.Tensor, take_low: torch.Tensor, axis: int) -> torch.Tensor:
    return _split(x, y, take_low, axis)


@_split_op.register_fake
def _split_fake(x, y, take_low, axis):
    return x.new_empty(x.shape)


@torch.library.register_vmap("cubed_tpu_torch::merge_split")
def _split_vmap(info, in_dims, x, y, take_low, axis):
    dx, dy, dt, _ = in_dims
    if dx is None and dy is None and dt is None:
        return _split_op(x, y, take_low, axis), None
    rank = x.ndim - (dx is not None)
    x, y = _front([x, y], [dx, dy], info.batch_size)
    take_low = _lead(take_low, dt, rank) if dt is not None else take_low
    return _split_op(x, y, take_low, axis + 1), 0


@torch.library.custom_op("cubed_tpu_torch::merge_split_pairs", mutates_args=())
def _split_pairs_op(x: torch.Tensor, y: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor, take_low: torch.Tensor,
                    axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    return _split_pairs(x, y, xi, yi, take_low, axis)


@_split_pairs_op.register_fake
def _split_pairs_fake(x, y, xi, yi, take_low, axis):
    return x.new_empty(x.shape), x.new_empty(x.shape, dtype=torch.int64)


@torch.library.register_vmap("cubed_tpu_torch::merge_split_pairs")
def _split_pairs_vmap(info, in_dims, x, y, xi, yi, take_low, axis):
    dx, dy, dxi, dyi, dt, _ = in_dims
    if all(d is None for d in (dx, dy, dxi, dyi, dt)):
        return _split_pairs_op(x, y, xi, yi, take_low, axis), (None, None)
    rank = x.ndim - (dx is not None)
    x, y, xi, yi = _front([x, y, xi, yi], [dx, dy, dxi, dyi], info.batch_size)
    take_low = _lead(take_low, dt, rank) if dt is not None else take_low
    return _split_pairs_op(x, y, xi, yi, take_low, axis + 1), (0, 0)


def merge_split_plain(x, y, take_low, axis: int, xi=None, yi=None):
    """The plain version of :func:`merge_split`: the two blocks concatenated
    and sorted (:func:`sort_block_plain`), then each lane group's half."""
    n = x.shape[axis]
    cat = torch.cat([x, y], dim=axis)
    if xi is None:
        merged = sort_block_plain(cat, axis)
    else:
        merged, mi = sort_block_plain(cat, axis, torch.cat([xi.to(torch.int64), yi.to(torch.int64)], dim=axis))
    low = torch.as_tensor(take_low, device=x.device).to(torch.bool)
    low = low.reshape((1,) * (x.ndim - low.ndim) + tuple(low.shape))
    low = low[(slice(None),) * axis + (slice(0, 1),) * (x.ndim - axis)]
    out = torch.where(low, merged.narrow(axis, 0, n), merged.narrow(axis, n, n))
    if xi is None:
        return out
    return out, torch.where(low, mi.narrow(axis, 0, n), mi.narrow(axis, n, n))


#: launches of the merge-split kernel, by path: "values" or "pairs"
merge_split.launches = 0
merge_split.paths = {"values": 0, "pairs": 0}
_build.COUNTED.append(merge_split)


_READY: set = set()


def _kernel(device=None):
    """The loaded library; with *device*, its sort kernels allowed their
    dynamic shared memory there first (once a device, outside any capture:
    the first sort on a device runs before any graph that holds one)."""
    lib = _library()
    if device is not None and device.index not in _READY:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("merge_sort: a device's first sort inside a CUDA-graph capture")
        with torch.cuda.device(device):
            _build.check(lib.merge_sort_init(), "merge_sort_init")
        _READY.add(device.index)
    return lib


@functools.cache
def _library():
    lib = _build.load("merge_sort")
    lib.merge_sort_init.argtypes = []
    lib.merge_sort_init.restype = ctypes.c_int
    lib.sort_tiles.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.sort_tiles.restype = ctypes.c_int
    lib.sort_merge.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.sort_merge.restype = ctypes.c_int
    lib.merge_split.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
    ]
    lib.merge_split.restype = ctypes.c_int
    return lib
