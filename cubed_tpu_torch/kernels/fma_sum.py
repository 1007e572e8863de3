"""K3: ``sum(a*x + b*y)`` of every block of a blocked grid of four
equal-shaped tensors (:func:`fma_sum_blocks`), or of the whole tensors
(:func:`fma_sum`: a grid of one block).

Replaces the JAX package's Pallas ``fused_fma_mean``
(``cubed_tpu/kernels/reductions.py:257``, ``pallas_call`` at ``:300``, at
commit 0cd9f84^): pangeo-vorticity's fused multiply-multiply-add-mean in one
pass over four streams. The device executor's fusion rule
(``runtime/executors/cuda.py``) sends that initial reduction here: every
block at once when its four inputs are resident, else each block as a grid
of one block (the chunked path); the blocks' element counts give mean's
``n``.

``csrc/fma_sum.cu`` (``fma_blocks_kernel``) sums every block of the grid in
one launch: its work items are (block, tile), each tile summed by one CTA in
place through the inputs' strides (block views of resident arrays are never
copied), accumulating in float64 with 16-byte loads where the layout allows
them; the CTA that draws a block's last ticket sums that block's partials
in tile order and writes its total into the ``(nb0, nb1, ...)`` output. No
atomic touches a value, so results are bitwise reproducible. Products and
their sum round as the plain version's do; only the order of summation
differs. The geometry is planned in pure Python by
:func:`._geometry.fma_blocks_plan` (a grid of few blocks takes smaller
tiles, so one block still fills the card) and cached per shape, strides and
alignment.

Bound on the H100: the four inputs, read once (3.35 TB/s).

:func:`fma_sum_plain` is ``(a*x + b*y).to(torch.float64).sum(keepdim=True)``
and :func:`fma_sum_blocks_plain` is it per block, stacked; the wrappers use
them only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math

import torch

from ..chunks import blockdims_from_blockshape
from ..utils import get_item
from . import _build, _geometry

#: dtypes the kernel takes, with the code its C entry point expects
DTYPES = {torch.float64: 0, torch.float32: 1}


def _check(a, x, b, y) -> None:
    ts = (a, x, b, y)
    if not all(isinstance(t, torch.Tensor) for t in ts):
        raise TypeError("fma_sum takes four tensors")
    if any(t.dtype != a.dtype for t in ts) or a.dtype not in DTYPES:
        raise TypeError(f"fma_sum takes four float64 or four float32 tensors, not "
                        f"{[t.dtype for t in ts]}")
    if any(t.shape != a.shape for t in ts):
        raise ValueError(f"fma_sum takes four tensors of one shape, not {[tuple(t.shape) for t in ts]}")
    if any(t.device != a.device for t in ts):
        raise ValueError("fma_sum takes four tensors on one device")
    if a.ndim > 4:
        raise ValueError(f"fma_sum takes tensors of rank 4 or less, not {a.ndim}")


def fma_sum(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum(a*x + b*y)`` as float64, with every axis kept at size 1: the
    whole tensors as a grid of one block (:func:`fma_sum_blocks`, one launch
    on a CUDA tensor; the plain version on a CPU tensor)."""
    _check(a, x, b, y)
    if a.ndim == 0:
        return fma_sum_blocks(*(t.reshape(1) for t in (a, x, b, y)), (1,)).reshape(())
    return fma_sum_blocks(a, x, b, y, tuple(a.shape))


def fma_sum_plain(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain version: the elementwise chain in the inputs' dtype, then a
    float64 sum over every axis, kept."""
    return (a * x + b * y).to(torch.float64).sum(dim=tuple(range(a.ndim)), keepdim=True)


def _grid(shape, chunks) -> tuple:
    """The block extents along each axis of *shape* blocked by *chunks*."""
    return blockdims_from_blockshape(tuple(shape), tuple(chunks))


def blocks_plan(a, x, b, y, chunks, tile_units: int = _geometry.FMA_TILE,
                sms: int = _geometry.SMS) -> _geometry.FmaBlocksPlan:
    """:func:`fma_sum_blocks`' geometry for these four tensors blocked by
    *chunks* (see :mod:`._geometry`)."""
    ts = (a, x, b, y)
    return _geometry.fma_blocks_plan(tuple(a.shape), [tuple(t.stride()) for t in ts], tuple(chunks),
                                     [t.data_ptr() for t in ts], a.element_size(), tile_units, sms)


def fma_sum_blocks(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor, chunks) -> torch.Tensor:
    """``sum(a*x + b*y)`` of every block of the grid of *chunks* (regular,
    the last block along an axis may be shorter), as a float64 tensor of
    the grid's shape ``(nb0, nb1, ...)``. A CUDA tensor goes to the kernel,
    in one launch for the whole grid; a CPU tensor to the plain version."""
    _check(a, x, b, y)
    if len(chunks) != a.ndim or a.ndim == 0:
        raise ValueError(f"fma_sum_blocks: chunks {tuple(chunks)} for rank-{a.ndim} tensors")
    if a.device.type == "cpu":
        return fma_sum_blocks_plain(a, x, b, y, chunks)
    if a.device.type != "cuda":
        raise ValueError(f"fma_sum_blocks: unsupported device {a.device}")
    ts = (a, x, b, y)
    nb, p, params = _launch_plan(tuple(a.shape), tuple(tuple(t.stride()) for t in ts), tuple(chunks),
                                 tuple(t.data_ptr() % 16 == 0 for t in ts), a.element_size(),
                                 _build.sm_count(a.device))
    if p is None:  # nothing to read
        return torch.zeros(nb, dtype=torch.float64, device=a.device)
    out = torch.empty(nb, dtype=torch.float64, device=a.device)
    split = p.per_block[0] > 1
    partials = torch.empty(p.items if split else 1, dtype=torch.float64, device=a.device)
    counters = _build.tickets(a.device, p.blocks if split else 0)
    fn = _blocks_kernel()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(
            ctypes.c_int(DTYPES[a.dtype]), ctypes.c_int(p.vector),
            *(ctypes.c_void_p(t.data_ptr()) for t in ts),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(partials.data_ptr()),
            ctypes.c_void_p(counters.data_ptr()), params, ctypes.c_void_p(stream),
        )
    _build.check(err, "fma_sum_blocks")
    fma_sum_blocks.launches += 1
    for key in p.paths + (("float32",) if a.dtype == torch.float32 else ()):
        fma_sum_blocks.paths[key] += 1
    return out


@functools.lru_cache(maxsize=256)
def _launch_plan(shape, strides, chunks, aligned, itemsize: int, sms: int):
    """(grid shape, plan, its parameters as the C entry point reads them) of
    a launch; the plan None when there is nothing to read. Cached: a plan
    depends on the addresses only through their 16-byte alignment."""
    nb = tuple(len(c) for c in _grid(shape, chunks))
    if math.prod(shape) == 0:
        return nb, None, None
    p = _geometry.fma_blocks_plan(shape, strides, chunks, [0 if al else 8 for al in aligned], itemsize, sms=sms)
    params = p.params()
    return nb, p, (ctypes.c_longlong * len(params))(*params)


#: launches of the CUDA kernel (the plain version does not count)
fma_sum_blocks.launches = 0
#: launches by path: "vector" (16-byte loads) or "scalar"; "one_cta" (one
#: work item a block) or "split" (a block's partials combined by its last CTA);
#: "float32": of float32 inputs (the route under the device executor's
#: compute_dtype="float32")
fma_sum_blocks.paths = dict.fromkeys(("vector", "scalar", "one_cta", "split", "float32"), 0)


_build.COUNTED.append(fma_sum_blocks)


@functools.cache
def _blocks_kernel():
    fn = _build.load("fma_sum").fma_sum_blocks
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def fma_sum_blocks_plain(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor,
                         chunks) -> torch.Tensor:
    """The plain version: :func:`fma_sum_plain` of each block, stacked into
    the grid's shape."""
    grid = _grid(a.shape, chunks)
    out = torch.empty(tuple(len(c) for c in grid), dtype=torch.float64, device=a.device)
    for idx in itertools.product(*(range(len(c)) for c in grid)):
        sel = get_item(grid, idx)
        out[idx] = fma_sum_plain(a[sel], x[sel], b[sel], y[sel]).reshape(())
    return out
