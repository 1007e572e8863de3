"""K2: keepdims sum over an axis set, for float64, float32 and int64.

Replaces the JAX package's Pallas ``region_sum`` and ``block_sum``
(``cubed_tpu/kernels/reductions.py:192`` and ``:84`` at commit 0cd9f84^),
which served the tree reduction's sums: ``_mean_func``, ``_mean_combine`` and
``_sum_with_dtype``. ``csrc/region_sum.cu`` reads the input in place
through its strides (axes merged where contiguous; never a permuted copy)
and finishes in one launch, in the ``rows`` layout when the innermost axis
is reduced or the ``columns`` layout when it is kept; 16-byte loads where
the layout allows them; small inputs take one CTA and no partials, larger
ones combine their partials in the CTA that draws the last ticket. Every
order of summation follows from the shape alone and no atomic touches a
value, so results are bitwise reproducible. float32 accumulates in float64;
int64 sums exactly, wrapping as torch does. The geometry is planned in pure
Python by :func:`._geometry.plan`.

The wrapper is the custom op ``cubed_tpu_torch::region_sum`` with a
``torch.func.vmap`` batching rule: a bucket of blocks that the device
executor batches is reduced in one launch over its grid view (grid axes
kept, in-block axes summed), never block by block.

Bound on the H100: the input bytes, read once (3.35 TB/s).

:func:`region_sum_plain` is ``x.to(acc).sum(dims, keepdim=True).to(dtype)``;
the wrapper uses it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from . import _build, _geometry

#: dtypes the kernel takes, with the code its C entry point expects
DTYPES = {torch.float64: 0, torch.float32: 1, torch.int64: 2}
_ACC = {torch.float64: torch.float64, torch.float32: torch.float64, torch.int64: torch.int64}
_LAYOUTS = {"rows": 0, "columns": 1}


def _normalize_axes(ndim: int, axis) -> tuple[int, ...]:
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(sorted({int(a) % ndim for a in axis})) if ndim else ()


def plan(x: torch.Tensor, axis=None, sms: int = _geometry.SMS) -> _geometry.Plan:
    """The kernel's geometry for summing *x* over *axis* (see :mod:`._geometry`)."""
    return _geometry.plan(tuple(x.shape), [tuple(x.stride())], [x.data_ptr()],
                          x.element_size(), _normalize_axes(x.ndim, axis), sms)


def region_sum(x: torch.Tensor, axis=None, keepdims: bool = True) -> torch.Tensor:
    """Sum *x* over *axis* (None = all). A CUDA tensor goes to the kernel, in
    one launch (none when the output is empty); a CPU tensor to the plain
    version. Under ``torch.func.vmap`` the batching rule sums the whole
    batched tensor in one call, the batch axes kept."""
    if x.dtype not in DTYPES:
        raise TypeError(f"region_sum takes float64, float32 or int64, not {x.dtype}")
    axes = _normalize_axes(x.ndim, axis)
    if torch._C._functorch.is_batchedtensor(x):
        # under torch.func.vmap: the custom op, whose batching rule takes
        # the whole batched tensor
        return _region_sum_op(x, list(axes), keepdims)
    # a plain tensor skips the custom op's dispatch (tens of microseconds
    # of host time a call, on the chunked path's every combine)
    return _region_sum(x, axes, keepdims)


@torch.library.custom_op("cubed_tpu_torch::region_sum", mutates_args=())
def _region_sum_op(x: torch.Tensor, axes: list[int], keepdims: bool) -> torch.Tensor:
    return _region_sum(x, tuple(axes), keepdims)


def _region_sum(x: torch.Tensor, axes: tuple, keepdims: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return region_sum_plain(x, axes, keepdims)
    if x.device.type == "meta":
        return _region_sum_fake(x, axes, keepdims)
    if x.device.type != "cuda":
        raise ValueError(f"region_sum: unsupported device {x.device}")
    keep_shape = tuple(1 if d in axes else x.shape[d] for d in range(x.ndim))
    out = torch.empty(keep_shape, dtype=x.dtype, device=x.device)
    if not keepdims:
        out = out.reshape([x.shape[d] for d in range(x.ndim) if d not in axes])
    p = plan(x, axes, _build.sm_count(x.device))
    if p.grid == 0:
        return out
    partials = torch.empty(max(1, p.partials), dtype=_ACC[x.dtype], device=x.device)
    counters = _build.tickets(x.device, p.tickets)
    params = p.params()
    fn = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(
            ctypes.c_int(DTYPES[x.dtype]), ctypes.c_int(p.dims), ctypes.c_int(_LAYOUTS[p.layout]),
            ctypes.c_int(p.vector),
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(partials.data_ptr()), ctypes.c_void_p(counters.data_ptr()),
            (ctypes.c_longlong * len(params))(*params), ctypes.c_int(p.grid),
            ctypes.c_int(p.threads), ctypes.c_void_p(stream),
        )
    _build.check(err, "region_sum")
    with _build.COUNT_LOCK:
        region_sum.launches += 1
        for key in p.paths + (("float32",) if x.dtype == torch.float32 else ()):
            region_sum.paths[key] += 1
    return out


@_region_sum_op.register_fake
def _region_sum_fake(x, axes, keepdims):
    # the output's metadata alone, for a plan-time trace on meta tensors
    shape = [1 if d in axes else n for d, n in enumerate(x.shape)]
    return x.new_empty(shape if keepdims else [n for d, n in enumerate(x.shape) if d not in axes])


@torch.library.register_vmap("cubed_tpu_torch::region_sum")
def _region_sum_vmap(info, in_dims, x, axes, keepdims):
    """The batching rule: the batch axis moves to the front and stays kept;
    the block's axes shift past it. Nested levels (one per grid axis of a
    bucket) each add a kept axis, so the kernel gets the bucket's whole grid
    view, in place, in one launch."""
    (d, _, _) = in_dims
    if d is None:
        return _region_sum_op(x, axes, keepdims), None
    return _region_sum_op(x.movedim(d, 0), [a + 1 for a in axes], keepdims), 0


#: launches of the CUDA kernel (the plain version does not count)
region_sum.launches = 0
#: launches by path: "rows" or "columns" (layout), "vector" (16-byte loads) or
#: "scalar", "one_cta" (each output summed by one CTA) or "split" (partials
#: combined by the last CTA); "float32": of float32 inputs (the route under
#: the device executor's compute_dtype="float32")
region_sum.paths = dict.fromkeys(("rows", "columns", "vector", "scalar", "one_cta", "split", "float32"), 0)


_build.COUNTED.append(region_sum)


@functools.cache
def _kernel():
    lib = _build.load("region_sum")
    fn = lib.region_sum
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def region_sum_plain(
    x: torch.Tensor, axis: Optional[Sequence[int]] = None, keepdims: bool = True
) -> torch.Tensor:
    """The plain version: accumulate in float64 (floats) or int64, cast back."""
    axes = _normalize_axes(x.ndim, axis)
    acc = _ACC[x.dtype]
    if not axes:
        return x.clone()
    return x.to(acc).sum(dim=axes, keepdim=keepdims).to(x.dtype)
