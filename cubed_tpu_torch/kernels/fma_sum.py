"""K3: ``sum(a*x + b*y)`` over every element of four equal-shaped tensors.

Replaces the JAX package's Pallas ``fused_fma_mean``
(``cubed_tpu/kernels/reductions.py:257``, ``pallas_call`` at ``:300``, at
commit 0cd9f84^): pangeo-vorticity's fused multiply-multiply-add-mean in one
pass over four streams. The device executor's fusion rule
(``runtime/executors/cuda.py``) sends each block of that initial reduction
here; the block's element count gives mean's ``n``.

``csrc/fma_sum.cu`` reads each input in place through its own strides
(block views of resident arrays are never copied), accumulates in float64
and finishes in one launch: persistent CTAs take ranges of the flattened
input, 16-byte loads where the layout allows them, and the CTA that draws
the last ticket sums the per-CTA partials in index order. No atomic touches a
value, so results are bitwise reproducible. Products and their sum round as
the plain version's do; only the order of summation differs. The geometry
(merged axes, vector or scalar path, CTAs, partials) is planned in pure
Python by :func:`._geometry.plan`.

Bound on the H100: the four inputs, read once (3.35 TB/s).

:func:`fma_sum_plain` is ``(a*x + b*y).to(torch.float64).sum(keepdim=True)``;
the wrapper uses it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

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


def plan(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor,
         sms: int = _geometry.SMS) -> _geometry.Plan:
    """The kernel's geometry for these four tensors (see :mod:`._geometry`)."""
    ts = (a, x, b, y)
    return _geometry.plan(tuple(a.shape), [tuple(t.stride()) for t in ts],
                          [t.data_ptr() for t in ts], a.element_size(), None, sms)


def fma_sum(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sum(a*x + b*y)`` as float64, with every axis kept at size 1. A CUDA
    tensor goes to the kernel, in one launch; a CPU tensor to the plain
    version."""
    _check(a, x, b, y)
    if a.device.type == "cpu":
        return fma_sum_plain(a, x, b, y)
    if a.device.type != "cuda":
        raise ValueError(f"fma_sum: unsupported device {a.device}")
    p = plan(a, x, b, y, _build.sm_count(a.device))
    out = torch.empty((1,) * a.ndim, dtype=torch.float64, device=a.device)
    partials = torch.empty(max(1, p.partials), dtype=torch.float64, device=a.device)
    counter = _build.tickets(a.device, p.tickets)
    params = p.params()
    fn = _kernel()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(
            ctypes.c_int(DTYPES[a.dtype]), ctypes.c_int(p.vector),
            *(ctypes.c_void_p(t.data_ptr()) for t in (a, x, b, y)),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(partials.data_ptr()),
            ctypes.c_void_p(counter.data_ptr()), (ctypes.c_longlong * len(params))(*params),
            ctypes.c_int(p.grid), ctypes.c_int(p.threads), ctypes.c_void_p(stream),
        )
    _build.check(err, "fma_sum")
    fma_sum.launches += 1
    for key in p.paths:
        fma_sum.paths[key] += 1
    return out


#: launches of the CUDA kernel (the plain version does not count)
fma_sum.launches = 0
#: launches by path: "vector" (16-byte loads) or "scalar"; "one_cta" (one
#: CTA writes the result) or "split" (partials combined by the last CTA);
#: "rows" (always: every axis is reduced)
fma_sum.paths = dict.fromkeys(("rows", "vector", "scalar", "one_cta", "split"), 0)


@functools.cache
def _kernel():
    lib = _build.load("fma_sum")
    fn = lib.fma_sum
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def fma_sum_plain(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain version: the elementwise chain in the inputs' dtype, then a
    float64 sum over every axis, kept."""
    return (a * x + b * y).to(torch.float64).sum(dim=tuple(range(a.ndim)), keepdim=True)
