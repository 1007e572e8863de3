"""The single seam selecting where chunk kernels run: torch tensors on one device.

Counterpart of ``cubed_tpu/backend_array_api.py``. The device comes from
:func:`set_device`, else the ``CUBED_TPU_TORCH_DEVICE`` environment variable,
else ``cuda``. Asking for ``cuda`` where ``torch.cuda.is_available()`` is
false raises ``RuntimeError``: the port never moves to the CPU on its own.
Tests ask for ``cpu`` explicitly.

``nxp`` is the Array-API namespace the chunk kernels call. Its functions take
numpy dtypes (the plan's dtypes are numpy's) and always pass dtypes to torch
explicitly: ``torch.asarray(1.0)`` is float32 where the JAX package's x64
default is float64. ``nxp.sum`` of a float64, float32 or int64 tensor goes to
the hand-written region-sum kernel (its plain version on the CPU); any other
dtype goes to ``torch.sum`` and, on the card, counts in ``TORCH_SUM_CALLS``.

Every function here runs under ``torch.func.vmap`` (the device executor's
batched route): the region sum and ``sqrt`` (numpy on the CPU) are custom
ops with batching rules, and a scalar ``asarray`` is filled on the device.

**The narrowing scope** (:func:`narrowing`, entered by the device executor
under ``compute_dtype="float32"`` for the whole DAG): inside it, float64
chunks are float32 and complex128 chunks complex64, wherever a dtype is
named (:func:`to_torch_dtype`) or a host array crosses to the device
(:func:`numpy_array_to_backend_array`). It is the counterpart of the JAX
package's ``jax.enable_x64(False)`` and, like it, local to the thread (a
``contextvars.ContextVar``). Integer and bool dtypes stay as they are:
the reference's x64-off also narrows int64 to int32, and so loses integer
data the port keeps exact. The per-block product's precision has a scope
of its own (``contraction.precision``).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
import os
import types
import warnings
from typing import Optional

import numpy as np
import torch

from . import contraction

DEVICE_ENV_VAR = "CUBED_TPU_TORCH_DEVICE"

_device_override: Optional[str] = None

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    # the carriers of the wider unsigned integers
    np.dtype(np.uint16): torch.int32,
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.uint64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def set_device(device: Optional[str]) -> None:
    """Pin the chunk device (``"cuda"``, ``"cuda:1"``, ``"cpu"``); ``None``
    returns to the environment variable or the ``cuda`` default."""
    global _device_override
    _device_override = device
    if device is not None:
        get_device()  # fail now, not at the first chunk


def get_device() -> torch.device:
    """The device chunk kernels run on; raises if CUDA is asked for and absent."""
    name = _device_override or os.environ.get(DEVICE_ENV_VAR) or "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"cubed_tpu_torch runs its chunks on {name!r}, but "
            "torch.cuda.is_available() is False. Set "
            f"{DEVICE_ENV_VAR}=cpu (or call "
            "cubed_tpu_torch.backend_array_api.set_device('cpu')) to run "
            "on the CPU."
        )
    return dev


_NARROW: contextvars.ContextVar = contextvars.ContextVar("cubed_tpu_torch_narrowing", default=False)

#: what the narrowing scope makes of each wide floating dtype
_NARROWED = {
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}


@contextlib.contextmanager
def narrowing(enabled: bool = True):
    """Within this block (this thread or task only), float64 chunks are
    float32 and complex128 chunks complex64 (see the module docstring); the
    previous scope is restored on every exit."""
    token = _NARROW.set(bool(enabled))
    try:
        yield
    finally:
        _NARROW.reset(token)


def narrowed() -> bool:
    """Whether the narrowing scope is in force."""
    return _NARROW.get()


def compute_numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype a chunk of *dtype* has under the current scope (a
    structured dtype field by field)."""
    dt = np.dtype(dtype)
    if not _NARROW.get():
        return dt
    if dt.fields is not None:
        return np.dtype([(name, compute_numpy_dtype(dt.fields[name][0])) for name in dt.names])
    return _NARROWED.get(dt, dt)


_TORCH_NARROWED = {_NP_TO_TORCH[wide]: _NP_TO_TORCH[narrow] for wide, narrow in _NARROWED.items()}


def _narrow(dt: torch.dtype) -> torch.dtype:
    """*dt* as a chunk holds it under the current scope."""
    return _TORCH_NARROWED.get(dt, dt) if _NARROW.get() else dt


def to_torch_dtype(dtype) -> torch.dtype:
    dt = np.dtype(dtype)
    try:
        return _narrow(_NP_TO_TORCH[dt])
    except KeyError:
        raise TypeError(f"dtype {dt} is not supported by cubed_tpu_torch") from None


#: the numpy carrier of each unsigned dtype wider than 8 bits, and the mask
#: that keeps a carried value in its range (None: the carrier's own width)
_UNSIGNED_CARRIERS = {
    np.dtype(np.uint16): (np.dtype(np.int32), 0xFFFF),
    np.dtype(np.uint32): (np.dtype(np.int64), 0xFFFFFFFF),
    np.dtype(np.uint64): (np.dtype(np.int64), None),
}


def _to_carrier(a: np.ndarray) -> np.ndarray:
    carrier = _UNSIGNED_CARRIERS.get(a.dtype)
    if carrier is None:
        return a
    return a.view(carrier[0]) if carrier[1] is None else a.astype(carrier[0])


def wrap_unsigned(x: torch.Tensor, dtype) -> torch.Tensor:
    """*x* (a carrier of unsigned *dtype*) wrapped into *dtype*'s range, as
    numpy's arithmetic wraps."""
    carrier = _UNSIGNED_CARRIERS.get(np.dtype(dtype))
    if carrier is None or carrier[1] is None:
        return x
    return torch.bitwise_and(x.to(_NP_TO_TORCH[np.dtype(dtype)]), carrier[1])


def backend_array_to_numpy_array(arr) -> np.ndarray:
    """Device tensor -> host numpy (waits for the device)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def numpy_array_to_backend_array(arr):
    """Host numpy -> tensor on the chunk device.

    Structured numpy arrays become dicts of tensors, one per field (mean's
    ``{n, total}``), as in the JAX package. A stride-0 broadcast (a virtual
    empty or full chunk) crosses as one element and is expanded on the
    device, so no block-sized copy is made of it. A tensor (a view of an
    array resident on the device, read by a task body) passes through.
    """
    if isinstance(arr, torch.Tensor):
        return arr
    if isinstance(arr, dict):
        return {k: numpy_array_to_backend_array(v) for k, v in arr.items()}
    a = np.asarray(arr)
    if a.dtype.fields is not None:
        return {k: numpy_array_to_backend_array(np.ascontiguousarray(a[k])) for k in a.dtype.names}
    a = _to_carrier(a)
    narrow = _NARROWED.get(a.dtype) if _NARROW.get() else None
    dev = get_device()
    if a.ndim and a.size > 1 and all(s == 0 for s in a.strides):
        one = torch.from_numpy(a.reshape(-1)[:1].astype(narrow or a.dtype)).reshape(())
        return one.to(dev).expand(a.shape)
    # under the narrowing scope rounded on the host, so half the bytes cross
    a = np.ascontiguousarray(a, dtype=narrow)
    if dev.type == "cpu":
        return torch.from_numpy(a if a.flags.writeable else a.copy())
    with warnings.catch_warnings():
        # a chunk read from the store is a read-only buffer; its only use
        # here is as the source of the copy to the card
        warnings.simplefilter("ignore", UserWarning)
        host = torch.from_numpy(a)
    return host.to(dev)


# ---------------------------------------------------------------------------
# The namespace
# ---------------------------------------------------------------------------

#: ``torch.sum`` calls made on the card for dtypes the region-sum kernel
#: does not take (bool and the narrow integers, complex)
TORCH_SUM_CALLS = {"count": 0}


def _dims(ndim: int, axis) -> tuple[int, ...]:
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (int, np.integer)):
        return (int(axis) % ndim,) if ndim else ()
    return tuple(int(a) % ndim for a in axis) if ndim else ()


def _sum_dtype(x: torch.Tensor, dtype) -> torch.dtype:
    """numpy's result dtype of ``sum``: narrow integers and bool widen to
    int64, everything else keeps its dtype, unless *dtype* is given."""
    if dtype is not None:
        return to_torch_dtype(dtype)
    if x.dtype in (torch.bool, torch.int8, torch.int16, torch.int32, torch.uint8):
        return torch.int64
    return x.dtype


def _sum(x, axis=None, keepdims=False, dtype=None):
    from .kernels.region_sum import DTYPES, region_sum

    out_dtype = _sum_dtype(x, dtype)
    dims = _dims(x.ndim, axis)
    if out_dtype in DTYPES:
        return region_sum(x.to(out_dtype), dims, keepdims)
    if x.device.type == "cuda":
        TORCH_SUM_CALLS["count"] += 1
    if not dims:
        return x.to(out_dtype).clone()
    return torch.sum(x, dim=dims, keepdim=keepdims, dtype=out_dtype)


def _asarray(obj, dtype=None, device=None):
    dev = device or get_device()
    if isinstance(obj, (bool, int, float, complex, np.generic)):
        # a scalar is filled on the device (one kernel, no host-to-device
        # copy, so a captured CUDA graph may hold it)
        value = obj.item() if isinstance(obj, np.generic) else obj
        dt = to_torch_dtype(dtype if dtype is not None else np.asarray(obj).dtype)
        return torch.full((), value, dtype=dt, device=dev)
    if isinstance(obj, torch.Tensor):
        t = obj
    else:
        a = np.asarray(obj, dtype=dtype)
        t = torch.from_numpy(np.ascontiguousarray(a))
    dt = to_torch_dtype(dtype) if dtype is not None else _narrow(t.dtype)
    return t.to(device=dev, dtype=dt)


def _divide(a, b):
    # true division of two integer tensors is float64, as in numpy (torch
    # would give its float32 default); float32 under the narrowing scope
    if not (a.is_floating_point() or a.is_complex() or b.is_floating_point() or b.is_complex()):
        a = a.to(to_torch_dtype(np.float64))
    return torch.true_divide(a, b)


@torch.library.custom_op("cubed_tpu_torch::sqrt", mutates_args=())
def _sqrt(x: torch.Tensor) -> torch.Tensor:
    # torch's vectorised CPU sqrt is not correctly rounded (about 0.7% of
    # float64 inputs come out 1 ulp off); numpy's is, as is CUDA's
    if x.device.type == "cpu" and x.dtype in (torch.float32, torch.float64):
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))  # a 0-d result is a numpy scalar
    return torch.sqrt(x)


@_sqrt.register_fake
def _sqrt_fake(x):
    # the output's metadata alone, for a plan-time trace on meta tensors
    return torch.empty_like(x)


@torch.library.register_vmap("cubed_tpu_torch::sqrt")
def _sqrt_vmap(info, in_dims, x):
    # elementwise: the batched tensor is just a larger input
    return _sqrt(x), in_dims[0]


def _broadcast_to(x, shape):
    return x.expand(tuple(shape))


def _concat(arrays, axis=0):
    return torch.cat(list(arrays), dim=axis)


def _squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(_dims(x.ndim, axis))


def _astype(x, dtype):
    if np.dtype(dtype) in _UNSIGNED_CARRIERS and not x.is_floating_point():
        # integers wrap into the narrower range, as numpy's astype does
        return wrap_unsigned(x.to(torch.int64), dtype)
    return x.to(to_torch_dtype(dtype))


def _max(x, axis=None, keepdims=False):
    dims = _dims(x.ndim, axis)
    # torch.amax over no dims would reduce them all
    return torch.amax(x, dim=dims, keepdim=keepdims) if dims else x.clone()


def _min(x, axis=None, keepdims=False):
    dims = _dims(x.ndim, axis)
    return torch.amin(x, dim=dims, keepdim=keepdims) if dims else x.clone()


def _expand_dims(x, axis=0):
    out_ndim = x.ndim + (1 if isinstance(axis, (int, np.integer)) else len(axis))
    for ax in sorted(_dims(out_ndim, axis)):
        x = x.unsqueeze(ax)
    return x


def _all_bits(like: torch.Tensor) -> torch.Tensor:
    """Every bit set, in *like*'s integer dtype (-1, or an unsigned maximum)."""
    return torch.bitwise_not(torch.zeros_like(like))


def _floor_divide(a, b, unsigned=False):
    # the JAX package's values where numpy's and torch's differ (torch
    # raises on an integer divisor of zero on the CPU, and leaves garbage on
    # the card): a float divisor of zero gives nan, not +-inf; an integer
    # one gives XLA's quotient, every bit set, floored once more (to -2)
    # where the dividend is nonzero and signed
    if a.is_floating_point() or b.is_floating_point():
        out = torch.floor_divide(a, b)
        return torch.where(b == 0, torch.full_like(out, float("nan")), out)
    zero = b == 0
    out = torch.floor_divide(a, torch.where(zero, torch.ones_like(b), b))
    by_zero = _all_bits(out)
    if not unsigned:
        by_zero = torch.where(a != 0, by_zero - 1, by_zero)
    return torch.where(zero, by_zero, out)


def floor_divide_unsigned(a, b):
    """``floor_divide`` of unsigned values (carried in signed types): a
    divisor of zero gives every bit set, as in the JAX package."""
    return _floor_divide(a, b, unsigned=True)


def _pow(a, b):
    # integers: the JAX package's binary exponentiation over the exponent's
    # low six bits, so an exponent out of the standard's domain (negative)
    # gives its values too; torch.pow gives 0
    if a.is_floating_point() or a.is_complex() or b.is_floating_point() or b.is_complex():
        return torch.pow(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    acc = torch.where((a == 0) & (b != 0), torch.zeros_like(a), torch.ones_like(a))
    for bit in range(6):
        acc = torch.where(torch.bitwise_and(torch.bitwise_right_shift(b, bit), 1) != 0, acc * a, acc)
        a = a * a
    return acc


def _round(x):
    # half to even, as numpy's; a complex value by parts (torch's round
    # takes no complex input)
    if x.is_complex():
        return torch.complex(torch.round(x.real), torch.round(x.imag))
    return torch.round(x)


def _remainder(a, b):
    # torch's remainder takes the divisor's sign, as numpy's and the JAX
    # package's do (torch.fmod does not); an integer divisor of zero gives 0,
    # as in the JAX package
    if a.is_floating_point() or b.is_floating_point():
        return torch.remainder(a, b)
    zero = b == 0
    out = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(out), out)


def _sign(x):
    # torch.sign(nan) is 0; numpy's and the JAX package's is nan
    if x.is_complex():
        return torch.sgn(x)
    if x.is_floating_point():
        return torch.where(torch.isnan(x), x, torch.sign(x))
    return torch.sign(x)


def logical_right_shift64(a, b):
    """``>>`` of uint64 values carried in int64: a logical shift (int64's is
    arithmetic). The mask keeps the low ``64 - b`` bits; built as
    ``~((-1 << (63 - b)) << 1)`` so that no shift is by 64."""
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    mask = torch.bitwise_not(torch.bitwise_left_shift(torch.bitwise_left_shift(_all_bits(a), 63 - b), 1))
    return torch.bitwise_and(torch.bitwise_right_shift(a, b), mask)


def _prod(x, axis=None, keepdims=False, dtype=None):
    # torch.prod reduces one dim a call
    dims = _dims(x.ndim, axis)
    out = x.to(_sum_dtype(x, dtype))
    if not dims:
        return out.clone()
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, dim=d, keepdim=True)
    return out if keepdims else out.squeeze(dims)


def _mean(x, axis=None, keepdims=False, dtype=None):
    # a sum through _sum (the region-sum kernel on the card), then a divide
    dims = _dims(x.ndim, axis)
    n = math.prod(x.shape[d] for d in dims)
    return torch.true_divide(_sum(x, axis=dims, keepdims=keepdims, dtype=dtype), n)


def _truth(fn, x, axis=None, keepdims=False):
    dims = _dims(x.ndim, axis)
    x = x if x.dtype == torch.bool else x != 0
    return fn(x, dim=dims, keepdim=keepdims) if dims else x.clone()


def _arg(fn, x, axis=None, keepdims=False):
    # the first extremum on ties, and the first NaN where there is one, as in
    # numpy and the JAX package
    return fn(x, dim=int(axis), keepdim=keepdims)


def _take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, indices.to(torch.int64), dim=axis)


def _flip(x, axis=None):
    return torch.flip(x, _dims(x.ndim, axis))


def _cumulative(fn):
    def scan(x, axis, dtype=None):
        return fn(x, dim=axis, dtype=to_torch_dtype(dtype) if dtype is not None else None)

    return scan


def _where(cond, a, b):
    return torch.where(cond if cond.dtype == torch.bool else cond != 0, a, b)


nxp = types.SimpleNamespace(
    # elementwise, one torch call each
    abs=torch.abs,
    add=torch.add,
    subtract=torch.subtract,
    multiply=torch.multiply,
    divide=_divide,
    negative=torch.negative,
    positive=torch.positive,
    sqrt=_sqrt,
    square=torch.square,
    exp=torch.exp,
    log=torch.log,
    sin=torch.sin,
    cos=torch.cos,
    tanh=torch.tanh,
    floor=torch.floor,
    ceil=torch.ceil,
    maximum=torch.maximum,
    minimum=torch.minimum,
    pow=_pow,
    equal=torch.eq,
    not_equal=torch.ne,
    less=torch.lt,
    less_equal=torch.le,
    greater=torch.gt,
    greater_equal=torch.ge,
    acos=torch.acos,
    acosh=torch.acosh,
    asin=torch.asin,
    asinh=torch.asinh,
    atan=torch.atan,
    atan2=torch.atan2,
    atanh=torch.atanh,
    bitwise_and=torch.bitwise_and,
    bitwise_invert=torch.bitwise_not,
    bitwise_left_shift=torch.bitwise_left_shift,
    bitwise_or=torch.bitwise_or,
    bitwise_right_shift=torch.bitwise_right_shift,
    bitwise_xor=torch.bitwise_xor,
    copysign=torch.copysign,
    cosh=torch.cosh,
    expm1=torch.expm1,
    floor_divide=_floor_divide,
    hypot=torch.hypot,
    imag=torch.imag,
    isfinite=torch.isfinite,
    isinf=torch.isinf,
    isnan=torch.isnan,
    log1p=torch.log1p,
    log2=torch.log2,
    log10=torch.log10,
    logaddexp=torch.logaddexp,
    logical_and=torch.logical_and,
    logical_not=torch.logical_not,
    logical_or=torch.logical_or,
    logical_xor=torch.logical_xor,
    nextafter=torch.nextafter,
    real=torch.real,
    reciprocal=torch.reciprocal,
    remainder=_remainder,
    round=_round,
    sign=_sign,
    signbit=torch.signbit,
    sinh=torch.sinh,
    tan=torch.tan,
    trunc=torch.trunc,
    where=_where,
    # reductions, scans and searches
    prod=_prod,
    mean=_mean,
    all=functools.partial(_truth, torch.all),
    any=functools.partial(_truth, torch.any),
    argmax=functools.partial(_arg, torch.argmax),
    argmin=functools.partial(_arg, torch.argmin),
    cumsum=_cumulative(torch.cumsum),
    cumprod=_cumulative(torch.cumprod),
    take_along_axis=_take_along_axis,
    flip=_flip,
    reshape=torch.reshape,
    concatenate=_concat,
    # reductions, creation and manipulation
    sum=_sum,
    asarray=_asarray,
    broadcast_to=_broadcast_to,
    concat=_concat,
    squeeze=_squeeze,
    astype=_astype,
    max=_max,
    min=_min,
    expand_dims=_expand_dims,
    permute_dims=torch.permute,
    # linear algebra: cuBLAS on the card, at the precision scope's mode
    matmul=contraction.matmul,
    tensordot=contraction.tensordot,
    einsum=torch.einsum,
    conj=torch.conj_physical,
)
