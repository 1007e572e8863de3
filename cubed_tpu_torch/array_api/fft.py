"""The ``fft`` extension namespace, beyond the standard.

Counterpart of ``cubed_tpu/array_api/fft.py``, with the same plans and
dask's semantics: the transform axis is rechunked to one chunk (the
plan-time memory bound prices that chunk, so an axis too long for a task
fails before anything runs) while every other axis stays chunked; an N-d
transform is applied one axis at a time, so at most one axis is gathered
per op. A block's transform is one ``torch.fft`` call (cuFFT on the card);
it runs under ``torch.func.vmap`` on the device executor's batched route
and joins captured segments (a first compute of a plan runs its segment op
by op, which fills torch's cuFFT plan cache; a plan made while capturing
is captured cleanly too).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ops import general_blockwise, rechunk
from .dtypes import (
    _complex_floating_dtypes,
    _floating_dtypes,
    _real_floating_dtypes,
    complex64,
    complex128,
    float32,
    float64,
)
from .manipulation_functions import roll

__all__ = [
    "fft", "ifft", "fftn", "ifftn", "rfft", "irfft", "rfftn", "irfftn",
    "hfft", "ihfft", "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]

_NORMS = (None, "backward", "ortho", "forward")


def _complex_dtype_for(dt):
    return complex64 if dt in (float32, complex64) else complex128


def _real_dtype_for(dt):
    return float32 if dt in (float32, complex64) else float64


class _Transform:
    """One block's 1-d transform along *axis* (``torch.fft.<name>``)."""

    batchable = True

    def __init__(self, name, n, axis, norm):
        self.__name__ = name
        self.fn = getattr(torch.fft, name)
        self.n, self.axis, self.norm = n, axis, norm

    def __call__(self, a):
        # ihfft returns a conjugate view: resolved, as a stored block must be
        return self.fn(a, n=self.n, dim=self.axis, norm=self.norm).resolve_conj()


def _fft_axis_op(x, axis, out_len, out_dtype, kernel, op_name):
    """A per-block 1-d transform along *axis* (gathered to one chunk); the
    output's grid is x's with *axis* re-sized."""
    axis = axis % x.ndim
    if len(x.chunks[axis]) > 1:
        x = rechunk(x, {axis: x.shape[axis]})
    out_shape = tuple(out_len if d == axis else s for d, s in enumerate(x.shape))
    out_chunks = tuple((out_len,) if d == axis else c for d, c in enumerate(x.chunks))
    x_name = x.name

    def bf(out_key):
        return ((x_name, *out_key[1:]),)

    # fusable=False, as in the JAX package (whose reason is XLA:CPU's: its
    # fft thunk requires a default input layout, which a fused producer may
    # not give it); kept here so that the port's ops and tasks equal the
    # reference's, and a transform is compute-bound, so the elementwise
    # fusion it forgoes costs little
    return general_blockwise(
        kernel, bf, x,
        shape=out_shape,
        dtype=np.dtype(out_dtype),
        chunks=out_chunks,
        fusable=False,
        op_name=op_name,
    )


def _check(x, fname, real_ok=True, complex_ok=True):
    allowed = ()
    if real_ok:
        allowed += _real_floating_dtypes
    if complex_ok:
        allowed += _complex_floating_dtypes
    if x.dtype not in allowed:
        kinds = " or ".join(k for k, ok in (("real", real_ok), ("complex", complex_ok)) if ok)
        raise TypeError(f"{fname} requires a {kinds} floating-point dtype")
    if x.ndim == 0:
        raise ValueError(f"{fname} requires at least 1 dimension")


def _check_norm(norm):
    if norm not in _NORMS:
        raise ValueError(f"invalid norm: {norm!r}")
    return norm or "backward"


def _check_axis(x, axis, fname):
    if not -x.ndim <= axis < x.ndim:
        raise IndexError(f"{fname}: axis {axis} is out of bounds for array of dimension {x.ndim}")
    return axis


def _complex_to_complex(name, x, n, axis, norm):
    _check(x, name)
    _check_axis(x, axis, name)
    norm = _check_norm(norm)
    out_n = n if n is not None else x.shape[axis % x.ndim]
    return _fft_axis_op(x, axis, out_n, _complex_dtype_for(x.dtype), _Transform(name, out_n, axis, norm), name)


def _real_to_half(name, x, n, axis, norm):
    _check(x, name, complex_ok=False)
    _check_axis(x, axis, name)
    norm = _check_norm(norm)
    in_n = n if n is not None else x.shape[axis % x.ndim]
    return _fft_axis_op(x, axis, in_n // 2 + 1, _complex_dtype_for(x.dtype), _Transform(name, in_n, axis, norm),
                        name)


def _half_to_real(name, x, n, axis, norm):
    _check(x, name)
    _check_axis(x, axis, name)
    norm = _check_norm(norm)
    out_n = n if n is not None else 2 * (x.shape[axis % x.ndim] - 1)
    return _fft_axis_op(x, axis, out_n, _real_dtype_for(x.dtype), _Transform(name, out_n, axis, norm), name)


def fft(x, /, *, n=None, axis=-1, norm="backward"):
    return _complex_to_complex("fft", x, n, axis, norm)


def ifft(x, /, *, n=None, axis=-1, norm="backward"):
    return _complex_to_complex("ifft", x, n, axis, norm)


def rfft(x, /, *, n=None, axis=-1, norm="backward"):
    return _real_to_half("rfft", x, n, axis, norm)


def irfft(x, /, *, n=None, axis=-1, norm="backward"):
    return _half_to_real("irfft", x, n, axis, norm)


def hfft(x, /, *, n=None, axis=-1, norm="backward"):
    return _half_to_real("hfft", x, n, axis, norm)


def ihfft(x, /, *, n=None, axis=-1, norm="backward"):
    return _real_to_half("ihfft", x, n, axis, norm)


def _resolve_axes(x, s, axes, fname):
    if axes is None:
        # numpy's convention: s without axes means the last len(s) axes,
        # negative, so that an s too long falls out of bounds below
        axes = tuple(range(x.ndim)) if s is None else tuple(range(-len(s), 0))
    for a in axes:
        _check_axis(x, a, fname)
    axes = tuple(a % x.ndim for a in axes)
    if s is None:
        s = tuple(x.shape[a] for a in axes)
    if len(s) != len(axes):
        raise ValueError("s and axes must have the same length")
    return s, axes


def fftn(x, /, *, s=None, axes=None, norm="backward"):
    _check(x, "fftn")
    s, axes = _resolve_axes(x, s, axes, "fftn")
    out = x
    for n, a in zip(s, axes):  # separable: one gathered axis per op
        out = fft(out, n=n, axis=a, norm=norm)
    return out


def ifftn(x, /, *, s=None, axes=None, norm="backward"):
    _check(x, "ifftn")
    s, axes = _resolve_axes(x, s, axes, "ifftn")
    out = x
    for n, a in zip(s, axes):
        out = ifft(out, n=n, axis=a, norm=norm)
    return out


def rfftn(x, /, *, s=None, axes=None, norm="backward"):
    _check(x, "rfftn", complex_ok=False)
    s, axes = _resolve_axes(x, s, axes, "rfftn")
    out = rfft(x, n=s[-1], axis=axes[-1], norm=norm)
    for n, a in zip(s[:-1], axes[:-1]):
        out = fft(out, n=n, axis=a, norm=norm)
    return out


def irfftn(x, /, *, s=None, axes=None, norm="backward"):
    _check(x, "irfftn")
    s_given = s is not None
    s, axes = _resolve_axes(x, s, axes, "irfftn")
    if not s_given:
        # the default s: the last transformed axis inverts to 2 * (m - 1)
        s = s[:-1] + (2 * (x.shape[axes[-1]] - 1),)
    out = x
    for n, a in zip(s[:-1], axes[:-1]):
        out = ifft(out, n=n, axis=a, norm=norm)
    return irfft(out, n=s[-1], axis=axes[-1], norm=norm)


def fftfreq(n, /, *, d=1.0, dtype=None, device=None, spec=None):
    """The sample frequencies ``[0, 1, ..., (n-1)//2, -(n//2), ..., -1] /
    (n*d)``, composed of a chunked ``arange`` and ``where`` (nothing made on
    the host)."""
    from .creation_functions import arange, asarray
    from .elementwise_functions import divide, less, subtract
    from .searching_functions import where

    dt = np.dtype(dtype) if dtype is not None else np.dtype(np.float64)
    if dt not in _real_floating_dtypes:
        raise ValueError("fftfreq requires a real floating-point dtype")
    i = arange(n, dtype=dt, spec=spec)
    folded = where(
        less(i, asarray((n + 1) // 2, dtype=dt, spec=spec)),
        i,
        subtract(i, asarray(n, dtype=dt, spec=spec)),
    )
    return divide(folded, asarray(n * d, dtype=dt, spec=spec))


def rfftfreq(n, /, *, d=1.0, dtype=None, device=None, spec=None):
    from .creation_functions import arange, asarray
    from .elementwise_functions import divide

    dt = np.dtype(dtype) if dtype is not None else np.dtype(np.float64)
    if dt not in _real_floating_dtypes:
        raise ValueError("rfftfreq requires a real floating-point dtype")
    i = arange(n // 2 + 1, dtype=dt, spec=spec)
    return divide(i, asarray(n * d, dtype=dt, spec=spec))


def _shift(x, axes, sign, fname):
    if x.dtype not in _floating_dtypes:
        raise TypeError(f"{fname} requires a floating-point dtype")
    if axes is None:
        axes = tuple(range(x.ndim))
    elif isinstance(axes, int):
        axes = (axes,)
    out = x
    for a in axes:
        _check_axis(x, a, fname)
        out = roll(out, sign * (x.shape[a % x.ndim] // 2), axis=a % x.ndim)
    return out


def fftshift(x, /, *, axes=None):
    return _shift(x, axes, 1, "fftshift")


def ifftshift(x, /, *, axes=None):
    return _shift(x, axes, -1, "ifftshift")
