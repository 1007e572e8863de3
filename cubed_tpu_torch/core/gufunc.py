"""apply_gufunc: a generalized ufunc (a signature such as ``"(i,j),(j)->(i)"``)
over the loop dimensions of chunked arrays, lowered to blockwise.

Counterpart of ``cubed_tpu/core/gufunc.py``. Core dimensions must each be one
chunk (rechunk first). Several outputs are one multi-output op when every
output has the same core dimensions (``"(i)->(),()"``). The function gets
torch tensors on the chunk device; with ``vectorize=True`` it is wrapped in
``np.vectorize`` and runs on the host, each block copied there and back (as
the JAX package's vectorized blocks are host functions too).
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from ..backend_array_api import backend_array_to_numpy_array, numpy_array_to_backend_array
from .ops import _declare_batchable, blockwise

_DIMENSION_NAME = r"\w+"
_CORE_DIMENSION_LIST = "(?:{0:}(?:,{0:})*,?)?".format(_DIMENSION_NAME)
_ARGUMENT = rf"\({_CORE_DIMENSION_LIST}\)"
_INPUT_ARGUMENTS = "(?:{0:}(?:,{0:})*,?)?".format(_ARGUMENT)
_OUTPUT_ARGUMENTS = "{0:}(?:,{0:})*".format(_ARGUMENT)
_SIGNATURE = f"^{_INPUT_ARGUMENTS}->{_OUTPUT_ARGUMENTS}$"


def _parse_gufunc_signature(signature: str):
    """Parse a NumPy gufunc signature into (input dims, output dims)."""
    signature = signature.replace(" ", "")
    if not re.match(_SIGNATURE, signature):
        raise ValueError(f"not a valid gufunc signature: {signature}")
    ins, outs = signature.split("->")
    input_dims = [tuple(re.findall(_DIMENSION_NAME, arg)) for arg in re.findall(_ARGUMENT, ins)]
    output_dims = [tuple(re.findall(_DIMENSION_NAME, arg)) for arg in re.findall(_ARGUMENT, outs)]
    return input_dims, output_dims


def apply_gufunc(
    func,
    signature: str,
    *args,
    axes=None,
    axis=None,
    output_dtypes=None,
    vectorize: Optional[bool] = None,
    **kwargs,
):
    """Apply a generalized ufunc over the loop dimensions of chunked arrays."""
    input_dims, output_dims = _parse_gufunc_signature(signature)
    n_out = len(output_dims)
    if n_out > 1 and len(set(output_dims)) != 1:
        raise NotImplementedError(
            "apply_gufunc supports multiple outputs only when they share "
            f"the same core dimensions; got {output_dims}"
        )
    output_dim = output_dims[0]
    if axes is not None or axis is not None:
        raise NotImplementedError("axes/axis are not supported")
    if len(input_dims) != len(args):
        raise ValueError(f"signature {signature} expects {len(input_dims)} arrays, got {len(args)}")
    if output_dtypes is None:
        raise ValueError("output_dtypes must be specified")
    if n_out > 1:
        if not isinstance(output_dtypes, (list, tuple)) or len(output_dtypes) != n_out:
            raise ValueError(f"output_dtypes must list {n_out} dtypes for {n_out} outputs")
        otype = list(output_dtypes)
    else:
        otype = output_dtypes[0] if isinstance(output_dtypes, (list, tuple)) else output_dtypes

    # the size of each core dimension, from the arrays
    dim_sizes: dict = {}
    loop_ndims = []
    for a, dims in zip(args, input_dims):
        if len(dims) > a.ndim:
            raise ValueError(f"array with {a.ndim} dims cannot supply core dims {dims}")
        loop_ndims.append(a.ndim - len(dims))
        for d, size in zip(dims, a.shape[a.ndim - len(dims):]):
            if d in dim_sizes and dim_sizes[d] != size:
                raise ValueError(f"inconsistent size for core dimension {d!r}")
            dim_sizes[d] = size
    max_loop = max(loop_ndims) if loop_ndims else 0

    # core dims must be single-chunk
    for a, dims in zip(args, input_dims):
        for ax, d in enumerate(dims):
            chunks_ax = a.chunks[a.ndim - len(dims) + ax]
            if len(chunks_ax) > 1:
                raise ValueError(
                    f"core dimension {d!r} of array is chunked ({chunks_ax}); "
                    "rechunk so core dimensions have a single chunk"
                )

    # index symbols: loop dims (aligned from the right), then core dims;
    # output-only core dims get symbols too, sized by output_sizes
    core_syms = {d: f"c_{d}" for d in {*dim_sizes, *(d for dims in output_dims for d in dims)}}
    blockwise_args = []
    for a, dims, lnd in zip(args, input_dims, loop_ndims):
        blockwise_args.extend([a, tuple(range(max_loop - lnd, max_loop)) + tuple(core_syms[d] for d in dims)])
    out_ind = tuple(range(max_loop)) + tuple(core_syms[d] for d in output_dim)
    new_axes = {}
    for d in output_dim:
        if not any(d in dims for dims in input_dims):
            new_axes[core_syms[d]] = dim_sizes.get(d, kwargs.get("output_sizes", {}).get(d))
            if new_axes[core_syms[d]] is None:
                raise ValueError(f"size of output core dimension {d!r} unknown")
    kwargs.pop("output_sizes", None)

    if vectorize:
        block_func = _HostVectorized(func, signature)
    else:
        # whether it runs under torch.func.vmap, traced once on meta blocks
        blocks = [(tuple(c[0] if c else 0 for c in a.chunks), a.dtype) for a in args]
        block_func = _declare_batchable(_UnwrapCoreDims(func), blocks, kwargs)
    return blockwise(block_func, out_ind, *blockwise_args, dtype=otype, new_axes=new_axes or None, **kwargs)


class _UnwrapCoreDims:
    """Core dims are one chunk each, so a block function gives them as
    single-element nested lists; unwrap them to plain chunks. The function's
    own hints to the device executor (``batchable``, ``host_sync``) carry
    over."""

    def __init__(self, func):
        self.func = func
        self.__name__ = getattr(func, "__name__", "apply_gufunc")
        for attr in ("batchable", "host_sync"):
            if hasattr(func, attr):
                setattr(self, attr, getattr(func, attr))

    def __call__(self, *args, **kwargs):
        return self.func(*[_unwrap_single(a) for a in args], **kwargs)


class _HostVectorized(_UnwrapCoreDims):
    """An ``np.vectorize``-d function over a block's values on the host."""

    def __init__(self, func, signature: str):
        super().__init__(func)
        self.func = np.vectorize(func, signature=signature)
        self.batchable = False  # host code: never under torch.func.vmap

    def __call__(self, *args, **kwargs):
        out = self.func(*[backend_array_to_numpy_array(_unwrap_single(a)) for a in args], **kwargs)
        if isinstance(out, tuple):
            return tuple(numpy_array_to_backend_array(np.asarray(o)) for o in out)
        return numpy_array_to_backend_array(np.asarray(out))


def _unwrap_single(x):
    while isinstance(x, list) and len(x) == 1:
        x = x[0]
    return x
