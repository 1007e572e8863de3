"""Array-API creation functions. Counterpart of
``cubed_tpu/array_api/creation_functions.py``.

Constant arrays (``empty``, ``full``, ``zeros``, ``ones`` and their
``_like`` forms) are virtual: nothing is stored, and the device executor
fills them on the card. ``arange``, ``eye`` and ``linspace`` compute each
block from its linear offset, which reaches the block function as data
(``supports_offset``), so the device executor's batched route runs them
under ``torch.func.vmap``. Each block is the JAX package's formula in float64
or int64 (torch's default float32 never enters), so the two agree bit for
bit."""

from __future__ import annotations

import numpy as np
import torch

from ..backend_array_api import get_device, to_torch_dtype
from ..chunks import normalize_chunks
from ..core.array import CoreArray
from ..core.ops import empty_virtual_array as _empty_virtual_array
from ..core.ops import map_blocks, new_array
from ..core.plan import Plan, gensym
from ..spec import spec_from_config
from ..storage.virtual import virtual_full, virtual_in_memory
from ..utils import to_chunksize


def _block_offset(offset):
    """A block's linear offset: a host integer, or (under vmap) a tensor."""
    if isinstance(offset, torch.Tensor):
        return offset.reshape(-1)[0]
    return int(np.asarray(offset).reshape(-1)[0])


def _positions(n: int, dtype) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=get_device())


def _times(count, factor):
    """``count * factor`` in float64 when *factor* is a float (the JAX
    package's x64 arithmetic; torch would make an int64 tensor times a
    Python float a float32)."""
    if isinstance(count, torch.Tensor) and isinstance(factor, float):
        return count.to(torch.float64) * factor
    return count * factor


def arange(start, /, stop=None, step=1, *, dtype=None, device=None, chunks="auto", spec=None):
    if stop is None:
        start, stop = 0, start
    num = int(max(np.ceil((stop - start) / step), 0))
    if dtype is None:
        dtype = np.arange(start, stop, step * num if num else step).dtype
    chunks = normalize_chunks(chunks, (num,), dtype=dtype)
    chunksize = chunks[0][0] if chunks[0] else 1
    floating = isinstance(start, (float, np.floating)) or isinstance(step, (float, np.floating))
    start, step = (float(start), float(step)) if floating else (int(start), int(step))

    def _arange_chunk(chunk, offset=None, numblocks=None):
        bstart = start + _times(_block_offset(offset) * chunksize, step)
        vals = bstart + _times(_positions(chunk.shape[0], torch.float64 if floating else torch.int64), step)
        return vals.to(to_torch_dtype(dtype))

    _arange_chunk.supports_offset = True
    _arange_chunk.batchable = True
    return map_blocks(_arange_chunk, empty((num,), dtype=dtype, chunks=chunks, spec=spec), dtype=dtype)


def asarray(obj, /, *, dtype=None, device=None, copy=None, chunks="auto", spec=None):
    if isinstance(obj, CoreArray):
        if dtype is not None and obj.dtype != np.dtype(dtype):
            from .data_type_functions import astype

            return astype(obj, dtype)
        return obj
    a = np.asarray(obj, dtype=dtype)
    if a.dtype == np.float16:
        raise NotImplementedError("float16 is not supported")
    spec = spec_from_config(spec)
    outchunks = normalize_chunks(chunks, a.shape, dtype=a.dtype)
    target = virtual_in_memory(a, to_chunksize(outchunks) if a.shape else ())
    name = gensym("array")
    return new_array(name, target, spec, Plan._new(name, "asarray", target))


def empty(shape, *, dtype=None, device=None, chunks="auto", spec=None):
    return empty_virtual_array(shape, dtype=dtype, chunks=chunks, spec=spec, hidden=False)


def empty_like(x, /, *, dtype=None, device=None, chunks=None, spec=None):
    return empty(**_like_args(x, dtype, chunks, spec))


def empty_virtual_array(shape, *, dtype=None, device=None, chunks="auto", spec=None, hidden=True):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return _empty_virtual_array(shape, dtype=np.float64 if dtype is None else dtype, chunks=chunks,
                                spec=spec, hidden=hidden)


def eye(n_rows, n_cols=None, /, *, k=0, dtype=None, device=None, chunks="auto", spec=None):
    if n_cols is None:
        n_cols = n_rows
    if dtype is None:
        dtype = np.dtype(np.float64)
    shape = (n_rows, n_cols)
    chunks = normalize_chunks(chunks, shape, dtype=dtype)
    chunksize = to_chunksize(chunks)
    nb1 = len(chunks[1])

    def _eye_chunk(chunk, offset=None, numblocks=None):
        m, n = chunk.shape
        off = _block_offset(offset)
        ii = (off // nb1 * chunksize[0] + _positions(m, torch.int64))[:, None]
        jj = (off % nb1 * chunksize[1] + _positions(n, torch.int64))[None, :]
        return (jj - ii == k).to(to_torch_dtype(dtype))

    _eye_chunk.supports_offset = True
    _eye_chunk.batchable = True
    return map_blocks(_eye_chunk, empty(shape, dtype=dtype, chunks=chunks, spec=spec), dtype=dtype)


def full(shape, fill_value, *, dtype=None, device=None, chunks="auto", spec=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = np.dtype(np.bool_)
        elif isinstance(fill_value, int):
            dtype = np.dtype(np.int64)
        elif isinstance(fill_value, float):
            dtype = np.dtype(np.float64)
        else:
            raise TypeError(f"Invalid input to full: {fill_value!r}")
    dtype = np.dtype(dtype)
    spec = spec_from_config(spec)
    outchunks = normalize_chunks(chunks, shape, dtype=dtype)
    target = virtual_full(shape, fill_value, dtype=dtype, chunks=to_chunksize(outchunks) if shape else ())
    name = gensym("full")
    return new_array(name, target, spec, Plan._new(name, "full", target))


def full_like(x, /, fill_value, *, dtype=None, device=None, chunks=None, spec=None):
    return full(fill_value=fill_value, **_like_args(x, dtype, chunks, spec))


def linspace(start, stop, /, num=50, *, dtype=None, device=None, endpoint=True, chunks="auto", spec=None):
    div = (num - 1) if endpoint else num
    div = div if div > 0 else 1
    step = float(stop - start) / div
    if dtype is None:
        dtype = np.dtype(np.float64)
    chunks = normalize_chunks(chunks, (num,), dtype=dtype)
    chunksize = chunks[0][0] if chunks[0] else 1

    def _linspace_chunk(chunk, offset=None, numblocks=None):
        first = _block_offset(offset) * chunksize
        blen = chunk.shape[0]
        vals = start + _times(first, step) + _times(_positions(blen, torch.float64), step)
        if endpoint and num > 1:
            # the last element is `stop` exactly, as numpy's is: the block's
            # affine form is a rounding step off there
            last = first + _positions(blen, torch.int64) == num - 1
            vals = torch.where(last, torch.full_like(vals, float(stop)), vals)
        return vals.to(to_torch_dtype(dtype))

    _linspace_chunk.supports_offset = True
    _linspace_chunk.batchable = True
    return map_blocks(_linspace_chunk, empty((num,), dtype=dtype, chunks=chunks, spec=spec), dtype=dtype)


def meshgrid(*arrays, indexing="xy"):
    if len({a.dtype for a in arrays}) > 1:
        raise ValueError("meshgrid inputs must all have the same dtype")
    from .manipulation_functions import broadcast_arrays, expand_dims

    if indexing == "xy" and len(arrays) > 1:
        arrays = (arrays[1], arrays[0]) + tuple(arrays[2:])
    n = len(arrays)
    grids = []
    for i, a in enumerate(arrays):
        for _ in range(i):
            a = expand_dims(a, axis=0)
        for _ in range(i + 1, n):
            a = expand_dims(a, axis=a.ndim)
        grids.append(a)
    grids = list(broadcast_arrays(*grids))
    if indexing == "xy" and len(arrays) > 1:
        grids[0], grids[1] = grids[1], grids[0]
    return grids


def ones(shape, *, dtype=None, device=None, chunks="auto", spec=None):
    return full(shape, 1, dtype=np.float64 if dtype is None else dtype, chunks=chunks, spec=spec)


def ones_like(x, /, *, dtype=None, device=None, chunks=None, spec=None):
    return ones(**_like_args(x, dtype, chunks, spec))


def tril(x, /, *, k=0):
    if x.ndim < 2:
        raise ValueError("x must be at least 2-dimensional for tril")
    from .searching_functions import where

    return where(_tri_mask(x, k), x, zeros_like(x))


def triu(x, /, *, k=0):
    if x.ndim < 2:
        raise ValueError("x must be at least 2-dimensional for triu")
    from .searching_functions import where

    return where(_tri_mask(x, k - 1), zeros_like(x), x)


def _tri_mask(x, k):
    """Boolean mask (row >= column - k) on x's trailing two dims and chunks."""
    cm, cn = x.chunks[-2], x.chunks[-1]

    def _mask_chunk(chunk, block_id=None):
        i0 = sum(cm[: block_id[0]])
        j0 = sum(cn[: block_id[1]])
        mm, nn = chunk.shape
        ii = (i0 + _positions(mm, torch.int64))[:, None]
        jj = (j0 + _positions(nn, torch.int64))[None, :]
        return ii >= (jj - k)

    return map_blocks(
        _mask_chunk,
        empty((x.shape[-2], x.shape[-1]), dtype=np.bool_, chunks=(cm, cn), spec=x.spec),
        dtype=np.dtype(np.bool_),
    )


def zeros(shape, *, dtype=None, device=None, chunks="auto", spec=None):
    return full(shape, 0, dtype=np.float64 if dtype is None else dtype, chunks=chunks, spec=spec)


def zeros_like(x, /, *, dtype=None, device=None, chunks=None, spec=None):
    return zeros(**_like_args(x, dtype, chunks, spec))


def _like_args(x, dtype=None, chunks=None, spec=None):
    return dict(shape=x.shape, dtype=x.dtype if dtype is None else dtype,
                chunks=x.chunks if chunks is None else chunks, spec=x.spec if spec is None else spec)


def from_dlpack(x, /, *, device=None, copy=None, chunks="auto", spec=None):
    """An array from any object that exports DLPack, always by copy through
    the host (a lazy plan may read it long after the exporter changes its
    buffer): ``copy=False`` and ``device`` are refused."""
    if not hasattr(x, "__dlpack__"):
        raise TypeError(f"from_dlpack requires an object with __dlpack__; got {type(x).__name__}")
    if copy is False:
        raise ValueError("from_dlpack(copy=False) is not supported: host data is always imported by copy")
    if device is not None:
        raise ValueError("from_dlpack(device=...) is not supported: arrays are placed by the executor")
    try:
        host = np.from_dlpack(x)
    except BufferError:
        host = np.asarray(x)
        if host.dtype == object:
            raise
    return asarray(np.array(host, copy=True), chunks=chunks, spec=spec)
