"""Host arrays as device constants: each uploaded once, outside any CUDA
graph capture, and read by later computes and by the graphs captured from
them (integer-array selections, the sort network's block permutations, the
table rows of permuted Philox seed grids).

A captured graph reads a constant by its address, so the tensor must live
as long as the graph, whatever this cache evicts: every constant read inside
:func:`recording` is appended to its list, and the captured graph keeps that
list. The cache keeps the :data:`LIMIT` most recently read constants.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections import OrderedDict

import numpy as np
import torch

#: constants kept by the cache, least recently read evicted first
LIMIT = 256

#: key (contents or identity, dtype, device) -> (the host array, its tensor)
_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()

_RECORDING: contextvars.ContextVar = contextvars.ContextVar("device_constants_recording", default=None)


def constant(array: np.ndarray, device, dtype=np.int64, by_id: bool = False) -> torch.Tensor:
    """*array* in *dtype* as a tensor on *device*, uploaded at its first
    read. Keyed by its contents, or with *by_id* by the host array's
    identity (the entry keeps the array alive, so its id stays its own): for
    large arrays read at every task. Raises where the first read would be
    inside a capture."""
    device = torch.device(device)
    if by_id:
        key = ("id", id(array), np.dtype(dtype).str, str(device))
    else:
        array = np.ascontiguousarray(array, dtype=dtype)
        key = (array.dtype.str, array.shape, array.tobytes(), str(device))
    entry = _CACHE.get(key)
    if entry is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a host array first read under CUDA graph capture")
        entry = _CACHE[key] = (array, torch.as_tensor(np.ascontiguousarray(array, dtype=dtype), device=device))
        while len(_CACHE) > LIMIT:
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(key)
    pins = _RECORDING.get()
    if pins is not None:
        pins.append(entry[1])
    return entry[1]


@contextlib.contextmanager
def recording():
    """Within this block every constant read is appended to the yielded
    list (a capture keeps it with its graph)."""
    pins: list = []
    token = _RECORDING.set(pins)
    try:
        yield pins
    finally:
        _RECORDING.reset(token)

