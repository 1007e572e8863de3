"""General utilities: plan-node names, byte strings, chunk memory and chunk math.

Counterpart of ``cubed_tpu/utils.py``, trimmed to what the port's plan and
storage layers call, the peak and current host memory a task reports (the
memory guard reads the current), and the caller's
frames a plan node records for ``visualize``. The memory
reckoning is the JAX package's, unchanged, so both packages bound the same
plan by the same projected memory.
"""

from __future__ import annotations

import itertools
import platform
import re
import threading
from math import prod
from pathlib import Path
from posixpath import join as _urljoin
from dataclasses import dataclass
from resource import RUSAGE_SELF, getrusage
from typing import Sequence
from urllib.parse import urlsplit, urlunsplit

import numpy as np

#: process-global counter shared by every gensym'd plan identifier
sym_counter = itertools.count()
_sym_lock = threading.Lock()


def gensym(name: str = "op") -> str:
    """A unique plan-node identifier with a fixed-width counter."""
    with _sym_lock:
        return f"{name}-{next(sym_counter):09d}"


_BYTE_UNITS = {
    "": 1,
    "B": 1,
    "KB": 10**3,
    "MB": 10**6,
    "GB": 10**9,
    "TB": 10**12,
    "PB": 10**15,
    "KIB": 2**10,
    "MIB": 2**20,
    "GIB": 2**30,
    "TIB": 2**40,
    "PIB": 2**50,
    "K": 2**10,
    "M": 2**20,
    "G": 2**30,
    "T": 2**40,
    "P": 2**50,
}

_BYTES_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([A-Za-z]*)\s*$")


def convert_to_bytes(value: int | float | str | None) -> int | None:
    """Parse a human byte string (``"2GB"``, ``"100MiB"``, ``"1_000"``) to an int."""
    if value is None:
        return None
    if isinstance(value, (int, np.integer)):
        if value < 0:
            raise ValueError(f"Invalid byte value: {value!r} (negative)")
        return int(value)
    if isinstance(value, float):
        if not value.is_integer() or value < 0:
            raise ValueError(f"Invalid byte value: {value!r}")
        return int(value)
    if isinstance(value, str):
        m = _BYTES_RE.match(value.replace("_", ""))
        if not m:
            raise ValueError(f"Invalid byte string: {value!r}")
        number, unit = m.groups()
        unit = unit.upper()
        if unit not in _BYTE_UNITS:
            raise ValueError(f"Invalid byte unit {unit!r} in {value!r}")
        result = float(number) * _BYTE_UNITS[unit]
        if not float(result).is_integer():
            raise ValueError(f"Byte string {value!r} is not an integral byte count")
        return int(result)
    raise TypeError(f"Cannot convert {type(value)} to bytes")


def memory_repr(num: int | float) -> str:
    """Render a byte count human-readably (``1.5 GB``)."""
    if num < 1000:
        return f"{int(num)} bytes"
    for unit in ("KB", "MB", "GB", "TB", "PB"):
        num /= 1000.0
        if num < 1000.0:
            return f"{num:3.1f} {unit}"
    return f"{num:3.1f} EB"


def itemsize(dtype) -> int:
    return np.dtype(dtype).itemsize


def chunk_memory(dtype, chunksize: Sequence[int]) -> int:
    """Bytes of memory for one chunk of the given dtype and shape."""
    return itemsize(dtype) * prod(int(c) for c in chunksize)


def to_chunksize(chunkset: tuple[tuple[int, ...], ...]) -> tuple[int, ...]:
    """Collapse regular per-dim block sizes to a single chunk shape."""
    for chunks in chunkset:
        if len(chunks) > 1 and (len(set(chunks[:-1])) > 1 or chunks[-1] > chunks[0]):
            raise ValueError(f"Array must have regular chunks, but found chunks={chunkset}")
    return tuple(c[0] if len(c) > 0 else 1 for c in chunkset)


def accumulate_prepend_zero(seq: Sequence[int]) -> list[int]:
    out = [0]
    for s in seq:
        out.append(out[-1] + s)
    return out[:-1]


def get_item(chunks: tuple[tuple[int, ...], ...], idx: tuple[int, ...]) -> tuple[slice, ...]:
    """Convert a block index into the tuple of slices selecting that block."""
    starts = tuple(tuple(accumulate_prepend_zero(c)) for c in chunks)
    return tuple(
        slice(start[i], start[i] + c[i]) for c, start, i in zip(chunks, starts, idx)
    )


def offset_to_block_id(offset: int, numblocks: Sequence[int]) -> tuple[int, ...]:
    """Linear offset -> nd block index (C order)."""
    return tuple(int(i) for i in np.unravel_index(offset, tuple(numblocks)))


def block_id_to_offset(block_id: Sequence[int], numblocks: Sequence[int]) -> int:
    """nd block index -> linear offset (C order)."""
    return int(np.ravel_multi_index(tuple(block_id), tuple(numblocks)))


def join_path(dir_url: str, child_path: str) -> str:
    """Join a path to a directory that may be a filesystem path or a URL."""
    parts = urlsplit(str(dir_url))
    if parts.scheme in ("", "file"):
        return str(Path(str(dir_url).replace("file://", "")) / child_path)
    return urlunsplit(
        (parts.scheme, parts.netloc, _urljoin(parts.path, child_path), parts.query, parts.fragment)
    )


def broadcast_trick(func):
    """Wrap a numpy creation function so the result is a stride-0 broadcast."""

    def wrapper(shape, *args, **kwargs):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return np.broadcast_to(func((), *args, **kwargs), shape)

    wrapper.__name__ = getattr(func, "__name__", "broadcast_trick")
    return wrapper


def peak_measured_mem() -> int:
    """Peak RSS of this process in bytes (counterpart of
    ``cubed_tpu/utils.py:peak_measured_mem``).

    On Linux this reads VmHWM from ``/proc/self/status``, not
    ``getrusage(RUSAGE_SELF).ru_maxrss``: ru_maxrss survives ``execve``, so
    a process spawned from a large parent would report the parent's peak
    as its own floor; VmHWM belongs to this program's own address space."""
    if platform.system() == "Linux":
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmHWM:"):
                        return int(line.split()[1]) * 1024
        except OSError:
            pass
    ru_maxrss = getrusage(RUSAGE_SELF).ru_maxrss
    # ru_maxrss is KiB on Linux, bytes on macOS
    if platform.system() == "Darwin":
        return ru_maxrss
    return ru_maxrss * 1024


def current_measured_mem() -> int | None:
    """Current RSS of this process in bytes (VmRSS from ``/proc/self/status``),
    or None where there is no ``/proc``: the memory guard's host reading
    (``runtime/memory.py``). Counterpart of
    ``cubed_tpu/utils.py:current_measured_mem``."""
    return _proc_field("/proc/self/status", "VmRSS:")


def host_available_mem() -> int | None:
    """``MemAvailable`` from ``/proc/meminfo`` in bytes, or None: the memory
    guard's host-pressure floor. Counterpart of
    ``cubed_tpu/utils.py:host_available_mem``."""
    return _proc_field("/proc/meminfo", "MemAvailable:")


def _proc_field(path: str, field: str) -> int | None:
    if platform.system() != "Linux":
        return None
    try:
        with open(path) as f:
            for line in f:
                if line.startswith(field):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


@dataclass
class StackSummary:
    """One frame of the caller's stack, as a plan node records it."""

    filename: str
    lineno: int
    name: str
    array_names_to_variable_names: dict[str, str]

    def is_cubed(self) -> bool:
        normalized = self.filename.replace("\\", "/")
        return "/cubed_tpu_torch/" in normalized or normalized.endswith("cubed_tpu_torch")


def extract_stack_summaries(frame, limit: int = 10) -> list[StackSummary]:
    """The frames from *frame* outward (at most *limit*, outermost first),
    each with the names of the plan's arrays that its local variables hold,
    so ``visualize`` can label a node with the user's own variable name."""
    summaries: list[StackSummary] = []
    while frame is not None and len(summaries) < limit:
        name_map = {}
        try:
            for var, val in frame.f_locals.items():
                nm = getattr(val, "name", None)
                if nm is not None and type(nm) is str and hasattr(val, "zarray_maybe_lazy"):
                    name_map[nm] = var
        except Exception:
            pass
        summaries.append(StackSummary(frame.f_code.co_filename, frame.f_lineno, frame.f_code.co_name, name_map))
        frame = frame.f_back
    summaries.reverse()
    return summaries
