"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries land in ``kernels/_build/``, named by a hash of their
source and of the shared headers (``csrc/*.cuh``), so an edited source
rebuilds and an unchanged one is reused. ``build_all`` starts one nvcc per
source at once and waits for all of them.

Each build keeps ptxas's report (``-Xptxas -v``) beside its library;
:func:`resource_usage` reads each kernel's registers and spills from it, and
:func:`sass_opcodes` counts the instructions of a built kernel by opcode
(``cuobjdump -sass``).
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("philox_uniform", "region_sum", "fma_sum", "merge_sort", "flash_block")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, then ``PATH``,
    then ``/usr/local/cuda/bin/nvcc``."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = []
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of cubed_tpu_torch are built from source at first use"
    )


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, f"{name}.cu"), *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _log_path(name: str) -> str:
    return _lib_path(name)[: -len(".so")] + ".ptxas.txt"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    final = _lib_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, final


def _finish_build(name: str, started) -> None:
    proc, tmp, final = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    with open(f"{tmp}.txt", "w") as f:
        f.write(out)
    os.replace(f"{tmp}.txt", _log_path(name))
    os.replace(tmp, final)  # atomic: a concurrent builder sees all or nothing


def build_all() -> None:
    """Build every kernel library not yet built, all nvcc runs in parallel."""
    with _lock:
        started = {name: _start_build(name) for name in SOURCES}
        errors = []
        for name, s in started.items():
            if s is None:
                continue
            try:
                _finish_build(name, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel *name*, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        started = _start_build(name)
        if started is not None:
            _finish_build(name, started)
        lib = ctypes.CDLL(_lib_path(name))
        _loaded[name] = lib
        return lib


_sm_counts: dict = {}
_tickets: dict = {}
#: the most ticket counters a launch has asked for, per device index
_wanted: dict = {}
#: ticket counters first allocated for a stream: a split launch uses fewer
#: than ``_geometry.CTAS_PER_SM`` per SM (a larger need grows the buffer)
_TICKETS = 1024


def sm_count(device) -> int:
    """Streaming multiprocessors of CUDA *device* (cached)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def tickets(device, n: int):
    """The ticket counters of the current stream on CUDA *device*: an int32
    tensor of at least *n* entries, all 0 between launches (the CTA that
    draws a counter's last ticket sets it back to 0). Each stream has its
    own, so launches on two streams never share a counter. The largest *n*
    asked for on a device is recorded: :func:`reserve_tickets` allocates
    that many for a stream before a CUDA graph is captured on it."""
    device = torch.device(device)
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    with _lock:
        _wanted[stream.device_index] = max(n, _wanted.get(stream.device_index, 0))
        buf = _tickets.get(key)
        if buf is None or buf.numel() < n:
            if torch.cuda.is_current_stream_capturing():
                # the buffer would live in the graph's pool and be zeroed by
                # the graph: the capturing executor reserves it beforehand
                raise RuntimeError(f"ticket counters for {n} outputs first asked for under CUDA graph capture")
            with torch.cuda.device(device):
                buf = _tickets[key] = torch.zeros(max(n, _TICKETS), dtype=torch.int32, device=device)
        return buf


def reserve_tickets(device):
    """The current stream's ticket counters, at least as many as any launch
    on *device* has asked for (call outside capture, on the capture stream).
    A graph captured on the stream keeps the tensor: a later, larger
    reservation replaces the stream's buffer without freeing this one."""
    device = torch.device(device)
    index = torch.cuda.current_stream(device).device_index
    return tickets(device, _wanted.get(index, 0))


#: the kernel wrappers that count their launches: each has ``launches`` and
#: ``paths`` (its launches by path), plain integers
COUNTED: list = []
#: held while a count changes: the threaded executor's tasks launch kernels
#: from several threads, and ``+=`` on a shared count is not atomic
COUNT_LOCK = threading.Lock()


def launch_counts() -> dict:
    """Every counted wrapper's ``launches`` and ``paths``, keyed by
    (wrapper name, path or None)."""
    out = {}
    for w in COUNTED:
        out[(w.__name__, None)] = w.launches
        for k, v in w.paths.items():
            out[(w.__name__, k)] = v
    return out


def add_launch_counts(delta: dict) -> None:
    """Add *delta* (as :func:`launch_counts` keys it) to the wrappers'
    counts: a replayed CUDA graph counts the launches it holds."""
    with COUNT_LOCK:
        for w in COUNTED:
            w.launches += delta.get((w.__name__, None), 0)
            for k in w.paths:
                w.paths[k] += delta.get((w.__name__, k), 0)


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def resource_usage(name: str) -> dict:
    """Per kernel of library *name* (mangled name): registers a thread and
    spill bytes, as ptxas reported them when the library was built."""
    build_all()
    usage: dict = {}
    current = None
    with open(_log_path(name)) as f:
        for line in f:
            m = _PTXAS_ENTRY.search(line)
            if m:
                current = usage.setdefault(m.group(1), {})
                continue
            if current is None:
                continue
            m = _PTXAS_SPILL.search(line)
            if m:
                current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = _PTXAS_REGS.search(line)
            if m:
                current["registers"] = int(m.group(1))
    return usage


_SASS_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_SASS_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_opcodes(name: str) -> dict:
    """Per kernel of library *name* (mangled name): a Counter of its SASS
    instructions by opcode with modifiers (``IMAD.WIDE.U32``), from
    ``cuobjdump -sass`` beside the nvcc that built it."""
    build_all()
    return library_sass_opcodes(_lib_path(name))


def library_sass_opcodes(path: str) -> dict:
    """:func:`sass_opcodes` of the built library at *path*."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    counts: dict = {}
    current = None
    for line in out.splitlines():
        m = _SASS_FUNCTION.match(line)
        if m:
            current = counts.setdefault(m.group(1), collections.Counter())
            continue
        m = _SASS_INSTRUCTION.search(line)
        if m and current is not None:
            current[m.group(1)] += 1
    return counts
