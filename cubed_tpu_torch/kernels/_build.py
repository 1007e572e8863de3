"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries land in ``kernels/_build/``, named by a hash of their
source, so an edited source rebuilds and an unchanged one is reused.
``build_all`` starts one nvcc per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("philox_uniform", "region_sum", "fma_sum")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


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


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
