"""cubed_tpu_torch: the PyTorch and CUDA port of cubed_tpu.

Bounded-memory chunked N-dimensional arrays on a lazy blockwise DAG with
plan-time per-task memory bounds and Zarr v2 storage, whose chunk kernels run
as torch tensors on one device: ``cuda`` by default (an NVIDIA H100 with
hand-written kernels for the main path), ``cpu`` when asked for with
``CUBED_TPU_TORCH_DEVICE=cpu`` or ``backend_array_api.set_device("cpu")``.
The package imports torch, numpy and the standard library only.

The port runs the Array API standard's surface (creation, elementwise
functions and operators, indexing with ints, slices of any step, ``None``
and one integer array, manipulation, searching, ``prod``/``var``/``std``
and the cumulative scans beside ``sum``/``mean``/``max``/``min``, linear
algebra), ``random.random``, ``from_array``/``from_zarr``, ``rechunk`` and
``merge_chunks``, ``map_blocks``/``map_direct`` and ``apply_gufunc``, on
the sequential executor (the default) and on the device executor
(``runtime.executors.cuda.CudaExecutor``); ROADMAP.md lists the rest.
"""

__version__ = "0.1.0"

from .spec import Spec  # noqa: F401
from .core.array import compute  # noqa: F401
from .core.ops import from_array, from_zarr, map_blocks, map_direct, merge_chunks, rechunk  # noqa: F401
from .core.gufunc import apply_gufunc  # noqa: F401
from . import array_api  # noqa: F401
from .array_api import Array  # noqa: F401
from . import random  # noqa: F401

__all__ = [
    "__version__",
    "Array",
    "Spec",
    "apply_gufunc",
    "array_api",
    "compute",
    "from_array",
    "from_zarr",
    "map_blocks",
    "map_direct",
    "merge_chunks",
    "random",
    "rechunk",
]
