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
algebra), sorting (``sort``/``argsort``/``searchsorted``/``topk`` on a bitonic
merge-split network of chunks) and the order statistics (``quantile``,
``median`` and their NaN forms, ``histogram``, ``cov``/``corrcoef``, the nan
reductions), ``pad``, ``random.random``/``normal``/``randint``,
``from_array``/``from_zarr``, ``to_zarr``/``store`` (the stdlib codecs
included), ``rechunk`` and ``merge_chunks``, ``map_blocks``/``map_direct``/
``map_overlap`` and ``apply_gufunc``, and plan introspection (``visualize``,
``measure_reserved_mem``), on
the sequential executor (the default) and on the device executor
(``runtime.executors.cuda.CudaExecutor``); ROADMAP.md lists the rest.
"""

__version__ = "0.1.0"

from .spec import Spec  # noqa: F401
from .runtime.types import Callback, TaskEndEvent  # noqa: F401
from .core.array import compute, measure_reserved_mem, visualize  # noqa: F401
from .core.ops import (  # noqa: F401
    from_array,
    from_zarr,
    map_blocks,
    map_direct,
    map_overlap,
    merge_chunks,
    rechunk,
    store,
    to_zarr,
)
from .core.gufunc import apply_gufunc  # noqa: F401
from .nan_functions import nanmax, nanmean, nanmin, nansum  # noqa: F401
from . import array_api  # noqa: F401
from .array_api import Array  # noqa: F401
from . import observability  # noqa: F401
from . import random  # noqa: F401
from . import service  # noqa: F401
from .service import ComputeService, ServiceConfig  # noqa: F401

__all__ = [
    "__version__",
    "Array",
    "Callback",
    "ComputeService",
    "ServiceConfig",
    "Spec",
    "TaskEndEvent",
    "apply_gufunc",
    "array_api",
    "compute",
    "from_array",
    "from_zarr",
    "map_blocks",
    "map_direct",
    "map_overlap",
    "measure_reserved_mem",
    "merge_chunks",
    "nanmax",
    "nanmean",
    "nanmin",
    "nansum",
    "observability",
    "random",
    "rechunk",
    "service",
    "store",
    "to_zarr",
    "visualize",
]
