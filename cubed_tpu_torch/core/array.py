"""CoreArray: the chunked-array handle tying together a name, a (possibly lazy)
Zarr target, a Spec and a Plan. Counterpart of ``cubed_tpu/core/array.py``."""

from __future__ import annotations

from math import prod
from typing import Optional, Sequence

import numpy as np

from ..chunks import blockdims_from_blockshape
from ..spec import Spec
from ..storage.zarr import open_if_lazy_zarr_array
from ..utils import chunk_memory


class CoreArray:
    """A chunked n-dimensional array handle participating in a lazy plan."""

    def __init__(self, name: str, zarray_maybe_lazy, spec: Spec, plan):
        self.name = name
        self.zarray_maybe_lazy = zarray_maybe_lazy
        self.spec = spec
        self.plan = plan

    @property
    def chunkmem(self) -> int:
        """Bytes of one chunk of this array."""
        return chunk_memory(self.dtype, self.chunksize)

    @property
    def chunks(self) -> tuple[tuple[int, ...], ...]:
        return blockdims_from_blockshape(self.shape, self.zarray_maybe_lazy.chunks)

    @property
    def chunksize(self) -> tuple[int, ...]:
        return tuple(self.zarray_maybe_lazy.chunks)

    @property
    def dtype(self):
        return self.zarray_maybe_lazy.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def numblocks(self) -> tuple[int, ...]:
        return tuple(len(c) for c in self.chunks)

    @property
    def npartitions(self) -> int:
        return prod(self.numblocks) if self.shape else 1

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.zarray_maybe_lazy.shape)

    @property
    def size(self) -> int:
        return prod(self.shape) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def zarray(self):
        """The concrete storage array (opens a lazy target)."""
        return open_if_lazy_zarr_array(self.zarray_maybe_lazy)

    def compute(self, **kwargs):
        """Execute the plan for this array and return it as a numpy array."""
        result = compute(self, **kwargs)
        return result[0] if result else None

    def _read_stored(self) -> np.ndarray:
        arr = self.zarray
        return np.asarray(arr[...] if self.shape else arr[()])

    def rechunk(self, chunks, **kwargs):
        """This array with another chunking (see ``core.ops.rechunk``)."""
        from .ops import rechunk

        return rechunk(self, chunks, **kwargs)

    def visualize(self, *args, **kwargs):
        """The plan that computes this array, drawn (``Plan.visualize``)."""
        return self.plan.visualize(*args, **kwargs)

    def explain(self, **kwargs):
        """EXPLAIN the plan that computes this array (``Plan.explain``),
        defaulting the spec and target array name to this array's."""
        kwargs.setdefault("spec", self.spec)
        kwargs.setdefault("array_names", (self.name,))
        return self.plan.explain(**kwargs)

    def __getitem__(self, key):
        from .ops import index

        return index(self, key)

    def __repr__(self) -> str:
        return f"cubed_tpu_torch.CoreArray<{self.name}, shape={self.shape}, dtype={self.dtype}, chunks={self.chunks}>"


def check_array_specs(arrays: Sequence) -> Optional[Spec]:
    """All arrays in one computation must share an equivalent Spec."""
    specs = [a.spec for a in arrays if hasattr(a, "spec")]
    if not specs:
        return None
    first = specs[0]
    for other in specs[1:]:
        if other != first:
            raise ValueError(
                f"Arrays must have same spec in single computation. "
                f"Specs: {first!r} and {other!r}"
            )
    return first


def compute(*arrays, executor=None, callbacks=None, optimize_graph: bool = True,
            optimize_function=None, resume: Optional[bool] = None, **kwargs) -> list[np.ndarray]:
    """Compute several arrays in one plan execution; return numpy results.

    The executor is *executor*, else the arrays' ``Spec.executor``, else the
    sequential ``PythonDagExecutor``. The plan is optimized by
    *optimize_function* (default: the fusion of
    ``multiple_inputs_optimize_dag``) unless *optimize_graph* is false. The
    chunk device is resolved first, so a missing card fails here, before any
    task runs (``backend_array_api.get_device``). ``resume``,
    ``resume_from_journal``, ``deadline_s`` and ``cancellation`` go to
    ``Plan.execute``."""
    if not arrays:
        return []
    execute(*arrays, executor=executor, callbacks=callbacks, optimize_graph=optimize_graph,
            optimize_function=optimize_function, resume=resume, **kwargs)
    return [a._read_stored() for a in arrays]


def execute(*arrays, executor=None, callbacks=None, optimize_graph: bool = True, optimize_function=None,
            resume: Optional[bool] = None, **kwargs) -> None:
    """Run the plan of *arrays* as ``compute`` does, leaving the results in
    their stores (``to_zarr`` and ``store``: the user's store is the result,
    not read back)."""
    from ..backend_array_api import get_device
    from .plan import arrays_to_plan

    get_device()
    spec = check_array_specs(arrays)
    if executor is None:
        executor = spec.executor if spec is not None else None
    if executor is None:
        from ..runtime.executors.python import PythonDagExecutor

        executor = PythonDagExecutor()
    arrays_to_plan(*arrays).execute(
        executor=executor,
        callbacks=callbacks,
        optimize_graph=optimize_graph,
        optimize_function=optimize_function,
        array_names=tuple(a.name for a in arrays),
        spec=spec,
        resume=resume,
        **kwargs,
    )


def visualize(*arrays, filename="cubed", format=None, **kwargs):
    """Draw the combined plan of *arrays* (``Plan.visualize``)."""
    from .plan import arrays_to_plan

    return arrays_to_plan(*arrays).visualize(filename=filename, format=format, **kwargs)


def measure_reserved_mem(executor=None, work_dir: Optional[str] = None, **kwargs) -> int:
    """The memory the runtime holds before a task loads any data: the peak
    host memory that a one-element compute's task reports, for use as
    ``Spec(reserved_mem=...)``. It runs on *executor* (by default the
    sequential executor) on the chunk device, which is the card unless the
    caller asks for the CPU: without a card it raises, as ``compute`` does."""
    from ..array_api.creation_functions import ones
    from ..extensions.history import HistoryCallback
    from ..utils import peak_measured_mem

    a = ones((1,), chunks=(1,), spec=Spec(work_dir=work_dir, allowed_mem="100MB"))
    history = HistoryCallback()
    a.compute(executor=executor, callbacks=[history], **kwargs)
    peaks = [e.peak_measured_mem_start for e in history.events if e.peak_measured_mem_start is not None]
    return max(peaks) if peaks else peak_measured_mem()
