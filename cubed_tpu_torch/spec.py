"""Resource specification carried by every array. Counterpart of
``cubed_tpu/spec.py``, trimmed to the work directory, the memory bounds, the
executor and the device executor's residency budget."""

from __future__ import annotations

import tempfile
from typing import Any, Optional, Union

from .utils import convert_to_bytes, memory_repr

#: Defaults when no spec is given (the JAX package's)
DEFAULT_ALLOWED_MEM = 200_000_000
DEFAULT_RESERVED_MEM = 100_000_000


class Spec:
    """Specification of resources available to run a computation."""

    def __init__(
        self,
        work_dir: Optional[str] = None,
        allowed_mem: Union[int, str, None] = None,
        reserved_mem: Union[int, str, None] = 0,
        executor: Optional[Any] = None,
        device_mem: Union[int, str, None] = None,
        executor_name: Optional[str] = None,
        executor_options: Optional[dict] = None,
    ):
        self._work_dir = work_dir
        self._reserved_mem = convert_to_bytes(reserved_mem or 0)
        if allowed_mem is None:
            self._allowed_mem = self._reserved_mem
        else:
            self._allowed_mem = convert_to_bytes(allowed_mem)
        self._executor = executor
        self._executor_name = executor_name
        self._executor_options = executor_options
        self._device_mem = convert_to_bytes(device_mem) if device_mem is not None else None

    @property
    def work_dir(self) -> Optional[str]:
        """The local directory for intermediate Zarr data."""
        return self._work_dir

    @property
    def allowed_mem(self) -> int:
        """Memory (bytes) one task may use: an op whose projected memory
        exceeds it raises when the op is built."""
        return self._allowed_mem

    @property
    def reserved_mem(self) -> int:
        """Memory (bytes) reserved on a worker before any task runs."""
        return self._reserved_mem

    @property
    def executor(self) -> Optional[Any]:
        """The executor ``compute()`` uses when it is given none: the one
        passed in, else one created from ``executor_name`` (and
        ``executor_options``) at first use, else None (the sequential one)."""
        if self._executor is None and self._executor_name is not None:
            from .runtime.create import create_executor

            self._executor = create_executor(self._executor_name, self._executor_options)
        return self._executor

    @property
    def device_mem(self) -> Optional[int]:
        """Residency budget (bytes) of the device executor, when it is not
        given one itself."""
        return self._device_mem

    def __repr__(self) -> str:
        return (
            f"Spec(work_dir={self._work_dir!r}, "
            f"allowed_mem={memory_repr(self._allowed_mem)}, "
            f"reserved_mem={memory_repr(self._reserved_mem)}, "
            f"executor={self._executor!r})"
        )

    def __eq__(self, other) -> bool:
        if other is self:
            return True
        if isinstance(other, Spec):
            return (
                self.work_dir == other.work_dir
                and self.allowed_mem == other.allowed_mem
                and self.reserved_mem == other.reserved_mem
                and self.executor == other.executor
            )
        return False


def spec_from_config(spec: Optional[Spec]) -> Spec:
    """Fill in a default spec (temp work_dir, 200MB allowed / 100MB reserved)."""
    if spec is not None:
        return spec
    return Spec(
        work_dir=tempfile.gettempdir(),
        allowed_mem=DEFAULT_ALLOWED_MEM,
        reserved_mem=DEFAULT_RESERVED_MEM,
    )
