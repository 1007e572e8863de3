"""Executor registry: create executors by name (``Spec(executor_name=...)``).
Counterpart of ``cubed_tpu/runtime/create.py`` with the port's executors:
the sequential one, the threaded one, the process pool, the TCP fleet and
the device executor."""

from __future__ import annotations

from typing import Optional


def create_executor(name: str, executor_options: Optional[dict] = None):
    executor_options = executor_options or {}
    if name in ("single-threaded", "python"):
        from .executors.python import PythonDagExecutor

        return PythonDagExecutor(**executor_options)
    if name in ("threads", "async-python"):
        from .executors.python_async import AsyncPythonDagExecutor

        return AsyncPythonDagExecutor(**executor_options)
    if name == "processes":
        from .executors.multiprocess import MultiprocessDagExecutor

        return MultiprocessDagExecutor(**executor_options)
    if name == "distributed":
        from .executors.distributed import DistributedDagExecutor

        return DistributedDagExecutor(**executor_options)
    if name == "cuda":
        from .executors.cuda import CudaExecutor

        return CudaExecutor(**executor_options)
    raise ValueError(f"Unrecognized executor name: {name!r}")
