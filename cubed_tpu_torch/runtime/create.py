"""Executor registry: create executors by name (``Spec(executor_name=...)``).
Counterpart of ``cubed_tpu/runtime/create.py`` with the port's two executors."""

from __future__ import annotations

from typing import Optional


def create_executor(name: str, executor_options: Optional[dict] = None):
    executor_options = executor_options or {}
    if name in ("single-threaded", "python"):
        from .executors.python import PythonDagExecutor

        return PythonDagExecutor(**executor_options)
    if name == "cuda":
        from .executors.cuda import CudaExecutor

        return CudaExecutor(**executor_options)
    raise ValueError(f"Unrecognized executor name: {name!r}")
