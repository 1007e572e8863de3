"""The device profiler callbacks at their extensions import path
(counterpart of ``cubed_tpu/extensions/profiler.py``); they live in
``cubed_tpu_torch.observability.profiler``."""

from __future__ import annotations

from ..observability.profiler import (  # noqa: F401
    DeviceMemoryCallback,
    TorchProfilerCallback,
)

__all__ = ["TorchProfilerCallback", "DeviceMemoryCallback"]
