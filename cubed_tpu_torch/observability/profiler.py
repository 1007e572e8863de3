"""**Device** profiler: torch.profiler traces and per-op device memory,
folded into the span pipeline.

Counterpart of ``cubed_tpu/observability/profiler.py``.
:class:`TorchProfilerCallback` brackets a compute in a ``torch.profiler``
session with CPU and CUDA activity and writes its Chrome trace, and
:class:`DeviceMemoryCallback` reads the CUDA caching allocator's counters
per op. Both record :func:`collect.record_decision` entries, so they appear
on the ``scheduler`` lane of a merged trace next to the host-side story.

CUDA is asynchronous: an executor's task spans are host time around queued
launches, and the device time is in this profiler's trace alone. The
session therefore synchronizes the device before it stops, or it would
lose the compute's last kernels. Both callbacks act in
``on_compute_start``/``on_compute_end``/``on_operation_start``, which every
executor fires outside a CUDA graph capture.

``cubed_tpu_torch.extensions.profiler`` re-exports both classes.
"""

from __future__ import annotations

import os

import torch

from ..backend_array_api import get_device
from ..runtime.types import Callback
from .collect import record_decision


class TorchProfilerCallback(Callback):
    """Write a torch.profiler Chrome trace, ``trace-<compute_id>.json`` in
    *log_dir*, for the span of one compute call (``trace_path`` after it)."""

    def __init__(self, log_dir: str = "profile"):
        self.log_dir = log_dir
        self.trace_path = None
        self._prof = None
        self._cuda = False

    def on_compute_start(self, event) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        self._cuda = get_device().type == "cuda"
        if self._cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.trace_path = None
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except Exception:
            self._prof = None  # no profiler here: the compute runs unprofiled
            return
        self._prof = prof
        record_decision("torch_profiler_start", log_dir=self.log_dir)

    def on_compute_end(self, event) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        if self._cuda:
            torch.cuda.synchronize()  # the compute's last kernels, recorded
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        name = getattr(event, "compute_id", None) or f"pid{os.getpid()}"
        path = os.path.join(self.log_dir, f"trace-{name}.json")
        prof.export_chrome_trace(path)
        self.trace_path = path
        record_decision("torch_profiler_stop", log_dir=self.log_dir, trace_path=path)


class DeviceMemoryCallback(Callback):
    """Record per-op device memory watermarks (the caching allocator's
    current and peak allocated bytes; None on the CPU or without stats)."""

    def __init__(self):
        self.samples: list[dict] = []

    def on_operation_start(self, event) -> None:
        try:
            dev = get_device()
            stats = torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}
        except Exception:
            stats = {}
        sample = {
            "op": event.name,
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        }
        self.samples.append(sample)
        record_decision("device_memory", **sample)
