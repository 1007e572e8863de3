"""Observability: span tracing, metrics, byte accounting and the device
profiler. Counterpart of ``cubed_tpu/observability/__init__.py``, for the
modules ported so far.

Every executor reports through one event stream (the ``Callback``
lifecycle in ``runtime/types.py``); this package turns it into

- **traces**: :class:`TracingCallback` writes a Perfetto-loadable
  ``trace.json`` with one span per task (op, chunk key, attempt, executor);
- **metrics**: a process-local :class:`MetricsRegistry` (:func:`get_registry`)
  of counters, gauges and histograms, whose per-compute delta rides
  ``ComputeEndEvent.executor_stats``;
- **byte accounting**: the Zarr store records ``bytes_read`` /
  ``bytes_written`` per chunk, attributed to the task that did the IO
  (``accounting.task_scope``);
- **merged traces**: :class:`TraceCollector` merges lifecycle spans, task
  sub-spans (storage IO, kernel apply), scheduler decisions and memory
  samples into one clock-aligned trace per compute, with a straggler watch;
- **correlated logs**: compute/op/chunk contextvars (``logs``);
- **the device profiler**: :class:`TorchProfilerCallback` (a
  ``torch.profiler`` trace per compute) and :class:`DeviceMemoryCallback`.
"""

from .accounting import (  # noqa: F401
    record_bytes_read,
    record_bytes_written,
    record_virtual_read,
    reset_store_totals,
    scope_span,
    store_totals,
    task_scope,
)
from .callback import TracingCallback  # noqa: F401
from .collect import (  # noqa: F401
    TraceCollector,
    record_decision,
    record_sample,
)
from .events import EventLogCallback, PlanRow  # noqa: F401
from .metrics import (  # noqa: F401
    MetricsRegistry,
    get_registry,
    merge_snapshots,
)
from .profiler import DeviceMemoryCallback, TorchProfilerCallback  # noqa: F401
from .tracer import Tracer  # noqa: F401
