"""Observability: span tracing, metrics, byte accounting and the device
profiler, the flight recorder, analytics, run history, SLOs, alerts and
live telemetry. Counterpart of ``cubed_tpu/observability/__init__.py``.

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
  ``torch.profiler`` trace per compute) and :class:`DeviceMemoryCallback`;
- **flight recorder**: :class:`FlightRecorder` bundles the merged trace,
  metrics, plan projections, the op and chunk graphs, decision and alert
  timelines and the last log records into a post-mortem directory read by
  ``python -m cubed_tpu_torch.diagnose`` (``flightrecorder``);
- **live telemetry**: a bounded :class:`TimeSeriesStore` sampled ~1s from
  the registry (``timeseries``), served as Prometheus ``/metrics`` +
  ``/healthz`` + ``/snapshot.json`` on 127.0.0.1 by a stdlib-HTTP thread
  armed via ``Spec(telemetry_port=...)`` / ``CUBED_TPU_TORCH_TELEMETRY_PORT``
  (``export``), watched by an :class:`AlertEngine` (``alerts``) and
  rendered by ``python -m cubed_tpu_torch.top``;
- **the dispatch profiler**: :class:`DispatchProfiler`, a bounded
  ``sys._current_frames()`` sampler over the client's threads, armed via
  ``Spec(dispatch_profile=True)`` / ``CUBED_TPU_TORCH_DISPATCH_PROFILE``
  (``dispatchprofile``);
- **SLOs and run history**: a durable, bounded run archive (``runs.jsonl``
  via ``Spec(run_history=...)``) of every compute with its ``analyze()``
  buckets (``runhistory``), per-tenant :class:`SloSpec` objectives with
  error budgets and burn rates (``slo``), and cross-run regressions named
  bucket by bucket by ``python -m cubed_tpu_torch.regress``;
- **compute analytics**: :func:`explain` / ``plan.explain()`` (``python -m
  cubed_tpu_torch.explain``) and :func:`analyze`, the critical path and a
  wall-clock attribution from a bundle or a live collector (``analytics``).
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
from .analytics import (  # noqa: F401
    AnalysisReport,
    ExplainReport,
    analyze,
    explain,
    regression_diff,
    render_regression,
)
from .callback import TracingCallback  # noqa: F401
from .collect import (  # noqa: F401
    TraceCollector,
    record_decision,
    record_sample,
)
from .alerts import (  # noqa: F401
    AlertEngine,
    AlertRule,
    BurnRateRule,
    DispatchSaturationRule,
    SloBurnRateRule,
    StallRule,
    ThresholdRule,
    default_rules,
)
from .runhistory import (  # noqa: F401
    RunHistory,
    find_baseline,
    load_runs,
)
from .slo import (  # noqa: F401
    SloBoard,
    SloSpec,
)
from .dispatchprofile import (  # noqa: F401
    DispatchProfiler,
    profile_enabled,
    profile_for,
)
from .events import EventLogCallback, PlanRow  # noqa: F401
from .export import (  # noqa: F401
    TelemetryRuntime,
    prometheus_text,
    resolve_port,
)
from .flightrecorder import FlightRecorder, load_bundle  # noqa: F401
from .metrics import (  # noqa: F401
    MetricsRegistry,
    get_registry,
    merge_snapshots,
)
from .profiler import DeviceMemoryCallback, TorchProfilerCallback  # noqa: F401
from .timeseries import (  # noqa: F401
    TelemetrySampler,
    TimeSeriesStore,
)
from .tracer import Tracer  # noqa: F401
