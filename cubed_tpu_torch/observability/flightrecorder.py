"""Post-mortem flight recorder: a self-contained bundle per failed compute.
Counterpart of ``cubed_tpu/observability/flightrecorder.py``.

``FlightRecorder`` rides a compute like any callback (it extends
:class:`~cubed_tpu_torch.observability.collect.TraceCollector`, so it already
holds the merged clock-aligned trace) and, when the compute fails — or on
demand via :meth:`dump` — assembles everything a post-mortem needs into one
directory:

.. code-block:: text

    <bundle_dir>/bundle-<compute_id>/
        manifest.json   # status, error + failing op/chunk, metrics snapshot,
                        # per-op projected-vs-measured memory, the op and
                        # chunk graphs, decision timeline, alert timeline +
                        # time-series dump (when live telemetry was armed),
                        # stragglers, per-worker clock offsets
        trace.json      # the merged Perfetto trace (open in ui.perfetto.dev)
        logs.jsonl      # last-N correlated structured log records
        profile-<compute_id>.folded
                        # collapsed client stacks when the dispatch
                        # profiler was armed (flamegraph.pl/speedscope-ready)

Read it with ``python -m cubed_tpu_torch.diagnose <bundle>`` — slowest ops, top
stragglers, retry/quarantine/guard timelines, per-worker skew — or any JSON
tooling. Arm it per compute by passing the callback, or process-wide with
``CUBED_TPU_TORCH_FLIGHT_RECORDER=<dir>`` (``Plan.execute`` then attaches one to
every compute automatically).
"""

from __future__ import annotations

import json
import logging
import os
import time
import traceback
from typing import Optional

from . import logs
from .collect import TraceCollector, decisions_since
from .metrics import get_registry

logger = logging.getLogger(__name__)

#: env var naming a bundle directory: when set, every Plan.execute attaches
#: a FlightRecorder writing there
FLIGHT_RECORDER_ENV_VAR = "CUBED_TPU_TORCH_FLIGHT_RECORDER"

BUNDLE_MANIFEST = "manifest.json"
BUNDLE_TRACE = "trace.json"
BUNDLE_LOGS = "logs.jsonl"


class FlightRecorder(TraceCollector):
    """Assemble a post-mortem bundle on compute failure (or on demand).

    A FlightRecorder IS a :class:`TraceCollector` — attach one or the
    other, not both: each attached collector counts ``spans_dropped`` /
    ``stragglers_detected`` and records straggler instants independently,
    so doubling up double-counts them. To get a loose trace file AND
    bundles, attach one recorder and call its inherited ``export(path)``.

    Parameters
    ----------
    bundle_dir : str
        Where bundles are written (one ``bundle-<compute_id>`` dir each).
    on_failure : bool
        Assemble automatically when the compute ends with an error.
    always : bool
        Assemble for successful computes too.
    max_log_records : int
        How many trailing structured log records the bundle keeps.
    """

    def __init__(
        self,
        bundle_dir: str = "flight-recorder",
        on_failure: bool = True,
        always: bool = False,
        max_log_records: int = 400,
        **collector_kwargs,
    ):
        # the merged trace lives inside the bundle, not as a loose file
        collector_kwargs.setdefault("trace_dir", None)
        super().__init__(**collector_kwargs)
        self.bundle_dir = bundle_dir
        self.on_failure = on_failure
        self.always = always
        self.max_log_records = max_log_records
        self.bundle_path: Optional[str] = None
        # capture log records from the moment the recorder exists
        logs.install()

    def on_compute_end(self, event) -> None:
        super().on_compute_end(event)
        if self.always or (self.on_failure and self.error is not None):
            try:
                self.bundle_path = self.dump()
                logger.warning(
                    "flight-recorder bundle written: %s (read it with "
                    "'python -m cubed_tpu_torch.diagnose %s')",
                    self.bundle_path, self.bundle_path,
                )
            except Exception:
                # the recorder must never mask the compute's own failure
                logger.exception(
                    "failed to assemble flight-recorder bundle for "
                    "compute %s", self.compute_id,
                )

    # -- bundle assembly -----------------------------------------------

    def _failing_tasks(self) -> list[dict]:
        """The failure timeline: task_failed decisions recorded during this
        compute, most recent last (the last one usually names the killer;
        fail-fasts arrive as classification="fail_fast")."""
        return [
            d for d in decisions_since(self._t0)
            if d["kind"] == "task_failed"
        ][-50:]

    def _alert_timeline(self) -> list:
        """Alert firings recorded during this compute (the alert engine
        lands every firing on the decision ring, so the bundle carries the
        alert timeline even when the telemetry endpoint is gone by
        post-mortem time)."""
        return [
            d for d in decisions_since(self._t0)
            if d["kind"] == "alert_fired"
        ]

    def _timeseries_dump(self) -> Optional[list]:
        """A bounded dump of the live time-series store covering this
        compute's window, or None when telemetry was never armed."""
        from .export import get_runtime

        runtime = get_runtime()
        if runtime is None:
            return None
        window_s = max(60.0, time.time() - self._t0 + 5.0)
        return runtime.store.to_dict(window_s=window_s, max_points=120)

    def manifest(self) -> dict:
        error = self.error
        err_block = None
        if error is not None:
            err_block = {
                "type": type(error).__name__,
                "message": str(error),
                "traceback": "".join(
                    traceback.format_exception(
                        type(error), error, error.__traceback__
                    )
                )[-8000:],
            }
            failures = self._failing_tasks()
            if failures:
                last = failures[-1]
                err_block["op"] = last.get("op")
                err_block["chunk"] = last.get("chunk")
        return {
            "compute_id": self.compute_id,
            "created_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "status": "failed" if error is not None else "succeeded",
            "wall_clock_s": (
                (self.end_tstamp - self.start_tstamp)
                if self.end_tstamp and self.start_tstamp
                else None
            ),
            "error": err_block,
            "failing_tasks": self._failing_tasks(),
            "executor_stats": self.executor_stats,
            "metrics": get_registry().snapshot(),
            # the plan joined against measured peaks: the bounded-memory
            # promise vs what actually happened, per op
            "plan": self.projected_vs_measured(),
            "op_wall_clock": {
                name: t.wall_clock for name, t in self.op_timings.items()
            },
            "decisions": decisions_since(self._t0),
            # the live-telemetry layer's post-mortem residue: every alert
            # that fired during the compute, plus the sampled time series
            # covering its window (None when telemetry was unarmed)
            "alerts": self._alert_timeline(),
            "timeseries": self._timeseries_dump(),
            "stragglers": self.stragglers(),
            "clock_offsets": self.clock_offsets(),
            # the dependency structure analytics (analyze()/diagnose
            # --analyze) walks for the critical path: the op-level skeleton
            # always, the chunk-level edges when the dataflow scheduler
            # recorded them (spans armed)
            "op_graph": self.op_graph(),
            "chunk_graph": self.chunk_graph(),
            "task_records": len(self._records),
            "task_records_dropped": self.records_dropped,
            # the coordinator self-profiler's summary (top folded stacks,
            # sample/overflow counts) when the dispatch profiler was armed
            # for this compute — the collapsed stacks themselves land as
            # profile-<compute_id>.folded beside the trace
            "dispatch_profile": self._dispatch_profile_summary(),
        }

    def _dispatch_profile_summary(self) -> Optional[dict]:
        from .dispatchprofile import profile_for

        prof = profile_for(self.compute_id)
        return prof.summary() if prof is not None else None

    def dump(self, path: Optional[str] = None) -> str:
        """Write the bundle directory now; returns its path."""
        if path is None:
            path = os.path.join(self.bundle_dir, f"bundle-{self.compute_id}")
        os.makedirs(path, exist_ok=True)
        self.export(os.path.join(path, BUNDLE_TRACE))
        from .dispatchprofile import profile_for

        prof = profile_for(self.compute_id)
        if prof is not None:
            # flamegraph-ready collapsed stacks: feed straight to
            # flamegraph.pl / speedscope / inferno
            folded = os.path.join(
                path, f"profile-{self.compute_id}.folded"
            )
            with open(folded, "w") as f:
                f.write("\n".join(prof.folded_lines()) + "\n")
        with open(os.path.join(path, BUNDLE_LOGS), "w") as f:
            for rec in logs.recent_records(self.max_log_records):
                f.write(json.dumps(rec, default=str) + "\n")
        manifest = self.manifest()
        tmp = os.path.join(path, BUNDLE_MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, default=str)
        os.replace(tmp, os.path.join(path, BUNDLE_MANIFEST))
        return path


def load_bundle(path: str) -> dict:
    """Read a bundle directory (or its manifest path) into a dict with
    ``manifest``, ``trace`` (parsed, or None), and ``logs`` (list)."""
    if os.path.isfile(path):
        path = os.path.dirname(path) or "."
    with open(os.path.join(path, BUNDLE_MANIFEST)) as f:
        manifest = json.load(f)
    trace = None
    trace_path = os.path.join(path, BUNDLE_TRACE)
    if os.path.exists(trace_path):
        try:
            with open(trace_path) as f:
                trace = json.load(f)
        except ValueError:
            trace = None
    records: list = []
    logs_path = os.path.join(path, BUNDLE_LOGS)
    if os.path.exists(logs_path):
        with open(logs_path) as f:
            for line in f:
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue  # torn line: tolerate, like manifest shards
    return {"path": path, "manifest": manifest, "trace": trace, "logs": records}
