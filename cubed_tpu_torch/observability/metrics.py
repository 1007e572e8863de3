"""Process-local metrics: counters, gauges and histograms.

Counterpart of ``cubed_tpu/observability/metrics.py``. One registry serves
the whole process (:func:`get_registry`); it is the port's own and never
the JAX package's. The executors and the storage layer report through it,
so a compute's ``ComputeEndEvent.executor_stats`` carries one snapshot.
``snapshot()`` is a flat, JSON-serializable dict, merged with
:func:`merge_snapshots`.

The metric names the port records:

- ``tasks_completed`` / ``tasks_started`` -- task lifecycle counts
- ``bytes_read`` / ``bytes_written`` / ``chunks_read`` / ``chunks_written``
  -- Zarr store IO, as stored (see ``accounting.py``)
- ``virtual_bytes_read`` -- reads served by virtual (never-materialized)
  arrays
- ``spans_dropped`` / ``stragglers_detected`` -- the trace collector's
  bounded span buffers and its straggler watch (``collect.py``)
- ``gauges_dropped_in_delta`` -- gauges windowed away by ``snapshot_delta``
- ``op_wall_clock_s`` -- histogram of per-operation wall clock
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class Counter:
    """A monotonically increasing integer."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """A point-in-time value; tracks the maximum it has ever been set to."""

    __slots__ = ("name", "_value", "_max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._max = 0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._value = v
            if v > self._max:
                self._max = v

    @property
    def value(self):
        return self._value

    @property
    def max(self):
        return self._max


#: bounded reservoir size for histogram quantile estimation (per
#: histogram): sized so the p99 estimate of a 512-sample reservoir stays
#: within a few observations of the true p99 for any stream length, at a
#: fixed ~4KB-per-histogram memory cost
RESERVOIR_SIZE = 512

#: the quantiles every histogram estimates, exported through ``summary()``
#: (and from there ``snapshot()``)
#: — latency SLO rules need percentiles, not just count/sum/min/max
QUANTILES = ((0.5, "p50"), (0.95, "p95"), (0.99, "p99"))


class Histogram:
    """Streaming summary (count/sum/min/max + estimated p50/p95/p99) of an
    observed quantity.

    Quantiles come from a bounded reservoir (Vitter's algorithm R,
    ``RESERVOIR_SIZE`` samples, seeded per histogram name so replacement is
    deterministic for a given observation order): every observation has an
    equal chance of being retained, so the sorted reservoir's order
    statistics estimate the stream's quantiles at fixed memory."""

    __slots__ = ("name", "count", "sum", "min", "max", "_lock",
                 "_reservoir", "_rng")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = threading.Lock()
        self._reservoir: list = []
        self._rng = random.Random(name)

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if len(self._reservoir) < RESERVOIR_SIZE:
                self._reservoir.append(v)
            else:
                slot = self._rng.randrange(self.count)
                if slot < RESERVOIR_SIZE:
                    self._reservoir[slot] = v

    def quantiles(self) -> dict:
        """Estimated quantiles from the reservoir (empty dict when nothing
        was observed). Keys are the ``QUANTILES`` labels (p50/p95/p99)."""
        with self._lock:
            sample = sorted(self._reservoir)
        if not sample:
            return {}
        n = len(sample)
        out = {}
        for q, label in QUANTILES:
            # nearest-rank on the retained sample
            idx = min(n - 1, max(0, int(round(q * (n - 1)))))
            out[label] = sample[idx]
        return out

    def summary(self) -> dict:
        q = self.quantiles()
        with self._lock:
            out = {
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "mean": (self.sum / self.count) if self.count else None,
            }
        out.update(q)
        return out


class MetricsRegistry:
    """Named counters/gauges/histograms with a flat dict snapshot.

    Snapshot keys: a counter appears under its name; a gauge under its name
    plus ``<name>_max``; a histogram under ``<name>`` as a nested summary
    dict. ``snapshot_delta(before)`` subtracts counter/histogram
    accumulations so a long-lived process (a REPL, a bench loop) can
    report per-compute numbers.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        #: gauge keys already log-noted as dropped from snapshot_delta
        self._delta_gauges_logged: set = set()

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def snapshot(self) -> dict:
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histograms = list(self._histograms.values())
        out: dict = {}
        for c in counters:
            out[c.name] = c.value
        for g in gauges:
            out[g.name] = g.value
            out[f"{g.name}_max"] = g.max
        for h in histograms:
            out[h.name] = h.summary()
        return out

    def snapshot_delta(self, before: dict, now: Optional[dict] = None) -> dict:
        """Current snapshot minus a previous one.

        ``now`` lets a caller that already took the current snapshot reuse
        it — a caller shipping deltas needs the delta and the new baseline to be
        the SAME observation, or increments landing between two internal
        snapshots would ship twice (once in this delta, again in the
        next).

        Counters and histogram count/sum/mean subtract, so the result is a
        true per-window reading. Quantities that CANNOT be windowed from two
        snapshots are dropped rather than reported stale: a gauge's
        ``_max`` key appears only if the window set a new high, a gauge's
        instantaneous value is omitted entirely (the end-of-window reading —
        e.g. ``queue_depth`` after the queue drained — measures nothing),
        and histogram summaries omit lifetime min/max and quantiles (a
        long-lived process — a REPL, a bench loop — must not
        attribute an old compute's extremes to a later one).

        Dropped gauges are NOT silent: each unwindowable gauge reading is
        counted in the ``gauges_dropped_in_delta`` counter (and logged once
        per key per registry), so a consumer shipping deltas can see that a gauge existed and was windowed
        away rather than never reported at all."""
        if now is None:
            now = self.snapshot()
        with self._lock:
            gauge_names = set(self._gauges)
        out: dict = {}
        dropped_gauges = []
        for k, v in now.items():
            prev = before.get(k)
            if isinstance(v, dict):  # histogram summary
                pc = (prev or {}).get("count", 0) if isinstance(prev, dict) else 0
                ps = (prev or {}).get("sum", 0.0) if isinstance(prev, dict) else 0.0
                count = v["count"] - pc
                out[k] = {
                    "count": count,
                    "sum": v["sum"] - ps,
                    "mean": ((v["sum"] - ps) / count) if count else None,
                }
            elif k.endswith("_max") and k[: -len("_max")] in gauge_names:
                # lifetime high-water mark: only meaningful for this window
                # if the window raised it
                if not isinstance(prev, (int, float)) or v > prev:
                    out[k] = v
            elif k in gauge_names:
                dropped_gauges.append(k)
                continue  # instantaneous reading: not a per-window quantity
            elif isinstance(prev, (int, float)):
                out[k] = v - prev
            else:
                out[k] = v
        if dropped_gauges:
            # count AFTER the snapshot above, so this window's delta is not
            # perturbed by its own bookkeeping (the next window sees it)
            self.counter("gauges_dropped_in_delta").inc(len(dropped_gauges))
            for k in dropped_gauges:
                if k not in self._delta_gauges_logged:
                    self._delta_gauges_logged.add(k)
                    logger.info(
                        "snapshot_delta: gauge %r has no per-window value "
                        "and is dropped from deltas (its _max rides when "
                        "the window raises it; counted in "
                        "gauges_dropped_in_delta)", k,
                    )
        return out

    def report(self) -> str:
        """Human-readable table of the current snapshot."""
        snap = self.snapshot()
        if not snap:
            return "(no metrics recorded)"
        rows = []
        for k in sorted(snap):
            v = snap[k]
            if isinstance(v, dict):
                mean = v.get("mean")
                row = (
                    f"count={v['count']} sum={_fmt(v['sum'])} "
                    f"mean={_fmt(mean)} min={_fmt(v['min'])} "
                    f"max={_fmt(v['max'])}"
                )
                if v.get("p50") is not None:
                    row += (
                        f" p50={_fmt(v['p50'])} p95={_fmt(v.get('p95'))} "
                        f"p99={_fmt(v.get('p99'))}"
                    )
                rows.append((k, row))
            else:
                rows.append((k, _fmt(v)))
        width = max(len(k) for k, _ in rows)
        lines = [f"{k.ljust(width)}  {v}" for k, v in rows]
        return "\n".join(lines)

    def kinds(self) -> Dict[str, str]:
        """Metric name -> ``"counter"`` / ``"gauge"`` / ``"histogram"`` for
        every registered metric (what an exposition format such as
        Prometheus's needs for its ``# TYPE`` lines)."""
        with self._lock:
            out: Dict[str, str] = {n: "counter" for n in self._counters}
            out.update({n: "gauge" for n in self._gauges})
            out.update({n: "histogram" for n in self._histograms})
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._delta_gauges_logged.clear()


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def merge_snapshots(a: dict, b: dict) -> dict:
    """Combine two snapshots: counters add, histogram summaries fold, and
    gauge readings take the max. A gauge is recognized structurally — a key
    whose ``<key>_max`` sibling exists in either snapshot (``snapshot()``
    always emits both) — because summing point-in-time readings (e.g. two
    workers each reporting queue_depth=3) would claim load that never
    existed at any instant. Used to merge one process's metrics into
    another's view."""
    out = dict(a)
    for k, v in b.items():
        if k not in out:
            out[k] = v
        elif (
            isinstance(v, (int, float))
            and isinstance(out[k], (int, float))
            and (f"{k}_max" in a or f"{k}_max" in b)
        ):
            out[k] = max(out[k], v)  # gauge reading: point-in-time, not additive
        elif isinstance(v, dict) and isinstance(out[k], dict):
            ac, bc = out[k], v
            count = (ac.get("count") or 0) + (bc.get("count") or 0)
            total = (ac.get("sum") or 0.0) + (bc.get("sum") or 0.0)
            mins = [x for x in (ac.get("min"), bc.get("min")) if x is not None]
            maxs = [x for x in (ac.get("max"), bc.get("max")) if x is not None]
            out[k] = {
                "count": count,
                "sum": total,
                "mean": (total / count) if count else None,
                "min": min(mins) if mins else None,
                "max": max(maxs) if maxs else None,
            }
        elif isinstance(v, (int, float)) and isinstance(out[k], (int, float)):
            out[k] = max(out[k], v) if k.endswith("_max") else out[k] + v
        else:
            out[k] = v
    return out


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _default_registry
