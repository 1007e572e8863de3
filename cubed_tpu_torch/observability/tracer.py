"""Span-based tracing with Chrome-trace/Perfetto export.

Counterpart of ``cubed_tpu/observability/tracer.py``.

``Tracer`` records three kinds of events, all thread-safe:

- ``span(name, **attrs)`` — a context manager timing a block of code;
  nesting is tracked per-thread (each span knows its parent and depth).
- ``add_complete(name, start, end, **attrs)`` — an externally-timed span
  (e.g. a task whose timestamps were measured on a remote worker).
- ``instant(name, **attrs)`` — a zero-duration marker.

Events are kept in memory (bounded by ``max_events``) and optionally
streamed to a JSONL sink as they finish — one JSON object per line, raw
epoch-seconds timestamps, so external tools can tail a live compute.

``export_chrome(path)`` writes the standard Chrome trace-event JSON
(``{"traceEvents": [...]}``, phase ``X`` complete events with microsecond
timestamps) which loads directly in Perfetto (https://ui.perfetto.dev) or
chrome://tracing. Lane assignment: every distinct ``lane`` label (defaults
to the recording thread) becomes a ``tid`` with a ``thread_name`` metadata
record, so ops/workers get their own rows in the UI.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class Tracer:
    def __init__(
        self,
        jsonl_path: Optional[str] = None,
        max_events: int = 1_000_000,
        clock=time.time,
    ):
        self.events: list[dict] = []
        self.max_events = max_events
        self.dropped = 0
        self._clock = clock
        self._lock = threading.Lock()
        #: spans entered but not yet exited, across all threads — so an
        #: export can close them (error=True) instead of dropping them
        self._open: dict[int, "_Span"] = {}
        self._tls = threading.local()
        self._jsonl_path = jsonl_path
        self._jsonl_file = None
        #: separate lock so slow sink IO never serializes event recording
        self._jsonl_lock = threading.Lock()

    # -- recording -----------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, event: dict) -> None:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(event)
        if self._jsonl_path is not None:
            # serialize + write under the sink's own lock, NOT the recording
            # lock: a slow filesystem must not throttle other threads' spans
            line = json.dumps(event, default=str) + "\n"
            with self._jsonl_lock:
                try:
                    if self._jsonl_file is None:
                        d = os.path.dirname(self._jsonl_path)
                        if d:
                            os.makedirs(d, exist_ok=True)
                        self._jsonl_file = open(self._jsonl_path, "a")
                    self._jsonl_file.write(line)
                    self._jsonl_file.flush()
                except (OSError, ValueError):
                    pass  # a broken sink must never fail the compute

    def span(self, name: str, lane: Optional[str] = None, **attrs):
        """Context manager recording a complete span around a block."""
        return _Span(self, name, lane, attrs)

    def add_complete(
        self,
        name: str,
        start: float,
        end: float,
        lane: Optional[str] = None,
        cat: str = "span",
        **attrs,
    ) -> None:
        """Record an externally-timed span (epoch-second timestamps)."""
        self._record(
            {
                "name": name,
                "cat": cat,
                "ph": "X",
                "ts": start,
                "dur": max(0.0, end - start),
                "lane": lane or f"thread-{threading.get_ident()}",
                "args": attrs,
            }
        )

    def instant(self, name: str, lane: Optional[str] = None, ts: Optional[float] = None, **attrs) -> None:
        self._record(
            {
                "name": name,
                "cat": "instant",
                "ph": "i",
                "ts": ts if ts is not None else self._clock(),
                "dur": 0.0,
                "lane": lane or f"thread-{threading.get_ident()}",
                "args": attrs,
            }
        )

    def add_counter(
        self, name: str, ts: float, value, lane: Optional[str] = None
    ) -> None:
        """A counter sample (Perfetto renders these as a value track)."""
        self._record(
            {
                "name": name,
                "cat": "counter",
                "ph": "C",
                "ts": ts,
                "dur": 0.0,
                "lane": lane or name,
                "args": {"value": value},
            }
        )

    # -- export --------------------------------------------------------

    def chrome_events(self) -> list[dict]:
        """Chrome trace-event list: lanes mapped to tids + name metadata.

        Spans still open at export time (entered but never exited — a task
        that raised through a frame holding one, or an export taken
        mid-compute) are closed AT the export instant and emitted with
        ``error=True`` + ``unterminated=True`` instead of being silently
        dropped: a crash is exactly when the trace matters most.
        """
        with self._lock:
            events = list(self.events)
            open_spans = list(self._open.values())
        end = self._clock()
        for s in open_spans:
            attrs = dict(s.attrs)
            attrs["error"] = True
            attrs["unterminated"] = True
            events.append(
                {
                    "name": s.name,
                    "cat": "span",
                    "ph": "X",
                    "ts": s.start,
                    "dur": max(0.0, end - s.start),
                    # the OWNING thread's lane, not the exporting thread's:
                    # a crashed task's span must land on its own lane
                    "lane": s.lane or f"thread-{s.owner}",
                    "args": attrs,
                }
            )
        if not events:
            return []
        t0 = min(e["ts"] for e in events)
        lanes: dict[str, int] = {}
        out: list[dict] = []
        pid = os.getpid()
        for e in events:
            lane = e.get("lane") or "main"
            tid = lanes.get(lane)
            if tid is None:
                tid = lanes[lane] = len(lanes) + 1
                out.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": tid,
                        "args": {"name": lane},
                    }
                )
            rec = {
                "name": e["name"],
                "cat": e.get("cat", "span"),
                "ph": e.get("ph", "X"),
                "ts": (e["ts"] - t0) * 1e6,  # microseconds
                "pid": pid,
                "tid": tid,
                "args": e.get("args", {}),
            }
            if rec["ph"] == "X":
                rec["dur"] = e.get("dur", 0.0) * 1e6
            elif rec["ph"] == "i":
                rec["s"] = "t"  # instant scope: thread
            out.append(rec)
        return out

    def export_chrome(self, path: str) -> str:
        """Write a Perfetto/chrome://tracing-loadable trace JSON file."""
        doc = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        return path

    def clear(self) -> None:
        with self._lock:
            self.events = []
            self.dropped = 0
            # also drop spans left open before the clear: a reused tracer
            # (TracingCallback clears per compute) must not re-emit a prior
            # compute's abandoned span into every later export — its stale
            # ts would anchor t0 and shift the whole new timeline (and the
            # strong ref would pin the span forever). A span live across
            # the clear still records on exit; it just can't be synthesized
            # if abandoned.
            self._open.clear()

    def close(self) -> None:
        with self._jsonl_lock:
            if self._jsonl_file is not None:
                try:
                    self._jsonl_file.close()
                except OSError:
                    pass
                self._jsonl_file = None


class _Span:
    """The context manager returned by ``Tracer.span``."""

    __slots__ = (
        "tracer", "name", "lane", "attrs", "start", "parent", "depth",
        "owner",
    )

    def __init__(self, tracer: Tracer, name: str, lane, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.lane = lane
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        stack = self.tracer._stack()
        self.parent = stack[-1].name if stack else None
        self.depth = len(stack)
        stack.append(self)
        self.start = self.tracer._clock()
        self.owner = threading.get_ident()
        with self.tracer._lock:
            self.tracer._open[id(self)] = self
        return self

    def __exit__(self, exc_type, *exc) -> None:
        end = self.tracer._clock()
        self.tracer._stack().pop()
        with self.tracer._lock:
            self.tracer._open.pop(id(self), None)
        attrs = dict(self.attrs)
        if self.parent is not None:
            attrs["parent"] = self.parent
        attrs["depth"] = self.depth
        if exc_type is not None:
            # error=True is the machine-checkable flag; error_type names it
            attrs["error"] = True
            attrs["error_type"] = exc_type.__name__
        self.tracer.add_complete(
            self.name, self.start, end, lane=self.lane, **attrs
        )
