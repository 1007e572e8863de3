"""Control-plane self-observation: the dispatch profiler and the
instrumented hot-lock wrapper. Counterpart of
``cubed_tpu/observability/dispatchprofile.py``.

The runtime's dispatch path (the executors' loops on the client thread,
which on the device executor also capture and replay its CUDA graphs) is
the one shared component every task crosses. Task-side instrumentation
(spans, task stats) cannot see it: its time is spent *between* tasks. This
module watches the control plane itself:

- :class:`DispatchProfiler` — a bounded ``sys._current_frames()`` sampling
  profiler (~75 Hz) over the client's threads for the life of a compute.
  Aggregates folded stacks (flamegraph-ready, hard entry cap with an
  overflow counter), keeps a bounded reservoir of leaf samples for a
  Perfetto ``dispatch profile`` lane, and exports collapsed stacks as
  ``profile-<compute_id>.folded`` in the flight-recorder bundle. **Off by
  default** and a true no-op when off (no thread, no sampling): armed via
  ``Spec(dispatch_profile=True)`` or ``CUBED_TPU_TORCH_DISPATCH_PROFILE=1``
  (env wins, same precedence as every other arming knob). Only threads of
  Python's ``threading`` module are sampled: a thread that torch's runtime
  starts (the CUDA caching allocator's, the profiler's, autograd's) is not
  the control plane, and a thread that has no ``threading`` entry is
  skipped.

- :class:`TimedLock` — a drop-in ``threading.Lock`` wrapper that measures
  contended-acquire wait time (``dispatch_lock_wait_s``) with a per-thread
  accumulator. The uncontended path costs one extra try-acquire. Works
  under ``threading.Condition`` via the generic acquire/release fallbacks.

Not to be confused with ``observability/profiler.py`` — the torch
**device** profiler; this module profiles the host-side control plane.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import List, Optional, Tuple

from .metrics import get_registry

#: operator override ("1" forces the profiler on for every compute)
PROFILE_ENV_VAR = "CUBED_TPU_TORCH_DISPATCH_PROFILE"

#: sampling rate: high enough to resolve per-task dispatch costs at
#: hundreds of tasks/sec, low enough that the sampler itself stays well
#: under the <5% armed-overhead budget the bench gate enforces
DEFAULT_HZ = 75.0

#: hard cap on distinct folded stacks retained — a pathological compute
#: (deep recursion, churning threads) must not grow the dict unboundedly;
#: overflow is counted (``dispatch_profile_overflow``), never silent
MAX_FOLDED_STACKS = 2000

#: frames walked per stack before truncation
MAX_STACK_DEPTH = 48

#: leaf samples retained for the Perfetto "dispatch profile" lane
MAX_LANE_SAMPLES = 1024

#: finished profiles retained for bundles/diagnose, newest-kept
MAX_KEPT_PROFILES = 4

#: thread-name prefixes the sampler skips: task-executing pool threads and
#: the telemetry/profiler machinery itself are not the control plane
EXCLUDE_THREAD_PREFIXES = (
    "ThreadPoolExecutor",  # task bodies on the threads executor
    "telemetry",           # the ~1s telemetry sampler and its HTTP server
    "dispatch-profile",    # this profiler's own thread
    "chunk-repair",        # the recompute side pool
    "mem-guard-sampler",   # the memory guard's sampler (runtime/memory.py)
)


def profile_enabled(spec=None) -> bool:
    """Whether the dispatch profiler arms for a compute (env > spec > off)."""
    env = os.environ.get(PROFILE_ENV_VAR)
    if env:
        return env == "1"
    if spec is not None:
        armed = getattr(spec, "dispatch_profile", None)
        if armed is not None:
            return bool(armed)
    return False


class DispatchProfiler:
    """Bounded sampling profiler over this process's control-plane threads.

    ``start()`` spawns one daemon thread sampling ``sys._current_frames()``
    at ``hz``; ``stop()`` joins it. Results: :meth:`folded_lines` (collapsed
    stacks, one ``stack count`` line each — feed to any flamegraph tool),
    :meth:`top_stacks` (ranked summary for ``diagnose``), and
    :meth:`lane_samples` (bounded ``(ts, leaf)`` reservoir for the Perfetto
    lane). All aggregation happens on the sampler thread; readers take the
    lock only at export time.
    """

    def __init__(self, hz: float = DEFAULT_HZ):
        self.hz = max(1.0, min(200.0, float(hz)))
        self.samples = 0
        self.overflow = 0
        self.started_at: Optional[float] = None
        self.stopped_at: Optional[float] = None
        self._folded: dict = {}
        self._lane: deque = deque(maxlen=MAX_LANE_SAMPLES)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "DispatchProfiler":
        if self._thread is not None:
            return self
        self.started_at = time.time()
        self._thread = threading.Thread(
            target=self._run, name="dispatch-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> "DispatchProfiler":
        if self._thread is None:
            return self
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._thread = None
        self.stopped_at = time.time()
        return self

    def _run(self) -> None:
        interval = 1.0 / self.hz
        own_tid = threading.get_ident()
        while not self._stop.wait(interval):
            try:
                self._sample_once(own_tid)
            except Exception:
                # the profiler must never take the compute down with it
                pass

    # -- sampling ------------------------------------------------------

    def _sample_once(self, own_tid: int) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        ts = time.time()
        for tid, frame in frames.items():
            if tid == own_tid:
                continue
            name = names.get(tid)
            if name is None or name.startswith(EXCLUDE_THREAD_PREFIXES):
                # no threading entry: a thread torch's runtime started
                continue
            stack: List[str] = []
            f = frame
            while f is not None and len(stack) < MAX_STACK_DEPTH:
                code = f.f_code
                stack.append(
                    f"{os.path.basename(code.co_filename)}:{code.co_name}"
                )
                f = f.f_back
            stack.reverse()  # root-first, the folded convention
            key = name + ";" + ";".join(stack)
            leaf = stack[-1] if stack else name
            with self._lock:
                self.samples += 1
                if key in self._folded:
                    self._folded[key] += 1
                elif len(self._folded) < MAX_FOLDED_STACKS:
                    self._folded[key] = 1
                else:
                    self.overflow += 1
                    get_registry().counter(
                        "dispatch_profile_overflow"
                    ).inc()
                self._lane.append((ts, f"{name}: {leaf}"))

    # -- export --------------------------------------------------------

    def folded(self) -> dict:
        with self._lock:
            return dict(self._folded)

    def folded_lines(self) -> List[str]:
        """Collapsed stacks, one ``stack count`` line each (the format
        ``flamegraph.pl`` / speedscope / inferno all consume)."""
        with self._lock:
            items = sorted(self._folded.items(), key=lambda kv: -kv[1])
        return [f"{stack} {count}" for stack, count in items]

    def top_stacks(self, n: int = 8) -> List[dict]:
        """The ``n`` hottest stacks, leaf-labelled, with sample fractions."""
        with self._lock:
            total = sum(self._folded.values()) or 1
            items = sorted(self._folded.items(), key=lambda kv: -kv[1])[:n]
        out = []
        for stack, count in items:
            parts = stack.split(";")
            out.append({
                "thread": parts[0],
                "leaf": parts[-1] if len(parts) > 1 else parts[0],
                "stack": stack,
                "count": count,
                "fraction": round(count / total, 4),
            })
        return out

    def lane_samples(self) -> List[Tuple[float, str]]:
        """Bounded ``(ts, "thread: leaf")`` reservoir for the trace lane."""
        with self._lock:
            return list(self._lane)

    def summary(self) -> dict:
        """The manifest block bundles/diagnose render."""
        return {
            "samples": self.samples,
            "overflow": self.overflow,
            "distinct_stacks": len(self._folded),
            "hz": self.hz,
            "duration_s": (
                round((self.stopped_at or time.time())
                      - self.started_at, 3)
                if self.started_at else None
            ),
            "top_stacks": self.top_stacks(),
        }


#: finished profiles by compute id (bounded, newest kept) — how the flight
#: recorder and ``diagnose`` find the profile after the compute ended
_profiles: "OrderedDict[str, DispatchProfiler]" = OrderedDict()
_profiles_lock = threading.Lock()


def register_profile(compute_id: str, profiler: DispatchProfiler) -> None:
    with _profiles_lock:
        _profiles[compute_id] = profiler
        _profiles.move_to_end(compute_id)
        while len(_profiles) > MAX_KEPT_PROFILES:
            _profiles.popitem(last=False)


def profile_for(compute_id: Optional[str]) -> Optional[DispatchProfiler]:
    """The finished (or live) profiler for a compute id, or None."""
    if compute_id is None:
        return None
    with _profiles_lock:
        return _profiles.get(compute_id)


class profile_scoped:
    """Arm the dispatch profiler for one compute (``Plan.execute`` enters
    this around ``execute_dag``). A true no-op — no thread, no sampling, no
    allocation beyond this object — unless :func:`profile_enabled` says the
    compute asked for it. The finished profiler is registered under the
    compute id so the flight recorder and ``diagnose`` can find it."""

    def __init__(self, spec=None, compute_id: Optional[str] = None):
        self._spec = spec
        self._compute_id = compute_id
        self.profiler: Optional[DispatchProfiler] = None

    def __enter__(self) -> Optional[DispatchProfiler]:
        if profile_enabled(self._spec):
            self.profiler = DispatchProfiler().start()
            if self._compute_id:
                # registered at START so a mid-compute dump sees the live
                # profiler (bundles on failure, diagnose on a hung compute)
                register_profile(self._compute_id, self.profiler)
        return self.profiler

    def __exit__(self, *exc) -> None:
        if self.profiler is not None:
            self.profiler.stop()


class TimedLock:
    """``threading.Lock`` with contended-wait measurement.

    The dispatch ledger needs "how long did THIS submit wait on the
    coordinator's hot lock": :meth:`reset_thread_wait` zeroes a per-thread
    accumulator, every contended ``acquire`` on that thread adds its wait,
    :meth:`thread_wait_s` reads it back. Cumulative wait also lands on the
    ``dispatch_lock_wait_s`` registry counter so the live surfaces see lock
    pressure without a ledger in flight.

    Implements ``acquire``/``release``/context-manager/``locked``, so
    ``threading.Condition(TimedLock())`` works through the stdlib's generic
    fallbacks — waits during a Condition ``wait_for`` (e.g. the
    coordinator's no-live-worker backfill wait) count as lock wait, which
    is the honest reading: the dispatch path was blocked either way.
    """

    __slots__ = ("_lock", "_tls", "_counter")

    def __init__(self, metric: str = "dispatch_lock_wait_s"):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._counter = get_registry().counter(metric)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        ok = self._lock.acquire(True, timeout)
        wait = time.perf_counter() - t0
        self._tls.acc = getattr(self._tls, "acc", 0.0) + wait
        self._counter.inc(wait)
        return ok

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def reset_thread_wait(self) -> None:
        self._tls.acc = 0.0

    def thread_wait_s(self) -> float:
        return getattr(self._tls, "acc", 0.0)
