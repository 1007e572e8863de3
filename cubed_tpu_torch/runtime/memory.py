"""Runtime memory guard: per-task enforcement of the bounded-memory promise.

Counterpart of ``cubed_tpu/runtime/memory.py``. The plan-time projection
(``projected_mem`` against ``Spec.allowed_mem``) says what a task should
use; this module watches what it does use:

- **Task-scope guard.** ``task_guard`` (entered by
  ``runtime/utils.execute_with_stats`` around every task body, and by the
  device executor around every segment and eager op) measures the task's
  growth. On the host, as in the reference: a shared sampler thread reads
  the process RSS every ``sample_interval_s`` and keeps, per active task,
  the peak of ``rss_now - rss_at_task_start``. **On a CUDA device the guard
  also reads the caching allocator**, where a task's blocks live and which
  RSS does not see: at entry it synchronizes, folds the allocator's peak
  statistics into a process-wide running maximum, resets them and records
  ``memory_allocated()``; at exit it synchronizes and reads
  ``max_memory_allocated()`` less that start. ``measured`` is the larger of
  the device growth and the RSS growth, plus any injected spike, and rides
  the task's stats as ``guard_mem_peak``. When it exceeds ``allowed_mem``:
  mode ``observe`` (the default) counts ``mem_guard_soft_exceeded``, records
  a ``guard_soft_exceeded`` decision naming which reading went over, and
  warns; ``enforce`` fails the task with a picklable
  :class:`MemoryGuardExceededError` (classified ``RESOURCE``); ``off`` is a
  no-op. If the allocator cannot be read on a CUDA device the guard raises:
  it never turns into a host-only reading there.
- **One owner of the peak statistics.** ``torch.cuda.reset_peak_memory_stats``
  is process-wide, so the guard is its only caller in the library, and
  every reset first folds the current ``max_memory_allocated()`` and
  ``max_memory_reserved()`` into :func:`device_peaks`'s running maximum: a
  compute-level reading (a gate on peak reserved memory) reads that, and
  still sees the compute's true peak. The guard refuses to run inside a
  CUDA graph capture (a replay is one unit; the device executor guards it
  from outside).
- **Host-pressure watermarks** (the sampler): RSS growth against
  ``allowed_mem x tasks-in-flight`` (``soft_fraction`` of it soft, over it
  hard) and ``MemAvailable`` under ``host_floor_bytes`` (hard), exported as
  gauges and read by :func:`pressure_level`.
- **Admission control.** :class:`AdmissionController` bounds tasks in
  flight, halving on a RESOURCE failure or hard pressure and doubling back
  after a window of successes (AIMD). Its consumer is the parallel
  executors' map, which comes with the fleet (ROADMAP Queue 1 item 11).

Activation mirrors the integrity layer: ``Spec(memory_guard=...)`` (armed by
``Plan.execute`` with the spec's ``allowed_mem`` for the compute), and the
``CUBED_TPU_TORCH_MEMORY_GUARD`` env var (a JSON config or a bare mode; the
operator's override, which wins). With no ``allowed_mem`` there is nothing
to judge against and the guard stays inactive.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, fields
from typing import Optional

import torch

from ..observability.accounting import record_scoped_counter
from ..observability.metrics import get_registry
from ..utils import current_measured_mem, host_available_mem, memory_repr

logger = logging.getLogger(__name__)

#: env var carrying a JSON MemoryGuardConfig (or a bare mode): the
#: operator's override, which wins over Spec-level arming
MEMORY_GUARD_ENV_VAR = "CUBED_TPU_TORCH_MEMORY_GUARD"

MODES = ("off", "observe", "enforce")
DEFAULT_MODE = "observe"


class MemoryGuardExceededError(RuntimeError):
    """A task's measured memory exceeded ``allowed_mem`` under
    ``memory_guard="enforce"``.

    Picklable and structured: ``chunk_key``/``op_name`` locate the task,
    ``measured``/``allowed`` are bytes. Classified ``RESOURCE``.
    """

    def __init__(
        self,
        message: str,
        chunk_key: Optional[str] = None,
        measured: Optional[int] = None,
        allowed: Optional[int] = None,
        op_name: Optional[str] = None,
    ):
        super().__init__(message)
        self.chunk_key = chunk_key
        self.measured = measured
        self.allowed = allowed
        self.op_name = op_name

    def __reduce__(self):
        return (
            MemoryGuardExceededError,
            (self.args[0] if self.args else "", self.chunk_key, self.measured, self.allowed, self.op_name),
        )

    @property
    def wire_payload(self) -> dict:
        """Plain-dict form (the channel ``ChunkIntegrityError`` uses), so an
        abort message can name the byte counts measured where the task ran."""
        return {
            "chunk_key": self.chunk_key,
            "measured": self.measured,
            "allowed": self.allowed,
            "op_name": self.op_name,
            "kind": "memory_guard",
        }


#: exception class names that classify RESOURCE across a process boundary
#: (``OutOfMemoryError`` is torch's CUDA out-of-memory)
RESOURCE_TYPE_NAMES = frozenset({"MemoryError", "MemoryGuardExceededError", "OutOfMemoryError"})


@dataclass(frozen=True)
class MemoryGuardConfig:
    """What to enforce, and how aggressively to watch."""

    #: "off" (no-op) | "observe" (count + warn) | "enforce" (fail task)
    mode: str = DEFAULT_MODE
    #: the per-task budget (bytes), ``Spec.allowed_mem``; 0 disables the guard
    allowed_mem: int = 0
    #: the RSS sampler's period
    sample_interval_s: float = 0.02
    #: host-pressure soft watermark as a fraction of allowed_mem x in-flight
    soft_fraction: float = 0.85
    #: MemAvailable floor below which the host is hard-pressured regardless
    host_floor_bytes: int = 128 * 1024 * 1024

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"invalid memory_guard mode {self.mode!r}; expected one of {MODES}")

    @classmethod
    def from_dict(cls, d: dict) -> "MemoryGuardConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown MemoryGuardConfig fields {sorted(unknown)}; known: {sorted(known)}")
        return cls(**d)

    def to_env_json(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})

    @property
    def enabled(self) -> bool:
        return self.mode != "off" and self.allowed_mem > 0


# ----------------------------------------------------------------------
# process-level activation (env > activated > None)
# ----------------------------------------------------------------------

_lock = threading.Lock()
_active: Optional[MemoryGuardConfig] = None
#: ((raw env string, armed base), parsed config): parse once per value
_env_cache: tuple = (None, None)


def _validate_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"invalid memory_guard mode {mode!r}; expected one of {MODES}")
    return mode


def _coerce(config) -> MemoryGuardConfig:
    if isinstance(config, MemoryGuardConfig):
        return config
    if isinstance(config, dict):
        return MemoryGuardConfig.from_dict(config)
    if isinstance(config, str):
        return MemoryGuardConfig(mode=config)
    raise TypeError(f"expected MemoryGuardConfig, dict or mode string, got {type(config).__name__}")


def activate(config, export_env: bool = False) -> MemoryGuardConfig:
    """Arm the guard in this process (and, with ``export_env``, in every
    child process spawned afterwards)."""
    global _active, _baseline_rss
    cfg = _coerce(config)
    with _lock:
        _active = cfg
        # RSS growth is measured against the footprint at this arming, not
        # absolute RSS: a large process must not read as standing pressure
        _baseline_rss = current_measured_mem()
    if export_env:
        os.environ[MEMORY_GUARD_ENV_VAR] = cfg.to_env_json()
    return cfg


def deactivate() -> None:
    global _active, _env_cache
    with _lock:
        _active = None
        _env_cache = (None, None)
    os.environ.pop(MEMORY_GUARD_ENV_VAR, None)


def get_guard_config() -> Optional[MemoryGuardConfig]:
    """The effective config, or None (unarmed: the common fast path).

    The env var wins; a malformed value raises. A bare mode string
    (``CUBED_TPU_TORCH_MEMORY_GUARD=enforce``) overrides the mode only,
    keeping ``allowed_mem`` and the sampler settings the Spec armed."""
    global _env_cache, _baseline_rss
    raw = os.environ.get(MEMORY_GUARD_ENV_VAR)
    if raw:
        base = _active
        cached_key, cached_cfg = _env_cache
        if (raw, base) == cached_key:
            return cached_cfg
        if raw.strip().startswith("{"):
            cfg = MemoryGuardConfig.from_dict(json.loads(raw))
        else:
            mode = _validate_mode(raw.strip())
            if base is not None:
                cfg = MemoryGuardConfig(
                    mode=mode,
                    allowed_mem=base.allowed_mem,
                    sample_interval_s=base.sample_interval_s,
                    soft_fraction=base.soft_fraction,
                    host_floor_bytes=base.host_floor_bytes,
                )
            else:
                cfg = MemoryGuardConfig(mode=mode)
        with _lock:
            _env_cache = ((raw, base), cfg)
            if cfg.enabled:
                _baseline_rss = current_measured_mem()
        return cfg
    return _active


class scoped:
    """Arm the guard for a ``with`` block (``Plan.execute`` uses this for
    ``Spec(memory_guard=...)``). ``mode=None`` with a known ``allowed_mem``
    arms the default ``observe``; with neither it is a no-op. A pre-existing
    env var is the operator's override and passes through untouched."""

    def __init__(self, mode=None, allowed_mem=None, export_env: bool = False):
        if mode is None and allowed_mem:
            mode = DEFAULT_MODE
        self._config = None if mode is None else MemoryGuardConfig(mode=mode, allowed_mem=int(allowed_mem or 0))
        self._export_env = export_env

    def __enter__(self):
        if self._config is None:
            return None
        self._prev = _active
        self._prev_env = os.environ.get(MEMORY_GUARD_ENV_VAR)
        return activate(self._config, export_env=self._export_env and self._prev_env is None)

    def __exit__(self, *exc) -> None:
        if self._config is None:
            return
        global _active
        with _lock:
            _active = self._prev
        if self._export_env:
            if self._prev_env is None:
                os.environ.pop(MEMORY_GUARD_ENV_VAR, None)
            else:
                os.environ[MEMORY_GUARD_ENV_VAR] = self._prev_env


# ----------------------------------------------------------------------
# the card's allocator: one owner of its peak statistics
# ----------------------------------------------------------------------

#: device index -> [max allocated, max reserved] folded in before each reset
_device_fold: dict = {}
_fold_lock = threading.Lock()


def _guard_device() -> Optional[torch.device]:
    """The chunk device when it is a CUDA device (the guard then reads its
    allocator), else None."""
    from ..backend_array_api import get_device

    dev = get_device()
    if dev.type != "cuda":
        return None
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


def _allocator_stats(dev: torch.device) -> dict:
    """The caching allocator's byte counts on *dev*, read once (the nested
    form: ``memory_allocated()`` and its kin flatten every statistic on
    each call)."""
    stats = torch.cuda.memory_stats_as_nested_dict(dev)
    return {"allocated": stats["allocated_bytes"]["all"], "reserved": stats["reserved_bytes"]["all"]}


def _fold(dev: torch.device, stats: Optional[dict] = None) -> list:
    stats = stats or _allocator_stats(dev)
    with _fold_lock:
        folded = _device_fold.setdefault(dev.index, [0, 0])
        folded[0] = max(folded[0], stats["allocated"]["peak"])
        folded[1] = max(folded[1], stats["reserved"]["peak"])
        return list(folded)


def device_peaks() -> dict:
    """The process's peak allocated and reserved bytes on the current CUDA
    device since :func:`reset_device_peaks`, the guard's resets folded in:
    ``{"allocated": ..., "reserved": ...}``."""
    allocated, reserved = _fold(torch.device("cuda", torch.cuda.current_device()))
    return {"allocated": allocated, "reserved": reserved}


def reset_device_peaks() -> None:
    """Start a compute-level peak reading on the current CUDA device: the
    allocator's peak statistics and the guard's running maximum, both
    reset."""
    dev = torch.device("cuda", torch.cuda.current_device())
    with _fold_lock:
        _device_fold[dev.index] = [0, 0]
    torch.cuda.reset_peak_memory_stats(dev)


def _start_device_reading(dev: torch.device) -> int:
    """Synchronize, fold the allocator's peaks into the running maximum,
    reset them; the bytes allocated now (the task's start)."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the memory guard cannot run inside a CUDA graph capture")
    torch.cuda.synchronize(dev)
    stats = _allocator_stats(dev)
    _fold(dev, stats)
    torch.cuda.reset_peak_memory_stats(dev)
    return stats["allocated"]["current"]


def _end_device_reading(dev: torch.device, start: int) -> int:
    """Synchronize; the allocator's peak since the start, less the start."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the memory guard cannot run inside a CUDA graph capture")
    torch.cuda.synchronize(dev)
    return max(0, _allocator_stats(dev)["allocated"]["peak"] - start)


# ----------------------------------------------------------------------
# the sampler and per-task guard
# ----------------------------------------------------------------------

#: RSS at arming: growth (not absolute RSS) is what watermarks see
_baseline_rss: Optional[int] = None

#: (monotonic ts, rss): the sampler keeps it warm, and a task's guard
#: accepts a reading up to ~1.5 sampler periods old
_rss_cache: tuple = (0.0, None)


def _read_rss(max_age_s: float = 0.0) -> Optional[int]:
    global _rss_cache
    if max_age_s > 0.0:
        ts, val = _rss_cache
        if val is not None and time.monotonic() - ts <= max_age_s:
            return val
    val = current_measured_mem()
    if val is not None:
        _rss_cache = (time.monotonic(), val)
    return val


#: active guarded tasks: id(guard) -> _GuardedTask
_tasks: dict = {}
_tasks_lock = threading.Lock()
_tasks_present = threading.Event()

_sampler_thread: Optional[threading.Thread] = None
_sampler_stop = threading.Event()

#: "ok" | "soft" | "hard": written by the sampler, read by admission
_pressure_level = "ok"

#: the collect ring records at most one memory sample per period (plus
#: every pressure-level change)
_TRACE_SAMPLE_PERIOD_S = 0.25
_last_trace_sample = 0.0

#: this thread's last guarded task's readings (:func:`last_readings`)
_last = threading.local()


class _GuardedTask:
    __slots__ = ("key", "start_rss", "injected", "peak_delta")

    def __init__(self, key: str, start_rss: Optional[int], injected: int):
        self.key = key
        self.start_rss = start_rss
        self.injected = injected
        self.peak_delta = 0


def _ensure_sampler() -> None:
    global _sampler_thread
    if _sampler_thread is not None and _sampler_thread.is_alive():
        return
    with _lock:
        if _sampler_thread is not None and _sampler_thread.is_alive():
            return
        _sampler_stop.clear()
        _sampler_thread = threading.Thread(target=_sampler_loop, name="mem-guard-sampler", daemon=True)
        _sampler_thread.start()


def stop_sampler(timeout: float = 5.0) -> None:
    """Stop the sampler thread (tests; the next guarded task restarts it)."""
    global _sampler_thread
    thread = _sampler_thread
    if thread is None:
        return
    _sampler_stop.set()
    _tasks_present.set()  # wake a sampler parked on the task event
    thread.join(timeout)
    with _lock:
        if _sampler_thread is thread and not thread.is_alive():
            _sampler_thread = None
    with _tasks_lock:
        if not _tasks:
            _tasks_present.clear()


def _sample_once(cfg: MemoryGuardConfig, tasks: list) -> None:
    global _pressure_level, _last_trace_sample
    rss = _read_rss()  # a fresh read; keeps the shared cache warm
    if rss is None:
        return
    for t in tasks:
        if t.start_rss is None:
            continue
        delta = rss - t.start_rss
        if delta > t.peak_delta:
            t.peak_delta = delta
    reg = get_registry()
    reg.gauge("worker_rss_bytes").set(rss)
    base = _baseline_rss if _baseline_rss is not None else rss
    growth = max(0, rss - base)
    watermark = cfg.allowed_mem * max(1, len(tasks))
    level = "ok"
    if growth > watermark:
        level = "hard"
    elif growth > cfg.soft_fraction * watermark:
        level = "soft"
    avail = host_available_mem()
    if avail is not None:
        reg.gauge("mem_host_available_bytes").set(avail)
        if avail < cfg.host_floor_bytes:
            level = "hard"
    level_changed = level != _pressure_level
    if level_changed:
        logger.debug("memory pressure level: %s -> %s", _pressure_level, level)
    _pressure_level = level
    level_int = {"ok": 0, "soft": 1, "hard": 2}[level]
    reg.gauge("mem_pressure").set(level_int)
    now_s = time.monotonic()
    if now_s - _last_trace_sample >= _TRACE_SAMPLE_PERIOD_S or level_changed:
        _last_trace_sample = now_s
        from ..observability.collect import record_sample

        record_sample(rss=rss, pressure=level_int, available=avail)


def _sampler_loop() -> None:
    global _pressure_level
    while not _sampler_stop.is_set():
        if not _tasks_present.wait(timeout=5.0):
            continue
        cfg = get_guard_config()
        # a period passes before each sample: a task shorter than a period
        # is measured at its exit, and a thread woken by every task's start
        # would contend for the GIL with the short units (a device
        # executor's replayed segment) it cannot add to
        if _sampler_stop.wait(cfg.sample_interval_s if cfg is not None else 0.05):
            return
        cfg = get_guard_config()
        with _tasks_lock:
            tasks = list(_tasks.values())
        if not tasks or cfg is None or not cfg.enabled:
            # the last guard exited meanwhile, or the compute disarmed while
            # a task is still inside its guard
            _pressure_level = "ok"
            continue
        _sample_once(cfg, tasks)


def pressure_level() -> str:
    """The sampler's latest host-pressure reading ("ok" when unarmed)."""
    if get_guard_config() is None:
        return "ok"
    return _pressure_level


def last_readings() -> Optional[dict]:
    """The readings of this thread's last guarded task: ``{"key", "device",
    "host", "injected", "measured"}`` (bytes; ``device`` None off the card,
    ``host`` None without ``/proc``), or None."""
    return getattr(_last, "readings", None)


class task_guard:
    """Context manager guarding one task body (see the module docstring).

    ``injected_bytes`` is the fault injector's synthetic spike, added to
    the measured peak. ``observe_only=True`` measures and never judges:
    the device executor's guarded unit is a whole segment or eager op, not
    a retryable task, so comparing it with the per-task budget would say
    nothing (the reference's ``JaxExecutor`` does the same).
    """

    def __init__(self, key: str = "", injected_bytes: int = 0, observe_only: bool = False):
        self._key = key
        self._injected = int(injected_bytes or 0)
        self._observe_only = observe_only
        self._task: Optional[_GuardedTask] = None
        self._cfg: Optional[MemoryGuardConfig] = None
        self._dev: Optional[torch.device] = None
        self._dev_start = 0
        #: the larger of the device growth and the RSS growth, plus the
        #: injected spike (bytes); None while inactive
        self.measured: Optional[int] = None
        #: the two readings apart (None where not read)
        self.device_measured: Optional[int] = None
        self.host_measured: Optional[int] = None

    def __enter__(self) -> "task_guard":
        cfg = get_guard_config()
        if cfg is None or not cfg.enabled:
            return self
        dev = _guard_device()
        start = _read_rss(max_age_s=cfg.sample_interval_s * 1.5)
        if start is None and dev is None:
            return self  # neither /proc nor a card: nothing to measure
        if dev is not None:
            self._dev = dev
            self._dev_start = _start_device_reading(dev)
        self._cfg = cfg
        self._task = _GuardedTask(self._key, start, self._injected)
        if start is not None:
            with _tasks_lock:
                _tasks[id(self)] = self._task
                _tasks_present.set()
            _ensure_sampler()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        global _pressure_level
        task = self._task
        if task is None:
            return
        if task.start_rss is not None:
            with _tasks_lock:
                _tasks.pop(id(self), None)
                if not _tasks:
                    _tasks_present.clear()
                    # no task in flight, no watermark to exceed
                    _pressure_level = "ok"
            # one last sample, so a task shorter than a period still counts
            rss = _read_rss(max_age_s=self._cfg.sample_interval_s * 1.5)
            if rss is not None:
                delta = rss - task.start_rss
                if delta > task.peak_delta:
                    task.peak_delta = delta
            self.host_measured = max(0, task.peak_delta)
        if self._dev is not None:
            self.device_measured = _end_device_reading(self._dev, self._dev_start)
        self.measured = max(self.device_measured or 0, self.host_measured or 0) + task.injected
        _last.readings = {"key": self._key, "device": self.device_measured, "host": self.host_measured,
                          "injected": task.injected, "measured": self.measured}
        if exc_type is not None:
            return  # the body already failed; never mask its error
        cfg = self._cfg
        if self.measured <= cfg.allowed_mem or self._observe_only:
            return
        over = [name for name, v in (("device", self.device_measured), ("host", self.host_measured))
                if v is not None and v + task.injected > cfg.allowed_mem]
        if cfg.mode == "enforce":
            raise MemoryGuardExceededError(
                f"task {self._key or '<unnamed>'} measured "
                f"{memory_repr(self.measured)} ({self.measured} bytes, {'+'.join(over) or 'injected'}) > "
                f"allowed_mem {memory_repr(cfg.allowed_mem)} ({cfg.allowed_mem} bytes)",
                chunk_key=self._key,
                measured=self.measured,
                allowed=cfg.allowed_mem,
            )
        record_scoped_counter("mem_guard_soft_exceeded")
        from ..observability.collect import record_decision

        record_decision("guard_soft_exceeded", chunk=self._key, measured=self.measured,
                        allowed=cfg.allowed_mem, over=over)
        logger.warning(
            "memory guard (observe): task %s measured %s (%d bytes, %s) > "
            "allowed_mem %s (%d bytes) — enforcement is off; set "
            "memory_guard='enforce' to fail such tasks, or raise "
            "allowed_mem / rechunk",
            self._key or "<unnamed>",
            memory_repr(self.measured),
            self.measured,
            "+".join(over) or "injected",
            memory_repr(cfg.allowed_mem),
            cfg.allowed_mem,
        )

    def stats(self) -> dict:
        """The guard's contribution to the task stats dict ({} while
        inactive, so ``memory_guard="off"`` adds nothing)."""
        if self.measured is None:
            return {}
        return {"guard_mem_peak": self.measured}


# ----------------------------------------------------------------------
# admission control
# ----------------------------------------------------------------------


class AdmissionController:
    """AIMD-style concurrency limiter shared by one compute's maps.

    Unbounded (``limit is None``) until the first step-down. ``step_down``
    halves, ``on_success`` doubles back after a full pressure-free window of
    successes, to unbounded once the limit covers the most ever in flight.
    """

    #: minimum seconds between pressure-triggered step-downs
    PRESSURE_COOLDOWN_S = 1.0

    def __init__(self):
        self.limit: Optional[int] = None
        self._max_seen = 1
        self._streak = 0
        self._last_stepdown = 0.0
        self._lock = threading.Lock()

    def has_slot(self, in_flight: int) -> bool:
        with self._lock:
            if in_flight > self._max_seen:
                self._max_seen = in_flight
            return self.limit is None or in_flight < self.limit

    @property
    def throttling(self) -> bool:
        return self.limit is not None

    def step_down(self, in_flight: int) -> int:
        """Halve the in-flight limit (a RESOURCE failure observed)."""
        reg = get_registry()
        with self._lock:
            base = self.limit if self.limit is not None else max(1, in_flight)
            new = max(1, base // 2)
            if self.limit is None or new < self.limit:
                log = logger.warning if self.limit is None else logger.info
                self.limit = new
                self._streak = 0
                self._last_stepdown = time.monotonic()
                reg.counter("mem_pressure_stepdowns").inc()
                reg.gauge("admission_limit").set(new)
                from ..observability.collect import record_decision

                record_decision("admission_step_down", limit=new)
                log("memory pressure: concurrency stepped down to %d in-flight task(s)", new)
            return self.limit

    def on_pressure(self, in_flight: int) -> None:
        """Hard host pressure observed: step down at most once per cooldown."""
        with self._lock:
            if time.monotonic() - self._last_stepdown < self.PRESSURE_COOLDOWN_S:
                return
            if self.limit is not None and in_flight < self.limit:
                return  # already below the limit; let it drain
        self.step_down(in_flight)

    def on_success(self, pressure_ok: bool = True) -> None:
        """A task completed; restore multiplicatively after a full window of
        successes with no pressure."""
        with self._lock:
            if self.limit is None:
                return
            if not pressure_ok:
                self._streak = 0
                return
            self._streak += 1
            if self._streak < self.limit:
                return
            self._streak = 0
            new = self.limit * 2
            reg = get_registry()
            reg.counter("mem_pressure_restores").inc()
            from ..observability.collect import record_decision

            if new >= self._max_seen:
                self.limit = None
                reg.gauge("admission_limit").set(self._max_seen)
                record_decision("admission_restore", limit=None)
                logger.info("memory pressure receded: concurrency unbounded")
            else:
                self.limit = new
                reg.gauge("admission_limit").set(new)
                record_decision("admission_restore", limit=new)
                logger.info("memory pressure receding: concurrency restored to %d", new)


# ----------------------------------------------------------------------
# failure accounting + the actionable abort
# ----------------------------------------------------------------------


def count_resource_failure(metrics, exc: BaseException) -> None:
    """Count a RESOURCE-classified failure (``task_resource_failures``; a
    guard trip also ``mem_guard_hard_exceeded``)."""
    metrics.counter("task_resource_failures").inc()
    if isinstance(exc, MemoryGuardExceededError):
        metrics.counter("mem_guard_hard_exceeded").inc()


def resource_abort_error(op_name: Optional[str], exc: BaseException, at_floor: bool = True) -> MemoryGuardExceededError:
    """The actionable fail-fast for a task over memory even at concurrency 1
    (``at_floor``) or after exhausting its retries under memory pressure:
    only a bigger budget or smaller chunks can help."""
    get_registry().counter("mem_guard_aborts").inc()
    measured, allowed, key = (getattr(exc, name, None) for name in ("measured", "allowed", "chunk_key"))
    if measured is not None and allowed is not None:
        detail = (
            f"measured {memory_repr(measured)} ({measured} bytes) > "
            f"allowed_mem {memory_repr(allowed)} ({allowed} bytes)"
        )
    else:
        detail = f"failed with {type(exc).__name__} ({exc})"
    context = "even at concurrency 1" if at_floor else "after exhausting its retries under memory pressure"
    return MemoryGuardExceededError(
        f"op {op_name or '<unknown>'} {detail} {context} — reduced "
        "concurrency cannot help: raise allowed_mem, or rechunk to "
        "smaller chunks (adjust extra_projected_mem if the projection "
        "was trusted)",
        chunk_key=key,
        measured=measured,
        allowed=allowed,
        op_name=op_name,
    )
