"""Overload robustness for the compute service: the degradation ladder,
deadline-feasibility admission, and per-tenant circuit breakers.
Counterpart of ``cubed_tpu/service/overload.py``.

Every infrastructure failure domain below this layer already degrades
gracefully (retries, integrity, memory, partitions, failover);
this module handles the day the *workload itself* is the fault: sustained
2x overload, or one tenant whose requests cannot succeed. The design is
the standard production answer (Google SRE "Handling Overload"): degrade
in stages, shed the cheapest work first, and fail requests *fast* when
executing them can only produce a guaranteed SLO miss.

**The ladder.** :class:`OverloadController` ticks inside the service
dispatch loop (~4/s) reading live signals the stack already emits — the
service queue depth, ``dispatch_utilization``,
``fleet_pressured_fraction``,
and the trailing deadline-miss rate (request deadlines) — and walks:

- **L0 normal** — admit everything.
- **L1 shed optional work** — speculative backups off (the executors
  consult :func:`sheds_optional_work`), the telemetry sampler throttled,
  the peer cache shrunk through its existing pressure hook.
- **L2 shed load** — deadline-infeasible requests are failed at admission
  with :class:`DeadlineInfeasibleError` (estimated cost from the plan
  cache's task count x the observed per-tenant seconds-per-task rate),
  and new *batch*-class submits are rejected with
  :class:`ServiceOverloadedError` carrying a retry-after hint.
  Interactive-class submits still land.
- **L3 emergency** — every new submit is rejected; already-accepted and
  running requests are protected and drain the backlog.

Transitions are hysteresis-guarded — stepping up is immediate, stepping
down requires the exit condition to hold for a dwell window, and happens
one level at a time — so a sawtoothing queue cannot flap the ladder.
Every transition is a decision-ring record (``overload_level``) and the
``overload_level`` gauge, which the telemetry sampler auto-records into
the time-series store, where the ``overload_shedding`` alert rule reads
it.

**Circuit breakers.** :class:`TenantBreaker` is the classic
consecutive-failure breaker with a half-open probe, one per tenant, so a
tenant whose every request fails (the poison tenant, a broken pipeline)
stops consuming admission slots and retry budget after ``threshold``
consecutive failures. Breaker state is durable (one small JSON per tenant
beside its request journal) and reloads on service restart — a SIGKILL
does not reset a tripped breaker (the recovery contract extends to
shed state).

``CUBED_TPU_TORCH_OVERLOAD=off`` (or ``0``/``false``) disables the whole
ladder: the escape hatch.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

from ..observability.collect import record_decision
from ..observability.metrics import get_registry

logger = logging.getLogger(__name__)

#: env escape hatch: "off" / "0" / "false" disables the ladder entirely
OVERLOAD_ENV_VAR = "CUBED_TPU_TORCH_OVERLOAD"

#: ladder levels (the gauge value IS the level)
L0_NORMAL = 0
L1_SHED_OPTIONAL = 1
L2_SHED_LOAD = 2
L3_EMERGENCY = 3

LEVEL_NAMES = ("normal", "shed_optional", "shed_load", "emergency")


def overload_env_disabled() -> bool:
    return os.environ.get(OVERLOAD_ENV_VAR, "").strip().lower() in (
        "off", "0", "false", "no",
    )


class ServiceOverloadedError(RuntimeError):
    """The service is shedding load: the request was rejected, not run.

    ``retry_after_s`` is the hint a well-behaved client should wait
    before resubmitting (estimated backlog drain time, or the breaker's
    remaining cooldown). Pickles faithfully (``__reduce__``) so the typed
    rejection survives the durable-journal round trip and pool result
    queues."""

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        self.retry_after_s = (
            None if retry_after_s is None else float(retry_after_s)
        )
        super().__init__(message)

    def __reduce__(self):
        return (type(self), (self.args[0], self.retry_after_s))


class DeadlineInfeasibleError(ServiceOverloadedError):
    """The request's estimated cost cannot meet its deadline: executing
    it would only produce a guaranteed SLO miss while displacing feasible
    work — failed fast at admission instead (L2+)."""


# -- module-level ladder state (what the executors consult) --------------

_live_lock = threading.Lock()
#: id(controller) -> current level, for every live controller in-process
_live_levels: Dict[int, int] = {}


def _publish_level(controller_id: int, level: Optional[int]) -> None:
    with _live_lock:
        if level is None:
            _live_levels.pop(controller_id, None)
        else:
            _live_levels[controller_id] = level


def current_overload_level() -> int:
    """The worst (highest) level across live controllers in this process."""
    with _live_lock:
        return max(_live_levels.values(), default=L0_NORMAL)


def sheds_optional_work() -> bool:
    """True at L1+: speculative backups and other optional work are shed
    (consulted by ``map_unordered`` on every backup-launch scan)."""
    return current_overload_level() >= L1_SHED_OPTIONAL


@dataclass
class OverloadPolicy:
    """Ladder thresholds. Defaults are sized for the reference service
    (a handful of admission slots); tests and small fixtures pass their
    own. Enter thresholds step UP; the exit condition is the enter
    threshold scaled by ``exit_fraction``, held for ``down_dwell_s``."""

    #: queued (accepted, not yet running) requests
    queue_l1: int = 8
    queue_l2: int = 16
    queue_l3: int = 32
    #: fraction of live fleet workers reporting memory pressure
    pressured_l1: float = 0.5
    #: dispatch-loop busy fraction
    util_l1: float = 0.95
    #: trailing deadline-miss fraction that proves the backlog is already
    #: blowing SLOs (needs >= miss_min_samples completions in the window)
    miss_rate_l2: float = 0.5
    miss_window_s: float = 30.0
    miss_min_samples: int = 4
    #: hysteresis: exit thresholds = enter * exit_fraction, and the exit
    #: condition must hold this long before stepping DOWN one level
    exit_fraction: float = 0.5
    down_dwell_s: float = 2.0
    #: controller tick spacing (the dispatch loop calls more often)
    tick_interval_s: float = 0.25
    #: L1 brownout: the telemetry sampler's interval is stretched by this
    #: factor while shedding optional work
    sampler_throttle_factor: float = 5.0
    #: retry-after hint bounds
    retry_after_min_s: float = 1.0
    retry_after_max_s: float = 60.0


class CostEstimator:
    """Observed seconds-per-task, per tenant (EWMA) with a global
    fallback: the feasibility model is ``estimate = plan task count x
    observed rate``. No observations yet -> no estimate -> admission
    fails OPEN (a cold service must not reject its first requests)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        #: tenant (or None = global) -> EWMA seconds per task
        self._rates: Dict[Optional[str], float] = {}

    def observe(self, tenant: Optional[str], num_tasks: int,
                wall_s: float) -> None:
        if not num_tasks or num_tasks <= 0 or wall_s <= 0:
            return
        per_task = float(wall_s) / float(num_tasks)
        with self._lock:
            for key in (tenant, None):
                prev = self._rates.get(key)
                self._rates[key] = (
                    per_task if prev is None
                    else prev + self.alpha * (per_task - prev)
                )

    def seconds_per_task(self, tenant: Optional[str]) -> Optional[float]:
        with self._lock:
            return self._rates.get(tenant, self._rates.get(None))

    def estimate_s(self, tenant: Optional[str],
                   num_tasks: Optional[int]) -> Optional[float]:
        """Estimated wall seconds for a request of ``num_tasks`` tasks,
        or None when either side of the model is unknown."""
        if not num_tasks:
            return None
        rate = self.seconds_per_task(tenant)
        if rate is None:
            return None
        return rate * int(num_tasks)


class TenantBreaker:
    """One tenant's circuit breaker: consecutive-failure trip, timed
    cooldown, half-open single probe — with the strike record durable
    beside the tenant's request journal so a tripped breaker survives a
    service SIGKILL.

    States: ``closed`` (admitting; ``strikes`` consecutive failures so
    far), ``open`` (rejecting until ``cooldown_s`` elapses), ``half_open``
    (exactly one probe request admitted; its success closes the breaker,
    its failure re-opens a fresh cooldown)."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self, tenant: str, threshold: int = 3, cooldown_s: float = 10.0,
        state_path: Optional[str] = None, clock=time.time,
    ):
        self.tenant = str(tenant)
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.state_path = state_path
        self._clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.strikes = 0
        self.opened_at = 0.0
        self._probing = False
        self._load()

    # -- durability ----------------------------------------------------

    def _load(self) -> None:
        if not self.state_path or not os.path.isfile(self.state_path):
            return
        try:
            with open(self.state_path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            self.state = str(doc.get("state", self.CLOSED))
            self.strikes = int(doc.get("strikes", 0))
            self.opened_at = float(doc.get("opened_at", 0.0))
            if self.state not in (self.CLOSED, self.OPEN, self.HALF_OPEN):
                self.state = self.CLOSED
            if self.state == self.HALF_OPEN:
                # a probe in flight when the process died resolved nothing:
                # come back OPEN with the cooldown it re-entered from
                self.state = self.OPEN
        except (OSError, ValueError):
            logger.warning(
                "tenant %s: unreadable breaker state %s — starting closed",
                self.tenant, self.state_path,
            )

    def _persist_locked(self) -> None:
        if not self.state_path:
            return
        try:
            tmp = self.state_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({
                    "tenant": self.tenant,
                    "state": self.state,
                    "strikes": self.strikes,
                    "opened_at": self.opened_at,
                }, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.state_path)
        except OSError:
            logger.warning(
                "tenant %s: breaker state not durable (%s unwritable)",
                self.tenant, self.state_path,
            )

    # -- the breaker ---------------------------------------------------

    def check(self) -> Optional[float]:
        """None -> admit. A float -> reject, retry after that many
        seconds. An elapsed cooldown flips OPEN -> HALF_OPEN and admits
        exactly one probe."""
        now = self._clock()
        with self._lock:
            if self.state == self.CLOSED:
                return None
            if self.state == self.OPEN:
                remaining = self.opened_at + self.cooldown_s - now
                if remaining > 0:
                    return max(0.1, remaining)
                self.state = self.HALF_OPEN
                self._probing = False
                self._persist_locked()
                record_decision(
                    "tenant_breaker", tenant=self.tenant,
                    state=self.HALF_OPEN, strikes=self.strikes,
                )
            # HALF_OPEN: one probe at a time
            if self._probing:
                return max(0.1, self.cooldown_s / 2.0)
            self._probing = True
            return None

    def on_failure(self) -> bool:
        """Count one request failure; True when this strike TRIPPED the
        breaker (closed/half-open -> open)."""
        now = self._clock()
        with self._lock:
            self.strikes += 1
            tripped = (
                self.state == self.HALF_OPEN
                or (self.state == self.CLOSED
                    and self.strikes >= self.threshold)
            )
            if tripped:
                self.state = self.OPEN
                self.opened_at = now
                self._probing = False
            self._persist_locked()
        if tripped:
            get_registry().counter("tenant_breaker_trips").inc()
            record_decision(
                "tenant_breaker", tenant=self.tenant, state=self.OPEN,
                strikes=self.strikes, cooldown_s=self.cooldown_s,
            )
            logger.warning(
                "tenant %s: circuit breaker OPEN after %d consecutive "
                "failures (cooldown %.1fs)", self.tenant, self.strikes,
                self.cooldown_s,
            )
        return tripped

    def abort_probe(self) -> None:
        """Release the half-open probe slot without resolving it: the
        admitted probe request died of something that was NOT the
        tenant's workload (throttle bound, journal error) before it could
        run, so the next submit may probe instead."""
        with self._lock:
            if self.state == self.HALF_OPEN:
                self._probing = False

    def on_success(self) -> None:
        with self._lock:
            was_open = self.state != self.CLOSED
            self.state = self.CLOSED
            self.strikes = 0
            self._probing = False
            self._persist_locked()
        if was_open:
            record_decision(
                "tenant_breaker", tenant=self.tenant, state=self.CLOSED,
            )
            logger.info(
                "tenant %s: circuit breaker closed (probe succeeded)",
                self.tenant,
            )

    @property
    def is_open(self) -> bool:
        with self._lock:
            if self.state == self.OPEN:
                return self.opened_at + self.cooldown_s > self._clock()
            return self.state == self.HALF_OPEN and self._probing

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tenant": self.tenant,
                "state": self.state,
                "strikes": self.strikes,
                "opened_at": self.opened_at,
            }


class OverloadController:
    """The hysteresis-guarded degradation ladder (module docstring).

    The owning service calls :meth:`tick` from its dispatch loop with the
    live queue depth, :meth:`note_completion` as requests finish (feeding
    the deadline-miss window), and :meth:`close` on shutdown. Everything
    else — the other signals, the L1 side effects, the gauge and the
    decision records — the controller handles itself, and everything
    degrades to a no-op when telemetry is not armed."""

    def __init__(self, policy: Optional[OverloadPolicy] = None,
                 clock=time.time):
        self.policy = policy or OverloadPolicy()
        self._clock = clock
        self._lock = threading.Lock()
        self.level = L0_NORMAL
        self.transitions = 0
        self._last_tick = 0.0
        #: when the exit (step-down) condition was first continuously true
        self._exit_since: Optional[float] = None
        #: trailing (ts, missed) completions for the miss-rate signal
        self._completions: deque = deque(maxlen=1024)
        #: telemetry sampler interval saved across the L1 brownout
        self._saved_sampler_interval: Optional[float] = None
        self._closed = False
        _publish_level(id(self), L0_NORMAL)
        get_registry().gauge("overload_level").set(L0_NORMAL)

    # -- signal feeds ---------------------------------------------------

    def note_completion(self, deadline_missed: bool) -> None:
        self._completions.append((self._clock(), bool(deadline_missed)))

    def miss_rate(self, now: Optional[float] = None) -> float:
        """Deadline-miss fraction over the trailing window (0.0 until
        ``miss_min_samples`` completions have landed in it)."""
        now = self._clock() if now is None else now
        cutoff = now - self.policy.miss_window_s
        total = missed = 0
        for ts, m in self._completions:
            if ts >= cutoff:
                total += 1
                missed += bool(m)
        if total < self.policy.miss_min_samples:
            return 0.0
        return missed / total

    @staticmethod
    def _dispatch_utilization() -> float:
        try:
            return float(
                get_registry().gauge("dispatch_utilization").value or 0.0
            )
        except Exception:
            return 0.0

    @staticmethod
    def _fleet_pressured_fraction() -> float:
        try:
            from ..observability.export import get_runtime

            rt = get_runtime()
            if rt is not None:
                v = rt.store.latest("fleet_pressured_fraction")
                if v is not None:
                    return float(v)
        except Exception:
            pass
        return 0.0

    # -- the ladder -----------------------------------------------------

    def _propose(self, queue_depth: int, util: float, pressured: float,
                 miss: float, scale: float = 1.0) -> int:
        """The level the signals justify; ``scale`` < 1 evaluates the
        (lower) exit thresholds for the step-down condition."""
        p = self.policy
        if queue_depth >= p.queue_l3 * scale:
            return L3_EMERGENCY
        if queue_depth >= p.queue_l2 * scale or miss >= p.miss_rate_l2 * scale:
            return L2_SHED_LOAD
        if (
            queue_depth >= p.queue_l1 * scale
            or pressured >= p.pressured_l1 * scale
            or util >= p.util_l1 * scale
        ):
            return L1_SHED_OPTIONAL
        return L0_NORMAL

    def tick(self, queue_depth: int, now: Optional[float] = None) -> int:
        """One policy-loop step; returns the (possibly new) level."""
        now = self._clock() if now is None else now
        with self._lock:
            if self._closed:
                return self.level
            if now - self._last_tick < self.policy.tick_interval_s:
                return self.level
            self._last_tick = now
            util = self._dispatch_utilization()
            pressured = self._fleet_pressured_fraction()
            miss = self.miss_rate(now)
            up = self._propose(queue_depth, util, pressured, miss)
            if up > self.level:
                # overload response must be immediate: jump straight to
                # the level the signals justify
                self._transition_locked(
                    up, now, queue_depth, util, pressured, miss,
                )
                return self.level
            down = self._propose(
                queue_depth, util, pressured, miss,
                scale=self.policy.exit_fraction,
            )
            if down < self.level:
                if self._exit_since is None:
                    self._exit_since = now
                elif now - self._exit_since >= self.policy.down_dwell_s:
                    # recovery is deliberate: one level per dwell window,
                    # so a queue oscillating around a threshold cannot
                    # flap the ladder
                    self._transition_locked(
                        self.level - 1, now, queue_depth, util, pressured,
                        miss,
                    )
            else:
                self._exit_since = None
            return self.level

    def _transition_locked(self, new: int, now: float, queue_depth: int,
                           util: float, pressured: float,
                           miss: float) -> None:
        old, self.level = self.level, new
        self.transitions += 1
        self._exit_since = None
        _publish_level(id(self), new)
        reg = get_registry()
        reg.gauge("overload_level").set(new)
        reg.counter("overload_transitions").inc()
        record_decision(
            "overload_level",
            from_level=old, to_level=new, name=LEVEL_NAMES[new],
            queue_depth=int(queue_depth), utilization=round(util, 4),
            pressured_fraction=round(pressured, 4),
            miss_rate=round(miss, 4),
        )
        logger.warning(
            "overload ladder: L%d (%s) -> L%d (%s) [queue=%d util=%.2f "
            "pressured=%.2f miss=%.2f]", old, LEVEL_NAMES[old], new,
            LEVEL_NAMES[new], queue_depth, util, pressured, miss,
        )
        if old < L1_SHED_OPTIONAL <= new:
            self._enter_brownout_locked()
        elif new < L1_SHED_OPTIONAL <= old:
            self._exit_brownout_locked()

    # -- L1 side effects (shed optional work) ---------------------------

    def _enter_brownout_locked(self) -> None:
        # telemetry sampler throttled: observation is optional work too
        try:
            from ..observability.export import get_runtime

            rt = get_runtime()
            if rt is not None and self._saved_sampler_interval is None:
                self._saved_sampler_interval = rt.sampler.interval_s
                rt.sampler.interval_s = (
                    self._saved_sampler_interval
                    * self.policy.sampler_throttle_factor
                )
        except Exception:
            pass
        # the peer cache sheds half its footprint through the existing
        # memory-pressure hook (workers do the same via their own guard
        # heartbeats when the pressure is fleet-wide)
        try:
            from ..runtime import transfer

            rt_peer = transfer.get_worker_runtime()
            if rt_peer is not None:
                rt_peer.pressure_tick("soft")
        except Exception:
            pass

    def _exit_brownout_locked(self) -> None:
        if self._saved_sampler_interval is not None:
            try:
                from ..observability.export import get_runtime

                rt = get_runtime()
                if rt is not None:
                    rt.sampler.interval_s = self._saved_sampler_interval
            except Exception:
                pass
            self._saved_sampler_interval = None

    # -- admission helpers ----------------------------------------------

    def retry_after_s(self, queue_depth: int,
                      drain_rate_s: Optional[float] = None) -> float:
        """The hint attached to a shed: roughly when the backlog should
        have drained (``queue_depth x seconds-per-request`` when a drain
        rate is known, else half a second per queued request), clamped
        to the policy bounds."""
        per = drain_rate_s if drain_rate_s and drain_rate_s > 0 else 0.5
        est = max(1, int(queue_depth)) * per
        return min(
            self.policy.retry_after_max_s,
            max(self.policy.retry_after_min_s, est),
        )

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "level": self.level,
                "name": LEVEL_NAMES[self.level],
                "transitions": self.transitions,
                "miss_rate": round(self.miss_rate(), 4),
            }

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self.level >= L1_SHED_OPTIONAL:
                self._exit_brownout_locked()
        _publish_level(id(self), None)
