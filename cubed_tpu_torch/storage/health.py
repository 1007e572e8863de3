"""Store-brownout tolerance: throttle classification and a per-store
health breaker that paces storage concurrency instead of burning retries.

Counterpart of ``cubed_tpu/storage/health.py``, whole. A browned-out store
answers 429/503/"SlowDown"; the cure is to slow down, not to retry harder:

- :func:`is_throttle_error` recognizes throttle-shaped failures (that text
  on an OSError-family exception, and the seeded ``storage_throttle_rate``
  fault) so the resilience layer classifies them ``THROTTLE``.
- :class:`StoreHealthBreaker` (one per store root, process-local) is an
  AIMD pacer: every throttle halves the store's in-flight IO limit
  (``open``), chunk IO then queues for a slot (a ``throttle_wait`` span)
  and throttled IO retries in place with paced backoff, drawing nothing
  from the task-retry budget; after a throttle-free probe window
  (``half_open``) successes restore the limit back to unbounded
  (``closed``).

``CUBED_TPU_TORCH_STORE_BREAKER=off`` disables the breaker: throttles then
surface to the task level (classified THROTTLE, retried with backoff).
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Optional

from ..observability.metrics import get_registry

logger = logging.getLogger(__name__)

#: operator kill switch for the breaker (pacing + in-place paced retries);
#: throttle CLASSIFICATION is unaffected — it is just a fact about errors
BREAKER_ENV_VAR = "CUBED_TPU_TORCH_STORE_BREAKER"
_OFF_VALUES = ("0", "off", "false", "no")

#: message fragments that identify a throttle-shaped storage error (the
#: shapes real object stores emit: S3 "SlowDown"/503, GCS 429 "rateLimit",
#: Azure 503 "ServerBusy"); the bare status codes are matched
#: word-bounded via _STATUS_RE, not as substrings
THROTTLE_MARKERS = (
    "slowdown", "slow down", "too many requests",
    "throttl", "rate limit", "ratelimit", "rate exceeded", "server busy",
    "serverbusy",
)

#: 429/503 only WITH HTTP-ish context: preceded by http/status/code/error
#: or followed by throttle words — a chunk file named '503.12', a path
#: segment '/run-429/', or a 503-element shape in an IO error message
#: must never read as a throttle
_STATUS_RE = re.compile(
    r"(?:http|status|code|error)[\s:=_-]{0,3}(?:429|503)(?![0-9])"
    r"|(?<![0-9a-z])(?:429|503)[\s:,-]{1,3}"
    r"(?:slow ?down|too many|service unavailable|server (?:is )?busy)"
)

#: exception type names that are throttles by construction (local or via
#: RemoteTaskError.remote_type off the fleet wire)
THROTTLE_TYPE_NAMES = frozenset({"FaultInjectedThrottleError"})

#: remote exception families whose MESSAGE is worth sniffing for throttle
#: shapes: IO-flavored errors only — a remote ValueError mentioning
#: "(503,)" in a broadcast-shape complaint is not a brownout
_REMOTE_IO_TYPE_NAMES = frozenset({
    "OSError", "IOError", "ConnectionError", "ConnectionResetError",
    "TimeoutError", "FaultInjectedIOError", "FaultInjectedThrottleError",
    "ClientError", "HTTPError", "HttpError", "StorageError",
})

#: in-place paced retries per logical chunk IO while the breaker is on —
#: past this the throttle surfaces to the task level (classified THROTTLE)
THROTTLE_IO_RETRIES = 8

#: numeric breaker states for the ``store_breaker_state`` gauge
STATE_CLOSED, STATE_HALF_OPEN, STATE_OPEN = 0, 1, 2


def breaker_enabled() -> bool:
    return os.environ.get(
        BREAKER_ENV_VAR, ""
    ).strip().lower() not in _OFF_VALUES


def is_throttle_error(exc: BaseException) -> bool:
    """True for throttle-shaped storage failures (see module docstring).

    Checked by name as well as locally so a worker-side throttle crossing
    the fleet wire as ``RemoteTaskError`` still classifies THROTTLE.
    Message sniffing only applies to IO-flavored exceptions (locally by
    isinstance, remotely by ``remote_type``): a ValueError whose text
    happens to contain "503" must never read as a brownout."""
    rtype = getattr(exc, "remote_type", None)
    if type(exc).__name__ in THROTTLE_TYPE_NAMES or (
        rtype in THROTTLE_TYPE_NAMES
    ):
        return True
    if isinstance(
        exc,
        (FileNotFoundError, IsADirectoryError, NotADirectoryError,
         PermissionError),
    ):
        # definitely-local filesystem failures: their messages embed
        # PATHS, which is exactly where digit false-positives live
        return False
    if isinstance(exc, (OSError, ConnectionError)):
        pass  # local IO error: sniff the message
    elif rtype is not None:
        if rtype not in _REMOTE_IO_TYPE_NAMES:
            return False  # remote non-IO error: never a throttle
    else:
        return False
    text = str(exc).lower()
    if any(marker in text for marker in THROTTLE_MARKERS):
        return True
    return _STATUS_RE.search(text) is not None


class StoreHealthBreaker:
    """AIMD pacer for one store's chunk IO (see module docstring).

    ``closed`` (healthy): no limit, :meth:`acquire` is a counter bump.
    ``open``: a throttle was seen recently; the in-flight limit is active
    and halves again on further throttles (cooldown-spaced, like the
    admission controller). ``half_open``: no throttle for
    ``probe_idle_s`` — the limit still applies, but a success streak now
    doubles it back toward unbounded.
    """

    #: minimum spacing between throttle-triggered halvings, so one salvo
    #: of concurrent 429s costs one step, not a collapse to 1
    STEP_COOLDOWN_S = 0.25
    #: throttle-free seconds before recovery probing starts
    PROBE_IDLE_S = 1.0
    #: a blocked acquire waits at most this long for a slot before
    #: proceeding anyway — the breaker degrades throughput, it must never
    #: deadlock a compute against a limit nothing will ever release
    MAX_SLOT_WAIT_S = 30.0

    def __init__(self, store: str):
        self.store = str(store)
        self._cond = threading.Condition()
        self._limit: Optional[int] = None
        #: IOs currently HOLDING a slot (waiters are deliberately not
        #: counted: a waiter inflating the count would keep the
        #: wait-condition true forever once there are more waiters than
        #: slots — the halving base and the gate both want holders only)
        self._active = 0
        self._max_seen = 1
        self._streak = 0
        self._last_throttle = 0.0
        self._last_step = 0.0
        #: consecutive in-place throttle retries observed (pacing input)
        self._consecutive = 0

    # -- state ---------------------------------------------------------

    @property
    def state(self) -> str:
        with self._cond:
            if self._limit is None:
                return "closed"
            if time.monotonic() - self._last_throttle >= self.PROBE_IDLE_S:
                return "half_open"
            return "open"

    def _state_int(self) -> int:
        return {
            "closed": STATE_CLOSED,
            "half_open": STATE_HALF_OPEN,
            "open": STATE_OPEN,
        }[self.state]

    def _publish_state(self) -> None:
        # snapshot under the registry lock: store_breaker() inserts while
        # other stores' IO threads publish, and iterating the live dict
        # would raise mid-exception-handler
        with _breakers_lock:
            breakers = list(_breakers.values())
        get_registry().gauge("store_breaker_state").set(
            max(
                (b._state_int() for b in breakers),
                default=STATE_CLOSED,
            )
        )

    # -- slots ---------------------------------------------------------

    def acquire(self, poll=None) -> float:
        """Take an IO slot; returns the seconds spent waiting for one
        (0.0 on the healthy fast path). Callers record the wait as a
        ``throttle_wait`` span so brownout time is attributed. ``poll``
        (if given) runs between wait quanta and may raise — how a
        cancelled/deadlined compute escapes a long slot wait instead of
        sitting out the full ``MAX_SLOT_WAIT_S``; a poll-raise leaves the
        slot untaken, so the caller's release never runs for it."""
        deadline = None
        waited = 0.0
        with self._cond:
            while self._limit is not None and self._active >= self._limit:
                if deadline is None:
                    deadline = time.monotonic() + self.MAX_SLOT_WAIT_S
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break  # degrade, never deadlock
                t0 = time.monotonic()
                self._cond.wait(timeout=min(remaining, 0.1))
                waited += time.monotonic() - t0
                if poll is not None:
                    poll()
            self._active += 1
            if self._active > self._max_seen:
                self._max_seen = self._active
        if waited:
            get_registry().counter("store_throttle_waits").inc()
        return waited

    def release(self) -> None:
        with self._cond:
            self._active = max(0, self._active - 1)
            self._cond.notify_all()

    # -- AIMD ----------------------------------------------------------

    def on_throttle(self) -> float:
        """A throttle was observed against this store: step the limit
        down (cooldown-spaced) and return the paced delay the caller
        should wait before its in-place retry."""
        now = time.monotonic()
        opened = False
        with self._cond:
            self._last_throttle = now
            self._streak = 0
            self._consecutive += 1
            consecutive = self._consecutive
            if now - self._last_step >= self.STEP_COOLDOWN_S:
                base = (
                    self._limit if self._limit is not None
                    else max(1, self._active)
                )
                new = max(1, base // 2)
                if self._limit is None or new < self._limit:
                    opened = self._limit is None
                    self._limit = new
                    self._last_step = now
                    get_registry().counter("store_breaker_trips").inc()
        if opened:
            from ..observability.collect import record_decision

            record_decision(
                "store_breaker_open", store=self.store, limit=self._limit,
            )
            logger.warning(
                "store %s is throttling (429/503/SlowDown-shaped errors): "
                "breaker open, storage concurrency paced to %d in-flight",
                self.store, self._limit,
            )
        self._publish_state()
        # exponential pacing for the in-place retry, deterministic (chaos
        # tests assert timing bounds): 50ms, 100ms, ... capped at 1s
        return min(1.0, 0.05 * (2 ** min(consecutive - 1, 6)))

    def on_success(self) -> None:
        """A storage op completed cleanly: while half-open, a full
        window of successes doubles the limit back toward unbounded."""
        closed = False
        with self._cond:
            self._consecutive = 0
            if self._limit is None:
                return
            if (
                time.monotonic() - self._last_throttle < self.PROBE_IDLE_S
            ):
                return  # still open: recovery probing hasn't started
            self._streak += 1
            if self._streak < max(2, self._limit):
                return
            self._streak = 0
            new = self._limit * 2
            if new >= self._max_seen:
                self._limit = None
                closed = True
            else:
                self._limit = new
            get_registry().counter("store_breaker_restores").inc()
            limit = self._limit
            self._cond.notify_all()
        from ..observability.collect import record_decision

        record_decision(
            "store_breaker_close" if closed else "store_breaker_restore",
            store=self.store, limit=limit,
        )
        if closed:
            logger.info(
                "store %s recovered: breaker closed, storage concurrency "
                "unbounded", self.store,
            )
        self._publish_state()


_breakers_lock = threading.Lock()
_breakers: dict = {}


def store_breaker(store: str) -> StoreHealthBreaker:
    """The process-local breaker for a store root (created on demand)."""
    key = str(store)
    breaker = _breakers.get(key)
    if breaker is None:
        with _breakers_lock:
            breaker = _breakers.get(key)
            if breaker is None:
                breaker = StoreHealthBreaker(key)
                _breakers[key] = breaker
    return breaker


def reset_breakers() -> None:
    """Drop every breaker (tests; a fresh compute against a recovered
    store should not inherit a previous test's open breaker)."""
    with _breakers_lock:
        _breakers.clear()
    get_registry().gauge("store_breaker_state").set(STATE_CLOSED)
