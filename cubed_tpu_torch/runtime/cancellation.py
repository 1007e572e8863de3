"""End-to-end deadlines and cooperative cancellation: bound a compute's
time the way the rest of the stack bounds its memory.

Counterpart of ``cubed_tpu/runtime/cancellation.py``, less the fleet's
wire (worker-side token mirrors and ``compute_cancel`` frames come with
ROADMAP Queue 1 item 11):

- **One token per compute.** ``Plan.execute(deadline_s=...)`` (or an
  explicit ``cancellation=CancellationToken()``) mints it. The deadline is
  an absolute wall-clock epoch.
- **Where it is checked.** The sequential executor's loop before every
  task; ``execute_with_stats`` before a task body; the storage layer
  between chunk reads and writes (``storage/store.py``); the device
  executor at every op and segment boundary, never inside a CUDA graph
  capture or replay (a replay cannot be interrupted). A task aborts at
  the next safe boundary, never mid-write, so a resumed compute after an
  abort is bitwise correct.
- **The errors** (:class:`ComputeCancelledError` /
  :class:`ComputeDeadlineExceededError`) are picklable and classified
  ``CANCELLED`` by the resilience layer: no retry, no budget drawn.

Token lookup is keyed by the compute id on the ``logs.compute_id_var``
contextvar, so concurrent computes in one process cancel independently.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from ..observability.metrics import get_registry

class ComputeCancelledError(RuntimeError):
    """The compute's cancellation token was tripped (explicit
    ``CancellationToken.cancel()`` — a client cancel, a service shutdown).

    Picklable (it crosses process boundaries like any task failure) and classified ``CANCELLED`` by the resilience layer: no
    retry, no backoff, zero retry-budget draw — cancellation is an
    *instruction*, not a failure to recover from."""

    def __init__(self, message: str = "compute cancelled",
                 compute_id: Optional[str] = None,
                 reason: Optional[str] = None):
        super().__init__(message)
        self.compute_id = compute_id
        self.reason = reason

    def __reduce__(self):
        return (
            type(self),
            (self.args[0] if self.args else "", self.compute_id, self.reason),
        )


class ComputeDeadlineExceededError(ComputeCancelledError):
    """The compute ran past its deadline (``deadline_s``). A subclass of
    :class:`ComputeCancelledError` so every cooperative-abort check covers
    both; kept distinct so callers can tell an operator-initiated cancel
    from an SLO violation."""


class CancellationToken:
    """One compute's deadline + cancel flag, shared by every layer.

    Thread-safe; cheap to poll (``cancelled`` is an event check plus one
    ``time.time()`` comparison). ``on_abort`` callbacks fire exactly once
    — on explicit :meth:`cancel`, or when the first enforcement point
    observes an expired deadline (:meth:`notify_abort`)."""

    def __init__(self, deadline_s: Optional[float] = None,
                 deadline_epoch: Optional[float] = None,
                 compute_id: Optional[str] = None):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._callbacks: list[Callable[[], None]] = []
        self._notified = False
        #: True when cancel() tripped the token BEFORE the deadline
        #: passed: error() must then report the explicit cancel even if
        #: the deadline has also expired by observation time
        self._explicit = False
        self.reason: Optional[str] = None
        self.compute_id = compute_id
        self.deadline_epoch: Optional[float] = deadline_epoch
        if deadline_s is not None:
            self.set_deadline(deadline_s)

    # -- arming --------------------------------------------------------

    def set_deadline(self, deadline_s: float) -> None:
        """Arm (or tighten) the deadline to ``deadline_s`` seconds from
        now. A later deadline never loosens an armed earlier one."""
        epoch = time.time() + float(deadline_s)
        with self._lock:
            if self.deadline_epoch is None or epoch < self.deadline_epoch:
                self.deadline_epoch = epoch

    def on_abort(self, fn: Callable[[], None]) -> None:
        """Register a callback fired once when the token trips (already
        tripped -> fired immediately)."""
        fire = False
        with self._lock:
            if self._notified:
                fire = True
            else:
                self._callbacks.append(fn)
        if fire:
            try:
                fn()
            except Exception:
                pass

    # -- state ---------------------------------------------------------

    @property
    def expired(self) -> bool:
        d = self.deadline_epoch
        return d is not None and time.time() >= d

    @property
    def cancelled(self) -> bool:
        """True once the token has tripped (explicit cancel or deadline)."""
        return self._event.is_set() or self.expired

    def remaining(self) -> Optional[float]:
        """Seconds until the deadline (None = no deadline; <= 0 expired)."""
        d = self.deadline_epoch
        return None if d is None else d - time.time()

    # -- tripping ------------------------------------------------------

    def cancel(self, reason: Optional[str] = None) -> None:
        """Trip the token explicitly. Idempotent; fires the abort
        callbacks from the caller's thread."""
        with self._lock:
            if self.reason is None:
                self.reason = reason
            if not self.expired:
                # which bound tripped FIRST is decided here, not at the
                # (possibly much later) observation point
                self._explicit = True
        self._event.set()
        self.notify_abort()

    def notify_abort(self) -> None:
        """Fire the abort callbacks exactly once (also called by the
        first enforcement point to observe an expired deadline)."""
        with self._lock:
            if self._notified:
                return
            self._notified = True
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn()
            except Exception:
                pass

    def error(self) -> ComputeCancelledError:
        """The typed error this token aborts with: whichever bound
        tripped FIRST wins — an explicit cancel() issued before the
        deadline passed reports the cancel even when the dispatch loop
        only observes it after expiry."""
        if self._explicit or (self._event.is_set() and not self.expired):
            return ComputeCancelledError(
                f"compute {self.compute_id or '<unnamed>'} cancelled"
                + (f": {self.reason}" if self.reason else ""),
                compute_id=self.compute_id, reason=self.reason,
            )
        if self.expired:
            return ComputeDeadlineExceededError(
                f"compute {self.compute_id or '<unnamed>'} exceeded its "
                f"deadline (epoch {self.deadline_epoch})",
                compute_id=self.compute_id, reason="deadline",
            )
        return ComputeCancelledError(
            f"compute {self.compute_id or '<unnamed>'} cancelled"
            + (f": {self.reason}" if self.reason else ""),
            compute_id=self.compute_id, reason=self.reason,
        )

    def check(self) -> None:
        """Raise the typed error if tripped (cooperative-abort check)."""
        if self.cancelled:
            raise self.error()

    def __repr__(self) -> str:
        return (
            f"CancellationToken(compute={self.compute_id!r}, "
            f"deadline_epoch={self.deadline_epoch}, "
            f"cancelled={self.cancelled})"
        )


# ----------------------------------------------------------------------
# the per-process registry: compute id -> the token Plan.execute armed
# ----------------------------------------------------------------------

_lock = threading.Lock()
_client_tokens: "OrderedDict[str, CancellationToken]" = OrderedDict()
#: fast path: True only while ANY token is registered in this process —
#: the per-chunk-IO check must cost one attribute read when unused
_any_tokens = False


def _refresh_any() -> None:
    global _any_tokens
    _any_tokens = bool(_client_tokens)


def register_compute(compute_id: str, token: CancellationToken) -> None:
    """Associate a compute's token with its id for the duration of
    ``Plan.execute`` (task bodies check it per chunk IO)."""
    token.compute_id = token.compute_id or compute_id
    with _lock:
        _client_tokens[compute_id] = token
        _refresh_any()


def unregister_compute(compute_id: str) -> None:
    with _lock:
        _client_tokens.pop(compute_id, None)
        _refresh_any()


def current_token() -> Optional[CancellationToken]:
    """The token governing the CURRENT compute, resolved through the
    compute-id contextvar only (set by ``Plan.execute``), not the env-var
    fallback ``logs.current_compute_id`` uses: the env export is
    last-writer-wins across concurrent computes. None when no compute is
    armed: the common fast path, one flag read."""
    if not _any_tokens:
        return None
    from ..observability.logs import compute_id_var

    cid = compute_id_var.get()
    if not cid:
        return None
    with _lock:
        return _client_tokens.get(cid)


def check_current() -> None:
    """Cooperative-abort check at a safe boundary (task start, between
    chunk reads/writes): raises the typed error when the governing token
    has tripped. A no-op (one attribute read) with no tokens armed."""
    token = current_token()
    if token is not None and token.cancelled:
        raise token.error()


def abort(token: CancellationToken) -> ComputeCancelledError:
    """The one counted/recorded abort path every dispatch loop shares:
    counts ``deadline_aborts`` or ``cancellations``, records the decision
    (``deadline_exceeded`` / ``compute_cancelled``), fires the token's
    abort callbacks, and returns the error to raise."""
    from ..observability.collect import record_decision

    token.notify_abort()
    err = token.error()
    reg = get_registry()
    if isinstance(err, ComputeDeadlineExceededError):
        reg.counter("deadline_aborts").inc()
        record_decision(
            "deadline_exceeded", compute=token.compute_id,
            deadline_epoch=token.deadline_epoch,
        )
    else:
        reg.counter("cancellations").inc()
        record_decision(
            "compute_cancelled", compute=token.compute_id,
            reason=token.reason,
        )
    return err
