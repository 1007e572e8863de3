"""Classified retries with exponential backoff and a per-compute budget.

Counterpart of ``cubed_tpu/runtime/resilience.py``. Tasks are idempotent
and their whole-chunk writes atomic, so any task may run more than once;
this module decides when running it again is worth anything:

- **Classification.** ``RetryPolicy.classify`` splits exceptions into
  ``FAIL_FAST`` (programming errors: one attempt), ``RETRY`` (transient:
  back off, consume one of the task's ``retries``), ``RECOMPUTE`` (a
  stored input chunk failed its checksum: its producer re-runs first),
  ``RESOURCE`` (out of memory: host, guard or card), ``THROTTLE`` (the
  store browns out) and ``CANCELLED`` (the compute's token tripped: abort,
  no retry, no budget). Unknown types default to ``RETRY``.
- **The card's errors.** ``torch.OutOfMemoryError`` (a ``RuntimeError``,
  which the reference would retry blindly) classifies ``RESOURCE``, as
  ``MemoryError`` does. A CUDA error that poisons the context (an illegal
  address, a device-side assert: torch reports these asynchronously, and
  every later call in the process fails the same way) classifies
  ``FAIL_FAST``: no retry can succeed after it.
- **Backoff with full jitter** from a seeded ``random.Random``, so a seeded
  run replays its delays; ``jitter="none"`` keeps the deterministic ceiling.
- **Retry budget (circuit breaker)**: one compute-wide allowance,
  ``max(budget_min, budget_factor * n_tasks * retries)``; exhaustion aborts
  the compute with ``RetryBudgetExceededError`` chaining the last error.

The reference's ``REQUEUE`` branches read the fleet's ``WorkerLostError``
and ``RemoteTaskError``; the port has no fleet yet (ROADMAP Queue 1 item
11), so those branches come with it.
"""

from __future__ import annotations

import enum
import math
import random
import threading
from typing import Optional

import torch

from ..observability.metrics import get_registry

#: reference default: 2 retries = 3 attempts per task
DEFAULT_RETRIES = 2


class Classification(enum.Enum):
    """What a failure means for the task that raised it."""

    RETRY = "retry"  #: transient: backoff, consume one retry, re-run
    FAIL_FAST = "fail_fast"  #: deterministic: one attempt, no backoff
    REQUEUE = "requeue"  #: the worker died, not the task (the fleet's; item 11)
    #: a stored input chunk failed integrity verification: the producing
    #: op's task for that chunk re-runs first, then the reader retries
    RECOMPUTE = "recompute"
    #: the task ran out of memory (``MemoryError``, a guard trip, a CUDA
    #: out-of-memory): retried only where less concurrency can help, and
    #: fatal with an actionable error at concurrency 1
    RESOURCE = "resource"
    #: the store is browning out (429/503/"SlowDown"-shaped errors)
    THROTTLE = "throttle"
    #: the compute's cancellation token tripped: abort, no retry, no budget
    CANCELLED = "cancelled"


class RetryBudgetExceededError(RuntimeError):
    """The compute-wide retry budget is spent: failures are systemic, not
    per-task noise. Carries the triggering task error as ``__cause__``."""


class PoisonTaskError(RuntimeError):
    """One task kills every worker it lands on: the request is the fault.
    Names the culprit ``(op, chunk)`` and pickles faithfully."""

    def __init__(self, op: str, chunk: str, attempts: int):
        self.op = str(op)
        self.chunk = str(chunk)
        self.attempts = int(attempts)
        super().__init__(
            f"poison task quarantined: op {self.op!r} chunk {self.chunk!r} "
            f"killed its worker on {self.attempts} consecutive attempts "
            "(OOM-kill/segfault-shaped exits); the request is the fault — "
            "workers survive, the rest of the fleet is untouched"
        )

    def __reduce__(self):
        return (type(self), (self.op, self.chunk, self.attempts))


#: exception type names that are near-certainly deterministic programming
#: errors when raised by a task body (matched by name, as the reference's
#: wire table is)
FAIL_FAST_TYPE_NAMES = frozenset(
    {
        "TypeError",
        "AssertionError",
        "AttributeError",
        "NameError",
        "UnboundLocalError",
        "IndexError",
        "KeyError",
        "ValueError",
        "ZeroDivisionError",
        "NotImplementedError",
        "ImportError",
        "ModuleNotFoundError",
        "SyntaxError",
        "RecursionError",
    }
)

#: the text torch gives a CUDA error reported asynchronously by CUDA:
#: the context is poisoned, and every later call fails the same way
STICKY_CUDA_MARKERS = (
    "cuda error: an illegal memory access",
    "cuda error: an illegal instruction",
    "cuda error: misaligned address",
    "cuda error: unspecified launch failure",
    "device-side assert",
    "cuda kernel errors might be asynchronously reported",
)


def _fail_fast_by_mro(exc: BaseException) -> bool:
    """True if any class in the exception's MRO is deny-listed (so a user
    subclass of ValueError fails fast like ValueError itself)."""
    return any(c.__name__ in FAIL_FAST_TYPE_NAMES for c in type(exc).__mro__)


def is_cuda_out_of_memory(exc: BaseException) -> bool:
    """``torch.OutOfMemoryError`` (``torch.cuda.OutOfMemoryError`` is the
    same class)."""
    return isinstance(exc, torch.OutOfMemoryError)


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """A CUDA error that poisons the context: ``torch.AcceleratorError``
    where torch has it, else a ``RuntimeError`` whose text torch marks as
    an asynchronously reported device fault."""
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    text = str(exc).lower()
    return any(marker in text for marker in STICKY_CUDA_MARKERS)


class RetryPolicy:
    """Classification + backoff + budget, shared by every executor.

    Parameters are the reference's: ``retries`` per task (attempts =
    retries + 1); the nth failure's backoff ceiling
    ``min(backoff_max, backoff_base * backoff_multiplier**(n-1))``;
    ``jitter`` ``"full"`` (uniform in [0, ceiling]) or ``"none"``; ``seed``
    for the jitter; ``max_requeues`` (the fleet's); ``budget_factor`` /
    ``budget_min`` size ``new_budget`` (``budget_factor=None`` disables the
    circuit breaker).
    """

    def __init__(
        self,
        retries: int = DEFAULT_RETRIES,
        backoff_base: float = 0.05,
        backoff_multiplier: float = 2.0,
        backoff_max: float = 5.0,
        jitter: str = "full",
        seed: Optional[int] = None,
        max_requeues: int = 3,
        budget_factor: Optional[float] = 0.5,
        budget_min: int = 8,
    ):
        if jitter not in ("full", "none"):
            raise ValueError(f"jitter must be 'full' or 'none', got {jitter!r}")
        self.retries = int(retries)
        self.backoff_base = float(backoff_base)
        self.backoff_multiplier = float(backoff_multiplier)
        self.backoff_max = float(backoff_max)
        self.jitter = jitter
        self.seed = seed
        self.max_requeues = int(max_requeues)
        self.budget_factor = budget_factor
        self.budget_min = int(budget_min)
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()

    # -- classification -------------------------------------------------

    def classify(self, exc: BaseException) -> Classification:
        from concurrent.futures import BrokenExecutor

        from ..storage.health import is_throttle_error
        from ..storage.integrity import ChunkIntegrityError
        from .cancellation import ComputeCancelledError
        from .memory import MemoryGuardExceededError

        if isinstance(exc, ComputeCancelledError):
            # an instruction, not a failure: never retried, no budget drawn
            return Classification.CANCELLED
        if isinstance(exc, PoisonTaskError):
            return Classification.FAIL_FAST
        if isinstance(exc, (MemoryError, MemoryGuardExceededError)) or is_cuda_out_of_memory(exc):
            # out of memory on the host, under the guard or on the card:
            # retrying at the same concurrency recreates the pressure
            return Classification.RESOURCE
        if is_sticky_cuda_error(exc):
            # the CUDA context is poisoned: every retry fails the same way
            return Classification.FAIL_FAST
        if isinstance(exc, ChunkIntegrityError):
            # a corrupt input chunk (quarantined): its producer re-runs first
            return Classification.RECOMPUTE
        if isinstance(exc, BrokenExecutor):
            return Classification.REQUEUE
        if _fail_fast_by_mro(exc):
            return Classification.FAIL_FAST
        if is_throttle_error(exc):
            return Classification.THROTTLE
        # OSError and friends, TimeoutError, plain RuntimeError from user
        # code: worth another attempt
        return Classification.RETRY

    # -- backoff --------------------------------------------------------

    def backoff_ceiling(self, failure_n: int) -> float:
        """Deterministic delay ceiling for the nth failure (1-based)."""
        n = max(1, int(failure_n))
        return min(self.backoff_max, self.backoff_base * self.backoff_multiplier ** (n - 1))

    def backoff_delay(self, failure_n: int) -> float:
        """The delay to wait before re-running after the nth failure."""
        ceiling = self.backoff_ceiling(failure_n)
        if self.jitter == "none":
            return ceiling
        with self._rng_lock:
            return self._rng.uniform(0.0, ceiling)

    # -- budget ---------------------------------------------------------

    def new_budget(self, n_tasks: Optional[int] = None) -> "RetryBudget":
        """A compute-wide retry allowance sized to the task count."""
        if self.budget_factor is None or self.retries <= 0:
            return RetryBudget(None)
        limit = max(
            self.budget_min,
            math.ceil(self.budget_factor * max(0, n_tasks or 0) * self.retries),
        )
        return RetryBudget(limit)

    def __repr__(self) -> str:
        return (
            f"RetryPolicy(retries={self.retries}, "
            f"backoff={self.backoff_base}x{self.backoff_multiplier}"
            f"<= {self.backoff_max}, jitter={self.jitter!r}, "
            f"max_requeues={self.max_requeues})"
        )


class RetryBudget:
    """Thread-safe compute-wide retry allowance. ``limit=None`` = unbounded."""

    def __init__(self, limit: Optional[int]):
        self.limit = limit
        self.spent = 0
        self._lock = threading.Lock()

    def consume(self, n: int = 1) -> bool:
        """Draw *n* retries; False (nothing drawn) once the budget is spent."""
        with self._lock:
            if self.limit is not None and self.spent + n > self.limit:
                return False
            self.spent += n
            return True

    @property
    def remaining(self) -> Optional[int]:
        with self._lock:
            return None if self.limit is None else self.limit - self.spent

    def __repr__(self) -> str:
        return f"RetryBudget(spent={self.spent}, limit={self.limit})"


def resolve_policy(retry_policy: Optional[RetryPolicy], retries: Optional[int]) -> RetryPolicy:
    """An explicit policy wins; otherwise a default policy built around the
    ``retries`` int."""
    if retry_policy is not None:
        return retry_policy
    return RetryPolicy(retries=DEFAULT_RETRIES if retries is None else retries)


def integrity_payload(exc: BaseException) -> Optional[dict]:
    """The ``{store, chunk_key, ...}`` payload of an integrity failure, else
    None."""
    return getattr(exc, "wire_payload", None) or None


def budget_exhausted_error(exc: BaseException, budget: RetryBudget):
    """Uniform circuit-breaker trip: counted and chained."""
    get_registry().counter("retry_budget_exhausted").inc()
    return RetryBudgetExceededError(
        f"compute-wide retry budget exhausted ({budget.spent} retries "
        f"consumed, limit {budget.limit}): failures are systemic, not "
        f"per-task noise; last task error: {exc!r}"
    )


def compute_retry_budget(policy: RetryPolicy, dag) -> RetryBudget:
    """One circuit-breaker allowance for a whole compute, sized to the
    plan's total task count."""
    from .pipeline import iter_op_nodes

    total = sum(d["primitive_op"].num_tasks for _, d in iter_op_nodes(dag))
    return policy.new_budget(total)
