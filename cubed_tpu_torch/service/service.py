"""The multi-tenant compute service: a persistent front door over one fleet.
Counterpart of ``cubed_tpu/service/service.py``.

One :class:`ComputeService` wraps one executor (any DagExecutor: the
device executor on one card, the autoscaled distributed fleet, the threaded
executor) and accepts many concurrent computes from many tenants:

.. code-block:: python

    svc = ComputeService(executor=ex, tenants={"gold": 4.0, "free": 1.0},
                         service_dir="/data/svc")
    h = svc.submit(result_array, tenant="gold")
    value = h.result(timeout=300)

- **Admission** is weighted fair-share (``service/admission.py``): a
  smooth-weighted-round-robin arbiter picks whose queued request runs
  next, and an AIMD controller (the memory module's, reused verbatim) sizes how many
  run concurrently — RESOURCE failures halve the ceiling, pressure-free
  successes restore it.
- **Durability** is journal-backed (``service/durability.py``): with a
  ``service_dir``, every accepted request is pickled (``runtime/payload.py``)
  and journaled before the submit returns, each request's compute writes a
  compute journal, and
  ``recover()`` (automatic on start) re-enqueues every accepted-but-
  unfinished request after a crash, resuming partial computes from the
  journal ∩ integrity frontier.
- **Caching** (``service/cache.py``): a structural plan cache (identical
  queries skip planning) and a result cache keyed by plan fingerprint +
  input manifest digests (identical queries over unchanged inputs return
  the prior array with zero tasks executed; a mutated input manifest
  invalidates). Identical in-flight requests coalesce onto one execution.
- **Isolation**: per-tenant queues, journals, stats rows
  (:meth:`ComputeService.stats_snapshot`, mirrored into
  ``/snapshot.json`` and ``cubed_tpu_torch.top``), per-tenant telemetry series
  (``tenant_queued``/``tenant_running``/``tenant_completed`` labelled by
  tenant), and tenant-tagged decision-ring entries.

Results are numpy arrays on the host (``RequestHandle.result``): a request
computed on the card leaves its output in the work dir's store, read back
once, so neither the handle nor the result cache pins device memory across
requests. A recovered request's payload restores any tensor it carries
onto the recovering process's chunk device, and fails the request when
that device is not of the tensor's kind.

Known limitation: fault-injection / integrity / memory-guard arming is
process-global, so concurrent requests should share one arming
configuration — build tenant arrays against a uniform Spec.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Dict, Optional

import numpy as np

from ..observability.collect import record_decision
from ..observability.metrics import get_registry
from .admission import DEFAULT_WEIGHT, FairShareArbiter, ServiceAdmission
from .cache import (
    DEFAULT_RESULT_CACHE_BYTES,
    PlanCache,
    ResultCache,
    input_state_digest,
    structural_fingerprint,
)
from .durability import TenantRequestJournal, load_requests, tenant_dirname
from .overload import (
    L2_SHED_LOAD,
    L3_EMERGENCY,
    CostEstimator,
    DeadlineInfeasibleError,
    OverloadController,
    OverloadPolicy,
    ServiceOverloadedError,
    TenantBreaker,
    overload_env_disabled,
)

logger = logging.getLogger(__name__)

#: env overrides (operator wins over Spec(service=...) / constructor args)
SERVICE_DIR_ENV_VAR = "CUBED_TPU_TORCH_SERVICE_DIR"
MAX_CONCURRENT_ENV_VAR = "CUBED_TPU_TORCH_SERVICE_MAX_CONCURRENT"
PLAN_CACHE_ENV_VAR = "CUBED_TPU_TORCH_SERVICE_PLAN_CACHE"
RESULT_CACHE_ENV_VAR = "CUBED_TPU_TORCH_SERVICE_RESULT_CACHE"
MAX_QUEUED_ENV_VAR = "CUBED_TPU_TORCH_SERVICE_MAX_QUEUED"

#: request states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"

#: finished request handles retained for introspection
MAX_RETAINED_REQUESTS = 4096
#: byte bound on the RESULT arrays those retained records pin — the
#: registry must never out-retain the deliberately byte-bounded result
#: cache (a client's own handle keeps its result alive regardless)
MAX_RETAINED_RESULT_BYTES = 512 * 1024 * 1024


class TenantThrottledError(RuntimeError):
    """A tenant exceeded its queued-request bound; the submission was
    rejected (counted in ``tenant_throttled``). Back off and resubmit."""


class RequestCancelledError(RuntimeError):
    """``result()`` was called on a cancelled request."""


class _RequeueRequest(Exception):
    """Internal: a coalesced follower's leader was cancelled — the
    follower must go back through admission (re-entering inline would
    run a full compute without holding an admission slot, since a
    parked follower hands its slot back)."""


def _env_bool(var: str) -> Optional[bool]:
    raw = os.environ.get(var)
    if raw is None:
        return None
    raw = raw.strip().lower()
    if raw == "":
        return None  # empty means unset
    if raw in ("on", "true", "1", "yes"):
        return True
    if raw in ("off", "false", "0", "no"):
        return False
    raise ValueError(
        f"invalid {var}={raw!r}: expected on/off (or true/false, 1/0)"
    )


def _env_int(var: str) -> Optional[int]:
    raw = os.environ.get(var)
    if raw is None or not raw.strip():
        return None
    try:
        value = int(raw.strip())
    except ValueError:
        raise ValueError(f"invalid {var}={raw!r}: expected an integer")
    if value < 1:
        raise ValueError(f"invalid {var}={raw!r}: must be >= 1")
    return value


class ServiceConfig:
    """Resolved service configuration (env > explicit > defaults)."""

    def __init__(
        self,
        tenants: Optional[Dict[str, float]] = None,
        default_weight: float = DEFAULT_WEIGHT,
        max_concurrent: int = 2,
        plan_cache: bool = True,
        result_cache: bool = True,
        result_cache_bytes: int = DEFAULT_RESULT_CACHE_BYTES,
        max_queued_per_tenant: int = 1024,
        service_dir: Optional[str] = None,
        recover: bool = True,
        overload: bool = True,
        overload_policy: Optional[OverloadPolicy] = None,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 10.0,
        slos: Optional[Dict[str, Any]] = None,
    ):
        self.tenants = dict(tenants or {})
        self.default_weight = float(default_weight)
        self.max_concurrent = int(max_concurrent)
        if self.max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self.plan_cache = bool(plan_cache)
        self.result_cache = bool(result_cache)
        self.result_cache_bytes = int(result_cache_bytes)
        self.max_queued_per_tenant = int(max_queued_per_tenant)
        if self.max_queued_per_tenant < 1:
            raise ValueError("max_queued_per_tenant must be >= 1")
        self.service_dir = service_dir
        self.recover = bool(recover)
        #: the overload degradation ladder + per-tenant circuit breakers
        #: (service/overload.py); CUBED_TPU_TORCH_OVERLOAD=off disables both
        self.overload = bool(overload)
        self.overload_policy = overload_policy
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        #: per-tenant SLO specs (tenant -> SloSpec or dict of its
        #: fields): what the SloBoard evaluates burn rates against —
        #: validated eagerly so a typo fails at construction, not at
        #: the first request (observability/slo.py)
        if slos:
            from ..observability.slo import SloSpec

            self.slos: Optional[Dict[str, Any]] = {
                tenant: SloSpec.from_value(tenant, value)
                for tenant, value in slos.items()
            }
        else:
            self.slos = None

    @classmethod
    def resolve(
        cls, spec=None, config: Optional["ServiceConfig"] = None, **overrides,
    ) -> "ServiceConfig":
        """Merge: env vars (operator, win) > explicit config/overrides >
        ``Spec(service=...)`` > defaults."""
        base: dict = {}
        spec_cfg = getattr(spec, "service", None)
        if isinstance(spec_cfg, ServiceConfig):
            base.update(
                tenants=spec_cfg.tenants,
                default_weight=spec_cfg.default_weight,
                max_concurrent=spec_cfg.max_concurrent,
                plan_cache=spec_cfg.plan_cache,
                result_cache=spec_cfg.result_cache,
                result_cache_bytes=spec_cfg.result_cache_bytes,
                max_queued_per_tenant=spec_cfg.max_queued_per_tenant,
                service_dir=spec_cfg.service_dir,
                recover=spec_cfg.recover,
                overload=spec_cfg.overload,
                overload_policy=spec_cfg.overload_policy,
                breaker_threshold=spec_cfg.breaker_threshold,
                breaker_cooldown_s=spec_cfg.breaker_cooldown_s,
                slos=spec_cfg.slos,
            )
        elif isinstance(spec_cfg, dict):
            base.update(spec_cfg)
        if config is not None:
            base.update(
                tenants=config.tenants,
                default_weight=config.default_weight,
                max_concurrent=config.max_concurrent,
                plan_cache=config.plan_cache,
                result_cache=config.result_cache,
                result_cache_bytes=config.result_cache_bytes,
                max_queued_per_tenant=config.max_queued_per_tenant,
                service_dir=config.service_dir,
                recover=config.recover,
                overload=config.overload,
                overload_policy=config.overload_policy,
                breaker_threshold=config.breaker_threshold,
                breaker_cooldown_s=config.breaker_cooldown_s,
                slos=config.slos,
            )
        base.update({k: v for k, v in overrides.items() if v is not None})
        resolved = cls(**base)
        env_dir = os.environ.get(SERVICE_DIR_ENV_VAR)
        if env_dir and env_dir.strip():
            resolved.service_dir = env_dir.strip()
        env_mc = _env_int(MAX_CONCURRENT_ENV_VAR)
        if env_mc is not None:
            resolved.max_concurrent = env_mc
        env_pc = _env_bool(PLAN_CACHE_ENV_VAR)
        if env_pc is not None:
            resolved.plan_cache = env_pc
        env_rc = _env_bool(RESULT_CACHE_ENV_VAR)
        if env_rc is not None:
            resolved.result_cache = env_rc
        env_mq = _env_int(MAX_QUEUED_ENV_VAR)
        if env_mq is not None:
            resolved.max_queued_per_tenant = env_mq
        if overload_env_disabled():
            resolved.overload = False
        return resolved


class RequestHandle:
    """The client's view of one submitted compute."""

    def __init__(self, request: "_Request"):
        self._request = request

    @property
    def request_id(self) -> str:
        return self._request.request_id

    @property
    def tenant(self) -> str:
        return self._request.tenant

    @property
    def plan_cache_hit(self) -> bool:
        return self._request.plan_cache_hit

    @property
    def result_cache_hit(self) -> bool:
        return self._request.result_cache_hit

    @property
    def compute_id(self) -> Optional[str]:
        """The correlated compute id (trace/log/journal joins), once the
        request starts executing."""
        return self._request.compute_id

    @property
    def cost(self) -> Optional[dict]:
        """What this request's execution consumed (task-seconds, store
        bytes R/W, peer bytes, retry draw) — None until it ran, and None
        forever for cache hits/coalesced followers (they cost ~nothing)."""
        cost = self._request.cost
        return dict(cost) if cost is not None else None

    def status(self) -> str:
        return self._request.state

    def done(self) -> bool:
        return self._request.event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The computed array; blocks until the request finishes. Raises
        the compute's own exception on failure and
        :class:`RequestCancelledError` after a cancel."""
        if not self._request.event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished within {timeout}s "
                f"(state: {self._request.state})"
            )
        req = self._request
        if req.state == CANCELLED:
            raise RequestCancelledError(
                f"request {self.request_id} was cancelled"
            )
        if req.error is not None:
            raise req.error
        return req.value

    def cancel(self) -> bool:
        """Cancel the request. A still-QUEUED request completes CANCELLED
        immediately; a RUNNING one has its cancellation token tripped —
        the fleet is told (``compute_cancel`` broadcast), workers abort
        cooperatively at their next chunk boundary, and the request
        completes CANCELLED (sealed durably) within seconds. False only
        for requests that already finished."""
        return self._request.service._cancel(self._request)

    def __repr__(self) -> str:
        return (
            f"RequestHandle({self.request_id}, tenant={self.tenant!r}, "
            f"state={self.status()!r})"
        )


class _Request:
    """Internal request record."""

    __slots__ = (
        "request_id", "tenant", "array", "service", "state", "event",
        "value", "error", "submitted_at", "started_at", "ended_at",
        "plan_cache_hit", "result_cache_hit", "recovered",
        "resume_journal", "durable", "compute_id", "coalesced_into",
        "fingerprint", "canonical", "cost", "deadline_epoch", "token",
        "cancel_requested", "request_class",
    )

    def __init__(self, service: "ComputeService", tenant: str, array,
                 request_id: Optional[str] = None):
        self.request_id = request_id or f"r-{uuid.uuid4().hex[:12]}"
        self.tenant = tenant
        self.array = array
        self.service = service
        self.state = QUEUED
        self.event = threading.Event()
        self.value: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.submitted_at = time.time()
        self.started_at: Optional[float] = None
        self.ended_at: Optional[float] = None
        self.plan_cache_hit = False
        self.result_cache_hit = False
        self.recovered = False
        self.resume_journal: Optional[str] = None
        self.durable = False
        self.compute_id: Optional[str] = None
        self.coalesced_into: Optional[str] = None
        #: fingerprint computed at submit time (durable path), reused by
        #: _execute so the masking-pickle pass runs once per request
        self.fingerprint: Optional[str] = None
        self.canonical: Optional[list] = None
        #: what this request's execution consumed (``_CostTracker``;
        #: None until it runs — cache hits keep it None = zero cost)
        self.cost: Optional[dict] = None
        #: end-to-end deadline (absolute epoch; queue wait counts — the
        #: contract is "an answer by T", not "T seconds of fleet time")
        self.deadline_epoch: Optional[float] = None
        #: the per-request CancellationToken, minted when the request
        #: starts running (RequestHandle.cancel trips it; close() trips
        #: every running one so shutdown is bounded)
        self.token = None
        #: True when the client asked for the cancel (distinguishes a
        #: CANCELLED outcome from a deadline FAILURE in _run_request)
        self.cancel_requested = False
        #: "batch" (default) or "interactive" — the shed ORDER under
        #: overload: L2 rejects new batch submits first, interactive
        #: submits are only refused at L3
        self.request_class = "batch"


class _ComputeIdCallback:
    """Captures the compute id Plan.execute mints for one request, so the
    per-tenant stats row and the handle can join traces/logs/journals."""

    def __init__(self, request: _Request):
        self._request = request

    def on_compute_start(self, event) -> None:
        self._request.compute_id = getattr(event, "compute_id", None)


class _CostTracker:
    """Per-request cost accounting, folded from the compute's own event
    stream (exact per compute even when requests run concurrently — the
    same reason ``_ComputeAggregator``'s per_op numbers are exact):

    - **task_seconds**: summed task-body durations, measured where each
      task ran — the fleet-time the request consumed;
    - **bytes_read / bytes_written**: store IO attributed to its tasks;
    - **peer_bytes**: bytes served worker-to-worker instead of from the
      store (the ``peer_bytes_fetched`` scope counter riding task stats);
    - **retries**: completions that needed attempt > 0 — the request's
      draw on the shared retry budget.

    A result-cache hit or coalesced follower never attaches one of these
    to an execution, so cached answers honestly cost ~zero — exactly the
    incentive the cache exists to create."""

    __slots__ = (
        "task_seconds", "bytes_read", "bytes_written", "peer_bytes",
        "retries", "tasks",
    )

    def __init__(self):
        self.task_seconds = 0.0
        self.bytes_read = 0
        self.bytes_written = 0
        self.peer_bytes = 0
        self.retries = 0
        self.tasks = 0

    def on_task_end(self, event) -> None:
        self.tasks += 1
        start = getattr(event, "function_start_tstamp", None)
        end = getattr(event, "function_end_tstamp", None)
        if start is not None and end is not None:
            self.task_seconds += max(0.0, end - start)
        self.bytes_read += getattr(event, "bytes_read", None) or 0
        self.bytes_written += getattr(event, "bytes_written", None) or 0
        counters = getattr(event, "counters", None) or {}
        self.peer_bytes += counters.get("peer_bytes_fetched", 0) or 0
        if getattr(event, "attempt", 0):
            self.retries += 1

    def as_dict(self) -> dict:
        return {
            "task_seconds": round(self.task_seconds, 6),
            "bytes_read": self.bytes_read,
            "bytes_written": self.bytes_written,
            "peer_bytes": self.peer_bytes,
            "retries": self.retries,
            "tasks": self.tasks,
        }


class _TenantStats:
    __slots__ = (
        "weight", "accepted", "completed", "failed", "cancelled",
        "throttled", "recovered", "plan_cache_hits", "result_cache_hits",
        "coalesced", "cost_task_seconds", "cost_bytes_read",
        "cost_bytes_written", "cost_peer_bytes", "cost_retries",
        "cost_tasks", "shed",
    )

    def __init__(self, weight: float):
        self.weight = weight
        self.accepted = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        self.throttled = 0
        self.recovered = 0
        self.plan_cache_hits = 0
        self.result_cache_hits = 0
        self.coalesced = 0
        #: cumulative cost accounting (``_CostTracker``): what this
        #: tenant's executed requests actually consumed — failed requests
        #: included, because their fleet time was spent either way
        self.cost_task_seconds = 0.0
        self.cost_bytes_read = 0
        self.cost_bytes_written = 0
        self.cost_peer_bytes = 0
        self.cost_retries = 0
        self.cost_tasks = 0
        #: submissions rejected by the overload ladder / breaker
        self.shed = 0


class ComputeService:
    """A persistent front door multiplexing many tenants onto one fleet."""

    def __init__(
        self,
        executor=None,
        spec=None,
        config: Optional[ServiceConfig] = None,
        tenants: Optional[Dict[str, float]] = None,
        service_dir: Optional[str] = None,
        max_concurrent: Optional[int] = None,
        **config_overrides,
    ):
        self.config = ServiceConfig.resolve(
            spec=spec, config=config, tenants=tenants,
            service_dir=service_dir, max_concurrent=max_concurrent,
            **config_overrides,
        )
        if executor is None and spec is not None:
            executor = spec.executor
        if executor is None:
            from ..runtime.executors.python_async import (
                AsyncPythonDagExecutor,
            )

            executor = AsyncPythonDagExecutor()
        self.executor = executor
        if (
            self.config.service_dir
            and getattr(executor, "control_dir", "absent") is None
        ):
            # arm live coordinator failover for distributed executors that
            # weren't given an explicit control dir: a service restart then
            # ADOPTS a still-running fleet (next epoch, rendezvous file)
            # instead of cold-starting it, and offline request recovery
            # only covers what the takeover couldn't
            from .durability import service_control_dir

            executor.control_dir = service_control_dir(
                self.config.service_dir
            )
        self.spec = spec
        self.arbiter = FairShareArbiter(
            self.config.tenants, self.config.default_weight
        )
        self.admission = ServiceAdmission(self.config.max_concurrent)
        self.plan_cache = PlanCache() if self.config.plan_cache else None
        self.result_cache = (
            ResultCache(self.config.result_cache_bytes)
            if self.config.result_cache else None
        )

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: Dict[str, deque] = {}
        self._tenant_stats: Dict[str, _TenantStats] = {}
        for t, w in self.config.tenants.items():
            self._tenant_stats[t] = _TenantStats(w)
        self._requests: "OrderedDict[str, _Request]" = OrderedDict()
        self._running: Dict[str, _Request] = {}
        #: per-tenant submissions between bound-check and enqueue, so the
        #: backlog bound holds exactly under concurrent submits
        self._reserved: Dict[str, int] = {}
        #: (fingerprint, input_digest) -> leader request (coalescing;
        #: followers synchronize on the leader's event directly)
        self._inflight: Dict[tuple, _Request] = {}
        #: output-store-path -> execution lock (see _exec_lock_for)
        self._exec_locks: "OrderedDict[str, threading.Lock]" = OrderedDict()
        #: result bytes currently pinned by finished records in _requests
        self._retained_bytes = 0
        self._journals: Dict[str, TenantRequestJournal] = {}
        self._dispatcher: Optional[threading.Thread] = None
        self._threads: list = []
        self._closed = threading.Event()
        self._started = False
        #: the overload degradation ladder (None = disabled: config or
        #: CUBED_TPU_TORCH_OVERLOAD=off) + the pieces it admits through —
        #: per-tenant circuit breakers and the feasibility cost model
        self.overload: Optional[OverloadController] = (
            OverloadController(self.config.overload_policy)
            if self.config.overload else None
        )
        self.estimator = CostEstimator()
        self._breakers: Dict[str, TenantBreaker] = {}
        #: per-tenant SLO board (None when no SLOs are configured via
        #: config/Spec or CUBED_TPU_TORCH_SERVICE_SLOS); seeded from the run
        #: archive on start() so error budgets survive restarts
        from ..observability.slo import SloBoard

        self.slo_board = SloBoard.resolve(self.config.slos)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ComputeService":
        """Start the dispatcher (idempotent) and, when a service_dir is
        armed, recover every accepted-but-unfinished request."""
        with self._lock:
            if self._started:
                return self
            self._started = True
        if self.config.service_dir and self.config.recover:
            try:
                self.recover()
            except Exception:
                # recovery is additive: a corrupt journal degrades to
                # re-submission, it must not keep the service down
                logger.exception("service recovery failed; starting empty")
        if self.slo_board is not None and self.config.service_dir:
            # durable error budgets: re-fold every archived request
            # outcome so a restart (or SIGKILL) resumes the compliance
            # window where it left off instead of resetting burned
            # budget to zero. An interrupted request never wrote a
            # completion record, so it is neither counted here nor
            # double-counted when recovery re-runs it.
            try:
                from ..observability.runhistory import load_runs

                records, bad = load_runs(self.config.service_dir)
                folded = self.slo_board.fold(records)
                record_decision(
                    "slo_budget_folded", folded=folded, bad_lines=bad,
                    service_dir=self.config.service_dir,
                )
            except Exception:
                logger.exception(
                    "SLO archive fold failed; budgets start empty"
                )
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="service-dispatch", daemon=True,
        )
        self._dispatcher.start()
        from ..observability.timeseries import register_service

        register_service(self)
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Stop admitting; wait for running computes; seal the journals.

        Shutdown is BOUNDED: a running compute gets the timeout window to
        finish, after which its cancellation token is tripped (reaching
        fleet workers via the ``compute_cancel`` broadcast) — a wedged or
        browned-out compute can no longer block close() forever. Queued
        requests complete their handles as CANCELLED so no client blocks
        forever in ``result()`` — durable ones keep their accepted
        journal record (NOT sealed), so a restarted service on the same
        ``service_dir`` still recovers and runs them; a RUNNING request
        cancelled by shutdown keeps its record unsealed the same way."""
        self._closed.set()
        with self._work:
            self._work.notify_all()
        d = self._dispatcher
        if d is not None:
            d.join(timeout=5.0)
        deadline = time.monotonic() + timeout
        for t in list(self._threads):
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        lingering = [t for t in self._threads if t.is_alive()]
        if lingering:
            # the timeout is spent and computes still run: route shutdown
            # through the cancellation tokens so it stays bounded
            with self._lock:
                running = list(self._running.values())
            for r in running:
                token = r.token
                if token is not None:
                    token.cancel("service shutdown")
            # ONE shared grace window for the whole pass (like the first
            # join loop): N wedged computes must not serialize into
            # N x 15s of shutdown
            grace = time.monotonic() + 15.0
            for t in lingering:
                t.join(timeout=max(0.1, grace - time.monotonic()))
        stranded = []
        with self._work:
            for q in self._queues.values():
                stranded.extend(q)
                q.clear()
        for req in stranded:
            # seal=False: a durable queued request's accepted record must
            # survive the close so recovery re-runs it
            self._finish(req, CANCELLED, seal=False)
        from ..observability.timeseries import unregister_service

        unregister_service(self)
        if self.overload is not None:
            self.overload.close()
        for j in self._journals.values():
            j.close()

    def __enter__(self) -> "ComputeService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    # -- submission ----------------------------------------------------

    def submit(
        self, array, tenant: str = "default",
        deadline_s: Optional[float] = None,
        request_class: str = "batch",
    ) -> RequestHandle:
        """Accept one compute for ``tenant``; returns immediately.

        Durable when a service_dir is armed (payload + fsync'd accepted
        record before return). Raises :class:`TenantThrottledError` past
        the tenant's queued-request bound, and
        :class:`ServiceOverloadedError` (with a ``retry_after_s`` hint)
        when the overload ladder or the tenant's circuit breaker is
        shedding — at L2 only ``request_class="batch"`` submits are
        refused (interactive still lands); at L3 every submit is.

        ``deadline_s`` is an END-TO-END deadline from this submission
        (queue wait included): past it the request fails with
        ``ComputeDeadlineExceededError`` — queued requests fail at
        admission, running computes abort cooperatively (fleet workers
        included) within about a task of the deadline."""
        if self._closed.is_set():
            raise RuntimeError("service is closed")
        if request_class not in ("batch", "interactive"):
            raise ValueError(
                "request_class must be 'batch' or 'interactive', got "
                f"{request_class!r}"
            )
        if not self._started:
            self.start()
        tenant = str(tenant)
        reg = get_registry()
        probe_breaker = None
        if self.overload is not None:
            with self._lock:
                depth = sum(len(q) for q in self._queues.values())
            level = self.overload.tick(depth)
            if level >= L3_EMERGENCY or (
                level >= L2_SHED_LOAD and request_class == "batch"
            ):
                retry = self.overload.retry_after_s(depth)
                self._note_shed(
                    tenant, reason="overload_level", level=level,
                    request_class=request_class,
                    retry_after_s=round(retry, 3),
                )
                raise ServiceOverloadedError(
                    f"service is shedding load (overload L{level} "
                    f"{self.overload.snapshot()['name']!r}): "
                    f"{request_class} submit for tenant {tenant!r} "
                    f"rejected; retry after {retry:.1f}s",
                    retry_after_s=retry,
                )
            breaker = self._breaker(tenant)
            retry = breaker.check()
            if retry is not None:
                self._note_shed(
                    tenant, reason="breaker_open",
                    strikes=breaker.strikes,
                    retry_after_s=round(retry, 3),
                )
                raise ServiceOverloadedError(
                    f"tenant {tenant!r} circuit breaker is open "
                    f"({breaker.strikes} consecutive failures); retry "
                    f"after {retry:.1f}s",
                    retry_after_s=retry,
                )
            if breaker.state == TenantBreaker.HALF_OPEN:
                # this submit holds the single half-open probe slot: a
                # rejection below (throttle bound, journal error) must
                # hand the slot back, or no probe ever resolves the
                # breaker
                probe_breaker = breaker
        with self._lock:
            stats = self._ensure_tenant_locked(tenant)
            q = self._queues.setdefault(tenant, deque())
            # the bound covers queued requests PLUS submissions between
            # their bound check and their enqueue (the durable write below
            # happens outside the lock): a reservation makes the bound
            # exact under concurrent submits, not just approximate
            reserved = self._reserved.get(tenant, 0)
            if len(q) + reserved >= self.config.max_queued_per_tenant:
                stats.throttled += 1
                reg.counter("tenant_throttled").inc()
                record_decision(
                    "service_throttled", tenant=tenant,
                    queued=len(q) + reserved,
                    bound=self.config.max_queued_per_tenant,
                )
                if probe_breaker is not None:
                    probe_breaker.abort_probe()
                raise TenantThrottledError(
                    f"tenant {tenant!r} has {len(q) + reserved} queued "
                    f"request(s) (bound {self.config.max_queued_per_tenant})"
                    "; backlog must drain before new submissions are "
                    "accepted"
                )
            self._reserved[tenant] = reserved + 1
        req = _Request(self, tenant, array)
        req.request_class = request_class
        if deadline_s is not None:
            req.deadline_epoch = time.time() + float(deadline_s)
        enqueue = True
        try:
            if self.plan_cache is not None or self.result_cache is not None:
                # computed once here, reused by _execute (the durable
                # record, the caches, and the overload feasibility gate
                # all key on the same fingerprint); with both caches off
                # it is journal metadata only — not worth a
                # masking-pickle pass per submit
                req.fingerprint, req.canonical = structural_fingerprint(
                    array.plan.dag
                )
            if self.config.service_dir:
                journal = self._tenant_journal(tenant)
                req.durable = journal.record_accepted(
                    req.request_id, array, fingerprint=req.fingerprint,
                    deadline_epoch=req.deadline_epoch,
                )
        except BaseException:
            enqueue = False  # never hand the queue a request the caller
            if probe_breaker is not None:  # believes was rejected
                probe_breaker.abort_probe()
            raise
        finally:
            with self._work:
                self._reserved[tenant] -= 1
                if enqueue:
                    stats = self._ensure_tenant_locked(tenant)
                    stats.accepted += 1
                    self._queues.setdefault(tenant, deque()).append(req)
                    self._remember_locked(req)
                    self._work.notify_all()
        reg.counter("service_requests_accepted").inc()
        record_decision(
            "service_accept", tenant=tenant, request=req.request_id,
            durable=req.durable,
        )
        return RequestHandle(req)

    def handle(self, request_id: str) -> Optional[RequestHandle]:
        with self._lock:
            req = self._requests.get(request_id)
        return RequestHandle(req) if req is not None else None

    def recover(self) -> int:
        """Re-enqueue every accepted-but-unfinished durable request (in
        acceptance order, preserving request ids); returns the count."""
        from ..runtime import payload as payload_codec

        recovered = 0
        pending = load_requests(self.config.service_dir)
        reg = get_registry()
        for tenant, records in pending.items():
            journal = self._tenant_journal(tenant)
            if self.overload is not None:
                # re-arm the tenant's durable breaker NOW: a breaker that
                # was open at the crash must reject this tenant's next
                # submit, not wait for its first post-restart failure
                self._breaker(tenant)
            for rec in records:
                rid = rec["request_id"]
                if rec["payload_path"] is None:
                    # accepted but its payload never made it / was lost:
                    # seal it failed so it can't linger forever
                    journal.record_done(
                        rid, FAILED, error="payload unrecoverable"
                    )
                    continue
                try:
                    with open(rec["payload_path"], "rb") as f:
                        array = payload_codec.loads(f.read())
                except Exception as e:
                    logger.warning(
                        "request %s (tenant %s): payload failed to load "
                        "(%s); sealing failed", rid, tenant, e,
                    )
                    journal.record_done(rid, FAILED, error=f"payload: {e}")
                    continue
                req = _Request(self, tenant, array, request_id=rid)
                req.durable = True
                req.recovered = True
                # the end-to-end SLO survives recovery: the ABSOLUTE
                # deadline is restored, so a request whose deadline
                # passed during the outage fails at admission with the
                # typed error instead of running unbounded
                req.deadline_epoch = rec.get("deadline_epoch")
                # the fingerprint too: the overload feasibility gate keys
                # the plan-cache task count on it, so a recovered request
                # sheds with the same typed rejection a live one would
                req.fingerprint = rec.get("fingerprint")
                req.resume_journal = rec["compute_journal"]
                with self._work:
                    stats = self._ensure_tenant_locked(tenant)
                    stats.accepted += 1
                    stats.recovered += 1
                    self._queues.setdefault(tenant, deque()).append(req)
                    self._remember_locked(req)
                    self._work.notify_all()
                reg.counter("service_requests_recovered").inc()
                record_decision(
                    "service_recovered", tenant=tenant, request=rid,
                    resume=bool(req.resume_journal),
                )
                recovered += 1
        if recovered:
            logger.info(
                "service recovery: re-enqueued %d accepted request(s) "
                "from %s", recovered, self.config.service_dir,
            )
        return recovered

    # -- dispatch ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._closed.is_set():
            req = None
            try:
                if self.overload is not None:
                    # the ladder's policy loop rides the dispatch loop:
                    # the controller self-limits to its tick interval, so
                    # this is ~4 signal reads a second, not 5 a wait-cycle
                    with self._lock:
                        depth = sum(
                            len(q) for q in self._queues.values()
                        )
                    self.overload.tick(depth)
                with self._work:
                    req = self._next_admissible_locked()
                    if req is None:
                        self._work.wait(timeout=0.2)
                        continue
                    req.state = RUNNING
                    req.started_at = time.time()
                    self._running[req.request_id] = req
                    self._threads = [
                        t for t in self._threads if t.is_alive()
                    ]
                record_decision(
                    "service_admit", tenant=req.tenant,
                    request=req.request_id,
                )
                t = threading.Thread(
                    target=self._run_request, args=(req,),
                    name=f"service-run-{req.request_id}", daemon=True,
                )
                with self._lock:
                    self._threads.append(t)
                t.start()
            except Exception as e:  # the dispatcher must never die
                logger.exception("service dispatch failed")
                if req is not None:
                    # never strand an admitted request in RUNNING with no
                    # thread behind it: fail it visibly
                    with self._work:
                        self._running.pop(req.request_id, None)
                        self._ensure_tenant_locked(req.tenant).failed += 1
                        self._work.notify_all()
                    get_registry().counter("service_requests_failed").inc()
                    self._finish(req, FAILED, error=e)
                time.sleep(0.2)  # thread/fd exhaustion: don't spin

    def _next_admissible_locked(self) -> Optional[_Request]:
        if not self.admission.has_slot(len(self._running)):
            return None
        backlog = {t: len(q) for t, q in self._queues.items() if q}
        tenant = self.arbiter.pick(backlog)
        if tenant is None:
            return None
        return self._queues[tenant].popleft()

    # -- execution -----------------------------------------------------

    def _run_request(self, req: _Request) -> None:
        from ..runtime.cancellation import (
            CancellationToken,
            ComputeCancelledError,
            ComputeDeadlineExceededError,
        )

        reg = get_registry()
        # the request's time bound becomes a real CancellationToken the
        # moment it runs: Plan.execute threads it through the dispatch
        # loop, the fleet wire, and the chunk-IO checks — so cancel()
        # reaches RUNNING computes and the deadline is enforced end to end
        # compute_id left unset: Plan.execute registers the token under
        # the compute id it mints, which is the id the fleet wire and the
        # worker-side lookups key on
        req.token = CancellationToken(deadline_epoch=req.deadline_epoch)
        if req.cancel_requested:
            req.token.cancel("client cancel")
        try:
            req.token.check()  # expired while queued: fail at admission
            self._check_feasible(req)
            value = self._execute(req)
        except _RequeueRequest:
            # a coalesced follower whose leader was cancelled: back onto
            # the tenant queue for a fresh admission slot (the handle
            # stays live — nothing is finished here)
            with self._work:
                if not self._closed.is_set():
                    req.state = QUEUED
                    req.started_at = None
                    self._queues.setdefault(req.tenant, deque()).append(req)
                    self._work.notify_all()
                    requeued = True
                else:
                    requeued = False
            if not requeued:
                # shutdown raced the requeue: complete the handle so no
                # client blocks forever; durable records stay unsealed
                with self._lock:
                    self._ensure_tenant_locked(req.tenant).cancelled += 1
                self._finish(req, CANCELLED, seal=False)
            return
        except ComputeCancelledError as e:
            if isinstance(e, ComputeDeadlineExceededError) and not (
                req.cancel_requested
            ):
                # the SLO fired, the client didn't ask: that is a FAILED
                # request carrying the typed error (result() raises it)
                with self._lock:
                    self._ensure_tenant_locked(req.tenant).failed += 1
                reg.counter("service_requests_failed").inc()
                record_decision(
                    "service_request_failed", tenant=req.tenant,
                    request=req.request_id, error=type(e).__name__,
                )
                self._note_outcome(req, ok=False, deadline_missed=True)
                self._finish(req, FAILED, error=e)
            else:
                # a client cancel (or shutdown) that reached a RUNNING
                # compute: CANCELLED, sealed durably so recovery never
                # resurrects it
                with self._lock:
                    self._ensure_tenant_locked(req.tenant).cancelled += 1
                reg.counter("service_requests_cancelled").inc()
                record_decision(
                    "service_cancelled", tenant=req.tenant,
                    request=req.request_id, running=True,
                )
                # a CLIENT cancel is sealed durably (recovery must not
                # resurrect it); a shutdown cancel leaves the durable
                # accepted record unsealed so the next service on this
                # service_dir recovers and finishes the work — resuming
                # from the journal ∩ integrity frontier, so everything
                # completed before the abort is kept
                self._finish(req, CANCELLED, seal=req.cancel_requested)
        except BaseException as e:  # noqa: BLE001 — reported to the handle
            with self._lock:
                self._ensure_tenant_locked(req.tenant).failed += 1
            reg.counter("service_requests_failed").inc()
            if self._is_resource_failure(e) and req.coalesced_into is None:
                # a compute died of memory pressure: halve the number of
                # concurrent computes before admitting the next one. Only
                # the LEADER steps down — its followers re-raise the same
                # error, and N+1 halvings for one pressure event would
                # collapse the ceiling to 1
                self.admission.on_resource_failure(len(self._running))
            record_decision(
                "service_request_failed", tenant=req.tenant,
                request=req.request_id, error=type(e).__name__,
            )
            if not isinstance(e, ServiceOverloadedError):
                # a shed is the SERVICE's decision, not evidence about
                # the tenant's workload: it must not feed the breaker or
                # the miss window, or shedding would self-amplify
                self._note_outcome(req, ok=False)
            self._finish(req, FAILED, error=e)
        else:
            with self._lock:
                stats = self._ensure_tenant_locked(req.tenant)
                stats.completed += 1
                if req.plan_cache_hit:
                    stats.plan_cache_hits += 1
                if req.result_cache_hit:
                    stats.result_cache_hits += 1
            reg.counter("service_requests_completed").inc()
            self._note_outcome(req, ok=True)
            if not req.result_cache_hit:
                # only a request that actually EXECUTED is evidence the
                # fleet can take more load: cache hits and coalesced
                # followers never touched it, and letting them advance
                # the AIMD restore streak would re-trigger the pressure
                # the step-down just relieved
                self.admission.on_success()
            self._finish(req, DONE, value=value)
        finally:
            with self._work:
                self._running.pop(req.request_id, None)
                self._work.notify_all()

    def _execute(self, req: _Request):
        from ..core.plan import arrays_to_plan

        plan = arrays_to_plan(req.array)
        use_caches = not req.recovered  # a resumed plan must re-finalize
        fp = canonical = None
        if use_caches and (
            self.plan_cache is not None or self.result_cache is not None
        ):
            if req.fingerprint is not None:
                # already computed on the submit path (durable requests)
                fp, canonical = req.fingerprint, req.canonical
            else:
                fp, canonical = structural_fingerprint(plan.dag)
        input_digest = None
        if use_caches and self.result_cache is not None and fp is not None:
            input_digest = input_state_digest(plan.dag)
            if input_digest is None:
                # an undigestable input (remote store, vanished dir):
                # neither cache may serve — and sharing a plan-cache
                # FinalizedPlan would let two concurrent identical
                # requests race on the same store paths with no
                # coalescing gate in front, so skip caching entirely
                fp = canonical = None
        if fp is not None and input_digest is not None:
            cached = self.result_cache.lookup(fp, input_digest)
            if cached is not None:
                req.result_cache_hit = True
                record_decision(
                    "service_cache_hit", tenant=req.tenant,
                    request=req.request_id, cache="result",
                )
                return cached
        if input_digest is not None:
            # coalesce onto an identical in-flight request: one execution
            # serves every waiter (and fills the cache for the rest). Only
            # with a known input digest — an undigestable input (remote
            # store) must force a fresh run, never share a possibly-stale
            # leader result
            leader = None
            key = (fp, input_digest)
            with self._lock:
                leader = self._inflight.get(key)
                if leader is None:
                    self._inflight[key] = req
            if leader is not None:
                req.coalesced_into = leader.request_id
                get_registry().counter("service_requests_coalesced").inc()
                with self._work:
                    self._ensure_tenant_locked(req.tenant).coalesced += 1
                    # a parked follower does no work: hand its admission
                    # slot back so other tenants' requests can run while
                    # it waits on the leader
                    self._running.pop(req.request_id, None)
                    self._work.notify_all()
                # a parked follower is still cancellable (and still has a
                # deadline): poll its own token while waiting — the
                # leader's execution is untouched either way
                while not leader.event.wait(timeout=0.2):
                    if req.token is not None:
                        req.token.check()
                if leader.error is not None:
                    from ..runtime.cancellation import (
                        ComputeCancelledError as _Cancelled,
                    )

                    if isinstance(leader.error, _Cancelled) and not (
                        self._closed.is_set()
                    ):
                        # the leader's own deadline/cancel is the
                        # LEADER's time bound, not this follower's:
                        # go back through admission and run under our
                        # own token (unless the service is shutting
                        # down — then the cancel is ours too)
                        req.coalesced_into = None
                        raise _RequeueRequest()
                    raise leader.error
                if leader.state != DONE:
                    if self._closed.is_set() and req.token is not None:
                        req.token.cancel("service shutdown")
                        req.token.check()
                    # the LEADER was cancelled (its CANCELLED completion
                    # carries no error and no value): this follower never
                    # asked to be cancelled, so it must not inherit the
                    # abort — and certainly not the leader's None value.
                    # Back through admission (the parked follower handed
                    # its slot away; re-entering inline would exceed the
                    # service's concurrency bound)
                    req.coalesced_into = None
                    raise _RequeueRequest()
                req.result_cache_hit = True
                return np.array(leader.value, copy=True)
        try:
            value = self._execute_plan(req, plan, fp, canonical)
            if (
                use_caches and self.result_cache is not None
                and fp is not None and input_digest is not None
            ):
                self.result_cache.put(
                    fp, input_digest, value, compute_id=req.compute_id
                )
            return value
        finally:
            if input_digest is not None:
                with self._lock:
                    if self._inflight.get((fp, input_digest)) is req:
                        del self._inflight[(fp, input_digest)]

    def _execute_plan(self, req: _Request, plan, fp, canonical):
        target_name = req.array.name
        finalized = None
        if self.plan_cache is not None and fp is not None:
            entry = self.plan_cache.get(fp)
            if entry is not None and req.array.name in (canonical or ()):
                # map this build's output name onto the cached build's
                # node at the same canonical position
                try:
                    idx = canonical.index(req.array.name)
                    target_name = entry.canonical[idx]
                    finalized = entry.finalized
                    req.plan_cache_hit = True
                    record_decision(
                        "service_cache_hit", tenant=req.tenant,
                        request=req.request_id, cache="plan",
                    )
                except (ValueError, IndexError):
                    finalized = None
                    target_name = req.array.name
        if finalized is None:
            finalized = plan._finalize(
                optimize_graph=True, array_names=(req.array.name,)
            )
            if self.plan_cache is not None and fp is not None:
                self.plan_cache.put(fp, finalized, canonical)
        # a finalized plan's lazy targets are concrete store paths, baked
        # at build time — shared by every plan-cache hit AND by any
        # resubmission of the same array object. Two computes writing
        # them concurrently (possible whenever the coalescing gate didn't
        # catch the pair: result cache off, undigestable input, or an
        # input mutated while the first still runs) could interleave
        # DIFFERENT data into one store. Executions are serialized per
        # OUTPUT store path; distinct plans are unaffected
        with self._exec_lock_for(finalized, target_name):
            return self._run_plan(req, plan, finalized, target_name)

    #: distinct output paths whose exec locks are retained (LRU): an
    #: evicted lock only matters if that plan runs again concurrently
    #: 1024 distinct plans later — effectively never
    MAX_EXEC_LOCKS = 1024

    def _exec_lock_for(self, finalized, target_name) -> threading.Lock:
        target = finalized.dag.nodes[target_name].get("target")
        key = str(getattr(target, "store", None) or target_name)
        with self._lock:
            lock = self._exec_locks.get(key)
            if lock is None:
                lock = threading.Lock()
                self._exec_locks[key] = lock
                while len(self._exec_locks) > self.MAX_EXEC_LOCKS:
                    self._exec_locks.popitem(last=False)
            else:
                self._exec_locks.move_to_end(key)
            return lock

    def _run_plan(self, req: _Request, plan, finalized, target_name):
        from ..storage.zarr import open_if_lazy_zarr_array

        cost = _CostTracker()
        callbacks = [_ComputeIdCallback(req), cost]
        kwargs: dict = {}
        if req.durable and self.config.service_dir:
            from ..runtime.journal import JournalCallback

            journal = self._tenant_journal(req.tenant)
            callbacks.append(
                JournalCallback(
                    journal.compute_journal_path(req.request_id)
                )
            )
        if req.resume_journal:
            kwargs["resume_from_journal"] = req.resume_journal
        elif req.recovered:
            # accepted before the crash but never journaled a task:
            # integrity-verified chunks (if any) still skip
            kwargs["resume"] = True
        if req.token is not None:
            kwargs["cancellation"] = req.token
        t0 = time.monotonic()
        try:
            plan.execute(
                executor=self.executor,
                callbacks=callbacks,
                array_names=(target_name,),
                spec=getattr(req.array, "spec", None) or self.spec,
                finalized=finalized,
                **kwargs,
            )
        finally:
            # a FAILED compute still spent the fleet's time: fold the cost
            # either way, so per-tenant accounting reflects consumption,
            # not just successful consumption
            self._fold_cost(req, cost)
        # only a SUCCESSFUL run teaches the feasibility model (a failed
        # or aborted one under-counts its tasks, and a poisoned tenant
        # polluting its own rate would distort the global fallback)
        self.estimator.observe(
            req.tenant, cost.tasks, time.monotonic() - t0
        )
        target = finalized.dag.nodes[target_name]["target"]
        arr = open_if_lazy_zarr_array(target)
        out = arr[...] if getattr(arr, "shape", ()) else arr[()]
        return np.asarray(out)

    def _fold_cost(self, req: _Request, cost: _CostTracker) -> None:
        req.cost = cost.as_dict()
        with self._lock:
            stats = self._ensure_tenant_locked(req.tenant)
            stats.cost_task_seconds += cost.task_seconds
            stats.cost_bytes_read += cost.bytes_read
            stats.cost_bytes_written += cost.bytes_written
            stats.cost_peer_bytes += cost.peer_bytes
            stats.cost_retries += cost.retries
            stats.cost_tasks += cost.tasks

    # -- completion / cancel -------------------------------------------

    def _finish(
        self, req: _Request, state: str,
        value: Optional[np.ndarray] = None,
        error: Optional[BaseException] = None,
        seal: bool = True,
    ) -> None:
        req.value = value
        req.error = error
        req.state = state
        req.ended_at = time.time()
        if value is not None:
            with self._lock:
                self._retained_bytes += int(getattr(value, "nbytes", 0))
                self._trim_retained_locked()
        if seal and req.durable and self.config.service_dir:
            try:
                self._tenant_journal(req.tenant).record_done(
                    req.request_id,
                    "completed" if state == DONE else state,
                    error=(
                        f"{type(error).__name__}: {error}"
                        if error is not None else None
                    ),
                    # structured fields so a typed rejection (and its
                    # retry-after hint) survives the journal round trip
                    error_type=(
                        type(error).__name__ if error is not None else None
                    ),
                    retry_after_s=getattr(error, "retry_after_s", None),
                )
            except Exception:
                logger.exception(
                    "failed to seal request %s", req.request_id
                )
        self._record_run(req, state)
        req.event.set()

    def _cancel(self, req: _Request) -> bool:
        with self._work:
            if req.event.is_set():
                return False  # already finished: nothing to cancel
            q = self._queues.get(req.tenant)
            if req.state == QUEUED and q is not None and req in q:
                q.remove(req)
                self._ensure_tenant_locked(req.tenant).cancelled += 1
                queued = True
            else:
                # RUNNING (or racing dispatch): trip the token — the
                # compute aborts cooperatively (dispatch loop + fleet
                # broadcast + worker chunk-IO checks) and _run_request
                # completes the handle CANCELLED, sealing it durably
                req.cancel_requested = True
                token = req.token
                queued = False
        if queued:
            get_registry().counter("service_requests_cancelled").inc()
            record_decision(
                "service_cancelled", tenant=req.tenant,
                request=req.request_id,
            )
            self._finish(req, CANCELLED)
            return True
        if token is not None:
            token.cancel("client cancel")
        return True

    # -- helpers -------------------------------------------------------

    def _ensure_tenant_locked(self, tenant: str) -> _TenantStats:
        stats = self._tenant_stats.get(tenant)
        if stats is None:
            stats = _TenantStats(self.arbiter.weight(tenant))
            self._tenant_stats[tenant] = stats
        return stats

    def _remember_locked(self, req: _Request) -> None:
        self._requests[req.request_id] = req
        self._trim_retained_locked()

    def _trim_retained_locked(self) -> None:
        """Evict FINISHED request records beyond the count/byte bounds,
        oldest first, skipping live ones (a live request's handle must
        survive until it completes). Eviction only drops the registry's
        reference — a client still holding the handle keeps its result."""
        over_count = len(self._requests) - MAX_RETAINED_REQUESTS
        over_bytes = self._retained_bytes - MAX_RETAINED_RESULT_BYTES
        if over_count <= 0 and over_bytes <= 0:
            return
        for rid in list(self._requests):
            if over_count <= 0 and over_bytes <= 0:
                break
            r = self._requests[rid]
            if not r.event.is_set():
                continue
            del self._requests[rid]
            over_count -= 1
            if r.value is not None:
                nbytes = int(getattr(r.value, "nbytes", 0))
                self._retained_bytes -= nbytes
                over_bytes -= nbytes

    def _tenant_journal(self, tenant: str) -> TenantRequestJournal:
        with self._lock:
            j = self._journals.get(tenant)
            if j is None:
                j = TenantRequestJournal(self.config.service_dir, tenant)
                self._journals[tenant] = j
            return j

    # -- overload / breakers -------------------------------------------

    def _breaker(self, tenant: str) -> TenantBreaker:
        """The tenant's circuit breaker (created on first use; durable
        beside the tenant's request journal when a service_dir is armed,
        so a tripped breaker survives a service SIGKILL)."""
        with self._lock:
            b = self._breakers.get(tenant)
            if b is None:
                state_path = None
                if self.config.service_dir:
                    d = os.path.join(
                        self.config.service_dir, tenant_dirname(tenant)
                    )
                    try:
                        os.makedirs(d, exist_ok=True)
                        state_path = os.path.join(d, "breaker.json")
                    except OSError:
                        pass  # volatile breaker beats no breaker
                b = TenantBreaker(
                    tenant,
                    threshold=self.config.breaker_threshold,
                    cooldown_s=self.config.breaker_cooldown_s,
                    state_path=state_path,
                )
                self._breakers[tenant] = b
            return b

    def _note_shed(self, tenant: str, reason: str, **extra) -> None:
        with self._lock:
            self._ensure_tenant_locked(tenant).shed += 1
        get_registry().counter("requests_shed").inc()
        record_decision(
            "request_shed", tenant=tenant, reason=reason, **extra
        )
        if self.config.service_dir and "request" not in extra:
            # admission-time sheds never reach _finish (the submit
            # raised before a request existed) — archive them here so
            # the run history shows the whole shed story. A shed that
            # DOES carry a request id (the feasibility gate) finishes
            # through _record_run, which writes its record.
            # SLO-ineligible either way (see _record_run).
            try:
                from ..observability.runhistory import record_request

                record_request(
                    self.config.service_dir,
                    request_id=f"shed-{reason}",
                    tenant=tenant,
                    status="shed",
                    error=reason,
                    shed=True,
                )
            except Exception:
                logger.exception("shed archive record failed")

    def _record_run(self, req: _Request, state: str) -> None:
        """One completion's SLI event + durable archive record.

        Runs on every ``_finish`` path. Outcome classification: DONE ->
        ``completed``; FAILED with a shed-typed error (the overload
        ladder / breaker / feasibility gate declined) -> ``shed``; other
        FAILED -> ``failed``; CANCELLED -> ``cancelled``. Only
        completed/failed are SLI-eligible — a shed is the service's
        decision and a cancel is the client's, neither is evidence about
        the tenant's promise (both still land in the archive for the
        record). Never raises: observability must not fail the request
        path."""
        try:
            from ..runtime.cancellation import ComputeDeadlineExceededError

            if state == DONE:
                status = "completed"
            elif state == CANCELLED:
                status = "cancelled"
            elif isinstance(req.error, ServiceOverloadedError):
                status = "shed"
            else:
                status = "failed"
            deadline_missed = isinstance(
                req.error, ComputeDeadlineExceededError
            ) and not req.cancel_requested
            latency = None
            if req.ended_at is not None:
                latency = max(0.0, req.ended_at - req.submitted_at)
            if self.config.service_dir:
                from ..observability.runhistory import record_request

                record_request(
                    self.config.service_dir,
                    request_id=req.request_id,
                    tenant=req.tenant,
                    status=status,
                    latency_s=latency,
                    fingerprint=req.fingerprint,
                    compute_id=req.compute_id,
                    error=(
                        type(req.error).__name__
                        if req.error is not None else None
                    ),
                    deadline_missed=deadline_missed,
                    shed=status == "shed",
                    request_class=req.request_class,
                )
            if self.slo_board is not None and status in (
                "completed", "failed",
            ):
                self.slo_board.record(
                    req.tenant, ok=status == "completed",
                    latency_s=latency, ts=req.ended_at,
                )
        except Exception:
            logger.exception(
                "run record failed for request %s", req.request_id
            )

    def _note_outcome(
        self, req: _Request, ok: bool, deadline_missed: bool = False,
    ) -> None:
        """Feed one request outcome to the overload signals: the
        deadline-miss window and the tenant's breaker."""
        if self.overload is None:
            return
        self.overload.note_completion(deadline_missed)
        breaker = self._breaker(req.tenant)
        if ok:
            breaker.on_success()
        else:
            breaker.on_failure()

    def _plan_task_count(self, req: _Request) -> Optional[int]:
        """Task count of the request's cached FinalizedPlan (None when
        the plan cache has never seen this fingerprint — the feasibility
        gate fails open on a cold cache)."""
        if self.plan_cache is None or req.fingerprint is None:
            return None
        entry = self.plan_cache.peek(req.fingerprint)
        if entry is None:
            return None
        try:
            total = 0
            dag = entry.finalized.dag
            for name in dag.nodes:
                node = dag.nodes[name]
                if node.get("type") != "op":
                    continue
                pop = node.get("primitive_op")
                n = getattr(pop, "num_tasks", None)
                if n:
                    total += int(n)
            return total or None
        except Exception:
            return None

    def _check_feasible(self, req: _Request) -> None:
        """L2+ deadline-feasibility admission: estimated cost (cached
        plan task count x the tenant's observed seconds-per-task rate)
        against the time left to the deadline. Either side unknown ->
        fail OPEN — a cold service must not reject its first requests."""
        ctl = self.overload
        if (
            ctl is None
            or ctl.level < L2_SHED_LOAD
            or req.deadline_epoch is None
        ):
            return
        num_tasks = self._plan_task_count(req)
        est = self.estimator.estimate_s(req.tenant, num_tasks)
        if est is None:
            return
        remaining = req.deadline_epoch - time.time()
        if est <= remaining:
            return
        with self._lock:
            depth = sum(len(q) for q in self._queues.values())
        retry = ctl.retry_after_s(depth)
        self._note_shed(
            req.tenant, reason="deadline_infeasible",
            request=req.request_id, estimated_s=round(est, 3),
            remaining_s=round(remaining, 3),
            retry_after_s=round(retry, 3),
        )
        raise DeadlineInfeasibleError(
            f"request {req.request_id} is deadline-infeasible: "
            f"~{est:.1f}s of estimated work against {remaining:.1f}s to "
            "its deadline — shed at admission instead of running to a "
            f"guaranteed SLO miss; retry after {retry:.1f}s",
            retry_after_s=retry,
        )

    @staticmethod
    def _is_resource_failure(exc: BaseException) -> bool:
        from ..runtime.memory import MemoryGuardExceededError

        return isinstance(exc, (MemoryError, MemoryGuardExceededError)) or (
            getattr(exc, "remote_type", None)
            in ("MemoryError", "MemoryGuardExceededError")
        )

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Block until no request is queued or running (True) or the
        timeout passes (False)."""
        deadline = time.monotonic() + timeout
        with self._work:
            while time.monotonic() < deadline:
                if not self._running and not any(
                    self._queues.get(t) for t in self._queues
                ):
                    return True
                self._work.wait(timeout=0.1)
        return False

    # -- introspection -------------------------------------------------

    def stats_snapshot(self) -> dict:
        """Per-tenant rows + service aggregates (the ``/snapshot.json``
        ``service`` section and the ``cubed_tpu_torch.top`` TENANTS panel)."""
        reg = get_registry()
        with self._lock:
            tenants = {}
            for name, s in sorted(self._tenant_stats.items()):
                queued = len(self._queues.get(name) or ())
                running = sum(
                    1 for r in self._running.values() if r.tenant == name
                )
                tenants[name] = {
                    "weight": self.arbiter.weight(name),
                    "queued": queued,
                    "running": running,
                    "accepted": s.accepted,
                    "completed": s.completed,
                    "failed": s.failed,
                    "cancelled": s.cancelled,
                    "throttled": s.throttled,
                    "recovered": s.recovered,
                    "coalesced": s.coalesced,
                    "plan_cache_hits": s.plan_cache_hits,
                    "result_cache_hits": s.result_cache_hits,
                    "shed": s.shed,
                    "breaker": (
                        self._breakers[name].snapshot()
                        if name in self._breakers else None
                    ),
                    # cumulative cost accounting — the sampler turns these
                    # into the tenant_cost_* series (/metrics), and the
                    # cubed_tpu_torch.top COST panel renders them
                    "cost": {
                        "task_seconds": round(s.cost_task_seconds, 6),
                        "bytes_read": s.cost_bytes_read,
                        "bytes_written": s.cost_bytes_written,
                        "peer_bytes": s.cost_peer_bytes,
                        "retries": s.cost_retries,
                        "tasks": s.cost_tasks,
                    },
                }
            queue_depth = sum(len(q) for q in self._queues.values())
            running = len(self._running)
            breakers = dict(self._breakers)
        open_breakers = sorted(
            t for t, b in breakers.items() if b.is_open
        )
        reg.gauge("service_queue_depth").set(queue_depth)
        reg.gauge("service_running").set(running)
        reg.gauge("tenant_breakers_open").set(len(open_breakers))
        overload = {
            "enabled": self.overload is not None,
            "requests_shed": int(reg.counter("requests_shed").value),
            "breakers_open": open_breakers,
        }
        if self.overload is not None:
            overload.update(self.overload.snapshot())
        else:
            overload.update(
                {"level": 0, "name": "disabled", "transitions": 0,
                 "miss_rate": 0.0}
            )
        return {
            "overload": overload,
            "tenants": tenants,
            "queue_depth": queue_depth,
            "running": running,
            "slots": self.admission.effective_limit,
            "throttling": self.admission.throttling,
            "durable": bool(self.config.service_dir),
            "service_dir": self.config.service_dir,
            # per-tenant SLO board rows (None when no SLOs configured):
            # burn rates per window, budget remaining, latency quantiles
            # — the sampler turns these into the slo_* series and the
            # top SLO panel renders them
            "slo": (
                self.slo_board.status()
                if self.slo_board is not None else None
            ),
            "plan_cache": (
                {"entries": len(self.plan_cache)}
                if self.plan_cache is not None else None
            ),
            "result_cache": (
                self.result_cache.stats()
                if self.result_cache is not None else None
            ),
        }
