"""Coordinator autoscaler: elastic fleet sizing + preemption backfill.

Counterpart of ``cubed_tpu/runtime/autoscale.py``; its policy and defaults
are the reference's.

The execution model (stateless idempotent tasks, all data through the
strongly-consistent shared store) is exactly the shape that tolerates
spot/preemptible workers — losing one costs a free requeue, a
drained one hands its in-flight chunks back explicitly, and chunk-granular
resume makes any replay cheap. What was missing is the control
loop: fleet size was fixed at construction, so a preempted worker was
never replaced and an idle fleet never shrank.

:class:`Autoscaler` is that loop. It runs beside a
:class:`~cubed_tpu_torch.runtime.distributed.Coordinator` and, each tick, reads

- **queue depth / per-worker load** — outstanding tasks (incl. ghost
  slots) per worker thread, from ``Coordinator.load_view()``;
- **straggler pressure** — the delta of the live straggler watch's
  ``stragglers_detected`` counter: stragglers mean the op is
  blocked on slow workers, which more capacity (and with it more
  speculative backups) relieves;
- **memory-pressure heartbeats** — workers whose watermarks tripped
 : a mostly-pressured fleet VETOES scale-up, because more workers
  on a memory-starved host deepen the problem they'd be solving;

and asks a pluggable :class:`WorkerFactory` to move the fleet between
``min_workers`` and ``max_workers``:

- **backfill** (no cooldown): live non-draining workers below the current
  desired size — a crash, preemption, or drain left a hole — spawn
  replacements immediately; this is what makes 30% spot preemption a
  wall-clock blip instead of a stall;
- **scale-up** (hysteresis + cooldown): sustained load above
  ``scale_up_queue_per_thread`` (or a burst of straggler detections)
  raises the desired size by ``scale_up_step``;
- **scale-down** (stricter hysteresis + its own cooldown): load below
  ``scale_down_queue_per_thread`` for ``idle_rounds_before_down``
  consecutive ticks drains the least-loaded worker gracefully
  (``Coordinator.request_drain``) — completed chunks are already durable,
  abandoned in-flight tasks requeue free — then asks the factory to reap
  the process.

Every decision lands in the decision ring (``record_decision``:
``scale_up``/``scale_down``; the drain protocol adds
``worker_drain_requested``/``worker_draining``/``worker_drained``), and in
the metrics registry (``workers_scaled_up``/``workers_scaled_down``), so
scale activity is visible in the merged trace and the flight recorder.

The Dask adaptive scheduler is the exemplar for the hysteresis/cooldown
shape; the drain protocol implements the "graceful worker retirement" its
``Worker.close_gracefully`` provides, minus the state migration our
store-mediated dataflow never needs.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..observability.collect import record_decision
from ..observability.metrics import get_registry

logger = logging.getLogger(__name__)


class WorkerFactory:
    """How the autoscaler gets (and gets rid of) workers.

    The local-subprocess implementation lives on
    ``DistributedDagExecutor`` (spawn another ``cubed_tpu_torch.runtime.worker``
    process on the client's chunk device; reap it after its drain); a cluster deployment would back this
    with its instance-group / k8s API instead.
    """

    def start_worker(self) -> Optional[str]:
        """Start one worker; return its name (``None`` = could not start,
        e.g. quota — the autoscaler backs off until the next tick)."""
        raise NotImplementedError

    def stop_worker(self, name: str) -> None:
        """Reap a worker AFTER its graceful drain was requested: wait for
        the process to exit on its own, escalate to kill if it lingers.
        Must be non-blocking (the policy loop calls it inline)."""
        raise NotImplementedError

    def spawn_failed(self, name: str) -> bool:
        """Has this spawned-but-never-registered worker already died
        (e.g. preempted mid-boot)? False = unknown / still booting — the
        pending-spawn timeout remains the backstop. Must be non-blocking
        (the policy loop calls it every tick per pending spawn)."""
        return False


@dataclass
class AutoscalePolicy:
    """Knobs for the policy loop. Defaults favor stability over speed:
    scale-up needs sustained demand, scale-down needs sustained idleness,
    and each direction has its own cooldown so the fleet never flaps."""

    min_workers: int = 1
    max_workers: int = 8
    #: policy-loop tick interval
    interval_s: float = 1.0
    #: scale up when outstanding tasks per live worker thread exceed this
    scale_up_queue_per_thread: float = 4.0
    #: workers added per scale-up decision
    scale_up_step: int = 1
    cooldown_up_s: float = 5.0
    #: scale down only when load per thread is below this...
    scale_down_queue_per_thread: float = 0.5
    #: ...for this many consecutive ticks (hysteresis)
    idle_rounds_before_down: int = 3
    cooldown_down_s: float = 15.0
    #: grace window handed to a scale-down drain
    drain_grace_s: float = 30.0
    #: straggler detections within one tick that count as scale-up demand
    #: even when the queue is shallow (backups need somewhere to run)
    straggler_pressure: int = 2
    #: fraction of live workers reporting memory pressure above which
    #: scale-up is vetoed
    pressure_veto_fraction: float = 0.5
    #: a spawn that has not registered after this long is written off
    #: (its slot reopens for backfill)
    spawn_pending_timeout_s: float = 60.0

    def __post_init__(self):
        if self.min_workers > self.max_workers:
            raise ValueError(
                f"AutoscalePolicy: min_workers={self.min_workers} exceeds "
                f"max_workers={self.max_workers}"
            )


class Autoscaler:
    """The policy loop. ``start()`` runs it on a daemon thread at
    ``policy.interval_s``; ``tick()`` is public so tests can drive the
    policy synchronously without timing races."""

    def __init__(
        self,
        coordinator,
        factory: Optional[WorkerFactory] = None,
        policy: Optional[AutoscalePolicy] = None,
        initial_workers: Optional[int] = None,
        pending_workers: Optional[list] = None,
    ):
        self.coordinator = coordinator
        self.factory = factory
        self.policy = policy or AutoscalePolicy()
        p = self.policy
        init = initial_workers if initial_workers else p.min_workers
        #: the fleet size the loop currently steers toward (clamped)
        self.desired = max(p.min_workers, min(p.max_workers, init))
        self.stats = {
            "workers_scaled_up": 0,
            "workers_scaled_down": 0,
            "autoscaler_ticks": 0,
            "desired_workers": self.desired,
        }
        #: name -> spawn monotonic time, cleared on registration/timeout.
        #: Seeded with the executor's initial spawns so the first ticks —
        #: which run while those workers are still booting — don't read
        #: the empty fleet as damage and backfill a second fleet on top
        self._pending_spawns: dict = {
            n: time.monotonic() for n in (pending_workers or [])
        }
        #: names ever observed live: a pending spawn is settled the moment
        #: its name has registered ONCE — if it later dies (e.g. preempted
        #: right after joining) it must read as a hole to backfill, not as
        #: still-pending capacity
        self._seen: set = set()
        self._idle_rounds = 0
        self._last_up = -1e9
        self._last_down = -1e9
        self._last_stragglers = get_registry().counter(
            "stragglers_detected"
        ).value
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        # with the loop running, a momentarily-empty fleet will be
        # backfilled: tell the coordinator so submit() waits for the
        # replacement instead of raising NoWorkersError when the LAST
        # worker drains/preempts before its replacement registers.
        # Without a factory (out-of-band/listen-mode fleet) nothing can
        # be backfilled, so the wait would only delay an actionable
        # NoWorkersError — leave the grace at 0 in that case.
        if self.factory is not None and hasattr(
            self.coordinator, "backfill_grace_s"
        ):
            self.coordinator.backfill_grace_s = (
                self.policy.spawn_pending_timeout_s
            )
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if hasattr(self.coordinator, "backfill_grace_s"):
            self.coordinator.backfill_grace_s = 0.0
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.policy.interval_s):
            try:
                self.tick()
            except Exception:  # the loop must survive any single bad tick
                logger.exception("autoscaler tick failed")

    # -- the policy ------------------------------------------------------

    def tick(self) -> None:
        """One policy evaluation: backfill, then scale up/down."""
        p = self.policy
        now = time.monotonic()
        in_takeover = getattr(self.coordinator, "in_takeover", None)
        if in_takeover is not None and in_takeover():
            # a successor coordinator is mid-takeover: the adopted fleet
            # is disconnected-but-leased ON PURPOSE, not a set of holes to
            # backfill — spawning replacements now would double the fleet
            # exactly when the real workers are about to re-attach
            with self._lock:
                self.stats["autoscaler_ticks"] += 1
            return
        view = self.coordinator.load_view()
        with self._lock:
            self.stats["autoscaler_ticks"] += 1
            live_names = {row["name"] for row in view}
            self._seen.update(live_names)
            # a worker can register AND die between two ticks; the
            # coordinator's ever-joined set closes that observation gap
            known = getattr(self.coordinator, "known_worker_names", None)
            if known is not None:
                self._seen.update(known())
            for n in list(self._pending_spawns):
                if n in self._seen:
                    del self._pending_spawns[n]
                    continue
                # a spawn killed before it ever registered (preempted
                # mid-boot) must reopen its slot NOW, not after the
                # pending timeout — the factory can often tell
                died = False
                if self.factory is not None:
                    try:
                        died = bool(self.factory.spawn_failed(n))
                    except Exception:
                        logger.exception(
                            "autoscaler: spawn_failed probe failed for %s", n
                        )
                if (
                    died
                    or now - self._pending_spawns[n] > p.spawn_pending_timeout_s
                ):
                    del self._pending_spawns[n]
                    if died:
                        record_decision("spawn_died", worker=n)
                        logger.warning(
                            "autoscaler: worker %s died before registering;"
                            " reopening its slot", n,
                        )
            # disconnected-but-leased workers (a network partition, not a
            # death) still count as capacity: the lease may resolve to a
            # reconnect, and backfilling on top of one would double the
            # fleet for every transient blip — if the lease expires the
            # worker leaves the view and reads as a hole on the next tick
            active = [r for r in view if not r["draining"]]
            n_active = len(active) + len(self._pending_spawns)
            total_threads = sum(max(r["nthreads"], 1) for r in active)
            queue = sum(r["outstanding"] for r in view)
            load = queue / max(total_threads, 1)
            pressured_frac = (
                sum(1 for r in active if r["pressured"]) / len(active)
                if active
                else 0.0
            )
            strag = get_registry().counter("stragglers_detected").value
            strag_delta = strag - self._last_stragglers
            self._last_stragglers = strag

            # -- backfill: replacements for lost/preempted/drained workers
            # jump the cooldown queue — a hole in the fleet is not demand,
            # it is damage, and the whole point is repairing it fast
            if n_active < self.desired:
                self._spawn(self.desired - n_active, "backfill", load)

            # -- scale up: sustained queue depth or straggler pressure.
            # stragglers_detected is process-global; a straggler on THIS
            # fleet implies in-flight work here (queue > 0), so an idle
            # fleet ignores detections that belong to some other compute
            # running in the same client process
            wants_up = (
                load > p.scale_up_queue_per_thread
                or (queue > 0 and strag_delta >= p.straggler_pressure)
            )
            if (
                wants_up
                and n_active >= self.desired  # backfill above handles holes
                and self.desired < p.max_workers
                and now - self._last_up >= p.cooldown_up_s
            ):
                if pressured_frac >= p.pressure_veto_fraction:
                    record_decision(
                        "scale_up_vetoed", reason="memory_pressure",
                        pressured_frac=round(pressured_frac, 2),
                    )
                else:
                    self.desired = min(
                        p.max_workers, self.desired + p.scale_up_step
                    )
                    self._last_up = now
                    self._idle_rounds = 0
                    # surplus capacity (out-of-band joiners above the old
                    # desired) already serves the new target — only spawn
                    # the shortfall, not the full step
                    self._spawn(
                        self.desired - n_active,
                        "straggler_pressure" if strag_delta
                        >= p.straggler_pressure and load
                        <= p.scale_up_queue_per_thread else "queue_depth",
                        load,
                    )

            # -- scale down: sustained idleness, one worker at a time
            if load < p.scale_down_queue_per_thread and not self._pending_spawns:
                self._idle_rounds += 1
            else:
                self._idle_rounds = 0
            # live workers above the steering target (out-of-band joiners,
            # or a fleet started above max) are overcapacity: reconcile
            # down toward `desired` without decrementing it further
            overcapacity = len(active) > self.desired
            if (
                self._idle_rounds >= p.idle_rounds_before_down
                and (overcapacity or self.desired > p.min_workers)
                and len(active) > p.min_workers
                and now - self._last_down >= p.cooldown_down_s
            ):
                # a drain request cannot reach a disconnected worker; pick
                # the least-loaded CONNECTED one (a fleet that is entirely
                # partitioned simply skips this round)
                reachable = [
                    r for r in active if r.get("connected", True)
                ]
                if reachable:
                    victim = min(reachable, key=lambda r: r["outstanding"])
                    if not overcapacity:
                        self.desired = max(p.min_workers, self.desired - 1)
                    self._last_down = now
                    self._idle_rounds = 0
                    self._retire(victim["name"], load)
            self.stats["desired_workers"] = self.desired

    def _spawn(self, k: int, reason: str, load: float) -> None:
        if self.factory is None:
            return  # out-of-band fleet (listen mode): nothing to spawn
        for _ in range(max(0, k)):
            try:
                name = self.factory.start_worker()
            except Exception:
                logger.exception("autoscaler: worker spawn failed")
                return
            if name is None:
                return  # factory out of capacity: retry next tick
            self._pending_spawns[name] = time.monotonic()
            self.stats["workers_scaled_up"] += 1
            get_registry().counter("workers_scaled_up").inc()
            record_decision(
                "scale_up", worker=name, reason=reason,
                desired=self.desired, load=round(load, 2),
            )
            logger.info(
                "autoscaler: starting worker %s (%s, desired=%d)",
                name, reason, self.desired,
            )

    def _retire(self, name: str, load: float) -> None:
        ok = self.coordinator.request_drain(
            name, grace_s=self.policy.drain_grace_s, reason="scale_down"
        )
        if not ok:
            return  # it died between the view and now; backfill logic rules
        self.stats["workers_scaled_down"] += 1
        get_registry().counter("workers_scaled_down").inc()
        record_decision(
            "scale_down", worker=name, desired=self.desired,
            load=round(load, 2),
        )
        logger.info(
            "autoscaler: draining worker %s (scale-down, desired=%d)",
            name, self.desired,
        )
        if self.factory is not None:
            try:
                self.factory.stop_worker(name)
            except Exception:
                logger.exception("autoscaler: worker reap failed for %s", name)
