"""Deterministic, seedable fault injection: off by default.

Counterpart of ``cubed_tpu/runtime/faults.py``, with the same config and the
same decisions: each is a pure function of ``(seed, site, key,
nth-occurrence-in-this-process)`` hashed through SHA-256, so for one config
and one sequence of keys the port injects exactly where the JAX package
does, and a retry in the same process rolls a fresh decision (an injected
fault behaves transiently, the class of failure retries exist for).

Activation (everything defaults to off): ``activate(FaultConfig(...))`` /
``deactivate()``; ``Spec(fault_injection={...})``, which ``Plan.execute``
arms for its compute (``scoped``); or the env var
``CUBED_TPU_TORCH_FAULTS='{"seed": 42, "storage_write_failure_rate": 0.1}'``,
a JSON ``FaultConfig``.

Sites: storage chunk reads and writes (``storage/store.py``: read and write
failures, a failed write that leaves a partial ``.tmp``, silent bit-flip or
truncation corruption, throttles; only inside a task scope); task bodies
(``runtime/utils.execute_with_stats``: failures, stragglers, a synthetic
memory spike handed to the guard); fleet workers (``runtime/distributed.py``:
a crash, hang or spot preemption after a worker's nth task, a poison chunk
that kills every worker it lands on, a timed one-way partition); the
control plane's frames (drop, duplicate, delay, reset); peer chunk fetches
(``runtime/transfer.py``: drop, corrupt, delay, a server's reset); and the
coordinator's dispatches. ``wire_config``/``arm_from_wire`` carry the
client's arming on every fleet task message, so a worker started before
the compute mirrors it. The coordinator crash knobs serve live failover
(``Coordinator(control_dir=)``): a crash after the nth dispatch, or during
a successor's takeover.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass, field, fields
from typing import Optional

from ..observability.accounting import current_scope
from ..observability.metrics import get_registry
from .arming import ScopeStack

#: env var carrying a JSON FaultConfig into every child process
FAULTS_ENV_VAR = "CUBED_TPU_TORCH_FAULTS"


class FaultInjectedError(Exception):
    """Base for injected faults (never raised itself)."""


class FaultInjectedIOError(FaultInjectedError, OSError):
    """An injected storage failure — an OSError, classified transient."""


class FaultInjectedTaskError(FaultInjectedError, RuntimeError):
    """An injected task-body crash — classified transient."""


class FaultInjectedThrottleError(FaultInjectedIOError):
    """An injected store THROTTLE (the 429/503/"SlowDown" shape):
    classified ``THROTTLE`` by the resilience layer, absorbed by the
    per-store health breaker's paced in-place retries when it is on."""


@dataclass(frozen=True)
class FaultConfig:
    """What to break, how often. All rates are probabilities in [0, 1]."""

    seed: int = 0
    #: chunk read/write failure probability (inside task scopes only)
    storage_read_failure_rate: float = 0.0
    storage_write_failure_rate: float = 0.0
    #: probability a chunk read/write is THROTTLED (429/503/SlowDown
    #: shape) — the seeded store-brownout knob; decided per occurrence, so
    #: a paced retry rolls fresh (modelling a store that answers once the
    #: request rate drops)
    storage_throttle_rate: float = 0.0
    #: a failed local write first leaves a partial .tmp file behind
    storage_write_leaves_tmp: bool = True
    #: probability a chunk write's bytes are silently corrupted in flight
    #: (the write "succeeds"): seeded per-chunk choice between a single
    #: bit-flip and a truncation to half length — the two shapes of real
    #: corruption the checksum layer must catch
    storage_corrupt_rate: float = 0.0
    #: task body raises before running
    task_failure_rate: float = 0.0
    #: task body sleeps straggler_delay_s before running
    straggler_rate: float = 0.0
    straggler_delay_s: float = 0.25
    #: probability a task "allocates" a synthetic memory spike of
    #: task_mem_spike_bytes: the memory guard (runtime/memory.py) adds the
    #: injected bytes to the task's measured peak, so chaos tests prove
    #: observe/enforce behavior deterministically without real allocations
    #: (which could genuinely OOM the test host)
    task_mem_spike_rate: float = 0.0
    task_mem_spike_bytes: int = 0
    #: distributed workers (by --name) that hard-exit / hang when their
    #: per-process executed-task count reaches worker_*_after_tasks (>=1)
    worker_crash_names: tuple = field(default_factory=tuple)
    worker_crash_after_tasks: int = 0
    worker_hang_names: tuple = field(default_factory=tuple)
    worker_hang_after_tasks: int = 0
    worker_hang_s: float = 3600.0
    #: probability a fleet worker is SPOT-PREEMPTED: decided once per
    #: worker name (seeded, so ~rate of the fleet is hit deterministically),
    #: fired when that worker's executed-task count reaches
    #: worker_preempt_after_tasks. The worker SIGTERMs itself — exercising
    #: the real spot path: preemption notice (preempt_notice_s) -> graceful
    #: drain -> hard kill at the end of the notice window
    worker_preempt_rate: float = 0.0
    worker_preempt_after_tasks: int = 2
    preempt_notice_s: float = 1.0
    #: POISON-TASK faults (the overload/quarantine chaos shape): a task
    #: whose chunk key rolls under task_fatal_rate — or is listed in
    #: task_fatal_chunk_keys — hard-kills its WORKER (os._exit 137,
    #: modelling a kernel OOM-kill or segfault pinned to one poison
    #: input). Deterministic PER CHUNK KEY with a fixed occurrence-0 roll:
    #: every retry/requeue of the same chunk kills its next host too, so
    #: only the quarantine path (PoisonTaskError after K worker-fatal
    #: attempts) ever ends it. Fleet-only: fires in run_worker, never in
    #: thread/process executors (it would kill the client process)
    task_fatal_rate: float = 0.0
    task_fatal_chunk_keys: tuple = field(default_factory=tuple)
    #: control-plane message faults, decided per frame at the worker's
    #: framing layer ("tx" = worker→coordinator, "rx" = coordinator→worker):
    #: a dropped frame silently vanishes (the reconnect/outbox/lease
    #: machinery must absorb it), a duplicated one is delivered twice (the
    #: seq/task-id dedup must ignore the copy), a delayed one sleeps
    #: net_msg_delay_s in the framing path, and a reset closes the socket
    #: mid-conversation (the worker must reconnect and replay)
    net_msg_drop_rate: float = 0.0
    net_msg_dup_rate: float = 0.0
    net_msg_delay_rate: float = 0.0
    net_msg_delay_s: float = 0.05
    net_reset_rate: float = 0.0
    #: one-way partition of named fleet workers: once such a worker's
    #: executed-task count reaches partition_after_tasks (>=1), frames in
    #: partition_direction ("tx" | "rx" | "both") stop being delivered for
    #: partition_duration_s — reconnect attempts included, exactly like a
    #: real network partition. In-flight tasks keep running; the protocol
    #: must carry their results across the gap (outbox replay) while the
    #: coordinator's lease keeps ownership from being requeued
    partition_worker_names: tuple = field(default_factory=tuple)
    partition_after_tasks: int = 0
    partition_duration_s: float = 2.0
    partition_direction: str = "tx"
    #: peer-to-peer chunk-fetch faults (runtime/transfer.py), decided per
    #: fetch on the READING worker: "drop" makes the reply vanish (store
    #: fallback, like a timeout), "delay" sleeps peer_delay_s in the fetch
    #: path, "corrupt" flips a bit in the fetched bytes so the CRC verify
    #: against the authoritative manifest must catch it. peer_reset_rate
    #: fires on the SERVING worker: the connection is closed mid-
    #: conversation, modelling a peer dying mid-fetch. Every one of these
    #: must resolve to a transparent store fallback — never a task failure
    peer_drop_rate: float = 0.0
    peer_delay_rate: float = 0.0
    peer_delay_s: float = 0.05
    peer_corrupt_rate: float = 0.0
    peer_reset_rate: float = 0.0
    #: coordinator-side crash knobs (live-failover chaos): the coordinator
    #: PROCESS hard-exits (137) once its per-process count of real task
    #: dispatches reaches the threshold (>=1, one-shot). The takeover
    #: variant fires only in a SUCCESSOR (epoch > 0) — killing the control
    #: plane again mid-takeover, the double-failure a second successor
    #: must absorb
    coordinator_crash_after_dispatches: int = 0
    coordinator_takeover_crash_after_dispatches: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "FaultConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown FaultConfig fields {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        d = dict(d)
        for k in (
            "worker_crash_names", "worker_hang_names",
            "partition_worker_names", "task_fatal_chunk_keys",
        ):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)

    def to_env_json(self) -> str:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = list(v) if isinstance(v, tuple) else v
        return json.dumps(out)

    @property
    def any_enabled(self) -> bool:
        return bool(
            self.storage_read_failure_rate
            or self.storage_write_failure_rate
            or self.storage_throttle_rate
            or self.storage_corrupt_rate
            or self.task_failure_rate
            or self.straggler_rate
            or (self.task_mem_spike_rate and self.task_mem_spike_bytes)
            or (self.worker_crash_names and self.worker_crash_after_tasks)
            or (self.worker_hang_names and self.worker_hang_after_tasks)
            or (self.worker_preempt_rate and self.worker_preempt_after_tasks)
            or self.task_fatal_rate
            or self.task_fatal_chunk_keys
            or self.net_msg_drop_rate
            or self.net_msg_dup_rate
            or self.net_msg_delay_rate
            or self.net_reset_rate
            or (self.partition_worker_names and self.partition_after_tasks)
            or self.peer_drop_rate
            or self.peer_delay_rate
            or self.peer_corrupt_rate
            or self.peer_reset_rate
            or self.coordinator_crash_after_dispatches
            or self.coordinator_takeover_crash_after_dispatches
        )


class FaultInjector:
    """Seeded decision engine; one instance per process while active."""

    def __init__(self, config: FaultConfig):
        self.config = config
        self._lock = threading.Lock()
        #: (site, key) -> occurrence count; the count is part of the hash
        #: input, so a retry of the same operation rolls a fresh decision
        self._counts: dict = {}
        #: worker name -> monotonic deadline of its active one-way
        #: partition (armed by worker_task_tick, consulted per frame)
        self._partition_until: dict = {}

    # -- the decision function ------------------------------------------

    def _roll(self, site: str, key: str) -> float:
        with self._lock:
            n = self._counts.get((site, key), 0)
            self._counts[(site, key)] = n + 1
        digest = hashlib.sha256(
            f"{self.config.seed}:{site}:{key}:{n}".encode()
        ).digest()
        return int.from_bytes(digest[:8], "big") / 2**64

    def _hit(self, site: str, key: str, rate: float) -> bool:
        if rate <= 0.0:
            return False
        if self._roll(site, key) >= rate:
            return False
        self._count_injection(site, key=key)
        return True

    @staticmethod
    def _count_injection(site: str, **context) -> None:
        """One injected fault: the conservation-law counters (total +
        per-site, incremented together — the invariant auditor checks
        they stay equal) plus a decision-ring record, so a diagnose
        bundle's timeline names what was injected and when."""
        from ..observability.collect import record_decision

        reg = get_registry()
        reg.counter("faults_injected").inc()
        reg.counter(f"faults_injected_{site}").inc()
        record_decision("fault_injected", site=site, **context)

    # -- storage --------------------------------------------------------

    def storage_read_fault(self, key: str) -> bool:
        """True -> the caller should raise FaultInjectedIOError. Only fires
        inside a task scope (see module docstring)."""
        if current_scope() is None:
            return False
        return self._hit("storage_read", key, self.config.storage_read_failure_rate)

    def storage_write_fault(self, key: str) -> bool:
        if current_scope() is None:
            return False
        return self._hit("storage_write", key, self.config.storage_write_failure_rate)

    def storage_throttle_fault(self, key: str) -> bool:
        """True -> the caller should raise FaultInjectedThrottleError (a
        seeded store brownout). Task-scope-only like the other storage
        sites, and CHUNK files only (digit-dotted names, like the
        corruption knob): the brownout being modelled is chunk-IO
        request pressure, and chunk IO is where the breaker's paced
        in-place retries exist — throttling metadata/manifest IO would
        measure unpaced side doors, not the breaker. Per-occurrence
        rolls mean a paced retry usually succeeds — exactly how a real
        throttling store behaves once the request rate drops."""
        if self.config.storage_throttle_rate <= 0.0:
            return False
        if current_scope() is None:
            return False
        name = key.rsplit("/", 1)[-1]
        if not all(p.lstrip("-").isdigit() for p in name.split(".")):
            return False
        return self._hit(
            "storage_throttle", key, self.config.storage_throttle_rate
        )

    def storage_corrupt_fault(self, key: str, data: bytes) -> Optional[bytes]:
        """Corrupted bytes for this chunk write, or None to write faithfully.

        The corruption itself is a pure function of ``(seed, key)`` — a
        single bit-flip at a seeded position, or truncation to half length —
        so a replayed chaos run corrupts identically; *whether* a given
        write is corrupted rolls per occurrence like every other site."""
        if not data or current_scope() is None:
            return None
        # corruption targets CHUNK files only (digit-dotted names): rotting
        # .zarray/manifest sidecars models a different failure (covered by
        # the metadata-tolerance paths), and would turn every subsequent
        # open into a metadata error instead of exercising checksums
        name = key.rsplit("/", 1)[-1]
        if not all(p.lstrip("-").isdigit() for p in name.split(".")):
            return None
        if not self._hit("storage_corrupt", key, self.config.storage_corrupt_rate):
            return None
        digest = hashlib.sha256(
            f"{self.config.seed}:corrupt:{key}".encode()
        ).digest()
        if digest[0] % 2 == 0:
            pos = int.from_bytes(digest[1:5], "big") % len(data)
            out = bytearray(data)
            out[pos] ^= 1 << (digest[5] % 8)
            return bytes(out)
        return data[: len(data) // 2]

    # -- task bodies ----------------------------------------------------

    def task_fault(self, key: str) -> None:
        """Raise an injected task failure and/or sleep a straggler delay."""
        if self._hit("straggler", key, self.config.straggler_rate):
            import time

            time.sleep(self.config.straggler_delay_s)
        if self._hit("task", key, self.config.task_failure_rate):
            raise FaultInjectedTaskError(
                f"injected task failure (seed={self.config.seed}, key={key!r})"
            )

    def task_fatal(self, chunk_key: str) -> bool:
        """True -> this task's worker must hard-exit (fleet-only call
        site: ``run_worker``, which ``os._exit(137)``s before executing).

        Unlike every other site this decision does NOT advance an
        occurrence counter: the roll is a pure function of
        ``(seed, chunk_key)``, so the same poison chunk kills its host on
        EVERY attempt — requeues reroute it to a fresh worker and kill
        that one too, which is exactly the shape the poison-request
        quarantine must end."""
        cfg = self.config
        if not (cfg.task_fatal_rate or cfg.task_fatal_chunk_keys):
            return False
        hit = str(chunk_key) in cfg.task_fatal_chunk_keys
        if not hit and cfg.task_fatal_rate > 0.0:
            digest = hashlib.sha256(
                f"{cfg.seed}:task_fatal:{chunk_key}:0".encode()
            ).digest()
            hit = (
                int.from_bytes(digest[:8], "big") / 2**64
                < cfg.task_fatal_rate
            )
        if hit:
            self._count_injection("task_fatal", key=str(chunk_key)[:120])
        return hit

    def task_mem_spike(self, key: str) -> int:
        """Synthetic memory-spike bytes for this task attempt (0 = none).

        The guard adds these to the task's measured peak; a retry in the
        same process rolls a fresh decision, so a spiked task usually
        passes on re-run — modelling pressure that recedes once
        concurrency steps down (a rate of 1.0 models a task that is
        genuinely over budget and must abort actionably)."""
        cfg = self.config
        if not (cfg.task_mem_spike_rate and cfg.task_mem_spike_bytes):
            return 0
        if self._hit("task_mem_spike", key, cfg.task_mem_spike_rate):
            return int(cfg.task_mem_spike_bytes)
        return 0


    # -- control plane (coordinator <-> worker framing) -----------------

    def net_fault(self, direction: str, worker_name: str,
                  msg_type: Optional[str]) -> Optional[str]:
        """One seeded decision for a control-plane frame: ``"drop"``,
        ``"reset"``, ``"dup"``, ``"delay"``, or None (deliver faithfully).
        ``direction`` is the worker's view ("tx" = worker→coordinator).
        At most one fault per frame, evaluated in severity order."""
        cfg = self.config
        if not (
            cfg.net_msg_drop_rate
            or cfg.net_msg_dup_rate
            or cfg.net_msg_delay_rate
            or cfg.net_reset_rate
        ):
            return None
        key = f"{worker_name}:{direction}:{msg_type}"
        if self._hit(f"net_{direction}_drop", key, cfg.net_msg_drop_rate):
            return "drop"
        if self._hit(f"net_{direction}_reset", key, cfg.net_reset_rate):
            return "reset"
        if self._hit(f"net_{direction}_dup", key, cfg.net_msg_dup_rate):
            return "dup"
        if self._hit(f"net_{direction}_delay", key, cfg.net_msg_delay_rate):
            return "delay"
        return None

    def peer_fetch_fault(self, key: str) -> Optional[str]:
        """One seeded decision for a peer chunk fetch on the reading side:
        ``"drop"`` (reply vanishes → store fallback), ``"corrupt"`` (a bit
        flips in the fetched bytes — the CRC verify must catch it), or
        ``"delay"`` (sleep ``peer_delay_s`` in the fetch path); None =
        fetch faithfully. At most one fault per fetch, severity order."""
        cfg = self.config
        if not (
            cfg.peer_drop_rate or cfg.peer_corrupt_rate or cfg.peer_delay_rate
        ):
            return None
        if self._hit("peer_drop", key, cfg.peer_drop_rate):
            return "drop"
        if self._hit("peer_corrupt", key, cfg.peer_corrupt_rate):
            return "corrupt"
        if self._hit("peer_delay", key, cfg.peer_delay_rate):
            return "delay"
        return None

    def peer_serve_reset(self, key: str) -> bool:
        """True -> the SERVING worker closes the peer connection instead of
        answering this chunk_get — a peer dying mid-fetch, as seen by the
        reader (who must fall back to the store)."""
        return self._hit("peer_reset", key, self.config.peer_reset_rate)

    def partitioned(self, worker_name: str, direction: str) -> bool:
        """True while ``worker_name`` is inside its injected one-way
        partition window for frames flowing in ``direction``. A reconnect
        attempt must check both directions — a real partition blackholes
        the TCP handshake too."""
        cfg = self.config
        if not (cfg.partition_worker_names and cfg.partition_after_tasks):
            return False
        if worker_name not in cfg.partition_worker_names:
            return False
        with self._lock:
            until = self._partition_until.get(worker_name)
        if until is None:
            return False
        import time

        if time.monotonic() >= until:
            return False
        return cfg.partition_direction in ("both", direction)

    # -- distributed workers --------------------------------------------

    def worker_task_tick(self, worker_name: str) -> Optional[str]:
        """Called once per executed task on a fleet worker; returns
        ``"crash"``/``"hang"``/``"preempt"`` exactly when this worker's
        per-process task count reaches the configured threshold (one-shot
        per process). Preemption is decided by a seeded per-name roll
        rather than an explicit name list: at ``worker_preempt_rate=0.3``
        about 30% of the fleet — the SAME ~30% in every replay — gets a
        SIGTERM-then-hard-kill spot preemption mid-compute."""
        cfg = self.config
        if not (
            (cfg.worker_crash_names and cfg.worker_crash_after_tasks)
            or (cfg.worker_hang_names and cfg.worker_hang_after_tasks)
            or (cfg.worker_preempt_rate and cfg.worker_preempt_after_tasks)
            or (cfg.partition_worker_names and cfg.partition_after_tasks)
        ):
            return None
        with self._lock:
            n = self._counts.get(("worker_tick", worker_name), 0) + 1
            self._counts[("worker_tick", worker_name)] = n
        if (
            cfg.partition_worker_names
            and worker_name in cfg.partition_worker_names
            and n == cfg.partition_after_tasks
        ):
            # arm the one-way partition window; the task itself proceeds —
            # the point is that work completed DURING the partition must
            # reach the coordinator afterwards via the reconnect/replay path
            import time

            with self._lock:
                self._partition_until[worker_name] = (
                    time.monotonic() + cfg.partition_duration_s
                )
            self._count_injection("partition", worker=worker_name)
        if (
            worker_name in cfg.worker_crash_names
            and n == cfg.worker_crash_after_tasks
        ):
            self._count_injection("worker_crash", worker=worker_name)
            return "crash"
        if (
            worker_name in cfg.worker_hang_names
            and n == cfg.worker_hang_after_tasks
        ):
            self._count_injection("worker_hang", worker=worker_name)
            return "hang"
        if (
            cfg.worker_preempt_rate
            and n == cfg.worker_preempt_after_tasks
            # decided per NAME at occurrence 0 (no count consumed by other
            # ticks): deterministic per (seed, worker) — the fleet loses
            # the same ~rate fraction in every replay, and a replacement
            # worker (fresh name) rolls its own fate
            # _hit counts the injection (faults_injected +
            # faults_injected_worker_preempt) — unlike the name-list
            # branches above, nothing to count here
            and self._hit(
                "worker_preempt", worker_name, cfg.worker_preempt_rate
            )
        ):
            return "preempt"
        return None

    # -- coordinator (live-failover chaos) -------------------------------

    def coordinator_dispatch_tick(self, epoch: int) -> bool:
        """Called once per REAL task dispatch on the coordinator; True
        exactly when this process should hard-exit (one-shot per process,
        mirroring ``worker_task_tick``). ``coordinator_crash_after_dispatches``
        fires in any epoch; the ``_takeover_`` variant only in a successor
        (epoch > 0), modelling a second control-plane crash landing while
        the first takeover is still settling."""
        cfg = self.config
        n_any = cfg.coordinator_crash_after_dispatches
        n_tko = cfg.coordinator_takeover_crash_after_dispatches
        if not n_any and not (n_tko and epoch > 0):
            return False
        with self._lock:
            n = self._counts.get(("coordinator_tick", ""), 0) + 1
            self._counts[("coordinator_tick", "")] = n
        if (n_any and n == n_any) or (n_tko and epoch > 0 and n == n_tko):
            self._count_injection("coordinator_crash", epoch=epoch)
            return True
        return False


# ----------------------------------------------------------------------
# process-level activation
# ----------------------------------------------------------------------

_lock = threading.Lock()
_active: Optional[FaultInjector] = None
#: (raw env string, injector built from it) — env parsing is cached per
#: value so the per-IO fast path is a dict lookup + string compare
_env_cache: tuple = (None, None)


def _coerce(config) -> FaultConfig:
    if isinstance(config, FaultConfig):
        return config
    if isinstance(config, dict):
        return FaultConfig.from_dict(config)
    raise TypeError(f"expected FaultConfig or dict, got {type(config).__name__}")


def activate(config, export_env: bool = False) -> FaultInjector:
    """Arm fault injection in this process (and, with ``export_env``, in
    every child process spawned afterwards)."""
    global _active
    cfg = _coerce(config)
    inj = FaultInjector(cfg)
    with _lock:
        _active = inj
    if export_env:
        os.environ[FAULTS_ENV_VAR] = cfg.to_env_json()
    return inj


def deactivate() -> None:
    """Disarm, including any env-var activation exported by this process."""
    global _active, _env_cache
    with _lock:
        _active = None
        _env_cache = (None, None)
    os.environ.pop(FAULTS_ENV_VAR, None)


def get_injector() -> Optional[FaultInjector]:
    """The active injector, or None (the common, fast case).

    Programmatic activation wins; otherwise the env var is consulted so
    spawned workers self-arm. A malformed env value raises loudly — silent
    no-fault chaos runs would be worse than an error.
    """
    global _env_cache
    if _active is not None:
        return _active
    raw = os.environ.get(FAULTS_ENV_VAR)
    if not raw:
        return None
    cached_raw, cached_inj = _env_cache
    if raw == cached_raw:
        return cached_inj
    cfg = FaultConfig.from_dict(json.loads(raw))
    inj = FaultInjector(cfg) if cfg.any_enabled else None
    with _lock:
        _env_cache = (raw, inj)
    return inj


def wire_config() -> Optional[str]:
    """The client's current arming state, serialized for task messages
    (``None`` = unarmed). The distributed coordinator attaches this to
    every task so fleet workers mirror the client exactly — workers that
    joined before arming still inject, and disarming propagates instead of
    leaving stale spawn-time env state behind."""
    inj = get_injector()
    return inj.config.to_env_json() if inj is not None else None


#: (raw wire string, injector) — the worker-side mirror persists across
#: tasks with the same config so occurrence counters advance
_wire_cache: tuple = (None, None)


def arm_from_wire(raw: Optional[str]) -> Optional[FaultInjector]:
    """Fleet-worker side: adopt the arming state a task message carried.

    ``None`` disarms (the client says no injection — overriding any stale
    env the worker process was spawned with)."""
    global _active, _wire_cache
    if raw is None:
        with _lock:
            _active = None
        return None
    cached_raw, cached_inj = _wire_cache
    if raw != cached_raw:
        cfg = FaultConfig.from_dict(json.loads(raw))
        cached_inj = FaultInjector(cfg) if cfg.any_enabled else None
    with _lock:
        _wire_cache = (raw, cached_inj)
        _active = cached_inj
    return cached_inj


class scoped:
    """Context manager arming injection for the duration of a ``with``
    block (used by ``Plan.execute`` for ``Spec(fault_injection=...)``).
    ``None`` config is a no-op, so callers need no conditional.

    Arming is process-global for that duration — it must be: tasks run on
    arbitrary pool threads, so a thread-local injector would never fire.
    Consequently a compute running CONCURRENTLY in the same process during
    an armed block sees the same injector (the same known limitation the
    process-global metrics registry has — see ``Plan.execute``); chaos
    testing and concurrent production computes don't mix in one process.
    Scopes that exit out of order leave the newest live one armed
    (``runtime/arming.py``)."""

    def __init__(self, config=None, export_env: bool = False):
        self._config = config
        self._export_env = export_env

    def __enter__(self):
        if self._config is None:
            return None
        cfg = _coerce(self._config)
        inj = FaultInjector(cfg)
        self._token = _scopes.push(inj, cfg.to_env_json() if self._export_env else None)
        return inj

    def __exit__(self, *exc) -> None:
        if self._config is None:
            return
        _scopes.pop(self._token)


def _set_active(injector) -> None:
    global _active
    _active = injector


_scopes = ScopeStack(_lock, lambda: _active, _set_active, FAULTS_ENV_VAR)
