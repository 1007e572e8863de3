"""Multi-host control plane: a TCP coordinator and worker task fabric.

Counterpart of ``cubed_tpu/runtime/distributed.py``, on the stdlib's
``pickle`` (``runtime/payload.py``) where the JAX package uses
``cloudpickle``. A coordinator in the client process fans chunk tasks out
to worker processes, one per host or one per card, over TCP. All
inter-task data still moves through the shared Zarr store (a shared
filesystem), with idempotent whole-chunk writes, as in the reference; the
fabric carries control messages and kilobyte-scale task payloads, and the
peer data plane (``runtime/transfer.py``) serves chunk bytes worker to
worker, verified against the store's manifests.

Design choices, and why:

- **Futures, not a new scheduler.** The coordinator exposes a
  ``concurrent.futures``-shaped ``submit``, so ``map_unordered`` (retries,
  backups, the dataflow scheduler) drives remote tasks unchanged.
- **Op payloads ship once per worker.** A task message carries the op's
  ``(function, config)`` blob only the first time a worker sees that op
  (content-addressed by SHA-1); later tasks name the blob id.
- **Worker loss is an ordinary task failure.** A lost worker fails its
  in-flight futures with ``WorkerLostError``; ``map_unordered`` requeues
  them (whole-chunk writes are idempotent) and ``submit`` routes to the
  survivors.
- **Worker clocks stamp task stats.** ``execute_with_stats`` runs on the
  worker, so each task's timing, peak memory and kernel launches are
  measured where the work happens, and ride back with its result.
- **The chunk device is the client's.** A worker runs its chunks on the
  device it was started with (``--device``; the executor passes its own);
  asked for ``cuda`` without a card it fails to start, never falling back.

Wire format: 8-byte big-endian length prefix + a ``payload`` frame. The
fabric trusts its peers (same trust model as dask/lithops workers — they
already execute arbitrary user functions by design); deployments must scope
the listen address/network accordingly.

**Partition tolerance.** The paper's data plane already tolerates
every failure — all chunk data moves through strongly-consistent storage
with idempotent whole-chunk writes — but this control plane used to treat
a socket error as worker death. Now the two are separated:

- **Session tokens + reconnect handshake.** Registration is answered with a
  ``hello_ack`` carrying a per-session token. A worker that loses its
  connection keeps running its in-flight tasks, reconnects, and presents
  the token; the coordinator swaps the socket into the existing
  ``_WorkerConn`` (same name, same outstanding futures). A hello claiming a
  live *connected* worker's name without its token is rejected as an
  impostor.
- **Lease-based task ownership.** Only lease expiry — never socket EOF —
  declares ``WorkerLostError``. A disconnect starts a ``lease_s`` clock
  (renewed by any received frame while connected); a worker that
  reconnects inside its lease keeps every in-flight task (no requeue, no
  retry-budget draw), one that stays dark past it is dropped and its tasks
  requeue exactly once as worker loss. Locally spawned workers whose
  process has verifiably exited skip the lease (a dead process cannot
  reconnect).
- **Sequenced, replayed results.** Every consequential worker→coordinator
  message (result / error / drained / abandoned) carries a monotonic
  ``seq``, is acked by the coordinator, and is retained in a bounded
  worker-side outbox until acked; a reconnect replays unacked messages in
  order. The coordinator drops any ``seq`` at or below the highest it has
  processed (``fleet_messages_deduped``), and workers drop re-delivered
  task assignments by task id (``fleet_assignments_deduped``) — so
  injected duplication or replay can never apply a result twice.
- **Frame robustness.** A truncated/garbage frame (bad length prefix,
  unpicklable payload) raises :class:`CorruptFrameError` — counted
  (``frames_corrupt``) and treated as a connection-level error on that
  peer (clean disconnect, lease rules apply) instead of killing the recv
  thread.

Chaos coverage for all of this lives in ``runtime/faults.py`` (seeded
message drop/delay/duplication/reset and a timed one-way partition of a
named worker).

**Live coordinator failover.** With ``control_dir``, the coordinator keeps
an epoch-stamped control log there (``runtime/journal.ControlLog``: the
workers and their session tokens, the dispatch frontier, chunk locations)
and advertises its epoch and address in ``rendezvous.json``. A successor
pointed at the same directory comes up as the next epoch, adopts the
running fleet (workers resume through their session tokens, in-flight
dispatches become adopted futures a resubmit of the same task gets back),
and fences frames of the old epoch; a worker started with ``--rendezvous``
chases the advertisement instead of dying with the old socket.
"""

from __future__ import annotations

import hashlib
import logging
import os
import socket
import struct
import threading
import time
import traceback
import uuid
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Dict, Optional

from ..observability.dispatchprofile import TimedLock
from ..observability.metrics import get_registry
from . import payload
from .transfer import ChunkLocationRegistry, pick_worker_by_locality

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">Q")
#: frames above this are rejected as corrupt/hostile length prefixes
MAX_FRAME = 1 << 31


class WorkerLostError(RuntimeError):
    """The worker owning a task is gone for good: its lease expired without
    a reconnect, its process verifiably exited, or the fleet shut down. A
    mere socket error is NOT this — a disconnected worker keeps task
    ownership until its lease runs out (see the module docstring)."""


class CorruptFrameError(ConnectionError):
    """A frame with a hostile length prefix or an undecodable payload.

    A ``ConnectionError`` subclass on purpose: once the stream carries
    garbage, nothing after it can be trusted — the only safe handling is to
    drop the connection (counted in ``frames_corrupt``) and let the
    reconnect/lease machinery decide what the peer's silence means."""


class WorkerDrainedError(WorkerLostError):
    """A draining worker (scale-down, or a spot preemption notice) abandoned
    this task before completing it. A subclass of ``WorkerLostError`` so the
    retry policy classifies it ``REQUEUE``: the task reroutes to a survivor
    without drawing the user-visible retry budget — chunk-granular resume
    makes the replay cheap, and the worker's completed chunks are
    already durable in the shared store."""


class TaskTimeoutError(RuntimeError):
    """A task exceeded the coordinator's ``task_timeout`` without a result."""


class RemoteTaskError(RuntimeError):
    """A task raised on a worker; carries the remote traceback text plus the
    root exception's class name (``remote_type``) so the retry policy can
    classify remote programming errors as fail-fast without a shared type.
    ``remote_payload`` is the root exception's structured wire payload when
    it has one (``ChunkIntegrityError.wire_payload``: the corrupt chunk's
    store + key, what the client-side RECOMPUTE repair needs)."""

    def __init__(
        self,
        message: str = "",
        remote_type: Optional[str] = None,
        remote_payload: Optional[dict] = None,
    ):
        super().__init__(message)
        self.remote_type = remote_type
        self.remote_payload = remote_payload


class NoWorkersError(RuntimeError):
    """No live workers are connected to the coordinator."""


def frame_bytes(obj: Any) -> bytes:
    """One wire frame (length prefix + ``payload`` bytes), materialized
    eagerly so pickling errors surface before anything is queued or sent —
    the ONE place the frame format lives."""
    data = payload.dumps(obj)
    return _LEN.pack(len(data)) + data


def send_frame(sock: socket.socket, obj: Any, lock: Optional[threading.Lock] = None) -> None:
    data = frame_bytes(obj)
    if lock is not None:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)


#: per-thread timing of the LAST ``recv_frame`` on this thread (unpickle
#: cost + wire size) — the dispatch ledger's result-deserialize stamp.
#: Thread-local because each worker link has its own recv loop: the reader
#: (``_recv_loop``) always runs on the same thread as the recv it measures
_recv_timing = threading.local()


def recv_frame(sock: socket.socket) -> Any:
    header = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise CorruptFrameError(f"frame length {n} exceeds limit")
    data = _recv_exact(sock, n)
    t0 = time.perf_counter()
    try:
        obj = payload.loads(data)
    except Exception as e:
        # torn or garbage payload: the stream is desynchronized — surface a
        # connection-level error, never an uncaught exception that would
        # kill the receiving thread
        raise CorruptFrameError(
            f"undecodable {n}-byte frame ({type(e).__name__}: {e})"
        ) from e
    _recv_timing.unpickle_s = time.perf_counter() - t0
    _recv_timing.nbytes = _LEN.size + n
    return obj


def _fail_future(fut: Future, exc: BaseException) -> None:
    """set_exception tolerating a caller-cancelled future.

    ``map_unordered`` cancels losing backup twins and pending futures on
    retry exhaustion from its own thread; racing that with set_exception
    raises InvalidStateError, which must not kill a coordinator daemon
    thread (the fleet outlives computes, so a dead timeout/receiver thread
    would silently disable enforcement for every later plan)."""
    if fut.done():
        return
    try:
        fut.set_exception(exc)
    except Exception:
        pass  # cancelled (or completed) concurrently: the race is benign


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf.extend(chunk)
    return bytes(buf)


class _WorkerConn:
    """Coordinator-side handle for one connected worker."""

    def __init__(self, sock: socket.socket, address, hello: dict):
        self.sock = sock
        self.address = address
        self.name = hello.get("name") or f"{address[0]}:{address[1]}"
        self.nthreads = int(hello.get("nthreads", 1))
        self.send_lock = threading.Lock()
        self.outstanding: Dict[int, Future] = {}
        #: task_id -> (monotonic deadline, started) — only under task_timeout.
        #: ``started`` flips when the worker acks actual execution start (post
        #: blob decode); a timeout before that is cold-start/queueing load,
        #: rerouted without counting as a hang
        self.deadlines: Dict[int, list] = {}
        #: consecutive timed-out STARTED tasks; reset on any result
        self.timeout_strikes = 0
        #: task_ids of threads still burned by timed-out-but-running tasks;
        #: counted in routing load so retries don't queue behind the very
        #: hang that timed them out; a ghost is removed when ITS late reply
        #: arrives (replies for never-started timeouts must not free a
        #: different ghost's slot)
        self.ghost_ids: set[int] = set()
        self.blobs_sent: set[str] = set()
        #: total tasks ever routed to this worker (load diagnostics)
        self.tasks_sent = 0
        self.alive = True
        #: the worker announced (or was asked) to drain: routing passes it
        #: over while any non-draining worker is live, and its abandoned
        #: tasks requeue free (WorkerDrainedError)
        self.draining = False
        #: guards _drop_worker against double-drops (recv-loop error racing
        #: a timeout-loop eviction or a clean drained departure)
        self.dropped = False
        #: last heartbeat-reported RSS (bytes) and memory-pressure flag —
        #: the coordinator stops dispatching to a pressured worker while
        #: any unpressured one is live (runtime/memory.py watermarks)
        self.rss: Optional[int] = None
        self.pressured = False
        #: NTP-style clock estimate from the heartbeat echo handshake:
        #: coordinator_time ≈ worker_time + clock_offset, accurate to about
        #: clock_rtt/2 — what the trace merger uses to land this worker's
        #: spans on the client timeline (observability/collect.py)
        self.clock_offset: Optional[float] = None
        self.clock_rtt: Optional[float] = None
        #: the worker's peer chunk-server address (ip, port) from the
        #: hello, or None for workers without the p2p data plane; refreshed
        #: on reconnect (the port survives, the reachable ip may not)
        self.peer_addr = tuple(hello["peer_addr"]) if hello.get("peer_addr") else None
        #: latest heartbeat-reported peer-cache stats (bytes/entries/
        #: evictions) for stats_snapshot/diagnose
        self.peer_cache: Optional[dict] = None
        #: cumulative worker-side counters, folded from the bounded
        #: ``metrics_delta`` payloads piggybacked on heartbeat frames —
        #: the per-worker dimension the live telemetry pipeline samples
        #: (tasks completed, peer hits/misses, retries ... as counted
        #: WHERE the work ran, continuously, not once at compute end)
        self.metrics: Dict[str, float] = {}
        #: per-session secret: a reconnecting worker must present it, so a
        #: stranger claiming a live worker's name cannot steal its tasks
        self.token = uuid.uuid4().hex
        #: False while the worker is disconnected-but-leased: routing skips
        #: it, its task deadlines freeze, and only lease expiry drops it
        self.connected = True
        #: bumped on every reconnect; a recv loop whose generation is stale
        #: was superseded and must exit without touching the conn
        self.generation = 0
        #: highest sequenced (important) message processed; replayed or
        #: duplicated frames at/below it are acked but not re-applied
        self.last_seq = 0
        #: monotonic deadline after which a disconnected worker is declared
        #: lost; renewed by every received frame while connected
        self.lease_deadline = float("inf")
        self.disconnect_reason: Optional[str] = None
        #: coordinator epoch this session last (re)joined under — the
        #: per-worker EPOCH column in ``top`` (an adopted worker shows the
        #: prior epoch until its reconnect lands on the successor)
        self.joined_epoch = 0


class Coordinator:
    """Accepts worker connections and fans tasks out to them.

    ``submit(execute_with_stats, function, input, config=...)`` matches how
    ``map_unordered`` drives a ``concurrent.futures`` pool; the stats wrapper
    runs worker-side, and the returned Future resolves to
    ``(result, stats_dict)``.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        task_timeout: Optional[float] = None,
        timeout_strikes: int = 2,
        blob_cache_size: int = 1024,
        lease_s: float = 15.0,
        control_dir: Optional[str] = None,
        takeover_grace_s: Optional[float] = None,
    ):
        if takeover_grace_s is not None and control_dir is None:
            # the window is a successor's: without a control log there is
            # no prior epoch to adopt, and the value would be dropped
            raise ValueError("Coordinator(takeover_grace_s=...) needs control_dir: the takeover window is that of a "
                             "successor adopting the fleet recorded there")
        self._server = socket.create_server((host, port))
        self._server.settimeout(0.2)
        self.address = self._server.getsockname()[:2]
        self._workers: list[_WorkerConn] = []
        #: lifetime count of workers that ever joined (diagnostics: a
        #: zero-worker submit reads very differently when 4 joined and died
        #: vs when nothing ever connected)
        self._workers_ever = 0
        #: names of every worker that ever joined — the autoscaler settles
        #: its pending-spawn bookkeeping against this, so a worker that
        #: registers and dies between two policy ticks still reads as a
        #: hole to backfill, not as still-pending capacity (strings only;
        #: unbounded but tiny even for a fleet churning thousands)
        self._worker_names_ever: set = set()
        #: set (>0) by an attached Autoscaler: a momentarily-empty fleet is
        #: expected to be backfilled, so submit() waits up to this long for
        #: a replacement to register before raising NoWorkersError
        self.backfill_grace_s: float = 0.0
        #: the coordinator's hot lock, instrumented: contended-acquire wait
        #: feeds ``dispatch_lock_wait_s`` and the per-submit ledger's
        #: ``lock_wait_s`` (observability/dispatchprofile.TimedLock — a
        #: drop-in Lock; the Condition below works through the stdlib's
        #: generic acquire/release fallbacks)
        self._lock = TimedLock()
        self._next_task_id = 0
        self._closed = threading.Event()
        self._worker_joined = threading.Condition(self._lock)
        #: LRU over (id(function), id(config)) — bounded so a long-lived
        #: listen-mode coordinator serving many plans doesn't pin every
        #: op's objects forever; an evicted pair is simply re-pickled on
        #: the next submit (same bytes -> same blob_id -> workers that
        #: already hold it are not resent)
        self._blob_cache: OrderedDict[tuple, tuple] = OrderedDict()
        self._blob_cache_size = max(1, blob_cache_size)
        #: final load rows of workers that left (crash/shutdown), so the
        #: stats snapshot doesn't erase history exactly when a worker is
        #: lost; bounded LRU (a long-lived fleet churns workers)
        self._departed: OrderedDict[str, dict] = OrderedDict()
        self.task_timeout = task_timeout
        self.timeout_strikes = timeout_strikes
        #: how long a disconnected worker keeps owning its in-flight tasks;
        #: a reconnect inside the lease costs nothing, expiry requeues its
        #: tasks exactly once as worker loss
        self.lease_s = float(lease_s)
        #: optional hook mapping a worker name to its process exit code
        #: (the executor sets it for locally spawned workers): a dropped
        #: connection plus exitcode -9/137 reads as an OOM-killed worker,
        #: which the WorkerLostError message then says out loud
        self.exit_probe = None
        #: diagnostics: blob bytes actually sent vs referenced by id
        self.stats: Dict[str, int] = {
            "blobs_sent": 0, "tasks_sent": 0, "task_timeouts": 0,
            "workers_lost": 0, "drains_completed": 0, "workers_preempted": 0,
            "tasks_abandoned_on_drain": 0, "workers_disconnected": 0,
            "workers_reconnected": 0, "leases_expired": 0,
            "frames_corrupt": 0, "workers_rejected": 0,
            "peer_locate_requests": 0, "placement_locality_hits": 0,
            "compute_cancels_sent": 0, "coordinator_takeovers": 0,
            "stale_epoch_frames": 0, "tasks_readopted": 0,
            "assignments_requeued": 0,
        }
        #: (store, chunk key) -> producing worker, fed by the `produced`
        #: lists piggybacked on sequenced result frames; drives the
        #: chunk_locate RPC and locality-aware dispatch (runtime/transfer.py)
        self.chunk_registry = ChunkLocationRegistry()
        #: fleet-wide accumulation of the workers' heartbeat metric deltas
        #: (counters add; the per-worker split lives on each conn) — what
        #: the telemetry sampler and stats_snapshot read as the merged
        #: worker-side view
        self.fleet_metrics: Dict[str, float] = {}
        #: per-message-type frame/byte counts on the coordinator link, both
        #: directions ({"sent"/"recv": {mtype: [frames, bytes]}}) — the
        #: control-plane traffic breakdown stats_snapshot/top expose; plain
        #: dict increments (GIL-atomic enough for diagnostics), bounded by
        #: the fixed message-type vocabulary plus a hard key cap
        self._frame_counts: Dict[str, Dict[str, list]] = {
            "sent": {}, "recv": {},
        }
        #: decision-ring entries for locality placement are throttled (the
        #: counters carry the totals; the ring is bounded)
        self._locality_decisions_left = 16
        #: live coordinator failover (runtime/journal.ControlLog): the
        #: epoch fences frames across coordinator incarnations, and the
        #: control log is the bounded snapshot a successor pointed at the
        #: same ``control_dir`` re-adopts the running fleet from
        self.epoch = 0
        self.control_dir = control_dir
        self._control = None
        self._control_sink = None
        #: takeover window: until this monotonic deadline, adopted-but-
        #: silent workers stay leased (the autoscaler must not backfill
        #: them) and adopted futures wait for worker outbox replays
        self._takeover_deadline = 0.0
        #: (op, chunk-key) tag -> adopted Future for the prior epoch's
        #: in-flight dispatches: ``submit`` with the same tag hands the
        #: adopted future back instead of re-dispatching (tasks_readopted)
        self._adopted: Dict[tuple, Future] = {}
        #: adopted futures actually handed out via submit(); the lease
        #: loop's takeover backstop requeues any still pending once the
        #: window closes (a genuinely lost assignment: no replay owned it)
        self._adopted_issued: list = []
        #: (conn, task_id, tag, fut) for every adoption, so the backstop
        #: can clear the stub bookkeeping exactly once
        self._adopted_pending: list = []
        if control_dir is not None:
            self._init_control_plane(takeover_grace_s)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="coordinator-accept", daemon=True
        )
        self._accept_thread.start()
        if task_timeout is not None:
            threading.Thread(
                target=self._timeout_loop, name="coordinator-timeouts",
                daemon=True,
            ).start()
        threading.Thread(
            target=self._lease_loop, name="coordinator-leases", daemon=True
        ).start()
        # the live telemetry sampler (observability/timeseries.py) polls
        # registered fleets for per-worker series; weak registration, so a
        # leaked coordinator can't pin itself into the telemetry loop
        from ..observability.timeseries import register_fleet

        register_fleet(self)

    # -- live failover: control-plane snapshot + fleet adoption ---------

    def _init_control_plane(self, takeover_grace_s: Optional[float]) -> None:
        """Open the control log; when it already records a prior epoch,
        this coordinator is a SUCCESSOR: bump the epoch, re-adopt the
        snapshot's fleet (workers re-attach through their session tokens,
        in-flight dispatches become adopted futures), fence the old epoch,
        and advertise the new one in the rendezvous file. Runs inside
        ``__init__`` before any service thread starts — no locking."""
        from ..observability.collect import add_decision_sink
        from .journal import ControlLog, control_log_path, load_control

        prior = load_control(control_log_path(self.control_dir))
        self._control = ControlLog(self.control_dir)
        if prior["epoch"] >= 0:
            self.epoch = prior["epoch"] + 1
        # successor task ids must never collide with the prior epoch's:
        # workers keep their assignment-dedup state across a resumed
        # reconnect, and a colliding id would be silently swallowed as a
        # duplicate — shift each epoch into its own id space
        self._next_task_id = self.epoch << 40
        grace = (
            float(takeover_grace_s) if takeover_grace_s is not None
            else max(2 * self.lease_s, 30.0)
        )
        if self.epoch > 0:
            self._takeover_deadline = time.monotonic() + grace
            self._adopt_fleet(prior, grace)
        self._control.record_epoch(self.epoch, self.address)
        self._control.advertise(self.epoch, self.address)
        get_registry().gauge("coordinator_epoch").set(self.epoch)
        # mirror connectivity decisions into the control log so the NEXT
        # successor can stitch a two-epoch timeline; replayed prior-epoch
        # entries carry an ``epoch`` attr and are not re-mirrored
        kinds = {
            "worker_disconnected", "worker_reconnected", "lease_expired",
            "worker_rejected", "worker_drain_requested", "worker_draining",
            "worker_drained", "scale_up", "scale_down", "spawn_died",
        }
        control, epoch = self._control, self.epoch

        def _sink(entry: dict) -> None:
            if entry.get("kind") in kinds and entry.get("epoch") is None:
                control.record_decision(epoch, entry)

        self._control_sink = _sink
        add_decision_sink(_sink)

    def _adopt_fleet(self, prior: dict, grace: float) -> None:
        """Rebuild the prior epoch's fleet from its snapshot: every
        recorded worker becomes a disconnected-but-leased session (same
        name, same token — the reconnect handshake resumes it), every
        in-flight dispatch becomes an adopted future keyed by its (op,
        chunk-key) tag, and the chunk-location registry is replayed.
        Nothing is re-dispatched here: ``submit`` hands an adopted future
        back when the DAG re-asks for that task, the worker's outbox
        replay resolves it, and the lease loop's backstop requeues only
        what the takeover window proves genuinely lost."""
        from ..observability.collect import record_decision

        deadline = time.monotonic() + grace
        for name, rec in prior["workers"].items():
            hello = {
                "name": name,
                "nthreads": rec.get("nthreads", 1),
                "peer_addr": rec.get("peer_addr"),
            }
            conn = _WorkerConn(
                None, tuple(rec.get("address") or ("?", 0)), hello
            )
            conn.token = rec["token"]
            conn.connected = False
            conn.disconnect_reason = "adopted after coordinator takeover"
            conn.lease_deadline = deadline
            conn.joined_epoch = max(0, prior["epoch"])
            self._workers.append(conn)
            self._workers_ever += 1
            self._worker_names_ever.add(name)
        by_name = {w.name: w for w in self._workers}
        readopted = 0
        for task_id, rec in prior["inflight"].items():
            tag, conn = rec.get("tag"), by_name.get(rec.get("worker"))
            if not tag or conn is None:
                continue
            fut: Future = Future()
            conn.outstanding[int(task_id)] = fut
            self._adopted[tuple(tag)] = fut
            self._adopted_pending.append((conn, int(task_id), tuple(tag), fut))
            readopted += 1
        for loc in prior["chunk_locations"]:
            wname = loc.get("worker")
            if wname in by_name:
                self.chunk_registry.record(
                    wname,
                    [(loc.get("store"), loc.get("key"),
                      int(loc.get("nbytes") or 0))],
                )
        self.stats["coordinator_takeovers"] += 1
        get_registry().counter("coordinator_takeovers").inc()
        # replay the prior epoch's connectivity decisions (bounded) into
        # THIS process's ring, keeping their original ``epoch`` attr, so
        # diagnose renders one stitched two-epoch timeline
        for entry in prior["decisions"]:
            kind = entry.get("decision")
            if not kind:
                continue
            attrs = {
                k: v for k, v in entry.items()
                if k not in ("kind", "decision", "t", "ts", "version")
            }
            record_decision(kind, **attrs)
        record_decision(
            "coordinator_takeover", epoch=self.epoch,
            prior_epoch=prior["epoch"],
            workers_adopted=len(prior["workers"]),
            inflight_readopted=readopted, grace_s=round(grace, 3),
        )
        self._control.record_decision(self.epoch, {
            "kind": "coordinator_takeover", "prior_epoch": prior["epoch"],
            "workers_adopted": len(prior["workers"]),
            "inflight_readopted": readopted,
        })
        logger.warning(
            "coordinator takeover: epoch %d adopted %d worker(s) and %d "
            "in-flight dispatch(es) from epoch %d (takeover window %.1fs)",
            self.epoch, len(prior["workers"]), readopted, prior["epoch"],
            grace,
        )

    def in_takeover(self) -> bool:
        """True while the successor's takeover window is open: adopted
        workers count as leased capacity (the autoscaler must not treat
        them as holes to backfill) and adopted futures wait for worker
        outbox replays before anything is requeued."""
        return time.monotonic() < self._takeover_deadline

    def _record_worker_control(self, conn: _WorkerConn, pid=None) -> None:
        if self._control is None:
            return
        self._control.record_worker(
            conn.name, conn.token, conn.nthreads,
            peer_addr=conn.peer_addr, address=conn.address, pid=pid,
        )

    # -- worker management ---------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, addr = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                hello = recv_frame(sock)
                if not isinstance(hello, dict) or hello.get("type") != "hello":
                    raise ConnectionError(f"bad hello: {hello!r}")
            except Exception:
                logger.exception("rejecting connection from %s", addr)
                sock.close()
                continue
            self._register(sock, addr, hello)

    def _register(self, sock, addr, hello: dict) -> None:
        """Handle one hello: a token-bearing reconnect re-adopts the
        existing session; a token-less hello claiming a live CONNECTED
        worker's name is rejected as an impostor; a token-less hello under
        a disconnected worker's name supersedes the old session (a
        restarted process cannot resume work it no longer holds)."""
        from ..observability.collect import record_decision

        name = hello.get("name") or f"{addr[0]}:{addr[1]}"
        token = hello.get("token")
        with self._lock:
            existing = next(
                (w for w in self._workers if w.alive and w.name == name), None
            )
        if existing is not None and token and token == existing.token:
            if self._adopt_reconnect(existing, sock, addr, hello):
                return
            # the lease expired between the lookup and the adopt: the old
            # session is gone — fall through to a fresh registration
            existing = None
        elif existing is not None and existing.connected:
            with self._lock:
                self.stats["workers_rejected"] += 1
            get_registry().counter("workers_rejected").inc()
            record_decision("worker_rejected", worker=name)
            logger.warning(
                "rejecting hello from %s claiming live worker %s "
                "(missing/wrong session token)", addr, name,
            )
            try:
                send_frame(sock, {
                    "type": "hello_reject",
                    "reason": f"name {name!r} belongs to a live connected "
                    "worker (wrong or missing session token)",
                })
            except (ConnectionError, OSError):
                pass
            sock.close()
            return
        elif existing is not None:
            # disconnected-but-leased, and the newcomer has no (valid)
            # token: a restarted process under the same name — the old
            # session's in-flight work is unrecoverable, hand it back now
            self._drop_worker(
                existing,
                "superseded by a new registration under the same name",
            )
        conn = _WorkerConn(sock, addr, hello)
        conn.lease_deadline = time.monotonic() + self.lease_s
        conn.joined_epoch = self.epoch
        # register BEFORE acking — acking first left a window where a fast
        # client's submit() raised NoWorkersError against a worker that
        # believed itself registered — but keep the conn UNROUTABLE
        # (connected=False) until the ack is on the wire: the hello_ack
        # must be the first frame the worker receives, so a racing
        # submit() must not slip a task frame ahead of it (submit's
        # no-connected-workers path waits on _worker_joined, which the
        # flip below notifies)
        conn.connected = False
        with self._lock:
            self._workers.append(conn)
            self._workers_ever += 1
            self._worker_names_ever.add(conn.name)
            self._worker_joined.notify_all()
        try:
            send_frame(sock, {
                "type": "hello_ack", "token": conn.token, "resume": False,
                "lease_s": self.lease_s, "epoch": self.epoch,
            })
        except (ConnectionError, OSError) as e:
            logger.warning("hello_ack to %s failed: %s", name, e)
            # roll the registration back quietly: the worker never saw the
            # ack (it retries with a fresh hello) and was never routable
            # (connected=False), so this is NOT a worker loss — no
            # workers_lost count, no departed row
            with self._lock:
                conn.dropped = True
                conn.alive = False
                if conn in self._workers:
                    self._workers.remove(conn)
            try:
                sock.close()
            except OSError:
                pass
            return
        with self._lock:
            conn.connected = True
            self._worker_joined.notify_all()
        # fsync'd AFTER the ack: the worker is durably part of the fleet a
        # successor would adopt only once both sides agree it registered
        self._record_worker_control(conn, pid=hello.get("pid"))
        threading.Thread(
            target=self._recv_loop,
            args=(conn, sock, conn.generation),
            name=f"coordinator-recv-{conn.name}",
            daemon=True,
        ).start()
        logger.info("worker %s joined (%d threads)", conn.name, conn.nthreads)

    def _adopt_reconnect(self, conn: _WorkerConn, sock, addr, hello=None) -> bool:
        """Swap a reconnecting worker's new socket into its live session:
        outstanding futures, lease, and blob bookkeeping all survive. The
        superseded recv loop notices its stale generation and exits."""
        from ..observability.collect import record_decision

        with self._lock:
            if conn.dropped:
                return False
            old_sock = conn.sock
            conn.sock = sock
            conn.address = addr
            if hello is not None and hello.get("peer_addr"):
                # the peer server survives the reconnect, but the reachable
                # ip may have changed with the new route
                conn.peer_addr = tuple(hello["peer_addr"])
            conn.connected = True
            conn.generation += 1
            gen = conn.generation
            conn.lease_deadline = time.monotonic() + self.lease_s
            conn.disconnect_reason = None
            conn.joined_epoch = self.epoch
            self.stats["workers_reconnected"] += 1
            # reconcile against what the worker actually HOLDS (its
            # assignment-dedup set plus unacked outbox frames, carried on
            # the resume hello): an assignment this side sent that the
            # dead link ate is outstanding here but unknown there — no
            # replay will ever resolve it, and the renewed lease would
            # shield the hole forever. Requeue exactly those.
            requeue = []
            holding = hello.get("holding") if hello else None
            if holding is not None:
                held = set(holding)
                issued = {id(f) for f in self._adopted_issued}
                for tid in [t for t in conn.outstanding if t not in held]:
                    fut = conn.outstanding.pop(tid)
                    conn.deadlines.pop(tid, None)
                    conn.ghost_ids.discard(tid)
                    if fut.done():
                        continue
                    entry = next(
                        (e for e in self._adopted_pending
                         if e[0] is conn and e[1] == tid), None,
                    )
                    if entry is not None:
                        # an adopted dispatch the prior epoch logged but
                        # never delivered: settle it now instead of
                        # waiting out the takeover window
                        self._adopted_pending.remove(entry)
                        if id(fut) not in issued:
                            # never handed out via submit: forget the tag
                            # so the DAG dispatches it fresh
                            self._adopted.pop(entry[2], None)
                            continue
                        self._adopted_issued = [
                            f for f in self._adopted_issued if f is not fut
                        ]
                    requeue.append((tid, fut))
                self.stats["assignments_requeued"] += len(requeue)
            outstanding = len(conn.outstanding)
            self._worker_joined.notify_all()
        if old_sock is not None:  # None: an adopted stub re-attaching
            try:
                old_sock.close()
            except OSError:
                pass
        for tid, fut in requeue:
            _fail_future(fut, WorkerLostError(
                f"assignment {tid} never reached worker {conn.name} "
                "(lost with the dead link); requeueing"
            ))
        if requeue:
            get_registry().counter("assignments_requeued").inc(len(requeue))
            logger.warning(
                "worker %s reconnected without %d assignment(s) this side "
                "thought it held; requeued them", conn.name, len(requeue),
            )
        get_registry().counter("workers_reconnected").inc()
        record_decision(
            "worker_reconnected", worker=conn.name, outstanding=outstanding,
            requeued=len(requeue),
        )
        logger.warning(
            "worker %s reconnected (%d in-flight tasks kept under its "
            "lease)", conn.name, outstanding,
        )
        try:
            send_frame(sock, {
                "type": "hello_ack", "token": conn.token, "resume": True,
                "lease_s": self.lease_s, "epoch": self.epoch,
            }, conn.send_lock)
        except (ConnectionError, OSError) as e:
            self._on_disconnect(conn, f"hello_ack failed: {e}", gen=gen)
            return True  # adopted (and immediately disconnected again)
        # refresh the snapshot row (the peer address may have moved with
        # the new route, and a successor's log needs this worker recorded
        # under ITS epoch too)
        self._record_worker_control(conn, pid=(hello or {}).get("pid"))
        threading.Thread(
            target=self._recv_loop,
            args=(conn, sock, gen),
            name=f"coordinator-recv-{conn.name}",
            daemon=True,
        ).start()
        return True

    def wait_for_workers(self, count: int, timeout: float = 60.0) -> None:
        with self._lock:
            ok = self._worker_joined.wait_for(
                lambda: len([w for w in self._workers if w.alive]) >= count,
                timeout=timeout,
            )
        if not ok:
            host, port = self.address
            with self._lock:
                ever = self._workers_ever
            raise TimeoutError(
                f"only {self.n_workers} of {count} workers joined the "
                f"coordinator at {host}:{port} (epoch {self.epoch}) "
                f"within {timeout}s "
                f"({ever} ever joined, {self.stats['workers_lost']} lost); "
                "start workers with 'python -m cubed_tpu_torch.runtime.worker "
                f"{host}:{port}' on each host, or raise "
                "worker_start_timeout if they are still booting"
            )

    @property
    def n_workers(self) -> int:
        with self._lock:
            return len([w for w in self._workers if w.alive])

    def _drop_worker(
        self, conn: _WorkerConn, reason: str, clean: bool = False,
        only_if_disconnected: bool = False,
    ) -> bool:
        """Remove a worker; True when this call actually dropped it.
        ``clean=True`` marks an orderly departure (a completed drain): it
        is not counted as ``workers_lost`` — the fleet asked it to leave
        (or it left within its preemption notice), and its in-flight work
        was already handed back explicitly. ``only_if_disconnected=True``
        (the lease-expiry path) aborts if a reconnect won the race between
        the expiry check and this call — the re-adopted live session must
        not be torn down."""
        with self._lock:
            if conn.dropped:
                return False  # recv-loop error racing another drop: done
            if only_if_disconnected and conn.connected:
                return False  # a reconnect won: the lease no longer applies
            conn.dropped = True
        if (
            self.exit_probe is not None
            and not clean
            and reason != "shutdown"
            and not reason.startswith("hung")
        ):
            # best-effort: the worker process usually finishes dying within
            # a few ms of its socket resetting; -9/137 turns a cause-less
            # "connection reset" into "likely OOM-killed". Hung-worker
            # evictions skip this: the process is alive by definition, so
            # the probe's brief reap-wait would only delay the eviction
            try:
                code = self.exit_probe(conn.name)
            except Exception:
                code = None
            if code is not None:
                if code in (-9, 137) and conn.draining:
                    # the drain protocol's own hard-kill deadline exits
                    # 137 — a worker we KNEW was draining did not OOM
                    hint = " — hard-killed at end of drain/preemption notice"
                elif code in (-9, 137):
                    hint = " — likely OOM-killed (SIGKILL)"
                else:
                    hint = ""
                reason = f"{reason} (worker process exitcode {code}{hint})"
        with self._lock:
            conn.alive = False
            if conn in self._workers:
                self._workers.remove(conn)
            orphans = list(conn.outstanding.items())
            self._departed[conn.name] = {
                "alive": False,
                "reason": reason,
                "nthreads": conn.nthreads,
                "outstanding": 0,
                "ghosts": len(conn.ghost_ids),
                "tasks_sent": conn.tasks_sent,
                "drained": clean,
                "clock_offset": conn.clock_offset,
                "clock_rtt": conn.clock_rtt,
            }
            while len(self._departed) > 32:
                self._departed.popitem(last=False)
            conn.outstanding.clear()
            conn.deadlines.clear()
        if conn.sock is not None:  # None: an adopted stub that never re-attached
            try:
                conn.sock.close()
            except OSError:
                pass
        if self._control is not None:
            # fsync'd: a successor must not re-adopt a worker this epoch
            # already declared gone (its tasks were requeued HERE)
            self._control.record_worker_gone(conn.name)
        # a departed worker can no longer serve peer fetches: drop its
        # chunk locations so readers go straight to the store instead of
        # timing out against a corpse
        self.chunk_registry.drop_worker(conn.name)
        exc_cls = WorkerDrainedError if clean else WorkerLostError
        nthreads = max(1, conn.nthreads or 1)
        for idx, (task_id, fut) in enumerate(orphans):
            err = exc_cls(f"worker {conn.name} lost: {reason}")
            if not clean:
                # only the task slots actually executing at the abrupt
                # death can have CAUSED it. Dispatch and slot execution
                # are both FIFO and completed tasks pop out of
                # `outstanding`, so the oldest `nthreads` remaining
                # entries were the ones running — everything behind them
                # was merely queued on the corpse and must not collect a
                # poison-quarantine strike for its neighbor's crime
                err.was_executing = idx < nthreads
            _fail_future(fut, err)
        if clean and orphans:
            # tasks still queued on the worker when its drain closed the
            # socket: abandoned like the in-flight ones, requeued free
            with self._lock:
                self.stats["tasks_abandoned_on_drain"] += len(orphans)
            get_registry().counter("tasks_abandoned_on_drain").inc(
                len(orphans)
            )
        if (orphans or reason != "shutdown") and not clean:
            with self._lock:
                self.stats["workers_lost"] += 1
            get_registry().counter("workers_lost").inc()
            logger.warning(
                "worker %s dropped (%s); failed %d in-flight tasks",
                conn.name, reason, len(orphans),
            )
        elif clean:
            logger.info("worker %s departed cleanly (%s)", conn.name, reason)
        return True

    def _on_disconnect(
        self, conn: _WorkerConn, reason: str, gen: Optional[int] = None
    ) -> None:
        """A worker's socket died. Socket EOF is NOT worker death: unless
        the worker's process has verifiably exited (local exit probe), was
        draining, or the fleet is shutting down, the worker enters the
        disconnected-but-leased state — routing skips it, its task
        deadlines freeze, and only lease expiry (or a reconnect) resolves
        it."""
        from ..observability.collect import record_decision

        with self._lock:
            if conn.dropped or not conn.connected:
                return
            if gen is not None and conn.generation != gen:
                return  # a reconnect already superseded this socket
            # pin the generation we are disconnecting: an adopt that lands
            # during the exit probe below bumps it, and must not have its
            # freshly installed socket closed by this stale failure
            gen = conn.generation
        if self._closed.is_set() or conn.draining:
            if (
                conn.draining
                and not self._closed.is_set()
                and not conn.outstanding
            ):
                # the drain already finished every task (nothing in
                # flight) but the link died before the ``drained`` frame
                # landed — e.g. a reconnect loop that exhausted its
                # retries mid-drain. Seal the drain instead of counting a
                # worker loss: the departure is exactly as clean as if
                # the frame had arrived
                self._on_drained(
                    conn,
                    {"reason": "drain-complete (link lost after completion)"},
                )
                return
            # shutdown, or a drainer that died mid-drain: the old semantics
            # (and the old diagnostics, e.g. the drain hard-kill hint)
            self._drop_worker(conn, reason)
            return
        if self.exit_probe is not None:
            # a locally spawned worker whose process already exited can
            # never reconnect: skip the lease and fail over immediately —
            # this keeps crash recovery exactly as fast as before leases
            try:
                code = self.exit_probe(conn.name)
            except Exception:
                code = None
            if code is not None:
                self._drop_worker(conn, reason)
                return
        with self._lock:
            if (
                conn.dropped
                or not conn.connected
                or conn.generation != gen
            ):
                return  # raced a concurrent drop/reconnect during the probe
            conn.connected = False
            conn.disconnect_reason = reason
            conn.lease_deadline = time.monotonic() + self.lease_s
            outstanding = len(conn.outstanding)
            self.stats["workers_disconnected"] += 1
            # captured under the lock: an adopt racing this close must not
            # have its freshly installed socket shut by us
            sock_to_close = conn.sock
        try:
            sock_to_close.close()
        except OSError:
            pass
        get_registry().counter("workers_disconnected").inc()
        record_decision(
            "worker_disconnected", worker=conn.name, reason=reason,
            outstanding=outstanding, lease_s=self.lease_s,
        )
        logger.warning(
            "worker %s disconnected (%s); %d in-flight task(s) stay leased "
            "to it for %.1fs pending a reconnect",
            conn.name, reason, outstanding, self.lease_s,
        )

    def _lease_loop(self) -> None:
        """Declare disconnected workers lost once their lease runs out —
        the ONLY path (besides a verified process exit and shutdown) that
        turns a network fault into ``WorkerLostError``.

        A CONNECTED worker whose lease lapses (no frame received for a
        whole window — heartbeats renew it every second, so this means a
        vanished host whose TCP stack never sent a reset) is first demoted
        to the disconnected state, earning one more lease window for its
        side's watchdog to reconnect; only then does expiry drop it. Total
        time to declare such a host lost: 2 x lease_s — finite, where it
        used to hang forever without a ``task_timeout``."""
        from ..observability.collect import record_decision

        interval = max(0.05, min(1.0, self.lease_s / 5))
        while not self._closed.wait(interval):
            now = time.monotonic()
            with self._lock:
                expired = [
                    w for w in self._workers
                    if w.alive and not w.connected
                    and now > w.lease_deadline
                ]
                silent = [
                    w for w in self._workers
                    if w.alive and w.connected and now > w.lease_deadline
                ]
            for conn in silent:
                self._on_disconnect(
                    conn,
                    f"no frames received for {self.lease_s}s "
                    "(half-open link or vanished host)",
                )
            for conn in expired:
                reason = conn.disconnect_reason
                if not self._drop_worker(
                    conn,
                    f"lease expired {self.lease_s}s after disconnect "
                    f"({reason})",
                    only_if_disconnected=True,
                ):
                    continue  # a reconnect won the race: nothing expired
                with self._lock:
                    self.stats["leases_expired"] += 1
                get_registry().counter("leases_expired").inc()
                record_decision(
                    "lease_expired", worker=conn.name, reason=reason,
                )
            # takeover backstop: once the window closes, any adopted
            # future still pending was a genuinely lost assignment — no
            # surviving worker replayed its result and no lease expiry
            # settled it. Requeue issued ones exactly once (_fail_future's
            # done-guard absorbs a racing late replay); forget the rest so
            # a later submit of that tag dispatches fresh.
            if self._adopted_pending and not self.in_takeover():
                with self._lock:
                    pending = self._adopted_pending
                    self._adopted_pending = []
                    issued = {id(f) for f in self._adopted_issued}
                    self._adopted_issued = []
                    requeue = []
                    for conn, tid, tag, fut in pending:
                        if fut.done():
                            continue
                        conn.outstanding.pop(tid, None)
                        conn.deadlines.pop(tid, None)
                        if id(fut) in issued:
                            requeue.append((tid, fut))
                        else:
                            self._adopted.pop(tag, None)
                for tid, fut in requeue:
                    _fail_future(fut, WorkerLostError(
                        f"adopted task {tid} from the prior epoch never "
                        "replayed a result inside the takeover window; "
                        "requeueing as worker loss"
                    ))
                if requeue:
                    logger.warning(
                        "takeover window closed: requeued %d adopted "
                        "task(s) with no replayed result", len(requeue),
                    )

    def _count_frame(self, direction: str, mtype, nbytes: int) -> None:
        """Fold one link frame into the per-message-type breakdown and the
        registry's coordinator-link counters (frames + bytes, per
        direction). Lock-free on purpose: a racing increment can lose one
        count, which diagnostics tolerate and the dispatch path's latency
        budget appreciates."""
        bucket = self._frame_counts[direction]
        key = str(mtype or "unknown")
        row = bucket.get(key)
        if row is None:
            if len(bucket) >= 32:
                key, row = "other", bucket.get("other")
            if row is None:
                row = bucket[key] = [0, 0]
        row[0] += 1
        row[1] += nbytes
        reg = get_registry()
        if direction == "sent":
            reg.counter("coord_frames_sent").inc()
            reg.counter("coord_frame_bytes_sent").inc(nbytes)
        else:
            reg.counter("coord_frames_recv").inc()
            reg.counter("coord_frame_bytes_recv").inc(nbytes)

    def _recv_loop(self, conn: _WorkerConn, sock, gen: int) -> None:
        try:
            while conn.alive:
                msg = recv_frame(sock)
                # the ledger's deserialize stamp: recv_frame times its
                # payload.loads on THIS thread (see _recv_timing)
                unpickle_s = getattr(_recv_timing, "unpickle_s", 0.0)
                if not isinstance(msg, dict):
                    raise CorruptFrameError(
                        f"non-dict frame from {conn.name}: "
                        f"{type(msg).__name__}"
                    )
                self._count_frame(
                    "recv", msg.get("type"),
                    getattr(_recv_timing, "nbytes", 0),
                )
                get_registry().counter(
                    "dispatch_unpickle_s"
                ).inc(unpickle_s)
                fepoch = msg.get("epoch")
                if fepoch is not None and int(fepoch) != self.epoch:
                    # a frame stamped by another coordinator incarnation:
                    # fence it — neither applied NOR acked, since an ack
                    # under this epoch would clear an outbox frame the
                    # epoch that owns it never processed
                    with self._lock:
                        self.stats["stale_epoch_frames"] += 1
                    get_registry().counter("stale_epoch_frames").inc()
                    logger.warning(
                        "fenced stale-epoch frame from %s (frame epoch "
                        "%s, ours %d)", conn.name, fepoch, self.epoch,
                    )
                    continue
                with self._lock:
                    if conn.generation != gen:
                        return  # a reconnect superseded this socket
                    # any frame from a connected worker renews its lease
                    conn.lease_deadline = time.monotonic() + self.lease_s
                seq = msg.get("seq")
                if seq is not None:
                    with self._lock:
                        dup = seq <= conn.last_seq
                        if not dup:
                            conn.last_seq = seq
                    if dup:
                        # an outbox replay (or injected duplication) of a
                        # message already applied: never process twice.
                        # Counted BEFORE the ack goes out — the ack is the
                        # observable "fully processed" signal, so anything
                        # the frame implies (this counter) must be done
                        # when a peer sees it
                        get_registry().counter(
                            "fleet_messages_deduped"
                        ).inc()
                    # ack even a duplicate: the ack for the original may be
                    # the very frame the partition ate
                    try:
                        send_frame(
                            conn.sock,
                            {"type": "ack", "seq": seq, "epoch": self.epoch},
                            conn.send_lock,
                        )
                    except (ConnectionError, OSError):
                        pass  # recv will notice the dead socket
                    if dup:
                        continue
                mtype = msg.get("type")
                if mtype in ("result", "error"):
                    produced = msg.get("produced")
                    if produced:
                        # the producer's advertisement piggybacks on the
                        # (sequenced, deduped) result frame: record BEFORE
                        # the future resolves so a consumer dispatched by
                        # this completion can already locate the bytes
                        self.chunk_registry.record(conn.name, produced)
                        if self._control is not None:
                            self._control.record_chunk_locations(
                                conn.name, produced
                            )
                    with self._lock:
                        fut = conn.outstanding.pop(msg["task_id"], None)
                        conn.deadlines.pop(msg["task_id"], None)
                        conn.timeout_strikes = 0  # it is producing results
                        # a ghost (started-then-timed-out task) finished:
                        # its thread is usable again
                        conn.ghost_ids.discard(msg["task_id"])
                    if fut is None or fut.done():
                        continue  # duplicate/late reply, or a cancelled twin
                    if self._control is not None:
                        # flushed, not fsync'd: losing this line costs one
                        # idempotent re-run after the NEXT takeover, never
                        # correctness
                        self._control.record_done(msg["task_id"])
                    if mtype == "result":
                        stats = msg.get("stats", {}) or {}
                        disp = getattr(fut, "_dispatch", None)
                        if disp is not None:
                            # complete the coordinator side of the ledger:
                            # submit() stamped serialize/send/lock-wait on
                            # this future; the receive side adds the
                            # result-arrival stamp and unpickle cost, and
                            # the whole dict rides the existing stats
                            # channel to map_unordered's success path
                            stats = dict(stats)
                            stats["dispatch"] = dict(
                                disp,
                                result_recv_tstamp=time.time(),
                                unpickle_s=unpickle_s,
                            )
                        try:
                            fut.set_result((msg.get("result"), stats))
                        except Exception:
                            pass  # cancelled concurrently (losing twin)
                    else:
                        err = RemoteTaskError(
                            msg.get("error", ""),
                            msg.get("error_type"),
                            msg.get("error_payload"),
                        )
                        task_stats = msg.get("task_stats")
                        if task_stats:
                            # the failed attempt's salvaged span buffer
                            # (collect.record_failed_task reads it off the
                            # exception on the client side)
                            err.cubed_tpu_torch_task_stats = task_stats
                        _fail_future(fut, err)
                elif mtype == "started":
                    # execution begins now: restart the timeout clock and
                    # make a subsequent timeout count as a real hang
                    if self.task_timeout is not None:
                        with self._lock:
                            entry = conn.deadlines.get(msg["task_id"])
                            if entry is not None:
                                entry[0] = time.monotonic() + self.task_timeout
                                entry[1] = True
                elif mtype == "heartbeat":
                    # the worker's own memory telemetry: last RSS reading
                    # plus its local pressure verdict (watermarks evaluated
                    # where the memory actually is); routing skips
                    # pressured workers while an unpressured one is live
                    if msg.get("peer_cache_flush"):
                        # the worker's cache emptied (hard pressure): its
                        # advertised locations are all stale now
                        self.chunk_registry.drop_worker(conn.name)
                    elif msg.get("peer_evicted"):
                        self.chunk_registry.remove(
                            conn.name, msg["peer_evicted"]
                        )
                    delta = msg.get("metrics_delta")
                    with self._lock:
                        conn.rss = msg.get("rss")
                        conn.pressured = bool(msg.get("pressured"))
                        if msg.get("peer_cache") is not None:
                            conn.peer_cache = msg["peer_cache"]
                        if msg.get("clock_offset") is not None:
                            conn.clock_offset = msg["clock_offset"]
                            conn.clock_rtt = msg.get("clock_rtt")
                        if isinstance(delta, dict):
                            # bounded per-window counter deltas shipped by
                            # the worker: fold into the per-worker and the
                            # fleet-wide cumulative views the telemetry
                            # sampler reads (heartbeats are lossy by
                            # design — a dropped frame costs one window's
                            # increments, never correctness: the
                            # authoritative per-compute numbers still ride
                            # the task result stats)
                            for k, v in delta.items():
                                if isinstance(v, (int, float)):
                                    conn.metrics[k] = (
                                        conn.metrics.get(k, 0) + v
                                    )
                                    self.fleet_metrics[k] = (
                                        self.fleet_metrics.get(k, 0) + v
                                    )
                    if isinstance(delta, dict):
                        get_registry().counter(
                            "heartbeat_metric_deltas"
                        ).inc()
                    if conn.rss is not None:
                        get_registry().gauge("fleet_worker_rss_bytes").set(
                            conn.rss
                        )
                        # worker memory telemetry feeds the merged trace's
                        # per-worker memory lane client-side (the worker's
                        # own sampler ring never crosses the process
                        # boundary) — stamped at receipt on the client
                        # clock, so no alignment needed
                        from ..observability.collect import record_sample

                        record_sample(rss=conn.rss, worker=conn.name)
                    if msg.get("t0") is not None:
                        # clock handshake: echo the worker's send timestamp
                        # with our own receipt time — the worker computes an
                        # NTP-style offset from the pair and ships it back
                        # on the next heartbeat (and immediately via a
                        # "clock" message, so even sub-second computes have
                        # aligned worker spans)
                        try:
                            send_frame(
                                conn.sock,
                                {
                                    "type": "heartbeat_echo",
                                    "t0": msg["t0"],
                                    "t_coord": time.time(),
                                    "epoch": self.epoch,
                                },
                                conn.send_lock,
                            )
                        except (ConnectionError, OSError):
                            pass  # recv will notice the dead socket
                elif mtype == "clock":
                    with self._lock:
                        conn.clock_offset = msg.get("clock_offset")
                        conn.clock_rtt = msg.get("clock_rtt")
                elif mtype == "draining":
                    # the worker stops accepting work NOW (scale-down drain
                    # or a spot preemption notice); routing passes it over,
                    # in-flight tasks finish or come back as "abandoned"
                    from ..observability.collect import record_decision

                    reason = msg.get("reason") or "drain"
                    with self._lock:
                        conn.draining = True
                        if reason == "preempted":
                            self.stats["workers_preempted"] += 1
                    if reason == "preempted":
                        get_registry().counter("workers_preempted").inc()
                    record_decision(
                        "worker_draining", worker=conn.name, reason=reason,
                        grace_s=msg.get("grace_s"),
                    )
                    logger.info(
                        "worker %s draining (%s, grace %.3fs)",
                        conn.name, reason, msg.get("grace_s", 0) or 0,
                    )
                elif mtype == "abandoned":
                    # a task that reached a draining worker before routing
                    # noticed: handed back unexecuted — a free requeue
                    with self._lock:
                        fut = conn.outstanding.pop(msg["task_id"], None)
                        conn.deadlines.pop(msg["task_id"], None)
                        conn.ghost_ids.discard(msg["task_id"])
                    if fut is not None:
                        with self._lock:
                            self.stats["tasks_abandoned_on_drain"] += 1
                        get_registry().counter("tasks_abandoned_on_drain").inc()
                        _fail_future(
                            fut,
                            WorkerDrainedError(
                                f"worker {conn.name} draining: task "
                                f"{msg['task_id']} abandoned before start"
                            ),
                        )
                elif mtype == "drained":
                    self._on_drained(conn, msg)
                    return  # the worker closes its socket right after
                elif mtype == "chunk_locate":
                    # the peer-fetch lookup RPC: name + dialable address of
                    # the worker whose cache holds this chunk (None when
                    # unknown, departed, or currently disconnected — the
                    # reader then goes straight to the store)
                    wname = self.chunk_registry.locate(
                        msg.get("store"), msg.get("key")
                    )
                    peer_addr = None
                    if wname is not None:
                        with self._lock:
                            target = next(
                                (
                                    w for w in self._workers
                                    if w.alive and w.connected
                                    and w.name == wname
                                ),
                                None,
                            )
                            peer_addr = (
                                target.peer_addr if target is not None
                                else None
                            )
                    with self._lock:
                        self.stats["peer_locate_requests"] += 1
                    get_registry().counter("peer_locate_requests").inc()
                    try:
                        send_frame(conn.sock, {
                            "type": "chunk_location",
                            "req_id": msg.get("req_id"),
                            "worker": wname if peer_addr is not None else None,
                            "addr": peer_addr,
                            "epoch": self.epoch,
                        }, conn.send_lock)
                    except (ConnectionError, OSError):
                        pass  # the reader's locate times out -> store read
                elif mtype == "blob_dropped":
                    # the worker evicted this blob from its bounded caches;
                    # forget we sent it so the next task of that op
                    # re-ships the bytes (a task already in flight when the
                    # eviction raced it fails with unknown-blob and heals
                    # through the normal retry -> resend path)
                    with self._lock:
                        conn.blobs_sent.discard(msg.get("blob_id"))
                else:
                    logger.warning("unknown message from %s: %r", conn.name, mtype)
        except CorruptFrameError as e:
            # a torn/garbage frame desynchronizes the stream: count it,
            # drop THIS connection cleanly, and let the lease decide what
            # the peer's silence means — never kill the recv thread
            with self._lock:
                self.stats["frames_corrupt"] += 1
            get_registry().counter("frames_corrupt").inc()
            logger.warning(
                "corrupt frame from worker %s: %s — dropping the "
                "connection", conn.name, e,
            )
            if not self._closed.is_set():
                self._on_disconnect(conn, f"corrupt frame: {e}", gen=gen)
        except (ConnectionError, OSError) as e:
            if not self._closed.is_set():
                self._on_disconnect(
                    conn, str(e) or type(e).__name__, gen=gen
                )
        except Exception:
            logger.exception("receiver for %s crashed", conn.name)
            self._on_disconnect(conn, "receiver crash", gen=gen)

    def _on_drained(self, conn: _WorkerConn, msg: dict) -> None:
        """A worker finished its drain: fail its abandoned in-flight tasks
        with ``WorkerDrainedError`` (free requeue), count the drain, and
        remove the worker cleanly (not a ``workers_lost``)."""
        from ..observability.collect import record_decision

        reason = msg.get("reason") or "drain"
        abandoned = list(msg.get("abandoned") or [])
        pairs = []
        with self._lock:
            for tid in abandoned:
                pairs.append((tid, conn.outstanding.pop(tid, None)))
                conn.deadlines.pop(tid, None)
                conn.ghost_ids.discard(tid)
        n_abandoned = 0
        for tid, fut in pairs:
            if fut is None:
                continue  # its late result won the race: nothing to requeue
            n_abandoned += 1
            _fail_future(
                fut,
                WorkerDrainedError(
                    f"worker {conn.name} drained ({reason}): in-flight task "
                    f"{tid} abandoned at the end of the drain window"
                ),
            )
        with self._lock:
            # stats increments stay under the coordinator lock: concurrent
            # per-worker recv threads (a coordinated reclaim drains many
            # workers at once) must not lose dict '+=' interleavings
            if n_abandoned:
                self.stats["tasks_abandoned_on_drain"] += n_abandoned
            self.stats["drains_completed"] += 1
        if n_abandoned:
            get_registry().counter("tasks_abandoned_on_drain").inc(n_abandoned)
        get_registry().counter("drains_completed").inc()
        record_decision(
            "worker_drained", worker=conn.name, reason=reason,
            abandoned=n_abandoned,
        )
        self._drop_worker(conn, f"drained ({reason})", clean=True)

    def request_drain(
        self, name: str, grace_s: float = 30.0, reason: str = "scale_down"
    ) -> bool:
        """Ask worker ``name`` to drain: stop accepting tasks, finish (or
        abandon) in-flight work within ``grace_s``, report ``drained`` and
        leave. Routing passes the worker over from this call on. Returns
        False when no live worker has that name (already gone)."""
        from ..observability.collect import record_decision

        with self._lock:
            conn = next(
                (
                    w for w in self._workers
                    if w.alive and w.connected and w.name == name
                ),
                None,
            )
            if conn is None:
                return False  # gone, or disconnected (a drain can't reach it)
            conn.draining = True  # stop routing immediately, not on the ack
        try:
            send_frame(
                conn.sock,
                {"type": "drain", "grace_s": grace_s, "reason": reason,
                 "epoch": self.epoch},
                conn.send_lock,
            )
        except (ConnectionError, OSError) as e:
            self._drop_worker(conn, f"drain send failed: {e}")
            return False
        record_decision(
            "worker_drain_requested", worker=name, reason=reason,
            grace_s=grace_s,
        )
        return True

    def known_worker_names(self) -> set:
        """Every worker name that ever joined (live or departed)."""
        with self._lock:
            return set(self._worker_names_ever)

    def load_view(self) -> list:
        """Per-worker load rows for the autoscaler's policy loop: one dict
        per live worker (name, draining, pressured, outstanding incl. ghost
        slots, nthreads). Cheap — one pass under the lock."""
        with self._lock:
            return [
                {
                    "name": w.name,
                    "draining": w.draining,
                    "pressured": w.pressured,
                    # disconnected-but-leased: NOT a hole to backfill (the
                    # lease may still resolve to a reconnect), but not a
                    # drain candidate either — the autoscaler reads this
                    "connected": w.connected,
                    "outstanding": len(w.outstanding) + len(w.ghost_ids),
                    "nthreads": w.nthreads,
                }
                for w in self._workers
                if w.alive
            ]

    def _timeout_loop(self) -> None:
        """Fail tasks that exceed ``task_timeout`` so the caller's retry
        machinery reroutes them; a worker that keeps timing out without
        producing any result is treated as hung and dropped (its remaining
        tasks fail with WorkerLostError and reroute too). The reference's
        fleet executors get this from their platforms' per-call timeouts."""
        interval = max(0.05, min(1.0, (self.task_timeout or 1.0) / 4))
        while not self._closed.wait(interval):
            now = time.monotonic()
            hung: list[_WorkerConn] = []
            timed_out: list[tuple[Future, str, int]] = []
            with self._lock:
                for conn in self._workers:
                    if not conn.connected:
                        # a partitioned-but-leased worker cannot deliver
                        # results; the LEASE governs its tasks, not the
                        # task timeout — freeze their clocks so a
                        # reconnect resumes them with a full window, and
                        # never count a partition as a hang
                        for entry in conn.deadlines.values():
                            entry[0] = now + self.task_timeout
                        continue
                    overdue = [
                        (tid, entry[1])
                        for tid, entry in conn.deadlines.items()
                        if entry[0] < now
                    ]
                    for tid, started in overdue:
                        fut = conn.outstanding.pop(tid, None)
                        conn.deadlines.pop(tid, None)
                        if started:
                            conn.ghost_ids.add(tid)
                        if fut is not None and not fut.done():
                            timed_out.append((fut, conn.name, tid))
                    if overdue:
                        self.stats["task_timeouts"] += len(overdue)
                        get_registry().counter("task_timeouts").inc(len(overdue))
                        # only tasks the worker acked as started count as
                        # hangs; queued/cold-start timeouts just reroute
                        conn.timeout_strikes += sum(
                            1 for _, started in overdue if started
                        )
                        if conn.timeout_strikes >= self.timeout_strikes:
                            hung.append(conn)
            for fut, wname, tid in timed_out:
                _fail_future(
                    fut,
                    TaskTimeoutError(
                        f"task {tid} exceeded {self.task_timeout}s on "
                        f"worker {wname}"
                    ),
                )
            for conn in hung:
                self._drop_worker(
                    conn, f"hung: {conn.timeout_strikes} consecutive timeouts"
                )

    # -- task submission -----------------------------------------------

    def _blob_for(self, function, config) -> tuple[str, bytes]:
        # the cached value keeps (function, config) alive so the id()-pair
        # key can never be reused by a different object while the entry
        # lives (bytes must stay resendable: workers joining later, or
        # losing tasks to a crash, receive the blob on their first task of
        # that op); eviction is safe because a miss just re-pickles
        key = (id(function), id(config))
        hit = self._blob_cache.get(key)
        if hit is not None:
            self._blob_cache.move_to_end(key)
            return hit[2], hit[3]
        blob = payload.dumps((function, config))
        blob_id = hashlib.sha1(blob).hexdigest()
        self._blob_cache[key] = (function, config, blob_id, blob)
        while len(self._blob_cache) > self._blob_cache_size:
            self._blob_cache.popitem(last=False)
        return blob_id, blob

    def submit(
        self, _stats_wrapper, function, task_input, *, config=None,
        locality=None, tag=None,
    ) -> Future:
        """Ship one task to the least-loaded live worker — or, when
        ``locality`` names the task's input chunks ``[(store, key), ...]``
        and peer transfer is on, to the non-pressured worker already
        holding the most of those bytes in its chunk cache (within a load
        slack of the least-loaded; see ``transfer.pick_worker_by_locality``).

        The first positional argument exists to mirror
        ``pool.submit(execute_with_stats, function, input, config=...)``; the
        wrapper always runs worker-side.

        ``tag`` is the task's durable ``(op, chunk-key)`` identity. After a
        coordinator takeover, a submit whose tag matches a dispatch adopted
        from the prior epoch returns the adopted future — the worker may
        still be running that task (or its replayed result already resolved
        it), so re-dispatching would re-run completed work.
        """
        if tag is not None and self._adopted:
            with self._lock:
                adopted = self._adopted.pop(tuple(tag), None)
                if adopted is not None:
                    self.stats["tasks_readopted"] += 1
                    self._adopted_issued.append(adopted)
            if adopted is not None:
                get_registry().counter("tasks_readopted").inc()
                return adopted
        # dispatch ledger: zero the hot-lock accumulator for THIS submit,
        # and fold the op-blob pickle (cached after first use) into the
        # serialize cost — submit runs inline on the dispatch loop, so
        # everything timed here is coordinator overhead by definition
        self._lock.reset_thread_wait()
        t_blob = time.perf_counter()
        blob_id, blob = self._blob_for(function, config)
        blob_cost = time.perf_counter() - t_blob
        fut: Future = Future()
        # routing may need a second try if a send races a worker death
        while True:
            with self._lock:
                live = [w for w in self._workers if w.alive and w.connected]
                if (
                    not live
                    and any(w.alive for w in self._workers)
                    and not self._closed.is_set()
                ):
                    # every worker is disconnected-but-leased (a fleet-wide
                    # partition): they are not lost yet — wait for a
                    # reconnect, or for the leases to resolve the question
                    self._worker_joined.wait_for(
                        lambda: any(
                            w.alive and w.connected for w in self._workers
                        )
                        or not any(w.alive for w in self._workers)
                        or self._closed.is_set(),
                        timeout=self.lease_s,
                    )
                    live = [
                        w for w in self._workers if w.alive and w.connected
                    ]
                if (
                    not live
                    and self.backfill_grace_s > 0
                    and self._workers_ever > 0
                    and not self._closed.is_set()
                ):
                    # an attached autoscaler owes the fleet a replacement
                    # (e.g. the LAST worker was preempted/drained and the
                    # backfill subprocess is still booting): wait for it to
                    # register instead of failing the compute the drain
                    # protocol promised to protect
                    self._worker_joined.wait_for(
                        lambda: any(
                            w.alive and w.connected for w in self._workers
                        )
                        or self._closed.is_set(),
                        timeout=self.backfill_grace_s,
                    )
                    live = [
                        w for w in self._workers if w.alive and w.connected
                    ]
                if not live:
                    host, port = self.address
                    ever = self._workers_ever
                    lost = self.stats["workers_lost"]
                    if ever == 0:
                        hint = (
                            "no worker ever connected — start workers with "
                            "'python -m cubed_tpu_torch.runtime.worker "
                            f"{host}:{port}' on each host (or use "
                            "n_local_workers/min_workers so the executor "
                            "waits for them before submitting)"
                        )
                    else:
                        hint = (
                            f"{ever} worker(s) joined over this "
                            f"coordinator's lifetime and {lost} were lost "
                            "(crash/hang/shutdown) — check worker logs, "
                            "task_timeout, and host health"
                        )
                    raise NoWorkersError(
                        f"cannot submit task: no live workers connected to "
                        f"coordinator {host}:{port} (epoch {self.epoch}); "
                        f"{hint}"
                    )
                if (
                    self.backfill_grace_s > 0
                    and not self._closed.is_set()
                    and all(w.draining for w in live)
                ):
                    # every live worker is draining (a coordinated spot
                    # reclaim hit the whole fleet): routing to a drainer
                    # is an instant abandon->requeue ping-pong that burns
                    # the free requeue allowance in milliseconds — far
                    # faster than any replacement can boot. Wait for the
                    # backfill to register; drainers remain the fallback
                    # if none arrives within the grace window.
                    self._worker_joined.wait_for(
                        lambda: any(
                            w.alive and w.connected and not w.draining
                            for w in self._workers
                        )
                        or self._closed.is_set(),
                        timeout=self.backfill_grace_s,
                    )
                    live = [
                        w for w in self._workers if w.alive and w.connected
                    ]
                    if not live:
                        continue  # drainers gone: the no-live path decides
                # draining workers are passed over while any non-draining
                # one is live (an all-draining fleet still takes the task:
                # it may be abandoned and requeued, which beats failing the
                # compute outright when no replacement can come)
                active = [w for w in live if not w.draining] or live
                # memory-pressured workers are passed over while any
                # unpressured one is live (never deadlock: an all-pressured
                # fleet still gets the least-loaded worker — the admission
                # controller is what sheds load in that state)
                unpressured = [w for w in active if not w.pressured]
                if unpressured and len(unpressured) < len(active):
                    get_registry().counter("dispatch_skipped_pressured").inc()
                candidates = unpressured or active

                def _load(w):
                    return (
                        len(w.outstanding) + len(w.ghost_ids)
                    ) / max(w.nthreads, 1)

                conn = None
                if locality and len(candidates) > 1:
                    # locality-aware placement: prefer the (non-pressured —
                    # an all-pressured fleet falls through to candidates,
                    # where load wins) worker whose chunk cache already
                    # holds the most input bytes
                    resident = self.chunk_registry.resident_bytes(locality)
                    conn = pick_worker_by_locality(
                        candidates, resident, _load
                    )
                    if conn is not None:
                        self.stats["placement_locality_hits"] += 1
                        get_registry().counter(
                            "placement_locality_hits"
                        ).inc()
                        if self._locality_decisions_left > 0:
                            self._locality_decisions_left -= 1
                            locality_note = (
                                conn.name, resident.get(conn.name, 0)
                            )
                        else:
                            locality_note = None
                    else:
                        locality_note = None
                else:
                    locality_note = None
                if conn is None:
                    conn = min(candidates, key=_load)
                task_id = self._next_task_id
                self._next_task_id += 1
                conn.outstanding[task_id] = fut
                first_use = blob_id not in conn.blobs_sent
                if self.task_timeout is not None:
                    # registered BEFORE the send, under the same lock as
                    # outstanding: a fast worker's 'started' ack must find
                    # the entry (racing it would permanently mark the task
                    # cold-start and exempt a real hang from eviction)
                    conn.deadlines[task_id] = [
                        time.monotonic() + self.task_timeout, False
                    ]
            from ..observability import accounting, logs
            from ..observability.collect import record_decision
            from ..storage import integrity
            from . import cancellation as cancel_mod
            from . import memory
            from . import transfer as p2p
            from .faults import get_injector, wire_config

            if locality_note is not None:
                record_decision(
                    "placement_locality", worker=locality_note[0],
                    resident_bytes=locality_note[1], task_id=task_id,
                )
            msg = {
                "type": "task",
                "task_id": task_id,
                "epoch": self.epoch,
                "blob_id": blob_id,
                "blob": blob if first_use else None,
                "input": task_input,
                # the client's compute id rides with every task so worker
                # log lines/spans correlate to the compute that asked
                "compute_id": logs.current_compute_id(),
                # ack execution start only when someone is watching the clock
                "ack": self.task_timeout is not None,
                # the client's fault-injection arming state rides with every
                # task: workers mirror it exactly (pre-started fleets still
                # inject; disarming propagates instead of lingering in
                # spawn-time env), see faults.wire_config
                "faults": wire_config(),
                # the client's integrity mode rides the same way, so a
                # pre-started fleet verifies (or not) exactly as the client
                # asked for THIS compute
                "integrity": integrity.wire_mode(),
                # ... as does the memory-guard config (mode + allowed_mem),
                # so workers enforce the same per-task budget the client's
                # Spec promised
                "memory_guard": memory.wire_config(),
                # ... and the span-recording arming: workers buffer/ship
                # spans exactly when the client has a collector to merge
                # them, and stop when it doesn't
                "spans": accounting.spans_wire(),
                # ... and the peer-transfer arming (None = off, which also
                # disarms a pre-started worker a previous compute enabled):
                # workers cache/advertise/fetch exactly when this compute
                # asked for the p2p data plane
                "peer": p2p.wire_config(),
                # ... and the compute's cancellation token (deadline epoch
                # + cancelled flag, None = unbounded): workers abort
                # cooperatively between chunk reads/writes the moment it
                # trips — read per submit, so a cancel mid-compute rides
                # every later task message even if the broadcast was lost
                "cancel": cancel_mod.wire_for_compute(
                    logs.current_compute_id()
                ),
            }
            try:
                # serialize and send timed separately: pickle time vs
                # socket time are different saturation stories (batch the
                # frame build vs shard the link), so the ledger keeps them
                # apart
                t_ser = time.perf_counter()
                data = frame_bytes(msg)
                serialize_s = blob_cost + time.perf_counter() - t_ser
                t_send = time.perf_counter()
                with conn.send_lock:
                    conn.sock.sendall(data)
                send_s = time.perf_counter() - t_send
            except (ConnectionError, OSError) as e:
                with self._lock:
                    conn.outstanding.pop(task_id, None)
                    conn.deadlines.pop(task_id, None)
                # a failed send means the socket is dead, not the worker:
                # lease rules decide its fate while this task re-routes
                self._on_disconnect(conn, f"send failed: {e}")
                continue  # pick another worker for the same future
            except Exception:
                # e.g. an unpicklable task input: the worker never saw the
                # message, so only this submission's bookkeeping rolls back
                with self._lock:
                    conn.outstanding.pop(task_id, None)
                    conn.deadlines.pop(task_id, None)
                raise
            # coordinator half of the dispatch ledger, attached to the
            # future the instant the send lands (the recv loop merges it
            # into the result's stats; a reply racing this attribute set
            # just ships without a ledger — it stays Optional end to end)
            fut._dispatch = {
                "serialize_s": serialize_s,
                "send_s": send_s,
                "lock_wait_s": self._lock.thread_wait_s(),
                "sent_tstamp": time.time(),
            }
            self._count_frame("sent", "task", len(data))
            reg = get_registry()
            reg.counter("dispatch_serialize_s").inc(serialize_s)
            reg.counter("dispatch_send_s").inc(send_s)
            with self._lock:
                # only mark the blob delivered once the send has succeeded
                conn.blobs_sent.add(blob_id)
                conn.tasks_sent += 1
            self.stats["tasks_sent"] += 1
            if first_use:
                self.stats["blobs_sent"] += 1
            if self._control is not None and tag is not None:
                # the dispatch-frontier record a successor folds: which
                # (op, chunk-key) was in flight where (flushed — a lost
                # line costs one idempotent re-run; untagged tasks have no
                # durable identity to readopt, so they aren't recorded)
                self._control.record_dispatch(task_id, tag, conn.name)
            inj = get_injector()
            if inj is not None and inj.coordinator_dispatch_tick(self.epoch):
                # chaos hook: the coordinator process hard-exits after the
                # Nth real dispatch (crash / crash-during-takeover knobs)
                logger.warning(
                    "coordinator: injected crash after dispatch %d "
                    "(epoch %d)", task_id, self.epoch,
                )
                os._exit(137)
            return fut

    def broadcast_cancel(
        self, compute_id: Optional[str], reason: Optional[str] = None
    ) -> int:
        """Send a ``compute_cancel`` frame to every connected worker so
        the fleet aborts that compute's tasks cooperatively (between
        chunk reads/writes). Best-effort by design: a worker that misses
        the frame (disconnected, mid-partition) still learns from the
        tripped token riding any later task message, and its in-flight
        results are simply discarded client-side. Returns the number of
        workers notified."""
        if not compute_id:
            return 0
        with self._lock:
            conns = [
                w for w in self._workers if w.alive and w.connected
            ]
        notified = 0
        # one frame build for the whole fleet (the payload is identical)
        data = frame_bytes({
            "type": "compute_cancel",
            "compute": compute_id,
            "reason": reason,
            "epoch": self.epoch,
        })
        for conn in conns:
            try:
                with conn.send_lock:
                    conn.sock.sendall(data)
                self._count_frame("sent", "compute_cancel", len(data))
                notified += 1
            except (ConnectionError, OSError):
                continue  # the task-message path is the backstop
        self.stats["compute_cancels_sent"] += notified
        logger.info(
            "broadcast compute_cancel for %s to %d worker(s)",
            compute_id, notified,
        )
        return notified

    def stats_snapshot(self) -> dict:
        """Counters plus a per-worker load view (outstanding tasks, ghost
        slots, lifetime tasks routed) for ``executor_stats``/debugging.
        Departed workers keep their final row (``alive: False`` + drop
        reason) so worker loss remains visible in the snapshot."""
        out: dict = dict(self.stats)
        out["epoch"] = self.epoch
        with self._lock:
            workers: dict = {name: dict(row) for name, row in self._departed.items()}
            for w in self._workers:
                workers[w.name] = {
                    "alive": w.alive,
                    "connected": w.connected,
                    "epoch": w.joined_epoch,
                    "nthreads": w.nthreads,
                    "outstanding": len(w.outstanding),
                    "ghosts": len(w.ghost_ids),
                    "tasks_sent": w.tasks_sent,
                    "rss": w.rss,
                    "pressured": w.pressured,
                    "draining": w.draining,
                    "clock_offset": w.clock_offset,
                    "clock_rtt": w.clock_rtt,
                    "peer_cache": w.peer_cache,
                    "metrics": dict(w.metrics) or None,
                }
        out["workers"] = workers
        out["chunk_locations"] = self.chunk_registry.stats()
        with self._lock:
            out["fleet_metrics"] = dict(self.fleet_metrics) or None
        # per-message-type link traffic ({direction: {type: [frames,
        # bytes]}}) — the DISPATCH panel's frame breakdown
        out["frames"] = {
            d: {k: list(v) for k, v in rows.items()}
            for d, rows in self._frame_counts.items()
        }
        return out

    def close(self) -> None:
        from ..observability.timeseries import unregister_fleet

        unregister_fleet(self)
        self._closed.set()
        with self._lock:
            workers = list(self._workers)
            # wake any submit() blocked on a backfill wait: closed wins
            self._worker_joined.notify_all()
        for conn in workers:
            if conn.sock is not None:
                try:
                    send_frame(
                        conn.sock,
                        {"type": "shutdown", "epoch": self.epoch},
                        conn.send_lock,
                    )
                except (ConnectionError, OSError):
                    pass
            self._drop_worker(conn, "shutdown")
        if self._control_sink is not None:
            from ..observability.collect import remove_decision_sink

            remove_decision_sink(self._control_sink)
            self._control_sink = None
        if self._control is not None:
            self._control.close()
        try:
            self._server.close()
        except OSError:
            pass


# ----------------------------------------------------------------------
# worker side
# ----------------------------------------------------------------------


#: unacked important messages a worker retains for replay across reconnects;
#: beyond this the OLDEST is dropped (counted) — results live in the shared
#: store anyway, so a dropped result frame costs a requeue, never data
OUTBOX_CAP = 256

#: worker stale-link watchdog thresholds. A healthy link echoes every 1s
#: heartbeat and acks important frames within ~RTT, so silence past these
#: windows reads as a half-open link and forces a reconnect. Known
#: limitation: progress is measured per COMPLETE frame, so a single frame
#: whose transfer legitimately exceeds the window (a huge op blob on a
#: very slow link) would be cut and retransmitted from zero — the control
#: plane ships kilobyte-scale frames by design (blobs once per worker, data
#: through Zarr), but blob-heavy deployments on constrained links should
#: raise these
RX_STALE_S = 4.0
ACK_STALE_S = 1.5

#: task-scope counters additionally folded into the WORKER's own registry
#: (so the heartbeat metrics_delta carries a live per-worker view of
#: them); bounded allowlist — scoped counters already reach the CLIENT
#: registry via task stats, this fold only feeds the worker-side telemetry
#: dimension and never crosses into client metrics
_WORKER_FOLD_COUNTERS = (
    "peer_hits", "peer_misses", "chunks_verified",
    "chunks_corrupt_detected", "store_throttled",
)

#: cap on the per-heartbeat metrics-delta payload (numeric keys): the
#: heartbeat frame must stay kilobyte-scale whatever the metric namespace
#: grows to; overflow keys are dropped deterministically (sorted order)
#: and the drop is itself counted in the shipped delta
HEARTBEAT_DELTA_MAX_KEYS = 64


def heartbeat_metrics_delta(reg, prev_snapshot: dict) -> tuple:
    """The bounded worker->coordinator metrics payload for one heartbeat.

    Returns ``(delta_dict_or_None, new_snapshot)``: numeric per-window
    increments only (histogram windows and gauge ``_max`` marks stay out
    — ``snapshot_delta`` already windowed gauges away, counting them in
    ``gauges_dropped_in_delta``, which DOES ship so a fleet gauge can
    never vanish silently), zero increments elided, at most
    ``HEARTBEAT_DELTA_MAX_KEYS`` keys. The delta and the returned new
    baseline are the SAME snapshot observation — two separate snapshots
    would ship increments landing between them twice."""
    snap = reg.snapshot()
    delta = reg.snapshot_delta(prev_snapshot, now=snap)
    out = {}
    overflow = 0
    for k in sorted(delta):
        v = delta[k]
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        if v == 0 or k.endswith("_max"):
            continue
        if len(out) >= HEARTBEAT_DELTA_MAX_KEYS:
            overflow += 1
            continue
        out[k] = v
    if overflow:
        out["heartbeat_delta_keys_dropped"] = overflow
    return (out or None), snap


class _WorkerLink:
    """The worker's side of the coordinator connection.

    Owns the socket, the monotonic ``seq`` counter, and a bounded outbox of
    unacked *important* frames (result / error / drained / abandoned —
    anything whose loss would strand coordinator state). ``send`` never
    raises for link trouble: a failed or injected-away send leaves
    important frames queued, and the reconnect path replays them in order
    (the coordinator drops duplicates by ``seq``). Seeded control-plane
    fault injection (``runtime/faults.py``: message drop / dup / delay /
    reset, one-way partition) is applied here, per frame, worker-side for
    both directions of the conversation."""

    def __init__(self, wname: str, sock: Optional[socket.socket] = None,
                 outbox_cap: int = OUTBOX_CAP):
        self.wname = wname
        self.sock = sock
        self.lock = threading.Lock()
        self.seq = 0
        #: the coordinator epoch this link last handshook under (from the
        #: hello_ack). Every outbound frame is stamped with it AT FRAME
        #: TIME, and outbox replays re-stamp — "replay the unacked outbox
        #: to the new epoch" is what lets a successor accept a result the
        #: crashed epoch dispatched. Inbound frames with an OLDER epoch
        #: (a zombie prior coordinator) are fenced by the recv loop
        self.epoch = 0
        #: (seq, enqueue-monotonic, message dict) — dicts, not frames, so
        #: a replay can re-stamp the current epoch; enqueue times are
        #: refreshed at replay so the staleness watchdog measures THIS
        #: link's silence
        self.outbox: deque = deque()
        self.outbox_cap = int(outbox_cap)
        #: monotonic time of the last frame actually delivered to us —
        #: the heartbeat watchdog reconnects when it goes stale
        self.last_rx = time.monotonic()
        #: session token from the coordinator's hello_ack; presenting it on
        #: reconnect is what re-adopts our in-flight leases
        self.token: Optional[str] = None
        #: the coordinator's advertised lease window (reconnect sizing hint)
        self.lease_hint: Optional[float] = None

    def held_task_ids(self) -> set:
        """Task ids named by an unacked important frame in the outbox:
        a replay will re-deliver their result/error/abandoned outcome, so
        the coordinator may keep waiting on them."""
        with self.lock:
            return {
                m["task_id"] for (_s, _t, m) in self.outbox
                if "task_id" in m
            }

    def send(self, msg: dict, important: bool = False) -> bool:
        """Frame and send one message. Important frames are sequenced and
        retained until acked. False = the link is down (important frames
        stay queued for replay); pickling errors propagate to the caller
        BEFORE anything is queued."""
        from .faults import get_injector

        inj = get_injector()
        with self.lock:
            if important:
                self.seq += 1
                msg = dict(msg, seq=self.seq)
            data = frame_bytes(dict(msg, epoch=self.epoch))
            if important:
                self.outbox.append((self.seq, time.monotonic(), msg))
                while len(self.outbox) > self.outbox_cap:
                    self.outbox.popleft()
                    get_registry().counter("outbox_dropped").inc()
            sock = self.sock
            if sock is None:
                return False
            act = None
            if inj is not None:
                if inj.partitioned(self.wname, "tx"):
                    # the wire ate it; important frames await the replay
                    return True
                act = inj.net_fault("tx", self.wname, msg.get("type"))
                if act == "drop":
                    return True
                if act == "reset":
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return False
                if act == "delay":
                    time.sleep(inj.config.net_msg_delay_s)
            try:
                sock.sendall(data)
                if act == "dup":
                    sock.sendall(data)
                return True
            except (ConnectionError, OSError):
                return False

    def on_ack(self, seq: Optional[int]) -> None:
        """The coordinator acknowledged everything up to ``seq``."""
        if seq is None:
            return
        with self.lock:
            while self.outbox and self.outbox[0][0] <= seq:
                self.outbox.popleft()

    def unacked_age(self) -> float:
        """Seconds the oldest unacked important frame has been waiting on
        THIS link (0.0 with an empty outbox) — the half-open-link signal."""
        with self.lock:
            if not self.outbox:
                return 0.0
            return time.monotonic() - self.outbox[0][1]

    def adopt(self, sock: socket.socket, token: Optional[str],
              resumed: bool) -> None:
        """Install a freshly handshaken socket. ``resumed=False`` means the
        coordinator registered us as a NEW session (our old lease is gone,
        its tasks were requeued): the outbox is cleared — replaying results
        nobody is waiting for would only be deduped anyway. ``True``
        replays every unacked frame in order. Raises on replay failure (the
        caller treats it as a failed reconnect attempt)."""
        now = time.monotonic()
        with self.lock:
            self.token = token
            if not resumed:
                self.outbox.clear()
            # refresh enqueue stamps: the watchdog must measure the NEW
            # link's progress, not how long the partition lasted
            self.outbox = deque(
                (seq, now, msg) for seq, _t, msg in self.outbox
            )
            for _seq, _t, msg in self.outbox:
                # re-stamped with the CURRENT epoch: a successor fences
                # frames from the epoch that dispatched these tasks, so a
                # replay must speak the epoch it handshook
                sock.sendall(frame_bytes(dict(msg, epoch=self.epoch)))
            self.sock = sock
        self.last_rx = now


def _give_up_message(
    wname: str, endpoint: str, epoch: int, waited_s: float,
    rendezvous: Optional[str] = None,
) -> str:
    """The worker's reconnect-give-up diagnostic. A worker used to die of
    a bare socket error here, which is undebuggable from its own log —
    name the coordinator endpoint and the last epoch this worker was
    joined under, plus a ``NoWorkersError``-style hint table."""
    lines = [
        f"worker {wname!r}: could not reach the coordinator at {endpoint} "
        f"(last epoch {epoch}) for {waited_s:.0f}s; giving up.",
        "Likely causes: the coordinator process crashed or was killed "
        "(check its log / exit code)",
        f"the coordinator host or network path is down (try dialing "
        f"{endpoint} from this host)",
    ]
    if rendezvous:
        lines.append(
            f"no successor advertised a takeover in {rendezvous!r} — if a "
            "replacement coordinator is expected, check that it runs with "
            "the same control_dir"
        )
    else:
        lines.append(
            "no rendezvous file is configured (--rendezvous), so a "
            "restarted coordinator cannot re-adopt this worker"
        )
    lines.append(
        "raise --reconnect-give-up if the control plane can legitimately "
        "stay dark longer than this window"
    )
    return "; ".join(lines)


def run_worker(
    coordinator: str,
    nthreads: int = 1,
    name: Optional[str] = None,
    drain_grace_s: float = 10.0,
    reconnect_give_up_s: float = 30.0,
    rendezvous: Optional[str] = None,
    device: Optional[str] = None,
) -> None:
    """Connect to ``host:port`` and execute tasks until shutdown/EOF.

    One process per host or per card; ``nthreads`` concurrent task slots.
    ``device`` (``"cuda"``, ``"cuda:1"``, ``"cpu"``) pins the chunk device
    before anything else runs: a worker asked for ``cuda`` without a card
    raises here and never joins, so no compute runs on a device its client
    did not choose (``None`` keeps ``CUBED_TPU_TORCH_DEVICE`` or ``cuda``).

    The worker honors a graceful **drain** (a scale-down request, or a spot
    preemption): stop accepting tasks, finish — or, at the end
    of the grace window, abandon — in-flight work, report ``drained`` with
    the abandoned task ids, and exit. ``SIGTERM`` triggers the same path
    with spot semantics (``drain_grace_s`` models the preemption notice;
    the platform's hard kill at the end of the notice is modelled by a
    hard-exit timer so a wedged task can't outlive its notice).

    A lost connection is NOT fatal: in-flight tasks keep running, result
    frames queue in a bounded outbox, and the worker reconnects —
    presenting its session token so the coordinator re-adopts its leases —
    replaying unacked frames in order. A half-open link (one-way
    partition) is detected by the heartbeat watchdog: no frames received
    for a few seconds, or an important frame unacked past its window,
    forces the same reconnect path. Only after ``reconnect_give_up_s`` of
    failed attempts does the worker exit.

    ``rendezvous`` names the coordinator's advertisement file (see
    ``runtime/journal.write_rendezvous``): the reconnect loop re-reads it
    each attempt, re-targets its dial at a successor's address, and — for
    as long as the advertisement names a NEWER epoch than the one this
    worker last joined (an open takeover window) — the give-up clock is
    suspended, so a fleet mid-takeover never dies of impatience."""
    import signal as _signal
    from concurrent.futures import ThreadPoolExecutor

    from ..observability import clock as obs_clock
    from ..observability import logs as obs_logs
    from ..observability.accounting import (
        arm_spans_from_wire,
        set_process_label,
    )
    from ..storage import integrity
    from ..utils import current_measured_mem
    from . import cancellation
    from . import memory
    from . import transfer as p2p
    from .faults import arm_from_wire, get_injector
    from .utils import chunk_key, execute_in_worker, prepare_worker_device

    # the chunk device first: a missing card fails the start, loudly
    chunk_device = prepare_worker_device(device)
    host, _, port = coordinator.rpartition(":")
    #: mutable dial target: a rendezvous advertisement re-points it at a
    #: successor coordinator's address mid-reconnect
    dial = {"host": host or "127.0.0.1", "port": int(port)}
    #: highest epoch ever seen advertised — each NEW epoch earns the
    #: reconnect loop one fresh give-up window, bounding how long a worker
    #: chases successors that never accept it
    adv_seen = {"epoch": -1}
    wname = name or f"{socket.gethostname()}:{os.getpid()}"
    #: the p2p data plane's worker half: chunk cache + serving socket. The
    #: listener is cheap and always started (its address must ride the
    #: FIRST hello, before any task message can arm fetching); the cache
    #: only fills — and fetches only happen — while a compute arms peer
    #: transfer over the wire. CUBED_TPU_TORCH_P2P=off disables it entirely.
    peer_rt: Optional[p2p.PeerRuntime] = None
    if not p2p.env_disabled():
        try:
            peer_rt = p2p.PeerRuntime(wname)
            peer_rt.start_server()
            p2p.set_worker_runtime(peer_rt)
        except OSError as e:
            logger.warning(
                "worker %s: peer chunk server failed to start (%s); "
                "running store-only", wname, e,
            )
            peer_rt = None
            p2p.set_worker_runtime(None)
    # stamp this process's task stats with the worker name (its trace lane)
    # and adopt any test-injected clock skew before the first heartbeat
    set_process_label(wname)
    obs_clock.configure_from_env(wname)
    #: latest NTP-style clock estimate from the coordinator's heartbeat
    #: echoes (coordinator_time ≈ our clock.now() + offset); "best" is the
    #: lowest rtt ever observed — the fixed quality anchor for refreshes
    clock_est: Dict[str, Optional[float]] = {
        "offset": None, "rtt": None, "best": None,
    }
    link = _WorkerLink(wname)
    if peer_rt is not None:
        # chunk_locate RPCs ride the coordinator link (non-important: a
        # lost lookup is a locate timeout, which is a store fallback)
        peer_rt.link_send = link.send
    #: task ids ever accepted, bounded: a re-delivered assignment (injected
    #: duplication, or a frame replay) must be executed at most once —
    #: idempotent task-assignment, worker-side. Cleared whenever the
    #: coordinator registers us as a NEW session: a fresh coordinator's
    #: task-id counter restarts at 0, and its ids must not collide with a
    #: dead session's
    seen_tasks: OrderedDict[int, bool] = OrderedDict()

    class _RegistrationRejected(ConnectionError):
        """The coordinator refused our hello (impostor-name rejection):
        retrying cannot succeed — give up instead of hammering it."""

    def _connect() -> None:
        """One connection attempt: TCP connect + hello/hello_ack handshake
        + outbox replay. Raises on any failure — including an active
        injected partition, which blackholes new connections exactly like
        a real one."""
        inj = get_injector()
        if inj is not None and (
            inj.partitioned(wname, "tx") or inj.partitioned(wname, "rx")
        ):
            raise ConnectionError("injected network partition")
        s = socket.create_connection(
            (dial["host"], dial["port"]), timeout=10
        )
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello = {
                "type": "hello",
                "name": wname,
                "nthreads": nthreads,
                "pid": os.getpid(),
                "device": chunk_device,
            }
            if peer_rt is not None:
                # advertise the peer server on the interface this worker
                # reaches the coordinator from — the address other fleet
                # hosts can dial
                try:
                    local_ip = s.getsockname()[0]
                except OSError:
                    local_ip = "127.0.0.1"
                hello["peer_addr"] = peer_rt.advertised_addr(local_ip)
            if link.token is not None:
                hello["token"] = link.token
                # every task id this session ever accepted (the dedup
                # set covers queued, running, and finished work) plus
                # unacked outbox frames: the coordinator reconciles its
                # outstanding set against this and requeues assignments
                # the dead link ate — nothing here will ever complete
                # an assignment we never received
                hello["holding"] = sorted(
                    set(seen_tasks) | link.held_task_ids()
                )
            send_frame(s, hello)
            ack = recv_frame(s)
            if isinstance(ack, dict) and ack.get("type") == "hello_reject":
                raise _RegistrationRejected(str(ack.get("reason", "")))
            if not isinstance(ack, dict) or ack.get("type") != "hello_ack":
                raise ConnectionError(f"bad handshake reply: {ack!r}")
            s.settimeout(None)
            link.lease_hint = ack.get("lease_s")
            resumed = bool(ack.get("resume"))
            if not resumed:
                # a NEW session (first registration, or our old lease is
                # gone — possibly under a brand-new coordinator whose task
                # ids restart at 0): stale dedup state must not swallow
                # the new session's assignments
                seen_tasks.clear()
            # the epoch must be current BEFORE adopt replays the outbox:
            # replayed frames are re-stamped with it, and a successor
            # fences anything stamped by the epoch that crashed
            link.epoch = int(ack.get("epoch") or 0)
            link.adopt(s, ack.get("token"), resumed)
        except BaseException:
            try:
                s.close()
            except OSError:
                pass
            raise

    def _check_rendezvous() -> bool:
        """Re-read the successor advertisement, re-targeting the dial at
        its address. True exactly once per newly advertised epoch newer
        than the one this worker last joined — an open takeover window,
        which earns the reconnect loop a fresh give-up allowance."""
        if rendezvous is None:
            return False
        from .journal import read_rendezvous

        adv = read_rendezvous(rendezvous)
        if adv is None:
            return False
        if adv["addr"] != (dial["host"], dial["port"]):
            logger.warning(
                "worker %s: rendezvous advertises epoch %d at %s:%s; "
                "re-targeting the reconnect", wname, adv["epoch"],
                adv["addr"][0], adv["addr"][1],
            )
            dial["host"], dial["port"] = adv["addr"]
        if adv["epoch"] > link.epoch and adv["epoch"] > adv_seen["epoch"]:
            adv_seen["epoch"] = adv["epoch"]
            return True
        return False

    def _reconnect() -> bool:
        """Re-establish the coordinator link after a drop, with backoff,
        for up to ``reconnect_give_up_s`` — suspended (restarted) each
        time the rendezvous file advertises a NEW successor epoch. In-
        flight tasks keep running throughout; success replays the outbox.
        False = give up (exit)."""
        give_up = time.monotonic() + max(0.0, reconnect_give_up_s)
        delay = 0.05
        while not stop.is_set() and not drain["on"]:
            if _check_rendezvous():
                # a successor is mid-takeover: dying now would abandon a
                # fleet that is about to be re-adopted
                give_up = time.monotonic() + max(0.0, reconnect_give_up_s)
            if time.monotonic() > give_up:
                logger.error(
                    "%s",
                    _give_up_message(
                        wname, f"{dial['host']}:{dial['port']}", link.epoch,
                        reconnect_give_up_s, rendezvous,
                    ),
                )
                return False
            try:
                _connect()
            except _RegistrationRejected as e:
                if rendezvous is not None:
                    # a successor can reject transiently while its own
                    # adoption settles; the rendezvous window (give_up
                    # above) decides when chasing it stops being worth it
                    logger.warning(
                        "worker %s: registration rejected (%s); retrying "
                        "under the rendezvous window", wname, e,
                    )
                    time.sleep(delay)
                    delay = min(delay * 2, 1.0)
                    continue
                logger.error(
                    "worker %s: registration rejected (%s); exiting",
                    wname, e,
                )
                return False
            except (ConnectionError, OSError):
                time.sleep(delay)
                delay = min(delay * 2, 1.0)
                continue
            get_registry().counter("worker_link_reconnects").inc()
            logger.warning(
                "worker %s: reconnected to the coordinator (%d unacked "
                "frame(s) replayed)", wname, len(link.outbox),
            )
            return True
        return False

    _connect()  # the initial registration failure stays loud: raise
    raw_blobs: Dict[str, bytes] = {}
    #: LRU of decoded (function, config) pairs, bounded so a worker serving
    #: a long-lived coordinator across many plans doesn't pin every op's
    #: live objects (raw bytes are freed at decode, as before). Evicting
    #: notifies the coordinator (``blob_dropped``) so it re-ships the bytes
    #: with the next task of that op instead of assuming the worker still
    #: holds them.
    decoded_blobs: OrderedDict[str, tuple] = OrderedDict()
    try:
        decoded_cap = max(
            1, int(os.environ.get("CUBED_TPU_TORCH_WORKER_BLOB_CAP", "256"))
        )
    except ValueError:
        decoded_cap = 256
    blob_lock = threading.Lock()
    stop = threading.Event()
    #: drain state: once armed, no new task starts; in-flight tasks get the
    #: grace window, then are abandoned. ``grace`` is mutable so an injected
    #: preemption can carry its own (shorter) notice window
    drain = {"on": False, "grace": float(drain_grace_s)}
    inflight: set[int] = set()
    inflight_lock = threading.Lock()

    def _drain_loop(reason: str, grace_s: float) -> None:
        deadline = time.monotonic() + max(0.0, grace_s)
        while time.monotonic() < deadline:
            with inflight_lock:
                if not inflight:
                    break
            time.sleep(0.02)
        with inflight_lock:
            abandoned = sorted(inflight)
        link.send(
            {"type": "drained", "reason": reason, "abandoned": abandoned},
            important=True,
        )
        stop.set()
        try:
            link.sock.close()  # unblocks the main recv loop
        except OSError:
            pass
        if abandoned and sigterm_installed:
            # abandoned tasks are still running on pool threads; the process
            # must not linger joining them past its drain window (the
            # "drained" frame is already in the kernel send buffer — a
            # graceful FIN flushes it). An embedded (non-main-thread)
            # worker does not own its process: leave the orphans to their
            # daemon threads instead of exiting the host
            os._exit(0)

    def _begin_drain(reason: str, grace_s: float) -> None:
        with inflight_lock:
            if drain["on"]:
                return
            drain["on"] = True
        logger.warning(
            "worker %s: draining (%s, grace %.3fs, %d in flight)",
            wname, reason, grace_s, len(inflight),
        )
        link.send(
            {"type": "draining", "reason": reason, "grace_s": grace_s},
            important=True,
        )
        if reason == "preempted" and sigterm_installed:
            # spot semantics: the platform hard-kills at the end of the
            # notice window regardless of progress — model it so a wedged
            # in-flight task cannot outlive its preemption notice (small
            # epsilon lets a just-finished drain report first). Embedded
            # workers don't own the process: no hard-kill modelling
            t = threading.Timer(grace_s + 0.5, os._exit, args=(137,))
            t.daemon = True
            t.start()
        threading.Thread(
            target=_drain_loop, args=(reason, grace_s),
            name=f"worker-drain-{wname}", daemon=True,
        ).start()

    def _on_sigterm(signum, frame):
        # the spot preemption notice: drain inside the window, then die.
        # Hand off to a thread — the handler interrupts the main thread
        # mid-anything, and _begin_drain takes the link lock/inflight_lock,
        # which the interrupted frame may be holding (a non-reentrant
        # lock acquired from the handler would self-deadlock)
        threading.Thread(
            target=_begin_drain, args=("preempted", drain["grace"]),
            name=f"worker-sigterm-{wname}", daemon=True,
        ).start()

    try:
        _signal.signal(_signal.SIGTERM, _on_sigterm)
        sigterm_installed = True
    except ValueError:
        # not the main thread (embedded use): no spot semantics — injected
        # preemptions must then drain directly instead of raising a
        # default-disposition SIGTERM that would kill the HOST process
        sigterm_installed = False

    def run_task(msg: dict) -> None:
        task_id = msg["task_id"]
        with inflight_lock:
            if drain["on"]:
                rejected = True
            else:
                rejected = False
                inflight.add(task_id)
        if rejected:
            # raced the drain start: hand the task back unexecuted so the
            # coordinator requeues it free instead of waiting for a timeout
            link.send(
                {"type": "abandoned", "task_id": task_id}, important=True
            )
            return
        try:
            _run_task_inner(msg)
        finally:
            with inflight_lock:
                inflight.discard(task_id)

    def _run_task_inner(msg: dict) -> None:
        task_id = msg["task_id"]
        # correlate every log line/span this task emits with the client's
        # compute (the id rides each task message; None clears stale state)
        cid_token = obs_logs.compute_id_var.set(msg.get("compute_id"))
        try:
            # chaos hook: a named worker hard-exits or wedges when its
            # executed-task count reaches the configured threshold —
            # modelling OOM-kills and hung hosts. The task message carries
            # the client's arming state (mirrored here, None = disarm);
            # messages from an old coordinator fall back to the spawn env
            if "faults" in msg:
                injector = arm_from_wire(msg.get("faults"))
            else:
                injector = get_injector()
            if "integrity" in msg:
                integrity.arm_from_wire(msg.get("integrity"))
            if "memory_guard" in msg:
                memory.arm_from_wire(msg.get("memory_guard"))
            if "spans" in msg:
                arm_spans_from_wire(msg.get("spans"))
            if "peer" in msg:
                p2p.arm_from_wire(msg.get("peer"))
            if msg.get("cancel") is not None:
                # the compute's cancellation token (deadline epoch +
                # cancelled flag), registered by compute id: the checks in
                # execute_with_stats and the storage layer resolve it via
                # this task's compute-id context, so concurrent computes
                # on one worker cancel independently
                cancellation.arm_from_wire(msg.get("cancel"))
            if injector is not None:
                action = injector.worker_task_tick(wname)
                if action == "crash":
                    logger.warning("worker %s: injected crash", wname)
                    os._exit(137)
                elif action == "hang":
                    logger.warning("worker %s: injected hang", wname)
                    time.sleep(injector.config.worker_hang_s)
                elif action == "preempt":
                    # injected spot preemption: SIGTERM ourselves so the
                    # REAL handler runs (notice -> drain -> hard kill); the
                    # current task stays in flight and races the window
                    logger.warning(
                        "worker %s: injected spot preemption (notice %.2fs)",
                        wname, injector.config.preempt_notice_s,
                    )
                    drain["grace"] = float(injector.config.preempt_notice_s)
                    if sigterm_installed:
                        os.kill(os.getpid(), _signal.SIGTERM)
                    else:
                        # embedded (non-main-thread) worker: no handler to
                        # receive the signal — drain directly
                        _begin_drain("preempted", drain["grace"])
                if injector.task_fatal(chunk_key(msg["input"])):
                    # the poison-task chaos shape: THIS input kills every
                    # worker it lands on (kernel OOM-kill / segfault),
                    # deterministically per chunk key — abrupt exit, no
                    # drain, no error frame; the coordinator sees a dead
                    # link and requeues, and the quarantine path in
                    # map_unordered must end the loop
                    logger.warning(
                        "worker %s: injected poison-task fatal (task %s)",
                        wname, task_id,
                    )
                    os._exit(137)
            blob_id = msg["blob_id"]
            # decode under a lock (concurrent same-blob tasks must not race
            # the decode/pop), inside the task try: an undeserializable op
            # (missing module on this host, version skew) fails THIS task
            # with a real traceback instead of killing the worker
            dropped = []
            missing = False
            with blob_lock:
                pair = decoded_blobs.get(blob_id)
                if pair is None:
                    raw = raw_blobs.get(blob_id)
                    if raw is None:
                        # eviction raced this task's dispatch. With
                        # worker_threads > 1 this error frame can reach
                        # the socket BEFORE the evicting thread's
                        # blob_dropped for the same blob, so the
                        # coordinator would retry once without re-shipping
                        # bytes and burn a retry; send our own
                        # blob_dropped first (coordinator discard is
                        # idempotent) so the first retry carries the bytes
                        missing = True
                    else:
                        pair = payload.loads(raw)
                        decoded_blobs[blob_id] = pair
                        # raw bytes are dead weight once decoded (late
                        # duplicate tasks hit decoded_blobs first)
                        raw_blobs.pop(blob_id, None)
                        while len(decoded_blobs) > decoded_cap:
                            dropped.append(
                                decoded_blobs.popitem(last=False)[0]
                            )
                else:
                    decoded_blobs.move_to_end(blob_id)
            if missing:
                dropped.append(blob_id)
            for gone in dropped:
                link.send({"type": "blob_dropped", "blob_id": gone})
            if missing:
                raise RuntimeError(
                    f"unknown blob {blob_id!r} (evicted or never sent); "
                    "blob_dropped sent, the coordinator re-ships it on "
                    "retry"
                )
            function, config = pair
            if msg.get("ack"):
                # ack actual execution start (post decode): the coordinator
                # restarts this task's timeout clock, separating cold-start
                # delay from a real hang. Not outbox-retained — a stale
                # started ack is useless after a reconnect
                link.send({"type": "started", "task_id": task_id})
            # collect the chunks this task writes (storage hook →
            # transfer.note_chunk_written) so the advertisement can
            # piggyback on the result frame; thread-local, so concurrent
            # task slots never mix their lists
            p2p.begin_task_produced()
            try:
                if config is not None:
                    result, stats = execute_in_worker(
                        function, msg["input"], config=config
                    )
                else:
                    result, stats = execute_in_worker(function, msg["input"])
            finally:
                produced = p2p.end_task_produced()
            # live-telemetry residue in the WORKER's own registry: the
            # per-worker counters the heartbeat metrics_delta ships (the
            # authoritative per-compute numbers still ride the task stats
            # to the client — this is the continuous, per-worker view).
            # Scoped counters deliberately bypass the local registry
            # (accounting.record_scoped_counter), so a bounded allowlist
            # is folded here where the worker identity is known
            reg = get_registry()
            reg.counter("worker_tasks_executed").inc()
            for key in _WORKER_FOLD_COUNTERS:
                v = (stats.get("counters") or {}).get(key)
                if isinstance(v, (int, float)) and v:
                    reg.counter(key).inc(int(v))
            try:
                # important: retained in the outbox and replayed across a
                # reconnect, so a partition between finishing the task and
                # delivering its result costs nothing
                link.send(
                    {"type": "result", "task_id": task_id, "result": result,
                     "stats": stats, "produced": produced or None},
                    important=True,
                )
            except Exception:
                # unpicklable result (TypeError, PicklingError, ...): the
                # value lives in the shared store anyway (tasks communicate
                # through Zarr) — the task SUCCEEDED, so report completion.
                # Loud, not silent: this is only safe while pipeline task
                # RESULTS are never consumed; a future value-returning
                # pipeline must not quietly receive None. (link.send frames
                # BEFORE queueing, so the bad payload never reaches the
                # outbox.)
                logger.warning(
                    "task %s: result of type %s is not picklable; "
                    "reporting completion with result=None (safe only "
                    "because pipeline results flow through the store, "
                    "not the return value)",
                    task_id, type(result).__name__,
                )
                link.send(
                    {"type": "result", "task_id": task_id, "result": None,
                     "stats": stats, "produced": produced or None},
                    important=True,
                )
        except Exception as e:
            get_registry().counter("worker_task_errors").inc()
            try:
                link.send(
                    {"type": "error", "task_id": task_id,
                     "error": traceback.format_exc(),
                     # root class name rides along so the coordinator-side
                     # retry policy can classify remote programming errors
                     "error_type": type(e).__name__,
                     # structured payload (ChunkIntegrityError: the corrupt
                     # chunk's store/key) for coordinator-side repair
                     "error_payload": getattr(e, "wire_payload", None),
                     # the failed attempt's salvaged span buffer (plain
                     # dict — execute_with_stats attached it), so the
                     # client can land the failure on the merged trace
                     "task_stats": getattr(
                         e, "cubed_tpu_torch_task_stats", None
                     )},
                    important=True,
                )
            except Exception:
                # the traceback/payload itself failed to pickle: ship a
                # minimal but well-formed error frame instead of silence
                link.send(
                    {"type": "error", "task_id": task_id,
                     "error": f"{type(e).__name__}: {e}",
                     "error_type": type(e).__name__},
                    important=True,
                )
        finally:
            obs_logs.compute_id_var.reset(cid_token)

    def heartbeat_loop() -> None:
        """RSS/memory-pressure telemetry plus the clock handshake's t0.

        The first heartbeat goes out immediately (not after the 1s period)
        so the coordinator's echo — and with it this worker's clock offset
        — exists before the first task completes: even a sub-second compute
        gets aligned worker spans. The coordinator only ever *reads* these;
        a worker that never heartbeats (older build) simply stays eligible
        for dispatch.

        Doubles as the **stale-link watchdog**: a healthy link echoes every
        heartbeat within ~RTT and acks important frames promptly, so
        receiving NOTHING for a few periods — or an important frame going
        unacked past its window — means the link is half-open (a one-way
        partition, a silently dead TCP stream). The watchdog then closes
        the socket, forcing the main recv loop into its reconnect path;
        against a healthy coordinator a spurious reconnect is cheap and
        harmless (the session token re-adopts the lease).

        Since the live-telemetry PR each heartbeat also piggybacks a
        bounded ``metrics_delta`` — this process's counter increments
        since the previous heartbeat — so the coordinator's telemetry
        pipeline sees worker-side progress continuously instead of once
        per task result."""
        hb_metrics_prev = get_registry().snapshot()
        while True:
            rss = current_measured_mem()
            pressure = memory.pressure_level()
            if peer_rt is not None:
                # evict-on-pressure: the chunk cache's budget is accounted
                # against the memory guard — under pressure the fast path
                # yields its footprint before admission control has to
                peer_rt.pressure_tick(pressure)
            hb = {
                "type": "heartbeat",
                "rss": rss,
                "pressured": (rss is not None and pressure != "ok"),
                "t0": obs_clock.now(),
            }
            if peer_rt is not None:
                hb["peer_cache"] = peer_rt.cache.stats()
                # evicted chunks ride the heartbeat so the coordinator's
                # location registry stops steering readers at them; a lost
                # heartbeat costs a fetch-miss + store fallback, nothing
                # more, so no ack/replay is needed
                evicted, flush = peer_rt.cache.drain_evictions()
                if flush:
                    hb["peer_cache_flush"] = True
                elif evicted:
                    hb["peer_evicted"] = evicted
            if clock_est["offset"] is not None:
                hb["clock_offset"] = clock_est["offset"]
                hb["clock_rtt"] = clock_est["rtt"]
            delta, hb_metrics_prev = heartbeat_metrics_delta(
                get_registry(), hb_metrics_prev
            )
            if delta is not None:
                hb["metrics_delta"] = delta
            link.send(hb)  # link failures heal via the recv loop's reconnect
            if (
                not stop.is_set()
                and not drain["on"]
                and (
                    link.unacked_age() > ACK_STALE_S
                    or time.monotonic() - link.last_rx > RX_STALE_S
                )
            ):
                logger.warning(
                    "worker %s: link looks half-open (last rx %.1fs ago, "
                    "oldest unacked %.1fs); forcing a reconnect",
                    wname, time.monotonic() - link.last_rx,
                    link.unacked_age(),
                )
                with link.lock:
                    s = link.sock
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
            if stop.wait(1.0):
                return

    threading.Thread(
        target=heartbeat_loop, name=f"worker-heartbeat-{wname}", daemon=True
    ).start()

    pool = ThreadPoolExecutor(max_workers=max(nthreads, 1))
    SEEN_TASKS_CAP = 4096

    def _handle(msg: dict) -> bool:
        """Process one delivered frame; False = leave the recv loop."""
        mtype = msg.get("type")
        if mtype == "task":
            task_id = msg.get("task_id")
            if task_id in seen_tasks:
                get_registry().counter("fleet_assignments_deduped").inc()
                return True
            seen_tasks[task_id] = True
            while len(seen_tasks) > SEEN_TASKS_CAP:
                seen_tasks.popitem(last=False)
            if msg.get("blob") is not None:
                raw_blobs[msg["blob_id"]] = msg["blob"]
            pool.submit(run_task, msg)
        elif mtype == "ack":
            link.on_ack(msg.get("seq"))
        elif mtype == "hello_ack":
            pass  # handshake frames are consumed in _connect; a stray
            # duplicate (injected) carries nothing new
        elif mtype == "chunk_location":
            if peer_rt is not None:
                peer_rt.on_location(msg)
        elif mtype == "compute_cancel":
            # cooperative cancellation: trip (or pre-record) the named
            # compute's token so every in-flight task aborts at its next
            # chunk-IO boundary and queued assignments of that compute
            # fail fast instead of running
            cancellation.cancel_compute(
                msg.get("compute"), msg.get("reason")
            )
        elif mtype == "drain":
            # graceful scale-down (or an operator-initiated drain):
            # same path as the SIGTERM handler, reason carried over
            # (grace_s=0.0 is a legitimate "abandon immediately" —
            # only an ABSENT grace falls back to the default)
            g = msg.get("grace_s")
            _begin_drain(
                msg.get("reason") or "scale_down",
                float(drain["grace"] if g is None else g),
            )
        elif mtype == "heartbeat_echo":
            # NTP-style: the coordinator echoed our t0 with its own
            # clock; offset = t_coord - midpoint(t0, t1), accurate
            # to ~rtt/2. Accept a sample when its rtt is comparable
            # to the BEST rtt ever seen (a fixed anchor — never
            # ratcheted by accepted samples — with a 1ms epsilon so
            # coarse clocks reporting rtt=0 still refresh), so slow
            # clock drift heals without estimate quality degrading
            # under rising load. Ship it back immediately — the
            # next task's spans may be exported before the next
            # 1s heartbeat
            t1 = obs_clock.now()
            t0, tc = msg.get("t0"), msg.get("t_coord")
            if t0 is not None and tc is not None:
                rtt = max(0.0, t1 - t0)
                best = clock_est.get("best")
                if best is None or rtt < best:
                    best = rtt
                clock_est["best"] = best
                if (
                    clock_est["rtt"] is None
                    or rtt <= best * 1.5 + 1e-3
                ):
                    clock_est["offset"] = tc - (t0 + t1) / 2
                    clock_est["rtt"] = rtt
                    link.send({
                        "type": "clock",
                        "clock_offset": clock_est["offset"],
                        "clock_rtt": rtt,
                    })
        elif mtype == "shutdown":
            return False
        else:
            logger.warning("worker: unknown message %r", mtype)
        return True

    try:
        while not stop.is_set():
            try:
                msg = recv_frame(link.sock)
            except CorruptFrameError as e:
                # a torn/garbage frame: the stream is useless from here —
                # count it, drop the connection, reconnect with a clean one
                get_registry().counter("frames_corrupt").inc()
                logger.warning(
                    "worker %s: corrupt frame from coordinator (%s); "
                    "reconnecting", wname, e,
                )
                try:
                    link.sock.close()
                except OSError:
                    pass
                if stop.is_set() or drain["on"] or not _reconnect():
                    break
                continue
            except (ConnectionError, OSError):
                if stop.is_set() or drain["on"]:
                    break  # shutdown or our own drain closed the socket
                if not _reconnect():
                    break  # coordinator unreachable past the give-up window
                continue
            if not isinstance(msg, dict):
                logger.warning(
                    "worker %s: non-dict frame %r ignored", wname,
                    type(msg).__name__,
                )
                continue
            mepoch = msg.get("epoch")
            if mepoch is not None and int(mepoch) < link.epoch:
                # a zombie prior-epoch coordinator still speaking on an
                # old socket: fence its frames — above all its acks,
                # which must not clear outbox results the successor epoch
                # has never processed
                get_registry().counter("stale_epoch_frames").inc()
                logger.warning(
                    "worker %s: fenced stale-epoch frame (%r, epoch %s < "
                    "%d)", wname, msg.get("type"), mepoch, link.epoch,
                )
                continue
            inj = get_injector()
            if inj is not None and inj.partitioned(wname, "rx"):
                # one-way partition, coordinator→worker leg: the frame was
                # never delivered — last_rx must NOT refresh, so the
                # watchdog sees the silence a real partition would cause
                continue
            link.last_rx = time.monotonic()
            if inj is not None:
                act = inj.net_fault("rx", wname, msg.get("type"))
                if act == "drop":
                    continue
                if act == "delay":
                    time.sleep(inj.config.net_msg_delay_s)
                if act == "reset":
                    try:
                        link.sock.close()
                    except OSError:
                        pass
                    continue  # the next recv notices and reconnects
                if act == "dup":
                    if not _handle(dict(msg)):
                        break
            if not _handle(msg):
                break
    finally:
        # every exit from the recv loop — shutdown frame, coordinator
        # unreachable past the reconnect window, or our own drain — means
        # this worker's outstanding futures are (or will be) failed or
        # requeued coordinator-side, so queued tasks produce results
        # nobody can receive: cancel them instead of running them out
        pool.shutdown(wait=False, cancel_futures=True)
    stop.set()  # silence the heartbeat/watchdog thread
    if peer_rt is not None:
        p2p.set_worker_runtime(None)
        peer_rt.close()
    try:
        link.sock.close()
    except OSError:
        pass
    if sigterm_installed:
        # give RUNNING tasks a moment to finish (their threads are
        # non-daemon: the interpreter would join them at exit), then
        # leave without blocking on a hung one — close() escalates to
        # SIGKILL after 10s otherwise, which is strictly worse. Embedded
        # (non-main-thread) workers don't own the process: they return
        # and leave stragglers to their own threads
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            with inflight_lock:
                if not inflight:
                    return
            time.sleep(0.02)
        os._exit(0)
