"""Peer-to-peer chunk transfer: the fleet's second data plane.

Counterpart of ``cubed_tpu/runtime/transfer.py``.

The paper's execution model routes ALL inter-op data through Zarr — on the
TCP fleet that is a write+read object-storage round-trip per chunk per DAG
edge. This module adds a peer-fetch fast path on top of machinery that
already exists, without touching any durability guarantee:

- **Worker chunk cache.** Every fleet worker keeps the raw stored bytes of
  chunks it produced in a bounded byte-budget LRU (:class:`ChunkCache`).
  Zarr stays write-through: the cache is filled AFTER the durable store
  write (and its manifest checksum record) succeeds, so losing any cache
  entry — eviction, pressure, worker death — costs at most a store read,
  never data. The budget is accounted against the memory guard: the
  heartbeat loop feeds the guard's pressure level into
  :meth:`ChunkCache.evict_for_pressure` (soft pressure halves the
  footprint, hard pressure empties the cache).

- **Location registry.** Producers advertise ``(store, chunk key, nbytes)``
  to the coordinator by piggybacking on the existing sequenced/acked result
  frames; :class:`ChunkLocationRegistry` (coordinator-side) maps each chunk
  to the worker that last produced it and drops a worker's entries the
  moment it leaves the fleet.

- **Peer fetch.** A consuming task's chunk read (``storage/store.py``
  task-scope hook → :func:`fetch_chunk`) first checks the local cache, then
  resolves the producer via a small ``chunk_locate`` RPC over the existing
  coordinator link and fetches the bytes over a direct worker→worker
  connection using the same length-prefixed frame protocol the control
  plane uses. Fetched bytes are verified (CRC32 + length) against the
  authoritative integrity manifest BEFORE use; any miss, timeout, peer
  death, checksum mismatch, or injected fault falls back to the Zarr store
  read — transparently, inside the read path, so fallbacks never surface
  as task failures and draw zero retry budget.

- **Sub-chunk byte ranges (the shuffle fast path).** A rechunk target
  task often overlaps a sliver of each source chunk; ``chunk_get`` with
  ``ranges`` (:func:`fetch_chunk_ranges`) fetches exactly the coalesced
  byte ranges the region needs (``runtime/shuffle.byte_ranges``). The
  whole-chunk manifest CRC cannot verify a sub-payload directly, so the
  serving worker returns both a payload CRC (wire integrity) and its
  cached chunk's insert-time CRC + length — which must match the
  manifest entry (cache-copy integrity). Fetches inside a rechunk
  exchange record ``shuffle_fetch`` spans (the ANALYZE ``shuffle``
  bucket) and ``shuffle_bytes_peer``.

- **Locality-aware placement.** Under ``Spec(scheduler="dataflow")`` the
  chunk graph knows exactly which chunks each task reads
  (``dataflow.ChunkGraph.reads``); the coordinator scores each dispatch by
  input bytes already resident per worker (:func:`pick_worker_by_locality`)
  and prefers the best-scoring non-pressured worker when its load is within
  a small slack of the least-loaded one — turning the cache from "helps if
  you get lucky" into the common case.

Activation mirrors the integrity/memory-guard layers: the
``CUBED_TPU_TORCH_P2P`` env var (operator override) > ``Spec(peer_transfer=...)``
> ``DistributedDagExecutor(peer_transfer=...)`` > **ON** (the fleet
default — store-only is the explicit escape hatch, ``CUBED_TPU_TORCH_P2P=off``
disabling the data plane fleet-wide including the worker-side server).
The client's resolved config rides every task message (``wire_config`` /
``arm_from_wire``) so pre-started fleets mirror the client per compute.

Chaos knobs (``runtime/faults.py``): seeded ``peer_drop_rate`` /
``peer_delay_rate`` / ``peer_corrupt_rate`` on the fetching side and
``peer_reset_rate`` on the serving side, plus the existing worker-crash
knobs for peer-death-mid-fetch: each falls back to the store read, so
values stay bit for bit.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass, fields
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..observability.accounting import (
    current_scope,
    record_scoped_counter,
    scope_span,
)
from ..observability.metrics import get_registry
from .arming import ScopeStack

logger = logging.getLogger(__name__)

#: operator override: "off"/"0"/"false" disables peer transfer everywhere
#: (including the worker-side peer server); any other non-empty value
#: force-enables the client arming
P2P_ENV_VAR = "CUBED_TPU_TORCH_P2P"

#: worker cache budget override (bytes); the default keeps a worker's cache
#: well under one allowed_mem of the default Spec
CACHE_BYTES_ENV_VAR = "CUBED_TPU_TORCH_PEER_CACHE_BYTES"
DEFAULT_CACHE_BYTES = 256 * 1024 * 1024

_OFF_VALUES = ("0", "off", "false", "no")

#: placement: a locality-preferred worker may carry at most this much more
#: load (outstanding tasks per thread) than the least-loaded candidate —
#: beyond it, chasing cached bytes would queue behind a busy worker longer
#: than the store round-trip it saves
LOCALITY_LOAD_SLACK = 2.0


def _crc(data: bytes) -> int:
    # same polynomial/masking as storage/integrity.checksum (kept inline so
    # this module never imports the storage package the store imports us
    # from)
    return zlib.crc32(data) & 0xFFFFFFFF


# ----------------------------------------------------------------------
# client-side arming (env > Spec > executor default > off)
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class PeerConfig:
    """The peer-fetch data plane's knobs (client-resolved, wire-mirrored)."""

    enabled: bool = False
    #: how long a reader waits for the coordinator's chunk_locate reply
    #: before treating the read as a location miss (store fallback)
    locate_timeout_s: float = 1.0
    #: connect + frame timeout for the direct worker→worker fetch
    fetch_timeout_s: float = 2.0

    @classmethod
    def from_dict(cls, d: dict) -> "PeerConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown PeerConfig fields {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        return cls(**d)

    def to_wire(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})


_lock = threading.Lock()
#: the client's armed config (the executor arms it per compute)
_client_config: Optional[PeerConfig] = None
#: the worker-side mirror of the client's arming, set per task message
_armed: Optional[PeerConfig] = None
_wire_cache: tuple = (None, None)


def env_disabled() -> bool:
    """True when the operator turned peer transfer off everywhere."""
    return os.environ.get(P2P_ENV_VAR, "").strip().lower() in _OFF_VALUES


def resolve_peer_transfer(spec=None, default: Optional[bool] = None) -> bool:
    """The effective client-side enablement (env > Spec > executor > ON).

    Peer transfer is the fleet DEFAULT: it is chaos-proven (every defect
    falls back to the store read, drawing zero retry budget) and saves
    the overwhelming majority of store read bytes, so store-only is now
    the escape hatch — ``CUBED_TPU_TORCH_P2P=off`` (operator-wide),
    ``Spec(peer_transfer=False)``, or
    ``DistributedDagExecutor(peer_transfer=False)``."""
    raw = os.environ.get(P2P_ENV_VAR)
    if raw:
        return raw.strip().lower() not in _OFF_VALUES
    s = getattr(spec, "peer_transfer", None)
    if s is not None:
        return bool(s)
    if default is not None:
        return bool(default)
    return True


class client_scoped:
    """Arm the client-side config for a ``with`` block (one compute). The
    coordinator attaches :func:`wire_config` to every task message while
    armed, which is how pre-started fleet workers mirror the client. Scopes
    that exit out of order leave the newest live one armed
    (``runtime/arming.py``)."""

    def __init__(self, enabled: bool, config: Optional[PeerConfig] = None):
        self._config = (
            config if config is not None else PeerConfig(enabled=bool(enabled))
        )

    def __enter__(self) -> PeerConfig:
        self._token = _client_scopes.push(self._config)
        return self._config

    def __exit__(self, *exc) -> None:
        _client_scopes.pop(self._token)


def _set_client_config(config: Optional[PeerConfig]) -> None:
    global _client_config
    _client_config = config


_client_scopes = ScopeStack(_lock, lambda: _client_config, _set_client_config)


def wire_config() -> Optional[str]:
    """The client's arming state for task messages (None = disabled —
    which also DISARMS a pre-started worker a previous compute enabled)."""
    cfg = _client_config
    if cfg is None or not cfg.enabled:
        return None
    return cfg.to_wire()


def arm_from_wire(raw: Optional[str]) -> Optional[PeerConfig]:
    """Fleet-worker side: adopt the arming a task message carried (None
    disarms — fetch AND cache-fill stop for this and later tasks)."""
    global _armed, _wire_cache
    if raw is None:
        with _lock:
            _armed = None
        return None
    cached_raw, cached_cfg = _wire_cache
    if raw != cached_raw:
        try:
            cached_cfg = PeerConfig.from_dict(json.loads(raw))
        except (ValueError, TypeError):
            logger.warning("ignoring invalid peer-transfer config from wire")
            return _armed
    with _lock:
        _wire_cache = (raw, cached_cfg)
        _armed = cached_cfg
    return cached_cfg


def armed_config() -> Optional[PeerConfig]:
    return _armed


# ----------------------------------------------------------------------
# the worker chunk cache
# ----------------------------------------------------------------------


class ChunkCache:
    """Bounded byte-budget LRU of raw stored chunk bytes, thread-safe.

    Holds chunks THIS worker produced (filled after the durable write), so
    every entry is reproducible from the store — eviction is always safe.
    """

    #: evicted keys retained for the next heartbeat's piggyback (so the
    #: coordinator's location registry forgets them); past this the list is
    #: collapsed into a flush-everything marker
    EVICT_NOTIFY_CAP = 512

    def __init__(self, max_bytes: int = DEFAULT_CACHE_BYTES):
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        #: (store, key) -> (raw stored bytes, crc32 of those bytes) — the
        #: crc is computed once at insert so sub-chunk range serving can
        #: prove "my cached copy matches the manifest" without re-hashing
        #: the whole chunk per request
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.bytes = 0
        self.evictions = 0
        self.pressure_evictions = 0
        #: (store, key) pairs evicted since the last drain_evictions();
        #: _flush_pending collapses an overflow (or a hard-pressure flush)
        #: into "forget everything of mine"
        self._evicted_pending: List[tuple] = []
        self._flush_pending = False

    def _note_evicted(self, ck: tuple) -> None:
        # under self._lock
        if self._flush_pending:
            return
        if len(self._evicted_pending) >= self.EVICT_NOTIFY_CAP:
            self._evicted_pending.clear()
            self._flush_pending = True
        else:
            self._evicted_pending.append(ck)

    def drain_evictions(self) -> tuple:
        """``(evicted key list, flush_all)`` accumulated since the last
        call — the worker heartbeat attaches these so the coordinator's
        registry stops steering readers at bytes this cache no longer
        holds (a lost heartbeat costs only a fetch-miss + store fallback,
        so the notify channel needs no ack)."""
        with self._lock:
            evicted, self._evicted_pending = self._evicted_pending, []
            flush, self._flush_pending = self._flush_pending, False
        return evicted, flush

    def put(self, store: str, key: str, data: bytes) -> bool:
        """Insert (or refresh) one chunk; False when it cannot fit at all."""
        n = len(data)
        if n > self.max_bytes:
            return False
        evicted = 0
        with self._lock:
            ck = (str(store), str(key))
            old = self._entries.pop(ck, None)
            if old is not None:
                self.bytes -= len(old[0])
            self._entries[ck] = (data, _crc(data))
            self.bytes += n
            while self.bytes > self.max_bytes and self._entries:
                dropped_key, dropped = self._entries.popitem(last=False)
                self.bytes -= len(dropped[0])
                self._note_evicted(dropped_key)
                evicted += 1
            self.evictions += evicted
            self._set_gauges()
        if evicted:
            get_registry().counter("cache_evictions").inc(evicted)
        return True

    def get(self, store: str, key: str) -> Optional[bytes]:
        entry = self.get_with_crc(store, key)
        return entry[0] if entry is not None else None

    def get_with_crc(self, store: str, key: str) -> Optional[tuple]:
        """``(bytes, crc32)`` of a cached chunk, or None — the crc was
        computed at insert time from the durably written bytes."""
        with self._lock:
            entry = self._entries.get((str(store), str(key)))
            if entry is not None:
                self._entries.move_to_end((str(store), str(key)))
            return entry

    def evict_for_pressure(self, level: str) -> int:
        """Shed footprint when the memory guard reports pressure:
        ``soft`` evicts down to half the budget, ``hard`` empties the cache
        (the machine needs the bytes more than the fast path does). Returns
        the number of entries evicted."""
        if level == "hard":
            target = 0
        elif level == "soft":
            target = self.max_bytes // 2
        else:
            return 0
        evicted = 0
        with self._lock:
            while self.bytes > target and self._entries:
                dropped_key, dropped = self._entries.popitem(last=False)
                self.bytes -= len(dropped[0])
                if target > 0:
                    self._note_evicted(dropped_key)
                evicted += 1
            if target == 0 and evicted:
                # a full flush: one marker beats listing every key
                self._evicted_pending.clear()
                self._flush_pending = True
            self.evictions += evicted
            self.pressure_evictions += evicted
            self._set_gauges()
        if evicted:
            get_registry().counter("cache_evictions").inc(evicted)
            logger.info(
                "peer cache: evicted %d chunk(s) under %s memory pressure",
                evicted, level,
            )
        return evicted

    def _set_gauges(self) -> None:
        reg = get_registry()
        reg.gauge("peer_cache_bytes").set(self.bytes)
        reg.gauge("peer_cache_entries").set(len(self._entries))

    def stats(self) -> dict:
        with self._lock:
            return {
                "bytes": self.bytes,
                "entries": len(self._entries),
                "evictions": self.evictions,
                "pressure_evictions": self.pressure_evictions,
                "max_bytes": self.max_bytes,
            }


# ----------------------------------------------------------------------
# the coordinator-side location registry
# ----------------------------------------------------------------------


class ChunkLocationRegistry:
    """``(store, chunk key) → (worker name, nbytes)``, coordinator-side.

    Fed by the ``produced`` lists piggybacked on sequenced result frames;
    consulted by the ``chunk_locate`` RPC and the locality-aware dispatch
    scoring. Bounded LRU — an evicted location is just a store read; a
    departed worker's entries are dropped eagerly so lookups never point
    readers at a corpse."""

    def __init__(self, max_entries: int = 262144):
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        #: worker -> set of keys it owns (eager drop on worker loss)
        self._by_worker: Dict[str, set] = {}
        self.recorded = 0
        self.dropped_workers = 0

    def record(self, worker: str, produced: Iterable) -> None:
        with self._lock:
            owned = self._by_worker.setdefault(worker, set())
            for item in produced:
                try:
                    store, key, nbytes = item[0], item[1], int(item[2])
                except (TypeError, IndexError, ValueError):
                    continue  # malformed advertisement: ignore, never crash
                ck = (str(store), str(key))
                prev = self._entries.pop(ck, None)
                if prev is not None and prev[0] != worker:
                    # a retry/backup on another worker re-produced it: the
                    # newest producer owns the freshest cache entry
                    old_owned = self._by_worker.get(prev[0])
                    if old_owned is not None:
                        old_owned.discard(ck)
                self._entries[ck] = (worker, nbytes)
                owned.add(ck)
                self.recorded += 1
            while len(self._entries) > self.max_entries:
                ck, (w, _n) = self._entries.popitem(last=False)
                o = self._by_worker.get(w)
                if o is not None:
                    o.discard(ck)

    def locate(self, store, key) -> Optional[str]:
        with self._lock:
            entry = self._entries.get((str(store), str(key)))
            return entry[0] if entry is not None else None

    def resident_bytes(self, reads: Iterable) -> Dict[str, int]:
        """Per-worker byte total of the given ``(store, key)`` reads that
        are registered as cache-resident — the dispatch locality score."""
        out: Dict[str, int] = {}
        with self._lock:
            for store, key in reads:
                entry = self._entries.get((str(store), str(key)))
                if entry is not None:
                    out[entry[0]] = out.get(entry[0], 0) + entry[1]
        return out

    def remove(self, worker: str, keys: Iterable) -> int:
        """Forget specific chunks a worker reported evicting — only
        entries still mapped to THAT worker (a newer producer's entry must
        survive a stale eviction notice)."""
        removed = 0
        with self._lock:
            owned = self._by_worker.get(worker)
            for item in keys:
                try:
                    ck = (str(item[0]), str(item[1]))
                except (TypeError, IndexError):
                    continue
                entry = self._entries.get(ck)
                if entry is not None and entry[0] == worker:
                    del self._entries[ck]
                    removed += 1
                if owned is not None:
                    owned.discard(ck)
        return removed

    def drop_worker(self, worker: str) -> int:
        with self._lock:
            owned = self._by_worker.pop(worker, None)
            if not owned:
                return 0
            for ck in owned:
                entry = self._entries.get(ck)
                if entry is not None and entry[0] == worker:
                    del self._entries[ck]
            self.dropped_workers += 1
            return len(owned)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "workers": len([w for w, s in self._by_worker.items() if s]),
                "recorded": self.recorded,
                "dropped_workers": self.dropped_workers,
            }


def pick_worker_by_locality(
    candidates: list,
    resident: Dict[str, int],
    load_of: Callable,
    slack: float = LOCALITY_LOAD_SLACK,
):
    """The dispatch-time placement decision: the candidate holding the most
    input bytes, unless taking it would queue behind real load.

    ``candidates`` are dispatch-eligible workers (already filtered for
    draining/pressure by the caller — a pressured worker is never
    locality-preferred); ``resident`` maps worker name → cached input
    bytes; ``load_of`` returns a worker's outstanding-per-thread load.
    Returns the chosen worker, or None when locality should not override
    the least-loaded default (no resident bytes, or the best holder is
    more than ``slack`` load units above the least-loaded candidate)."""
    if not resident or not candidates:
        return None
    scored = [w for w in candidates if resident.get(w.name, 0) > 0]
    if not scored:
        return None
    best = max(scored, key=lambda w: (resident[w.name], -load_of(w)))
    min_load = min(load_of(w) for w in candidates)
    if load_of(best) - min_load > slack:
        return None
    return best


# ----------------------------------------------------------------------
# the worker-side runtime: peer server, locate RPC, fetch path
# ----------------------------------------------------------------------


class PeerRuntime:
    """One per fleet-worker process: the cache, the serving socket, the
    locate-RPC bookkeeping, and a small pool of peer connections."""

    #: bound on remembered (store, key) -> producer locations; chunks are
    #: write-once so positive entries never go stale (a dead producer just
    #: turns into a fetch failure + store fallback)
    LOC_CACHE_CAP = 65536

    #: sentinel for a cached NEGATIVE lookup: the coordinator explicitly
    #: answered "no producer". Safe to remember — a consumer only reads a
    #: chunk after its producing task completed, and the advertisement is
    #: recorded before that completion resolves, so an explicit miss means
    #: the chunk was client-written (source arrays) or too big to cache:
    #: permanently store-only either way. Locate TIMEOUTS are never cached
    #: (a slow coordinator is not a fact about the chunk).
    _NEGATIVE = ("<none>", ())

    #: soft cap on pooled connections per peer: locality placement
    #: concentrates a fan-in's inputs on one producer, and a single locked
    #: connection would serialize that worker's task threads into
    #: back-to-back round trips
    CONNS_PER_PEER = 4

    def __init__(
        self,
        wname: str,
        link_send: Optional[Callable[[dict], bool]] = None,
        max_cache_bytes: Optional[int] = None,
    ):
        self.wname = wname
        if max_cache_bytes is None:
            raw = os.environ.get(CACHE_BYTES_ENV_VAR, "")
            try:
                max_cache_bytes = int(raw) if raw else DEFAULT_CACHE_BYTES
            except ValueError:
                max_cache_bytes = DEFAULT_CACHE_BYTES
        self.cache = ChunkCache(max_cache_bytes)
        self.link_send = link_send
        self._lock = threading.Lock()
        self._req_id = 0
        #: req_id -> [threading.Event, response msg | None]
        self._pending: Dict[int, list] = {}
        self._loc_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        #: addr -> [(socket, lock), ...] — a small pool per peer, so
        #: concurrent task threads fetching from the same producer don't
        #: serialize into back-to-back round trips (soft-capped at
        #: CONNS_PER_PEER; a dial race may briefly overshoot)
        self._conns: Dict[tuple, list] = {}
        self._server: Optional[socket.socket] = None
        self.port: Optional[int] = None
        self._closed = threading.Event()

    # -- serving side ---------------------------------------------------

    def start_server(self) -> None:
        self._server = socket.create_server(("", 0))
        self._server.settimeout(0.2)
        self.port = self._server.getsockname()[1]
        threading.Thread(
            target=self._accept_loop, name=f"peer-serve-{self.wname}",
            daemon=True,
        ).start()

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _addr = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(sock,),
                name=f"peer-conn-{self.wname}", daemon=True,
            ).start()

    def _serve_conn(self, sock: socket.socket) -> None:
        from .distributed import recv_frame, send_frame
        from .faults import get_injector

        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._closed.is_set():
                msg = recv_frame(sock)
                if not isinstance(msg, dict) or msg.get("type") != "chunk_get":
                    return
                store, key = msg.get("store"), msg.get("key")
                inj = get_injector()
                if inj is not None and inj.peer_serve_reset(f"{store}/{key}"):
                    # injected mid-conversation reset: the reader sees a
                    # dead connection and must fall back to the store
                    return
                entry = self.cache.get_with_crc(store, key)
                ranges = msg.get("ranges")
                if entry is None:
                    send_frame(sock, {
                        "type": "chunk_data", "store": store, "key": key,
                        "data": None,
                    })
                    continue
                data, full_crc = entry
                get_registry().counter("peer_chunks_served").inc()
                if ranges:
                    # sub-chunk shuffle fetch: concatenated byte ranges of
                    # the cached chunk plus enough evidence to verify —
                    # a crc over the payload (transport integrity) and the
                    # insert-time crc + length of the WHOLE cached chunk,
                    # which the reader checks against the authoritative
                    # manifest entry (cache-copy integrity): together the
                    # sub-bytes are as trustworthy as a whole-chunk fetch
                    try:
                        payload = b"".join(
                            data[int(off):int(off) + int(n)]
                            for off, n in ranges
                        )
                    except (TypeError, ValueError):
                        payload = None
                    send_frame(sock, {
                        "type": "chunk_data", "store": store, "key": key,
                        "data": payload,
                        "crc": _crc(payload) if payload is not None else None,
                        "full_crc": full_crc,
                        "total": len(data),
                    })
                    continue
                send_frame(sock, {
                    "type": "chunk_data", "store": store, "key": key,
                    "data": data,
                })
        except (ConnectionError, OSError):
            pass  # reader went away / reset: nothing to clean up but the fd
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def advertised_addr(self, local_ip: str) -> Optional[Tuple[str, int]]:
        """The (ip, port) peers should dial, advertised in the hello.
        ``local_ip`` is this worker's address on the coordinator-facing
        interface — the one other fleet hosts can reach."""
        if self.port is None:
            return None
        return (local_ip or "127.0.0.1", self.port)

    # -- locate RPC (over the coordinator link) -------------------------

    def locate(self, store: str, key: str, timeout_s: float):
        """(worker name, (ip, port)) of the chunk's producer, or None."""
        ck = (str(store), str(key))
        with self._lock:
            hit = self._loc_cache.get(ck)
            if hit is not None:
                self._loc_cache.move_to_end(ck)
                return None if hit is self._NEGATIVE else hit
            if self.link_send is None:
                return None
            self._req_id += 1
            rid = self._req_id
            entry = [threading.Event(), None]
            self._pending[rid] = entry
        sent = self.link_send({
            "type": "chunk_locate", "req_id": rid, "store": str(store),
            "key": str(key),
        })
        if not sent or not entry[0].wait(timeout_s):
            with self._lock:
                self._pending.pop(rid, None)
            return None
        msg = entry[1] or {}
        worker, addr = msg.get("worker"), msg.get("addr")
        loc = (
            self._NEGATIVE if worker is None or addr is None
            else (worker, (addr[0], int(addr[1])))
        )
        with self._lock:
            self._loc_cache[ck] = loc
            while len(self._loc_cache) > self.LOC_CACHE_CAP:
                self._loc_cache.popitem(last=False)
        return None if loc is self._NEGATIVE else loc

    def on_location(self, msg: dict) -> None:
        """The coordinator's chunk_location reply (worker recv loop)."""
        with self._lock:
            entry = self._pending.pop(msg.get("req_id"), None)
        if entry is not None:
            entry[1] = msg
            entry[0].set()

    # -- fetching side --------------------------------------------------

    def _acquire_conn(self, addr: tuple, timeout_s: float):
        """A (socket, lock) pair with the lock HELD, or None. Prefers an
        idle pooled connection, dials a new one below the per-peer cap,
        and only blocks (bounded) when the pool is saturated."""
        with self._lock:
            pool = self._conns.setdefault(addr, [])
            for pair in pool:
                if pair[1].acquire(blocking=False):
                    return pair
            saturated = len(pool) >= self.CONNS_PER_PEER
            first = pool[0] if pool else None
        if saturated and first is not None:
            return first if first[1].acquire(timeout=timeout_s) else None
        try:
            sock = socket.create_connection(addr, timeout=timeout_s)
        except OSError:
            return None
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(timeout_s)
        pair = (sock, threading.Lock())
        pair[1].acquire()
        with self._lock:
            self._conns.setdefault(addr, []).append(pair)
        return pair

    def _discard_conn(self, addr: tuple, pair: tuple) -> None:
        with self._lock:
            pool = self._conns.get(addr)
            if pool is not None and pair in pool:
                pool.remove(pair)
        try:
            pair[0].close()
        except OSError:
            pass

    def _fetch_reply(
        self, addr: tuple, msg: dict, timeout_s: float
    ) -> Optional[dict]:
        """One framed chunk_get round-trip to a peer; None on any failure
        (connect refused/timeout, torn frame, peer reset mid-response) —
        the caller falls back to the store."""
        from .distributed import CorruptFrameError, recv_frame, send_frame

        pair = self._acquire_conn(addr, timeout_s)
        if pair is None:
            return None
        sock, lock = pair
        try:
            try:
                send_frame(sock, msg)
                reply = recv_frame(sock)
            except (ConnectionError, OSError, CorruptFrameError):
                self._discard_conn(addr, pair)
                return None
        finally:
            lock.release()
        if not isinstance(reply, dict) or reply.get("type") != "chunk_data":
            self._discard_conn(addr, pair)
            return None
        return reply

    def fetch_bytes(
        self, addr: tuple, store: str, key: str, timeout_s: float
    ) -> Optional[bytes]:
        """Whole-chunk fetch: the stored bytes, or None on any failure or
        a serve-side cache miss."""
        reply = self._fetch_reply(addr, {
            "type": "chunk_get", "store": str(store), "key": str(key),
        }, timeout_s)
        return reply.get("data") if reply is not None else None

    def fetch_range_reply(
        self, addr: tuple, store: str, key: str, ranges, timeout_s: float
    ) -> Optional[dict]:
        """Sub-chunk fetch: the full reply dict (payload + payload crc +
        the serving cache's whole-chunk crc/length), or None on failure —
        verification against the manifest entry happens in
        :func:`fetch_chunk_ranges`."""
        return self._fetch_reply(addr, {
            "type": "chunk_get", "store": str(store), "key": str(key),
            "ranges": [(int(o), int(n)) for o, n in ranges],
        }, timeout_s)

    def pressure_tick(self, level: str) -> int:
        return self.cache.evict_for_pressure(level)

    def close(self) -> None:
        self._closed.set()
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        with self._lock:
            pools = list(self._conns.values())
            self._conns.clear()
        for pool in pools:
            for sock, _lock in pool:
                try:
                    sock.close()
                except OSError:
                    pass


# ----------------------------------------------------------------------
# process-level glue: the storage hooks call these
# ----------------------------------------------------------------------

_runtime: Optional[PeerRuntime] = None

_tls = threading.local()


def set_worker_runtime(rt: Optional[PeerRuntime]) -> None:
    global _runtime
    _runtime = rt


def get_worker_runtime() -> Optional[PeerRuntime]:
    return _runtime


def task_fetch_active() -> bool:
    """Whether a task-scope chunk read should try the peer path: this is a
    fleet worker with a running :class:`PeerRuntime`, the current compute
    armed peer transfer over the wire, and a task scope is active (plan
    metadata IO and client-side result fetches never peer-fetch — the same
    boundary integrity verification and fault injection use)."""
    cfg = _armed
    return (
        _runtime is not None
        and cfg is not None
        and cfg.enabled
        and current_scope() is not None
    )


def begin_task_produced() -> None:
    """Arm per-task collection of written chunks (worker task runner)."""
    _tls.produced = []


def end_task_produced() -> List[tuple]:
    """The (store, key, nbytes) list the task wrote, for the result frame."""
    produced = getattr(_tls, "produced", None)
    _tls.produced = None
    return produced or []


def note_chunk_written(store: str, key: str, data: bytes) -> None:
    """Storage write hook: cache the stored bytes and record the
    advertisement. A no-op outside an armed fleet worker — and always
    AFTER the durable write, so the store remains the sole durable tier."""
    rt = _runtime
    cfg = _armed
    if rt is None or cfg is None or not cfg.enabled:
        return
    data = bytes(data)  # the store may hand over a view of its buffer
    if not rt.cache.put(store, key, data):
        return  # over budget: advertising an uncached chunk is a lie
    produced = getattr(_tls, "produced", None)
    if produced is not None:
        produced.append((str(store), str(key), len(data)))


def _verify(data: bytes, entry: dict) -> bool:
    return len(data) == entry.get("n") and _crc(data) == entry.get("c")


def _fetch_span_name() -> str:
    """``shuffle_fetch`` inside a rechunk task's exchange window (so the
    analytics layer attributes the time to its own ``shuffle`` bucket),
    ``peer_fetch`` everywhere else."""
    from .shuffle import in_exchange

    return "shuffle_fetch" if in_exchange() else "peer_fetch"


def _count_peer_hit(nbytes: int, saved: int) -> None:
    """Shared hit accounting: ``nbytes`` moved over the peer plane,
    ``saved`` store-read bytes avoided (for a sub-chunk fetch the whole
    chunk read is avoided, so saved > fetched — exactly the point)."""
    from .shuffle import in_exchange

    record_scoped_counter("peer_hits")
    if nbytes:
        record_scoped_counter("peer_bytes_fetched", nbytes)
    if saved:
        record_scoped_counter("store_read_bytes_saved", saved)
    if in_exchange() and nbytes:
        record_scoped_counter("shuffle_bytes_peer", nbytes)


def _fallback(store: str, key: str, reason: str) -> None:
    from ..observability.collect import record_decision

    record_scoped_counter("peer_fetch_fallbacks")
    record_decision(
        "peer_fallback", store=str(store), chunk=str(key), reason=reason
    )


def fetch_chunk(store: str, key: str, entry: dict) -> Optional[bytes]:
    """The read-path entry point: verified raw stored bytes of one chunk
    from the local cache or a peer, or None — in which case the caller
    performs the normal store read (the fallback contract).

    ``entry`` is the chunk's authoritative integrity-manifest record
    (crc32 ``c`` + length ``n``); a chunk without one never takes the peer
    path, so unverifiable bytes can never substitute for store data.
    """
    rt = _runtime
    cfg = _armed
    if rt is None or cfg is None or not cfg.enabled:
        return None
    from .faults import get_injector

    store = str(store)
    # the producer's own downstream task (locality placement's common
    # case): straight out of process memory, no RPC at all
    data = rt.cache.get(store, key)
    if data is not None and _verify(data, entry):
        record_scoped_counter("peer_hits")
        record_scoped_counter("store_read_bytes_saved", len(data))
        return data
    with scope_span(_fetch_span_name(), cat="transfer", key=key) as sp:
        inj = get_injector()
        act = (
            inj.peer_fetch_fault(f"{store}/{key}") if inj is not None else None
        )
        if act == "drop":
            # the reply vanished on the wire: indistinguishable from a
            # fetch timeout — fall back
            _fallback(store, key, "injected_drop")
            record_scoped_counter("peer_misses")
            sp.attrs["fallback"] = "injected_drop"
            return None
        loc = rt.locate(store, key, cfg.locate_timeout_s)
        if loc is None:
            record_scoped_counter("peer_misses")
            sp.attrs["fallback"] = "no_location"
            return None
        worker, addr = loc
        if worker == rt.wname:
            # the registry says we produced it but the cache no longer has
            # it (evicted): a plain miss, read the store
            record_scoped_counter("peer_misses")
            sp.attrs["fallback"] = "evicted_local"
            return None
        if act == "delay":
            import time as _time

            _time.sleep(inj.config.peer_delay_s)
        data = rt.fetch_bytes(addr, store, key, cfg.fetch_timeout_s)
        if data is None:
            # connect refused/timeout, peer died mid-response, or the
            # peer's cache evicted the chunk: the store has it regardless
            _fallback(store, key, "peer_unreachable_or_miss")
            record_scoped_counter("peer_misses")
            sp.attrs["fallback"] = "peer_unreachable_or_miss"
            return None
        if act == "corrupt" and data:
            flipped = bytearray(data)
            flipped[0] ^= 0x01
            data = bytes(flipped)
        if not _verify(data, entry):
            # wrong bytes off the wire (or an injected corruption): the
            # manifest is authoritative — never use them, never quarantine
            # the (innocent) store file, just read the store
            _fallback(store, key, "checksum_mismatch")
            record_scoped_counter("peer_misses")
            sp.attrs["fallback"] = "checksum_mismatch"
            return None
        _count_peer_hit(len(data), len(data))
        sp.attrs["bytes"] = len(data)
        sp.attrs["peer"] = worker
        return data


def fetch_chunk_ranges(
    store: str, key: str, entry: dict, ranges,
) -> tuple:
    """Sub-chunk read-path entry point: ``(payload, attempted)``.

    ``payload`` is the concatenated byte ranges of one chunk from the
    local cache or a peer, or None. ``attempted`` tells the caller what a
    None means: False — the peer path never engaged (disarmed, no
    ranges), so the whole-chunk PEER path may still try; True — a lookup
    or fetch was attempted and missed/failed, and the caller must go
    straight to the store read (retrying the whole-chunk peer path would
    re-draw the fault injector, re-count a miss, and re-dial the same
    peer for one logical read — the fallback accounting here is the
    single authoritative record). The shuffle's bytes-moved win lives
    here: a rechunk target task pulls exactly the regions of each source
    chunk it overlaps (``shuffle.byte_ranges``) instead of whole chunks
    it barely touches.

    Verification is double-layered because the whole-chunk manifest CRC
    cannot check a sub-payload directly: the serving peer returns its
    cached chunk's insert-time crc + length — which must match the
    authoritative manifest ``entry`` (proves the cache copy is the real
    chunk) — plus a crc over the payload itself (proves the sub-bytes
    crossed the wire intact). Either failing is a transparent store
    fallback, like every other peer defect.
    """
    rt = _runtime
    cfg = _armed
    if rt is None or cfg is None or not cfg.enabled or not ranges:
        return None, False
    from .faults import get_injector

    store = str(store)
    want = sum(int(n) for _off, n in ranges)
    local = rt.cache.get_with_crc(store, key)
    if local is not None and _verify(local[0], entry):
        # producer-local: slice process memory, no RPC
        data = local[0]
        payload = b"".join(data[int(o):int(o) + int(n)] for o, n in ranges)
        record_scoped_counter("peer_hits")
        record_scoped_counter("store_read_bytes_saved", entry.get("n") or 0)
        return payload, True
    with scope_span(_fetch_span_name(), cat="transfer", key=key) as sp:
        sp.attrs["ranges"] = len(ranges)
        inj = get_injector()
        act = (
            inj.peer_fetch_fault(f"{store}/{key}") if inj is not None else None
        )
        if act == "drop":
            _fallback(store, key, "injected_drop")
            record_scoped_counter("peer_misses")
            sp.attrs["fallback"] = "injected_drop"
            return None, True
        loc = rt.locate(store, key, cfg.locate_timeout_s)
        if loc is None:
            record_scoped_counter("peer_misses")
            sp.attrs["fallback"] = "no_location"
            return None, True
        worker, addr = loc
        if worker == rt.wname:
            record_scoped_counter("peer_misses")
            sp.attrs["fallback"] = "evicted_local"
            return None, True
        if act == "delay":
            import time as _time

            _time.sleep(inj.config.peer_delay_s)
        reply = rt.fetch_range_reply(
            addr, store, key, ranges, cfg.fetch_timeout_s
        )
        payload = reply.get("data") if reply is not None else None
        if payload is None:
            _fallback(store, key, "peer_unreachable_or_miss")
            record_scoped_counter("peer_misses")
            sp.attrs["fallback"] = "peer_unreachable_or_miss"
            return None, True
        if act == "corrupt" and payload:
            flipped = bytearray(payload)
            flipped[0] ^= 0x01
            payload = bytes(flipped)
        ok = (
            len(payload) == want
            and _crc(payload) == reply.get("crc")
            and reply.get("total") == entry.get("n")
            and reply.get("full_crc") == entry.get("c")
        )
        if not ok:
            _fallback(store, key, "checksum_mismatch")
            record_scoped_counter("peer_misses")
            sp.attrs["fallback"] = "checksum_mismatch"
            return None, True
        record_scoped_counter("peer_range_fetches")
        _count_peer_hit(len(payload), entry.get("n") or 0)
        sp.attrs["bytes"] = len(payload)
        sp.attrs["peer"] = worker
        return payload, True
