"""Plan and result caching for the compute service. Counterpart of
``cubed_tpu/service/cache.py``; the run archive
(``observability/runhistory.py``) keys on the fingerprint too.

Two caches, two keys:

- **Plan cache**: keyed by the *structural fingerprint* of the un-finalized
  plan DAG (:func:`structural_fingerprint`). Two builds of one query
  fingerprint equal though every gensym name and intermediate store path
  differs, so a repeat submission reuses the first build's finalized plan
  and skips optimization and lazy-array creation (``plan_cache_hits``). A
  finalized plan holds no tensor of its own: the device executor's
  residency (``runtime/executors/cuda.py``) keeps and charges the device
  constants it reads, once.
- **Result cache**: keyed by the fingerprint plus a digest of the source
  arrays' integrity manifests (:func:`input_state_digest`). A hit returns
  a copy of the prior run's host array with no task run
  (``result_cache_hits``); a changed manifest changes the digest and drops
  the stale entry (``result_cache_invalidations``). Entries are numpy
  copies on the host, never tensors on the card, LRU-evicted by a byte
  budget (``result_cache_evictions``).

:func:`structural_fingerprint` hashes an un-finalized plan DAG so that two
builds of the same query fingerprint equal, though every gensym name and
intermediate store path differs, and two different queries differ. The
canonical payload masks what does not affect the computed values (store
paths of this process's intermediates -> order-of-first-use tokens, the
Spec, provenance) and keeps what does: shapes, dtypes, chunking, in-memory
input bytes by digest, RNG bases, and the block functions.

The JAX package pickles the payload with cloudpickle; the port describes it
with the device executor's segment describer (``runtime/executors/cuda.py:
_Describer``: a function by its module, qualified name, code, defaults,
closure values and the globals it reads, each described the same way), with
the fingerprint's masking: a stored input's or a user-named target's path
is kept, host arrays of any size are hashed, and a tensor is hashed by
shape, dtype and the sha256 of its bytes; a tensor on the card is copied to
the host for that, counted in ``fingerprint_device_bytes`` (this runs only
when a caller fingerprints, as an armed run archive does). Generated plan
names are canonicalized by order of first appearance. Fingerprinting is
best-effort: any failure returns ``(None, None)``.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from ..observability.metrics import get_registry

logger = logging.getLogger(__name__)

#: default byte budget for in-memory result copies
DEFAULT_RESULT_CACHE_BYTES = 256 * 1024 * 1024

#: plan-cache entry bound (finalized plans are cheap: graph metadata only)
MAX_PLAN_ENTRIES = 128


def _node_counter(name: str) -> Tuple[int, str]:
    """Sort key recovering creation order from a gensym'd node name.

    Every plan identifier is ``{prefix}-{counter:09d}`` with one shared
    process-global counter, so sorting by the numeric suffix reproduces
    build order, which is the same across two builds of the same code even
    though the absolute counter values differ."""
    tail = name.rsplit("-", 1)[-1]
    if tail.isdigit():
        return (int(tail), "")
    return (-1, name)  # non-gensym nodes (create-arrays) sort first, by name


def canonical_node_order(dag) -> List[str]:
    """The dag's node names in build order (stable across rebuilds)."""
    return sorted((str(n) for n in dag.nodes), key=_node_counter)


def _is_temp_store(store: str) -> bool:
    """True when a store path is one of this process's build-local
    intermediates (under the ``work_dir/CONTEXT_ID`` temp directory), the
    only paths the fingerprint may mask as noise."""
    from ..core.plan import CONTEXT_ID

    return CONTEXT_ID in store


def _tensor_token(t) -> str:
    """``tensor:<shape>:<dtype>:<sha256>`` of a tensor's values; a tensor on
    the card is copied to the host for it, and counted."""
    import torch

    t = t.detach()
    if t.device.type != "cpu":
        get_registry().counter("fingerprint_device_bytes").inc(t.element_size() * t.numel())
        t = t.cpu()
    data = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return f"tensor:{tuple(t.shape)}:{t.dtype}:{hashlib.sha256(data).hexdigest()}"


def structural_fingerprint(dag) -> Tuple[Optional[str], Optional[List[str]]]:
    """``(sha256 hexdigest, canonical node order)`` of a plan dag, or
    ``(None, None)`` when fingerprinting fails.

    Two dags of structurally identical queries (same ops, same block
    functions and closures, same shapes, dtypes and chunking, same in-memory
    input bytes) fingerprint equal; the canonical order maps this build's
    node names to another build's at the same position."""
    import torch

    from ..runtime.executors.cuda import _Describer, _tokenize

    class _FingerprintDescriber(_Describer):
        """The segment describer with the fingerprint's masking: only this
        process's intermediates become store tokens, seeds are kept (a
        different seed is a different result), and host arrays and tensors
        of any size are hashed by value."""

        def store(self, path) -> str:
            path = str(path)
            return super().store(path) if _is_temp_store(path) else path

        def _describe(self, obj):
            if isinstance(obj, torch.Tensor):
                return ("tensor", _tensor_token(obj))
            if isinstance(obj, np.ndarray) and not obj.dtype.hasobject:
                return ("ndarray", obj.shape, str(obj.dtype),
                        hashlib.sha256(np.ascontiguousarray(obj).tobytes()).hexdigest())
            return super()._describe(obj)

    canonical = canonical_node_order(dag)
    index = {n: i for i, n in enumerate(canonical)}
    describe = _FingerprintDescriber(masked=set())
    try:
        payload = []
        for name in canonical:
            node = dag.nodes[name]
            if node.get("type") == "op":
                pop = node.get("primitive_op")
                payload.append(("op", node.get("op_name"), pop.num_tasks if pop is not None else None,
                                describe(pop.pipeline.config) if pop is not None and pop.pipeline is not None
                                else None))
            else:
                payload.append(("array", describe(node.get("target"))))
        payload.append(("edges", tuple(sorted((index[str(u)], index[str(v)]) for u, v in dag.edges()))))
        desc = _tokenize(tuple(payload), set(canonical) | describe.names, {})
    except Exception:
        logger.debug("plan fingerprinting failed", exc_info=True)
        return None, None
    return hashlib.sha256(repr(desc).encode()).hexdigest(), canonical


# ----------------------------------------------------------------------
# input state (what the result cache invalidates on)
# ----------------------------------------------------------------------


def _manifest_digest(store: str) -> Optional[str]:
    """Digest of a local zarr store's integrity-manifest shards (falling
    back to the chunk listing when no manifest exists). ``None`` when the
    store isn't a readable local directory — the caller treats that input
    as uncacheable rather than guessing."""
    import os

    if "://" in store and not store.startswith("file://"):
        return None
    path = store.replace("file://", "")
    if not os.path.isdir(path):
        return None
    h = hashlib.sha256()
    try:
        names = sorted(os.listdir(path))
        manifest_names = [
            n for n in names
            if n.startswith(".manifest-") and n.endswith(".json")
        ]
        if manifest_names:
            for n in manifest_names:
                h.update(n.encode())
                with open(os.path.join(path, n), "rb") as f:
                    h.update(f.read())
        else:
            # no integrity manifests (plain zarr input): fall back to the
            # chunk listing with sizes + mtimes — coarser, still catches
            # any rewrite of the store
            for n in names:
                st = os.stat(os.path.join(path, n))
                h.update(f"{n}:{st.st_size}:{st.st_mtime_ns}".encode())
    except OSError:
        return None
    return h.hexdigest()


def input_state_digest(dag) -> Optional[str]:
    """One digest over every STORED source array's manifest state.

    In-memory virtual inputs are already value-hashed inside the
    structural fingerprint; this covers the zarr-backed sources whose
    bytes live outside the plan. Returns ``None`` when any source store
    can't be digested (remote store, vanished directory) — the result
    cache then refuses to serve for this plan rather than risk staleness.
    """
    from ..storage.store import ZarrV2Array

    h = hashlib.sha256()
    for name in canonical_node_order(dag):
        node = dag.nodes[name]
        if node.get("type") != "array":
            continue
        target = node.get("target")
        if isinstance(target, ZarrV2Array):
            d = _manifest_digest(str(target.store))
            if d is None:
                return None
            h.update(d.encode())
    return h.hexdigest()


# ----------------------------------------------------------------------
# the caches
# ----------------------------------------------------------------------


class PlanCacheEntry:
    __slots__ = ("finalized", "canonical")

    def __init__(self, finalized, canonical: List[str]):
        self.finalized = finalized
        self.canonical = canonical


class PlanCache:
    """fingerprint -> finalized plan (+ the source dag's canonical order,
    for mapping a new build's output names onto the cached build)."""

    def __init__(self, max_entries: int = MAX_PLAN_ENTRIES):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, PlanCacheEntry]" = OrderedDict()

    def get(self, fingerprint: Optional[str]) -> Optional[PlanCacheEntry]:
        if fingerprint is None:
            return None
        with self._lock:
            entry = self._entries.get(fingerprint)
            if entry is not None:
                self._entries.move_to_end(fingerprint)
                get_registry().counter("plan_cache_hits").inc()
            else:
                get_registry().counter("plan_cache_misses").inc()
            return entry

    def peek(self, fingerprint: Optional[str]) -> Optional[PlanCacheEntry]:
        """Entry lookup that touches neither the hit/miss counters nor the
        LRU order — for the overload feasibility estimator (reading the
        cached plan's task count), not for serving plans."""
        if fingerprint is None:
            return None
        with self._lock:
            return self._entries.get(fingerprint)

    def put(
        self, fingerprint: Optional[str], finalized, canonical: List[str],
    ) -> None:
        if fingerprint is None:
            return
        with self._lock:
            self._entries[fingerprint] = PlanCacheEntry(finalized, canonical)
            self._entries.move_to_end(fingerprint)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class ResultCacheEntry:
    __slots__ = ("value", "input_digest", "nbytes", "compute_id")

    def __init__(self, value: np.ndarray, input_digest: str,
                 compute_id: Optional[str] = None):
        self.value = value
        self.input_digest = input_digest
        self.nbytes = int(value.nbytes)
        self.compute_id = compute_id


class ResultCache:
    """fingerprint -> (input digest, bounded in-memory result copy).

    A lookup whose fingerprint matches but whose freshly-computed input
    digest does NOT is an *invalidation*: the stale entry is dropped
    (``result_cache_invalidations``) and the caller recomputes. Serving a
    hit returns a copy — cached bytes must never alias a caller's
    mutable array."""

    def __init__(self, max_bytes: int = DEFAULT_RESULT_CACHE_BYTES):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, ResultCacheEntry]" = OrderedDict()
        self._bytes = 0

    def lookup(
        self, fingerprint: Optional[str], input_digest: Optional[str],
    ) -> Optional[np.ndarray]:
        reg = get_registry()
        if fingerprint is None or input_digest is None:
            reg.counter("result_cache_misses").inc()
            return None
        with self._lock:
            entry = self._entries.get(fingerprint)
            if entry is None:
                reg.counter("result_cache_misses").inc()
                return None
            if entry.input_digest != input_digest:
                # a source store's manifest changed under the cached
                # fingerprint: drop the fossil, force recompute
                del self._entries[fingerprint]
                self._bytes -= entry.nbytes
                reg.counter("result_cache_invalidations").inc()
                reg.counter("result_cache_misses").inc()
                return None
            self._entries.move_to_end(fingerprint)
            reg.counter("result_cache_hits").inc()
            value = entry.value
        # the (possibly large) defensive copy happens OUTSIDE the lock so
        # concurrent lookups don't serialize behind a memcpy; the cached
        # array itself is never mutated, only replaced
        return np.array(value, copy=True)

    def put(
        self, fingerprint: Optional[str], input_digest: Optional[str],
        value: np.ndarray, compute_id: Optional[str] = None,
    ) -> bool:
        if fingerprint is None or input_digest is None:
            return False
        value = np.asarray(value)
        if value.nbytes > self.max_bytes:
            return False  # one oversize result must not flush everything
        entry = ResultCacheEntry(
            np.array(value, copy=True), input_digest, compute_id
        )
        reg = get_registry()
        with self._lock:
            old = self._entries.pop(fingerprint, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[fingerprint] = entry
            self._bytes += entry.nbytes
            while self._bytes > self.max_bytes and self._entries:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= evicted.nbytes
                reg.counter("result_cache_evictions").inc()
        return True

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
