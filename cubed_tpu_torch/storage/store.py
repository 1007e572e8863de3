"""A minimal, dependency-free Zarr-v2 chunked array store on a local directory.

Counterpart of ``cubed_tpu/storage/store.py``, trimmed to local directories.
The on-disk layout is the standard Zarr v2 one the JAX package writes: a
``.zarray`` JSON document and one C-order file per chunk, named by
``.``-separated chunk indices, raw or compressed by one of the stdlib codecs
(zlib, gzip, bz2, lzma). Each chunk write is atomic and durable: temp file,
fsync, rename, fsync of the directory. That is what makes a re-run or
duplicate task safe, and it is kept whole here. Every chunk read and write is
counted as stored (the compressed length on a compressed store) and spanned
(``storage_read`` / ``storage_write``) by ``observability/accounting.py``,
against the task scope that does it, else the process registry.

The reliability layers sit here as in the reference (its ``store.py``
:100-145 and :530-540): every chunk write records its checksum in the
array's sidecar manifest, and under ``integrity="verify"`` every task-scope
read is verified (``storage/integrity.py``); a resume scan verifies every
chunk (:meth:`ZarrV2Array.verify_chunks`); the fault injector's storage
sites fire inside task scopes (``runtime/faults.py``); throttles are paced
by the store's health breaker (``storage/health.py``); transient read
errors retry in place; and the compute's cancellation token is checked
between chunk reads and writes (``runtime/cancellation.py``). Remote
(fsspec) stores are not ported.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import time
import uuid
from typing import Any, Optional, Sequence
from urllib.parse import urlsplit

import numpy as np

from ..chunks import blockdims_from_blockshape
from ..observability.accounting import (
    record_bytes_read,
    record_bytes_written,
    record_scoped_counter,
    scope_span,
)
from ..observability.metrics import get_registry
from ..runtime import cancellation
from ..runtime.faults import FaultInjectedIOError, FaultInjectedThrottleError, get_injector
from ..runtime.resilience import RetryPolicy
from . import health, integrity
from .integrity import ChunkIntegrityError

logger = logging.getLogger(__name__)

#: a crashed writer's orphaned ``.tmp`` is only swept once it is this old
ORPHAN_TMP_MAX_AGE_S = 60.0

#: in-place retries of a chunk read's transient IO error (the reference's
#: default), with short backoff
_READ_RETRY_POLICY = RetryPolicy(retries=2, backoff_base=0.02, backoff_max=0.5)


def _local_root(store: str) -> str:
    store = str(store)
    if urlsplit(store).scheme not in ("", "file"):
        raise ValueError(
            f"cubed_tpu_torch stores are local directories; got {store!r}"
        )
    return store[7:] if store.startswith("file://") else store


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync after a rename, so the new entry is durable."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class _LocalIO:
    """Direct filesystem IO for a store directory."""

    def __init__(self, root: str):
        self.root = root

    def makedirs(self) -> None:
        os.makedirs(self.root, exist_ok=True)

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.root, name))

    def read_bytes(self, name: str) -> bytes:
        injector = get_injector()
        if injector is not None:
            if injector.storage_throttle_fault(_fault_key(self.root, name)):
                raise FaultInjectedThrottleError(f"injected store throttle (503 SlowDown): {name}")
            if injector.storage_read_fault(_fault_key(self.root, name)):
                raise FaultInjectedIOError(f"injected read failure: {name}")
        with open(os.path.join(self.root, name), "rb") as f:
            return f.read()

    def write_bytes_atomic(self, name: str, data, inject: bool = True) -> None:
        path = os.path.join(self.root, name)
        tmp = path + f".{uuid.uuid4().hex[:8]}.tmp"
        injector = get_injector() if inject else None
        if injector is not None:
            key = _fault_key(self.root, name)
            if injector.storage_throttle_fault(key):
                # a throttled write touches nothing: the request was refused
                raise FaultInjectedThrottleError(f"injected store throttle (503 SlowDown): {name}")
            if injector.storage_write_fault(key):
                if injector.config.storage_write_leaves_tmp:
                    # a writer killed mid-write: a partial temp file is left
                    # behind, the chunk itself untouched
                    with open(tmp, "wb") as f:
                        f.write(data[: max(1, len(data) // 2)])
                raise FaultInjectedIOError(f"injected write failure: {name}")
            # seeded bit-flip or truncation: the write "succeeds" with wrong
            # bytes, which only the checksum (of the bytes meant) can catch
            corrupted = injector.storage_corrupt_fault(key, data)
            if corrupted is not None:
                data = corrupted
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            # fsync before rename: a host crash must not leave a renamed
            # but empty chunk
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic on POSIX
        _fsync_dir(os.path.dirname(path))

    def rename(self, old: str, new: str) -> None:
        os.replace(os.path.join(self.root, old), os.path.join(self.root, new))

    def append_bytes(self, name: str, data: bytes) -> None:
        """O_APPEND write for the manifest's JSONL shards: one writer per shard
        by construction, no fsync (the loader skips a torn tail line)."""
        with open(os.path.join(self.root, name), "ab") as f:
            f.write(data)

    def list_names(self) -> list[str]:
        try:
            return os.listdir(self.root)
        except FileNotFoundError:
            return []

    def sweep_tmp(self, max_age_s: float = ORPHAN_TMP_MAX_AGE_S) -> int:
        """Remove ``*.tmp`` files old enough that no live writer owns them."""
        removed = 0
        now = time.time()
        for name in self.list_names():
            if not name.endswith(".tmp"):
                continue
            path = os.path.join(self.root, name)
            try:
                if now - os.path.getmtime(path) < max_age_s:
                    continue
                os.unlink(path)
                removed += 1
            except OSError:
                continue
        if removed:
            get_registry().counter("orphan_tmps_swept").inc(removed)
        return removed


def _fault_key(root: str, name: str) -> str:
    """Injection-decision key: the array's directory name and the chunk
    name, not the full path, so a seeded run replays across work dirs."""
    return f"{os.path.basename(str(root).rstrip('/'))}/{name}"


def _active_breaker(store: str):
    """The store's health breaker, or None when it is disabled."""
    return health.store_breaker(store) if health.breaker_enabled() else None


@contextlib.contextmanager
def _breaker_slot(breaker, key: str):
    """Hold the breaker's IO slot around one IO attempt (retry sleeps run
    outside it); while degraded the wait is a ``throttle_wait`` span, and the
    cancellation token is polled between wait quanta."""
    if breaker is None:
        yield
        return
    if breaker.state == "closed":
        breaker.acquire()
    else:
        with scope_span("throttle_wait", cat="throttle", site="breaker_slot", key=key):
            breaker.acquire(poll=cancellation.check_current)
    try:
        yield
    finally:
        breaker.release()


def _note_throttle(store: str, breaker) -> float:
    """Count a throttle (``store_throttled``) and step the breaker down;
    returns its paced retry delay."""
    record_scoped_counter("store_throttled")
    if breaker is not None:
        return breaker.on_throttle()
    return 0.0


def _encode_dtype(dtype: np.dtype) -> Any:
    if dtype.fields is not None:
        return [[name, dtype.fields[name][0].str] for name in dtype.names]
    return dtype.str


def _decode_dtype(d: Any) -> np.dtype:
    if isinstance(d, list):
        return np.dtype([(name, dt) for name, dt in d])
    return np.dtype(d)


def _codec_from_meta(comp: Optional[dict]):
    """(compress, decompress) callables for a Zarr v2 ``compressor`` config.

    Covers the numcodecs ids expressible with the stdlib: ``zlib``, ``gzip``,
    ``bz2`` and ``lzma``. Any other id (blosc among them) needs the numcodecs
    C library and raises ``ValueError`` rather than reading garbage."""
    if comp is None:
        return None
    cid = comp.get("id")
    if cid == "zlib":
        import zlib

        level = int(comp.get("level", 1))
        return (lambda b: zlib.compress(b, level)), zlib.decompress
    if cid == "gzip":
        import gzip

        level = int(comp.get("level", 1))
        return (lambda b: gzip.compress(b, compresslevel=level)), gzip.decompress
    if cid == "bz2":
        import bz2

        level = int(comp.get("level", 1))
        return (lambda b: bz2.compress(b, level)), bz2.decompress
    if cid == "lzma":
        import lzma

        preset = comp.get("preset")
        fmt = comp.get("format", lzma.FORMAT_XZ)
        filters = comp.get("filters")
        # a FORMAT_RAW stream cannot be decoded without its filter chain, but
        # the container formats (XZ/ALONE) embed it and lzma.decompress
        # refuses an explicit filters argument for them
        if fmt == lzma.FORMAT_RAW:
            decompress = lambda b: lzma.decompress(  # noqa: E731
                b, format=lzma.FORMAT_RAW, filters=filters
            )
        else:
            decompress = lzma.decompress
        return (
            lambda b: lzma.compress(b, format=fmt, preset=preset, filters=filters),
            decompress,
        )
    raise ValueError(
        f"Unsupported Zarr compressor {cid!r}: this store supports the "
        "stdlib codecs zlib/gzip/bz2/lzma (blosc and friends need the "
        "numcodecs C library)"
    )


def _encode_fill(fill_value: Any, dtype: np.dtype) -> Any:
    if fill_value is None:
        return None
    if dtype.kind == "f":
        f = float(fill_value)
        if np.isnan(f):
            return "NaN"
        if np.isinf(f):
            return "Infinity" if f > 0 else "-Infinity"
        return f
    if dtype.kind in "iu":
        return int(fill_value)
    if dtype.kind == "b":
        return bool(fill_value)
    return None


def _decode_fill(v: Any) -> Any:
    return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}.get(v, v) if isinstance(v, str) else v


class ZarrV2Array:
    """A chunked N-dimensional array persisted in Zarr v2 directory format."""

    def __init__(self, store: str, meta: dict):
        self.store = str(store)
        self._io = _LocalIO(_local_root(store))
        self.compressor: Optional[dict] = meta.get("compressor")
        self._codec = _codec_from_meta(self.compressor)
        self.shape: tuple[int, ...] = tuple(meta["shape"])
        self.chunks: tuple[int, ...] = tuple(meta["chunks"])
        self.dtype: np.dtype = _decode_dtype(meta["dtype"])
        self.fill_value = _decode_fill(meta.get("fill_value"))
        #: merged checksum manifest, loaded at the first verified read
        self._manifest_cache: Optional[tuple[dict, bool]] = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def cdata_shape(self) -> tuple[int, ...]:
        """Number of chunks along each dimension."""
        return tuple(max(1, -(-s // c)) for s, c in zip(self.shape, self.chunks)) if self.shape else ()

    @property
    def nchunks(self) -> int:
        return int(np.prod(self.cdata_shape)) if self.shape else 1

    def _chunk_names(self) -> list[str]:
        """Names of the chunk files present: digit-dotted keys only (no
        metadata, manifests, ``.tmp`` litter or ``*.quarantine.*``)."""
        out = []
        for name in self._io.list_names():
            if name.startswith(".") or name.endswith(".tmp"):
                continue
            if all(p.lstrip("-").isdigit() for p in name.split(".")):
                out.append(name)
        return out

    @property
    def nchunks_initialized(self) -> int:
        """Number of chunk files present (the existence-only resume count)."""
        return len(self._chunk_names())

    def chunkset(self) -> tuple[tuple[int, ...], ...]:
        return blockdims_from_blockshape(self.shape, self.chunks)

    # -- chunk IO ----------------------------------------------------------

    @staticmethod
    def _chunk_key(idx: tuple[int, ...]) -> str:
        return ".".join(str(int(i)) for i in idx) if idx else "0"

    def _read_chunk(self, idx: tuple[int, ...]) -> Optional[np.ndarray]:
        """The full (padded) chunk at block index *idx*, or None if absent."""
        key = self._chunk_key(idx)
        # between chunk reads is a safe abort boundary
        cancellation.check_current()
        verify = integrity.verify_reads_active()
        if not self._io.exists(key):
            if verify and key in self._manifest()[0]:
                # the manifest says it was written: its absence is an
                # integrity failure (quarantined, or lost), never fill values
                record_scoped_counter("chunks_corrupt_detected")
                raise ChunkIntegrityError(
                    f"chunk {key} of {self.store} is recorded in the manifest but missing from the store",
                    store=self.store, chunk_key=key, kind="missing",
                )
            return None
        with scope_span("storage_read", cat="storage", key=key) as sp:
            data = self._read_bytes_with_retries(key)
            sp.attrs["bytes"] = len(data)
        # bytes as stored (before decompression)
        record_bytes_read(self.store, len(data))
        if verify:
            with scope_span("integrity_verify", cat="integrity", key=key):
                self._verify_chunk_bytes(key, data)
        if self._codec is not None:
            data = self._codec[1](data)
        arr = np.frombuffer(data, dtype=self.dtype)
        return arr.reshape(self.chunks if self.shape else ())

    def _manifest(self) -> tuple[dict, bool]:
        """Merged checksum manifest ``(entries, had_shards)``, cached per
        instance (instances are opened per task)."""
        if self._manifest_cache is None:
            self._manifest_cache = integrity.load_manifest(self._io)
        return self._manifest_cache

    def _verify_chunk_bytes(self, key: str, data: bytes) -> None:
        """Verify stored chunk bytes against the manifest; on a mismatch
        quarantine the file and raise :class:`ChunkIntegrityError`. A chunk
        with no entry passes unverified (nothing to check against)."""
        entry = self._manifest()[0].get(key)
        if entry is None:
            return
        record_scoped_counter("chunks_verified")
        actual = (integrity.checksum(data), len(data))
        expected = (entry.get("c"), entry.get("n"))
        if actual != expected:
            record_scoped_counter("chunks_corrupt_detected")
            integrity.quarantine_chunk(self._io, key, store=self.store)
            raise ChunkIntegrityError(
                f"chunk {key} of {self.store} failed checksum verification "
                f"(expected crc32={expected[0]} len={expected[1]}, got "
                f"crc32={actual[0]} len={actual[1]}); file quarantined",
                store=self.store, chunk_key=key, kind="checksum",
                expected=expected, actual=actual,
            )

    def verify_chunks(self, quarantine: bool = True, verify: bool = True,
                      count: bool = True) -> tuple[set, list, bool]:
        """Verify every stored chunk against the manifest.

        Returns ``(valid, corrupt, verified)``: the chunk keys whose bytes
        match their checksum, those that failed (renamed to
        ``*.quarantine.*`` with *quarantine*), and whether verification ran.
        With no manifest, or ``verify=False`` (a resume under
        ``integrity="off"``), every present chunk is valid and ``verified``
        is False: existence-only accounting. ``count=False`` keeps the scan
        off the metrics (plan introspection). A chunk present but absent
        from the manifest is reported corrupt (untrusted) but never
        quarantined: re-running its producer overwrites it in place."""
        names = self._chunk_names()
        if not verify:
            return set(names), [], False
        entries, had_shards = integrity.load_manifest(self._io)
        if not had_shards:
            return set(names), [], False
        valid: set = set()
        corrupt: list = []
        for name in names:
            entry = entries.get(name)
            ok = False
            if entry is not None:
                try:
                    data = self._io.read_bytes(name)
                except OSError:
                    data = None
                ok = data is not None and len(data) == entry.get("n") and integrity.checksum(data) == entry.get("c")
                if count:
                    record_scoped_counter("chunks_verified")
            if ok:
                valid.add(name)
            else:
                corrupt.append(name)
                if count:
                    record_scoped_counter("chunks_corrupt_detected")
                if quarantine and entry is not None:
                    integrity.quarantine_chunk(self._io, name, store=self.store)
        return valid, corrupt, True

    def _read_bytes_with_retries(self, key: str) -> bytes:
        """A chunk read that retries transient IO errors in place (two cheap
        retries absorb a blip a task retry would pay for with all its work),
        and throttles with the breaker's pacing. A ``FileNotFoundError``
        after ``exists()`` retries like any OSError: it must never read as
        an absent chunk (fill values in place of real data)."""
        policy = _READ_RETRY_POLICY
        breaker = _active_breaker(self.store)
        failures = throttles = 0
        while True:
            try:
                with _breaker_slot(breaker, key):
                    data = self._io.read_bytes(key)
                if breaker is not None:
                    breaker.on_success()
                return data
            except OSError as exc:
                if health.is_throttle_error(exc):
                    throttles += 1
                    delay = _note_throttle(self.store, breaker)
                    if breaker is None or throttles > health.THROTTLE_IO_RETRIES:
                        raise
                    if delay > 0:
                        with scope_span("throttle_wait", cat="throttle", site="storage_read", key=key):
                            time.sleep(delay)
                    cancellation.check_current()
                    continue
                failures += 1
                if failures > policy.retries:
                    raise
                delay = policy.backoff_delay(failures)
                logger.info("retrying chunk read %s/%s (attempt %d) in %.3fs: %s",
                            self.store, key, failures + 1, delay, exc)
                get_registry().counter("storage_read_retries").inc()
                if delay > 0:
                    with scope_span("retry_sleep", cat="retry", site="storage_read", key=key):
                        time.sleep(delay)

    def _write_chunk(self, idx: tuple[int, ...], arr: np.ndarray) -> None:
        # checked before the write starts: an abort never interrupts an
        # atomic chunk write, so the store and its manifest stay consistent
        cancellation.check_current()
        arr = np.ascontiguousarray(arr, dtype=self.dtype)
        data = memoryview(arr).cast("B")
        if self._codec is not None:
            data = self._codec[0](data)
        key = self._chunk_key(idx)
        with scope_span("storage_write", cat="storage", key=key, bytes=len(data)):
            self._write_bytes_throttle_paced(key, data)
            if integrity.current_mode() != "off":
                # after the chunk's write: a crash between the two leaves a
                # chunk without an entry (re-run on resume), never an entry
                # without its chunk
                entry = integrity.record_checksum(self._io, self.store, key, data)
                if self._manifest_cache is not None:
                    self._manifest_cache[0][key] = entry
                    self._manifest_cache = (self._manifest_cache[0], True)
        record_bytes_written(self.store, len(data))

    def _write_bytes_throttle_paced(self, key: str, data) -> None:
        """Atomic chunk write with the breaker's paced in-place retries for
        throttles only; any other failure goes to the task level."""
        breaker = _active_breaker(self.store)
        throttles = 0
        while True:
            try:
                with _breaker_slot(breaker, key):
                    self._io.write_bytes_atomic(key, data)
                if breaker is not None:
                    breaker.on_success()
                return
            except OSError as exc:
                if not health.is_throttle_error(exc):
                    raise
                throttles += 1
                delay = _note_throttle(self.store, breaker)
                if breaker is None or throttles > health.THROTTLE_IO_RETRIES:
                    raise
                if delay > 0:
                    with scope_span("throttle_wait", cat="throttle", site="storage_write", key=key):
                        time.sleep(delay)
                cancellation.check_current()

    def _empty_chunk(self) -> np.ndarray:
        fill = self.fill_value if self.fill_value is not None else 0
        return np.full(self.chunks if self.shape else (), fill, dtype=self.dtype)

    # -- indexing ----------------------------------------------------------

    def _normalize_key(self, key) -> tuple[slice, ...]:
        if not isinstance(key, tuple):
            key = (key,)
        if Ellipsis in key:
            i = key.index(Ellipsis)
            key = key[:i] + (slice(None),) * (self.ndim - (len(key) - 1)) + key[i + 1 :]
        key = key + (slice(None),) * (self.ndim - len(key))
        out = []
        for k, s in zip(key, self.shape):
            if isinstance(k, (int, np.integer)):
                k = int(k) + (s if k < 0 else 0)
                out.append(slice(k, k + 1))
            elif isinstance(k, slice):
                out.append(slice(*k.indices(s)))
            else:
                raise IndexError(f"Unsupported index {k!r}")
        return tuple(out)

    def __getitem__(self, key) -> np.ndarray:
        if self.ndim == 0:
            chunk = self._read_chunk(())
            return chunk if chunk is not None else self._empty_chunk()
        sel = self._normalize_key(key)
        int_axes = []
        if isinstance(key, tuple):
            int_axes = [i for i, k in enumerate(key) if isinstance(k, (int, np.integer))]
        elif isinstance(key, (int, np.integer)):
            int_axes = [0]
        out_shape = tuple(
            max(0, (s.stop - s.start + (s.step or 1) - 1) // (s.step or 1)) for s in sel
        )
        out = np.empty(out_shape, dtype=self.dtype)
        if out.size == 0:
            return out.squeeze(axis=tuple(int_axes)) if int_axes else out
        for cidx in self._chunks_overlapping(sel):
            c_starts = tuple(i * c for i, c in zip(cidx, self.chunks))
            chunk_sel = []
            out_sel = []
            skip = False
            for s, cs, clen, extent in zip(sel, c_starts, self.chunks, self.shape):
                step = s.step or 1
                lo = max(s.start, cs)
                hi = min(s.stop, cs + clen, extent)
                if step != 1:
                    offset = (lo - s.start) % step
                    if offset:
                        lo += step - offset
                if lo >= hi:
                    skip = True
                    break
                chunk_sel.append(slice(lo - cs, hi - cs, step))
                out_sel.append(slice((lo - s.start) // step, (hi - s.start + step - 1) // step))
            if skip:
                continue
            chunk = self._read_chunk(cidx)
            if chunk is None:
                chunk = self._empty_chunk()
            out[tuple(out_sel)] = chunk[tuple(chunk_sel)]
        if int_axes:
            out = out.squeeze(axis=tuple(int_axes))
        return out

    def __setitem__(self, key, value) -> None:
        if self.ndim == 0:
            self._write_chunk((), np.asarray(value, dtype=self.dtype))
            return
        sel = self._normalize_key(key)
        if any((s.step or 1) != 1 for s in sel):
            raise IndexError("strided writes not supported")
        region_shape = tuple(s.stop - s.start for s in sel)
        value = np.broadcast_to(np.asarray(value, dtype=self.dtype), region_shape)
        for cidx in self._chunks_overlapping(sel):
            c_starts = tuple(i * c for i, c in zip(cidx, self.chunks))
            chunk_sel = []
            val_sel = []
            full_cover = True
            for s, cs, clen, extent in zip(sel, c_starts, self.chunks, self.shape):
                lo = max(s.start, cs)
                hi = min(s.stop, cs + clen)
                chunk_sel.append(slice(lo - cs, hi - cs))
                val_sel.append(slice(lo - s.start, hi - s.start))
                if lo > cs or hi < min(cs + clen, extent):
                    full_cover = False
            piece = value[tuple(val_sel)]
            covered_extent = tuple(
                min(cs + clen, ext) - cs
                for cs, clen, ext in zip(c_starts, self.chunks, self.shape)
            )
            if full_cover and covered_extent == self.chunks:
                self._write_chunk(cidx, piece)
            elif full_cover:
                # an edge chunk wholly covered within the array: pad it
                chunk = self._empty_chunk()
                chunk[tuple(slice(0, e) for e in covered_extent)] = piece
                self._write_chunk(cidx, chunk)
            else:
                chunk = self._read_chunk(cidx)
                chunk = self._empty_chunk() if chunk is None else chunk.copy()
                chunk[tuple(chunk_sel)] = piece
                self._write_chunk(cidx, chunk)

    def _chunks_overlapping(self, sel: tuple[slice, ...]):
        ranges = []
        for s, c in zip(sel, self.chunks):
            first = s.start // c
            last = max(first, (max(s.stop - 1, s.start)) // c)
            ranges.append(range(first, last + 1))
        return itertools.product(*ranges)

    @property
    def oindex(self) -> "_OIndex":
        """Orthogonal indexing: per axis a slice (any step) or an integer array."""
        return _OIndex(self)

    def __repr__(self) -> str:
        return f"ZarrV2Array<{self.store}, shape={self.shape}, dtype={self.dtype}, chunks={self.chunks}>"


class _OIndex:
    """Reads the selected positions chunk by chunk: along each axis the
    positions are grouped by the chunk that holds them."""

    def __init__(self, array: ZarrV2Array):
        self.array = array

    def __getitem__(self, key) -> np.ndarray:
        from .virtual import oindex_lists

        a = self.array
        index_lists = oindex_lists(key, a.shape)
        out = np.empty(tuple(len(ix) for ix in index_lists), dtype=a.dtype)
        if not out.size:
            return out
        axis_groups = []
        for ax, ix in enumerate(index_lists):
            cidx = ix // a.chunks[ax]
            axis_groups.append({
                int(c): (ix[cidx == c] - c * a.chunks[ax], np.flatnonzero(cidx == c)) for c in np.unique(cidx)
            })
        for combo in itertools.product(*(g.items() for g in axis_groups)):
            chunk = a._read_chunk(tuple(c for c, _ in combo))
            if chunk is None:
                chunk = a._empty_chunk()
            out[np.ix_(*[pos for _, (_, pos) in combo])] = chunk[np.ix_(*[within for _, (within, _) in combo])]
        return out


def open_zarr_array(
    store: str,
    mode: str,
    shape: Optional[Sequence[int]] = None,
    dtype: Any = None,
    chunks: Optional[Sequence[int]] = None,
    fill_value: Any = None,
    compressor: Optional[dict] = None,
) -> ZarrV2Array:
    """Open (``r``: must exist; ``a``: open or create) a Zarr v2 array.

    ``compressor`` (a numcodecs-style config such as ``{"id": "zlib",
    "level": 1}``) applies only when the array is created: mode ``a`` on an
    existing array keeps the metadata, compressor included, as it is."""
    io = _LocalIO(_local_root(store))
    if mode != "r":
        io.sweep_tmp()
    meta_exists = io.exists(".zarray")
    if mode == "r" or (mode == "a" and meta_exists):
        if not meta_exists:
            raise FileNotFoundError(f"No zarr array at {store}")
        try:
            return ZarrV2Array(store, json.loads(io.read_bytes(".zarray")))
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as exc:
            # a corrupt .zarray: a reader fails loudly; a writer with the
            # creation parameters quarantines it and writes it anew (chunk
            # data untouched: a verified resume decides per chunk)
            if mode == "r" or shape is None or dtype is None:
                raise ValueError(
                    f"corrupt .zarray metadata at {store}: {exc!r} (reopen in a writer mode with shape/dtype "
                    "to recreate it)"
                ) from exc
            logger.warning("quarantining corrupt .zarray at %s and recreating metadata (%s)", store, exc)
            try:
                io.rename(".zarray", f".zarray.quarantine.{int(time.time() * 1000)}")
            except OSError:
                pass
            get_registry().counter("zarray_meta_recreated").inc()
    if shape is None or dtype is None:
        raise ValueError("shape and dtype required to create a new array")
    dtype = np.dtype(dtype)
    shape = tuple(int(s) for s in shape)
    if chunks is None:
        chunks = shape
    chunks = tuple(int(c) for c in chunks) if shape else ()
    chunks = tuple(min(c, s) if s > 0 else max(1, c) for c, s in zip(chunks, shape))
    if compressor is not None:
        _codec_from_meta(compressor)  # an unsupported id fails at create time
    meta = {
        "zarr_format": 2,
        "shape": list(shape),
        "chunks": [max(1, c) for c in chunks] if shape else [],
        "dtype": _encode_dtype(dtype),
        "compressor": dict(compressor) if compressor is not None else None,
        "fill_value": _encode_fill(fill_value if fill_value is not None else 0, dtype),
        "order": "C",
        "filters": None,
        "dimension_separator": ".",
    }
    io.makedirs()
    io.write_bytes_atomic(".zarray", json.dumps(meta).encode())
    return ZarrV2Array(store, meta)
