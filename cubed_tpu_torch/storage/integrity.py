"""End-to-end chunk integrity: checksums, sidecar manifests, quarantine.

Counterpart of ``cubed_tpu/storage/integrity.py``, whole, with the same
on-disk format, so a store written by either package verifies under the
other's functions:

- **Checksums.** Every chunk write records the CRC-32 (``zlib.crc32``) of
  the bytes as stored (after compression), their length and a timestamp.
- **Sidecar manifests** are dot-prefixed keys (``.manifest-<writer>.json``)
  beside ``.zarray``, which plain Zarr v2 readers ignore. Each writer
  process owns one shard per array; local shards are append-only JSONL (one
  line per chunk write, no fsync: a lost tail costs recomputation on
  resume, never correctness). Readers merge all shards, last write wins by
  timestamp; an undecodable shard or line is skipped, so its chunks verify
  as untrustworthy, never as valid.
- **Quarantine.** A chunk that fails verification is renamed to
  ``<key>.quarantine.<ts>`` and counted (``chunks_corrupt_detected`` /
  ``chunks_quarantined``); its manifest entry is kept, so it reads as
  "written but missing", an integrity error, never as fill values.
- **Modes** ``"off" | "write" | "verify"`` (default ``write``): ``write``
  records checksums; ``verify`` also verifies every task-scope chunk read,
  raising :class:`ChunkIntegrityError` (classified RECOMPUTE: the producing
  task re-runs); ``off`` does neither, and resume falls back to
  existence-only accounting. Resolution order: the
  ``CUBED_TPU_TORCH_INTEGRITY`` env var (operator override), then
  ``activate()``/``Spec(integrity=...)`` (armed by ``Plan.execute`` for the
  compute), then ``write``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
import zlib
from typing import Any, Optional

from ..observability.accounting import current_scope, record_scoped_counter

logger = logging.getLogger(__name__)

#: env var overriding the integrity mode everywhere (and how spawned worker
#: processes inherit a Spec-level setting)
INTEGRITY_ENV_VAR = "CUBED_TPU_TORCH_INTEGRITY"

MODES = ("off", "write", "verify")
DEFAULT_MODE = "write"

#: sidecar manifest shard prefix/suffix (dot-prefixed: plain Zarr v2
#: readers and the chunk-name scan both ignore it)
MANIFEST_PREFIX = ".manifest-"
MANIFEST_SUFFIX = ".json"


class ChunkIntegrityError(RuntimeError):
    """A stored chunk failed integrity verification.

    ``kind`` is ``"checksum"`` (content mismatch — bit rot, torn write,
    codec-level corruption) or ``"missing"`` (the manifest says the chunk
    was written but no file exists — e.g. it was quarantined, or the store
    lost it). Carries enough structure (``store``, ``chunk_key``) for the
    runtime to re-run the producing task (RECOMPUTE classification), and
    survives pickling across process/fleet boundaries.
    """

    def __init__(
        self,
        message: str,
        store: Optional[str] = None,
        chunk_key: Optional[str] = None,
        kind: str = "checksum",
        expected: Any = None,
        actual: Any = None,
    ):
        super().__init__(message)
        self.store = store
        self.chunk_key = chunk_key
        self.kind = kind
        self.expected = expected
        self.actual = actual

    def __reduce__(self):
        return (
            ChunkIntegrityError,
            (
                self.args[0] if self.args else "",
                self.store,
                self.chunk_key,
                self.kind,
                self.expected,
                self.actual,
            ),
        )

    @property
    def wire_payload(self) -> dict:
        """Plain-dict form that rides distributed error frames, so the
        coordinator-side retry machinery can locate the producing task
        without sharing the exception object."""
        return {
            "store": self.store,
            "chunk_key": self.chunk_key,
            "kind": self.kind,
            "expected": self.expected,
            "actual": self.actual,
        }


def checksum(data: bytes) -> int:
    """The chunk checksum: CRC-32 of the bytes as stored."""
    return zlib.crc32(data) & 0xFFFFFFFF


# ----------------------------------------------------------------------
# mode resolution
# ----------------------------------------------------------------------

_lock = threading.Lock()
_active_mode: Optional[str] = None


def _validate(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(
            f"invalid integrity mode {mode!r}; expected one of {MODES}"
        )
    return mode


def current_mode() -> str:
    """The effective integrity mode for this process (env > activated >
    default). A malformed env value raises loudly — a typo silently
    downgrading integrity to the default would be worse than an error."""
    raw = os.environ.get(INTEGRITY_ENV_VAR)
    if raw:
        return _validate(raw)
    if _active_mode is not None:
        return _active_mode
    return DEFAULT_MODE


def verify_reads_active() -> bool:
    """True when task-scope chunk reads must be verified: mode ``verify``
    and a task scope is active (plan-construction metadata IO and
    client-side result fetches are never verified — the same boundary the
    fault injector uses)."""
    return current_mode() == "verify" and current_scope() is not None


def activate(mode: Optional[str], export_env: bool = False) -> None:
    """Set the process-global integrity mode (and, with ``export_env``,
    the env var so child processes spawned afterwards inherit it)."""
    global _active_mode
    if mode is not None:
        _validate(mode)
    with _lock:
        _active_mode = mode
    if export_env:
        if mode is None:
            os.environ.pop(INTEGRITY_ENV_VAR, None)
        else:
            os.environ[INTEGRITY_ENV_VAR] = mode


def wire_mode() -> str:
    """The client's resolved mode, attached to every distributed task
    message so pre-started fleet workers mirror the client exactly."""
    return current_mode()


def arm_from_wire(mode: Optional[str]) -> None:
    """Fleet-worker side: adopt the mode a task message carried."""
    global _active_mode
    if mode is not None:
        try:
            _validate(mode)
        except ValueError:
            logger.warning("ignoring invalid integrity mode from wire: %r", mode)
            return
    with _lock:
        _active_mode = mode


class scoped:
    """Arm an integrity mode for a ``with`` block (``Plan.execute`` uses
    this for ``Spec(integrity=...)``); ``None`` is a no-op so callers need
    no conditional. Like fault injection, arming is process-global for the
    duration — tasks run on arbitrary pool threads."""

    def __init__(self, mode: Optional[str] = None, export_env: bool = False):
        self._mode = mode
        self._export_env = export_env

    def __enter__(self):
        if self._mode is None:
            return None
        self._prev = _active_mode
        self._prev_env = os.environ.get(INTEGRITY_ENV_VAR)
        # the env var is the OPERATOR's override and wins over Spec-level
        # modes everywhere (current_mode resolution order) — so when it is
        # already set, arming must not clobber it: the process-global mode
        # is recorded (harmless, env shadows it) but the env passes through
        # to this process and every spawned worker untouched
        activate(
            self._mode,
            export_env=self._export_env and self._prev_env is None,
        )
        return self._mode

    def __exit__(self, *exc) -> None:
        if self._mode is None:
            return
        global _active_mode
        with _lock:
            _active_mode = self._prev
        if self._export_env:
            if self._prev_env is None:
                os.environ.pop(INTEGRITY_ENV_VAR, None)
            else:
                os.environ[INTEGRITY_ENV_VAR] = self._prev_env


# ----------------------------------------------------------------------
# manifest shards
# ----------------------------------------------------------------------

#: this process's writer id (shard filename component); lazy so forked
#: children that never write share nothing
_writer_id: Optional[str] = None

#: store root -> {"entries": {...}, "lock": Lock}; one shard per
#: (process, array store)
_shards: dict = {}
_shards_lock = threading.Lock()


def _get_writer_id() -> str:
    global _writer_id
    if _writer_id is None or _writer_id.split("-", 1)[0] != str(os.getpid()):
        # pid guard: a forked child must not reuse (and clobber) the
        # parent's shard name
        _writer_id = f"{os.getpid()}-{uuid.uuid4().hex[:6]}"
        with _shards_lock:
            _shards.clear()
    return _writer_id


def shard_name() -> str:
    return f"{MANIFEST_PREFIX}{_get_writer_id()}{MANIFEST_SUFFIX}"


def record_checksum(io, store_root: str, chunk_key: str, data: bytes) -> dict:
    """Record ``chunk_key``'s checksum in this process's manifest shard for
    the array at ``store_root``. Returns the recorded entry.

    Local stores append one JSONL line — O(1) per chunk write, no fsync
    (losing an unsynced manifest tail costs recomputation on resume, never
    correctness; the chunk's own write is the fsynced, load-bearing one),
    and a torn trailing line from a crash is skipped by the line-tolerant
    loader without poisoning earlier lines. IO backends without append
    (object stores) fall back to atomically rewriting the whole shard
    document. Shard writes bypass fault injection (``inject=False``) so a
    chaos profile's "chunk write failure rate" means chunk writes."""
    name = shard_name()
    with _shards_lock:
        state = _shards.get(store_root)
        if state is None:
            state = _shards[store_root] = {"entries": {}, "lock": threading.Lock()}
    entry = {"c": checksum(data), "n": len(data), "t": time.time()}
    with state["lock"]:
        state["entries"][chunk_key] = entry
        if hasattr(io, "append_bytes"):
            line = json.dumps({"k": chunk_key, **entry}) + "\n"
            io.append_bytes(name, line.encode())
        else:
            payload = json.dumps(
                {"writer": _get_writer_id(), "entries": state["entries"]}
            ).encode()
            io.write_bytes_atomic(name, payload, inject=False)
    return entry


def _merge_entry(entries: dict, key, ent) -> None:
    """Fold one (key, entry) into the merged view, last-write-wins by
    recorded timestamp on identical keys."""
    if not isinstance(ent, dict) or "c" not in ent or "n" not in ent:
        return
    if not isinstance(key, str):
        return
    prev = entries.get(key)
    if prev is None or ent.get("t", 0) >= prev.get("t", 0):
        entries[key] = ent


def load_manifest(io) -> tuple[dict, bool]:
    """Merge all manifest shards of one array: ``(entries, had_shards)``.

    ``entries`` maps chunk key -> ``{"c": crc, "n": nbytes, "t": ts}``,
    last-write-wins by recorded timestamp on identical keys. ``had_shards``
    is False when no shard file exists at all (an array written with
    integrity off, or by a pre-integrity version) — callers fall back to
    existence-only accounting then. Both shard formats are read: JSONL
    (one ``{"k", "c", "n", "t"}`` line per write — local stores) and a
    whole-document ``{"entries": {...}}`` rewrite (object stores).
    Undecodable content — a whole bad shard, or any single torn/garbage
    line — is skipped: those chunks lose their entries and verify as
    untrustworthy, never valid. Corrupt manifest data can cost
    recomputation, never correctness.
    """
    names = [
        n
        for n in io.list_names()
        if n.startswith(MANIFEST_PREFIX) and n.endswith(MANIFEST_SUFFIX)
    ]
    entries: dict = {}
    had_shards = bool(names)
    for name in names:
        try:
            raw = io.read_bytes(name)
        except OSError:
            logger.warning("skipping unreadable manifest shard %s", name)
            continue
        try:
            # whole-document shard (object stores; also external tools
            # that pretty-print — any shape, as long as it has "entries")
            doc = json.loads(raw)
            if isinstance(doc, dict) and isinstance(doc.get("entries"), dict):
                for key, ent in doc["entries"].items():
                    _merge_entry(entries, key, ent)
                continue
        except (ValueError, UnicodeDecodeError):
            pass
        bad_lines = 0
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
                if not isinstance(doc, dict):
                    raise ValueError("not an object")
            except (ValueError, UnicodeDecodeError):
                bad_lines += 1
                continue
            _merge_entry(entries, doc.get("k"), doc)
        if bad_lines:
            logger.warning(
                "manifest shard %s: skipped %d undecodable line(s) (their "
                "chunks will verify as untrustworthy and recompute)",
                name, bad_lines,
            )
    return entries, had_shards


def quarantine_chunk(io, chunk_key: str, store: str = "") -> Optional[str]:
    """Rename a bad chunk file out of the chunk namespace
    (``<key>.quarantine.<ts>``), count it, and return the new name (None if
    the rename failed — e.g. a concurrent quarantine already moved it)."""
    qname = f"{chunk_key}.quarantine.{int(time.time() * 1000)}"
    try:
        io.rename(chunk_key, qname)
    except OSError:
        logger.warning(
            "could not quarantine corrupt chunk %s/%s", store, chunk_key
        )
        return None
    record_scoped_counter("chunks_quarantined")
    logger.warning("quarantined corrupt chunk %s/%s -> %s", store, chunk_key, qname)
    return qname
