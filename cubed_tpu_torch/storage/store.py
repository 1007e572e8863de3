"""A minimal, dependency-free Zarr-v2 chunked array store on a local directory.

Counterpart of ``cubed_tpu/storage/store.py``, trimmed to local directories.
The on-disk layout is the standard Zarr v2 one the JAX package writes: a
``.zarray`` JSON document and one raw (uncompressed, C-order) file per chunk,
named by ``.``-separated chunk indices. Each chunk write is atomic and
durable: temp file, fsync, rename, fsync of the directory. That is what makes
a re-run or duplicate task safe, and it is kept whole here. Checksum
sidecars, breakers, compressors and remote (fsspec) stores are not ported.
Every chunk read and write is counted as stored (uncompressed, as the JAX
package stores by default) and spanned (``storage_read`` /
``storage_write``) by ``observability/accounting.py``, against the task
scope that does it, else the process registry.
"""

from __future__ import annotations

import itertools
import json
import os
import time
import uuid
from typing import Any, Optional, Sequence
from urllib.parse import urlsplit

import numpy as np

from ..chunks import blockdims_from_blockshape
from ..observability.accounting import record_bytes_read, record_bytes_written, scope_span

#: a crashed writer's orphaned ``.tmp`` is only swept once it is this old
ORPHAN_TMP_MAX_AGE_S = 60.0


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
        with open(os.path.join(self.root, name), "rb") as f:
            return f.read()

    def write_bytes_atomic(self, name: str, data) -> None:
        path = os.path.join(self.root, name)
        tmp = path + f".{uuid.uuid4().hex[:8]}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            # fsync before rename: a host crash must not leave a renamed
            # but empty chunk
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic on POSIX
        _fsync_dir(os.path.dirname(path))

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
        return removed


def _encode_dtype(dtype: np.dtype) -> Any:
    if dtype.fields is not None:
        return [[name, dtype.fields[name][0].str] for name in dtype.names]
    return dtype.str


def _decode_dtype(d: Any) -> np.dtype:
    if isinstance(d, list):
        return np.dtype([(name, dt) for name, dt in d])
    return np.dtype(d)


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
        if meta.get("compressor") is not None:
            raise ValueError(
                f"{store}: compressed Zarr stores are not supported by "
                "cubed_tpu_torch yet"
            )
        self.shape: tuple[int, ...] = tuple(meta["shape"])
        self.chunks: tuple[int, ...] = tuple(meta["chunks"])
        self.dtype: np.dtype = _decode_dtype(meta["dtype"])
        self.fill_value = _decode_fill(meta.get("fill_value"))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def chunkset(self) -> tuple[tuple[int, ...], ...]:
        return blockdims_from_blockshape(self.shape, self.chunks)

    # -- chunk IO ----------------------------------------------------------

    @staticmethod
    def _chunk_key(idx: tuple[int, ...]) -> str:
        return ".".join(str(int(i)) for i in idx) if idx else "0"

    def _read_chunk(self, idx: tuple[int, ...]) -> Optional[np.ndarray]:
        """The full (padded) chunk at block index *idx*, or None if absent."""
        key = self._chunk_key(idx)
        if not self._io.exists(key):
            return None
        with scope_span("storage_read", cat="storage", key=key) as sp:
            data = self._io.read_bytes(key)
            sp.attrs["bytes"] = len(data)
        record_bytes_read(self.store, len(data))
        arr = np.frombuffer(data, dtype=self.dtype)
        return arr.reshape(self.chunks if self.shape else ())

    def _write_chunk(self, idx: tuple[int, ...], arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr, dtype=self.dtype)
        key = self._chunk_key(idx)
        with scope_span("storage_write", cat="storage", key=key, bytes=arr.nbytes):
            self._io.write_bytes_atomic(key, memoryview(arr).cast("B"))
        record_bytes_written(self.store, arr.nbytes)

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
) -> ZarrV2Array:
    """Open (``r``: must exist; ``a``: open or create) a Zarr v2 array."""
    io = _LocalIO(_local_root(store))
    if mode != "r":
        io.sweep_tmp()
    meta_exists = io.exists(".zarray")
    if mode == "r" or (mode == "a" and meta_exists):
        if not meta_exists:
            raise FileNotFoundError(f"No zarr array at {store}")
        return ZarrV2Array(store, json.loads(io.read_bytes(".zarray")))
    if shape is None or dtype is None:
        raise ValueError("shape and dtype required to create a new array")
    dtype = np.dtype(dtype)
    shape = tuple(int(s) for s in shape)
    if chunks is None:
        chunks = shape
    chunks = tuple(int(c) for c in chunks) if shape else ()
    chunks = tuple(min(c, s) if s > 0 else max(1, c) for c, s in zip(chunks, shape))
    meta = {
        "zarr_format": 2,
        "shape": list(shape),
        "chunks": [max(1, c) for c in chunks] if shape else [],
        "dtype": _encode_dtype(dtype),
        "compressor": None,
        "fill_value": _encode_fill(fill_value if fill_value is not None else 0, dtype),
        "order": "C",
        "filters": None,
        "dimension_separator": ".",
    }
    io.makedirs()
    io.write_bytes_atomic(".zarray", json.dumps(meta).encode())
    return ZarrV2Array(store, meta)
