"""The rechunk exchange on the fleet's peer data plane.

Counterpart of ``cubed_tpu/runtime/shuffle.py``. A rechunk task's item is a
slice-region of the write grid; which source chunks it reads and which
target chunks it writes are pure index computations, which live in
``runtime/pipeline.py`` (the dataflow scheduler's edges and chunk-granular
resume use them too) and are re-exported here. This module adds the
exchange itself:

- :func:`byte_ranges` turns the sub-region of a C-order chunk a task needs
  into coalesced ``(offset, nbytes)`` ranges, so a fleet worker fetches
  from a peer's chunk cache the bytes it reads, not whole chunks it barely
  touches (``runtime/transfer.fetch_chunk_ranges``; the store's read path
  calls it, ``storage/store.py``).
- :class:`exchange_scope` marks a rechunk task's read window
  (``primitive/rechunk.copy_read_to_write``), so peer fetches under it
  record ``shuffle_fetch`` spans (the analytics ``shuffle`` bucket) and
  count ``shuffle_bytes_peer``.

The fallback contract is the data plane's: Zarr stays the durable
write-through tier, and any peer miss, death, timeout or checksum mismatch
reads the store instead, so resume, the journal and the manifests are
untouched.
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import List, Optional, Tuple

from .pipeline import (  # noqa: F401  (the index half of the exchange)
    chunk_key_str,
    chunks_overlapping_region,
    is_rechunk_pipeline,
    is_region_item,
    rechunk_task_reads,
    rechunk_task_writes,
    region_chunk_keys,
    region_identity,
)

#: bound on byte ranges per sub-chunk fetch: past this, the per-range
#: bookkeeping costs more than the bytes it saves — fetch the whole chunk
MAX_FETCH_RANGES = 512

#: a region covering at least this fraction of the chunk fetches the whole
#: chunk instead (one range, and the cache entry verifies against the
#: manifest end to end)
RANGE_FETCH_MAX_FRACTION = 0.75


# ----------------------------------------------------------------------
# sub-chunk byte ranges (the wire format of a partial-chunk fetch)
# ----------------------------------------------------------------------


def byte_ranges(
    chunk_shape: Tuple[int, ...],
    itemsize: int,
    inner_sel: Tuple[slice, ...],
) -> Optional[List[Tuple[int, int]]]:
    """Coalesced ``(offset, nbytes)`` ranges of a C-order chunk covering
    ``inner_sel`` (unit-step slices within the chunk), enumerated in the
    region's own C order — so the concatenated payload IS the selected
    sub-array's C-order buffer. Returns None when a range read is not
    worth it (full coverage, strided selection, too many ranges, or the
    region is nearly the whole chunk — see :data:`MAX_FETCH_RANGES` /
    :data:`RANGE_FETCH_MAX_FRACTION`); the caller then fetches the whole
    chunk."""
    if not chunk_shape:
        return None
    sel = []
    region_elems = 1
    for s, extent in zip(inner_sel, chunk_shape):
        step = s.step or 1
        if step != 1:
            return None
        start = int(s.start or 0)
        stop = min(int(s.stop if s.stop is not None else extent), extent)
        if stop <= start:
            return None
        sel.append((start, stop))
        region_elems *= stop - start
    chunk_elems = math.prod(chunk_shape)
    if region_elems >= chunk_elems:
        return None  # full chunk: the whole-chunk path verifies end to end
    if region_elems * itemsize > RANGE_FETCH_MAX_FRACTION * chunk_elems * itemsize:
        return None

    # the largest suffix of axes fully covered: runs are contiguous across
    # it, anchored at the last partially-covered axis
    ndim = len(chunk_shape)
    full_from = ndim
    for ax in reversed(range(ndim)):
        if sel[ax] == (0, chunk_shape[ax]):
            full_from = ax
        else:
            break
    # strides in elements, C order
    strides = [1] * ndim
    for ax in reversed(range(ndim - 1)):
        strides[ax] = strides[ax + 1] * chunk_shape[ax + 1]
    run_axis = full_from - 1  # the contiguous-run axis (last partial one)
    if run_axis < 0:
        return None  # fully covered (caught above, but belt and braces)
    run_elems = (sel[run_axis][1] - sel[run_axis][0]) * strides[run_axis]
    lead_counts = [sel[ax][1] - sel[ax][0] for ax in range(run_axis)]
    n_ranges = math.prod(lead_counts) if lead_counts else 1
    if n_ranges > MAX_FETCH_RANGES:
        return None
    ranges: List[Tuple[int, int]] = []
    base = sum(sel[ax][0] * strides[ax] for ax in range(run_axis + 1))
    for combo in itertools.product(*(range(n) for n in lead_counts)):
        off = base
        for ax, i in enumerate(combo):
            off += i * strides[ax]
        ranges.append((off * itemsize, run_elems * itemsize))
    return ranges


# ----------------------------------------------------------------------
# the exchange scope (observability: shuffle time gets its own bucket)
# ----------------------------------------------------------------------

_tls = threading.local()


class exchange_scope:
    """Marks the current thread as inside a rechunk task's read window, so
    peer fetches issued under it record ``shuffle_fetch`` spans (the
    ``shuffle`` attribution bucket) and count ``shuffle_bytes_peer``
    instead of blending into generic peer-fetch time."""

    def __enter__(self):
        self._prev = getattr(_tls, "exchange", False)
        _tls.exchange = True
        return self

    def __exit__(self, *exc) -> None:
        _tls.exchange = self._prev


def in_exchange() -> bool:
    return bool(getattr(_tls, "exchange", False))


