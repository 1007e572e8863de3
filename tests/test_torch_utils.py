"""The port's utils held against the JAX package's (counterpart of
tests/test_utils.py): byte strings, chunk memory and chunk math, paths, the
broadcast trick, stack summaries, and the host memory readings the memory
guard takes. ``split_into``, ``map_nested`` and ``flatten_nested`` have no
counterpart: nothing in the port uses them."""

from __future__ import annotations

import sys

import numpy as np
import pytest

import cubed_tpu.utils as ref
from cubed_tpu_torch.backend_array_api import set_device
from cubed_tpu_torch.utils import (
    block_id_to_offset,
    broadcast_trick,
    chunk_memory,
    convert_to_bytes,
    current_measured_mem,
    extract_stack_summaries,
    get_item,
    host_available_mem,
    itemsize,
    join_path,
    memory_repr,
    offset_to_block_id,
    peak_measured_mem,
    to_chunksize,
)


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    yield


@pytest.mark.parametrize(
    "value,expect",
    [(1000, 1000), ("500", 500), ("1KB", 1000), ("1kB", 1000), ("2MB", 2_000_000), ("1.5GB", 1_500_000_000),
     ("100B", 100), (1.0, 1), ("2GiB", 2 * 2**30)],
)
def test_convert_to_bytes(value, expect):
    assert convert_to_bytes(value) == expect == ref.convert_to_bytes(value)


def test_convert_to_bytes_none_and_invalid():
    assert convert_to_bytes(None) is None
    with pytest.raises((ValueError, TypeError)):
        convert_to_bytes("lots")


@pytest.mark.parametrize("n", [0, 1000, 2_000_000, 3 * 10**9, 123_456_789_012])
def test_memory_repr(n):
    assert memory_repr(n) == ref.memory_repr(n)


def test_chunk_and_array_memory():
    assert itemsize(np.dtype("float64")) == 8
    assert chunk_memory(np.dtype("float64"), (100, 100)) == 80_000 == ref.chunk_memory(np.dtype("float64"), (100, 100))
    dt = np.dtype([("n", np.int64), ("total", np.float64)])
    assert chunk_memory(dt, (10,)) == 160 == ref.chunk_memory(dt, (10,))


def test_to_chunksize():
    assert to_chunksize(((4, 4, 2), (3, 3))) == (4, 3) == ref.to_chunksize(((4, 4, 2), (3, 3)))
    with pytest.raises(ValueError):
        to_chunksize(((4, 2, 4),))


def test_get_item():
    chunks = ((4, 4, 2), (3, 3))
    for idx in ((0, 0), (2, 1), (1, 0)):
        assert get_item(chunks, idx) == ref.get_item(chunks, idx)
    assert get_item(chunks, (2, 1)) == (slice(8, 10), slice(3, 6))


def test_offset_block_id_roundtrip():
    numblocks = (3, 4, 2)
    for offset in range(3 * 4 * 2):
        bid = offset_to_block_id(offset, numblocks)
        assert bid == ref.offset_to_block_id(offset, numblocks)
        assert block_id_to_offset(bid, numblocks) == offset


def test_join_path():
    for base, child in (("/tmp/work", "a.zarr"), ("/tmp/work/", "a.zarr"), ("s3://bucket/dir", "a.zarr")):
        assert join_path(base, child) == ref.join_path(base, child)
    assert join_path("/tmp/work/", "a.zarr") == "/tmp/work/a.zarr"


def test_peak_measured_mem():
    assert peak_measured_mem() > 1_000_000


@pytest.mark.mem
def test_current_and_available_host_memory():
    """The memory guard's host readings: this process's RSS (at most its
    peak) and the host's available memory, read as the reference reads them."""
    rss = current_measured_mem()
    assert 1_000_000 < rss <= peak_measured_mem()
    assert abs(rss - ref.current_measured_mem()) < 64 * 2**20
    avail = host_available_mem()
    assert avail is not None and avail > 0
    assert abs(avail - ref.host_available_mem()) < 2**30


def test_broadcast_trick():
    full = broadcast_trick(np.full)
    a = full((1000, 1000), 3.0, dtype=np.float64)
    assert a.shape == (1000, 1000) and float(a[7, 11]) == 3.0
    assert a.strides == (0, 0)


def test_extract_stack_summaries_maps_variables(tmp_path):
    import cubed_tpu_torch as ct

    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    my_special_var = ct.from_array(np.zeros((4, 4)), chunks=(2, 2), spec=spec)
    summaries = extract_stack_summaries(sys._getframe())
    this = summaries[-1]
    assert this.name == "test_extract_stack_summaries_maps_variables"
    assert this.array_names_to_variable_names[my_special_var.name] == "my_special_var"
