"""Device constants (``cubed_tpu_torch/device_constants.py``): host arrays
uploaded once, keyed by contents or identity, and kept alive by the graph
captured while they were read. On the CPU (a capture needs the card:
``tests/test_torch_cuda.py::test_a_captured_graph_keeps_the_device_constants_it_reads``).
Every comparison is exact."""

import numpy as np
import pytest
import torch

from cubed_tpu_torch import device_constants


@pytest.fixture(autouse=True)
def empty_cache():
    saved = dict(device_constants._CACHE)
    device_constants._CACHE.clear()
    yield
    device_constants._CACHE.clear()
    device_constants._CACHE.update(saved)


def test_a_constant_is_uploaded_once_by_its_contents():
    a = device_constants.constant(np.array([3, 1, 2], dtype=np.int32), "cpu")
    assert a.dtype == torch.int64
    np.testing.assert_array_equal(a.numpy(), [3, 1, 2])
    assert device_constants.constant(np.array([3, 1, 2]), "cpu") is a
    assert device_constants.constant(np.array([3, 1, 2, 0]), "cpu") is not a
    assert len(device_constants._CACHE) == 2


def test_a_constant_by_identity_keeps_its_host_array():
    positions = np.arange(5)
    a = device_constants.constant(positions, "cpu", by_id=True)
    assert device_constants.constant(positions, "cpu", by_id=True) is a
    assert device_constants.constant(positions.copy(), "cpu", by_id=True) is not a
    assert any(entry[0] is positions for entry in device_constants._CACHE.values())


def test_recorded_constants_outlive_their_eviction():
    with device_constants.recording() as pins:
        first = device_constants.constant(np.array([7, 8]), "cpu")
        device_constants.constant(np.array([7, 8]), "cpu")
    assert [id(t) for t in pins] == [id(first), id(first)]
    for n in range(device_constants.LIMIT):
        device_constants.constant(np.arange(n, n + 3), "cpu")
    assert len(device_constants._CACHE) == device_constants.LIMIT
    assert all(entry[1] is not first for entry in device_constants._CACHE.values())
    np.testing.assert_array_equal(pins[0].numpy(), [7, 8])
    assert device_constants.constant(np.array([9]), "cpu") is not None and len(pins) == 2
