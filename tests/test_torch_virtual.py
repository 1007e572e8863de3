"""The port's virtual arrays, held against the JAX package's: each case of
``tests/storage/test_virtual.py`` run on both packages' classes, comparing
the blocks they give (exact) and their metadata."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cubed_tpu.storage import virtual as ref_virtual  # noqa: E402
from cubed_tpu_torch.storage import virtual as port_virtual  # noqa: E402

MODULES = pytest.mark.parametrize("virtual", [ref_virtual, port_virtual], ids=["ref", "port"])


def _both(build):
    ref, port = build(ref_virtual), build(port_virtual)
    assert type(port) is type(ref)
    if isinstance(ref, np.ndarray):
        assert port.dtype == ref.dtype and port.shape == ref.shape
        np.testing.assert_array_equal(port, ref)
    else:
        assert port == ref
    return port


def test_virtual_full():
    out = _both(lambda v: np.asarray(v.VirtualFullArray((5, 7), np.float64, (2, 3), 3.5)[1:4, 2:6]))
    assert out.shape == (3, 4) and (out == 3.5).all()
    for v in (ref_virtual, port_virtual):
        # the broadcast trick: no real allocation
        assert v.VirtualFullArray((5, 7), np.float64, (2, 3), 3.5)[1:4, 2:6].strides == (0, 0)


def test_virtual_empty():
    assert _both(lambda v: v.VirtualEmptyArray((5, 7), np.float64, (2, 3))[0:2, 0:3].shape) == (2, 3)
    assert _both(lambda v: v.VirtualEmptyArray((5, 7), np.float64, (2, 3)).nbytes) == 5 * 7 * 8


@pytest.mark.parametrize("key, want", [((slice(0, 1), slice(0, 1)), 0), ((slice(0, 1), slice(2, 3)), 2),
                                       ((slice(1, 2), slice(0, 1)), 3)])
def test_virtual_offsets(key, want):
    assert _both(lambda v: int(v.VirtualOffsetsArray((2, 3))[key].ravel()[0])) == want


@MODULES
def test_virtual_offsets_refuse_more_than_one_block(virtual):
    with pytest.raises(IndexError):
        virtual.VirtualOffsetsArray((2, 3))[0:2, 0:1]


def test_virtual_offsets_base():
    assert _both(lambda v: int(v.VirtualOffsetsArray((2, 2), base=100)[1:2, 1:2].ravel()[0])) == 103


def test_virtual_in_memory():
    an = np.arange(12).reshape(3, 4)
    np.testing.assert_array_equal(_both(lambda v: np.asarray(v.VirtualInMemoryArray(an, (2, 2))[1:3, 0:2])),
                                  an[1:3, 0:2])


@MODULES
def test_virtual_in_memory_size_limit(virtual):
    with pytest.raises(ValueError, match="exceeds maximum"):
        virtual.VirtualInMemoryArray(np.zeros(2_000_000, dtype=np.uint8), (1000,))
    assert port_virtual.MAX_IN_MEMORY_BYTES == ref_virtual.MAX_IN_MEMORY_BYTES


def test_virtual_full_dtypes_and_fill_values():
    for dtype, fill in ((np.int64, 7), (np.bool_, True), (np.float32, np.nan), (np.complex128, 1 + 2j)):
        _both(lambda v: np.asarray(v.VirtualFullArray((4, 4), dtype, (2, 2), fill)[0:2, 2:4]))
