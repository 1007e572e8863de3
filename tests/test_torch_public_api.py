"""Pin the port's public names to a superset of the JAX package's, less the
names still to be ported, each listed here (ROADMAP.md, Queue 1).

The counterpart of ``tests/test_public_api.py``: the reference's names are
read from the JAX package itself, so a name it gains fails here until the
port carries it or this file lists it as pending.
"""

import os

os.environ.setdefault("CUBED_TPU_TORCH_DEVICE", "cpu")

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as ref_xp  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as xp  # noqa: E402

#: top-level names of the reference not ported yet
PENDING_TOP_LEVEL = set()

#: array_api names of the reference not ported yet
PENDING_ARRAY_API = set()

#: the linalg extension's functions of the reference (the Array API
#: standard's linalg names it defines)
REFERENCE_LINALG = {
    "cholesky", "cross", "det", "diagonal", "eigh", "eigvalsh", "inv", "matmul", "matrix_norm",
    "matrix_power", "matrix_rank", "matrix_transpose", "outer", "pinv", "qr", "slogdet", "solve", "svd",
    "svdvals", "tensordot", "trace", "vecdot", "vector_norm",
}

#: linalg names of the reference not ported yet
PENDING_LINALG = set()


def _public(module) -> set:
    return {n for n in dir(module) if not n.startswith("_")}


def test_top_level_superset_of_reference_less_pending():
    missing = set(cubed_tpu.__all__) - set(cubed_tpu_torch.__all__) - {"__version__"}
    assert missing == PENDING_TOP_LEVEL, sorted(missing ^ PENDING_TOP_LEVEL)
    assert cubed_tpu_torch.__version__ == cubed_tpu.__version__


@pytest.mark.parametrize("name", ["Callback", "TaskEndEvent", "observability"])
def test_observer_names_exported_as_the_reference_does(name):
    assert name in cubed_tpu_torch.__all__
    assert getattr(cubed_tpu_torch, name) is not None
    assert name in cubed_tpu.__all__


def test_callback_and_task_end_event_are_the_lifecycles_own():
    from cubed_tpu_torch.observability import TraceCollector
    from cubed_tpu_torch.runtime.types import Callback, TaskEndEvent

    assert cubed_tpu_torch.Callback is Callback
    assert cubed_tpu_torch.TaskEndEvent is TaskEndEvent
    assert issubclass(TraceCollector, cubed_tpu_torch.Callback)
    assert cubed_tpu_torch.observability.TraceCollector is TraceCollector
    assert {f for f in TaskEndEvent.__dataclass_fields__} == set(cubed_tpu.TaskEndEvent.__dataclass_fields__)
    assert {m for m in dir(Callback) if m.startswith("on_")} == {
        m for m in dir(cubed_tpu.Callback) if m.startswith("on_")}


def test_all_names_resolve():
    for name in cubed_tpu_torch.__all__:
        assert getattr(cubed_tpu_torch, name) is not None, name


@pytest.mark.parametrize("name", ["to_zarr", "store", "map_overlap", "visualize", "measure_reserved_mem"])
def test_zarr_stencil_and_introspection_names_exported(name):
    assert name in cubed_tpu_torch.__all__
    assert callable(getattr(cubed_tpu_torch, name))


def test_pad_exported_from_array_api():
    assert callable(xp.pad)


def test_pending_names_are_really_missing():
    """A name ported later leaves the pending lists with it."""
    assert not PENDING_TOP_LEVEL & set(cubed_tpu_torch.__all__)
    assert not {n for n in PENDING_ARRAY_API if hasattr(xp, n)}
    assert not {n for n in PENDING_LINALG if hasattr(xp.linalg, n)}


def test_array_api_superset_of_reference_less_pending():
    missing = _public(ref_xp) - _public(xp)
    assert missing == PENDING_ARRAY_API, sorted(missing ^ PENDING_ARRAY_API)


def test_array_api_names_resolve():
    for name in _public(ref_xp) - PENDING_ARRAY_API:
        assert hasattr(xp, name), name


def test_linalg_superset_of_reference_less_pending():
    assert REFERENCE_LINALG <= _public(ref_xp.linalg)
    assert REFERENCE_LINALG - PENDING_LINALG <= _public(xp.linalg)


def test_linalg_all_equals_the_references():
    assert xp.linalg.__all__ == ref_xp.linalg.__all__


@pytest.mark.parametrize("name", ["QRResult", "SVDResult", "EighResult", "SlogdetResult"])
def test_linalg_result_tuples_have_the_references_fields(name):
    assert getattr(xp.linalg, name)._fields == getattr(ref_xp.linalg, name)._fields


def test_fft_and_einsum_names_equal_the_references():
    assert xp.fft.__all__ == ref_xp.fft.__all__
    assert callable(xp.einsum) and xp.einsum_functions.__all__ == ref_xp.einsum_functions.__all__
