"""The port's indexing against the JAX package's, on the CPU: ``None``,
negative steps, integer-array indices (a lazy one computed first), ``take``
and ``take_along_axis``, with the plans compared task for task
(``num_tasks``, op count, ``max_projected_mem``) and ``CudaExecutor``'s path
counters against ``JaxExecutor``'s (every failed check at 0). The boolean
index is refused in both.

An index moves values without arithmetic, so results are exact (dtype and
shape included).
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402

PATH_COUNTERS = ("whole_array_hits", "whole_concat_hits", "batched_ops", "chunked_ops", "eager_ops",
                 "rechunk_alias", "rechunk_virtual")
FAILED_CHECKS = ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors")

X = np.random.default_rng(0).random((11, 9, 4))


def _specs(tmp_path):
    return (cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="100MB"),
            cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="100MB"))


def _plan(arr):
    plan = arr.plan._finalize(array_names=(arr.name,))
    return plan.num_tasks(), plan.num_ops(), plan.max_projected_mem()


def _run_both(r, p, expected):
    assert _plan(p) == _plan(r)
    ref = np.asarray(r.compute())
    jax_executor_module._STRUCT_CACHE.clear()
    rex, pex = JaxExecutor(), CudaExecutor()
    np.testing.assert_array_equal(np.asarray(r.compute(executor=rex)), ref)
    for got in (p.compute(), p.compute(executor=pex)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ref, expected)
    assert {c: pex.stats[c] for c in PATH_COUNTERS} == {c: rex.stats.get(c, 0) for c in PATH_COUNTERS}
    assert {c: pex.stats[c] for c in FAILED_CHECKS} == dict.fromkeys(FAILED_CHECKS, 0)
    return pex


KEYS = {
    "reverse": np.s_[::-1],
    "reverse_step": np.s_[::-3, 1:],
    "negative_start_stop": np.s_[-2:1:-2, ::-1, 2],
    "negative_empty": np.s_[2:5:-1],
    "newaxis": np.s_[None, 1:, None],
    "newaxis_ellipsis": np.s_[..., None, 0],
    "int_array": np.s_[[0, 10, 3, 3]],
    "int_array_negative": np.s_[:, [-1, 0, -4]],
    "int_array_with_int": np.s_[2, [1, 1, 5], ::2],
    "int_array_numpy": np.s_[np.array([7, 2]), None],
    "ints": np.s_[-1, 3],
    "ellipsis_step": np.s_[..., ::2],
}


@pytest.mark.parametrize("name", sorted(KEYS))
@pytest.mark.parametrize("scaled", [False, True], ids=["alone", "scaled"])
def test_index_matches_jax_package(tmp_path, name, scaled):
    """Alone the index is its own op (a whole-array select on the device
    executor); scaled, its output feeds an elementwise op."""
    key = KEYS[name]
    rs, ps = _specs(tmp_path)
    r = cubed_tpu.from_array(X, chunks=(4, 3, 2), spec=rs)[key]
    p = cubed_tpu_torch.from_array(X, chunks=(4, 3, 2), spec=ps)[key]
    expected = X[key] if not isinstance(key, tuple) or sum(
        isinstance(k, (list, np.ndarray)) for k in key) <= 1 else None
    if scaled:
        r, p, expected = r * 2.0, p * 2.0, expected * 2.0
    _run_both(r, p, expected)


def test_index_of_a_resident_random_array_stays_on_the_device(tmp_path):
    """A negative step and an integer array of a resident array are taken on
    the device (whole-array selects), as the reference takes them."""
    import random

    rs, ps = _specs(tmp_path)
    out = []
    for pkg, spec in ((cubed_tpu, rs), (cubed_tpu_torch, ps)):
        random.seed(5)
        a = pkg.random.random((40, 30), chunks=10, spec=spec)
        out.append(a[::-2, [29, 3, 3, 0]] * 2.0)
    pex = _run_both(*out, np.asarray(out[0].compute()))
    assert pex.stats["chunked_ops"] == 0


def test_lazy_integer_array_index_is_computed_first(tmp_path):
    rs, ps = _specs(tmp_path)
    idx = np.array([4, 0, 8])
    r = cubed_tpu.from_array(X, chunks=4, spec=rs)[:, cubed_tpu.from_array(idx, chunks=2, spec=rs)]
    p = cubed_tpu_torch.from_array(X, chunks=4, spec=ps)[:, cubed_tpu_torch.from_array(idx, chunks=2, spec=ps)]
    _run_both(r, p, X[:, idx])


@pytest.mark.parametrize("key", [np.s_[np.arange(11) < 4], np.s_[[1, 2], [1, 2]], np.s_[0, 0, 0, 0],
                                 np.s_[..., ...], np.s_[11]],
                         ids=["boolean", "two_arrays", "too_many", "two_ellipses", "out_of_bounds"])
def test_refused_indices_match(tmp_path, key):
    rs, ps = _specs(tmp_path)
    with pytest.raises(Exception) as ref_err:
        cubed_tpu.from_array(X, chunks=4, spec=rs)[key]
    with pytest.raises(type(ref_err.value)):
        cubed_tpu_torch.from_array(X, chunks=4, spec=ps)[key]


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_take(tmp_path, axis):
    rs, ps = _specs(tmp_path)
    idx = np.array([1, 0, 3, 1])
    r = rxp.take(cubed_tpu.from_array(X, chunks=3, spec=rs), rxp.asarray(idx, spec=rs), axis=axis)
    p = pxp.take(cubed_tpu_torch.from_array(X, chunks=3, spec=ps), pxp.asarray(idx, spec=ps), axis=axis)
    _run_both(r, p, np.take(X, idx, axis=axis))


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("idx_dtype", [np.int64, np.int8, np.uint8])
def test_take_along_axis(tmp_path, axis, idx_dtype):
    rs, ps = _specs(tmp_path)
    rng = np.random.default_rng(axis)
    n = X.shape[axis]
    shape = tuple(5 if d == axis else s for d, s in enumerate(X.shape))
    idx = rng.integers(0, n, shape).astype(idx_dtype)
    if np.dtype(idx_dtype).kind == "i":
        idx[0] = -1  # counts from the end
    r = rxp.take_along_axis(cubed_tpu.from_array(X, chunks=(4, 3, 2), spec=rs),
                            cubed_tpu.from_array(idx, chunks=(3, 2, 3), spec=rs), axis=axis)
    p = pxp.take_along_axis(cubed_tpu_torch.from_array(X, chunks=(4, 3, 2), spec=ps),
                            cubed_tpu_torch.from_array(idx, chunks=(3, 2, 3), spec=ps), axis=axis)
    _run_both(r, p, np.take_along_axis(X, np.where(idx < 0, idx + n, idx).astype(np.int64), axis=axis))


def test_take_along_axis_broadcasts_and_refuses(tmp_path):
    rs, ps = _specs(tmp_path)
    idx = np.array([[2], [0], [8]])  # (3, 1) against (11, 9): broadcast off the axis
    x2 = X[:3, :, 0]
    r = rxp.take_along_axis(cubed_tpu.from_array(x2, chunks=2, spec=rs), cubed_tpu.from_array(idx, spec=rs), axis=1)
    p = pxp.take_along_axis(cubed_tpu_torch.from_array(x2, chunks=2, spec=ps),
                            cubed_tpu_torch.from_array(idx, spec=ps), axis=1)
    _run_both(r, p, np.take_along_axis(x2, idx, axis=1))
    for bad_idx, err in [(np.zeros((3,), dtype=np.int64), ValueError), (np.zeros((3, 1)), TypeError)]:
        with pytest.raises(err):
            rxp.take_along_axis(cubed_tpu.from_array(x2, spec=rs), cubed_tpu.from_array(bad_idx, spec=rs))
        with pytest.raises(err):
            pxp.take_along_axis(cubed_tpu_torch.from_array(x2, spec=ps), cubed_tpu_torch.from_array(bad_idx, spec=ps))
