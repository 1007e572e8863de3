"""The port's manipulation functions against the JAX package's, on the
CPU: the same seeded inputs through both, computed on the port's sequential
executor and on ``CudaExecutor`` (chunks on the CPU), the plans compared
task for task (``num_tasks``, op count, ``max_projected_mem``), and
``CudaExecutor``'s path counters against ``JaxExecutor``'s with every failed
check at 0.

Every manipulation moves values without arithmetic, so results are exact
(dtype and shape included).
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


def _an(shape, seed=0, dtype=np.float64):
    return (np.random.default_rng(seed).random(shape) * 100).astype(dtype)


def _plan(arr):
    plan = arr.plan._finalize(array_names=(arr.name,))
    return plan.num_tasks(), plan.num_ops(), plan.max_projected_mem()


def run_both(tmp_path, build, expected=None):
    """*build(pkg, xp, spec)* in both packages; the values (reference on its
    sequential executor and on JaxExecutor, port on its sequential executor
    and on CudaExecutor), plans and path counters compared."""
    rs = cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="100MB")
    ps = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="100MB")
    r, p = build(cubed_tpu, rxp, rs), build(cubed_tpu_torch, pxp, ps)
    assert _plan(p) == _plan(r)
    ref = np.asarray(r.compute())
    jax_executor_module._STRUCT_CACHE.clear()  # trace anew, so the path counters fire
    rex, pex = JaxExecutor(), CudaExecutor()
    np.testing.assert_array_equal(np.asarray(r.compute(executor=rex)), ref)
    for got in (p.compute(), p.compute(executor=pex)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    assert {c: pex.stats[c] for c in PATH_COUNTERS} == {c: rex.stats.get(c, 0) for c in PATH_COUNTERS}
    assert {c: pex.stats[c] for c in FAILED_CHECKS} == dict.fromkeys(FAILED_CHECKS, 0)
    if expected is not None:
        np.testing.assert_array_equal(ref, expected)
    return ref


def _a(pkg, spec, shape=(9, 8), chunks=(4, 3), seed=0, dtype=np.float64):
    return pkg.from_array(_an(shape, seed, dtype), chunks=chunks, spec=spec)


def _column_sums(chunks):
    # a dropped axis is contracted: the function gets the list of its blocks
    return sum(c.sum(axis=0) for c in chunks)


def _leading_axis(chunk):
    return chunk[None]


X = _an((9, 8))
CASES = {
    "map_blocks_drop_axis": (lambda p, x, s: p.map_blocks(_column_sums, _a(p, s, (9, 8), (3, 3)), drop_axis=0,
                                                          dtype=np.float64), None),
    "map_blocks_new_axis": (lambda p, x, s: p.map_blocks(_leading_axis, _a(p, s), new_axis=0, dtype=np.float64),
                            X[None]),
    "map_blocks_new_axis_chunks": (lambda p, x, s: p.map_blocks(_leading_axis, _a(p, s, (8, 6), (4, 3)), new_axis=0,
                                                                chunks=(1, 4, 3), dtype=np.float64),
                                   _an((8, 6))[None]),
    "broadcast_to": (lambda p, x, s: x.broadcast_to(_a(p, s)[0], (5, 8)), np.broadcast_to(X[0], (5, 8))),
    "broadcast_to_chunks": (lambda p, x, s: x.broadcast_to(_a(p, s)[:1], (6, 8), chunks=(2, 3)),
                            np.broadcast_to(X[:1], (6, 8))),
    "broadcast_arrays": (lambda p, x, s: x.broadcast_arrays(_a(p, s)[:, :1], _a(p, s, (1, 8), (1, 3), 1))[0],
                         np.broadcast_arrays(X[:, :1], _an((1, 8), 1))[0]),
    "concat_axis0": (lambda p, x, s: x.concat([_a(p, s), _a(p, s, seed=1)], axis=0),
                     np.concatenate([X, _an((9, 8), 1)], 0)),
    "concat_axis1": (lambda p, x, s: x.concat([_a(p, s), _a(p, s, (9, 5), (4, 2), 2)], axis=1),
                     np.concatenate([X, _an((9, 5), 2)], 1)),
    "concat_none": (lambda p, x, s: x.concat([_a(p, s), _a(p, s, seed=1)], axis=None),
                    np.concatenate([X.ravel(), _an((9, 8), 1).ravel()])),
    "concat_promotes": (lambda p, x, s: x.concat([_a(p, s, dtype=np.int16), _a(p, s, dtype=np.int64)], axis=0),
                        np.concatenate([_an((9, 8), dtype=np.int16), _an((9, 8), dtype=np.int64)])),
    "flatten": (lambda p, x, s: x.flatten(_a(p, s)), X.ravel()),
    "flip_axis0": (lambda p, x, s: x.flip(_a(p, s), axis=0), np.flip(X, 0)),
    "flip_all": (lambda p, x, s: x.flip(_a(p, s)), np.flip(X)),
    "moveaxis": (lambda p, x, s: x.moveaxis(_a(p, s, (3, 4, 5), 2), (0, 2), (2, 0)),
                 np.moveaxis(_an((3, 4, 5)), (0, 2), (2, 0))),
    "repeat": (lambda p, x, s: x.repeat(_a(p, s), 3, axis=1), np.repeat(X, 3, 1)),
    "repeat_axis0": (lambda p, x, s: x.repeat(_a(p, s), 2, axis=0), np.repeat(X, 2, 0)),
    "reshape_flat": (lambda p, x, s: x.reshape(_a(p, s), (72,)), X.reshape(72)),
    "reshape_split": (lambda p, x, s: x.reshape(_a(p, s, (12, 10), (4, 5)), (3, 4, 2, 5)),
                      _an((12, 10)).reshape(3, 4, 2, 5)),
    "reshape_minus1": (lambda p, x, s: x.reshape(_a(p, s), (-1, 4)), X.reshape(-1, 4)),
    "roll_axis0": (lambda p, x, s: x.roll(_a(p, s), 3, axis=0), np.roll(X, 3, 0)),
    "roll_two_axes": (lambda p, x, s: x.roll(_a(p, s), (-2, 5), axis=(0, 1)), np.roll(X, (-2, 5), (0, 1))),
    "roll_flat": (lambda p, x, s: x.roll(_a(p, s), 11), np.roll(X, 11)),
    "stack_axis0": (lambda p, x, s: x.stack([_a(p, s), _a(p, s, seed=1)]), np.stack([X, _an((9, 8), 1)])),
    "stack_axis2": (lambda p, x, s: x.stack([_a(p, s), _a(p, s, seed=1), _a(p, s, seed=2)], axis=2),
                    np.stack([X, _an((9, 8), 1), _an((9, 8), 2)], 2)),
    "unstack": (lambda p, x, s: x.unstack(_a(p, s), axis=1)[5], X[:, 5]),
    "tile": (lambda p, x, s: x.tile(_a(p, s), (2, 3)), np.tile(X, (2, 3))),
    "tile_new_axis": (lambda p, x, s: x.tile(_a(p, s), (2, 1, 1)), np.tile(X, (2, 1, 1))),
    "tile_zero": (lambda p, x, s: x.tile(_a(p, s), (0, 1)), np.tile(X, (0, 1))),
    "expand_squeeze": (lambda p, x, s: x.squeeze(x.expand_dims(_a(p, s), axis=1), axis=1), X),
    "int_dtype_flip": (lambda p, x, s: x.flip(_a(p, s, dtype=np.uint32), axis=1),
                       np.flip(_an((9, 8), dtype=np.uint32), 1)),
    "flip_of_random": (lambda p, x, s: x.flip(p.random.random((40, 30), chunks=10, spec=s), axis=0), None),
    "concat_of_zeros": (lambda p, x, s: x.concat([_a(p, s), x.zeros((3, 8), chunks=(4, 3), spec=s)]),
                        np.concatenate([X, np.zeros((3, 8))])),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_manipulation_matches_jax_package(tmp_path, name):
    import random

    build, expected = CASES[name]

    def seeded(pkg, xp, spec):
        random.seed(11)
        return build(pkg, xp, spec)

    run_both(tmp_path, seeded, expected)


@pytest.mark.parametrize("call", [
    lambda xp, a: xp.broadcast_to(a, (4, 8)),
    lambda xp, a: xp.stack([a, a[1:]]),
    lambda xp, a: xp.concat([]),
    lambda xp, a: xp.reshape(a, (7, 7)),
    lambda xp, a: xp.roll(a, (1, 2), axis=0),
    lambda xp, a: xp.tile(a, (-1, 1)),
    lambda xp, a: xp.repeat(a, [1, 2]),
    lambda xp, a: xp.squeeze(a, axis=0),
    lambda xp, a: xp.unstack(xp.sum(a)),
], ids=["broadcast_to", "stack", "concat", "reshape", "roll", "tile", "repeat", "squeeze", "unstack"])
def test_refusals_match(tmp_path, call):
    rs = cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="100MB")
    ps = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="100MB")
    with pytest.raises(Exception) as ref_err:
        call(rxp, _a(cubed_tpu, rs))
    with pytest.raises(type(ref_err.value)):
        call(pxp, _a(cubed_tpu_torch, ps))
