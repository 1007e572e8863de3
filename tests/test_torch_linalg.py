"""The port's linear algebra (``matmul``, ``tensordot``, ``vecdot``,
``outer``, ``matrix_transpose``; ``@``, ``.T``, ``.mT``), ``max``/``min``
and ``expand_dims``/``permute_dims`` against the JAX package on the CPU:
the same seeded inputs, the same plans (tasks, ops and projected memory,
exactly), the same values (rtol 1e-12 where a sum's order may differ,
exact otherwise), and on ``CudaExecutor`` (chunks on the CPU) the path
counters of ``JaxExecutor``.

Counterparts of tests/test_array_api.py's ``test_matmul_1d``,
``test_matmul_batched``, ``test_tensordot_axes2``, ``test_outer_vecdot``
and ``test_matrix_transpose``, and of its max and min cases.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor  # noqa: E402

RTOL = 1e-12
PATH_COUNTERS = ("whole_array_hits", "batched_ops", "chunked_ops", "eager_ops", "rechunk_alias",
                 "rechunk_virtual")


def _an(shape, seed=0):
    return np.random.default_rng(seed).random(shape)


def _plan_stats(x):
    plan = x.plan._finalize(array_names=(x.name,))
    return plan.num_tasks(), plan.num_ops(), plan.max_projected_mem()


def _check(tmp_path, build, want=None, exact=False, seed=5):
    """Build in both packages from the same seeds; the plans must agree, and
    the port's value on both of its executors must equal the reference's
    (and *want*, numpy's, where given); the device executor's path counters
    must equal JaxExecutor's."""
    jax_executor_module._STRUCT_CACHE.clear()  # trace anew, so its path counters fire
    ref_ex, port_ex = JaxExecutor(), CudaExecutor()
    random.seed(seed)
    ref = build(cubed_tpu, rxp, cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB"))
    port_spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB")
    random.seed(seed)
    port = build(cubed_tpu_torch, pxp, port_spec)
    assert _plan_stats(port) == _plan_stats(ref)
    ref_value = np.asarray(ref.compute(executor=ref_ex))
    got = port.compute(executor=port_ex)
    random.seed(seed)
    seq = build(cubed_tpu_torch, pxp, port_spec).compute(executor=PythonDagExecutor())
    assert got.dtype == ref_value.dtype and got.shape == ref_value.shape
    for value in (got, seq) + ((want,) if want is not None else ()):
        if exact:
            np.testing.assert_array_equal(value, ref_value)
        else:
            np.testing.assert_allclose(value, ref_value, rtol=RTOL, atol=0)
    assert {c: port_ex.stats[c] for c in PATH_COUNTERS} == {c: ref_ex.stats[c] for c in PATH_COUNTERS}
    assert port_ex.stats["eager_fallbacks"] == 0
    return port_ex


def test_matmul_1d(tmp_path):
    an, bn = np.arange(6.0), np.arange(6.0) + 1

    def build(pkg, xp, spec):
        return xp.matmul(pkg.from_array(an, chunks=3, spec=spec), pkg.from_array(bn, chunks=3, spec=spec))

    _check(tmp_path, build, an @ bn)


def test_matmul_batched(tmp_path):
    rng = np.random.default_rng(0)
    an, bn = rng.random((2, 4, 6)), rng.random((2, 6, 5))

    def build(pkg, xp, spec):
        return xp.matmul(pkg.from_array(an, chunks=(1, 2, 3), spec=spec),
                         pkg.from_array(bn, chunks=(1, 3, 5), spec=spec))

    _check(tmp_path, build, an @ bn)


def test_matmul_operator_and_chunks_unified(tmp_path):
    """``@`` of operands chunked differently along k: unify_chunks rechunks
    one of them (the reference's choice: the smaller chunk)."""
    an, bn = _an((12, 10)), _an((10, 8), 1)

    def build(pkg, xp, spec):
        return pkg.from_array(an, chunks=(4, 5), spec=spec) @ pkg.from_array(bn, chunks=(2, 4), spec=spec)

    _check(tmp_path, build, an @ bn)


def test_sum_of_matmul(tmp_path):
    """BASELINE config 4's plan, cut to size: ``sum(matmul(a, b))`` of random
    arrays (a batched per-block product, the k-sum, then the total)."""
    def build(pkg, xp, spec):
        a = pkg.random.random((40, 40), chunks=10, spec=spec)
        b = pkg.random.random((40, 40), chunks=10, spec=spec)
        return xp.sum(xp.matmul(a, b))

    ex = _check(tmp_path, build)
    assert ex.stats["batched_ops"] >= 1


def test_tensordot_axes2(tmp_path):
    rng = np.random.default_rng(0)
    an, bn = rng.random((4, 5, 6)), rng.random((5, 6, 3))

    def build(pkg, xp, spec):
        return xp.tensordot(pkg.from_array(an, chunks=(2, 5, 3), spec=spec),
                            pkg.from_array(bn, chunks=(5, 3, 3), spec=spec), axes=2)

    _check(tmp_path, build, np.tensordot(an, bn, axes=2))


def test_tensordot_explicit_axes(tmp_path):
    an, bn = _an((6, 4, 5)), _an((5, 3, 6), 1)

    def build(pkg, xp, spec):
        return xp.tensordot(pkg.from_array(an, chunks=(3, 2, 5), spec=spec),
                            pkg.from_array(bn, chunks=(5, 3, 3), spec=spec), axes=((0, 2), (2, 0)))

    _check(tmp_path, build, np.tensordot(an, bn, axes=((0, 2), (2, 0))))


def test_outer_vecdot(tmp_path):
    an, bn = np.arange(4.0), np.arange(5.0)

    def outer(pkg, xp, spec):
        return xp.outer(pkg.from_array(an, chunks=2, spec=spec), pkg.from_array(bn, chunks=2, spec=spec))

    def vecdot(pkg, xp, spec):
        return xp.vecdot(pkg.from_array(bn, chunks=2, spec=spec), pkg.from_array(bn, chunks=2, spec=spec))

    _check(tmp_path / "outer", outer, np.outer(an, bn), exact=True)
    _check(tmp_path / "vecdot", vecdot, np.dot(bn, bn))


def test_vecdot_along_an_axis(tmp_path):
    an, bn = _an((6, 8)), _an((6, 8), 1)

    def build(pkg, xp, spec):
        return xp.vecdot(pkg.from_array(an, chunks=(3, 4), spec=spec),
                         pkg.from_array(bn, chunks=(3, 4), spec=spec), axis=0)

    _check(tmp_path, build, np.sum(an * bn, axis=0))


def test_matrix_transpose(tmp_path):
    an = _an((6, 9))

    for name, fn in (("T", lambda xp, a: a.T), ("mT", lambda xp, a: a.mT),
                     ("matrix_transpose", lambda xp, a: xp.matrix_transpose(a))):
        _check(tmp_path / name, lambda pkg, xp, spec: fn(xp, pkg.from_array(an, chunks=(2, 4), spec=spec)),
               an.T, exact=True)


def test_permute_and_expand_dims(tmp_path):
    an = _an((4, 6, 5))

    def permute(pkg, xp, spec):
        return xp.permute_dims(pkg.from_array(an, chunks=(2, 3, 5), spec=spec), (2, 0, 1))

    def expand(pkg, xp, spec):
        return xp.expand_dims(pkg.from_array(an, chunks=(2, 3, 5), spec=spec), axis=1)

    _check(tmp_path / "permute", permute, np.transpose(an, (2, 0, 1)), exact=True)
    _check(tmp_path / "expand", expand, np.expand_dims(an, 1), exact=True)


MAX_MIN_CASES = [(None, False), (0, False), (1, True), ((0, 1), True)]


@pytest.mark.parametrize("name", ["max", "min"])
@pytest.mark.parametrize("axis, keepdims", MAX_MIN_CASES, ids=[f"{a}-{k}" for a, k in MAX_MIN_CASES])
def test_max_min(tmp_path, name, axis, keepdims):
    an = _an((13, 11)) - 0.5

    def build(pkg, xp, spec):
        return getattr(xp, name)(pkg.from_array(an, chunks=(4, 3), spec=spec), axis=axis, keepdims=keepdims)

    _check(tmp_path, build, getattr(np, name)(an, axis=axis, keepdims=keepdims), exact=True)


def test_max_min_of_integers(tmp_path):
    an = (np.random.default_rng(3).random((9, 10)) * 1000).astype(np.int64) - 500

    for name in ("max", "min"):
        _check(tmp_path / name, lambda pkg, xp, spec: getattr(xp, name)(pkg.from_array(an, chunks=4, spec=spec)),
               getattr(np, name)(an), exact=True)


def test_max_of_mean(tmp_path):
    """BASELINE config 3's plan, cut to size: ``max(mean(a, axis=0))``."""
    def build(pkg, xp, spec):
        return xp.max(xp.mean(pkg.random.random((40, 40), chunks=10, spec=spec), axis=0))

    _check(tmp_path, build)


def test_elemwise_config(tmp_path):
    """BASELINE config 2's plan, cut to size:
    ``sum(sqrt(abs(sin(a)*b + cos(b))))``."""
    def build(pkg, xp, spec):
        a = pkg.random.random((60, 60), chunks=10, spec=spec)
        b = pkg.random.random((60, 60), chunks=10, spec=spec)
        return xp.sum(xp.sqrt(xp.abs(xp.sin(a) * b + xp.cos(b))))

    _check(tmp_path, build)


def test_uint64_order_is_refused_when_the_plan_is_built(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(np.arange(6, dtype=np.uint64), chunks=3, spec=spec)
    for fn in (pxp.max, pxp.min, lambda x: pxp.astype(x, pxp.float64), lambda x: pxp.less(x, x)):
        with pytest.raises(TypeError, match="uint64"):
            fn(a)
