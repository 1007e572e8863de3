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


# ---------------------------------------------------------------------------
# The rest of the linalg namespace: TSQR, the per-matrix solvers, the
# blocked Cholesky, the norms and compositions. Counterparts of
# tests/test_linalg.py. Tolerances: a factorization's entries atol 1e-10
# (float64; factors compared after their signs are made canonical, as they
# are defined only up to sign), solutions, determinants, eigenvalues and
# singular values atol 1e-10 too; complex64 results rtol 1e-5.
# ---------------------------------------------------------------------------

from ._torch_parity import FAILED_CHECKS, PATH_COUNTERS as PARITY_COUNTERS, plan_of, specs  # noqa: E402

ATOL = 1e-10


def _sign(v):
    s = np.sign(v)
    return np.where(s == 0, 1, s)


def _cols(q):
    """Each column's sign made that of its largest entry positive."""
    idx = np.argmax(np.abs(q), axis=-2)[..., None, :]
    return q * _sign(np.take_along_axis(q, idx, axis=-2).real)


def _rows(r):
    """Each row's sign made that of its largest entry positive."""
    return np.swapaxes(_cols(np.swapaxes(r, -1, -2)), -1, -2)


def _rows_by_diag(r):
    """R's rows scaled so that its diagonal is non-negative."""
    d = np.diagonal(r, axis1=-2, axis2=-1)
    k = d.shape[-1]
    return np.concatenate([r[..., :k, :] * _sign(d.real)[..., :, None], r[..., k:, :]], axis=-2)


def _factor(tmp_path, build, *data, chunks, canon=None, atol=ATOL, rtol=0, allowed_mem="500MB"):
    """One array of a linalg result built in both packages: the same plan;
    the port's value on its sequential executor and on ``CudaExecutor``
    equal to ``JaxExecutor``'s after *canon* (within *atol*, *rtol*); the
    path counters equal, every failed check 0. Returns the port's value."""
    rs, ps = specs(tmp_path, allowed_mem)
    chunks = chunks if isinstance(chunks, list) else [chunks] * len(data)
    r = build(rxp, *[cubed_tpu.from_array(d, chunks=c, spec=rs) for d, c in zip(data, chunks)])
    p = build(pxp, *[cubed_tpu_torch.from_array(d, chunks=c, spec=ps) for d, c in zip(data, chunks)])
    assert plan_of(p) == plan_of(r)
    canon = canon or (lambda v: v)
    jax_executor_module._STRUCT_CACHE.clear()
    # its segment cache too: keyed by the lowered HLO's text, where a large
    # constant is elided, it could replay another test's program of this shape
    jax_executor_module._SEGMENT_CACHE.clear()
    rex, pex = JaxExecutor(), CudaExecutor()
    ref = np.asarray(r.compute(executor=rex))
    got = np.asarray(p.compute())
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype, got.shape, ref.shape)
    for value in (got, np.asarray(p.compute(executor=pex))):
        np.testing.assert_allclose(canon(value), canon(ref), atol=atol, rtol=rtol, equal_nan=True)
        assert np.array_equal(np.isfinite(value), np.isfinite(ref))
    assert {c: pex.stats[c] for c in PARITY_COUNTERS} == {c: rex.stats.get(c, 0) for c in PARITY_COUNTERS}
    assert {c: pex.stats[c] for c in FAILED_CHECKS} == dict.fromkeys(FAILED_CHECKS, 0)
    return got


def _spd(rng, *batch_n):
    *batch, n = batch_n
    m = rng.standard_normal((*batch, n, n))
    return m @ np.swapaxes(m, -1, -2) + n * np.eye(n)


def _q(xp, a):
    return xp.linalg.qr(a).Q


def _r(xp, a):
    return xp.linalg.qr(a).R


QR_TALL = [
    ((40, 6), (10, 6)),  # even row blocks: stage 1 batched
    ((37, 5), (10, 5)),  # a ragged last block
    ((24, 6), (24, 6)),  # one block (b == 1)
    ((30, 8), (10, 4)),  # chunked columns gathered
    ((9, 4), (2, 4)),  # row blocks smaller than n: rechunked
]


@pytest.mark.parametrize("shape, chunks", QR_TALL, ids=[f"{s}-{c}" for s, c in QR_TALL])
def test_qr_tall(tmp_path, shape, chunks):
    an = np.random.default_rng(0).standard_normal(shape)
    qn = _factor(tmp_path / "q", _q, an, chunks=chunks, canon=_cols)
    rn = _factor(tmp_path / "r", _r, an, chunks=chunks, canon=_rows_by_diag)
    n = shape[1]
    assert qn.shape == shape and rn.shape == (n, n)
    np.testing.assert_allclose(qn @ rn, an, atol=ATOL)
    np.testing.assert_allclose(qn.T @ qn, np.eye(n), atol=ATOL)
    np.testing.assert_array_equal(np.triu(rn), rn)
    np.testing.assert_allclose(_rows_by_diag(rn), _rows_by_diag(np.linalg.qr(an)[1]), atol=ATOL)


def test_qr_wide(tmp_path):
    an = np.random.default_rng(1).standard_normal((4, 9))
    qn = _factor(tmp_path / "q", _q, an, chunks=(2, 3), canon=_cols)
    rn = _factor(tmp_path / "r", _r, an, chunks=(2, 3), canon=_rows_by_diag)
    assert qn.shape == (4, 4) and rn.shape == (4, 9)
    np.testing.assert_allclose(qn @ rn, an, atol=ATOL)


def test_qr_batched(tmp_path):
    an = np.random.default_rng(2).standard_normal((3, 10, 4))
    qn = _factor(tmp_path / "q", _q, an, chunks=(1, 5, 4), canon=_cols)
    rn = _factor(tmp_path / "r", _r, an, chunks=(1, 5, 4), canon=_rows_by_diag)
    np.testing.assert_allclose(qn @ rn, an, atol=ATOL)


def test_qr_of_many_row_blocks(tmp_path):
    an = np.random.default_rng(3).standard_normal((4000, 16))
    qn = _factor(tmp_path, _q, an, chunks=(250, 16), canon=_cols, atol=1e-9)
    np.testing.assert_allclose(qn.T @ qn, np.eye(16), atol=1e-9)


def test_tsqr_panel_op_has_per_output_chunks(tmp_path):
    """Stage 1 writes Q blocks (c, n) and R blocks (n, n) on one (b, 1)
    grid, in one op, priced as the reference prices it."""
    rs, ps = specs(tmp_path)
    an = np.random.default_rng(4).standard_normal((40, 6))
    for xp, pkg, spec in ((rxp, cubed_tpu, rs), (pxp, cubed_tpu_torch, ps)):
        q, r = xp.linalg.qr(pkg.from_array(an, chunks=(10, 6), spec=spec))
        nodes = q.plan.dag.nodes(data=True) if pkg is cubed_tpu else q.plan.dag.nodes.items()
        ops = [d for _, d in nodes if d.get("op_name") == "tsqr_panel"]
        assert len(ops) == 1
        writes = ops[0]["primitive_op"].target_arrays
        assert [tuple(t.chunks) for t in writes] == [(10, 6), (6, 6)]
    assert plan_of(pxp.linalg.qr(cubed_tpu_torch.from_array(an, chunks=(10, 6), spec=ps)).Q) == plan_of(
        rxp.linalg.qr(cubed_tpu.from_array(an, chunks=(10, 6), spec=rs)).Q)


SVD_CASES = [((40, 6), (10, 6)), ((5, 12), (5, 4))]


@pytest.mark.parametrize("shape, chunks", SVD_CASES, ids=["tall", "wide"])
def test_svd_tall_and_wide(tmp_path, shape, chunks):
    an = np.random.default_rng(4).standard_normal(shape)
    un = _factor(tmp_path / "u", lambda xp, a: xp.linalg.svd(a, full_matrices=False).U, an, chunks=chunks,
                 canon=_cols)
    sn = _factor(tmp_path / "s", lambda xp, a: xp.linalg.svd(a, full_matrices=False).S, an, chunks=chunks)
    vhn = _factor(tmp_path / "vh", lambda xp, a: xp.linalg.svd(a, full_matrices=False).Vh, an, chunks=chunks,
                  canon=_rows)
    k = min(shape)
    assert un.shape == (shape[0], k) and sn.shape == (k,) and vhn.shape == (k, shape[1])
    np.testing.assert_allclose((un * sn) @ vhn, an, atol=ATOL)
    np.testing.assert_allclose(sn, np.linalg.svd(an, compute_uv=False), atol=ATOL)


def test_svd_full_matrices_not_implemented(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    with pytest.raises(NotImplementedError):
        pxp.linalg.svd(cubed_tpu_torch.from_array(np.ones((4, 3)), chunks=(4, 3), spec=spec))


def test_svdvals(tmp_path):
    an = np.random.default_rng(5).standard_normal((30, 5))
    got = _factor(tmp_path, lambda xp, a: xp.linalg.svdvals(a), an, chunks=(10, 5))
    np.testing.assert_allclose(got, np.linalg.svd(an, compute_uv=False), atol=ATOL)


def test_svdvals_plan_never_forms_q(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    s = pxp.linalg.svdvals(cubed_tpu_torch.from_array(np.random.default_rng(16).standard_normal((40, 6)),
                                                     chunks=(10, 6), spec=spec))
    ops = [d.get("op_name", "") for d in s.plan.dag.nodes.values()]
    assert "tsqr_panel_r" in ops and "tsqr_panel" not in ops and "tsqr_apply_q" not in ops


@pytest.mark.parametrize("upper", [False, True])
def test_cholesky(tmp_path, upper):
    an = _spd(np.random.default_rng(6), 6)
    got = _factor(tmp_path, lambda xp, a: xp.linalg.cholesky(a, upper=upper), an, chunks=(3, 3))
    want = np.linalg.cholesky(an)
    np.testing.assert_allclose(got, want.T if upper else want, atol=ATOL)


@pytest.mark.parametrize("name", ["det", "logabsdet", "sign", "inv"])
def test_det_slogdet_inv_batched(tmp_path, name):
    an = _spd(np.random.default_rng(7), 2, 4)
    build = {
        "det": lambda xp, a: xp.linalg.det(a),
        "logabsdet": lambda xp, a: xp.linalg.slogdet(a).logabsdet,
        "sign": lambda xp, a: xp.linalg.slogdet(a).sign,
        "inv": lambda xp, a: xp.linalg.inv(a),
    }[name]
    got = _factor(tmp_path, build, an, chunks=(1, 2, 2), rtol=1e-12)
    want = {"det": np.linalg.det(an), "logabsdet": np.linalg.slogdet(an)[1], "sign": np.linalg.slogdet(an)[0],
            "inv": np.linalg.inv(an)}[name]
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=ATOL)


def test_solve_batched(tmp_path):
    rng = np.random.default_rng(7)
    an, bn = _spd(rng, 2, 4), rng.standard_normal((2, 4, 3))
    got = _factor(tmp_path, lambda xp, a, b: xp.linalg.solve(a, b), an, bn, chunks=[(1, 2, 2), (1, 4, 3)])
    np.testing.assert_allclose(got, np.linalg.solve(an, bn), atol=ATOL)


def test_solve_vector(tmp_path):
    rng = np.random.default_rng(8)
    an, bn = _spd(rng, 5), rng.standard_normal(5)
    got = _factor(tmp_path, lambda xp, a, b: xp.linalg.solve(a, b), an, bn, chunks=[(5, 5), (5,)])
    np.testing.assert_allclose(got, np.linalg.solve(an, bn), atol=ATOL)


@pytest.mark.parametrize("batch", [(), (3,)], ids=["matrix", "batched"])
def test_eigh(tmp_path, batch):
    an = _spd(np.random.default_rng(9), *batch, 5)
    chunks = (2, 5, 5) if batch else (5, 5)
    vals = _factor(tmp_path / "v", lambda xp, a: xp.linalg.eigh(a).eigenvalues, an, chunks=chunks)
    vecs = _factor(tmp_path / "w", lambda xp, a: xp.linalg.eigh(a).eigenvectors, an, chunks=chunks, canon=_cols)
    np.testing.assert_allclose(vals, np.linalg.eigvalsh(an), atol=ATOL)
    np.testing.assert_allclose(an @ vecs, vecs * vals[..., None, :], atol=1e-9)
    got = _factor(tmp_path / "e", lambda xp, a: xp.linalg.eigvalsh(a), an, chunks=chunks)
    np.testing.assert_allclose(got, vals, atol=ATOL)


def test_batched_svd(tmp_path):
    bn = np.random.default_rng(17).standard_normal((3, 6, 4))
    un = _factor(tmp_path / "u", lambda xp, a: xp.linalg.svd(a, full_matrices=False).U, bn, chunks=(1, 6, 4),
                 canon=_cols)
    sn = _factor(tmp_path / "s", lambda xp, a: xp.linalg.svd(a, full_matrices=False).S, bn, chunks=(1, 6, 4))
    vhn = _factor(tmp_path / "vh", lambda xp, a: xp.linalg.svd(a, full_matrices=False).Vh, bn, chunks=(1, 6, 4),
                  canon=_rows)
    np.testing.assert_allclose((un * sn[..., None, :]) @ vhn, bn, atol=ATOL)


@pytest.mark.parametrize("offset", [0, 1, -2])
def test_diagonal_trace(tmp_path, offset):
    an = np.arange(30, dtype=np.float64).reshape(5, 6)
    got = _factor(tmp_path / "d", lambda xp, a: xp.linalg.diagonal(a, offset=offset), an, chunks=(2, 2))
    np.testing.assert_array_equal(got, np.diagonal(an, offset=offset))
    got = _factor(tmp_path / "t", lambda xp, a: xp.linalg.trace(a, offset=offset), an, chunks=(2, 2))
    assert float(got) == np.trace(an, offset=offset)


def test_cross(tmp_path):
    rng = np.random.default_rng(10)
    an, bn = rng.standard_normal((4, 3)), rng.standard_normal((4, 3))
    got = _factor(tmp_path, lambda xp, a, b: xp.linalg.cross(a, b), an, bn, chunks=(2, 3))
    np.testing.assert_allclose(got, np.cross(an, bn), atol=1e-12)


@pytest.mark.parametrize("p", [0, 1, 2, 3, 5, -2])
def test_matrix_power(tmp_path, p):
    an = np.random.default_rng(11).standard_normal((4, 4))
    got = _factor(tmp_path, lambda xp, a: xp.linalg.matrix_power(a, p), an, chunks=(2, 2), atol=1e-9)
    np.testing.assert_allclose(got, np.linalg.matrix_power(an, p), atol=1e-8)


@pytest.mark.parametrize("ord", ["fro", 1, -1, np.inf, -np.inf, 2, -2, "nuc"])
def test_matrix_norm(tmp_path, ord):
    an = np.random.default_rng(12).standard_normal((6, 4))
    got = _factor(tmp_path, lambda xp, a: xp.linalg.matrix_norm(a, ord=ord), an, chunks=(3, 2))
    np.testing.assert_allclose(float(got), np.linalg.norm(an, ord=ord), rtol=1e-10)


@pytest.mark.parametrize("axis, ord", [(None, 2), (1, np.inf), (0, 3), (0, 0), (1, -np.inf)])
def test_vector_norm(tmp_path, axis, ord):
    an = np.random.default_rng(13).standard_normal((8, 5))
    got = _factor(tmp_path, lambda xp, a: xp.linalg.vector_norm(a, axis=axis, ord=ord), an, chunks=(4, 5))
    want = np.linalg.norm(an.ravel() if axis is None else an, ord=ord, **({} if axis is None else {"axis": axis}))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_matrix_rank_pinv(tmp_path):
    rng = np.random.default_rng(14)
    an = np.outer(rng.standard_normal(8), rng.standard_normal(5)) + np.outer(rng.standard_normal(8),
                                                                             rng.standard_normal(5))
    assert int(_factor(tmp_path / "r", lambda xp, a: xp.linalg.matrix_rank(a), an, chunks=(4, 5))) == 2
    got = _factor(tmp_path / "p", lambda xp, a: xp.linalg.pinv(a), an, chunks=(4, 5), atol=1e-9)
    np.testing.assert_allclose(got, np.linalg.pinv(an), atol=1e-8)


def test_diagonal_with_nonfinite_and_bool(tmp_path):
    an = np.array([[1.0, np.inf], [np.nan, 4.0]])
    np.testing.assert_array_equal(_factor(tmp_path / "f", lambda xp, a: xp.linalg.diagonal(a), an, chunks=(2, 2)),
                                  [1.0, 4.0])
    bn = np.array([[True, False], [True, True]])
    out = _factor(tmp_path / "b", lambda xp, a: xp.linalg.diagonal(a), bn, chunks=(2, 2))
    assert out.dtype == np.bool_
    np.testing.assert_array_equal(out, np.diagonal(bn))


def test_diagonal_out_of_range_offset_is_empty(tmp_path):
    an = np.ones((3, 4))
    assert _factor(tmp_path / "d", lambda xp, a: xp.linalg.diagonal(a, offset=10), an, chunks=(3, 4)).shape == (0,)
    assert float(_factor(tmp_path / "t", lambda xp, a: xp.linalg.trace(a, offset=10), an, chunks=(3, 4))) == 0.0


def test_complex_dtype_results_are_real_where_the_standard_says(tmp_path):
    rng = np.random.default_rng(18)
    an = (rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))).astype(np.complex64)
    s = _factor(tmp_path / "s", lambda xp, a: xp.linalg.svdvals(a), an, chunks=(3, 4), atol=1e-5, rtol=1e-5)
    assert s.dtype == np.float32
    np.testing.assert_allclose(s, np.linalg.svd(an, compute_uv=False), atol=1e-4)
    assert int(_factor(tmp_path / "k", lambda xp, a: xp.linalg.matrix_rank(a), an, chunks=(3, 4))) == 4
    hn = (an[:4] @ an[:4].conj().T + 6 * np.eye(4)).astype(np.complex64)
    vals = _factor(tmp_path / "v", lambda xp, a: xp.linalg.eigh(a).eigenvalues, hn, chunks=(4, 4), atol=1e-5,
                   rtol=1e-5)
    assert vals.dtype == np.float32
    np.testing.assert_allclose(vals, np.linalg.eigvalsh(hn), rtol=1e-4)
    logabs = _factor(tmp_path / "l", lambda xp, a: xp.linalg.slogdet(a).logabsdet, hn, chunks=(4, 4), rtol=1e-5)
    assert logabs.dtype == np.float32
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "n"), allowed_mem="100MB")
    assert pxp.linalg.vector_norm(cubed_tpu_torch.from_array(an, chunks=(3, 4), spec=spec), ord=0).dtype == np.float32


def test_vector_norm_complex_p_is_real(tmp_path):
    an = (np.ones(4) + 1j * np.ones(4)).astype(np.complex64)
    got = _factor(tmp_path, lambda xp, a: xp.linalg.vector_norm(a, ord=3), an, chunks=(4,), rtol=1e-5)
    assert got.dtype == np.float32
    np.testing.assert_allclose(float(got), np.linalg.norm(an, ord=3), rtol=1e-5)


def _hpd(rng, n, complex_=False):
    base = rng.standard_normal((n, n)) / n**0.5
    if complex_:
        base = base + 1j * rng.standard_normal((n, n)) / n**0.5
    return base @ base.conj().T + np.eye(n)


BLOCKED = [
    ("exceeds one task", 200, (50, 50), 600_000, False),
    ("ragged last block", 170, (60, 60), 500_000, False),
    ("complex Hermitian", 96, (24, 24), 300_000, True),
]


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("case, n, chunks, mem, complex_", BLOCKED, ids=[b[0] for b in BLOCKED])
def test_blocked_cholesky(tmp_path, case, n, chunks, mem, complex_, upper):
    """Too large for one task's gufunc (5 n^2 itemsize over allowed_mem):
    the right-looking panels and the one-write assembly (a map_direct whose
    task bodies read device views on CudaExecutor)."""
    an = _hpd(np.random.default_rng(19), n, complex_)
    assert 5 * an.nbytes > mem
    got = _factor(tmp_path, lambda xp, a: xp.linalg.cholesky(a, upper=upper), an, chunks=chunks, atol=1e-9,
                  allowed_mem=mem)
    want = np.linalg.cholesky(an)
    np.testing.assert_allclose(got, want.conj().T if upper else want, atol=1e-9)


def test_blocked_cholesky_writes_only_its_output(tmp_path):
    """On CudaExecutor the assembly reads its L blocks on the device: no
    intermediate array is written to storage."""
    an = _hpd(np.random.default_rng(20), 120)
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem=250_000)
    lo = pxp.linalg.cholesky(cubed_tpu_torch.from_array(an, chunks=(40, 40), spec=spec))
    ex = CudaExecutor()
    np.testing.assert_allclose(np.asarray(lo.compute(executor=ex)), np.linalg.cholesky(an), atol=1e-9)
    written = {root for root, _, files in os.walk(tmp_path) if root.endswith(".zarr") and
               any(f != ".zarray" for f in files)}
    assert len(written) == 1, written


def test_cholesky_of_a_matrix_that_is_not_positive_definite(tmp_path):
    """The JAX package's result: NaN on and below the diagonal, 0 above, the
    batch's other matrices unaffected; nothing raises."""
    an = np.array([[[4., 2, 0], [2, 3, 1], [0, 1, 2]], [[1., 2, 3], [2, 1, 0], [3, 0, 1]],
                   [[2., 0, 0], [0, -1, 0], [0, 0, 1]]])
    for upper in (False, True):
        got = _factor(tmp_path / str(upper), lambda xp, a: xp.linalg.cholesky(a, upper=upper), an, chunks=(1, 3, 3))
        lower = np.swapaxes(got, -1, -2) if upper else got
        np.testing.assert_allclose(lower[0], np.linalg.cholesky(an[0]), atol=ATOL)
        for m in lower[1:]:
            np.testing.assert_array_equal(np.isnan(m), np.tril(np.ones((3, 3), bool)))
            np.testing.assert_array_equal(np.triu(m, 1), 0)


@pytest.mark.parametrize("name", ["inv", "solve"])
def test_inv_and_solve_of_a_singular_matrix(tmp_path, name):
    """The JAX package's infinities (its LU's), the batch's other matrices
    unaffected; nothing raises."""
    an = np.array([[[1., 2], [2, 4]], [[2., 1], [1, 2]]])
    if name == "inv":
        got = _factor(tmp_path, lambda xp, a: xp.linalg.inv(a), an, chunks=(1, 2, 2), rtol=1e-12)
        np.testing.assert_allclose(got[1], np.linalg.inv(an[1]), rtol=1e-12)
    else:
        bn = np.ones((2, 2, 1))
        got = _factor(tmp_path, lambda xp, a, b: xp.linalg.solve(a, b), an, bn, chunks=[(1, 2, 2), (1, 2, 1)],
                      rtol=1e-12)
        np.testing.assert_allclose(got[1], np.linalg.solve(an[1], bn[1]), rtol=1e-12)
    assert not np.isfinite(got[0]).any()


def test_per_output_chunks_length_mismatch(tmp_path):
    from cubed_tpu_torch.core.ops import general_blockwise

    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(np.ones((4, 4)), chunks=(2, 4), spec=spec)
    with pytest.raises(ValueError, match="one entry per output"):
        general_blockwise(lambda c: (c, c), lambda k: ((a.name, *k[1:]),), a, shape=[(4, 4), (4, 4)],
                          dtype=[a.dtype, a.dtype], chunks=[((2, 2), (4,)), ((2, 2), (4,)), ((2, 2), (4,))])
    with pytest.raises(ValueError, match="one block grid"):
        general_blockwise(lambda c: (c, c), lambda k: ((a.name, *k[1:]),), a, shape=[(4, 4), (4, 4)],
                          dtype=[a.dtype, a.dtype], chunks=[((2, 2), (4,)), ((4,), (4,))])


def test_per_output_chunks_in_the_primitive():
    from cubed_tpu_torch.primitive.blockwise import general_blockwise
    from cubed_tpu_torch.storage.virtual import virtual_empty

    src = virtual_empty((8, 3), dtype=np.float64, chunks=(4, 3))
    kw = dict(allowed_mem=10**9, reserved_mem=0, target_store=["q", "r"], shape=[(8, 3), (6, 3)],
              dtype=[np.dtype(np.float64)] * 2, in_names=["x"], out_name=["q", "r"])
    op = general_blockwise(lambda a: (a, a[:3]), lambda k: (("x", k[1], 0),), src,
                           chunks=[((4, 4), (3,)), ((3, 3), (3,))], **kw)
    assert [tuple(t.chunks) for t in op.target_arrays] == [(4, 3), (3, 3)]
    assert op.num_tasks == 2
    # each output counted twice at its own block size, the input twice
    assert op.projected_mem == 2 * 8 * (12 + 12 + 9)
    with pytest.raises(ValueError, match="one entry per output"):
        general_blockwise(lambda a: (a, a), lambda k: (("x", k[1], 0),), src, chunks=[((4, 4), (3,))], **kw)


@pytest.mark.parametrize("name, marked", [
    ("cholesky", False), ("inv", False), ("solve", False), ("det", False), ("slogdet", False), ("qr", False),
    ("eigh", False), ("eigvalsh", False), ("svd", True), ("svdvals", True), ("eigh complex", True),
    ("eigvalsh complex", True)])
def test_which_solvers_run_their_segment_op_by_op(tmp_path, name, marked):
    """A solver whose torch.linalg call checks its info on the host declares
    ``host_sync`` (svd, svdvals; eigh and eigvalsh of complex input: the real
    ones are the Jacobi method in torch operations); CudaExecutor then runs
    its segment op by op on the card (the others capture)."""
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    an = _spd(np.random.default_rng(21), 3, 4)
    a = cubed_tpu_torch.from_array(an + 0j if name.endswith("complex") else an, chunks=(1, 4, 4), spec=spec)
    name = name.split()[0]
    x = {"cholesky": lambda: pxp.linalg.cholesky(a), "inv": lambda: pxp.linalg.inv(a),
         "solve": lambda: pxp.linalg.solve(a, a), "det": lambda: pxp.linalg.det(a),
         "slogdet": lambda: pxp.linalg.slogdet(a).sign, "qr": lambda: pxp.linalg.qr(a).R,
         "eigh": lambda: pxp.linalg.eigh(a).eigenvalues, "eigvalsh": lambda: pxp.linalg.eigvalsh(a),
         "svd": lambda: pxp.linalg.svd(a, full_matrices=False).S, "svdvals": lambda: pxp.linalg.svdvals(a)}[name]()
    plan = x.plan._finalize(array_names=(x.name,))
    ops = [(n, d) for n, d in plan.dag.nodes.items() if d.get("primitive_op") is not None]
    assert CudaExecutor._uncapturable(ops) is marked


def test_a_zero_d_literal_on_the_device_executor(tmp_path):
    """A 0-d ``asarray`` literal uploaded to the device keeps its shape
    (numpy's ascontiguousarray makes a 0-d array 1-d), so ``vector_norm``'s
    ``pow(sum, 1/p)`` and any product of literals run on CudaExecutor."""
    rs, ps = specs(tmp_path)
    r = rxp.multiply(rxp.asarray(2.0, spec=rs), rxp.asarray(3.0, spec=rs))
    p = pxp.multiply(pxp.asarray(2.0, spec=ps), pxp.asarray(3.0, spec=ps))
    assert plan_of(p) == plan_of(r)
    assert float(p.compute(executor=CudaExecutor())) == float(r.compute()) == 6.0


def test_eigh_in_pieces_equals_one_call(tmp_path, monkeypatch):
    """On the card torch's batched eigensolver refuses 32768 matrices or
    more in one call, so a complex ``eigh``/``eigvalsh`` solves a bucket in
    pieces of ``EIGH_PIECE`` matrices (cut to 4 here: a bucket of 3 blocks
    of 4); the values are one call's."""
    from cubed_tpu_torch.array_api import linalg as port_linalg

    rng = np.random.default_rng(23)
    b = rng.standard_normal((12, 5, 5)) + 1j * rng.standard_normal((12, 5, 5))
    an = b @ np.conj(np.swapaxes(b, -1, -2)) + 5 * np.eye(5)
    whole = _factor(tmp_path / "whole", lambda xp, a: xp.linalg.eigh(a).eigenvalues, an, chunks=(4, 5, 5))
    monkeypatch.setattr(port_linalg, "EIGH_PIECE", 4)
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "pieces"), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(an, chunks=(4, 5, 5), spec=spec)
    ex = CudaExecutor()
    np.testing.assert_allclose(pxp.linalg.eigh(a).eigenvalues.compute(executor=ex), whole, rtol=0, atol=0)
    np.testing.assert_allclose(pxp.linalg.eigvalsh(a).compute(executor=ex), whole, rtol=0, atol=1e-13)
    assert ex.stats["batched_ops"] >= 1 and ex.stats["batched_errors"] == 0


def test_a_block_function_with_an_ellipsis_is_described():
    """``x[..., i]`` puts ``Ellipsis`` among a function's code constants; the
    device executor's structural key describes it, so such a segment (eigh's
    block function) is captured on the card."""
    from cubed_tpu_torch.runtime.executors.cuda import _Describer

    def block(x):
        return x[..., None, :]

    assert _Describer(set())(block) == _Describer(set())(block)
