"""The port's ``apply_gufunc`` against the JAX package on the CPU: the same
inputs and signatures, the same plans (tasks, ops and projected memory),
the same values on both of the port's executors, and on ``CudaExecutor``
(chunks on the CPU) the path counters of ``JaxExecutor``. Each block
function is written once per package, in its own array library.

Counterparts of tests/test_gufunc.py, all nine.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu_torch  # noqa: E402
from cubed_tpu.backend_array_api import nxp as rnxp  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.backend_array_api import nxp as pnxp  # noqa: E402
from cubed_tpu_torch.core.gufunc import _parse_gufunc_signature  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor  # noqa: E402

RTOL = 1e-12
PATH_COUNTERS = ("whole_array_hits", "batched_ops", "chunked_ops", "eager_ops")


def _check(tmp_path, build, want, host=False):
    """*build(pkg, spec)* in both packages; plans, values (rtol 1e-12 of
    numpy's *want* and of each other) and path counters must agree. A *host*
    function (``vectorize``) does not batch: both executors count a failed
    batched check and run it chunked."""
    jax_executor_module._STRUCT_CACHE.clear()  # trace anew, so its path counters fire
    ref_ex, port_ex = JaxExecutor(), CudaExecutor()
    ref = build(cubed_tpu, cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="100MB"))
    port_spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="100MB")
    port = build(cubed_tpu_torch, port_spec)
    outs = (ref, port) if isinstance(ref, tuple) else ((ref,), (port,))
    for r, p in zip(*outs):
        rp = r.plan._finalize(array_names=(r.name,))
        pp = p.plan._finalize(array_names=(p.name,))
        assert (pp.num_tasks(), pp.num_ops(), pp.max_projected_mem()) == (
            rp.num_tasks(), rp.num_ops(), rp.max_projected_mem())
    ref_values = [np.asarray(v) for v in cubed_tpu.compute(*outs[0], executor=ref_ex)]
    got = cubed_tpu_torch.compute(*outs[1], executor=port_ex)
    seq = cubed_tpu_torch.compute(*build(cubed_tpu_torch, port_spec) if isinstance(port, tuple)
                                  else (build(cubed_tpu_torch, port_spec),), executor=PythonDagExecutor())
    wants = want if isinstance(want, list) else [want]
    for r, g, s, w in zip(ref_values, got, seq, wants):
        assert g.dtype == r.dtype and g.shape == r.shape
        for v in (g, s, w):
            np.testing.assert_allclose(v, r, rtol=RTOL, atol=0)
    assert {c: port_ex.stats[c] for c in PATH_COUNTERS} == {c: ref_ex.stats[c] for c in PATH_COUNTERS}
    # (the reference counts the failure again when its segment's trace
    # fails and the op is retried eagerly)
    assert (ref_ex.stats["batched_errors"] > 0) == host
    assert port_ex.stats["batched_errors"] == port_ex.stats["eager_fallbacks"] == (1 if host else 0)


def _lib(pkg):
    """(the package's nxp, whether it is the port)."""
    return (pnxp, True) if pkg is cubed_tpu_torch else (rnxp, False)


def test_elementwise_gufunc(tmp_path):
    an = np.arange(12.0).reshape(3, 4)

    def build(pkg, spec):
        nxp, _ = _lib(pkg)
        a = pkg.from_array(an, chunks=(2, 2), spec=spec)
        return pkg.apply_gufunc(nxp.negative, "()->()", a, output_dtypes=a.dtype)

    _check(tmp_path, build, -an)


def test_core_dim_reduction(tmp_path):
    an = np.arange(24.0).reshape(4, 6)

    def build(pkg, spec):
        def last_mean(x):
            return x.sum(-1) / x.shape[-1]

        # the core dim is one chunk
        return pkg.apply_gufunc(last_mean, "(i)->()", pkg.from_array(an, chunks=(2, 6), spec=spec),
                                output_dtypes=np.float64)

    _check(tmp_path, build, an.mean(axis=-1))


def test_matvec_gufunc(tmp_path):
    rng = np.random.default_rng(0)
    mats, vecs = rng.random((3, 4, 5)), rng.random((3, 5))

    def build(pkg, spec):
        nxp, _ = _lib(pkg)

        def matvec(m, v):
            return nxp.einsum("...ij,...j->...i", m, v)

        a = pkg.from_array(mats, chunks=(1, 4, 5), spec=spec)
        b = pkg.from_array(vecs, chunks=(1, 5), spec=spec)
        return pkg.apply_gufunc(matvec, "(i,j),(j)->(i)", a, b, output_dtypes=mats.dtype)

    _check(tmp_path, build, np.einsum("bij,bj->bi", mats, vecs))


def test_chunked_core_dim_raises(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(np.arange(24.0).reshape(4, 6), chunks=(2, 3), spec=spec)
    with pytest.raises(ValueError, match="core dimension .* rechunk"):
        cubed_tpu_torch.apply_gufunc(lambda x: pnxp.sum(x, axis=-1), "(i)->()", a, output_dtypes=a.dtype)


def test_vectorize(tmp_path):
    an = np.arange(6.0)

    def build(pkg, spec):
        def add_one_scalar(x):
            return x + 1

        return pkg.apply_gufunc(add_one_scalar, "()->()", pkg.from_array(an, chunks=3, spec=spec),
                                output_dtypes=np.float64, vectorize=True)

    _check(tmp_path, build, an + 1, host=True)


def test_bad_signature(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(np.zeros(3), chunks=3, spec=spec)
    with pytest.raises(ValueError, match="valid gufunc signature"):
        cubed_tpu_torch.apply_gufunc(lambda x: x, "bad sig", a, output_dtypes=np.float64)
    assert _parse_gufunc_signature("(i,j),(j)->(i)") == ([("i", "j"), ("j",)], [("i",)])


def test_apply_gufunc_multiple_outputs(tmp_path):
    """Same-core-dim outputs are one multi-output op."""
    an = np.random.default_rng(0).random((8, 6))

    def build(pkg, spec):
        _, port = _lib(pkg)

        def mean_and_ptp(a):
            if port:
                return a.mean(dim=-1), torch.amax(a, dim=-1) - torch.amin(a, dim=-1)
            return a.mean(axis=-1), a.max(axis=-1) - a.min(axis=-1)

        a = pkg.from_array(an, chunks=(2, 6), spec=spec)
        return pkg.apply_gufunc(mean_and_ptp, "(i)->(),()", a, output_dtypes=[np.float64, np.float64])

    _check(tmp_path, build, [an.mean(axis=1), an.max(axis=1) - an.min(axis=1)])
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "plan"), allowed_mem="100MB")
    m, _ = build(cubed_tpu_torch, spec)
    multi = [d["primitive_op"] for d in m.plan.dag.nodes.values()
             if d.get("type") == "op" and d.get("primitive_op") is not None
             and d["primitive_op"].target_arrays is not None]
    assert len(multi) == 1 and len(multi[0].target_arrays) == 2


def test_apply_gufunc_multiple_outputs_vectorized_divmod(tmp_path):
    an = (np.random.default_rng(1).random(24) * 100).reshape(4, 6)

    def build(pkg, spec):
        a = pkg.from_array(an, chunks=(2, 3), spec=spec)
        return pkg.apply_gufunc(lambda v: (v // 7.0, v % 7.0), "()->(),()", a,
                                output_dtypes=[np.float64, np.float64], vectorize=True)

    _check(tmp_path, build, [an // 7.0, an % 7.0], host=True)


def test_apply_gufunc_differing_output_core_dims_rejected(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(np.zeros((4, 4)), chunks=(2, 4), spec=spec)
    with pytest.raises(NotImplementedError, match="same core dimensions"):
        cubed_tpu_torch.apply_gufunc(lambda v: (v, v.sum()), "(i)->(i),()", a,
                                     output_dtypes=[np.float64, np.float64])
