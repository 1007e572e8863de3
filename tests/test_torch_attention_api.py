"""The attention bridge (``cubed_tpu_torch/parallel/attention.py``): cubed
arrays in, a cubed array out, ring-parallel under a mesh, held against the
JAX package's ``attention`` on the same numpy inputs. Counterpart of
tests/parallel/test_attention_api.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu as ct_ref  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
from cubed_tpu.parallel import attention as ref_attention  # noqa: E402
from cubed_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from cubed_tpu_torch.parallel import attention, make_mesh  # noqa: E402
from cubed_tpu_torch.parallel.ring_attention import dense_attention  # noqa: E402

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture
def specs(tmp_path):
    return (ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB"),
            ct_ref.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB", reserved_mem=0))


def _qkv(pkg, spec, B=2, S=16, H=2, D=8, seed=0):
    rng = np.random.default_rng(seed)
    qn, kn, vn = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    wrap = lambda an: pkg.from_array(an, chunks=(B, S // 2, H, D), spec=spec)  # noqa: E731
    return (qn, kn, vn), (wrap(qn), wrap(kn), wrap(vn))


def _ref_devices():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("the JAX package's side needs 8 virtual CPU devices")
    return devs[:8]


def test_attention_dense_single_device(specs):
    (qn, kn, vn), (q, k, v) = _qkv(ct, specs[0])
    out = attention(q, k, v)
    expect = dense_attention(*(torch.from_numpy(x) for x in (qn, kn, vn))).numpy()
    got = np.asarray(out.compute())
    assert out.chunksize == q.chunksize
    np.testing.assert_allclose(got, expect, atol=2e-5)
    _, (rq, rk, rv) = _qkv(ct_ref, specs[1])
    np.testing.assert_allclose(got, np.asarray(ref_attention(rq, rk, rv).compute()), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_ring_over_mesh(specs, causal):
    mesh = make_mesh(shape=(8,), axis_names=("seq",), devices=CPU8)
    (qn, kn, vn), (q, k, v) = _qkv(ct, specs[0])
    out = attention(q, k, v, causal=causal, mesh=mesh)
    expect = dense_attention(*(torch.from_numpy(x) for x in (qn, kn, vn)), causal=causal).numpy()
    got = np.asarray(out.compute())
    np.testing.assert_allclose(got, expect, atol=2e-5)
    assert out.chunksize == q.chunksize and out.dtype == q.dtype
    ref_mesh = ref_make_mesh(shape=(8,), axis_names=("seq",), devices=_ref_devices())
    _, (rq, rk, rv) = _qkv(ct_ref, specs[1])
    np.testing.assert_allclose(got, np.asarray(ref_attention(rq, rk, rv, causal=causal, mesh=ref_mesh).compute()),
                               atol=2e-5)


def test_attention_rejects_bad_rank(specs):
    a = ct.from_array(np.zeros((4, 4)), chunks=(2, 2), spec=specs[0])
    with pytest.raises(ValueError):
        attention(a, a, a)


def test_attention_rejects_axis_name_miss(specs):
    # a mesh without the requested axis must raise, not silently run dense
    mesh = make_mesh(shape=(8,), axis_names=("data",), devices=CPU8)
    _, (q, k, v) = _qkv(ct, specs[0])
    with pytest.raises(ValueError, match="not a mesh axis"):
        attention(q, k, v, mesh=mesh)  # default axis_name='seq'


def test_attention_inputs_computed_in_one_plan(specs):
    """One source, three projections: the inputs are computed in one plan,
    and the float64 source rides the ring in float32, as the reference's
    body computes every step."""
    import cubed_tpu_torch.array_api as xp

    spec = specs[0]
    src = ct.random.random((2, 16, 2, 8), chunks=(2, 8, 2, 8), spec=spec)
    q, k, v = (xp.multiply(src, float(c)) for c in (1.0, 0.5, 0.25))
    mesh = make_mesh(shape=(4,), axis_names=("seq",), devices=CPU8[:4])
    out = attention(q, k, v, mesh=mesh, causal=True)
    sn = src.compute()
    expect = dense_attention(*(torch.from_numpy(sn * c) for c in (1.0, 0.5, 0.25)), causal=True).numpy()
    assert out.dtype == np.float64
    np.testing.assert_allclose(np.asarray(out.compute()), expect, atol=2e-5)
