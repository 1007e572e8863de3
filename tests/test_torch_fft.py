"""The port's ``fft`` namespace against the JAX package's on the CPU: the
same numpy inputs, the same plans (tasks, ops, projected memory: the
transform axis gathered to one chunk, one op per transformed axis), values
on the port's sequential executor and on ``CudaExecutor`` (chunks on the
CPU), and ``CudaExecutor``'s path counters equal to ``JaxExecutor``'s, every
failed check 0 (``tests/_torch_parity.py``).

Tolerances: float64 and complex128 rtol 1e-12 (atol 1e-12 where a value
cancels to about zero); float32 and complex64 rtol 1e-5; a shift moves
values, exactly. Counterparts of ``tests/test_fft.py``'s fifteen tests.
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

from ._torch_parity import PATH_COUNTERS, plan_of, specs  # noqa: E402

RTOL = 1e-12
ATOL = 1e-12
RTOL_F32 = 1e-5


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL if rtol == RTOL else 1e-5)


def _check(tmp_path, build, data, chunks, want=None, rtol=RTOL):
    """The parity harness's checks (plans, values on both of the port's
    executors, path counters), with an absolute floor: transforms of random
    data cancel some outputs to about zero, where a relative tolerance means
    nothing."""
    got, _ = _parity_atol(tmp_path, build, data, chunks, rtol)
    if want is not None:
        _close(got, want, rtol)
    return got


def _parity_atol(tmp_path, build, data, chunks, rtol):
    rs, ps = specs(tmp_path)
    r = build(rxp, cubed_tpu.from_array(data, chunks=chunks, spec=rs))
    p = build(pxp, cubed_tpu_torch.from_array(data, chunks=chunks, spec=ps))
    assert plan_of(p) == plan_of(r)
    jax_executor_module._STRUCT_CACHE.clear()
    # its segment cache too: keyed by the lowered HLO's text, where a large
    # constant is elided, it could replay another test's program of this shape
    jax_executor_module._SEGMENT_CACHE.clear()
    rex, pex = JaxExecutor(), CudaExecutor()
    ref = np.asarray(r.compute(executor=rex))
    got = np.asarray(p.compute())
    assert got.dtype == ref.dtype and got.shape == ref.shape
    _close(got, ref, rtol)
    _close(np.asarray(p.compute(executor=pex)), ref, rtol)
    assert {c: pex.stats[c] for c in PATH_COUNTERS} == {c: rex.stats.get(c, 0) for c in PATH_COUNTERS}
    assert pex.stats["eager_fallbacks"] == 0 and pex.stats["batched_errors"] == 0
    return got, ref


def _an(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def test_fft_ifft_roundtrip(tmp_path):
    an = _an((6, 32), 0)
    _check(tmp_path / "f", lambda xp, a: xp.fft.fft(a), an, (2, 8), np.fft.fft(an))
    _check(tmp_path / "i", lambda xp, a: xp.fft.ifft(xp.fft.fft(a)), an, (2, 8), an)


def test_fft_other_axes_stay_chunked(tmp_path):
    an = _an((8, 16), 1)
    got = _check(tmp_path, lambda xp, a: xp.fft.fft(a, axis=1), an, (2, 4), np.fft.fft(an, axis=1))
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "nb"), allowed_mem="100MB")
    assert pxp.fft.fft(cubed_tpu_torch.from_array(an, chunks=(2, 4), spec=spec), axis=1).numblocks[0] == 4
    assert got.shape == (8, 16)


@pytest.mark.parametrize("n", [6, 16])
def test_fft_n_pad_truncate(tmp_path, n):
    an = _an((4, 10), 2)
    _check(tmp_path, lambda xp, a: xp.fft.fft(a, n=n), an, (2, 5), np.fft.fft(an, n=n))


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
def test_norms(tmp_path, norm):
    an = _an(24, 3)
    _check(tmp_path, lambda xp, a: xp.fft.fft(a, norm=norm), an, (8,), np.fft.fft(an, norm=norm))


def test_rfft_irfft(tmp_path):
    an = _an((3, 20), 4)
    _check(tmp_path / "r", lambda xp, a: xp.fft.rfft(a), an, (1, 5), np.fft.rfft(an))
    _check(tmp_path / "ir", lambda xp, a: xp.fft.irfft(xp.fft.rfft(a)), an, (1, 5), an)
    _check(tmp_path / "n", lambda xp, a: xp.fft.irfft(xp.fft.rfft(a), n=20), an, (1, 5),
           np.fft.irfft(np.fft.rfft(an), n=20))


def test_hfft_ihfft(tmp_path):
    an = _an(9, 5)
    _check(tmp_path / "ih", lambda xp, a: xp.fft.ihfft(a), an, (3,), np.fft.ihfft(an))
    _check(tmp_path / "h", lambda xp, a: xp.fft.hfft(xp.fft.ihfft(a), n=9), an, (3,),
           np.fft.hfft(np.fft.ihfft(an), n=9))


@pytest.mark.parametrize("kw", [{}, {"axes": (0, 2)}, {"s": (4, 8), "axes": (1, 2)}], ids=["all", "axes", "s"])
def test_fftn_separable(tmp_path, kw):
    an = _an((8, 12, 6), 6)
    _check(tmp_path, lambda xp, a: xp.fft.fftn(a, **kw), an, (2, 3, 2), np.fft.fftn(an, **kw))


def test_ifftn_of_fftn(tmp_path):
    an = _an((8, 12, 6), 6)
    _check(tmp_path, lambda xp, a: xp.fft.ifftn(xp.fft.fftn(a)), an, (2, 3, 2), an)


def test_rfftn_irfftn(tmp_path):
    an = _an((6, 10), 7)
    _check(tmp_path / "r", lambda xp, a: xp.fft.rfftn(a), an, (2, 5), np.fft.rfftn(an))
    _check(tmp_path / "ir", lambda xp, a: xp.fft.irfftn(xp.fft.rfftn(a)), an, (2, 5), an)


@pytest.mark.parametrize("n", [8, 9])
def test_fftfreq_rfftfreq(tmp_path, n):
    rs, ps = specs(tmp_path)
    for name, kw, want in (("fftfreq", {}, np.fft.fftfreq(n)), ("fftfreq", {"d": 0.25}, np.fft.fftfreq(n, d=0.25)),
                           ("rfftfreq", {}, np.fft.rfftfreq(n))):
        r = getattr(rxp.fft, name)(n, spec=rs, **kw)
        p = getattr(pxp.fft, name)(n, spec=ps, **kw)
        assert plan_of(p) == plan_of(r)
        got = np.asarray(p.compute(executor=CudaExecutor()))
        np.testing.assert_array_equal(got, np.asarray(r.compute()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_fftshift_roundtrip(tmp_path):
    an = _an((5, 8), 8)
    for i, (build, want) in enumerate((
        (lambda xp, a: xp.fft.fftshift(a), np.fft.fftshift(an)),
        (lambda xp, a: xp.fft.ifftshift(xp.fft.fftshift(a)), an),
        (lambda xp, a: xp.fft.fftshift(a, axes=1), np.fft.fftshift(an, axes=1)),
    )):
        got = _check(tmp_path / str(i), build, an, (2, 3))
        np.testing.assert_array_equal(got, want)


def test_fft_dtype_rules(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a32 = cubed_tpu_torch.from_array(np.ones((4,), np.float32), chunks=(4,), spec=spec)
    assert pxp.fft.fft(a32).dtype == np.complex64
    assert pxp.fft.rfft(a32).dtype == np.complex64
    a64 = cubed_tpu_torch.from_array(np.ones((4,), np.float64), chunks=(4,), spec=spec)
    assert pxp.fft.fft(a64).dtype == np.complex128
    assert pxp.fft.irfft(pxp.fft.fft(a64)).dtype == np.float64
    ai = cubed_tpu_torch.from_array(np.ones((4,), np.int32), chunks=(4,), spec=spec)
    with pytest.raises(TypeError):
        pxp.fft.fft(ai)
    with pytest.raises(ValueError):
        pxp.fft.fft(a64, norm="bogus")


def test_float32_transforms(tmp_path):
    an = _an((6, 32), 9).astype(np.float32)
    _check(tmp_path / "r", lambda xp, a: xp.fft.rfft(a, axis=0), an, (2, 8), np.fft.rfft(an, axis=0),
           rtol=RTOL_F32)
    _check(tmp_path / "ir", lambda xp, a: xp.fft.irfft(xp.fft.rfft(a)), an, (2, 8), an, rtol=RTOL_F32)


def test_complex128_narrowed_under_compute_dtype_float32(tmp_path):
    """Under ``compute_dtype="float32"`` complex128 chunks are complex64 in
    both packages; the transform keeps the narrowing and returns the
    declared dtype, within float32's tolerance of the reference's."""
    an = _an((6, 32), 10)
    rs, ps = specs(tmp_path)
    r = rxp.fft.ifft(rxp.fft.fft(cubed_tpu.from_array(an, chunks=(2, 8), spec=rs)), axis=0)
    p = pxp.fft.ifft(pxp.fft.fft(cubed_tpu_torch.from_array(an, chunks=(2, 8), spec=ps)), axis=0)
    jax_executor_module._STRUCT_CACHE.clear()
    rex, pex = JaxExecutor(compute_dtype="float32"), CudaExecutor(compute_dtype="float32")
    ref = np.asarray(r.compute(executor=rex))
    got = np.asarray(p.compute(executor=pex))
    assert got.dtype == ref.dtype == np.complex128
    np.testing.assert_allclose(got, ref, rtol=RTOL_F32, atol=1e-5)
    np.testing.assert_allclose(got, np.fft.ifft(np.fft.fft(an), axis=0), rtol=RTOL_F32, atol=1e-5)
    assert {c: pex.stats[c] for c in PATH_COUNTERS} == {c: rex.stats.get(c, 0) for c in PATH_COUNTERS}


def test_axis_and_s_validation(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(np.ones(8), chunks=(4,), spec=spec)
    with pytest.raises(IndexError):
        pxp.fft.fft(a, axis=3)
    with pytest.raises(IndexError):
        pxp.fft.fftn(a, s=(4, 4))
    with pytest.raises(IndexError):
        pxp.fft.fftshift(a, axes=2)


def test_fftshift_repeated_axes(tmp_path):
    an = np.arange(5.0)
    got = _check(tmp_path, lambda xp, a: xp.fft.fftshift(a, axes=(0, 0)), an, (5,))
    np.testing.assert_array_equal(got, np.fft.fftshift(an, axes=(0, 0)))


def test_roll_repeated_axes_accumulate(tmp_path):
    an = np.arange(5.0)
    got = _check(tmp_path, lambda xp, a: xp.roll(a, (1, 1), axis=(0, 0)), an, (5,))
    np.testing.assert_array_equal(got, np.roll(an, (1, 1), axis=(0, 0)))


def test_a_transform_op_is_not_fused(tmp_path):
    """``fusable=False`` as in the reference: ``ifft(fft(x))`` keeps its two
    transform ops."""
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(_an((4, 16), 11), chunks=(2, 16), spec=spec)
    f = pxp.fft.fft(a)
    op = f.plan.dag.predecessors(f.name)[0]
    assert f.plan.dag.nodes[op]["primitive_op"].fusable is False
    assert plan_of(pxp.fft.ifft(f))[1] == 3  # create-arrays, fft, ifft
