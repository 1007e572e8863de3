"""The device executor's ``compute_dtype`` and ``matmul_precision``
(``CudaExecutor``, chunks on the CPU) against the JAX package's
``JaxExecutor(compute_dtype="float32", matmul_precision=...)`` on the same
seeded plans.

- Under ``compute_dtype="float32"`` both packages run the float64 plan
  (tasks, ops, projected memory unchanged) in float32 and return the
  declared dtype. Random blocks are the float64 Philox stream rounded to
  float32 in both, so a random array is bit for bit the reference's; any
  other value is held to the reference's documented float32 bound
  (``JaxExecutor``'s docstring; tests/conformance/test_executor_differential.py).
- Integers stay exact in the port, where the reference's x64-off narrows
  int64 to int32 (a deliberate divergence).
- Each ``matmul_precision`` mode is held to an exact model of it: the
  operands rounded in numpy (bit operations, to nearest even), the product
  in float64, rtol 1e-6; and, as the reference test does, within 2e-2 of
  the reference (whose CPU backend ignores the precision).
- An alias (a rechunk's target) counts once against ``device_mem``.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import random  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from hypothesis.extra import numpy as hnp  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch import backend_array_api, contraction  # noqa: E402
from cubed_tpu_torch.kernels.philox_uniform import (  # noqa: E402
    philox_blocks,
    philox_key,
    philox_keys,
    philox_uniform,
    philox_uniform_blocks,
    philox_uniform_blocks_plain,
    philox_uniform_plain,
)
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor, _held, _Resident  # noqa: E402
from cubed_tpu_torch.runtime.pipeline import visit_nodes  # noqa: E402

F32_EPS = float(np.finfo(np.float32).eps)
PATH_COUNTERS = ("whole_array_hits", "whole_concat_hits", "batched_ops", "chunked_ops", "eager_ops",
                 "rechunk_alias", "rechunk_virtual")
FAILED_CHECKS = ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors")


def _an(shape, seed=0):
    return np.random.default_rng(seed).random(shape)


def _bound(k: int, scale: float = 1.0) -> float:
    """The reference's float32 tolerance (test_f32_ingestion_within_documented_bounds):
    anchored to the largest term a multiply can make, over k input elements."""
    return 16.0 * max(k, 1) * scale * scale * F32_EPS


def _plan_stats(x):
    plan = x.plan._finalize(array_names=(x.name,))
    return plan.num_tasks(), plan.num_ops(), plan.max_projected_mem()


def _pair(tmp_path, build, seed=7, allowed_mem="500MB", matmul_precision=(None, None), **options):
    """(reference value, its JaxExecutor, port value, its CudaExecutor) of one
    seeded plan built in both packages, each executor made with *options*
    and its own of the (port, reference) *matmul_precision*; the two plans
    agree in tasks, ops and projected memory."""
    jax_executor_module._STRUCT_CACHE.clear()  # trace anew, so its path counters fire
    ref_ex = JaxExecutor(matmul_precision=matmul_precision[1], **options)
    port_ex = CudaExecutor(matmul_precision=matmul_precision[0], **options)
    random.seed(seed)
    ref = build(cubed_tpu, rxp, cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem=allowed_mem))
    random.seed(seed)
    port = build(cubed_tpu_torch, pxp, cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"),
                                                            allowed_mem=allowed_mem))
    assert _plan_stats(port) == _plan_stats(ref)
    return np.asarray(ref.compute(executor=ref_ex)), ref_ex, port.compute(executor=port_ex), port_ex


# ---------------------------------------------------------------------------
# counterparts of tests/test_plan_fusion.py:461-538
# ---------------------------------------------------------------------------


def _spec(tmp_path, name="w"):
    return cubed_tpu_torch.Spec(work_dir=str(tmp_path / name), allowed_mem="500MB")


def test_compute_dtype_f32_ingestion(tmp_path):
    """An f64 plan run with ``compute_dtype="float32"`` computes in single
    precision, random generation included, and returns the declared f64."""
    spec = _spec(tmp_path)

    def build():
        random.seed(11)
        a = cubed_tpu_torch.random.random((40, 40), chunks=(13, 13), spec=spec)
        b = cubed_tpu_torch.random.random((40, 40), chunks=(13, 13), spec=spec)
        return pxp.mean(pxp.add(pxp.multiply(a, b), pxp.sin(a)))

    f64 = build().compute(executor=CudaExecutor())
    f32 = build().compute(executor=CudaExecutor(compute_dtype="float32"))
    assert f64.dtype == np.float64
    assert f32.dtype == np.float64  # the declared dtype at the boundary
    np.testing.assert_allclose(f32, f64, rtol=1e-4, atol=_bound(1600))
    an = np.linspace(0.0, 1.0, 64, dtype=np.float64).reshape(8, 8)

    def expr():
        src = cubed_tpu_torch.from_array(an, chunks=(3, 3), spec=spec)
        return pxp.sum(pxp.sqrt(pxp.abs(pxp.sin(src) * 2.0 + 1.0)))

    r64 = float(expr().compute(executor=CudaExecutor()))
    r32 = float(expr().compute(executor=CudaExecutor(compute_dtype="float32")))
    np.testing.assert_allclose(r32, r64, rtol=1e-5)  # f32 eps * tree depth


def _boom(x):
    raise ValueError("kernel boom")


def test_compute_dtype_restores_the_narrowing_scope(tmp_path):
    """The scopes are restored after a compute, and on its failure path."""
    spec = _spec(tmp_path)
    assert not backend_array_api.narrowed() and contraction.current() is None
    a = cubed_tpu_torch.from_array(_an((6, 6)), chunks=(2, 2), spec=spec)
    pxp.add(a, 1.0).compute(executor=CudaExecutor(compute_dtype="float32", matmul_precision="bfloat16"))
    assert not backend_array_api.narrowed() and contraction.current() is None
    b = cubed_tpu_torch.map_blocks(_boom, a, dtype=np.float64)
    with pytest.raises(ValueError, match="kernel boom"):
        b.compute(executor=CudaExecutor(compute_dtype="float32", matmul_precision="bfloat16"))
    assert not backend_array_api.narrowed() and contraction.current() is None


@pytest.mark.parametrize("bad", ["bfloat16", "float16", "f32"])
def test_compute_dtype_invalid(bad):
    with pytest.raises(ValueError, match="compute_dtype"):
        CudaExecutor(compute_dtype=bad)


def test_matmul_precision_bf16(tmp_path):
    """bf16 contractions, f32-accumulated: within 1e-2 relative of full
    precision, and exactly the model of the mode."""
    an = np.linspace(0.0, 1.0, 64 * 48, dtype=np.float64).reshape(64, 48)
    bn = np.linspace(1.0, 2.0, 48 * 32, dtype=np.float64).reshape(48, 32)
    spec = _spec(tmp_path)

    def build():
        a = cubed_tpu_torch.from_array(an, chunks=(16, 16), spec=spec)
        b = cubed_tpu_torch.from_array(bn, chunks=(16, 16), spec=spec)
        return pxp.sum(pxp.matmul(a, b))

    exact = float(build().compute(executor=CudaExecutor()))
    fast = float(build().compute(executor=CudaExecutor(compute_dtype="float32", matmul_precision="bfloat16")))
    np.testing.assert_allclose(fast, exact, rtol=2e-2)
    np.testing.assert_allclose(exact, float((an @ bn).sum()), rtol=1e-12)
    np.testing.assert_allclose(fast, float(_model(an, bn, "bfloat16").sum()), rtol=1e-6)


@pytest.mark.parametrize("bad", ["int8", "fp8", "tf32"])
def test_matmul_precision_invalid(bad):
    with pytest.raises(ValueError, match="matmul_precision"):
        CudaExecutor(matmul_precision=bad)
    with pytest.raises(ValueError, match="matmul_precision"):
        with contraction.precision(bad):
            pass


# ---------------------------------------------------------------------------
# the documented bound, fuzzed (tests/conformance/test_executor_differential.py:289)
# ---------------------------------------------------------------------------


def _unary_step(draw, a):
    op = draw(st.sampled_from(["negative", "abs", "multiply2", "add1", "transpose", "slice", "rechunk"]))
    if op == "negative":
        return pxp.negative(a)
    if op == "abs":
        return pxp.abs(a)
    if op == "multiply2":
        return pxp.multiply(a, draw(st.sampled_from([2.0, -0.5, 3.0])))
    if op == "add1":
        return pxp.add(a, draw(st.sampled_from([1.0, -2.0])))
    if op == "transpose":
        return pxp.permute_dims(a, tuple(reversed(range(a.ndim)))) if a.ndim >= 2 else a
    if op == "slice":
        return a[1:] if a.shape[0] > 1 else a
    return a.rechunk(tuple(max(1, s // 3) for s in a.shape))


def _binary_step(draw, a, b):
    if a.shape != b.shape:
        return a
    return getattr(pxp, draw(st.sampled_from(["add", "multiply", "subtract"])))(a, b)


def _reduce_step(draw, a):
    op = draw(st.sampled_from(["sum", "mean", "max", "none"]))
    if op == "none":
        return a
    return getattr(pxp, op)(a, axis=draw(st.one_of(st.none(), st.integers(0, a.ndim - 1))))


_BOUNDED = st.floats(min_value=-1e3, max_value=1e3, allow_nan=False, allow_infinity=False,
                     allow_subnormal=False, width=64)


@settings(max_examples=15, deadline=None)
@given(data=st.data())
def test_f32_ingestion_within_documented_bounds(data, tmp_path_factory):
    """Random plans of the port's surface: float32 within the reference's
    tolerance formula of float64, the declared float64 kept throughout."""
    shape = data.draw(st.sampled_from([(6, 8), (5, 5, 4), (12,)]))
    an = data.draw(hnp.arrays(np.float64, shape, elements=_BOUNDED))
    bn = data.draw(hnp.arrays(np.float64, shape, elements=_BOUNDED))
    chunks = tuple(max(1, (s + 1) // 2) for s in shape)
    spec = _spec(tmp_path_factory.mktemp("fuzz"))
    a = cubed_tpu_torch.from_array(an, chunks=chunks, spec=spec)
    b = cubed_tpu_torch.from_array(bn, chunks=chunks, spec=spec)
    x = _binary_step(data.draw, _unary_step(data.draw, a), b)
    expr = _reduce_step(data.draw, _unary_step(data.draw, x))
    f64 = np.asarray(expr.compute(executor=CudaExecutor()))
    f32 = np.asarray(expr.compute(executor=CudaExecutor(compute_dtype="float32")))
    assert f32.dtype == f64.dtype == np.float64
    scale = max(float(np.max(np.abs(an), initial=0.0)), float(np.max(np.abs(bn), initial=0.0)), 1.0)
    np.testing.assert_allclose(f32, f64, rtol=1e-4, atol=_bound(an.size, scale), equal_nan=True)


# ---------------------------------------------------------------------------
# parity with JaxExecutor(compute_dtype="float32") on the bench workloads, cut
# ---------------------------------------------------------------------------


def _vorticity(pkg, xp, spec):
    a, b, x, y = [pkg.random.random((30, 25, 20), chunks=10, spec=spec) for _ in range(4)]
    return xp.mean(xp.add(xp.multiply(a[1:], x[1:]), xp.multiply(b[1:], y[1:])))


def _addsum(pkg, xp, spec):
    a = pkg.random.random((200, 200), chunks=50, spec=spec)
    b = pkg.random.random((200, 200), chunks=50, spec=spec)
    return xp.sum(xp.add(a, b))


def _elemwise(pkg, xp, spec):
    a, b = [pkg.random.random((120, 120), chunks=40, spec=spec) for _ in range(2)]
    return xp.sum(xp.sqrt(xp.abs(xp.sin(a) * b + xp.cos(b))))


def _reduce(pkg, xp, spec):
    return xp.max(xp.mean(pkg.random.random((160, 160), chunks=40, spec=spec), axis=0))


def _matmul(pkg, xp, spec):
    a, b = [pkg.random.random((80, 80), chunks=20, spec=spec) for _ in range(2)]
    return xp.sum(xp.matmul(a, b))


def _rechunk(pkg, xp, spec):
    a = pkg.random.random((40, 36, 32), chunks=8, spec=spec)
    return xp.mean(a.rechunk((40, 6, 4)), axis=0)


#: plan -> input elements (the bound's k)
WORKLOADS = {"vorticity": (_vorticity, 4 * 15000), "addsum": (_addsum, 2 * 40000),
             "elemwise": (_elemwise, 2 * 14400), "reduce": (_reduce, 25600), "matmul": (_matmul, 2 * 6400),
             "rechunk": (_rechunk, 46080)}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_f32_plans_match_the_reference_executor(tmp_path, name):
    """The same plan, the same path counters and, within the reference's
    float32 bound, the same values; the declared dtype kept."""
    build, k = WORKLOADS[name]
    ref, ref_ex, got, ex = _pair(tmp_path, build, compute_dtype="float32")
    assert got.dtype == ref.dtype == np.float64 and got.shape == ref.shape
    assert {c: ex.stats[c] for c in PATH_COUNTERS} == {c: ref_ex.stats[c] for c in PATH_COUNTERS}
    assert {c: ex.stats[c] for c in FAILED_CHECKS} == dict.fromkeys(FAILED_CHECKS, 0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=_bound(k))
    random.seed(7)
    f64 = build(cubed_tpu_torch, pxp, _spec(tmp_path, "f64")).compute(executor=CudaExecutor())
    np.testing.assert_allclose(got, f64, rtol=1e-4, atol=_bound(k))


@pytest.mark.parametrize("shape, chunks", [((30, 25, 20), 10), ((13, 11), (4, 5)), ((7,), 3)],
                         ids=["30x25x20/10", "13x11/4x5", "7/3"])
def test_a_random_array_is_the_reference_f32_block_bit_for_bit(tmp_path, shape, chunks):
    """The float64 stream rounded to float32, as the reference makes it, on
    the batched route (and on the per-block route for a one-block grid)."""
    ref, _, got, ex = _pair(tmp_path, lambda pkg, xp, spec: pkg.random.random(shape, chunks=chunks, spec=spec),
                            compute_dtype="float32")
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    random.seed(7)
    root = random.getrandbits(30)
    numpy_f64 = philox_uniform_blocks_plain(shape, (chunks,) * len(shape) if isinstance(chunks, int) else chunks,
                                            philox_keys(root + np.arange(got.size)), dtype=torch.float64)
    np.testing.assert_array_equal(got, numpy_f64.numpy().astype(np.float32).astype(np.float64))
    assert ex.stats["batched_ops"] == 1


# ---------------------------------------------------------------------------
# dtypes at the boundary, integers, the scope per thread
# ---------------------------------------------------------------------------


def test_every_result_keeps_its_declared_dtype(tmp_path):
    """float64 results widen back from float32, float32 and int64 results keep
    theirs; an output that stays resident to the end (read by another
    output) is written from residency in its declared dtype."""
    spec = _spec(tmp_path)
    an = _an((9, 8))
    a = cubed_tpu_torch.from_array(an, chunks=(4, 4), spec=spec)
    x = pxp.add(a, 1.0)
    total = pxp.sum(x)
    half = pxp.astype(a, pxp.float32)
    count = pxp.sum(pxp.astype(pxp.multiply(a, 100.0), pxp.int64))
    ex = CudaExecutor(compute_dtype="float32")
    got_x, got_total, got_half, got_count = cubed_tpu_torch.compute(x, total, half, count, executor=ex)
    assert (got_x.dtype, got_total.dtype, got_half.dtype, got_count.dtype) == (
        np.float64, np.float64, np.float32, np.int64)
    np.testing.assert_array_equal(got_x, (an.astype(np.float32) + np.float32(1.0)).astype(np.float64))
    np.testing.assert_array_equal(got_half, an.astype(np.float32))
    assert int(got_count) == int((an.astype(np.float32) * np.float32(100.0)).astype(np.int64).sum())
    # the stored chunks of the resident output are float64 bytes
    assert x.zarray.dtype == np.float64 and x.zarray[...].dtype == np.float64
    np.testing.assert_allclose(got_total, got_x.sum(), rtol=1e-6)


def _target(spec, shape):
    """A float64 store not yet written: an op's output."""
    return pxp.add(cubed_tpu_torch.from_array(np.zeros(shape), chunks=4, spec=spec), 1.0).zarray_maybe_lazy


def test_flush_widens_a_narrowed_resident_value(tmp_path):
    spec = _spec(tmp_path)
    target = _target(spec, (6, 5))
    value = torch.from_numpy(_an((6, 5), 2).astype(np.float32))
    CudaExecutor._flush(_Resident(value, target))
    stored = target.open()[...]
    assert stored.dtype == np.float64
    np.testing.assert_array_equal(stored, value.numpy().astype(np.float64))


def test_spilled_f32_arrays_read_back_the_same(tmp_path):
    """A budget below one array spills narrowed arrays as float64 chunks;
    readers narrow them again on the way in, to the same values."""
    random.seed(6)
    spec = _spec(tmp_path, "spill")
    spilled = _vorticity(cubed_tpu_torch, pxp, spec).compute(
        executor=CudaExecutor(device_mem=100_000, compute_dtype="float32"))
    random.seed(6)
    resident = _vorticity(cubed_tpu_torch, pxp, _spec(tmp_path, "resident")).compute(
        executor=CudaExecutor(compute_dtype="float32"))
    assert spilled.dtype == np.float64
    np.testing.assert_allclose(spilled, resident, rtol=1e-6)


def test_int64_sum_is_exact_where_the_reference_loses_it(tmp_path):
    """x64-off narrows int64 to int32 in the reference, whose sum is 0; the
    port narrows floating types only."""
    data = np.arange(10) * 2**40

    def build(pkg, xp, spec):
        return xp.sum(pkg.from_array(data, chunks=3, spec=spec))

    ref, _, got, _ = _pair(tmp_path, build, compute_dtype="float32")
    assert int(got) == int(data.sum()) == 49478023249920
    assert got.dtype == np.int64
    assert int(ref) == 0  # the reference's documented loss (ROADMAP)


def test_int_division_is_float32_under_the_scope():
    ones = torch.ones(3, dtype=torch.int64)
    assert backend_array_api.nxp.divide(ones, ones).dtype == torch.float64
    with backend_array_api.narrowing():
        assert backend_array_api.nxp.divide(ones, ones).dtype == torch.float32
        assert backend_array_api.to_torch_dtype(np.complex128) == torch.complex64
        assert backend_array_api.to_torch_dtype(np.int64) == torch.int64
        assert backend_array_api.numpy_array_to_backend_array(np.zeros(3)).dtype == torch.float32
        carrier = backend_array_api.numpy_array_to_backend_array(np.broadcast_to(np.float64(2.5), (4, 4)))
        assert carrier.dtype == torch.float32 and carrier.stride() == (0, 0)
    assert backend_array_api.to_torch_dtype(np.float64) == torch.float64


def test_a_default_executor_in_another_thread_keeps_float64(tmp_path):
    """The narrowing scope is the thread's own: while a float32 compute is
    inside a chunk function, a default compute on another thread sees
    float64 chunks and returns float64 values."""
    inside, release = threading.Event(), threading.Event()
    seen = {}

    def hold(x):
        if x.device.type == "meta":  # map_blocks' plan-time trace
            return x
        seen.setdefault("f32", x.dtype)
        inside.set()
        release.wait(30)
        return x

    def look(x):
        if x.device.type == "meta":
            return x
        seen.setdefault("f64", x.dtype)
        return x

    an = _an((4, 4))
    narrow = cubed_tpu_torch.map_blocks(hold, cubed_tpu_torch.from_array(an, chunks=4, spec=_spec(tmp_path, "a")),
                                        dtype=np.float64)
    errors = []

    def run():
        try:
            narrow.compute(executor=CudaExecutor(compute_dtype="float32"))
        except Exception as e:  # surfaced below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    try:
        assert inside.wait(30)
        wide = cubed_tpu_torch.map_blocks(look, cubed_tpu_torch.from_array(an, chunks=4, spec=_spec(tmp_path, "b")),
                                          dtype=np.float64)
        np.testing.assert_array_equal(wide.compute(executor=CudaExecutor()), an)
        assert not backend_array_api.narrowed()
    finally:
        release.set()
        t.join(30)
    assert not errors
    assert seen == {"f32": torch.float32, "f64": torch.float64}


def _segment_key(tmp_path, **options):
    random.seed(1)
    x = _vorticity(cubed_tpu_torch, pxp, _spec(tmp_path, "key"))
    dag = x.plan._finalize(array_names=(x.name,)).dag
    ex = CudaExecutor(**options)
    ops = [(n, d) for n, d in visit_nodes(dag) if ex._classify(d["primitive_op"]) == "segment"]
    keep = ex._segment_keep(ops, dag, {x.zarray_maybe_lazy.store})
    keep_list = [k for k in keep if k in ex._produced(ops)]
    return ex._structural_key(ops, dag, [], {}, keep_list, ex._hoisted_arrays(ops), torch.device("cpu"))


def test_structural_key_folds_in_compute_dtype_and_precision(tmp_path):
    keys = {name: _segment_key(tmp_path, **options) for name, options in {
        "f64": {}, "float64": dict(compute_dtype="float64"), "f32": dict(compute_dtype="float32"),
        "f32-bf16": dict(compute_dtype="float32", matmul_precision="bfloat16"),
        "f32-tf32": dict(compute_dtype="float32", matmul_precision="tensorfloat32"),
    }.items()}
    assert None not in keys.values()
    assert keys["f64"] == keys["float64"]  # the same computation
    assert len({keys[k] for k in ("f64", "f32", "f32-bf16", "f32-tf32")}) == 4


# ---------------------------------------------------------------------------
# matmul_precision: each mode against its exact model
# ---------------------------------------------------------------------------


def _round_bits(x32: np.ndarray, drop: int) -> np.ndarray:
    """float32 *x32* with its low *drop* mantissa bits rounded away, to
    nearest even (numpy bit operations: the model, independent of torch)."""
    bits = x32.astype(np.float32).view(np.uint32).astype(np.uint64)
    half = (1 << (drop - 1)) - 1
    bits = (bits + half + ((bits >> drop) & 1)) & ~np.uint64((1 << drop) - 1)
    return bits.astype(np.uint32).view(np.float32)


def _model(a, b, mode) -> np.ndarray:
    """The exact model of *mode*: float32 operands rounded as the mode says,
    their products summed in float64."""
    a32, b32 = np.asarray(a, dtype=np.float32), np.asarray(b, dtype=np.float32)
    if mode == "tensorfloat32":
        x, y = _round_bits(a32, 13), _round_bits(b32, 13)
    elif mode == "bfloat16":
        x, y = _round_bits(a32, 16), _round_bits(b32, 16)
    elif mode == "bfloat16_3x":
        ah, bh = _round_bits(a32, 16), _round_bits(b32, 16)
        al, bl = _round_bits(a32 - ah, 16), _round_bits(b32 - bh, 16)
        return (ah.astype(np.float64) @ bh + ah.astype(np.float64) @ bl + al.astype(np.float64) @ bh)
    else:
        x, y = a32, b32
    return x.astype(np.float64) @ y.astype(np.float64)


MODES = [None, "default", "float32", "highest", "tensorfloat32", "bfloat16", "bfloat16_3x"]
MODE_IDS = ["none", "default", "float32", "highest", "tf32", "bf16", "bf16_3x"]

AN = np.linspace(0.0, 1.0, 64 * 48, dtype=np.float64).reshape(64, 48) + _an((64, 48), 3) * 1e-3
BN = np.linspace(1.0, 2.0, 48 * 32, dtype=np.float64).reshape(48, 32) - _an((48, 32), 4) * 1e-3


@pytest.mark.parametrize("route, chunks", [("batched", (16, 16)), ("chunked", (64, 48))],
                         ids=["batched", "chunked"])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_each_precision_mode_matches_its_model(tmp_path, mode, route, chunks):
    """The product of a float32 plan at each mode, element by element, equals
    the mode's model at rtol 1e-6 (only the order of float32 sums differs),
    and the total is within 2e-2 of the reference's; on the batched route
    (a grid of blocks under torch.func.vmap, the custom op's batching rule)
    and the chunked one (one block)."""

    def build(pkg, xp, spec):
        a = pkg.from_array(AN, chunks=chunks, spec=spec)
        b = pkg.from_array(BN, chunks=(chunks[1], 16 if route == "batched" else 32), spec=spec)
        return xp.matmul(a, b)

    # the reference's constructor takes "bfloat16_3x", but jax's
    # default_matmul_precision rejects it when the compute starts; its CPU
    # backend ignores the precision anyway, so that mode is held to the
    # reference's full float32
    ref_mode = None if mode == "bfloat16_3x" else mode
    ref, ref_ex, got, ex = _pair(tmp_path, build, compute_dtype="float32", matmul_precision=(mode, ref_mode))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, _model(AN, BN, mode), rtol=1e-6)
    np.testing.assert_allclose(got.sum(), ref.sum(), rtol=2e-2)
    assert {c: ex.stats[c] for c in PATH_COUNTERS} == {c: ref_ex.stats[c] for c in PATH_COUNTERS}
    assert (ex.stats["batched_ops"] > 0) == (route == "batched")


@pytest.mark.parametrize("mode", ["tensorfloat32", "bfloat16", "bfloat16_3x"])
def test_reduced_modes_differ_from_full_float32(mode):
    a, b = torch.from_numpy(AN.astype(np.float32)), torch.from_numpy(BN.astype(np.float32))
    with contraction.precision(mode):
        got = contraction.matmul(a, b)
    full = torch.matmul(a, b)
    assert got.dtype == torch.float32
    assert not torch.equal(got, full)
    np.testing.assert_allclose(got.numpy(), _model(AN, BN, mode), rtol=1e-6)


def test_float64_products_stay_full_precision():
    a, b = torch.from_numpy(AN), torch.from_numpy(BN)
    with contraction.precision("bfloat16"):
        got = contraction.matmul(a, b)
    assert got.dtype == torch.float64 and torch.equal(got, torch.matmul(a, b))


@pytest.mark.parametrize("mode", ["tensorfloat32", "bfloat16", "bfloat16_3x"])
def test_the_batching_rule_equals_the_product_block_by_block(mode):
    """Under torch.func.vmap (and nested vmap, and a shared operand) the
    custom op's rule gives each block's own product."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.random((3, 4, 6, 5)).astype(np.float32))
    b = torch.from_numpy(rng.random((3, 4, 5, 7)).astype(np.float32))
    shared = torch.from_numpy(rng.random((5, 7)).astype(np.float32))
    with contraction.precision(mode):
        nested = torch.func.vmap(torch.func.vmap(contraction.matmul))(a, b)
        one_side = torch.func.vmap(contraction.matmul, in_dims=(0, None))(a[0], shared)
        loop = torch.stack([torch.stack([contraction.matmul(a[i, j], b[i, j]) for j in range(4)])
                            for i in range(3)])
        loop_shared = torch.stack([contraction.matmul(a[0, j], shared) for j in range(4)])
        vector = contraction.matmul(a[0, 0, 0], b[0, 0])
    assert torch.equal(nested, loop) and torch.equal(one_side, loop_shared)
    np.testing.assert_allclose(vector.numpy(), _model(a[0, 0, :1].numpy(), b[0, 0].numpy(), mode)[0], rtol=1e-6)


@pytest.mark.parametrize("mode", ["tensorfloat32", "bfloat16", "bfloat16_3x"])
def test_tensordot_at_each_mode_is_the_matmul_of_its_matrices(mode):
    rng = np.random.default_rng(6)
    a = rng.random((4, 3, 5)).astype(np.float32)
    b = rng.random((5, 4, 6)).astype(np.float32)
    with contraction.precision(mode):
        got = contraction.tensordot(torch.from_numpy(a), torch.from_numpy(b), axes=([0, 2], [1, 0]))
    x = a.transpose(1, 0, 2).reshape(3, 20)
    y = b.transpose(1, 0, 2).reshape(20, 6)
    np.testing.assert_allclose(got.numpy(), _model(x, y, mode), rtol=1e-6)


def test_tf32_rounding_is_to_nearest_even():
    x = np.array([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 1.0 + 2.0**-10 + 2.0**-20, -3.14159, 3.4e38,
                  np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40], dtype=np.float32)
    got = contraction.round_tf32(torch.from_numpy(x)).numpy()
    # ties: 1 + 2**-11 rounds down to 1 (even), 1 + 3 * 2**-11 up to 1 + 2**-9
    assert got[1] == 1.0 and got[2] == np.float32(1.0 + 2.0**-9)
    finite = np.isfinite(x)
    np.testing.assert_array_equal(got[finite], _round_bits(x, 13)[finite])
    assert np.isinf(got[6]) and np.isinf(got[7]) and np.isnan(got[8])
    assert (got[finite & (x != 0)].view(np.uint32) & 0x1FFF == 0).all()


def test_no_process_global_matmul_switch_changes(tmp_path):
    """The precision lives in a context-local scope: torch's process-global
    switches read the same before, during and after a compute."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
              torch.backends.cudnn.allow_tf32)
    during = []

    def probe(x):
        if x.device.type == "meta":
            return x
        during.append((torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
                       torch.backends.cudnn.allow_tf32, contraction.current()))
        return x

    a = cubed_tpu_torch.from_array(AN, chunks=(16, 16), spec=_spec(tmp_path))
    x = cubed_tpu_torch.map_blocks(probe, pxp.matmul(a, pxp.matrix_transpose(a)), dtype=np.float64)
    x.compute(executor=CudaExecutor(compute_dtype="float32", matmul_precision="tensorfloat32"))
    after = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    assert before == after
    assert during and all(d == before + ("tensorfloat32",) for d in during)


# ---------------------------------------------------------------------------
# the float32 Philox plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, seed", [(1, 0), (7, 3), (1000, 2**30 + 5)])
def test_f32_philox_plain_is_the_rounded_float64_stream(n, seed):
    key = philox_key(seed)
    f64 = np.random.Generator(np.random.Philox(seed=seed)).random(n)
    got = philox_uniform_plain(n, key, dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), f64.astype(np.float32))
    out = philox_uniform(torch.empty(n, dtype=torch.float32), key)
    np.testing.assert_array_equal(out.numpy(), f64.astype(np.float32))


@pytest.mark.parametrize("shape, chunks", [((13, 11), (4, 5)), ((8, 14), (4, 8)), ((2, 3, 4, 5), (1, 2, 3, 4))])
def test_f32_philox_blocks_plain_and_custom_op(shape, chunks):
    nblocks = int(np.prod([-(-s // c) for s, c in zip(shape, chunks)]))
    seeds = 2**30 - 2 + np.arange(nblocks, dtype=np.int64)
    keys = philox_keys(seeds)
    f64 = philox_uniform_blocks_plain(shape, chunks, keys)
    f32 = philox_uniform_blocks_plain(shape, chunks, keys, dtype=torch.float32)
    assert f32.dtype == torch.float32
    np.testing.assert_array_equal(f32.numpy(), f64.numpy().astype(np.float32))
    out = philox_uniform_blocks(torch.empty(shape, dtype=torch.float32), chunks, keys)
    assert torch.equal(out, f32)
    like = torch.zeros((), dtype=torch.float32).expand(chunks)
    got = philox_blocks(like, torch.from_numpy(seeds[:3].reshape((3,) + (1,) * len(chunks))))
    assert got.dtype == torch.float32 and got.shape == (3,) + tuple(chunks)
    for i in range(3):
        ref = np.random.Generator(np.random.Philox(seed=int(seeds[i]))).random(chunks)
        np.testing.assert_array_equal(got[i].numpy(), ref.astype(np.float32))


def test_philox_wrappers_refuse_other_dtypes():
    with pytest.raises(ValueError, match="float64 or float32"):
        philox_uniform(torch.empty(4, dtype=torch.float16), philox_key(1))
    with pytest.raises(ValueError, match="float64 or float32"):
        philox_uniform_blocks(torch.empty(4, dtype=torch.bfloat16), (2,), philox_keys([1, 2]))


# ---------------------------------------------------------------------------
# an alias counts once against device_mem (ROADMAP Queue 3, item 1)
# ---------------------------------------------------------------------------


def test_an_alias_adds_no_bytes_to_residency(tmp_path):
    ex = CudaExecutor()
    resident = {}
    value = torch.zeros((10, 10), dtype=torch.float64)
    a = _target(_spec(tmp_path), (10, 10))
    ex._admit(resident, "src", value, a, budget=10_000)
    ex._admit(resident, "alias", value, a, budget=10_000)
    ex._admit(resident, "view", value[1:], a, budget=10_000)
    assert _held(resident.values()) == 800
    # a budget of one copy: admitting the alias spills nothing
    ex._admit(resident, "alias2", value, a, budget=800)
    assert set(resident) == {"src", "alias", "view", "alias2"}


def test_a_storage_spills_only_with_its_last_name(tmp_path):
    """Spilling frees a storage by writing and dropping every name that holds
    it, never one name while another still holds it."""
    ex = CudaExecutor()
    resident = {}
    spec = _spec(tmp_path)
    targets = [_target(spec, (10, 10)) for _ in range(3)]
    old = torch.from_numpy(_an((10, 10), 7))
    ex._admit(resident, "old", old, targets[0], budget=1600)
    ex._admit(resident, "old-alias", old, targets[1], budget=1600)
    ex._admit(resident, "new", torch.from_numpy(_an((10, 10), 8)), targets[2], budget=1600)
    assert set(resident) == {"old", "old-alias", "new"}
    ex._admit(resident, "newer", torch.from_numpy(_an((10, 10), 9)), targets[2], budget=1600)
    # the old storage (least recently used) spilled with both its names
    assert set(resident) == {"new", "newer"}
    for t in targets[:2]:
        np.testing.assert_array_equal(t.open()[...], old.numpy())


def test_a_rechunk_segment_passes_the_pre_check_with_its_aliases(tmp_path):
    """A three-stage rechunk of an array of more than a third of device_mem:
    counting each alias as an array would need four times the array, so
    the segment would fail its pre-check and residency would spill; counted
    by storage it fits, spills nothing, and keeps the reference's values and
    path counters."""

    def build(pkg, xp, spec):
        a = pkg.random.random((40, 36, 32), chunks=8, spec=spec)  # 368,640 B
        return xp.mean(a.rechunk((40, 6, 4)), axis=0)

    device_mem = 1_000_000
    random.seed(7)
    x = build(cubed_tpu_torch, pxp, cubed_tpu_torch.Spec(work_dir=str(tmp_path / "plan"), allowed_mem=241_000))
    dag = x.plan._finalize(array_names=(x.name,)).dag
    ex = CudaExecutor(device_mem=device_mem)
    ops = [(n, d) for n, d in visit_nodes(dag) if ex._classify(d["primitive_op"]) == "segment"]
    assert sum(d.get("op_name") == "rechunk" for _, d in ops) == 3
    assert 3 * 40 * 36 * 32 * 8 > device_mem
    assert ex._segment_fits(ops, {}, device_mem)

    ref, ref_ex, got, ex = _pair(tmp_path, build, allowed_mem=241_000, device_mem=device_mem)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert ex.stats["rechunk_alias"] == 3
    assert {c: ex.stats[c] for c in PATH_COUNTERS} == {c: ref_ex.stats[c] for c in PATH_COUNTERS}
    stored = [root for root, _, files in os.walk(tmp_path / "port")
              if root.endswith(".zarr") and any(f != ".zarray" for f in files)]
    assert len(stored) == 1  # the output's store alone: nothing spilled
