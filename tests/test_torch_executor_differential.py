"""Differential fuzzing of the port's executors: random plans computed on
``CudaExecutor`` (chunks on the CPU) must match the port's
``PythonDagExecutor`` at rtol 1e-12, and both must match the JAX package's
sequential executor on the same plan built there, at rtol 1e-12 and an atol
of 1e-12 times the inputs' largest magnitude and their count (the scans and
reductions add in another order, so a result near zero keeps the rounding
of its larger terms).

The port's counterparts of ``test_random_plans_match_oracle`` and, for the
families ported so far (matmul, tensordot, var, std, an integer-array index,
take_along_axis, count_nonzero), ``test_random_linalg_and_stats_match_oracle``
(tests/conformance/test_executor_differential.py). Hypothesis first draws a
*recipe* (every op and its parameters), with a numpy shadow tracking the
shapes; the recipe is then built in both packages, so no draw repeats
between builds. The example counts are set here: this file sits outside
tests/conformance/'s hypothesis profile.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from hypothesis.extra import numpy as hnp  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor  # noqa: E402

RTOL = ATOL = 1e-12
FUZZ = settings(max_examples=20, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture,
                                                                       HealthCheck.too_slow])

_FLOATS = st.floats(min_value=-1e3, max_value=1e3, allow_nan=False, allow_infinity=False,
                    allow_subnormal=False, width=64)


def _np_unary(step, a):
    op = step[0]
    if op == "negative":
        return -a
    if op == "abs":
        return np.abs(a)
    if op == "multiply":
        return a * step[1]
    if op == "add":
        return a + step[1]
    if op == "transpose":
        return a.T
    if op == "flip":
        return np.flip(a, step[1])
    if op == "slice":
        return a[step[1]:]
    if op == "reshape_flat":
        return a.reshape(-1)
    if op == "cumsum":
        return np.cumsum(a, axis=step[1])
    if op == "diff":
        return np.diff(a, axis=step[1])
    if op == "tile":
        return np.tile(a, step[1])
    if op == "roll":
        return np.roll(a, step[1], axis=step[2])
    return a  # rechunk, none


def _unary(draw, a):
    """One unary step for an array shaped like *a* (the numpy shadow)."""
    op = draw(st.sampled_from(["negative", "abs", "multiply", "add", "transpose", "flip", "slice", "rechunk",
                               "reshape_flat", "cumsum", "diff", "tile", "roll"]))
    if op == "multiply":
        return (op, draw(st.sampled_from([2.0, -0.5, 3.0])))
    if op == "add":
        return (op, draw(st.sampled_from([1.0, -2.0])))
    if op in ("flip", "cumsum"):
        return (op, draw(st.integers(0, a.ndim - 1)))
    if op == "diff":
        ax = draw(st.integers(0, a.ndim - 1))
        return (op, ax) if a.shape[ax] >= 2 else ("none",)
    if op == "slice":
        return (op, draw(st.integers(0, a.shape[0] - 2))) if a.shape[0] >= 2 else ("none",)
    if op == "rechunk":
        return (op, tuple(draw(st.sampled_from([1, 2, 3])) for _ in a.shape))
    if op == "tile":
        return (op, tuple(draw(st.integers(1, 2)) for _ in a.shape))
    if op == "roll":
        return (op, draw(st.integers(-5, 5)), draw(st.integers(0, a.ndim - 1)))
    if op == "transpose" and a.ndim < 2:
        return ("none",)
    return (op,)


def _apply_unary(step, xp, a):
    op = step[0]
    if op == "negative":
        return xp.negative(a)
    if op == "abs":
        return xp.abs(a)
    if op == "multiply":
        return xp.multiply(a, step[1])
    if op == "add":
        return xp.add(a, step[1])
    if op == "transpose":
        return xp.permute_dims(a, tuple(reversed(range(a.ndim))))
    if op == "flip":
        return xp.flip(a, axis=step[1])
    if op == "slice":
        return a[step[1]:]
    if op == "rechunk":
        return a.rechunk(tuple(max(1, s // d) for s, d in zip(a.shape, step[1])))
    if op == "reshape_flat":
        return xp.reshape(a, (a.size,))
    if op == "cumsum":
        return xp.cumulative_sum(a, axis=step[1])
    if op == "diff":
        return xp.diff(a, axis=step[1])
    if op == "tile":
        return xp.tile(a, step[1])
    if op == "roll":
        return xp.roll(a, step[1], axis=step[2])
    return a


@st.composite
def recipes(draw):
    shape = draw(st.sampled_from([(6, 8), (9, 4), (5, 5, 4), (12,)]))
    an = draw(hnp.arrays(np.float64, shape, elements=_FLOATS))
    bn = draw(hnp.arrays(np.float64, shape, elements=_FLOATS))
    x = _np_unary(u1 := _unary(draw, np.zeros(shape)), np.zeros(shape))
    b_step = binary = None
    if x.shape == shape:
        b_step = _unary(draw, np.zeros(shape))
        y = _np_unary(b_step, np.zeros(shape))
        if y.shape != x.shape:
            y = np.zeros(x.shape)
        binary = draw(st.sampled_from(["add", "multiply", "subtract", "concat", "stack"]))
        if binary == "concat":
            binary = ("concat", draw(st.integers(0, x.ndim - 1)))
            x = np.concatenate([x, y], axis=binary[1])
        elif binary == "stack":
            x = np.stack([x, y])
    u2 = _unary(draw, x)
    x = _np_unary(u2, x)
    reduce = (draw(st.sampled_from(["sum", "mean", "max", "var", "argmax", "none"])),
              draw(st.one_of(st.none(), st.integers(0, x.ndim - 1))))
    return an, bn, u1, b_step, binary, u2, reduce


def _build(recipe, pkg, xp, spec):
    an, bn, u1, b_step, binary, u2, (red, axis) = recipe
    chunks = tuple(max(1, (s + 1) // 2) for s in an.shape)
    a = pkg.from_array(an, chunks=chunks, spec=spec)
    b = pkg.from_array(bn, chunks=chunks, spec=spec)
    x = _apply_unary(u1, xp, a)
    if binary is not None:
        y = _apply_unary(b_step, xp, b)
        if x.shape != y.shape:
            y = xp.zeros(x.shape, chunks=x.chunksize, spec=x.spec)
        if isinstance(binary, tuple):
            x = xp.concat([x, y], axis=binary[1])
        elif binary == "stack":
            x = xp.stack([x, y], axis=0)
        else:
            x = getattr(xp, binary)(x, y)
    x = _apply_unary(u2, xp, x)
    if red == "none":
        return x
    return getattr(xp, red)(x, axis=axis)


def _check(tmp_path, recipe, build=_build):
    ref_spec = cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB")
    port_spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB")
    ref = np.asarray(build(recipe, cubed_tpu, rxp, ref_spec).compute())
    expr = build(recipe, cubed_tpu_torch, pxp, port_spec)  # one plan for both executors
    oracle = expr.compute(executor=PythonDagExecutor())
    ex = CudaExecutor()
    device = expr.compute(executor=ex)
    # sums in another order differ by rounding of their terms, which the
    # inputs' scale and count bound
    an, bn = recipe[:2]
    atol = ATOL * max(1.0, np.abs(an).max(), np.abs(bn).max()) * an.size
    np.testing.assert_allclose(device, oracle, rtol=RTOL, atol=atol)
    assert device.dtype == oracle.dtype == ref.dtype and device.shape == oracle.shape == ref.shape
    np.testing.assert_allclose(oracle, ref, rtol=RTOL, atol=atol)
    for counter in ("whole_array_errors", "whole_select_errors"):
        assert ex.stats[counter] == 0


@FUZZ
@given(recipe=recipes())
def test_random_plans_match_oracle(tmp_path_factory, recipe):
    _check(tmp_path_factory.mktemp("plan"), recipe)


@st.composite
def linalg_and_stats_recipes(draw):
    m, k, n = (draw(st.integers(2, 6)) for _ in range(3))
    an = draw(hnp.arrays(np.float64, (m, k), elements=_FLOATS))
    bn = draw(hnp.arrays(np.float64, (k, n), elements=_FLOATS))
    kind = draw(st.sampled_from(["matmul", "tensordot", "var", "std", "index", "take_along_axis",
                                 "count_nonzero", "argmin"]))
    params = None
    if kind in ("var", "std", "count_nonzero", "argmin"):
        params = draw(st.one_of(st.none(), st.integers(0, 1)))
    elif kind == "index":
        params = sorted(draw(st.lists(st.integers(0, m - 1), min_size=1, max_size=m, unique=True)))
    elif kind == "take_along_axis":
        ax = draw(st.integers(0, 1))
        nax = (m, k)[ax]
        params = (ax, draw(hnp.arrays(np.int64, (m, k), elements=st.integers(-nax, nax - 1))))
    return an, bn, kind, params


def _build_linalg(recipe, pkg, xp, spec):
    an, bn, kind, params = recipe
    (m, k), n = an.shape, bn.shape[1]
    a = pkg.from_array(an, chunks=(max(1, m // 2), max(1, k // 2)), spec=spec)
    b = pkg.from_array(bn, chunks=(max(1, k // 2), max(1, n // 2)), spec=spec)
    if kind == "matmul":
        return xp.matmul(a, b)
    if kind == "tensordot":
        return xp.tensordot(a, b, axes=1)
    if kind in ("var", "std", "argmin"):
        return getattr(xp, kind)(a, axis=params)
    if kind == "count_nonzero":
        return xp.count_nonzero(xp.greater(a, 0.5), axis=params)
    if kind == "index":
        return a[params, :]
    ax, idx = params
    return xp.take_along_axis(a, pkg.from_array(idx, chunks=(max(1, m // 2), max(1, k // 2)), spec=spec), axis=ax)


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(recipe=linalg_and_stats_recipes())
def test_random_linalg_and_stats_match_oracle(tmp_path_factory, recipe):
    _check(tmp_path_factory.mktemp("linalg"), recipe, _build_linalg)
