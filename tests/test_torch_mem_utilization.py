"""The port's plan-time memory bound against the JAX package's, on the CPU:
the counterpart of tests/test_mem_utilization.py. For each op, the port's
``max_projected_mem`` must equal the JAX package's on the same plan, and the
plan must then run to completion under ``allowed_mem`` equal to that value
with ``reserved_mem=0`` (the bound is enough for the plan to be built and
computed). Values are compared with numpy exactly (the inputs are ones, so
every sum is exact).

The ops are those of tests/test_mem_utilization.py's ``OPS`` that the port
has (``sort_axis``, ``qr_q``, ``svdvals`` and ``fft_abs`` wait for their
modules), and flip, roll, var, cumulative_sum, argmax and where. The card's
counterpart, each task's device peak against the projected bound at 10000 x
10000 float64, is chip_smoke.py's Array API phase.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402

OPS = {
    "add": lambda xp, a, b: xp.add(a, b),
    "multiply": lambda xp, a, b: xp.multiply(a, b),
    "negative": lambda xp, a, b: xp.negative(a),
    "astype": lambda xp, a, b: xp.astype(a, np.float32),
    "sum": lambda xp, a, b: xp.sum(a, axis=0),
    "mean": lambda xp, a, b: xp.mean(a, axis=0),
    "max": lambda xp, a, b: xp.max(a, axis=1),
    "matmul": lambda xp, a, b: xp.matmul(a, b),
    "transpose": lambda xp, a, b: xp.permute_dims(a, (1, 0)),
    "index_slice": lambda xp, a, b: a[1:, :],
    "concat": lambda xp, a, b: xp.concat([a, b], axis=0),
    "stack": lambda xp, a, b: xp.stack([a, b], axis=0),
    "reshape": lambda xp, a, b: xp.reshape(a, (a.shape[0] * a.shape[1],)),
    "flip": lambda xp, a, b: xp.flip(a, axis=0),
    "roll": lambda xp, a, b: xp.roll(a, 37, axis=1),
    "var": lambda xp, a, b: xp.var(a, axis=0),
    "cumulative_sum": lambda xp, a, b: xp.cumulative_sum(a, axis=1),
    "argmax": lambda xp, a, b: xp.argmax(a, axis=0),
    "where": lambda xp, a, b: xp.where(xp.greater(a, 0.5), a, b),
}

SHAPE, CHUNKS = (500, 500), (100, 100)


def _expected(name, an):
    return OPS[name](_NumpyNamespace, an, an)


class _NumpyNamespace:
    """numpy under the names OPS calls."""

    add, multiply, negative, matmul, where, greater = np.add, np.multiply, np.negative, np.matmul, np.where, np.greater
    reshape, flip, roll, var, stack = np.reshape, np.flip, np.roll, np.var, np.stack

    @staticmethod
    def astype(a, dtype):
        return a.astype(dtype)

    @staticmethod
    def sum(a, axis):
        return np.sum(a, axis=axis)

    @staticmethod
    def mean(a, axis):
        return np.mean(a, axis=axis)

    @staticmethod
    def max(a, axis):
        return np.max(a, axis=axis)

    @staticmethod
    def permute_dims(a, axes):
        return np.transpose(a, axes)

    @staticmethod
    def concat(arrays, axis):
        return np.concatenate(arrays, axis=axis)

    @staticmethod
    def cumulative_sum(a, axis):
        return np.cumsum(a, axis=axis)

    @staticmethod
    def argmax(a, axis):
        return np.argmax(a, axis=axis)


def _build(pkg, xp, name, spec):
    an = np.ones(SHAPE)
    a = pkg.from_array(an, chunks=CHUNKS, spec=spec)
    b = pkg.from_array(an, chunks=CHUNKS, spec=spec)
    return OPS[name](xp, a, b)


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_within_projected_mem(tmp_path, name):
    ref_probe = _build(cubed_tpu, rxp, name, cubed_tpu.Spec(work_dir=str(tmp_path / "r"), allowed_mem="1GB",
                                                            reserved_mem=0))
    probe = _build(cubed_tpu_torch, pxp, name, cubed_tpu_torch.Spec(work_dir=str(tmp_path / "p"),
                                                                   allowed_mem="1GB", reserved_mem=0))
    projected = probe.plan.max_projected_mem()
    assert projected == ref_probe.plan.max_projected_mem() > 0
    tight = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "t"), allowed_mem=projected, reserved_mem=0)
    out = _build(cubed_tpu_torch, pxp, name, tight).compute()
    expected = _expected(name, np.ones(SHAPE))
    assert out.dtype == expected.dtype and out.shape == expected.shape
    np.testing.assert_array_equal(out, expected)


def test_op_below_projected_mem_is_refused_at_plan_time(tmp_path):
    probe = _build(cubed_tpu_torch, pxp, "concat", cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="1GB",
                                                                       reserved_mem=0))
    projected = probe.plan.max_projected_mem()
    with pytest.raises(ValueError):
        _build(cubed_tpu_torch, pxp, "concat",
               cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem=projected - 1, reserved_mem=0))


def test_elemwise_projected_formula(tmp_path):
    # projected for a binary elemwise must cover 2 inputs + 1 output, doubled
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="1GB", reserved_mem=0)
    a = pxp.ones((100, 100), chunks=(50, 50), spec=spec)
    b = pxp.ones((100, 100), chunks=(50, 50), spec=spec)
    c = pxp.add(a, b)
    chunk_bytes = 50 * 50 * 8
    assert c.plan.max_projected_mem(optimize_graph=False) >= 6 * chunk_bytes
