"""The port's plan-time memory bound against the JAX package's, on the CPU:
the counterpart of tests/test_mem_utilization.py. For each op, the port's
``max_projected_mem`` must equal the JAX package's on the same plan, and the
plan must then run to completion under ``allowed_mem`` equal to that value
with ``reserved_mem=0`` (the bound is enough for the plan to be built and
computed). Values are compared with numpy exactly (the inputs are ones, so
every sum is exact).

The ops are those of tests/test_mem_utilization.py's ``OPS`` that the port
has (``qr_q``, ``svdvals`` and ``fft_abs`` wait for their modules), and
flip, roll, var, cumulative_sum, argmax and where; then ``ORDER_OPS``: the
sorts (``sort_axis`` among them; the network forced in both packages where
the name says so), quantiles, top-k, searchsorted, histogram, cov,
corrcoef and the nan reductions, on seeded random data (floats rtol
1e-12; cov and corrcoef, whose sums cancel, atol 1e-12). The card's counterpart, each task's device peak against the
projected bound, is chip_smoke.py's Array API and order-statistics phases.
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


# the order statistics: each computed under allowed_mem equal to its
# projected memory (equal to the reference's), on seeded random data (the
# network forced where the name says so, in both packages)
def _forced(build):
    def run(xp, a, b):
        before = {k: os.environ.get(k) for k in ("CUBED_TPU_SORT_NETWORK", "CUBED_TPU_TORCH_SORT_NETWORK")}
        os.environ.update(dict.fromkeys(before, "force"))
        try:
            return build(xp, a, b)
        finally:
            for k, v in before.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v

    return run


def _pkg(xp):
    return cubed_tpu if xp is rxp else cubed_tpu_torch


ORDER_OPS = {
    "sort_axis": (lambda xp, a, b: xp.sort(a, axis=1), lambda a, b: np.sort(a, axis=1)),
    "sort_network": (_forced(lambda xp, a, b: xp.sort(a, axis=0)), lambda a, b: np.sort(a, axis=0)),
    "argsort_network": (_forced(lambda xp, a, b: xp.argsort(a, axis=1)),
                        lambda a, b: np.argsort(a, axis=1, kind="stable")),
    "argsort": (lambda xp, a, b: xp.argsort(a, axis=0), lambda a, b: np.argsort(a, axis=0, kind="stable")),
    "median": (lambda xp, a, b: xp.median(a, axis=0), lambda a, b: np.median(a, axis=0)),
    "quantile_network": (_forced(lambda xp, a, b: xp.quantile(a, 0.9, axis=1)),
                         lambda a, b: np.quantile(a, 0.9, axis=1)),
    "nanmedian": (lambda xp, a, b: xp.nanmedian(xp.where(xp.greater(a, 0.9), b * np.nan, a), axis=0),
                  lambda a, b: np.nanmedian(np.where(a > 0.9, np.nan, a), axis=0)),
    "topk": (lambda xp, a, b: xp.topk(a, 5, axis=0), lambda a, b: -np.sort(-a, axis=0)[:5]),
    "argtopk": (lambda xp, a, b: xp.argtopk(a, -5, axis=1), lambda a, b: np.argsort(a, axis=1, kind="stable")[:, :5]),
    "searchsorted": (lambda xp, a, b: xp.searchsorted(xp.sort(xp.reshape(a, (SHAPE[0] * SHAPE[1],))), b),
                     lambda a, b: np.searchsorted(np.sort(a.reshape(-1)), b)),
    "histogram": (lambda xp, a, b: xp.histogram(a, bins=16)[0], lambda a, b: np.histogram(a, bins=16)[0]),
    "cov": (lambda xp, a, b: xp.cov(a), lambda a, b: np.cov(a)),
    "corrcoef": (lambda xp, a, b: xp.corrcoef(a), lambda a, b: np.corrcoef(a)),
    "nanmean": (lambda xp, a, b: _pkg(xp).nanmean(a, axis=0), lambda a, b: np.nanmean(a, axis=0)),
    "nansum": (lambda xp, a, b: _pkg(xp).nansum(a, axis=1), lambda a, b: np.nansum(a, axis=1)),
    "nanmax": (lambda xp, a, b: _pkg(xp).nanmax(a, axis=0), lambda a, b: np.nanmax(a, axis=0)),
    "nanmin": (lambda xp, a, b: _pkg(xp).nanmin(a), lambda a, b: np.nanmin(a)),
}


def _order_build(pkg, xp, name, spec, an, bn):
    a = pkg.from_array(an, chunks=CHUNKS, spec=spec)
    b = pkg.from_array(bn, chunks=CHUNKS, spec=spec)
    return ORDER_OPS[name][0](xp, a, b)


@pytest.mark.parametrize("name", sorted(ORDER_OPS))
def test_order_statistic_within_projected_mem(tmp_path, name):
    rng = np.random.default_rng(0)
    an, bn = rng.random(SHAPE), rng.random(SHAPE)
    ref_probe = _order_build(cubed_tpu, rxp, name, cubed_tpu.Spec(work_dir=str(tmp_path / "r"), allowed_mem="1GB",
                                                                  reserved_mem=0), an, bn)
    probe = _order_build(cubed_tpu_torch, pxp, name, cubed_tpu_torch.Spec(work_dir=str(tmp_path / "p"),
                                                                         allowed_mem="1GB", reserved_mem=0), an, bn)
    projected = probe.plan.max_projected_mem()
    assert projected == ref_probe.plan.max_projected_mem() > 0
    tight = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "t"), allowed_mem=projected, reserved_mem=0)
    out = _order_build(cubed_tpu_torch, pxp, name, tight, an, bn).compute()
    expected = ORDER_OPS[name][1](an, bn)
    assert out.dtype == expected.dtype and out.shape == expected.shape
    if name in ("cov", "corrcoef"):
        # sums of products that cancel: numpy adds them in another order
        np.testing.assert_allclose(out, expected, rtol=0, atol=1e-12)
    elif expected.dtype.kind == "f":
        np.testing.assert_allclose(out, expected, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(out, expected)
