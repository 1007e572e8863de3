"""Per-request and per-tenant cost accounting: the tracker's fold, the
tenant_cost_* series, the COST panel; one request's cost held against the
JAX package's. Counterpart of tests/service/test_cost.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import time

import numpy as np
import pytest

import cubed_tpu_torch as ct
from cubed_tpu_torch import top
from cubed_tpu_torch.observability.export import prometheus_text
from cubed_tpu_torch.observability.timeseries import (
    TelemetrySampler,
    TimeSeriesStore,
)
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor
from cubed_tpu_torch.service import ComputeService
from ._torch_chaos import clean_process  # noqa: E402,F401

AN = np.arange(64, dtype=np.float64).reshape(8, 8)


@pytest.fixture
def spec(tmp_path):
    return ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")


def _build(spec, k):
    def kernel(x, _k=float(k)):
        return x + _k

    a = ct.from_array(AN, chunks=(4, 4), spec=spec)
    return ct.map_blocks(kernel, a, dtype=np.float64)


def _sleepy_build(spec, k, delay=0.05):
    def kernel(x, _k=float(k), _d=delay):
        time.sleep(_d)
        return x + _k

    a = ct.from_array(AN, chunks=(4, 4), spec=spec)
    return ct.map_blocks(kernel, a, dtype=np.float64)


def test_request_and_tenant_cost_fold(spec):
    with ComputeService(
        executor=AsyncPythonDagExecutor(), tenants={"gold": 2.0},
        plan_cache=False, result_cache=False,
    ) as svc:
        h = svc.submit(_sleepy_build(spec, 1.0), tenant="gold")
        np.testing.assert_array_equal(h.result(120), AN + 1.0)
        cost = h.cost
        assert cost is not None
        # 4 chunks x 50ms sleep, measured where the tasks ran
        assert cost["task_seconds"] >= 4 * 0.05 * 0.8
        assert cost["bytes_written"] >= AN.nbytes
        assert cost["retries"] == 0
        row = svc.stats_snapshot()["tenants"]["gold"]["cost"]
        assert row["task_seconds"] == pytest.approx(
            cost["task_seconds"], abs=1e-6
        )
        assert row["bytes_written"] == cost["bytes_written"]


def test_cost_accumulates_per_tenant_and_isolates(spec):
    with ComputeService(
        executor=AsyncPythonDagExecutor(),
        tenants={"gold": 2.0, "free": 1.0},
        plan_cache=False, result_cache=False,
    ) as svc:
        for i in range(2):
            h = svc.submit(_build(spec, float(i)), tenant="gold")
            np.testing.assert_array_equal(h.result(120), AN + float(i))
        snap = svc.stats_snapshot()["tenants"]
        assert snap["gold"]["cost"]["task_seconds"] > 0
        assert snap["gold"]["cost"]["bytes_written"] >= 2 * AN.nbytes
        # the free tenant never ran anything: zero cost
        assert snap["free"]["cost"]["task_seconds"] == 0
        assert snap["free"]["cost"]["bytes_written"] == 0


def test_result_cache_hit_costs_nothing(spec):
    with ComputeService(
        executor=AsyncPythonDagExecutor(), tenants={"gold": 2.0},
    ) as svc:
        arr = _build(spec, 7.0)
        h1 = svc.submit(arr, tenant="gold")
        np.testing.assert_array_equal(h1.result(120), AN + 7.0)
        spent = svc.stats_snapshot()["tenants"]["gold"]["cost"]
        h2 = svc.submit(_build(spec, 7.0), tenant="gold")
        np.testing.assert_array_equal(h2.result(120), AN + 7.0)
        assert h2.result_cache_hit
        assert h2.cost is None  # a cached answer consumed ~nothing
        after = svc.stats_snapshot()["tenants"]["gold"]["cost"]
        assert after == spent  # the tenant's bill did not move


def test_failed_request_still_folds_cost(spec):
    def boom(x):
        raise ValueError("kernel exploded")

    a = ct.from_array(AN, chunks=(4, 4), spec=spec)
    bad = ct.map_blocks(boom, a, dtype=np.float64)
    with ComputeService(
        executor=AsyncPythonDagExecutor(retries=0),
        tenants={"gold": 2.0}, plan_cache=False, result_cache=False,
    ) as svc:
        h = svc.submit(bad, tenant="gold")
        with pytest.raises(ValueError):
            h.result(120)
        # the fleet's time was spent either way: the fold happened
        assert h.cost is not None
        row = svc.stats_snapshot()["tenants"]["gold"]["cost"]
        assert row is not None


def test_sampler_records_tenant_cost_series_and_metrics(spec):
    with ComputeService(
        executor=AsyncPythonDagExecutor(), tenants={"gold": 2.0},
        plan_cache=False, result_cache=False,
    ) as svc:
        h = svc.submit(_sleepy_build(spec, 1.0), tenant="gold")
        np.testing.assert_array_equal(h.result(120), AN + 1.0)
        store = TimeSeriesStore()
        TelemetrySampler(store).sample_once()
        labels = {"tenant": "gold"}
        secs = store.latest("tenant_cost_task_seconds", labels=labels)
        assert secs is not None and secs > 0
        assert store.latest(
            "tenant_cost_bytes_written", labels=labels
        ) >= AN.nbytes
        assert store.latest("tenant_cost_retries", labels=labels) == 0
        text = prometheus_text(store=store)
        assert (
            'cubed_tpu_torch_tenant_cost_task_seconds{tenant="gold"}' in text
        )
        assert (
            'cubed_tpu_torch_tenant_cost_bytes_written{tenant="gold"}' in text
        )


def test_top_cost_panel_renders(spec):
    with ComputeService(
        executor=AsyncPythonDagExecutor(), tenants={"gold": 2.0},
        plan_cache=False, result_cache=False,
    ) as svc:
        h = svc.submit(_build(spec, 1.0), tenant="gold")
        np.testing.assert_array_equal(h.result(120), AN + 1.0)
        frame = top.render({
            "ts": time.time(), "fleet": {}, "metrics": {},
            "service": svc.stats_snapshot(), "computes": [], "alerts": [],
        })
    assert "COST" in frame
    assert "TASK-SEC" in frame
    assert "gold" in frame


@pytest.fixture(scope="module", autouse=True)
def _clean_process(clean_process):
    yield


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------


def test_request_cost_matches_the_jax_package(tmp_path):
    """One request of the same plan in both packages costs the same tasks,
    store bytes read and written, retries and peer bytes (the task seconds
    are measured, so only their sign is compared)."""
    import cubed_tpu
    import cubed_tpu.service as ref_service

    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    costs = []
    for pkg, svc_cls in ((ct, ComputeService), (cubed_tpu, ref_service.ComputeService)):
        spec = pkg.Spec(work_dir=str(tmp_path / pkg.__name__), allowed_mem="500MB")
        arr = pkg.map_blocks(lambda x: x * 3.0, pkg.from_array(an, chunks=(2, 4), spec=spec), dtype=np.float64)
        with svc_cls(max_concurrent=1, plan_cache=False, result_cache=False) as svc:
            h = svc.submit(arr, tenant="t")
            np.testing.assert_array_equal(h.result(60), an * 3.0)
            cost = dict(h.cost)
        assert cost.pop("task_seconds") > 0
        costs.append(cost)
    assert costs[0] == costs[1]
