"""The port's ComputeService: submission lifecycle, fair-share
interleaving across tenants, flood isolation, throttling, cancellation,
durable request records, in-process recovery, config and env resolution,
and per-tenant stats; and three tenants' values, plans and rows held
against the JAX package's service. Counterpart of
tests/service/test_service.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import time

import numpy as np
import pytest

import cubed_tpu_torch as ct
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.service import (
    ComputeService,
    RequestCancelledError,
    ServiceConfig,
    TenantThrottledError,
)
from cubed_tpu_torch.service.durability import load_requests
from ._torch_chaos import clean_process  # noqa: E402,F401


@pytest.fixture()
def spec(tmp_path):
    return ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")


AN = np.arange(16, dtype=np.float64).reshape(4, 4)


def _build(spec, k=1.0, delay=0.0, chunks=(2, 2)):
    def kernel(x, _k=k, _d=delay):
        if _d:
            time.sleep(_d)
        return x + _k

    a = ct.from_array(AN, chunks=chunks, spec=spec)
    return ct.map_blocks(kernel, a, dtype=np.float64)


# ----------------------------------------------------------------------
# lifecycle basics
# ----------------------------------------------------------------------


def test_submit_result_status_roundtrip(spec):
    with ComputeService(max_concurrent=2) as svc:
        h = svc.submit(_build(spec, k=7.0), tenant="t1")
        value = h.result(timeout=60)
        np.testing.assert_array_equal(value, AN + 7.0)
        assert h.status() == "done"
        assert h.done()
        assert h.tenant == "t1"
        assert h.compute_id  # joined to traces/logs/journals
        row = svc.stats_snapshot()["tenants"]["t1"]
        assert row["accepted"] == 1 and row["completed"] == 1


def test_failure_surfaces_through_the_handle(spec):
    def boom(x):
        raise ValueError("kernel exploded")

    a = ct.from_array(AN, chunks=(2, 2), spec=spec)
    bad = ct.map_blocks(boom, a, dtype=np.float64)
    with ComputeService(max_concurrent=1) as svc:
        h = svc.submit(bad, tenant="t1")
        with pytest.raises(ValueError, match="kernel exploded"):
            h.result(timeout=60)
        assert h.status() == "failed"
        assert svc.stats_snapshot()["tenants"]["t1"]["failed"] == 1


def test_cancel_queued_request(spec):
    with ComputeService(max_concurrent=1) as svc:
        h1 = svc.submit(_build(spec, delay=0.2), tenant="t1")
        h2 = svc.submit(_build(spec, k=2.0, delay=0.2), tenant="t1")
        # h2 is behind h1 on a 1-slot service: cancellable while queued
        assert h2.cancel() or h2.done()
        if h2.status() == "cancelled":
            with pytest.raises(RequestCancelledError):
                h2.result(timeout=5)
        np.testing.assert_array_equal(h1.result(60), AN + 1.0)
        assert not h1.cancel()  # finished requests don't cancel


def test_tenant_throttle_bound(spec):
    reg = get_registry()
    before = reg.snapshot()
    with ComputeService(
        max_concurrent=1, max_queued_per_tenant=2, plan_cache=False,
        result_cache=False,
    ) as svc:
        accepted = []
        # built before the flood: the port traces a block function once at
        # plan time (its batchable hint), which would sleep here
        arrays = [_build(spec, k=float(i), delay=0.3) for i in range(20)]
        with pytest.raises(TenantThrottledError):
            # a flood from one tenant hits its backlog bound within a few
            # submissions (2 queued + whatever the dispatcher drained)
            for i in range(20):
                accepted.append((
                    svc.submit(arrays[i], tenant="noisy"),
                    float(i),
                ))
        assert 2 <= len(accepted) < 20
        assert svc.stats_snapshot()["tenants"]["noisy"]["throttled"] >= 1
        for h, k in accepted:
            np.testing.assert_array_equal(h.result(120), AN + k)
    assert reg.snapshot_delta(before).get("tenant_throttled", 0) >= 1


# ----------------------------------------------------------------------
# fair share across tenants
# ----------------------------------------------------------------------


def test_three_tenants_interleaved_fair_share(spec):
    """The acceptance shape: >=3 tenants, interleaved submissions, all
    bitwise-correct, admissions interleaved by weight with the fairness
    ratio within the configured bound."""
    weights = {"gold": 2.0, "silver": 1.0, "bronze": 1.0}
    n_each = 6
    with ComputeService(
        max_concurrent=1, tenants=weights, plan_cache=False,
        result_cache=False,
    ) as svc:
        handles = {}
        for i in range(n_each):  # interleaved submission order
            for tenant in weights:
                k = float(hash((tenant, i)) % 97)
                handles[(tenant, i)] = (
                    svc.submit(_build(spec, k=k, delay=0.02), tenant=tenant),
                    k,
                )
        for (tenant, i), (h, k) in handles.items():
            np.testing.assert_array_equal(h.result(180), AN + k)

        # admission order from the started_at stamps
        reqs = sorted(
            (h._request for h, _ in handles.values()),
            key=lambda r: r.started_at,
        )
        order = [r.tenant for r in reqs]
        # over the window where every tenant was still backlogged (gold
        # drains last at 2x weight: use the first 2 * n_bronze picks),
        # admission counts follow the weights
        window = order[: 2 * n_each]
        counts = {t: window.count(t) for t in weights}
        shares = {t: counts[t] / weights[t] for t in weights}
        ratio = max(shares.values()) / max(1e-9, min(shares.values()))
        assert ratio <= 2.0, (counts, order)
        row = svc.stats_snapshot()["tenants"]
        assert all(row[t]["completed"] == n_each for t in weights)


def test_flooding_tenant_cannot_starve_light_tenant(spec):
    """A tenant flooding the queue buys throughput proportional to its
    weight, never the whole service: the light tenant's requests all
    complete while the flood is still draining."""
    with ComputeService(
        max_concurrent=1, tenants={"flood": 1.0, "light": 1.0},
        plan_cache=False, result_cache=False,
    ) as svc:
        # built before any submit (plan-time tracing runs the kernel)
        flood_arrays = [_build(spec, k=float(i), delay=0.05) for i in range(12)]
        light_arrays = [_build(spec, k=100.0 + i, delay=0.05) for i in range(3)]
        flood = [svc.submit(a, tenant="flood") for a in flood_arrays]
        light = [svc.submit(a, tenant="light") for a in light_arrays]
        for i, h in enumerate(light):
            np.testing.assert_array_equal(h.result(120), AN + 100.0 + i)
        light_done = time.time()
        for i, h in enumerate(flood):
            np.testing.assert_array_equal(h.result(120), AN + float(i))
        # starvation bound: while both were backlogged the light tenant
        # was admitted at least every ceil(W/w)=2 picks, so its 3 requests
        # finished within the first ~8 admissions — long before the
        # 12-deep flood drained
        reqs = sorted(
            (h._request for h in flood + light),
            key=lambda r: r.started_at,
        )
        light_positions = [
            i for i, r in enumerate(reqs) if r.tenant == "light"
        ]
        assert light_positions, "light tenant never admitted"
        assert max(light_positions) <= 8, light_positions
        assert light_done  # noqa: B018 — document the timeline var


# ----------------------------------------------------------------------
# durability (in-process restart; the SIGKILL proof is in test_service_chaos)
# ----------------------------------------------------------------------


def test_durable_records_and_in_process_recovery(tmp_path, spec):
    sdir = str(tmp_path / "svc")
    svc = ComputeService(
        max_concurrent=1, service_dir=sdir, recover=False,
        plan_cache=False, result_cache=False,
    ).start()
    handles = [
        svc.submit(_build(spec, k=float(i), delay=0.1), tenant="t")
        for i in range(4)
    ]
    svc.close(timeout=60)
    # close() completes the queued tail's handles as CANCELLED (no client
    # may block forever) but does NOT seal their journal records: they
    # stay accepted + durable for the next service on this directory
    unfinished = [h for h in handles if h.status() == "cancelled"]
    assert unfinished, "all requests finished before close; nothing to recover"
    for h in unfinished:
        with pytest.raises(RequestCancelledError):
            h.result(timeout=1)
    pending = load_requests(sdir)
    assert {r["request_id"] for r in pending.get("t", [])} == {
        h.request_id for h in unfinished
    }

    reg = get_registry()
    before = reg.snapshot()
    svc2 = ComputeService(max_concurrent=2, service_dir=sdir).start()
    try:
        assert svc2.wait_idle(timeout=120)
        delta = reg.snapshot_delta(before)
        assert delta.get("service_requests_recovered", 0) == len(unfinished)
        for h in unfinished:
            h2 = svc2.handle(h.request_id)
            assert h2 is not None and h2.status() == "done"
            k = float(handles.index(h))
            np.testing.assert_array_equal(h2.result(10), AN + k)
        assert load_requests(sdir) == {}  # every accepted request sealed
    finally:
        svc2.close()


# ----------------------------------------------------------------------
# config / env resolution
# ----------------------------------------------------------------------


def test_spec_service_config_flows_through(tmp_path):
    cfg = ServiceConfig(tenants={"vip": 3.0}, max_concurrent=4)
    spec = ct.Spec(
        work_dir=str(tmp_path), allowed_mem="500MB", service=cfg
    )
    svc = ComputeService(spec=spec)
    assert svc.config.max_concurrent == 4
    assert svc.arbiter.weight("vip") == 3.0
    # a dict works too
    spec2 = ct.Spec(
        work_dir=str(tmp_path), allowed_mem="500MB",
        service={"max_concurrent": 3},
    )
    assert ComputeService(spec=spec2).config.max_concurrent == 3
    with pytest.raises(ValueError):
        ct.Spec(work_dir=str(tmp_path), service="not-a-config")


def test_env_overrides_win(monkeypatch, tmp_path):
    monkeypatch.setenv("CUBED_TPU_TORCH_SERVICE_MAX_CONCURRENT", "5")
    monkeypatch.setenv("CUBED_TPU_TORCH_SERVICE_RESULT_CACHE", "off")
    monkeypatch.setenv("CUBED_TPU_TORCH_SERVICE_DIR", str(tmp_path / "envdir"))
    cfg = ServiceConfig.resolve(config=ServiceConfig(max_concurrent=2))
    assert cfg.max_concurrent == 5
    assert cfg.result_cache is False
    assert cfg.service_dir == str(tmp_path / "envdir")


def test_malformed_env_raises(monkeypatch):
    monkeypatch.setenv("CUBED_TPU_TORCH_SERVICE_MAX_CONCURRENT", "many")
    with pytest.raises(ValueError, match="CUBED_TPU_TORCH_SERVICE_MAX_CONCURRENT"):
        ServiceConfig.resolve()
    monkeypatch.delenv("CUBED_TPU_TORCH_SERVICE_MAX_CONCURRENT")
    monkeypatch.setenv("CUBED_TPU_TORCH_SERVICE_PLAN_CACHE", "maybe")
    with pytest.raises(ValueError, match="CUBED_TPU_TORCH_SERVICE_PLAN_CACHE"):
        ServiceConfig.resolve()


def test_stats_snapshot_shape(spec):
    with ComputeService(tenants={"a": 2.0}) as svc:
        h = svc.submit(_build(spec), tenant="a")
        h.result(60)
        snap = svc.stats_snapshot()
        assert snap["durable"] is False
        assert snap["slots"] >= 1
        row = snap["tenants"]["a"]
        for key in (
            "weight", "queued", "running", "accepted", "completed",
            "failed", "cancelled", "throttled", "recovered",
            "plan_cache_hits", "result_cache_hits",
        ):
            assert key in row
        assert row["weight"] == 2.0


@pytest.fixture(scope="module", autouse=True)
def _clean_process(clean_process):
    yield


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------


def test_values_plans_and_rows_match_the_jax_package_service(tmp_path):
    """Three tenants' seeded requests, the same numpy inputs built in both
    packages: each value equals the JAX package's service's, each finalized
    plan has its tasks and ops, and the per-tenant rows agree."""
    import cubed_tpu
    import cubed_tpu.array_api as rxp
    import cubed_tpu.service as ref_service

    import cubed_tpu_torch.array_api as xp

    rng = np.random.default_rng(19)
    inputs = {t: rng.random((12, 10)) for t in ("gold", "silver", "bronze")}

    def build(pkg, ns, spec, x):
        a = pkg.from_array(x, chunks=(4, 5), spec=spec)
        return ns.sum(ns.multiply(a, a) + 1.0, axis=0)

    rspec = cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB")
    pspec = ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB")
    weights = {"gold": 2.0, "silver": 1.0, "bronze": 1.0}
    out = {}
    for name, pkg, ns, spec, service in (("ref", cubed_tpu, rxp, rspec, ref_service),
                                         ("port", ct, xp, pspec, None)):
        svc_cls = service.ComputeService if service is not None else ComputeService
        with svc_cls(tenants=weights, max_concurrent=2) as svc:
            arrays = {t: build(pkg, ns, spec, x) for t, x in inputs.items()}
            handles = {t: svc.submit(arr, tenant=t) for t, arr in arrays.items()}
            values = {t: h.result(120) for t, h in handles.items()}
            plans = {t: (arr.plan.num_tasks(), len(arr.plan._finalize(array_names=(arr.name,)).dag.nodes))
                     for t, arr in arrays.items()}
            rows = {t: {k: v for k, v in r.items() if k in ("weight", "accepted", "completed", "failed")}
                    for t, r in svc.stats_snapshot()["tenants"].items()}
        out[name] = (values, plans, rows)
    for t in inputs:
        np.testing.assert_allclose(out["port"][0][t], out["ref"][0][t], rtol=1e-12)
        np.testing.assert_allclose(out["port"][0][t], (inputs[t] ** 2 + 1.0).sum(axis=0), rtol=1e-12)
    assert out["port"][1] == out["ref"][1]
    assert out["port"][2] == out["ref"][2]


def test_durable_submit_of_an_unshippable_class_raises_at_submit(tmp_path, spec):
    """A durable request whose plan holds a class with no importable name
    (defined inside a function) cannot be written: the payload's refusal
    reaches the caller at submit, and no record is written."""
    from cubed_tpu_torch.runtime.payload import UnshippableClassError

    class Local:
        def __call__(self, x):
            return x + 1.0

    a = ct.from_array(AN, chunks=(2, 2), spec=spec)
    arr = ct.map_blocks(Local(), a, dtype=np.float64)
    sdir = str(tmp_path / "svc")
    with ComputeService(service_dir=sdir) as svc:
        with pytest.raises(UnshippableClassError, match="Local"):
            svc.submit(arr, tenant="t1")
        assert svc.stats_snapshot()["tenants"]["t1"]["accepted"] == 0
    assert load_requests(sdir) == {}
    assert not [p for p in os.listdir(os.path.join(sdir, "t1")) if p.endswith(".pkl")]
