"""The port's plan and result caches: structural fingerprints, the input
state digest over integrity manifests, LRU and byte bounds, a copy on a
hit, invalidation on a changed input, coalescing of identical in-flight
requests, and the switches; one cache story's flags, values and counters
held against the JAX package's service. Counterpart of
tests/service/test_cache.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import threading
import time

import numpy as np
import pytest

import cubed_tpu_torch as ct
from cubed_tpu_torch.core.plan import arrays_to_plan
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.service import ComputeService
from cubed_tpu_torch.service.cache import (
    PlanCache,
    ResultCache,
    input_state_digest,
    structural_fingerprint,
)
from ._torch_chaos import clean_process  # noqa: E402,F401


@pytest.fixture()
def spec(tmp_path):
    return ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")


def _plus_one(x):
    return x + 1.0


def _times_two(x):
    return x * 2.0


AN = np.arange(64, dtype=np.float64).reshape(8, 8)


def _build(spec, fn=_plus_one, data=AN):
    a = ct.from_array(data, chunks=(4, 4), spec=spec)
    return ct.map_blocks(fn, a, dtype=np.float64)


# ----------------------------------------------------------------------
# structural fingerprint
# ----------------------------------------------------------------------


def test_fingerprint_stable_across_rebuilds(spec):
    """Two builds of the same query fingerprint equal even though every
    gensym name and intermediate path differs."""
    d1 = arrays_to_plan(_build(spec)).dag
    d2 = arrays_to_plan(_build(spec)).dag
    f1, c1 = structural_fingerprint(d1)
    f2, c2 = structural_fingerprint(d2)
    assert f1 is not None
    assert f1 == f2
    assert len(c1) == len(c2)
    # the canonical orders are positionally aligned but name-disjoint
    assert set(c1).isdisjoint(set(c2))


def test_fingerprint_distinguishes_kernels(spec):
    f1, _ = structural_fingerprint(arrays_to_plan(_build(spec, _plus_one)).dag)
    f2, _ = structural_fingerprint(arrays_to_plan(_build(spec, _times_two)).dag)
    assert f1 != f2


def test_fingerprint_distinguishes_input_values(spec):
    """In-memory inputs are value-hashed: different data, different key."""
    f1, _ = structural_fingerprint(arrays_to_plan(_build(spec, data=AN)).dag)
    f2, _ = structural_fingerprint(
        arrays_to_plan(_build(spec, data=AN + 1.0)).dag
    )
    assert f1 != f2


def test_fingerprint_distinguishes_shapes_and_chunks(spec):
    a = ct.from_array(AN, chunks=(4, 4), spec=spec)
    b = ct.from_array(AN, chunks=(2, 2), spec=spec)
    f1, _ = structural_fingerprint(
        arrays_to_plan(ct.map_blocks(_plus_one, a, dtype=np.float64)).dag
    )
    f2, _ = structural_fingerprint(
        arrays_to_plan(ct.map_blocks(_plus_one, b, dtype=np.float64)).dag
    )
    assert f1 != f2


def test_fingerprint_distinguishes_source_stores(tmp_path, spec):
    """Two structurally identical queries over DIFFERENT zarr input
    stores must not collide — a plan-cache hit across them would compute
    over the wrong store's data."""
    src_a = str(tmp_path / "a.zarr")
    src_b = str(tmp_path / "b.zarr")
    ct.to_zarr(ct.from_array(AN, chunks=(4, 4), spec=spec), src_a)
    ct.to_zarr(ct.from_array(AN + 1.0, chunks=(4, 4), spec=spec), src_b)

    def build(src):
        a = ct.from_zarr(src, spec=spec)
        return ct.map_blocks(_plus_one, a, dtype=np.float64)

    f1, _ = structural_fingerprint(arrays_to_plan(build(src_a)).dag)
    f2, _ = structural_fingerprint(arrays_to_plan(build(src_b)).dag)
    assert f1 is not None and f1 != f2
    # same store twice still hashes equal (rebuild stability holds)
    f3, _ = structural_fingerprint(arrays_to_plan(build(src_a)).dag)
    assert f1 == f3

    # end-to-end through the service: each store serves its own data
    with ComputeService(max_concurrent=2) as svc:
        h1 = svc.submit(build(src_a), tenant="t")
        np.testing.assert_array_equal(h1.result(60), AN + 1.0)
        h2 = svc.submit(build(src_b), tenant="t")
        np.testing.assert_array_equal(h2.result(60), AN + 2.0)
        assert not h2.plan_cache_hit and not h2.result_cache_hit


def test_input_digest_tracks_manifest_changes(tmp_path, spec):
    """A zarr-backed source's digest changes when the store is rewritten
    (integrity manifests change), and is stable when it isn't."""
    src = str(tmp_path / "input.zarr")
    ct.to_zarr(ct.from_array(AN, chunks=(4, 4), spec=spec), src)

    def build():
        a = ct.from_zarr(src, spec=spec)
        return ct.map_blocks(_plus_one, a, dtype=np.float64)

    d1 = input_state_digest(arrays_to_plan(build()).dag)
    d2 = input_state_digest(arrays_to_plan(build()).dag)
    assert d1 is not None and d1 == d2
    ct.to_zarr(ct.from_array(AN + 5.0, chunks=(4, 4), spec=spec), src)
    d3 = input_state_digest(arrays_to_plan(build()).dag)
    assert d3 != d1


# ----------------------------------------------------------------------
# cache containers
# ----------------------------------------------------------------------


def test_result_cache_lru_eviction_by_bytes():
    cache = ResultCache(max_bytes=3 * AN.nbytes // 2)  # room for one
    reg = get_registry()
    before = reg.snapshot()
    assert cache.put("f1", "i1", AN)
    assert cache.put("f2", "i2", AN + 1.0)  # evicts f1
    assert len(cache) == 1
    assert cache.lookup("f1", "i1") is None
    got = cache.lookup("f2", "i2")
    np.testing.assert_array_equal(got, AN + 1.0)
    delta = reg.snapshot_delta(before)
    assert delta.get("result_cache_evictions", 0) >= 1
    # an oversize result is refused, not cached at the cost of the rest
    assert not cache.put("f3", "i3", np.zeros((1000, 1000)))


def test_result_cache_invalidates_on_input_digest_change():
    cache = ResultCache()
    reg = get_registry()
    cache.put("fp", "digest-a", AN)
    before = reg.snapshot()
    assert cache.lookup("fp", "digest-CHANGED") is None
    delta = reg.snapshot_delta(before)
    assert delta.get("result_cache_invalidations", 0) == 1
    assert len(cache) == 0  # the stale entry is gone, not just skipped


def test_result_cache_hit_returns_a_copy():
    cache = ResultCache()
    cache.put("fp", "i", AN)
    got = cache.lookup("fp", "i")
    got[0, 0] = -999.0
    again = cache.lookup("fp", "i")
    assert again[0, 0] == AN[0, 0]


def test_plan_cache_bound():
    cache = PlanCache(max_entries=2)
    for i in range(4):
        cache.put(f"f{i}", object(), [])
    assert len(cache) == 2
    assert cache.get("f0") is None
    assert cache.get("f3") is not None


# ----------------------------------------------------------------------
# service-level caching behavior
# ----------------------------------------------------------------------


def test_repeat_identical_query_hits_result_cache_zero_tasks(spec):
    reg = get_registry()
    with ComputeService(max_concurrent=2) as svc:
        h1 = svc.submit(_build(spec), tenant="a")
        np.testing.assert_array_equal(h1.result(60), AN + 1.0)
        assert not h1.result_cache_hit
        before = reg.snapshot()
        h2 = svc.submit(_build(spec), tenant="b")
        np.testing.assert_array_equal(h2.result(60), AN + 1.0)
        delta = reg.snapshot_delta(before)
        assert h2.result_cache_hit
        # the acceptance bar: the repeat ran NOTHING
        assert delta.get("tasks_completed", 0) == 0
        assert delta.get("result_cache_hits", 0) == 1


def test_mutated_input_manifest_invalidates_result_cache(tmp_path, spec):
    src = str(tmp_path / "in.zarr")
    ct.to_zarr(ct.from_array(AN, chunks=(4, 4), spec=spec), src)

    def build():
        a = ct.from_zarr(src, spec=spec)
        return ct.map_blocks(_times_two, a, dtype=np.float64)

    reg = get_registry()
    with ComputeService(max_concurrent=2) as svc:
        h1 = svc.submit(build(), tenant="a")
        np.testing.assert_array_equal(h1.result(60), AN * 2.0)
        h2 = svc.submit(build(), tenant="a")
        np.testing.assert_array_equal(h2.result(60), AN * 2.0)
        assert h2.result_cache_hit
        # rewrite the input: its integrity manifests change
        ct.to_zarr(ct.from_array(AN + 10.0, chunks=(4, 4), spec=spec), src)
        before = reg.snapshot()
        h3 = svc.submit(build(), tenant="a")
        np.testing.assert_array_equal(h3.result(60), (AN + 10.0) * 2.0)
        delta = reg.snapshot_delta(before)
        assert not h3.result_cache_hit
        assert h3.plan_cache_hit  # planning was still skipped
        assert delta.get("result_cache_invalidations", 0) >= 1
        assert delta.get("tasks_completed", 0) > 0  # it really re-ran


def test_identical_inflight_requests_coalesce(spec):
    """Two identical requests running concurrently share ONE execution."""

    def slow_plus(x):
        time.sleep(0.3)
        return x + 1.0

    def build():
        a = ct.from_array(AN, chunks=(8, 8), spec=spec)  # one task
        return ct.map_blocks(slow_plus, a, dtype=np.float64)

    reg = get_registry()
    before = reg.snapshot()
    with ComputeService(max_concurrent=2) as svc:
        h1 = svc.submit(build(), tenant="a")
        h2 = svc.submit(build(), tenant="b")
        np.testing.assert_array_equal(h1.result(60), AN + 1.0)
        np.testing.assert_array_equal(h2.result(60), AN + 1.0)
    delta = reg.snapshot_delta(before)
    # one of the two coalesced onto the other (or, if the first finished
    # before the second started, the second hit the result cache)
    assert (
        delta.get("service_requests_coalesced", 0)
        + delta.get("result_cache_hits", 0)
    ) >= 1


def test_concurrent_identical_requests_serialize_on_shared_plan(spec):
    """With the result cache OFF (so no coalescing gate), two identical
    concurrent requests share one cached FinalizedPlan — its exec lock
    must serialize them so the shared store paths are never written by
    two computes at once, and both results stay bitwise-correct."""

    def slow_plus(x):
        time.sleep(0.2)
        return x + 1.0

    def build():
        a = ct.from_array(AN, chunks=(4, 4), spec=spec)
        return ct.map_blocks(slow_plus, a, dtype=np.float64)

    with ComputeService(max_concurrent=2, result_cache=False) as svc:
        h1 = svc.submit(build(), tenant="a")
        h2 = svc.submit(build(), tenant="b")
        np.testing.assert_array_equal(h1.result(60), AN + 1.0)
        np.testing.assert_array_equal(h2.result(60), AN + 1.0)
        assert h1.plan_cache_hit or h2.plan_cache_hit


def test_caches_can_be_disabled(spec, monkeypatch):
    monkeypatch.setenv("CUBED_TPU_TORCH_SERVICE_PLAN_CACHE", "off")
    monkeypatch.setenv("CUBED_TPU_TORCH_SERVICE_RESULT_CACHE", "off")
    with ComputeService(max_concurrent=1) as svc:
        assert svc.plan_cache is None
        assert svc.result_cache is None
        h1 = svc.submit(_build(spec), tenant="a")
        h2 = svc.submit(_build(spec), tenant="a")
        np.testing.assert_array_equal(h1.result(60), AN + 1.0)
        np.testing.assert_array_equal(h2.result(60), AN + 1.0)
        assert not h2.result_cache_hit and not h2.plan_cache_hit


@pytest.fixture(scope="module", autouse=True)
def _clean_process(clean_process):
    yield


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------


def _cache_story(pkg, svc_cls, registry, work: str):
    """One cache story in *pkg*: a stored input, a repeat, a rewrite of the
    input and a resubmit; the hit flags, values and counter deltas."""
    spec = pkg.Spec(work_dir=work, allowed_mem="500MB")
    src = os.path.join(work, "in.zarr")
    pkg.to_zarr(pkg.from_array(AN, chunks=(4, 4), spec=spec), src)

    def build():
        return pkg.map_blocks(lambda x: x * 2.0, pkg.from_zarr(src, spec=spec), dtype=np.float64)

    before = registry.snapshot()
    story = []
    with svc_cls(max_concurrent=1) as svc:
        for step in range(4):
            if step == 2:
                pkg.to_zarr(pkg.from_array(AN + 10.0, chunks=(4, 4), spec=spec), src)
            h = svc.submit(build(), tenant="a")
            story.append((h.result(60).tolist(), h.plan_cache_hit, h.result_cache_hit))
    delta = registry.snapshot_delta(before)
    counters = {k: delta.get(k, 0) for k in ("plan_cache_hits", "plan_cache_misses", "result_cache_hits",
                                             "result_cache_misses", "result_cache_invalidations")}
    return story, counters


def test_cache_hits_and_invalidations_match_the_jax_package(tmp_path):
    """The same story (a miss, a result hit, a rewritten input that
    invalidates but still hits the plan cache, a hit again) gives the JAX
    package's service's flags, values and cache counters."""
    import cubed_tpu
    import cubed_tpu.service as ref_service
    from cubed_tpu.observability.metrics import get_registry as ref_registry

    ours = _cache_story(ct, ComputeService, get_registry(), str(tmp_path / "port"))
    theirs = _cache_story(cubed_tpu, ref_service.ComputeService, ref_registry(), str(tmp_path / "ref"))
    assert ours == theirs
    assert [s[1:] for s in ours[0]] == [(False, False), (False, True), (True, False), (False, True)]
