"""The port's peer chunk transfer (``runtime/transfer.py``): the worker
chunk cache (byte budget, LRU, pressure eviction, eviction notices), the
coordinator's location registry, locality placement, the peer config's
wire (reset around every test: a config left armed by an earlier test in
the process must not leak in), and the fleet: a deep chain bit for bit with
store reads saved, remote fetches equal to store-only, a cache too small to
serve, and seeded peer faults (decided for the same fetches as in the JAX
package) and a peer's death, each a transparent store fallback that draws
no retry. Counterpart of tests/runtime/test_transfer.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as xp  # noqa: E402
from cubed_tpu.runtime import faults as ref_faults  # noqa: E402
from cubed_tpu_torch.observability.metrics import get_registry  # noqa: E402
from cubed_tpu_torch.runtime import faults, transfer  # noqa: E402
from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor  # noqa: E402

from . import _torch_fleet  # noqa: E402
from ._torch_fleet import bump as _bump  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clean_process():
    before = _torch_fleet.snapshot()
    _torch_fleet.reset_process_state()
    yield
    _torch_fleet.reset_process_state()
    assert _torch_fleet.leftovers(before) == {"children": [], "listening": []}


@pytest.fixture(autouse=True)
def _disarmed():
    _torch_fleet.reset_process_state()
    yield
    _torch_fleet.reset_process_state()


@pytest.fixture(scope="module")
def fleet():
    ex = DistributedDagExecutor(n_local_workers=2)
    try:
        yield ex
    finally:
        ex.close()


# ----------------------------------------------------------------------
# unit: the chunk cache
# ----------------------------------------------------------------------


def test_chunk_cache_respects_byte_budget_lru():
    cache = transfer.ChunkCache(max_bytes=100)
    assert cache.put("s", "0.0", b"x" * 40)
    assert cache.put("s", "0.1", b"x" * 40)
    assert cache.get("s", "0.0") is not None
    # 0.1 is now LRU; inserting 40 more evicts it, not the just-touched 0.0
    assert cache.put("s", "0.2", b"x" * 40)
    assert cache.get("s", "0.1") is None
    assert cache.get("s", "0.0") is not None
    assert cache.get("s", "0.2") is not None
    assert cache.bytes <= 100
    assert cache.evictions == 1
    # an entry bigger than the whole budget is rejected outright
    assert not cache.put("s", "big", b"x" * 101)
    assert cache.get("s", "big") is None
    # re-putting an existing key replaces, never double-counts
    assert cache.put("s", "0.0", b"y" * 40)
    assert cache.bytes <= 100


def test_chunk_cache_pressure_eviction():
    cache = transfer.ChunkCache(max_bytes=100)
    for i in range(5):
        cache.put("s", f"0.{i}", b"x" * 20)
    assert cache.bytes == 100
    # ok pressure: nothing happens
    assert cache.evict_for_pressure("ok") == 0
    # soft pressure: down to half the budget
    assert cache.evict_for_pressure("soft") > 0
    assert cache.bytes <= 50
    # hard pressure: the cache empties entirely
    cache.put("s", "9.9", b"x" * 20)
    assert cache.evict_for_pressure("hard") > 0
    assert cache.bytes == 0 and cache.stats()["entries"] == 0
    assert cache.pressure_evictions > 0


def test_chunk_cache_eviction_notify_drain():
    """Evicted keys accumulate for the heartbeat piggyback; a hard flush
    (or overflow) collapses into one forget-everything marker."""
    cache = transfer.ChunkCache(max_bytes=40)
    cache.put("s", "0.0", b"x" * 20)
    cache.put("s", "0.1", b"x" * 20)
    cache.put("s", "0.2", b"x" * 20)  # evicts 0.0
    evicted, flush = cache.drain_evictions()
    assert evicted == [("s", "0.0")] and not flush
    # drained: a second call returns nothing
    assert cache.drain_evictions() == ([], False)
    # hard pressure = full flush marker, no per-key list
    cache.evict_for_pressure("hard")
    evicted, flush = cache.drain_evictions()
    assert flush and evicted == []


def test_location_registry_remove_respects_ownership():
    """An eviction notice removes only entries still owned by that worker:
    a newer producer's entry survives a stale notice."""
    reg = transfer.ChunkLocationRegistry()
    reg.record("w1", [("s", "0.0", 10), ("s", "0.1", 10)])
    reg.record("w2", [("s", "0.0", 10)])  # w2 re-produced 0.0
    assert reg.remove("w1", [("s", "0.0"), ("s", "0.1"), ("s", "bad")]) == 1
    assert reg.locate("s", "0.0") == "w2"  # w1's stale notice didn't win
    assert reg.locate("s", "0.1") is None


# ----------------------------------------------------------------------
# unit: the location registry + placement scoring
# ----------------------------------------------------------------------


def test_location_registry_record_locate_drop():
    reg = transfer.ChunkLocationRegistry(max_entries=8)
    reg.record("w1", [("s", "0.0", 100), ("s", "0.1", 100)])
    reg.record("w2", [("s", "1.0", 200)])
    assert reg.locate("s", "0.0") == "w1"
    assert reg.locate("s", "1.0") == "w2"
    assert reg.locate("s", "9.9") is None
    # a retry/backup re-produced a chunk elsewhere: newest producer wins
    reg.record("w2", [("s", "0.0", 100)])
    assert reg.locate("s", "0.0") == "w2"
    resident = reg.resident_bytes([("s", "0.0"), ("s", "0.1"), ("s", "1.0")])
    assert resident == {"w2": 300, "w1": 100}
    # a departed worker's entries drop eagerly
    reg.drop_worker("w2")
    assert reg.locate("s", "0.0") is None
    assert reg.locate("s", "1.0") is None
    assert reg.locate("s", "0.1") == "w1"
    # malformed advertisements are ignored, never raise
    reg.record("w1", [("s",), None, ("s", "2.0", "nan")])
    assert reg.locate("s", "2.0") is None


def test_location_registry_bounded():
    reg = transfer.ChunkLocationRegistry(max_entries=4)
    reg.record("w1", [("s", f"0.{i}", 10) for i in range(10)])
    assert reg.stats()["entries"] == 4
    assert reg.locate("s", "0.9") == "w1"  # newest kept
    assert reg.locate("s", "0.0") is None  # oldest evicted


class _FakeWorker:
    def __init__(self, name, load):
        self.name = name
        self._load = load


def test_pick_worker_by_locality():
    load_of = lambda w: w._load  # noqa: E731
    a, b, c = _FakeWorker("a", 0.0), _FakeWorker("b", 1.0), _FakeWorker("c", 9.0)
    # most resident bytes wins while inside the load slack
    got = transfer.pick_worker_by_locality(
        [a, b, c], {"a": 100, "b": 500}, load_of
    )
    assert got is b
    # a best-scoring worker too far above the least-loaded is passed over
    got = transfer.pick_worker_by_locality([a, b, c], {"c": 500}, load_of)
    assert got is None
    # no resident bytes anywhere: locality has no opinion
    assert transfer.pick_worker_by_locality([a, b], {}, load_of) is None


def test_peer_config_wire_roundtrip():
    cfg = transfer.PeerConfig(enabled=True, fetch_timeout_s=0.5)
    armed = transfer.arm_from_wire(cfg.to_wire())
    assert armed is not None and armed.enabled
    assert armed.fetch_timeout_s == 0.5
    assert transfer.arm_from_wire(None) is None
    assert transfer.armed_config() is None
    # client side: wire_config is None unless a compute armed it
    assert transfer.wire_config() is None
    with transfer.client_scoped(True):
        raw = transfer.wire_config()
        assert raw is not None
        assert transfer.PeerConfig.from_dict(json.loads(raw)).enabled
    assert transfer.wire_config() is None


def test_seeded_peer_faults_match_the_reference():
    cfg = dict(seed=7, peer_drop_rate=0.3, peer_corrupt_rate=0.3, peer_delay_rate=0.2, peer_reset_rate=0.2)
    port = faults.FaultInjector(faults.FaultConfig.from_dict(cfg))
    ref = ref_faults.FaultInjector(ref_faults.FaultConfig.from_dict(cfg))
    keys = [f"/work/array-{i % 3}/{i}.{j}" for i in range(12) for j in range(4)] * 2
    assert [port.peer_fetch_fault(k) for k in keys] == [ref.peer_fetch_fault(k) for k in keys]
    assert [port.peer_serve_reset(k) for k in keys] == [ref.peer_serve_reset(k) for k in keys]


# ----------------------------------------------------------------------
# the fleet
# ----------------------------------------------------------------------


def _deep_chain(spec, depth=3, n=16, chunk=4):
    an = np.arange(n * n, dtype=np.float64).reshape(n, n)
    a = ct.from_array(an, chunks=(chunk, chunk), spec=spec)
    r = a
    for _ in range(depth):
        r = ct.map_blocks(_bump, r, dtype=np.float64)
    return an, r


def test_peer_transfer_end_to_end_bitwise_and_saves_store_reads(tmp_path, fleet):
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", scheduler="dataflow", peer_transfer=True)
    an, r = _deep_chain(spec, depth=3)
    reg = get_registry()
    before = reg.snapshot()
    result = r.compute(executor=fleet, optimize_graph=False)
    np.testing.assert_array_equal(result, an + 3.0)
    coord_stats = fleet._coordinator.stats_snapshot()
    delta = reg.snapshot_delta(before)
    assert delta.get("peer_hits", 0) > 0, delta
    assert delta.get("store_read_bytes_saved", 0) > 0, delta
    assert delta.get("placement_locality_hits", 0) > 0, delta
    assert delta.get("peer_fetch_fallbacks", 0) == 0, delta
    assert coord_stats["chunk_locations"]["recorded"] > 0, coord_stats


def test_peer_transfer_remote_fetch_and_store_only_parity(tmp_path, fleet):
    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    vals, deltas = {}, {}
    reg = get_registry()
    for mode in (False, True):
        spec = ct.Spec(work_dir=str(tmp_path / f"peer-{mode}"), allowed_mem="500MB", scheduler="dataflow",
                       peer_transfer=mode)
        a = ct.from_array(an, chunks=(4, 4), spec=spec)
        r = xp.sum(ct.map_blocks(_bump, a, dtype=np.float64))
        before = reg.snapshot()
        vals[mode] = float(r.compute(executor=fleet, optimize_graph=False))
        deltas[mode] = reg.snapshot_delta(before)
    assert vals[True] == vals[False] == float((an + 1.0).sum())
    assert deltas[True].get("peer_hits", 0) > 0, deltas[True]
    assert deltas[True].get("peer_locate_requests", 0) > 0, deltas[True]
    assert deltas[False].get("peer_hits", 0) == 0, deltas[False]
    assert deltas[False].get("store_read_bytes_saved", 0) == 0


def test_chaos_peer_fetch_drop_corrupt_delay_reset_bitwise(tmp_path, fleet):
    """Seeded drop, corrupt, delay and a serving peer's reset: bit for bit,
    each failure a store fallback, no retry drawn."""
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", scheduler="dataflow", peer_transfer=True,
                   fault_injection=dict(seed=7, peer_drop_rate=0.3, peer_corrupt_rate=0.3, peer_delay_rate=0.2,
                                        peer_delay_s=0.01, peer_reset_rate=0.2))
    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    a = ct.from_array(an, chunks=(4, 4), spec=spec)
    r = xp.sum(ct.map_blocks(_bump, ct.map_blocks(_bump, a, dtype=np.float64), dtype=np.float64))
    reg = get_registry()
    before = reg.snapshot()
    val = float(r.compute(executor=fleet, optimize_graph=False))
    assert val == float((an + 2.0).sum())
    delta = reg.snapshot_delta(before)
    assert delta.get("peer_fetch_fallbacks", 0) > 0, delta
    assert delta.get("task_retries", 0) == 0, delta
    assert delta.get("worker_loss_requeues", 0) == 0, delta


def test_peer_cache_eviction_transparently_falls_back_to_store(tmp_path, monkeypatch):
    monkeypatch.setenv(transfer.CACHE_BYTES_ENV_VAR, "64")  # less than one chunk
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", scheduler="dataflow", peer_transfer=True)
    an, r = _deep_chain(spec, depth=2)
    ex = DistributedDagExecutor(n_local_workers=2)
    reg = get_registry()
    before = reg.snapshot()
    try:
        np.testing.assert_array_equal(r.compute(executor=ex, optimize_graph=False), an + 2.0)
    finally:
        ex.close()
    delta = reg.snapshot_delta(before)
    assert delta.get("peer_hits", 0) == 0, delta
    assert delta.get("peer_misses", 0) > 0, delta
    assert delta.get("task_retries", 0) == 0, delta


def test_chaos_peer_death_mid_fetch_falls_back(tmp_path, monkeypatch):
    """A producer killed mid-compute: readers of its chunks read the store,
    bit for bit, its loss costing only free requeues."""
    monkeypatch.setenv(faults.FAULTS_ENV_VAR, faults.FaultConfig(
        seed=11, worker_crash_names=("local-0",), worker_crash_after_tasks=3).to_env_json())
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", scheduler="dataflow", peer_transfer=True)
    an, r = _deep_chain(spec, depth=3)
    ex = DistributedDagExecutor(n_local_workers=2)
    reg = get_registry()
    before = reg.snapshot()
    try:
        np.testing.assert_array_equal(r.compute(executor=ex, optimize_graph=False), an + 3.0)
        assert ex._coordinator.stats["workers_lost"] >= 1
    finally:
        ex.close()
    delta = reg.snapshot_delta(before)
    assert delta.get("peer_hits", 0) + delta.get("peer_misses", 0) > 0, delta
    assert delta.get("task_retries", 0) == 0, delta
