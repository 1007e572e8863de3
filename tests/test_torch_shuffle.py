"""The port's rechunk exchange on the peer data plane (``runtime/shuffle.py``)
held against the JAX package: the byte ranges of a sub-chunk fetch (equal
to the reference's, and rebuilding the region), the region and chunk-grid
index math, a real plan's rechunk reads and writes, the sub-chunk peer
protocol with its two checks, the threaded scheduler overlapping the
rechunk, chunk-granular rechunk resume, and on a fleet: the exchange bit
for bit with remote ranged fetches and store reads saved, the analytics
``shuffle`` bucket, seeded peer faults and a killed worker mid-exchange
(store fallbacks, no retries), and a client killed mid-rechunk resumed bit
for bit. Counterpart of tests/runtime/test_shuffle.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
from cubed_tpu.runtime import shuffle as ref_shuffle  # noqa: E402
from cubed_tpu.runtime.dataflow import build_chunk_graph as ref_build_chunk_graph  # noqa: E402
from cubed_tpu_torch.observability.metrics import get_registry  # noqa: E402
from cubed_tpu_torch.runtime import faults, shuffle, transfer  # noqa: E402
from cubed_tpu_torch.runtime.dataflow import build_chunk_graph  # noqa: E402
from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor  # noqa: E402
from cubed_tpu_torch.runtime.journal import load_journal  # noqa: E402

from . import _torch_fleet  # noqa: E402
from ._torch_fleet import bump as _bump  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _transpose_pipeline(tmp_path, n=128, chunk=32, allowed="700KB", pkg=ct, **spec_kw):
    """Row chunks rechunked to column chunks: every target region reads
    every source chunk (the all-to-all)."""
    spec = pkg.Spec(work_dir=str(tmp_path), allowed_mem=allowed, **spec_kw)
    an = np.arange(n * n, dtype=np.float64).reshape(n, n)
    a = pkg.from_array(an, chunks=(chunk, n), spec=spec)
    b = pkg.map_blocks(_bump, a, dtype=np.float64)
    return an, b.rechunk((n, chunk))


@pytest.mark.parametrize("shape,sel", [
    ((8, 8), (slice(2, 5), slice(1, 4))),
    ((8, 8), (slice(0, 8), slice(0, 3))),
    ((4, 6, 8), (slice(1, 3), slice(0, 6), slice(0, 8))),
    ((4, 6, 8), (slice(0, 4), slice(2, 4), slice(1, 7))),
    ((16,), (slice(3, 9),)),
])
def test_byte_ranges_reconstruct_region(shape, sel):
    buf = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    ranges = shuffle.byte_ranges(shape, buf.dtype.itemsize, sel)
    assert ranges is not None and ranges == ref_shuffle.byte_ranges(shape, buf.dtype.itemsize, sel)
    raw = buf.tobytes()
    got = np.frombuffer(b"".join(raw[o:o + n] for o, n in ranges), dtype=np.float64)
    np.testing.assert_array_equal(got.reshape(tuple(s.stop - s.start for s in sel)), buf[sel])


def test_byte_ranges_declines_unrangeable_reads():
    assert shuffle.byte_ranges((8, 8), 8, (slice(0, 8), slice(0, 8))) is None
    assert shuffle.byte_ranges((8, 8), 8, (slice(0, 8), slice(0, 7))) is None
    assert shuffle.byte_ranges((8, 8), 8, (slice(0, 4, 2), slice(0, 4))) is None
    assert shuffle.byte_ranges((1024, 1024), 8, (slice(0, 1024), slice(0, 1))) is None
    assert shuffle.byte_ranges((), 8, ()) is None
    assert shuffle.byte_ranges((8, 8), 8, (slice(2, 4), slice(0, 8))) == [(2 * 8 * 8, 2 * 8 * 8)]


def test_region_chunk_index_math():
    region = (slice(0, 64), slice(32, 64))
    for mod in (shuffle, ref_shuffle):
        assert list(mod.chunks_overlapping_region(region, (32, 64))) == [(0, 0), (1, 0)]
        assert mod.region_chunk_keys(region, (32, 64)) == ["0.0", "1.0"]
        assert mod.chunk_key_str(()) == "0"
        assert mod.region_identity(region) == "0:64,32:64"
        assert mod.is_region_item(region) and not mod.is_region_item(("array-1", 0, 0))


def test_rechunk_task_reads_and_writes_from_real_plan(tmp_path):
    counts = []
    for pkg, build, mod in ((ct, build_chunk_graph, shuffle), (cubed_tpu, ref_build_chunk_graph, ref_shuffle)):
        _an, c = _transpose_pipeline(tmp_path / pkg.__name__, pkg=pkg)
        g = build(c.plan._finalize(optimize_graph=False).dag)
        name = [n for n, k in g.op_kind.items() if k == "rechunk"][0]
        config = g.pipelines[name].config
        items = [m for op, m in g.items if op == name]
        src_store = str(config.read.array.store)
        covered = []
        for m in items:
            reads = mod.rechunk_task_reads(m, config)
            assert {s for s, _k in reads} == {src_store} and len(reads) == 128 // 32
            covered.extend(mod.rechunk_task_writes(m, config))
        assert len(covered) == len(set(covered))
        counts.append((len(items), sorted(covered)))
    assert counts[0] == counts[1]


def test_peer_server_serves_ranges_with_verification_evidence():
    data = np.arange(64, dtype=np.float64).tobytes()
    server = transfer.PeerRuntime("w-serve", max_cache_bytes=1 << 20)
    server.cache.put("s", "0.0", data)
    server.start_server()
    client = transfer.PeerRuntime("w-client", max_cache_bytes=1 << 20)
    addr = ("127.0.0.1", server.port)
    try:
        reply = client.fetch_range_reply(addr, "s", "0.0", [(0, 64), (256, 128)], 2.0)
        payload = reply["data"]
        assert payload == data[0:64] + data[256:384]
        assert reply["crc"] == transfer._crc(payload)
        assert reply["full_crc"] == transfer._crc(data) and reply["total"] == len(data)
        assert client.fetch_bytes(addr, "s", "0.0", 2.0) == data
        miss = client.fetch_range_reply(addr, "s", "9.9", [(0, 64)], 2.0)
        assert miss is not None and miss["data"] is None
    finally:
        client.close()
        server.close()


def test_fetch_chunk_ranges_rejects_stale_cache_copy():
    data = np.arange(64, dtype=np.float64).tobytes()
    entry = {"c": transfer._crc(data), "n": len(data)}
    server = transfer.PeerRuntime("w-serve", max_cache_bytes=1 << 20)
    server.start_server()
    reader = transfer.PeerRuntime("w-read", max_cache_bytes=1 << 20)
    addr = ("127.0.0.1", server.port)
    reader._loc_cache[("s", "0.0")] = ("w-serve", addr)
    transfer.set_worker_runtime(reader)
    assert transfer.arm_from_wire(transfer.PeerConfig(enabled=True).to_wire()) is not None
    try:
        server.cache.put("s", "0.0", data)
        got, attempted = transfer.fetch_chunk_ranges("s", "0.0", entry, [(0, 64)])
        assert attempted and got == data[0:64]
        server.cache.put("s", "0.0", b"\x00" * len(data))  # a stale copy
        reg = get_registry()
        before = reg.snapshot()
        got, attempted = transfer.fetch_chunk_ranges("s", "0.0", entry, [(0, 64)])
        assert got is None and attempted
        assert reg.snapshot_delta(before).get("peer_fetch_fallbacks", 0) > 0
        transfer.arm_from_wire(None)
        got, attempted = transfer.fetch_chunk_ranges("s", "0.0", entry, [(0, 64)])
        assert got is None and not attempted
    finally:
        reader.close()
        server.close()


def test_threaded_rechunk_dataflow_no_barrier_bitwise(tmp_path):
    from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor

    an, c = _transpose_pipeline(tmp_path)
    d = ct.map_blocks(lambda x: x * 2.0, c, dtype=np.float64)
    reg = get_registry()
    before = reg.snapshot()
    res = d.compute(executor=AsyncPythonDagExecutor(), optimize_graph=False)
    np.testing.assert_array_equal(res, (an + 1.0) * 2.0)
    delta = reg.snapshot_delta(before)
    assert delta.get("op_barrier_waits", 0) == 0, delta
    assert delta.get("tasks_dispatched_early", 0) > 0, delta


def test_rechunk_resume_is_chunk_granular(tmp_path):
    an, c = _transpose_pipeline(tmp_path)
    np.testing.assert_array_equal(c.compute(optimize_graph=False), an + 1.0)
    fin = c.plan._finalize(optimize_graph=False)
    assert fin.num_tasks(resume=True) == 2  # the create-arrays bootstrap
    g = build_chunk_graph(fin.dag)
    rechunk_ops = [n for n, k in g.op_kind.items() if k == "rechunk"]
    store = str(g.pipelines[rechunk_ops[-1]].config.write.array.store)
    os.unlink(os.path.join(store, "0.0"))
    assert fin.num_tasks(resume=True) == 2 + 1  # and the one covering region
    g2 = build_chunk_graph(fin.dag, resume=True)
    rech = [(i, m) for i, (op, m) in enumerate(g2.items) if op in rechunk_ops]
    assert len(rech) == 1
    idx, m = rech[0]
    assert "0.0" in shuffle.rechunk_task_writes(m, g2.pipelines[rechunk_ops[-1]].config)
    create = {i for i, (op, _m) in enumerate(g2.items) if op == "create-arrays"}
    assert g2.dependencies.get(idx, set()) <= create


def test_fleet_shuffle_eliminates_store_reads_bitwise(tmp_path, fleet):
    an, c = _transpose_pipeline(tmp_path, peer_transfer=True)
    reg = get_registry()
    before = reg.snapshot()
    np.testing.assert_array_equal(c.compute(executor=fleet, optimize_graph=False), an + 1.0)
    delta = reg.snapshot_delta(before)
    for key in ("peer_hits", "peer_range_fetches", "shuffle_bytes_peer", "store_read_bytes_saved"):
        assert delta.get(key, 0) > 0, (key, delta)
    assert delta.get("peer_fetch_fallbacks", 0) == 0 and delta.get("task_retries", 0) == 0, delta
    assert delta.get("peer_bytes_fetched", 0) < delta.get("store_read_bytes_saved", 0), delta


def test_fleet_shuffle_analytics_bucket(tmp_path, fleet):
    from cubed_tpu_torch.observability.analytics import analyze
    from cubed_tpu_torch.observability.flightrecorder import FlightRecorder

    an, c = _transpose_pipeline(tmp_path, peer_transfer=True)
    fr = FlightRecorder(bundle_dir=str(tmp_path / "fr"), always=True)
    np.testing.assert_array_equal(c.compute(executor=fleet, optimize_graph=False, callbacks=[fr]), an + 1.0)
    d = analyze(fr).to_dict()
    assert d["critical_path_source"] == "chunk_graph"
    rows = {op: row for op, row in d["per_op"].items() if "rechunk" in op}
    assert rows and any(row["buckets"].get("shuffle", 0) > 0 for row in rows.values()), rows


def test_chaos_peer_faults_during_shuffle_bitwise(tmp_path, fleet):
    an, c = _transpose_pipeline(
        tmp_path, peer_transfer=True,
        fault_injection=dict(seed=13, peer_drop_rate=0.3, peer_corrupt_rate=0.3, peer_delay_rate=0.2,
                             peer_delay_s=0.01, peer_reset_rate=0.2))
    reg = get_registry()
    before = reg.snapshot()
    np.testing.assert_array_equal(c.compute(executor=fleet, optimize_graph=False), an + 1.0)
    delta = reg.snapshot_delta(before)
    assert delta.get("peer_fetch_fallbacks", 0) > 0, delta
    assert delta.get("task_retries", 0) == 0 and delta.get("worker_loss_requeues", 0) == 0, delta


def test_chaos_worker_hard_killed_mid_shuffle(tmp_path, monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV_VAR, faults.FaultConfig(
        seed=17, worker_crash_names=("local-0",), worker_crash_after_tasks=3).to_env_json())
    an, c = _transpose_pipeline(tmp_path, peer_transfer=True)
    ex = DistributedDagExecutor(n_local_workers=2)
    reg = get_registry()
    before = reg.snapshot()
    try:
        np.testing.assert_array_equal(c.compute(executor=ex, optimize_graph=False), an + 1.0)
        assert ex._coordinator.stats["workers_lost"] >= 1
    finally:
        ex.close()
    assert reg.snapshot_delta(before).get("task_retries", 0) == 0


_CRASH_SCRIPT = r"""
import json, sys
import numpy as np
sys.path.insert(0, {repo!r})
import cubed_tpu_torch as ct
from cubed_tpu_torch.observability import get_registry
from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor

mode = sys.argv[1]

def bump(x):
    return x + 1.0

if __name__ == "__main__":
    N, CHUNK = 128, 32
    spec = ct.Spec(work_dir={work_dir!r}, allowed_mem="700KB", journal={journal!r}, peer_transfer=True,
                   fault_injection={{"seed": 3, "straggler_rate": 1.0, "straggler_delay_s": 0.12}})
    an = np.arange(N * N, dtype=np.float64).reshape(N, N)
    a = ct.from_array(an, chunks=(CHUNK, N), spec=spec)
    c = ct.map_blocks(bump, a, dtype=np.float64).rechunk((N, CHUNK))
    total = c.plan.num_tasks(optimize_graph=False)
    ex = DistributedDagExecutor(n_local_workers=2, worker_threads=1)
    try:
        if mode == "run":
            c.compute(executor=ex, optimize_graph=False)
        else:
            reg = get_registry()
            before = reg.snapshot()
            result = ex.resume_compute(c, {journal!r}, optimize_graph=False)
            delta = reg.snapshot_delta(before)
            print(json.dumps({{"correct": bool(np.array_equal(result, an + 1.0)), "total": total,
                               "resumed_tasks": delta.get("tasks_completed", 0),
                               "skipped": delta.get("tasks_skipped_resume", 0)}}), flush=True)
    finally:
        ex.close()
"""


def test_chaos_client_sigkill_mid_rechunk_resume_bitwise(tmp_path):
    """The client killed while the rechunk is part done (seen in its
    journal), the same plan rebuilt in a fresh process and resumed on a
    fresh fleet: bit for bit, with fewer tasks re-run than the plan has."""
    journal = str(tmp_path / "shuffle.journal.jsonl")
    script = _CRASH_SCRIPT.format(repo=REPO, work_dir=str(tmp_path), journal=journal)
    env = dict(os.environ, CUBED_TPU_TORCH_DEVICE="cpu", CUBED_TPU_TORCH_CONTEXT_ID="cubed-shufflecrash")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", script, "run"], env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, start_new_session=True)
    try:
        deadline = time.time() + 120
        killed = False
        while time.time() < deadline and proc.poll() is None:
            if os.path.exists(journal):
                done = sum(1 for op, _k in load_journal(journal)["completed"] if "rechunk" in op)
                if done >= 1:
                    os.killpg(proc.pid, signal.SIGKILL)
                    killed = True
                    break
            time.sleep(0.03)
        proc.wait(timeout=30)
        assert killed, f"compute finished before the kill (rc={proc.returncode})"
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    # the killed run's workers lose their coordinator and give up
    loaded = load_journal(journal)
    assert loaded["complete"] is False
    total = sum(n for op, n in loaded["meta"]["ops"].items() if "rechunk" in op)
    done = sum(1 for op, _k in loaded["completed"] if "rechunk" in op)
    assert 0 < done < total
    out = subprocess.run([sys.executable, "-c", script, "resume"], env=env, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["correct"] is True and report["skipped"] > 0
    assert report["resumed_tasks"] < report["total"], report
    assert load_journal(journal)["complete"] is True
