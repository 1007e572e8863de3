"""Chunk integrity in the port, held against the JAX package's: checksum
manifests, quarantine, read-time verification, corrupt metadata, the
corruption fault site (counterpart of tests/storage/test_integrity.py), stores
that verify across the packages, and the sequential cases of
tests/runtime/test_integrity.py (a corrupt chunk repaired mid-compute, an
unhealable one failing loudly, corruption and a kill then resume)."""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import pytest

import cubed_tpu_torch as ct
import cubed_tpu_torch.array_api as xp
from cubed_tpu.storage import integrity as ref_integrity
from cubed_tpu.storage.store import open_zarr_array as ref_open
from cubed_tpu_torch.backend_array_api import set_device
from cubed_tpu_torch.observability.accounting import task_scope
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime import faults
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor
from cubed_tpu_torch.runtime.faults import FaultConfig, FaultInjector
from cubed_tpu_torch.runtime.resilience import RetryBudgetExceededError, RetryPolicy
from cubed_tpu_torch.storage import integrity
from cubed_tpu_torch.storage.integrity import ChunkIntegrityError
from cubed_tpu_torch.storage.store import open_zarr_array


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    yield
    faults.deactivate()


def _make_array(path, shape=(4, 4), chunks=(2, 2), opener=open_zarr_array):
    arr = opener(str(path), mode="a", shape=shape, dtype=np.float64, chunks=chunks)
    arr[:] = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    return arr


def _flip_byte(path, offset=0):
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        data[offset] ^= 0xFF
        f.seek(0)
        f.write(data)


# -- manifest recording ---------------------------------------------------


def test_chunk_writes_record_manifest(tmp_path):
    store = tmp_path / "a"
    arr = _make_array(store)
    shards = [n for n in os.listdir(store) if n.startswith(".manifest-")]
    assert len(shards) == 1
    lines = [json.loads(line) for line in (store / shards[0]).read_text().splitlines() if line.strip()]
    assert {line["k"] for line in lines} == {"0.0", "0.1", "1.0", "1.1"}
    entries, had = integrity.load_manifest(arr._io)
    assert had and set(entries) == {"0.0", "0.1", "1.0", "1.1"}
    for key, ent in entries.items():
        data = (store / key).read_bytes()
        assert ent["c"] == integrity.checksum(data) == ref_integrity.checksum(data)
        assert ent["n"] == len(data)
    assert arr.nchunks_initialized == 4


def test_integrity_off_records_nothing(tmp_path):
    with integrity.scoped("off"):
        _make_array(tmp_path / "a")
    assert not [n for n in os.listdir(tmp_path / "a") if n.startswith(".manifest-")]


def test_manifest_merges_shards_last_write_wins(tmp_path):
    store = tmp_path / "a"
    _make_array(store)
    io = open_zarr_array(str(store), mode="r")._io
    entries, _ = integrity.load_manifest(io)
    newer = dict(entries["0.0"], c=12345, t=entries["0.0"]["t"] + 100)
    (store / ".manifest-99999-abc.json").write_text(json.dumps({"writer": "99999-abc", "entries": {"0.0": newer}}))
    merged, had = integrity.load_manifest(io)
    assert had and merged["0.0"]["c"] == 12345 and merged["0.1"] == entries["0.1"]
    assert ref_integrity.load_manifest(ref_open(str(store), mode="r")._io) == (merged, had)


def test_torn_trailing_manifest_line_tolerated(tmp_path):
    store = tmp_path / "a"
    arr = _make_array(store)
    shard = next(n for n in os.listdir(store) if n.startswith(".manifest-"))
    raw = (store / shard).read_bytes()
    (store / shard).write_bytes(raw[: len(raw) - 9])
    entries, had = integrity.load_manifest(arr._io)
    assert had and len(entries) == 3
    valid, corrupt, verified = arr.verify_chunks(quarantine=False)
    assert verified and len(valid) == 3 and len(corrupt) == 1


def test_corrupt_manifest_shard_tolerated(tmp_path):
    store = tmp_path / "a"
    arr = _make_array(store)
    shard = next(n for n in os.listdir(store) if n.startswith(".manifest-"))
    (store / shard).write_bytes(b"{not json!!")
    entries, had = integrity.load_manifest(arr._io)
    assert had and entries == {}
    valid, corrupt, verified = open_zarr_array(str(store), mode="r").verify_chunks(quarantine=False)
    assert verified and not valid
    assert sorted(corrupt) == ["0.0", "0.1", "1.0", "1.1"]
    assert not [n for n in os.listdir(store) if "quarantine" in n]


# -- verify_chunks --------------------------------------------------------


def test_verify_chunks_detects_bitflip_and_quarantines(tmp_path):
    store = tmp_path / "a"
    _make_array(store)
    _flip_byte(store / "1.0", offset=5)
    before = get_registry().snapshot()
    arr = open_zarr_array(str(store), mode="r")
    valid, corrupt, verified = arr.verify_chunks()
    assert verified and corrupt == ["1.0"] and valid == {"0.0", "0.1", "1.1"}
    assert len([n for n in os.listdir(store) if n.startswith("1.0.quarantine.")]) == 1
    assert arr.nchunks_initialized == 3
    delta = get_registry().snapshot_delta(before)
    assert delta.get("chunks_corrupt_detected") == 1
    assert delta.get("chunks_quarantined") == 1
    assert delta.get("chunks_verified", 0) >= 4
    # the reference's scan of the quarantined store agrees
    assert ref_open(str(store), mode="r").verify_chunks(quarantine=False)[:2] == ({"0.0", "0.1", "1.1"}, [])


def test_verify_chunks_detects_truncation(tmp_path):
    store = tmp_path / "a"
    _make_array(store)
    data = (store / "0.1").read_bytes()
    (store / "0.1").write_bytes(data[: len(data) // 2])
    assert ref_open(str(store), mode="r").verify_chunks(quarantine=False)[1] == ["0.1"]
    _, corrupt, _ = open_zarr_array(str(store), mode="r").verify_chunks()
    assert corrupt == ["0.1"]


def test_verify_chunks_without_manifest_falls_back_to_existence(tmp_path):
    with integrity.scoped("off"):
        _make_array(tmp_path / "a")
    valid, corrupt, verified = open_zarr_array(str(tmp_path / "a"), mode="r").verify_chunks()
    assert not verified and valid == {"0.0", "0.1", "1.0", "1.1"} and not corrupt


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stores_verify_across_the_packages(tmp_path, writer):
    """A store written by either package verifies under the other's
    functions: the same chunk bytes, the same manifest format; and a flipped
    byte is caught by both."""
    opener, reader = (open_zarr_array, ref_open) if writer == "port" else (ref_open, open_zarr_array)
    store = tmp_path / "a"
    _make_array(store, shape=(5, 7), chunks=(2, 3), opener=opener)
    arr = reader(str(store), mode="r")
    valid, corrupt, verified = arr.verify_chunks(quarantine=False)
    assert verified and len(valid) == 9 and not corrupt
    other_io = reader(str(store), mode="r")._io
    assert integrity.load_manifest(other_io)[0].keys() == ref_integrity.load_manifest(other_io)[0].keys()
    _flip_byte(store / "2.2")
    assert reader(str(store), mode="r").verify_chunks(quarantine=False)[1] == ["2.2"]
    assert opener(str(store), mode="r").verify_chunks(quarantine=False)[1] == ["2.2"]


# -- read-time verification ----------------------------------------------


def test_task_scope_read_verifies_and_quarantines(tmp_path):
    store = tmp_path / "a"
    expected = np.arange(16.0).reshape(4, 4)
    _make_array(store)
    _flip_byte(store / "0.0")
    arr = open_zarr_array(str(store), mode="r")
    with integrity.scoped("verify"):
        with task_scope():
            with pytest.raises(ChunkIntegrityError) as ei:
                arr[0:2, 0:2]
    assert ei.value.kind == "checksum" and ei.value.chunk_key == "0.0" and ei.value.store == str(store)
    assert [n for n in os.listdir(store) if n.startswith("0.0.quarantine.")]
    with integrity.scoped("verify"):
        with task_scope():
            np.testing.assert_array_equal(arr[2:4, 2:4], expected[2:4, 2:4])


def test_quarantined_chunk_reads_as_missing_not_fill_values(tmp_path):
    store = tmp_path / "a"
    _make_array(store)
    _flip_byte(store / "0.0")
    with integrity.scoped("verify"):
        with task_scope():
            with pytest.raises(ChunkIntegrityError):
                open_zarr_array(str(store), mode="r")[0:2, 0:2]
            with pytest.raises(ChunkIntegrityError) as ei:
                open_zarr_array(str(store), mode="r")[0:2, 0:2]
    assert ei.value.kind == "missing"


def test_write_mode_does_not_verify_reads(tmp_path):
    store = tmp_path / "a"
    _make_array(store)
    _flip_byte(store / "0.0")
    with task_scope():
        open_zarr_array(str(store), mode="r")[0:2, 0:2]


def test_client_side_reads_never_verify(tmp_path):
    store = tmp_path / "a"
    _make_array(store)
    _flip_byte(store / "0.0")
    with integrity.scoped("verify"):
        open_zarr_array(str(store), mode="r")[0:2, 0:2]


def test_chunk_integrity_error_pickles():
    err = ChunkIntegrityError("boom", store="/s", chunk_key="1.2", kind="checksum", expected=(1, 2), actual=(3, 4))
    back = pickle.loads(pickle.dumps(err))
    assert back.store == "/s" and back.chunk_key == "1.2"
    assert back.kind == "checksum" and back.wire_payload == err.wire_payload
    ref_err = ref_integrity.ChunkIntegrityError("boom", store="/s", chunk_key="1.2", kind="checksum",
                                                expected=(1, 2), actual=(3, 4))
    assert ref_err.wire_payload == err.wire_payload


# -- integrity mode knob --------------------------------------------------


def test_env_var_overrides_mode(monkeypatch):
    assert integrity.INTEGRITY_ENV_VAR == "CUBED_TPU_TORCH_INTEGRITY"
    monkeypatch.setenv(integrity.INTEGRITY_ENV_VAR, "verify")
    assert integrity.current_mode() == "verify"
    monkeypatch.setenv(integrity.INTEGRITY_ENV_VAR, "bogus")
    with pytest.raises(ValueError, match="integrity mode"):
        integrity.current_mode()
    monkeypatch.delenv(integrity.INTEGRITY_ENV_VAR)
    assert integrity.current_mode() == ref_integrity.DEFAULT_MODE == "write"
    with integrity.scoped("off"):
        assert integrity.current_mode() == "off"
    assert integrity.current_mode() == "write"


def test_env_override_wins_over_scoped_spec_mode(monkeypatch):
    monkeypatch.setenv(integrity.INTEGRITY_ENV_VAR, "verify")
    with integrity.scoped("off", export_env=True):
        assert integrity.current_mode() == "verify"
        assert os.environ[integrity.INTEGRITY_ENV_VAR] == "verify"
    assert integrity.current_mode() == "verify"


def test_spec_rejects_invalid_mode(tmp_path):
    with pytest.raises(ValueError, match="integrity mode"):
        ct.Spec(work_dir=str(tmp_path), integrity="sometimes")
    assert ct.Spec(work_dir=str(tmp_path), integrity="verify").integrity == "verify"


# -- corrupt .zarray hardening -------------------------------------------


def test_corrupt_zarray_read_raises_clear_error(tmp_path):
    store = tmp_path / "a"
    _make_array(store)
    (store / ".zarray").write_bytes(b'{"zarr_format": 2, "shape')
    with pytest.raises(ValueError, match="corrupt .zarray"):
        open_zarr_array(str(store), mode="r")


def test_corrupt_zarray_writer_mode_recreates(tmp_path):
    store = tmp_path / "a"
    _make_array(store)
    (store / ".zarray").write_bytes(b"\x00garbage")
    arr = open_zarr_array(str(store), mode="a", shape=(4, 4), dtype=np.float64, chunks=(2, 2))
    assert arr.shape == (4, 4)
    assert [n for n in os.listdir(store) if n.startswith(".zarray.quarantine.")]
    np.testing.assert_array_equal(arr[:], np.arange(16.0).reshape(4, 4))
    valid, corrupt, verified = arr.verify_chunks()
    assert verified and len(valid) == 4 and not corrupt


def test_atomic_write_fsyncs_before_rename(tmp_path, monkeypatch):
    from cubed_tpu_torch.storage import store as store_mod

    events = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(os, "fsync", lambda fd: (events.append("fsync"), real_fsync(fd))[1])
    monkeypatch.setattr(os, "replace", lambda a, b: (events.append("replace"), real_replace(a, b))[1])
    store_mod._LocalIO(str(tmp_path)).write_bytes_atomic("0", b"hello")
    assert "fsync" in events and "replace" in events
    assert events.index("fsync") < events.index("replace")
    assert (tmp_path / "0").read_bytes() == b"hello"


# -- corruption fault injection ------------------------------------------


def test_fault_injector_corruption_deterministic_bitflip_or_truncation(tmp_path):
    from cubed_tpu.observability.accounting import task_scope as ref_task_scope
    from cubed_tpu.runtime.faults import FaultConfig as RefFaultConfig, FaultInjector as RefFaultInjector

    inj = FaultInjector(FaultConfig(seed=5, storage_corrupt_rate=1.0))
    data = bytes(range(256))
    with task_scope():
        out1 = inj.storage_corrupt_fault("arr/0.0", data)
        assert out1 is not None and out1 != data
        assert len(out1) in (len(data), len(data) // 2)
        assert out1 == FaultInjector(FaultConfig(seed=5, storage_corrupt_rate=1.0)).storage_corrupt_fault(
            "arr/0.0", data)
    with ref_task_scope():
        assert RefFaultInjector(RefFaultConfig(seed=5, storage_corrupt_rate=1.0)).storage_corrupt_fault(
            "arr/0.0", data) == out1
    assert inj.storage_corrupt_fault("arr/0.0", data) is None


def test_injected_corruption_caught_by_verification(tmp_path):
    store = tmp_path / "a"
    with faults.scoped({"seed": 1, "storage_corrupt_rate": 1.0}):
        with task_scope():
            arr = open_zarr_array(str(store), mode="a", shape=(2,), dtype=np.float64, chunks=(2,))
            arr[:] = np.arange(2.0)
    valid, corrupt, verified = open_zarr_array(str(store), mode="r").verify_chunks()
    assert verified and corrupt == ["0"] and not valid


# -- end to end on the sequential executor --------------------------------


def _chunk_files(store: str) -> list:
    return sorted(n for n in os.listdir(store) if not n.startswith(".") and not n.endswith(".tmp")
                  and all(p.lstrip("-").isdigit() for p in n.split(".")))


def _stores_with_chunks(work_dir) -> list:
    out = []
    for root, _, names in os.walk(str(work_dir)):
        if ".zarray" in names and _chunk_files(root):
            out.append(root)
    return sorted(out)


class _CorruptFirstPopulatedStore:
    """Flips a byte in one chunk of the first store that gains chunks: the
    intermediate, after its producer ends and before any reader runs."""

    def __init__(self, work_dir):
        self.work_dir = work_dir
        self.corrupted = None

    def on_operation_end(self, event):
        if self.corrupted is not None:
            return
        for store in _stores_with_chunks(self.work_dir):
            name = _chunk_files(store)[0]
            _flip_byte(os.path.join(store, name), offset=3)
            self.corrupted = os.path.join(store, name)
            return


def test_chaos_recompute_repairs_corrupt_chunk_sequential(tmp_path):
    an = np.arange(100.0, dtype=np.float64).reshape(10, 10)
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", integrity="verify")
    a = ct.from_array(an, chunks=(2, 2), spec=spec)
    c = xp.multiply(xp.add(a, 1.0), 2.0)
    corruptor = _CorruptFirstPopulatedStore(str(tmp_path))
    before = get_registry().snapshot()
    res = c.compute(executor=PythonDagExecutor(retry_policy=RetryPolicy(retries=3, backoff_base=0.0, seed=0)),
                    optimize_graph=False, callbacks=[corruptor])
    np.testing.assert_array_equal(res, (an + 1.0) * 2.0)
    assert corruptor.corrupted is not None
    delta = get_registry().snapshot_delta(before)
    assert delta.get("chunks_corrupt_detected", 0) >= 1, delta
    assert delta.get("chunks_quarantined", 0) >= 1, delta
    assert delta.get("chunks_recomputed", 0) >= 1, delta
    assert delta.get("chunks_verified", 0) > 0, delta
    assert delta.get("task_failfast", 0) == 0, delta


def test_chaos_unhealable_corruption_fails_loudly(tmp_path):
    an = np.arange(16.0, dtype=np.float64).reshape(4, 4)
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", integrity="verify",
                   fault_injection=dict(seed=3, storage_corrupt_rate=1.0))
    a = ct.from_array(an, chunks=(2, 2), spec=spec)
    c = xp.multiply(xp.add(a, 1.0), 2.0)
    with pytest.raises((ChunkIntegrityError, RetryBudgetExceededError)):
        c.compute(executor=PythonDagExecutor(retry_policy=RetryPolicy(retries=2, backoff_base=0.0, seed=0)),
                  optimize_graph=False)


class _KillableAdd:
    """``x + 1`` that raises on one late block while a flag file exists."""

    def __init__(self, flag_path: str, kill_block=(9, 5)):
        self.flag_path = flag_path
        self.kill_block = tuple(kill_block)

    def __call__(self, x, block_id=None):
        if tuple(block_id or ()) == self.kill_block and os.path.exists(self.flag_path):
            raise RuntimeError(f"injected mid-compute kill at {block_id}")
        return x + 1.0


def test_chaos_corruption_kill_resume_sequential(tmp_path):
    """Seeded ~5% write corruption and a kill on a late block; one more chunk
    rots at rest; a clean resume quarantines every corrupt chunk, runs
    strictly fewer tasks than the plan and is bitwise correct."""
    an = np.arange(400.0, dtype=np.float64).reshape(20, 20)
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(an, chunks=(2, 2), spec=spec)
    kill_flag = os.path.join(str(tmp_path), "kill.flag")
    open(kill_flag, "w").close()
    b = ct.map_blocks(_KillableAdd(kill_flag), a, dtype=np.float64)
    full = b.plan.num_tasks(optimize_graph=False)
    with faults.scoped(dict(seed=1234, storage_corrupt_rate=0.05), export_env=True):
        with pytest.raises(Exception, match="mid-compute kill"):
            b.compute(executor=PythonDagExecutor(), optimize_graph=False)
    stores = _stores_with_chunks(str(tmp_path))
    survivors = _chunk_files(stores[0])
    assert 0 < len(survivors) < 100
    _flip_byte(os.path.join(stores[0], survivors[0]), offset=7)
    os.unlink(kill_flag)
    before = get_registry().snapshot()
    res = b.compute(executor=PythonDagExecutor(retries=2), optimize_graph=False, resume=True)
    np.testing.assert_array_equal(res, an + 1.0)
    delta = get_registry().snapshot_delta(before)
    assert delta.get("chunks_quarantined", 0) > 0, delta
    assert delta.get("tasks_skipped_resume", 0) > 0, delta
    assert 0 < delta.get("tasks_started", 0) < full, delta
    assert delta.get("tasks_skipped_resume", 0) + delta.get("tasks_started", 0) >= full
