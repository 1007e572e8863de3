"""Resume in the port, held against the JAX package's: chunk-granular skips,
checksum-trustworthy restarts, plan introspection under ``resume=True``
equal to what the executors run and to the reference's count on the same
store, corrupt metadata tolerated (counterpart of the sequential cases of
tests/runtime/test_resume.py), and the device executor's op-granular resume,
whose path counters equal ``JaxExecutor``'s on the same plan and store."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest

import cubed_tpu as ct_ref
import cubed_tpu.array_api as ref_xp
import cubed_tpu_torch as ct
import cubed_tpu_torch.array_api as xp
from cubed_tpu.core.ops import _store_op as ref_store_op
from cubed_tpu.runtime.executors import jax as jax_executor_module
from cubed_tpu.runtime.executors.jax import JaxExecutor
from cubed_tpu_torch.backend_array_api import set_device
from cubed_tpu_torch.core.ops import _store_op
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor
from cubed_tpu_torch.runtime.types import Callback


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    yield


@pytest.fixture
def spec(tmp_path):
    return ct.Spec(work_dir=str(tmp_path / "work"), allowed_mem="500MB", reserved_mem=0)


class TaskCounter(Callback):
    """Counts the tasks of completed task events."""

    def __init__(self):
        self.value = 0

    def on_task_end(self, event):
        self.value += event.num_tasks


def _output_store(work_dir) -> str:
    stores = sorted(os.path.dirname(p) for p in glob.glob(f"{work_dir}/*/*.zarr/.zarray"))
    assert len(stores) == 1, stores
    return stores[0]


def _chunk_files(store: str) -> list:
    return sorted(n for n in os.listdir(store) if not n.startswith(".") and not n.endswith(".tmp")
                  and all(p.lstrip("-").isdigit() for p in n.split(".")))


def _flip_byte(path: str, offset: int = 0) -> None:
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        data[offset] ^= 0xFF
        f.seek(0)
        f.write(data)


def test_resume_is_chunk_granular(spec):
    an = np.arange(100.0).reshape(10, 10)
    b = xp.add(ct.from_array(an, chunks=(2, 2), spec=spec), 1.0)
    np.testing.assert_array_equal(b.compute(optimize_graph=False), an + 1.0)
    os.unlink(os.path.join(_output_store(spec.work_dir), "3.3"))
    before = get_registry().snapshot()
    counter = TaskCounter()
    np.testing.assert_array_equal(b.compute(optimize_graph=False, resume=True, callbacks=[counter]), an + 1.0)
    assert get_registry().snapshot_delta(before).get("tasks_skipped_resume") == 24
    assert counter.value == 2  # create-arrays and the missing chunk's task


def test_resume_distrusts_corrupt_chunk(spec):
    an = np.arange(100.0).reshape(10, 10)
    b = xp.add(ct.from_array(an, chunks=(2, 2), spec=spec), 1.0)
    b.compute(optimize_graph=False)
    store = _output_store(spec.work_dir)
    _flip_byte(os.path.join(store, "0.1"), offset=4)
    before = get_registry().snapshot()
    np.testing.assert_array_equal(b.compute(optimize_graph=False, resume=True), an + 1.0)
    delta = get_registry().snapshot_delta(before)
    assert delta.get("chunks_corrupt_detected") == 1
    assert delta.get("chunks_quarantined") == 1
    assert delta.get("tasks_skipped_resume") == 24
    assert [n for n in os.listdir(store) if n.startswith("0.1.quarantine.")]


@pytest.mark.parametrize("missing", [(), ("0.0",), ("0.0", "1.2", "3.3"), ("0.0", "0.1", "1.0", "1.1", "2.2")])
def test_num_tasks_resume_matches_executed_tasks(tmp_path, missing):
    """On one partly written store, ``num_tasks(resume=True)`` of the port's
    plan equals the reference's plan's and what the resumed compute runs."""
    an = np.arange(64.0).reshape(8, 8)
    store = str(tmp_path / "out.zarr")
    spec = ct.Spec(work_dir=str(tmp_path / "work"), allowed_mem="500MB")
    ref_spec = ct_ref.Spec(work_dir=str(tmp_path / "ref-work"), allowed_mem="500MB")
    b = _store_op(xp.add(ct.from_array(an, chunks=(2, 2), spec=spec), 1.0), store)
    rb = ref_store_op(ref_xp.add(ct_ref.from_array(an, chunks=(2, 2), spec=ref_spec), 1.0), store, None)
    full = b.plan.num_tasks()
    assert full == rb.plan.num_tasks()
    b.compute()
    for name in missing:
        os.unlink(os.path.join(store, name))
    pending = b.plan.num_tasks(resume=True)
    assert pending == rb.plan.num_tasks(resume=True) == 1 + len(missing)
    assert b.plan.max_projected_mem(resume=True) == rb.plan.max_projected_mem(resume=True)
    counter = TaskCounter()
    b.compute(resume=True, callbacks=[counter])
    assert counter.value == pending


def test_num_tasks_resume_complete_plan(spec):
    b = xp.add(ct.from_array(np.arange(16.0).reshape(4, 4), chunks=(2, 2), spec=spec), 1.0)
    b.compute(optimize_graph=False)
    assert b.plan.num_tasks(optimize_graph=False, resume=True) == 1


def test_max_projected_mem_resume_consistent(spec):
    b = xp.add(ct.from_array(np.arange(64.0).reshape(8, 8), chunks=(2, 2), spec=spec), 1.0)
    full_mem = b.plan.max_projected_mem(optimize_graph=False)
    assert full_mem > 0
    b.compute(optimize_graph=False)
    assert b.plan.max_projected_mem(optimize_graph=False, resume=True) == 0
    os.unlink(os.path.join(_output_store(spec.work_dir), "0.0"))
    assert b.plan.max_projected_mem(optimize_graph=False, resume=True) == full_mem


def test_resume_tolerates_corrupt_zarray(spec):
    an = np.arange(36.0).reshape(6, 6)
    b = xp.add(ct.from_array(an, chunks=(2, 2), spec=spec), 1.0)
    b.compute(optimize_graph=False)
    store = _output_store(spec.work_dir)
    with open(os.path.join(store, ".zarray"), "wb") as f:
        f.write(b'{"zarr_format": 2, "shape": [6,')
    np.testing.assert_array_equal(b.compute(optimize_graph=False, resume=True), an + 1.0)
    assert [n for n in os.listdir(store) if n.startswith(".zarray.quarantine.")]


def test_resume_tolerates_corrupt_manifest(spec):
    an = np.arange(36.0).reshape(6, 6)
    b = xp.add(ct.from_array(an, chunks=(2, 2), spec=spec), 1.0)
    b.compute(optimize_graph=False)
    store = _output_store(spec.work_dir)
    shard = next(n for n in os.listdir(store) if n.startswith(".manifest-"))
    with open(os.path.join(store, shard), "wb") as f:
        f.write(b"\xff\xfenot json")
    before = get_registry().snapshot()
    np.testing.assert_array_equal(b.compute(optimize_graph=False, resume=True), an + 1.0)
    assert get_registry().snapshot_delta(before).get("tasks_skipped_resume", 0) == 0


def test_resume_integrity_off_is_existence_only(spec):
    from cubed_tpu_torch.storage import integrity

    an = np.arange(100.0).reshape(10, 10)
    b = xp.add(ct.from_array(an, chunks=(2, 2), spec=spec), 1.0)
    b.compute(optimize_graph=False)
    store = _output_store(spec.work_dir)
    _flip_byte(os.path.join(store, "0.1"), offset=4)
    before = get_registry().snapshot()
    with integrity.scoped("off"):
        b.compute(optimize_graph=False, resume=True)
    delta = get_registry().snapshot_delta(before)
    assert delta.get("chunks_verified", 0) == 0
    assert delta.get("chunks_corrupt_detected", 0) == 0
    assert delta.get("chunks_quarantined", 0) == 0
    assert delta.get("tasks_started") == 1
    assert not [n for n in os.listdir(store) if "quarantine" in n]


def test_plan_introspection_is_metrics_silent(spec):
    b = xp.add(ct.from_array(np.arange(36.0).reshape(6, 6), chunks=(2, 2), spec=spec), 1.0)
    b.compute(optimize_graph=False)
    before = get_registry().snapshot()
    b.plan.num_tasks(optimize_graph=False, resume=True)
    b.plan.max_projected_mem(optimize_graph=False, resume=True)
    delta = get_registry().snapshot_delta(before)
    assert delta.get("chunks_verified", 0) == 0
    assert delta.get("tasks_skipped_resume", 0) == 0


def test_multioutput_resume_skips_per_task(spec):
    from cubed_tpu_torch.core.ops import general_blockwise

    an = np.arange(12, dtype=np.float64)
    a = ct.from_array(an, chunks=(4,), spec=spec)

    def two(chunk):
        return chunk + 1.0, chunk * 2.0

    def block_function(out_key):
        return ((a.name, *out_key[1:]),)

    p, d = general_blockwise(two, block_function, a, shape=a.shape, dtype=[a.dtype, np.dtype(np.float64)],
                             chunks=a.chunks, op_name="two_out")
    ex = PythonDagExecutor()
    np.testing.assert_array_equal(np.asarray(p.compute(executor=ex)), an + 1.0)
    np.testing.assert_array_equal(np.asarray(d.compute(executor=ex)), an * 2.0)
    os.unlink(os.path.join(str(d.zarray_maybe_lazy.store), "1"))
    before = get_registry().snapshot()
    np.testing.assert_array_equal(np.asarray(d.compute(executor=ex, resume=True)), an * 2.0)
    assert get_registry().snapshot_delta(before).get("tasks_skipped_resume") == 2


# -- the device executor: op-granular, against JaxExecutor ----------------


def _product(pkg, mod, spec, shape=(20, 18, 16), chunks=8):
    a, b, x, y = [pkg.random.random(shape, chunks=chunks, spec=spec) for _ in range(4)]
    return a[1:] * x[1:] + b[1:] * y[1:]


@pytest.mark.parametrize("corrupt", [False, True])
def test_device_executor_resume_counters_equal_the_jax_executor(tmp_path, corrupt):
    """The to-Zarr product plan: computed once by the port into a user
    store, then resumed on ``CudaExecutor`` and on ``JaxExecutor`` over the
    same store (each after the same damage). With the store whole the
    product op is skipped; the random ops, which persisted nothing, run
    again. A corrupt chunk is quarantined by the scan and its op re-runs."""
    import random

    store = str(tmp_path / "product.zarr")
    random.seed(5)
    port = _store_op(_product(ct, xp, ct.Spec(work_dir=str(tmp_path / "w"), allowed_mem="500MB")), store)
    random.seed(5)
    ref = ref_store_op(_product(ct_ref, ref_xp, ct_ref.Spec(work_dir=str(tmp_path / "rw"), allowed_mem="500MB")),
                       store, None)
    port.compute(executor=CudaExecutor())
    expected = ct.from_zarr(store).compute()
    counters = {}
    for name, arr, ex in (("port", port, CudaExecutor()), ("ref", ref, JaxExecutor())):
        if corrupt:
            _flip_byte(os.path.join(store, "1.0.1"), offset=9)
        jax_executor_module._STRUCT_CACHE.clear()
        before = get_registry().snapshot()
        arr.compute(executor=ex, resume=True)
        counters[name] = dict(ex.stats)
        if name == "port":
            delta = get_registry().snapshot_delta(before)
            assert delta.get("chunks_quarantined", 0) == (1 if corrupt else 0)
        # the port's rewrite is bit for bit; JAX's arithmetic may round the
        # product's sum once differently
        np.testing.assert_allclose(ct.from_zarr(store).compute(), expected, rtol=0 if name == "port" else 1e-15)
        assert not ct.from_zarr(store).zarray.verify_chunks(quarantine=False)[1]
    paths = ("whole_array_hits", "whole_concat_hits", "batched_ops", "chunked_ops", "eager_ops", "rechunk_alias",
             "rechunk_virtual", "eager_fallbacks", "batched_errors")
    assert {c: counters["port"].get(c, 0) for c in paths} == {c: counters["ref"].get(c, 0) for c in paths}
    assert counters["port"].get("batched_ops", 0) == (5 if corrupt else 4)
