"""Results written to Zarr: ``to_zarr``, ``store``, explicit target stores in
``blockwise`` and the stdlib codecs, held against the JAX package.

The counterparts of ``tests/test_core.py::test_from_zarr_to_zarr`` and of the
codec cases of ``tests/storage/test_store.py``, and beside them the same
plans built in both packages: values exact (a store only moves them), the
plans' tasks, ops and projected memory equal, ``CudaExecutor``'s path
counters equal to ``JaxExecutor``'s, and the bytes written and read, as
stored, equal to the reference's ``executor_stats``. A compressed store
written by either package reads back in the other, and for one codec and
level both packages write byte-identical chunk files (gzip's header carries
the time of writing, so its four mtime bytes are set aside).
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json  # noqa: E402
import lzma  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.runtime import types as reference_types  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu.storage.store import open_zarr_array as ref_open  # noqa: E402
from cubed_tpu_torch.runtime import types as port_types  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor  # noqa: E402
from cubed_tpu_torch.storage.store import open_zarr_array  # noqa: E402

PATH_COUNTERS = ("whole_array_hits", "whole_concat_hits", "batched_ops", "chunked_ops", "eager_ops",
                 "rechunk_alias", "rechunk_virtual")
FAILED_CHECKS = ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors")
IO_COUNTS = ("bytes_read", "bytes_written", "chunks_read", "chunks_written")

CODECS = [
    {"id": "zlib", "level": 5},
    {"id": "zlib", "level": 1},
    {"id": "gzip", "level": 1},
    {"id": "bz2", "level": 1},
    {"id": "lzma", "preset": 0},
    {"id": "lzma", "format": lzma.FORMAT_RAW, "filters": [{"id": lzma.FILTER_LZMA2, "preset": 1}]},
    {"id": "lzma", "format": lzma.FORMAT_XZ, "filters": [{"id": lzma.FILTER_LZMA2, "preset": 1}]},
]


def _codec_id(c):
    return "-".join(f"{v}" for k, v in sorted(c.items()) if k != "filters")


def _stats_catcher(types_mod):
    class StatsCatcher(types_mod.Callback):
        def on_compute_end(self, event):
            self.executor_stats = event.executor_stats

    return StatsCatcher()


def _specs(tmp_path):
    return (cubed_tpu.Spec(work_dir=str(tmp_path / "ref-work"), allowed_mem="500MB", reserved_mem=0,
                           memory_guard="off"),
            cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port-work"), allowed_mem="500MB", reserved_mem=0))


def _plan_of(arr):
    plan = arr.plan._finalize(array_names=(arr.name,))
    return plan.num_tasks(), plan.num_ops(), plan.max_projected_mem()


def _chunk_bytes(store, key, codec):
    data = open(os.path.join(store, key), "rb").read()
    if codec["id"] == "gzip":
        data = data[:4] + b"\0\0\0\0" + data[8:]  # the header's mtime
    return data


# ---------------------------------------------------------------------------
# the codecs (tests/storage/test_store.py:232-360)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compressor", CODECS, ids=_codec_id)
def test_compressed_roundtrip(tmp_path, compressor):
    store = str(tmp_path / "c.zarr")
    z = open_zarr_array(store, "w", shape=(5, 7), dtype=np.float64, chunks=(2, 3), compressor=compressor)
    an = np.arange(35.0).reshape(5, 7)
    z[...] = an
    np.testing.assert_array_equal(z[...], an)
    z2 = open_zarr_array(store, "r")
    assert z2.compressor["id"] == compressor["id"]
    np.testing.assert_array_equal(z2[...], an)
    meta = json.loads(open(os.path.join(store, ".zarray")).read())
    assert meta["compressor"]["id"] == compressor["id"]
    assert open(os.path.join(store, "0.0"), "rb").read() != an[:2, :3].tobytes()


@pytest.mark.parametrize("compressor", CODECS, ids=_codec_id)
def test_chunk_files_byte_identical_to_the_jax_package(tmp_path, compressor):
    an = np.random.default_rng(3).random((5, 7))
    stores = {}
    for name, opener in (("ref", ref_open), ("port", open_zarr_array)):
        stores[name] = str(tmp_path / f"{name}.zarr")
        z = opener(stores[name], "w", shape=(5, 7), dtype=np.float64, chunks=(2, 3), compressor=compressor)
        z[...] = an
    meta = [json.loads(open(os.path.join(s, ".zarray")).read()) for s in stores.values()]
    assert meta[0] == meta[1]
    keys = sorted(k for k in os.listdir(stores["ref"]) if not k.startswith("."))
    assert keys == sorted(k for k in os.listdir(stores["port"]) if not k.startswith("."))
    assert len(keys) == 9
    for key in keys:
        assert _chunk_bytes(stores["ref"], key, compressor) == _chunk_bytes(stores["port"], key, compressor)
    # and each package reads the other's store
    np.testing.assert_array_equal(open_zarr_array(stores["ref"], "r")[...], an)
    np.testing.assert_array_equal(ref_open(stores["port"], "r")[...], an)


def test_compressed_interop_zlib(tmp_path):
    """A zlib chunk written byte for byte as any Zarr v2 implementation writes
    it reads back."""
    import zlib

    store = tmp_path / "other.zarr"
    store.mkdir()
    an = np.arange(6.0).reshape(2, 3)
    meta = {"zarr_format": 2, "shape": [2, 3], "chunks": [2, 3], "dtype": "<f8",
            "compressor": {"id": "zlib", "level": 1}, "fill_value": 0.0, "order": "C", "filters": None}
    (store / ".zarray").write_text(json.dumps(meta))
    (store / "0.0").write_bytes(zlib.compress(an.tobytes(), 1))
    np.testing.assert_array_equal(open_zarr_array(str(store), "r")[...], an)


@pytest.mark.parametrize("compressor", [{"id": "blosc", "cname": "lz4"}, {"id": "zstd"}])
def test_unsupported_compressor_raises(tmp_path, compressor):
    for opener in (ref_open, open_zarr_array):
        with pytest.raises(ValueError, match="blosc"):
            opener(str(tmp_path / "b.zarr"), "w", shape=(2,), dtype=np.float64, chunks=(2,),
                   compressor=compressor)


def test_reading_an_unsupported_store_raises(tmp_path):
    store = tmp_path / "blosc.zarr"
    store.mkdir()
    meta = {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f8",
            "compressor": {"id": "blosc", "cname": "lz4"}, "fill_value": 0.0, "order": "C", "filters": None}
    (store / ".zarray").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="blosc"):
        open_zarr_array(str(store), "r")


def test_append_mode_keeps_existing_compressor(tmp_path):
    store = str(tmp_path / "a.zarr")
    open_zarr_array(store, "w", shape=(4,), dtype=np.float64, chunks=(2,), compressor={"id": "bz2", "level": 1})
    z = open_zarr_array(store, "a", shape=(4,), dtype=np.float64, chunks=(2,))
    assert z.compressor == {"id": "bz2", "level": 1}
    from cubed_tpu_torch.storage.zarr import LazyZarrArray

    assert LazyZarrArray(store, (4,), np.float64, (2,)).create().compressor == {"id": "bz2", "level": 1}


def test_lzma_raw_format_roundtrip(tmp_path):
    comp = {"id": "lzma", "format": lzma.FORMAT_RAW, "filters": [{"id": lzma.FILTER_LZMA2, "preset": 1}]}
    store = str(tmp_path / "raw.zarr")
    z = open_zarr_array(store, "w", shape=(4, 4), dtype=np.float64, chunks=(2, 2), compressor=comp)
    an = np.arange(16.0).reshape(4, 4)
    z[...] = an
    np.testing.assert_array_equal(z[...], an)
    np.testing.assert_array_equal(open_zarr_array(store, "r")[...], an)


def test_bytes_recorded_as_stored(tmp_path):
    from cubed_tpu_torch.observability.metrics import get_registry

    store = str(tmp_path / "s.zarr")
    z = open_zarr_array(store, "w", shape=(64,), dtype=np.float64, chunks=(64,), compressor={"id": "zlib"})
    before = get_registry().snapshot()
    z[...] = np.zeros(64)
    z[...]
    delta = get_registry().snapshot_delta(before)
    stored = os.path.getsize(os.path.join(store, "0"))
    assert stored < 64 * 8
    assert delta["bytes_written"] == stored and delta["bytes_read"] == stored


# ---------------------------------------------------------------------------
# to_zarr and store, in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("executor", ["sequential", "device"])
def test_from_zarr_to_zarr(tmp_path, executor):
    an = np.arange(36.0).reshape(6, 6)
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB", reserved_mem=0)
    ex = PythonDagExecutor() if executor == "sequential" else CudaExecutor()
    a = cubed_tpu_torch.from_array(an, chunks=(2, 2), spec=spec)
    store = str(tmp_path / "out.zarr")
    cubed_tpu_torch.to_zarr(pxp.add(a, 1.0), store, executor=ex)
    b = cubed_tpu_torch.from_zarr(store, spec=spec)
    np.testing.assert_array_equal(b.compute(executor=ex), an + 1.0)


@pytest.mark.parametrize("compressor", [None, {"id": "zlib", "level": 1}, {"id": "bz2", "level": 1}],
                         ids=["raw", "zlib", "bz2"])
@pytest.mark.parametrize("executors", ["sequential", "device"])
def test_to_zarr_agrees_with_the_jax_package(tmp_path, compressor, executors):
    """The same plan into a store in both packages: the stores' metadata and
    chunk files, the values read back by the other package, the plans, the
    bytes as stored and, on the device executors, the path counters."""
    an = np.random.default_rng(0).random((10, 12))
    rs, ps = _specs(tmp_path)
    stores = {}
    stats = {}
    for label, pkg, xp, spec in (("ref", cubed_tpu, rxp, rs), ("port", cubed_tpu_torch, pxp, ps)):
        stores[label] = str(tmp_path / f"{label}.zarr")
        a = pkg.from_array(an, chunks=(4, 5), spec=spec)
        out = xp.multiply(xp.add(a, 1.0), 2.0)
        if executors == "sequential":
            ex = None
        elif pkg is cubed_tpu:
            jax_executor_module._STRUCT_CACHE.clear()
            ex = JaxExecutor()
        else:
            ex = CudaExecutor()
        catcher = _stats_catcher(reference_types if pkg is cubed_tpu else port_types)
        pkg.to_zarr(out, stores[label], executor=ex, compressor=compressor, callbacks=[catcher])
        stats[label] = (catcher.executor_stats, ex)
    ref_meta, port_meta = (json.loads(open(os.path.join(s, ".zarray")).read()) for s in stores.values())
    assert ref_meta == port_meta and port_meta["compressor"] == compressor
    keys = sorted(k for k in os.listdir(stores["ref"]) if not k.startswith("."))
    assert keys == sorted(k for k in os.listdir(stores["port"]) if not k.startswith(".")) and len(keys) == 9
    for key in keys:
        assert _chunk_bytes(stores["ref"], key, compressor or {"id": None}) == \
            _chunk_bytes(stores["port"], key, compressor or {"id": None})
    want = (an + 1.0) * 2.0
    np.testing.assert_array_equal(cubed_tpu_torch.from_zarr(stores["ref"], spec=ps).compute(), want)
    np.testing.assert_array_equal(np.asarray(cubed_tpu.from_zarr(stores["port"], spec=rs).compute()), want)
    (ref_stats, rex), (port_stats, pex) = stats["ref"], stats["port"]
    stored = sum(os.path.getsize(os.path.join(stores["port"], k)) for k in keys)
    assert port_stats["bytes_written"] == ref_stats["bytes_written"] == stored
    assert {k: port_stats.get(k, 0) for k in IO_COUNTS} == {k: ref_stats.get(k, 0) for k in IO_COUNTS}
    if executors == "device":
        assert {c: pex.stats[c] for c in PATH_COUNTERS} == {c: rex.stats.get(c, 0) for c in PATH_COUNTERS}
        assert {c: pex.stats[c] for c in FAILED_CHECKS} == dict.fromkeys(FAILED_CHECKS, 0)


def test_store_op_plan_agrees_and_fuses_into_its_producer(tmp_path):
    from cubed_tpu.core.ops import _store_op as ref_store_op
    from cubed_tpu_torch.core.ops import _store_op

    an = np.arange(48.0).reshape(6, 8)
    rs, ps = _specs(tmp_path)
    r = ref_store_op(rxp.negative(cubed_tpu.from_array(an, chunks=(3, 4), spec=rs)), str(tmp_path / "r.zarr"),
                     None)
    p = _store_op(pxp.negative(cubed_tpu_torch.from_array(an, chunks=(3, 4), spec=ps)), str(tmp_path / "p.zarr"))
    assert _plan_of(p) == _plan_of(r)
    # the fused op writes the user's store itself: no temporary store
    dag = p.plan._finalize(array_names=(p.name,)).dag
    targets = [d["target"] for d in dag.nodes.values() if d.get("type") == "array" and "target" in d]
    assert str(tmp_path / "p.zarr") in {getattr(t, "store", None) for t in targets}
    assert _plan_of(p)[1] == 2  # create-arrays and the fused negative-and-store


@pytest.mark.parametrize("executor", ["sequential", "device"])
def test_store_writes_several_arrays_in_one_plan(tmp_path, executor):
    rs, ps = _specs(tmp_path)
    an = np.arange(20.0).reshape(4, 5)
    targets = {}
    for label, pkg, xp, spec in (("ref", cubed_tpu, rxp, rs), ("port", cubed_tpu_torch, pxp, ps)):
        a = pkg.from_array(an, chunks=(2, 5), spec=spec)
        stores = [str(tmp_path / f"{label}-{i}.zarr") for i in range(2)]
        # store() writes into existing targets, as the reference's does
        for s in stores:
            (ref_open if pkg is cubed_tpu else open_zarr_array)(s, "w", shape=(4, 5), dtype=np.float64,
                                                                 chunks=(2, 5))
        if executor == "sequential":
            ex = None
        elif pkg is cubed_tpu:
            jax_executor_module._STRUCT_CACHE.clear()
            ex = JaxExecutor()
        else:
            ex = CudaExecutor()
        pkg.store([xp.add(a, 1.0), xp.multiply(a, 3.0)], stores, executor=ex)
        targets[label] = (stores, ex)
    for i, want in enumerate((an + 1.0, an * 3.0)):
        np.testing.assert_array_equal(open_zarr_array(targets["port"][0][i], "r")[...], want)
        np.testing.assert_array_equal(ref_open(targets["ref"][0][i], "r")[...], want)
    if executor == "device":
        pex, rex = targets["port"][1], targets["ref"][1]
        assert {c: pex.stats[c] for c in PATH_COUNTERS} == {c: rex.stats.get(c, 0) for c in PATH_COUNTERS}


def test_store_of_one_array(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB", reserved_mem=0)
    a = cubed_tpu_torch.from_array(np.arange(6.0), chunks=(4,), spec=spec)
    store = str(tmp_path / "one.zarr")
    open_zarr_array(store, "w", shape=(6,), dtype=np.float64, chunks=(4,))
    cubed_tpu_torch.store(a, store)
    np.testing.assert_array_equal(open_zarr_array(store, "r")[...], np.arange(6.0))


def test_to_zarr_with_path(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB", reserved_mem=0)
    a = cubed_tpu_torch.from_array(np.arange(6.0), chunks=(4,), spec=spec)
    cubed_tpu_torch.to_zarr(a, str(tmp_path / "group"), path="x", compressor={"id": "gzip", "level": 1})
    z = open_zarr_array(str(tmp_path / "group" / "x"), "r")
    assert z.compressor == {"id": "gzip", "level": 1}
    np.testing.assert_array_equal(z[...], np.arange(6.0))


def test_device_executor_writes_a_compressed_resident_output(tmp_path):
    """On the device executor the user's store is a requested output, written
    at the end chunk by chunk through the codec, and no intermediate store is
    written."""
    import random

    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "work"), allowed_mem="500MB", reserved_mem=0)
    random.seed(4)
    a = cubed_tpu_torch.random.random((12, 10), chunks=(5, 5), spec=spec)
    random.seed(4)
    root = random.getrandbits(30)
    store = str(tmp_path / "out.zarr")
    ex = CudaExecutor()
    cubed_tpu_torch.to_zarr(pxp.multiply(a, 2.0), store, executor=ex, compressor={"id": "zlib", "level": 1})
    z = open_zarr_array(store, "r")
    assert z.compressor == {"id": "zlib", "level": 1}
    want = np.empty((12, 10))
    for i in range(3):
        for j in range(2):
            block = np.random.Generator(np.random.Philox(seed=root + i * 2 + j)).random(
                (min(5, 12 - 5 * i), 5))
            want[5 * i:5 * i + block.shape[0], 5 * j:5 * j + 5] = block
    np.testing.assert_array_equal(z[...], want * 2.0)
    assert ex.stats["batched_ops"] == 1 and ex.stats["eager_fallbacks"] == 0
    work = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "work") for d in ds if d.endswith(".zarr")]
    assert work == []


# ---------------------------------------------------------------------------
# blockwise's explicit target store
# ---------------------------------------------------------------------------


def test_blockwise_target_store(tmp_path):
    from cubed_tpu.core.ops import blockwise as ref_blockwise
    from cubed_tpu_torch.core.ops import blockwise

    an = np.arange(12.0).reshape(3, 4)
    rs, ps = _specs(tmp_path)
    r = ref_blockwise(lambda x: x + 1, "ij", cubed_tpu.from_array(an, chunks=(2, 2), spec=rs), "ij",
                      dtype=np.float64, target_store=str(tmp_path / "r.zarr"))
    p = blockwise(lambda x: x + 1, "ij", cubed_tpu_torch.from_array(an, chunks=(2, 2), spec=ps), "ij",
                  dtype=np.float64, target_store=str(tmp_path / "p.zarr"))
    assert p.zarray_maybe_lazy.store == str(tmp_path / "p.zarr")
    assert _plan_of(p) == _plan_of(r)
    np.testing.assert_array_equal(p.compute(), np.asarray(r.compute()))
    np.testing.assert_array_equal(open_zarr_array(str(tmp_path / "p.zarr"), "r")[...], an + 1)


def test_blockwise_storage_options_refused(tmp_path):
    """storage_options were refused until the port had fsspec stores; they
    now ride with the target store (to fsspec, for a store that is not a
    local path), and a local store ignores them, as in the JAX package."""
    from cubed_tpu.core.ops import blockwise as ref_blockwise
    from cubed_tpu_torch.core.ops import blockwise

    rs, ps = _specs(tmp_path)
    a = cubed_tpu_torch.from_array(np.arange(4.0), chunks=(2,), spec=ps)
    out = blockwise(lambda x: x, "i", a, "i", dtype=np.float64, storage_options={"anon": True})
    assert out.zarray_maybe_lazy.storage_options == {"anon": True}
    r = ref_blockwise(lambda x: x, "i", cubed_tpu.from_array(np.arange(4.0), chunks=(2,), spec=rs), "i",
                      dtype=np.float64, storage_options={"anon": True})
    assert r.zarray_maybe_lazy.storage_options == out.zarray_maybe_lazy.storage_options
    cubed_tpu_torch.to_zarr(a, str(tmp_path / "x.zarr"), storage_options={"anon": True})
    np.testing.assert_array_equal(open_zarr_array(str(tmp_path / "x.zarr"), "r")[...], np.arange(4.0))
    # None and empty options are a local store's
    blockwise(lambda x: x, "i", a, "i", dtype=np.float64, storage_options={})


def test_multi_output_target_store_must_be_a_list(tmp_path):
    from cubed_tpu_torch.core.ops import _alloc_output_names_stores

    ps = _specs(tmp_path)[1]
    with pytest.raises(TypeError, match="list"):
        _alloc_output_names_stores([np.float64, np.int64], ps, "one.zarr")
    multi, names, stores = _alloc_output_names_stores([np.float64, np.int64], ps, ["a.zarr", "b.zarr"])
    assert multi and len(names) == 2 and stores == ["a.zarr", "b.zarr"]


@pytest.mark.parametrize("compressor", [None, {"id": "zlib", "level": 1}], ids=["raw", "zlib"])
def test_to_zarr_and_store_do_not_read_the_result_back(tmp_path, compressor):
    """The user's store is the result: no chunk of it is read after the
    compute (the device executor reads nothing at all here)."""
    from cubed_tpu_torch.observability.metrics import get_registry

    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "work"), allowed_mem="500MB", reserved_mem=0)
    a = cubed_tpu_torch.from_array(np.arange(120.0).reshape(10, 12), chunks=(4, 5), spec=spec)
    before = get_registry().snapshot()
    cubed_tpu_torch.to_zarr(pxp.add(a, 1.0), str(tmp_path / "a.zarr"), executor=CudaExecutor(),
                            compressor=compressor)
    cubed_tpu_torch.store(pxp.add(a, 2.0), str(tmp_path / "b.zarr"), executor=CudaExecutor())
    delta = get_registry().snapshot_delta(before)
    assert delta.get("bytes_read", 0) == 0 and delta.get("chunks_read", 0) == 0
    assert delta["chunks_written"] == 2 * 9
    np.testing.assert_array_equal(open_zarr_array(str(tmp_path / "b.zarr"), "r")[...],
                                  np.arange(120.0).reshape(10, 12) + 2.0)
