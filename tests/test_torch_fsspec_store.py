"""fsspec stores in the port (``cubed_tpu_torch/storage/store.py:_FsspecIO``):
the two fsspec cases of tests/storage/test_store.py on ``memory://``, the
same store read by the JAX package (``memory://`` is one filesystem per
process), ``storage_options`` carried from the caller and the spec to every
store of a plan, and a remote URL refused, with no fallback to a local path,
where fsspec is missing (as on the card's machine)."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import sys  # noqa: E402
import uuid  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as xp  # noqa: E402
from cubed_tpu.storage.store import open_zarr_array as ref_open_zarr_array  # noqa: E402
from cubed_tpu_torch.storage.store import open_zarr_array  # noqa: E402

pytest.importorskip("fsspec")


def test_fsspec_memory_store_roundtrip():
    """The _FsspecIO path (s3://, gs://, ... in production) via memory://."""
    store = f"memory://zarr-{uuid.uuid4().hex}"
    z = open_zarr_array(store, "w", shape=(5, 6), dtype=np.float64, chunks=(2, 3),
                        compressor={"id": "zlib", "level": 1})
    an = np.arange(30.0).reshape(5, 6)
    z[...] = an
    np.testing.assert_array_equal(z[...], an)
    z2 = open_zarr_array(store, "r")
    np.testing.assert_array_equal(z2[...], an)
    assert z2.nchunks_initialized == z2.nchunks
    # the JAX package reads the port's store, and the port the JAX package's
    np.testing.assert_array_equal(ref_open_zarr_array(store, "r")[...], an)
    theirs = f"memory://zarr-{uuid.uuid4().hex}"
    ref_open_zarr_array(theirs, "w", shape=(5, 6), dtype=np.float64, chunks=(2, 3))[...] = an * 2
    np.testing.assert_array_equal(open_zarr_array(theirs, "r")[...], an * 2)


def test_fsspec_memory_workdir_end_to_end():
    """A whole plan with its work_dir on an fsspec store (single-process
    executors only: memory:// is per-process), on the sequential, threaded
    and device executors, and a rechunk through an intermediate store."""
    from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
    from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor

    spec = ct.Spec(work_dir=f"memory://work-{uuid.uuid4().hex}", allowed_mem="500MB")
    an = np.arange(64.0).reshape(8, 8)
    a = ct.from_array(an, chunks=(3, 3), spec=spec)
    total = xp.sum(xp.multiply(a, 3.0))
    for ex in (None, AsyncPythonDagExecutor(max_workers=2), CudaExecutor()):
        assert float(total.compute(executor=ex)) == 3 * an.sum()
    np.testing.assert_array_equal(xp.add(a, 1.0).rechunk((8, 1)).compute(), an + 1)


def test_to_zarr_and_from_zarr_on_memory_with_storage_options():
    spec = ct.Spec(work_dir=f"memory://work-{uuid.uuid4().hex}", allowed_mem="500MB")
    an = np.arange(48.0).reshape(6, 8)
    out = f"memory://out-{uuid.uuid4().hex}"
    ct.to_zarr(xp.add(ct.from_array(an, chunks=(3, 4), spec=spec), 1.0), out, storage_options={},
               compressor={"id": "zlib", "level": 1})
    np.testing.assert_array_equal(ref_open_zarr_array(out, "r")[...], an + 1)
    np.testing.assert_array_equal(ct.from_zarr(out, storage_options={}).compute(), an + 1)


def test_storage_options_reach_every_store_of_the_plan(tmp_path):
    from cubed_tpu_torch.core.ops import blockwise

    opts = {"skip_instance_cache": True}
    spec = ct.Spec(work_dir=f"memory://work-{uuid.uuid4().hex}", allowed_mem="500MB", storage_options=opts)
    assert spec.storage_options == opts and spec != ct.Spec(work_dir=spec.work_dir, allowed_mem="500MB")
    a = ct.from_array(np.arange(16.0).reshape(4, 4), chunks=(2, 2), spec=spec)
    b = xp.multiply(a, 2.0)
    assert b.zarray_maybe_lazy.storage_options == opts
    assert b.rechunk((4, 1)).zarray_maybe_lazy.storage_options == opts
    mine = {"skip_instance_cache": False}
    c = blockwise(lambda x: x, "ij", a, "ij", dtype=np.float64, storage_options=mine)
    assert c.zarray_maybe_lazy.storage_options == mine
    np.testing.assert_array_equal(b.compute(), np.arange(16.0).reshape(4, 4) * 2)


def test_remote_url_without_fsspec_raises_rather_than_falls_back(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "fsspec", None)
    monkeypatch.chdir(tmp_path)
    url = "s3://bucket/array.zarr"
    with pytest.raises(ImportError, match="fsspec") as info:
        open_zarr_array(url, "w", shape=(2,), dtype=np.float64, chunks=(1,))
    assert url in str(info.value)
    with pytest.raises(ImportError, match="fsspec"):
        ct.from_zarr(url)
    assert os.listdir(tmp_path) == []  # nothing written to a local path
