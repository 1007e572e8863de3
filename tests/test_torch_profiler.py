"""The port's device profiler callbacks
(``cubed_tpu_torch/observability/profiler.py``): the counterparts of
tests/observability/test_profiler.py with ``torch.profiler`` in place of
``jax.profiler``, a real CPU session's trace, and parity with the JAX
package's ``DeviceMemoryCallback`` on one plan."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json  # noqa: E402
import random  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.observability.profiler import DeviceMemoryCallback as ReferenceDeviceMemoryCallback  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.observability import profiler as profiler_module  # noqa: E402
from cubed_tpu_torch.observability.collect import decisions_since  # noqa: E402
from cubed_tpu_torch.observability.profiler import DeviceMemoryCallback, TorchProfilerCallback  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402


def test_extensions_import_path_is_a_shim():
    from cubed_tpu_torch.extensions import profiler as shim

    assert shim.TorchProfilerCallback is TorchProfilerCallback
    assert shim.DeviceMemoryCallback is DeviceMemoryCallback


class _FakeProfile:
    """Stands in for ``torch.profiler.profile``, recording its calls."""

    def __init__(self, calls, activities):
        self.calls = calls
        calls.append(("init", tuple(activities)))

    def start(self):
        self.calls.append(("start", None))

    def stop(self):
        self.calls.append(("stop", None))

    def export_chrome_trace(self, path):
        self.calls.append(("export", path))
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_torch_profiler_callback_brackets_the_compute(monkeypatch, tmp_path, device):
    """The session starts at the compute's start and, after the device has
    synchronized (a CUDA device only), stops and writes its trace at the
    compute's end."""
    calls = []
    monkeypatch.setattr(torch.profiler, "profile", lambda activities: _FakeProfile(calls, activities))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(("synchronize", None)))
    monkeypatch.setattr(profiler_module, "get_device", lambda: torch.device(device))
    t0 = time.time()
    cb = TorchProfilerCallback(log_dir=str(tmp_path / "prof-dir"))
    cb.on_compute_start(types.SimpleNamespace(dag=None, compute_id="c-1"))
    assert cb._prof is not None
    cb.on_compute_end(types.SimpleNamespace(dag=None, compute_id="c-1"))
    assert cb._prof is None
    path = str(tmp_path / "prof-dir" / "trace-c-1.json")
    activities = (torch.profiler.ProfilerActivity.CPU,) + (
        (torch.profiler.ProfilerActivity.CUDA,) if device == "cuda" else ())
    assert calls == [("init", activities), ("start", None)] + (
        [("synchronize", None)] if device == "cuda" else []) + [("stop", None), ("export", path)]
    assert cb.trace_path == path
    kinds = [d["kind"] for d in decisions_since(t0)]
    assert "torch_profiler_start" in kinds and "torch_profiler_stop" in kinds


def test_torch_profiler_start_failure_is_swallowed(monkeypatch, tmp_path):
    class Refuses(_FakeProfile):
        def start(self):
            raise RuntimeError("no profiler here")

    calls = []
    monkeypatch.setattr(torch.profiler, "profile", lambda activities: Refuses(calls, activities))
    cb = TorchProfilerCallback(log_dir=str(tmp_path))
    cb.on_compute_start(types.SimpleNamespace(dag=None, compute_id="c-2"))
    assert cb._prof is None
    cb.on_compute_end(types.SimpleNamespace(dag=None, compute_id="c-2"))  # no stop, no raise
    assert [c[0] for c in calls] == ["init"]
    assert cb.trace_path is None and os.listdir(tmp_path) == []


def test_torch_profiler_callback_writes_a_cpu_trace_of_a_compute(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path / "work"), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(np.arange(64.0).reshape(8, 8), chunks=(4, 4), spec=spec)
    cb = TorchProfilerCallback(log_dir=str(tmp_path / "profile"))
    assert float(pxp.sum(a).compute(callbacks=[cb], executor=CudaExecutor())) == float(np.arange(64.0).sum())
    assert os.path.basename(cb.trace_path).startswith("trace-c-")
    events = json.load(open(cb.trace_path))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and e["name"].startswith("aten::") for e in events)


def test_device_memory_callback_samples_per_op(monkeypatch):
    monkeypatch.setattr(profiler_module, "get_device", lambda: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "allocated_bytes.all.current": 123, "allocated_bytes.all.peak": 456})
    t0 = time.time()
    cb = DeviceMemoryCallback()
    cb.on_operation_start(types.SimpleNamespace(name="op-a", num_tasks=4))
    assert cb.samples == [{"op": "op-a", "bytes_in_use": 123, "peak_bytes_in_use": 456}]
    assert any(d["kind"] == "device_memory" and d.get("op") == "op-a" for d in decisions_since(t0))


def test_device_memory_callback_tolerates_missing_stats(monkeypatch):
    def broken(dev):
        raise RuntimeError("no device")

    monkeypatch.setattr(profiler_module, "get_device", lambda: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "memory_stats", broken)
    cb = DeviceMemoryCallback()
    cb.on_operation_start(types.SimpleNamespace(name="op-b", num_tasks=1))
    assert cb.samples == [{"op": "op-b", "bytes_in_use": None, "peak_bytes_in_use": None}]


def test_device_memory_callback_on_the_cpu_reads_no_stats(monkeypatch):
    def never(dev):
        raise AssertionError("memory_stats read for a CPU device")

    monkeypatch.setattr(torch.cuda, "memory_stats", never)
    cb = DeviceMemoryCallback()
    cb.on_operation_start(types.SimpleNamespace(name="op-c", num_tasks=1))
    assert cb.samples == [{"op": "op-c", "bytes_in_use": None, "peak_bytes_in_use": None}]


def _vorticity(pkg, xp, spec):
    a, b, x, y = [pkg.random.random((20, 18, 16), chunks=8, spec=spec) for _ in range(4)]
    return xp.mean(xp.add(xp.multiply(a[1:], x[1:]), xp.multiply(b[1:], y[1:])))


def test_device_memory_samples_match_the_reference_op_for_op(tmp_path):
    """One sample per op, in the same order of op kinds, on JaxExecutor and
    CudaExecutor (both on the CPU: no device memory stats)."""
    samples = []
    for pkg, xp, cb, ex in ((cubed_tpu, rxp, ReferenceDeviceMemoryCallback(), JaxExecutor()),
                            (cubed_tpu_torch, pxp, DeviceMemoryCallback(), CudaExecutor())):
        spec = pkg.Spec(work_dir=str(tmp_path / pkg.__name__), allowed_mem="100MB")
        random.seed(3)
        arr = _vorticity(pkg, xp, spec)
        arr.compute(executor=ex, callbacks=[cb])
        # op names end in a counter of their own package: compare the kinds
        samples.append([(s["op"].rsplit("-", 1)[0], s["bytes_in_use"], s["peak_bytes_in_use"])
                        for s in cb.samples])
    assert samples[0] == samples[1]
    assert len(samples[1]) == arr.plan._finalize(array_names=(arr.name,)).num_ops()
