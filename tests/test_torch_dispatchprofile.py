"""The port's dispatch profiler (``cubed_tpu_torch/observability/
dispatchprofile.py``): the counterparts of
tests/observability/test_dispatchprofile.py, plus the port's own thread
rules (its sampler threads and any thread without a ``threading`` entry,
as torch's runtime threads are, are not the control plane) and the
"dispatch profile" lane of a device-executor compute, whose merged trace
has the same lanes as the JAX package's ``JaxExecutor`` compute armed the
same way. Every case that starts a sampler stops it in a ``finally``."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import _thread  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
from cubed_tpu.observability import TraceCollector as RefTraceCollector  # noqa: E402
from cubed_tpu.observability import dispatchprofile as ref_dp  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.diagnose import render_report  # noqa: E402
from cubed_tpu_torch.observability import TraceCollector, dispatchprofile  # noqa: E402
from cubed_tpu_torch.observability.dispatchprofile import (  # noqa: E402
    DispatchProfiler,
    TimedLock,
    profile_for,
    profile_scoped,
    register_profile,
)
from cubed_tpu_torch.observability.flightrecorder import FlightRecorder, load_bundle  # noqa: E402
from cubed_tpu_torch.observability.metrics import get_registry  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor  # noqa: E402

PROFILER_THREAD = "dispatch-profiler"


def _profiler_threads() -> list:
    return [t for t in threading.enumerate() if t.name == PROFILER_THREAD]


def test_profile_enabled_precedence(monkeypatch):
    assert dispatchprofile.PROFILE_ENV_VAR == "CUBED_TPU_TORCH_DISPATCH_PROFILE"
    for mod, pkg in ((ref_dp, cubed_tpu), (dispatchprofile, ct)):
        monkeypatch.delenv(mod.PROFILE_ENV_VAR, raising=False)
        got = [mod.profile_enabled(), mod.profile_enabled(pkg.Spec()),
               mod.profile_enabled(pkg.Spec(dispatch_profile=True)),
               mod.profile_enabled(pkg.Spec(dispatch_profile=False))]
        monkeypatch.setenv(mod.PROFILE_ENV_VAR, "1")
        got.append(mod.profile_enabled(pkg.Spec(dispatch_profile=False)))
        monkeypatch.setenv(mod.PROFILE_ENV_VAR, "0")
        got.append(mod.profile_enabled(pkg.Spec(dispatch_profile=True)))
        monkeypatch.delenv(mod.PROFILE_ENV_VAR)
        assert got == [False, False, True, False, True, False]


def test_off_is_a_true_noop(monkeypatch, tmp_path):
    monkeypatch.delenv(dispatchprofile.PROFILE_ENV_VAR, raising=False)
    with profile_scoped(ct.Spec(), "c-noop-unit") as prof:
        assert prof is None
        assert not _profiler_threads()
    assert profile_for("c-noop-unit") is None
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    an = np.arange(16.0).reshape(4, 4)
    a = ct.from_array(an, chunks=(2, 2), spec=spec)
    seen = []

    def spy(x):
        seen.extend(_profiler_threads())
        return x + 1.0

    r = ct.map_blocks(spy, ct.map_blocks(lambda x: x + 1.0, a, dtype=np.float64), dtype=np.float64)
    np.testing.assert_array_equal(np.asarray(r.compute(executor=AsyncPythonDagExecutor())), an + 2.0)
    assert not seen, "profiler thread ran on an unarmed compute"


def test_profiler_samples_and_folded_format():
    prof = DispatchProfiler(hz=200.0).start()
    try:
        deadline = time.time() + 0.5
        while time.time() < deadline and prof.samples == 0:
            sum(range(2000))
    finally:
        prof.stop()
    assert prof.samples > 0
    lines = prof.folded_lines()
    assert lines
    for line in lines:
        stack, count = line.rsplit(" ", 1)
        assert int(count) >= 1 and ";" in stack
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in lines]
    assert counts == sorted(counts, reverse=True)
    top = prof.top_stacks(3)
    assert top and sum(s["fraction"] for s in prof.top_stacks(10_000)) <= 1.01
    assert all({"thread", "leaf", "count"} <= set(s) for s in top)
    lane = prof.lane_samples()
    assert len(lane) <= dispatchprofile.MAX_LANE_SAMPLES
    assert all(isinstance(ts, float) and ": " in label for ts, label in lane)
    summ = prof.summary()
    assert summ["samples"] == prof.samples and summ["duration_s"] is not None
    assert set(summ) == set(ref_dp.DispatchProfiler().summary())
    prof.stop()


def test_folded_stack_cap_counts_overflow(monkeypatch):
    prof = DispatchProfiler()
    monkeypatch.setattr(dispatchprofile, "MAX_FOLDED_STACKS", 2)
    prof._folded = {"t;a": 1, "t;b": 1}
    reg = get_registry()
    before = reg.snapshot()
    prof._sample_once(own_tid=-1)
    assert prof.overflow >= 1
    assert len(prof._folded) == 2
    assert reg.snapshot_delta(before).get("dispatch_profile_overflow", 0) >= 1
    prof._folded["t;a"] = 5
    assert prof.folded()["t;a"] == 5


def test_register_profile_is_bounded():
    assert dispatchprofile.MAX_KEPT_PROFILES == ref_dp.MAX_KEPT_PROFILES
    for i in range(dispatchprofile.MAX_KEPT_PROFILES + 3):
        register_profile(f"c-bound-{i}", DispatchProfiler())
    assert profile_for("c-bound-0") is None
    assert profile_for(f"c-bound-{dispatchprofile.MAX_KEPT_PROFILES + 2}") is not None
    assert profile_for(None) is None


def test_timed_lock_measures_contended_wait_only():
    lock = TimedLock()
    reg = get_registry()
    before = reg.snapshot()
    lock.reset_thread_wait()
    with lock:
        pass
    assert lock.thread_wait_s() == 0.0
    hold, held, acquired = threading.Event(), threading.Event(), threading.Event()

    def holder():
        with lock:
            held.set()
            hold.wait(2.0)

    def waiter():
        with lock:
            acquired.set()

    t = threading.Thread(target=holder)
    t.start()
    w = threading.Thread(target=waiter)
    try:
        assert held.wait(2.0)
        lock.reset_thread_wait()
        w.start()
        time.sleep(0.05)
    finally:
        hold.set()
        t.join(2.0)
    assert acquired.wait(2.0)
    w.join(2.0)
    assert lock.thread_wait_s() == 0.0
    assert reg.snapshot_delta(before).get("dispatch_lock_wait_s", 0) > 0
    cond = threading.Condition(TimedLock())
    with cond:
        cond.notify_all()


def test_sampler_skips_the_port_threads_and_threads_without_a_threading_entry():
    """The memory guard's sampler, the repair pool, the telemetry threads
    and a thread started below ``threading`` (as torch's runtime starts
    its own) never appear in the folded stacks; the main thread does."""
    stop = threading.Event()
    raw_running = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(500))

    def raw():
        raw_running.set()
        spin()

    named = [threading.Thread(target=spin, name=n, daemon=True)
             for n in ("mem-guard-sampler", "chunk-repair_0", "telemetry-sampler", "telemetry-http")]
    for t in named:
        t.start()
    _thread.start_new_thread(raw, ())
    prof = DispatchProfiler(hz=200.0)
    try:
        assert raw_running.wait(2.0)
        for _ in range(20):
            prof._sample_once(own_tid=-1)
    finally:
        stop.set()
        for t in named:
            t.join(2.0)
    threads = {stack.split(";", 1)[0] for stack in prof.folded()}
    assert "MainThread" in threads
    assert not threads & {t.name for t in named}
    assert not any(name.startswith("thread-") for name in threads)


def test_armed_compute_bundles_folded_profile_and_diagnose(monkeypatch, tmp_path):
    monkeypatch.setenv(dispatchprofile.PROFILE_ENV_VAR, "1")
    spec = ct.Spec(work_dir=str(tmp_path / "work"), allowed_mem="500MB")
    an = np.arange(16.0).reshape(4, 4)
    a = ct.from_array(an, chunks=(2, 2), spec=spec)

    def slow(x):
        time.sleep(0.03)
        return x + 1.0

    r = ct.map_blocks(slow, a, dtype=np.float64)
    fr = FlightRecorder(bundle_dir=str(tmp_path / "bundles"), always=True)
    val = np.asarray(r.compute(executor=AsyncPythonDagExecutor(), callbacks=[fr]))
    np.testing.assert_array_equal(val, an + 1.0)
    prof = profile_for(fr.compute_id)
    assert prof is not None and prof._thread is None and prof.samples > 0
    bundle_path = fr.dump()
    with open(f"{bundle_path}/profile-{fr.compute_id}.folded") as f:
        lines = [ln for ln in f.read().splitlines() if ln]
    assert lines == prof.folded_lines()
    bundle = load_bundle(bundle_path)
    summ = bundle["manifest"].get("dispatch_profile")
    assert summ and summ["samples"] == prof.samples
    report = render_report(bundle)
    assert "dispatch (coordinator self-profile" in report
    assert f"profile-{fr.compute_id}.folded" in report


def test_device_executor_compute_has_the_reference_lanes(monkeypatch, tmp_path):
    """An armed compute on ``CudaExecutor`` (chunks on the CPU) and on the
    reference's ``JaxExecutor``: the merged traces carry the same lanes,
    a "dispatch profile" lane among them. Both run with the memory guard
    off: a guard variable an earlier test left in the environment (which
    outranks the Spec) is cleared, as the guard's own tests clear it."""
    from cubed_tpu.runtime import memory as ref_memory
    from cubed_tpu_torch.runtime import memory

    monkeypatch.delenv(ref_memory.MEMORY_GUARD_ENV_VAR, raising=False)
    monkeypatch.delenv(memory.MEMORY_GUARD_ENV_VAR, raising=False)
    lanes = []
    for mod, pkg, col_cls, ex in ((ref_dp, cubed_tpu, RefTraceCollector, JaxExecutor()),
                                  (dispatchprofile, ct, TraceCollector, CudaExecutor())):
        monkeypatch.setenv(mod.PROFILE_ENV_VAR, "1")
        spec = pkg.Spec(work_dir=str(tmp_path / pkg.__name__), allowed_mem="500MB", memory_guard="off")
        a = pkg.from_array(np.arange(64.0).reshape(8, 8), chunks=(4, 4), spec=spec)

        def slow(x):
            time.sleep(0.05)
            return x * 2.0

        r = pkg.map_blocks(slow, a, dtype=np.float64)
        col = col_cls(trace_dir=None)
        np.testing.assert_array_equal(np.asarray(r.compute(executor=ex, callbacks=[col])),
                                      np.arange(64.0).reshape(8, 8) * 2.0)
        events = col.merged_tracer().chrome_events()
        lanes.append({e["args"]["name"] for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"})
        monkeypatch.delenv(mod.PROFILE_ENV_VAR)
    assert "dispatch profile" in lanes[1]
    assert lanes[1] == lanes[0]
