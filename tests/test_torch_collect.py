"""The port's ``TraceCollector`` and task-scope spans
(``cubed_tpu_torch/observability/{collect,accounting}.py``,
``runtime/utils.py:execute_with_stats``): the counterparts of
tests/observability/test_collect.py that need no fleet, driven with
synthetic events so every edge is deterministic. Worker names and pids here
stand for another process's tasks, whose clock the collector aligns."""

import json
import logging
import os
import pickle
import time

import pytest

from cubed_tpu_torch.core.plan import Dag
from cubed_tpu_torch.observability import accounting
from cubed_tpu_torch.observability.accounting import task_scope
from cubed_tpu_torch.observability.collect import (
    TraceCollector,
    decisions_since,
    oob_tasks_since,
    record_decision,
    record_failed_task,
    record_repair_spans,
    record_sample,
    samples_since,
)
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime.types import ComputeEndEvent, ComputeStartEvent, TaskEndEvent
from cubed_tpu_torch.runtime.utils import execute_with_stats


def _start_event(compute_id="c-test"):
    return ComputeStartEvent(Dag(), compute_id=compute_id)


def _task_event(op="op-a", chunk="0.0", start=None, end=None, pid=None, worker=None, spans=None,
                spans_dropped=None, result=None):
    now = time.time()
    return TaskEndEvent(
        array_name=op,
        chunk_key=chunk,
        function_start_tstamp=start if start is not None else now - 0.01,
        function_end_tstamp=end if end is not None else now,
        task_result_tstamp=result,
        pid=pid,
        worker=worker,
        spans=spans,
        spans_dropped=spans_dropped,
    )


def _events_by_lane(doc):
    meta = {e["tid"]: e["args"]["name"] for e in doc if e.get("ph") == "M"}
    out: dict = {}
    for e in doc:
        if e.get("ph") != "M":
            out.setdefault(meta.get(e.get("tid")), []).append(e)
    return out


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------


def test_handshake_offset_aligns_worker_spans():
    """Spans from a worker whose clock is 5 s behind land on the client
    timeline when the executor stats carry its handshake offset."""
    col = TraceCollector(trace_dir=None)
    col.on_compute_start(_start_event())
    now = time.time()
    skew = -5.0
    span = {"name": "storage_read", "ts": now + skew - 0.008, "dur": 0.005, "cat": "storage"}
    col.on_task_end(_task_event(start=now + skew - 0.01, end=now + skew, pid=12345, worker="w1",
                                spans=[span], result=now))
    col.on_compute_end(ComputeEndEvent(
        Dag(), executor_stats={"workers": {"w1": {"clock_offset": 5.0, "clock_rtt": 0.002}}}))
    offs = col.clock_offsets()
    assert offs["w1"] == {"offset": 5.0, "rtt": 0.002, "source": "handshake"}
    events = col.merged_tracer().events
    task = next(e for e in events if e["cat"] == "task")
    sub = next(e for e in events if e["cat"] == "storage")
    assert abs(task["ts"] - (now - 0.01)) < 0.01
    assert abs(sub["ts"] - (now - 0.008)) < 0.01
    assert task["lane"] == "worker w1" and sub["lane"] == "worker w1"


def test_latency_estimate_aligns_unlabelled_remote_process():
    col = TraceCollector(trace_dir=None)
    col.on_compute_start(_start_event())
    now = time.time()
    for i in range(5):
        col.on_task_end(_task_event(chunk=str(i), start=now - 3.01, end=now - 3.0, pid=99999,
                                    result=now + 0.001 * i))
    col.on_compute_end(ComputeEndEvent(Dag()))
    offs = col.clock_offsets()
    assert offs["pid-99999"]["source"] == "latency"
    assert offs["pid-99999"]["offset"] == pytest.approx(3.0, abs=0.05)


def test_same_clock_latency_noise_is_not_treated_as_skew():
    col = TraceCollector(trace_dir=None)
    col.on_compute_start(_start_event())
    now = time.time()
    col.on_task_end(_task_event(start=now - 0.01, end=now, pid=99999, result=now + 0.004))
    col.on_compute_end(ComputeEndEvent(Dag()))
    assert col.clock_offsets()["pid-99999"] == {"offset": 0.0, "source": "local"}


def test_client_pid_needs_no_offset():
    col = TraceCollector(trace_dir=None)
    col.on_compute_start(_start_event())
    col.on_task_end(_task_event(pid=os.getpid()))
    assert col.clock_offsets() == {"client": {"offset": 0.0, "source": "local"}}


def test_skewed_worker_spans_order_correctly_after_alignment():
    col = TraceCollector(trace_dir=None)
    col.on_compute_start(_start_event())
    now = time.time()
    rtt = 0.004
    # true order: w1's task ran 0-10 ms, w2's 20-30 ms; their raw stamps
    # order them the other way around
    col.on_task_end(_task_event(chunk="a", start=now + 2.0, end=now + 2.01, worker="w1", result=now + 0.012))
    col.on_task_end(_task_event(chunk="b", start=now - 2.98, end=now - 2.97, worker="w2", result=now + 0.032))
    col.on_compute_end(ComputeEndEvent(Dag(), executor_stats={"workers": {
        "w1": {"clock_offset": -2.0, "clock_rtt": rtt}, "w2": {"clock_offset": 3.0, "clock_rtt": rtt}}}))
    by_chunk = {e["args"]["chunk"]: e for e in col.merged_tracer().events if e["cat"] == "task"}
    assert by_chunk["a"]["ts"] + by_chunk["a"]["dur"] <= by_chunk["b"]["ts"] + rtt


# ---------------------------------------------------------------------------
# bounded buffers
# ---------------------------------------------------------------------------


def test_task_scope_span_buffer_is_bounded():
    with task_scope() as scope:
        for i in range(accounting.MAX_TASK_SPANS + 25):
            scope.add_span(f"s{i}", 0.0, 1.0)
    assert len(scope.spans) == accounting.MAX_TASK_SPANS
    assert scope.spans_dropped == 25
    stats = scope.stats()
    assert stats["spans_dropped"] == 25 and len(stats["spans"]) == accounting.MAX_TASK_SPANS


def test_spans_dropped_reaches_the_metrics_registry():
    before = get_registry().counter("spans_dropped").value
    col = TraceCollector(trace_dir=None)
    col.on_compute_start(_start_event())
    col.on_task_end(_task_event(spans_dropped=7))
    assert get_registry().counter("spans_dropped").value == before + 7


def test_task_record_retention_is_bounded_and_counted():
    col = TraceCollector(trace_dir=None, max_task_records=3)
    col.on_compute_start(_start_event())
    for i in range(5):
        col.on_task_end(_task_event(chunk=str(i)))
    assert len(col._records) == 3
    assert col.records_dropped == 2


def test_scope_span_records_error_and_noops_without_scope():
    with accounting.spans_scoped(True):
        with accounting.scope_span("outside"):  # no scope: nothing recorded
            pass
        with task_scope() as scope:
            with pytest.raises(ValueError):
                with accounting.scope_span("fails", cat="storage"):
                    raise ValueError("boom")
    assert len(scope.spans) == 1
    span = scope.spans[0]
    assert span["name"] == "fails" and span["cat"] == "storage"
    assert span["attrs"] == {"error": True, "error_type": "ValueError"}


def test_scope_span_records_nothing_while_disarmed():
    assert not accounting.spans_enabled()
    with task_scope() as scope:
        with accounting.scope_span("storage_read", cat="storage"):
            pass
    assert scope.spans == [] and scope.spans_dropped == 0
    with accounting.spans_scoped(True):
        assert accounting.spans_enabled()
        with task_scope() as scope:
            with accounting.scope_span("storage_read", cat="storage"):
                pass
        assert [s["name"] for s in scope.spans] == ["storage_read"]
    assert not accounting.spans_enabled()


def test_spans_env_var_wins_over_scoped_arming(monkeypatch):
    assert accounting.SPANS_ENV_VAR == "CUBED_TPU_TORCH_TASK_SPANS"
    monkeypatch.setenv(accounting.SPANS_ENV_VAR, "1")
    assert accounting.spans_enabled()
    monkeypatch.setenv(accounting.SPANS_ENV_VAR, "0")
    with accounting.spans_scoped(True, export_env=True):
        # the operator's explicit off wins over programmatic arming, and the
        # scope leaves it untouched
        assert not accounting.spans_enabled()
        assert os.environ[accounting.SPANS_ENV_VAR] == "0"
    monkeypatch.delenv(accounting.SPANS_ENV_VAR)
    with accounting.spans_scoped(True, export_env=True):
        assert os.environ[accounting.SPANS_ENV_VAR] == "1"  # for child processes
    assert accounting.SPANS_ENV_VAR not in os.environ


# ---------------------------------------------------------------------------
# straggler watch
# ---------------------------------------------------------------------------


def test_live_straggler_watch_counts_and_records(caplog):
    before = get_registry().counter("stragglers_detected").value
    col = TraceCollector(trace_dir=None, straggler_factor=3.0, straggler_min_s=0.05, straggler_min_tasks=5)
    col.on_compute_start(_start_event())
    now = time.time()
    for i in range(6):
        col.on_task_end(_task_event(chunk=str(i), start=now, end=now + 0.02))
    with caplog.at_level(logging.WARNING, logger="cubed_tpu_torch"):
        col.on_task_end(_task_event(chunk="slow", start=now, end=now + 1.0))
    assert get_registry().counter("stragglers_detected").value == before + 1
    assert any("straggler" in r.message for r in caplog.records)
    assert any(d["kind"] == "straggler" and d["chunk"] == "slow" for d in decisions_since(now - 1))
    rows = col.stragglers()
    assert rows and rows[0]["chunk"] == "slow" and rows[0]["factor"] > 3.0


def test_fast_ops_produce_no_stragglers():
    before = get_registry().counter("stragglers_detected").value
    col = TraceCollector(trace_dir=None)
    col.on_compute_start(_start_event())
    now = time.time()
    for i in range(20):
        col.on_task_end(_task_event(chunk=str(i), start=now, end=now + 0.01))
    assert get_registry().counter("stragglers_detected").value == before
    assert col.stragglers() == []


# ---------------------------------------------------------------------------
# merged export
# ---------------------------------------------------------------------------


def test_export_merges_decisions_and_samples_and_is_loadable(tmp_path):
    col = TraceCollector(trace_dir=str(tmp_path))
    col.on_compute_start(_start_event("c-exp"))
    record_decision("cuda_segment_mem_abort", segment="op-a,op-b")
    record_sample(rss=123456789, pressure=1)
    record_sample(rss=5, worker="w1")
    col.on_task_end(_task_event(spans=[{"name": "kernel_apply", "ts": time.time(), "dur": 0.001,
                                        "cat": "kernel"}]))
    col.on_compute_end(ComputeEndEvent(Dag()))
    assert col.trace_path == str(tmp_path / "trace-c-exp.json")
    lanes = _events_by_lane(json.load(open(col.trace_path))["traceEvents"])
    scheduler = lanes.get("scheduler", [])
    assert any(e["name"] == "cuda_segment_mem_abort" and e["args"]["segment"] == "op-a,op-b"
               for e in scheduler)
    assert any(e["ph"] == "C" and e["name"] == "rss_bytes" for e in lanes.get("memory", []))
    assert any(e["ph"] == "C" and e["name"] == "mem_pressure" for e in lanes.get("memory", []))
    assert [e["args"]["value"] for e in lanes.get("memory w1", [])] == [5]
    client = lanes.get("client tasks", [])
    assert any(e.get("cat") == "kernel" for e in client)
    assert any(e.get("cat") == "task" for e in client)
    assert samples_since(0)


def test_execute_with_stats_ships_spans_pid_and_worker_label():
    def body(m):
        with accounting.scope_span("storage_read", cat="storage", key="0.0"):
            pass
        return m

    accounting.set_process_label("test-worker")
    try:
        with accounting.spans_scoped(True):
            result, stats = execute_with_stats(body, ("op-x", 0, 0))
    finally:
        accounting.set_process_label(None)
    assert result == ("op-x", 0, 0)
    assert stats["pid"] == os.getpid()
    assert stats["worker"] == "test-worker"
    assert [s["name"] for s in stats["spans"]] == ["storage_read"]
    assert stats["spans_dropped"] == 0
    assert stats["function_end_tstamp"] >= stats["function_start_tstamp"]
    assert stats["peak_measured_mem_end"] >= stats["peak_measured_mem_start"] > 0
    TaskEndEvent(array_name="op-x", **stats)  # the stats dict builds an event


def test_failed_task_spans_ride_the_exception_to_the_trace(tmp_path):
    def body(m):
        with accounting.scope_span("storage_read", cat="storage", key="0.0"):
            pass
        raise OSError("disk on fire")

    with accounting.spans_scoped(True):
        with pytest.raises(OSError) as excinfo:
            execute_with_stats(body, ("op-f", 0, 0))
    stats = excinfo.value.cubed_tpu_torch_task_stats
    assert stats["error_type"] == "OSError"
    assert [s["name"] for s in stats["spans"]] == ["storage_read"]
    assert stats["function_end_tstamp"] >= stats["function_start_tstamp"]
    exc = pickle.loads(pickle.dumps(excinfo.value))  # how it crosses a process
    assert exc.cubed_tpu_torch_task_stats["spans"]

    col = TraceCollector(trace_dir=str(tmp_path))
    col.on_compute_start(_start_event("c-fail"))
    record_failed_task("op-f", "(op-f, 0, 0)", 0, exc)
    col.on_compute_end(ComputeEndEvent(Dag()))
    client = _events_by_lane(json.load(open(col.trace_path))["traceEvents"]).get("client tasks", [])
    failed = [e for e in client if e.get("cat") == "task" and e["args"].get("error")]
    assert failed and failed[0]["args"]["error_type"] == "OSError"
    assert any(e["name"] == "storage_read" for e in client)


def test_unobserved_failed_task_carries_no_stats():
    def body(m):
        raise OSError("x")

    with pytest.raises(OSError) as excinfo:
        execute_with_stats(body, ("op-g", 0))
    assert not hasattr(excinfo.value, "cubed_tpu_torch_task_stats")


def test_failed_task_without_stats_is_a_noop():
    t0 = time.time()
    record_failed_task("op-none", "0.0", 0, ValueError("no stats attached"))
    assert [t for t in oob_tasks_since(t0) if t["op"] == "op-none"] == []


def test_repair_spans_reach_the_merged_trace(tmp_path):
    col = TraceCollector(trace_dir=str(tmp_path))
    col.on_compute_start(_start_event("c-rep"))
    with accounting.spans_scoped(True):
        with task_scope() as scope:
            with accounting.scope_span("recompute_repair", cat="repair", chunk="0.0"):
                pass
    record_repair_spans("0.0", "/store/x", scope.stats())
    col.on_compute_end(ComputeEndEvent(Dag()))
    client = _events_by_lane(json.load(open(col.trace_path))["traceEvents"]).get("client tasks", [])
    assert any(e["name"] == "recompute_repair" and e.get("cat") == "repair" for e in client)


def _drive_collector(collect_mod, types_mod, dag, now):
    """The same synthetic compute through one package's collector: tasks
    of a skewed worker (handshake), of another process (latency), of this
    process with sub-spans, a dropped-span count and a decision."""
    col = collect_mod.TraceCollector(trace_dir=None)
    col.on_compute_start(types_mod.ComputeStartEvent(dag, compute_id="c-parity"))
    span = {"name": "storage_read", "ts": now - 5.008, "dur": 0.005, "cat": "storage", "attrs": {"bytes": 8}}
    events = [
        dict(array_name="op-a", chunk_key="0.0", function_start_tstamp=now - 5.01, function_end_tstamp=now - 5.0,
             task_result_tstamp=now, pid=12345, worker="w1", spans=[span]),
        dict(array_name="op-a", chunk_key="0.1", function_start_tstamp=now - 3.01, function_end_tstamp=now - 3.0,
             task_result_tstamp=now + 0.001, pid=99999),
        dict(array_name="op-b", chunk_key="1", function_start_tstamp=now - 0.02, function_end_tstamp=now - 0.01,
             pid=os.getpid(), spans=[dict(span, name="kernel_apply", cat="kernel", ts=now - 0.015)],
             spans_dropped=2),
    ]
    for e in events:
        col.on_task_end(types_mod.TaskEndEvent(**e))
    collect_mod.record_decision("parity_decision", op="op-a")
    col.on_compute_end(types_mod.ComputeEndEvent(
        dag, executor_stats={"workers": {"w1": {"clock_offset": 5.0, "clock_rtt": 0.002}}}))
    merged = [e for e in col.merged_tracer().events if e["cat"] not in ("compute", "operation")]
    return col.clock_offsets(), merged


def test_merged_trace_and_offsets_equal_the_reference_collectors():
    import networkx as nx

    from cubed_tpu.observability import collect as reference_collect
    from cubed_tpu.runtime import types as reference_types
    from cubed_tpu_torch.observability import collect as port_collect
    from cubed_tpu_torch.runtime import types as port_types

    now = time.time()
    ours = _drive_collector(port_collect, port_types, Dag(), now)
    theirs = _drive_collector(reference_collect, reference_types, nx.MultiDiGraph(), now)
    assert ours[0] == theirs[0]
    # the decision instants carry each package's own compute id (none here)
    # and are stamped by each package's clock: compare what they say
    strip = [({k: v for k, v in e.items() if k != "ts"} if e["cat"] == "instant" else e) for e in ours[1]]
    assert strip == [({k: v for k, v in e.items() if k != "ts"} if e["cat"] == "instant" else e)
                     for e in theirs[1]]
    assert {e["cat"] for e in ours[1]} == {"task", "storage", "kernel", "instant"}
