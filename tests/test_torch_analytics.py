"""The port's ANALYZE (``cubed_tpu_torch/observability/analytics.py``) and
``diagnose --analyze``: the counterparts of
tests/observability/test_analytics.py. A chain of four ``map_blocks`` with
one sleeping block runs on the threads executor of both packages (dataflow
and op-level schedulers) and the two reports are compared by structure:
the critical path's ops (by ``op_name``), its stragglers by chunk indices,
its source, the bottleneck named first, the tasks analyzed. Synthetic
bundles go through both packages' ``analyze`` and must give equal reports;
the device executor's one-event-per-op computes analyze as ``JaxExecutor``'s
do."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json  # noqa: E402
import re  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.observability import FlightRecorder as RefFlightRecorder  # noqa: E402
from cubed_tpu.observability import analytics as ref_analytics  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu.runtime.executors.python_async import AsyncPythonDagExecutor as RefAsync  # noqa: E402
from cubed_tpu_torch import diagnose  # noqa: E402
from cubed_tpu_torch.observability import FlightRecorder, TraceCollector, analyze  # noqa: E402
from cubed_tpu_torch.observability.analytics import BUCKETS, AnalysisReport, render_analysis  # noqa: E402
from cubed_tpu_torch.observability.flightrecorder import load_bundle  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor  # noqa: E402

STRAGGLER_SLEEP_S = 0.5
DEPTH = 4
STRAGGLER_DEPTH = 2
STRAGGLER_BLOCK = (0, 1)


class _Step:
    def __init__(self, depth):
        self.depth = depth

    def __call__(self, x, block_id=None):
        if self.depth == STRAGGLER_DEPTH and block_id == STRAGGLER_BLOCK:
            time.sleep(STRAGGLER_SLEEP_S)
        return x + 1.0


def _run_chain(tmp_path, pkg=ct, scheduler=None, recorder=None):
    executor = AsyncPythonDagExecutor() if pkg is ct else RefAsync()
    spec = pkg.Spec(work_dir=str(tmp_path / pkg.__name__), allowed_mem="2GB", scheduler=scheduler)
    an = np.arange(16, dtype=np.float64).reshape(4, 4)
    r = pkg.from_array(an, chunks=(2, 2), spec=spec)
    for d in range(DEPTH):
        r = pkg.map_blocks(_Step(d), r, dtype=np.float64)
    val = np.asarray(r.compute(executor=executor, callbacks=[recorder] if recorder is not None else None,
                               optimize_graph=False))
    np.testing.assert_array_equal(val, an + DEPTH)


def _canon(row) -> tuple:
    """(op kind, chunk indices) of a path row: node names and the chunk
    keys' array names are gensym'd per build."""
    return row["op"].rsplit("-", 1)[0], re.findall(r"\d+", str(row["chunk"]).rsplit("'", 1)[-1])


def _assert_straggler_named(report: AnalysisReport):
    d = report.to_dict()
    wall = d["wall_clock_s"]
    assert wall >= STRAGGLER_SLEEP_S * 0.9
    path_stragglers = [r for r in d["critical_path"] if r["straggler"]]
    assert path_stragglers, "straggler not on the critical path"
    s = max(path_stragglers, key=lambda r: r["duration_s"])
    assert s["duration_s"] >= STRAGGLER_SLEEP_S * 0.9
    assert f", {STRAGGLER_BLOCK[0]}, {STRAGGLER_BLOCK[1]})" in str(s["chunk"])
    assert d["bottlenecks"][0]["chunk"] == s["chunk"] and d["bottlenecks"][0]["op"] == s["op"]
    assert abs(sum(d["attribution"].values()) - wall) <= 0.10 * wall
    assert set(d["attribution"]) <= set(BUCKETS)
    assert d["attribution"]["straggler_excess"] >= STRAGGLER_SLEEP_S * 0.7


def _both_chains(tmp_path, scheduler):
    """The chain analyzed in both packages; (reference data, port report)."""
    ref = RefFlightRecorder(bundle_dir=str(tmp_path / "ref-fr"), always=True)
    _run_chain(tmp_path, cubed_tpu, scheduler, ref)
    fr = FlightRecorder(bundle_dir=str(tmp_path / "fr"), always=True)
    _run_chain(tmp_path, ct, scheduler, fr)
    r, p = ref_analytics.analyze(ref.bundle_path).to_dict(), analyze(fr.bundle_path)
    d = p.to_dict()
    assert d["critical_path_source"] == r["critical_path_source"]
    # the path's ops and its stragglers; which sibling chunk gated a
    # barrier-gated task is a matter of timing in either package
    assert [x["op"].rsplit("-", 1)[0] for x in d["critical_path"]] == \
        [x["op"].rsplit("-", 1)[0] for x in r["critical_path"]]
    assert [_canon(x) for x in d["critical_path"] if x["straggler"]] == \
        [_canon(x) for x in r["critical_path"] if x["straggler"]]
    assert _canon(d["bottlenecks"][0]) == _canon(r["bottlenecks"][0])
    assert d["tasks_analyzed"] == r["tasks_analyzed"]
    assert sorted(x["tasks"] for x in d["per_op"].values()) == sorted(x["tasks"] for x in r["per_op"].values())
    return fr, p


def test_analyze_dataflow_names_straggler_and_attributes_wall(tmp_path):
    _, report = _both_chains(tmp_path, "dataflow")
    d = report.to_dict()
    assert d["critical_path_source"] == "chunk_graph"
    _assert_straggler_named(report)
    assert len(d["per_op"]) >= DEPTH
    assert any(div["kind"] == "wall_clock" for div in d["divergences"])
    text = report.render()
    assert "STRAGGLER" in text and "straggler_excess" in text and "critical path" in text


def test_analyze_oplevel_falls_back_to_op_graph(tmp_path):
    _, report = _both_chains(tmp_path, "oplevel")
    assert report.to_dict()["critical_path_source"] == "op_graph"
    _assert_straggler_named(report)


def test_analyze_accepts_collector_and_compute_id(tmp_path):
    fr = FlightRecorder(bundle_dir=str(tmp_path / "fr"), always=True)
    _run_chain(tmp_path, scheduler="dataflow", recorder=fr)
    _assert_straggler_named(analyze(fr))
    assert analyze(fr.compute_id, bundle_dir=str(tmp_path / "fr")).to_dict()["compute_id"] == fr.compute_id
    assert analyze(load_bundle(fr.bundle_path)).to_dict()["compute_id"] == fr.compute_id


def test_analyze_plain_trace_collector(tmp_path):
    col = TraceCollector(trace_dir=None)
    _run_chain(tmp_path, scheduler="dataflow", recorder=col)
    _assert_straggler_named(analyze(col))


def test_analyze_unknown_target_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        analyze("c-no-such-compute", bundle_dir=str(tmp_path))
    with pytest.raises(TypeError):
        analyze(12345)


def _task(op, chunk, t0, t1, tid=1):
    us = 1e6
    return {"name": op, "cat": "task", "ph": "X", "ts": t0 * us, "dur": (t1 - t0) * us, "tid": tid,
            "args": {"chunk": chunk, "attempt": 0}}


def _head(total_s):
    return [{"name": "thread_name", "ph": "M", "tid": 1, "args": {"name": "worker w-0"}},
            {"name": "compute", "cat": "compute", "ph": "X", "ts": 0.0, "dur": total_s * 1e6, "tid": 1,
             "args": {}}]


def _analyze_both(bundle) -> dict:
    d = analyze(bundle).to_dict()
    assert d == ref_analytics.analyze(bundle).to_dict()
    return d


def test_critical_path_synthetic_chain():
    events = _head(10.0) + [_task("op-a", "('a', 0)", 1.0, 2.0), _task("op-a", "('a', 1)", 1.0, 6.0),
                            _task("op-b", "('b', 0)", 3.0, 4.0), _task("op-c", "('c', 0)", 8.0, 9.5)]
    edges = {"op-a\t('a', 0)": [], "op-a\t('a', 1)": [], "op-b\t('b', 0)": ["op-a\t('a', 0)"],
             "op-c\t('c', 0)": ["op-b\t('b', 0)"]}
    d = _analyze_both({"manifest": {"compute_id": "c-synth", "status": "succeeded", "chunk_graph": edges},
                       "trace": {"traceEvents": events}})
    assert d["critical_path_source"] == "chunk_graph"
    assert [(r["op"], r["chunk"]) for r in d["critical_path"]] == [
        ("op-a", "('a', 0)"), ("op-b", "('b', 0)"), ("op-c", "('c', 0)")]
    assert d["wall_clock_s"] == pytest.approx(10.0)
    assert sum(d["attribution"].values()) == pytest.approx(10.0, rel=1e-6)
    assert d["attribution"]["queue_wait"] == pytest.approx(6.0, abs=1e-6)
    assert d["attribution"]["other"] == pytest.approx(0.5, abs=1e-6)


def test_zero_width_resume_tasks_do_not_poison_op_stats():
    events = _head(2.0) + [_task("op-a", f"('a', {i})", 0.1, 0.1) for i in range(20)]
    for i in range(20, 24):
        t0 = 0.2 + (i - 20) * 0.3
        events.append(_task("op-a", f"('a', {i})", t0, t0 + 0.2))
    d = _analyze_both({"manifest": {"compute_id": "c-zw", "status": "succeeded"}, "trace": {"traceEvents": events}})
    assert not [r for r in d["critical_path"] if r["straggler"]]
    row = d["per_op"]["op-a"]
    assert row["tasks"] == 4 and row["stragglers"] == 0
    assert row["busy_s"] == pytest.approx(0.8, rel=1e-3)


def test_analyze_rejects_traceless_bundle():
    with pytest.raises(ValueError):
        analyze({"manifest": {"compute_id": "c-x"}, "trace": None})
    with pytest.raises(ValueError, match="no task spans"):
        analyze({"manifest": {}, "trace": {"traceEvents": _head(1.0)}})


def test_render_analysis_tolerates_minimal():
    assert render_analysis({"compute_id": "c-x"}) == ref_analytics.render_analysis({"compute_id": "c-x"})
    assert "ANALYZE" in render_analysis({"compute_id": "c-x"})


def test_device_executor_computes_analyze_as_jax_executor(tmp_path):
    """The device executor's task spans are one per op with ``num_tasks``:
    its compute analyzes, with the op graph as the path's source, the same
    ops on the path (by ``op_name``) and the same task records as the
    reference's ``JaxExecutor`` compute of the same plan."""
    out = []
    for pkg, xp, col, ex in ((cubed_tpu, rxp, RefFlightRecorder, JaxExecutor()),
                             (ct, pxp, FlightRecorder, CudaExecutor())):
        spec = pkg.Spec(work_dir=str(tmp_path / pkg.__name__), allowed_mem="2GB", memory_guard="off")
        a, b, x, y = [pkg.from_array(np.random.default_rng(i).random((20, 18, 16)), chunks=(5, 6, 8), spec=spec)
                      for i in range(4)]
        fr = col(bundle_dir=str(tmp_path / f"fr-{pkg.__name__}"), always=True)
        v = xp.mean(a[1:] * x[1:] + b[1:] * y[1:]).compute(executor=ex, callbacks=[fr])
        data = (analyze if pkg is ct else ref_analytics.analyze)(fr.bundle_path).to_dict()
        out.append((float(v), data))
    (rv, r), (pv, p) = out
    assert pv == pytest.approx(rv, rel=1e-12)
    assert p["critical_path_source"] == r["critical_path_source"] == "op_graph"
    assert p["tasks_analyzed"] == r["tasks_analyzed"]
    assert [x["op"].rsplit("-", 1)[0] for x in p["critical_path"]] == \
        [x["op"].rsplit("-", 1)[0] for x in r["critical_path"]]
    assert p["attribution_coverage"] == pytest.approx(1.0, abs=0.01)
    assert sum(p["attribution"].values()) == pytest.approx(p["wall_clock_s"], rel=0.01)


# ----------------------------------------------------------------------
# diagnose: --analyze and graceful degradation
# ----------------------------------------------------------------------


def test_diagnose_analyze_cli(tmp_path, capsys):
    fr = FlightRecorder(bundle_dir=str(tmp_path / "fr"), always=True)
    _run_chain(tmp_path, scheduler="dataflow", recorder=fr)
    assert diagnose.main([fr.bundle_path, "--analyze"]) == 0
    out = capsys.readouterr().out
    assert "== analysis" in out and "wall-clock attribution" in out and "STRAGGLER" in out


def _old_style_bundle(tmp_path):
    """A bundle without the alerts/timeseries keys, trace.json or logs."""
    b = tmp_path / "bundle-c-old"
    b.mkdir()
    manifest = {"compute_id": "c-old", "status": "failed", "op_wall_clock": {"op-a": 1.5},
                "decisions": [{"ts": 1.0, "kind": "retry", "op": "op-a"}],
                "error": {"type": "RuntimeError", "message": "boom"}}
    (b / "manifest.json").write_text(json.dumps(manifest))
    return str(b)


def test_diagnose_degrades_on_a_bundle_without_telemetry_keys(tmp_path, capsys):
    assert diagnose.main([_old_style_bundle(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "c-old" in out and "RuntimeError" in out
    assert "alerts (" not in out and "timeseries" not in out


def test_diagnose_analyze_degrades_without_trace(tmp_path, capsys):
    assert diagnose.main([_old_style_bundle(tmp_path), "--analyze"]) == 0
    assert "analysis unavailable" in capsys.readouterr().out


def test_diagnose_tolerates_string_error_manifest(tmp_path, capsys):
    b = tmp_path / "bundle-c-str"
    b.mkdir()
    (b / "manifest.json").write_text(json.dumps({"compute_id": "c-str", "status": "failed", "error": "bare string"}))
    assert diagnose.main([str(b)]) == 0
    assert "bare string" in capsys.readouterr().out


def test_flightrecorder_manifest_carries_graphs(tmp_path):
    fr = FlightRecorder(bundle_dir=str(tmp_path / "fr"), always=True)
    _run_chain(tmp_path, scheduler="dataflow", recorder=fr)
    manifest = load_bundle(fr.bundle_path)["manifest"]
    assert manifest["op_graph"] and manifest["chunk_graph"]
    assert "\t" in next(iter(manifest["chunk_graph"]))
