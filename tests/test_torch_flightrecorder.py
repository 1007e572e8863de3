"""The port's flight recorder (``cubed_tpu_torch/observability/
flightrecorder.py``) and ``python -m cubed_tpu_torch.diagnose``: the
counterparts of tests/observability/test_flightrecorder.py. The failing
computes run the same seeded task fault in both packages (the threads
executor, one retry) and their bundles are compared: file names, manifest
keys, status, the error's type, the decision kinds, the failing op's
``op_name``. Synthetic bundles are rendered by both packages' ``diagnose``
and compared line for line."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import networkx as nx  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu import diagnose as ref_diagnose  # noqa: E402
from cubed_tpu.observability import FlightRecorder as RefFlightRecorder  # noqa: E402
from cubed_tpu.runtime import types as ref_types  # noqa: E402
from cubed_tpu.runtime.executors.python_async import AsyncPythonDagExecutor as RefAsync  # noqa: E402
from cubed_tpu_torch.core.plan import Dag  # noqa: E402
from cubed_tpu_torch.diagnose import main as diagnose_main  # noqa: E402
from cubed_tpu_torch.diagnose import render_report  # noqa: E402
from cubed_tpu_torch.observability import FlightRecorder, load_bundle  # noqa: E402
from cubed_tpu_torch.observability.collect import record_decision  # noqa: E402
from cubed_tpu_torch.observability.flightrecorder import FLIGHT_RECORDER_ENV_VAR  # noqa: E402
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor  # noqa: E402
from cubed_tpu_torch.runtime import types as port_types  # noqa: E402
from cubed_tpu_torch.runtime.types import ComputeEndEvent, ComputeStartEvent  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _failed_compute(tmp_path, pkg, xp, executor, seed, callbacks=None):
    spec = pkg.Spec(work_dir=str(tmp_path / pkg.__name__), allowed_mem="500MB",
                    fault_injection={"seed": seed, "task_failure_rate": 1.0})
    a = pkg.from_array(np.arange(64.0).reshape(8, 8), chunks=(4, 4), spec=spec)
    with pytest.raises(Exception):
        xp.add(xp.add(a, 1), 1).compute(callbacks=callbacks, executor=executor, optimize_graph=False)


def _op_kind(name: str) -> str:
    return name.rsplit("-", 1)[0] if name else name


def test_failed_chaos_compute_produces_readable_bundle(tmp_path, capsys):
    bundles = []
    for pkg, xp, rec_cls, ex in ((cubed_tpu, rxp, RefFlightRecorder, RefAsync(retries=1)),
                                 (ct, pxp, FlightRecorder, AsyncPythonDagExecutor(retries=1))):
        fr = rec_cls(bundle_dir=str(tmp_path / f"fr-{pkg.__name__}"))
        _failed_compute(tmp_path, pkg, xp, ex, seed=7, callbacks=[fr])
        assert fr.bundle_path is not None
        bundles.append((sorted(os.listdir(fr.bundle_path)), load_bundle(fr.bundle_path)))
    (ref_files, ref_b), (files, b) = bundles
    assert files == ref_files == ["logs.jsonl", "manifest.json", "trace.json"]
    m, rm = b["manifest"], ref_b["manifest"]
    assert set(m) == set(rm)
    assert m["status"] == rm["status"] == "failed"
    assert m["error"]["type"] == rm["error"]["type"] == "FaultInjectedTaskError"
    assert _op_kind(m["error"]["op"]) == _op_kind(rm["error"]["op"])
    assert m["error"]["chunk"] and m["failing_tasks"]
    assert m["metrics"]["tasks_started"] > 0
    assert b["trace"]["traceEvents"]
    kinds = {d["kind"] for d in m["decisions"]}
    assert "task_failed" in kinds and "retry" in kinds
    assert {"task_failed", "retry"} <= {d["kind"] for d in rm["decisions"]}
    assert set(m["op_graph"]) and all(isinstance(v, list) for v in m["op_graph"].values())
    rc = diagnose_main([b["path"]])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[failed]" in out and "FaultInjectedTaskError" in out and m["error"]["op"] in out
    assert "retries timeline" in out


def test_diagnose_cli_runs_as_a_module(tmp_path):
    fr = FlightRecorder(bundle_dir=str(tmp_path / "fr2"))
    _failed_compute(tmp_path, ct, pxp, AsyncPythonDagExecutor(retries=1), seed=3, callbacks=[fr])
    env = {k: v for k, v in os.environ.items() if k != "CUBED_TPU_TORCH_DEVICE"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-m", "cubed_tpu_torch.diagnose", fr.bundle_path],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[failed]" in proc.stdout and "failure" in proc.stdout


def test_diagnose_cli_errors_cleanly_on_missing_bundle(tmp_path, capsys):
    rc = diagnose_main([str(tmp_path / "nope")])
    assert rc == 2
    assert "cannot read bundle" in capsys.readouterr().err


def _straggler_bundle(rec_cls, types_mod, dag, bundle_dir):
    fr = rec_cls(bundle_dir=bundle_dir, always=True)
    fr.on_compute_start(types_mod.ComputeStartEvent(dag, compute_id="c-strag"))
    now = time.time()
    for i in range(8):
        fr.on_task_end(types_mod.TaskEndEvent(array_name="op-a", chunk_key=str(i), function_start_tstamp=now,
                                              function_end_tstamp=now + 0.02))
    fr.on_task_end(types_mod.TaskEndEvent(array_name="op-a", chunk_key="slowpoke", function_start_tstamp=now,
                                          function_end_tstamp=now + 2.0, worker="local-1"))
    fr.on_compute_end(types_mod.ComputeEndEvent(dag))
    return fr


def test_bundle_names_top_stragglers(tmp_path, capsys):
    fr = _straggler_bundle(FlightRecorder, port_types, Dag(),
                           str(tmp_path / "fr3"))
    ref = _straggler_bundle(RefFlightRecorder, ref_types, nx.MultiDiGraph(), str(tmp_path / "ref3"))
    m = load_bundle(fr.bundle_path)["manifest"]
    rm = load_bundle(ref.bundle_path)["manifest"]
    assert m["status"] == "succeeded"
    assert m["stragglers"][0]["chunk"] == "slowpoke" and m["stragglers"][0]["worker"] == "local-1"
    assert [(s["op"], s["chunk"], s["worker"]) for s in m["stragglers"]] == \
        [(s["op"], s["chunk"], s["worker"]) for s in rm["stragglers"]]
    rc = diagnose_main([fr.bundle_path])
    out = capsys.readouterr().out
    assert rc == 0 and "top stragglers" in out and "slowpoke" in out


def test_dump_on_demand_without_failure(tmp_path):
    fr = FlightRecorder(bundle_dir=str(tmp_path / "fr4"))
    fr.on_compute_start(ComputeStartEvent(Dag(), compute_id="c-ok"))
    fr.on_compute_end(ComputeEndEvent(Dag()))
    assert fr.bundle_path is None
    path = fr.dump()
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert load_bundle(path)["manifest"]["status"] == "succeeded"


def test_env_var_arms_flight_recorder_for_every_compute(tmp_path, monkeypatch):
    assert FLIGHT_RECORDER_ENV_VAR == "CUBED_TPU_TORCH_FLIGHT_RECORDER"
    bundles = tmp_path / "auto-fr"
    monkeypatch.setenv(FLIGHT_RECORDER_ENV_VAR, str(bundles))
    _failed_compute(tmp_path, ct, pxp, AsyncPythonDagExecutor(retries=1), seed=11)
    made = [d for d in os.listdir(bundles) if d.startswith("bundle-")]
    assert len(made) == 1
    assert load_bundle(str(bundles / made[0]))["manifest"]["status"] == "failed"
    # an attached collector suppresses the env-armed recorder
    from cubed_tpu_torch.observability import TraceCollector

    _failed_compute(tmp_path, ct, pxp, AsyncPythonDagExecutor(retries=1), seed=12,
                    callbacks=[TraceCollector(trace_dir=None)])
    assert len([d for d in os.listdir(bundles) if d.startswith("bundle-")]) == 1


def test_decision_ring_feeds_failing_task_payloads(tmp_path):
    fr = FlightRecorder(bundle_dir=str(tmp_path / "fr5"))
    fr.on_compute_start(ComputeStartEvent(Dag(), compute_id="c-pay"))
    record_decision("task_failed", op="op-x", chunk="2.3", attempt=1, error_type="ValueError",
                    error="bad block", classification="fail_fast")
    fr.on_compute_end(ComputeEndEvent(Dag(), error=ValueError("bad block")))
    with open(os.path.join(fr.bundle_path, "manifest.json")) as f:
        m = json.load(f)
    assert m["error"]["op"] == "op-x" and m["error"]["chunk"] == "2.3"
    assert m["failing_tasks"][-1]["error"] == "bad block"


def test_diagnose_renders_injected_fault_counters_and_timeline():
    bundle = {"manifest": {
        "compute_id": "c-chaos",
        "status": "succeeded",
        "metrics": {"faults_injected": 3, "faults_injected_storage_read": 2, "faults_injected_task": 1,
                    "faults_injected_straggler": 0},
        "decisions": [
            {"ts": 10.0, "kind": "fault_injected", "site": "storage_read", "key": "a/0.1"},
            {"ts": 10.2, "kind": "fault_injected", "site": "storage_read", "key": "a/1.0"},
            {"ts": 10.5, "kind": "fault_injected", "site": "task", "key": "op-2:(0, 1)"},
        ],
    }}
    report = render_report(bundle)
    assert "injected faults (3 total)" in report
    assert "injected faults timeline (3 events)" in report and "site=task" in report
    assert "straggler" not in report
    assert report == ref_diagnose.render_report(bundle)
