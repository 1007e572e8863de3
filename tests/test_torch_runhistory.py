"""The port's run archive (``cubed_tpu_torch/observability/runhistory.py``),
its structural fingerprint (``service/cache.py``), the regression diff and
``python -m cubed_tpu_torch.regress``: the counterparts of
tests/observability/test_runhistory.py. The archive units run the same
records through both packages' writers and loaders; the fingerprint holds
the reference's property (structurally identical plans fingerprint equal,
different ones differ) on the same pairs of plans, built in both packages,
though its digest is its own; the regression diffs are compared exactly."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.observability import analytics as ref_analytics  # noqa: E402
from cubed_tpu.observability import runhistory as ref_rh  # noqa: E402
from cubed_tpu.service.cache import structural_fingerprint as ref_fingerprint  # noqa: E402
from cubed_tpu_torch.diagnose import main as diagnose_main  # noqa: E402
from cubed_tpu_torch.observability import TraceCollector, analyze, runhistory  # noqa: E402
from cubed_tpu_torch.observability.analytics import regression_diff, render_regression  # noqa: E402
from cubed_tpu_torch.observability.flightrecorder import FlightRecorder  # noqa: E402
from cubed_tpu_torch.observability.metrics import get_registry  # noqa: E402
from cubed_tpu_torch.observability.runhistory import (  # noqa: E402
    RunHistory,
    archive_path,
    find_baseline,
    load_runs,
    record_request,
)
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor  # noqa: E402
from cubed_tpu_torch.runtime.faults import FaultConfig  # noqa: E402
from cubed_tpu_torch.service.cache import canonical_node_order, structural_fingerprint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RH = (ref_rh, runhistory)


# ---------------------------------------------------------------------------
# archive units
# ---------------------------------------------------------------------------


def test_append_and_load_round_trip(tmp_path):
    out = []
    for mod in RH:
        d = str(tmp_path / mod.__name__)
        h = mod.RunHistory(d)
        assert h.append({"kind": "request", "tenant": "a", "ok": True})
        assert h.append({"kind": "compute", "compute_id": "c-1", "ok": False})
        h.close()
        records, bad = mod.load_runs(d)
        assert bad == 0 and all(isinstance(r.get("ts"), float) for r in records)
        out.append([{k: v for k, v in r.items() if k != "ts"} for r in records])
    assert out[1] == out[0]
    assert runhistory.archive_path("x") == ref_rh.archive_path("x")


def test_loader_tolerates_torn_and_garbage_lines(tmp_path):
    h = RunHistory(str(tmp_path))
    h.append({"kind": "request", "tenant": "a", "ok": True})
    h.close()
    with open(archive_path(str(tmp_path)), "ab") as f:
        f.write(b"not json at all\n")
        f.write(b'{"kind": "request", "tenant": "b", "ok": false}\n')
        f.write(b'{"kind": "request", "torn...')
    records, bad = load_runs(str(tmp_path))
    assert (len(records), bad) == (2, 2)
    assert [r["tenant"] for r in records] == ["a", "b"]
    ref_records, ref_bad = ref_rh.load_runs(str(tmp_path))
    assert ref_records == records and ref_bad == bad


def test_append_never_raises_on_unserializable_record(tmp_path):
    h = RunHistory(str(tmp_path))
    loop: dict = {}
    loop["self"] = loop
    assert h.append({"kind": "compute", "bad": loop}) is False
    assert h.append({"kind": "compute", "ok": True}) is True
    h.close()


def test_rotation_bounds_the_archive_and_keeps_history_contiguous(tmp_path):
    sizes = []
    for mod in RH:
        d = str(tmp_path / mod.__name__)
        h = mod.RunHistory(d, max_bytes=4096)
        for i in range(300):
            h.append({"kind": "request", "tenant": "a", "seq": i, "ts": 1.0}, fsync=False)
        h.close()
        active = mod.archive_path(d)
        assert os.path.exists(active + ".1"), "rotation never happened"
        assert os.path.getsize(active) <= 4096
        assert os.path.getsize(active) + os.path.getsize(active + ".1") <= 2 * 4096
        records, bad = mod.load_runs(d)
        seqs = [r["seq"] for r in records]
        assert bad == 0 and seqs == sorted(seqs) and seqs[-1] == 299 and len(seqs) > 50
        sizes.append((os.path.getsize(active), seqs))
    assert sizes[1] == sizes[0]


def test_max_bytes_env_override(tmp_path, monkeypatch):
    assert runhistory.MAX_BYTES_ENV_VAR == "CUBED_TPU_TORCH_RUN_HISTORY_MAX_BYTES"
    monkeypatch.setenv(runhistory.MAX_BYTES_ENV_VAR, "9999")
    h = RunHistory(str(tmp_path))
    assert h.max_bytes == 9999
    h.close()
    monkeypatch.setenv(runhistory.MAX_BYTES_ENV_VAR, "not-a-number")
    h = RunHistory(str(tmp_path))
    assert h.max_bytes == runhistory.DEFAULT_MAX_ARCHIVE_BYTES == ref_rh.DEFAULT_MAX_ARCHIVE_BYTES
    h.close()


# ---------------------------------------------------------------------------
# the Plan.execute record hook
# ---------------------------------------------------------------------------


def _compute(work_dir, hist, faults=None, k=1.0, executor=None):
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    spec = ct.Spec(work_dir=str(work_dir), allowed_mem="500MB", run_history=str(hist), fault_injection=faults)
    a = ct.from_array(an, chunks=(4, 4), spec=spec)
    r = ct.map_blocks(lambda x, _k=k: x + _k, a, dtype=np.float64)
    assert (np.asarray(r.compute(executor=executor or AsyncPythonDagExecutor())) == an + k).all()


def test_plan_execute_appends_a_diffable_record(tmp_path):
    hist = tmp_path / "hist"
    _compute(tmp_path, hist)
    records, bad = load_runs(str(hist))
    assert bad == 0 and len(records) == 1
    rec = records[0]
    assert rec["kind"] == "compute" and rec["ok"] is True and rec["compute_id"].startswith("c-")
    assert isinstance(rec["fingerprint"], str) and len(rec["fingerprint"]) == 64
    assert rec["wall_clock_s"] > 0
    assert rec["buckets"] and "kernel" in rec["buckets"] and rec["per_op"]
    assert rec["metrics"]["tasks_completed"] >= 4
    # no loose trace file: the collector run history attaches writes none
    assert not [f for f in os.listdir(tmp_path) if f.startswith("trace-")]


def test_device_executor_compute_is_archived_with_buckets(tmp_path):
    hist = tmp_path / "hist"
    before = get_registry().snapshot().get("fingerprint_device_bytes", 0)
    _compute(tmp_path, hist, executor=CudaExecutor())
    _compute(tmp_path, hist, executor=CudaExecutor())
    records, _ = load_runs(str(hist))
    assert len(records) == 2 and records[0]["fingerprint"] == records[1]["fingerprint"]
    assert records[1]["buckets"] and records[1]["metrics"]["tasks_completed"] >= 4
    assert get_registry().snapshot().get("fingerprint_device_bytes", 0) == before


def test_same_query_fingerprints_equal_across_builds(tmp_path):
    hist = tmp_path / "hist"
    _compute(tmp_path, hist, k=1.0)
    _compute(tmp_path, hist, k=1.0)
    _compute(tmp_path, hist, k=2.0)
    records, _ = load_runs(str(hist))
    assert len(records) == 3
    assert records[0]["fingerprint"] == records[1]["fingerprint"] != records[2]["fingerprint"]
    assert records[0]["compute_id"] != records[1]["compute_id"]


def _plan(pkg, xp, spec, variant):
    """One of a few plans; variants that differ change the result."""
    import random

    random.seed(3 if variant != "seed" else 4)
    shape = (12, 10) if variant != "shape" else (12, 12)
    chunks = 4 if variant != "chunks" else 6
    a = pkg.random.random(shape, chunks=chunks, spec=spec)
    k = 2.0 if variant != "closure" else 3.0
    b = pkg.map_blocks(lambda x, _k=k: x * _k, a, dtype=np.float64)
    if variant == "op":
        return xp.sum(b + a)
    return xp.sum(b * a)


@pytest.mark.parametrize("variant", ["same", "seed", "shape", "chunks", "closure", "op"])
def test_fingerprint_property_matches_reference(tmp_path, variant):
    """Two builds fingerprint equal exactly when the reference's do."""
    verdicts = []
    for pkg, xp, fp in ((cubed_tpu, rxp, ref_fingerprint), (ct, pxp, structural_fingerprint)):
        spec = pkg.Spec(work_dir=str(tmp_path / pkg.__name__), allowed_mem="500MB")
        one, two = (_plan(pkg, xp, spec, v).plan.dag for v in ("same", variant))
        f1, order = fp(one)
        f2, _ = fp(two)
        assert f1 is not None and f2 is not None
        assert len(order) == len(one.nodes)
        verdicts.append(f1 == f2)
    assert verdicts[1] == verdicts[0] == (variant == "same")


def test_fingerprint_hashes_closure_tensors_by_value(tmp_path):
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(np.ones((8, 8)), chunks=4, spec=spec)
    fps = [structural_fingerprint(ct.map_blocks(lambda x, w=w: x * w[0].item(), a, dtype=np.float64).plan.dag)[0]
           for w in (torch.ones(4), torch.ones(4), torch.zeros(4))]
    assert fps[0] == fps[1] != fps[2]
    assert canonical_node_order(a.plan.dag) == sorted(a.plan.dag.nodes)


def test_failed_compute_is_archived_with_its_error(tmp_path):
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", run_history=str(tmp_path / "hist"))

    def boom(x):
        raise ValueError("seeded kernel failure")

    a = ct.from_array(np.arange(64, dtype=np.float64).reshape(8, 8), chunks=(4, 4), spec=spec)
    with pytest.raises(ValueError):
        ct.map_blocks(boom, a, dtype=np.float64).compute(executor=AsyncPythonDagExecutor())
    records, _ = load_runs(str(tmp_path / "hist"))
    assert len(records) == 1 and records[0]["ok"] is False and records[0]["error"] == "ValueError"


# ---------------------------------------------------------------------------
# baseline selection, regression_diff, analyze(baseline=...)
# ---------------------------------------------------------------------------


def _rec(cid, fp="f1", ts=1.0, ok=True, buckets=None):
    return {"kind": "compute", "compute_id": cid, "fingerprint": fp, "ts": ts, "ok": ok,
            "buckets": {"kernel": 1.0} if buckets is None else buckets}


def test_find_baseline_picks_latest_matching_ok_run():
    records = [_rec("c-old", ts=1.0), _rec("c-failed", ts=2.0, ok=False), _rec("c-otherplan", ts=3.0, fp="f2"),
               _rec("c-nodecomp", ts=4.0, buckets={}), _rec("c-best", ts=5.0), _rec("c-later", ts=9.0),
               {"kind": "request", "tenant": "a", "ts": 6.0}]
    for mod in RH:
        assert mod.find_baseline(records, "f1", before_ts=8.0)["compute_id"] == "c-best"
        assert mod.find_baseline(records, "f9") is None
        assert mod.find_baseline(records, "f1", exclude_compute_id="c-later")["compute_id"] == "c-best"


def test_regression_diff_names_the_grown_bucket():
    baseline = {"compute_id": "c-base", "ts": 1.0, "wall_clock_s": 1.0,
                "buckets": {"kernel": 0.8, "storage_read": 0.2},
                "per_op": {"op-a": {"busy_s": 0.8, "buckets": {"kernel": 0.8}}}}
    current = {"compute_id": "c-cur", "ts": 2.0, "wall_clock_s": 2.0,
               "buckets": {"kernel": 0.8, "storage_read": 0.2, "throttle_wait": 1.0},
               "per_op": {"op-a": {"busy_s": 1.8, "buckets": {"kernel": 0.8, "throttle_wait": 1.0}}},
               "stragglers": [{"op": "op-a", "worker": "w3", "factor": 4.0}]}
    reg = regression_diff(baseline, current)
    assert reg == ref_analytics.regression_diff(baseline, current)
    assert reg["regressed"] is True and reg["wall_clock"]["ratio"] == 2.0
    assert reg["culprits"][0] == "throttle_wait"
    assert reg["buckets"][0]["bucket"] == "throttle_wait" and reg["buckets"][0]["share_of_slowdown"] == 1.0
    assert next(r for r in reg["ops"] if r["op"] == "op-a")["grew_bucket"] == "throttle_wait"
    assert reg["straggler_workers"] == ["w3"]
    text = render_regression(reg)
    assert text == ref_analytics.render_regression(reg)
    assert "REGRESSED" in text and "throttle_wait" in text and "w3" in text


def test_regression_diff_flat_run_is_not_regressed():
    rec = dict(_rec("c-1", ts=1.0), wall_clock_s=1.0)
    cur = dict(rec, compute_id="c-2", ts=2.0, wall_clock_s=1.05)
    reg = regression_diff(rec, cur)
    assert reg == ref_analytics.regression_diff(rec, cur)
    assert reg["regressed"] is False and "no regression" in render_regression(reg)


def test_analyze_baseline_attaches_regression_section(tmp_path):
    hist = tmp_path / "hist"
    _compute(tmp_path, hist)
    baseline = load_runs(str(hist))[0][0]
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    a = ct.from_array(np.arange(64, dtype=np.float64).reshape(8, 8), chunks=(4, 4), spec=spec)
    coll = TraceCollector(trace_dir=None)
    ct.map_blocks(lambda x: x + 1.0, a, dtype=np.float64).compute(executor=AsyncPythonDagExecutor(),
                                                                   callbacks=[coll])
    report = analyze(coll, baseline=baseline)
    reg = report.to_dict()["regression"]
    assert reg["baseline_compute_id"] == baseline["compute_id"]
    assert any(r["bucket"] == "kernel" for r in reg["buckets"])
    assert "REGRESSION" in report.render()


# ---------------------------------------------------------------------------
# the regress CLI
# ---------------------------------------------------------------------------


def _run_regress(*args):
    """``regress.main`` in this process: (returncode, stdout, stderr)."""
    from cubed_tpu_torch import regress

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = regress.main(list(args))
    return subprocess.CompletedProcess(args, rc, out.getvalue(), err.getvalue())


def test_regress_cli_errors_cleanly_without_an_archive(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "CUBED_TPU_TORCH_DEVICE"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-m", "cubed_tpu_torch.regress", "--history", str(tmp_path / "nothere")],
                         capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 2 and "no archive records" in out.stderr
    assert _run_regress().returncode == 2


def test_regress_cli_errors_cleanly_without_a_baseline(tmp_path):
    hist = tmp_path / "hist"
    _compute(tmp_path, hist)
    out = _run_regress("--history", str(hist))
    assert out.returncode == 2 and "no comparable baseline" in out.stderr


def test_chaos_regress_attributes_seeded_stragglers(tmp_path):
    """A clean run, then the same query under seeded stragglers: regress
    finds the baseline by fingerprint and puts the slowdown in the wait
    buckets, not kernel or storage."""
    hist = tmp_path / "hist"
    _compute(tmp_path, hist)
    _compute(tmp_path, hist, faults=FaultConfig(seed=7, straggler_rate=1.0, straggler_delay_s=0.3))
    out = _run_regress("--history", str(hist), "--json")
    assert out.returncode == 1, out.stderr
    reg = json.loads(out.stdout)
    assert reg["regressed"] is True and reg["wall_clock"]["ratio"] > 1.5
    culprits = set(reg["culprits"])
    assert culprits & {"queue_wait", "uninstrumented", "straggler_excess"}
    assert "kernel" not in culprits and "storage_read" not in culprits
    human = _run_regress("--history", str(hist))
    assert human.returncode == 1 and "REGRESSED" in human.stdout


def test_diagnose_history_flag_appends_regression_section(tmp_path):
    hist = tmp_path / "hist"
    an = np.arange(64, dtype=np.float64).reshape(8, 8)

    def bump(x):
        return x + 1.0

    def build():
        spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", run_history=str(hist))
        return ct.map_blocks(bump, ct.from_array(an, chunks=(4, 4), spec=spec), dtype=np.float64)

    build().compute(executor=AsyncPythonDagExecutor())
    rec = FlightRecorder(str(tmp_path / "bundles"), always=True)
    build().compute(executor=AsyncPythonDagExecutor(), callbacks=[rec])
    bundles = os.listdir(tmp_path / "bundles")
    assert len(bundles) == 1
    out_path = tmp_path / "out.txt"
    with open(out_path, "w") as f, contextlib.redirect_stdout(f):
        rc = diagnose_main([str(tmp_path / "bundles" / bundles[0]), "--history", str(hist)])
    text = out_path.read_text()
    assert rc == 0 and "== regression" in text and "REGRESSION" in text
    assert "no comparable baseline" not in text


def test_record_request_shapes(tmp_path):
    for mod in RH:
        d = str(tmp_path / mod.__name__)
        mod.record_request(d, request_id="r-1", tenant="a", status="completed", latency_s=0.5,
                           fingerprint="f" * 64, compute_id="c-1")
        mod.record_request(d, request_id="shed-overload", tenant="b", status="shed", error="overload", shed=True)
    records, _ = load_runs(str(tmp_path / runhistory.__name__))
    ref_records, _ = ref_rh.load_runs(str(tmp_path / ref_rh.__name__))
    assert [{k: v for k, v in r.items() if k != "ts"} for r in records] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in ref_records]
    assert records[0]["ok"] is True and records[0]["latency_s"] == 0.5
    assert records[1]["ok"] is False and records[1]["shed"] is True
    assert record_request is runhistory.record_request and find_baseline is runhistory.find_baseline
