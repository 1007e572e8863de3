"""The port's EXPLAIN (``Plan.explain``, ``analytics.explain``) and
``python -m cubed_tpu_torch.explain``: the counterparts of
tests/observability/test_explain.py. Each plan is built in both packages
from the same numpy input, and the reports are compared row by row (ops
matched in order, their names aside): kind, tasks, projected and allowed
memory, bytes read and written, chunk-structured or barrier, and every
total. Both packages are explained with ``peer_transfer=False`` (the
store-only mode), and the case that arms the fleet's peer data plane
compares the two armed reports, peer-eligible bytes included."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu_torch import explain as explain_cli  # noqa: E402
from cubed_tpu_torch.observability.analytics import ExplainReport, render_explain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _specs(tmp_path, **kw):
    return (cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB", peer_transfer=False, **kw),
            ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB", peer_transfer=False, **kw))


def _chain(pkg, spec, depth=2):
    r = pkg.from_array(np.arange(64, dtype=np.float64).reshape(8, 8), chunks=(4, 4), spec=spec)
    for _ in range(depth):
        r = pkg.map_blocks(lambda x: x + 1.0, r, dtype=np.float64)
    return r


def _rows(d) -> list:
    return [{k: v for k, v in row.items() if k != "op"} for row in d["ops"]]


def _same_report(ref, port) -> dict:
    """Compare two explain dicts; the port's."""
    r, p = ref.to_dict(), port.to_dict()
    assert _rows(p) == _rows(r)
    assert p["totals"] == r["totals"]
    assert p["scheduler"] == r["scheduler"] and p["peer_transfer"] == r["peer_transfer"] is False
    assert p["fusion"] == r["fusion"]
    assert p["barriers"]["chunk_edges"] == r["barriers"]["chunk_edges"]
    assert len(p["barriers"]["ops"]) == len(r["barriers"]["ops"])
    return p


def test_explain_totals_match_plan_introspection(tmp_path):
    rs, ps = _specs(tmp_path)
    r = _chain(ct, ps)
    d = _same_report(_chain(cubed_tpu, rs).explain(), r.explain())
    finalized = r.plan._finalize(True, None, (r.name,))
    assert d["totals"]["tasks"] == finalized.num_tasks() > 0
    assert d["totals"]["arrays"] == finalized.num_arrays()
    assert d["totals"]["max_projected_mem"] == finalized.max_projected_mem()
    assert d["totals"]["allowed_mem"] == ps.allowed_mem
    assert d["totals"]["bytes_written"] >= 64 * 8
    assert finalized.explain(spec=ps).to_dict()["totals"] == d["totals"]


def test_explain_rows_and_render(tmp_path):
    rs, ps = _specs(tmp_path)
    rep = _chain(ct, ps).explain()
    ref = _chain(cubed_tpu, rs).explain()
    d = _same_report(ref, rep)
    real = [row for row in d["ops"] if row["op"] != "create-arrays"]
    assert real and all(row["tasks"] >= 1 for row in real)
    assert any(row["chunk_structured"] for row in real) and any(row["bytes_read"] > 0 for row in real)
    text = rep.render()
    assert "EXPLAIN" in text and "scheduler=dataflow" in text
    for row in d["ops"]:
        assert row["op"] in text
    assert str(rep) == text
    assert text.splitlines()[:4] == ref.render().splitlines()[:4]


def test_explain_fusion_counts(tmp_path):
    rs, ps = _specs(tmp_path)
    d = _same_report(_chain(cubed_tpu, rs, 3).explain(), _chain(ct, ps, 3).explain())
    assert d["fusion"]["ops_before"] >= d["fusion"]["ops_after"]
    unopt = _same_report(_chain(cubed_tpu, rs, 3).explain(optimize_graph=False),
                         _chain(ct, ps, 3).explain(optimize_graph=False))
    assert unopt["fusion"]["ops_before"] == unopt["fusion"]["ops_after"]


def _rechunked(pkg, spec):
    a = pkg.from_array(np.arange(64, dtype=np.float64).reshape(8, 8), chunks=(4, 4), spec=spec)
    b = pkg.map_blocks(lambda x: x + 1.0, a, dtype=np.float64)
    return pkg.map_blocks(lambda x: x * 2.0, b.rechunk((8, 2)), dtype=np.float64)


def test_explain_reports_scheduler_and_rechunk_chunked(tmp_path):
    rs, ps = _specs(tmp_path, scheduler="dataflow")
    d = _same_report(_rechunked(cubed_tpu, rs).explain(spec=rs, optimize_graph=False),
                     _rechunked(ct, ps).explain(spec=ps, optimize_graph=False))
    assert d["scheduler"] == "dataflow" and d["barriers"]["chunk_edges"] is not None
    rechunk_rows = [row for row in d["ops"] if row["kind"] == "rechunk"]
    assert rechunk_rows
    for row in rechunk_rows:
        assert row["chunk_structured"] and not row["barrier"], row
    assert d["barriers"]["ops"] == []
    # store-only: no predicted shuffle
    assert d["totals"]["predicted_shuffle_bytes"] == 0


def test_explain_peer_eligible_bytes(tmp_path):
    """Armed, both packages predict the same peer-eligible bytes; store-only,
    both report zero and otherwise the armed totals."""
    spec = cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB", peer_transfer=True)
    armed = _chain(cubed_tpu, spec).explain(optimize_graph=False).to_dict()
    assert armed["peer_transfer"] is True and armed["totals"]["peer_eligible_bytes"] > 0
    port_spec = ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB", peer_transfer=True)
    port_armed = _chain(ct, port_spec).explain(optimize_graph=False).to_dict()
    assert port_armed["peer_transfer"] is True
    assert port_armed["totals"] == armed["totals"]
    assert _rows(port_armed) == _rows(armed)
    rs, ps = _specs(tmp_path)
    d = _same_report(_chain(cubed_tpu, rs).explain(optimize_graph=False),
                     _chain(ct, ps).explain(optimize_graph=False))
    assert d["totals"]["peer_eligible_bytes"] == 0
    assert {k: v for k, v in d["totals"].items() if k not in ("peer_eligible_bytes", "predicted_shuffle_bytes")} == \
        {k: v for k, v in armed["totals"].items() if k not in ("peer_eligible_bytes", "predicted_shuffle_bytes")}


def test_explain_vorticity_matches_reference(tmp_path):
    """The main path's plan, cut: the same rows and totals."""
    rs, ps = _specs(tmp_path)
    out = []
    for pkg, xp, spec in ((cubed_tpu, rxp, rs), (ct, pxp, ps)):
        a, b, x, y = [pkg.from_array(np.random.default_rng(i).random((20, 18, 16)), chunks=(5, 6, 8), spec=spec)
                      for i in range(4)]
        out.append(xp.mean(a[1:] * x[1:] + b[1:] * y[1:]).explain())
    d = _same_report(*out)
    assert d["totals"]["tasks"] > 0


def test_explain_report_roundtrip_and_cli(tmp_path, capsys):
    rep = _chain(ct, _specs(tmp_path)[1]).explain()
    path = str(tmp_path / "explain.json")
    rep.save(path)
    assert ExplainReport.load(path).to_dict() == rep.to_dict()
    assert explain_cli.main([path]) == 0
    assert "EXPLAIN" in capsys.readouterr().out
    assert explain_cli.main([path, "--json"]) == 0
    assert '"totals"' in capsys.readouterr().out


def test_explain_cli_subprocess(tmp_path):
    path = str(tmp_path / "explain.json")
    _chain(ct, _specs(tmp_path)[1]).explain().save(path)
    env = {k: v for k, v in os.environ.items() if k != "CUBED_TPU_TORCH_DEVICE"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-m", "cubed_tpu_torch.explain", path], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert "EXPLAIN" in out.stdout


def test_explain_cli_missing_path(capsys):
    assert explain_cli.main(["/nonexistent/explain.json"]) == 2
    assert "cannot read" in capsys.readouterr().err


@pytest.mark.parametrize("data", [{}, {"totals": {"ops": 1}}, {"ops": [{"op": "x", "tasks": 1}]}])
def test_render_explain_tolerates_empty(data):
    from cubed_tpu.observability.analytics import render_explain as ref_render

    assert "EXPLAIN" in render_explain(data)
    assert render_explain(data) == ref_render(data)
