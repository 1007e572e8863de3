"""End to end: a live ComputeService over a two-worker TCP fleet serving
two tenants, the telemetry endpoint scraped for the tenant-labelled series
while it lives; and the service process SIGKILLed at about half of a
tenant's queued requests, restarted in a fresh process, every accepted
request recovered from the journals and completed bit for bit. Counterpart
of tests/service/test_service_fleet.py and test_service_chaos.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json
import signal
import subprocess
import sys
import time
from urllib.request import urlopen

import numpy as np
import pytest

import cubed_tpu_torch as ct
from cubed_tpu_torch.observability import export
from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor
from cubed_tpu_torch.service import ComputeService
from cubed_tpu_torch.service.durability import REQUESTS_FILE, _raw_records
from ._torch_chaos import clean_process  # noqa: E402,F401


@pytest.fixture()
def spec(tmp_path):
    return ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")


def test_service_over_live_fleet_with_tenant_metrics(spec):
    an = np.arange(144, dtype=np.float64).reshape(12, 12)

    def build(k):
        a = ct.from_array(an, chunks=(3, 3), spec=spec)
        return ct.map_blocks(
            lambda x, _k=k: x + _k, a, dtype=np.float64
        )

    export.shutdown()
    rt = export.ensure_started(0)  # ephemeral port
    ex = DistributedDagExecutor(n_local_workers=2)
    try:
        ex._ensure_fleet()
        with ComputeService(
            executor=ex, tenants={"gold": 2.0, "free": 1.0},
            max_concurrent=2, plan_cache=False, result_cache=False,
        ) as svc:
            handles = []
            for i in range(3):
                handles.append(
                    (svc.submit(build(float(i)), tenant="gold"), float(i))
                )
                handles.append(
                    (
                        svc.submit(build(100.0 + i), tenant="free"),
                        100.0 + i,
                    )
                )
            for h, k in handles:
                np.testing.assert_array_equal(h.result(300), an + k)

            # scrape the live endpoints DURING the service's lifetime
            rt.sampler.sample_once()
            base = f"http://127.0.0.1:{rt.port}"
            with urlopen(f"{base}/metrics", timeout=10) as resp:
                text = resp.read().decode()
            assert 'tenant_queued{tenant="gold"}' in text
            assert 'tenant_completed{tenant="free"}' in text
            # per-tenant COST accounting scraped live: the computes above
            # really consumed fleet task-seconds, attributed per tenant
            cost_lines = [
                line for line in text.splitlines()
                if line.startswith(
                    'cubed_tpu_torch_tenant_cost_task_seconds{tenant="gold"}'
                )
            ]
            assert cost_lines, "tenant_cost_task_seconds{tenant=} missing"
            assert float(cost_lines[0].rsplit(" ", 1)[1]) > 0
            accepted = [
                float(line.rsplit(" ", 1)[1])
                for line in text.splitlines()
                if line.startswith("cubed_tpu_torch_service_requests_accepted ")
            ]
            # the registry is process-global: at least THIS service's 6
            assert accepted and accepted[0] >= 6
            with urlopen(f"{base}/snapshot.json", timeout=10) as resp:
                snap = json.loads(resp.read().decode())
            tenants = (snap.get("service") or {}).get("tenants") or {}
            assert set(tenants) == {"gold", "free"}
            assert tenants["gold"]["completed"] == 3
            assert tenants["free"]["completed"] == 3
            assert tenants["gold"]["weight"] == 2.0
            # cost rows ride /snapshot.json: both tenants consumed real
            # fleet task-seconds and wrote their output arrays
            for tenant in ("gold", "free"):
                cost = tenants[tenant].get("cost") or {}
                assert cost.get("task_seconds", 0) > 0
                assert cost.get("bytes_written", 0) >= an.nbytes
            # ...and the top dashboard renders them as the COST panel
            from cubed_tpu_torch import top

            frame = top.render(snap)
            assert "COST" in frame and "TASK-SEC" in frame
            assert "gold" in frame and "free" in frame
            # the fleet really ran these: live workers visible
            assert (snap.get("fleet") or {}).get("workers_live", 0) >= 1
    finally:
        try:
            ex.close()
        finally:
            export.shutdown()


# ----------------------------------------------------------------------
# the service process SIGKILLed mid-queue, recovered in a fresh process
# ----------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json, sys, time
import numpy as np
sys.path.insert(0, {repo!r})
import cubed_tpu_torch as ct
from cubed_tpu_torch.service import ComputeService

mode = sys.argv[1]
work_dir = {work_dir!r}
sdir = {sdir!r}
idmap_path = {idmap!r}
N = {n_requests!r}

AN = np.arange(64, dtype=np.float64).reshape(8, 8)
spec = ct.Spec(work_dir=work_dir, allowed_mem="500MB")


def build(k):
    def kernel(x, _k=float(k)):
        time.sleep(0.06)
        return x + _k

    a = ct.from_array(AN, chunks=(2, 2), spec=spec)  # 16 tasks
    return ct.map_blocks(kernel, a, dtype=np.float64)


if mode == "run":
    svc = ComputeService(
        max_concurrent=1, service_dir=sdir, recover=False,
        plan_cache=False, result_cache=False,
    ).start()
    handles = {{}}
    for i in range(N):
        handles[str(i)] = svc.submit(build(i), tenant="alpha").request_id
    with open(idmap_path, "w") as f:
        json.dump(handles, f)
    print(json.dumps({{"phase": "run", "accepted": N}}), flush=True)
    # run until killed (the parent SIGKILLs at ~50% done)
    svc.wait_idle(timeout=600)
    print(json.dumps({{"phase": "run", "done": True}}), flush=True)
else:
    with open(idmap_path) as f:
        idmap = json.load(f)
    svc = ComputeService(max_concurrent=2, service_dir=sdir).start()
    try:
        ok = svc.wait_idle(timeout=300)
        report = {{"phase": "recover", "idle": bool(ok), "results": {{}}}}
        for k, rid in idmap.items():
            h = svc.handle(rid)
            if h is None:
                report["results"][k] = "missing"
                continue
            if h.status() != "done":
                report["results"][k] = h.status()
                continue
            correct = bool(
                np.array_equal(h.result(10), AN + float(k))
            )
            report["results"][k] = "correct" if correct else "WRONG"
        snap = svc.stats_snapshot()["tenants"].get("alpha") or {{}}
        report["recovered"] = snap.get("recovered", 0)
        print(json.dumps(report), flush=True)
    finally:
        svc.close()
"""


def _done_count(requests_jsonl: str) -> int:
    return sum(
        1 for rec in _raw_records(requests_jsonl) if rec.get("kind") == "done"
    )


@pytest.mark.chaos
def test_chaos_service_sigkill_recovers_every_accepted_request(tmp_path):
    """Kill the service process once ~50% of a tenant's accepted requests
    are sealed done; a fresh process recovers the rest from the per-tenant
    request journals, bitwise-correct."""
    n_requests = 6
    sdir = str(tmp_path / "svc")
    idmap = str(tmp_path / "idmap.json")
    script = _SCRIPT.format(
        repo=REPO, work_dir=str(tmp_path), sdir=sdir, idmap=idmap,
        n_requests=n_requests,
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    requests_jsonl = os.path.join(sdir, "alpha", REQUESTS_FILE)

    proc = subprocess.Popen(
        [sys.executable, "-c", script, "run"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    killed_at = None
    try:
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None:
            if os.path.isfile(requests_jsonl):
                done = _done_count(requests_jsonl)
                if done >= n_requests // 2:
                    os.killpg(proc.pid, signal.SIGKILL)
                    killed_at = done
                    break
            time.sleep(0.05)
        proc.wait(timeout=30)
        assert killed_at is not None, (
            f"service finished before the kill landed "
            f"(rc={proc.returncode}); make the requests slower"
        )
    finally:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(timeout=30)

    # the journal shows accepted > done: there IS something to recover
    records = _raw_records(requests_jsonl)
    accepted = {r["request_id"] for r in records if r.get("kind") == "accepted"}
    done = {r["request_id"] for r in records if r.get("kind") == "done"}
    assert len(accepted) == n_requests
    assert 0 < len(done) < n_requests

    out = subprocess.run(
        [sys.executable, "-c", script, "recover"], env=env,
        capture_output=True, text=True, timeout=400,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["idle"] is True
    # every request accepted-but-unfinished at the kill recovered and
    # re-ran bitwise-correct (the ones sealed done pre-crash were already
    # served; their payloads are reclaimed, so the fresh process has no
    # handle for them)
    with open(idmap) as f:
        id_by_k = json.load(f)
    pending = accepted - done
    assert pending
    for k, rid in id_by_k.items():
        if rid in pending:
            assert report["results"][k] == "correct", (k, report)
    assert report["recovered"] == len(pending)
    # the journal is fully sealed after recovery
    records = _raw_records(requests_jsonl)
    done_after = {
        r["request_id"] for r in records if r.get("kind") == "done"
    }
    assert done_after == accepted


@pytest.fixture(scope="module", autouse=True)
def _clean_process(clean_process):
    yield
