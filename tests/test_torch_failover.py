"""Live coordinator failover: the control log and the rendezvous, epoch
fencing, fleet re-adoption, and the chaos proofs. A crashed coordinator is
replaced by a successor pointed at the same ``control_dir``: it comes up as
the next epoch, re-adopts the recorded fleet (workers re-attach through
their session tokens and replay their unacked outboxes), fences stale
frames, and re-issues only lost assignments; the chaos proofs end with the
port's invariant auditor. A successor's takeover is held against the JAX
package's coordinator's on the same control log. Counterpart of
tests/runtime/test_failover.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import cubed_tpu_torch as ct
from cubed_tpu_torch.observability import get_registry
from cubed_tpu_torch.runtime.distributed import (
    Coordinator,
    WorkerLostError,
    _give_up_message,
    frame_bytes,
    recv_frame,
    run_worker,
    send_frame,
)
from cubed_tpu_torch.runtime.journal import (
    ControlLog,
    control_log_path,
    load_control,
    load_journal,
    read_rendezvous,
    rendezvous_path,
    write_rendezvous,
)
from ._torch_chaos import clean_process, invariant_audit  # noqa: E402,F401


# ----------------------------------------------------------------------
# control log + rendezvous (runtime/journal.py)
# ----------------------------------------------------------------------


def test_control_log_roundtrip_and_torn_tail(tmp_path):
    d = str(tmp_path / "ctrl")
    log = ControlLog(d)
    log.record_epoch(0, ("127.0.0.1", 4000))
    log.record_worker("w0", "tok0", 2, peer_addr=("10.0.0.1", 9000),
                      address=("10.0.0.1", 50001), pid=1234)
    log.record_worker("w1", "tok1", 1)
    log.record_dispatch(7, ("op-a", "0.0"), "w0")
    log.record_dispatch(8, ("op-a", "0.1"), "w1")
    log.record_dispatch(9, ("op-a", "1.0"), "w0")
    log.record_done(8)
    log.record_chunk_locations("w0", [("store", "a/0.0", 64)])
    log.record_worker_gone("w1")
    log.record_decision(0, {"kind": "worker_disconnected", "worker": "w0"})
    log.close()

    # a torn tail (partial line) and garbage cost only themselves
    with open(control_log_path(d), "ab") as f:
        f.write(b'{"kind": "dispatch", "task_')

    prior = load_control(control_log_path(d))
    assert prior["epoch"] == 0
    assert prior["addr"] == ["127.0.0.1", 4000]
    # w1 is gone: its registration AND its in-flight dispatch fold away
    assert set(prior["workers"]) == {"w0"}
    assert prior["workers"]["w0"]["token"] == "tok0"
    assert prior["workers"]["w0"]["pid"] == 1234
    assert set(prior["inflight"]) == {7, 9}  # 8 done, w1's 8 gone anyway
    assert prior["inflight"][7]["tag"] == ["op-a", "0.0"]
    assert prior["chunk_locations"][0]["key"] == "a/0.0"
    assert prior["decisions"][-1]["decision"] == "worker_disconnected"
    assert prior["bad_lines"] == 1

    # a fresh directory folds to epoch -1 (NOT a successor)
    fresh = load_control(control_log_path(str(tmp_path / "nope")))
    assert fresh["epoch"] == -1 and not fresh["workers"]


def test_rendezvous_roundtrip_and_garbage_tolerance(tmp_path):
    d = str(tmp_path)
    write_rendezvous(d, 3, ("10.1.2.3", 8765))
    adv = read_rendezvous(rendezvous_path(d))
    assert adv == {"epoch": 3, "addr": ("10.1.2.3", 8765)}
    # garbage / missing files read as None — the reconnect loop just
    # keeps dialing its last-known address
    with open(rendezvous_path(d), "w") as f:
        f.write("{not json")
    assert read_rendezvous(rendezvous_path(d)) is None
    assert read_rendezvous(str(tmp_path / "absent.json")) is None


# ----------------------------------------------------------------------
# satellite: error paths name the endpoint + epoch
# ----------------------------------------------------------------------


def test_give_up_message_names_endpoint_epoch_and_hints():
    msg = _give_up_message(
        "w3", "10.0.0.9:8765", 2, 30.0, rendezvous="/ctrl/rendezvous.json"
    )
    assert "10.0.0.9:8765" in msg
    assert "epoch 2" in msg
    assert "/ctrl/rendezvous.json" in msg
    assert "--reconnect-give-up" in msg
    # without a rendezvous file the hint says live failover isn't armed
    msg2 = _give_up_message("w3", "10.0.0.9:8765", 0, 30.0)
    assert "--rendezvous" in msg2


def test_wait_for_workers_timeout_names_endpoint_and_epoch():
    coord = Coordinator("127.0.0.1", 0)
    try:
        with pytest.raises(TimeoutError) as exc:
            coord.wait_for_workers(1, timeout=0.2)
        host, port = coord.address
        assert f"{host}:{port}" in str(exc.value)
        assert "epoch 0" in str(exc.value)
    finally:
        coord.close()


# ----------------------------------------------------------------------
# raw-socket worker helpers (handshake only: enough to exercise the
# coordinator's frame paths without a task loop)
# ----------------------------------------------------------------------


def _fake_worker(coord, name, token=None):
    """Register a hello-only worker; returns its connected socket."""
    host, port = coord.address
    s = socket.create_connection((host, port), timeout=10)
    hello = {"type": "hello", "name": name, "nthreads": 1, "pid": os.getpid()}
    if token is not None:
        hello["token"] = token
    send_frame(s, hello)
    ack = recv_frame(s)
    assert ack["type"] == "hello_ack", ack
    return s, ack


def test_drain_complete_sealed_when_link_dies():
    """Satellite regression: a worker whose drain already finished every
    task but whose link tears down before the ``drained`` frame lands
    (e.g. a reconnect loop exhausting its retries mid-drain) seals as a
    completed drain — never counted toward ``workers_lost``."""
    coord = Coordinator("127.0.0.1", 0)
    try:
        s, _ = _fake_worker(coord, "w-drain")
        coord.wait_for_workers(1, timeout=10)
        # the coordinator flips `connected` just after its hello_ack —
        # poll past that handshake race before requesting the drain
        deadline = time.time() + 10
        ok = coord.request_drain("w-drain", grace_s=30.0)
        while not ok and time.time() < deadline:
            time.sleep(0.05)
            ok = coord.request_drain("w-drain", grace_s=30.0)
        assert ok
        # nothing in flight: the drain is complete the moment it began.
        # Kill the link abruptly — no drained frame will ever arrive.
        s.close()
        deadline = time.time() + 10
        while time.time() < deadline:
            if coord.stats["drains_completed"] == 1:
                break
            time.sleep(0.05)
        assert coord.stats["drains_completed"] == 1
        assert coord.stats["workers_lost"] == 0
    finally:
        coord.close()


def test_stale_epoch_frames_fenced_and_counted():
    """Frames stamped by another coordinator incarnation are rejected
    (not applied, not acked) and counted — a zombie's traffic cannot
    corrupt the live epoch's state."""
    coord = Coordinator("127.0.0.1", 0)
    try:
        s, ack = _fake_worker(coord, "w-fence")
        assert ack["epoch"] == 0
        coord.wait_for_workers(1, timeout=10)
        # a sequenced frame from a bogus epoch: must be fenced, and the
        # fence must NOT ack it (an ack would clear the sender's outbox)
        s.sendall(frame_bytes({
            "type": "heartbeat", "seq": 1, "epoch": 7,
        }))
        deadline = time.time() + 10
        while time.time() < deadline:
            if coord.stats["stale_epoch_frames"] == 1:
                break
            time.sleep(0.05)
        assert coord.stats["stale_epoch_frames"] == 1
        # the conn's sequencing never saw the fenced frame
        with coord._lock:
            conn = next(w for w in coord._workers if w.name == "w-fence")
        assert conn.last_seq == 0
        s.close()
    finally:
        coord.close()


# ----------------------------------------------------------------------
# successor adoption (unit: pre-recorded control log, no prior process)
# ----------------------------------------------------------------------


def _seed_prior_epoch(d, inflight=((11, ("op-a", "0.0"), "w0"),)):
    log = ControlLog(d)
    log.record_epoch(0, ("127.0.0.1", 1))
    log.record_worker("w0", "tok-w0", 1, address=("127.0.0.1", 55001))
    for tid, tag, worker in inflight:
        log.record_dispatch(tid, tag, worker)
    log.record_chunk_locations("w0", [("s3://b", "arr/0.0", 128)])
    log.record_decision(0, {"kind": "worker_disconnected", "worker": "w0",
                            "reason": "seeded"})
    log.close()


def test_successor_adopts_fleet_and_submit_returns_adopted_future(tmp_path):
    from cubed_tpu_torch.observability.collect import decisions_since

    d = str(tmp_path / "ctrl")
    _seed_prior_epoch(d)
    t0 = time.time() - 1
    coord = Coordinator("127.0.0.1", 0, control_dir=d, takeover_grace_s=60.0)
    try:
        assert coord.epoch == 1
        assert coord.in_takeover()
        assert coord.stats["coordinator_takeovers"] == 1
        # the adopted worker is alive (counts as fleet capacity) but
        # disconnected — waiting for its token'd reconnect
        assert coord.n_workers == 1
        snap = coord.stats_snapshot()
        assert snap["epoch"] == 1
        row = snap["workers"]["w0"]
        assert row["alive"] and not row["connected"]
        assert row["epoch"] == 0  # joined under the prior epoch
        # task ids live in the successor's shifted space: no collision
        # with worker dedup state that survived the resume
        assert coord._next_task_id >= (1 << 40)
        # a re-submit of the same plan-derived tag hands the adopted
        # future back instead of re-dispatching the work
        fut = coord.submit(None, lambda x: x, 0, tag=("op-a", "0.0"))
        assert coord.stats["tasks_readopted"] == 1
        assert not fut.done()  # waiting on the worker's outbox replay
        # the successor advertised its epoch for the fleet to chase
        adv = read_rendezvous(rendezvous_path(d))
        assert adv["epoch"] == 1
        assert adv["addr"] == coord.address
        # stitched timeline: the prior epoch's replayed connectivity
        # decisions and the takeover marker are both in THIS ring
        kinds = [e["kind"] for e in decisions_since(t0)]
        assert "coordinator_takeover" in kinds
        replayed = [
            e for e in decisions_since(t0)
            if e["kind"] == "worker_disconnected" and e.get("epoch") == 0
        ]
        assert replayed and replayed[0]["reason"] == "seeded"
    finally:
        coord.close()


def test_takeover_window_lease_requeues_exactly_once(tmp_path):
    """Satellite: an adopted assignment whose worker never reports back
    requeues exactly once when the takeover window closes — never
    double-requeued across the epoch boundary."""
    d = str(tmp_path / "ctrl")
    _seed_prior_epoch(d)
    coord = Coordinator(
        "127.0.0.1", 0, control_dir=d, takeover_grace_s=1.0, lease_s=1.0,
    )
    try:
        fut = coord.submit(None, lambda x: x, 0, tag=("op-a", "0.0"))
        assert coord.stats["tasks_readopted"] == 1
        with pytest.raises(WorkerLostError):
            fut.result(timeout=30)
        # exactly one requeue: the backstop consumed the adoption records
        deadline = time.time() + 10
        while time.time() < deadline and coord._adopted_pending:
            time.sleep(0.05)
        assert coord._adopted_pending == []
        assert coord._adopted == {}
        assert coord._adopted_issued == []
    finally:
        coord.close()


def test_autoscaler_holds_during_takeover(tmp_path):
    """An adopted fleet is disconnected-but-leased ON PURPOSE: the
    autoscaler must not read it as holes and spawn a duplicate fleet
    while the takeover window is open."""
    from cubed_tpu_torch.runtime.autoscale import (
        Autoscaler,
        AutoscalePolicy,
        WorkerFactory,
    )

    d = str(tmp_path / "ctrl")
    _seed_prior_epoch(d)
    coord = Coordinator("127.0.0.1", 0, control_dir=d, takeover_grace_s=60.0)

    class CountingFactory(WorkerFactory):
        spawned = 0

        def start_worker(self):
            CountingFactory.spawned += 1
            return f"x-{CountingFactory.spawned}"

        def stop_worker(self, name):
            pass

    scaler = Autoscaler(
        coord, factory=CountingFactory(),
        policy=AutoscalePolicy(min_workers=1, max_workers=4, interval_s=0.05),
        initial_workers=1,
    )
    try:
        assert coord.in_takeover()
        for _ in range(5):
            scaler.tick()
        assert CountingFactory.spawned == 0
        assert scaler.stats["autoscaler_ticks"] == 5
    finally:
        scaler.stop()
        coord.close()


# ----------------------------------------------------------------------
# live takeover, in-process: real worker loop chases the rendezvous
# file to the successor and replays its outbox to the new epoch
# ----------------------------------------------------------------------


class _SlowDouble:
    def __init__(self, delay_s):
        self.delay_s = delay_s

    def __call__(self, x):
        time.sleep(self.delay_s)
        return x * 2


def test_reconnect_requeues_assignments_the_dead_link_ate():
    """An assignment sent on a link that dies before delivery must not
    hang under the worker's renewed lease: the resume hello names every
    task the worker actually holds, and outstanding ids missing from it
    are requeued as worker loss at reconnect."""
    coord = Coordinator("127.0.0.1", 0)
    try:
        s, ack = _fake_worker(coord, "w-req")
        coord.wait_for_workers(1, timeout=10)
        fut = coord.submit(None, _SlowDouble(0.0), 1.0)
        # drain the assignment off the wire so the send definitely
        # completed coordinator-side, then kill the link and reconnect
        # claiming an empty hold — as if the frame never arrived
        frame = recv_frame(s)
        assert frame["type"] == "task"
        s.close()
        s2 = socket.create_connection(coord.address, timeout=10)
        send_frame(s2, {
            "type": "hello", "name": "w-req", "nthreads": 1,
            "pid": os.getpid(), "token": ack["token"], "holding": [],
        })
        ack2 = recv_frame(s2)
        assert ack2["type"] == "hello_ack" and ack2.get("resume") is True
        with pytest.raises(WorkerLostError):
            fut.result(timeout=10)
        assert coord.stats["assignments_requeued"] == 1
        assert coord.stats["workers_lost"] == 0
        s2.close()
    finally:
        coord.close()


def test_live_takeover_worker_rejoins_and_replays(tmp_path):
    """The tentpole end to end, in-process: coordinator A dies abruptly
    with a task in flight; successor B (same control_dir) adopts the
    fleet; the worker — still running the task — chases the rendezvous
    advertisement to B, resumes its session with its token, and replays
    the finished result to the NEW epoch. The adopted future resolves
    without the task ever re-running, and nothing counts as lost."""
    d = str(tmp_path / "ctrl")
    a = Coordinator("127.0.0.1", 0, control_dir=d, lease_s=10.0)
    host, port = a.address
    wt = threading.Thread(
        target=run_worker, args=(f"{host}:{port}",),
        kwargs=dict(
            nthreads=1, name="w-live", rendezvous=rendezvous_path(d),
            reconnect_give_up_s=60.0,
        ),
        daemon=True,
    )
    wt.start()
    b = None
    try:
        a.wait_for_workers(1, timeout=30)
        fut_a = a.submit(
            None, _SlowDouble(2.0), 21.0, tag=("op-live", "0"),
        )
        time.sleep(0.4)  # the dispatch is on the wire and in the log
        assert not fut_a.done()
        # crash A without any goodbye: server + worker socket just die
        a._closed.set()
        a._server.close()
        with a._lock:
            socks = [w.sock for w in a._workers if w.sock is not None]
        for s in socks:
            s.close()

        b = Coordinator(
            "127.0.0.1", 0, control_dir=d, lease_s=10.0,
            takeover_grace_s=30.0,
        )
        assert b.epoch == 1
        assert b.stats["coordinator_takeovers"] == 1
        fut_b = b.submit(
            None, _SlowDouble(2.0), 21.0, tag=("op-live", "0"),
        )
        assert b.stats["tasks_readopted"] == 1
        # the worker finds B through the rendezvous file, resumes with
        # its session token, and its outbox replay resolves the future
        result, _stats = fut_b.result(timeout=60)
        assert result == 42.0
        assert b.stats["workers_lost"] == 0
        deadline = time.time() + 10
        while time.time() < deadline:
            row = b.stats_snapshot()["workers"].get("w-live") or {}
            if row.get("connected"):
                break
            time.sleep(0.05)
        assert row.get("connected"), row
        assert row.get("epoch") == 1  # rejoined under the successor
        # and the fleet still takes NEW work under the new epoch
        fut_new = b.submit(None, _SlowDouble(0.0), 5.0, tag=("op-live", "1"))
        assert fut_new.result(timeout=30)[0] == 10.0
    finally:
        if b is not None:
            b.close()  # shutdown frame stops the worker thread
        a.close()
        wt.join(timeout=15)


# ----------------------------------------------------------------------
# chaos proofs: SIGKILL the coordinator process mid-compute; the
# orphaned worker fleet is adopted by a successor PROCESS
# ----------------------------------------------------------------------


_FAILOVER_SCRIPT = r"""
import json, sys, time
import numpy as np
sys.path.insert(0, {repo!r})
import cubed_tpu_torch as ct
from cubed_tpu_torch.observability import get_registry
from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor

mode = sys.argv[1]
work_dir = {work_dir!r}
journal = {journal!r}
control_dir = {control_dir!r}

def slow_add(x):
    import time
    time.sleep(0.15)
    return x + 1.0

spec = ct.Spec(work_dir=work_dir, allowed_mem="500MB", journal=journal)
an = np.arange(144, dtype=np.float64).reshape(12, 12)
a = ct.from_array(an, chunks=(2, 2), spec=spec)   # 36 map tasks
# a REDUCTION on top of the slow map: its combine rounds are
# dependency-gated, so when the coordinator dies mid-map the successor
# must both re-adopt the running map tasks AND dispatch the combine
# tasks fresh mid-takeover (a pure elementwise chain would fuse into
# one op whose tasks are all already in flight)
import cubed_tpu_torch.array_api as xp
r = xp.sum(ct.map_blocks(slow_add, a, dtype=np.float64))
expected = (an + 1.0).sum()  # integer-valued float64: the sum is exact
total = r.plan.num_tasks()

if mode == "run":
    ex = DistributedDagExecutor(
        n_local_workers=2, worker_threads=1, control_dir=control_dir,
    )
    print(json.dumps({{"phase": "run", "total": total}}), flush=True)
    t0 = time.monotonic()
    r.compute(executor=ex)
    print(json.dumps(
        {{"phase": "run", "done": True,
          "wall_s": time.monotonic() - t0}}), flush=True)
    ex.close()
else:
    # successor: NO local workers of its own — it must adopt the
    # orphaned fleet the killed coordinator left running
    ex = DistributedDagExecutor(
        n_local_workers=0, worker_threads=1, control_dir=control_dir,
        worker_start_timeout=60.0,
    )
    reg = get_registry()
    before = reg.snapshot()
    t0 = time.monotonic()
    result = ex.resume_compute(r, journal)
    wall = time.monotonic() - t0
    delta = reg.snapshot_delta(before)
    stats = ex.stats
    print(json.dumps({{
        "phase": "adopt",
        "correct": bool(np.array_equal(result, expected)),
        "total": total,
        "wall_s": wall,
        "epoch": stats.get("epoch"),
        "takeovers": stats.get("coordinator_takeovers"),
        "readopted": stats.get("tasks_readopted"),
        "workers_lost": stats.get("workers_lost"),
        "resumed_tasks": delta.get("tasks_completed", 0),
        "skipped": delta.get("tasks_skipped_resume", 0),
        "deduped": delta.get("fleet_assignments_deduped", 0),
    }}), flush=True)
    ex.close()
"""


def _reap_control_log_workers(control_dir):
    """Kill any orphaned worker processes recorded in the control log
    (test cleanup: a failed takeover must not leak fleet processes)."""
    prior = load_control(control_log_path(control_dir))
    for rec in prior["workers"].values():
        pid = rec.get("pid")
        if isinstance(pid, int) and pid > 1:
            try:
                os.kill(pid, signal.SIGKILL)
            except (OSError, ProcessLookupError):
                pass


def _run_failover_phases(tmp_path, adopt_env_extra=None, kills=1):
    """Shared chaos driver: run phase, SIGKILL the coordinator process
    (ONLY the coordinator — its worker subprocesses survive as orphans),
    then run the successor phase in a fresh process. Returns the
    successor's JSON report (plus kill bookkeeping)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    journal = str(tmp_path / "failover.journal.jsonl")
    control_dir = str(tmp_path / "ctrl")
    script = _FAILOVER_SCRIPT.format(
        repo=repo, work_dir=str(tmp_path), journal=journal,
        control_dir=control_dir,
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               # cross-process adoption needs stable intermediate paths
               CUBED_TPU_TORCH_CONTEXT_ID="cubed-failover")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    proc = subprocess.Popen(
        [sys.executable, "-c", script, "run"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    report = None
    try:
        # kill the coordinator at ~50% task completions, straggler-held:
        # every 0.15s task keeps the in-flight window real
        deadline = time.time() + 120
        killed_at = None
        while time.time() < deadline and proc.poll() is None:
            if os.path.exists(journal):
                done = len(load_journal(journal)["completed"])
                if done >= 19:  # creates + ~half the 36 slow map tasks
                    os.kill(proc.pid, signal.SIGKILL)  # NOT the group:
                    killed_at = done                   # workers survive
                    break
            time.sleep(0.05)
        proc.wait(timeout=30)
        assert killed_at is not None, (
            "compute finished before the kill landed (rc="
            f"{proc.returncode})"
        )

        adopt_env = dict(env)
        if adopt_env_extra:
            adopt_env.update(adopt_env_extra)
        for attempt in range(kills):
            out = subprocess.run(
                [sys.executable, "-c", script, "adopt"], env=adopt_env,
                capture_output=True, text=True, timeout=240,
            )
            if out.returncode == 137 and attempt < kills - 1:
                # the injected crash-during-takeover landed: the NEXT
                # successor must finish the job un-injected
                adopt_env.pop("CUBED_TPU_TORCH_FAULTS", None)
                continue
            assert out.returncode == 0, out.stderr[-4000:]
            report = json.loads(out.stdout.strip().splitlines()[-1])
            report["successors"] = attempt + 1
            break
        assert report is not None, "every successor attempt was killed"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        _reap_control_log_workers(control_dir)
    return report


@pytest.mark.chaos
def test_chaos_coordinator_sigkill_live_failover(tmp_path, invariant_audit):
    """Acceptance proof: SIGKILL the coordinator process at ~50% task
    completion mid-dataflow-compute; a successor process pointed at the
    same control_dir adopts the orphaned worker fleet (epoch 1), the
    result is bitwise-correct, no worker counts as lost, and strictly
    fewer tasks re-executed than the full plan."""
    # uninterrupted baseline first (same plan, same machine) for the
    # wall-clock ratio; reuse of the work dir is fine — fresh context ids
    report = _run_failover_phases(tmp_path)
    assert report["correct"] is True
    assert report["epoch"] == 1
    assert report["takeovers"] == 1
    assert report["workers_lost"] == 0
    # the adopted fleet's in-flight/finished work was NOT re-run
    assert report["skipped"] > 0
    assert report["resumed_tasks"] < report["total"], report
    # takeover wall clock stays under 2x a generous uninterrupted
    # estimate (~46 tasks x 0.15s across 2 workers, plus fixed overhead)
    assert report["wall_s"] < 2 * (46 * 0.15 / 2 + 3.0), report
    # the two-epoch control log must show the takeover as a LEGAL
    # ownership transfer and strictly increasing epochs; the journal's
    # kill/resume segments must each stay exactly-once
    invariant_audit(
        journal=str(tmp_path / "failover.journal.jsonl"),
        control_dir=str(tmp_path / "ctrl"), work_dir=str(tmp_path),
    )


@pytest.mark.chaos
def test_chaos_coordinator_killed_again_during_takeover(
    tmp_path, invariant_audit
):
    """Second variant: the FIRST successor is itself killed mid-takeover
    (seeded fault: hard-exit after 3 dispatches in an epoch > 0); the
    second successor (epoch 2) adopts whatever both prior epochs left
    and still completes bitwise-correct."""
    faults = json.dumps({
        "seed": 7, "coordinator_takeover_crash_after_dispatches": 3,
    })
    report = _run_failover_phases(
        tmp_path, adopt_env_extra={"CUBED_TPU_TORCH_FAULTS": faults}, kills=2,
    )
    assert report["successors"] == 2  # the first successor really died
    assert report["correct"] is True
    assert report["epoch"] == 2
    assert report["workers_lost"] == 0
    assert report["resumed_tasks"] < report["total"], report
    # three epochs (0 killed, 1 crashed mid-takeover, 2 finished): the
    # control log must still audit as monotone with legal hand-offs
    invariant_audit(
        journal=str(tmp_path / "failover.journal.jsonl"),
        control_dir=str(tmp_path / "ctrl"), work_dir=str(tmp_path),
    )


@pytest.fixture(scope="module", autouse=True)
def _clean_process(clean_process):
    yield


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------


def test_successor_takeover_matches_the_jax_package(tmp_path):
    """Both packages' coordinators, each a successor on a copy of the same
    prior epoch's control log: the same epoch, takeover and readoption
    counters, adopted fleet rows and folded control state; each package
    folds the other's control log to the same state."""
    import shutil

    from cubed_tpu.runtime.distributed import Coordinator as RefCoordinator
    from cubed_tpu.runtime.journal import load_control as ref_load_control

    seeded = str(tmp_path / "seed")
    _seed_prior_epoch(seeded)
    outcome = {}
    for name, cls in (("port", Coordinator), ("ref", RefCoordinator)):
        d = str(tmp_path / name)
        shutil.copytree(seeded, d)
        coord = cls("127.0.0.1", 0, control_dir=d, takeover_grace_s=60.0)
        try:
            coord.submit(None, lambda x: x, 0, tag=("op-a", "0.0"))
            snap = coord.stats_snapshot()
            outcome[name] = (coord.epoch, coord.in_takeover(), coord.n_workers,
                             {k: coord.stats[k] for k in ("coordinator_takeovers", "tasks_readopted", "workers_lost")},
                             {w: (r["alive"], r["connected"], r["epoch"]) for w, r in snap["workers"].items()},
                             read_rendezvous(rendezvous_path(d))["epoch"])
        finally:
            coord.close()
        for fold in (load_control, ref_load_control):
            folded = fold(control_log_path(d))
            outcome[f"{name}-{fold.__module__}"] = (folded["epoch"], sorted(folded["workers"]),
                                                    folded["inflight"], len(folded["decisions"]))
    assert outcome["port"] == outcome["ref"]
    assert outcome["port"][3] == {"coordinator_takeovers": 1, "tasks_readopted": 1, "workers_lost": 0}
    folds = [v for k, v in outcome.items() if "-" in k]
    assert all(f == folds[0] for f in folds)


def test_takeover_grace_without_a_control_dir_is_refused():
    """The takeover window belongs to a successor on a control log: given
    without one it is refused, not dropped."""
    with pytest.raises(ValueError, match="needs control_dir"):
        Coordinator("127.0.0.1", 0, takeover_grace_s=5.0)
