"""Partition tolerance of the port's fleet: the worker link's outbox and
sequence numbers, the reconnect handshake with session tokens, leases that
keep task ownership across a disconnect, sequence dedup, frame robustness,
the seeded control-plane faults (decided for the same frames as in the JAX
package), and the chaos proof that a one-way partition plus seeded message
faults leave a compute bit for bit. The protocol units drive a raw socket
speaking the worker protocol against a real ``Coordinator``. The autoscaler
holds still for a disconnected-but-leased worker, and the chaos proof ends
with the port's invariant auditor over its journal, control log and work
dir. Counterpart of tests/runtime/test_partition.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import socket  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu_torch as ct  # noqa: E402
from cubed_tpu.runtime import faults as ref_faults  # noqa: E402
from cubed_tpu_torch.observability.metrics import get_registry  # noqa: E402
from cubed_tpu_torch.runtime import faults, payload  # noqa: E402
from cubed_tpu_torch.runtime.distributed import (  # noqa: E402
    Coordinator,
    WorkerLostError,
    _WorkerLink,
    recv_frame,
    run_worker,
    send_frame,
)
from cubed_tpu_torch.runtime.resilience import Classification, RetryPolicy  # noqa: E402

from . import _torch_fleet  # noqa: E402
from ._torch_chaos import invariant_audit  # noqa: E402,F401
from ._torch_fleet import SlowAdd  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clean_process():
    before = _torch_fleet.snapshot()
    _torch_fleet.reset_process_state()
    yield
    _torch_fleet.reset_process_state()
    assert _torch_fleet.leftovers(before) == {"children": [], "listening": []}


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    _torch_fleet.reset_process_state()


class _Count(ct.Callback):
    def __init__(self):
        self.value = 0

    def on_task_end(self, event):
        self.value += 1


# ----------------------------------------------------------------------
# pure units: the worker link state machine
# ----------------------------------------------------------------------


def test_worker_link_outbox_is_bounded():
    before = get_registry().counter("outbox_dropped").value
    link = _WorkerLink("w-unit", sock=None, outbox_cap=4)
    for i in range(6):
        # sock=None: the link is down — sends fail but important frames
        # must queue for replay
        assert link.send({"type": "result", "task_id": i}, important=True) \
            is False
    assert len(link.outbox) == 4  # bounded: the two OLDEST were dropped
    assert [seq for seq, _t, _d in link.outbox] == [3, 4, 5, 6]
    assert get_registry().counter("outbox_dropped").value - before == 2


def test_worker_link_seq_monotonic_and_ack_prunes():
    link = _WorkerLink("w-unit", sock=None)
    for i in range(5):
        link.send({"type": "result", "task_id": i}, important=True)
    assert [seq for seq, _t, _d in link.outbox] == [1, 2, 3, 4, 5]
    assert link.unacked_age() >= 0.0
    link.on_ack(3)
    assert [seq for seq, _t, _d in link.outbox] == [4, 5]
    link.on_ack(None)  # malformed ack: no-op, never a crash
    link.on_ack(99)
    assert not link.outbox
    assert link.unacked_age() == 0.0


def test_worker_link_unimportant_frames_not_retained():
    link = _WorkerLink("w-unit", sock=None)
    link.send({"type": "heartbeat"})
    link.send({"type": "started", "task_id": 1})
    assert not link.outbox  # nothing to replay: stale acks are useless


def test_worker_link_adopt_fresh_session_clears_outbox():
    link = _WorkerLink("w-unit", sock=None)
    link.send({"type": "result", "task_id": 0}, important=True)
    a, b = socket.socketpair()
    try:
        # resumed=False: the coordinator registered us as a NEW session —
        # our old lease is gone, replaying its results would only be noise
        link.adopt(a, "tok-1", resumed=False)
        assert link.token == "tok-1"
        assert not link.outbox
    finally:
        a.close()
        b.close()


def test_worker_link_adopt_resumed_replays_in_order():
    link = _WorkerLink("w-unit", sock=None)
    for i in range(3):
        link.send({"type": "result", "task_id": i}, important=True)
    a, b = socket.socketpair()
    try:
        link.adopt(a, "tok-2", resumed=True)
        got = [recv_frame(b) for _ in range(3)]
        assert [m["task_id"] for m in got] == [0, 1, 2]
        assert [m["seq"] for m in got] == [1, 2, 3]
        # replayed frames stay queued until the coordinator acks them
        assert len(link.outbox) == 3
    finally:
        a.close()
        b.close()


# ----------------------------------------------------------------------
# protocol units: a raw socket speaking the worker protocol
# ----------------------------------------------------------------------


def _fake_worker_connect(coord, name, token=None, nthreads=1):
    """Raw-socket registration; returns (sock, hello_ack)."""
    s = socket.create_connection(coord.address, timeout=10)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    hello = {"type": "hello", "name": name, "nthreads": nthreads, "pid": 0}
    if token is not None:
        hello["token"] = token
    send_frame(s, hello)
    ack = recv_frame(s)
    return s, ack


def test_reconnect_within_lease_keeps_task_ownership():
    """The core lease guarantee: disconnect + reconnect inside the lease
    window keeps in-flight tasks owned by the worker — no WorkerLostError,
    no requeue, no retry-budget draw — and the replayed result resolves
    the original future."""
    coord = Coordinator("127.0.0.1", 0, lease_s=8.0)
    reg = get_registry()
    before = reg.snapshot()
    try:
        s, ack = _fake_worker_connect(coord, "w-p0")
        assert ack["type"] == "hello_ack" and ack["resume"] is False
        assert ack["lease_s"] == 8.0
        token = ack["token"]

        fut = coord.submit(None, SlowAdd(0.0), 1.0)
        task = recv_frame(s)
        assert task["type"] == "task"

        # abrupt disconnect: socket EOF must NOT be worker death
        s.close()
        deadline = time.time() + 5
        while coord.stats["workers_disconnected"] == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert coord.stats["workers_disconnected"] == 1
        time.sleep(0.3)
        assert not fut.done(), "socket EOF must not fail a leased task"
        assert coord.stats["workers_lost"] == 0
        snap = coord.stats_snapshot()
        assert snap["workers"]["w-p0"]["alive"] is True
        assert snap["workers"]["w-p0"]["connected"] is False

        # reconnect with the session token: the lease is re-adopted
        s2, ack2 = _fake_worker_connect(coord, "w-p0", token=token)
        assert ack2["type"] == "hello_ack" and ack2["resume"] is True
        assert ack2["token"] == token
        send_frame(s2, {
            "type": "result", "task_id": task["task_id"],
            "result": 42.0, "stats": {}, "seq": 1,
        })
        assert recv_frame(s2) == {"type": "ack", "seq": 1, "epoch": 0}
        result, _stats = fut.result(timeout=5)
        assert result == 42.0

        assert coord.stats["workers_reconnected"] == 1
        assert coord.stats["workers_lost"] == 0
        assert coord.stats["leases_expired"] == 0
        delta = reg.snapshot_delta(before)
        assert delta.get("worker_loss_requeues", 0) == 0
        assert delta.get("task_retries", 0) == 0
        s2.close()
    finally:
        coord.close()


def test_lease_expiry_requeues_exactly_once_as_worker_loss():
    """A worker that stays dark past its lease is declared lost exactly
    once: its in-flight task fails with WorkerLostError — which the retry
    policy classifies REQUEUE (a free reroute, not a budget-drawing
    retry)."""
    coord = Coordinator("127.0.0.1", 0, lease_s=0.4)
    try:
        s, ack = _fake_worker_connect(coord, "w-dark")
        fut = coord.submit(None, SlowAdd(0.0), 1.0)
        recv_frame(s)  # the task reaches the worker, then: darkness
        s.close()
        with pytest.raises(WorkerLostError, match="lease expired"):
            fut.result(timeout=8)
        # the counter lands just after the futures fail: allow it a moment
        deadline = time.time() + 2
        while coord.stats["leases_expired"] == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert coord.stats["leases_expired"] == 1
        assert coord.stats["workers_lost"] == 1
        assert coord.stats["workers_disconnected"] == 1
        # "requeued as worker loss": the classification every executor's
        # map routes through — free reroute, capped by max_requeues
        exc = fut.exception()
        assert RetryPolicy().classify(exc) is Classification.REQUEUE
    finally:
        coord.close()


def test_impostor_name_rejected_while_live():
    """A hello claiming a live connected worker's name without its session
    token must be rejected — and must not perturb the real worker."""
    coord = Coordinator("127.0.0.1", 0)
    try:
        s, ack = _fake_worker_connect(coord, "w-real")
        imp, reply = _fake_worker_connect(coord, "w-real")  # no token
        assert reply["type"] == "hello_reject"
        assert "token" in reply["reason"]
        imp.close()
        assert coord.stats["workers_rejected"] == 1
        assert coord.n_workers == 1
        # the real worker still serves tasks on its original connection
        fut = coord.submit(None, SlowAdd(0.0), 1.0)
        task = recv_frame(s)
        send_frame(s, {
            "type": "result", "task_id": task["task_id"], "result": 7.0,
            "stats": {}, "seq": 1,
        })
        assert fut.result(timeout=5)[0] == 7.0
        s.close()
    finally:
        coord.close()


def test_duplicate_sequenced_result_applied_once():
    """A replayed/duplicated result frame is acked (the original ack may be
    the lost frame) but never applied twice."""
    coord = Coordinator("127.0.0.1", 0)
    before = get_registry().counter("fleet_messages_deduped").value
    try:
        s, _ack = _fake_worker_connect(coord, "w-dup")
        fut = coord.submit(None, SlowAdd(0.0), 1.0)
        task = recv_frame(s)
        msg = {
            "type": "result", "task_id": task["task_id"], "result": 5.0,
            "stats": {}, "seq": 1,
        }
        send_frame(s, msg)
        send_frame(s, msg)  # the duplicate
        assert recv_frame(s) == {"type": "ack", "seq": 1, "epoch": 0}
        assert recv_frame(s) == {"type": "ack", "seq": 1, "epoch": 0}
        assert fut.result(timeout=5)[0] == 5.0
        assert (
            get_registry().counter("fleet_messages_deduped").value - before
            == 1
        )
        s.close()
    finally:
        coord.close()


def test_corrupt_frames_counted_and_peer_dropped_cleanly():
    """Fuzz the coordinator with malformed frames: a garbage payload and a
    hostile length prefix must each be a connection-level error on that
    peer — counted, logged, connection dropped — never an uncaught
    exception killing the recv thread (the coordinator keeps serving)."""
    import struct

    coord = Coordinator("127.0.0.1", 0, lease_s=0.3)
    try:
        # garbage payload under a sane length prefix
        s1, _ = _fake_worker_connect(coord, "w-fuzz1")
        s1.sendall(struct.pack(">Q", 16) + b"\xde\xad\xbe\xef" * 4)
        # hostile length prefix (64 EiB)
        s2, _ = _fake_worker_connect(coord, "w-fuzz2")
        s2.sendall(struct.pack(">Q", 1 << 63))
        deadline = time.time() + 5
        while coord.stats["frames_corrupt"] < 2 and time.time() < deadline:
            time.sleep(0.02)
        assert coord.stats["frames_corrupt"] == 2
        # the fuzzed peers were disconnected (then lease-dropped), and the
        # coordinator still accepts registrations and serves tasks
        s3, ack3 = _fake_worker_connect(coord, "w-clean")
        assert ack3["type"] == "hello_ack"
        fut = coord.submit(None, SlowAdd(0.0), 1.0)
        task = recv_frame(s3)
        send_frame(s3, {
            "type": "result", "task_id": task["task_id"], "result": 2.0,
            "stats": {}, "seq": 1,
        })
        assert fut.result(timeout=5)[0] == 2.0
        for s in (s1, s2, s3):
            s.close()
    finally:
        coord.close()


def test_worker_recv_survives_corrupt_frame_and_reconnects():
    """Worker-side frame robustness: a garbage frame from the coordinator
    makes the worker drop the connection and reconnect with its session
    token — the recv thread survives. A hello_reject on reconnect is
    fatal (the worker gives up instead of hammering)."""
    import struct

    server = socket.create_server(("127.0.0.1", 0))
    host, port = server.getsockname()[:2]
    before = get_registry().counter("frames_corrupt").value
    box: dict = {}
    done = threading.Event()

    def fake_coordinator():
        # first registration
        c1, _ = server.accept()
        hello1 = recv_frame(c1)
        box["hello1"] = hello1
        send_frame(c1, {"type": "hello_ack", "token": "tok-X",
                        "resume": False, "lease_s": 5.0})
        # feed a garbage frame: the worker must reconnect, not die
        c1.sendall(struct.pack(">Q", 8) + b"notapkl!")
        c2, _ = server.accept()
        hello2 = recv_frame(c2)
        box["hello2"] = hello2
        # reject the reconnect: the worker should exit, not retry forever
        send_frame(c2, {"type": "hello_reject", "reason": "test says no"})
        c1.close()
        c2.close()
        done.set()

    t = threading.Thread(target=fake_coordinator, daemon=True)
    t.start()
    w = threading.Thread(
        target=run_worker, args=(f"{host}:{port}",),
        kwargs=dict(nthreads=1, name="w-fuzzed", reconnect_give_up_s=10.0),
        daemon=True,
    )
    w.start()
    assert done.wait(timeout=15)
    w.join(timeout=15)
    assert not w.is_alive(), "worker must exit after a fatal rejection"
    assert box["hello1"].get("token") is None
    assert box["hello2"].get("token") == "tok-X"  # session token presented
    assert get_registry().counter("frames_corrupt").value - before >= 1
    server.close()


def test_new_session_clears_assignment_dedup():
    """Regression: a persistent worker re-registered as a NEW session (a
    fresh coordinator after a client crash — its task-id counter restarts
    at 0) must not swallow the new session's assignments as duplicates of
    the dead session's task ids."""
    import hashlib

    server = socket.create_server(("127.0.0.1", 0))
    host, port = server.getsockname()[:2]
    results: list = []
    done = threading.Event()

    def blob_task(task_id):
        blob = payload.dumps((SlowAdd(0.0), None))
        return {
            "type": "task", "task_id": task_id,
            "blob_id": hashlib.sha1(blob).hexdigest(), "blob": blob,
            "input": 1.0, "ack": False,
        }

    def await_result(c):
        while True:
            m = recv_frame(c)
            if m.get("type") == "result":
                results.append(m)
                send_frame(c, {"type": "ack", "seq": m["seq"]})
                return

    def fake_coordinators():
        # coordinator A: session 1, assigns task id 0
        c1, _ = server.accept()
        recv_frame(c1)
        send_frame(c1, {"type": "hello_ack", "token": "t1",
                        "resume": False, "lease_s": 5.0})
        send_frame(c1, blob_task(0))
        await_result(c1)
        c1.close()  # the client process "crashes"
        # coordinator B: a fresh process — new session, ids restart at 0
        c2, _ = server.accept()
        recv_frame(c2)
        send_frame(c2, {"type": "hello_ack", "token": "t2",
                        "resume": False, "lease_s": 5.0})
        send_frame(c2, blob_task(0))
        await_result(c2)
        send_frame(c2, {"type": "shutdown"})
        c2.close()
        done.set()

    threading.Thread(target=fake_coordinators, daemon=True).start()
    w = threading.Thread(
        target=run_worker, args=(f"{host}:{port}",),
        kwargs=dict(nthreads=1, name="w-sessions"), daemon=True,
    )
    w.start()
    assert done.wait(timeout=30), (
        "the new session's task id 0 was swallowed by stale dedup state"
    )
    w.join(timeout=15)
    assert [m["result"] for m in results] == [2.0, 2.0]
    server.close()


def test_injected_duplication_deduped_on_both_sides():
    """With every frame duplicated in both directions (rate 1.0), task
    assignments execute once (worker-side task-id dedup) and sequenced
    results apply once (coordinator-side seq dedup) — the compute's
    arithmetic is untouched."""
    coord = Coordinator("127.0.0.1", 0)
    host, port = coord.address
    reg = get_registry()
    before = reg.snapshot()
    faults.activate({"seed": 7, "net_msg_dup_rate": 1.0})
    try:
        threading.Thread(
            target=run_worker, args=(f"{host}:{port}",),
            kwargs=dict(nthreads=1, name="w-dupes"), daemon=True,
        ).start()
        coord.wait_for_workers(1, timeout=30)
        futs = [coord.submit(None, SlowAdd(0.0), float(i)) for i in range(4)]
        assert [f.result(timeout=15)[0] for f in futs] == [1.0, 2.0, 3.0, 4.0]
        delta = reg.snapshot_delta(before)
        assert delta.get("fleet_assignments_deduped", 0) >= 1, delta
        assert delta.get("fleet_messages_deduped", 0) >= 1, delta
        assert coord.stats["workers_lost"] == 0
    finally:
        faults.deactivate()
        coord.close()


def test_seeded_control_plane_and_worker_faults_match_the_reference():
    """The same config decides the same frames and the same worker ticks
    in both packages: drops, resets, duplicates and delays by frame, and
    the partition, crash and preemption by a worker's task count."""
    cfg = dict(seed=1234, net_msg_drop_rate=0.04, net_msg_dup_rate=0.05, net_msg_delay_rate=0.10,
               net_reset_rate=0.02, partition_worker_names=["local-0"], partition_after_tasks=3,
               partition_duration_s=2.5, worker_crash_names=["local-1"], worker_crash_after_tasks=5,
               worker_preempt_rate=0.5, worker_preempt_after_tasks=2)
    port = faults.FaultInjector(faults.FaultConfig.from_dict(cfg))
    ref = ref_faults.FaultInjector(ref_faults.FaultConfig.from_dict(cfg))
    frames = [(d, w, t) for w in ("local-0", "local-1") for d in ("tx", "rx")
              for t in ("result", "heartbeat", "task", "ack") for _ in range(25)]
    assert [port.net_fault(*f) for f in frames] == [ref.net_fault(*f) for f in frames]
    ticks = [(w, i) for i in range(8) for w in ("local-0", "local-1", "local-2", "local-3")]
    assert [port.worker_task_tick(w) for w, _ in ticks] == [ref.worker_task_tick(w) for w, _ in ticks]
    assert port.partitioned("local-0", "tx") == ref.partitioned("local-0", "tx") is True
    assert faults.FaultConfig.from_dict(cfg).to_env_json() == ref_faults.FaultConfig.from_dict(cfg).to_env_json()


def test_fault_config_rides_the_wire_and_disarms():
    cfg = faults.FaultConfig(seed=3, net_msg_drop_rate=0.5)
    faults.activate(cfg)
    raw = faults.wire_config()
    faults.deactivate()
    assert faults.wire_config() is None
    inj = faults.arm_from_wire(raw)
    assert inj is not None and faults.get_injector() is inj and inj.config == cfg
    assert faults.arm_from_wire(raw) is inj  # one injector per config: its counts advance
    assert faults.arm_from_wire(None) is None and faults.get_injector() is None


def test_autoscaler_does_not_backfill_leased_worker():
    """A disconnected-but-leased worker is not a hole: the policy loop
    neither spawns a replacement for it nor picks it as a drain victim."""
    from cubed_tpu_torch.runtime.autoscale import Autoscaler, AutoscalePolicy, WorkerFactory

    class Factory(WorkerFactory):
        def __init__(self):
            self.started = []

        def start_worker(self):
            name = f"x-{len(self.started)}"
            self.started.append(name)
            return name

        def stop_worker(self, name):
            pass

    class View:
        """Coordinator stub: two workers, one disconnected-but-leased."""

        backfill_grace_s = 0.0

        def __init__(self):
            self.drained = []

        def load_view(self):
            return [
                {"name": "a", "draining": False, "pressured": False, "connected": True, "outstanding": 0,
                 "nthreads": 1},
                {"name": "b", "draining": False, "pressured": False, "connected": False, "outstanding": 2,
                 "nthreads": 1},
            ]

        def known_worker_names(self):
            return {"a", "b"}

        def request_drain(self, name, grace_s=30.0, reason="scale_down"):
            self.drained.append(name)
            return True

    coord = View()
    factory = Factory()
    scaler = Autoscaler(coord, factory=factory, initial_workers=2, policy=AutoscalePolicy(
        min_workers=1, max_workers=4, idle_rounds_before_down=1, cooldown_down_s=0.0))
    scaler.tick()
    assert factory.started == []  # the leased worker still counts as capacity
    # idle long enough to scale down: the victim must be the connected one
    scaler.tick()
    assert coord.drained in ([], ["a"]) and "b" not in coord.drained


# ----------------------------------------------------------------------
# chaos proof: partition and message faults, end to end
# ----------------------------------------------------------------------


def test_chaos_partition_and_message_faults_bitwise_correct(tmp_path, invariant_audit):
    """Seeded message drop, delay and duplication plus a 2.5 s one-way
    partition of one worker mid-compute, under the dataflow scheduler: the
    value is bit for bit, no worker is lost, at least one reconnects, and
    every task's result is applied once, which the invariant auditor also
    proves post hoc from the journal and the control log."""
    from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor

    journal = str(tmp_path / "partition.journal.jsonl")
    control_dir = str(tmp_path / "ctrl")
    spec = ct.Spec(
        work_dir=str(tmp_path), allowed_mem="500MB", scheduler="dataflow", journal=journal,
        fault_injection=dict(seed=1234, net_msg_drop_rate=0.04, net_msg_dup_rate=0.05, net_msg_delay_rate=0.10,
                             net_msg_delay_s=0.02, partition_worker_names=["local-0"], partition_after_tasks=3,
                             partition_duration_s=2.5, partition_direction="tx"),
    )
    an = np.arange(144, dtype=np.float64).reshape(12, 12)
    ex = DistributedDagExecutor(n_local_workers=2, worker_threads=1, control_dir=control_dir, task_timeout=6.0,
                                retries=6, use_backups=False, lease_s=12.0)
    try:
        a = ct.from_array(an, chunks=(2, 2), spec=spec)  # 36 tasks
        r = ct.map_blocks(SlowAdd(0.05), a, dtype=np.float64)
        expected_tasks = r.plan._finalize().num_tasks()
        counter = _Count()
        result = r.compute(executor=ex, callbacks=[counter])
        np.testing.assert_array_equal(result, an + 1.0)
        stats = ex._coordinator.stats
        assert stats["workers_lost"] == 0, stats
        assert stats["leases_expired"] == 0, stats
        assert stats["workers_reconnected"] >= 1, stats
        assert counter.value == expected_tasks, (counter.value, expected_tasks)
    finally:
        ex.close()
    # duplicate frame deliveries never reach the journal as duplicate
    # applications, and every re-dispatch across the partition shows an
    # ownership release in the control log
    invariant_audit(journal=journal, control_dir=control_dir, work_dir=str(tmp_path))
