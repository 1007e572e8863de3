"""Composed-failure chaos campaigns: seeded schedules, shrinking, repros.
Counterpart of ``cubed_tpu/runtime/campaign.py``: the same schedules from
the same seeds, in the same JSON, so a repro written by either package
replays in the other.

The chaos suites prove each failure domain in isolation; real incidents
happen at domain *intersections*. This module turns the existing
:class:`~cubed_tpu_torch.runtime.faults.FaultConfig` knobs plus lifecycle
events into one declarative, seeded :class:`FaultSchedule`, runs it over
a small workload matrix, and verifies the outcome twice: bitwise output
equality AND a clean :class:`~cubed_tpu_torch.runtime.audit.InvariantAuditor`
report over the run's durable artifacts. When a schedule fails either
check, :class:`CampaignRunner.shrink` reduces it to a minimal reproducing
subset (greedy delta-debugging over fault atoms) and writes a replayable
repro file:

    python -m cubed_tpu_torch.chaos --seed 7          # one generated schedule
    python -m cubed_tpu_torch.chaos --campaign 25     # seeded soak over seeds
    python -m cubed_tpu_torch.chaos --repro repro-7.json   # replay a repro

Determinism: the injector hashes ``seed:site:key:n`` where chunk keys
embed gensym'd plan names, so each run pins the process-global sym
counter (the established bench/brownout idiom) — the same schedule rolls
the same decisions every run, which is what makes both the tier-1
fixed-seed proof and repro replay meaningful.

Two execution modes:

- **in-process** (default): threaded or in-process-fleet executors.
  Schedules must not contain *process faults* (coordinator SIGKILL /
  client SIGKILL) — those hard-exit the calling process by design.
  ``generate()`` therefore only emits them when
  ``allow_process_faults=True``.
- **subprocess** (``--campaign`` soak / process-fault schedules): the
  compute runs in a child interpreter (the test_failover harness shape),
  the parent kills/adopts per the schedule's events, and the auditor
  runs over the artifacts the child left behind.

Computes run on the chunk device (``backend_array_api.get_device``); a
child interpreter is given the parent's. Plans reach fleet workers through
``runtime/payload.py`` (the stdlib's ``pickle``).
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import random
import shutil
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .audit import AuditReport, InvariantAuditor

#: knobs that only make sense together form one shrink "atom": removing a
#: rate without its companion duration/names would leave dead weight and
#: make "minimal" ambiguous. seed is never an atom (always kept).
KNOB_ATOMS = (
    ("storage_read_failure_rate",),
    ("storage_write_failure_rate", "storage_write_leaves_tmp"),
    ("storage_throttle_rate",),
    ("storage_corrupt_rate",),
    ("task_failure_rate",),
    ("task_fatal_rate",),
    ("task_fatal_chunk_keys",),
    ("straggler_rate", "straggler_delay_s"),
    ("task_mem_spike_rate", "task_mem_spike_bytes"),
    ("worker_crash_names", "worker_crash_after_tasks"),
    ("worker_hang_names", "worker_hang_after_tasks", "worker_hang_s"),
    ("worker_preempt_rate", "worker_preempt_after_tasks",
     "preempt_notice_s"),
    ("net_msg_drop_rate",),
    ("net_msg_dup_rate",),
    ("net_msg_delay_rate", "net_msg_delay_s"),
    ("net_reset_rate",),
    ("partition_worker_names", "partition_after_tasks",
     "partition_duration_s", "partition_direction"),
    ("peer_drop_rate",),
    ("peer_delay_rate", "peer_delay_s"),
    ("peer_corrupt_rate",),
    ("peer_reset_rate",),
    ("coordinator_crash_after_dispatches",),
    ("coordinator_takeover_crash_after_dispatches",),
)

#: knob -> failure domain, for the ≥3-domains-composed acceptance check
#: and for generate()'s domain sampling
KNOB_DOMAINS = {
    "storage_read_failure_rate": "storage",
    "storage_write_failure_rate": "storage",
    "storage_write_leaves_tmp": "storage",
    "storage_throttle_rate": "storage",
    "storage_corrupt_rate": "integrity",
    "task_failure_rate": "task",
    # poison-task knobs: the WORKLOAD is the fault (a request whose chunks
    # kill their worker every attempt). Deliberately absent from
    # _DOMAIN_TEMPLATES — a generated campaign expects bitwise success,
    # and a poison chunk is *supposed* to fail (with PoisonTaskError);
    # explicit schedules and tests/service/test_overload.py exercise it
    "task_fatal_rate": "workload",
    "task_fatal_chunk_keys": "workload",
    "straggler_rate": "task",
    "straggler_delay_s": "task",
    "task_mem_spike_rate": "memory",
    "task_mem_spike_bytes": "memory",
    "worker_crash_names": "worker_loss",
    "worker_crash_after_tasks": "worker_loss",
    "worker_hang_names": "worker_loss",
    "worker_hang_after_tasks": "worker_loss",
    "worker_hang_s": "worker_loss",
    "worker_preempt_rate": "elasticity",
    "worker_preempt_after_tasks": "elasticity",
    "preempt_notice_s": "elasticity",
    "net_msg_drop_rate": "partition",
    "net_msg_dup_rate": "partition",
    "net_msg_delay_rate": "partition",
    "net_msg_delay_s": "partition",
    "net_reset_rate": "partition",
    "partition_worker_names": "partition",
    "partition_after_tasks": "partition",
    "partition_duration_s": "partition",
    "partition_direction": "partition",
    "peer_drop_rate": "partition",
    "peer_delay_rate": "partition",
    "peer_delay_s": "partition",
    "peer_corrupt_rate": "partition",
    "peer_reset_rate": "partition",
    "coordinator_crash_after_dispatches": "coordinator",
    "coordinator_takeover_crash_after_dispatches": "coordinator",
}

EVENT_DOMAINS = {
    "cancel": "cancellation",
    "client_kill": "client_loss",
}

#: fleet-side knobs force the distributed in-process fleet (the threaded
#: executor has no workers to crash, partition, or preempt — and a
#: poison task kills a WORKER process, so "workload" is fleet-side too)
FLEET_KNOBS = frozenset(
    k for k, d in KNOB_DOMAINS.items()
    if d in ("worker_loss", "elasticity", "partition", "coordinator",
             "workload")
)

#: knobs/events that hard-exit the CURRENT process (coordinator crash
#: injection calls os._exit; client_kill SIGKILLs the client process) — only
#: legal in subprocess mode
PROCESS_FAULT_KNOBS = frozenset({
    "coordinator_crash_after_dispatches",
    "coordinator_takeover_crash_after_dispatches",
})
PROCESS_FAULT_EVENTS = frozenset({"client_kill"})


@dataclass
class FaultSchedule:
    """One declarative, seeded timeline of composed faults.

    ``faults`` is a plain FaultConfig-knob dict (validated on run via
    ``FaultConfig.from_dict`` — unknown knobs are a schedule bug, not a
    silent no-op); ``events`` are lifecycle actions the runner itself
    performs (``{"kind": "cancel", "after_completes": n}``,
    ``{"kind": "client_kill", "after_completes": n}``)."""

    seed: int
    workload: str
    faults: dict = field(default_factory=dict)
    events: list = field(default_factory=list)

    @property
    def domains(self) -> set:
        out = {
            KNOB_DOMAINS[k] for k in self.faults
            if k in KNOB_DOMAINS
        }
        out |= {
            EVENT_DOMAINS[e.get("kind")] for e in self.events
            if e.get("kind") in EVENT_DOMAINS
        }
        return out

    @property
    def needs_subprocess(self) -> bool:
        return bool(PROCESS_FAULT_KNOBS & set(self.faults)) or any(
            e.get("kind") in PROCESS_FAULT_EVENTS for e in self.events
        )

    @property
    def needs_fleet(self) -> bool:
        return bool(FLEET_KNOBS & set(self.faults)) or self.needs_subprocess

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "seed": self.seed,
            "workload": self.workload,
            "faults": dict(self.faults),
            "events": [dict(e) for e in self.events],
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "FaultSchedule":
        return cls(
            seed=int(doc["seed"]),
            workload=str(doc["workload"]),
            faults=dict(doc.get("faults") or {}),
            events=[dict(e) for e in doc.get("events") or []],
        )

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "FaultSchedule":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def describe(self) -> str:
        doms = ",".join(sorted(self.domains)) or "none"
        evs = ",".join(e.get("kind", "?") for e in self.events) or "-"
        return (
            f"schedule(seed={self.seed}, workload={self.workload}, "
            f"domains=[{doms}], knobs={len(self.faults)}, events={evs})"
        )


# -- workload matrix ------------------------------------------------------


def _wl_blockwise_chain(ct, xp, spec):
    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    a = ct.from_array(an, chunks=(4, 4), spec=spec)
    lazy = (a * 2.0 + 1.0) * 0.5
    return [("chain", lazy, (an * 2.0 + 1.0) * 0.5)]


def _wl_tree_reduce(ct, xp, spec):
    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    a = ct.from_array(an, chunks=(4, 4), spec=spec)
    lazy = xp.sum(a + 1.0, axis=0)
    return [("reduce", lazy, (an + 1.0).sum(axis=0))]


def _wl_rechunk(ct, xp, spec):
    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    a = ct.from_array(an, chunks=(4, 4), spec=spec)
    lazy = (a + 3.0).rechunk((8, 2)) * 2.0
    return [("rechunk", lazy, (an + 3.0) * 2.0)]


def _wl_overload_flood(ct, xp, spec):
    """A 2x-overload shape: one tenant floods many small computes while a
    victim tenant runs one normal reduce — the overload/poison chaos
    surface. Under a plain campaign every compute must still land
    bitwise; seeding ``task_fatal_*`` on top of it (explicit schedules,
    tests/service/test_overload.py) turns a flood chunk into a poison
    task whose *request* fails while the fleet and the victim survive."""
    pairs = []
    for i in range(5):
        an = np.arange(36, dtype=np.float64).reshape(6, 6) + i
        a = ct.from_array(an, chunks=(3, 3), spec=spec)
        pairs.append((f"flood-{i}", a * 2.0 + float(i), an * 2.0 + float(i)))
    vn = np.arange(144, dtype=np.float64).reshape(12, 12)
    v = ct.from_array(vn, chunks=(4, 4), spec=spec)
    pairs.append(("victim", xp.sum(v + 1.0, axis=0), (vn + 1.0).sum(axis=0)))
    return pairs


def _wl_multi_tenant(ct, xp, spec):
    """Two tenants' requests through one runtime, the shape the service
    layer serves — each must land bitwise in spite of the other's load."""
    an = np.arange(144, dtype=np.float64).reshape(12, 12)
    bn = np.arange(144, dtype=np.float64).reshape(12, 12) * 3.0
    a = ct.from_array(an, chunks=(3, 3), spec=spec)
    b = ct.from_array(bn, chunks=(4, 4), spec=spec)
    return [
        ("tenant-a", a * 2.0, an * 2.0),
        ("tenant-b", xp.sum(b, axis=1), bn.sum(axis=1)),
    ]


WORKLOADS = {
    "blockwise_chain": _wl_blockwise_chain,
    "tree_reduce": _wl_tree_reduce,
    "rechunk": _wl_rechunk,
    "multi_tenant": _wl_multi_tenant,
    "overload_flood": _wl_overload_flood,
}


# -- generation -----------------------------------------------------------

#: knob templates per domain generate() samples from: moderate rates that
#: a 6-retry policy should absorb (campaigns hunt invariant breaks, not
#: guaranteed-fatal outages)
_DOMAIN_TEMPLATES = {
    "storage": [
        {"storage_read_failure_rate": 0.1},
        {"storage_write_failure_rate": 0.1,
         "storage_write_leaves_tmp": True},
        {"storage_throttle_rate": 0.15},
    ],
    "task": [
        {"task_failure_rate": 0.08},
        {"straggler_rate": 0.2, "straggler_delay_s": 0.1},
    ],
    "memory": [
        {"task_mem_spike_rate": 0.1, "task_mem_spike_bytes": 1 << 20},
    ],
    "elasticity": [
        {"worker_preempt_rate": 0.3, "worker_preempt_after_tasks": 2,
         "preempt_notice_s": 0.5},
    ],
    "partition": [
        {"net_msg_delay_rate": 0.2, "net_msg_delay_s": 0.05},
        {"net_msg_dup_rate": 0.15},
        {"partition_worker_names": ("local-1",), "partition_after_tasks": 2,
         "partition_duration_s": 1.0, "partition_direction": "both"},
    ],
    "cancellation": [
        {"__event__": {"kind": "cancel", "after_completes": 3}},
    ],
    # subprocess-only domains (gated on allow_process_faults)
    "coordinator": [
        {"coordinator_crash_after_dispatches": 10},
    ],
    "client_loss": [
        {"__event__": {"kind": "client_kill", "after_completes": 8}},
    ],
}


@dataclass
class CampaignResult:
    """Outcome of running one schedule."""

    schedule: FaultSchedule
    ok: bool
    stage: str  # "ok" | "compute" | "bitwise" | "audit"
    error: Optional[str] = None
    report: Optional[AuditReport] = None
    wall_s: float = 0.0
    stats: dict = field(default_factory=dict)

    @property
    def signature(self) -> tuple:
        """What shrink preserves: the failing stage and error class —
        'the same failure', not 'any failure'."""
        etype = (self.error or "").split(":", 1)[0]
        return (self.stage, etype)

    def render(self) -> str:
        head = (
            f"{'PASS' if self.ok else 'FAIL'} [{self.stage}] "
            f"{self.schedule.describe()} wall={self.wall_s:.2f}s"
        )
        lines = [head]
        if self.error:
            lines.append(f"  error: {self.error}")
        if self.report is not None and not self.report.ok:
            lines.extend(
                "  " + v.render() for v in self.report.violations
            )
        return "\n".join(lines)


class CampaignRunner:
    """Generate, run, shrink, and replay composed-failure schedules."""

    def __init__(
        self,
        base_dir: str,
        retries: int = 6,
        allowed_mem: str = "500MB",
        gensym_base: int = 20_000,
    ):
        self.base_dir = str(base_dir)
        self.retries = retries
        self.allowed_mem = allowed_mem
        self.gensym_base = gensym_base

    # -- generation --------------------------------------------------------

    def generate(
        self,
        seed: int,
        n_domains: int = 3,
        allow_process_faults: bool = False,
    ) -> FaultSchedule:
        """A random schedule from a seed: pick a workload and compose
        knobs from ``n_domains`` (or more) distinct failure domains."""
        rng = random.Random(seed)
        workload = rng.choice(sorted(WORKLOADS))
        pool = [
            d for d in sorted(_DOMAIN_TEMPLATES)
            if allow_process_faults or d not in ("coordinator", "client_loss")
        ]
        n = min(max(n_domains, 3), len(pool))
        domains = rng.sample(pool, n)
        faults: dict = {"seed": seed}
        events: list = []
        for d in domains:
            tmpl = rng.choice(_DOMAIN_TEMPLATES[d])
            for k, v in tmpl.items():
                if k == "__event__":
                    events.append(dict(v))
                else:
                    faults[k] = v
        return FaultSchedule(
            seed=seed, workload=workload, faults=faults, events=events
        )

    # -- running -----------------------------------------------------------

    def run(self, schedule: FaultSchedule) -> CampaignResult:
        if schedule.needs_subprocess:
            return self._run_subprocess(schedule)
        return self._run_inprocess(schedule)

    def _scratch(self, schedule: FaultSchedule) -> str:
        # named by the schedule's content, not by a count of runs: the
        # create-arrays task's key holds its store's path, so a path that
        # changed from run to run would roll that task's faults anew
        digest = hashlib.sha256(json.dumps(schedule.to_dict(), sort_keys=True).encode()).hexdigest()[:12]
        d = os.path.join(self.base_dir, f"campaign-{schedule.seed}-{digest}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d, exist_ok=True)
        return d

    def _run_inprocess(self, schedule: FaultSchedule) -> CampaignResult:
        import cubed_tpu_torch as ct
        import cubed_tpu_torch.array_api as xp
        from cubed_tpu_torch import utils as ct_utils
        from cubed_tpu_torch.observability.metrics import get_registry

        from .faults import FaultConfig
        from .resilience import RetryPolicy

        t0 = time.monotonic()
        scratch = self._scratch(schedule)
        journal = os.path.join(scratch, "compute.journal")
        work_dir = os.path.join(scratch, "work")
        control_dir = os.path.join(scratch, "control")

        faults = dict(schedule.faults)

        # pin plan names so this schedule's injector decisions replay
        # identically run over run (bench/brownout idiom)
        resume_at = next(ct_utils.sym_counter)
        ct_utils.sym_counter = itertools.count(self.gensym_base)
        stage, error, report = "ok", None, None
        delta: dict = {}
        try:
            # schedule bugs (unknown knobs) must fail loudly as a campaign
            # verdict, not inject nothing
            FaultConfig.from_dict(faults)
            spec = ct.Spec(
                work_dir=work_dir,
                allowed_mem=self.allowed_mem,
                fault_injection=faults or None,
                journal=journal,
                integrity="verify" if faults.get(
                    "storage_corrupt_rate"
                ) else None,
            )
            pairs = WORKLOADS[schedule.workload](ct, xp, spec)
            policy = RetryPolicy(
                retries=self.retries, backoff_base=0.01, seed=0
            )
            before = get_registry().snapshot()
            if schedule.needs_fleet:
                from .executors.distributed import DistributedDagExecutor

                ex = DistributedDagExecutor(
                    n_local_workers=2,
                    control_dir=control_dir,
                    retry_policy=policy,
                )
            else:
                from .executors.python_async import AsyncPythonDagExecutor

                ex = AsyncPythonDagExecutor(retry_policy=policy)
            try:
                for name, lazy, expected in pairs:
                    result = self._compute_one(
                        lazy, ex, schedule, journal
                    )
                    if not np.array_equal(np.asarray(result), expected):
                        stage, error = "bitwise", (
                            f"BitwiseMismatch: workload "
                            f"{schedule.workload}/{name} diverged"
                        )
                        break
            finally:
                close = getattr(ex, "close", None)
                if close:
                    close()
            delta = get_registry().snapshot_delta(before)
        except Exception as e:  # noqa: BLE001 — the verdict IS the product
            stage = "compute"
            error = f"{type(e).__name__}: {e}"
        finally:
            used = next(ct_utils.sym_counter) - self.gensym_base
            ct_utils.sym_counter = itertools.count(resume_at + used)

        if stage == "ok":
            report = InvariantAuditor(
                journal=journal,
                control_dir=control_dir if schedule.needs_fleet else None,
                work_dir=work_dir,
                metrics=delta,
                expect_success=True,
            ).audit()
            if not report.ok:
                stage = "audit"
                error = "; ".join(
                    sorted({v.invariant for v in report.violations})
                )
        ok = stage == "ok"
        if ok:
            shutil.rmtree(scratch, ignore_errors=True)
        return CampaignResult(
            schedule=schedule, ok=ok, stage=stage, error=error,
            report=report, wall_s=time.monotonic() - t0,
            stats={
                k: delta[k] for k in (
                    "faults_injected", "task_retries",
                    "worker_loss_requeues", "cancellations",
                    "tasks_skipped_resume", "chunks_quarantined",
                ) if delta.get(k)
            },
        )

    def _compute_one(self, lazy, ex, schedule: FaultSchedule, journal: str):
        """One workload compute, applying in-process lifecycle events
        (mid-compute cancel + journal resume)."""
        from .cancellation import CancellationToken, ComputeCancelledError

        cancel_ev = next(
            (e for e in schedule.events if e.get("kind") == "cancel"), None
        )
        if cancel_ev is None:
            return lazy.compute(executor=ex)

        tok = CancellationToken()
        after = int(cancel_ev.get("after_completes", 3))

        class _CancelAfter:
            seen = 0

            def on_task_end(self, event):
                self.seen += 1
                if self.seen == after and not tok.cancelled:
                    tok.cancel("campaign cancel event")

        try:
            result = lazy.compute(
                executor=ex, cancellation=tok, callbacks=[_CancelAfter()]
            )
            # compute finished before the event fired (tiny workloads can
            # legally outrun the trigger) — still a valid run
            return result
        except ComputeCancelledError:
            # the event fired: the resumed compute must land bitwise,
            # proving cancel composed with the other domains lost nothing
            return lazy.compute(executor=ex, resume_from_journal=journal)

    # -- subprocess mode ---------------------------------------------------

    _CHILD_SCRIPT = r"""
import json, sys
from cubed_tpu_torch.runtime.campaign import CampaignRunner, FaultSchedule

doc = json.load(open(sys.argv[1]))
sched = FaultSchedule.from_dict(doc["schedule"])
# the child runs the schedule minus the process-fault events the PARENT
# performs (client_kill) — coordinator-crash knobs stay: they kill the
# child, which is the point
sched.events = [
    e for e in sched.events if e.get("kind") != "client_kill"
]
runner = CampaignRunner(doc["base_dir"], gensym_base=doc["gensym_base"])
res = runner._run_inprocess(sched)
print(json.dumps({"ok": res.ok, "stage": res.stage, "error": res.error}))
"""

    def _run_subprocess(self, schedule: FaultSchedule) -> CampaignResult:
        """Run a process-fault schedule in a child interpreter.

        Coordinator-crash knobs hard-exit the child (exit 137 shape);
        ``client_kill`` events SIGKILL it from here. Either way the
        parent audits the artifacts the child left and, for a killed
        child, re-runs in a fresh child WITHOUT the process faults to
        prove the journal/control artifacts support recovery."""
        import signal
        import subprocess
        import sys

        t0 = time.monotonic()
        scratch = self._scratch(schedule)
        plan_path = os.path.join(scratch, "child-plan.json")
        child_base = os.path.join(scratch, "child")
        with open(plan_path, "w") as f:
            json.dump({
                "schedule": schedule.to_dict(),
                "base_dir": child_base,
                "gensym_base": self.gensym_base,
            }, f)

        from ..backend_array_api import DEVICE_ENV_VAR, get_device
        from .executors.distributed import _worker_env

        env = _worker_env()
        env[DEVICE_ENV_VAR] = str(get_device())

        kill_ev = next(
            (e for e in schedule.events if e.get("kind") == "client_kill"),
            None,
        )
        proc = subprocess.Popen(
            [sys.executable, "-c", self._CHILD_SCRIPT, plan_path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        killed = False
        if kill_ev is not None:
            delay = float(kill_ev.get("after_s", 2.0))
            try:
                proc.wait(timeout=delay)
            except subprocess.TimeoutExpired:
                os.kill(proc.pid, signal.SIGKILL)
                killed = True
        out, err = proc.communicate(timeout=600)
        rc = proc.returncode

        stage, error = "ok", None
        if killed or rc != 0:
            # the process fault fired; a clean replay (faults stripped)
            # must now succeed from the same seed
            clean = FaultSchedule(
                seed=schedule.seed, workload=schedule.workload,
                faults={
                    k: v for k, v in schedule.faults.items()
                    if k not in PROCESS_FAULT_KNOBS
                },
                events=[
                    e for e in schedule.events
                    if e.get("kind") not in PROCESS_FAULT_EVENTS
                ],
            )
            res2 = self._run_inprocess(clean)
            if not res2.ok:
                stage, error = res2.stage, res2.error
            report = res2.report
        else:
            try:
                verdict = json.loads(out.strip().splitlines()[-1])
            except (ValueError, IndexError):
                verdict = {"ok": False, "stage": "compute",
                           "error": f"child rc={rc}: {err[-500:]}"}
            if not verdict.get("ok"):
                stage = verdict.get("stage", "compute")
                error = verdict.get("error")
            report = None
        ok = stage == "ok"
        if ok:
            shutil.rmtree(scratch, ignore_errors=True)
        return CampaignResult(
            schedule=schedule, ok=ok, stage=stage, error=error,
            report=report, wall_s=time.monotonic() - t0,
            stats={"child_rc": rc, "child_killed": killed},
        )

    # -- shrinking ---------------------------------------------------------

    def _atoms(self, schedule: FaultSchedule) -> list:
        """The removable units of a schedule: knob groups + events."""
        atoms = []
        present = set(schedule.faults)
        for group in KNOB_ATOMS:
            if present & set(group):
                atoms.append(("knobs", group))
        for i, _e in enumerate(schedule.events):
            atoms.append(("event", i))
        return atoms

    @staticmethod
    def _without(schedule: FaultSchedule, atom) -> FaultSchedule:
        kind, spec = atom
        if kind == "knobs":
            faults = {
                k: v for k, v in schedule.faults.items() if k not in spec
            }
            return FaultSchedule(
                seed=schedule.seed, workload=schedule.workload,
                faults=faults, events=[dict(e) for e in schedule.events],
            )
        events = [
            dict(e) for i, e in enumerate(schedule.events) if i != spec
        ]
        return FaultSchedule(
            seed=schedule.seed, workload=schedule.workload,
            faults=dict(schedule.faults), events=events,
        )

    def shrink(
        self,
        schedule: FaultSchedule,
        signature: Optional[tuple] = None,
        check: Optional[Callable[[FaultSchedule], bool]] = None,
        log: Optional[Callable[[str], None]] = None,
    ) -> FaultSchedule:
        """Greedy delta-debugging: repeatedly drop any fault atom whose
        removal still reproduces the failure (same stage + error class),
        until no single atom can be removed. Returns the minimal
        schedule (the input itself if already minimal)."""
        say = log or (lambda _m: None)
        if check is None:
            want = signature
            if want is None:
                first = self.run(schedule)
                if first.ok:
                    raise ValueError(
                        "cannot shrink a passing schedule: "
                        + schedule.describe()
                    )
                want = first.signature

            def check(s: FaultSchedule) -> bool:
                return self.run(s).signature == want

        current = schedule
        progress = True
        while progress:
            progress = False
            for atom in self._atoms(current):
                candidate = self._without(current, atom)
                say(f"shrink: trying without {atom[1]}")
                if check(candidate):
                    say(f"shrink: dropped {atom[1]}")
                    current = candidate
                    progress = True
                    break
        return current

    # -- repro files -------------------------------------------------------

    def write_repro(
        self, schedule: FaultSchedule, result: CampaignResult,
        path: Optional[str] = None,
    ) -> str:
        path = path or os.path.join(
            self.base_dir, f"repro-{schedule.seed}.json"
        )
        doc = schedule.to_dict()
        doc["failure"] = {
            "stage": result.stage,
            "error": result.error,
            "violations": [
                {"invariant": v.invariant, "message": v.message,
                 "context": v.context}
                for v in (result.report.violations if result.report else [])
            ],
        }
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    def replay(self, repro_path: str) -> CampaignResult:
        return self.run(FaultSchedule.load(repro_path))

    # -- campaign loop -----------------------------------------------------

    def run_campaign(
        self,
        seeds,
        n_domains: int = 3,
        allow_process_faults: bool = False,
        log: Optional[Callable[[str], None]] = None,
    ) -> dict:
        """Generate + run a schedule per seed; shrink and write a repro
        for every failure. Returns a summary dict."""
        say = log or (lambda _m: None)
        passed, failures = 0, []
        for seed in seeds:
            sched = self.generate(
                seed, n_domains=n_domains,
                allow_process_faults=allow_process_faults,
            )
            say(f"seed {seed}: {sched.describe()}")
            res = self.run(sched)
            say("  " + res.render().splitlines()[0])
            if res.ok:
                passed += 1
                continue
            say("  shrinking to a minimal reproducing subset ...")
            minimal = self.shrink(sched, signature=res.signature, log=say)
            repro = self.write_repro(minimal, self.run(minimal))
            say(f"  repro written: {repro}")
            failures.append({
                "seed": seed, "stage": res.stage, "error": res.error,
                "repro": repro, "minimal": minimal.to_dict(),
            })
        return {
            "total": passed + len(failures),
            "passed": passed,
            "failures": failures,
        }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cubed_tpu_torch.chaos",
        description="Composed-failure chaos campaigns: run seeded "
        "schedules over the workload matrix, shrink failures, replay "
        "repro files.",
    )
    parser.add_argument(
        "--seed", type=int, help="run the one schedule generated from "
        "this seed"
    )
    parser.add_argument(
        "--campaign", type=int, metavar="N",
        help="soak: run schedules for seeds 0..N-1",
    )
    parser.add_argument(
        "--repro", metavar="FILE", help="replay a repro schedule file"
    )
    parser.add_argument(
        "--base-dir", default="chaos-campaigns",
        help="scratch + repro output directory (default: %(default)s)",
    )
    parser.add_argument(
        "--domains", type=int, default=3,
        help="failure domains composed per generated schedule "
        "(default: %(default)s)",
    )
    parser.add_argument(
        "--allow-process-faults", action="store_true",
        help="let generated schedules include coordinator/client kills "
        "(subprocess mode)",
    )
    args = parser.parse_args(argv)
    modes = [m for m in (args.seed is not None, args.campaign is not None,
                         args.repro) if m]
    if len(modes) != 1:
        parser.error("pass exactly one of --seed, --campaign, --repro")

    runner = CampaignRunner(args.base_dir)
    if args.repro:
        res = runner.replay(args.repro)
        print(res.render())
        return 0 if res.ok else 1
    if args.seed is not None:
        sched = runner.generate(
            args.seed, n_domains=args.domains,
            allow_process_faults=args.allow_process_faults,
        )
        print(sched.describe())
        res = runner.run(sched)
        print(res.render())
        if not res.ok:
            minimal = runner.shrink(
                sched, signature=res.signature, log=print
            )
            repro = runner.write_repro(minimal, runner.run(minimal))
            print(f"repro written: {repro}")
        return 0 if res.ok else 1
    summary = runner.run_campaign(
        range(args.campaign), n_domains=args.domains,
        allow_process_faults=args.allow_process_faults, log=print,
    )
    print(json.dumps(
        {k: v for k, v in summary.items() if k != "failures"}
    ))
    for f in summary["failures"]:
        print(f"FAIL seed={f['seed']} stage={f['stage']}: {f['repro']}")
    return 0 if not summary["failures"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
