"""Post-hoc invariant auditing over the artifacts the system already writes.

Counterpart of ``cubed_tpu/runtime/audit.py``: the same invariant
catalogue, names unchanged, over the same artifact formats (the port's
journal, control log and integrity manifests are the JAX package's, so
either package's auditor reads either's artifacts alike).

Every recovery path in the stack (retries, requeues, takeover, resume,
quarantine) ultimately rests on a handful of *global* invariants that no
single test assertion states: a task's result is applied exactly once per
run, a task has one owner at a time unless a recorded failure event moved
it, every consumed retry was accounted, the store's bytes match the
integrity manifest modulo quarantine, the bookkeeping counters conserve,
and coordinator epochs only move forward. The chaos suites prove *bitwise
output*; this module upgrades those proofs to *bitwise + invariant-clean*
by re-deriving the invariants from durable artifacts after the fact — the
Jepsen discipline: compose failures first, then let a checker (not a
reviewer) decide whether the history was legal.

Inputs (all optional — each invariant runs only when its artifact is
present):

- the **compute journal** (``Spec(journal=...)``, runtime/journal.py):
  per-attempt ``dispatch`` and once-per-task ``complete`` records, split
  into run segments at each ``compute_start``;
- the **control log** (``DistributedDagExecutor(control_dir=...)``):
  epoch fences, worker registrations, the per-task dispatch frontier, and
  the mirrored connectivity decisions;
- the **work dir**: every array store carrying integrity-manifest shards
  is re-read and re-checksummed;
- a **metrics snapshot delta** (``get_registry().snapshot_delta(before)``)
  for the conservation laws counters must obey.

The invariant catalogue (names are stable API — tests and docs key on
them):

``exactly_once_application``
    Within one run segment a ``complete`` record appears at most once per
    ``(op, chunk_key)``, and never without a prior ``dispatch`` of that
    task in the same segment. Re-runs across segments (resume re-running
    an unverifiable task) are legal; double-application within a run —
    e.g. a speculative twin or a replayed fleet result leaking past dedup
    — is not.

``single_ownership``
    In the control log, a task_id re-dispatched to a *different* worker
    requires an intervening ownership-release event: a ``worker_gone``
    record for the previous owner, or a requeue-class decision
    (disconnect, lease expiry, drain, preemption, timeout, takeover).
    Silent re-dispatch means two workers could hold the same assignment.

``retry_budget_conservation``
    Every consumed retry was backoff-spaced exactly once:
    ``retry_backoff_s.count == task_retries`` in the metrics delta. A
    compute that claims success must not have tripped the circuit breaker
    (``retry_budget_exhausted`` = 0 when ``expect_success=True``).

``manifest_store_crc``
    Every manifested chunk is either present with matching CRC-32 and
    byte length, or has been quarantined (``<key>.quarantine.<ts>`` —
    quarantine keeps the manifest entry on purpose). A present chunk
    whose bytes disagree with its manifest is corruption the runtime
    failed to catch; a manifested chunk that vanished without a
    quarantine marker is a silent hole resume would mis-trust.

``counter_conservation``
    Per journal segment, ``complete`` records never exceed ``dispatch``
    records (results cannot outnumber attempts). In the metrics delta,
    ``tasks_completed <= tasks_started`` and ``faults_injected`` equals
    the sum of its per-site counters (each injection increments both).

``epoch_monotonicity``
    Epoch records in the control log are strictly increasing in file
    order, and the rendezvous advertisement never names an epoch newer
    than the last durably recorded one (``record_epoch`` is fsync'd
    *before* ``advertise`` — an advertisement from the future means the
    fence is not durable).

Use ``InvariantAuditor(...).audit()`` programmatically (the chaos suites'
shared fixture does), or ``python -m cubed_tpu_torch.audit --journal J
--control-dir D --work-dir W`` against a production run's artifacts
(exit code 1 names every violated invariant).
"""

from __future__ import annotations

import argparse
import json
import os
import zlib
from dataclasses import dataclass, field
from typing import Optional

#: decision kinds that legitimately release task ownership between two
#: dispatches of the same task_id (the requeue-class events the control
#: plane records when a worker stops being trustworthy or departs)
OWNERSHIP_RELEASE_DECISIONS = frozenset({
    "worker_disconnected",
    "worker_reconnected",
    "lease_expired",
    "requeue",
    "worker_preempted",
    "worker_draining",
    "worker_drained",
    "worker_drain_requested",
    "task_timeout",
    "coordinator_takeover",
    "worker_rejected",
    "spawn_died",
})

#: per-site fault counters are dynamic (``faults_injected_<site>``); the
#: conservation law is total == sum(sites)
FAULTS_TOTAL = "faults_injected"
FAULTS_SITE_PREFIX = "faults_injected_"


@dataclass
class Violation:
    """One invariant breach, with enough context to reproduce the claim."""

    invariant: str
    message: str
    context: dict = field(default_factory=dict)

    def render(self) -> str:
        ctx = " ".join(f"{k}={v}" for k, v in self.context.items())
        return f"[{self.invariant}] {self.message}" + (f"  ({ctx})" if ctx else "")


@dataclass
class AuditReport:
    """The auditor's verdict: which invariants ran, what they found."""

    violations: list = field(default_factory=list)
    checked: list = field(default_factory=list)
    #: artifact stats for the human reading the report (segments folded,
    #: chunks re-checksummed, ...) — diagnostic, not load-bearing
    stats: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def by_invariant(self, name: str) -> list:
        return [v for v in self.violations if v.invariant == name]

    def render(self) -> str:
        lines = [
            f"invariant audit: {'CLEAN' if self.ok else 'VIOLATED'} "
            f"({len(self.checked)} invariant(s) checked: "
            f"{', '.join(self.checked) or 'none'})"
        ]
        for k, v in sorted(self.stats.items()):
            lines.append(f"  {k}: {v}")
        for v in self.violations:
            lines.append("  " + v.render())
        return "\n".join(lines)


def _hashable(v):
    """JSON round-trips chunk keys as lists; fold to tuples so they can
    key the per-segment dispatch/complete maps."""
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v


class _PlainIO:
    """Injection-free local store IO for the auditor: the auditor reads
    ground truth, so it must bypass the fault injector that
    ``storage.store._LocalIO`` consults (an armed injector would make the
    audit roll chaos decisions of its own)."""

    def __init__(self, root: str):
        self.root = root

    def list_names(self) -> list:
        try:
            return os.listdir(self.root)
        except FileNotFoundError:
            return []

    def read_bytes(self, name: str) -> bytes:
        with open(os.path.join(self.root, name), "rb") as f:
            return f.read()

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.root, name))


def _read_jsonl(path: str) -> tuple:
    """All decodable records of a JSONL file, in order, plus the count of
    torn/garbage lines skipped — the same tolerance discipline every
    journal loader in the codebase uses (a torn tail costs its own line,
    never the audit)."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return [], 0
    records, bad = [], 0
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
            if not isinstance(doc, dict):
                raise ValueError("not an object")
        except (ValueError, UnicodeDecodeError):
            bad += 1
            continue
        records.append(doc)
    return records, bad


def journal_segments(path: str) -> list:
    """Split a compute journal into run segments at each ``compute_start``.

    Returns ``[{"meta": compute_start record (or {}), "records": [...]}]``
    — resume and crash-rerun append to one file, so per-run invariants
    must fold per segment, not per file."""
    records, _bad = _read_jsonl(path)
    segments: list = []
    current = {"meta": {}, "records": []}
    for rec in records:
        if rec.get("kind") == "compute_start":
            if current["records"] or current["meta"]:
                segments.append(current)
            current = {"meta": rec, "records": []}
        else:
            current["records"].append(rec)
    if current["records"] or current["meta"]:
        segments.append(current)
    return segments


class InvariantAuditor:
    """Verify global invariants post-hoc from a compute's durable artifacts.

    Every input is optional; each invariant is checked exactly when its
    artifact was provided, and ``AuditReport.checked`` names what actually
    ran — an audit that silently checked nothing must be visible as such.

    Parameters
    ----------
    journal:
        Path to a compute journal (``Spec(journal=...)``).
    control_dir:
        The distributed coordinator's ``control_dir`` (``control.jsonl``
        + ``rendezvous.json``).
    work_dir:
        Root directory scanned for array stores with integrity-manifest
        shards; every manifested chunk is re-read and re-checksummed.
    metrics:
        A metrics snapshot delta covering the compute
        (``get_registry().snapshot_delta(before)``).
    expect_success:
        When True, artifacts of a compute that *claims* it succeeded are
        held to the stricter laws (no budget exhaustion).
    """

    def __init__(
        self,
        journal: Optional[str] = None,
        control_dir: Optional[str] = None,
        work_dir: Optional[str] = None,
        metrics: Optional[dict] = None,
        expect_success: Optional[bool] = None,
    ):
        self.journal = str(journal) if journal else None
        self.control_dir = str(control_dir) if control_dir else None
        self.work_dir = str(work_dir) if work_dir else None
        self.metrics = metrics
        self.expect_success = expect_success

    # -- entry point ----------------------------------------------------

    def audit(self) -> AuditReport:
        report = AuditReport()
        if self.journal and os.path.exists(self.journal):
            self._audit_journal(report)
        if self.control_dir:
            from .journal import control_log_path

            if os.path.exists(control_log_path(self.control_dir)):
                self._audit_control(report)
        if self.work_dir and os.path.isdir(self.work_dir):
            self._audit_manifests(report)
        if self.metrics is not None:
            self._audit_metrics(report)
        return report

    # -- journal: exactly-once + dispatch/complete conservation ---------

    def _audit_journal(self, report: AuditReport) -> None:
        report.checked.append("exactly_once_application")
        if "counter_conservation" not in report.checked:
            report.checked.append("counter_conservation")
        segments = journal_segments(self.journal)
        report.stats["journal_segments"] = len(segments)
        for si, seg in enumerate(segments):
            dispatched: dict = {}
            completed: dict = {}
            n_dispatch = n_complete = 0
            for rec in seg["records"]:
                kind = rec.get("kind")
                op, key = rec.get("op"), _hashable(rec.get("key"))
                if kind == "dispatch" and isinstance(op, str):
                    n_dispatch += 1
                    dispatched[(op, key)] = dispatched.get((op, key), 0) + 1
                elif kind == "complete" and isinstance(op, str):
                    n_complete += 1
                    completed[(op, key)] = completed.get((op, key), 0) + 1
                    if (op, key) not in dispatched:
                        report.violations.append(Violation(
                            "exactly_once_application",
                            "result applied for a task this run never "
                            "dispatched",
                            {"segment": si, "op": op, "key": key},
                        ))
            for (op, key), n in completed.items():
                if n > 1:
                    report.violations.append(Violation(
                        "exactly_once_application",
                        f"result applied {n} times in one run",
                        {"segment": si, "op": op, "key": key},
                    ))
            if n_complete > n_dispatch:
                report.violations.append(Violation(
                    "counter_conservation",
                    f"{n_complete} completions exceed {n_dispatch} "
                    "dispatches in one run segment",
                    {"segment": si},
                ))
            report.stats[f"segment_{si}_dispatches"] = n_dispatch
            report.stats[f"segment_{si}_completes"] = n_complete

    # -- control log: single ownership + epoch monotonicity -------------

    def _audit_control(self, report: AuditReport) -> None:
        from .journal import control_log_path, read_rendezvous, rendezvous_path

        report.checked.append("single_ownership")
        report.checked.append("epoch_monotonicity")
        records, _bad = _read_jsonl(control_log_path(self.control_dir))

        # single ownership: fold the dispatch frontier in file order; a
        # re-dispatch to a new worker needs a release event in between
        owner: dict = {}
        releases_since: dict = {}  # task_id -> release seen since dispatch
        released_workers: set = set()
        redispatches = 0
        for rec in records:
            kind = rec.get("kind")
            if kind == "worker_gone":
                name = rec.get("name")
                released_workers.add(name)
                for tid, w in list(owner.items()):
                    if w == name:
                        releases_since[tid] = True
            elif kind == "decision":
                if rec.get("decision") in OWNERSHIP_RELEASE_DECISIONS:
                    w = rec.get("worker")
                    tid = rec.get("task_id")
                    if tid is not None and tid in owner:
                        releases_since[tid] = True
                    elif w is not None:
                        released_workers.add(w)
                        for t, ow in list(owner.items()):
                            if ow == w:
                                releases_since[t] = True
                    else:
                        # a release event naming neither (e.g. a takeover
                        # marker) releases everything in flight: the new
                        # epoch re-issues under its own fence
                        for t in list(owner):
                            releases_since[t] = True
            elif kind == "worker":
                # a worker (re)registration ends any prior release state
                released_workers.discard(rec.get("name"))
            elif kind == "dispatch":
                tid = rec.get("task_id")
                worker = rec.get("worker")
                if tid is None:
                    continue
                prev = owner.get(tid)
                if (
                    prev is not None
                    and worker != prev
                    and not releases_since.get(tid)
                    and prev not in released_workers
                ):
                    redispatches += 1
                    report.violations.append(Violation(
                        "single_ownership",
                        "task re-dispatched to a second worker with no "
                        "recorded ownership release",
                        {"task_id": tid, "from": prev, "to": worker,
                         "tag": rec.get("tag")},
                    ))
                owner[tid] = worker
                releases_since[tid] = False
            elif kind == "done":
                owner.pop(rec.get("task_id"), None)
                releases_since.pop(rec.get("task_id"), None)

        # epoch monotonicity: strictly increasing fences, and the
        # advertisement never runs ahead of the durable record
        last_epoch = None
        for rec in records:
            if rec.get("kind") != "epoch":
                continue
            e = rec.get("epoch")
            if not isinstance(e, int):
                continue
            if last_epoch is not None and e <= last_epoch:
                report.violations.append(Violation(
                    "epoch_monotonicity",
                    f"epoch fence went from {last_epoch} to {e}",
                    {"control_log": control_log_path(self.control_dir)},
                ))
            last_epoch = e
        adv = read_rendezvous(rendezvous_path(self.control_dir))
        if adv is not None and last_epoch is not None:
            if adv["epoch"] > last_epoch:
                report.violations.append(Violation(
                    "epoch_monotonicity",
                    f"rendezvous advertises epoch {adv['epoch']} but the "
                    f"last durably recorded fence is {last_epoch}",
                    {"control_dir": self.control_dir},
                ))
        report.stats["control_records"] = len(records)
        if last_epoch is not None:
            report.stats["last_epoch"] = last_epoch

    # -- store vs manifest: CRC consistency modulo quarantine ------------

    def _iter_manifest_dirs(self):
        from ..storage.integrity import MANIFEST_PREFIX

        for root, _dirs, names in os.walk(self.work_dir):
            if any(n.startswith(MANIFEST_PREFIX) for n in names):
                yield root

    def _audit_manifests(self, report: AuditReport) -> None:
        from ..storage.integrity import load_manifest

        report.checked.append("manifest_store_crc")
        verified = 0
        stores = 0
        for store_root in self._iter_manifest_dirs():
            stores += 1
            io = _PlainIO(store_root)
            entries, _had = load_manifest(io)
            names = set(io.list_names())
            for key, ent in entries.items():
                quarantined = any(
                    n.startswith(f"{key}.quarantine.") for n in names
                )
                if key not in names:
                    if not quarantined:
                        report.violations.append(Violation(
                            "manifest_store_crc",
                            "manifested chunk is missing with no "
                            "quarantine marker",
                            {"store": store_root, "key": key},
                        ))
                    continue
                try:
                    data = io.read_bytes(key)
                except OSError as e:
                    report.violations.append(Violation(
                        "manifest_store_crc",
                        f"manifested chunk unreadable: {e}",
                        {"store": store_root, "key": key},
                    ))
                    continue
                verified += 1
                if len(data) != ent.get("n") or (
                    zlib.crc32(data) & 0xFFFFFFFF
                ) != ent.get("c"):
                    report.violations.append(Violation(
                        "manifest_store_crc",
                        "chunk bytes disagree with the integrity manifest "
                        "(undetected corruption)",
                        {"store": store_root, "key": key,
                         "manifest_crc": ent.get("c"),
                         "actual_crc": zlib.crc32(data) & 0xFFFFFFFF,
                         "manifest_n": ent.get("n"), "actual_n": len(data)},
                    ))
        report.stats["manifest_stores"] = stores
        report.stats["chunks_reverified"] = verified

    # -- metrics: conservation laws --------------------------------------

    @staticmethod
    def _hist_count(val) -> Optional[int]:
        if isinstance(val, dict):
            c = val.get("count")
            return int(c) if isinstance(c, (int, float)) else None
        return None

    def _audit_metrics(self, report: AuditReport) -> None:
        m = self.metrics or {}
        report.checked.append("retry_budget_conservation")
        if "counter_conservation" not in report.checked:
            report.checked.append("counter_conservation")

        retries = int(m.get("task_retries", 0) or 0)
        backoffs = self._hist_count(m.get("retry_backoff_s"))
        if backoffs is not None and backoffs != retries:
            report.violations.append(Violation(
                "retry_budget_conservation",
                f"{retries} retries drawn from the budget but "
                f"{backoffs} backoff delays scheduled — a retry ran "
                "unaccounted (or was double-counted)",
                {"task_retries": retries, "retry_backoff_count": backoffs},
            ))
        if self.expect_success and int(m.get("retry_budget_exhausted", 0) or 0):
            report.violations.append(Violation(
                "retry_budget_conservation",
                "compute claims success but the retry circuit breaker "
                "tripped",
                {"retry_budget_exhausted": m.get("retry_budget_exhausted")},
            ))

        started = int(m.get("tasks_started", 0) or 0)
        completed = int(m.get("tasks_completed", 0) or 0)
        if completed > started:
            report.violations.append(Violation(
                "counter_conservation",
                f"{completed} tasks completed but only {started} started",
                {"tasks_started": started, "tasks_completed": completed},
            ))
        site_total = sum(
            int(v or 0) for k, v in m.items()
            if k.startswith(FAULTS_SITE_PREFIX) and isinstance(v, (int, float))
        )
        total = int(m.get(FAULTS_TOTAL, 0) or 0)
        if total != site_total:
            report.violations.append(Violation(
                "counter_conservation",
                f"faults_injected={total} but per-site counters sum to "
                f"{site_total}",
                {"faults_injected": total, "site_sum": site_total},
            ))


def audit_artifacts(**kwargs) -> AuditReport:
    """One-call convenience: ``audit_artifacts(journal=..., ...)``."""
    return InvariantAuditor(**kwargs).audit()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m cubed_tpu_torch.audit",
        description="Verify global invariants post-hoc from a compute's "
        "durable artifacts (journal, control log, integrity manifests).",
    )
    parser.add_argument("--journal", help="compute journal JSONL path")
    parser.add_argument(
        "--control-dir", help="coordinator control_dir (control.jsonl)"
    )
    parser.add_argument(
        "--work-dir",
        help="work dir scanned for stores with integrity manifests",
    )
    parser.add_argument(
        "--expect-success", action="store_true",
        help="hold the artifacts to the stricter success-claim laws",
    )
    args = parser.parse_args(argv)
    if not (args.journal or args.control_dir or args.work_dir):
        parser.error(
            "nothing to audit: pass --journal, --control-dir and/or "
            "--work-dir"
        )
    report = InvariantAuditor(
        journal=args.journal,
        control_dir=args.control_dir,
        work_dir=args.work_dir,
        expect_success=args.expect_success or None,
    ).audit()
    print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
