"""The post-hoc invariant auditor: every invariant of the catalogue is
detected by name when deliberately broken in synthetic artifacts, stays
silent on legal histories, and runs clean on a real compute's artifacts.
Every audit here is held against the JAX package's auditor on the same
artifacts, and a JAX-package compute's artifacts audit alike. Counterpart
of tests/runtime/test_audit.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import json
import zlib

import numpy as np
import pytest

import cubed_tpu_torch as ct
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime.audit import (
    InvariantAuditor as PortAuditor,
    journal_segments,
    main as audit_main,
)
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor
from cubed_tpu_torch.runtime.resilience import RetryPolicy
from ._torch_chaos import clean_process, pinned_names  # noqa: E402,F401


def _verdict(report) -> tuple:
    return (report.ok, list(report.checked), [(v.invariant, v.message, v.context) for v in report.violations],
            report.stats)


class InvariantAuditor(PortAuditor):
    """The port's auditor, held against the JAX package's on every audit
    in this file: the same artifacts give the same checks, violations and
    stats."""

    def audit(self):
        from cubed_tpu.runtime.audit import InvariantAuditor as RefAuditor

        report = super().audit()
        ref = RefAuditor(journal=self.journal, control_dir=self.control_dir, work_dir=self.work_dir,
                         metrics=self.metrics, expect_success=self.expect_success).audit()
        assert _verdict(report) == _verdict(ref), (report.render(), ref.render())
        return report


def audit_artifacts(**kwargs):
    return InvariantAuditor(**kwargs).audit()


@pytest.fixture(autouse=True)
def _restore_gensym_names():
    """This suite creates arrays; later suites' seeded chaos decisions
    key on array NAMES (store._fault_key), so leave the global gensym
    counter exactly where it started."""
    import itertools

    from cubed_tpu_torch import utils as ct_utils

    n0 = next(ct_utils.sym_counter)
    ct_utils.sym_counter = itertools.count(n0)
    yield
    ct_utils.sym_counter = itertools.count(n0)


def _write_jsonl(path, records):
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return str(path)


def _journal(tmp_path, records, name="compute.journal"):
    return _write_jsonl(tmp_path / name, records)


def _control(tmp_path, records, rendezvous=None):
    d = tmp_path / "control"
    d.mkdir(exist_ok=True)
    _write_jsonl(d / "control.jsonl", records)
    if rendezvous is not None:
        (d / "rendezvous.json").write_text(json.dumps(rendezvous))
    return str(d)


# -- exactly_once_application ---------------------------------------------


def test_duplicate_application_detected_and_named(tmp_path):
    journal = _journal(tmp_path, [
        {"kind": "compute_start", "compute_id": "c1"},
        {"kind": "dispatch", "op": "op-a", "key": [0, 0], "attempt": 0},
        {"kind": "complete", "op": "op-a", "key": [0, 0]},
        {"kind": "complete", "op": "op-a", "key": [0, 0]},  # twin leaked
    ])
    report = audit_artifacts(journal=journal)
    assert not report.ok
    assert report.by_invariant("exactly_once_application"), report.render()
    assert "2 times" in report.by_invariant(
        "exactly_once_application"
    )[0].message


def test_application_without_dispatch_detected(tmp_path):
    journal = _journal(tmp_path, [
        {"kind": "compute_start", "compute_id": "c1"},
        {"kind": "complete", "op": "op-a", "key": [1, 0]},  # from nowhere
    ])
    report = audit_artifacts(journal=journal)
    names = {v.invariant for v in report.violations}
    assert "exactly_once_application" in names, report.render()


def test_rerun_across_segments_is_legal(tmp_path):
    # resume re-running a task in a NEW run segment is not a duplicate
    journal = _journal(tmp_path, [
        {"kind": "compute_start", "compute_id": "c1"},
        {"kind": "dispatch", "op": "op-a", "key": [0, 0], "attempt": 0},
        {"kind": "complete", "op": "op-a", "key": [0, 0]},
        {"kind": "compute_start", "compute_id": "c1", "resume": True},
        {"kind": "dispatch", "op": "op-a", "key": [0, 0], "attempt": 0},
        {"kind": "complete", "op": "op-a", "key": [0, 0]},
    ])
    report = audit_artifacts(journal=journal)
    assert report.ok, report.render()
    assert report.stats["journal_segments"] == 2


def test_retry_attempts_within_segment_are_legal(tmp_path):
    journal = _journal(tmp_path, [
        {"kind": "compute_start", "compute_id": "c1"},
        {"kind": "dispatch", "op": "op-a", "key": [0, 0], "attempt": 0},
        {"kind": "dispatch", "op": "op-a", "key": [0, 0], "attempt": 1},
        {"kind": "complete", "op": "op-a", "key": [0, 0]},
    ])
    assert audit_artifacts(journal=journal).ok


# -- single_ownership -----------------------------------------------------


def test_silent_redispatch_detected_and_named(tmp_path):
    control_dir = _control(tmp_path, [
        {"kind": "epoch", "epoch": 1, "addr": ["h", 1]},
        {"kind": "dispatch", "task_id": "t1", "tag": "op-a", "worker": "w1"},
        {"kind": "dispatch", "task_id": "t1", "tag": "op-a", "worker": "w2"},
    ])
    report = audit_artifacts(control_dir=control_dir)
    vs = report.by_invariant("single_ownership")
    assert vs, report.render()
    assert vs[0].context["from"] == "w1"
    assert vs[0].context["to"] == "w2"


def test_redispatch_after_worker_gone_is_legal(tmp_path):
    control_dir = _control(tmp_path, [
        {"kind": "dispatch", "task_id": "t1", "tag": "op-a", "worker": "w1"},
        {"kind": "worker_gone", "name": "w1"},
        {"kind": "dispatch", "task_id": "t1", "tag": "op-a", "worker": "w2"},
    ])
    assert audit_artifacts(control_dir=control_dir).ok


def test_redispatch_after_requeue_decision_is_legal(tmp_path):
    control_dir = _control(tmp_path, [
        {"kind": "dispatch", "task_id": "t1", "tag": "op-a", "worker": "w1"},
        {"kind": "decision", "epoch": 1, "decision": "lease_expired",
         "worker": "w1"},
        {"kind": "dispatch", "task_id": "t1", "tag": "op-a", "worker": "w2"},
    ])
    assert audit_artifacts(control_dir=control_dir).ok


def test_redispatch_after_done_is_legal(tmp_path):
    # a finished task re-dispatched later (a new compute reusing ids)
    control_dir = _control(tmp_path, [
        {"kind": "dispatch", "task_id": "t1", "tag": "op-a", "worker": "w1"},
        {"kind": "done", "task_id": "t1"},
        {"kind": "dispatch", "task_id": "t1", "tag": "op-b", "worker": "w2"},
    ])
    assert audit_artifacts(control_dir=control_dir).ok


# -- epoch_monotonicity ---------------------------------------------------


def test_epoch_regression_detected_and_named(tmp_path):
    control_dir = _control(tmp_path, [
        {"kind": "epoch", "epoch": 1, "addr": ["h", 1]},
        {"kind": "epoch", "epoch": 3, "addr": ["h", 2]},
        {"kind": "epoch", "epoch": 2, "addr": ["h", 3]},  # fence went back
    ])
    report = audit_artifacts(control_dir=control_dir)
    vs = report.by_invariant("epoch_monotonicity")
    assert vs, report.render()
    assert "3 to 2" in vs[0].message


def test_rendezvous_ahead_of_durable_record_detected(tmp_path):
    control_dir = _control(
        tmp_path,
        [{"kind": "epoch", "epoch": 2, "addr": ["h", 1]}],
        rendezvous={"epoch": 9, "addr": ["h", 9], "t": 0},
    )
    report = audit_artifacts(control_dir=control_dir)
    vs = report.by_invariant("epoch_monotonicity")
    assert vs, report.render()
    assert "advertises epoch 9" in vs[0].message


def test_increasing_epochs_with_matching_rendezvous_clean(tmp_path):
    control_dir = _control(
        tmp_path,
        [
            {"kind": "epoch", "epoch": 1, "addr": ["h", 1]},
            {"kind": "epoch", "epoch": 2, "addr": ["h", 2]},
        ],
        rendezvous={"epoch": 2, "addr": ["h", 2], "t": 0},
    )
    assert audit_artifacts(control_dir=control_dir).ok


# -- manifest_store_crc ---------------------------------------------------


def _store_with_manifest(tmp_path, data=b"chunk-bytes", key="0.0"):
    store = tmp_path / "work" / "arr"
    store.mkdir(parents=True)
    (store / key).write_bytes(data)
    crc = zlib.crc32(data) & 0xFFFFFFFF
    (store / ".manifest-test.json").write_text(
        json.dumps({"k": key, "c": crc, "n": len(data), "t": 1.0}) + "\n"
    )
    return store


def test_matching_manifest_and_store_clean(tmp_path):
    _store_with_manifest(tmp_path)
    assert audit_artifacts(work_dir=str(tmp_path / "work")).ok


def test_undetected_corruption_detected_and_named(tmp_path):
    store = _store_with_manifest(tmp_path)
    (store / "0.0").write_bytes(b"chunk-bytEs")  # bit-flip after manifest
    report = audit_artifacts(work_dir=str(tmp_path / "work"))
    vs = report.by_invariant("manifest_store_crc")
    assert vs, report.render()
    assert "disagree" in vs[0].message


def test_missing_chunk_without_quarantine_detected(tmp_path):
    store = _store_with_manifest(tmp_path)
    os.unlink(store / "0.0")
    report = audit_artifacts(work_dir=str(tmp_path / "work"))
    vs = report.by_invariant("manifest_store_crc")
    assert vs, report.render()
    assert "missing" in vs[0].message


def test_quarantined_chunk_is_legal(tmp_path):
    # quarantine renames the chunk but keeps the manifest entry on purpose
    store = _store_with_manifest(tmp_path)
    os.replace(store / "0.0", store / "0.0.quarantine.1000")
    assert audit_artifacts(work_dir=str(tmp_path / "work")).ok


# -- retry_budget_conservation / counter_conservation ---------------------


def test_unaccounted_retry_detected_and_named():
    report = audit_artifacts(metrics={
        "task_retries": 3, "retry_backoff_s": {"count": 2, "sum": 0.1},
    })
    vs = report.by_invariant("retry_budget_conservation")
    assert vs, report.render()


def test_success_claim_with_tripped_breaker_detected():
    report = InvariantAuditor(
        metrics={"retry_budget_exhausted": 1, "task_retries": 0},
        expect_success=True,
    ).audit()
    vs = report.by_invariant("retry_budget_conservation")
    assert vs, report.render()
    assert "circuit breaker" in vs[0].message


def test_fault_counter_nonconservation_detected():
    report = audit_artifacts(metrics={
        "faults_injected": 5,
        "faults_injected_storage_read": 2,
        "faults_injected_task": 2,  # sums to 4, not 5
    })
    vs = report.by_invariant("counter_conservation")
    assert vs, report.render()


def test_completions_exceeding_starts_detected():
    report = audit_artifacts(metrics={
        "tasks_started": 3, "tasks_completed": 5,
    })
    vs = report.by_invariant("counter_conservation")
    assert vs, report.render()


def test_completions_exceeding_dispatches_in_segment_detected(tmp_path):
    journal = _journal(tmp_path, [
        {"kind": "compute_start", "compute_id": "c1"},
        {"kind": "dispatch", "op": "op-a", "key": [0], "attempt": 0},
        {"kind": "complete", "op": "op-a", "key": [0]},
        {"kind": "complete", "op": "op-b", "key": [1]},
        {"kind": "complete", "op": "op-b", "key": [2]},
    ])
    report = audit_artifacts(journal=journal)
    names = {v.invariant for v in report.violations}
    assert "counter_conservation" in names, report.render()


def test_balanced_metrics_clean():
    report = audit_artifacts(
        metrics={
            "task_retries": 2, "retry_backoff_s": {"count": 2, "sum": 0.1},
            "tasks_started": 10, "tasks_completed": 8,
            "faults_injected": 4,
            "faults_injected_storage_read": 1,
            "faults_injected_task": 3,
        },
    )
    assert report.ok, report.render()
    assert "retry_budget_conservation" in report.checked
    assert "counter_conservation" in report.checked


# -- tolerance + plumbing -------------------------------------------------


def test_torn_journal_lines_tolerated(tmp_path):
    path = tmp_path / "compute.journal"
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "compute_start"}) + "\n")
        f.write(json.dumps(
            {"kind": "dispatch", "op": "a", "key": [0], "attempt": 0}
        ) + "\n")
        f.write(json.dumps({"kind": "complete", "op": "a", "key": [0]}) + "\n")
        f.write('{"kind": "comp')  # torn tail from a crash
    assert audit_artifacts(journal=str(path)).ok


def test_nothing_to_audit_reports_nothing_checked(tmp_path):
    report = InvariantAuditor(journal=str(tmp_path / "absent")).audit()
    assert report.ok
    assert report.checked == []


def test_journal_segments_split_on_compute_start(tmp_path):
    journal = _journal(tmp_path, [
        {"kind": "compute_start", "compute_id": "c1"},
        {"kind": "dispatch", "op": "a", "key": [0], "attempt": 0},
        {"kind": "compute_start", "compute_id": "c1", "resume": True},
        {"kind": "complete", "op": "a", "key": [0]},
    ])
    segs = journal_segments(journal)
    assert len(segs) == 2
    assert segs[0]["meta"]["compute_id"] == "c1"
    assert segs[1]["meta"].get("resume") is True


def test_report_render_names_every_violation(tmp_path):
    journal = _journal(tmp_path, [
        {"kind": "compute_start"},
        {"kind": "complete", "op": "a", "key": [0]},
    ])
    report = audit_artifacts(journal=journal)
    text = report.render()
    assert "VIOLATED" in text
    assert "exactly_once_application" in text


# -- CLI ------------------------------------------------------------------


def test_cli_clean_exit_zero(tmp_path, capsys):
    journal = _journal(tmp_path, [
        {"kind": "compute_start"},
        {"kind": "dispatch", "op": "a", "key": [0], "attempt": 0},
        {"kind": "complete", "op": "a", "key": [0]},
    ])
    assert audit_main(["--journal", journal]) == 0
    assert "CLEAN" in capsys.readouterr().out


def test_cli_violation_exit_one_and_names_invariant(tmp_path, capsys):
    journal = _journal(tmp_path, [
        {"kind": "compute_start"},
        {"kind": "dispatch", "op": "a", "key": [0], "attempt": 0},
        {"kind": "complete", "op": "a", "key": [0]},
        {"kind": "complete", "op": "a", "key": [0]},
    ])
    assert audit_main(["--journal", journal]) == 1
    assert "exactly_once_application" in capsys.readouterr().out


def test_cli_requires_an_artifact():
    with pytest.raises(SystemExit):
        audit_main([])


# -- fixes surfaced by the auditor ----------------------------------------


def test_long_chunk_keys_do_not_alias():
    """Regression: journal/resume/audit identify tasks by (op, chunk_key);
    the old prefix-only truncation aliased distinct create-arrays keys
    sharing a long work-dir path — the auditor flagged the aliases as
    duplicate result application. Shortened keys now carry a digest."""
    from cubed_tpu_torch.runtime.utils import chunk_key

    base = "LazyZarrArray</deep/tmp/prefix/" + "x" * 150
    k1 = chunk_key(base + "/array-000000004.zarr>")
    k2 = chunk_key(base + "/array-000000007.zarr>")
    assert k1 != k2, k1
    assert k1 == chunk_key(base + "/array-000000004.zarr>")  # stable
    assert len(k1) <= 120
    # short keys stay verbatim (resume frontiers written by older runs
    # only ever contained short keys or aliased long ones)
    assert chunk_key("('op-a', 0, 1)") == "('op-a', 0, 1)"


# -- end to end on a real compute ----------------------------------------


def test_auditor_clean_on_real_chaos_compute(tmp_path):
    """A real flaky compute's artifacts (journal + work dir + metrics
    delta) audit clean — the production shape the chaos suites retrofit."""
    journal = str(tmp_path / "compute.journal")
    spec = ct.Spec(
        work_dir=str(tmp_path / "work"), allowed_mem="500MB",
        journal=journal,
        fault_injection=dict(
            seed=42, storage_write_failure_rate=0.1, task_failure_rate=0.05
        ),
    )
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    with pinned_names(7_300_000):
        a = ct.from_array(an, chunks=(2, 2), spec=spec)
    before = get_registry().snapshot()
    result = (a + 1.0).compute(
        executor=AsyncPythonDagExecutor(
            retry_policy=RetryPolicy(retries=6, backoff_base=0.01, seed=0)
        )
    )
    np.testing.assert_array_equal(result, an + 1.0)
    delta = get_registry().snapshot_delta(before)
    report = InvariantAuditor(
        journal=journal, work_dir=str(tmp_path / "work"),
        metrics=delta, expect_success=True,
    ).audit()
    assert report.ok, report.render()
    assert "exactly_once_application" in report.checked
    assert report.stats["journal_segments"] >= 1


@pytest.fixture(scope="module", autouse=True)
def _clean_process(clean_process):
    yield


def test_jax_package_artifacts_audit_alike(tmp_path):
    """A flaky compute of the JAX package (its journal, its work dir's
    manifests, its metrics delta) audits clean by both auditors, with the
    same checks and stats; a byte flipped in one of its chunks is the same
    named violation to both."""
    import cubed_tpu
    from cubed_tpu.observability.metrics import get_registry as ref_registry
    from cubed_tpu.runtime.executors.python_async import AsyncPythonDagExecutor as RefAsync
    from cubed_tpu.runtime.resilience import RetryPolicy as RefRetryPolicy

    journal = str(tmp_path / "ref.journal")
    work = str(tmp_path / "work")
    spec = cubed_tpu.Spec(work_dir=work, allowed_mem="500MB", journal=journal,
                          fault_injection=dict(seed=42, storage_write_failure_rate=0.1, task_failure_rate=0.05))
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    with pinned_names(7_310_000):
        a = cubed_tpu.from_array(an, chunks=(2, 2), spec=spec)
    before = ref_registry().snapshot()
    result = (a + 1.0).compute(executor=RefAsync(retry_policy=RefRetryPolicy(retries=6, backoff_base=0.01, seed=0)))
    np.testing.assert_array_equal(result, an + 1.0)
    delta = ref_registry().snapshot_delta(before)
    report = InvariantAuditor(journal=journal, work_dir=work, metrics=delta, expect_success=True).audit()
    assert report.ok, report.render()
    assert report.stats["chunks_reverified"] >= 16
    manifested = [root for root, _d, names in os.walk(work) if any(n.startswith(".manifest-") for n in names)]
    chunk = os.path.join(manifested[0], "0.0")
    data = bytearray(open(chunk, "rb").read())
    data[0] ^= 0xFF
    open(chunk, "wb").write(bytes(data))
    broken = InvariantAuditor(work_dir=work).audit()
    assert [v.invariant for v in broken.violations] == ["manifest_store_crc"]
