"""Composed-failure campaigns in the port (``cubed_tpu_torch/runtime/campaign.py``),
the cases of tests/runtime/test_campaign.py, and the port held to the JAX
package: the same seed gives the same schedule, and a repro file written by
either package replays the same outcome in the other.

The tier-1 headline: a fixed-seed schedule composing >= 3 failure domains
(storage brownout + spot preemption + network partition, during a rechunk)
completes bitwise-correct AND invariant-auditor-clean on the port's fleet.
"""

from __future__ import annotations

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import itertools  # noqa: E402
import json  # noqa: E402

import pytest  # noqa: E402

from cubed_tpu.runtime import campaign as ref_campaign  # noqa: E402
from cubed_tpu_torch.runtime.campaign import (  # noqa: E402
    KNOB_ATOMS,
    KNOB_DOMAINS,
    WORKLOADS,
    CampaignRunner,
    FaultSchedule,
)
from cubed_tpu_torch.runtime.campaign import main as chaos_main  # noqa: E402

from . import _torch_fleet  # noqa: E402

pytestmark = pytest.mark.chaos


@pytest.fixture(scope="module", autouse=True)
def _clean_process():
    before = _torch_fleet.snapshot()
    _torch_fleet.reset_process_state()
    yield
    _torch_fleet.reset_process_state()
    assert _torch_fleet.leftovers(before) == {"children": [], "listening": []}


@pytest.fixture(autouse=True)
def _restore_gensym_names():
    """CampaignRunner pins plan names per run and advances the name counter
    past what it used; both packages' counters are left where they were."""
    import cubed_tpu.utils as ref_utils
    import cubed_tpu_torch.utils as utils

    n0, r0 = next(utils.sym_counter), next(ref_utils.sym_counter)
    utils.sym_counter, ref_utils.sym_counter = itertools.count(n0), itertools.count(r0)
    yield
    utils.sym_counter, ref_utils.sym_counter = itertools.count(n0), itertools.count(r0)


# -- schedule model -------------------------------------------------------


def test_schedule_roundtrip(tmp_path):
    sched = FaultSchedule(
        seed=7, workload="rechunk",
        faults={"seed": 7, "storage_read_failure_rate": 0.1, "partition_worker_names": ["local-1"]},
        events=[{"kind": "cancel", "after_completes": 3}],
    )
    path = str(tmp_path / "repro-7.json")
    sched.save(path)
    back = FaultSchedule.load(path)
    assert back.to_dict() == sched.to_dict()
    assert back.domains == {"storage", "partition", "cancellation"}
    assert open(path).read() == _ref_saved(sched, tmp_path)


def _ref_saved(sched, tmp_path) -> str:
    path = str(tmp_path / "ref.json")
    ref_campaign.FaultSchedule.from_dict(sched.to_dict()).save(path)
    return open(path).read()


def test_schedule_mode_properties():
    threaded = FaultSchedule(seed=1, workload="blockwise_chain", faults={"seed": 1, "task_failure_rate": 0.1})
    assert not threaded.needs_fleet and not threaded.needs_subprocess
    fleet = FaultSchedule(seed=1, workload="rechunk", faults={"seed": 1, "worker_preempt_rate": 0.3})
    assert fleet.needs_fleet and not fleet.needs_subprocess
    proc = FaultSchedule(seed=1, workload="rechunk", faults={"seed": 1, "coordinator_crash_after_dispatches": 5})
    assert proc.needs_subprocess and proc.needs_fleet
    killer = FaultSchedule(seed=1, workload="rechunk", faults={"seed": 1},
                           events=[{"kind": "client_kill", "after_s": 1.0}])
    assert killer.needs_subprocess
    for s in (threaded, fleet, proc, killer):
        ref = ref_campaign.FaultSchedule.from_dict(s.to_dict())
        assert (s.domains, s.needs_fleet, s.needs_subprocess, s.describe()) == (
            ref.domains, ref.needs_fleet, ref.needs_subprocess, ref.describe())


def test_every_fault_knob_has_a_domain_and_an_atom():
    from dataclasses import fields

    from cubed_tpu_torch.runtime.faults import FaultConfig

    knobs = {f.name for f in fields(FaultConfig)} - {"seed"}
    atom_knobs = {k for group in KNOB_ATOMS for k in group}
    assert knobs == atom_knobs, knobs ^ atom_knobs
    assert knobs == set(KNOB_DOMAINS), knobs ^ set(KNOB_DOMAINS)
    assert KNOB_ATOMS == ref_campaign.KNOB_ATOMS and KNOB_DOMAINS == ref_campaign.KNOB_DOMAINS


def test_generate_deterministic_per_seed_and_composes_domains(tmp_path):
    runner = CampaignRunner(str(tmp_path))
    a = runner.generate(123)
    b = runner.generate(123)
    assert a.to_dict() == b.to_dict()
    assert len(a.domains) >= 3
    assert a.workload in WORKLOADS
    assert not a.needs_subprocess  # process faults are opt-in
    assert any(runner.generate(s).to_dict() != a.to_dict() for s in range(5))


@pytest.mark.parametrize("n_domains,allow", [(3, False), (4, False), (6, True)])
def test_same_seed_same_schedule_as_the_reference(tmp_path, n_domains, allow):
    runner = CampaignRunner(str(tmp_path))
    ref = ref_campaign.CampaignRunner(str(tmp_path / "ref"))
    for seed in range(40):
        mine = runner.generate(seed, n_domains=n_domains, allow_process_faults=allow)
        theirs = ref.generate(seed, n_domains=n_domains, allow_process_faults=allow)
        assert json.dumps(mine.to_dict(), sort_keys=True) == json.dumps(theirs.to_dict(), sort_keys=True)


def test_generate_process_faults_only_when_allowed(tmp_path):
    runner = CampaignRunner(str(tmp_path))
    assert not any(runner.generate(s).needs_subprocess for s in range(30))
    armed = [runner.generate(s, n_domains=6, allow_process_faults=True) for s in range(30)]
    assert any(s.needs_subprocess for s in armed)


def test_unknown_knob_fails_loudly(tmp_path):
    runner = CampaignRunner(str(tmp_path))
    res = runner.run(FaultSchedule(seed=1, workload="blockwise_chain", faults={"seed": 1, "no_such_knob": 0.5}))
    assert not res.ok and res.stage == "compute"
    assert "no_such_knob" in res.error


# -- the tier-1 composed-failure proof ------------------------------------

#: storage brownout + spot preemption + network partition, composed on
#: one seed during a rechunk: >= 3 domains firing simultaneously
COMPOSED_3DOMAIN = FaultSchedule(
    seed=1800,
    workload="rechunk",
    faults={
        "seed": 1800,
        "storage_read_failure_rate": 0.08,
        "storage_write_failure_rate": 0.08,
        "storage_throttle_rate": 0.1,
        "worker_preempt_rate": 0.3,
        "worker_preempt_after_tasks": 2,
        "preempt_notice_s": 0.3,
        "net_msg_delay_rate": 0.15,
        "net_msg_delay_s": 0.05,
        "net_msg_dup_rate": 0.1,
    },
)


def test_composed_three_domain_campaign_bitwise_and_auditor_clean(tmp_path):
    assert len(COMPOSED_3DOMAIN.domains) >= 3, COMPOSED_3DOMAIN.domains
    runner = CampaignRunner(str(tmp_path))
    res = runner.run(COMPOSED_3DOMAIN)
    assert res.ok, res.render()
    assert res.report is not None and res.report.ok, res.report.render()
    for inv in ("exactly_once_application", "single_ownership", "epoch_monotonicity", "manifest_store_crc",
                "retry_budget_conservation", "counter_conservation"):
        assert inv in res.report.checked, res.report.checked
    assert res.stats.get("task_retries", 0) > 0 or res.stats.get("faults_injected", 0) > 0, res.stats


def test_threaded_schedule_deterministic_per_seed(tmp_path):
    """The same seeded schedule rolls identical injector decisions run over
    run (plan names pinned), so the injected-fault count is exactly
    reproducible, and equal to the JAX package's on the same schedule."""
    sched = FaultSchedule(
        seed=77, workload="blockwise_chain",
        faults={"seed": 77, "storage_read_failure_rate": 0.1, "storage_write_failure_rate": 0.1,
                "task_failure_rate": 0.05},
    )
    runner = CampaignRunner(str(tmp_path))
    r1 = runner.run(sched)
    r2 = runner.run(sched)
    assert r1.ok and r2.ok, (r1.render(), r2.render())
    assert r1.stats.get("faults_injected") == r2.stats.get("faults_injected"), (r1.stats, r2.stats)


def test_cancel_event_composes_with_faults_and_resumes_bitwise(tmp_path):
    sched = FaultSchedule(
        seed=31, workload="blockwise_chain",
        faults={"seed": 31, "storage_read_failure_rate": 0.08, "straggler_rate": 0.5, "straggler_delay_s": 0.1},
        events=[{"kind": "cancel", "after_completes": 2}],
    )
    runner = CampaignRunner(str(tmp_path))
    res = runner.run(sched)
    assert res.ok, res.render()
    assert "cancellation" in sched.domains


@pytest.mark.parametrize("workload", ["overload_flood", "multi_tenant", "tree_reduce"])
def test_every_workload_lands_bitwise_under_storage_and_task_faults(tmp_path, workload):
    sched = FaultSchedule(seed=5, workload=workload,
                          faults={"seed": 5, "storage_read_failure_rate": 0.05, "task_failure_rate": 0.05})
    res = CampaignRunner(str(tmp_path)).run(sched)
    assert res.ok, res.render()
    assert res.report is not None and res.report.ok


# -- shrink + repro -------------------------------------------------------


def _failing_schedule():
    # task_failure_rate=1.0 deterministically exhausts the retry budget; the
    # straggler and storage-throttle atoms are passengers shrink must strip
    return FaultSchedule(
        seed=55, workload="blockwise_chain",
        faults={"seed": 55, "task_failure_rate": 1.0, "straggler_rate": 0.2, "straggler_delay_s": 0.05,
                "storage_throttle_rate": 0.05},
    )


def test_failing_schedule_shrinks_to_minimal_and_replays(tmp_path):
    runner = CampaignRunner(str(tmp_path))
    sched = _failing_schedule()
    res = runner.run(sched)
    assert not res.ok and res.stage == "compute", res.render()
    assert res.signature[1] == "FaultInjectedTaskError", res.error

    minimal = runner.shrink(sched, signature=res.signature)
    assert set(minimal.faults) == {"seed", "task_failure_rate"}, minimal.faults
    assert minimal.seed == sched.seed

    final = runner.run(minimal)
    repro = runner.write_repro(minimal, final, str(tmp_path / "repro.json"))
    doc = json.loads(open(repro).read())
    assert doc["failure"]["stage"] == "compute"
    replayed = runner.replay(repro)
    assert replayed.signature == res.signature, replayed.render()


def test_shrink_refuses_passing_schedule(tmp_path):
    runner = CampaignRunner(str(tmp_path))
    sched = FaultSchedule(seed=2, workload="blockwise_chain", faults={"seed": 2})
    with pytest.raises(ValueError, match="passing schedule"):
        runner.shrink(sched)


def test_shrink_drops_irrelevant_event(tmp_path):
    runner = CampaignRunner(str(tmp_path))
    sched = FaultSchedule(
        seed=9, workload="blockwise_chain", faults={"seed": 9, "task_failure_rate": 1.0},
        events=[{"kind": "cancel", "after_completes": 2}],
    )
    minimal = runner.shrink(sched, check=lambda s: "task_failure_rate" in s.faults)
    assert minimal.events == []
    assert set(minimal.faults) == {"seed", "task_failure_rate"}


@pytest.mark.parametrize("failing", [False, True])
def test_repros_cross_between_the_packages(tmp_path, failing):
    """A repro written by the JAX package replays in the port with the same
    outcome, and one written by the port replays in the JAX package."""
    faults = {"seed": 4, "task_failure_rate": 1.0} if failing else {"seed": 3, "storage_read_failure_rate": 0.05}
    sched = FaultSchedule(seed=faults["seed"], workload="blockwise_chain", faults=faults)
    runner = CampaignRunner(str(tmp_path / "port"))
    ref = ref_campaign.CampaignRunner(str(tmp_path / "ref"))
    ref_sched = ref_campaign.FaultSchedule.from_dict(sched.to_dict())
    theirs = ref.write_repro(ref_sched, ref.run(ref_sched), str(tmp_path / "from-ref.json"))
    mine = runner.write_repro(sched, runner.run(sched), str(tmp_path / "from-port.json"))
    doc_mine, doc_theirs = json.load(open(mine)), json.load(open(theirs))
    assert {k: v for k, v in doc_mine.items() if k != "failure"} == {
        k: v for k, v in doc_theirs.items() if k != "failure"}
    assert doc_mine["failure"]["stage"] == doc_theirs["failure"]["stage"]
    port_replay, ref_replay = runner.replay(theirs), ref.replay(mine)
    assert port_replay.ok == ref_replay.ok == (not failing), (port_replay.render(), ref_replay.render())
    assert port_replay.signature == ref_replay.signature


# -- CLI ------------------------------------------------------------------


def test_cli_repro_replay_exit_codes(tmp_path, capsys):
    passing = FaultSchedule(seed=3, workload="blockwise_chain",
                            faults={"seed": 3, "storage_read_failure_rate": 0.05})
    p = str(tmp_path / "repro-pass.json")
    passing.save(p)
    assert chaos_main(["--repro", p, "--base-dir", str(tmp_path / "scratch")]) == 0
    assert "PASS" in capsys.readouterr().out

    failing = FaultSchedule(seed=4, workload="blockwise_chain", faults={"seed": 4, "task_failure_rate": 1.0})
    f = str(tmp_path / "repro-fail.json")
    failing.save(f)
    assert chaos_main(["--repro", f, "--base-dir", str(tmp_path / "scratch")]) == 1


def test_cli_requires_exactly_one_mode():
    with pytest.raises(SystemExit):
        chaos_main([])
    with pytest.raises(SystemExit):
        chaos_main(["--seed", "1", "--repro", "x.json"])


# -- soak (slow) ----------------------------------------------------------


@pytest.mark.slow
def test_campaign_soak_generated_seeds_all_clean(tmp_path):
    runner = CampaignRunner(str(tmp_path))
    summary = runner.run_campaign(range(4), log=print)
    assert summary["failures"] == [], summary


@pytest.mark.slow
def test_subprocess_mode_coordinator_kill_recovers(tmp_path):
    """A schedule carrying a coordinator-crash knob runs in a child
    interpreter; the child dies by injection and the clean replay from the
    same seed must succeed."""
    runner = CampaignRunner(str(tmp_path))
    sched = FaultSchedule(
        seed=88, workload="blockwise_chain",
        faults={"seed": 88, "storage_read_failure_rate": 0.05, "coordinator_crash_after_dispatches": 3},
    )
    assert sched.needs_subprocess
    res = runner.run(sched)
    assert res.ok, res.render()
    assert res.stats.get("child_rc") != 0 or res.stats.get("child_killed")
