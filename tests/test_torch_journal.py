"""The port's compute journal held against the JAX package's (counterpart of
tests/runtime/test_journal.py, less its hard-killed fleet coordinator): the
writer and loader, a compute's lifecycle journaled through
``Spec(journal=...)`` (records equal the reference's on the same plan), the
journal ∩ integrity resume frontier on the threaded executor, and the device
executor's op-granular resume from a journal, whose path counters equal
``JaxExecutor``'s."""

from __future__ import annotations

import contextlib
import itertools
import json

import numpy as np
import pytest

import cubed_tpu as ct_ref
import cubed_tpu.array_api as ref_xp
import cubed_tpu_torch as ct
import cubed_tpu_torch.array_api as xp
from cubed_tpu.runtime.executors import jax as jax_executor_module
from cubed_tpu.runtime.executors.jax import JaxExecutor
from cubed_tpu.runtime.executors.python_async import AsyncPythonDagExecutor as RefAsyncPythonDagExecutor
from cubed_tpu.runtime.journal import load_journal as ref_load_journal
from cubed_tpu_torch.backend_array_api import set_device
from cubed_tpu_torch.observability import collect
from cubed_tpu_torch.observability.metrics import get_registry
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor
from cubed_tpu_torch.runtime.journal import ComputeJournal, load_journal
from cubed_tpu_torch.runtime.types import Callback


@pytest.fixture(autouse=True)
def _cpu_device():
    set_device("cpu")
    yield


class TaskCounter(Callback):
    def __init__(self):
        self.value = 0

    def on_task_end(self, event):
        self.value += event.num_tasks


# -- writer and loader ----------------------------------------------------


def test_journal_roundtrip_and_torn_line_tolerance(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = ComputeJournal(path)
    j.append("compute_start", compute_id="c-1", tasks_total=3, ops={"op-a": 3})
    j.append("dispatch", fsync=False, op="op-a", key="k0", attempt=0)
    j.append("complete", op="op-a", key="k0")
    j.append("complete", op="op-a", key="k1")
    j.append("decision", fsync=False, kind_detail="retry")
    j.close()
    with open(path, "ab") as f:
        f.write(b'{"kind": "complete", "op": "op-a", "key": "k2"')  # a torn last line
    loaded = load_journal(path)
    assert loaded["meta"]["compute_id"] == "c-1" and loaded["meta"]["tasks_total"] == 3
    assert loaded["completed"] == {("op-a", "k0"), ("op-a", "k1")}
    assert (loaded["dispatches"], len(loaded["decisions"]), loaded["bad_lines"]) == (1, 1, 1)
    assert loaded["complete"] is False
    # the reference's loader folds the port's file alike
    ref = ref_load_journal(path)
    assert {k: ref[k] for k in ("completed", "dispatches", "bad_lines", "complete")} == \
        {k: loaded[k] for k in ("completed", "dispatches", "bad_lines", "complete")}


def test_journal_seal_and_multi_run_fold(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = ComputeJournal(path)
    j.append("compute_start", compute_id="c-1", tasks_total=2)
    j.append("complete", op="op-a", key="k0")
    j.close()
    j2 = ComputeJournal(path)
    j2.append("compute_start", compute_id="c-2", tasks_total=2)
    j2.append("complete", op="op-a", key="k1")
    j2.append("compute_end", status="completed", error=None)
    j2.close()
    loaded = load_journal(path)
    assert loaded["meta"]["compute_id"] == "c-2"
    assert loaded["completed"] == {("op-a", "k0"), ("op-a", "k1")}
    assert loaded["complete"] is True


def test_append_after_close_is_noop(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = ComputeJournal(path)
    j.append("compute_start", compute_id="c-1")
    j.close()
    assert j.append("decision", kind_detail="late") is False
    assert len(load_journal(path)["decisions"]) == 0


def test_a_failing_decision_sink_never_fails_the_decision():
    seen = []

    def broken(entry):
        raise RuntimeError("sink down")

    collect.add_decision_sink(broken)
    collect.add_decision_sink(seen.append)
    try:
        collect.record_decision("probe", n=1)
    finally:
        collect.remove_decision_sink(broken)
        collect.remove_decision_sink(seen.append)
    collect.remove_decision_sink(broken)  # removing twice is harmless
    assert [e["kind"] for e in seen] == ["probe"]


# -- lifecycle journaling via Spec(journal=...) ----------------------------


def _records(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_compute_journals_lifecycle_and_decisions(tmp_path, monkeypatch):
    """The port's journal of a threaded compute holds what the reference's
    holds on the same plan: the plan's shape, every task complete, the
    seal, and the decision ring mirrored (the scheduler's mode at least)."""
    import cubed_tpu.core.plan as ref_plan
    import cubed_tpu_torch.core.plan as plan

    monkeypatch.setattr(plan, "CONTEXT_ID", "ctx-journal")
    monkeypatch.setattr(ref_plan, "CONTEXT_ID", "ctx-journal")
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    loaded = {}
    for name, pkg, ex in (("port", ct, AsyncPythonDagExecutor()), ("ref", ct_ref, RefAsyncPythonDagExecutor())):
        path = str(tmp_path / f"{name}.journal.jsonl")
        spec = pkg.Spec(work_dir=str(tmp_path / name), allowed_mem="500MB", journal=path)
        r = pkg.map_blocks(lambda x: x + 1.0, pkg.from_array(an, chunks=(4, 4), spec=spec), dtype=np.float64)
        total = r.plan.num_tasks()
        np.testing.assert_array_equal(r.compute(executor=ex), an + 1.0)
        loaded[name] = (load_journal if name == "port" else ref_load_journal)(path)
        assert loaded[name]["meta"]["tasks_total"] == total == sum(loaded[name]["meta"]["ops"].values())
        assert len(loaded[name]["completed"]) == total and loaded[name]["dispatches"] >= total
        assert loaded[name]["complete"] is True
        assert any(d.get("decision") == "scheduler_mode" for d in loaded[name]["decisions"])
    assert sorted(loaded["port"]["meta"]["ops"].values()) == sorted(loaded["ref"]["meta"]["ops"].values())
    kinds = [{r["kind"] for r in _records(tmp_path / f"{n}.journal.jsonl")} for n in ("port", "ref")]
    assert kinds[0] == kinds[1]
    assert get_registry().counter("journal_appends").value > 0


def _drop_completes(path, n, prefix="op-") -> int:
    """Drop the first *n* complete records of ops named *prefix*..., as if
    the client had died before writing them (every chunk still verifies)."""
    with open(path) as f:
        lines = f.readlines()
    kept, dropped = [], 0
    for line in lines:
        doc = json.loads(line)
        if doc.get("kind") == "complete" and str(doc.get("op", "")).startswith(prefix) and dropped < n:
            dropped += 1
            continue
        kept.append(line)
    with open(path, "w") as f:
        f.writelines(kept)
    return dropped


def test_resume_from_journal_narrows_the_skip_frontier(tmp_path):
    """journal ∩ integrity: chunks that verify but whose tasks the journal
    never recorded re-run on resume; journaled ones are skipped."""
    path = str(tmp_path / "compute.journal.jsonl")
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB", journal=path)
    an = np.arange(144, dtype=np.float64).reshape(12, 12)
    r = ct.map_blocks(lambda x: x * 2.0, ct.from_array(an, chunks=(3, 3), spec=spec), dtype=np.float64)  # 16 tasks
    np.testing.assert_array_equal(r.compute(executor=AsyncPythonDagExecutor()), an * 2.0)
    assert _drop_completes(path, 8) == 8
    before = get_registry().snapshot()
    counter = TaskCounter()
    np.testing.assert_array_equal(r.compute(executor=AsyncPythonDagExecutor(), callbacks=[counter],
                                            resume_from_journal=path), an * 2.0)
    # the 8 unjournaled tasks and create-arrays (which always runs)
    assert counter.value == 9
    assert get_registry().snapshot_delta(before).get("tasks_skipped_resume", 0) >= 8
    counter2 = TaskCounter()
    np.testing.assert_array_equal(r.compute(executor=AsyncPythonDagExecutor(), callbacks=[counter2],
                                            resume_from_journal=path), an * 2.0)
    assert counter2.value == 1


@contextlib.contextmanager
def _pinned_names(base: int):
    """Both packages' plan-name counters pinned to *base*: one plan built in
    each has the same names, so the same stores."""
    import cubed_tpu.utils as ref_utils
    import cubed_tpu_torch.utils as utils

    saved = (utils.sym_counter, ref_utils.sym_counter)
    utils.sym_counter = itertools.count(base)
    ref_utils.sym_counter = itertools.count(base)
    try:
        yield
    finally:
        used = max(next(utils.sym_counter), next(ref_utils.sym_counter)) - base
        utils.sym_counter = itertools.count(next(saved[0]) + used)
        ref_utils.sym_counter = itertools.count(next(saved[1]) + used)


def test_device_executor_resume_from_journal_is_op_granular(tmp_path, monkeypatch):
    """A threaded compute's journal with half of the last op's completions
    dropped: the device executor's resume skips the first op (journaled
    whole, verified) and re-runs the last one whole, with the path counters
    of ``JaxExecutor``'s resume from the same journal over the same stores."""
    import cubed_tpu.core.plan as ref_plan
    import cubed_tpu_torch.core.plan as plan

    monkeypatch.setattr(plan, "CONTEXT_ID", "ctx-journal-device")
    monkeypatch.setattr(ref_plan, "CONTEXT_ID", "ctx-journal-device")
    an = np.arange(256, dtype=np.float64).reshape(16, 16)
    path = str(tmp_path / "compute.journal.jsonl")
    plans = {}
    for name, pkg, mod in (("port", ct, xp), ("ref", ct_ref, ref_xp)):
        with _pinned_names(660_000_000):
            spec = pkg.Spec(work_dir=str(tmp_path / "w"), allowed_mem="500MB")
            plans[name] = mod.multiply(mod.add(pkg.from_array(an, chunks=(4, 4), spec=spec), 1.0), 3.0)
    c = plans["port"]
    journaled = ct.Spec(work_dir=str(tmp_path / "w"), allowed_mem="500MB", journal=path)
    with _pinned_names(660_000_000):
        c_journaled = xp.multiply(xp.add(ct.from_array(an, chunks=(4, 4), spec=journaled), 1.0), 3.0)
    np.testing.assert_array_equal(c_journaled.compute(executor=AsyncPythonDagExecutor(), optimize_graph=False),
                                  (an + 1.0) * 3.0)
    last_op = max(op for op, _ in load_journal(path)["completed"] if op != "create-arrays")
    assert _drop_completes(path, 8, prefix=last_op) == 8
    counts = {}
    for name, ex in (("port", CudaExecutor()), ("ref", JaxExecutor())):
        jax_executor_module._STRUCT_CACHE.clear()
        ops = TaskCounter()
        before = get_registry().snapshot()
        out = plans[name].compute(executor=ex, optimize_graph=False, resume_from_journal=path, callbacks=[ops])
        np.testing.assert_array_equal(out, (an + 1.0) * 3.0)
        if name == "port":
            # create-arrays' two targets and the last op's 16 tasks ran; the
            # first op's 16 were skipped
            assert ops.value == 2 + 16
            assert get_registry().snapshot_delta(before).get("tasks_skipped_resume", 0) == 0
        counts[name] = {k: ex.stats.get(k, 0) for k in ("batched_ops", "chunked_ops", "eager_ops", "whole_array_hits",
                                                         "eager_fallbacks", "batched_errors")}
    assert counts["port"] == counts["ref"]
