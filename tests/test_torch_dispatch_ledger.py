"""The dispatch ledger on the port's executors held against the JAX
package: the per-task control-plane stamps of the threaded loop (the same
fields as the reference's), and on the fleet the coordinator's serialize,
send, lock-wait and unpickle costs in clock order, within the submit they
happened in, with ``analyze()`` splitting the pre-start gap by them.
Counterpart of the stamp cases of tests/runtime/test_dispatch_ledger.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
from cubed_tpu.observability import TraceCollector as RefTraceCollector  # noqa: E402
from cubed_tpu.runtime.executors.python_async import AsyncPythonDagExecutor as RefAsync  # noqa: E402
from cubed_tpu_torch.observability import TraceCollector, analyze  # noqa: E402
from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor  # noqa: E402

from . import _torch_fleet  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clean_process():
    before = _torch_fleet.snapshot()
    _torch_fleet.reset_process_state()
    yield
    _torch_fleet.reset_process_state()
    assert _torch_fleet.leftovers(before) == {"children": [], "listening": []}


def _ledgers(col) -> list:
    return [r["dispatch"] for r in col._records if r.get("dispatch")]


def test_local_ledger_stamps_every_task_monotonically(tmp_path):
    an = np.arange(36.0).reshape(6, 6)
    fields = []
    for pkg, col, ex in ((ct, TraceCollector(trace_dir=None), AsyncPythonDagExecutor()),
                         (cubed_tpu, RefTraceCollector(trace_dir=None), RefAsync())):
        spec = pkg.Spec(work_dir=str(tmp_path / pkg.__name__), allowed_mem="500MB")
        r = pkg.map_blocks(lambda x: x + 1.0, pkg.from_array(an, chunks=(2, 2), spec=spec), dtype=np.float64)
        np.testing.assert_array_equal(np.asarray(r.compute(executor=ex, callbacks=[col])), an + 1.0)
        ledgers = _ledgers(col)
        assert len(ledgers) == len(col._records)
        for d in ledgers:
            assert d["ready_tstamp"] <= d["submitted_tstamp"] and d["submit_cost_s"] >= 0.0
        fields.append({frozenset(d) for d in ledgers})
    assert fields[0] == fields[1]


def test_distributed_ledger_carries_coordinator_costs(tmp_path):
    an = np.arange(36.0).reshape(6, 6)
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")
    r = ct.map_blocks(lambda x: x * 2.0, ct.from_array(an, chunks=(3, 3), spec=spec), dtype=np.float64)
    r2 = ct.map_blocks(lambda x: x + 1.0, ct.from_array(an, chunks=(2, 2), spec=spec), dtype=np.float64)
    col = TraceCollector(trace_dir=None)
    col2 = TraceCollector(trace_dir=None)
    with DistributedDagExecutor(n_local_workers=2, worker_threads=2) as ex:
        np.testing.assert_array_equal(np.asarray(r.compute(executor=ex, callbacks=[col])), an * 2.0)
        np.testing.assert_array_equal(np.asarray(r2.compute(executor=ex, callbacks=[col2], optimize_graph=False)),
                                      an + 1.0)
    ledgers = [d for d in _ledgers(col) if d.get("sent_tstamp") is not None]
    assert ledgers, "no task shipped a coordinator-side ledger"
    for d in ledgers:
        assert d["ready_tstamp"] <= d["submitted_tstamp"] <= d["sent_tstamp"] + 1e-6
        assert d["sent_tstamp"] <= d["result_recv_tstamp"]
        for k in ("serialize_s", "send_s", "lock_wait_s", "unpickle_s"):
            assert d[k] >= 0.0
        assert d["serialize_s"] + d["send_s"] <= d["submit_cost_s"] + 5e-3
    # every fleet task carries a ledger: analyze() leaves nothing in the
    # legacy queue-wait bucket and its buckets add up to the wall clock
    attr = analyze(col2).to_dict()
    assert attr["attribution"]["queue_wait"] == 0.0
    assert abs(sum(attr["attribution"].values()) - attr["wall_clock_s"]) <= 0.10 * attr["wall_clock_s"]
