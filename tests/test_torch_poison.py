"""The poison-task quarantine at unit level, held against the JAX package:
the ``task_fatal`` fault knobs (the same chunks die in both packages), the
worker-fatal strike count in ``map_unordered`` (the same verdict, attempts
and counters), and the ``PoisonTaskError`` verdict's pickling and
fail-fast classification. Counterpart of tests/runtime/test_poison.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import concurrent.futures  # noqa: E402
import pickle  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402

from cubed_tpu.observability.metrics import get_registry as ref_registry  # noqa: E402
from cubed_tpu.runtime import faults as ref_faults  # noqa: E402
from cubed_tpu.runtime import distributed as ref_distributed  # noqa: E402
from cubed_tpu.runtime.executors.python_async import map_unordered as ref_map_unordered  # noqa: E402
from cubed_tpu.runtime.resilience import PoisonTaskError as RefPoisonTaskError  # noqa: E402
from cubed_tpu.runtime.resilience import RetryPolicy as RefRetryPolicy  # noqa: E402
from cubed_tpu_torch.observability.collect import decisions_since  # noqa: E402
from cubed_tpu_torch.observability.metrics import get_registry  # noqa: E402
from cubed_tpu_torch.runtime import distributed, faults  # noqa: E402
from cubed_tpu_torch.runtime.executors.python_async import map_unordered  # noqa: E402
from cubed_tpu_torch.runtime.resilience import Classification, PoisonTaskError, RetryPolicy  # noqa: E402

KEYS = [f"('a', {i})" for i in range(40)]


def test_task_fatal_is_deterministic_pinned_and_the_reference_s():
    inj = faults.FaultInjector(faults.FaultConfig(seed=7, task_fatal_rate=0.3))
    verdicts = {k: inj.task_fatal(k) for k in KEYS}
    assert any(verdicts.values()) and not all(verdicts.values())
    for _ in range(3):  # a poison chunk re-kills on every attempt
        for k, v in verdicts.items():
            assert inj.task_fatal(k) is v
    ref = ref_faults.FaultInjector(ref_faults.FaultConfig(seed=7, task_fatal_rate=0.3))
    assert {k: ref.task_fatal(k) for k in KEYS} == verdicts
    other = faults.FaultInjector(faults.FaultConfig(seed=8, task_fatal_rate=0.3))
    assert {k: other.task_fatal(k) for k in KEYS} != verdicts


def test_task_fatal_explicit_chunk_keys_and_counting():
    before = get_registry().snapshot()
    inj = faults.FaultInjector(faults.FaultConfig(seed=1, task_fatal_chunk_keys=("('x', 0, 0)",)))
    assert inj.task_fatal("('x', 0, 0)") is True
    assert inj.task_fatal("('x', 0, 1)") is False
    delta = get_registry().snapshot_delta(before)
    assert delta.get("faults_injected", 0) == 1
    assert delta.get("faults_injected_task_fatal", 0) == 1
    assert faults.FaultInjector(faults.FaultConfig(seed=1)).task_fatal("('x', 0, 0)") is False


def test_poison_task_error_pickles_and_classifies_fail_fast():
    err = PoisonTaskError("op-add-000000003", "('array-x', 1, 2)", 4)
    assert str(err) == str(RefPoisonTaskError("op-add-000000003", "('array-x', 1, 2)", 4))
    rt = pickle.loads(pickle.dumps(err))
    assert (rt.op, rt.chunk, rt.attempts) == (err.op, err.chunk, err.attempts)
    policy = RetryPolicy()
    assert policy.classify(err) is Classification.FAIL_FAST
    remote = distributed.RemoteTaskError("remote poison", "PoisonTaskError")
    assert policy.classify(remote) is Classification.FAIL_FAST
    assert policy.classify(distributed.WorkerLostError("gone")) is Classification.REQUEUE
    assert policy.classify(distributed.WorkerDrainedError("drained")) is Classification.REQUEUE


def _lost(module, kind):
    if kind == "drained":
        return module.WorkerDrainedError("worker w0 drained (preemption notice)")
    return module.WorkerLostError("worker w0 died abruptly (exitcode 137)")


def _run_poison(map_fn, registry, lost_module, policy_cls):
    calls = {"poison": 0}

    def work(i, config=None):
        if i == 3:
            calls["poison"] += 1
            raise _lost(lost_module, "abrupt")
        return i

    before = registry().snapshot()
    policy = policy_cls(retries=2, backoff_base=0.01, max_requeues=2)
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        with pytest.raises(Exception) as info:
            map_fn(pool, work, list(range(8)), retry_policy=policy)
    delta = registry().snapshot_delta(before)
    return info.value, calls["poison"], delta.get("poison_quarantined", 0), policy


def test_map_unordered_quarantines_abrupt_worker_fatal_strikes():
    t0 = time.time()
    err, calls, quarantined, policy = _run_poison(map_unordered, get_registry, distributed, RetryPolicy)
    ref_err, ref_calls, ref_quarantined, _ = _run_poison(ref_map_unordered, ref_registry, ref_distributed,
                                                          RefRetryPolicy)
    assert isinstance(err, PoisonTaskError) and isinstance(ref_err, RefPoisonTaskError)
    assert err.attempts == ref_err.attempts == policy.max_requeues + 1 == calls == ref_calls
    assert err.chunk == ref_err.chunk == "3"
    assert quarantined == ref_quarantined == 1
    quarantines = [d for d in decisions_since(t0) if d["kind"] == "poison_quarantine"]
    assert quarantines and quarantines[0]["chunk"] == "3" and quarantines[0]["attempts"] == err.attempts


def test_clean_worker_drains_never_count_as_poison_strikes():
    for map_fn, registry, module, policy_cls in ((map_unordered, get_registry, distributed, RetryPolicy),
                                                 (ref_map_unordered, ref_registry, ref_distributed, RefRetryPolicy)):
        failures = {"n": 0}

        def work(i, config=None):
            if i == 3 and failures["n"] < 3:
                failures["n"] += 1
                raise _lost(module, "drained")
            return i

        before = registry().snapshot()
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
            map_fn(pool, work, list(range(8)), retry_policy=policy_cls(retries=2, backoff_base=0.01, max_requeues=3))
        delta = registry().snapshot_delta(before)
        assert delta.get("poison_quarantined", 0) == 0
        assert delta.get("worker_loss_requeues", 0) == 3


def test_quarantine_cancels_pending_work_for_the_request():
    started = set()

    def work(i, config=None):
        started.add(i)
        if i == 0:
            raise distributed.WorkerLostError("worker w0 died abruptly")
        time.sleep(0.3)
        return i

    policy = RetryPolicy(retries=1, backoff_base=0.01, max_requeues=1)
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        with pytest.raises(PoisonTaskError):
            map_unordered(pool, work, list(range(16)), retry_policy=policy, batch_size=4)
    assert started <= set(range(8)) and len(started) < 16


def _pinned_names(base: int):
    """Both packages' plan-name counters pinned to *base* (the injector
    hashes the array names in the chunk keys)."""
    import contextlib
    import itertools

    import cubed_tpu.utils as ref_utils
    import cubed_tpu_torch.utils as utils

    @contextlib.contextmanager
    def pinned():
        saved = (utils.sym_counter, ref_utils.sym_counter)
        utils.sym_counter = itertools.count(base)
        ref_utils.sym_counter = itertools.count(base)
        try:
            yield
        finally:
            used = max(next(utils.sym_counter), next(ref_utils.sym_counter)) - base
            utils.sym_counter = itertools.count(next(saved[0]) + used)
            ref_utils.sym_counter = itertools.count(next(saved[1]) + used)

    return pinned()


def test_the_same_tasks_of_a_plan_are_poison_and_lose_their_workers_in_both_packages(tmp_path):
    """One plan built in each package with pinned names: the seeded poison
    chunks, and the worker crashes, hangs and preemptions by task count, are
    the same tasks in both."""
    import numpy as np

    import cubed_tpu
    import cubed_tpu.array_api as rxp
    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu.runtime.pipeline import visit_nodes as ref_visit_nodes
    from cubed_tpu.runtime.utils import chunk_key as ref_chunk_key
    from cubed_tpu_torch.runtime.pipeline import visit_nodes
    from cubed_tpu_torch.runtime.utils import chunk_key

    keys = []
    for pkg, nxp, walk, key in ((ct, xp, visit_nodes, chunk_key),
                                (cubed_tpu, rxp, ref_visit_nodes, ref_chunk_key)):
        with _pinned_names(918_000_000):
            spec = pkg.Spec(work_dir=str(tmp_path / pkg.__name__), allowed_mem="500MB")
            a = pkg.from_array(np.arange(144.0).reshape(12, 12), chunks=(3, 3), spec=spec)
            v = nxp.sum(nxp.multiply(a, 2.0) + a)
            dag = v.plan._finalize().dag
        # the chunk tasks (the create-arrays bootstrap's items name store paths)
        keys.append([key(m) for _name, node in walk(dag) for m in node["primitive_op"].pipeline.mappable
                     if isinstance(m, tuple)])
    assert keys[0] == keys[1] and len(keys[0]) > 16
    cfg = dict(seed=21, task_fatal_rate=0.2, worker_crash_names=["local-0"], worker_crash_after_tasks=4,
               worker_hang_names=["local-1"], worker_hang_after_tasks=6, worker_preempt_rate=0.5,
               worker_preempt_after_tasks=3)
    port = faults.FaultInjector(faults.FaultConfig.from_dict(cfg))
    ref = ref_faults.FaultInjector(ref_faults.FaultConfig.from_dict(cfg))
    fatal = [port.task_fatal(k) for k in keys[0]]
    assert fatal == [ref.task_fatal(k) for k in keys[1]] and any(fatal)
    workers = [f"local-{i % 3}" for i in range(len(keys[0]))]
    assert [port.worker_task_tick(w) for w in workers] == [ref.worker_task_tick(w) for w in workers]
