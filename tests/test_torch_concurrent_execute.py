"""Concurrent ``Plan.execute`` from many threads in one process is safe:
the gensym counter mints no duplicate plan name, intermediate paths never
collide, the compute-id env export cannot clobber a live sibling's value,
and concurrent computes are bit for bit, on the threaded executor and on
the device executor (one instance shared by many threads included, as the
compute service shares it), held against the same computes alone and
against the JAX package's. Counterpart of
tests/service/test_concurrent_execute.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import threading

import numpy as np
import pytest

import cubed_tpu_torch as ct
from cubed_tpu_torch.observability import logs
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor
from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor
from cubed_tpu_torch.storage.zarr import LazyZarrArray
from cubed_tpu_torch.utils import gensym
from ._torch_chaos import clean_process  # noqa: E402,F401


@pytest.fixture()
def spec(tmp_path):
    return ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")


def test_gensym_unique_under_thread_contention():
    names: list = []
    lock = threading.Lock()

    def mint(n=300):
        mine = [gensym("op-race") for _ in range(n)]
        with lock:
            names.extend(mine)

    threads = [threading.Thread(target=mint) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(names) == len(set(names)) == 8 * 300


def test_compute_scope_env_export_is_concurrency_safe():
    """A finishing scope must not clobber a live sibling's env export."""
    var = logs.COMPUTE_ID_ENV_VAR
    os.environ.pop(var, None)
    release_a = threading.Event()
    a_exported = threading.Event()
    b_done = threading.Event()
    observed = {}

    def compute_a():
        with logs.compute_scope("c-AAA", export_env=True):
            a_exported.set()
            release_a.wait(timeout=10)
        observed["after_a_exit"] = os.environ.get(var)

    def compute_b():
        a_exported.wait(timeout=10)
        with logs.compute_scope("c-BBB", export_env=True):
            pass  # B enters and exits while A is still live
        b_done.set()

    ta = threading.Thread(target=compute_a)
    tb = threading.Thread(target=compute_b)
    ta.start()
    tb.start()
    assert b_done.wait(timeout=10)
    # B exited while A's scope is live: B saw A's id as "previous" and
    # restored it — A's export must still stand
    assert os.environ.get(var) == "c-AAA"
    release_a.set()
    ta.join(timeout=10)
    tb.join(timeout=10)
    # both scopes exited: the export is fully cleaned up
    assert os.environ.get(var) is None
    assert observed["after_a_exit"] is None


def test_compute_scope_env_export_drops_dead_previous():
    """Out-of-order exits: when B exits after A already finished, B must
    DROP A's id (a dead compute), not resurrect it into the env. Each
    scope runs on its own thread, like concurrent service computes."""
    var = logs.COMPUTE_ID_ENV_VAR
    os.environ.pop(var, None)
    a_in, a_exit, a_done = (threading.Event() for _ in range(3))
    b_in, b_exit, b_done = (threading.Event() for _ in range(3))

    def compute_a():
        with logs.compute_scope("c-dead", export_env=True):
            a_in.set()
            a_exit.wait(timeout=10)
        a_done.set()

    def compute_b():
        a_in.wait(timeout=10)
        with logs.compute_scope("c-later", export_env=True):
            b_in.set()
            b_exit.wait(timeout=10)
        b_done.set()

    ta = threading.Thread(target=compute_a)
    tb = threading.Thread(target=compute_b)
    ta.start()
    tb.start()
    assert b_in.wait(timeout=10)
    a_exit.set()                     # A dies first, while B is live
    assert a_done.wait(timeout=10)
    assert os.environ.get(var) == "c-later"
    b_exit.set()
    assert b_done.wait(timeout=10)
    # B must not restore the finished A's id
    assert os.environ.get(var) is None
    ta.join(timeout=10)
    tb.join(timeout=10)

    # ...but an EXTERNAL pin (operator-set, never scope-exported) is
    # always restored
    os.environ[var] = "operator-pin"
    with logs.compute_scope("c-x", export_env=True):
        assert os.environ.get(var) == "c-x"
    assert os.environ.get(var) == "operator-pin"
    os.environ.pop(var, None)


#: the executors the compute tests run on: the threaded executor, and the
#: device executor (its plain versions on the CPU), one instance per compute
EXECUTORS = {"threads": AsyncPythonDagExecutor, "cuda": CudaExecutor}


def _intermediate_stores(finalized) -> set:
    return {
        str(d["target"].store)
        for _, d in finalized.dag.nodes.items()
        if d.get("type") == "array" and isinstance(d.get("target"), LazyZarrArray)
    }


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_two_concurrent_computes_bitwise_correct_disjoint_paths(spec, executor):
    """The acceptance regression: two computes built and executed
    concurrently in one process produce bitwise-correct results and write
    their intermediates to non-colliding store paths."""
    an = np.arange(144, dtype=np.float64).reshape(12, 12)

    def build(k):
        a = ct.from_array(an, chunks=(3, 3), spec=spec)
        b = ct.map_blocks(lambda x, _k=k: x * _k, a, dtype=np.float64)
        return ct.map_blocks(lambda x, _k=k: x + _k, b, dtype=np.float64)

    r1, r2 = build(2.0), build(5.0)
    # the plans' materialized targets never collide, even within one
    # shared CUBED_TPU_TORCH_CONTEXT_ID (names come from the locked counter)
    f1 = r1.plan._finalize(array_names=(r1.name,))
    f2 = r2.plan._finalize(array_names=(r2.name,))
    assert _intermediate_stores(f1).isdisjoint(_intermediate_stores(f2))

    results: dict = {}
    errors: list = []

    def run(key, arr, finalized):
        try:
            arr.plan.execute(
                executor=EXECUTORS[executor](),
                array_names=(arr.name,),
                spec=spec,
                finalized=finalized,
            )
            results[key] = arr._read_stored()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append((key, e))

    t1 = threading.Thread(target=run, args=("a", r1, f1))
    t2 = threading.Thread(target=run, args=("b", r2, f2))
    t1.start()
    t2.start()
    t1.join(timeout=120)
    t2.join(timeout=120)
    assert not errors, errors
    np.testing.assert_array_equal(results["a"], an * 2.0 + 2.0)
    np.testing.assert_array_equal(results["b"], an * 5.0 + 5.0)


@pytest.mark.parametrize("executor", sorted(EXECUTORS))
def test_concurrent_computes_through_top_level_compute(spec, executor):
    """Same regression through the public ``.compute()`` path (each
    thread owns its finalize + execute end-to-end)."""
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    results: dict = {}
    errors: list = []

    def run(k):
        try:
            a = ct.from_array(an, chunks=(4, 4), spec=spec)
            r = ct.map_blocks(lambda x, _k=k: x - _k, a, dtype=np.float64)
            results[k] = r.compute(executor=EXECUTORS[executor]())
        except BaseException as e:  # noqa: BLE001
            errors.append((k, e))

    threads = [
        threading.Thread(target=run, args=(float(k),)) for k in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for k in range(4):
        np.testing.assert_array_equal(results[float(k)], an - float(k))


@pytest.fixture(scope="module", autouse=True)
def _clean_process(clean_process):
    yield


def test_concurrent_computes_on_one_device_executor_match_alone_and_the_jax_package(tmp_path):
    """Two tenants' computes at once on ONE device executor (the compute
    service's shape) equal the same computes run alone bit for bit, and
    the JAX package's at rtol 1e-12: the executor serializes capture and
    replay per device, so neither compute launches into the other's."""
    import random as pyrandom

    import cubed_tpu
    import cubed_tpu.array_api as rxp

    import cubed_tpu_torch.array_api as xp

    def build(pkg, ns, spec, seed):
        pyrandom.seed(seed)
        a, b, x, y = [pkg.random.random((20, 18, 16), chunks=6, spec=spec) for _ in range(4)]
        return ns.mean(a[1:] * x[1:] + b[1:] * y[1:], axis=0)

    pspec = ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB")
    alone = {s: build(ct, xp, pspec, s).compute(executor=CudaExecutor()) for s in (3, 4)}
    shared = CudaExecutor()
    arrays = {s: build(ct, xp, pspec, s) for s in (3, 4)}
    results, errors = {}, []

    def run(s):
        try:
            results[s] = arrays[s].compute(executor=shared)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append((s, e))

    threads = [threading.Thread(target=run, args=(s,)) for s in (3, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    rspec = cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB")
    for s in (3, 4):
        np.testing.assert_array_equal(results[s], alone[s])
        np.testing.assert_allclose(results[s], build(cubed_tpu, rxp, rspec, s).compute(), rtol=1e-12)


def test_device_executor_lock_under_thread_contention(tmp_path):
    """More threads than cores computing on one device executor at once,
    with the interpreter switching threads every 10 us: every value equals
    its compute run alone, and the executor's per-compute state is whole
    after each (its counters are one compute's)."""
    import random as pyrandom
    import sys

    import cubed_tpu_torch.array_api as xp

    n = (os.cpu_count() or 4) + 2
    spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="500MB")

    def build(seed):
        pyrandom.seed(seed)
        a, b = [ct.random.random((12, 10), chunks=5, spec=spec) for _ in range(2)]
        return xp.sum(a * b + a, axis=0)

    alone = {s: build(s).compute(executor=CudaExecutor()) for s in range(n)}
    arrays = {s: build(s) for s in range(n)}
    shared = CudaExecutor()
    results, errors = {}, []

    def run(s):
        try:
            results[s] = arrays[s].compute(executor=shared)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append((s, e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(s,)) for s in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for s in range(n):
        np.testing.assert_array_equal(results[s], alone[s])
    one = CudaExecutor()
    build(0).compute(executor=one)
    paths = ("batched_ops", "chunked_ops", "eager_ops")
    assert {k: shared.stats[k] for k in paths} == {k: one.stats[k] for k in paths}

