"""The port's process-pool executor held against the JAX package: plans
whose ``(function, input, config)`` payloads cross a ``spawn`` boundary on
the stdlib's ``pickle`` (a lambda, a closure and a partial in
``map_blocks``), values against the JAX package's sequential executor,
retries in fresh processes with exact counts, and a dead worker surviving
both op by op and under the dataflow scheduler (where an OOM-shaped exit
halves the pool). Counterpart of tests/runtime/test_multiprocess.py."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import concurrent.futures  # noqa: E402
import functools  # noqa: E402
import multiprocessing  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as xp  # noqa: E402
from cubed_tpu_torch.observability.metrics import get_registry  # noqa: E402
from cubed_tpu_torch.runtime.create import create_executor  # noqa: E402
from cubed_tpu_torch.runtime.executors.multiprocess import MultiprocessDagExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.python_async import map_unordered  # noqa: E402

from . import _torch_fleet  # noqa: E402
from .runtime.utils import check_invocation_counts  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clean_process():
    before = _torch_fleet.snapshot()
    _torch_fleet.reset_process_state()
    yield
    _torch_fleet.reset_process_state()
    assert _torch_fleet.leftovers(before) == {"children": [], "listening": []}


@pytest.fixture(scope="module")
def pool():
    """One spawned pool for the map-level retry cases."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=2, mp_context=ctx) as p:
        yield p


class _Count(ct.Callback):
    def __init__(self):
        self.value = 0

    def on_task_end(self, event):
        self.value += 1


def _specs(tmp_path):
    return (cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB"),
            ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB"))


def test_multiprocess_end_to_end(tmp_path):
    an = np.arange(100, dtype=np.float64).reshape(10, 10)
    rs, ps = _specs(tmp_path)
    ref = float(rxp.sum(rxp.add(cubed_tpu.from_array(an, chunks=(4, 4), spec=rs),
                                cubed_tpu.from_array(an, chunks=(4, 4), spec=rs))).compute())
    a = ct.from_array(an, chunks=(4, 4), spec=ps)
    counter = _Count()
    ex = MultiprocessDagExecutor(max_workers=2)
    result = float(xp.sum(xp.add(a, a)).compute(executor=ex, callbacks=[counter]))
    assert result == ref == (an + an).sum()
    assert counter.value > 0
    # every task ran in a worker on the CPU, which reported it
    workers = ex.stats["workers"]
    assert sum(w["tasks"] for w in workers.values()) == counter.value
    assert {w["device"] for w in workers.values()} == {"cpu"}
    assert os.getpid() not in {int(k) for k in workers}


def test_multiprocess_fused_kernels_lambda_closure_partial(tmp_path):
    """Fused closures and user lambdas, closures and partials are the
    payloads ``cloudpickle`` exists for; here the stdlib carries them."""
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    k = 0.5
    rs, ps = _specs(tmp_path)
    vals = []
    for pkg, nxp, spec, ex in ((cubed_tpu, rxp, rs, None),
                               (ct, xp, ps, create_executor("processes", {"max_workers": 2}))):
        a = pkg.from_array(an, chunks=(4, 4), spec=spec)
        b = pkg.map_blocks(lambda x: x * 2.0 + k, a, dtype=np.float64)
        c = pkg.map_blocks(functools.partial(np.add, 1.0), b, dtype=np.float64)
        r = nxp.mean(nxp.add(nxp.multiply(c, 2.0), a))
        vals.append(float(r.compute(executor=ex)) if ex is not None else float(r.compute()))
    assert vals[1] == pytest.approx(vals[0], rel=1e-12)
    assert vals[1] == pytest.approx(((an * 2.0 + k + 1.0) * 2.0 + an).mean(), rel=1e-12)


def test_multiprocess_vorticity_matches_the_reference_and_sequential(tmp_path):
    """The main path's plan, cut, under the dataflow scheduler: equal to
    the JAX package's sequential executor at rtol 1e-12 and to the port's
    sequential one bit for bit, with the same task count."""
    rs, ps = _specs(tmp_path)
    out = []
    for pkg, nxp, spec in ((cubed_tpu, rxp, rs), (ct, xp, ps)):
        rng = np.random.default_rng(3)
        a, b, x, y = [pkg.from_array(rng.random((12, 10, 8)), chunks=(4, 5, 4), spec=spec) for _ in range(4)]
        out.append(nxp.mean(a[1:] * x[1:] + b[1:] * y[1:]))
    ref, v = out
    assert v.plan._finalize().num_tasks() == ref.plan._finalize().num_tasks()
    counter = _Count()
    got = float(v.compute(executor=MultiprocessDagExecutor(max_workers=2), callbacks=[counter]))
    assert got == pytest.approx(float(ref.compute()), rel=1e-12)
    assert got == float(v.compute())
    assert counter.value == v.plan._finalize().num_tasks()


def test_multiprocess_retries_success(tmp_path, pool):
    path = tmp_path / "counts"
    path.mkdir()
    timing_map = {0: [-1]}  # input 0 fails once, then succeeds in another call
    map_unordered(pool, _torch_fleet.FaultTask(str(path), timing_map), list(range(2)), retries=2)
    check_invocation_counts(str(path), timing_map, n_tasks=2, retries=2)


def test_multiprocess_retries_exhausted(tmp_path, pool):
    path = tmp_path / "counts"
    path.mkdir()
    timing_map = {0: [-1, -1, -1]}  # more failures than attempts
    with pytest.raises(RuntimeError):
        map_unordered(pool, _torch_fleet.FaultTask(str(path), timing_map), list(range(2)), retries=2)


def test_multiprocess_survives_worker_death(tmp_path):
    ex = MultiprocessDagExecutor(max_workers=1, retries=2)
    marker = str(tmp_path / "died")
    ctx = multiprocessing.get_context("spawn")
    p = ex._new_pool(ctx, 1, "cpu")
    before = get_registry().snapshot()
    try:
        p = ex._map_surviving_pool_crash(p, ctx, _torch_fleet.DieOnce(marker), [0, 1], retries=2, device="cpu")
    finally:
        p.shutdown(wait=True, cancel_futures=True)
    assert os.path.exists(marker)  # the crash happened and was survived
    delta = get_registry().snapshot_delta(before)
    assert delta.get("pool_rebuilds", 0) == 1 and delta.get("worker_oom_kills", 0) == 0


def test_multiprocess_oom_shaped_death_halves_the_pool_and_resumes_the_graph(tmp_path):
    """Under the dataflow scheduler a dead worker's exit code 137 reads as
    an OOM kill: the pool comes back with half the workers, the re-run
    skips the graph's completed tasks, and the value is bit for bit."""
    ps = ct.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB")
    an = np.arange(64, dtype=np.float64).reshape(8, 8)
    a = ct.from_array(an, chunks=(2, 2), spec=ps)
    marker = str(tmp_path / "died")

    def die_once(x):
        if x[0, 0] == 36.0 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(137)
        return x + 1.0

    r = xp.sum(ct.map_blocks(die_once, a, dtype=np.float64))
    before = get_registry().snapshot()
    counter = _Count()
    got = float(r.compute(executor=MultiprocessDagExecutor(max_workers=2), callbacks=[counter]))
    assert os.path.exists(marker)
    assert got == float(xp.sum(ct.map_blocks(lambda x: x + 1.0, a, dtype=np.float64)).compute())
    delta = get_registry().snapshot_delta(before)
    assert delta.get("pool_rebuilds", 0) == 1 and delta.get("worker_oom_kills", 0) == 1
    # completed tasks were not re-run: each task ended once, the crashed one
    # after the rebuild
    assert counter.value == r.plan._finalize().num_tasks()
