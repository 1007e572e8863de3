"""The port stands alone: importing it loads no JAX, networkx, cloudpickle,
fsspec, graphviz binding or module of the JAX package, neither does
chip_smoke.py, and with no
device asked for and no CUDA it refuses to compute instead of running on the
CPU. Each check runs in a fresh interpreter. One place in the sources may
import fsspec: the remote-IO class of ``storage/store.py``, which a store
that is not a local path opens (``FSSPEC_EXEMPTION``); a local compute
never loads it."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "networkx", "cloudpickle", "fsspec", "cubed_tpu", "graphviz", "pydot",
             "pygraphviz")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN and top != "cubed_tpu_torch"


def _run(code: str, env_update=None) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "CUBED_TPU_TORCH_DEVICE"}
    env["PYTHONPATH"] = REPO
    env.update(env_update or {})
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=120,
    )


def test_import_loads_no_jax_or_reference_modules():
    proc = _run(
        "import sys, cubed_tpu_torch, cubed_tpu_torch.array_api, cubed_tpu_torch.random\n"
        "import cubed_tpu_torch.kernels._build, cubed_tpu_torch.runtime.executors.python\n"
        "import cubed_tpu_torch.runtime.executors.cuda, cubed_tpu_torch.runtime.create\n"
        "import cubed_tpu_torch.observability, cubed_tpu_torch.extensions, cubed_tpu_torch.extensions.profiler\n"
        "import cubed_tpu_torch.array_api.sorting_functions, cubed_tpu_torch.array_api._block_sort\n"
        "import cubed_tpu_torch.array_api.linalg, cubed_tpu_torch.nan_functions, cubed_tpu_torch.kernels.merge_sort\n"
        "import cubed_tpu_torch.core.visualization, cubed_tpu_torch.array_api.html_repr\n"
        "import cubed_tpu_torch.runtime.executors.python_async, cubed_tpu_torch.runtime.dataflow\n"
        "import cubed_tpu_torch.runtime.journal, cubed_tpu_torch.runtime.backup\n"
        "import cubed_tpu_torch.observability.slo, cubed_tpu_torch.observability.alerts\n"
        "import cubed_tpu_torch.observability.dispatchprofile, cubed_tpu_torch.observability.flightrecorder\n"
        "import cubed_tpu_torch.observability.analytics, cubed_tpu_torch.observability.runhistory\n"
        "import cubed_tpu_torch.observability.timeseries, cubed_tpu_torch.observability.export\n"
        "import cubed_tpu_torch.service, cubed_tpu_torch.service.cache, cubed_tpu_torch.service.admission\n"
        "import cubed_tpu_torch.service.overload, cubed_tpu_torch.service.durability, cubed_tpu_torch.service.service\n"
        "import cubed_tpu_torch.runtime.autoscale, cubed_tpu_torch.runtime.audit, cubed_tpu_torch.audit\n"
        "import cubed_tpu_torch.runtime.payload, cubed_tpu_torch.runtime.distributed, cubed_tpu_torch.runtime.worker\n"
        "import cubed_tpu_torch.runtime.transfer, cubed_tpu_torch.runtime.shuffle\n"
        "import cubed_tpu_torch.runtime.executors.multiprocess, cubed_tpu_torch.runtime.executors.distributed\n"
        "import cubed_tpu_torch.explain, cubed_tpu_torch.regress, cubed_tpu_torch.diagnose, cubed_tpu_torch.top\n"
        "import cubed_tpu_torch.parallel, cubed_tpu_torch.parallel.ring, cubed_tpu_torch.parallel.ring_attention\n"
        "import cubed_tpu_torch.kernels.flash_block, cubed_tpu_torch.runtime.campaign, cubed_tpu_torch.chaos\n"
        "import cubed_tpu_torch.runtime.arming\n"
        "print('\\n'.join(sorted(sys.modules)))"
    )
    assert proc.returncode == 0, proc.stderr
    loaded = [m for m in proc.stdout.split() if _forbidden(m)]
    assert loaded == []


def _compute_on_cpu(tmp_path, observed: bool) -> None:
    """A compute in a fresh interpreter loads no forbidden module; *observed*
    attaches a TraceCollector (and the tracing and profiler callbacks),
    whose traces it writes."""
    callbacks = (
        "from cubed_tpu_torch.observability import (TraceCollector, TracingCallback,\n"
        "    TorchProfilerCallback, DeviceMemoryCallback)\n"
        f"cbs = [TraceCollector(trace_dir={str(tmp_path / 'trace')!r}),\n"
        f"       TracingCallback(trace_path={str(tmp_path / 'trace.json')!r}),\n"
        f"       TorchProfilerCallback(log_dir={str(tmp_path / 'profile')!r}), DeviceMemoryCallback()]\n"
    ) if observed else "cbs = None\n"
    proc = _run(
        "import sys, cubed_tpu_torch as ct, cubed_tpu_torch.array_api as xp\n"
        + callbacks +
        f"spec = ct.Spec(work_dir={str(tmp_path)!r}, allowed_mem='100MB')\n"
        "a = ct.random.random((8, 8), chunks=4, spec=spec)\n"
        "z = xp.zeros((8, 8), chunks=4, spec=spec)  # a VirtualFullArray, read on the CPU\n"
        "print(float(xp.mean(a[1:] * (a[1:] + z[1:])).compute(callbacks=cbs)))\n"
        "from cubed_tpu_torch.runtime.executors.python_async import AsyncPythonDagExecutor\n"
        "print(float(xp.sum(a).compute(executor=AsyncPythonDagExecutor(max_workers=2))))\n"
        "print('\\n'.join(sorted(sys.modules)))",
        {"CUBED_TPU_TORCH_DEVICE": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr
    assert [m for m in proc.stdout.split() if _forbidden(m)] == []
    if observed:
        assert "cubed_tpu_torch.observability.collect" in proc.stdout.split()
        assert len(os.listdir(tmp_path / "trace")) == 1 and len(os.listdir(tmp_path / "profile")) == 1


def test_compute_on_cpu_loads_no_jax_or_reference_modules(tmp_path):
    _compute_on_cpu(tmp_path, observed=False)


def test_observed_compute_on_cpu_loads_no_jax_or_reference_modules(tmp_path):
    _compute_on_cpu(tmp_path, observed=True)


def test_armed_observability_and_the_clis_load_no_jax(tmp_path):
    """A compute with run history, live telemetry, the dispatch profiler and
    a flight recorder armed, then the four CLIs on what it left (top from
    the live endpoint), in a fresh interpreter: no forbidden module."""
    proc = _run(
        "import sys, cubed_tpu_torch as ct, cubed_tpu_torch.array_api as xp\n"
        "from cubed_tpu_torch import explain, regress, diagnose, top\n"
        "from cubed_tpu_torch.observability import FlightRecorder, export\n"
        f"spec = ct.Spec(work_dir={str(tmp_path)!r}, allowed_mem='100MB', run_history={str(tmp_path / 'h')!r},\n"
        "               telemetry_port=0, dispatch_profile=True)\n"
        "a = ct.random.random((8, 8), chunks=4, spec=spec)\n"
        "try:\n"
        "    for _ in range(2):\n"
        f"        fr = FlightRecorder(bundle_dir={str(tmp_path / 'fr')!r}, always=True)\n"
        "        xp.sum(a).compute(callbacks=[fr])\n"
        f"    xp.sum(a).plan.explain(spec=spec).save({str(tmp_path / 'e.json')!r})\n"
        f"    rcs = [explain.main([{str(tmp_path / 'e.json')!r}]), diagnose.main([fr.bundle_path, '--analyze']),\n"
        f"           regress.main(['--history', {str(tmp_path / 'h')!r}]),\n"
        "           top.main([f'127.0.0.1:{export.get_runtime().port}', '--once'])]\n"
        "finally:\n"
        "    export.shutdown()\n"
        "print('RCS', rcs[0], rcs[1], rcs[3], rcs[2] in (0, 1))\n"
        "print('\\n'.join(sorted(sys.modules)))",
        {"CUBED_TPU_TORCH_DEVICE": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.split()
    assert out[out.index("RCS"):out.index("RCS") + 5] == ["RCS", "0", "0", "0", "True"]
    assert [m for m in out if _forbidden(m)] == []


#: the one place a source may import fsspec, and why: the remote-IO class of
#: the store imports it when a store that is not a local path is opened
#: (``s3://``, ``memory://``, ...), so neither an import of the port nor a
#: local compute loads it (checked at run time below)
FSSPEC_EXEMPTION = (os.path.join("cubed_tpu_torch", "storage", "store.py"), "_FsspecIO", "fsspec")


def _imported_modules(path: str, skip_class=None) -> set:
    """The modules *path* imports, less those imported inside the class
    named *skip_class*."""
    with open(path) as f:
        tree = ast.parse(f.read())
    skipped = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == skip_class:
            skipped.update(id(n) for n in ast.walk(node))
    names = set()
    for node in ast.walk(tree):
        if id(node) in skipped:
            continue
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            names.update(a.value for a in node.args if isinstance(a, ast.Constant))
    return names


SOURCES = ["chip_smoke.py"] + sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(os.path.join(REPO, "cubed_tpu_torch"))
    for f in files if f.endswith(".py")
)


def test_source_walk_covers_every_subpackage():
    for sub in ("observability", "extensions", "runtime", "kernels", "storage", "array_api", "parallel"):
        assert any(p.startswith(os.path.join("cubed_tpu_torch", sub, "")) for p in SOURCES), sub
    assert os.path.join("cubed_tpu_torch", "observability", "collect.py") in SOURCES
    for module in ("constants", "device", "indexing_functions", "searching_functions", "set_functions",
                   "utility_functions", "sorting_functions", "_block_sort", "linalg"):
        assert os.path.join("cubed_tpu_torch", "array_api", f"{module}.py") in SOURCES, module
    for path in (("nan_functions.py",), ("kernels", "merge_sort.py"), ("core", "visualization.py"),
                 ("array_api", "html_repr.py"), ("random.py",), ("storage", "store.py"),
                 ("runtime", "executors", "python_async.py"), ("runtime", "dataflow.py"), ("runtime", "journal.py"),
                 ("runtime", "backup.py"), ("service", "cache.py"), ("explain.py",), ("regress.py",),
                 ("diagnose.py",), ("top.py",), ("runtime", "payload.py"), ("runtime", "distributed.py"),
                 ("runtime", "transfer.py"), ("runtime", "shuffle.py"), ("runtime", "worker.py"),
                 ("runtime", "executors", "multiprocess.py"), ("runtime", "executors", "distributed.py")):
        assert os.path.join("cubed_tpu_torch", *path) in SOURCES, path
    for module in ("slo", "alerts", "dispatchprofile", "flightrecorder", "analytics", "runhistory",
                   "timeseries", "export"):
        assert os.path.join("cubed_tpu_torch", "observability", f"{module}.py") in SOURCES, module


@pytest.mark.parametrize("path", SOURCES)
def test_sources_import_no_jax_or_reference_modules(path):
    exempt_path, exempt_class, _ = FSSPEC_EXEMPTION
    skip = exempt_class if path == exempt_path else None
    assert [m for m in _imported_modules(os.path.join(REPO, path), skip) if _forbidden(m)] == []


def test_the_fsspec_exemption_is_exactly_the_remote_io_class():
    path, cls, module = FSSPEC_EXEMPTION
    whole = _imported_modules(os.path.join(REPO, path))
    outside = _imported_modules(os.path.join(REPO, path), cls)
    assert [m for m in whole - outside if _forbidden(m)] == [module]


def test_local_stores_with_storage_options_load_no_fsspec(tmp_path):
    """to_zarr and from_zarr of a local store, with storage_options given
    (a local store ignores them), and a compute whose spec carries them:
    fsspec stays unloaded."""
    proc = _run(
        "import sys, cubed_tpu_torch as ct, cubed_tpu_torch.array_api as xp\n"
        f"spec = ct.Spec(work_dir={str(tmp_path)!r}, allowed_mem='100MB', storage_options={{'anon': True}})\n"
        "a = ct.random.random((8, 8), chunks=4, spec=spec)\n"
        f"ct.to_zarr(xp.add(a, 1.0).rechunk((8, 2)), {str(tmp_path / 'out.zarr')!r}, storage_options={{'anon': True}})\n"
        f"print(ct.from_zarr({str(tmp_path / 'out.zarr')!r}, storage_options={{'anon': True}}).compute().shape)\n"
        "print('\\n'.join(sorted(sys.modules)))",
        {"CUBED_TPU_TORCH_DEVICE": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[:2] == ["(8,", "8)"]
    assert [m for m in proc.stdout.split() if _forbidden(m)] == []


def test_compute_without_cuda_raises_instead_of_running_on_cpu(tmp_path):
    """On the default sequential executor, on the device executor passed to
    compute(), and on the device executor driven directly."""
    proc = _run(
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "import cubed_tpu_torch as ct, cubed_tpu_torch.array_api as xp\n"
        "from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor\n"
        f"spec = ct.Spec(work_dir={str(tmp_path)!r}, allowed_mem='100MB')\n"
        "a = ct.random.random((8, 8), chunks=4, spec=spec)\n"
        "runs = [lambda: xp.sum(a).compute(), lambda: xp.sum(a).compute(executor=CudaExecutor()),\n"
        "        lambda: CudaExecutor().execute_dag(xp.sum(a).plan._finalize().dag)]\n"
        "for run in runs:\n"
        "    try:\n"
        "        run()\n"
        "    except RuntimeError as e:\n"
        "        print('RAISED', 'is_available() is False' in str(e))\n"
        "    else:\n"
        "        print('COMPUTED')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["RAISED", "True"] * 3
    assert not list(tmp_path.rglob("*.zarr")), "no task may run before the device check"


def test_zarr_stencil_random_and_introspection_on_cpu_load_no_jax(tmp_path):
    """to_zarr (compressed), map_overlap, normal, randint, pad, visualize and
    the HTML repr in a fresh interpreter load no forbidden module."""
    proc = _run(
        "import sys, torch, cubed_tpu_torch as ct, cubed_tpu_torch.array_api as xp\n"
        f"spec = ct.Spec(work_dir={str(tmp_path)!r}, allowed_mem='100MB')\n"
        "a = ct.random.normal((8, 8), chunks=4, spec=spec)\n"
        "b = ct.map_overlap(lambda t: torch.roll(t, 1, 0) - t, a, depth=1, boundary='periodic')\n"
        f"ct.to_zarr(b, {str(tmp_path / 'out.zarr')!r}, compressor={{'id': 'zlib', 'level': 1}})\n"
        "r = xp.pad(ct.random.randint(0, 9, (4, 4), chunks=2, spec=spec), 1, mode='edge')\n"
        "print(r.compute().shape, b._repr_html_().count('<svg'))\n"
        f"ct.visualize(b, r, filename={str(tmp_path / 'plan')!r})\n"
        "print('\\n'.join(sorted(sys.modules)))",
        {"CUBED_TPU_TORCH_DEVICE": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[:3] == ["(6,", "6)", "1"]
    assert [m for m in proc.stdout.split() if _forbidden(m)] == []
    assert (tmp_path / "plan.dot").exists()


def test_to_zarr_and_measure_reserved_mem_without_cuda_raise(tmp_path):
    """The default device is the card: without one, to_zarr and
    measure_reserved_mem raise before any task runs, as compute does."""
    proc = _run(
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "import cubed_tpu_torch as ct\n"
        f"spec = ct.Spec(work_dir={str(tmp_path)!r}, allowed_mem='100MB')\n"
        "a = ct.random.normal((8, 8), chunks=4, spec=spec)\n"
        f"runs = [lambda: ct.to_zarr(a, {str(tmp_path / 'out.zarr')!r}),\n"
        f"        lambda: ct.measure_reserved_mem(work_dir={str(tmp_path)!r})]\n"
        "for run in runs:\n"
        "    try:\n"
        "        run()\n"
        "    except RuntimeError as e:\n"
        "        print('RAISED', 'is_available() is False' in str(e))\n"
        "    else:\n"
        "        print('COMPUTED')\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["RAISED", "True"] * 2
    assert not (tmp_path / "out.zarr").exists()


def test_device_seam_env_and_set_device():
    proc = _run(
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from cubed_tpu_torch import backend_array_api as b\n"
        "print(b.get_device())\n"
        "b.set_device('cuda')\n",
        {"CUBED_TPU_TORCH_DEVICE": "cpu"},
    )
    assert proc.stdout.split() == ["cpu"]
    assert proc.returncode != 0 and "RuntimeError" in proc.stderr


_WORKER_PROBE = (
    "import sys\n"
    "sys.path.insert(0, {repo!r})\n"
    "import multiprocessing, numpy as np, cubed_tpu_torch as ct, cubed_tpu_torch.array_api as xp\n"
    "from cubed_tpu_torch.runtime.executors.multiprocess import MultiprocessDagExecutor, _ProcessTaskRunner\n"
    "from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor\n"
    "from cubed_tpu_torch.runtime.pipeline import visit_nodes\n"
    "from cubed_tpu_torch.runtime.utils import execute_in_worker\n"
    "from tests._torch_fleet import loaded_modules\n"
    "if __name__ == '__main__':\n"
    "    spec = ct.Spec(work_dir={work_dir!r}, allowed_mem='100MB')\n"
    "    a, b = [ct.random.random((8, 8, 6), chunks=4, spec=spec) for _ in range(2)]\n"
    "    v = xp.mean(ct.map_blocks(lambda t: t * 2.0, a, dtype=np.float64)[1:] * b[1:])\n"
    "    ex = MultiprocessDagExecutor(max_workers=1)\n"
    "    print('POOL', float(v.compute(executor=ex)))\n"
    "    pool = ex._new_pool(multiprocessing.get_context('spawn'), 1, 'cpu')\n"
    "    for name, node in visit_nodes(v.plan._finalize().dag):\n"
    "        p = node['primitive_op'].pipeline\n"
    "        pool.submit(execute_in_worker, _ProcessTaskRunner(p.function, p.config), list(p.mappable)[0]).result()\n"
    "    print('POOLMODS', pool.submit(loaded_modules).result())\n"
    "    pool.shutdown()\n"
    "    with DistributedDagExecutor(n_local_workers=1) as fl:\n"
    "        print('FLEET', float(v.compute(executor=fl)))\n"
    "        print('FLEETMODS', fl._coordinator.submit(None, loaded_modules, None).result(timeout=60)[0])\n"
)


def test_pool_and_fleet_workers_load_no_jax_cloudpickle_or_reference(tmp_path):
    """A spawned pool worker, after running a task of every op of a plan,
    and a fleet worker, after a whole compute, hold no forbidden module."""
    proc = _run(_WORKER_PROBE.format(repo=REPO, work_dir=str(tmp_path)), {"CUBED_TPU_TORCH_DEVICE": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines() if " " in line)
    assert lines["POOL"] == lines["FLEET"]
    for key in ("POOLMODS", "FLEETMODS"):
        mods = ast.literal_eval(lines[key])
        assert "cubed_tpu_torch.runtime.payload" in mods, key
        assert [m for m in mods if _forbidden(m)] == [], key


def test_workers_asked_for_cuda_without_a_card_fail_the_compute(tmp_path):
    """A pool worker and a fleet worker asked for ``cuda`` on a machine with
    no card fail the compute with the device error; no task runs."""
    import numpy as np

    import cubed_tpu_torch as ct
    import cubed_tpu_torch.array_api as xp
    from cubed_tpu_torch.backend_array_api import set_device
    from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor
    from cubed_tpu_torch.runtime.executors.multiprocess import MultiprocessDagExecutor

    set_device("cpu")
    try:
        spec = ct.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
        a = ct.from_array(np.ones((4, 4)), chunks=(2, 2), spec=spec)
        r = ct.map_blocks(lambda x: x + 1.0, a, dtype=np.float64)
        with pytest.raises(RuntimeError, match="is_available\\(\\) is False"):
            r.compute(executor=MultiprocessDagExecutor(max_workers=1, device="cuda", retries=0))
        with pytest.raises(RuntimeError, match="exited with code 1 before joining.*'cuda'"):
            r.compute(executor=DistributedDagExecutor(n_local_workers=1, device="cuda"))
        written = [p for p in tmp_path.rglob("*") if p.is_file() and p.parent.name.endswith(".zarr")
                   and not p.name.startswith(".")]
        assert written == [], "a task ran although its worker had no device"
    finally:
        set_device(None)


_RECOVERY_PROBE = (
    "import sys, json\n"
    "sys.path.insert(0, {repo!r})\n"
    "import numpy as np\n"
    "import cubed_tpu_torch as ct\n"
    "from cubed_tpu_torch.service import ComputeService\n"
    "from cubed_tpu_torch.service.durability import TenantRequestJournal\n"
    "if sys.argv[1] == 'accept':\n"
    "    spec = ct.Spec(work_dir={work_dir!r}, allowed_mem='100MB')\n"
    "    a = ct.from_array(np.arange(16.0).reshape(4, 4), chunks=(2, 2), spec=spec)\n"
    "    k = 3.0\n"
    "    r = ct.map_blocks(lambda x: x * k, a, dtype=np.float64)\n"
    "    print('DURABLE', TenantRequestJournal({sdir!r}, 'gold').record_accepted('r-probe', r))\n"
    "else:\n"
    "    with ComputeService(service_dir={sdir!r}) as svc:\n"
    "        svc.wait_idle(60)\n"
    "        print('VALUE', json.dumps(svc.handle('r-probe').result(60).tolist()))\n"
    "    print('MODS', sorted(sys.modules))\n"
)


def test_recovered_request_and_autoscaled_worker_load_no_jax_cloudpickle_or_reference(tmp_path):
    """A durable request accepted in one process and recovered and run by a
    service in a fresh one, and a worker the autoscaler spawned, hold no
    forbidden module."""
    import numpy as np

    code = _RECOVERY_PROBE.format(repo=REPO, work_dir=str(tmp_path / "work"), sdir=str(tmp_path / "svc"))
    env = {"CUBED_TPU_TORCH_DEVICE": "cpu"}
    accept = subprocess.run([sys.executable, "-c", code, "accept"], capture_output=True, text=True, cwd=REPO,
                            env={**os.environ, **env}, timeout=120)
    assert accept.returncode == 0 and "DURABLE True" in accept.stdout, accept.stderr[-3000:]
    recover = subprocess.run([sys.executable, "-c", code, "recover"], capture_output=True, text=True, cwd=REPO,
                             env={**os.environ, **env}, timeout=120)
    assert recover.returncode == 0, recover.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in recover.stdout.splitlines() if " " in line)
    np.testing.assert_array_equal(np.array(ast.literal_eval(lines["VALUE"])), np.arange(16.0).reshape(4, 4) * 3.0)
    assert [m for m in ast.literal_eval(lines["MODS"]) if _forbidden(m)] == []

    from cubed_tpu_torch.backend_array_api import set_device
    from cubed_tpu_torch.runtime.autoscale import AutoscalePolicy
    from cubed_tpu_torch.runtime.executors.distributed import DistributedDagExecutor

    from . import _torch_fleet

    set_device("cpu")
    ex = DistributedDagExecutor(n_local_workers=1, autoscale_policy=AutoscalePolicy(
        min_workers=2, max_workers=2, interval_s=0.2))
    try:
        coord = ex._ensure_fleet()
        coord.wait_for_workers(2, timeout=60)
        spawned = ex._procs[1].pid
        seen = {}
        for _ in range(3):
            futs = [coord.submit(None, _torch_fleet.pid_and_modules, i) for i in range(4)]
            seen.update(dict(f.result(timeout=60)[0] for f in futs))
            if spawned in seen:
                break
        assert spawned in seen and ex.stats["autoscale"]["workers_scaled_up"] == 1
        assert "cubed_tpu_torch.runtime.payload" in seen[spawned]
        assert [m for m in seen[spawned] if _forbidden(m)] == []
    finally:
        ex.close()
        set_device(None)


def test_a_durable_payload_naming_cuda_fails_its_recovery_without_a_card(tmp_path, monkeypatch):
    """A durable request whose payload holds a tensor from a card (as one
    written on a card host does), recovered where there is no card, is
    sealed failed with the device error: it never runs on the CPU."""
    import io
    import pickle

    import numpy as np
    import torch

    import cubed_tpu_torch as ct
    from cubed_tpu_torch.backend_array_api import set_device
    from cubed_tpu_torch.runtime import payload
    from cubed_tpu_torch.service import ComputeService
    from cubed_tpu_torch.service.durability import REQUESTS_FILE, TenantRequestJournal, _raw_records, load_requests

    class FromCard(payload.PayloadPickler):
        """Tags every tensor as one that left a card."""

        hosts: list = []

        def reducer_override(self, obj):
            if isinstance(obj, torch.Tensor) and not any(obj is h for h in self.hosts):
                self.hosts.append(obj.detach().clone())
                return (payload._restore_tensor, (self.hosts[-1], "cuda"))
            return super().reducer_override(obj)

    def dumps_from_card(obj):
        buf = io.BytesIO()
        FromCard(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
        return buf.getvalue()

    set_device("cpu")
    try:
        spec = ct.Spec(work_dir=str(tmp_path / "work"), allowed_mem="100MB")
        offset = torch.full((2, 2), 5.0, dtype=torch.float64)
        r = ct.map_blocks(lambda x: x + offset, ct.from_array(np.ones((4, 4)), chunks=(2, 2), spec=spec),
                          dtype=np.float64)
        sdir = str(tmp_path / "svc")
        monkeypatch.setattr(payload, "dumps", dumps_from_card)
        assert TenantRequestJournal(sdir, "gold").record_accepted("r-card", r)
        monkeypatch.undo()
        with ComputeService(service_dir=sdir) as svc:
            assert svc.wait_idle(30)
            assert svc.handle("r-card") is None  # never re-enqueued
        done = [rec for rec in _raw_records(os.path.join(sdir, "gold", REQUESTS_FILE)) if rec["kind"] == "done"]
        assert [d["status"] for d in done] == ["failed"]
        assert "cuda" in done[0]["error"] and "chunk device is cpu" in done[0]["error"]
        assert load_requests(sdir) == {}
        written = [p for p in (tmp_path / "work").rglob("*") if p.is_file() and p.parent.name.endswith(".zarr")
                   and not p.name.startswith(".")]
        assert written == [], "the request ran although its payload names a card"
    finally:
        set_device(None)

