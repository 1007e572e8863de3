"""The port stands alone: importing it loads no JAX, networkx, cloudpickle,
fsspec, graphviz binding or module of the JAX package, neither does
chip_smoke.py, and with no
device asked for and no CUDA it refuses to compute instead of running on the
CPU. Each check runs in a fresh interpreter."""

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
        "import cubed_tpu_torch.service.cache\n"
        "import cubed_tpu_torch.explain, cubed_tpu_torch.regress, cubed_tpu_torch.diagnose, cubed_tpu_torch.top\n"
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


def _imported_modules(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
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
    for sub in ("observability", "extensions", "runtime", "kernels", "storage", "array_api"):
        assert any(p.startswith(os.path.join("cubed_tpu_torch", sub, "")) for p in SOURCES), sub
    assert os.path.join("cubed_tpu_torch", "observability", "collect.py") in SOURCES
    for module in ("constants", "device", "indexing_functions", "searching_functions", "set_functions",
                   "utility_functions", "sorting_functions", "_block_sort", "linalg"):
        assert os.path.join("cubed_tpu_torch", "array_api", f"{module}.py") in SOURCES, module
    for path in (("nan_functions.py",), ("kernels", "merge_sort.py"), ("core", "visualization.py"),
                 ("array_api", "html_repr.py"), ("random.py",), ("storage", "store.py"),
                 ("runtime", "executors", "python_async.py"), ("runtime", "dataflow.py"), ("runtime", "journal.py"),
                 ("runtime", "backup.py"), ("service", "cache.py"), ("explain.py",), ("regress.py",),
                 ("diagnose.py",), ("top.py",)):
        assert os.path.join("cubed_tpu_torch", *path) in SOURCES, path
    for module in ("slo", "alerts", "dispatchprofile", "flightrecorder", "analytics", "runhistory",
                   "timeseries", "export"):
        assert os.path.join("cubed_tpu_torch", "observability", f"{module}.py") in SOURCES, module


@pytest.mark.parametrize("path", SOURCES)
def test_sources_import_no_jax_or_reference_modules(path):
    assert [m for m in _imported_modules(os.path.join(REPO, path)) if _forbidden(m)] == []


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
