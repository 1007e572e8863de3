"""The port's task payloads (``runtime/payload.py``, the stdlib's ``pickle``
where the JAX package ships ``cloudpickle``): functions by reference and by
value, closures (a recursive one too), defaults, globals, partials, bound
methods and a lambda in ``map_blocks``; a plan's pipelines unpickled and run
in a fresh interpreter computing what the JAX package computes; and the
refusal of a class that has no importable name."""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import functools  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch as ct  # noqa: E402
import cubed_tpu_torch.array_api as xp  # noqa: E402
from cubed_tpu_torch.observability.metrics import get_registry  # noqa: E402
from cubed_tpu_torch.runtime import payload  # noqa: E402
from cubed_tpu_torch.runtime.executors.python import PythonDagExecutor  # noqa: E402
from cubed_tpu_torch.runtime.pipeline import visit_nodes  # noqa: E402

from . import _torch_fleet  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 3.0


def _roundtrip(obj):
    return payload.loads(payload.dumps(obj))


def test_module_function_travels_by_reference():
    data = payload.dumps(_torch_fleet.bump)
    assert b"marshal" not in data and len(data) < 200
    assert payload.loads(data) is _torch_fleet.bump


def test_lambda_with_defaults_kwdefaults_and_globals_by_value():
    fn = lambda x, y=2.0, *, z=5.0: x * SCALE + y + z + np.float64(0.5)  # noqa: E731
    out = _roundtrip(fn)
    assert out is not fn and out.__name__ == "<lambda>"
    assert out(1.0) == fn(1.0) == 10.5
    assert out(1.0, 3.0, z=1.0) == fn(1.0, 3.0, z=1.0)
    assert out.__defaults__ == (2.0,) and out.__kwdefaults__ == {"z": 5.0}


def test_closures_and_a_recursive_closure():
    def outer(k):
        def fact(n):
            return 1 if n <= 0 else n * fact(n - 1) * k

        return fact

    f = outer(1)
    g = _roundtrip(f)
    assert g(5) == f(5) == 120
    # a cell bound after the inner function was made, and one never bound
    def late():
        def inner():
            return later + 1

        later = 41
        return inner

    assert _roundtrip(late())() == 42

    def unbound():
        def inner():
            return never  # noqa: F821

        if False:
            never = 1
        return inner

    with pytest.raises(NameError):
        _roundtrip(unbound())()


class _Adder:
    def __init__(self, k):
        self.k = k

    def add(self, x):
        return x + self.k


def test_partial_bound_method_and_modules_by_name():
    p = functools.partial(lambda x, y: x - y, y=2.0)
    assert _roundtrip(p)(5.0) == 3.0
    m = _Adder(4.0).add
    assert _roundtrip(m)(1.0) == 5.0
    uses_modules = lambda t: torch.as_tensor(np.asarray(t)) * 2  # noqa: E731
    out = _roundtrip(uses_modules)
    assert out.__globals__["torch"] is torch and out.__globals__["np"] is np
    assert torch.equal(out([1.0, 2.0]), torch.tensor([2.0, 4.0], dtype=torch.float64))


def test_a_host_tensor_is_not_counted_as_device_bytes():
    before = get_registry().counter(payload.DEVICE_BYTES_COUNTER).value
    t = torch.arange(6, dtype=torch.float64)
    assert torch.equal(_roundtrip(lambda: t)(), t)
    assert get_registry().counter(payload.DEVICE_BYTES_COUNTER).value == before


def test_a_local_class_is_refused_by_name():
    class Local:
        pass

    with pytest.raises(TypeError, match=r"test_a_local_class_is_refused_by_name.<locals>.Local.*define it"):
        payload.dumps(Local())
    with pytest.raises(TypeError, match="define it at the top level of a module"):
        payload.dumps(lambda: Local)


def _vorticity(pkg, xp_, spec, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    a, b, x, y = [pkg.from_array(rng.random((12, 10, 8)), chunks=(4, 5, 4), spec=spec) for _ in range(4)]
    a2 = pkg.map_blocks(lambda t: t * SCALE, a, dtype=np.float64)
    return xp_.mean(a2[1:] * x[1:] + b[1:] * y[1:])


def test_every_pipeline_of_a_plan_round_trips_and_matches_the_reference(tmp_path):
    """Each op's ``(function, config)`` through the payload, run task by task
    in this process: the value equals the JAX package's sequential one."""

    class PayloadExecutor(PythonDagExecutor):
        def execute_dag(self, dag, **kwargs):
            for _name, node in visit_nodes(dag):
                p = node["primitive_op"].pipeline
                function, config = _roundtrip((p.function, p.config))
                for m in p.mappable:
                    function(m, config=config)

    ref = float(_vorticity(cubed_tpu, rxp, cubed_tpu.Spec(work_dir=str(tmp_path / "r"), allowed_mem="500MB")).compute())
    v = _vorticity(ct, xp, ct.Spec(work_dir=str(tmp_path / "p"), allowed_mem="500MB"))
    assert float(v.compute(executor=PayloadExecutor())) == pytest.approx(ref, rel=1e-12)
    assert float(v.compute()) == float(v.compute(executor=PayloadExecutor()))


_FRESH = r"""
import sys
sys.path.insert(0, {repo!r})
from cubed_tpu_torch.runtime import payload
with open({path!r}, "rb") as f:
    ops = payload.loads(f.read())
for name, function, config, mappable in ops:
    for m in mappable:
        function(m, config=config)
print(len(ops), sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "cubed_tpu", "cloudpickle")))
"""


def test_a_pipeline_unpickled_in_a_fresh_interpreter_computes_the_reference(tmp_path):
    """The plan's pipelines, shipped to a fresh interpreter (as a worker
    gets them), write the plan's stores there, loading no JAX; resuming
    here skips what verifies, and the value is the JAX package's."""
    spec = ct.Spec(work_dir=str(tmp_path / "p"), allowed_mem="500MB")
    v = _vorticity(ct, xp, spec)
    finalized = v.plan._finalize()
    ops = [(name, node["primitive_op"].pipeline.function, node["primitive_op"].pipeline.config,
            list(node["primitive_op"].pipeline.mappable)) for name, node in visit_nodes(finalized.dag)]
    path = str(tmp_path / "ops.payload")
    with open(path, "wb") as f:
        f.write(payload.dumps(ops))
    env = dict(os.environ, CUBED_TPU_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _FRESH.format(repo=REPO, path=path)], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_ops, forbidden = proc.stdout.split(" ", 1)
    assert int(n_ops) == len(ops) and forbidden.strip() == "[]"

    class Count(ct.Callback):
        n = 0

        def on_task_end(self, event):
            Count.n += 1

    got = float(v.compute(resume=True, callbacks=[Count()]))
    ref = float(_vorticity(cubed_tpu, rxp, cubed_tpu.Spec(work_dir=str(tmp_path / "r"), allowed_mem="500MB")).compute())
    assert got == pytest.approx(ref, rel=1e-12)
    # the fresh interpreter's writes verify: most of the plan is skipped
    assert Count.n < finalized.num_tasks() // 2
