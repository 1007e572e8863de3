"""Plan introspection of the port, held against the JAX package: ``visualize``
and its DOT text, ``Plan.optimize``, ``num_arrays``, ``total_nbytes_written``,
``compute(optimize_function=...)``, ``npartitions``/``itemsize``, the HTML
repr and ``measure_reserved_mem``.

The counterparts of ``tests/test_html.py`` and of the ``num_arrays``/
``visualize``/``optimize_function`` cases of ``tests/test_optimization.py``
and ``tests/test_core.py``. The same plan built in both packages by one
helper gives the same DOT text once the generated names (``array-NNN``,
``op-...-NNN``) are replaced by their order of appearance: the tooltips'
caller frames are the helper's and the test's in both.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import functools  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as xp  # noqa: E402
from cubed_tpu.core.visualization import build_dot as ref_build_dot  # noqa: E402
from cubed_tpu_torch.core.optimization import multiple_inputs_optimize_dag  # noqa: E402
from cubed_tpu_torch.core.visualization import build_dot  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402


@pytest.fixture
def spec(tmp_path):
    return cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="500MB", reserved_mem=0)


def _specs(tmp_path):
    return {cubed_tpu: cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem="500MB", reserved_mem=0),
            cubed_tpu_torch: cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem="500MB",
                                                  reserved_mem=0)}


def _canonical(dot: str) -> str:
    names: dict = {}
    return re.sub(r"op-[A-Za-z_\-]+-\d{9}|[a-z_\-]+-\d{9}",
                  lambda m: names.setdefault(m.group(0), f"N{len(names)}"), dot)


def _elementwise(pkg, spec):
    a = pkg.from_array(np.arange(36.0).reshape(6, 6), chunks=(2, 2), spec=spec)
    b = pkg.array_api.add(a, 1)
    return pkg.array_api.multiply(b, b)


def _reduction(pkg, spec):
    a = pkg.from_array(np.arange(48.0).reshape(6, 8), chunks=(2, 3), spec=spec)
    return pkg.array_api.sum(pkg.array_api.negative(a), axis=0)


def _random_mean(pkg, spec):
    a, x = (pkg.random.random((20, 10), chunks=5, spec=spec) for _ in range(2))
    return pkg.array_api.mean(pkg.array_api.multiply(a[1:], x[1:]))


def _rechunked(pkg, spec):
    return pkg.array_api.ones((8, 8), chunks=(2, 8), spec=spec).rechunk((8, 2))


PLANS = {"elementwise": _elementwise, "reduction": _reduction, "random_mean": _random_mean,
         "rechunked": _rechunked}


def _both(tmp_path, build):
    specs = _specs(tmp_path)
    return [build(pkg, specs[pkg]) for pkg in (cubed_tpu, cubed_tpu_torch)]


@pytest.mark.parametrize("optimize_graph", [True, False])
@pytest.mark.parametrize("show_hidden", [False, True])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_dot_text_equals_the_reference(tmp_path, plan, show_hidden, optimize_graph):
    r, p = _both(tmp_path, PLANS[plan])
    rdag = r.plan._finalize(optimize_graph=optimize_graph, array_names=(r.name,)).dag
    pdag = p.plan._finalize(optimize_graph=optimize_graph, array_names=(p.name,)).dag
    ref = _canonical(ref_build_dot(rdag, rankdir="LR", show_hidden=show_hidden))
    ours = _canonical(build_dot(pdag, rankdir="LR", show_hidden=show_hidden))
    assert ours == ref
    assert "calls: _both" in ours and "rankdir=\"LR\"" in ours


@pytest.mark.parametrize("optimize_graph", [True, False])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_num_arrays_tasks_and_bytes_written_equal_the_reference(tmp_path, plan, optimize_graph):
    r, p = _both(tmp_path, PLANS[plan])
    for method in ("num_arrays", "num_tasks", "max_projected_mem", "total_nbytes_written"):
        assert getattr(p.plan, method)(optimize_graph=optimize_graph) == \
            getattr(r.plan, method)(optimize_graph=optimize_graph), method
    assert p.npartitions == r.npartitions and p.itemsize == r.itemsize


def test_visualize_writes_the_dot_file(spec, tmp_path):
    b = xp.add(xp.ones((6, 6), chunks=(2, 2), spec=spec), 1)
    out = b.visualize(filename=str(tmp_path / "plan"))
    assert os.path.exists(out)
    dot = open(str(tmp_path / "plan.dot")).read()
    assert dot.startswith("digraph {") and "create-arrays" in dot
    out2 = cubed_tpu_torch.visualize(b, xp.negative(b), filename=str(tmp_path / "both"), format="png")
    assert os.path.exists(out2)


def test_plan_optimize_returns_a_plan(spec):
    d = xp.negative(xp.negative(xp.negative(xp.ones((6, 6), chunks=(2, 2), spec=spec))))
    optimized = d.plan.optimize()
    assert isinstance(optimized, type(d.plan))
    ops = [n for n, v in optimized.dag.nodes.items() if v.get("type") == "op" and v.get("primitive_op")]
    assert len(ops) == 1
    never = d.plan.optimize(lambda dag, array_names=None: dag)
    assert len([n for n, v in never.dag.nodes.items() if v.get("primitive_op")]) == 3


# ---------------------------------------------------------------------------
# counts per fusion shape (tests/test_optimization.py:146-270)
# ---------------------------------------------------------------------------


def _counts(arr, optimize_function=None, optimize_graph=True):
    plan = arr.plan
    return (
        plan._finalize(optimize_graph=optimize_graph, optimize_function=optimize_function).num_ops(),
        plan.num_tasks(optimize_graph=optimize_graph, optimize_function=optimize_function),
        plan.num_arrays(optimize_graph=optimize_graph, optimize_function=optimize_function),
    )


def test_unary_chain_exact_counts(spec):
    d = xp.negative(xp.negative(xp.negative(xp.ones((6, 6), chunks=(2, 2), spec=spec))))
    ops_un, tasks_un, arrays_un = _counts(d, optimize_graph=False)
    ops_opt, tasks_opt, arrays_opt = _counts(d, optimize_function=multiple_inputs_optimize_dag)
    assert ops_un - ops_opt == 2
    assert arrays_un - arrays_opt == 2
    assert tasks_opt == 10 and tasks_un == 30
    np.testing.assert_array_equal(d.compute(optimize_function=multiple_inputs_optimize_dag),
                                  np.full((6, 6), -1.0))


def test_fan_in_exact_counts(spec):
    arrs = [xp.ones((4, 4), chunks=(2, 2), spec=spec) for _ in range(4)]
    s = xp.add(xp.add(arrs[0], arrs[1]), xp.add(arrs[2], arrs[3]))
    ops_un, tasks_un, _ = _counts(s, optimize_graph=False)
    ops_opt, tasks_opt, _ = _counts(s, optimize_function=multiple_inputs_optimize_dag)
    assert tasks_un == 3 * 4 + 3 and tasks_opt == 5 and ops_un - ops_opt == 2
    np.testing.assert_array_equal(s.compute(), np.full((4, 4), 4.0))


@pytest.mark.parametrize("executor", [None, CudaExecutor])
def test_fan_in_gate_blocks_wide_fusion(spec, executor):
    arrs = [xp.ones((4, 4), chunks=(2, 2), spec=spec) for _ in range(5)]
    s = xp.add(xp.add(xp.add(arrs[0], arrs[1]), xp.add(arrs[2], arrs[3])), arrs[4])
    gated = functools.partial(multiple_inputs_optimize_dag, max_total_source_arrays=4)
    wide = functools.partial(multiple_inputs_optimize_dag, max_total_source_arrays=5)
    ops_gated, tasks_gated, _ = _counts(s, optimize_function=gated)
    ops_wide, tasks_wide, _ = _counts(s, optimize_function=wide)
    assert tasks_wide == 5 and ops_wide < ops_gated and tasks_gated > tasks_wide
    ex = executor() if executor else None
    np.testing.assert_array_equal(s.compute(optimize_function=wide, executor=ex), np.full((4, 4), 5.0))


def test_repeated_argument_fuses_once(spec):
    b = xp.negative(xp.ones((4, 4), chunks=(2, 2), spec=spec))
    c = xp.add(b, b)
    ops_un, _, _ = _counts(c, optimize_graph=False)
    ops_opt, tasks_opt, _ = _counts(c, optimize_function=multiple_inputs_optimize_dag)
    assert tasks_opt == 5 and ops_un - ops_opt == 1
    np.testing.assert_array_equal(c.compute(), np.full((4, 4), -2.0))


def test_mixed_levels_partial_fusion_counts(spec):
    t = xp.negative(xp.negative(xp.sum(xp.ones((8, 8), chunks=(2, 2), spec=spec), axis=0)))
    ops_un, _, _ = _counts(t, optimize_graph=False)
    ops_opt, _, _ = _counts(t, optimize_function=multiple_inputs_optimize_dag)
    assert ops_un - ops_opt >= 1
    np.testing.assert_array_equal(t.compute(), np.full((8,), 8.0))


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_optimize_function_counts_equal_the_reference(tmp_path, plan):
    from cubed_tpu.core.optimization import multiple_inputs_optimize_dag as ref_optimize

    r, p = _both(tmp_path, PLANS[plan])
    for gate in (1, 2, 4):
        assert _counts(p, functools.partial(multiple_inputs_optimize_dag, max_total_source_arrays=gate)) == \
            _counts(r, functools.partial(ref_optimize, max_total_source_arrays=gate)), gate


def test_total_nbytes_written(spec):
    a = xp.ones((10, 10), chunks=(5, 5), spec=spec)
    b = xp.add(a, 1)
    # the one fused output: 10 * 10 float64
    assert b.plan.total_nbytes_written() == 800
    assert b.plan.total_nbytes_written(optimize_graph=False) == 800


# ---------------------------------------------------------------------------
# the HTML repr (tests/test_html.py)
# ---------------------------------------------------------------------------


def test_repr_html_contains_metadata(spec):
    a = cubed_tpu_torch.from_array(np.arange(48.0).reshape(6, 8), chunks=(2, 4), spec=spec)
    html = a._repr_html_()
    assert "<svg" in html and "float64" in html and "(6, 8)" in html and "Chunk" in html
    assert "6 chunks" in html


def test_repr_html_1d_and_scalar(spec):
    v = xp.ones((12,), chunks=(5,), spec=spec)
    assert "<svg" in v._repr_html_()
    assert xp.sum(v)._repr_html_()


def test_repr_html_ragged_grid(spec):
    assert "<svg" in cubed_tpu_torch.from_array(np.zeros((19, 13)), chunks=(5, 4), spec=spec)._repr_html_()


def test_repr_html_equals_the_reference(tmp_path):
    for build in (lambda pkg, s: pkg.from_array(np.zeros((19, 13)), chunks=(5, 4), spec=s),
                  lambda pkg, s: pkg.array_api.ones((12,), chunks=(5,), spec=s),
                  lambda pkg, s: pkg.array_api.sum(pkg.array_api.ones((12,), chunks=(5,), spec=s))):
        r, p = _both(tmp_path, build)
        assert p._repr_html_() == r._repr_html_()


def test_plain_repr(spec):
    r = repr(cubed_tpu_torch.from_array(np.zeros((4, 4)), chunks=(2, 2), spec=spec))
    assert "Array" in r and "(4, 4)" in r


# ---------------------------------------------------------------------------
# measure_reserved_mem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("executor", [None, CudaExecutor])
def test_measure_reserved_mem(tmp_path, executor):
    reserved = cubed_tpu_torch.measure_reserved_mem(executor=executor() if executor else None,
                                                    work_dir=str(tmp_path))
    assert isinstance(reserved, int) and reserved > 1_000_000  # this interpreter, torch loaded
