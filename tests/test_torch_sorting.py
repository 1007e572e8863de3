"""The port's sort network, sorts, searches and top-k against the JAX
package's, on the CPU: the same seeded numpy inputs through both
(``cubed_tpu_torch`` on the CPU, ``cubed_tpu`` on JAX's CPU backend), case
for case as ``tests/test_block_sort.py`` and the top-k cases of
``tests/test_quantile.py`` hold the reference. Each case compares the
values (against numpy and the reference), the plans (tasks, ops, projected
memory), and ``CudaExecutor``'s path counters against ``JaxExecutor``'s,
every failed check 0 (the network's rounds batched, each a multi-output
op with traced offsets, the partner blocks gathered).

Tolerance: exact everywhere (sorts, argsorts, searches and top-k move
values and count positions). The cases of 10^4 elements or more compare
plans and values but run no JaxExecutor: XLA's CPU compiler constant-folds
sorts of large ``from_array`` inputs for minutes.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu.array_api as rxp  # noqa: E402
import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.core.plan import iter_op_nodes  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402
from cubed_tpu_torch.runtime.pipeline import visit_nodes  # noqa: E402

PATH_COUNTERS = ("whole_array_hits", "whole_concat_hits", "batched_ops", "chunked_ops", "eager_ops",
                 "rechunk_alias", "rechunk_virtual")
FAILED_CHECKS = ("eager_fallbacks", "whole_array_errors", "whole_select_errors", "batched_errors")


@pytest.fixture
def force(monkeypatch):
    # small arrays pass the memory heuristic and take the one-kernel path;
    # force the network in both packages so these cases cover it
    monkeypatch.setenv("CUBED_TPU_SORT_NETWORK", "force")
    monkeypatch.setenv("CUBED_TPU_TORCH_SORT_NETWORK", "force")


def _plan(arr):
    plan = arr.plan._finalize(array_names=(arr.name,))
    return plan.num_tasks(), plan.num_ops(), plan.max_projected_mem()


def _specs(tmp_path, allowed_mem="100MB", reserved_mem=0):
    return (cubed_tpu.Spec(work_dir=str(tmp_path / "ref"), allowed_mem=allowed_mem, reserved_mem=reserved_mem),
            cubed_tpu_torch.Spec(work_dir=str(tmp_path / "port"), allowed_mem=allowed_mem, reserved_mem=reserved_mem))


def _parity(tmp_path, build, *data, chunks, expected=None, allowed_mem="100MB", reserved_mem=0, executors=True,
            reference=True):
    """Build ``build(xp, *arrays)`` in both packages from *data*; assert the
    plans equal, the port's value (sequential and device executor) equal to
    the reference's and to *expected*, and the device executor's counters
    equal to JaxExecutor's (without *reference*, the plans and *expected*
    only, and no failed check on the device executor: for the cases of
    hundreds of tasks). Returns the port's result array."""
    rs, ps = _specs(tmp_path, allowed_mem, reserved_mem)
    chunks = chunks if isinstance(chunks, list) else [chunks] * len(data)
    r = build(rxp, *[cubed_tpu.from_array(d, chunks=c, spec=rs) for d, c in zip(data, chunks)])
    p = build(pxp, *[cubed_tpu_torch.from_array(d, chunks=c, spec=ps) for d, c in zip(data, chunks)])
    assert _plan(p) == _plan(r)
    got = np.asarray(p.compute())
    if expected is not None:
        assert got.dtype == np.asarray(expected).dtype
        np.testing.assert_array_equal(got, expected)
    if not executors:
        return p
    if not reference:
        pex = CudaExecutor()
        np.testing.assert_array_equal(np.asarray(p.compute(executor=pex)), got)
        assert {c: pex.stats[c] for c in FAILED_CHECKS} == dict.fromkeys(FAILED_CHECKS, 0)
        return p
    jax_executor_module._STRUCT_CACHE.clear()
    rex, pex = JaxExecutor(), CudaExecutor()
    ref = np.asarray(r.compute(executor=rex))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.asarray(p.compute(executor=pex)), ref)
    assert {c: pex.stats[c] for c in PATH_COUNTERS} == {c: rex.stats.get(c, 0) for c in PATH_COUNTERS}
    assert {c: pex.stats[c] for c in FAILED_CHECKS} == dict.fromkeys(FAILED_CHECKS, 0)
    return p


def _op_names(arr):
    return [d["op_name"] for _, d in iter_op_nodes(arr.plan.dag)]


def test_sort_axis_larger_than_allowed_mem(tmp_path):
    """The scale criterion: an 800 KB axis under allowed_mem 780 KB in 8
    chunks; the single-chunk path would be refused at plan time, the
    network sorts (auto routing, coarsened)."""
    n = 100_000
    an = np.random.default_rng(0).permutation(n).astype(np.float64)
    _parity(tmp_path, lambda xp, a: xp.sort(a), an, chunks=(12_500,), allowed_mem="780KB",
            expected=np.arange(n, dtype=np.float64), reference=False)


def test_argsort_axis_larger_than_allowed_mem(tmp_path):
    # a 320 KB axis slab under 300 KB in 31 chunks, heavy ties: the stable order
    n = 40_000
    an = np.random.default_rng(1).integers(0, 50, n).astype(np.int64)
    _parity(tmp_path, lambda xp, a: xp.argsort(a), an, chunks=(1_300,), allowed_mem="300KB",
            expected=np.argsort(an, kind="stable"), reference=False)


def test_argsort_one_op_per_round(tmp_path, force):
    """Each argsort round is ONE multi-output op (values and indices from one
    merge), not a values op beside an indices op."""
    an = np.random.default_rng(7).random(64)
    arg = _parity(tmp_path, lambda xp, a: xp.argsort(a), an, chunks=(8,), expected=np.argsort(an, kind="stable"))
    pair_ops = [(n, d) for n, d in iter_op_nodes(arg.plan.dag) if "pair" in d["op_name"]]
    # the local pair sort + log2(8)*(log2(8)+1)/2 = 6 merge rounds
    assert len(pair_ops) == 7
    for name, d in pair_ops:
        assert len(arg.plan.dag.successors(name)) == 2
        assert d["primitive_op"].target_arrays is not None and len(d["primitive_op"].target_arrays) == 2


def test_multioutput_round_resident_on_the_device_executor(tmp_path, force):
    """The reference runs a multi-output op on its distributed executor; the
    port has none yet (ROADMAP Queue 1 item 11c), so its counterpart: every
    round's two outputs admitted to residency on the device executor, the
    requested indices alone written to storage."""
    an = np.random.default_rng(8).integers(0, 9, 48)
    rs, ps = _specs(tmp_path)
    arg = pxp.argsort(cubed_tpu_torch.from_array(an, chunks=(6,), spec=ps))
    ex = CudaExecutor()
    np.testing.assert_array_equal(arg.compute(executor=ex), np.argsort(an, kind="stable"))
    written = {root for root, _, files in os.walk(tmp_path / "port")
               if root.endswith(".zarr") and any(not f.startswith(".") for f in files)}
    assert written == {str(arg.zarray_maybe_lazy.store)}


def test_multioutput_op_computes_every_output(tmp_path):
    """The reference checks resume of a multi-output op here (the port's
    counterpart is tests/test_torch_resume.py::test_multioutput_resume_skips_per_task);
    here both outputs of one op, each computed alone on both executors,
    equal the reference's."""
    an = np.arange(12, dtype=np.float64)
    outs = {}
    for xp, pkg, spec in ((rxp, cubed_tpu, _specs(tmp_path)[0]), (pxp, cubed_tpu_torch, _specs(tmp_path)[1])):
        a = pkg.from_array(an, chunks=(4,), spec=spec)

        def two(chunk):
            return chunk + 1.0, chunk * 2.0

        two.batchable = True

        def block_function(out_key, name=a.name):
            return ((name, *out_key[1:]),)

        outs[pkg.__name__] = pkg.core.ops.general_blockwise(
            two, block_function, a, shape=a.shape, dtype=[a.dtype, np.dtype(np.float64)], chunks=a.chunks,
            op_name="two_out")
    p, d = outs["cubed_tpu_torch"]
    for ex in (None, CudaExecutor()):
        np.testing.assert_array_equal(p.compute(executor=ex), an + 1.0)
        np.testing.assert_array_equal(d.compute(executor=ex), an * 2.0)
    assert [np.asarray(x.compute()).tolist() for x in outs["cubed_tpu"]] == [(an + 1).tolist(), (an * 2).tolist()]


def _bitonic_ops(arr):
    return [n for n in _op_names(arr) if "bitonic" in n]


def test_auto_network_coarsens_large_m(tmp_path):
    """auto rechunks the sort axis to the largest fitting merge first: 64
    small chunks must not give a 22-round network."""
    n = 65_536
    an = np.random.default_rng(11).random(n)
    srt = _parity(tmp_path, lambda xp, a: xp.sort(a), an, chunks=(1_024,), allowed_mem="2MB", expected=np.sort(an),
                  reference=False)
    assert len(_bitonic_ops(srt)) <= 4, _bitonic_ops(srt)
    arg = _parity(tmp_path, lambda xp, a: xp.argsort(a), an, chunks=(1_024,), allowed_mem="2MB",
                  expected=np.argsort(an, kind="stable"), reference=False)
    assert len(_bitonic_ops(arg)) <= 7, _bitonic_ops(arg)


def test_auto_network_shrinks_oversized_chunks(tmp_path):
    """Chunks larger than the feasible pair merge rechunk DOWN to it."""
    n = 100_000
    an = np.random.default_rng(13).random(n)
    _parity(tmp_path, lambda xp, a: xp.sort(a), an, chunks=(25_000,), allowed_mem="1MB", expected=np.sort(an),
            reference=False)
    _parity(tmp_path, lambda xp, a: xp.argsort(a), an, chunks=(25_000,), allowed_mem="1MB",
            expected=np.argsort(an, kind="stable"), reference=False)


def _skey(result):
    dag = result.plan._finalize(array_names=(result.name,)).dag
    ex = CudaExecutor()
    ops = [(n, d) for n, d in visit_nodes(dag) if ex._classify(d["primitive_op"]) == "segment"]
    keep = ex._segment_keep(ops, dag, {result.zarray_maybe_lazy.store})
    keep_list = [k for k in keep if k in ex._produced(ops)]
    return ex._structural_key(ops, dag, [], {}, keep_list, ex._hoisted_arrays(ops), torch.device("cpu"))


def test_multioutput_plan_hits_struct_cache(tmp_path, force):
    """Repeat computes of a structurally equal multi-output plan: the
    reference's second JaxExecutor compute is a struct hit. On the CPU the
    port's segments run op by op (its struct hit is a card test), so here:
    both plans have one structural key (every round described, so the
    card's second sighting captures and a third replays)."""
    an = np.random.default_rng(21).random(4096)
    jax_executor_module._STRUCT_CACHE.clear()
    rs, ps = _specs(tmp_path)
    ex1 = JaxExecutor()
    rxp.argsort(cubed_tpu.from_array(an, chunks=(512,), spec=rs)).compute(executor=ex1)
    assert ex1.stats["segments_traced"] == 1
    ex2 = JaxExecutor()
    rxp.argsort(cubed_tpu.from_array(an, chunks=(512,), spec=rs)).compute(executor=ex2)
    assert ex2.stats.get("segment_struct_hits", 0) == 1
    keys = [_skey(pxp.argsort(cubed_tpu_torch.from_array(an, chunks=(512,), spec=ps))) for _ in range(2)]
    assert keys[0] is not None and keys[0] == keys[1]
    got = pxp.argsort(cubed_tpu_torch.from_array(an, chunks=(512,), spec=ps)).compute(executor=CudaExecutor())
    np.testing.assert_array_equal(got, np.argsort(an, kind="stable"))


def test_predecessor_fuses_into_multioutput_consumer(tmp_path):
    """A single-output elemwise producer fuses INTO a multi-output consumer;
    the multi-output op never fuses away as a predecessor."""
    from cubed_tpu_torch.core.ops import elemwise, general_blockwise
    from cubed_tpu_torch.core.optimization import multiple_inputs_optimize_dag

    an = np.arange(12, dtype=np.float64)
    a = cubed_tpu_torch.from_array(an, chunks=(4,), spec=_specs(tmp_path)[1])

    def double(x):
        return x * 2.0

    doubled = elemwise(double, a, dtype=np.dtype(np.float64))

    def two(chunk):
        return chunk + 1.0, chunk - 1.0

    def block_function(out_key):
        return ((doubled.name, *out_key[1:]),)

    p, q = general_blockwise(two, block_function, doubled, shape=a.shape, dtype=[a.dtype, a.dtype],
                             chunks=a.chunks, op_name="two_out")
    dag = multiple_inputs_optimize_dag(p.plan.dag.copy())
    multi = [d["primitive_op"] for _, d in iter_op_nodes(dag) if d["primitive_op"].target_arrays is not None]
    assert len(multi) == 1
    reads = {proxy.array for proxy in multi[0].pipeline.config.reads_map.values()}
    assert a.zarray_maybe_lazy in reads
    np.testing.assert_array_equal(p.compute(), an * 2.0 + 1.0)
    np.testing.assert_array_equal(q.compute(), an * 2.0 - 1.0)


def test_multichunk_sort_matches_numpy(tmp_path, force):
    an = np.random.default_rng(2).random((13, 17))
    _parity(tmp_path, lambda xp, a: xp.sort(a, axis=0), an, chunks=(3, 4), expected=np.sort(an, axis=0))
    _parity(tmp_path, lambda xp, a: xp.sort(a, axis=1, descending=True), an, chunks=(3, 4),
            expected=np.sort(an, axis=1)[:, ::-1])


def test_multichunk_argsort_stable_with_ties(tmp_path, force):
    an = np.random.default_rng(3).integers(0, 5, 37)
    _parity(tmp_path, lambda xp, a: xp.argsort(a), an, chunks=(5,), expected=np.argsort(an, kind="stable"))
    m = len(an)
    _parity(tmp_path, lambda xp, a: xp.argsort(a, descending=True), an, chunks=(5,),
            expected=(m - 1 - np.argsort(an[::-1], kind="stable"))[::-1])


def test_multichunk_sort_nan_last(tmp_path, force):
    an = np.random.default_rng(4).random(19)
    an[[2, 7, 11]] = np.nan
    an[5] = -0.0
    an[6] = 0.0
    p = _parity(tmp_path, lambda xp, a: xp.sort(a), an, chunks=(4,), executors=False)
    np.testing.assert_array_equal(p.compute(), np.sort(an))
    _parity(tmp_path, lambda xp, a: xp.argsort(a), an, chunks=(4,), expected=np.argsort(an, kind="stable"))


def test_multichunk_sort_sentinel_collision(tmp_path, force):
    """Real int64 maxima survive the padding sentinels."""
    imax = np.iinfo(np.int64).max
    an = np.array([3, imax, 1, imax, 2] * 3, dtype=np.int64)
    _parity(tmp_path, lambda xp, a: xp.sort(a), an, chunks=(4,), expected=np.sort(an))
    _parity(tmp_path, lambda xp, a: xp.argsort(a), an, chunks=(4,), expected=np.argsort(an, kind="stable"))


def test_multichunk_sort_batched_on_the_device_executor(tmp_path, force):
    """The network stays on the batched route (uniform kernels, offsets as
    data, the partner blocks gathered): no failed check, counters as
    JaxExecutor's, and no trace failure there."""
    an = np.random.default_rng(5).random(100)
    rs, ps = _specs(tmp_path)
    _parity(tmp_path, lambda xp, a: xp.sort(a), an, chunks=(16,), expected=np.sort(an))
    ex = JaxExecutor()
    rxp.sort(cubed_tpu.from_array(an, chunks=(16,), spec=rs)).compute(executor=ex)
    assert ex.stats["trace_failures"] == 0 and ex.stats["eager_fallbacks"] == 0
    pex = CudaExecutor()
    pxp.sort(cubed_tpu_torch.from_array(an, chunks=(16,), spec=ps)).compute(executor=pex)
    assert pex.stats["batched_ops"] >= 1


def test_auto_prefers_single_chunk_when_slab_fits(tmp_path, monkeypatch):
    """Plenty of memory: a multi-chunk axis takes the one-kernel path."""
    import cubed_tpu_torch.array_api._block_sort as bs

    def boom(*a, **k):
        raise AssertionError("network used despite fitting slab")

    monkeypatch.setattr(bs, "block_sort", boom)
    monkeypatch.setattr(bs, "block_argsort", boom)
    an = np.random.default_rng(6).random(1000)
    _parity(tmp_path, lambda xp, a: xp.sort(a), an, chunks=(100,), expected=np.sort(an))
    _parity(tmp_path, lambda xp, a: xp.argsort(a), an, chunks=(100,), expected=np.argsort(an, kind="stable"))


def test_auto_network_when_reserved_mem_eats_budget(tmp_path):
    """reserved_mem counts against the slab's fit: the network, and a plan
    that succeeds."""
    n = 100_000
    an = np.random.default_rng(7).permutation(n).astype(np.float64)
    p = _parity(tmp_path, lambda xp, a: xp.sort(a), an, chunks=(12_500,), allowed_mem="8MB", reserved_mem="6MB",
                expected=np.arange(n, dtype=np.float64), reference=False)
    assert _bitonic_ops(p)


def test_auto_argsort_accounts_int64_output(tmp_path):
    """float32 argsort: the int64 output is charged, so the chosen path plans."""
    n = 100_000
    an = np.random.default_rng(8).permutation(n).astype(np.float32)
    _parity(tmp_path, lambda xp, a: xp.argsort(a), an, chunks=(12_500,), allowed_mem="2300KB",
            expected=np.argsort(an, kind="stable"), reference=False)


def test_searchsorted_partial_counts_matches_numpy(tmp_path, force):
    """Forced network: per-chunk counts summed over the tree equal the
    single-chunk search, both sides, with duplicates across chunk edges."""
    rng = np.random.default_rng(9)
    x1n = np.sort(rng.integers(0, 8, 29)).astype(np.float64)
    x2n = np.array([[0.0, 3.0, 7.0], [8.0, -1.0, 3.5]])
    for side in ("left", "right"):
        p = _parity(tmp_path, lambda xp, a, b: xp.searchsorted(a, b, side=side), x1n, x2n, chunks=[(4,), (1, 2)],
                    expected=np.searchsorted(x1n, x2n, side=side))
        assert "searchsorted_partials" in _op_names(p)


def test_searchsorted_x1_larger_than_allowed_mem(tmp_path):
    """A sorted x1 bigger than allowed_mem searches by partial counts."""
    n = 200_000  # 1.6 MB > 800 KB
    x1n = np.arange(n, dtype=np.float64)
    x2n = np.random.default_rng(10).random(500) * n
    _parity(tmp_path, lambda xp, a, b: xp.searchsorted(a, b), x1n, x2n, chunks=[(12_500,), (125,)],
            allowed_mem="800KB", expected=np.searchsorted(x1n, x2n), reference=False)


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_single_chunk_nan_and_dtypes(tmp_path, side):
    """One chunk of x1: NaN placed as numpy places it (after every number),
    -0.0 equal to 0.0, an integer x1 searched with float values."""
    x1n = np.array([-1.0, -0.0, 1.0, 2.0, 2.0, np.nan])
    x2n = np.array([np.nan, 0.0, -0.0, 2.0, 5.0, -2.0, np.inf, 1.5])
    _parity(tmp_path, lambda xp, a, b: xp.searchsorted(a, b, side=side), x1n, x2n, chunks=[(6,), (3,)],
            expected=np.searchsorted(x1n, x2n, side=side))
    i1 = np.arange(0, 40, 3, dtype=np.int32)
    _parity(tmp_path, lambda xp, a, b: xp.searchsorted(a, b, side=side), i1, x2n, chunks=[(14,), (3,)],
            expected=np.searchsorted(i1, x2n, side=side))


# -- top-k (the reference's tests/test_quantile.py) --------------------------


def test_topk_argtopk(tmp_path):
    an = np.random.default_rng(7).standard_normal((5, 40))
    _parity(tmp_path, lambda xp, a: xp.topk(a, 3, axis=1), an, chunks=(2, 10), expected=-np.sort(-an, axis=1)[:, :3])
    _parity(tmp_path, lambda xp, a: xp.topk(a, -2, axis=1), an, chunks=(2, 10), expected=np.sort(an, axis=1)[:, :2])
    gi = _parity(tmp_path, lambda xp, a: xp.argtopk(a, 3, axis=1), an, chunks=(2, 10)).compute()
    np.testing.assert_array_equal(np.take_along_axis(an, gi, axis=1), -np.sort(-an, axis=1)[:, :3])
    a = cubed_tpu_torch.from_array(an, chunks=(2, 10), spec=_specs(tmp_path)[1])
    with pytest.raises(ValueError):
        pxp.topk(a, 0)
    with pytest.raises(ValueError):
        pxp.topk(a, 99, axis=1)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int8, np.int64, np.float32])
def test_topk_argtopk_descending_integer_dtypes(tmp_path, dtype):
    """Descending top-k never negates the keys (it would wrap unsigned
    integers and INT_MIN), and pads short blocks with the dtype's own
    extremes; ties go by index, as the reference's stable order."""
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        pool = np.array([info.min, info.max, info.min + 1, info.max - 1, 0, 1, 2, 7], dtype=dt)
    else:
        pool = np.array([-3.0, -1.5, 0.0, 1.0, 2.5, 7.0, -8.0, 9.0], dtype=dt)
    an = pool[np.random.default_rng(11).integers(0, len(pool), size=(4, 24))]
    want = np.flip(np.sort(an, axis=1), axis=1)[:, :3]
    _parity(tmp_path, lambda xp, a: xp.topk(a, 3, axis=1), an, chunks=(2, 6), expected=want)
    _parity(tmp_path, lambda xp, a: xp.topk(a, -3, axis=1), an, chunks=(2, 6), expected=np.sort(an, axis=1)[:, :3])
    gi = _parity(tmp_path, lambda xp, a: xp.argtopk(a, 3, axis=1), an, chunks=(2, 6)).compute()
    np.testing.assert_array_equal(np.take_along_axis(an, gi, axis=1), want)


def test_topk_uint64_refused(tmp_path):
    """uint64 rides in int64, whose order differs past 2**63: its top-k and
    sorts are refused at plan time (the reference's case runs in JAX)."""
    an = np.array([[1, 2**63 + 5, 3, 2**64 - 1]], dtype=np.uint64)
    rs, ps = _specs(tmp_path)
    r = rxp.topk(cubed_tpu.from_array(an, chunks=(1, 2), spec=rs), 2, axis=1)
    np.testing.assert_array_equal(np.asarray(r.compute()), [[2**64 - 1, 2**63 + 5]])
    a = cubed_tpu_torch.from_array(an, chunks=(1, 2), spec=ps)
    for f in (lambda: pxp.topk(a, 2, axis=1), lambda: pxp.sort(a), lambda: pxp.argsort(a)):
        with pytest.raises(TypeError, match="uint64"):
            f()


def test_topk_short_blocks_pad_with_integer_sentinels(tmp_path):
    """Blocks shorter than k pad with the dtype's extremes; the ragged last
    block too."""
    an = np.array([[250, 255, 0, 3, 128, 2, 254, 1, 127, 129]], dtype=np.uint8)
    _parity(tmp_path, lambda xp, a: xp.topk(a, 4, axis=1), an, chunks=(1, 3),
            expected=np.flip(np.sort(an, axis=1), axis=1)[:, :4])
    _parity(tmp_path, lambda xp, a: xp.topk(a, -4, axis=1), an, chunks=(1, 3), expected=np.sort(an, axis=1)[:, :4])


def test_topk_one_pass_engine(tmp_path):
    """k << n under a tight budget: the one-pass engine's ops."""
    an = np.random.default_rng(8).standard_normal(100_000)
    t = _parity(tmp_path, lambda xp, a: xp.topk(a, 5), an, chunks=(10_000,), allowed_mem=600_000,
                expected=-np.sort(-an)[:5], reference=False)
    assert "topk_local" in _op_names(t)
    gi = _parity(tmp_path, lambda xp, a: xp.argtopk(a, 5), an, chunks=(10_000,), allowed_mem=600_000,
                 reference=False).compute()
    np.testing.assert_array_equal(an[gi], -np.sort(-an)[:5])


def test_topk_ragged(tmp_path):
    an = np.random.default_rng(9).standard_normal((3, 23))  # ragged last block
    _parity(tmp_path, lambda xp, a: xp.topk(a, 4, axis=1), an, chunks=(2, 5), expected=-np.sort(-an, axis=1)[:, :4])
    a = cubed_tpu_torch.from_array(an, chunks=(2, 5), spec=_specs(tmp_path)[1])
    with pytest.raises(IndexError):
        pxp.topk(a, 2, axis=5)


def test_topk_ties_by_index(tmp_path):
    """Equal values across blocks: argtopk returns the lowest indices first,
    as the reference's stable order (torch.topk's tie order differs)."""
    an = np.array([[5, 1, 5, 5, 2, 5, 0, 5, 5]], dtype=np.int32)
    _parity(tmp_path, lambda xp, a: xp.argtopk(a, 4, axis=1), an, chunks=(1, 2), expected=np.array([[0, 2, 3, 5]]))
    _parity(tmp_path, lambda xp, a: xp.argtopk(a, -2, axis=1), an, chunks=(1, 2), expected=np.array([[6, 1]]))


def test_hoisted_keys_of_a_permuted_seed_grid():
    """A random input fused into a network round reads its partner blocks'
    seeds, a permuted grid of the segment's key table: gathered by rows
    (uploaded once), equal to the keys drawn directly."""
    from cubed_tpu_torch.kernels.philox_uniform import HoistedKeys, philox_keys

    seeds = 2**30 - 9 + np.arange(16, dtype=np.int64)
    table = HoistedKeys(seeds, "cpu")
    table.upload()
    partners = seeds[np.arange(16) ^ 2].reshape(4, 4)
    np.testing.assert_array_equal(table.lookup(partners).numpy().view(np.uint64), philox_keys(partners.reshape(-1)))


def test_network_rounds_drop_dead_arrays_within_their_segment(tmp_path, force):
    """Each round's outputs are dropped once the next round has read them
    (as XLA frees a program's dead buffers), so an argsort network of 7
    rounds runs batched under a device_mem of a few of its arrays: no spill,
    no failed check, the reference's counters."""
    an = np.random.default_rng(12).random(1024)
    rs, ps = _specs(tmp_path)
    arg = pxp.argsort(cubed_tpu_torch.from_array(an, chunks=(128,), spec=ps))
    ex = CudaExecutor(device_mem=8 * 8 * 1024)  # eight arrays of 8 KB: the network makes 16 and the input
    np.testing.assert_array_equal(arg.compute(executor=ex), np.argsort(an, kind="stable"))
    assert {c: ex.stats[c] for c in FAILED_CHECKS} == dict.fromkeys(FAILED_CHECKS, 0)
    rex = JaxExecutor()
    rxp.argsort(cubed_tpu.from_array(an, chunks=(128,), spec=rs)).compute(executor=rex)
    assert {c: ex.stats[c] for c in PATH_COUNTERS} == {c: rex.stats.get(c, 0) for c in PATH_COUNTERS}
    written = {root for root, _, files in os.walk(tmp_path / "port")
               if root.endswith(".zarr") and any(not f.startswith(".") for f in files)}
    assert written == {str(arg.zarray_maybe_lazy.store)}  # nothing spilled

