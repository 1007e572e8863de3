"""``random.normal`` and ``random.randint`` of the port, bit for bit the JAX
package's Philox route.

Both packages key each block by ``Philox(seed=root + block offset)`` with
``root = random.getrandbits(30)``; under ``CUBED_TPU_RNG=philox`` the JAX
package draws ``rng.normal(size=...)`` and ``rng.integers(0, span,
dtype=int64)``, and the port draws the same on the host. With the stdlib
generator seeded alike the arrays are identical (compared as bits) on the
sequential executors. The scale and offset are elementwise ops that fuse in
both packages; on ``JaxExecutor`` XLA may contract a multiply and an add
into one fused multiply-add, which skips one rounding of about 1e-15 at
``mean`` 10: so ``mean``/``stddev`` values on the device executors are held
to rtol 1e-12 and atol 1e-14 (an element near zero after the offset has a
large relative error from that one rounding), and the unscaled ones
exactly. The counterparts of ``tests/test_random.py:86-115``.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu  # noqa: E402
import cubed_tpu_torch  # noqa: E402
from cubed_tpu.runtime.executors import jax as jax_executor_module  # noqa: E402
from cubed_tpu.runtime.executors.jax import JaxExecutor  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402

from ._torch_parity import FAILED_CHECKS, PATH_COUNTERS, plan_of  # noqa: E402


@pytest.fixture(autouse=True)
def philox_route(monkeypatch):
    """The reference's Philox route, for this file's tests only (every test
    file is imported by every worker, so the variable is not set at import)."""
    monkeypatch.setenv("CUBED_TPU_RNG", "philox")

CASES = {
    "normal": lambda pkg, spec: pkg.random.normal((40, 30), chunks=(10, 10), spec=spec),
    "normal_scaled": lambda pkg, spec: pkg.random.normal((50, 50), mean=10.0, stddev=3.0, chunks=(20, 20),
                                                          spec=spec),
    "normal_ragged_3d": lambda pkg, spec: pkg.random.normal((9, 10, 11), stddev=0.5, chunks=4, spec=spec),
    "randint": lambda pkg, spec: pkg.random.randint(5, 15, (30, 30), chunks=(8, 8), spec=spec),
    "randint_zero_low": lambda pkg, spec: pkg.random.randint(0, 1000, (16, 12), chunks=(4, 6), spec=spec),
    "randint_1d": lambda pkg, spec: pkg.random.randint(-3, 3, (17,), chunks=5, spec=spec),
}


def _build(pkg, tmp_path, case, seed=2024):
    random.seed(seed)
    spec = pkg.Spec(work_dir=str(tmp_path / pkg.__name__), allowed_mem="100MB", reserved_mem=0)
    return CASES[case](pkg, spec)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint64) if x.dtype == np.float64 else x


@pytest.mark.parametrize("case", sorted(CASES))
def test_bit_identical_to_the_jax_package(tmp_path, case):
    r, p = _build(cubed_tpu, tmp_path, case), _build(cubed_tpu_torch, tmp_path, case)
    assert plan_of(p) == plan_of(r)
    ref = np.asarray(r.compute())
    got = p.compute()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_executor_agrees_with_the_jax_executor(tmp_path, case):
    r, p = _build(cubed_tpu, tmp_path, case), _build(cubed_tpu_torch, tmp_path, case)
    # the reference's compiled-program caches, both: its segment cache is
    # keyed by the lowered HLO's text, where a large constant (host draws
    # embedded in the program) is elided, so an earlier program of the same
    # shape in this process would be replayed with its own draws
    jax_executor_module._STRUCT_CACHE.clear()
    jax_executor_module._SEGMENT_CACHE.clear()
    rex, pex = JaxExecutor(), CudaExecutor()
    ref = np.asarray(r.compute(executor=rex))
    got = p.compute(executor=pex)
    if "scaled" in case or "3d" in case:
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(_bits(got), _bits(p.compute()))  # both executors of the port
    assert {c: pex.stats[c] for c in PATH_COUNTERS} == {c: rex.stats.get(c, 0) for c in PATH_COUNTERS}
    assert {c: pex.stats[c] for c in FAILED_CHECKS} == dict.fromkeys(FAILED_CHECKS, 0)


def test_blocks_follow_numpys_philox_streams(tmp_path):
    random.seed(7)
    root = random.getrandbits(30)
    random.seed(7)
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    n = cubed_tpu_torch.random.normal((6, 10), chunks=(3, 4), spec=spec).compute()
    # block (1, 2): linear offset 1 * 3 + 2 = 5, shape (3, 2) (ragged)
    np.testing.assert_array_equal(n[3:6, 8:10], np.random.Generator(np.random.Philox(seed=root + 5)).normal(
        size=(3, 2)))
    random.seed(7)
    i = cubed_tpu_torch.random.randint(-4, 9, (6, 10), chunks=(3, 4), spec=spec).compute()
    want = np.random.Generator(np.random.Philox(seed=root + 5)).integers(0, 13, size=(3, 2), dtype=np.int64) - 4
    np.testing.assert_array_equal(i[3:6, 8:10], want)


def test_normal(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.random.normal((40, 30), chunks=(10, 10), spec=spec)
    x = a.compute()
    assert x.shape == (40, 30) and x.dtype == np.float64
    assert abs(x.mean()) < 0.2 and abs(x.std() - 1.0) < 0.2
    np.testing.assert_array_equal(x, a.compute())  # per-block determinism


def test_normal_mean_stddev(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    x = cubed_tpu_torch.random.normal((50, 50), mean=10.0, stddev=3.0, chunks=(20, 20), spec=spec).compute()
    assert abs(x.mean() - 10.0) < 0.5 and abs(x.std() - 3.0) < 0.5


def test_randint(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.random.randint(5, 15, (30, 30), chunks=(8, 8), spec=spec)
    x = a.compute()
    assert x.dtype == np.int64
    assert x.min() >= 5 and x.max() < 15
    assert len(np.unique(x)) == 10
    np.testing.assert_array_equal(x, a.compute())


@pytest.mark.parametrize("call", [
    lambda spec: cubed_tpu_torch.random.randint(5, 5, (4,), chunks=(2,), spec=spec),
    lambda spec: cubed_tpu_torch.random.normal((4,), stddev=-1.0, chunks=(2,), spec=spec),
], ids=["randint_empty_range", "normal_negative_stddev"])
def test_validation(tmp_path, call):
    with pytest.raises(ValueError):
        call(cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB"))


def test_batching_rule_draws_a_bucket_in_one_call():
    """Under torch.func.vmap the host draw takes a bucket's seeds at once."""
    from cubed_tpu_torch.random import _normal_block

    like = torch.empty((3, 4), dtype=torch.float64)
    seeds = torch.tensor([11, 12, 13], dtype=torch.int64).reshape(3, 1, 1)
    out = torch.func.vmap(_normal_block, in_dims=(None, 0))(like, seeds)
    assert out.shape == (3, 3, 4)
    for b, seed in enumerate((11, 12, 13)):
        np.testing.assert_array_equal(out[b].numpy(), np.random.Generator(np.random.Philox(seed=seed)).normal(
            size=(3, 4)))


def test_whole_array_form_matches_the_blocks():
    from cubed_tpu_torch.random import _randint_kernel

    block = _randint_kernel(7)
    whole = block.batched((5, 6), (2, 4), 100, torch.device("cpu"))
    assert whole.dtype == torch.int64
    np.testing.assert_array_equal(whole[2:4, 4:6].numpy(), np.random.Generator(np.random.Philox(seed=100 + 3))
                                  .integers(0, 7, size=(2, 2), dtype=np.int64))
    assert block.host_draws and block.batchable


def test_float32_chunks_take_the_float64_draw_rounded(tmp_path):
    """Under compute_dtype="float32" a block is the float64 draw rounded, as
    the reference's Philox route casts it."""
    random.seed(3)
    root = random.getrandbits(30)
    random.seed(3)
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    got = cubed_tpu_torch.random.normal((4, 6), chunks=(4, 3), spec=spec).compute(
        executor=CudaExecutor(compute_dtype="float32"))
    want = np.random.Generator(np.random.Philox(seed=root)).normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_array_equal(got[:, :3], want.astype(np.float64))
