"""The port's ``einsum`` against the JAX package's on the CPU: the same
numpy inputs, the same plans (tasks, ops, projected memory), values on the
port's sequential executor and on ``CudaExecutor`` (chunks on the CPU), and
``CudaExecutor``'s path counters equal to ``JaxExecutor``'s, every failed
check 0 (``tests/_torch_parity.py``).

Tolerances: float64 rtol 1e-12 (a contraction sums in another order);
float32 rtol 1e-5; integers exact. Counterparts of ``tests/test_einsum.py``
(its ten subscript cases, the JAX executor's, the contraction larger than
memory, the refusals, the block dtype and the label mismatch), with the
block contraction's product route (``contraction.einsum_by_products``: the
card's route for integers and for float32 under a reduced
``matmul_precision``) held to numpy's einsum exactly.
"""

import os

os.environ["CUBED_TPU_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import cubed_tpu_torch  # noqa: E402
import cubed_tpu_torch.array_api as pxp  # noqa: E402
from cubed_tpu_torch import contraction  # noqa: E402
from cubed_tpu_torch.runtime.executors.cuda import CudaExecutor  # noqa: E402

from ._torch_parity import parity  # noqa: E402

RTOL = 1e-12
RTOL_F32 = 1e-5

CASES = [
    ("ij,jk->ik", [(20, 12), (12, 8)], [(5, 4), (4, 4)]),
    ("ij,jk", [(6, 5), (5, 7)], [(3, 5), (5, 7)]),
    ("bij,bjk->bik", [(3, 6, 5), (3, 5, 4)], [(1, 3, 5), (1, 5, 2)]),
    ("i,i->", [(24,), (24,)], [(6,), (8,)]),
    ("ij,ij->ij", [(6, 4), (6, 4)], [(3, 2), (2, 4)]),
    ("i,j->ij", [(5,), (7,)], [(2,), (3,)]),
    ("abc,cd,be->ade", [(3, 4, 5), (5, 6), (4, 2)], [(1, 2, 5), (5, 3), (2, 2)]),
    ("ijk->ki", [(3, 4, 5)], [(1, 2, 5)]),
    ("ij->", [(5, 6)], [(2, 3)]),
    ("ij,kj->ik", [(4, 6), (5, 6)], [(2, 3), (5, 2)]),
]


def _einsum(subscripts, **kw):
    return lambda xp, pkg, *arrays: xp.einsum(subscripts, *arrays, **kw)


@pytest.mark.parametrize("subscripts, shapes, chunks", CASES, ids=[c[0] for c in CASES])
def test_einsum_matches_the_reference(tmp_path, subscripts, shapes, chunks):
    rng = np.random.default_rng(0)
    data = [rng.standard_normal(s) for s in shapes]
    got, _ = parity(tmp_path, _einsum(subscripts), *data, chunks=chunks, rtol=RTOL)
    np.testing.assert_allclose(got, np.einsum(subscripts, *data), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("subscripts, shapes, chunks", [CASES[0], CASES[6]], ids=["ij,jk->ik", "abc,cd,be->ade"])
def test_integer_einsum_is_exact(tmp_path, subscripts, shapes, chunks):
    rng = np.random.default_rng(1)
    data = [rng.integers(-1000, 1000, s) for s in shapes]
    got, _ = parity(tmp_path, _einsum(subscripts), *data, chunks=chunks, rtol=0)
    np.testing.assert_array_equal(got, np.einsum(subscripts, *data))


def test_float32_einsum(tmp_path):
    rng = np.random.default_rng(2)
    data = [rng.standard_normal(s).astype(np.float32) for s in ((16, 12), (12, 10))]
    parity(tmp_path, _einsum("ij,jk->ik"), *data, chunks=[(4, 4), (4, 5)], rtol=RTOL_F32)


def test_einsum_contraction_larger_than_memory(tmp_path):
    """The contracted axis spans many chunks; every task holds only blocks."""
    rng = np.random.default_rng(2)
    an, bn = rng.standard_normal((8, 4000)), rng.standard_normal((4000, 8))
    got, _ = parity(tmp_path, _einsum("ij,jk->ik"), an, bn, chunks=[(8, 250), (250, 8)], rtol=RTOL,
                    allowed_mem=300_000)
    np.testing.assert_allclose(got, an @ bn, rtol=1e-10)


def test_einsum_dtype_applies_to_the_block_contraction(tmp_path):
    """int32 products would overflow per block without the cast to the
    requested dtype."""
    an = np.full((4, 64), 100_000_000, dtype=np.int32)
    bn = np.full((64, 4), 1, dtype=np.int32)
    got, _ = parity(tmp_path, _einsum("ij,jk->ik", dtype=np.float64), an, bn, chunks=[(4, 16), (16, 4)],
                    rtol=RTOL)
    np.testing.assert_allclose(got, np.einsum("ij,jk->ik", an, bn, dtype=np.float64))


def test_einsum_validation(tmp_path):
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(np.ones((3, 3)), chunks=(3, 3), spec=spec)
    with pytest.raises(NotImplementedError, match="ellipsis"):
        pxp.einsum("...i,i->...", a, a)
    with pytest.raises(NotImplementedError, match="repeated"):
        pxp.einsum("ii->i", a)
    with pytest.raises(ValueError, match="operand"):
        pxp.einsum("ij,jk->ik", a)
    with pytest.raises(ValueError, match="dimensions"):
        pxp.einsum("ijk->k", a)
    bi = cubed_tpu_torch.from_array(np.ones((3, 3), dtype=bool), chunks=(3, 3), spec=spec)
    with pytest.raises(TypeError):
        pxp.einsum("ij,jk->ik", bi, bi)
    b = cubed_tpu_torch.from_array(np.ones((4, 2)), chunks=(4, 2), spec=spec)
    with pytest.raises(ValueError, match="label 'j'"):
        pxp.einsum("ij,jk->ik", cubed_tpu_torch.from_array(np.ones((2, 3)), chunks=(2, 3), spec=spec), b)


@pytest.mark.parametrize("subscripts, shapes, chunks", CASES, ids=[c[0] for c in CASES])
def test_the_product_route_equals_numpy_exactly_on_integers(subscripts, shapes, chunks):
    """The card's integer route, run here on the CPU: pairwise products by
    permute, reshape and matmul, wrapping as numpy's int64 does."""
    from cubed_tpu_torch.array_api.einsum_functions import _parse

    rng = np.random.default_rng(3)
    data = [rng.integers(-2**40, 2**40, s) for s in shapes]
    in_labels, out_labels, _ = _parse(subscripts, len(data))
    explicit = ",".join(in_labels) + "->" + out_labels
    got = contraction.einsum_by_products(explicit, *[torch.from_numpy(d) for d in data])
    np.testing.assert_array_equal(got.numpy(), np.einsum(explicit, *data))


@pytest.mark.parametrize("mode", ["bfloat16", "bfloat16_3x", "tensorfloat32"])
def test_a_float32_block_rounds_as_matmul_does(mode):
    """Under a reduced mode a float32 block contraction is
    ``contraction.matmul``'s: the operands rounded as the mode says, float32
    sums."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((6, 9)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((9, 5)).astype(np.float32))
    with contraction.precision(mode):
        got = contraction.einsum("ij,jk->ik", a, b)
    want = contraction.matmul_plain(a, b, mode)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL_F32, atol=1e-6)
    assert not np.array_equal(got.numpy(), (a @ b).numpy())


@pytest.mark.parametrize("mode", ["bfloat16", "tensorfloat32"])
def test_float32_einsum_plan_under_a_precision_mode(tmp_path, mode):
    """A float32 einsum plan on ``CudaExecutor(matmul_precision=...)`` equals
    the same plan's matmul under the mode (both products are the mode's
    rounding and float32 sums)."""
    rng = np.random.default_rng(5)
    an = rng.standard_normal((16, 12)).astype(np.float32)
    bn = rng.standard_normal((12, 10)).astype(np.float32)
    spec = cubed_tpu_torch.Spec(work_dir=str(tmp_path), allowed_mem="100MB")
    a = cubed_tpu_torch.from_array(an, chunks=(4, 4), spec=spec)
    b = cubed_tpu_torch.from_array(bn, chunks=(4, 5), spec=spec)
    ex = CudaExecutor(matmul_precision=mode)
    got = np.asarray(pxp.einsum("ij,jk->ik", a, b).compute(executor=ex))
    want = np.asarray(pxp.matmul(a, b).compute(executor=CudaExecutor(matmul_precision=mode)))
    np.testing.assert_allclose(got, want, rtol=RTOL_F32, atol=1e-6)
    assert ex.stats["eager_fallbacks"] == 0


@pytest.mark.parametrize("sa, sb", [((50, 50), (50, 50)), ((1, 1000), (1000, 1)), ((3, 7, 5), (5, 4)), ((6,), (6,)),
                                    ((4, 6), (6,)), ((16,), (16, 3))])
def test_integer_matmul_is_exact_for_every_rank(sa, sb):
    """The card's exact integer product (run here on the CPU), 1-D operands
    included, wrapping as numpy's int64 does; its panels' products hold at
    most the larger of the output and the two operands."""
    rng = np.random.default_rng(6)
    a, b = rng.integers(-2**40, 2**40, sa), rng.integers(-2**40, 2**40, sb)
    np.testing.assert_array_equal(contraction.integer_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(), a @ b)
