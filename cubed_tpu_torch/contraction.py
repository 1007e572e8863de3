"""The per-block product at the device executor's ``matmul_precision``.

Counterpart of the contraction the JAX package runs under
``jax.default_matmul_precision`` (``JaxExecutor(matmul_precision=...)``,
reference ``runtime/executors/jax.py:159-176`` and ``:346-350``): the
per-block ``jnp.matmul`` of ``matmul`` and ``tensordot``, outside any
Pallas kernel. Here the product is cuBLAS through torch, and the mode is
read from a context-local scope (:func:`precision`, a
``contextvars.ContextVar``, entered by the device executor for the whole
DAG), never from torch's process-global switches
(``torch.backends.cuda.matmul.allow_tf32``,
``torch.set_float32_matmul_precision``), which this module neither sets
nor changes.

A mode applies to a product of two float32 operands; any other product
(float64: DGEMM; integers, complex) is torch's own. On float32:

- ``None``: float32 operands, float32 sums and output, under torch's own
  settings (TF32 off unless the process turned it on);
- ``"default"``, ``"float32"``, ``"highest"``: the same, TF32 off; on the
  card a product raises if the process turned TF32 on;
- ``"tensorfloat32"``: operands rounded to TF32 (a 10-bit mantissa, to
  nearest even), float32 sums and output;
- ``"bfloat16"``: operands rounded to bf16 (to nearest even), float32 sums
  and a float32 output, never rounded to bf16;
- ``"bfloat16_3x"``: each operand split as ``hi = bf16(x)``,
  ``lo = bf16(x - hi)``; the products ``hi*hi + hi*lo + lo*hi``, float32
  sums and output.

On the card, ``"bfloat16"`` is one bf16 GEMM with a float32 output
(``torch.mm`` / ``torch.bmm`` with ``out_dtype``, on the tensor cores) and
``"bfloat16_3x"`` three of them, ``hi*lo + lo*hi`` first, then ``hi*hi``
(one product of depth 3k would sum the small terms into the large ones'
float32 rounding error; three keep it the one-pass error). torch has no per-call
route to a TF32 product, so ``"tensorfloat32"`` rounds its operands
explicitly and multiplies them in full float32 (CUDA cores): every product
of two TF32 (or bf16) values is exact in float32, so only the order of the
float32 sums differs from a tensor-core TF32 GEMM.

The reduced modes run as the custom op ``cubed_tpu_torch::matmul_at``,
with a ``torch.func.vmap`` batching rule (one batched GEMM for a bucket of
blocks, as the device executor's batched route calls it) and a fake
kernel. :func:`matmul_plain` is the same rounding followed by a float32
``torch.matmul``: the CPU route and the card's yardstick.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch

#: the reference's list of modes (JaxExecutor's ``matmul_precision``)
MODES = (None, "bfloat16", "bfloat16_3x", "tensorfloat32", "float32", "highest", "default")
#: the modes that round the operands
REDUCED = ("bfloat16", "bfloat16_3x", "tensorfloat32")

_PRECISION: contextvars.ContextVar = contextvars.ContextVar("cubed_tpu_torch_matmul_precision", default=None)


def check_mode(mode) -> None:
    if mode not in MODES:
        raise ValueError(f"matmul_precision must be one of None, 'bfloat16', 'bfloat16_3x', 'tensorfloat32', "
                         f"'float32', 'highest', 'default'; got {mode!r}")


@contextlib.contextmanager
def precision(mode: Optional[str]):
    """Within this block (this thread or task only), float32 products run at
    *mode*; the previous mode is restored on every exit."""
    check_mode(mode)
    token = _PRECISION.set(mode)
    try:
        yield
    finally:
        _PRECISION.reset(token)


def current() -> Optional[str]:
    """The mode in force."""
    return _PRECISION.get()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 *x* rounded to TF32's 10-bit mantissa, to nearest even (inf
    and nan kept)."""
    bits = x.view(torch.int32)
    r = ((bits + (0x0FFF + ((bits >> 13) & 1))) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 *x* rounded to bf16, to nearest even, held in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split_bf16(x: torch.Tensor):
    """(hi, lo) in bf16: ``hi = bf16(x)``, ``lo = bf16(x - hi)``."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


def _products(a: torch.Tensor, b: torch.Tensor, mode: str) -> list:
    """The operand pairs of the float32-accumulated products that *mode* sums,
    smallest first, in bf16 (the bf16 modes) or float32 (TF32)."""
    if mode == "tensorfloat32":
        return [(round_tf32(a), round_tf32(b))]
    if mode == "bfloat16":
        return [(a.to(torch.bfloat16), b.to(torch.bfloat16))]
    ah, al = _split_bf16(a)
    bh, bl = _split_bf16(b)
    return [(ah, bl), (al, bh), (ah, bh)]


def _sum_products(products: list, mm) -> torch.Tensor:
    """The products' sum, the small correction terms added first (so the
    largest product's float32 sums bound the error, as in one pass)."""
    out = mm(*products[0])
    for x, y in products[1:]:
        out = out + mm(x, y)
    return out


def matmul_plain(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """The plain version: the operands rounded as *mode* says, then float32
    ``torch.matmul``s."""
    return _sum_products(_products(a, b, mode), lambda x, y: torch.matmul(x.to(torch.float32), y.to(torch.float32)))


def _mm_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` of bf16 operands (broadcast batch axes) as one cuBLAS bf16
    GEMM with a float32 output."""
    m, k, n = x.shape[-2], x.shape[-1], y.shape[-1]
    if y.ndim == 2:
        out = torch.mm(x.reshape(-1, k), y, out_dtype=torch.float32)
        return out.reshape(x.shape[:-1] + (n,))
    batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    xb = x.expand(batch + (m, k)).reshape(-1, m, k)
    yb = y.expand(batch + (k, n)).reshape(-1, k, n)
    return torch.bmm(xb, yb, out_dtype=torch.float32).reshape(batch + (m, n))


@torch.library.custom_op("cubed_tpu_torch::matmul_at", mutates_args=())
def _matmul_at(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if a.device.type != "cuda":
        return matmul_plain(a, b, mode)
    if mode == "tensorfloat32":
        return torch.matmul(round_tf32(a), round_tf32(b))
    return _sum_products(_products(a, b, mode), _mm_f32)


@_matmul_at.register_fake
def _matmul_at_fake(a, b, mode):
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return a.new_empty(batch + (a.shape[-2], b.shape[-1]), dtype=torch.float32)


@torch.library.register_vmap("cubed_tpu_torch::matmul_at")
def _matmul_at_vmap(info, in_dims, a, b, mode):
    """The batching rule: each batched operand's batch axis moves to the
    front, above the operands' own batch axes, so one call (one batched
    GEMM) takes the whole bucket."""
    a_d, b_d, _ = in_dims
    if a_d is None and b_d is None:
        return _matmul_at(a, b, mode), None
    ranks = (a.ndim - (a_d is not None), b.ndim - (b_d is not None))
    top = max(ranks)

    def front(x, d, rank):
        if d is None:
            return x
        x = x.movedim(d, 0)
        return x.reshape(x.shape[:1] + (1,) * (top - rank) + x.shape[1:])

    return _matmul_at(front(a, a_d, ranks[0]), front(b, b_d, ranks[1]), mode), 0


def _check_full(x: torch.Tensor, mode: str) -> None:
    if x.device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                    or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(f"matmul_precision={mode!r} asks for full float32 products, but this process turned "
                           "TF32 on (torch.backends.cuda.matmul.allow_tf32 / set_float32_matmul_precision)")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at the mode in force (see the module docstring)."""
    mode = _PRECISION.get()
    if mode is None or a.dtype != torch.float32 or b.dtype != torch.float32:
        return torch.matmul(a, b)
    if mode not in REDUCED:
        _check_full(a, mode)
        return torch.matmul(a, b)
    x = a.unsqueeze(0) if a.ndim == 1 else a
    y = b.unsqueeze(-1) if b.ndim == 1 else b
    out = _matmul_at(x, y, mode)
    if b.ndim == 1:
        out = out.squeeze(-1)
    return out.squeeze(-2) if a.ndim == 1 else out


def tensordot(a: torch.Tensor, b: torch.Tensor, axes=2) -> torch.Tensor:
    """``tensordot`` at the mode in force: under a reduced mode the contracted
    axes are gathered into one product of two matrices (:func:`matmul`)."""
    if isinstance(axes, int):
        ax_a, ax_b = list(range(a.ndim - axes, a.ndim)), list(range(axes))
    else:
        ax_a, ax_b = [int(d) % a.ndim for d in axes[0]], [int(d) % b.ndim for d in axes[1]]
    if _PRECISION.get() not in REDUCED or a.dtype != torch.float32 or b.dtype != torch.float32:
        return torch.tensordot(a, b, dims=(ax_a, ax_b))
    free_a = [d for d in range(a.ndim) if d not in ax_a]
    free_b = [d for d in range(b.ndim) if d not in ax_b]
    k = math.prod(a.shape[d] for d in ax_a)
    x = a.permute(free_a + ax_a).reshape(-1, k)
    y = b.permute(ax_b + free_b).reshape(k, -1)
    shape = tuple(a.shape[d] for d in free_a) + tuple(b.shape[d] for d in free_b)
    return matmul(x, y).reshape(shape)
