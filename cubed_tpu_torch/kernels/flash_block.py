"""One step of ring attention's online softmax, in place (:func:`flash_block`).

Replaces the per-device body of the JAX package's ring attention,
``cubed_tpu/parallel/ring_attention.py:_ring_attention_local`` (:51; the
loop body :75-108), a JAX program with no Pallas kernel behind it: at ring
step ``s`` the slot of index ``i`` holds the K/V block of slot ``(i - s) % n``
and folds its scores into the running maximum ``m``, denominator ``l`` and
unnormalized output ``o``. The JAX body returns new arrays; :func:`flash_block`
**overwrites** ``o``, ``l`` and ``m``. The ring's epilogue, ``o / l`` with
``l == 0 -> 1`` (:115-117), is plain torch in ``parallel/ring_attention.py``.

``csrc/flash_block.cu``: one CTA per (batch, head, 64-query tile), looping
over 64-key tiles of the block staged in shared memory, the online softmax
in registers, FP32 on the CUDA cores; key tiles the causal mask hides are
skipped. Positions are global (``q_offset + row`` against ``k_offset +
column``), so causal rings work. Head dimensions up to 256.

Bound on the H100: FP32 arithmetic, ``4 * B * H * S_q * S_k * D`` operations
a step (two products; 137 GFLOP at S_q = S_k = 4096, H = 16, D = 128) at 67
TFLOP/s, 2.05 ms; a later redesign would move both products to ``wgmma``
with TMA loads, against the TF32 tensor-core rate.

:func:`flash_block_plain` is the JAX body's arithmetic in torch; the wrapper
uses it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: dtypes of q, k and v the kernel takes, with the code its C entry point expects
DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: the head dimension is padded to the first of these that holds it
HEAD_DIMS = (64, 128, 256)


def _check(q, k, v, o, l, m) -> None:
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v, o, l, m)):
        raise TypeError("flash_block takes six tensors")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_block takes (B, S, H, D) q, k and v, not {[tuple(t.shape) for t in (q, k, v)]}")
    B, S_q, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"flash_block: k {tuple(k.shape)} and v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if tuple(o.shape) != (B, H, S_q, D) or tuple(l.shape) != (B, H, S_q) or tuple(m.shape) != (B, H, S_q):
        raise ValueError(f"flash_block: o {tuple(o.shape)}, l {tuple(l.shape)}, m {tuple(m.shape)} are not "
                         f"(B, H, S_q, D) and (B, H, S_q) of q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not q.dtype.is_floating_point:
        raise TypeError(f"flash_block takes q, k and v of one float dtype, not {[q.dtype, k.dtype, v.dtype]}")
    if any(t.dtype != torch.float32 for t in (o, l, m)):
        raise TypeError("flash_block's accumulators o, l and m are float32")
    if len({t.device for t in (q, k, v, o, l, m)}) != 1:
        raise ValueError("flash_block takes tensors on one device")


def flash_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, l: torch.Tensor,
                m: torch.Tensor, *, q_offset: int, k_offset: int, causal: bool, scale: float) -> None:
    """Fold the block ``(k, v)`` into ``(o, l, m)`` for the queries ``q``, in
    place. q (B, S_q, H, D) and k, v (B, S_k, H, D) of one float dtype, any
    strides with the head dimension contiguous; o (B, H, S_q, D), l and m
    (B, H, S_q), float32 and contiguous. ``q_offset`` and ``k_offset`` are
    the blocks' first global positions (the causal mask keeps ``q_pos >=
    k_pos``). A CUDA tensor goes to the kernel, one launch; a CPU tensor to
    the plain version."""
    _check(q, k, v, o, l, m)
    if q.device.type == "cpu":
        flash_block_plain(q, k, v, o, l, m, q_offset=q_offset, k_offset=k_offset, causal=causal, scale=scale)
        return
    if q.device.type != "cuda":
        raise ValueError(f"flash_block: unsupported device {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_block's kernel takes {sorted(str(d) for d in DTYPES)}, not {q.dtype}")
    B, S_q, H, D = q.shape
    dp = next((n for n in HEAD_DIMS if D <= n), None)
    if dp is None:
        raise ValueError(f"flash_block: head dimension {D} is over {HEAD_DIMS[-1]}")
    if any(t.stride(3) != 1 for t in (q, k, v)) and D > 1:
        raise ValueError("flash_block: the head dimension of q, k and v must be contiguous")
    if not all(t.is_contiguous() for t in (o, l, m)):
        raise ValueError("flash_block: o, l and m must be contiguous")
    if B * H * S_q == 0 or k.shape[1] == 0:
        return
    params = (ctypes.c_longlong * 16)(
        B, H, S_q, k.shape[1], D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(q_offset), int(k_offset))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(
            ctypes.c_int(DTYPES[q.dtype]), ctypes.c_int(dp),
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o, l, m)),
            params, ctypes.c_float(scale), ctypes.c_int(1 if causal else 0), ctypes.c_void_p(stream),
        )
    _build.check(err, "flash_block")
    with _build.COUNT_LOCK:
        flash_block.launches += 1
        flash_block.paths["causal" if causal else "full"] += 1


#: launches of the CUDA kernel (the plain version does not count)
flash_block.launches = 0
#: launches by mask: "causal" or "full"
flash_block.paths = dict.fromkeys(("causal", "full"), 0)


_build.COUNTED.append(flash_block)


@functools.cache
def _kernel():
    fn = _build.load("flash_block").flash_block
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, *([ctypes.c_void_p] * 6),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def step_scores(q: torch.Tensor, k: torch.Tensor, *, q_offset: int, k_offset: int, causal: bool,
                scale: float) -> tuple:
    """The step's float32 scores ``(B, H, S_q, S_k)``, ``-inf`` where the
    causal mask hides a key, and that mask (None when not causal)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    if not causal:
        return scores, None
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
    mask = q_pos[:, None] >= k_pos[None, :]
    return torch.where(mask, scores, -torch.inf), mask


def flash_block_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, l: torch.Tensor,
                      m: torch.Tensor, *, q_offset: int, k_offset: int, causal: bool, scale: float) -> None:
    """The plain version: the JAX body's arithmetic over the whole block, in
    torch, written into ``o``, ``l`` and ``m``."""
    scores, mask = step_scores(q, k, q_offset=q_offset, k_offset=k_offset, causal=causal, scale=scale)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(scores - safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe))
    l.copy_(l * corr + p.sum(dim=-1))
    o.copy_(o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.to(torch.float32)))
    m.copy_(m_new)
