"""Ring attention: exact attention with the sequence dimension sharded over a
mesh axis. Counterpart of ``cubed_tpu/parallel/ring_attention.py``.

Each slot of the ring holds one block of Q/K/V; the K/V blocks rotate round
the ring while a flash-style online softmax accumulates, so no slot ever
holds the full (S, S) score matrix or the full K/V. One step of a slot is
the hand kernel ``kernels/flash_block.py`` (its plain torch version on the
CPU), which updates the slot's running maximum ``m``, denominator ``l`` and
unnormalized output ``o`` in place. The rotation is a peer copy between
distinct devices and a rebinding between slots on one device. The epilogue,
``o / l`` with ``l == 0 -> 1``, is plain torch.

The ring is differentiable: a ``torch.autograd.Function`` whose forward is
the kernel's ring and whose backward recomputes each (query block, key
block) pair's probabilities from the saved ``m`` and ``l`` in torch
operations (the flash-attention backward). The JAX package's gradient is
autodiff of the same einsums; it has no kernel behind it either.

Public functions keep the reference's ``(B, S, H, D)`` layout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_block import flash_block, step_scores
from .mesh import Mesh, Placement, ShardedTensor, place, ring_sharded, slots


def dense_attention(q, k, v, *, causal: bool = False, scale: Optional[float] = None):
    """Single-device attention on ``(B, S, H, D)`` tensors, the oracle."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        qi = torch.arange(s_q, device=scores.device)[:, None]
        ki = torch.arange(s_k, device=scores.device)[None, :]
        scores = torch.where(qi >= ki, scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


#: the step's input dtypes the kernel takes; other blocks are narrowed to
#: float32 first (the reference's body computes every step in float32)
_STEP_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def _ring_forward(qs, ks, vs, devices, causal: bool, scale: float):
    """The ring over slots: per slot the float32 ``(o / l)`` (B, H, S, D),
    ``l`` and ``m`` after every block has passed."""
    n = len(qs)
    B, S, H, D = qs[0].shape
    acc = []
    for i in range(n):
        dev = qs[i].device
        acc.append((torch.zeros((B, H, S, D), dtype=torch.float32, device=dev),
                    torch.zeros((B, H, S), dtype=torch.float32, device=dev),
                    torch.full((B, H, S), -torch.inf, dtype=torch.float32, device=dev)))
    held = list(zip(ks, vs))
    for step in range(n):
        for i in range(n):
            src = (i - step) % n
            k_blk, v_blk = held[i]
            o, l, m = acc[i]
            flash_block(qs[i], k_blk, v_blk, o, l, m, q_offset=i * S, k_offset=src * S, causal=causal, scale=scale)
        if step + 1 < n:
            # pass each slot's block to the next slot of the ring
            held = [_to(held[(i - 1) % n], devices[i]) for i in range(n)]
    outs = []
    for o, l, m in acc:
        outs.append(o / torch.where(l == 0.0, 1.0, l)[..., None])
    return outs, [a[1] for a in acc], [a[2] for a in acc]


def _to(pair, device):
    """A K/V pair on *device*: a peer copy between distinct devices, the same
    tensors on one device."""
    return tuple(t if t.device == device else t.to(device) for t in pair)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, causal, scale, devices, *tensors):
        qs, ks, vs = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        outs, ls, ms = _ring_forward(qs, ks, vs, devices, causal, scale)
        ctx.n, ctx.causal, ctx.scale = n, causal, scale
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *ls, *ms)
        return tuple(o.transpose(1, 2).contiguous().to(qs[0].dtype) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        n, causal, scale = ctx.n, ctx.causal, ctx.scale
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, ls, ms = saved[3 * n:4 * n], saved[4 * n:5 * n], saved[5 * n:]
        S = qs[0].shape[1]
        f32 = torch.float32
        dq = [torch.zeros(q.shape, dtype=f32, device=q.device) for q in qs]
        dk = [torch.zeros(k.shape, dtype=f32, device=k.device) for k in ks]
        dv = [torch.zeros(v.shape, dtype=f32, device=v.device) for v in vs]
        for i in range(n):
            dev = qs[i].device
            do = torch.zeros_like(dq[i]) if grads[i] is None else grads[i].to(f32)
            delta = torch.einsum("bqhd,bhqd->bhq", do, outs[i])
            safe_m = torch.where(torch.isneginf(ms[i]), 0.0, ms[i])
            l_safe = torch.where(ls[i] == 0.0, 1.0, ls[i])
            q32 = qs[i].to(f32)
            for j in range(n):
                if causal and i * S + S - 1 < j * S:
                    continue  # every key of block j is hidden from block i
                k_j, v_j = _to((ks[j], vs[j]), dev)
                scores, mask = step_scores(qs[i], k_j, q_offset=i * S, k_offset=j * S, causal=causal, scale=scale)
                p = torch.exp(scores - safe_m[..., None]) / l_safe[..., None]
                if mask is not None:
                    p = torch.where(mask, p, 0.0)
                dv_j = torch.einsum("bhqk,bqhd->bkhd", p, do)
                dp = torch.einsum("bqhd,bkhd->bhqk", do, v_j.to(f32))
                ds = p * (dp - delta[..., None])
                dq[i] += torch.einsum("bhqk,bkhd->bqhd", ds, k_j.to(f32)) * scale
                dk_j = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
                dk[j] += dk_j.to(dk[j].device)
                dv[j] += dv_j.to(dv[j].device)
        return (None, None, None, None, *(g.to(q.dtype) for g, q in zip(dq, qs)),
                *(g.to(k.dtype) for g, k in zip(dk, ks)), *(g.to(v.dtype) for g, v in zip(dv, vs)))


def _slot_blocks(x, mesh: Mesh, axis_name: str, devices: list) -> list:
    """The ring slots' blocks of *x* along dim 1: a sequence-sharded
    :class:`ShardedTensor`'s own shards, else *x* split and placed."""
    n = len(devices)
    if isinstance(x, ShardedTensor) and x.mesh is mesh and x.placement.spec[1:2] == (axis_name,):
        a = mesh.axis_names.index(axis_name)
        by_pos = {}
        for s, slot in zip(x.shards, slots(mesh)):
            if all(p == 0 for d, p in enumerate(slot) if d != a):
                by_pos[slot[a]] = s
        return [by_pos[i] for i in range(n)]
    if isinstance(x, ShardedTensor):
        x = x.gather()
    x = torch.as_tensor(x)
    if x.ndim != 4:
        raise ValueError(f"ring attention takes (B, S, H, D) arrays, got {tuple(x.shape)}")
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} is not divisible by the ring's {n} slots")
    return [blk.to(dev) for blk, dev in zip(torch.chunk(x, n, dim=1), devices)]


def ring_attention(q, k, v, *, mesh: Optional[Mesh] = None, axis_name: str = "seq", causal: bool = False,
                   scale: Optional[float] = None):
    """Exact attention with the sequence dimension sharded over *axis_name*.

    q, k, v: (batch, seq, heads, head_dim) tensors or sequence-sharded
    :class:`ShardedTensor` s, seq divisible by the axis's size. With
    ``mesh=None``, dense single-device attention (the ring of one). The
    result is sharded like the inputs (seq over *axis_name*, a
    :class:`ShardedTensor`). Differentiable with respect to q, k and v."""
    if mesh is None:
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        return dense_attention(q, k, v, causal=causal, scale=scale)
    devices = mesh.axis_devices(axis_name)
    n = len(devices)
    blocks = [_slot_blocks(x, mesh, axis_name, devices) for x in (q, k, v)]
    out_dtype = blocks[0][0].dtype
    if scale is None:
        scale = 1.0 / math.sqrt(blocks[0][0].shape[-1])
    if out_dtype not in _STEP_DTYPES:
        # the reference's body computes every step in float32
        blocks = [[b.to(torch.float32) for b in bs] for bs in blocks]
    outs = _RingAttention.apply(n, bool(causal), float(scale), devices, *blocks[0], *blocks[1], *blocks[2])
    B, S_l, H, D = outs[0].shape
    return ring_sharded(mesh, axis_name, 1, (B, S_l * n, H, D), [o.to(out_dtype) for o in outs])


def sequence_sharded(x, mesh: Mesh, axis_name: str = "seq", dim: int = 1) -> ShardedTensor:
    """Place *x* with dimension *dim* sharded over a mesh axis."""
    x = torch.as_tensor(x)
    spec = [None] * x.ndim
    spec[dim] = axis_name
    return place(x, Placement(mesh, tuple(spec)))
