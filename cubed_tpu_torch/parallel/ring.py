"""Ring-pipelined sharded contractions over the device mesh. Counterpart of
``cubed_tpu/parallel/ring.py``.

:func:`ring_matmul` is Cannon's algorithm: A sharded by rows, B by the
contraction dim; at step t the slot of index i multiplies its A-column slab
of shard ``(i + t) % p`` against the B shard it holds, then hands that shard
to the previous slot, so no slot ever holds B whole. :func:`ring_reduction`
rides per-slot partials round the ring until every slot holds the total.
Each slot's product is ``torch.matmul`` (the reference's is ``jnp.dot``,
outside any kernel); a rotation is a peer copy between distinct devices and
a rebinding between slots on one device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .mesh import Mesh, ShardedTensor, make_mesh, ring_sharded


def _whole(x) -> torch.Tensor:
    return x.gather() if isinstance(x, ShardedTensor) else torch.as_tensor(x)


def _on(t: torch.Tensor, device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def ring_matmul(a, b, mesh: Optional[Mesh] = None, axis_name: str = "data") -> ShardedTensor:
    """Sharded ``a @ b`` by a ring over *mesh*'s *axis_name*: a (M, K)
    sharded on M, b (K, N) on K; the result (M, N) sharded on M."""
    if mesh is None:
        mesh = make_mesh()
    devices = mesh.axis_devices(axis_name)
    p = len(devices)
    a, b = _whole(a), _whole(b)
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if K % p != 0 or M % p != 0:
        raise ValueError(f"M={M} and K={K} must be divisible by mesh size {p}")
    mp, kp = M // p, K // p
    a_loc = [_on(a[i * mp:(i + 1) * mp], dev) for i, dev in enumerate(devices)]
    b_cur = [_on(b[i * kp:(i + 1) * kp], dev) for i, dev in enumerate(devices)]
    dtype = torch.result_type(a, b)
    acc = [torch.zeros((mp, N), dtype=dtype, device=dev) for dev in devices]
    for t in range(p):
        for i in range(p):
            shard = (i + t) % p
            acc[i] = acc[i] + a_loc[i][:, shard * kp:(shard + 1) * kp] @ b_cur[i]
        # each slot's B shard to the previous slot of the ring
        b_cur = [_on(b_cur[(j + 1) % p], devices[j]) for j in range(p)]
    return ring_sharded(mesh, axis_name, 0, (M, N), acc)


def ring_reduction(x, combine: Callable, mesh: Optional[Mesh] = None, axis_name: str = "data") -> ShardedTensor:
    """Ring all-reduce of per-slot partials: ``combine`` reduces a slot's
    shard of *x* (split on dim 0) to a partial; partials ride the ring,
    accumulating, until every slot holds the global result (one entry a slot
    for a scalar partial)."""
    if mesh is None:
        mesh = make_mesh()
    devices = mesh.axis_devices(axis_name)
    p = len(devices)
    x = _whole(x)
    if x.shape[0] % p:
        raise ValueError(f"dim 0 of {tuple(x.shape)} must be divisible by mesh size {p}")
    n = x.shape[0] // p
    partials = [combine(_on(x[i * n:(i + 1) * n], dev)) for i, dev in enumerate(devices)]
    acc, incoming = list(partials), list(partials)
    for _ in range(p - 1):
        incoming = [_on(incoming[(j - 1) % p], devices[j]) for j in range(p)]
        acc = [acc[j] + incoming[j] for j in range(p)]
    outs = [t[None] if t.ndim == 0 else t for t in acc]
    return ring_sharded(mesh, axis_name, 0, (p * outs[0].shape[0],) + tuple(outs[0].shape[1:]), outs)
