"""Attention over cubed arrays: the bridge from the array layer to the
sequence-parallel ring. Counterpart of ``cubed_tpu/parallel/attention.py``.

Global attention needs communication across chunks of the sequence axis,
which the array layer's task model does not express, so this API sits
beside the plan machinery: the inputs are computed (storage to the device)
in one plan, attention runs as one ring over the mesh's axis
(``parallel/ring_attention.py``; dense on the chunk device with no mesh),
and the result re-enters the plan world as a cubed array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def attention(
    q,
    k,
    v,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    mesh=None,
    axis_name: str = "seq",
    chunks=None,
    spec=None,
):
    """Multi-head attention over cubed arrays of shape (B, S, H, D).

    With ``mesh``, the sequence axis is sharded over ``axis_name`` and the
    kernel is blockwise ring attention; without it, dense attention on the
    chunk device. Returns a cubed array chunked like ``q`` (override with
    ``chunks``)."""
    from ..backend_array_api import get_device
    from ..core.array import CoreArray
    from ..core.array import compute as compute_multi
    from ..core.ops import from_array
    from .ring_attention import dense_attention, ring_attention, sequence_sharded

    # all cubed inputs in ONE plan, so a shared upstream subgraph (one
    # source, three projections) computes once
    core = [x for x in (q, k, v) if isinstance(x, CoreArray)]
    computed = iter(compute_multi(*core)) if core else iter(())

    def materialize(x):
        if isinstance(x, CoreArray):
            return np.asarray(next(computed)), x
        return np.asarray(x), None

    qn, q_arr = materialize(q)
    kn, _ = materialize(k)
    vn, _ = materialize(v)
    if qn.ndim != 4:
        raise ValueError(f"attention expects (B, S, H, D) arrays, got {qn.shape}")

    if mesh is not None and axis_name not in mesh.axis_names:
        raise ValueError(
            f"axis_name {axis_name!r} is not a mesh axis {mesh.axis_names}; "
            "pass axis_name= matching your mesh (a silent dense fallback "
            "would run the whole sequence on one device)"
        )
    if mesh is not None:
        qd, kd, vd = (sequence_sharded(torch.from_numpy(x), mesh, axis_name=axis_name) for x in (qn, kn, vn))
        out = ring_attention(qd, kd, vd, mesh=mesh, axis_name=axis_name, causal=causal, scale=scale).gather()
    else:
        dev = get_device()
        out = dense_attention(*(torch.from_numpy(x).to(dev) for x in (qn, kn, vn)), causal=causal, scale=scale)

    out_np = out.detach().cpu().numpy().astype(qn.dtype)
    if chunks is None:
        chunks = q_arr.chunksize if q_arr is not None else out_np.shape
    if spec is None and q_arr is not None:
        spec = q_arr.spec
    return from_array(out_np, chunks=chunks, spec=spec)
