"""Ring attention in the port (``cubed_tpu_torch/parallel/ring_attention.py``)
on an 8-slot CPU mesh, held against the JAX package's on its 8 virtual CPU
devices and against the dense oracle, and the kernel module's plain step
(``kernels/flash_block.py``) against the JAX body it replaces. Counterpart
of tests/parallel/test_ring_attention.py. Tolerances: the reference's own,
2e-5 on values and 2e-4 on gradients (float32 sums in another order)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubed_tpu.parallel import mesh as ref_mesh
from cubed_tpu.parallel import ring_attention as ref_ra
from cubed_tpu_torch.kernels import flash_block as fb
from cubed_tpu_torch.parallel.mesh import make_mesh
from cubed_tpu_torch.parallel.ring_attention import dense_attention, ring_attention, sequence_sharded


def _meshes(n):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"the JAX package's side needs {n} virtual CPU devices")
    return (make_mesh(shape=(n,), axis_names=("seq",), devices=[torch.device("cpu")] * n),
            ref_mesh.make_mesh(shape=(n,), axis_names=("seq",), devices=devs[:n]))


def _qkv(B=2, S=64, H=2, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3)]


def _ref_ring(qkv, mesh, causal):
    return np.asarray(ref_ra.ring_attention(*(ref_ra.sequence_sharded(jnp.asarray(x), mesh) for x in qkv),
                                            mesh=mesh, causal=causal))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_dense(causal):
    mesh, ref = _meshes(8)
    qn, kn, vn = _qkv()
    q, k, v = (torch.from_numpy(x) for x in (qn, kn, vn))
    expect = dense_attention(q, k, v, causal=causal)
    out = ring_attention(*(sequence_sharded(x, mesh) for x in (q, k, v)), mesh=mesh, causal=causal)
    np.testing.assert_allclose(np.asarray(out), expect.numpy(), atol=2e-5)
    np.testing.assert_allclose(np.asarray(out), _ref_ring((qn, kn, vn), ref, causal), atol=2e-5)
    np.testing.assert_allclose(expect.numpy(), np.asarray(ref_ra.dense_attention(qn, kn, vn, causal=causal)),
                               atol=2e-5)


def test_ring_no_mesh_is_dense():
    q, k, v = (torch.from_numpy(x) for x in _qkv(S=16))
    np.testing.assert_allclose(ring_attention(q, k, v, causal=True).numpy(),
                               dense_attention(q, k, v, causal=True).numpy(), atol=1e-6)


def _grads(qkv, loss):
    ts = [torch.from_numpy(x).requires_grad_() for x in qkv]
    loss(*ts).backward()
    return [t.grad.numpy() for t in ts]


def test_ring_gradients_flow():
    """The backward recomputes each pair's probabilities from the saved m
    and l; its gradient equals autograd of dense attention and the JAX
    package's gradient of its dense attention."""
    mesh, _ = _meshes(4)
    qkv = _qkv(B=1, S=32, H=1, D=4)
    ring = _grads(qkv, lambda *t: (ring_attention(*t, mesh=mesh, causal=True).gather() ** 2).sum())
    dense = _grads(qkv, lambda *t: (dense_attention(*t, causal=True) ** 2).sum())
    theirs = jax.grad(lambda a, b, c: jnp.sum(ref_ra.dense_attention(a, b, c, causal=True) ** 2),
                      argnums=(0, 1, 2))(*(jnp.asarray(x) for x in qkv))
    for r, d, g in zip(ring, dense, theirs):
        np.testing.assert_allclose(r, d, atol=2e-4)
        np.testing.assert_allclose(r, np.asarray(g), atol=2e-4)


@pytest.mark.slow
def test_ring_gradients_match_the_reference_ring():
    """Slow-marked as the JAX package marks its gradient test: the
    reference's grad of shard_map compiles for 10-30 s on one CPU core."""
    mesh, ref = _meshes(4)
    qkv = _qkv(B=1, S=32, H=1, D=4)
    ring = _grads(qkv, lambda *t: (ring_attention(*t, mesh=mesh, causal=True).gather() ** 2).sum())
    theirs = jax.grad(lambda a, b, c: jnp.sum(ref_ra.ring_attention(a, b, c, mesh=ref, causal=True) ** 2),
                      argnums=(0, 1, 2))(*(jnp.asarray(x) for x in qkv))
    for r, g in zip(ring, theirs):
        np.testing.assert_allclose(r, np.asarray(g), atol=2e-4)


def test_ring_output_stays_sharded():
    mesh, ref = _meshes(8)
    qkv = _qkv()
    out = ring_attention(*(sequence_sharded(torch.from_numpy(x), mesh) for x in qkv), mesh=mesh)
    shard_shapes = {tuple(s.data.shape) for s in out.addressable_shards}
    assert shard_shapes == {(2, 8, 2, 8)}
    theirs = ref_ra.ring_attention(*(ref_ra.sequence_sharded(jnp.asarray(x), ref) for x in qkv), mesh=ref)
    assert shard_shapes == {tuple(s.data.shape) for s in theirs.addressable_shards}
    assert out.placement.spec == tuple(theirs.sharding.spec)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_step_against_the_jax_body(n, causal):
    """The plain step (``flash_block_plain``), driven round a ring of n slots,
    against the JAX body driven round the same ring by the reference's
    shard_map (n = 1: one step from the empty accumulators)."""
    mesh, ref = _meshes(n)
    qkv = _qkv(B=1, S=24 * n, H=3, D=16, seed=n)
    ts = [torch.from_numpy(x) for x in qkv]
    before = fb.flash_block.launches
    out = ring_attention(*ts, mesh=mesh, causal=causal)
    assert fb.flash_block.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(np.asarray(out), _ref_ring(qkv, ref, causal), atol=2e-5)


def test_plain_step_folds_a_block_into_a_running_state():
    """One step from a running (o, l, m), rows already at -inf among them,
    against the recurrence the JAX body states, in float64 numpy."""
    rng = np.random.default_rng(5)
    B, S_q, S_k, H, D = 1, 12, 10, 2, 4
    q, k, v = (rng.standard_normal((B, s, H, D)).astype(np.float32) for s in (S_q, S_k, S_k))
    o = rng.standard_normal((B, H, S_q, D)).astype(np.float32)
    l = (rng.random((B, H, S_q)) + 0.5).astype(np.float32)
    m = rng.standard_normal((B, H, S_q)).astype(np.float32)
    m[..., :3], l[..., :3], o[..., :3, :] = -np.inf, 0.0, 0.0
    q_off, k_off, scale = 5, 9, 0.5
    tensors = [torch.from_numpy(x.copy()) for x in (o, l, m)]
    fb.flash_block(*(torch.from_numpy(x) for x in (q, k, v)), *tensors, q_offset=q_off, k_offset=k_off,
                   causal=True, scale=scale)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    mask = (q_off + np.arange(S_q))[:, None] >= (k_off + np.arange(S_k))[None, :]
    s = np.where(mask, s, -np.inf)
    m_new = np.maximum(m, s.max(axis=-1))
    safe = np.where(np.isneginf(m_new), 0.0, m_new)
    p = np.where(mask, np.exp(s - safe[..., None]), 0.0)
    with np.errstate(invalid="ignore"):
        corr = np.where(np.isneginf(m), 0.0, np.exp(m - safe))
    np.testing.assert_allclose(tensors[2].numpy(), m_new, rtol=1e-6)
    np.testing.assert_allclose(tensors[1].numpy(), l * corr + p.sum(-1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tensors[0].numpy(), o * corr[..., None] + np.einsum("bhqk,bkhd->bhqd", p, v),
                               rtol=1e-5, atol=1e-5)


def test_flash_block_refuses_what_it_does_not_take():
    q = torch.zeros((1, 4, 1, 8))
    acc = (torch.zeros((1, 1, 4, 8)), torch.zeros((1, 1, 4)), torch.zeros((1, 1, 4)))
    with pytest.raises(ValueError, match="do not match"):
        fb.flash_block(q, torch.zeros((1, 4, 2, 8)), q, *acc, q_offset=0, k_offset=0, causal=False, scale=1.0)
    with pytest.raises(TypeError, match="float32"):
        fb.flash_block(q, q, q, acc[0].double(), *acc[1:], q_offset=0, k_offset=0, causal=False, scale=1.0)
    with pytest.raises(ValueError, match="not"):
        fb.flash_block(q, q, q, acc[0][..., :4], *acc[1:], q_offset=0, k_offset=0, causal=False, scale=1.0)
