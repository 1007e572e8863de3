"""Cannon's product and the ring reduction (``cubed_tpu_torch/parallel/ring.py``)
on an 8-slot CPU mesh, held against the JAX package's on its 8 virtual CPU
devices. Counterpart of tests/parallel/test_ring.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubed_tpu.parallel import mesh as ref_mesh
from cubed_tpu.parallel import ring as ref_ring
from cubed_tpu_torch.parallel.mesh import make_mesh
from cubed_tpu_torch.parallel.ring import ring_matmul, ring_reduction


@pytest.fixture
def meshes():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("the JAX package's side needs 8 virtual CPU devices")
    return (make_mesh(shape=(8,), axis_names=("data",), devices=[torch.device("cpu")] * 8),
            ref_mesh.make_mesh(shape=(8,), axis_names=("data",), devices=devs[:8]))


@pytest.mark.parametrize("shape", [(16, 24, 8), (64, 32, 48)])
def test_ring_matmul(meshes, shape):
    mesh, ref = meshes
    M, K, N = shape
    rng = np.random.default_rng(0)
    an = rng.random((M, K), dtype=np.float32)
    bn = rng.random((K, N), dtype=np.float32)
    out = ring_matmul(torch.from_numpy(an), torch.from_numpy(bn), mesh=mesh)
    np.testing.assert_allclose(np.asarray(out), an @ bn, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref_ring.ring_matmul(jnp.asarray(an), jnp.asarray(bn),
                                                                               mesh=ref)), rtol=1e-4)
    assert {tuple(s.data.shape) for s in out.addressable_shards} == {(M // 8, N)}


def test_ring_matmul_shape_check(meshes):
    mesh, _ = meshes
    with pytest.raises(ValueError, match="divisible"):
        ring_matmul(torch.zeros((15, 24)), torch.zeros((24, 8)), mesh=mesh)
    with pytest.raises(ValueError, match="contraction mismatch"):
        ring_matmul(torch.zeros((16, 24)), torch.zeros((16, 8)), mesh=mesh)


def test_ring_reduction(meshes):
    mesh, ref = meshes
    rng = np.random.default_rng(0)
    xn = rng.random((32, 4), dtype=np.float32)
    out = ring_reduction(torch.from_numpy(xn), lambda s: torch.sum(s), mesh=mesh)
    # every ring position holds the global sum
    np.testing.assert_allclose(np.asarray(out), np.full(8, xn.sum()), rtol=1e-4)
    theirs = ref_ring.ring_reduction(jnp.asarray(xn), lambda s: jnp.sum(s), mesh=ref)
    np.testing.assert_allclose(np.asarray(out), np.asarray(theirs), rtol=1e-6)


def test_ring_reduction_of_vector_partials(meshes):
    mesh, ref = meshes
    xn = np.random.default_rng(1).random((16, 3), dtype=np.float32)
    out = ring_reduction(torch.from_numpy(xn), lambda s: s.sum(dim=0), mesh=mesh)
    theirs = ref_ring.ring_reduction(jnp.asarray(xn), lambda s: s.sum(axis=0), mesh=ref)
    assert np.asarray(out).shape == np.asarray(theirs).shape == (24,)
    np.testing.assert_allclose(np.asarray(out), np.asarray(theirs), rtol=1e-6)
