"""The port's device mesh (``cubed_tpu_torch/parallel/mesh.py``) held against
the JAX package's: an 8-slot mesh of ``torch.device("cpu")`` against JAX's 8
virtual CPU devices, the placement policy's partition specs tuple for tuple,
and the shards each slot holds. Counterpart of tests/parallel/test_mesh.py's
four policy cases; its seven ``mesh_executor`` cases wait for the
mesh-sharded executor (ROADMAP Queue 1 item 12b)."""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

from cubed_tpu.parallel import mesh as ref_mesh
from cubed_tpu_torch.parallel import factorized_mesh, make_mesh, reshard, sharding_for_chunks
from cubed_tpu_torch.parallel.mesh import prime_factors

CPU8 = [torch.device("cpu")] * 8


def _ref_devices():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("the JAX package's side needs 8 virtual CPU devices")
    return devs[:8]


def _both(shape, axis_names):
    return (make_mesh(shape=shape, axis_names=axis_names, devices=CPU8),
            ref_mesh.make_mesh(shape=shape, axis_names=axis_names, devices=_ref_devices()))


def test_sharding_for_chunks():
    mesh, ref = _both((8,), ("data",))
    args = (((2,) * 8, (6,) * 4), (16, 24))
    placement = sharding_for_chunks(mesh, *args)
    assert placement.spec[0] == "data"  # most blocks and divisible
    assert placement.spec == tuple(ref_mesh.sharding_for_chunks(ref, *args).spec)


def test_prime_factors():
    assert prime_factors(8) == [2, 2, 2]
    assert prime_factors(12) == [2, 2, 3]
    assert prime_factors(7) == [7]
    assert prime_factors(1) == []
    assert all(prime_factors(n) == ref_mesh.prime_factors(n) for n in range(1, 200))


def test_factorized_mesh_shards_odd_shapes():
    # (499, 450, 400) replicates under a 1-d 8-mesh (no dim divides by 8);
    # the factorized (2, 2, 2) placement shards it 8-way across two dims
    mesh, ref = _both((8,), ("data",))
    fmesh, fref = factorized_mesh(mesh), ref_mesh.factorized_mesh(ref)
    assert fmesh.devices.shape == (2, 2, 2) == fref.devices.shape
    assert fmesh.axis_names == fref.axis_names
    shape = (499, 450, 400)
    chunkset = tuple(tuple(min(100, s - i) for i in range(0, s, 100)) for s in shape)
    placement = sharding_for_chunks(fmesh, chunkset, shape)
    theirs = ref_mesh.sharding_for_chunks(fref, chunkset, shape)
    assert placement.spec == tuple(theirs.spec)
    assert placement.shard_shape(shape) == tuple(theirs.shard_shape(shape))
    assert math.prod(placement.shard_shape(shape)) * 8 == math.prod(shape)


def test_sharding_for_chunks_2d_mesh_uneven_grid():
    mesh, ref = _both((4, 2), ("a", "b"))
    # ragged chunk grid: 19 = 5+5+5+4 blocks of chunk 5; both dims uneven
    args = (((5, 5, 5, 4), (6, 6, 2)), (19, 14))
    placement = sharding_for_chunks(mesh, *args)
    assert placement.spec[1] == "b" or placement.spec[1] == ("b",)
    assert placement.spec[0] is None
    assert placement.spec == tuple(ref_mesh.sharding_for_chunks(ref, *args).spec)


#: (mesh shape, axis names, chunkset or None, array shape)
POLICY_CASES = [
    ((8,), ("data",), None, (64, 24)),
    ((8,), ("data",), ((4,) * 4, (3,) * 8), (16, 24)),
    ((4, 2), ("data", "model"), ((2,) * 8, (6,) * 4), (16, 24)),
    ((2, 2, 2), ("x", "y", "z"), ((50,) * 10, (45,) * 10, (40,) * 10), (500, 450, 400)),
    ((8,), ("data",), ((7, 7, 3),), (17,)),
    ((8,), ("data",), (), ()),
]


@pytest.mark.parametrize("case", POLICY_CASES)
def test_placement_and_shards_match_the_reference(case):
    shape_m, names, chunkset, shape = case
    mesh, ref = _both(shape_m, names)
    placement = sharding_for_chunks(mesh, chunkset, shape)
    theirs = ref_mesh.sharding_for_chunks(ref, chunkset, shape)
    assert placement.spec == tuple(theirs.spec)
    xn = np.arange(math.prod(shape), dtype=np.float64).reshape(shape)
    sharded = reshard(torch.from_numpy(xn), mesh, chunkset, shape)
    ref_arr = jax.device_put(xn, theirs)
    by_device = {d.id: np.asarray(s.data) for s in ref_arr.addressable_shards for d in [s.device]}
    for shard, dev in zip(sharded.addressable_shards, ref.devices.flat):
        np.testing.assert_array_equal(shard.data.numpy(), by_device[dev.id])
        assert shard.device == torch.device("cpu")
    np.testing.assert_array_equal(np.asarray(sharded), xn)


def test_mesh_attributes_match_the_reference():
    mesh, ref = _both((4, 2), ("data", "model"))
    assert mesh.axis_names == ref.axis_names
    assert mesh.shape == dict(ref.shape)
    assert mesh.devices.shape == ref.devices.shape
    assert make_mesh(devices=CPU8).axis_names == ref_mesh.make_mesh(devices=_ref_devices()).axis_names
    with pytest.raises(ValueError, match="does not match"):
        make_mesh(shape=(3,), devices=CPU8)


def test_default_mesh_is_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh()
    assert mesh.shape == {"data": 2}
    assert list(mesh.devices.flat) == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_parallel_exports_the_reference_names_less_multihost():
    import cubed_tpu.parallel as ref
    import cubed_tpu_torch.parallel as port

    pending = {"dcn_mesh", "host_chunk_assignment", "local_chunks"}  # multihost.py: ROADMAP Queue 1 item 12b
    names = {n for n in dir(ref) if not n.startswith("_") and callable(getattr(ref, n))}
    assert pending <= names
    assert names - pending == {n for n in dir(port) if not n.startswith("_") and callable(getattr(port, n))}
