"""The device mesh: slots of devices laid out along named axes, one process
driving them all. Counterpart of ``cubed_tpu/parallel/mesh.py``.

The JAX package's mesh is a ``jax.sharding.Mesh`` under a single controller:
one process drives every device, and ``shard_map`` runs a per-device body on
each. The port keeps that model. A :class:`Mesh` is a numpy object array of
``torch.device`` s with axis names; a slot may repeat a device, so a ring of
four slots on one card runs every slot's kernel work there, and a ring of
eight on ``torch.device("cpu")`` is how the tests build one. A tensor laid
over a mesh is a :class:`ShardedTensor`: one shard a slot, placed on its
slot's device, as :func:`sharding_for_chunks` assigns mesh axes to array
dimensions (the same policy, and the same partition-spec tuples, as the
reference's). What the reference's collectives do over ICI, the ring
modules do with copies between distinct devices and nothing at all between
slots on one device.

The mesh-sharded executor (``CudaExecutor(mesh=)``, ``Spec(mesh_shape=)``)
and the multi-host seams (``multihost.py``) are not ported yet (ROADMAP
Queue 1 item 12b).
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Devices on named axes: ``devices`` a numpy object array of
    ``torch.device`` s, ``axis_names`` a tuple, ``shape`` a dict from axis
    name to size (the attributes the reference reads of a JAX mesh)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs {devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis_name: str) -> list:
        """The devices along *axis_name*, the other axes at their first slot:
        a ring's slots in order."""
        if axis_name not in self.axis_names:
            raise ValueError(f"{axis_name!r} is not a mesh axis {self.axis_names}")
        a = self.axis_names.index(axis_name)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[a]):
            index[a] = i
            out.append(self.devices[tuple(index)])
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _as_device(d) -> torch.device:
    return d if isinstance(d, torch.device) else torch.device(d)


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Optional[Sequence[str]] = None,
    devices=None,
) -> Mesh:
    """A :class:`Mesh` over *devices* (default: every visible CUDA device;
    raises when there is none). Default shape: a 1-d ``("data",)`` mesh over
    all of them; pass an n-d shape (e.g. ``(4, 2)`` with ``("data",
    "model")``) for hybrid layouts. A device may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= (for example "
                "[torch.device('cpu')] * 8) to lay a mesh over the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_as_device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,)
    if axis_names is None:
        axis_names = ("data", "model", "seq", "expert")[: len(shape)]
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not match {n} devices")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def prime_factors(n: int) -> list[int]:
    """Prime factorization (ascending); [] for n <= 1."""
    out = []
    f = 2
    while f * f <= n:
        while n % f == 0:
            out.append(f)
            n //= f
        f += 1
    if n > 1:
        out.append(n)
    return out


def factorized_mesh(mesh: Mesh) -> Mesh:
    """A view of *mesh*'s devices with one axis per prime factor, so that
    :func:`sharding_for_chunks` can place factors on different array dims:
    (499, 450, 400) on 8 devices replicates under a 1-d mesh but shards
    8-way under (2, 2, 2). Device order is preserved."""
    devs = mesh.devices.flatten()
    factors = prime_factors(len(devs)) or [1]
    return Mesh(devs.reshape(tuple(factors)), tuple(f"f{i}" for i in range(len(factors))))


class Placement:
    """Mesh axes assigned to array dimensions: ``spec`` is the tuple a JAX
    ``PartitionSpec`` holds (per dim None, one axis name, or a tuple of
    names)."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)

    def _axes(self, dim: int) -> tuple:
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return ()
        return tuple(entry) if isinstance(entry, tuple) else (entry,)

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        """One shard's shape for an array of *shape*."""
        return tuple(s // math.prod(self.mesh.shape[a] for a in self._axes(d)) for d, s in enumerate(shape))

    def shard_index(self, slot: tuple, shape: Sequence[int]) -> tuple:
        """The slices of an array of *shape* held by the mesh slot *slot*
        (its index along each mesh axis); axes over several mesh axes split
        major to minor in the order they were assigned."""
        at = dict(zip(self.mesh.axis_names, slot))
        out = []
        for d, s in enumerate(shape):
            axes = self._axes(d)
            pos = 0
            for a in axes:
                pos = pos * self.mesh.shape[a] + at[a]
            step = s // math.prod(self.mesh.shape[a] for a in axes) if axes else s
            out.append(slice(pos * step, (pos + 1) * step))
        return tuple(out)

    def __repr__(self) -> str:
        return f"Placement(spec={self.spec}, mesh={self.mesh.shape})"


def sharding_for_chunks(
    mesh: Mesh,
    chunkset: Optional[Sequence[Sequence[int]]],
    shape: Sequence[int],
) -> Placement:
    """A :class:`Placement` laying the chunk grid over the mesh: the
    reference's policy. Mesh axes go to array dims greedily, dims with the
    most chunk blocks first, then by extent; several axes may stack on one
    dim (their product must divide it). A first pass takes only
    chunk-aligned assignments (the block count divisible by the axis
    product), a second any dim whose extent divides. ``chunkset=None`` ranks
    dims by extent alone."""
    if not shape:
        return Placement(mesh, ())
    nb = [len(c) for c in chunkset] if chunkset else [1] * len(shape)
    assigned: list[list] = [[] for _ in shape]
    prods = [1] * len(shape)
    pool = [(n, s) for n, s in zip(mesh.axis_names, mesh.devices.shape) if s > 1]
    order = sorted(range(len(shape)), key=lambda d: (-nb[d], -shape[d]))
    for aligned_only in (True, False):
        for dim in order:
            if not pool:
                break
            for name, size in list(pool):
                total = prods[dim] * size
                if shape[dim] % total != 0:
                    continue
                if aligned_only and nb[dim] % total != 0:
                    continue
                assigned[dim].append(name)
                prods[dim] = total
                pool.remove((name, size))
    return Placement(mesh, tuple((tuple(a) if len(a) > 1 else a[0]) if a else None for a in assigned))


class Shard:
    """One slot's piece of a :class:`ShardedTensor` (``data``, ``device``,
    ``index``: the slices of the whole it holds)."""

    def __init__(self, data: torch.Tensor, device: torch.device, index: tuple):
        self.data = data
        self.device = device
        self.index = index


class ShardedTensor:
    """A tensor laid over a mesh: one shard a slot (in the order of
    ``mesh.devices.flat``), each on its slot's device; a dimension no mesh
    axis shards is whole in every shard (replicated)."""

    def __init__(self, placement: Placement, shape: Sequence[int], shards: list):
        self.placement = placement
        self.shape = tuple(shape)
        self.shards = list(shards)

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    @property
    def addressable_shards(self) -> list:
        return [Shard(t, dev, self.placement.shard_index(slot, self.shape))
                for t, dev, slot in zip(self.shards, self.mesh.devices.flat, slots(self.mesh))]

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on *device* (default: the first slot's),
        assembled from the shards (differentiable)."""
        device = _as_device(device) if device is not None else self.mesh.devices.flat[0]
        pieces: dict = {}
        for s in self.addressable_shards:
            pieces.setdefault(tuple((sl.start, sl.stop) for sl in s.index), s)
        return _assemble(self.placement, self.shape, pieces, device)

    def __array__(self, dtype=None, copy=None):
        out = self.gather().detach().cpu().numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return f"ShardedTensor(shape={self.shape}, spec={self.placement.spec}, shards={len(self.shards)})"


def _assemble(placement: Placement, shape, pieces: dict, device) -> torch.Tensor:
    """Concatenate the distinct shards *pieces* (keyed by their (start,
    stop) per dim) into the whole, one dim at a time."""
    dims = [d for d in range(len(shape)) if placement._axes(d)]

    def build(prefix: tuple, d: int):
        if d == len(dims):
            for key, s in pieces.items():
                if all(key[dims[i]] == prefix[i] for i in range(len(dims))):
                    return s.data.to(device)
            raise ValueError("a shard is missing")
        starts = sorted({key[dims[d]] for key in pieces})
        return torch.cat([build(prefix + (st,), d + 1) for st in starts], dim=dims[d])

    return build((), 0)


def place(x: torch.Tensor, placement: Placement) -> ShardedTensor:
    """Split *x* into its shards under *placement*, each moved to its slot's
    device."""
    mesh = placement.mesh
    shape = tuple(x.shape)
    for d, s in enumerate(shape):
        n = math.prod(mesh.shape[a] for a in placement._axes(d))
        if s % n:
            raise ValueError(f"dim {d} of {shape} does not divide over {n} slots")
    shards = [x[placement.shard_index(slot, shape)].to(dev) for slot, dev in zip(slots(mesh), mesh.devices.flat)]
    return ShardedTensor(placement, shape, shards)


def slots(mesh: Mesh):
    """Every slot's index along each mesh axis, in the order of
    ``mesh.devices.flat``."""
    return itertools.product(*(range(n) for n in mesh.devices.shape))


def ring_sharded(mesh: Mesh, axis_name: str, dim: int, shape: tuple, outs: list) -> ShardedTensor:
    """A ring's per-slot outputs as a tensor of *shape* sharded on *dim* over
    *axis_name*, copied to the slots of the mesh's other axes."""
    a = mesh.axis_names.index(axis_name)
    shards = [outs[slot[a]] if outs[slot[a]].device == dev else outs[slot[a]].to(dev)
              for slot, dev in zip(slots(mesh), mesh.devices.flat)]
    spec = [None] * len(shape)
    spec[dim] = axis_name
    return ShardedTensor(Placement(mesh, tuple(spec)), shape, shards)


def reshard(x, mesh: Mesh, chunkset, shape) -> ShardedTensor:
    """Split *x* into per-slot shards under the placement its chunk grid
    implies (:func:`sharding_for_chunks`)."""
    if isinstance(x, ShardedTensor):
        x = x.gather()
    return place(torch.as_tensor(x), sharding_for_chunks(mesh, chunkset, shape))
