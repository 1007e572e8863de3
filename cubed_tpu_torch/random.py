"""Coordination-free distributed random arrays.

Counterpart of ``cubed_tpu/random.py``: ``random``, ``normal`` and
``randint``. The contract is the JAX package's: each block draws from
``np.random.Philox(seed=root_seed + linear block offset)``, with
``root_seed = random.getrandbits(30)`` from the stdlib generator, so a block
is the same whichever worker computes it, and with the stdlib generator
seeded alike both packages draw the same seeds. The seed rides the offsets
*data* (a VirtualOffsetsArray whose base is the root seed).

A block on the card is generated there by the hand-written Philox kernel
(``kernels/philox_uniform.py``), bit for bit numpy's stream; no block is
drawn on the host and copied over. The block function carries the hint
``batched``: the device executor then fills the whole array in one launch
(:func:`_random_blocks`). It is also ``batchable``: where a random op is
fused into its consumer, the executor's batched route calls it under
``torch.func.vmap`` with its seeds as a tensor, and it takes the Philox
custom op, whose batching rule fills a bucket's blocks in one launch. Its
seeds are ``hoisted_seeds``, as the reference's are ``traced_offsets``: a
captured CUDA graph reads their keys from a buffer refilled before each
replay, so plans that differ only in seeds share one graph.

Under the device executor's ``compute_dtype="float32"`` (the narrowing
scope of ``backend_array_api``) a block is float32: the float64 stream
rounded to the nearest float32, element by element, by the kernels' float32
entry points. That is the reference's float32 block bit for bit: its
Philox route draws float64 and casts (``cubed_tpu/random.py:111-122``,
``:163``), and never uses numpy's own float32 draw, another stream.

``normal`` and ``randint`` draw their blocks on the host, with numpy's own
``Philox(seed).normal`` and ``.integers(0, span)``: the ziggurat and the
bounded integers with rejection are the reference's Philox route bit for bit
and are not a small kernel. Their block functions carry the same pair as
``random``'s: a whole-array ``batched`` form (every block drawn, then one
upload) and a custom op whose batching rule draws a bucket's blocks and
uploads them in one copy. They declare ``host_draws``: a device segment
that holds one runs op by op and is never captured as a CUDA graph. The
scale and the offset (``stddev``, ``mean``, ``low``) are elementwise ops
that fuse, as in the reference.
"""

from __future__ import annotations

import math
import random as pyrandom

import numpy as np
import torch

from .backend_array_api import to_torch_dtype
from .chunks import blockdims_from_blockshape, normalize_chunks
from .core.ops import general_blockwise, new_array
from .core.plan import Plan, gensym
from .kernels._geometry import blocks_fit
from .kernels.philox_uniform import block_keys, philox_blocks, philox_key, philox_uniform, philox_uniform_blocks
from .spec import spec_from_config
from .storage.virtual import VirtualOffsetsArray, virtual_empty
from .utils import get_item, to_chunksize


def random(size, *, chunks=None, spec=None):
    """Uniform [0, 1) float64 array with per-block reproducible randomness."""
    return _distribution(size, chunks, spec, kernel=_random_block, op_name="random", dtype=np.float64)


def normal(size, *, mean=0.0, stddev=1.0, chunks=None, spec=None):
    """Normal array with the per-block determinism of :func:`random`. The
    blocks are standard normal; the scale and the offset are elementwise
    ops, which fuse."""
    mean, stddev = float(mean), float(stddev)
    if stddev < 0:
        raise ValueError(f"stddev must be non-negative, got {stddev}")
    out = _distribution(size, chunks, spec, kernel=_normal_block, op_name="normal", dtype=np.float64)
    from .array_api.elementwise_functions import add, multiply

    if stddev != 1.0:
        out = multiply(out, stddev)
    if mean != 0.0:
        out = add(out, mean)
    return out


def randint(low, high, size, *, chunks=None, spec=None):
    """Uniform int64 integers in [low, high) with per-block determinism: the
    blocks draw from [0, high - low) and ``low`` is added by a fused
    elementwise op."""
    low, high = int(low), int(high)
    if high <= low:
        raise ValueError(f"high ({high}) must be greater than low ({low})")
    out = _distribution(size, chunks, spec, kernel=_randint_kernel(high - low), op_name="randint",
                        dtype=np.int64)
    if low != 0:
        from .array_api.elementwise_functions import add

        out = add(out, low)
    return out


def _distribution(size, chunks, spec, *, kernel, op_name, dtype):
    shape = (size,) if isinstance(size, int) else tuple(size)
    dtype = np.dtype(dtype)
    spec = spec_from_config(spec)
    chunks = normalize_chunks(chunks, shape, dtype=dtype)
    numblocks = tuple(len(c) for c in chunks)
    root_seed = pyrandom.getrandbits(30)

    template_t = virtual_empty(shape, dtype=dtype, chunks=to_chunksize(chunks) if shape else ())
    t_name = gensym("template")
    template = new_array(t_name, template_t, spec, Plan._new(t_name, "template", template_t, None, True))

    offsets_t = VirtualOffsetsArray(numblocks, base=root_seed)
    o_name = gensym("seeds")
    offsets = new_array(o_name, offsets_t, spec, Plan._new(o_name, "seeds", offsets_t, None, True))

    def block_function(out_key):
        coords = out_key[1:]
        return ((t_name, *coords), (o_name, *coords))

    return general_blockwise(
        kernel,
        block_function,
        template,
        offsets,
        shape=shape,
        dtype=dtype,
        chunks=chunks,
        op_name=op_name,
    )


def _random_block(chunk, seeded_offset):
    """One uniform block (float64, or float32 under the narrowing scope) on
    the template chunk's device; ``seeded_offset`` (root seed +
    block offset) is a host array, or an int64 tensor on the CPU in the
    device executor's batched route (then possibly batched under
    ``torch.func.vmap``)."""
    if isinstance(seeded_offset, torch.Tensor):
        return philox_blocks(chunk, seeded_offset)
    seed = int(np.asarray(seeded_offset).reshape(-1)[0])
    out = torch.empty(tuple(chunk.shape), dtype=to_torch_dtype(np.float64), device=chunk.device)
    return philox_uniform(out, philox_key(seed))


def _random_blocks(shape, chunks, root_seed: int, device) -> torch.Tensor:
    """The whole array of ``random(shape, chunks=chunks)`` with root seed
    *root_seed*, every block as :func:`_random_block` draws it: one launch of
    the batched kernel on a CUDA device, the plain version on the CPU."""
    shape = tuple(shape)
    nblocks = math.prod(len(c) for c in blockdims_from_blockshape(shape, tuple(chunks)))
    keys = block_keys(root_seed + np.arange(nblocks, dtype=np.int64))
    out = torch.empty(shape, dtype=to_torch_dtype(np.float64), device=device)
    return philox_uniform_blocks(out, chunks, keys)


#: shapes one batched launch takes (rank 4 or less, 32-bit offsets)
_random_blocks.fits = blocks_fit
_random_block.batched = _random_blocks
_random_block.batchable = True
_random_block.hoisted_seeds = True


# ---------------------------------------------------------------------------
# normal and randint: blocks drawn on the host
# ---------------------------------------------------------------------------


def _draw(kind: str, span: int, seed: int, shape: tuple) -> np.ndarray:
    """Block *shape* of ``Philox(seed=seed)``'s normal or integer stream, as
    the reference's Philox route draws it."""
    rng = np.random.Generator(np.random.Philox(seed=int(seed)))
    if kind == "normal":
        return rng.normal(size=shape)
    return rng.integers(0, span, size=shape, dtype=np.int64)


def _upload(host: np.ndarray, like_dtype: torch.dtype, device) -> torch.Tensor:
    """*host* on *device* in one copy, in *like_dtype* (a float32 chunk under
    the narrowing scope takes the float64 draw rounded)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    return t.to(device=device, dtype=like_dtype)


@torch.library.custom_op("cubed_tpu_torch::host_draws", mutates_args=())
def _host_draws_op(like: torch.Tensor, seeds: torch.Tensor, kind: str, span: int) -> torch.Tensor:
    """Blocks of *like*'s shape and dtype on its device, one for each seed:
    *seeds* is an int64 tensor of shape ``batch + (1,) * like.ndim`` on the
    CPU; block ``b`` is drawn by :func:`_draw` from ``seeds[b]``. The blocks
    are drawn on the host and uploaded in one copy."""
    block = tuple(like.shape)
    batch = tuple(seeds.shape[: seeds.ndim - like.ndim])
    flat = seeds.detach().cpu().numpy().reshape(-1)
    host = np.empty((len(flat),) + block, dtype=np.float64 if kind == "normal" else np.int64)
    for b, seed in enumerate(flat):
        host[b] = _draw(kind, span, seed, block)
    return _upload(host.reshape(batch + block), like.dtype, like.device)


@_host_draws_op.register_fake
def _host_draws_fake(like, seeds, kind, span):
    batch = tuple(seeds.shape[: seeds.ndim - like.ndim])
    return like.new_empty(batch + tuple(like.shape))


@torch.library.register_vmap("cubed_tpu_torch::host_draws")
def _host_draws_vmap(info, in_dims, like, seeds, kind, span):
    """The batching rule: a bucket's blocks share one shape, so a batched
    *like* is read at index 0; the seeds' batch axis becomes the output's,
    and the bottom call draws every block of the bucket and uploads them in
    one copy."""
    like_d, seeds_d = in_dims[0], in_dims[1]
    if like_d is not None:
        like = like.select(like_d, 0)
    if seeds_d is None:
        return _host_draws_op(like, seeds, kind, span), None
    return _host_draws_op(like, seeds.movedim(seeds_d, 0), kind, span), 0


def _host_block(kind: str, span: int, chunk, seeded_offset):
    if isinstance(seeded_offset, torch.Tensor):
        return _host_draws_op(chunk, seeded_offset, kind, span)
    seed = int(np.asarray(seeded_offset).reshape(-1)[0])
    return _upload(_draw(kind, span, seed, tuple(chunk.shape)), chunk.dtype, chunk.device)


def _host_blocks(kind: str, span: int):
    """The whole-array form of a host-drawn distribution: every block drawn
    into one host array, uploaded in one copy."""

    def blocks(shape, chunks, root_seed: int, device) -> torch.Tensor:
        shape = tuple(shape)
        chunkset = blockdims_from_blockshape(shape, tuple(chunks))
        host = np.empty(shape, dtype=np.float64 if kind == "normal" else np.int64)
        grid = tuple(len(c) for c in chunkset)
        for offset, idx in enumerate(np.ndindex(*grid)):
            sel = get_item(chunkset, idx)
            host[sel] = _draw(kind, span, root_seed + offset, tuple(s.stop - s.start for s in sel))
        return _upload(host, to_torch_dtype(host.dtype), device)

    blocks.fits = lambda shape: True
    return blocks


def _normal_block(chunk, seeded_offset):
    """One standard normal block on the template chunk's device."""
    return _host_block("normal", 0, chunk, seeded_offset)


def _randint_kernel(span: int):
    """The block function of ``randint`` with span *span*."""

    def _randint_block(chunk, seeded_offset):
        """One block of integers in [0, span) on the template chunk's device."""
        return _host_block("randint", span, chunk, seeded_offset)

    _randint_block.batched = _host_blocks("randint", span)
    _randint_block.batchable = True
    _randint_block.host_draws = True
    return _randint_block


_normal_block.batched = _host_blocks("normal", 0)
_normal_block.batchable = True
_normal_block.host_draws = True
