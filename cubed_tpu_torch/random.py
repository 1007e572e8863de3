"""Coordination-free distributed random arrays.

Counterpart of ``cubed_tpu/random.py``, trimmed to ``random``. The contract
is the JAX package's: each block draws from
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
from .utils import to_chunksize


def random(size, *, chunks=None, spec=None):
    """Uniform [0, 1) float64 array with per-block reproducible randomness."""
    shape = (size,) if isinstance(size, int) else tuple(size)
    dtype = np.dtype(np.float64)
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
        _random_block,
        block_function,
        template,
        offsets,
        shape=shape,
        dtype=dtype,
        chunks=chunks,
        op_name="random",
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
