"""K1: uniform float64 (or float32) blocks from numpy's Philox4x64-10 stream.

Replaces the host-side block generation of the JAX package's
``random.py:_random_block`` (:217) and ``_philox_block`` (:137), which draw
``np.random.Generator(np.random.Philox(seed=root + block_offset)).random(shape)``.
The CUDA kernels (``csrc/philox_uniform.cu``) reproduce that stream bit for
bit on the card: element ``4*i + j`` of a block is word ``j`` of
``philox4x64_10(counter=(i+1, 0, 0, 0), key)`` (numpy increments the counter
before its first use), and the double is ``(u >> 11) * 2**-53``. Keys are
derived on the host from numpy's SeedSequence, all of an op's at once
(:func:`philox_keys`).

Each wrapper takes a float64 or a float32 output. A float32 element is the
same double rounded to the nearest float32 (``__double2float_rn``): the
reference's float32 block under ``compute_dtype="float32"``, which casts
its float64 draw. Both kernels are templates on the output type, with an
entry point per type (``philox_uniform_f64`` / ``_f32``,
``philox_uniform_blocks_f64`` / ``_f32``); a float32 counter's four words go
out as one 16-byte store where the address allows it.

Two wrappers, one launch count:

- :func:`philox_uniform` fills one block (one counter per thread): the
  sequential executor's tasks and fused random ops call it block by block;
- :func:`philox_uniform_blocks` fills every block of a regular grid in place
  in the assembled array, in one launch of persistent CTAs (the device
  executor's batched route). Its work split is planned in pure Python
  (:func:`._geometry.blocks_plan`).

:func:`philox_blocks` is the custom op ``cubed_tpu_torch::philox_blocks``
that a random block function calls when its seeds come as a tensor (under
``torch.func.vmap``, in the device executor's batched route): its batching
rule takes a bucket's seeds at once, derives every key in one
:func:`philox_keys` pass and fills the bucket's stacked blocks with one
:func:`philox_uniform_blocks` launch.

While a CUDA graph is captured, keys may not be uploaded from fresh host
memory (the graph would keep reading a freed address). :class:`HoistedKeys`
holds a captured segment's keys in a static pinned buffer and a device
copy; inside :func:`hoisted`, every key the kernels take comes from there,
and a replay for new seeds refills the pinned buffer first.

Bound on the H100: integer issue on the FMA pipe. The card has no 64-bit
multiplier, so a counter's twenty 64x64->128 products take 164-178 FMA-pipe
issue slots, by build (IMAD.WIDE at two slots; counted from the SASS), which
at 64 lanes per clock per SM is a little more time than the 8 bytes written
per element at 3.35 TB/s (4 bytes in float32: the integer floor still
bounds it).

:func:`philox_uniform_plain` is the same counter arithmetic in torch, in
32-bit limbs held by int64 tensors (torch's uint64 arithmetic is incomplete),
rounded to float32 where asked; :func:`philox_uniform_blocks_plain` builds
each block with it and writes it into place. The wrappers use them only for
tensors on the CPU.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import itertools
import math
from typing import Optional

import numpy as np
import torch

from .. import device_constants
from ..chunks import blockdims_from_blockshape
from ..utils import get_item
from . import _build, _geometry

M0 = 0xD2E7470EE14C6C93
M1 = 0xCA5A826395121157
W0 = 0x9E3779B97F4A7C15
W1 = 0xBB67AE8584CAA73B
ROUNDS = 10
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
_THREADS = 256

#: output dtypes the kernels take, with their entry points' suffixes
DTYPES = {torch.float64: "f64", torch.float32: "f32"}


# numpy's SeedSequence constants (numpy/random/bit_generator.pyx)
_INIT_A = 0x43B0D7E5
_MULT_A = 0x931E8875
_INIT_B = 0x8B51F9DD
_MULT_B = 0x58F38DED
_MIX_MULT_L = 0xCA01F9DD
_MIX_MULT_R = 0x4973F715
_POOL = 4


def _hashmix(value, hash_const: int):
    value = (value ^ hash_const) & _MASK32
    hash_const = (hash_const * _MULT_A) & _MASK32
    value = (value * hash_const) & _MASK32
    return value ^ (value >> 16), hash_const


def _mix(x, y):
    r = (_MIX_MULT_L * x - _MIX_MULT_R * y) & _MASK32
    return r ^ (r >> 16)


def _key_of_entropy(words: list) -> tuple:
    """SeedSequence's pool mixing of the 32-bit entropy *words* (least
    significant first), then ``generate_state(2, uint64)``: the two key
    words. Each word is a Python int (one seed) or a uint64 array (one seed
    an element, masked to 32 bits at every step). The hash constant advances
    in a fixed order, the same for every seed, so an array is mixed in one
    pass."""
    h = _INIT_A
    pool = []
    for i in range(_POOL):
        v, h = _hashmix(words[i] if i < len(words) else 0 * words[0], h)
        pool.append(v)
    for src in range(_POOL):
        for dst in range(_POOL):
            if src != dst:
                v, h = _hashmix(pool[src], h)
                pool[dst] = _mix(pool[dst], v)
    for src in range(_POOL, len(words)):
        for dst in range(_POOL):
            v, h = _hashmix(words[src], h)
            pool[dst] = _mix(pool[dst], v)
    h = _INIT_B
    out = []
    for v in pool:
        v = v ^ h
        h = (h * _MULT_B) & _MASK32
        v = (v * h) & _MASK32
        out.append(v ^ (v >> 16))
    return out[0] | (out[1] << 32), out[2] | (out[3] << 32)


def _words(seed: int) -> list:
    """The 32-bit entropy words of a non-negative *seed*, least significant
    first (one word for a seed below 2**32, two below 2**64, ...)."""
    if seed < 0:
        raise ValueError("Philox seeds must be non-negative")
    words = [seed & _MASK32]
    seed >>= 32
    while seed:
        words.append(seed & _MASK32)
        seed >>= 32
    return words


def philox_keys(seeds) -> np.ndarray:
    """The 2x64-bit keys of ``np.random.Philox(seed=s)`` for each of *seeds*
    (non-negative integers), as an ``(n, 2)`` uint64 array: numpy's
    ``SeedSequence(s).generate_state(2, uint64)``, vectorised. Seeds are
    grouped by their count of 32-bit entropy words (:func:`_words`) and each
    group is mixed in one pass."""
    seeds = np.asarray(seeds).reshape(-1)
    if seeds.dtype.kind not in "iuO":
        raise TypeError(f"philox_keys takes integer seeds, not {seeds.dtype}")
    if seeds.size and (seeds < 0).any():
        raise ValueError("philox_keys: seeds must be non-negative")
    if seeds.dtype.kind == "O":  # Python ints, possibly past 64 bits
        entropy = [_words(int(v)) for v in seeds]
        counts = np.array([len(w) for w in entropy], dtype=np.int64)
    else:
        u = seeds.astype(np.uint64)
        counts = np.where(u >> np.uint64(32), 2, 1)
    keys = np.empty((seeds.size, 2), dtype=np.uint64)
    for nwords in np.unique(counts):
        rows = np.flatnonzero(counts == nwords)
        if seeds.dtype.kind == "O":
            words = list(np.array([entropy[r] for r in rows], dtype=np.uint64).T)
        else:
            words = [u[rows] & np.uint64(_MASK32), u[rows] >> np.uint64(32)][:nwords]
        k0, k1 = _key_of_entropy(words)
        keys[rows, 0], keys[rows, 1] = k0, k1
    return keys


def philox_key(seed: int) -> tuple[int, int]:
    """The 2x64-bit key of ``np.random.Philox(seed=seed)`` (SeedSequence),
    mixed in Python ints: the per-block path's key."""
    return _key_of_entropy(_words(int(seed)))


def philox_uniform(out: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """Fill contiguous float64 or float32 *out* with the Philox uniform stream
    of *key*.

    A CUDA tensor goes to the kernel; a CPU tensor to the plain version.
    """
    if out.dtype not in DTYPES or not out.is_contiguous():
        raise ValueError(f"philox_uniform needs a contiguous float64 or float32 tensor, not {out.dtype}")
    if out.device.type == "cpu":
        out.copy_(philox_uniform_plain(out.numel(), key, dtype=out.dtype).reshape(out.shape))
        return out
    if out.device.type != "cuda":
        raise ValueError(f"philox_uniform: unsupported device {out.device}")
    if _HOISTED.get() is not None:
        raise RuntimeError("philox_uniform passes its key by value, which a captured CUDA graph "
                           "would replay unchanged for new seeds; take philox_uniform_blocks")
    n = out.numel()
    if n == 0:
        return out
    fn = _kernel(DTYPES[out.dtype])
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        err = fn(
            ctypes.c_void_p(out.data_ptr()), ctypes.c_longlong(n),
            ctypes.c_uint64(key[0]), ctypes.c_uint64(key[1]),
            ctypes.c_int(_THREADS), ctypes.c_void_p(stream),
        )
    _build.check(err, "philox_uniform")
    with _build.COUNT_LOCK:
        philox_uniform.launches += 1
        philox_uniform.paths["block"] += 1
        if out.dtype == torch.float32:
            philox_uniform.paths["block_f32"] += 1
    return out


#: launches of the CUDA kernels, per-block and batched (the plain versions
#: do not count)
philox_uniform.launches = 0
#: launches by kernel: "block" (:func:`philox_uniform`) or "batched"
#: (:func:`philox_uniform_blocks`), of which float32 outputs in "block_f32"
#: and "batched_f32"; a batched launch also counts the store paths its
#: blocks take, "vector" (16-byte stores) and "scalar"
philox_uniform.paths = dict.fromkeys(("block", "batched", "block_f32", "batched_f32", "vector", "scalar"), 0)
_build.COUNTED.append(philox_uniform)


def blocks_plan(out: torch.Tensor, chunks, sms: int = _geometry.SMS,
                ctas_per_sm: int = _geometry.PHILOX_CTAS_PER_SM) -> _geometry.BlocksPlan:
    """The batched kernel's geometry for *out* blocked by *chunks*."""
    return _geometry.blocks_plan(tuple(out.shape), tuple(out.stride()), tuple(chunks), out.data_ptr(),
                                 sms, ctas_per_sm, out.element_size())


def _check_blocks(out: torch.Tensor, chunks, keys) -> None:
    if out.dtype not in DTYPES:
        raise ValueError(f"philox_uniform_blocks needs a float64 or float32 tensor, not {out.dtype}")
    if len(chunks) != out.ndim:
        raise ValueError(f"philox_uniform_blocks: chunks {tuple(chunks)} for a rank-{out.ndim} tensor")
    nblocks = math.prod(len(c) for c in _chunkset(tuple(out.shape), tuple(chunks)))
    if isinstance(keys, torch.Tensor):
        if (keys.dtype != torch.int64 or tuple(keys.shape) != (nblocks, 2) or keys.device != out.device
                or not keys.is_contiguous()):
            raise ValueError(f"philox_uniform_blocks needs ({nblocks}, 2) contiguous int64 keys on "
                             f"{out.device}, not {tuple(keys.shape)} {keys.dtype} on {keys.device}")
    elif keys.dtype != np.uint64 or keys.shape != (nblocks, 2):
        raise ValueError(f"philox_uniform_blocks needs ({nblocks}, 2) uint64 keys, "
                         f"not {keys.shape} {keys.dtype}")


def philox_uniform_blocks(out: torch.Tensor, chunks, keys) -> torch.Tensor:
    """Fill float64 or float32 *out* block by block: block ``b`` (C order) of the
    regular grid of *chunks* with the Philox uniform stream of ``keys[b]``.
    *keys* is a host ``(n, 2)`` uint64 array, or the same bits as an int64
    tensor on *out*'s device (:meth:`HoistedKeys.lookup`).

    A CUDA tensor goes to the batched kernel, in one launch; a CPU tensor to
    the plain version.
    """
    _check_blocks(out, chunks, keys)
    if out.device.type == "cpu":
        host = keys.numpy().view(np.uint64) if isinstance(keys, torch.Tensor) else keys
        out.copy_(philox_uniform_blocks_plain(tuple(out.shape), chunks, host, dtype=out.dtype))
        return out
    if out.device.type != "cuda":
        raise ValueError(f"philox_uniform_blocks: unsupported device {out.device}")
    suffix = DTYPES[out.dtype]
    p = blocks_plan(out, chunks, _build.sm_count(out.device), _occupancy(out.device, suffix))
    if p.grid == 0:
        return out
    if isinstance(keys, torch.Tensor):
        keys_dev = keys
    elif _HOISTED.get() is not None:
        raise RuntimeError("philox_uniform_blocks: host keys under a captured CUDA graph; "
                           "take them from the hoisted keys (block_keys)")
    else:
        # the op's keys, uploaded once from pinned memory on the launch stream
        keys_dev = torch.from_numpy(np.ascontiguousarray(keys).view(np.int64)).pin_memory().to(
            out.device, non_blocking=True)
    params = p.params()
    fn = _blocks_kernel(suffix)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        err = fn(
            ctypes.c_void_p(out.data_ptr()), (ctypes.c_longlong * len(params))(*params),
            ctypes.c_void_p(keys_dev.data_ptr()), ctypes.c_int(p.grid), ctypes.c_void_p(stream),
        )
    _build.check(err, "philox_uniform_blocks")
    with _build.COUNT_LOCK:
        philox_uniform.launches += 1
        for key in ("batched", *(("batched_f32",) if suffix == "f32" else ()), *p.paths):
            philox_uniform.paths[key] += 1
    return out


# ---------------------------------------------------------------------------
# keys hoisted out of a captured CUDA graph
# ---------------------------------------------------------------------------


class HoistedKeys:
    """The Philox keys of every seed a captured segment draws from: a
    static pinned host buffer, refilled from a plan's seeds by one
    :func:`philox_keys` pass (:meth:`fill`), and a device copy that the
    graph's first node uploads from it (:meth:`upload`). Row ``i`` holds the
    key of ``seeds[i]``."""

    def __init__(self, seeds, device):
        self.seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
        n = max(1, self.seeds.size)
        # pinned for a card (the graph's copy node reads it); a CPU table
        # (the tests) needs no pinning
        self.host = torch.empty((n, 2), dtype=torch.int64, pin_memory=torch.device(device).type == "cuda")
        self.device = torch.empty((n, 2), dtype=torch.int64, device=device)
        order = np.argsort(self.seeds, kind="stable")
        self._sorted, self._rows = self.seeds[order], order
        self.fill(self.seeds)

    @property
    def nbytes(self) -> int:
        return 2 * self.host.numel() * self.host.element_size()

    def fill(self, seeds) -> None:
        """Write the keys of *seeds* (as many as at construction) into the
        pinned buffer; the device copy changes at the next :meth:`upload`."""
        seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
        if seeds.size != self.seeds.size:
            raise ValueError(f"HoistedKeys: {seeds.size} seeds for {self.seeds.size} rows")
        if seeds.size:
            self.host.numpy()[: seeds.size] = philox_keys(seeds).view(np.int64)

    def upload(self) -> None:
        """Copy the pinned buffer to the device copy, on the current stream."""
        self.device.copy_(self.host, non_blocking=True)

    def lookup(self, seeds: np.ndarray) -> torch.Tensor:
        """The device keys of *seeds* as a contiguous ``(n, 2)`` int64
        tensor: where their rows, in C order, form an affine grid of table
        rows (a bucket of a block grid), a view or one device copy; else (a
        permuted grid: the sort network's partner blocks) a gather by the
        rows, their positions a device constant (uploaded once, outside any
        capture)."""
        seeds = np.asarray(seeds, dtype=np.int64)
        flat = seeds.reshape(-1)
        pos = np.searchsorted(self._sorted, flat)
        if flat.size and (pos.max() >= self._sorted.size or not np.array_equal(self._sorted[pos], flat)):
            raise KeyError("HoistedKeys: a seed outside the segment's hoisted seeds")
        rows = self._rows[pos].reshape(seeds.shape)
        if flat.size == 0:
            return self.device[:0]
        grid = rows.shape
        r0 = int(rows.reshape(-1)[0])
        steps = [int(rows[tuple(1 if a == d else 0 for a in range(len(grid)))]) - r0 if n > 1 else 0
                 for d, n in enumerate(grid)]
        expect = r0 + sum(np.arange(n).reshape([-1 if a == d else 1 for a in range(len(grid))]) * st
                          for d, (n, st) in enumerate(zip(grid, steps)))
        if not np.array_equal(rows, np.broadcast_to(expect, grid)) or min(steps, default=0) < 0:
            return self.device.index_select(0, device_constants.constant(rows.reshape(-1), self.device.device))
        view = self.device.as_strided(grid + (2,), tuple(2 * st for st in steps) + (1,),
                                      self.device.storage_offset() + 2 * r0)
        return view.reshape(-1, 2).contiguous()


_HOISTED: contextvars.ContextVar = contextvars.ContextVar("philox_hoisted_keys", default=None)


@contextlib.contextmanager
def hoisted(table: Optional[HoistedKeys]):
    """Within this block every key comes from *table* (:func:`block_keys`)."""
    token = _HOISTED.set(table)
    try:
        yield table
    finally:
        _HOISTED.reset(token)


def block_keys(seeds):
    """The keys of *seeds*: rows of the hoisted table inside :func:`hoisted`
    (a device tensor), else :func:`philox_keys` (a host array)."""
    table = _HOISTED.get()
    if table is not None:
        return table.lookup(seeds)
    return philox_keys(np.asarray(seeds).reshape(-1))


def philox_blocks(like: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Uniform blocks of *like*'s shape and dtype (float64 or float32) on its
    device, one for each seed: *seeds* is an int64 tensor of shape
    ``batch + (1,) * like.ndim`` on the CPU (an offsets chunk and its batch
    axes); the result has shape ``batch + like.shape``. Block ``b`` is
    numpy's ``Philox(seed=seeds[b]).random(like.shape)``, rounded to float32
    for a float32 *like*. One :func:`philox_uniform_blocks` launch on a CUDA
    device."""
    return _philox_blocks_op(like, seeds)


@torch.library.custom_op("cubed_tpu_torch::philox_blocks", mutates_args=())
def _philox_blocks_op(like: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    block, batch = _blocks_shape(like, seeds)
    n, size = math.prod(batch), math.prod(block)
    keys = block_keys(seeds.detach().cpu().numpy().reshape(batch))
    # a block's stream fills it in C order, so each block is one row of an
    # (n, size) grid of (1, size) blocks, whatever the block's rank
    out = torch.empty((n, size), dtype=like.dtype, device=like.device)
    philox_uniform_blocks(out, (1, size), keys)
    return out.reshape(batch + block)


def _blocks_shape(like: torch.Tensor, seeds: torch.Tensor) -> tuple:
    """(block shape, batch shape) of a :func:`philox_blocks` call."""
    block = tuple(like.shape)
    batch = tuple(seeds.shape[: seeds.ndim - like.ndim])
    if seeds.ndim < like.ndim or any(n != 1 for n in seeds.shape[len(batch):]):
        raise ValueError(f"philox_blocks: seeds of shape {tuple(seeds.shape)} for blocks of {block}")
    if like.dtype not in DTYPES:
        raise ValueError(f"philox_blocks makes float64 or float32 blocks, not {like.dtype}")
    return block, batch


@_philox_blocks_op.register_fake
def _philox_blocks_fake(like, seeds):
    # the output's metadata alone, for a trace on meta tensors
    block, batch = _blocks_shape(like, seeds)
    return like.new_empty(batch + block)


@torch.library.register_vmap("cubed_tpu_torch::philox_blocks")
def _philox_blocks_vmap(info, in_dims, like, seeds):
    """The batching rule: every block of a bucket has one shape, so a batched
    *like* is read at index 0; the seeds' batch axis becomes the output's.
    Nested levels stack up, and the bottom call fills every block of the
    bucket in one launch."""
    like_d, seeds_d = in_dims
    if like_d is not None:
        like = like.select(like_d, 0)
    if seeds_d is None:
        return _philox_blocks_op(like, seeds), None
    return _philox_blocks_op(like, seeds.movedim(seeds_d, 0)), 0


_occupancies: dict = {}


def _occupancy(device, suffix: str = "f64") -> int:
    """CTAs of the batched kernel for outputs of *suffix* ("f64", "f32")
    that fit on one SM of *device* at once."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    n = _occupancies.get((index, suffix))
    if n is None:
        fn = getattr(_build.load("philox_uniform"), f"philox_uniform_blocks_occupancy_{suffix}")
        fn.restype = ctypes.c_int
        with torch.cuda.device(index):
            n = fn()
        if n <= 0:
            raise RuntimeError(f"philox_uniform_blocks: occupancy query failed ({n})")
        _occupancies[(index, suffix)] = n
    return n


@functools.cache
def _kernel(suffix: str):
    lib = _build.load("philox_uniform")
    fn = getattr(lib, f"philox_uniform_{suffix}")
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _blocks_kernel(suffix: str):
    fn = getattr(_build.load("philox_uniform"), f"philox_uniform_blocks_{suffix}")
    fn.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _limbs(v: int) -> tuple[int, int]:
    return (v >> 32) & _MASK32, v & _MASK32


def _mulhilo(m: int, hi: torch.Tensor, lo: torch.Tensor):
    """(hi, lo) 64-bit halves, as (hi1, hi0, lo1, lo0) 32-bit limbs, of the
    128-bit product of constant *m* and the 64-bit value (hi, lo). Every
    partial product of two 32-bit limbs wraps mod 2**64 in int64; masking
    recovers its bits exactly."""
    m1, m0 = _limbs(m)
    p00 = lo * m0
    p01 = lo * m1
    p10 = hi * m0
    p11 = hi * m1
    t = ((p00 >> 32) & _MASK32) + (p01 & _MASK32) + (p10 & _MASK32)
    r0 = p00 & _MASK32
    r1 = t & _MASK32
    t = (t >> 32) + ((p01 >> 32) & _MASK32) + ((p10 >> 32) & _MASK32) + (p11 & _MASK32)
    r2 = t & _MASK32
    r3 = ((t >> 32) + ((p11 >> 32) & _MASK32)) & _MASK32
    return r3, r2, r1, r0


def philox_uniform_plain(n: int, key: tuple[int, int], device="cpu", dtype=torch.float64) -> torch.Tensor:
    """The plain version: *n* uniforms of the Philox stream of *key*, as
    float64, or those doubles rounded to the nearest float32."""
    ncounters = (n + 3) // 4
    ctr = torch.arange(1, ncounters + 1, dtype=torch.int64, device=device)
    zero = torch.zeros_like(ctr)
    # four 64-bit counter words, each as (hi, lo) 32-bit limbs
    c = [[zero, ctr & _MASK32], [zero, zero], [zero, zero], [zero, zero]]
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + W0) & _MASK64
            k1 = (k1 + W1) & _MASK64
        hi0h, hi0l, lo0h, lo0l = _mulhilo(M0, *c[0])
        hi1h, hi1l, lo1h, lo1l = _mulhilo(M1, *c[2])
        k0h, k0l = _limbs(k0)
        k1h, k1l = _limbs(k1)
        c = [
            [hi1h ^ c[1][0] ^ k0h, hi1l ^ c[1][1] ^ k0l],
            [lo1h, lo1l],
            [hi0h ^ c[3][0] ^ k1h, hi0l ^ c[3][1] ^ k1l],
            [lo0h, lo0l],
        ]
    # (u >> 11) has 53 bits: exact in int64 and in float64
    words = [(h << 21) | (lo >> 11) for h, lo in c]
    u53 = torch.stack(words, dim=1).reshape(-1)[:n]
    return (u53.to(torch.float64) * (1.0 / 9007199254740992.0)).to(dtype)


def _chunkset(shape: tuple, chunks: tuple) -> tuple:
    return blockdims_from_blockshape(shape, chunks) if shape else ()


def philox_uniform_blocks_plain(out_shape, chunks, keys: np.ndarray, device="cpu",
                                dtype=torch.float64) -> torch.Tensor:
    """The plain version of :func:`philox_uniform_blocks`: each block built
    with :func:`philox_uniform_plain` and written into place."""
    out_shape = tuple(out_shape)
    out = torch.empty(out_shape, dtype=dtype, device=device)
    chunkset = _chunkset(out_shape, tuple(chunks))
    for b, idx in enumerate(itertools.product(*(range(len(c)) for c in chunkset))):
        sel = get_item(chunkset, idx) if out_shape else ()
        bshape = tuple(c[i] for c, i in zip(chunkset, idx))
        key = (int(keys[b, 0]), int(keys[b, 1]))
        out[sel] = philox_uniform_plain(math.prod(bshape), key, device=device, dtype=dtype).reshape(bshape)
    return out
