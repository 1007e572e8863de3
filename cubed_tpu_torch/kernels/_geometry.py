"""How the hand-written kernels split their work: pure Python, no torch.

``region_sum`` (``csrc/region_sum.cu``) reads its input in place through
its strides. Before each launch the wrapper calls :func:`plan` with the
input's shape, strides and address (the planner takes any number of inputs
of one shape), and the plan fixes everything the kernel does:

- **Merged axes.** Axes of size 1 are dropped, and neighbouring axes merge
  where every input is contiguous across them and both are reduced or both
  kept. A contiguous block becomes one axis; a block view of a larger array
  keeps its outer axes.
- **Layout.** ``rows`` when the innermost merged axis is reduced: each
  output sums a run of rows, its threads packed across them, so short rows
  leave no lane idle. ``columns`` when it is kept: each thread owns outputs
  along the innermost axis (coalesced loads) and walks the reduced axes.
- **Vector or scalar path.** 16-byte loads (``double2``, ``float4``,
  ``longlong2``) when the innermost axis has stride 1 in every input, its
  length is a multiple of the vector, and every other stride and every base
  address is 16-byte aligned; else one element a load. Positions along the
  innermost axis are then counted in *units* of one vector.
- **Splits.** The reduced units of each output go to ``splits`` CTAs of
  ``per_split`` units each. With one split a CTA writes its output
  directly; with more, each writes a partial and the CTA that draws the
  last ticket sums the partials in index order. An output of at most
  ``ONE_CTA_STEPS`` full CTA steps takes one CTA.
- **32-bit indices.** Every offset and count must fit a signed 32-bit int
  with room for a step; :func:`plan` raises otherwise.
- **Index width.** Kept and reduced positions each span up to four merged
  axes (``dims`` 4), or up to eight (``dims`` 8: a grid view of blocks,
  whose grid axes and kept in-block axes do not merge); the kernels are
  instantiated for both widths.

A position along the merged axes is found by dividing with a precomputed
multiplier (:func:`fast_divmod`, CUTLASS's ``FastDivmod``).
:func:`walk` replays a plan's assignment of elements to CTAs, threads and
steps, as the kernels do it, so the CPU tests can check that each element
is read exactly once.

``philox_uniform_blocks`` (``csrc/philox_uniform.cu``) writes every block
of a random array in one launch; :func:`blocks_plan` fixes its work items,
grid, per-axis divisors and store paths, and :func:`blocks_walk` replays
every store it makes. ``fma_sum_blocks`` (``csrc/fma_sum.cu``) sums every
block of a fused multiply-add reduction in one launch; :func:`fma_blocks_plan`
fixes its (block, tile) work items and load path, and :func:`fma_blocks_walk`
replays every load. :func:`index_fits` and :func:`fma_blocks_fit` say from
metadata alone whether a launch can index its inputs, so that the device
executor chooses a route before it runs anything.

The reduction kernels also take the grid views that the device executor's
batched route hands them under ``torch.func.vmap``: a bucket of blocks of a
resident array is one strided view (grid axes, then in-block axes) that
does not merge, so the grid axes stay kept axes of their own and the
in-block axes reduced ones (up to four of each).
"""

from __future__ import annotations

from dataclasses import dataclass

#: streaming multiprocessors of an H100 SXM (the wrappers pass the card's own)
SMS = 132
#: CTAs per SM the kernels are sized for (``__launch_bounds__(256, 2)``)
CTAS_PER_SM = 2
THREADS = 256
#: units a thread loads per input per step (kUnroll in csrc/reduce_common.cuh)
UNROLL = 4
#: a rows output of at most this many full CTA steps takes one CTA
ONE_CTA_STEPS = 2
#: a columns output reduces at least this many elements per split; at most
#: this many take one CTA
COL_MIN_SPLIT = 16
MAX_DIMS = 4
#: merged axes of a role the wide instantiation of the reduction kernels takes
MAX_INDEX_DIMS = 8
#: bound on every element offset and unit count (int32, less one step)
INDEX_LIMIT = 2**31 - 2**16


@dataclass(frozen=True)
class Axes:
    """Merged axes, outermost first: their sizes and each input's strides
    (in elements; the innermost in units when the path is the vector one)."""

    sizes: tuple
    strides: tuple  # one tuple of strides per input

    @property
    def count(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


@dataclass(frozen=True)
class Plan:
    layout: str  # "rows" or "columns"
    vector: int  # elements one load takes (1: scalar path)
    kept: Axes  # the output index (columns: innermost in units)
    reduced: Axes  # the reduced index (rows: innermost in units)
    outputs: int  # output elements
    out_units: int  # rows: outputs; columns: outputs / vector
    red_units: int  # rows: reduced elements / vector; columns: reduced elements
    threads: int
    splits: int
    per_split: int  # reduced units one CTA takes
    grid: int  # CTAs; 0 when there is no output
    partials: int  # partial sums written (0 with one split)
    tickets: int  # ticket counters used (0 with one split)
    dims: int = MAX_DIMS  # index width the kernels are instantiated for (4 or 8)

    @property
    def paths(self) -> tuple:
        """The keys this launch counts in its wrapper's ``paths``."""
        return (self.layout, "vector" if self.vector > 1 else "scalar",
                "one_cta" if self.splits == 1 else "split")

    def params(self) -> list:
        """The kernels' geometry as the C entry points take it: for the kept
        then the reduced index, ``dims`` sizes, multipliers, shifts and
        strides per input (right-aligned, padded with size 1, stride 0);
        then out_units, red_units, splits, per_split, outputs."""
        out = []
        for axes in (self.kept, self.reduced):
            pad = self.dims - len(axes.sizes)
            sizes = (1,) * pad + tuple(axes.sizes)
            out.extend(sizes)
            magic = [fast_divmod(s) for s in sizes]
            out.extend(m for m, _ in magic)
            out.extend(r for _, r in magic)
            for st in axes.strides:
                out.extend((0,) * pad + tuple(st))
        out.extend((self.out_units, self.red_units, self.splits, self.per_split, self.outputs))
        return out


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _ceil_log2(d: int) -> int:
    return (d - 1).bit_length()


def fast_divmod(d: int) -> tuple[int, int]:
    """(multiplier, shift) with ``i // d == umulhi(i, multiplier) >> shift``
    for every ``0 <= i < 2**31``; (0, 0) stands for d == 1."""
    if not 1 <= d < 2**31:
        raise ValueError(f"fast_divmod: divisor {d} out of range")
    if d == 1:
        return 0, 0
    p = 31 + _ceil_log2(d)
    return ((1 << p) + d - 1) // d, p - 32


def fast_div(i, d: int):
    """``i // d`` as the kernels compute it; *i* an int or an int64 tensor."""
    mul, shr = fast_divmod(d)
    if mul == 0:
        return i
    return ((i * mul) >> 32) >> shr


def merge_axes(shape, strides, reduced) -> tuple[list, list]:
    """Drop size-1 axes and merge neighbours that are contiguous in every
    input and share a role. Returns (axes, roles): each axis a (size,
    strides per input) pair, each role True for a reduced axis."""
    axes, roles = [], []
    for d, n in enumerate(shape):
        if n == 1:
            continue
        st = tuple(s[d] for s in strides)
        r = d in reduced
        if axes and roles[-1] == r and all(p == n * q for p, q in zip(axes[-1][1], st)):
            axes[-1] = (axes[-1][0] * n, st)
        else:
            axes.append((n, st))
            roles.append(r)
    return axes, roles


def _pow2_threads(units: int) -> int:
    t = 32
    while t < THREADS and t < units:
        t *= 2
    return t


def _split(units: int, want: int) -> tuple[int, int]:
    """(splits, per_split) for *units* cut into at most *want* pieces."""
    if units == 0:
        return 1, 0
    per = _ceil_div(units, max(1, want))
    return _ceil_div(units, per), per


def plan(shape, strides, ptrs, itemsize: int, axes=None, sms: int = SMS) -> Plan:
    """The geometry of one reduction launch.

    *shape* is the inputs' common shape, *strides* one stride tuple per input
    (in elements), *ptrs* their addresses, *axes* the reduced axes (None:
    all). Raises ValueError when more than eight merged axes are kept or
    reduced, or an offset does not fit 32 bits."""
    ndim = len(shape)
    reduced = set(range(ndim)) if axes is None else {a % ndim for a in axes} if ndim else set()
    n_in = len(strides)
    outputs = 1
    for d in range(ndim):
        if d not in reduced:
            outputs *= shape[d]
    total = 1
    for n in shape:
        total *= n
    merged, roles = merge_axes(shape, strides, reduced) if total else ([], [])
    kept = [a for a, r in zip(merged, roles) if not r]
    red = [a for a, r in zip(merged, roles) if r]
    if len(kept) > MAX_INDEX_DIMS or len(red) > MAX_INDEX_DIMS:
        raise ValueError(
            f"reduction kernels take at most {MAX_INDEX_DIMS} kept and {MAX_INDEX_DIMS} reduced axes "
            f"after merging, not {len(kept)} and {len(red)} (shape {tuple(shape)})")
    dims = MAX_DIMS if max(len(kept), len(red)) <= MAX_DIMS else MAX_INDEX_DIMS
    for k in range(n_in):
        reach = sum((n - 1) * st[k] for n, st in merged)
        if reach >= INDEX_LIMIT or any(st[k] < 0 for _, st in merged):
            raise ValueError(f"reduction kernels index in 32 bits: input {k} reaches "
                             f"element offset {reach}, past {INDEX_LIMIT}")
    if total >= INDEX_LIMIT or outputs >= INDEX_LIMIT:
        raise ValueError(f"reduction kernels count in 32 bits: {total} elements is too many")
    layout = "columns" if roles and not roles[-1] else "rows"

    vector = 16 // itemsize
    inner = merged[-1] if merged else None
    if not (
        total and inner is not None and vector > 1 and inner[0] % vector == 0
        and all(s == 1 for s in inner[1])
        and all(st * itemsize % 16 == 0 for _, sts in merged[:-1] for st in sts)
        and all(p % 16 == 0 for p in ptrs)
    ):
        vector = 1
    if vector > 1:  # count the innermost axis in vectors, stepping a vector's elements
        inner = (inner[0] // vector, tuple(vector for _ in range(n_in)))
        if layout == "columns":
            kept[-1] = inner
        else:
            red[-1] = inner

    def as_axes(lst):
        return Axes(tuple(n for n, _ in lst), tuple(tuple(st[k] for _, st in lst) for k in range(n_in)))

    kept_axes, red_axes = as_axes(kept), as_axes(red)
    red_units = red_axes.count if total else 0
    want = CTAS_PER_SM * sms
    if layout == "rows":
        out_units = outputs
        if red_units <= ONE_CTA_STEPS * THREADS * UNROLL:
            splits, per_split = _split(red_units, 1)
            threads = _pow2_threads(_ceil_div(red_units, UNROLL))
        else:
            splits, per_split = _split(red_units, min(_ceil_div(want, outputs),
                                                      _ceil_div(red_units, THREADS * UNROLL)))
            threads = THREADS
        grid = outputs * splits
        tickets = outputs if splits > 1 else 0
    else:
        out_units = outputs // vector
        threads = _pow2_threads(out_units)
        tiles = _ceil_div(out_units, threads)
        if red_units <= COL_MIN_SPLIT:
            splits, per_split = _split(red_units, 1)
        else:
            splits, per_split = _split(red_units, min(_ceil_div(want, tiles),
                                                      _ceil_div(red_units, COL_MIN_SPLIT)))
        grid = tiles * splits
        tickets = tiles if splits > 1 else 0
    return Plan(
        layout=layout, vector=vector, kept=kept_axes, reduced=red_axes, outputs=outputs,
        out_units=out_units, red_units=red_units, threads=threads, splits=splits,
        per_split=per_split, grid=grid, partials=outputs * splits if splits > 1 else 0,
        tickets=tickets, dims=dims,
    )


def _offsets(torch, axes: Axes, index, k: int):
    """Element offsets, in input *k*, of positions *index* (int64 tensor)
    of *axes*: innermost first, each coordinate by fast division."""
    off = torch.zeros_like(index)
    i = index
    for n, st in zip(reversed(axes.sizes), reversed(axes.strides[k])):
        q = fast_div(i, n)
        off = off + (i - q * n) * st
        i = q
    return off


def walk(torch, p: Plan, n_inputs: int = 1):
    """Replay *p* as the kernels run it: the elements each CTA's threads
    load, step by step. Returns (output element index, element offsets of
    each input), one entry per element read, as int64 tensors.

    rows: CTA ``b`` takes output ``b // splits`` and reduced units
    ``[s * per_split, min((s + 1) * per_split, red_units))`` of it, ``s = b %
    splits``; its thread ``t`` loads units ``begin + t + k * threads * UNROLL
    + u * threads``. columns: CTA ``b`` takes output units ``tile * threads +
    t`` of tile ``b // splits`` and reduced positions ``begin + k * UNROLL +
    u`` of its split. A unit is ``vector`` consecutive elements."""
    i64 = torch.int64
    if p.grid == 0 or p.red_units == 0:
        return torch.zeros(0, dtype=i64), [torch.zeros(0, dtype=i64) for _ in range(n_inputs)]
    cta = torch.arange(p.grid, dtype=i64)
    s = cta % p.splits
    begin = s * p.per_split
    end = torch.clamp(begin + p.per_split, max=p.red_units)
    t = torch.arange(p.threads, dtype=i64)
    u = torch.arange(UNROLL, dtype=i64)
    if p.layout == "rows":
        m = cta // p.splits
        steps = _ceil_div(p.per_split, p.threads * UNROLL)
        k = torch.arange(steps, dtype=i64)
        unit = (begin[:, None, None, None] + t[None, :, None, None]
                + k[None, None, :, None] * p.threads * UNROLL + u[None, None, None, :] * p.threads)
        live = unit < end[:, None, None, None]
        out_unit = m[:, None, None, None].expand_as(unit)[live]
        red_unit = unit[live]
    else:
        tile = cta // p.splits
        o = tile[:, None] * p.threads + t[None, :]
        steps = _ceil_div(p.per_split, UNROLL)
        k = torch.arange(steps, dtype=i64)
        pos = begin[:, None, None, None] + k[None, None, :, None] * UNROLL + u[None, None, None, :]
        shape = (p.grid, p.threads, steps, UNROLL)
        live = (o[:, :, None, None] < p.out_units) & (pos < end[:, None, None, None])
        out_unit = o[:, :, None, None].expand(shape)[live]
        red_unit = pos.expand(shape)[live]
    lane = torch.arange(p.vector, dtype=i64)
    offsets = []
    for kk in range(n_inputs):
        off = _offsets(torch, p.kept, out_unit, kk) + _offsets(torch, p.reduced, red_unit, kk)
        offsets.append((off[:, None] + lane[None, :]).reshape(-1))
    if p.layout == "columns":
        out_elem = (out_unit[:, None] * p.vector + lane[None, :]).reshape(-1)
    else:
        out_elem = out_unit[:, None].expand(-1, p.vector).reshape(-1)
    return out_elem, offsets


# ---------------------------------------------------------------------------
# philox_uniform_blocks: every block of a random op in one launch
# ---------------------------------------------------------------------------

#: threads of a CTA and counters a thread takes per work item (kThreads and
#: kCounters in csrc/philox_uniform.cu)
PHILOX_THREADS = 256
PHILOX_COUNTERS = 4
#: counters one work item takes
PHILOX_TILE = PHILOX_THREADS * PHILOX_COUNTERS
#: CTAs per SM assumed when the card's occupancy is not given
#: (``__launch_bounds__(256, 3)``)
PHILOX_CTAS_PER_SM = 3


@dataclass(frozen=True)
class BlocksPlan:
    """How ``philox_uniform_blocks`` covers a regular block grid. Axes are
    padded in front to ``MAX_DIMS`` (size 1, stride 0); each divisor is kept
    with its fast-division multiplier as ``(d, multiplier, shift)``.

    Work item ``i`` is tile ``i % per_block`` of block ``i // per_block``
    (blocks in C order of the grid): its thread ``t`` takes the block's
    counters ``tile * PHILOX_TILE + k * PHILOX_THREADS + t`` for ``k <
    PHILOX_COUNTERS`` that are below the block's own count. A block is
    ``chunks`` along an axis, or ``edges`` when it is the last block there."""

    strides: tuple  # output strides, in elements (0 on a size-1 axis)
    chunks: tuple  # (d, mul, shr) per axis: a full block's extent
    edges: tuple  # (d, mul, shr) per axis: the last block's extent
    numblocks: tuple  # (d, mul, shr) per axis: blocks along it
    per_block: tuple  # (d, mul, shr): work items per block
    items: int
    grid: int  # persistent CTAs; 0 when there is nothing to write
    vector_full: bool  # blocks not last along the last axis: 16-byte stores
    vector_edge: bool  # the last block along the last axis: 16-byte stores

    @property
    def paths(self) -> tuple:
        """The store paths some block of this launch takes."""
        several = self.numblocks[-1][0] > 1
        taken = []
        if (several and self.vector_full) or self.vector_edge:
            taken.append("vector")
        if (several and not self.vector_full) or not self.vector_edge:
            taken.append("scalar")
        return tuple(taken)

    def params(self) -> list:
        """The plan as ``philox_uniform_blocks_f64`` takes it: 4 strides;
        (d, mul, shr) per axis for the chunks, edges and block counts; then
        per_block as (d, mul, shr), items, vector_full, vector_edge."""
        out = list(self.strides)
        for divs in (self.chunks, self.edges, self.numblocks):
            for div in divs:
                out.extend(div)
        out.extend(self.per_block)
        out.extend((self.items, int(self.vector_full), int(self.vector_edge)))
        return out


def _div(d: int) -> tuple:
    return (d, *fast_divmod(d))


def blocks_fit(shape) -> bool:
    """Whether one launch can fill a C-contiguous array of *shape*: rank 4
    or less, and every element offset in 32 bits."""
    n = 1
    for s in shape:
        n *= s
    return len(shape) <= MAX_DIMS and n < INDEX_LIMIT


def blocks_plan(shape, strides, chunks, ptr: int, sms: int = SMS,
                ctas_per_sm: int = PHILOX_CTAS_PER_SM, itemsize: int = 8) -> BlocksPlan:
    """The geometry of one ``philox_uniform_blocks`` launch filling the
    float64 (*itemsize* 8) or float32 (4) array of *shape* and *strides*
    (elements) at address *ptr*, blocked by the regular *chunks*. Raises
    ValueError past four axes or when an offset does not fit 32 bits."""
    ndim = len(shape)
    if ndim > MAX_DIMS or len(chunks) != ndim or len(strides) != ndim:
        raise ValueError(f"philox_uniform_blocks takes rank {MAX_DIMS} or less with a chunk and a "
                         f"stride per axis: shape {tuple(shape)}, chunks {tuple(chunks)}")
    pad = MAX_DIMS - ndim
    shape = (1,) * pad + tuple(shape)
    chunks = (1,) * pad + tuple(min(c, s) if s else 0 for c, s in zip(chunks, shape[pad:]))
    strides = tuple(0 if s == 1 else st for s, st in zip(shape, (0,) * pad + tuple(strides)))
    total = 1
    for s in shape:
        total *= s
    if total == 0:
        one = _div(1)
        return BlocksPlan(strides=strides, chunks=(one,) * MAX_DIMS, edges=(one,) * MAX_DIMS,
                          numblocks=(one,) * MAX_DIMS, per_block=one, items=0, grid=0,
                          vector_full=False, vector_edge=False)
    if any(c <= 0 for c in chunks) or any(st < 0 for st in strides):
        raise ValueError(f"philox_uniform_blocks: chunks {chunks} and strides {strides} must be positive")
    nb = tuple(_ceil_div(s, c) for s, c in zip(shape, chunks))
    edges = tuple(s - (n - 1) * c for s, c, n in zip(shape, chunks, nb))
    reach = sum((s - 1) * st for s, st in zip(shape, strides))
    largest = 1
    for c in chunks:
        largest *= c
    blocks = 1
    for n in nb:
        blocks *= n
    per_block = _ceil_div(_ceil_div(largest, 4), PHILOX_TILE)
    items = blocks * per_block
    if reach >= INDEX_LIMIT or largest >= INDEX_LIMIT or items >= INDEX_LIMIT:
        raise ValueError(f"philox_uniform_blocks indexes in 32 bits: shape {shape[pad:]} with strides "
                         f"{strides[pad:]} reaches element offset {reach}, past {INDEX_LIMIT}")
    # 16-byte stores: a counter's four words in one row, 16-byte aligned
    # (two double2 stores, or one float4): every row and block origin a
    # multiple of `per16` elements from a 16-byte aligned address
    per16 = 16 // itemsize
    aligned = ptr % 16 == 0 and (shape[-1] == 1 or strides[-1] == 1) and all(st % per16 == 0 for st in strides[:-1])
    return BlocksPlan(
        strides=strides,
        chunks=tuple(_div(c) for c in chunks),
        edges=tuple(_div(e) for e in edges),
        numblocks=tuple(_div(n) for n in nb),
        per_block=_div(per_block),
        items=items,
        grid=min(items, max(1, ctas_per_sm) * sms),
        vector_full=aligned and chunks[-1] % 4 == 0,
        vector_edge=aligned and edges[-1] % 4 == 0 and (nb[-1] - 1) * chunks[-1] % per16 == 0,
    )


def _quot(i, div):
    """``i // d`` by the multiplier of ``div = (d, mul, shr)``, as the kernel
    divides; *i* an int64 tensor."""
    _, mul, shr = div
    return i if mul == 0 else ((i * mul) >> 32) >> shr


def blocks_walk(torch, p: BlocksPlan):
    """Replay *p* as ``philox_blocks_kernel`` runs it: every store of every
    work item's threads. Returns (element offset, block, counter, word), one
    int64 tensor entry per element written."""
    i64 = torch.int64
    empty = torch.zeros(0, dtype=i64)
    if p.items == 0:
        return empty, empty, empty, empty
    item = torch.arange(p.items, dtype=i64)
    b = _quot(item, p.per_block)
    first = (item - b * p.per_block[0]) * PHILOX_TILE
    rest, n, base = b, torch.ones_like(b), torch.zeros_like(b)
    last_inner = None
    ext = [None] * MAX_DIMS  # per axis: (extent, whether the block is last there)
    for d in range(MAX_DIMS - 1, -1, -1):
        q = _quot(rest, p.numblocks[d]) if d else torch.zeros_like(rest)
        coord = rest - q * p.numblocks[d][0] if d else rest
        rest = q
        last = coord == p.numblocks[d][0] - 1
        if d == MAX_DIMS - 1:
            last_inner = last
        extent = torch.where(last, p.edges[d][0], p.chunks[d][0])
        ext[d] = (extent, last)
        n = n * extent
        base = base + coord * p.chunks[d][0] * p.strides[d]
    counters = (n + 3) >> 2
    vector = torch.where(last_inner, p.vector_edge, p.vector_full)
    t = torch.arange(PHILOX_THREADS, dtype=i64)
    k = torch.arange(PHILOX_COUNTERS, dtype=i64)
    c = first[:, None, None] + k[None, :, None] * PHILOX_THREADS + t[None, None, :]
    live = c < counters[:, None, None]
    row = torch.arange(p.items, dtype=i64)[:, None, None].expand_as(c)[live]
    c = c[live]

    def local_offset(e, row):
        off = torch.zeros_like(e)
        for d in range(MAX_DIMS - 1, 0, -1):
            extent, last = ext[d][0][row], ext[d][1][row]
            q = torch.where(last, _quot(e, p.edges[d]), _quot(e, p.chunks[d]))
            off = off + (e - q * extent) * p.strides[d]
            e = q
        return off + e * p.strides[0]

    offsets, blocks_out, counters_out, words = [], [], [], []
    vec = vector[row]
    # vector stores: one unravel, the four words at consecutive offsets
    cv, rv = c[vec], row[vec]
    start = base[rv] + local_offset(4 * cv, rv)
    for j in range(4):
        offsets.append(start + j)
        blocks_out.append(b[rv])
        counters_out.append(cv)
        words.append(torch.full_like(cv, j))
    # scalar stores: each word at its own unravelled position
    cs, rs = c[~vec], row[~vec]
    for j in range(4):
        e = 4 * cs + j
        keep = e < n[rs]
        e, rj, cj = e[keep], rs[keep], cs[keep]
        offsets.append(base[rj] + local_offset(e, rj))
        blocks_out.append(b[rj])
        counters_out.append(cj)
        words.append(torch.full_like(cj, j))
    return tuple(torch.cat(x) for x in (offsets, blocks_out, counters_out, words))


# ---------------------------------------------------------------------------
# fma_sum_blocks: every block of a fused multiply-add reduction in one launch
# ---------------------------------------------------------------------------

#: units (elements, or 16-byte vectors on the vector path) one work item of
#: ``fma_sum_blocks`` sums: THREADS threads, UNROLL loads each, 4 steps
FMA_TILE = THREADS * UNROLL * 4


@dataclass(frozen=True)
class FmaBlocksPlan:
    """How ``fma_sum_blocks`` covers the block grid of four equal-shaped
    inputs. Axes are padded in front to ``MAX_DIMS`` (size 1, stride 0);
    along the innermost axis extents and strides count *units* of
    ``vector`` elements. Each divisor is kept as ``(d, multiplier, shift)``.

    Work item ``i`` (one CTA) is tile ``i % per_block`` of block ``i //
    per_block`` (blocks in C order of the grid): it sums the block's units
    ``[tile * tile_units, (tile + 1) * tile_units)`` that exist, its thread
    ``t`` loading units ``begin + t + k * THREADS * UNROLL + u * THREADS``.
    A block is ``chunks`` along an axis, or ``edges`` where it is the last
    block there. With ``per_block > 1`` each item writes a partial and the
    CTA that draws its block's last ticket sums the block's partials in
    tile order."""

    vector: int
    chunks: tuple  # (d, mul, shr) per axis: a full block's extent, in units
    edges: tuple  # (d, mul, shr) per axis: the last block's extent, in units
    numblocks: tuple  # (d, mul, shr) per axis: blocks along it
    strides: tuple  # per input, 4 strides (innermost in units of `vector` elements)
    per_block: tuple  # (d, mul, shr): work items per block
    tile_units: int
    items: int  # work items, one CTA each; 0 when there is nothing to read
    blocks: int

    @property
    def paths(self) -> tuple:
        """The keys this launch counts in ``fma_sum_blocks.paths``."""
        return ("vector" if self.vector > 1 else "scalar", "one_cta" if self.per_block[0] == 1 else "split")

    def params(self) -> list:
        """The plan as ``fma_sum_blocks`` (csrc/fma_sum.cu) takes it: (d,
        mul, shr) per axis for the chunks, edges and block counts; 4 strides
        per input; per_block as (d, mul, shr); tile_units, items."""
        out = []
        for divs in (self.chunks, self.edges, self.numblocks):
            for div in divs:
                out.extend(div)
        for st in self.strides:
            out.extend(st)
        out.extend(self.per_block)
        out.extend((self.tile_units, self.items))
        return out


def index_fits(shape, strides) -> bool:
    """Whether 32-bit indices reach every element of tensors of *shape* with
    *strides* (one tuple per tensor, in elements): the element count and
    each tensor's furthest offset below ``INDEX_LIMIT``, no negative stride."""
    total = 1
    for n in shape:
        total *= n
    return total < INDEX_LIMIT and all(
        min(st, default=0) >= 0 and sum((n - 1) * s for n, s in zip(shape, st)) < INDEX_LIMIT
        for st in strides)


def _fma_blocks_error(shape, strides, chunks):
    """Why one ``fma_sum_blocks`` launch cannot take four inputs of *shape*
    and *strides* blocked by *chunks*, or None when it can."""
    if len(shape) > MAX_DIMS or len(chunks) != len(shape) or any(len(s) != len(shape) for s in strides):
        return (f"fma_sum_blocks takes rank {MAX_DIMS} or less with a chunk and a stride per axis: "
                f"shape {tuple(shape)}, chunks {tuple(chunks)}")
    if not index_fits(shape, strides):
        return f"fma_sum_blocks indexes in 32 bits: shape {tuple(shape)} with strides {list(strides)}"
    blocks = largest = 1
    for n, c in zip(shape, chunks):
        c = max(1, min(c, n))
        blocks *= _ceil_div(n, c)
        largest *= c
    if blocks * _ceil_div(largest, THREADS * UNROLL) >= INDEX_LIMIT:  # the most work items any tiling makes
        return f"fma_sum_blocks counts in 32 bits: {blocks} blocks of {largest} elements"
    return None


def fma_blocks_fit(shape, strides, chunks) -> bool:
    """Whether :func:`fma_blocks_plan` takes these inputs (checked from
    metadata before a route is chosen)."""
    return _fma_blocks_error(shape, strides, chunks) is None


def fma_blocks_plan(shape, strides, chunks, ptrs, itemsize: int, tile_units: int = FMA_TILE,
                    sms: int = SMS) -> FmaBlocksPlan:
    """The geometry of one ``fma_sum_blocks`` launch over four inputs of
    *shape*, with *strides* (one tuple per input, in elements) and addresses
    *ptrs*, blocked by the regular *chunks* (the last block along an axis
    may be shorter). A block takes tiles of at most *tile_units*; when the
    grid has too few blocks to fill ``CTAS_PER_SM * sms`` CTAs, its tiles
    shrink (to no less than one CTA step) so that it does. Raises
    ValueError past four axes or when an offset does not fit 32 bits."""
    error = _fma_blocks_error(shape, strides, chunks)
    if error is not None:
        raise ValueError(error)
    ndim = len(shape)
    pad = MAX_DIMS - ndim
    shape = (1,) * pad + tuple(shape)
    chunks = (1,) * pad + tuple(max(1, min(c, s)) for c, s in zip(chunks, shape[pad:]))
    strides = [tuple(0 if n == 1 else st for n, st in zip(shape, (0,) * pad + tuple(s))) for s in strides]
    nb = tuple(_ceil_div(s, c) for s, c in zip(shape, chunks))
    edges = tuple(s - (n - 1) * c for s, c, n in zip(shape, chunks, nb))
    total = 1
    for s in shape:
        total *= s
    blocks = 1
    for n in nb:
        blocks *= n
    vector = 16 // itemsize
    if not (
        total and vector > 1 and shape[-1] > 1
        and chunks[-1] % vector == 0 and edges[-1] % vector == 0
        and all(s[-1] == 1 for s in strides)
        and all(st % vector == 0 for s in strides for st in s[:-1])
        and all(p % 16 == 0 for p in ptrs)
    ):
        vector = 1
    if vector > 1:  # count the innermost axis in vectors of `vector` elements
        chunks = chunks[:-1] + (chunks[-1] // vector,)
        edges = edges[:-1] + (edges[-1] // vector,)
        strides = [s[:-1] + (vector,) for s in strides]
    largest = 1
    for c in chunks:
        largest *= c
    want = CTAS_PER_SM * sms
    if blocks * _ceil_div(largest, tile_units) < want:
        step = THREADS * UNROLL
        tile_units = min(tile_units, max(step, _ceil_div(_ceil_div(largest, _ceil_div(want, blocks)), step) * step))
    per_block = max(1, _ceil_div(largest, tile_units))
    items = blocks * per_block if total else 0
    if items >= INDEX_LIMIT:
        raise ValueError(f"fma_sum_blocks counts in 32 bits: {items} work items of blocks of {largest} units")
    return FmaBlocksPlan(
        vector=vector, chunks=tuple(_div(c) for c in chunks), edges=tuple(_div(e) for e in edges),
        numblocks=tuple(_div(n) for n in nb), strides=tuple(tuple(s) for s in strides),
        per_block=_div(per_block), tile_units=tile_units, items=items, blocks=blocks,
    )


def fma_blocks_walk(torch, p: FmaBlocksPlan, n_inputs: int = 4):
    """Replay *p* as ``fma_blocks_kernel`` runs it: every load of every work
    item's threads. Returns (block of each element read, work item, element
    offsets of each input), int64 tensors with one entry per element."""
    i64 = torch.int64
    empty = torch.zeros(0, dtype=i64)
    if p.items == 0:
        return empty, empty, [empty for _ in range(n_inputs)]
    item = torch.arange(p.items, dtype=i64)
    b = _quot(item, p.per_block)
    tile = item - b * p.per_block[0]
    rest, units = b, torch.ones_like(b)
    base = [torch.zeros_like(b) for _ in range(n_inputs)]
    ext = [None] * MAX_DIMS
    for d in range(MAX_DIMS - 1, -1, -1):
        q = _quot(rest, p.numblocks[d]) if d else torch.zeros_like(rest)
        coord = rest - q * p.numblocks[d][0] if d else rest
        rest = q
        last = coord == p.numblocks[d][0] - 1
        ext[d] = (torch.where(last, p.edges[d][0], p.chunks[d][0]), last)
        units = units * ext[d][0]
        for k in range(n_inputs):
            base[k] = base[k] + coord * p.chunks[d][0] * p.strides[k][d]
    begin = tile * p.tile_units
    end = torch.minimum(begin + p.tile_units, units)
    steps = _ceil_div(p.tile_units, THREADS * UNROLL)
    t = torch.arange(THREADS, dtype=i64)
    k = torch.arange(steps, dtype=i64)
    u = torch.arange(UNROLL, dtype=i64)
    unit = (begin[:, None, None, None] + t[None, :, None, None]
            + k[None, None, :, None] * THREADS * UNROLL + u[None, None, None, :] * THREADS)
    live = unit < end[:, None, None, None]
    row = item[:, None, None, None].expand_as(unit)[live]
    j = unit[live]
    coords = [None] * MAX_DIMS
    for d in range(MAX_DIMS - 1, 0, -1):
        extent, last = ext[d][0][row], ext[d][1][row]
        q = torch.where(last, _quot(j, p.edges[d]), _quot(j, p.chunks[d]))
        coords[d] = j - q * extent
        j = q
    coords[0] = j
    lane = torch.arange(p.vector, dtype=i64)
    offsets = []
    for kk in range(n_inputs):
        off = base[kk][row] + sum(coords[d] * p.strides[kk][d] for d in range(MAX_DIMS))
        offsets.append((off[:, None] + lane[None, :]).reshape(-1))
    blocks = b[row][:, None].expand(-1, p.vector).reshape(-1)
    items = row[:, None].expand(-1, p.vector).reshape(-1)
    return blocks, items, offsets


# ---------------------------------------------------------------------------
# sort_block / argsort_block: a tile sort in shared memory, then merge passes
# ---------------------------------------------------------------------------

#: outputs a thread of the sort kernels merges at a time (``kItems`` in
#: csrc/merge_sort.cu); a tile is at least this long
SORT_ITEMS = 8
#: dynamic shared memory one CTA may have on an H100
SORT_SMEM_LIMIT = 232448
#: shared memory a tile is sized to: two CTAs an SM (228 KB an SM, less
#: 1 KB the runtime keeps a CTA)
SORT_SMEM_TARGET = 233472 // 2 - 1024
#: the sort kernels' modes: values; values with carried int64 indices (the
#: pair (value, index) the key); argsort (int64 positions out)
SORT_MODES = {"values": 0, "pairs": 1, "argsort": 2}
#: most CTAs of one sort launch (each takes work items grid-stride past it)
SORT_MAX_GRID = 1 << 20


def _round16(nbytes: int) -> int:
    return _ceil_div(nbytes, 16) * 16


#: the shared-memory regions of a sort kernel's CTA whose byte offsets the
#: kernels take (``Regions`` in csrc/merge_sort.cu); the carried indices are
#: at 0
SORT_REGIONS = ("vals", "pos", "ord0", "ord1", "splits")


def sort_layout(tile: int, lanes: int, itemsize: int, mode: int, kernel: str) -> tuple[tuple, int]:
    """One CTA's dynamic shared memory for *kernel* (``tile`` or
    ``merge``): the byte offsets of ``SORT_REGIONS`` and the bytes in all,
    each region rounded up to 16 bytes: the carried indices (pairs; lanes of
    ``tile + 1``), the values (lanes of ``tile + 1``: neighbouring lanes fall
    in other banks); for the tile sort two order buffers of uint16 positions
    (lanes of ``tile + 2``); for a merge pass, argsort's int32 positions, one
    order buffer (``ord0`` and ``ord1`` the same) and each lane's two splits
    (int64). A region the kernel does not use starts where the next does."""
    vals = _round16(lanes * (tile + 1) * 8) if mode == SORT_MODES["pairs"] else 0
    pos = vals + _round16(lanes * (tile + 1) * itemsize)
    order = _round16(lanes * (tile + 2) * 2)
    if kernel == "tile":
        return (vals, pos, pos, pos + order, pos + 2 * order), pos + 2 * order
    ord0 = pos + (_round16(lanes * tile * 4) if mode == SORT_MODES["argsort"] else 0)
    return (vals, pos, ord0, ord0, ord0 + order), ord0 + order + _round16(2 * lanes * 8)


@dataclass(frozen=True)
class SortPlan:
    """How ``sort_block``/``argsort_block`` (csrc/merge_sort.cu) sort the
    lanes of a contiguous ``(outer, n, inner)`` tensor along ``n``.

    A work item (one CTA) is a *tile*: ``tile`` consecutive positions of
    ``lanes`` neighbouring lanes along ``inner`` (item ``b``: tile ``b %
    tiles_n`` along n of lane group ``b // tiles_n % lane_groups`` of outer
    index ``b // tiles_n // lane_groups``). The first launch sorts every
    tile in shared memory; a lane of at most ``tile`` elements is then
    sorted, written where it was read. A longer lane's tiles are written as
    sorted runs of ``tile`` into a buffer whose lanes are contiguous, and
    one merge pass per width in ``widths`` merges neighbouring runs of that
    width, each work item producing one tile of the merged pair of runs it
    lies in; the last pass writes the ``(outer, n, inner)`` layout.
    ``vector``: elements one load of the tile sort takes (16 bytes where a
    lane is contiguous and aligned, else 1)."""

    outer: int
    n: int
    inner: int
    itemsize: int
    mode: int
    tile: int
    lanes: int
    vector: int
    tiles_n: int
    lane_groups: int
    tiles: int  # work items of each launch; 0 when there is nothing to sort
    grid: int
    widths: tuple  # run width merged by each pass
    tile_smem: int
    merge_smem: int
    tile_regions: tuple  # the tile sort's SORT_REGIONS offsets (sort_layout)
    merge_regions: tuple  # a merge pass's; () without passes

    @property
    def launches(self) -> int:
        return (1 + len(self.widths)) if self.tiles else 0

    @property
    def smem(self) -> int:
        return max(self.tile_smem, self.merge_smem)


def _pow2_at_least(n: int) -> int:
    return 1 << _ceil_log2(max(1, n))


def sort_plan(outer: int, n: int, inner: int, itemsize: int, mode, ptr: int = 0) -> SortPlan:
    """The geometry of one ``sort_block``/``argsort_block`` call over a
    contiguous tensor of ``(outer, n, inner)`` lanes of *itemsize* bytes at
    address *ptr*; *mode* a name or code of ``SORT_MODES``.

    ``lanes``: a power of two, rows of at least 128 bytes (32 lanes at most)
    and no more than ``inner`` needs. ``tile``: the largest power of two
    from ``SORT_ITEMS`` up to what the lane needs whose shared memory fits
    ``SORT_SMEM_TARGET``: the tile sort's, and a merge pass's where the
    lane is longer than the tile. A float64 block of (512, 256, 256) along
    axis 0 is 4096 tiles of 512 x 16: one launch."""
    mode = SORT_MODES.get(mode, mode)
    if mode not in SORT_MODES.values():
        raise ValueError(f"sort_plan: mode {mode!r} is not one of {sorted(SORT_MODES)}")
    if n >= 2**31:
        raise ValueError(f"sort_plan: the kernels count positions along a lane in 32 bits, not {n}")
    lanes = min(max(1, 128 // itemsize), 32, _pow2_at_least(inner))
    tile = SORT_ITEMS
    while tile < n and max(sort_layout(2 * tile, lanes, itemsize, mode, k)[1]
                           for k in (("tile", "merge") if 2 * tile < n else ("tile",))) <= SORT_SMEM_TARGET:
        tile *= 2
    tiles_n = _ceil_div(n, tile)
    lane_groups = _ceil_div(inner, lanes)
    tiles = outer * lane_groups * tiles_n if outer * n * inner else 0
    widths, w = [], tile
    while w < n:
        widths.append(w)
        w *= 2
    vector = 16 // itemsize
    if not (inner == 1 and vector > 1 and ptr % 16 == 0 and (outer == 1 or (n * itemsize) % 16 == 0)
            and (tiles_n == 1 or (tile * itemsize) % 16 == 0)):
        vector = 1
    tile_regions, tile_smem = sort_layout(tile, lanes, itemsize, mode, "tile")
    merge_regions, merge_smem = sort_layout(tile, lanes, itemsize, mode, "merge") if widths else ((), 0)
    return SortPlan(
        outer=outer, n=n, inner=inner, itemsize=itemsize, mode=mode, tile=tile, lanes=lanes, vector=vector,
        tiles_n=tiles_n, lane_groups=lane_groups, tiles=tiles, grid=min(tiles, SORT_MAX_GRID),
        widths=tuple(widths if tiles else ()), tile_smem=tile_smem, merge_smem=merge_smem,
        tile_regions=tile_regions, merge_regions=merge_regions,
    )


def sort_walk(torch, p: SortPlan) -> list:
    """Replay *p* as the sort kernels run it: for the tile sort, then each
    merge pass, the work item that writes each element and the part of its
    lane the item sorts or merges. Returns one ``(offsets, items, starts,
    ends)`` tuple of int64 tensors per launch, an entry per element written:
    its offset in the ``(outer, n, inner)`` tensor, its work item, and the
    positions along n where the sorted tile (the tile sort) or the merged
    pair of runs (a pass) it lies in starts and ends."""
    i64 = torch.int64
    if not p.tiles:
        return []
    item = torch.arange(p.tiles, dtype=i64)
    kt = item % p.tiles_n
    rest = item // p.tiles_n
    lg = rest % p.lane_groups
    o = rest // p.lane_groups
    k0, l0 = kt * p.tile, lg * p.lanes
    tn = torch.clamp(p.n - k0, max=p.tile)
    cn = torch.clamp(p.inner - l0, max=p.lanes)
    k = torch.arange(p.tile, dtype=i64)
    c = torch.arange(p.lanes, dtype=i64)
    live = (k[None, :, None] < tn[:, None, None]) & (c[None, None, :] < cn[:, None, None])
    row = item[:, None, None].expand(-1, p.tile, p.lanes)[live]
    pos = (k0[:, None, None] + k[None, :, None]).expand(-1, -1, p.lanes)[live]
    lane = (l0[:, None, None] + c[None, None, :]).expand(-1, p.tile, -1)[live]
    offsets = (o[row] * p.n + pos) * p.inner + lane
    out = [(offsets, row, k0[row], k0[row] + tn[row])]
    for w in p.widths:
        start = pos // (2 * w) * (2 * w)
        out.append((offsets, row, start, torch.clamp(start + 2 * w, max=p.n)))
    return out
