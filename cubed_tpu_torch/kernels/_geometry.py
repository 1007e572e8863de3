"""How the reduction kernels split their work: pure Python, no torch.

``fma_sum`` and ``region_sum`` (``csrc/fma_sum.cu``, ``csrc/region_sum.cu``)
read their inputs in place through their strides. Before each launch the
wrapper calls :func:`plan` with the inputs' shape, strides and addresses, and
the plan fixes everything the kernel does:

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

A position along up to four merged axes is found by dividing with a
precomputed multiplier (:func:`fast_divmod`, CUTLASS's ``FastDivmod``).
:func:`walk` replays a plan's assignment of elements to CTAs, threads and
steps, as the kernels do it, so the CPU tests can check that each element
is read exactly once.
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

    @property
    def paths(self) -> tuple:
        """The keys this launch counts in its wrapper's ``paths``."""
        return (self.layout, "vector" if self.vector > 1 else "scalar",
                "one_cta" if self.splits == 1 else "split")

    def params(self) -> list:
        """The kernels' geometry as the C entry points take it: for the kept
        then the reduced index, 4 sizes, 4 multipliers, 4 shifts and 4
        strides per input (right-aligned, padded with size 1, stride 0);
        then out_units, red_units, splits, per_split, outputs."""
        out = []
        for axes in (self.kept, self.reduced):
            pad = MAX_DIMS - len(axes.sizes)
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
    all). Raises ValueError when more than four merged axes are kept or
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
    if len(kept) > MAX_DIMS or len(red) > MAX_DIMS:
        raise ValueError(
            f"reduction kernels take at most {MAX_DIMS} kept and {MAX_DIMS} reduced axes after "
            f"merging, not {len(kept)} and {len(red)} (shape {tuple(shape)})")
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
        tickets=tickets,
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
