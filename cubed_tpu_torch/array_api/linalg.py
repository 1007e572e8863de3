"""The ``linalg`` extension namespace of the Array API standard (2022.12).

Counterpart of ``cubed_tpu/array_api/linalg.py``, with the same plans:

- ``qr``, ``svd`` and ``svdvals`` of a 2-d array run TSQR (tall-skinny QR):
  stage 1 is one multi-output op writing each panel's Q block and its R
  factor, two outputs of different chunk sizes (``(c, n)`` and ``(n, n)``)
  on one block grid; stage 2 factors the stacked R in one task; stage 3
  forms Q, each panel times its rows of the inner Q, the rows picked by a
  device index (``index_select``) from the block's offset, so the op runs
  under ``torch.func.vmap`` and inside a captured segment. Rows may exceed
  ``allowed_mem``; panels never do.
- The square per-matrix ops (``cholesky``, ``inv``, ``solve``, ``det``,
  ``slogdet``, ``eigh``, ...) rechunk the last two axes to one chunk and run
  as gufuncs over the batch grid, one ``torch.linalg`` call per task (cuSOLVER
  and cuBLAS on the card), batched across a bucket of matrices by the device
  executor's vmapped route. ``slogdet`` and ``eigh`` are one multi-output op
  each.
- Failures give the JAX package's values, never an exception: ``cholesky``
  of a matrix that is not positive definite is NaN on and below the
  diagonal and 0 above it (``cholesky_ex``'s ``info``), the other matrices of
  the batch unaffected; ``inv`` and ``solve`` of a singular matrix are the
  LU's infinities (``inv_ex``, ``solve_ex``).
- No call synchronises the host inside a CUDA graph capture: the solvers use
  the ``_ex`` forms, which return ``info`` on the device. A real QR is
  Householder reflections and a real ``eigh``/``eigvalsh`` the Jacobi method,
  composed of torch operations (``_dense``: cuSOLVER's workspaces for them
  are many times a task's projected memory on the card, and its eigensolver
  checks ``info`` on the host). ``svd``, ``svdvals`` and complex
  ``eigh``/``eigvalsh`` call ``torch.linalg``, which checks their ``info`` on
  the host, so their block functions declare ``host_sync`` and a device
  segment holding one runs op by op.
- A 2-d ``cholesky`` too large for one task runs a blocked right-looking
  factorization over the chunk grid, assembled by one ``map_direct`` whose
  task bodies read their blocks as device views on the device executor.
- Norms, ``trace``, ``diagonal``, ``cross`` and ``matrix_power`` compose
  chunked primitives (reductions, elementwise, matmul).
"""

from __future__ import annotations

import math
from collections import namedtuple

import numpy as np
import torch

from ..backend_array_api import get_device, numpy_array_to_backend_array, nxp, to_torch_dtype
from ..core.gufunc import apply_gufunc
from ..core.ops import _offsets_array_for, block_index_from_offset, general_blockwise, rechunk
from ._dense import householder_qr, jacobi_eigh
from .creation_functions import asarray, eye
from .data_type_functions import astype, result_type
from .dtypes import _floating_dtypes, _numeric_dtypes, int64
from .dtypes import bool as xp_bool
from .elementwise_functions import _float_of
from .elementwise_functions import abs as xp_abs
from .elementwise_functions import greater, logical_and, multiply, sqrt, square, subtract
from .elementwise_functions import pow as xp_pow
from .linear_algebra_functions import (  # noqa: F401  (re-exported, as the standard asks)
    matmul,
    matrix_transpose,
    outer,
    tensordot,
    vecdot,
)
from .manipulation_functions import expand_dims, moveaxis, squeeze, stack
from .searching_functions import where
from .statistical_functions import max as xp_max
from .statistical_functions import min as xp_min
from .statistical_functions import sum as xp_sum
from .utility_functions import any as xp_any

__all__ = [
    "cholesky", "cross", "det", "diagonal", "eigh", "eigvalsh", "inv",
    "matmul", "matrix_norm", "matrix_power", "matrix_rank",
    "matrix_transpose", "outer", "pinv", "qr", "slogdet", "solve", "svd",
    "svdvals", "tensordot", "trace", "vecdot", "vector_norm",
]

QRResult = namedtuple("QRResult", ["Q", "R"])
SVDResult = namedtuple("SVDResult", ["U", "S", "Vh"])
EighResult = namedtuple("EighResult", ["eigenvalues", "eigenvectors"])
SlogdetResult = namedtuple("SlogdetResult", ["sign", "logabsdet"])


def _kernel(fn, name: str, host_sync: bool = False):
    """*fn* as a block function of its own: named, declared to run under
    ``torch.func.vmap``, and with *host_sync*, declared to synchronise the
    host (its segment on the card then runs op by op, never captured)."""

    def kernel(*blocks):
        return fn(*blocks)

    kernel.__name__ = name
    kernel.batchable = True
    if host_sync:
        kernel.host_sync = True
    return kernel


def _symmetrized(a):
    """``(a + a^H) / 2``, as the JAX package's solvers take their input."""
    return (a + a.mH) / 2


def _require_floating(x, fname):
    if x.dtype not in _floating_dtypes:
        raise TypeError(f"Only floating-point dtypes are allowed in {fname}")


def _require_square(x, fname):
    if x.ndim < 2 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"{fname} requires square matrices in the last two dimensions; got shape {x.shape}")


def _single_chunk_core(x, ncore=2):
    """*x* rechunked so that its last *ncore* axes are one chunk each (a
    gufunc's core)."""
    return rechunk(x, {ax: x.shape[ax] for ax in range(x.ndim - ncore, x.ndim)})


# ---------------------------------------------------------------------------
# TSQR (qr, svd, svdvals)
# ---------------------------------------------------------------------------


def _tsqr_row_chunks(x, n):
    """*x* rechunked by rows so that every row block has at least *n* rows and
    stage 2 (the QR of the ``(b*n, n)`` stacked R in one task) fits the
    memory budget."""
    m = x.shape[0]
    itemsize = x.dtype.itemsize
    allowed = x.spec.allowed_mem or (2**63)
    # stage 2's task holds the stacked R and its Q2 and R outputs: keep its
    # footprint well under the budget
    b_mem_cap = max(1, int(allowed // (8 * n * n * itemsize)))
    if all(c >= n for c in x.chunks[0]) and len(x.chunks[0]) <= b_mem_cap:
        return x
    for b in range(min(m // max(n, 1), b_mem_cap) or 1, 0, -1):
        c = math.ceil(m / b)
        last = m - (b - 1) * c
        if last >= n or b == 1:
            return rechunk(x, {0: c})
    return rechunk(x, {0: m})


def _per_matrix_multi(x, kernel, shapes, chunks, op_name, dtypes=None):
    """One multi-output op applying *kernel* to each core block of a
    single-chunk-core array over the batch grid: the decomposition runs once
    a matrix and feeds every output. The outputs share the batch grid (a
    missing core axis is padded to size 1 and squeezed by the caller)."""
    x_name = x.name

    def bf(out_key):
        return ((x_name, *out_key[1:]),)

    return general_blockwise(
        kernel, bf, x,
        shape=shapes,
        dtype=list(dtypes) if dtypes else [x.dtype] * len(shapes),
        chunks=chunks,
        op_name=op_name,
    )


def _batch_chunks(x, *core):
    """x's batch-axis chunks and the given core-axis sizes."""
    return tuple(x.chunks[:-2]) + tuple((c,) for c in core)


def _qr(a, want_q=True):
    """The reduced QR of a block: Householder reflections in torch operations
    for real dtypes (``_dense``: a few copies of the block, where cuSOLVER's
    geqrf peaks at 13 of a small panel), ``torch.linalg.qr`` for complex."""
    if a.is_complex():
        q, r = torch.linalg.qr(a)
        return (q, r) if want_q else r
    return householder_qr(a, want_q)


def _qr_r(a):
    return _qr(a, want_q=False)


def _stack_r(rs):
    return _qr(torch.cat(list(rs), dim=0), want_q=False)


def _tsqr_r(x):
    """The R factor alone (a one-output TSQR): the m x n Q panels are never
    formed or written, for consumers that drop Q (``svdvals``)."""
    m, n = x.shape
    dt = x.dtype
    if len(x.chunks[1]) > 1:
        x = rechunk(x, {1: n})
    x = _tsqr_row_chunks(x, n)
    b = len(x.chunks[0])
    x_name = x.name

    def bf_panel(out_key):
        return ((x_name, out_key[1], 0),)

    r1 = general_blockwise(
        _kernel(_qr_r, "tsqr_panel_r"), bf_panel, x,
        shape=(b * n, n),
        dtype=dt,
        chunks=((n,) * b, (n,)),
        op_name="tsqr_panel_r",
    )
    if b == 1:
        return r1
    r1_name = r1.name

    def bf_reduce(out_key):
        return ([(r1_name, i, 0) for i in range(b)],)

    return general_blockwise(
        _kernel(_stack_r, "tsqr_reduce_r"), bf_reduce, r1,
        shape=(n, n),
        dtype=dt,
        chunks=((n,), (n,)),
        num_input_blocks=(b,),
        extra_projected_mem=2 * (b - 1) * n * n * dt.itemsize,
        op_name="tsqr_reduce_r",
    )


def _qr_both(a):
    return _qr(a)


def _stack_qr(rs):
    return _qr(torch.cat(list(rs), dim=0))


class _ApplyQ:
    """Stage 3 of TSQR: a panel's Q1 block times its rows of Q2, the rows
    from the block's offset (``traced_offsets``: read as data, so a device
    tensor on the batched route) by a device index."""

    __name__ = "tsqr_apply_q"
    batchable = True
    traced_offsets = True

    def __init__(self, b, n):
        self.b, self.n = b, n

    def __call__(self, panel, q2_full, off):
        bi = block_index_from_offset(off, 0, (self.b, 1))
        rows = bi * self.n + torch.arange(self.n, device=q2_full.device)
        return nxp.matmul(panel, torch.index_select(q2_full, 0, rows))


def qr(x, /, *, mode="reduced"):
    """The reduced QR of a 2-d array by TSQR (rows may be chunked; columns
    are gathered to one chunk): the panels factor on their own, their stacked
    R factors once, and Q is formed blockwise; three ops, two of them
    multi-output. A stack of matrices factors matrix by matrix."""
    _require_floating(x, "qr")
    if mode != "reduced":
        raise NotImplementedError("qr currently supports mode='reduced' only")
    if x.ndim != 2:
        if x.ndim < 2:
            raise ValueError("qr requires at least 2 dimensions")
        mm, nn = x.shape[-2], x.shape[-1]
        k = min(mm, nn)
        xc = _single_chunk_core(x)
        batch = x.shape[:-2]
        q, r = _per_matrix_multi(
            xc, _kernel(_qr_both, "qr_batched"),
            shapes=[(*batch, mm, k), (*batch, k, nn)],
            chunks=[_batch_chunks(xc, mm, k), _batch_chunks(xc, k, nn)],
            op_name="qr_batched",
        )
        return QRResult(q, r)

    m, n = x.shape
    dt = x.dtype
    if len(x.chunks[1]) > 1:
        x = rechunk(x, {1: n})

    if m < n:
        # wide: one block's QR (Q (m, m), R (m, n)), one multi-output op
        x1 = rechunk(x, {0: m})

        def bf_single(out_key):
            return ((x1.name, 0, 0),)

        q, r = general_blockwise(
            _kernel(_qr_both, "qr_single"), bf_single, x1,
            shape=[(m, m), (m, n)],
            dtype=[dt, dt],
            chunks=[((m,), (m,)), ((m,), (n,))],
            op_name="qr_single",
        )
        return QRResult(q, r)

    x = _tsqr_row_chunks(x, n)
    row_chunks = x.chunks[0]
    b = len(row_chunks)
    x_name = x.name

    # stage 1: each panel's QR, one op, two outputs on one (b, 1) grid
    def bf_panel(out_key):
        return ((x_name, out_key[1], 0),)

    q1, r1 = general_blockwise(
        _kernel(_qr_both, "tsqr_panel"), bf_panel, x,
        shape=[(m, n), (b * n, n)],
        dtype=[dt, dt],
        chunks=[(row_chunks, (n,)), ((n,) * b, (n,))],
        op_name="tsqr_panel",
    )
    if b == 1:
        return QRResult(q1, r1)

    # stage 2: the QR of the stacked R factors, one task
    r1_name = r1.name

    def bf_reduce(out_key):
        return ([(r1_name, i, 0) for i in range(b)],)

    q2, r = general_blockwise(
        _kernel(_stack_qr, "tsqr_reduce"), bf_reduce, r1,
        shape=[(b * n, n), (n, n)],
        dtype=[dt, dt],
        chunks=[((b * n,), (n,)), ((n,), (n,))],
        num_input_blocks=(b,),
        extra_projected_mem=2 * (b - 1) * n * n * dt.itemsize,
        op_name="tsqr_reduce",
    )

    # stage 3: Q_i = Q1_i @ Q2[i*n:(i+1)*n]
    offsets = _offsets_array_for(q1)
    q1_name, q2_name, off_name = q1.name, q2.name, offsets.name

    def bf_apply(out_key):
        i = out_key[1]
        return ((q1_name, i, 0), (q2_name, 0, 0), (off_name, i, 0))

    q = general_blockwise(
        _ApplyQ(b, n), bf_apply, q1, q2, offsets,
        shape=(m, n),
        dtype=dt,
        chunks=(row_chunks, (n,)),
        op_name="tsqr_apply_q",
    )
    return QRResult(q, r)


def _svd_rows(a):
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    return u, s.reshape(1, -1), vh


def _svd_batched(a):
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    return u, s[..., None, :], vh


def svd(x, /, *, full_matrices=True):
    """The thin SVD. A 2-d array factors by TSQR and then one small SVD of
    R; a stack of matrices matrix by matrix."""
    _require_floating(x, "svd")
    if full_matrices:
        raise NotImplementedError(
            "svd currently computes the thin factorization only; pass full_matrices=False"
        )
    if x.ndim < 2:
        raise ValueError("svd requires at least 2 dimensions")
    k = min(x.shape[-2], x.shape[-1])
    if x.ndim > 2:
        mm, nn = x.shape[-2], x.shape[-1]
        xc = _single_chunk_core(x)
        batch = x.shape[:-2]
        u, s2d, vh = _per_matrix_multi(
            xc, _kernel(_svd_batched, "svd_batched", host_sync=True),
            shapes=[(*batch, mm, k), (*batch, 1, k), (*batch, k, nn)],
            chunks=[_batch_chunks(xc, mm, k), _batch_chunks(xc, 1, k), _batch_chunks(xc, k, nn)],
            op_name="svd_batched",
            dtypes=[x.dtype, _float_of(x.dtype), x.dtype],
        )
        return SVDResult(u, squeeze(s2d, axis=-2), vh)

    m, n = x.shape
    dt = x.dtype
    if m >= n:
        q, r = qr(x)
        r_name = r.name

        def bf_svd(out_key):
            return ((r_name, 0, 0),)

        u_r, s2d, vh = general_blockwise(
            _kernel(_svd_rows, "svd_of_r", host_sync=True), bf_svd, r,
            shape=[(n, n), (1, n), (n, n)],
            dtype=[dt, _float_of(dt), dt],
            chunks=[((n,), (n,)), ((1,), (n,)), ((n,), (n,))],
            op_name="svd_of_r",
        )
        return SVDResult(matmul(q, u_r), squeeze(s2d, axis=0), vh)

    # wide: one block's SVD
    x1 = rechunk(x, {0: m, 1: n})
    x1_name = x1.name

    def bf_wide(out_key):
        return ((x1_name, 0, 0),)

    u, s2d, vh = general_blockwise(
        _kernel(_svd_rows, "svd_single", host_sync=True), bf_wide, x1,
        shape=[(m, k), (1, k), (k, n)],
        dtype=[dt, _float_of(dt), dt],
        chunks=[((m,), (k,)), ((1,), (k,)), ((k,), (n,))],
        op_name="svd_single",
    )
    return SVDResult(u, squeeze(s2d, axis=0), vh)


def _svdvals(a):
    return torch.linalg.svdvals(a)


def svdvals(x, /):
    _require_floating(x, "svdvals")
    if x.ndim < 2:
        raise ValueError("svdvals requires at least 2 dimensions")
    m, n = x.shape[-2], x.shape[-1]
    k = min(m, n)
    if x.ndim == 2 and m >= n:
        # R-only TSQR: x's singular values are R's, and no Q panel is formed
        target = _tsqr_r(x)
    else:
        target = _single_chunk_core(x)
    return apply_gufunc(
        _kernel(_svdvals, "svdvals", host_sync=True), "(i,j)->(k)", target,
        output_dtypes=_float_of(x.dtype), output_sizes={"k": k},
    )


# ---------------------------------------------------------------------------
# Square per-matrix ops (gufuncs over the batch grid)
# ---------------------------------------------------------------------------


def _cholesky_lower(a):
    """The lower Cholesky factor of each matrix of *a*, with the JAX
    package's result where one is not positive definite: NaN on and below
    the diagonal, 0 above (``cholesky_ex``'s ``info``, on the device)."""
    lo, info = torch.linalg.cholesky_ex(_symmetrized(a))
    n = a.shape[-1]
    below = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    failed = torch.where(below, torch.full((), float("nan"), dtype=lo.dtype, device=a.device),
                         torch.zeros((), dtype=lo.dtype, device=a.device))
    return torch.where((info != 0)[..., None, None], failed, lo)


class _Cholesky:
    __name__ = "cholesky"
    batchable = True

    def __init__(self, upper: bool):
        self.upper = upper

    def __call__(self, a):
        lo = _cholesky_lower(a)
        if not self.upper:
            return lo
        return lo.mT.conj().resolve_conj() if lo.is_complex() else lo.mT


def cholesky(x, /, *, upper=False):
    """The Cholesky factorization. Stacks, and 2-d matrices that fit one
    task, run a per-matrix gufunc; a 2-d matrix too large for one task runs
    a blocked right-looking factorization over the chunk grid, a plan of
    panel steps whose every task holds only block-sized operands, so the
    matrix may exceed ``allowed_mem``."""
    _require_floating(x, "cholesky")
    _require_square(x, "cholesky")
    if x.ndim == 2:
        n = x.shape[-1]
        itemsize = np.dtype(x.dtype).itemsize
        allowed = x.spec.allowed_mem or (2**63)
        # the gufunc gathers the whole matrix into one task (about two input
        # and two output copies): blocked where that cannot fit
        if 5 * n * n * itemsize > allowed:
            lo = _blocked_cholesky(x)
            if not upper:
                return lo
            up = matrix_transpose(lo)
            if np.dtype(x.dtype).kind == "c":
                from .elementwise_functions import conj

                up = conj(up)
            return up
    return apply_gufunc(_Cholesky(upper), "(i,j)->(i,j)", _single_chunk_core(x), output_dtypes=x.dtype)


class _AssembleBlock:
    """The blocked Cholesky's assembly: output block (i, j) is its L block,
    or zeros above the diagonal. Reads tensors (``device_reads``): views of
    resident blocks on the device executor, chunks from storage elsewhere."""

    __name__ = "assemble_cholesky"
    device_reads = True

    def __init__(self, index_of, axis_chunks, dtype):
        self.index_of, self.axis_chunks, self.dtype = index_of, axis_chunks, dtype

    def __call__(self, out_chunk, *zarrs, block_id=None):
        i, j = block_id
        if j > i:
            return torch.zeros((self.axis_chunks[i], self.axis_chunks[j]), dtype=to_torch_dtype(self.dtype),
                               device=get_device())
        return numpy_array_to_backend_array(zarrs[self.index_of[(i, j)]][:, :])


def _blocked_cholesky(x):
    """A right-looking blocked Cholesky on the chunk grid (the lower factor):

        for k:  L[k][k] = chol(A[k][k] - sum_j L[k][j] L[k][j]^H)
                L[i][k] = (A[i][k] - sum_j L[i][j] L[k][j]^H) L[k][k]^-H   (i > k)

    in chunked ops over single-block panels: O(nb^3) small matmuls in nb
    sequential panel steps, each task holding only (c, c) blocks. Solves take
    ``solve`` on the diagonal factor (no explicit inverse); a complex
    Hermitian input takes the conjugate transpose throughout (A = L L^H). The
    factor is assembled by one ``map_direct`` (each task reads one L block
    or makes zeros)."""
    from ..core.ops import map_direct
    from .elementwise_functions import conj

    n = x.shape[0]
    itemsize = np.dtype(x.dtype).itemsize
    allowed = x.spec.allowed_mem or (2**63)
    # the block size: the existing square chunking where its blocks fit the
    # per-task budget (no rechunk), else the largest (c, c) that does
    cur = x.chunksize
    if cur[0] == cur[1] and 16 * cur[0] * cur[0] * itemsize <= allowed:
        c = cur[0]
    else:
        c = max(1, min(n, int(math.isqrt(max(1, int(allowed // (16 * itemsize)))))))
    nb = math.ceil(n / c)
    if x.chunksize != (c, c):
        x = rechunk(x, {0: c, 1: c})
    bounds = [min(n, i * c) for i in range(nb + 1)]
    is_complex = np.dtype(x.dtype).kind == "c"

    def ct_(a):
        # the conjugate transpose (a transpose for real dtypes)
        t = matrix_transpose(a)
        return conj(t) if is_complex else t

    def block(arr, i, j):
        return arr[bounds[i]:bounds[i + 1], bounds[j]:bounds[j + 1]]

    def chol_block(a):
        return apply_gufunc(_Cholesky(False), "(i,j)->(i,j)", a, output_dtypes=a.dtype)

    L: dict = {}
    for k in range(nb):
        s = block(x, k, k)
        for j in range(k):
            s = subtract(s, matmul(L[k, j], ct_(L[k, j])))
        L[k, k] = chol_block(s)
        for i in range(k + 1, nb):
            t = block(x, i, k)
            for j in range(k):
                t = subtract(t, matmul(L[i, j], ct_(L[k, j])))
            # L[i][k] = t L[k][k]^-H = (solve(L[k][k], t^H))^H
            L[i, k] = ct_(solve(L[k, k], ct_(t)))

    if nb == 1:
        return L[0, 0]

    ordered = sorted(L)  # (i, j) -> the position of its side input
    index_of = {ij: p for p, ij in enumerate(ordered)}
    axis_chunks = tuple(bounds[i + 1] - bounds[i] for i in range(nb))
    out_dtype = np.dtype(x.dtype)
    block_bytes = max(axis_chunks) ** 2 * out_dtype.itemsize
    return map_direct(
        _AssembleBlock(index_of, axis_chunks, out_dtype),
        *[L[ij] for ij in ordered],
        shape=(n, n),
        dtype=out_dtype,
        chunks=(axis_chunks, axis_chunks),
        extra_projected_mem=2 * block_bytes,
        spec=x.spec,
    )


def _det(a):
    return torch.linalg.det(a)


def det(x, /):
    _require_floating(x, "det")
    _require_square(x, "det")
    return apply_gufunc(_kernel(_det, "det"), "(i,j)->()", _single_chunk_core(x), output_dtypes=x.dtype)


def _slogdet(a):
    sign, logabs = torch.linalg.slogdet(a)
    return sign, logabs


def slogdet(x, /):
    _require_floating(x, "slogdet")
    _require_square(x, "slogdet")
    sign, logabs = apply_gufunc(
        _kernel(_slogdet, "slogdet"), "(i,j)->(),()", _single_chunk_core(x),
        output_dtypes=[x.dtype, _float_of(x.dtype)],
    )
    return SlogdetResult(sign, logabs)


def _inv(a):
    # inv_ex: info stays on the device; a singular matrix gives the LU's
    # infinities, as the JAX package's inv does
    return torch.linalg.inv_ex(a)[0]


def inv(x, /):
    _require_floating(x, "inv")
    _require_square(x, "inv")
    return apply_gufunc(_kernel(_inv, "inv"), "(i,j)->(i,j)", _single_chunk_core(x), output_dtypes=x.dtype)


class _Solve:
    __name__ = "solve"
    batchable = True

    def __init__(self, dtype):
        self.dtype = dtype

    def __call__(self, a, b):
        return torch.linalg.solve_ex(nxp.astype(a, self.dtype), nxp.astype(b, self.dtype))[0]


def solve(x1, x2, /):
    _require_floating(x1, "solve")
    _require_square(x1, "solve")
    vector = x2.ndim == 1
    if vector:
        x2 = expand_dims(x2, axis=-1)
    dt = result_type(x1, x2)
    out = apply_gufunc(
        _Solve(dt), "(i,j),(j,k)->(i,k)",
        _single_chunk_core(x1), _single_chunk_core(x2), output_dtypes=dt,
    )
    return squeeze(out, axis=-1) if vector else out


#: the most matrices one call of torch's eigensolver (complex Hermitian
#: input) takes: on the card its batched form (cusolverDnXsyevBatched,
#: n <= 32) refuses a batch of 32768 or more (CUSOLVER_STATUS_INVALID_VALUE;
#: torch 2.11, CUDA 12.8, H100), so larger batches are solved in pieces
EIGH_PIECE = 16384


def _real_dtype(dt: torch.dtype) -> torch.dtype:
    return {torch.complex64: torch.float32, torch.complex128: torch.float64}.get(dt, dt)


def _in_pieces(fn, a: torch.Tensor):
    """*fn* (a solver returning a tuple of tensors, each with *a*'s batch
    axes in front) over *a*'s matrices, at most EIGH_PIECE a call."""
    batch = a.shape[:-2]
    flat = a.reshape(-1, *a.shape[-2:])
    if flat.shape[0] <= EIGH_PIECE:
        return fn(a)
    parts = [fn(p) for p in flat.split(EIGH_PIECE)]
    return tuple(torch.cat(ts).reshape(batch + ts[0].shape[1:]) for ts in zip(*parts))


@torch.library.custom_op("cubed_tpu_torch::eigh", mutates_args=())
def _eigh_op(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` in pieces of EIGH_PIECE matrices."""
    return _in_pieces(lambda x: tuple(torch.linalg.eigh(x)), a)


@_eigh_op.register_fake
def _eigh_fake(a):
    return a.new_empty(a.shape[:-1], dtype=_real_dtype(a.dtype)), a.new_empty(a.shape)


@torch.library.register_vmap("cubed_tpu_torch::eigh")
def _eigh_vmap(info, in_dims, a):
    """The batching rule: the vmapped axis joins the op's own batch axes, so
    one call (in pieces) takes the whole bucket."""
    (d,) = in_dims
    if d is None:
        return _eigh_op(a), (None, None)
    return _eigh_op(a.movedim(d, 0)), (0, 0)


@torch.library.custom_op("cubed_tpu_torch::eigvalsh", mutates_args=())
def _eigvalsh_op(a: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.eigvalsh`` in pieces of EIGH_PIECE matrices."""
    return _in_pieces(lambda x: (torch.linalg.eigvalsh(x),), a)[0]


@_eigvalsh_op.register_fake
def _eigvalsh_fake(a):
    return a.new_empty(a.shape[:-1], dtype=_real_dtype(a.dtype))


@torch.library.register_vmap("cubed_tpu_torch::eigvalsh")
def _eigvalsh_vmap(info, in_dims, a):
    (d,) = in_dims
    if d is None:
        return _eigvalsh_op(a), None
    return _eigvalsh_op(a.movedim(d, 0)), 0


def _eigh_all(a):
    a = _symmetrized(a)
    vals, vecs = _eigh_op(a) if a.is_complex() else jacobi_eigh(a)
    return vals[..., None, :], vecs


def eigh(x, /):
    _require_floating(x, "eigh")
    _require_square(x, "eigh")
    n = x.shape[-1]
    xc = _single_chunk_core(x)
    batch = x.shape[:-2]
    vals2d, vecs = _per_matrix_multi(
        xc, _kernel(_eigh_all, "eigh", host_sync=np.dtype(x.dtype).kind == "c"),
        shapes=[(*batch, 1, n), (*batch, n, n)],
        chunks=[_batch_chunks(xc, 1, n), _batch_chunks(xc, n, n)],
        op_name="eigh",
        dtypes=[_float_of(x.dtype), x.dtype],
    )
    return EighResult(squeeze(vals2d, axis=-2), vecs)


def _eigvalsh(a):
    a = _symmetrized(a)
    return _eigvalsh_op(a) if a.is_complex() else jacobi_eigh(a)[0]


def eigvalsh(x, /):
    _require_floating(x, "eigvalsh")
    _require_square(x, "eigvalsh")
    return apply_gufunc(
        _kernel(_eigvalsh, "eigvalsh", host_sync=np.dtype(x.dtype).kind == "c"), "(i,j)->(i)",
        _single_chunk_core(x), output_dtypes=_float_of(x.dtype),
    )


# ---------------------------------------------------------------------------
# Compositions of chunked primitives
# ---------------------------------------------------------------------------


def matrix_power(x, n, /):
    _require_floating(x, "matrix_power")
    _require_square(x, "matrix_power")
    if n == 0:
        mask = eye(x.shape[-1], dtype=x.dtype, spec=x.spec, chunks=(x.chunks[-2], x.chunks[-1]))
        if x.ndim == 2:
            return mask
        from .creation_functions import ones_like

        return multiply(mask, ones_like(x))
    if n < 0:
        x = inv(x)
        n = -n
    result = None
    power = x
    while n:
        if n & 1:
            result = power if result is None else matmul(result, power)
        n >>= 1
        if n:
            power = matmul(power, power)
    return result


def diagonal(x, /, *, offset=0):
    """The diagonal of the last two dims, by a virtual eye mask and a row
    reduction (O(n*m) reads, chunked and fused, no gather op). ``where``
    rather than a multiply by the mask, so inf or NaN off the diagonal
    cannot poison the row sums."""
    if x.ndim < 2:
        raise ValueError("diagonal requires at least 2 dimensions")
    n, m = x.shape[-2], x.shape[-1]
    # an offset out of range gives an empty diagonal (numpy's convention:
    # its trace is then 0, not an error)
    d = max(0, min(n, m - offset) if offset >= 0 else min(n + offset, m))
    mask = eye(n, m, k=offset, dtype=xp_bool, spec=x.spec, chunks=(x.chunks[-2], x.chunks[-1]))
    if x.dtype == xp_bool:
        v = xp_any(logical_and(x, mask), axis=-1)
    else:
        zero = asarray(0, dtype=x.dtype, spec=x.spec)
        # v[..., i] = x[..., i, i + offset]
        v = xp_sum(where(mask, x, zero), axis=-1, dtype=x.dtype)
    start = max(0, -offset)
    return v[(Ellipsis, slice(start, start + d))]


def trace(x, /, *, offset=0, dtype=None):
    if x.dtype not in _numeric_dtypes:
        raise TypeError("Only numeric dtypes are allowed in trace")
    return xp_sum(diagonal(x, offset=offset), axis=-1, dtype=dtype)


def cross(x1, x2, /, *, axis=-1):
    if x1.dtype not in _numeric_dtypes or x2.dtype not in _numeric_dtypes:
        raise TypeError("Only numeric dtypes are allowed in cross")
    if x1.shape[axis] != 3 or x2.shape[axis] != 3:
        raise ValueError("cross requires the axis to have size 3")
    a = moveaxis(x1, axis, -1)
    b = moveaxis(x2, axis, -1)

    def comp(i, j):
        return subtract(multiply(a[..., i], b[..., j]), multiply(a[..., j], b[..., i]))

    c = stack([comp(1, 2), comp(2, 0), comp(0, 1)], axis=-1)
    return moveaxis(c, -1, axis)


def matrix_norm(x, /, *, keepdims=False, ord="fro"):
    _require_floating(x, "matrix_norm")
    if x.ndim < 2:
        raise ValueError("matrix_norm requires at least 2 dimensions")
    if ord == "fro":
        return sqrt(xp_sum(square(xp_abs(x)), axis=(-2, -1), keepdims=keepdims))
    if ord in (1, -1, np.inf, -np.inf):
        sum_axis, pick_axis = (-2, -1) if ord in (1, -1) else (-1, -2)
        sums = xp_sum(xp_abs(x), axis=sum_axis, keepdims=True)
        pick = xp_max if ord in (1, np.inf) else xp_min
        out = pick(sums, axis=pick_axis, keepdims=True)
        return out if keepdims else squeeze(out, axis=(-2, -1))
    if ord in (2, -2, "nuc"):
        s = svdvals(x)
        if ord == 2:
            out = xp_max(s, axis=-1)
        elif ord == -2:
            out = xp_min(s, axis=-1)
        else:
            out = xp_sum(s, axis=-1)
        if keepdims:
            out = expand_dims(expand_dims(out, axis=-1), axis=-1)
        return out
    raise ValueError(f"unsupported matrix norm order: {ord!r}")


def vector_norm(x, /, *, axis=None, keepdims=False, ord=2):
    _require_floating(x, "vector_norm")
    if ord == np.inf:
        return xp_max(xp_abs(x), axis=axis, keepdims=keepdims)
    if ord == -np.inf:
        return xp_min(xp_abs(x), axis=axis, keepdims=keepdims)
    if ord == 0:
        from .searching_functions import count_nonzero

        return astype(count_nonzero(x, axis=axis, keepdims=keepdims), _float_of(x.dtype))
    if ord == 2:
        return sqrt(xp_sum(square(xp_abs(x)), axis=axis, keepdims=keepdims))
    p = float(ord)
    # the exponents carry the real counterpart dtype: abs() already made a
    # complex input real, and a complex constant would promote the chain
    # back to complex
    rd = _float_of(x.dtype)
    powed = xp_pow(xp_abs(x), asarray(p, dtype=rd, spec=x.spec))
    return xp_pow(xp_sum(powed, axis=axis, keepdims=keepdims), asarray(1.0 / p, dtype=rd, spec=x.spec))


def matrix_rank(x, /, *, rtol=None):
    _require_floating(x, "matrix_rank")
    if x.ndim < 2:
        raise ValueError("matrix_rank requires at least 2 dimensions")
    s = svdvals(x)
    if rtol is None:
        rtol = max(x.shape[-2], x.shape[-1]) * np.finfo(np.dtype(x.dtype)).eps
    smax = xp_max(s, axis=-1, keepdims=True)
    tol = multiply(smax, asarray(float(rtol), dtype=s.dtype, spec=x.spec))
    return xp_sum(astype(greater(s, tol), int64), axis=-1)


def pinv(x, /, *, rtol=None):
    _require_floating(x, "pinv")
    if x.ndim < 2:
        raise ValueError("pinv requires at least 2 dimensions")
    u, s, vh = svd(x, full_matrices=False)
    if rtol is None:
        rtol = max(x.shape[-2], x.shape[-1]) * np.finfo(np.dtype(x.dtype)).eps
    smax = xp_max(s, axis=-1, keepdims=True)
    cutoff = multiply(smax, asarray(float(rtol), dtype=s.dtype, spec=x.spec))
    zero = asarray(0.0, dtype=s.dtype, spec=x.spec)
    sinv = where(greater(s, cutoff), xp_pow(s, asarray(-1.0, dtype=s.dtype, spec=x.spec)), zero)
    # pinv = V diag(sinv) U^H = (V * sinv[..., None, :]) @ U^H
    v = matrix_transpose(vh)
    return matmul(multiply(v, expand_dims(sinv, axis=-2)), matrix_transpose(u))
