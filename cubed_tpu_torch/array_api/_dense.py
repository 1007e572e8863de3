"""Small dense factorizations composed of torch operations, for the
``linalg`` block functions whose ``torch.linalg`` call does not fit a
task's projected memory on the card or synchronises the host.

On the H100, torch's cuSOLVER routes need workspaces that the plan's
per-task memory model (two copies of each input and output block, as the
JAX package prices them) does not hold: the batched symmetric eigensolver
(``cusolverDnXsyevBatched``) takes about 575 KB a matrix for 8 x 8
matrices (4.7 GB for 8192 of them) and refuses 32768 or more in one call,
and checks its ``info`` on the host; ``geqrf`` of a (2048, 32) panel peaks
at 13 times the panel (torch 2.11, CUDA 12.8; PERF.md). The two functions
here hold a few copies of their block, never synchronise the
host, run under ``torch.func.vmap`` (their loops are over static indices)
and inside a captured CUDA graph:

- :func:`householder_qr`: the reduced QR by Householder reflections, with
  LAPACK's ``geqrf`` signs (``R[j, j] = -sign(x_0) |x|``), so Q and R match
  LAPACK's to rounding;
- :func:`jacobi_eigh`: the eigen-decomposition of real symmetric matrices
  by the cyclic Jacobi method in the round-robin (parallel) order, a fixed
  number of sweeps, eigenvalues ascending as LAPACK's.
"""

from __future__ import annotations

import math

import torch


def householder_qr(a: torch.Tensor, want_q: bool = True):
    """The reduced QR of real (..., m, n) *a*: (Q (..., m, k), R (..., k, n)),
    k = min(m, n); R alone when not *want_q*."""
    m, n = a.shape[-2], a.shape[-1]
    k = min(m, n)
    rows = torch.arange(m, device=a.device)
    cols = torch.arange(n, device=a.device)
    r = a
    vs = []  # the reflectors, kept only to form Q (a block's worth)
    for j in range(k):
        x = r[..., :, j] * (rows >= j)
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        x0 = r[..., j:j + 1, j]
        alpha = -torch.where(x0 < 0, -1.0, 1.0).to(a.dtype) * norm  # R[j, j], geqrf's sign
        v = x - alpha * (rows == j)
        vv = (v * v).sum(-1, keepdim=True)
        # no reflection where x is zero below its first entry (LAPACK's
        # dlarfg: tau 0, the last column of a square matrix among them)
        reflect = (x * (rows > j) != 0).any(-1, keepdim=True) & (vv > 0)
        scale = torch.where(reflect, 2.0 / torch.where(reflect, vv, 1.0), 0.0)
        # v^T R on the trailing columns (a product: no block-sized
        # temporary), then R - scale v w^T in one pass (addcmul)
        w = torch.matmul(v.unsqueeze(-2), r).squeeze(-2) * (cols >= j)
        r = torch.addcmul(r, (scale * v).unsqueeze(-1), w.unsqueeze(-2), value=-1)
        if want_q:
            vs.append((v, scale))
    r_out = r[..., :k, :] * (rows[:k, None] <= cols[None, :])
    del r
    if not want_q:
        return r_out
    q = (rows[:, None] == torch.arange(k, device=a.device)[None, :]).to(a.dtype)
    q = q.expand(a.shape[:-2] + (m, k))
    for v, scale in reversed(vs):
        w = torch.matmul(v.unsqueeze(-2), q).squeeze(-2)
        q = torch.addcmul(q, (scale * v).unsqueeze(-1), w.unsqueeze(-2), value=-1)
    return q, r_out


def _rounds(m: int, device) -> list:
    """The round-robin schedule of m (even) indices: m - 1 rounds of m / 2
    disjoint pairs (P, Q), each with the permutation that puts the columns
    of ``cat(P, Q)`` back in order."""
    ks = torch.arange(m // 2, device=device)
    out = []
    for r in range(m - 1):
        p = torch.where(ks == 0, r, torch.remainder(r + ks, m - 1))
        q = torch.where(ks == 0, m - 1, torch.remainder(r - ks, m - 1))
        out.append((p, q, torch.argsort(torch.cat([p, q]))))
    return out


def _rotate_cols(x, p, q, inverse, c, s):
    """Columns p and q of *x* rotated by (c, s): x[:, p] c - x[:, q] s and
    x[:, p] s + x[:, q] c, for every pair at once."""
    xp, xq = x.index_select(-1, p), x.index_select(-1, q)
    new = torch.cat([torch.addcmul(c * xp, s, xq, value=-1), torch.addcmul(s * xp, c, xq)], dim=-1)
    del xp, xq  # a block's worth, freed before the permutation's copy
    return new.index_select(-1, inverse)


def jacobi_sweeps(n: int) -> int:
    """Sweeps of :func:`jacobi_eigh` for n x n: the off-diagonal mass falls
    quadratically once small; 6 plus log2(n) reach float64 rounding."""
    return 6 + max(1, math.ceil(math.log2(max(n, 2))))


def jacobi_eigh(a: torch.Tensor):
    """(eigenvalues ascending (..., n), eigenvectors (..., n, n) by column) of
    real symmetric *a*."""
    n = a.shape[-1]
    m = n + n % 2
    if m != n:
        # an odd size padded with a zero row and column: the pad index is
        # never rotated (its off-diagonal entries are zero)
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
    v = torch.eye(m, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    rounds = _rounds(m, a.device)
    for _ in range(jacobi_sweeps(n)):
        for p, q, inverse in rounds:
            app = a[..., p, p]
            aqq = a[..., q, q]
            apq = a[..., p, q]
            nonzero = apq != 0
            tau = (aqq - app) / (2 * torch.where(nonzero, apq, 1.0))
            t = torch.where(tau >= 0, 1.0, -1.0) / (tau.abs() + torch.sqrt(1 + tau * tau))
            t = torch.where(nonzero, t, 0.0)
            c = 1 / torch.sqrt(1 + t * t)
            s = t * c
            cc, ss = c.unsqueeze(-2), s.unsqueeze(-2)
            a = _rotate_cols(a, p, q, inverse, cc, ss)
            a = _rotate_cols(a.mT, p, q, inverse, cc, ss).mT
            v = _rotate_cols(v, p, q, inverse, cc, ss)
    vals = torch.diagonal(a, dim1=-2, dim2=-1)[..., :n]
    vecs = v[..., :n, :n]
    order = torch.argsort(vals, dim=-1)
    return torch.take_along_dim(vals, order, dim=-1), torch.take_along_dim(vecs, order.unsqueeze(-2), dim=-1)
