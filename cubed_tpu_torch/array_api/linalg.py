"""The ``linalg`` extension namespace, begun with what ``corrcoef`` needs:
``diagonal`` and ``trace``.

Counterpart of ``cubed_tpu/array_api/linalg.py:652-685``, with the same
plans. The rest of the reference's namespace (``qr``, ``svd``, ``cholesky``,
``inv``, ``solve``, norms, ...) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from .creation_functions import asarray, eye
from .dtypes import _numeric_dtypes
from .dtypes import bool as xp_bool
from .elementwise_functions import logical_and
from .searching_functions import where
from .statistical_functions import sum as xp_sum
from .utility_functions import any as xp_any

__all__ = ["diagonal", "trace"]


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
