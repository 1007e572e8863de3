"""The Array API namespace of the port: the standard's surface, sorting and
the order statistics, and the extensions ``linalg``, ``fft`` and
``einsum``. Counterpart of ``cubed_tpu/array_api/__init__.py``, in its
order."""

__array_api_version__ = "2022.12"

from .array_object import Array  # noqa: F401

from .constants import e, inf, nan, newaxis, pi  # noqa: F401

from .creation_functions import (  # noqa: F401
    arange,
    asarray,
    empty,
    empty_like,
    empty_virtual_array,
    eye,
    full,
    full_like,
    linspace,
    meshgrid,
    ones,
    ones_like,
    tril,
    triu,
    zeros,
    zeros_like,
)

from .data_type_functions import (  # noqa: F401
    astype,
    can_cast,
    finfo,
    iinfo,
    isdtype,
    result_type,
)

from .dtypes import (  # noqa: F401
    bool,
    complex64,
    complex128,
    float32,
    float64,
    int8,
    int16,
    int32,
    int64,
    uint8,
    uint16,
    uint32,
    uint64,
)

from .elementwise_functions import (  # noqa: F401
    abs,
    acos,
    acosh,
    add,
    asin,
    asinh,
    atan,
    atan2,
    atanh,
    bitwise_and,
    bitwise_invert,
    bitwise_left_shift,
    bitwise_or,
    bitwise_right_shift,
    bitwise_xor,
    ceil,
    clip,
    conj,
    copysign,
    cos,
    cosh,
    divide,
    equal,
    exp,
    expm1,
    floor,
    floor_divide,
    greater,
    greater_equal,
    hypot,
    imag,
    isfinite,
    isinf,
    isnan,
    less,
    less_equal,
    log,
    log10,
    log1p,
    log2,
    logaddexp,
    logical_and,
    logical_not,
    logical_or,
    logical_xor,
    maximum,
    minimum,
    multiply,
    negative,
    not_equal,
    positive,
    pow,
    real,
    remainder,
    round,
    sign,
    signbit,
    nextafter,
    reciprocal,
    sin,
    sinh,
    sqrt,
    square,
    subtract,
    tan,
    tanh,
    trunc,
)

from .indexing_functions import take, take_along_axis  # noqa: F401

from .linear_algebra_functions import (  # noqa: F401
    matmul,
    matrix_transpose,
    outer,
    tensordot,
    vecdot,
)

from .manipulation_functions import (  # noqa: F401
    broadcast_arrays,
    broadcast_to,
    concat,
    expand_dims,
    flatten,
    flip,
    moveaxis,
    pad,
    permute_dims,
    repeat,
    reshape,
    roll,
    squeeze,
    stack,
    tile,
    unstack,
)

from .searching_functions import argmax, argmin, count_nonzero, where  # noqa: F401
from .sorting_functions import argsort, searchsorted, sort  # noqa: F401

from .statistical_functions import (  # noqa: F401
    cumulative_prod,
    cumulative_sum,
    max,
    mean,
    min,
    prod,
    std,
    sum,
    var,
)

from .utility_functions import all, any, diff  # noqa: F401

from . import fft  # noqa: F401  (extension namespace)
from . import linalg  # noqa: F401  (extension namespace)

from .searching_functions import nonzero  # noqa: F401  (refused)
from .set_functions import (  # noqa: F401  (refused)
    unique_all,
    unique_counts,
    unique_inverse,
    unique_values,
)
from .creation_functions import from_dlpack  # noqa: F401
from .einsum_functions import einsum  # noqa: F401  (beyond the standard)
from .statistical_functions import median, quantile  # noqa: F401  (beyond the standard)
from .statistical_functions import corrcoef, cov, histogram  # noqa: F401  (beyond the standard)
from .statistical_functions import nanmedian, nanquantile  # noqa: F401  (beyond the standard)
from .sorting_functions import argtopk, topk  # noqa: F401  (beyond the standard)
