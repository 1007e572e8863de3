"""The Array API namespace of the port: the part of the standard this slice
runs. Counterpart of ``cubed_tpu/array_api/__init__.py``; every name left out
is listed in ROADMAP.md."""

__array_api_version__ = "2022.12"

from .array_object import Array  # noqa: F401
from .creation_functions import asarray  # noqa: F401
from .data_type_functions import astype, can_cast, result_type  # noqa: F401
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
    add,
    ceil,
    cos,
    divide,
    equal,
    exp,
    floor,
    greater,
    less,
    log,
    maximum,
    minimum,
    multiply,
    negative,
    positive,
    sin,
    sqrt,
    square,
    subtract,
    tanh,
)
from .linear_algebra_functions import matmul, matrix_transpose, outer, tensordot, vecdot  # noqa: F401
from .manipulation_functions import expand_dims, permute_dims, squeeze  # noqa: F401
from .statistical_functions import max, mean, min, sum  # noqa: F401
