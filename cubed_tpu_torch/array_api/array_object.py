"""The Array object: CoreArray plus the Array-API operators of the slice.

Counterpart of ``cubed_tpu/array_api/array_object.py``. Each operator lowers
to ``elemwise(nxp.<op>)`` with the spec's dtype checks and scalar promotion;
``@`` is ``matmul`` and ``.T``/``.mT`` are ``matrix_transpose``. The
operators share their element functions with ``elementwise_functions``
(floor division, remainder and ``>>`` of uint64 as there).
"""

from __future__ import annotations

import builtins
from typing import Optional

import numpy as np

from ..backend_array_api import logical_right_shift64, nxp
from ..core.array import CoreArray
from ..core.ops import elemwise
from .dtypes import (
    _boolean_dtypes,
    _complex_floating_dtypes,
    _dtype_categories,
    _floating_dtypes,
    _integer_dtypes,
    _integer_or_boolean_dtypes,
    _numeric_dtypes,
    complex64,
    complex128,
    float32,
    float64,
    promote_types,
    uint64,
)


class Array(CoreArray):
    """A chunked, lazily-computed N-dimensional array (Array API standard)."""

    __array_priority__ = 100

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        x = self.compute()
        if dtype is not None and x.dtype != dtype:
            x = x.astype(dtype)
        return np.asarray(x)

    def __bool__(self) -> builtins.bool:
        self._check_0d("bool")
        return builtins.bool(self.compute())

    def __float__(self) -> float:
        self._check_0d("float")
        return float(self.compute())

    def __int__(self) -> int:
        self._check_0d("int")
        return int(self.compute())

    def __index__(self) -> int:
        if self.dtype not in _integer_dtypes:
            raise TypeError("Only integer arrays can be used as an index")
        self._check_0d("index")
        return int(self.compute())

    def __complex__(self) -> complex:
        self._check_0d("complex")
        return complex(self.compute())

    def _check_0d(self, name):
        if self.ndim != 0:
            raise TypeError(f"{name}() of non-0d array")

    def __array_namespace__(self, *, api_version=None):
        if api_version is not None and api_version not in ("2021.12", "2022.12"):
            raise ValueError(f"Unrecognized array API version: {api_version!r}")
        import cubed_tpu_torch.array_api

        return cubed_tpu_torch.array_api

    def to_device(self, device, /, *, stream=None):
        if stream is not None:
            raise ValueError("stream is not supported")
        return self

    @property
    def device(self):
        from .device import device

        return device

    def __repr__(self) -> str:
        return f"cubed_tpu_torch.Array<{self.name}, shape={self.shape}, dtype={self.dtype}, chunks={self.chunks}>"

    @property
    def mT(self):
        from .linear_algebra_functions import matrix_transpose

        return matrix_transpose(self)

    @property
    def T(self):
        if self.ndim != 2:
            raise ValueError("x.T requires x to have 2 dimensions")
        from .linear_algebra_functions import matrix_transpose

        return matrix_transpose(self)

    def __matmul__(self, other):
        from .linear_algebra_functions import matmul

        if not isinstance(other, CoreArray):
            return NotImplemented
        return matmul(self, other)

    def __rmatmul__(self, other):
        from .linear_algebra_functions import matmul

        if not isinstance(other, CoreArray):
            return NotImplemented
        return matmul(other, self)

    # -- scalar promotion --------------------------------------------------

    def _promote_scalar(self, scalar) -> Optional["Array"]:
        """A Python scalar as a 0-d array of this array's dtype."""
        from .creation_functions import asarray

        if isinstance(scalar, builtins.bool):
            if self.dtype not in _boolean_dtypes:
                raise TypeError("Python bool not allowed with non-boolean arrays")
        elif isinstance(scalar, int):
            if self.dtype in _boolean_dtypes:
                raise TypeError("Python int not allowed with boolean arrays")
        elif isinstance(scalar, float):
            if self.dtype not in _floating_dtypes:
                raise TypeError("Python float not allowed with integer/boolean arrays")
        elif isinstance(scalar, complex):
            if self.dtype not in _complex_floating_dtypes:
                raise TypeError("Python complex not allowed with non-complex arrays")
        else:
            return None
        return asarray(scalar, dtype=self.dtype, spec=self.spec)

    def _check_op_dtypes(self, other, category, op):
        if self.dtype not in _dtype_categories[category]:
            raise TypeError(f"Only {category} dtypes are allowed in {op}")
        if isinstance(other, (int, float, complex, builtins.bool)):
            other = self._promote_scalar(other)
        elif isinstance(other, CoreArray):
            if other.dtype not in _dtype_categories[category]:
                raise TypeError(f"Only {category} dtypes are allowed in {op}")
        else:
            return NotImplemented
        return other

    def _binop(self, other, nxp_func, category, op, reflected=False):
        other = self._check_op_dtypes(other, category, op)
        if other is NotImplemented:
            return NotImplemented
        a, b = (other, self) if reflected else (self, other)
        if op in _COMPARISON_OPS:
            dtype = np.dtype(np.bool_)
        elif op in _TRUEDIV_OPS:
            dtype = promote_types(a.dtype, b.dtype)
            if dtype in _integer_or_boolean_dtypes:
                dtype = np.dtype(np.float64)
        else:
            dtype = promote_types(a.dtype, b.dtype)
        if nxp_func is nxp.bitwise_right_shift and dtype == uint64:
            nxp_func = logical_right_shift64  # int64's >> is arithmetic
        elif nxp_func is nxp.floor_divide:
            from .elementwise_functions import floor_divide_for

            nxp_func = floor_divide_for(dtype)
        return elemwise(nxp_func, a, b, dtype=dtype)

    def __add__(self, other):
        return self._binop(other, nxp.add, "numeric", "__add__")

    def __radd__(self, other):
        return self._binop(other, nxp.add, "numeric", "__radd__", reflected=True)

    def __sub__(self, other):
        return self._binop(other, nxp.subtract, "numeric", "__sub__")

    def __rsub__(self, other):
        return self._binop(other, nxp.subtract, "numeric", "__rsub__", reflected=True)

    def __mul__(self, other):
        return self._binop(other, nxp.multiply, "numeric", "__mul__")

    def __rmul__(self, other):
        return self._binop(other, nxp.multiply, "numeric", "__rmul__", reflected=True)

    def __truediv__(self, other):
        return self._binop(other, nxp.divide, "floating-point", "__truediv__")

    def __rtruediv__(self, other):
        return self._binop(other, nxp.divide, "floating-point", "__rtruediv__", reflected=True)

    def __floordiv__(self, other):
        return self._binop(other, nxp.floor_divide, "real numeric", "__floordiv__")

    def __rfloordiv__(self, other):
        return self._binop(other, nxp.floor_divide, "real numeric", "__rfloordiv__", reflected=True)

    def __mod__(self, other):
        return self._binop(other, nxp.remainder, "real numeric", "__mod__")

    def __rmod__(self, other):
        return self._binop(other, nxp.remainder, "real numeric", "__rmod__", reflected=True)

    def __pow__(self, other):
        return self._binop(other, nxp.pow, "numeric", "__pow__")

    def __rpow__(self, other):
        return self._binop(other, nxp.pow, "numeric", "__rpow__", reflected=True)

    def __neg__(self):
        if self.dtype not in _numeric_dtypes:
            raise TypeError("Only numeric dtypes are allowed in __neg__")
        return elemwise(nxp.negative, self, dtype=self.dtype)

    def __pos__(self):
        if self.dtype not in _numeric_dtypes:
            raise TypeError("Only numeric dtypes are allowed in __pos__")
        return elemwise(nxp.positive, self, dtype=self.dtype)

    def __abs__(self):
        if self.dtype not in _numeric_dtypes:
            raise TypeError("Only numeric dtypes are allowed in __abs__")
        dtype = {complex64: float32, complex128: float64}.get(self.dtype, self.dtype)
        return elemwise(nxp.abs, self, dtype=dtype)

    # -- bitwise -----------------------------------------------------------

    def __and__(self, other):
        return self._binop(other, nxp.bitwise_and, "integer or boolean", "__and__")

    def __rand__(self, other):
        return self._binop(other, nxp.bitwise_and, "integer or boolean", "__rand__", reflected=True)

    def __or__(self, other):
        return self._binop(other, nxp.bitwise_or, "integer or boolean", "__or__")

    def __ror__(self, other):
        return self._binop(other, nxp.bitwise_or, "integer or boolean", "__ror__", reflected=True)

    def __xor__(self, other):
        return self._binop(other, nxp.bitwise_xor, "integer or boolean", "__xor__")

    def __rxor__(self, other):
        return self._binop(other, nxp.bitwise_xor, "integer or boolean", "__rxor__", reflected=True)

    def __lshift__(self, other):
        return self._binop(other, nxp.bitwise_left_shift, "integer", "__lshift__")

    def __rlshift__(self, other):
        return self._binop(other, nxp.bitwise_left_shift, "integer", "__rlshift__", reflected=True)

    def __rshift__(self, other):
        return self._binop(other, nxp.bitwise_right_shift, "integer", "__rshift__")

    def __rrshift__(self, other):
        return self._binop(other, nxp.bitwise_right_shift, "integer", "__rrshift__", reflected=True)

    def __invert__(self):
        if self.dtype not in _integer_or_boolean_dtypes:
            raise TypeError("Only integer or boolean dtypes are allowed in __invert__")
        return elemwise(nxp.bitwise_invert, self, dtype=self.dtype)

    # -- comparison --------------------------------------------------------

    def __eq__(self, other):  # type: ignore[override]
        return self._binop(other, nxp.equal, "all", "__eq__")

    def __ne__(self, other):  # type: ignore[override]
        return self._binop(other, nxp.not_equal, "all", "__ne__")

    def __lt__(self, other):
        return self._binop(other, nxp.less, "real numeric", "__lt__")

    def __le__(self, other):
        return self._binop(other, nxp.less_equal, "real numeric", "__le__")

    def __gt__(self, other):
        return self._binop(other, nxp.greater, "real numeric", "__gt__")

    def __ge__(self, other):
        return self._binop(other, nxp.greater_equal, "real numeric", "__ge__")

    __hash__ = None  # type: ignore[assignment]


_COMPARISON_OPS = {"__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__"}
_TRUEDIV_OPS = {"__truediv__", "__rtruediv__"}
