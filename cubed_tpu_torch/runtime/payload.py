"""Task payloads across a process boundary, on the stdlib's ``pickle``.

The JAX package ships each op's ``(function, config)`` to pool and fleet
workers with ``cloudpickle`` (``runtime/executors/multiprocess.py``,
``runtime/distributed.py``), because block functions are closures and
lambdas. The port imports no ``cloudpickle``; this module is its stand-in,
a ``pickle.Pickler`` whose ``reducer_override`` carries what the stdlib
refuses:

- **Functions by reference** when ``module.qualname`` resolves, in a module
  already imported here other than ``__main__``, to the very object being
  pickled (the receiver imports the module). Otherwise **by value**: the
  code object through ``marshal`` (so both ends run one Python), the
  module globals the code (nested code included) names, modules by name
  (a function nested in one of this package's modules runs in that
  module's globals, imported by the receiver), the defaults, the keyword defaults, ``__dict__`` and the closure cells.
  The function is created with empty cells and filled afterwards, so a
  closure that refers to itself (a recursive inner function) round-trips.
- ``functools.partial``, bound methods and the port's blockwise and
  rechunk configs go through the same pickler by their own reductions, so
  every function inside them is treated as above.
- **A tensor on the card** is copied to the host and tagged with its
  device kind; it is restored onto the receiving process's device
  (``backend_array_api.get_device()``), and its bytes are counted in the
  ``payload_device_bytes`` counter where it was pickled. A receiver whose
  chunk device is not of that kind (a ``cuda`` tensor where the chunk
  device is the CPU, or where there is no card) refuses it with a
  ``RuntimeError``: the work it carries never runs on a device its sender
  did not choose.
- **A class** defined in ``__main__`` or inside a function is refused with
  an :class:`UnshippableClassError` (a ``TypeError``) naming it: define it
  in a module, which the worker imports.

The trust model is the JAX package's fleet's (its ``distributed.py``
module docstring): loading a payload runs code the sender chose, as any
worker that executes the sender's functions must. Payloads cross only
between a client and the workers it started or admitted; scope the
fleet's listen address to the network that holds them.
"""

from __future__ import annotations

import builtins
import importlib
import io
import marshal
import pickle
import sys
import types
from typing import Any

import torch

from ..observability.metrics import get_registry

#: counter of the bytes of card tensors copied to the host to be pickled
DEVICE_BYTES_COUNTER = "payload_device_bytes"


def _lookup(module_name: str, qualname: str) -> Any:
    """The object ``module.qualname`` names in an imported module, or a
    sentinel when it names nothing."""
    module = sys.modules.get(module_name)
    if module is None or "<locals>" in qualname.split("."):
        return _MISSING
    obj: Any = module
    for part in qualname.split("."):
        obj = getattr(obj, part, _MISSING)
        if obj is _MISSING:
            return _MISSING
    return obj


_MISSING = object()


def _by_reference(obj) -> bool:
    """True when *obj* (a function or class) can travel by name: its module
    is imported here, is not ``__main__``, and names this very object."""
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None)
    if not module or not qualname or module in ("__main__", "__mp_main__"):
        return False
    return _lookup(module, qualname) is obj


def _code_names(code: types.CodeType) -> set:
    """The global names a code object (nested code included) may read."""
    names: set = set()
    stack = [code]
    while stack:
        c = stack.pop()
        names.update(c.co_names)
        stack.extend(k for k in c.co_consts if isinstance(k, types.CodeType))
    return names


def _shares_module_globals(fn: types.FunctionType) -> bool:
    """True for a function nested in one of this package's modules: it runs
    in that module's own globals, which the receiver imports."""
    module = fn.__module__ or ""
    return module.startswith(_PACKAGE + ".") and module in sys.modules


_PACKAGE = __name__.partition(".")[0]


def _make_function(code_bytes: bytes, name: str, qualname: str, module: str, ncells: int, shared: bool):
    """A function from marshalled code, with empty cells (filled by
    :func:`_fill_function`, after the function is memoized) and fresh
    globals, or its module's when *shared*."""
    code = marshal.loads(code_bytes)
    if shared:
        fn_globals = importlib.import_module(module).__dict__
    else:
        fn_globals = {"__builtins__": builtins, "__name__": module}
    closure = tuple(types.CellType() for _ in range(ncells)) if ncells else None
    fn = types.FunctionType(code, fn_globals, name, None, closure)
    fn.__qualname__ = qualname
    fn.__module__ = module
    return fn


def _fill_function(fn: types.FunctionType, state: dict) -> types.FunctionType:
    fn.__globals__.update(state["globals"])
    fn.__defaults__ = state["defaults"]
    fn.__kwdefaults__ = state["kwdefaults"]
    fn.__dict__.update(state["dict"])
    for cell, value in zip(fn.__closure__ or (), state["cells"]):
        if value is not _EMPTY_CELL:
            cell.cell_contents = value
    return fn


class _EmptyCell:
    """A closure cell not yet bound when the function was pickled."""

    def __reduce__(self):
        return (_empty_cell, ())


def _empty_cell():
    return _EMPTY_CELL


_EMPTY_CELL = _EmptyCell()


def _cell_value(cell):
    try:
        return cell.cell_contents
    except ValueError:
        return _EMPTY_CELL


class UnshippableClassError(TypeError):
    """A class with no importable name (defined in ``__main__`` or inside a
    function) cannot travel to another process."""


def _restore_tensor(host: torch.Tensor, device_kind: str) -> torch.Tensor:
    """A tensor that left a card, put on this process's chunk device, which
    must be of the kind it left (``get_device`` raises for ``cuda`` where
    there is no card)."""
    from ..backend_array_api import get_device

    device = get_device()
    if device.type != device_kind:
        raise RuntimeError(
            f"payload holds a tensor from a {device_kind} device but this process's chunk device is {device}; "
            f"set CUBED_TPU_TORCH_DEVICE={device_kind} on a machine that has one")
    return host.to(device)


class PayloadPickler(pickle.Pickler):
    """``pickle.Pickler`` that ships closures and lambdas by value."""

    def reducer_override(self, obj):
        if isinstance(obj, types.FunctionType):
            if _by_reference(obj):
                return NotImplemented
            return self._reduce_function(obj)
        if isinstance(obj, types.ModuleType):
            return (importlib.import_module, (obj.__name__,))
        if isinstance(obj, type):
            if obj.__module__ not in ("__main__", "__mp_main__") and "<locals>" not in obj.__qualname__:
                return NotImplemented
            raise UnshippableClassError(
                f"cannot ship class {obj.__module__}.{obj.__qualname__} to a worker process: a class defined in "
                "__main__ or inside a function has no importable name; define it at the top level of a module")
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            host = obj.detach().cpu()
            get_registry().counter(DEVICE_BYTES_COUNTER).inc(host.numel() * host.element_size())
            return (_restore_tensor, (host, obj.device.type))
        return NotImplemented

    @staticmethod
    def _reduce_function(fn: types.FunctionType):
        g = fn.__globals__
        shared = _shares_module_globals(fn)
        names = () if shared else _code_names(fn.__code__)
        state = {
            "globals": {n: g[n] for n in sorted(names) if n in g},
            "defaults": fn.__defaults__,
            "kwdefaults": fn.__kwdefaults__,
            "dict": dict(fn.__dict__),
            "cells": tuple(_cell_value(c) for c in fn.__closure__ or ()),
        }
        args = (marshal.dumps(fn.__code__), fn.__name__, fn.__qualname__, fn.__module__ or "__main__",
                len(fn.__closure__ or ()), shared)
        return (_make_function, args, state, None, None, _fill_function)


def dumps(obj) -> bytes:
    """*obj* as bytes: closures, lambdas and partials by value, tensors on
    the card through the host."""
    buf = io.BytesIO()
    PayloadPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def loads(data: bytes):
    """The object :func:`dumps` made, in this process (a card tensor lands
    on this process's chunk device)."""
    return pickle.loads(data)
