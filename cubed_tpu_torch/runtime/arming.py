"""Arming scopes that survive concurrent computes.

A compute arms the memory guard, the fault injector, the integrity mode and
the fleet's peer-transfer client config for its duration, process-wide
(tasks run on any pool thread). The JAX package saves the armed value when a
scope enters and restores it when the scope exits, which is right for nested
scopes on one thread. Two computes on two threads (a service's requests)
exit in any order, and then an exit restores a value armed by a compute
that has already ended. A :class:`ScopeStack` keeps the live scopes of one
kind instead: a scope's exit removes its own entry, and the armed value
becomes the newest live scope's or, once none is live, what was armed
before the first of them. A scope's export to an environment variable (so
that child processes arm too) follows the same rule.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Optional


class ScopeStack:
    """The live arming scopes of one kind, newest last.

    *get* and *set* read and write the module's armed value; both run with
    *lock* (the module's own) held. *env_var*, when given, is exported for
    child processes; with *operator_env_wins*, a value the variable already
    held before the first live scope is the operator's override and stays.
    """

    def __init__(self, lock, get: Callable[[], Any], set: Callable[[Any], None],
                 env_var: Optional[str] = None, operator_env_wins: bool = False):
        self._lock = lock
        self._get = get
        self._set = set
        self._env_var = env_var
        self._operator_env_wins = operator_env_wins
        self._live: list = []  # (token, value, the env var's value or None)
        self._base: Any = None
        self._base_env: Optional[str] = None
        self._tokens = itertools.count()

    def push(self, value: Any, env_value: Optional[str] = None) -> int:
        """Arm *value* (and export *env_value*, if given); returns the token
        :meth:`pop` takes."""
        with self._lock:
            if not self._live:
                self._base = self._get()
                self._base_env = os.environ.get(self._env_var) if self._env_var else None
            if self._operator_env_wins and self._base_env is not None:
                env_value = None
            token = next(self._tokens)
            self._live.append((token, value, env_value))
            self._settle(exported=env_value is not None)
        return token

    def pop(self, token: int) -> None:
        """End the scope of *token*, wherever it stands among the live ones."""
        with self._lock:
            ended = [e for e in self._live if e[0] == token]
            self._live = [e for e in self._live if e[0] != token]
            self._settle(exported=any(e[2] is not None for e in ended))

    def _settle(self, exported: bool) -> None:
        self._set(self._live[-1][1] if self._live else self._base)
        if self._env_var is None or not (exported or any(e[2] is not None for e in self._live)):
            return
        values = [e[2] for e in self._live if e[2] is not None]
        value = values[-1] if values else self._base_env
        if value is None:
            os.environ.pop(self._env_var, None)
        else:
            os.environ[self._env_var] = value
