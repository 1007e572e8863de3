"""The observability wall clock: ``time.time`` plus a settable skew.

Counterpart of ``cubed_tpu/observability/clock.py``. Every span timestamp
in the tracing pipeline goes through :func:`now` instead of ``time.time()``
so tests can inject a per-process clock skew and check that the trace
collector's alignment corrects it. In production the skew is 0.

Skew is configured per process: :func:`set_skew`, or the env var
``CUBED_TPU_TORCH_CLOCK_SKEW_S``, either a plain float or a JSON object
mapping process names to floats, which :func:`configure_from_env` resolves.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

SKEW_ENV_VAR = "CUBED_TPU_TORCH_CLOCK_SKEW_S"

_skew = 0.0


def now() -> float:
    """Epoch seconds on this process's (possibly skewed) observability clock."""
    return time.time() + _skew


def get_skew() -> float:
    return _skew


def set_skew(seconds: float) -> None:
    global _skew
    _skew = float(seconds)


def skew_for(name: Optional[str] = None) -> float:
    """The env-configured skew for this process (0.0 when unset). A
    malformed value raises: a silently unskewed clock-skew test would pass
    for the wrong reason."""
    raw = os.environ.get(SKEW_ENV_VAR)
    if not raw:
        return 0.0
    try:
        return float(raw)
    except ValueError:
        pass
    mapping = json.loads(raw)
    if not isinstance(mapping, dict):
        raise ValueError(f"{SKEW_ENV_VAR} must be a float or a JSON object")
    return float(mapping.get(name or "", 0.0))


def configure_from_env(name: Optional[str] = None) -> float:
    """Adopt the env-configured skew."""
    skew = skew_for(name)
    set_skew(skew)
    return skew
