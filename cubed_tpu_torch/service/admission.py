"""Weighted fair-share admission for the multi-tenant compute service.
Counterpart of ``cubed_tpu/service/admission.py``.

Generalizes the AIMD :class:`~cubed_tpu_torch.runtime.memory.AdmissionController`
from "one compute vs host pressure" to "N tenants vs one fleet", in two
layers:

- :class:`FairShareArbiter` — decides *whose* request is admitted next.
  Smooth weighted round-robin (the nginx SWRR scheme, a deficit-style
  credit scheduler): each pick, every backlogged tenant's credit grows by
  its quota weight and the highest-credit tenant wins, paying the total
  backlogged weight back. This yields exact weighted interleaving over
  any window and a hard starvation bound: while backlogged, a tenant
  with weight ``w`` waits at most ``ceil(W / w)`` admissions between its
  own (``W`` = total weight of backlogged tenants) — a flooding tenant
  buys itself *throughput proportional to its weight*, never the queue.
  Credits reset when a tenant's backlog drains, so an idle tenant can't
  bank an admission burst.

- **AIMD slot control** — decides *how many* requests run at once. The
  service reuses :class:`AdmissionController` verbatim over its
  concurrent-compute slots: RESOURCE-classified request failures (memory
  guard trips, OOM-killed pools) halve the effective concurrency,
  pressure-free successes double it back — the same multiplicative
  machinery that already arbitrates task concurrency inside one compute,
  now arbitrating computes inside one fleet.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..runtime.memory import AdmissionController

DEFAULT_WEIGHT = 1.0


class FairShareArbiter:
    """Smooth weighted round-robin over tenants with queued work."""

    def __init__(
        self,
        weights: Optional[Dict[str, float]] = None,
        default_weight: float = DEFAULT_WEIGHT,
    ):
        self.default_weight = float(default_weight)
        if self.default_weight <= 0:
            raise ValueError("default_weight must be > 0")
        self._weights: Dict[str, float] = {}
        self._credit: Dict[str, float] = {}
        self._lock = threading.Lock()
        for tenant, w in (weights or {}).items():
            self.set_weight(tenant, w)

    def set_weight(self, tenant: str, weight: float) -> None:
        weight = float(weight)
        if weight <= 0:
            raise ValueError(
                f"tenant {tenant!r} weight must be > 0, got {weight}"
            )
        with self._lock:
            self._weights[tenant] = weight

    def weight(self, tenant: str) -> float:
        with self._lock:
            return self._weights.get(tenant, self.default_weight)

    def weights(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._weights)

    def pick(self, backlog: Dict[str, int]) -> Optional[str]:
        """The next tenant to admit from, given per-tenant queue depths.

        Only tenants with ``backlog > 0`` compete; returns ``None`` when
        nobody has queued work."""
        with self._lock:
            contenders = [t for t, n in backlog.items() if n and n > 0]
            # a drained tenant's credit resets: fairness is over *active*
            # demand, not a bankable allowance
            for t in list(self._credit):
                if t not in contenders:
                    del self._credit[t]
            if not contenders:
                return None
            total = 0.0
            for t in contenders:
                w = self._weights.get(t, self.default_weight)
                self._credit[t] = self._credit.get(t, 0.0) + w
                total += w
            winner = max(
                contenders, key=lambda t: (self._credit[t], t)
            )
            self._credit[winner] -= total
            return winner

    def starvation_bound(self, tenant: str, backlog: Dict[str, int]) -> int:
        """Max admissions between two of ``tenant``'s own, while every
        listed tenant stays backlogged — the documented fairness contract
        (``ceil(W / w)``)."""
        import math

        with self._lock:
            w = self._weights.get(tenant, self.default_weight)
            total = sum(
                self._weights.get(t, self.default_weight)
                for t, n in backlog.items()
                if n and n > 0
            )
        return int(math.ceil(total / w)) if w > 0 else 0


class ServiceAdmission:
    """AIMD slot control over the service's concurrent-compute ceiling."""

    def __init__(self, max_concurrent: int):
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self.max_concurrent = int(max_concurrent)
        self.controller = AdmissionController()

    def has_slot(self, running: int) -> bool:
        if running >= self.max_concurrent:
            return False
        return self.controller.has_slot(running)

    @property
    def effective_limit(self) -> int:
        limit = self.controller.limit
        if limit is None:
            return self.max_concurrent
        return max(1, min(self.max_concurrent, limit))

    @property
    def throttling(self) -> bool:
        return self.controller.throttling

    def on_resource_failure(self, running: int) -> None:
        self.controller.step_down(max(1, running))

    def on_success(self) -> None:
        self.controller.on_success()
