"""Per-tenant SLOs: declarative objectives, durable error budgets,
multi-window burn rates. Counterpart of ``cubed_tpu/observability/slo.py``;
the compute service that feeds a board is not ported yet (ROADMAP Queue 1
item 11c), so a board here is fed by its caller or folded from a run
archive.

An :class:`SloSpec` states what a tenant was promised — a latency
objective at a percentile ("99% of requests under 2s") and/or an
availability objective ("99.9% of requests succeed") over a rolling
compliance window (3 days by default). The :class:`SloBoard` turns the
service's per-request outcomes into SLIs against those promises:

- every finished request is one **event** — good when it succeeded AND
  (for a latency objective) came in under the threshold; client cancels
  and admission sheds are SLO-ineligible (the service declined or the
  client walked away — neither is evidence about the promise);
- the **error budget** is the tolerated bad fraction (``1 -
  objective``); ``budget_remaining`` is how much of it the compliance
  window has left, and it SURVIVES RESTARTS: the board is folded from
  the durable run archive (``observability/runhistory.py``) on service
  start, so a SIGKILL never resets a burned budget;
- **burn rates** follow the multi-window multi-burn-rate practice from
  the SRE literature: burn 1.0 means "spending the budget exactly as
  fast as the objective tolerates". The board evaluates four windows —
  5m/1h (the fast pair: burn >= 14.4 on BOTH pages, it empties a 3d
  budget in ~5h) and 6h/3d (the slow pair: burn >= 1.0 on both warns, a
  sustained slow leak). The paired short window makes alerts reset
  quickly once the bleeding stops.

The telemetry sampler publishes each tenant's board row as ``slo_*``
series (labelled by tenant) which the ``slo_fast_burn`` /
``slo_slow_burn`` rules in ``observability/alerts.py`` watch; the same
rows ride ``/snapshot.json`` and the ``cubed_tpu_torch.top`` SLO panel.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, Optional

from .metrics import Histogram

logger = logging.getLogger(__name__)

#: default rolling compliance window (seconds): 3 days
DEFAULT_WINDOW_S = 3 * 86400.0

#: the burn-rate pairs (label -> window seconds) the board evaluates
BURN_WINDOWS = {
    "5m": 300.0, "1h": 3600.0, "6h": 6 * 3600.0, "3d": 3 * 86400.0,
}

#: page-grade threshold on the fast pair (5m + 1h): burn 14.4 empties a
#: 3d budget in five hours — classic SRE-workbook sizing
FAST_BURN_THRESHOLD = 14.4
#: warn-grade threshold on the slow pair (6h + 3d): any sustained
#: overspend of the budget
SLOW_BURN_THRESHOLD = 1.0

#: per-tenant event ring bound; at one request/second this covers >2h of
#: dense traffic, and the archive fold seeds the long windows
MAX_EVENTS_PER_TENANT = 8192

#: JSON mapping tenant -> spec fields, e.g.
#: ``{"analytics": {"latency_s": 2.0, "objective": 0.99}}``
SLOS_ENV_VAR = "CUBED_TPU_TORCH_SERVICE_SLOS"


class SloSpec:
    """One tenant's objectives.

    ``latency_s`` + ``latency_objective``: at least ``latency_objective``
    of requests must finish (successfully) within ``latency_s`` seconds.
    ``availability_objective``: at least that fraction must succeed at
    all. Either may be omitted; at least one must be set."""

    def __init__(
        self,
        tenant: str,
        latency_s: Optional[float] = None,
        latency_objective: float = 0.99,
        availability_objective: Optional[float] = None,
        window_s: float = DEFAULT_WINDOW_S,
    ):
        self.tenant = str(tenant)
        self.latency_s = None if latency_s is None else float(latency_s)
        self.latency_objective = float(latency_objective)
        self.availability_objective = (
            None if availability_objective is None
            else float(availability_objective)
        )
        self.window_s = float(window_s)
        if self.latency_s is None and self.availability_objective is None:
            raise ValueError(
                f"SLO for tenant {tenant!r} needs a latency_s and/or an "
                "availability_objective"
            )
        for label, obj in (
            ("latency_objective", self.latency_objective),
            ("availability_objective", self.availability_objective),
        ):
            if obj is not None and not (0.0 < obj < 1.0):
                raise ValueError(
                    f"{label} must be in (0, 1), got {obj} for tenant "
                    f"{tenant!r}"
                )
        if self.window_s <= 0:
            raise ValueError("window_s must be positive")

    @classmethod
    def from_value(cls, tenant: str, value) -> "SloSpec":
        """Accept an :class:`SloSpec` or a dict of its fields."""
        if isinstance(value, SloSpec):
            return value
        if isinstance(value, dict):
            known = {
                "latency_s", "latency_objective", "availability_objective",
                "window_s",
            }
            unknown = set(value) - known
            if unknown:
                raise ValueError(
                    f"unknown SLO field(s) {sorted(unknown)} for tenant "
                    f"{tenant!r}; expected {sorted(known)}"
                )
            return cls(tenant, **value)
        raise ValueError(
            f"SLO for tenant {tenant!r} must be an SloSpec or a dict of "
            f"its fields, got {type(value).__name__}"
        )

    def to_dict(self) -> dict:
        return {
            "tenant": self.tenant,
            "latency_s": self.latency_s,
            "latency_objective": self.latency_objective,
            "availability_objective": self.availability_objective,
            "window_s": self.window_s,
        }


def parse_slos_env(raw: Optional[str] = None) -> Optional[Dict[str, dict]]:
    """``CUBED_TPU_TORCH_SERVICE_SLOS`` -> tenant->fields mapping (None when
    unset/empty; a malformed value is logged and ignored — a bad env var
    must not keep a service from starting)."""
    if raw is None:
        raw = os.environ.get(SLOS_ENV_VAR)
    if not raw or not raw.strip():
        return None
    try:
        parsed = json.loads(raw)
        if not isinstance(parsed, dict):
            raise ValueError("expected a JSON object of tenant -> fields")
        for tenant, value in parsed.items():
            SloSpec.from_value(tenant, value)  # validate early
        return parsed
    except (ValueError, TypeError):
        logger.exception(
            "ignoring malformed %s (expected JSON like "
            '{"tenant": {"latency_s": 2.0}})', SLOS_ENV_VAR,
        )
        return None


class _TenantTracker:
    """One tenant's SLI event ring + latency reservoir."""

    def __init__(self, spec: SloSpec):
        self.spec = spec
        #: (ts, ok, latency_s-or-None) — appended at request completion,
        #: oldest first; bounded, the archive fold seeds it on restart
        self.events: deque = deque(maxlen=MAX_EVENTS_PER_TENANT)
        #: quantile estimates for the slo_latency_* series / SLO panel
        self.latency = Histogram(f"slo_request_latency:{spec.tenant}")

    def record(
        self, ts: float, ok: bool, latency_s: Optional[float],
    ) -> None:
        self.events.append((ts, bool(ok), latency_s))
        if latency_s is not None:
            self.latency.observe(float(latency_s))

    # -- SLI math ------------------------------------------------------

    def _counts(self, window_s: float, now: float):
        """(total, availability-bad, latency-bad) inside the window."""
        cutoff = now - window_s
        total = avail_bad = lat_bad = 0
        for ts, ok, latency_s in self.events:
            if ts < cutoff:
                continue
            total += 1
            if not ok:
                avail_bad += 1
                lat_bad += 1  # a failed request met no latency promise
            elif (
                self.spec.latency_s is not None
                and latency_s is not None
                and latency_s > self.spec.latency_s
            ):
                lat_bad += 1
        return total, avail_bad, lat_bad

    def burn(self, window_s: float, now: float) -> float:
        """Worst burn rate across the spec's objectives over the window:
        bad-fraction divided by the budget fraction (``1 - objective``).
        1.0 = spending the budget exactly as fast as tolerated; 0 while
        the window holds no events (absence of data must not page)."""
        total, avail_bad, lat_bad = self._counts(window_s, now)
        if total == 0:
            return 0.0
        worst = 0.0
        if self.spec.availability_objective is not None:
            budget = 1.0 - self.spec.availability_objective
            worst = max(worst, (avail_bad / total) / budget)
        if self.spec.latency_s is not None:
            budget = 1.0 - self.spec.latency_objective
            worst = max(worst, (lat_bad / total) / budget)
        return worst

    def budget_remaining(self, now: float) -> float:
        """Fraction of the compliance window's error budget left, worst
        objective; clamped at 0 (an overdrawn budget reads as empty)."""
        total, avail_bad, lat_bad = self._counts(self.spec.window_s, now)
        if total == 0:
            return 1.0
        remaining = 1.0
        if self.spec.availability_objective is not None:
            allowed = (1.0 - self.spec.availability_objective) * total
            remaining = min(remaining, 1.0 - avail_bad / max(allowed, 1e-9))
        if self.spec.latency_s is not None:
            allowed = (1.0 - self.spec.latency_objective) * total
            remaining = min(remaining, 1.0 - lat_bad / max(allowed, 1e-9))
        return max(0.0, remaining)

    def status(self, now: float) -> dict:
        total, avail_bad, lat_bad = self._counts(self.spec.window_s, now)
        burns = {
            label: round(self.burn(w, now), 4)
            for label, w in BURN_WINDOWS.items()
        }
        lat = self.latency.summary()
        return {
            "spec": self.spec.to_dict(),
            "events": total,
            "availability_bad": avail_bad,
            "latency_bad": lat_bad,
            "bad": max(avail_bad, lat_bad),
            "good_fraction": (
                round(1.0 - max(avail_bad, lat_bad) / total, 6)
                if total else None
            ),
            "budget_remaining": round(self.budget_remaining(now), 6),
            "burn": burns,
            "fast_burn": (
                burns["5m"] >= FAST_BURN_THRESHOLD
                and burns["1h"] >= FAST_BURN_THRESHOLD
            ),
            "slow_burn": (
                burns["6h"] >= SLOW_BURN_THRESHOLD
                and burns["3d"] >= SLOW_BURN_THRESHOLD
            ),
            "latency": {
                "count": lat.get("count"),
                "p50_s": lat.get("p50"),
                "p95_s": lat.get("p95"),
                "p99_s": lat.get("p99"),
            },
        }


#: request-record statuses that count as SLI events; cancels and sheds
#: are ineligible (see module docstring)
ELIGIBLE_STATUSES = ("completed", "failed")


class SloBoard:
    """The service's per-tenant SLO state: specs + trackers.

    ``fold(records)`` seeds the trackers from the durable run archive
    (restart survival); ``record(...)`` feeds live request outcomes;
    ``status()`` is what ``stats_snapshot``, the sampler and the top SLO
    panel read."""

    def __init__(self, specs: Dict[str, SloSpec]):
        self._lock = threading.Lock()
        self._trackers: Dict[str, _TenantTracker] = {
            tenant: _TenantTracker(spec) for tenant, spec in specs.items()
        }

    @classmethod
    def resolve(cls, raw) -> Optional["SloBoard"]:
        """tenant -> SloSpec/dict mapping (env wins) -> a board, or None
        when no SLOs are configured anywhere."""
        merged: Dict[str, SloSpec] = {}
        if raw:
            for tenant, value in raw.items():
                merged[tenant] = SloSpec.from_value(tenant, value)
        env = parse_slos_env()
        if env:
            for tenant, value in env.items():
                try:
                    merged[tenant] = SloSpec.from_value(tenant, value)
                except ValueError:
                    logger.exception(
                        "ignoring malformed env SLO for tenant %r", tenant
                    )
        if not merged:
            return None
        return cls(merged)

    @property
    def tenants(self) -> list:
        with self._lock:
            return sorted(self._trackers)

    def spec_for(self, tenant: str) -> Optional[SloSpec]:
        with self._lock:
            t = self._trackers.get(tenant)
            return t.spec if t is not None else None

    def fold(self, records: Iterable[dict]) -> int:
        """Seed from archive request records (oldest first); returns how
        many events were folded. Only statuses in
        :data:`ELIGIBLE_STATUSES` count — an interrupted request never
        wrote a completion record, so a crash neither burns nor refunds
        budget for it (no double-count on recovery re-run either: the
        re-run appends its own single completion record)."""
        folded = 0
        with self._lock:
            for rec in records:
                if rec.get("kind") != "request":
                    continue
                tracker = self._trackers.get(rec.get("tenant"))
                if tracker is None:
                    continue
                if rec.get("status") not in ELIGIBLE_STATUSES:
                    continue
                ts = rec.get("ts")
                if not isinstance(ts, (int, float)):
                    continue
                tracker.record(
                    float(ts), bool(rec.get("ok")), rec.get("latency_s"),
                )
                folded += 1
        return folded

    def record(
        self,
        tenant: str,
        ok: bool,
        latency_s: Optional[float] = None,
        ts: Optional[float] = None,
    ) -> None:
        with self._lock:
            tracker = self._trackers.get(tenant)
            if tracker is None:
                return
            tracker.record(
                time.time() if ts is None else float(ts), ok, latency_s,
            )

    def status(self, now: Optional[float] = None) -> Dict[str, dict]:
        if now is None:
            now = time.time()
        with self._lock:
            return {
                tenant: tracker.status(now)
                for tenant, tracker in sorted(self._trackers.items())
            }
