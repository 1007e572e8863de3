"""Alert rules over the live time series: threshold + burn-rate + stall.
Counterpart of ``cubed_tpu/observability/alerts.py``, with the same rules:
those over fleet, service and peer-transfer series stay quiet until the
modules that feed them are ported (ROADMAP Queue 1 item 11c).

The rules run inside the telemetry sampler's ~1s tick
(``observability/timeseries.py``), so alert latency is one sampling
interval. A firing is never just a log line — it lands everywhere an
operator might be looking:

- the ``alerts_fired`` counter (per-rule visibility via the firing ring),
- a ``scheduler``-lane decision (``record_decision("alert_fired", ...)``)
  — which means the flight-recorder bundle and ``python -m
  cubed_tpu_torch.diagnose`` both show the alert timeline for free,
- a structured warning on the ``cubed_tpu_torch`` logger (compute-correlated
  when one is running),
- the engine's bounded firing ring, served by ``/snapshot.json`` and the
  ``cubed_tpu_torch.top`` dashboard.

Rules fire on the rising edge (condition flips false->true) and re-fire
while still active only after ``cooldown_s`` — a sustained condition
reads as one alert per cooldown window, not one per second.

The default rule set (:func:`default_rules`) covers the failure shapes
the PRs so far taught the runtime to survive — so an operator sees them
*while* the machinery absorbs them, not in the post-mortem: retry-budget
burn, a half-pressured fleet, a straggler burst, a stalled queue, and a
peer-fetch fallback spike.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

from .metrics import get_registry

logger = logging.getLogger(__name__)

#: firings retained for /snapshot.json, the dashboard and the bundle
MAX_FIRINGS = 256


class AlertRule:
    """One named condition over the telemetry store.

    Subclasses implement ``evaluate(store, now) -> Optional[dict]``: None
    while healthy, else a dict of firing details (at least ``value`` and
    ``threshold``). ``severity`` is ``"warning"`` or ``"critical"``
    (display only — every firing takes the same paths)."""

    def __init__(self, name: str, description: str = "",
                 severity: str = "warning"):
        self.name = name
        self.description = description
        self.severity = severity

    def evaluate(self, store, now: float) -> Optional[dict]:
        raise NotImplementedError


class ThresholdRule(AlertRule):
    """Fire when a series' latest value (or its rate over ``window_s``
    when ``rate=True``) crosses ``threshold``.

    ``comparison`` is ``">="`` or ``"<="``. A missing series is healthy —
    absence of data must not page anyone — and so is a FROZEN one: a
    latest-value reading older than ``stale_after_s`` means its writer is
    gone (a closed fleet, a finished compute), and a long-lived telemetry
    endpoint must not re-fire on that fossil every cooldown forever."""

    #: latest-value samples older than this are treated as no-data (the
    #: sampler ticks at ~1s, so 10 missed writes means the writer is gone)
    STALE_AFTER_S = 10.0

    def __init__(
        self, name: str, metric: str, threshold: float,
        comparison: str = ">=", rate: bool = False, window_s: float = 30.0,
        labels: Optional[dict] = None, description: str = "",
        severity: str = "warning", stale_after_s: Optional[float] = None,
    ):
        super().__init__(name, description, severity)
        if comparison not in (">=", "<="):
            raise ValueError(
                f"comparison must be '>=' or '<=', got {comparison!r}"
            )
        self.metric = metric
        self.threshold = float(threshold)
        self.comparison = comparison
        self.rate = rate
        self.window_s = float(window_s)
        self.labels = labels
        self.stale_after_s = (
            self.STALE_AFTER_S if stale_after_s is None
            else float(stale_after_s)
        )

    def evaluate(self, store, now: float) -> Optional[dict]:
        if self.rate:
            value = store.rate(
                self.metric, self.window_s, labels=self.labels, now=now
            )
        else:
            pt = store.latest_point(self.metric, labels=self.labels)
            value = None
            if pt is not None and now - pt[0] <= self.stale_after_s:
                value = pt[1]
        if value is None:
            return None
        crossed = (
            value >= self.threshold if self.comparison == ">="
            else value <= self.threshold
        )
        if not crossed:
            return None
        return {
            "metric": self.metric,
            "value": round(float(value), 6),
            "threshold": self.threshold,
            "comparison": self.comparison,
            "window_s": self.window_s if self.rate else None,
        }


class BurnRateRule(AlertRule):
    """Fire when a cumulative counter consumes more than ``burn_frac`` of
    ``budget`` within ``window_s`` — the classic error-budget burn alert,
    here sized for bounded allowances like the per-compute retry budget:
    spending 10% of the whole allowance inside one window means the
    failures are systemic, and the circuit breaker is where this ends."""

    def __init__(
        self, name: str, counter: str, budget: float,
        burn_frac: float = 0.1, window_s: float = 60.0,
        description: str = "", severity: str = "critical",
    ):
        super().__init__(name, description, severity)
        self.counter = counter
        self.budget = float(budget)
        self.burn_frac = float(burn_frac)
        self.window_s = float(window_s)

    def evaluate(self, store, now: float) -> Optional[dict]:
        pts = store.window(self.counter, self.window_s, now=now)
        if len(pts) < 2:
            return None
        burned = max(0.0, pts[-1][1] - pts[0][1])
        allowance = self.budget * self.burn_frac
        if burned < max(allowance, 1.0):
            return None
        return {
            "metric": self.counter,
            "value": burned,
            "threshold": allowance,
            "budget": self.budget,
            "window_s": self.window_s,
        }


class StallRule(AlertRule):
    """Fire when work is queued but nothing completes: ``gauge_metric``
    (latest) is positive while ``progress_counter`` shows zero increase
    over ``window_s`` — the queue-depth stall shape (a wedged fleet, a
    dead dispatch loop, an all-pressured admission floor)."""

    def __init__(
        self, name: str, gauge_metric: str = "queue_depth",
        progress_counter: str = "tasks_completed", window_s: float = 30.0,
        description: str = "", severity: str = "critical",
    ):
        super().__init__(name, description, severity)
        self.gauge_metric = gauge_metric
        self.progress_counter = progress_counter
        self.window_s = float(window_s)

    def evaluate(self, store, now: float) -> Optional[dict]:
        depth = store.latest(self.gauge_metric)
        if not depth:
            return None
        # the queue must have been non-empty for the WHOLE window — a
        # queue that just filled is starting, not stalled
        depth_pts = store.window(self.gauge_metric, self.window_s, now=now)
        if len(depth_pts) < 2 or depth_pts[0][0] > now - self.window_s * 0.8:
            return None
        if any(v <= 0 for _, v in depth_pts):
            return None
        rate = store.rate(self.progress_counter, self.window_s, now=now)
        # a MISSING progress series is zero progress, not health: a fleet
        # wedged before the first task ever completes never creates the
        # tasks_completed counter at all — and the full-window depth
        # series above already proves the sampler covered the window
        if rate is not None and rate > 0:
            return None
        return {
            "metric": self.gauge_metric,
            "value": depth,
            "threshold": 0,
            "progress_counter": self.progress_counter,
            "window_s": self.window_s,
        }


class TenantStarvationRule(AlertRule):
    """Fire when any tenant has queued work for a whole window with zero
    completions — the multi-tenant stall shape (a wedged service
    dispatcher, a fair-share weight misconfigured to ~0, or every slot
    pinned by another tenant's long computes).

    Evaluates every ``tenant_queued{tenant=...}`` series the telemetry
    sampler maintains (one per tenant the service has seen), so new
    tenants are covered the tick they first queue work. A starving tenant
    must show a positive queue across the ENTIRE window while its
    ``tenant_completed`` counter shows no increase."""

    def __init__(
        self, name: str = "tenant_starvation", window_s: float = 30.0,
        description: str = "", severity: str = "critical",
    ):
        super().__init__(name, description, severity)
        self.window_s = float(window_s)

    def evaluate(self, store, now: float) -> Optional[dict]:
        starving = []
        worst = 0.0
        for sname, labels, _latest in store.latest_series():
            if sname != "tenant_queued" or "tenant" not in labels:
                continue
            pts = store.window(sname, self.window_s, labels=labels, now=now)
            # queued for the WHOLE window (same discipline as StallRule:
            # a queue that just filled is starting, not starved)
            if len(pts) < 2 or pts[0][0] > now - self.window_s * 0.8:
                continue
            if any(v <= 0 for _, v in pts):
                continue
            rate = store.rate(
                "tenant_completed", self.window_s, labels=labels, now=now,
            )
            if rate is not None and rate > 0:
                continue
            starving.append(labels["tenant"])
            worst = max(worst, pts[-1][1])
        if not starving:
            return None
        return {
            "metric": "tenant_queued",
            "value": worst,
            "threshold": 0,
            "tenants": sorted(starving),
            "window_s": self.window_s,
        }


class DispatchSaturationRule(AlertRule):
    """Fire when the dispatch loop is pegged while the queue deepens:
    ``dispatch_utilization`` at or above ``threshold`` across the ENTIRE
    window while ``queue_depth`` stays positive and does not shrink — the
    coordinator-saturation shape. Distinct from :class:`StallRule`: tasks
    ARE completing, the host just can't dispatch them any faster — adding
    workers past this point buys nothing."""

    def __init__(
        self, name: str = "dispatch_saturation", threshold: float = 0.9,
        window_s: float = 20.0, description: str = "",
        severity: str = "critical",
    ):
        super().__init__(name, description, severity)
        self.threshold = float(threshold)
        self.window_s = float(window_s)

    def evaluate(self, store, now: float) -> Optional[dict]:
        util_pts = store.window(
            "dispatch_utilization", self.window_s, now=now
        )
        # utilization pegged for the WHOLE window (same full-coverage
        # discipline as StallRule: a briefly-busy loop is working, not
        # saturated)
        if len(util_pts) < 2 or util_pts[0][0] > now - self.window_s * 0.8:
            return None
        if any(v < self.threshold for _, v in util_pts):
            return None
        depth_pts = store.window("queue_depth", self.window_s, now=now)
        if len(depth_pts) < 2 or any(v <= 0 for _, v in depth_pts):
            return None
        if depth_pts[-1][1] < depth_pts[0][1]:
            return None  # the backlog is draining: saturated but coping
        return {
            "metric": "dispatch_utilization",
            "value": round(float(util_pts[-1][1]), 6),
            "threshold": self.threshold,
            "queue_depth": depth_pts[-1][1],
            "window_s": self.window_s,
        }


class SloBurnRateRule(AlertRule):
    """Multi-window multi-burn-rate SLO alert (the SRE-workbook shape).

    The service's :class:`~cubed_tpu_torch.observability.slo.SloBoard`
    publishes each tenant's burn rate over four windows as
    ``slo_burn_{5m,1h,6h,3d}{tenant=...}`` series (burn 1.0 = spending
    the error budget exactly as fast as the objective tolerates). A
    rule pairs a LONG window (the page signal: enough evidence that the
    budget is truly bleeding) with a SHORT window (the reset signal:
    the alert clears quickly once the bleeding stops) and fires for any
    tenant whose burn exceeds ``threshold`` on BOTH.

    Two instances ship in :func:`default_rules`: ``slo_fast_burn``
    (5m + 1h at 14.4x — page-grade, that pace empties a 3-day budget in
    ~5 hours) and ``slo_slow_burn`` (6h + 3d at 1x — warn-grade, a
    sustained slow leak). Stale series (a closed service) are no-data,
    not a firing."""

    STALE_AFTER_S = 10.0

    def __init__(
        self, name: str, long_window: str, short_window: str,
        threshold: float, description: str = "",
        severity: str = "warning",
    ):
        super().__init__(name, description, severity)
        self.long_series = f"slo_burn_{long_window}"
        self.short_series = f"slo_burn_{short_window}"
        self.threshold = float(threshold)

    def evaluate(self, store, now: float) -> Optional[dict]:
        burning = []
        worst = 0.0
        for sname, labels, _latest in store.latest_series():
            if sname != self.long_series or "tenant" not in labels:
                continue
            long_pt = store.latest_point(self.long_series, labels=labels)
            short_pt = store.latest_point(self.short_series, labels=labels)
            ok = True
            for pt in (long_pt, short_pt):
                if pt is None or now - pt[0] > self.STALE_AFTER_S:
                    ok = False  # a frozen board must not page forever
                    break
            if not ok:
                continue
            if long_pt[1] >= self.threshold and short_pt[1] >= self.threshold:
                burning.append(labels["tenant"])
                worst = max(worst, float(long_pt[1]), float(short_pt[1]))
        if not burning:
            return None
        return {
            "metric": self.long_series,
            "value": round(worst, 4),
            "threshold": self.threshold,
            "tenants": sorted(burning),
            "short_window": self.short_series,
        }


def default_rules(retry_budget_hint: float = 50.0) -> list:
    """The standing rule set, covering the runtime's known failure shapes.

    ``retry_budget_hint`` sizes the burn-rate rule when no compute-specific
    budget is known (the resilience layer sizes real budgets off the task
    count; 50 matches a mid-sized compute's allowance)."""
    return [
        BurnRateRule(
            "retry_budget_burn", counter="task_retries",
            budget=retry_budget_hint, burn_frac=0.2, window_s=60.0,
            description="task retries consumed >=20% of the retry budget "
            "within a minute: failures are systemic, the circuit breaker "
            "is next",
        ),
        ThresholdRule(
            "fleet_memory_pressure", metric="fleet_pressured_fraction",
            threshold=0.5, severity="critical",
            description=">=50% of live fleet workers report memory "
            "pressure: admission control is degrading throughput; raise "
            "allowed_mem, shrink chunks, or add workers",
        ),
        ThresholdRule(
            "straggler_rate", metric="stragglers_detected", rate=True,
            threshold=0.2, window_s=30.0,
            description="stragglers detected faster than 1 per 5s over "
            "30s: a slow worker or skewed chunking is serializing the "
            "compute",
        ),
        StallRule(
            "queue_depth_stall",
            description="tasks are queued but none completed for a whole "
            "window: a wedged fleet or a dead dispatch loop",
        ),
        ThresholdRule(
            "peer_fetch_fallback_spike", metric="peer_fetch_fallbacks",
            rate=True, threshold=1.0, window_s=30.0,
            description="peer fetches falling back to the store >1/s: "
            "the p2p data plane is degraded (cache pressure, peer churn, "
            "or network faults) — correctness is unaffected, the "
            "store-read savings are gone",
        ),
        TenantStarvationRule(
            description="a tenant has had queued requests for a whole "
            "window with zero completions: check the service dispatcher, "
            "the tenant's quota weight, and whether another tenant's "
            "long computes hold every admission slot",
        ),
        DispatchSaturationRule(
            description="the dispatch loop ran >=90% busy for a whole "
            "window while the ready queue kept growing: the coordinator "
            "is the bottleneck, not the fleet — check the top DISPATCH "
            "panel, pull the folded dispatch profile, reduce fleet size "
            "or batch dispatch",
        ),
        ThresholdRule(
            "store_brownout", metric="store_throttled", rate=True,
            threshold=0.5, window_s=30.0, severity="critical",
            description="the store is answering 429/503/SlowDown faster "
            "than 1 per 2s over 30s: a brownout — the per-store health "
            "breaker is pacing storage concurrency (check "
            "store_breaker_state); expect degraded throughput, raise "
            "provisioned store throughput or lean on the peer data plane",
        ),
        ThresholdRule(
            "overload_shedding", metric="overload_level",
            threshold=2, severity="critical",
            description="the service's degradation ladder reached L2+: "
            "deadline-infeasible requests are failed at admission and "
            "new batch submits are rejected with retry-after hints "
            "(L3 rejects everything) — check the top OVERLOAD row, the "
            "overload_level decisions for the signals that drove it, "
            "and drain or widen the fleet",
        ),
        ThresholdRule(
            "tenant_breaker_open", metric="tenant_breakers_open",
            threshold=1,
            description="at least one tenant's circuit breaker is open "
            "(consecutive request failures hit the trip threshold): "
            "that tenant's submits are rejected until a half-open probe "
            "succeeds — check its tenant_breaker decisions and whether "
            "a poison request (poison_quarantine) is the root cause",
        ),
        SloBurnRateRule(
            "slo_fast_burn", long_window="1h", short_window="5m",
            threshold=14.4, severity="critical",
            description="a tenant's SLO error budget is burning >=14.4x "
            "faster than its objective tolerates on BOTH the 1h and 5m "
            "windows — at this pace a 3-day budget empties in ~5 hours; "
            "page-grade: check the top SLO panel, the tenant's "
            "slo_request_latency quantiles, and run "
            "python -m cubed_tpu_torch.regress to name the regressed bucket",
        ),
        SloBurnRateRule(
            "slo_slow_burn", long_window="3d", short_window="6h",
            threshold=1.0, severity="warning",
            description="a tenant's SLO error budget is being spent "
            "faster than it accrues on BOTH the 3d and 6h windows — a "
            "sustained slow leak that will exhaust the budget before "
            "the compliance window rolls; warn-grade: schedule the "
            "regression hunt before it becomes a page",
        ),
    ]


class AlertEngine:
    """Evaluates rules against a :class:`TimeSeriesStore` each tick."""

    def __init__(
        self, store, rules: Optional[list] = None, cooldown_s: float = 60.0,
    ):
        self.store = store
        self.rules = list(rules) if rules is not None else default_rules()
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        #: rule name -> {"active": bool, "last_fired": ts}
        self._state = {
            r.name: {"active": False, "last_fired": 0.0} for r in self.rules
        }
        self.firings: deque = deque(maxlen=MAX_FIRINGS)

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            self.rules.append(rule)
            self._state[rule.name] = {"active": False, "last_fired": 0.0}

    def tick(self, now: Optional[float] = None) -> list:
        """Evaluate every rule; returns the firings this tick produced."""
        if now is None:
            now = time.time()
        fired = []
        with self._lock:
            rules = list(self.rules)
        for rule in rules:
            try:
                details = rule.evaluate(self.store, now)
            except Exception:
                logger.exception("alert rule %s failed to evaluate", rule.name)
                continue
            state = self._state.setdefault(
                rule.name, {"active": False, "last_fired": 0.0}
            )
            if details is None:
                state["active"] = False
                continue
            rising = not state["active"]
            state["active"] = True
            if not rising and now - state["last_fired"] < self.cooldown_s:
                continue  # sustained condition inside its cooldown window
            state["last_fired"] = now
            firing = self._fire(rule, details, now)
            fired.append(firing)
        return fired

    def _fire(self, rule: AlertRule, details: dict, now: float) -> dict:
        from .collect import record_decision

        firing = {
            "ts": now,
            "rule": rule.name,
            "severity": rule.severity,
            "description": rule.description,
        }
        firing.update(details)
        with self._lock:
            self.firings.append(firing)
        get_registry().counter("alerts_fired").inc()
        record_decision(
            "alert_fired", rule=rule.name, severity=rule.severity,
            metric=details.get("metric"), value=details.get("value"),
            threshold=details.get("threshold"),
        )
        logger.warning(
            "ALERT %s [%s]: %s=%s crossed %s — %s",
            rule.name, rule.severity, details.get("metric"),
            details.get("value"), details.get("threshold"),
            rule.description or "(no description)",
        )
        return firing

    def recent(self, n: int = 50) -> list:
        """The last ``n`` firings, oldest first."""
        with self._lock:
            return list(self.firings)[-n:]

    def active(self) -> list:
        """Names of rules currently in the active (condition-true) state."""
        with self._lock:
            return [name for name, s in self._state.items() if s["active"]]


def format_alert_row(firing: dict) -> str:
    """One firing as a fixed-width row — the shared format both
    ``python -m cubed_tpu_torch.top`` and ``python -m cubed_tpu_torch.diagnose``
    render (callers prepend their own timestamp/flag column)."""
    return (
        f"{firing.get('severity', '?'):<9}"
        f"{firing.get('rule', '?'):<28}"
        f"{firing.get('metric', '')}={firing.get('value', '')} "
        f"(threshold {firing.get('threshold', '')})"
    )
