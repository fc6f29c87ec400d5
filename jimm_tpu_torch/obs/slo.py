"""SLO objectives and multi-window burn rates over serve traffic; the
counterpart of ``jimm_tpu/obs/slo.py``.

An :class:`SloObjective` states what "good" means for a tenant: an
availability target (fraction of requests that must succeed) and an
optional latency target (a success slower than ``latency_ms`` still counts
against the SLO). The :class:`SloEngine` consumes one observation per
finished request (ok/failed + latency) and maintains, per tenant,
per-second traffic buckets from which it computes **burn rates** over two
windows:

    burn_rate(window) = bad_fraction(window) / error_budget

where ``error_budget = 1 - availability``. A burn rate of 1.0 means the
budget is being spent exactly as provisioned; 14.4 (the classic fast-page
threshold for a 99.9% objective) means the monthly budget would be gone in
~2 days. Zero-traffic windows burn nothing (rate 0.0) — no traffic, no
spend.

:meth:`SloEngine.fast_burning` implements the standard multi-window guard:
a tenant is fast-burning only when **both** the fast window exceeds the
page threshold **and** the slow window is itself burning (>= 1.0), so a
single failed request after an idle stretch can't page. The serve engine
feeds this into the self-heal escalation path and the journal.

Metrics are published as a ``jimm_slo`` registry (``jimm_slo_*`` series in
the unified snapshot and the serving ``/metrics`` dump): per tenant,
``{tenant}_good_total`` / ``{tenant}_bad_total`` counters and
``{tenant}_fast_burn_rate`` / ``{tenant}_slow_burn_rate`` gauges. Tenant
cardinality is bounded by the policy file: only tenants with declared
objectives get series; unknown tenants fold into ``default``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from jimm_tpu_torch.obs.registry import MetricRegistry, publish

__all__ = ["SloEngine", "SloObjective", "DEFAULT_FAST_WINDOW_S",
           "DEFAULT_SLOW_WINDOW_S", "DEFAULT_FAST_BURN_THRESHOLD"]

DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 600.0
DEFAULT_FAST_BURN_THRESHOLD = 14.4


@dataclass(frozen=True)
class SloObjective:
    """What "good" means for one tenant."""

    availability: float = 0.999        # target good-fraction, in (0, 1)
    latency_ms: float | None = None    # slower-than-this successes are bad

    def __post_init__(self):
        if not 0.0 < self.availability < 1.0:
            raise ValueError(
                f"availability must be in (0, 1), got {self.availability}")
        if self.latency_ms is not None and self.latency_ms <= 0:
            raise ValueError(
                f"latency_ms must be positive, got {self.latency_ms}")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.availability

    @classmethod
    def from_dict(cls, data: dict) -> "SloObjective":
        unknown = set(data) - {"availability", "latency_ms"}
        if unknown:
            raise ValueError(f"unknown SLO objective keys: {sorted(unknown)}")
        kw = {}
        if "availability" in data:
            kw["availability"] = float(data["availability"])
        if "latency_ms" in data and data["latency_ms"] is not None:
            kw["latency_ms"] = float(data["latency_ms"])
        return cls(**kw)

    def describe(self) -> dict:
        out: dict = {"availability": self.availability}
        if self.latency_ms is not None:
            out["latency_ms"] = self.latency_ms
        return out


class _Tracker:
    """Per-second (sec, good, bad) buckets for one tenant, bounded by the
    longest window we will ever ask about."""

    def __init__(self, horizon_s: float):
        self._buckets: deque[list] = deque(maxlen=int(horizon_s) + 2)
        self.good_total = 0
        self.bad_total = 0

    def observe(self, ok: bool, now: float) -> None:
        sec = int(now)
        if not self._buckets or self._buckets[-1][0] != sec:
            self._buckets.append([sec, 0, 0])
        self._buckets[-1][1 if ok else 2] += 1
        if ok:
            self.good_total += 1
        else:
            self.bad_total += 1

    def window_counts(self, window_s: float, now: float) -> tuple[int, int]:
        lo = now - window_s
        good = bad = 0
        for sec, g, b in self._buckets:
            if sec >= lo:
                good += g
                bad += b
        return good, bad


class SloEngine:
    """Burn-rate accounting for a set of per-tenant objectives."""

    def __init__(self, objectives: dict[str, SloObjective] | None = None, *,
                 fast_window_s: float = DEFAULT_FAST_WINDOW_S,
                 slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
                 fast_burn_threshold: float = DEFAULT_FAST_BURN_THRESHOLD,
                 registry: MetricRegistry | None = None,
                 clock=time.monotonic):
        objectives = dict(objectives or {})
        objectives.setdefault("default", SloObjective())
        self.objectives = objectives
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn_threshold = float(fast_burn_threshold)
        self._clock = clock
        self._lock = threading.Lock()
        self._trackers = {name: _Tracker(self.slow_window_s)
                          for name in objectives}
        self._listeners: list = []
        self._burning: set[str] = set()
        if registry is None:
            registry = MetricRegistry("jimm_slo")
            publish(registry)
        self.registry = registry
        self._counters = {}
        for name in objectives:
            self._counters[name] = (
                registry.counter(f"{name}_good_total"),
                registry.counter(f"{name}_bad_total"))
            registry.gauge(f"{name}_fast_burn_rate",
                           lambda t=name: self.burn_rate(
                               t, self.fast_window_s))
            registry.gauge(f"{name}_slow_burn_rate",
                           lambda t=name: self.burn_rate(
                               t, self.slow_window_s))

    @classmethod
    def from_objective_dicts(cls, slo: dict[str, dict],
                             **kwargs) -> "SloEngine":
        """Build from a parsed policy-file ``slo`` section
        (``{tenant: {availability, latency_ms}}``)."""
        return cls({name: SloObjective.from_dict(spec)
                    for name, spec in slo.items()}, **kwargs)

    def _resolve(self, tenant: str | None) -> str:
        return tenant if tenant in self._trackers else "default"

    # -- write -------------------------------------------------------------

    def observe(self, tenant: str | None, ok: bool,
                latency_s: float | None = None) -> bool:
        """Account one finished request; returns whether it counted as good
        (a success slower than the tenant's latency target does not)."""
        name = self._resolve(tenant)
        obj = self.objectives[name]
        good = bool(ok)
        if good and obj.latency_ms is not None and latency_s is not None:
            good = latency_s * 1000.0 <= obj.latency_ms
        now = self._clock()
        with self._lock:
            self._trackers[name].observe(good, now)
        self._counters[name][0 if good else 1].inc()
        if self._listeners:
            self._notify_transitions()
        return good

    # -- burn-rate consumers ------------------------------------------------

    def add_listener(self, fn) -> None:
        """Register a fast-burn *transition* consumer:
        ``fn(tenant, entered, fast_rate, slow_rate)`` fires once when a
        tenant enters fast burn (``entered=True``) and once when it exits
        (``entered=False``). Transitions are evaluated on observations —
        an idle tenant's exit is reported with its next request, which is
        exactly when a consumer could act on it anyway. This is the hook
        a capacity controller hangs its decisions on."""
        self._listeners.append(fn)

    def _notify_transitions(self) -> None:
        burning = set(self.fast_burning())
        entered = burning - self._burning
        exited = self._burning - burning
        if not entered and not exited:
            return
        self._burning = burning
        for name in sorted(entered | exited):
            fast = self.burn_rate(name, self.fast_window_s)
            slow = self.burn_rate(name, self.slow_window_s)
            for fn in list(self._listeners):
                try:
                    fn(name, name in entered, fast, slow)
                except Exception:  # noqa: BLE001 — a consumer bug must not fail request accounting; surfaced as a counted error
                    self.registry.counter("listener_errors_total").inc()

    # -- read --------------------------------------------------------------

    def burn_rate(self, tenant: str | None, window_s: float) -> float:
        """bad_fraction(window) / error_budget; 0.0 at zero traffic."""
        name = self._resolve(tenant)
        now = self._clock()
        with self._lock:
            good, bad = self._trackers[name].window_counts(window_s, now)
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / self.objectives[name].error_budget

    def fast_burning(self) -> list[str]:
        """Tenants burning budget fast enough to page: fast-window burn
        over the threshold AND slow-window burn >= 1.0 (multi-window
        guard against blips)."""
        out = []
        for name in self.objectives:
            if (self.burn_rate(name, self.fast_window_s)
                    >= self.fast_burn_threshold
                    and self.burn_rate(name, self.slow_window_s) >= 1.0):
                out.append(name)
        return out

    def snapshot(self) -> dict:
        """The ``/healthz`` block: per-tenant objectives, counts, and both
        burn rates."""
        tenants = {}
        for name, obj in self.objectives.items():
            tr = self._trackers[name]
            tenants[name] = {
                "objective": obj.describe(),
                "good_total": tr.good_total,
                "bad_total": tr.bad_total,
                "fast_burn_rate": round(
                    self.burn_rate(name, self.fast_window_s), 4),
                "slow_burn_rate": round(
                    self.burn_rate(name, self.slow_window_s), 4),
            }
        burning = self.fast_burning()
        return {
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "fast_burn_threshold": self.fast_burn_threshold,
            "fast_burning": burning,
            "tenants": tenants,
        }
