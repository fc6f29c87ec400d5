"""Metric registry: counters, gauges, histograms, and the process-wide hub
that merges every namespace's series into one snapshot; the counterpart of
``jimm_tpu/obs/registry.py``.

Every instrument lives in a :class:`MetricRegistry` under a namespace
prefix (``jimm_train``, ``jimm_spans``); :func:`get_registry` keeps one
per prefix in a process-global hub, and :func:`snapshot` returns their
union as one flat ``{prefix_name: value}`` dict; :func:`render_prometheus`
renders that union as one Prometheus text dump.

Thread safety: counters and histograms take a per-instrument lock; gauges
are evaluated at snapshot time and a raising gauge is skipped.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Iterable

__all__ = [
    "Counter", "DuplicateMetricError", "Gauge", "Histogram", "MetricRegistry",
    "enabled", "get_registry", "percentile", "publish", "registries",
    "render_prometheus", "set_enabled", "snapshot", "unpublish",
]


class DuplicateMetricError(ValueError):
    """Raised when a metric name is re-registered as a different kind (the
    same-kind re-request returns the existing instrument instead)."""


_enabled = os.environ.get("JIMM_OBS", "1").lower() not in ("0", "false", "off")


def enabled() -> bool:
    """True unless observability is switched off (``JIMM_OBS=0``). Span and
    goodput instrumentation become no-ops when disabled; registries keep
    counting."""
    return _enabled


def set_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)


def percentile(values: Iterable[float], pct: float) -> float:
    """Nearest-rank percentile over ``values`` (0 on empty input)."""
    data = sorted(values)
    if not data:
        return 0.0
    idx = min(len(data) - 1, int(round(pct / 100.0 * (len(data) - 1))))
    return data[idx]


class Counter:
    """Monotonic counter. Prometheus convention: name it ``*_total``."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, by: int | float = 1) -> None:
        with self._lock:
            self._value += by

    @property
    def value(self) -> int | float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value: either set explicitly (``set``) or bound to a
    callable evaluated at snapshot time."""

    __slots__ = ("name", "_value", "fn")

    def __init__(self, name: str, fn: Callable[[], float] | None = None):
        self.name = name
        self._value = 0.0
        self.fn = fn

    def set(self, value: float) -> None:
        self._value = value

    def read(self) -> float:
        """Current value; raises whatever a bound callable raises (the
        registry snapshot catches it)."""
        if self.fn is not None:
            return float(self.fn())
        return self._value


class Histogram:
    """Bounded-reservoir histogram with nearest-rank percentiles: the last
    ``window`` observations plus an unbounded count and sum."""

    __slots__ = ("name", "_window", "_count", "_sum", "_lock", "unit")

    def __init__(self, name: str, window: int = 4096, unit: str = "s"):
        self.name = name
        self.unit = unit
        self._window: deque[float] = deque(maxlen=window)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._window.append(value)
            self._count += 1
            self._sum += value

    def percentile(self, pct: float) -> float:
        with self._lock:
            data = list(self._window)
        return percentile(data, pct)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict[str, float]:
        """Flat series: ``{name}_p50``/``_p99`` (window), ``{name}_count``
        and ``{name}_sum`` (lifetime)."""
        with self._lock:
            data = list(self._window)
            count, total = self._count, self._sum
        return {
            f"{self.name}_p50": percentile(data, 50),
            f"{self.name}_p99": percentile(data, 99),
            f"{self.name}_count": count,
            f"{self.name}_sum": round(total, 6),
        }


class MetricRegistry:
    """One namespace of instruments; series render as ``{prefix}_{name}``.

    ``counter``/``histogram`` are get-or-create; asking for an existing
    name as a different kind raises :class:`DuplicateMetricError`.
    ``gauge`` with a callable re-binds (latest wins).
    """

    def __init__(self, prefix: str = "jimm"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._t_start = time.monotonic()

    def _check_free(self, name: str, kind: dict) -> None:
        for other in (self._counters, self._gauges, self._histograms):
            if other is not kind and name in other:
                raise DuplicateMetricError(
                    f"metric {name!r} already registered in "
                    f"{self.prefix!r} as a different kind")

    def counter(self, name: str) -> Counter:
        with self._lock:
            self._check_free(name, self._counters)
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str,
              fn: Callable[[], float] | None = None) -> Gauge:
        with self._lock:
            self._check_free(name, self._gauges)
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, fn)
            elif fn is not None:
                g.fn = fn
            return g

    def histogram(self, name: str, window: int = 4096,
                  unit: str = "s") -> Histogram:
        with self._lock:
            self._check_free(name, self._histograms)
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, window, unit)
            return self._histograms[name]

    @property
    def uptime_s(self) -> float:
        return time.monotonic() - self._t_start

    def snapshot(self) -> dict[str, float]:
        """Flat ``{name: value}`` dict (no prefix). Counters keep int-ness;
        gauges evaluate now (a raising gauge is skipped); histograms expand
        to their ``_p50/_p99/_count/_sum`` series."""
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        out: dict[str, float] = {}
        for c in counters:
            out[c.name] = c.value
        for h in hists:
            out.update(h.snapshot())
        for g in gauges:
            try:
                out[g.name] = g.read()
            except Exception:  # noqa: BLE001 -- a bad gauge must not
                pass           # break the snapshot
        return out

    def reset(self) -> None:
        """Drop every instrument (test isolation)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._t_start = time.monotonic()


_hub_lock = threading.Lock()
_hub: dict[str, MetricRegistry] = {}


def publish(registry: MetricRegistry) -> MetricRegistry:
    """Attach a registry to the hub under its prefix; re-publishing a prefix
    replaces the previous registry (latest wins)."""
    with _hub_lock:
        _hub[registry.prefix] = registry
    return registry


def unpublish(prefix: str) -> None:
    with _hub_lock:
        _hub.pop(prefix, None)


def get_registry(prefix: str) -> MetricRegistry:
    """The hub's shared registry for ``prefix``, created (and published) on
    first use."""
    with _hub_lock:
        reg = _hub.get(prefix)
        if reg is None:
            reg = _hub[prefix] = MetricRegistry(prefix)
        return reg


def registries() -> dict[str, MetricRegistry]:
    with _hub_lock:
        return dict(_hub)


def snapshot() -> dict[str, float]:
    """Every published registry's series under its full ``{prefix}_{name}``
    name."""
    out: dict[str, float] = {}
    for prefix, reg in sorted(registries().items()):
        for name, value in reg.snapshot().items():
            out[f"{prefix}_{name}"] = value
    return out


def render_prometheus() -> str:
    """Prometheus text exposition of the unified snapshot: ``*_total``
    series as counters, everything else as gauges."""
    from jimm_tpu_torch.obs.exporters import render_prometheus_text
    return render_prometheus_text(snapshot())
