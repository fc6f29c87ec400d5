"""Backpressure, deadlines and serve observability; the counterpart of
``jimm_tpu/serve/admission.py``.

- a bounded queue: past ``max_queue`` pending requests a submission is
  rejected at once with :class:`QueueFullError` (503);
- per-request deadlines: a request that outlives its deadline gets
  :class:`DeadlineExceededError` (504) and is dropped at dispatch;
- graceful degradation: once the queue holds ``shed_fraction`` of its bound
  (:attr:`AdmissionPolicy.shed_depth`) the batcher stops waiting out its
  coalescing window.

:class:`ServeMetrics` keeps counters, gauges and latency histograms in a
:class:`~jimm_tpu_torch.obs.registry.MetricRegistry` published under the
``jimm_serve`` namespace, with the reference's series names, its Prometheus
text rendering and its flat ``snapshot()``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

from jimm_tpu_torch.obs.registry import MetricRegistry, publish


class ServeError(Exception):
    """Base class of typed serving errors; carries an HTTP status and a
    stable machine-readable code for clients."""

    code = "serve_error"
    http_status = 500


class QueueFullError(ServeError):
    code = "queue_full"
    http_status = 503


class ThrottledError(ServeError):
    """A tenant over its rate or queue quota: never admitted; the 429
    carries a Retry-After hint."""

    code = "throttled"
    http_status = 429

    def __init__(self, message: str, *, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class ShedError(ServeError):
    """Request evicted from the queue under overload to make room for a
    higher-priority class; a 503 typed apart from queue-full."""

    code = "shed"
    http_status = 503

    def __init__(self, message: str, *, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineExceededError(ServeError):
    code = "deadline_exceeded"
    http_status = 504


class RequestError(ServeError):
    """Malformed request (wrong image shape, bad payload)."""

    code = "bad_request"
    http_status = 400


class EngineClosedError(ServeError):
    code = "engine_closed"
    http_status = 503


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Queue bound, default deadline, and the shed watermark."""

    max_queue: int = 256
    default_timeout_s: float = 5.0
    shed_fraction: float = 0.5

    @property
    def shed_depth(self) -> int:
        """Queue depth at which coalescing stops waiting (>= 1 so an empty
        queue never counts as pressure)."""
        return max(1, int(self.max_queue * self.shed_fraction))


class ServeMetrics:
    """Counters, gauges, and bounded latency windows for p50/p99, safe to
    update from the engine loop, executor threads and handler threads.

    ``observe_phase`` records a request's time in one dispatch phase
    (queue / pad / device / readback); ``bind_gauge`` registers a callable
    gauge evaluated at snapshot time. Every instrument lives in a registry
    published under ``jimm_serve`` (the newest server's wins)."""

    COUNTERS = ("requests_total", "responses_total", "timeouts_total",
                "rejected_total", "cancelled_total", "shed_batches_total",
                "errors_total", "batches_total", "batch_items_total",
                "batch_slots_total")

    PHASES = ("queue", "pad", "device", "readback")

    def __init__(self, latency_window: int = 4096):
        self._lock = threading.Lock()
        self.registry = publish(MetricRegistry("jimm_serve"))
        self._counters = {name: self.registry.counter(name)
                          for name in self.COUNTERS}
        self._latency = self.registry.histogram(
            "request_latency_seconds", window=latency_window)
        self._phases = {name: self.registry.histogram(
            f"span_{name}_seconds", window=latency_window)
            for name in self.PHASES}
        self._gauges: dict[str, Callable[[], float]] = {}
        self.queue_depth = 0
        self._t_start = time.monotonic()
        self.registry.gauge("queue_depth", lambda: self.queue_depth)
        self.registry.gauge("batch_fill_ratio",
                            lambda: round(self.batch_fill_ratio, 4))
        self.registry.gauge("uptime_s",
                            lambda: round(time.monotonic()
                                          - self._t_start, 3))

    # -- observation ------------------------------------------------------

    def inc(self, name: str, by: float = 1) -> None:
        with self._lock:
            counter = self._counters.get(name)
            if counter is None:
                counter = self._counters[name] = self.registry.counter(name)
        counter.inc(by)

    def set_queue_depth(self, depth: int) -> None:
        self.queue_depth = depth

    def observe_batch(self, items: int, bucket: int, *,
                      shed: bool = False) -> None:
        self._counters["batches_total"].inc()
        self._counters["batch_items_total"].inc(items)
        self._counters["batch_slots_total"].inc(bucket)
        if shed:
            self._counters["shed_batches_total"].inc()

    def observe_latency(self, seconds: float) -> None:
        self._latency.observe(seconds)

    def observe_phase(self, phase: str, seconds: float) -> None:
        """Record one request's time in a dispatch phase."""
        hist = self._phases.get(phase)
        if hist is None:
            with self._lock:
                hist = self._phases.setdefault(
                    phase, self.registry.histogram(f"span_{phase}_seconds"))
        hist.observe(seconds)

    def bind_gauge(self, name: str, fn: Callable[[], float]) -> None:
        self._gauges[name] = fn
        self.registry.gauge(name, fn)

    # -- derived ----------------------------------------------------------

    def count(self, name: str) -> float:
        with self._lock:
            counter = self._counters.get(name)
        return counter.value if counter is not None else 0

    def latency_percentile(self, pct: float) -> float:
        return self._latency.percentile(pct)

    def phase_percentile(self, phase: str, pct: float) -> float:
        hist = self._phases.get(phase)
        return hist.percentile(pct) if hist is not None else 0.0

    @property
    def batch_fill_ratio(self) -> float:
        slots = self._counters["batch_slots_total"].value
        items = self._counters["batch_items_total"].value
        return items / slots if slots else 0.0

    def snapshot(self) -> dict:
        """Flat float/int dict: the healthz payload, and loggable as
        ``MetricsLogger.log(step, **metrics.snapshot())``."""
        with self._lock:
            out = {name: counter.value
                   for name, counter in self._counters.items()}
        out["queue_depth"] = self.queue_depth
        out["batch_fill_ratio"] = round(self.batch_fill_ratio, 4)
        out["latency_p50_ms"] = round(self.latency_percentile(50) * 1e3, 3)
        out["latency_p99_ms"] = round(self.latency_percentile(99) * 1e3, 3)
        for phase, hist in list(self._phases.items()):
            if hist.count:
                out[f"span_{phase}_p50_ms"] = round(
                    hist.percentile(50) * 1e3, 3)
                out[f"span_{phase}_p99_ms"] = round(
                    hist.percentile(99) * 1e3, 3)
        out["uptime_s"] = round(time.monotonic() - self._t_start, 3)
        for name, fn in list(self._gauges.items()):
            try:
                out[name] = float(fn())
            except Exception:  # noqa: BLE001 -- a bad gauge must not break /metrics
                pass
        return out

    def render_prometheus(self, prefix: str = "jimm_serve") -> str:
        """Prometheus text exposition of the snapshot (counters keep their
        ``_total`` names; everything else renders as a gauge)."""
        lines = []
        for key, value in sorted(self.snapshot().items()):
            kind = "counter" if key.endswith("_total") else "gauge"
            lines.append(f"# TYPE {prefix}_{key} {kind}")
            lines.append(f"{prefix}_{key} {value}")
        return "\n".join(lines) + "\n"


class AdmissionController:
    """Applies an :class:`AdmissionPolicy` at the submit boundary."""

    def __init__(self, policy: AdmissionPolicy | None = None,
                 metrics: ServeMetrics | None = None):
        self.policy = policy or AdmissionPolicy()
        self.metrics = metrics or ServeMetrics()

    def admit(self, queue_depth: int) -> None:
        """Raise :class:`QueueFullError` when the queue is at capacity."""
        if queue_depth >= self.policy.max_queue:
            self.metrics.inc("rejected_total")
            raise QueueFullError(
                f"queue full ({queue_depth}/{self.policy.max_queue} pending);"
                f" retry with backoff")

    def under_pressure(self, queue_depth: int) -> bool:
        """True when the batcher should shed (skip the coalescing wait)."""
        return queue_depth >= self.policy.shed_depth

    def deadline_for(self, timeout_s: float | None, now: float) -> float:
        timeout = (self.policy.default_timeout_s
                   if timeout_s is None else timeout_s)
        return now + max(timeout, 0.0)
