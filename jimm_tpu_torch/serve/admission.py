"""Backpressure, deadlines and request counters; the subset of
``jimm_tpu/serve/admission.py`` the engine uses.

- a bounded queue: past ``max_queue`` pending requests a submission is
  rejected at once with :class:`QueueFullError` (503);
- per-request deadlines: a request that outlives its deadline gets
  :class:`DeadlineExceededError` (504) and is dropped at dispatch;
- graceful degradation: once the queue holds :data:`SHED_FRACTION` of its
  bound the batcher stops waiting out its coalescing window.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np

#: share of ``max_queue`` at which the batcher dispatches without waiting
SHED_FRACTION = 0.5


class ServeError(Exception):
    """Base class of typed serving errors; carries an HTTP status and a
    stable machine-readable code for clients."""

    code = "serve_error"
    http_status = 500


class QueueFullError(ServeError):
    code = "queue_full"
    http_status = 503


class ShedError(ServeError):
    """Request evicted from the queue under overload."""

    code = "shed"
    http_status = 503


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
    """Queue bound and default deadline."""

    max_queue: int = 256
    default_timeout_s: float = 5.0


class ServeMetrics:
    """Plain request counters and a bounded window of request latencies,
    safe to update from the engine loop and read from handler threads."""

    COUNTERS = ("requests_total", "responses_total", "timeouts_total",
                "rejected_total", "cancelled_total", "errors_total",
                "batches_total", "batch_items_total", "batch_slots_total",
                "shed_batches_total")

    #: latencies kept for the percentiles (the newest ones)
    LATENCY_WINDOW = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self.COUNTERS, 0)
        self._latency: collections.deque[float] = collections.deque(
            maxlen=self.LATENCY_WINDOW)

    def inc(self, name: str, by: int = 1) -> None:
        if name not in self._counts:
            raise KeyError(f"unknown counter {name!r}")
        with self._lock:
            self._counts[name] += by

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts[name]

    def observe_batch(self, items: int, bucket: int, *,
                      shed: bool = False) -> None:
        with self._lock:
            self._counts["batches_total"] += 1
            self._counts["batch_items_total"] += items
            self._counts["batch_slots_total"] += bucket
            self._counts["shed_batches_total"] += int(shed)

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self._latency.append(seconds)

    def latency_percentile(self, pct: float) -> float:
        with self._lock:
            window = list(self._latency)
        return float(np.percentile(window, pct)) if window else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counts)
        slots = out["batch_slots_total"]
        out["batch_fill_ratio"] = (round(out["batch_items_total"] / slots, 4)
                                   if slots else 0.0)
        out["latency_p50_ms"] = round(self.latency_percentile(50) * 1e3, 3)
        out["latency_p99_ms"] = round(self.latency_percentile(99) * 1e3, 3)
        return out


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
        """True when the batcher should stop waiting for batch-mates (the
        watermark is >= 1, so an empty queue is never pressure)."""
        return queue_depth >= max(1, int(self.policy.max_queue
                                         * SHED_FRACTION))

    def deadline_for(self, timeout_s: float | None, now: float) -> float:
        timeout = (self.policy.default_timeout_s
                   if timeout_s is None else timeout_s)
        return now + max(timeout, 0.0)
