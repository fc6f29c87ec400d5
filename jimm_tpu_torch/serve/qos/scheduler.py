"""Runtime QoS: token buckets, per-class weighted-fair dequeue, shedding;
the counterpart of ``jimm_tpu/serve/qos/scheduler.py``.

Three pieces the engine composes when a policy is configured:

- :class:`TokenBucket` — the standard refill-on-read rate limiter; a
  failed take returns the seconds until a token exists, which rides out
  to clients as ``Retry-After``.
- :class:`QosScheduler` — per-tenant runtime state (bucket, queued count)
  plus every ``jimm_serve_tenant_*`` / ``jimm_serve_class_*`` metric.
  State is keyed **only** by tenants the policy file names — anonymous
  and unknown ids share one default slot — so the tables here are bounded
  by configuration, never by traffic.
- :class:`WeightedFairQueue` — a drop-in for the engine's
  ``asyncio.Queue`` (same ``put_nowait`` / ``get`` / ``get_nowait`` /
  ``qsize`` surface) that drains per-class deques by deficit round robin,
  so under saturation each class's dequeue share converges to its
  configured weight, and FIFO order is preserved within a class. Items
  without a ``klass`` attribute (the engine's stop sentinel) sit in a
  control lane served only once every class queue is empty, so shutdown
  still drains pending work first — exactly the FIFO behavior.

Shedding is class-ordered: :meth:`WeightedFairQueue.shed_lower` evicts
the *newest* request of the *lowest-priority* non-empty class strictly
below the arriving request's class, so a higher class is never dropped
while a lower one has anything left to give back.
"""

from __future__ import annotations

import asyncio
import re
import time
from collections import deque
from typing import Callable

from jimm_tpu_torch.serve.admission import ServeMetrics, ThrottledError
from jimm_tpu_torch.serve.qos.policy import TenantRegistry, TenantSpec

__all__ = ["QosScheduler", "TokenBucket", "WeightedFairQueue"]

_METRIC_SAFE = re.compile(r"[^A-Za-z0-9_]")


def _metric_key(name: str) -> str:
    return _METRIC_SAFE.sub("_", name)


class TokenBucket:
    """Refill-on-read token bucket: ``rate`` tokens/s up to ``burst``."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float, *, now: float = 0.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_last = now

    def _refill(self, now: float) -> None:
        if now > self.t_last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now

    def peek(self, now: float) -> float:
        """Current token count WITHOUT mutating the bucket. Metrics
        scrapes and snapshots run on HTTP/exporter threads concurrently
        with the loop's :meth:`try_take`; a read-side ``_refill`` there
        races the loop's read-modify-write and can resurrect spent
        tokens. Observers compute the refilled value, never store it."""
        if now <= self.t_last:
            return self.tokens
        return min(self.burst, self.tokens + (now - self.t_last) * self.rate)

    def try_take(self, now: float) -> float:
        """Take one token. Returns 0.0 on success, else the seconds until
        a token will exist (the Retry-After hint)."""
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


class _TenantState:
    """One tenant's runtime slot: its bucket and queued-request count.
    Unknown/anonymous tenants all share the default instance."""

    __slots__ = ("spec", "bucket", "queued")

    def __init__(self, spec: TenantSpec, now: float):
        self.spec = spec
        self.bucket = (TokenBucket(spec.rate, spec.burst or
                                   max(1.0, spec.rate), now=now)
                       if spec.rate is not None else None)
        self.queued = 0


class QosScheduler:
    """Per-tenant admission (rate + quota) and the QoS metric surface.

    The engine calls :meth:`resolve` + :meth:`admit` at submit time and
    the weighted-fair queue reports dequeues/sheds back here so tenant
    queued-counts and the ``jimm_serve_{tenant,class}_*`` series stay
    consistent. ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, registry: TenantRegistry, *,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.clock = clock
        now = clock()
        # keyed by policy-file tenant names only (bounded by config):
        # resolve() maps every unknown id onto the shared default state
        self._states = {name: _TenantState(spec, now)
                        for name, spec in registry.tenants.items()}
        self._default_state = _TenantState(registry.default, now)
        self.metrics: ServeMetrics | None = None

    # -- wiring -----------------------------------------------------------

    def bind_metrics(self, metrics: ServeMetrics) -> None:
        """Pre-create every tenant/class series at zero (a tenant that is
        throttled before its first success still shows up in scrapes) and
        bind the quota gauges."""
        self.metrics = metrics
        metrics.inc("throttled_total", 0)
        metrics.inc("shed_requests_total", 0)
        for name, state in self._tenant_items():
            key = _metric_key(name)
            for series in ("requests_total", "throttled_total", "shed_total"):
                metrics.inc(f"tenant_{key}_{series}", 0)
            metrics.bind_gauge(f"tenant_{key}_queued",
                               lambda s=state: float(s.queued))
            if state.bucket is not None:
                metrics.bind_gauge(
                    f"tenant_{key}_tokens",
                    lambda s=state: round(self._peek_tokens(s), 3))
        for klass in self.registry.class_order:
            key = _metric_key(klass)
            for series in ("requests_total", "dispatched_total",
                           "shed_total"):
                metrics.inc(f"class_{key}_{series}", 0)

    def _tenant_items(self):
        yield from self._states.items()
        yield self.registry.default.name, self._default_state

    def _peek_tokens(self, state: _TenantState) -> float:
        return state.bucket.peek(self.clock())

    # -- submit-side ------------------------------------------------------

    def resolve(self, tenant: str | None) -> _TenantState:
        if tenant is None:
            return self._default_state
        return self._states.get(tenant, self._default_state)

    def rank_of(self, klass: str) -> int:
        return self.registry.rank_of(klass)

    def timeout_for(self, state: _TenantState,
                    timeout_s: float | None) -> float | None:
        """Per-tenant deadline inheritance: an explicit request timeout
        wins, else the tenant's policy deadline, else None (the admission
        policy default applies downstream)."""
        if timeout_s is not None:
            return timeout_s
        return state.spec.timeout_s

    def admit(self, state: _TenantState, now: float | None = None) -> None:
        """Rate-limit + quota check; raises :class:`ThrottledError` (429)
        with a Retry-After hint. Queue-capacity overload is NOT handled
        here — that is the class-ordered shed path in the engine."""
        spec = state.spec
        self._inc(f"tenant_{_metric_key(spec.name)}_requests_total")
        self._inc(f"class_{_metric_key(spec.klass)}_requests_total")
        if (spec.max_queued is not None
                and state.queued >= spec.max_queued):
            self._count_throttle(state)
            raise ThrottledError(
                f"tenant {spec.name!r} max_queued quota "
                f"({spec.max_queued}) exhausted", retry_after_s=0.05)
        if state.bucket is not None:
            wait = state.bucket.try_take(self.clock() if now is None
                                         else now)
            if wait > 0.0:
                self._count_throttle(state)
                raise ThrottledError(
                    f"tenant {spec.name!r} rate limit "
                    f"({spec.rate:g}/s) exceeded",
                    retry_after_s=round(wait, 4))

    # -- queue-side accounting (called by WeightedFairQueue) --------------

    def on_enqueue(self, state: _TenantState) -> None:
        state.queued += 1

    def on_dequeue(self, req) -> None:
        state = getattr(req, "tenant", None)
        if state is not None:
            state.queued -= 1
        self._inc(f"class_{_metric_key(req.klass)}_dispatched_total")

    def on_shed(self, req) -> None:
        state = getattr(req, "tenant", None)
        if state is not None:
            state.queued -= 1
            self._inc(f"tenant_{_metric_key(state.spec.name)}_shed_total")
        self._inc(f"class_{_metric_key(req.klass)}_shed_total")
        self._inc("shed_requests_total")

    def _count_throttle(self, state: _TenantState) -> None:
        self._inc(f"tenant_{_metric_key(state.spec.name)}_throttled_total")
        self._inc("throttled_total")

    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

    # -- surfaces ---------------------------------------------------------

    def snapshot(self) -> dict:
        """The healthz ``qos`` block: policy + live per-tenant state."""
        m = self.metrics
        now = self.clock()

        def _count(name):
            return m.count(name) if m is not None else 0

        tenants = {}
        for name, state in self._tenant_items():
            key = _metric_key(name)
            row = {"class": state.spec.klass, "queued": state.queued,
                   "requests": _count(f"tenant_{key}_requests_total"),
                   "throttled": _count(f"tenant_{key}_throttled_total"),
                   "shed": _count(f"tenant_{key}_shed_total")}
            if state.bucket is not None:
                row["rate"] = state.spec.rate
                row["tokens"] = round(state.bucket.peek(now), 3)
            if state.spec.max_queued is not None:
                row["max_queued"] = state.spec.max_queued
            tenants[name] = row
        classes = {}
        for klass in self.registry.class_order:
            key = _metric_key(klass)
            classes[klass] = {
                "weight": self.registry.classes[klass].weight,
                "rank": self.registry.classes[klass].rank,
                "requests": _count(f"class_{key}_requests_total"),
                "dispatched": _count(f"class_{key}_dispatched_total"),
                "shed": _count(f"class_{key}_shed_total")}
        return {"tenants": tenants, "classes": classes}


class WeightedFairQueue:
    """Deficit-round-robin per-class queue with the ``asyncio.Queue``
    surface the engine's batcher uses (single consumer).

    Each visit to a class grants it ``weight`` credits; serving one
    request costs one credit, and an emptied class forfeits its balance
    (classic DRR), so under saturation class ``c`` receives
    ``weight_c / sum(weights)`` of dequeues while an idle class costs the
    others nothing.
    """

    def __init__(self, scheduler: QosScheduler):
        self.scheduler = scheduler
        registry = scheduler.registry
        self._order = list(registry.class_order)
        self._weights = {n: registry.classes[n].weight for n in self._order}
        self._ranks = {n: registry.classes[n].rank for n in self._order}
        self._queues: dict[str, deque] = {n: deque() for n in self._order}
        self._control: deque = deque()
        self._deficit = {n: 0.0 for n in self._order}
        self._cursor = 0
        self._size = 0
        self._waiter: asyncio.Future | None = None

    # -- asyncio.Queue surface -------------------------------------------

    def qsize(self) -> int:
        return self._size

    def empty(self) -> bool:
        return self._size == 0 and not self._control

    def put_nowait(self, item) -> None:
        klass = getattr(item, "klass", None)
        if klass is None or klass not in self._queues:
            self._control.append(item)
        else:
            self._queues[klass].append(item)
            self._size += 1
        if self._waiter is not None and not self._waiter.done():
            self._waiter.set_result(None)

    def get_nowait(self):
        req = self._next()
        if req is not None:
            self.scheduler.on_dequeue(req)
            return req
        if self._control:
            return self._control.popleft()
        raise asyncio.QueueEmpty

    async def get(self):
        while True:
            try:
                return self.get_nowait()
            except asyncio.QueueEmpty:
                self._waiter = asyncio.get_running_loop().create_future()
                try:
                    await self._waiter
                finally:
                    self._waiter = None

    # -- DRR core ---------------------------------------------------------

    def _next(self):
        if self._size == 0:
            return None
        order, queues, deficit = self._order, self._queues, self._deficit
        n = len(order)
        while True:
            name = order[self._cursor]
            q = queues[name]
            if q and deficit[name] >= 1.0:
                deficit[name] -= 1.0
                self._size -= 1
                return q.popleft()
            if not q:
                deficit[name] = 0.0  # an emptied class forfeits its credit
            self._cursor = (self._cursor + 1) % n
            nxt = order[self._cursor]
            w = self._weights[nxt]
            deficit[nxt] = min(deficit[nxt] + w, 2.0 * max(w, 1.0))

    # -- class-ordered shedding ------------------------------------------

    def shed_lower(self, rank: int):
        """Evict and return the newest queued request of the lowest-
        priority non-empty class strictly below ``rank`` (None when every
        lower class is empty — the arriving request must then be refused
        instead). Priority order is honored unconditionally: a class is
        only touched when every class below it has nothing queued."""
        for name in reversed(self._order):
            if self._ranks[name] <= rank:
                return None
            q = self._queues[name]
            if q:
                req = q.pop()
                self._size -= 1
                self.scheduler.on_shed(req)
                return req
        return None
