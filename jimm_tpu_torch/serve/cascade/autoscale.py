"""SLO-driven autoscaler for cascade pools: burn rates in, replans out; the
counterpart of ``jimm_tpu/serve/cascade/autoscale.py``.

A :class:`CascadeAutoscaler` is the serving twin of the training
``GoodputAdvisor``: a **bounded**, **hysteretic**, **audited** control
loop. Each :meth:`tick` samples the SLO engine's burn rates and the
weighted-fair queue depth of the watched class, keeps a sliding window of
samples, and -- after a cooldown, outside a dead band -- makes exactly ONE
clamped decision:

- sustained pressure (burn or queue high across the window) -> shift a
  replica from the cheap stage to the expensive one via ``engine.replan``
  (no fresh export off the warm AOT store), or, once replica counts
  are pinned at their bounds -- promote the cheap model's dtype via
  ``ModelPool.swap`` when a staged wider engine was provided;
- sustained calm (burn and queue well below the pressure rule's trip
  points -- a dead band, so the two rules cannot ping-pong) -> shift the
  replica back to the cheap stage, or demote the dtype again.

Every decision is journaled (``autoscale_decision`` /
``autoscale_applied``) on the autoscaler's root correlation id, appended
to the :attr:`decisions` audit list, and counted in
``autoscale_decisions_total`` -- pre-created at 0 so "the loop ran and did
nothing" is visible, distinct from "the loop never ran".
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable

from jimm_tpu_torch.obs.journal import get_journal, new_correlation_id

__all__ = ["CascadeAutoscaler", "REPLICA_BOUNDS", "ScaleTarget"]

#: hard clamp on any replica target -- no rule can push outside this
REPLICA_BOUNDS = (1, 64)


@dataclasses.dataclass
class ScaleTarget:
    """One scalable pool model.

    ``build_forwards(n)`` returns the replica forward set for ``n``
    replicas (the ``build_replica_forwards`` return shape, or a bare
    list); it must come off the warm AOT store, so that replans never
    export. ``promote``/``demote`` optionally stage a warmed engine of
    the next-wider/narrower dtype for ``ModelPool.swap``.
    """

    name: str
    engine: object
    build_forwards: Callable[[int], object]
    replicas: int
    min_replicas: int = 1
    max_replicas: int = 8
    promote: Callable[[], object] | None = None
    demote: Callable[[], object] | None = None

    def __post_init__(self):
        lo, hi = REPLICA_BOUNDS
        self.min_replicas = max(lo, int(self.min_replicas))
        self.max_replicas = min(hi, int(self.max_replicas))
        if self.min_replicas > self.max_replicas:
            raise ValueError(
                f"{self.name}: min_replicas {self.min_replicas} > "
                f"max_replicas {self.max_replicas}")
        if not self.min_replicas <= self.replicas <= self.max_replicas:
            raise ValueError(
                f"{self.name}: replicas {self.replicas} outside "
                f"[{self.min_replicas}, {self.max_replicas}]")


class CascadeAutoscaler:
    """Converts SLO burn + WFQ queue depth into residency decisions.

    Args:
        cheap / expensive: the two :class:`ScaleTarget` ends of the
            cascade (capacity shifts between them).
        slo: an :class:`~jimm_tpu_torch.obs.slo.SloEngine` to sample burn rates
            from (and, via :meth:`watch_slo`, to receive fast-burn
            transition events from).
        scheduler: the QoS scheduler whose snapshot supplies per-class
            queue depth; ``watch_class`` picks the class whose backlog
            counts as pressure.
        pool: the :class:`~jimm_tpu_torch.serve.qos.pool.ModelPool` for dtype
            swaps (only needed when targets stage promote/demote engines).
        burn_high / queue_high: the pressure trip points (operator
            policy, normally from the ``autoscale`` policy-file section).
            The calm rule trips at a quarter of each -- the dead band.
        window / cooldown: hysteresis, measured in ticks.
    """

    def __init__(self, *, cheap: ScaleTarget, expensive: ScaleTarget,
                 slo=None, scheduler=None, pool=None,
                 watch_class: str = "interactive",
                 burn_high: float = 1.0, queue_high: float = 8.0,
                 window: int = 3, cooldown: int = 2,
                 metrics=None, cid: str | None = None,
                 clock=time.monotonic):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if burn_high <= 0 or queue_high <= 0:
            raise ValueError("burn_high and queue_high must be positive")
        self.cheap = cheap
        self.expensive = expensive
        self.slo = slo
        self.scheduler = scheduler
        self.pool = pool
        self.watch_class = watch_class
        self.burn_high = float(burn_high)
        self.queue_high = float(queue_high)
        # dead band: calm only counts well below the pressure trip points,
        # so scale-up and scale-down can never alternate on one workload
        self.burn_low = self.burn_high / 4.0
        self.queue_low = self.queue_high / 4.0
        self.window = int(window)
        self.cooldown = max(0, int(cooldown))
        self.cid = cid or new_correlation_id()
        self.metrics = metrics
        self.clock = clock
        self.decisions: list[dict] = []
        self._samples: deque[dict] = deque(maxlen=self.window)
        # _since_decision is written from tick() (control-loop thread) and
        # from the SLO listener (whatever thread observe() runs on)
        self._cooldown_lock = threading.Lock()
        self._since_decision = self.cooldown  # first full window may decide
        self._tick = 0
        self._dtype_promoted = False
        if metrics is not None:
            metrics.inc("autoscale_decisions_total", 0)

    # -- sensing -----------------------------------------------------------

    def watch_slo(self, slo=None) -> None:
        """Subscribe to fast-burn transitions: entering fast burn resets
        the cooldown so the next tick may act immediately -- a page-worthy
        burn should not wait out hysteresis meant for drift."""
        slo = slo or self.slo
        if slo is None:
            raise ValueError("no SLO engine to watch")
        self.slo = slo
        slo.add_listener(self._on_burn_transition)

    def _on_burn_transition(self, tenant: str, entered: bool,
                            fast_rate: float, slow_rate: float) -> None:
        get_journal().emit("autoscale_burn_transition", cid=self.cid,
                           tenant=tenant, entered=entered,
                           fast_burn=round(fast_rate, 4),
                           slow_burn=round(slow_rate, 4))
        if entered:
            with self._cooldown_lock:
                self._since_decision = self.cooldown

    def sample(self) -> dict:
        """One sensor reading: worst-tenant burn rates + watched-class
        queue depth."""
        fast = slow = 0.0
        if self.slo is not None:
            for name in self.slo.objectives:
                fast = max(fast, self.slo.burn_rate(
                    name, self.slo.fast_window_s))
                slow = max(slow, self.slo.burn_rate(
                    name, self.slo.slow_window_s))
        depth = 0.0
        if self.scheduler is not None:
            snap = self.scheduler.snapshot()
            depth = float(sum(
                row.get("queued", 0) for row in snap["tenants"].values()
                if row.get("class") == self.watch_class))
        elif hasattr(self.expensive.engine, "metrics"):
            depth = float(self.expensive.engine.metrics.queue_depth)
        return {"fast_burn": fast, "slow_burn": slow, "queue_depth": depth}

    # -- deciding ----------------------------------------------------------

    def tick(self) -> dict | None:
        """Sample, window, and decide. Returns the decision (not yet
        applied -- run it through :meth:`apply`) or None."""
        self._tick += 1
        self._samples.append(self.sample())
        if len(self._samples) < self.window:
            return None
        with self._cooldown_lock:
            if self._since_decision < self.cooldown:
                self._since_decision += 1
                return None
        decision = self._decide()
        if decision is None:
            with self._cooldown_lock:
                self._since_decision += 1
            return None
        self._record(decision)
        return decision

    def _mean(self, name: str) -> float:
        return sum(s[name] for s in self._samples) / len(self._samples)

    def _decide(self) -> dict | None:
        burn = self._mean("fast_burn")
        depth = self._mean("queue_depth")
        window = {"fast_burn": round(burn, 4),
                  "slow_burn": round(self._mean("slow_burn"), 4),
                  "queue_depth": round(depth, 2), "ticks": self._tick}

        def shift(src: ScaleTarget, dst: ScaleTarget,
                  reason: str) -> dict | None:
            if (src.replicas - 1 < src.min_replicas
                    or dst.replicas + 1 > dst.max_replicas):
                return None
            return {"action": "shift_replica", "from": src.name,
                    "to": dst.name,
                    "replicas": {src.name: src.replicas - 1,
                                 dst.name: dst.replicas + 1},
                    "reason": reason, "window": window}

        def swap(target: ScaleTarget, factory, promoted: bool,
                 reason: str) -> dict | None:
            if factory is None or self.pool is None:
                return None
            return {"action": "swap_model", "model": target.name,
                    "promoted": promoted, "reason": reason,
                    "window": window}

        pressure = burn >= self.burn_high or depth >= self.queue_high
        calm = burn < self.burn_low and depth < self.queue_low
        if pressure:
            reason = (f"sustained pressure (burn {burn:.2f} vs "
                      f"{self.burn_high}, {self.watch_class} queue "
                      f"{depth:.1f} vs {self.queue_high}): add expensive-"
                      "stage capacity")
            decision = shift(self.cheap, self.expensive, reason)
            if decision is None and not self._dtype_promoted:
                decision = swap(self.cheap, self.cheap.promote, True,
                                reason + " (replica bounds pinned: "
                                "promote cheap-stage dtype)")
            return decision
        if calm:
            reason = (f"sustained calm (burn {burn:.2f} < {self.burn_low}, "
                      f"queue {depth:.1f} < {self.queue_low}): reclaim "
                      "cheap-stage capacity")
            if self._dtype_promoted:
                return swap(self.cheap, self.cheap.demote, False,
                            reason + " (demote cheap-stage dtype)")
            return shift(self.expensive, self.cheap, reason)
        return None

    def _record(self, decision: dict) -> None:
        self.decisions.append(decision)
        with self._cooldown_lock:
            self._since_decision = 0
        if self.metrics is not None:
            self.metrics.inc("autoscale_decisions_total")
        get_journal().emit("autoscale_decision", cid=self.cid, **decision)

    # -- acting ------------------------------------------------------------

    def _target(self, name: str) -> ScaleTarget:
        for t in (self.cheap, self.expensive):
            if t.name == name:
                return t
        raise ValueError(f"unknown scale target {name!r}")

    async def apply(self, decision: dict) -> None:
        """Execute one decision: replan both shifted engines (warm store, no
        fresh export) or hot-swap the staged dtype twin. Journals
        ``autoscale_applied`` on the root cid when done."""
        t0 = time.perf_counter()
        if decision["action"] == "shift_replica":
            for name, n in decision["replicas"].items():
                target = self._target(name)
                built = target.build_forwards(n)
                await target.engine.replan(
                    built[0] if isinstance(built, tuple) else built,
                    trace_count=(built[1] if isinstance(built, tuple)
                                 else None),
                    cid=self.cid)
                target.replicas = n
        elif decision["action"] == "swap_model":
            target = self._target(decision["model"])
            factory = target.promote if decision["promoted"] \
                else target.demote
            staged = factory()
            old = self.pool.swap(target.name, staged)
            target.engine = staged
            self._dtype_promoted = decision["promoted"]
            stop = getattr(old, "stop", None)
            if stop is not None:
                await stop()
        else:
            raise ValueError(f"unknown action {decision['action']!r}")
        get_journal().emit("autoscale_applied", cid=self.cid,
                           action=decision["action"],
                           dur_s=round(time.perf_counter() - t0, 6))

    async def step(self) -> dict | None:
        """tick() + apply() -- the body of the control loop."""
        decision = self.tick()
        if decision is not None:
            await self.apply(decision)
        return decision

    # -- introspection -----------------------------------------------------

    def describe(self) -> dict:
        """The healthz ``autoscale`` block."""
        return {
            "cid": self.cid,
            "watch_class": self.watch_class,
            "burn_high": self.burn_high,
            "queue_high": self.queue_high,
            "window": self.window,
            "cooldown": self.cooldown,
            "replicas": {self.cheap.name: self.cheap.replicas,
                         self.expensive.name: self.expensive.replicas},
            "dtype_promoted": self._dtype_promoted,
            "decisions": len(self.decisions),
            "last_decision": self.decisions[-1] if self.decisions else None,
        }
