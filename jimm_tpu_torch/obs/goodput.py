"""Goodput accounting: classify training wall time into named buckets; the
counterpart of ``jimm_tpu/obs/goodput.py``.

Goodput is the fraction of wall time the card spends on training steps, as
opposed to warming up, waiting for data, writing checkpoints or syncing
scalars to the host. Wrap each region of the training loop in
``acct.measure("bucket")`` and ask for a :meth:`report` at the end; the
residual is attributed to ``other`` so the buckets sum to the wall time.

Buckets (the reference's fixed vocabulary):

- ``compile``    -- the first step run (first-use kernel loads, cuBLAS
                    handles, allocator warm-up)
- ``data_wait``  -- blocked on the input pipeline
- ``step``       -- the training step incl. the sync that realizes the loss
- ``checkpoint`` -- checkpoint save/restore
- ``host_sync``  -- metric logging, console/JSONL writes
- ``preemption_save`` -- SIGTERM grace-window save (initiate + final flush)
- ``lost_work``  -- wall time a preemption/restart discarded
- ``replan``, ``heal`` -- topology replans and self-heal (no port path
                    books them yet)
- ``other``      -- residual wall time not covered by a measure() region
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from jimm_tpu_torch.obs.registry import MetricRegistry, enabled, get_registry

__all__ = ["BUCKETS", "GoodputAccounter"]

BUCKETS = ("compile", "data_wait", "step", "checkpoint", "host_sync",
           "preemption_save", "lost_work", "replan", "heal")


class GoodputAccounter:
    """Wall-time ledger over the fixed bucket vocabulary, mirrored into the
    ``jimm_train`` registry as ``goodput_{bucket}_seconds_total`` counters
    plus the ``goodput_ratio`` and ``goodput_wall_s`` gauges."""

    def __init__(self, registry: MetricRegistry | None = None):
        self._lock = threading.Lock()
        self._seconds = {name: 0.0 for name in BUCKETS}
        self._t_start = time.monotonic()
        self.registry = registry if registry is not None \
            else get_registry("jimm_train")
        self._counters = {
            name: self.registry.counter(f"goodput_{name}_seconds_total")
            for name in BUCKETS}
        self.registry.gauge("goodput_ratio", self.goodput)
        self.registry.gauge("goodput_wall_s", self.wall_s)

    @contextmanager
    def measure(self, bucket: str):
        """Attribute the wrapped region's wall time to ``bucket``."""
        if bucket not in self._seconds:
            raise KeyError(f"unknown goodput bucket {bucket!r}; "
                           f"expected one of {BUCKETS}")
        if not enabled():
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._seconds[bucket] += dt
            self._counters[bucket].inc(dt)

    def add(self, bucket: str, seconds: float) -> None:
        """Attribute already-measured time."""
        if bucket not in self._seconds:
            raise KeyError(f"unknown goodput bucket {bucket!r}")
        with self._lock:
            self._seconds[bucket] += seconds
        self._counters[bucket].inc(seconds)

    def wall_s(self) -> float:
        return time.monotonic() - self._t_start

    def seconds(self, wall: float | None = None) -> dict[str, float]:
        with self._lock:
            out = dict(self._seconds)
        # the residual, clamped at 0 so overlapping regions cannot go
        # negative
        if wall is None:
            wall = self.wall_s()
        out["other"] = max(0.0, wall - sum(out.values()))
        return out

    def goodput(self) -> float:
        """step-time / wall-time, in [0, 1]."""
        wall = self.wall_s()
        if wall <= 0:
            return 0.0
        with self._lock:
            step = self._seconds["step"]
        return min(1.0, step / wall)

    def report(self, mfu: float | None = None) -> dict[str, float]:
        """Flat report: per-bucket seconds and fractions (summing to 1 by
        construction), goodput, and MFU-adjusted goodput when an MFU is
        given. Every field comes from one wall-clock sample."""
        wall = self.wall_s()
        secs = self.seconds(wall)
        out: dict[str, float] = {"wall_s": round(wall, 4)}
        for name, s in secs.items():
            out[f"{name}_s"] = round(s, 4)
            out[f"{name}_frac"] = round(s / wall, 4) if wall > 0 else 0.0
        g = min(1.0, secs["step"] / wall) if wall > 0 else 0.0
        out["goodput"] = round(g, 4)
        if mfu is not None:
            out["mfu"] = round(mfu, 4)
            out["mfu_adjusted_goodput"] = round(g * mfu, 4)
        return out
