"""Device-memory observability: per-device gauges and a monotonic-leak
watchdog; the counterpart of ``jimm_tpu/obs/prof/memory.py``.

``MemoryMonitor.sample()`` reads each card's caching-allocator statistics
(``torch.cuda.memory_stats(i)``, ``torch.cuda.mem_get_info(i)``) and
publishes the reference's ``jimm_hbm_*`` gauges: bytes in use, peak, limit
and a fragmentation estimate. Without a card (the CPU tests) the one row
comes from the live CPU tensors the garbage collector can see, as the
reference sums ``jax.live_arrays()``; each row names its ``source``
(``"allocator"`` or ``"live_tensors"``), and on a card the rows always come
from the allocator.

**Per-subsystem attribution**: ``register_subsystem(name, fn)`` binds a
byte-counting callable (the served models' parameters and buffers) into
``jimm_hbm_subsystem_{name}_bytes``.

**Leak watchdog**: when total in-use bytes grow monotonically across
``leak_window`` consecutive samples by at least ``leak_min_growth_frac``
(and ``leak_min_growth_bytes``), it journals ``hbm_leak_suspected`` with a
fresh correlation id and the subsystem snapshot, once per episode; any
decrease closes the episode.
"""

from __future__ import annotations

import gc
import threading
import time
import warnings
from collections import deque
from typing import Callable

from jimm_tpu_torch.obs.journal import get_journal, new_correlation_id
from jimm_tpu_torch.obs.registry import get_registry

__all__ = ["MemoryMonitor", "device_memory_rows", "module_bytes"]


def _allocator_row(i: int) -> dict:
    """One card's row from its caching allocator. ``bytes_in_use`` is the
    bytes held by live tensors, ``bytes_limit`` the card's memory, and
    ``fragmentation`` the share of the allocator's reserved memory that sits
    in free pieces of split blocks (reserved, not in use, and not
    releasable as whole segments)."""
    import torch
    stats = torch.cuda.memory_stats(i)
    _free, total = torch.cuda.mem_get_info(i)
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    reserved = int(stats.get("reserved_bytes.all.current", 0))
    inactive = int(stats.get("inactive_split_bytes.all.current", 0))
    return {"device": i, "platform": "gpu", "source": "allocator",
            "bytes_in_use": in_use,
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               in_use)),
            "bytes_limit": int(total),
            "bytes_reserved": reserved,
            "fragmentation": round(inactive / reserved, 4) if reserved
            else 0.0}


def _live_tensor_row() -> dict:
    """The CPU row: the bytes of the distinct storages of the CPU tensors
    the garbage collector tracks (parameters included)."""
    import torch
    seen: dict[int, int] = {}
    with warnings.catch_warnings():
        # isinstance() on deprecated module proxies warns
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            try:
                if isinstance(obj, torch.Tensor) and obj.device.type == "cpu":
                    st = obj.untyped_storage()
                    seen[st.data_ptr()] = st.nbytes()
            except (RuntimeError, ReferenceError):  # meta/freed storages
                continue
    return {"device": 0, "platform": "cpu", "source": "live_tensors",
            "bytes_in_use": sum(seen.values()), "peak_bytes_in_use": 0,
            "bytes_limit": 0, "fragmentation": 0.0}


def device_memory_rows() -> list[dict]:
    """One row per CUDA card from its allocator; without a card, one CPU
    row from the live tensors. Each row carries its ``source``."""
    import torch
    if torch.cuda.is_available():
        return [_allocator_row(i) for i in range(torch.cuda.device_count())]
    return [_live_tensor_row()]


def module_bytes(*modules) -> int:
    """Parameter and buffer bytes of ``modules`` (each storage once)."""
    seen: dict[tuple, int] = {}
    for m in modules:
        for t in list(m.parameters()) + list(m.buffers()):
            seen[(t.device, t.untyped_storage().data_ptr())] = \
                t.untyped_storage().nbytes()
    return sum(seen.values())


class MemoryMonitor:
    """Periodic device-memory sampler + leak watchdog publishing
    ``jimm_hbm_*``.

    ``sample()`` is callable directly (train loop, tests); ``start()``
    spawns a daemon polling thread for serving processes."""

    def __init__(self, *, period_s: float = 10.0, leak_window: int = 5,
                 leak_min_growth_frac: float = 0.05,
                 leak_min_growth_bytes: int = 1 << 20,
                 journal=None, sampler: Callable[[], list[dict]]
                 | None = None):
        self.period_s = float(period_s)
        self.leak_window = max(2, int(leak_window))
        self.leak_min_growth_frac = float(leak_min_growth_frac)
        self.leak_min_growth_bytes = int(leak_min_growth_bytes)
        self._journal = journal
        self._sampler = sampler or device_memory_rows
        self._subsystems: dict[str, Callable[[], float]] = {}
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}
        self._bound: set[str] = set()
        self._totals: deque[float] = deque(maxlen=self.leak_window + 1)
        self._leak_open = False
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._reg = get_registry("jimm_hbm")
        self._samples_total = self._reg.counter("samples_total")
        self._leaks_total = self._reg.counter("leak_suspected_total")
        self.last_leak_cid: str | None = None

    def register_subsystem(self, name: str,
                           fn: Callable[[], float]) -> None:
        """Attribute bytes to a named subsystem. ``fn`` returns current
        bytes; it is called at sample time and a raising fn reports 0."""
        self._subsystems[name] = fn

    def _gauge(self, key: str, value: float) -> None:
        self._last[key] = float(value)
        if key not in self._bound:
            self._bound.add(key)
            self._reg.gauge(key, lambda k=key: self._last.get(k, 0.0))

    def sample(self) -> dict:
        """One sampling pass: refresh every gauge, run the leak check.
        Returns ``{"devices": rows, "total_bytes_in_use": n,
        "subsystems": {...}, "leak_suspected": bool}``."""
        rows = self._sampler()
        with self._lock:
            total = 0
            for row in rows:
                i = row["device"]
                total += row["bytes_in_use"]
                self._gauge(f"device{i}_bytes_in_use",
                            row["bytes_in_use"])
                self._gauge(f"device{i}_peak_bytes_in_use",
                            row["peak_bytes_in_use"])
                self._gauge(f"device{i}_bytes_limit", row["bytes_limit"])
                self._gauge(f"device{i}_fragmentation",
                            row["fragmentation"])
            self._gauge("total_bytes_in_use", total)
            subsystems = {}
            for name, fn in self._subsystems.items():
                try:
                    subsystems[name] = float(fn())
                except Exception:  # noqa: BLE001 -- attribution is best-effort; a broken counter must not stop the sampler
                    subsystems[name] = 0.0
                self._gauge(f"subsystem_{name}_bytes", subsystems[name])
            self._samples_total.inc()
            leak = self._check_leak(total, subsystems)
        return {"devices": rows, "total_bytes_in_use": total,
                "subsystems": subsystems, "leak_suspected": leak}

    def _check_leak(self, total: float, subsystems: dict) -> bool:
        self._totals.append(total)
        if len(self._totals) < self._totals.maxlen:
            return self._leak_open
        deltas = [b - a for a, b in zip(self._totals,
                                        list(self._totals)[1:])]
        if any(d <= 0 for d in deltas):
            self._leak_open = False  # any decrease closes the episode
            return False
        growth = self._totals[-1] - self._totals[0]
        base = self._totals[0] or 1.0
        if growth < self.leak_min_growth_bytes \
                or growth / base < self.leak_min_growth_frac:
            return self._leak_open
        if self._leak_open:
            return True  # one journal record per episode
        self._leak_open = True
        self._leaks_total.inc()
        cid = new_correlation_id()
        self.last_leak_cid = cid
        journal = self._journal if self._journal is not None \
            else get_journal()
        journal.emit("hbm_leak_suspected", cid=cid,
                     growth_bytes=int(growth),
                     window=self.leak_window,
                     total_bytes_in_use=int(total),
                     subsystems={k: int(v) for k, v in subsystems.items()})
        return True

    # -- background polling -----------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="jimm-hbm-monitor",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 -- a transient backend error must not end monitoring; the next tick retries
                time.sleep(0.0)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
