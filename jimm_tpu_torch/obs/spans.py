"""Span timer: ``span("name")`` records a region's host wall time into the
``jimm_spans`` registry histogram ``{name}_seconds``; the counterpart of
``jimm_tpu/obs/spans.py``. While a ``torch.profiler`` session records on
the calling thread, the region is also a ``record_function`` range of the
same name, so host logs and the captured trace share one vocabulary
(torch is never imported here: the bridge works only where it is loaded).

Disabled mode (``JIMM_OBS=0`` or ``obs.set_enabled(False)``) returns one
shared no-op context manager: no allocation, no clock reads.
"""

from __future__ import annotations

import sys
import time

from jimm_tpu_torch.obs.registry import enabled, get_registry

__all__ = ["span"]

SPAN_NAMESPACE = "jimm_spans"


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "_t0", "_annotation")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0
        self._annotation = None

    def __enter__(self):
        torch = sys.modules.get("torch")
        if torch is not None and torch.autograd._profiler_enabled():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        get_registry(SPAN_NAMESPACE).histogram(
            f"{self.name}_seconds").observe(dt)
        return False


def span(name: str):
    """Time a region under ``name``: the elapsed wall time lands in the
    ``jimm_spans`` registry as ``{name}_seconds`` (p50/p99/count/sum in the
    unified snapshot)."""
    if not enabled():
        return _NOOP
    return _Span(name)
