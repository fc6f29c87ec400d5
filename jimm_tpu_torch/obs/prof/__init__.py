"""jimm_tpu_torch.obs.prof -- profiler captures and device-memory
observability; the counterpart of ``jimm_tpu/obs/prof``.

- :mod:`~jimm_tpu_torch.obs.prof.capture` -- the ``torch.profiler`` capture
  manager: a bounded on-disk ring of step-window captures plus deep
  captures triggered on flight-recorder cids, and
  :func:`~jimm_tpu_torch.obs.prof.capture.profiler_session`, the only other
  way to open a profiler session.
- :mod:`~jimm_tpu_torch.obs.prof.memory` -- per-card memory gauges
  (``jimm_hbm_*``) from the caching allocator, per-subsystem bytes, and
  the ``hbm_leak_suspected`` watchdog.
- :mod:`~jimm_tpu_torch.obs.prof.opstats` -- stdlib parsing of kineto's
  Chrome traces into per-op tables, a direction-aware diff, and what a
  capture holds (``obs prof ls/show/diff``, ``profile-analyze``).
"""

from jimm_tpu_torch.obs.prof.capture import (CaptureManager, TorchProfiler,
                                             configure_capture,
                                             get_capture_manager,
                                             list_captures, maybe_trigger,
                                             profiler_session, reset_capture)
from jimm_tpu_torch.obs.prof.memory import (MemoryMonitor,
                                            device_memory_rows, module_bytes)
from jimm_tpu_torch.obs.prof.opstats import (aggregate_ops, capture_summary,
                                             diff_ops, op_table, render_diff,
                                             render_summary, render_table,
                                             top_ops)

__all__ = [
    "CaptureManager", "MemoryMonitor", "TorchProfiler", "aggregate_ops",
    "capture_summary", "configure_capture", "device_memory_rows",
    "diff_ops", "get_capture_manager", "list_captures", "maybe_trigger",
    "module_bytes", "op_table", "profiler_session", "render_diff",
    "render_summary", "render_table", "reset_capture", "top_ops",
]
