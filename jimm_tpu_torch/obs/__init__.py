"""jimm_tpu_torch.obs -- observability: one metric registry with its
exporters, the flight-recorder journal, span timing, goodput, profiler
captures and device-memory gauges (``obs.prof``), and the Perfetto
timeline and the SLO burn-rate engine; the counterpart of
``jimm_tpu.obs`` (its ``baseline`` waits for the port's benchmark,
ROADMAP.md queue 1 item 3).

::

    from jimm_tpu_torch import obs

    reg = obs.get_registry("jimm_train")
    reg.counter("steps_total").inc()
    with obs.span("checkpoint_save"): ...
    acct = obs.GoodputAccounter()
    with acct.measure("data_wait"): batch = next(it)
    obs.snapshot()                               # {prefix_name: value}
    obs.render_prometheus()                      # one text dump

``JIMM_OBS=0`` (or ``obs.set_enabled(False)``) turns spans and goodput
measures into no-ops; registries keep counting.
"""

from jimm_tpu_torch.obs.exporters import (JsonlExporter, console_table,
                                          diff_snapshots,
                                          parse_prometheus_text,
                                          render_prometheus_text)
from jimm_tpu_torch.obs.goodput import BUCKETS, GoodputAccounter
from jimm_tpu_torch.obs.journal import (EventJournal, chain,
                                        configure_journal, correlate,
                                        current_cid, get_journal,
                                        new_correlation_id, read_events,
                                        reset_journal)
from jimm_tpu_torch.obs.prof import (CaptureManager, MemoryMonitor,
                                     configure_capture, get_capture_manager,
                                     maybe_trigger, reset_capture)
from jimm_tpu_torch.obs.registry import (Counter, DuplicateMetricError, Gauge,
                                         Histogram, MetricRegistry, enabled,
                                         get_registry, percentile, publish,
                                         registries, render_prometheus,
                                         set_enabled, snapshot, unpublish)
from jimm_tpu_torch.obs.slo import SloEngine, SloObjective
from jimm_tpu_torch.obs.spans import new_trace_id, span
from jimm_tpu_torch.obs.timeline import (export_timeline,
                                         validate_chrome_trace,
                                         write_timeline)

__all__ = [
    "BUCKETS", "CaptureManager", "Counter", "DuplicateMetricError",
    "EventJournal", "Gauge", "GoodputAccounter", "Histogram",
    "JsonlExporter", "MemoryMonitor", "MetricRegistry", "SloEngine",
    "SloObjective", "chain",
    "configure_capture", "configure_journal", "console_table", "correlate",
    "current_cid", "diff_snapshots", "enabled", "export_timeline",
    "get_capture_manager", "get_journal", "get_registry", "maybe_trigger",
    "new_correlation_id", "new_trace_id", "parse_prometheus_text", "percentile", "publish",
    "read_events", "registries", "render_prometheus",
    "render_prometheus_text", "reset_capture", "reset_journal",
    "set_enabled", "snapshot", "span", "unpublish", "validate_chrome_trace",
    "write_timeline",
]
