"""jimm_tpu_torch.obs -- observability for the training loop: one metric
registry, the flight-recorder journal, span timing and goodput; the
counterpart of the parts of ``jimm_tpu.obs`` that checkpointing and
resilience use (the exporters and the profiler ring wait for ROADMAP.md
queue 1, item 10).

::

    from jimm_tpu_torch import obs

    reg = obs.get_registry("jimm_train")
    reg.counter("steps_total").inc()
    with obs.span("checkpoint_save"): ...
    acct = obs.GoodputAccounter()
    with acct.measure("data_wait"): batch = next(it)
    obs.snapshot()                               # {prefix_name: value}

``JIMM_OBS=0`` (or ``obs.set_enabled(False)``) turns spans and goodput
measures into no-ops; registries keep counting.
"""

from jimm_tpu_torch.obs.goodput import BUCKETS, GoodputAccounter
from jimm_tpu_torch.obs.journal import (EventJournal, chain,
                                        configure_journal, correlate,
                                        current_cid, get_journal,
                                        new_correlation_id, read_events,
                                        reset_journal)
from jimm_tpu_torch.obs.registry import (Counter, DuplicateMetricError, Gauge,
                                         Histogram, MetricRegistry, enabled,
                                         get_registry, percentile,
                                         registries, set_enabled, snapshot,
                                         unpublish)
from jimm_tpu_torch.obs.spans import span

__all__ = [
    "BUCKETS", "Counter", "DuplicateMetricError", "EventJournal", "Gauge",
    "GoodputAccounter", "Histogram", "MetricRegistry", "chain",
    "configure_journal", "correlate", "current_cid", "enabled",
    "get_journal", "get_registry", "new_correlation_id", "percentile",
    "read_events", "registries", "reset_journal", "set_enabled",
    "snapshot", "span", "unpublish",
]
