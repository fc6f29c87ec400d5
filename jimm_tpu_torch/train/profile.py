"""Profiling hooks: a ``torch.profiler`` capture of training steps, readable
in Perfetto or ``chrome://tracing``, and an offline per-op analyzer
(``python -m jimm_tpu_torch profile-analyze DIR``); the counterpart of
``jimm_tpu/train/profile.py``.

:func:`trace` runs on :func:`jimm_tpu_torch.obs.prof.capture
.profiler_session`, the process-wide lock that the ``--prof-ring`` ring
also takes, so a one-shot ``--profile-dir`` capture and the ring never
overlap. The parsing lives in :mod:`jimm_tpu_torch.obs.prof.opstats`; this
module keeps the :class:`OpStat` shape the CLI prints."""

from __future__ import annotations

import collections
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path

from jimm_tpu_torch.obs.prof.opstats import op_table


@contextmanager
def trace(log_dir: str | Path):
    """Capture a host + device trace of the enclosed steps into
    ``log_dir`` (a ``*.pt.trace.json.gz``)::

        with trace("/tmp/profile"):
            for _ in range(3):
                train_step(...)
    """
    from jimm_tpu_torch.obs.prof.capture import profiler_session
    with profiler_session(log_dir):
        yield


def annotate(name: str):
    """Named region that shows up in the trace timeline."""
    import torch
    return torch.profiler.record_function(name)


@dataclass
class OpStat:
    """One device op (kernel, memcpy, memset; ``cpu_op`` in a capture
    without a card) aggregated over its occurrences. ``bytes_accessed`` is
    the total over all occurrences, None where the trace records none (a
    kernel)."""

    name: str
    category: str
    total_us: float
    count: int
    bytes_accessed: int | None
    long_name: str

    @property
    def gbps(self) -> float | None:
        """Achieved bytes/s in GB/s; None where the bytes are unknown."""
        if self.bytes_accessed is None:
            return None
        if not self.total_us:
            return 0.0
        return self.bytes_accessed / (self.total_us * 1e-6) / 1e9


def op_stats(log_dir: str | Path, *, device: int | None = 0) -> list[OpStat]:
    """Device-op totals from the newest ``*.trace.json.gz`` under
    ``log_dir`` (written by :func:`trace`); ``device`` picks one card (the
    first by default), None sums every card."""
    return [OpStat(**row) for row in op_table(log_dir, device=device)]


def summarize(stats: list[OpStat], top: int = 25, steps: int = 1) -> str:
    """Human-readable per-op and per-category summary. ``steps`` divides the
    totals so numbers read as per training step; bytes a trace does not
    record print as '?'. A capture without device events (its rows
    ``cpu_op`` self times) says so in the first line."""
    total = sum(s.total_us for s in stats)
    by_cat = collections.Counter()
    for s in stats:
        by_cat[s.category] += s.total_us
    what = ("host op self time" if stats and all(
        s.category == "cpu_op" for s in stats) else "device op time")
    lines = [f"{what}: {total / steps / 1e3:.2f} ms/step",
             "by category (ms/step):"]
    for cat, us in by_cat.most_common():
        lines.append(f"  {us / steps / 1e3:9.2f}  {cat}")
    lines.append(f"top {top} ops (ms/step, n/step, MB/occurrence, GB/s):")
    for s in stats[:top]:
        if s.bytes_accessed is None:
            size, rate = f"{'?':>8}MB", f"{'?':>6}GB/s"
        else:
            per_occ = s.bytes_accessed / max(s.count, 1)
            size, rate = f"{per_occ / 1e6:8.1f}MB", f"{s.gbps:6.0f}GB/s"
        lines.append(
            f"  {s.total_us / steps / 1e3:8.2f} n={s.count // steps:4d} "
            f"{size} {rate}  {s.name[:44]:44s} {s.long_name[:60]}")
    return "\n".join(lines)
