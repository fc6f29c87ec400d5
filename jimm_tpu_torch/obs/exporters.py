"""Exporters for the unified metric hub: Prometheus text, JSONL, console;
the counterpart of ``jimm_tpu/obs/exporters.py``.

- :func:`render_prometheus_text` -- the text exposition format, for any
  flat ``{name: value}`` dict.
- :class:`JsonlExporter` -- one ``{"ts": ..., "phase": ..., **series}``
  line per snapshot, which ``python -m jimm_tpu_torch obs tail`` reads.
- :func:`console_table` -- an aligned two-column dump for humans.

Plus the inverse (:func:`parse_prometheus_text`) and a structural diff
(:func:`diff_snapshots`) behind ``obs diff``.
"""

from __future__ import annotations

import json
import time
from typing import Mapping, TextIO

__all__ = ["JsonlExporter", "console_table", "diff_snapshots",
           "parse_prometheus_text", "render_prometheus_text"]


def render_prometheus_text(series: Mapping[str, float]) -> str:
    """Prometheus text exposition of a flat ``{name: value}`` dict.

    The kind heuristic is the repo-wide convention: a ``*_total`` suffix
    (or a ``*_count`` histogram-count series) is a counter, everything else
    a gauge.
    """
    lines = []
    for key, value in sorted(series.items()):
        kind = ("counter" if key.endswith(("_total", "_count"))
                else "gauge")
        lines.append(f"# TYPE {key} {kind}")
        lines.append(f"{key} {value}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict[str, float]:
    """Inverse of :func:`render_prometheus_text` for the unlabeled series
    this repo emits (``# TYPE``/``# HELP`` comments ignored)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        if not name:
            continue
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


class JsonlExporter:
    """Append unified snapshots as JSONL lines, each with ``ts`` and
    ``phase`` provenance keys (what ``obs tail`` prints first)."""

    def __init__(self, path: str, phase: str = "obs"):
        self.path = path
        self.phase = phase

    def export(self, series: Mapping[str, float]) -> dict:
        rec = {"ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
               "phase": self.phase, **series}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


def console_table(series: Mapping[str, float], *,
                  title: str | None = None) -> str:
    """Aligned ``name  value`` table, sorted by name."""
    if not series:
        return "(no metrics)\n"
    width = max(len(k) for k in series)
    lines = []
    if title:
        lines.append(title)
        lines.append("-" * max(len(title), width + 8))
    for key in sorted(series):
        value = series[key]
        if isinstance(value, float) and not value.is_integer():
            lines.append(f"{key:<{width}}  {value:.6g}")
        else:
            lines.append(f"{key:<{width}}  {value:g}")
    return "\n".join(lines) + "\n"


def diff_snapshots(before: Mapping[str, float],
                   after: Mapping[str, float]) -> dict[str, dict]:
    """Structural diff of two flat snapshots.

    Returns ``{"added": {name: value}, "removed": {name: value},
    "changed": {name: {"before": a, "after": b, "delta": b - a}}}`` —
    the payload behind ``obs diff a.json b.json``.
    """
    added = {k: after[k] for k in after.keys() - before.keys()}
    removed = {k: before[k] for k in before.keys() - after.keys()}
    changed = {}
    for k in before.keys() & after.keys():
        if before[k] != after[k]:
            try:
                delta = after[k] - before[k]
            except TypeError:
                delta = float("nan")
            changed[k] = {"before": before[k], "after": after[k],
                          "delta": delta}
    return {"added": added, "removed": removed, "changed": changed}
