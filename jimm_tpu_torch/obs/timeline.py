"""Perfetto/Chrome-trace timeline export: journal + serve traces + goodput;
the counterpart of ``jimm_tpu/obs/timeline.py``.

Merges four sources into one ``chrome://tracing`` / Perfetto-loadable
JSON object (the `Trace Event Format`_):

- **journal events** — instant ("i") markers on per-subsystem lanes, or
  complete ("X") spans when the record carries a ``dur_s`` payload field;
  the correlation id becomes the event's ``args.cid`` so an incident's
  chain is searchable in the UI.
- **serve request traces** — rows of the serve engine's trace ring
  (``recent_traces``, served at ``/debug/traces``): each request becomes a
  stack of queue/pad/device/readback spans on its replica's lane, placed
  backwards from the recorded ``done_mono``.
- **goodput buckets** — a final accounter report rendered as consecutive
  per-bucket spans on a synthetic ``goodput`` lane (relative placement:
  buckets are cumulative ledgers, not intervals, so the lane shows
  proportions, anchored at the trace origin).
- **profiler captures** — committed capture metas from the continuous
  profiling ring (``obs prof``): each capture window becomes an "X" span
  on the ``prof`` lane, carrying its incident cid, so a deep capture sits
  visually under the heal/replan/SLO event that triggered it.

All timestamps share the ``time.monotonic()`` clock the journal and the
serve dispatcher stamp, shifted so the earliest event sits at t=0 (Chrome
trace ``ts``/``dur`` are microseconds).

.. _Trace Event Format:
   https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = [
    "captures_to_trace_events", "export_timeline", "goodput_to_trace_events",
    "journal_to_trace_events", "traces_to_trace_events",
    "validate_chrome_trace", "write_timeline",
]

_PID = 1
_US = 1e6

# journal event-name prefix -> lane (tid) name
_LANES = (
    (("preempt", "grace", "attempt", "restart", "supervise", "checkpoint",
      "mesh", "restore"), "train"),
    (("replica", "heal", "replan", "probe", "revive", "slo"), "serve"),
    (("advisor",), "advisor"),
    (("prof", "hbm"), "prof"),
)


def _lane_for(event: str) -> str:
    for prefixes, lane in _LANES:
        if event.startswith(prefixes):
            return lane
    return "events"


def _args_of(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in ("mono", "seq")}


def journal_to_trace_events(events: list[dict], *,
                            t0: float | None = None) -> list[dict]:
    """Journal records -> trace events. Records without a usable ``mono``
    timestamp (partial/corrupt rows from a truncated attempt) are skipped
    rather than corrupting the timeline."""
    usable = [e for e in events
              if isinstance(e.get("mono"), (int, float))]
    if not usable:
        return []
    if t0 is None:
        t0 = min(e["mono"] for e in usable)
    out = []
    for rec in usable:
        dur_s = rec.get("dur_s")
        base = {
            "name": str(rec.get("event", "event")),
            "pid": _PID,
            "tid": _lane_for(str(rec.get("event", ""))),
            "cat": "journal",
            "args": _args_of(rec),
        }
        if isinstance(dur_s, (int, float)) and dur_s > 0:
            base.update(ph="X",
                        ts=max(0.0, (rec["mono"] - dur_s - t0)) * _US,
                        dur=dur_s * _US)
        else:
            base.update(ph="i", ts=max(0.0, rec["mono"] - t0) * _US,
                        s="p")
        out.append(base)
    return out


_TRACE_PHASES = ("queue_s", "pad_s", "device_s", "readback_s")


def traces_to_trace_events(rows: list[dict], *,
                           t0: float | None = None) -> list[dict]:
    """Serve ``recent_traces`` rows -> per-phase request spans.

    Rows need ``done_mono`` (stamped by the dispatcher) to be placed on the
    shared clock; legacy rows without it are skipped. Phases are laid end to
    end finishing at ``done_mono`` — the dispatcher measures them as
    consecutive stopwatch segments, so that reconstruction is exact up to
    the unmeasured inter-phase glue."""
    usable = [r for r in rows
              if isinstance(r.get("done_mono"), (int, float))]
    if not usable:
        return []
    if t0 is None:
        t0 = min(r["done_mono"] - r.get("total_s", 0.0) for r in usable)
    out = []
    for row in usable:
        tid = f"replica{row.get('replica', '?')}"
        cursor = row["done_mono"] - sum(
            row.get(p, 0.0) or 0.0 for p in _TRACE_PHASES)
        for phase in _TRACE_PHASES:
            dur = float(row.get(phase, 0.0) or 0.0)
            out.append({
                "name": phase[:-2],
                "ph": "X",
                "pid": _PID,
                "tid": tid,
                "cat": "serve",
                "ts": max(0.0, cursor - t0) * _US,
                "dur": dur * _US,
                "args": {"trace_id": row.get("trace_id"),
                         "bucket": row.get("bucket")},
            })
            cursor += dur
    return out


def captures_to_trace_events(metas: list[dict], *,
                             t0: float | None = None) -> list[dict]:
    """Committed capture metas (``list_captures``) -> spans on the ``prof``
    lane. Metas stamp ``start_mono``/``end_mono`` on the same monotonic
    clock the journal uses, so a deep capture lines up under the heal or
    replan that triggered it; ``args.cid`` makes the incident searchable
    from the capture span too."""
    usable = [m for m in metas
              if isinstance(m.get("start_mono"), (int, float))
              and isinstance(m.get("end_mono"), (int, float))]
    if not usable:
        return []
    if t0 is None:
        t0 = min(m["start_mono"] for m in usable)
    out = []
    for m in usable:
        out.append({
            "name": f"capture:{m.get('kind', 'window')}",
            "ph": "X",
            "pid": _PID,
            "tid": "prof",
            "cat": "prof",
            "ts": max(0.0, m["start_mono"] - t0) * _US,
            "dur": max(0.0, m["end_mono"] - m["start_mono"]) * _US,
            "args": {"cid": m.get("cid"), "capture": m.get("name"),
                     "kind": m.get("kind"), "reason": m.get("reason"),
                     "bytes": m.get("bytes"), "step": m.get("step")},
        })
    return out


def goodput_to_trace_events(buckets: dict[str, float], *,
                            t0_us: float = 0.0) -> list[dict]:
    """A ``{bucket: seconds}`` ledger -> consecutive spans on one lane."""
    out = []
    cursor = t0_us
    for bucket, seconds in buckets.items():
        if not isinstance(seconds, (int, float)) or seconds <= 0:
            continue
        out.append({
            "name": bucket, "ph": "X", "pid": _PID, "tid": "goodput",
            "cat": "goodput", "ts": cursor, "dur": seconds * _US,
            "args": {"seconds": seconds},
        })
        cursor += seconds * _US
    return out


def export_timeline(journal_events: list[dict], *,
                    traces: list[dict] = (),
                    captures: list[dict] = (),
                    goodput: dict[str, float] | None = None,
                    meta: dict | None = None) -> dict:
    """Merge all sources into one Chrome trace object.

    Empty inputs are fine — the result is a valid (possibly event-free)
    trace, so exporting a partial or crashed attempt always succeeds."""
    monos = [e["mono"] for e in journal_events
             if isinstance(e.get("mono"), (int, float))]
    monos += [r["done_mono"] - r.get("total_s", 0.0) for r in traces
              if isinstance(r.get("done_mono"), (int, float))]
    monos += [m["start_mono"] for m in captures
              if isinstance(m.get("start_mono"), (int, float))]
    t0 = min(monos) if monos else 0.0
    events = journal_to_trace_events(journal_events, t0=t0)
    events += traces_to_trace_events(list(traces), t0=t0)
    events += captures_to_trace_events(list(captures), t0=t0)
    if goodput:
        events += goodput_to_trace_events(goodput)
    tids = sorted({e["tid"] for e in events})
    metadata = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
                 "args": {"name": "jimm_tpu_torch flight recorder"}}]
    metadata += [{"name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
                  "args": {"name": str(tid)}} for tid in tids]
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("tid", "")))
    return {
        "traceEvents": metadata + events,
        "displayTimeUnit": "ms",
        "otherData": dict(meta or {},
                          exporter="jimm_tpu_torch.obs.timeline"),
    }


def validate_chrome_trace(trace) -> list[str]:
    """Structural validation against the trace-event schema; returns a list
    of problems (empty == valid). Used by CI so a malformed export fails
    loudly instead of silently refusing to load in the UI."""
    problems: list[str] = []
    if not isinstance(trace, dict):
        return ["trace must be a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            problems.append(f"{where}: missing/empty name")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "M", "C", "b", "e", "n"):
            problems.append(f"{where}: bad phase {ph!r}")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event with bad dur {dur!r}")
        if "pid" not in ev or "tid" not in ev:
            problems.append(f"{where}: missing pid/tid")
    return problems


def write_timeline(path: str | Path, trace: dict) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
        f.write("\n")
    return path
