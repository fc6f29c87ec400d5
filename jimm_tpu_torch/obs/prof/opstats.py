"""Offline analysis of profiler captures; the counterpart of
``jimm_tpu/obs/prof/opstats.py``, reading torch's Chrome trace (kineto's
``*.pt.trace.json.gz``) instead of XLA's.

A kineto trace holds two kinds of ``ph: "X"`` events:

- **device events** -- ``cat`` ``kernel``, ``gpu_memcpy`` or ``gpu_memset``,
  on the card's pid (``args.device`` names it), one per launch, CUPTI's
  record of every stream of the process. Kernels carry no byte count;
  memcpy and memset carry ``args.bytes``.
- **host events** -- ``cpu_op`` (aten operators, nested: ``aten::linear``
  holds ``aten::addmm``), ``cuda_runtime`` / ``cuda_driver`` (launch and
  copy calls, recorded by CUPTI on every thread), ``user_annotation``
  (``record_function`` regions) and the like. torch records ``cpu_op``\\ s
  only on the thread that started the profiler and the threads that
  inherit its state (autograd's device threads).

From those this module makes:

- a per-op table (``aggregate_ops`` / ``op_table`` / ``top_ops``): device
  time, launches and, where the trace knows them, bytes, of each device
  op by its full demangled name (so the ``HAS_MASK``, ``SIGMOID`` and
  ``HAS_BIAS`` instantiations of one kernel stay apart). A capture without
  device events (a CPU run) tabulates its ``cpu_op``\\ s by **self time**
  (each op's duration less that of the ops nested in it on its thread), so
  nested ops are not counted twice;
- a direction-aware diff of two tables (``diff_ops``): op time is
  lower-better, so a positive delta is a regression;
- what a capture holds and where its wall time went
  (``capture_summary``): device events, the host threads whose operators
  it recorded, the device-busy share, and the host's split into launch
  calls, other operator time and gaps.

Everything here is stdlib-only, so ``obs prof ls/show/diff`` and
``profile-analyze`` run on a machine without torch's CUDA build.
"""

from __future__ import annotations

import glob
import gzip
import json
from pathlib import Path

__all__ = [
    "DEVICE_CATEGORIES", "aggregate_ops", "capture_summary", "diff_ops",
    "find_trace_file", "load_trace_events", "op_table", "render_diff",
    "render_summary", "render_table", "top_ops",
]

#: kineto categories of the events that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: host-side categories of launch and copy calls into the CUDA runtime
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")


def find_trace_file(source: str | Path) -> Path:
    """Newest ``*.trace.json.gz`` (or ``*.trace.json``) under ``source``: a
    capture directory, a ``--profile-dir``, or the file itself."""
    source = Path(source)
    if source.is_file():
        return source
    paths = []
    for pattern in ("*.trace.json.gz", "*.trace.json"):
        paths += glob.glob(str(source / "**" / pattern), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.trace.json.gz under {source}")
    return Path(max(paths, key=lambda p: (Path(p).stat().st_mtime, p)))


def load_trace_events(source: str | Path) -> list[dict]:
    """The ``traceEvents`` list of the newest trace file under ``source``
    (gzip or plain JSON)."""
    path = find_trace_file(source)
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _complete(events: list[dict]) -> list[dict]:
    return [e for e in events if e.get("ph") == "X"
            and isinstance(e.get("ts"), (int, float))]


def _device_of(e: dict):
    return e.get("args", {}).get("device", e.get("pid"))


def _device_events(events: list[dict], device: int | None) -> list[dict]:
    """Device events of the ``device``-th card present (sorted by id), or of
    every card with ``device=None``."""
    dev = [e for e in _complete(events) if e.get("cat") in DEVICE_CATEGORIES]
    if dev and device is not None:
        ids = sorted({_device_of(e) for e in dev}, key=str)
        if device >= len(ids):
            return []
        dev = [e for e in dev if _device_of(e) == ids[device]]
    return dev


def _self_times(ops: list[dict]) -> list[tuple[dict, float]]:
    """Each op with its self time: its duration less the durations of the
    ops directly nested in it on the same thread."""
    out = []
    by_thread: dict = {}
    for e in ops:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: list[list] = []  # [event, end, self]
        for e in evs:
            end = e["ts"] + e.get("dur", 0)
            while stack and stack[-1][1] <= e["ts"]:
                out.append((stack[-1][0], stack[-1][2]))
                stack.pop()
            if stack:
                stack[-1][2] -= e.get("dur", 0)
            stack.append([e, end, float(e.get("dur", 0))])
        out += [(s[0], s[2]) for s in stack]
    return out


def aggregate_ops(events: list[dict], *,
                  device: int | None = 0) -> list[dict]:
    """Rows ``{name, category, total_us, count, bytes_accessed, long_name}``
    sorted by descending total time.

    With device events: one row per device op name (kernel, memcpy,
    memset) of ONE card, the ``device``-th present (``None``: every card);
    ``bytes_accessed`` is the sum of the events' ``args.bytes`` for
    memcpy and memset and None (unknown) for kernels, which record none.
    Without device events (a CPU capture): one row per ``cpu_op`` name by
    self time, ``bytes_accessed`` None."""
    agg: dict[str, list] = {}
    dev = _device_events(events, device)
    if dev:
        timed = [(e, float(e.get("dur", 0))) for e in dev]
    else:
        timed = _self_times([e for e in _complete(events)
                             if e.get("cat") == "cpu_op"])
    for e, us in timed:
        a = e.get("args", {})
        cat = e.get("cat", "?")
        r = agg.setdefault(e["name"], [0.0, 0, None, "", cat])
        r[0] += us
        r[1] += 1
        if "bytes" in a:
            r[2] = (r[2] or 0) + int(a["bytes"] or 0)
        if not r[3] and "grid" in a:
            r[3] = f"grid={a['grid']} block={a.get('block')}"
    rows = [{"name": k, "category": v[4], "total_us": v[0], "count": v[1],
             "bytes_accessed": v[2], "long_name": v[3]}
            for k, v in agg.items()]
    rows.sort(key=lambda r: -r["total_us"])
    return rows


def op_table(source: str | Path, *, device: int | None = 0) -> list[dict]:
    """``aggregate_ops`` over the newest trace file under ``source``."""
    return aggregate_ops(load_trace_events(source), device=device)


def top_ops(rows: list[dict], k: int = 20,
            by: str = "total_us") -> list[dict]:
    return sorted(rows, key=lambda r: -(r.get(by) or 0))[:k]


def _merged(intervals: list[tuple[float, float]]
            ) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _union_us(intervals: list[tuple[float, float]],
              within: list[tuple[float, float]] | None = None) -> float:
    """Length of the union of ``intervals`` (clipped to ``within``, a
    merged list, when given)."""
    merged = _merged(intervals)
    if within is None:
        return sum(b - a for a, b in merged)
    total = 0.0
    for a, b in merged:
        for wa, wb in within:
            if wb <= a:
                continue
            if wa >= b:
                break
            total += min(b, wb) - max(a, wa)
    return total


def _span(e: dict) -> tuple[float, float]:
    return e["ts"], e["ts"] + e.get("dur", 0)


def capture_summary(events: list[dict], *, device: int | None = 0,
                    region: str | None = None) -> dict:
    """What a capture holds and where its wall time went.

    ``wall_us`` runs from the first event to the end of the last; with a
    ``region``, it is the time inside the events of that name (a
    ``record_function`` range such as the train command's
    ``train_step``), ``regions`` of them, and every other time below is
    clipped to them. ``device_busy_us`` is the union of the device events
    of the chosen card. On the host, every instant of the wall falls in one
    of three parts, over all threads the capture recorded: a runtime call
    (``runtime_us``: ``cuda_runtime``/``cuda_driver``, launches and copies),
    else an operator (``cpu_op_us``), else a gap (``gap_us``: Python, and
    whatever the capture did not record). ``cpu_op_threads`` names the
    threads whose operators the capture holds: a capture taken from a
    thread that runs no model work holds the card's side and the runtime
    calls of every thread, but no operator of the thread that did."""
    xs = [e for e in _complete(events) if e.get("cat") != "Trace"]
    dev = _device_events(events, device)
    cpu = [e for e in xs if e.get("cat") == "cpu_op"]
    rt = [e for e in xs if e.get("cat") in RUNTIME_CATEGORIES]
    names = {(e.get("pid"), e.get("tid")): e.get("args", {}).get("name")
             for e in events if e.get("ph") == "M"
             and e.get("name") == "thread_name"}
    threads = sorted({(e.get("pid"), e.get("tid")) for e in cpu}, key=str)
    out = {"device_events": len(dev),
           "kernels": sum(e.get("cat") == "kernel" for e in dev),
           "cpu_op_events": len(cpu), "runtime_events": len(rt),
           "cpu_op_threads": [names.get(t) or f"tid {t[1]}"
                              for t in threads],
           "runtime_threads": len({(e.get("pid"), e.get("tid"))
                                   for e in rt})}
    within = None
    if region is not None:
        within = _merged([_span(e) for e in xs if e["name"] == region])
        out["regions"] = len(within)
    elif xs:
        within = [(min(e["ts"] for e in xs),
                   max(e["ts"] + e.get("dur", 0) for e in xs))]
    wall = sum(b - a for a, b in within or [])
    busy = _union_us([_span(e) for e in dev], within)
    runtime = _union_us([_span(e) for e in rt], within)
    host = _union_us([_span(e) for e in rt + cpu], within)
    return dict(out, wall_us=wall, device_busy_us=busy,
                device_busy_share=busy / wall if wall else 0.0,
                runtime_us=runtime, cpu_op_us=host - runtime,
                gap_us=max(0.0, wall - host))


def render_summary(s: dict) -> str:
    """One plain line on what a capture holds: a capture without device
    events says so first."""
    head = ("NO DEVICE EVENTS: a host-only capture "
            "(no card, or CUPTI recorded nothing)"
            if not s["device_events"] else
            f"{s['kernels']} kernel launches, {s['device_events']} device "
            f"events, device busy {s['device_busy_us'] / 1e3:.3f} ms of "
            f"{s['wall_us'] / 1e3:.3f} ms ({s['device_busy_share']:.1%})")
    threads = ", ".join(s["cpu_op_threads"]) or "none"
    return (f"{head}; host: runtime calls {s['runtime_us'] / 1e3:.3f} ms, "
            f"other operators {s['cpu_op_us'] / 1e3:.3f} ms, gaps "
            f"{s['gap_us'] / 1e3:.3f} ms; operators recorded on: {threads}")


def _fmt_bytes(row: dict) -> tuple[str, str]:
    """(MB, GB/s) columns; '?' where the trace records no bytes."""
    b = row["bytes_accessed"]
    if b is None:
        return "?", "?"
    gbps = b / (row["total_us"] * 1e-6) / 1e9 if row["total_us"] else 0.0
    return f"{b / 1e6:.2f}", f"{gbps:.1f}"


def render_table(rows: list[dict], *, top: int = 20) -> str:
    """Human-readable top-k table (us, n, MB total, GB/s; '?' where the
    trace records no bytes, as for kernels). A table of ``cpu_op`` rows (a
    capture without device events) says so in its first line."""
    total = sum(r["total_us"] for r in rows)
    what = ("host op self time" if rows and all(
        r["category"] == "cpu_op" for r in rows) else "device op time")
    lines = [f"{what}: {total / 1e3:.2f} ms over {len(rows)} ops",
             f"{'us':>10} {'n':>5} {'MB':>9} {'GB/s':>7}  name"]
    for r in rows[:top]:
        mb, gbps = _fmt_bytes(r)
        lines.append(f"{r['total_us']:10.1f} {r['count']:5d} "
                     f"{mb:>9} {gbps:>7}  {r['name'][:60]}")
    return "\n".join(lines)


def diff_ops(before: list[dict], after: list[dict], *,
             threshold: float = 0.10, top: int = 20,
             min_us: float = 1.0) -> dict:
    """Direction-aware per-op diff between two op tables.

    Op time is lower-better: an op whose ``total_us`` grew by more than
    ``threshold`` (fractionally) is a *regression*, one that shrank is an
    *improvement*. Ops below ``min_us`` in both tables are noise and
    skipped. The overall ``verdict`` is ``"regression"`` when the total
    op time grew past the threshold, else ``"ok"``."""
    b = {r["name"]: r for r in before}
    a = {r["name"]: r for r in after}
    regressions, improvements, added, removed = [], [], [], []
    for name in sorted(set(b) | set(a)):
        bu = b.get(name, {}).get("total_us", 0.0)
        au = a.get(name, {}).get("total_us", 0.0)
        if bu < min_us and au < min_us:
            continue
        if name not in b:
            added.append({"name": name, "after_us": au})
            continue
        if name not in a:
            removed.append({"name": name, "before_us": bu})
            continue
        delta = au - bu
        frac = delta / bu if bu else 0.0
        entry = {"name": name, "before_us": round(bu, 1),
                 "after_us": round(au, 1), "delta_us": round(delta, 1),
                 "delta_frac": round(frac, 4)}
        if frac > threshold:
            regressions.append(entry)
        elif frac < -threshold:
            improvements.append(entry)
    regressions.sort(key=lambda e: -e["delta_us"])
    improvements.sort(key=lambda e: e["delta_us"])
    total_b = sum(r["total_us"] for r in before)
    total_a = sum(r["total_us"] for r in after)
    total_frac = (total_a - total_b) / total_b if total_b else 0.0
    return {
        "total_before_us": round(total_b, 1),
        "total_after_us": round(total_a, 1),
        "total_delta_frac": round(total_frac, 4),
        "threshold": threshold,
        "regressions": regressions[:top],
        "improvements": improvements[:top],
        "added": added[:top],
        "removed": removed[:top],
        "verdict": "regression" if total_frac > threshold else "ok",
    }


def render_diff(d: dict) -> str:
    lines = [f"total device-op time: {d['total_before_us'] / 1e3:.2f} ms -> "
             f"{d['total_after_us'] / 1e3:.2f} ms "
             f"({d['total_delta_frac']:+.1%}) [{d['verdict']}]"]
    for label, mark in (("regressions", "REGRESSION"),
                        ("improvements", "+"),):
        for e in d[label]:
            lines.append(f"{mark} {e['name'][:56]}: {e['before_us']}us -> "
                         f"{e['after_us']}us ({e['delta_frac']:+.1%})")
    for e in d["added"]:
        lines.append(f"? new op {e['name'][:56]} ({e['after_us']}us)")
    for e in d["removed"]:
        lines.append(f"? gone op {e['name'][:56]} ({e['before_us']}us)")
    return "\n".join(lines)
