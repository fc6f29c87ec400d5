"""``python -m jimm_tpu_torch obs`` -- snapshot, tail, diff, timeline and
prof; the counterpart of ``jimm_tpu/obs/cli.py``.

Verbs over the exporter formats (stdlib only):

- ``snapshot`` -- fetch a ``/metrics`` endpoint (or read a saved dump) and
  print it as a console table, JSON, or raw Prometheus text; ``-o`` saves
  the parsed snapshot as JSON for a later ``diff``.
- ``tail``     -- follow a JSONL metrics file (``tail -f``, surviving the
  journal's rotation), or poll a ``/metrics`` URL and print only the
  series that changed between polls; ``--traces`` polls a server's
  ``/debug/traces`` ring.
- ``diff``     -- structural diff of two dumps (JSON snapshot or Prometheus
  text, auto-detected): added / removed / changed with deltas.
- ``timeline`` -- merge a flight-recorder journal (plus serve traces,
  profiler captures and a goodput report) into Chrome trace-event JSON
  loadable in Perfetto / ``chrome://tracing``.
- ``prof``     -- the profiler capture ring: ``ls`` committed captures,
  ``show`` a per-op table, ``diff`` two captures direction-aware (exit 1
  on regression), and ``trigger`` a deep capture on a running server.
- ``regress``  -- refused: it gates benchmark rows against baselines, and
  the port writes no such rows until its benchmark twin of ``bench.py``
  (ROADMAP.md queue 1, item 3's leftover) exists.
"""

from __future__ import annotations

import json
import os
import sys
import time
import urllib.request

from jimm_tpu_torch.obs.exporters import (console_table, diff_snapshots,
                                          parse_prometheus_text)

__all__ = ["add_obs_parser", "cmd_obs"]


def _load_dump(source: str, timeout_s: float = 10.0) -> dict[str, float]:
    """Read a metrics dump from a URL, JSON file, or Prometheus text file."""
    if source.startswith(("http://", "https://")):
        with urllib.request.urlopen(source, timeout=timeout_s) as resp:
            text = resp.read().decode("utf-8")
    else:
        with open(source) as f:
            text = f.read()
    text = text.strip()
    if text.startswith("{"):
        data = json.loads(text)
        return {k: v for k, v in data.items()
                if isinstance(v, (int, float))}
    return parse_prometheus_text(text)


def _cmd_snapshot(args) -> int:
    series = _load_dump(args.source)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(series, f, indent=2, sort_keys=True)
            f.write("\n")
    if args.json:
        print(json.dumps(series, indent=2, sort_keys=True))
    else:
        print(console_table(series, title=f"metrics: {args.source}"),
              end="")
    return 0


def _follow_lines(path: str, *, follow: bool, poll_s: float = 0.5,
                  sleep=time.sleep, should_stop=None):
    """Yield lines from ``path``, surviving journal-style rotation.

    The flight-recorder journal rotates by renaming the live file aside
    and recreating the path; a follower holding the old descriptor then
    reads EOF forever. So at EOF we re-stat the *path*: a changed inode
    (or a file shorter than our read position — truncate-in-place
    rotation) means a new file is live, and we reopen from its top.
    ``sleep``/``should_stop`` are injectable so the rotation regression
    test can drive the loop without wall-clock waits."""
    f = open(path)
    try:
        ino = os.fstat(f.fileno()).st_ino
        while True:
            line = f.readline()
            if line:
                yield line
                continue
            if not follow:
                return
            try:
                st = os.stat(path)
            except OSError:
                st = None  # mid-rotation window; poll again
            if st is not None and (st.st_ino != ino
                                   or st.st_size < f.tell()):
                f.close()
                f = open(path)
                ino = os.fstat(f.fileno()).st_ino
                continue
            if should_stop is not None and should_stop():
                return
            sleep(poll_s)
    finally:
        f.close()


def _tail_jsonl(path: str, follow: bool, *, sleep=time.sleep,
                should_stop=None, out=None) -> int:
    out = out if out is not None else sys.stdout
    for line in _follow_lines(path, follow=follow, sleep=sleep,
                              should_stop=should_stop):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        ts = rec.pop("ts", "")
        phase = rec.pop("phase", "")
        keys = ", ".join(f"{k}={v}" for k, v in sorted(rec.items()))
        print(f"{ts} [{phase}] {keys}", file=out, flush=True)
    return 0


def _tail_url(url: str, interval_s: float) -> int:
    prev: dict[str, float] = {}
    while True:
        try:
            cur = _load_dump(url)
        except OSError as e:
            print(f"# fetch failed: {e}", file=sys.stderr, flush=True)
            time.sleep(interval_s)
            continue
        changes = diff_snapshots(prev, cur)
        stamp = time.strftime("%H:%M:%S")
        for name, value in sorted(changes["added"].items()):
            print(f"{stamp} {name} = {value}", flush=True)
        for name, d in sorted(changes["changed"].items()):
            print(f"{stamp} {name} = {d['after']} ({d['delta']:+g})",
                  flush=True)
        prev = cur
        time.sleep(interval_s)


def _trace_line(row: dict) -> str:
    phases = " ".join(
        f"{p[:-2]}={row.get(p, 0.0) * 1e3:.2f}ms"
        for p in ("queue_s", "pad_s", "device_s", "readback_s")
        if isinstance(row.get(p), (int, float)))
    total = row.get("total_s")
    total_txt = f" total={total * 1e3:.2f}ms" \
        if isinstance(total, (int, float)) else ""
    return (f"{row.get('trace_id', '?')} replica={row.get('replica', '?')} "
            f"bucket={row.get('bucket', '?')} {phases}{total_txt}")


def _load_trace_rows(source: str) -> list[dict]:
    """Rows from a ``/debug/traces`` endpoint or a saved JSON dump."""
    if source.startswith(("http://", "https://")):
        url = source if source.endswith("/debug/traces") \
            else source.rstrip("/") + "/debug/traces"
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            data = json.loads(resp.read().decode("utf-8"))
    else:
        with open(source) as f:
            data = json.load(f)
    if isinstance(data, dict):
        data = data.get("traces", [])
    return [r for r in data if isinstance(r, dict)]


def _tail_traces(source: str, interval_s: float, follow: bool) -> int:
    seen: set = set()
    while True:
        try:
            rows = _load_trace_rows(source)
        except OSError as e:
            print(f"# fetch failed: {e}", file=sys.stderr, flush=True)
            rows = []
        for row in rows:
            tid = row.get("trace_id")
            if tid in seen:
                continue
            seen.add(tid)
            print(_trace_line(row), flush=True)
        if len(seen) > 4096:  # ring is small; cap the dedup set anyway
            seen = set(r.get("trace_id") for r in rows)
        if not follow and not source.startswith(("http://", "https://")):
            return 0
        time.sleep(interval_s)


def _cmd_tail(args) -> int:
    if args.traces:
        try:
            return _tail_traces(args.source, args.interval, args.follow)
        except KeyboardInterrupt:
            return 0
    if args.source.startswith(("http://", "https://")):
        try:
            return _tail_url(args.source, args.interval)
        except KeyboardInterrupt:
            return 0
    try:
        return _tail_jsonl(args.source, follow=args.follow)
    except KeyboardInterrupt:
        return 0


def _cmd_diff(args) -> int:
    before = _load_dump(args.before)
    after = _load_dump(args.after)
    d = diff_snapshots(before, after)
    if args.json:
        print(json.dumps(d, indent=2, sort_keys=True))
    else:
        for name, value in sorted(d["added"].items()):
            print(f"+ {name} = {value}")
        for name, value in sorted(d["removed"].items()):
            print(f"- {name} = {value}")
        for name, c in sorted(d["changed"].items()):
            print(f"~ {name}: {c['before']} -> {c['after']} "
                  f"({c['delta']:+g})")
        if not (d["added"] or d["removed"] or d["changed"]):
            print("(no differences)")
    return 1 if (d["added"] or d["removed"] or d["changed"]) else 0


def _cmd_timeline(args) -> int:
    from jimm_tpu_torch.obs.journal import read_events
    from jimm_tpu_torch.obs.timeline import (export_timeline,
                                             validate_chrome_trace,
                                             write_timeline)

    events = read_events(args.journal)
    traces = _load_trace_rows(args.traces) if args.traces else []
    captures = []
    if args.prof:
        from jimm_tpu_torch.obs.prof.capture import list_captures
        captures = list_captures(args.prof)
    goodput = None
    if args.goodput:
        with open(args.goodput) as f:
            report = json.load(f)
        # accept either a raw {bucket: seconds} map or a goodput report
        # with {bucket}_s keys
        goodput = {k[:-2]: v for k, v in report.items()
                   if k.endswith("_s") and isinstance(v, (int, float))} \
            or {k: v for k, v in report.items()
                if isinstance(v, (int, float))}
    trace = export_timeline(events, traces=traces, captures=captures,
                            goodput=goodput,
                            meta={"journal": str(args.journal)})
    problems = validate_chrome_trace(trace)
    if problems:
        for p in problems:
            print(f"invalid trace: {p}", file=sys.stderr)
        return 1
    out = args.out or "timeline.json"
    write_timeline(out, trace)
    n = sum(1 for e in trace["traceEvents"] if e.get("ph") != "M")
    print(f"wrote {out}: {n} events from {len(events)} journal records"
          f" + {len(traces)} serve traces + {len(captures)} captures"
          f" (open in Perfetto or chrome://tracing)")
    return 0


def _cmd_prof_ls(args) -> int:
    from jimm_tpu_torch.obs.prof.capture import list_captures
    metas = list_captures(args.dir)
    if args.json:
        print(json.dumps([{k: v for k, v in m.items() if k != "path"}
                          for m in metas], indent=2))
        return 0
    if not metas:
        print(f"(no committed captures under {args.dir})")
        return 0
    print(f"{'capture':<24} {'kind':<7} {'dur':>8} {'bytes':>10} "
          f"{'step':>7}  cid / reason")
    for m in metas:
        dur = m.get("dur_s")
        dur_txt = f"{dur:.3f}s" if isinstance(dur, (int, float)) else "?"
        step = m.get("step")
        tail = " ".join(str(x) for x in (m.get("cid"), m.get("reason"))
                        if x is not None)
        print(f"{m.get('name', '?'):<24} {m.get('kind', '?'):<7} "
              f"{dur_txt:>8} {m.get('bytes', 0):>10} "
              f"{step if step is not None else '-':>7}  {tail}")
    return 0


def _cmd_prof_show(args) -> int:
    from jimm_tpu_torch.obs.prof.opstats import (aggregate_ops,
                                                 capture_summary,
                                                 load_trace_events,
                                                 render_summary, render_table)
    events = load_trace_events(args.capture)
    print(render_summary(capture_summary(events, device=args.device)))
    print(render_table(aggregate_ops(events, device=args.device),
                       top=args.top))
    return 0


def _cmd_prof_diff(args) -> int:
    from jimm_tpu_torch.obs.prof.opstats import diff_ops, op_table, render_diff
    before = op_table(args.before, device=args.device)
    after = op_table(args.after, device=args.device)
    d = diff_ops(before, after, threshold=args.threshold, top=args.top)
    if args.json:
        print(json.dumps(d, indent=2))
    else:
        print(render_diff(d))
    return 1 if d["verdict"] == "regression" else 0


def _cmd_prof_trigger(args) -> int:
    url = args.url.rstrip("/") + "/admin/prof/trigger"
    payload: dict = {"reason": args.reason}
    if args.cid:
        payload["cid"] = args.cid
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=15.0) as resp:
            body = json.loads(resp.read().decode("utf-8"))
    except OSError as e:
        print(f"trigger failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(body, indent=2))
    return 0 if body.get("triggered") else 1


#: why ``obs regress`` is refused, and where it waits
REGRESS_NOT_PORTED = (
    "obs regress is not ported yet: it gates benchmark rows against adopted "
    "baselines (obs/baseline.py), and the port writes no benchmark rows "
    "until the torch twin of bench.py, ROADMAP.md queue 1, item 3's "
    "leftover (with the port's first benchmark)")


def _cmd_regress(args) -> int:
    raise SystemExit(REGRESS_NOT_PORTED)


def add_obs_parser(subparsers) -> None:
    """Attach the ``obs`` subcommand tree to the main CLI's subparsers."""
    p = subparsers.add_parser(
        "obs", help="metric dumps, the journal's timeline, and profiler "
                    "captures")
    p.set_defaults(func=cmd_obs)
    sub = p.add_subparsers(dest="obs_cmd", required=True)

    ps = sub.add_parser("snapshot",
                        help="fetch/read a metrics dump and print it")
    ps.add_argument("source",
                    help="/metrics URL, JSON snapshot, or Prometheus "
                         "text file")
    ps.add_argument("--json", action="store_true",
                    help="print as JSON instead of a table")
    ps.add_argument("-o", "--out", default=None,
                    help="also save the parsed snapshot as JSON")
    ps.set_defaults(obs_func=_cmd_snapshot)

    pt = sub.add_parser("tail",
                        help="follow a metrics JSONL ledger or poll a "
                             "/metrics URL")
    pt.add_argument("source", help="JSONL path or /metrics URL")
    pt.add_argument("-f", "--follow", action="store_true",
                    help="keep following a JSONL file (tail -f)")
    pt.add_argument("--interval", type=float, default=2.0,
                    help="poll interval for URLs (seconds)")
    pt.add_argument("--traces", action="store_true",
                    help="tail the serve request-trace ring "
                         "(/debug/traces) instead of metric series")
    pt.set_defaults(obs_func=_cmd_tail)

    pd = sub.add_parser("diff", help="diff two metric dumps")
    pd.add_argument("before")
    pd.add_argument("after")
    pd.add_argument("--json", action="store_true")
    pd.set_defaults(obs_func=_cmd_diff)

    px = sub.add_parser(
        "timeline",
        help="export a flight-recorder journal as Chrome trace JSON")
    px.add_argument("journal", help="journal.jsonl path (rotated segments "
                                    "are merged automatically)")
    px.add_argument("-o", "--out", default=None,
                    help="output path (default timeline.json)")
    px.add_argument("--traces", default=None,
                    help="serve traces: /debug/traces URL or saved JSON")
    px.add_argument("--goodput", default=None,
                    help="goodput report JSON to render as a bucket lane")
    px.add_argument("--prof", default=None,
                    help="capture ring dir: render committed profiler "
                         "captures as spans on a 'prof' lane")
    px.set_defaults(obs_func=_cmd_timeline)

    pp = sub.add_parser(
        "prof", help="list, analyze, and trigger profiler captures")
    psub = pp.add_subparsers(dest="prof_cmd", required=True)

    pls = psub.add_parser("ls", help="list committed captures in a ring dir")
    pls.add_argument("dir", nargs="?", default=".",
                     help="capture ring directory (default .)")
    pls.add_argument("--json", action="store_true")
    pls.set_defaults(obs_func=_cmd_prof_ls)

    psh = psub.add_parser(
        "show", help="what a capture holds and its per-op table")
    psh.add_argument("capture",
                     help="capture dir (or any dir/file holding a "
                          "*.trace.json.gz)")
    psh.add_argument("--top", type=int, default=20)
    psh.add_argument("--device", type=int, default=0,
                     help="card to aggregate (index among the trace's "
                          "cards; default the first)")
    psh.set_defaults(obs_func=_cmd_prof_show)

    pdf = psub.add_parser(
        "diff", help="direction-aware per-op diff of two captures; "
                     "exit 1 on regression")
    pdf.add_argument("before")
    pdf.add_argument("after")
    pdf.add_argument("--top", type=int, default=20)
    pdf.add_argument("--threshold", type=float, default=0.10,
                     help="per-op fractional slowdown that counts as a "
                          "regression (0.10 = 10%%)")
    pdf.add_argument("--device", type=int, default=0)
    pdf.add_argument("--json", action="store_true")
    pdf.set_defaults(obs_func=_cmd_prof_diff)

    ptr = psub.add_parser(
        "trigger", help="ask a serving server for a deep capture "
                        "(POST /admin/prof/trigger)")
    ptr.add_argument("url", help="server base URL, e.g. http://host:8000")
    ptr.add_argument("--cid", default=None,
                     help="incident correlation id to tag the capture with")
    ptr.add_argument("--reason", default="manual")
    ptr.set_defaults(obs_func=_cmd_prof_trigger)

    # accepted with the reference's flags, then refused (REGRESS_NOT_PORTED)
    pr = sub.add_parser("regress", help="not ported yet (needs the port's "
                                        "benchmark rows)")
    pr.add_argument("--measurements", default=None)
    pr.add_argument("--baselines", default=None)
    pr.add_argument("--threshold", type=float, default=0.20)
    pr.add_argument("--adopt", action="store_true")
    pr.add_argument("--note", default=None)
    pr.add_argument("--fail-on-fallback", action="store_true")
    pr.add_argument("--json", action="store_true")
    pr.set_defaults(obs_func=_cmd_regress)


def cmd_obs(args) -> int:
    return args.obs_func(args)
