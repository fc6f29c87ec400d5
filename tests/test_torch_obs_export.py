"""The port's metric exporters, the registry's hub additions and the
Perfetto timeline (``jimm_tpu_torch/obs/exporters.py``, ``registry.py``,
``timeline.py``) against the JAX package's on the same series and journal
events; both sides are stdlib code, no JAX runs."""

import json

import pytest

from jimm_tpu.obs import exporters as jex
from jimm_tpu.obs import registry as jreg
from jimm_tpu.obs import timeline as jtl
from jimm_tpu_torch.obs import exporters as tex
from jimm_tpu_torch.obs import registry as treg
from jimm_tpu_torch.obs import timeline as ttl
from jimm_tpu_torch.obs.journal import EventJournal

SERIES = [
    {"jimm_train_steps_total": 12, "jimm_train_loss": 0.25,
     "jimm_spans_save_seconds_count": 3, "jimm_hbm_device0_bytes": 1e9,
     "jimm_x_ratio": 1.0 / 3.0, "jimm_y": -2},
    {},
    {"a_total": 1.5, "b": 7.0, "c_count": 0},
]


@pytest.mark.parametrize("series", SERIES)
def test_prometheus_text_and_tables_match_jax(series):
    text = tex.render_prometheus_text(series)
    assert text == jex.render_prometheus_text(series)
    assert tex.parse_prometheus_text(text) == jex.parse_prometheus_text(text)
    assert tex.console_table(series, title="t") == jex.console_table(
        series, title="t")


def test_diff_snapshots_and_jsonl_match_jax(tmp_path):
    before = {"a": 1, "b": 2.5, "gone": 3, "s": "x"}
    after = {"a": 1, "b": 4.0, "new": 9, "s": "y"}
    got, want = tex.diff_snapshots(before, after), jex.diff_snapshots(
        before, after)
    # nan deltas (a non-numeric pair) compare by repr
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    rec = tex.JsonlExporter(str(tmp_path / "t.jsonl"), phase="p").export(
        {"x": 1})
    ref = jex.JsonlExporter(str(tmp_path / "j.jsonl"), phase="p").export(
        {"x": 1})
    assert set(rec) == set(ref) and rec["phase"] == "p" and rec["x"] == 1
    line = json.loads((tmp_path / "t.jsonl").read_text())
    assert line == rec


def test_registry_hub_additions_match_jax():
    for mod in (treg, jreg):
        reg = mod.MetricRegistry("jimm_test_export")
        reg.counter("hits_total").inc(4)
        reg.gauge("depth").set(2.5)
        reg.histogram("lat_seconds").observe(0.5)
        assert mod.publish(reg) is reg
        assert mod.get_registry("jimm_test_export") is reg
        assert reg.uptime_s >= 0.0
    try:
        tdump, jdump = treg.render_prometheus(), jreg.render_prometheus()
        mine = [ln for ln in tdump.splitlines() if "jimm_test_export" in ln]
        ref = [ln for ln in jdump.splitlines() if "jimm_test_export" in ln]
        assert mine == ref and len(mine) == 2 * 6
        reg = treg.get_registry("jimm_test_export")
        reg.reset()
        assert reg.snapshot() == {}
        replaced = treg.publish(treg.MetricRegistry("jimm_test_export"))
        assert treg.get_registry("jimm_test_export") is replaced
    finally:
        treg.unpublish("jimm_test_export")
        jreg.unpublish("jimm_test_export")


def _journal_events() -> list[dict]:
    j = EventJournal()
    j.emit("preempt_detected", cid="c1", step=3)
    j.emit("checkpoint_saved", cid="c1", dur_s=0.25, step=3)
    j.emit("prof_capture_committed", cid="c2", dur_s=0.5, bytes=10)
    j.emit("hbm_leak_suspected", cid="c3")
    j.emit("replica_down")
    j.emit("something_else", dur_s=0)
    events = list(j.events())
    # a partial record (a truncated attempt) is skipped by both
    events.append({"event": "broken"})
    return events


def test_timeline_matches_jax():
    events = _journal_events()
    t0 = min(e["mono"] for e in events if "mono" in e)
    traces = [{"done_mono": t0 + 0.3, "total_s": 0.2, "queue_s": 0.05,
               "pad_s": 0.01, "device_s": 0.1, "readback_s": 0.04,
               "replica": 0, "trace_id": "t1", "bucket": 8},
              {"trace_id": "legacy"}]
    captures = [{"start_mono": t0 + 0.1, "end_mono": t0 + 0.4,
                 "kind": "deep", "cid": "c2", "name": "cap-000001-deep",
                 "bytes": 10, "step": None, "reason": "admin"}]
    goodput = {"step": 1.5, "data_wait": 0.25, "checkpoint": 0.0}
    kwargs = dict(traces=traces, captures=captures, goodput=goodput,
                  meta={"journal": "j.jsonl"})
    got = ttl.export_timeline(events, **kwargs)
    want = jtl.export_timeline(events, **kwargs)
    # the exporter names itself
    assert got["otherData"].pop("exporter") == "jimm_tpu_torch.obs.timeline"
    assert want["otherData"].pop("exporter") == "jimm_tpu.obs.timeline"
    assert got["traceEvents"][0]["args"]["name"] == \
        "jimm_tpu_torch flight recorder"
    got["traceEvents"][0]["args"]["name"] = \
        want["traceEvents"][0]["args"]["name"]
    assert got == want
    assert ttl.validate_chrome_trace(got) == []
    assert {e["tid"] for e in got["traceEvents"]} >= {
        "train", "prof", "serve", "goodput", "replica0", "events"}


@pytest.mark.parametrize("trace", [
    [], {"traceEvents": "x"},
    {"traceEvents": [1, {"name": "", "ph": "Q", "ts": -1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "dur": -1,
                      "pid": 1, "tid": 1}]},
    {"traceEvents": [{"name": "m", "ph": "M", "pid": 1, "tid": 0}]},
])
def test_validate_chrome_trace_matches_jax(trace, tmp_path):
    assert ttl.validate_chrome_trace(trace) == jtl.validate_chrome_trace(
        trace)
    if isinstance(trace, dict) and not ttl.validate_chrome_trace(trace):
        path = ttl.write_timeline(tmp_path / "sub" / "t.json", trace)
        assert json.loads(path.read_text()) == trace
