"""The port's observability core (``jimm_tpu_torch.obs``: the registry, the
journal, spans, goodput) against the JAX package's jax-free modules: the
same calls through both give equal snapshots, equal event sequences (all
fields but the clock's) and equal correlation chains. Exact equality
throughout; only wall-clock fields are left out."""

import json

import pytest

import jimm_tpu.obs as jax_obs
from jimm_tpu.obs import goodput as jax_goodput
from jimm_tpu.obs import journal as jax_journal
from jimm_tpu.obs import registry as jax_registry
from jimm_tpu.obs import spans as jax_spans
from jimm_tpu_torch import obs
from jimm_tpu_torch.obs import goodput, journal, registry, spans

PACKAGES = {"jax": (jax_registry, jax_journal, jax_spans, jax_goodput),
            "port": (registry, journal, spans, goodput)}


@pytest.fixture(autouse=True)
def _enabled():
    prev = (jax_registry.enabled(), registry.enabled())
    jax_registry.set_enabled(True)
    registry.set_enabled(True)
    yield
    jax_registry.set_enabled(prev[0])
    registry.set_enabled(prev[1])


def _drive_registry(reg_mod, prefix):
    reg = reg_mod.MetricRegistry(prefix)
    c = reg.counter("requests_total")
    c.inc()
    c.inc(4)
    reg.counter("seconds_total").inc(0.25)
    reg.gauge("depth").set(3.5)
    reg.gauge("bound", lambda: 7)
    reg.gauge("bound", lambda: 8)  # re-bind: latest wins
    reg.gauge("broken", lambda: 1 / 0)  # skipped in the snapshot
    h = reg.histogram("lat_seconds", window=3)
    for v in (5.0, 1.0, 4.0, 2.0, 3.0):
        h.observe(v)
    errors = []
    for kind in ("gauge", "histogram"):
        with pytest.raises(reg_mod.DuplicateMetricError) as e:
            getattr(reg, kind)("requests_total")
        errors.append(str(e.value))
    return reg.snapshot(), errors, (h.count, h.sum, h.percentile(50))


def test_registry_snapshots_match():
    assert _drive_registry(registry, "t_port") \
        == _drive_registry(jax_registry, "t_port")


HUNDRED = [float(i) for i in range(1, 101)]


@pytest.mark.parametrize("values,pct", [([], 50), ([3.0], 99),
                                        (HUNDRED, 50), (HUNDRED, 99),
                                        ([9.0, 1.0, 5.0, 7.0], 75)])
def test_percentile_matches(values, pct):
    assert registry.percentile(values, pct) == \
        jax_registry.percentile(values, pct)


def test_hub_snapshot_matches():
    snaps = []
    for reg_mod in (registry, jax_registry):
        reg = reg_mod.get_registry("t_hub_port")
        assert reg_mod.get_registry("t_hub_port") is reg
        reg.counter("a_total").inc(2)
        reg.histogram("b_seconds").observe(0.5)
        try:
            snaps.append({k: v for k, v in reg_mod.snapshot().items()
                          if k.startswith("t_hub_port_")})
        finally:
            reg_mod.unpublish("t_hub_port")
    assert snaps[0] == snaps[1] and snaps[0]["t_hub_port_a_total"] == 2


def _canonical(events):
    """Events without their clock fields, cids renamed by first
    appearance (each package mints from its own process counter)."""
    names: dict[str, str] = {}
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("ts", "mono")}
        if e["cid"] is not None:
            e["cid"] = names.setdefault(e["cid"], f"cid{len(names)}")
        out.append(e)
    return out


def _drive_journal(jmod, path):
    j = jmod.EventJournal(path, max_bytes=600, max_segments=3)
    try:
        a = jmod.new_correlation_id()
        b = jmod.new_correlation_id()
        j.emit("standalone", step=0)
        with jmod.correlate(a):
            j.emit("outer", step=1)
            with jmod.correlate(None):
                j.emit("still_outer")
            with jmod.correlate(b):
                j.emit("inner", step=2, nested={"k": [1, 2]})
                assert jmod.current_cid() == b
            j.emit("explicit", cid=b)
            j.emit("after_inner")
        assert jmod.current_cid() is None
        chains = [j.chain(a), j.chain(b)]
        for i in range(12):  # rotates past the oldest segment
            j.emit("filler", i=i, pad="x" * 40)
        events = j.events()
        ring = j.tail(3)
    finally:
        j.close()
    segments = sorted(p.name for p in path.parent.iterdir())
    return (_canonical(events), [_canonical(c) for c in chains],
            _canonical(ring), segments)


def test_journal_events_chains_and_rotation_match(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _drive_journal(jax_journal, tmp_path / "jax" / "journal.jsonl")
    got = _drive_journal(journal, tmp_path / "port" / "journal.jsonl")
    assert got == want
    events, chains, _, segments = got
    # rotated to the limit: journal.jsonl, then .1 (newest) to .3
    assert segments == ["journal.1.jsonl", "journal.2.jsonl",
                        "journal.3.jsonl", "journal.jsonl"]
    assert [e["event"] for e in chains[0]] == ["outer", "still_outer",
                                               "after_inner"]
    assert [e["event"] for e in chains[1]] == ["inner", "explicit"]


@pytest.mark.parametrize("name", ["jax", "port"])
def test_journal_reader_skips_a_truncated_tail(tmp_path, name):
    jmod = PACKAGES[name][1]
    path = tmp_path / "j.jsonl"
    j = jmod.EventJournal(path)
    j.emit("first")
    j.close()
    with open(path, "a") as f:
        f.write('{"seq": 1, "event": "trunc')  # a crash mid-record
    j = jmod.EventJournal(path)  # starts its first record on a new line
    j.emit("second")
    j.close()
    assert [e["event"] for e in jmod.read_events(path)] == ["first",
                                                            "second"]


def test_global_journal_matches(tmp_path, monkeypatch):
    got = []
    for jmod, sub in ((journal, "port"), (jax_journal, "jax")):
        jmod.reset_journal()
        try:
            monkeypatch.setenv("JIMM_JOURNAL", str(tmp_path / sub / "j.jsonl"))
            first = jmod.get_journal()
            assert jmod.get_journal() is first
            first.emit("from_env")
            second = jmod.configure_journal(None)
            second.emit("in_memory")
            got.append((_canonical(jmod.read_events(first.path)),
                        _canonical(second.events())))
        finally:
            jmod.reset_journal()
    assert got[0] == got[1]


def test_echo_lines_match(capsys):
    lines = []
    for jmod in (journal, jax_journal):
        j = jmod.EventJournal(None, echo=True)
        j.emit("restart", cid="c1-0001", attempt=2, backoff_s=0.5)
        j.emit("quiet", echo=False)
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1] == \
        '[journal] restart cid=c1-0001 attempt=2 backoff_s=0.5\n'


def test_spans_time_into_the_span_registry():
    counts = []
    for reg_mod, span_mod in ((registry, spans), (jax_registry, jax_spans)):
        reg_mod.unpublish(span_mod.SPAN_NAMESPACE)
        for _ in range(3):
            with span_mod.span("t_port_region"):
                pass
        reg_mod.set_enabled(False)
        with span_mod.span("t_port_region") as s:
            assert type(s).__name__ == "_NoopSpan"
        reg_mod.set_enabled(True)
        snap = reg_mod.get_registry(span_mod.SPAN_NAMESPACE).snapshot()
        counts.append(sorted(k for k in snap))
        assert snap["t_port_region_seconds_count"] == 3
        reg_mod.unpublish(span_mod.SPAN_NAMESPACE)
    assert counts[0] == counts[1]


def _drive_goodput(reg_mod, gp_mod):
    reg = reg_mod.MetricRegistry("t_goodput")
    acct = gp_mod.GoodputAccounter(reg)
    acct.add("step", 0.5)
    acct.add("checkpoint", 0.25)
    acct.add("lost_work", 0.125)
    with acct.measure("host_sync"):
        pass
    errors = []
    for call in (lambda: acct.add("nope", 1.0),
                 lambda: acct.measure("nope").__enter__()):
        with pytest.raises(KeyError) as e:
            call()
        errors.append(str(e.value))
    secs = acct.seconds(wall=2.0)
    # a measured region and the residual hold wall-clock time
    measured = secs.pop("host_sync")
    assert secs.pop("other") == pytest.approx(2.0 - 0.875 - measured)
    report = acct.report(mfu=0.5)
    snap = reg.snapshot()
    counters = {k: v for k, v in snap.items()
                if k.endswith("_seconds_total") and "host_sync" not in k}
    return (gp_mod.BUCKETS, secs, sorted(report), counters, errors,
            sorted(snap))


def test_goodput_matches():
    got = _drive_goodput(registry, goodput)
    assert got == _drive_goodput(jax_registry, jax_goodput)
    assert got[1]["lost_work"] == 0.125


def test_package_exports_the_ported_names():
    assert set(obs.__all__) <= set(jax_obs.__all__)
    assert {"GoodputAccounter", "EventJournal", "span", "snapshot",
            "get_registry", "correlate", "render_prometheus", "publish",
            "CaptureManager", "MemoryMonitor", "export_timeline",
            "JsonlExporter"} <= set(obs.__all__)


def test_journal_records_are_json_lines(tmp_path):
    j = journal.EventJournal(tmp_path / "j.jsonl")
    j.emit("a", value=object())  # not JSON: rendered with str()
    j.close()
    rec = json.loads((tmp_path / "j.jsonl").read_text())
    assert rec["event"] == "a" and rec["value"].startswith("<object")
