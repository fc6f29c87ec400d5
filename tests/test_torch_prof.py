"""The port's profiler capture ring, device-memory watchdog and op tables
(``jimm_tpu_torch/obs/prof/``, ``train/profile.py``) against the JAX
package's: the same schedule, dedupe, eviction and quarantine with the
same files and journal events under an injected backend, the same leak
episodes, the same diff verdicts and tables on the same rows; the kineto
trace parser on a hand-built trace; and the torch backend's rules on the
CPU (a session per thread, one session at a time)."""

import gzip
import json
import os
import threading
import time

import pytest
import torch

from jimm_tpu.obs.journal import EventJournal as JaxJournal
from jimm_tpu.obs.prof import capture as jcap
from jimm_tpu.obs.prof import memory as jmem
from jimm_tpu.obs.prof import opstats as jops
from jimm_tpu.train import profile as jprofile
from jimm_tpu_torch import configs, obs
from jimm_tpu_torch.models.siglip import SigLIP
from jimm_tpu_torch.obs.journal import EventJournal
from jimm_tpu_torch.obs.prof import capture as tcap
from jimm_tpu_torch.obs.prof import memory as tmem
from jimm_tpu_torch.obs.prof import opstats as tops
from jimm_tpu_torch.train import profile as tprofile
from test_torch_siglip import tiny_config


class FakeProfiler:
    """Writes a fixed payload instead of a trace (both managers take it;
    the port's passes ``dedicated``)."""

    def __init__(self, payload_bytes: int = 512):
        self.payload_bytes = payload_bytes
        self.active_dir = None
        self.dedicated = []

    def start(self, log_dir: str, dedicated: bool = False) -> None:
        assert self.active_dir is None, "double start"
        self.active_dir = log_dir
        self.dedicated.append(dedicated)

    def stop(self) -> None:
        assert self.active_dir is not None, "stop without start"
        with open(os.path.join(self.active_dir, "fake.trace.bin"),
                  "wb") as f:
            f.write(b"x" * self.payload_bytes)
        self.active_dir = None


def managers(tmp_path, **kw):
    """The JAX package's manager and the port's, each in its own ring
    directory with its own memory-only journal and fake backend."""
    out = []
    for mod, journal_cls, name in ((jcap, JaxJournal, "jax"),
                                   (tcap, EventJournal, "port")):
        kw2 = dict(kw)
        kw2.setdefault("min_trigger_interval_s", 0.0)
        payload = kw2.pop("payload_bytes", 512)
        journal = journal_cls()
        mgr = mod.CaptureManager(tmp_path / name, journal=journal,
                                 profiler=FakeProfiler(payload), **kw2)
        out.append((mgr, journal))
    return out


def _listing(root) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def _events(journal) -> list[dict]:
    drop = ("seq", "ts", "mono", "dur_s")
    return [{k: v for k, v in r.items() if k not in drop}
            for r in journal._ring]


def _metas(mgr) -> list[dict]:
    drop = ("ts", "start_mono", "end_mono", "dur_s", "path")
    return [{k: v for k, v in m.items() if k not in drop} for m in mgr.ls()]


def _same(pair) -> None:
    (jm, jj), (tm, tj) = pair
    assert _listing(tm.root) == _listing(jm.root)
    assert _events(tj) == _events(jj)
    assert _metas(tm) == _metas(jm)
    assert tm.ring_bytes() == jm.ring_bytes()


def test_window_schedule_matches_jax(tmp_path):
    pair = managers(tmp_path, every_steps=10, window_steps=2)
    for mgr, _ in pair:
        for step in range(35):
            mgr.on_step(step)
    _same(pair)
    (_, _), (tm, tj) = pair
    assert [m["step"] for m in tm.ls()] == [2, 12, 22, 32]
    started = [r for r in tj._ring if r["event"] == "prof_capture_started"]
    assert len(started) == 4
    assert tm._profiler.dedicated == [False] * 4


def test_deep_trigger_dedupe_matches_jax(tmp_path):
    pair = managers(tmp_path, every_steps=0, deep_window_s=0.02)
    for mgr, _ in pair:
        assert mgr.trigger("c-incident", "heal")["cid"] == "c-incident"
        assert mgr.trigger("c-incident", "replan") is None
    deadline = time.monotonic() + 5.0
    while (not all(m.ls() for m, _ in pair)
           and time.monotonic() < deadline):
        time.sleep(0.005)
    _same(pair)
    (_, _), (tm, _) = pair
    assert tm._profiler.dedicated == [True]  # its own profiler thread
    snap = obs.get_registry("jimm_prof").snapshot()
    assert snap["trigger_suppressed_total"] >= 1


def test_byte_budget_eviction_matches_jax(tmp_path):
    pair = managers(tmp_path, every_steps=0, payload_bytes=1000,
                    max_ring_bytes=2500)
    for mgr, _ in pair:
        for i in range(4):
            assert mgr.start("window", step=i) is not None
            mgr.commit()
    _same(pair)
    (_, _), (tm, _) = pair
    seqs = [m["seq"] for m in tm.ls()]
    assert 1 not in seqs and seqs[-1] == 4 and tm.ring_bytes() <= 2500


def test_leftover_tmp_quarantined_like_jax(tmp_path):
    for name in ("jax", "port"):
        stale = tmp_path / name / "cap-000007-window.tmp"
        stale.mkdir(parents=True)
        (stale / "partial.bin").write_bytes(b"wreck")
    pair = managers(tmp_path)
    _same(pair)
    (_, _), (tm, _) = pair
    assert tm.ls() == []
    moved = list((tm.root / "quarantine").glob("*/partial.bin"))
    assert len(moved) == 1 and moved[0].read_bytes() == b"wreck"


def test_maybe_trigger_is_a_noop_unconfigured(tmp_path, monkeypatch):
    monkeypatch.delenv("JIMM_PROF_DIR", raising=False)
    tcap.reset_capture()
    try:
        assert tcap.maybe_trigger("c-x", "heal") is None
        tcap.configure_capture(tmp_path / "g", profiler=FakeProfiler(),
                               min_trigger_interval_s=0.0,
                               deep_window_s=0.01)
        assert tcap.maybe_trigger("c-x", "heal")["cid"] == "c-x"
    finally:
        tcap.reset_capture()


def _leak_run(mem_mod, journal):
    rows = {"bytes": 0.0}

    def sampler():
        return [{"device": 0, "source": "fake",
                 "bytes_in_use": rows["bytes"],
                 "peak_bytes_in_use": rows["bytes"],
                 "bytes_limit": 1 << 30, "fragmentation": 0.0}]

    mon = mem_mod.MemoryMonitor(leak_window=3, leak_min_growth_frac=0.01,
                                leak_min_growth_bytes=1000, journal=journal,
                                sampler=sampler)
    mon.register_subsystem("model_pool", lambda: 42.0)
    reports = []
    for b in (1000, 2000, 3000, 4000, 5000, 1000, 2000, 3000, 4000, 5000,
              5000, 6000):
        rows["bytes"] = float(b)
        reports.append(mon.sample()["leak_suspected"])
    return reports


def test_leak_watchdog_matches_jax():
    tj, jj = EventJournal(), JaxJournal()
    assert _leak_run(tmem, tj) == _leak_run(jmem, jj)
    drop = ("seq", "ts", "mono", "cid")
    leaks = [r for r in tj._ring if r["event"] == "hbm_leak_suspected"]
    assert len(leaks) == 2 and leaks[0]["cid"] != leaks[1]["cid"]
    assert [{k: v for k, v in r.items() if k not in drop}
            for r in tj._ring] == [
        {k: v for k, v in r.items() if k not in drop} for r in jj._ring]
    snap = obs.get_registry("jimm_hbm").snapshot()
    assert snap["device0_bytes_in_use"] == 6000.0
    assert snap["subsystem_model_pool_bytes"] == 42.0


def test_cpu_rows_and_model_pool_bytes():
    rows = tmem.device_memory_rows()
    assert [r["source"] for r in rows] == ["live_tensors"]
    assert rows[0]["platform"] == "cpu"
    model = SigLIP(tiny_config(configs), device="cpu")
    want = sum(t.numel() * t.element_size()
               for t in [*model.parameters(), *model.buffers()])
    assert tmem.module_bytes(model) == want
    assert tmem.device_memory_rows()[0]["bytes_in_use"] >= want
    mon = tmem.MemoryMonitor(sampler=lambda: [], journal=EventJournal())
    mon.register_subsystem("broken", lambda: 1 / 0)
    assert mon.sample()["subsystems"]["broken"] == 0.0


ROWS = [
    {"name": "fusion.1", "category": "kernel", "total_us": 100.0,
     "count": 10, "bytes_accessed": 1000, "long_name": "f1"},
    {"name": "copy.2", "category": "gpu_memcpy", "total_us": 50.0,
     "count": 5, "bytes_accessed": 500, "long_name": "c2"},
    {"name": "gone.3", "category": "kernel", "total_us": 20.0,
     "count": 2, "bytes_accessed": 0, "long_name": "g3"},
]
AFTER = [dict(ROWS[0], total_us=300.0), dict(ROWS[1], total_us=30.0),
         {"name": "new.4", "category": "kernel", "total_us": 5.0,
          "count": 1, "bytes_accessed": 0, "long_name": "n4"}]


@pytest.mark.parametrize("threshold", [0.1, 5.0])
def test_diff_and_tables_match_jax(threshold):
    d = tops.diff_ops(ROWS, AFTER, threshold=threshold)
    assert d == jops.diff_ops(ROWS, AFTER, threshold=threshold)
    assert tops.render_diff(d) == jops.render_diff(d)
    assert d["verdict"] == ("regression" if threshold < 1 else "ok")
    assert tops.top_ops(ROWS, 2) == jops.top_ops(ROWS, 2)
    assert tops.render_table(ROWS, top=2) == jops.render_table(ROWS, top=2)
    stats = [tprofile.OpStat(**r) for r in ROWS]
    jstats = [jprofile.OpStat(**r) for r in ROWS]
    assert tprofile.summarize(stats, top=3, steps=2) == jprofile.summarize(
        jstats, top=3, steps=2)


def test_unknown_bytes_print_as_unknown():
    row = dict(ROWS[0], bytes_accessed=None)
    table = tops.render_table([row])
    assert "?" in table.splitlines()[2] and "GB/s" in table
    assert tprofile.OpStat(**row).gbps is None
    assert "?MB" in tprofile.summarize([tprofile.OpStat(**row)])


def _kineto_trace() -> dict:
    """A small kineto-style trace: a host thread with nested operators
    and runtime calls, a kernel and a memcpy on card 0 (two instantiations
    of one template), and a kernel on card 1."""
    host = dict(pid=100, tid=7)

    def x(cat, name, ts, dur, **kw):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                **kw}

    return {"traceEvents": [
        {"ph": "M", "name": "thread_name", "pid": 100, "tid": 7,
         "args": {"name": "thread 7 (python)"}},
        x("cpu_op", "aten::linear", 0, 100, **host),
        x("cpu_op", "aten::addmm", 10, 60, **host),
        x("cuda_runtime", "cudaLaunchKernel", 20, 10, **host),
        x("cpu_op", "aten::linear", 200, 50, **host),
        x("cpu_op", "aten::addmm", 210, 30, **host),
        x("user_annotation", "step", 0, 300, **host),
        x("user_annotation", "first", 0, 100, **host),
        x("cuda_runtime", "cudaMemcpyAsync", 260, 20, **host),
        x("kernel", "void flash_fwd_mma_kernel<64, false>(...)", 30, 40,
          pid=0, tid=7, args={"device": 0, "grid": [1, 2, 3],
                              "block": [128, 1, 1]}),
        x("kernel", "void flash_fwd_mma_kernel<64, true>(...)", 80, 10,
          pid=0, tid=7, args={"device": 0}),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 270, 20,
          pid=0, tid=8, args={"device": 0, "bytes": 4096}),
        x("kernel", "void flash_fwd_mma_kernel<64, false>(...)", 30, 40,
          pid=1, tid=7, args={"device": 1}),
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": -50, "dur": 500},
    ]}


def test_aggregate_ops_reads_a_kineto_trace(tmp_path):
    trace = _kineto_trace()
    events = trace["traceEvents"]
    rows = {r["name"]: r for r in tops.aggregate_ops(events)}
    # one card: the two instantiations apart, the memcpy's bytes known, a
    # kernel's unknown
    assert set(rows) == {"void flash_fwd_mma_kernel<64, false>(...)",
                         "void flash_fwd_mma_kernel<64, true>(...)",
                         "Memcpy HtoD (Pageable -> Device)"}
    k = rows["void flash_fwd_mma_kernel<64, false>(...)"]
    assert (k["count"], k["total_us"], k["bytes_accessed"]) == (1, 40.0, None)
    assert k["long_name"] == "grid=[1, 2, 3] block=[128, 1, 1]"
    assert rows["Memcpy HtoD (Pageable -> Device)"]["bytes_accessed"] == 4096
    every = tops.aggregate_ops(events, device=None)
    assert sum(r["count"] for r in every) == 4
    assert tops.aggregate_ops(events, device=1)[0]["count"] == 1
    # without device events: operators by self time, nested ones not
    # counted twice
    host = [e for e in events if e.get("cat") != "kernel"
            and e.get("cat") != "gpu_memcpy"]
    ops = {r["name"]: r for r in tops.aggregate_ops(host)}
    assert ops["aten::linear"]["total_us"] == (100 - 60) + (50 - 30)
    assert ops["aten::addmm"]["total_us"] == 60 + 30
    assert sum(r["total_us"] for r in ops.values()) == 150
    s = tops.capture_summary(events)
    assert (s["device_events"], s["kernels"]) == (3, 2)
    assert s["cpu_op_threads"] == ["thread 7 (python)"]
    assert s["wall_us"] == 300 and s["device_busy_us"] == 40 + 10 + 20
    assert (s["runtime_us"], s["cpu_op_us"]) == (30, 150 - 10)
    assert s["gap_us"] == 300 - 150 - 20
    first = tops.capture_summary(events, region="first")
    assert (first["regions"], first["wall_us"]) == (1, 100)
    assert (first["device_busy_us"], first["runtime_us"],
            first["cpu_op_us"], first["gap_us"]) == (50, 10, 90, 0)
    line = tops.render_summary(s)
    assert "2 kernel launches" in line and "thread 7" in line
    assert tops.render_summary(tops.capture_summary(host)).startswith(
        "NO DEVICE EVENTS")
    path = tmp_path / "h_1.1.pt.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)
    assert tops.find_trace_file(tmp_path) == path
    assert tops.op_table(tmp_path) == tops.aggregate_ops(events)


def test_torch_backend_on_the_cpu(tmp_path):
    """A session a thread, one at a time: the backend refuses a stop from
    another thread (torch's session would not be found there) and the
    lock refuses a second session; a dedicated session stops from any
    thread; every export parses."""
    backend = tcap.TorchProfiler()
    backend.start(str(tmp_path / "inline"))
    torch.ones(8) + 1
    errors = []

    def stop_elsewhere():
        try:
            backend.stop()
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=stop_elsewhere)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and "per thread" in errors[0]
    info = backend.stop()
    assert info["profiler_thread"] == "caller"
    assert info["device_events"] == 0 and info["cpu_op_threads"]
    backend.start(str(tmp_path / "dedicated"), dedicated=True)
    torch.ones(8) + 1  # this thread's operators are not recorded
    t = threading.Thread(target=lambda: errors.append(backend.stop()))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and errors[-1]["profiler_thread"] == "dedicated"
    assert errors[-1]["cpu_op_threads"] == []
    with tcap.profiler_session(tmp_path / "session") as prof:
        torch.ones(8) + 1
        mgr = tcap.CaptureManager(tmp_path / "ring", every_steps=0,
                                  journal=EventJournal())
        assert mgr.start("window") is None  # the session lock is held
    assert any(e.key == "aten::add" for e in prof.key_averages())
    assert tops.op_table(tmp_path / "session")
    with tprofile.trace(tmp_path / "trace"):
        with tprofile.annotate("region"):
            torch.ones(8) * 2
    names = {s.name for s in tprofile.op_stats(tmp_path / "trace")}
    assert "aten::mul" in names
