"""The port's observability commands on the CPU: ``train --profile-dir``
(the JAX CLI's profiled steps, a readable capture, ``profile-analyze``),
``--prof-ring``, ``--tensorboard-dir`` (events equal to the JAX package's
``MetricsLogger``'s, read with the ``tensorboard`` package), ``serve
--prof-dir`` with ``POST /admin/prof/trigger``, and the ``obs`` verbs."""

import contextlib
import io
import json
import sys
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from jimm_tpu_torch import cli, obs
from jimm_tpu_torch.obs import cli as obs_cli
from jimm_tpu_torch.obs.journal import EventJournal
from jimm_tpu_torch.obs.prof import capture, list_captures, op_table
from jimm_tpu_torch.obs.prof.memory import module_bytes
from jimm_tpu_torch.train.metrics import MetricsLogger, read_event_file

TINY = ["train", "--tiny", "--device", "cpu", "--batch-size", "2",
        "--log-every", "1"]


def run(argv: list[str]) -> tuple[int, list[str]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue().splitlines()


@pytest.fixture(autouse=True)
def no_global_manager():
    capture.reset_capture()
    yield
    capture.reset_capture()


@pytest.fixture
def one_thread():
    """Tiny models on one intra-op thread: beside other test workers, the
    default thread pool's contention costs these commands several times
    their run time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tensorboard_loader():
    """tensorboard's raw event reader, on its own record reader: the
    package's documented ``tensorboard.compat.notf`` switch keeps it from
    importing TensorFlow."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_file_loader import (
        LegacyEventFileLoader)
    return LegacyEventFileLoader


def tb_scalars(logdir) -> tuple[list, list]:
    """(file versions, [(step, tag, value)]) of the one event file in
    ``logdir``, through tensorboard's reader."""
    files = sorted(logdir.glob("events.out.tfevents.*"))
    assert len(files) == 1
    versions, scalars = [], []
    for ev in tensorboard_loader()(str(files[0])).Load():
        if ev.file_version:
            versions.append(ev.file_version)
        scalars += [(ev.step, v.tag, v.simple_value)
                    for v in ev.summary.value]
    return versions, scalars


@pytest.mark.parametrize("steps,profiled", [(6, [2, 4]), (2, [1, 1])])
def test_profile_dir_profiles_the_reference_steps(tmp_path, steps,
                                                  profiled, one_thread):
    """The JAX CLI profiles steps ``start+2 .. start+4``, clamped:
    ``min(start + 2, max(steps - 1, start))`` to ``min(start + 4, steps -
    1)`` (``jimm_tpu/cli.py:731-732``)."""
    d, tb = tmp_path / "prof", tmp_path / "tb"
    metrics = tmp_path / "m.jsonl"
    rc, lines = run(TINY + ["--steps", str(steps), "--profile-dir", str(d),
                            "--tensorboard-dir", str(tb),
                            "--metrics-file", str(metrics)])
    summary = json.loads(lines[-1])
    assert rc == 0 and summary["profiled_steps"] == profiled
    # the profiler's start and stop sit outside the step bucket
    assert summary["goodput"]["other_s"] > 0
    rows = op_table(d)
    assert rows and {r["category"] for r in rows} == {"cpu_op"}
    rc, out = run(["profile-analyze", str(d), "--steps",
                   str(profiled[1] - profiled[0] + 1), "--top", "5"])
    assert rc == 0 and out[0].startswith("NO DEVICE EVENTS")
    assert any("aten::" in line for line in out)
    versions, scalars = tb_scalars(tb)
    logged = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert versions == ["brain.Event:2"]
    assert [(s, v) for s, tag, v in scalars if tag == "loss"] == [
        (r["step"], float(np.float32(r["loss"]))) for r in logged]
    mine = read_event_file(next(tb.glob("events.out.tfevents.*")))
    assert [(e["step"], tag, v) for e in mine for tag, v in
            e["scalars"].items()] == scalars


def test_tensorboard_events_match_jax(tmp_path):
    """The port's events equal the JAX package's ``MetricsLogger``'s
    (step, tag, value) for the same metrics; non-numeric values stay in
    the JSONL only."""
    tensorboard_loader()
    from jimm_tpu.train.metrics import MetricsLogger as JaxMetricsLogger
    metrics = [(0, {"loss": 2.5, "lr": 1e-3, "mfu": None, "tag": "x"}),
               (1, {"loss": np.float32(1.25), "step_time_s": 0.5}),
               (7, {"accuracy": 0.75, "images_per_s": 1e4})]
    for cls, name in ((MetricsLogger, "port"), (JaxMetricsLogger, "jax")):
        logger = cls(tensorboard_dir=tmp_path / name, print_every=0)
        for step, m in metrics:
            logger.log(step, **m)
        logger.close()
    assert tb_scalars(tmp_path / "port") == tb_scalars(tmp_path / "jax")
    assert len(tb_scalars(tmp_path / "port")[1]) == 6


def test_prof_ring_commits_evicts_and_obs_reads_it(tmp_path, one_thread):
    ring = tmp_path / "ring"
    reg = obs.get_registry("jimm_prof")
    before = reg.snapshot()
    rc, lines = run(TINY + ["--steps", "8", "--prof-ring", str(ring),
                            "--prof-every", "2", "--prof-window", "1",
                            "--prof-ring-bytes", "1"])
    after = reg.snapshot()
    assert rc == 0
    assert after["captures_total"] - before.get("captures_total", 0) == 3
    assert after["evicted_total"] - before.get("evicted_total", 0) == 2
    metas = list_captures(ring)
    assert [m["step"] for m in metas] == [6]  # the newest always stays
    assert metas[0]["device_events"] == 0
    assert metas[0]["profiler_thread"] == "caller"
    assert not [p for p in ring.iterdir() if p.name.endswith(".tmp")]
    rc, out = run(["obs", "prof", "ls", str(ring)])
    assert rc == 0 and "cap-000003-window" in out[1]
    rc, out = run(["obs", "prof", "show", metas[0]["path"], "--top", "3"])
    assert rc == 0 and out[0].startswith("NO DEVICE EVENTS")
    rc, out = run(["obs", "prof", "diff", metas[0]["path"],
                   metas[0]["path"]])
    assert rc == 0 and "[ok]" in out[0]


def test_obs_snapshot_diff_tail_timeline_and_regress(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.prom"
    a.write_text(json.dumps({"x_total": 1, "y": 2.0}))
    b.write_text(obs.render_prometheus_text({"x_total": 3, "y": 2.0}))
    rc, out = run(["obs", "snapshot", str(a), "-o", str(tmp_path / "c")])
    assert rc == 0 and "x_total" in out[-2]
    assert json.loads((tmp_path / "c").read_text()) == {"x_total": 1,
                                                         "y": 2.0}
    rc, out = run(["obs", "diff", str(a), str(b)])
    assert rc == 1 and out == ["~ x_total: 1 -> 3.0 (+2)"]
    assert run(["obs", "diff", str(a), str(a)]) == (0, ["(no differences)"])
    # tail --follow survives the journal's rotation
    path = tmp_path / "journal.jsonl"
    journal = EventJournal(path, max_bytes=300, max_segments=3)
    journal.emit("before_rotation", phase="a")
    state = {"polls": 0}

    def fake_sleep(_):
        state["polls"] += 1
        if state["polls"] == 1:
            for i in range(8):
                journal.emit("filler", i=i, pad="x" * 64)
            journal.emit("after_rotation", phase="b")

    text = io.StringIO()
    assert obs_cli._tail_jsonl(str(path), follow=True, sleep=fake_sleep,
                               should_stop=lambda: state["polls"] >= 5,
                               out=text) == 0
    assert "before_rotation" in text.getvalue()
    assert "after_rotation" in text.getvalue()
    assert (tmp_path / "journal.1.jsonl").exists()
    journal.close()
    goodput = tmp_path / "g.json"
    goodput.write_text(json.dumps({"step_s": 1.0, "wall_s": 2.0,
                                   "step_frac": 0.5}))
    rc, out = run(["obs", "timeline", str(path), "--goodput", str(goodput),
                   "-o", str(tmp_path / "t.json")])
    trace = json.loads((tmp_path / "t.json").read_text())
    assert rc == 0 and obs.validate_chrome_trace(trace) == []
    assert {"step", "wall"} <= {e["name"] for e in trace["traceEvents"]
                                if e.get("tid") == "goodput"}
    with pytest.raises(SystemExit, match="torch twin of bench.py"):
        cli.main(["obs", "regress", "--adopt"])
    # every train flag of the JAX CLI is ported: --max-devices checks the
    # ranks there are as JAX checks its devices
    with pytest.raises(SystemExit, match=r"--max-devices 2 out of range "
                       r"\(1\.\.1 visible\)"):
        cli.main(TINY + ["--max-devices", "2", "--mesh", "data=2"])
    assert not hasattr(cli, "_TRAIN_NOT_PORTED")


def _trigger(port: int, payload: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/admin/prof/trigger",
        data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_serve_prof_dir_and_the_trigger(tmp_path, monkeypatch, one_thread):
    monkeypatch.delenv("JIMM_PROF_DIR", raising=False)
    serve = ["serve", "--tiny", "--device", "cpu", "--port", "0",
             "--buckets", "1"]
    server, _, _ = cli.build_server(cli.build_parser().parse_args(serve))
    try:
        status, body = _trigger(server.port, {"cid": "c-1"})
        assert status == 400 and "no capture manager" in body["message"]
    finally:
        server.stop()
    prof = tmp_path / "prof"
    server, model, _ = cli.build_server(cli.build_parser().parse_args(
        serve + ["--prof-dir", str(prof)]))
    try:
        assert _trigger(server.port, {"cid": 7})[0] == 400
        status, body = _trigger(server.port, {"cid": "c-2", "window_s": 30})
        assert status == 200 and body["triggered"] is True
        assert body["capture"]["cid"] == "c-2"
        status, body = _trigger(server.port, {"cid": "c-2"})
        assert body == {"triggered": False, "suppressed": True}
        report = server.monitor.sample()
        assert report["subsystems"]["model_pool"] == module_bytes(model)
        assert report["devices"][0]["source"] == "live_tensors"
    finally:
        server.stop()  # commits the open deep capture
    metas = list_captures(prof)
    assert [(m["cid"], m["kind"], m["profiler_thread"]) for m in metas] == [
        ("c-2", "deep", "dedicated")]
