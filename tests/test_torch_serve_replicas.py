"""Serving replicas of the port on the CPU, held to the JAX package: the
topology planner against JAX's over its virtual CPU devices, the engine's
replica dispatch (JAX's ``TestMultiReplicaEngine`` case for case), a tiny
SigLIP served by ``serve --device cpu,cpu --replicas 2 --self-heal`` with
JAX's weights against JAX's ``build_replica_forwards``, the Prometheus
series names, ``/debug/traces`` through ``obs tail``/``obs timeline``, and
the CLI's refusals and ready line."""

import asyncio
import json
import re
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import cli as jax_cli
from jimm_tpu import preset as jax_preset
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.serve import InferenceEngine as JaxEngine
from jimm_tpu.serve import ServeMetrics as JaxServeMetrics
from jimm_tpu.serve import build_replica_forwards as jax_build_forwards
from jimm_tpu.serve import plan_topology as jax_plan
from jimm_tpu.serve.topology import _feasible_splits as jax_feasible
from jimm_tpu_torch import _build, cli
from jimm_tpu_torch.models.siglip import load_jax_params
from jimm_tpu_torch.obs import cli as obs_cli
from jimm_tpu_torch.obs.prof.capture import reset_capture
from jimm_tpu_torch.obs.prof.memory import module_bytes
from jimm_tpu_torch.ops import layer_norm as ln
from jimm_tpu_torch.serve import (BucketTable, InferenceEngine,
                                  ReplicaForward, ServeClient, ServeMetrics,
                                  build_replica_forwards, plan_topology)
from jimm_tpu_torch.serve import topology
from test_torch_siglip import jax_params

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def _jax_devices(n):
    devs = jax.devices()
    assert len(devs) >= n, "tests/conftest.py forces 8 CPU devices"
    return devs[:n]


# -- the planner ---------------------------------------------------------------

SPLITS = [(1, 1, 1, 1), (2, 1, 1, 1), (2, 2, 1, 1), (2, 1, 2, 1),
          (4, 2, 2, 1), (4, 4, 1, 1), (4, 1, 4, 1), (4, 2, 1, 1),
          (8, 2, 4, 1), (8, 4, 2, 1), (8, 8, 1, 1), (8, 1, 8, 1),
          (8, 3, 2, 1), (8, 2, 2, 2), (4, 1, 2, 2), (8, 1, 1, 8)]


@pytest.mark.parametrize("n,replicas,model_parallel,seq_parallel", SPLITS)
def test_plan_matches_jax(n, replicas, model_parallel, seq_parallel):
    devs = _jax_devices(n)
    want = jax_plan(replicas, model_parallel, seq_parallel, devices=devs)
    got = plan_topology(replicas, model_parallel, seq_parallel,
                        devices=[CPU] * n)
    assert got.describe() == want.describe()
    assert got.is_trivial == want.is_trivial
    assert [len(g) for g in got.device_groups] == \
        [len(g) for g in want.device_groups]
    assert all(d == CPU for g in got.device_groups for d in g)
    # the same positions of the device list, group by group
    by_position = plan_topology(replicas, model_parallel, seq_parallel,
                                devices=list(range(n)))
    assert [list(g) for g in by_position.device_groups] == \
        [[devs.index(d) for d in g] for g in want.device_groups]
    assert got.revise(replicas=1).describe() == \
        want.revise(replicas=1).describe()


def _message(fn, *args, **kwargs) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kwargs)
    return str(e.value)


@pytest.mark.parametrize("n,replicas,model_parallel,seq_parallel", [
    (1, 2, 1, 1), (1, 1, 2, 1), (2, 2, 2, 1), (4, 8, 1, 1), (8, 3, 3, 1),
    (4, 1, 2, 3), (6, 7, 1, 1)])
def test_refusals_match_jax(n, replicas, model_parallel, seq_parallel):
    want = _message(jax_plan, replicas, model_parallel, seq_parallel,
                    devices=_jax_devices(n))
    got = _message(plan_topology, replicas, model_parallel, seq_parallel,
                   devices=[CPU] * n)
    need = replicas * model_parallel * seq_parallel
    # the same text up to the fix: the reference forces XLA's virtual CPU
    # device count, the port lists a device more than once
    assert got.split(" (e.g. ")[0] == want.split(" (e.g. ")[0]
    assert got.endswith(f"(e.g. list one device {need} times: --device "
                        + ",".join(["cpu"] * need) + ")")


@pytest.mark.parametrize("split", [(0, 1, 1), (1, 0, 1), (-1, 1, 1),
                                   (1, -2, 1), (1, 1, 0)])
def test_nonpositive_splits_match_jax(split):
    assert _message(plan_topology, *split, devices=[CPU]) == \
        _message(jax_plan, *split, devices=_jax_devices(1))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24, 64])
def test_feasible_splits_match_jax(n):
    assert topology._feasible_splits(n) == jax_feasible(n)


def test_default_devices_are_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    plan = plan_topology(2)
    assert plan.device_groups == ((torch.device("cuda", 0),),
                                  (torch.device("cuda", 1),))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 are visible"):
        plan_topology(2)


def test_wider_replicas_name_part_2():
    """Replicas wider than one device (ROADMAP.md item 8(a) part 2) build:
    one sharded forward per group, a model copy per position."""
    cfg = cli.tiny_override(cli.preset("siglip-base-patch16-256"))
    model, _ = cli.serving_model(cfg, "f32", CPU)
    for split in ((1, 2, 1), (1, 1, 2)):
        plan = plan_topology(*split, devices=[CPU] * 2)
        forwards = build_replica_forwards(model, plan, method="forward")
        assert len(forwards) == 1
        assert isinstance(forwards[0], topology.ShardedReplicaForward)
        assert len(forwards[0].models) == 2
        assert all(m is not model for m in forwards[0].models)


# -- the engine (JAX's TestMultiReplicaEngine, case for case) ------------------

def _fake_replicas(n, delay_s=0.0):
    calls = [[] for _ in range(n)]
    lock = threading.Lock()

    def make(i):
        def fwd(padded):
            if delay_s:
                time.sleep(delay_s)
            with lock:
                calls[i].append(np.shape(padded)[0])
            return np.asarray(padded)
        return fwd

    return [make(i) for i in range(n)], calls


def _run_load(engine, item, clients, per_client):
    async def client():
        for _ in range(per_client):
            await engine.submit(item)

    async def go():
        await engine.start()
        try:
            await asyncio.gather(*[client() for _ in range(clients)])
        finally:
            await engine.stop()

    asyncio.run(go())


class TestMultiReplicaEngine:
    def test_dispatch_spreads_across_replicas(self):
        forwards, calls = _fake_replicas(2, delay_s=0.002)
        engine = InferenceEngine(forwards, item_shape=(4,),
                                 buckets=BucketTable((1, 4)),
                                 max_delay_ms=1.0)
        engine.warmup_blocking()
        warm = [len(c) for c in calls]
        item = np.zeros((4,), np.float32)
        _run_load(engine, item, clients=16, per_client=4)
        per_replica = [len(c) - w for c, w in zip(calls, warm)]
        total = sum(per_replica)
        assert total >= 16
        assert min(per_replica) / total >= 0.3, per_replica
        stats = engine.replica_stats()
        assert [s["dispatched"] for s in stats] == per_replica
        assert all(s["inflight"] == 0 for s in stats)

    def test_replica_metrics_rendered(self):
        forwards, _calls = _fake_replicas(2)
        engine = InferenceEngine(forwards, item_shape=(4,),
                                 buckets=BucketTable((1, 4)),
                                 max_delay_ms=1.0)
        engine.warmup_blocking()
        _run_load(engine, np.zeros((4,), np.float32), clients=8,
                  per_client=2)
        text = engine.metrics.render_prometheus()
        names = set(re.findall(r"^(jimm_serve_replica_\S+) ", text,
                               re.MULTILINE))
        for i in (0, 1):
            assert f"jimm_serve_replica_{i}_dispatched_total" in names
            assert f"jimm_serve_replica_{i}_inflight" in names
        assert "jimm_serve_n_replicas" in engine.metrics.render_prometheus()

    def test_warmup_report_carries_per_replica_entries(self):
        forwards, calls = _fake_replicas(3)
        engine = InferenceEngine(forwards, item_shape=(4,),
                                 buckets=BucketTable((1, 2)),
                                 max_delay_ms=1.0)
        engine.warmup_blocking()
        for size, rep in engine.warmup_report.items():
            assert len(rep["replicas"]) == 3
            assert all("seconds" in p and "source" in p
                       for p in rep["replicas"])
        assert [sorted(c) for c in calls] == [[1, 2]] * 3

    def test_empty_forward_list_rejected(self):
        with pytest.raises(ValueError):
            InferenceEngine([], item_shape=(4,))

    def test_bare_callable_is_single_replica(self):
        engine = InferenceEngine(lambda padded: np.asarray(padded),
                                 item_shape=(4,),
                                 buckets=BucketTable((1,)),
                                 max_delay_ms=1.0)
        engine.warmup_blocking()
        assert not engine._multi
        assert "replicas" not in next(iter(engine.warmup_report.values()))
        assert "replica_0_dispatched_total" not in \
            engine.metrics.render_prometheus()


def test_launch_counts_lose_no_update_across_threads():
    """Replicas launch from several executor threads at once: 32 threads
    (more than the cores) bumping one counter with a short switch interval
    lose no update."""
    before = ln.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(32) as pool:
            futures = [pool.submit(lambda: [
                _build.count_launch(ln.__name__, "launches")
                for _ in range(500)]) for _ in range(32)]
            for f in futures:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        got, ln.launches = ln.launches - before, before
    assert got == 32 * 500


def _series(text: str) -> dict[str, str]:
    return dict(re.findall(r"^(\S+) (\S+)$", text, re.MULTILINE))


def test_serve_metrics_render_jax_series():
    """One event sequence through both packages' ServeMetrics: the same
    series, with the same values but the clock's."""
    got, want = ServeMetrics(), JaxServeMetrics()
    for m in (got, want):
        m.inc("requests_total", 5)
        m.inc("responses_total", 4)
        m.inc("errors_total")
        m.inc("replica_0_dispatched_total", 0)
        m.inc("replica_1_dispatched_total", 2)
        m.set_queue_depth(3)
        m.observe_batch(3, 4)
        m.observe_batch(1, 1, shed=True)
        for i, seconds in enumerate((0.002, 0.004, 0.001, 0.03)):
            m.observe_latency(seconds)
            for phase in m.PHASES:
                m.observe_phase(phase, seconds / (i + 2))
        m.bind_gauge("n_replicas", lambda: 2.0)
        m.bind_gauge("replica_0_inflight", lambda: 1.0)
    got_s, want_s = (_series(m.render_prometheus()) for m in (got, want))
    assert sorted(got_s) == sorted(want_s)
    for name in got_s:
        if name != "jimm_serve_uptime_s":
            assert got_s[name] == want_s[name], name
    assert got.phase_percentile("device", 99) == \
        want.phase_percentile("device", 99)
    assert got.snapshot().keys() == want.snapshot().keys()


def test_replica_engines_render_jax_series():
    """Both engines over two fake replicas, the same traffic: the same
    series names."""
    def ok(x):
        return np.asarray(x) * 2

    got = InferenceEngine([ok, ok], item_shape=(3,),
                          buckets=BucketTable((1, 2)), max_delay_ms=1.0)
    want = JaxEngine([ok, ok], item_shape=(3,), buckets=_jax_buckets(),
                     max_delay_ms=1.0)
    for engine in (got, want):
        engine.warmup_blocking()
        _run_load(engine, np.ones(3, np.float32), clients=4, per_client=2)
    assert sorted(_series(got.metrics.render_prometheus())) == \
        sorted(_series(want.metrics.render_prometheus()))


def _jax_buckets():
    from jimm_tpu.serve import BucketTable as JaxBuckets
    return JaxBuckets((1, 2))


# -- a tiny SigLIP served by two replicas, against JAX's replicas --------------

SERVE_ARGV = ["serve", "--tiny", "--device", "cpu,cpu", "--replicas", "2",
              "--self-heal", "--port", "0", "--buckets", "1,2,4",
              "--max-delay-ms", "20", "--timeout-s", "60"]


@pytest.fixture(scope="module")
def served():
    jmodel = JaxSigLIP(jax_cli._tiny_override(
        jax_preset("siglip-base-patch16-256")), rngs=nnx.Rngs(0))
    params = jax_params(jmodel)
    jplan = jax_plan(2, 1, devices=_jax_devices(2))
    jforwards, traces = jax_build_forwards(jmodel, jplan,
                                           method="encode_image",
                                           item_shape=(32, 32, 3))
    images = np.random.default_rng(0).standard_normal(
        (12, 32, 32, 3)).astype(np.float32)
    want = [np.asarray(f(images)) for f in jforwards]
    original = cli.serving_model

    def carried(cfg, dtype, device, generator=None):
        model, quantized = original(cfg, dtype, device, generator)
        load_jax_params(model, params)
        return model, quantized

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "serving_model", carried)
        server, model, ready = cli.build_server(
            cli.build_parser().parse_args(SERVE_ARGV))
    try:
        yield dict(server=server, model=model, ready=ready, images=images,
                   want=want, jplan=jplan, traces=traces)
    finally:
        server.stop()


def test_replicas_match_jax_replicas(served):
    server, images = served["server"], served["images"]
    np.testing.assert_allclose(served["want"][0], served["want"][1], **TOL)
    assert served["traces"]() == 2
    forwards = server.engine.forwards
    assert [type(f) for f in forwards] == [ReplicaForward] * 2
    assert forwards[0].model is served["model"]
    assert forwards[1].model is not served["model"]
    for a, b in zip(forwards[0].model.state_dict().values(),
                    forwards[1].model.state_dict().values()):
        assert torch.equal(a, b)
    client = ServeClient(port=server.port, timeout_s=60)
    with ThreadPoolExecutor(6) as pool:
        got = list(pool.map(client.embed, images))
    for i, row in enumerate(got):
        np.testing.assert_allclose(row, served["want"][0][i], **TOL)
        assert isinstance(row.trace_id, str) and row.cascade is None
    bulk = client.embed_many(images[:5])
    np.testing.assert_allclose(bulk, served["want"][1][:5], **TOL)
    stats = server.engine.replica_stats()
    assert all(s["dispatched"] >= 1 for s in stats), stats


def test_ready_line_topology_is_jax_describe(served):
    ready = served["ready"]
    assert ready["topology"] == served["jplan"].describe()
    assert ready["status"] == "serving" and ready["device"] == "cpu"


def test_health_metrics_and_traces_name_both_replicas(served):
    server = served["server"]
    client = ServeClient(port=server.port, timeout_s=60)
    for img in served["images"][:4]:
        client.embed(img)
    health = client.healthz()
    assert health["status"] == "ok" and health["replans"] == 0
    assert [r["replica"] for r in health["replicas"]] == [0, 1]
    assert set(health["warmup"]) == {"1", "2", "4"}
    assert len(health["warmup"]["4"]["replicas"]) == 2
    text = client.metrics_text()
    for name in ("jimm_serve_replica_0_dispatched_total",
                 "jimm_serve_replica_1_dispatched_total",
                 "jimm_serve_n_replicas", "jimm_serve_replicas_alive",
                 "jimm_serve_span_device_p99_ms",
                 "jimm_serve_span_queue_p50_ms",
                 "jimm_serve_heal_failures_total",
                 "jimm_serve_traces_dropped_total"):
        assert re.search(rf"^{name} ", text, re.MULTILINE), name
    assert re.search(r"^jimm_spans_serve_device_r1_seconds_count ", text,
                     re.MULTILINE)
    traces = client._request("GET", "/debug/traces")
    assert traces["count"] == len(traces["traces"]) > 0
    assert {row["replica"] for row in traces["traces"]} == {0, 1}
    for row in traces["traces"]:
        assert {"trace_id", "bucket", "queue_s", "pad_s", "device_s",
                "readback_s", "total_s", "done_mono"} <= set(row)


def test_obs_reads_debug_traces(served, tmp_path, monkeypatch, capsys):
    server = served["server"]
    client = ServeClient(port=server.port, timeout_s=60)
    tid = client.embed(served["images"][0]).trace_id
    url = f"http://127.0.0.1:{server.port}"

    def stop(_seconds):
        raise KeyboardInterrupt

    # the module's own name for time: other threads keep time.sleep
    monkeypatch.setattr(obs_cli, "time", types.SimpleNamespace(sleep=stop))
    assert cli.main(["obs", "tail", "--traces", url]) == 0
    lines = capsys.readouterr().out.splitlines()
    mine = [ln for ln in lines if ln.startswith(tid + " ")]
    assert len(mine) == 1 and re.search(r"replica=[01] bucket=\d", mine[0])
    assert "device=" in mine[0] and "total=" in mine[0]
    journal = tmp_path / "journal.jsonl"
    journal.write_text(json.dumps({"seq": 0, "event": "replica_fault",
                                   "mono": time.monotonic(), "cid": "c"})
                       + "\n")
    out = tmp_path / "timeline.json"
    assert cli.main(["obs", "timeline", str(journal), "-o", str(out),
                     "--traces", url]) == 0
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]}
    assert {"replica_fault", "queue", "device", "readback"} <= names


def test_prof_dir_counts_every_replica_copy(tmp_path, monkeypatch):
    monkeypatch.delenv("JIMM_PROF_DIR", raising=False)
    server, model, _ = cli.build_server(cli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu,cpu", "--replicas", "2",
         "--port", "0", "--buckets", "1", "--prof-dir",
         str(tmp_path / "prof")]))
    try:
        ServeClient(port=server.port).embed(np.zeros((32, 32, 3),
                                                     np.float32))
        report = server.monitor.sample()["subsystems"]
        assert report["model_pool"] == 2 * module_bytes(model)
        assert report["serve_buffers"] == server.engine.traces_bytes > 0
    finally:
        server.stop()
        reset_capture()


# -- the CLI's refusals ---------------------------------------------------------

def _jax_exit(argv) -> str:
    with pytest.raises(SystemExit) as e:
        jax_cli.main(argv)
    return str(e.value)


def _port_exit(argv) -> str:
    with pytest.raises(SystemExit) as e:
        cli.build_server(cli.build_parser().parse_args(argv))
    return str(e.value)


TINY = ["serve", "--tiny", "--port", "0"]


def test_refusals_are_the_jax_clis():
    jax_tiny = TINY + ["--preset", "siglip-base-patch16-256"]
    assert _port_exit(TINY + ["--device", "cpu", "--self-heal"]) == \
        _jax_exit(jax_tiny + ["--self-heal"])
    assert _port_exit(TINY + ["--device", "cpu,cpu", "--dtype", "int8",
                              "--model-parallel", "2"]) == \
        _jax_exit(jax_tiny + ["--dtype", "int8", "--model-parallel", "2"])
    assert _port_exit(TINY + ["--device", "cpu", "--bf16", "--dtype",
                              "f32"]) == \
        _jax_exit(jax_tiny + ["--bf16", "--dtype", "f32"])


@pytest.mark.parametrize("flag", ["--model-parallel", "--seq-parallel"])
def test_wider_replicas_are_refused_naming_part_2(flag):
    """Item 8(a) part 2 is ported: a two-device replica serves, and
    answers as the model does."""
    assert not hasattr(cli, "_MODEL_PARALLEL_NOT_PORTED")
    server, model, ready = cli.build_server(cli.build_parser().parse_args(
        TINY + ["--device", "cpu,cpu", flag, "2", "--buckets", "1"]))
    try:
        image = np.random.default_rng(0).uniform(
            -1, 1, (32, 32, 3)).astype(np.float32)
        got = ServeClient(port=server.port).embed(image)
    finally:
        server.stop()
    assert ready["topology"]["devices_used"] == 2
    with torch.inference_mode():
        want = model.encode_image(torch.from_numpy(image[None]))[0].numpy()
    np.testing.assert_allclose(np.asarray(got), want, **TOL)


def test_two_replicas_on_one_card_are_refused_as_jax_does(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = cli.build_parser().parse_args(["serve", "--replicas", "2"])
    assert args.device == "cuda"
    with pytest.raises(ValueError) as e:
        cli.build_server(args)
    want = _message(jax_plan, 2, devices=_jax_devices(1))
    assert str(e.value).split(" (e.g. ")[0] == want.split(" (e.g. ")[0]
    assert "--device cuda:0,cuda:0" in str(e.value)


def test_device_lists():
    assert cli.serve_devices("cpu,cpu") == [CPU, CPU]
    assert cli.serve_devices(" cpu ") == [CPU]
    with pytest.raises(SystemExit, match="names no device"):
        cli.serve_devices(",")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.serve_devices("cuda")
    args = cli.build_parser().parse_args(["serve", "--bf16"])
    assert cli.serve_dtype(args) == "bf16"
    assert cli.serve_dtype(cli.build_parser().parse_args(["serve"])) == "f32"
