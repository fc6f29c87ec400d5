"""The port's serving health machinery on the CPU, held to the JAX package:
the replica watchdog, revive, live replan and self-heal (JAX's
``TestReplicaWatchdog``, ``TestReviveHook``, ``TestReplan`` and
``TestSelfHeal`` case for case), the SLO engine (``TestSlo``,
``TestSloTransitions``, and the same burn rates as JAX's on the same
observations), the stdlib client (``TestClientRetry``, typed errors and
``Retry-After``), and a tiny CLIP served by two replicas with JAX's weights
against JAX's ``build_replica_forwards``, driven through the fence, revive
and heal drills over HTTP."""

import asyncio
import json
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import cli as jax_cli
from jimm_tpu import preset as jax_preset
from jimm_tpu.models.clip import CLIP as JaxCLIP
from jimm_tpu.obs.registry import MetricRegistry as JaxRegistry
from jimm_tpu.obs.slo import SloEngine as JaxSloEngine
from jimm_tpu.obs.slo import SloObjective as JaxSloObjective
from jimm_tpu.serve import build_replica_forwards as jax_build_forwards
from jimm_tpu.serve import plan_topology as jax_plan
from jimm_tpu_torch import cli, obs
from jimm_tpu_torch.models.common import load_jax_params
from jimm_tpu_torch.obs.journal import chain, configure_journal, reset_journal
from jimm_tpu_torch.obs.registry import MetricRegistry, unpublish
from jimm_tpu_torch.obs.slo import SloEngine, SloObjective
from jimm_tpu_torch.serve import (BucketTable, InferenceEngine,
                                  ServeClientError, ServingServer,
                                  ShedClientError, ShedError,
                                  ThrottledClientError,
                                  build_replica_forwards, plan_topology)
from jimm_tpu_torch.serve.admission import RequestError
from jimm_tpu_torch.serve import engine as engine_mod
from jimm_tpu_torch.serve.client import ServeClient, _typed_error
from test_torch_siglip import jax_params

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


# -- the watchdog, revive, replan and self-heal (JAX's cases) ------------------

def _engine(forwards, **kw):
    kw.setdefault("item_shape", (3,))
    kw.setdefault("buckets", BucketTable((1, 2)))
    kw.setdefault("max_delay_ms", 1.0)
    return InferenceEngine(forwards, **kw)


def _ok(x):
    return np.asarray(x) * 2


class _Raiser:
    def __call__(self, x):
        raise RuntimeError("device lost")


async def _fence_replica(engine, index=1, tries=30):
    for _ in range(tries):
        try:
            await engine.submit(np.ones(3, np.float32))
        except RuntimeError:
            pass
        if index in engine.dead_replicas():
            return
        if engine.metrics.count("replans_total") > 0:
            return
        await asyncio.sleep(0.01)


class TestReplicaWatchdog:
    def test_failing_replica_restarts_once_then_fenced(self):
        def ok(x):
            return x * 2

        engine = _engine([ok, _Raiser()])

        async def go():
            await engine.start()
            try:
                for _ in range(16):
                    try:
                        await engine.submit(np.ones(3, np.float32))
                    except RuntimeError:
                        pass
                    if engine.dead_replicas():
                        break
                assert engine.dead_replicas() == [1]
                stats = {s["replica"]: s for s in engine.replica_stats()}
                assert stats[1]["restarts"] == 1 and stats[1]["dead"]
                assert not stats[0]["dead"]
                out = await engine.submit(np.ones(3, np.float32))
                np.testing.assert_allclose(np.asarray(out), 2.0)
            finally:
                await engine.stop()

        asyncio.run(go())

    def test_last_live_replica_is_never_fenced(self):
        engine = _engine([_Raiser()])

        async def go():
            await engine.start()
            try:
                for _ in range(4):
                    with pytest.raises(RuntimeError, match="device lost"):
                        await engine.submit(np.ones(3, np.float32))
                assert engine.dead_replicas() == []
                stats = engine.replica_stats()[0]
                assert stats["restarts"] == 1 and not stats["dead"]
            finally:
                await engine.stop()

        asyncio.run(go())

    def test_healthz_reports_degraded_with_dead_replica(self):
        engine = _engine([lambda x: x, lambda x: x])
        engine._replicas[1].dead = True
        out = ServingServer(engine, warmup=False).healthz()
        assert out["status"] == "degraded"
        assert out["dead_replicas"] == [1]
        assert out["replicas"][1]["dead"] is True


class TestReviveHook:
    def test_revive_unfences_and_rearms(self):
        engine = _engine([_ok, _ok])

        async def go():
            await engine.start()
            try:
                engine._replicas[1].forward = _Raiser()
                await _fence_replica(engine)
                assert engine.dead_replicas() == [1]
                engine._replicas[1].forward = _ok
                row = engine.revive(1)
                assert row["dead"] is False and row["revived"] == 1
                assert row["restarts"] == 0
                assert engine.dead_replicas() == []
                assert engine.metrics.count("revives_total") == 1
                assert engine.metrics.count("replica_1_revived_total") == 1
                for _ in range(4):
                    out = await engine.submit(np.ones(3, np.float32))
                    np.testing.assert_allclose(np.asarray(out), 2.0)
            finally:
                await engine.stop()

        asyncio.run(go())

    def test_revive_rejects_bad_targets(self):
        engine = _engine([_ok, _ok])
        with pytest.raises(ValueError, match="no replica 7"):
            engine.revive(7)
        with pytest.raises(ValueError, match="not fenced"):
            engine.revive(0)

    def test_server_revive_route_and_healthz(self):
        engine = _engine([_ok, _ok])
        engine._replicas[1].dead = True
        server = ServingServer(engine, warmup=False)
        out = server.healthz()
        assert out["status"] == "degraded"
        assert out["replans"] == 0
        assert out["replicas"][1]["revived"] == 0
        res = server.revive({"replica": 1})
        assert res["revived"] == 1 and res["dead_replicas"] == []
        out = server.healthz()
        assert out["status"] == "ok"
        assert out["replicas"][1]["revived"] == 1
        with pytest.raises(RequestError):
            server.revive({"replica": "one"})
        with pytest.raises(RequestError):
            server.revive({"replica": 5})


class TestReplan:
    def test_replan_grows_and_shrinks_live(self):
        engine = _engine([_ok, _ok])

        async def go():
            await engine.start()
            try:
                out = await engine.submit(np.ones(3, np.float32))
                np.testing.assert_allclose(np.asarray(out), 2.0)
                info = await engine.replan([_ok, _ok, _ok])
                assert info["replicas"] == 3 and info["was_running"]
                assert engine.n_replicas == 3
                for _ in range(6):
                    out = await engine.submit(np.ones(3, np.float32))
                    np.testing.assert_allclose(np.asarray(out), 2.0)
                await engine.replan([_ok, _ok])
                assert engine.n_replicas == 2
                snap = engine.metrics.snapshot()
                assert snap["replica_2_inflight"] == 0.0
                assert engine.metrics.count("replans_total") == 2
                out = await engine.submit(np.ones(3, np.float32))
                np.testing.assert_allclose(np.asarray(out), 2.0)
            finally:
                await engine.stop()

        asyncio.run(go())

    def test_replan_keeps_queued_requests(self):
        engine = _engine([_ok])

        async def go():
            await engine.start()
            try:
                submits = [asyncio.ensure_future(
                    engine.submit(np.ones(3, np.float32)))
                    for _ in range(8)]
                await engine.replan([_ok, _ok])
                outs = await asyncio.gather(*submits)
                for out in outs:
                    np.testing.assert_allclose(np.asarray(out), 2.0)
            finally:
                await engine.stop()

        asyncio.run(go())

    def test_replan_warms_prepare_bucket_forwards(self):
        calls = []

        class StoreBacked:
            def prepare_bucket(self, bucket):
                calls.append(bucket)
                return "aot"

            def __call__(self, x):
                return np.asarray(x) * 2

        engine = _engine([_ok, _ok])

        async def go():
            await engine.start()
            try:
                await engine.replan([StoreBacked(), StoreBacked()])
                assert sorted(calls) == [1, 1, 2, 2]
                out = await engine.submit(np.ones(3, np.float32))
                np.testing.assert_allclose(np.asarray(out), 2.0)
            finally:
                await engine.stop()

        asyncio.run(go())


class TestSelfHeal:
    def test_fence_escalates_to_replan_around(self):
        heal_calls = []

        def heal():
            heal_calls.append(1)
            return [_ok, _ok], lambda: 0

        engine = _engine([_ok, _Raiser()])
        engine.set_heal(heal)

        async def go():
            await engine.start()
            try:
                await _fence_replica(engine)
                for _ in range(100):
                    if engine.metrics.count("replans_total") >= 1:
                        break
                    await asyncio.sleep(0.01)
                assert heal_calls == [1]
                assert engine.metrics.count("replans_total") == 1
                assert engine.dead_replicas() == []
                assert engine.n_replicas == 2
                for _ in range(6):
                    out = await engine.submit(np.ones(3, np.float32))
                    np.testing.assert_allclose(np.asarray(out), 2.0)
            finally:
                await engine.stop()

        asyncio.run(go())

    def test_transient_fault_revives_in_place(self):
        heal_calls = []
        flaky = {"fails": 0}

        def sometimes(x):
            if flaky["fails"] < 2:
                flaky["fails"] += 1
                raise RuntimeError("transient")
            return np.asarray(x) * 2

        def heal():
            heal_calls.append(1)
            return [_ok, _ok], None

        engine = _engine([_ok, sometimes])
        engine.set_heal(heal)

        async def go():
            await engine.start()
            try:
                await _fence_replica(engine)
                for _ in range(100):
                    if engine.metrics.count("revives_total") >= 1:
                        break
                    await asyncio.sleep(0.01)
                assert engine.metrics.count("revives_total") == 1
                assert heal_calls == []
                assert engine.dead_replicas() == []
            finally:
                await engine.stop()

        asyncio.run(go())

    def test_failed_heal_is_counted_not_fatal(self):
        def heal():
            raise OSError("store unreachable")

        engine = _engine([_ok, _Raiser()])
        engine.set_heal(heal)

        async def go():
            await engine.start()
            try:
                await _fence_replica(engine)
                for _ in range(100):
                    if engine.metrics.count("heal_failures_total") >= 1:
                        break
                    await asyncio.sleep(0.01)
                assert engine.metrics.count("heal_failures_total") == 1
                assert "store unreachable" in engine.last_heal_error
                out = await engine.submit(np.ones(3, np.float32))
                np.testing.assert_allclose(np.asarray(out), 2.0)
            finally:
                await engine.stop()

        asyncio.run(go())


@pytest.fixture
def journal():
    j = configure_journal(None)
    yield j
    reset_journal()


def test_heal_chains_one_incident(journal, monkeypatch):
    """A lasting fault: restart, fence, a failed probe, the rebuild and the
    replan, every event on the fenced replica's cid, and a deep capture
    asked for at the heal and at the replan on that cid."""
    triggers = []
    monkeypatch.setattr(engine_mod, "maybe_trigger",
                        lambda cid, reason: triggers.append((cid, reason)))
    engine = _engine([_ok, _Raiser()])
    engine.set_heal(lambda: [_ok, _ok])

    async def go():
        await engine.start()
        try:
            await _fence_replica(engine)
            for _ in range(200):
                if engine.metrics.count("replans_total") >= 1:
                    break
                await asyncio.sleep(0.01)
        finally:
            await engine.stop()

    asyncio.run(go())
    first = next(e for e in journal.events() if e["event"] == "replica_fault")
    got = [(e["event"], e.get("action"), e.get("ok"))
           for e in chain(journal.events(), first["cid"])]
    assert got == [("replica_fault", "restart", None),
                   ("replica_fenced", None, None),
                   ("heal_probe", None, False), ("heal_rebuilt", None, None),
                   ("replan_started", None, None),
                   ("replan_done", None, None)]
    assert triggers == [(first["cid"], "heal"), (first["cid"], "replan")]
    snap = engine.metrics.snapshot()
    assert snap["goodput_heal_seconds_total"] > 0
    assert snap["goodput_replan_seconds_total"] > 0


# -- the SLO engine (JAX's cases, and JAX's numbers) ---------------------------

def make_engine(objectives=None, **kw):
    clock = {"t": 1000.0}
    kw.setdefault("registry", MetricRegistry("slo_test"))
    eng = SloEngine(objectives, clock=lambda: clock["t"], **kw)
    return eng, clock


class TestSlo:
    def test_objective_validation(self):
        assert SloObjective(0.999).error_budget == pytest.approx(0.001)
        with pytest.raises(ValueError):
            SloObjective(availability=1.0)
        with pytest.raises(ValueError):
            SloObjective(availability=0.9, latency_ms=0)
        with pytest.raises(ValueError):
            SloObjective.from_dict({"availability": 0.9, "bogus": 1})
        assert SloObjective.from_dict(
            {"availability": 0.99, "latency_ms": 250}).latency_ms == 250.0

    def test_zero_traffic_windows_burn_nothing(self):
        eng, clock = make_engine({"t": SloObjective(0.9)})
        assert eng.burn_rate("t", 60.0) == 0.0
        assert eng.fast_burning() == []
        eng.observe("t", False)
        assert eng.burn_rate("t", 60.0) > 0.0
        clock["t"] += 10_000.0
        assert eng.burn_rate("t", 60.0) == 0.0

    def test_burn_rate_math(self):
        eng, clock = make_engine({"t": SloObjective(0.9)})
        for _ in range(9):
            eng.observe("t", True)
        eng.observe("t", False)
        assert eng.burn_rate("t", 60.0) == pytest.approx(1.0)
        eng2, _ = make_engine({"t": SloObjective(0.9)})
        eng2.observe("t", False)
        assert eng2.burn_rate("t", 60.0) == pytest.approx(10.0)

    def test_multi_window_guard(self):
        eng, clock = make_engine({"t": SloObjective(0.5)},
                                 fast_window_s=60, slow_window_s=600,
                                 fast_burn_threshold=1.5)
        for _ in range(400):
            eng.observe("t", True)
        clock["t"] += 300.0
        eng.observe("t", False)
        assert eng.burn_rate("t", 60.0) == pytest.approx(2.0)
        assert eng.burn_rate("t", 600.0) < 1.0
        assert eng.fast_burning() == []
        for _ in range(500):
            eng.observe("t", False)
        assert "t" in eng.fast_burning()

    def test_latency_target_counts_slow_success_as_bad(self):
        eng, _ = make_engine({"t": SloObjective(0.9, latency_ms=100.0)})
        assert eng.observe("t", True, latency_s=0.05) is True
        assert eng.observe("t", True, latency_s=0.5) is False
        assert eng.observe("t", False, latency_s=0.01) is False
        snap = eng.snapshot()["tenants"]["t"]
        assert snap["good_total"] == 1 and snap["bad_total"] == 2

    def test_unknown_tenant_folds_to_default(self):
        eng, _ = make_engine({"vip": SloObjective(0.99)})
        eng.observe("attacker-invented-name", False)
        eng.observe(None, True)
        snap = eng.snapshot()["tenants"]
        assert set(snap) == {"vip", "default"}
        assert snap["default"]["bad_total"] == 1
        assert snap["default"]["good_total"] == 1

    def test_publishes_jimm_slo_series(self):
        eng = SloEngine({"alice": SloObjective(0.99)})
        try:
            eng.observe("alice", True)
            snap = obs.snapshot()
            assert snap["jimm_slo_alice_good_total"] == 1
            assert "jimm_slo_alice_fast_burn_rate" in snap
        finally:
            unpublish("jimm_slo")

    def test_snapshot_shape(self):
        eng, _ = make_engine({"t": SloObjective(0.999)})
        snap = eng.snapshot()
        assert snap["fast_window_s"] == 60.0
        assert snap["fast_burn_threshold"] == 14.4
        assert snap["fast_burning"] == []
        assert snap["tenants"]["t"]["objective"] == {"availability": 0.999}


class TestSloTransitions:
    @staticmethod
    def make_listening_engine(**kw):
        kw.setdefault("fast_window_s", 60)
        kw.setdefault("slow_window_s", 600)
        kw.setdefault("fast_burn_threshold", 1.5)
        eng, clock = make_engine({"t": SloObjective(0.5)}, **kw)
        events = []
        eng.add_listener(
            lambda tenant, entered, fast, slow:
            events.append((tenant, entered, fast, slow)))
        return eng, clock, events

    def test_enter_fires_once_not_per_observation(self):
        eng, clock, events = self.make_listening_engine()
        eng.observe("t", False)
        assert events == [("t", True, pytest.approx(2.0),
                           pytest.approx(2.0))]
        for _ in range(5):
            eng.observe("t", False)
        assert len(events) == 1

    def test_exit_fires_when_windows_drain(self):
        eng, clock, events = self.make_listening_engine()
        eng.observe("t", False)
        assert [e[1] for e in events] == [True]
        clock["t"] += 700.0
        assert len(events) == 1
        eng.observe("t", True)
        assert [e[1] for e in events] == [True, False]
        tenant, entered, fast, slow = events[-1]
        assert fast < 1.5 and slow < 1.0

    def test_burst_diluted_by_slow_window_never_fires(self):
        eng, clock, events = self.make_listening_engine()
        for _ in range(400):
            eng.observe("t", True)
        clock["t"] += 300.0
        eng.observe("t", False)
        assert eng.burn_rate("t", 60.0) >= 1.5
        assert eng.burn_rate("t", 600.0) < 1.0
        assert events == []
        for _ in range(500):
            eng.observe("t", False)
        assert [e[1] for e in events] == [True]
        assert events[0][3] >= 1.0

    def test_flap_across_windows_yields_paired_transitions(self):
        eng, clock, events = self.make_listening_engine()
        for _ in range(3):
            eng.observe("t", False)
            clock["t"] += 700.0
            eng.observe("t", True)
            clock["t"] += 700.0
        assert [e[1] for e in events] == [True, False] * 3

    def test_listener_errors_counted_not_raised(self):
        eng, clock, events = self.make_listening_engine()

        def broken(tenant, entered, fast, slow):
            raise RuntimeError("consumer bug")

        eng._listeners.insert(0, broken)
        assert eng.observe("t", False) is False
        assert [e[1] for e in events] == [True]
        assert eng.registry.counter("listener_errors_total").value == 1


@pytest.mark.parametrize("seed", range(4))
def test_burn_rates_equal_jax(seed):
    """One random observation sequence (tenants known and unknown, latency
    targets, idle gaps) through both packages' engines on fake clocks: the
    same verdicts, burn rates, fast-burn sets, transitions and snapshots."""
    specs = {"t": (0.99, 200.0), "u": (0.9, None)}
    engines = []
    for module_objective, engine_cls, registry in (
            (SloObjective, SloEngine, MetricRegistry("slo_port")),
            (JaxSloObjective, JaxSloEngine, JaxRegistry("slo_jax"))):
        clock = {"t": 5000.0}
        eng = engine_cls({k: module_objective(a, latency_ms=l)
                          for k, (a, l) in specs.items()},
                         fast_window_s=30, slow_window_s=300,
                         fast_burn_threshold=3.0, registry=registry,
                         clock=lambda c=clock: c["t"])
        events = []
        eng.add_listener(lambda *e, out=events: out.append(e))
        engines.append((eng, clock, events))
    rng = np.random.default_rng(seed)
    for _ in range(600):
        dt = float(rng.choice([0.0, 0.2, 3.0, 40.0, 400.0],
                              p=[0.5, 0.3, 0.15, 0.04, 0.01]))
        tenant = rng.choice(["t", "u", "nobody", None])
        ok = bool(rng.random() < 0.85)
        latency = float(rng.exponential(0.12))
        verdicts = []
        for eng, clock, _ in engines:
            clock["t"] += dt
            verdicts.append(eng.observe(tenant, ok, latency))
        assert verdicts[0] == verdicts[1]
        for name in ("t", "u", "default"):
            for window in (30.0, 300.0, 45.0):
                assert engines[0][0].burn_rate(name, window) == \
                    engines[1][0].burn_rate(name, window)
        assert engines[0][0].fast_burning() == engines[1][0].fast_burning()
    assert engines[0][2] == engines[1][2]
    assert engines[0][0].snapshot() == engines[1][0].snapshot()
    assert engines[0][0].registry.snapshot() == \
        engines[1][0].registry.snapshot()


def test_fast_burn_degrades_healthz_and_escalates(journal, monkeypatch):
    triggers = []
    monkeypatch.setattr(engine_mod, "maybe_trigger",
                        lambda cid, reason: triggers.append((cid, reason)))
    engine = _engine([_ok, _ok])
    # every request bad: burn 1 / 0.01 = 100, over the 14.4 page
    slo = SloEngine({"default": SloObjective(0.99)},
                    registry=MetricRegistry("slo_health"))
    engine.attach_slo(slo)
    server = ServingServer(engine, warmup=False)
    for _ in range(5):
        slo.observe(None, False)
    engine._slo_check_escalate()
    out = server.healthz()
    assert out["status"] == "degraded"
    assert out["slo"]["fast_burning"] == ["default"]
    assert engine.metrics.count("slo_fast_burn_total") == 1
    assert [e["event"] for e in journal.events()] == ["slo_fast_burn"]
    assert triggers == [(None, "slo_fast_burn")]


# -- the client -----------------------------------------------------------------

class TestClientRetry:
    def _client(self, **kw):
        client = ServeClient(port=1, backoff_seed=0, **kw)
        slept = []
        client._sleep = slept.append
        return client, slept

    def test_fresh_connection_failures_backoff_then_raise(self):
        client, slept = self._client(retries=2, backoff_base_s=0.05)
        with pytest.raises(OSError):
            client.healthz()
        assert len(slept) == 2
        assert all(0.0 <= s <= 0.05 * 2 * 1.5 for s in slept)

    def test_zero_retries_raises_immediately(self):
        client, slept = self._client(retries=0)
        with pytest.raises(OSError):
            client.healthz()
        assert slept == []

    def test_deadline_bounds_the_retry_budget(self):
        client, slept = self._client(retries=5, backoff_base_s=10.0)
        with pytest.raises(OSError):
            client._request("GET", "/healthz", deadline_s=0.5)
        assert slept == []


def test_typed_client_errors():
    assert type(_typed_error(429, "throttled", "m", 1.0)) \
        is ThrottledClientError
    assert type(_typed_error(503, "shed", "m", None)) is ShedClientError
    err = _typed_error(503, "queue_full", "m", None)
    assert type(err) is ServeClientError and err.status == 503


def test_shed_answers_carry_retry_after(monkeypatch):
    """A 503 shed answer carries ``Retry-After``; the client honors it up to
    ``retry_throttled`` times, then raises the typed error."""
    engine = _engine([_ok])
    server = ServingServer(engine, port=0)
    server.start()
    attempts = []

    def shed(payload):
        attempts.append(payload["trace_id"])
        raise ShedError("shed to admit class 'gold'", retry_after_s=0.25)

    monkeypatch.setattr(server, "embed", shed)
    try:
        client = ServeClient(port=server.port, retry_throttled=2,
                             backoff_base_s=0.01, backoff_seed=0)
        slept = []
        client._sleep = slept.append
        with pytest.raises(ShedClientError) as e:
            client.embed(np.ones(3, np.float32))
        assert e.value.retry_after_s == 0.25 and e.value.status == 503
        assert len(slept) == 2 and all(s >= 0.25 for s in slept)
        # one trace id for the logical request, retries included
        assert len(attempts) == 3 and len(set(attempts)) == 1
        with pytest.raises(ServeClientError) as e:
            client.search(vector=np.ones(4, np.float32))
        # a server without an index answers /v1/search as JAX's does
        assert e.value.status == 400 and "serve --index" in str(e.value)
    finally:
        server.stop()


def test_metrics_file_logs_snapshots(tmp_path):
    path = tmp_path / "serve_metrics.jsonl"
    server, _, _ = cli.build_server(cli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu", "--port", "0", "--buckets",
         "1", "--metrics-file", str(path), "--metrics-every-s", "0.05"]))
    try:
        ServeClient(port=server.port).embed(np.zeros((32, 32, 3),
                                                     np.float32))
        end = time.monotonic() + 30
        while not (path.exists() and len(path.read_text().splitlines()) >= 2):
            assert time.monotonic() < end
            time.sleep(0.02)
    finally:
        server.stop()
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["step"] for r in rows[:2]] == [0, 1]
    assert rows[-1]["responses_total"] == 1
    assert "latency_p99_ms" in rows[-1] and "uptime_s" in rows[-1]


# -- a tiny CLIP served by two replicas, and the drills ------------------------

@pytest.fixture(scope="module")
def clip():
    jmodel = JaxCLIP(jax_cli._tiny_override(
        jax_preset("clip-vit-base-patch16")), rngs=nnx.Rngs(0))
    params = jax_params(jmodel)
    jforwards, _ = jax_build_forwards(
        jmodel, jax_plan(2, 1, devices=jax.devices()[:2]),
        method="encode_image", item_shape=(32, 32, 3))
    images = np.random.default_rng(1).standard_normal(
        (10, 32, 32, 3)).astype(np.float32)
    want = [np.asarray(f(images)) for f in jforwards]
    original = cli.serving_model

    def carried(cfg, dtype, device, generator=None):
        model, quantized = original(cfg, dtype, device, generator)
        load_jax_params(model, params)
        return model, quantized

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "serving_model", carried)
        server, model, ready = cli.build_server(cli.build_parser().parse_args(
            ["serve", "--preset", "clip-vit-base-patch16", "--tiny",
             "--device", "cpu,cpu", "--replicas", "2", "--port", "0",
             "--buckets", "1,2,4", "--max-delay-ms", "20"]))
    try:
        yield dict(server=server, model=model, ready=ready, images=images,
                   want=want)
    finally:
        server.stop()


def test_clip_replicas_match_jax_replicas(clip):
    server, images = clip["server"], clip["images"]
    client = ServeClient(port=server.port, timeout_s=60)
    with ThreadPoolExecutor(5) as pool:
        got = list(pool.map(client.embed, images))
    np.testing.assert_allclose(np.asarray(got), clip["want"][0], **TOL)
    np.testing.assert_allclose(clip["want"][1], clip["want"][0], **TOL)
    assert all(s["dispatched"] >= 1 for s in server.engine.replica_stats())
    assert clip["ready"]["topology"]["replicas"] == 2


class _Faulty:
    """A replica forward that raises on command: ``fail`` times, or for
    good with ``fail = -1``."""

    def __init__(self, inner):
        self.inner = inner
        self.fail = 0

    def __call__(self, x):
        if self.fail:
            self.fail -= self.fail > 0
            raise RuntimeError("device lost")
        return self.inner(x)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _post(port: int, path: str, payload: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait(pred, timeout_s: float = 60.0) -> None:
    end = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < end, "condition not reached in time"
        time.sleep(0.01)


def test_drills_fence_revive_and_heal(clip, journal):
    """The library path over the served model: one failure restarts the
    lane, a second fences it (healthz degraded), POST /admin/revive
    un-fences it; then a lasting fault is healed by a rebuild and a replan
    to two live lanes, and requests sent meanwhile are answered."""
    model, images, want = clip["model"], clip["images"], clip["want"][0]
    plan = plan_topology(2, devices=[CPU, CPU])
    forwards = build_replica_forwards(model, plan, method="encode_image")
    faulty = _Faulty(forwards[1])
    engine = InferenceEngine([forwards[0], faulty], item_shape=(32, 32, 3),
                             buckets=BucketTable((1, 2, 4)),
                             max_delay_ms=1.0)
    server = ServingServer(engine, port=0)
    server.start()
    client = ServeClient(port=server.port, timeout_s=60)
    body = {"image": images[0].tolist()}
    try:
        faulty.fail = 2
        statuses = [_post(server.port, "/v1/embed", body)[0]
                    for _ in range(4)]
        assert sorted(statuses) == [200, 200, 500, 500], statuses
        health = client.healthz()
        assert health["status"] == "degraded"
        assert health["dead_replicas"] == [1]
        assert health["replicas"][1]["restarts"] == 1
        status, out = _post(server.port, "/admin/revive", {"replica": 1})
        assert status == 200 and out["dead_replicas"] == []
        assert _post(server.port, "/admin/revive", {"replica": 1})[0] == 400
        assert client.healthz()["status"] == "ok"
        for _ in range(2):
            np.testing.assert_allclose(client.embed(images[0]), want[0],
                                       **TOL)

        sent = []

        def rebuild():
            built = build_replica_forwards(model, plan, method="encode_image")
            # requests sent while the replan runs
            sent.append(pool.submit(
                lambda: list(map(client.embed, images[1:9]))))
            return built

        engine.set_heal(rebuild)
        faulty.fail = -1
        with ThreadPoolExecutor(1) as pool:
            for _ in range(6):
                _post(server.port, "/v1/embed", body)
                if engine.metrics.count("replans_total"):
                    break
            _wait(lambda: engine.metrics.count("replans_total") == 1)
            answers = sent[0].result(timeout=60)
        np.testing.assert_allclose(np.asarray(answers), want[1:9], **TOL)
        health = client.healthz()
        assert health["status"] == "ok" and health["replans"] == 1
        assert engine.n_replicas == 2 and engine.dead_replicas() == []
        assert faulty not in engine.forwards
        with ThreadPoolExecutor(4) as burst:
            after = list(burst.map(client.embed, images))
        np.testing.assert_allclose(np.asarray(after), want, **TOL)
        assert {r["replica"] for r in engine.recent_traces} == {0, 1}
    finally:
        server.stop()
    events = journal.events()
    cids = [e["cid"] for e in events if e["event"] == "replica_fenced"]
    assert len(cids) == 2 and cids[0] != cids[1]
    assert [e["event"] for e in chain(events, cids[0])] == [
        "replica_fault", "replica_fenced", "replica_revived"]
    assert [e["event"] for e in chain(events, cids[1])] == [
        "replica_fault", "replica_fenced", "heal_probe", "heal_rebuilt",
        "replan_started", "replan_done"]


def test_metrics_text_merges_the_hub(clip):
    slo = SloEngine({"default": SloObjective(0.99)})
    try:
        slo.observe(None, True)
        text = clip["server"].metrics_text()
        assert "jimm_slo_default_good_total 1" in text
        assert "jimm_serve_requests_total" in text
        assert "# TYPE jimm_serve_replans_total counter" in text
    finally:
        unpublish("jimm_slo")
