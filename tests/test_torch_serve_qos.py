"""The port's QoS package (``jimm_tpu_torch.serve.qos``) against the JAX
package's: JAX's ``tests/test_qos.py`` classes run on the port's copies
(policy, token bucket, scheduler, weighted-fair queue, the engine's tenant
path, the model pool, the tenant wire over HTTP, the ``qos`` command);
the same admit/throttle/shed/dequeue decisions as JAX's scheduler and
queue on seeded random request sequences; ``qos ls`` and ``qos validate``
printing what JAX's prints for the same files; and ``serve --qos-policy
--pool-model`` with an int8 twin behind a sequence-parallel default,
routed by ``X-Jimm-Model``.

The reference's guarantees, held here too:

- **weighted fairness**: under saturation the deficit-round-robin dequeue
  shares converge to the configured class weights;
- **class-ordered shedding**: a queued request is only ever evicted in
  favor of a strictly higher class, and only while every class below the
  victim's is empty;
- **no policy, no change**: with no policy configured the engine uses a
  plain ``asyncio.Queue``, healthz carries no ``qos``/``models`` blocks,
  and the submit path is the pre-QoS one.
"""

import asyncio
import contextlib
import io
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from jimm_tpu.serve.admission import ServeMetrics as JaxServeMetrics
from jimm_tpu.serve.admission import ThrottledError as JaxThrottledError
from jimm_tpu.serve.qos import QosScheduler as JaxQosScheduler
from jimm_tpu.serve.qos import TenantRegistry as JaxTenantRegistry
from jimm_tpu.serve.qos import WeightedFairQueue as JaxWeightedFairQueue
from jimm_tpu.serve.qos.cli import main as jax_qos_main
from jimm_tpu.serve.qos.policy import QosPolicyError as JaxQosPolicyError
from jimm_tpu_torch import cli
from jimm_tpu_torch.serve import (AdmissionPolicy, BucketTable,
                                  InferenceEngine, ModelPool,
                                  QosPolicyError, QosScheduler,
                                  QueueFullError, RequestError, ServeClient,
                                  ServeMetrics, ServingServer, ShedError,
                                  ThrottledClientError, ThrottledError,
                                  WeightedFairQueue)
from jimm_tpu_torch.serve.qos.cli import main as qos_main
from jimm_tpu_torch.serve.qos.policy import (DEFAULT_CLASSES, TenantRegistry,
                                             load_policy)
from jimm_tpu_torch.serve.qos.pool import param_nbytes
from jimm_tpu_torch.serve.qos.scheduler import TokenBucket

REPO = pathlib.Path(__file__).resolve().parent.parent

POLICY = {
    "classes": {"interactive": {"weight": 8}, "batch": {"weight": 2},
                "background": {"weight": 1}},
    "tenants": {
        "vip": {"class": "interactive", "rate": 100, "burst": 200},
        "bulk": {"class": "batch"},
        "crawler": {"class": "background", "max_queued": 2},
    },
    "default": {"class": "batch"},
}


def _registry(data=None):
    return TenantRegistry.from_dict(data if data is not None else POLICY)


class _Item:
    """Queue stub carrying the two attributes the WFQ reads."""

    def __init__(self, klass, tag=0):
        self.klass = klass
        self.tag = tag
        self.tenant = None


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

class TestPolicy:
    def test_parse_and_priority_order(self):
        reg = _registry()
        assert reg.class_order == ("interactive", "batch", "background")
        assert reg.classes["interactive"].weight == 8.0
        assert reg.rank_of("interactive") == 0
        assert reg.rank_of("background") == 2
        assert reg.tenants["vip"].rate == 100.0
        assert reg.tenants["crawler"].max_queued == 2
        assert reg.default.klass == "batch"

    def test_missing_sections_get_defaults(self):
        reg = _registry({})
        assert reg.class_order == tuple(n for n, _ in DEFAULT_CLASSES)
        assert reg.tenants == {}
        # the built-in default tenant rides the highest class, unlimited
        assert reg.default.klass == "interactive"
        assert reg.default.rate is None

    def test_unknown_and_anonymous_resolve_to_default(self):
        reg = _registry()
        assert reg.resolve_spec(None) is reg.default
        assert reg.resolve_spec("never-heard-of-you") is reg.default
        assert reg.resolve_spec("vip").klass == "interactive"

    def test_all_problems_reported_at_once(self):
        bad = {"classes": {"a": {"weight": -1}},
               "tenants": {"t1": {"class": "nope", "rate": 0},
                           "t2": {"burst": 0.5, "frobnicate": 1}},
               "surprise": {}}
        with pytest.raises(QosPolicyError) as err:
            _registry(bad)
        problems = str(err.value).split("; ")
        assert len(problems) >= 5
        assert any("weight" in p for p in problems)
        assert any("unknown class" in p for p in problems)
        assert any("rate" in p for p in problems)
        assert any("burst" in p for p in problems)
        assert any("frobnicate" in str(p) for p in problems)

    def test_load_json_file(self, tmp_path):
        path = tmp_path / "policy.json"
        path.write_text(json.dumps(POLICY))
        reg = load_policy(str(path))
        assert sorted(reg.tenants) == ["bulk", "crawler", "vip"]

    def test_load_errors_are_typed(self, tmp_path):
        with pytest.raises(QosPolicyError):
            load_policy(str(tmp_path / "missing.json"))
        bad = tmp_path / "bad.json"
        bad.write_text("{nope")
        with pytest.raises(QosPolicyError):
            load_policy(str(bad))

    def test_describe_is_json_shaped(self):
        desc = _registry().describe()
        assert [c["name"] for c in desc["classes"]] == [
            "interactive", "batch", "background"]
        assert json.loads(json.dumps(desc)) == desc


# ---------------------------------------------------------------------------
# token bucket + scheduler admission
# ---------------------------------------------------------------------------

class TestTokenBucket:
    def test_burst_then_refill(self):
        bucket = TokenBucket(rate=10.0, burst=2.0, now=0.0)
        assert bucket.try_take(0.0) == 0.0
        assert bucket.try_take(0.0) == 0.0
        wait = bucket.try_take(0.0)
        assert wait == pytest.approx(0.1)
        # after the hinted wait a token exists again
        assert bucket.try_take(wait) == 0.0

    def test_refill_caps_at_burst(self):
        bucket = TokenBucket(rate=100.0, burst=3.0, now=0.0)
        bucket.try_take(1000.0)
        assert bucket.tokens == pytest.approx(2.0)

    def test_peek_reports_without_mutating(self):
        # regression (JL017): metrics-scrape readers used to call _refill,
        # racing the admission path's read-modify-write of `tokens`
        bucket = TokenBucket(rate=10.0, burst=5.0, now=0.0)
        bucket.try_take(0.0)
        before = (bucket.tokens, bucket.t_last)
        assert bucket.peek(0.5) == pytest.approx(
            min(5.0, before[0] + 0.5 * 10.0))
        assert (bucket.tokens, bucket.t_last) == before
        # a stale clock reading never rolls the bucket backwards either
        assert bucket.peek(-1.0) == pytest.approx(before[0])
        assert (bucket.tokens, bucket.t_last) == before


class TestScheduler:
    def _scheduler(self, t0=0.0):
        clock = {"now": t0}
        sched = QosScheduler(_registry(), clock=lambda: clock["now"])
        return sched, clock

    def test_rate_limit_throttles_with_hint(self):
        sched, clock = self._scheduler()
        reg = _registry({"tenants": {"slow": {"rate": 2, "burst": 1}}})
        sched = QosScheduler(reg, clock=lambda: clock["now"])
        state = sched.resolve("slow")
        sched.admit(state)
        with pytest.raises(ThrottledError) as err:
            sched.admit(state)
        assert err.value.http_status == 429
        assert err.value.retry_after_s == pytest.approx(0.5)
        clock["now"] += 0.5
        sched.admit(state)  # the hint was sufficient, not just polite

    def test_max_queued_quota(self):
        sched, _ = self._scheduler()
        state = sched.resolve("crawler")
        sched.admit(state)
        sched.on_enqueue(state)
        sched.admit(state)
        sched.on_enqueue(state)
        with pytest.raises(ThrottledError):
            sched.admit(state)

    def test_timeout_inheritance(self):
        reg = _registry({"tenants": {"t": {"timeout_s": 0.25}}})
        sched = QosScheduler(reg)
        state = sched.resolve("t")
        assert sched.timeout_for(state, None) == 0.25
        assert sched.timeout_for(state, 1.5) == 1.5  # explicit wins
        assert sched.timeout_for(sched.resolve(None), None) is None

    def test_tenant_cardinality_is_bounded_by_policy(self):
        # the JL014 discipline at runtime: traffic cannot grow the table
        sched, _ = self._scheduler()
        before = len(sched._states)
        default = sched.resolve(None)
        for i in range(100):
            assert sched.resolve(f"invented-{i}") is default
        assert len(sched._states) == before

    def test_snapshot_and_gauges_leave_buckets_untouched(self):
        # regression (JL017): snapshot/scrape are observers; only admit()
        # may advance a bucket's (tokens, t_last) state
        sched, clock = self._scheduler()
        reg = _registry({"tenants": {"slow": {"rate": 2, "burst": 1}}})
        sched = QosScheduler(reg, clock=lambda: clock["now"])
        state = sched.resolve("slow")
        sched.admit(state)
        frozen = (state.bucket.tokens, state.bucket.t_last)
        clock["now"] += 0.25
        snap = sched.snapshot()
        assert (state.bucket.tokens, state.bucket.t_last) == frozen
        assert snap["tenants"]["slow"]["tokens"] == pytest.approx(0.5)

    def test_metrics_precreated_and_snapshot_shape(self):
        sched, _ = self._scheduler()
        metrics = ServeMetrics()
        sched.bind_metrics(metrics)
        snap = metrics.snapshot()
        assert snap["tenant_vip_requests_total"] == 0
        assert snap["class_background_shed_total"] == 0
        qos = sched.snapshot()
        assert sorted(qos["tenants"]) == ["bulk", "crawler", "default",
                                          "vip"]
        assert qos["classes"]["interactive"]["weight"] == 8.0
        assert json.loads(json.dumps(qos)) == qos


# ---------------------------------------------------------------------------
# weighted-fair queue
# ---------------------------------------------------------------------------

class TestWeightedFairQueue:
    def _wfq(self):
        return WeightedFairQueue(QosScheduler(_registry()))

    def test_saturated_shares_converge_to_weights(self):
        q = self._wfq()
        for i in range(400):
            for klass in ("background", "batch", "interactive"):
                q.put_nowait(_Item(klass, i))
        served = {"interactive": 0, "batch": 0, "background": 0}
        for _ in range(440):  # every class stays saturated throughout
            served[q.get_nowait().klass] += 1
        total = sum(served.values())
        for klass, weight in (("interactive", 8), ("batch", 2),
                              ("background", 1)):
            share = served[klass] / total
            assert share == pytest.approx(weight / 11, rel=0.10), served

    def test_fifo_within_class_and_idle_classes_cost_nothing(self):
        q = self._wfq()
        for i in range(5):
            q.put_nowait(_Item("batch", i))
        # no interactive/background traffic: batch drains back-to-back
        assert [q.get_nowait().tag for t in range(5)] == [0, 1, 2, 3, 4]
        with pytest.raises(asyncio.QueueEmpty):
            q.get_nowait()

    def test_control_lane_served_after_work_drains(self):
        q = self._wfq()
        stop = object()  # the engine's _STOP sentinel has no klass attr
        q.put_nowait(_Item("batch", 1))
        q.put_nowait(stop)
        q.put_nowait(_Item("interactive", 2))
        assert q.qsize() == 2  # control items are not queued work
        # both queued requests drain BEFORE the sentinel (stop-then-drain
        # would drop in-flight work on shutdown)
        assert {q.get_nowait().tag, q.get_nowait().tag} == {1, 2}
        assert q.get_nowait() is stop

    def test_async_get_wakes_on_put(self):
        async def go():
            q = self._wfq()
            getter = asyncio.create_task(q.get())
            await asyncio.sleep(0.01)
            assert not getter.done()
            q.put_nowait(_Item("interactive", 7))
            return (await getter).tag

        assert asyncio.run(go()) == 7

    def test_shed_only_strictly_lower_class(self):
        q = self._wfq()
        q.put_nowait(_Item("interactive", 0))
        q.put_nowait(_Item("batch", 1))
        q.put_nowait(_Item("batch", 2))
        q.put_nowait(_Item("background", 3))
        # interactive arrival: background is the lowest non-empty victim
        victim = q.shed_lower(0)
        assert victim.klass == "background"
        # background now empty -> batch gives back its NEWEST
        victim = q.shed_lower(0)
        assert (victim.klass, victim.tag) == ("batch", 2)
        # batch arrival cannot touch batch or interactive
        assert q.shed_lower(1) is None
        # background arrival (lowest class) can never shed anyone
        assert q.shed_lower(2) is None
        q.get_nowait()
        q.get_nowait()
        # queue holds nothing below interactive -> its arrivals get None
        assert q.shed_lower(0) is None

    def test_shed_never_violates_priority_under_churn(self):
        q = self._wfq()
        rank = {"interactive": 0, "batch": 1, "background": 2}
        pattern = ["batch", "background", "interactive", "batch",
                   "background", "batch", "interactive", "background"]
        for i, klass in enumerate(pattern * 5):
            q.put_nowait(_Item(klass, i))
        queued = {k: sum(1 for n in pattern * 5 if n == k) for k in rank}
        while True:
            victim = q.shed_lower(0)
            if victim is None:
                break
            # the victim is the lowest non-empty class below interactive
            assert rank[victim.klass] > 0
            lower = [k for k in rank if rank[k] > rank[victim.klass]]
            assert all(queued[k] == 0 for k in lower), victim.klass
            queued[victim.klass] -= 1
        assert queued["batch"] == queued["background"] == 0
        assert queued["interactive"] == 10  # never touched


# ---------------------------------------------------------------------------
# engine integration
# ---------------------------------------------------------------------------

def _qos_engine(fwd=None, *, max_queue=256, registry=None, **kw):
    sched = QosScheduler(registry or _registry())
    kw.setdefault("buckets", BucketTable((1, 2, 4)))
    kw.setdefault("max_delay_ms", 1.0)
    engine = InferenceEngine(
        fwd or (lambda batch: batch * 2.0), item_shape=(3,),
        policy=AdmissionPolicy(max_queue=max_queue, default_timeout_s=5.0),
        qos=sched, **kw)
    return engine, sched


class TestEngineQos:
    def test_tenant_requests_roundtrip_and_count(self):
        async def go():
            engine, sched = _qos_engine()
            await engine.start()
            out = await engine.submit(np.full(3, 2.0, np.float32),
                                      tenant="vip")
            await engine.stop()
            return out, sched

        out, sched = asyncio.run(go())
        assert np.allclose(out, 4.0)
        snap = sched.snapshot()
        assert snap["tenants"]["vip"]["requests"] == 1
        assert snap["classes"]["interactive"]["dispatched"] == 1

    def test_rate_limited_tenant_throttled(self):
        async def go():
            reg = _registry({"tenants": {"slow": {"rate": 0.1, "burst": 1}}})
            engine, _ = _qos_engine(registry=reg)
            await engine.start()
            item = np.zeros(3, np.float32)
            await engine.submit(item, tenant="slow")
            try:
                with pytest.raises(ThrottledError) as err:
                    await engine.submit(item, tenant="slow")
                return err.value
            finally:
                await engine.stop()

        err = asyncio.run(go())
        assert err.retry_after_s and err.retry_after_s > 1.0

    def test_tenant_deadline_inherited(self):
        def slow(batch):
            time.sleep(0.3)
            return batch

        async def go():
            from jimm_tpu_torch.serve import DeadlineExceededError
            reg = _registry({"tenants": {"t": {"timeout_s": 0.05}}})
            engine, _ = _qos_engine(slow, registry=reg)
            await engine.start()
            try:
                with pytest.raises(DeadlineExceededError):
                    await engine.submit(np.zeros(3, np.float32), tenant="t")
            finally:
                await engine.stop()

        asyncio.run(go())

    def test_overload_sheds_lower_class_for_higher(self):
        def slow(batch):
            time.sleep(0.25)
            return batch * 2.0

        async def go():
            engine, sched = _qos_engine(slow, max_queue=3,
                                        buckets=BucketTable((1,)))
            await engine.start()
            item = np.zeros(3, np.float32)
            filler = asyncio.create_task(
                engine.submit(item, tenant="bulk"))
            await asyncio.sleep(0.1)  # batcher takes it into the slow lane
            bulk = [asyncio.create_task(engine.submit(item, tenant="bulk"))
                    for _ in range(3)]
            await asyncio.sleep(0)  # run each submit's sync admission part
            # queue is at max_queue: a BATCH arrival has no lower class to
            # shed, so it takes the plain queue-full rejection
            with pytest.raises(QueueFullError):
                await engine.submit(item, tenant="bulk")
            # an INTERACTIVE arrival evicts the newest bulk request instead
            vip = await engine.submit(item, tenant="vip")
            results = await asyncio.gather(filler, *bulk,
                                           return_exceptions=True)
            await engine.stop()
            return vip, results, sched

        vip, results, sched = asyncio.run(go())
        assert np.allclose(vip, 0.0)
        shed = [r for r in results if isinstance(r, ShedError)]
        served = [r for r in results if not isinstance(r, Exception)]
        assert len(shed) == 1
        assert shed[0].retry_after_s is not None
        assert len(served) == 3
        snap = sched.snapshot()
        assert snap["tenants"]["bulk"]["shed"] == 1
        assert snap["classes"]["batch"]["shed"] == 1

    def test_no_policy_path_is_plain_queue(self):
        async def go():
            engine = InferenceEngine(lambda b: b, item_shape=(3,),
                                     buckets=BucketTable((1, 2)))
            await engine.start()
            kind = type(engine._queue)
            # tenant= is accepted and ignored without a scheduler
            out = await engine.submit(np.zeros(3, np.float32),
                                      tenant="whoever")
            await engine.stop()
            return kind, out, engine

        kind, out, engine = asyncio.run(go())
        assert kind is asyncio.Queue
        assert engine.qos is None
        snap = engine.metrics.snapshot()
        assert not any(k.startswith(("tenant_", "class_")) for k in snap)


# ---------------------------------------------------------------------------
# model pool
# ---------------------------------------------------------------------------

def _pool_engine(scale, metrics, qos=None):
    return InferenceEngine(lambda b, s=scale: b * s, item_shape=(3,),
                           buckets=BucketTable((1, 2, 4)), max_delay_ms=1.0,
                           metrics=metrics, qos=qos)


class TestModelPool:
    def test_routing_and_unknown_model(self):
        metrics = ServeMetrics()
        a, b = _pool_engine(2.0, metrics), _pool_engine(3.0, metrics)
        pool = ModelPool({"default": a, "beta": b}, default="default")
        assert pool.get(None) is a
        assert pool.get("beta") is b
        with pytest.raises(RequestError):
            pool.get("gamma")
        assert metrics.count("model_beta_requests_total") == 1

    def test_add_swap_remove(self):
        metrics = ServeMetrics()
        a, b, c = (_pool_engine(s, metrics) for s in (1.0, 2.0, 3.0))
        pool = ModelPool({"default": a}, default="default")
        pool.add("canary", b)
        with pytest.raises(ValueError):
            pool.add("canary", c)  # already resident: swap, don't add
        old = pool.swap("canary", c)
        assert old is b
        assert pool.get("canary") is c
        assert pool.remove("canary") is c
        with pytest.raises(ValueError):
            pool.remove("default")  # the default model is not evictable
        assert pool.names() == ["default"]

    def test_describe_shape(self):
        metrics = ServeMetrics()
        pool = ModelPool({"default": _pool_engine(1.0, metrics)},
                         default="default")
        desc = pool.describe()
        assert desc["default"]["default"] is True
        assert desc["default"]["buckets"] == [1, 2, 4]


# ---------------------------------------------------------------------------
# HTTP end to end: tenant headers, model routing, typed errors, healthz
# ---------------------------------------------------------------------------

@pytest.fixture()
def qos_server():
    registry = _registry({
        "classes": POLICY["classes"],
        "tenants": dict(POLICY["tenants"],
                        slow={"class": "batch", "rate": 0.1, "burst": 1}),
        "default": {"class": "batch"},
    })
    sched = QosScheduler(registry)
    metrics = ServeMetrics()
    default = _pool_engine(2.0, metrics, qos=sched)
    beta = _pool_engine(3.0, metrics, qos=sched)
    pool = ModelPool({"default": default, "beta": beta}, default="default")
    server = ServingServer(default, pool=pool, port=0)
    server.start()
    try:
        yield server
    finally:
        server.stop()


class TestHttpQos:
    def _item(self):
        return np.full(3, 1.0, np.float32)

    def test_model_routing_via_header(self, qos_server):
        base = ServeClient(port=qos_server.port, tenant="vip")
        beta = ServeClient(port=qos_server.port, tenant="vip", model="beta")
        assert np.allclose(base.embed(self._item(), timeout_s=5), 2.0)
        assert np.allclose(beta.embed(self._item(), timeout_s=5), 3.0)
        from jimm_tpu_torch.serve import ServeClientError
        bad = ServeClient(port=qos_server.port, model="gamma")
        with pytest.raises(ServeClientError) as err:
            bad.embed(self._item(), timeout_s=5)
        assert err.value.status == 400
        assert "gamma" in str(err.value)

    def test_throttled_is_typed_with_retry_after(self, qos_server):
        client = ServeClient(port=qos_server.port, tenant="slow")
        client.embed(self._item(), timeout_s=5)
        with pytest.raises(ThrottledClientError) as err:
            client.embed(self._item(), timeout_s=5)
        assert err.value.status == 429
        assert err.value.code == "throttled"
        assert err.value.retry_after_s and err.value.retry_after_s > 1.0

    def test_healthz_has_qos_and_models_blocks(self, qos_server):
        health = ServeClient(port=qos_server.port).healthz()
        assert "vip" in health["qos"]["tenants"]
        assert health["qos"]["classes"]["interactive"]["weight"] == 8.0
        assert sorted(health["models"]) == ["beta", "default"]
        assert health["models"]["default"]["default"] is True

    def test_metrics_expose_tenant_and_class_series(self, qos_server):
        client = ServeClient(port=qos_server.port, tenant="vip")
        client.embed(self._item(), timeout_s=5)
        text = client.metrics_text()
        assert "jimm_serve_tenant_vip_requests_total" in text
        assert "jimm_serve_class_interactive_requests_total" in text
        assert "jimm_serve_model_beta_requests_total" in text

    def test_policy_free_server_healthz_unchanged(self):
        engine = _pool_engine(2.0, ServeMetrics())
        server = ServingServer(engine, port=0)
        server.start()
        try:
            health = ServeClient(port=server.port).healthz()
        finally:
            server.stop()
        assert "qos" not in health
        assert "models" not in health


# ---------------------------------------------------------------------------
# CLI + import hygiene
# ---------------------------------------------------------------------------

class TestQosCli:
    def test_validate_ok(self, tmp_path, capsys):
        path = tmp_path / "policy.json"
        path.write_text(json.dumps(POLICY))
        assert qos_main(["qos", "validate", str(path)]) == 0
        assert "OK" in capsys.readouterr().out

    def test_validate_lists_every_problem(self, tmp_path, capsys):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps(
            {"tenants": {"t": {"class": "nope", "rate": -1}}}))
        assert qos_main(["qos", "validate", str(path)]) == 1
        out = capsys.readouterr().out
        assert "INVALID" in out
        assert "unknown class" in out
        assert "rate" in out

    def test_ls_json(self, tmp_path, capsys):
        path = tmp_path / "policy.json"
        path.write_text(json.dumps(POLICY))
        assert qos_main(["qos", "ls", str(path), "--json"]) == 0
        desc = json.loads(capsys.readouterr().out)
        assert [t["name"] for t in desc["tenants"]] == ["bulk", "crawler",
                                                        "vip"]

    def test_qos_package_imports_without_jax(self):
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys\n"
             "import jimm_tpu_torch.serve.qos.cli\n"
             "import jimm_tpu_torch.serve.qos.policy\n"
             "assert 'jax' not in sys.modules, 'qos CLI dragged in jax'"],
            capture_output=True, text=True, cwd=REPO)
        assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# the same decisions as JAX's, on seeded random sequences
# ---------------------------------------------------------------------------

PARITY_POLICY = {
    "classes": {"interactive": {"weight": 8}, "batch": {"weight": 2},
                "background": {"weight": 1}},
    "tenants": {
        "vip": {"class": "interactive", "rate": 40, "burst": 3},
        "bulk": {"class": "batch", "rate": 5, "max_queued": 4},
        "crawler": {"class": "background", "rate": 2, "burst": 2,
                    "max_queued": 2},
    },
    "default": {"class": "batch", "rate": 10, "burst": 2},
}
TENANTS = ["vip", "bulk", "crawler", None, "stranger"]


def _schedulers():
    """The port's and JAX's schedulers over one policy, each on a clock
    the test advances and bound to its own package's metrics."""
    clock = {"now": 0.0}
    now = lambda: clock["now"]  # noqa: E731
    port = QosScheduler(TenantRegistry.from_dict(PARITY_POLICY), clock=now)
    ref = JaxQosScheduler(JaxTenantRegistry.from_dict(PARITY_POLICY),
                          clock=now)
    port.bind_metrics(ServeMetrics())
    ref.bind_metrics(JaxServeMetrics())
    return port, ref, clock


def _admit(sched, error, tenant):
    state = sched.resolve(tenant)
    try:
        sched.admit(state)
    except error as e:
        return ("throttled", e.retry_after_s, str(e))
    sched.on_enqueue(state)
    return ("admitted", state.spec.name)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_decisions_match_jax(seed):
    rng = np.random.default_rng(seed)
    port, ref, clock = _schedulers()
    queued = []
    for _ in range(300):
        clock["now"] += float(rng.exponential(0.04))
        if queued and rng.random() < 0.4:
            # a dispatch: the oldest queued request leaves the queue
            tenant, klass = queued.pop(0)
            for sched in (port, ref):
                req = type("R", (), {"tenant": sched.resolve(tenant),
                                     "klass": klass})()
                sched.on_dequeue(req)
            continue
        tenant = TENANTS[rng.integers(len(TENANTS))]
        got = _admit(port, ThrottledError, tenant)
        want = _admit(ref, JaxThrottledError, tenant)
        assert got == want
        if got[0] == "admitted":
            queued.append((tenant, port.resolve(tenant).spec.klass))
    assert port.snapshot() == ref.snapshot()
    assert port.metrics.snapshot().keys() == ref.metrics.snapshot().keys()


class _Req:
    def __init__(self, klass, tag):
        self.klass = klass
        self.tag = tag
        self.tenant = None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_weighted_fair_queue_decisions_match_jax(seed):
    """Puts, dequeues and class-ordered sheds in a random order: the same
    request out of both queues at every step, and the same counters."""
    rng = np.random.default_rng(seed)
    port, ref, _ = _schedulers()
    queues = (WeightedFairQueue(port), JaxWeightedFairQueue(ref))
    classes = list(PARITY_POLICY["classes"])
    tag = 0
    for _ in range(600):
        op = rng.random()
        if op < 0.55:
            klass = classes[rng.choice(3, p=[0.3, 0.45, 0.25])]
            for q in queues:
                q.put_nowait(_Req(klass, tag))
            tag += 1
        elif op < 0.9:
            out = []
            for q in queues:
                try:
                    out.append(q.get_nowait().tag)
                except asyncio.QueueEmpty:
                    out.append(None)
            assert out[0] == out[1]
        else:
            rank = int(rng.integers(3))
            out = [q.shed_lower(rank) for q in queues]
            assert [None if r is None else r.tag for r in out][0] == \
                [None if r is None else r.tag for r in out][1]
        assert queues[0].qsize() == queues[1].qsize()
    assert port.snapshot() == ref.snapshot()


POLICY_FILES = {
    "good.json": json.dumps(dict(
        PARITY_POLICY, slo={"vip": {"availability": 0.999,
                                    "latency_ms": 250},
                            "default": {"availability": 0.99}})),
    "good.toml": ('[classes.interactive]\nweight = 8\n'
                  '[classes.batch]\nweight = 2\n'
                  '[tenants.alice]\nclass = "interactive"\nrate = 200\n'
                  'burst = 400\ntimeout_s = 2.0\nmax_queued = 64\n'
                  '[tenants.bob]\nclass = "batch"\nrate = 50\n'
                  '[default]\nclass = "batch"\n'),
    "bad.json": json.dumps({
        "classes": {"a": {"weight": -1}},
        "tenants": {"t1": {"class": "nope", "rate": 0},
                    "t2": {"burst": 0.5, "frobnicate": 1}},
        "slo": {"ghost": {"availability": 0.9}}, "surprise": {}}),
    "broken.json": "{nope",
}


@pytest.mark.parametrize("name", sorted(POLICY_FILES))
def test_policies_parse_as_jax_parses_them(tmp_path, name):
    path = tmp_path / name
    path.write_text(POLICY_FILES[name])
    try:
        want = JaxTenantRegistry.load(str(path)).describe()
    except JaxQosPolicyError as e:
        want = ("error", str(e).replace(str(tmp_path), "<dir>"))
    try:
        got = load_policy(str(path)).describe()
    except QosPolicyError as e:
        got = ("error", str(e).replace(str(tmp_path), "<dir>"))
    assert got == want


def _printed(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("verb", [["ls"], ["ls", "--json"], ["validate"]],
                         ids=["ls", "ls-json", "validate"])
@pytest.mark.parametrize("name", sorted(POLICY_FILES))
def test_qos_command_prints_what_jax_prints(tmp_path, verb, name):
    path = tmp_path / name
    path.write_text(POLICY_FILES[name])
    argv = ["qos", verb[0], str(path), *verb[1:]]
    got = _printed(qos_main, argv)
    assert got == _printed(jax_qos_main, argv)
    # and through the port's own CLI
    assert _printed(cli.main, argv) == got


def test_param_nbytes_counts_tensors():
    model = torch.nn.Linear(4, 3)
    assert param_nbytes(model) == (4 * 3 + 3) * 4
    assert param_nbytes({"w": torch.zeros(2, 5, dtype=torch.bfloat16),
                         "n": [np.zeros(3, np.float32)]}) == 20 + 12


# ---------------------------------------------------------------------------
# serve --qos-policy --pool-model: an int8 twin behind a sharded default
# ---------------------------------------------------------------------------

def test_pool_routes_an_int8_twin_behind_a_sharded_default(tmp_path):
    """``serve --device cpu,cpu --seq-parallel 2 --qos-policy P
    --pool-model twin=siglip-base-patch16-256@int8``: the default model
    and its int8 twin are each one replica over the plan's two devices;
    ``X-Jimm-Model: twin`` answers as the quantized model does, the
    default as the f32 one; the over-rate tenant alone gets 429."""
    policy = tmp_path / "policy.json"
    policy.write_text(json.dumps({
        "classes": {"interactive": {"weight": 8}, "batch": {"weight": 2}},
        "tenants": {"vip": {"class": "interactive"},
                    "slow": {"class": "batch", "rate": 0.1, "burst": 1}},
        "default": {"class": "batch"},
        "slo": {"vip": {"availability": 0.99}}}))
    server, model, ready = cli.build_server(cli.build_parser().parse_args(
        ["serve", "--tiny", "--port", "0", "--device", "cpu,cpu",
         "--seq-parallel", "2", "--buckets", "1,2",
         "--qos-policy", str(policy),
         "--pool-model", "twin=siglip-base-patch16-256@int8"]))
    image = np.random.default_rng(0).standard_normal(
        (32, 32, 3)).astype(np.float32)
    try:
        vip = ServeClient(port=server.port, tenant="vip", timeout_s=60)
        default = np.asarray(vip.embed(image))
        twin = np.asarray(ServeClient(port=server.port, tenant="vip",
                                      model="twin", timeout_s=60).embed(image))
        slow = ServeClient(port=server.port, tenant="slow", timeout_s=60)
        slow.embed(image)
        with pytest.raises(ThrottledClientError) as err:
            slow.embed(image)
        vip.embed(image)  # the other tenant is not throttled
        health = vip.healthz()
        text = vip.metrics_text()
        engines = server.pool.engines()
    finally:
        server.stop()
    assert ready["qos"] == {"policy": str(policy),
                            "classes": ["interactive", "batch"],
                            "tenants": ["slow", "vip"], "slo": ["vip"]}
    assert ready["models"]["twin"]["dtype"] == "int8"
    assert ready["topology"]["seq_parallel"] == 2
    assert all(type(f).__name__ == "ShardedReplicaForward"
               for e in engines for f in e.forwards)
    assert err.value.status == 429 and err.value.retry_after_s > 1.0
    assert health["qos"]["tenants"]["slow"]["throttled"] == 1
    assert health["qos"]["tenants"]["vip"]["throttled"] == 0
    assert health["models"]["twin"]["requests"] == 1
    assert "jimm_serve_model_twin_requests_total 1" in text
    assert "jimm_serve_class_interactive_dispatched_total" in text
    with torch.inference_mode():
        want = model.encode_image(torch.from_numpy(image[None]))[0].numpy()
        quantized, _ = cli.serving_model(
            cli.tiny_override(cli.preset("siglip-base-patch16-256")),
            "int8", "cpu")
        want_twin = quantized.encode_image(
            torch.from_numpy(image[None]))[0].numpy()
    np.testing.assert_allclose(default, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(twin, want_twin, rtol=1e-4, atol=1e-4)
    assert not np.allclose(twin, default, rtol=1e-6, atol=1e-6)


def test_prof_dir_counts_every_pool_model(tmp_path, monkeypatch):
    """``serve --prof-dir``'s ``model_pool`` subsystem counts the default
    model and every ``--pool-model``."""
    from jimm_tpu_torch.obs.prof.capture import reset_capture
    from jimm_tpu_torch.obs.prof.memory import module_bytes
    monkeypatch.delenv("JIMM_PROF_DIR", raising=False)
    server, model, _ = cli.build_server(cli.build_parser().parse_args(
        ["serve", "--tiny", "--port", "0", "--device", "cpu", "--buckets",
         "1", "--prof-dir", str(tmp_path / "prof"), "--pool-model",
         "twin=siglip-base-patch16-256@bf16"]))
    try:
        report = server.monitor.sample()["subsystems"]
    finally:
        server.stop()
        reset_capture()
    twin, _ = cli.serving_model(
        cli.tiny_override(cli.preset("siglip-base-patch16-256")), "bf16",
        "cpu")
    assert report["model_pool"] == module_bytes(model) + module_bytes(twin)
