"""The port's confidence cascade (`jimm_tpu_torch/serve/cascade/`), held to
the JAX package's: JAX's ``tests/test_cascade.py`` classes on the port's
copies (calibration fit and wire format, router, escalated billing,
autoscaler, the policy sections, resident bytes, client parsing, HTTP), the
fit bit for bit against JAX's on seeded holdouts, calibrations read across
the two packages' stores, the ``cascade`` command against JAX's, a tiny
SigLIP pool (an int8 twin as the cheap stage, f32 as the terminal one)
routed through ``ServingServer(cascade=...)``, an autoscaler replan off a
warm AOT store, and the reference's lint rule JL021 over the port's
cascade package."""

import ast
import asyncio
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from jimm_tpu.lint.rules_ast import check_cascade_thresholds
from jimm_tpu.aot.store import ArtifactStore as JaxStore
from jimm_tpu.serve.cascade import calibrate as jax_calibrate
from jimm_tpu.serve.cascade.cli import main as jax_cascade_main
from jimm_tpu_torch import cli
from jimm_tpu_torch.__main__ import main as port_main
from jimm_tpu_torch.aot.store import ArtifactStore
from jimm_tpu_torch.obs.journal import get_journal, reset_journal
from jimm_tpu_torch.obs.slo import SloEngine, SloObjective
from jimm_tpu_torch.serve import (AdmissionPolicy, BucketTable,
                                  CascadeAutoscaler, CascadeCalibration,
                                  CascadeInfo, CascadeRouter, CascadeStage,
                                  EmbedResult, InferenceEngine, ModelPool,
                                  QosPolicyError, QosScheduler, ScaleTarget,
                                  ServeClient, ServeMetrics, ServingServer,
                                  ThrottledError, build_replica_forwards,
                                  fit_calibration, fit_from_logits,
                                  image_forward, load_calibration,
                                  parse_cascade_headers, plan_topology,
                                  replica_trace_count, save_calibration)
from jimm_tpu_torch.serve.cascade.autoscale import REPLICA_BOUNDS
from jimm_tpu_torch.serve.cascade.calibrate import list_calibrations
from jimm_tpu_torch.serve.qos.policy import TenantRegistry
from jimm_tpu_torch.serve.qos.pool import param_nbytes

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def make_calibration(threshold=0.5, temperature=1.0, **kw):
    kw.setdefault("cheap_model", "q8")
    kw.setdefault("reference_model", "f32")
    kw.setdefault("target_disagreement", 0.01)
    kw.setdefault("measured_disagreement", 0.005)
    kw.setdefault("escalation_fraction", 0.1)
    kw.setdefault("holdout", 100)
    return CascadeCalibration(temperature=temperature, threshold=threshold,
                              **kw)


def synthetic_holdout(n=400, classes=8, noise=0.3, seed=0):
    """Holdout where cheap/reference agreement correlates with margin:
    the reference is argmax of clean logits, the cheap model adds noise."""
    rng = np.random.default_rng(seed)
    clean = rng.normal(size=(n, classes))
    clean[np.arange(n), rng.integers(classes, size=n)] += 3.0
    cheap = clean + rng.normal(scale=noise, size=clean.shape)
    return cheap, clean


# ---------------------------------------------------------------------------
# calibration fitting + persistence
# ---------------------------------------------------------------------------

class TestCalibrationFit:
    def test_fit_meets_disagreement_target_on_holdout(self):
        cheap, ref = synthetic_holdout()
        calib = fit_from_logits(cheap, ref, cheap_model="q8",
                                reference_model="f32",
                                target_disagreement=0.01)
        agree = cheap.argmax(axis=1) == ref.argmax(axis=1)
        conf = np.array([calib.confidence(row) for row in cheap])
        keep = conf >= calib.threshold
        kept = int(keep.sum())
        assert kept > 0  # separable holdout: something is accepted
        # the contract: top-1 disagreement among accepted rows <= target
        assert (~agree[keep]).sum() <= 0.01 * kept + 1e-9
        assert calib.escalation_fraction == pytest.approx(
            1.0 - kept / len(cheap))
        assert 0.0 < calib.escalation_fraction < 1.0
        assert calib.holdout == len(cheap)

    def test_lowest_feasible_threshold_maximizes_acceptance(self):
        # every row agrees -> the whole holdout is feasible -> the fitted
        # threshold accepts everything
        cheap, _ = synthetic_holdout(noise=0.0)
        calib = fit_from_logits(cheap, cheap, cheap_model="a",
                                reference_model="b")
        assert calib.escalation_fraction == 0.0
        assert calib.measured_disagreement == 0.0

    def test_infeasible_holdout_escalates_everything(self):
        cheap, _ = synthetic_holdout(n=50)
        calib = fit_calibration(cheap, np.zeros(50, bool), cheap_model="a",
                                reference_model="b",
                                target_disagreement=0.01)
        assert calib.escalation_fraction == 1.0
        # the fitted threshold sits above every holdout confidence
        assert all(not calib.accepts(row)[0] for row in cheap)

    def test_fit_validation(self):
        with pytest.raises(ValueError, match=r"\(N, C>=2\)"):
            fit_calibration(np.zeros((4, 1)), np.ones(4, bool),
                            cheap_model="a", reference_model="b")
        with pytest.raises(ValueError, match="logit rows"):
            fit_calibration(np.zeros((4, 3)), np.ones(5, bool),
                            cheap_model="a", reference_model="b")
        with pytest.raises(ValueError, match="target_disagreement"):
            fit_calibration(np.zeros((4, 3)), np.ones(4, bool),
                            cheap_model="a", reference_model="b",
                            target_disagreement=0.0)
        with pytest.raises(ValueError, match="shapes differ"):
            fit_from_logits(np.zeros((4, 3)), np.zeros((4, 2)),
                            cheap_model="a", reference_model="b")

    def test_confidence_is_temperature_scaled_margin(self):
        calib = make_calibration(temperature=1.0)
        assert calib.confidence([0.0, 0.0, 0.0]) == pytest.approx(0.0)
        assert calib.confidence([20.0, 0.0, 0.0]) == pytest.approx(
            1.0, abs=1e-6)
        # hotter temperature flattens the same logits
        hot = make_calibration(temperature=10.0)
        assert hot.confidence([5.0, 0.0]) < calib.confidence([5.0, 0.0])
        accept, conf = calib.accepts([20.0, 0.0, 0.0])
        assert accept and conf > 0.99
        accept, conf = calib.accepts([0.0, 0.0, 0.0])
        assert not accept and conf == pytest.approx(0.0)


class TestCalibrationWire:
    def test_roundtrip_and_fingerprint_stability(self):
        calib = make_calibration()
        again = CascadeCalibration.from_dict(calib.to_dict())
        assert again == calib
        assert again.fingerprint == calib.fingerprint
        # content addressing: any field change moves the fingerprint
        other = make_calibration(threshold=0.6)
        assert other.fingerprint != calib.fingerprint

    def test_from_dict_rejects_bad_wire_data(self):
        good = make_calibration().to_dict()
        with pytest.raises(ValueError, match="version"):
            CascadeCalibration.from_dict(dict(good, version=99))
        with pytest.raises(ValueError, match="unknown"):
            CascadeCalibration.from_dict(dict(good, extra=1))
        bad = dict(good)
        del bad["threshold"]
        with pytest.raises(ValueError, match="missing"):
            CascadeCalibration.from_dict(bad)

    def test_store_roundtrip_is_content_addressed(self, tmp_path):
        store = ArtifactStore(tmp_path / "store")
        calib = make_calibration()
        fp = save_calibration(store, calib)
        assert fp == calib.fingerprint
        assert load_calibration(store, fp) == calib
        # idempotent: saving again lands on the same entry
        assert save_calibration(store, calib) == fp
        rows = list_calibrations(store)
        assert len(rows) == 1
        assert rows[0]["fingerprint"] == fp
        assert rows[0]["label"] == "cascade:q8->f32"

    def test_load_fails_loudly(self, tmp_path):
        store = ArtifactStore(tmp_path / "store")
        with pytest.raises(ValueError, match="no calibration"):
            load_calibration(store, "deadbeef")
        # a mis-addressed entry (payload hash != fingerprint) is corrupt
        store.put("deadbeef", b"{}", meta={"kind": "cascade_calibration"})
        with pytest.raises(ValueError, match="content-"):
            load_calibration(store, "deadbeef")

    def test_list_skips_foreign_artifacts(self, tmp_path):
        store = ArtifactStore(tmp_path / "store")
        store.put("aot-entry", b"xx", meta={"kind": "aot_executable"})
        assert list_calibrations(store) == []


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

class _ScriptedEngine:
    """Engine stub: returns fixed logits, records how it was called."""

    def __init__(self, out, metrics):
        self.out = np.asarray(out, np.float32)
        self.metrics = metrics
        self.calls = []

    async def submit(self, item, timeout_s=None, trace_id=None, tenant=None,
                     escalated=False):
        self.calls.append({"escalated": escalated, "tenant": tenant,
                           "trace_id": trace_id})
        return self.out


CONFIDENT = [20.0, 0.0, 0.0]
AMBIGUOUS = [0.0, 0.0, 0.0]


def two_stage_router(cheap_out, metrics=None, **kw):
    metrics = metrics or ServeMetrics()
    cheap = _ScriptedEngine(cheap_out, metrics)
    wide = _ScriptedEngine([1.0, 2.0, 3.0], metrics)
    router = CascadeRouter(
        [CascadeStage("q8", cheap, make_calibration()),
         CascadeStage("f32", wide)], metrics=metrics, **kw)
    return router, cheap, wide


class TestRouter:
    def test_confident_request_stays_on_cheap_stage(self):
        router, cheap, wide = two_stage_router(CONFIDENT)
        result = asyncio.run(router.submit(np.zeros(3), tenant="vip"))
        assert result.model == "q8"
        assert result.models_tried == ("q8",)
        assert result.escalations == 0
        assert result.confidence > 0.99
        assert np.allclose(result.output, CONFIDENT)
        assert cheap.calls[0]["escalated"] is False
        assert wide.calls == []
        assert router.metrics.count("cascade_q8_accepted_total") == 1
        assert router.escalation_rate == 0.0

    def test_doubtful_request_escalates_once_billed_once(self):
        router, cheap, wide = two_stage_router(AMBIGUOUS)
        result = asyncio.run(router.submit(np.zeros(3), tenant="vip"))
        assert result.model == "f32"
        assert result.models_tried == ("q8", "f32")
        assert result.escalations == 1
        assert result.confidence is None  # terminal accepts by fiat
        # the first hop is a normal admission, the escalation is not
        assert cheap.calls[0]["escalated"] is False
        assert wide.calls[0]["escalated"] is True
        # both hops ride one trace id
        assert wide.calls[0]["trace_id"] == cheap.calls[0]["trace_id"]
        assert router.metrics.count("cascade_escalations_total") == 1
        assert router.escalation_rate == 1.0

    def test_headers_roundtrip_to_client_info(self):
        router, _, _ = two_stage_router(AMBIGUOUS)
        result = asyncio.run(router.submit(np.zeros(3)))
        info = parse_cascade_headers(result.headers())
        assert info == CascadeInfo(models_tried=("q8", "f32"), model="f32",
                                   confidence=None)
        router2, _, _ = two_stage_router(CONFIDENT)
        result2 = asyncio.run(router2.submit(np.zeros(3)))
        info2 = parse_cascade_headers(result2.headers())
        assert info2.model == "q8"
        assert info2.escalations == 0
        assert info2.confidence == pytest.approx(result2.confidence,
                                                 abs=1e-6)

    def test_whole_path_journaled_on_one_cid(self):
        reset_journal()
        try:
            router, _, _ = two_stage_router(AMBIGUOUS)
            result = asyncio.run(router.submit(np.zeros(3), tenant="vip"))
            chain = get_journal().chain(result.cid)
            assert [e["event"] for e in chain] == [
                "cascade_request", "cascade_escalated", "cascade_routed"]
            hop = chain[1]
            assert hop["stage_from"] == "q8" and hop["stage_to"] == "f32"
            assert chain[2]["model"] == "f32"
            assert chain[2]["escalations"] == 1
        finally:
            reset_journal()

    def test_agreement_crosscheck_overrides_confident_accept(self):
        reset_journal()
        try:
            router, cheap, wide = two_stage_router(
                CONFIDENT, agreement_fn=lambda out: 0.1,
                agreement_floor=0.5)
            result = asyncio.run(router.submit(np.zeros(3)))
            # the margin said accept; the neighbor cross-check vetoed it
            assert result.model == "f32"
            assert wide.calls[0]["escalated"] is True
            events = [e["event"] for e in get_journal().chain(result.cid)]
            assert "cascade_crosscheck_failed" in events
        finally:
            reset_journal()

    def test_constructor_validation(self):
        metrics = ServeMetrics()
        eng = _ScriptedEngine(CONFIDENT, metrics)
        with pytest.raises(ValueError, match="at least one stage"):
            CascadeRouter([], metrics=metrics)
        with pytest.raises(ValueError, match="duplicate"):
            CascadeRouter([CascadeStage("a", eng, make_calibration()),
                           CascadeStage("a", eng)], metrics=metrics)
        with pytest.raises(ValueError, match="no calibration"):
            CascadeRouter([CascadeStage("a", eng),
                           CascadeStage("b", eng)], metrics=metrics)
        with pytest.raises(ValueError, match="together"):
            CascadeRouter([CascadeStage("a", eng)], metrics=metrics,
                          agreement_fn=lambda out: 1.0)

    def test_from_pool_builds_ladder_from_policy_order(self):
        metrics = ServeMetrics()
        engines = {"q8": InferenceEngine(lambda b: b, item_shape=(3,),
                                         buckets=BucketTable((1,)),
                                         metrics=metrics),
                   "f32": InferenceEngine(lambda b: b, item_shape=(3,),
                                          buckets=BucketTable((1,)),
                                          metrics=metrics)}
        pool = ModelPool(engines, default="f32")
        calib = make_calibration()
        router = CascadeRouter.from_pool(pool, ["q8", "f32"],
                                         {"q8": calib})
        assert [s.name for s in router.stages] == ["q8", "f32"]
        assert router.stages[0].calibration is calib
        assert router.metrics is metrics
        with pytest.raises(ValueError, match="no calibration"):
            CascadeRouter.from_pool(pool, ["q8", "f32"], {})

    def test_describe_carries_calibration_provenance(self):
        router, _, _ = two_stage_router(AMBIGUOUS)
        asyncio.run(router.submit(np.zeros(3)))
        desc = router.describe()
        assert desc["requests"] == 1 and desc["escalations"] == 1
        assert desc["stages"][0]["model"] == "q8"
        calib = router.stages[0].calibration
        assert desc["stages"][0]["calibration"]["fingerprint"] == \
            calib.fingerprint
        assert "calibration" not in desc["stages"][1]
        assert desc["crosscheck"] is False


# ---------------------------------------------------------------------------
# escalated submits bypass double billing on the real engine
# ---------------------------------------------------------------------------

class TestEscalatedBilling:
    def test_escalated_submit_skips_request_count_and_tokens(self):
        async def go():
            registry = TenantRegistry.from_dict({
                "classes": {"interactive": {"weight": 1}},
                "tenants": {"slow": {"class": "interactive", "rate": 0.01,
                                     "burst": 1}},
                "default": {"class": "interactive"},
            })
            engine = InferenceEngine(
                lambda b: b * 2.0, item_shape=(3,),
                buckets=BucketTable((1, 2)), max_delay_ms=1.0,
                policy=AdmissionPolicy(max_queue=8, default_timeout_s=5.0),
                qos=QosScheduler(registry))
            await engine.start()
            item = np.ones(3, np.float32)
            try:
                await engine.submit(item, tenant="slow")  # burns the token
                # a second NORMAL submit is throttled...
                with pytest.raises(ThrottledError):
                    await engine.submit(item, tenant="slow")
                # ...but the cascade's re-submit is not re-billed
                out = await engine.submit(item, tenant="slow",
                                          escalated=True)
            finally:
                await engine.stop()
            return out, engine.metrics

        out, metrics = asyncio.run(go())
        assert np.allclose(out, 2.0)
        # requests_total counts arrivals (including the throttled one);
        # the escalation hop is billed on its own counter, not here
        assert metrics.count("requests_total") == 2
        assert metrics.count("escalated_submits_total") == 1


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------

class _FakeSlo:
    """SloEngine stand-in with dial-a-burn rates."""

    fast_window_s = 60.0
    slow_window_s = 600.0

    def __init__(self, fast=0.0, slow=0.0):
        self.objectives = {"t": SloObjective(0.99)}
        self.fast = fast
        self.slow = slow
        self.listeners = []

    def burn_rate(self, name, window_s):
        return self.fast if window_s == self.fast_window_s else self.slow

    def add_listener(self, fn):
        self.listeners.append(fn)


class _FakeScheduler:
    def __init__(self):
        self.queued = 0

    def snapshot(self):
        return {"tenants": {
            "vip": {"class": "interactive", "queued": self.queued},
            "bulk": {"class": "batch", "queued": 99},  # never counted
        }}


class _ReplanEngine:
    def __init__(self):
        self.replans = []
        self.stopped = False

    async def replan(self, built, trace_count=None, cid=None):
        self.replans.append({"built": built, "trace_count": trace_count,
                             "cid": cid})

    async def stop(self):
        self.stopped = True


class _FakePool:
    def __init__(self):
        self.swaps = []

    def swap(self, name, engine):
        self.swaps.append((name, engine))
        return _ReplanEngine()


def make_autoscaler(cheap_replicas=3, expensive_replicas=1, **kw):
    cheap = ScaleTarget(name="q8", engine=_ReplanEngine(),
                        build_forwards=lambda n: [object()] * n,
                        replicas=cheap_replicas,
                        promote=kw.pop("promote", None),
                        demote=kw.pop("demote", None))
    expensive = ScaleTarget(name="f32", engine=_ReplanEngine(),
                            build_forwards=lambda n: ([object()] * n, n),
                            replicas=expensive_replicas)
    slo = kw.pop("slo", _FakeSlo())
    sched = kw.pop("scheduler", _FakeScheduler())
    kw.setdefault("window", 3)
    kw.setdefault("cooldown", 2)
    auto = CascadeAutoscaler(cheap=cheap, expensive=expensive, slo=slo,
                             scheduler=sched, **kw)
    return auto, slo, sched


class TestAutoscaler:
    def test_needs_full_window_then_shifts_under_pressure(self):
        auto, slo, _ = make_autoscaler(burn_high=1.0)
        slo.fast = 5.0
        assert auto.tick() is None  # 1 sample < window
        assert auto.tick() is None  # 2 samples
        decision = auto.tick()
        assert decision["action"] == "shift_replica"
        assert decision["from"] == "q8" and decision["to"] == "f32"
        assert decision["replicas"] == {"q8": 2, "f32": 2}
        assert decision["window"]["fast_burn"] == pytest.approx(5.0)

    def test_queue_depth_of_watched_class_also_trips(self):
        auto, _, sched = make_autoscaler(queue_high=8.0)
        sched.queued = 20  # interactive backlog; batch's 99 is ignored
        for _ in range(2):
            assert auto.tick() is None
        decision = auto.tick()
        assert decision["action"] == "shift_replica"
        assert decision["window"]["queue_depth"] == pytest.approx(20.0)

    def test_cooldown_spaces_decisions(self):
        auto, slo, _ = make_autoscaler(cooldown=2)
        slo.fast = 5.0
        ticks = [auto.tick() for _ in range(8)]
        decided = [i for i, d in enumerate(ticks) if d is not None]
        # first decision once the window fills, then every cooldown+1
        assert decided == [2, 5]

    def test_dead_band_between_pressure_and_calm(self):
        auto, slo, _ = make_autoscaler(burn_high=1.0, queue_high=8.0)
        slo.fast = 0.5  # above burn_low 0.25, below burn_high 1.0
        assert all(auto.tick() is None for _ in range(10))
        assert auto.decisions == []

    def test_calm_shifts_capacity_back(self):
        auto, slo, _ = make_autoscaler(cheap_replicas=2,
                                       expensive_replicas=2)
        decision = None
        for _ in range(3):
            decision = auto.tick()
        assert decision["action"] == "shift_replica"
        assert decision["from"] == "f32" and decision["to"] == "q8"

    def test_bounds_stop_shifting_then_dtype_promotes(self):
        pool = _FakePool()
        auto, slo, _ = make_autoscaler(
            cheap_replicas=1,  # already at min: no replica to give
            promote=lambda: _ReplanEngine(), pool=pool)
        slo.fast = 5.0
        for _ in range(2):
            auto.tick()
        decision = auto.tick()
        assert decision["action"] == "swap_model"
        assert decision["model"] == "q8" and decision["promoted"] is True
        asyncio.run(auto.apply(decision))
        assert [name for name, _ in pool.swaps] == ["q8"]
        assert auto._dtype_promoted is True
        # once promoted, sustained pressure has no further move
        for _ in range(6):
            assert auto.tick() is None

    def test_calm_demotes_before_shifting(self):
        pool = _FakePool()
        auto, slo, _ = make_autoscaler(
            cheap_replicas=1, promote=lambda: _ReplanEngine(),
            demote=lambda: _ReplanEngine(), pool=pool, cooldown=0)
        slo.fast = 5.0
        for _ in range(3):
            auto.tick()
        asyncio.run(auto.apply(auto.decisions[-1]))  # promoted swap
        slo.fast = 0.0
        decision = None
        while decision is None:
            decision = auto.tick()
        assert decision["action"] == "swap_model"
        assert decision["promoted"] is False

    def test_apply_shift_replans_both_engines_on_root_cid(self):
        auto, slo, _ = make_autoscaler()
        slo.fast = 5.0
        for _ in range(2):
            auto.tick()
        decision = auto.tick()
        asyncio.run(auto.apply(decision))
        assert auto.cheap.replicas == 2 and auto.expensive.replicas == 2
        assert len(auto.cheap.engine.replans) == 1
        assert len(auto.expensive.engine.replans) == 1
        # expensive's build_forwards returns (forwards, trace_count)
        assert auto.expensive.engine.replans[0]["trace_count"] == 2
        assert auto.cheap.engine.replans[0]["cid"] == auto.cid

    def test_decisions_journaled_on_one_cid(self):
        reset_journal()
        try:
            auto, slo, _ = make_autoscaler()
            slo.fast = 5.0
            for _ in range(2):
                auto.tick()
            asyncio.run(auto.step())
            events = [e["event"] for e in get_journal().chain(auto.cid)]
            assert events == ["autoscale_decision", "autoscale_applied"]
        finally:
            reset_journal()

    def test_burn_transition_resets_cooldown_via_real_slo(self):
        reset_journal()
        try:
            clock = {"t": 1000.0}
            slo = SloEngine({"t": SloObjective(0.5)},
                            fast_window_s=60, slow_window_s=600,
                            fast_burn_threshold=1.5,
                            clock=lambda: clock["t"])
            auto, _, _ = make_autoscaler(slo=slo, cooldown=3)
            auto.watch_slo()
            auto._since_decision = 0  # mid-cooldown
            slo.observe("t", False)  # enter fast burn -> listener fires
            assert auto._since_decision == auto.cooldown
            events = [e["event"] for e in get_journal().chain(auto.cid)]
            assert events == ["autoscale_burn_transition"]
        finally:
            reset_journal()

    def test_validation_and_bounds(self):
        with pytest.raises(ValueError, match="window"):
            make_autoscaler(window=0)
        with pytest.raises(ValueError, match="positive"):
            make_autoscaler(burn_high=0.0)
        with pytest.raises(ValueError, match="outside"):
            ScaleTarget(name="x", engine=None,
                        build_forwards=lambda n: [], replicas=9,
                        max_replicas=8)
        # max_replicas clamps into the hard bounds
        t = ScaleTarget(name="x", engine=None,
                        build_forwards=lambda n: [], replicas=4,
                        max_replicas=10_000)
        assert t.max_replicas == REPLICA_BOUNDS[1]

    def test_describe_shape(self):
        auto, _, _ = make_autoscaler()
        desc = auto.describe()
        assert desc["replicas"] == {"q8": 3, "f32": 1}
        assert desc["dtype_promoted"] is False
        assert desc["decisions"] == 0 and desc["last_decision"] is None
        assert desc["cid"] == auto.cid


# ---------------------------------------------------------------------------
# policy-file cascade/autoscale sections
# ---------------------------------------------------------------------------

CASCADE_POLICY = {
    "classes": {"interactive": {"weight": 8}, "batch": {"weight": 2}},
    "tenants": {"vip": {"class": "interactive"}},
    "default": {"class": "batch"},
    "cascade": {"order": ["q8", "f32"],
                "calibrations": {"q8": "abc123"},
                "agreement_floor": 0.8},
    "autoscale": {"watch_class": "interactive", "burn_high": 2.0,
                  "queue_high": 16, "window": 5, "cooldown": 3},
}


class TestPolicySections:
    def test_valid_sections_parse(self):
        reg = TenantRegistry.from_dict(CASCADE_POLICY)
        assert reg.cascade["order"] == ["q8", "f32"]
        assert reg.cascade["calibrations"] == {"q8": "abc123"}
        assert reg.cascade["agreement_floor"] == pytest.approx(0.8)
        assert reg.autoscale["watch_class"] == "interactive"
        assert reg.autoscale["burn_high"] == pytest.approx(2.0)
        desc = reg.describe()
        assert desc["cascade"]["order"] == ["q8", "f32"]
        assert desc["autoscale"]["window"] == 5

    def test_sections_are_optional(self):
        reg = TenantRegistry.from_dict({
            "classes": {"interactive": {"weight": 1}},
            "default": {"class": "interactive"}})
        assert reg.cascade is None and reg.autoscale is None
        assert "cascade" not in reg.describe()

    @pytest.mark.parametrize("patch,match", [
        ({"cascade": {"order": ["solo"], "calibrations": {}}},
         ">= 2 distinct"),
        ({"cascade": {"order": ["a", "a"], "calibrations": {"a": "x"}}},
         "distinct"),
        ({"cascade": {"order": ["a", "b"], "calibrations": {}}},
         "calibration"),
        ({"cascade": {"order": ["a", "b"],
                      "calibrations": {"a": "x", "b": "y"}}},
         "non-terminal"),
        ({"cascade": {"order": ["a", "b"], "calibrations": {"a": "x"},
                      "agreement_floor": 1.5}}, "agreement_floor"),
        ({"autoscale": {"watch_class": "nope", "burn_high": 1,
                        "queue_high": 1, "window": 3, "cooldown": 1}},
         "watch_class"),
        ({"autoscale": {"watch_class": "interactive", "burn_high": -1,
                        "queue_high": 1, "window": 3, "cooldown": 1}},
         "burn_high"),
        ({"autoscale": {"watch_class": "interactive", "burn_high": 1,
                        "queue_high": 1, "window": True, "cooldown": 1}},
         "window"),
    ])
    def test_bad_sections_rejected(self, patch, match):
        data = {k: v for k, v in CASCADE_POLICY.items()
                if k not in ("cascade", "autoscale")}
        data.update(patch)
        with pytest.raises(QosPolicyError, match=match):
            TenantRegistry.from_dict(data)


# ---------------------------------------------------------------------------
# pool resident-byte accounting
# ---------------------------------------------------------------------------

class TestResidentBytes:
    def test_param_nbytes_duck_typed(self):
        tree = {"a": np.zeros((2, 3), np.float32),
                "b": [np.zeros(4, np.int8), np.zeros(2, np.float16)],
                "c": "not-an-array"}
        assert param_nbytes(tree) == 2 * 3 * 4 + 4 * 1 + 2 * 2

        # a module's parameters (the port's models are torch modules)
        assert param_nbytes(torch.nn.Linear(10, 1, bias=False)) == 40

    def _engine(self, metrics, nbytes=None):
        eng = InferenceEngine(lambda b: b, item_shape=(3,),
                              buckets=BucketTable((1,)), metrics=metrics)
        if nbytes is not None:
            eng.resident_param_bytes = nbytes
        return eng

    def test_pool_accounts_and_gauges_track_swaps(self):
        metrics = ServeMetrics()
        pool = ModelPool({"f32": self._engine(metrics, 400),
                          "q8": self._engine(metrics, 100)}, default="f32")
        assert pool.resident_bytes() == {"f32": 400, "q8": 100}
        snap = metrics.snapshot()
        assert snap["pool_resident_bytes"] == 500.0
        assert snap["pool_resident_bytes_q8"] == 100.0
        desc = pool.describe()
        assert desc["f32"]["resident_param_bytes"] == 400
        # swap to a wider twin: the existing gauges see the new bytes
        pool.swap("q8", self._engine(metrics, 200))
        assert metrics.snapshot()["pool_resident_bytes_q8"] == 200.0
        # operator override for engines built without a stamp
        pool.set_resident_bytes("q8", 150)
        assert metrics.snapshot()["pool_resident_bytes"] == 550.0
        with pytest.raises(ValueError, match="not resident"):
            pool.set_resident_bytes("nope", 1)

    def test_remove_drops_accounting(self):
        metrics = ServeMetrics()
        pool = ModelPool({"f32": self._engine(metrics, 400)}, default="f32")
        pool.add("canary", self._engine(metrics, 50))
        assert metrics.snapshot()["pool_resident_bytes"] == 450.0
        pool.remove("canary")
        assert pool.resident_bytes() == {"f32": 400}
        assert metrics.snapshot()["pool_resident_bytes"] == 400.0


# ---------------------------------------------------------------------------
# client-side header parsing
# ---------------------------------------------------------------------------

class TestClientParsing:
    def test_parse_mapping_and_iterable_case_insensitive(self):
        headers = {"X-Jimm-Cascade-Models": "q8,f32",
                   "x-jimm-cascade-model": "f32",
                   "X-JIMM-CASCADE-CONFIDENCE": "0.125000"}
        info = parse_cascade_headers(headers)
        assert info.models_tried == ("q8", "f32")
        assert info.model == "f32"
        assert info.confidence == pytest.approx(0.125)
        assert info.escalations == 1
        # http.client getheaders() shape: list of (name, value)
        assert parse_cascade_headers(list(headers.items())) == info

    def test_non_cascade_response_parses_to_none(self):
        assert parse_cascade_headers({}) is None
        assert parse_cascade_headers(
            {"Content-Type": "application/json"}) is None

    def test_degenerate_values(self):
        info = parse_cascade_headers({"X-Jimm-Cascade-Model": "q8",
                                      "X-Jimm-Cascade-Confidence": "nan?"})
        assert info.models_tried == ("q8",)  # falls back to the final model
        assert info.confidence is None

    def test_embed_result_is_still_a_list(self):
        res = EmbedResult([1.0, 2.0], cascade=None, trace_id="tid")
        assert list(res) == [1.0, 2.0]
        assert res[1] == 2.0
        assert res.cascade is None and res.trace_id == "tid"


# ---------------------------------------------------------------------------
# HTTP end to end: cascade headers + healthz blocks
# ---------------------------------------------------------------------------

@pytest.fixture()
def cascade_server():
    metrics = ServeMetrics()

    def spread(b):
        # per-row score rows whose margin tracks the input's first entry
        out = np.zeros((b.shape[0], 3), np.float32)
        out[:, 0] = b[:, 0] * 4.0
        return out

    cheap = InferenceEngine(spread, item_shape=(3,),
                            buckets=BucketTable((1, 2)), max_delay_ms=1.0,
                            metrics=metrics)
    wide = InferenceEngine(lambda b: b * 3.0, item_shape=(3,),
                           buckets=BucketTable((1, 2)), max_delay_ms=1.0,
                           metrics=metrics)
    pool = ModelPool({"q8": cheap, "f32": wide}, default="f32")
    router = CascadeRouter.from_pool(pool, ["q8", "f32"],
                                     {"q8": make_calibration()})
    auto, _, _ = make_autoscaler()
    server = ServingServer(wide, pool=pool, cascade=router, autoscaler=auto,
                           port=0)
    server.start()
    try:
        yield server
    finally:
        server.stop()


class TestHttpCascade:
    def test_confident_request_served_by_cheap_model(self, cascade_server):
        client = ServeClient(port=cascade_server.port)
        res = client.embed(np.full(3, 5.0, np.float32), timeout_s=5)
        assert isinstance(res, EmbedResult)
        assert res.cascade is not None
        assert res.cascade.model == "q8"
        assert res.cascade.escalations == 0
        assert res.cascade.confidence > 0.99
        assert np.asarray(res).shape == (3,)

    def test_doubtful_request_escalates_to_wide_model(self, cascade_server):
        client = ServeClient(port=cascade_server.port)
        res = client.embed(np.zeros(3, np.float32), timeout_s=5)
        assert res.cascade.models_tried == ("q8", "f32")
        assert res.cascade.model == "f32"
        assert res.cascade.confidence is None
        assert np.allclose(res, 0.0)

    def test_explicit_model_bypasses_cascade(self, cascade_server):
        client = ServeClient(port=cascade_server.port, model="f32")
        res = client.embed(np.full(3, 5.0, np.float32), timeout_s=5)
        assert res.cascade is None
        assert np.allclose(res, 15.0)

    def test_healthz_carries_cascade_and_autoscale_blocks(
            self, cascade_server):
        health = ServeClient(port=cascade_server.port).healthz()
        assert [s["model"] for s in health["cascade"]["stages"]] == \
            ["q8", "f32"]
        assert "fingerprint" in health["cascade"]["stages"][0]["calibration"]
        assert health["autoscale"]["replicas"] == {"q8": 3, "f32": 1}
        assert health["models"]["q8"]["resident_param_bytes"] == 0


# ---------------------------------------------------------------------------
# the fit and the stores against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,noise,target", [
    (0, 0.3, 0.01), (1, 0.6, 0.05), (2, 1.0, 0.02), (3, 0.1, 0.01)])
def test_fit_is_jax_bit_for_bit(seed, noise, target):
    cheap, ref = synthetic_holdout(n=300, noise=noise, seed=seed)
    kw = dict(cheap_model="q8", reference_model="f32",
              target_disagreement=target)
    ours = fit_from_logits(cheap, ref, **kw)
    theirs = jax_calibrate.fit_from_logits(cheap, ref, **kw)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.payload() == theirs.payload()
    assert ours.fingerprint == theirs.fingerprint
    rows = [ours.accepts(r) for r in cheap]
    assert rows == [theirs.accepts(r) for r in cheap]


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_calibrations_cross_the_two_stores(tmp_path, direction):
    cheap, ref = synthetic_holdout(seed=5)
    kw = dict(cheap_model="q8", reference_model="f32")
    if direction == "jax-to-port":
        calib = jax_calibrate.fit_from_logits(cheap, ref, **kw)
        fp = jax_calibrate.save_calibration(JaxStore(tmp_path), calib)
        store, load, ls = ArtifactStore(tmp_path), load_calibration, \
            list_calibrations
    else:
        calib = fit_from_logits(cheap, ref, **kw)
        fp = save_calibration(ArtifactStore(tmp_path), calib)
        store, load, ls = JaxStore(tmp_path), \
            jax_calibrate.load_calibration, jax_calibrate.list_calibrations
    assert load(store, fp).to_dict() == calib.to_dict()
    [row] = ls(store)
    assert row["fingerprint"] == fp and row["label"] == "cascade:q8->f32"


def _holdout_file(tmp_path, seed=0) -> str:
    cheap, ref = synthetic_holdout(n=200, seed=seed)
    path = tmp_path / "holdout.npz"
    np.savez(path, cheap=cheap, reference=ref)
    return str(path)


def test_cascade_commands_print_what_jax_prints(tmp_path, capsys):
    holdout = _holdout_file(tmp_path)
    args = ["calibrate", holdout, "--cheap-model", "q8", "--reference-model",
            "f32", "--target-disagreement", "0.02"]
    outputs = []
    for main, store in ((port_main, "port"), (jax_cascade_main, "jax")):
        root = str(tmp_path / store)
        assert main(["cascade", *args, "--store", root, "--json"]) == 0
        calibrated = capsys.readouterr().out
        assert main(["cascade", *args, "--store", root]) == 0
        text = capsys.readouterr().out
        assert main(["cascade", "ls", "--store", root]) == 0
        listed = capsys.readouterr().out
        outputs.append((calibrated, text, listed))
    assert outputs[0] == outputs[1]
    assert json.loads(outputs[0][0])["holdout"] == 200
    # each reads the other's store
    assert port_main(["cascade", "ls", "--store",
                      str(tmp_path / "jax")]) == 0
    assert capsys.readouterr().out == outputs[0][2]


def test_calibrate_refuses_a_bad_holdout(tmp_path, capsys):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"cheap": [[1.0, 0.0]]}))
    assert port_main(["cascade", "calibrate", str(path), "--cheap-model",
                      "a", "--reference-model", "b", "--store",
                      str(tmp_path / "s")]) == 1
    assert "holdout missing ['reference']" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the reference's lint rule JL021 over the port's cascade package
# ---------------------------------------------------------------------------

CASCADE_FILES = sorted((REPO / "jimm_tpu_torch" / "serve" /
                        "cascade").glob("*.py"))


@pytest.mark.parametrize("path", CASCADE_FILES, ids=lambda p: p.name)
def test_no_hardcoded_threshold_in_the_cascade(path):
    rel = str(path.relative_to(REPO))
    assert check_cascade_thresholds(ast.parse(path.read_text()), rel) == []


def test_the_rule_sees_the_port_s_cascade_package():
    router = REPO / "jimm_tpu_torch" / "serve" / "cascade" / "router.py"
    tree = ast.parse(router.read_text() + "\nescalation_threshold = 0.92\n")
    [finding] = check_cascade_thresholds(tree, str(router.relative_to(REPO)))
    assert finding.rule == "JL021"


# ---------------------------------------------------------------------------
# a tiny SigLIP pool: the int8 twin as the cheap stage, f32 as the terminal
# ---------------------------------------------------------------------------

ITEM = (32, 32, 3)


def _tiny(dtype):
    cfg = cli.with_runtime(cli.tiny_override(cli.preset(
        "siglip-base-patch16-256")), ln_impl="fused", attn_impl="flash")
    return cli.serving_model(cfg, dtype, CPU,
                             generator=torch.Generator().manual_seed(0))[0]


@pytest.fixture(scope="module")
def siglip_pool():
    """The f32 SigLIP and its int8 twin (the same seeded weights), a fixed
    projection of the embedding onto 8 class scores, and a calibration fit
    on a seeded holdout of 64 images."""
    models = {"f32": _tiny("f32"), "q8": _tiny("int8")}
    proj = np.random.default_rng(7).standard_normal(
        (models["f32"].config.projection_dim, 8)).astype(np.float32)

    def score(out):
        return np.asarray(out, np.float32) @ proj

    holdout = np.random.default_rng(3).standard_normal(
        (64, *ITEM)).astype(np.float32)
    rows = {name: score(image_forward(m, "encode_image")(holdout).numpy())
            for name, m in models.items()}
    calib = fit_from_logits(rows["q8"], rows["f32"], cheap_model="q8",
                            reference_model="f32", target_disagreement=0.01)
    return {"models": models, "score": score, "calib": calib,
            "holdout": holdout}


def test_a_tiny_siglip_pool_routes_through_the_server(siglip_pool):
    models, calib = siglip_pool["models"], siglip_pool["calib"]
    assert 0.0 < calib.escalation_fraction < 1.0
    metrics = ServeMetrics()
    engines = {name: InferenceEngine(image_forward(m, "encode_image"),
                                     item_shape=ITEM,
                                     buckets=BucketTable((1,)),
                                     max_delay_ms=1.0, metrics=metrics)
               for name, m in models.items()}
    pool = ModelPool(engines, default="f32")
    router = CascadeRouter.from_pool(pool, ["q8", "f32"], {"q8": calib},
                                     score_fn=siglip_pool["score"])
    server = ServingServer(engines["f32"], pool=pool, cascade=router, port=0)
    server.start()
    try:
        client = ServeClient(port=server.port)
        seen = set()
        for image in siglip_pool["holdout"][:16]:
            res = client.embed(image, timeout_s=10)
            assert isinstance(res.cascade, CascadeInfo)
            stage = res.cascade.model
            seen.add(stage)
            want = image_forward(models[stage], "encode_image")(
                image[None]).numpy()[0]
            np.testing.assert_allclose(np.asarray(res), want, rtol=1e-6,
                                       atol=1e-6)
            cheap = siglip_pool["score"](image_forward(
                models["q8"], "encode_image")(image[None]).numpy()[0])
            accept, conf = calib.accepts(cheap)
            assert (stage == "q8") == accept
            assert res.cascade.models_tried == (
                ("q8",) if accept else ("q8", "f32"))
            if accept:
                assert res.cascade.confidence == pytest.approx(conf,
                                                               abs=1e-6)
        assert seen == {"q8", "f32"}
        health = client.healthz()
        assert health["cascade"]["requests"] == 16
        assert health["cascade"]["stages"][0]["calibration"][
            "fingerprint"] == calib.fingerprint
    finally:
        server.stop()


def test_an_autoscaler_tick_replans_off_a_warm_store(siglip_pool,
                                                     tmp_path):
    """Under forced burn one tick shifts a replica from the cheap stage to
    the terminal one; both replans load every bucket from the store (no
    fresh export, compile_count still 0)."""
    store = ArtifactStore(tmp_path / "warm")
    models = siglip_pool["models"]

    def build(name):
        def forwards(n):
            built = build_replica_forwards(
                models[name], plan_topology(n, devices=[CPU] * n),
                method="encode_image", store=store, label=name)
            return built, replica_trace_count(built)
        return forwards

    builds = {"q8": build("q8"), "f32": build("f32")}
    engines = {}
    for name, n in (("q8", 2), ("f32", 1)):
        forwards, traces = builds[name](n)
        engines[name] = InferenceEngine(
            forwards, item_shape=ITEM, buckets=BucketTable((1, 2)),
            trace_count=traces)
        engines[name].warmup_blocking()  # misses write through
    entries = len(store.entries())
    assert entries == 4  # two models x two buckets, replicas share
    slo = _FakeSlo(fast=5.0)
    auto = CascadeAutoscaler(
        cheap=ScaleTarget("q8", engines["q8"], builds["q8"], replicas=2),
        expensive=ScaleTarget("f32", engines["f32"], builds["f32"],
                              replicas=1),
        slo=slo, window=1, cooldown=0)
    decision = auto.tick()
    assert decision["action"] == "shift_replica"
    assert decision["replicas"] == {"q8": 1, "f32": 2}
    asyncio.run(auto.apply(decision))
    assert engines["q8"].n_replicas == 1 and engines["f32"].n_replicas == 2
    for engine in engines.values():
        assert engine.metrics.snapshot()["compile_count"] == 0
        assert all(f.trace_count() == 0 for f in engine.forwards)
        assert {f._forward.sources[b] for f in engine.forwards
                for b in (1, 2)} == {"aot"}
    assert len(store.entries()) == entries
