"""Cascade router: hit the cheapest resident model, escalate on doubt; the
counterpart of ``jimm_tpu/serve/cascade/router.py``.

A :class:`CascadeRouter` fronts an ordered list of pool engines -- cheapest
dtype first (int8/fp8 twin), widest last -- and routes each request through
them as a confidence cascade:

1. Submit to the cheapest stage's engine (normal admission: the request
   counter and the tenant's token bucket are charged exactly once, here).
2. Score the output through the stage's **calibrated** confidence signal
   (:class:`~jimm_tpu_torch.serve.cascade.calibrate.CascadeCalibration` --
   temperature-scaled logit margin; thresholds come from content-addressed
   store artifacts, never from code: the reference's lint JL021).
3. Accept, or escalate to the next stage via ``engine.submit(...,
   escalated=True)`` -- the re-submit bypasses admission double-billing but
   still honors the physical queue bound.

Every hop is journaled on one correlation id (``cascade_request`` ->
``cascade_escalated``* -> ``cascade_routed``) so ``obs timeline`` shows a
request's whole path, and escalations run under a ``cascade_escalate``
span for the latency decomposition. An optional ``agreement_fn`` cross-
checks a confident cheap answer against embedding-neighbor agreement from
the retrieval index (run off-loop; it touches host index structures).
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Callable, Sequence

from jimm_tpu_torch.obs.journal import get_journal, new_correlation_id
from jimm_tpu_torch.obs.spans import new_trace_id, span
from jimm_tpu_torch.serve.admission import ServeMetrics

#: response headers the server attaches and the client parses back
CASCADE_HEADER_MODELS = "X-Jimm-Cascade-Models"
CASCADE_HEADER_MODEL = "X-Jimm-Cascade-Model"
CASCADE_HEADER_CONFIDENCE = "X-Jimm-Cascade-Confidence"


@dataclasses.dataclass(frozen=True)
class CascadeStage:
    """One rung of the ladder: a pool model plus the calibration that
    decides whether its answers are trustworthy. The terminal (widest)
    stage carries ``calibration=None`` -- it always accepts."""

    name: str
    engine: object
    calibration: object = None


@dataclasses.dataclass(frozen=True)
class CascadeResult:
    """What the router hands back: the accepted output plus the routing
    metadata the server exposes as response headers."""

    output: object
    model: str
    models_tried: tuple[str, ...]
    confidence: float | None
    escalations: int
    cid: str
    trace_id: str

    def headers(self) -> dict[str, str]:
        """The cascade response headers (server side; the client parses
        the same names back into :class:`~jimm_tpu_torch.serve.client
        .CascadeInfo`)."""
        out = {CASCADE_HEADER_MODELS: ",".join(self.models_tried),
               CASCADE_HEADER_MODEL: self.model}
        if self.confidence is not None:
            out[CASCADE_HEADER_CONFIDENCE] = f"{self.confidence:.6f}"
        return out


class CascadeRouter:
    """Routes requests through calibrated stages, cheapest first.

    ``score_fn`` maps an engine output row to the score row the
    calibration thresholds (e.g. a fixed zero-shot projection of the
    embedding); identity when omitted. ``agreement_fn`` +
    ``agreement_floor`` optionally cross-check accepted cheap answers
    with embedding-neighbor agreement -- both must be given together, and
    the floor, like every threshold, belongs in operator config or a
    calibration artifact, not code.
    """

    def __init__(self, stages: Sequence[CascadeStage], *,
                 metrics: ServeMetrics | None = None,
                 score_fn: Callable | None = None,
                 agreement_fn: Callable | None = None,
                 agreement_floor: float | None = None):
        stages = list(stages)
        if not stages:
            raise ValueError("cascade needs at least one stage")
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names {names}")
        for s in stages[:-1]:
            if s.calibration is None:
                raise ValueError(
                    f"non-terminal stage {s.name!r} has no calibration; "
                    "only the widest stage may accept unconditionally")
        if (agreement_fn is None) != (agreement_floor is None):
            raise ValueError("agreement_fn and agreement_floor must be "
                             "given together")
        self.stages = stages
        self.metrics = metrics or getattr(stages[0].engine, "metrics",
                                          None) or ServeMetrics()
        self.score_fn = score_fn
        self.agreement_fn = agreement_fn
        self.agreement_floor = agreement_floor
        self.metrics.inc("cascade_requests_total", 0)
        self.metrics.inc("cascade_escalations_total", 0)
        for s in stages:
            self.metrics.inc(f"cascade_{s.name}_accepted_total", 0)
        self.metrics.bind_gauge("cascade_escalation_rate",
                                lambda: round(self.escalation_rate, 4))

    @classmethod
    def from_pool(cls, pool, order: Sequence[str],
                  calibrations: dict, **kwargs) -> "CascadeRouter":
        """Build stages from pool model names, cheapest -> widest.
        ``calibrations`` maps every non-terminal name to its
        :class:`CascadeCalibration`."""
        order = list(order)
        missing = [n for n in order[:-1] if n not in calibrations]
        if missing:
            raise ValueError(f"no calibration for cascade stages {missing}")
        stages = [CascadeStage(name=n, engine=pool.get(n),
                               calibration=calibrations.get(n))
                  for n in order]
        kwargs.setdefault("metrics", pool.metrics)
        return cls(stages, **kwargs)

    # -- routing -----------------------------------------------------------

    async def submit(self, item, timeout_s: float | None = None,
                     trace_id: str | None = None,
                     tenant: str | None = None) -> CascadeResult:
        """Route one request through the cascade. Raises whatever the
        stage engines raise (throttle/shed/deadline are not swallowed --
        an escalation that can't be admitted fails the request)."""
        cid = new_correlation_id()
        tid = trace_id or new_trace_id()
        self.metrics.inc("cascade_requests_total")
        journal = get_journal()
        journal.emit("cascade_request", cid=cid, trace_id=tid,
                     stage=self.stages[0].name, tenant=tenant)
        loop = asyncio.get_running_loop()
        tried: list[str] = []
        confidence: float | None = None
        last = len(self.stages) - 1
        for i, stage in enumerate(self.stages):
            if i == 0:
                out = await stage.engine.submit(item, timeout_s, tid, tenant)
            else:
                with span("cascade_escalate"):
                    out = await stage.engine.submit(item, timeout_s, tid,
                                                    tenant, escalated=True)
            tried.append(stage.name)
            if stage.calibration is None:
                confidence = None  # terminal stage: accepted by fiat
                accept = True
            else:
                scores = self.score_fn(out) if self.score_fn else out
                accept, confidence = stage.calibration.accepts(scores)
                if accept and self.agreement_fn is not None and i < last:
                    agreement = await loop.run_in_executor(
                        None, self.agreement_fn, out)
                    if agreement < self.agreement_floor:
                        accept = False
                        journal.emit("cascade_crosscheck_failed", cid=cid,
                                     stage=stage.name,
                                     agreement=round(float(agreement), 6),
                                     floor=self.agreement_floor)
            if accept:
                self.metrics.inc(f"cascade_{stage.name}_accepted_total")
                journal.emit("cascade_routed", cid=cid, trace_id=tid,
                             model=stage.name, escalations=i,
                             models_tried=tried,
                             confidence=None if confidence is None
                             else round(confidence, 6))
                return CascadeResult(
                    output=out, model=stage.name, models_tried=tuple(tried),
                    confidence=confidence, escalations=i, cid=cid,
                    trace_id=tid)
            self.metrics.inc("cascade_escalations_total")
            journal.emit("cascade_escalated", cid=cid, trace_id=tid,
                         stage_from=stage.name,
                         stage_to=self.stages[i + 1].name,
                         confidence=round(confidence, 6))
        raise AssertionError("unreachable: terminal stage always accepts")

    # -- introspection -----------------------------------------------------

    @property
    def escalation_rate(self) -> float:
        total = self.metrics.count("cascade_requests_total")
        if not total:
            return 0.0
        return self.metrics.count("cascade_escalations_total") / total

    def describe(self) -> dict:
        """The healthz ``cascade`` block: stage ladder, calibration
        provenance, live escalation counters."""
        stages = []
        for s in self.stages:
            entry: dict = {"model": s.name,
                           "accepted": self.metrics.count(
                               f"cascade_{s.name}_accepted_total")}
            if s.calibration is not None:
                entry["calibration"] = {
                    "fingerprint": s.calibration.fingerprint,
                    "threshold": s.calibration.threshold,
                    "temperature": s.calibration.temperature,
                    "measured_disagreement":
                        s.calibration.measured_disagreement,
                }
            stages.append(entry)
        return {
            "stages": stages,
            "requests": self.metrics.count("cascade_requests_total"),
            "escalations": self.metrics.count("cascade_escalations_total"),
            "escalation_rate": round(self.escalation_rate, 4),
            "crosscheck": self.agreement_fn is not None,
        }
