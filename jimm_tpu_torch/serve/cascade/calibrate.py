"""Confidence calibration for the cascade router (numpy only); the
counterpart of ``jimm_tpu/serve/cascade/calibrate.py``, which fits the same
temperatures, thresholds and fingerprints, bit for bit, from the same score
rows.

The router's escalation signal is a **temperature-scaled logit margin**:
softmax the cheap model's score row at temperature ``T`` and take
``p_top1 - p_top2``. Raw margins are uncalibrated -- an int8 twin can be
confidently wrong -- so the threshold the router compares against is *fit
on a holdout set* for a target top-1 disagreement rate and persisted as a
content-addressed artifact on the AOT store (the port's, whose layout the
JAX package's store reads too). Routers load calibrations; they never ship
hardcoded thresholds (the reference's lint rule JL021 bans numeric
threshold literals everywhere in ``serve/cascade/`` except this module, and
``tests/test_torch_serve_cascade.py`` runs it over this package).

Fitting is two stages over ``(cheap_logits, agree)`` pairs, where
``agree[i]`` says whether the cheap model's top-1 matched the reference
(wide-dtype) model's on holdout item ``i``:

1. **Temperature**: grid-search ``T`` minimizing the binary cross-entropy
   between the margin and the agreement labels -- the margin becomes an
   honest probability-like predictor of "the expensive model would say
   the same thing".
2. **Threshold**: rank the holdout by calibrated margin and pick the
   *lowest* threshold whose accepted prefix keeps top-1 disagreement at
   or under the target (default 1%). Lowest = maximal acceptance =
   maximal cost saving at the contracted quality.

The artifact's fingerprint is the SHA-256 of its canonical JSON payload,
so identical calibrations land on identical store entries and a router
can pin a calibration by content, not by path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

__all__ = ["CALIBRATION_KIND", "CALIBRATION_VERSION", "CascadeCalibration",
           "fit_calibration", "fit_from_logits", "list_calibrations",
           "load_calibration", "save_calibration"]

#: meta.json ``kind`` tag that marks a store entry as a cascade calibration
CALIBRATION_KIND = "cascade_calibration"
CALIBRATION_VERSION = 1

#: temperature grid (log-spaced): wide enough to cover peaked int8 logits
#: and nearly-flat random-init embeddings
_TEMPERATURES = np.logspace(-1.5, 1.5, 61)


@dataclasses.dataclass(frozen=True)
class CascadeCalibration:
    """One fitted (cheap model, reference model) escalation policy."""

    cheap_model: str
    reference_model: str
    temperature: float
    threshold: float
    target_disagreement: float
    measured_disagreement: float
    escalation_fraction: float
    holdout: int
    version: int = CALIBRATION_VERSION

    def confidence(self, scores) -> float:
        """Temperature-scaled top-1/top-2 softmax margin of one score row,
        in [0, 1]. This is THE confidence signal the router thresholds."""
        z = np.asarray(scores, np.float64).reshape(-1) / self.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        if p.size < 2:
            return 1.0
        top1, top2 = _top2(p)
        return float(top1 - top2)

    def accepts(self, scores) -> tuple[bool, float]:
        """(accept, confidence) for one cheap-model score row."""
        conf = self.confidence(scores)
        return conf >= self.threshold, conf

    # -- wire format -------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "CascadeCalibration":
        version = data.get("version")
        if version != CALIBRATION_VERSION:
            raise ValueError(f"calibration version {version!r} != "
                             f"{CALIBRATION_VERSION}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown calibration keys {sorted(unknown)}")
        missing = known - set(data)
        if missing:
            raise ValueError(f"missing calibration keys {sorted(missing)}")
        return cls(**{k: (int(v) if k in ("holdout", "version")
                          else str(v) if k.endswith("_model") else float(v))
                      for k, v in data.items()})

    def payload(self) -> bytes:
        """Canonical JSON bytes -- the content the fingerprint addresses."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":")).encode()

    @property
    def fingerprint(self) -> str:
        return hashlib.sha256(self.payload()).hexdigest()


def _top2(p: np.ndarray) -> tuple[float, float]:
    """Largest two entries without a full sort (O(n) partition)."""
    idx = int(np.argmax(p))
    top1 = float(p[idx])
    rest = np.delete(p, idx)
    return top1, float(rest.max()) if rest.size else 0.0


def _margins(logits: np.ndarray, temperature: float) -> np.ndarray:
    """Per-row temperature-scaled softmax margin, vectorized for the fit."""
    z = logits / temperature
    z = z - z.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    part = -np.partition(-p, 1, axis=1)
    return part[:, 0] - part[:, 1]


def fit_calibration(cheap_logits, agree, *, cheap_model: str,
                    reference_model: str,
                    target_disagreement: float = 0.01
                    ) -> CascadeCalibration:
    """Fit temperature + threshold from holdout score rows and per-row
    top-1 agreement labels (True = cheap and reference models agreed)."""
    logits = np.asarray(cheap_logits, np.float64)
    agree = np.asarray(agree, bool).reshape(-1)
    if logits.ndim != 2 or logits.shape[1] < 2:
        raise ValueError(f"cheap_logits must be (N, C>=2), "
                         f"got shape {logits.shape}")
    if logits.shape[0] != agree.shape[0]:
        raise ValueError(f"{logits.shape[0]} logit rows vs "
                         f"{agree.shape[0]} agreement labels")
    if not 0.0 < target_disagreement < 1.0:
        raise ValueError(f"target_disagreement must be in (0, 1), "
                         f"got {target_disagreement}")
    n = logits.shape[0]

    # stage 1: temperature by BCE between margin and agreement
    y = agree.astype(np.float64)
    best_t, best_loss = 1.0, np.inf
    for t in _TEMPERATURES:
        m = np.clip(_margins(logits, float(t)), 1e-9, 1.0 - 1e-9)
        loss = float(-(y * np.log(m) + (1.0 - y) * np.log1p(-m)).mean())
        if loss < best_loss:
            best_t, best_loss = float(t), loss

    # stage 2: lowest threshold whose accepted prefix meets the target.
    # np.lexsort, as in the reference: the holdout is a bounded
    # operator-supplied set, not serving traffic.
    conf = _margins(logits, best_t)
    order = np.lexsort((conf,))[::-1]  # descending confidence
    disagree = (~agree[order]).cumsum()
    accepted = np.arange(1, n + 1)
    feasible = np.nonzero(disagree <= target_disagreement * accepted)[0]
    if feasible.size:
        k = int(feasible.max())
        threshold = float(conf[order[k]])
    else:
        # no prefix is clean enough: escalate everything
        threshold = float(np.nextafter(conf.max(), np.inf))
    keep = conf >= threshold
    kept = int(keep.sum())
    measured = float((~agree[keep]).sum() / n)
    # temperature/threshold ship at full float precision: the boundary
    # row's accept/escalate decision must reproduce bit-exactly from the
    # stored artifact (rounding here once moved `measured` by one row)
    return CascadeCalibration(
        cheap_model=cheap_model, reference_model=reference_model,
        temperature=float(best_t), threshold=float(threshold),
        target_disagreement=float(target_disagreement),
        measured_disagreement=round(measured, 6),
        escalation_fraction=round(1.0 - kept / n, 6), holdout=n)


def fit_from_logits(cheap_logits, reference_logits, **kwargs
                    ) -> CascadeCalibration:
    """Fit from both models' holdout score rows: the agreement label is
    per-row top-1 equality. See :func:`fit_calibration` for kwargs."""
    cheap = np.asarray(cheap_logits, np.float64)
    ref = np.asarray(reference_logits, np.float64)
    if cheap.shape != ref.shape:
        raise ValueError(f"logit shapes differ: cheap {cheap.shape} vs "
                         f"reference {ref.shape}")
    agree = cheap.argmax(axis=1) == ref.argmax(axis=1)
    return fit_calibration(cheap, agree, **kwargs)


# -- store persistence (content-addressed, AOT ArtifactStore) --------------

def save_calibration(store, calib: CascadeCalibration) -> str:
    """Persist on the AOT artifact store; returns the content fingerprint.
    Identical calibrations re-land on the same entry (same bytes, same
    hash), so saves are idempotent."""
    payload = calib.payload()
    fp = calib.fingerprint
    store.put(fp, payload, meta={
        "kind": CALIBRATION_KIND,
        "label": f"cascade:{calib.cheap_model}->{calib.reference_model}",
        "threshold": calib.threshold,
        "temperature": calib.temperature,
        "measured_disagreement": calib.measured_disagreement,
        "escalation_fraction": calib.escalation_fraction,
    })
    return fp


def load_calibration(store, fingerprint: str) -> CascadeCalibration:
    """Load + verify a calibration by content fingerprint. Raises
    ``ValueError`` on a missing, corrupt, or mis-addressed entry -- a
    router must fail loudly rather than serve an uncalibrated cascade."""
    payload = store.get(fingerprint)
    if payload is None:
        raise ValueError(f"no calibration {fingerprint!r} in store "
                         f"{store.root}")
    if hashlib.sha256(payload).hexdigest() != fingerprint:
        raise ValueError(f"calibration {fingerprint!r} is not content-"
                         "addressed by its payload hash")
    try:
        data = json.loads(payload)
    except ValueError as e:
        raise ValueError(f"calibration {fingerprint!r}: bad JSON payload: "
                         f"{e}") from None
    return CascadeCalibration.from_dict(data)


def list_calibrations(store) -> list[dict]:
    """Calibration entries on a store (the ``cascade ls`` rows), newest
    first."""
    rows = []
    for entry in store.entries():
        if entry.meta.get("kind") != CALIBRATION_KIND:
            continue
        rows.append({
            "fingerprint": entry.fingerprint,
            "label": entry.meta.get("label"),
            "threshold": entry.meta.get("threshold"),
            "temperature": entry.meta.get("temperature"),
            "measured_disagreement": entry.meta.get("measured_disagreement"),
            "escalation_fraction": entry.meta.get("escalation_fraction"),
            "created": entry.created,
        })
    rows.sort(key=lambda r: r["created"], reverse=True)
    return rows
