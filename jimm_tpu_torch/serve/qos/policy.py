"""Tenant identity and QoS policy: classes, rate limits, quotas; the
counterpart of ``jimm_tpu/serve/qos/policy.py``.

Stdlib-only (``json`` + ``tomllib``) so the ``qos`` command and any
front-end proxy can load and validate a policy without the accelerator
stack. A policy file (JSON or TOML) looks like::

    {
      "classes": {"interactive": {"weight": 8},
                  "batch":       {"weight": 2},
                  "background":  {"weight": 1}},
      "tenants": {
        "alice": {"class": "interactive", "rate": 200, "burst": 400,
                  "timeout_s": 2.0, "max_queued": 64},
        "bob":   {"class": "batch", "rate": 50}
      },
      "default": {"class": "interactive"},
      "slo": {
        "alice":   {"availability": 0.999, "latency_ms": 250},
        "default": {"availability": 0.99}
      }
    }

Class **priority is declaration order** (first listed = highest = shed
last); ``weight`` sets the weighted-fair dequeue share, so priority (who
is shed first) and share (who drains faster) are independent knobs.
Requests carrying no tenant id — or an id the policy doesn't name — map
to the **default tenant**: one shared spec and one shared runtime state,
so an adversary inventing tenant names cannot grow any per-tenant table
(the reference's bounded-cardinality discipline for ``serve/``).

The optional ``slo`` section declares per-tenant service-level
objectives (availability as a success-rate fraction, optional latency
target in ms). Names must be declared tenants or ``default``; the serve
CLI feeds the parsed objectives into the burn-rate engine
(:class:`jimm_tpu_torch.obs.slo.SloEngine`). The ``cascade`` and
``autoscale`` sections configure the cascade router and its autoscaler
(`serve/cascade/`), parsed and validated as the reference does.
"""

from __future__ import annotations

import dataclasses
import json
import re

__all__ = ["ClassSpec", "DEFAULT_CLASSES", "QosPolicyError", "TenantRegistry",
           "TenantSpec", "load_policy"]

#: shipped class ladder: (name, weight) in priority order. A policy file
#: may re-weight, drop, or extend these; declaration order stays the
#: priority order either way.
DEFAULT_CLASSES: tuple[tuple[str, float], ...] = (
    ("interactive", 8.0), ("batch", 2.0), ("background", 1.0))

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_.-]*$")


class QosPolicyError(ValueError):
    """Malformed QoS policy (bad file, unknown class, non-positive rate)."""


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """One priority class: ``rank`` 0 is highest priority (shed last),
    ``weight`` is its deficit-round-robin dequeue share."""

    name: str
    weight: float
    rank: int


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's policy: class membership, token-bucket rate limit
    (``rate`` requests/s refill, ``burst`` bucket depth), an optional
    per-tenant default deadline (inherited by requests that carry none),
    and a ``max_queued`` quota bounding this tenant's share of the
    admission queue."""

    name: str
    klass: str = "interactive"
    rate: float | None = None
    burst: float | None = None
    timeout_s: float | None = None
    max_queued: int | None = None


def _check_name(kind: str, name: str, problems: list[str]) -> None:
    if not isinstance(name, str) or not _NAME_RE.match(name):
        problems.append(f"{kind} name {name!r} is not a valid identifier "
                        "([A-Za-z_][A-Za-z0-9_.-]*)")


def _parse_classes(raw, problems: list[str]) -> dict[str, ClassSpec]:
    if raw is None:
        raw = {name: {"weight": weight} for name, weight in DEFAULT_CLASSES}
    if not isinstance(raw, dict) or not raw:
        problems.append("'classes' must be a non-empty mapping")
        return {}
    classes: dict[str, ClassSpec] = {}
    for rank, (name, spec) in enumerate(raw.items()):
        _check_name("class", name, problems)
        if not isinstance(spec, dict):
            spec = {"weight": spec}
        weight = spec.get("weight", 1.0)
        if not isinstance(weight, (int, float)) or weight <= 0:
            problems.append(f"class {name!r}: weight must be > 0, "
                            f"got {weight!r}")
            weight = 1.0
        classes[str(name)] = ClassSpec(str(name), float(weight), rank)
    return classes


def _parse_tenant(name: str, spec, classes: dict[str, ClassSpec],
                  problems: list[str]) -> TenantSpec:
    if not isinstance(spec, dict):
        problems.append(f"tenant {name!r}: spec must be a mapping")
        spec = {}
    klass = spec.get("class", spec.get("klass"))
    if klass is None:
        klass = next(iter(classes), "interactive")
    if klass not in classes:
        problems.append(f"tenant {name!r}: unknown class {klass!r} "
                        f"(declared: {sorted(classes)})")
    rate = spec.get("rate")
    if rate is not None and (not isinstance(rate, (int, float)) or rate <= 0):
        problems.append(f"tenant {name!r}: rate must be > 0, got {rate!r}")
        rate = None
    burst = spec.get("burst")
    if burst is not None and (not isinstance(burst, (int, float))
                              or burst < 1):
        problems.append(f"tenant {name!r}: burst must be >= 1, got {burst!r}")
        burst = None
    timeout_s = spec.get("timeout_s")
    if timeout_s is not None and (not isinstance(timeout_s, (int, float))
                                  or timeout_s <= 0):
        problems.append(f"tenant {name!r}: timeout_s must be > 0, "
                        f"got {timeout_s!r}")
        timeout_s = None
    max_queued = spec.get("max_queued")
    if max_queued is not None and (not isinstance(max_queued, int)
                                   or max_queued < 1):
        problems.append(f"tenant {name!r}: max_queued must be an int >= 1, "
                        f"got {max_queued!r}")
        max_queued = None
    unknown = set(spec) - {"class", "klass", "rate", "burst", "timeout_s",
                           "max_queued"}
    if unknown:
        problems.append(f"tenant {name!r}: unknown keys {sorted(unknown)}")
    return TenantSpec(name=str(name), klass=str(klass),
                      rate=None if rate is None else float(rate),
                      burst=None if burst is None else float(burst),
                      timeout_s=(None if timeout_s is None
                                 else float(timeout_s)),
                      max_queued=max_queued)


def _parse_slo(raw, tenants: dict[str, TenantSpec],
               problems: list[str]) -> dict[str, dict]:
    """Validate the optional ``slo`` section into plain objective dicts
    keyed by tenant name (``SloEngine.from_objective_dicts`` consumes
    them). Names must be declared tenants or ``default`` — an SLO for a
    tenant the policy never admits would silently track nothing."""
    if raw is None:
        return {}
    if not isinstance(raw, dict):
        problems.append("'slo' must be a mapping of tenant -> objective")
        return {}
    slo: dict[str, dict] = {}
    for name, spec in raw.items():
        if name != TenantRegistry.DEFAULT_TENANT and name not in tenants:
            problems.append(f"slo {name!r}: not a declared tenant "
                            f"(declared: {sorted(tenants)} + ['default'])")
            continue
        if not isinstance(spec, dict):
            problems.append(f"slo {name!r}: objective must be a mapping")
            continue
        unknown = set(spec) - {"availability", "latency_ms"}
        if unknown:
            problems.append(f"slo {name!r}: unknown keys {sorted(unknown)}")
            continue
        availability = spec.get("availability", 0.999)
        if (not isinstance(availability, (int, float))
                or not 0.0 < availability < 1.0):
            problems.append(f"slo {name!r}: availability must be in (0, 1), "
                            f"got {availability!r}")
            continue
        latency_ms = spec.get("latency_ms")
        if latency_ms is not None and (
                not isinstance(latency_ms, (int, float)) or latency_ms <= 0):
            problems.append(f"slo {name!r}: latency_ms must be > 0, "
                            f"got {latency_ms!r}")
            continue
        slo[str(name)] = {"availability": float(availability)}
        if latency_ms is not None:
            slo[str(name)]["latency_ms"] = float(latency_ms)
    return slo


def _parse_cascade(raw, problems: list[str]) -> dict:
    """Validate the optional ``cascade`` section: the stage ladder
    (``order``, cheapest model first) and the store fingerprints of each
    non-terminal stage's calibration — the policy file carries artifact
    *references*, never threshold values."""
    if raw is None:
        return {}
    if not isinstance(raw, dict):
        problems.append("'cascade' must be a mapping")
        return {}
    unknown = set(raw) - {"order", "calibrations", "agreement_floor"}
    if unknown:
        problems.append(f"cascade: unknown keys {sorted(unknown)}")
        return {}
    order = raw.get("order")
    if (not isinstance(order, list) or len(order) < 2
            or not all(isinstance(n, str) and n for n in order)
            or len(set(order)) != len(order)):
        problems.append("cascade: 'order' must list >= 2 distinct model "
                        f"names cheapest-first, got {order!r}")
        return {}
    calibrations = raw.get("calibrations")
    if calibrations is None or not isinstance(calibrations, dict) or not all(
            isinstance(k, str) and isinstance(v, str) and v
            for k, v in calibrations.items()):
        problems.append("cascade: 'calibrations' must map stage name -> "
                        "store fingerprint")
        return {}
    missing = [n for n in order[:-1] if n not in calibrations]
    if missing:
        problems.append(f"cascade: stages {missing} have no calibration "
                        "fingerprint (only the terminal stage may accept "
                        "unconditionally)")
    stray = sorted(set(calibrations) - set(order[:-1]))
    if stray:
        problems.append(f"cascade: calibrations for {stray} name no "
                        "non-terminal stage in 'order'")
    out = {"order": [str(n) for n in order],
           "calibrations": {str(k): str(v)
                            for k, v in calibrations.items()}}
    floor = raw.get("agreement_floor")
    if floor is not None:
        if not isinstance(floor, (int, float)) or not 0.0 < floor <= 1.0:
            problems.append("cascade: agreement_floor must be in (0, 1], "
                            f"got {floor!r}")
        else:
            out["agreement_floor"] = float(floor)
    return out


def _parse_autoscale(raw, classes: dict, problems: list[str]) -> dict:
    """Validate the optional ``autoscale`` section (the
    cascade autoscaler's knobs: trip points + hysteresis)."""
    if raw is None:
        return {}
    if not isinstance(raw, dict):
        problems.append("'autoscale' must be a mapping")
        return {}
    unknown = set(raw) - {"watch_class", "burn_high", "queue_high",
                          "window", "cooldown"}
    if unknown:
        problems.append(f"autoscale: unknown keys {sorted(unknown)}")
        return {}
    out: dict = {}
    watch = raw.get("watch_class")
    if watch is not None:
        if not isinstance(watch, str) or (classes and watch not in classes):
            problems.append(f"autoscale: watch_class {watch!r} is not a "
                            f"declared class ({sorted(classes)})")
        else:
            out["watch_class"] = watch
    for key in ("burn_high", "queue_high"):
        value = raw.get(key)
        if value is None:
            continue
        if not isinstance(value, (int, float)) or value <= 0:
            problems.append(f"autoscale: {key} must be > 0, got {value!r}")
        else:
            out[key] = float(value)
    for key, floor in (("window", 1), ("cooldown", 0)):
        value = raw.get(key)
        if value is None:
            continue
        if not isinstance(value, int) or isinstance(value, bool) \
                or value < floor:
            problems.append(f"autoscale: {key} must be an int >= {floor}, "
                            f"got {value!r}")
        else:
            out[key] = value
    return out


class TenantRegistry:
    """The parsed policy: priority classes, named tenants, and the shared
    default tenant that anonymous/unknown traffic maps to."""

    DEFAULT_TENANT = "default"

    def __init__(self, classes: dict[str, ClassSpec],
                 tenants: dict[str, TenantSpec], default: TenantSpec,
                 slo: dict[str, dict] | None = None,
                 cascade: dict | None = None,
                 autoscale: dict | None = None):
        self.classes = classes
        self.tenants = tenants
        self.default = default
        #: per-tenant SLO objective dicts from the policy's ``slo`` section
        #: (empty when the policy declares none)
        self.slo = dict(slo or {})
        #: cascade stage ladder + calibration fingerprints (``cascade``
        #: section; None when the policy declares none)
        self.cascade = dict(cascade) if cascade else None
        #: autoscaler trip points + hysteresis (``autoscale`` section)
        self.autoscale = dict(autoscale) if autoscale else None
        #: class names in priority order (rank 0 first) — the weighted-fair
        #: queue's drain order and the INVERSE of the shed order
        self.class_order = tuple(sorted(classes, key=lambda n:
                                        classes[n].rank))

    # -- construction -----------------------------------------------------

    @classmethod
    def from_dict(cls, data: dict) -> "TenantRegistry":
        if not isinstance(data, dict):
            raise QosPolicyError("policy must be a mapping")
        problems: list[str] = []
        unknown = set(data) - {"classes", "tenants", "default", "slo",
                               "cascade", "autoscale"}
        if unknown:
            problems.append(f"unknown top-level keys {sorted(unknown)}")
        classes = _parse_classes(data.get("classes"), problems)
        raw_tenants = data.get("tenants") or {}
        if not isinstance(raw_tenants, dict):
            problems.append("'tenants' must be a mapping")
            raw_tenants = {}
        tenants: dict[str, TenantSpec] = {}
        for name, spec in raw_tenants.items():
            _check_name("tenant", name, problems)
            tenants[str(name)] = _parse_tenant(str(name), spec, classes,
                                               problems)
        default = _parse_tenant(cls.DEFAULT_TENANT, data.get("default") or {},
                                classes, problems)
        slo = _parse_slo(data.get("slo"), tenants, problems)
        cascade = _parse_cascade(data.get("cascade"), problems)
        autoscale = _parse_autoscale(data.get("autoscale"), classes,
                                     problems)
        if problems:
            raise QosPolicyError("; ".join(problems))
        return cls(classes, tenants, default, slo, cascade, autoscale)

    @classmethod
    def load(cls, path: str) -> "TenantRegistry":
        """Parse a JSON (``.json``) or TOML (``.toml``) policy file."""
        if str(path).endswith(".toml"):
            try:
                import tomllib
            except ImportError as e:  # pragma: no cover — Python < 3.11
                raise QosPolicyError(
                    "TOML policy files need Python >= 3.11 (tomllib); "
                    "use JSON") from e
            try:
                with open(path, "rb") as f:
                    data = tomllib.load(f)
            except (OSError, tomllib.TOMLDecodeError) as e:
                raise QosPolicyError(f"cannot load {path}: {e}") from e
        else:
            try:
                with open(path, "r", encoding="utf-8") as f:
                    data = json.load(f)
            except (OSError, ValueError) as e:
                raise QosPolicyError(f"cannot load {path}: {e}") from e
        return cls.from_dict(data)

    # -- queries ----------------------------------------------------------

    def resolve_spec(self, tenant: str | None) -> TenantSpec:
        """The spec governing ``tenant``; anonymous (None) and unknown ids
        share the default spec, so tenant cardinality is bounded by this
        file, not by what clients send."""
        if tenant is None:
            return self.default
        return self.tenants.get(tenant, self.default)

    def rank_of(self, klass: str) -> int:
        return self.classes[klass].rank

    def describe(self) -> dict:
        """JSON-shaped summary (the ``qos ls`` CLI and healthz payload)."""
        out = {
            "classes": [{"name": c.name, "weight": c.weight, "rank": c.rank}
                        for c in sorted(self.classes.values(),
                                        key=lambda c: c.rank)],
            "tenants": [dataclasses.asdict(t) for t in
                        sorted(self.tenants.values(), key=lambda t: t.name)],
            "default": dataclasses.asdict(self.default),
        }
        if self.slo:
            out["slo"] = {name: dict(obj)
                          for name, obj in sorted(self.slo.items())}
        if self.cascade:
            out["cascade"] = dict(self.cascade)
        if self.autoscale:
            out["autoscale"] = dict(self.autoscale)
        return out


def load_policy(path: str) -> TenantRegistry:
    """Module-level alias for :meth:`TenantRegistry.load`."""
    return TenantRegistry.load(path)
