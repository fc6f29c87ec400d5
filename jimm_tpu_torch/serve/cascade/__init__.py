"""Confidence-cascade serving: route cheap, escalate on doubt; the
counterpart of ``jimm_tpu/serve/cascade/``.

Three pieces over the existing serving substrate:

- :mod:`~jimm_tpu_torch.serve.cascade.calibrate` -- fit the confidence threshold
  on a holdout set for a target top-1 disagreement rate and persist the
  result as a content-addressed artifact on the AOT store (routers never
  ship hardcoded thresholds; the reference's lint rule JL021, which
  ``tests/test_torch_serve_cascade.py`` runs over this package).
- :mod:`~jimm_tpu_torch.serve.cascade.router` -- requests hit the cheapest
  resident pool model first and escalate to wider dtypes when the
  calibrated confidence signal (temperature-scaled logit margin,
  optionally cross-checked by embedding-neighbor agreement) says the
  cheap answer is not trustworthy.
- :mod:`~jimm_tpu_torch.serve.cascade.autoscale` -- a bounded, hysteretic
  control loop converting SLO burn rates and per-class queue depth into
  residency actions: shift replicas between pool models via
  ``engine.replan``, hot-swap dtypes via ``ModelPool.swap``.

Everything here is numpy and the stdlib: the router and the autoscaler
drive engines they are given, and ``calibrate``/``cli`` import no torch.
"""

_EXPORTS = {
    "CascadeAutoscaler": "jimm_tpu_torch.serve.cascade.autoscale",
    "ScaleTarget": "jimm_tpu_torch.serve.cascade.autoscale",
    "CascadeCalibration": "jimm_tpu_torch.serve.cascade.calibrate",
    "fit_calibration": "jimm_tpu_torch.serve.cascade.calibrate",
    "fit_from_logits": "jimm_tpu_torch.serve.cascade.calibrate",
    "list_calibrations": "jimm_tpu_torch.serve.cascade.calibrate",
    "load_calibration": "jimm_tpu_torch.serve.cascade.calibrate",
    "save_calibration": "jimm_tpu_torch.serve.cascade.calibrate",
    "CascadeResult": "jimm_tpu_torch.serve.cascade.router",
    "CascadeRouter": "jimm_tpu_torch.serve.cascade.router",
    "CascadeStage": "jimm_tpu_torch.serve.cascade.router",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    """Import an export's module, or a submodule, at first use."""
    import importlib
    module = _EXPORTS.get(name)
    if module is not None:
        value = getattr(importlib.import_module(module), name)
    else:
        try:
            value = importlib.import_module(f"{__name__}.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value
    return value
