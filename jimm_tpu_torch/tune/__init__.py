"""jimm_tpu_torch.tune: the persistent cache of the kernels' launch knobs;
the counterpart of ``jimm_tpu/tune/``.

JAX's tuner measures Pallas block sizes. The port's kernels compile their
tiles in; what their wrappers pick at run time (the LayerNorm backward's
CTAs, row 8's batch ranges, the fp8 GEMMs' K ranges, the retrieval scan's
block) is what this package measures offline (``python -m jimm_tpu_torch
tune run``) and persists in a fingerprint-keyed store on the AOT store's
machinery, so the hot path only looks up::

    from jimm_tpu_torch import tune

    cfg = tune.best_config("fp8_matmul", (x.shape, w.shape),
                           (x.dtype, w.dtype), device=x.device,
                           default=lambda: default_k_ranges(...))

`best_config` never measures unless ``JIMM_TUNE=1``: a miss returns the
default (today's heuristic, so an empty cache changes no launch) and counts
``jimm_tune_{miss,fallback}_total``; resolutions are memoized a shape a
process. See `space.py` for the design and `api.py` for the contract.

No module here imports torch at import: ``tune ls`` is a host tool.
"""

from jimm_tpu_torch.tune.api import (KERNELS, NOT_PORTED, best_config,
                                     configure, get_cache, tune_kernel)
from jimm_tpu_torch.tune.cache import (TUNE_FORMAT_VERSION, TuneCache,
                                       TuneKey, default_root, tune_key)
from jimm_tpu_torch.tune.measure import (measure, trimmed_median,
                                         trimmed_spread)

__all__ = [
    "KERNELS", "NOT_PORTED", "TUNE_FORMAT_VERSION", "TuneCache", "TuneKey",
    "best_config", "configure", "default_root", "get_cache", "measure",
    "trimmed_median", "trimmed_spread", "tune_key", "tune_kernel",
]
