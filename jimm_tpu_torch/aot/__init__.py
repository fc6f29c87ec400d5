"""``jimm_tpu_torch.aot``: the persistent store of ahead-of-time serve
programs; the counterpart of ``jimm_tpu/aot/``.

Cold start here is the export of every bucket's forward: in eager torch
nothing compiles, so what a warm store saves is ``torch.export`` tracing
the model's Python, not a compiler. The package has the reference's two
halves but one:

1. **Artifact store** (:mod:`keys` / :mod:`store` / :mod:`export`): serve
   forwards exported with ``torch.export``, the model's tensors as call
   arguments, keyed by a byte-stable fingerprint over everything that
   shaped the program (config hash, bucket, dtypes, mesh and position,
   device kind, torch and CUDA versions, the ``jimm::`` op schemas,
   donation), in a content-addressed on-disk store with atomic writes,
   integrity hashes, LRU eviction and quarantine on mismatch. The loaded
   program names the ``jimm::`` ops, so it launches the same hand-written
   kernels as the model's own forward.
2. JAX's persistent compilation cache is XLA's and has no counterpart.

:class:`~jimm_tpu_torch.aot.warmup.AotForward` is the serve-side entry
point: a drop-in for ``serve.engine.image_forward`` that consults the
store per bucket (``jimm_aot_hit_total``), writes through on a miss
(``jimm_aot_miss_total``) and runs the model's own forward for a bad
artifact (``jimm_aot_fallback_total``). ``aot warmup|ls|gc|verify``
manage stores offline; this module and :mod:`keys`, :mod:`store` and
:mod:`cli` import no torch until ``warmup`` runs.
"""

from jimm_tpu_torch.aot.keys import (AOT_FORMAT_VERSION, AotKey,
                                     canonical_json, config_hash,
                                     donation_signature, serve_forward_key)
from jimm_tpu_torch.aot.store import (DEFAULT_MAX_BYTES, ArtifactStore,
                                      StoreEntry)

__all__ = [
    "AOT_FORMAT_VERSION",
    "AotKey",
    "ArtifactStore",
    "DEFAULT_MAX_BYTES",
    "StoreEntry",
    "canonical_json",
    "config_hash",
    "donation_signature",
    "serve_forward_key",
]


def __getattr__(name):  # lazy: keep `import jimm_tpu_torch.aot` torch-free
    if name in ("AotForward", "aot_metrics", "warmup_naflex", "warmup_store"):
        from jimm_tpu_torch.aot import warmup
        return getattr(warmup, name)
    if name in ("load_program", "serialize_serve_forward"):
        from jimm_tpu_torch.aot import export
        return getattr(export, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
