"""Store-first serve forward: loaded ``torch.export`` programs per bucket,
the model's own forward as the always-correct fallback, and warm-up of
whole bucket tables; the counterpart of ``jimm_tpu/aot/warmup.py``.

:class:`AotForward` is a drop-in for ``serve.engine.image_forward``:
callable over one padded numpy batch, with ``trace_count``, the getter the
engine exports as its ``compile_count`` gauge. Each bucket first consults
the :class:`~jimm_tpu_torch.aot.store.ArtifactStore` (under an
``aot_load`` span) and runs the model's own forward only on a miss or a
bad artifact, so a fully warm store reaches readiness with no bucket run
through the model's Python. Nothing compiles in eager torch: what a warm
store saves is the export. Either way the same ``jimm::`` ops launch the
same kernels. Outcome counters land in the ``jimm_aot`` registry:

- ``jimm_aot_hit_total``       artifact loaded and installed
- ``jimm_aot_miss_total``      no artifact for the key (the model's own
  forward serves; write-through exports and puts the artifact unless
  disabled)
- ``jimm_aot_fallback_total``  artifact existed but failed validation,
  loading or execution (quarantined; the model's own forward serves)
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from jimm_tpu_torch import obs
from jimm_tpu_torch.aot.export import (export_program, load_program,
                                       save_program, serialize_serve_forward)
from jimm_tpu_torch.aot.keys import (AOT_FORMAT_VERSION, AotKey,
                                     device_backend, runtime_versions,
                                     serve_forward_key)
from jimm_tpu_torch.aot.store import ArtifactStore

__all__ = ["AotForward", "aot_metrics", "model_param_dtype",
           "warmup_naflex", "warmup_store"]


def aot_metrics():
    """The ``jimm_aot`` registry's (hit, miss, fallback) counters."""
    reg = obs.get_registry("jimm_aot")
    return (reg.counter("hit_total"), reg.counter("miss_total"),
            reg.counter("fallback_total"))


def model_param_dtype(model: nn.Module) -> str:
    """The sorted set of the model's parameter and buffer dtypes joined
    with "+": "float32" for a plain model, "float32+int8" for one with
    ``QuantLinear`` layers (their int8 weights are buffers), so that an
    int8 model never adopts its f32 twin's program."""
    dtypes = {str(t.dtype).removeprefix("torch.")
              for t in [*model.parameters(), *model.buffers()]}
    return "+".join(sorted(dtypes)) if dtypes else "unknown"


def _key(model: nn.Module, method: str, bucket: int, item_shape, in_dtype,
         mesh, position: int) -> AotKey:
    device = next(model.parameters()).device
    return serve_forward_key(
        model.config, method=method, bucket=bucket, item_shape=item_shape,
        in_dtype=in_dtype, param_dtype=model_param_dtype(model), mesh=mesh,
        position=position, backend=device_backend(device))


def _meta(label: str, key: AotKey) -> dict:
    return {"label": label, **key.describe(), "kind": "serve_forward",
            "format_version": AOT_FORMAT_VERSION}


class AotForward:
    """Bucket-dispatching forward with store-first warm start.

    Args:
        model: the live model (supplies its tensors at every call).
        method: forward method name (``encode_image``, or ``forward``).
        item_shape: per-request shape, no batch axis.
        in_dtype: dtype the engine assembles batches in.
        store: artifact store consulted before the model's own forward.
        label: tag recorded in the store's metadata
            (``siglip:siglip-base-patch16-256:bf16``).
        mesh: optional mesh folded into the key, with ``position``: a wide
            replica's positions and the single-device model never share an
            artifact.
        context: optional context-manager factory entered around an export
            (a wide replica position's ``use_sharding`` and device).

    A missed bucket is exported and written through, so that the next
    process starts warm.
    """

    def __init__(self, model: nn.Module, *, method: str,
                 item_shape: tuple[int, ...], in_dtype: Any = np.float32,
                 store: ArtifactStore, label: str = "", mesh: Any = None,
                 position: int = 0,
                 context: Callable[[], Any] | None = None):
        from jimm_tpu_torch.serve.engine import image_forward
        self.model = model
        self.method = method
        self.item_shape = tuple(int(d) for d in item_shape)
        self.in_dtype = np.dtype(in_dtype)
        self.store = store
        self.label = label
        self.mesh = mesh
        self.position = int(position)
        self.context = context or contextlib.nullcontext
        param = next(model.parameters())
        self.device, self.dtype = param.device, param.dtype
        self._loaded: dict[int, Callable] = {}
        #: bucket -> "aot" | "miss" | "fallback" (how it was warmed)
        self.sources: dict[int, str] = {}
        self._fresh = image_forward(model, method)
        #: buckets the model's own forward ran (not a loaded program)
        self._traced: set[int] = set()

    def trace_count(self) -> int:
        """Buckets that ran the model's own Python instead of a loaded
        program (the engine's ``compile_count``; 0 on a warm store)."""
        return len(self._traced)

    # -- keys -------------------------------------------------------------

    def key_for(self, bucket: int) -> AotKey:
        return _key(self.model, self.method, bucket, self.item_shape,
                    self.in_dtype, self.mesh, self.position)

    # -- warm start -------------------------------------------------------

    def prepare_bucket(self, bucket: int) -> str:
        """Consult the store for one bucket; install the loaded program or
        leave the bucket to the model's own forward. Returns the source tag
        the engine's warm-up report records. Never raises."""
        bucket = int(bucket)
        if bucket in self.sources:
            return self.sources[bucket]
        hit, miss, fallback = aot_metrics()
        key = self.key_for(bucket)
        fp = key.fingerprint()
        existed = self.store.contains(fp)
        source = "miss"
        with obs.span("aot_load"):
            payload = self.store.get(fp, expect_versions=runtime_versions())
            if payload is not None:
                try:
                    self._loaded[bucket] = load_program(payload, self.model)
                    source = "aot"
                except Exception as e:  # noqa: BLE001 -- degrade, never die
                    self.store.quarantine(fp, f"load/bind failed: {e}")
                    source = "fallback"
            elif existed:
                source = "fallback"  # store.get already quarantined it
        if source == "aot":
            hit.inc()
        elif source == "fallback":
            fallback.inc()
        else:
            miss.inc()
            self._export_and_put(bucket, key, fp)
        self.sources[bucket] = source
        return source

    def _export_and_put(self, bucket: int, key: AotKey, fp: str) -> None:
        """Write-through on a miss: export this bucket and store it for the
        next process. A failed export must not break serving."""
        try:
            with self.context():
                payload = serialize_serve_forward(
                    self.model, self.method, bucket, self.item_shape)
            self.store.put(fp, payload, meta=_meta(self.label, key))
        except Exception:  # noqa: BLE001
            pass

    # -- dispatch ---------------------------------------------------------

    def __call__(self, padded: np.ndarray) -> torch.Tensor:
        bucket = int(np.shape(padded)[0])
        program = self._loaded.get(bucket)
        if program is not None:
            try:
                with torch.inference_mode():
                    return program(torch.from_numpy(padded).to(
                        self.device, self.dtype))
            except Exception:  # noqa: BLE001 -- a bad artifact must not
                # fail the request: drop it, quarantine, serve fresh
                _, _, fallback = aot_metrics()
                fallback.inc()
                del self._loaded[bucket]
                self.sources[bucket] = "fallback"
                self.store.quarantine(self.key_for(bucket).fingerprint(),
                                      "loaded program raised at call time")
        self._traced.add(bucket)
        return self._fresh(padded)



def warmup_store(model: nn.Module, *, method: str, buckets, item_shape,
                 in_dtype: Any = np.float32, store: ArtifactStore,
                 label: str = "", force: bool = False) -> dict:
    """Export every bucket of a table into the store (the ``aot warmup``
    core). Valid entries are kept unless ``force``. Returns a per-bucket
    report of ``{fingerprint, seconds, action[, bytes]}``."""
    item_shape = tuple(int(d) for d in item_shape)
    sizes = getattr(buckets, "sizes", buckets)
    report: dict[int, dict] = {}
    for bucket in sizes:
        bucket = int(bucket)
        key = _key(model, method, bucket, item_shape, in_dtype, None, 0)
        fp = key.fingerprint()
        t0 = time.monotonic()
        if store.contains(fp) and not force:
            report[bucket] = {"fingerprint": fp, "seconds": 0.0,
                              "action": "kept"}
            continue
        payload = serialize_serve_forward(model, method, bucket, item_shape)
        store.put(fp, payload, meta=_meta(label, key))
        report[bucket] = {"fingerprint": fp,
                          "seconds": round(time.monotonic() - t0, 3),
                          "action": "compiled", "bytes": len(payload)}
    return report


def warmup_naflex(model: nn.Module, *, batch_buckets, seq_buckets=None,
                  method: str = "encode_image_naflex") -> dict:
    """Export and load the NaFlex forward for every (batch, seq) bucket
    pair.

    NaFlex batches carry three arrays (padded patches, per-sample spatial
    shapes, the key-padding mask), so the shape contract is the (batch
    bucket, seq bucket) grid rather than the single-input tables
    :func:`warmup_store` covers (the store's key is unary; these programs
    are kept in memory, as JAX's are warm jits). Mask contents are runtime
    data: one program per pair serves every real-token count, and the mask
    routes attention onto the masked flash kernel (kernel row 4). Returns
    ``{(batch, seq): {"seconds", "traces", "bytes", "program"}}``; a
    ``program`` takes ``(patches, spatial_shapes, mask)`` tensors on the
    model's device."""
    from jimm_tpu_torch.serve.buckets import DEFAULT_NAFLEX_SEQ_BUCKETS
    if seq_buckets is None:
        seq_buckets = DEFAULT_NAFLEX_SEQ_BUCKETS
    vc = model.config.vision
    patch_dim = vc.patch_size * vc.patch_size * vc.channels
    param = next(model.parameters())
    report: dict[tuple[int, int], dict] = {}
    for b in sorted({int(s) for s in batch_buckets}):
        for s in sorted({int(s) for s in seq_buckets}):
            g = max(math.isqrt(s), 1)
            patches = torch.zeros((b, s, patch_dim), dtype=param.dtype,
                                  device=param.device)
            shapes = torch.full((b, 2), g, dtype=torch.int32,
                                device=param.device)
            mask = torch.zeros((b, s), dtype=torch.bool, device=param.device)
            mask[:, :g * g] = True
            t0 = time.monotonic()
            payload = save_program(export_program(model, method,
                                                  (patches, shapes, mask)))
            program = load_program(payload, model)
            report[(b, s)] = {"seconds": round(time.monotonic() - t0, 4),
                              "traces": 1, "bytes": len(payload),
                              "program": program}
    return report
