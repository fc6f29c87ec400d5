"""Serving: buckets, admission, the micro-batching engine over one or more
replicas (each one device, or an in-process mesh of several), the topology
planner, tenant QoS and the model pool, the confidence cascade and its
autoscaler, HTTP and the stdlib client; the counterpart of
``jimm_tpu.serve``. Store-backed forwards (``--aot-store``) come from
``jimm_tpu_torch.aot``. The exports import their modules at first use, so
that ``serve.cascade``'s host tools import no torch."""

_EXPORTS = {
    "AdmissionController": "jimm_tpu_torch.serve.admission",
    "AdmissionPolicy": "jimm_tpu_torch.serve.admission",
    "DeadlineExceededError": "jimm_tpu_torch.serve.admission",
    "EngineClosedError": "jimm_tpu_torch.serve.admission",
    "QueueFullError": "jimm_tpu_torch.serve.admission",
    "RequestError": "jimm_tpu_torch.serve.admission",
    "ServeError": "jimm_tpu_torch.serve.admission",
    "ServeMetrics": "jimm_tpu_torch.serve.admission",
    "ShedError": "jimm_tpu_torch.serve.admission",
    "ThrottledError": "jimm_tpu_torch.serve.admission",
    "BucketTable": "jimm_tpu_torch.serve.buckets",
    "CUDA_BATCH_BUCKETS": "jimm_tpu_torch.serve.buckets",
    "DEFAULT_BATCH_BUCKETS": "jimm_tpu_torch.serve.buckets",
    "DEFAULT_NAFLEX_SEQ_BUCKETS": "jimm_tpu_torch.serve.buckets",
    "SERVE_DTYPES": "jimm_tpu_torch.serve.buckets",
    "default_buckets": "jimm_tpu_torch.serve.buckets",
    "pad_batch": "jimm_tpu_torch.serve.buckets",
    "EmbeddingCache": "jimm_tpu_torch.serve.cache",
    "class_embedding_cache": "jimm_tpu_torch.serve.cache",
    "prompt_set_key": "jimm_tpu_torch.serve.cache",
    "CascadeAutoscaler": "jimm_tpu_torch.serve.cascade",
    "CascadeCalibration": "jimm_tpu_torch.serve.cascade",
    "CascadeResult": "jimm_tpu_torch.serve.cascade",
    "CascadeRouter": "jimm_tpu_torch.serve.cascade",
    "CascadeStage": "jimm_tpu_torch.serve.cascade",
    "ScaleTarget": "jimm_tpu_torch.serve.cascade",
    "fit_calibration": "jimm_tpu_torch.serve.cascade",
    "fit_from_logits": "jimm_tpu_torch.serve.cascade",
    "list_calibrations": "jimm_tpu_torch.serve.cascade",
    "load_calibration": "jimm_tpu_torch.serve.cascade",
    "save_calibration": "jimm_tpu_torch.serve.cascade",
    "CascadeInfo": "jimm_tpu_torch.serve.client",
    "EmbedResult": "jimm_tpu_torch.serve.client",
    "ServeClient": "jimm_tpu_torch.serve.client",
    "ServeClientError": "jimm_tpu_torch.serve.client",
    "ShedClientError": "jimm_tpu_torch.serve.client",
    "ThrottledClientError": "jimm_tpu_torch.serve.client",
    "encode_image_payload": "jimm_tpu_torch.serve.client",
    "parse_cascade_headers": "jimm_tpu_torch.serve.client",
    "InferenceEngine": "jimm_tpu_torch.serve.engine",
    "image_forward": "jimm_tpu_torch.serve.engine",
    "ModelPool": "jimm_tpu_torch.serve.qos",
    "QosPolicyError": "jimm_tpu_torch.serve.qos",
    "QosScheduler": "jimm_tpu_torch.serve.qos",
    "TenantRegistry": "jimm_tpu_torch.serve.qos",
    "TenantSpec": "jimm_tpu_torch.serve.qos",
    "WeightedFairQueue": "jimm_tpu_torch.serve.qos",
    "load_policy": "jimm_tpu_torch.serve.qos",
    "ServingServer": "jimm_tpu_torch.serve.server",
    "ZeroShotService": "jimm_tpu_torch.serve.server",
    "decode_image_payload": "jimm_tpu_torch.serve.server",
    "ReplicaForward": "jimm_tpu_torch.serve.topology",
    "ShardedReplicaForward": "jimm_tpu_torch.serve.topology",
    "TopologyPlan": "jimm_tpu_torch.serve.topology",
    "build_replica_forwards": "jimm_tpu_torch.serve.topology",
    "plan_topology": "jimm_tpu_torch.serve.topology",
    "replica_trace_count": "jimm_tpu_torch.serve.topology",
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
