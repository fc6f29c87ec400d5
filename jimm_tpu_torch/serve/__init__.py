"""Serving: buckets, admission, the micro-batching engine over one or more
replicas, the topology planner, HTTP and the stdlib client; the counterpart
of ``jimm_tpu.serve`` (its QoS, cascade and AOT parts wait in ROADMAP.md
queue 1 item 8(b) and (c))."""

from jimm_tpu_torch.serve.admission import (AdmissionController,
                                            AdmissionPolicy,
                                            DeadlineExceededError,
                                            EngineClosedError,
                                            QueueFullError, RequestError,
                                            ServeError, ServeMetrics,
                                            ShedError, ThrottledError)
from jimm_tpu_torch.serve.buckets import (CUDA_BATCH_BUCKETS,
                                          DEFAULT_BATCH_BUCKETS, BucketTable,
                                          default_buckets, pad_batch)
from jimm_tpu_torch.serve.cache import (EmbeddingCache, class_embedding_cache,
                                        prompt_set_key)
from jimm_tpu_torch.serve.client import (CascadeInfo, EmbedResult,
                                         ServeClient, ServeClientError,
                                         ShedClientError,
                                         ThrottledClientError,
                                         encode_image_payload,
                                         parse_cascade_headers)
from jimm_tpu_torch.serve.engine import InferenceEngine, image_forward
from jimm_tpu_torch.serve.server import (ServingServer, ZeroShotService,
                                         decode_image_payload)
from jimm_tpu_torch.serve.topology import (ReplicaForward, TopologyPlan,
                                           build_replica_forwards,
                                           plan_topology)

__all__ = [
    "AdmissionController", "AdmissionPolicy", "BucketTable",
    "CUDA_BATCH_BUCKETS", "CascadeInfo", "DEFAULT_BATCH_BUCKETS",
    "DeadlineExceededError", "EmbedResult", "EmbeddingCache",
    "EngineClosedError", "InferenceEngine", "QueueFullError",
    "ReplicaForward", "RequestError", "ServeClient", "ServeClientError",
    "ServeError", "ServeMetrics", "ServingServer", "ShedClientError",
    "ShedError", "ThrottledClientError", "ThrottledError", "TopologyPlan",
    "ZeroShotService", "build_replica_forwards", "class_embedding_cache",
    "decode_image_payload", "default_buckets", "encode_image_payload",
    "image_forward", "pad_batch", "parse_cascade_headers", "plan_topology",
    "prompt_set_key",
]
