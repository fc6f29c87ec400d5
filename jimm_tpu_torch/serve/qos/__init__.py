"""``jimm_tpu_torch.serve.qos`` — multi-tenant QoS serving control plane;
the counterpart of ``jimm_tpu/serve/qos/``.

A policy layer above the engine's replica-dispatch data plane: tenant
identity with token-bucket rate limits and quotas (:mod:`.policy`),
per-class weighted-fair (deficit-round-robin) dequeue with class-ordered
shedding (:mod:`.scheduler`), and multi-model residency on one topology
(:mod:`.pool`). Everything here is control plane: the hot compiled path —
buckets, replica executors, kernels — is untouched, and with no policy
configured the engine runs its original single-FIFO semantics.

``policy`` and ``cli`` are stdlib-only (no torch, no numpy) so the ``qos``
command works from any process.
"""

from jimm_tpu_torch.serve.qos.policy import (ClassSpec, QosPolicyError,
                                       TenantRegistry, TenantSpec,
                                       load_policy)
from jimm_tpu_torch.serve.qos.pool import ModelPool
from jimm_tpu_torch.serve.qos.scheduler import (QosScheduler, TokenBucket,
                                          WeightedFairQueue)

__all__ = [
    "ClassSpec", "ModelPool", "QosPolicyError", "QosScheduler",
    "TenantRegistry", "TenantSpec", "TokenBucket", "WeightedFairQueue",
    "load_policy",
]
