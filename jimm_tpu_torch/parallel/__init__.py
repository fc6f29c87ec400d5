"""Parallelism over ``torch.distributed``: the counterpart of
``jimm_tpu/parallel/``, the ``data``, ``seq``, ``model`` and ``stage``
axes.

- `mesh`: the process group (NCCL or gloo, chosen at setup) and named
  device meshes.
- `comm`: differentiable collectives over a mesh axis, and tensor
  parallelism's conjugate operators.
- `sharding`: the rules presets, ``use_sharding``, ``shard_model`` (full
  copies with averaged gradients, FSDP2, slices over ``model``, a stage's
  blocks), ``shard_batch`` and the sequence axis of the towers.
- `pipeline`: the microbatched GPipe and interleaved schedules over
  ``stage``.
- `ring_attention`, `ulysses`, `seqpar`: attention over a sequence sharded
  across ranks (the seqpar hops on the flash kernels' ring-hop entry
  points).
"""

from jimm_tpu_torch.parallel.mesh import (MESH_AXES, TOPOLOGIES,
                                          initialize_distributed,
                                          make_hybrid_mesh, make_mesh,
                                          make_topology, resolve_mesh_axis,
                                          shutdown_distributed)
from jimm_tpu_torch.parallel.pipeline import (circular_layer_order,
                                              num_ticks, pipeline_forward)
from jimm_tpu_torch.parallel.ring_attention import (ring_attention,
                                                    zigzag_order,
                                                    zigzag_shard,
                                                    zigzag_unshard)
from jimm_tpu_torch.parallel.seqpar import (plan_seq_parallel,
                                            ring_attention_sp,
                                            seq_parallel_attention,
                                            seqpar_comm_bytes)
from jimm_tpu_torch.parallel.sharding import (DATA_PARALLEL, FSDP, FSDP_SP,
                                              FSDP_TP, HYBRID_FSDP_TP,
                                              PIPELINE, PRESET_RULES,
                                              REPLICATED, SEQUENCE_PARALLEL,
                                              TENSOR_PARALLEL, ShardingRules,
                                              current_rules, logical_constraint,
                                              logical_names, prune_spec,
                                              resolve_logical_spec,
                                              shard_batch, shard_model,
                                              use_sharding)
from jimm_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "MESH_AXES", "TOPOLOGIES", "initialize_distributed", "make_hybrid_mesh",
    "make_mesh", "make_topology", "resolve_mesh_axis", "shutdown_distributed",
    "circular_layer_order", "num_ticks", "pipeline_forward",
    "ring_attention", "zigzag_order", "zigzag_shard", "zigzag_unshard",
    "plan_seq_parallel", "ring_attention_sp", "seq_parallel_attention",
    "seqpar_comm_bytes", "ulysses_attention", "ShardingRules",
    "use_sharding", "current_rules", "shard_model", "shard_batch",
    "logical_constraint", "logical_names", "prune_spec",
    "resolve_logical_spec", "REPLICATED", "DATA_PARALLEL", "TENSOR_PARALLEL",
    "FSDP", "FSDP_SP", "FSDP_TP", "HYBRID_FSDP_TP", "SEQUENCE_PARALLEL",
    "PIPELINE", "PRESET_RULES",
]
