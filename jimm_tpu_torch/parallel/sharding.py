"""Sharding by policy: logical axis names and one rules table; the
counterpart of ``jimm_tpu/parallel/sharding.py``.

:class:`ShardingRules` and its presets are JAX's, as data. What GSPMD does
implicitly from them, the port does explicitly:

- parameters: laid out by their specs (:func:`partition_specs`, the one
  description of the layout). Under ``replicated``/``dp``/``sp`` no spec
  shards, so every rank keeps a full copy and the gradients are averaged
  over the mesh (:func:`finish_gradients`); under ``fsdp``/``fsdp_sp`` a
  parameter whose spec shards a dimension over ``data`` becomes an FSDP2
  shard of that dimension, replicated over the other axes
  (:func:`shard_model`). FSDP2 gathers a unit's parameters into plain
  tensors before its forward, so the kernels' ctypes wrappers never see a
  ``DTensor``.
- activations: the batch is this rank's slice (:func:`shard_batch`); under
  a rule that maps ``seq``, a tower whose sequence divides over the ``seq``
  axis runs its encoder on this rank's chunk of the tokens
  (:func:`shard_sequence`), attention crossing the chunks through the
  sequence-parallel schemes, and gathers the tokens back for pooling
  (:func:`gather_sequence`).

The ``model`` and ``stage`` axes (``tp``, ``fsdp_tp``, ``hybrid_fsdp_tp``,
``pp``) are ROADMAP.md queue 1 item 6 part 2.

torch has no ``nnx.with_partitioning``, so the logical names of the port's
parameters are one table (:data:`LOGICAL`, keyed by parameter name) that
follows the JAX modules' ``logical(...)`` calls, in torch's dimension order
(a Linear's weight is ``(out, in)``; JAX's blocks add a leading ``layers``
axis that the port's per-block modules do not have).
"""

from __future__ import annotations

import contextvars
import dataclasses
import math
import re
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from jimm_tpu_torch.parallel import comm
from jimm_tpu_torch.parallel.mesh import mesh_shape

MeshAxis = str | tuple[str, ...] | None
#: a PartitionSpec: one mesh axis (or tuple, or None) per dimension
Spec = tuple[MeshAxis, ...]

#: what part 2 of the parallelism item brings
PART_2 = ("ROADMAP.md queue 1 item 6 part 2 (the model and stage axes: "
          "tensor and pipeline parallelism)")


@dataclass(frozen=True)
class ShardingRules:
    """Logical -> physical mesh-axis mapping."""

    layers: MeshAxis = None
    embed: MeshAxis = None
    heads: MeshAxis = None
    mlp: MeshAxis = None
    vocab: MeshAxis = None
    proj: MeshAxis = None
    classes: MeshAxis = None
    patch: MeshAxis = None
    batch: MeshAxis = None
    seq: MeshAxis = None
    pos: MeshAxis = None

    def spec(self, *names: str | None) -> Spec:
        """The spec of a tuple of logical axis names."""
        return tuple(getattr(self, n) if n is not None else None
                     for n in names)


REPLICATED = ShardingRules()
DATA_PARALLEL = ShardingRules(batch="data")
TENSOR_PARALLEL = ShardingRules(
    heads="model", mlp="model", vocab="model", proj="model",
    classes="model", batch="data")
FSDP = ShardingRules(embed="data", batch="data", mlp=None, heads=None)
FSDP_TP = ShardingRules(
    embed="data", heads="model", mlp="model", vocab="model", proj="model",
    classes="model", batch="data")
HYBRID_FSDP_TP = ShardingRules(
    embed="data", heads="model", mlp="model", vocab="model", proj="model",
    classes="model", batch=("replica", "data"))
SEQUENCE_PARALLEL = ShardingRules(batch="data", seq="seq", pos="seq")
FSDP_SP = ShardingRules(embed="data", batch="data", seq="seq", pos="seq",
                        mlp=None, heads=None)
PIPELINE = ShardingRules(layers="stage", batch="data")

PRESET_RULES: dict[str, ShardingRules] = {
    "replicated": REPLICATED,
    "dp": DATA_PARALLEL,
    "tp": TENSOR_PARALLEL,
    "fsdp": FSDP,
    "fsdp_tp": FSDP_TP,
    "hybrid_fsdp_tp": HYBRID_FSDP_TP,
    "sp": SEQUENCE_PARALLEL,
    "fsdp_sp": FSDP_SP,
    "pp": PIPELINE,
}
#: the presets of part 2
NOT_PORTED = ("tp", "fsdp_tp", "hybrid_fsdp_tp", "pp")

_LOGICAL_AXES = tuple(f.name for f in dataclasses.fields(ShardingRules))

#: (regex over a port parameter name, logical names of its dimensions):
#: the JAX modules' ``logical(...)`` calls in torch's dimension order
LOGICAL: tuple[tuple[str, tuple[str | None, ...]], ...] = (
    (r"attn\.(q|k|v)\.weight$", ("heads", "embed")),
    (r"attn\.(q|k|v)\.bias$", ("heads",)),
    (r"attn\.out\.weight$", ("embed", "heads")),
    (r"attn\.out\.bias$", ("embed",)),
    (r"mlp\.fc1\.weight$", ("mlp", "embed")),
    (r"mlp\.fc1\.bias$", ("mlp",)),
    (r"mlp\.fc2\.weight$", ("embed", "mlp")),
    (r"mlp\.fc2\.bias$", ("embed",)),
    (r"(ln1|ln2|ln_pre|ln_post|ln_final|head\.ln)\.(weight|bias)$",
     ("embed",)),
    (r"patch_embed\.conv\.weight$", ("embed", "patch", "patch", "patch")),
    (r"patch_embed\.conv\.bias$", ("embed",)),
    (r"(cls_token|probe)$", (None, None, "embed")),
    (r"vision\.pos_embed$", (None, "pos", "embed")),
    (r"text\.pos_embed$", ("pos", "embed")),
    (r"token_embed\.weight$", ("vocab", "embed")),
    (r"(visual|text)_projection\.weight$", ("proj", "embed")),
    (r"text_projection\.bias$", ("proj",)),
    (r"classifier\.weight$", ("classes", "embed")),
    (r"classifier\.bias$", ("classes",)),
    (r"logit_(scale|bias)$", ()),
)


def logical_names(name: str) -> tuple[str | None, ...]:
    """The logical axis names of the port parameter ``name``."""
    for pattern, names in LOGICAL:
        if re.search(pattern, name):
            return names
    raise KeyError(f"no logical names for parameter {name!r}")


# ---------------------------------------------------------------------------
# Context: ambient mesh + rules
# ---------------------------------------------------------------------------

_AMBIENT: contextvars.ContextVar[tuple[DeviceMesh | None,
                                       ShardingRules | None]] = \
    contextvars.ContextVar("jimm_sharding", default=(None, None))


def _rules(rules: ShardingRules | str | None) -> ShardingRules | None:
    return PRESET_RULES[rules] if isinstance(rules, str) else rules


@contextmanager
def use_sharding(mesh: DeviceMesh | None,
                 rules: ShardingRules | str | None = None):
    """Install ``mesh`` and ``rules`` as the ambient context: the
    collectives resolve axis names on that mesh, the towers read the
    ``seq`` rule, and ``attention``'s ``"auto"`` routes to the
    sequence-parallel schemes under it."""
    token = _AMBIENT.set((mesh, _rules(rules)))
    try:
        yield
    finally:
        _AMBIENT.reset(token)


def current_rules() -> ShardingRules | None:
    return _AMBIENT.get()[1]


def current_mesh() -> DeviceMesh | None:
    return _AMBIENT.get()[0]


def _sizes(mesh: DeviceMesh | Mapping[str, int]) -> dict[str, int]:
    return dict(mesh) if isinstance(mesh, Mapping) else mesh_shape(mesh)


def prune_spec(spec: Spec, shape: Sequence[int],
               mesh: DeviceMesh | Mapping[str, int]) -> Spec:
    """Drop sharding on dims the mesh (or its ``{"axis": size}``) can't
    divide evenly (a 7-class head over a 2-way axis) -- replicate those dims
    instead."""
    sizes = _sizes(mesh)
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axis is None:
            out.append(None)
            continue
        ways = math.prod(sizes[a] for a in
                         (axis if isinstance(axis, tuple) else (axis,)))
        out.append(axis if dim % ways == 0 else None)
    return tuple(out)


def resolve_logical_spec(spec: Sequence, rules: ShardingRules) -> Spec:
    """Logical axis names in ``spec`` -> physical mesh axes through
    ``rules``; nested tuples flatten, and an axis that resolves to nothing
    is None (replicated)."""
    def resolve_one(a) -> tuple:
        if a is None:
            return ()
        if isinstance(a, tuple):
            out: tuple = ()
            for el in a:
                out += resolve_one(el)
            return out
        if a in _LOGICAL_AXES:
            target = getattr(rules, a)
            if target != a:  # rules.seq == "seq": already physical
                return resolve_one(target)
        return (a,)

    out = []
    for a in tuple(spec):
        r = resolve_one(a)
        out.append(None if not r else (r[0] if len(r) == 1 else r))
    return tuple(out)


def partition_specs(model: nn.Module, mesh: DeviceMesh | Mapping[str, int],
                    rules: ShardingRules | str) -> dict[str, Spec]:
    """Each parameter's spec under ``rules`` on ``mesh``, as JAX's
    ``shard_model`` places it: logical names resolved, then pruned."""
    rules = _rules(rules)
    return {name: prune_spec(resolve_logical_spec(logical_names(name), rules),
                             tuple(p.shape), mesh)
            for name, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# Applying the rules to a model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Plan:
    """What ``shard_model`` left to :func:`finish_gradients`: the
    parameters FSDP2 does not hold (all of them when no spec shards), in
    the model's order, whose gradients are averaged over ``group``, every
    rank of the mesh."""

    group: comm.AxisGroup
    replicated: tuple[nn.Parameter, ...]


def _check_rules(name: str | None, rules: ShardingRules,
                 mesh: DeviceMesh) -> None:
    if name in NOT_PORTED or rules in (TENSOR_PARALLEL, FSDP_TP,
                                       HYBRID_FSDP_TP, PIPELINE):
        raise NotImplementedError(f"sharding rules {name or rules} are not "
                                  f"ported yet: {PART_2}")
    shape = mesh_shape(mesh)
    for axis in ("model", "stage"):
        if shape.get(axis, 1) > 1:
            raise NotImplementedError(f"a mesh {axis!r} axis is not ported "
                                      f"yet: {PART_2}")


def _fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """FSDP2's mesh: shard over ``data``, replicate over the other axes --
    1-D over ``data``, or 2-D ``(replicate, shard)`` (HSDP) when another
    axis (``seq`` under ``fsdp_sp``) has more than one rank."""
    names = list(mesh.mesh_dim_names)
    if "data" not in names:
        raise ValueError(f"FSDP shards over a 'data' axis; mesh "
                         f"{mesh_shape(mesh)} has none")
    rest = [i for i, n in enumerate(names) if n != "data"]
    if math.prod(mesh.mesh.shape[i] for i in rest) == 1:
        return mesh["data"]
    d = names.index("data")
    ranks = mesh.mesh.permute(*rest, d).reshape(-1, mesh.mesh.shape[d])
    return DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=("replicate", "data"))


def _data_dim(spec: Spec) -> int | None:
    """The dimension ``spec`` shards over the ``data`` axis, or None."""
    for dim, axis in enumerate(spec):
        if "data" in comm.axis_names(axis):
            return dim
    return None


def shard_model(model: nn.Module, mesh: DeviceMesh,
                rules: ShardingRules | str = REPLICATED) -> nn.Module:
    """Lay ``model`` out over ``mesh`` per ``rules`` (see the module
    docstring) and record the :class:`Plan` on it. Each parameter's layout
    is its :func:`partition_specs` entry: a parameter whose spec shards a
    dimension over ``data`` (``fsdp``/``fsdp_sp`` put ``embed`` there) is
    an FSDP2 shard of that dimension (``shard_placement_fn``), every other
    one stays whole on every rank (``ignored_params``), its gradient
    averaged by :func:`finish_gradients`. ``fully_shard`` is applied to
    every encoder block, then to every other child that holds parameters
    (the towers with their embeddings, heads and final LayerNorms; the
    projections; a classifier); the root's own parameters (logit scale and
    bias) are 0-d, whole. A ``seq`` entry of a spec (``pos`` under
    ``fsdp_sp``) shards activations, not parameters: the towers cut their
    position embedding to the rank's tokens (:func:`logical_constraint`)."""
    name = rules if isinstance(rules, str) else None
    rules = _rules(rules)
    _check_rules(name, rules, mesh)
    everything = comm.axis_group(tuple(mesh.mesh_dim_names), mesh)
    dims = {p: _data_dim(spec) for p, spec in zip(
        model.parameters(), partition_specs(model, mesh, rules).values())}
    whole = {p for p, d in dims.items() if d is None}
    if len(whole) < len(dims):
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        from jimm_tpu_torch.nn.transformer import Block
        kw = {"mesh": _fsdp_mesh(mesh), "ignored_params": whole,
              "shard_placement_fn": lambda p: Shard(dims[p])}
        for m in model.modules():
            if isinstance(m, Block):
                fully_shard(m, **kw)
        for child in model.children():
            if any(True for _ in child.parameters()):
                fully_shard(child, **kw)
    model._jimm_plan = Plan(everything, tuple(
        p for p in model.parameters() if not isinstance(p, DTensor)))
    return model


def finish_gradients(model: nn.Module) -> None:
    """After the backward: average the gradients of the parameters that
    FSDP2 does not reduce over every rank of the mesh (one all-reduce). A
    no-op for a model ``shard_model`` did not lay out."""
    plan: Plan | None = getattr(model, "_jimm_plan", None)
    if plan is None:
        return
    grads = [p.grad for p in plan.replicated if p.grad is not None]
    comm.all_reduce_mean_(grads, plan.group)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of an FSDP2 ``DTensor`` (``t`` itself when plain),
    gathered with c10d's ``all_gather_into_tensor`` over each mesh dim
    that shards it (``torch.chunk``'s uneven pieces padded to one size):
    ``DTensor.full_tensor()`` goes through functional collectives, which
    crash under gloo on CUDA tensors (a segmentation fault on the H100's
    machine, torch 2.11). Every rank of the mesh must call it."""
    if not isinstance(t, DTensor):
        return t
    whole = t.to_local()
    for mdim, placement in enumerate(t.placements):
        if not placement.is_shard():
            continue
        group = t.device_mesh.get_group(mdim)
        ways = torch.distributed.get_world_size(group)
        sizes = [len(c) for c in torch.arange(t.shape[placement.dim]).chunk(
            ways)]
        sizes += [0] * (ways - len(sizes))
        piece = whole.movedim(placement.dim, 0)
        rows = max(sizes)
        padded = torch.cat([piece, piece.new_zeros(
            (rows - piece.shape[0], *piece.shape[1:]))]).contiguous()
        out = padded.new_empty((ways * rows, *piece.shape[1:]))
        torch.distributed.all_gather_into_tensor(out, padded, group=group)
        whole = torch.cat([out[r * rows:r * rows + n]
                           for r, n in enumerate(sizes)]).movedim(
                               0, placement.dim)
    return whole


def shard_batch(batch: Any, mesh: DeviceMesh,
                rules: ShardingRules | str = DATA_PARALLEL) -> Any:
    """This rank's slice of a global host batch: the leading dimension of
    every leaf (a nested tuple/list/dict of arrays or tensors) split over
    ``rules.batch``'s axes in their linear order."""
    rules = _rules(rules)
    if rules.batch is None:
        return batch
    grp = comm.axis_group(rules.batch, mesh)

    def take(x):
        if isinstance(x, (tuple, list)):
            return type(x)(take(v) for v in x)
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        n = x.shape[0]
        if n % grp.size:
            raise ValueError(f"batch {n} not divisible by {grp.size} ranks")
        step = n // grp.size
        return x[grp.index * step:(grp.index + 1) * step]

    return take(batch)


# ---------------------------------------------------------------------------
# The sequence axis
# ---------------------------------------------------------------------------

#: the mesh axis the current activations' sequence is sharded over (set
#: by the towers around their encoder), or None
_SEQUENCE: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "jimm_sequence_axis", default=None)


def shard_sequence(length: int) -> str | None:
    """The mesh axis a tower of ``length`` tokens shards its sequence
    over: the ambient rules' ``seq`` axis when it has more than one rank
    and divides ``length``; else None, and the tower runs whole on every
    rank, as JAX's ``"auto"`` falls through to the single-chip path."""
    mesh, rules = _AMBIENT.get()
    if mesh is None or rules is None or not isinstance(rules.seq, str):
        return None
    size = mesh_shape(mesh).get(rules.seq, 1)
    if size <= 1 or length % size:
        return None
    return rules.seq


def sharded_sequence_axis() -> str | None:
    """The axis the current activations' sequence is sharded over."""
    return _SEQUENCE.get()


@contextmanager
def sequence_sharded(axis: str | None):
    token = _SEQUENCE.set(axis)
    try:
        yield
    finally:
        _SEQUENCE.reset(token)


def logical_constraint(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """JAX's activation constraint. A no-op in the port except on the
    sequence axis: where ``names`` puts ``"seq"`` on a dimension that the
    ambient rules shard (:func:`shard_sequence`), this rank's chunk of that
    dimension."""
    if "seq" not in names:
        return x
    dim = names.index("seq")
    axis = shard_sequence(x.shape[dim])
    if axis is None:
        return x
    grp = comm.axis_group(axis)
    return x.chunk(grp.size, dim=dim)[grp.index]


def gather_sequence(x: torch.Tensor, axis: str | None) -> torch.Tensor:
    """The whole ``(B, S, ...)`` sequence from every rank's chunk along
    ``axis`` (differentiable: the backward reduce-scatters); ``x`` itself
    when ``axis`` is None."""
    return x if axis is None else comm.all_gather(x, axis, dim=1)
