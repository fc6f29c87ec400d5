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
- the ``model`` axis (``tp``, ``fsdp_tp``, ``hybrid_fsdp_tp``): a
  parameter whose spec puts ``model`` on a dimension is replaced by this
  rank's slice of it, a plain parameter of the local shape, and its module
  runs Megatron-style on `comm.py`'s tensor-parallel operators:
  column-parallel q/k/v and fc1 (``tp_copy``; the attention on
  ``num_heads / model`` local heads), row-parallel attention out and fc2
  (``tp_row_linear``: partial products summed in f32, the bias added
  once), a vocab-parallel token embedding (``tp_reduce``), and
  projections and a classifier whose sharded outputs are gathered
  (``tp_gather``). Under ``fsdp_tp`` FSDP2 shards each local
  slice further on its ``data`` dimension, over the ``data`` ranks of its
  ``model`` position (HSDP over ``replica`` under ``hybrid_fsdp_tp``).
- the ``stage`` axis (``pp``): a pipelined encoder (``cfg.pipeline``)
  keeps only the blocks this stage runs (`parallel/pipeline.py`), under
  their global names.
- activations: the batch is this rank's slice (:func:`shard_batch`); under
  a rule that maps ``seq``, a tower whose sequence divides over the ``seq``
  axis runs its encoder on this rank's chunk of the tokens
  (:func:`shard_sequence`), attention crossing the chunks through the
  sequence-parallel schemes, and gathers the tokens back for pooling
  (:func:`gather_sequence`).

Gradients: ranks that saw different examples (every axis but ``model`` and
``stage``) average them (:func:`finish_gradients`, FSDP2's
reduce-scatter). The fp8 policy's amaxes are maxima over every axis but
``stage`` (``quant.policy.Fp8Linear.amax_group``, set here;
:func:`finish_gradients` rolls the histories). Ranks along ``model`` and ``stage`` already hold the
whole gradient of what they hold (see `comm.py` and `pipeline.py`).
:func:`gather_whole` and :func:`local_piece` move between the local and
the whole tensors (checkpoints), :func:`norm_groups` says over which ranks
a gradient's square sums (the global norm).

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
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from jimm_tpu_torch.parallel import comm
from jimm_tpu_torch.parallel.mesh import mesh_shape

MeshAxis = str | tuple[str, ...] | None
#: a PartitionSpec: one mesh axis (or tuple, or None) per dimension
Spec = tuple[MeshAxis, ...]

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
#: the presets that use the model or stage axis
MODEL_STAGE_RULES = ("tp", "fsdp_tp", "hybrid_fsdp_tp", "pp")

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
    """What ``shard_model`` left to the training step and the checkpoints.

    - ``group``: the ranks that saw different examples (every mesh axis but
      ``model`` and ``stage``), over which ``replicated`` -- the parameters
      FSDP2 does not hold, in the model's order -- have their gradients
      averaged.
    - ``model``: this rank's ``model`` group (None: no model axis), and
      ``tp_dims`` the dimension each of its sliced parameters is cut on.
    - ``stage``: this rank's ``stage`` group (None: no stage axis), and
      ``pipelined`` each pipelined encoder's block-name prefix with the
      blocks every stage holds (position order).
    - ``names``: the whole model's parameter names, in order."""

    group: comm.AxisGroup
    replicated: tuple[nn.Parameter, ...]
    model: comm.AxisGroup | None = None
    tp_dims: Mapping[str, int] = dataclasses.field(default_factory=dict)
    stage: comm.AxisGroup | None = None
    pipelined: tuple[tuple[str, tuple[tuple[int, ...], ...]], ...] = ()
    names: tuple[str, ...] = ()


def fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """FSDP2's mesh: shard over ``data``, replicate over the other axes --
    1-D over ``data``, or 2-D ``(replicate, shard)`` (HSDP) when another
    axis (``seq`` under ``fsdp_sp``, ``replica`` under ``hybrid_fsdp_tp``)
    has more than one rank; one such mesh per ``model`` position, whose
    ranks hold different slices. Made once per mesh (its groups are a
    collective of every rank, see ``comm.prepare_groups``)."""
    made = mesh.__dict__.get("_jimm_fsdp_mesh")
    if made is None:
        made = mesh.__dict__["_jimm_fsdp_mesh"] = _fsdp_mesh(mesh)
    return made


def _fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    names = list(mesh.mesh_dim_names)
    if "data" not in names:
        raise ValueError(f"FSDP shards over a 'data' axis; mesh "
                         f"{mesh_shape(mesh)} has none")
    shape = mesh_shape(mesh)
    d = names.index("data")
    rest = [i for i, n in enumerate(names) if n not in ("data", "model")]
    n_rest = math.prod(mesh.mesh.shape[i] for i in rest)
    if shape.get("model", 1) == 1:
        if n_rest == 1:
            return mesh["data"]
        ranks = mesh.mesh.permute(
            *[i for i in range(len(names)) if i != d], d).reshape(
                -1, shape["data"])
        return DeviceMesh(mesh.device_type, ranks,
                          mesh_dim_names=("replicate", "data"))
    m = names.index("model")
    ranks = mesh.mesh.permute(m, *rest, d).reshape(
        shape["model"], n_rest, shape["data"])
    full = DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=("model", "replicate", "data"))
    return full["data"] if n_rest == 1 else full["replicate", "data"]


def _data_dim(spec: Spec) -> int | None:
    """The dimension ``spec`` shards over the ``data`` axis, or None."""
    for dim, axis in enumerate(spec):
        if "data" in comm.axis_names(axis):
            return dim
    return None


def _model_dim(spec: Spec) -> int | None:
    """The dimension ``spec`` shards over the ``model`` axis, or None."""
    for dim, axis in enumerate(spec):
        if "model" in comm.axis_names(axis):
            return dim
    return None


def _split_model(model: nn.Module, specs: dict[str, Spec],
                 grp: comm.AxisGroup) -> dict[str, int]:
    """Replace every parameter whose spec shards a dimension over ``model``
    by this rank's slice of it, and mark the modules that compute on the
    slices (their ``tp`` group); returns each sliced parameter's
    dimension."""
    from jimm_tpu_torch.nn.transformer import Attention, Mlp
    from jimm_tpu_torch.quant.policy import Fp8Linear
    dims: dict[str, int] = {}
    for prefix, module in model.named_modules():
        for pname, p in list(module.named_parameters(recurse=False)):
            full = f"{prefix}.{pname}" if prefix else pname
            dim = _model_dim(specs[full])
            if dim is None:
                continue
            # a dense slice: a column slice's view strides by the whole
            # row, which the fp8 GEMM's TMA operands may not
            piece = p.detach().chunk(grp.size, dim)[grp.index].clone(
                memory_format=torch.contiguous_format)
            setattr(module, pname, nn.Parameter(
                piece, requires_grad=p.requires_grad))
            dims[full] = dim
    inner = set()  # the projections an Attention or Mlp runs itself
    for prefix, module in model.named_modules():
        if not isinstance(module, (Attention, Mlp)):
            continue
        inner.update(f"{prefix}.{name}" for name, _ in module.named_children())
        first = "q" if isinstance(module, Attention) else "fc1"
        if f"{prefix}.{first}.weight" not in dims:
            continue
        if isinstance(module, Attention) and module.num_heads % grp.size:
            raise ValueError(f"{prefix}: {module.num_heads} heads do not "
                             f"split over a {grp.size}-way model axis")
        module.tp = grp
    for prefix, module in model.named_modules():
        # a projection, the classifier or the token embedding
        if (isinstance(module, (nn.Linear, nn.Embedding, Fp8Linear))
                and prefix not in inner and dims.get(f"{prefix}.weight") == 0):
            module.tp = grp
    return dims


def _split_stages(model: nn.Module, grp: comm.AxisGroup
                  ) -> tuple[tuple[str, tuple[tuple[int, ...], ...]], ...]:
    """Keep, in every pipelined encoder, only the blocks this stage runs
    (:func:`pipeline.held_layers`), under their global names; returns each
    pipelined encoder's block prefix with every stage's blocks."""
    from jimm_tpu_torch.nn.transformer import Transformer
    from jimm_tpu_torch.parallel.pipeline import held_layers
    out = []
    for prefix, module in model.named_modules():
        if not (isinstance(module, Transformer) and module.cfg.pipeline):
            continue
        cfg = module.cfg
        held = tuple(tuple(sum(held_layers(cfg.depth, grp.size,
                                           cfg.pp_virtual, d), []))
                     for d in range(grp.size))
        module.keep_blocks(held[grp.index])
        out.append((f"{prefix}.blocks.", held))
    return tuple(out)


def shard_model(model: nn.Module, mesh: DeviceMesh,
                rules: ShardingRules | str = REPLICATED) -> nn.Module:
    """Lay ``model`` out over ``mesh`` per ``rules`` (see the module
    docstring) and record the :class:`Plan` on it. Each parameter's layout
    is its :func:`partition_specs` entry, taken on the whole model: a
    dimension on ``model`` is sliced here; then a parameter whose spec
    shards a dimension over ``data`` (``fsdp``, ``fsdp_sp`` and the tp
    presets put ``embed`` there) is an FSDP2 shard of that dimension of
    its slice (``shard_placement_fn``), every other one stays whole on
    every rank (``ignored_params``), its gradient averaged by
    :func:`finish_gradients`. ``fully_shard`` is applied to every encoder
    block, then to every other child that holds parameters (the towers
    with their embeddings, heads and final LayerNorms; the projections; a
    classifier); the root's own parameters (logit scale and bias) are 0-d,
    whole. A ``seq`` entry of a spec (``pos`` under ``fsdp_sp``) shards
    activations, not parameters: the towers cut their position embedding
    to the rank's tokens (:func:`logical_constraint`). A mesh with a
    ``stage`` axis of more than one rank leaves each pipelined encoder the
    blocks its stage runs."""
    rules = _rules(rules)
    shape = mesh_shape(mesh)
    specs = partition_specs(model, mesh, rules)
    names = tuple(specs)
    tp = stage = None
    tp_dims: dict[str, int] = {}
    pipelined: tuple = ()
    if shape.get("model", 1) > 1:
        tp = comm.axis_group("model", mesh)
        tp_dims = _split_model(model, specs, tp)
    if shape.get("stage", 1) > 1:
        stage = comm.axis_group("stage", mesh)
        pipelined = _split_stages(model, stage)
    examples = comm.axis_group(tuple(
        a for a in mesh.mesh_dim_names if a not in ("model", "stage")), mesh)
    _fp8_amax_group(model, mesh)
    own = dict(model.named_parameters())
    dims = {own[n]: _data_dim(specs[n]) for n in own}
    whole = {p for p, d in dims.items() if d is None}
    if len(whole) < len(dims):
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        from jimm_tpu_torch.nn.transformer import Block
        kw = {"mesh": fsdp_mesh(mesh), "ignored_params": whole,
              "shard_placement_fn": lambda p: Shard(dims[p])}
        for m in model.modules():
            if isinstance(m, Block):
                fully_shard(m, **kw)
        for child in model.children():
            if any(True for _ in child.parameters()):
                fully_shard(child, **kw)
    model._jimm_plan = Plan(
        examples, tuple(p for p in model.parameters()
                        if not isinstance(p, DTensor)),
        tp, tp_dims, stage, pipelined, names)
    return model


def _fp8_amax_group(model: nn.Module, mesh: DeviceMesh) -> None:
    """Give every fp8 policy module the ranks its amaxes are the max over:
    every mesh axis but ``stage`` (over an axis that replicates a tensor
    the max changes nothing; each stage holds other blocks)."""
    from jimm_tpu_torch.quant.policy import Fp8Linear
    mods = [m for m in model.modules() if isinstance(m, Fp8Linear)]
    if mods:
        grp = comm.axis_group(tuple(a for a in mesh.mesh_dim_names
                                    if a != "stage"), mesh)
        for m in mods:
            m.amax_group = grp


def plan_of(model: nn.Module) -> Plan | None:
    """The :class:`Plan` ``shard_model`` recorded on ``model``, or None."""
    return getattr(model, "_jimm_plan", None)


def finish_gradients(model: nn.Module) -> None:
    """After the backward: average the gradients of the parameters that
    FSDP2 does not reduce over the ranks that saw different examples (one
    all-reduce), and roll the fp8 policy modules' amax histories with the
    step's maxima over the mesh (``quant.policy.sync_amax_histories``, one
    all-reduce). A no-op for a model ``shard_model`` did not lay out."""
    plan = plan_of(model)
    if plan is None:
        return
    from jimm_tpu_torch.quant.policy import sync_amax_histories
    sync_amax_histories(model)
    grads = [p.grad for p in plan.replicated if p.grad is not None]
    comm.all_reduce_mean_(grads, plan.group)


def _block_of(plan: Plan, name: str) -> tuple[int, int, str] | None:
    """``(encoder, block, rest)`` of a pipelined encoder's block parameter
    ``name`` (the encoder's position in ``plan.pipelined``), or None."""
    for e, (prefix, _) in enumerate(plan.pipelined):
        if name.startswith(prefix):
            block, _, rest = name[len(prefix):].partition(".")
            return e, int(block), rest
    return None


def norm_groups(model: nn.Module, name: str) -> tuple[comm.AxisGroup, ...]:
    """The groups over which the square of parameter ``name``'s gradient
    sums into the global norm, besides the FSDP2 shards' own: ``model``
    for a sliced parameter, ``stage`` for a pipelined block's (each stage
    holds other blocks); none for a parameter every rank of those axes
    holds whole."""
    plan = plan_of(model)
    if plan is None:
        return ()
    out = ()
    if name in plan.tp_dims:
        out += (plan.model,)
    if plan.stage is not None and _block_of(plan, name) is not None:
        out += (plan.stage,)
    return out


def whole_names(model: nn.Module) -> tuple[str, ...]:
    """The whole model's parameter names, every stage's blocks included."""
    plan = plan_of(model)
    if plan is None or not plan.names:
        return tuple(n for n, _ in model.named_parameters())
    return plan.names


def whole_shape(model: nn.Module, name: str, shape: Sequence[int]
                ) -> tuple[int, ...]:
    """The whole shape of parameter ``name`` (or of a state tensor of its
    shape) whose local tensor has ``shape``."""
    plan = plan_of(model)
    shape = list(shape)
    if plan is not None and name in plan.tp_dims and shape:
        shape[plan.tp_dims[name]] *= plan.model.size
    return tuple(shape)


def local_piece(model: nn.Module, name: str, whole: torch.Tensor
                ) -> torch.Tensor:
    """This rank's slice of the whole tensor of parameter ``name`` (or of
    a state tensor of its shape) over ``model``; ``whole`` itself
    otherwise. An FSDP2 shard is cut from it afterwards."""
    plan = plan_of(model)
    if plan is None or name not in plan.tp_dims or not whole.ndim:
        return whole
    grp = plan.model
    return whole.chunk(grp.size, plan.tp_dims[name])[grp.index]


def gather_whole(model: nn.Module, tensors: Mapping[str, torch.Tensor],
                 param_of=lambda key: key) -> dict[str, torch.Tensor]:
    """The whole tensors of this rank's ``tensors`` (parameters, or
    optimizer state keyed so that ``param_of(key)`` is the parameter's
    name): FSDP2 shards gathered (:func:`full_tensor`), model slices
    gathered along their dimension, and every stage's pipelined blocks
    broadcast from their stage (``dist.broadcast``, which gloo carries on
    the card), under their global names. A collective: every rank of the
    mesh calls it with the same keys but for the blocks' indices."""
    plan = plan_of(model)
    out = {k: full_tensor(t.detach()) for k, t in tensors.items()}
    if plan is None:
        return out
    if plan.model is not None:
        for k, t in out.items():
            name = param_of(k)
            if name in plan.tp_dims and t.ndim:
                out[k] = comm._gather(t, plan.model, plan.tp_dims[name])
    if plan.stage is None:
        return out
    grp = plan.stage
    held: dict[int, list[tuple[int, str, str]]] = {}
    for k in list(out):
        where = _block_of(plan, param_of(k))
        if where is not None:
            e, block, _ = where
            stages = plan.pipelined[e][1]
            j = stages[grp.index].index(block)
            rest = k[len(plan.pipelined[e][0]) + len(str(block)) + 1:]
            held.setdefault(e, []).append((j, rest, k))
    device = next(model.parameters()).device
    for e, entries in sorted(held.items()):
        prefix, stages = plan.pipelined[e]
        entries.sort()
        mine = {k: out.pop(k) for _, _, k in entries}
        for s in range(grp.size):
            for j, rest, k in entries:
                t = mine[k]
                buf = (t if s == grp.index else torch.empty_like(t)).to(
                    device)
                dist.broadcast(buf, src=grp.ranks[s], group=grp.pg)
                out[f"{prefix}{stages[s][j]}.{rest}"] = buf.to(t.device)
    return out


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


def gathered_linear(linear: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``linear(x)``; for a linear whose ``tp`` group holds slices of its
    output features (a projection or the classifier on a ``model`` axis),
    the slices' outputs gathered whole on every rank of the group."""
    grp = getattr(linear, "tp", None)
    if grp is None:
        return linear(x)
    return comm.tp_gather(linear(comm.tp_copy(x, grp)), grp, dim=-1)


def vocab_embedding(embed: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """``embed(ids)``; for an embedding whose ``tp`` group holds slices of
    the vocabulary, each rank looks up the ids in its slice (zeros for the
    others) and the group sums the lookups."""
    grp = getattr(embed, "tp", None)
    if grp is None:
        return embed(ids)
    rows = embed.weight.shape[0]
    local = ids - grp.index * rows
    mine = (local >= 0) & (local < rows)
    x = embed(torch.where(mine, local, 0)) * mine.unsqueeze(-1).to(
        embed.weight.dtype)
    return comm.tp_reduce(x, grp)


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
