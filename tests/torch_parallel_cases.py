"""What the ranks of the port's parallel tests run (``torch_rank_pool``):
module-level functions of numpy inputs that return numpy results, so the
test processes (which hold JAX) compare them. Nothing here imports JAX."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from jimm_tpu_torch.parallel import comm, seqpar
from jimm_tpu_torch.parallel.mesh import make_mesh
from jimm_tpu_torch.parallel.ring_attention import ring_attention
from jimm_tpu_torch.parallel.ulysses import ulysses_attention
from jimm_tpu_torch.train import losses


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(t: torch.Tensor | None):
    return None if t is None else t.detach().cpu().numpy()


# -- collectives ------------------------------------------------------------

def collectives(axes: dict, axis, x: np.ndarray, w: np.ndarray) -> dict:
    """Each collective on this rank's piece of ``x`` (its position's row
    block along the axis) and the gradient of ``sum(w_piece * y)``; the
    test rebuilds the dense answers."""
    mesh = make_mesh(axes)
    grp = comm.axis_group(axis, mesh)
    n, i = grp.size, grp.index
    rows = x.shape[0] // n
    mine = _t(x[i * rows:(i + 1) * rows]).requires_grad_()
    out = {"index": i, "size": n}
    cases = {
        "ppermute": lambda t: comm.ppermute(t, axis,
                                            comm.ring_perm(n, 1), mesh=mesh),
        "ppermute_partial": lambda t: comm.ppermute(t, axis, [(0, n - 1)],
                                                    mesh=mesh),
        "all_gather": lambda t: comm.all_gather(t, axis, dim=1, mesh=mesh),
        "all_to_all": lambda t: comm.all_to_all(t, axis, split_dim=1,
                                                concat_dim=0, mesh=mesh),
        "psum": lambda t: comm.psum(t, axis, mesh=mesh),
    }
    for name, fn in cases.items():
        y = fn(mine)
        wy = _t(w[:y.numel()].reshape(y.shape) + i)
        (g,) = torch.autograd.grad((y * wy).sum(), mine)
        out[name] = (_np(y), _np(g), _np(wy))
    return out


def layouts(batch: np.ndarray) -> dict:
    """``make_hybrid_mesh`` and ``shard_batch`` on this rank: the mesh's
    dims and shape, and this rank's rows of ``batch`` under ``dp`` (the
    ``data`` axis) and ``hybrid_fsdp_tp``'s batch axes."""
    from jimm_tpu_torch.parallel import sharding
    from jimm_tpu_torch.parallel.mesh import make_hybrid_mesh, mesh_shape
    mesh = make_hybrid_mesh({"data": 2}, {"replica": 2})
    return {"shape": mesh_shape(mesh), "rank": dist.get_rank(),
            "dp": sharding.shard_batch({"x": batch, "y": (batch, batch)},
                                       mesh, "dp"),
            "pair": sharding.shard_batch(batch, mesh,
                                         sharding.HYBRID_FSDP_TP)}


# -- ring losses --------------------------------------------------------------

def ring_loss(axes: dict, axis, kind: str, x_img, x_txt, w_img, w_txt,
              scale, bias) -> dict:
    """The ring loss of ``(x @ w)`` embeddings over ``axis``, this rank's
    rows of the batch; the loss and this rank's parameter gradients."""
    mesh = make_mesh(axes)
    grp = comm.axis_group(axis, mesh)
    rows = x_img.shape[0] // grp.size
    sl = slice(grp.index * rows, (grp.index + 1) * rows)
    params = [_t(p).requires_grad_() for p in (w_img, w_txt, scale, bias)]
    img = _t(x_img[sl]) @ params[0]
    txt = _t(x_txt[sl]) @ params[1]
    if kind == "siglip_ring":
        loss = losses.ring_sigmoid_loss(img, txt, params[2], params[3],
                                        mesh=mesh, axis_name=axis)
    else:
        loss = losses.ring_clip_infonce_loss(img, txt, params[2], mesh=mesh,
                                             axis_name=axis)
    loss.backward()
    return {"loss": float(loss), "ring": grp.ranks,
            "grads": [_np(p.grad) if p.grad is not None else None
                      for p in params]}


# -- attention ------------------------------------------------------------------

def attention(scheme: str, q, k, v, do, mask=None, **kw) -> dict:
    """One sequence-parallel scheme over a ``seq`` axis of every rank, on
    this rank's chunk of the global q/k/v/mask, backward with its chunk of
    ``do``: this rank's chunks of o, dq, dk, dv."""
    mesh = make_mesh({"seq": dist.get_world_size()})
    grp = comm.axis_group("seq", mesh)
    s = q.shape[1] // grp.size
    sl = slice(grp.index * s, (grp.index + 1) * s)
    qkv = [_t(x[:, sl]).requires_grad_() for x in (q, k, v)]
    m = None if mask is None else _t(mask[:, sl])
    if scheme == "ring_sp":
        o = seqpar.ring_attention_sp(*qkv, mask=m, mesh=mesh, **kw)
    elif scheme == "ulysses":
        o = ulysses_attention(*qkv, mask=m, mesh=mesh, **kw)
    elif scheme == "ring":
        o = ring_attention(*qkv, mesh=mesh, **kw)
    else:
        raise ValueError(scheme)
    o.backward(_t(do[:, sl]))
    return {"o": _np(o), "grads": [_np(x.grad) for x in qkv]}


# -- the train command ------------------------------------------------------------

def fsdp_layout(preset_name: str, rules: str) -> dict:
    """A tiny ``preset_name`` laid out by ``shard_model`` over a ``data``
    mesh of every rank: each parameter's spec (``partition_specs``, taken
    first), the dimension FSDP2 shards it on (None: whole on this rank),
    and the parameters whose gradients ``finish_gradients`` averages."""
    from torch.distributed.tensor import DTensor

    from jimm_tpu_torch import cli
    from jimm_tpu_torch.configs import preset
    from jimm_tpu_torch.parallel import sharding
    model = cli.MODELS[cli.family(preset_name)](
        cli.tiny_override(preset(preset_name)), device="cpu")
    mesh = make_mesh({"data": dist.get_world_size()})
    specs = sharding.partition_specs(model, mesh, rules)
    names = {id(p): n for n, p in model.named_parameters()}
    sharding.shard_model(model, mesh, rules)
    dims = {n: (p.placements[0].dim if isinstance(p, DTensor) else None)
            for n, p in model.named_parameters()}
    from jimm_tpu_torch.train.trainer import OptimizerConfig, make_optimizer
    opt = make_optimizer(model, OptimizerConfig())
    return {"specs": specs, "dims": dims, "averaged": [
        names[id(p)] for p in model._jimm_plan.replicated],
        # (DTensor, plain) parameters in each optimizer group
        "groups": [(sum(isinstance(p, DTensor) for p in g["params"]),
                    sum(not isinstance(p, DTensor) for p in g["params"]))
                   for g in opt.opt.param_groups]}


def train_cli(argv: list[str], weights: dict | None = None) -> dict:
    """``python -m jimm_tpu_torch <argv>`` on this rank (inside the pool's
    group), the tiny preset started from ``weights`` (a JAX model's
    parameters: the two packages seed differently); the return code and
    the ring bytes and the checkpoint topology changes this rank
    counted."""
    from jimm_tpu_torch import cli, obs
    from jimm_tpu_torch.models.common import load_jax_params
    real = cli.build_run_model

    def from_jax(spec, *a, **kw):
        model, fresh = real(spec, *a, **kw)
        if weights is not None:
            load_jax_params(model, weights)
        return model, fresh

    cli.build_run_model = from_jax
    obs.reset_journal()
    ring = obs.get_registry("jimm_ring").counter(
        "jimm_ring_bytes_permuted_total")
    topology = obs.get_registry("jimm_train").counter(
        "checkpoint_topology_changes_total")
    before = ring.value, topology.value
    try:
        rc = cli.main(argv)
    finally:
        cli.build_run_model = real
    return {"rc": rc, "ring_bytes": ring.value - before[0],
            "topology_changes": topology.value - before[1]}


# -- the model and stage axes -------------------------------------------------

def tiny_model(preset_name: str, runtime: dict | None = None,
               weights: dict | None = None, num_classes: int | None = None,
               precision: str | None = None):
    """The tiny ``preset_name`` on the CPU with the towers' ``runtime``
    fields, from ``weights`` (a JAX model's parameters) when given, else
    seeded as every process seeds it; a ViT's zero classifier drawn from
    seed 1 (a zero head passes no gradient upstream); then the
    ``precision`` policy's surgery, as the train command orders it."""
    import dataclasses

    from jimm_tpu_torch import cli
    from jimm_tpu_torch.configs import preset, with_runtime
    from jimm_tpu_torch.models.common import load_jax_params
    cfg = cli.tiny_override(preset(preset_name))
    if runtime:
        cfg = with_runtime(cfg, **runtime)
    if num_classes:
        cfg = dataclasses.replace(cfg, num_classes=num_classes)
    model = cli.MODELS[cli.family(preset_name)](cfg, device="cpu")
    if weights is not None:
        load_jax_params(model, weights)
    elif hasattr(model, "classifier"):
        with torch.no_grad():
            model.classifier.weight.normal_(
                0.0, 0.1, generator=torch.Generator().manual_seed(1))
    if precision:
        from jimm_tpu_torch.quant.policy import apply_precision_policy
        apply_precision_policy(model, precision)
    return model


def step0_gradients(model, images, target, *, mesh=None, rules=None,
                    kind: str = "siglip") -> dict:
    """One loss and backward of ``model`` on the global batch ``(images,
    target)`` (this rank's rows of it on a mesh), the gradients finished as
    the train step finishes them; each parameter's whole gradient norm (f32),
    the global norm the clip computes, and the loss."""
    from jimm_tpu_torch.parallel import sharding
    from jimm_tpu_torch.train import trainer
    x, y = _t(images), _t(target).long()
    ctx = (sharding.use_sharding(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    with ctx:
        if mesh is not None:
            x, y = sharding.shard_batch((x, y), mesh, rules)
        if kind == "classifier":
            loss = trainer.classifier_metrics(
                trainer.encode_batch(model, x), y)["loss"]
        else:
            loss = trainer.contrastive_loss_fn(model, x, y, kind=kind,
                                               mesh=mesh)
        loss.backward()
        sharding.finish_gradients(model)
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        whole = sharding.gather_whole(model, grads)
        opt = trainer.make_optimizer(model, trainer.OptimizerConfig())
        norm = trainer.clip_by_global_norm_(opt.params, 1e30,
                                            opt.norm_groups)
    return {"norms": {n: float(t.float().norm()) for n, t in whole.items()},
            "global_norm": float(norm), "loss": float(loss.detach())}


def mesh_gradients(preset_name: str, axes: dict, rules: str, images, target,
                   weights: dict | None = None, runtime: dict | None = None,
                   kind: str = "siglip", num_classes: int | None = None,
                   precision: str | None = None) -> dict:
    """:func:`step0_gradients` of the tiny model laid out by
    ``shard_model`` over ``axes`` under ``rules``, with each parameter's
    local shape and whether it is an FSDP2 shard."""
    from torch.distributed.tensor import DTensor

    from jimm_tpu_torch.parallel import sharding
    from jimm_tpu_torch.ops import fp8_matmul as fp8
    model = tiny_model(preset_name, runtime, weights, num_classes, precision)
    mesh = make_mesh(axes)
    sharding.shard_model(model, mesh, rules)
    real, dense = fp8.fp8_gemm, []

    def spy(a_q, b_q, *args, **kwargs):
        # the card's kernel takes dense operands only
        dense.append(a_q.is_contiguous() and b_q.is_contiguous())
        return real(a_q, b_q, *args, **kwargs)

    fp8.fp8_gemm = spy
    try:
        out = step0_gradients(model, images, target, mesh=mesh,
                              rules=rules, kind=kind)
    finally:
        fp8.fp8_gemm = real
    out["fp8_dense"] = dense
    out["local"] = {n: (tuple(p.to_local().shape) if isinstance(p, DTensor)
                        else tuple(p.shape), isinstance(p, DTensor))
                    for n, p in model.named_parameters()}
    out["dense"] = {n: (p.to_local() if isinstance(p, DTensor)
                        else p).is_contiguous()
                    for n, p in model.named_parameters()}
    return out


def pipeline_small(x, w, b, dout, n_micro: int, n_virtual: int) -> dict:
    """``pipeline_forward`` over a ``stage`` axis of every rank on a stack
    of ``tanh(h @ w[l] + b[l])`` layers (``w``: (L, F, F), layers in
    natural order), backward with ``dout``: the output, the input's
    gradient and the whole gradients of ``w`` and ``b`` (each stage's
    layers' summed over the stages)."""
    from jimm_tpu_torch.parallel.pipeline import held_layers, pipeline_forward
    mesh = make_mesh({"stage": dist.get_world_size()})
    grp = comm.axis_group("stage", mesh)
    xt = _t(x).requires_grad_()
    wt, bt = _t(w).requires_grad_(), _t(b).requires_grad_()
    chunks = held_layers(w.shape[0], grp.size, n_virtual, grp.index)

    def stage_apply(v, h):
        for layer in chunks[v]:
            h = torch.tanh(h @ wt[layer] + bt[layer])
        return h

    out = pipeline_forward(stage_apply, xt, n_microbatches=n_micro,
                           n_virtual=n_virtual, axis=grp, params=[wt, bt])
    out.backward(_t(dout))
    for g in (wt.grad, bt.grad):
        dist.all_reduce(g, group=grp.pg)
    return {"out": _np(out), "dx": _np(xt.grad), "dw": _np(wt.grad),
            "db": _np(bt.grad)}


def pipelined_forward(preset_name: str, runtime: dict, weights: dict,
                      images, text) -> dict:
    """The tiny pipelined ``preset_name`` from ``weights`` (a JAX model of
    the same pipeline configuration) laid out over a ``stage`` axis of
    every rank: its image and text embeddings, without gradients."""
    from jimm_tpu_torch.parallel import sharding
    model = tiny_model(preset_name, runtime, weights)
    mesh = make_mesh({"stage": dist.get_world_size()})
    sharding.shard_model(model, mesh, "pp")
    with torch.no_grad(), sharding.use_sharding(mesh, "pp"):
        return {"image": _np(model.encode_image(_t(images))),
                "text": _np(model.encode_text(_t(text).long())),
                "blocks": sorted(n for n, _ in model.named_parameters()
                                 if ".blocks." in n and n.endswith(
                                     "ln1.weight"))}


# -- fp8 and int8 under the mesh, the drills ----------------------------------

def fp8_linear_passes(x, w, b, g, passes: int = 2) -> dict:
    """One ``Fp8Linear`` (JAX's ``(in, out)`` kernel ``w``, bias ``b``) as
    the ``mlp.fc1`` of a module laid out under ``dp`` over a ``data`` axis
    of every rank, run ``passes`` times on this rank's rows of ``x`` with
    the loss ``sum(y * g_rows)``, each pass finished as a train step
    finishes it (``finish_gradients``). Per pass: the histories, the e5m2
    gradient scale the backward took, this rank's rows of y and dx, and
    the whole dw and db (the averaged gradients times the ranks)."""
    from torch import nn

    from jimm_tpu_torch.ops import fp8_matmul as fp8
    from jimm_tpu_torch.parallel import sharding
    from jimm_tpu_torch.quant.policy import Fp8Linear
    mesh = make_mesh({"data": dist.get_world_size()})
    holder = nn.Module()
    holder.mlp = nn.Module()
    holder.mlp.fc1 = Fp8Linear(nn.Parameter(_t(w.T.copy())),
                               nn.Parameter(_t(b)))
    sharding.shard_model(holder, mesh, "dp")
    grp = comm.axis_group("data", mesh)
    rows = x.shape[0] // grp.size
    sl = slice(grp.index * rows, (grp.index + 1) * rows)
    real = fp8.quantize_tensor
    scales = []

    def spy(t, scale, dtype):
        if dtype == fp8.E5M2:
            scales.append(_np(scale).copy())
        return real(t, scale, dtype)

    fp8.quantize_tensor = spy
    out = []
    lin = holder.mlp.fc1
    try:
        for _ in range(passes):
            lin.weight.grad = lin.bias.grad = None
            xr = _t(x[sl]).requires_grad_()
            y = lin(xr)
            (y * _t(g[sl])).sum().backward()
            sharding.finish_gradients(holder)
            out.append({"x_amax": _np(lin.x_amax).copy(),
                        "w_amax": _np(lin.w_amax).copy(),
                        "dy_scale": scales[-1], "y": _np(y), "dx": _np(xr.grad),
                        "dw": _np(lin.weight.grad * grp.size).T,
                        "db": _np(lin.bias.grad * grp.size)})
    finally:
        fp8.quantize_tensor = real
    return {"index": grp.index, "passes": out}


def fp8_step(preset_name: str, axes: dict | None, rules: str | None, images,
             target, weights: dict) -> dict:
    """The tiny ``preset_name`` from ``weights`` under the fp8_hybrid policy,
    laid out over ``axes`` (None: no mesh), one loss and backward on the
    global batch finished as the train step finishes it: every amax
    history (all rolled once) and the whole gradients."""
    from jimm_tpu_torch.parallel import sharding
    from jimm_tpu_torch.train import trainer
    model = tiny_model(preset_name, None, weights, precision="fp8_hybrid")
    mesh = None if axes is None else make_mesh(axes)
    x, y = _t(images), _t(target).long()
    ctx = contextlib.nullcontext()
    if mesh is not None:
        sharding.shard_model(model, mesh, rules)
        ctx = sharding.use_sharding(mesh, rules)
        x, y = sharding.shard_batch((x, y), mesh, rules)
    with ctx:
        trainer.contrastive_loss_fn(model, x, y, kind="siglip",
                                    mesh=mesh).backward()
        sharding.finish_gradients(model)
        grads = sharding.gather_whole(model, {
            n: p.grad for n, p in model.named_parameters()})
    return {"hist": {n: _np(b).copy() for n, b in model.named_buffers()
                     if n.endswith("_amax")},
            "grads": {n: _np(g) for n, g in grads.items()}}


def _outcome(fn) -> dict:
    try:
        return {"rc": fn(), "error": None, "step": None}
    except Exception as e:  # noqa: BLE001 -- the test reads it
        return {"rc": None, "error": type(e).__name__,
                "step": getattr(e, "step", None), "message": str(e)}


def cli_outcome(argv: list[str], weights: dict | None = None) -> dict:
    """:func:`train_cli`, or the exception it raised: its type's name, its
    ``step`` (a ``PreemptedError``'s) and its message; and what this rank
    printed."""
    import io
    from contextlib import redirect_stdout
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = _outcome(lambda: train_cli(argv, weights))
    if out["rc"] is not None:
        out.update(out.pop("rc"))
    out["stdout"] = buf.getvalue()
    return out


def supervise(argv: list[str], weights: dict | None = None) -> dict:
    """``python -m jimm_tpu_torch supervise <argv>`` on this rank, the tiny
    model started from ``weights``: the return code, what this rank
    printed and what its counters counted."""
    import io
    from contextlib import redirect_stdout

    from jimm_tpu_torch import cli, obs
    from jimm_tpu_torch.models.common import load_jax_params
    real = cli.build_run_model

    def from_jax(spec, *a, **kw):
        model, fresh = real(spec, *a, **kw)
        if weights is not None:
            load_jax_params(model, weights)
        return model, fresh

    obs.reset_journal()
    before = obs.snapshot()
    cli.build_run_model = from_jax
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            rc = cli.main(["supervise", *argv])
    finally:
        cli.build_run_model = real
    return {"rc": rc, "stdout": buf.getvalue(), "counted": {
        k: v - before.get(k, 0.0) for k, v in obs.snapshot().items()}}
