"""Training machinery: the optimizer (AdamW with warmup-cosine schedule,
global-norm clipping and the JAX package's weight-decay mask), the
cross-entropy classifier steps and the contrastive train step; the
counterpart of ``jimm_tpu/train/trainer.py``.

The JAX package builds an optax chain ``clip_by_global_norm`` ->
``adamw(schedule, mask=ndim > 1, mu_dtype=moment_dtype)``; here it is
``torch.optim.AdamW`` with two parameter groups, a clip written out with
optax's formula, and the learning rate set from the schedule before every
update. With a ``moment_dtype`` the update is written out with
``_foreach`` ops in optax's order instead (:meth:`Optimizer.step`). PyTorch
runs eagerly, so the steps are plain functions (no jit, no donation).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from jimm_tpu_torch.parallel import comm
from jimm_tpu_torch.parallel.sharding import (current_mesh, current_rules,
                                              finish_gradients, norm_groups)
from jimm_tpu_torch.train.losses import (clip_softmax_loss,
                                         ring_clip_infonce_loss,
                                         ring_sigmoid_loss,
                                         sigmoid_pairwise_loss)


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 0
    total_steps: int | None = None  # cosine decay horizon; None = constant
    b1: float = 0.9
    b2: float = 0.999
    grad_clip_norm: float | None = 1.0
    min_lr_ratio: float = 0.0
    #: dtype of Adam's first moment (optax ``mu_dtype``), by its name
    #: ("bfloat16", "float32"); None keeps it in the parameter dtype
    moment_dtype: str | None = None


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """The learning rate of the k-th update, counting from 0 (optax's
    count): constant, linear warmup from 0, or linear warmup then cosine
    decay to ``learning_rate * min_lr_ratio`` at ``total_steps``."""
    lr = cfg.learning_rate
    if cfg.total_steps is None:
        if cfg.warmup_steps:
            return lambda k: lr * min(k, cfg.warmup_steps) / cfg.warmup_steps
        return lambda k: lr
    # short runs can have total_steps <= warmup_steps; the decay needs at
    # least one step, so the warmup is clamped, loudly, as in the JAX package
    warmup = min(cfg.warmup_steps, max(cfg.total_steps - 1, 0))
    if warmup != cfg.warmup_steps:
        warnings.warn(f"warmup_steps={cfg.warmup_steps} >= total_steps="
                      f"{cfg.total_steps}; clamping warmup to {warmup}",
                      stacklevel=2)
    decay = cfg.total_steps - warmup
    if decay <= 0:
        raise ValueError(f"total_steps={cfg.total_steps} leaves no decay "
                         f"steps")
    alpha = 0.0 if lr == 0.0 else cfg.min_lr_ratio  # end value / peak

    def schedule(k: int) -> float:
        if k < warmup:
            return lr * k / warmup
        t = min(k - warmup, decay)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay))
                     + alpha)

    return schedule


def decays(name: str, param: torch.Tensor) -> bool:
    """The JAX package's weight-decay mask, ``ndim > 1``, as it falls on
    its parameters: the JAX encoder stacks its blocks, so every block
    parameter has a leading layer axis and is decayed, LayerNorm scales and
    biases included, while 1-D parameters outside the blocks (``ln_post``,
    the MAP head's biases and LayerNorm, ``ln_final``) and the scalars are
    not. The port keeps one module per block, so a block parameter is
    decayed whatever its rank. The rank is the unsharded one (an FSDP2
    ``DTensor`` reports its global shape)."""
    return param.ndim > 1 or "encoder.blocks." in name


@torch.no_grad()
def clip_by_global_norm_(params: list[torch.Tensor], max_norm: float,
                         groups: list[tuple[comm.AxisGroup, ...]]
                         | None = None) -> torch.Tensor:
    """Scale the gradients in place by ``max_norm / ||g||`` when the global
    norm ``||g||`` is at least ``max_norm`` (optax's rule; unlike
    ``clip_grad_norm_``, nothing is added to the norm). Returns ``||g||``
    in f32, without a host sync. The per-tensor norms and the scaling are
    multi-tensor ops: a few launches for all parameters, not a few each.

    On a mesh a rank may hold a piece of a gradient: an FSDP2 ``DTensor``
    shard, or a slice (``model``) or block (``stage``) of the model that
    other ranks hold other pieces of, listed per parameter in ``groups``
    (``sharding.norm_groups``). The squares of the pieces' norms are summed
    over the ranks that hold the other pieces (one all-reduce per layout),
    a gradient every rank of a group holds whole counted once, and each
    rank scales its own pieces."""
    groups = groups or [()] * len(params)
    held = [(p.grad, grp) for p, grp in zip(params, groups)
            if p.grad is not None]
    if not held:
        return torch.zeros(())
    grads = [g for g, _ in held]
    local = [_local(g) for g in grads]
    norms = torch.stack(torch._foreach_norm(local, 2.0, dtype=torch.float32))
    if not any(isinstance(g, DTensor) or grp for g, grp in held):
        norm = torch.linalg.vector_norm(norms)
    else:
        norm = _sharded_norm(held, norms)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(local, factor)
    return norm


def _sharded_norm(held: list[tuple[torch.Tensor, tuple]],
                  norms: torch.Tensor) -> torch.Tensor:
    """The global norm of gradients some of which are pieces (``norms``:
    each local piece's): the pieces' squares summed over the ranks of each
    mesh dim that shards an FSDP2 shard and of each of its ``groups``, in
    one order on every rank."""
    parts: dict[tuple, list[torch.Tensor]] = {}
    reduce: dict[tuple, list] = {}
    for (g, grps), n in zip(held, norms):
        fsdp = ((g.device_mesh, g.placements) if isinstance(g, DTensor)
                else None)
        key = (fsdp, tuple(id(grp) for grp in grps))
        parts.setdefault(key, []).append(n)
        reduce[key] = [] if fsdp is None else [
            fsdp[0].get_group(dim) for dim, placement in enumerate(fsdp[1])
            if placement.is_shard()]
        reduce[key] += [grp.pg for grp in grps if grp.pg is not None]
    total = torch.zeros((), dtype=torch.float32, device=norms.device)
    for key, pieces in parts.items():
        part = torch.stack(pieces).square().sum()
        for pg in reduce[key]:
            dist.all_reduce(part, group=pg)
        total = total + part
    return total.sqrt()


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of an FSDP2 ``DTensor`` (sharing its storage), or
    ``t`` itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _moment_dtype(name: str | None) -> torch.dtype | None:
    if name is None:
        return None
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"moment_dtype {name!r} is not a torch float dtype")
    return dtype


class Optimizer:
    """AdamW (eps 1e-8) over ``model``'s parameters in two groups, decayed
    and not (:func:`decays`), each split into FSDP2 shards and whole
    parameters where both are present, with the learning rate of
    :func:`make_schedule`
    and global-norm clipping applied in :meth:`step`. Its state is
    ``opt.state[p]``'s ``exp_avg`` (mu, in ``cfg.moment_dtype`` when set)
    and ``exp_avg_sq`` (nu, in the parameter dtype)."""

    def __init__(self, model: nn.Module, cfg: OptimizerConfig):
        self.cfg = cfg
        self.moment_dtype = _moment_dtype(cfg.moment_dtype)
        self.schedule = make_schedule(cfg)
        decay, keep = [], []
        groups = {}
        for name, p in model.named_parameters():
            if p.requires_grad:
                (decay if decays(name, p) else keep).append(p)
                groups[p] = norm_groups(model, name)
        self.params = decay + keep
        #: per parameter, the ranks its gradient's norm sums over
        self.norm_groups = [groups[p] for p in self.params]
        # FSDP2's shards and the parameters it leaves whole in groups of
        # their own: the foreach update refuses a list that mixes DTensors
        # with tensors of more than 0 dimensions
        groups = [{"params": [p for p in params
                              if isinstance(p, DTensor) == sharded],
                   "weight_decay": wd}
                  for params, wd in ((decay, cfg.weight_decay), (keep, 0.0))
                  for sharded in (True, False)]
        self.opt = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=self.schedule(0),
            betas=(cfg.b1, cfg.b2), eps=1e-8)
        #: updates applied so far (optax's count)
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.cfg.grad_clip_norm:
            clip_by_global_norm_(self.params, self.cfg.grad_clip_norm,
                                 self.norm_groups)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        if self.moment_dtype is None:
            self.opt.step()
        else:
            self._step_with_moment_dtype(lr)
        self.count += 1

    @torch.no_grad()
    def _step_with_moment_dtype(self, lr: float) -> None:
        """One AdamW update as optax's ``scale_by_adam(mu_dtype=...)`` ->
        ``add_decayed_weights`` -> ``scale_by_learning_rate`` orders it: mu
        starts at zero in the moment dtype; the new mu is formed in f32 from
        the stored one and used unrounded for this update, then stored in
        the moment dtype; nu stays in the parameter dtype; ``p - lr * (mu_hat
        / (sqrt(nu_hat) + eps) + wd * p)`` in f32, rounded to the parameter
        dtype once."""
        cfg = self.cfg
        t = self.count + 1
        bc1, bc2 = 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t
        for group in self.opt.param_groups:
            held = [p for p in group["params"] if p.grad is not None]
            if not held:
                continue
            for p in held:
                state = self.opt.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=self.moment_dtype,
                        memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            # this rank's shards under FSDP2 (the state stays sharded like
            # its parameter)
            params = [_local(p) for p in held]
            grads = [_local(p.grad) for p in held]
            mus = [_local(self.opt.state[p]["exp_avg"]) for p in held]
            nus = [_local(self.opt.state[p]["exp_avg_sq"]) for p in held]
            torch._foreach_mul_(nus, cfg.b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - cfg.b2)
            mu = torch._foreach_mul([m.float() for m in mus], cfg.b1)
            torch._foreach_add_(mu, [g.float() for g in grads],
                                alpha=1.0 - cfg.b1)
            update = torch._foreach_div(mu, bc1)
            denom = torch._foreach_div([n.float() for n in nus], bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, 1e-8)
            torch._foreach_div_(update, denom)
            masters = [p.float() for p in params]
            if group["weight_decay"]:
                torch._foreach_add_(update, masters,
                                    alpha=group["weight_decay"])
            torch._foreach_copy_(params, torch._foreach_add(
                masters, update, alpha=-lr))
            torch._foreach_copy_(mus, mu)


def make_optimizer(model: nn.Module, cfg: OptimizerConfig) -> Optimizer:
    """AdamW with warmup-cosine schedule and global-norm clipping; weight
    decay masked as the JAX package masks it (:func:`decays`)."""
    return Optimizer(model, cfg)


def classifier_metrics(logits: torch.Tensor, labels: torch.Tensor
                       ) -> dict[str, torch.Tensor]:
    """Mean softmax cross-entropy on integer labels (in f32) and top-1
    accuracy, as optax's ``softmax_cross_entropy_with_integer_labels``
    ``.mean()`` and JAX's argmax accuracy."""
    loss = F.cross_entropy(logits.float(), labels.long())
    accuracy = (logits.detach().argmax(dim=-1) == labels).float().mean()
    return {"loss": loss, "accuracy": accuracy}


def _sequence_in_batch() -> str | None:
    """Under the ambient rules, the ``seq`` axis when the batch is also
    sharded over it (the ring losses' ``("data", "seq")`` pair axis): the
    towers of one ``seq`` group then need that group's whole batch."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None or not isinstance(rules.seq, str):
        return None
    return rules.seq if rules.seq in comm.axis_names(rules.batch) else None


def _map_tensors(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(fn, v) for v in x)
    return fn(x)


def _own_rows(x: torch.Tensor, axis) -> torch.Tensor:
    grp = comm.axis_group(axis)
    return x.chunk(grp.size, dim=0)[grp.index]


def encode_batch(encode, inputs):
    """``encode(inputs)`` on this rank's rows of a batch sharded under the
    ambient rules (the inputs themselves without a mesh). When the sequence
    axis also shards the batch, the towers of a ``seq`` group run on the
    group's whole batch, sequence-parallel, and each rank keeps its rows of
    the result."""
    seq = _sequence_in_batch()
    if seq is None:
        return encode(inputs)
    gathered = _map_tensors(lambda t: comm.all_gather(t, seq, dim=0), inputs)
    return _own_rows(encode(gathered), seq)


def _global_mean(t: torch.Tensor) -> torch.Tensor:
    """A per-rank mean over equal shards -> the global mean (no
    gradient), for the logged metrics."""
    rules = current_rules()
    if current_mesh() is None or rules is None or rules.batch is None:
        return t
    grp = comm.axis_group(rules.batch)
    return comm.psum(t.detach(), grp) / grp.size


def make_classifier_train_step() -> Callable:
    """``step(model, optimizer, images, labels) -> {"loss", "accuracy"}``:
    zero the gradients, backpropagate the cross-entropy of ``model(images)``,
    clip and update; the accuracy is of the logits before the update. Both
    stay on the device."""

    def train_step(model: nn.Module, optimizer: Optimizer,
                   images: torch.Tensor, labels: torch.Tensor
                   ) -> dict[str, torch.Tensor]:
        optimizer.zero_grad()
        metrics = classifier_metrics(encode_batch(model, images), labels)
        metrics["loss"].backward()
        finish_gradients(model)
        optimizer.step()
        return {k: _global_mean(v) for k, v in metrics.items()}

    return train_step


def make_classifier_eval_step() -> Callable:
    """``step(model, images, labels) -> {"loss", "accuracy"}`` without
    gradients."""

    @torch.no_grad()
    def eval_step(model: nn.Module, images: torch.Tensor,
                  labels: torch.Tensor) -> dict[str, torch.Tensor]:
        return classifier_metrics(model(images), labels)

    return eval_step


def _check_kind(kind: str) -> None:
    if kind not in ("clip", "siglip", "clip_ring", "siglip_ring"):
        raise ValueError(f"unknown contrastive loss kind {kind!r}")


def _ring_rows(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Embeddings sharded over the ring's axis: this rank's rows as they
    are when the ambient batch sharding is the ring's axis, its share of
    a replicated batch when the rules replicate it."""
    rules = current_rules()
    batch = comm.axis_names(None if rules is None else rules.batch)
    if batch == comm.axis_names(axis_name):
        return x
    if not batch:
        return _own_rows(x, axis_name)
    raise ValueError(f"the ring loss over {axis_name!r} needs the batch "
                     f"sharded over it, not over {rules.batch!r}")


def contrastive_loss_fn(model: nn.Module,
                        images: torch.Tensor | tuple[torch.Tensor, ...],
                        text: torch.Tensor, *, kind: str, mesh=None,
                        axis_name: str | tuple[str, ...] = "data"
                        ) -> torch.Tensor:
    """The loss of the model's image and text embeddings:

    - ``"clip"``: symmetric softmax InfoNCE;
    - ``"clip_ring"``: the ring InfoNCE over ``axis_name`` of ``mesh``
      (None: the ambient one);
    - ``"siglip"``: the dense sigmoid all-pairs loss;
    - ``"siglip_ring"``: the ring sigmoid loss over ``axis_name``.

    ``images`` is a ``(B, H, W, C)`` tensor or a NaFlex triple ``(patches,
    spatial_shapes, mask)`` (``SigLIP.encode_image_naflex``), which trains
    SigLIP2 on variable-resolution batches. Under a mesh
    (``parallel.sharding.use_sharding``) the inputs are this rank's rows
    of the global batch (:func:`encode_batch`), and a dense loss gathers
    the embeddings over the batch axes first: every kind is the global
    batch's loss."""
    _check_kind(kind)
    if isinstance(images, (tuple, list)):
        img = encode_batch(lambda x: model.encode_image_naflex(*x), images)
    else:
        img = encode_batch(model.encode_image, images)
    txt = encode_batch(model.encode_text, text)
    if kind.endswith("_ring"):
        img, txt = _ring_rows(img, axis_name), _ring_rows(txt, axis_name)
        if kind == "clip_ring":
            return ring_clip_infonce_loss(img, txt, model.logit_scale,
                                          mesh=mesh, axis_name=axis_name)
        return ring_sigmoid_loss(img, txt, model.logit_scale,
                                 model.logit_bias, mesh=mesh,
                                 axis_name=axis_name)
    rules = current_rules()
    if current_mesh() is not None and rules is not None and rules.batch:
        img = comm.all_gather(img, rules.batch, dim=0)
        txt = comm.all_gather(txt, rules.batch, dim=0)
    if kind == "clip":
        return clip_softmax_loss(img, txt, model.logit_scale)
    return sigmoid_pairwise_loss(img, txt, model.logit_scale,
                                 model.logit_bias)


def make_contrastive_train_step(kind: str = "siglip", *, mesh=None,
                                axis_name: str | tuple[str, ...] = "data"
                                ) -> Callable:
    """``step(model, optimizer, images, text) -> {"loss": tensor}``: zero
    the gradients, backpropagate the loss, average the replicated
    parameters' gradients over the mesh (``parallel.sharding``), clip and
    update. The loss stays on the device (no host sync). ``images`` may be
    a NaFlex triple; ``mesh`` and ``axis_name`` are the ring losses', as in
    :func:`contrastive_loss_fn`."""
    _check_kind(kind)

    def train_step(model: nn.Module, optimizer: Optimizer,
                   images: torch.Tensor | tuple[torch.Tensor, ...],
                   text: torch.Tensor
                   ) -> dict[str, torch.Tensor]:
        optimizer.zero_grad()
        loss = contrastive_loss_fn(model, images, text, kind=kind, mesh=mesh,
                                   axis_name=axis_name)
        loss.backward()
        finish_gradients(model)
        optimizer.step()
        return {"loss": loss.detach()}

    return train_step
