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
import torch.nn.functional as F
from torch import nn

from jimm_tpu_torch.train.losses import clip_softmax_loss, sigmoid_pairwise_loss


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
    decayed whatever its rank."""
    return param.ndim > 1 or "encoder.blocks." in name


@torch.no_grad()
def clip_by_global_norm_(params: list[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """Scale the gradients in place by ``max_norm / ||g||`` when the global
    norm ``||g||`` is at least ``max_norm`` (optax's rule; unlike
    ``clip_grad_norm_``, nothing is added to the norm). Returns ``||g||``
    in f32, without a host sync. The per-tensor norms and the scaling are
    multi-tensor ops: a few launches for all parameters, not a few each."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads, 2.0, dtype=torch.float32)))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


def _moment_dtype(name: str | None) -> torch.dtype | None:
    if name is None:
        return None
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"moment_dtype {name!r} is not a torch float dtype")
    return dtype


class Optimizer:
    """AdamW (eps 1e-8) over ``model``'s parameters in two groups, decayed
    and not (:func:`decays`), with the learning rate of :func:`make_schedule`
    and global-norm clipping applied in :meth:`step`. Its state is
    ``opt.state[p]``'s ``exp_avg`` (mu, in ``cfg.moment_dtype`` when set)
    and ``exp_avg_sq`` (nu, in the parameter dtype)."""

    def __init__(self, model: nn.Module, cfg: OptimizerConfig):
        self.cfg = cfg
        self.moment_dtype = _moment_dtype(cfg.moment_dtype)
        self.schedule = make_schedule(cfg)
        decay, keep = [], []
        for name, p in model.named_parameters():
            if p.requires_grad:
                (decay if decays(name, p) else keep).append(p)
        self.params = decay + keep
        self.opt = torch.optim.AdamW(
            [{"params": decay, "weight_decay": cfg.weight_decay},
             {"params": keep, "weight_decay": 0.0}],
            lr=self.schedule(0), betas=(cfg.b1, cfg.b2), eps=1e-8)
        #: updates applied so far (optax's count)
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.cfg.grad_clip_norm:
            clip_by_global_norm_(self.params, self.cfg.grad_clip_norm)
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
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                state = self.opt.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=self.moment_dtype,
                        memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            mus = [self.opt.state[p]["exp_avg"] for p in params]
            nus = [self.opt.state[p]["exp_avg_sq"] for p in params]
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


def make_classifier_train_step() -> Callable:
    """``step(model, optimizer, images, labels) -> {"loss", "accuracy"}``:
    zero the gradients, backpropagate the cross-entropy of ``model(images)``,
    clip and update; the accuracy is of the logits before the update. Both
    stay on the device."""

    def train_step(model: nn.Module, optimizer: Optimizer,
                   images: torch.Tensor, labels: torch.Tensor
                   ) -> dict[str, torch.Tensor]:
        optimizer.zero_grad()
        metrics = classifier_metrics(model(images), labels)
        metrics["loss"].backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

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
    if kind in ("clip_ring", "siglip_ring"):
        raise NotImplementedError(f"loss {kind!r} needs a device mesh, not "
                                  f"ported yet (ROADMAP.md queue 1, item 6: "
                                  f"parallelism)")
    if kind not in ("clip", "siglip"):
        raise ValueError(f"unknown contrastive loss kind {kind!r}")


def contrastive_loss_fn(model: nn.Module,
                        images: torch.Tensor | tuple[torch.Tensor, ...],
                        text: torch.Tensor, *, kind: str) -> torch.Tensor:
    """``"clip"``: symmetric softmax InfoNCE; ``"siglip"``: dense sigmoid
    all-pairs loss, on the model's image and text embeddings. ``images`` is
    a ``(B, H, W, C)`` tensor or a NaFlex triple ``(patches, spatial_shapes,
    mask)`` (``SigLIP.encode_image_naflex``), which trains SigLIP2 on
    variable-resolution batches."""
    _check_kind(kind)
    if isinstance(images, (tuple, list)):
        img = model.encode_image_naflex(*images)
    else:
        img = model.encode_image(images)
    txt = model.encode_text(text)
    if kind == "clip":
        return clip_softmax_loss(img, txt, model.logit_scale)
    return sigmoid_pairwise_loss(img, txt, model.logit_scale,
                                 model.logit_bias)


def make_contrastive_train_step(kind: str = "siglip") -> Callable:
    """``step(model, optimizer, images, text) -> {"loss": tensor}``: zero
    the gradients, backpropagate the loss, clip and update. The loss stays
    on the device (no host sync). ``images`` may be a NaFlex triple, as in
    :func:`contrastive_loss_fn`."""
    _check_kind(kind)

    def train_step(model: nn.Module, optimizer: Optimizer,
                   images: torch.Tensor | tuple[torch.Tensor, ...],
                   text: torch.Tensor
                   ) -> dict[str, torch.Tensor]:
        optimizer.zero_grad()
        loss = contrastive_loss_fn(model, images, text, kind=kind)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return train_step
