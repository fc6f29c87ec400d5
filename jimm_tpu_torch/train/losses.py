"""Contrastive losses: CLIP's symmetric softmax and SigLIP's dense sigmoid;
the counterpart of the single-device losses of ``jimm_tpu/train/losses.py``.
The ring versions (the batch sharded over devices) wait for parallelism
(ROADMAP.md queue 1, item 6)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def optax_softmax_ce(logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """Mean cross-entropy of integer labels (optax's formula)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp[torch.arange(logits.shape[0], device=logits.device),
                 labels].mean()


def clip_softmax_loss(img: torch.Tensor, txt: torch.Tensor,
                      logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch (CLIP): L2-normalised embeddings,
    logits ``exp(scale) * img @ txt.T``, matching pairs on the diagonal."""
    logits = logit_scale.exp() * _unit(img) @ _unit(txt).T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (optax_softmax_ce(logits, labels)
            + optax_softmax_ce(logits.T, labels)) / 2


def sigmoid_pairwise_loss(img: torch.Tensor, txt: torch.Tensor,
                          logit_scale: torch.Tensor, logit_bias: torch.Tensor
                          ) -> torch.Tensor:
    """Dense SigLIP sigmoid loss over the batch:
    ``-sum_ij log sigmoid(z_ij * (exp(scale) * <img_i, txt_j> + bias)) / n``
    with z = +1 on the diagonal and -1 elsewhere (SigLIP paper eq. 1)."""
    logits = logit_scale.exp() * _unit(img) @ _unit(txt).T + logit_bias
    n = logits.shape[0]
    z = 2 * torch.eye(n, dtype=logits.dtype, device=logits.device) - 1
    return -F.logsigmoid(z * logits).sum() / n
