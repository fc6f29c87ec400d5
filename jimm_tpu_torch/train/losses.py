"""Contrastive losses: CLIP's symmetric softmax and SigLIP's dense sigmoid,
and ring versions of both over a batch sharded across ranks; the
counterpart of ``jimm_tpu/train/losses.py``.

The ring losses keep each rank's images in place while the text chunks
travel around a mesh axis (``parallel.comm.ppermute``), so no rank holds
the global text batch or the full B x B logit matrix (the SigLIP paper's
chunked algorithm; streaming logsumexps for InfoNCE). Each returns the
global loss on every rank (a ``psum`` over the axis, divided by the global
batch, as JAX's). Their backward runs the collectives' adjoints, so a
rank's gradients are those of the sum of every rank's copy of the loss:
averaged over the ranks (``parallel.sharding.finish_gradients``, FSDP2),
they are the unsharded loss's gradients."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from jimm_tpu_torch.parallel import comm


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


def ring_sigmoid_loss(img: torch.Tensor, txt: torch.Tensor,
                      logit_scale: torch.Tensor, logit_bias: torch.Tensor, *,
                      mesh: DeviceMesh | None = None,
                      axis_name: str | tuple[str, ...] = "data"
                      ) -> torch.Tensor:
    """The SigLIP sigmoid loss of a batch whose rows are sharded over
    ``axis_name`` (a name, or a tuple of names linearised in its order):
    ``img`` and ``txt`` are this rank's rows. The own text chunk holds the
    positives; the n - 1 visiting chunks are all negatives."""
    grp = comm.axis_group(axis_name, mesh)
    b = img.shape[0]
    img, txt = _unit(img), _unit(txt)
    scale = logit_scale.exp()

    def chunk_loss(chunk: torch.Tensor, positives: bool) -> torch.Tensor:
        logits = scale * img @ chunk.T + logit_bias
        z = (2 * torch.eye(b, dtype=logits.dtype, device=logits.device) - 1
             if positives else -torch.ones_like(logits))
        return -F.logsigmoid(z * logits).sum()

    total = chunk_loss(txt, True)
    chunk = txt
    for _ in range(grp.size - 1):
        chunk = comm.ppermute(chunk, grp, comm.ring_perm(grp.size))
        total = total + chunk_loss(chunk, False)
    # averaged over the global batch, like the dense loss
    return comm.psum(total, grp) / (b * grp.size)


def _fold(m: torch.Tensor, se: torch.Tensor, logits: torch.Tensor,
          dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming logsumexp: fold a block of logits into (max, sumexp)."""
    m_new = torch.maximum(m, logits.amax(dim=dim))
    expand = m_new[:, None] if dim == 1 else m_new[None, :]
    return m_new, se * torch.exp(m - m_new) + torch.exp(
        logits - expand).sum(dim=dim)


def ring_clip_infonce_loss(img: torch.Tensor, txt: torch.Tensor,
                           logit_scale: torch.Tensor, *,
                           mesh: DeviceMesh | None = None,
                           axis_name: str | tuple[str, ...] = "data"
                           ) -> torch.Tensor:
    """Symmetric CLIP InfoNCE over a batch sharded on ``axis_name``, as a
    ring with two streaming logsumexps: image->text over every text chunk
    that visits this rank's images, and text->image carried with the text
    chunk, each rank folding in its images' logits; a last hop brings the
    finished column statistics home. The positives are the own block's
    diagonal."""
    grp = comm.axis_group(axis_name, mesh)
    b, width = txt.shape
    img, txt = _unit(img), _unit(txt)
    s = logit_scale.exp()
    perm = comm.ring_perm(grp.size)
    logits0 = s * img @ txt.T
    pos = torch.diagonal(logits0)
    row_m = logits0.amax(dim=1)
    row_s = torch.exp(logits0 - row_m[:, None]).sum(dim=1)
    col_m = logits0.amax(dim=0)
    col_s = torch.exp(logits0 - col_m[None, :]).sum(dim=0)
    chunk = txt
    for _ in range(grp.size - 1):
        # the chunk and its column statistics travel as one exchange
        moved = comm.ppermute(torch.cat(
            [chunk, col_m[:, None], col_s[:, None]], dim=1), grp, perm)
        chunk, col_m, col_s = moved[:, :width], moved[:, width], \
            moved[:, width + 1]
        logits = s * img @ chunk.T
        row_m, row_s = _fold(row_m, row_s, logits, 1)
        col_m, col_s = _fold(col_m, col_s, logits, 0)
    home = comm.ppermute(torch.stack([col_m, col_s]), grp, perm)
    col_lse = home[0] + torch.log(home[1])
    row_lse = row_m + torch.log(row_s)
    li = -(pos - row_lse).sum()
    lt = -(pos - col_lse).sum()
    return comm.psum(li + lt, grp) / (2 * b * grp.size)
