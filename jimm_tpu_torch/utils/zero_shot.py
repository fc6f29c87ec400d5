"""Prompt-ensemble zero-shot classification (the CLIP-paper recipe); the
counterpart of ``jimm_tpu/utils/zero_shot.py``.

Each class's text embedding is averaged over a set of prompt templates —
normalize per prompt, mean over templates, normalize again. The class
weights are built once, so inference is one image forward and a
``(B, D) @ (D, C)`` product per batch, with no text tower in the loop.
Text and image encodes run under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from jimm_tpu_torch.data.records import pad_tokens

#: The 7-template ImageNet evaluation subset popularized by the CLIP
#: authors' zero-shot notebook.
TEMPLATES: tuple[str, ...] = (
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
)


def expand_templates(labels: Sequence[str],
                     templates: Sequence[str] = TEMPLATES) -> list[str]:
    """All prompts, class-major: ``[t.format(l) for l in labels for t in
    templates]`` — the layout `classifier_weights` expects."""
    return [t.format(label) for label in labels for t in templates]


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def classifier_weights(model, text_rows, n_classes: int) -> torch.Tensor:
    """Ensemble zero-shot classifier weights from tokenized prompts.

    Args:
        model: CLIP or SigLIP (anything with ``encode_text``).
        text_rows: ``(n_classes * n_templates, L)`` token rows, class-major
            (``expand_templates`` order), each padded/EOT'd the way the
            model's tokenizer requires.
        n_classes: number of classes the rows cover.

    Returns:
        ``(n_classes, D)`` unit-norm class embeddings on the model's device,
        in its dtype: per-prompt L2 normalization, mean over the class's
        templates, renormalized.
    """
    text_rows = torch.as_tensor(text_rows).to(_model_device(model),
                                              torch.long)
    total = text_rows.shape[0]
    if total % n_classes:
        raise ValueError(f"{total} prompt rows not divisible by "
                         f"{n_classes} classes")
    emb = model.encode_text(text_rows)                       # (C*T, D)
    emb = emb / emb.norm(dim=-1, keepdim=True)
    emb = emb.reshape(n_classes, total // n_classes, -1).mean(dim=1)
    return emb / emb.norm(dim=-1, keepdim=True)


def token_table_rows(table: dict, context_length: int,
                     labels: Sequence[str] | None = None
                     ) -> tuple[list[str], torch.Tensor, list[int]]:
    """Flatten a ``{label: [ids]}`` / ``{label: [[ids], ...]}`` token table
    into padded class-major rows.

    Returns ``(labels, (N, L) int64 token rows, owner)`` where ``owner[i]``
    is the class index row ``i`` belongs to (classes may carry different
    template counts). Raises ``ValueError`` for rows longer than
    ``context_length`` (silent truncation would drop CLIP's EOT pooling
    token).
    """
    labels = list(table) if labels is None else list(labels)
    missing = [label for label in labels if label not in table]
    if missing:
        raise ValueError(f"token table lacks entries for {missing[:5]}")
    rows, owner = [], []
    for ci, label in enumerate(labels):
        entry = table[label]
        per_class = entry if entry and isinstance(entry[0], list) else [entry]
        for r in per_class:
            if len(r) > context_length:
                raise ValueError(
                    f"tokens for {label!r} are {len(r)} ids but "
                    f"context_length is {context_length}; re-tokenize to fit")
            rows.append(pad_tokens(r, context_length))
            owner.append(ci)
    return labels, torch.from_numpy(np.stack(rows).astype(np.int64)), owner


def weights_from_rows(model, rows, owner: Sequence[int],
                      n_classes: int) -> torch.Tensor:
    """Ensemble class weights from flat prompt rows with per-row class
    ownership (the ragged-template generalization of `classifier_weights`):
    per-prompt L2 normalization, mean over each class's rows, renormalized,
    on the host in f32. Returns an f32 CPU tensor."""
    rows = torch.as_tensor(rows).to(_model_device(model), torch.long)
    with torch.inference_mode():
        emb = model.encode_text(rows).float().cpu().numpy()
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    owner_arr = np.asarray(owner)
    weights = np.stack([emb[owner_arr == ci].mean(axis=0)
                        for ci in range(n_classes)])
    weights /= np.linalg.norm(weights, axis=-1, keepdims=True)
    return torch.from_numpy(weights)


@torch.inference_mode()
def zero_shot_logits_from_features(model, img_features: torch.Tensor,
                                   class_embeds) -> torch.Tensor:
    """Like `zero_shot_logits` but over precomputed (unnormalized) image
    features — e.g. from ``encode_image_naflex``. The scaled features stay
    in their dtype; the product with the class embeddings and the bias run
    in f32 (JAX's promotion of a bf16 operand against f32 weights)."""
    img = img_features / img_features.norm(dim=-1, keepdim=True)
    scaled = model.logit_scale.exp() * img
    weights = torch.as_tensor(class_embeds).to(img.device, torch.float32)
    logits = scaled.float() @ weights.T
    bias = getattr(model, "logit_bias", None)
    if bias is not None:
        logits = logits + bias.float()
    return logits


def zero_shot_logits(model, images: torch.Tensor,
                     class_embeds) -> torch.Tensor:
    """``(B, C)`` logits against prebuilt ensemble weights, using the
    model's own calibration: ``exp(logit_scale)`` (CLIP & SigLIP) plus
    ``logit_bias`` when present (SigLIP — feed through a sigmoid for
    per-class probabilities; CLIP logits go through a softmax)."""
    with torch.inference_mode():
        feats = model.encode_image(images)
    return zero_shot_logits_from_features(model, feats, class_embeds)
