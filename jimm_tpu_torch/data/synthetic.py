"""Synthetic datasets for offline training: the port's numpy-only copy of
``jimm_tpu/data/synthetic.py``'s ``blob_classification``,
``contrastive_pairs`` and ``naflex_contrastive_pairs``. The same seed yields
the same arrays as the JAX package's generators (the same RandomState draws
in the same order)."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from jimm_tpu_torch.data.naflex import patchify_naflex
from jimm_tpu_torch.data.preprocess import resize_bilinear


def blob_classification(batch_size: int, *, image_size: int = 28,
                        num_classes: int = 4, channels: int = 3,
                        seed: int = 0, num_frames: int = 1
                        ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Classify which quadrant holds a bright Gaussian blob: ``(B, H, W, C)``
    f32 images (``(B, T, H, W, C)`` clips with a drifting blob when
    ``num_frames > 1``) and int32 labels."""
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(np.arange(image_size), np.arange(image_size),
                                indexing="ij"), -1).astype(np.float32)
    half = image_size / 2
    centers = np.asarray([(0.25, 0.25), (0.25, 0.75), (0.75, 0.25),
                          (0.75, 0.75)], np.float32) * image_size
    while True:
        labels = rng.randint(0, num_classes, size=batch_size)
        jitter = rng.randn(batch_size, 2).astype(np.float32) * half * 0.15
        mu = centers[labels % 4] + jitter
        if num_frames > 1:
            drift = rng.randn(batch_size, 2).astype(np.float32) * half * 0.05
            t = np.arange(num_frames, dtype=np.float32)[None, :, None]
            mu_t = mu[:, None] + drift[:, None] * t      # (B, T, 2)
            d2 = np.sum((grid[None, None] - mu_t[:, :, None, None]) ** 2, -1)
        else:
            d2 = np.sum((grid[None] - mu[:, None, None]) ** 2, -1)
        images = np.exp(-d2 / (2 * (image_size * 0.08) ** 2))
        images = images[..., None].repeat(channels, -1)
        images += rng.randn(*images.shape).astype(np.float32) * 0.05
        yield images.astype(np.float32), labels.astype(np.int32)


def contrastive_pairs(batch_size: int, *, image_size: int = 32,
                      vocab_size: int = 64, seq_len: int = 8,
                      channels: int = 3, seed: int = 0,
                      shard_index: int = 0, shard_count: int = 1
                      ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Image/text pairs with shared structure: the first text token is the
    blob's quadrant, so contrastive training has signal to align on.
    ``shard_index/shard_count`` yield one contiguous row block of the global
    batch, every shard drawing the same global stream."""
    if batch_size % shard_count:
        raise ValueError(f"batch_size={batch_size} not divisible by "
                         f"shard_count={shard_count}")
    if not 0 <= shard_index < shard_count:
        raise ValueError(f"shard_index={shard_index} outside "
                         f"[0, {shard_count})")
    rng = np.random.RandomState(seed)
    img_gen = blob_classification(batch_size, image_size=image_size,
                                  num_classes=4, channels=channels, seed=seed)
    lo = shard_index * (batch_size // shard_count)
    hi = lo + batch_size // shard_count
    while True:
        images, labels = next(img_gen)
        text = rng.randint(4, vocab_size, size=(batch_size, seq_len))
        text[:, 0] = labels  # class token leads the caption
        yield images[lo:hi], text[lo:hi].astype(np.int32)


def naflex_contrastive_pairs(batch_size: int, *, patch_size: int = 16,
                             max_num_patches: int = 4, vocab_size: int = 64,
                             seq_len: int = 8, seed: int = 0):
    """:func:`contrastive_pairs` in NaFlex form: the square blob images are
    resized to a cycling set of aspect ratios (wide, square, tall, 1:2)
    before patchification, so every batch has variable grids, per-sample
    position resampling and padding masks. Yields
    ``((patches, spatial_shapes, mask), tokens)``. (The JAX generator's
    ``shard_index`` / ``shard_count`` wait for multi-process training,
    ROADMAP.md queue 1, item 6.)"""
    base = patch_size * 2  # native square size before aspect warping
    aspects = [(1.0, 3.0), (1.0, 1.0), (3.0, 1.0), (1.0, 2.0)]
    pairs = contrastive_pairs(batch_size, image_size=base,
                              vocab_size=vocab_size, seq_len=seq_len,
                              seed=seed)
    step = 0
    while True:
        images, tokens = next(pairs)
        warped = []
        for j, img in enumerate(images):
            ah, aw = aspects[(step * batch_size + j) % len(aspects)]
            h = max(patch_size, int(base * ah))
            w = max(patch_size, int(base * aw))
            warped.append(resize_bilinear(img[None], (h, w))[0])
        step += 1
        yield (patchify_naflex(warped, patch_size=patch_size,
                               max_num_patches=max_num_patches), tokens)
