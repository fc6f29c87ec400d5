"""Synthetic datasets for offline training: the port's copy of
``jimm_tpu/data/synthetic.py``'s ``blob_classification``,
``contrastive_pairs`` and ``naflex_contrastive_pairs``. The same seed yields
the same arrays as the JAX package's generators (the same RandomState draws
in the same order); the NaFlex images are resized by the native library,
within ~1e-7 of the JAX package's numpy resize and equal to its native one.

Each returns an iterator with a ``skip(n)``: it makes the draws of the next
``n`` batches in the same order but builds no image and resizes nothing, so
the batch after it equals the one a full generation would give there, bit
for bit (``train --resume`` replays the stream up to the resumed step with
it).
"""

from __future__ import annotations

import numpy as np

from jimm_tpu_torch.data.naflex import patchify_naflex
from jimm_tpu_torch.data.preprocess import resize_bilinear


class _Blobs:
    """:func:`blob_classification`'s stream."""

    def __init__(self, batch_size: int, image_size: int, num_classes: int,
                 channels: int, seed: int, num_frames: int):
        self.batch_size, self.image_size = batch_size, image_size
        self.num_classes, self.channels = num_classes, channels
        self.num_frames = num_frames
        self.rng = np.random.RandomState(seed)
        self.grid = np.stack(np.meshgrid(np.arange(image_size),
                                         np.arange(image_size),
                                         indexing="ij"), -1).astype(np.float32)
        self.centers = np.asarray([(0.25, 0.25), (0.25, 0.75), (0.75, 0.25),
                                   (0.75, 0.75)], np.float32) * image_size

    def _shape(self) -> tuple[int, ...]:
        frames = (self.num_frames,) if self.num_frames > 1 else ()
        return (self.batch_size, *frames, self.image_size, self.image_size,
                self.channels)

    def __iter__(self) -> "_Blobs":
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        rng, b, half = self.rng, self.batch_size, self.image_size / 2
        labels = rng.randint(0, self.num_classes, size=b)
        jitter = rng.randn(b, 2).astype(np.float32) * half * 0.15
        mu = self.centers[labels % 4] + jitter
        grid = self.grid
        if self.num_frames > 1:
            drift = rng.randn(b, 2).astype(np.float32) * half * 0.05
            t = np.arange(self.num_frames, dtype=np.float32)[None, :, None]
            mu_t = mu[:, None] + drift[:, None] * t      # (B, T, 2)
            d2 = np.sum((grid[None, None] - mu_t[:, :, None, None]) ** 2, -1)
        else:
            d2 = np.sum((grid[None] - mu[:, None, None]) ** 2, -1)
        images = np.exp(-d2 / (2 * (self.image_size * 0.08) ** 2))
        images = images[..., None].repeat(self.channels, -1)
        images += rng.randn(*images.shape).astype(np.float32) * 0.05
        return images.astype(np.float32), labels.astype(np.int32)

    def skip(self, n: int) -> None:
        """Draw the next ``n`` batches' labels, jitter, drift and noise in
        :meth:`__next__`'s order, and build nothing."""
        rng, b = self.rng, self.batch_size
        for _ in range(n):
            rng.randint(0, self.num_classes, size=b)
            rng.randn(b, 2)
            if self.num_frames > 1:
                rng.randn(b, 2)
            rng.randn(*self._shape())


def blob_classification(batch_size: int, *, image_size: int = 28,
                        num_classes: int = 4, channels: int = 3,
                        seed: int = 0, num_frames: int = 1) -> _Blobs:
    """Classify which quadrant holds a bright Gaussian blob: ``(B, H, W, C)``
    f32 images (``(B, T, H, W, C)`` clips with a drifting blob when
    ``num_frames > 1``) and int32 labels."""
    return _Blobs(batch_size, image_size, num_classes, channels, seed,
                  num_frames)


class _Rows:
    """:func:`shard_rows`'s stream."""

    def __init__(self, stream, rows: slice):
        self.stream, self.rows = stream, rows

    def __iter__(self) -> "_Rows":
        return self

    def __next__(self):
        return tuple(x[self.rows] for x in next(self.stream))

    def skip(self, n: int) -> None:
        self.stream.skip(n)


def shard_rows(stream, shard_index: int, shard_count: int):
    """One contiguous row block of every batch of ``stream`` (a generator
    of this module), as ``contrastive_pairs``'s ``shard_index`` /
    ``shard_count`` cut theirs; ``stream`` itself for one shard."""
    if shard_count == 1:
        return stream
    b = stream.batch_size
    if b % shard_count:
        raise ValueError(f"batch_size={b} not divisible by "
                         f"shard_count={shard_count}")
    lo = shard_index * (b // shard_count)
    return _Rows(stream, slice(lo, lo + b // shard_count))


class _Pairs:
    """:func:`contrastive_pairs`'s stream."""

    def __init__(self, images: _Blobs, seed: int, vocab_size: int,
                 seq_len: int, rows: slice):
        self.images, self.rng = images, np.random.RandomState(seed)
        self.vocab_size, self.seq_len, self.rows = vocab_size, seq_len, rows

    def __iter__(self) -> "_Pairs":
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        images, labels = next(self.images)
        text = self.rng.randint(4, self.vocab_size,
                                size=(self.images.batch_size, self.seq_len))
        text[:, 0] = labels  # class token leads the caption
        return images[self.rows], text[self.rows].astype(np.int32)

    def skip(self, n: int) -> None:
        """The next ``n`` batches' draws, nothing built."""
        self.images.skip(n)
        for _ in range(n):
            self.rng.randint(4, self.vocab_size,
                             size=(self.images.batch_size, self.seq_len))


def contrastive_pairs(batch_size: int, *, image_size: int = 32,
                      vocab_size: int = 64, seq_len: int = 8,
                      channels: int = 3, seed: int = 0,
                      shard_index: int = 0, shard_count: int = 1) -> _Pairs:
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
    lo = shard_index * (batch_size // shard_count)
    images = blob_classification(batch_size, image_size=image_size,
                                 num_classes=4, channels=channels, seed=seed)
    return _Pairs(images, seed, vocab_size, seq_len,
                  slice(lo, lo + batch_size // shard_count))


#: the aspect ratios naflex_contrastive_pairs cycles through
_ASPECTS = [(1.0, 3.0), (1.0, 1.0), (3.0, 1.0), (1.0, 2.0)]


class _NaFlexPairs:
    """:func:`naflex_contrastive_pairs`'s stream."""

    def __init__(self, pairs: _Pairs, batch_size: int, patch_size: int,
                 max_num_patches: int, lo: int):
        self.pairs, self.batch_size = pairs, batch_size
        self.patch_size, self.max_num_patches = patch_size, max_num_patches
        #: the global row of this shard's first row
        self.lo = lo
        self.step = 0

    def __iter__(self) -> "_NaFlexPairs":
        return self

    def __next__(self):
        images, tokens = next(self.pairs)
        p, base = self.patch_size, self.patch_size * 2
        warped = []
        for j, img in enumerate(images):
            # keyed by the global row: the shards reassemble into exactly
            # the single-process stream, shapes included
            ah, aw = _ASPECTS[(self.step * self.batch_size + self.lo + j)
                              % len(_ASPECTS)]
            h = max(p, int(base * ah))
            w = max(p, int(base * aw))
            warped.append(resize_bilinear(img[None], (h, w))[0])
        self.step += 1
        return (patchify_naflex(warped, patch_size=p,
                                max_num_patches=self.max_num_patches),
                tokens)

    def skip(self, n: int) -> None:
        """The next ``n`` batches' draws, nothing built or resized."""
        self.pairs.skip(n)
        self.step += n


def naflex_contrastive_pairs(batch_size: int, *, patch_size: int = 16,
                             max_num_patches: int = 4, vocab_size: int = 64,
                             seq_len: int = 8, seed: int = 0,
                             shard_index: int = 0, shard_count: int = 1
                             ) -> _NaFlexPairs:
    """:func:`contrastive_pairs` in NaFlex form: the square blob images are
    resized to a cycling set of aspect ratios (wide, square, tall, 1:2)
    before patchification, so every batch has variable grids, per-sample
    position resampling and padding masks. Yields
    ``((patches, spatial_shapes, mask), tokens)``; ``shard_index`` /
    ``shard_count`` as in :func:`contrastive_pairs`."""
    pairs = contrastive_pairs(batch_size, image_size=patch_size * 2,
                              vocab_size=vocab_size, seq_len=seq_len,
                              seed=seed, shard_index=shard_index,
                              shard_count=shard_count)
    return _NaFlexPairs(pairs, batch_size, patch_size, max_num_patches,
                        shard_index * (batch_size // shard_count))
