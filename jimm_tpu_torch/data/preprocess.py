"""Host-side image preprocessing; the port's numpy copy of
``jimm_tpu/data/preprocess.py``: the normalization constants,
``to_float_normalized``, ``resize_bilinear`` (half-pixel centers, PIL /
``tf.image.resize`` semantics), ``center_crop`` and ``preprocess_batch``.
The JAX package may take a native C++ path for the same functions, which
agrees with these to ~1e-6.

Conventions: C-contiguous NHWC float32/uint8.
"""

from __future__ import annotations

import numpy as np

#: CLIP / SigLIP standard normalization constants.
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
SIGLIP_MEAN = np.asarray([0.5, 0.5, 0.5], np.float32)
SIGLIP_STD = np.asarray([0.5, 0.5, 0.5], np.float32)


def _chanwise(arr, c: int) -> np.ndarray:
    return np.ascontiguousarray(np.broadcast_to(
        np.asarray(arr, np.float32), (c,)))


def to_float_normalized(images: np.ndarray, mean=SIGLIP_MEAN,
                        std=SIGLIP_STD) -> np.ndarray:
    """uint8 or float [B,H,W,C] -> float32, ``(x/255 - mean) / std`` (uint8)
    or ``(x - mean) / std`` (float input, assumed already in [0,1])."""
    c = images.shape[-1]
    mean, std = _chanwise(mean, c), _chanwise(std, c)
    if images.dtype == np.uint8:
        out = np.empty(images.shape, np.float32)
        out[...] = (images.astype(np.float32) / 255.0 - mean) / std
        return out
    out = np.array(images, np.float32, order="C")  # always a fresh copy
    out[...] = (out - mean) / std
    return out


def resize_bilinear(images: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """float32 [B,H,W,C] -> [B,size[0],size[1],C], half-pixel bilinear."""
    images = np.ascontiguousarray(images, np.float32)
    b, sh, sw, c = images.shape
    dh, dw = size
    if (sh, sw) == (dh, dw):
        return images
    out = np.empty((b, dh, dw, c), np.float32)
    # gather the four corners with precomputed weights
    ys = np.maximum((np.arange(dh, dtype=np.float32) + 0.5) * (sh / dh) - 0.5,
                    0.0)
    xs = np.maximum((np.arange(dw, dtype=np.float32) + 0.5) * (sw / dw) - 0.5,
                    0.0)
    y0 = np.minimum(ys.astype(np.int64), sh - 1)
    x0 = np.minimum(xs.astype(np.int64), sw - 1)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = (ys - y0).astype(np.float32)[None, :, None, None]
    wx = (xs - x0).astype(np.float32)[None, None, :, None]
    rows0, rows1 = images[:, y0], images[:, y1]
    top = rows0[:, :, x0] * (1 - wx) + rows0[:, :, x1] * wx
    bot = rows1[:, :, x0] * (1 - wx) + rows1[:, :, x1] * wx
    out[...] = top * (1 - wy) + bot * wy
    return out


def center_crop(images: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """float32 [B,H,W,C] -> centered [B,size[0],size[1],C]."""
    images = np.ascontiguousarray(images, np.float32)
    _, h, w, _ = images.shape
    ch, cw = size
    if (h, w) == (ch, cw):
        return images
    if ch > h or cw > w:
        raise ValueError(f"crop {size} larger than image {(h, w)}")
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    return np.ascontiguousarray(images[:, y0:y0 + ch, x0:x0 + cw])


def preprocess_batch(images: np.ndarray, *, image_size: int,
                     mean=SIGLIP_MEAN, std=SIGLIP_STD,
                     crop: bool = False) -> np.ndarray:
    """Full inference-style pipeline: resize (shorter side or direct) ->
    optional center crop -> normalize. Input uint8/float [B,H,W,C]."""
    _, h, w, _ = images.shape
    if images.dtype == np.uint8:
        if not crop and (h, w) == (image_size, image_size):
            return to_float_normalized(images, mean, std)
        # u8 -> [0,1] f32 (mean 0 / std 1), then resize
        images = to_float_normalized(images, 0.0, 1.0)
    if crop and (h != w):
        scale = image_size / min(h, w)
        images = resize_bilinear(images, (round(h * scale), round(w * scale)))
        images = center_crop(images, (image_size, image_size))
    else:
        images = resize_bilinear(images, (image_size, image_size))
    return to_float_normalized(images, mean, std)
