"""Host-side image resizing; the port's numpy copy of the part of
``jimm_tpu/data/preprocess.py`` that NaFlex batching needs: the numpy path
of ``resize_bilinear`` (half-pixel centers, PIL / ``tf.image.resize``
semantics). The JAX package may take a native C++ path for the same
function, which agrees with this one to ~1e-6."""

from __future__ import annotations

import numpy as np


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
