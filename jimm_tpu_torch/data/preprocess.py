"""Host-side image preprocessing; the port's copy of
``jimm_tpu/data/preprocess.py``: the normalization constants,
``to_float_normalized``, ``resize_bilinear`` (half-pixel centers, PIL /
``tf.image.resize`` semantics), ``center_crop``, ``preprocess_batch`` and
``decode_image_native``, each on the native C++ library
(``jimm_tpu_torch.data.native``: ``native/preprocess.cpp`` and
``native/decode.cpp``, multithreaded over the batch, built with g++ at first
use). The native calls release the interpreter lock, so a prefetch thread's
preprocessing overlaps the main thread's dispatch.

The numpy functions (``*_plain``) are the plain versions the tests hold the
native ones to (within ~1e-6); the main path never falls back to them.

Conventions: C-contiguous NHWC float32/uint8.
"""

from __future__ import annotations

import ctypes

import numpy as np

from jimm_tpu_torch.data import native

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


def decode_image_native(data: bytes) -> np.ndarray | None:
    """JPEG/PNG bytes -> uint8 [H, W, 3] RGB through libjpeg/libpng, or
    None whenever the native path cannot or should not take it: codecs not
    built, an image class the C side does not handle (alpha, palette,
    16-bit PNG, CMYK JPEG, decompression-bomb sizes), libjpeg warnings
    during header or scanline decode, or a corrupt body. The caller then
    hands the bytes to PIL, which makes the final accept/reject call, as
    in the JAX package."""
    lib = native.load()
    if not lib.jimm_has_image_codecs():
        return None
    h, w = ctypes.c_int64(0), ctypes.c_int64(0)
    if lib.jimm_image_info(data, len(data), ctypes.byref(h),
                           ctypes.byref(w)) != 0:
        return None  # needs PIL (1) or not an image (2: the caller raises)
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jimm_decode_image(data, len(data), out, h.value, w.value) != 0:
        return None  # suspect (1) or corrupt (-1): PIL decides
    return out


def to_float_normalized(images: np.ndarray, mean=SIGLIP_MEAN,
                        std=SIGLIP_STD) -> np.ndarray:
    """uint8 or float [B,H,W,C] -> float32, ``(x/255 - mean) / std`` (uint8)
    or ``(x - mean) / std`` (float input, assumed already in [0,1])."""
    b, h, w, c = images.shape
    mean, std = _chanwise(mean, c), _chanwise(std, c)
    lib = native.load()
    if images.dtype == np.uint8:
        images = np.ascontiguousarray(images)
        out = np.empty(images.shape, np.float32)
        lib.jimm_u8_to_f32_normalize(images, out, b, h, w, c, mean, std,
                                     native.threads())
        return out
    out = np.array(images, np.float32, order="C")  # always a fresh copy
    lib.jimm_f32_normalize(out, b, h, w, c, mean, std, native.threads())
    return out


def to_float_normalized_plain(images: np.ndarray, mean=SIGLIP_MEAN,
                              std=SIGLIP_STD) -> np.ndarray:
    """numpy version of :func:`to_float_normalized`."""
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
    native.load().jimm_resize_bilinear_f32(images, out, b, sh, sw, dh, dw, c,
                                           native.threads())
    return out


def resize_bilinear_plain(images: np.ndarray, size: tuple[int, int]
                          ) -> np.ndarray:
    """numpy version of :func:`resize_bilinear`."""
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


def _crop_box(shape: tuple[int, ...], size: tuple[int, int]
              ) -> tuple[int, int] | None:
    """The crop's top-left corner, or None when the image is that size."""
    _, h, w, _ = shape
    ch, cw = size
    if (h, w) == (ch, cw):
        return None
    if ch > h or cw > w:
        raise ValueError(f"crop {size} larger than image {(h, w)}")
    return (h - ch) // 2, (w - cw) // 2


def center_crop(images: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """float32 [B,H,W,C] -> centered [B,size[0],size[1],C]."""
    images = np.ascontiguousarray(images, np.float32)
    if _crop_box(images.shape, size) is None:
        return images
    b, h, w, c = images.shape
    out = np.empty((b, *size, c), np.float32)
    native.load().jimm_center_crop_f32(images, out, b, h, w, *size, c,
                                       native.threads())
    return out


def center_crop_plain(images: np.ndarray, size: tuple[int, int]
                      ) -> np.ndarray:
    """numpy version of :func:`center_crop`."""
    images = np.ascontiguousarray(images, np.float32)
    box = _crop_box(images.shape, size)
    if box is None:
        return images
    y0, x0 = box
    return np.ascontiguousarray(images[:, y0:y0 + size[0], x0:x0 + size[1]])


def _preprocess(images: np.ndarray, image_size: int, mean, std, crop: bool,
                normalize, resize, crop_to) -> np.ndarray:
    _, h, w, _ = images.shape
    if images.dtype == np.uint8:
        if not crop and (h, w) == (image_size, image_size):
            # one fused pass: u8 -> normalized f32
            return normalize(images, mean, std)
        # u8 -> [0,1] f32 (mean 0 / std 1), then resize
        images = normalize(images, 0.0, 1.0)
    if crop and (h != w):
        scale = image_size / min(h, w)
        images = resize(images, (round(h * scale), round(w * scale)))
        images = crop_to(images, (image_size, image_size))
    else:
        images = resize(images, (image_size, image_size))
    return normalize(images, mean, std)


def preprocess_batch(images: np.ndarray, *, image_size: int,
                     mean=SIGLIP_MEAN, std=SIGLIP_STD,
                     crop: bool = False) -> np.ndarray:
    """Full inference-style pipeline: resize (shorter side or direct) ->
    optional center crop -> normalize. Input uint8/float [B,H,W,C]."""
    return _preprocess(images, image_size, mean, std, crop,
                       to_float_normalized, resize_bilinear, center_crop)


def preprocess_batch_plain(images: np.ndarray, *, image_size: int,
                           mean=SIGLIP_MEAN, std=SIGLIP_STD,
                           crop: bool = False) -> np.ndarray:
    """numpy version of :func:`preprocess_batch`."""
    return _preprocess(images, image_size, mean, std, crop,
                       to_float_normalized_plain, resize_bilinear_plain,
                       center_crop_plain)
