"""Host-side NaFlex preprocessing: raw images -> ``(patches, spatial_shapes,
mask)`` batches for ``SigLIP.encode_image_naflex``; the port's numpy copy of
``jimm_tpu/data/naflex.py``.

The semantics of HF's ``Siglip2ImageProcessor``: an aspect-preserving resize
to the largest patch-divisible size whose patch count fits
``max_num_patches`` (the binary-search rounding of HF's
``get_image_size_for_max_num_patches``, kept exactly), the
(row, col, channel)-flattened ``convert_image_to_patches`` layout, and
zero-padding to the fixed token budget with a mask.
"""

from __future__ import annotations

import math

import numpy as np

from jimm_tpu_torch.data.preprocess import resize_bilinear


def target_size_for_max_patches(height: int, width: int, patch_size: int,
                                max_num_patches: int,
                                eps: float = 1e-5) -> tuple[int, int]:
    """Largest aspect-preserving (h, w), both divisible by ``patch_size``
    and at least one patch, with ``(h/p) * (w/p) <= max_num_patches``.
    Rounding (ceil-to-patch after scaling, binary search on the scale)
    matches HF exactly, so the same image maps to the same grid."""
    def scaled(scale: float, size: int) -> int:
        s = math.ceil(size * scale / patch_size) * patch_size
        return max(patch_size, int(s))

    lo, hi = eps / 10, 100.0
    while (hi - lo) >= eps:
        mid = (lo + hi) / 2
        th, tw = scaled(mid, height), scaled(mid, width)
        if (th / patch_size) * (tw / patch_size) <= max_num_patches:
            lo = mid
        else:
            hi = mid
    return scaled(lo, height), scaled(lo, width)


def image_to_patches(image: np.ndarray, patch_size: int) -> np.ndarray:
    """(H, W, C) -> (gh*gw, p*p*C), rows flattened (patch_row, patch_col,
    channel): the layout the NaFlex Linear patch embedding expects."""
    h, w, c = image.shape
    gh, gw = h // patch_size, w // patch_size
    x = image.reshape(gh, patch_size, gw, patch_size, c)
    x = x.transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(x.reshape(gh * gw, -1))


def patchify_naflex(images: list[np.ndarray] | np.ndarray, *,
                    patch_size: int = 16, max_num_patches: int = 256
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Images (each (H, W, C) float, already value-normalized; a uniform
    (B, H, W, C) array also works) -> a NaFlex batch:

    Returns:
        patches: ``(B, max_num_patches, p*p*C)`` float32, zero-padded.
        spatial_shapes: ``(B, 2)`` int32 per-sample (h, w) patch grid.
        mask: ``(B, max_num_patches)`` bool, True at real tokens.
    """
    if isinstance(images, np.ndarray) and images.ndim == 4:
        images = list(images)
    batch, shapes, masks = [], [], []
    for im in images:
        im = np.asarray(im, np.float32)
        if im.ndim != 3:
            raise ValueError(f"expected (H, W, C) images, got {im.shape}")
        th, tw = target_size_for_max_patches(im.shape[0], im.shape[1],
                                             patch_size, max_num_patches)
        im = resize_bilinear(im[None], (th, tw))[0]
        p = image_to_patches(im, patch_size)
        n = p.shape[0]
        if n > max_num_patches:
            raise AssertionError(  # target_size guarantees n <= budget
                f"{n} patches > budget {max_num_patches}")
        pad = np.zeros((max_num_patches - n, p.shape[1]), np.float32)
        batch.append(np.concatenate([p, pad], axis=0))
        shapes.append((th // patch_size, tw // patch_size))
        m = np.zeros(max_num_patches, bool)
        m[:n] = True
        masks.append(m)
    return (np.stack(batch), np.asarray(shapes, np.int32), np.stack(masks))
