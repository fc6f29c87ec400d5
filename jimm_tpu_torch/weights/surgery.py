"""Checkpoint surgery: a pretrained position table resampled for another
image size at load time (``from_pretrained(..., image_size=...)``, the
higher-resolution fine-tune recipe); the counterpart of
``jimm_tpu/weights/surgery.py``, bilinear through the port's numpy
``data/preprocess.py::resize_bilinear``.
"""

from __future__ import annotations

import dataclasses

import torch

from jimm_tpu_torch.data.preprocess import resize_bilinear


def interpolate_pos_embed(pos: torch.Tensor, new_grid: int, *,
                          n_prefix: int = 0) -> torch.Tensor:
    """Resample a ViT position-embedding table to a new square grid.

    - ``pos``: ``(P, H)`` or ``(1, P, H)`` with ``P = n_prefix + g*g``
      (``n_prefix`` class tokens first, then the row-major grid).
    - ``new_grid``: the new side; the output has ``n_prefix + new_grid^2``
      positions, the input's rank and dtype.
    """
    squeeze = pos.ndim == 2
    arr = pos[None] if squeeze else pos
    if arr.ndim != 3:
        raise ValueError(f"pos embed must be (P, H) or (1, P, H), "
                         f"got {tuple(pos.shape)}")
    n_grid = arr.shape[1] - n_prefix
    old_grid = int(round(n_grid ** 0.5))
    if old_grid * old_grid != n_grid:
        raise ValueError(f"{n_grid} grid positions is not a square grid")
    if old_grid != new_grid:
        grid = arr[:, n_prefix:].reshape(old_grid, old_grid, -1)
        resized = resize_bilinear(grid[None].float().cpu().numpy(),
                                  (new_grid, new_grid))[0]
        arr = torch.cat([arr[:, :n_prefix].float().cpu(),
                         torch.from_numpy(resized).reshape(
                             1, new_grid * new_grid, -1)], dim=1
                        ).to(arr.dtype)
    return arr[0] if squeeze else arr


def resize_checkpoint_pos_embed(weights: dict, key: str, *, patch_size: int,
                                image_size: int, n_prefix: int) -> dict:
    """A copy of ``weights`` with ``weights[key]`` resampled for
    ``image_size``, which must be a multiple of ``patch_size``."""
    if image_size % patch_size:
        raise ValueError(f"image_size {image_size} is not a multiple of "
                         f"patch_size {patch_size}")
    out = dict(weights)
    out[key] = interpolate_pos_embed(weights[key], image_size // patch_size,
                                     n_prefix=n_prefix)
    return out


def apply_image_size(weights: dict, cfg, image_size: int | None, *,
                     key: str, n_prefix: int):
    """``(weights, cfg)`` adapted to ``image_size`` (as they are when it is
    unset or already the config's). ``key`` is the family's HF position
    table and ``n_prefix`` its class-token count (0 for SigLIP's MAP
    grid)."""
    if not image_size or image_size == cfg.vision.image_size:
        return weights, cfg
    weights = resize_checkpoint_pos_embed(
        weights, key, patch_size=cfg.vision.patch_size,
        image_size=image_size, n_prefix=n_prefix)
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, image_size=image_size))
    return weights, cfg
