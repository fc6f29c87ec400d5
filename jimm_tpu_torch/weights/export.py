"""HF-interoperable checkpoint export; the counterpart of
``jimm_tpu/weights/export.py``. Each model's mapping table, read backwards,
gives an HF-keyed state dict: transforms inverted, and the ``Chunk``
entries that share one fused torch tensor (the MAP head's ``in_proj_*``)
concatenated again."""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable

import torch
from torch import nn

from jimm_tpu_torch.weights.loader import Chunk, M
from jimm_tpu_torch.weights.safetensors_io import save_file


def to_hf_state_dict(model: nn.Module, entries: list[M]
                     ) -> dict[str, torch.Tensor]:
    params = dict(model.named_parameters())
    out: dict[str, torch.Tensor] = {}
    fused: dict[str, list[tuple[int, torch.Tensor]]] = {}
    for e in entries:
        t = params[e.dst].detach()
        if isinstance(e.transform, Chunk):
            fused.setdefault(e.src, []).append((e.transform.idx, t))
        else:
            out[e.src] = t if e.transform is None else e.transform.inv(t)
    for key, parts in fused.items():
        out[key] = torch.cat([t for _, t in sorted(parts, key=lambda p: p[0])])
    return out


def save_pretrained(model: nn.Module, save_dir: str | os.PathLike, *,
                    state_hook: Callable[[dict], dict] | None = None,
                    config_hook: Callable[[dict], dict] | None = None) -> None:
    """Write ``model.safetensors`` (metadata ``{"format": "pt"}``) and
    ``config.json``, readable by ``transformers`` and by both packages'
    ``from_pretrained``. ``state_hook(state_dict)`` and
    ``config_hook(config_dict)`` let a model write a format variant (SigLIP's
    ``flavor="siglip2"``); each returns its dict."""
    d = Path(save_dir)
    d.mkdir(parents=True, exist_ok=True)
    state = to_hf_state_dict(model, model.hf_mapping(model.config))
    if state_hook is not None:
        state = state_hook(state)
    config = model.hf_config()
    if config_hook is not None:
        config = config_hook(config)
    save_file(state, d / "model.safetensors", metadata={"format": "pt"})
    with open(d / "config.json", "w") as f:
        json.dump(config, f, indent=2)
