"""Checkpoint resolution over local files and directories; the counterpart
of ``jimm_tpu/weights/resolve.py`` with the same precedence: a sharded
``model.safetensors.index.json``, ``model.safetensors``, any
``*.safetensors``, then ``pytorch_model.bin`` (sharded or single), the
``.bin`` first when ``use_pytorch=True``; a file's config from its sibling
``config.json``, or from the parent of a ``model/`` directory. ``.bin``
files are read by ``torch.load(..., weights_only=True)``. Hub downloads are
not ported (ROADMAP.md queue 1, item 4): a name the JAX package would fetch
from the hub is refused.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Callable

import torch

from jimm_tpu_torch.weights.safetensors_io import load_file

_TORCH_SUFFIXES = (".bin", ".pt", ".pth")

Weights = dict[str, torch.Tensor]


def load_torch_file(path: str | os.PathLike) -> Weights:
    """A ``pytorch_model.bin`` state dict, on the CPU, unpickled with
    ``weights_only=True`` (tensors and plain containers only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_config(path: Path) -> dict[str, Any] | None:
    if path.is_file():
        with open(path) as f:
            return json.load(f)
    return None


def _sharded(d: Path, index: Path, loader: Callable[[Path], Weights]
             ) -> Weights:
    with open(index) as f:
        weight_map: dict[str, str] = json.load(f)["weight_map"]
    weights: Weights = {}
    for shard in sorted(set(weight_map.values())):
        weights.update(loader(d / shard))
    return weights


def _torch_format(d: Path) -> Weights | None:
    index = d / "pytorch_model.bin.index.json"
    if index.is_file():
        return _sharded(d, index, load_torch_file)
    single = d / "pytorch_model.bin"
    return load_torch_file(single) if single.is_file() else None


def _from_dir(d: Path, use_pytorch: bool) -> tuple[Weights, dict | None]:
    config = _load_config(d / "config.json")
    if use_pytorch:
        weights = _torch_format(d)
        if weights is None:
            raise FileNotFoundError(f"no pytorch_model.bin under {d}")
        return weights, config
    index = d / "model.safetensors.index.json"
    if index.is_file():
        return _sharded(d, index, load_file), config
    single = d / "model.safetensors"
    if single.is_file():
        return load_file(single), config
    candidates = sorted(d.glob("*.safetensors"))
    if candidates:
        weights: Weights = {}
        for c in candidates:
            weights.update(load_file(c))
        return weights, config
    # the torch format only when no safetensors exist at all
    weights = _torch_format(d)
    if weights is None:
        raise FileNotFoundError(f"no .safetensors or pytorch_model.bin "
                                f"weights under {d}")
    return weights, config


def _from_file(p: Path) -> tuple[Weights, dict | None]:
    weights = (load_torch_file(p) if p.suffix in _TORCH_SUFFIXES
               else load_file(p))
    config = _load_config(p.parent / "config.json")
    if config is None and p.parent.name == "model":
        config = _load_config(p.parent.parent / "config.json")
    return weights, config


def resolve_checkpoint(name_or_path: str | os.PathLike, *,
                       use_pytorch: bool = False
                       ) -> tuple[Weights, dict | None]:
    """Return ``(flat HF tensor dict, HF config dict | None)`` for a local
    checkpoint file or directory."""
    p = Path(name_or_path).expanduser()
    if p.is_dir():
        return _from_dir(p, use_pytorch)
    if p.is_file():
        return _from_file(p)
    name = str(name_or_path)
    if name.startswith((".", "/", "~")) or name.count("/") != 1:
        raise FileNotFoundError(f"no checkpoint file or directory at {name!r}")
    raise NotImplementedError(
        f"{name!r} is not a local path, and hub downloads are not ported "
        f"(ROADMAP.md queue 1, item 4): pass a local checkpoint directory "
        f"or file")
