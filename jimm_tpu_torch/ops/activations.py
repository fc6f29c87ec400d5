"""Activation functions, by the names the JAX package resolves
(``jimm_tpu/ops/activations.py``): ``gelu`` is the erf GELU, ``gelu_tanh``
(HF ``gelu_pytorch_tanh`` / ``gelu_new``) the tanh approximation,
``quick_gelu`` OpenAI CLIP's sigmoid approximation."""

from __future__ import annotations

import warnings
from typing import Callable

import torch
import torch.nn.functional as F


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's GELU approximation: ``x * sigmoid(1.702 * x)``."""
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu_exact,
    "gelu_tanh": gelu_tanh,
    "gelu_pytorch_tanh": gelu_tanh,
    "gelu_new": gelu_tanh,
    "quick_gelu": quick_gelu,
    "relu": F.relu,
    "silu": F.silu,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation by (HF) name; an unknown name warns and falls
    back to gelu_tanh, as the JAX package does."""
    if name not in _ACTS:
        warnings.warn(f"unknown activation {name!r}; falling back to gelu_tanh")
        return gelu_tanh
    return _ACTS[name]
