"""In-place int8 model surgery for the serving fast path; the counterpart of
``jimm_tpu/quant/__init__.py``.

:func:`quantize_model` walks a built model and swaps every eligible
``nn.Linear`` for a :class:`QuantLinear` holding symmetric
per-output-channel int8 weights and f32 scales. Its forward quantizes the
activations per row (W8A8) and runs the fused int8 matmul of
``ops/int8_matmul.py`` (kernel row 11 on the card).

Skipped, as in the JAX package:

- ``Attention`` q/k/v when ``fused_qkv`` is on: that path concatenates the
  three weights into one ``(3H, H)`` matmul; the out projection is still
  quantized.
- Everything that is not an ``nn.Linear`` (the conv patch embed, token and
  positional embeddings, norms).

The port's blocks are separate modules, so it counts each layer's Linear
once (151 for SigLIP-B/16), where the JAX package counts a stacked role
once.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from jimm_tpu_torch.nn.transformer import Attention
from jimm_tpu_torch.ops.int8_matmul import quantized_linear

__all__ = ["QuantLinear", "quantize_linear", "quantize_model"]


class QuantLinear(nn.Module):
    """An ``nn.Linear`` replacement holding int8 weights and f32 scales.

    ``w_q`` is the ``(out, in)`` int8 weight and ``scale`` its
    ``(out,)`` f32 per-output-channel scale, both buffers: no optimizer and
    no ``next(model.parameters())`` ever meets an int8 tensor. ``bias``
    stays an f32 parameter, as in the JAX module. The output comes back in
    the replaced Linear's dtype, so downstream modules see the interface of
    the Linear they replaced.
    """

    def __init__(self, w_q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor | None = None, *,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)
        self.bias = None if bias is None else nn.Parameter(bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = quantized_linear(x.reshape(-1, x.shape[-1]), self.w_q,
                             self.scale, self.bias)
        return y.reshape(*lead, self.w_q.shape[0]).to(self.dtype)


@torch.no_grad()
def quantize_linear(lin: nn.Linear) -> QuantLinear:
    """Symmetric per-output-channel int8 surgery on one Linear: reduces the
    ``(out, in)`` weight over ``in``, the numbers the JAX package gets from
    its ``(in, out)`` kernel's axis -2."""
    w = lin.weight.detach().float()
    amax = w.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w_q = torch.round(w / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    bias = None if lin.bias is None else lin.bias.detach().float().clone()
    return QuantLinear(w_q, scale, bias, dtype=lin.weight.dtype)


def _skip(parent: nn.Module, name: str) -> bool:
    return (isinstance(parent, Attention)
            and getattr(parent, "fused_qkv", False)
            and name in ("q", "k", "v"))


def swap_linears(module: nn.Module, swap: Callable[[nn.Linear], nn.Module],
                 seen: set[int] | None = None) -> int:
    """Replace every eligible ``nn.Linear`` under ``module`` (in place) with
    ``swap(linear)``; returns the number replaced. The eligibility rule of
    the JAX package's surgery: q/k/v under ``fused_qkv`` stay."""
    seen = set() if seen is None else seen
    if id(module) in seen:
        return 0
    seen.add(id(module))
    count = 0
    for name, child in list(module.named_children()):
        if isinstance(child, nn.Linear):
            if _skip(module, name):
                continue
            setattr(module, name, swap(child))
            count += 1
        else:
            count += swap_linears(child, swap, seen)
    return count


def quantize_model(model: nn.Module) -> int:
    """Replace every eligible ``nn.Linear`` in ``model`` (in place) with a
    :class:`QuantLinear`. Returns the number of Linear modules replaced."""
    return swap_linears(model, quantize_linear)
