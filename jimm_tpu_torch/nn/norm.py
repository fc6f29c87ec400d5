"""LayerNorm module over the fused LayerNorm kernels
(`jimm_tpu_torch/ops/layer_norm.py`, forward and backward through
``LayerNormFn``); the counterpart of ``jimm_tpu/nn/norm.py::FusedLayerNorm``."""

from __future__ import annotations

import torch
from torch import nn

from jimm_tpu_torch.ops.layer_norm import layer_norm


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis with ``weight``/``bias`` like
    ``nn.LayerNorm``. x, weight and bias meet in the module's dtype (the
    compute dtype) before the kernel, as the JAX module casts them; the
    weight and bias gradients come back in that dtype."""

    def __init__(self, dim: int, *, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).to(self.weight.dtype).contiguous()
        return layer_norm(x2, self.weight, self.bias, self.eps).reshape(shape)
