"""Fused LayerNorm forward: a hand-written CUDA kernel and its plain version.

Kernel row 1 of the port's kernel table: it replaces the Pallas TPU kernel
``jimm_tpu/ops/layer_norm.py::_fwd_kernel``. The CUDA source is
``jimm_tpu_torch/csrc/layer_norm.cu``: one CTA per row, the row widened to
f32 in shared memory, two-pass statistics (mean, then centred variance).
It is bound by bytes on the H100 (one read of x, one write of y; ~8 flops an
element), and the design reads and writes each element exactly once.

:func:`layer_norm_fwd` launches the kernel for a CUDA tensor and runs
:func:`layer_norm_plain` for a CPU tensor; any other device raises. The
module-level ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from jimm_tpu_torch import _build

#: kernel launches since the count was last set to 0
launches = 0


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: ``(y, mean, rstd)`` over the last
    axis of ``(rows, F)`` input, f32 statistics, biased variance."""
    xf = x.float()
    mu = xf.sum(dim=1) / x.shape[1]
    xc = xf - mu[:, None]
    var = (xc * xc).sum(dim=1) / x.shape[1]
    rstd = torch.rsqrt(var + eps)
    y = (xc * rstd[:, None]) * scale.float() + bias.float()
    return y.to(x.dtype), mu, rstd


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"layer_norm takes (rows, F) input, got {tuple(x.shape)}")
    f = x.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (f,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({f},)")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} must match x in dtype and device "
                             f"({t.dtype}, {t.device} vs {x.dtype}, {x.device})")


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, rstd)``: y in the dtype of x, mean and rstd ``(rows,)``
    f32 (the residuals the backward will read)."""
    global launches
    _check(x, scale, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on CUDA or CPU tensors, not "
                         f"{x.device.type}")
    dtype = str(x.dtype).removeprefix("torch.")
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"layer_norm kernel takes float32 or bfloat16, "
                         f"not {x.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("layer_norm kernel needs contiguous x, scale, bias")
    rows, f = x.shape
    y = torch.empty_like(x)
    mu = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.jimm_layer_norm_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mu.data_ptr(), rstd.data_ptr(), rows, f, float(eps),
            _build.DTYPE_CODES[dtype], stream)
    _build.check(rc, "jimm_layer_norm_fwd")
    launches += 1
    return y, mu, rstd


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Fused LayerNorm over the last axis of ``(rows, F)`` input."""
    return layer_norm_fwd(x, scale, bias, eps)[0]
