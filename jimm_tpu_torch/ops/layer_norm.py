"""Fused LayerNorm, forward and backward: hand-written CUDA kernels, their
plain versions, and the ``torch.autograd.Function`` that joins them.

Kernel row 1 of the port's kernel table replaces the Pallas TPU kernel
``jimm_tpu/ops/layer_norm.py::_fwd_kernel``; its CUDA source is
``jimm_tpu_torch/csrc/layer_norm.cu``: two-pass statistics (mean, then
centred variance) in one of two bodies, chosen by shape (:func:`forward_body`
names it): one warp a row with the row in registers as f32 (every preset
width), or one CTA a row with the row in shared memory (rows wider than
2048, an F off the 16-byte vector, views off a 16-byte boundary).
Kernel row 2 replaces ``::_bwd_kernel``; its source is
``jimm_tpu_torch/csrc/layer_norm_bwd.cu``: dx from the saved f32 mean and
rstd, and per-CTA f32 dscale/dbias partial rows that :func:`layer_norm_bwd`
sums over CTAs (no atomics, so the sums are deterministic). Both are bound
by bytes on the H100 and read and write each element once.

:class:`LayerNormFn` is the autograd Function (the counterpart of the JAX
``custom_vjp``): its forward runs :func:`layer_norm_fwd`'s kernel or plain
version and saves x, scale, mean and rstd; its backward runs
:func:`layer_norm_bwd`. A wrapper launches its kernel for CUDA tensors and
runs the plain version for CPU tensors; any other device raises. The
module-level ``launches`` and ``bwd_launches`` count kernel launches.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from jimm_tpu_torch import _build

#: forward / backward kernel launches since the count was last set to 0
launches = 0
bwd_launches = 0

#: backward CTAs per SM: each walks a strided set of rows and writes one
#: f32 partial row of dscale and of dbias. On the H100 at (32768, 768) bf16,
#: 8 beat 4 (more rows in flight) and 16 or 32 (larger partial sums)
_BWD_CTAS_PER_SM = 8

#: the forward's register body takes rows up to this wide
#: (csrc/layer_norm.cu ``kRegisterMaxF``)
_REGISTER_MAX_F = 2048
#: the two forward bodies' kernel names, by :func:`forward_body`'s answer
FORWARD_KERNELS = {"register": "layer_norm_fwd_register_kernel",
                   "cta": "layer_norm_fwd_kernel"}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions compute in f32 (f64 for f64 input, as gradcheck
    needs)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: ``(y, mean, rstd)`` over the last
    axis of ``(rows, F)`` input, f32 statistics, biased variance."""
    acc = _acc_dtype(x.dtype)
    xf = x.to(acc)
    mu = xf.sum(dim=1) / x.shape[1]
    xc = xf - mu[:, None]
    var = (xc * xc).sum(dim=1) / x.shape[1]
    rstd = torch.rsqrt(var + eps)
    y = (xc * rstd[:, None]) * scale.to(acc) + bias.to(acc)
    return y.to(x.dtype), mu, rstd


def layer_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         mean: torch.Tensor, rstd: torch.Tensor,
                         dy: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in plain PyTorch: ``(dx, dscale, dbias)`` from the
    forward's statistics; dx in the dtype of x, dscale/dbias summed in f32
    and returned in the dtype of scale (as ``_ln_bwd`` casts them)."""
    acc = _acc_dtype(x.dtype)
    f = x.shape[1]
    xhat = (x.to(acc) - mean.to(acc)[:, None]) * rstd.to(acc)[:, None]
    do = dy.to(acc)
    dyg = do * scale.to(acc)
    m1 = dyg.sum(dim=1, keepdim=True) / f
    m2 = (dyg * xhat).sum(dim=1, keepdim=True) / f
    dx = rstd.to(acc)[:, None] * (dyg - m1 - xhat * m2)
    return (dx.to(x.dtype), (do * xhat).sum(dim=0).to(scale.dtype),
            do.sum(dim=0).to(scale.dtype))


def forward_body(x: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> str:
    """Which forward kernel the C entry (``jimm_layer_norm_fwd``) launches
    for these operands, by the same rule: ``"register"`` (one warp a row,
    16-byte vectors) when F is a multiple of a 16-byte vector's elements
    (8 bf16, 4 f32), F <= 2048 and x, scale and bias start on 16-byte
    boundaries (y is a fresh allocation, always aligned); else ``"cta"``
    (one CTA a row)."""
    f = x.shape[-1]
    per_vector = 16 // x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, bias))
    return ("register" if f % per_vector == 0 and f <= _REGISTER_MAX_F
            and aligned else "cta")


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


def _kernel_dtype(x: torch.Tensor) -> int:
    """The C interface's dtype code for a CUDA tensor; other devices and
    dtypes raise."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on CUDA or CPU tensors, not "
                         f"{x.device.type}")
    dtype = str(x.dtype).removeprefix("torch.")
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"layer_norm kernel takes float32 or bfloat16, "
                         f"not {x.dtype}")
    return _build.DTYPE_CODES[dtype]


def _fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
         eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel on a CUDA tensor, the plain version on a CPU one."""
    global launches
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    code = _kernel_dtype(x)
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
            mu.data_ptr(), rstd.data_ptr(), rows, f, float(eps), code, stream)
    _build.check(rc, "jimm_layer_norm_fwd")
    launches += 1
    return y, mu, rstd


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, dy: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dscale, dbias)``: the backward kernel on CUDA tensors (then a
    sum of its per-CTA partials), :func:`layer_norm_bwd_plain` on CPU
    tensors."""
    global bwd_launches
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, scale, mean, rstd, dy)
    code = _kernel_dtype(x)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match x "
                         f"{x.dtype} {tuple(x.shape)}")
    dy = dy.contiguous()
    if not (x.is_contiguous() and scale.is_contiguous()
            and mean.is_contiguous() and rstd.is_contiguous()):
        raise ValueError("layer_norm backward kernel needs contiguous x, "
                         "scale, mean, rstd")
    rows, f = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ctas = max(1, min(rows, _BWD_CTAS_PER_SM * sms))
    dx = torch.empty_like(x)
    dg_part = torch.empty((ctas, f), dtype=torch.float32, device=x.device)
    db_part = torch.empty((ctas, f), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.jimm_layer_norm_bwd(
            x.data_ptr(), scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dg_part.data_ptr(),
            db_part.data_ptr(), rows, f, ctas, code, stream)
    _build.check(rc, "jimm_layer_norm_bwd")
    bwd_launches += 1
    return (dx, dg_part.sum(dim=0).to(scale.dtype),
            db_part.sum(dim=0).to(scale.dtype))


class LayerNormFn(torch.autograd.Function):
    """``(y, mean, rstd)`` of a fused LayerNorm, differentiable in x, scale
    and bias through y (mean and rstd are residuals, not differentiable)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mu, rstd = _fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mu, rstd)
        ctx.mark_non_differentiable(mu, rstd)
        return y, mu, rstd

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, _dmu, _drstd):
        x, scale, mu, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, scale, mu, rstd, dy)
        return dx, dscale, dbias, None


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, rstd)``: y in the dtype of x, mean and rstd ``(rows,)``
    f32 (the residuals the backward reads). Differentiable through y."""
    _check(x, scale, bias)
    return LayerNormFn.apply(x, scale, bias, eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Fused LayerNorm over the last axis of ``(rows, F)`` input."""
    return layer_norm_fwd(x, scale, bias, eps)[0]
