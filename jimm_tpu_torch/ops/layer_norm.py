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
rstd, in one of two bodies chosen by the forward's rule
(:func:`backward_body` names it): one warp a row with x and do in
registers, or one CTA a row; each writes per-CTA f32 dscale/dbias partial
rows that a second kernel sums over CTAs in a fixed order (no atomics, so
the sums are deterministic). Both rows are bound by bytes on the H100 and
read and write each element once.

:class:`LayerNormFn` is the autograd Function (the counterpart of the JAX
``custom_vjp``): its forward runs :func:`layer_norm_fwd`'s kernel or plain
version and saves x, scale, mean and rstd; its backward runs
:func:`layer_norm_bwd`. A wrapper launches its kernel for CUDA tensors and
runs the plain version for CPU tensors; any other device raises. The
module-level ``launches`` and ``bwd_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from jimm_tpu_torch import _build
from jimm_tpu_torch.ops.library import define_op

#: forward / backward kernel launches since the count was last set to 0
launches = 0
bwd_launches = 0

#: the register bodies, forward and backward, take rows up to this wide
#: (csrc/layer_norm.cuh ``kRegisterMaxF``)
_REGISTER_MAX_F = 2048
#: the two forward bodies' kernel names, by :func:`forward_body`'s answer
FORWARD_KERNELS = {"register": "layer_norm_fwd_register_kernel",
                   "cta": "layer_norm_fwd_kernel"}
#: the two backward bodies' kernel names, by :func:`backward_body`'s answer
BACKWARD_KERNELS = {"register": "layer_norm_bwd_register_kernel",
                    "cta": "layer_norm_bwd_kernel"}


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


def _register_body(x: torch.Tensor, widest: int,
                   *others: torch.Tensor) -> bool:
    """Whether x's rows go to a register body (one warp a row, 16-byte
    vectors): F a multiple of a 16-byte vector's elements (8 bf16, 4 f32),
    F <= ``widest``, x and ``others`` starting on 16-byte boundaries."""
    f = x.shape[-1]
    return (f % (16 // x.element_size()) == 0 and f <= widest
            and all(t.data_ptr() % 16 == 0 for t in (x, *others)))


def forward_body(x: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> str:
    """Which forward kernel the C entry (``jimm_layer_norm_fwd``) launches
    for these operands, by the same rule: ``"register"`` (one warp a row,
    16-byte vectors) when F is a multiple of a 16-byte vector's elements
    (8 bf16, 4 f32), F <= 2048 and x, scale and bias start on 16-byte
    boundaries (y is a fresh allocation, always aligned); else ``"cta"``
    (one CTA a row)."""
    return ("register" if _register_body(x, _REGISTER_MAX_F, scale, bias)
            else "cta")


def backward_body(x: torch.Tensor, scale: torch.Tensor,
                  dy: torch.Tensor) -> str:
    """Which backward kernel the C entry (``jimm_layer_norm_bwd``) launches
    for these operands (``dy`` as the kernel reads it, contiguous), by the
    forward's rule: ``"register"`` (one warp a row, 16-byte vectors) when F
    is a multiple of a 16-byte vector's elements, F <= 2048 and x, scale and
    dy start on 16-byte boundaries (dx and the partial rows are fresh
    allocations, always aligned); else ``"cta"`` (one CTA a row)."""
    return ("register" if _register_body(x, _REGISTER_MAX_F, scale, dy)
            else "cta")


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
    second kernel that sums its per-CTA partial rows in a fixed order),
    :func:`layer_norm_bwd_plain` on CPU tensors."""
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
    if scale.dtype != x.dtype or scale.shape != (f,):
        raise ValueError(f"scale {scale.dtype} {tuple(scale.shape)} does not "
                         f"match x {x.dtype} (F = {f})")
    dx = torch.empty_like(x)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
    lib = _build.load()
    ctas = ctypes.c_int()
    with torch.cuda.device(x.device):
        # the C side sizes the grid: one partial row of dscale and of dbias
        # a CTA, which it then sums in a fixed order
        _build.check(lib.jimm_layer_norm_bwd_grid(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), rows, f, code,
            ctypes.byref(ctas)), "jimm_layer_norm_bwd_grid")
        part = torch.empty((2, ctas.value, f), dtype=torch.float32,
                           device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.jimm_layer_norm_bwd(
            x.data_ptr(), scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), part.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), rows, f, ctas.value, code, stream)
    _build.check(rc, "jimm_layer_norm_bwd")
    bwd_launches += 1
    return dx, dscale, dbias


#: :func:`_fwd` as the op ``jimm::layer_norm_fwd``, which a remat policy
#: can save (`jimm_tpu_torch/ops/library.py`)
fwd_op = define_op(
    "layer_norm_fwd(Tensor x, Tensor scale, Tensor bias, float eps) "
    "-> (Tensor, Tensor, Tensor)",
    lambda x, scale, bias, eps: _fwd(x, scale, bias, eps))


class LayerNormFn(torch.autograd.Function):
    """``(y, mean, rstd)`` of a fused LayerNorm, differentiable in x, scale
    and bias through y (mean and rstd are residuals, not differentiable).
    The forward goes through :data:`fwd_op`."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mu, rstd = fwd_op(x, scale, bias, eps)
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
