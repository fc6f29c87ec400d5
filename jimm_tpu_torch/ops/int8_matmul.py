"""int8 x int8 matmul with a fused dequantizing epilogue (W8A8), its plain
version, the per-row activation quantizer, and the differentiable
``quantized_linear``; the counterpart of ``jimm_tpu/ops/int8_matmul.py``.

Kernel row 11 of the port's kernel table replaces the Pallas TPU kernel
``jimm_tpu/ops/int8_matmul.py::_matmul_kernel``; its CUDA source is
``jimm_tpu_torch/csrc/int8_matmul.cu``: an exact s32 accumulation with s8
``wgmma`` on operands brought by TMA, then ``((float)acc * x_scale[m]) *
w_scale[n] + bias[n]`` and an optional relu or exact-erf gelu, f32 out,
each epilogue step rounded on its own as XLA rounds the TPU kernel's.

The scheme is symmetric and zero-point free: weights carry one f32 scale per
output channel (``jimm_tpu_torch.quant.quantize_linear``), activations one
per row (:func:`quantize_rows`), so dequantization is a rank-1 rescale of
the accumulator. The port keeps ``w_q`` in the ``nn.Linear`` layout
``(N, K)``, K-contiguous like ``x_q``; the JAX kernel takes ``(K, N)``, the
same numbers transposed. Both are K-major, the layout 8-bit ``wgmma``
reads; TMA needs K a multiple of 16 and 16-byte aligned bases, so the
wrapper zero-pads K of both copies otherwise (:func:`tma_operands`, shared
with the fp8 GEMM; a zero product adds nothing).

:func:`int8_matmul` launches the kernel for CUDA tensors and runs
:func:`int8_matmul_plain` for CPU tensors; any other device raises. The
module-level ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jimm_tpu_torch import _build
from jimm_tpu_torch.ops.fp8_matmul import tma_operands

#: kernel launches since the count was last set to 0
launches = 0

#: the C interface's activation codes (csrc/int8_matmul.cu ``Activation``)
_ACTIVATIONS = {None: 0, "relu": 1, "gelu": 2}


def _check_activation(activation: str | None) -> int:
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown fused activation {activation!r}; "
                         f"supported: None, 'relu', 'gelu'")
    return _ACTIVATIONS[activation]


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 quantization over the last axis:
    ``(x_q int8, scale f32)`` with ``scale = max|row| / 127`` (1.0 for an
    all-zero row, so dequantization stays finite), ``x_q = round(x / scale)``
    half to even, clipped to +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    x_q = torch.round(xf / scale[..., None]).clamp_(-127, 127)
    return x_q.to(torch.int8), scale


def _epilogue(acc: torch.Tensor, x_scale: torch.Tensor,
              w_scale: torch.Tensor, bias: torch.Tensor | None,
              activation: str | None) -> torch.Tensor:
    """The kernel's epilogue as separate ops (no FMA contraction):
    ``((acc * x_scale) * w_scale) + bias``, then the activation."""
    y = acc * x_scale.float()[:, None]
    y = y * w_scale.float()[None, :]
    if bias is not None:
        y = y + bias.float()[None, :]
    if activation == "relu":
        y = torch.clamp_min(y, 0.0)
    elif activation == "gelu":
        y = F.gelu(y)
    return y


def int8_matmul_plain(x_q: torch.Tensor, x_scale: torch.Tensor,
                      w_q: torch.Tensor, w_scale: torch.Tensor,
                      bias: torch.Tensor | None = None, *,
                      activation: str | None = None) -> torch.Tensor:
    """The same function in plain PyTorch. PyTorch has no int32 matmul on
    CUDA tensors, so the s32 accumulation is an f64 matmul of the int8
    values, exact while |acc| < 2^53 (K * 127^2 is far below); its f64 -> f32
    cast rounds to nearest even, as the kernel's s32 -> f32 does."""
    _check_activation(activation)
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64).T).float()
    return _epilogue(acc, x_scale, w_scale, bias, activation)


def _check(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
           w_scale: torch.Tensor, bias: torch.Tensor | None) -> None:
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q (N, K) "
                         f"{tuple(w_q.shape)} do not agree")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"x_q and w_q must be int8, not {x_q.dtype}, "
                         f"{w_q.dtype}")
    m, n = x_q.shape[0], w_q.shape[0]
    if tuple(x_scale.shape) != (m,) or tuple(w_scale.shape) != (n,):
        raise ValueError(f"scales {tuple(x_scale.shape)}, "
                         f"{tuple(w_scale.shape)} do not match (M,)=({m},), "
                         f"(N,)=({n},)")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} is not (N,)=({n},)")


def int8_matmul(x_q: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor, bias: torch.Tensor | None = None, *,
                activation: str | None = None) -> torch.Tensor:
    """Fused dequantizing matmul ``(x_q * x_scale[:, None]) @ (w_q *
    w_scale[:, None]).T + bias`` with an optional fused activation, f32 out.

    Args:
        x_q: ``(M, K)`` int8 activations (see :func:`quantize_rows`).
        x_scale: ``(M,)`` f32 per-row activation scales.
        w_q: ``(N, K)`` int8 weights (per-output-channel symmetric).
        w_scale: ``(N,)`` f32 per-output-channel weight scales.
        bias: optional ``(N,)`` bias added in f32 after dequantization.
        activation: ``None`` / ``"relu"`` / ``"gelu"`` fused epilogue.
    """
    global launches
    _check(x_q, x_scale, w_q, w_scale, bias)
    code = _check_activation(activation)
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, x_scale, w_q, w_scale, bias,
                                 activation=activation)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CUDA or CPU tensors, not "
                         f"{x_q.device.type}")
    operands = [x_scale, w_scale] + ([] if bias is None else [bias])
    if w_q.device != x_q.device or any(
            t.dtype != torch.float32 or t.device != x_q.device
            for t in operands):
        raise ValueError("int8_matmul kernel takes w_q, and f32 scales and "
                         "bias, on the device of x_q")
    if not all(t.is_contiguous() for t in operands + [x_q, w_q]):
        raise ValueError("int8_matmul kernel needs contiguous operands")
    m, n = x_q.shape[0], w_q.shape[0]
    x_q, w_q = tma_operands(x_q, w_q)
    k = x_q.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    lib = _build.load()
    with torch.cuda.device(x_q.device):
        stream = torch.cuda.current_stream(x_q.device).cuda_stream
        rc = lib.jimm_int8_matmul(
            x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(),
            w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), m, n, k, code, stream)
    _build.check(rc, "jimm_int8_matmul")
    launches += 1
    return out


class QuantizedLinearFn(torch.autograd.Function):
    """One W8A8 linear layer over ``(M, K)`` float input, f32 out; the
    counterpart of the JAX ``custom_vjp`` ``_quantized_linear``. Its
    backward is the straight-through estimator: ``dx = dy @ dequant(w_q)``
    in f32, cast to x's dtype; ``dbias = sum(dy)``; the int8 weights and
    their scales get no gradient (they are frozen quantization artifacts,
    and the port keeps them as buffers). A fused activation has no
    gradient, as in JAX."""

    @staticmethod
    def forward(ctx, x, w_q, w_scale, bias, activation):
        x_q, x_scale = quantize_rows(x)
        y = int8_matmul(x_q, x_scale, w_q, w_scale, bias,
                        activation=activation)
        ctx.save_for_backward(w_q, w_scale)
        ctx.activation = activation
        ctx.x_dtype = x.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        if ctx.activation is not None:
            raise NotImplementedError(
                "gradients through a fused int8 activation epilogue are not "
                "supported; run with activation=None when training")
        w_q, w_scale = ctx.saved_tensors
        dy = dy.float()
        w_deq = w_q.float() * w_scale.float()[:, None]
        dx = (dy @ w_deq).to(ctx.x_dtype)
        dbias = (None if ctx.bias_dtype is None
                 else dy.sum(dim=0).to(ctx.bias_dtype))
        return dx, None, None, dbias, None


def quantized_linear(x: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor, bias: torch.Tensor | None = None,
                     *, activation: str | None = None) -> torch.Tensor:
    """One W8A8 linear layer over float ``(M, K)`` input: quantize the
    activations per row, run the fused matmul, return f32 ``(M, N)``.
    Differentiable with ``activation=None`` (see :class:`QuantizedLinearFn`).
    """
    return QuantizedLinearFn.apply(x, w_q, w_scale, bias, activation)
