"""Flash attention with int8-quantized Q and K, forward and backward:
hand-written CUDA kernels, their plain versions, and the
``torch.autograd.Function`` that joins them; the counterpart of
``jimm_tpu/ops/flash_attention_int8.py``.

Q and K are quantized symmetrically per ``(batch, position, head)`` row over
the head dim (:func:`quantize_heads`, scale ``max|row| / 127``), the score
is an exact s32 dot of the int8 rows, dequantized through the two rows'
scales, and the softmax and the P.V product stay in f32 and the storage
dtype; V is not quantized.

Kernel row 9 of the port's kernel table replaces the Pallas TPU kernel
``jimm_tpu/ops/flash_attention_int8.py::_fwd_kernel``; its CUDA source is
``jimm_tpu_torch/csrc/flash_attention_int8.cu``. Kernel row 10 replaces
``::_bwd_dq_kernel`` and ``::_bwd_dkv_kernel``; its source is
``jimm_tpu_torch/csrc/flash_attention_int8_bwd.cu``. Both keep the FA2
arrangement of the softmax flash kernels, with the scores on ``__dp4a``.

:class:`FlashAttentionInt8Fn` (the counterpart of the JAX ``custom_vjp``
``_flash_int8``) quantizes q and k, saves the int8 tensors the forward
multiplied (one byte an element), their scales, v, o and lse, and
recomputes the score tiles from them in the backward, so the softmax
recomputation is exact; the gradient reaches q and k straight through the
quantizer, and the scales get none. There is no mask, no bias and no lse
output. A wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors; any other device raises. The module-level
``launches`` and ``bwd_launches`` count kernel launches (one backward call
launches the dq and the dk/dv kernel and counts once).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from jimm_tpu_torch import _build
from jimm_tpu_torch.ops.library import define_op
from jimm_tpu_torch.ops.flash_attention import (NEG_INF, _acc_dtype, _check,
                                                _delta, _kernel_dtype,
                                                _strides)

#: forward / backward kernel launches since the count was last set to 0
launches = 0
bwd_launches = 0


def quantize_heads(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of ``(B, S, N, D)`` q or k over D:
    ``(x_q, scale)`` with x_q ``(B, S, N, D)`` int8 (contiguous) and scale
    ``(B, N, S)`` f32 (the lse layout), ``max|row| / 127`` or 1.0 for an
    all-zero row; ``round(x / scale)`` half to even, clipped to +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    x_q = torch.round(xf / scale[..., None]).clamp_(-127, 127)
    return (x_q.to(torch.int8).contiguous(),
            scale.transpose(1, 2).contiguous())


def _scores(qq: torch.Tensor, qs: torch.Tensor, kq: torch.Tensor,
            ks: torch.Tensor, is_causal: bool, acc: torch.dtype
            ) -> torch.Tensor:
    """``(B, N, Sq, Sk)`` dequantized scores in the kernels' order,
    ``((s * q_scale) * k_scale) * sm_scale``, with dropped scores at -1e30.
    The s32 dot runs as a float matmul of the int8 values: every partial sum
    is an integer below D * 127^2 <= 2^22, so it is exact."""
    sq, sk, d = qq.shape[1], kq.shape[1], qq.shape[-1]
    s = torch.einsum("bqnd,bknd->bnqk", qq.to(acc), kq.to(acc))
    s = s * qs.to(acc)[..., None]
    s = s * ks.to(acc)[:, :, None, :]
    s = s * (1.0 / d ** 0.5)
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_attention_int8_plain(qq: torch.Tensor, qs: torch.Tensor,
                               kq: torch.Tensor, ks: torch.Tensor,
                               v: torch.Tensor, *, is_causal: bool = False
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward in plain PyTorch from the quantized q and k: ``(o, lse)``,
    o ``(B, Sq, N, D)`` in v's dtype, lse ``(B, N, Sq)`` f32. One softmax
    pass over all keys; P.V takes p rounded to v's dtype, as the kernels
    do."""
    acc = _acc_dtype(v.dtype)
    s = _scores(qq, qs, kq, ks, is_causal, acc)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).to(acc), v.to(acc))
    o = out / l.permute(0, 2, 1, 3)
    return o.to(v.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_int8_bwd_plain(qq: torch.Tensor, qs: torch.Tensor,
                                   kq: torch.Tensor, ks: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor, *,
                                   is_causal: bool = False
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The backward in plain PyTorch: ``(dq, dk, dv)`` in v's dtype, with the
    TPU kernels' rounding points: dq contracts ds against dequant(k) rounded
    to the storage dtype, dk against dequant(q) rounded the same way, ds is
    formed from the unrounded p and rounded for both, dv takes p rounded to
    do's dtype."""
    acc = _acc_dtype(v.dtype)
    dtype = do.dtype
    scale = 1.0 / qq.shape[-1] ** 0.5
    s = _scores(qq, qs, kq, ks, is_causal, acc)
    p = torch.exp(s - lse.to(acc)[..., None])
    dof = do.to(acc)
    dp = torch.einsum("bqnd,bknd->bnqk", dof, v.to(acc))
    ds = (p * (dp - _delta(o, do, None)[..., None])).to(dtype).to(acc)
    kd = (kq.to(acc) * ks.transpose(1, 2).to(acc)[..., None]).to(dtype)
    qd = (qq.to(acc) * qs.transpose(1, 2).to(acc)[..., None]).to(dtype)
    dq = torch.einsum("bnqk,bknd->bqnd", ds, kd.to(acc)) * scale
    dk = torch.einsum("bnqk,bqnd->bknd", ds, qd.to(acc)) * scale
    dv = torch.einsum("bnqk,bqnd->bknd", p.to(dtype).to(acc), dof)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _check_quantized(qq: torch.Tensor, qs: torch.Tensor, kq: torch.Tensor,
                     ks: torch.Tensor, v: torch.Tensor) -> None:
    """The kernels' operands: contiguous int8 q/k and f32 scales on v's
    CUDA device, shaped as :func:`quantize_heads` makes them."""
    b, sq, n, d = qq.shape
    sk = kq.shape[1]
    if (qq.dtype != torch.int8 or kq.dtype != torch.int8
            or qs.dtype != torch.float32 or ks.dtype != torch.float32):
        raise ValueError("the int8 flash kernels take int8 q/k and f32 "
                         "scales")
    if (tuple(kq.shape) != (b, sk, n, d) or tuple(v.shape) != (b, sk, n, d)
            or tuple(qs.shape) != (b, n, sq) or tuple(ks.shape) != (b, n, sk)):
        raise ValueError(f"qq {tuple(qq.shape)}, kq {tuple(kq.shape)}, v "
                         f"{tuple(v.shape)}, qs {tuple(qs.shape)}, ks "
                         f"{tuple(ks.shape)} do not agree")
    if any(t.device != v.device or not t.is_contiguous()
           for t in (qq, qs, kq, ks)):
        raise ValueError("the int8 flash kernels need contiguous q/k and "
                         "scales on v's device")


def flash_attention_int8_fwd(qq: torch.Tensor, qs: torch.Tensor,
                             kq: torch.Tensor, ks: torch.Tensor,
                             v: torch.Tensor, *, is_causal: bool = False
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` from the quantized q and k (see :func:`quantize_heads`)
    and v: the forward kernel on CUDA tensors,
    :func:`flash_attention_int8_plain` on CPU tensors."""
    global launches
    if v.device.type == "cpu":
        return flash_attention_int8_plain(qq, qs, kq, ks, v,
                                          is_causal=is_causal)
    code = _kernel_dtype(v)
    _check_quantized(qq, qs, kq, ks, v)
    b, sq, n, d = qq.shape
    sk = kq.shape[1]
    o = torch.empty((b, sq, n, d), dtype=v.dtype, device=v.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=v.device)
    lib = _build.load()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.jimm_flash_attention_int8_fwd(
            qq.data_ptr(), kq.data_ptr(), qs.data_ptr(), ks.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, n, sq, sk, d,
            *_strides(v), 1.0 / d ** 0.5, int(is_causal), code, stream)
    _build.check(rc, "jimm_flash_attention_int8_fwd")
    launches += 1
    return o, lse


def flash_attention_int8_bwd(qq: torch.Tensor, qs: torch.Tensor,
                             kq: torch.Tensor, ks: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             is_causal: bool = False
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's residuals and the cotangent of o:
    the two backward kernels on CUDA tensors,
    :func:`flash_attention_int8_bwd_plain` on CPU tensors."""
    global bwd_launches
    if v.device.type == "cpu":
        return flash_attention_int8_bwd_plain(qq, qs, kq, ks, v, o, lse, do,
                                              is_causal=is_causal)
    if do.dtype != v.dtype or do.shape != o.shape:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} does not match o "
                         f"{o.dtype} {tuple(o.shape)}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    code = _kernel_dtype(v, do)
    _check_quantized(qq, qs, kq, ks, v)
    b, sq, n, d = qq.shape
    sk = kq.shape[1]
    delta = _delta(o, do, None)
    lse = lse.contiguous()
    dq = torch.empty((b, sq, n, d), dtype=v.dtype, device=v.device)
    dk = torch.empty((b, sk, n, d), dtype=v.dtype, device=v.device)
    dv = torch.empty((b, sk, n, d), dtype=v.dtype, device=v.device)
    lib = _build.load()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.jimm_flash_attention_int8_bwd(
            qq.data_ptr(), kq.data_ptr(), qs.data_ptr(), ks.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, sq, sk, d,
            *_strides(v), *_strides(do), 1.0 / d ** 0.5, int(is_causal),
            code, stream)
    _build.check(rc, "jimm_flash_attention_int8_bwd")
    bwd_launches += 1
    return dq, dk, dv


#: the forward as the op ``jimm::flash_int8_fwd``, which a remat policy can
#: save (`ops/library.py`)
fwd_op = define_op(
    "flash_int8_fwd(Tensor qq, Tensor qs, Tensor kq, Tensor ks, Tensor v, "
    "bool is_causal) -> (Tensor, Tensor)",
    lambda qq, qs, kq, ks, v, is_causal: flash_attention_int8_fwd(
        qq, qs, kq, ks, v, is_causal=is_causal))


class FlashAttentionInt8Fn(torch.autograd.Function):
    """o of int8-QK flash attention, differentiable in q, k and v (straight
    through the quantizer in q and k)."""

    @staticmethod
    def forward(ctx, q, k, v, is_causal):
        qq, qs = quantize_heads(q)
        kq, ks = quantize_heads(k)
        o, lse = fwd_op(qq, qs, kq, ks, v, is_causal)
        ctx.save_for_backward(qq, qs, kq, ks, v, o, lse)
        ctx.is_causal = is_causal
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        qq, qs, kq, ks, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_int8_bwd(qq, qs, kq, ks, v, o, lse, do,
                                              is_causal=ctx.is_causal)
        return dq, dk, dv, None


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, is_causal: bool = False) -> torch.Tensor:
    """int8-QK flash attention over ``(B, S, N, D)`` q/k/v, scale
    1/sqrt(D): q and k quantize per row to int8, the score is an int8 dot,
    softmax and P.V stay full precision. Differentiable (straight-through
    gradient of the quantized forward)."""
    _check(q, k, v)
    return FlashAttentionInt8Fn.apply(q, k, v, is_causal)
