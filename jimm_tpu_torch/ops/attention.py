"""Attention dispatch over ``(B, S, N, D)`` q/k/v, as in
``jimm_tpu/ops/attention.py``:

- ``"flash"``: the hand-written flash-attention kernels
  (`jimm_tpu_torch/ops/flash_attention.py`, forward and backward through
  ``FlashAttentionFn``) on a CUDA tensor, their plain versions on a CPU
  tensor. With a key-padding mask (``(B, Sk)`` or ``(B, 1, 1, Sk)``) it is
  ``"flash_masked"``; any other mask shape raises ``ValueError``.
- ``"flash_masked"``: masked flash attention, the kernels' ``HAS_MASK``
  instantiations (NaFlex, MAP pooling); needs a key-padding mask.
- ``"auto"``: on a CUDA tensor ``"flash"``, or ``"xla"`` for a mask that is
  not a key-padding mask; ``"xla"`` on a CPU tensor. No sequence-length
  crossover is applied: the port has not measured one.
- ``"flash_int8"``: flash attention with int8-quantized q and k
  (`jimm_tpu_torch/ops/flash_attention_int8.py`, forward and backward
  through ``FlashAttentionInt8Fn``; the ``int8_qk`` training policy sets
  it); no mask and no bias.
- ``"sigmoid"``: sigmoid attention (``sigmoid(s + logit_bias)``, no
  normaliser; `jimm_tpu_torch/ops/flash_attention.py`, forward and backward
  through ``SigmoidAttentionFn``), with or without a key-padding mask; no
  bias. Reached by a config with ``attn_impl="sigmoid"``.
- ``"xla"`` / ``"einsum"``: :func:`reference_attention`, plain f32-softmax
  math (the names the JAX configs use for the non-kernel path),
  differentiated by autograd.

The other JAX impls, and a bias under ``"flash"``, are kernels or schemes
not ported yet; each raises ``NotImplementedError`` naming its place in
``ROADMAP.md``.
"""

from __future__ import annotations

import torch

from jimm_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_masked,
                                                sigmoid_attention)
from jimm_tpu_torch.ops.flash_attention_int8 import flash_attention_int8

#: JAX attention impls the port does not have yet -> where the ROADMAP
#: queues them
_NOT_PORTED = {
    "flash_bias": "kernel rows 5 and 8 (biased flash), ROADMAP queue 2",
    "ring": "sequence parallelism, ROADMAP queue 1 (parallelism)",
    "ulysses": "sequence parallelism, ROADMAP queue 1 (parallelism)",
    "saveable": "remat policies, ROADMAP queue 1 item 3 (training, rest)",
}


#: why flash_int8 refuses a mask or a bias (the JAX dispatch's reason)
INT8_NO_MASK = ("flash_int8 does not support masks or biases — the int8 "
                "score kernel has no mask/bias plumbing")


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, is_causal: bool = False,
                        mask: torch.Tensor | None = None,
                        bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain einsum attention with an f32 softmax. ``mask`` is bool,
    broadcastable to ``(B, N, Sq, Sk)``, True = attend; ``bias`` is an
    additive logits bias."""
    depth = q.shape[-1]
    logits = torch.einsum("bqnd,bknd->bnqk", q.float() / depth ** 0.5,
                          k.float())
    sq, sk = logits.shape[-2], logits.shape[-1]
    if bias is not None:
        logits = logits + bias.float()
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        logits = logits.masked_fill(~mask.bool(), float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", weights, v.float())
    return out.to(q.dtype)


def _is_key_padding_mask(mask: torch.Tensor) -> bool:
    """True for the masks the flash kernels take: per-sample key masks
    ``(B, Sk)`` or ``(B, 1, 1, Sk)`` (what the NaFlex tower builds)."""
    if mask.ndim == 2:
        return True
    return mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, is_causal: bool = False,
                          mask: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None,
                          impl: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention over (batch, seq, heads, head_dim)."""
    if impl == "auto":
        impl = ("flash" if q.device.type == "cuda" and (
            mask is None or _is_key_padding_mask(mask)) else "xla")
    if impl == "flash":
        if bias is not None:
            raise NotImplementedError(
                "flash attention with a bias is not ported yet: "
                + _NOT_PORTED["flash_bias"])
        if mask is None:
            return flash_attention(q, k, v, is_causal=is_causal)
        if not _is_key_padding_mask(mask):
            raise ValueError(
                "flash attention supports key-padding masks only ((B, Sk) or "
                f"(B, 1, 1, Sk)); arbitrary {tuple(mask.shape)} masks need "
                "impl='xla'")
        impl = "flash_masked"
    if impl == "flash_masked":
        if bias is not None:
            raise ValueError("flash_masked does not take a bias; use "
                             "impl='xla'")
        if mask is None:
            raise ValueError("impl='flash_masked' requires a key-padding "
                             "mask ((B, Sk) or (B, 1, 1, Sk))")
        return flash_attention_masked(q, k, v, mask, is_causal=is_causal)
    if impl == "flash_int8":
        if mask is not None or bias is not None:
            raise ValueError(f"{INT8_NO_MASK}; use is_causal, or "
                             f"impl='flash_masked' / 'xla' for masked "
                             f"batches")
        return flash_attention_int8(q, k, v, is_causal=is_causal)
    if impl == "sigmoid":
        if bias is not None:
            raise ValueError("sigmoid attention takes no additive bias "
                             "(its scalar logit_bias is set by the op)")
        if mask is not None and not _is_key_padding_mask(mask):
            raise ValueError(
                "sigmoid attention supports key-padding masks only "
                f"((B, Sk) or (B, 1, 1, Sk)); got {tuple(mask.shape)}")
        return sigmoid_attention(q, k, v, is_causal=is_causal, mask=mask)
    if impl in ("xla", "einsum"):
        return reference_attention(q, k, v, is_causal=is_causal, mask=mask,
                                   bias=bias)
    if impl in _NOT_PORTED:
        raise NotImplementedError(f"attention impl {impl!r} is not ported "
                                  f"yet: {_NOT_PORTED[impl]}")
    raise ValueError(f"unknown attention impl {impl!r}")
