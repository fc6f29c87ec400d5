"""Attention dispatch over ``(B, S, N, D)`` q/k/v, as in
``jimm_tpu/ops/attention.py``:

- ``"flash"``: the hand-written flash-attention kernels
  (`jimm_tpu_torch/ops/flash_attention.py`, forward and backward through
  ``FlashAttentionFn``) on a CUDA tensor, their plain versions on a CPU
  tensor. With a key-padding mask (``(B, Sk)`` or ``(B, 1, 1, Sk)``) it is
  ``"flash_masked"`` (any other mask shape raises ``ValueError``), else with
  a bias ``"flash_bias"``.
- ``"flash_masked"``: masked flash attention, the kernels' ``HAS_MASK``
  instantiations (NaFlex, MAP pooling); needs a key-padding mask.
- ``"flash_bias"``: flash attention with an additive bias broadcastable to
  ``(N, Sq, Sk)`` (relative-position style), the kernels' ``HAS_BIAS``
  instantiations and the dbias kernel (``FlashAttentionBiasFn``),
  differentiable in the bias; no mask.
- ``"auto"``: :func:`resolve_impl` with "on the card" for JAX's "on the
  TPU": on a CUDA tensor a bias of ndim <= 3 without a mask is
  ``"flash_bias"``, any other bias ``"xla"``; without a bias ``"flash"``, or
  ``"flash_masked"`` for a key-padding mask, or ``"xla"`` for any other
  mask. ``"xla"`` on a CPU tensor. JAX's seq-512 flash crossover
  (``_flash_eligible``) is a TPU measurement and is not copied. First of
  all, as in JAX, ``"auto"`` without a bias (and with no mask or a
  key-padding one) takes the sequence-parallel schemes
  (``parallel.seqpar.seq_parallel_attention``) when the activations'
  sequence is sharded over a mesh axis (a tower's encoder under a rule that
  maps ``seq``; ``parallel.sharding.sharded_sequence_axis``) and q and k
  are chunks of one sequence.
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
- ``"saveable"``: :func:`saveable_attention`, einsum attention whose
  probabilities a ``"dots+attn"`` remat policy keeps.
- ``"ring"`` / ``"ulysses"``: sequence parallelism over the ambient rules'
  ``seq`` axis (default ``"seq"``) on this rank's chunks: causal softmax
  without a mask takes the zigzag-capable ring
  (``parallel.ring_attention``), the rest the seqpar plans; no bias, and
  only key-padding masks, as in JAX.
"""

from __future__ import annotations

import torch

from jimm_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_bias,
                                                flash_attention_masked,
                                                sigmoid_attention)
from jimm_tpu_torch.ops.flash_attention_int8 import flash_attention_int8
from jimm_tpu_torch.ops.library import checkpoint_name
from jimm_tpu_torch.parallel.sharding import (current_rules,
                                              sharded_sequence_axis)

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


def saveable_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, is_causal: bool = False,
                       mask: torch.Tensor | None = None,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """``jimm_tpu/ops/attention.py::saveable_attention``: f32 scores (the
    products of the input-dtype q and k summed in f32) and an f32 softmax,
    the probabilities cast to the input dtype inside
    ``checkpoint_name("attn_probs")``, so that a ``"dots+attn"`` remat policy
    keeps them (and the softmax under them) instead of recomputing them;
    ``p @ v`` is a batched product, not kept."""
    dtype = q.dtype
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    logits = logits * (1.0 / q.shape[-1] ** 0.5)
    sq, sk = logits.shape[-2], logits.shape[-1]
    if bias is not None:
        logits = logits + bias.float()
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        logits = logits.masked_fill(~mask.bool(), float("-inf"))
    with checkpoint_name("attn_probs"):
        probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def _is_key_padding_mask(mask: torch.Tensor) -> bool:
    """True for the masks the flash kernels take: per-sample key masks
    ``(B, Sk)`` or ``(B, 1, 1, Sk)`` (what the NaFlex tower builds)."""
    if mask.ndim == 2:
        return True
    return mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1


def resolve_impl(impl: str, *, on_card: bool,
                 mask: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None) -> str:
    """The impl that ``"auto"`` and ``"flash"`` stand for, as
    ``jimm_tpu/ops/attention.py::dot_product_attention`` routes them with
    "on the card" for "on the TPU" (and without its seq-512 crossover); any
    other impl is itself. ``"flash"`` with a mask that is not a key-padding
    mask raises JAX's ``ValueError``."""
    if impl == "auto":
        if not on_card:
            return "xla"
        if bias is not None:
            return "flash_bias" if mask is None and bias.ndim <= 3 else "xla"
        if mask is None:
            return "flash"
        return "flash_masked" if _is_key_padding_mask(mask) else "xla"
    if impl == "flash" and mask is not None:
        if not _is_key_padding_mask(mask):
            raise ValueError(
                "flash attention supports key-padding masks only ((B, Sk) or "
                f"(B, 1, 1, Sk)); arbitrary {tuple(mask.shape)} masks need "
                "impl='xla'")
        return "flash_masked"
    if impl == "flash" and bias is not None:
        return "flash_bias"
    return impl


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, is_causal: bool = False,
                          mask: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None,
                          impl: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention over (batch, seq, heads, head_dim)."""
    if impl == "auto" and bias is None and (
            mask is None or _is_key_padding_mask(mask)):
        axis = sharded_sequence_axis()
        if axis is not None and q.shape[1] == k.shape[1]:
            from jimm_tpu_torch.parallel.seqpar import seq_parallel_attention
            return seq_parallel_attention(q, k, v, mask=mask,
                                          is_causal=is_causal,
                                          axis_name=axis, plan="auto")
    if impl in ("ring", "ulysses"):
        return _sequence_parallel(q, k, v, impl, is_causal, mask, bias)
    impl = resolve_impl(impl, on_card=q.device.type == "cuda", mask=mask,
                        bias=bias)
    if impl == "flash":
        return flash_attention(q, k, v, is_causal=is_causal)
    if impl == "flash_masked":
        if bias is not None:
            raise ValueError("flash_masked does not take a bias; use "
                             "impl='flash_bias' (bias only) or impl='xla'")
        if mask is None:
            raise ValueError("impl='flash_masked' requires a key-padding "
                             "mask ((B, Sk) or (B, 1, 1, Sk))")
        return flash_attention_masked(q, k, v, mask, is_causal=is_causal)
    if impl == "flash_bias":
        if bias is None:
            raise ValueError("impl='flash_bias' requires a bias "
                             "broadcastable to (N, Sq, Sk)")
        if mask is not None:
            raise ValueError("flash_bias does not take a mask; use "
                             "impl='flash_masked' (mask only) or "
                             "impl='xla'")
        return flash_attention_bias(q, k, v, bias, is_causal=is_causal)
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
    if impl == "saveable":
        return saveable_attention(q, k, v, is_causal=is_causal, mask=mask,
                                  bias=bias)
    raise ValueError(f"unknown attention impl {impl!r}")


def _sequence_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       impl: str, is_causal: bool,
                       mask: torch.Tensor | None,
                       bias: torch.Tensor | None) -> torch.Tensor:
    """``impl="ring"`` / ``"ulysses"`` on this rank's sequence chunks, as
    JAX's dispatch routes them."""
    if bias is not None:
        raise ValueError(
            f"{impl} attention does not take an additive bias — the "
            "cross-chip exchange only rotates per-sample key-padding rows; "
            "use impl='flash_bias' single-chip or impl='xla'")
    if mask is not None and not _is_key_padding_mask(mask):
        raise ValueError(
            f"{impl} attention supports key-padding masks only ((B, Sk) or "
            f"(B, 1, 1, Sk)); got {tuple(mask.shape)} — arbitrary masks "
            "need impl='xla'")
    rules = current_rules()
    axis = rules.seq if rules is not None and rules.seq else "seq"
    if impl == "ring" and is_causal and mask is None:
        # causal softmax keeps the ring with exact causal skipping; the
        # seqpar ring is the masked / sigmoid generalist
        from jimm_tpu_torch.parallel.ring_attention import ring_attention
        return ring_attention(q, k, v, axis_name=axis, is_causal=True,
                              impl="auto")
    from jimm_tpu_torch.parallel.seqpar import seq_parallel_attention
    return seq_parallel_attention(q, k, v, mask=mask, axis_name=axis,
                                  is_causal=is_causal, plan=impl)
