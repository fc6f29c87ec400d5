"""Attention dispatch over ``(B, S, N, D)`` q/k/v, as in
``jimm_tpu/ops/attention.py``:

- ``"flash"``: the hand-written flash-attention kernels
  (`jimm_tpu_torch/ops/flash_attention.py`, forward and backward through
  ``FlashAttentionFn``) on a CUDA tensor, their plain versions on a CPU
  tensor.
- ``"auto"``: ``"flash"`` on a CUDA tensor, ``"xla"`` on a CPU tensor. No
  sequence-length crossover is applied: the port has not measured one.
- ``"xla"`` / ``"einsum"``: :func:`reference_attention`, plain f32-softmax
  math (the names the JAX configs use for the non-kernel path),
  differentiated by autograd.

The other JAX impls are kernels or schemes not ported yet; each raises
``NotImplementedError`` naming its place in ``ROADMAP.md``.
"""

from __future__ import annotations

import torch

from jimm_tpu_torch.ops.flash_attention import flash_attention

#: JAX attention impls the port does not have yet -> where the ROADMAP
#: queues them
_NOT_PORTED = {
    "flash_masked": "kernel row 4 (masked flash), ROADMAP queue 2",
    "flash_bias": "kernel rows 5 and 8 (biased flash), ROADMAP queue 2",
    "sigmoid": "kernel row 6 (sigmoid flash), ROADMAP queue 2",
    "flash_int8": "kernel rows 9-10 (int8 flash), ROADMAP queue 2",
    "ring": "sequence parallelism, ROADMAP queue 1 (parallelism)",
    "ulysses": "sequence parallelism, ROADMAP queue 1 (parallelism)",
    "saveable": "remat policies, ROADMAP queue 1 item 3 (training, rest)",
}


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


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, is_causal: bool = False,
                          mask: torch.Tensor | None = None,
                          bias: torch.Tensor | None = None,
                          impl: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention over (batch, seq, heads, head_dim)."""
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "xla"
    if impl == "flash":
        if mask is not None or bias is not None:
            raise NotImplementedError(
                "flash attention with a mask or bias is not ported yet: "
                + _NOT_PORTED["flash_masked" if mask is not None
                              else "flash_bias"])
        return flash_attention(q, k, v, is_causal=is_causal)
    if impl in ("xla", "einsum"):
        return reference_attention(q, k, v, is_causal=is_causal, mask=mask,
                                   bias=bias)
    if impl in _NOT_PORTED:
        raise NotImplementedError(f"attention impl {impl!r} is not ported "
                                  f"yet: {_NOT_PORTED[impl]}")
    raise ValueError(f"unknown attention impl {impl!r}")
