"""Transformer encoder stack; the counterpart of
``jimm_tpu/nn/transformer.py``.

The JAX package stacks the layers (one parameter set with a leading
``layers`` axis, scanned); here each layer is its own module in an
``nn.ModuleList`` and the forward is a Python loop. ``load_jax_params``
(`jimm_tpu_torch/models/siglip.py`) unstacks at the weight edge.

Parity-preserved semantics: pre-LN residual order
``x + drop(attn(ln1(x)))``; ``x + drop(mlp(ln2(x)))``; attention over
explicit ``(B, S, N, D)`` tensors with plain ``(H, H)`` q/k/v/out
projections. The LayerNorm outputs and the MLP activation run inside
``checkpoint_name`` blocks (``ln_out``, ``act_out``) that the remat
policies of `jimm_tpu_torch/nn/remat.py` can keep; the projections that
close the residual branches run inside ``branch_out``, which none keeps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jimm_tpu_torch.configs import TransformerConfig
from jimm_tpu_torch.nn.norm import FusedLayerNorm
from jimm_tpu_torch.nn.remat import Dropout, checkpoint_block, context_fn
from jimm_tpu_torch.ops.activations import get_activation
from jimm_tpu_torch.ops.attention import dot_product_attention
from jimm_tpu_torch.ops.library import checkpoint_name
from jimm_tpu_torch.parallel.sharding import shard_sequence


def sequence_parallel(cfg, length: int) -> str | None:
    """The mesh axis a tower configured by ``cfg`` shards its ``length``
    tokens over under the ambient rules (``parallel.sharding``), or None:
    the tower then runs whole on every rank. A tower whose attention is
    ``"ring"`` / ``"ulysses"`` needs its sequence sharded."""
    axis = shard_sequence(length)
    if axis is None and cfg.attn_impl in ("ring", "ulysses"):
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} needs the sequence sharded over a "
            f"mesh axis: use_sharding(mesh, rules) with a rule mapping seq, "
            f"and a length ({length}) that divides over it")
    return axis


def _layernorm(dim: int, eps: float, *, impl: str = "xla", device=None,
               dtype=None) -> nn.Module:
    if impl == "fused":
        return FusedLayerNorm(dim, eps=eps, device=device, dtype=dtype)
    if impl != "xla":
        raise ValueError(f"unknown ln_impl {impl!r}")
    return nn.LayerNorm(dim, eps=eps, device=device, dtype=dtype)


class Attention(nn.Module):
    """Multi-head attention with (H, H) q/k/v/out projections; self- or
    cross-attention (the MAP pooling probe).

    ``fused_qkv`` computes the three projections as one ``(H, 3H)`` matmul
    over weights concatenated at call time; the parameters stay separate.
    The q/k/v it hands to attention are then strided views of one tensor,
    which the flash kernel reads in place."""

    def __init__(self, width: int, num_heads: int, *, is_causal: bool = False,
                 impl: str = "auto", fused_qkv: bool = False, device=None,
                 dtype=None):
        super().__init__()
        if width % num_heads:
            raise ValueError(f"width {width} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = width // num_heads
        self.is_causal = is_causal
        self.impl = impl
        self.fused_qkv = fused_qkv
        kw = {"device": device, "dtype": dtype}
        self.q = nn.Linear(width, width, **kw)
        self.k = nn.Linear(width, width, **kw)
        self.v = nn.Linear(width, width, **kw)
        self.out = nn.Linear(width, width, **kw)

    def forward(self, x: torch.Tensor, kv: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        b, sq, _ = x.shape
        if kv is None and self.fused_qkv:
            w = torch.cat([self.q.weight, self.k.weight, self.v.weight])
            bias = torch.cat([self.q.bias, self.k.bias, self.v.bias])
            q, k, v = F.linear(x, w, bias).chunk(3, dim=-1)
            sk = sq
        else:
            kv = x if kv is None else kv
            sk = kv.shape[1]
            q, k, v = self.q(x), self.k(kv), self.v(kv)
        q = q.reshape(b, sq, self.num_heads, self.head_dim)
        k = k.reshape(b, sk, self.num_heads, self.head_dim)
        v = v.reshape(b, sk, self.num_heads, self.head_dim)
        o = dot_product_attention(q, k, v, is_causal=self.is_causal,
                                  mask=mask, impl=self.impl)
        with checkpoint_name("branch_out"):
            return self.out(o.reshape(b, sq, self.num_heads * self.head_dim))


class Mlp(nn.Module):
    def __init__(self, width: int, mlp_dim: int, act: str, *, device=None,
                 dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(width, mlp_dim, device=device, dtype=dtype)
        self.fc2 = nn.Linear(mlp_dim, width, device=device, dtype=dtype)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        with checkpoint_name("act_out"):
            h = self.act(h)
        with checkpoint_name("branch_out"):
            return self.fc2(h)


class Block(nn.Module):
    """Pre-LN residual block, with dropout on both residual branches (one
    module, drawn twice, as JAX's ``Block.dropout``)."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln1 = _layernorm(cfg.width, cfg.ln_eps, impl=cfg.ln_impl, **kw)
        self.attn = Attention(cfg.width, cfg.num_heads, is_causal=cfg.causal,
                              impl=cfg.attn_impl, fused_qkv=cfg.fused_qkv,
                              **kw)
        self.ln2 = _layernorm(cfg.width, cfg.ln_eps, impl=cfg.ln_impl, **kw)
        self.mlp = Mlp(cfg.width, cfg.mlp_dim, cfg.act, **kw)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        with checkpoint_name("ln_out"):
            h = self.ln1(x)
        x = x + self.dropout(self.attn(h, mask=mask))
        with checkpoint_name("ln_out"):
            h = self.ln2(x)
        return x + self.dropout(self.mlp(h))


class Transformer(nn.Module):
    """``depth`` blocks applied in order, differentiable end to end (the
    kernels' autograd Functions carry the gradient through attention and
    the fused LayerNorm). With ``cfg.remat`` each block is recomputed in
    the backward, keeping what ``cfg.remat_policy`` saves
    (`jimm_tpu_torch/nn/remat.py`); a forward without autograd runs the
    blocks as they are. Pipeline parallelism is not ported yet and is
    rejected."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.pipeline:
            raise NotImplementedError(
                "pipeline parallelism is not ported yet (ROADMAP.md queue 1, "
                "item 6 part 2: the stage axis)")
        if cfg.remat:
            context_fn(cfg)  # a bad policy raises here, not in the step
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            Block(cfg, device=device, dtype=dtype) for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        if not (self.cfg.remat and torch.is_grad_enabled()):
            for block in self.blocks:
                x = block(x, mask=mask)
            return x
        context = context_fn(self.cfg)
        for block in self.blocks:
            x = checkpoint_block(block, x, mask, context)
        return x
