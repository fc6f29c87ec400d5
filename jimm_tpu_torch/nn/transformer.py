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

Tensor parallelism: on a ``model`` axis (``parallel.sharding``) an
attention or MLP whose ``tp`` group is set holds this rank's slices of its
projections and runs Megatron-style: q/k/v and fc1 column-parallel on the
replicated input (``comm.tp_copy``), the attention on the local heads,
attention out and fc2 row-parallel (``comm.tp_row_linear``: the partial
products summed in f32, the bias added once, one rounding; an fp8 policy
module sums the fp8 GEMM's partial products the same way).

Pipeline parallelism (``cfg.pipeline``): the blocks run under
`parallel/pipeline.py`'s schedule over the ambient mesh's ``stage`` axis,
each stage on the blocks it holds (``keep_blocks``, kept under their
global names, so checkpoints and ``save_pretrained`` stay canonical).
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
from jimm_tpu_torch.parallel import comm
from jimm_tpu_torch.parallel.mesh import mesh_shape
from jimm_tpu_torch.parallel.sharding import current_mesh, shard_sequence


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


def row_parallel(linear: nn.Module, x: torch.Tensor,
                 grp: comm.AxisGroup) -> torch.Tensor:
    """``linear`` row-parallel over ``grp`` on this rank's slice ``x`` of
    its input features: an fp8 policy module's own (its partial products
    from the fp8 GEMM), else ``comm.tp_row_linear``."""
    own = getattr(linear, "row_parallel", None)
    if own is not None:
        return own(x, grp)
    return comm.tp_row_linear(x, linear.weight, linear.bias, grp)


class Attention(nn.Module):
    """Multi-head attention with (H, H) q/k/v/out projections; self- or
    cross-attention (the MAP pooling probe).

    ``fused_qkv`` computes the three projections as one ``(H, 3H)`` matmul
    over weights concatenated at call time; the parameters stay separate.
    The q/k/v it hands to attention are then strided views of one tensor,
    which the flash kernel reads in place."""

    #: the ``model`` group whose ranks hold slices of the projections
    tp: comm.AxisGroup | None = None

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
        if self.tp is not None:
            kv = None if kv is None else comm.tp_copy(kv, self.tp)
            x = comm.tp_copy(x, self.tp)
        if kv is None and self.fused_qkv:
            w = torch.cat([self.q.weight, self.k.weight, self.v.weight])
            bias = torch.cat([self.q.bias, self.k.bias, self.v.bias])
            q, k, v = F.linear(x, w, bias).chunk(3, dim=-1)
            sk = sq
        else:
            kv = x if kv is None else kv
            sk = kv.shape[1]
            q, k, v = self.q(x), self.k(kv), self.v(kv)
        # the local heads: all of them, or this model rank's
        q = q.reshape(b, sq, -1, self.head_dim)
        k = k.reshape(b, sk, -1, self.head_dim)
        v = v.reshape(b, sk, -1, self.head_dim)
        o = dot_product_attention(q, k, v, is_causal=self.is_causal,
                                  mask=mask, impl=self.impl)
        o = o.reshape(b, sq, -1)
        with checkpoint_name("branch_out"):
            if self.tp is None:
                return self.out(o)
            return row_parallel(self.out, o, self.tp)


class Mlp(nn.Module):
    #: the ``model`` group whose ranks hold slices of fc1 and fc2
    tp: comm.AxisGroup | None = None

    def __init__(self, width: int, mlp_dim: int, act: str, *, device=None,
                 dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(width, mlp_dim, device=device, dtype=dtype)
        self.fc2 = nn.Linear(mlp_dim, width, device=device, dtype=dtype)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = comm.tp_copy(x, self.tp)
        h = self.fc1(x)
        with checkpoint_name("act_out"):
            h = self.act(h)
        with checkpoint_name("branch_out"):
            if self.tp is None:
                return self.fc2(h)
            return row_parallel(self.fc2, h, self.tp)


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
    blocks as they are. With ``cfg.pipeline`` the blocks run pipelined over
    the ambient mesh's ``stage`` axis (see the module docstring)."""

    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.remat:
            context_fn(cfg)  # a bad policy raises here, not in the step
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            Block(cfg, device=device, dtype=dtype) for _ in range(cfg.depth))

    def keep_blocks(self, layers) -> None:
        """Drop every block but ``layers`` (global indices), which keep
        their names (``blocks.<i>``), in order: a stage's share of a
        pipelined encoder."""
        self.blocks = nn.ModuleDict({str(i): self.blocks[i]
                                     for i in sorted(layers)})

    def _block(self, i: int) -> Block:
        return self.blocks[str(i) if isinstance(self.blocks, nn.ModuleDict)
                           else i]

    def _run(self, blocks, x: torch.Tensor,
             mask: torch.Tensor | None) -> torch.Tensor:
        if not (self.cfg.remat and torch.is_grad_enabled()):
            for block in blocks:
                x = block(x, mask=mask)
            return x
        context = context_fn(self.cfg)
        for block in blocks:
            x = checkpoint_block(block, x, mask, context)
        return x

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        if not self.cfg.pipeline:
            return self._run(self.blocks, x, mask)
        if mask is not None:
            raise ValueError(
                "attention masks are not supported on the pipelined path "
                "yet (the stage loop has no mask plumbing); use "
                "pipeline=False — the non-pipelined path runs key-padding "
                "masks on the flash kernel (impl='flash_masked' / 'auto')")
        from jimm_tpu_torch.configs import validate_pipeline
        from jimm_tpu_torch.parallel.pipeline import (held_layers,
                                                      pipeline_forward)
        mesh = current_mesh()
        n_stage = mesh_shape(mesh).get("stage", 0) if mesh is not None else 0
        validate_pipeline(self.cfg, n_stages=n_stage)
        grp = comm.axis_group("stage", mesh)
        chunks = [[self._block(i) for i in layers] for layers in held_layers(
            self.cfg.depth, grp.size, self.cfg.pp_virtual, grp.index)]
        return pipeline_forward(
            lambda v, xm: self._run(chunks[v], xm, None), x,
            n_microbatches=self.cfg.pp_microbatches,
            n_virtual=self.cfg.pp_virtual, axis=grp,
            params=[p for c in chunks for b in c for p in b.parameters()])
