"""Vision tower: patch embedding, learned positions, encoder, post-LN, then
CLS (ViT, CLIP) or MAP (SigLIP) pooling; the counterpart of
``jimm_tpu/nn/vision.py``, at fixed resolution (:meth:`VisionTower.forward`)
and, for SigLIP-style towers, on NaFlex variable-resolution batches
(:meth:`VisionTower.forward_naflex`). Pre-norm towers (CLIP) LayerNorm the
embeddings (``ln_pre``); the others apply dropout there. A temporal tower
(``num_frames > 1``) takes ``(B, T, H, W, C)`` clips: each frame is
patchified on its own and the tokens flatten into one ``(B, T*N, width)``
sequence under the ``T*N`` position table.

Under sharding rules that map ``seq`` (``parallel.sharding``), a tower
whose token count divides over the ``seq`` axis runs its encoder on this
rank's chunk of the tokens (and of the position table), attention crossing
the chunks through the sequence-parallel schemes, and gathers the tokens
for the post-LN and the pooling."""

from __future__ import annotations

import torch
from torch import nn

from jimm_tpu_torch.configs import VisionConfig
from jimm_tpu_torch.nn.naflex import naflex_position_embedding
from jimm_tpu_torch.nn.remat import Dropout
from jimm_tpu_torch.nn.transformer import (Attention, Mlp, Transformer,
                                           _layernorm, sequence_parallel)
from jimm_tpu_torch.parallel.sharding import (gather_sequence,
                                              logical_constraint,
                                              sequence_sharded)


class PatchEmbed(nn.Module):
    """Non-overlapping conv patchifier: (B, H, W, C) -> (B, N, width), tokens
    in row-major (grid row, grid column) order like the JAX NHWC conv."""

    def __init__(self, cfg: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(cfg.channels, cfg.width,
                              kernel_size=cfg.patch_size,
                              stride=cfg.patch_size, bias=cfg.patch_bias,
                              device=device, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.conv(images.permute(0, 3, 1, 2).to(self.conv.weight.dtype))
        return x.flatten(2).transpose(1, 2)


class MAPHead(nn.Module):
    """SigLIP multi-head attention pooling. The residual is the *pre-LN*
    attention output::

        x = attn(probe, h, h); res = x; x = res + mlp(ln(x)); return x[:, 0]
    """

    def __init__(self, cfg: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.probe = nn.Parameter(torch.zeros(1, 1, cfg.width, **kw))
        # ring/ulysses shard the query sequence, which a 1-row probe cannot:
        # a sequence-parallel tower pools on the gathered tokens
        pool_impl = ("auto" if cfg.attn_impl in ("ring", "ulysses")
                     else cfg.attn_impl)
        self.attn = Attention(cfg.width, cfg.num_heads, impl=pool_impl, **kw)
        self.ln = _layernorm(cfg.width, cfg.ln_eps, **kw)
        self.mlp = Mlp(cfg.width, cfg.mlp_dim, cfg.act, **kw)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """``mask``: an optional ``(B, 1, 1, S)`` key-padding mask over the
        tokens (NaFlex)."""
        probe = self.probe.expand(x.shape[0], 1, x.shape[-1]).to(x.dtype)
        x = self.attn(probe, kv=x, mask=mask)         # (B, 1, width)
        x = x + self.mlp(self.ln(x))
        return x[:, 0]


class VisionTower(nn.Module):
    """(B, H, W, C) images -> pooled (B, width) features, or the (B, N,
    width) tokens with ``pooling="none"``.

    The LayerNorms around the encoder of a CLS tower (ViT's ``ln_post``,
    CLIP's ``ln_pre`` and ``ln_post``) follow ``ln_impl`` as the blocks'
    do; a MAP tower's ``ln_post`` and head LayerNorm stay ``nn.LayerNorm``
    (the SigLIP paths' launch counts rest on that)."""

    #: set by ``SigLIP.from_pretrained`` when the checkpoint's position
    #: table was resampled at load; :meth:`forward_naflex` then refuses
    _pos_table_resampled = False

    def __init__(self, cfg: VisionConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        outer_ln = {"impl": cfg.ln_impl if cfg.pooling == "cls" else "xla",
                    **kw}
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, **kw)
        if cfg.pooling == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width, **kw))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.seq_len, cfg.width, **kw))
        if cfg.pre_norm:
            self.ln_pre = _layernorm(cfg.width, cfg.ln_eps, **outer_ln)
        else:
            self.dropout = Dropout(cfg.dropout)
        self.encoder = Transformer(cfg.encoder(), **kw)
        self.ln_post = _layernorm(cfg.width, cfg.ln_eps, **outer_ln)
        if cfg.pooling == "map":
            self.head = MAPHead(cfg, **kw)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images, or (B, T, H, W, C) clips for a temporal
        tower -> pooled (B, width) (or the tokens with ``pooling="none"``)."""
        size, frames = self.cfg.image_size, self.cfg.num_frames
        if frames > 1:
            if images.ndim != 5 or images.shape[1] != frames:
                raise ValueError(
                    f"temporal tower expects (B, {frames}, {size}, {size}, "
                    f"C) clips, got {tuple(images.shape)}")
            b = images.shape[0]
            images = images.reshape((b * frames, *images.shape[2:]))
        if images.ndim != 4 or images.shape[1:3] != (size, size):
            raise ValueError(f"expected {size}x{size} input images (NHWC), "
                             f"got {tuple(images.shape)}")
        x = self.patch_embed(images)
        if frames > 1:
            x = x.reshape(b, frames * x.shape[1], x.shape[-1])
        if self.cfg.pooling == "cls":
            # the class token joins before the position add
            cls = self.cls_token.expand(x.shape[0], 1, x.shape[-1])
            x = torch.cat([cls.to(x.dtype), x], dim=1)
        # under a rule that shards the sequence, this rank's chunk of the
        # tokens and of the position table (pos="seq")
        seq = sequence_parallel(self.cfg, x.shape[1])
        x = (logical_constraint(x, "batch", "seq", None)
             + logical_constraint(self.pos_embed, None, "seq", None).to(
                 x.dtype))
        # pre-norm towers (CLIP) LayerNorm the embeddings, the others drop
        x = self.ln_pre(x) if self.cfg.pre_norm else self.dropout(x)
        with sequence_sharded(seq):
            x = self.encoder(x)
        # the pooling reads the whole sequence
        x = self.ln_post(gather_sequence(x, seq))
        if self.cfg.pooling == "cls":
            return x[:, 0]
        if self.cfg.pooling == "map":
            return self.head(x)
        return x

    def forward_naflex(self, patches: torch.Tensor,
                       spatial_shapes: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        """NaFlex path: variable-resolution batches as pre-patchified tokens.

        Args:
            patches: ``(B, S, p*p*C)``, each row a (patch_row, patch_col,
                channel)-flattened patch, zero-padded past the sample's
                ``h * w`` tokens (``jimm_tpu_torch.data.naflex``).
            spatial_shapes: ``(B, 2)`` int, per-sample (h, w) patch grid.
            mask: ``(B, S)`` bool/int, True at real tokens.

        Returns pooled ``(B, width)`` features: the encoder and the MAP head
        attend over the real tokens only.

        Refused for a model whose position table was resampled when its HF
        checkpoint was loaded (``_pos_table_resampled``): resampling it
        again per sample would diverge from the checkpoint."""
        cfg = self.cfg
        if cfg.pooling != "map" or cfg.pre_norm:
            raise ValueError("forward_naflex targets SigLIP2-style towers "
                             "(MAP pooling, post-norm)")
        if self._pos_table_resampled:
            raise ValueError(
                "this model's position table was interpolated at load "
                "(image_size override, or a checkpoint whose NaFlex grid "
                "differs from the fixed-resolution grid); resampling it "
                "again per sample would diverge from the checkpoint -- load "
                "at the native image_size for NaFlex inference")
        # the conv patchifier is the NaFlex Linear: the JAX kernel is HWIO
        # (p, p, C, D), flattened row-major over (row, col, chan), which is
        # this OIHW weight permuted to (H, W, I, O)
        conv = self.patch_embed.conv
        d, c, p, _ = conv.weight.shape
        w_flat = conv.weight.permute(2, 3, 1, 0).reshape(p * p * c, d)
        # the model's dtype, as the fixed path's conv computes in it
        x = patches.to(w_flat.dtype) @ w_flat
        if conv.bias is not None:
            x = x + conv.bias
        g = int(round(cfg.seq_len ** 0.5))
        table = self.pos_embed.reshape(g, g, -1)
        x = x + naflex_position_embedding(table, spatial_shapes,
                                          x.shape[1]).to(x.dtype)
        x = self.dropout(x)
        key_mask = (mask != 0)[:, None, None, :]      # (B, 1, 1, S) over keys
        seq = sequence_parallel(cfg, x.shape[1])
        with sequence_sharded(seq):
            x = self.encoder(logical_constraint(x, "batch", "seq", None),
                             mask=logical_constraint(key_mask, "batch", None,
                                                     None, "seq"))
        return self.head(self.ln_post(gather_sequence(x, seq)), mask=key_mask)
