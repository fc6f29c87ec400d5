"""SigLIP dual-tower model; the counterpart of ``jimm_tpu/models/siglip.py``,
at fixed resolution and on SigLIP2's NaFlex variable-resolution batches.
HF checkpoints of both flavors load (:meth:`SigLIP.from_pretrained`) and
export (:meth:`SigLIP.save_pretrained`): a ``Siglip2Model`` checkpoint
differs only in its vision embeddings, a NaFlex Linear patch embedding and
a ``num_patches``-sized position table, resampled to the fixed grid at load
when the two differ. :func:`load_jax_params` carries a live JAX model's
parameters across (SigLIP2 has the same parameters, with a larger
vocabulary)."""

from __future__ import annotations

import warnings
from typing import Any

import torch
from torch import nn

from jimm_tpu_torch.configs import (SigLIPConfig, TextConfig, VisionConfig,
                                    act_to_hf, normalize_act, with_runtime)
from jimm_tpu_torch.models.common import (_port_entries, build_loaded,
                                          hf_encoder_layers, init_params,
                                          load_jax_params, resolve_device)
from jimm_tpu_torch.nn.text import TextTower
from jimm_tpu_torch.nn.vision import VisionTower
from jimm_tpu_torch.parallel.sharding import gathered_linear
from jimm_tpu_torch.weights.export import save_pretrained
from jimm_tpu_torch.weights.loader import M, T, per_layer
from jimm_tpu_torch.weights.resolve import resolve_checkpoint
from jimm_tpu_torch.weights.surgery import (apply_image_size,
                                            resize_checkpoint_pos_embed)

__all__ = ["SigLIP", "load_jax_params", "_port_entries"]

#: the HF names of the vision position table and patch embedding
POS_KEY = "vision_model.embeddings.position_embedding.weight"
PATCH_KEY = "vision_model.embeddings.patch_embedding.weight"


class SigLIP(nn.Module):
    """SigLIP on ``device`` (default: the card) in ``dtype`` (parameters and
    compute), randomly initialised from ``generator`` (default: seed 0 on
    the model's device)."""

    def __init__(self, config: SigLIPConfig | None = None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = config or SigLIPConfig()
        dev = resolve_device(device)
        self.config = cfg
        kw = {"device": dev, "dtype": dtype}
        self.vision = VisionTower(cfg.vision, **kw)
        self.text = TextTower(cfg.text, **kw)
        self.text_projection = nn.Linear(cfg.text.width, cfg.projection_dim,
                                         **kw)
        self.logit_scale = nn.Parameter(torch.zeros((), **kw))
        self.logit_bias = nn.Parameter(torch.zeros((), **kw))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init_params(self, generator)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> unnormalized (B, width): the MAP-head output."""
        return self.vision(images)

    def encode_image_naflex(self, patches: torch.Tensor,
                            spatial_shapes: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
        """NaFlex variable-resolution image encoding: ``(B, S, p*p*C)``
        patches, per-sample ``(B, 2)`` (h, w) grids and a ``(B, S)`` padding
        mask (``jimm_tpu_torch.data.naflex.patchify_naflex`` makes them from
        raw images) -> unnormalized ``(B, width)``."""
        return self.vision.forward_naflex(patches, spatial_shapes, mask)

    def logits_naflex(self, patches: torch.Tensor,
                      spatial_shapes: torch.Tensor, mask: torch.Tensor,
                      text: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` over NaFlex image inputs."""
        return self._logits(
            self.encode_image_naflex(patches, spatial_shapes, mask),
            self.encode_text(text))

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """(B, S) -> unnormalized (B, projection_dim): pooled, then the
        biased projection."""
        hidden = self.text(text)
        return gathered_linear(self.text_projection,
                               self.text.pool(hidden, text))

    def _logits(self, img: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
        """L2-normalize, scale by exp(logit_scale), add logit_bias:
        logits_per_image (B_img, B_txt)."""
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return self.logit_scale.exp() * img @ txt.T + self.logit_bias

    def forward(self, images: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        return self._logits(self.encode_image(images), self.encode_text(text))

    # -- HF checkpoints ----------------------------------------------------

    @staticmethod
    def config_from_hf(config: dict[str, Any] | None,
                       weights: dict[str, torch.Tensor]) -> SigLIPConfig:
        """Shapes from the tensors; the HF config fills the rest when
        present (SigLIP2 vision configs carry ``num_patches`` instead of
        ``image_size``: the square grid of the position table stands in)."""
        w = weights
        v_width = w["vision_model.post_layernorm.weight"].shape[0]
        t_width = w["text_model.final_layer_norm.weight"].shape[0]
        v_depth = 1 + max(int(k.split(".")[3]) for k in w
                          if k.startswith("vision_model.encoder.layers."))
        t_depth = 1 + max(int(k.split(".")[3]) for k in w
                          if k.startswith("text_model.encoder.layers."))
        vc = (config or {}).get("vision_config", {})
        tc = (config or {}).get("text_config", {})
        pe = w[PATCH_KEY]
        if pe.ndim == 4:  # SigLIP v1: Conv2d OIHW
            patch = pe.shape[-1]
        else:  # SigLIP2: NaFlex Linear (out, p*p*3)
            patch = vc.get("patch_size",
                           int(round((pe.shape[-1] // 3) ** 0.5)))
        n_pos = w[POS_KEY].shape[0]
        vocab, _ = w["text_model.embeddings.token_embedding.weight"].shape
        ctx = w["text_model.embeddings.position_embedding.weight"].shape[0]
        image = vc.get("image_size", int(round(n_pos ** 0.5)) * patch)
        vision = VisionConfig(
            image_size=image, patch_size=patch, width=v_width, depth=v_depth,
            num_heads=vc.get("num_attention_heads", max(1, v_width // 64)),
            mlp_dim=w["vision_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
            act=normalize_act(vc.get("hidden_act"), "gelu_tanh"),
            ln_eps=vc.get("layer_norm_eps", 1e-6),
            pooling="map", pre_norm=False, patch_bias=True)
        text = TextConfig(
            vocab_size=vocab, context_length=ctx, width=t_width, depth=t_depth,
            num_heads=tc.get("num_attention_heads", max(1, t_width // 64)),
            mlp_dim=w["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
            act=normalize_act(tc.get("hidden_act"), "gelu_tanh"),
            ln_eps=tc.get("layer_norm_eps", 1e-6),
            causal=False, pooling="last", proj_bias=True)
        proj = w["text_model.head.weight"].shape[0]
        return SigLIPConfig(vision=vision, text=text, projection_dim=proj)

    @staticmethod
    def hf_mapping(cfg: SigLIPConfig) -> list[M]:
        """HF ``SiglipModel`` name -> port parameter, one entry per layer.
        torch's MAP head fuses q/k/v into ``in_proj_*``: split in thirds."""
        h, d = "vision_model.head.", "vision.head."
        entries = [
            M("vision.pos_embed", POS_KEY, T.unsqueeze),
            M("vision.patch_embed.conv.weight", PATCH_KEY, T.patch),
            M("vision.patch_embed.conv.bias",
              "vision_model.embeddings.patch_embedding.bias"),
            M("vision.ln_post.weight", "vision_model.post_layernorm.weight"),
            M("vision.ln_post.bias", "vision_model.post_layernorm.bias"),
            M(d + "probe", h + "probe"),
            *[M(f"{d}attn.{n}.{leaf}", f"{h}attention.in_proj_{leaf}",
                T.chunk(3, i))
              for leaf in ("weight", "bias") for i, n in enumerate("qkv")],
            M(d + "attn.out.weight", h + "attention.out_proj.weight"),
            M(d + "attn.out.bias", h + "attention.out_proj.bias"),
            M(d + "ln.weight", h + "layernorm.weight"),
            M(d + "ln.bias", h + "layernorm.bias"),
            M(d + "mlp.fc1.weight", h + "mlp.fc1.weight"),
            M(d + "mlp.fc1.bias", h + "mlp.fc1.bias"),
            M(d + "mlp.fc2.weight", h + "mlp.fc2.weight"),
            M(d + "mlp.fc2.bias", h + "mlp.fc2.bias"),
            M("text.token_embed.weight",
              "text_model.embeddings.token_embedding.weight"),
            M("text.pos_embed",
              "text_model.embeddings.position_embedding.weight"),
            M("text.ln_final.weight", "text_model.final_layer_norm.weight"),
            M("text.ln_final.bias", "text_model.final_layer_norm.bias"),
            M("text_projection.weight", "text_model.head.weight"),
            M("text_projection.bias", "text_model.head.bias"),
            M("logit_scale", "logit_scale", T.scalar_1d),
            M("logit_bias", "logit_bias", T.scalar_1d),
        ]
        return (per_layer(entries
                          + hf_encoder_layers("vision.", "vision_model."),
                          cfg.vision.depth)
                + per_layer(hf_encoder_layers("text.", "text_model."),
                            cfg.text.depth))

    @classmethod
    def from_pretrained(cls, name_or_path, *, device=None,
                        dtype: torch.dtype | None = None,
                        use_pytorch: bool = False,
                        runtime: dict | None = None,
                        image_size: int | None = None) -> "SigLIP":
        """Load a local HF SigLIP or SigLIP2 checkpoint (directory or file)
        onto ``device`` (default: the card) in ``dtype`` (default f32).
        ``runtime`` overrides execution fields a checkpoint cannot know
        (``attn_impl``, ``ln_impl``, ...; ``configs.RUNTIME_FIELDS``);
        ``image_size`` loads at another resolution, the position grid
        resampled bilinearly."""
        device = resolve_device(device)
        weights, config = resolve_checkpoint(name_or_path,
                                             use_pytorch=use_pytorch)
        cfg = cls.config_from_hf(config, weights)
        if runtime:
            cfg = with_runtime(cfg, **runtime)
        orig_pos_n = weights[POS_KEY].shape[0]
        # MAP pooling: a pure grid, no class token
        weights, cfg = apply_image_size(weights, cfg, image_size,
                                        key=POS_KEY, n_prefix=0)
        # SigLIP2 position tables are sized by num_patches (the NaFlex
        # maximum), which can differ from the fixed grid: resample as the HF
        # runtime's resize_positional_embeddings does (bilinear)
        if weights[POS_KEY].shape[0] != cfg.vision.grid ** 2:
            weights = resize_checkpoint_pos_embed(
                weights, POS_KEY, patch_size=cfg.vision.patch_size,
                image_size=cfg.vision.image_size, n_prefix=0)
        model = build_loaded(cls, cfg, weights, device=device, dtype=dtype)
        # a SigLIP2 origin (NaFlex Linear patch embedding) decides the
        # default export flavor
        model._hf_source_flavor = ("siglip2" if weights[PATCH_KEY].ndim == 2
                                   else "siglip")
        model.vision._pos_table_resampled = (
            weights[POS_KEY].shape[0] != orig_pos_n)
        return model

    def hf_config(self) -> dict:
        cfg = self.config
        vision = {
            "hidden_size": cfg.vision.width,
            "num_hidden_layers": cfg.vision.depth,
            "num_attention_heads": cfg.vision.num_heads,
            "intermediate_size": cfg.vision.mlp_dim,
            "image_size": cfg.vision.image_size,
            "patch_size": cfg.vision.patch_size,
            "hidden_act": act_to_hf(cfg.vision.act),
            "layer_norm_eps": cfg.vision.ln_eps,
        }
        text = {
            "hidden_size": cfg.text.width,
            "num_hidden_layers": cfg.text.depth,
            "num_attention_heads": cfg.text.num_heads,
            "intermediate_size": cfg.text.mlp_dim,
            "vocab_size": cfg.text.vocab_size,
            "max_position_embeddings": cfg.text.context_length,
            "hidden_act": act_to_hf(cfg.text.act),
            "layer_norm_eps": cfg.text.ln_eps,
        }
        return {"architectures": ["SiglipModel"], "model_type": "siglip",
                "vision_config": vision, "text_config": text}

    def save_pretrained(self, save_dir, *, flavor: str | None = None) -> None:
        """Export an HF checkpoint. ``flavor``: ``"siglip"`` (v1: Conv2d OIHW
        patch embedding, ``SiglipModel`` reloads it), ``"siglip2"`` (NaFlex
        Linear patch embedding and ``num_patches``, ``Siglip2Model`` reloads
        it), or ``None``: the flavor the model was loaded from (v1 for a
        model built from a config)."""
        source = getattr(self, "_hf_source_flavor", None)
        flavor = flavor or source or "siglip"
        if flavor not in ("siglip", "siglip2"):
            raise ValueError(f"unknown export flavor {flavor!r}")
        if flavor == "siglip":
            if source == "siglip2":
                warnings.warn(
                    "exporting a Siglip2-origin model in SiglipModel (v1) "
                    "format: the NaFlex Linear patch embedding becomes a "
                    "Conv2d OIHW weight; pass flavor='siglip2' for a "
                    "Siglip2Model-loadable export", stacklevel=2)
            save_pretrained(self, save_dir)
            return

        def state_hook(state: dict) -> dict:
            # OIHW (D, C, p, p) -> the NaFlex Linear (D, p*p*C), its input
            # ordered (row, col, chan)
            pe = state[PATCH_KEY]
            d_out, c, p, _ = pe.shape
            state[PATCH_KEY] = pe.permute(0, 2, 3, 1).reshape(
                d_out, p * p * c).contiguous()
            return state

        def config_hook(config: dict) -> dict:
            config["architectures"] = ["Siglip2Model"]
            config["model_type"] = "siglip2"
            config["vision_config"]["num_patches"] = \
                self.config.vision.num_patches
            return config

        save_pretrained(self, save_dir, state_hook=state_hook,
                        config_hook=config_hook)
