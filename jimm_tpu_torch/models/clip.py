"""CLIP dual-tower model; the counterpart of ``jimm_tpu/models/clip.py``:
a pre-norm QuickGELU vision tower without patch bias, a causal text tower
pooled at the EOT token, bias-free projections and a scalar learned
``logit_scale``; HF ``CLIPModel`` checkpoints in and out (``config.json``
parsed, or the shapes read from the tensors when it is absent)."""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from jimm_tpu_torch.configs import (CLIPConfig, TextConfig, VisionConfig,
                                    act_to_hf, normalize_act, with_runtime)
from jimm_tpu_torch.models.common import (build_loaded, hf_encoder_layers,
                                          init_params, resolve_device)
from jimm_tpu_torch.nn.text import TextTower
from jimm_tpu_torch.nn.vision import VisionTower
from jimm_tpu_torch.parallel.sharding import gathered_linear
from jimm_tpu_torch.weights.export import save_pretrained
from jimm_tpu_torch.weights.loader import M, T, per_layer
from jimm_tpu_torch.weights.resolve import resolve_checkpoint
from jimm_tpu_torch.weights.surgery import apply_image_size

POS_KEY = "vision_model.embeddings.position_embedding.weight"


class CLIP(nn.Module):
    """CLIP on ``device`` (default: the card) in ``dtype``, randomly
    initialised from ``generator`` (default: seed 0 on the model's
    device)."""

    def __init__(self, config: CLIPConfig | None = None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = config or CLIPConfig()
        dev = resolve_device(device)
        self.config = cfg
        kw = {"device": dev, "dtype": dtype}
        self.vision = VisionTower(cfg.vision, **kw)
        self.visual_projection = nn.Linear(cfg.vision.width,
                                           cfg.projection_dim, bias=False,
                                           **kw)
        self.text = TextTower(cfg.text, **kw)
        self.text_projection = nn.Linear(cfg.text.width, cfg.projection_dim,
                                         bias=False, **kw)
        self.logit_scale = nn.Parameter(torch.zeros((), **kw))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init_params(self, generator)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> unnormalized (B, projection_dim)."""
        return gathered_linear(self.visual_projection, self.vision(images))

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """(B, S) token ids -> unnormalized (B, projection_dim), pooled at
        the EOT token."""
        hidden = self.text(text)
        return gathered_linear(self.text_projection,
                               self.text.pool(hidden, text))

    def forward(self, images: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """logits_per_image (B_img, B_txt): cosine similarities scaled by
        exp(logit_scale)."""
        img = self.encode_image(images)
        txt = self.encode_text(text)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return self.logit_scale.exp() * img @ txt.T

    # -- HF checkpoints ----------------------------------------------------

    @staticmethod
    def config_from_hf(config: dict[str, Any] | None,
                       weights: dict[str, torch.Tensor]) -> CLIPConfig:
        if config and "vision_config" in config:
            vc, tc = config["vision_config"], config["text_config"]
            vw, tw = vc.get("hidden_size", 768), tc.get("hidden_size", 512)
            vision = VisionConfig(
                image_size=vc.get("image_size", 224),
                patch_size=vc.get("patch_size", 32), width=vw,
                depth=vc.get("num_hidden_layers", 12),
                num_heads=vc.get("num_attention_heads", max(1, vw // 64)),
                mlp_dim=vc.get("intermediate_size", 4 * vw),
                act=normalize_act(vc.get("hidden_act"), "quick_gelu"),
                ln_eps=vc.get("layer_norm_eps", 1e-5),
                pooling="cls", pre_norm=True, patch_bias=False)
            text = TextConfig(
                vocab_size=tc.get("vocab_size", 49408),
                context_length=tc.get("max_position_embeddings", 77),
                width=tw, depth=tc.get("num_hidden_layers", 12),
                num_heads=tc.get("num_attention_heads", max(1, tw // 64)),
                mlp_dim=tc.get("intermediate_size", 4 * tw),
                act=normalize_act(tc.get("hidden_act"), "quick_gelu"),
                ln_eps=tc.get("layer_norm_eps", 1e-5),
                causal=True, pooling="eot", proj_bias=False,
                eos_token_id=tc.get("eos_token_id"))
            return CLIPConfig(vision=vision, text=text,
                              projection_dim=config.get("projection_dim", 512))
        w = weights
        v_width = w["vision_model.post_layernorm.weight"].shape[0]
        t_width = w["text_model.final_layer_norm.weight"].shape[0]
        v_depth = 1 + max(int(k.split(".")[3]) for k in w
                          if k.startswith("vision_model.encoder.layers."))
        t_depth = 1 + max(int(k.split(".")[3]) for k in w
                          if k.startswith("text_model.encoder.layers."))
        patch = w["vision_model.embeddings.patch_embedding.weight"].shape[-1]
        n_pos = w[POS_KEY].shape[0] - 1
        vocab, _ = w["text_model.embeddings.token_embedding.weight"].shape
        ctx = w["text_model.embeddings.position_embedding.weight"].shape[0]
        vision = VisionConfig(
            image_size=int(round(n_pos ** 0.5)) * patch, patch_size=patch,
            width=v_width, depth=v_depth, num_heads=max(1, v_width // 64),
            mlp_dim=w["vision_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
            act="quick_gelu", ln_eps=1e-5, pooling="cls", pre_norm=True,
            patch_bias=False)
        text = TextConfig(
            vocab_size=vocab, context_length=ctx, width=t_width, depth=t_depth,
            num_heads=max(1, t_width // 64),
            mlp_dim=w["text_model.encoder.layers.0.mlp.fc1.weight"].shape[0],
            act="quick_gelu", ln_eps=1e-5, causal=True, pooling="eot",
            proj_bias=False)
        return CLIPConfig(vision=vision, text=text,
                          projection_dim=w["visual_projection.weight"].shape[0])

    @staticmethod
    def hf_mapping(cfg: CLIPConfig) -> list[M]:
        """HF ``CLIPModel`` name -> port parameter, one entry per layer."""
        entries = [
            M("vision.cls_token", "vision_model.embeddings.class_embedding",
              T.reshape_1_1_d),
            M("vision.pos_embed", POS_KEY, T.unsqueeze),
            M("vision.patch_embed.conv.weight",
              "vision_model.embeddings.patch_embedding.weight"),
            # HF's misspelled "pre_layrnorm" is the checkpoint's name
            M("vision.ln_pre.weight", "vision_model.pre_layrnorm.weight"),
            M("vision.ln_pre.bias", "vision_model.pre_layrnorm.bias"),
            M("vision.ln_post.weight", "vision_model.post_layernorm.weight"),
            M("vision.ln_post.bias", "vision_model.post_layernorm.bias"),
            M("visual_projection.weight", "visual_projection.weight"),
            M("text.token_embed.weight",
              "text_model.embeddings.token_embedding.weight"),
            M("text.pos_embed",
              "text_model.embeddings.position_embedding.weight"),
            M("text.ln_final.weight", "text_model.final_layer_norm.weight"),
            M("text.ln_final.bias", "text_model.final_layer_norm.bias"),
            M("text_projection.weight", "text_projection.weight"),
            M("logit_scale", "logit_scale", T.scalar),
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
                        image_size: int | None = None) -> "CLIP":
        """Load a local HF CLIP checkpoint onto ``device`` (default: the
        card) in ``dtype`` (default f32); ``runtime`` and ``image_size`` as
        in :meth:`SigLIP.from_pretrained
        <jimm_tpu_torch.models.siglip.SigLIP.from_pretrained>`."""
        device = resolve_device(device)
        weights, config = resolve_checkpoint(name_or_path,
                                             use_pytorch=use_pytorch)
        cfg = cls.config_from_hf(config, weights)
        if runtime:
            cfg = with_runtime(cfg, **runtime)
        # the class token's position comes first
        weights, cfg = apply_image_size(weights, cfg, image_size,
                                        key=POS_KEY, n_prefix=1)
        return build_loaded(cls, cfg, weights, device=device, dtype=dtype)

    def hf_config(self) -> dict:
        cfg = self.config
        vision = {
            "projection_dim": cfg.projection_dim,
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
            "projection_dim": cfg.projection_dim,
            # eos 2 selects HF's legacy argmax pooling: the EOT semantics of
            # an unset eos_token_id here
            "eos_token_id": (cfg.text.eos_token_id
                             if cfg.text.eos_token_id is not None else 2),
            "hidden_size": cfg.text.width,
            "num_hidden_layers": cfg.text.depth,
            "num_attention_heads": cfg.text.num_heads,
            "intermediate_size": cfg.text.mlp_dim,
            "vocab_size": cfg.text.vocab_size,
            "max_position_embeddings": cfg.text.context_length,
            "hidden_act": act_to_hf(cfg.text.act),
            "layer_norm_eps": cfg.text.ln_eps,
        }
        return {"architectures": ["CLIPModel"], "model_type": "clip",
                "projection_dim": cfg.projection_dim,
                "vision_config": vision, "text_config": text}

    def save_pretrained(self, save_dir) -> None:
        save_pretrained(self, save_dir)
