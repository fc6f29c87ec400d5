"""ViT image classifier; the counterpart of ``jimm_tpu/models/vit.py``:
a post-norm CLS-pooled vision tower (LayerNorm eps 1e-12) and an optional
zero-initialised linear head, HF ``ViTForImageClassification`` checkpoints
in and out (``config.json`` parsed, or the shapes read from the tensors
when it is absent), strictly mapped."""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from jimm_tpu_torch.configs import (VisionConfig, ViTConfig, act_to_hf,
                                    normalize_act, with_runtime)
from jimm_tpu_torch.models.common import (build_loaded, init_params,
                                          resolve_device)
from jimm_tpu_torch.nn.vision import VisionTower
from jimm_tpu_torch.parallel.sharding import gathered_linear
from jimm_tpu_torch.weights.export import save_pretrained
from jimm_tpu_torch.weights.loader import M, per_layer
from jimm_tpu_torch.weights.resolve import resolve_checkpoint
from jimm_tpu_torch.weights.surgery import apply_image_size

POS_KEY = "vit.embeddings.position_embeddings"


class VisionTransformer(nn.Module):
    """ViT on ``device`` (default: the card) in ``dtype``, randomly
    initialised from ``generator`` (default: seed 0 on the model's device);
    the classifier starts at zero, as the JAX package's does."""

    def __init__(self, config: ViTConfig | None = None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = config or ViTConfig()
        dev = resolve_device(device)
        self.config = cfg
        kw = {"device": dev, "dtype": dtype}
        self.vision = VisionTower(cfg.vision, **kw)
        if cfg.do_classification:
            self.classifier = nn.Linear(cfg.vision.width, cfg.num_classes,
                                        **kw)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        init_params(self, generator)
        if cfg.do_classification:
            with torch.no_grad():
                self.classifier.weight.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, num_classes) logits, or the pooled (B, width)
        features without a head."""
        pooled = self.vision(images)
        if self.config.do_classification:
            return gathered_linear(self.classifier, pooled)
        return pooled

    # -- HF checkpoints ----------------------------------------------------

    @staticmethod
    def config_from_hf(config: dict[str, Any] | None,
                       weights: dict[str, torch.Tensor]) -> ViTConfig:
        """HF ``config.json`` -> ViTConfig; from the tensors' shapes when it
        is absent. The head exists when the checkpoint has one."""
        has_head = "classifier.weight" in weights
        if config:
            width = config.get("hidden_size", 768)
            vision = VisionConfig(
                image_size=config.get("image_size", 224),
                patch_size=config.get("patch_size", 16),
                channels=config.get("num_channels", 3),
                width=width,
                depth=config.get("num_hidden_layers", 12),
                num_heads=config.get("num_attention_heads", 12),
                mlp_dim=config.get("intermediate_size", 4 * width),
                act=normalize_act(config.get("hidden_act")),
                ln_eps=config.get("layer_norm_eps", 1e-12),
                pooling="cls")
            num_classes = (len(config["id2label"]) if config.get("id2label")
                           else config.get("num_labels", 1000))
            return ViTConfig(vision=vision, num_classes=num_classes,
                             do_classification=has_head)
        w = weights
        width = w["vit.embeddings.cls_token"].shape[-1]
        depth = 1 + max(int(k.split(".")[3]) for k in w
                        if k.startswith("vit.encoder.layer."))
        mlp_dim = w["vit.encoder.layer.0.intermediate.dense.weight"].shape[0]
        patch = w["vit.embeddings.patch_embeddings.projection.weight"].shape[-1]
        n_pos = w[POS_KEY].shape[1] - 1
        vision = VisionConfig(image_size=int(round(n_pos ** 0.5)) * patch,
                              patch_size=patch, width=width, depth=depth,
                              num_heads=max(1, width // 64), mlp_dim=mlp_dim,
                              ln_eps=1e-12, pooling="cls")
        num_classes = w["classifier.weight"].shape[0] if has_head else 1000
        return ViTConfig(vision=vision, num_classes=num_classes,
                         do_classification=has_head)

    @staticmethod
    def hf_mapping(cfg: ViTConfig) -> list[M]:
        """HF ``ViTForImageClassification`` name -> port parameter, one
        entry per layer."""
        p, d = "vit.encoder.layer.{i}.", "vision.encoder.blocks.{i}."
        layer = [("ln1", "layernorm_before"),
                 ("attn.q", "attention.attention.query"),
                 ("attn.k", "attention.attention.key"),
                 ("attn.v", "attention.attention.value"),
                 ("attn.out", "attention.output.dense"),
                 ("ln2", "layernorm_after"),
                 ("mlp.fc1", "intermediate.dense"),
                 ("mlp.fc2", "output.dense")]
        entries = [
            M("vision.cls_token", "vit.embeddings.cls_token"),
            M("vision.pos_embed", POS_KEY),
            M("vision.patch_embed.conv.weight",
              "vit.embeddings.patch_embeddings.projection.weight"),
            M("vision.patch_embed.conv.bias",
              "vit.embeddings.patch_embeddings.projection.bias"),
            M("vision.ln_post.weight", "vit.layernorm.weight"),
            M("vision.ln_post.bias", "vit.layernorm.bias"),
            *[M(f"{d}{ours}.{leaf}", f"{p}{theirs}.{leaf}")
              for ours, theirs in layer for leaf in ("weight", "bias")],
        ]
        if cfg.do_classification:
            entries += [M("classifier.weight", "classifier.weight"),
                        M("classifier.bias", "classifier.bias")]
        return per_layer(entries, cfg.vision.depth)

    @classmethod
    def from_pretrained(cls, name_or_path, *, device=None,
                        dtype: torch.dtype | None = None,
                        use_pytorch: bool = False,
                        runtime: dict | None = None,
                        image_size: int | None = None
                        ) -> "VisionTransformer":
        """Load a local HF ViT checkpoint onto ``device`` (default: the
        card) in ``dtype`` (default f32); ``runtime`` and ``image_size`` as
        in :meth:`SigLIP.from_pretrained
        <jimm_tpu_torch.models.siglip.SigLIP.from_pretrained>`."""
        device = resolve_device(device)
        weights, config = resolve_checkpoint(name_or_path,
                                             use_pytorch=use_pytorch)
        cfg = cls.config_from_hf(config, weights)
        if runtime:
            cfg = with_runtime(cfg, **runtime)
        weights, cfg = apply_image_size(weights, cfg, image_size,
                                        key=POS_KEY, n_prefix=1)
        return build_loaded(cls, cfg, weights, device=device, dtype=dtype)

    def hf_config(self) -> dict:
        cfg, v = self.config, self.config.vision
        return {
            "architectures": ["ViTForImageClassification"],
            "model_type": "vit",
            "hidden_size": v.width, "num_hidden_layers": v.depth,
            "num_attention_heads": v.num_heads,
            "intermediate_size": v.mlp_dim, "image_size": v.image_size,
            "patch_size": v.patch_size, "num_channels": v.channels,
            "hidden_act": act_to_hf(v.act), "layer_norm_eps": v.ln_eps,
            "qkv_bias": True,
            "id2label": {str(i): f"LABEL_{i}"
                         for i in range(cfg.num_classes)},
            "label2id": {f"LABEL_{i}": i for i in range(cfg.num_classes)},
        }

    def save_pretrained(self, save_dir) -> None:
        save_pretrained(self, save_dir)
