"""Model configuration dataclasses and the ViT, CLIP and SigLIP presets.

The port's own copy of the parts of ``jimm_tpu/configs.py`` it uses: the
tower and model dataclasses with the same fields and defaults (so a config
means the same thing to both packages), the runtime-field rule,
``with_runtime`` with its value checks, ``remat_policy_parts``,
``parse_remat``, ``normalize_act``, ``act_to_hf`` and the presets, the
temporal ViT ones included. The tests hold this copy equal to the JAX
package's field by field.

``scan_unroll`` selects a JAX execution strategy the port does not have
(its blocks run in a Python loop); it is kept for that equality, and
``train --scan-unroll`` (which ``supervise --adapt`` may set) writes it. The
pipeline fields (``pipeline`` and the ``pp_*`` family) are honoured by the
pipelined encoder (`jimm_tpu_torch/nn/transformer.py`), whose schedule
checks, :func:`check_pp_schedule` and :func:`validate_pipeline`, are copies
of JAX's with its messages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Literal

Pooling = Literal["cls", "map", "last", "eot", "none"]
Activation = Literal["gelu", "gelu_tanh", "quick_gelu"]
AttnImpl = Literal["auto", "xla", "flash", "flash_masked", "flash_bias",
                   "flash_int8", "sigmoid", "ring", "ulysses", "saveable"]
Precision = Literal["bf16", "fp8_hybrid", "int8_qk"]
#: "dots" + optional "+ln"/"+act"/"+attn" save-list extensions
RematPolicy = str


def remat_policy_parts(policy: str) -> list[str]:
    """Validate a remat policy string; return its ``+``-separated parts."""
    parts = policy.split("+")
    if policy != "none" and (parts[0] != "dots"
                             or not set(parts[1:]) <= {"ln", "act", "attn"}):
        raise ValueError(f"unknown remat_policy {policy!r}; expected 'none' "
                         "or 'dots' with optional '+ln', '+act', '+attn' "
                         "suffixes (e.g. 'dots+ln+act')")
    return parts


def parse_remat(spec: str) -> dict[str, Any]:
    """CLI ``--remat`` spec -> `with_runtime` kwargs. ``none`` = remat off,
    ``full`` = remat with full recompute, ``dots[+ln][+act][+attn]`` = remat
    with that save-list. Raises ValueError on a malformed spec."""
    if spec in ("none", "full"):
        return {"remat": spec != "none", "remat_policy": "none"}
    remat_policy_parts(spec)
    return {"remat": True, "remat_policy": spec}


def check_pp_schedule(M: int, V: int, *, n_stages: int | None = None,
                      local_batch: int | None = None,
                      prefix: str = "") -> None:
    """Microbatch scheduling constraints -- the ONE implementation behind
    both the parse-time validation (``validate_pipeline``) and the
    trace-time checks in `parallel/pipeline.py`, so semantics and messages
    cannot drift apart."""
    if M < 1:
        raise ValueError(prefix + f"n_microbatches must be >= 1, got {M}")
    if V < 1:
        raise ValueError(prefix + f"n_virtual must be >= 1, got {V}")
    if n_stages is not None and V > 1 and M % n_stages:
        raise ValueError(prefix + f"interleaved schedule needs microbatches "
                         f"{M} divisible by {n_stages} stages")
    if local_batch is not None and local_batch % M:
        raise ValueError(prefix + f"local batch {local_batch} not divisible "
                         f"by {M} microbatches")


def validate_pipeline(tower, *, n_stages: int, local_batch: int | None = None,
                      tower_name: str | None = None) -> None:
    """Surface the pipeline constraints at config/CLI parse time. The same
    function runs inside `nn/transformer.py`'s pipeline dispatch, and the
    microbatch checks are shared with `parallel/pipeline.py` via
    ``check_pp_schedule`` -- one implementation, both paths."""
    if not getattr(tower, "pipeline", False):
        return
    M, V = tower.pp_microbatches, tower.pp_virtual
    prefix = f"{tower_name} tower: " if tower_name else ""
    check_pp_schedule(M, V, prefix=prefix)
    if n_stages < 1:
        raise ValueError(prefix + "pipeline=True needs an ambient mesh with "
                         "a 'stage' axis (use use_sharding(mesh, PIPELINE))")
    if tower.depth % (n_stages * V):
        raise ValueError(prefix + f"depth {tower.depth} not divisible by "
                         f"{n_stages} stages x {V} virtual chunks")
    if V > 1 and tower.pp_stages and tower.pp_stages != n_stages:
        raise ValueError(prefix + f"model was built for "
                         f"pp_stages={tower.pp_stages} but the mesh has "
                         f"{n_stages} stages")
    check_pp_schedule(M, V, n_stages=n_stages, local_batch=local_batch,
                      prefix=prefix)


def normalize_act(name: str | None, default: str = "gelu") -> str:
    """HF ``hidden_act`` -> canonical Activation name."""
    if name is None:
        return default
    return {"gelu": "gelu", "gelu_new": "gelu_tanh",
            "gelu_pytorch_tanh": "gelu_tanh",
            "quick_gelu": "quick_gelu"}.get(name, name)


def act_to_hf(name: str) -> str:
    """Canonical Activation name -> HF ``hidden_act``."""
    return {"gelu": "gelu", "gelu_tanh": "gelu_pytorch_tanh",
            "quick_gelu": "quick_gelu"}.get(name, name)


#: Tower fields that select execution strategy, not architecture — safe to
#: override on a preset or a loaded checkpoint
RUNTIME_FIELDS = frozenset({
    "attn_impl", "ln_impl", "fused_qkv", "remat", "remat_policy", "scan_unroll",
    "dropout", "pipeline", "pp_microbatches", "pp_virtual", "pp_stages",
    "precision",
})


def _check_runtime_values(fields: dict[str, Any]) -> None:
    """Raise on an out-of-domain runtime value, as the JAX package's
    ``_check_runtime_fields`` does for the fields the port reads: a
    malformed remat policy (its own message), a dropout rate outside
    [0, 1], a non-bool ``remat``."""
    for k, v in fields.items():
        ok = True
        if k == "remat":
            ok = isinstance(v, bool)
        elif k == "remat_policy":
            remat_policy_parts(str(v))  # raises on a malformed spec
            ok = isinstance(v, str)
        elif k == "dropout":
            ok = isinstance(v, (int, float)) and 0.0 <= v <= 1.0
        if not ok:
            raise ValueError(f"bad value for runtime field {k!r}: {v!r}")


def with_runtime(cfg, **fields):
    """Return ``cfg`` with runtime (non-architecture) fields replaced in the
    vision and, if present, text tower. Rejects architecture fields and
    out-of-domain values (:func:`_check_runtime_values`).

    Flat fields apply to both towers; ``vision=dict(...)`` /
    ``text=dict(...)`` target one tower."""
    per_tower = {t: dict(fields.pop(t, None) or {})
                 for t in ("vision", "text")}
    bad = (set(fields) | set(per_tower["vision"]) | set(per_tower["text"])
           ) - RUNTIME_FIELDS
    if bad:
        raise ValueError(f"not runtime-overridable: {sorted(bad)} "
                         f"(allowed: {sorted(RUNTIME_FIELDS)})")
    for group in (fields, per_tower["vision"], per_tower["text"]):
        _check_runtime_values(group)
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, **fields, **per_tower["vision"]))
    if hasattr(cfg, "text"):
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, **fields, **per_tower["text"]))
    elif per_tower["text"]:
        raise ValueError("config has no text tower to override")
    return cfg


@dataclass(frozen=True)
class TransformerConfig:
    """Shared encoder-stack hyperparameters (vision or text tower)."""

    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    act: Activation = "gelu"
    ln_eps: float = 1e-6
    dropout: float = 0.0
    causal: bool = False
    attn_impl: AttnImpl = "auto"
    pipeline: bool = False
    pp_microbatches: int = 4
    pp_virtual: int = 1
    pp_stages: int = 0
    remat: bool = False
    remat_policy: RematPolicy = "none"
    #: LayerNorm: "xla" (plain torch LayerNorm) or "fused" (the LayerNorm
    #: kernel, `jimm_tpu_torch/ops/layer_norm.py`)
    ln_impl: Literal["xla", "fused"] = "xla"
    #: compute q/k/v as one (H, 3H) matmul (call-time weight concat)
    fused_qkv: bool = False
    scan_unroll: int = 1
    precision: Precision = "bf16"

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads


@dataclass(frozen=True)
class VisionConfig:
    """Vision tower (fixed resolution)."""

    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_frames: int = 1
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    act: Activation = "gelu"
    ln_eps: float = 1e-6
    dropout: float = 0.0
    pooling: Pooling = "cls"
    pre_norm: bool = False
    patch_bias: bool = True
    attn_impl: AttnImpl = "auto"
    pipeline: bool = False
    pp_microbatches: int = 4
    pp_virtual: int = 1
    pp_stages: int = 0
    remat: bool = False
    remat_policy: RematPolicy = "none"
    ln_impl: Literal["xla", "fused"] = "xla"
    fused_qkv: bool = False
    scan_unroll: int = 1
    precision: Precision = "bf16"

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid * self.num_frames

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.pooling == "cls" else 0)

    def encoder(self) -> TransformerConfig:
        return TransformerConfig(
            width=self.width, depth=self.depth, num_heads=self.num_heads,
            mlp_dim=self.mlp_dim, act=self.act, ln_eps=self.ln_eps,
            dropout=self.dropout, causal=False, attn_impl=self.attn_impl,
            pipeline=self.pipeline, pp_microbatches=self.pp_microbatches,
            pp_virtual=self.pp_virtual, pp_stages=self.pp_stages,
            remat=self.remat, remat_policy=self.remat_policy,
            ln_impl=self.ln_impl, fused_qkv=self.fused_qkv,
            scan_unroll=self.scan_unroll, precision=self.precision,
        )


@dataclass(frozen=True)
class TextConfig:
    """Text tower. SigLIP: bidirectional + last-token pooling; CLIP: causal
    + EOT pooling."""

    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    depth: int = 12
    num_heads: int = 8
    mlp_dim: int = 2048
    act: Activation = "quick_gelu"
    ln_eps: float = 1e-5
    dropout: float = 0.0
    causal: bool = True
    pooling: Pooling = "eot"
    proj_bias: bool = False
    eos_token_id: int | None = None
    attn_impl: AttnImpl = "auto"
    pipeline: bool = False
    pp_microbatches: int = 4
    pp_virtual: int = 1
    pp_stages: int = 0
    remat: bool = False
    remat_policy: RematPolicy = "none"
    ln_impl: Literal["xla", "fused"] = "xla"
    fused_qkv: bool = False
    scan_unroll: int = 1
    precision: Precision = "bf16"

    def encoder(self) -> TransformerConfig:
        return TransformerConfig(
            width=self.width, depth=self.depth, num_heads=self.num_heads,
            mlp_dim=self.mlp_dim, act=self.act, ln_eps=self.ln_eps,
            dropout=self.dropout, causal=self.causal, attn_impl=self.attn_impl,
            pipeline=self.pipeline, pp_microbatches=self.pp_microbatches,
            pp_virtual=self.pp_virtual, pp_stages=self.pp_stages,
            remat=self.remat, remat_policy=self.remat_policy,
            ln_impl=self.ln_impl, fused_qkv=self.fused_qkv,
            scan_unroll=self.scan_unroll, precision=self.precision,
        )


@dataclass(frozen=True)
class ViTConfig:
    """ViT image classifier: post-norm backbone, CLS pooling, LN eps 1e-12,
    optional linear head."""

    vision: VisionConfig = field(default_factory=lambda: VisionConfig(ln_eps=1e-12))
    num_classes: int = 1000
    do_classification: bool = True


@dataclass(frozen=True)
class CLIPConfig:
    """CLIP dual tower: pre-norm QuickGELU vision tower without patch bias,
    causal text tower, bias-free projections, learned ``logit_scale``."""

    vision: VisionConfig = field(default_factory=lambda: VisionConfig(
        width=768, depth=12, num_heads=12, mlp_dim=3072, act="quick_gelu",
        ln_eps=1e-5, pooling="cls", pre_norm=True, patch_bias=False,
        patch_size=32))
    text: TextConfig = field(default_factory=TextConfig)
    projection_dim: int = 512
    logit_scale_init: float = 2.6592  # ln(1/0.07), OpenAI CLIP init


@dataclass(frozen=True)
class SigLIPConfig:
    """SigLIP dual tower: MAP-pooled vision tower (gelu_tanh, eps 1e-6),
    bidirectional text tower with last-token pooling and a biased
    projection, ``logit_scale`` and ``logit_bias``."""

    vision: VisionConfig = field(default_factory=lambda: VisionConfig(
        image_size=256, patch_size=16, width=768, depth=12, num_heads=12,
        mlp_dim=3072, act="gelu_tanh", ln_eps=1e-6, pooling="map",
        pre_norm=False, patch_bias=True))
    text: TextConfig = field(default_factory=lambda: TextConfig(
        vocab_size=32000, context_length=64, width=768, depth=12, num_heads=12,
        mlp_dim=3072, act="gelu_tanh", ln_eps=1e-6, causal=False,
        pooling="last", proj_bias=True))
    projection_dim: int = 768
    logit_scale_init: float = 2.3026  # ln(10), SigLIP paper init
    logit_bias_init: float = -10.0


def _vit(size: str, patch: int, image: int, classes: int = 1000) -> ViTConfig:
    w, d, h, m = {
        "T": (192, 12, 3, 768),
        "S": (384, 12, 6, 1536),
        "B": (768, 12, 12, 3072),
        "L": (1024, 24, 16, 4096),
        "H": (1280, 32, 16, 5120),
    }[size]
    return ViTConfig(
        vision=VisionConfig(image_size=image, patch_size=patch, width=w,
                            depth=d, num_heads=h, mlp_dim=m, ln_eps=1e-12),
        num_classes=classes)


def _vit_temporal(size: str, patch: int, image: int, frames: int,
                  classes: int = 1000) -> ViTConfig:
    """Temporal ViT: the frames flattened into one sequence (T * grid^2
    tokens) under a T * grid^2 position table, full spatio-temporal
    attention, MAP pooling (no class token)."""
    base = _vit(size, patch, image, classes)
    return dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_frames=frames,
                                         pooling="map"))


def _clip(vision_size: str, patch: int, image: int = 224) -> CLIPConfig:
    vw, vd, vh, vm, proj = {
        "B": (768, 12, 12, 3072, 512),
        "L": (1024, 24, 16, 4096, 768),
    }[vision_size]
    tw, td, th, tm = {"B": (512, 12, 8, 2048),
                      "L": (768, 12, 12, 3072)}[vision_size]
    return CLIPConfig(
        vision=VisionConfig(image_size=image, patch_size=patch, width=vw,
                            depth=vd, num_heads=vh, mlp_dim=vm,
                            act="quick_gelu", ln_eps=1e-5, pooling="cls",
                            pre_norm=True, patch_bias=False),
        text=TextConfig(vocab_size=49408, context_length=77, width=tw,
                        depth=td, num_heads=th, mlp_dim=tm, act="quick_gelu",
                        ln_eps=1e-5, causal=True, pooling="eot",
                        proj_bias=False),
        projection_dim=proj)


def _siglip(size: str, patch: int, image: int, vocab: int = 32000,
            ctx: int = 64) -> SigLIPConfig:
    w, d, h, m = {
        "B": (768, 12, 12, 3072),
        "L": (1024, 24, 16, 4096),
        "So400m": (1152, 27, 16, 4304),
    }[size]
    return SigLIPConfig(
        vision=VisionConfig(image_size=image, patch_size=patch, width=w, depth=d,
                            num_heads=h, mlp_dim=m, act="gelu_tanh", ln_eps=1e-6,
                            pooling="map"),
        text=TextConfig(vocab_size=vocab, context_length=ctx, width=w, depth=d,
                        num_heads=h, mlp_dim=m, act="gelu_tanh", ln_eps=1e-6,
                        causal=False, pooling="last", proj_bias=True),
        projection_dim=w)


#: Named presets (the same names and shapes as the JAX package's)
PRESETS: dict[str, ViTConfig | CLIPConfig | SigLIPConfig] = {
    "vit-tiny-patch16-224": _vit("T", 16, 224),
    "vit-small-patch16-224": _vit("S", 16, 224),
    "vit-base-patch16-224": _vit("B", 16, 224),
    "vit-base-patch32-384": _vit("B", 32, 384),
    "vit-large-patch16-384": _vit("L", 16, 384),
    "vit-huge-patch14-224": _vit("H", 14, 224),
    # temporal ViT: 8 frames x 196 patches = 1568 tokens, MAP pooling
    "vit-temporal-small-patch16-224-f8": _vit_temporal("S", 16, 224, 8),
    "vit-temporal-base-patch16-224-f8": _vit_temporal("B", 16, 224, 8),
    "clip-vit-base-patch32": _clip("B", 32),
    "clip-vit-base-patch16": _clip("B", 16),
    "clip-vit-large-patch14": _clip("L", 14),
    "clip-vit-large-patch14-336": _clip("L", 14, 336),
    "siglip-base-patch16-224": _siglip("B", 16, 224),
    "siglip-base-patch16-256": _siglip("B", 16, 256),
    "siglip-base-patch16-384": _siglip("B", 16, 384),
    "siglip-large-patch16-256": _siglip("L", 16, 256),
    "siglip-large-patch16-384": _siglip("L", 16, 384),
    "siglip-so400m-patch14-384": _siglip("So400m", 14, 384),
    "siglip2-base-patch16-256": _siglip("B", 16, 256, vocab=256000),
    "siglip2-large-patch16-512": _siglip("L", 16, 512, vocab=256000),
    "siglip2-so400m-patch14-384": _siglip("So400m", 14, 384, vocab=256000),
    "siglip2-so400m-patch16-256": _siglip("So400m", 16, 256, vocab=256000),
}


def family(name: str) -> str:
    """The model family of a preset name: ``vit``, ``clip`` or ``siglip``."""
    for fam in ("vit", "clip", "siglip"):
        if name.startswith(fam):
            return fam
    raise ValueError(f"cannot infer the model family of preset {name!r}")


def preset(name: str, **overrides: Any) -> ViTConfig | CLIPConfig | SigLIPConfig:
    """Fetch a named preset (a config of its family), optionally overriding
    top-level fields."""
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
