"""What the three model families share: the device rule, the JAX
package's initializers, the HF mapping of a CLIP-style encoder layer, the
load of a checkpoint into a built model, and :func:`load_jax_params`, which
carries a JAX model's parameters across by their names."""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from jimm_tpu_torch.nn.norm import FusedLayerNorm
from jimm_tpu_torch.nn.remat import Dropout
from jimm_tpu_torch.quant import QuantLinear
from jimm_tpu_torch.quant.policy import Fp8Linear
from jimm_tpu_torch.weights.loader import M, apply_mapping


def resolve_device(device) -> torch.device:
    """``None`` means the card. Without CUDA that is an error, never a quiet
    move to the CPU: a caller who wants the CPU says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def _xavier_(w: torch.Tensor, fan_in: int, fan_out: int,
             generator: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers, drawn from ``generator``: xavier-uniform
    linear/conv/probe weights, zero biases and class tokens, unit LayerNorm
    scales, normal embeddings (0.02), image positions (0.02) and text
    positions (0.01), the config's logit scale and bias; then one seed for
    each dropout's mask stream. The numbers differ from ``nnx.Rngs(0)``'s;
    tests carry JAX weights across instead."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _xavier_(m.weight, m.in_features, m.out_features, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            rf = m.kernel_size[0] * m.kernel_size[1]
            _xavier_(m.weight, m.in_channels * rf, m.out_channels * rf,
                     generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, FusedLayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
    vision, cfg = model.vision, model.config
    if hasattr(vision, "head"):
        # probe (1, 1, W): JAX's xavier reads fan_in = 1, fan_out = W
        _xavier_(vision.head.probe, 1, cfg.vision.width, generator)
    if hasattr(vision, "cls_token"):
        vision.cls_token.zero_()
    vision.pos_embed.normal_(0.0, 0.02, generator=generator)
    if hasattr(model, "text"):
        model.text.pos_embed.normal_(0.0, 0.01, generator=generator)
    if hasattr(model, "logit_scale"):
        model.logit_scale.fill_(cfg.logit_scale_init)
    if hasattr(model, "logit_bias"):
        model.logit_bias.fill_(cfg.logit_bias_init)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.seed_(generator)


def hf_encoder_layers(dst: str, src: str) -> list[M]:
    """One CLIP/SigLIP encoder layer, HF ``{src}encoder.layers.{i}.*`` ->
    the port's ``{dst}encoder.blocks.{i}.*``."""
    p, d = src + "encoder.layers.{i}.", dst + "encoder.blocks.{i}."
    names = [("ln1", "layer_norm1"), ("attn.q", "self_attn.q_proj"),
             ("attn.k", "self_attn.k_proj"), ("attn.v", "self_attn.v_proj"),
             ("attn.out", "self_attn.out_proj"), ("ln2", "layer_norm2"),
             ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")]
    return [M(f"{d}{ours}.{leaf}", f"{p}{theirs}.{leaf}")
            for ours, theirs in names for leaf in ("weight", "bias")]


def build_loaded(cls, cfg, weights: Mapping[str, torch.Tensor], *, device,
                 dtype: torch.dtype | None) -> nn.Module:
    """``cls(cfg)`` on ``device`` in ``dtype`` (default f32), its parameters
    filled from the HF ``weights`` by ``cls.hf_mapping(cfg)``."""
    model = cls(cfg, device=device, dtype=dtype or torch.float32)
    apply_mapping(model, weights, cls.hf_mapping(cfg))
    return model


#: JAX leaf name -> port leaf name (nnx.Linear/Conv ``kernel``, LayerNorm
#: ``scale``, nnx.Embed ``embedding`` all become torch's ``weight``)
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _port_entries(key: str, arr: np.ndarray, *, quantized: bool = False,
                  orders: Mapping[str, np.ndarray] | None = None
                  ) -> list[tuple[str, np.ndarray]]:
    """One JAX parameter -> the port (name, array) pairs it fills.
    ``quantized``: the key belongs to a JAX ``QuantLinear``, whose int8
    ``w_q`` (..., in, out) becomes the port's (..., out, in) buffer and
    whose ``scale`` and ``bias`` keep their names. ``orders``: for an
    encoder (by its path, e.g. ``vision.encoder``) whose JAX stack is
    stored in circular pipeline order, the layer each row holds."""
    parts = key.split(".")
    leaf = parts[-1]
    if leaf == "kernel" or (quantized and leaf == "w_q"):
        # Conv HWIO (p, p, C, W) -> OIHW; Linear (..., in, out) -> (..., out, in)
        arr = (arr.transpose(3, 2, 0, 1) if parts[-2] == "conv"
               else np.swapaxes(arr, -1, -2))
    name = parts[:-1] + [leaf if quantized else _LEAF.get(leaf, leaf)]
    if "blocks" not in parts:
        return [(".".join(name), arr)]
    # stacked (layers, ...) -> one entry per layer module
    i = parts.index("blocks") + 1
    order = (orders or {}).get(".".join(parts[:i - 1]))
    return [(".".join(name[:i] + [str(layer if order is None
                                      else order[layer])] + name[i:]),
             arr[layer]) for layer in range(arr.shape[0])]


@torch.no_grad()
def load_jax_params(model: nn.Module,
                    params: Mapping[str, np.ndarray]) -> None:
    """Fill ``model`` from the JAX model's parameters, given as numpy arrays
    keyed by their dotted nnx paths (e.g.
    ``vision.encoder.blocks.attn.q.kernel`` of shape (depth, in, out)).

    A model quantized by ``jimm_tpu_torch.quant.quantize_model`` takes the
    parameters of a JAX model quantized by ``jimm_tpu.quant``: each JAX
    ``QuantLinear``'s int8 ``w_q`` (depth, in, out), f32 ``scale`` (depth,
    out) and ``bias`` fill the port's ``w_q`` and ``scale`` buffers and its
    bias, per layer, the int8 values copied as they are.

    A model under ``apply_precision_policy(model, "fp8_hybrid")`` takes the
    parameters of a JAX model under the same policy together with its amax
    histories: each JAX ``Fp8Linear``'s ``x_amax`` and ``w_amax`` ((depth,
    16) under the stacked blocks) fill the port's per-layer buffers.

    A pipelined encoder configured with ``pp_virtual > 1`` and
    ``pp_stages`` takes a JAX model of the same configuration, whose
    stacked layers are stored in circular order
    (``pipeline.circular_layer_order``): each row goes to the block of the
    layer it holds, and the port's blocks stay in their natural order.

    Strict: every port parameter, quantized-weight buffer and amax history
    must be filled exactly once and every key used, with matching shapes;
    anything else raises."""
    from jimm_tpu_torch.nn.transformer import Transformer
    from jimm_tpu_torch.parallel.pipeline import circular_layer_order
    orders = {}
    for prefix, module in model.named_modules():
        cfg = getattr(module, "cfg", None)
        if (isinstance(module, Transformer) and cfg.pipeline
                and cfg.pp_virtual > 1 and cfg.pp_stages):
            orders[prefix] = circular_layer_order(cfg.depth, cfg.pp_stages,
                                                  cfg.pp_virtual)
    own = dict(model.named_parameters())
    quant_parents = set()  # the JAX (stacked) paths of the QuantLinears
    for prefix, module in model.named_modules():
        if isinstance(module, QuantLinear):
            own[f"{prefix}.w_q"] = module.w_q
            own[f"{prefix}.scale"] = module.scale
            parts = prefix.split(".")
            if "blocks" in parts:
                del parts[parts.index("blocks") + 1]
            quant_parents.add(".".join(parts))
        elif isinstance(module, Fp8Linear):
            own[f"{prefix}.x_amax"] = module.x_amax
            own[f"{prefix}.w_amax"] = module.w_amax
    filled: set[str] = set()
    for key, value in params.items():
        value = np.asarray(value)
        if value.dtype != np.int8:
            value = value.astype(np.float32)
        quantized = key.rpartition(".")[0] in quant_parents
        for name, arr in _port_entries(key, value, quantized=quantized,
                                       orders=orders):
            if name not in own:
                raise KeyError(f"JAX parameter {key!r} has no port "
                               f"counterpart ({name!r})")
            if name in filled:
                raise KeyError(f"port parameter {name!r} filled twice")
            p = own[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{key!r} -> {name!r}: shape "
                                 f"{tuple(arr.shape)} != {tuple(p.shape)}")
            if (arr.dtype == np.int8) != (p.dtype == torch.int8):
                raise ValueError(f"{key!r} -> {name!r}: dtype {arr.dtype} "
                                 f"does not fill {p.dtype}")
            p.copy_(torch.from_numpy(np.array(arr)))  # a C-order copy
            filled.add(name)
    missing = sorted(set(own) - filled)
    if missing:
        raise KeyError(f"port parameters or buffers missing from the JAX "
                       f"params: {missing}")
