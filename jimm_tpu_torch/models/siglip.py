"""SigLIP dual-tower model; the counterpart of ``jimm_tpu/models/siglip.py``,
at fixed resolution and on SigLIP2's NaFlex variable-resolution batches.
:func:`load_jax_params` carries the JAX model's parameters across (SigLIP2
has the same parameters, with a larger vocabulary); HF checkpoint IO is not
ported yet (ROADMAP.md)."""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from jimm_tpu_torch.configs import SigLIPConfig
from jimm_tpu_torch.nn.norm import FusedLayerNorm
from jimm_tpu_torch.nn.text import TextTower
from jimm_tpu_torch.nn.vision import VisionTower
from jimm_tpu_torch.quant import QuantLinear
from jimm_tpu_torch.quant.policy import Fp8Linear


def _resolve_device(device) -> torch.device:
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
def _init_params(model: "SigLIP", generator: torch.Generator) -> None:
    """The JAX package's initializers, drawn from ``generator``: xavier-uniform
    linear/conv/probe weights, zero biases, unit LayerNorm scales, normal
    embeddings (0.02) and text positions (0.01). The numbers differ from
    ``nnx.Rngs(0)``'s; tests carry JAX weights across instead."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            _xavier_(m.weight, m.in_features, m.out_features, generator)
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
    # probe (1, 1, W): JAX's xavier reads fan_in = 1, fan_out = W
    _xavier_(model.vision.head.probe, 1, model.config.vision.width, generator)
    model.vision.pos_embed.normal_(0.0, 0.02, generator=generator)
    model.text.pos_embed.normal_(0.0, 0.01, generator=generator)
    model.logit_scale.fill_(model.config.logit_scale_init)
    model.logit_bias.fill_(model.config.logit_bias_init)


class SigLIP(nn.Module):
    """SigLIP on ``device`` (default: the card) in ``dtype`` (parameters and
    compute), randomly initialised from ``generator`` (default: seed 0 on
    the model's device)."""

    def __init__(self, config: SigLIPConfig | None = None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = config or SigLIPConfig()
        dev = _resolve_device(device)
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
        _init_params(self, generator)

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
        return self.text_projection(self.text.pool(hidden, text))

    def _logits(self, img: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
        """L2-normalize, scale by exp(logit_scale), add logit_bias:
        logits_per_image (B_img, B_txt)."""
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return self.logit_scale.exp() * img @ txt.T + self.logit_bias

    def forward(self, images: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        return self._logits(self.encode_image(images), self.encode_text(text))


#: JAX leaf name -> port leaf name (nnx.Linear/Conv ``kernel``, LayerNorm
#: ``scale``, nnx.Embed ``embedding`` all become torch's ``weight``)
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _port_entries(key: str, arr: np.ndarray, *, quantized: bool = False
                  ) -> list[tuple[str, np.ndarray]]:
    """One JAX parameter -> the port (name, array) pairs it fills.
    ``quantized``: the key belongs to a JAX ``QuantLinear``, whose int8
    ``w_q`` (..., in, out) becomes the port's (..., out, in) buffer and
    whose ``scale`` and ``bias`` keep their names."""
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
    return [(".".join(name[:i] + [str(layer)] + name[i:]), arr[layer])
            for layer in range(arr.shape[0])]


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

    Strict: every port parameter, quantized-weight buffer and amax history
    must be filled exactly once and every key used, with matching shapes;
    anything else raises."""
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
        for name, arr in _port_entries(key, value, quantized=quantized):
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
