"""Post-training symmetric per-output-channel int8 checkpoint quantization;
the counterpart of ``jimm_tpu/weights/quantize.py``.

The unit of work is the flat HF-keyed state dict of torch tensors, as
``weights/export.to_hf_state_dict`` makes it; the arithmetic runs in numpy,
as the reference's does, so both packages write the same bits.
:func:`save_quantized` rides ``weights/export.save_pretrained``'s
``state_hook``: the state is rewritten in flight, lands in
``model.safetensors`` through ``safetensors_io.save_file`` (``"I8"``
tensors), and reloads with plain ``safetensors_io.load_file``.

Scheme (the one the int8 matmul, kernel row 11, serves): symmetric,
zero-point-free, one f32 scale per output channel -- ``scale =
max|channel| / 127`` over every axis but the first (the HF/torch layout
puts ``out_features`` first). The max-abs element quantizes to exactly
+-127, so re-quantizing a dequantized tensor gives the same int8 bits and
the same scales. Scales are stored beside each int8 tensor under
``<name>.scale_q8``, a suffix no HF checkpoint uses.

Tensors that stay floating point: anything 0/1-D (norms, biases),
embeddings and positional tables (looked up, not multiplied), and the logit
scale and bias.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from jimm_tpu_torch.obs.registry import get_registry
from jimm_tpu_torch.obs.spans import span

__all__ = [
    "EXCLUDE_SUBSTRINGS", "QUANT_FORMAT", "SCALE_SUFFIX", "default_predicate",
    "dequantize_state_dict", "dequantize_tensor", "is_quantized_state",
    "load_dequantized", "quantize_state_dict", "quantize_tensor",
    "save_quantized",
]

#: suffix of the per-output-channel f32 scales stored beside each int8
#: tensor (bare ``.scale`` would collide with LayerNorm parameters)
SCALE_SUFFIX = ".scale_q8"

#: stamped into config.json by :func:`save_quantized`
QUANT_FORMAT = "int8-v1"

#: name substrings that keep their tensor floating point even when >= 2-D
EXCLUDE_SUBSTRINGS = ("embed", "position", "pos_", "norm", "ln_",
                      "logit_scale", "logit_bias")


def _f32(w: torch.Tensor) -> np.ndarray:
    """``w`` widened to an f32 numpy array (bf16 widens exactly)."""
    return w.detach().to("cpu", torch.float32).numpy()


def default_predicate(name: str, t: torch.Tensor) -> bool:
    """Should this state-dict tensor be quantized? Floating point, at least
    2-D (a matmul operand), and not on the exclude list."""
    if t.dim() < 2 or not t.is_floating_point():
        return False
    lname = name.lower()
    return not any(s in lname for s in EXCLUDE_SUBSTRINGS)


def quantize_tensor(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of one tensor.

    Channels are rows of the first axis. Returns ``(int8 tensor, f32
    scales shaped (w.shape[0],))`` on the CPU. All-zero channels get scale
    1.0 so dequantization stays finite."""
    wf = _f32(w)
    axes = tuple(range(1, wf.ndim))
    amax = np.max(np.abs(wf), axis=axes)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    bshape = (-1,) + (1,) * (wf.ndim - 1)
    q = np.clip(np.rint(wf / scale.reshape(bshape)), -127, 127)
    return torch.from_numpy(q.astype(np.int8)), torch.from_numpy(scale)


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_tensor`: ``q * scale`` per channel, in f32,
    then cast to ``dtype``."""
    bshape = (-1,) + (1,) * (q.dim() - 1)
    out = (q.detach().cpu().numpy().astype(np.float32)
           * _f32(scale).reshape(bshape))
    return torch.from_numpy(out).to(dtype)


def is_quantized_state(state: dict) -> bool:
    return any(name.endswith(SCALE_SUFFIX) for name in state)


def quantize_state_dict(state: dict[str, torch.Tensor], *,
                        predicate=None) -> dict[str, torch.Tensor]:
    """Rewrite a flat HF state dict: eligible tensors become int8 with a
    ``<name>.scale_q8`` f32 companion; everything else passes through.
    int8 tensors pass through untouched (re-quantizing a quantized state
    changes nothing). Bumps ``jimm_quant_tensors_quantized_total``."""
    pred = predicate or default_predicate
    out: dict[str, torch.Tensor] = {}
    n_quantized = 0
    with span("quantize_state"):
        for name, t in state.items():
            if name.endswith(SCALE_SUFFIX) or t.dtype == torch.int8:
                out[name] = t
                continue
            if pred(name, t):
                q, scale = quantize_tensor(t)
                out[name] = q
                out[name + SCALE_SUFFIX] = scale
                n_quantized += 1
            else:
                out[name] = t
    get_registry("jimm_quant").counter(
        "tensors_quantized_total").inc(n_quantized)
    return out


def dequantize_state_dict(state: dict[str, torch.Tensor], *,
                          dtype: torch.dtype = torch.float32
                          ) -> dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_state_dict`: int8 tensors with a stored
    scale come back as ``dtype``; the scale keys are consumed."""
    out: dict[str, torch.Tensor] = {}
    for name, t in state.items():
        if name.endswith(SCALE_SUFFIX):
            continue
        scale = state.get(name + SCALE_SUFFIX)
        if scale is not None and t.dtype == torch.int8:
            out[name] = dequantize_tensor(t, scale, dtype)
        else:
            out[name] = t
    return out


def save_quantized(model: torch.nn.Module, save_dir: str | os.PathLike, *,
                   predicate=None) -> None:
    """Export ``model`` as an int8-quantized HF-style checkpoint directory
    (``save_pretrained``'s state hook; config.json gains a ``jimm_quant``
    stanza, so the format describes itself)."""
    from jimm_tpu_torch.weights.export import save_pretrained

    def _hook(state):
        return quantize_state_dict(state, predicate=predicate)

    def _config(config):
        config = dict(config)
        config["jimm_quant"] = {"format": QUANT_FORMAT,
                                "scheme": "symmetric-per-channel",
                                "scale_suffix": SCALE_SUFFIX}
        return config

    save_pretrained(model, save_dir, state_hook=_hook, config_hook=_config)


def load_dequantized(path: str | os.PathLike, *,
                     dtype: torch.dtype = torch.float32
                     ) -> dict[str, torch.Tensor]:
    """Load a ``model.safetensors`` written by :func:`save_quantized` and
    return the dequantized state dict (ready for the standard loaders)."""
    from jimm_tpu_torch.weights.safetensors_io import load_file
    return dequantize_state_dict(load_file(path), dtype=dtype)
