"""The port's int8 checkpoint quantization (``jimm_tpu_torch/weights/
quantize.py``) against the JAX package's: the same weights give the same
``model.safetensors`` bytes and the same ``config.json`` stamp,
re-quantizing gives the same bits, and the predicate keeps and skips the
same keys."""

import json

import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import configs as jax_configs
from jimm_tpu.cli import _tiny_override as jax_tiny_override
from jimm_tpu.models.clip import CLIP as JaxCLIP
from jimm_tpu.weights import quantize as jq
from jimm_tpu.weights.export import _layer_kwargs
from jimm_tpu.weights.export import to_hf_state_dict as jax_state
from jimm_tpu_torch import cli, configs, obs
from jimm_tpu_torch.models.clip import CLIP
from jimm_tpu_torch.models.common import load_jax_params
from jimm_tpu_torch.weights import quantize as tq
from jimm_tpu_torch.weights.export import to_hf_state_dict
from jimm_tpu_torch.weights.safetensors_io import load_file
from test_torch_siglip import jax_params

NAME = "clip-vit-base-patch16"


@pytest.fixture(scope="module")
def clips():
    """A tiny JAX CLIP and the port's, carrying its weights."""
    jmodel = JaxCLIP(jax_tiny_override(jax_configs.preset(NAME)),
                     rngs=nnx.Rngs(0))
    tmodel = CLIP(cli.tiny_override(configs.preset(NAME)), device="cpu")
    load_jax_params(tmodel, jax_params(jmodel))
    return jmodel, tmodel


@pytest.fixture(scope="module")
def saved(clips, tmp_path_factory):
    jmodel, tmodel = clips
    root = tmp_path_factory.mktemp("quantized")
    jq.save_quantized(jmodel, root / "jax")
    before = obs.get_registry("jimm_quant").counter(
        "tensors_quantized_total").value
    tq.save_quantized(tmodel, root / "port")
    after = obs.get_registry("jimm_quant").counter(
        "tensors_quantized_total").value
    return root, after - before


def test_save_quantized_writes_jax_bytes(saved):
    root, n_quantized = saved
    port = (root / "port" / "model.safetensors").read_bytes()
    assert port == (root / "jax" / "model.safetensors").read_bytes()
    jcfg = json.loads((root / "jax" / "config.json").read_text())
    tcfg = json.loads((root / "port" / "config.json").read_text())
    assert tcfg["jimm_quant"] == jcfg["jimm_quant"] == {
        "format": "int8-v1", "scheme": "symmetric-per-channel",
        "scale_suffix": ".scale_q8"}
    raw = load_file(root / "port" / "model.safetensors")
    assert n_quantized == sum(t.dtype == torch.int8 for t in raw.values())
    assert n_quantized > 0


def test_requantizing_gives_the_same_bits(saved):
    root, _ = saved
    raw = load_file(root / "port" / "model.safetensors")
    assert tq.is_quantized_state(raw)
    again = tq.quantize_state_dict(tq.dequantize_state_dict(raw))
    assert set(again) == set(raw)
    assert all(torch.equal(again[k], raw[k]) for k in raw)
    # and the dequantized state equals the JAX package's
    full = tq.load_dequantized(root / "port" / "model.safetensors")
    want = jq.load_dequantized(root / "jax" / "model.safetensors")
    assert set(full) == set(want) and not tq.is_quantized_state(full)
    for k, v in want.items():
        np.testing.assert_array_equal(full[k].numpy(), np.asarray(v))


def test_predicate_keeps_and_skips_the_same_keys(clips):
    jmodel, tmodel = clips
    tstate = to_hf_state_dict(tmodel, tmodel.hf_mapping(tmodel.config))
    jstate = jax_state(jmodel, jmodel.hf_mapping(jmodel.config),
                       **_layer_kwargs(jmodel))
    assert set(jstate) == set(tstate)
    kept = sorted(k for k, v in tstate.items() if tq.default_predicate(k, v))
    want = sorted(k for k, v in jstate.items() if jq.default_predicate(k, v))
    assert kept == want and 0 < len(kept) < len(tstate)
    mat = torch.ones(4, 4)
    for name, t in (("vision_model.mlp.fc1.weight", mat),
                    ("bias", torch.ones(4)), ("layer_norm.weight", mat),
                    ("embeddings.position_embedding.weight", mat),
                    ("logit_scale", mat),
                    ("k", torch.ones(4, 4, dtype=torch.int32)),
                    ("w", mat.bfloat16())):
        assert tq.default_predicate(name, t) == jq.default_predicate(
            name, t.float().numpy() if t.is_floating_point()
            else t.numpy()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_tensor_bits_match_jax(dtype):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((7, 3, 5)).astype(np.float32)
    w[2] = 0.0  # an all-zero channel: scale 1
    t = torch.from_numpy(w).to(dtype)
    q, s = tq.quantize_tensor(t)
    jqv, js = jq.quantize_tensor(t.float().numpy())
    np.testing.assert_array_equal(q.numpy(), jqv)
    np.testing.assert_array_equal(s.numpy(), js)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(tq.dequantize_tensor(q, s).numpy(),
                                  jq.dequantize_tensor(jqv, js))
    q2, s2 = tq.quantize_tensor(tq.dequantize_tensor(q, s))
    assert torch.equal(q2, q) and torch.equal(s2, s)
