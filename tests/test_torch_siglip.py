"""The port's SigLIP against the JAX package's, with the JAX model's weights
carried across by `jimm_tpu_torch.models.siglip.load_jax_params`. Both run
the flash and fused-LayerNorm paths (plain versions on the port's CPU side,
Pallas interpret mode on the JAX side)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import configs as jax_configs
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu_torch import configs
from jimm_tpu_torch.models.siglip import SigLIP, load_jax_params

# model-parity tolerance of the JAX suite (README "parity" section)
TOL = dict(atol=1e-4, rtol=1e-4)


def tiny_config(cfg_mod, **runtime):
    cfg = cfg_mod.SigLIPConfig(
        vision=cfg_mod.VisionConfig(
            image_size=64, patch_size=16, width=64, depth=2, num_heads=2,
            mlp_dim=128, act="gelu_tanh", ln_eps=1e-6, pooling="map"),
        text=cfg_mod.TextConfig(
            vocab_size=100, context_length=8, width=64, depth=2, num_heads=2,
            mlp_dim=128, act="gelu_tanh", ln_eps=1e-6, causal=False,
            pooling="last", proj_bias=True),
        projection_dim=64)
    return cfg_mod.with_runtime(cfg, attn_impl="flash", ln_impl="fused",
                                **runtime)


def jax_params(model) -> dict[str, np.ndarray]:
    """``nnx.state(model, nnx.Param)`` flattened to dotted paths -> numpy."""
    return {".".join(str(p) for p in path): np.asarray(var[...])
            for path, var in nnx.to_flat_state(nnx.state(model, nnx.Param))}


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0))
    params = jax_params(jmodel)
    tmodel = SigLIP(tiny_config(configs), device="cpu")
    load_jax_params(tmodel, params)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 64, 64, 3), np.float32)
    text = rng.integers(0, 100, (2, 8)).astype(np.int32)
    return jmodel, tmodel, params, images, text


@pytest.mark.parametrize("method", ["encode_image", "encode_text", "logits"])
def test_matches_jax(pair, method):
    jmodel, tmodel, _, images, text = pair
    ji, jt = jnp.asarray(images), jnp.asarray(text)
    ti, tt = torch.from_numpy(images), torch.from_numpy(text).long()
    with torch.no_grad():
        if method == "encode_image":
            want = nnx.jit(lambda m, x: m.encode_image(x))(jmodel, ji)
            got = tmodel.encode_image(ti)
        elif method == "encode_text":
            want = nnx.jit(lambda m, t: m.encode_text(t))(jmodel, jt)
            got = tmodel.encode_text(tt)
        else:
            want = nnx.jit(lambda m, x, t: m(x, t))(jmodel, ji, jt)
            got = tmodel(ti, tt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_qkv_matches_jax(pair):
    """fused_qkv hands strided q/k/v views to attention; same answer."""
    jmodel, _, params, images, _ = pair
    fused = SigLIP(tiny_config(configs, fused_qkv=True), device="cpu")
    load_jax_params(fused, params)
    with torch.no_grad():
        got = fused.encode_image(torch.from_numpy(images))
    want = nnx.jit(lambda m, x: m.encode_image(x))(jmodel, jnp.asarray(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_load_rejects_a_missing_key(pair):
    params = dict(pair[2])
    del params["vision.head.probe"]
    model = SigLIP(tiny_config(configs), device="cpu")
    with pytest.raises(KeyError, match="vision.head.probe"):
        load_jax_params(model, params)


def test_load_rejects_an_extra_key(pair):
    params = dict(pair[2], **{"vision.extra.kernel": np.zeros((2, 2))})
    model = SigLIP(tiny_config(configs), device="cpu")
    with pytest.raises(KeyError, match="vision.extra.kernel"):
        load_jax_params(model, params)


def test_load_rejects_a_wrong_shape(pair):
    params = dict(pair[2])
    params["text.pos_embed"] = np.zeros((9, 64), np.float32)
    model = SigLIP(tiny_config(configs), device="cpu")
    with pytest.raises(ValueError, match="text.pos_embed"):
        load_jax_params(model, params)


def test_load_rejects_a_deeper_stack(pair):
    params = dict(pair[2])
    key = "text.encoder.blocks.ln1.scale"
    params[key] = np.concatenate([params[key], params[key][:1]])
    model = SigLIP(tiny_config(configs), device="cpu")
    with pytest.raises(KeyError, match=key):
        load_jax_params(model, params)


@pytest.mark.parametrize("name", sorted(configs.PRESETS))
def test_presets_match_jax(name):
    assert (dataclasses.asdict(configs.preset(name))
            == dataclasses.asdict(jax_configs.preset(name)))


@pytest.mark.parametrize("cls", ["TransformerConfig", "VisionConfig",
                                 "TextConfig", "SigLIPConfig"])
def test_config_fields_match_jax(cls):
    def fields(mod):
        return [(f.name, f.default) for f in
                dataclasses.fields(getattr(mod, cls))]
    assert fields(configs) == fields(jax_configs)
    assert configs.RUNTIME_FIELDS == jax_configs.RUNTIME_FIELDS


def test_with_runtime_rejects_architecture_fields():
    cfg = configs.preset("siglip-base-patch16-256")
    with pytest.raises(ValueError, match="not runtime-overridable"):
        configs.with_runtime(cfg, width=32)
    out = configs.with_runtime(cfg, ln_impl="fused", text={"attn_impl": "xla"})
    assert out.vision.ln_impl == out.text.ln_impl == "fused"
    assert (out.vision.attn_impl, out.text.attn_impl) == ("auto", "xla")


@pytest.mark.parametrize("name,default", [("gelu_pytorch_tanh", "gelu"),
                                          ("gelu_new", "gelu"),
                                          ("quick_gelu", "gelu"),
                                          (None, "gelu_tanh")])
def test_normalize_act_matches_jax(name, default):
    assert (configs.normalize_act(name, default)
            == jax_configs.normalize_act(name, default))


def test_training_strategies_are_rejected():
    """Pipeline parallelism runs over a mesh's stage axis
    (tests/test_torch_parallel_pp.py); outside one, and with an attention
    mask, the pipelined encoder refuses with JAX's messages. Remat and
    dropout are ported (tests/test_torch_remat.py)."""
    cfg = configs.with_runtime(tiny_config(configs), pipeline=True)
    model = SigLIP(cfg, device="cpu")
    x = torch.zeros(2, cfg.vision.seq_len, cfg.vision.width)
    with pytest.raises(ValueError, match="pipeline=True needs an ambient "
                       "mesh with a 'stage' axis"):
        model.vision.encoder(x)
    with pytest.raises(ValueError, match="attention masks are not "
                       "supported on the pipelined path"):
        model.vision.encoder(x, mask=torch.ones(2, 1, 1, x.shape[1],
                                                dtype=torch.bool))
