"""The port's quantized paths on the CPU against the JAX package: int8 model
surgery (``quantize_model``: the same Linears, bit-identical int8 weights and
scales), a quantized JAX model carried across by ``load_jax_params``, the
int8 SigLIP forward and its HTTP serving, the ``int8_qk`` precision policy
and one f32 train step under it, and the ``serve --dtype int8`` and
``train --precision int8_qk`` commands."""

import json
import math
import pathlib
import subprocess
import sys
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import configs as jax_configs
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.nn.transformer import Attention as JaxAttention
from jimm_tpu.quant import quantize_model as jax_quantize_model
from jimm_tpu.quant.policy import apply_precision_policy as jax_policy
from jimm_tpu.train import trainer as jax_trainer
from jimm_tpu_torch import cli, configs
from jimm_tpu_torch.models.siglip import SigLIP, _port_entries, load_jax_params
from jimm_tpu_torch.nn.transformer import Attention
from jimm_tpu_torch.ops import flash_attention_int8 as fa8
from jimm_tpu_torch.ops import int8_matmul as mm
from jimm_tpu_torch.quant import QuantLinear, quantize_model
from jimm_tpu_torch.quant.policy import (POLICIES, Fp8Linear,
                                         apply_precision_policy)
from jimm_tpu_torch.serve.buckets import default_buckets
from jimm_tpu_torch.serve.engine import InferenceEngine, image_forward
from jimm_tpu_torch.serve.server import ServingServer
from jimm_tpu_torch.train import trainer
from test_torch_siglip import jax_params, tiny_config
from test_torch_train import _port_arrays

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
#: quantization is discontinuous: a one-ulp difference in a Linear's input
#: (the two packages sum their f32 matmuls in different orders) can move
#: one int8 activation by one step. In this tiny model such a flip moves an
#: image's features to cosine ~0.99995 and its norm by ~2e-3, where the
#: images without one agree to f32 rounding, and int8 itself is ~0.9998 and
#: ~4e-3 off the f32 model. So the int8 model is held to a per-image cosine
#: of 0.9999 and norms within 1% (the served-feature bound of chip_smoke.py),
#: which a flip passes and a wrong scale, layout or rounding rule, which
#: moves every image, does not.
INT8_MIN_COS = 0.9999
INT8_NORM_RTOL = 1e-2


def _quant_paths_jax(params: dict[str, np.ndarray]) -> set[str]:
    """The unstacked port names of the JAX model's QuantLinear weights."""
    return {name for key, arr in params.items() if key.endswith(".w_q")
            for name, _ in _port_entries(key, arr, quantized=True)}


def _quant_paths(model: torch.nn.Module) -> set[str]:
    return {f"{name}.w_q" for name, m in model.named_modules()
            if isinstance(m, QuantLinear)}


@pytest.fixture(scope="module")
def quantized():
    """A tiny JAX SigLIP and its quantized twin's parameters, and the port
    model loaded from the f32 parameters, then quantized."""
    jmodel = JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0))
    params_f32 = jax_params(jmodel)
    n_jax = jax_quantize_model(jmodel)
    model = SigLIP(tiny_config(configs), device="cpu")
    load_jax_params(model, params_f32)
    n = quantize_model(model)
    return dict(jmodel=jmodel, params_f32=params_f32,
                params_q=jax_params(jmodel), n_jax=n_jax, model=model, n=n)


def test_quantize_model_takes_the_same_linears(quantized):
    """The port counts per-layer modules (2 + 2 layers x 6, the MAP head's 6,
    the text projection: 19 Linears of 6 + 6 + 6 + 1 roles), the JAX package
    stacked roles; the sets of unstacked weights agree."""
    model = quantized["model"]
    assert quantized["n"] == 31 and quantized["n_jax"] == 19
    assert _quant_paths(model) == _quant_paths_jax(quantized["params_q"])
    assert not any(isinstance(m, torch.nn.Linear) for m in model.modules())
    # the conv patch embed, the embeddings and the norms stay as they were
    assert isinstance(model.vision.patch_embed.conv, torch.nn.Conv2d)
    assert model.text.token_embed.weight.dtype == torch.float32


def test_quantized_weights_are_bit_identical(quantized):
    own = dict(quantized["model"].named_buffers())
    checked = 0
    for key, arr in quantized["params_q"].items():
        leaf = key.rpartition(".")[2]
        if leaf not in ("w_q", "scale") or key.rpartition(".")[0] + ".w_q" \
                not in quantized["params_q"]:
            continue
        for name, want in _port_entries(key, arr, quantized=True):
            got = own[name]
            assert got.dtype == (torch.int8 if leaf == "w_q"
                                 else torch.float32)
            np.testing.assert_array_equal(
                got.numpy().view(np.uint8 if leaf == "w_q" else np.uint32),
                np.ascontiguousarray(want).view(
                    np.uint8 if leaf == "w_q" else np.uint32), err_msg=name)
            checked += 1
    assert checked == 2 * 31


def test_quant_weights_are_buffers_not_parameters(quantized):
    model = quantized["model"]
    params = dict(model.named_parameters())
    assert not any(p.dtype == torch.int8 for p in params.values())
    assert not any(name.endswith((".w_q", ".scale")) for name in params)
    assert next(model.parameters()).dtype == torch.float32
    lin = model.vision.encoder.blocks[0].mlp.fc1
    assert isinstance(lin.bias, torch.nn.Parameter)
    assert lin.bias.dtype == torch.float32 and lin.dtype == torch.float32
    assert "w_q" in dict(lin.named_buffers())


def test_fused_qkv_skips_q_k_v():
    jmodel = JaxSigLIP(tiny_config(jax_configs, fused_qkv=True),
                       rngs=nnx.Rngs(0))
    params = jax_params(jmodel)
    jax_quantize_model(jmodel)
    model = SigLIP(tiny_config(configs, fused_qkv=True), device="cpu")
    load_jax_params(model, params)
    n = quantize_model(model)
    block = model.vision.encoder.blocks[0].attn
    assert all(isinstance(getattr(block, r), torch.nn.Linear)
               for r in "qkv")
    assert isinstance(block.out, QuantLinear)
    # 4 blocks x 3 (out, fc1, fc2), the unfused MAP head's 6, the projection
    assert n == 19
    assert _quant_paths(model) == _quant_paths_jax(jax_params(jmodel))
    with torch.no_grad():
        model.encode_image(torch.zeros(1, 64, 64, 3))


@pytest.fixture(scope="module")
def carried(quantized):
    """The quantized JAX model's parameters loaded into a quantized port
    model, and one batch of images."""
    model = SigLIP(tiny_config(configs), device="cpu")
    quantize_model(model)
    load_jax_params(model, quantized["params_q"])
    images = np.random.default_rng(2).standard_normal(
        (5, 64, 64, 3)).astype(np.float32)
    return model, images


def test_load_jax_params_carries_the_quantized_model(quantized, carried):
    model, _ = carried
    for name, buf in model.named_buffers():
        np.testing.assert_array_equal(
            buf.numpy(), dict(quantized["model"].named_buffers())[name],
            err_msg=name)
    params = dict(quantized["params_q"])
    key = "vision.encoder.blocks.mlp.fc1.w_q"
    assert params[key].dtype == np.int8
    del params[key]
    with pytest.raises(KeyError, match="fc1.w_q"):
        load_jax_params(model, params)
    # f32 weights do not fill a quantized model, nor int8 ones a plain one
    with pytest.raises(KeyError):
        load_jax_params(model, quantized["params_f32"])
    with pytest.raises((KeyError, ValueError)):
        load_jax_params(SigLIP(tiny_config(configs), device="cpu"),
                        quantized["params_q"])


def _check_int8_features(got: np.ndarray, want: np.ndarray) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    norm, want_norm = np.linalg.norm(got, axis=1), np.linalg.norm(want,
                                                                  axis=1)
    cos = (got * want).sum(1) / (norm * want_norm)
    assert (cos >= INT8_MIN_COS).all(), cos
    assert (np.abs(norm / want_norm - 1) <= INT8_NORM_RTOL).all()


def test_int8_encode_image_matches_jax(quantized, carried):
    model, images = carried
    want = nnx.jit(lambda m, x: m.encode_image(x))(quantized["jmodel"],
                                                   jnp.asarray(images))
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(images))
    assert got.dtype == torch.float32
    _check_int8_features(got.numpy(), np.asarray(want))
    assert mm.launches == 0


def test_int8_served_over_http_matches_jax(quantized, carried):
    model, images = carried
    want = np.asarray(nnx.jit(lambda m, x: m.encode_image(x))(
        quantized["jmodel"], jnp.asarray(images)))
    engine = InferenceEngine(image_forward(model), item_shape=(64, 64, 3),
                             buckets=default_buckets("cpu"), max_delay_ms=20)
    server = ServingServer(engine, port=0)
    server.start()
    try:
        got = [_post(server.port, {"image": img.tolist()})["features"]
               for img in images[:3]]
    finally:
        server.stop()
    _check_int8_features(np.asarray(got), want[:3])


def _post(port: int, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/embed", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_int8_qk_policy_flips_every_attention():
    model = SigLIP(tiny_config(configs), device="cpu")
    attns = [m for m in model.modules() if isinstance(m, Attention)]
    assert apply_precision_policy(model, "int8_qk") == len(attns) == 5
    assert all(m.impl == "flash_int8" for m in attns)
    assert model.vision.head.attn.impl == "flash_int8"  # the MAP probe
    jmodel = JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0))
    # the JAX package counts its stacked encoders' Attention once each
    assert jax_policy(jmodel, "int8_qk") == 3
    assert all(m.impl == "flash_int8" for _, m in jmodel.iter_modules()
               if isinstance(m, JaxAttention))


def test_precision_policy_refusals():
    """An unknown policy is refused before any surgery; bf16 is the
    identity; fp8_hybrid swaps Linears and leaves attention as it was."""
    model = SigLIP(tiny_config(configs), device="cpu")
    assert POLICIES == ("bf16", "fp8_hybrid", "int8_qk")
    assert apply_precision_policy(model, "bf16") == 0
    with pytest.raises(ValueError, match="unknown precision policy"):
        apply_precision_policy(model, "int4")
    assert not any(isinstance(m, Fp8Linear) for m in model.modules())
    # 2 + 2 blocks x 6 Linears, the MAP head's 6 and text_projection
    assert apply_precision_policy(model, "fp8_hybrid") == 31
    assert all(m.impl == "flash" for m in model.modules()
               if isinstance(m, Attention))


@pytest.fixture(scope="module")
def int8_qk_step():
    """One f32 step under int8_qk in both packages from the same weights and
    batch: the loss, the gradients, and the loss after one AdamW update."""
    jmodel = JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0))
    params0 = jax_params(jmodel)
    jax_policy(jmodel, "int8_qk")
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 64, 64, 3), np.float32)
    text = rng.integers(0, 100, (4, 8)).astype(np.int32)
    ji, jt = jnp.asarray(images), jnp.asarray(text)
    jloss, jgrads = nnx.jit(nnx.value_and_grad(
        lambda m, a, b: jax_trainer.contrastive_loss_fn(
            m, a, b, kind="siglip")))(jmodel, ji, jt)
    jgrads = {".".join(str(p) for p in path): np.asarray(v[...])
              for path, v in nnx.to_flat_state(jgrads)}
    opt_kw = dict(learning_rate=1e-3, weight_decay=1e-4)
    jopt = jax_trainer.make_optimizer(jmodel, jax_trainer.OptimizerConfig(
        **opt_kw))
    jstep = jax_trainer.make_contrastive_train_step("siglip")
    jlosses = [float(jstep(jmodel, jopt, ji, jt)["loss"]) for _ in range(2)]

    model = SigLIP(tiny_config(configs), device="cpu")
    load_jax_params(model, params0)
    apply_precision_policy(model, "int8_qk")
    ti, tt = torch.from_numpy(images), torch.from_numpy(text).long()
    loss = trainer.contrastive_loss_fn(model, ti, tt, kind="siglip")
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    opt = trainer.make_optimizer(model, trainer.OptimizerConfig(**opt_kw))
    step = trainer.make_contrastive_train_step("siglip")
    losses = [step(model, opt, ti, tt)["loss"].item() for _ in range(2)]
    return dict(jloss=float(jloss), loss=loss.item(),
                jgrads=_port_arrays(jgrads), grads=grads, jlosses=jlosses,
                losses=losses)


def test_int8_qk_step_loss_matches_jax(int8_qk_step):
    r = int8_qk_step
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-5)
    np.testing.assert_allclose(r["losses"], r["jlosses"], rtol=1e-5)


def test_int8_qk_step_grads_match_jax(int8_qk_step):
    """The tolerances of tests/test_torch_train.py's first-step gradients."""
    r = int8_qk_step
    assert set(r["grads"]) == set(r["jgrads"])
    for name, got in r["grads"].items():
        np.testing.assert_allclose(got.numpy(), r["jgrads"][name],
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def _run(*argv: str, timeout: int = 300) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "jimm_tpu_torch", *argv],
                          cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_train_cli_int8_qk_on_the_cpu():
    proc = _run("train", "--tiny", "--device", "cpu", "--steps", "2",
                "--batch-size", "4", "--log-every", "1", "--precision",
                "int8_qk", "--ln-impl", "fused")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    assert [r["step"] for r in lines if "step" in r] == [0, 1]
    assert all(math.isfinite(r["loss"]) for r in lines if "step" in r)
    summary = lines[-1]
    assert summary["status"] == "trained" and summary["device"] == "cpu"
    # 4 + 4 encoder blocks and the MAP probe of the tiny towers
    assert summary["precision"] == "int8_qk"
    assert summary["precision_modules"] == 9


@pytest.mark.parametrize("argv,reason", [
    (["--attn-impl", "flash_masked"], "needs --naflex"),
    (["--precision", "int8_qk", "--naflex"], "no mask/bias plumbing"),
    (["--attn-impl", "flash_int8", "--naflex"], "no mask/bias plumbing")])
def test_train_cli_refuses_what_has_no_kernel(argv, reason):
    args = cli.build_parser().parse_args(["train", "--tiny", "--device",
                                          "cpu", *argv])
    with pytest.raises(SystemExit, match=reason):
        cli.cmd_train(args)


def test_serve_cli_int8_round_trip():
    """``serve --dtype int8 --tiny --device cpu`` answers /v1/embed with
    the features of the model `cli.serving_model` makes (seeded weights)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "jimm_tpu_torch", "serve", "--tiny",
         "--device", "cpu", "--dtype", "int8", "--port", "0",
         "--max-seconds", "120"], cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["status"] == "serving" and ready["dtype"] == "int8"
        assert ready["quantized_layers"] == 55  # 4 + 4 blocks x 6, head 6, 1
        image = np.random.default_rng(3).uniform(
            -1, 1, (32, 32, 3)).astype(np.float32)
        got = _post(ready["port"], {"image": image.tolist()})["features"]
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    cfg = cli.tiny_override(configs.preset("siglip-base-patch16-256"))
    model, n = cli.serving_model(cfg, "int8", "cpu")
    assert n == 55
    with torch.no_grad():
        want = model.encode_image(torch.from_numpy(image)[None])[0]
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=1e-5)
    assert fa8.launches == 0
