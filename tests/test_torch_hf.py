"""HF checkpoints through both packages: one tiny ``tests/hf_util.py``
checkpoint per family (ViT with and without a head, CLIP, SigLIP, SigLIP2),
loaded by the JAX package's ``from_pretrained`` and the port's
(``device="cpu"``), give the same outputs at the JAX suite's tolerance
(``tests/test_vit.py:32``, ``test_clip.py:32``, ``test_siglip.py:54``).
Also: loading at another image size, ``.bin`` checkpoints, export in both
directions, the NaFlex refusal after a resampled position table,
``load_jax_params`` into ViT and CLIP, and ``serve --ckpt``."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from hf_util import (sample_image, sample_text, save_tiny_clip,
                     save_tiny_siglip, save_tiny_siglip2, save_tiny_vit)
from jimm_tpu import configs as jax_configs
from jimm_tpu.cli import _tiny_override as jax_tiny_override
from jimm_tpu.models.clip import CLIP as JaxCLIP
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.models.vit import VisionTransformer as JaxViT
from jimm_tpu.weights.safetensors_io import load_file as jax_load_file
from jimm_tpu.weights.safetensors_io import save_file as jax_save_file
from jimm_tpu_torch import cli, configs
from jimm_tpu_torch.models.clip import CLIP
from jimm_tpu_torch.models.common import load_jax_params
from jimm_tpu_torch.models.siglip import SigLIP
from jimm_tpu_torch.models.vit import VisionTransformer
from test_torch_siglip import jax_params

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=0)
#: case -> (JAX class, port class, image size, the outputs compared)
CASES = {
    "vit_head": (JaxViT, VisionTransformer, 48, ("logits",)),
    "vit_nohead": (JaxViT, VisionTransformer, 48, ("pooled",)),
    "clip": (JaxCLIP, CLIP, 32, ("encode_image", "encode_text", "logits")),
    "siglip": (JaxSigLIP, SigLIP, 32,
               ("encode_image", "encode_text", "logits")),
    "siglip2": (JaxSigLIP, SigLIP, 32,
                ("encode_image", "encode_text", "logits")),
}


def _drop_head(src: str, dst: pathlib.Path) -> str:
    """The ViT checkpoint without its classifier tensors."""
    dst.mkdir()
    weights = jax_load_file(os.path.join(src, "model.safetensors"))
    jax_save_file({k: v for k, v in weights.items()
                   if not k.startswith("classifier.")},
                  dst / "model.safetensors", metadata={"format": "pt"})
    (dst / "config.json").write_text(
        pathlib.Path(src, "config.json").read_text())
    return str(dst)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    vit = save_tiny_vit(root / "vit")
    return {"vit_head": vit,
            "vit_nohead": _drop_head(vit, root / "vit_nohead"),
            "clip": save_tiny_clip(root / "clip"),
            "siglip": save_tiny_siglip(root / "siglip"),
            "siglip2": save_tiny_siglip2(root / "siglip2")}


@pytest.fixture(scope="module")
def loaded(ckpts):
    """``loaded(case)`` -> (JAX model, port model) from the case's
    checkpoint, each package loading it once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            jcls, tcls, _, _ = CASES[case]
            cache[case] = (jcls.from_pretrained(ckpts[case]),
                           tcls.from_pretrained(ckpts[case], device="cpu"))
        return cache[case]

    return get


def _inputs(case: str):
    rng = np.random.RandomState(0)
    images = sample_image(rng, n=3, size=CASES[case][2])
    text = (sample_text(rng) if case == "clip"
            else rng.randint(1, 99, (2, 16)))
    return images, text


def _outputs(jmodel, tmodel, output: str, images, text):
    """(want, got) for one output of the pair."""
    ji, jt = jnp.asarray(images), jnp.asarray(text)
    ti, tt = torch.from_numpy(images), torch.from_numpy(text).long()
    with torch.no_grad():
        if output in ("logits", "pooled") and isinstance(tmodel,
                                                         VisionTransformer):
            return np.asarray(jmodel(ji)), tmodel(ti).numpy()
        if output == "encode_image":
            return (np.asarray(jmodel.encode_image(ji)),
                    tmodel.encode_image(ti).numpy())
        if output == "encode_text":
            return (np.asarray(jmodel.encode_text(jt)),
                    tmodel.encode_text(tt).numpy())
        return np.asarray(jmodel(ji, jt)), tmodel(ti, tt).numpy()


@pytest.mark.parametrize("case,output", [
    (case, output) for case, (_, _, _, outputs) in CASES.items()
    for output in outputs])
def test_checkpoint_outputs_match_jax(loaded, case, output):
    jmodel, tmodel = loaded(case)
    want, got = _outputs(jmodel, tmodel, output, *_inputs(case))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if case.startswith("vit"):
        has_head = case == "vit_head"
        assert tmodel.config.do_classification is has_head
        assert got.shape[-1] == (7 if has_head else 64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_round_trip_matches_jax(loaded, case):
    """The config read from a checkpoint equals JAX's field by field, and
    ``config_from_hf(hf_config())`` gives it back (CLIP's unset
    ``eos_token_id`` is written as 2, HF's legacy argmax pooling, which
    reads back as 2 in both packages)."""
    jmodel, tmodel = loaded(case)
    assert dataclasses.asdict(tmodel.config) == dataclasses.asdict(
        jmodel.config)
    assert tmodel.hf_config() == jmodel.hf_config()
    state = {k: v for k, v in tmodel.named_parameters()}
    hf_state = {m.src: state[m.dst] for m in tmodel.hf_mapping(tmodel.config)}
    again = type(tmodel).config_from_hf(tmodel.hf_config(), hf_state)
    assert again == tmodel.config


@pytest.mark.parametrize("cls", ["ViTConfig", "CLIPConfig"])
def test_config_fields_match_jax(cls):
    def fields(mod):
        return [(f.name, f.default) for f in
                dataclasses.fields(getattr(mod, cls))]
    assert fields(configs) == fields(jax_configs)
    assert (dataclasses.asdict(getattr(configs, cls)())
            == dataclasses.asdict(getattr(jax_configs, cls)()))


def test_fine_tune_at_a_new_image_size(ckpts):
    """``image_size=64`` resamples the 3x3 grid of a 48-pixel ViT to 4x4,
    the class token's position kept, as JAX's surgery does."""
    jmodel = JaxViT.from_pretrained(ckpts["vit_head"], image_size=64)
    tmodel = VisionTransformer.from_pretrained(ckpts["vit_head"],
                                               device="cpu", image_size=64)
    assert tmodel.config.vision.image_size == 64
    assert tuple(tmodel.vision.pos_embed.shape) == (1, 17, 64)
    np.testing.assert_allclose(
        tmodel.vision.pos_embed.detach().numpy(),
        np.asarray(jmodel.vision.pos_embed[...]), atol=1e-6, rtol=0)
    images = sample_image(np.random.RandomState(1), n=2, size=64)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel(jnp.asarray(images))),
                               **TOL)


@pytest.mark.parametrize("case", ["vit_head", "clip", "siglip"])
def test_bin_checkpoint_loads(loaded, ckpts, case, tmp_path):
    """A ``pytorch_model.bin`` written by transformers
    (``save_pretrained(..., safe_serialization=False)``) loads as the
    safetensors file does: found when it is the only format, and first with
    ``use_pytorch=True`` beside a safetensors file."""
    from transformers import AutoModel, ViTForImageClassification
    hf_cls = ViTForImageClassification if case == "vit_head" else AutoModel
    hf = hf_cls.from_pretrained(ckpts[case])
    hf.save_pretrained(tmp_path / "bin", safe_serialization=False)
    assert (tmp_path / "bin" / "pytorch_model.bin").is_file()
    assert not list((tmp_path / "bin").glob("*.safetensors"))
    jmodel, want_model = loaded(case)
    tcls = CASES[case][1]
    got_model = tcls.from_pretrained(tmp_path / "bin", device="cpu")
    for name, p in want_model.named_parameters():
        assert torch.equal(dict(got_model.named_parameters())[name], p), name
    # beside a safetensors file of other values, use_pytorch picks the .bin
    other = tmp_path / "both"
    tcls.from_pretrained(ckpts[case], device="cpu").save_pretrained(other)
    hf.save_pretrained(other, safe_serialization=False)
    preferred = tcls.from_pretrained(other, device="cpu", use_pytorch=True)
    images, text = _inputs(case)
    output = CASES[case][3][-1]
    want, got = _outputs(jmodel, preferred, output, images, text)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", ["vit_head", "vit_nohead", "clip", "siglip",
                                  "siglip2"])
def test_export_both_directions(loaded, case, tmp_path):
    """The port's ``save_pretrained`` read by JAX's ``from_pretrained``, and
    JAX's ``save_pretrained`` read by the port's: outputs allclose both
    ways, and the two exports hold the same tensors under the same names."""
    jmodel, tmodel = loaded(case)
    flavor = {"flavor": "siglip2"} if case == "siglip2" else {}
    tmodel.save_pretrained(tmp_path / "port", **flavor)
    jmodel.save_pretrained(tmp_path / "jax", **flavor)
    port_file = jax_load_file(tmp_path / "port" / "model.safetensors")
    jax_file = jax_load_file(tmp_path / "jax" / "model.safetensors")
    assert sorted(port_file) == sorted(jax_file)
    for key, arr in jax_file.items():
        np.testing.assert_array_equal(port_file[key], arr, err_msg=key)
    assert (json.loads((tmp_path / "port" / "config.json").read_text())
            == json.loads((tmp_path / "jax" / "config.json").read_text()))
    images, text = _inputs(case)
    j_from_port = type(jmodel).from_pretrained(str(tmp_path / "port"))
    t_from_jax = type(tmodel).from_pretrained(tmp_path / "jax", device="cpu")
    for output in CASES[case][3]:
        want, got = _outputs(j_from_port, tmodel, output, images, text)
        np.testing.assert_allclose(got, want, **TOL)
        want, got = _outputs(jmodel, t_from_jax, output, images, text)
        np.testing.assert_allclose(got, want, **TOL)


def test_siglip_flavors_and_resampled_table_refusal(loaded, ckpts, tmp_path):
    """A SigLIP2 origin exports as SigLIP2 by default; a position table
    resampled at load makes ``forward_naflex`` refuse, as JAX's does, while
    the native load runs it."""
    jmodel, tmodel = loaded("siglip2")
    assert tmodel._hf_source_flavor == "siglip2"
    assert not tmodel.vision._pos_table_resampled
    tmodel.save_pretrained(tmp_path / "default")
    config = json.loads((tmp_path / "default" / "config.json").read_text())
    assert config["model_type"] == "siglip2"
    assert config["vision_config"]["num_patches"] == 4
    with pytest.warns(UserWarning, match="Siglip2-origin"):
        tmodel.save_pretrained(tmp_path / "v1", flavor="siglip")
    with pytest.raises(ValueError, match="unknown export flavor"):
        tmodel.save_pretrained(tmp_path / "x", flavor="clip")
    patches = torch.zeros(1, 4, 16 * 16 * 3)
    shapes = torch.tensor([[2, 2]])
    mask = torch.ones(1, 4, dtype=torch.bool)
    with torch.no_grad():
        tmodel.encode_image_naflex(patches, shapes, mask)
    big = SigLIP.from_pretrained(ckpts["siglip2"], device="cpu",
                                 image_size=64)
    assert big.vision._pos_table_resampled
    with pytest.raises(ValueError, match="interpolated at load"):
        big.encode_image_naflex(patches, shapes, mask)


def _tiny(name: str, cfg_mod):
    cfg = cfg_mod.preset(name)
    return (cli.tiny_override(cfg) if cfg_mod is configs
            else jax_tiny_override(cfg))


@pytest.mark.parametrize("name", ["vit-base-patch16-224",
                                  "clip-vit-base-patch16"])
def test_load_jax_params_fills_vit_and_clip(name):
    """A JAX model built from a tiny preset, carried across by its names
    (``vision.cls_token``, ``vision.ln_pre``, ``classifier``,
    ``visual_projection``, ...): outputs allclose. The ViT head is drawn
    at random first (it starts at zero)."""
    jcfg, tcfg = _tiny(name, jax_configs), _tiny(name, configs)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3), np.float32)
    if name.startswith("vit"):
        jmodel = JaxViT(jcfg, rngs=nnx.Rngs(0))
        kernel = jmodel.classifier.kernel
        kernel[...] = jnp.asarray(
            rng.standard_normal(kernel[...].shape, np.float32))
        tmodel = VisionTransformer(tcfg, device="cpu")
        load_jax_params(tmodel, jax_params(jmodel))
        with torch.no_grad():
            got = tmodel(torch.from_numpy(images)).numpy()
        want = np.asarray(jmodel(jnp.asarray(images)))
        assert np.abs(want).max() > 1e-2
    else:
        jmodel = JaxCLIP(jcfg, rngs=nnx.Rngs(0))
        tmodel = CLIP(tcfg, device="cpu")
        load_jax_params(tmodel, jax_params(jmodel))
        text = rng.integers(1, 63, (3, 8))
        text[:, 5] = 63  # the EOT, the largest id
        with torch.no_grad():
            got = tmodel(torch.from_numpy(images),
                         torch.from_numpy(text)).numpy()
        want = np.asarray(jmodel(jnp.asarray(images), jnp.asarray(text)))
    np.testing.assert_allclose(got, want, **TOL)


def test_from_pretrained_defaults_to_the_card(ckpts):
    if torch.cuda.is_available():
        model = VisionTransformer.from_pretrained(ckpts["vit_head"])
        assert next(model.parameters()).device.type == "cuda"
    else:
        for cls, case in [(VisionTransformer, "vit_head"), (CLIP, "clip"),
                          (SigLIP, "siglip")]:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cls.from_pretrained(ckpts[case])
    model = CLIP.from_pretrained(ckpts["clip"], device="cpu",
                                 dtype=torch.bfloat16)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


def test_serve_cli_refusals():
    parser = cli.build_parser()
    with pytest.raises(SystemExit, match="--ckpt needs --model"):
        cli.build_server(parser.parse_args(["serve", "--ckpt", "x",
                                            "--device", "cpu"]))
    with pytest.raises(SystemExit, match="--tiny"):
        cli.build_server(parser.parse_args(["serve", "--ckpt", "x", "--model",
                                            "vit", "--tiny", "--device",
                                            "cpu"]))
    with pytest.raises(SystemExit):
        parser.parse_args(["train", "--preset", "vit-no-such-preset"])


def _post(port: int, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/embed", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("case", ["vit_head", "clip"])
def test_serve_ckpt_answers_embed(loaded, ckpts, case):
    """``serve --ckpt DIR --model vit|clip --device cpu`` answers one
    /v1/embed request with the JAX model's served output: ViT's logits,
    CLIP's ``encode_image``."""
    fam = case.split("_")[0]
    proc = subprocess.Popen(
        [sys.executable, "-m", "jimm_tpu_torch", "serve", "--ckpt",
         ckpts[case], "--model", fam, "--device", "cpu", "--port", "0",
         "--buckets", "1,2", "--max-seconds", "120"], cwd=REPO_ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["status"] == "serving"
        assert ready["model"] == f"{fam}:{ckpts[case]}"
        assert ready["buckets"] == [1, 2]
        images, _ = _inputs(case)
        got = _post(ready["port"], {"image": images[0].tolist()})["features"]
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    jmodel, _ = loaded(case)
    x = jnp.asarray(images[:1])
    want = jmodel(x) if fam == "vit" else jmodel.encode_image(x)
    np.testing.assert_allclose(got, np.asarray(want)[0], **TOL)
