"""The port's ``classify`` and ``/v1/classify`` on the CPU
(``--device cpu``) against the JAX package's (``jimm_tpu.cli.main``, its
``ZeroShotService``) on the same checkpoints, images and token tables: tiny
CLIP (the synthetic vocabulary of ``tests/conftest.py`` next to it), SigLIP,
SigLIP2 (NaFlex) and ViT checkpoints that the port writes, seeded, and both
packages load (``ckpts``, shared with ``test_torch_evaluate.py``). Scores
agree at 1e-4 in f32 (plus the 4-digit rounding of the printed lines);
refusals carry JAX's messages, and options that need parts the port does
not have cite their ROADMAP item."""

import dataclasses
import json
import shutil
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jimm_tpu import cli as jax_cli
from jimm_tpu.models.clip import CLIP as JaxCLIP
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.serve.server import ZeroShotService as JaxZeroShot
from jimm_tpu_torch import cli, configs
from jimm_tpu_torch.data import records

#: printed scores: 1e-4 agreement plus two roundings to 4 digits
PRINTED_TOL = 2e-4
TOL = dict(atol=1e-4, rtol=0)
CLIP_EOT = 525
PRESETS = {"clip": "clip-vit-base-patch16", "siglip": "siglip-base-patch16-256",
           "siglip2": "siglip2-base-patch16-256", "vit": "vit-base-patch16-224"}


def _config(kind: str):
    cfg = cli.tiny_override(configs.preset(PRESETS[kind]))
    if kind == "clip":  # the synthetic vocabulary's 526 ids, 16 positions
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, vocab_size=CLIP_EOT + 1, context_length=16))
    if kind == "vit":
        cfg = dataclasses.replace(cfg, num_classes=7)
    return cfg


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, clip_vocab_dir):
    root = tmp_path_factory.mktemp("ckpts")
    out = {}
    for kind in PRESETS:
        fam = "siglip" if kind == "siglip2" else kind
        g = torch.Generator().manual_seed(5)
        model = cli.MODELS[fam](_config(kind), device="cpu", generator=g)
        with torch.no_grad():
            if kind == "vit":  # the head is zero at init: draw it
                model.classifier.weight.normal_(0.0, 0.5, generator=g)
            if fam == "siglip":  # scores near 0.3, not sigmoid(-10)
                model.logit_bias.fill_(-1.0)
        out[kind] = root / kind
        model.save_pretrained(out[kind], **(
            {"flavor": "siglip2"} if kind == "siglip2" else {}))
    for name in ("vocab.json", "merges.txt"):
        shutil.copy(clip_vocab_dir / name, out["clip"] / name)
    return out


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("img") / "img.png"
    Image.fromarray(np.random.default_rng(6).integers(
        0, 256, (24, 40, 3), dtype=np.uint8)).save(p)
    return p


def _tokens_file(path, table) -> str:
    path.write_text(json.dumps(table))
    return str(path)


CLASSIFY_CASES = {
    "clip_tokens_file": ("clip", ["--tokens-file", {
        "cat": [1, 5, CLIP_EOT], "dog": [2, 6, 7, CLIP_EOT],
        "owl": [3, CLIP_EOT]}]),
    "clip_builtin_tokenizer": ("clip", ["--labels", "cat,the dog, of 42"]),
    "clip_template": ("clip", ["--labels", "cat,dog", "--template",
                               "itap of a {}."]),
    "clip_ensemble": ("clip", ["--labels", "cat,dog,phone", "--ensemble"]),
    "clip_ensemble_templates": ("clip", ["--labels", "cat,dog", "--ensemble",
                                         "--template", "a {}|the {} photo"]),
    "siglip_tokens_file": ("siglip", ["--tokens-file", {
        "ant": [1, 2], "bee": [3, 4, 5], "fly": [6]}]),
    "siglip2_naflex": ("siglip2", ["--tokens-file", {
        "ant": [1, 2], "bee": [3, 4, 5]}, "--naflex"]),
}


def _argv(kind, extra, ckpts, tmp_path):
    fam = "siglip" if kind == "siglip2" else kind
    extra = [_tokens_file(tmp_path / "tokens.json", e) if isinstance(e, dict)
             else e for e in extra]
    return ["--ckpt", str(ckpts[kind]), "--model", fam, *extra]


def _printed(out: str) -> dict[str, float]:
    lines = out.strip().splitlines()
    scores = [float(line.split()[0]) for line in lines]
    assert scores == sorted(scores, reverse=True)
    return {line.split(None, 1)[1]: s for line, s in zip(lines, scores)}


@pytest.mark.parametrize("case", list(CLASSIFY_CASES))
def test_classify_matches_jax(ckpts, image_file, tmp_path, capsys, case):
    kind, extra = CLASSIFY_CASES[case]
    argv = ["classify", str(image_file), *_argv(kind, extra, ckpts, tmp_path)]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    ours = _printed(capsys.readouterr().out)
    assert jax_cli.main(argv + ["--platform", "cpu"]) == 0
    theirs = _printed(capsys.readouterr().out)
    assert ours.keys() == theirs.keys()
    for label, score in ours.items():
        assert abs(score - theirs[label]) <= PRINTED_TOL, (label, ours, theirs)
    if kind == "clip":
        assert abs(sum(ours.values()) - 1.0) < 1e-3  # softmax over labels
    else:
        assert all(0.0 < s < 1.0 for s in ours.values())  # sigmoids


def test_classify_caches_the_class_weights(ckpts, image_file, tmp_path):
    """The text tower runs once per (checkpoint, label set): the second
    call finds the weights cached and scores the same."""
    args = cli.build_parser().parse_args(
        ["classify", str(image_file), "--device", "cpu", *_argv(
            "clip", ["--labels", "heron,stork"], ckpts, tmp_path)])
    image = records.decode_image(image_file.read_bytes())
    first, again = cli.classify_image(args, image), cli.classify_image(
        args, image)
    assert not first["cached"] and again["cached"]
    np.testing.assert_array_equal(first["scores"], again["scores"])
    assert first["labels"] == ["heron", "stork"]


CLASSIFY_REFUSALS = {
    "ensemble_with_tokens_file": ("clip", ["--tokens-file", {"a": [1]},
                                           "--ensemble"]),
    "no_labels": ("clip", []),
    "no_tokenizer": ("siglip", ["--labels", "ant,bee"]),
    "overlong_tokens": ("clip", ["--tokens-file", {"a": list(range(1, 40))}]),
    "naflex_clip": ("clip", ["--tokens-file", {"a": [1, CLIP_EOT]},
                             "--naflex"]),
}


@pytest.mark.parametrize("case", list(CLASSIFY_REFUSALS))
def test_classify_refusals_match_jax(ckpts, image_file, tmp_path, case):
    kind, extra = CLASSIFY_REFUSALS[case]
    argv = ["classify", str(image_file), *_argv(kind, extra, ckpts, tmp_path)]
    with pytest.raises(SystemExit) as ours:
        cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        jax_cli.main(argv + ["--platform", "cpu"])
    assert str(ours.value) == str(theirs.value)


def test_classify_refuses_index_citing_its_roadmap_item(ckpts, image_file):
    with pytest.raises(SystemExit, match="item 9 \\(retrieval\\)"):
        cli.main(["classify", str(image_file), "--ckpt", str(ckpts["clip"]),
                  "--labels", "a", "--index", "store", "--device", "cpu"])


# -- /v1/classify ----------------------------------------------------------

def _post(port: int, payload: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/classify",
        data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def server(ckpts):
    started = []

    def start(kind: str):
        srv, model, ready = cli.build_server(cli.build_parser().parse_args(
            ["serve", "--ckpt", str(ckpts[kind]), "--model", kind,
             "--device", "cpu", "--port", "0", "--buckets", "1,2"]))
        started.append(srv)
        return srv, model, ready

    yield start
    for srv in started:
        srv.stop()


@pytest.mark.parametrize("fam", ["clip", "siglip"])
def test_v1_classify_matches_jax(ckpts, server, fam):
    srv, model, ready = server(fam)
    assert ready["zero_shot"]
    eot = CLIP_EOT if fam == "clip" else 63
    table = {"ant": [[1, 2, eot], [3, eot]], "bee": [4, 5, 6, eot],
             "fly": [[7, eot]]}
    size = model.config.vision.image_size
    image = np.random.default_rng(7).uniform(-1, 1, (size, size, 3)).astype(
        np.float32)
    status, out = _post(srv.port, {"image": image.tolist(), "tokens": table})
    assert status == 200 and out["cached"] is False
    assert set(out) == {"scores", "cached"}
    status, again = _post(srv.port, {"image": image.tolist(),
                                     "tokens": table})
    assert again["cached"] is True and again["scores"] == out["scores"]
    jax_model = (JaxCLIP if fam == "clip" else JaxSigLIP).from_pretrained(
        str(ckpts[fam]))
    service = JaxZeroShot(jax_model, model_key="k")
    labels, weights, _ = service.class_weights_blocking(table)
    feats = np.asarray(jax_model.encode_image(jnp.asarray(image[None])))
    want = service.scores(feats[0], weights)
    assert list(out["scores"]) == labels
    np.testing.assert_allclose([out["scores"][k] for k in labels], want,
                               **TOL)


BAD_REQUESTS = {
    "no_tokens": ({}, "classify needs 'tokens': {label: [ids]}"),
    "empty_tokens": ({"tokens": {}},
                     "classify needs 'tokens': {label: [ids]}"),
    "tokens_not_a_table": ({"tokens": [[1, 2]]},
                           "classify needs 'tokens': {label: [ids]}"),
    "overlong_row": ({"tokens": {"cat": list(range(1, 20))}},
                     "tokens for 'cat' are 19 ids but context_length is 8; "
                     "re-tokenize to fit"),
}


@pytest.mark.parametrize("case", list(BAD_REQUESTS))
def test_v1_classify_bad_requests(ckpts, server, case):
    """400 with the JAX server's messages (jimm_tpu/serve/server.py:505-511,
    and ``token_table_rows``'s)."""
    srv, model, _ = server("siglip")
    payload, message = BAD_REQUESTS[case]
    size = model.config.vision.image_size
    status, out = _post(srv.port, {"image": np.zeros(
        (size, size, 3)).tolist(), **payload})
    assert status == 400
    assert out == {"error": "bad_request", "message": message}


def test_v1_classify_refused_without_a_text_tower(ckpts, server):
    srv, model, ready = server("vit")
    assert not ready["zero_shot"] and srv.zero_shot is None
    status, out = _post(srv.port, {"image": [[[0.0] * 3]],
                                   "tokens": {"a": [1]}})
    assert status == 400 and out["message"] == (
        "this server has no zero-shot service (started without a text "
        "tower)")
