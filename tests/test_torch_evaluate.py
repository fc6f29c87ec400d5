"""The port's ``evaluate`` on the CPU (``--device cpu``) against the JAX
package's (``jimm_tpu.cli.main``) on the same checkpoints (the tiny ones of
``test_torch_classify.py``) and raw-encoded shards: ViT top-1, CLIP and
SigLIP retrieval, CLIP ``--zero-shot``, SigLIP2 ``--naflex``, each with a
short last batch. The same JSON line; the logits batch by batch within
1e-4 of JAX's from the JAX package's own readers; a metric may differ
only by examples whose JAX top-1/top-2 margin is under 2e-4 (each such
example is named in the failure message). Refusals carry JAX's messages
(a training run's, ``--preset --ckpt-dir``, in
``test_torch_resume_cli.py``)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from jimm_tpu import cli as jax_cli
from jimm_tpu.data import records as jax_records
from jimm_tpu.models.clip import CLIP as JaxCLIP
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.models.vit import VisionTransformer as JaxViT
from jimm_tpu.utils.zero_shot import (weights_from_rows as jax_weights,
                                      zero_shot_logits_from_features as
                                      jax_logits_from_features)
from jimm_tpu_torch import cli
from jimm_tpu_torch.data import records
from test_torch_classify import CLIP_EOT, TOL, _tokens_file, ckpts  # noqa: F401

#: an example whose JAX logits' top-1/top-2 margin is under this may take
#: the other class in the port (each side within 1e-4)
MARGIN = 2e-4


def _images(rng, sizes):
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Raw-encoded shards: 10 labeled 16 x 16 images (batch 4 leaves 2),
    with a classes.json; 6 image-text pairs; 4 NaFlex pairs of mixed
    aspect; and a zero-shot token table in another order than
    classes.json, ragged."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(8)
    out = {k: root / k for k in ("cls", "pairs", "naflex", "empty")}
    for p in out.values():
        p.mkdir()
    records.write_classification_records(
        out["cls"] / "part-00000.tfrecord",
        [(im, i % 3) for i, im in enumerate(_images(rng, [(16, 16)] * 10))],
        encoding="raw")
    (out["cls"] / "classes.json").write_text(json.dumps(["ant", "bee",
                                                         "fly"]))
    records.write_image_text_records(
        out["pairs"] / "part-00000.tfrecord",
        [(im, [i + 1, i + 2, 60 - i]) for i, im in
         enumerate(_images(rng, [(16, 16), (20, 12)] * 3))], encoding="raw")
    records.write_image_text_records(
        out["naflex"] / "part-00000.tfrecord",
        [(im, [i + 1, i + 2]) for i, im in enumerate(_images(
            rng, [(16, 48), (32, 32), (48, 16), (16, 32)]))], encoding="raw")
    records.write_classification_records(out["empty"] / "e.tfrecord", [],
                                         encoding="raw")
    out["tokens"] = root / "tokens.json"
    out["tokens"].write_text(json.dumps({
        "fly": [[5, 6, CLIP_EOT], [7, 8, CLIP_EOT]], "ant": [1, 2, CLIP_EOT],
        "bee": [[3, 4, CLIP_EOT]]}))
    return out


EVAL_CASES = {
    "vit_top1": ("vit", "cls", 4, []),
    "clip_retrieval": ("clip", "pairs", 4, []),
    "siglip_retrieval": ("siglip", "pairs", 4, []),
    "clip_zero_shot": ("clip", "cls", 4, ["--zero-shot", "tokens"]),
    "siglip2_naflex": ("siglip2", "naflex", 3, ["--naflex"]),
}


def _jax_pass(model, fam, case, data, batch):
    _, ds, _, extra = EVAL_CASES[case]
    cfg = model.config
    norm = jax_cli._norm_for(fam)
    once = dict(repeat=False, shuffle_buffer=0, drop_remainder=False)
    out = []
    if fam == "vit" or "--zero-shot" in extra:
        if "--zero-shot" in extra:
            table = json.loads(data["tokens"].read_text())
            labels = json.loads((data["cls"] / "classes.json").read_text())
            rows = [jax_records.pad_tokens(r, cfg.text.context_length)
                    for lab in labels for r in (
                        table[lab] if isinstance(table[lab][0], list)
                        else [table[lab]])]
            owner = [ci for ci, lab in enumerate(labels) for _ in (
                table[lab] if isinstance(table[lab][0], list)
                else [table[lab]])]
            weights = jax_weights(model, jnp.asarray(np.stack(rows)), owner,
                                  len(labels))
        for images, y in jax_records.classification_batches(
                str(data[ds]), batch, image_size=cfg.vision.image_size,
                **once, **(norm if fam != "vit" else {})):
            if fam == "vit":
                logits = model(jnp.asarray(images))
            else:
                logits = jax_logits_from_features(
                    model, model.encode_image(jnp.asarray(images)), weights)
            out.append((np.asarray(logits, np.float32), y))
        return out
    if "--naflex" in extra:
        batches = jax_records.naflex_image_text_batches(
            str(data[ds]), batch, patch_size=cfg.vision.patch_size,
            max_num_patches=cfg.vision.num_patches,
            seq_len=cfg.text.context_length, **once, **norm)
        for triple, tokens in batches:
            logits = model.logits_naflex(*(jnp.asarray(a) for a in triple),
                                         jnp.asarray(tokens))
            out.append((np.asarray(logits, np.float32),
                        np.arange(len(tokens))))
        return out
    for images, tokens in jax_records.image_text_batches(
            str(data[ds]), batch, image_size=cfg.vision.image_size,
            seq_len=cfg.text.context_length, **once, **norm):
        logits = model(jnp.asarray(images), jnp.asarray(tokens))
        out.append((np.asarray(logits, np.float32), np.arange(len(tokens))))
    return out


def _near_ties(batches, axis: int) -> list[tuple[int, int]]:
    """(batch, example) whose top-1/top-2 margin is under MARGIN."""
    near = []
    for b, (logits, _) in enumerate(batches):
        if logits.shape[axis] < 2:
            continue
        top = -np.sort(-logits, axis=axis)
        margin = (top[0] - top[1]) if axis == 0 else (top[:, 0] - top[:, 1])
        near += [(b, int(i)) for i in np.nonzero(margin < MARGIN)[0]]
    return near


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_evaluate_matches_jax(ckpts, datasets, capsys, case):
    kind, ds, batch, extra = EVAL_CASES[case]
    fam = "siglip" if kind == "siglip2" else kind
    extra = [str(datasets[e]) if e in datasets else e for e in extra]
    argv = ["evaluate", "--data", str(datasets[ds]), "--batch-size",
            str(batch), "--ckpt", str(ckpts[kind]), "--model", fam, *extra]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(argv + ["--platform", "cpu"]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(ours) == list(theirs)
    # the logits batch by batch, the short last batch included
    ev = cli.Evaluation(cli.build_parser().parse_args(argv + ["--device",
                                                              "cpu"]))
    got = list(ev.logits())
    model = {"vit": JaxViT, "clip": JaxCLIP, "siglip": JaxSigLIP}[
        fam].from_pretrained(str(ckpts[kind]))
    want = _jax_pass(model, fam, case, datasets, batch)
    assert [len(t) for _, t in got] == [len(t) for _, t in want]
    assert ours["examples"] == theirs["examples"] == sum(
        len(t) for _, t in want)
    for (g, gt), (w, wt) in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_array_equal(gt, wt)
    n = ours["examples"]
    axes = {"top1_accuracy": 1, "zero_shot_top1": 1,
            "retrieval_r1_image_to_text": 1, "retrieval_r1_text_to_image": 0}
    for key, value in theirs.items():
        if key not in axes:
            assert ours[key] == value, key
            continue
        near = _near_ties(want, axes[key])
        assert abs(ours[key] - value) * n <= len(near) + 1e-6, (
            f"{key}: {ours[key]} vs JAX {value}; examples under the "
            f"{MARGIN} margin (batch, index): {near}")


EVAL_REFUSALS = {
    "zero_shot_vit": ("vit", "cls", ["--zero-shot", "tokens"]),
    "naflex_vit": ("vit", "cls", ["--naflex"]),
    "naflex_zero_shot": ("siglip", "cls", ["--naflex", "--zero-shot",
                                           "tokens"]),
    "naflex_clip": ("clip", "pairs", ["--naflex"]),
    "naflex_tar": ("siglip", "tar", ["--naflex"]),
    "zero_shot_missing_class": ("clip", "cls", ["--zero-shot", "few"]),
    "zero_shot_overlong": ("clip", "cls", ["--zero-shot", "long"]),
    "no_examples": ("vit", "empty", []),
    "no_family": (None, "cls", []),
}


@pytest.mark.parametrize("case", list(EVAL_REFUSALS))
def test_evaluate_refusals_match_jax(ckpts, datasets, tmp_path, case):
    kind, ds, extra = EVAL_REFUSALS[case]
    files = {"tokens": datasets["tokens"],
             "few": _tokens_file(tmp_path / "few.json", {"ant": [1]}),
             "long": _tokens_file(tmp_path / "long.json", {
                 k: list(range(1, 20)) for k in ("ant", "bee", "fly")})}
    extra = [str(files[e]) if e in files else e for e in extra]
    data = (str(tmp_path / "x.tar") if ds == "tar" else str(datasets[ds]))
    argv = ["evaluate", "--data", data, "--ckpt",
            str(ckpts[kind or "vit"]), *(["--model", kind] if kind else []),
            *extra]
    with pytest.raises(SystemExit) as ours:
        cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        jax_cli.main(argv + ["--platform", "cpu"])
    assert str(ours.value) == str(theirs.value)
