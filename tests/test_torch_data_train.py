"""The port's ``train --data`` on the CPU: a tiny ViT-B/16 from TFRecord
shards with a classes.json of 3 classes, started from the JAX command's
initial weights, matches the JAX CLI's run of the same argv (losses at rtol
1e-5, ``tests/test_torch_resume_cli.py``'s tolerance for the classifier
step; batch fingerprints exactly), the JAX package's preprocessing given
the port's native library; the head's width comes from classes.json and
``run.json`` records it, so ``evaluate`` and ``export-run`` rebuild it; a
crash-and-``--resume`` run with ``--data`` gives, in its resumed steps,
the losses and fingerprints of the port's uninterrupted run for both
loaders: records through the skipped example stream, grain through the
``grain_state`` its checkpoints keep (and a preemption's grace save).

The helpers here (shards, the JAX start, the patched CLI) serve the other
``test_torch_data_*`` files."""

import base64
import json
import threading

import numpy as np
import pytest
from flax import nnx

from jimm_tpu import cli as jax_cli
from jimm_tpu import preset as jax_preset
from jimm_tpu.data import preprocess as jax_pre
from jimm_tpu_torch import cli, obs
from jimm_tpu_torch.data import grain_pipeline, native, records, webdataset
from jimm_tpu_torch.models.common import load_jax_params
from jimm_tpu_torch.models.vit import VisionTransformer
from test_torch_siglip import jax_params

#: the loss tolerance of the port's classifier step against JAX's
LOSS_RTOL = 1e-5
#: raw images larger than the tiny towers' 32 x 32, so every batch resizes
IMAGE_HW = (40, 48)
CLASSES = ["cat", "dog", "fish"]


def read_metrics(path) -> dict[int, dict]:
    """A metrics file's rows by step (a step logged twice: the later)."""
    with open(path) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def _image(rng, hw=IMAGE_HW):
    return rng.integers(0, 256, (*hw, 3), dtype=np.uint8)


def write_classification_shards(root, *, shards: int = 2, per_shard: int = 9,
                                 tar: bool = False, seed: int = 0):
    """``shards`` shards of labelled images (raw TFRecord, or PNG in tar)
    and a classes.json of :data:`CLASSES` beside them."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for s in range(shards):
        pairs = [(_image(rng), int(rng.integers(0, len(CLASSES))))
                 for _ in range(per_shard)]
        if tar:
            webdataset.write_wds_shard(
                root / f"part-{s}.tar",
                [{"image": im, "label": y} for im, y in pairs])
        else:
            records.write_classification_records(
                root / f"part-{s}.tfrecord", pairs, encoding="raw")
    (root / "classes.json").write_text(json.dumps(
        {name: i for i, name in enumerate(CLASSES)}))
    return root


def write_pair_shards(root, *, shards: int = 2, per_shard: int = 9,
                      seed: int = 0, sizes=(IMAGE_HW,)):
    """``shards`` TFRecord shards of raw image-text pairs, token ids in
    [4, 64) (the tiny text tower's vocabulary) of varying length, the
    images cycling through ``sizes``."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    k = 0
    for s in range(shards):
        pairs = []
        for _ in range(per_shard):
            tokens = rng.integers(4, 64, int(rng.integers(2, 11))).tolist()
            pairs.append((_image(rng, sizes[k % len(sizes)]), tokens))
            k += 1
        records.write_image_text_records(root / f"part-{s}.tfrecord", pairs,
                                         encoding="raw")
    return root


def jax_start(preset: str, seed: int, num_classes: int | None = None):
    """The tiny model the JAX ``train`` command of ``--preset preset
    --tiny --seed seed`` starts from, as numpy parameters."""
    import dataclasses
    cfg = jax_cli._tiny_override(jax_preset(preset))
    if num_classes:
        cfg = dataclasses.replace(cfg, num_classes=num_classes)
    fam = "vit" if preset.startswith("vit") else "siglip"
    return jax_params(jax_cli._model_cls(fam)(cfg, rngs=nnx.Rngs(seed)))


@pytest.fixture
def same_native_library(monkeypatch):
    """The JAX package's preprocessing on the port's native library (the
    same ``native/`` sources), so both packages decode and resize to the
    same bits."""
    monkeypatch.setattr(jax_pre, "_LIB", native.load())


def port_cli_from(monkeypatch, weights: dict, preset: str):
    """The port's CLI with the tiny ``preset`` run started from ``weights``
    (the two packages seed differently)."""
    real = cli.build_run_model

    def from_jax(spec, *a, **kw):
        model, fresh = real(spec, *a, **kw)
        if spec["tiny"] and spec["preset"] == preset:
            load_jax_params(model, weights)
        return model, fresh

    monkeypatch.setattr(cli, "build_run_model", from_jax)
    monkeypatch.delenv("JIMM_JOURNAL", raising=False)
    obs.reset_journal()
    return cli.main


def assert_matches_jax(port: dict, jax: dict, steps: int, rtol: float):
    assert sorted(port) == sorted(jax) == list(range(steps))
    for step in range(steps):
        np.testing.assert_allclose(port[step]["loss"], jax[step]["loss"],
                                   rtol=rtol, err_msg=f"step {step}")
        assert port[step]["batch_fingerprint"] == \
            jax[step]["batch_fingerprint"], step


def assert_same_run(got: dict, control: dict, steps) -> None:
    assert sorted(got) == list(steps)
    for step in steps:
        assert got[step]["loss"] == control[step]["loss"], step
        assert got[step]["batch_fingerprint"] == \
            control[step]["batch_fingerprint"], step


PRESET = "vit-base-patch16-224"
SEED = 7


def _argv(data, *extra) -> list[str]:
    return ["train", "--preset", PRESET, "--tiny", "--batch-size", "4",
            "--steps", "6", "--log-every", "0", "--seed", str(SEED),
            "--data", str(data), "--batch-fingerprint", *extra]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return write_classification_shards(tmp_path_factory.mktemp("cls"))


@pytest.fixture(scope="module")
def weights():
    return jax_start(PRESET, SEED, num_classes=len(CLASSES))


@pytest.fixture
def port_cli(monkeypatch, weights):
    yield port_cli_from(monkeypatch, weights, PRESET)
    obs.reset_journal()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, shards, weights):
    """The JAX command's run and the port's uninterrupted runs (records
    and grain loaders), each with checkpoints every step."""
    out = tmp_path_factory.mktemp("runs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pre, "_LIB", native.load())
        assert jax_cli.main(_argv(shards, "--metrics-file",
                                  str(out / "jax.jsonl"))) == 0
        main = port_cli_from(mp, weights, PRESET)
        for loader in ("records", "grain"):
            assert main(_argv(shards, "--loader", loader, "--device", "cpu",
                              "--save-every", "1",
                              "--ckpt-dir", str(out / loader),
                              "--metrics-file",
                              str(out / f"{loader}.jsonl"))) == 0
    obs.reset_journal()
    return {name: read_metrics(out / f"{name}.jsonl")
            for name in ("jax", "records", "grain")} | {"dir": out}


def test_records_run_matches_jax(runs):
    assert_matches_jax(runs["records"], runs["jax"], 6, LOSS_RTOL)


def test_head_width_from_classes_json(runs, shards, capsys):
    spec = json.loads((runs["dir"] / "records" / "run.json").read_text())
    assert spec["num_classes"] == len(CLASSES)
    # evaluate and export-run rebuild the 3-wide head from the record
    out = runs["dir"] / "export"
    assert cli.main(["export-run", str(out), "--ckpt-dir",
                     str(runs["dir"] / "records"), "--preset", PRESET,
                     "--device", "cpu"]) == 0
    exported = VisionTransformer.from_pretrained(out, device="cpu")
    assert exported.config.num_classes == len(CLASSES)
    assert exported.classifier.out_features == len(CLASSES)
    assert cli.main(["evaluate", "--data", str(shards), "--preset", PRESET,
                     "--ckpt-dir", str(runs["dir"] / "records"),
                     "--batch-size", "6", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["examples"] == 18 and "top1_accuracy" in line


def test_grain_loader_run_trains_every_record(runs):
    rows = runs["grain"]
    assert sorted(rows) == list(range(6))
    assert all(np.isfinite(r["loss"]) for r in rows.values())
    assert len({r["batch_fingerprint"] for r in rows.values()}) == 6
    extra = json.loads((runs["dir"] / "grain" / "5" / "extra.json")
                       .read_text())
    state = json.loads(base64.b64decode(extra["grain_state"]))
    # 6 batches of 4 taken from 18 records: position 24, epoch 1
    assert state["position"] == 24 and state["epoch"] == 1


@pytest.mark.parametrize("loader", ["records", "grain"])
def test_crash_and_resume_continue_the_stream(port_cli, runs, shards,
                                              tmp_path, monkeypatch, loader):
    ckpt = tmp_path / "ckpt"
    common = _argv(shards, "--loader", loader, "--device", "cpu",
                   "--save-every", "1", "--ckpt-dir", str(ckpt))
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        port_cli(common + ["--metrics-file", str(tmp_path / "a.jsonl"),
                           "--inject-faults", "crash@2"])
    assert_same_run(read_metrics(tmp_path / "a.jsonl"), runs[loader],
                    range(3))
    restored = []
    real = grain_pipeline.IndexedIterator.set_state
    monkeypatch.setattr(grain_pipeline.IndexedIterator, "set_state",
                        lambda it, state: restored.append(state)
                        or real(it, state))
    assert port_cli(common + ["--metrics-file", str(tmp_path / "b.jsonl"),
                              "--resume"]) == 0
    assert_same_run(read_metrics(tmp_path / "b.jsonl"), runs[loader],
                    range(3, 6))
    # grain jumps to the position its step-2 checkpoint recorded
    assert len(restored) == (loader == "grain")


def test_grain_preemption_grace_save_resumes_exactly(port_cli, runs, shards,
                                                     tmp_path):
    assert threading.current_thread() is threading.main_thread()
    ckpt = tmp_path / "ckpt"
    drilled = tmp_path / "drilled.jsonl"
    rc = port_cli(["supervise", "--max-restarts", "2", "--backoff-base-s",
                   "0.01", "--seed", "0", "--"]
                  + _argv(shards, "--loader", "grain", "--device", "cpu",
                          "--save-every", "50", "--ckpt-dir", str(ckpt),
                          "--metrics-file", str(drilled),
                          "--inject-faults", "preempt@2"))
    assert rc == 0
    with open(drilled) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [0, 1, 2, 3, 3, 4, 5]
    assert_same_run(read_metrics(drilled), runs["grain"], range(6))
    extra = json.loads((ckpt / "2" / "extra.json").read_text())
    assert "grain_state" in extra
