"""A resume from shards against the JAX package's: the JAX CLI's
crash-and-``--resume`` drill on the records loader (a tiny ViT-B/16 from
TFRecord shards, 6 steps, a save every step, ``crash@2``) and the port's
same drill, started from the JAX command's initial weights: in the resumed
steps 3-5 the batch fingerprints are equal (the shuffled example stream
skipped to the same place) and the losses agree at rtol 1e-5."""

import pytest

from jimm_tpu import cli as jax_cli
from jimm_tpu_torch import obs
from test_torch_data_train import (  # noqa: F401 (a fixture)
    CLASSES, LOSS_RTOL, jax_start, port_cli_from, read_metrics,
    same_native_library, write_classification_shards)

PRESET = "vit-base-patch16-224"
SEED = 11


def _argv(data, ckpt, metrics, *extra) -> list[str]:
    return ["train", "--preset", PRESET, "--tiny", "--batch-size", "4",
            "--steps", "6", "--log-every", "0", "--seed", str(SEED),
            "--data", str(data), "--shuffle-buffer", "10",
            "--batch-fingerprint", "--save-every", "1",
            "--ckpt-dir", str(ckpt), "--metrics-file", str(metrics), *extra]


def test_resumed_steps_match_the_jax_resume(tmp_path, monkeypatch,
                                            same_native_library):
    data = write_classification_shards(tmp_path / "cls", per_shard=11,
                                       seed=4)
    runs = {}
    main = port_cli_from(monkeypatch, jax_start(PRESET, SEED, len(CLASSES)),
                         PRESET)
    try:
        for name, run in (("jax", jax_cli.main), ("port", main)):
            device = [] if name == "jax" else ["--device", "cpu"]
            ckpt = tmp_path / f"{name}_ckpt"
            with pytest.raises(RuntimeError, match="failure at step 2"):
                run(_argv(data, ckpt, tmp_path / f"{name}_a.jsonl",
                          "--inject-faults", "crash@2", *device))
            assert run(_argv(data, ckpt, tmp_path / f"{name}_b.jsonl",
                             "--resume", *device)) == 0
            runs[name] = read_metrics(tmp_path / f"{name}_b.jsonl")
    finally:
        obs.reset_journal()
    assert sorted(runs["port"]) == sorted(runs["jax"]) == [3, 4, 5]
    for step in (3, 4, 5):
        assert runs["port"][step]["batch_fingerprint"] == \
            runs["jax"][step]["batch_fingerprint"], step
        assert runs["port"][step]["loss"] == pytest.approx(
            runs["jax"][step]["loss"], rel=LOSS_RTOL)
