"""The port's ``train --data`` over WebDataset tar shards on the CPU: a
tiny ViT-B/16 from PNG-in-tar shards with a classes.json, started from the
JAX command's initial weights, matches the JAX CLI's run of the same argv
(losses at rtol 1e-5, batch fingerprints exactly) and takes its head's
width from the file; ``--loader grain`` refuses tar shards."""

import json

import pytest

from jimm_tpu import cli as jax_cli
from jimm_tpu_torch import cli, obs
from test_torch_data_train import (  # noqa: F401 (a fixture)
    CLASSES, LOSS_RTOL, assert_matches_jax, jax_start, port_cli_from,
    read_metrics, same_native_library, write_classification_shards)

PRESET = "vit-base-patch16-224"
SEED = 3


def _argv(data, *extra) -> list[str]:
    return ["train", "--preset", PRESET, "--tiny", "--batch-size", "4",
            "--steps", "5", "--log-every", "0", "--seed", str(SEED),
            "--data", str(data), "--shuffle-buffer", "6",
            "--batch-fingerprint", *extra]


@pytest.fixture(scope="module")
def tar_shards(tmp_path_factory):
    return write_classification_shards(tmp_path_factory.mktemp("tar"),
                                       per_shard=7, tar=True, seed=1)


def test_tar_run_matches_jax(tar_shards, tmp_path, monkeypatch,
                             same_native_library, capsys):
    assert jax_cli.main(_argv(tar_shards, "--metrics-file",
                              str(tmp_path / "jax.jsonl"))) == 0
    main = port_cli_from(monkeypatch, jax_start(PRESET, SEED, len(CLASSES)),
                         PRESET)
    capsys.readouterr()
    try:
        assert main(_argv(tar_shards, "--device", "cpu", "--metrics-file",
                          str(tmp_path / "port.jsonl"))) == 0
    finally:
        obs.reset_journal()
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["num_classes"] == len(CLASSES)
    assert summary["data"] == str(tar_shards)
    assert_matches_jax(read_metrics(tmp_path / "port.jsonl"),
                       read_metrics(tmp_path / "jax.jsonl"), 5, LOSS_RTOL)


def test_grain_loader_refuses_tar(tar_shards):
    args = cli.build_parser().parse_args(
        _argv(tar_shards, "--loader", "grain", "--device", "cpu"))
    with pytest.raises(SystemExit, match="--loader grain reads tfrecord"):
        cli.cmd_train(args)
