"""The port's ``train --data`` for a dual tower on the CPU: a tiny
SigLIP-B/16-256 from TFRecord image-text shards with ``--shuffle-buffer
8``, started from the JAX command's initial weights, matches the JAX CLI's
run of the same argv (losses at ``tests/test_torch_train.py``'s rtol 1e-5
for the contrastive step, batch fingerprints exactly); ``--loader grain``
with two worker processes trains on the batches it trains on with none."""

import pytest

from jimm_tpu import cli as jax_cli
from jimm_tpu_torch import obs
from test_torch_data_train import (  # noqa: F401 (a fixture)
    assert_matches_jax, assert_same_run, jax_start, port_cli_from,
    read_metrics, same_native_library, write_pair_shards)

PRESET = "siglip-base-patch16-256"
SEED = 5
#: the contrastive step's loss tolerance against JAX's
LOSS_RTOL = 1e-5


def _argv(data, *extra) -> list[str]:
    return ["train", "--preset", PRESET, "--tiny", "--batch-size", "4",
            "--steps", "5", "--log-every", "0", "--seed", str(SEED),
            "--data", str(data), "--batch-fingerprint", *extra]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return write_pair_shards(tmp_path_factory.mktemp("pairs"), seed=2)


@pytest.fixture
def port_cli(monkeypatch):
    yield port_cli_from(monkeypatch, jax_start(PRESET, SEED), PRESET)
    obs.reset_journal()


def test_records_run_matches_jax(pairs, tmp_path, port_cli,
                                 same_native_library):
    argv = _argv(pairs, "--shuffle-buffer", "8")
    assert jax_cli.main(argv + ["--metrics-file",
                                str(tmp_path / "jax.jsonl")]) == 0
    assert port_cli(argv + ["--device", "cpu", "--metrics-file",
                            str(tmp_path / "port.jsonl")]) == 0
    assert_matches_jax(read_metrics(tmp_path / "port.jsonl"),
                       read_metrics(tmp_path / "jax.jsonl"), 5, LOSS_RTOL)


def test_grain_workers_give_the_in_process_run(pairs, tmp_path, port_cli):
    runs = {}
    for workers in ("0", "2"):
        path = tmp_path / f"w{workers}.jsonl"
        assert port_cli(_argv(pairs, "--loader", "grain", "--data-workers",
                              workers, "--device", "cpu", "--metrics-file",
                              str(path))) == 0
        runs[workers] = read_metrics(path)
    assert_same_run(runs["2"], runs["0"], range(5))
