"""The port's ``train --naflex --data`` on the CPU: a tiny SigLIP2-B/16-256
from TFRecord image-text shards of mixed aspect ratios (NaFlex batches:
variable grids, padding masks), started from the JAX command's initial
weights, matches the JAX CLI's run of the same argv (losses at rtol 1e-5,
the contrastive step's tolerance; batch fingerprints, the patches, grid
shapes, masks and tokens, exactly)."""

from jimm_tpu import cli as jax_cli
from jimm_tpu_torch import obs
from test_torch_data_train import (  # noqa: F401 (a fixture)
    assert_matches_jax, jax_start, port_cli_from, read_metrics,
    same_native_library, write_pair_shards)

PRESET = "siglip2-base-patch16-256"
SEED = 4
LOSS_RTOL = 1e-5
#: wide, tall and square images: the tiny tower's 4-patch budget resizes
#: each to another grid
SIZES = ((24, 72), (64, 30), (40, 40), (18, 50))


def test_naflex_records_run_matches_jax(tmp_path, monkeypatch,
                                        same_native_library):
    data = write_pair_shards(tmp_path / "pairs", seed=3, sizes=SIZES)
    argv = ["train", "--preset", PRESET, "--tiny", "--naflex",
            "--batch-size", "4", "--steps", "4", "--log-every", "0",
            "--seed", str(SEED), "--data", str(data), "--shuffle-buffer",
            "5", "--batch-fingerprint"]
    assert jax_cli.main(argv + ["--metrics-file",
                                str(tmp_path / "jax.jsonl")]) == 0
    main = port_cli_from(monkeypatch, jax_start(PRESET, SEED), PRESET)
    try:
        assert main(argv + ["--device", "cpu", "--metrics-file",
                            str(tmp_path / "port.jsonl")]) == 0
    finally:
        obs.reset_journal()
    assert_matches_jax(read_metrics(tmp_path / "port.jsonl"),
                       read_metrics(tmp_path / "jax.jsonl"), 4, LOSS_RTOL)
