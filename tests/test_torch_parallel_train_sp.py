"""``train --mesh ... --rules sp`` over two gloo ranks: the towers run
sequence-parallel (each rank encodes its half of the tokens, attention
through the seqpar ring's hops, the tokens gathered for the pooling).

The JAX CLI's own default on a seq axis, the ring loss over the
``("data", "seq")`` pair axis, does not run there: its batch spec maps
``seq`` twice (``DuplicateSpecError``). So the parity run is ``--mesh
data=1,seq=2 --rules sp --loss siglip``: a tiny SigLIP-B/16-256 started
from the JAX command's weights gives the JAX CLI's losses (rtol 1e-5, as
for a contrastive step in ``tests/test_torch_train.py``). The port's
default, ``--mesh seq=2 --rules sp`` with ``siglip_ring`` over the pair
axis (each rank keeps its half of the batch's embeddings), gives the same
losses: the ring loss is the dense loss. A tiny CLIP (a causal text
tower: the ring's causal hops) under ``--rules sp`` gives the port's
single-process losses. Every sharded run moved ring bytes."""

import numpy as np
import pytest

from jimm_tpu import cli as jax_cli
from jimm_tpu_torch import cli
import torch_parallel_cases as cases
from test_torch_data_train import jax_start, read_metrics
from torch_rank_pool import RankPool

SEED = 4
SIGLIP = "siglip-base-patch16-256"
LOSS_RTOL = 1e-5


def _argv(preset, *extra) -> list[str]:
    return ["train", "--preset", preset, "--tiny", "--batch-size", "4",
            "--steps", "2", "--log-every", "0", "--seed", str(SEED), *extra]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    # every call has the pool's timeout (60 s)
    p = RankPool(2, tmp_path_factory.mktemp("ranks"), timeout=60)
    yield p
    p.close()


def _losses(path) -> list[float]:
    rows = read_metrics(path)
    return [rows[s]["loss"] for s in sorted(rows)]


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "jax.jsonl"
    assert jax_cli.main(_argv(SIGLIP, "--mesh", "data=1,seq=2", "--rules",
                              "sp", "--loss", "siglip", "--max-devices", "2",
                              "--metrics-file", str(path))) == 0
    return _losses(path)


def _port(pool, path, preset, *extra, weights=None) -> list[float]:
    res = pool.run(cases.train_cli, _argv(
        preset, "--device", "cpu", "--metrics-file", str(path), *extra),
        weights)
    assert [r["rc"] for r in res] == [0, 0]
    assert all(r["ring_bytes"] > 0 for r in res)
    return _losses(path)


@pytest.mark.parametrize("mesh", [
    ["--mesh", "data=1,seq=2", "--loss", "siglip"],
    ["--mesh", "seq=2"]], ids=["dense_loss", "ring_loss"])
def test_sp_losses_match_the_jax_cli(pool, tmp_path, jax_losses, mesh):
    got = _port(pool, tmp_path / "port.jsonl", SIGLIP, *mesh, "--rules",
                "sp", weights=jax_start(SIGLIP, SEED))
    np.testing.assert_allclose(got, jax_losses, rtol=LOSS_RTOL)


def test_sp_causal_text_matches_the_single_process_run(pool, tmp_path):
    clip = "clip-vit-base-patch16"
    sp = _port(pool, tmp_path / "sp.jsonl", clip, "--mesh", "data=1,seq=2",
               "--rules", "sp", "--loss", "clip")
    assert cli.main(_argv(clip, "--device", "cpu", "--metrics-file",
                          str(tmp_path / "one.jsonl"))) == 0
    np.testing.assert_allclose(sp, _losses(tmp_path / "one.jsonl"),
                               rtol=LOSS_RTOL)
