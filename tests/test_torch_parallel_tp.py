"""The ``model`` axis over gloo ranks: ``train --mesh data=1,model=2 --rules
tp`` (two ranks) and ``--mesh data=2,model=2 --rules fsdp_tp`` (four) give
the JAX CLI's losses at the same meshes for a tiny SigLIP-B/16-256 started
from its weights (rtol 1e-5, ``tests/test_torch_train.py``'s tolerance for a
contrastive step); ``--naflex`` under ``tp`` (the masked kernels' plain
versions on the local heads) gives the port's single-process losses.

The losses cannot show a gradient's scale (Adam after global-norm
clipping), so step 0's gradients are held to the single process's: each
parameter's whole gradient norm (f32) and the clip's global norm within
1e-5 relative under ``tp``, ``fsdp_tp``, ``hybrid_fsdp_tp`` (the library's
preset, ``replica=2,data=1,model=2``), for SigLIP, CLIP (a causal text
tower, bias-free projections) and a ViT classifier. A gradient summed over
``model`` where it should not be, or a shard's square counted once per
rank, fails here. Each rank holds the slices the table of logical names
gives it. A ``fsdp_tp`` run's checkpoint holds whole tensors (slices
gathered over ``model``, shards over ``data``), and resumed under ``tp``
(each rank cutting its slices) gives the run's own later steps and counts
one topology change."""

import shutil

import numpy as np
import pytest

from jimm_tpu import cli as jax_cli
from jimm_tpu_torch import cli
from jimm_tpu_torch.weights.safetensors_io import load_file
import torch_parallel_cases as cases
from test_torch_data_train import jax_start, read_metrics
from torch_rank_pool import RankPool

PRESET = "siglip-base-patch16-256"
SEED = 3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5


def _argv(*extra) -> list[str]:
    return ["train", "--preset", PRESET, "--tiny", "--batch-size", "4",
            "--steps", "2", "--log-every", "0", "--seed", str(SEED), *extra]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {n: RankPool(n, tmp_path_factory.mktemp(f"ranks{n}"), timeout=90)
            for n in (2, 4)}
    yield made
    for p in made.values():
        p.close()


@pytest.fixture(scope="module")
def weights():
    return jax_start(PRESET, SEED)


def _losses(path) -> list[float]:
    rows = read_metrics(path)
    return [rows[s]["loss"] for s in sorted(rows)]


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    out = {}
    for rules, mesh, n in (("tp", "data=1,model=2", 2),
                           ("fsdp_tp", "data=2,model=2", 4)):
        path = tmp_path_factory.mktemp("jax") / f"{rules}.jsonl"
        assert jax_cli.main(_argv("--mesh", mesh, "--rules", rules,
                                  "--max-devices", str(n),
                                  "--metrics-file", str(path))) == 0
        out[rules] = _losses(path)
    return out


@pytest.mark.parametrize("rules,mesh,n", [("tp", "data=1,model=2", 2),
                                          ("fsdp_tp", "data=2,model=2", 4)])
def test_model_axis_losses_match_the_jax_cli(pools, tmp_path, weights,
                                             jax_losses, rules, mesh, n):
    path = tmp_path / "port.jsonl"
    res = pools[n].run(cases.train_cli, _argv(
        "--device", "cpu", "--metrics-file", str(path), "--mesh", mesh,
        "--rules", rules), weights)
    assert [r["rc"] for r in res] == [0] * n
    np.testing.assert_allclose(_losses(path), jax_losses[rules],
                               rtol=LOSS_RTOL)


def test_naflex_under_tp_matches_the_single_process_run(pools, tmp_path):
    naflex = ["--naflex", "--preset", "siglip2-base-patch16-256"]
    path = tmp_path / "tp.jsonl"
    res = pools[2].run(cases.train_cli, _argv(
        "--device", "cpu", "--metrics-file", str(path), "--mesh",
        "data=1,model=2", "--rules", "tp", *naflex))
    assert [r["rc"] for r in res] == [0, 0]
    assert cli.main(_argv("--device", "cpu", "--metrics-file",
                          str(tmp_path / "one.jsonl"), *naflex)) == 0
    np.testing.assert_allclose(_losses(path),
                               _losses(tmp_path / "one.jsonl"),
                               rtol=LOSS_RTOL)


def _batch(preset_name: str, n: int = 4):
    rng = np.random.default_rng(7)
    images = rng.standard_normal((n, 32, 32, 3), np.float32)
    if preset_name.startswith("vit"):
        return images, rng.integers(0, 4, (n,)).astype(np.int64)
    text = rng.integers(1, 64, (n, 8)).astype(np.int64)
    if preset_name.startswith("clip"):
        text[:, -1] = 63  # the EOT token, the vocabulary's largest id
    return images, text


@pytest.mark.parametrize("preset_name,rules,axes,n", [
    (PRESET, "tp", {"data": 1, "model": 2}, 2),
    (PRESET, "fsdp_tp", {"data": 2, "model": 2}, 4),
    (PRESET, "hybrid_fsdp_tp", {"replica": 2, "data": 1, "model": 2}, 4),
    ("clip-vit-base-patch16", "tp", {"data": 1, "model": 2}, 2),
    ("vit-base-patch16-224", "tp", {"data": 1, "model": 2}, 2),
], ids=["siglip-tp", "siglip-fsdp_tp", "siglip-hybrid_fsdp_tp", "clip-tp",
        "vit-tp"])
def test_step0_gradients_match_the_single_process(pools, preset_name, rules,
                                                  axes, n):
    kind = ("classifier" if preset_name.startswith("vit")
            else preset_name.split("-")[0])
    classes = 4 if kind == "classifier" else None
    images, target = _batch(preset_name)
    # every process seeds the tiny model alike
    want = cases.step0_gradients(cases.tiny_model(
        preset_name, num_classes=classes), images, target, kind=kind)
    got = pools[n].run(cases.mesh_gradients, preset_name, axes, rules,
                       images, target, kind=kind, num_classes=classes)
    for rank, g in enumerate(got):
        assert sorted(g["norms"]) == sorted(want["norms"]), rank
        for name, w in want["norms"].items():
            np.testing.assert_allclose(g["norms"][name], w, rtol=GRAD_RTOL,
                                       atol=1e-7, err_msg=f"{rank} {name}")
        np.testing.assert_allclose(g["global_norm"], want["global_norm"],
                                   rtol=GRAD_RTOL)
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-6)
    # q/k/v and fc1 cut on their output features, out and fc2 on their
    # inputs; LayerNorms and the patch embedding whole
    local = got[0]["local"]
    width = 64
    q = "vision.encoder.blocks.0.attn.q.weight"
    out = "vision.encoder.blocks.0.attn.out.weight"
    ln = "vision.encoder.blocks.0.ln1.weight"
    if rules == "tp":
        assert local[q] == ((width // 2, width), False)
        assert local[out] == ((width, width // 2), False)
        assert local[ln] == ((width,), False)
    else:  # and FSDP2 shards of the slices over data
        assert local[q] == ((width // 2, width // axes["data"]), True)
        assert local[out] == ((width // axes["data"], width // 2), True)


def test_fsdp_tp_checkpoint_resumes_under_tp(pools, tmp_path, weights):
    ckpt = tmp_path / "ckpt"
    path = tmp_path / "whole.jsonl"
    res = pools[4].run(cases.train_cli, _argv(
        "--steps", "4", "--device", "cpu", "--metrics-file", str(path),
        "--mesh", "data=2,model=2", "--rules", "fsdp_tp", "--ckpt-dir",
        str(ckpt), "--save-every", "1"), weights)
    assert [r["rc"] for r in res] == [0] * 4
    whole = _losses(path)
    # whole tensors, as an unsharded run writes them (a 0-d one as (1,))
    want = {n: tuple(p.shape) or (1,) for n, p in
            cases.tiny_model(PRESET).named_parameters()}
    saved = load_file(ckpt / "1" / "model.safetensors")
    assert {n: tuple(t.shape) for n, t in saved.items()} == want
    for step in ("2", "3"):
        shutil.rmtree(ckpt / step)
        (ckpt / ".jimm_markers" / step).unlink()
    path = tmp_path / "resumed.jsonl"
    res = pools[2].run(cases.train_cli, _argv(
        "--steps", "4", "--device", "cpu", "--metrics-file", str(path),
        "--mesh", "data=1,model=2", "--rules", "tp", "--ckpt-dir",
        str(ckpt), "--save-every", "1", "--resume"), weights)
    assert [(r["rc"], r["topology_changes"]) for r in res] == [(0, 1)] * 2
    resumed = read_metrics(path)
    assert sorted(resumed) == [2, 3]
    np.testing.assert_allclose([resumed[2]["loss"], resumed[3]["loss"]],
                               whole[2:], rtol=LOSS_RTOL)
