"""The port's NaFlex (SigLIP2 variable-resolution) slice against the JAX
package on the CPU: the per-sample position resample, the host-side data
layer, ``encode_image_naflex`` / ``logits_naflex`` with the JAX model's
weights carried across (both sides on the flash path: the masked flash's
plain version here, Pallas interpret mode there), padding that cannot leak,
and the ``train --naflex`` command."""

import json
import math
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from jimm_tpu import configs as jax_configs
from jimm_tpu.data import naflex as jax_data_naflex
from jimm_tpu.data import synthetic as jax_synthetic
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.nn.naflex import (
    naflex_position_embedding as jax_naflex_position_embedding)
from jimm_tpu_torch import configs
from jimm_tpu_torch.data import naflex as data_naflex
from jimm_tpu_torch.data import preprocess, synthetic
from jimm_tpu_torch.models.siglip import SigLIP, load_jax_params
from jimm_tpu_torch.nn.naflex import naflex_position_embedding
from jimm_tpu_torch.ops import flash_attention as fa
from test_torch_siglip import jax_params, tiny_config

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
# model-parity tolerance of the JAX suite (README "parity" section), as in
# tests/test_torch_siglip.py
TOL = dict(atol=1e-4, rtol=1e-4)


# -- position embedding -----------------------------------------------------

@pytest.mark.parametrize("grids,seq", [
    ([(16, 16)], 256),                   # the native grid: the identity
    ([(8, 32), (20, 10)], 256),          # down- and up-sampled axes
    ([(3, 5), (1, 64), (16, 1)], 70),    # padded rows past h*w, tiny axes
    ([(9, 27), (16, 16), (27, 9), (11, 22)], 256),  # the train grids
])
def test_position_embedding_matches_jax(grids, seq):
    rng = np.random.default_rng(len(grids) + seq)
    table = rng.standard_normal((16, 16, 8), np.float32)
    shapes = np.asarray(grids, np.int32)
    want = np.asarray(jax_naflex_position_embedding(
        jnp.asarray(table), jnp.asarray(shapes), seq))
    got = naflex_position_embedding(torch.from_numpy(table),
                                    torch.from_numpy(shapes), seq).numpy()
    assert got.shape == (len(grids), seq, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.isfinite(got).all()
    any_far = False
    for b, (h, w) in enumerate(grids):
        # a padded row whose grid row lies beyond the filter's reach of the
        # table gets all-zero weights: zero, never NaN (0/0)
        t = np.arange(seq)
        scale = 16 / h
        src = (t // w + 0.5) * scale - 0.5
        far = src - 15 >= max(scale, 1.0)
        assert not got[b, far].any()
        any_far |= bool(far.any())
        if h * w <= seq:
            # the per-axis filter is torch's antialiased bilinear resize
            t = torch.from_numpy(table).permute(2, 0, 1)[None]
            ref = F.interpolate(t, size=(h, w), mode="bilinear",
                                align_corners=False, antialias=True)
            np.testing.assert_allclose(
                got[b, :h * w], ref[0].permute(1, 2, 0).reshape(h * w, -1),
                atol=1e-5)
    assert any_far or seq != 70  # the padded case has such rows


def test_position_embedding_is_differentiable_in_the_table():
    table = torch.randn(4, 4, 3, requires_grad=True)
    out = naflex_position_embedding(table, torch.tensor([[2, 3], [4, 4]]), 16)
    out.sum().backward()
    assert table.grad is not None and torch.isfinite(table.grad).all()


# -- data layer -------------------------------------------------------------

@pytest.mark.parametrize("h,w,p,budget", [
    (224, 224, 16, 256), (32, 96, 16, 256), (96, 32, 16, 256),
    (32, 64, 16, 256), (480, 640, 16, 256), (100, 3000, 14, 729),
    (7, 5, 16, 4), (1000, 10, 16, 16), (32, 96, 16, 16)])
def test_target_size_matches_jax(h, w, p, budget):
    got = data_naflex.target_size_for_max_patches(h, w, p, budget)
    assert got == jax_data_naflex.target_size_for_max_patches(h, w, p, budget)
    assert got[0] % p == 0 and got[1] % p == 0
    assert (got[0] // p) * (got[1] // p) <= budget


def test_image_to_patches_matches_jax():
    img = np.random.default_rng(0).standard_normal((48, 32, 3), np.float32)
    got = data_naflex.image_to_patches(img, 16)
    np.testing.assert_array_equal(got, jax_data_naflex.image_to_patches(img,
                                                                         16))
    # row (patch_row, patch_col, channel) layout
    np.testing.assert_array_equal(got[1].reshape(16, 16, 3), img[:16, 16:32])


def test_resize_matches_jax():
    from jimm_tpu.data.preprocess import resize_bilinear
    img = np.random.default_rng(1).standard_normal((2, 32, 32, 3), np.float32)
    for size in ((144, 432), (16, 48), (32, 32), (7, 9)):
        # the JAX package may take its native C path, which agrees to ~1e-6
        np.testing.assert_allclose(preprocess.resize_bilinear(img, size),
                                   resize_bilinear(img, size), atol=1e-5)


def test_patchify_naflex_matches_jax():
    rng = np.random.default_rng(2)
    images = [rng.standard_normal(s, np.float32)
              for s in ((40, 120, 3), (64, 64, 3), (90, 30, 3))]
    got = data_naflex.patchify_naflex(images, patch_size=16,
                                      max_num_patches=32)
    want = jax_data_naflex.patchify_naflex(images, patch_size=16,
                                           max_num_patches=32)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].dtype == np.int32 and got[2].dtype == bool


@pytest.mark.parametrize("batch,budget,seed", [(4, 256, 0), (6, 16, 3)])
def test_naflex_pairs_match_jax(batch, budget, seed):
    kw = dict(patch_size=16, max_num_patches=budget, vocab_size=50,
              seq_len=6, seed=seed)
    jgen = jax_synthetic.naflex_contrastive_pairs(batch, **kw)
    tgen = synthetic.naflex_contrastive_pairs(batch, **kw)
    for _ in range(2):
        ((jp, js, jm), jt), ((tp, ts, tm), tt) = next(jgen), next(tgen)
        np.testing.assert_allclose(tp, jp, atol=1e-5)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tt, jt)
    if budget == 256:
        # the full-width grids: 243, 256, 243 and 242 of 256 tokens real
        assert ts.tolist() == [[9, 27], [16, 16], [27, 9], [11, 22]]
        assert tm.sum(1).tolist() == [243, 256, 243, 242]


# -- the model --------------------------------------------------------------

def _naflex_batch(batch: int, seed: int):
    """A mixed-grid NaFlex batch for the tiny model (64x64, patch 16: a
    16-token budget) from the synthetic generator."""
    (patches, shapes, mask), _ = next(synthetic.naflex_contrastive_pairs(
        batch, patch_size=16, max_num_patches=16, seed=seed))
    assert len({tuple(s) for s in shapes}) > 1 and not mask.all()
    return patches, shapes, mask


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0))
    tmodel = SigLIP(tiny_config(configs), device="cpu")
    load_jax_params(tmodel, jax_params(jmodel))
    return jmodel, tmodel


@pytest.mark.parametrize("method", ["encode_image_naflex", "logits_naflex"])
def test_naflex_matches_jax(pair, method):
    jmodel, tmodel = pair
    patches, shapes, mask = _naflex_batch(4, 0)
    text = np.random.default_rng(1).integers(0, 100, (3, 8)).astype(np.int32)
    jargs = tuple(map(jnp.asarray, (patches, shapes, mask)))
    targs = tuple(map(torch.from_numpy, (patches, shapes, mask)))
    before = fa.masked_launches
    with torch.no_grad():
        if method == "encode_image_naflex":
            want = nnx.jit(lambda m, *a: m.encode_image_naflex(*a))(
                jmodel, *jargs)
            got = tmodel.encode_image_naflex(*targs)
        else:
            want = nnx.jit(lambda m, *a: m.logits_naflex(*a))(
                jmodel, *jargs, jnp.asarray(text))
            got = tmodel.logits_naflex(*targs, torch.from_numpy(text).long())
    assert fa.masked_launches == before  # plain versions on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_padding_cannot_leak(pair):
    """Garbage in the padded patches changes nothing: the padded tokens are
    masked out of every attention, and nothing else mixes tokens."""
    _, tmodel = pair
    patches, shapes, mask = _naflex_batch(4, 5)
    poisoned = patches.copy()
    poisoned[~mask] = 1e4
    with torch.no_grad():
        base = tmodel.encode_image_naflex(*map(torch.from_numpy,
                                               (patches, shapes, mask)))
        out = tmodel.encode_image_naflex(*map(torch.from_numpy,
                                              (poisoned, shapes, mask)))
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, base, atol=1e-5, rtol=0)


def test_native_grid_is_the_fixed_resolution_path(pair):
    """At the native square grid with no padding the NaFlex path is
    ``encode_image``: the resample is the identity, and the flattened conv
    weight is the NaFlex Linear (a wrong permute fails here)."""
    _, tmodel = pair
    images = np.random.default_rng(7).standard_normal((2, 64, 64, 3),
                                                      np.float32)
    patches = np.stack([data_naflex.image_to_patches(im, 16)
                        for im in images])
    shapes = np.full((2, 2), 4, np.int32)
    mask = np.ones((2, 16), bool)
    with torch.no_grad():
        got = tmodel.encode_image_naflex(*map(torch.from_numpy,
                                              (patches, shapes, mask)))
        want = tmodel.encode_image(torch.from_numpy(images))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# -- the train command ------------------------------------------------------

def _train(*argv: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "jimm_tpu_torch", "train", "--tiny", *argv],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)


def test_train_naflex_cli_on_the_cpu():
    proc = _train("--naflex", "--device", "cpu", "--steps", "2",
                  "--batch-size", "4", "--log-every", "1", "--ln-impl",
                  "fused", "--attn-impl", "flash")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    steps = [r for r in lines if "step" in r]
    assert [r["step"] for r in steps] == [0, 1]
    assert all(math.isfinite(r["loss"]) for r in steps)
    assert lines[-1]["status"] == "trained" and lines[-1]["naflex"] is True


def _args(*argv: str):
    from jimm_tpu_torch.cli import build_parser
    return build_parser().parse_args(["train", "--tiny", "--device", "cpu",
                                      *argv])


def test_train_naflex_refuses_other_families():
    """The JAX CLI's message for a ViT/CLIP preset (the port's parser lists
    only SigLIP presets, so the name is set after parsing)."""
    from jimm_tpu_torch.cli import cmd_train
    args = _args("--naflex")
    args.preset = "vit-base-patch16-224"
    with pytest.raises(SystemExit, match="use a siglip preset"):
        cmd_train(args)


@pytest.mark.parametrize("argv,match", [
    (["--attn-impl", "flash_masked"], "needs --naflex"),
    (["--naflex", "--loader", "grain", "--data", "x"],
     "--naflex reads tfrecord shards")])
def test_train_naflex_refusals(argv, match):
    from jimm_tpu_torch.cli import cmd_train
    with pytest.raises(SystemExit, match=match):
        cmd_train(_args(*argv))
