"""The ``stage`` axis over two gloo ranks: the schedule helpers
(``num_ticks``, ``circular_layer_order``, ``check_pp_schedule`` and
``validate_pipeline``'s messages) equal JAX's; ``pipeline_forward`` on a
small stack of layers gives JAX's ``pipeline_forward`` in a two-device
``shard_map`` (output, the input's gradient, the layers'), at V = 1 and
V = 2; ``load_jax_params`` reads a JAX tower built with ``pp_stages=2,
pp_virtual=2`` (its layers stored in circular order), and the pipelined
port gives the JAX model's embeddings.

``train --mesh data=1,stage=2 --rules pp --pipeline-microbatches 2``, with
and without ``--pipeline-virtual 2``, gives the JAX CLI's losses for a
tiny SigLIP-B/16-256 started from its weights (rtol 1e-5). Step 0's
gradients under ``pp`` and ``pp`` V=2 equal the single process's (each
parameter's whole gradient norm and the clip's global norm, 1e-5
relative): a missing sum over ``stage`` of the embeddings' gradient, or a
block's counted on both stages, fails here. A ``pp`` V=2 run's checkpoint
holds every block under its own name, and resumed on one rank gives the
run's own later steps and counts one topology change; resumed under
``pp`` V=1 (each stage taking other blocks of it) it gives them too."""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx
from jax.sharding import Mesh

from jimm_tpu import cli as jax_cli
from jimm_tpu import configs as jax_configs
from jimm_tpu import preset as jax_preset
from jimm_tpu.parallel import pipeline as jax_pipeline
from jimm_tpu_torch import cli, configs, obs
from jimm_tpu_torch.parallel import pipeline
from jimm_tpu_torch.weights.safetensors_io import load_file
import torch_parallel_cases as cases
from test_torch_data_train import (jax_start, port_cli_from,
                                   read_metrics)
from test_torch_siglip import jax_params
from torch_rank_pool import RankPool

PRESET = "siglip-base-patch16-256"
SEED = 3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
PP = ["--mesh", "data=1,stage=2", "--rules", "pp",
      "--pipeline-microbatches", "2"]
V2 = ["--pipeline-virtual", "2"]


def _argv(*extra) -> list[str]:
    return ["train", "--preset", PRESET, "--tiny", "--batch-size", "4",
            "--log-every", "0", "--seed", str(SEED), *extra]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, tmp_path_factory.mktemp("ranks"), timeout=90)
    yield p
    p.close()


@pytest.fixture(scope="module")
def weights():
    return jax_start(PRESET, SEED)


#: the towers' pipeline fields of ``--pipeline-virtual 2`` on two stages
V2_RUNTIME = {"pipeline": True, "pp_virtual": 2, "pp_stages": 2,
              "pp_microbatches": 2}


def _jax_model(runtime: dict | None = None):
    cfg = jax_cli._tiny_override(jax_preset(PRESET))
    if runtime:
        cfg = jax_configs.with_runtime(cfg, **runtime)
    return jax_cli._model_cls("siglip")(cfg, rngs=nnx.Rngs(SEED))


@pytest.fixture(scope="module")
def v2_weights():
    """The model the JAX command of ``--pipeline-virtual 2`` starts from:
    its layers stored in circular order."""
    return jax_params(_jax_model(V2_RUNTIME))


def _losses(path) -> list[float]:
    rows = read_metrics(path)
    return [rows[s]["loss"] for s in sorted(rows)]


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    out = {}
    for name, extra in (("v1", []), ("v2", V2)):
        path = tmp_path_factory.mktemp("jax") / f"{name}.jsonl"
        assert jax_cli.main(_argv("--steps", "2", *PP, *extra,
                                  "--max-devices", "2", "--metrics-file",
                                  str(path))) == 0
        out[name] = _losses(path)
    return out


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("v", [1, 2, 3])
def test_schedule_helpers_match_jax(m, s, v):
    assert pipeline.num_ticks(m, s, v) == jax_pipeline.num_ticks(m, s, v)
    for depth in (s * v, 2 * s * v):
        np.testing.assert_array_equal(
            pipeline.circular_layer_order(depth, s, v),
            jax_pipeline.circular_layer_order(depth, s, v))
    # every (microbatch, lap) is worked on once by every stage
    for d in range(s):
        work = [pipeline.tick_work(t, d, m, s, v)
                for t in range(pipeline.num_ticks(m, s, v))]
        if v == 1 or m % s == 0:
            assert sorted(w for w in work if w) == [
                (mb, lap) for mb in range(m) for lap in range(v)]


@pytest.mark.parametrize("kw", [
    {"depth": 4, "n_stages": 0}, {"depth": 6, "n_stages": 4},
    {"depth": 8, "n_stages": 4, "pp_virtual": 2, "pp_stages": 2},
    {"depth": 8, "n_stages": 4, "pp_virtual": 2, "pp_microbatches": 6},
    {"depth": 8, "n_stages": 2, "local_batch": 6},
    {"depth": 8, "n_stages": 2, "pp_microbatches": 0},
], ids=["no-stage-axis", "depth", "pp_stages", "interleaved", "local-batch",
        "microbatches"])
def test_pipeline_checks_match_jax(kw):
    kw = dict(kw)
    call = {k: kw.pop(k) for k in ("n_stages", "local_batch") if k in kw}
    errors = []
    for mod in (configs, jax_configs):
        tower = dataclasses.replace(mod.TransformerConfig(), pipeline=True,
                                    **kw)
        with pytest.raises(ValueError) as e:
            mod.validate_pipeline(tower, tower_name="vision", **call)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("v,m", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_pipeline_forward_matches_jax(pool, v, m):
    rng = np.random.default_rng(v * 10 + m)
    depth, f, b = 4, 8, 4
    x = rng.standard_normal((b, f), np.float32)
    w = (rng.standard_normal((depth, f, f)) / np.sqrt(f)).astype(np.float32)
    bias = rng.standard_normal((depth, f)).astype(np.float32) * 0.1
    dout = rng.standard_normal((b, f), np.float32)
    order = (jax_pipeline.circular_layer_order(depth, 2, v) if v > 1
             else np.arange(depth))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("stage",))

    def stage_apply(chunk, xm, tick):
        cw, cb = chunk
        for layer in range(cw.shape[0]):
            xm = jnp.tanh(xm @ cw[layer] + cb[layer])
        return xm

    def loss(xx, ww, bb):
        out = jax_pipeline.pipeline_forward(
            stage_apply, (ww, bb), xx, n_microbatches=m, n_virtual=v,
            mesh=mesh)
        return jnp.sum(out * dout), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(x), jnp.asarray(w[order]), jnp.asarray(bias[order]))
    dw, db = np.empty_like(w), np.empty_like(bias)
    dw[order], db[order] = np.asarray(grads[1]), np.asarray(grads[2])
    for got in pool.run(cases.pipeline_small, x, w, bias, dout, m, v):
        np.testing.assert_allclose(got["out"], np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(got["dx"], np.asarray(grads[0]),
                                   atol=1e-5)
        np.testing.assert_allclose(got["dw"], dw, atol=1e-5)
        np.testing.assert_allclose(got["db"], db, atol=1e-5)


def test_load_jax_params_reads_a_circular_tower(pool, v2_weights):
    plain = _jax_model()
    stored, canonical = v2_weights, jax_params(plain)
    key = "vision.encoder.blocks.attn.q.kernel"
    order = pipeline.circular_layer_order(4, 2, 2)
    assert not np.array_equal(order, np.arange(4))
    np.testing.assert_array_equal(stored[key], canonical[key][order])
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 32, 32, 3), np.float32)
    text = rng.integers(1, 64, (4, 8)).astype(np.int32)
    want_img = nnx.jit(lambda mm, x: mm.encode_image(x))(plain, images)
    want_txt = nnx.jit(lambda mm, t: mm.encode_text(t))(plain, text)
    got = pool.run(cases.pipelined_forward, PRESET, V2_RUNTIME, stored,
                   images, text)
    for rank, g in enumerate(got):
        np.testing.assert_allclose(g["image"], np.asarray(want_img),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["text"], np.asarray(want_txt),
                                   rtol=1e-4, atol=1e-4)
        # stage d holds the chunks {v*2 + d}: blocks d and d + 2
        assert g["blocks"] == [
            f"{t}.encoder.blocks.{i}.ln1.weight"
            for t in ("text", "vision") for i in (rank, rank + 2)]


@pytest.mark.parametrize("extra", [[], V2], ids=["v1", "v2"])
def test_pp_losses_match_the_jax_cli(pool, tmp_path, weights, v2_weights,
                                     jax_losses, extra):
    # each run from the JAX command's own start (under V = 2 stored in
    # circular order, which the port's load undoes)
    path = tmp_path / "port.jsonl"
    res = pool.run(cases.train_cli, _argv(
        "--steps", "2", "--device", "cpu", "--metrics-file", str(path),
        *PP, *extra), v2_weights if extra else weights)
    assert [r["rc"] for r in res] == [0, 0]
    np.testing.assert_allclose(_losses(path),
                               jax_losses["v2" if extra else "v1"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("preset_name,runtime", [
    (PRESET, {"pipeline": True, "pp_microbatches": 2}),
    (PRESET, {"pipeline": True, "pp_microbatches": 2, "pp_virtual": 2,
              "pp_stages": 2}),
    ("clip-vit-base-patch16", {"pipeline": True, "pp_microbatches": 4}),
], ids=["siglip-v1", "siglip-v2", "clip-v1"])
def test_step0_gradients_match_the_single_process(pool, preset_name,
                                                  runtime):
    kind = preset_name.split("-")[0]
    rng = np.random.default_rng(7)
    images = rng.standard_normal((4, 32, 32, 3), np.float32)
    text = rng.integers(1, 64, (4, 8)).astype(np.int64)
    text[:, -1] = 63  # CLIP pools at the EOT token, the largest id
    want = cases.step0_gradients(cases.tiny_model(preset_name), images,
                                 text, kind=kind)
    got = pool.run(cases.mesh_gradients, preset_name,
                   {"data": 1, "stage": 2}, "pp", images, text,
                   runtime=runtime, kind=kind)
    for rank, g in enumerate(got):
        assert sorted(g["norms"]) == sorted(want["norms"]), rank
        for name, w in want["norms"].items():
            np.testing.assert_allclose(g["norms"][name], w, rtol=GRAD_RTOL,
                                       atol=1e-7, err_msg=f"{rank} {name}")
        np.testing.assert_allclose(g["global_norm"], want["global_norm"],
                                   rtol=GRAD_RTOL)
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-6)


def test_pp_checkpoint_resumes_on_one_rank(pool, tmp_path, weights,
                                           v2_weights, monkeypatch):
    ckpt = tmp_path / "ckpt"
    path = tmp_path / "whole.jsonl"
    res = pool.run(cases.train_cli, _argv(
        "--steps", "4", "--device", "cpu", "--metrics-file", str(path),
        *PP, *V2, "--ckpt-dir", str(ckpt), "--save-every", "1"), v2_weights)
    assert [r["rc"] for r in res] == [0, 0]
    whole = _losses(path)
    run = json.loads((ckpt / "1" / "checkpoint.json").read_text())
    assert run["mesh"] == {"axes": {"data": 1, "stage": 2}, "n_devices": 2}
    # every block under its own name, as an unsharded run writes them
    names = {n for n, _ in cases.tiny_model(PRESET).named_parameters()}
    assert set(load_file(ckpt / "1" / "model.safetensors")) == names
    for step in ("2", "3"):
        shutil.rmtree(ckpt / step)
        (ckpt / ".jimm_markers" / step).unlink()
    topology = obs.get_registry("jimm_train").counter(
        "checkpoint_topology_changes_total")
    before = topology.value
    # the restore replaces the start
    port_cli = port_cli_from(monkeypatch, weights, PRESET)
    path = tmp_path / "resumed.jsonl"
    assert port_cli(_argv("--device", "cpu", "--steps", "4", "--mesh",
                          "data=1", "--ckpt-dir", str(ckpt), "--save-every",
                          "1", "--resume", "--metrics-file", str(path))) == 0
    resumed = read_metrics(path)
    assert sorted(resumed) == [2, 3]
    np.testing.assert_allclose([resumed[2]["loss"], resumed[3]["loss"]],
                               whole[2:], rtol=LOSS_RTOL)
    assert topology.value - before == 1
    assert not cli.torch.distributed.is_initialized()
    # the same checkpoint, each stage restoring its V = 1 blocks
    for step in ("2", "3"):
        shutil.rmtree(ckpt / step)
        (ckpt / ".jimm_markers" / step).unlink()
    path = tmp_path / "resumed_pp.jsonl"
    res = pool.run(cases.train_cli, _argv(
        "--steps", "4", "--device", "cpu", "--metrics-file", str(path),
        *PP, "--ckpt-dir", str(ckpt), "--save-every", "1", "--resume"),
        weights)
    assert [(r["rc"], r["topology_changes"]) for r in res] == [(0, 0)] * 2
    resumed = read_metrics(path)
    np.testing.assert_allclose([resumed[2]["loss"], resumed[3]["loss"]],
                               whole[2:], rtol=LOSS_RTOL)
