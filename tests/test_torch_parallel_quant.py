"""fp8_hybrid and int8_qk on a mesh of gloo ranks, against the JAX package.

The fault first: an fp8 amax is the max over every shard of its tensor (JAX
takes ``tensor_amax`` of the global array). One ``Fp8Linear`` under
``data=2``, two passes finished as a train step finishes them: its x and w
histories and the backward's e5m2 gradient scale equal JAX's module on the
whole batch bit for bit, on both ranks; the outputs and gradients agree at
``tests/test_torch_fp8.py``'s tolerance. A tiny SigLIP's step under
``data=2``: every history equal on the two ranks and to the port's single
process bit for bit, and to JAX's model on the whole batch to f32 rounding
(rtol 1e-5, as ``test_torch_fp8.py`` holds the single process), its
gradients within 1e-4 of their largest.

Then the model and stage axes: ``train --precision fp8_hybrid|int8_qk``
under ``--rules tp`` gives the JAX CLI's losses at the same mesh, and
int8_qk under ``--rules pp`` too (rtol 1e-5), with ``--lr 0``: every step
from the same weights, fp8's second on its histories rolled by the first.
A free step of a quantized model flips roundings (Adam turns a gradient
that is zero in exact arithmetic into an lr-sized move, see
``test_torch_fp8.py``): with the default lr, step 1's loss moved by 1.6e-3
(fp8) and 4.6e-5 (int8) between the packages, and as much between two
layouts of either package, JAX's tp and pp included. Under
``pp`` the JAX CLI's fp8 losses leave its own single process's from step
1 on, at one microbatch too (10.1348 against 10.2142): its pipelined scan
merges each block from its state and returns none, so the blocks' amax
histories never roll there. The port's pp is held to its single process
instead, at one microbatch (at more, each microbatch's backward takes its
own gradient scale, as JAX's does). Step 0's gradient norms under
``fsdp_tp`` (four ranks) equal the single process's at 1e-5 under both
policies. A JAX fp8 model of ``--pipeline-virtual 2`` carries its
histories, stored in circular order, to the port's blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx

from jimm_tpu import cli as jax_cli
from jimm_tpu.configs import preset as jax_preset
from jimm_tpu.ops import fp8_matmul as jfp8
from jimm_tpu.quant.policy import apply_precision_policy as jax_policy
from jimm_tpu.quant.policy import fp8_linear as jax_fp8_linear
from jimm_tpu.train import trainer as jax_trainer
from jimm_tpu_torch import cli
from jimm_tpu_torch.models.common import load_jax_params
import torch_parallel_cases as cases
from test_torch_data_train import jax_start, read_metrics
from test_torch_fp8 import jax_state
from test_torch_train import _port_arrays
from torch_rank_pool import RankPool

PRESET = "siglip-base-patch16-256"
SEED = 3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5


def _argv(*extra) -> list[str]:
    return ["train", "--preset", PRESET, "--tiny", "--batch-size", "4",
            "--log-every", "0", "--seed", str(SEED), *extra]


def _losses(path) -> list[float]:
    rows = read_metrics(path)
    return [rows[s]["loss"] for s in sorted(rows)]


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


def _batch(n: int = 4):
    rng = np.random.default_rng(7)
    images = rng.standard_normal((n, 32, 32, 3), np.float32)
    return images, rng.integers(1, 64, (n, 8)).astype(np.int64)


# -- the fault: amax over the data axis ----------------------------------------

def test_fp8_linear_amax_is_the_whole_batchs(pools):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 48), np.float32) * 3
    x[5, 7] = 40.0  # the batch's amax sits in rank 1's rows
    w = rng.standard_normal((48, 24), np.float32) * 0.1
    b = rng.standard_normal((24,), np.float32) * 0.1
    g = rng.standard_normal((8, 24), np.float32)
    g[1, 3] = 9.0  # the gradient's in rank 0's
    lin = nnx.Linear(48, 24, rngs=nnx.Rngs(0))
    lin.kernel.value, lin.bias.value = jnp.asarray(w), jnp.asarray(b)
    jlin = jax_fp8_linear(lin)
    want = []
    for _ in range(2):
        xs = jfp8.delayed_scale(jlin.x_amax[...], jnp.float8_e4m3fn)
        ws = jfp8.delayed_scale(jlin.w_amax[...], jnp.float8_e4m3fn)
        y, vjp = jax.vjp(lambda a, k, c: jfp8.fp8_matmul(
            a, k, c, x_scale=xs, w_scale=ws), jnp.asarray(x), jlin.kernel[...],
            jlin.bias[...])
        dx, dw, db = vjp(jnp.asarray(g))
        jlin(jnp.asarray(x))  # the module's own roll of its histories
        want.append({"x_amax": np.asarray(jlin.x_amax[...]),
                     "w_amax": np.asarray(jlin.w_amax[...]),
                     "dy_scale": np.asarray(jfp8.dynamic_scale(
                         jnp.asarray(g), jnp.float8_e5m2)),
                     "y": np.asarray(y), "dx": np.asarray(dx),
                     "dw": np.asarray(dw), "db": np.asarray(db)})
    tol = dict(rtol=1e-5, atol=1e-3)
    for rank in pools[2].run(cases.fp8_linear_passes, x, w, b, g):
        rows = slice(4 * rank["index"], 4 * rank["index"] + 4)
        for got, jw in zip(rank["passes"], want):
            for key in ("x_amax", "w_amax", "dy_scale"):
                np.testing.assert_array_equal(got[key], jw[key],
                                              err_msg=key)
            np.testing.assert_allclose(got["y"], jw["y"][rows], **tol)
            np.testing.assert_allclose(got["dx"], jw["dx"][rows], **tol)
            for key in ("dw", "db"):
                np.testing.assert_allclose(got[key], jw[key], rtol=1e-5,
                                           atol=1e-5 * 8, err_msg=key)


@pytest.fixture(scope="module")
def jax_fp8_pass(weights):
    """JAX's tiny fp8_hybrid SigLIP on the whole batch: one gradient pass
    (which rolls every history once), its gradients and histories."""
    model = jax_cli._model_cls("siglip")(
        jax_cli._tiny_override(jax_preset(PRESET)), rngs=nnx.Rngs(SEED))
    jax_policy(model, "fp8_hybrid")
    images, text = _batch()
    grads = nnx.jit(nnx.grad(lambda m, a, b: jax_trainer.contrastive_loss_fn(
        m, a, b, kind="siglip")))(model, jnp.asarray(images),
                                  jnp.asarray(text.astype(np.int32)))
    grads = {".".join(str(p) for p in path): np.asarray(v[...])
             for path, v in nnx.to_flat_state(grads)}
    hist = {k: v for k, v in jax_state(model).items()
            if k.endswith("_amax")}
    return _port_arrays(grads), _port_arrays(hist)


def _hold_fp8_step(ranks: list[dict], one: dict, jax_fp8_pass,
                   inexact: str | None = None, grad_tol: float = 1e-4
                   ) -> None:
    """Every rank's histories equal the other ranks' and the single
    process's ``one`` bit for bit (those whose names end in ``inexact``:
    the ranks' bit for bit, the single process's to 1e-6), and JAX's
    whole-batch pass to f32 rounding; the gradients within ``grad_tol`` of
    their largest of JAX's."""
    jgrads, jhist = jax_fp8_pass
    assert set(one["hist"]) == set(jhist) and len(jhist) == 110
    for name, want in jhist.items():
        for got in ranks:
            np.testing.assert_array_equal(got["hist"][name],
                                          ranks[0]["hist"][name],
                                          err_msg=name)
        if inexact is not None and name.endswith(inexact):
            np.testing.assert_allclose(ranks[0]["hist"][name],
                                       one["hist"][name], rtol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(ranks[0]["hist"][name],
                                          one["hist"][name], err_msg=name)
        np.testing.assert_allclose(ranks[0]["hist"][name], want, rtol=1e-5,
                                   err_msg=name)
    floor = 1e-3 * max(np.abs(g).max() for g in jgrads.values())
    for name, want in jgrads.items():
        peak = max(np.abs(want).max(), floor)
        for got in ranks:
            err = np.abs(got["grads"][name] - want).max()
            assert err <= grad_tol * peak, (name, err / peak)


@pytest.fixture(scope="module")
def fp8_single(weights):
    images, text = _batch()
    return cases.fp8_step(PRESET, None, None, images, text, weights)


def test_fp8_siglip_step_under_data_parallel(pools, weights, jax_fp8_pass,
                                             fp8_single):
    images, text = _batch()
    ranks = pools[2].run(cases.fp8_step, PRESET, {"data": 2}, "dp", images,
                         text, weights)
    _hold_fp8_step(ranks, fp8_single, jax_fp8_pass)


@pytest.mark.parametrize("axes,rules,inexact,grad_tol", [
    ({"data": 1, "model": 2}, "tp", None, 1e-4),
    ({"data": 1, "seq": 2}, "sp", "attn.out.x_amax", 2e-4)],
    ids=["tp", "sp"])
def test_fp8_siglip_histories_under_model_and_seq_axes(
        pools, weights, jax_fp8_pass, fp8_single, axes, rules, inexact,
        grad_tol):
    # the amax is the max over model (a sliced weight, a row-parallel
    # input, a column-parallel output's gradient) and over seq. Under sp
    # the attention output comes from the sequence-parallel attention's
    # own arithmetic (a row's hops summed in another order): the output
    # projection's input history is one f32 step off the single process's
    # in 5 of its 16 blocks, equal on the two ranks; those steps flip a few
    # e4m3 roundings of that input, which moves block 0's attention
    # weight gradients by 1.1e-4 of their largest from the single process
    # and JAX alike
    images, text = _batch()
    ranks = pools[2].run(cases.fp8_step, PRESET, axes, rules, images, text,
                         weights)
    _hold_fp8_step(ranks, fp8_single, jax_fp8_pass, inexact, grad_tol)


# -- the model and stage axes ------------------------------------------------------

LAYOUTS = {"tp": ("data=1,model=2", 2), "pp": ("data=1,stage=2", 2)}


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    out = {}
    # int8_qk keeps no state across steps: one step says it all
    for precision, rules, steps in (("fp8_hybrid", "tp", 2),
                                    ("int8_qk", "tp", 1),
                                    ("int8_qk", "pp", 1)):
        mesh, n = LAYOUTS[rules]
        path = tmp_path_factory.mktemp("jax") / f"{precision}-{rules}.jsonl"
        assert jax_cli.main(_argv(
            "--steps", str(steps), "--lr", "0", "--precision", precision,
            "--mesh",
            mesh, "--rules", rules, "--max-devices", str(n),
            "--metrics-file", str(path))) == 0
        out[precision, rules] = _losses(path)
    return out


@pytest.mark.parametrize("precision,rules", [
    ("fp8_hybrid", "tp"), ("int8_qk", "tp"), ("int8_qk", "pp")])
def test_quantized_losses_match_the_jax_cli(pools, tmp_path, weights,
                                           jax_losses, precision, rules):
    want = jax_losses[precision, rules]
    mesh, n = LAYOUTS[rules]
    path = tmp_path / "port.jsonl"
    res = pools[n].run(cases.train_cli, _argv(
        "--steps", str(len(want)), "--lr", "0", "--device", "cpu",
        "--precision",
        precision, "--metrics-file", str(path), "--mesh", mesh, "--rules",
        rules), weights)
    assert [r["rc"] for r in res] == [0] * n
    np.testing.assert_allclose(_losses(path), want, rtol=LOSS_RTOL)


def test_fp8_under_pp_matches_the_single_process(pools, tmp_path, weights,
                                                 monkeypatch):
    from test_torch_data_train import port_cli_from
    base = _argv("--steps", "3", "--device", "cpu", "--precision",
                 "fp8_hybrid")
    path = tmp_path / "pp.jsonl"
    res = pools[2].run(cases.train_cli, base + [
        "--metrics-file", str(path), "--mesh", "data=1,stage=2", "--rules",
        "pp", "--pipeline-microbatches", "1"], weights)
    assert [r["rc"] for r in res] == [0, 0]
    port_cli = port_cli_from(monkeypatch, weights, PRESET)
    assert port_cli(base + ["--metrics-file", str(tmp_path / "one.jsonl")]) \
        == 0
    np.testing.assert_allclose(_losses(path), _losses(tmp_path / "one.jsonl"),
                               rtol=LOSS_RTOL)
    assert not cli.torch.distributed.is_initialized()


def test_model_slices_and_fp8_operands_are_dense(pools, weights):
    # the fp8 GEMM on the card takes contiguous operands only: a weight
    # cut on its input features must not stay a view striding by the row,
    # nor a gathered projection's gradient slice reach the GEMM as one
    images, text = _batch()
    for got in pools[2].run(cases.mesh_gradients, PRESET,
                            {"data": 1, "model": 2}, "tp", images, text,
                            weights=weights, precision="fp8_hybrid"):
        assert got["local"]["vision.encoder.blocks.0.attn.out.weight"] == \
            ((64, 32), False)
        assert all(got["dense"].values()), [
            n for n, d in got["dense"].items() if not d]
        # 55 Linears, each one forward GEMM and two backward ones
        assert len(got["fp8_dense"]) == 3 * 55 and all(got["fp8_dense"])


def test_load_jax_params_carries_circular_fp8_histories():
    # a JAX model of --pipeline-virtual 2 on two stages stores its layers
    # in circular order, histories included: each row reaches its block
    from jimm_tpu import configs as jax_configs
    from jimm_tpu_torch.parallel import pipeline
    from jimm_tpu_torch.quant.policy import DEFAULT_AMAX_HISTORY
    runtime = {"pipeline": True, "pp_virtual": 2, "pp_stages": 2,
               "pp_microbatches": 2}
    jmodel = jax_cli._model_cls("siglip")(jax_configs.with_runtime(
        jax_cli._tiny_override(jax_preset(PRESET)), **runtime),
        rngs=nnx.Rngs(SEED))
    jax_policy(jmodel, "fp8_hybrid")
    rng = np.random.default_rng(3)
    state = {k: (rng.random(v.shape).astype(np.float32)
                 if k.endswith("_amax") else v)
             for k, v in jax_state(jmodel).items()}
    key = "vision.encoder.blocks.mlp.fc1.x_amax"
    assert state[key].shape == (4, DEFAULT_AMAX_HISTORY)
    model = cases.tiny_model(PRESET, runtime, precision="fp8_hybrid")
    load_jax_params(model, state)
    order = pipeline.circular_layer_order(4, 2, 2)
    own = dict(model.named_buffers())
    for row, layer in enumerate(order):
        np.testing.assert_array_equal(
            own[f"vision.encoder.blocks.{layer}.mlp.fc1.x_amax"].numpy(),
            state[key][row])


@pytest.mark.parametrize("precision", ["fp8_hybrid", "int8_qk"])
def test_fsdp_tp_step0_gradients_match_the_single_process(pools, weights,
                                                          precision):
    images, text = _batch()
    want = cases.step0_gradients(cases.tiny_model(
        PRESET, weights=weights, precision=precision), images, text)
    got = pools[4].run(cases.mesh_gradients, PRESET,
                       {"data": 2, "model": 2}, "fsdp_tp", images, text,
                       weights=weights, precision=precision)
    for rank, g in enumerate(got):
        assert sorted(g["norms"]) == sorted(want["norms"]), rank
        for name, w in want["norms"].items():
            np.testing.assert_allclose(g["norms"][name], w, rtol=GRAD_RTOL,
                                       atol=1e-7, err_msg=f"{rank} {name}")
        np.testing.assert_allclose(g["global_norm"], want["global_norm"],
                                   rtol=GRAD_RTOL)
