"""The port's training slice on the CPU against the JAX package: losses,
schedules, clipping, the weight-decay mask, synthetic data, FLOP counts,
three optimizer steps of a tiny SigLIP (flash + fused LayerNorm, JAX weights
carried across), and the ``train`` command."""

import json
import math
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from jimm_tpu import configs as jax_configs
from jimm_tpu.data import synthetic as jax_synthetic
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.train import losses as jax_losses
from jimm_tpu.train import metrics as jax_metrics
from jimm_tpu.train import trainer as jax_trainer
from jimm_tpu_torch import configs
from jimm_tpu_torch.data import synthetic
from jimm_tpu_torch.models.siglip import SigLIP, _port_entries, load_jax_params
from jimm_tpu_torch.train import losses, metrics, trainer
from test_torch_siglip import jax_params, tiny_config

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
LR = 1e-3
STEPS = 3


def _port_arrays(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """JAX dotted-path arrays -> the port's parameter names and layouts."""
    return dict(pair for key, arr in flat.items()
                for pair in _port_entries(key, np.asarray(arr, np.float32)))


@pytest.mark.parametrize("kind", ["siglip", "clip"])
def test_losses_match_jax(kind):
    rng = np.random.default_rng(0)
    img, txt = (rng.standard_normal((6, 16), np.float32) for _ in range(2))
    scale, bias = np.float32(2.3), np.float32(-4.0)
    if kind == "siglip":
        want = jax_losses.sigmoid_pairwise_loss(
            jnp.asarray(img), jnp.asarray(txt), scale, bias)
        got = losses.sigmoid_pairwise_loss(
            torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(scale),
            torch.tensor(bias))
    else:
        want = jax_losses.clip_softmax_loss(jnp.asarray(img), jnp.asarray(txt),
                                            scale)
        got = losses.clip_softmax_loss(torch.from_numpy(img),
                                       torch.from_numpy(txt),
                                       torch.tensor(scale))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("cfg", [
    dict(), dict(warmup_steps=4), dict(total_steps=10),
    dict(warmup_steps=3, total_steps=10),
    dict(warmup_steps=2, total_steps=9, min_lr_ratio=0.1)])
def test_schedule_matches_optax(cfg):
    want = jax_trainer.make_schedule(jax_trainer.OptimizerConfig(**cfg))
    got = trainer.make_schedule(trainer.OptimizerConfig(**cfg))
    for k in range(13):
        np.testing.assert_allclose(got(k), float(want(k)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {k}")


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s, np.float32) * scale
             for s in ((3, 4), (5,), ())]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(np.array(g))
    norm = trainer.clip_by_global_norm_(params, 1.0)
    assert math.isclose(norm.item(), float(np.sqrt(sum(
        (g.astype(np.float64) ** 2).sum() for g in grads))), rel_tol=1e-6)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


def test_synthetic_pairs_match_jax():
    jgen = jax_synthetic.contrastive_pairs(4, image_size=32, vocab_size=50,
                                           seq_len=6, seed=3)
    tgen = synthetic.contrastive_pairs(4, image_size=32, vocab_size=50,
                                       seq_len=6, seed=3)
    for _ in range(2):
        (ji, jt), (ti, tt) = next(jgen), next(tgen)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tt, jt)
    jb = jax_synthetic.blob_classification(3, num_frames=2, seed=1)
    tb = synthetic.blob_classification(3, num_frames=2, seed=1)
    for a, b in zip(next(tb), next(jb)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["siglip-base-patch16-256",
                                  "siglip-so400m-patch14-384"])
def test_flop_counts_match_jax(name):
    assert (metrics.train_step_flops(configs.preset(name), 128)
            == jax_metrics.train_step_flops(jax_configs.preset(name), 128))


def test_mfu_and_peak():
    assert metrics.mfu(989e12, 1.0, 989.0) == pytest.approx(1.0)
    assert metrics.mfu(None, 1.0, 989.0) is None
    assert metrics.mfu(1.0, 0.0, 989.0) is None
    assert metrics.device_peak_tflops("cpu") is None


# -- the slice as a whole -----------------------------------------------------

@pytest.fixture(scope="module")
def run():
    """Three AdamW steps (warmup 1, cosine to step 3, weight decay 0.5,
    clipping at 1) on one fixed batch, in both packages from the same
    weights; plus the first step's gradients."""
    jmodel = JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0))
    params0 = jax_params(jmodel)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 64, 64, 3), np.float32)
    text = rng.integers(0, 100, (4, 8)).astype(np.int32)
    opt_kw = dict(learning_rate=LR, weight_decay=0.5, warmup_steps=1,
                  total_steps=STEPS)

    ji, jt = jnp.asarray(images), jnp.asarray(text)
    jgrads = nnx.jit(nnx.grad(lambda m, a, b: jax_trainer.contrastive_loss_fn(
        m, a, b, kind="siglip")))(jmodel, ji, jt)
    jgrads = {".".join(str(p) for p in path): np.asarray(v[...])
              for path, v in nnx.to_flat_state(jgrads)}
    jopt = jax_trainer.make_optimizer(jmodel, jax_trainer.OptimizerConfig(
        **opt_kw))
    jstep = jax_trainer.make_contrastive_train_step("siglip")
    jlosses = [float(jstep(jmodel, jopt, ji, jt)["loss"])
               for _ in range(STEPS)]

    tmodel = SigLIP(tiny_config(configs), device="cpu")
    load_jax_params(tmodel, params0)
    ti, tt = torch.from_numpy(images), torch.from_numpy(text).long()
    trainer.contrastive_loss_fn(tmodel, ti, tt, kind="siglip").backward()
    tgrads = {n: p.grad.clone() for n, p in tmodel.named_parameters()}
    topt = trainer.make_optimizer(tmodel, trainer.OptimizerConfig(**opt_kw))
    tstep = trainer.make_contrastive_train_step("siglip")
    tlosses = [tstep(tmodel, topt, ti, tt)["loss"].item()
               for _ in range(STEPS)]
    return dict(params0=params0, jgrads=_port_arrays(jgrads), tgrads=tgrads,
                jlosses=jlosses, tlosses=tlosses, tmodel=tmodel,
                jparams=_port_arrays(jax_params(jmodel)))


def test_first_step_grads_match_jax(run):
    assert set(run["tgrads"]) == set(run["jgrads"])
    for name, got in run["tgrads"].items():
        np.testing.assert_allclose(got.numpy(), run["jgrads"][name],
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_step_losses_match_jax(run):
    np.testing.assert_allclose(run["tlosses"], run["jlosses"], rtol=1e-5)
    assert run["tlosses"][-1] < run["tlosses"][0]


def test_params_after_three_steps_match_jax(run):
    """Adam divides each gradient by its own running scale, so an element
    whose gradient is near 0 (within ~10x the gradients' agreement) can move
    by up to the learning rate either way in either package: those get
    2 * lr * steps. Every other element must agree to 0.1 * lr."""
    jg = run["jgrads"]
    for name, p in run["tmodel"].named_parameters():
        got, want = p.detach().numpy(), run["jparams"][name]
        tol = np.where(np.abs(jg[name]) < 1e-4, 2 * LR * STEPS, 0.1 * LR)
        bad = np.abs(got - want) > tol
        assert not bad.any(), (name, np.abs(got - want).max())


def test_decay_mask_matches_optax(run):
    """The port decays exactly the parameters the JAX mask (ndim > 1 on the
    stacked JAX params) decays: block LayerNorm scales and biases yes,
    ln_post, the head's biases and LayerNorm, ln_final and the scalars no."""
    want = {}
    for key, arr in run["params0"].items():
        for name, _ in _port_entries(key, np.asarray(arr)):
            want[name] = np.ndim(arr) > 1
    got = {n: trainer.decays(n, p)
           for n, p in run["tmodel"].named_parameters()}
    assert got == want
    assert got["vision.encoder.blocks.0.ln1.weight"]
    assert not got["vision.head.ln.weight"] and not got["logit_scale"]


def test_block_layer_norm_moves_as_in_optax(run):
    """With decay on, a block LN scale (decayed only because the JAX blocks
    are stacked) lands where optax puts it; without the decay it would be
    off by lr * wd * (sum of step lrs / lr) * scale, ~7.5e-4 here, far
    above the 1e-4 tolerance."""
    name = "text.encoder.blocks.1.ln2.weight"
    got = dict(run["tmodel"].named_parameters())[name].detach().numpy()
    np.testing.assert_allclose(got, run["jparams"][name], atol=0.1 * LR)


# -- the train command --------------------------------------------------------

def _train(*argv: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "jimm_tpu_torch", "train", "--tiny", *argv],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)


def test_train_cli_on_the_cpu():
    proc = _train("--device", "cpu", "--steps", "2", "--batch-size", "4",
                  "--log-every", "1", "--attn-impl", "flash", "--ln-impl",
                  "fused")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    steps = [r for r in lines if "step" in r]
    assert [r["step"] for r in steps] == [0, 1]
    assert all(math.isfinite(r["loss"]) for r in steps)
    assert lines[-1]["status"] == "trained" and lines[-1]["device"] == "cpu"


def test_train_cli_needs_the_card_or_asks_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    proc = _train("--steps", "1")
    assert proc.returncode != 0
    assert "RuntimeError: CUDA is not available" in proc.stderr


@pytest.mark.parametrize("flag,match", [
    # the reference's refusal that --data brings (the flag itself is
    # ported): the indexed loader reads TFRecord shards only
    (["--loader", "grain", "--data", "x.tar"],
     "--loader grain reads tfrecord shards"),
    # the ring losses need a mesh, and --mesh the ranks it names (--mesh
    # and the ring losses are ported: tests/test_torch_parallel_*.py;
    # --profile-dir, --prof-ring and --tensorboard-dir, once refused here,
    # too: tests/test_torch_profile_cli.py; so are the pipeline flags:
    # tests/test_torch_parallel_pp.py, and --max-devices, which checks
    # the ranks there are as JAX checks its devices:
    # tests/test_torch_elastic.py)
    (["--loss", "siglip_ring"], "--loss siglip_ring needs --mesh"),
    (["--mesh", "data=2"], r"mesh \{'data': 2\} != 1 devices"),
    (["--loss", "clip_ring"], "--loss clip_ring needs --mesh"),
    pytest.param(["--max-devices", "2", "--mesh", "data=2", "--preset",
                  "clip-vit-base-patch16"],
                 r"--max-devices 2 out of range \(1\.\.1 visible\)",
                 id="flag4-ROADMAP")])
def test_train_cli_names_the_roadmap_for_unported_flags(flag, match):
    from jimm_tpu_torch.cli import build_parser, cmd_train
    args = build_parser().parse_args(["train", "--tiny", "--device", "cpu",
                                      *flag])
    with pytest.raises(SystemExit, match=match):
        cmd_train(args)
