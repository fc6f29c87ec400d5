"""The rest of the port's training slice on the CPU against the JAX
package: Adam's first moment in another dtype (``moment_dtype``) against
optax, the ViT classifier steps, temporal clips, and the ``train`` command
for every family with remat, bf16 moments and ``--from-pretrained``.

Tolerances are stated per test."""

import json
import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from jimm_tpu import configs as jax_configs
from jimm_tpu.models.vit import VisionTransformer as JaxViT
from jimm_tpu.train import trainer as jax_trainer
from jimm_tpu_torch import cli, configs
from jimm_tpu_torch.models.common import _port_entries, load_jax_params
from jimm_tpu_torch.models.vit import VisionTransformer
from jimm_tpu_torch.train import trainer
from test_torch_siglip import jax_params

LR = 1e-3


# -- moment_dtype -------------------------------------------------------------

def _grads(step: int, dtype) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(10 + step)
    return {"kernel": rng.standard_normal((3, 4)).astype(dtype),
            "bias": rng.standard_normal(4).astype(dtype)}


def _port_linear(kernel: np.ndarray, bias: np.ndarray, dtype, cfg: dict):
    lin = torch.nn.Linear(3, 4, dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.astype(np.float32).T))
        lin.bias.copy_(torch.from_numpy(bias.astype(np.float32)))
    return lin, trainer.make_optimizer(lin, trainer.OptimizerConfig(**cfg))


def _optax(cfg: dict, params: dict):
    jmodel = nnx.Linear(3, 4, rngs=nnx.Rngs(0))
    tx = jax_trainer.make_optimizer(jmodel, jax_trainer.OptimizerConfig(
        **cfg)).tx
    return tx, tx.init(params)


def _set_grads(lin: torch.nn.Linear, g: dict, dtype) -> None:
    lin.weight.grad = torch.from_numpy(
        g["kernel"].astype(np.float32).T.copy()).to(dtype)
    lin.bias.grad = torch.from_numpy(g["bias"].astype(np.float32)).to(dtype)


def _check_mu(opt, lin, mu, moment: str, tdtype, tol: float) -> None:
    """exp_avg in ``moment``, exp_avg_sq in the parameter dtype, and mu
    within ``tol`` of the largest of optax's."""
    for p, want_mu in ((lin.weight, mu["kernel"].T), (lin.bias, mu["bias"])):
        state = opt.opt.state[p]
        assert state["exp_avg"].dtype == getattr(torch, moment)
        assert state["exp_avg_sq"].dtype == tdtype
        assert str(want_mu.dtype) == moment
        want_mu = np.asarray(want_mu, np.float32)
        np.testing.assert_allclose(state["exp_avg"].float().numpy(), want_mu,
                                   atol=tol * np.abs(want_mu).max(), rtol=0)


@pytest.mark.parametrize("moment", ["bfloat16", "float32"])
@pytest.mark.parametrize("param", ["bfloat16", "float32"])
def test_moment_dtype_matches_optax(param, moment):
    """Three AdamW updates with the first moment stored in ``moment``
    against optax, for f32 and for bf16 parameters."""
    if param == "bfloat16":
        _bf16_params_step_by_step(moment)
    else:
        _f32_params(moment)


def _f32_params(moment: str) -> None:
    """f32 parameters: three AdamW updates (weight decay 0.5 on the kernel,
    not the bias; clipping at 1; lr 1e-2) of a Linear's parameters from the
    same gradients, against optax's chain from the JAX ``make_optimizer``,
    the first moment stored in ``moment`` both ways. Tolerances: the
    parameters within 1e-2 of the learning rate (optax rounds ``b1 * mu``
    to a bf16 mu before adding, the port forms the new mu in f32), mu
    within 2^-7 of its largest value (bf16) or 1e-6 (f32)."""
    cfg = dict(learning_rate=1e-2, weight_decay=0.5, moment_dtype=moment)
    rng = np.random.default_rng(0)
    kernel = rng.standard_normal((3, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    jparams = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    tx, jstate = _optax(cfg, jparams)
    lin, opt = _port_linear(kernel, bias, torch.float32, cfg)
    for step in range(3):
        g = _grads(step, np.float32)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _set_grads(lin, g, torch.float32)
        opt.step()
    for p, want in ((lin.weight, jparams["kernel"].T),
                    (lin.bias, jparams["bias"])):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   atol=1e-2 * cfg["learning_rate"], rtol=0)
    mu = jstate[1][0].mu  # chain: (clip, adamw: (scale_by_adam, ...))
    _check_mu(opt, lin, mu, moment, torch.float32,
              2.0**-7 if moment == "bfloat16" else 1e-6)


def _bf16_params_step_by_step(moment: str) -> None:
    """bf16 parameters: each of three AdamW updates (weight decay 0.5 on
    the kernel, clipping at 1, lr 0.1; parameters of size ~0.25, so that a
    bf16 step is at most 2e-2 lr) against optax run in f32
    from the port's parameters of that step, with the same bf16-valued
    gradients and the first moment stored in ``moment``. The port forms
    the update in f32 and rounds the parameter once. Tolerance: each
    parameter within one bf16 step of optax's plus 1e-2 of the learning
    rate (half a step for the rounding; the port's bf16 second moment and
    optax's rounded ``b1 * mu`` move the update by under 1e-2 lr), where a
    lost step is lr off and the weight decay ~0.1 lr. mu within 2^-6 of its
    largest value (two bf16 steps: optax rounds ``b1 * mu`` and then the
    sum)."""
    import ml_dtypes
    cfg = dict(learning_rate=0.1, weight_decay=0.5, moment_dtype=moment)
    rng = np.random.default_rng(0)
    kernel = (0.25 * rng.standard_normal((3, 4))).astype(ml_dtypes.bfloat16)
    bias = (0.25 * rng.standard_normal(4)).astype(ml_dtypes.bfloat16)
    lin, opt = _port_linear(kernel, bias, torch.bfloat16, cfg)
    start = {"kernel": jnp.asarray(kernel, jnp.float32),
             "bias": jnp.asarray(bias, jnp.float32)}
    tx, jstate = _optax(cfg, start)
    for step in range(3):
        g = _grads(step, ml_dtypes.bfloat16)
        start = {"kernel": jnp.asarray(lin.weight.detach().float().numpy().T),
                 "bias": jnp.asarray(lin.bias.detach().float().numpy())}
        updates, jstate = tx.update(
            {k: jnp.asarray(v, jnp.float32) for k, v in g.items()}, jstate,
            start)
        want = optax.apply_updates(start, updates)
        _set_grads(lin, g, torch.bfloat16)
        opt.step()
        for p, w in ((lin.weight, want["kernel"].T), (lin.bias, want["bias"])):
            w = np.asarray(w, np.float32)
            ulp = np.spacing(np.abs(w).astype(ml_dtypes.bfloat16)).astype(
                np.float32)
            np.testing.assert_array_less(
                np.abs(p.detach().float().numpy() - w),
                ulp + 1e-2 * cfg["learning_rate"], err_msg=f"step {step}")
    _check_mu(opt, lin, jstate[1][0].mu, moment, torch.bfloat16, 2.0**-6)


def test_moment_dtype_none_keeps_adamw():
    """``moment_dtype=None`` is ``torch.optim.AdamW``'s own update, bit for
    bit, and an unknown dtype name raises."""
    torch.manual_seed(0)
    a, b = torch.nn.Linear(3, 4), torch.nn.Linear(3, 4)
    b.load_state_dict(a.state_dict())
    opt = trainer.make_optimizer(a, trainer.OptimizerConfig(
        grad_clip_norm=None))
    ref = torch.optim.AdamW([{"params": [b.weight], "weight_decay": 1e-4},
                             {"params": [b.bias], "weight_decay": 0.0}],
                            lr=LR, eps=1e-8)
    for step in range(3):
        g = _grads(step, np.float32)
        for lin in (a, b):
            lin.weight.grad = torch.from_numpy(g["kernel"].T.copy())
            lin.bias.grad = torch.from_numpy(g["bias"])
        opt.step()
        ref.step()
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    with pytest.raises(ValueError, match="not a torch float dtype"):
        trainer.make_optimizer(a, trainer.OptimizerConfig(moment_dtype="int8"))


# -- the classifier steps and temporal clips ----------------------------------

def vit_config(cfg_mod, frames: int = 1):
    vision = cfg_mod.VisionConfig(image_size=32, patch_size=16, width=64,
                                  depth=2, num_heads=2, mlp_dim=128,
                                  ln_eps=1e-12, num_frames=frames,
                                  pooling="map" if frames > 1 else "cls")
    return cfg_mod.with_runtime(cfg_mod.ViTConfig(vision=vision,
                                                  num_classes=5),
                                attn_impl="flash", ln_impl="fused")


def _images(frames: int) -> np.ndarray:
    rng = np.random.default_rng(frames)
    shape = (4, 32, 32, 3) if frames == 1 else (4, frames, 32, 32, 3)
    return rng.standard_normal(shape, np.float32)


LABELS = np.array([0, 1, 4, 4], np.int32)


def _pair(frames: int):
    """JAX and port ViTs with the same weights: JAX's from nnx.Rngs(0), its
    zero head replaced by a seeded random one."""
    jmodel = JaxViT(vit_config(jax_configs, frames), rngs=nnx.Rngs(0))
    jmodel.classifier.kernel[...] = jnp.asarray(
        np.random.default_rng(1).standard_normal((64, 5), np.float32))
    tmodel = VisionTransformer(vit_config(configs, frames), device="cpu")
    load_jax_params(tmodel, jax_params(jmodel))
    return jmodel, tmodel


@pytest.mark.parametrize("frames", [1, 2])
def test_forward_matches_jax(frames):
    """Logits at the model-parity tolerance (atol / rtol 1e-4); a temporal
    tower flattens its 2 x 4 patches into one 8-token sequence."""
    jmodel, tmodel = _pair(frames)
    x = _images(frames)
    want = nnx.jit(lambda m, x: m(x))(jmodel, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("frames", [1, 2])
def test_classifier_steps_match_jax(frames):
    """One classifier train step (AdamW, weight decay 0.5, clipping) and
    one eval step after it, against JAX's: loss rtol 1e-5, accuracy
    exactly, every parameter after the update within 0.1 lr (2 lr where
    its gradient is near 0, as in ``test_torch_train.py``)."""
    jmodel, tmodel = _pair(frames)
    x, y = _images(frames), LABELS
    opt_kw = dict(learning_rate=LR, weight_decay=0.5)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jopt = jax_trainer.make_optimizer(jmodel, jax_trainer.OptimizerConfig(
        **opt_kw))
    jgrads = nnx.grad(lambda m: optax.softmax_cross_entropy_with_integer_labels(
        m(jx), jy).mean())(jmodel)
    jgrads = {name: arr for path, v in nnx.to_flat_state(jgrads)
              for name, arr in _port_entries(
                  ".".join(str(p) for p in path), np.asarray(v[...]))}
    jm = jax_trainer.make_classifier_train_step()(jmodel, jopt, jx, jy)
    topt = trainer.make_optimizer(tmodel, trainer.OptimizerConfig(**opt_kw))
    tm = trainer.make_classifier_train_step()(tmodel, topt, tx, ty)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    assert tm["accuracy"].item() == float(jm["accuracy"])
    want = {name: arr for key, v in jax_params(jmodel).items()
            for name, arr in _port_entries(key, v)}
    for name, p in tmodel.named_parameters():
        tol = np.where(np.abs(jgrads[name]) < 1e-4, 2 * LR, 0.1 * LR)
        bad = np.abs(p.detach().numpy() - want[name]) > tol
        assert not bad.any(), name
    je = jax_trainer.make_classifier_eval_step()(jmodel, jx, jy)
    te = trainer.make_classifier_eval_step()(tmodel, tx, ty)
    np.testing.assert_allclose(te["loss"].item(), float(je["loss"]),
                               rtol=1e-4)
    assert te["accuracy"].item() == float(je["accuracy"])


@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (4, 3, 32, 32, 3),
                                   (4, 2, 16, 16, 3)])
def test_temporal_shape_errors_match_jax(shape):
    """A temporal tower takes (B, T, H, W, C) clips with T = num_frames at
    its image size; anything else raises JAX's ValueError. A 4-D batch
    raises the temporal message in both."""
    jmodel = JaxViT(vit_config(jax_configs, 2), rngs=nnx.Rngs(0))
    tmodel = VisionTransformer(vit_config(configs, 2), device="cpu")
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as want:
        jmodel(jnp.asarray(x))
    with pytest.raises(ValueError) as got:
        tmodel(torch.from_numpy(x))
    assert str(got.value).replace("(", "").replace(")", "") == \
        str(want.value).replace("(", "").replace(")", "")


def test_temporal_presets_match_jax():
    for name in ("vit-temporal-small-patch16-224-f8",
                 "vit-temporal-base-patch16-224-f8"):
        cfg = configs.preset(name)
        assert cfg.vision.seq_len == 8 * 196 and cfg.vision.pooling == "map"
        assert cfg == configs.preset(name)  # frozen, hashable


# -- the train command --------------------------------------------------------

def _train(capsys, *argv: str) -> list[dict]:
    rc = cli.main(["train", "--device", "cpu", "--steps", "2",
                   "--batch-size", "4", "--log-every", "1", *argv])
    assert rc == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in lines[:-1]] == [0, 1]
    assert all(math.isfinite(r["loss"]) for r in lines[:-1])
    assert lines[-1]["status"] == "trained"
    return lines


@pytest.mark.parametrize("preset,family", [
    ("vit-base-patch16-224", "vit"), ("clip-vit-base-patch16", "clip"),
    ("vit-temporal-small-patch16-224-f8", "vit")])
def test_train_cli_families(capsys, preset, family):
    lines = _train(capsys, "--tiny", "--preset", preset, "--attn-impl",
                   "flash", "--ln-impl", "fused")
    summary = lines[-1]
    assert summary["family"] == family and summary["remat"] == "none"
    assert summary["model"] == f"{family}:{preset}:tiny"
    if family == "vit":
        assert summary["num_classes"] == 4
        assert all(0.0 <= r["accuracy"] <= 1.0 for r in lines[:-1])
        assert summary["num_frames"] == (8 if "temporal" in preset else 1)
    else:
        assert summary["accuracy"] is None


def test_train_cli_remat_and_bf16_moments(capsys):
    lines = _train(capsys, "--tiny", "--preset", "siglip-base-patch16-256",
                   "--remat", "dots+ln", "--moment-dtype", "bf16",
                   "--ln-impl", "fused")
    assert lines[-1]["remat"] == "dots+ln"
    assert lines[-1]["moment_dtype"] == "bfloat16"
    lines = _train(capsys, "--tiny", "--preset", "vit-base-patch16-224",
                   "--remat", "full", "--bf16-momentum", "--moment-dtype",
                   "f32")
    assert lines[-1]["remat"] == "full"
    assert lines[-1]["moment_dtype"] == "float32"  # --moment-dtype wins


def test_train_cli_from_pretrained_swaps_the_head(capsys, tmp_path):
    cfg = cli.tiny_override(configs.preset("vit-base-patch16-224"))
    VisionTransformer(cfg, device="cpu").save_pretrained(tmp_path)
    lines = _train(capsys, "--preset", "vit-base-patch16-224",
                   "--from-pretrained", str(tmp_path), "--num-classes", "10")
    summary = lines[-1]
    assert summary["fresh_head"] is True and summary["num_classes"] == 10
    assert summary["model"] == f"vit:{tmp_path}"
    # a head of the asked width is kept
    lines = _train(capsys, "--preset", "vit-base-patch16-224",
                   "--from-pretrained", str(tmp_path), "--num-classes",
                   "1000", "--image-size", "48")
    assert lines[-1]["fresh_head"] is False


@pytest.mark.parametrize("argv,match", [
    (["--tiny", "--from-pretrained", "x"], "--tiny conflicts with "
                                           "--from-pretrained"),
    (["--preemption-save"], "--preemption-save needs --ckpt-dir"),
    (["--remat", "dots+mlp"], "--remat: unknown remat_policy 'dots\\+mlp'"),
    (["--loss", "siglip_ring"], "--loss siglip_ring needs --mesh"),
    (["--remat", "dots+attn"], "never emits them; use attn_impl='saveable'"),
])
def test_train_cli_refusals(argv, match):
    args = cli.build_parser().parse_args(["train", "--device", "cpu", *argv])
    with pytest.raises((SystemExit, ValueError), match=match):
        cli.cmd_train(args)
