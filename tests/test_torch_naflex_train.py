"""NaFlex training on the CPU against the JAX package: a tiny SigLIP2 (JAX
weights carried across, flash attention and fused LayerNorm on both sides)
takes one and three AdamW steps on one fixed mixed-grid NaFlex batch;
gradients, losses and parameters must agree at ``test_torch_train.py``'s
tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import configs as jax_configs
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.train import trainer as jax_trainer
from jimm_tpu_torch import configs
from jimm_tpu_torch.data import preprocess, synthetic
from jimm_tpu_torch.models.siglip import SigLIP, load_jax_params
from jimm_tpu_torch.train import trainer
from test_torch_siglip import jax_params, tiny_config
from test_torch_train import LR, STEPS, _port_arrays


@pytest.fixture(scope="module")
def run():
    """STEPS AdamW steps (warmup 1, cosine to STEPS, weight decay 0.5,
    clipping at 1) on one NaFlex batch in both packages from the same
    weights; the first step's gradients, and the parameters after the first
    and the last step."""
    jmodel = JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0))
    params0 = jax_params(jmodel)
    # the batch resized by the numpy plain version, the one these
    # tolerances were set on: one conv-bias gradient is a sum of ~+-20
    # terms that cancels to ~0.04, and the native resize's 1e-7 changes to
    # the patches move its f32 rounding past atol 1e-5 between the packages
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(synthetic, "resize_bilinear",
                   preprocess.resize_bilinear_plain)
        (patches, shapes, mask), text = next(
            synthetic.naflex_contrastive_pairs(
                4, patch_size=16, max_num_patches=16, vocab_size=100,
                seq_len=8, seed=2))
    assert len({tuple(s) for s in shapes}) > 1 and not mask.all()
    opt_kw = dict(learning_rate=LR, weight_decay=0.5, warmup_steps=1,
                  total_steps=STEPS)

    jimg = tuple(map(jnp.asarray, (patches, shapes, mask)))
    jt = jnp.asarray(text)
    jgrads = nnx.jit(nnx.grad(lambda m, a, b: jax_trainer.contrastive_loss_fn(
        m, a, b, kind="siglip")))(jmodel, jimg, jt)
    jgrads = {".".join(str(p) for p in path): np.asarray(v[...])
              for path, v in nnx.to_flat_state(jgrads)}
    jopt = jax_trainer.make_optimizer(jmodel, jax_trainer.OptimizerConfig(
        **opt_kw))
    jstep = jax_trainer.make_contrastive_train_step("siglip")
    jlosses, jparams1 = [], None
    for i in range(STEPS):
        jlosses.append(float(jstep(jmodel, jopt, jimg, jt)["loss"]))
        if i == 0:
            jparams1 = _port_arrays(jax_params(jmodel))

    tmodel = SigLIP(tiny_config(configs), device="cpu")
    load_jax_params(tmodel, params0)
    timg = (torch.from_numpy(patches), torch.from_numpy(shapes).long(),
            torch.from_numpy(mask))
    tt = torch.from_numpy(text).long()
    trainer.contrastive_loss_fn(tmodel, timg, tt, kind="siglip").backward()
    tgrads = {n: p.grad.clone() for n, p in tmodel.named_parameters()}
    topt = trainer.make_optimizer(tmodel, trainer.OptimizerConfig(**opt_kw))
    tstep = trainer.make_contrastive_train_step("siglip")
    tlosses, tparams1 = [], None
    for i in range(STEPS):
        tlosses.append(tstep(tmodel, topt, timg, tt)["loss"].item())
        if i == 0:
            tparams1 = {n: p.detach().clone()
                        for n, p in tmodel.named_parameters()}
    return dict(jgrads=_port_arrays(jgrads), tgrads=tgrads, jlosses=jlosses,
                tlosses=tlosses, jparams1=jparams1, tparams1=tparams1,
                tparams=dict(tmodel.named_parameters()),
                jparams=_port_arrays(jax_params(jmodel)))


def test_naflex_step_grads_match_jax(run):
    assert set(run["tgrads"]) == set(run["jgrads"])
    for name, got in run["tgrads"].items():
        np.testing.assert_allclose(got.numpy(), run["jgrads"][name],
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    # the resampled position table and the patch Linear train
    for name in ("vision.pos_embed", "vision.patch_embed.conv.weight"):
        assert run["tgrads"][name].abs().sum() > 0, name


def test_naflex_step_losses_match_jax(run):
    np.testing.assert_allclose(run["tlosses"], run["jlosses"], rtol=1e-5)
    assert run["tlosses"][-1] < run["tlosses"][0]


@pytest.mark.parametrize("after", ["one_step", "three_steps"])
def test_params_after_naflex_steps_match_jax(run, after):
    """As ``test_torch_train.py``: an element whose first gradient is near 0
    may move by up to the learning rate either way in either package, and
    gets 2 * lr * steps; every other element must agree to 0.1 * lr."""
    got_all, want_all, steps = (
        (run["tparams1"], run["jparams1"], 1) if after == "one_step"
        else (run["tparams"], run["jparams"], STEPS))
    jg = run["jgrads"]
    for name, p in got_all.items():
        got, want = p.detach().numpy(), want_all[name]
        tol = np.where(np.abs(jg[name]) < 1e-4, 2 * LR * steps, 0.1 * LR)
        bad = np.abs(got - want) > tol
        assert not bad.any(), (name, np.abs(got - want).max())
