"""Sigmoid attention (kernel row 6, row 7's sigmoid kind) on the CPU against
the JAX package: the plain versions behind ``sigmoid_attention`` and its
autograd Function against JAX's Pallas kernels in interpret mode and its
einsum oracle, forward and backward; exact zeros for masked keys and for
rows with no key; the ``-log(Sk)`` default bias; the dispatch's refusals;
and a tiny SigLIP built with ``attn_impl="sigmoid"``, forward and three
AdamW steps, at ``test_torch_train.py``'s tolerances."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import configs as jax_configs
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.ops.attention import dot_product_attention as jax_dpa
from jimm_tpu.ops.attention import reference_sigmoid_attention as jax_oracle
from jimm_tpu.ops.flash_attention import sigmoid_attention as jax_sigmoid
from jimm_tpu.train import trainer as jax_trainer
from jimm_tpu_torch import configs
from jimm_tpu_torch.models.siglip import SigLIP, load_jax_params
from jimm_tpu_torch.nn.transformer import Attention
from jimm_tpu_torch.ops import attention
from jimm_tpu_torch.ops import flash_attention as fa
from jimm_tpu_torch.train import trainer
from test_torch_siglip import jax_params, tiny_config
from test_torch_train import LR, STEPS, _port_arrays

#: f32 contract (the JAX package's sigmoid kernel against its oracle)
TOL = dict(atol=1e-5, rtol=1e-5)

_CASES = [(sq, sk, d, causal, masked)
          for sq, sk in [(1, 1), (5, 5), (1, 257), (257, 257)]
          for d in (64, 80)
          for causal in ((False, True) if sq == sk else (False,))
          for masked in (False, True)]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(sq: int, sk: int, d: int, masked: bool, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, 2, d), np.float32)
    k, v = (rng.standard_normal((2, sk, 2, d), np.float32) for _ in range(2))
    do = rng.standard_normal((2, sq, 2, d), np.float32)
    mask = None
    if masked:
        mask = rng.random((2, sk)) > 0.4
        mask[1] = False  # a sample with no key to attend
    return q, k, v, do, mask


@pytest.mark.parametrize("sq,sk,d,causal,masked", _CASES)
def test_sigmoid_attention_matches_jax(sq, sk, d, causal, masked):
    """Forward and backward against JAX's sigmoid kernels (interpret
    mode), and the forward against its einsum oracle."""
    q, k, v, do, mask = _inputs(sq, sk, d, masked, sq + 3 * sk + d)
    jmask = None if mask is None else jnp.asarray(mask)
    fn = functools.partial(jax_sigmoid, is_causal=causal, mask=jmask)
    want, vjp = jax.vjp(jax.jit(fn), jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    oracle = jax_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        is_causal=causal, mask=jmask)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    before = (fa.sigmoid_launches, fa.sigmoid_bwd_launches)
    got = fa.sigmoid_attention(tq, tk, tv, is_causal=causal,
                               mask=None if mask is None else _t(mask))
    assert type(got.grad_fn).__name__ == "SigmoidAttentionFnBackward"
    got.backward(_t(do))
    assert (fa.sigmoid_launches, fa.sigmoid_bwd_launches) == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(oracle),
                               **TOL)
    for t, g in zip((tq, tk, tv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_masked_keys_and_empty_rows_are_exactly_zero(causal):
    q, k, v, do, mask = _inputs(33, 33, 64, True, 9)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o = fa.sigmoid_attention(tq, tk, tv, is_causal=causal, mask=_t(mask))
    o.backward(_t(do))
    # sample 1 has no key: its rows are 0, not finite garbage
    assert (o[1] == 0).all() and (tq.grad[1] == 0).all()
    # masked keys get no attention and no gradient
    assert (tk.grad[_t(~mask)] == 0).all() and (tv.grad[_t(~mask)] == 0).all()
    want = np.asarray(jax_sigmoid(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), is_causal=causal,
                                  mask=jnp.asarray(mask)))
    assert (want[1] == 0).all()
    # a key that is masked contributes nothing: change its value, o stays
    v2 = v.copy()
    v2[~mask] = 1e4
    o2 = fa.sigmoid_attention(tq, tk, _t(v2), is_causal=causal,
                              mask=_t(mask))
    torch.testing.assert_close(o2, o, atol=0, rtol=0)


def test_default_logit_bias_is_minus_log_of_the_padded_key_length():
    """``-log(k.shape[1])``: keys past a padding mask count, as in JAX."""
    q, k, v, _, mask = _inputs(5, 9, 64, True, 4)
    got = fa.sigmoid_attention(_t(q), _t(k), _t(v), mask=_t(mask))
    explicit = fa.sigmoid_attention(_t(q), _t(k), _t(v), mask=_t(mask),
                                    logit_bias=-math.log(9))
    torch.testing.assert_close(got, explicit, atol=0, rtol=0)
    real = int(mask[0].sum())
    assert real < 9
    other = fa.sigmoid_attention(_t(q), _t(k), _t(v), mask=_t(mask),
                                 logit_bias=-math.log(real))
    assert not torch.allclose(got[0], other[0])
    want = jax_sigmoid(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert fa.default_logit_bias(0) == 0.0


def test_dispatch_matches_jax_and_refuses_what_jax_refuses():
    q, k, v, _, mask = _inputs(5, 5, 64, True, 6)
    for keys in (mask, mask[:, None, None, :]):
        got = attention.dot_product_attention(_t(q), _t(k), _t(v),
                                              mask=_t(keys), impl="sigmoid")
        want = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mask=jnp.asarray(keys), impl="sigmoid")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cases = [dict(bias=np.zeros((2, 5, 5), np.float32)),
             dict(mask=np.ones((2, 2, 5, 5), bool))]
    for kw in cases:
        with pytest.raises(ValueError) as jax_err:
            jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    impl="sigmoid", **{n: jnp.asarray(a)
                                       for n, a in kw.items()})
        with pytest.raises(ValueError) as port_err:
            attention.dot_product_attention(_t(q), _t(k), _t(v),
                                            impl="sigmoid",
                                            **{n: _t(a)
                                               for n, a in kw.items()})
        assert str(port_err.value) == str(jax_err.value)


def test_sigmoid_refuses_other_devices():
    q = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fa.sigmoid_attention(q, q, q)


# -- the model ----------------------------------------------------------------

def sigmoid_config(cfg_mod):
    return cfg_mod.with_runtime(tiny_config(cfg_mod), attn_impl="sigmoid")


@pytest.fixture(scope="module")
def run():
    """A tiny SigLIP with every attention (the MAP probe's included) on
    sigmoid attention in both packages from the same weights: the forward,
    the first step's gradients and three AdamW steps (warmup 1, cosine to
    step 3, weight decay 0.5, clipping at 1) on one fixed batch."""
    jmodel = JaxSigLIP(sigmoid_config(jax_configs), rngs=nnx.Rngs(0))
    params0 = jax_params(jmodel)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 64, 64, 3), np.float32)
    text = rng.integers(0, 100, (4, 8)).astype(np.int32)
    ji, jt = jnp.asarray(images), jnp.asarray(text)
    opt_kw = dict(learning_rate=LR, weight_decay=0.5, warmup_steps=1,
                  total_steps=STEPS)
    jlogits = np.asarray(nnx.jit(lambda m, a, b: m(a, b))(jmodel, ji, jt))
    jgrads = nnx.jit(nnx.grad(lambda m, a, b: jax_trainer.contrastive_loss_fn(
        m, a, b, kind="siglip")))(jmodel, ji, jt)
    jgrads = {".".join(str(p) for p in path): np.asarray(v[...])
              for path, v in nnx.to_flat_state(jgrads)}
    jopt = jax_trainer.make_optimizer(jmodel, jax_trainer.OptimizerConfig(
        **opt_kw))
    jstep = jax_trainer.make_contrastive_train_step("siglip")
    jlosses = [float(jstep(jmodel, jopt, ji, jt)["loss"])
               for _ in range(STEPS)]

    tmodel = SigLIP(sigmoid_config(configs), device="cpu")
    load_jax_params(tmodel, params0)
    ti, tt = _t(images), _t(text).long()
    with torch.no_grad():
        tlogits = tmodel(ti, tt).numpy()
    trainer.contrastive_loss_fn(tmodel, ti, tt, kind="siglip").backward()
    tgrads = {n: p.grad.clone() for n, p in tmodel.named_parameters()}
    topt = trainer.make_optimizer(tmodel, trainer.OptimizerConfig(**opt_kw))
    tstep = trainer.make_contrastive_train_step("siglip")
    tlosses = [tstep(tmodel, topt, ti, tt)["loss"].item()
               for _ in range(STEPS)]
    return dict(jlogits=jlogits, tlogits=tlogits,
                jgrads=_port_arrays(jgrads), tgrads=tgrads, jlosses=jlosses,
                tlosses=tlosses, tmodel=tmodel,
                jparams=_port_arrays(jax_params(jmodel)))


def test_sigmoid_model_runs_every_attention_on_sigmoid(run):
    attns = [m for m in run["tmodel"].modules() if isinstance(m, Attention)]
    assert len(attns) == 5 and all(m.impl == "sigmoid" for m in attns)


def test_sigmoid_model_forward_matches_jax(run):
    np.testing.assert_allclose(run["tlogits"], run["jlogits"], **TOL)


def test_sigmoid_model_first_step_grads_match_jax(run):
    assert set(run["tgrads"]) == set(run["jgrads"])
    for name, got in run["tgrads"].items():
        np.testing.assert_allclose(got.numpy(), run["jgrads"][name],
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_sigmoid_model_steps_match_jax(run):
    """Losses at rtol 1e-5; parameters as in test_torch_train.py: an element
    whose first gradient is near 0 may move by up to the learning rate
    either way in either package (2 lr a step), every other within 0.1 lr."""
    np.testing.assert_allclose(run["tlosses"], run["jlosses"], rtol=1e-5)
    assert run["tlosses"][-1] < run["tlosses"][0]
    jg = run["jgrads"]
    for name, p in run["tmodel"].named_parameters():
        got, want = p.detach().numpy(), run["jparams"][name]
        tol = np.where(np.abs(jg[name]) < 1e-4, 2 * LR * STEPS, 0.1 * LR)
        assert not (np.abs(got - want) > tol).any(), (
            name, np.abs(got - want).max())
