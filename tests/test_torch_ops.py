"""The port's ops (`jimm_tpu_torch/ops`) against the JAX package's on the
CPU. On a CPU tensor each kernel wrapper runs its plain version; the JAX
side runs its Pallas kernels in interpret mode, as the JAX suite does.
Inputs are made with numpy and handed to both."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jimm_tpu.ops import activations as jax_acts
from jimm_tpu.ops.attention import reference_attention as jax_reference
from jimm_tpu.ops.flash_attention import flash_attention_lse as jax_flash_lse
from jimm_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from jimm_tpu_torch.ops import activations, attention, flash_attention
from jimm_tpu_torch.ops import layer_norm as ln_mod

# f32 contract of both kernels: the JAX package states ~1e-5 against its
# einsum oracle (ops/flash_attention.py:35-37, tests/test_layer_norm.py)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("rows", [1, 7, 300])
@pytest.mark.parametrize("f", [64, 80, 768])
def test_layer_norm_matches_jax(rows, f):
    rng = np.random.default_rng(rows * 1000 + f)
    x = rng.standard_normal((rows, f), np.float32) * 3 + 0.5
    scale = rng.standard_normal(f, np.float32)
    bias = rng.standard_normal(f, np.float32)
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias), 1e-6))
    y, mu, rstd = ln_mod.layer_norm_fwd(_t(x), _t(scale), _t(bias), 1e-6)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(mu.numpy(), x64.mean(1), **TOL)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(x64.var(1) + 1e-6),
                               **TOL)


def _offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose base is ``nbytes`` past a 16-byte
    boundary."""
    pad = nbytes // t.element_size()
    store = torch.zeros(t.numel() + 16, dtype=t.dtype)
    skip = (-store.data_ptr() % 16) // t.element_size() + pad
    view = store[skip:skip + t.numel()].view(t.shape)
    view.copy_(t)
    return view


#: (rows, F, dtype, byte offset of x, of scale, body): the register body
#: takes F a multiple of a 16-byte vector (8 bf16, 4 f32) up to 2048 with
#: every base on a 16-byte boundary; the CTA body the rest
LN_BODIES = [
    (1, 64, torch.bfloat16, 0, 0, "register"),
    (7, 80, torch.bfloat16, 0, 0, "register"),
    (7, 80, torch.float32, 0, 0, "register"),
    (8192, 768, torch.bfloat16, 0, 0, "register"),
    (32768, 768, torch.float32, 0, 0, "register"),
    (5, 1024, torch.bfloat16, 0, 0, "register"),
    (5, 1152, torch.bfloat16, 0, 0, "register"),
    (5, 1152, torch.float32, 0, 0, "register"),
    (2, 2048, torch.float32, 0, 0, "register"),
    (3, 5000, torch.bfloat16, 0, 0, "cta"),
    (3, 5000, torch.float32, 0, 0, "cta"),
    (2, 2056, torch.bfloat16, 0, 0, "cta"),
    (2, 84, torch.bfloat16, 0, 0, "cta"),
    (2, 84, torch.float32, 0, 0, "register"),
    (3, 30, torch.float32, 0, 0, "cta"),
    (4, 768, torch.bfloat16, 4, 0, "cta"),
    (4, 768, torch.float32, 8, 0, "cta"),
    (4, 768, torch.bfloat16, 0, 2, "cta"),
    (4, 768, torch.bfloat16, 16, 0, "register"),
]


@pytest.mark.parametrize("rows,f,dtype,x_off,g_off,want", LN_BODIES)
def test_layer_norm_forward_body(rows, f, dtype, x_off, g_off, want):
    x = _offset(torch.randn(rows, f).to(dtype), x_off)
    scale = _offset(torch.randn(f).to(dtype), g_off)
    bias = torch.randn(f).to(dtype)
    assert ln_mod.forward_body(x, scale, bias) == want
    # on the CPU either way the plain version runs, on the same values
    y = ln_mod.layer_norm(x, scale, bias)
    assert torch.equal(y, ln_mod.layer_norm_plain(x.clone(), scale.clone(),
                                                  bias)[0])


#: (rows, F, dtype, byte offset of x, of scale, of dy, body): the backward's
#: register body takes what the forward's does, F a multiple of a 16-byte
#: vector (8 bf16, 4 f32) up to 2048 with x, scale and dy on 16-byte
#: boundaries; the CTA body the rest
LN_BWD_BODIES = [
    (8192, 768, torch.bfloat16, 0, 0, 0, "register"),
    (5, 1024, torch.bfloat16, 0, 0, 0, "register"),
    (5, 1152, torch.bfloat16, 0, 0, 0, "register"),
    (2, 2048, torch.bfloat16, 0, 0, 0, "register"),
    (1, 64, torch.bfloat16, 0, 0, 0, "register"),
    (32768, 768, torch.float32, 0, 0, 0, "register"),
    (5, 1024, torch.float32, 0, 0, 0, "register"),
    (5, 1152, torch.float32, 0, 0, 0, "register"),
    (2, 2048, torch.float32, 0, 0, 0, "register"),
    (7, 80, torch.float32, 0, 0, 0, "register"),
    (2, 2056, torch.bfloat16, 0, 0, 0, "cta"),
    (2, 2052, torch.float32, 0, 0, 0, "cta"),
    (3, 5000, torch.bfloat16, 0, 0, 0, "cta"),
    (3, 5000, torch.float32, 0, 0, 0, "cta"),
    (2, 84, torch.bfloat16, 0, 0, 0, "cta"),
    (2, 84, torch.float32, 0, 0, 0, "register"),
    (3, 30, torch.float32, 0, 0, 0, "cta"),
    (4, 768, torch.bfloat16, 4, 0, 0, "cta"),
    (4, 768, torch.float32, 8, 0, 0, "cta"),
    (4, 768, torch.bfloat16, 0, 2, 0, "cta"),
    (4, 768, torch.bfloat16, 0, 0, 6, "cta"),
    (4, 768, torch.float32, 0, 0, 4, "cta"),
    (4, 768, torch.bfloat16, 16, 0, 32, "register"),
]


@pytest.mark.parametrize("rows,f,dtype,x_off,g_off,dy_off,want",
                         LN_BWD_BODIES)
def test_layer_norm_backward_body(rows, f, dtype, x_off, g_off, dy_off,
                                  want):
    x = _offset(torch.randn(rows, f).to(dtype), x_off)
    scale = _offset(torch.randn(f).to(dtype), g_off)
    dy = _offset(torch.randn(rows, f).to(dtype), dy_off)
    assert ln_mod.backward_body(x, scale, dy) == want
    # on the CPU either way the plain version runs, on the same values
    _, mu, rstd = ln_mod.layer_norm_plain(x, scale, scale)
    got = ln_mod.layer_norm_bwd(x, scale, mu, rstd, dy)
    want_grads = ln_mod.layer_norm_bwd_plain(x.clone(), scale.clone(), mu,
                                             rstd, dy.clone())
    assert all(torch.equal(a, b) for a, b in zip(got, want_grads))


_ATTN_CASES = [(sq, sk, d, causal)
               for sq, sk in [(1, 5), (5, 5), (1, 257), (257, 257)]
               for d in (32, 64, 80)
               for causal in ((False, True) if sq == sk else (False,))]


@pytest.mark.parametrize("sq,sk,d,causal", _ATTN_CASES)
def test_flash_attention_matches_jax(sq, sk, d, causal):
    rng = np.random.default_rng(sq * 7 + sk * 13 + d + int(causal))
    q, k, v = (rng.standard_normal((2, s, 2, d), np.float32)
               for s in (sq, sk, sk))
    # one jitted program per shape compiles faster than eager dispatch
    want_o, want_lse = jax.jit(functools.partial(
        jax_flash_lse, is_causal=causal))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    o, lse = flash_attention.flash_attention_lse(_t(q), _t(k), _t(v),
                                                 is_causal=causal)
    assert o.shape == (2, sq, 2, d) and lse.shape == (2, 2, sq)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_reference_attention_matches_jax(causal, with_mask):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 9, 2, 16), np.float32)
               for _ in range(3))
    mask = rng.random((2, 1, 1, 9)) > 0.3 if with_mask else None
    mask_j = None if mask is None else jnp.asarray(mask)
    mask_t = None if mask is None else torch.from_numpy(mask)
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         is_causal=causal, mask=mask_j)
    for impl in ("xla", "einsum", "auto"):
        if impl == "auto" and with_mask:
            continue  # "auto" is the plain path on the CPU, same as xla
        got = attention.dot_product_attention(
            _t(q), _t(k), _t(v), is_causal=causal, mask=mask_t, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_impl_on_cpu_is_the_plain_flash():
    rng = np.random.default_rng(4)
    q, k, v = (_t(rng.standard_normal((1, 5, 2, 8), np.float32))
               for _ in range(3))
    before = flash_attention.launches
    got = attention.dot_product_attention(q, k, v, impl="flash")
    want = flash_attention.flash_attention_plain(q, k, v)[0]
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert flash_attention.launches == before  # no kernel on the CPU


def test_sigmoid_impl_on_cpu_is_the_plain_sigmoid():
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.standard_normal((1, 5, 2, 8), np.float32))
               for _ in range(3))
    before = flash_attention.sigmoid_launches
    got = attention.dot_product_attention(q, k, v, impl="sigmoid")
    want = flash_attention.sigmoid_attention_plain(
        q, k, v, logit_bias=-math.log(5))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert flash_attention.sigmoid_launches == before  # no kernel on the CPU


@pytest.mark.parametrize("impl", ["flash_bias", "ring", "ulysses",
                                  "saveable"])
def test_unported_attention_impls_name_the_roadmap(impl):
    """Every JAX impl is ported now. ``flash_bias`` without a bias raises
    JAX's ValueError (tests/test_torch_bias.py compares the messages);
    ``saveable`` in f32 is the einsum path's function
    (tests/test_torch_remat.py holds it to JAX's); ``ring`` and
    ``ulysses`` (sequence parallelism, tests/test_torch_parallel_*.py)
    need a mesh, and refuse a bias, as JAX's do."""
    q = torch.zeros(1, 4, 1, 8)
    if impl == "saveable":
        q = torch.randn(1, 4, 1, 8, generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(
            attention.dot_product_attention(q, q, q, impl=impl),
            attention.reference_attention(q, q, q), atol=1e-6, rtol=1e-6)
        return
    if impl == "flash_bias":
        with pytest.raises(ValueError, match="impl='flash_bias' requires a "
                                             "bias"):
            attention.dot_product_attention(q, q, q, impl=impl)
        return
    with pytest.raises(ValueError, match="no ambient mesh installed"):
        attention.dot_product_attention(q, q, q, impl=impl)
    with pytest.raises(ValueError, match=f"{impl} attention does not take "
                                         f"an additive bias"):
        attention.dot_product_attention(q, q, q, impl=impl, bias=q[0, 0])


@pytest.mark.parametrize("impl", ["flash", "flash_masked"])
@pytest.mark.parametrize("rank", [2, 4])
def test_flash_with_a_key_padding_mask_is_masked_flash(impl, rank):
    """A (B, Sk) or (B, 1, 1, Sk) mask under "flash" or "flash_masked" goes
    through the masked flash Function (its plain version on the CPU) and
    matches the einsum reference with the same mask."""
    rng = np.random.default_rng(6)
    q, k, v = (_t(rng.standard_normal((2, s, 2, 16), np.float32))
               for s in (5, 9, 9))
    mask = rng.random((2, 9)) > 0.4
    mask[:, 0] = True
    keys = mask if rank == 2 else mask[:, None, None, :]
    q.requires_grad_()
    got = attention.dot_product_attention(q, k, v, mask=_t(keys), impl=impl)
    assert type(got.grad_fn).__name__ == "FlashAttentionFnBackward"
    want = attention.reference_attention(q, k, v,
                                         mask=_t(mask[:, None, None, :]))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **TOL)
    torch.testing.assert_close(got, flash_attention.flash_attention_masked(
        q, k, v, _t(mask)), atol=0, rtol=0)


@pytest.mark.parametrize("impl", ["flash", "flash_masked"])
def test_flash_refuses_masks_that_are_not_key_padding(impl):
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="(?i)key-padding masks only"):
        attention.dot_product_attention(
            q, q, q, mask=torch.ones(1, 2, 4, 4, dtype=torch.bool), impl=impl)


def test_flash_masked_needs_a_mask():
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="requires a key-padding mask"):
        attention.dot_product_attention(q, q, q, impl="flash_masked")


def test_flash_with_a_bias_names_the_roadmap():
    """``"flash"`` with a bias (and no mask) is ``"flash_bias"``, as in JAX:
    the biased flash Function (its plain version on the CPU), matching the
    einsum reference with the same bias, in value and in the bias's
    gradient."""
    rng = np.random.default_rng(7)
    q, k, v = (_t(rng.standard_normal((2, s, 2, 16), np.float32))
               for s in (4, 6, 6))
    bias = _t(rng.standard_normal((2, 4, 6), np.float32)).requires_grad_()
    got = attention.dot_product_attention(q, k, v, bias=bias, impl="flash")
    assert type(got.grad_fn).__name__ == "FlashAttentionBiasFnBackward"
    (grad,) = torch.autograd.grad(got.sum(), bias)
    want = attention.reference_attention(q, k, v, bias=bias)
    (want_grad,) = torch.autograd.grad(want.sum(), bias)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(grad, want_grad, **TOL)


@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "gelu_pytorch_tanh",
                                  "gelu_new", "quick_gelu", "relu", "silu"])
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jax_acts.get_activation(name)(jnp.asarray(x)))
    got = activations.get_activation(name)(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_unknown_activation_warns_and_falls_back_to_gelu_tanh():
    with pytest.warns(UserWarning, match="unknown activation"):
        fn = activations.get_activation("nope")
    assert fn is activations.gelu_tanh


@pytest.mark.parametrize("wrapper", ["layer_norm", "flash", "flash_masked"])
def test_wrappers_refuse_other_devices(wrapper):
    # a tensor that is neither on the CPU nor on the card gets no kernel and
    # no plain fallback: the wrapper raises
    if wrapper == "layer_norm":
        x = torch.empty(4, 8, device="meta")
        w = torch.empty(8, device="meta")
        call = lambda: ln_mod.layer_norm(x, w, w)  # noqa: E731
    elif wrapper == "flash":
        q = torch.empty(1, 4, 1, 8, device="meta")
        call = lambda: flash_attention.flash_attention(q, q, q)  # noqa: E731
    else:
        q = torch.empty(1, 4, 1, 8, device="meta")
        m = torch.ones(1, 4, dtype=torch.bool, device="meta")
        call = lambda: flash_attention.flash_attention_masked(  # noqa: E731
            q, q, q, m)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        call()
