"""The port's backward passes on the CPU: the LayerNorm and flash-attention
autograd Functions against ``jax.vjp`` of the JAX package's kernels (Pallas
interpret mode, as the JAX suite runs them), and against finite differences
(``gradcheck`` in float64). Inputs and cotangents are made with numpy from
a seed and handed to both packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jimm_tpu.ops.flash_attention import flash_attention_lse as jax_flash_lse
from jimm_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from jimm_tpu_torch.nn.norm import FusedLayerNorm
from jimm_tpu_torch.ops import flash_attention as fa
from jimm_tpu_torch.ops import layer_norm as ln

# the JAX suite's backward tolerances: tests/test_layer_norm.py:38-40 (LN
# grads, atol 1e-3 rtol 1e-4, tightened here to 1e-4 / 1e-4) and
# tests/test_flash_attention.py:47 (flash grads, atol 5e-4, tightened to
# 5e-5); the f32 arithmetic is the same, only the order of sums differs
LN_TOL = dict(atol=1e-4, rtol=1e-4)
FLASH_TOL = dict(atol=5e-5, rtol=1e-4)


def _t(a: np.ndarray, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _graph(fn) -> set[str]:
    """The names of every autograd node that ``fn`` reaches."""
    names, todo = set(), [fn]
    while todo:
        node = todo.pop()
        if node is not None and type(node).__name__ not in names:
            names.add(type(node).__name__)
            todo += [f for f, _ in node.next_functions]
    return names


def test_kernel_outputs_carry_their_function():
    """The outputs of both wrappers hang off the port's autograd Functions
    and backpropagate into every input, so a model on the card trains its
    projections and LayerNorm parameters."""
    rng = np.random.default_rng(0)
    q, k, v = (_t(rng.standard_normal((2, 5, 2, 8), np.float32), True)
               for _ in range(3))
    o = fa.flash_attention(q, k, v)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    o.square().sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (q, k, v))

    norm = FusedLayerNorm(8, eps=1e-6)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
    x = _t(rng.standard_normal((3, 4, 8), np.float32), True)
    y = norm(x)
    assert "LayerNormFnBackward" in _graph(y.grad_fn)
    (y * torch.arange(8.0)).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    assert norm.weight.grad is not None and norm.bias.grad is not None
    assert norm.weight.grad.dtype == norm.weight.dtype


# (100, 768), (33, 1024), (33, 1152): preset widths, on the card the
# register body; (9, 2056) wider than it takes, the CTA body
@pytest.mark.parametrize("rows,f", [(1, 3), (5, 100), (257, 769), (100, 768),
                                    (96, 64), (33, 1024), (33, 1152),
                                    (9, 2056)])
def test_layer_norm_grads_match_jax(rows, f):
    rng = np.random.default_rng(rows + f)
    x = rng.standard_normal((rows, f), np.float32) * 2 + 0.3
    scale = rng.standard_normal(f, np.float32)
    bias = rng.standard_normal(f, np.float32)
    dy = rng.standard_normal((rows, f), np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_layer_norm(a, b, c, 1e-6),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(dy))
    tx, ts, tb = _t(x, True), _t(scale, True), _t(bias, True)
    ln.layer_norm(tx, ts, tb, 1e-6).backward(_t(dy))
    for name, got, w in zip(("dx", "dscale", "dbias"),
                            (tx.grad, ts.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **LN_TOL,
                                   err_msg=name)


# every S of the JAX suite with D = 64 and 80 and causal on and off (a JAX
# compile in interpret mode takes ~4 s a shape, so not the full product),
# and the MAP probe's cross-attention, Sq = 1 against Sk = 257
_FLASH_CASES = [(1, 1, 64, False), (1, 1, 80, True), (5, 5, 64, True),
                (5, 5, 80, False), (197, 197, 64, False), (197, 197, 80, True),
                (257, 257, 64, True), (257, 257, 80, False),
                (1, 257, 80, False)]


@functools.lru_cache(maxsize=None)
def _jax_flash_vjp(causal: bool):
    def run(q, k, v, do, dlse):
        out, vjp = jax.vjp(functools.partial(jax_flash_lse, is_causal=causal),
                           q, k, v)
        return out, vjp((do, dlse))
    return jax.jit(run)


def _flash_pair(sq, sk, d, causal, seed, with_dlse):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, 2, d), np.float32)
    k, v = (rng.standard_normal((2, sk, 2, d), np.float32) for _ in range(2))
    do = rng.standard_normal((2, sq, 2, d), np.float32)
    dlse = (rng.standard_normal((2, 2, sq), np.float32) if with_dlse
            else np.zeros((2, 2, sq), np.float32))
    (_, _), want = _jax_flash_vjp(causal)(*map(jnp.asarray,
                                               (q, k, v, do, dlse)))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o, lse = fa.flash_attention_lse(tq, tk, tv, is_causal=causal)
    if with_dlse:
        torch.autograd.backward([o, lse], [_t(do), _t(dlse)])
    else:
        o.backward(_t(do))
    return (tq.grad, tk.grad, tv.grad), want


@pytest.mark.parametrize("sq,sk,d,causal", _FLASH_CASES)
def test_flash_grads_match_jax(sq, sk, d, causal):
    got, want = _flash_pair(sq, sk, d, causal, sq * 31 + sk + d, False)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FLASH_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_lse_cotangent_matches_jax(causal):
    """A cotangent on lse (the ring-attention combine) folds into delta on
    both sides."""
    got, want = _flash_pair(33, 33, 64, causal, 7, True)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FLASH_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradcheck(causal):
    """The plain backward formulas against finite differences, through both
    outputs, in float64."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 5, 2, 6, generator=g, dtype=torch.float64)
    k, v = (torch.randn(1, 7, 2, 6, generator=g, dtype=torch.float64)
            for _ in range(2))
    inputs = tuple(t.requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention_lse(a, b, c, is_causal=causal),
        inputs)


def test_layer_norm_gradcheck():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 9, generator=g, dtype=torch.float64) * 2 + 1
    w, b = (torch.randn(9, generator=g, dtype=torch.float64)
            for _ in range(2))
    inputs = tuple(t.requires_grad_() for t in (x, w, b))
    assert torch.autograd.gradcheck(
        lambda a, s, c: ln.layer_norm(a, s, c, 1e-6), inputs)
