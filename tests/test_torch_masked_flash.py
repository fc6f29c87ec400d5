"""The port's masked flash attention (kernel row 4 and row 7's mask kind) on
the CPU against the JAX package's ``flash_attention_masked`` (Pallas
interpret mode, as the JAX suite runs it): forward, backward (``jax.vjp``),
and finite differences (``gradcheck`` in float64). Inputs, masks and
cotangents are made with numpy from a seed and handed to both packages.

A query row whose keys are all masked (a fully padded sample, or a causal
row whose visible keys are all padding) gives finite garbage that depends on
the implementation's tile padding: such rows are checked for finiteness
only, and carry a zero cotangent, under which both sides give them zero
gradient."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jimm_tpu.ops.flash_attention import (
    flash_attention_masked as jax_flash_masked)
from jimm_tpu_torch.ops import flash_attention as fa

# f32: the JAX package states ~1e-5 against its einsum oracle
# (ops/flash_attention.py:35-37); backward as tests/test_torch_backward.py
# (the JAX suite's 5e-4, tightened to 5e-5)
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
B, N = 2, 2


def _mask(kind: str, sk: int, rng: np.random.Generator) -> np.ndarray:
    """(B, Sk) bool, True = attend."""
    if kind == "sparse":      # most keys padded, at least one real per sample
        m = rng.random((B, sk)) > 0.7
        m[np.arange(B), rng.integers(0, sk, B)] = True
    elif kind == "one_key":   # a single valid key, anywhere
        m = np.zeros((B, sk), bool)
        m[np.arange(B), rng.integers(0, sk, B)] = True
    elif kind.startswith("len"):  # a valid prefix, at the 64-row tile edge
        m = np.arange(sk)[None, :] < int(kind[3:])
        m = np.repeat(m, B, 0)
        m[1, : sk // 2 + 1] = True
        m[1, sk // 2 + 1:] = False
    elif kind == "empty_row":  # sample 1 has no valid key at all
        m = rng.random((B, sk)) > 0.5
        m[0, 0] = True
        m[1] = False
    else:
        raise ValueError(kind)
    return m


def _live_rows(mask: np.ndarray, sq: int, causal: bool) -> np.ndarray:
    """(B, Sq) bool: the query rows with at least one key to attend."""
    sk = mask.shape[1]
    keep = mask[:, None, :] & np.ones((sq, sk), bool)[None]
    if causal:
        keep &= np.tri(sq, sk, dtype=bool)[None]
    return keep.any(-1)


def _inputs(sq, sk, d, kind, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, N, d), np.float32)
    k, v = (rng.standard_normal((B, sk, N, d), np.float32) for _ in range(2))
    return q, k, v, _mask(kind, sk, rng), rng


def _t(a: np.ndarray, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@functools.lru_cache(maxsize=None)
def _jax_fwd(causal: bool):
    return jax.jit(functools.partial(jax_flash_masked, is_causal=causal))


_SHAPES = [(sq, sk, d, False) for sq, sk in [(1, 5), (5, 5), (1, 257),
                                             (5, 257), (257, 257)]
           for d in (64, 80)] + [(5, 5, 80, True), (257, 257, 64, True)]
_KINDS = {5: ["sparse", "one_key", "empty_row"],
          257: ["sparse", "one_key", "len63", "len64", "len65", "empty_row"]}
_FWD_CASES = [(sq, sk, d, causal, kind) for sq, sk, d, causal in _SHAPES
              for kind in _KINDS[sk]]


@pytest.mark.parametrize("sq,sk,d,causal,kind", _FWD_CASES)
def test_masked_flash_matches_jax(sq, sk, d, causal, kind):
    q, k, v, mask, _ = _inputs(sq, sk, d, kind, sq * 7 + sk + d)
    want = np.asarray(_jax_fwd(causal)(*map(jnp.asarray, (q, k, v, mask))))
    before = fa.masked_launches
    o, lse = fa.flash_attention_lse(_t(q), _t(k), _t(v), is_causal=causal,
                                    mask=_t(mask))
    assert fa.masked_launches == before  # no kernel on the CPU
    assert o.shape == (B, sq, N, d) and lse.shape == (B, N, sq)
    got = o.numpy()
    assert np.isfinite(got).all() and np.isfinite(lse.numpy()).all()
    live = _live_rows(mask, sq, causal)
    np.testing.assert_allclose(got[live], want[live], **TOL)
    if kind == "empty_row":
        assert not live[1].any()


def test_masked_flash_takes_every_mask_form():
    """(B, Sk) or (B, 1, 1, Sk), bool or int: the same answer; any other
    shape raises ValueError."""
    q, k, v, mask, _ = _inputs(5, 9, 16, "sparse", 0)
    want = fa.flash_attention_masked(_t(q), _t(k), _t(v), _t(mask))
    for form in (mask.astype(np.int32), mask[:, None, None, :],
                 mask[:, None, None, :].astype(np.int64)):
        got = fa.flash_attention_masked(_t(q), _t(k), _t(v), _t(form))
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    for bad in (np.ones((B, N, 5, 9), bool), np.ones((B, 8), bool),
                np.ones((B, 1, 2, 9), bool)):
        with pytest.raises(ValueError, match="mask"):
            fa.flash_attention_masked(_t(q), _t(k), _t(v), _t(bad))


# -- backward ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_vjp(causal: bool):
    def run(q, k, v, mask, do):
        _, vjp = jax.vjp(lambda a, b, c: jax_flash_masked(
            a, b, c, mask, is_causal=causal), q, k, v)
        return vjp(do)
    return jax.jit(run)


_BWD_CASES = [(sq, sk, d, causal, kind)
              for sq, sk, d, causal in [(5, 5, 64, False), (5, 5, 80, True),
                                        (1, 257, 80, False),
                                        (5, 257, 64, False),
                                        (257, 257, 64, False),
                                        (257, 257, 80, True)]
              for kind in ("sparse", "len64", "empty_row")
              if not (kind == "len64" and sk == 5)]


@pytest.mark.parametrize("sq,sk,d,causal,kind", _BWD_CASES)
def test_masked_flash_grads_match_jax(sq, sk, d, causal, kind):
    q, k, v, mask, rng = _inputs(sq, sk, d, kind, sq * 31 + sk + d)
    do = rng.standard_normal(q.shape, np.float32)
    # rows with no key to attend carry no cotangent (see the docstring)
    do *= _live_rows(mask, sq, causal)[:, :, None, None]
    want = _jax_vjp(causal)(*map(jnp.asarray, (q, k, v, mask, do)))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    before = fa.masked_bwd_launches
    fa.flash_attention_masked(tq, tk, tv, _t(mask),
                              is_causal=causal).backward(_t(do))
    assert fa.masked_bwd_launches == before
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=f"d{name}")
    # masked keys get exactly zero gradient
    dead = ~mask
    assert not tk.grad.numpy()[dead].any() and not tv.grad.numpy()[dead].any()


@pytest.mark.parametrize("causal", [False, True])
def test_masked_flash_gradcheck(causal):
    """The plain masked backward against finite differences, through both
    outputs, in float64; every query row has a key to attend."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 5, 2, 6, generator=g, dtype=torch.float64)
    k, v = (torch.randn(2, 7, 2, 6, generator=g, dtype=torch.float64)
            for _ in range(2))
    mask = torch.tensor([[1, 0, 1, 1, 0, 0, 1], [1, 1, 0, 0, 0, 1, 0]],
                        dtype=torch.bool)
    inputs = tuple(t.requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention_lse(a, b, c, is_causal=causal,
                                               mask=mask), inputs)

