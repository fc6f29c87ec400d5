"""Biased flash attention (kernel rows 5 and 8, row 7's bias kind) on the CPU
against the JAX package: the plain versions behind ``flash_attention_bias``
and ``FlashAttentionBiasFn`` against JAX's Pallas kernels in interpret mode
(as ``tests/test_flash_variants.py`` runs them), forward and backward, dbias
included, at the JAX suite's tolerances; a ``(Sq, Sk)`` bias's gradient
summed over heads; ``-inf`` bias entries, a row with no finite key included;
the routing of ``dot_product_attention`` on the card against JAX's on the
TPU, case by case; and JAX's refusal messages, word for word.

Inputs are made with numpy (B = 2, N = 2) and handed to both. Each JAX
result is computed once, in a module-scoped fixture, one jitted forward and
VJP per case."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jimm_tpu.ops.attention as jax_attention
import jimm_tpu.ops.flash_attention as jax_flash
from jimm_tpu.ops.attention import dot_product_attention as jax_dpa
from jimm_tpu.ops.flash_attention import flash_attention_bias as jax_bias
from jimm_tpu_torch.ops import attention
from jimm_tpu_torch.ops import flash_attention as fa

B, N = 2, 2
#: f32 forward; dq, dk, dv and dbias: the JAX suite's tolerances for its own
#: bias kernel against its einsum oracle (test_flash_variants.py:103-110,
#: 209-261)
FWD_ATOL = 3e-5
GRAD_ATOL = 5e-4
BF16_MIN_COS = 0.999

#: name -> (Sq, Sk, D, causal, bias kind): "full" (N, Sq, Sk), "2d" a
#: (Sq, Sk) bias broadcast over heads, "neginf" (N, Sq, Sk) with -inf
#: entries and one query row with no finite key
CASES = {
    "s5-d64": (5, 5, 64, False, "full"),
    "s64-d64-causal": (64, 64, 64, True, "full"),
    "sq5-sk9-d80-2d": (5, 9, 80, False, "2d"),
    "s64-d80-neginf": (64, 64, 80, False, "neginf"),
    "s5-d80-causal-2d": (5, 5, 80, True, "2d"),
}
DEAD = (0, 3)  # (head, query row) whose keys all have a -inf bias


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(name: str):
    sq, sk, d, _, kind = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    q, do = (rng.standard_normal((B, sq, N, d), np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, sk, N, d), np.float32) for _ in range(2))
    shape = (sq, sk) if kind == "2d" else (N, sq, sk)
    bias = rng.standard_normal(shape).astype(np.float32) * 0.3
    if kind == "neginf":
        bias[rng.random(shape) < 0.3] = -np.inf
        bias[:, :, 0] = 0.5  # every other row keeps a finite key
        bias[DEAD] = -np.inf
    return q, k, v, bias, do


def _live(name: str) -> np.ndarray:
    """(B, Sq, N) bool: the query rows with at least one finite, kept key;
    the reference softmax is NaN on the others."""
    sq, sk, _, causal, _ = CASES[name]
    bias = np.broadcast_to(_inputs(name)[3], (N, sq, sk))
    keep = np.isfinite(bias)
    if causal:
        keep = keep & np.tri(sq, sk, dtype=bool)
    return np.broadcast_to(keep.any(-1).T[None], (B, sq, N))


def _jax_fwd_vjp(q, k, v, bias, do, *, causal):
    o, vjp = jax.vjp(functools.partial(jax_bias, is_causal=causal),
                     q, k, v, bias)
    return o, vjp(do)


@pytest.fixture(scope="module")
def jax_results():
    """Each case's JAX output and (dq, dk, dv, dbias), interpret mode."""
    out = {}
    for name, (_, _, _, causal, _) in CASES.items():
        fn = jax.jit(functools.partial(_jax_fwd_vjp, causal=causal))
        o, grads = fn(*map(jnp.asarray, _inputs(name)))
        out[name] = (np.asarray(o), [np.asarray(g) for g in grads])
    return out


def _port(name: str, dtype=torch.float32):
    """The port's o and (dq, dk, dv, dbias) through FlashAttentionBiasFn."""
    causal = CASES[name][3]
    q, k, v, bias, do = (_t(a) for a in _inputs(name))
    q, k, v = (x.to(dtype).requires_grad_() for x in (q, k, v))
    bias.requires_grad_()
    o = fa.flash_attention_bias(q, k, v, bias, is_causal=causal)
    assert type(o.grad_fn).__name__ == "FlashAttentionBiasFnBackward"
    grads = torch.autograd.grad(o, (q, k, v, bias), do.to(dtype))
    return o.detach(), grads


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(jax_results, name):
    got, _ = _port(name)
    want = jax_results[name][0]
    live = _live(name)
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=FWD_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_jax(jax_results, name):
    """dq (on live rows), dk, dv and dbias; a (Sq, Sk) bias gets the
    gradient summed over heads, in its own shape."""
    _, got = _port(name)
    live = _live(name)
    for label, g, w in zip(("dq", "dk", "dv", "dbias"), got,
                           jax_results[name][1]):
        assert g.shape == w.shape and torch.isfinite(g).all(), label
        g = g.numpy()
        if label == "dq":
            g, w = g[live], w[live]
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, err_msg=label)


@pytest.mark.parametrize("name", ["s64-d64-causal", "sq5-sk9-d80-2d"])
def test_bf16_forward_keeps_cosine(name):
    """bf16 through the port against JAX's bf16 kernel on the same
    inputs."""
    causal = CASES[name][3]
    q, k, v, bias, _ = _inputs(name)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax.jit(functools.partial(jax_bias, is_causal=causal))(
        qb, kb, vb, jnp.asarray(bias)), np.float32).ravel()
    got = fa.flash_attention_bias(
        *(_t(np.asarray(x, np.float32)).bfloat16() for x in (qb, kb, vb)),
        _t(bias), is_causal=causal)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().ravel()
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos >= BF16_MIN_COS


def test_a_row_with_no_finite_key_is_zero_and_finite():
    """o = 0 and lse = -1e30 there, as on the TPU (the reference softmax is
    NaN), and its gradients are zero."""
    q, k, v, bias, do = (_t(a) for a in _inputs("s64-d80-neginf"))
    o, lse = fa.flash_attention_bias_fwd(q, k, v, bias)
    h, row = DEAD
    assert (o[:, row, h] == 0).all() and (lse[:, h, row] == fa.NEG_INF).all()
    dq, dk, dv = fa.flash_attention_bias_bwd(q, k, v, bias, o, lse, do)
    dbias = fa.flash_attention_dbias(q, k, v, bias, o, lse, do)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv, dbias))
    assert (dq[:, row, h] == 0).all() and (dbias[h, row] == 0).all()
    assert (dbias[torch.isinf(bias)] == 0).all()


@pytest.mark.parametrize("impl", ["flash_bias", "flash"])
def test_dispatch_matches_jax(impl):
    """``dot_product_attention(..., bias=)`` under ``"flash_bias"`` and
    ``"flash"`` against JAX's, which both reach its bias kernel."""
    q, k, v, bias, _ = _inputs("sq5-sk9-d80-2d")
    want = jax.jit(functools.partial(jax_dpa, impl=impl))(
        *map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias))
    got = attention.dot_product_attention(_t(q), _t(k), _t(v),
                                          bias=_t(bias), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)


def test_auto_on_the_cpu_is_xla_as_in_jax():
    q, k, v, bias, _ = _inputs("s5-d64")
    got = attention.dot_product_attention(_t(q), _t(k), _t(v), bias=_t(bias))
    want = jax_dpa(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


class _Routed(Exception):
    """Raised by a stand-in for a dispatch target: its name."""


def _route(call) -> str:
    try:
        call()
    except _Routed as r:
        return str(r)
    except ValueError as e:
        return f"ValueError: {e}"
    raise AssertionError("the call reached no target")


def _stand_in(name: str):
    def target(*args, **kwargs):
        raise _Routed(name)
    return target


_MASKS = {None: None, "kp2": (B, 6), "kp4": (B, 1, 1, 6),
          "full4": (B, N, 5, 6)}
_BIASES = {None: None, "b1": (6,), "b2": (5, 6), "b3": (N, 5, 6),
           "b4": (1, N, 5, 6)}


@pytest.mark.parametrize("bias_kind", list(_BIASES))
@pytest.mark.parametrize("mask_kind", list(_MASKS))
@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_routing_on_the_card_matches_jax_on_the_tpu(monkeypatch, impl,
                                                    mask_kind, bias_kind):
    """``resolve_impl(on_card=True)`` and the dispatch's own checks send
    each (impl, mask, bias) where JAX's dispatch sends it on a TPU (its
    seq-512 crossover and seqpar branch held open and shut), or raise its
    ValueError. Every target is a stand-in that names itself."""
    for mod, name, target in (
            (jax_attention, "_default_backend", lambda: "tpu"),
            (jax_attention, "_flash_eligible", lambda q, k: True),
            (jax_attention, "_ambient_seq_axis", lambda: None),
            (jax_flash, "flash_attention", _stand_in("flash")),
            (jax_flash, "flash_attention_masked", _stand_in("flash_masked")),
            (jax_flash, "flash_attention_bias", _stand_in("flash_bias")),
            (jax.nn, "dot_product_attention", _stand_in("xla")),
            (attention, "flash_attention", _stand_in("flash")),
            (attention, "flash_attention_masked", _stand_in("flash_masked")),
            (attention, "flash_attention_bias", _stand_in("flash_bias")),
            (attention, "reference_attention", _stand_in("xla"))):
        monkeypatch.setattr(mod, name, target)
    q = np.zeros((B, 5, N, 8), np.float32)
    k = np.zeros((B, 6, N, 8), np.float32)
    mask = (None if _MASKS[mask_kind] is None
            else np.ones(_MASKS[mask_kind], bool))
    bias = (None if _BIASES[bias_kind] is None
            else np.zeros(_BIASES[bias_kind], np.float32))

    def jax_call():
        jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                mask=None if mask is None else jnp.asarray(mask),
                bias=None if bias is None else jnp.asarray(bias), impl=impl)

    def port_call():
        kw = dict(mask=None if mask is None else _t(mask),
                  bias=None if bias is None else _t(bias))
        resolved = attention.resolve_impl(impl, on_card=True, **kw)
        attention.dot_product_attention(_t(q), _t(k), _t(k), impl=resolved,
                                        **kw)

    assert _route(port_call) == _route(jax_call)


@pytest.mark.parametrize("impl,kw", [
    ("flash_bias", {}),
    ("flash_bias", {"bias": (N, 5, 5), "mask": (B, 5)}),
    ("flash_masked", {"bias": (N, 5, 5), "mask": (B, 5)}),
    ("flash", {"bias": (N, 5, 5), "mask": (B, 5)}),
])
def test_refusals_match_jax_word_for_word(impl, kw):
    """flash_bias without a bias or with a mask, flash_masked with a bias
    (and so "flash" with both): JAX's ValueError, as a string."""
    q = np.zeros((B, 5, N, 8), np.float32)
    arrays = {n: (np.ones(s, bool) if n == "mask"
                  else np.zeros(s, np.float32)) for n, s in kw.items()}
    with pytest.raises(ValueError) as jax_err:
        jax_dpa(*(jnp.asarray(q),) * 3, impl=impl,
                **{n: jnp.asarray(a) for n, a in arrays.items()})
    with pytest.raises(ValueError) as port_err:
        attention.dot_product_attention(*(_t(q),) * 3, impl=impl,
                                        **{n: _t(a)
                                           for n, a in arrays.items()})
    assert str(port_err.value) == str(jax_err.value)


def test_dbias_is_computed_only_when_the_bias_needs_it(monkeypatch):
    calls = []
    plain = fa.flash_attention_dbias_plain

    def spy(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_dbias_plain", spy)
    q, k, v, bias, _ = (_t(a) for a in _inputs("s5-d64"))
    q.requires_grad_()
    fa.flash_attention_bias(q, k, v, bias).sum().backward()
    assert not calls and bias.grad is None and q.grad is not None
    bias.requires_grad_()
    fa.flash_attention_bias(q, k, v, bias).sum().backward()
    assert len(calls) == 1 and bias.grad.shape == bias.shape


@pytest.mark.parametrize("shape,sms,ranges", [
    ((128, 12, 256, 256, 64), 132, 4),   # 192 tiles: 3 waves, 97% full
    ((128, 12, 1, 256, 64), 132, 11),    # the MAP probe: 2 full waves
    ((128, 12, 256, 256, 128), 132, 2),  # one CTA an SM above D = 64
    ((2, 2, 5, 5, 80), 132, 2),          # no more ranges than samples
    ((4, 64, 512, 512, 64), 132, 1),     # 4096 tiles: the whole batch
    ((128, 12, 256, 256, 80), 132, 2),   # 147 KB a CTA: one an SM
    ((128, 12, 1, 256, 128), 132, 11),   # the probe above D = 64: 4 waves
    ((24, 2, 256, 256, 64), 132, 8),     # 32 tiles: 8 ranges of 3
    ((3, 2, 5, 5, 64), 132, 3),          # a range per sample
])
def test_dbias_splits_the_batch_to_fill_the_card(shape, sms, ranges):
    b_range = fa.dbias_batch_range(*shape, sms)
    assert -(-shape[0] // b_range) == ranges


def test_the_bias_gradient_takes_the_callers_shape_and_dtype():
    q, k, v, _, _ = (_t(a) for a in _inputs("sq5-sk9-d80-2d"))
    bias = torch.zeros(9, dtype=torch.bfloat16, requires_grad=True)
    fa.flash_attention_bias(q, k, v, bias).sum().backward()
    assert bias.grad.shape == (9,) and bias.grad.dtype == torch.bfloat16


def test_flash_attention_bias_refuses_other_devices():
    q = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fa.flash_attention_bias(q, q, q, torch.zeros(1, 4, 4, device="meta"))
