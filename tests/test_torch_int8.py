"""The port's int8 ops on the CPU against the JAX package's: the row and head
quantizers (bit for bit), the int8 matmul's plain version against the Pallas
kernel in interpret mode, ``quantized_linear``'s straight-through backward
against the JAX custom VJP, and the int8-QK flash attention's plain forward
and backward against the Pallas kernels in interpret mode. Inputs are made
with numpy from a seed and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jimm_tpu.ops import flash_attention_int8 as jax_fa8
from jimm_tpu.ops import int8_matmul as jax_mm
from jimm_tpu.ops.flash_attention import _flatten_heads
from jimm_tpu_torch.ops import attention
from jimm_tpu_torch.ops import flash_attention_int8 as fa8
from jimm_tpu_torch.ops import int8_matmul as mm

#: (M, K, N) off the tile grid (tests/test_int8_ops.py) and a served
#: projection's (K, N) = (768, 768) at 64 of its 8192 rows
MATMUL_SHAPES = [(1, 7, 5), (5, 100, 33), (33, 64, 128), (257, 769, 129),
                 (16, 768, 768), (64, 768, 768)]
#: flash tolerances of tests/test_flash_variants.py: f32 forward 3e-5,
#: backward 5e-4 absolute; bf16 cosine
FWD_ATOL = 3e-5
BWD_ATOL = 5e-4
BF16_MIN_COS = 0.999


def _cos(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _rows_with_ties() -> np.ndarray:
    """Rows whose quantized values sit exactly at .5 of a step (round half
    to even decides them), an all-zero row, and random rows."""
    rng = np.random.default_rng(0)
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5])
    rows = [halves, 2.0 * halves, np.zeros(8),
            *rng.standard_normal((5, 8)) * 3.0]
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_is_bit_identical(dtype):
    x = _rows_with_ties()
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = jax_mm.quantize_rows(xj)
    got_q, got_s = mm.quantize_rows(xt)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  np.asarray(want_s).view(np.uint32))
    # the ties went to even and the zero row got scale 1.0
    assert got_q[0, 1:7].tolist() == [0, 2, 2, 0, -2, -2]
    assert got_s[2].item() == 1.0 and not got_q[2].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_heads_is_bit_identical(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    x[0, 3, 1] = 0.0  # an all-zero row
    x[1, 2, 0, :8] = _rows_with_ties()[0]
    xj = jnp.asarray(x).astype(dtype)
    got_q, got_s = fa8.quantize_heads(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    want_q, want_s = jax_fa8._quantize_heads(_flatten_heads(xj), 7, 16)
    assert got_q.shape == (2, 7, 3, 16) and got_s.shape == (2, 3, 7)
    np.testing.assert_array_equal(
        got_q.permute(0, 2, 1, 3).reshape(6, 7, 16).numpy(),
        np.asarray(want_q))
    np.testing.assert_array_equal(
        got_s.reshape(6, 1, 7).numpy().view(np.uint32),
        np.asarray(want_s).view(np.uint32))


def _operands(m: int, k: int, n: int, seed: int):
    """x quantized per row by the port, w quantized per output channel by
    the port's QuantLinear surgery, as (port, JAX) operand tuples: the JAX
    kernel takes w_q as (K, N)."""
    from jimm_tpu_torch.quant import quantize_linear
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    lin = torch.nn.Linear(k, n)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(
            rng.standard_normal((n, k)).astype(np.float32)))
        lin.bias.copy_(torch.from_numpy(
            rng.standard_normal(n).astype(np.float32)))
    ql = quantize_linear(lin)
    x_q, x_s = mm.quantize_rows(x)
    port = (x_q, x_s, ql.w_q, ql.scale, ql.bias.detach())
    jax_ops = (jnp.asarray(x_q.numpy()), jnp.asarray(x_s.numpy()),
               jnp.asarray(ql.w_q.numpy().T), jnp.asarray(ql.scale.numpy()),
               jnp.asarray(ql.bias.detach().numpy()))
    return port, jax_ops


@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_int8_matmul_plain_matches_jax(m, k, n):
    (x_q, x_s, w_q, w_s, _), (jx, jxs, jw, jws, _) = _operands(m, k, n, m + k)
    got = mm.int8_matmul(x_q, x_s, w_q, w_s)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = np.asarray(jax_mm.int8_matmul(jx, jxs, jw, jws))
    # the JAX test's tolerance for its integer reference
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * max(1, k // 64), rtol=1e-6)
    assert mm.launches == 0  # the CPU takes the plain version


@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_int8_matmul_epilogue_matches_jax(activation):
    (x_q, x_s, w_q, w_s, b), (jx, jxs, jw, jws, jb) = _operands(9, 40, 17, 3)
    got = mm.int8_matmul(x_q, x_s, w_q, w_s, b, activation=activation)
    want = jax_mm.int8_matmul(jx, jxs, jw, jws, jb, activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_int8_matmul_rejects_an_unknown_activation():
    (x_q, x_s, w_q, w_s, _), _ = _operands(4, 8, 8, 5)
    with pytest.raises(ValueError, match="activation"):
        mm.int8_matmul(x_q, x_s, w_q, w_s, activation="swish")


#: (M, K): K off a multiple of 16, which the wrapper zero-pads for TMA
#: before the kernel sees it
PADDED_CASES = [(m, k) for m in (1, 5, 70) for k in (7, 100, 769, 97)]


def _fused_bias_add(x_q, x_s, w_q, w_s, b, activation):
    """The epilogue as XLA on the CPU compiles JAX's interpret-mode kernel:
    ``(acc * x_scale) * w_scale + bias`` with the last multiply and the add
    contracted into one fused multiply-add (one rounding, here in f64 then
    to f32, exact for f32 operands)."""
    acc = (x_q.double() @ w_q.double().T).float()
    y = (acc * x_s[:, None]).double() * w_s.double()[None, :]
    y = (y + b.double()[None, :]).float()
    return torch.clamp_min(y, 0.0) if activation == "relu" else y


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("activation", [None, "relu"])
@pytest.mark.parametrize("m,k", PADDED_CASES)
def test_int8_matmul_plain_on_padded_operands_is_bit_identical(m, k,
                                                               activation,
                                                               bias):
    """What the kernel computes on the wrapper's K-padded copies equals, bit
    for bit, the unpadded plain version (the zero columns add no product)
    and, without a bias, JAX's Pallas kernel in interpret mode. With a bias,
    XLA on the CPU contracts JAX's last multiply and the bias add into one
    fused multiply-add, where the kernel and the plain version round each
    step: JAX's result is then exactly that contraction of the same
    operands, and within one rounding of the plain version."""
    (x_q, x_s, w_q, w_s, b), (jx, jxs, jw, jws, jb) = _operands(m, k, 33,
                                                                 m * k)
    if not bias:
        b, jb = None, None
    xp, wp = mm.tma_operands(x_q, w_q)
    k_pad = -(-k // 16) * 16
    assert xp.shape == (m, k_pad) and wp.shape == (33, k_pad)
    assert xp.dtype == wp.dtype == torch.int8
    assert torch.equal(xp[:, :k], x_q) and torch.equal(wp[:, :k], w_q)
    assert not xp[:, k:].any() and not wp[:, k:].any()
    got = mm.int8_matmul_plain(xp, x_s, wp, w_s, b, activation=activation)
    unpadded = mm.int8_matmul_plain(x_q, x_s, w_q, w_s, b,
                                    activation=activation)
    want = np.asarray(jax_mm.int8_matmul(jx, jxs, jw, jws, jb,
                                         activation=activation))
    assert torch.equal(got, unpadded)
    if not bias:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    fused = _fused_bias_add(xp, x_s, wp, w_s, b, activation)
    np.testing.assert_array_equal(fused.numpy(), want)
    # the product's rounding and the two sums' (half an ulp each)
    unbiased = mm.int8_matmul_plain(xp, x_s, wp, w_s).abs().numpy()
    ulps = unbiased + np.abs(got.numpy()) + np.abs(want)
    assert (np.abs(got.numpy() - want) <= 2.0**-24 * ulps).all()


def test_int8_tma_operands_copy_only_what_tma_cannot_read():
    """Served operands (K a multiple of 16, fresh allocations) pass as they
    are; a base off a 16-byte boundary is copied, K unchanged."""
    (x_q, _, w_q, _, _), _ = _operands(64, 96, 40, 11)
    xp, wp = mm.tma_operands(x_q, w_q)
    assert xp is x_q and wp is w_q
    store = torch.zeros(64 * 96 + 4, dtype=torch.int8)
    store[4:] = x_q.flatten()
    view = store[4:].view(64, 96)
    assert view.data_ptr() % 16 != 0
    xp, wp = mm.tma_operands(view, w_q)
    assert xp.data_ptr() % 16 == 0 and xp.shape == (64, 96)
    assert torch.equal(xp, x_q) and torch.equal(wp, w_q)


def test_quantized_linear_backward_matches_jax():
    """dx and dbias against the JAX custom VJP; the int8 weights and scales
    get none (they are buffers, not parameters)."""
    (_, _, w_q, w_s, b), (_, _, jw, jws, jb) = _operands(12, 40, 17, 7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((12, 40)).astype(np.float32)
    dy = rng.standard_normal((12, 17)).astype(np.float32)
    jdx, jdb = jax.grad(
        lambda x, b: jnp.sum(jax_mm.quantized_linear(x, jw, jws, b) * dy),
        argnums=(0, 1))(jnp.asarray(x), jb)
    xt = torch.from_numpy(x).requires_grad_()
    bt = b.clone().requires_grad_()
    y = mm.quantized_linear(xt, w_q, w_s, bt)
    want_y = jax_mm.quantized_linear(jnp.asarray(x), jw, jws, jb)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=1e-4, rtol=1e-6)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jdb), atol=1e-5,
                               rtol=1e-5)
    assert not w_q.requires_grad and not w_s.requires_grad


def test_quantized_linear_keeps_a_bf16_input_dtype_in_dx():
    (_, _, w_q, w_s, b), _ = _operands(6, 24, 8, 9)
    x = torch.randn(6, 24, dtype=torch.bfloat16, requires_grad=True)
    mm.quantized_linear(x, w_q, w_s, b).sum().backward()
    assert x.grad.dtype == torch.bfloat16


def test_quantized_linear_fused_activation_has_no_gradient():
    (_, _, w_q, w_s, _), _ = _operands(4, 8, 8, 10)
    x = torch.randn(4, 8, requires_grad=True)
    y = mm.quantized_linear(x, w_q, w_s, activation="gelu")
    with pytest.raises(NotImplementedError, match="fused int8"):
        y.sum().backward()


#: (Sq, Sk, D, causal): the JAX suite's seq 64/100/257 causal/577, the head
#: dims 32/64/80, and the MAP probe's one query against 256 keys
FLASH_CASES = [(64, 64, 32, False), (100, 100, 64, False),
               (257, 257, 80, True), (577, 577, 32, False),
               (1, 256, 64, False)]


def _qkv(sq: int, sk: int, d: int, seed: int, n: int = 2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, sq, n, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, sk, n, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((1, sq, n, d)).astype(np.float32)
    return q, k, v, do


def _jax_fwd_bwd(q, k, v, do, causal, dtype):
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    o, vjp = jax.vjp(lambda q, k, v: jax_fa8.flash_attention_int8(
        q, k, v, is_causal=causal), *args)
    return o, vjp(jnp.asarray(do).astype(dtype))


def _port_fwd_bwd(q, k, v, do, causal, dtype):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = fa8.flash_attention_int8(*ts, is_causal=causal)
    o.backward(torch.from_numpy(do).to(dtype))
    return o.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("sq,sk,d,causal", FLASH_CASES)
def test_flash_int8_matches_jax_in_f32(sq, sk, d, causal):
    q, k, v, do = _qkv(sq, sk, d, sq + sk + d)
    jo, jgrads = _jax_fwd_bwd(q, k, v, do, causal, jnp.float32)
    o, grads = _port_fwd_bwd(q, k, v, do, causal, torch.float32)
    assert o.shape == q.shape
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=FWD_ATOL)
    for name, got, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=BWD_ATOL, err_msg=f"d{name}")
    assert fa8.launches == fa8.bwd_launches == 0  # plain versions on the CPU


@pytest.mark.parametrize("sq,sk,d,causal", [FLASH_CASES[1], FLASH_CASES[2],
                                            FLASH_CASES[4]])
def test_flash_int8_matches_jax_in_bf16(sq, sk, d, causal):
    q, k, v, do = _qkv(sq, sk, d, 2 * sq + sk)
    jo, jgrads = _jax_fwd_bwd(q, k, v, do, causal, jnp.bfloat16)
    o, grads = _port_fwd_bwd(q, k, v, do, causal, torch.bfloat16)
    assert o.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert _cos(_np(o), _np(jo)) >= BF16_MIN_COS
    for name, got, want in zip("qkv", grads, jgrads):
        assert _cos(_np(got), _np(want)) >= BF16_MIN_COS, f"d{name}"


def test_flash_int8_saves_one_byte_per_q_and_k_element():
    q, k, v, _ = (torch.from_numpy(a).requires_grad_()
                  for a in _qkv(9, 9, 16, 3))
    o = fa8.flash_attention_int8(q, k, v)
    saved = o.grad_fn.saved_tensors
    assert [t.dtype for t in saved[:4]] == [torch.int8, torch.float32,
                                            torch.int8, torch.float32]
    assert type(o.grad_fn).__name__ == "FlashAttentionInt8FnBackward"


def test_flash_int8_backward_plain_is_the_function_of_its_forward():
    """The plain backward's gradients are those of the plain forward's
    straight-through function: autograd through a dequantized twin of the
    forward (the quantizer as identity, the rounding points kept) agrees in
    f64."""
    q, k, v, do = (torch.from_numpy(a).double() for a in _qkv(11, 13, 8, 4))
    qq, qs = fa8.quantize_heads(q)
    kq, ks = fa8.quantize_heads(k)
    o, lse = fa8.flash_attention_int8_plain(qq, qs, kq, ks, v)
    dq, dk, dv = fa8.flash_attention_int8_bwd_plain(qq, qs, kq, ks, v, o,
                                                    lse, do)
    # the same function with q and k as f64 leaves at their dequantized
    # values: d/dq of softmax((q . k) * scale) v
    qd = (qq.double() * qs.transpose(1, 2)[..., None]).requires_grad_()
    kd = (kq.double() * ks.transpose(1, 2)[..., None]).requires_grad_()
    vd = v.clone().requires_grad_()
    ref = attention.reference_attention(qd, kd, vd)
    torch.autograd.backward(ref.double(), do)
    np.testing.assert_allclose(dv.numpy(), vd.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(dq.numpy(), qd.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(dk.numpy(), kd.grad.numpy(), atol=1e-5)


@pytest.mark.parametrize("kw", [
    {"mask": torch.ones(1, 5, dtype=torch.bool)},
    {"bias": torch.zeros(1, 5, 5)}], ids=["mask", "bias"])
def test_flash_int8_refuses_masks_and_biases(kw):
    q = torch.zeros(1, 5, 1, 8)
    with pytest.raises(ValueError, match="flash_int8 does not support masks"):
        attention.dot_product_attention(q, q, q, impl="flash_int8", **kw)


def test_flash_int8_dispatch_is_the_int8_function():
    q, k, v, _ = (torch.from_numpy(a).requires_grad_()
                  for a in _qkv(5, 5, 8, 5))
    got = attention.dot_product_attention(q, k, v, impl="flash_int8",
                                          is_causal=True)
    assert type(got.grad_fn).__name__ == "FlashAttentionInt8FnBackward"
    torch.testing.assert_close(
        got, fa8.flash_attention_int8(q, k, v, is_causal=True), atol=0,
        rtol=0)
