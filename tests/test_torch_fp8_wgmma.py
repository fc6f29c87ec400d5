"""The fp8 GEMM's host side on the CPU (kernel row 12 on wgmma): the
operands' K padding for TMA, and the gate the kernel is held to on the card (the tensor core's truncated f32
sums, relative to the sum of absolute products), checked against an
emulation of that accumulator and of fp8 wgmma's narrower one."""

import math

import numpy as np
import pytest
import torch

from jimm_tpu_torch.ops import fp8_matmul as fp8


def _int_operands(m: int, k: int, n: int, seed: int):
    """fp8 operands of small integers (exact in e4m3 and e5m2): every sum
    of their products is an integer below 2**24, so any f32 summation order
    gives the same, exact result."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-8, 9, (m, k)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-8, 9, (n, k)).astype(np.float32))
    return a.to(fp8.E4M3), b.to(fp8.E4M3)


def _tensor_core_sum(a: np.ndarray, b: np.ndarray, group: int, bits: int,
                     promote: int = 0) -> np.ndarray:
    """A tensor core's accumulator, in float64: each instruction aligns its
    ``group`` exact products and the running sum to the largest of them and
    truncates each toward zero to ``bits`` bits below that one's leading
    bit, then adds; with ``promote`` the running sum restarts from zero
    every ``promote`` of K and is added into an f32 total. The kernel's
    f16 wgmma is ``group=16, bits=23``; fp8 wgmma keeps about ``bits=13``
    (``group=32``, promoted every 128 in the design the kernel replaced)."""
    prods = a[:, None, :].astype(np.float64) * b[None, :, :]
    total = np.zeros(prods.shape[:2], np.float32)
    acc = np.zeros(prods.shape[:2])
    for k0 in range(0, a.shape[1], group):
        if promote and k0 % promote == 0:
            total = (total + acc.astype(np.float32)).astype(np.float32)
            acc = np.zeros_like(acc)
        terms = np.concatenate([acc[..., None],
                                prods[..., k0:k0 + group]], axis=-1)
        top = np.abs(terms).max(axis=-1, keepdims=True)
        exp = np.floor(np.log2(np.where(top > 0, top, 1.0)))
        ulp = 2.0 ** (exp - bits)
        acc = (np.trunc(terms / ulp) * ulp).sum(-1).astype(np.float32)
    return (total + acc.astype(np.float32)).astype(np.float32)


def _swamp(k: int):
    """Rows of 256 then ones: every output is 65536 + (K - 1), exact in f32,
    the ones each below an accumulator of ~14 bits holding 65536."""
    a = torch.ones(2, k)
    b = torch.ones(3, k)
    a[:, 0] = b[:, 0] = 256.0
    return a.to(fp8.E4M3), b.to(fp8.E4M3)


# -- TMA operands --------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(1, 7, 5), (5, 100, 33), (257, 769, 129),
                                   (33, 64, 128), (16, 768, 768)])
def test_tma_operands_pad_k_and_keep_the_product(m, k, n):
    a_q, b_q = _int_operands(m, k, n, m + k + n)
    a_p, b_p = fp8.tma_operands(a_q, b_q)
    if k % 16 == 0:
        assert a_p is a_q and b_p is b_q
    k_pad = -(-k // 16) * 16
    assert a_p.shape == (m, k_pad) and b_p.shape == (n, k_pad)
    assert a_p.dtype == a_q.dtype and b_p.dtype == b_q.dtype
    assert torch.equal(a_p[:, :k].view(torch.uint8), a_q.view(torch.uint8))
    assert not a_p[:, k:].view(torch.uint8).any()
    assert not b_p[:, k:].view(torch.uint8).any()
    one = torch.ones(())
    assert torch.equal(fp8.fp8_gemm_plain(a_p, b_p, one),
                       fp8.fp8_gemm_plain(a_q, b_q, one))


def test_tma_operands_copy_a_base_off_16_bytes():
    a_q, b_q = _int_operands(64, 96, 40, 1)
    store = torch.zeros(64 * 96 + 4, dtype=torch.uint8)
    store[4:] = a_q.view(torch.uint8).flatten()
    a_view = store[4:].view(64, 96).view(fp8.E4M3)
    assert a_view.data_ptr() % 16 != 0
    a_p, b_p = fp8.tma_operands(a_view, b_q)
    assert a_p.data_ptr() % 16 == 0 and a_p.shape == (64, 96)
    assert torch.equal(a_p.view(torch.uint8), a_q.view(torch.uint8))
    assert torch.equal(b_p.view(torch.uint8), b_q.view(torch.uint8))


def test_fp8_gemm_on_the_cpu_is_the_plain_version_at_odd_k():
    a_q, b_q = _int_operands(5, 100, 33, 2)
    scale = torch.tensor(0.25)
    bias = torch.arange(33, dtype=torch.float32)
    assert torch.equal(fp8.fp8_gemm(a_q, b_q, scale, bias),
                       fp8.fp8_gemm_plain(a_q, b_q, scale, bias))


# -- the gate ------------------------------------------------------------------

@pytest.mark.parametrize("k", [7, 128, 768, 3072, 32768])
def test_accumulation_tolerance_is_the_derivation(k):
    """One f16 wgmma's worst case (17 addends at 2**-23) plus 2 sqrt(K)
    steps of 2**-24: between the kernel's largest reading on the card
    (1.11e-07 of the sum of absolute products) and fp8 wgmma's (1.2e-04
    at K = 768)."""
    c = fp8.accumulation_tolerance(k)
    assert c == pytest.approx((34 + 2 * math.sqrt(k)) * 2.0 ** -24,
                              rel=1e-12)
    assert 1.11e-07 < c
    assert fp8.accumulation_tolerance(768) < 1.2e-04 / 10
    # a typical output of random signs is ~1.25 / sqrt(K) of the sum of
    # absolute products: the gate allows at most 0.4% of it
    assert c < 4e-3 * 1.25 / math.sqrt(k)


def test_gemm_error_bound_scales_with_the_absolute_products():
    a_q, b_q = _int_operands(4, 64, 3, 3)
    scale = torch.tensor(-0.5)
    want = fp8.fp8_gemm_plain(a_q, b_q, scale)
    bound = fp8.gemm_error_bound(a_q, b_q, scale, want)
    abs_sum = a_q.float().abs() @ b_q.float().abs().T
    expected = (fp8.accumulation_tolerance(64) * abs_sum * 0.5
                + 2.0 ** -22 * want.abs())
    torch.testing.assert_close(bound, expected, rtol=1e-6, atol=0)
    assert fp8.gate_excess(want, want, bound) <= 0
    off = want.clone()
    off[1, 2] += bound[1, 2] * 1.5
    assert fp8.gate_excess(off, want, bound) == (
        (off - want).abs() - bound)[1, 2].item() > 0
    off[0, 0] = math.nan
    assert fp8.gate_excess(off, want, bound) == math.inf


@pytest.mark.parametrize("a_dtype", [fp8.E4M3, fp8.E5M2])
@pytest.mark.parametrize("m,k,n", [(3, 768, 4), (2, 1000, 3)])
def test_emulated_kernel_sums_keep_to_the_gate(m, k, n, a_dtype):
    g = torch.Generator().manual_seed(k + m)
    a, b = torch.randn(m, k, generator=g), torch.randn(n, k, generator=g)
    sa, sb = fp8.dynamic_scale(a, a_dtype), fp8.dynamic_scale(b, fp8.E4M3)
    a_q, b_q = (fp8.quantize_tensor(a, sa, a_dtype),
                fp8.quantize_tensor(b, sb, fp8.E4M3))
    scale = sa * sb
    want = fp8.fp8_gemm_plain(a_q, b_q, scale)
    bound = fp8.gemm_error_bound(a_q, b_q, scale, want)
    a_np, b_np = a_q.float().numpy(), b_q.float().numpy()
    got = torch.from_numpy(_tensor_core_sum(a_np, b_np, 16, 23)) * scale
    assert fp8.gate_excess(got, want, bound) <= 0
    # fp8 wgmma's narrow sums, promoted to f32 every 128 of K, fail it
    narrow = torch.from_numpy(_tensor_core_sum(a_np, b_np, 32, 13,
                                               promote=128)) * scale
    assert (narrow - want).abs().max() > 10 * (got - want).abs().max()
    assert fp8.gate_excess(narrow, want, bound) > 0


def test_the_gate_fails_an_accumulator_narrower_than_f32():
    """Rows of 256 then ones: the kernel's f32 sums keep every one; an
    accumulator of fp8 wgmma's ~14 bits carried over K drops every one
    after 65536 and fails the gate."""
    a_q, b_q = _swamp(4096)
    one = torch.ones(())
    want = fp8.fp8_gemm_plain(a_q, b_q, one)
    assert (want == 65536 + 4095).all()
    bound = fp8.gemm_error_bound(a_q, b_q, one, want)
    a, b = a_q.float().numpy(), b_q.float().numpy()
    kernel = torch.from_numpy(_tensor_core_sum(a, b, 16, 23))
    assert torch.equal(kernel, want)
    narrow = torch.from_numpy(_tensor_core_sum(a, b, 32, 13))
    assert (want - narrow).abs().max().item() == 4095
    assert fp8.gate_excess(narrow, want, bound) > 0
