"""The tensor-core kernels' arithmetic, on the CPU, against the JAX package.

On the card, bf16 runs kernel row 7 (the flash backward's dq and dk/dv
kernels, in the softmax, mask, sigmoid and bias kinds), row 8 (the bias
gradient), row 9 (the int8-QK flash forward) and row 10 (its backward) on
mma.sync (``csrc/flash_attention_bwd.cu``, ``csrc/flash_attention_dbias.cu``,
``csrc/flash_attention_int8.cu``, ``csrc/flash_attention_int8_bwd.cu``). No
CUDA kernel runs here, so this file emulates their tile order in torch:

- 64-row q tiles and 64-key tiles, causal tiles above the diagonal skipped;
- every product of bf16 values summed exactly per k16 step and added to an
  f32 accumulator, step after step, as mma.sync sums;
- p (for dv and P.V) and ds (for dq and dk) rounded to bf16 before their
  products; dq summed over key tiles and dk, dv over q tiles, in order;
- row 9's scores an exact integer product, dequantized as ((s * q_scale) *
  k_scale) * sm_scale, each product rounded, with the softmax online over
  64-key tiles (running max and sum in f32, the accumulator rescaled);
- row 10: row 9's scores, p and ds in f32 from the forward's lse, ds and p
  rounded to bf16 against the dequantized operands bf16(x_q * scale);
- row 8: per sample s and dp in mma order, ds in f32 (neither scaled nor
  rounded), the samples summed in order within batch ranges, then the
  ranges in order.

The emulation is held to JAX's Pallas kernels in interpret mode, as the JAX
suite runs them (``jimm_tpu.ops.flash_attention``'s backward in each kind
and its bias gradient, ``flash_attention_int8``'s forward and backward,
straight through the quantizer), with the card's bf16 gate: cosine >=
0.999 and max abs error <= 2^-7 of the largest reference value (of the
reference's scale, at least 1, for the backward), and an absolute 1e-5 where
the reference is zero up to rounding. One case shows that row 9's s8
mma.sync scores equal the FMA body's ``__dp4a`` sums bit for bit.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jimm_tpu.ops import flash_attention as jax_fa
from jimm_tpu.ops import flash_attention_int8 as jax_fa8
from jimm_tpu_torch.ops import flash_attention as fa
from jimm_tpu_torch.ops import flash_attention_int8 as fa8

TILE = 64
K16 = 16
NEG_INF = -1e30
BF16_MIN_COS = 0.999
BF16_REL_ERR = 2.0**-7
ZERO_REF_ABS_ERR = 1e-5


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, kept as f32."""
    return x.to(torch.bfloat16).float()


def mma_acc(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """``acc + a @ b`` as mma.sync sums: the exact products of each k16 step
    (bf16 values, so exact in f64) added to the f32 accumulator in order."""
    for k0 in range(0, a.shape[-1], K16):
        step = a[..., k0:k0 + K16].double() @ b[..., k0:k0 + K16, :].double()
        acc = acc + step.float()
    return acc


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, N, D) -> (B, N, S, D) f32."""
    return x.float().permute(0, 2, 1, 3)


def _keep(rows: range, cols: range, sq: int, sk: int, causal: bool,
          mask: torch.Tensor | None) -> torch.Tensor:
    """(B or 1, 1, rows, cols) bool: real rows and keys, the causal
    triangle, the key-padding mask."""
    r = torch.tensor(list(rows))[:, None]
    c = torch.tensor(list(cols))[None, :]
    keep = (r < sq) & (c < sk)
    if causal:
        keep = keep & (c <= r)
    keep = keep[None, None]
    if mask is not None:
        cols_in = torch.tensor([min(x, sk - 1) for x in cols])
        keep = keep & mask[:, cols_in][:, None, None, :]
    return keep


def _tile(x: torch.Tensor, r0: int) -> torch.Tensor:
    """Rows [r0, r0 + 64) of (B, N, S, D), zero past S."""
    out = torch.zeros(*x.shape[:2], TILE, x.shape[-1])
    rows = x[:, :, r0:r0 + TILE]
    out[:, :, :rows.shape[2]] = rows
    return out


def _pad_cols(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., S) zero-padded to n."""
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def emulate_bwd(q, k, v, o, lse, do, *, causal: bool, kind: str,
                mask=None, bias=None, logit_bias: float = 0.0):
    """Row 7's bf16 body in torch: (dq, dk, dv) in bf16, (B, S, N, D)."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = map(_heads, (q, k, v, do))
    delta = (None if kind == "sigmoid"
             else fa._delta(o, do, None).float())            # (B, N, Sq)
    nq = -(-sq // TILE)
    lse_p = _pad_cols(lse.float(), nq * TILE) if kind != "sigmoid" else None
    delta_p = _pad_cols(delta, nq * TILE) if delta is not None else None

    def p_ds(q0: int, k0: int):
        """p and ds of the (64 q, 64 key) tile at (q0, k0), unrounded."""
        s = mma_acc(torch.zeros(*qf.shape[:2], TILE, TILE), _tile(qf, q0),
                    _tile(kf, k0).transpose(-1, -2))
        dp = mma_acc(torch.zeros_like(s), _tile(dof, q0),
                     _tile(vf, k0).transpose(-1, -2))
        keep = _keep(range(q0, q0 + TILE), range(k0, k0 + TILE), sq, sk,
                     causal, mask)
        if kind == "sigmoid":
            p = torch.sigmoid(s * scale + logit_bias)
            p = torch.where(keep, p, 0.0)
            return p, (p * (1.0 - p)) * dp
        lse_t = lse_p[:, :, q0:q0 + TILE, None]
        delta_t = delta_p[:, :, q0:q0 + TILE, None]
        x = s * scale
        if kind == "bias":
            b = torch.zeros(bias.shape[0], TILE, TILE)
            part = bias[:, q0:q0 + TILE, k0:k0 + TILE]
            b[:, :part.shape[1], :part.shape[2]] = part
            x = x + b[None]
        p = torch.where(keep, torch.exp(x - lse_t), 0.0)
        return p, p * (dp - delta_t)

    return _bwd_tiles(p_ds, kf, qf, dof, sq, sk, causal, scale)


def _bwd_tiles(p_ds, k_op: torch.Tensor, q_op: torch.Tensor,
               dof: torch.Tensor, sq: int, sk: int, causal: bool,
               scale: float):
    """The dq and dk/dv kernels' loops: (dq, dk, dv) in bf16, (B, S, N, D),
    from ``p_ds(q0, k0)``, the unrounded p and ds of a (64 q, 64 key) tile,
    and the (B, N, S, D) operands of dq (``k_op``) and dk (``q_op``)."""
    d = k_op.shape[-1]
    nq, nk = -(-sq // TILE), -(-sk // TILE)
    # dq: per 64-row q tile, the key tiles in order
    dq = torch.zeros(*q_op.shape[:2], nq * TILE, d)
    for qi in range(nq):
        q0 = qi * TILE
        kv_end = min(sk, q0 + TILE) if causal else sk
        acc = torch.zeros(*q_op.shape[:2], TILE, d)
        for k0 in range(0, kv_end, TILE):
            _, ds = p_ds(q0, k0)
            acc = mma_acc(acc, _bf16(ds), _tile(k_op, k0))
        dq[:, :, q0:q0 + TILE] = acc * scale
    # dk, dv: per 64-key tile, the q tiles in order
    dk = torch.zeros(*k_op.shape[:2], nk * TILE, d)
    dv = torch.zeros_like(dk)
    for ki in range(nk):
        k0 = ki * TILE
        acc_k = torch.zeros(*k_op.shape[:2], TILE, d)
        acc_v = torch.zeros_like(acc_k)
        # causal: q tiles before this key tile never attend to it
        for q0 in range(k0 if causal else 0, sq, TILE):
            p, ds = p_ds(q0, k0)
            acc_v = mma_acc(acc_v, _bf16(p).transpose(-1, -2), _tile(dof, q0))
            acc_k = mma_acc(acc_k, _bf16(ds).transpose(-1, -2),
                            _tile(q_op, q0))
        dk[:, :, k0:k0 + TILE] = acc_k * scale
        dv[:, :, k0:k0 + TILE] = acc_v

    def out(x: torch.Tensor, s: int) -> torch.Tensor:
        return x[:, :, :s].permute(0, 2, 1, 3).to(torch.bfloat16)

    return out(dq, sq), out(dk, sk), out(dv, sk)


def s8_scores(qq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """(B, N, Sq, Sk) s32 scores as s8 mma.sync sums them: exact products
    of each k32 step of D (zero-padded), added in s32 step after step."""
    a, b = _heads(qq).long(), _heads(kq).long()
    d = a.shape[-1]
    pad = -(-d // 32) * 32 - d
    a, b = (torch.nn.functional.pad(x, (0, pad)) for x in (a, b))
    acc = torch.zeros(*a.shape[:3], b.shape[2], dtype=torch.int64)
    for k0 in range(0, a.shape[-1], 32):
        acc = acc + a[..., k0:k0 + 32] @ b[..., k0:k0 + 32].transpose(-1, -2)
        assert acc.abs().max() < 2**31  # s32 never wraps
    return acc.int()


def dp4a_scores(qq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """The FMA body's s32 scores: __dp4a over the rows' 4-byte words, one
    word after another (csrc/flash_int8.cuh::tile_dots_i8)."""
    a, b = _heads(qq).long(), _heads(kq).long()
    d = a.shape[-1]
    pad = -(-d // 4) * 4 - d
    a, b = (torch.nn.functional.pad(x, (0, pad)) for x in (a, b))
    acc = torch.zeros(*a.shape[:3], b.shape[2], dtype=torch.int64)
    for w in range(0, a.shape[-1], 4):
        acc = acc + a[..., w:w + 4] @ b[..., w:w + 4].transpose(-1, -2)
        assert acc.abs().max() < 2**31
    return acc.int()


def emulate_int8_fwd(qq, qs, kq, ks, v, *, causal: bool):
    """Row 9's bf16 body in torch: (o, lse) from the quantized q and k."""
    sq, sk, d = qq.shape[1], kq.shape[1], qq.shape[-1]
    scale = 1.0 / math.sqrt(d)
    s32 = s8_scores(qq, kq).float()
    nq = -(-sq // TILE)
    vf = _heads(v)
    o = torch.zeros(*vf.shape[:2], nq * TILE, d)
    lse = torch.zeros(*vf.shape[:2], nq * TILE)
    q_scale = _pad_cols(qs, nq * TILE)[..., None]   # (B, N, Sq, 1)
    k_scale = _pad_cols(ks, -(-sk // TILE) * TILE)  # (B, N, Sk)
    s32 = torch.nn.functional.pad(s32, (0, k_scale.shape[-1] - sk,
                                        0, nq * TILE - sq))
    for qi in range(nq):
        q0 = qi * TILE
        m = torch.full((*vf.shape[:2], TILE, 1), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(*vf.shape[:2], TILE, d)
        kv_end = min(sk, q0 + TILE) if causal else sk
        for k0 in range(0, kv_end, TILE):
            s = s32[:, :, q0:q0 + TILE, k0:k0 + TILE]
            s = ((s * q_scale[:, :, q0:q0 + TILE])
                 * k_scale[:, :, None, k0:k0 + TILE]) * scale
            keep = _keep(range(q0, q0 + TILE), range(k0, k0 + TILE), 10**9,
                         sk, causal, None)
            s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = mma_acc(acc * corr, _bf16(p), _tile(vf, k0))
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        o[:, :, q0:q0 + TILE] = acc / l_safe
        lse[:, :, q0:q0 + TILE] = (m + torch.log(l_safe))[..., 0]
    return (o[:, :, :sq].permute(0, 2, 1, 3).to(torch.bfloat16),
            lse[:, :, :sq])


def _dequant_heads(x_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(B, N, S, D) f32 of the bf16 operand bf16(x_q * scale), the product
    rounded on its own (the TPU kernel's _dequant_operand)."""
    return _bf16(_heads(x_q) * scale[..., None])


def emulate_int8_bwd(qq, qs, kq, ks, v, o, lse, do, *, causal: bool):
    """Row 10's bf16 body in torch: (dq, dk, dv) in bf16, (B, S, N, D)."""
    sq, sk, d = qq.shape[1], kq.shape[1], qq.shape[-1]
    scale = 1.0 / math.sqrt(d)
    vf, dof = _heads(v), _heads(do)
    nq, nk = -(-sq // TILE), -(-sk // TILE)
    s32 = torch.nn.functional.pad(s8_scores(qq, kq).float(),
                                  (0, nk * TILE - sk, 0, nq * TILE - sq))
    q_scale = _pad_cols(qs, nq * TILE)[..., None]    # (B, N, Sq, 1)
    k_scale = _pad_cols(ks, nk * TILE)[:, :, None]   # (B, N, 1, Sk)
    lse_p = _pad_cols(lse.float(), nq * TILE)[..., None]
    delta_p = _pad_cols(fa._delta(o, do, None).float(), nq * TILE)[..., None]

    def p_ds(q0: int, k0: int):
        s = s32[:, :, q0:q0 + TILE, k0:k0 + TILE]
        s = ((s * q_scale[:, :, q0:q0 + TILE])
             * k_scale[..., k0:k0 + TILE]) * scale
        dp = mma_acc(torch.zeros_like(s), _tile(dof, q0),
                     _tile(vf, k0).transpose(-1, -2))
        keep = _keep(range(q0, q0 + TILE), range(k0, k0 + TILE), sq, sk,
                     causal, None)
        p = torch.where(keep, torch.exp(s - lse_p[:, :, q0:q0 + TILE]), 0.0)
        return p, p * (dp - delta_p[:, :, q0:q0 + TILE])

    return _bwd_tiles(p_ds, _dequant_heads(kq, ks), _dequant_heads(qq, qs),
                      dof, sq, sk, causal, scale)


def emulate_dbias(q, k, v, bias, o, lse, do, *, causal: bool,
                  b_range: int) -> torch.Tensor:
    """Row 8's bf16 body in torch: dbias, (N, Sq, Sk) f32, the batch summed
    in ranges of ``b_range`` samples, then the ranges in order."""
    d = q.shape[-1]
    qf, kf, vf, dof = map(_heads, (q, k, v, do))
    # s and dp are sums over D in k16 steps, whatever the tile of a pair
    s = mma_acc(torch.zeros(*qf.shape[:3], kf.shape[2]), qf,
                kf.transpose(-1, -2))
    dp = mma_acc(torch.zeros_like(s), dof, vf.transpose(-1, -2))
    x = s * (1.0 / math.sqrt(d)) + bias[None]
    p = torch.exp(x - lse.float()[..., None])
    ds = p * (dp - fa._delta(o, do, None).float()[..., None])
    keep = _keep(range(q.shape[1]), range(k.shape[1]), q.shape[1],
                 k.shape[1], causal, None)
    ds = torch.where(keep, ds, 0.0)
    ranges = []
    for b0 in range(0, q.shape[0], b_range):
        acc = ds[b0]
        for b in range(b0 + 1, min(q.shape[0], b0 + b_range)):
            acc = acc + ds[b]
        ranges.append(acc)
    out = ranges[0]
    for part in ranges[1:]:
        out = out + part
    return out


def _gate(got: torch.Tensor, want, scaled: bool, what: str) -> None:
    """The card's bf16 gate; ``scaled``: both divided by the reference's
    largest magnitude (at least 1), as the backward's gate does."""
    got = got.float().numpy().astype(np.float64).ravel()
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64).ravel()
    assert np.isfinite(got).all(), what
    peak = np.abs(want).max()
    if scaled:
        got, want = got / max(1.0, peak), want / max(1.0, peak)
        peak = np.abs(want).max()
    err = np.abs(got - want).max()
    if peak <= 1e-6:
        assert err <= ZERO_REF_ABS_ERR, f"{what}: err {err} (zero reference)"
        return
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos >= BF16_MIN_COS, f"{what}: cosine {cos}"
    assert err <= BF16_REL_ERR * peak + 1e-6, f"{what}: err {err} peak {peak}"


def _inputs(b: int, sq: int, sk: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, 2, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, sk, 2, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _mask(b: int, sk: int, seed: int) -> np.ndarray:
    """(B, Sk) bool, ~60% of keys attended, key 0 always (every row has a
    key)."""
    m = np.random.default_rng(seed).random((b, sk)) > 0.4
    m[:, 0] = True
    return m


def _bias(sq: int, sk: int, seed: int, neginf: bool) -> np.ndarray:
    """(2, Sq, Sk) f32; ``neginf``: ~30% of entries -inf, key 0 finite."""
    rng = np.random.default_rng(seed)
    bias = rng.standard_normal((2, sq, sk)).astype(np.float32)
    if neginf:
        bias[rng.random((2, sq, sk)) < 0.3] = -np.inf
        bias[:, :, 0] = 0.5
    return bias


@functools.lru_cache(maxsize=None)
def _jax_vjp(kind: str, causal: bool):
    def run(q, k, v, do, extra):
        if kind == "mask":
            fn = functools.partial(jax_fa.flash_attention_masked, mask=extra,
                                   is_causal=causal)
        elif kind == "bias":
            fn = functools.partial(jax_fa.flash_attention_bias, bias=extra,
                                   is_causal=causal)
        elif kind == "sigmoid":
            fn = functools.partial(jax_fa.sigmoid_attention,
                                   is_causal=causal, logit_bias=extra)
        else:
            fn = functools.partial(jax_fa.flash_attention, is_causal=causal)
        o, vjp = jax.vjp(fn, q, k, v)
        return o, vjp(do)
    return jax.jit(run, static_argnums=(4,) if kind == "sigmoid" else ())


#: (kind, B, Sq, Sk, D, causal, extra): the JAX suite's odd sequence
#: lengths 1, 5 and 257 and head dims 64 and 80, causal and not
BWD_CASES = [("softmax", 1, 257, 257, 64, True, None),
             ("softmax", 2, 5, 5, 80, False, None),
             ("mask", 1, 257, 257, 80, False, None),
             ("mask", 2, 5, 5, 64, True, None),
             ("sigmoid", 2, 1, 257, 80, False, None),
             ("sigmoid", 1, 257, 257, 64, True, None),
             ("bias", 2, 5, 5, 80, True, "full"),
             ("bias", 1, 257, 257, 64, False, "neginf")]


@pytest.mark.parametrize("kind,b,sq,sk,d,causal,extra", BWD_CASES)
def test_backward_tile_order_matches_jax(kind, b, sq, sk, d, causal, extra):
    q, k, v, do = _inputs(b, sq, sk, d, sq * 7 + sk + d)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    mask = bias = None
    logit_bias = fa.default_logit_bias(sk)
    if kind == "mask":
        mask = _mask(b, sk, sq + d)
        jextra = jnp.asarray(mask)
        o, lse = fa.flash_attention_plain(tq, tk, tv, is_causal=causal,
                                          mask=torch.from_numpy(mask))
    elif kind == "bias":
        bias = _bias(sq, sk, sq + d, extra == "neginf")
        jextra = jnp.asarray(bias)
        o, lse = fa.flash_attention_bias_plain(tq, tk, tv,
                                               torch.from_numpy(bias),
                                               is_causal=causal)
    elif kind == "sigmoid":
        jextra, o, lse = logit_bias, None, None
    else:
        jextra = jnp.zeros(())
        o, lse = fa.flash_attention_plain(tq, tk, tv, is_causal=causal)
    jo, want = _jax_vjp(kind, causal)(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, do)),
        jextra)
    if o is not None:
        # the backward's residual o (its delta) as JAX's backward has it:
        # the bf16 o of JAX's forward; lse from the plain forward (f32, one
        # pass, as JAX's at S <= 512)
        o = torch.from_numpy(np.asarray(jo.astype(jnp.float32))).to(
            torch.bfloat16)
    got = emulate_bwd(tq, tk, tv, o, lse, tdo, causal=causal, kind=kind,
                      mask=None if mask is None else torch.from_numpy(mask),
                      bias=None if bias is None else torch.from_numpy(bias),
                      logit_bias=logit_bias)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _gate(g, w, scaled=True, what=f"{kind} {name}")


#: (B, Sq, Sk, D, causal)
INT8_CASES = [(1, 257, 257, 64, True), (2, 5, 5, 80, False),
              (2, 1, 257, 80, False)]


@pytest.mark.parametrize("b,sq,sk,d,causal", INT8_CASES)
def test_int8_forward_tile_order_matches_jax(b, sq, sk, d, causal):
    q, k, v, _ = _inputs(b, sq, sk, d, sq * 5 + sk + d)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    qq, qs = fa8.quantize_heads(tq)
    kq, ks = fa8.quantize_heads(tk)
    o, lse = emulate_int8_fwd(qq, qs, kq, ks, tv, causal=causal)
    want = jax.jit(functools.partial(jax_fa8.flash_attention_int8,
                                     is_causal=causal))(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)))
    _gate(o, want, scaled=False, what="int8 o")
    # the online softmax's lse against the plain version's one pass
    _, plain_lse = fa8.flash_attention_int8_plain(qq, qs, kq, ks, tv,
                                                  is_causal=causal)
    np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), atol=1e-4)


@pytest.mark.parametrize("d", [30, 64, 80])
def test_s8_mma_scores_equal_the_dp4a_sums_bit_for_bit(d):
    """s8 mma.sync's k32 steps and __dp4a's words sum the same integers:
    both exact in s32, so the scores agree bit for bit, also at the
    extremes (every value -127 or 127)."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.integers(-127, 128, (2, 70, 2, d),
                                      dtype=np.int8))
    k = torch.from_numpy(rng.integers(-127, 128, (2, 65, 2, d),
                                      dtype=np.int8))
    q[0, 0], k[0, 0] = 127, -127
    mma, dp4a = s8_scores(q, k), dp4a_scores(q, k)
    assert mma.dtype == dp4a.dtype == torch.int32
    assert torch.equal(mma, dp4a)
    assert mma[0, :, 0, 0].tolist() == [-127 * 127 * d] * 2
    # and the plain version's float matmul of the int8 values
    plain = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    assert torch.equal(mma.float(), plain)


@pytest.mark.parametrize("b,sq,sk,d,causal", INT8_CASES)
def test_int8_backward_tile_order_matches_jax(b, sq, sk, d, causal):
    """Row 10's emulation against ``jax.vjp`` of JAX's int8-QK flash
    attention (the gradients straight through the quantizer), from the
    same quantized q and k, JAX's own forward o (for delta) and the plain
    forward's lse (one pass, as JAX's at S <= 512)."""
    q, k, v, do = _inputs(b, sq, sk, d, sq * 11 + sk + d)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    qq, qs = fa8.quantize_heads(tq)
    kq, ks = fa8.quantize_heads(tk)
    _, lse = fa8.flash_attention_int8_plain(qq, qs, kq, ks, tv,
                                            is_causal=causal)

    def run(q, k, v, do):
        o, vjp = jax.vjp(functools.partial(jax_fa8.flash_attention_int8,
                                           is_causal=causal), q, k, v)
        return o, vjp(do)

    jo, want = jax.jit(run)(*(jnp.asarray(x).astype(jnp.bfloat16)
                              for x in (q, k, v, do)))
    o = torch.from_numpy(np.asarray(jo.astype(jnp.float32))).to(
        torch.bfloat16)
    got = emulate_int8_bwd(qq, qs, kq, ks, tv, o, lse, tdo, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _gate(g, w, scaled=True, what=f"int8 {name}")


#: (B, Sq, Sk, D, causal, bias shape, -inf keys): three samples summed in
#: two ranges (of 2 and 1)
DBIAS_CASES = [(3, 257, 257, 64, False, "full", True),
               (3, 5, 5, 80, True, "2d", True),
               (3, 1, 257, 80, False, "2d", False)]


@pytest.mark.parametrize("b,sq,sk,d,causal,shape,neginf", DBIAS_CASES)
def test_dbias_batch_ranges_match_jax(b, sq, sk, d, causal, shape, neginf):
    """Row 8's emulation against ``jax.vjp`` of JAX's biased flash
    attention with respect to the bias: an (N, Sq, Sk) bias, or an (Sq,
    Sk) one whose gradient is the heads' sum; -inf entries get zero."""
    q, k, v, do = _inputs(b, sq, sk, d, sq * 13 + sk + d)
    rng = np.random.default_rng(sq + sk + d)
    bias = rng.standard_normal((sq, sk) if shape == "2d" else (2, sq, sk))
    bias = bias.astype(np.float32)
    if neginf:
        bias[rng.random(bias.shape) < 0.3] = -np.inf
        bias[..., 0] = 0.5  # every row keeps a finite key
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    bias3 = torch.from_numpy(bias).expand(2, sq, sk)
    _, lse = fa.flash_attention_bias_plain(tq, tk, tv, bias3,
                                           is_causal=causal)

    def run(q, k, v, do, bias):
        o, vjp = jax.vjp(lambda b: jax_fa.flash_attention_bias(
            q, k, v, bias=b, is_causal=causal), bias)
        return o, vjp(do)[0]

    jo, want = jax.jit(run)(*(jnp.asarray(x).astype(jnp.bfloat16)
                              for x in (q, k, v, do)), jnp.asarray(bias))
    o = torch.from_numpy(np.asarray(jo.astype(jnp.float32))).to(
        torch.bfloat16)
    got = emulate_dbias(tq, tk, tv, bias3, o, lse, tdo, causal=causal,
                        b_range=2)
    if shape == "2d":
        got = got.sum(0)
    assert got.shape == want.shape
    _gate(got, want, scaled=True, what="dbias")
    assert not got[torch.from_numpy(np.isinf(bias))].any()
