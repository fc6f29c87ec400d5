"""Sequence-parallel attention plans, ring KV rotation and Ulysses head
scatter, behind one planner; the counterpart of
``jimm_tpu/parallel/seqpar.py``.

q, k and v are this rank's chunks ``(B, S/p, N, D)`` of a sequence sharded
over a ``p``-way mesh axis, and so is the result (JAX's functions take the
global arrays and ``shard_map`` cuts them; here every rank already holds
its chunk). The ring keeps q local and rotates the k/v chunk, and the
key-padding mask rows with it, around the axis with ``comm.ppermute``,
folding each hop into the online-softmax carry; sigmoid hops just add.

The backward is written out (one ``torch.autograd.Function``, JAX's
``custom_vjp``): each hop's probabilities are recomputed against the saved
global ``(o, lse)``, and ``(k, v, mask, dk, dv)`` rotate together so the
gradient accumulators ride the same ring, one last hop homing dk/dv. No
hop's k/v chunk is saved.

``impl="flash"`` runs each hop's local product on the flash kernels
through ``ring_hop_fwd`` / ``ring_hop_bwd`` (rows 3/4/6 forward, row 7
backward), ``impl="einsum"`` in plain f32 math (causal too); ``"auto"``
picks flash on CUDA tensors for the non-causal kinds. The hops use the
kernels' compiled tiles: JAX's ``_resolve_ring_blocks`` looks block sizes
up in its tune cache; the port's tune cache (`jimm_tpu_torch/tune/`) keeps
for ``ring_attention`` the one compiled tile, so there is nothing to
resolve here.

Observability: every hop runs under a ``ring_hop`` span and a
``ring_hop{j}`` profiler range, and ``jimm_ring_bytes_permuted_total``
counts the plan's forward bytes per call (this rank's share; JAX's counter
sums every device's).
"""

from __future__ import annotations

import math
from contextlib import ExitStack

import torch
from torch.distributed.device_mesh import DeviceMesh

from jimm_tpu_torch.obs import get_registry, span
from jimm_tpu_torch.ops.flash_attention import ring_hop_bwd, ring_hop_fwd
from jimm_tpu_torch.parallel import comm
from jimm_tpu_torch.parallel.comm import AxisGroup

NEG_INF = -1e30

__all__ = ["plan_seq_parallel", "ring_attention_sp", "seq_parallel_attention",
           "seqpar_comm_bytes"]


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def seqpar_comm_bytes(b: int, s: int, n: int, d: int, p: int, *,
                      itemsize: int = 2, plan: str = "ring",
                      masked: bool = False) -> int:
    """Per-rank bytes moved by one forward of a plan over a ``p``-way axis
    for a global sequence ``s``: ring, ``p - 1`` hops of the local k and v
    chunks (and the f32 mask rows when masked); ulysses, the tiled
    all-to-alls of q, k, v in and o out, ``(p - 1)/p`` of each local
    tensor."""
    local = (s // p) * n * d * itemsize * b
    if plan == "ring":
        bytes_ = 2 * (p - 1) * local
        if masked:
            bytes_ += (p - 1) * b * (s // p) * 4
        return bytes_
    if plan == "ulysses":
        return 4 * local * (p - 1) // p
    raise ValueError(f"unknown seq-parallel plan {plan!r}")


def plan_seq_parallel(num_heads: int, axis_n: int, *,
                      plan: str = "auto") -> str:
    """Ring vs Ulysses for a ``p``-way axis: Ulysses needs ``heads % p ==
    0``, and moves ``4 (p-1)/p^2`` of the activations against the ring's
    ``2 (p-1)/p``, so ``"auto"`` is Ulysses iff divisible and ``p > 2``."""
    if plan != "auto":
        if plan not in ("ring", "ulysses"):
            raise ValueError(f"unknown seq-parallel plan {plan!r}")
        if plan == "ulysses" and num_heads % axis_n:
            raise ValueError(
                f"ulysses needs num_heads ({num_heads}) divisible by the "
                f"seq axis ({axis_n}); use plan='ring'")
        return plan
    if num_heads % axis_n == 0 and axis_n > 2:
        return "ulysses"
    return "ring"


# ---------------------------------------------------------------------------
# Ring core: one hop loop, three variants, a written-out backward
# ---------------------------------------------------------------------------

def _rotate(grp: AxisGroup, *xs: torch.Tensor | None):
    """Every non-None operand one step around the ring, operands of one
    dtype packed into one exchange."""
    perm = comm.ring_perm(grp.size)
    out: list[torch.Tensor | None] = list(xs)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, x in enumerate(xs):
        if x is not None:
            by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        moved = comm._ppermute(flat, grp, perm)
        for i, piece in zip(idx, moved.split([xs[i].numel() for i in idx])):
            out[i] = piece.view(xs[i].shape)
    return tuple(out)


def _hop_span(j: int) -> ExitStack:
    """The host span and the profiler range of ring hop ``j``."""
    stack = ExitStack()
    stack.enter_context(span("ring_hop"))
    stack.enter_context(torch.profiler.record_function(f"ring_hop{j}"))
    return stack


def _hop_scores(q, k_cur, mask_cur, sm_scale, q_pos, k_pos):
    """f32 ``(B, N, Sq, Sk)`` scores of one (local q x visiting chunk)
    product, with the travelling additive mask rows and, when the global
    positions are given, the causal term."""
    s = torch.einsum("bqnd,bknd->bnqk", q.float() * sm_scale, k_cur.float())
    if mask_cur is not None:
        s = s + mask_cur[:, None, None, :]
    if q_pos is not None:
        s = s + torch.where(k_pos[None, :] <= q_pos[:, None], 0.0,
                            NEG_INF)[None, None]
    return s


def _positions(grp: AxisGroup, j: int, sq: int, causal: bool, device):
    """Global positions of the local queries and of hop ``j``'s keys."""
    if not causal:
        return None, None
    src = (grp.index - j) % grp.size  # the ring owner of the visiting chunk
    ar = torch.arange(sq, device=device)
    return grp.index * sq + ar, src * sq + ar


def _keep(maskrows: torch.Tensor | None) -> torch.Tensor | None:
    """Additive f32 rows -> the kernels' ``(B, Sk)`` bool mask."""
    return None if maskrows is None else maskrows > NEG_INF / 2


def _ring_fwd(q, k, v, maskrows, grp, kind, causal, sm_scale, logit_bias,
              impl):
    """``(o, lse)`` of this rank's queries over every chunk (lse None for
    sigmoid)."""
    b, sq, n, d = q.shape
    k_cur, v_cur, mask_cur = k, v, maskrows
    lse = torch.full((b, n, sq), NEG_INF, dtype=torch.float32,
                     device=q.device)
    m = lse.clone()
    l = torch.zeros((b, n, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, n, d), dtype=torch.float32, device=q.device)
    for j in range(grp.size):
        with _hop_span(j):
            if impl == "flash":
                o_blk, lse_blk = ring_hop_fwd(q, k_cur, v_cur,
                                              _keep(mask_cur), kind,
                                              logit_bias=logit_bias)
                if kind == "sigmoid":
                    acc = acc + o_blk.float()
                else:
                    lse_new = torch.logaddexp(lse, lse_blk)
                    acc = (acc * torch.exp(lse - lse_new).transpose(1, 2)[
                        ..., None] + o_blk.float() * torch.exp(
                            lse_blk - lse_new).transpose(1, 2)[..., None])
                    lse = lse_new
            else:
                q_pos, k_pos = _positions(grp, j, sq, causal, q.device)
                s = _hop_scores(q, k_cur, mask_cur, sm_scale, q_pos, k_pos)
                if kind == "sigmoid":
                    p = torch.sigmoid(s + logit_bias)
                    acc = acc + torch.einsum("bnqk,bknd->bqnd", p,
                                             v_cur.float())
                else:
                    m_new = torch.maximum(m, s.amax(dim=-1))
                    p = torch.exp(s - m_new[..., None])
                    scale = torch.exp(m - m_new)
                    l = l * scale + p.sum(dim=-1)
                    acc = (acc * scale.transpose(1, 2)[..., None]
                           + torch.einsum("bnqk,bknd->bqnd", p,
                                          v_cur.float()))
                    m = m_new
            if j != grp.size - 1:
                k_cur, v_cur, mask_cur = _rotate(grp, k_cur, v_cur, mask_cur)
    if kind == "sigmoid":
        return acc.to(q.dtype), None
    if impl == "flash":
        return acc.to(q.dtype), lse
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (acc / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
    return o, m + torch.log(l_safe)


def _ring_bwd(q, k, v, maskrows, o, lse, do, grp, kind, causal, sm_scale,
              logit_bias, impl):
    """``(dq, dk, dv)``: each hop's tile recomputed against the global
    ``(o, lse)``; ``(k, v, mask, dk, dv)`` rotate together and a last hop
    homes dk and dv."""
    b, sq, n, d = q.shape
    k_cur, v_cur, mask_cur = k, v, maskrows
    dq = torch.zeros((b, sq, n, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    do32 = do.float()
    delta = None
    if impl != "flash" and kind == "softmax":
        # o is global: delta already holds every chunk's share
        delta = (do32 * o.float()).sum(dim=-1).transpose(1, 2)
    for j in range(grp.size):
        with _hop_span(j):
            if impl == "flash":
                dq_h, dk_h, dv_h = ring_hop_bwd(q, k_cur, v_cur,
                                                _keep(mask_cur), o, lse, do,
                                                kind, logit_bias=logit_bias)
                dq_h, dk_h, dv_h = dq_h.float(), dk_h.float(), dv_h.float()
            else:
                q_pos, k_pos = _positions(grp, j, sq, causal, q.device)
                s = _hop_scores(q, k_cur, mask_cur, sm_scale, q_pos, k_pos)
                dp = torch.einsum("bqnd,bknd->bnqk", do32, v_cur.float())
                if kind == "sigmoid":
                    p = torch.sigmoid(s + logit_bias)
                    ds = p * (1.0 - p) * dp
                else:
                    p = torch.exp(s - lse[..., None])
                    ds = p * (dp - delta[..., None])
                dq_h = sm_scale * torch.einsum("bnqk,bknd->bqnd", ds,
                                               k_cur.float())
                dk_h = sm_scale * torch.einsum("bnqk,bqnd->bknd", ds,
                                               q.float())
                dv_h = torch.einsum("bnqk,bqnd->bknd", p, do32)
            dq = dq + dq_h
            dk = dk + dk_h
            dv = dv + dv_h
            if j != grp.size - 1:
                k_cur, v_cur, mask_cur, dk, dv = _rotate(
                    grp, k_cur, v_cur, mask_cur, dk, dv)
    # the accumulators hold the grads of chunk (index + 1): one more hop
    dk, dv = _rotate(grp, dk, dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingCore(torch.autograd.Function):
    """The ring's o, differentiable in q, k and v (not in the mask rows)."""

    @staticmethod
    def forward(ctx, q, k, v, maskrows, grp, kind, causal, sm_scale,
                logit_bias, impl):
        o, lse = _ring_fwd(q, k, v, maskrows, grp, kind, causal, sm_scale,
                           logit_bias, impl)
        # one local chunk each: no hop's k/v is kept
        ctx.save_for_backward(q, k, v, maskrows, o, lse)
        ctx.args = (grp, kind, causal, sm_scale, logit_bias, impl)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, maskrows, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, maskrows, o, lse, do.contiguous(),
                               *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def canon_mask_rows(mask: torch.Tensor, b: int, sk: int) -> torch.Tensor:
    """Bool key-padding mask chunk ((B, Sk) or (B, 1, 1, Sk)) -> additive
    f32 ``(B, Sk)`` rows (0 keep / -1e30 drop), the form that rotates."""
    if mask.ndim == 4:
        if mask.shape[1] != 1 or mask.shape[2] != 1:
            raise ValueError(
                "sequence-parallel attention supports KEY-PADDING masks "
                f"only ((B, Sk) or (B, 1, 1, Sk)); got {tuple(mask.shape)}")
        mask = mask[:, 0, 0, :]
    if tuple(mask.shape) != (b, sk):
        raise ValueError(f"key-padding mask shape {tuple(mask.shape)} does "
                         f"not match (B, Sk)=({b}, {sk})")
    return torch.where(mask != 0, 0.0, NEG_INF).to(torch.float32)


def count_permuted_bytes(q: torch.Tensor, p: int, *, plan: str,
                         masked: bool) -> None:
    b, sq, n, d = q.shape
    get_registry("jimm_ring").counter("jimm_ring_bytes_permuted_total").inc(
        seqpar_comm_bytes(b, sq * p, n, d, p, itemsize=q.element_size(),
                          plan=plan, masked=masked))


def ring_attention_sp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mask: torch.Tensor | None = None, kind: str = "softmax",
                      is_causal: bool = False, mesh: DeviceMesh | None = None,
                      axis_name: str = "seq", impl: str = "auto",
                      logit_bias: float | None = None) -> torch.Tensor:
    """Exact attention of this rank's ``(B, S/p, N, D)`` chunks of a
    sequence sharded over ``axis_name``; ``mask`` is this rank's chunk of a
    key-padding mask and rotates with k/v. ``kind``: ``"softmax"``
    (optionally masked or causal) or ``"sigmoid"`` (``logit_bias`` defaults
    to ``-log(S)`` of the global length, as the single-device op's default
    of its whole sequence). ``impl``: ``"einsum"``, ``"flash"`` (non-causal
    only) or ``"auto"`` (flash on CUDA tensors unless causal)."""
    if kind not in ("softmax", "sigmoid"):
        raise ValueError(f"unknown ring variant kind {kind!r}")
    grp = comm.axis_group(axis_name, mesh)
    b, sq, n, d = q.shape
    if k.shape[1] != sq:
        raise ValueError("ring attention shards one sequence axis; "
                         f"Sq={sq} != Sk={k.shape[1]}")
    if kind == "sigmoid" and logit_bias is None:
        logit_bias = -math.log(max(k.shape[1] * grp.size, 1))
    maskrows = None if mask is None else canon_mask_rows(mask, b, sq)
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" and not is_causal \
            else "einsum"
    if impl not in ("einsum", "flash"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    if impl == "flash" and is_causal:
        raise ValueError("the per-hop flash ring is non-causal (the hop "
                         "mask is key-padding rows); causal softmax rings "
                         "go through parallel/ring_attention.py")
    count_permuted_bytes(q, grp.size, plan="ring", masked=mask is not None)
    return _RingCore.apply(q, k, v, maskrows, grp, kind, is_causal,
                           1.0 / math.sqrt(d),
                           0.0 if logit_bias is None else float(logit_bias),
                           impl)


def seq_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           mask: torch.Tensor | None = None,
                           kind: str = "softmax", is_causal: bool = False,
                           mesh: DeviceMesh | None = None,
                           axis_name: str = "seq", plan: str = "auto",
                           impl: str = "auto",
                           logit_bias: float | None = None) -> torch.Tensor:
    """Both plans behind one entry: ring or Ulysses by
    :func:`plan_seq_parallel`, then the plan. Exact either way."""
    grp = comm.axis_group(axis_name, mesh)
    plan = plan_seq_parallel(q.shape[2], grp.size, plan=plan)
    if plan == "ulysses":
        from jimm_tpu_torch.parallel.ulysses import ulysses_attention
        count_permuted_bytes(q, grp.size, plan="ulysses",
                             masked=mask is not None)
        return ulysses_attention(q, k, v, mask=mask, kind=kind,
                                 is_causal=is_causal, mesh=mesh,
                                 axis_name=axis_name, impl=impl,
                                 logit_bias=logit_bias)
    return ring_attention_sp(q, k, v, mask=mask, kind=kind,
                             is_causal=is_causal, mesh=mesh,
                             axis_name=axis_name, impl=impl,
                             logit_bias=logit_bias)
