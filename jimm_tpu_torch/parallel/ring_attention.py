"""Ring attention: exact attention over a sequence sharded across ranks;
the counterpart of ``jimm_tpu/parallel/ring_attention.py``.

Each rank keeps its query chunk while the key/value chunks travel around
the ring (``comm.ppermute``, one exchange a step for k and v stacked);
an online softmax in f32 makes the result equal to full attention. Unlike
`seqpar.ring_attention_sp`, the backward is autograd's, through the
differentiable ``ppermute`` (JAX differentiates through its
scan-of-ppermute the same way).

``impl="flash"`` runs each local (q x kv-chunk) product through
``flash_attention_lse`` (rows 3 and 7) and merges the chunks by logsumexp;
causal runs block-causally: the own chunk causal, earlier owners' chunks
in full, later owners' chunks skipped. ``zigzag=True`` takes the
`zigzag_order` layout, in which every rank does two half-chunk products a
step whatever its position, so the causal skip no longer leaves the last
rank working every round.

q, k, v are this rank's ``(B, S/p, N, D)`` chunks (JAX's takes the global
arrays); the result is this rank's chunk of the output.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from jimm_tpu_torch.ops.flash_attention import flash_attention_lse
from jimm_tpu_torch.parallel import comm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Zigzag sequence layout (causal load balancing)
# ---------------------------------------------------------------------------

def zigzag_order(seq_len: int, n_dev: int) -> np.ndarray:
    """Permutation taking the natural sequence order to the zigzag layout:
    block i of the output is chunk i followed by chunk 2n-1-i, so
    contiguous sharding over ``n_dev`` ranks gives each its zigzag pair."""
    if seq_len % (2 * n_dev):
        raise ValueError(f"seq_len {seq_len} not divisible by 2*{n_dev}")
    c = seq_len // (2 * n_dev)
    parts = []
    for i in range(n_dev):
        parts.append(np.arange(i * c, (i + 1) * c))
        j = 2 * n_dev - 1 - i
        parts.append(np.arange(j * c, (j + 1) * c))
    return np.concatenate(parts)


def zigzag_shard(x: torch.Tensor, n_dev: int, axis: int = 1) -> torch.Tensor:
    """Reorder ``axis`` from natural to zigzag layout."""
    order = torch.from_numpy(zigzag_order(x.shape[axis], n_dev))
    return x.index_select(axis, order.to(x.device))


def zigzag_unshard(x: torch.Tensor, n_dev: int,
                   axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard`."""
    inverse = np.argsort(zigzag_order(x.shape[axis], n_dev))
    return x.index_select(axis, torch.from_numpy(inverse).to(x.device))


def _positions(dev: int, local_len: int, n_dev: int, zigzag: bool,
               device) -> torch.Tensor:
    """Global sequence positions of rank ``dev``'s chunk."""
    ar = torch.arange(local_len, device=device)
    if not zigzag:
        return dev * local_len + ar
    if local_len % 2:
        raise ValueError("zigzag needs an even local sequence length")
    h = local_len // 2
    return torch.cat([dev * h + ar[:h], (2 * n_dev - 1 - dev) * h + ar[:h]])


def _ring(grp: comm.AxisGroup, kv: torch.Tensor) -> torch.Tensor:
    return comm.ppermute(kv, grp, comm.ring_perm(grp.size))


def _in_graph(acc: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """``acc``, with a zero-weight use of a rotated chunk this rank skipped:
    every rank's backward then runs every ``ppermute`` of the ring in the
    same order, as its peers' do (a chunk nothing reads would leave its
    exchange out of this rank's backward and stall the others)."""
    return acc + 0.0 * kv.sum().to(acc.dtype)


def _ring_local(q, k, v, grp, causal, zigzag):
    """Einsum ring: online softmax over every chunk (the causal mask by
    global positions)."""
    n_dev, idx = grp.size, grp.index
    b, sq, n, d = q.shape
    sk = k.shape[1]
    q_pos = _positions(idx, sq, n_dev, zigzag, q.device)
    qf = q.float() / d ** 0.5
    m = torch.full((b, n, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, n, d), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for j in range(n_dev):
        if j:
            kv = _ring(grp, kv)
        src = (idx - j) % n_dev  # the ring owner of the visiting chunk
        s = torch.einsum("bqnd,bknd->bnqk", qf, kv[0].float())
        if causal:
            k_pos = _positions(src, sk, n_dev, zigzag, q.device)
            s = s.masked_fill(~(k_pos[None, :] <= q_pos[:, None]), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        c_old = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * c_old + p.sum(dim=-1)
        acc = (acc * c_old.transpose(1, 2)[..., None]
               + torch.einsum("bnqk,bknd->bqnd", p, kv[1].float()))
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe.transpose(1, 2)[..., None]).to(q.dtype)


def _merge(qh, k_cur, v_cur, lse, acc, *, is_causal=False):
    """Fold one flash product into the (lse, acc) carry by logsumexp."""
    o_blk, lse_blk = flash_attention_lse(qh, k_cur, v_cur,
                                         is_causal=is_causal)
    lse_new = torch.logaddexp(lse, lse_blk)
    w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_blk = torch.exp(lse_blk - lse_new).transpose(1, 2)[..., None]
    return lse_new, acc * w_old + o_blk.float() * w_blk


def _carry(q):
    b, sq, n, d = q.shape
    return (torch.full((b, n, sq), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, sq, n, d), dtype=torch.float32, device=q.device))


def _ring_local_flash(q, k, v, grp, causal):
    """Flash ring: the own chunk first (causal when causal), then each
    visiting chunk, skipped when it comes from a later owner."""
    n_dev, idx = grp.size, grp.index
    lse, acc = _merge(q, k, v, *_carry(q), is_causal=causal)
    kv = torch.stack([k, v])
    for j in range(1, n_dev):
        kv = _ring(grp, kv)
        src = (idx - j) % n_dev
        if causal and src > idx:
            acc = _in_graph(acc, kv)
        else:
            lse, acc = _merge(q, kv[0], kv[1], lse, acc)
    return acc.to(q.dtype)


def _ring_zigzag_causal_flash(q, k, v, grp):
    """Causal flash ring in the zigzag layout: local halves e (global chunk
    ``idx``) and l (chunk ``2n-1-idx``). Own round: e<-e and l<-l causal,
    l<-e full; from an earlier rank: e<-e and l<-e full; from a later rank:
    l<-e and l<-l full. Every round is two half-products on every rank."""
    n_dev, idx = grp.size, grp.index
    sq = q.shape[1]
    if sq % 2:
        raise ValueError("zigzag needs an even local sequence length")
    h = sq // 2
    q_e, q_l = q[:, :h], q[:, h:]
    lse_e, acc_e = _merge(q_e, k[:, :h], v[:, :h], *_carry(q_e),
                          is_causal=True)
    lse_l, acc_l = _merge(q_l, k[:, h:], v[:, h:], *_carry(q_l),
                          is_causal=True)
    lse_l, acc_l = _merge(q_l, k[:, :h], v[:, :h], lse_l, acc_l)
    kv = torch.stack([k, v])
    for j in range(1, n_dev):
        kv = _ring(grp, kv)
        k_e, v_e = kv[0][:, :h], kv[1][:, :h]
        k_l, v_l = kv[0][:, h:], kv[1][:, h:]
        if (idx - j) % n_dev < idx:  # from an earlier rank
            lse_e, acc_e = _merge(q_e, k_e, v_e, lse_e, acc_e)
            lse_l, acc_l = _merge(q_l, k_e, v_e, lse_l, acc_l)
        else:
            lse_l, acc_l = _merge(q_l, k_e, v_e, lse_l, acc_l)
            lse_l, acc_l = _merge(q_l, k_l, v_l, lse_l, acc_l)
    return torch.cat([acc_e, acc_l], dim=1).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: DeviceMesh | None = None, axis_name: str = "seq",
                   is_causal: bool = False, impl: str = "einsum",
                   zigzag: bool = False) -> torch.Tensor:
    """Exact attention of this rank's ``(B, S/p, N, D)`` chunks of a
    sequence sharded over ``axis_name`` (``mesh=None``: the ambient mesh).
    ``impl``: ``"einsum"``, ``"flash"`` (see the module docstring) or
    ``"auto"``, flash on CUDA tensors. ``zigzag=True`` expects (and
    returns) the `zigzag_order` layout; use :func:`zigzag_shard` /
    :func:`zigzag_unshard` at the model's edge."""
    grp = comm.axis_group(axis_name, mesh)
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "einsum"
    if impl == "einsum":
        return _ring_local(q, k, v, grp, is_causal, zigzag)
    if impl != "flash":
        raise ValueError(f"unknown ring attention impl {impl!r}")
    if is_causal and zigzag:
        return _ring_zigzag_causal_flash(q, k, v, grp)
    return _ring_local_flash(q, k, v, grp, is_causal)
