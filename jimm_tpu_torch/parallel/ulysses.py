"""All-to-all (Ulysses) sequence parallelism, the second scheme; the
counterpart of ``jimm_tpu/parallel/ulysses.py``.

Where the ring keeps the queries local and rotates the k/v chunks, this
scheme redistributes once per call: an all-to-all swaps the sharded axis
from sequence to heads, every rank runs ordinary full-sequence attention
over its head subset (the single-device kernels, rows 3/4/6 and 7,
unchanged; causal masking exact), and a second all-to-all swaps back. It
needs ``num_heads % p == 0``.

Same call contract as `seqpar.ring_attention_sp`: this rank's ``(B, S/p,
N, D)`` chunks in, its chunk of the output out. The key-padding mask is
this rank's ``(B, S/p)`` chunk too; it is gathered (a few bytes a token)
so the local kernel sees the whole sequence's mask, which JAX passes
replicated.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from jimm_tpu_torch.parallel import comm


def _seq_to_heads(x: torch.Tensor, grp: comm.AxisGroup) -> torch.Tensor:
    """(B, S/p, N, D) -> (B, S, N/p, D): heads sharded, sequence gathered."""
    return comm.all_to_all(x, grp, split_dim=2, concat_dim=1)


def _heads_to_seq(x: torch.Tensor, grp: comm.AxisGroup) -> torch.Tensor:
    return comm.all_to_all(x, grp, split_dim=1, concat_dim=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mask: torch.Tensor | None = None, kind: str = "softmax",
                      mesh: DeviceMesh | None = None, axis_name: str = "seq",
                      is_causal: bool = False, impl: str = "auto",
                      logit_bias: float | None = None) -> torch.Tensor:
    """Exact attention of this rank's sequence chunks by head
    redistribution. ``impl="flash"`` runs the head subset through the flash
    kernels, ``"einsum"`` through the plain math (``"auto"``: flash on CUDA
    tensors). ``kind="sigmoid"``: ``logit_bias`` defaults to ``-log(S)``
    inside the op, where S is already the global length."""
    from jimm_tpu_torch.ops.attention import reference_attention
    from jimm_tpu_torch.ops.flash_attention import (
        canon_mask, flash_attention, flash_attention_masked, sigmoid_attention,
        sigmoid_attention_plain)
    grp = comm.axis_group(axis_name, mesh)
    if q.shape[2] % grp.size:
        raise ValueError(f"ulysses attention needs num_heads {q.shape[2]} "
                         f"divisible by the {axis_name!r} axis size "
                         f"{grp.size} (use attn_impl='ring' otherwise)")
    if kind not in ("softmax", "sigmoid"):
        raise ValueError(f"unknown ulysses variant kind {kind!r}")
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "einsum"
    if impl not in ("flash", "einsum"):
        raise ValueError(f"unknown ulysses attention impl {impl!r}")
    if mask is not None:
        # as bytes: a backend need not carry bool
        mask = comm.all_gather(canon_mask(mask, q.shape[0], k.shape[1]).to(
            torch.uint8), grp, dim=1) != 0
    qg, kg, vg = (_seq_to_heads(x, grp) for x in (q, k, v))
    if kind == "sigmoid":
        if impl == "flash":
            o = sigmoid_attention(qg, kg, vg, is_causal=is_causal, mask=mask,
                                  logit_bias=logit_bias)
        else:
            from jimm_tpu_torch.ops.flash_attention import default_logit_bias
            o = sigmoid_attention_plain(
                qg, kg, vg, is_causal=is_causal, mask=mask,
                logit_bias=(default_logit_bias(kg.shape[1])
                            if logit_bias is None else logit_bias))
    elif impl == "flash":
        o = (flash_attention(qg, kg, vg, is_causal=is_causal) if mask is None
             else flash_attention_masked(qg, kg, vg, mask,
                                         is_causal=is_causal))
    else:
        o = reference_attention(
            qg, kg, vg, is_causal=is_causal,
            mask=None if mask is None else mask[:, None, None, :])
    return _heads_to_seq(o, grp)
