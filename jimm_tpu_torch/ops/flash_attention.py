"""Softmax flash-attention forward: a hand-written CUDA kernel and its plain
version.

Kernel row 3 of the port's kernel table: it replaces the Pallas TPU kernel
``jimm_tpu/ops/flash_attention.py::_fwd_kernel`` (softmax kind, no mask or
bias). The CUDA source is ``jimm_tpu_torch/csrc/flash_attention.cu``: the
FA2 arrangement, one CTA per (batch*head, 64-row q tile) looping over 64-row
k/v tiles in shared memory, f32 online max/sum, the scale applied to the f32
score after the dot, masked scores at -1e30. At the served shapes the call
is bound by bytes on the H100 (q/k/v/o each moved once); this first version
computes with f32 FMAs, which at S=256 costs more than the bytes (see
``PERF.md``).

:func:`flash_attention_lse` launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors; any other device raises. The
module-level ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from jimm_tpu_torch import _build

NEG_INF = -1e30
#: largest head dim the kernel takes (it pads D to 64/128/256 in shared memory)
MAX_HEAD_DIM = 256

#: kernel launches since the count was last set to 0
launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, is_causal: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: ``(o, lse)`` for ``(B, S, N, D)``
    q/k/v; o in the dtype of q, lse ``(B, N, Sq)`` f32. Scores and softmax in
    f32, scale 1/sqrt(D) after the dot, causal masking top-left aligned."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    s = s * (1.0 / d ** 0.5)
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bnqk,bknd->bqnd", p, v.float())
    o = acc / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes (B, S, N, D) q/k/v")
    b, _, n, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (n, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, is_causal: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention over ``(B, S, N, D)`` q/k/v returning ``(o, lse)``:
    o ``(B, Sq, N, D)`` in the input dtype, lse ``(B, N, Sq)`` f32."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, is_causal=is_causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, not "
                         f"{q.device.type}")
    dtype = str(q.dtype).removeprefix("torch.")
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"flash attention kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    b, sq, n, d = q.shape
    sk = k.shape[1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash attention kernel needs unit stride over D")
    o = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.jimm_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, n, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            1.0 / d ** 0.5, int(is_causal), _build.DTYPE_CODES[dtype], stream)
    _build.check(rc, "jimm_flash_attention_fwd")
    launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    is_causal: bool = False) -> torch.Tensor:
    """Flash attention over ``(B, S, N, D)`` q/k/v; scale 1/sqrt(D)."""
    return flash_attention_lse(q, k, v, is_causal=is_causal)[0]
