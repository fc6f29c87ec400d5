"""Flash attention, softmax or sigmoid, forward and backward, with or
without a key-padding mask, or softmax with an additive bias: hand-written
CUDA kernels, their plain versions, and the ``torch.autograd.Function``s that
join them.

Kernel row 3 of the port's kernel table replaces the Pallas TPU kernel
``jimm_tpu/ops/flash_attention.py::_fwd_kernel`` (softmax kind, no mask or
bias). Its CUDA source is ``jimm_tpu_torch/csrc/flash_attention.cu``: the
FA2 arrangement, one CTA per (batch*head, 64-row q tile) looping over 64-row
k/v tiles in shared memory, f32 online max/sum, the scale applied to the f32
score after the dot, masked scores at -1e30. Kernel row 7 replaces
``::_bwd_dq_kernel`` and ``::_bwd_dkv_kernel``; its source is
``jimm_tpu_torch/csrc/flash_attention_bwd.cu``: the dq kernel loops over
k/v tiles, the dk/dv kernel over q tiles, no atomics; p and ds are rounded
to the input dtype before the products that consume them, as on the TPU.
At the model's shapes both are bound by bytes on the H100; these first
versions compute with f32 FMAs, which at S=256 cost more than the bytes
(see ``PERF.md``).

Kernel row 4 (``_fwd_kernel`` with ``has_mask``, reached through
``flash_attention_masked``) and row 7's mask kind are the same sources'
``HAS_MASK`` instantiations: a ``(B, Sk)`` key-padding mask, one byte a key,
folded into the predicate that already masks ragged and causal keys, where
the TPU kernels add a ``(B*N, 1, Sk)`` f32 row of 0 / -1e30 (the same
function: ``s - 1e30`` rounds to -1e30 in f32). Masked keys get exactly zero
attention and zero dk/dv. A query row whose keys are all masked gives finite
garbage that differs between the kernel and the plain version (it depends on
the tile padding), and zero gradient under a zero cotangent: callers mask
such rows downstream, as NaFlex's MAP pooling does.

:class:`FlashAttentionFn` is the autograd Function (the counterpart of the
JAX ``custom_vjp``s ``_flash`` and ``_flash_lse``): it saves q, k, v, o, lse
and the mask, and differentiates through both outputs in q, k and v; an lse
cotangent folds into ``delta``. A wrapper launches its kernel for CUDA
tensors and runs the plain version for CPU tensors; any other device raises.
The module-level ``launches`` and ``bwd_launches`` count unmasked kernel
launches, ``masked_launches`` and ``masked_bwd_launches`` masked ones (one
backward call launches the dq and the dk/dv kernel and counts once).

Kernel row 6 (``_fwd_kernel`` with ``kind="sigmoid"``, reached through
``sigmoid_attention``) and row 7's sigmoid kind are the same sources'
``SIGMOID`` instantiations, masked or not: ``o = sigmoid(s + logit_bias) v``
with no normaliser, so the forward writes no lse and the backward
(``ds = p (1 - p) dp``) needs no delta. ``logit_bias`` defaults to
``-log(Sk)`` with Sk = ``k.shape[1]``, the padded key length. A dropped key
gets exactly zero attention and zero dk/dv, and a query row with no key to
attend is exactly zero. :class:`SigmoidAttentionFn` joins them;
``sigmoid_launches`` and ``sigmoid_bwd_launches`` count their launches.

Kernel row 5 (``_fwd_kernel`` with ``has_bias``, reached through
``flash_attention_bias``) and row 7's bias kind are the sources' ``HAS_BIAS``
instantiations (softmax, no mask): an f32 ``(N, Sq, Sk)`` bias shared by the
batch, added to the scaled f32 score (multiply, then add, each rounded as XLA
rounds them). Kernel row 8 (``_bwd_dbias_kernel``) is
``jimm_tpu_torch/csrc/flash_attention_dbias.cu``: ``dbias[n] = sum_b ds[b,
n]``, the unscaled, unrounded f32 ds summed over the batch in order, one CTA
per (head, q tile, k tile), no atomics. A bias of -inf drops a key; a query
row with no finite score gives o = 0 and lse = -1e30 (as on the TPU; the
reference softmax gives NaN there) and zero gradients.
:class:`FlashAttentionBiasFn` joins them, launching the dbias kernel only when
the bias needs a gradient; ``bias_launches``, ``bias_bwd_launches`` (dq and
dk/dv, once a call) and ``dbias_launches`` count their launches.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from jimm_tpu_torch import _build
from jimm_tpu_torch.ops.library import define_op

NEG_INF = -1e30
#: largest head dim the kernels take (they pad D to 64/128/256 in shared
#: memory)
MAX_HEAD_DIM = 256

#: forward / backward kernel launches since the count was last set to 0,
#: without and with a key-padding mask
launches = 0
bwd_launches = 0
masked_launches = 0
masked_bwd_launches = 0
#: sigmoid forward / backward kernel launches, masked or not
sigmoid_launches = 0
sigmoid_bwd_launches = 0
#: biased forward, backward (dq and dk/dv) and dbias kernel launches
bias_launches = 0
bias_bwd_launches = 0
dbias_launches = 0


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions compute in f32 (f64 for f64 input, as gradcheck
    needs)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def canon_mask(mask: torch.Tensor, b: int, sk: int) -> torch.Tensor:
    """``(B, Sk)`` or ``(B, 1, 1, Sk)`` bool/int, True = attend -> ``(B, Sk)``
    bool with unit stride over Sk (a view where the input is one already);
    any other shape raises, as
    ``jimm_tpu/ops/flash_attention.py::_canon_mask`` does."""
    if mask.ndim == 4:
        if mask.shape[1] != 1 or mask.shape[2] != 1:
            raise ValueError(
                "masked flash attention supports KEY-PADDING masks only "
                f"((B, Sk) or (B, 1, 1, Sk)); got {tuple(mask.shape)} — "
                "arbitrary (B, N, Sq, Sk) masks need impl='xla'")
        mask = mask[:, 0, 0, :]
    if tuple(mask.shape) != (b, sk):
        raise ValueError(f"key-padding mask shape {tuple(mask.shape)} does "
                         f"not match (B, Sk)=({b}, {sk})")
    mask = mask if mask.dtype == torch.bool else mask != 0
    return mask if mask.stride(1) == 1 else mask.contiguous()


def _keep(sq: int, sk: int, is_causal: bool, mask: torch.Tensor | None,
          device) -> torch.Tensor | None:
    """Which scores survive, broadcastable to ``(B, N, Sq, Sk)``: the causal
    triangle (top-left aligned) and the key-padding mask; None for all."""
    keep = None
    if is_causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=device).tril()
    if mask is not None:
        rows = mask[:, None, None, :]
        keep = rows if keep is None else keep & rows
    return keep


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, is_causal: bool = False,
                          mask: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: ``(o, lse)`` for ``(B, S, N, D)``
    q/k/v; o in the dtype of q, lse ``(B, N, Sq)`` f32. Scores and softmax in
    f32, scale 1/sqrt(D) after the dot, causal masking top-left aligned;
    ``mask`` is a ``(B, Sk)`` bool key-padding mask (True = attend), and a
    dropped score is -1e30 as in the kernels."""
    acc = _acc_dtype(q.dtype)
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqnd,bknd->bnqk", q.to(acc), k.to(acc))
    s = s * (1.0 / d ** 0.5)
    keep = _keep(sq, sk, is_causal, mask, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bnqk,bknd->bqnd", p, v.to(acc))
    o = out / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _delta(o: torch.Tensor, do: torch.Tensor,
           dlse: torch.Tensor | None) -> torch.Tensor:
    """``rowsum(do * o)`` as ``(B, N, Sq)``, minus the lse cotangent (which
    folds into delta exactly, ``_flash_bwd``)."""
    acc = _acc_dtype(o.dtype)
    delta = (do.to(acc) * o.to(acc)).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.to(acc)
    return delta.contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              dlse: torch.Tensor | None = None, *,
                              is_causal: bool = False,
                              mask: torch.Tensor | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward in plain PyTorch: ``(dq, dk, dv)`` in the dtype of q,
    recomputing ``p = exp(s - lse)`` in f32 (a dropped score is -1e30, so its
    p is 0) and rounding p (for dv) and ds (for dq and dk) to the input dtype
    before the products, where the kernels and the TPU kernels round them."""
    acc = _acc_dtype(q.dtype)
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / d ** 0.5
    qf, kf, vf, dof = (t.to(acc) for t in (q, k, v, do))
    s = torch.einsum("bqnd,bknd->bnqk", qf, kf) * scale
    keep = _keep(sq, sk, is_causal, mask, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse.to(acc)[..., None])
    dv = torch.einsum("bnqk,bqnd->bknd", p.to(q.dtype).to(acc), dof)
    dp = torch.einsum("bqnd,bknd->bnqk", dof, vf)
    ds = (p * (dp - _delta(o, do, dlse)[..., None])).to(q.dtype).to(acc)
    dq = torch.einsum("bnqk,bknd->bqnd", ds, kf) * scale
    dk = torch.einsum("bnqk,bqnd->bknd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


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


def _kernel_dtype(*ts: torch.Tensor) -> int:
    """The C interface's dtype code for CUDA tensors with unit stride over D
    and D <= 256; anything else raises."""
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, not "
                         f"{q.device.type}")
    dtype = str(q.dtype).removeprefix("torch.")
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"flash attention kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} > {MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash attention kernel needs unit stride over D")
    return _build.DTYPE_CODES[dtype]


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def _mask_arg(mask: torch.Tensor | None, q: torch.Tensor
              ) -> tuple[int | None, int]:
    """The C interface's mask pointer (None = no mask) and batch stride: the
    ``(B, Sk)`` bool mask on q's device, one byte a key, unit stride over
    Sk."""
    if mask is None:
        return None, 0
    if mask.dtype != torch.bool or mask.device != q.device:
        raise ValueError(f"the kernel's mask is a bool tensor on {q.device}, "
                         f"not {mask.dtype} on {mask.device}")
    if mask.stride(1) != 1:
        raise ValueError("the kernel's mask needs unit stride over Sk")
    return mask.data_ptr(), mask.stride(0)


def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, is_causal: bool,
         mask: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors, the plain version on CPU ones."""
    global launches, masked_launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, is_causal=is_causal, mask=mask)
    code = _kernel_dtype(q, k, v)
    mask_ptr, mask_sb = _mask_arg(mask, q)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    o = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.jimm_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, n, sq, sk, d, *_strides(q), *_strides(k),
            *_strides(v), 1.0 / d ** 0.5, int(is_causal), mask_ptr, mask_sb,
            code, stream)
    _build.check(rc, "jimm_flash_attention_fwd")
    if mask is None:
        launches += 1
    else:
        masked_launches += 1
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        dlse: torch.Tensor | None = None, *,
                        is_causal: bool = False,
                        mask: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's residuals and the cotangents of o
    (and, optionally, of lse): the two backward kernels on CUDA tensors,
    :func:`flash_attention_bwd_plain` on CPU tensors. ``mask`` is the
    forward's ``(B, Sk)`` bool key-padding mask, or None."""
    global bwd_launches, masked_bwd_launches
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, dlse,
                                         is_causal=is_causal, mask=mask)
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} does not match q "
                         f"{q.dtype} {tuple(q.shape)}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    code = _kernel_dtype(q, k, v, do)
    mask_ptr, mask_sb = _mask_arg(mask, q)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    delta = _delta(o, do, dlse)
    lse = lse.contiguous()
    dq = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, n, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, n, d), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.jimm_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, n, sq, sk, d, *_strides(q), *_strides(k),
            *_strides(v), *_strides(do), 1.0 / d ** 0.5, int(is_causal),
            mask_ptr, mask_sb, code, stream)
    _build.check(rc, "jimm_flash_attention_bwd")
    if mask is None:
        bwd_launches += 1
    else:
        masked_bwd_launches += 1
    return dq, dk, dv


#: the forwards as ops a remat policy can save, their o and lse being the
#: JAX kernels' ``flash_o`` / ``flash_lse`` (`ops/library.py`); each looks
#: its wrapper up when called
fwd_op = define_op(
    "flash_fwd(Tensor q, Tensor k, Tensor v, Tensor? mask, bool is_causal) "
    "-> (Tensor, Tensor)",
    lambda q, k, v, mask, is_causal: _fwd(q, k, v, is_causal, mask))
sigmoid_fwd_op = define_op(
    "sigmoid_fwd(Tensor q, Tensor k, Tensor v, Tensor? mask, bool is_causal, "
    "float logit_bias) -> Tensor",
    lambda q, k, v, mask, is_causal, logit_bias: sigmoid_attention_fwd(
        q, k, v, is_causal=is_causal, mask=mask, logit_bias=logit_bias))


class FlashAttentionFn(torch.autograd.Function):
    """``(o, lse)`` of softmax flash attention, differentiable in q, k and v
    through both outputs; the ``(B, Sk)`` bool key-padding mask (or None)
    rides through to the backward and gets no gradient. The forward goes
    through :data:`fwd_op`."""

    @staticmethod
    def forward(ctx, q, k, v, mask, is_causal):
        o, lse = fwd_op(q, k, v, mask, is_causal)
        ctx.save_for_backward(q, k, v, o, lse, mask)
        ctx.is_causal = is_causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, o, lse, mask = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, dlse,
                                         is_causal=ctx.is_causal, mask=mask)
        return dq, dk, dv, None, None


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, is_causal: bool = False,
                        mask: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention over ``(B, S, N, D)`` q/k/v returning ``(o, lse)``:
    o ``(B, Sq, N, D)`` in the input dtype, lse ``(B, N, Sq)`` f32.
    Differentiable through both. ``mask``: an optional key-padding mask,
    ``(B, Sk)`` or ``(B, 1, 1, Sk)`` bool/int, True = attend."""
    _check(q, k, v)
    if mask is not None:
        mask = canon_mask(mask, q.shape[0], k.shape[1])
    return FlashAttentionFn.apply(q, k, v, mask, is_causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    is_causal: bool = False) -> torch.Tensor:
    """Flash attention over ``(B, S, N, D)`` q/k/v; scale 1/sqrt(D)."""
    return flash_attention_lse(q, k, v, is_causal=is_causal)[0]


def flash_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, *, is_causal: bool = False
                           ) -> torch.Tensor:
    """Flash attention with a per-sample key-padding mask (the NaFlex /
    MAP-pooling case), the counterpart of
    ``jimm_tpu/ops/flash_attention.py::flash_attention_masked``: ``mask`` is
    ``(B, Sk)`` or ``(B, 1, 1, Sk)`` bool/int, True = attend. Masked keys get
    exactly zero attention and zero gradient; a row with no valid key gives
    finite garbage (see the module docstring)."""
    return flash_attention_lse(q, k, v, is_causal=is_causal, mask=mask)[0]


def default_logit_bias(sk: int) -> float:
    """Sigmoid attention's default scalar bias, ``-log(max(Sk, 1))`` (the
    sigmoid-attention paper's initialisation, which matches softmax's 1/Sk
    row mass at init)."""
    return -math.log(max(sk, 1))


def _sigmoid_p(q: torch.Tensor, k: torch.Tensor, is_causal: bool,
               mask: torch.Tensor | None, logit_bias: float) -> torch.Tensor:
    """``sigmoid((q . k) * scale + logit_bias)`` as ``(B, N, Sq, Sk)`` in
    f32 (f64 for f64 input), exactly 0 at a dropped key."""
    acc = _acc_dtype(q.dtype)
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqnd,bknd->bnqk", q.to(acc), k.to(acc))
    p = torch.sigmoid(s * (1.0 / d ** 0.5) + logit_bias)
    keep = _keep(sq, sk, is_causal, mask, q.device)
    return p if keep is None else p.masked_fill(~keep, 0.0)


def sigmoid_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, is_causal: bool = False,
                            mask: torch.Tensor | None = None,
                            logit_bias: float) -> torch.Tensor:
    """The sigmoid kind in plain PyTorch: o in the dtype of q, p rounded to
    v's dtype before ``p . v``, as in the kernels and the TPU kernel; ``mask``
    is a ``(B, Sk)`` bool key-padding mask (True = attend)."""
    acc = _acc_dtype(q.dtype)
    p = _sigmoid_p(q, k, is_causal, mask, logit_bias)
    out = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype).to(acc), v.to(acc))
    return out.to(q.dtype)


def sigmoid_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor, *,
                                is_causal: bool = False,
                                mask: torch.Tensor | None = None,
                                logit_bias: float
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The sigmoid kind's backward in plain PyTorch: p recomputed in f32,
    ``ds = p (1 - p) dp``; p (for dv) and ds rounded to the input dtype
    before their products."""
    acc = _acc_dtype(q.dtype)
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, dof = (t.to(acc) for t in (q, k, v, do))
    p = _sigmoid_p(q, k, is_causal, mask, logit_bias)
    dp = torch.einsum("bqnd,bknd->bnqk", dof, vf)
    ds = (p * (1.0 - p) * dp).to(q.dtype).to(acc)
    dv = torch.einsum("bnqk,bqnd->bknd", p.to(q.dtype).to(acc), dof)
    dq = torch.einsum("bnqk,bknd->bqnd", ds, kf) * scale
    dk = torch.einsum("bnqk,bqnd->bknd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def sigmoid_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, is_causal: bool = False,
                          mask: torch.Tensor | None = None,
                          logit_bias: float) -> torch.Tensor:
    """The sigmoid forward kernel on CUDA tensors, its plain version on CPU
    ones. ``mask``: the ``(B, Sk)`` bool key-padding mask, or None."""
    global sigmoid_launches
    if q.device.type == "cpu":
        return sigmoid_attention_plain(q, k, v, is_causal=is_causal,
                                       mask=mask, logit_bias=logit_bias)
    code = _kernel_dtype(q, k, v)
    mask_ptr, mask_sb = _mask_arg(mask, q)
    b, sq, n, d = q.shape
    o = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.jimm_sigmoid_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, sq,
            k.shape[1], d, *_strides(q), *_strides(k), *_strides(v),
            1.0 / d ** 0.5, logit_bias, int(is_causal), mask_ptr, mask_sb,
            code, stream)
    _build.check(rc, "jimm_sigmoid_attention_fwd")
    sigmoid_launches += 1
    return o


def sigmoid_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, *, is_causal: bool = False,
                          mask: torch.Tensor | None = None,
                          logit_bias: float
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's inputs and the cotangent of o: the
    two backward kernels' sigmoid kind on CUDA tensors (no delta),
    :func:`sigmoid_attention_bwd_plain` on CPU tensors."""
    global sigmoid_bwd_launches
    if q.device.type == "cpu":
        return sigmoid_attention_bwd_plain(q, k, v, do, is_causal=is_causal,
                                           mask=mask, logit_bias=logit_bias)
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} does not match q "
                         f"{q.dtype} {tuple(q.shape)}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    code = _kernel_dtype(q, k, v, do)
    mask_ptr, mask_sb = _mask_arg(mask, q)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    dq = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, n, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, n, d), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.jimm_sigmoid_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, sq, sk, d,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do),
            1.0 / d ** 0.5, logit_bias, int(is_causal), mask_ptr, mask_sb,
            code, stream)
    _build.check(rc, "jimm_sigmoid_attention_bwd")
    sigmoid_bwd_launches += 1
    return dq, dk, dv


class SigmoidAttentionFn(torch.autograd.Function):
    """Sigmoid attention's o, differentiable in q, k and v; the counterpart
    of the JAX ``custom_vjp`` ``_flash`` with the sigmoid kind. It saves the
    inputs only (no lse); the ``(B, Sk)`` bool key-padding mask (or None)
    rides through to the backward and gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, is_causal, logit_bias):
        o = sigmoid_fwd_op(q, k, v, mask, is_causal, logit_bias)
        ctx.save_for_backward(q, k, v, mask)
        ctx.is_causal = is_causal
        ctx.logit_bias = logit_bias
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = sigmoid_attention_bwd(q, k, v, do,
                                           is_causal=ctx.is_causal, mask=mask,
                                           logit_bias=ctx.logit_bias)
        return dq, dk, dv, None, None, None


def sigmoid_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      is_causal: bool = False,
                      mask: torch.Tensor | None = None,
                      logit_bias: float | None = None) -> torch.Tensor:
    """Sigmoid attention over ``(B, S, N, D)`` q/k/v, the counterpart of
    ``jimm_tpu/ops/flash_attention.py::sigmoid_attention``: ``o =
    sigmoid(q k^T / sqrt(D) + logit_bias) v`` with no row normaliser.
    ``logit_bias`` defaults to ``-log(Sk)``, Sk = ``k.shape[1]`` (padded
    keys included). ``mask``: an optional key-padding mask, ``(B, Sk)`` or
    ``(B, 1, 1, Sk)`` bool/int, True = attend; masked keys, and rows with no
    key, are exactly zero."""
    _check(q, k, v)
    if logit_bias is None:
        logit_bias = default_logit_bias(k.shape[1])
    if mask is not None:
        mask = canon_mask(mask, q.shape[0], k.shape[1])
    return SigmoidAttentionFn.apply(q, k, v, mask, is_causal,
                                    float(logit_bias))


def _bias_scores(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor,
                 is_causal: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(q . k) * scale + bias`` as ``(B, N, Sq, Sk)`` in f32 (f64 for f64
    input), the multiply and the add rounded on their own as the kernels
    round them, and which scores the causal triangle keeps (None: all)."""
    acc = _acc_dtype(q.dtype)
    s = torch.einsum("bqnd,bknd->bnqk", q.to(acc), k.to(acc))
    s = s * (1.0 / q.shape[-1] ** 0.5) + bias.to(acc)
    return s, _keep(q.shape[1], k.shape[1], is_causal, None, q.device)


def flash_attention_bias_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor, *,
                               is_causal: bool = False
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bias kind in plain PyTorch: ``(o, lse)`` for ``(B, S, N, D)`` q/k/v
    and an f32 bias broadcastable to ``(N, Sq, Sk)``; o in the dtype of q,
    lse ``(B, N, Sq)`` f32. As in the kernel, a dropped key (causal, or a
    bias of -inf) has p = 0 and the row max starts at -1e30, so a row with
    no finite score gives o = 0 and lse = -1e30."""
    acc = _acc_dtype(q.dtype)
    s, keep = _bias_scores(q, k, bias, is_causal)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bnqk,bknd->bqnd", p, v.to(acc))
    o = out / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _bias_ds(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
             do: torch.Tensor, is_causal: bool,
             delta: torch.Tensor | None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bias kind's p = exp(s - lse), recomputed with the bias (0 at a
    dropped key), and ds = p (dp - delta), both ``(B, N, Sq, Sk)`` in f32
    (f64 for f64 input), unrounded; delta is rowsum(do * o) unless given."""
    acc = _acc_dtype(q.dtype)
    s, keep = _bias_scores(q, k, bias, is_causal)
    p = torch.exp(s - lse.to(acc)[..., None])
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dp = torch.einsum("bqnd,bknd->bnqk", do.to(acc), v.to(acc))
    if delta is None:
        delta = _delta(o, do, None)
    return p, p * (dp - delta.to(dp.dtype)[..., None])


def flash_attention_bias_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, bias: torch.Tensor,
                                   o: torch.Tensor, lse: torch.Tensor,
                                   do: torch.Tensor, *,
                                   is_causal: bool = False,
                                   delta: torch.Tensor | None = None
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Row 7's bias kind in plain PyTorch: ``(dq, dk, dv)`` in the dtype of
    q, p (for dv) and ds (for dq and dk) rounded to the input dtype before
    their products, as in the kernels. ``delta``: rowsum(do * o), ``(B, N,
    Sq)`` f32, where the caller has it."""
    acc = _acc_dtype(q.dtype)
    scale = 1.0 / q.shape[-1] ** 0.5
    p, ds = _bias_ds(q, k, v, bias, o, lse, do, is_causal, delta)
    dv = torch.einsum("bnqk,bqnd->bknd", p.to(q.dtype).to(acc), do.to(acc))
    ds = ds.to(q.dtype).to(acc)
    dq = torch.einsum("bnqk,bknd->bqnd", ds, k.to(acc)) * scale
    dk = torch.einsum("bnqk,bqnd->bknd", ds, q.to(acc)) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_dbias_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, bias: torch.Tensor,
                                o: torch.Tensor, lse: torch.Tensor,
                                do: torch.Tensor, *, is_causal: bool = False,
                                delta: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Row 8 in plain PyTorch: the unscaled, unrounded ds summed over the
    batch, ``(N, Sq, Sk)`` f32."""
    ds = _bias_ds(q, k, v, bias, o, lse, do, is_causal, delta)[1]
    return ds.sum(0).float()


def _bias_arg(bias: torch.Tensor, q: torch.Tensor, sk: int
              ) -> tuple[torch.Tensor, int, int]:
    """The kernels' bias: an f32 ``(N, Sq, Sk)`` tensor on q's device with
    unit stride over Sk (a broadcast view keeps its 0 strides; a bias
    broadcast over Sk is copied), and its head and row strides."""
    n, sq = q.shape[2], q.shape[1]
    if (bias.dtype != torch.float32 or bias.device != q.device
            or tuple(bias.shape) != (n, sq, sk)):
        raise ValueError(f"the kernels' bias is float32 ({n}, {sq}, {sk}) on "
                         f"{q.device}, not {bias.dtype} {tuple(bias.shape)} "
                         f"on {bias.device}")
    if bias.stride(2) != 1:
        bias = bias.contiguous()
    return bias, bias.stride(0), bias.stride(1)


def flash_attention_bias_fwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor, *,
                             is_causal: bool = False
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of the bias kind: the row-5 kernel on CUDA tensors, its
    plain version on CPU ones. ``bias``: f32 ``(N, Sq, Sk)``."""
    global bias_launches
    if q.device.type == "cpu":
        return flash_attention_bias_plain(q, k, v, bias, is_causal=is_causal)
    code = _kernel_dtype(q, k, v)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    bias, b_sn, b_ss = _bias_arg(bias, q, sk)
    o = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.jimm_flash_attention_bias_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, n, sq, sk, d, *_strides(q),
            *_strides(k), *_strides(v), b_sn, b_ss, 1.0 / d ** 0.5,
            int(is_causal), code, stream)
    _build.check(rc, "jimm_flash_attention_bias_fwd")
    bias_launches += 1
    return o, lse


def _bias_bwd_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                   do: torch.Tensor, is_causal: bool,
                   delta: torch.Tensor | None
                   ) -> tuple[list[torch.Tensor], tuple]:
    """What the two backward kernels share: the tensors q, k, v, do, lse,
    delta and the bias as the kernels take them (do, lse and the bias
    possibly copies, which the caller holds until the launch), and the
    shapes, strides, scale, causal flag and dtype code."""
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} does not match q "
                         f"{q.dtype} {tuple(q.shape)}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    code = _kernel_dtype(q, k, v, do)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    bias, b_sn, b_ss = _bias_arg(bias, q, sk)
    delta = _delta(o, do, None) if delta is None else delta.contiguous()
    lse = lse.contiguous()
    return [q, k, v, do, lse, delta, bias], (
        b, n, sq, sk, d, *_strides(q), *_strides(k), *_strides(v),
        *_strides(do), b_sn, b_ss, 1.0 / d ** 0.5, int(is_causal), code)


def flash_attention_bias_bwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor,
                             do: torch.Tensor, *, is_causal: bool = False,
                             delta: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's residuals and the cotangent of o:
    row 7's bias kind (dq, then dk/dv) on CUDA tensors,
    :func:`flash_attention_bias_bwd_plain` on CPU tensors. ``delta``:
    rowsum(do * o), ``(B, N, Sq)`` f32, where the caller has it (it is
    computed otherwise)."""
    global bias_bwd_launches
    if q.device.type == "cpu":
        return flash_attention_bias_bwd_plain(q, k, v, bias, o, lse, do,
                                              is_causal=is_causal,
                                              delta=delta)
    inputs, args = _bias_bwd_args(q, k, v, bias, o, lse, do, is_causal,
                                  delta)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    dq = torch.empty((b, sq, n, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, n, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, n, d), dtype=q.dtype, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.jimm_flash_attention_bias_bwd(
            *(t.data_ptr() for t in inputs), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *args, stream)
    _build.check(rc, "jimm_flash_attention_bias_bwd")
    bias_bwd_launches += 1
    return dq, dk, dv


def dbias_batch_range(b: int, n: int, sq: int, sk: int, d: int,
                      sms: int) -> int:
    """How many samples each CTA of the row-8 kernel sums. Its CTAs are the
    (head, q tile, k tile) tiles (64 rows, 32 above D = 128) times the batch
    ranges, and an SM holds two of them at D <= 64 or one above, in either
    body: the mma.sync body (bf16 up to D = 128) by its shared memory, 83 KB
    a CTA at D <= 64 and 147 KB above; the FMA body (f32, and bf16 at D =
    256) by its cap of 128 registers a thread at D <= 64 and its shared
    memory above. Of 1 to about four waves' worth of ranges, the count that
    fills its last wave best (the fewest on a tie); at the train shape (12 x
    4 x 4 = 192 tiles on 132 SMs) 4 ranges of 32, three waves 97% full,
    where the whole batch gives 1.45."""
    rows = 64 if d <= 128 else 32
    tiles = n * -(-sq // rows) * -(-sk // rows)
    slots = (2 if d <= 64 else 1) * sms

    def fill(ranges: int) -> float:
        return tiles * ranges / (-(-tiles * ranges // slots) * slots)

    ranges = max(range(1, min(b, -(-4 * slots // tiles)) + 1),
                 key=lambda r: (fill(r), -r))
    return -(-b // ranges)


def flash_attention_dbias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, o: torch.Tensor,
                          lse: torch.Tensor, do: torch.Tensor, *,
                          is_causal: bool = False,
                          delta: torch.Tensor | None = None) -> torch.Tensor:
    """The bias's gradient, ``(N, Sq, Sk)`` f32: the row-8 kernel on CUDA
    tensors (the batch summed in :func:`dbias_batch_range` ranges, the
    ranges added in order by a second kernel),
    :func:`flash_attention_dbias_plain` on CPU tensors. ``delta`` as in
    :func:`flash_attention_bias_bwd`."""
    global dbias_launches
    if q.device.type == "cpu":
        return flash_attention_dbias_plain(q, k, v, bias, o, lse, do,
                                           is_causal=is_causal, delta=delta)
    inputs, args = _bias_bwd_args(q, k, v, bias, o, lse, do, is_causal,
                                  delta)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    b_range = dbias_batch_range(b, n, sq, sk, d, sms)
    ranges = -(-b // b_range)
    dbias = torch.empty((n, sq, sk), dtype=torch.float32, device=q.device)
    workspace = (None if ranges == 1 else torch.empty(
        (ranges, n, sq, sk), dtype=torch.float32, device=q.device))
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.jimm_flash_attention_dbias(
            *(t.data_ptr() for t in inputs), dbias.data_ptr(),
            None if workspace is None else workspace.data_ptr(), *args[:5],
            b_range, *args[5:], stream)
    _build.check(rc, "jimm_flash_attention_dbias")
    dbias_launches += 1
    return dbias


class FlashAttentionBiasFn(torch.autograd.Function):
    """o of softmax flash attention with an additive f32 ``(N, Sq, Sk)``
    bias, differentiable in q, k, v and the bias (the counterpart of the
    JAX ``custom_vjp`` ``_flash`` with ``has_bias``). It saves q, k, v, the
    bias, o and lse; its backward launches the dbias kernel only when the
    bias needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, is_causal):
        o, lse = flash_attention_bias_fwd(q, k, v, bias, is_causal=is_causal)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.is_causal = is_causal
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        delta = _delta(o, do, None)  # one pass for both backward kernels
        dq, dk, dv = flash_attention_bias_bwd(q, k, v, bias, o, lse, do,
                                              is_causal=ctx.is_causal,
                                              delta=delta)
        dbias = (flash_attention_dbias(q, k, v, bias, o, lse, do,
                                       is_causal=ctx.is_causal, delta=delta)
                 if ctx.needs_input_grad[3] else None)
        return dq, dk, dv, dbias, None


def flash_attention_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, *, is_causal: bool = False
                         ) -> torch.Tensor:
    """Flash attention with an additive logits bias broadcastable to
    ``(N, Sq, Sk)`` (relative-position style; shared by the batch), the
    counterpart of ``jimm_tpu/ops/flash_attention.py::flash_attention_bias``.
    Differentiable in the bias: the bias is broadcast to ``(N, Sq, Sk)`` f32
    as ``_canon_bias`` does, so its gradient (the row-8 kernel's batch sum)
    flows back to the caller's shape and dtype, summed over heads for a
    ``(Sq, Sk)`` bias."""
    _check(q, k, v)
    if bias.device != q.device:
        raise ValueError(f"bias on {bias.device}, q on {q.device}")
    n, sq, sk = q.shape[2], q.shape[1], k.shape[1]
    bias3 = bias.float().expand(n, sq, sk)
    return FlashAttentionBiasFn.apply(q, k, v, bias3, is_causal)


# ---------------------------------------------------------------------------
# External-residual hop entry points: the sequence-parallel ring
# (`jimm_tpu_torch/parallel/seqpar.py`) drives the same kernels per KV hop
# ---------------------------------------------------------------------------

def ring_hop_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor | None, kind: str = "softmax", *,
                 logit_bias: float = 0.0
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One ring hop's forward, the counterpart of
    ``jimm_tpu/ops/flash_attention.py::ring_hop_fwd``: ``(o, lse)`` of the
    local q against the visiting k/v chunk, ``(B, S, N, D)`` q/k/v and a
    ``(B, Sk)`` bool key-padding mask or None; lse is None for the sigmoid
    kind, which keeps no normaliser. Rows 3 and 4 (softmax, unmasked or
    masked) or row 6 (sigmoid) on CUDA tensors, their plain versions on CPU
    tensors. A plain function, not an autograd Function: the caller owns the
    cross-hop merge and its differentiation."""
    if kind == "softmax":
        return _fwd(q, k, v, False, mask)
    if kind == "sigmoid":
        return sigmoid_attention_fwd(q, k, v, mask=mask,
                                     logit_bias=logit_bias), None
    raise ValueError(f"unknown ring hop kind {kind!r}")


def ring_hop_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor | None, o: torch.Tensor,
                 lse: torch.Tensor | None, do: torch.Tensor,
                 kind: str = "softmax", *, logit_bias: float = 0.0
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring hop's backward against the global residuals, the
    counterpart of ``jimm_tpu/ops/flash_attention.py::ring_hop_bwd``: ``o``
    and ``lse`` are the fully merged output and logsumexp, so the kernels'
    ``p = exp(s - lse)`` and ``delta = rowsum(do * o)`` (recomputed by each
    hop) are the global row statistics, and the hop's ``(dq, dk, dv)`` are
    exact partial gradients: their sum over the hops is the unsharded
    backward. Row 7 on CUDA tensors (sigmoid: its sigmoid kind, which reads
    neither o nor lse), the plain versions on CPU tensors."""
    if kind == "softmax":
        return flash_attention_bwd(q, k, v, o, lse, do, mask=mask)
    if kind == "sigmoid":
        return sigmoid_attention_bwd(q, k, v, do, mask=mask,
                                     logit_bias=logit_bias)
    raise ValueError(f"unknown ring hop kind {kind!r}")
