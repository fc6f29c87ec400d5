"""fp8 x fp8 -> f32 matmul with a fused dequantizing epilogue, its plain
version, the per-tensor scaling helpers, and the differentiable
``fp8_matmul`` (e4m3 forward, e5m2 gradients); the counterpart of
``jimm_tpu/ops/fp8_matmul.py``.

Kernel row 12 of the port's kernel table replaces the Pallas TPU kernel
``jimm_tpu/ops/fp8_matmul.py::_matmul_kernel``; its CUDA source is
``jimm_tpu_torch/csrc/fp8_matmul.cu``: ``out = (a . b^T) * scale + bias``
over K-contiguous fp8 operands, fed by TMA and widened exactly to f16 in
shared memory for f16 ``wgmma`` with an f32 accumulator (fp8 ``wgmma``
keeps ~14 bits in its sums: PERF.md), the epilogue's multiply and add
rounded one at a time, as XLA rounds the TPU kernel's. The kernel takes K
a multiple of 16 and 16-byte aligned operands (a TMA row stride must be);
:func:`tma_operands` zero-pads K otherwise, as JAX's ``_pad2`` pads K to
128 (zero products add nothing). An output with
too few 128 x 128 tiles to fill the card (the weight gradients) is summed
over K in ranges, each range's f32 sums in a workspace this wrapper
allocates, then added in order (:func:`k_range`). The kernel differs from
its plain version by the order of its f32 sums and the tensor core's
truncation of them: :func:`gemm_error_bound` is the bound it is held to.

Scaling is per tensor and explicit, as in the JAX package: the scales are
f32 rank-0 tensors the caller passes (delayed scales from amax histories in
``jimm_tpu_torch.quant.policy.Fp8Linear``); the backward takes a dynamic
scale for the incoming gradient. Every scale stays on the device and reaches
the kernel by pointer, so no step waits on the host for one. The
quantizers keep the JAX op order bit for bit: ``x.float() / scale`` (a
divide, not a multiply by a reciprocal), clamp to the format's max, cast.

The port keeps ``nn.Linear``'s ``(N, K)`` weight, so the forward is
``x_q (M, K) . w_q (N, K)^T``; the backward's ``dx = dy_q . w_q`` and
``dw = dy_q^T . x_q`` (the transpose of JAX's ``x_q^T @ dy_q``, the same
products) take K-contiguous fp8 copies of the transposed operands, written
by plain torch as JAX's ``.T`` is.

:func:`fp8_gemm` launches the kernel for CUDA tensors and runs
:func:`fp8_gemm_plain` for CPU tensors; any other device raises. The
module-level ``launches`` counts the forward's kernel launches and
``bwd_launches`` the backward's (two a call: dx and dw);
``amax_reductions`` counts the backward's gradient-amax all-reduces on a
mesh.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from jimm_tpu_torch import _build

#: saturation bounds of the two formats (torch.finfo(...).max)
E4M3_MAX = 448.0
E5M2_MAX = 57344.0
E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
_FMAX = {E4M3: E4M3_MAX, E5M2: E5M2_MAX}
#: the C interface's format codes (csrc/fp8_matmul.cu ``Format``)
_FORMATS = {E4M3: 0, E5M2: 1}
#: the operand formats the kernel is built for: (a, b)
_KERNEL_FORMATS = {(E4M3, E4M3), (E5M2, E4M3)}

#: the kernel's output tile, the step of its K ranges (whole 64-wide
#: stages), and the least K range a CTA sums (a shorter one spends its time
#: filling the pipeline)
_TILE = 128
_RANGE_STEP = 128
_MIN_K_RANGE = 512
#: a TMA row stride and base address are multiples of 16 bytes
_TMA_ALIGN = 16
#: the K of one f16 wgmma (the kernel widens fp8 to f16 in shared memory)
#: and the fraction bits of its f32 accumulator, below whose leading bit
#: the instruction's addends are aligned and truncated
_WGMMA_K = 16
_ACC_FRACTION_BITS = 23
#: lambda of the gate's sqrt(K) growth of rounding errors
_GROWTH = 2.0

#: kernel launches since the count was last set to 0: the forward's GEMMs,
#: and the backward's (dx and dw)
launches = 0
bwd_launches = 0
#: the backward's gradient-amax all-reduces on a mesh since last set to 0
amax_reductions = 0


def quantize_tensor(x: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Per-tensor symmetric fp8 quantization at an explicit f32 scale,
    saturating at the format max (no inf from a stale delayed scale); the
    result is dense, as the GEMM's operands must be, whatever ``x``'s
    strides (a gathered output's gradient is a column slice)."""
    fmax = _FMAX[dtype]
    xf = x.float() / scale
    return xf.clamp(-fmax, fmax).to(dtype).contiguous()


def tensor_amax(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor amax observation feeding delayed scaling (f32, 0-d)."""
    return x.float().abs().amax()


def _scale_from(amax: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``amax / format_max``, or 1.0 where amax is 0 (dequantization stays
    finite); a device tensor, no host sync."""
    return torch.where(amax > 0, amax / _FMAX[dtype], torch.ones_like(amax))


def dynamic_scale(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-tensor scale from this tensor's own amax."""
    return _scale_from(tensor_amax(x), dtype)


def delayed_scale(amax_history: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Per-tensor scale from a rolling amax history (the max over the
    window, one matmul pass behind the live tensor)."""
    return _scale_from(amax_history.amax(), dtype)


def update_amax_history(amax_history: torch.Tensor,
                        amax: torch.Tensor) -> torch.Tensor:
    """The window rolled: the oldest observation dropped, the newest
    appended."""
    return torch.cat([amax_history[1:], amax.reshape(1).float()])


def fp8_gemm_plain(a_q: torch.Tensor, b_q: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """The same function in plain PyTorch: the fp8 values widened to f32
    (exactly), an f32 matmul, then ``* scale`` and ``+ bias`` as separate
    ops."""
    acc = a_q.float() @ b_q.float().T
    y = acc * scale.float()
    return y if bias is None else y + bias.float()


def k_range(m: int, n: int, k: int, sms: int) -> int:
    """The length of the K ranges the kernel sums, a multiple of 128 (two of
    its 64-wide stages). An output of at least four 128 x 128 tiles an SM
    (two waves of the two CTAs an SM holds) takes all of K in one range; a
    smaller one is split into enough ranges for four CTAs an SM, each at
    least 512 of K long."""
    tiles = -(-m // _TILE) * -(-n // _TILE)
    steps = -(-k // _RANGE_STEP)
    ranges = 1
    if tiles < 4 * sms:
        ranges = max(1, min(-(-4 * sms // tiles), k // _MIN_K_RANGE))
    return -(-steps // ranges) * _RANGE_STEP


def default_k_ranges(m: int, n: int, k: int, sms: int) -> dict[str, int]:
    """The K-range lengths :func:`fp8_gemm` picks by :func:`k_range` for the
    three GEMMs of one ``x (M, K) . w (N, K)^T`` call: the forward sums K,
    dx (``dy_q . w_q``, ``(M, N) x (N, K)``) sums N, dw (``dy_q^T . x_q``,
    ``(N, M) x (M, K)``) sums M, each padded to 16 as
    :func:`tma_operands` pads it."""
    def pad(x: int) -> int:
        return -(-x // _TMA_ALIGN) * _TMA_ALIGN

    return {"k_range_fwd": k_range(m, n, pad(k), sms),
            "k_range_dx": k_range(m, k, pad(n), sms),
            "k_range_dw": k_range(n, k, pad(m), sms)}


def tuned_k_ranges(x: torch.Tensor, w: torch.Tensor,
                   sms: int) -> dict[str, int]:
    """The three GEMMs' K-range lengths for ``x (M, K)`` and ``w (N, K)``:
    the tune cache's ``fp8_matmul`` record at their shapes and dtypes, else
    :func:`default_k_ranges` on ``sms`` SMs (today's heuristic). The lookup
    is memoized a shape a process
    (`jimm_tpu_torch/tune/api.py::best_config`)."""
    from jimm_tpu_torch.tune.api import best_config
    (m, k), n = x.shape, w.shape[0]
    return best_config("fp8_matmul", (x.shape, w.shape), (x.dtype, w.dtype),
                       device=x.device,
                       default=lambda: default_k_ranges(m, n, k, sms))


def tma_operands(a_q: torch.Tensor, b_q: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The operands as the kernel takes them: unchanged when K is a multiple
    of 16 and both start on a 16-byte boundary, else both copied with K
    zero-padded to the next multiple of 16 (a zero product adds nothing, so
    the GEMM is the same)."""
    k = a_q.shape[1]
    if k % _TMA_ALIGN == 0 and all(t.data_ptr() % _TMA_ALIGN == 0
                                   for t in (a_q, b_q)):
        return a_q, b_q
    k_pad = -(-k // _TMA_ALIGN) * _TMA_ALIGN

    def padded(t: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((t.shape[0], k_pad), dtype=torch.uint8,
                          device=t.device)
        out[:, :k] = t.view(torch.uint8)
        return out.view(t.dtype)

    return padded(a_q), padded(b_q)


def accumulation_tolerance(k: int) -> float:
    """``c`` of :func:`gemm_error_bound` for a sum over ``k``.

    The kernel widens fp8 to f16 exactly, so every product is exact, and
    each f16 wgmma adds 16 of them to the f32 accumulator: the 17 addends
    aligned to the largest and each truncated to 23 bits below its leading
    bit, an error under ``17 * 2**-23`` of the largest addend, itself at
    most the sum of absolute products. That is the first term, the worst
    case of one instruction. Over many instructions the worst case grows
    as ``k`` (``3.1 k`` steps of ``2**-24`` in all), which at K = 32768
    allows most of a typical output of random signs, whose magnitude is
    about ``1.25 / sqrt(k)`` of its sum of absolute products. The second
    term is instead the growth of independent rounding errors, ``lambda *
    sqrt(k)`` steps of ``2**-24`` with ``lambda = 2`` (Higham and Mary's
    probabilistic analysis), for the kernel's sums and the plain version's
    alike. The inputs it holds are random-sign; a sum of one sign is held
    exactly instead (every partial sum an integer below 2**24)."""
    one_instruction = (_WGMMA_K + 1) * 2.0 ** (24 - _ACC_FRACTION_BITS)
    return (one_instruction + _GROWTH * math.sqrt(k)) * 2.0 ** -24


def gemm_error_bound(a_q: torch.Tensor, b_q: torch.Tensor,
                     scale: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on ``|kernel - plain|`` for the GEMM of ``a_q (M,
    K)`` and ``b_q (N, K)`` at ``scale``, ``want`` the plain version's
    result: ``accumulation_tolerance(K) * (|a_q| . |b_q|^T) * |scale|`` for
    the sums and the scale, plus ``2**-22 * |want|`` for the bias add, which
    rounds each side once more (the sum of absolute products is itself an
    f32 matmul of nonnegative terms, within ``k * 2**-24`` of its value)."""
    abs_sum = a_q.float().abs() @ b_q.float().abs().T
    c = accumulation_tolerance(a_q.shape[1])
    return (c * abs_sum * scale.float().abs()
            + 2.0 ** -22 * want.float().abs())


def gate_excess(got: torch.Tensor, want: torch.Tensor,
                bound: torch.Tensor) -> float:
    """The largest amount by which ``|got - want|`` exceeds ``bound``
    (<= 0 when the kernel keeps to it); a non-finite value fails."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - bound).max().item()
    return excess if bool(torch.isfinite(got).all()) else math.inf


def check_gemm(a_q: torch.Tensor, b_q: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None, got: torch.Tensor
               ) -> tuple[float, float, bool, torch.Tensor]:
    """Row 12's gate on the kernel's output ``got`` of ``fp8_gemm(a_q,
    b_q, scale, bias)``: the excess over :func:`gemm_error_bound` against
    the plain version (<= 0 passes), the largest error over the sum of
    absolute products (a reading), whether the epilogue is exact (the same
    GEMM launched at scale 1 and without the bias gives ``got`` back
    through the plain epilogue's multiply and add, bit for bit: both
    launches sum K in the same order), and the plain version's output."""
    want = fp8_gemm_plain(a_q, b_q, scale, bias)
    excess = gate_excess(got, want, gemm_error_bound(a_q, b_q, scale, want))
    abs_sum = (a_q.float().abs() @ b_q.float().abs().T) * scale.abs()
    ratio = ((got - want).abs() / abs_sum.clamp_min(1e-30)).max().item()
    raw = fp8_gemm(a_q, b_q, torch.ones_like(scale), backward=True)
    epilogue = raw * scale if bias is None else raw * scale + bias
    return excess, ratio, torch.equal(got, epilogue), want


def _check(a_q: torch.Tensor, b_q: torch.Tensor, scale: torch.Tensor,
           bias: torch.Tensor | None) -> None:
    if a_q.ndim != 2 or b_q.ndim != 2 or a_q.shape[1] != b_q.shape[1]:
        raise ValueError(f"a_q {tuple(a_q.shape)} and b_q (N, K) "
                         f"{tuple(b_q.shape)} do not agree")
    if a_q.dtype not in _FMAX or b_q.dtype not in _FMAX:
        raise ValueError(f"a_q and b_q must be float8_e4m3fn or float8_e5m2, "
                         f"not {a_q.dtype}, {b_q.dtype}")
    if scale.numel() != 1:
        raise ValueError(f"scale must hold one value, not "
                         f"{tuple(scale.shape)}")
    if bias is not None and tuple(bias.shape) != (b_q.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} is not (N,)="
                         f"({b_q.shape[0]},)")


def fp8_gemm(a_q: torch.Tensor, b_q: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor | None = None, *,
             backward: bool = False,
             k_split: int | None = None) -> torch.Tensor:
    """``(a_q . b_q^T) * scale + bias``, f32 ``(M, N)``.

    Args:
        a_q: ``(M, K)`` fp8 (e4m3, or e5m2 for a gradient).
        b_q: ``(N, K)`` fp8 e4m3.
        scale: the f32 combined per-tensor scale (one value), read by the
            kernel from device memory.
        bias: optional ``(N,)`` bias added in f32 after the rescale.
        backward: count the launch in ``bwd_launches`` (the backward's dx
            and dw GEMMs) instead of ``launches``.
        k_split: the length of the K ranges summed apart, a multiple of 128
            (default: :func:`k_range`'s; one range when it is at least K).
    """
    _check(a_q, b_q, scale, bias)
    if a_q.device.type == "cpu":
        return fp8_gemm_plain(a_q, b_q, scale, bias)
    if a_q.device.type != "cuda":
        raise ValueError(f"fp8_gemm runs on CUDA or CPU tensors, not "
                         f"{a_q.device.type}")
    if (a_q.dtype, b_q.dtype) not in _KERNEL_FORMATS:
        raise ValueError(f"the fp8 GEMM kernel takes e4m3 x e4m3 or "
                         f"e5m2 x e4m3 operands, not {a_q.dtype} x "
                         f"{b_q.dtype}")
    operands = [scale] + ([] if bias is None else [bias])
    if b_q.device != a_q.device or any(
            t.dtype != torch.float32 or t.device != a_q.device
            for t in operands):
        raise ValueError("fp8_gemm kernel takes b_q, and an f32 scale and "
                         "bias, on the device of a_q")
    if not all(t.is_contiguous() for t in operands + [a_q, b_q]):
        raise ValueError("fp8_gemm kernel needs contiguous operands")
    a_q, b_q = tma_operands(a_q, b_q)
    m, k = a_q.shape
    n = b_q.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a_q.device)
    if k_split is None:
        k_split = k_range(m, n, k, torch.cuda.get_device_properties(
            a_q.device).multi_processor_count)
    if k_split < _RANGE_STEP or k_split % _RANGE_STEP:
        raise ValueError(f"k_split {k_split} is not a positive multiple of "
                         f"{_RANGE_STEP}")
    ranges = -(-k // k_split)
    workspace = (None if ranges == 1 else torch.empty(
        (ranges, m, n), dtype=torch.float32, device=a_q.device))
    lib = _build.load()
    with torch.cuda.device(a_q.device):
        stream = torch.cuda.current_stream(a_q.device).cuda_stream
        rc = lib.jimm_fp8_matmul(
            a_q.data_ptr(), b_q.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if workspace is None else workspace.data_ptr(), m, n, k,
            k_split, _FORMATS[a_q.dtype], _FORMATS[b_q.dtype], stream)
    _build.check(rc, "jimm_fp8_matmul")
    if backward:
        _build.count_launch(__name__, "bwd_launches")
    else:
        _build.count_launch(__name__, "launches")
    return out


class Fp8MatmulFn(torch.autograd.Function):
    """``x @ w.T + bias`` in fp8, f32 out; the counterpart of the JAX
    ``custom_vjp`` ``_fp8_matmul``. The forward quantizes x and w to e4m3 at
    the given scales and saves the fp8 tensors (1 byte an element) as
    residuals; the backward quantizes dy to e5m2 at its dynamic scale and
    contracts it against them (straight through the quantizer):
    ``dx = dy_q . w_q`` at ``dy_scale * w_scale`` in x's dtype, ``dw = dy_q^T
    . x_q`` at ``x_scale * dy_scale`` in w's dtype, ``dbias`` the f32 sum of
    the unquantized dy in the bias dtype. The scales get no gradient. A dx
    or dw that no input needs is not computed (JAX's jit drops it alike).

    On a mesh, ``amax_group`` (a ``comm.AxisGroup``) is the ranks dy is
    split over: its amax is their max, as JAX's dynamic scale of a global
    array is (one scalar all-reduce a backward, counted in
    ``amax_reductions``). ``sum_group``: a row-parallel product's ``model``
    group; the GEMM gives this rank's partial product unscaled in f32, the
    group sums them, and the scale and bias are applied once, as the
    kernel's epilogue applies them to a whole product."""

    @staticmethod
    def forward(ctx, x, w, bias, x_scale, w_scale, amax_group=None,
                sum_group=None, k_ranges=None):
        if k_ranges is None and x.device.type == "cuda":
            k_ranges = tuned_k_ranges(x, w, torch.cuda.get_device_properties(
                x.device).multi_processor_count)
        ranges = k_ranges or {}
        x_q = quantize_tensor(x, x_scale, E4M3)
        w_q = quantize_tensor(w, w_scale, E4M3)
        # the bias joins the f32 epilogue in f32, as in JAX's _fp8_gemm
        b = None if bias is None else bias.float()
        k_fwd = ranges.get("k_range_fwd")
        if sum_group is None or sum_group.pg is None:
            y = fp8_gemm(x_q, w_q, x_scale * w_scale, b, k_split=k_fwd)
        else:
            y = fp8_gemm(x_q, w_q, torch.ones_like(x_scale), k_split=k_fwd)
            torch.distributed.all_reduce(y, group=sum_group.pg)
            y = y * (x_scale * w_scale)
            if b is not None:
                y = y + b
        ctx.save_for_backward(x_q, w_q, x_scale, w_scale)
        ctx.dtypes = (x.dtype, w.dtype, None if bias is None else bias.dtype)
        ctx.amax_group = amax_group
        ctx.k_ranges = ranges
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        global amax_reductions
        x_q, w_q, x_scale, w_scale = ctx.saved_tensors
        x_dtype, w_dtype, b_dtype = ctx.dtypes
        grp = ctx.amax_group
        if grp is None or grp.pg is None:
            dy_scale = dynamic_scale(dy, E5M2)
        else:
            from jimm_tpu_torch.parallel.comm import all_reduce_max_
            dy_amax = all_reduce_max_(tensor_amax(dy).reshape(1), grp)
            amax_reductions += 1
            dy_scale = _scale_from(dy_amax.reshape(()), E5M2)
        dy_q = quantize_tensor(dy, dy_scale, E5M2)
        dx = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = fp8_gemm(dy_q, w_q.T.contiguous(), dy_scale * w_scale,
                          backward=True,
                          k_split=ctx.k_ranges.get("k_range_dx")).to(x_dtype)
        if ctx.needs_input_grad[1]:
            dw = fp8_gemm(dy_q.T.contiguous(), x_q.T.contiguous(),
                          x_scale * dy_scale, backward=True,
                          k_split=ctx.k_ranges.get("k_range_dw")).to(w_dtype)
        if b_dtype is not None and ctx.needs_input_grad[2]:
            dbias = dy.float().sum(dim=0).to(b_dtype)
        return dx, dw, dbias, None, None, None, None, None


def fp8_matmul(x: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor | None = None, *,
               x_scale: torch.Tensor | None = None,
               w_scale: torch.Tensor | None = None, amax_group=None,
               sum_group=None,
               k_ranges: dict[str, int] | None = None) -> torch.Tensor:
    """Differentiable fp8 matmul ``x @ w.T + bias``, f32 ``(M, N)``.

    Args:
        x: ``(M, K)`` activations (any float dtype).
        w: ``(N, K)`` weights (the ``nn.Linear`` layout).
        bias: optional ``(N,)`` bias added in f32 after dequantization.
        x_scale, w_scale: f32 per-tensor scales; ``None`` takes the dynamic
            scale of the live tensor (the policy module passes delayed
            scales instead).
        amax_group, sum_group: on a mesh, the ranks the gradient's amax is
            taken over, and a row-parallel product's ``model`` group (see
            :class:`Fp8MatmulFn`).
        k_ranges: the three GEMMs' K-range lengths, ``{"k_range_fwd",
            "k_range_dx", "k_range_dw"}`` (default on the card:
            :func:`tuned_k_ranges`; explicit values skip the lookup).
    """
    xs = dynamic_scale(x, E4M3) if x_scale is None else x_scale.float()
    ws = dynamic_scale(w, E4M3) if w_scale is None else w_scale.float()
    return Fp8MatmulFn.apply(x, w, bias, xs, ws, amax_group, sum_group,
                             k_ranges)
