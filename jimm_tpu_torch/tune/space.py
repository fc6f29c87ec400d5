"""Per-kernel search spaces over the launch parameters the port's kernels
take at run time; where the port departs from ``jimm_tpu/tune/space.py``.

JAX tunes Pallas block sizes and prunes them with models of a TPU core's
VMEM (``jimm_tpu/tune/space.py:56-400``). None of that is copied: its
budgets are a TPU's, and a threshold taken from a TPU has no meaning on
the H100. The port's kernels have their tiles compiled in; what a launch
chooses today, by a heuristic in its wrapper, is the search space here:

============================  =================================  ==========
kernel (JAX's ``KERNELS``)    knob (config key)                  feasible
============================  =================================  ==========
``layer_norm``                the backward's CTAs, the ``ctas``  1 .. rows
                              of ``jimm_layer_norm_bwd``
                              (``ctas``)
``flash_attention_bias``      row 8's samples a batch range      1 .. B
                              (``batch_range``)
``fp8_matmul``                the K-range length of each of the  128 .. K,
                              call's three GEMMs (``k_range_fwd``,  a multiple
                              ``k_range_dx``, ``k_range_dw``)     of 128
``retrieval_topk``            ``block_n`` of the streaming scan  a power of
                                                                 two, 128 ..
                                                                 N padded to
                                                                 128
the rest                      none: one candidate naming the     --
                              compiled tile
============================  =================================  ==========

Each kernel's default is the heuristic that picks the knob today
(`jimm_tpu_torch/tune/api.py` names it), so an empty cache changes no
launch and no bit; the scan's is :func:`retrieval_default`, the largest
block under a cap on its temporaries. Candidates come from the card (its
SM count) and the kernel's own limits, never from a model of a TPU's
memory: the default first, then a
few multiples of the SM count (CTAs), powers of two of the split count
(batch and K ranges) or of the block (retrieval), deduplicated. No module
here imports torch.
"""

from __future__ import annotations

from typing import Any, Sequence

__all__ = ["COMPILED_TILES", "FP8_KNOBS", "RETRIEVAL_BYTES_A_SCORE",
           "RETRIEVAL_MIN_BLOCK", "RETRIEVAL_TEMP_BYTES",
           "bias_space", "compiled_tile", "fp8_space", "ln_space",
           "pow2_splits", "retrieval_default", "retrieval_space"]

Shapes = Sequence[Sequence[int]]

#: the streaming scan's least block: a block below it spends its time on
#: the per-block merge, not on scoring
RETRIEVAL_MIN_BLOCK = 128
#: the scan's temporaries a block may take by default (0.3% of an 80 GB
#: card), and what one (query, row) pair takes of them: its f64 and f32
#: scores, its int64 key and its place in the carry's merge
#: (retrieval/topk.py ``scan_partition``)
RETRIEVAL_TEMP_BYTES = 256 << 20
RETRIEVAL_BYTES_A_SCORE = 40
#: the fp8 GEMM's K-range step: two of its 64-wide stages
#: (ops/fp8_matmul.py ``_RANGE_STEP``)
_FP8_RANGE_STEP = 128
#: the fp8 call's three GEMMs, by config key
FP8_KNOBS = ("k_range_fwd", "k_range_dx", "k_range_dw")
#: split counts tried for a batch or K range (1 = the whole axis)
_SPLITS = (1, 2, 4, 8, 16, 32)
#: multiples of the SM count tried for the LayerNorm backward's CTAs
_CTA_WAVES = (1, 2, 4, 8, 16)

#: the tiles compiled into the kernels without a run-time knob
#: (csrc/flash_attention.cu ``kBQ``/``kBK``, csrc/flash_mma.cuh ``kRows``,
#: csrc/flash_attention_int8.cu, csrc/int8_matmul.cu ``kBlockN`` and its
#: two row counts)
COMPILED_TILES = {
    "flash_attention": {"block_q": 64, "block_k": 64},
    "flash_attention_masked": {"block_q": 64, "block_k": 64},
    "sigmoid_attention": {"block_q": 64, "block_k": 64},
    "ring_attention": {"block_q": 64, "block_k": 64},
    "flash_attention_int8": {"block_q": 64, "block_k": 64},
}


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _dedup(configs: list[dict]) -> list[dict]:
    seen, out = set(), []
    for c in configs:
        key = tuple(sorted(c.items()))
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def compiled_tile(kernel: str, shapes: Shapes) -> dict:
    """The one candidate of a kernel without a knob: the tile its source
    compiles in (the int8 matmul's rows by M, as its entry picks them)."""
    if kernel == "int8_matmul":
        m = int(shapes[0][-2])
        return {"block_m": 64 if m <= 64 else 128, "block_n": 128}
    return dict(COMPILED_TILES[kernel])


def ln_space(shapes: Shapes, dtypes: Sequence[Any], *, default: dict,
             sms: int) -> list[dict]:
    """``{"ctas"}`` candidates for a LayerNorm of ``(rows, F)``: the
    default, then 1, 2, 4, 8 and 16 CTAs an SM, each at most ``rows`` (the
    C entry's limit, csrc/layer_norm_bwd.cu:451)."""
    rows = int(shapes[0][-2])
    cands = [dict(default)] + [{"ctas": max(1, min(rows, sms * w))}
                               for w in _CTA_WAVES]
    return _dedup(cands)


def pow2_splits(extent: int, step: int = 1) -> list[int]:
    """Range lengths, multiples of ``step``, that cut ``extent`` into 1, 2,
    4, ... 32 ranges (as many as it has steps)."""
    steps = -(-extent // step)
    return sorted({-(-steps // r) * step for r in _SPLITS if r <= steps},
                  reverse=True)


def bias_space(shapes: Shapes, dtypes: Sequence[Any], *, default: dict,
               sms: int) -> list[dict]:
    """``{"batch_range"}`` candidates for q of ``(B, S, N, D)``: the default,
    then B cut into 1, 2, 4, ... 32 ranges (at most B of them)."""
    b = int(shapes[0][0])
    return _dedup([dict(default)]
                  + [{"batch_range": n} for n in pow2_splits(b)])


def _fp8_extents(shapes: Shapes) -> dict[str, int]:
    """The K each of the three GEMMs sums, as the kernel takes it (padded
    to 16, ops/fp8_matmul.py ``tma_operands``): x ``(M, K)`` . w ``(N,
    K)^T`` over K; dx over N; dw over M."""
    (m, k), (n, _) = ((int(d) for d in s[-2:]) for s in shapes[:2])
    return {"k_range_fwd": _ceil_to(k, 16), "k_range_dx": _ceil_to(n, 16),
            "k_range_dw": _ceil_to(m, 16)}


def fp8_space(shapes: Shapes, dtypes: Sequence[Any], *, default: dict,
              sms: int) -> list[dict]:
    """``{"k_range_fwd", "k_range_dx", "k_range_dw"}`` candidates for x
    ``(M, K)`` and w ``(N, K)``: the default, then each GEMM's K cut into
    1, 2, 4, ... 32 ranges of whole 128s with the other two at their
    default (one GEMM moved at a time: the three are independent launches,
    so their product would multiply the sweep for nothing)."""
    cands = [dict(default)]
    for knob, extent in _fp8_extents(shapes).items():
        for length in pow2_splits(extent, _FP8_RANGE_STEP):
            cands.append({**default, knob: length})
    return _dedup(cands)


def retrieval_space(shapes: Shapes, dtypes: Sequence[Any] = ()
                    ) -> list[dict]:
    """``{"block_n"}`` candidates for a top-k workload shaped ``[(batch,
    dim), (n_rows, dim)]``: powers of two from 128 up to the corpus padded
    to 128 (a larger block covers every row with one padded block
    already)."""
    n_rows = int(shapes[-1][-2])
    top = _ceil_to(max(n_rows, 1), RETRIEVAL_MIN_BLOCK)
    out, bn = [], RETRIEVAL_MIN_BLOCK
    while bn <= top:
        out.append({"block_n": bn})
        bn *= 2
    return out


def retrieval_default(shapes: Shapes, dtypes: Sequence[Any] = ()) -> dict:
    """The scan's block without a record: the largest feasible block whose
    temporaries for the query batch (``shapes[0]``) stay within
    :data:`RETRIEVAL_TEMP_BYTES`, else the least feasible one. The eager
    scan pays its host work a block, so the fewest blocks the cap allows
    is the default (the port's own rule: JAX's is its 1024-row block,
    sized for a compiled ``lax.scan``)."""
    batch = max(1, int(shapes[0][-2]))
    cap = RETRIEVAL_TEMP_BYTES // (batch * RETRIEVAL_BYTES_A_SCORE)
    feasible = [c["block_n"] for c in retrieval_space(shapes, dtypes)]
    fits = [bn for bn in feasible if bn <= cap]
    return {"block_n": max(fits) if fits else min(feasible)}
