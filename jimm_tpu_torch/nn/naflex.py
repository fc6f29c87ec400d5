"""NaFlex (native-flexible-resolution) position embeddings for SigLIP2; the
counterpart of ``jimm_tpu/nn/naflex.py``.

Each sample of a variable-resolution batch has its own ``(h, w)`` patch
grid, and its tokens get the learned ``(H0, W0, D)`` position table resampled
to that grid with ``F.interpolate(mode="bilinear", align_corners=False,
antialias=True)`` semantics: the triangle filter, its support widened by the
downsampling factor, per axis. As in the JAX package the resample is one
batched contraction over per-sample interpolation weights, not a loop of
``F.interpolate`` calls, so the whole batch is one shape.
"""

from __future__ import annotations

import torch


def _axis_weights(idx: torch.Tensor, n_out: torch.Tensor, n_in: int
                  ) -> torch.Tensor:
    """Antialiased-bilinear weights ``(B, S, n_in)`` for sampling a length
    ``n_in`` source axis at output indices ``idx`` ``(B, S)`` of per-sample
    target lengths ``n_out`` ``(B,)``.

    For output index i: source center ``(i + 0.5) * s - 0.5`` with
    ``s = n_in / n_out``; triangle filter of half-width ``max(1, s)``,
    normalized over the in-range taps (which also gives torch's edge clamp
    for plain bilinear upsampling)."""
    scale = n_in / n_out.float()[:, None, None]
    src = (idx.float()[..., None] + 0.5) * scale - 0.5
    support = scale.clamp(min=1.0)
    taps = torch.arange(n_in, dtype=torch.float32, device=idx.device)
    w = (1.0 - (taps - src).abs() / support).clamp(min=0.0)
    # out-of-grid rows (padded tokens whose row/col lies past the sample's
    # h*w) can have an all-zero tap window; the epsilon makes their weights
    # zero instead of 0/0 = NaN, which would poison masked attention
    return w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)


def naflex_position_embedding(table: torch.Tensor,
                              spatial_shapes: torch.Tensor,
                              seq_len: int) -> torch.Tensor:
    """Sample a ``(H0, W0, D)`` position table at every token of every
    sample's ``(h, w)`` grid: token ``t`` of sample ``b`` lies at row
    ``t // w_b``, column ``t % w_b``. Returns ``(B, seq_len, D)`` f32. Rows
    past ``h * w`` are padding, masked out of attention: they are finite,
    and zero where their grid row lies beyond the filter's reach.

    ``spatial_shapes`` is ``(B, 2)`` int, per-sample (height, width) in
    patches. Differentiable in ``table``."""
    h0, w0, d = table.shape
    shapes = spatial_shapes.to(table.device, torch.long)
    h, w = shapes[:, 0], shapes[:, 1].clamp(min=1)
    t = torch.arange(seq_len, device=table.device)[None, :]
    wr = _axis_weights(t // w[:, None], h, h0)          # (B, S, H0)
    wc = _axis_weights(t % w[:, None], w, w0)           # (B, S, W0)
    # (B, S, H0*W0) @ (H0*W0, D): the outer product of the two axes' weights
    # is 1 KB a token at a 16 x 16 table, where contracting the table with
    # one axis first would make a (B, S, H0, D) intermediate, 48 KB a token
    # at D = 768
    both = torch.einsum("bsj,bsk->bsjk", wr, wc).reshape(
        wr.shape[0], seq_len, h0 * w0)
    return both @ table.float().reshape(h0 * w0, d)
