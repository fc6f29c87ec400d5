"""Batch shape buckets: every micro-batch is zero-padded up to one of a
small, fixed set of batch sizes, and each size is warmed once at startup.
The counterpart of ``jimm_tpu/serve/buckets.py``; the bucket sets here are
the port's own, not the TPU's."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

#: CPU bucket set: small enough that warmup is a few tiny forwards
DEFAULT_BATCH_BUCKETS: tuple[int, ...] = (1, 2, 4, 8)

#: card bucket set: single images, a small burst, and the 32-image batch
#: `chip_smoke.py` serves and measures (not tuned)
CUDA_BATCH_BUCKETS: tuple[int, ...] = (1, 8, 32)

#: the precisions a served model computes in (batches are assembled in f32
#: either way); "int8" is quantized weights with int8 activations
SERVE_DTYPES: tuple[str, ...] = ("float32", "bfloat16", "int8")


@dataclasses.dataclass(frozen=True)
class BucketTable:
    """An ascending, de-duplicated set of allowed batch sizes, tagged with
    the serving precision (reported by a model pool's ``describe``)."""

    sizes: tuple[int, ...]
    dtype: str = "float32"

    def __post_init__(self) -> None:
        sizes = tuple(sorted(set(int(s) for s in self.sizes)))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {self.sizes}")
        object.__setattr__(self, "sizes", sizes)
        if self.dtype not in SERVE_DTYPES:
            raise ValueError(f"unknown serve dtype {self.dtype!r}; "
                             f"known: {SERVE_DTYPES}")

    @property
    def max_size(self) -> int:
        return self.sizes[-1]

    def select(self, n: int) -> int | None:
        """Smallest bucket holding ``n`` items (None when ``n`` exceeds the
        largest bucket)."""
        if n < 1:
            raise ValueError(f"need n >= 1, got {n}")
        for size in self.sizes:
            if size >= n:
                return size
        return None

    def shed(self, n: int) -> int:
        """Largest bucket not exceeding ``n`` (the smallest bucket when none
        does)."""
        if n < 1:
            raise ValueError(f"need n >= 1, got {n}")
        best = self.sizes[0]
        for size in self.sizes:
            if size <= n:
                best = size
        return best


def pad_batch(rows: Sequence[np.ndarray], bucket: int) -> np.ndarray:
    """Stack ``rows`` (identical shapes/dtypes) and zero-pad the batch axis
    up to ``bucket``; the engine slices the padding off the output."""
    if not rows:
        raise ValueError("empty batch")
    if len(rows) > bucket:
        raise ValueError(f"{len(rows)} rows do not fit bucket {bucket}")
    stacked = np.stack(rows)
    if len(rows) == bucket:
        return stacked
    pad = np.zeros((bucket - len(rows),) + stacked.shape[1:], stacked.dtype)
    return np.concatenate([stacked, pad])


def default_buckets(device, dtype: str = "float32") -> BucketTable:
    """The bucket table for ``device`` (a ``torch.device`` or its string)."""
    kind = str(device).split(":")[0]
    return BucketTable(CUDA_BATCH_BUCKETS if kind == "cuda"
                       else DEFAULT_BATCH_BUCKETS, dtype=dtype)
