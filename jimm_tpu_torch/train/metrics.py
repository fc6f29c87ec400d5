"""Training metrics: analytic model FLOPs, MFU against the card's peak,
step timing and a console + JSONL metrics logger mirrored into a metric
registry; the counterpart of ``jimm_tpu/train/metrics.py`` (TensorBoard
waits for ROADMAP.md queue 1, item 10)."""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import IO, Any

import torch

from jimm_tpu_torch.obs.registry import MetricRegistry, get_registry

#: Peak dense bf16 TFLOP/s by device name (NVIDIA's H100 SXM data sheet,
#: at the full 700 W power limit)
PEAK_TFLOPS: dict[str, float] = {"h100": 989.0}


def device_peak_tflops(device: torch.device | str | None = None
                       ) -> float | None:
    """The bf16 peak of a CUDA device from its name; None for a device the
    table does not know (the CPU included)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev).lower()
    for key, peak in PEAK_TFLOPS.items():
        if key in name:
            return peak
    return None


def mfu(flops_per_step: float | None, step_time_s: float | None,
        peak_tflops: float | None, n_devices: int = 1) -> float | None:
    """Model FLOPs utilization in [0, 1]: the step's model FLOPs over its
    time and the devices' peak. None when any input is missing or not a
    positive finite number; degenerate inputs (a missing, non-finite or
    negative FLOP count, a missing or non-positive step time, a
    non-positive peak) also bump the ``jimm_train`` registry's
    ``mfu_degenerate_total``, where the reference's ``mfu`` does. An
    unknown peak (a device the table does not know) is not degenerate."""
    if (flops_per_step is None or step_time_s is None
            or not math.isfinite(step_time_s) or step_time_s <= 0.0
            or not math.isfinite(flops_per_step) or flops_per_step < 0.0
            or (peak_tflops is not None and peak_tflops <= 0.0)):
        get_registry("jimm_train").counter("mfu_degenerate_total").inc()
        return None
    if peak_tflops is None:
        return None
    return flops_per_step / (step_time_s * peak_tflops * 1e12 * n_devices)


@dataclass
class StepTimer:
    """Wall-clock step timing, synced at both ends by fetching to the host
    values that depend on the last update (a loss alone can be ready before
    the optimizer has finished)."""

    t0: float = 0.0

    def start(self, *sync: torch.Tensor) -> None:
        for t in sync:
            float(t.detach())
        self.t0 = time.perf_counter()

    def stop(self, *sync: torch.Tensor) -> float:
        for t in sync:
            float(t.detach())
        return time.perf_counter() - self.t0


@dataclass
class MetricsLogger:
    """Structured metrics: one JSON object per logged step, appended to a
    JSONL file (``path``) and printed to the console every
    ``print_every`` steps.

    With a ``registry`` (the train command passes the shared ``jimm_train``
    one), every logged scalar is mirrored into it, as the reference's
    logger does: the ``steps_logged_total`` counter, ``step_time_s`` into
    the ``step_time_seconds`` histogram, every other numeric value as a
    last-value gauge."""

    path: str | Path | None = None
    print_every: int = 1
    registry: MetricRegistry | None = None
    _file: IO | None = field(default=None, repr=False)

    def log(self, step: int, **metrics: Any) -> None:
        record = json.dumps({"step": step, "time": time.time(), **metrics},
                            default=float)
        if self.path is not None:
            if self._file is None:
                Path(self.path).parent.mkdir(parents=True, exist_ok=True)
                self._file = open(self.path, "a")
            self._file.write(record + "\n")
            self._file.flush()
        if self.registry is not None:
            self._registry_log(metrics)
        if self.print_every and step % self.print_every == 0:
            print(record, flush=True)

    def _registry_log(self, metrics: dict[str, Any]) -> None:
        reg = self.registry
        reg.counter("steps_logged_total").inc()
        for k, v in metrics.items():
            try:
                value = float(v)
            except (TypeError, ValueError):
                continue  # non-numeric (None included): JSONL only
            if k == "step_time_s":
                reg.histogram("step_time_seconds").observe(value)
            else:
                try:
                    reg.gauge(k).set(value)
                except ValueError:  # a name taken by another kind
                    pass

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


# -- analytic model FLOPs (the same formulas as the JAX package) -----------

def _tower_fwd_flops(width: int, depth: int, mlp_dim: int, seq: int) -> float:
    matmul_params = depth * (4 * width * width + 2 * width * mlp_dim)
    attn = depth * 4 * seq * seq * width  # qk^T and pv
    return 2 * matmul_params * seq + attn


def vision_fwd_flops(v) -> float:
    """Per-image forward FLOPs of a VisionConfig tower (+ patch conv, MAP)."""
    seq = v.seq_len
    total = _tower_fwd_flops(v.width, v.depth, v.mlp_dim, seq)
    total += 2 * (v.patch_size ** 2 * v.channels * v.width) * v.num_patches
    if v.pooling == "map":
        # probe cross-attention: k/v projections over seq + mlp on 1 token
        total += 2 * (2 * v.width ** 2) * seq + 2 * (2 * v.width * v.mlp_dim)
    return total


def text_fwd_flops(t) -> float:
    return _tower_fwd_flops(t.width, t.depth, t.mlp_dim, t.context_length)


def model_fwd_flops(cfg) -> float:
    """Per-sample forward FLOPs of a SigLIP config (vision + text towers and
    the text projection)."""
    total = vision_fwd_flops(cfg.vision)
    if hasattr(cfg, "text"):
        total += text_fwd_flops(cfg.text)
        proj = getattr(cfg, "projection_dim", cfg.text.width)
        total += 2 * cfg.text.width * proj
        if cfg.vision.pooling == "cls":
            total += 2 * cfg.vision.width * proj  # CLIP visual projection
    return total


def train_step_flops(cfg, batch_size: int) -> float:
    """Model FLOPs (no remat recompute) of one training step: fwd + 2x bwd."""
    return 3.0 * model_fwd_flops(cfg) * batch_size
