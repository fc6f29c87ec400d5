"""Training metrics: analytic model FLOPs, MFU against the card's peak,
step timing and a console + JSONL + TensorBoard metrics logger mirrored
into a metric registry; the counterpart of ``jimm_tpu/train/metrics.py``.

TensorBoard scalars are written without the ``tensorboard`` package (the
card's machine has none): :class:`EventFileWriter` frames each
``Event{wall_time, step, summary{value{tag, simple_value}}}`` protobuf as a
TFRecord (masked CRC32C, ``data/tfrecord.py``) in a file named as
tensorboard names its own, after a first ``file_version: "brain.Event:2"``
record; :func:`read_event_file` reads such a file back, CRCs checked."""

from __future__ import annotations

import itertools
import json
import math
import os
import socket
import struct
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import IO, Any

import torch

from jimm_tpu_torch.data.tfrecord import (TFRecordWriter, _iter_fields,
                                          _len_delim, _tag, _varint,
                                          read_tfrecord)
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


# -- TensorBoard event files -------------------------------------------------

#: the event-file version tensorboard's own writer stamps first
FILE_VERSION = "brain.Event:2"
_file_uid = itertools.count()


def encode_event(wall_time: float, step: int = 0, *,
                 file_version: str | None = None,
                 scalars: dict[str, float] | None = None,
                 writer: str | None = None) -> bytes:
    """One serialized ``tensorboard.Event`` (proto3: fields at their
    default are left out): ``wall_time`` (1, double), ``step`` (2),
    ``file_version`` (3), ``summary`` (5) of ``value {tag (1),
    simple_value (2, float)}``, ``source_metadata {writer}`` (10)."""
    out = b""
    if wall_time:
        out += _tag(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _tag(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version:
        out += _len_delim(3, file_version.encode())
    if scalars:
        values = b"".join(
            _len_delim(1, _len_delim(1, tag.encode())
                       + _tag(2, 5) + struct.pack("<f", value))
            for tag, value in scalars.items())
        out += _len_delim(5, values)
    if writer:
        out += _len_delim(10, _len_delim(1, writer.encode()))
    return out


def decode_event(buf: bytes) -> dict:
    """Inverse of :func:`encode_event`: ``{"wall_time", "step",
    "file_version", "scalars": {tag: value}}``."""
    ev = {"wall_time": 0.0, "step": 0, "file_version": None, "scalars": {}}
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            ev["wall_time"] = struct.unpack("<d", val)[0]
        elif fnum == 2:
            ev["step"] = val - (1 << 64) if val >= 1 << 63 else val
        elif fnum == 3:
            ev["file_version"] = val.decode()
        elif fnum == 5:
            for vnum, _, value in _iter_fields(val):
                if vnum != 1:
                    continue
                tag, simple = None, None
                for f, _, v in _iter_fields(value):
                    if f == 1:
                        tag = v.decode()
                    elif f == 2:
                        simple = struct.unpack("<f", v)[0]
                if tag is not None and simple is not None:
                    ev["scalars"][tag] = simple
    return ev


class EventFileWriter:
    """Scalar events for TensorBoard in ``logdir``:
    ``events.out.tfevents.<time>.<host>.<pid>.<n>``, a version record first,
    then one record per :meth:`add_scalars` call, flushed as written."""

    def __init__(self, logdir: str | Path):
        Path(logdir).mkdir(parents=True, exist_ok=True)
        self.path = Path(logdir) / (
            f"events.out.tfevents.{int(time.time()):010d}."
            f"{socket.gethostname()}.{os.getpid()}.{next(_file_uid)}")
        self._w = TFRecordWriter(self.path)
        self._write(encode_event(time.time(), file_version=FILE_VERSION,
                                 writer="jimm_tpu_torch.train.metrics"))

    def _write(self, record: bytes) -> None:
        self._w.write(record)
        self._w.flush()

    def add_scalars(self, step: int, scalars: dict[str, float],
                    wall_time: float | None = None) -> None:
        self._write(encode_event(time.time() if wall_time is None
                                 else wall_time, step, scalars=scalars))

    def close(self) -> None:
        self._w.close()


def read_event_file(path: str | Path) -> list[dict]:
    """Every event of one event file (:func:`decode_event`), both framing
    CRCs of each record checked."""
    return [decode_event(rec) for rec in read_tfrecord(path, verify=True)]


@dataclass
class MetricsLogger:
    """Structured metrics: one JSON object per logged step, appended to a
    JSONL file (``path``), printed to the console every ``print_every``
    steps, and with a ``tensorboard_dir`` written there as TensorBoard
    scalars (numeric values only; the rest stay JSONL-only, as in the
    reference).

    With a ``registry`` (the train command passes the shared ``jimm_train``
    one), every logged scalar is mirrored into it, as the reference's
    logger does: the ``steps_logged_total`` counter, ``step_time_s`` into
    the ``step_time_seconds`` histogram, every other numeric value as a
    last-value gauge."""

    path: str | Path | None = None
    print_every: int = 1
    tensorboard_dir: str | Path | None = None
    registry: MetricRegistry | None = None
    _file: IO | None = field(default=None, repr=False)
    _tb: EventFileWriter | None = field(default=None, repr=False)

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
        if self.tensorboard_dir is not None:
            self._tb_log(step, metrics)
        if self.print_every and step % self.print_every == 0:
            print(record, flush=True)

    def _tb_log(self, step: int, metrics: dict[str, Any]) -> None:
        if self._tb is None:
            self._tb = EventFileWriter(self.tensorboard_dir)
        scalars = {}
        for k, v in metrics.items():
            try:
                # the JSONL's default=float coercion: numpy and 0-d tensor
                # scalars land here too
                scalars[k] = float(v)
            except (TypeError, ValueError):
                pass  # non-numeric (None, strings): JSONL only
        if scalars:
            self._tb.add_scalars(step, scalars)

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
        if self._tb is not None:
            self._tb.close()
            self._tb = None


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
