"""Candidate timing that measures the kernel, not the first call or the
host's launch work; the counterpart of ``jimm_tpu/tune/measure.py``.

- **First-call costs out of the sample**: the warmup call (the kernel
  library's load, the caching allocator's first blocks) is waited on and
  discarded.
- **Device time, not host time**: on the card each rep is the time between
  two CUDA events on the current stream, recorded around the call. Before
  each rep the card spins for :data:`HOLD_CYCLES` (about a millisecond),
  during which the host queues the rep's launches; so a closure whose
  launches take the host less than that is timed on the device alone, and
  one that is longer on the host (the retrieval scan's block loop) pays
  its host time, as a call of it does.
- **Scheduling noise**: the figure is the trimmed median of 7 reps (min
  and max dropped once there are at least 5), not a best-of, and
  :func:`trimmed_spread` says how far the kept reps lie apart, which
  `api.py::tune_kernel` requires a winner to beat the default by.

On the CPU the kernels' plain versions run and the timing says nothing of
the card, so reps short-circuit to 1 (JAX's interpret-mode rule) and are
host wall time: the path measure -> persist -> lookup is tested, the
number is not.

Every measurement adds one to ``jimm_tune_measure_total`` and runs under a
``tune_measure`` span and, when the caller names the kernel, a
``tune_measure_{kernel}`` span.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Any, Callable, Sequence

from jimm_tpu_torch import obs

__all__ = ["measure", "measure_samples", "trimmed_median", "trimmed_spread"]

#: timed reps a candidate on the card
CUDA_REPS = 7
#: cycles the card spins before a timed rep (~1 ms at an H100's clocks)
HOLD_CYCLES = 2_000_000


def _trimmed(samples: Sequence[float]) -> list[float]:
    xs = sorted(samples)
    if not xs:
        raise ValueError("no samples")
    return xs[1:-1] if len(xs) >= 5 else xs


def trimmed_median(samples: Sequence[float]) -> float:
    """Median after dropping the min and max (when >= 5 samples)."""
    xs = _trimmed(samples)
    mid = len(xs) // 2
    if len(xs) % 2:
        return xs[mid]
    return 0.5 * (xs[mid - 1] + xs[mid])


def trimmed_spread(samples: Sequence[float]) -> float:
    """Largest minus least of the samples :func:`trimmed_median` keeps."""
    xs = _trimmed(samples)
    return xs[-1] - xs[0]


def measure_samples(fn: Callable[[], object], *, reps: int | None = None,
                    warmup: int = 1, kernel: str | None = None,
                    device: Any = None) -> list[float]:
    """Each timed rep's seconds of ``fn()`` on ``device`` (default: the
    card when torch sees one, else the CPU); see the module docstring."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    on_card = device.type == "cuda"
    if reps is None:
        reps = CUDA_REPS if on_card else 1

    per_kernel = (obs.span(f"tune_measure_{kernel}") if kernel
                  else nullcontext())
    with obs.span("tune_measure"), per_kernel:
        for _ in range(max(1, warmup)):
            fn()
        samples = []
        if on_card:
            with torch.cuda.device(device):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                for _ in range(max(1, reps)):
                    torch.cuda.synchronize(device)
                    torch.cuda._sleep(HOLD_CYCLES)
                    start.record()
                    fn()
                    end.record()
                    end.synchronize()
                    samples.append(start.elapsed_time(end) / 1e3)
        else:
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                fn()
                samples.append(time.perf_counter() - t0)
    obs.get_registry("jimm_tune").counter("measure_total").inc()
    return samples


def measure(fn: Callable[[], object], *, reps: int | None = None,
            warmup: int = 1, kernel: str | None = None,
            device: Any = None) -> float:
    """Trimmed-median seconds of ``fn()`` (:func:`measure_samples`)."""
    return trimmed_median(measure_samples(fn, reps=reps, warmup=warmup,
                                          kernel=kernel, device=device))
