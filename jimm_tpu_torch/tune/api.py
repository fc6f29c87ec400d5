"""``best_config`` lookup and the offline tuner; the counterpart of
``jimm_tpu/tune/api.py``.

The contract the kernel wrappers rely on:

- **Never measure in the hot path** unless asked: ``best_config`` returns
  the stored config or the knob's default (the heuristic that picks it
  today); it measures only under ``JIMM_TUNE=1``. ``tune run`` and
  :func:`tune_kernel` measure offline.
- **One store probe a shape a process.** JAX looks up at trace time, once
  a traced shape; the port launches eagerly, a lookup a launch, and its
  steps are host-bound. So a resolution, hit or miss, is memoized per
  ``(kernel, shapes, dtypes, device)`` on the cache object, and what a
  launch then pays is a tuple and a dict probe. ``configure()`` starts a
  new cache and so an empty memo; a ``put`` clears it.
- **Every resolution is counted**: ``jimm_tune_hit_total`` /
  ``jimm_tune_miss_total`` / ``jimm_tune_fallback_total`` (once a
  resolution, not once a launch), ``jimm_tune_measure_total`` a
  measurement.
- **Explicit knobs win**: a wrapper given its knob skips the lookup, so the
  bench closures below, which pass each candidate explicitly, never
  recurse.
- **A knob's bench launches the knob's kernel alone**: the LayerNorm
  backward, row 8's dbias kernel, the fp8 call's three GEMMs, on inputs
  the main path's forward makes, timed on the device
  (`measure.py`). Timed inside a whole forward and backward, a knob worth
  a few microseconds sat under the host's autograd and quantizer passes,
  and the winner moved from run to run.
- **The default stays unless beaten beyond the noise**: a candidate
  replaces the default only when its trimmed median is below the
  default's by more than the larger of the two trimmed spreads; every
  trial is stored with its spread. A stored knob changes a reduction's
  order (dscale/dbias partials, the dbias ranges, split-K sums), so it
  should change only for a real gain.
- **A measurement on a miss runs with gradients on**: a lookup inside a
  custom Function's forward or backward runs with grad mode off, where the
  autograd benches of the compiled-tile kernels could not differentiate.

The wrappers resolve their knobs inside the real launch (the CUDA branch),
never in a fake: an exported program's ``jimm::`` op runs its wrapper at
call time, where the lookup then happens. The process-wide cache defaults to
``JIMM_TUNE_CACHE`` or ``~/.cache/jimm_tpu_torch/tune``; ``serve
--tune-cache`` repoints it with :func:`configure`. See `space.py` for the
knobs and their feasible values.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Mapping, Sequence

from jimm_tpu_torch import obs
from jimm_tpu_torch.tune.cache import TuneCache, TuneKey, tune_key
from jimm_tpu_torch.tune.measure import (measure_samples, trimmed_median,
                                         trimmed_spread)
from jimm_tpu_torch.tune.space import (bias_space, compiled_tile, fp8_space,
                                       ln_space, retrieval_default,
                                       retrieval_space)

__all__ = ["KERNELS", "NOT_PORTED", "KernelSpec", "best_config", "configure",
           "device_sms", "get_cache", "tune_kernel"]

Shapes = Sequence[Sequence[int]]
Dtypes = Sequence[Any]

#: JAX's kernels whose port waits, with the reason a tune run refuses them
NOT_PORTED = {
    "retrieval_ivf": "retrieval_ivf is not ported yet: IVF search, "
                     "ROADMAP.md queue 1 item 9 part 2",
    "retrieval_tier": "retrieval_tier is not ported yet: tiered residency, "
                      "ROADMAP.md queue 1 item 9 part 3",
}


def device_sms(device: Any) -> int:
    """The card's SM count; 1 for the CPU, where the knobs reach no kernel
    (the plain versions ignore them) and only the path is exercised."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def _torch_dtype(name: Any):
    import torch
    from jimm_tpu_torch.tune.cache import dtype_name
    return getattr(torch, dtype_name(name))


def _gen(device) -> Any:
    import torch
    return torch.Generator(device=device).manual_seed(0)


def _randn(shape, dtype, device, g, requires_grad: bool = False):
    import torch
    x = torch.randn(tuple(shape), generator=g, device=device,
                    dtype=torch.float32).to(dtype)
    return x.requires_grad_(requires_grad)


def _grad_step(loss_fn: Callable[[], Any], inputs: tuple) -> Callable[[], Any]:
    """A closure running ``loss_fn`` forward and its backward to
    ``inputs`` (fresh gradients a call, nothing accumulates)."""
    import torch

    def step():
        return torch.autograd.grad(loss_fn(), inputs)
    return step


def _qkv(shapes: Shapes, dtypes: Dtypes, device) -> tuple:
    g = _gen(device)
    dt = _torch_dtype(dtypes[0] if dtypes else "float32")
    return tuple(_randn(s, dt, device, g, True) for s in shapes[:3])


def _padding_mask(b: int, sk: int, device):
    """NaFlex-shaped key padding: ~25% of the keys masked, every row keeping
    its first key (JAX's bench mask)."""
    import torch
    g = torch.Generator(device=device).manual_seed(1)
    mask = torch.rand((b, sk), generator=g, device=device) > 0.25
    mask[:, 0] = True
    return mask


# ---------------------------------------------------------------------------
# the kernels with a knob
# ---------------------------------------------------------------------------

def _ln_default(shapes: Shapes, dtypes: Dtypes, device) -> dict:
    """Today's grid: the C entry's answer on the card
    (``jimm_layer_norm_bwd_grid``), its rule stated in Python elsewhere."""
    import torch

    from jimm_tpu_torch.ops import layer_norm as ln
    rows, f = (int(d) for d in shapes[0][-2:])
    dt = _torch_dtype(dtypes[0] if dtypes else "float32")
    if torch.device(device).type == "cuda":
        x = torch.empty((rows, f), dtype=dt, device=device)
        return {"ctas": ln.bwd_grid(x, x[0], x)}
    register = f % (16 // dt.itemsize) == 0 and f <= ln.REGISTER_MAX_F
    return {"ctas": ln.bwd_grid_rule(rows, f, dt, register=register, sms=1,
                                     resident=1)}


def _ln_bench(shapes: Shapes, dtypes: Dtypes, config: Mapping[str, int],
              device) -> Callable[[], Any]:
    """The LayerNorm backward (the knob's kernel and its partial-row sum) at
    the candidate's CTAs, on the statistics of the forward."""
    import torch

    from jimm_tpu_torch.ops import layer_norm as ln
    rows, f = (int(d) for d in shapes[0][-2:])
    dt = _torch_dtype(dtypes[0] if dtypes else "float32")
    g = _gen(device)
    x, dy = (_randn((rows, f), dt, device, g) for _ in range(2))
    scale = torch.ones((f,), dtype=dt, device=device)
    _, mean, rstd = ln.layer_norm_plain(x, scale, torch.zeros_like(scale),
                                        1e-6)
    ctas = int(config["ctas"])
    return lambda: ln.layer_norm_bwd(x, scale, mean, rstd, dy, ctas=ctas)


def _bias_default(shapes: Shapes, dtypes: Dtypes, device) -> dict:
    from jimm_tpu_torch.ops.flash_attention import dbias_batch_range
    b, sq, n, d = (int(x) for x in shapes[0])
    return {"batch_range": dbias_batch_range(b, n, sq, int(shapes[1][1]), d,
                                             device_sms(device))}


def _bias_bench(shapes: Shapes, dtypes: Dtypes, config: Mapping[str, int],
                device) -> Callable[[], Any]:
    """Row 8 (the dbias kernel and its range sum) at the candidate's range,
    on the bias forward's o and lse and the delta the backward shares."""
    import torch

    from jimm_tpu_torch.ops import flash_attention as fa
    q, k, v = (t.detach() for t in _qkv(shapes, dtypes, device))
    do = _randn(q.shape, q.dtype, device, _gen(device))
    n, sq, sk = q.shape[2], q.shape[1], k.shape[1]
    bias = _randn((n, sq, sk), torch.float32, device, _gen(device))
    o, lse = fa.flash_attention_bias_fwd(q, k, v, bias)
    delta = fa._delta(o, do, None)
    br = int(config["batch_range"])
    return lambda: fa.flash_attention_dbias(q, k, v, bias, o, lse, do,
                                            delta=delta, batch_range=br)


def _fp8_default(shapes: Shapes, dtypes: Dtypes, device) -> dict:
    from jimm_tpu_torch.ops.fp8_matmul import default_k_ranges
    m, k = (int(d) for d in shapes[0][-2:])
    n = int(shapes[1][-2])
    return default_k_ranges(m, n, k, device_sms(device))


def _fp8_bench(shapes: Shapes, dtypes: Dtypes, config: Mapping[str, int],
               device) -> Callable[[], Any]:
    """The fp8 call's three GEMMs (forward, dx, dw), each at the
    candidate's K range, on operands quantized as ``Fp8MatmulFn`` does."""
    import torch

    from jimm_tpu_torch.ops import fp8_matmul as fp8
    g = _gen(device)
    x = _randn(shapes[0], _torch_dtype(dtypes[0]), device, g)
    w = _randn(shapes[1], _torch_dtype(dtypes[-1]), device, g)
    dy = _randn((x.shape[0], w.shape[0]), x.dtype, device, g)
    xs, ws = (fp8.dynamic_scale(t, fp8.E4M3) for t in (x, w))
    dys = fp8.dynamic_scale(dy, fp8.E5M2)
    x_q, w_q = (fp8.quantize_tensor(t, s, fp8.E4M3)
                for t, s in ((x, xs), (w, ws)))
    dy_q = fp8.quantize_tensor(dy, dys, fp8.E5M2)
    w_t, dy_t, x_t = (t.T.contiguous() for t in (w_q, dy_q, x_q))
    bias = torch.zeros((w.shape[0],), dtype=torch.float32, device=device)
    fwd, dx, dw = (int(config[key]) for key in
                   ("k_range_fwd", "k_range_dx", "k_range_dw"))

    def step():
        fp8.fp8_gemm(x_q, w_q, xs * ws, bias, k_split=fwd)
        fp8.fp8_gemm(dy_q, w_t, dys * ws, backward=True, k_split=dx)
        fp8.fp8_gemm(dy_t, x_t, xs * dys, backward=True, k_split=dw)
    return step


def _retrieval_default(shapes: Shapes, dtypes: Dtypes, device) -> dict:
    return retrieval_default(shapes, dtypes)


def _retrieval_bench(shapes: Shapes, dtypes: Dtypes,
                     config: Mapping[str, int], device) -> Callable[[], Any]:
    """One streaming top-k pass (k = 10) at the candidate's block over a
    seeded normalized corpus shaped like the live one, made on the
    device."""
    from jimm_tpu_torch.retrieval.topk import synthetic_scan
    batch, dim = (int(d) for d in shapes[0][-2:])
    n_rows = int(shapes[-1][-2])
    return synthetic_scan(batch, n_rows, dim,
                          _torch_dtype(dtypes[-1] if dtypes else "float32"),
                          int(config["block_n"]), device, k=10)


# ---------------------------------------------------------------------------
# the kernels whose tile is compiled in: one candidate each
# ---------------------------------------------------------------------------

def _tile_default(kernel: str):
    return lambda shapes, dtypes, device: compiled_tile(kernel, shapes)


def _flash_bench(shapes: Shapes, dtypes: Dtypes, config: Mapping[str, int],
                 device) -> Callable[[], Any]:
    from jimm_tpu_torch.ops.flash_attention import flash_attention
    q, k, v = _qkv(shapes, dtypes, device)
    return _grad_step(lambda: flash_attention(q, k, v).float().sum(),
                      (q, k, v))


def _masked_bench(shapes: Shapes, dtypes: Dtypes, config: Mapping[str, int],
                  device) -> Callable[[], Any]:
    """Masked flash forward and backward; for ``ring_attention`` the
    shapes are a rank's chunk ``(B, S/p, N, D)``, and the hop's product is
    this same masked call (`parallel/seqpar.py`)."""
    from jimm_tpu_torch.ops.flash_attention import flash_attention_masked
    q, k, v = _qkv(shapes, dtypes, device)
    mask = _padding_mask(q.shape[0], k.shape[1], device)
    return _grad_step(lambda: flash_attention_masked(
        q, k, v, mask).float().sum(), (q, k, v))


def _sigmoid_bench(shapes: Shapes, dtypes: Dtypes, config: Mapping[str, int],
                   device) -> Callable[[], Any]:
    from jimm_tpu_torch.ops.flash_attention import sigmoid_attention
    q, k, v = _qkv(shapes, dtypes, device)
    return _grad_step(lambda: sigmoid_attention(q, k, v).float().sum(),
                      (q, k, v))


def _int8_flash_bench(shapes: Shapes, dtypes: Dtypes,
                      config: Mapping[str, int], device) -> Callable[[], Any]:
    from jimm_tpu_torch.ops.flash_attention_int8 import flash_attention_int8
    q, k, v = _qkv(shapes, dtypes, device)
    return _grad_step(lambda: flash_attention_int8(q, k, v).float().sum(),
                      (q, k, v))


def _int8_matmul_bench(shapes: Shapes, dtypes: Dtypes,
                       config: Mapping[str, int],
                       device) -> Callable[[], Any]:
    """The fused dequantizing matmul with gelu, forward only (a serving
    kernel): x ``(M, K)`` and w ``(N, K)``."""
    import torch

    from jimm_tpu_torch.ops.int8_matmul import int8_matmul
    (m, k), n = (int(d) for d in shapes[0][-2:]), int(shapes[1][-2])
    g = _gen(device)
    x_q = torch.randint(-127, 128, (m, k), generator=g, device=device,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (n, k), generator=g, device=device,
                        dtype=torch.int8)
    x_s = torch.full((m,), 0.01, device=device)
    w_s = torch.full((n,), 0.01, device=device)
    bias = torch.zeros((n,), device=device)
    return lambda: int8_matmul(x_q, x_s, w_q, w_s, bias, activation="gelu")


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One tunable kernel: identity, search space, default and bench."""

    version: int  # bump with the kernel: stale configs then miss
    #: ``(shapes, dtypes, *, default, sms) -> [config, ...]``
    space: Callable[..., list[dict]]
    #: ``(shapes, dtypes, device) -> config``: today's heuristic
    default: Callable[[Shapes, Dtypes, Any], dict]
    #: ``(shapes, dtypes, config, device) -> closure`` timed by `measure`
    bench: Callable[[Shapes, Dtypes, Mapping[str, int], Any],
                    Callable[[], Any]]


def _single(shapes, dtypes, *, default: dict, sms: int) -> list[dict]:
    return [dict(default)]


def _retrieval_candidates(shapes, dtypes, *, default: dict,
                          sms: int) -> list[dict]:
    rest = [c for c in retrieval_space(shapes, dtypes) if c != default]
    return [dict(default)] + rest


def _tile(kernel: str, bench) -> KernelSpec:
    return KernelSpec(version=1, space=_single,
                      default=_tile_default(kernel), bench=bench)


KERNELS: dict[str, KernelSpec] = {
    "layer_norm": KernelSpec(version=1, space=ln_space, default=_ln_default,
                             bench=_ln_bench),
    "flash_attention_bias": KernelSpec(version=1, space=bias_space,
                                       default=_bias_default,
                                       bench=_bias_bench),
    "fp8_matmul": KernelSpec(version=1, space=fp8_space,
                             default=_fp8_default, bench=_fp8_bench),
    "retrieval_topk": KernelSpec(version=1, space=_retrieval_candidates,
                                 default=_retrieval_default,
                                 bench=_retrieval_bench),
    "flash_attention": _tile("flash_attention", _flash_bench),
    "flash_attention_masked": _tile("flash_attention_masked", _masked_bench),
    "sigmoid_attention": _tile("sigmoid_attention", _sigmoid_bench),
    # keyed on a rank's chunk shapes (B, S/p, N, D), as JAX's
    "ring_attention": _tile("ring_attention", _masked_bench),
    "flash_attention_int8": _tile("flash_attention_int8", _int8_flash_bench),
    "int8_matmul": _tile("int8_matmul", _int8_matmul_bench),
}


def _spec(kernel: str) -> KernelSpec:
    if kernel in NOT_PORTED:
        raise ValueError(NOT_PORTED[kernel])
    try:
        return KERNELS[kernel]
    except KeyError:
        raise ValueError(f"unknown kernel {kernel!r}; tunable: "
                         f"{sorted(KERNELS)}") from None


# ---------------------------------------------------------------------------
# process-wide cache
# ---------------------------------------------------------------------------

_cache: TuneCache | None = None


def get_cache() -> TuneCache:
    global _cache
    if _cache is None:
        _cache = TuneCache()
    return _cache


def configure(root: str | os.PathLike | None) -> TuneCache:
    """Point the process-wide tune cache at ``root`` (``serve
    --tune-cache`` calls this before the first forward); the new cache's
    memo starts empty."""
    global _cache
    _cache = TuneCache(root)
    return _cache


# ---------------------------------------------------------------------------
# lookup (hot path) and tuning (offline)
# ---------------------------------------------------------------------------

def _key_for(kernel: str, shapes: Shapes, dtypes: Dtypes,
             device: Any) -> TuneKey:
    from jimm_tpu_torch.aot.keys import device_backend
    return tune_key(kernel, shapes=shapes, dtypes=dtypes,
                    kernel_version=KERNELS[kernel].version,
                    device=device_backend(device))


def _default_config(spec: KernelSpec, default, shapes: Shapes,
                    dtypes: Dtypes, device: Any) -> dict:
    if default is None:
        return spec.default(shapes, dtypes, device)
    return dict(default() if callable(default) else default)


def best_config(kernel: str, shapes: Shapes, dtypes: Dtypes, *,
                default: Mapping[str, int] | Callable[[], Mapping[str, int]]
                | None = None, device: Any = "cpu",
                cache: TuneCache | None = None) -> dict:
    """The tuned config of ``kernel`` at these shapes on ``device``, else
    its default: ``default`` (a mapping, or a callable evaluated only
    then), or the kernel's own default. Lookup only unless ``JIMM_TUNE=1``;
    memoized per (kernel, shapes, dtypes, device), misses included (see the
    module docstring)."""
    spec = _spec(kernel)
    cache = cache or get_cache()
    memo = (kernel, tuple(tuple(s) for s in shapes), tuple(dtypes), device)
    try:
        config = cache.resolved[memo]
    except KeyError:
        registry = obs.get_registry("jimm_tune")
        record = cache.get(_key_for(kernel, shapes, dtypes, device))
        if record is not None:
            registry.counter("hit_total").inc()
            config = record["config"]
        else:
            registry.counter("miss_total").inc()
            config = None
            if os.environ.get("JIMM_TUNE") == "1":
                config = tune_kernel(kernel, shapes, dtypes, cache=cache,
                                     device=device)["config"]
            else:
                registry.counter("fallback_total").inc()
        cache.resolved[memo] = config
    if config is not None:
        return dict(config)
    return _default_config(spec, default, shapes, dtypes, device)


def _winner(trials: list[dict]) -> dict:
    """The fastest trial that beats the default (the first) by more than
    the larger of their trimmed spreads; else the default."""
    base = best = trials[0]
    for t in trials[1:]:
        margin = max(t["spread_s"], base["spread_s"])
        if t["time_s"] + margin < base["time_s"] and \
                t["time_s"] < best["time_s"]:
            best = t
    return best


def tune_kernel(kernel: str, shapes: Shapes, dtypes: Dtypes, *,
                cache: TuneCache | None = None, reps: int | None = None,
                candidates: Sequence[Mapping[str, int]] | None = None,
                device: Any = None) -> dict:
    """Measure the default and every feasible candidate on ``device``
    (default: the card when torch sees one), persist the winner
    (:func:`_winner`) with both times and every trial's spread, and return
    ``{"config", "time_s", "default", "default_time_s", "candidates",
    "fingerprint", "trials"}``. Runs with gradients on, whatever the
    caller's grad mode (see the module docstring)."""
    import torch

    spec = _spec(kernel)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    cache = cache or get_cache()
    key = _key_for(kernel, shapes, dtypes, device)
    default = spec.default(shapes, dtypes, device)
    cands = (list(candidates) if candidates is not None
             else spec.space(shapes, dtypes, default=default,
                             sms=device_sms(device)))
    cands = [dict(default)] + [dict(c) for c in cands if dict(c) != default]
    trials = []
    with torch.enable_grad():
        for config in cands:
            fn = spec.bench(shapes, dtypes, config, device)
            samples = measure_samples(fn, reps=reps, kernel=kernel,
                                      device=device)
            trials.append({"config": config,
                           "time_s": trimmed_median(samples),
                           "spread_s": trimmed_spread(samples)})
            del fn
    best = _winner(trials)
    default_time = trials[0]["time_s"]
    fingerprint = cache.put(key, best["config"], metrics={
        "time_s": best["time_s"], "default": default,
        "default_time_s": default_time,
        "default_spread_s": trials[0]["spread_s"], "trials": trials})
    return {"config": dict(best["config"]), "time_s": best["time_s"],
            "default": default, "default_time_s": default_time,
            "candidates": len(trials), "fingerprint": fingerprint,
            "trials": trials}
