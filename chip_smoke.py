#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``jimm_tpu_torch``) runs on an
NVIDIA card: ``python3 chip_smoke.py`` from the repository root, one card.

Phases, each of which ends the run with a non-zero exit when it fails:

1. device   -- a CUDA card must be visible; prints its name and, from
               nvidia-smi, its name and power limit.
2. build    -- compiles every kernel of ``jimm_tpu_torch/csrc`` with nvcc for
               sm_90a (``jimm_tpu_torch/_build.py``).
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the served shapes and some odd ones, in f32 (max abs error
               <= 1e-4, TF32 off) and bf16 (cosine >= 0.999 and max abs
               error <= 2**-7 of the largest reference value, about one
               bf16 step); reports the
               device time (profiler) of the kernel, of the plain version
               and of one PyTorch library call that computes the same
               function (a yardstick the port never calls), the kernel's
               time per call (CUDA events), and the least time the card
               could take (bytes over 3.35 TB/s or flops over the peak).
4. serve    -- SigLIP-B/16-256 at full width in bf16, fused LayerNorm and
               flash attention, random weights from a seeded generator,
               behind the port's HTTP server with buckets (1, 8, 32): 48
               /v1/embed requests from 16 client threads plus one bulk
               request of 32 images. Every answer must match the same
               model's forward with the kernels' plain versions swapped in
               (cosine >= 0.999, and norms within 1%, which a uniformly
               scaled answer fails), and the launch counters must show 13 flash
               and 24 LayerNorm launches per dispatched batch. Then the
               forward's time per bucket, its device-busy share, and the
               kernels of a bucket-32 forward by device time.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import base64
import contextlib
import json
import math
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from jimm_tpu_torch import _build, configs
from jimm_tpu_torch.models.siglip import SigLIP
from jimm_tpu_torch.nn import norm as norm_mod
from jimm_tpu_torch.ops import attention as attention_mod
from jimm_tpu_torch.ops import flash_attention as fa
from jimm_tpu_torch.ops import layer_norm as ln
from jimm_tpu_torch.serve.admission import AdmissionPolicy
from jimm_tpu_torch.serve.buckets import BucketTable
from jimm_tpu_torch.serve.engine import InferenceEngine, image_forward
from jimm_tpu_torch.serve.server import ServingServer

#: H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
F32_MAX_ERR = 1e-4
BF16_MIN_COS = 0.999
BF16_REL_ERR = 2.0**-7  # one bf16 step relative to the largest value
SERVE_MIN_COS = 0.999
SERVE_NORM_RTOL = 1e-2
FLASH_PER_BATCH = 13   # 12 encoder blocks + the MAP probe
LN_PER_BATCH = 24      # ln1 + ln2 of 12 blocks (ln_post, head ln: plain LN)


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call of ``fn`` between CUDA events around ``iters``
    back-to-back calls, after ``warmup`` calls: device time plus any gap in
    which the device waits for the host (L2 warm in both timings: the served
    path reads what the layer before just wrote)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn``: the device time of every kernel it
    launches, from a torch.profiler (CUPTI) trace over ``iters`` calls after
    ``warmup``. Unlike events around a loop, this leaves out the time the
    device sits idle while Python prepares the next launch.

    A trace now and then comes back with no device rows at all; it is taken
    again, and after three empty traces the call is timed with CUDA events
    instead (noted on stderr)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in _device_rows(prof))
        if us > 0:
            return us / iters / 1e3
    print("chip_smoke: the profiler recorded no device time; timed with "
          "CUDA events instead", file=sys.stderr, flush=True)
    return cuda_ms(fn, iters=iters, warmup=0)


def _device_rows(prof) -> list:
    """The kernel (device-side) rows of a profile, one per kernel name."""
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def bound_ms(nbytes: int, flops: float, dtype: torch.dtype
             ) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got: torch.Tensor, want: torch.Tensor
            ) -> tuple[float, float, float]:
    """Max abs error, cosine, and the largest reference magnitude."""
    got, want = got.float().flatten(), want.float().flatten()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    err = (got - want).abs().max().item()
    cos = F.cosine_similarity(got, want, dim=0).item()
    return err, cos, want.abs().max().item()


def within(dtype: torch.dtype, err: float, cos: float, peak: float) -> bool:
    """f32: max abs error; bf16: cosine, and max abs error relative to the
    largest reference value, which a uniformly scaled output fails."""
    if dtype == torch.float32:
        return err <= F32_MAX_ERR
    return cos >= BF16_MIN_COS and err <= BF16_REL_ERR * peak + 1e-6


# -- phase 3: kernels --------------------------------------------------------

def ln_case(rows: int, f: int, dtype: torch.dtype, seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, f, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    w = torch.randn(f, generator=g, device="cuda").to(dtype)
    b = torch.randn(f, generator=g, device="cuda").to(dtype)
    y, mu, rstd = ln.layer_norm_fwd(x, w, b, 1e-6)
    torch.cuda.synchronize()
    py, pmu, prstd = ln.layer_norm_plain(x, w, b, 1e-6)
    err, cos, peak = compare(y, py)
    stat_err = max(compare(mu, pmu)[0], compare(rstd, prstd)[0])
    check(within(dtype, err, cos, peak) and stat_err <= F32_MAX_ERR,
          f"layer_norm ({rows}, {f}) {dtype}: err {err} cos {cos} "
          f"stats {stat_err}")
    nbytes = sum(t.nbytes for t in (x, w, b, y, mu, rstd))
    bound, by = bound_ms(nbytes, 8.0 * rows * f, dtype)
    return {"shape": f"({rows}, {f})", "dtype": str(dtype)[6:],
            "max_abs_err": err, "cosine": cos,
            "ms": device_ms(lambda: ln.layer_norm_fwd(x, w, b, 1e-6)),
            "call_ms": cuda_ms(lambda: ln.layer_norm_fwd(x, w, b, 1e-6)),
            "plain_ms": device_ms(lambda: ln.layer_norm_plain(x, w, b, 1e-6)),
            "library_ms": device_ms(lambda: F.layer_norm(x, (f,), w, b,
                                                         1e-6)),
            "bound_ms": bound, "bound_by": by}


def flash_case(qshape: tuple[int, int, int, int], sk: int, causal: bool,
               dtype: torch.dtype, seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, n, d = qshape
    q = torch.randn(b, sq, n, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, sk, n, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, sk, n, d, generator=g, device="cuda").to(dtype)
    o, lse = fa.flash_attention_lse(q, k, v, is_causal=causal)
    torch.cuda.synchronize()
    po, plse = fa.flash_attention_plain(q, k, v, is_causal=causal)
    err, cos, peak = compare(o, po)
    lse_err = compare(lse, plse)[0]
    check(within(dtype, err, cos, peak) and lse_err <= F32_MAX_ERR,
          f"flash {qshape} sk={sk} causal={causal} {dtype}: err {err} "
          f"cos {cos} lse err {lse_err}")
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk)
    flops = 4.0 * b * n * pairs * d
    nbytes = sum(t.nbytes for t in (q, k, v, o, lse))
    bound, by = bound_ms(nbytes, flops, dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return {"shape": f"q{qshape} sk={sk}" + (" causal" if causal else ""),
            "dtype": str(dtype)[6:], "max_abs_err": err, "cosine": cos,
            "ms": device_ms(lambda: fa.flash_attention_lse(
                q, k, v, is_causal=causal)),
            "call_ms": cuda_ms(lambda: fa.flash_attention_lse(
                q, k, v, is_causal=causal)),
            "plain_ms": device_ms(lambda: fa.flash_attention_plain(
                q, k, v, is_causal=causal)),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal)),
            "bound_ms": bound, "bound_by": by}


def kernel_phase(card: str) -> dict[str, dict]:
    """Runs every case; returns the served-shape bf16 case of each kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(("layer_norm", ln_case(8192, 768, dtype, 1)))
        cases.append(("layer_norm", ln_case(7, 80, dtype, 2)))
        for i, (qshape, sk, causal) in enumerate([
                ((32, 256, 12, 64), 256, False),   # image self-attention
                ((32, 1, 12, 64), 256, False),     # MAP probe
                ((32, 64, 12, 64), 64, False),     # text self-attention
                ((2, 5, 2, 80), 5, False), ((2, 5, 2, 80), 5, True),
                ((2, 257, 2, 64), 257, True), ((2, 257, 2, 80), 257, False),
                ((2, 1, 2, 80), 257, False)]):
            cases.append(("flash_attention",
                          flash_case(qshape, sk, causal, dtype, 10 + i)))
    for name, c in cases:
        print(f"kernel {name} {c['shape']} {c['dtype']}: max_abs_err "
              f"{c['max_abs_err']:.3e} cosine {c['cosine']:.6f} | device "
              f"time: kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"library {c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} "
              f"ms ({c['bound_by']}); kernel per call {c['call_ms']:.4f} ms "
              f"| {card}", flush=True)
    return {"layer_norm": cases[0][1], "flash_attention": cases[2][1],
            "flash_probe": cases[3][1], "flash_text": cases[4][1]}


# -- phase 4: serve ----------------------------------------------------------

def _post(port: int, payload: dict) -> tuple[float, dict]:
    body = json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/embed",
                                 data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        out = json.loads(resp.read())
    return time.perf_counter() - t0, out


def _b64(img: np.ndarray) -> dict:
    return {"image_b64": base64.b64encode(img.tobytes()).decode(),
            "shape": list(img.shape)}


def serve_phase(card: str) -> dict:
    cfg = configs.with_runtime(configs.preset("siglip-base-patch16-256"),
                               ln_impl="fused")
    check(cfg.vision.attn_impl == "auto", "preset attn_impl changed")
    t0 = time.perf_counter()
    model = SigLIP(cfg, device="cuda", dtype=torch.bfloat16,
                   generator=torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    size = cfg.vision.image_size
    engine = InferenceEngine(
        image_forward(model), item_shape=(size, size, 3),
        buckets=BucketTable((1, 8, 32)), max_delay_ms=10.0,
        policy=AdmissionPolicy(max_queue=256, default_timeout_s=120.0))
    server = ServingServer(engine, port=0, request_timeout_s=300.0)
    server.start()
    print(f"serve: SigLIP-B/16-256 bf16 built and warmed "
          f"(buckets {engine.buckets.sizes}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (80, size, size, 3)).astype(np.float32)
    # base64 bodies: a JSON list of 196,608 floats per image is parsed in
    # Python on the server side and would dominate the timed traffic (the
    # list form is covered by the CPU tests)
    singles = [_b64(img) for img in images[:48]]
    bulk = {"images": [_b64(img) for img in images[48:]]}
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.launches = 0
        ln.launches = 0
        t_start = time.perf_counter()
        with ThreadPoolExecutor(16) as pool:
            answers = list(pool.map(lambda p: _post(server.port, p), singles))
        t_bulk = time.perf_counter()
        bulk_s, bulk_out = _post(server.port, bulk)
        t_end = time.perf_counter()
        flash_n, ln_n = fa.launches, ln.launches
        batches = engine.metrics.count("batches_total")
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.stop()
    features = np.asarray([out["features"] for _, out in answers]
                          + bulk_out["features"], np.float32)
    check(features.shape == (80, cfg.vision.width),
          f"features shape {features.shape}")
    check(bool(np.isfinite(features).all()), "non-finite features")
    check(batches > 0 and flash_n == FLASH_PER_BATCH * batches
          and ln_n == LN_PER_BATCH * batches,
          f"launch counts: {flash_n} flash, {ln_n} layer_norm over "
          f"{batches} batches")
    print(f"serve: {batches} batches dispatched; launches flash {flash_n} "
          f"= {FLASH_PER_BATCH}/batch, layer_norm {ln_n} = "
          f"{LN_PER_BATCH}/batch", flush=True)

    batch = torch.from_numpy(images).to("cuda", torch.bfloat16)
    ref = []
    with plain_versions(), torch.inference_mode():
        for i in range(0, 80, 32):
            ref.append(model.encode_image(batch[i:i + 32]).float().cpu()
                       .numpy())
    check(fa.launches == flash_n and ln.launches == ln_n,
          "the reference forward launched a kernel")
    ref = np.concatenate(ref)
    norm, ref_norm = (np.linalg.norm(features, axis=1),
                      np.linalg.norm(ref, axis=1))
    cos = (features * ref).sum(1) / (norm * ref_norm)
    norm_err = np.abs(norm / ref_norm - 1)
    check(bool((cos >= SERVE_MIN_COS).all()),
          f"served features vs plain forward: min cosine {cos.min()}")
    check(bool((norm_err <= SERVE_NORM_RTOL).all()),
          f"served features vs plain forward: norm off by {norm_err.max()}")
    lat = np.asarray([s for s, _ in answers]) * 1e3
    n_img = len(images)
    print(f"serve: 80 answers match the plain-version forward, min cosine "
          f"{cos.min():.6f}, norms within {norm_err.max():.2e}", flush=True)
    print(f"serve: /v1/embed single-request latency p50 "
          f"{np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f}"
          f" ms (48 requests, 16 client threads) | {card}", flush=True)
    print(f"serve: {48 / (t_bulk - t_start):.1f} images/s over the singles, "
          f"{32 / bulk_s:.1f} images/s for the bulk request of 32, "
          f"{n_img / (t_end - t_start):.1f} images/s overall | {card}",
          flush=True)
    print(f"serve: torch.cuda.max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB) | {card}", flush=True)
    forward_readout(model, batch, card)
    return {"flash_attention": flash_n, "layer_norm": ln_n,
            "batches": batches}


@contextlib.contextmanager
def plain_versions():
    """The model's kernel calls answered by the kernels' plain versions."""
    def plain_ln(x, w, b, eps=1e-6):
        return ln.layer_norm_plain(x, w, b, eps)[0]

    def plain_flash(q, k, v, *, is_causal=False):
        return fa.flash_attention_plain(q, k, v, is_causal=is_causal)[0]

    with mock.patch.object(norm_mod, "layer_norm", plain_ln), \
            mock.patch.object(attention_mod, "flash_attention", plain_flash):
        yield


def forward_readout(model: SigLIP, batch: torch.Tensor, card: str) -> None:
    """Device time of one encode_image per bucket (kernels, then plain
    versions), and where a bucket-32 forward's device time goes."""
    with torch.inference_mode():
        for size in (1, 8, 32):
            x = batch[:size]

            def fwd():
                return model.encode_image(x)

            k_call, k_dev = cuda_ms(fwd, iters=10), device_ms(fwd, iters=10)
            with plain_versions():
                p_call, p_dev = (cuda_ms(fwd, iters=10),
                                 device_ms(fwd, iters=10))
            print(f"forward: encode_image bucket {size}: kernels {k_call:.3f}"
                  f" ms per call, {k_dev:.3f} ms device busy (idle "
                  f"{max(0.0, 1 - k_dev / k_call):.0%}); plain versions "
                  f"{p_call:.3f} ms per call, {p_dev:.3f} ms device busy "
                  f"| {card}", flush=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            model.encode_image(batch[:32])
            torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in _device_rows(prof)), reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        print("profile: the trace of a bucket-32 forward recorded no device "
              "time", flush=True)
        return
    print(f"profile: bucket-32 forward, {total / 1e3:.3f} ms of kernel time "
          f"| {card}", flush=True)
    for us, count, key in rows[:10]:
        print(f"profile:   {us / 1e3:8.3f} ms {100 * us / total:5.1f}% "
              f"x{count:<4d} {key[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {name} ({torch.cuda.device_count()} visible); "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    try:
        t0 = time.perf_counter()
        built = _build.library_path().exists()
        _build.load()
        print(f"build: {_build.library_path().name} (nvcc, sm_90a) "
              f"{'found' if built else 'built'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        timed = kernel_phase(card)
        launches = serve_phase(card)
        check(all(math.isfinite(timed[k]["ms"]) for k in timed), "bad timing")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    sources = {"layer_norm": ("jimm_tpu_torch/csrc/layer_norm.cu",
                              "jimm_tpu/ops/layer_norm.py:52"),
               "flash_attention": ("jimm_tpu_torch/csrc/flash_attention.cu",
                                   "jimm_tpu/ops/flash_attention.py:136")}
    record = []
    for kernel, (source, replaces) in sources.items():
        c = timed[kernel]
        record.append({"name": kernel, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[kernel],
                       "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                       "call_ms": c["call_ms"],
                       "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                       "bound_by": c["bound_by"],
                       "library_ms": c["library_ms"], "shape": c["shape"],
                       "dtype": c["dtype"]})
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
