"""Side-by-side timing of kernel source variants on one card.

    python -m jimm_tpu_torch.kernel_ab --variant PATH.cu [--variant ...]
        [--case NAME ...] [--rounds N]

The base is the library ``_build`` builds from ``csrc/``. Each variant is
one CUDA source (an edited copy of a ``csrc/*.cu`` file, compiled alone with
``nvcc -shared`` and ``-I csrc`` for its headers) whose exported entry
points replace the base's while it is timed; every other entry point stays
the base's. Each case runs the port's public wrapper (the flash cases at
the train image shape of SigLIP-B/16, q, k, v (128, 256, 12, 64) bf16),
and is timed in
turns (base, then each variant, then in reverse order, ``--rounds`` times)
with CUDA events around 50 calls after 5 warm-up calls, so that every
variant is compared with the base on one card within one process. Prints
one JSON line per timing, with the card's name and power limit.

Cases: ``bwd``, ``mask_bwd``, ``sigmoid_bwd``, ``bias_bwd`` (row 7 in each
kind, dq and dk/dv), ``int8_fwd`` (row 9), ``int8_bwd`` (row 10, dq and
dk/dv), ``dbias`` (row 8, with the wrapper's batch ranges), ``fwd`` (row 3);
at the served int8 shapes of bucket 32 (``MATMUL_SHAPES``, f32 bias, no
activation) ``mm_qkv``, ``mm_fc1``, ``mm_fc2``, ``mm_head`` (row 11); and
``ln_train`` (32768 x 768) and ``ln_serve`` (8192 x 768) in bf16 (row 1);
``ln_bwd_train`` (32768 x 768) and ``ln_bwd_text`` (8192 x 768: the text
tower's rows) in bf16, ``ln_bwd_train_f32`` (row 2).
``--device-time``: time each variant by the device time of its kernels (a
profiler trace, as ``--kernels``) instead of CUDA events, for calls so
short that the host sets the pace between events (``mm_head``).
``--dbias-ranges R`` (repeatable) adds a case ``dbias@R``: row 8 with the
batch split into R ranges, whatever ``dbias_batch_range`` would choose.

``--kernels``: instead of the timings, each case's device time per call
on the base split by kernel (a ``torch.profiler`` trace of 20 calls after
5), which separates a wrapper's torch ops (row 7's and 10's delta pass)
from the kernels.

Two more readings of the same variants, for numerics rather than speed
(run from the repository root: they build models as ``chip_smoke.py``
does):

- ``--losses softmax|sigmoid[@LR]`` (repeatable; LR defaults to 1e-3,
  the train phase's): the losses of 13 steps of
  ``chip_smoke.py``'s train phase (SigLIP-B/16-256, bf16, batch 128, one
  fixed batch, AdamW) through the base, through each variant and with the
  plain versions swapped in;
- ``--grads softmax|naflex|sigmoid`` (repeatable): one bf16 batch-8
  step's gradients
  (``chip_smoke.py`` phases 5(a), 6(a), 10(a)) through the base and each
  variant, each parameter's cosine against the plain-version step and
  against the base's; prints the ten lowest against the plain versions
  (the k-projection biases, zero in exact arithmetic, left out);
- ``--grad-errors softmax|naflex|sigmoid`` (repeatable): the same step with
  the kernels swapped for plain versions in turn (``grad_swaps``), each
  parameter's distance ``||g - t||`` from the step in f32 through the plain
  versions, t, read against chip_smoke.py's per-gradient gate
  (``norm_gate``) with each of the two bf16 plain steps as its reference:
  the largest share of the bound, the gradients over it, the worst ones
  and the one-element parameters.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import pathlib
import subprocess
import tempfile
from unittest import mock

import torch

from jimm_tpu_torch import _build
from jimm_tpu_torch.obs.prof.capture import profiler_session
from jimm_tpu_torch.ops import flash_attention as fa
from jimm_tpu_torch.ops import flash_attention_int8 as fa8
from jimm_tpu_torch.ops import int8_matmul as mm
from jimm_tpu_torch.ops import layer_norm as ln

SHAPE = (128, 256, 12, 64)
#: row 11's (M, K, N) at a served bucket-32 batch: q/k/v/out, fc1, fc2 over
#: 8192 token rows, and the MAP head's q and out projections over 32
MATMUL_SHAPES = {"mm_qkv": (8192, 768, 768), "mm_fc1": (8192, 768, 3072),
                 "mm_fc2": (8192, 3072, 768), "mm_head": (32, 768, 768)}
#: row 1's (rows, F): the train step's (batch 128) and a served batch's
LN_SHAPES = {"ln_train": (32768, 768), "ln_serve": (8192, 768)}
#: row 2's (rows, F, dtype): the train step's image and text rows (batch
#: 128)
LN_BWD_SHAPES = {"ln_bwd_train": (32768, 768, torch.bfloat16),
                 "ln_bwd_text": (8192, 768, torch.bfloat16),
                 "ln_bwd_train_f32": (32768, 768, torch.float32)}


def variant_libraries(sources: list[pathlib.Path], out_dir: pathlib.Path
                      ) -> list[tuple[ctypes.CDLL, set[str]]]:
    """Each source compiled alone into a shared library (one nvcc each, all
    at once), and the entry points of ``_build._SIGNATURES`` it exports
    (their argtypes set)."""
    outs = [out_dir / f"variant_{i}.so" for i in range(len(sources))]
    procs = [subprocess.Popen(
        [_build.nvcc(), *_build._ARCH, "-shared", "-Xcompiler", "-fPIC",
         "-I", str(_build.CSRC_DIR), "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, out in zip(sources, outs)]
    libs = []
    for src, out, proc in zip(sources, outs, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{src}: nvcc failed:\n{err}")
        lib = ctypes.CDLL(str(out))
        names = set()
        for name, argtypes in _build._SIGNATURES.items():
            try:
                fn = getattr(lib, name)
            except AttributeError:
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            names.add(name)
        libs.append((lib, names))
    return libs


class _Routed:
    """The base library with some entry points sent to a variant."""

    def __init__(self, base: ctypes.CDLL, variant: ctypes.CDLL,
                 names: set[str]):
        self._base, self._variant, self._names = base, variant, names

    def __getattr__(self, name):
        return getattr(self._variant if name in self._names else self._base,
                       name)


def cases() -> dict:
    """Each case's call, on inputs made once from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, n, d = SHAPE
    q, k, v, do = (torch.randn(b, s, n, d, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_plain(q, k, v)
    mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
    mask[:, 243:] = False
    mo, mlse = fa.flash_attention_plain(q, k, v, mask=mask)
    bias = torch.randn(n, s, s, generator=g, device="cuda")
    bo, blse = fa.flash_attention_bias_plain(q, k, v, bias)
    qq, qs = fa8.quantize_heads(q)
    kq, ks = fa8.quantize_heads(k)
    o8, lse8 = fa8.flash_attention_int8_plain(qq, qs, kq, ks, v)
    logit_bias = fa.default_logit_bias(s)
    calls = {}
    for name, (m_, k_, n_) in MATMUL_SHAPES.items():
        x_q, x_s = mm.quantize_rows(torch.randn(m_, k_, generator=g,
                                                device="cuda"))
        w_q, w_s = mm.quantize_rows(torch.randn(n_, k_, generator=g,
                                                device="cuda"))
        mb = torch.randn(n_, generator=g, device="cuda")
        calls[name] = functools.partial(mm.int8_matmul, x_q, x_s, w_q, w_s,
                                        mb)
    for name, (rows, f) in LN_SHAPES.items():
        x, w, lb = (torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16) for shape in ((rows, f), (f,), (f,)))
        calls[name] = functools.partial(ln.layer_norm_fwd, x, w, lb)
    for name, (rows, f, dtype) in LN_BWD_SHAPES.items():
        x, dy = (torch.randn(rows, f, generator=g, device="cuda").to(dtype)
                 for _ in range(2))
        w = torch.randn(f, generator=g, device="cuda").to(dtype)
        _, mu, rstd = ln.layer_norm_plain(x, w, w)
        calls[name] = functools.partial(ln.layer_norm_bwd, x, w, mu, rstd,
                                        dy)
    return calls | {
        "bwd": lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
        "mask_bwd": lambda: fa.flash_attention_bwd(q, k, v, mo, mlse, do,
                                                   mask=mask),
        "sigmoid_bwd": lambda: fa.sigmoid_attention_bwd(
            q, k, v, do, logit_bias=logit_bias),
        "bias_bwd": lambda: fa.flash_attention_bias_bwd(q, k, v, bias, bo,
                                                        blse, do),
        "int8_fwd": lambda: fa8.flash_attention_int8_fwd(qq, qs, kq, ks, v),
        "int8_bwd": lambda: fa8.flash_attention_int8_bwd(qq, qs, kq, ks, v,
                                                         o8, lse8, do),
        "dbias": lambda: fa.flash_attention_dbias(q, k, v, bias, bo, blse,
                                                  do),
        "fwd": lambda: fa.flash_attention_lse(q, k, v),
    }


def case_shape(case: str) -> list[int]:
    """The shape a case runs at, for its JSON line."""
    name = case.partition("@")[0]
    if name in LN_BWD_SHAPES:
        return list(LN_BWD_SHAPES[name][:2])
    return list(MATMUL_SHAPES.get(name) or LN_SHAPES.get(name) or SHAPE)


def with_ranges(fn, ranges: int):
    """``fn`` with row 8's batch split into ``ranges`` ranges."""
    def call():
        chosen = fa.dbias_batch_range
        fa.dbias_batch_range = lambda b, *args: -(-b // ranges)
        try:
            return fn()
        finally:
            fa.dbias_batch_range = chosen
    return call


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
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


def kernel_ms(fn, iters: int = 20, warmup: int = 5) -> dict[str, float]:
    """Device time per call of ``fn`` by kernel name, from a profiler
    trace of ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profiler_session(cuda_only=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / iters / 1e3
            for e in prof.key_averages() if e.self_device_time_total > 0}


@contextlib.contextmanager
def _routed(base: ctypes.CDLL, lib: ctypes.CDLL, names: set[str]):
    _build._lib = _Routed(base, lib, names) if names else base
    try:
        yield
    finally:
        _build._lib = base


def _model(smoke, kind: str):
    if kind == "naflex":
        return smoke._naflex_model(torch.bfloat16)
    return smoke._train_model(torch.bfloat16,
                              "sigmoid" if kind == "sigmoid" else None)


def loss_trajectories(variants, kind: str, lr: float, card: str,
                      steps: int = 13) -> None:
    """Per-step losses of chip_smoke.py's train loop under each variant and
    under the plain versions."""
    import chip_smoke as smoke
    from jimm_tpu_torch.train.trainer import (OptimizerConfig,
                                              make_contrastive_train_step,
                                              make_optimizer)
    runs = [(label, functools.partial(_routed, variants[0][1], lib, names))
            for label, lib, names in variants]
    runs.append(("plain", smoke.plain_versions))
    for label, ctx in runs:
        model = _model(smoke, kind)
        optimizer = make_optimizer(model, OptimizerConfig(learning_rate=lr))
        step = make_contrastive_train_step("siglip")
        images, text = smoke._batch(model.config, smoke.TRAIN_BATCH,
                                    torch.bfloat16, 2)
        with ctx():
            losses = [float(step(model, optimizer, images, text)["loss"])
                      for _ in range(steps)]
        print(json.dumps({"losses": kind, "lr": lr, "variant": label,
                          "loss": losses, "card": card}), flush=True)


def grad_cosines(variants, kind: str, card: str) -> None:
    """Each parameter's bf16 batch-8 gradient under each variant: its
    cosine against the plain-version step and against the base's."""
    import chip_smoke as smoke
    model = _model(smoke, kind)
    batch = smoke._naflex_batch if kind == "naflex" else smoke._batch
    images, text = batch(model.config, 8, torch.bfloat16, 1)

    def grads(ctx):
        model.zero_grad(set_to_none=True)
        with ctx():
            smoke.contrastive_loss_fn(model, images, text,
                                      kind="siglip").backward()
        return {n: p.grad.float().flatten().clone()
                for n, p in model.named_parameters()}

    plain = grads(smoke.plain_versions)
    top = max(g.abs().max().item() for g in plain.values())
    base = None
    for label, lib, names in variants:
        got = grads(functools.partial(_routed, variants[0][1], lib, names))
        base = base or got
        rows = sorted(
            (torch.nn.functional.cosine_similarity(got[n], w, dim=0).item(),
             torch.nn.functional.cosine_similarity(got[n], base[n],
                                                   dim=0).item(),
             n, w.abs().max().item() / top)
            for n, w in plain.items()
            if not n.endswith("attn.k.bias") and w.abs().max() > 0)
        print(json.dumps({"grads": kind, "variant": label,
                          "largest_gradient": top,
                          "lowest": [{"name": n, "cos_plain": cp,
                                      "cos_base": cb, "peak_of_largest": r}
                                     for cp, cb, n, r in rows[:10]],
                          "card": card}), flush=True)


def _bwd_f32_delta(q, k, v, o, lse, do, dlse=None, *, is_causal=False,
                   mask=None):
    """Row 7's plain backward with its roundings of p and ds, but delta
    taken from o recomputed in f32 instead of the stored, rounded o."""
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bqnd,bknd->bnqk", qf, kf) * scale
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], fa.NEG_INF)
    p = torch.exp(s - lse[..., None])
    of = torch.einsum("bnqk,bknd->bqnd", p, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    dv = torch.einsum("bnqk,bqnd->bknd", p.to(q.dtype).float(), dof)
    dp = torch.einsum("bqnd,bknd->bnqk", dof, vf)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bnqk,bknd->bqnd", ds, kf) * scale
    dk = torch.einsum("bnqk,bqnd->bknd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _swap(smoke, plain: bool, keep_flash: bool = False, *patches):
    """A context: the plain versions (or the kernels) with ``patches``
    ``(module, name, value)`` on top."""
    @contextlib.contextmanager
    def run():
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(smoke.plain_versions(keep_flash))
            for module, name, value in patches:
                stack.enter_context(mock.patch.object(module, name, value))
            yield
    return run


def grad_swaps(smoke) -> dict:
    """The steps ``--grad-errors`` compares, by name."""
    def ln_plain(x, w, b, eps=1e-6):
        return ln.layer_norm_plain(x, w, b, eps)[0]

    def ln_f64(x, w, b, eps=1e-6):
        return ln.layer_norm_plain(x.double(), w.double(), b.double(),
                                   eps)[0].to(x.dtype)

    norm = smoke.norm_mod
    return {
        "kernels": _swap(smoke, False),
        "plain": _swap(smoke, True),
        "plain, flash Functions kept": _swap(smoke, True, True),
        "plain, flash Functions kept, delta from f32 o": _swap(
            smoke, True, True, (fa, "flash_attention_bwd", _bwd_f32_delta)),
        "plain but the LayerNorm kernels": _swap(
            smoke, True, False, (norm, "layer_norm", norm.layer_norm)),
        "kernels but the LayerNorm plain": _swap(
            smoke, False, False, (norm, "layer_norm", ln_plain)),
        "plain, LayerNorm in f64": _swap(
            smoke, True, False, (norm, "layer_norm", ln_f64)),
    }


def grad_errors(kind: str, card: str) -> None:
    """Each swap's per-parameter distance from the f32 step, read against
    chip_smoke.py's per-gradient gate with either plain step as the
    reference."""
    import chip_smoke as smoke
    model = _model(smoke, kind)
    batch = smoke._naflex_batch if kind == "naflex" else smoke._batch
    images, text = batch(model.config, 8, torch.bfloat16, 1)

    def grads(ctx):
        model.zero_grad(set_to_none=True)
        with ctx():
            smoke.contrastive_loss_fn(model, images, text,
                                      kind="siglip").backward()
        return {n: p.grad.double().clone()
                for n, p in model.named_parameters()}

    exact = {n: g.double() for n, g in smoke.f32_reference_grads(
        model, images, text, {}, [], None).items()}
    norms = {n: g.norm().item() for n, g in exact.items()}
    err = {label: {n: (g[n] - exact[n]).norm().item() for n in exact}
           for label, g in ((label, grads(ctx))
                            for label, ctx in grad_swaps(smoke).items())}
    gated = [n for n in exact if exact[n].numel() > 1 and not (
        kind != "sigmoid" and n.endswith("attn.k.bias"))]
    for ref in ("plain", "plain, flash Functions kept"):
        for label, e in err.items():
            share = {n: e[n] / (smoke.BF16_GRAD_NORM_R * err[ref][n]
                                + smoke.BF16_GRAD_NORM_EPS * norms[n])
                     for n in gated}
            worst = sorted(gated, key=share.get, reverse=True)[:5]
            print(json.dumps({
                "grad_errors": kind, "reference": ref, "swap": label,
                "largest_share": share[worst[0]], "over_bound": sum(
                    v > 1 for v in share.values()),
                "worst": {n: {"share": share[n], "rel": e[n] / norms[n]}
                          for n in worst},
                "one_element": {n: {"rel": e[n] / norms[n],
                                    "f32": exact[n].item()}
                                for n in exact if exact[n].numel() == 1},
                "card": card}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    type=pathlib.Path)
    ap.add_argument("--case", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--dbias-ranges", action="append", default=[], type=int)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--device-time", action="store_true")
    ap.add_argument("--losses", action="append", default=[])
    ap.add_argument("--grads", action="append", default=[],
                    choices=["softmax", "naflex", "sigmoid"])
    ap.add_argument("--grad-errors", action="append", default=[],
                    choices=["softmax", "naflex", "sigmoid"])
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    base = _build.load()
    if args.grad_errors:
        for kind in args.grad_errors:
            grad_errors(kind, card)
        return
    calls = cases()
    for ranges in args.dbias_ranges:
        calls[f"dbias@{ranges}"] = with_ranges(calls["dbias"], ranges)
    names = args.case or list(calls)
    if args.kernels:
        for case in names:
            print(json.dumps({"case": case, "kernel_ms": kernel_ms(
                calls[case]), "shape": case_shape(case), "card": card}),
                flush=True)
        return
    with tempfile.TemporaryDirectory() as tmp:
        variants = [("base", base, set())] + [
            (str(p), *built) for p, built in zip(
                args.variant,
                variant_libraries(args.variant, pathlib.Path(tmp)))]
        for spec in args.losses:
            kind, _, lr = spec.partition("@")
            loss_trajectories(variants, kind, float(lr or 1e-3), card)
        for kind in args.grads:
            grad_cosines(variants, kind, card)
        if args.losses or args.grads:
            return
        order = variants + variants[::-1]
        for case in names:
            for _ in range(args.rounds):
                for label, lib, routed in order:
                    _build._lib = base if not routed else _Routed(
                        base, lib, routed)
                    try:
                        ms = (sum(kernel_ms(calls[case]).values())
                              if args.device_time else time_ms(calls[case]))
                    finally:
                        _build._lib = base
                    print(json.dumps({"case": case, "variant": label,
                                      "ms": ms, "shape": case_shape(case),
                                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
