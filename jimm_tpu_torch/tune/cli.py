"""``python -m jimm_tpu_torch tune``: measure the kernels' launch knobs
offline and inspect the results; the counterpart of
``jimm_tpu/tune/cli.py``.

- ``run``: measure the default and every feasible candidate of a kernel at
  given shapes (``--kernel``/``--shapes``, or the points of a ``--preset``
  at ``--batch-size``: its towers' LayerNorm and fp8 GEMMs), persist the
  winner with both times, and print them. A point already in the store is
  a hit and measures nothing, so a second run of the same command leaves
  ``jimm_tune_measure_total`` unchanged.
- ``ls``: list tuned entries (kernel, shapes, config, times) without
  importing torch.
"""

from __future__ import annotations

import argparse
import json

from jimm_tpu_torch.tune.cache import TuneCache, default_root

__all__ = ["add_tune_parser", "cmd_tune", "main"]


def _parse_shapes(text: str) -> list[tuple[int, ...]]:
    """``"8x256x12x64,8x256x12x64"`` -> [(8, 256, 12, 64), (8, 256, 12, 64)]."""
    shapes = []
    for part in text.split(","):
        dims = tuple(int(d) for d in part.strip().split("x"))
        if not dims:
            raise ValueError(f"empty shape in {text!r}")
        shapes.append(dims)
    return shapes


def _preset_points(preset_name: str, batch_size: int,
                   dtype: str) -> list[dict]:
    """The (kernel, shapes, dtypes) points one preset's towers launch at
    ``batch_size``: each tower's LayerNorm at ``(B * S, width)`` and the fp8
    GEMMs of its Linears, x ``(B * S, K)`` and w ``(N, K)`` (q/k/v/out,
    fc1, fc2), keyed as the wrappers key them (one dtype an operand)."""
    from jimm_tpu_torch.configs import preset
    cfg = preset(preset_name)
    towers = [(cfg.vision.seq_len, cfg.vision)]
    text = getattr(cfg, "text", None)
    if text is not None:
        towers.append((text.context_length, text))
    points: list[dict] = []
    for seq, tower in towers:
        m, w, mlp = batch_size * seq, tower.width, tower.mlp_dim
        points.append({"kernel": "layer_norm", "shapes": [(m, w)],
                       "dtypes": [dtype]})
        for n, k in ((w, w), (mlp, w), (w, mlp)):
            points.append({"kernel": "fp8_matmul",
                           "shapes": [(m, k), (n, k)],
                           "dtypes": [dtype, dtype]})
    seen, out = set(), []
    for p in points:
        key = json.dumps(p, sort_keys=True)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def _spreads(trials: list[dict], config: dict) -> dict:
    """The default's and the winner's trimmed spreads (null where a record
    has none)."""
    spread = {json.dumps(t["config"], sort_keys=True): t.get("spread_s")
              for t in trials}
    return {"default_spread_s": trials[0].get("spread_s") if trials else None,
            "spread_s": spread.get(json.dumps(config, sort_keys=True))}


def _cmd_run(args) -> int:
    import torch

    from jimm_tpu_torch.tune.api import _key_for, _spec, tune_kernel
    if args.kernel:
        try:
            _spec(args.kernel)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if args.preset:
        points = _preset_points(args.preset, args.batch_size, args.dtype)
        if args.kernel:
            points = [p for p in points if p["kernel"] == args.kernel]
    else:
        if not (args.kernel and args.shapes):
            raise SystemExit("tune run needs --preset or "
                             "--kernel + --shapes")
        shapes = _parse_shapes(args.shapes)
        dtypes = args.dtype.split(",")
        if len(dtypes) == 1:
            dtypes = dtypes * len(shapes)
        if len(dtypes) != len(shapes):
            raise SystemExit(f"--dtype names {len(dtypes)} dtypes for "
                             f"{len(shapes)} shapes")
        points = [{"kernel": args.kernel, "shapes": shapes,
                   "dtypes": dtypes}]
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tune run measures on the card (--device cuda) and "
                         "torch sees none; pass --device cpu to exercise "
                         "the path")
    cache = TuneCache(args.store)
    report = []
    for point in points:
        kernel, shapes, dtypes = (point["kernel"], point["shapes"],
                                  point["dtypes"])
        record = cache.get(_key_for(kernel, shapes, dtypes, device))
        if record is not None:
            metrics = record.get("metrics", {})
            row = {"source": "hit", "config": record["config"],
                   "time_s": metrics.get("time_s"),
                   "default": metrics.get("default"),
                   "default_time_s": metrics.get("default_time_s"),
                   "candidates": len(metrics.get("trials", [])),
                   **_spreads(metrics.get("trials", []), record["config"]),
                   "fingerprint": _key_for(kernel, shapes, dtypes,
                                           device).fingerprint()[:16]}
        else:
            result = tune_kernel(kernel, shapes, dtypes, cache=cache,
                                 reps=args.reps, device=device)
            row = {"source": "measured", "config": result["config"],
                   "time_s": result["time_s"], "default": result["default"],
                   "default_time_s": result["default_time_s"],
                   "candidates": result["candidates"],
                   **_spreads(result["trials"], result["config"]),
                   "fingerprint": result["fingerprint"][:16]}
        report.append({"kernel": kernel,
                       "shapes": [list(s) for s in shapes],
                       "dtypes": list(dtypes), **row})
    print(json.dumps({"store": str(cache.root), "device": str(device),
                      "tuned": report}, indent=2))
    return 0


def _cmd_ls(args) -> int:
    cache = TuneCache(args.store)
    rows = []
    for e in cache.entries():
        rows.append({"fingerprint": e.fingerprint,
                     "kernel": e.meta.get("kernel"),
                     "shapes": e.meta.get("shapes"),
                     "dtypes": e.meta.get("dtypes"),
                     "device": e.meta.get("device"),
                     "torch": e.meta.get("torch"),
                     "kernels": e.meta.get("kernels"),
                     "last_used": e.last_used})
    if args.json:
        print(json.dumps(rows, indent=2, sort_keys=True))
        return 0
    if not rows:
        print(f"(empty tune cache: {cache.root})")
        return 0
    for r in sorted(rows, key=lambda r: r["last_used"], reverse=True):
        shapes = ",".join("x".join(str(d) for d in s)
                          for s in (r["shapes"] or []))
        print(f"{r['fingerprint'][:16]}  {r['kernel'] or '?':<20}  "
              f"{shapes:<28}  {','.join(r['dtypes'] or [])}  "
              f"device={r['device'] or '?'}")
    print(f"total: {len(rows)} entries")
    return 0


def add_tune_parser(subparsers) -> None:
    """Attach the ``tune`` subcommand tree to a command line's
    subparsers."""
    from jimm_tpu_torch.tune.space import COMPILED_TILES
    kernels = sorted({"layer_norm", "flash_attention_bias", "fp8_matmul",
                      "retrieval_topk", "int8_matmul", "retrieval_ivf",
                      "retrieval_tier", *COMPILED_TILES})
    p = subparsers.add_parser(
        "tune", help="measure the kernels' launch knobs into a persistent "
                     "cache")
    p.set_defaults(func=cmd_tune)
    sub = p.add_subparsers(dest="tune_cmd", required=True)

    pr = sub.add_parser("run", help="measure candidates and persist winners")
    pr.add_argument("--store", default=default_root(),
                    help="tune cache root (default: JIMM_TUNE_CACHE or "
                         "~/.cache/jimm_tpu_torch/tune)")
    pr.add_argument("--preset", default=None,
                    help="derive points from a preset's towers (LayerNorm, "
                         "fp8 GEMMs)")
    pr.add_argument("--batch-size", type=int, default=8)
    pr.add_argument("--kernel", default=None, choices=kernels,
                    help="restrict to one kernel (with --preset) or name "
                         "the kernel for explicit --shapes")
    pr.add_argument("--shapes", default=None,
                    help="comma-separated operand shapes, dims joined with "
                         "'x', e.g. 32768x768 or 64x768,262144x768")
    pr.add_argument("--dtype", default="float32",
                    help="operand dtype, or one an operand comma-separated "
                         "(default float32; retrieval_topk: the queries' "
                         "float32 and the corpus's)")
    pr.add_argument("--reps", type=int, default=None,
                    help="timed reps per candidate (default: 7 on the card, "
                         "1 on the CPU)")
    pr.add_argument("--device", default="cuda",
                    help="torch device to measure on (default cuda; 'cpu' "
                         "exercises the path with the plain versions)")
    pr.set_defaults(tune_func=_cmd_run)

    pl = sub.add_parser("ls", help="list tuned entries (no torch import)")
    pl.add_argument("--store", default=default_root())
    pl.add_argument("--json", action="store_true")
    pl.set_defaults(tune_func=_cmd_ls)


def cmd_tune(args) -> int:
    return args.tune_func(args)


def main(argv=None) -> int:
    """``python -m jimm_tpu_torch tune ...`` (``argv[0]`` is ``tune``)."""
    parser = argparse.ArgumentParser(prog="python -m jimm_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    add_tune_parser(sub)
    args = parser.parse_args(argv)
    return cmd_tune(args)


if __name__ == "__main__":
    import sys
    raise SystemExit(main(["tune", *sys.argv[1:]]))
