"""``python -m jimm_tpu_torch aot``: manage the persistent AOT artifact
store; the counterpart of ``jimm_tpu/aot/cli.py``.

Four verbs:

- ``warmup``: build a preset (or its tiny override, or a checkpoint) as
  ``serve`` does and export every serve bucket into the store, so the next
  ``serve --aot-store`` reaches readiness with no bucket run through the
  model's own forward.
- ``ls``: list store entries (fingerprint, size, label).
- ``gc``: evict least-recently-used entries down to a byte cap.
- ``verify``: re-hash every entry; quarantine any that fail integrity or
  format-version checks.

``ls``/``gc``/``verify`` import no torch (host tools, usable on a machine
with no card); ``warmup`` is the one verb that exports. JAX's
``--platform``/``--host-devices`` are the port's ``--device``, as in
``serve``; ``--ln-impl`` is ``serve``'s (it is part of the config the
key hashes).
"""

from __future__ import annotations

import argparse
import json

from jimm_tpu_torch.aot.store import ArtifactStore

__all__ = ["add_aot_parser", "cmd_aot"]


def _human(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def _cmd_warmup(args) -> int:
    # the model is built as `serve` builds it; imported here so that
    # `aot ls` never imports torch
    from jimm_tpu_torch.aot.warmup import warmup_store
    from jimm_tpu_torch.cli import (SERVED_METHOD, load_checkpoint,
                                    serve_devices, serving_model,
                                    tiny_override)
    from jimm_tpu_torch.configs import family, preset, with_runtime
    from jimm_tpu_torch.serve.buckets import BucketTable, default_buckets

    dtype = "bf16" if args.bf16 else "f32"
    device = serve_devices(args.device)[0]
    fam = family(args.preset)
    runtime = {"ln_impl": args.ln_impl} if args.ln_impl else None
    if args.ckpt:
        model, _ = load_checkpoint(fam, args.ckpt, dtype, device, runtime)
        label = f"{fam}:{args.ckpt}"
    else:
        cfg = preset(args.preset)
        if args.tiny:
            cfg = tiny_override(cfg)
        if runtime:
            cfg = with_runtime(cfg, **runtime)
        model, _ = serving_model(cfg, dtype, device)
        label = f"{fam}:{args.preset}" + (":tiny" if args.tiny else "")
    label += f":{dtype}"
    method = SERVED_METHOD[fam]
    buckets = (BucketTable(tuple(int(s) for s in args.buckets.split(",")))
               if args.buckets else default_buckets(device))
    vision = model.config.vision
    size = vision.image_size
    store = ArtifactStore(args.store)
    report = warmup_store(model, method=method, buckets=buckets,
                          item_shape=(size, size, vision.channels),
                          in_dtype="float32", store=store, label=label,
                          force=args.force)
    print(json.dumps({"store": str(store.root), "label": label,
                      "method": method,
                      "buckets": {str(k): v for k, v in report.items()}},
                     indent=2))
    return 0


def _cmd_ls(args) -> int:
    store = ArtifactStore(args.store)
    rows = [e.to_row() for e in store.entries()]
    if args.json:
        print(json.dumps(rows, indent=2, sort_keys=True))
        return 0
    if not rows:
        print(f"(empty store: {store.root})")
        return 0
    for r in sorted(rows, key=lambda r: r["last_used"], reverse=True):
        print(f"{r['fingerprint'][:16]}  {_human(r['size']):>10}  "
              f"bucket={r.get('bucket')}  {r.get('label') or '-'}  "
              f"torch={r.get('torch') or '?'}")
    print(f"total: {len(rows)} entries, {_human(store.total_bytes)}")
    return 0


def _cmd_gc(args) -> int:
    store = ArtifactStore(args.store, max_bytes=args.max_bytes)
    evicted = store.gc()
    print(json.dumps({"evicted": evicted,
                      "remaining_bytes": store.total_bytes,
                      "cap_bytes": store.max_bytes}))
    return 0


def _cmd_verify(args) -> int:
    store = ArtifactStore(args.store)
    problems = store.verify()
    print(json.dumps({"entries": len(store.entries()),
                      "problems": problems}))
    return 1 if problems else 0


def add_aot_parser(subparsers) -> None:
    """Attach the ``aot`` subcommand tree to the main CLI's subparsers."""
    p = subparsers.add_parser(
        "aot", help="manage the persistent AOT artifact store")
    p.set_defaults(func=cmd_aot)
    sub = p.add_subparsers(dest="aot_cmd", required=True)

    pw = sub.add_parser("warmup",
                        help="export every serve bucket for a preset into "
                             "the store")
    pw.add_argument("--preset", required=True)
    pw.add_argument("--store", required=True,
                    help="artifact store root directory")
    pw.add_argument("--ckpt", default=None,
                    help="load weights (an HF checkpoint directory or "
                         "file, --preset naming its family) instead of "
                         "random init; keys ignore weights, so this only "
                         "changes the recorded label")
    pw.add_argument("--tiny", action="store_true",
                    help="shrink the preset to CPU-demo size")
    pw.add_argument("--bf16", action="store_true")
    pw.add_argument("--buckets", default=None,
                    help="comma-separated batch buckets (default: the "
                         "device's table)")
    pw.add_argument("--force", action="store_true",
                    help="export buckets that already have entries again")
    pw.add_argument("--ln-impl", default=None, choices=["xla", "fused"],
                    help="encoder LayerNorm, as serve --ln-impl")
    pw.add_argument("--device", default="cuda",
                    help="torch device the model is built and exported on "
                         "(default cuda; 'cpu' must be asked for)")
    pw.set_defaults(aot_func=_cmd_warmup)

    pl = sub.add_parser("ls", help="list store entries")
    pl.add_argument("--store", required=True)
    pl.add_argument("--json", action="store_true")
    pl.set_defaults(aot_func=_cmd_ls)

    pg = sub.add_parser("gc", help="evict LRU entries down to a byte cap")
    pg.add_argument("--store", required=True)
    pg.add_argument("--max-bytes", type=int, default=None,
                    help="override the store cap for this run")
    pg.set_defaults(aot_func=_cmd_gc)

    pv = sub.add_parser("verify",
                        help="re-hash entries; quarantine failures")
    pv.add_argument("--store", required=True)
    pv.set_defaults(aot_func=_cmd_verify)


def cmd_aot(args) -> int:
    return args.aot_func(args)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m jimm_tpu_torch.aot.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    add_aot_parser(sub)
    args = parser.parse_args(argv)
    return cmd_aot(args)


if __name__ == "__main__":
    raise SystemExit(main())
