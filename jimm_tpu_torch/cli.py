"""Command line: ``python -m jimm_tpu_torch serve``.

Builds a SigLIP model from a preset (randomly initialised from a seeded
generator; checkpoint loading comes with HF IO, ROADMAP.md), puts its
``encode_image`` behind the micro-batching engine and the HTTP front end,
warms every bucket, and prints one JSON ready line with
``"status": "serving"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from jimm_tpu_torch.configs import PRESETS, SigLIPConfig, preset
from jimm_tpu_torch.models.siglip import SigLIP
from jimm_tpu_torch.serve.admission import AdmissionPolicy
from jimm_tpu_torch.serve.buckets import BucketTable, default_buckets
from jimm_tpu_torch.serve.engine import InferenceEngine, image_forward
from jimm_tpu_torch.serve.server import ServingServer

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def tiny_override(cfg: SigLIPConfig) -> SigLIPConfig:
    """Shrink a preset to CPU-demo size, keeping its architecture class
    (the JAX CLI's ``--tiny`` sizes)."""
    return dataclasses.replace(
        cfg,
        vision=dataclasses.replace(cfg.vision, image_size=32, patch_size=16,
                                   width=64, depth=4, num_heads=2,
                                   mlp_dim=128),
        text=dataclasses.replace(cfg.text, vocab_size=64, context_length=8,
                                 width=64, depth=4, num_heads=2, mlp_dim=128),
        projection_dim=64)


def cmd_serve(args: argparse.Namespace) -> int:
    cfg = preset(args.preset)
    if args.tiny:
        cfg = tiny_override(cfg)
    model = SigLIP(cfg, device=args.device, dtype=_DTYPES[args.dtype])
    model.eval()
    param = next(model.parameters())
    size = cfg.vision.image_size
    buckets = (BucketTable(tuple(int(s) for s in args.buckets.split(",")))
               if args.buckets else default_buckets(args.device))
    engine = InferenceEngine(
        image_forward(model), item_shape=(size, size, cfg.vision.channels),
        buckets=buckets, max_delay_ms=args.max_delay_ms,
        policy=AdmissionPolicy(max_queue=args.queue_size,
                               default_timeout_s=args.timeout_s))
    server = ServingServer(engine, host=args.host, port=args.port)
    t0 = time.monotonic()
    server.start()
    ready = {"status": "serving", "host": args.host, "port": server.port,
             "model": f"siglip:{args.preset}" + (":tiny" if args.tiny else ""),
             "device": str(param.device),
             "dtype": str(param.dtype).removeprefix("torch."),
             "buckets": list(buckets.sizes),
             "warmup_s": round(time.monotonic() - t0, 3)}
    print(json.dumps(ready), flush=True)
    if args.max_seconds:
        try:
            time.sleep(args.max_seconds)
        finally:
            server.stop()
    else:
        server.serve_forever()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m jimm_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("serve", help="HTTP micro-batching embedding server")
    sp.add_argument("--preset", default="siglip-base-patch16-256",
                    choices=sorted(PRESETS))
    sp.add_argument("--tiny", action="store_true",
                    help="shrink the preset to CPU-demo size")
    sp.add_argument("--dtype", choices=sorted(_DTYPES), default="f32",
                    help="parameter and compute dtype")
    sp.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000, help="0 = any free port")
    sp.add_argument("--buckets", default=None,
                    help="comma-separated batch buckets (default: the "
                         "device's table)")
    sp.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="coalescing window")
    sp.add_argument("--queue-size", type=int, default=256,
                    help="admission queue bound (503 past it)")
    sp.add_argument("--timeout-s", type=float, default=5.0,
                    help="default request deadline (504 past it)")
    sp.add_argument("--max-seconds", type=float, default=None,
                    help="stop after this long (default: serve until ^C)")
    sp.set_defaults(func=cmd_serve)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
