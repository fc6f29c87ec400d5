"""Command line: ``python -m jimm_tpu_torch serve|train``.

``serve`` loads a local HF checkpoint (``--ckpt DIR --model
vit|clip|siglip``) or builds a preset of any family (randomly initialised
from a seeded generator), puts its image forward (``encode_image`` for CLIP
and SigLIP, the model itself for ViT: logits, or pooled features without a
head) behind the micro-batching engine and the HTTP front end, warms every
bucket, and prints one JSON ready line with ``"status": "serving"``.
``--dtype int8`` builds or loads the model in f32 and swaps every eligible
Linear for a W8A8 ``QuantLinear`` before any forward
(``jimm_tpu_torch.quant``).

``train`` trains a SigLIP preset contrastively on synthetic pairs
(``data/synthetic.py``) with AdamW, clipping and the warmup-cosine schedule
of the JAX package's ``train`` command, printing one JSON metrics line per
logged step and a JSON summary line at the end. With ``--naflex`` the image
side is SigLIP2's variable-resolution NaFlex batches (mixed-aspect synthetic
images as padded patch sequences with a key-padding mask). ``--precision
int8_qk`` runs every attention on the int8-QK flash kernels, ``--precision
fp8_hybrid`` every eligible Linear on the fp8 matmul with delayed scaling
(``jimm_tpu_torch.quant.policy``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from jimm_tpu_torch.configs import (PRESETS, CLIPConfig, SigLIPConfig,
                                    ViTConfig, family, preset, with_runtime)
from jimm_tpu_torch.data.synthetic import (contrastive_pairs,
                                            naflex_contrastive_pairs)
from jimm_tpu_torch.models.clip import CLIP
from jimm_tpu_torch.models.common import resolve_device
from jimm_tpu_torch.models.siglip import SigLIP
from jimm_tpu_torch.models.vit import VisionTransformer
from jimm_tpu_torch.ops.attention import INT8_NO_MASK
from jimm_tpu_torch.quant import quantize_model
from jimm_tpu_torch.quant.policy import POLICIES, apply_precision_policy
from jimm_tpu_torch.serve.admission import AdmissionPolicy
from jimm_tpu_torch.serve.buckets import BucketTable, default_buckets
from jimm_tpu_torch.serve.engine import InferenceEngine, image_forward
from jimm_tpu_torch.serve.server import ServingServer
from jimm_tpu_torch.train.metrics import (MetricsLogger, StepTimer,
                                          device_peak_tflops, mfu,
                                          train_step_flops)
from jimm_tpu_torch.train.trainer import (OptimizerConfig,
                                          make_contrastive_train_step,
                                          make_optimizer)

#: serving dtypes: int8 is the f32 model with its Linears quantized
_SERVE_DTYPES = ("bf16", "f32", "int8")
#: the model class of each family
MODELS = {"vit": VisionTransformer, "clip": CLIP, "siglip": SigLIP}
_FAMILY_OF = {ViTConfig: "vit", CLIPConfig: "clip", SigLIPConfig: "siglip"}
#: the method ``serve`` puts behind /v1/embed: ViT serves its logits (or
#: pooled features without a head), the dual towers their image embedding
SERVED_METHOD = {"vit": "forward", "clip": "encode_image",
                 "siglip": "encode_image"}


def tiny_override(cfg):
    """Shrink a preset of any family to CPU-demo size, keeping its
    architecture class (the JAX CLI's ``--tiny`` sizes)."""
    vision = dataclasses.replace(cfg.vision, image_size=32, patch_size=16,
                                 width=64, depth=4, num_heads=2, mlp_dim=128)
    if isinstance(cfg, ViTConfig):
        return dataclasses.replace(cfg, vision=vision)
    return dataclasses.replace(
        cfg, vision=vision,
        text=dataclasses.replace(cfg.text, vocab_size=64, context_length=8,
                                 width=64, depth=4, num_heads=2, mlp_dim=128),
        projection_dim=64)


def _serving_dtype(dtype: str) -> torch.dtype:
    if dtype not in _SERVE_DTYPES:
        raise ValueError(f"serving dtype {dtype!r} is not one of "
                         f"{_SERVE_DTYPES}")
    return torch.bfloat16 if dtype == "bf16" else torch.float32


def _ready_to_serve(model: torch.nn.Module, dtype: str
                    ) -> tuple[torch.nn.Module, int]:
    model.eval()
    return model, quantize_model(model) if dtype == "int8" else 0


def serving_model(cfg, dtype: str, device,
                  generator: torch.Generator | None = None
                  ) -> tuple[torch.nn.Module, int]:
    """The model ``serve --preset P --dtype DTYPE`` serves (the config's
    family), in eval mode, and the number of Linears quantized: f32 or bf16
    parameters; for ``int8`` the f32 model with every eligible Linear
    swapped for a ``QuantLinear`` before any forward runs, as the JAX
    ``serve`` command quantizes before its warm compiles."""
    model = MODELS[_FAMILY_OF[type(cfg)]](
        cfg, device=device, dtype=_serving_dtype(dtype), generator=generator)
    return _ready_to_serve(model, dtype)


def build_server(args: argparse.Namespace
                 ) -> tuple[ServingServer, torch.nn.Module, dict]:
    """The ``serve`` command up to its ready line: the model built or
    loaded, its engine and HTTP server started (every bucket warmed); the
    server, the model it serves and the ready line's fields. The caller
    stops the server."""
    runtime = {"ln_impl": args.ln_impl} if args.ln_impl else None
    if args.ckpt:
        if not args.model:
            raise SystemExit("--ckpt needs --model vit|clip|siglip")
        if args.tiny:
            raise SystemExit("--tiny shrinks a preset; it does not apply "
                             "to --ckpt")
        fam = args.model
        # int8: loaded in f32, then quantized
        model, quantized = _ready_to_serve(MODELS[fam].from_pretrained(
            args.ckpt, device=args.device, dtype=_serving_dtype(args.dtype),
            runtime=runtime), args.dtype)
        name = f"{fam}:{args.ckpt}"
    else:
        fam = family(args.preset)
        cfg = preset(args.preset)
        if args.tiny:
            cfg = tiny_override(cfg)
        if runtime:
            cfg = with_runtime(cfg, **runtime)
        model, quantized = serving_model(cfg, args.dtype, args.device)
        name = f"{fam}:{args.preset}" + (":tiny" if args.tiny else "")
    param = next(model.parameters())
    vision = model.config.vision
    buckets = (BucketTable(tuple(int(s) for s in args.buckets.split(",")))
               if args.buckets else default_buckets(args.device))
    engine = InferenceEngine(
        image_forward(model, SERVED_METHOD[fam]),
        item_shape=(vision.image_size, vision.image_size, vision.channels),
        buckets=buckets, max_delay_ms=args.max_delay_ms,
        policy=AdmissionPolicy(max_queue=args.queue_size,
                               default_timeout_s=args.timeout_s))
    server = ServingServer(engine, host=args.host, port=args.port)
    t0 = time.monotonic()
    server.start()
    ready = {"status": "serving", "host": args.host, "port": server.port,
             "model": name, "device": str(param.device),
             "dtype": ("int8" if args.dtype == "int8"
                       else str(param.dtype).removeprefix("torch.")),
             "quantized_layers": quantized,
             "buckets": list(buckets.sizes),
             "warmup_s": round(time.monotonic() - t0, 3)}
    return server, model, ready


def cmd_serve(args: argparse.Namespace) -> int:
    server, _, ready = build_server(args)
    print(json.dumps(ready), flush=True)
    if args.max_seconds:
        try:
            time.sleep(args.max_seconds)
        finally:
            server.stop()
    else:
        server.serve_forever()
    return 0


#: train flags of the JAX CLI that the port does not have yet -> where the
#: ROADMAP queues them
_TRAIN_NOT_PORTED = {
    "data": "file datasets, ROADMAP.md queue 1, item 7 (data)",
    "ckpt_dir": "checkpoints, ROADMAP.md queue 1, item 4",
    "resume": "checkpoints, ROADMAP.md queue 1, item 4",
    "mesh": "device meshes, ROADMAP.md queue 1, item 6 (parallelism)",
    "remat": "remat policies, ROADMAP.md queue 1, item 3 (training, rest)",
    "dropout": "dropout, ROADMAP.md queue 1, item 3 (training, rest)",
}


def naflex_to_device(triple, device: torch.device, dtype: torch.dtype
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A NaFlex ``(patches, spatial_shapes, mask)`` numpy triple on the
    device: patches in the model dtype, shapes int, mask bool."""
    patches, shapes, mask = triple
    return (torch.from_numpy(patches).to(device, dtype),
            torch.from_numpy(shapes).to(device, torch.long),
            torch.from_numpy(mask).to(device, torch.bool))


def cmd_train(args: argparse.Namespace) -> int:
    for flag, where in _TRAIN_NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet: "
                             f"{where}")
    if args.naflex and not args.preset.startswith("siglip"):
        raise SystemExit("--naflex trains SigLIP2-style models; "
                         "use a siglip preset")
    if args.naflex and (args.precision == "int8_qk"
                        or args.attn_impl == "flash_int8"):
        raise SystemExit(f"--naflex batches need a key-padding mask: "
                         f"{INT8_NO_MASK}")
    device = resolve_device(args.device)
    cfg = preset(args.preset)
    if args.tiny:
        cfg = tiny_override(cfg)
    runtime = {"attn_impl": args.attn_impl, "ln_impl": args.ln_impl,
               "fused_qkv": args.fused_qkv, "precision": args.precision}
    if args.attn_impl == "flash_masked":
        # only the NaFlex vision tower has a mask; the text tower takes the
        # unmasked kernels
        if not args.naflex:
            raise SystemExit("--attn-impl flash_masked needs --naflex (the "
                             "fixed-resolution towers have no mask)")
        runtime.update(attn_impl=None, vision={"attn_impl": "flash_masked"},
                       text={"attn_impl": "flash"})
    cfg = with_runtime(cfg, **{k: v for k, v in runtime.items() if v})
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = SigLIP(cfg, device=device, dtype=dtype,
                   generator=torch.Generator(device=device).manual_seed(
                       args.seed))
    model.train()
    # the precision policy's surgery, before the optimizer is built (as the
    # JAX train command orders it)
    precision = cfg.vision.precision
    rewritten = apply_precision_policy(model, precision)
    optimizer = make_optimizer(model, OptimizerConfig(
        learning_rate=args.lr, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, total_steps=args.steps))
    step_fn = make_contrastive_train_step(args.loss)
    if args.naflex:
        data = naflex_contrastive_pairs(
            args.batch_size, patch_size=cfg.vision.patch_size,
            max_num_patches=cfg.vision.num_patches,
            seq_len=cfg.text.context_length, vocab_size=cfg.text.vocab_size,
            seed=args.seed)
    else:
        data = contrastive_pairs(args.batch_size,
                                 image_size=cfg.vision.image_size,
                                 vocab_size=cfg.text.vocab_size,
                                 seq_len=cfg.text.context_length,
                                 seed=args.seed)
    logger = MetricsLogger(path=args.metrics_file,
                           print_every=args.log_every)
    timer = StepTimer()
    peak = device_peak_tflops(device)
    flops = train_step_flops(cfg, args.batch_size)
    loss = dt = None
    try:
        for step in range(args.steps):
            images, text = next(data)
            images = (naflex_to_device(images, device, dtype) if args.naflex
                      else torch.from_numpy(images).to(device, dtype))
            text = torch.from_numpy(text).to(device, torch.long)
            timer.start()
            metrics = step_fn(model, optimizer, images, text)
            # logit_scale depends on the update just made
            dt = timer.stop(metrics["loss"], model.logit_scale)
            loss = float(metrics["loss"])
            logger.log(step, loss=loss, step_time_s=dt,
                       lr=optimizer.schedule(step),
                       images_per_s=args.batch_size / dt,
                       mfu=mfu(flops, dt, peak))
    finally:
        logger.close()
    print(json.dumps({
        "status": "trained", "steps": args.steps, "loss": loss,
        "step_time_s": dt, "model": f"siglip:{args.preset}"
        + (":tiny" if args.tiny else ""), "naflex": args.naflex,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "dtype": str(dtype).removeprefix("torch."),
        "precision": precision, "precision_modules": rewritten,
        "train_step_flops": flops, "mfu_last_step": mfu(flops, dt, peak)}),
        flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m jimm_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("serve", help="HTTP micro-batching embedding server")
    sp.add_argument("--ckpt", default=None,
                    help="a local HF checkpoint directory or file (needs "
                         "--model); hub names are not ported")
    sp.add_argument("--model", default=None, choices=sorted(MODELS),
                    help="model family of --ckpt")
    sp.add_argument("--preset", default="siglip-base-patch16-256",
                    choices=sorted(PRESETS),
                    help="random-init a preset of any family (when no "
                         "--ckpt)")
    sp.add_argument("--tiny", action="store_true",
                    help="shrink the preset to CPU-demo size")
    sp.add_argument("--dtype", choices=_SERVE_DTYPES, default="f32",
                    help="parameter and compute dtype; int8 = f32 with every "
                         "eligible Linear as a W8A8 QuantLinear")
    sp.add_argument("--ln-impl", default=None, choices=["xla", "fused"],
                    help="encoder LayerNorm (fused = the LayerNorm kernels)")
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

    sp = sub.add_parser("train", help="contrastive training on synthetic "
                                      "pairs (offline)")
    sp.add_argument("--preset", default="siglip-base-patch16-256",
                    choices=sorted(n for n in PRESETS
                                   if family(n) == "siglip"))
    sp.add_argument("--tiny", action="store_true",
                    help="shrink the preset to CPU-demo size")
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--weight-decay", type=float, default=1e-4)
    sp.add_argument("--warmup-steps", type=int, default=0)
    sp.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the synthetic data")
    sp.add_argument("--bf16", action="store_true",
                    help="bf16 parameters and compute (default f32)")
    sp.add_argument("--loss", default="siglip", choices=["siglip", "clip"])
    sp.add_argument("--naflex", action="store_true",
                    help="variable-resolution SigLIP2 training: NaFlex "
                         "(patches, shapes, mask) batches of synthetic "
                         "mixed-aspect images instead of square images")
    sp.add_argument("--attn-impl", default=None,
                    choices=["auto", "xla", "flash", "flash_masked",
                             "flash_int8"],
                    help="attention for both towers (auto = flash on CUDA; "
                         "flash takes the masked kernels where there is a "
                         "key-padding mask; flash_masked = the masked "
                         "kernels for the NaFlex vision tower, needs "
                         "--naflex; flash_int8 = int8-QK flash, forward and "
                         "backward)")
    sp.add_argument("--ln-impl", default=None, choices=["xla", "fused"],
                    help="encoder LayerNorm (fused = the LayerNorm kernels)")
    sp.add_argument("--fused-qkv", action="store_true",
                    help="q/k/v as one (H, 3H) matmul")
    sp.add_argument("--precision", default=None, choices=POLICIES,
                    help="training precision policy: bf16 (as built), "
                         "fp8_hybrid (eligible Linears matmul in e4m3 "
                         "forward / e5m2 gradients, delayed scaling), "
                         "int8_qk (every attention on the int8-QK flash "
                         "kernels)")
    sp.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    sp.add_argument("--log-every", type=int, default=10)
    sp.add_argument("--metrics-file", default=None,
                    help="JSONL metrics output path")
    # the JAX CLI's flags that are not ported yet: accepted, then refused
    # with their ROADMAP queue
    sp.add_argument("--data", default=None, help=argparse.SUPPRESS)
    sp.add_argument("--ckpt-dir", default=None, help=argparse.SUPPRESS)
    sp.add_argument("--resume", action="store_true", help=argparse.SUPPRESS)
    sp.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    sp.add_argument("--remat", default=None, help=argparse.SUPPRESS)
    sp.add_argument("--dropout", type=float, default=None,
                    help=argparse.SUPPRESS)
    sp.set_defaults(func=cmd_train)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
