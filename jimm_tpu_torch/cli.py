"""Command line: ``python -m jimm_tpu_torch
serve|train|supervise|classify|evaluate|export-run|prepare-data|
build-native|profile-analyze|obs``.

``serve`` loads an HF checkpoint (``--ckpt DIR --model
vit|clip|siglip``) or builds a preset of any family (randomly initialised
from a seeded generator), puts its image forward (``encode_image`` for CLIP
and SigLIP, the model itself for ViT: logits, or pooled features without a
head) behind the micro-batching engine and the HTTP front end, warms every
bucket, and prints one JSON ready line with ``"status": "serving"``.
``--replicas R`` partitions the ``--device`` list (a card may be listed more
than once) into R replicas, each with its own model copy, stream and
executor, balanced behind the one queue; ``--model-parallel k`` and
``--seq-parallel s`` make each replica ``k * s`` devices wide (an in-process
mesh: the model sliced Megatron-style over ``model``, the tokens over
``seq``; ``serve/topology.py``); ``--self-heal`` rebuilds and replans
around a fenced replica. ``--qos-policy FILE`` turns on tenant QoS (token
buckets, quotas, weighted-fair classes, class-ordered shedding; the
policy's ``slo`` section feeds the burn-rate engine) and ``--pool-model
NAME=PRESET[@DTYPE]`` makes more models resident over the same plan,
routed by ``X-Jimm-Model``; ``qos ls|validate`` reads policy files. The
server also answers ``/metrics``, ``/debug/traces`` and ``POST
/admin/revive``.
``--dtype int8`` builds or loads the model in f32 and swaps every eligible
Linear for a W8A8 ``QuantLinear`` before any forward
(``jimm_tpu_torch.quant``). A CLIP or SigLIP server also answers
``/v1/classify`` (zero-shot scores; the class weights cached per label
set).

``train`` trains a preset of any family, or fine-tunes a checkpoint
(``--from-pretrained``), on synthetic data (``data/synthetic.py``) with
AdamW, clipping and the warmup-cosine schedule of the JAX package's
``train`` command: a ViT as a cross-entropy classifier on the blob task
(temporal presets on clips), CLIP and SigLIP contrastively on pairs,
optionally with per-block remat (``--remat``) and a bf16 first moment
(``--moment-dtype bf16``). It prints one JSON metrics line per logged step
and a JSON summary line at the end, with the run's goodput breakdown. With
``--naflex`` the image side is SigLIP2's variable-resolution NaFlex batches
(mixed-aspect synthetic images as padded patch sequences with a
key-padding mask). ``--precision int8_qk`` runs every attention on the
int8-QK flash kernels, ``--precision fp8_hybrid`` every eligible Linear on
the fp8 matmul with delayed scaling (``jimm_tpu_torch.quant.policy``).
``--ckpt-dir`` checkpoints the run (``train/checkpoint.py``) and
``--resume`` continues it; ``--inject-faults`` and ``--preemption-save``
are the resilience drills. ``supervise -- train ...`` reruns a failed or
preempted run with ``--resume`` (``jimm_tpu_torch.resilience``);
``--elastic`` replans its data axis between attempts from the ranks
available (``--shrink-plan`` caps them, ``train --max-devices`` trains
on the first ranks), ``--adapt`` tunes the next attempt's knobs from its
goodput.

``train --data SHARDS`` reads TFRecord or tar shards instead
(``--loader records``, buffer-shuffled, or ``--loader grain``, the indexed
multi-worker loader whose position each checkpoint records), the batches
made and copied to the card ahead of the step (``data/pipeline.py``).
``build-native`` builds the native host-preprocessing library.

``classify`` scores one image against a label set with a CLIP or SigLIP
checkpoint (zero-shot); ``evaluate`` runs one pass over TFRecord or
WebDataset shards (ViT top-1, CLIP/SigLIP in-batch retrieval R@1, or
zero-shot top-1 from a token table) with an HF checkpoint or a training
run's (``--preset --ckpt-dir``); ``export-run`` writes a training run out
as an HF checkpoint; ``prepare-data`` writes TFRecord shards from image
files.

Observability: ``train --profile-dir D`` writes a ``torch.profiler`` trace
of steps 2-4, which ``profile-analyze D`` tabulates; ``train --prof-ring
R`` keeps a byte-bounded ring of step-window captures; ``train
--tensorboard-dir T`` writes TensorBoard scalars; ``serve --prof-dir P``
keeps a capture ring that ``POST /admin/prof/trigger`` fills, and samples
the ``jimm_hbm_*`` device-memory gauges; ``obs`` reads metric dumps,
journals and captures (``jimm_tpu_torch.obs.cli``).
"""
from __future__ import annotations

import argparse
import base64
import dataclasses
import hashlib
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from jimm_tpu_torch import obs
from jimm_tpu_torch.configs import (PRESETS, CLIPConfig, SigLIPConfig,
                                    ViTConfig, family, parse_remat, preset,
                                    validate_pipeline, with_runtime)
from jimm_tpu_torch.data import native, records, webdataset
from jimm_tpu_torch.data.clip_tokenizer import CLIPTokenizer
from jimm_tpu_torch.data.grain_pipeline import (CheckpointableGrainStream,
                                                make_grain_loader)
from jimm_tpu_torch.data.naflex import patchify_naflex
from jimm_tpu_torch.data.pipeline import PrefetchIterator, place
from jimm_tpu_torch.data.preprocess import (CLIP_MEAN, CLIP_STD, SIGLIP_MEAN,
                                            SIGLIP_STD, preprocess_batch,
                                            to_float_normalized)
from jimm_tpu_torch.data.synthetic import (blob_classification, shard_rows,
                                            contrastive_pairs,
                                            naflex_contrastive_pairs)
from jimm_tpu_torch.data.tfrecord import TFRecordWriter, encode_example
from jimm_tpu_torch.models.clip import CLIP
from jimm_tpu_torch.models.common import resolve_device
from jimm_tpu_torch.models.siglip import SigLIP
from jimm_tpu_torch.models.vit import VisionTransformer
from jimm_tpu_torch.obs.cli import add_obs_parser
from jimm_tpu_torch.obs.prof.capture import configure_capture
from jimm_tpu_torch.obs.prof.memory import MemoryMonitor, module_bytes
from jimm_tpu_torch.obs.prof.opstats import (capture_summary,
                                             load_trace_events,
                                             render_summary)
from jimm_tpu_torch.obs.slo import SloEngine
from jimm_tpu_torch.ops.attention import INT8_NO_MASK
from jimm_tpu_torch.parallel import comm
from jimm_tpu_torch.parallel.mesh import (check_max_devices,
                                          initialize_distributed,
                                          local_device, make_mesh,
                                          mesh_shape, mesh_sizes,
                                          outcome_group,
                                          planned_world_size,
                                          shutdown_distributed)
from jimm_tpu_torch.parallel.sharding import (PRESET_RULES, ShardingRules,
                                              fsdp_mesh, shard_model,
                                              use_sharding)
from jimm_tpu_torch.quant import quantize_model
from jimm_tpu_torch.quant.policy import POLICIES, apply_precision_policy
from jimm_tpu_torch.resilience import (BackoffPolicy, FaultPlan, GiveUpError,
                                       GoodputAdvisor, PreemptedError,
                                       PreemptionGuard, PreemptionHandler,
                                       Supervisor, plan_data_axis)
from jimm_tpu_torch.serve.admission import AdmissionPolicy
from jimm_tpu_torch.serve.buckets import BucketTable, default_buckets
from jimm_tpu_torch.serve.engine import InferenceEngine, image_forward
from jimm_tpu_torch.serve.cache import (EmbeddingCache, class_embedding_cache,
                                        prompt_set_key)
from jimm_tpu_torch.serve.qos import ModelPool, QosScheduler, load_policy
from jimm_tpu_torch.serve.qos.cli import add_qos_parser
from jimm_tpu_torch.serve.server import ServingServer, ZeroShotService
from jimm_tpu_torch.serve.topology import (build_replica_forwards,
                                           plan_topology, visible_devices)
from jimm_tpu_torch.train.checkpoint import (CheckpointManager,
                                              CheckpointMismatchError)
from jimm_tpu_torch.train.metrics import (MetricsLogger, StepTimer,
                                          device_peak_tflops, mfu,
                                          train_step_flops)
from jimm_tpu_torch.train.profile import annotate, op_stats, summarize, trace
from jimm_tpu_torch.train.trainer import (OptimizerConfig,
                                          make_classifier_train_step,
                                          make_contrastive_train_step,
                                          make_optimizer)
from jimm_tpu_torch.utils.zero_shot import (TEMPLATES, expand_templates,
                                            token_table_rows,
                                            weights_from_rows,
                                            zero_shot_logits_from_features)

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


#: the bucket tables' names of the serving dtypes
_BUCKET_DTYPES = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}


def parse_pool_model(spec: str) -> tuple[str, str, str]:
    """One ``--pool-model NAME=PRESET[@DTYPE]`` as ``(name, preset,
    dtype)``; DTYPE defaults to f32 (the JAX CLI's parser and words)."""
    name, sep, rest = spec.partition("=")
    if not sep or not name or not rest:
        raise SystemExit(f"--pool-model {spec!r}: expected "
                         "NAME=PRESET[@DTYPE]")
    if name == "default":
        raise SystemExit("--pool-model: 'default' names the primary model; "
                         "pick another name")
    preset_name, _, dtype = rest.partition("@")
    dtype = dtype or "f32"
    if dtype not in ("f32", "bf16", "int8"):
        raise SystemExit(f"--pool-model {spec!r}: dtype must be "
                         "f32|bf16|int8")
    return name, preset_name, dtype


def serve_dtype(args: argparse.Namespace) -> str:
    """The serving precision from ``--dtype`` or the legacy ``--bf16``."""
    if args.bf16 and args.dtype not in (None, "bf16"):
        raise SystemExit(f"--bf16 conflicts with --dtype {args.dtype}")
    return args.dtype or ("bf16" if args.bf16 else "f32")


def serve_devices(spec: str) -> list[torch.device]:
    """The devices of ``serve --device``: a comma-separated list in which a
    device may stand more than once (``cuda:0,cuda:0``: two replicas on one
    card); plain ``cuda`` lists each visible card once."""
    names = [n.strip() for n in spec.split(",") if n.strip()]
    if not names:
        raise SystemExit(f"--device {spec!r} names no device")
    if names == ["cuda"]:
        resolve_device("cuda")  # raises without CUDA
        return visible_devices()
    return [resolve_device(n) for n in names]


def build_server(args: argparse.Namespace
                 ) -> tuple[ServingServer, torch.nn.Module, dict]:
    """The ``serve`` command up to its ready line: the model built or
    loaded, its replicas (``--replicas``, each ``--model-parallel *
    --seq-parallel`` devices wide) and engine, the QoS scheduler and the
    model pool, the HTTP server started (every bucket warmed on every
    replica of every model); the server, the default model and the ready
    line's fields. The caller stops the server."""
    runtime = {"ln_impl": args.ln_impl} if args.ln_impl else None
    dtype = serve_dtype(args)
    if dtype == "int8" and args.model_parallel > 1:
        raise SystemExit("--dtype int8 does not support --model-parallel > 1 "
                         "yet (QuantLinear params carry no logical sharding "
                         "axes); use data replicas")
    plan = plan_topology(args.replicas, args.model_parallel,
                         args.seq_parallel, devices=serve_devices(args.device))
    if args.self_heal and plan.is_trivial:
        raise SystemExit("--self-heal needs a replica topology "
                         "(--replicas/--model-parallel > 1): a single lane "
                         "has nothing to replan around")
    if args.journal:
        obs.configure_journal(args.journal)
    device = plan.device_groups[0][0]
    if args.ckpt:
        if not args.model:
            raise SystemExit("--ckpt needs --model vit|clip|siglip")
        if args.tiny:
            raise SystemExit("--tiny shrinks a preset; it does not apply "
                             "to --ckpt")
        fam = args.model
        # int8: loaded in f32, then quantized
        model, quantized = _ready_to_serve(MODELS[fam].from_pretrained(
            args.ckpt, device=device, dtype=_serving_dtype(dtype),
            runtime=runtime), dtype)
        name = f"{fam}:{args.ckpt}"
    else:
        fam = family(args.preset)
        cfg = preset(args.preset)
        if args.tiny:
            cfg = tiny_override(cfg)
        if runtime:
            cfg = with_runtime(cfg, **runtime)
        model, quantized = serving_model(cfg, dtype, device)
        name = f"{fam}:{args.preset}" + (":tiny" if args.tiny else "")
    param = next(model.parameters())
    vision = model.config.vision
    method = SERVED_METHOD[fam]
    zero_shot = (ZeroShotService(model, model_key=f"{name}:{dtype}")
                 if fam in ("clip", "siglip") else None)
    buckets = (BucketTable(tuple(int(s) for s in args.buckets.split(",")),
                           dtype=_BUCKET_DTYPES[dtype])
               if args.buckets
               else default_buckets(device, dtype=_BUCKET_DTYPES[dtype]))

    def build_forward(mdl: torch.nn.Module, mdl_method: str):
        # the trivial plan serves the model itself; replicas get their own
        # copies (sliced, for a replica wider than one device), streams and
        # executors
        if plan.is_trivial:
            return image_forward(mdl, mdl_method)
        return build_replica_forwards(mdl, plan, method=mdl_method)

    policy = AdmissionPolicy(max_queue=args.queue_size,
                             default_timeout_s=args.timeout_s,
                             shed_fraction=args.shed_fraction)
    # tenant admission and weighted-fair classes; without a policy the
    # engine keeps its single FIFO
    qos = QosScheduler(load_policy(args.qos_policy)) if args.qos_policy \
        else None
    engine = InferenceEngine(
        build_forward(model, method),
        item_shape=(vision.image_size, vision.image_size, vision.channels),
        buckets=buckets, max_delay_ms=args.max_delay_ms, policy=policy,
        qos=qos)
    if qos is not None and qos.registry.slo:
        # the policy's slo section: per-tenant burn rates; a fast burn
        # escalates into the self-heal path and degrades /healthz
        engine.attach_slo(SloEngine.from_objective_dicts(qos.registry.slo))
    if args.self_heal:
        # fence -> probe/revive -> rebuild the replica set over the same
        # plan and replan around the dead lane
        engine.set_heal(lambda: build_forward(model, method))
    pool, pool_models = None, [model]
    if args.pool_model:
        # more resident models, each built as the default one is over the
        # same plan, with its own engine behind the same metrics and QoS
        # scheduler; requests name one with X-Jimm-Model
        engines = {"default": engine}
        for spec in args.pool_model:
            pname, ppreset, pdtype = parse_pool_model(spec)
            if pname in engines:
                raise SystemExit(f"--pool-model: duplicate name {pname!r}")
            if pdtype == "int8" and args.model_parallel > 1:
                raise SystemExit(
                    f"--pool-model {pname}: int8 does not support "
                    "--model-parallel > 1 (same constraint as --dtype "
                    "int8); use data replicas")
            pfam = family(ppreset)
            pcfg = preset(ppreset)
            if args.tiny:
                pcfg = tiny_override(pcfg)
            if runtime:
                pcfg = with_runtime(pcfg, **runtime)
            pmodel, _ = serving_model(pcfg, pdtype, device)
            pvision = pmodel.config.vision
            engines[pname] = InferenceEngine(
                build_forward(pmodel, SERVED_METHOD[pfam]),
                item_shape=(pvision.image_size, pvision.image_size,
                            pvision.channels),
                buckets=BucketTable(buckets.sizes,
                                    dtype=_BUCKET_DTYPES[pdtype]),
                max_delay_ms=args.max_delay_ms, policy=policy,
                metrics=engine.metrics, qos=qos)
            pool_models.append(pmodel)
        pool = ModelPool(engines, default="default")
        # each engine bound queue_depth_now to its own queue (the last
        # wins): the default model's again
        engine.metrics.bind_gauge(
            "queue_depth_now", lambda: float(engine._queue.qsize())
            if engine._queue is not None else 0.0)
    capture = monitor = None
    if args.prof_dir:
        # the capture ring (heal, replan and SLO-burn incidents and POST
        # /admin/prof/trigger deep-capture onto their cids) and the
        # device-memory gauges: every resident model and every replica or
        # position copy of it under model_pool, the trace ring under
        # serve_buffers
        capture = configure_capture(args.prof_dir)
        monitor = MemoryMonitor()

        def model_pool_bytes() -> float:
            models = {id(m): m for m in pool_models}
            for eng in (pool.engines() if pool is not None else [engine]):
                for fwd in eng.forwards:
                    for m in getattr(fwd, "models", [getattr(fwd, "model",
                                                             None)]):
                        if m is not None:
                            models[id(m)] = m
            return float(sum(module_bytes(m) for m in models.values()))

        monitor.register_subsystem("model_pool", model_pool_bytes)
        monitor.register_subsystem("serve_buffers",
                                   lambda: float(engine.traces_bytes))
        monitor.sample()
        monitor.start()
    logger = (MetricsLogger(path=args.metrics_file, print_every=10**9)
              if args.metrics_file else None)
    server = ServingServer(engine, host=args.host, port=args.port,
                           zero_shot=zero_shot, pool=pool, capture=capture,
                           monitor=monitor, metrics_logger=logger,
                           metrics_log_every_s=args.metrics_every_s)
    t0 = time.monotonic()
    server.start()
    ready = {"status": "serving", "host": args.host, "port": server.port,
             "model": name, "device": str(param.device),
             "dtype": ("int8" if dtype == "int8"
                       else str(param.dtype).removeprefix("torch.")),
             "quantized_layers": quantized,
             "buckets": list(buckets.sizes),
             "zero_shot": zero_shot is not None,
             "warmup_s": round(time.monotonic() - t0, 3)}
    if qos is not None:
        ready["qos"] = {"policy": args.qos_policy,
                        "classes": list(qos.registry.class_order),
                        "tenants": sorted(qos.registry.tenants)}
        if qos.registry.slo:
            ready["qos"]["slo"] = sorted(qos.registry.slo)
    if pool is not None:
        ready["models"] = pool.describe()
    if not plan.is_trivial:
        ready["topology"] = plan.describe()
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


#: the train command's sharding rules, the JAX CLI's choices
#: (``hybrid_fsdp_tp`` is library API, as in JAX)
TRAIN_RULES = ("replicated", "dp", "tp", "fsdp", "fsdp_tp", "sp", "fsdp_sp",
               "pp")
#: the counters supervise reports on its ``resilience:`` line (the
#: reference's set), and those --elastic and --adapt add
RESILIENCE_KEYS = ("jimm_train_restarts_total", "jimm_train_preemptions_total",
                   "jimm_train_checkpoint_quarantined_total",
                   "jimm_train_goodput_lost_work_seconds_total",
                   "jimm_train_goodput_preemption_save_seconds_total")
ELASTIC_KEYS = ("jimm_train_topology_changes_total",
                "jimm_train_checkpoint_topology_changes_total")
ADAPT_KEYS = ("jimm_train_goodput_advisor_decisions_total",)
#: a mesh attempt's outcomes, agreed over every rank as their max
ATTEMPT_OK, ATTEMPT_PREEMPTED, ATTEMPT_FAILED = 0, 1, 2


def fit_head(model: VisionTransformer, n: int | None) -> bool:
    """Make a loaded ViT's classifier match the task, as the JAX CLI's
    ``_fit_head`` does: a fresh zero-initialised ``n``-wide head when the
    count differs or the checkpoint has none (returns True); an error when
    it has none and no count is known."""
    cfg = model.config
    if n and (not cfg.do_classification or n != cfg.num_classes):
        like = model.vision.pos_embed
        model.classifier = torch.nn.Linear(cfg.vision.width, n,
                                           device=like.device,
                                           dtype=like.dtype)
        with torch.no_grad():
            model.classifier.weight.zero_()
            model.classifier.bias.zero_()
        model.config = dataclasses.replace(cfg, num_classes=n,
                                           do_classification=True)
        return True
    if not cfg.do_classification:
        raise SystemExit("checkpoint has no classifier head; pass "
                         "--num-classes")
    return False


def remat_name(cfg) -> str:
    """The ``--remat`` spec a tower config runs: none, full or the save set."""
    if not cfg.remat:
        return "none"
    return "full" if cfg.remat_policy == "none" else cfg.remat_policy


#: a ViT's classes on the synthetic data, unless --num-classes says
SYNTHETIC_CLASSES = 4


def run_spec(args: argparse.Namespace, fam: str,
             num_classes: int | None = None, synthetic: bool = True) -> dict:
    """The architecture of a run of family ``fam``, as ``train``'s flags
    give it and as its checkpoint directory records it (``run.json``): the
    preset [shrunk by ``--tiny``], or the ``--from-pretrained`` checkpoint
    at ``--image-size``; a ViT's head ``--num-classes`` wide, else
    ``num_classes`` (a dataset's classes.json), else the synthetic data's,
    else (a file dataset without classes.json: ``synthetic`` false) the
    preset's or the checkpoint's own."""
    n = None
    if fam == "vit":
        n = args.num_classes or num_classes or (
            SYNTHETIC_CLASSES if synthetic else None)
    return {"family": fam, "preset": args.preset, "tiny": bool(args.tiny),
            "from_pretrained": args.from_pretrained,
            "image_size": args.image_size, "num_classes": n}


def build_run_model(spec: dict, device: torch.device, dtype: torch.dtype,
                    runtime: dict | None, seed: int = 0):
    """The model of the architecture ``spec`` (:func:`run_spec`): a seeded
    preset, or the pretrained checkpoint with a ViT's head fitted to the
    classes; and whether a fresh head was fitted. ``train`` builds its
    model here, and :func:`restore_run` rebuilds a run's."""
    fam, n = spec["family"], spec["num_classes"]
    if spec["from_pretrained"]:
        model = MODELS[fam].from_pretrained(
            spec["from_pretrained"], device=device, dtype=dtype,
            runtime=runtime or None, image_size=spec["image_size"])
        return model, fam == "vit" and fit_head(model, n)
    cfg = preset(spec["preset"])
    if spec["tiny"]:
        cfg = tiny_override(cfg)
    if runtime:
        cfg = with_runtime(cfg, **runtime)
    if n:
        cfg = dataclasses.replace(cfg, num_classes=n)
    model = MODELS[fam](cfg, device=device, dtype=dtype,
                        generator=torch.Generator(device=device).manual_seed(
                            seed))
    return model, False


def _leaves(batch) -> Iterator[np.ndarray]:
    if isinstance(batch, (tuple, list)):
        for item in batch:
            yield from _leaves(item)
    else:
        yield np.asarray(batch)


def batch_fingerprint(batch) -> int:
    """48-bit content hash of a host batch (nested tuples of numpy arrays),
    the reference's ``_batch_fingerprint``: SHA-1 over each array's bytes
    in order, as the reference hashes its batch after ``jnp.asarray``
    (64-bit values as 32-bit ones). Equal fingerprints at equal steps
    between a resumed run and an uninterrupted one prove the resume
    replayed and skipped no batch; 48 bits survive a float64 metrics path
    exactly."""
    h = hashlib.sha1()
    for a in _leaves(batch):
        if a.dtype.itemsize == 8 and a.dtype.kind in "iuf":
            a = a.astype(a.dtype.str.replace("8", "4"))
        h.update(a.tobytes())
    return int(h.hexdigest()[:12], 16)


def _fault_plan(args: argparse.Namespace) -> FaultPlan | None:
    """The ``--inject-faults`` plan (``--fake-failure-at-step N`` is sugar
    for ``crash@N``), with the reference's refusals."""
    spec = args.inject_faults or ""
    if args.fake_failure_at_step is not None:
        crash = f"crash@{args.fake_failure_at_step}"
        spec = f"{spec},{crash}" if spec else crash
    plan = None
    if spec:
        try:
            plan = FaultPlan.parse(spec)
        except ValueError as e:
            raise SystemExit(f"--inject-faults: {e}")
        if plan.needs("corrupt") and not args.ckpt_dir:
            raise SystemExit("--inject-faults: corrupt@STEP needs --ckpt-dir")
    if args.preemption_save and not args.ckpt_dir:
        raise SystemExit("--preemption-save needs --ckpt-dir")
    return plan


def _check_data_flags(args: argparse.Namespace) -> None:
    """The reference's refusals of ``--data`` combinations."""
    if args.naflex and (args.loader == "grain" or _is_tar_data(args.data)):
        raise SystemExit("--naflex reads tfrecord shards (records loader) "
                         "or synthetic data")
    if args.loader == "grain" and _is_tar_data(args.data):
        raise SystemExit("--loader grain reads tfrecord shards; tar "
                         "(webdataset) data uses --loader records")


def _synthetic_data(args: argparse.Namespace, fam: str, cfg, start_step: int,
                    shard: tuple[int, int]) -> Iterator:
    """The synthetic stream of the run, its first ``start_step`` batches
    skipped: the same draws, no image built. ``shard``: ``(index, count)``,
    this rank's contiguous rows of every global batch."""
    index, count = shard
    if fam == "vit":
        data = shard_rows(blob_classification(
            args.batch_size, image_size=cfg.vision.image_size,
            num_classes=cfg.num_classes, seed=args.seed,
            num_frames=cfg.vision.num_frames), index, count)
    elif args.naflex:
        data = naflex_contrastive_pairs(
            args.batch_size, patch_size=cfg.vision.patch_size,
            max_num_patches=cfg.vision.num_patches,
            seq_len=cfg.text.context_length,
            vocab_size=cfg.text.vocab_size, seed=args.seed,
            shard_index=index, shard_count=count)
    else:
        data = contrastive_pairs(args.batch_size,
                                 image_size=cfg.vision.image_size,
                                 vocab_size=cfg.text.vocab_size,
                                 seq_len=cfg.text.context_length,
                                 seed=args.seed, shard_index=index,
                                 shard_count=count)
    with obs.span("resume_fast_forward"):
        data.skip(start_step)
    return data


def _records_data(args: argparse.Namespace, fam: str, cfg, start_step: int,
                  shard: tuple[int, int]) -> Iterator:
    """``--loader records``: TFRecord or tar shards, buffer-shuffled,
    repeating; the example stream fast-forwarded past the ``start_step``
    batches already trained on (protobuf or tar entries only, no decode).
    ``shard``: ``(index, count)``, this rank taking every count-th example
    into batches of ``batch_size / count``."""
    index, count = shard
    batch = args.batch_size // count
    kw = dict(shuffle_buffer=args.shuffle_buffer, seed=args.seed,
              shard_index=index, shard_count=count)
    if _is_tar_data(args.data):
        examples = webdataset.iter_wds_examples(
            webdataset.resolve_tar_paths(args.data), **kw)
    else:
        examples = records.iter_examples(records.resolve_paths(args.data),
                                         **kw)
    with obs.span("resume_fast_forward"):
        records.skip(examples, start_step * batch)
    norm = _norm_for(fam)
    if fam == "vit":
        return records.classification_batches_from(
            examples, batch, image_size=cfg.vision.image_size, **norm)
    if args.naflex:
        return records.naflex_image_text_batches_from(
            examples, batch, patch_size=cfg.vision.patch_size,
            max_num_patches=cfg.vision.num_patches,
            seq_len=cfg.text.context_length, **norm)
    return records.image_text_batches_from(
        examples, batch, image_size=cfg.vision.image_size,
        seq_len=cfg.text.context_length, **norm)


def _grain_data(args: argparse.Namespace, fam: str, cfg, start_step: int,
                ckpt: CheckpointManager | None, shard: tuple[int, int]
                ) -> CheckpointableGrainStream:
    """``--loader grain``: the indexed loader, shuffled by index each epoch,
    with ``--data-workers`` worker processes; on a resume it jumps to the
    checkpoint's ``grain_state`` (decoding nothing), or without one replays
    ``start_step`` batches. ``shard``: ``(index, count)``, this rank's
    records in batches of ``batch_size / count``."""
    task = "classification" if fam == "vit" else "contrastive"
    extra = ({"seq_len": cfg.text.context_length}
             if task == "contrastive" else {})
    index, count = shard
    loader = make_grain_loader(
        args.data, args.batch_size // count, task=task,
        image_size=cfg.vision.image_size, seed=args.seed,
        worker_count=args.data_workers, shard_index=index,
        shard_count=count, **_norm_for(fam), **extra)
    it = iter(loader)
    saved = (ckpt.last_restored_extra.get("grain_state")
             if ckpt is not None else None)
    with obs.span("resume_fast_forward"):
        if start_step and saved:
            # the state saved with the last batch the loop consumed (not
            # the prefetcher's read-ahead): the very next batch follows
            it.set_state(base64.b64decode(saved))
        else:
            for _ in range(start_step):
                next(it)
    # the workers fork here, from the main thread, before the prefetch
    # thread starts
    return CheckpointableGrainStream(it.start())


def train_data(args: argparse.Namespace, fam: str, cfg, start_step: int,
               ckpt: CheckpointManager | None,
               shard: tuple[int, int] = (0, 1)
               ) -> tuple[Iterator, CheckpointableGrainStream | None]:
    """The run's host batches from ``start_step`` on, as the reference
    routes them: no ``--data``, the synthetic generator; TFRecord or tar
    shards through the records readers; ``--loader grain``, the indexed
    loader, whose consumed-state tracker comes second. ``shard``:
    ``(index, count)``, the rows of this rank on a mesh (JAX's
    ``process_index`` / ``process_count``)."""
    if not args.data:
        return _synthetic_data(args, fam, cfg, start_step, shard), None
    if args.loader == "grain":
        stream = _grain_data(args, fam, cfg, start_step, ckpt, shard)
        return stream.batches(), stream
    return _records_data(args, fam, cfg, start_step, shard), None


def parse_mesh(spec: str, max_devices: int | None = None) -> dict[str, int]:
    """``"data=4,seq=2"`` -> ``{"data": 4, "seq": 2}``, checked against the
    ranks the run has (``mesh.planned_world_size``), or the first
    ``max_devices`` of them, with the JAX CLI's range check, before any
    group is made."""
    axes = {}
    for part in spec.split(","):
        name, sep, size = part.partition("=")
        if not sep or not size.strip().lstrip("-").isdigit():
            raise SystemExit(f"--mesh {spec!r}: expected axis=size,...")
        axes[name.strip()] = int(size)
    n = planned_world_size()
    try:
        if max_devices is not None:
            check_max_devices(max_devices, n)
            n = max_devices
    except ValueError as e:
        raise SystemExit(str(e)) from None
    try:
        return mesh_sizes(axes, n)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec!r}: {e}") from None


@dataclasses.dataclass
class TrainMesh:
    """A ``train --mesh`` run's layout, as the JAX CLI derives it: the mesh,
    the rules (``--rules``, default ``dp``; the batch re-sharded over the
    pair axis of a ring loss on a seq axis), the loss and its axis, and this
    rank's shard of every global batch."""

    mesh: DeviceMesh
    rules: ShardingRules
    loss: str | None
    loss_axis: str | tuple[str, ...]
    shard_index: int
    shard_count: int
    #: this process made the group (and leaves it at the end)
    owns_group: bool
    #: the towers' pipeline fields under --rules pp
    runtime: dict
    #: this rank is one of the mesh's (--max-devices leaves the others
    #: out: they take no step and wait for the attempt's outcome)
    active: bool = True

    @property
    def rank(self) -> int:
        return torch.distributed.get_rank()

    def agree(self, *values: int, mesh_only: bool = True) -> list[int]:
        """The largest of the ranks' ``values``, elementwise: over the
        mesh's ranks, or over every rank of the group (the ranks
        --max-devices left out too), on the outcome group, whose
        collective waits out an attempt of any length."""
        if mesh_only:
            grp = comm.axis_group(tuple(self.mesh.mesh_dim_names), self.mesh)
            device = (local_device()
                      if torch.distributed.get_backend() == "nccl" else "cpu")
        else:
            grp, device = outcome_group(), "cpu"
        t = torch.tensor(values, dtype=torch.int64, device=device)
        return comm.all_reduce_max_(t, grp).tolist()


def train_mesh(args: argparse.Namespace, fam: str) -> TrainMesh:
    """Join the run's process group and lay out its mesh
    (``jimm_tpu/cli.py``'s choices: ring losses by default on a mesh with a
    data or seq axis, their axis ``("data", "seq")`` when seq > 1). With
    ``--max-devices k`` the mesh is over ranks ``0..k-1``: every rank makes
    its groups (FSDP2's included), and the others are left inactive."""
    axes = parse_mesh(args.mesh, args.max_devices)
    name = args.rules or "dp"
    rules = PRESET_RULES[name]
    loss, loss_axis = args.loss, "data"
    if fam != "vit":
        ring_ok = "data" in axes or axes.get("seq", 1) > 1
        loss = loss or (f"{fam}_ring" if ring_ok else fam)
        if loss.endswith("_ring") and axes.get("seq", 1) > 1:
            # the seq axis joins the pair ring: the contrastive batch
            # shards over ("data", "seq") combined
            loss_axis = tuple(a for a in ("data", "seq") if a in axes)
            rules = dataclasses.replace(rules, batch=loss_axis)
    # every axis the batch (or the ring) runs over is checked here, before
    # any group is made
    needed = comm.axis_names(rules.batch)
    if loss is not None and loss.endswith("_ring"):
        needed += comm.axis_names(loss_axis)
    for axis in needed:
        if axis not in axes:
            with_loss = f" with --loss {loss}" if loss else ""
            raise SystemExit(f"--mesh {args.mesh}: --rules {name}{with_loss}"
                             f" shards the batch over a {axis!r} axis, which "
                             f"the mesh lacks")
    count = math.prod(axes[a] for a in comm.axis_names(rules.batch))
    if args.batch_size % count:
        raise SystemExit(f"--batch-size {args.batch_size} not divisible by "
                         f"the {count} ranks the batch shards over")
    runtime = pipeline_runtime(args, axes)
    owns = not torch.distributed.is_initialized()
    initialize_distributed(device=args.device)
    mesh = make_mesh(axes, max_devices=args.max_devices)
    if args.max_devices is not None and "data" in axes:
        # FSDP2's mesh makes groups too: every rank, before any step
        fsdp_mesh(mesh)
    # a mesh over ranks 0..k-1 has no coordinate for the others
    active = mesh.get_coordinate() is not None
    index = 0
    if active and rules.batch is not None:
        index = comm.axis_group(rules.batch, mesh).index
    return TrainMesh(mesh, rules, loss, loss_axis, index, count, owns,
                     runtime, active)


def check_pipeline_flags(args: argparse.Namespace) -> None:
    """The JAX CLI's refusals of the pipeline flags without ``--rules
    pp``."""
    if args.pipeline_virtual > 1 and args.rules != "pp":
        raise SystemExit("--pipeline-virtual needs --rules pp")
    if args.pipeline_microbatches:
        if args.pipeline_microbatches < 1:
            raise SystemExit("--pipeline-microbatches must be >= 1")
        if args.rules != "pp":
            raise SystemExit("--pipeline-microbatches needs --rules pp "
                             "(layers sharded over the 'stage' mesh axis)")


def pipeline_runtime(args: argparse.Namespace, axes: dict[str, int]
                     ) -> dict:
    """Under ``--rules pp``, the towers' pipeline fields (the config's 4
    microbatches unless ``--pipeline-microbatches`` says otherwise;
    ``--pipeline-virtual`` with the mesh's stage count), checked against
    the preset's towers and this rank's batch before any group is made,
    with the JAX CLI's messages; nothing otherwise."""
    if args.rules != "pp":
        return {}
    runtime: dict = {"pipeline": True}
    if args.pipeline_virtual > 1:
        runtime.update(pp_virtual=args.pipeline_virtual,
                       pp_stages=axes.get("stage", 0))
    if args.pipeline_microbatches:
        runtime["pp_microbatches"] = args.pipeline_microbatches
    data = axes.get("data", 1)
    if args.batch_size % data:
        raise SystemExit(f"--batch-size {args.batch_size} is not "
                         f"divisible by the data mesh axis ({data})")
    if not args.from_pretrained:
        cfg = preset(args.preset)
        cfg = with_runtime(tiny_override(cfg) if args.tiny else cfg,
                           **runtime)
        validate_pipeline_towers(cfg, axes, args.batch_size // data)
    return runtime


def validate_pipeline_towers(cfg, axes: dict[str, int],
                             local_batch: int) -> None:
    """``validate_pipeline`` on each tower of ``cfg`` over ``axes``."""
    try:
        for tname in ("vision", "text"):
            tower = getattr(cfg, tname, None)
            if tower is not None:
                validate_pipeline(tower, n_stages=axes.get("stage", 0),
                                  local_batch=local_batch, tower_name=tname)
    except ValueError as e:
        raise SystemExit(f"pipeline config: {e}") from None


def cmd_train(args: argparse.Namespace) -> int:
    check_pipeline_flags(args)
    if args.rules and not args.mesh:
        raise SystemExit("--rules needs --mesh")
    if args.loss and args.loss.endswith("_ring") and not args.mesh:
        raise SystemExit(f"--loss {args.loss} needs --mesh (a ring over the "
                         f"batch's data or seq axis)")
    if args.naflex and args.rules == "pp":
        raise SystemExit("--naflex needs attention masks, which the "
                         "pipelined path does not support yet")
    if args.journal:
        obs.configure_journal(args.journal)
    fam = family(args.preset)
    if args.naflex and fam != "siglip":
        raise SystemExit("--naflex trains SigLIP2-style models; "
                         "use a siglip preset")
    if args.naflex and (args.precision == "int8_qk"
                        or args.attn_impl == "flash_int8"):
        raise SystemExit(f"--naflex batches need a key-padding mask: "
                         f"{INT8_NO_MASK}")
    if args.tiny and args.from_pretrained:
        raise SystemExit("--tiny conflicts with --from-pretrained (the "
                         "checkpoint defines the architecture)")
    if args.data:
        _check_data_flags(args)
    fault_plan = _fault_plan(args)
    if not args.mesh:
        return _train(args, fam, fault_plan, None)
    par = train_mesh(args, fam)
    try:
        return _mesh_attempt(args, fam, fault_plan, par)
    finally:
        if par.owns_group:
            shutdown_distributed()


def _mesh_attempt(args: argparse.Namespace, fam: str,
                  fault_plan: FaultPlan | None, par: TrainMesh) -> int:
    """``train`` on a mesh as one attempt whose outcome every rank agrees
    on: the mesh's ranks train (the others, left out by --max-devices, wait),
    then all join one all-reduce of the outcome (done, preempted, failed;
    the worst wins), so that every rank returns or raises alike and a
    supervisor on each restarts or stops them together."""
    code, step, err = ATTEMPT_OK, -1, None
    try:
        if par.active:
            with use_sharding(par.mesh, par.rules):
                _train(args, fam, fault_plan, par)
    except PreemptedError as e:
        code, step, err = ATTEMPT_PREEMPTED, e.step, e
    except BaseException as e:  # noqa: BLE001 -- agreed, then raised
        code, err = ATTEMPT_FAILED, e
    agreed, step = par.agree(code, step, mesh_only=False)
    if err is not None and code == agreed:
        raise err
    if agreed == ATTEMPT_PREEMPTED:
        raise PreemptedError(step) from err
    if agreed == ATTEMPT_FAILED:
        raise RuntimeError("the attempt failed on another rank") from err
    return 0


def _train(args: argparse.Namespace, fam: str,
           fault_plan: FaultPlan | None, par: TrainMesh | None) -> int:
    """``train``'s run, on a mesh when ``par`` says so (under its ambient
    sharding): every rank trains its shard of each batch, rank 0 alone
    logs, prints and writes."""
    device = local_device() if par is not None else resolve_device(
        args.device)
    lead = par is None or par.rank == 0
    runtime = {"attn_impl": args.attn_impl, "ln_impl": args.ln_impl,
               "fused_qkv": args.fused_qkv, "precision": args.precision}
    if args.scan_unroll >= 1:
        # any explicit value is the config's (0, auto, picks no value off
        # a TPU); it changes nothing in the port's loop over the blocks
        runtime["scan_unroll"] = args.scan_unroll
    if args.remat:
        try:
            runtime.update(parse_remat(args.remat))
        except ValueError as e:
            raise SystemExit(f"--remat: {e}")
    if args.attn_impl == "flash_masked":
        # only the NaFlex vision tower has a mask; the text tower takes the
        # unmasked kernels
        if not args.naflex:
            raise SystemExit("--attn-impl flash_masked needs --naflex (the "
                             "fixed-resolution towers have no mask)")
        runtime.update(attn_impl=None, vision={"attn_impl": "flash_masked"},
                       text={"attn_impl": "flash"})
    runtime = {k: v for k, v in runtime.items() if v}
    if par is not None:
        runtime.update(par.runtime)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    # --moment-dtype wins over --bf16-momentum
    moment_dtype = ({"f32": "float32", "bf16": "bfloat16"}[args.moment_dtype]
                    if args.moment_dtype
                    else ("bfloat16" if args.bf16_momentum else None))
    spec = run_spec(args, fam, _num_classes_from_data(args.data)
                    if fam == "vit" and args.data else None,
                    synthetic=not args.data)
    ckpt = None
    if args.ckpt_dir:
        # a run's directory records its architecture and dtypes: another
        # run's flags are refused before any step is read
        try:
            ckpt = CheckpointManager(
                args.ckpt_dir, save_interval_steps=args.save_every,
                run={**spec, "dtype": str(dtype).removeprefix("torch."),
                     "moment_dtype": moment_dtype or "param"},
                mesh=None if par is None else par.mesh, writer=lead)
        except CheckpointMismatchError as e:
            raise SystemExit(f"--ckpt-dir: {e}") from None
    model, fresh_head = build_run_model(spec, device, dtype, runtime,
                                        args.seed)
    cfg = model.config
    if par is not None and par.runtime and args.from_pretrained:
        # the checkpoint gave the towers' depths
        validate_pipeline_towers(cfg, mesh_shape(par.mesh),
                                 args.batch_size // par.shard_count)
    model.train()
    # the precision policy's surgery, before the optimizer is built (as the
    # JAX train command orders it)
    precision = cfg.vision.precision
    rewritten = apply_precision_policy(model, precision)
    if par is not None:
        # every rank built the same seeded model: laid out over the mesh
        try:
            shard_model(model, par.mesh, par.rules)
        except (NotImplementedError, ValueError) as e:
            raise SystemExit(f"--rules: {e}") from None
    optimizer = make_optimizer(model, OptimizerConfig(
        learning_rate=args.lr, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, total_steps=args.steps,
        moment_dtype=moment_dtype))
    start_step = 0
    if ckpt is not None and args.resume:
        had = ckpt.completed_steps()
        try:
            start_step = ckpt.restore(model, optimizer) + 1
        except CheckpointMismatchError as e:
            raise SystemExit(f"--resume: {e}") from None
        except FileNotFoundError:
            if had:
                # every step was quarantined: starting over at 0 would
                # silently drop the run's progress
                raise SystemExit(
                    f"--resume: no step of {args.ckpt_dir} restores (steps "
                    f"{had} were quarantined to "
                    f"{ckpt.directory / '.quarantine'}); refusing to train "
                    f"from step 0") from None
    if fam == "vit":
        step_fn = make_classifier_train_step()
        # the classifier's bias is among the last parameters updated
        sync = model.classifier.bias
    else:
        if par is None:
            step_fn = make_contrastive_train_step(args.loss or fam)
        else:
            step_fn = make_contrastive_train_step(
                par.loss, mesh=par.mesh, axis_name=par.loss_axis)
        # logit_scale depends on the update just made
        sync = model.logit_scale
    # a resumed step sees the batch the uninterrupted run saw at that step;
    # on a mesh, this rank's rows of it
    shard = (0, 1) if par is None else (par.shard_index, par.shard_count)
    source, grain_stream = train_data(args, fam, cfg, start_step, ckpt,
                                      shard)
    logger = MetricsLogger(path=args.metrics_file if lead else None,
                           print_every=args.log_every if lead else 0,
                           tensorboard_dir=(args.tensorboard_dir if lead
                                            else None),
                           registry=obs.get_registry("jimm_train"))
    timer = StepTimer()
    peak = device_peak_tflops(device)
    flops = train_step_flops(cfg, args.batch_size)
    # every region of the loop in a goodput bucket: the closing line
    # decomposes the wall time
    acct = obs.GoodputAccounter()
    # SIGTERM sets a flag the loop polls; the handler turns it into a
    # grace-window save and a resumable PreemptedError
    guard = preempt = None
    if args.preemption_save:
        guard = PreemptionGuard().install()
        # on a mesh a signal to any rank preempts them all at one step: the
        # flag is agreed at every step's end (one all-reduce)
        agree = None if par is None else (
            lambda flag: bool(par.agree(int(flag))[0]))
        preempt = PreemptionHandler(guard, ckpt, grace_steps=args.grace_steps,
                                    accounter=acct, agree=agree)
    # on a mesh every rank profiles itself into a folder of its own
    profile_dir, ring_dir = args.profile_dir, args.prof_ring
    if par is not None:
        profile_dir, ring_dir = (
            None if d is None else str(Path(d) / f"rank{par.rank}")
            for d in (profile_dir, ring_dir))
    # the profiling ring: short step-window captures kept in a byte budget
    # (process-global, so incident paths can deep-capture into it)
    prof_ring = None
    if ring_dir:
        prof_ring = configure_capture(
            ring_dir, max_ring_bytes=args.prof_ring_bytes,
            every_steps=args.prof_every, window_steps=args.prof_window)
    # --profile-dir traces steps start+2 .. start+4 (past the warm-up
    # step), clamped to the run as the reference clamps it; the profiler's
    # start and stop run outside every goodput region, so their time is the
    # report's residual "other", never "step"
    profile_start = min(start_step + 2, max(args.steps - 1, start_step))
    profile_stop = min(start_step + 4, args.steps - 1)
    profiler_ctx = profiled = None
    loss = dt = accuracy = None
    # host batches made and copied to the card ahead of the step
    prefetch = PrefetchIterator(source, device=device, dtype=dtype)
    # advance the loader's consumed state on this (consumer) side of the
    # prefetch queue, so that a checkpoint records the trained-on position
    data = prefetch if grain_stream is None else grain_stream.track(prefetch)
    try:
        for step in range(start_step, args.steps):
            if prof_ring is not None:
                prof_ring.on_step(step)
            if profile_dir and step == profile_start:
                if prof_ring is not None:
                    # one profiler session at a time: commit a live window
                    prof_ring.flush()
                profiler_ctx = trace(profile_dir)
                profiler_ctx.__enter__()
            with acct.measure("data_wait"):
                batch, (images, target) = next(data)
            # from the host arrays, outside the buckets, as the reference
            fp = batch_fingerprint(batch) if args.batch_fingerprint else None
            # the first step run warms up (kernel loads, library handles):
            # the "compile" bucket, as the reference books its trace
            # the step's range in a trace (a profiler's breakdown of the
            # step leaves the input wait out)
            with acct.measure("compile" if step == start_step else "step"), \
                    annotate("train_step"):
                timer.start()
                metrics = step_fn(model, optimizer, images, target)
                dt = timer.stop(metrics["loss"], sync.reshape(-1)[0])
            if profiler_ctx is not None and step == profile_stop:
                profiler_ctx.__exit__(None, None, None)
                profiler_ctx = None
                profiled = [profile_start, profile_stop]
            with acct.measure("host_sync"):
                loss = float(metrics["loss"])
                extra = {}
                if "accuracy" in metrics:
                    accuracy = extra["accuracy"] = float(metrics["accuracy"])
                if fp is not None:
                    extra["batch_fingerprint"] = fp
                logger.log(step, loss=loss, **extra, step_time_s=dt,
                           lr=optimizer.schedule(step),
                           images_per_s=args.batch_size / dt,
                           mfu=mfu(flops, dt, peak))
            # --scan-unroll is recorded with each step, never compared: a
            # resume may change it (supervise --adapt does)
            extra = {"scan_unroll": args.scan_unroll}
            if ckpt is not None and grain_stream is not None:
                extra["grain_state"] = base64.b64encode(
                    grain_stream.consumed_state).decode("ascii")
            saved_now = False
            if ckpt is not None and (preempt is None
                                     or not preempt.draining):
                # while the grace save drains, later saves are pointless:
                # nothing after it survives the restart
                with acct.measure("checkpoint"):
                    saved_now = ckpt.save(step, model, optimizer,
                                          extra=extra)
            if fault_plan is not None:
                # a preempt's SIGTERM lands before the guard check below,
                # as a real maintenance signal would
                fault_plan.fire(step, ckpt=ckpt,
                                rank=0 if par is None else par.rank)
            if preempt is not None:
                preempt.after_step(step, model, optimizer, extra=extra,
                                   already_saved=saved_now)
    finally:
        prefetch.close()
        if grain_stream is not None:
            grain_stream.close()
        if guard is not None:
            guard.uninstall()
        if profiler_ctx is not None:
            # a crash mid-profile still writes what was captured
            profiler_ctx.__exit__(None, None, None)
        if prof_ring is not None:
            # commit a half-open window: the newest capture survives a crash
            prof_ring.close()
        logger.close()
        if ckpt is not None:
            # a failed attempt's write in flight finishes (and is marked)
            # before a supervised restart opens the directory again
            ckpt.close()
    if not lead:
        return 0
    name = (f"{fam}:{args.from_pretrained}" if args.from_pretrained
            else f"{fam}:{args.preset}" + (":tiny" if args.tiny else ""))
    last_mfu = None if dt is None else mfu(flops, dt, peak)
    print(json.dumps({
        "status": "trained", "steps": args.steps, "start_step": start_step,
        "loss": loss, "accuracy": accuracy, "step_time_s": dt, "model": name,
        "family": fam, "naflex": args.naflex, "data": args.data,
        "loader": args.loader if args.data else "synthetic",
        "num_classes": cfg.num_classes if fam == "vit" else None,
        "fresh_head": fresh_head, "num_frames": cfg.vision.num_frames,
        "remat": remat_name(cfg.vision), "dropout": cfg.vision.dropout,
        "moment_dtype": moment_dtype or "param",
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "dtype": str(dtype).removeprefix("torch."),
        "precision": precision, "precision_modules": rewritten,
        "train_step_flops": flops, "mfu_last_step": last_mfu,
        "profile_dir": args.profile_dir, "profiled_steps": profiled,
        "mesh": None if par is None else mesh_shape(par.mesh),
        "rules": None if par is None else (args.rules or "dp"),
        "loss_kind": (None if fam == "vit" else
                      par.loss if par is not None else args.loss or fam),
        "backend": (None if par is None
                    else torch.distributed.get_backend()),
        "goodput": acct.report(mfu=last_mfu)}),
        flush=True)
    return 0


def _argv_flag_value(argv: list[str], flag: str, default):
    """The value of ``flag`` in ``argv``, the last occurrence winning as in
    argparse; the JAX CLI's."""
    value = default
    for i, tok in enumerate(argv):
        if tok == flag and i + 1 < len(argv):
            value = argv[i + 1]
        elif tok.startswith(flag + "="):
            value = tok.split("=", 1)[1]
    return value


def _shrink_plan(args: argparse.Namespace) -> list[int] | None:
    """``--shrink-plan``'s device budgets, with the JAX CLI's checks."""
    if not args.shrink_plan:
        return None
    if not args.elastic:
        raise SystemExit("--shrink-plan is an --elastic drill knob")
    try:
        plan = [int(x) for x in args.shrink_plan.split(",")]
    except ValueError:
        raise SystemExit(f"--shrink-plan {args.shrink_plan!r}: expected "
                         "comma-separated device counts, e.g. 8,4") from None
    if any(n < 1 for n in plan):
        raise SystemExit("--shrink-plan device counts must be >= 1")
    return plan


def cmd_supervise(args: argparse.Namespace) -> int:
    """Run ``train`` as restartable attempts, in this process (one metric
    registry, so restarts and lost work add up across attempts): a
    preemption (the grace-window save's PreemptedError) or a crash restarts
    the command with ``--resume`` after a bounded jittered backoff, up to
    ``--max-restarts`` times, then gives up. Prints one ``resilience:``
    line with the counters.

    ``--elastic`` replans the mesh before every attempt from the ranks
    available (``--shrink-plan`` caps them per attempt, a drill of lost
    hosts): ``--mesh data=K --rules dp --max-devices K`` is appended to
    the train command, and the restart restores its checkpoint onto the
    smaller mesh. ``--adapt`` runs a :class:`GoodputAdvisor` over each
    attempt's goodput and appends its knobs (checkpoint cadence, grace
    steps, scan unroll) to the next attempt.

    Under ``torch.distributed.run`` every rank runs this same supervisor:
    the group is made here, once, each attempt's outcome is agreed over it
    (``train``'s), and the advisor sees rank 0's goodput on every rank, so
    every rank restarts or stops with the same flags."""
    if args.journal:
        obs.configure_journal(args.journal)
    cmd = list(args.train_args or [])
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd or cmd[0] != "train":
        raise SystemExit("supervise wraps the train subcommand: python -m "
                         "jimm_tpu_torch supervise [options] -- train ...")
    if "--ckpt-dir" not in cmd:
        raise SystemExit("supervise needs --ckpt-dir in the train command "
                         "(restarts resume from checkpoints)")
    if "--preemption-save" not in cmd:
        cmd.append("--preemption-save")
    shrink_plan = _shrink_plan(args)
    advisor = None
    if args.adapt:
        # the knobs start from the train command's own flags
        advisor = GoodputAdvisor(knobs={
            "save_every": int(_argv_flag_value(cmd, "--save-every", 50)),
            "grace_steps": int(_argv_flag_value(cmd, "--grace-steps", 1)),
            "scan_unroll": int(_argv_flag_value(cmd, "--scan-unroll", 0)),
        })
    sup = Supervisor(max_restarts=args.max_restarts,
                     backoff=BackoffPolicy(base_s=args.backoff_base_s,
                                           max_s=args.backoff_max_s,
                                           jitter=0.5, seed=args.seed))
    owns = (not torch.distributed.is_initialized()
            and planned_world_size() > 1)
    if owns:
        initialize_distributed(
            device=build_parser().parse_args(cmd).device)
    lead = (not torch.distributed.is_initialized()
            or torch.distributed.get_rank() == 0)
    # threaded through the attempts: the previous attempt's data axis (to
    # count replans) and the goodput already booked (the advisor reads
    # per-attempt deltas)
    state: dict = {"last_k": None, "booked": {}}

    def observe_goodput(i: int, t0: float) -> None:
        snap = obs.snapshot()
        prefix = "jimm_train_goodput_"
        deltas = {}
        for key, value in snap.items():
            if key.startswith(prefix) and key.endswith("_seconds_total"):
                bucket = key[len(prefix):-len("_seconds_total")]
                deltas[bucket] = value - state["booked"].get(key, 0.0)
                state["booked"][key] = value
        seen = [deltas, time.monotonic() - t0]
        if torch.distributed.is_initialized():
            # rank 0 trained in every attempt: its goodput is the run's,
            # and every rank's advisor decides from it alike
            torch.distributed.broadcast_object_list(seen, src=0)
        advisor.observe(i, seen[1], seen[0])

    def attempt(i: int, resume: bool) -> int:
        argv = list(cmd)
        if resume and "--resume" not in argv:
            argv.append("--resume")
        if args.elastic:
            avail = planned_world_size()
            if shrink_plan is not None:
                avail = min(avail, shrink_plan[min(i, len(shrink_plan) - 1)])
            batch = int(_argv_flag_value(argv, "--batch-size", 32))
            k = plan_data_axis(avail, batch)
            # after the user's flags: argparse's last one wins
            argv += ["--mesh", f"data={k}", "--rules", "dp",
                     "--max-devices", str(k)]
            if state["last_k"] is not None and k != state["last_k"]:
                obs.get_registry("jimm_train").counter(
                    "topology_changes_total").inc()
                obs.get_journal().emit("mesh_replanned", attempt=i + 1,
                                       data_from=state["last_k"],
                                       data_to=k, devices=avail)
                if lead:
                    print(f"[supervise] attempt {i + 1}: replanned mesh "
                          f"data={state['last_k']} -> data={k} ({avail} "
                          f"devices available)", flush=True)
            state["last_k"] = k
        if advisor is not None:
            argv += advisor.argv_overrides()
        t0 = time.monotonic()
        try:
            ns = build_parser().parse_args(argv)
            return ns.func(ns)
        finally:
            if advisor is not None:
                observe_goodput(i, t0)

    try:
        try:
            rc = sup.run(attempt)
        except GiveUpError as e:
            print(f"supervise: {e}", file=sys.stderr)
            return 1
        keys = RESILIENCE_KEYS + (ELASTIC_KEYS if args.elastic else ()) + (
            ADAPT_KEYS if advisor is not None else ())
        snap = obs.snapshot()
        if lead:
            print("resilience: " + json.dumps({k: snap.get(k, 0.0)
                                               for k in keys}), flush=True)
        return rc
    finally:
        if owns:
            shutdown_distributed()


def restore_run(args: argparse.Namespace) -> tuple[str, torch.nn.Module]:
    """Rebuild the architecture a training run used and restore the newest
    good checkpoint of ``--ckpt-dir`` over it, on ``--device`` in the dtype
    ``--bf16`` asks for (the saved parameters cast to it, as orbax casts);
    the reference's ``_restore_run``, shared by ``evaluate`` and
    ``export-run``. The architecture is the run's record (``run.json``,
    which ``train`` writes): ``--preset``, ``--tiny``, ``--from-pretrained``,
    ``--image-size`` and ``--num-classes`` may be left out, and one given
    must agree with it. Without a record the flags give it, as
    :func:`run_spec` reads them (a ViT's head from classes.json next to
    ``--data`` when ``--num-classes`` is left out). A checkpoint that does
    not fit is refused, and no step of the run is touched."""
    try:
        fam = family(args.preset)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.tiny and args.from_pretrained:
        raise SystemExit("--tiny conflicts with --from-pretrained "
                         "(the checkpoint defines the architecture)")
    ckpt = CheckpointManager(args.ckpt_dir)
    if ckpt.run is None:
        data = getattr(args, "data", None)
        classes = _dataset_classes(data) if data and fam == "vit" else None
        spec = run_spec(args, fam, len(classes) if classes else None)
    else:
        spec = {k: ckpt.run[k] for k in run_spec(args, fam)}
        given = {"family": fam, "preset": args.preset,
                 "tiny": args.tiny or None,
                 "from_pretrained": args.from_pretrained,
                 "image_size": args.image_size,
                 "num_classes": args.num_classes}
        clash = [f"{k} {v!r} (the run's: {spec[k]!r})"
                 for k, v in given.items() if v is not None and v != spec[k]]
        if clash:
            raise SystemExit(f"{args.ckpt_dir} holds a run of another "
                             f"architecture: {', '.join(clash)}")
    runtime = {"ln_impl": args.ln_impl} if getattr(args, "ln_impl",
                                                   None) else None
    model, _ = build_run_model(spec, resolve_device(args.device),
                               _model_dtype(args.bf16), runtime)
    try:
        step = ckpt.restore(model, cast=True)
    except CheckpointMismatchError as e:
        raise SystemExit(f"{args.ckpt_dir}: {e}") from None
    print(f"restored step {step} from {args.ckpt_dir}", flush=True)
    return fam, model


def cmd_export_run(args: argparse.Namespace) -> int:
    """Export a training run's checkpoint as an HF checkpoint directory
    (``model.safetensors`` + ``config.json``), which loads back through
    ``from_pretrained`` in both packages and in transformers."""
    _, model = restore_run(args)
    if args.flavor != "auto" and not isinstance(model, SigLIP):
        raise SystemExit("--flavor applies to SigLIP models only")
    if args.flavor == "auto":
        model.save_pretrained(args.out)
    else:
        model.save_pretrained(args.out, flavor=args.flavor)
    print(f"exported {args.ckpt_dir} -> {args.out}", flush=True)
    return 0


# -- file datasets, zero-shot classification, evaluation ----------------------

#: options of the JAX commands that need parts the port does not have yet ->
#: where the ROADMAP queues them
_INDEX_NOT_PORTED = ("--index is not ported yet: the retrieval vector store, "
                     "ROADMAP.md queue 1, item 9 (retrieval)")



def _model_dtype(bf16: bool) -> torch.dtype:
    return torch.bfloat16 if bf16 else torch.float32


def _load(fam: str, args: argparse.Namespace) -> torch.nn.Module:
    """``--ckpt`` of family ``fam`` on ``--device`` in eval mode, bf16 with
    ``--bf16``, the encoder LayerNorms by ``--ln-impl``."""
    runtime = {"ln_impl": args.ln_impl} if args.ln_impl else None
    model = MODELS[fam].from_pretrained(
        args.ckpt, device=args.device, dtype=_model_dtype(args.bf16),
        runtime=runtime)
    return model.eval()


def _norm_for(fam: str) -> dict:
    """Family-correct file-pipeline normalization (HF processor
    conventions): CLIP's mean/std; ViT/SigLIP use the 0.5 defaults."""
    if fam == "clip":
        return {"mean": CLIP_MEAN, "std": CLIP_STD}
    return {}


def _is_tar_data(data: str) -> bool:
    """Route --data to the webdataset loader when it names tar shards
    (compressed .tar.gz/.tar.zst included)."""
    p = Path(data)
    if p.is_dir():
        return (not any(p.glob("*.tfrecord*"))) and any(p.glob("*.tar*"))
    return ".tar" in p.name


def _dataset_classes(data: str) -> list[str] | None:
    """Ordered class names from the classes.json prepare-data writes next
    to the shards (index == label id) — resolved by the container's own
    path rules (tfrecord or tar), so every --data form (dir, glob, file)
    works for both formats."""
    resolve = (webdataset.resolve_tar_paths if _is_tar_data(data)
               else records.resolve_paths)
    try:
        cj = Path(resolve(data)[0]).parent / "classes.json"
    except FileNotFoundError:
        return None  # the loader itself will raise with the right message
    if cj.is_file():
        return list(json.loads(cj.read_text()))
    return None


def _num_classes_from_data(data: str) -> int | None:
    """A dataset's class count from its classes.json, if it has one."""
    classes = _dataset_classes(data)
    return None if classes is None else len(classes)


def _classification_batches(data: str):
    return (webdataset.wds_classification_batches if _is_tar_data(data)
            else records.classification_batches)


def _prompt_rows(args: argparse.Namespace, context_length: int
                 ) -> tuple[list[str], np.ndarray, list[int]]:
    """``classify``'s label set as padded token rows: (labels, (N, L) rows,
    the class of each row)."""
    if args.tokens_file:
        if args.ensemble:
            raise SystemExit("--ensemble builds prompts from templates; it "
                             "needs --labels (+ a tokenizer), not "
                             "--tokens-file")
        table = json.loads(Path(args.tokens_file).read_text())
        labels = list(table)
        rows = [table[k] for k in labels]
        for k, r in table.items():
            if len(r) > context_length:
                # silent truncation could drop the EOT token CLIP pools at
                raise SystemExit(
                    f"tokens for {k!r} are {len(r)} ids but the checkpoint's "
                    f"context_length is {context_length}; re-tokenize to fit")
    else:
        if not args.labels:
            raise SystemExit("need --labels (with --tokenizer or a CLIP "
                             "checkpoint dir holding vocab.json/merges.txt), "
                             "or --tokens-file")
        labels = [s.strip() for s in args.labels.split(",") if s.strip()]
        if args.ensemble:
            # CLIP-paper recipe: average each class over prompt templates;
            # an explicit --template supplies the set ("|"-separated), else
            # the builtin 7-template subset
            templates = (tuple(t for t in args.template.split("|") if t)
                         if args.template else TEMPLATES)
            prompts = expand_templates(labels, templates)
        else:
            template = args.template or "a photo of a {}"
            prompts = [template.format(label) for label in labels]
        rows = None
        if not args.tokenizer and args.model == "clip":
            # every HF CLIP checkpoint ships its BPE vocabulary: the
            # built-in tokenizer when the files are local
            p = Path(args.ckpt)
            d = p if p.is_dir() else p.parent
            if (d / "vocab.json").is_file() and (d / "merges.txt").is_file():
                rows = CLIPTokenizer.from_dir(d)(
                    prompts, context_length=context_length)
        if rows is None:
            if not args.tokenizer:
                raise SystemExit(
                    "no vocab.json/merges.txt next to the checkpoint; pass "
                    "--tokenizer (HF name/path) or --tokens-file")
            from transformers import AutoTokenizer  # optional tooling
            tok = AutoTokenizer.from_pretrained(args.tokenizer)
            rows = tok(prompts, padding="max_length", truncation=True,
                       max_length=context_length)["input_ids"]
    text = np.stack([records.pad_tokens(r, context_length) for r in rows])
    if args.ensemble:
        n_templates = text.shape[0] // len(labels)
        owner = [i // n_templates for i in range(text.shape[0])]
    else:
        owner = list(range(len(labels)))
    return labels, text, owner


def classify_image(args: argparse.Namespace, image: np.ndarray, *,
                   cache: EmbeddingCache | None = None) -> dict:
    """The ``classify`` command after decoding: ``image`` a uint8
    ``(H, W, C)`` array. The class weights go through ``cache`` (default:
    the process-wide class-embedding cache, which a server in the same
    process shares), keyed on (family, checkpoint, dtype, token rows).
    Returns the labels, the (C,) f32 logits and scores (CLIP: a softmax
    over the labels; SigLIP: a sigmoid per label) and whether the weights
    were cached."""
    if args.index:
        raise SystemExit(_INDEX_NOT_PORTED)
    model = _load(args.model, args)
    cfg = model.config
    labels, text, owner = _prompt_rows(args, cfg.text.context_length)
    if args.naflex and args.model != "siglip":
        raise SystemExit("--naflex is a SigLIP2 feature; use "
                         "--model siglip")
    model_key = (f"{args.model}:{args.ckpt}:"
                 f"{'bf16' if args.bf16 else 'f32'}")
    cache = class_embedding_cache() if cache is None else cache
    key = prompt_set_key(model_key, text)
    weights = cache.get(key)
    cached = weights is not None
    if not cached:
        weights = weights_from_rows(model, text, owner, len(labels)).numpy()
        cache.put(key, weights)
    param = next(model.parameters())
    mean, std = ((CLIP_MEAN, CLIP_STD) if args.model == "clip"
                 else (SIGLIP_MEAN, SIGLIP_STD))
    with torch.inference_mode():
        if args.naflex:
            # aspect-preserving patch grid + mask instead of the square
            im = to_float_normalized(image[None], mean, std)[0]
            triple = patchify_naflex([im], patch_size=cfg.vision.patch_size,
                                     max_num_patches=cfg.vision.num_patches)
            feats = model.encode_image_naflex(
                *place(triple, param.device, param.dtype))
        else:
            # CLIP checkpoints are trained with shortest-side resize +
            # center crop; SigLIP's processor resizes straight to the square
            batch = preprocess_batch(image[None],
                                     image_size=cfg.vision.image_size,
                                     mean=mean, std=std,
                                     crop=args.model == "clip")
            feats = model.encode_image(
                torch.from_numpy(batch).to(param.device, param.dtype))
    logits = zero_shot_logits_from_features(
        model, feats, torch.from_numpy(weights)).cpu().numpy()[0]
    if args.model == "siglip":
        scores = 1.0 / (1.0 + np.exp(-logits))  # per-pair sigmoid
    else:
        e = np.exp(logits - logits.max())
        scores = e / e.sum()
    return {"labels": labels, "logits": logits, "scores": scores,
            "cached": cached}


def cmd_classify(args: argparse.Namespace) -> int:
    """Zero-shot image classification with CLIP/SigLIP: one line per label,
    best first. Label prompts come from ``--labels`` (the checkpoint's own
    vocab.json/merges.txt for CLIP, else ``--tokenizer``, an optional HF
    tokenizer) or from ``--tokens-file`` (JSON ``{label: [token ids]}``)."""
    image = records.decode_image(Path(args.image).read_bytes())
    out = classify_image(args, image)
    scores, labels = out["scores"], out["labels"]
    for i in np.argsort(-scores):
        print(f"{scores[i]:8.4f}  {labels[i]}")
    return 0


class Evaluation:
    """One ``evaluate`` pass: the model loaded and the options checked at
    construction (the JAX command's refusals and messages); :meth:`run`
    reads the shards once and returns the command's JSON fields.

    ``kind``: ``"top1"`` (ViT), ``"zero_shot"`` (``--zero-shot``) or
    ``"retrieval"`` (CLIP/SigLIP in-batch R@1, ``--naflex`` included).
    """

    def __init__(self, args: argparse.Namespace):
        if args.ckpt:
            if not (args.model or args.preset):
                raise SystemExit("--ckpt needs --model (or --preset to infer "
                                 "the family)")
            try:
                fam = args.model or family(args.preset)
            except ValueError as e:
                raise SystemExit(str(e)) from None
            model = _load(fam, args)
        else:
            if not (args.preset and args.ckpt_dir):
                raise SystemExit("need --ckpt, or --preset with --ckpt-dir")
            fam, model = restore_run(args)
            model.eval()
        self.args, self.fam, self.model = args, fam, model
        self.cfg = self.model.config
        # the pixels training saw: the family's normalization, square resize
        self.norm = _norm_for(fam)
        if args.naflex and (fam == "vit" or args.zero_shot):
            raise SystemExit("--naflex applies to clip/siglip retrieval "
                             "evaluation (not vit accuracy or --zero-shot)")
        if args.zero_shot:
            if fam == "vit":
                raise SystemExit("--zero-shot needs a contrastive model "
                                 "(clip/siglip); vit evaluates accuracy "
                                 "directly")
            self.kind = "zero_shot"
            self._zero_shot_weights()
        elif fam == "vit":
            self.kind = "top1"
        else:
            self.kind = "retrieval"
            if args.naflex:
                if fam != "siglip":
                    raise SystemExit("--naflex evaluates SigLIP2-style "
                                     "models; use --model siglip")
                if _is_tar_data(args.data):
                    raise SystemExit("--naflex reads tfrecord shards")
        #: wall seconds spent reading (decode, resize, normalize) in the
        #: last run, and in the whole run
        self.reader_s = self.wall_s = 0.0

    def _zero_shot_weights(self) -> None:
        """Ensemble class weights from the ``--zero-shot`` token table
        (``{label: [ids]}`` or ``{label: [[ids], ...]}``), in the
        dataset's classes.json order when there is one."""
        args, ctx = self.args, self.cfg.text.context_length
        table = json.loads(Path(args.zero_shot).read_text())
        labels = _dataset_classes(args.data) or list(table)
        missing = [label for label in labels if label not in table]
        if missing:
            raise SystemExit(f"--zero-shot file lacks tokens for classes "
                             f"{missing[:5]} (dataset classes.json order)")
        for label in labels:
            entry = table[label]
            for r in (entry if entry and isinstance(entry[0], list)
                      else [entry]):
                if len(r) > ctx:
                    raise SystemExit(
                        f"tokens for {label!r} are {len(r)} ids but the "
                        f"checkpoint's context_length is {ctx}; "
                        "re-tokenize to fit")
        labels, rows, owner = token_table_rows(table, ctx, labels)
        self.labels, self.prompts = labels, len(owner)
        self.weights = weights_from_rows(self.model, rows, owner, len(labels))

    def _batches(self) -> Iterator:
        args, cfg, norm = self.args, self.cfg, self.norm
        common = dict(repeat=False, shuffle_buffer=0, drop_remainder=False)
        if self.kind == "top1":
            return _classification_batches(args.data)(
                args.data, args.batch_size, image_size=cfg.vision.image_size,
                **common)
        if self.kind == "zero_shot":
            return _classification_batches(args.data)(
                args.data, args.batch_size, image_size=cfg.vision.image_size,
                **common, **norm)
        if args.naflex:
            return records.naflex_image_text_batches(
                args.data, args.batch_size, patch_size=cfg.vision.patch_size,
                max_num_patches=cfg.vision.num_patches,
                seq_len=cfg.text.context_length, **common, **norm)
        batches = (webdataset.wds_image_text_batches
                   if _is_tar_data(args.data) else records.image_text_batches)
        return batches(args.data, args.batch_size,
                       image_size=cfg.vision.image_size,
                       seq_len=cfg.text.context_length, **common, **norm)

    @torch.inference_mode()
    def _logits(self, images, targets) -> np.ndarray:
        model = self.model
        param = next(model.parameters())
        if self.args.naflex:
            images = place(images, param.device, param.dtype)
        else:
            images = torch.from_numpy(images).to(param.device, param.dtype)
        if self.kind == "top1":
            logits = model(images)
        elif self.kind == "zero_shot":
            logits = zero_shot_logits_from_features(
                model, model.encode_image(images), self.weights)
        else:
            tokens = torch.from_numpy(targets).to(param.device, torch.long)
            logits = (model.logits_naflex(*images, tokens) if self.args.naflex
                      else model(images, tokens))
        return logits.float().cpu().numpy()

    def logits(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Each batch's f32 logits and what they are scored against: the
        labels (top-1, zero-shot), or the diagonal (retrieval: row i's
        positive is text i, column i's image i). Times the reader into
        ``reader_s`` and the whole pass into ``wall_s``."""
        self.reader_s = 0.0
        t0 = time.perf_counter()
        batches = self._batches()
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            self.reader_s += time.perf_counter() - t
            if batch is None:
                break
            images, targets = batch
            logits = self._logits(images, targets)
            yield logits, (np.arange(len(logits)) if self.kind == "retrieval"
                           else targets)
        self.wall_s = time.perf_counter() - t0

    def run(self) -> dict:
        """One pass: the command's JSON fields."""
        return self.summary(self.logits())

    def summary(self, batches) -> dict:
        """The command's JSON fields from the pass's (logits, targets)."""
        n = hits = hits_t = 0
        for logits, targets in batches:
            hits += int((logits.argmax(axis=1) == targets).sum())
            if self.kind == "retrieval":
                hits_t += int((logits.argmax(axis=0) == targets).sum())
            n += len(logits)
        if not n:
            raise SystemExit(f"no examples in {self.args.data}")
        if self.kind == "top1":
            metrics = {"top1_accuracy": round(hits / n, 4)}
        elif self.kind == "zero_shot":
            metrics = {"zero_shot_top1": round(hits / n, 4),
                       "classes": len(self.labels), "prompts": self.prompts}
        else:
            metrics = {"retrieval_r1_image_to_text": round(hits / n, 4),
                       "retrieval_r1_text_to_image": round(hits_t / n, 4)}
        return {"examples": n, "batch_size": self.args.batch_size, **metrics}


def cmd_evaluate(args: argparse.Namespace) -> int:
    """Evaluate a model over a file dataset (single non-repeating pass,
    the short last batch counted): ViT top-1 accuracy over labeled records;
    CLIP/SigLIP in-batch retrieval R@1 both ways (the diagonal is the
    positive pair); ``--zero-shot`` accuracy over labeled records. Prints
    one JSON line."""
    print(json.dumps(Evaluation(args).run()))
    return 0


class _ShardWriter:
    """Rotates ``part-NNNNN.tfrecord`` files every ``shard_size``
    examples."""

    def __init__(self, out: Path, shard_size: int):
        self.out, self.shard_size = out, shard_size
        self.n_in_shard = self.shards = self.total = 0
        self._w = None

    def write(self, payload: bytes) -> None:
        if self._w is None or self.n_in_shard >= self.shard_size:
            self.close()
            self._w = TFRecordWriter(self.out / f"part-{self.shards:05d}"
                                                ".tfrecord")
            self.shards += 1
            self.n_in_shard = 0
        self._w.write(payload)
        self.n_in_shard += 1
        self.total += 1

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None


def cmd_prepare_data(args: argparse.Namespace) -> int:
    """Build tfrecord shards (the format ``evaluate --data`` reads) from raw
    files.

    - ``--task classification``: SRC/<class_name>/*.{jpg,jpeg,png} — labels
      are sorted class-directory indices; writes ``classes.json`` alongside
      the shards.
    - ``--task contrastive``: SRC holds the images; ``--captions`` is a TSV
      of ``relative/path<TAB>caption``. Captions that are whitespace-
      separated integers are taken as pre-tokenized ids; otherwise
      ``--tokenizer`` names a HuggingFace tokenizer (an optional
      ``transformers`` install).
    """
    src, out = Path(args.src), Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stale = sorted(out.glob("part-*.tfrecord"))
    if stale:
        # the readers glob the whole dir: leftover higher-numbered shards
        # from a previous run would silently mix into the dataset
        raise SystemExit(f"{out} already holds {len(stale)} shard(s) "
                         f"({stale[0].name}..); remove them or use a fresh "
                         "output directory")
    exts = {".jpg", ".jpeg", ".png"}
    integer = re.compile(r"^-?\d+$")
    writer = _ShardWriter(out, args.shard_size)
    classes: dict[str, int] = {}
    try:
        if args.task == "classification":
            names = sorted(d.name for d in src.iterdir() if d.is_dir())
            if not names:
                raise SystemExit(f"no class directories under {src}")
            classes = {name: i for i, name in enumerate(names)}
            for name, label in classes.items():
                for img in sorted((src / name).iterdir()):
                    if img.suffix.lower() not in exts or not img.is_file():
                        continue
                    writer.write(encode_example({"image": img.read_bytes(),
                                                 "label": label}))
        else:  # contrastive
            if not args.captions:
                raise SystemExit("--task contrastive needs --captions TSV")
            tok = None
            for ln_no, line in enumerate(
                    Path(args.captions).read_text().splitlines(), 1):
                if not line.strip():
                    continue
                rel, _, caption = line.partition("\t")
                parts = caption.split()
                if not parts:
                    raise SystemExit(f"{args.captions}:{ln_no}: no caption "
                                     f"after TAB (line {line[:60]!r})")
                if all(integer.match(p) for p in parts):
                    ids = [int(p) for p in parts]  # pre-tokenized
                else:
                    if tok is None:
                        if not args.tokenizer:
                            raise SystemExit(
                                f"{args.captions}:{ln_no}: text caption "
                                "needs --tokenizer (HF name/path)")
                        from transformers import AutoTokenizer  # optional
                        tok = AutoTokenizer.from_pretrained(args.tokenizer)
                    ids = tok(caption)["input_ids"]
                if len(ids) > args.seq_len:
                    # keep the FINAL token when truncating: CLIP pools the
                    # text tower at the EOT position (argmax of ids), which
                    # a plain tail-chop would drop
                    ids = list(ids[:args.seq_len - 1]) + [ids[-1]]
                writer.write(encode_example(
                    {"image": (src / rel).read_bytes(), "tokens": ids}))
    finally:
        writer.close()  # flush the open shard even on a mid-run error
    if not writer.total:
        raise SystemExit(f"no examples found under {src}")
    if classes:
        # written last: a failed run must not leave a plausible-looking
        # classes.json next to no (or partial) shards
        (out / "classes.json").write_text(json.dumps(classes, indent=2))
    print(f"wrote {writer.total} examples in {writer.shards} shard(s) "
          f"to {out}")
    return 0


def _positive_int(v: str) -> int:
    n = int(v)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def cmd_profile_analyze(args: argparse.Namespace) -> int:
    """Offline per-op summary of a ``--profile-dir`` trace: first one plain
    line on what the capture holds (a capture without device events says
    so), and one on its ``train_step`` ranges where it has them, then the
    per-op table. A ``--mesh`` run's directory holds one ``rank<r>``
    folder a rank: each is summarized in turn, under a ``rank<r>:``
    line."""
    device = None if args.device < 0 else args.device
    root = Path(args.dir)
    ranks = sorted((p for p in root.glob("rank*") if p.is_dir()
                    and p.name[4:].isdigit()), key=lambda p: int(p.name[4:]))
    for where in ranks or [root]:
        if ranks:
            print(f"{where.name}:")
        events = load_trace_events(where)
        print(render_summary(capture_summary(events, device=device)))
        steps = capture_summary(events, device=device, region="train_step")
        if steps["regions"]:
            print(f"inside its {steps['regions']} train_step ranges: "
                  f"{render_summary(steps)}")
        print(summarize(op_stats(where, device=device), top=args.top,
                        steps=args.steps))
    return 0


def cmd_build_native(args: argparse.Namespace) -> int:
    """Build (or find) the native host-preprocessing library with g++ and
    check that it loads; one JSON line. Exits 1 when the compiler or the
    load fails, with its message."""
    found = native.target()[3].exists()
    try:
        native.load()
    except RuntimeError as e:
        print(f"build-native: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"status": "found" if found else "built",
                      "library": str(native.build()),
                      "codecs": native.codecs_available(),
                      "threads": native.threads()}), flush=True)
    return 0


def _add_run_flags(sp: argparse.ArgumentParser) -> None:
    """``evaluate``'s training-run options (with ``--preset``); the
    architecture flags may be left out where the run records them."""
    sp.add_argument("--ckpt-dir", default=None,
                    help="a training run's checkpoint directory (with "
                         "--preset)")
    sp.add_argument("--tiny", action="store_true",
                    help="with --ckpt-dir: the run trained --tiny")
    sp.add_argument("--from-pretrained", default=None,
                    help="with --ckpt-dir: the HF checkpoint the run "
                         "fine-tuned from (rebuilds that architecture)")
    sp.add_argument("--image-size", type=int, default=None,
                    help="with --from-pretrained: the run's --image-size")
    sp.add_argument("--num-classes", type=int, default=None,
                    help="classifier width of the run's head (vit + "
                         "--ckpt-dir; default: the run's record, else "
                         "classes.json next to --data)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m jimm_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("serve", help="HTTP micro-batching embedding server")
    sp.add_argument("--ckpt", default=None,
                    help="an HF checkpoint: a local directory or file, or "
                         "a hub repository id (needs --model)")
    sp.add_argument("--model", default=None, choices=sorted(MODELS),
                    help="model family of --ckpt")
    sp.add_argument("--preset", default="siglip-base-patch16-256",
                    choices=sorted(PRESETS),
                    help="random-init a preset of any family (when no "
                         "--ckpt)")
    sp.add_argument("--tiny", action="store_true",
                    help="shrink the preset to CPU-demo size")
    sp.add_argument("--dtype", choices=_SERVE_DTYPES, default=None,
                    help="parameter and compute dtype (default f32); int8 = "
                         "f32 with every eligible Linear as a W8A8 "
                         "QuantLinear")
    sp.add_argument("--bf16", action="store_true",
                    help="legacy spelling of --dtype bf16")
    sp.add_argument("--ln-impl", default=None, choices=["xla", "fused"],
                    help="encoder LayerNorm (fused = the LayerNorm kernels)")
    sp.add_argument("--device", default="cuda",
                    help="torch device, or a comma-separated list of them, "
                         "one entry per device of the replica plan; a card "
                         "may be listed more than once (cuda:0,cuda:0: two "
                         "replicas on one card). 'cuda' lists each visible "
                         "card once; 'cpu' must be asked for explicitly")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000, help="0 = any free port")
    sp.add_argument("--buckets", default=None,
                    help="comma-separated batch buckets (default: the "
                         "device's table)")
    sp.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="coalescing window")
    sp.add_argument("--replicas", type=int, default=1,
                    help="independent serving replicas to partition the "
                         "listed devices into; micro-batches are load-"
                         "balanced across them (1 = classic single-device "
                         "serve)")
    sp.add_argument("--model-parallel", type=int, default=1,
                    help="devices per replica the model is sliced over "
                         "(Megatron tensor parallelism, in process)")
    sp.add_argument("--seq-parallel", type=int, default=1,
                    help="sequence-parallel ways per replica: a tower whose "
                         "tokens divide runs on each device's chunk, "
                         "attention on the ring")
    sp.add_argument("--qos-policy", default=None, metavar="FILE",
                    help="tenant QoS policy (JSON/TOML): priority classes, "
                         "per-tenant token-bucket rate limits and queue "
                         "quotas; enables weighted-fair scheduling and "
                         "class-ordered shedding. Without it the engine "
                         "keeps its single FIFO")
    sp.add_argument("--pool-model", action="append", default=None,
                    metavar="NAME=PRESET[@DTYPE]",
                    help="additional resident model (repeatable): "
                         "random-init PRESET at DTYPE (f32|bf16|int8, "
                         "default f32) over the same replica plan, with its "
                         "own engine; requests naming model=NAME route to "
                         "it. Inherits --tiny, --ln-impl and --buckets")
    sp.add_argument("--self-heal", action="store_true",
                    help="escalate a watchdog fence: probe the fenced "
                         "replica (transient fault -> revive in place), "
                         "else rebuild the replica set and replan around "
                         "it live")
    sp.add_argument("--queue-size", type=int, default=256,
                    help="admission queue bound (503 past it)")
    sp.add_argument("--timeout-s", type=float, default=5.0,
                    help="default request deadline (504 past it)")
    sp.add_argument("--shed-fraction", type=float, default=0.5,
                    help="queue fill fraction past which the batcher stops "
                         "waiting for stragglers")
    sp.add_argument("--max-seconds", type=float, default=None,
                    help="stop after this long (default: serve until ^C)")
    sp.add_argument("--metrics-file", default=None,
                    help="append metric snapshots as JSONL "
                         "(train/metrics.py format)")
    sp.add_argument("--metrics-every-s", type=float, default=10.0)
    sp.add_argument("--journal", default=None, metavar="FILE",
                    help="flight-recorder journal (JSONL): replica faults, "
                         "fences, revives, heals and replans")
    sp.add_argument("--prof-dir", default=None, metavar="DIR",
                    help="profiling: keep the capture ring here (heal, "
                         "replan and SLO-burn incidents and POST "
                         "/admin/prof/trigger deep-capture onto their "
                         "cids) and sample the jimm_hbm_* device-memory "
                         "gauges")
    sp.set_defaults(func=cmd_serve)

    sp = sub.add_parser("train", help="train on synthetic data or file "
                                      "shards: ViT classifiers, CLIP/SigLIP "
                                      "pairs")
    sp.add_argument("--preset", default="siglip-base-patch16-256",
                    choices=sorted(PRESETS),
                    help="names the family (vit, clip, siglip) and, "
                         "without --from-pretrained, the architecture")
    sp.add_argument("--tiny", action="store_true",
                    help="shrink the preset to CPU-demo size")
    sp.add_argument("--from-pretrained", default=None,
                    help="fine-tune from a local HF checkpoint directory "
                         "or file of the preset's family")
    sp.add_argument("--image-size", type=int, default=None,
                    help="with --from-pretrained: load at a different "
                         "resolution (position-table interpolation)")
    sp.add_argument("--num-classes", type=int, default=None,
                    help="ViT classifier width (default 4, the synthetic "
                         "classes); a checkpoint's head of another width is "
                         "replaced by a fresh one")
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--weight-decay", type=float, default=1e-4)
    sp.add_argument("--warmup-steps", type=int, default=0)
    sp.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the synthetic data and the "
                         "--data shuffles")
    sp.add_argument("--bf16", action="store_true",
                    help="bf16 parameters and compute (default f32)")
    sp.add_argument("--loss", default=None,
                    choices=["clip", "clip_ring", "siglip", "siglip_ring"],
                    help="contrastive loss (default: the family's own, "
                         "its ring version on a --mesh with a data or seq "
                         "axis; the ring losses need --mesh)")
    sp.add_argument("--naflex", action="store_true",
                    help="variable-resolution SigLIP2 training: NaFlex "
                         "(patches, shapes, mask) batches of synthetic "
                         "mixed-aspect images instead of square images")
    sp.add_argument("--attn-impl", default=None,
                    choices=["auto", "xla", "flash", "flash_masked",
                             "flash_int8", "saveable"],
                    help="attention for both towers (auto = flash on CUDA; "
                         "flash takes the masked kernels where there is a "
                         "key-padding mask; flash_masked = the masked "
                         "kernels for the NaFlex vision tower, needs "
                         "--naflex; flash_int8 = int8-QK flash, forward and "
                         "backward; saveable = einsum attention whose "
                         "probabilities --remat dots+attn keeps)")
    sp.add_argument("--ln-impl", default=None, choices=["xla", "fused"],
                    help="encoder LayerNorm (fused = the LayerNorm kernels)")
    sp.add_argument("--fused-qkv", action="store_true",
                    help="q/k/v as one (H, 3H) matmul")
    sp.add_argument("--remat", default=None,
                    help="activation remat of every block: none (off), full "
                         "(recompute all), or dots with +ln/+act/+attn "
                         "suffixes (keep matmul [+layernorm][+activation]"
                         "[+attention-prob] outputs)")
    sp.add_argument("--bf16-momentum", action="store_true",
                    help="keep Adam's first moment in bfloat16")
    sp.add_argument("--moment-dtype", default=None, choices=["f32", "bf16"],
                    help="Adam first-moment dtype; wins over "
                         "--bf16-momentum")
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
    sp.add_argument("--ckpt-dir", default=None,
                    help="checkpoint the run here (parameters, optimizer "
                         "state, step) every --save-every steps")
    sp.add_argument("--resume", action="store_true",
                    help="continue from the newest good checkpoint in "
                         "--ckpt-dir (a corrupt or partial one is "
                         "quarantined and the one before it taken)")
    sp.add_argument("--save-every", type=int, default=50,
                    help="checkpoint every N steps")
    sp.add_argument("--fake-failure-at-step", type=int, default=None,
                    help="failure drill: crash after checkpointing this step "
                         "(recover with --resume); sugar for "
                         "--inject-faults crash@STEP")
    sp.add_argument("--inject-faults", default=None,
                    help="deterministic fault drill plan: comma-separated "
                         "kind@STEP entries -- preempt@N (SIGTERM to self), "
                         "crash@N (hard failure after N's checkpoint), "
                         "stall@N:SECONDS (slow-host sleep), corrupt@N "
                         "(garbage the newest committed checkpoint)")
    sp.add_argument("--preemption-save", action="store_true",
                    help="catch SIGTERM and spend the grace window on a "
                         "checkpoint save whose writes overlap the next "
                         "--grace-steps steps, then exit resumable (needs "
                         "--ckpt-dir)")
    sp.add_argument("--grace-steps", type=int, default=1,
                    help="training steps to overlap with the preemption "
                         "save before exiting (0 = save and exit at once)")
    sp.add_argument("--batch-fingerprint", action="store_true",
                    help="log a content hash of every consumed batch (the "
                         "proof that a resume replays and skips no batch)")
    sp.add_argument("--journal", default=None, metavar="FILE",
                    help="persist flight-recorder events (preemption, "
                         "checkpoint) to this rotating JSONL journal")
    sp.add_argument("--data", default=None,
                    help="tfrecord or tar shards (file/dir/glob) with "
                         "image+label (vit) or image+tokens (clip/siglip) "
                         "examples; default: procedural synthetic data")
    sp.add_argument("--shuffle-buffer", type=int, default=256,
                    help="example shuffle-buffer size for --data (records "
                         "loader)")
    sp.add_argument("--loader", default="records",
                    choices=["records", "grain"],
                    help="--data pipeline: 'records' (generator, buffer "
                         "shuffle) or 'grain' (the indexed loader: "
                         "parallel workers, shuffle by index, exact "
                         "checkpointed position)")
    sp.add_argument("--data-workers", type=int, default=0,
                    help="worker processes of the grain loader (0 = in "
                         "this process)")
    sp.add_argument("--tensorboard-dir", default=None,
                    help="write TensorBoard scalar events here")
    sp.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of steps 2-4 here "
                         "(profile-analyze reads it)")
    sp.add_argument("--prof-ring", default=None, metavar="DIR",
                    help="continuous profiling: keep a bounded on-disk "
                         "ring of short step-window captures here (obs "
                         "prof ls/show/diff)")
    sp.add_argument("--prof-every", type=int, default=200,
                    help="capture a ring window every N steps")
    sp.add_argument("--prof-window", type=int, default=2,
                    help="steps per ring window capture")
    sp.add_argument("--prof-ring-bytes", type=int, default=64 << 20,
                    help="ring byte budget; oldest captures evicted")
    sp.add_argument("--mesh", default=None,
                    help="device mesh over the ranks of a "
                         "torch.distributed.run launch, e.g. data=2 or "
                         "data=2,seq=2 (-1: the remaining ranks); the batch "
                         "shards over it and the ring losses run on it")
    sp.add_argument("--rules", default=None, choices=TRAIN_RULES,
                    help="sharding rules preset on --mesh (default dp): "
                         "replicated, dp, fsdp, sp, fsdp_sp; tp and fsdp_tp "
                         "(a model axis: tensor parallelism, fsdp_tp FSDP "
                         "over data on top); pp (a stage axis: the "
                         "pipelined encoders)")
    sp.add_argument("--pipeline-microbatches", type=int, default=0,
                    help="enable pipeline parallelism with N microbatches "
                         "(needs a 'stage' mesh axis and --rules pp)")
    sp.add_argument("--pipeline-virtual", type=int, default=1,
                    help="interleaved PP: virtual chunks per stage "
                         "(circular placement; shrinks the bubble ~Vx)")
    sp.add_argument("--scan-unroll", type=int, default=0,
                    help="layer-scan unroll factor of the JAX package (0 = "
                         "auto); the port's blocks run in a Python loop, so "
                         "it changes no kernel or loop here: it is recorded "
                         "(each step's extra.json) and supervise --adapt may "
                         "set it")
    sp.add_argument("--max-devices", type=int, default=None,
                    help="build the mesh over only the first N ranks "
                         "(elastic restarts: a shrunk attempt plans over "
                         "the surviving subset and restore reshards the "
                         "checkpoint onto it; the other ranks wait for the "
                         "attempt's outcome)")
    sp.set_defaults(func=cmd_train)

    sp = sub.add_parser("supervise",
                        help="run train as restartable attempts "
                             "(preemption/crash -> backoff -> --resume)")
    sp.add_argument("--max-restarts", type=int, default=3,
                    help="restarts before giving up")
    sp.add_argument("--backoff-base-s", type=float, default=1.0)
    sp.add_argument("--backoff-max-s", type=float, default=30.0)
    sp.add_argument("--seed", type=int, default=None,
                    help="seed the restart-backoff jitter (reproducible "
                         "drills)")
    sp.add_argument("--journal", default=None, metavar="FILE",
                    help="persist flight-recorder events (attempts, "
                         "restarts, replans, advisor decisions) to this "
                         "rotating JSONL journal")
    sp.add_argument("--elastic", action="store_true",
                    help="replan the mesh from surviving devices before "
                         "every attempt (--mesh data=K --max-devices K "
                         "appended to the train command); restore reshards "
                         "the checkpoint onto the new shape")
    sp.add_argument("--shrink-plan", default=None,
                    help="elastic drill: comma-separated device budgets per "
                         "attempt, e.g. 8,4 = first attempt sees 8 devices, "
                         "every later attempt 4 (simulates losing hosts)")
    sp.add_argument("--adapt", action="store_true",
                    help="run the GoodputAdvisor over per-attempt goodput "
                         "breakdowns and carry its bounded knob decisions "
                         "(--save-every/--grace-steps/--scan-unroll) into "
                         "the next attempt")
    sp.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="-- train --preset ... --ckpt-dir ...")
    sp.set_defaults(func=cmd_supervise)

    sp = sub.add_parser("evaluate",
                        help="accuracy / retrieval metrics over a dataset")
    sp.add_argument("--data", required=True,
                    help="tfrecord or tar shards: file/dir/glob (single "
                         "pass, no repeat)")
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--ckpt", default=None,
                    help="a local HF checkpoint directory or file")
    sp.add_argument("--model", default=None, choices=sorted(MODELS),
                    help="model family for --ckpt (else from --preset name)")
    sp.add_argument("--preset", default=None,
                    help="a preset name, to infer the family of --ckpt")
    sp.add_argument("--zero-shot", default=None, metavar="TOKENS_JSON",
                    help="zero-shot classification accuracy over labeled "
                         "records (clip/siglip): {label: [ids]} or "
                         "{label: [[ids], ...]} for prompt ensembles; "
                         "class order from the dataset's classes.json")
    sp.add_argument("--naflex", action="store_true",
                    help="SigLIP2 retrieval over NaFlex variable-resolution "
                         "batches (aspect-preserving) instead of the square "
                         "resize")
    sp.add_argument("--bf16", action="store_true",
                    help="bf16 parameters and compute (default f32)")
    sp.add_argument("--ln-impl", default=None, choices=["xla", "fused"],
                    help="encoder LayerNorm (fused = the LayerNorm kernels)")
    sp.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    _add_run_flags(sp)
    sp.set_defaults(func=cmd_evaluate)

    sp = sub.add_parser("classify",
                        help="zero-shot image classification (CLIP/SigLIP)")
    sp.add_argument("image", help="image file (PNG/JPEG)")
    sp.add_argument("--ckpt", required=True,
                    help="a local HF checkpoint directory or file")
    sp.add_argument("--model", default="clip", choices=["clip", "siglip"])
    sp.add_argument("--labels", default=None,
                    help='comma-separated label names, e.g. "cat,dog"')
    sp.add_argument("--template", default=None,
                    help="prompt template applied to each label (default "
                         "'a photo of a {}'); with --ensemble, a "
                         "\"|\"-separated template set")
    sp.add_argument("--tokenizer", default=None,
                    help="HF tokenizer for --labels (optional tooling)")
    sp.add_argument("--tokens-file", default=None,
                    help="JSON {label: [token ids]} — offline alternative "
                         "to --tokenizer")
    sp.add_argument("--ensemble", action="store_true",
                    help="prompt-template ensemble per class (the CLIP-"
                         "paper recipe): normalize/mean/renormalize text "
                         "embeddings over templates; --template with "
                         "\"|\"-separated entries overrides the builtin set")
    sp.add_argument("--naflex", action="store_true",
                    help="SigLIP2 NaFlex path: keep the image's aspect "
                         "ratio (variable-resolution patches + mask) "
                         "instead of squashing to the square")
    sp.add_argument("--bf16", action="store_true",
                    help="bf16 parameters and compute (default f32)")
    sp.add_argument("--ln-impl", default=None, choices=["xla", "fused"],
                    help="encoder LayerNorm (fused = the LayerNorm kernels)")
    sp.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    sp.add_argument("--index", default=None, help=argparse.SUPPRESS)
    sp.set_defaults(func=cmd_classify)

    sp = sub.add_parser("export-run",
                        help="export a training run as an HF checkpoint")
    sp.add_argument("out", help="output directory")
    sp.add_argument("--ckpt-dir", required=True,
                    help="checkpoint directory of the run")
    sp.add_argument("--preset", required=True, choices=sorted(PRESETS),
                    help="preset the run trained (or its family, with "
                         "--from-pretrained)")
    sp.add_argument("--flavor", default="auto",
                    choices=["auto", "siglip", "siglip2"],
                    help="SigLIP export format: auto = the source "
                         "checkpoint's (v1 for a preset)")
    sp.add_argument("--tiny", action="store_true")
    sp.add_argument("--from-pretrained", default=None,
                    help="HF checkpoint the run fine-tuned from")
    sp.add_argument("--image-size", type=int, default=None)
    sp.add_argument("--num-classes", type=int, default=None)
    sp.add_argument("--bf16", action="store_true",
                    help="export bf16 parameters (the run's cast, as "
                         "orbax casts; default f32)")
    sp.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' must be asked for explicitly")
    sp.set_defaults(func=cmd_export_run)

    sp = sub.add_parser("prepare-data",
                        help="build tfrecord shards from raw image files")
    sp.add_argument("src", help="source directory (class dirs, or images)")
    sp.add_argument("out", help="output directory for part-*.tfrecord")
    sp.add_argument("--task", default="classification",
                    choices=["classification", "contrastive"])
    sp.add_argument("--captions", default=None,
                    help="TSV: relative/path<TAB>caption (contrastive)")
    sp.add_argument("--tokenizer", default=None,
                    help="HF tokenizer for text captions (optional tooling; "
                         "integer captions are used as pre-tokenized ids)")
    sp.add_argument("--seq-len", type=int, default=64,
                    help="truncate token ids to this length")
    sp.add_argument("--shard-size", type=int, default=1000,
                    help="examples per tfrecord shard")
    sp.set_defaults(func=cmd_prepare_data)

    sp = sub.add_parser("profile-analyze",
                        help="per-op summary of a torch.profiler trace dir")
    sp.add_argument("dir", help="--profile-dir of a train run (or a "
                                "capture of the ring)")
    sp.add_argument("--top", type=int, default=25)
    sp.add_argument("--steps", type=_positive_int, default=1,
                    help="steps captured, to report per-step numbers")
    sp.add_argument("--device", type=int, default=0,
                    help="card to report (-1 = sum across cards)")
    sp.set_defaults(func=cmd_profile_analyze)

    add_obs_parser(sub)
    add_qos_parser(sub)

    sp = sub.add_parser("build-native",
                        help="compile the native host-preprocessing library "
                             "(g++) and check that it loads")
    sp.set_defaults(func=cmd_build_native)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
