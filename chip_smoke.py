#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``jimm_tpu_torch``) runs on an
NVIDIA card: ``python3 chip_smoke.py`` from the repository root, one card.

Phases, each of which ends the run with a non-zero exit when it fails:

1. device   -- a CUDA card must be visible; prints its name and, from
               nvidia-smi, its name and power limit.
2. build    -- compiles every kernel of ``jimm_tpu_torch/csrc`` with nvcc for
               sm_90a (``jimm_tpu_torch/_build.py``), then reads the
               library's SASS with ``cuobjdump``: every fp8 GEMM kernel must
               hold wgmma instructions (HGMMA: f16 wgmma on the fp8 values
               widened in shared memory), every int8 matmul kernel s8
               wgmma ones (IGMMA), every bf16 flash forward, dq and
               dk/dv kernel mma.sync ones (HMMA), every int8-QK forward
               and backward (dq, dk/dv) of the bf16 body both s8 mma.sync
               (IMMA, its scores) and HMMA (P.V; dp and the gradients), and
               every dbias kernel of the bf16 body HMMA; prints their
               counts, and each kernel's registers and local memory
               (spills) from ``cuobjdump -res-usage``.
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the served and trained shapes and some odd ones, forward and
               backward, the masked flash kernels (NaFlex) with the
               synthetic NaFlex batches' masks and odd masks (a query row
               with no key to attend is checked for finiteness only), in
               f32 (max abs error <= 1e-4, relative to the reference's
               scale for the backward, TF32 off) and bf16
               (cosine >= 0.999 and max abs error <= 2**-7 of the largest
               reference value, about one bf16 step; a bf16 reference that
               is zero up to rounding, max abs error <= 1e-5); reports the
               device time (profiler) of the kernel, of the plain version
               and of one PyTorch library call that computes the same
               function (a yardstick the port never calls), the kernel's
               time per call (CUDA events), and the least time the card
               could take (bytes over 3.35 TB/s or flops over the peak);
               then readings, not gates: the redesigned kernels (the bf16
               flash forward and backward in each kind, rows 3-7, the
               int8-QK forward and backward, rows 9 and 10, the dbias
               kernel, row 8, the int8 matmul, row 11, and the fp8 GEMM,
               row 12, on tensor cores; the LayerNorm forward, row 1, one
               warp a row) as a speed-up over their first versions' times
               in PERF.md, and the rows whose recorded times stand (3-6
               and 12, which share headers with rows 7-11, and 1, 2, 11)
               beside those times (within 5%). Row 1 runs on both its
               bodies (the register body at F = 768, 1024, 1152, 80 and
               64; the CTA body at (3, 5000) and with x off a 16-byte
               boundary), each case naming its body, which a trace of the
               call must confirm. Row 11 must equal its plain version
               (``torch.equal``) but for gelu. In bf16 only, rows 7 (every
               kind), 8, 9 and 10 also run at more odd shapes on their
               tensor-core bodies: an unaligned strided q view, unaligned
               int8 q and k with strided v and do, D = 30, a broadcast
               (256, 256) bias, -inf keys, a batch summed in several
               ranges.
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
5. train    -- SigLIP-B/16-256 at full width, the contrastive train step of
               ``python -m jimm_tpu_torch train``: (a) in f32 at batch 8, the
               gradients of one step through the kernels must match those
               with the plain versions swapped in (every parameter within
               1e-3 of its largest value, or of 1e-3 of the model's largest
               for a gradient that is zero in exact arithmetic), then the
               same in bf16, on the tensor-core bodies (each gradient
               within 2^-3 of its largest value or of 2^-4 of the model's
               largest, and a cosine of at least 0.99 above that floor);
               (b) in
               bf16 at batch 128 (the benchmark's batch), fused LayerNorm
               and flash attention, one
               fixed synthetic batch repeated: warm-up steps, then timed
               steps whose loss must stay finite and fall, with 25 flash and
               48 LayerNorm launches forward and backward per step. Prints
               the step time, images/s, MFU against 989 TFLOP/s, peak
               memory, and the device-busy share and top kernels of one
               profiled step; (c) the ``train`` command itself, in this
               process: ``train --preset siglip-base-patch16-256 --bf16
               --ln-impl fused --batch-size 128`` for a few steps on its
               synthetic pairs, whose metric lines must show a finite loss
               and an MFU, with the same launches per step. Its launch
               counts are the ones the kernels' JSON record reports for the
               unmasked kernels.
6. naflex   -- SigLIP2-B/16-256 (Gemma vocabulary, 256000) at full width on
               NaFlex variable-resolution batches from
               ``naflex_contrastive_pairs`` (grids 9x27, 16x16, 27x9, 11x22:
               243, 256, 243 and 242 of 256 tokens real), fused LayerNorm,
               flash attention: (a) in f32 and in bf16 at batch 8, one
               step's gradients through the kernels against the plain
               versions, as 5(a);
               (b) ``encode_image_naflex`` in bf16 at batch 32 against the
               plain-version forward (cosine >= 0.999, norms within 1%),
               13 masked flash and 24 LayerNorm launches, and padded patches
               poisoned with 1e4 must leave the features unchanged; (c) in
               bf16 at batch 128, a fixed NaFlex batch repeated (step time,
               images/s, MFU, peak memory, one profiled step), then the
               command ``train --preset siglip2-base-patch16-256 --naflex
               --bf16 --ln-impl fused --batch-size 128`` in this process,
               with 13 masked and 12 unmasked flash and 48 LayerNorm
               launches forward and backward per step. Its counts are the
               ones the JSON record reports for the masked kernels.
7. int8 serve -- SigLIP-B/16-256 at full width as ``serve --dtype int8``
               builds it (``cli.serving_model``: f32, then every eligible
               Linear a W8A8 ``QuantLinear``), fused LayerNorm, flash, behind
               the HTTP server with buckets (1, 8, 32): 48 single requests
               from 16 client threads and one bulk request of 32. Every
               answer must match the same quantized model's forward with the
               plain versions swapped in (cosine >= 0.999, norms within 1%);
               the cosine against the unquantized f32 model is printed; per
               dispatched batch 78 int8-matmul, 13 flash and 24 LayerNorm
               launches. Then the forward's time per bucket and the kernels
               of a bucket-32 forward.
8. int8_qk  -- SigLIP-B/16-256 under ``--precision int8_qk`` (every
               attention, the MAP probe's included, on the int8-QK flash
               kernels): (a) f32 at batch 8, one step's gradients through the
               kernels against the plain versions, as 5(a), the
               quantizations of q and k replayed, then the same in bf16 on
               the tensor-core bodies (5(a)'s bf16 bound); (b) bf16 at batch
               128, one fixed batch, 3 warm-up and 10 timed steps (25 int8
               flash launches forward and backward a step, no softmax flash,
               48 LayerNorm; the loss must fall), with one profiled step;
               (c) ``train --preset siglip-base-patch16-256 --precision
               int8_qk --bf16 --ln-impl fused --batch-size 128`` in this
               process, whose counts the JSON record reports for the int8
               flash kernels. The int8 matmul's come from phase 7.
9. fp8_hybrid -- SigLIP-B/16-256 under ``--precision fp8_hybrid`` (151
               Linears as ``Fp8Linear``s on the fp8 GEMM, delayed scaling):
               (a) f32 at batch 8, one step's gradients through the kernels
               against the plain versions, as 5(a), with every fp8
               quantization of the kernel step replayed in the plain step
               (a one-ulp difference upstream of a quantizer moves an fp8
               value by a step), and the 302 amax histories after the two
               steps equal within 1e-4 of their values; (b) bf16 at batch
               128, one fixed batch, 3 warm-up and 10 timed steps (151 fp8
               GEMM launches forward and 302 backward a step, 25 flash, 48
               LayerNorm; the loss must fall), one step run under
               ``torch.cuda.set_sync_debug_mode("warn")`` that must
               synchronise with the host nowhere, and one profiled step;
               (c) ``train --preset siglip-base-patch16-256 --precision
               fp8_hybrid --bf16 --ln-impl fused --batch-size 128`` in this
               process, whose counts the JSON record reports for the fp8
               GEMM.
10. sigmoid -- SigLIP-B/16-256 with ``attn_impl="sigmoid"`` (the library
               path: the JAX train command has no such flag) trained by
               ``make_contrastive_train_step("siglip")``: (a) f32 and bf16
               at batch 8, one step's gradients against the plain versions,
               as 5(a);
               (b) bf16 at batch 128 as 9(b), at a learning rate of 1e-4
               (``SIGMOID_LEARNING_RATE``): 25 sigmoid flash launches
               forward and backward a step, no softmax flash, the loss
               falling, no host sync, one profiled step. Its counts are the
               ones the JSON record reports for the sigmoid kernels.
11. bias    -- the library path ``dot_product_attention(..., bias=b,
               impl="auto")`` on the card (no preset or CLI flag of either
               package passes a bias): (a) f32 at batch 8, q, k, v
               (8, 256, 12, 64) and a learnable (12, 256, 256) bias, then a
               (256, 256) one: the gradients of q, k, v and the bias through
               the kernels (rows 5, 7-bias and 8, one launch each) against
               the plain versions, within 1e-3 of each largest gradient;
               (b) bf16 at batch 128, 12 biased calls, one per
               SigLIP-B/16 vision block, forward and backward: 12, 12 and 12
               launches of rows 5, 7-bias and 8, timed against the same 12
               calls without a bias and against SDPA with a float attn_mask
               that requires grad, with one profiled pass. Its counts are
               the ones the JSON record reports for the bias kernels;
               (c) the routing: a 4-D bias, or a bias with a mask, goes to
               the einsum path and moves no kernel counter, and "flash" with
               a key-padding mask and a bias raises JAX's ValueError.
12. checkpoints -- HF checkpoint IO and the ViT and CLIP models, at full
               width and depth in bf16: (a) ViT-B/16-224 (1000 classes, the
               zero-initialised head drawn from the generator), CLIP-B/16
               and SigLIP-B/16-256, seeded, through ``save_pretrained`` into
               a temporary directory and ``from_pretrained`` back onto the
               card: every parameter ``torch.equal``, the same keys, and
               ``config_from_hf(hf_config())`` the config; SigLIP again in
               the siglip2 flavor; each file's size and each save's and
               load's wall time printed; (b) ``serve --ckpt DIR --model vit``
               and ``--model clip`` (``--dtype bf16 --ln-impl fused``,
               buckets 1, 8, 32), built by the CLI's own parser and
               ``build_server``, answer phase 4's traffic: every answer
               against the plain-version forward (cosine >= 0.999, norms
               within 1%), and per dispatched batch 12 flash launches and 25
               (ViT: the blocks' 24 and ln_post) or 26 (CLIP: and ln_pre)
               LayerNorm launches; (c) CLIP's ``encode_text`` at (32, 77):
               12 flash launches, every one causal, and 24 LayerNorm,
               against the plain versions (cosine >= 0.999, norms within
               1%), then ``CLIP.forward``'s logits (cosine >= 0.999; their
               row norms are printed: between untrained towers the logits
               are scaled cosines near 0, which magnify the features'
               bf16 differences); (d) each served tower's
               forward per bucket and the kernels of a bucket-32 forward,
               with images/s. The checkpoints stay for phase 13.
13. zero-shot -- classification and offline evaluation over phase 12's
               checkpoints, every path through the kernels and then under
               the plain versions, each path's launches counted (the text
               tower once a label set, CLIP's causal; an image batch
               12 flash and 26 LayerNorm for CLIP, 13 and 24 for SigLIP,
               12 and 25 for ViT): (a) ``serve --ckpt DIR --model clip``
               (then ``siglip``, a shorter run) answers /v1/classify for
               two label sets of 10 labels x 7 templates (70 rows of 77
               tokens from a synthetic vocabulary in the real layout,
               written next to the CLIP checkpoint): the first request of
               a set ``"cached": false``, every repeat true; the class
               weights (row cosine >= 0.999), the image features (cosine
               >= 0.999, norms within 1%) and the logits (within eps, below)
               against the plain versions, the served scores' logits within
               2 eps; images/s, p50/p99 and the cache's counters; (b)
               ``classify`` through ``cli.classify_image`` on a decoded
               uint8 image: CLIP ``--ensemble`` with the checkpoint's own
               vocabulary, SigLIP ``--tokens-file``, each call twice (the
               second cached), logits within eps of the plain versions';
               the CLI on a PNG file where Pillow exists; (c) ``evaluate``
               (``cli.Evaluation``) at batch 32 over 256 raw 64 x 64
               examples: ViT-B/16-224 top-1, CLIP-B/16 ``--zero-shot`` (a
               classes.json of 10 classes, 70 prompt rows) and
               SigLIP-B/16-256 retrieval R@1 (64-token rows), and ViT over
               a WebDataset .tar shard where Pillow exists: every logit
               within eps = 2^-6 S + u of the plain pass's (S
               exp(logit_scale), or the largest |logit| for ViT's head; u
               one bf16 step of the largest |logit| where the logits leave
               the model in bf16), a top-1 moved only where the plain
               top-1/top-2 margin is under 2 eps, the share of such
               examples printed, examples/s and the reader's share of the
               wall time; (d) ``evaluate --naflex`` of a SigLIP2-B/16-256
               checkpoint written here, 75 examples of mixed aspect (13
               masked and 12 unmasked flash, 48 LayerNorm a batch), as
               (c).
14. training, rest -- full width and depth, bf16, fused LayerNorm: (a) one
               SigLIP-B/16-256 step (forward and backward, batch 128) from
               the same weights and batch under each ``--remat`` policy
               (none, full, dots, dots+ln, dots+act, dots+ln+act,
               dots+attn with the saveable impl): loss and every gradient
               equal to the no-remat step's bit for bit (a gradient that
               two no-remat runs already disagree on is named and held
               to twice that run-to-run distance), LayerNorm and flash
               launches as ``REMAT_LAUNCHES`` predicts, the activation
               peak (``max_memory_allocated`` over what was allocated
               before) falling none > dots+ln+act > dots > full and
               dots+ln+act > dots+ln > dots (``REMAT_MEMORY_CHAINS``),
               the median wall time of three steps; SigLIP-L/16-256 at
               batch 128 under none, dots and full and at batch 384 (no
               remat would not fit) under dots and full, peaks gated in
               that order and wall times printed; one SigLIP2 NaFlex step
               under dots (rows 4 and 7-mask kept, not rerun) and one
               fp8_hybrid step under full whose amax histories and
               gradients equal the no-remat step's; (b) dropout 0.1 set
               through the config: a step trains, ``eval()`` is the rate-0
               model bit for bit, one mask keeps 0.9 within 6 binomial
               sigma, full remat with dropout gives the no-remat gradients
               bit for bit; (c) ``train --moment-dtype bf16`` (f32
               parameters), every ``exp_avg`` bf16, the optimizer state's
               bytes beside f32 moments'; (d) ``train --preset
               vit-base-patch16-224 --num-classes 1000`` at batch 128, then
               ``--from-pretrained`` phase 12's ViT-B/16 checkpoint with
               ``--num-classes 10`` (a fresh head); (e) ``train --preset
               clip-vit-base-patch16`` at batch 128 (12 causal flash each
               way in the text tower); (f) ``train --preset
               vit-temporal-base-patch16-224-f8`` at batch 32 (1568-token
               clips), without remat and with ``--remat dots``, both peaks
               printed. Each command runs in-process, its launches counted
               per step.
15. resilience -- phase 5's train command (SigLIP-B/16-256, bf16, batch
               128) for 6 steps with ``--save-every 1 --batch-fingerprint``
               and a fresh ``--ckpt-dir`` each run, in-process: (a) the
               uninterrupted control run, then ``--inject-faults crash@2``
               and ``--resume``, whose steps 3-5 must equal the control's
               losses and batch fingerprints bit for bit, whose newest
               ``model.safetensors`` must hash (SHA-256) as the control's,
               and which must launch rows 1, 2, 3 and 7 for exactly its 3
               steps (no replay); (b) ``supervise --max-restarts 2 -- train
               ... --inject-faults preempt@2 --grace-steps 1`` (a real
               SIGTERM, the grace-window save overlapping step 3): steps
               [0, 1, 2, 3, 3, 4, 5] equal to the control's, the
               ``resilience:`` line with a restart, a preemption and lost
               work; (c) ``corrupt@2,crash@2`` then ``--resume``: step 2
               quarantined, the run resumed from step 1, steps 2-5 equal
               to the control's; (d) the checkpoint's bytes, the save's
               host copy and background write, the time to resume (each
               successful restore, and the replay of the synthetic
               generator up to the resumed step), the corruption drill's
               fall-back restore apart, and the ``checkpoint`` goodput
               bucket against the step time; the replay (the
               generator's draws alone) beside the same batches built in
               full.
16. data    -- ``train --data`` at phase 5's width (SigLIP-B/16-256, bf16,
               fused LayerNorm, batch 128) over 1024 raw 288 x 320
               image-text TFRecord records written here (resized to 256
               on the host by the native library), in-process, each
               command launching rows 1, 2, 3 and 7 for exactly its steps:
               (a) ``--loader records --shuffle-buffer 256``, 6 steps,
               each step's batch fingerprint equal to the same reader's
               alone on the host, its data_wait share and images/s beside
               phase 5's synthetic command; (b) ``--loader grain
               --data-workers 8`` (the indexed loader's worker processes),
               its fingerprints equal to the loader's own epoch, which
               covers each record once (per-example fingerprints), and its
               prefetch waits; (c) for each loader, ``--inject-faults
               crash@3`` with a save every step, then ``--resume``: steps
               4-5 equal (a)'s or (b)'s losses and fingerprints bit for
               bit, and the time to resume (restore + fast-forward); (d)
               ViT-B/16 from PNG tar shards whose classes.json sets the
               head's width (where libpng or Pillow decodes), and
               ``--naflex`` SigLIP2-B/16-256 from records of four aspects
               with phase 6's masked launches a step; (e) the prefetcher
               (pinned staging, side-stream copies) against synchronous
               copies over 256 nested batches, bit for bit, the consumer's
               stream held busy; (f) native preprocessing of 128 raw
               images against its numpy version (1e-6), both timed, and
               whether the library has its image codecs.
17. profiling -- (a) ``train --profile-dir D --tensorboard-dir T`` at
               phase 5's width and batch, 6 steps, in-process: the
               ``torch.profiler`` capture of steps 2-4 must hold device
               kernels (three empty tries, each printed, fail the phase),
               ``profile-analyze D`` (``op_stats``) must count as many
               launches of rows 1, 2, 3 and 7 as the launch counters over
               the same steps; the steps' device-busy share and the host's
               split (runtime launch calls, other operators, gaps) are
               printed, and T read back (CRCs checked) must hold the
               JSONL's losses; (b) ``--prof-ring R --prof-every 2
               --prof-window 1`` for 12 steps with a byte budget of (a)'s
               capture: 5 window captures, some evicted, the ring within
               its budget, no ``.tmp`` left, ``obs prof ls/show/diff`` over
               them, and the median step with the ring on and off beside
               ``jimm_prof_overhead_seconds_total``; (c) ``serve --prof-dir
               P`` (SigLIP-B/16-256, bf16, fused LayerNorm): ``POST
               /admin/prof/trigger`` with a cid under a bulk request of 32,
               the timer's deep capture must carry the cid and hold rows 1
               and 3, the ``jimm_hbm_*`` rows must come from the allocator
               with ``model_pool`` the model's parameter and buffer bytes;
               then the host's split of the bucket-32 forward; (d)
               ``save_quantized`` of phase 12's SigLIP-B/16-256 checkpoint,
               re-quantized from its dequantized state bit for bit, and
               ``obs timeline`` over the phase's journal, the ring's
               captures and (b)'s goodput report, validated.
18. parallel -- two ranks on the one card over gloo (this script again,
               ``--rank-task runs``, under ``python -m
               torch.distributed.run``, one launch for phases 18 and 19's
               two-rank runs, one after another in one process group;
               any rank's non-zero exit fails the phase), SigLIP-B/16-256
               width, bf16: (a) the seqpar ring (softmax, masked with
               key lengths crossing the shard boundary, sigmoid), Ulysses
               and the causal zigzag ring at q (64, 256, 12, 64), 128
               tokens a rank, forward and backward, each rank's chunks
               against the unsharded kernels' and the plain versions'
               (phase 3's bf16 cosine, and two bf16 steps of the largest
               value: each hop's output is rounded to bf16 before the
               merge, one rounding more), with their launches (rows 3, 4, 6,
               7 through ``ring_hop_fwd`` / ``ring_hop_bwd``) and times;
               (b) ``train --mesh data=2 --rules dp`` (``siglip_ring``) and
               ``--rules fsdp`` (saving step 0), phase 5(c)'s command at
               batch 128: each step's loss within one bf16 step of phase
               5(c)'s, step 0's gradient norm of every parameter (after
               the ranks' average) within 5e-2 of phase 5(c)'s (0.15
               under sp, whose hops round dq before they are summed), each
               rank's launches those of a 64-row step; (c) ``--mesh
               seq=2 --rules sp`` at batch 32, attention through the
               ring's hops (two a block), held the same way to the single
               process at batch 32; (d)+(e) (b)'s fsdp checkpoint
               resumed in this process as ``--mesh data=1 --rules fsdp``,
               one rank over NCCL: its losses within one bf16 step of
               (b)'s run, one topology change. Prints each run's median
               step, the backend, the ring bytes and each rank's peak
               memory; the kernels' record gains the ``mesh*`` paths
               (rank 0's launches).
19. model and stage axes -- phase 18's launcher and gates, SigLIP-B/16-256
               at full width and depth, bf16, phase 5(c)'s command: (a)
               ``--mesh data=1,model=2 --rules tp`` at batch 32, held to
               the single process at batch 32 (two ranks, each on its
               slices: q/k/v and fc1 column-parallel, the attention on 6
               of the 12 heads, out and fc2 row-parallel); (b) ``--mesh data=1,stage=2 --rules pp``
               with 4 microbatches, and again with ``--pipeline-virtual
               2`` (saving step 0); (c) ``--mesh data=2,model=2 --rules
               fsdp_tp``, four ranks (a launch of its own), at batch 32
               as (a); (d) (b)'s V = 2 checkpoint resumed
               in this process as ``--mesh data=1``, one rank over NCCL
               (one topology change, its losses within one bf16 step of
               (b)'s). Each run's losses within one bf16 step of phase
               5(c)'s, step 0's whole gradient norms (slices and blocks
               gathered) within 5e-2 of phase 5(c)'s, each rank's launches
               of rows 3/7/1/2 those of a step (25/25/48/48 under the model
               axis; 49/49/96/96 under pp: each stage's 6 blocks a tower
               on 4 microbatches, the MAP probe once); the record gains the
               ``mesh_tp``, ``mesh_pp``, ``mesh_pp_v2``, ``mesh_fsdp_tp``
               and ``mesh_pp_resume`` paths.
20. quantized mesh and drills -- phase 18's launcher, the same command at
               batch 32, each run held to the single process's at batch
               32 made in this process: (a) ``--precision fp8_hybrid
               --mesh data=2 --rules dp``: the amax histories equal on
               both ranks at every step, the first blocks' equal the
               single process's bit for bit after step 0, 151
               gradient-amax all-reduces and one amax sync a rank a step;
               (b) fp8_hybrid and int8_qk under ``tp``, int8_qk under
               ``pp``, launches of rows 9, 10 and 12 a rank a step
               counted (the quantized runs at ``--lr 0``: a free step
               flips roundings; each rank's step-0 gradient norms within
               5e-2 of the single process's, which holds the quantized
               backward); (c) ``supervise --elastic --shrink-plan
               2,1 --adapt`` crashing at step 2 on both ranks and resuming
               on rank 0 alone (one restart and replan on each rank, one
               topology change, the attempts' walls and the restore);
               (d) a SIGTERM to rank 0 at step 2 saving step 2 on both
               ranks, then the resume; (e) the times of the agreement and
               amax collectives. Losses within one bf16 step throughout;
               the record gains the ``q_*`` paths.
21. serving replicas -- SigLIP-B/16-256 at full width, fused LayerNorm,
               buckets (1, 8, 32), the card listed twice: (a) ``serve
               --device cuda:0,cuda:0 --replicas 2 --self-heal --dtype
               bf16`` through ``cli.build_server`` (a model copy, a CUDA
               stream and an executor a replica), phase 4's traffic sent by
               the stdlib ``ServeClient`` in turns with a one-replica
               server over the same model (one, two, two, one): phase 4's
               gates on every run (13 flash and 24 LayerNorm launches per
               batch summed over the replicas), each replica at least 30%
               of a two-replica run's batches, /metrics with every
               replica's dispatch counter and the phase percentiles,
               /debug/traces naming both replicas and read by ``obs tail
               --traces``; images/s and p50/p99 of both; (b) the library
               path with replica 1 wrapped to fail on command: two faults
               restart, then fence it (healthz degraded), ``POST
               /admin/revive`` un-fences it; a lasting fault: the probe
               fails, the rebuild and replan bring back two live lanes, the
               requests sent as the replan begins are answered (phase 4's
               gate), the journal chains fault, fence, probe, rebuild and
               replan on one cid; the heal and replan seconds; (c)
               ``--dtype int8 --replicas 2``: 78 int8-matmul launches per
               batch summed over both replicas, both dispatching, answers
               against the plain versions and at cosine >= 0.999 against
               the f32 twin. The record gains the ``replicas`` and
               ``replicas_int8`` paths. ``python3 chip_smoke.py --phase
               21`` runs the build and this phase alone.
22. wide     -- serving replicas wider than one device and tenant QoS: (a)
               ``serve --device cuda:0,cuda:0,cuda:0,cuda:0`` with
               ``--model-parallel k --seq-parallel s`` at (1, 2, 1), (1,
               1, 2) and (1, 2, 2), each replica an in-process mesh (a
               copy, a stream and a thread a position), phase 4's traffic
               and gates, the launches a batch summed over the positions
               (``WIDE_PLANS``), every answer at cosine >= 0.999 against
               the single-device model; a drill in which one position of
               one of two (1, 2, 1) replicas fails for good: the call
               raises at once, the lane is fenced, the heal rebuilds and
               the replan serves; (b) ``--qos-policy`` with two tenants in
               two classes and ``--pool-model twin=...@int8``: the
               rate-limited tenant alone gets 429 with Retry-After, the
               twin answers through the int8 matmul (78 launches a batch)
               at cosine >= 0.999 against f32, /metrics carries the QoS
               series. The record gains the ``wide_121``, ``wide_112``,
               ``wide_122`` and ``pool_twin`` paths. ``python3
               chip_smoke.py --phase 22`` runs the build and this phase
               alone.

Phase 3's flash cases include row 3's causal kind at CLIP-B/16's text
shapes, (32, 77, 8, 64) and the 70 prompt rows of one label set (70, 77,
8, 64), timed beside SDPA with ``is_causal=True``; and, in bf16, rows 3 and
7 at CLIP-B/16's training text shape (128, 77, 8, 64), causal, and at the
temporal ViT's (32, 1568, 12, 64), with its MAP probe (32, 1, 12, 64)
against 1568 keys. Phase 3 also holds the
int8 kernels (rows 9, 10 and 11) against their plain
versions: the int8 matmul at the served shapes and odd ones, with bias,
relu and gelu (yardstick: ``torch._int_mm`` and the epilogue as torch ops);
the int8-QK flash forward and backward at the train shapes and odd ones
(yardstick: SDPA on the dequantized q and k in the storage dtype). And the
fp8 GEMM (row 12) at the three GEMMs of every Linear of the train step
(forward e4m3 x e4m3, dx and dw e5m2 x e4m3; image M = 32768, text 8192,
probe 128 token rows; (K, N) = (768, 3072), (768, 768), (3072, 768)), the
odd shapes and a base off a 16-byte boundary (through the wrapper's
K-padded copies), within ``fp8_matmul.gemm_error_bound`` (the tensor
core's truncated f32 sums, relative to the sum of absolute products) and
with its epilogue bit for bit, plus a case that fails unless the sums keep
f32's bits (yardstick: ``torch._scaled_mm`` on the same fp8 operands, dims
zero-padded to 16, without the bias); the sigmoid flash forward and
backward (row 6, row 7's sigmoid kind) at the train shapes and odd ones,
masked and causal, where a row with no key must be exactly zero (no single
PyTorch call computes sigmoid attention: no yardstick); and the biased flash
forward, backward and dbias (rows 5, 7's bias kind, 8) at the train shapes
with a (12, Sq, Sk) bias and odd ones: seq 1, 5 and 257, D 80 and 256,
causal, a broadcast (Sq, Sk) bias, and a bias with -inf entries whose row
with no finite key must give o = 0 and zero gradients (yardstick: SDPA with
the bias as a float attn_mask, the causal triangle folded in; for the
backward and dbias, its backward with the mask requiring grad).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import base64
import copy
import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import urllib.request
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from jimm_tpu_torch import _build, cli, configs, obs
from jimm_tpu_torch.data import native, preprocess, records
from jimm_tpu_torch.data.clip_tokenizer import CLIPTokenizer, bytes_to_unicode
from jimm_tpu_torch.data.grain_pipeline import grain_batches, make_grain_loader
from jimm_tpu_torch.data.pipeline import PrefetchIterator, place
from jimm_tpu_torch.data.records import (write_classification_records,
                                         write_image_text_records)
from jimm_tpu_torch.data.synthetic import (contrastive_pairs,
                                            naflex_contrastive_pairs)
from jimm_tpu_torch.data.webdataset import write_wds_shard
from jimm_tpu_torch.models.siglip import SigLIP
from jimm_tpu_torch.nn import norm as norm_mod
from jimm_tpu_torch.obs.prof.capture import (list_captures, profiler_session,
                                             reset_capture)
from jimm_tpu_torch.obs.prof.opstats import (capture_summary,
                                             load_trace_events, op_table,
                                             render_summary)
from jimm_tpu_torch.ops import attention as attention_mod
from jimm_tpu_torch.ops import flash_attention as fa
from jimm_tpu_torch.ops import flash_attention_int8 as fa8
from jimm_tpu_torch.ops import fp8_matmul as fp8
from jimm_tpu_torch.ops import int8_matmul as mm
from jimm_tpu_torch.ops import layer_norm as ln
from jimm_tpu_torch.quant import policy as fp8_policy
from jimm_tpu_torch.quant.policy import apply_precision_policy
from jimm_tpu_torch.parallel import comm
from jimm_tpu_torch.resilience import PreemptedError
from jimm_tpu_torch.serve.admission import AdmissionPolicy
from jimm_tpu_torch.serve.buckets import BucketTable
from jimm_tpu_torch.serve.cache import EmbeddingCache
from jimm_tpu_torch.serve.client import ServeClient, ServeClientError
from jimm_tpu_torch.serve.engine import InferenceEngine, image_forward
from jimm_tpu_torch.serve.server import ServingServer
from jimm_tpu_torch.serve.topology import build_replica_forwards, plan_topology
from jimm_tpu_torch.obs.timeline import validate_chrome_trace
from jimm_tpu_torch.train.metrics import (mfu, read_event_file,
                                          train_step_flops)
from jimm_tpu_torch.train.profile import annotate, op_stats
from jimm_tpu_torch.train.trainer import (OptimizerConfig, contrastive_loss_fn,
                                          make_contrastive_train_step,
                                          make_optimizer)
from jimm_tpu_torch.utils.zero_shot import (TEMPLATES, token_table_rows,
                                            weights_from_rows)
from jimm_tpu_torch.weights.quantize import (dequantize_state_dict,
                                             quantize_state_dict,
                                             save_quantized)
from jimm_tpu_torch.weights.resolve import resolve_checkpoint
from jimm_tpu_torch.weights.safetensors_io import load_file

#: H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12
PEAK_FP8_FLOPS = 1979e12
F32_MAX_ERR = 1e-4
BF16_MIN_COS = 0.999
BF16_REL_ERR = 2.0**-7  # one bf16 step relative to the largest value
#: a bf16 reference that is zero up to rounding (attention over one key):
#: both sides return ~1e-7 there on the card
ZERO_REF_ABS_ERR = 1e-5
SERVE_MIN_COS = 0.999
SERVE_NORM_RTOL = 1e-2
FLASH_PER_BATCH = 13   # 12 encoder blocks + the MAP probe
LN_PER_BATCH = 24      # ln1 + ln2 of 12 blocks (ln_post, head ln: plain LN)
FLASH_PER_STEP = 25    # 12 vision blocks + the MAP probe + 12 text blocks
LN_PER_STEP = 48       # ln1 + ln2 of 24 blocks (ln_post, head, ln_final: plain)
TRAIN_GRAD_REL_ERR = 1e-3
NAFLEX_PRESET = "siglip2-base-patch16-256"
NAFLEX_MASKED_PER_STEP = 13   # 12 vision blocks + the MAP probe, masked
NAFLEX_FLASH_PER_STEP = 12    # 12 text blocks, unmasked
NAFLEX_SERVE_BATCH = 32
#: the train image shape of rows 3-10 (the masked kinds with the NaFlex
#: masks, the biased ones with a (12, 256, 256) bias), fc1's forward for
#: row 12
TRAIN_IMAGE = "q(128, 256, 12, 64) sk=256"
NAFLEX_IMAGE = "q(128, 256, 12, 64) sk=256 naflex"
FC1_FORWARD = "(32768, 768) x (3072, 768)^T +bias"
#: the redesigned rows' first (CUDA-core, FMA) versions, as PERF.md's
#: kernel table records them (NVIDIA H100 80GB HBM3, 700.00 W), by kernel:
#: (shape, ms): rows 3-7 (every kind), 8, 9, 10, 11 and 12, now on tensor
#: cores, and rows 1 and 2, now one warp a row
FMA_VERSION_MS = {
    "layer_norm": ("(32768, 768)", 0.0715),
    "layer_norm_bwd": ("(32768, 768)", 0.1241),
    "int8_matmul": ("(8192, 3072) x (3072, 768)", 0.3837),
    "flash_attention": (TRAIN_IMAGE, 1.2623),
    "flash_attention_masked": (NAFLEX_IMAGE, 1.0818),
    "flash_attention_bias": (TRAIN_IMAGE, 1.3805),
    "sigmoid_attention": (TRAIN_IMAGE, 1.0930),
    "fp8_matmul": (FC1_FORWARD, 3.7083),
    "flash_attention_bwd": (TRAIN_IMAGE, 3.9728),
    "flash_attention_masked_bwd": (NAFLEX_IMAGE, 4.1322),
    "sigmoid_attention_bwd": (TRAIN_IMAGE, 3.7372),
    "flash_attention_bias_bwd": (TRAIN_IMAGE, 4.1653),
    "flash_attention_int8": (TRAIN_IMAGE, 0.9121),
    "flash_attention_dbias": (TRAIN_IMAGE, 2.2143),
    "flash_attention_int8_bwd": (TRAIN_IMAGE, 3.5000)}
#: the times PERF.md records for rows 3-6 and 12 on tensor cores, which a
#: change to their shared headers (flash_mma.cuh, hopper_tma.cuh) must
#: leave within 5%, and for rows 1, 2 and 11 as redesigned
RECORDED_MS = {
    "flash_attention": (TRAIN_IMAGE, 0.2272),
    "flash_attention_masked": (NAFLEX_IMAGE, 0.2620),
    "flash_attention_bias": (TRAIN_IMAGE, 0.3099),
    "sigmoid_attention": (TRAIN_IMAGE, 0.2740),
    "fp8_matmul": (FC1_FORWARD, 0.4046),
    "layer_norm": ("(32768, 768)", 0.0380),
    "layer_norm_bwd": ("(32768, 768)", 0.0573),
    "int8_matmul": ("(8192, 3072) x (3072, 768)", 0.0452)}
#: the kernels that must run on tensor cores, by a substring of their
#: mangled names, and the SASS instructions each must contain: f16 wgmma
#: (the fp8 GEMM's, on operands widened in shared memory) assembles to
#: HGMMA, s8 wgmma (the int8 matmul's) to IGMMA, bf16 mma.sync to HMMA, s8
#: mma.sync to IMMA
TENSOR_CORE_KERNELS = {"fp8_matmul_kernel": ("HGMMA",),
                       "int8_matmul_kernel": ("IGMMA",),
                       "flash_fwd_mma_kernel": ("HMMA",),
                       "flash_bwd_dq_mma_kernel": ("HMMA",),
                       "flash_bwd_dkv_mma_kernel": ("HMMA",),
                       "flash_int8_fwd_mma_kernel": ("IMMA", "HMMA"),
                       "flash_int8_bwd_dq_mma_kernel": ("IMMA", "HMMA"),
                       "flash_int8_bwd_dkv_mma_kernel": ("IMMA", "HMMA"),
                       "flash_dbias_mma_kernel": ("HMMA",)}
#: the LayerNorm register bodies (one warp a row) keep rows in registers:
#: every instantiation of the backward's must use no local memory (spills;
#: its widest rows, 2048 as the forward's, are set by this), the forward's
#: is printed
REGISTER_BODY_KERNELS = {"layer_norm_bwd_register_kernel": True,
                         "layer_norm_fwd_register_kernel": False}
#: the bf16 twins of the f32 gradient checks (5(a), 6(a), 8(a), 10(a)): each
#: parameter's gradient within 2^-3 of its largest value (or of 2^-4 of the
#: model's largest, for a gradient under that floor: the k-projection bias,
#: zero in exact arithmetic, is rounding noise on both sides), and, above
#: the floor, a cosine of at least 0.99 (PERF.md section 6 gives the
#: reasoning, written before the first run that checked it)
BF16_GRAD_REL_ERR = 2.0**-3
BF16_GRAD_FLOOR = 2.0**-4
BF16_GRAD_MIN_COS = 0.99
#: and on top of those, each parameter's gradient held to its own size: with
#: t the gradient of the same step in f32 through the plain versions (the
#: bf16 parameters and inputs widened exactly), ||g_kernel - t|| <=
#: BF16_GRAD_NORM_R ||g_plain - t|| + BF16_GRAD_NORM_EPS ||t||, 2-norms over
#: the parameter, g_plain the bf16 step through the plain versions of the
#: kernels' own algorithm (the flash Functions kept: delta from the stored
#: o): the kernel step may be at most twice as far from f32 as the plain
#: bf16 step, plus a slack for the roundings the kernels add. PERF.md
#: section 6 gives the derivation (written before the first run that
#: checked it) and its correction after that run. Not for the
#: k-projection biases under softmax attention (zero in exact arithmetic)
#: nor one-element parameters: they stay on the floor.
BF16_GRAD_NORM_R = 2.0
BF16_GRAD_NORM_EPS = 2.0**-6
#: int8 serve: 12 blocks x 6 Linears (q, k, v, out, fc1, fc2) and the MAP
#: head's q, k, v, out, fc1, fc2 run on the int8 matmul per batch; the
#: model quantizes 151 Linears (the text tower's 72 and its projection too)
INT8_MATMUL_PER_BATCH = 78
INT8_QUANTIZED = 151
#: (M, K, N) off the tile grid (tests/test_int8_ops.py ODD_MATMUL_SHAPES)
ODD_MATMUL_SHAPES = [(1, 7, 5), (5, 100, 33), (33, 64, 128), (257, 769, 129),
                     (16, 768, 768)]
#: fp8_hybrid: 12 + 12 blocks x 6 Linears, the MAP head's 6 and
#: text_projection; each runs one forward GEMM and two backward (dx, dw)
FP8_LINEARS = 151
FP8_HIST_RTOL = 1e-4
#: the fp8 GEMM's (K, N) per Linear: fc1, q/k/v/out, fc2
FP8_KN = [(768, 3072), (768, 768), (3072, 768)]
TRAIN_BATCH = 128
#: 10(b)'s learning rate: at 1e-3 (the other phases') the sigmoid-attention
#: SigLIP's loss on one fixed batch oscillates between ~6 and ~26 from step
#: 3 on, in the plain versions as through the kernels, so whether step 12
#: lands below step 0 is chance; at 1e-4 it falls step by step (PERF.md,
#: section 6)
SIGMOID_LEARNING_RATE = 1e-4
TRAIN_WARMUP = 3
TRAIN_STEPS = 10
CLI_STEPS = 5
NAFLEX_TRAIN_STEPS = 5
#: phase 11: SigLIP-B/16's vision blocks, one biased attention each
BIAS_CALLS = 12
#: phase 12: the full-width checkpoint of each family
CKPT_PRESETS = {"vit": "vit-base-patch16-224", "clip": "clip-vit-base-patch16",
                "siglip": "siglip-base-patch16-256"}
#: per served batch of the CLS towers: 12 blocks' attention (no MAP probe),
#: and the blocks' ln1 and ln2 plus ln_post (ViT) and ln_pre (CLIP), which
#: follow ln_impl in a CLS tower
CKPT_FLASH_PER_BATCH = 12
CKPT_LN_PER_BATCH = {"vit": 25, "clip": 26}
#: CLIP-B/16's text tower: 12 causal flash launches and 24 fused LayerNorms
#: (ln_final stays nn.LayerNorm) per encode_text at (32, 77)
CLIP_TEXT_SHAPE = (32, 77)
CLIP_TEXT_FLASH = 12
CLIP_TEXT_LN = 24
#: phase 14: the LayerNorm and flash forwards a SigLIP-B/16-256 step
#: launches under each --remat spec (PERF.md section 6): full
#: recomputes every block (48 LayerNorms and 24 flash calls again; the MAP
#: probe is outside the blocks), every "dots" set keeps flash o and lse and
#: reruns the LayerNorms unless "+ln" keeps them; dots+attn runs the
#: saveable impl in both towers and the probe (no flash kernel)
REMAT_LAUNCHES = {"none": (48, 25), "full": (96, 49), "dots": (96, 25),
                  "dots+ln": (48, 25), "dots+act": (96, 25),
                  "dots+ln+act": (48, 25), "dots+attn": (96, 0)}
#: 14(a)'s activation peaks must fall along each chain
REMAT_MEMORY_CHAINS = (("none", "dots+ln+act", "dots", "full"),
                       ("dots+ln+act", "dots+ln", "dots"))
#: timed steps a remat policy's model runs after its warm step (the median
#: is printed)
REMAT_TIMED_STEPS = 3
#: 14(a)'s wider check: whether a "dots" set beats full remat on wall time
#: once the device time outgrows the host's (printed, not gated), at
#: SigLIP-L/16-256's batch 128 and at 384, where no remat would not fit
#: (batch -> the specs run, their peaks falling in this order)
REMAT_WIDE_PRESET = "siglip-large-patch16-256"
REMAT_WIDE_RUNS = {128: ("none", "dots", "full"), 384: ("dots", "full")}
#: Linears inside the blocks: rerun under full remat (fp8_hybrid)
FP8_BLOCK_LINEARS = 144
#: phase 15: phase 5's train command (SigLIP-B/16-256, bf16, fused
#: LayerNorm, batch 128) for 6 steps with a save every step
RESILIENCE_STEPS = 6
RESILIENCE_ARGV = ["train", "--preset", "siglip-base-patch16-256", "--bf16",
                   "--ln-impl", "fused", "--batch-size", str(TRAIN_BATCH),
                   "--steps", str(RESILIENCE_STEPS), "--save-every", "1",
                   "--log-every", "1", "--batch-fingerprint"]
#: the checkpoint and resume spans phase 15(d) reads
CKPT_SPANS = ("checkpoint_save", "checkpoint_host_copy", "checkpoint_write",
              "checkpoint_restore", "resume_fast_forward")
#: phase 16: the file-dataset train command (phase 5's, SigLIP-B/16-256,
#: bf16, batch 128) over raw 288 x 320 image-text records, resized to 256
#: on the host; a crash after step DATA_CRASH's checkpoint; the indexed
#: loader's worker processes
DATA_EXAMPLES = 1024
DATA_SHARDS = 8
DATA_HW = (288, 320)
DATA_STEPS = 6
DATA_CRASH = 3
DATA_WORKERS = 8
#: SigLIP-B/16-256's image side and text length, as its readers take them,
#: and the token ids of SigLIP's and SigLIP2's vocabularies
DATA_IMAGE = 256
DATA_SEQ = 64
DATA_VOCAB = 32000
NAFLEX_VOCAB = 256000
DATA_ARGV = ["train", "--preset", "siglip-base-patch16-256", "--bf16",
             "--ln-impl", "fused", "--batch-size", str(TRAIN_BATCH),
             "--steps", str(DATA_STEPS), "--log-every", "1",
             "--batch-fingerprint", "--shuffle-buffer", "256"]
#: 16(d): SigLIP2 NaFlex records of four aspects, and ViT-B/16 tar shards
#: of PNG images with a classes.json
NAFLEX_DATA_EXAMPLES = 256
NAFLEX_DATA_SIZES = ((192, 384), (256, 256), (384, 192), (160, 400))
NAFLEX_DATA_STEPS = 2
TAR_EXAMPLES = 64
TAR_HW = (256, 288)
TAR_CLASSES = 10
TAR_BATCH = 32
TAR_STEPS = 2
#: 16(e): nested host batches through the prefetcher
PREFETCH_BATCHES = 256
PREFETCH_ROWS = 32
DROPOUT_RATE = 0.1
VIT_CLASSES = 1000
FINETUNE_CLASSES = 10
FINETUNE_STEPS = 2
TEMPORAL_PRESET = "vit-temporal-base-patch16-224-f8"
TEMPORAL_BATCH = 32
TEMPORAL_STEPS = 3
#: launches per step of the train command's paths in 14(c)-(f): flash
#: (each way), LayerNorm forward and backward, causal flash forwards.
#: SigLIP-B/16-256 as phase 5; ViT-B/16 12 flash and 25 LayerNorm (ln_post
#: follows ln_impl in a CLS tower); CLIP-B/16 24 flash (the text tower's 12
#: causal) and 50 LayerNorm (26 vision, 24 text: ln_final stays
#: nn.LayerNorm); the temporal ViT 13 flash (the MAP probe) and 24
#: LayerNorm, whose forwards "dots" reruns
FAMILY_STEP = {"siglip": (25, 48, 48, 0), "vit": (12, 25, 25, 0),
               "clip": (24, 50, 50, 12), "temporal": (13, 24, 24, 0),
               "temporal_dots": (13, 48, 24, 0)}
#: phase 13: the label sets of 13(a) (10 labels x the 7 TEMPLATES = 70
#: prompt rows at 77 tokens each), of 13(b) and of 13(c)'s classes.json,
#: each its own so that no part finds another's class weights cached
ZS_LABEL_SETS = (
    ("cat", "dog", "bird", "fish", "horse", "frog", "ship", "truck",
     "plane", "deer"),
    ("apple", "pear", "plum", "lemon", "melon", "grape", "peach", "lime",
     "fig", "date"),
    ("oak", "pine", "elm", "ash", "birch", "maple", "cedar", "fir",
     "yew", "palm"),
    ("red", "blue", "green", "black", "white", "gray", "pink", "brown",
     "gold", "teal"))
#: 13(a): single requests per label set, the first alone, the rest from
#: 16 client threads (SigLIP's run is the shorter one)
ZS_REQUESTS = {"clip": (48, 16), "siglip": (16, 8)}
#: per-batch launches of the image towers (CLIP: 12 flash, the blocks' 24
#: LayerNorms with ln_pre and ln_post; SigLIP: 12 blocks and the MAP
#: probe, 24 LayerNorms) and per encode_text of the text towers (12
#: flash, causal in CLIP's, and 24 LayerNorms; ln_final stays
#: nn.LayerNorm)
IMAGE_LAUNCHES = {"vit": (12, 25), "clip": (12, 26), "siglip": (13, 24)}
TEXT_LAUNCHES = (12, 24)
#: 13(c): examples a dataset, 64 x 64 raw images read back and resized
#: to each model's size, at evaluate's batch of 32; 13(d): NaFlex images
#: of mixed aspect, 75 examples (the last batch of 11)
EVAL_EXAMPLES = 256
EVAL_BATCH = 32
EVAL_IMAGE = 64
NAFLEX_EVAL_EXAMPLES = 75
NAFLEX_EVAL_SIZES = ((48, 96), (64, 64), (96, 48), (40, 120), (80, 64))
#: 13(c), (d): the bound on a logit's error through the kernels against
#: the plain versions, eps = 2^-6 S + u, where S is exp(logit_scale)
#: (CLIP, SigLIP) or the largest |logit| of the plain pass (ViT's head),
#: and u one bf16 step of that largest |logit| where the logits leave the
#: model in bf16 (ViT, retrieval; the zero-shot logits are f32). An
#: example can change its top-1 only where the plain pass's top-1/top-2
#: margin is below 2 eps (PERF.md section 6 gives the derivation, written
#: before the first run that checked it)
LOGITS_EPS = 2.0**-6
#: the refusal of "flash" with a key-padding mask and a bias, word for word
#: as jimm_tpu/ops/attention.py raises it
FLASH_MASKED_BIAS_ERROR = ("flash_masked does not take a bias; use "
                           "impl='flash_bias' (bias only) or impl='xla'")


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int = 10, warmup: int = 3) -> float:
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


def device_ms(fn, iters: int = 10, warmup: int = 3) -> float:
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
        with profiler_session(cuda_only=True) as prof:
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


def bound_ms(nbytes: int, flops: float, dtype: torch.dtype,
             int8_ops: float = 0.0, fp8_flops: float = 0.0
             ) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate, or the
    float operations over the dtype's peak plus the int8 and fp8 ones over
    their peaks, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_FLOPS[dtype] + int8_ops / PEAK_INT8_OPS
             + fp8_flops / PEAK_FP8_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got: torch.Tensor, want: torch.Tensor
            ) -> tuple[float, float, float]:
    """Max abs error, cosine, and the largest reference magnitude."""
    got, want = got.float().flatten(), want.float().flatten()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    err = (got - want).abs().max().item()
    cos = F.cosine_similarity(got, want, dim=0).item()
    return err, cos, want.abs().max().item()


def within(dtype: torch.dtype, err: float, cos: float, peak: float,
           relative: bool = False) -> bool:
    """f32: max abs error (relative to the reference's scale, at least 1,
    when ``relative``: a gradient summed over 32768 rows is in the
    hundreds); bf16: cosine, and max abs error relative to the largest
    reference value, which a uniformly scaled output fails. A bf16
    reference that is zero up to rounding (attention over one key:
    dq = dk = 0) has no direction to compare: it is held to an absolute
    bound a hundred times the rounding seen there."""
    if dtype == torch.float32:
        return err <= F32_MAX_ERR * (max(1.0, peak) if relative else 1.0)
    if peak <= 1e-6:
        return err <= ZERO_REF_ABS_ERR
    return cos >= BF16_MIN_COS and err <= BF16_REL_ERR * peak + 1e-6


def grad_ms(outputs: torch.Tensor, inputs: tuple[torch.Tensor, ...],
            cotangent: torch.Tensor):
    """A call that runs the library's backward of ``outputs`` (kept graph)."""
    return lambda: torch.autograd.grad(outputs, inputs, cotangent,
                                       retain_graph=True)


# -- phase 3: kernels --------------------------------------------------------

def traced(fn, kernels: tuple[str, ...] = ()):
    """``fn()``'s result and the names of the kernels it launched, from a
    profiler trace (taken again, up to three times, when it comes back with
    no device rows, or with none of ``kernels`` where one must run: the
    trace can drop a kernel's record)."""
    for _ in range(3):
        with profiler_session(cuda_only=True) as prof:
            out = fn()
            torch.cuda.synchronize()
        names = [e.key for e in _device_rows(prof)]
        if names and (not kernels or any(_is_kernel(n, k) for n in names
                                         for k in kernels)):
            break
    return out, names


def _is_kernel(name: str, kernel: str) -> bool:
    """Whether the traced ``name`` is the template ``kernel``."""
    return kernel + "<" in name or kernel + "I" in name


def _offset_copy(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of ``x`` whose base is ``nbytes`` past a 16-byte
    boundary."""
    skip = nbytes // x.element_size()
    store = torch.empty(x.numel() + skip, dtype=x.dtype, device=x.device)
    store[skip:] = x.flatten()
    return store[skip:].view(x.shape)


def ln_case(rows: int, f: int, dtype: torch.dtype, seed: int,
            offset: bool = False) -> dict:
    """Row 1 against its plain version. ``ln.forward_body`` names the body
    the C entry picks by shape (the register body, one warp a row, or the
    CTA body); a trace of the call must show that body's kernel and not
    the other's. ``offset``: x 4 bytes past a 16-byte boundary."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, f, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    w = torch.randn(f, generator=g, device="cuda").to(dtype)
    b = torch.randn(f, generator=g, device="cuda").to(dtype)
    if offset:
        x = _offset_copy(x, 4)
    body = ln.forward_body(x, w, b)
    (y, mu, rstd), names = traced(lambda: ln.layer_norm_fwd(x, w, b, 1e-6),
                                  tuple(ln.FORWARD_KERNELS.values()))
    for kind, kernel in ln.FORWARD_KERNELS.items():
        check(any(_is_kernel(n, kernel) for n in names) == (kind == body),
              f"layer_norm ({rows}, {f}) {dtype}: forward_body says {body}, "
              f"the trace shows {names}")
    py, pmu, prstd = ln.layer_norm_plain(x, w, b, 1e-6)
    err, cos, peak = compare(y, py)
    stat_err = max(compare(mu, pmu)[0], compare(rstd, prstd)[0])
    check(within(dtype, err, cos, peak) and stat_err <= F32_MAX_ERR,
          f"layer_norm ({rows}, {f}) {dtype}: err {err} cos {cos} "
          f"stats {stat_err}")
    nbytes = sum(t.nbytes for t in (x, w, b, y, mu, rstd))
    bound, by = bound_ms(nbytes, 8.0 * rows * f, dtype)
    return {"shape": f"({rows}, {f})" + (" x at +4 B" if offset else ""),
            "dtype": str(dtype)[6:], "body": body,
            "max_abs_err": err, "cosine": cos,
            "ms": device_ms(lambda: ln.layer_norm_fwd(x, w, b, 1e-6)),
            "call_ms": cuda_ms(lambda: ln.layer_norm_fwd(x, w, b, 1e-6)),
            "plain_ms": device_ms(lambda: ln.layer_norm_plain(x, w, b, 1e-6)),
            "library_ms": device_ms(lambda: F.layer_norm(x, (f,), w, b,
                                                         1e-6)),
            "bound_ms": bound, "bound_by": by}


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """The same (B, S, N, D) values as a view whose base and head stride
    are off any 16-byte boundary, unit stride over D: the kernels' element
    by element loads."""
    b, s, n, d = x.shape
    store = torch.zeros(b, s, n, d + 3, dtype=x.dtype, device=x.device)
    store[..., 1:d + 1] = x
    return store[..., 1:d + 1]


def _unaligned_contiguous(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose base is 4 bytes past a 16-byte
    boundary (the int8 q and k the int8-QK kernels take contiguous)."""
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    flat[4:] = x.flatten()
    return flat[4:].view(x.shape)


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


_NAFLEX_MASKS: dict[int, torch.Tensor] = {}


def naflex_mask(batch: int) -> torch.Tensor:
    """The key-padding mask of the first ``naflex_contrastive_pairs`` batch
    of the SigLIP2-B/16-256 train command (256-token budget; grids 9x27,
    16x16, 27x9, 11x22 in turn), on the card."""
    if batch not in _NAFLEX_MASKS:
        cfg = configs.preset(NAFLEX_PRESET)
        (_, _, mask), _ = next(naflex_contrastive_pairs(
            batch, patch_size=cfg.vision.patch_size,
            max_num_patches=cfg.vision.num_patches,
            seq_len=cfg.text.context_length, vocab_size=cfg.text.vocab_size))
        _NAFLEX_MASKS[batch] = torch.from_numpy(mask).cuda()
    return _NAFLEX_MASKS[batch]


def key_mask(kind: str, b: int, sk: int, g: torch.Generator
             ) -> torch.Tensor:
    """(B, Sk) bool, True = attend: ``naflex``, the NaFlex train batches'
    masks; ``lenL``, an L-key prefix; ``sparse``, ~70% of keys padded;
    ``empty_row``, sparse with sample 1 fully padded."""
    if kind == "naflex":
        return naflex_mask(b)
    if kind.startswith("len"):
        cols = torch.arange(sk, device="cuda")
        return (cols < int(kind[3:]))[None, :].expand(b, sk).contiguous()
    m = torch.rand(b, sk, generator=g, device="cuda") > 0.7
    m[:, 0] = True
    if kind == "empty_row":
        m[1] = False
    return m


def attended(mask: torch.Tensor, sq: int, causal: bool) -> torch.Tensor:
    """(B, Sq, Sk) bool: the (query, key) pairs the key-padding mask and the
    causal triangle let through. Its sum is the work the inputs need; a
    query row with no pair gives finite garbage, checked for finiteness
    only. Also SDPA's boolean mask, with a head axis added."""
    keep = mask[:, None, :].expand(-1, sq, -1)
    if causal:
        keep = keep & torch.ones(sq, mask.shape[1], dtype=torch.bool,
                                 device="cuda").tril()
    return keep


def masked_flash_case(qshape: tuple[int, int, int, int], sk: int,
                      causal: bool, kind: str, dtype: torch.dtype,
                      seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, n, d = qshape
    q = torch.randn(b, sq, n, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, sk, n, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, sk, n, d, generator=g, device="cuda").to(dtype)
    mask = key_mask(kind, b, sk, g)
    o, lse = fa.flash_attention_lse(q, k, v, is_causal=causal, mask=mask)
    torch.cuda.synchronize()
    po, plse = fa.flash_attention_plain(q, k, v, is_causal=causal, mask=mask)
    check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
          f"masked flash {qshape} {kind}: non-finite output")
    keep = attended(mask, sq, causal)
    live = keep.any(-1)
    err, cos, peak = compare(o[live], po[live])
    lse_err = compare(lse.transpose(1, 2)[live],
                      plse.transpose(1, 2)[live])[0]
    check(within(dtype, err, cos, peak) and lse_err <= F32_MAX_ERR,
          f"masked flash {qshape} sk={sk} causal={causal} {kind} {dtype}: "
          f"err {err} cos {cos} lse err {lse_err}")
    flops = 4.0 * n * d * keep.sum().item()
    nbytes = sum(t.nbytes for t in (q, k, v, o, lse, mask))
    bound, by = bound_ms(nbytes, flops, dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_mask = keep[:, None]

    def kernel():
        return fa.flash_attention_lse(q, k, v, is_causal=causal, mask=mask)

    return {"shape": f"q{qshape} sk={sk} {kind}"
            + (" causal" if causal else ""),
            "dtype": str(dtype)[6:], "max_abs_err": err, "cosine": cos,
            "dead_rows": int((~live).sum().item()),
            "ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(lambda: fa.flash_attention_plain(
                q, k, v, is_causal=causal, mask=mask)),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask)),
            "bound_ms": bound, "bound_by": by}


def masked_flash_bwd_case(qshape: tuple[int, int, int, int], sk: int,
                          causal: bool, kind: str, dtype: torch.dtype,
                          seed: int, view: bool = False) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, n, d = qshape
    q, do = (torch.randn(b, sq, n, d, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, n, d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    mask = key_mask(kind, b, sk, g)
    if view:
        q = _unaligned(q)
    keep = attended(mask, sq, causal)
    do = do * keep.any(-1)[:, :, None, None].to(dtype)  # dead rows: none
    o, lse = fa.flash_attention_plain(q, k, v, is_causal=causal, mask=mask)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, is_causal=causal,
                                 mask=mask)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                        is_causal=causal, mask=mask)
    errs = [compare(a, w) for a, w in zip(got, want)]
    check(all(within(dtype, *e, relative=True) for e in errs),
          f"masked flash_bwd {qshape} sk={sk} causal={causal} {kind} "
          f"{dtype}: (err, cos, peak) of dq, dk, dv {errs}")
    check(not got[1][~mask].any() and not got[2][~mask].any(),
          f"masked flash_bwd {qshape} {kind}: a masked key got a gradient")
    flops = 10.0 * n * d * keep.sum().item()
    nbytes = (sum(t.nbytes for t in (q, k, v, o, lse, do, mask))
              + lse.nbytes + sum(t.nbytes for t in got))
    bound, by = bound_ms(nbytes, flops, dtype)
    qt, kt, vt = (t.transpose(1, 2).detach().clone().requires_grad_()
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep[:, None])

    def kernel():
        return fa.flash_attention_bwd(q, k, v, o, lse, do, is_causal=causal,
                                      mask=mask)

    return {"shape": f"q{qshape} sk={sk} {kind}"
            + (" causal" if causal else "") + (" unaligned q" if view else ""),
            "dtype": str(dtype)[6:], "max_abs_err": max(e[0] for e in errs),
            "cosine": min(e[1] for e in errs),
            "ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, is_causal=causal, mask=mask)),
            "library_ms": device_ms(grad_ms(ot, (qt, kt, vt),
                                            do.transpose(1, 2))),
            "bound_ms": bound, "bound_by": by}


def ln_bwd_case(rows: int, f: int, dtype: torch.dtype, seed: int,
                offset: bool = False) -> dict:
    """Row 2 against its plain version. ``ln.backward_body`` names the body
    the C entry picks by shape (the register body, one warp a row, or the
    CTA body); a trace of the call must show that body's kernel and not the
    other's, and a second call must give dscale and dbias bit for bit (no
    atomics, a fixed order of sums). ``offset``: x 4 bytes past a 16-byte
    boundary."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(rows, f, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    w = torch.randn(f, generator=g, device="cuda").to(dtype)
    dy = torch.randn(rows, f, generator=g, device="cuda").to(dtype)
    if offset:
        x = _offset_copy(x, 4)
    _, mu, rstd = ln.layer_norm_plain(x, w, w, 1e-6)
    body = ln.backward_body(x, w, dy)
    got, names = traced(lambda: ln.layer_norm_bwd(x, w, mu, rstd, dy),
                        tuple(ln.BACKWARD_KERNELS.values()))
    for kind, kernel in ln.BACKWARD_KERNELS.items():
        check(any(_is_kernel(n, kernel) for n in names) == (kind == body),
              f"layer_norm_bwd ({rows}, {f}) {dtype}: backward_body says "
              f"{body}, the trace shows {names}")
    again = ln.layer_norm_bwd(x, w, mu, rstd, dy)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"layer_norm_bwd ({rows}, {f}) {dtype}: two calls differ")
    want = ln.layer_norm_bwd_plain(x, w, mu, rstd, dy)
    errs = [compare(a, b) for a, b in zip(got, want)]
    check(all(within(dtype, *e, relative=True) for e in errs),
          f"layer_norm_bwd ({rows}, {f}) {dtype}: (err, cos, peak) of dx, "
          f"dscale, dbias {errs}")
    nbytes = (sum(t.nbytes for t in (x, w, mu, rstd, dy)) + sum(
        t.nbytes for t in got))
    bound, by = bound_ms(nbytes, 10.0 * rows * f, dtype)
    xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, w, w))
    yl = F.layer_norm(xl, (f,), wl, bl, 1e-6)
    return {"shape": f"({rows}, {f})" + (" x at +4 B" if offset else ""),
            "dtype": str(dtype)[6:], "body": body,
            "max_abs_err": max(e[0] for e in errs),
            "cosine": min(e[1] for e in errs),
            "ms": device_ms(lambda: ln.layer_norm_bwd(x, w, mu, rstd, dy)),
            "call_ms": cuda_ms(lambda: ln.layer_norm_bwd(x, w, mu, rstd, dy)),
            "plain_ms": device_ms(lambda: ln.layer_norm_bwd_plain(
                x, w, mu, rstd, dy)),
            "library_ms": device_ms(grad_ms(yl, (xl, wl, bl), dy)),
            "bound_ms": bound, "bound_by": by}


def flash_bwd_case(qshape: tuple[int, int, int, int], sk: int, causal: bool,
                   dtype: torch.dtype, seed: int, view: bool = False) -> dict:
    """Row 7 (dq, then dk/dv) against its plain version; ``view``: q is an
    unaligned strided view."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, n, d = qshape
    q, do = (torch.randn(b, sq, n, d, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, n, d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    if view:
        q = _unaligned(q)
    o, lse = fa.flash_attention_plain(q, k, v, is_causal=causal)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, is_causal=causal)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                        is_causal=causal)
    errs = [compare(a, w) for a, w in zip(got, want)]
    check(all(within(dtype, *e, relative=True) for e in errs),
          f"flash_bwd {qshape} sk={sk} causal={causal} {dtype}: (err, cos, "
          f"peak) of dq, dk, dv {errs}")
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk)
    # five products: s and dp recomputed, then dv, dq, dk
    flops = 10.0 * b * n * pairs * d
    nbytes = (sum(t.nbytes for t in (q, k, v, o, lse, do)) + lse.nbytes
              + sum(t.nbytes for t in got))  # lse.nbytes again: delta
    bound, by = bound_ms(nbytes, flops, dtype)
    qt, kt, vt = (t.transpose(1, 2).detach().clone().requires_grad_()
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, o, lse, do, is_causal=causal)

    return {"shape": f"q{qshape} sk={sk}" + (" causal" if causal else "")
            + (" unaligned q" if view else ""),
            "dtype": str(dtype)[6:], "max_abs_err": max(e[0] for e in errs),
            "cosine": min(e[1] for e in errs),
            "ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, is_causal=causal)),
            "library_ms": device_ms(grad_ms(ot, (qt, kt, vt),
                                            do.transpose(1, 2))),
            "bound_ms": bound, "bound_by": by}


def int8_matmul_case(m: int, k: int, n: int, activation: str | None,
                     seed: int, offset: int = 0) -> dict:
    """Kernel row 11 against its plain version: x quantized per row, w per
    output channel (as ``quantize_linear`` does), an f32 bias. The s32 sums
    are exact and the epilogue rounds each step as the plain version does,
    so the two are equal (``torch.equal``) but for gelu, whose erff is held
    to the f32 gate. ``offset`` bytes moves x_q's base off a 16-byte
    boundary (the wrapper's padded copy)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=g, device="cuda")
    w = torch.randn(n, k, generator=g, device="cuda")
    bias = torch.randn(n, generator=g, device="cuda")
    x_q, x_s = mm.quantize_rows(x)
    w_q, w_s = mm.quantize_rows(w)
    if offset:
        store = torch.empty(m * k + offset, dtype=torch.int8, device="cuda")
        store[offset:] = x_q.flatten()
        x_q = store[offset:].view(m, k)

    def kernel():
        return mm.int8_matmul(x_q, x_s, w_q, w_s, bias, activation=activation)

    def plain():
        return mm.int8_matmul_plain(x_q, x_s, w_q, w_s, bias,
                                    activation=activation)

    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err, cos, peak = compare(got, want)
    label = f"int8_matmul ({m}, {k}) x ({k}, {n}) {activation}"
    if activation == "gelu":
        check(within(torch.float32, err, cos, peak), f"{label}: err {err}")
    else:
        check(torch.equal(got, want), f"{label}: not equal, err {err}")
    nbytes = sum(t.nbytes for t in (x_q, x_s, w_q, w_s, bias, got))
    bound, by = bound_ms(nbytes, 0.0, torch.float32, int8_ops=2.0 * m * n * k)
    library = None
    if m > 16 and k % 8 == 0 and n % 8 == 0:  # what torch._int_mm takes
        library = device_ms(lambda: mm._epilogue(
            torch._int_mm(x_q, w_q.t()).float(), x_s, w_s, bias,
            activation))
    return {"shape": f"({m}, {k}) x ({k}, {n})"
            + (f" {activation}" if activation else "")
            + (f" x_q at +{offset} B" if offset else ""),
            "dtype": "int8", "max_abs_err": err, "cosine": cos,
            "ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(plain), "library_ms": library,
            "bound_ms": bound, "bound_by": by}


def _int8_flash_inputs(qshape, sk: int, dtype: torch.dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, n, d = qshape
    q, do = (torch.randn(b, sq, n, d, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, n, d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    qq, qs = fa8.quantize_heads(q)
    kq, ks = fa8.quantize_heads(k)
    return qq, qs, kq, ks, v, do


def _dequantized(x_q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """(B, N, S, D) q or k for SDPA: the int8 values times their scales, in
    the storage dtype."""
    return (x_q.float() * scale.transpose(1, 2)[..., None]).to(
        dtype).transpose(1, 2)


def int8_flash_case(qshape: tuple[int, int, int, int], sk: int,
                    causal: bool, dtype: torch.dtype, seed: int,
                    view: bool = False) -> dict:
    """Kernel row 9 against its plain version, from the same int8 q/k;
    ``view``: q and k off a 16-byte boundary, v an unaligned strided
    view."""
    qq, qs, kq, ks, v, _ = _int8_flash_inputs(qshape, sk, dtype, seed)
    b, sq, n, d = qshape
    if view:
        qq, kq, v = (_unaligned_contiguous(qq), _unaligned_contiguous(kq),
                     _unaligned(v))

    def kernel():
        return fa8.flash_attention_int8_fwd(qq, qs, kq, ks, v,
                                            is_causal=causal)

    o, lse = kernel()
    torch.cuda.synchronize()
    po, plse = fa8.flash_attention_int8_plain(qq, qs, kq, ks, v,
                                              is_causal=causal)
    err, cos, peak = compare(o, po)
    lse_err = compare(lse, plse)[0]
    check(within(dtype, err, cos, peak) and lse_err <= F32_MAX_ERR,
          f"flash_int8 {qshape} sk={sk} causal={causal} {dtype}: err {err} "
          f"cos {cos} lse err {lse_err}")
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk)
    work = 2.0 * b * n * pairs * d  # the int8 scores, and P.V
    nbytes = sum(t.nbytes for t in (qq, qs, kq, ks, v, o, lse))
    bound, by = bound_ms(nbytes, work, dtype, int8_ops=work)
    qd, kd = _dequantized(qq, qs, dtype), _dequantized(kq, ks, dtype)
    # SDPA's kernels assume aligned rows: the yardstick gets an aligned v
    vt = (v.contiguous() if view else v).transpose(1, 2)
    return {"shape": f"q{qshape} sk={sk}" + (" causal" if causal else "")
            + (" unaligned q, k, v" if view else ""),
            "dtype": str(dtype)[6:], "max_abs_err": err, "cosine": cos,
            "ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(lambda: fa8.flash_attention_int8_plain(
                qq, qs, kq, ks, v, is_causal=causal)),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vt, is_causal=causal)),
            "bound_ms": bound, "bound_by": by}


def int8_flash_bwd_case(qshape: tuple[int, int, int, int], sk: int,
                        causal: bool, dtype: torch.dtype, seed: int,
                        view: bool = False) -> dict:
    """Kernel row 10 (dq, then dk/dv) against its plain version; ``view``:
    q and k off a 16-byte boundary, v and do unaligned strided views."""
    qq, qs, kq, ks, v, do = _int8_flash_inputs(qshape, sk, dtype, seed)
    b, sq, n, d = qshape
    if view:
        qq, kq, v, do = (_unaligned_contiguous(qq), _unaligned_contiguous(kq),
                         _unaligned(v), _unaligned(do))
    o, lse = fa8.flash_attention_int8_plain(qq, qs, kq, ks, v,
                                            is_causal=causal)

    def kernel():
        return fa8.flash_attention_int8_bwd(qq, qs, kq, ks, v, o, lse, do,
                                            is_causal=causal)

    got = kernel()
    torch.cuda.synchronize()
    want = fa8.flash_attention_int8_bwd_plain(qq, qs, kq, ks, v, o, lse, do,
                                              is_causal=causal)
    errs = [compare(a, w) for a, w in zip(got, want)]
    check(all(within(dtype, *e, relative=True) for e in errs),
          f"flash_int8_bwd {qshape} sk={sk} causal={causal} {dtype}: (err, "
          f"cos, peak) of dq, dk, dv {errs}")
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk)
    # the int8 scores once, then dp, dv, dq and dk
    work = 2.0 * b * n * pairs * d
    nbytes = (sum(t.nbytes for t in (qq, qs, kq, ks, v, o, lse, do))
              + lse.nbytes + sum(t.nbytes for t in got))  # lse again: delta
    bound, by = bound_ms(nbytes, 4 * work, dtype, int8_ops=work)
    # SDPA's kernels assume aligned rows: the yardstick gets aligned copies
    qd, kd, vt = (t.detach().clone().requires_grad_() for t in (
        _dequantized(qq, qs, dtype), _dequantized(kq, ks, dtype),
        v.transpose(1, 2)))
    dot = do.transpose(1, 2).clone()
    ot = F.scaled_dot_product_attention(qd, kd, vt, is_causal=causal)
    return {"shape": f"q{qshape} sk={sk}" + (" causal" if causal else "")
            + (" unaligned q, k, v, do" if view else ""),
            "dtype": str(dtype)[6:], "max_abs_err": max(e[0] for e in errs),
            "cosine": min(e[1] for e in errs),
            "ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(lambda: fa8.flash_attention_int8_bwd_plain(
                qq, qs, kq, ks, v, o, lse, do, is_causal=causal)),
            "library_ms": device_ms(grad_ms(ot, (qd, kd, vt), dot)),
            "bound_ms": bound, "bound_by": by}


def _pad16(x: torch.Tensor) -> torch.Tensor:
    """A copy of a 2-D tensor zero-padded to multiples of 16 (what
    ``torch._scaled_mm`` takes)."""
    rows, cols = (-(-n // 16) * 16 for n in x.shape)
    out = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def fp8_gate(a_q: torch.Tensor, b_q: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor | None, got: torch.Tensor, label: str
             ) -> tuple[torch.Tensor, float]:
    """Row 12's gate, ``fp8.check_gemm``: the kernel's output ``got``
    against its plain version within ``fp8.gemm_error_bound`` (relative to
    the sum of absolute products), and its epilogue bit for bit. Returns
    the plain version's output and the largest error over the sum of
    absolute products."""
    excess, ratio, epilogue_exact, want = fp8.check_gemm(a_q, b_q, scale,
                                                         bias, got)
    check(excess <= 0, f"fp8_gemm {label}: beyond the bound by {excess} "
          f"(error / sum of absolute products {ratio:.3e}, c "
          f"{fp8.accumulation_tolerance(a_q.shape[1]):.3e})")
    check(epilogue_exact,
          f"fp8_gemm {label}: the epilogue differs from (sum * scale) + bias")
    return want, ratio


def fp8_gemm_case(m: int, k: int, n: int, a_dtype: torch.dtype, bias: bool,
                  seed: int, offset: int = 0) -> dict:
    """Kernel row 12 against its plain version: a (M, K) in ``a_dtype`` and
    b (N, K) in e4m3, each quantized at its dynamic scale, as the train step
    quantizes them; an f32 bias for a forward GEMM; ``offset`` bytes moves
    a's base off a 16-byte boundary (the wrapper's padded copy). Held to
    :func:`fp8_gate`."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(m, k, generator=g, device="cuda")
    b = torch.randn(n, k, generator=g, device="cuda")
    bvec = torch.randn(n, generator=g, device="cuda") if bias else None
    sa, sb = fp8.dynamic_scale(a, a_dtype), fp8.dynamic_scale(b, fp8.E4M3)
    a_q, b_q = (fp8.quantize_tensor(a, sa, a_dtype),
                fp8.quantize_tensor(b, sb, fp8.E4M3))
    if offset:
        store = torch.empty(m * k + offset, dtype=torch.uint8, device="cuda")
        store[offset:] = a_q.view(torch.uint8).flatten()
        a_q = store[offset:].view(m, k).view(a_dtype)
    scale = sa * sb
    del a, b
    backward = a_dtype == fp8.E5M2

    def kernel():
        return fp8.fp8_gemm(a_q, b_q, scale, bvec, backward=backward)

    def plain():
        return fp8.fp8_gemm_plain(a_q, b_q, scale, bvec)

    got = kernel()
    torch.cuda.synchronize()
    label = f"({m}, {k}) x ({n}, {k})^T {a_dtype}"
    want, ratio = fp8_gate(a_q, b_q, scale, bvec, got, label)
    err, cos, _ = compare(got, want)
    nbytes = (a_q.nbytes + b_q.nbytes + got.nbytes + scale.nbytes
              + (0 if bvec is None else bvec.nbytes))
    bound, by = bound_ms(nbytes, 0.0, torch.float32,
                         fp8_flops=2.0 * m * n * k)
    ap, bp, one = _pad16(a_q), _pad16(b_q), torch.ones((), device="cuda")
    try:  # a yardstick only: a refusal is reported, not a failure
        library = device_ms(lambda: torch._scaled_mm(
            ap, bp.t(), scale_a=scale, scale_b=one, out_dtype=torch.float32))
    except RuntimeError as e:
        print(f"kernel fp8_matmul: torch._scaled_mm refused {tuple(ap.shape)}"
              f" x {tuple(bp.shape)}^T: {str(e)[:200]}", flush=True)
        library = None
    kind = "e5m2 x e4m3" if backward else "e4m3 x e4m3"
    return {"shape": f"({m}, {k}) x ({n}, {k})^T" + (" +bias" if bias else "")
            + (f" a at +{offset} B" if offset else ""),
            "dtype": kind, "max_abs_err": err, "cosine": cos,
            "err_over_abs_sum": ratio,
            "ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(plain), "library_ms": library,
            "bound_ms": bound, "bound_by": by}


def fp8_accumulator_case(a_dtype: torch.dtype) -> None:
    """The accumulator's width and the K ranges, held exactly: each row of
    a and b starts with 256 and is 1 after, so each output is 65536 + (K -
    1), exact in f32, at the q/k/v/out weight gradients' shape (768 x 768,
    K = 32768: 15 K ranges, the last 512 long). An accumulator of fp8
    wgmma's ~14 significant bits keeps no unit next to 2^16: carried over K
    it drops K - 1, promoted to f32 after every instruction it still drops
    the first instruction's 31; a dropped or doubled range is off by its
    length. The kernel's f32 sums must give every output exactly."""
    m = n = 768
    k = 32768
    a = torch.ones(m, k, device="cuda")
    b = torch.ones(n, k, device="cuda")
    a[:, 0] = b[:, 0] = 256.0
    a_q, b_q = a.to(a_dtype), b.to(fp8.E4M3)
    one = torch.ones((), device="cuda")
    got = fp8.fp8_gemm(a_q, b_q, one, backward=a_dtype == fp8.E5M2)
    torch.cuda.synchronize()
    want, ratio = fp8_gate(a_q, b_q, one, None, got,
                           f"65536 + ones ({m}, {k}) x ({n}, {k})^T "
                           f"{a_dtype}")
    lost = (want - got).abs().max().item()
    k_split = fp8.k_range(m, n, k, torch.cuda.get_device_properties(
        0).multi_processor_count)
    print(f"kernel fp8 accumulator {a_dtype} ({m}, {k}) x ({n}, {k})^T in "
          f"{-(-k // k_split)} K ranges of {k_split}: every output "
          f"{want[0, 0].item()} in the plain version, at most {lost} lost "
          f"on the card", flush=True)
    check(lost == 0, f"fp8_gemm {a_dtype}: 65536 + ones lost {lost} (error "
          f"/ sum of absolute products {ratio:.3e}): an accumulator "
          f"narrower than f32")


def _sigmoid_inputs(qshape, sk: int, kind: str | None, dtype: torch.dtype,
                    seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, n, d = qshape
    q, do = (torch.randn(b, sq, n, d, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, n, d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    mask = None if kind is None else key_mask(kind, b, sk, g)
    return q, k, v, do, mask


def _pairs(qshape, sk: int, causal: bool, mask: torch.Tensor | None) -> float:
    """The (query, key) pairs the inputs need, over every batch and head."""
    b, sq, n, _ = qshape
    if mask is not None:
        return float(n * attended(mask, sq, causal).sum().item())
    return float(b * n * (sum(min(i + 1, sk) for i in range(sq)) if causal
                          else sq * sk))


def sigmoid_case(qshape: tuple[int, int, int, int], sk: int, causal: bool,
                 kind: str | None, dtype: torch.dtype, seed: int) -> dict:
    """Kernel row 6 against its plain version; a row with no key to attend
    is exactly zero in both."""
    q, k, v, _, mask = _sigmoid_inputs(qshape, sk, kind, dtype, seed)
    kw = dict(is_causal=causal, mask=mask,
              logit_bias=fa.default_logit_bias(sk))

    def kernel():
        return fa.sigmoid_attention_fwd(q, k, v, **kw)

    o = kernel()
    torch.cuda.synchronize()
    err, cos, peak = compare(o, fa.sigmoid_attention_plain(q, k, v, **kw))
    check(within(dtype, err, cos, peak),
          f"sigmoid {qshape} sk={sk} causal={causal} {kind} {dtype}: err "
          f"{err} cos {cos}")
    if mask is not None:
        dead = ~attended(mask, qshape[1], causal).any(-1)
        check(not o[dead].any(), f"sigmoid {qshape} {kind}: a row with no "
              f"key is not zero")
    nbytes = sum(t.nbytes for t in (q, k, v, o)) + (
        0 if mask is None else mask.nbytes)
    bound, by = bound_ms(nbytes, 4.0 * qshape[3] * _pairs(qshape, sk, causal,
                                                          mask), dtype)
    return {"shape": f"q{qshape} sk={sk}" + (f" {kind}" if kind else "")
            + (" causal" if causal else ""),
            "dtype": str(dtype)[6:], "max_abs_err": err, "cosine": cos,
            "ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(lambda: fa.sigmoid_attention_plain(
                q, k, v, **kw)),
            "library_ms": None, "bound_ms": bound, "bound_by": by}


def sigmoid_bwd_case(qshape: tuple[int, int, int, int], sk: int,
                     causal: bool, kind: str | None, dtype: torch.dtype,
                     seed: int, view: bool = False) -> dict:
    """Row 7's sigmoid kind (dq, then dk/dv) against its plain version;
    masked keys get exactly zero dk and dv."""
    q, k, v, do, mask = _sigmoid_inputs(qshape, sk, kind, dtype, seed)
    if view:
        q = _unaligned(q)
    kw = dict(is_causal=causal, mask=mask,
              logit_bias=fa.default_logit_bias(sk))

    def kernel():
        return fa.sigmoid_attention_bwd(q, k, v, do, **kw)

    got = kernel()
    torch.cuda.synchronize()
    want = fa.sigmoid_attention_bwd_plain(q, k, v, do, **kw)
    errs = [compare(a, w) for a, w in zip(got, want)]
    check(all(within(dtype, *e, relative=True) for e in errs),
          f"sigmoid_bwd {qshape} sk={sk} causal={causal} {kind} {dtype}: "
          f"(err, cos, peak) of dq, dk, dv {errs}")
    if mask is not None:
        check(not got[1][~mask].any() and not got[2][~mask].any(),
              f"sigmoid_bwd {qshape} {kind}: a masked key got a gradient")
    # five products: s and dp recomputed, then dv, dq, dk
    flops = 10.0 * qshape[3] * _pairs(qshape, sk, causal, mask)
    nbytes = (sum(t.nbytes for t in (q, k, v, do)) + sum(
        t.nbytes for t in got) + (0 if mask is None else mask.nbytes))
    bound, by = bound_ms(nbytes, flops, dtype)
    return {"shape": f"q{qshape} sk={sk}" + (f" {kind}" if kind else "")
            + (" causal" if causal else "") + (" unaligned q" if view else ""),
            "dtype": str(dtype)[6:], "max_abs_err": max(e[0] for e in errs),
            "cosine": min(e[1] for e in errs),
            "ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(lambda: fa.sigmoid_attention_bwd_plain(
                q, k, v, do, **kw)),
            "library_ms": None, "bound_ms": bound, "bound_by": by}


def _bias_inputs(qshape, sk: int, causal: bool, kind: str,
                 dtype: torch.dtype, seed: int):
    """q, k, v, do in ``dtype``; the f32 (N, Sq, Sk) bias: ``full``, ``2d``
    (an (Sq, Sk) bias broadcast over heads, a view with head stride 0) or
    ``neginf`` (~30% of entries -inf, head 0's row 3 all -inf); the bytes of
    the bias its caller holds; which (N, Sq, Sk) pairs the function needs
    (kept by the causal triangle, with a finite bias); and the (B, Sq, N)
    query rows that have one."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, n, d = qshape
    q, do = (torch.randn(b, sq, n, d, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, sk, n, d, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    if kind == "2d":
        held = torch.randn(sq, sk, generator=g, device="cuda")
        bias = held.expand(n, sq, sk)
    else:
        held = bias = torch.randn(n, sq, sk, generator=g, device="cuda")
    if kind == "neginf":
        bias[torch.rand(n, sq, sk, generator=g, device="cuda") < 0.3] = (
            float("-inf"))
        bias[:, :, 0] = 0.5
        bias[0, min(3, sq - 1)] = float("-inf")
    pairs = torch.isfinite(bias)
    if causal:
        pairs = pairs & torch.ones(sq, sk, dtype=torch.bool,
                                   device="cuda").tril()
    live = pairs.any(-1).T[None].expand(b, sq, n)
    return q, k, v, do, bias, held.nbytes, pairs, live


def _sdpa_mask(bias: torch.Tensor, causal: bool, dtype: torch.dtype,
               grad: bool = False) -> torch.Tensor:
    """The bias as SDPA's float attn_mask, (1, N, Sq, Sk) in ``dtype``, the
    causal triangle folded in as -inf (SDPA takes no is_causal with a
    mask)."""
    if causal:
        sq, sk = bias.shape[1:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device="cuda").tril()
        bias = bias.masked_fill(~keep, float("-inf"))
    return bias[None].to(dtype).clone(
        memory_format=torch.contiguous_format).requires_grad_(grad)


def _library_ms(label: str, setup):
    """The device time of the call ``setup()`` returns, or None (noted)
    where PyTorch refuses these inputs (SDPA may refuse a float attn_mask
    that requires grad)."""
    try:
        return device_ms(setup())
    except RuntimeError as e:
        print(f"{label}: the library call refused these inputs, no "
              f"yardstick: {str(e).splitlines()[0][:160]}", flush=True)
        return None


def _bias_label(qshape, sk: int, causal: bool, kind: str) -> str:
    return (f"q{qshape} sk={sk}" + ("" if kind == "full" else f" {kind}")
            + (" causal" if causal else ""))


def bias_case(qshape: tuple[int, int, int, int], sk: int, causal: bool,
              kind: str, dtype: torch.dtype, seed: int) -> dict:
    """Kernel row 5 against its plain version; a query row with no finite
    key gives o = 0 and lse = -1e30 in both."""
    q, k, v, _, bias, held, pairs, live = _bias_inputs(qshape, sk, causal,
                                                       kind, dtype, seed)

    def kernel():
        return fa.flash_attention_bias_fwd(q, k, v, bias, is_causal=causal)

    o, lse = kernel()
    torch.cuda.synchronize()
    po, plse = fa.flash_attention_bias_plain(q, k, v, bias, is_causal=causal)
    check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
          f"flash_bias {qshape} {kind}: non-finite output")
    err, cos, peak = compare(o[live], po[live])
    lse_err = compare(lse.transpose(1, 2)[live],
                      plse.transpose(1, 2)[live])[0]
    label = _bias_label(qshape, sk, causal, kind)
    check(within(dtype, err, cos, peak) and lse_err <= F32_MAX_ERR,
          f"flash_bias {label} {dtype}: err {err} cos {cos} lse err "
          f"{lse_err}")
    check(not o[~live].any() and bool(
        (lse.transpose(1, 2)[~live] == fa.NEG_INF).all()),
        f"flash_bias {label}: a row with no finite key is not o = 0, "
        f"lse = -1e30")
    nbytes = sum(t.nbytes for t in (q, k, v, o, lse)) + held
    bound, by = bound_ms(nbytes, 4.0 * qshape[0] * qshape[3]
                         * pairs.sum().item(), dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = _sdpa_mask(bias, causal, dtype)
    return {"shape": label, "dtype": str(dtype)[6:], "max_abs_err": err,
            "cosine": cos, "dead_rows": int((~live).sum().item()),
            "ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(lambda: fa.flash_attention_bias_plain(
                q, k, v, bias, is_causal=causal)),
            "library_ms": _library_ms(f"flash_bias {label}", lambda: (
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask))),
            "bound_ms": bound, "bound_by": by}


def _bias_bwd_setup(qshape, sk: int, causal: bool, kind: str,
                    dtype: torch.dtype, seed: int, view: bool = False):
    """The inputs (``view``: q an unaligned strided view), the plain
    forward's o and lse, and the time of SDPA's backward with the mask
    requiring grad (the yardstick of rows 7-bias and 8), or None where
    PyTorch refuses it."""
    q, k, v, do, bias, held, pairs, _ = _bias_inputs(qshape, sk, causal,
                                                     kind, dtype, seed)
    if view:
        q = _unaligned(q)
    o, lse = fa.flash_attention_bias_plain(q, k, v, bias, is_causal=causal)
    qt, kt, vt = (t.transpose(1, 2).detach().clone().requires_grad_()
                  for t in (q, k, v))
    mask = _sdpa_mask(bias, causal, dtype, grad=True)
    label = (_bias_label(qshape, sk, causal, kind)
             + (" unaligned q" if view else ""))
    library = _library_ms(f"flash_bias backward {label}", lambda: grad_ms(
        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
        (qt, kt, vt, mask), do.transpose(1, 2)))
    return q, k, v, do, bias, held, pairs, o, lse, label, library


def bias_bwd_case(qshape: tuple[int, int, int, int], sk: int, causal: bool,
                  kind: str, dtype: torch.dtype, seed: int,
                  view: bool = False) -> dict:
    """Row 7's bias kind (dq, then dk/dv) against its plain version."""
    q, k, v, do, bias, held, pairs, o, lse, label, library = _bias_bwd_setup(
        qshape, sk, causal, kind, dtype, seed, view)

    def kernel():
        return fa.flash_attention_bias_bwd(q, k, v, bias, o, lse, do,
                                           is_causal=causal)

    got = kernel()
    torch.cuda.synchronize()
    want = fa.flash_attention_bias_bwd_plain(q, k, v, bias, o, lse, do,
                                             is_causal=causal)
    errs = [compare(a, w) for a, w in zip(got, want)]
    check(all(within(dtype, *e, relative=True) for e in errs),
          f"flash_bias_bwd {label} {dtype}: (err, cos, peak) of dq, dk, dv "
          f"{errs}")
    # five products: s and dp recomputed, then dv, dq, dk
    flops = 10.0 * qshape[0] * qshape[3] * pairs.sum().item()
    nbytes = (sum(t.nbytes for t in (q, k, v, o, lse, do)) + lse.nbytes
              + held + sum(t.nbytes for t in got))  # lse again: delta
    bound, by = bound_ms(nbytes, flops, dtype)
    return {"shape": label, "dtype": str(dtype)[6:],
            "max_abs_err": max(e[0] for e in errs),
            "cosine": min(e[1] for e in errs),
            "ms": device_ms(kernel), "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(lambda: fa.flash_attention_bias_bwd_plain(
                q, k, v, bias, o, lse, do, is_causal=causal)),
            "library_ms": library, "bound_ms": bound, "bound_by": by}


def dbias_case(qshape: tuple[int, int, int, int], sk: int, causal: bool,
               kind: str, dtype: torch.dtype, seed: int, view: bool = False,
               split: bool = False) -> dict:
    """Row 8 against its plain version: the f32 batch sum of the unrounded
    ds, held at the f32 tolerance relative to its scale in either input
    dtype (both sides sum f32 products of the same inputs); a key whose
    bias is -inf gets exactly zero. ``view``: q an unaligned strided view;
    ``split``: the wrapper must split the batch into ranges, which a trace
    of its call shows as a launch of the range-sum kernel."""
    q, k, v, do, bias, held, pairs, o, lse, label, library = _bias_bwd_setup(
        qshape, sk, causal, kind, dtype, seed, view)

    def kernel():
        return fa.flash_attention_dbias(q, k, v, bias, o, lse, do,
                                        is_causal=causal)

    got, names = traced(kernel)
    if split:
        check(any("dbias_range_sum_kernel" in name for name in names),
              f"flash_dbias {label}: the batch was not split into ranges "
              f"(kernels launched: {names})")
    want = fa.flash_attention_dbias_plain(q, k, v, bias, o, lse, do,
                                          is_causal=causal)
    err, cos, peak = compare(got, want)
    check(within(torch.float32, err, cos, peak, relative=True),
          f"flash_dbias {label} {dtype}: err {err} cos {cos} peak {peak}")
    check(not got[torch.isinf(bias)].any(),
          f"flash_dbias {label}: a -inf bias entry got a gradient")
    # two products a sample: s and dp recomputed
    flops = 4.0 * qshape[0] * qshape[3] * pairs.sum().item()
    nbytes = (sum(t.nbytes for t in (q, k, v, do, lse)) + lse.nbytes + held
              + got.nbytes)  # lse again: delta
    bound, by = bound_ms(nbytes, flops, dtype)
    return {"shape": label + (" split" if split else ""),
            "dtype": str(dtype)[6:], "max_abs_err": err,
            "cosine": cos, "ms": device_ms(kernel),
            "call_ms": cuda_ms(kernel),
            "plain_ms": device_ms(lambda: fa.flash_attention_dbias_plain(
                q, k, v, bias, o, lse, do, is_causal=causal)),
            "library_ms": library, "bound_ms": bound, "bound_by": by}


def rows_against_recorded(cases: list[tuple[str, dict]], card: str) -> None:
    """Readings, not gates (a card below 700 W runs slower), at the shapes
    ``FMA_VERSION_MS`` and ``RECORDED_MS`` name, in bf16 (int8 and fp8 for
    rows 11 and 12): the redesigned rows (1, 3-12) as a speed-up over their
    first versions' recorded times, and the rows with recorded times (3-6
    and 12 on the shared headers, 1, 2, 11) against those times, which
    they should keep within 5%."""
    for name, c in cases:
        if c["dtype"] == "float32":
            continue
        if FMA_VERSION_MS.get(name, (None,))[0] == c["shape"]:
            was = FMA_VERSION_MS[name][1]
            print(f"kernel {name} {c['shape']} {c['dtype']}: {c['ms']:.4f} "
                  f"ms, the FMA version {was:.4f} ms (speed-up "
                  f"{was / c['ms']:.2f}x) | {card}", flush=True)
        if RECORDED_MS.get(name, (None,))[0] == c["shape"]:
            was = RECORDED_MS[name][1]
            ratio = c["ms"] / was
            print(f"kernel {name} {c['shape']} {c['dtype']}: {c['ms']:.4f} "
                  f"ms, PERF.md records {was:.4f} ms (ratio {ratio:.3f}, "
                  f"within 5%: {abs(ratio - 1) <= 0.05}) | {card}",
                  flush=True)


def tensor_core_phase(card: str) -> None:
    """Reads the built library's SASS (``cuobjdump -sass``) and resources
    (``cuobjdump -res-usage``): every instantiation of the fp8 GEMM must
    hold warpgroup MMA instructions, every one of the bf16 flash forward,
    dq and dk/dv kernels and of the dbias kernel's mma body bf16 mma.sync
    ones, and every one of the int8-QK forward's and backward's mma bodies
    both s8 (the scores) and bf16 (P.V, dp, the gradients) mma.sync ones;
    prints each kernel's counts, registers and local memory (spills) a
    thread, and fails if a kernel is missing or lacks one; and every
    instantiation of the LayerNorm backward's register body must use no
    local memory (the forward's is printed)."""
    tool = pathlib.Path(_build.nvcc()).parent / "cuobjdump"
    lib = str(_build.library_path())
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    usage = subprocess.run([str(tool), "-res-usage", lib],
                           capture_output=True, text=True, timeout=300,
                           check=True).stdout.splitlines()
    resources = {}
    for line, nxt in zip(usage, usage[1:]):
        if line.strip().startswith("Function "):
            fn = line.strip()[len("Function "):].rstrip(":")
            regs = re.search(r"REG:(\d+)", nxt)
            local = re.search(r"LOCAL:(\d+)", nxt)
            resources[fn] = (regs and regs.group(1), local and local.group(1))
    for key, mnemonics in TENSOR_CORE_KERNELS.items():
        found = 0
        for chunk in sass.split("Function : ")[1:]:
            fn = chunk.split("\n", 1)[0].strip()
            if key not in fn:
                continue
            found += 1
            ops = {m: re.findall(r"\b(" + m + r")\.", chunk)
                   for m in mnemonics}
            regs, local = resources.get(fn, (None, None))
            counts = ", ".join(f"{len(o)} {m}" for m, o in ops.items())
            print(f"sass: {key} #{found}: {counts} instructions, {regs} "
                  f"registers, {local} bytes of local memory a thread | "
                  f"{card}", flush=True)
            for m, o in ops.items():
                check(len(o) > 0, f"{fn}: no {m} instruction in its SASS")
        check(found > 0, f"no kernel named *{key}* in {lib}")
    for key, gated in REGISTER_BODY_KERNELS.items():
        found = sorted((fn, r) for fn, r in resources.items() if key in fn)
        check(bool(found), f"no kernel named *{key}* in {lib}")
        for fn, (regs, local) in found:
            args = re.search(r"I(13__nv_bfloat16|f)Li(\d+)E", fn)
            name = (f"{key}<{'bf16' if args.group(1) != 'f' else 'f32'}, "
                    f"{args.group(2)} vectors a lane>" if args else fn)
            print(f"res-usage: {name}: {regs} registers, {local} bytes of "
                  f"local memory a thread | {card}", flush=True)
            check(not gated or local == "0",
                  f"{fn}: {local} bytes of local memory a thread (spills)")


def odd_tensor_core_cases(add) -> None:
    """Rows 7 (every kind), 8, 9 and 10 on their bf16 tensor-core bodies at
    more of the JAX tests' odd shapes: seq 1, 5 and 257, D 64 and 80,
    causal and not, rows off a 16-byte boundary (an unaligned strided q
    view; for rows 9 and 10 unaligned int8 q and k and a strided v (and
    do), and D = 30), a broadcast (256, 256) bias, a bias with -inf keys,
    and (row 8) a batch summed in several ranges."""
    bf16 = torch.bfloat16
    for i, (qshape, sk, causal, view) in enumerate([
            ((2, 5, 2, 64), 5, False, False),
            ((2, 257, 2, 80), 257, True, False),
            ((2, 257, 2, 64), 257, False, True),
            ((2, 5, 2, 80), 5, True, True)]):
        add("flash_attention_bwd",
            flash_bwd_case(qshape, sk, causal, bf16, 400 + i, view))
    for i, (qshape, sk, causal, kind, view) in enumerate([
            ((2, 5, 2, 64), 5, False, "sparse", False),
            ((2, 257, 2, 80), 257, True, "len65", False),
            ((2, 257, 2, 64), 257, False, "sparse", True)]):
        add("flash_attention_masked_bwd", masked_flash_bwd_case(
            qshape, sk, causal, kind, bf16, 410 + i, view))
    for i, (qshape, sk, causal, kind, view) in enumerate([
            ((2, 5, 2, 64), 5, False, None, False),
            ((2, 257, 2, 80), 257, True, None, False),
            ((2, 257, 2, 64), 257, False, "sparse", True)]):
        add("sigmoid_attention_bwd", sigmoid_bwd_case(
            qshape, sk, causal, kind, bf16, 420 + i, view))
    for i, (qshape, sk, causal, kind, view) in enumerate([
            ((2, 256, 2, 64), 256, False, "2d", False),
            ((2, 257, 2, 80), 257, True, "neginf", False),
            ((2, 5, 2, 64), 5, False, "full", False),
            ((2, 257, 2, 64), 257, False, "full", True)]):
        add("flash_attention_bias_bwd", bias_bwd_case(
            qshape, sk, causal, kind, bf16, 430 + i, view))
    for i, (qshape, sk, causal, view) in enumerate([
            ((2, 5, 2, 64), 5, False, False),
            ((2, 257, 2, 80), 257, True, True),
            ((2, 1, 2, 64), 257, False, True),
            ((2, 65, 2, 30), 65, False, False)]):
        add("flash_attention_int8",
            int8_flash_case(qshape, sk, causal, bf16, 440 + i, view))
    for i, (qshape, sk, causal, view) in enumerate([
            ((2, 5, 2, 64), 5, False, False),
            ((2, 257, 2, 80), 257, True, False),
            ((2, 257, 2, 64), 257, False, True),
            ((2, 1, 2, 64), 257, False, False),
            ((2, 65, 2, 30), 65, False, True)]):
        add("flash_attention_int8_bwd",
            int8_flash_bwd_case(qshape, sk, causal, bf16, 450 + i, view))
    for i, (qshape, sk, causal, kind, view, split) in enumerate([
            ((2, 256, 2, 64), 256, False, "2d", False, False),
            ((2, 257, 2, 80), 257, True, "neginf", False, False),
            ((2, 5, 2, 64), 5, False, "full", False, False),
            ((2, 257, 2, 64), 257, False, "full", True, False),
            ((24, 256, 2, 64), 256, False, "neginf", False, True)]):
        add("flash_attention_dbias", dbias_case(
            qshape, sk, causal, kind, bf16, 460 + i, view, split))


def kernel_phase(card: str) -> dict[str, dict]:
    """Runs every case; returns the first case of each kernel (bf16, at the
    shape of its main path), and of each LayerNorm body as
    ``"<kernel>:<body>"``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cases = []

    def add(name: str, c: dict) -> None:
        cases.append((name, c))
        library = ("none" if c["library_ms"] is None
                   else f"{c['library_ms']:.4f} ms")
        gate = ("" if "err_over_abs_sum" not in c else
                f" (/ sum of |products| {c['err_over_abs_sum']:.3e})")
        body = f" ({c['body']} body)" if "body" in c else ""
        print(f"kernel {name} {c['shape']} {c['dtype']}{body}: max_abs_err "
              f"{c['max_abs_err']:.3e}{gate} cosine {c['cosine']:.6f} | "
              f"device time: kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"library {library}, bound {c['bound_ms']:.4f} "
              f"ms ({c['bound_by']}); kernel per call {c['call_ms']:.4f} ms "
              f"| {card}", flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        # the served shapes (batch 32), the train step's (batch 128), the
        # widths of SigLIP-L and So400m, on the register body; odd ones,
        # rows wider than it takes and x off a 16-byte boundary on the CTA
        # body
        add("layer_norm", ln_case(8192, 768, dtype, 1))
        add("layer_norm", ln_case(32768, 768, dtype, 5))
        add("layer_norm", ln_case(8192, 1024, dtype, 6))
        add("layer_norm", ln_case(8192, 1152, dtype, 7))
        add("layer_norm", ln_case(7, 80, dtype, 2))
        add("layer_norm", ln_case(1, 64, dtype, 8))
        add("layer_norm", ln_case(3, 5000, dtype, 9))
        add("layer_norm", ln_case(300, 768, dtype, 10, offset=True))
        for i, (qshape, sk, causal) in enumerate([
                ((32, 256, 12, 64), 256, False),   # image self-attention
                ((32, 1, 12, 64), 256, False),     # MAP probe
                ((32, 64, 12, 64), 64, False),     # text self-attention
                ((128, 256, 12, 64), 256, False),
                ((128, 1, 12, 64), 256, False),
                ((128, 64, 12, 64), 64, False),
                ((2, 5, 2, 80), 5, False), ((2, 5, 2, 80), 5, True),
                ((2, 257, 2, 64), 257, True), ((2, 257, 2, 80), 257, False),
                ((2, 1, 2, 80), 257, False), ((1, 70, 1, 256), 130, True),
                ((2, 257, 2, 256), 257, False),
                # CLIP-B/16's causal text tower: a (32, 77) batch, and the
                # 70 prompt rows of one label set (10 labels x 7 templates)
                ((32, 77, 8, 64), 77, True), ((70, 77, 8, 64), 77, True)]):
            add("flash_attention",
                flash_case(qshape, sk, causal, dtype, 10 + i))
        # the train step's shapes (batch 128: image and text rows), the
        # widths of SigLIP-L and So400m, on the register body; odd ones,
        # rows wider than it takes and x off a 16-byte boundary on the CTA
        # body; backward
        add("layer_norm_bwd", ln_bwd_case(32768, 768, dtype, 3))
        add("layer_norm_bwd", ln_bwd_case(8192, 768, dtype, 11))
        add("layer_norm_bwd", ln_bwd_case(8192, 1024, dtype, 12))
        add("layer_norm_bwd", ln_bwd_case(8192, 1152, dtype, 13))
        add("layer_norm_bwd", ln_bwd_case(7, 80, dtype, 4))
        add("layer_norm_bwd", ln_bwd_case(1, 64, dtype, 14))
        add("layer_norm_bwd", ln_bwd_case(3, 5000, dtype, 15))
        add("layer_norm_bwd", ln_bwd_case(300, 768, dtype, 16, offset=True))
        for i, (qshape, sk, causal) in enumerate([
                ((128, 256, 12, 64), 256, False),  # image self-attention
                ((128, 1, 12, 64), 256, False),    # MAP probe
                ((128, 64, 12, 64), 64, False),    # text self-attention
                ((2, 1, 2, 64), 1, False), ((2, 5, 2, 80), 5, True),
                ((2, 257, 2, 64), 257, True), ((2, 257, 2, 80), 257, False),
                ((2, 1, 2, 80), 257, False), ((1, 70, 1, 256), 130, True)]):
            add("flash_attention_bwd",
                flash_bwd_case(qshape, sk, causal, dtype, 30 + i))
        if dtype == torch.bfloat16:
            # phase 14's training shapes: CLIP-B/16's causal text tower at
            # batch 128, the temporal ViT's 1568-token clips at batch 32 and
            # its MAP probe against them
            for i, (qshape, sk, causal) in enumerate([
                    ((128, 77, 8, 64), 77, True),
                    ((32, 1568, 12, 64), 1568, False),
                    ((32, 1, 12, 64), 1568, False)]):
                add("flash_attention",
                    flash_case(qshape, sk, causal, dtype, 300 + i))
                add("flash_attention_bwd",
                    flash_bwd_case(qshape, sk, causal, dtype, 310 + i))
        # masked flash (kernel row 4, row 7's mask kind): the NaFlex train
        # shapes (batch 128) with the synthetic generator's masks, a
        # serve-like batch of 32, and odd ones, one with a fully masked
        # sample (its rows checked for finiteness only)
        for i, (qshape, sk, causal, kind) in enumerate([
                ((128, 256, 12, 64), 256, False, "naflex"),  # image
                ((128, 1, 12, 64), 256, False, "naflex"),    # MAP probe
                ((32, 256, 12, 64), 256, False, "naflex"),   # serve batch
                ((32, 1, 12, 64), 256, False, "naflex"),
                ((2, 5, 2, 80), 5, True, "sparse"),
                ((2, 257, 2, 64), 257, False, "len63"),
                ((2, 257, 2, 80), 257, False, "len65"),
                ((2, 1, 2, 80), 257, False, "sparse"),
                ((2, 65, 2, 64), 65, False, "empty_row"),
                ((1, 70, 1, 256), 130, True, "sparse")]):
            add("flash_attention_masked", masked_flash_case(
                qshape, sk, causal, kind, dtype, 50 + i))
        for i, (qshape, sk, causal, kind) in enumerate([
                ((128, 256, 12, 64), 256, False, "naflex"),  # image
                ((128, 1, 12, 64), 256, False, "naflex"),    # MAP probe
                ((2, 5, 2, 80), 5, True, "sparse"),
                ((2, 257, 2, 64), 257, False, "len64"),
                ((2, 1, 2, 80), 257, False, "sparse"),
                ((2, 65, 2, 64), 65, False, "empty_row"),
                ((1, 70, 1, 256), 130, True, "sparse")]):
            add("flash_attention_masked_bwd", masked_flash_bwd_case(
                qshape, sk, causal, kind, dtype, 70 + i))
        # int8-QK flash (kernel rows 9 and 10): the int8_qk train shapes
        # (batch 128) and odd ones: seq 1, 5 and 257, causal and not, D 64
        # and 80 (and 256)
        for i, (qshape, sk, causal) in enumerate([
                ((128, 256, 12, 64), 256, False),  # image self-attention
                ((128, 1, 12, 64), 256, False),    # MAP probe
                ((128, 64, 12, 64), 64, False),    # text self-attention
                ((2, 1, 2, 64), 1, False), ((2, 5, 2, 80), 5, True),
                ((2, 5, 2, 80), 5, False), ((2, 257, 2, 64), 257, True),
                ((2, 257, 2, 80), 257, False), ((2, 1, 2, 80), 257, False),
                ((1, 70, 1, 256), 130, True)]):
            add("flash_attention_int8",
                int8_flash_case(qshape, sk, causal, dtype, 90 + i))
            add("flash_attention_int8_bwd",
                int8_flash_bwd_case(qshape, sk, causal, dtype, 110 + i))
        # sigmoid flash (kernel row 6, row 7's sigmoid kind): the sigmoid
        # train shapes (batch 128) and odd ones, causal and masked, one
        # sample with no key to attend
        for i, (qshape, sk, causal, kind) in enumerate([
                ((128, 256, 12, 64), 256, False, None),  # image
                ((128, 1, 12, 64), 256, False, None),    # MAP probe
                ((128, 64, 12, 64), 64, False, None),    # text
                ((2, 1, 2, 64), 1, False, None), ((2, 5, 2, 80), 5, True, None),
                ((2, 257, 2, 64), 257, True, None),
                ((2, 257, 2, 80), 257, False, "len65"),
                ((2, 1, 2, 80), 257, False, "sparse"),
                ((2, 65, 2, 64), 65, True, "empty_row"),
                ((1, 70, 1, 256), 130, True, "sparse")]):
            add("sigmoid_attention",
                sigmoid_case(qshape, sk, causal, kind, dtype, 200 + i))
            add("sigmoid_attention_bwd",
                sigmoid_bwd_case(qshape, sk, causal, kind, dtype, 220 + i))
        # biased flash (kernel row 5, row 7's bias kind, row 8): phase 11's
        # shapes (batch 128, a (12, Sq, Sk) bias) and odd ones: seq 1, 5 and
        # 257, D 80 and 256, causal, a broadcast (Sq, Sk) bias, -inf entries
        # and a row with no finite key
        for i, (qshape, sk, causal, kind) in enumerate([
                ((128, 256, 12, 64), 256, False, "full"),  # image
                ((128, 1, 12, 64), 256, False, "full"),    # MAP probe
                ((128, 64, 12, 64), 64, False, "full"),    # text
                ((2, 1, 2, 64), 1, False, "full"),
                ((2, 5, 2, 80), 5, True, "full"),
                ((2, 257, 2, 64), 257, True, "full"),
                ((2, 257, 2, 80), 257, False, "2d"),
                ((2, 65, 2, 64), 65, False, "neginf"),
                ((1, 70, 1, 256), 130, True, "full")]):
            add("flash_attention_bias",
                bias_case(qshape, sk, causal, kind, dtype, 240 + i))
            add("flash_attention_bias_bwd",
                bias_bwd_case(qshape, sk, causal, kind, dtype, 260 + i))
            add("flash_attention_dbias",
                dbias_case(qshape, sk, causal, kind, dtype, 260 + i))
        if dtype == torch.bfloat16:
            odd_tensor_core_cases(add)
    # int8 matmul (kernel row 11): the served shapes at bucket 32 (8192
    # token rows; the MAP head's q and out projections have 32) with a
    # bias, fc1's with relu and gelu, and odd shapes
    for i, (m, k, n, act) in enumerate([
            (8192, 768, 768, None),     # q, k, v, out
            (8192, 768, 3072, None),    # fc1
            (8192, 3072, 768, None),    # fc2
            (32, 768, 768, None),       # MAP head q, out
            (8192, 768, 3072, "relu"), (8192, 768, 3072, "gelu"),
            *((m, k, n, act) for m, k, n in ODD_MATMUL_SHAPES
              for act in (None, "relu", "gelu"))]):
        add("int8_matmul", int8_matmul_case(m, k, n, act, 130 + i))
    add("int8_matmul", int8_matmul_case(64, 96, 40, None, 129, offset=4))
    # fp8 GEMM (kernel row 12): the three GEMMs of each Linear of the
    # fp8_hybrid train step (batch 128) at every (K, N), then odd shapes.
    # forward y = x_q . w_q^T (+ bias); dx = dy_q . (w_q^T)^T; dw = (dy_q^T)
    # . (x_q^T)^T, the backward's operands K-contiguous copies
    seed = 300
    for m in (32768, 8192, 128):   # image, text, MAP-probe token rows
        for k, n in FP8_KN:
            for name, shape, a_dtype, bias in (
                    ("fp8_matmul", (m, k, n), fp8.E4M3, True),
                    ("fp8_matmul_bwd", (m, n, k), fp8.E5M2, False),
                    ("fp8_matmul_bwd", (n, m, k), fp8.E5M2, False)):
                seed += 1
                add(name, fp8_gemm_case(*shape, a_dtype, bias, seed))
    # odd shapes: K of 7, 100 and 769 and a base off a 16-byte boundary take
    # the wrapper's K-padded copies
    for m, k, n in ODD_MATMUL_SHAPES:
        seed += 1
        add("fp8_matmul", fp8_gemm_case(m, k, n, fp8.E4M3, True, seed))
        add("fp8_matmul_bwd", fp8_gemm_case(m, k, n, fp8.E5M2, False, seed))
    seed += 1
    add("fp8_matmul", fp8_gemm_case(64, 96, 40, fp8.E4M3, True, seed,
                                    offset=4))
    for a_dtype in (fp8.E4M3, fp8.E5M2):
        fp8_accumulator_case(a_dtype)
    rows_against_recorded(cases, card)
    first = {}
    for name, c in cases:  # the first case of each kernel: bf16, main shape
        first.setdefault(name, c)
        if "body" in c:  # and of each body of the LayerNorm kernels
            first.setdefault(f"{name}:{c['body']}", c)
    return first


# -- phase 4: serve ----------------------------------------------------------

def _post(port: int, payload: dict, path: str = "/v1/embed"
          ) -> tuple[float, dict]:
    body = json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        out = json.loads(resp.read())
    return time.perf_counter() - t0, out


def _b64(img: np.ndarray) -> dict:
    return {"image_b64": base64.b64encode(img.tobytes()).decode(),
            "shape": list(img.shape)}


def serve_phase(card: str, dtype: str = "bf16") -> dict:
    """Phase 4 (``dtype="bf16"``) or phase 7 (``"int8"``): the model as
    ``serve --dtype DTYPE`` builds it, behind the HTTP server."""
    cfg = configs.with_runtime(configs.preset("siglip-base-patch16-256"),
                               ln_impl="fused")
    check(cfg.vision.attn_impl == "auto", "preset attn_impl changed")
    t0 = time.perf_counter()
    model, quantized = cli.serving_model(
        cfg, dtype, "cuda",
        generator=torch.Generator(device="cuda").manual_seed(0))
    int8 = dtype == "int8"
    check(quantized == (INT8_QUANTIZED if int8 else 0),
          f"serve --dtype {dtype} quantized {quantized} Linears")
    label = "int8 serve" if int8 else "serve"
    size = cfg.vision.image_size
    engine = InferenceEngine(
        image_forward(model), item_shape=(size, size, 3),
        buckets=BucketTable((1, 8, 32)), max_delay_ms=10.0,
        policy=AdmissionPolicy(max_queue=256, default_timeout_s=120.0))
    server = ServingServer(engine, port=0, request_timeout_s=300.0)
    server.start()
    print(f"{label}: SigLIP-B/16-256 {dtype} built and warmed "
          f"(buckets {engine.buckets.sizes}, {quantized} Linears quantized) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    mm_per_batch = INT8_MATMUL_PER_BATCH if int8 else 0
    traffic = served_traffic(server, model, "encode_image", label, {
        "flash_attention": FLASH_PER_BATCH, "layer_norm": LN_PER_BATCH,
        "int8_matmul": mm_per_batch}, cfg.vision.width, card)
    features, batch = traffic.pop("features"), traffic.pop("batch")
    if int8:
        # the unquantized twin: the same seeded weights in f32
        twin, _ = cli.serving_model(
            cfg, "f32", "cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))
        full = encode_all(twin, batch)
        del twin
        full_cos = (features * full).sum(1) / (
            np.linalg.norm(features, axis=1) * np.linalg.norm(full, axis=1))
        print(f"{label}: cosine against the unquantized f32 model: min "
              f"{full_cos.min():.6f}, mean {full_cos.mean():.6f} (the JAX "
              f"package's floor for int8 serving is 0.999, "
              f"docs/quantization.md) | {card}", flush=True)
    forward_readout(model, batch, card, "int8 " if int8 else "")
    return traffic


def served_traffic(server: ServingServer, model, method: str, label: str,
                   per_batch: dict[str, int], out_dim: int, card: str,
                   client: ServeClient | None = None, keep: bool = False
                   ) -> dict:
    """Phase 4's traffic against a started server (stopped here unless
    ``keep``): 48 /v1/embed requests from 16 client threads, then one bulk
    request of 32, base64 bodies (by urllib, or by the stdlib ``client``),
    every kernel counter set to 0 just before and read just after. Fails
    unless each counter of ``per_batch`` shows that many launches per batch
    dispatched meanwhile and no other kernel launched, and every answer, a
    row of ``out_dim`` values, matches ``model.<method>`` with the plain
    versions swapped in (cosine, norms). Prints latency, images/s and peak
    memory; returns the counts (with ``batches``), the features and the
    input batch."""
    engine = server.engine
    size = engine.item_shape[0]
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (80, size, size, 3)).astype(np.float32)
    if client is None:
        # base64 bodies: a JSON list of 196,608 floats per image is parsed
        # in Python on the server side and would dominate the timed traffic
        # (the list form is covered by the CPU tests)
        singles = [_b64(img) for img in images[:48]]
        bulk = {"images": [_b64(img) for img in images[48:]]}

        def single(payload):
            return _post(server.port, payload)

        def bulk_post():
            return _post(server.port, bulk)
    else:
        singles = list(images[:48])

        def single(image):
            t0 = time.perf_counter()
            out = client.embed(image)
            return time.perf_counter() - t0, {"features": list(out)}

        def bulk_post():
            t0 = time.perf_counter()
            out = client.embed_many(images[48:])
            return time.perf_counter() - t0, {"features": out}
    try:
        torch.cuda.reset_peak_memory_stats()
        batches_before = engine.metrics.count("batches_total")
        zero_counts()
        t_start = time.perf_counter()
        with ThreadPoolExecutor(16) as pool:
            answers = list(pool.map(single, singles))
        t_bulk = time.perf_counter()
        bulk_s, bulk_out = bulk_post()
        t_end = time.perf_counter()
        counts = read_counts()
        batches = int(engine.metrics.count("batches_total") - batches_before)
        peak = torch.cuda.max_memory_allocated()
    finally:
        if not keep:
            server.stop()
    features = np.asarray([out["features"] for _, out in answers]
                          + bulk_out["features"], np.float32)
    check(features.shape == (80, out_dim), f"features shape {features.shape}")
    check(bool(np.isfinite(features).all()), "non-finite features")
    check(batches > 0 and all(counts[k] == n * batches
                              for k, n in per_batch.items()),
          f"launch counts over {batches} batches: {counts}")
    check(sum(n for k, n in counts.items() if k not in per_batch) == 0,
          f"serving launched other kernels: {counts}")
    images_per_s = len(images) / (t_end - t_start)
    print(f"{label}: {batches} batches dispatched; launches "
          + ", ".join(f"{k} {counts[k]} = {n}/batch"
                      for k, n in per_batch.items()), flush=True)

    batch = torch.from_numpy(images).to("cuda", next(model.parameters()).dtype)
    ref = encode_all(model, batch, plain=True, method=method)
    check(read_counts() == counts, "the reference forward launched a kernel")
    cos, norm_err = served_gate(features, ref, f"{label}: served features")
    lat = np.asarray([s for s, _ in answers]) * 1e3
    print(f"{label}: 80 answers match the plain-version forward, min cosine "
          f"{cos.min():.6f}, norms within {norm_err.max():.2e}", flush=True)
    print(f"{label}: /v1/embed single-request latency p50 "
          f"{np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f}"
          f" ms (48 requests, 16 client threads) | {card}", flush=True)
    print(f"{label}: {48 / (t_bulk - t_start):.1f} images/s over the singles, "
          f"{32 / bulk_s:.1f} images/s for the bulk request of 32, "
          f"{images_per_s:.1f} images/s overall | {card}", flush=True)
    print(f"{label}: torch.cuda.max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB) | {card}", flush=True)
    return dict(counts, batches=batches, images_per_s=images_per_s,
                p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                features=features, batch=batch)


def served_gate(got: np.ndarray, ref: np.ndarray, what: str
                ) -> tuple[np.ndarray, np.ndarray]:
    """Row by row: cosine >= SERVE_MIN_COS and norms within SERVE_NORM_RTOL
    (a uniformly scaled answer fails the second); the cosines and the norm
    errors."""
    norm, ref_norm = np.linalg.norm(got, axis=1), np.linalg.norm(ref, axis=1)
    cos = (got * ref).sum(1) / (norm * ref_norm)
    norm_err = np.abs(norm / ref_norm - 1)
    check(bool((cos >= SERVE_MIN_COS).all()),
          f"{what} vs plain forward: min cosine {cos.min()}")
    check(bool((norm_err <= SERVE_NORM_RTOL).all()),
          f"{what} vs plain forward: norm off by {norm_err.max()}")
    return cos, norm_err


def encode_all(model, batch: torch.Tensor, plain: bool = False,
               method: str = "encode_image") -> np.ndarray:
    """``model.<method>`` (``"forward"``: the model itself) over the batch in
    buckets of 32, through the kernels or (``plain``) their plain versions,
    as f32 numpy."""
    fn = model if method == "forward" else getattr(model, method)
    out = []
    with (plain_versions() if plain else contextlib.nullcontext()), \
            torch.inference_mode():
        for i in range(0, batch.shape[0], 32):
            out.append(fn(batch[i:i + 32]).float().cpu().numpy())
    return np.concatenate(out)


@contextlib.contextmanager
def plain_versions(keep_flash: bool = False):
    """The model's kernel calls answered by the kernels' plain versions.

    ``keep_flash``: the softmax flash Function (unmasked and masked) stays
    too, with the plain forward and backward inside, as the int8, sigmoid
    and bias Functions always do; its backward then takes delta =
    rowsum(do * o) from the stored o, rounded to the model's dtype, as the
    kernels and JAX's ``_flash_bwd`` do. Without it, autograd
    differentiates the plain forward, whose o is never rounded."""
    def plain_ln(x, w, b, eps=1e-6):
        return ln.layer_norm_plain(x, w, b, eps)[0]

    def plain_flash(q, k, v, *, is_causal=False):
        return fa.flash_attention_plain(q, k, v, is_causal=is_causal)[0]

    def plain_masked(q, k, v, mask, *, is_causal=False):
        mask = fa.canon_mask(mask, q.shape[0], k.shape[1])
        return fa.flash_attention_plain(q, k, v, is_causal=is_causal,
                                        mask=mask)[0]

    def plain_flash_fwd(q, k, v, is_causal, mask=None):
        return fa.flash_attention_plain(q, k, v, is_causal=is_causal,
                                        mask=mask)

    def plain_fp8(a_q, b_q, scale, bias=None, *, backward=False):
        return fp8.fp8_gemm_plain(a_q, b_q, scale, bias)

    flash = ([(fa, "_fwd", plain_flash_fwd),
              (fa, "flash_attention_bwd", fa.flash_attention_bwd_plain)]
             if keep_flash else
             [(attention_mod, "flash_attention", plain_flash),
              (attention_mod, "flash_attention_masked", plain_masked)])
    # the int8, fp8, sigmoid and bias Functions stay (their backwards are
    # the functions under test); inside them the plain versions answer
    with contextlib.ExitStack() as stack:
        for module, name, plain in flash + [
                (norm_mod, "layer_norm", plain_ln),
                (fa8, "flash_attention_int8_fwd",
                 fa8.flash_attention_int8_plain),
                (fa8, "flash_attention_int8_bwd",
                 fa8.flash_attention_int8_bwd_plain),
                (mm, "int8_matmul", mm.int8_matmul_plain),
                (fp8, "fp8_gemm", plain_fp8),
                (fa, "sigmoid_attention_fwd", fa.sigmoid_attention_plain),
                (fa, "sigmoid_attention_bwd", fa.sigmoid_attention_bwd_plain),
                (fa, "flash_attention_bias_fwd",
                 fa.flash_attention_bias_plain),
                (fa, "flash_attention_bias_bwd",
                 fa.flash_attention_bias_bwd_plain),
                (fa, "flash_attention_dbias",
                 fa.flash_attention_dbias_plain)]:
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def forward_readout(model, batch: torch.Tensor, card: str,
                    label: str = "", method: str = "encode_image"
                    ) -> float | None:
    """Device time of one ``model.<method>`` per bucket (kernels, then plain
    versions), and where a bucket-32 forward's device time goes; returns
    that forward's kernel time in ms (None when the trace recorded none)."""
    fn = model if method == "forward" else getattr(model, method)
    with torch.inference_mode():
        for size in (1, 8, 32):
            x = batch[:size]

            def fwd():
                return fn(x)

            k_call, k_dev = cuda_ms(fwd, iters=10), device_ms(fwd, iters=10)
            with plain_versions():
                p_call, p_dev = (cuda_ms(fwd, iters=10),
                                 device_ms(fwd, iters=10))
            print(f"{label}forward: {method} bucket {size}: kernels "
                  f"{k_call:.3f}"
                  f" ms per call, {k_dev:.3f} ms device busy (idle "
                  f"{max(0.0, 1 - k_dev / k_call):.0%}); plain versions "
                  f"{p_call:.3f} ms per call, {p_dev:.3f} ms device busy "
                  f"| {card}", flush=True)
        with profiler_session(cuda_only=True) as prof:
            fn(batch[:32])
            torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in _device_rows(prof)), reverse=True)
    total = sum(r[0] for r in rows)
    if not total:
        print(f"profile: the trace of a {label}bucket-32 forward recorded no "
              f"device time", flush=True)
        return None
    print(f"profile: {label}bucket-32 forward, {total / 1e3:.3f} ms of kernel "
          f"time | {card}", flush=True)
    for us, count, key in rows[:10]:
        print(f"profile:   {us / 1e3:8.3f} ms {100 * us / total:5.1f}% "
              f"x{count:<4d} {key[:90]}", flush=True)
    return total / 1e3


# -- phase 5: train ----------------------------------------------------------

def _train_model(dtype: torch.dtype, attn_impl: str | None = None
                 ) -> SigLIP:
    """SigLIP-B/16-256 with fused LayerNorm, its attention as the preset
    has it ("auto") or ``attn_impl``."""
    cfg = configs.preset("siglip-base-patch16-256")
    check(cfg.vision.attn_impl == "auto", "preset attn_impl changed")
    cfg = configs.with_runtime(cfg, ln_impl="fused",
                               **({"attn_impl": attn_impl} if attn_impl
                                  else {}))
    return SigLIP(cfg, device="cuda", dtype=dtype,
                  generator=torch.Generator(device="cuda").manual_seed(0))


def _batch(cfg, batch: int, dtype: torch.dtype, seed: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One synthetic batch as ``bench.py`` makes it: normal images, tokens
    in [1, vocab)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    size = cfg.vision.image_size
    images = torch.randn(batch, size, size, 3, generator=g,
                         device="cuda").to(dtype)
    text = torch.randint(1, cfg.text.vocab_size,
                         (batch, cfg.text.context_length), generator=g,
                         device="cuda")
    return images, text


@contextlib.contextmanager
def quantization_tape(tape: list, replay: bool, module, name: str):
    """Records every result of the quantizer ``module.name`` in a run into
    ``tape``, or (``replay``) hands the recorded ones back in order, so that
    a second run quantizes as the first one did."""
    quantize, replayed = getattr(module, name), iter(tape)

    def record(x, *args):
        tape.append(quantize(x, *args))
        return tape[-1]

    def play(x, *args):
        out = next(replayed)
        x_q = out[0] if isinstance(out, tuple) else out
        check(x_q.shape == x.shape, "the replayed run quantized another "
              "tensor")
        return out

    with mock.patch.object(module, name, play if replay else record):
        yield


def grads_phase(model: SigLIP, images, text, want: dict[str, int],
                label: str, card: str, held: tuple | None = None,
                zero_k_bias: bool = True) -> None:
    """One f32 step's gradients through the kernels (whose launches must
    be ``want``) against the same step with the plain versions swapped in:
    every parameter within 1e-3 of its largest gradient.

    ``held``, a quantizer as ``(module, name)`` (the int8_qk step's
    ``quantize_heads``, the fp8_hybrid step's ``quantize_tensor``): the
    plain-version step quantizes exactly as the kernel step did.
    Quantization is discontinuous: a one-ulp difference upstream (the
    LayerNorm and flash kernels round otherwise than their plain versions)
    can move an int8 value by one step and a gradient by ~2e-3 of its
    largest value (seen on the card), a property of the quantized function,
    not of a kernel; held fixed, both steps differentiate the same function.

    The model's buffers (the fp8 amax histories, which every forward rolls)
    start both steps from the same values, and must end them within
    ``FP8_HIST_RTOL`` of each other.

    A bf16 model also runs the per-gradient gate of :func:`norm_gate`
    against a third step in f32; ``zero_k_bias``: the k-projection biases'
    gradients are zero in exact arithmetic (softmax attention) and are left
    out of it."""
    tape: list = []
    start = {n: b.clone() for n, b in model.named_buffers()}
    zero_counts()
    with (quantization_tape(tape, False, *held) if held
          else contextlib.nullcontext()):
        contrastive_loss_fn(model, images, text, kind="siglip").backward()
    counts = read_counts()
    check(all(counts[k] == n for k, n in want.items()),
          f"{label}: launch counts {counts}, want {want}")
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    rolled = {n: b.clone() for n, b in model.named_buffers()}
    for n, b in model.named_buffers():
        b.copy_(start[n])
    model.zero_grad(set_to_none=True)
    with plain_versions(), (quantization_tape(tape, True, *held)
                            if held else contextlib.nullcontext()):
        contrastive_loss_fn(model, images, text, kind="siglip").backward()
    check(read_counts() == counts,
          f"{label}: the plain-version step launched a kernel")
    if rolled:
        hist = max(((rolled[n] - b).abs().max()
                    / b.abs().max().clamp_min(1e-30)).item()
                   for n, b in model.named_buffers())
        check(hist <= FP8_HIST_RTOL and all(
            not (rolled[n] == start[n]).all()
            for n in rolled), f"{label}: histories after the two steps "
              f"differ by {hist:.3e} of their values, or did not roll")
        print(f"{label}: {len(rolled)} amax histories after the kernel and "
              f"the plain-version step agree within {hist:.3e} of their "
              f"largest value | {card}", flush=True)
    worst, worst_cos, under = (0.0, ""), (1.0, ""), 0
    low_cos = (1.0, "")  # bf16, a reading: every gradient but the k biases
    params = dict(model.named_parameters())
    check(all(got[n] is not None and p.grad is not None
              for n, p in params.items()), "a parameter got no gradient")
    bf16 = next(iter(params.values())).dtype == torch.bfloat16
    # a gradient that is zero in exact arithmetic (the k-projection bias:
    # softmax does not see a per-row shift of the scores) is held to a floor
    # (f32: 1e-3, bf16: 2^-4) of the model's largest gradient instead of its
    # own; in bf16 every gradient above the floor also keeps its direction
    top = max(p.grad.float().abs().max().item() for p in params.values())
    floor = (BF16_GRAD_FLOOR if bf16 else 1e-3) * top
    bound = BF16_GRAD_REL_ERR if bf16 else TRAIN_GRAD_REL_ERR
    for name, p in params.items():
        check(bool(torch.isfinite(got[name]).all()),
              f"non-finite gradient for {name}")
        g, want = got[name].float(), p.grad.float()
        own = want.abs().max().item()
        rel = (g - want).abs().max().item() / max(own, floor)
        check(rel <= bound,
              f"{label} gradient of {name}: max abs error {rel:.3e} of its "
              f"largest value (bound {bound:.3e})")
        worst = max(worst, (rel, name))
        under += own <= floor
        if bf16 and own > 0 and not name.endswith("attn.k.bias"):
            low_cos = min(low_cos, (F.cosine_similarity(
                g.flatten(), want.flatten(), dim=0).item(), name))
        if bf16 and own > floor:
            cos = F.cosine_similarity(g.flatten(), want.flatten(),
                                      dim=0).item()
            check(cos >= BF16_GRAD_MIN_COS,
                  f"{label} gradient of {name}: cosine {cos:.6f}")
            worst_cos = min(worst_cos, (cos, name))
    print(f"{label}, {len(got)} parameter gradients through the kernels "
          f"match the plain versions; worst max abs error {worst[0]:.3e} of "
          f"the largest value ({worst[1]}), {under} under the floor of "
          f"{floor:.3e}" + (f", lowest cosine {worst_cos[0]:.6f} "
                            f"({worst_cos[1]}); reading: lowest cosine of "
                            f"any gradient but the k biases "
                            f"{low_cos[0]:.6f} ({low_cos[1]})" if bf16
                            else "") + f" | {card}", flush=True)
    if bf16:
        # the plain bf16 step again, the flash Functions kept (the kernels'
        # delta), then the f32 step
        for n, b in model.named_buffers():
            b.copy_(start[n])
        model.zero_grad(set_to_none=True)
        with plain_versions(keep_flash=True), (
                quantization_tape(tape, True, *held) if held
                else contextlib.nullcontext()):
            contrastive_loss_fn(model, images, text, kind="siglip").backward()
        plain = {n: p.grad for n, p in params.items()}
        exact = f32_reference_grads(model, images, text, start, tape, held)
        check(read_counts() == counts,
              f"{label}: a plain-version step launched a kernel")
        norm_gate(got, plain, exact, label, card,
                  skip="attn.k.bias" if zero_k_bias else None)


def _f32_batch(images):
    """The batch's floating tensors in f32 (a NaFlex batch is a tuple:
    patches, spatial shapes, mask)."""
    if isinstance(images, (tuple, list)):
        return type(images)(_f32_batch(t) for t in images)
    return images.float() if images.is_floating_point() else images


def f32_reference_grads(model: SigLIP, images, text, start: dict,
                        tape: list, held: tuple | None
                        ) -> dict[str, torch.Tensor]:
    """One step's gradients of an f32 copy of ``model`` (its bf16 values
    widened exactly, its buffers as ``start``) on the f32 batch, through the
    plain versions; ``held``: the quantizations in ``tape`` replayed."""
    ref = copy.deepcopy(model).float()
    for n, b in ref.named_buffers():
        b.copy_(start[n])
    ref.zero_grad(set_to_none=True)
    with plain_versions(), (quantization_tape(tape, True, *held)
                            if held else contextlib.nullcontext()):
        contrastive_loss_fn(ref, _f32_batch(images), text,
                            kind="siglip").backward()
    return {n: p.grad for n, p in ref.named_parameters()}


def norm_gate(kernel: dict[str, torch.Tensor], plain: dict[str, torch.Tensor],
              exact: dict[str, torch.Tensor], label: str, card: str,
              skip: str | None) -> None:
    """Each gradient through the kernels within ``BF16_GRAD_NORM_R`` times
    the plain bf16 step's distance from the f32 step, plus
    ``BF16_GRAD_NORM_EPS`` of the f32 gradient's norm (2-norms over the
    parameter). Left out: names ending in ``skip``, and one-element
    parameters (logit_scale, logit_bias), whose "norm" is a single draw of
    the rounding noise, so that the ratio of two draws has no bound. Prints
    the largest share of its bound any gradient uses."""
    worst, left_out = (0.0, ""), []
    for name, t in exact.items():
        if (skip and name.endswith(skip)) or t.numel() == 1:
            left_out.append(name)
            continue
        t = t.double()
        e_kernel = (kernel[name].double() - t).norm().item()
        e_plain = (plain[name].double() - t).norm().item()
        bound = BF16_GRAD_NORM_R * e_plain + BF16_GRAD_NORM_EPS * t.norm(
            ).item()
        check(e_kernel <= bound,
              f"{label} gradient of {name}: ||kernel - f32|| {e_kernel:.3e} "
              f"over {BF16_GRAD_NORM_R} ||plain - f32|| {e_plain:.3e} + "
              f"{BF16_GRAD_NORM_EPS} ||f32|| (bound {bound:.3e})")
        worst = max(worst, (e_kernel / bound if bound else 0.0, name))
    print(f"{label}, per-gradient gate against the f32 plain-version step: "
          f"{len(exact) - len(left_out)} gradients within "
          f"{BF16_GRAD_NORM_R} ||plain - f32|| + {BF16_GRAD_NORM_EPS} "
          f"||f32||, largest share of the bound {worst[0]:.3f} "
          f"({worst[1]}); left to the floor: {len(left_out)} (k biases "
          f"under softmax, one-element parameters) | {card}", flush=True)


def _dtype_name(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


def train_grads_phase(card: str, dtype: torch.dtype = torch.float32) -> None:
    """(a) batch 8, f32 (the FMA bodies) or bf16 (the flash kernels'
    tensor-core bodies): one step's gradients through the kernels against
    the same step with the plain versions swapped in."""
    model = _train_model(dtype)
    images, text = _batch(model.config, 8, dtype, 1)
    grads_phase(model, images, text, step_counts(),
                f"train: {_dtype_name(dtype)} batch 8", card)


def step_counts(precision: str | None = None, naflex: bool = False,
                sigmoid: bool = False) -> dict[str, int]:
    """Kernel launches per train step of SigLIP-B/16-256 (or, with
    ``naflex``, SigLIP2-B/16-256 on NaFlex batches) under ``precision``,
    or with every attention on sigmoid attention."""
    flash, masked, int8, sig = (
        (NAFLEX_FLASH_PER_STEP, NAFLEX_MASKED_PER_STEP, 0, 0) if naflex
        else (0, 0, FLASH_PER_STEP, 0) if precision == "int8_qk"
        else (0, 0, 0, FLASH_PER_STEP) if sigmoid
        else (FLASH_PER_STEP, 0, 0, 0))
    linears = FP8_LINEARS if precision == "fp8_hybrid" else 0
    return {"flash_attention": flash, "flash_attention_bwd": flash,
            "flash_attention_masked": masked,
            "flash_attention_masked_bwd": masked,
            "layer_norm": LN_PER_STEP, "layer_norm_bwd": LN_PER_STEP,
            "flash_attention_int8": int8, "flash_attention_int8_bwd": int8,
            "int8_matmul": 0, "fp8_matmul": linears,
            "fp8_matmul_bwd": 2 * linears, "sigmoid_attention": sig,
            "sigmoid_attention_bwd": sig, "flash_attention_bias": 0,
            "flash_attention_bias_bwd": 0, "flash_attention_dbias": 0}


def int8_qk_grads_phase(card: str, dtype: torch.dtype = torch.float32
                        ) -> None:
    """8(a) batch 8 in f32 (the FMA bodies) or bf16 (the tensor-core
    bodies), every attention on the int8-QK flash kernels: one step's
    gradients through the kernels against the same step with the plain
    versions swapped in, the quantizations of q and k replayed."""
    model = _train_model(dtype)
    check(apply_precision_policy(model, "int8_qk") == FLASH_PER_STEP,
          "int8_qk did not rewrite every attention")
    images, text = _batch(model.config, 8, dtype, 1)
    grads_phase(model, images, text, step_counts("int8_qk"),
                f"int8_qk: {_dtype_name(dtype)} batch 8", card,
                held=(fa8, "quantize_heads"))


def fp8_grads_phase(card: str) -> None:
    """9(a) f32, batch 8, every eligible Linear on the fp8 GEMM: one step's
    gradients through the kernels against the plain versions, every fp8
    quantization held, and the histories after both steps."""
    model = _train_model(torch.float32)
    check(apply_precision_policy(model, "fp8_hybrid") == FP8_LINEARS,
          "fp8_hybrid did not rewrite every eligible Linear")
    images, text = _batch(model.config, 8, torch.float32, 1)
    grads_phase(model, images, text, step_counts("fp8_hybrid"),
                "fp8_hybrid: f32 batch 8", card,
                held=(fp8, "quantize_tensor"))


def sigmoid_grads_phase(card: str, dtype: torch.dtype = torch.float32
                        ) -> None:
    """10(a) batch 8 in f32 or bf16, every attention on sigmoid attention:
    one step's gradients through the kernels against the plain versions."""
    model = _train_model(dtype, attn_impl="sigmoid")
    images, text = _batch(model.config, 8, dtype, 1)
    # sigmoid attention is not shift-invariant: the k biases get a gradient
    grads_phase(model, images, text, step_counts(sigmoid=True),
                f"sigmoid: {_dtype_name(dtype)} batch 8", card,
                zero_k_bias=False)


def train_phase(card: str, precision: str | None = None,
                attn_impl: str | None = None
                ) -> tuple[dict[str, int], dict[str, int]]:
    """(b) bf16, batch 128: the train step's speed and launch counts, under
    the precision policy ``precision`` (phases 8(b), 9(b)), with every
    attention on ``attn_impl`` (10(b)), or as built (5(b)). Returns the
    launches over the timed steps, and the LayerNorm backward's launches by
    body in a traced step. The new paths (fp8_hybrid, sigmoid) also
    run one step under the sync debug mode: it must not wait on the host."""
    model = _train_model(torch.bfloat16, attn_impl)
    label = f"{precision or attn_impl}: train" if precision or attn_impl \
        else "train"
    if precision:
        want_rewritten = (FP8_LINEARS if precision == "fp8_hybrid"
                          else FLASH_PER_STEP)
        check(apply_precision_policy(model, precision) == want_rewritten,
              f"{precision} did not rewrite every module it takes")
    cfg = model.config
    optimizer = make_optimizer(model, OptimizerConfig(
        learning_rate=SIGMOID_LEARNING_RATE if attn_impl == "sigmoid"
        else 1e-3))
    step = make_contrastive_train_step("siglip")
    images, text = _batch(cfg, TRAIN_BATCH, torch.bfloat16, 2)
    torch.cuda.reset_peak_memory_stats()
    losses = [step(model, optimizer, images, text)["loss"]
              for _ in range(TRAIN_WARMUP)]
    float(model.logit_scale.detach())
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        losses.append(step(model, optimizer, images, text)["loss"])
    # logit_scale depends on the last update: the chain has finished
    float(model.logit_scale.detach())
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    counts = read_counts()
    want = step_counts(precision, sigmoid=attn_impl == "sigmoid")
    check(all(counts[k] == want[k] * TRAIN_STEPS for k in want),
          f"{label} launch counts over {TRAIN_STEPS} steps: {counts}")
    loss = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(loss).all()), f"non-finite loss: {loss}")
    check(loss[-1] < loss[0], f"loss did not fall: {loss.tolist()}")
    peak = torch.cuda.max_memory_allocated()
    flops = train_step_flops(cfg, TRAIN_BATCH)
    per_step = {k: n // TRAIN_STEPS for k, n in counts.items() if n}
    print(f"{label}: bf16 batch {TRAIN_BATCH}, {TRAIN_STEPS} timed steps "
          f"after {TRAIN_WARMUP} warm-up: launches per step {per_step}",
          flush=True)
    print(f"{label}: loss {loss[0].item():.4f} at step 0 -> "
          f"{loss[-1].item():.4f} after step {len(losses) - 1}", flush=True)
    print(f"{label}: step {dt * 1e3:.3f} ms, {TRAIN_BATCH / dt:.1f} images/s, "
          f"MFU {mfu(flops, dt, 989.0):.4f} of 989 TFLOP/s "
          f"({flops / 1e12:.3f} TFLOP a step), torch.cuda.max_memory_allocated "
          f"{peak} bytes ({peak / 2**30:.2f} GiB) | {card}", flush=True)
    if precision == "fp8_hybrid" or attn_impl:
        syncs = host_syncs(lambda: step(model, optimizer, images, text))
        check(not syncs, f"{label}: the step synchronised with the host: "
              f"{syncs[:3]}")
        print(f"{label}: one step under torch.cuda.set_sync_debug_mode"
              f"('warn'): 0 host syncs | {card}", flush=True)
    return counts, step_readout(model, optimizer, step, images, text, card)


def host_syncs(fn) -> list[str]:
    """The warnings ``torch.cuda.set_sync_debug_mode("warn")`` raises while
    ``fn`` runs: one per operation that makes the host wait for the card."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]


def profile_readout(fn, what: str, card: str) -> list[tuple]:
    """Device-busy share of one profiled call of ``fn`` (``what`` names it)
    and its top kernels; returns the profile's ``(device us, launches,
    kernel name)`` rows, largest first (the call is run again, up to three
    times, while a trace comes back with no device rows)."""
    for _ in range(3):
        torch.cuda.synchronize()
        with profiler_session(cuda_only=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in _device_rows(prof)), reverse=True)
        total = sum(r[0] for r in rows)
        if total:
            break
    else:
        print(f"profile: the trace of {what} recorded no device time",
              flush=True)
        return rows
    print(f"profile: {what}, {total / 1e3:.3f} ms of kernel time in "
          f"{wall * 1e3:.3f} ms wall (device busy {total / 1e3 / (wall * 1e3):.1%}"
          f", traced) | {card}", flush=True)
    for us, count, key in rows[:12]:
        print(f"profile:   {us / 1e3:8.3f} ms {100 * us / total:5.1f}% "
              f"x{count:<4d} {key[:90]}", flush=True)
    return rows


def step_readout(model, optimizer, step, images, text, card: str
                 ) -> dict[str, int]:
    """Device-busy share of one profiled train step and its top kernels.
    Every LayerNorm backward of the step (``LN_PER_STEP``, each tower's
    rows at width 768) must run the register body, none the CTA body;
    returns each body's launches and prints their device time."""
    rows = profile_readout(lambda: step(model, optimizer, images, text),
                           "one train step", card)
    bodies, ms = {}, 0.0
    for kind, kernel in ln.BACKWARD_KERNELS.items():
        hits = [(us, n) for us, n, key in rows
                if kernel + "<" in key or kernel + "I" in key]
        bodies[kind] = sum(n for _, n in hits)
        ms += sum(us for us, _ in hits) / 1e3
    check(bodies == {"register": LN_PER_STEP, "cta": 0},
          f"the traced step's LayerNorm backward launches by body: {bodies}, "
          f"want all {LN_PER_STEP} on the register body")
    print(f"profile: the step's {LN_PER_STEP} LayerNorm backwards, all on "
          f"the register body: {ms:.3f} ms of kernel time | {card}",
          flush=True)
    return bodies


def zero_counts() -> None:
    fa.launches = fa.bwd_launches = ln.launches = ln.bwd_launches = 0
    fa.masked_launches = fa.masked_bwd_launches = 0
    fa.sigmoid_launches = fa.sigmoid_bwd_launches = 0
    fa.bias_launches = fa.bias_bwd_launches = fa.dbias_launches = 0
    fa8.launches = fa8.bwd_launches = mm.launches = 0
    fp8.launches = fp8.bwd_launches = 0


def read_counts() -> dict[str, int]:
    return {"flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches,
            "flash_attention_masked": fa.masked_launches,
            "flash_attention_masked_bwd": fa.masked_bwd_launches,
            "layer_norm": ln.launches, "layer_norm_bwd": ln.bwd_launches,
            "flash_attention_int8": fa8.launches,
            "flash_attention_int8_bwd": fa8.bwd_launches,
            "int8_matmul": mm.launches, "fp8_matmul": fp8.launches,
            "fp8_matmul_bwd": fp8.bwd_launches,
            "sigmoid_attention": fa.sigmoid_launches,
            "sigmoid_attention_bwd": fa.sigmoid_bwd_launches,
            "flash_attention_bias": fa.bias_launches,
            "flash_attention_bias_bwd": fa.bias_bwd_launches,
            "flash_attention_dbias": fa.dbias_launches}


def run_train_command(argv: list[str], card: str,
                      keep_optimizer: bool = False) -> dict:
    """The ``train`` command ``argv``, run in this process so that its
    launches can be counted: the counters are zeroed just before it and
    read just after, and the causal flag of each flash forward is recorded.
    Its JSON lines are printed with a ``cli:`` prefix. Returns its exit
    code, counts, causal flags, peak memory, logged steps, summary line
    and, with ``keep_optimizer``, its optimizer."""
    out = io.StringIO()
    made = []

    def recorded(*args, **kwargs):
        made.append(make_optimizer(*args, **kwargs))
        return made[-1]

    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "metrics.jsonl"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with causal_flags() as flags, \
                mock.patch.object(cli, "make_optimizer", recorded):
            zero_counts()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv + ["--metrics-file", str(path)])
            counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        logged = [json.loads(line) for line in path.read_text().splitlines()]
    printed = out.getvalue().splitlines()
    for line in printed:
        print(f"cli: {line} | {card}", flush=True)
    return {"rc": rc, "counts": counts, "flags": list(flags), "peak": peak,
            "logged": logged, "summary": json.loads(printed[-1]),
            "optimizer": made[-1] if keep_optimizer else None}


def cli_train_phase(card: str, naflex: bool = False,
                    precision: str | None = None) -> dict:
    """(c) The ``train`` command, run in this process so that its launches
    can be counted: the counters are zeroed just before it and read just
    after. Its JSON lines are printed with a ``cli:`` prefix. With
    ``naflex``, SigLIP2-B/16-256 on NaFlex batches (phase 6(c)); with
    ``precision``, under that policy (phase 8(c)). Returns the run
    (:func:`run_train_command`)."""
    argv = ["train", "--preset", NAFLEX_PRESET if naflex
            else "siglip-base-patch16-256", "--bf16",
            "--ln-impl", "fused", "--steps", str(CLI_STEPS), "--batch-size",
            str(TRAIN_BATCH), "--log-every", "1"] + (
                ["--naflex"] if naflex else []) + (
                ["--precision", precision] if precision else [])
    run = run_train_command(argv, card)
    rc, counts, peak, logged, summary = (
        run[k] for k in ("rc", "counts", "peak", "logged", "summary"))
    check(rc == 0 and summary.get("status") == "trained"
          and summary.get("device", "").startswith("cuda")
          and summary.get("precision") == (precision or "bf16")
          and (precision != "fp8_hybrid"
               or summary.get("precision_modules") == FP8_LINEARS),
          f"python -m jimm_tpu_torch {' '.join(argv)}: rc {rc}, {summary}")
    check([r["step"] for r in logged] == list(range(CLI_STEPS)),
          f"train command logged steps {[r['step'] for r in logged]}")
    check(all(math.isfinite(r["loss"]) and r["mfu"] is not None
              for r in logged), f"train command metrics: {logged}")
    want = step_counts(precision, naflex)
    check(all(counts[k] == want[k] * CLI_STEPS for k in want),
          f"train command launch counts over {CLI_STEPS} steps: {counts}")
    times = [r["step_time_s"] * 1e3 for r in logged]
    print(f"cli: train command, {CLI_STEPS} steps at batch {TRAIN_BATCH}: "
          f"launches {counts}; step times {[round(t, 3) for t in times]} ms; "
          f"torch.cuda.max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB) | {card}", flush=True)
    return run


# -- phase 6: NaFlex ---------------------------------------------------------

def _naflex_model(dtype: torch.dtype) -> SigLIP:
    cfg = configs.with_runtime(configs.preset(NAFLEX_PRESET),
                               ln_impl="fused")
    check(cfg.vision.attn_impl == "auto", "preset attn_impl changed")
    return SigLIP(cfg, device="cuda", dtype=dtype,
                  generator=torch.Generator(device="cuda").manual_seed(0))


def _naflex_batch(cfg, batch: int, dtype: torch.dtype, seed: int):
    """One ``naflex_contrastive_pairs`` batch on the card, as the train
    command makes it: ``((patches, spatial_shapes, mask), text)``."""
    triple, text = next(naflex_contrastive_pairs(
        batch, patch_size=cfg.vision.patch_size,
        max_num_patches=cfg.vision.num_patches,
        seq_len=cfg.text.context_length, vocab_size=cfg.text.vocab_size,
        seed=seed))
    return (place(triple, torch.device("cuda"), dtype),
            torch.from_numpy(text).to("cuda", torch.long))


def naflex_grads_phase(card: str, dtype: torch.dtype = torch.float32
                       ) -> None:
    """(a) batch 8 in f32 or bf16: one NaFlex step's gradients through the
    kernels against the plain versions."""
    model = _naflex_model(dtype)
    images, text = _naflex_batch(model.config, 8, dtype, 1)
    check(not bool(images[2].all()), "the NaFlex batch has no padding")
    grads_phase(model, images, text, step_counts(naflex=True),
                f"naflex: {_dtype_name(dtype)} batch 8", card)


def naflex_forward_phase(card: str) -> None:
    """(b) bf16, batch 32: ``encode_image_naflex`` through the kernels
    against the plain-version forward, and poisoned padding."""
    model = _naflex_model(torch.bfloat16)
    model.eval()
    (patches, shapes, mask), _ = _naflex_batch(
        model.config, NAFLEX_SERVE_BATCH, torch.bfloat16, 3)
    with torch.inference_mode():
        zero_counts()
        got = model.encode_image_naflex(patches, shapes, mask).float()
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts["flash_attention_masked"] == NAFLEX_MASKED_PER_STEP
              and counts["flash_attention"] == 0
              and counts["layer_norm"] == LN_PER_BATCH,
              f"encode_image_naflex launches {counts}")
        with plain_versions():
            ref = model.encode_image_naflex(patches, shapes, mask).float()
        check(read_counts() == counts,
              "the plain-version forward launched a kernel")
        poisoned = patches.clone()
        poisoned[~mask] = 1e4
        out = model.encode_image_naflex(poisoned, shapes, mask).float()
    check(bool(torch.isfinite(got).all()), "non-finite NaFlex features")
    cos = F.cosine_similarity(got, ref, dim=1)
    norm_err = (got.norm(dim=1) / ref.norm(dim=1) - 1).abs()
    check(bool((cos >= SERVE_MIN_COS).all()),
          f"NaFlex features vs plain forward: min cosine {cos.min()}")
    check(bool((norm_err <= SERVE_NORM_RTOL).all()),
          f"NaFlex features vs plain forward: norm off by {norm_err.max()}")
    leak = (out - got).abs().max().item()
    check(bool(torch.isfinite(out).all())
          and leak <= 1e-3 * got.abs().max().item(),
          f"poisoned padding moved the features by {leak}")
    print(f"naflex: encode_image_naflex bf16 batch {NAFLEX_SERVE_BATCH}: "
          f"launches {counts}; min cosine {cos.min().item():.6f} against "
          f"the plain versions, norms within {norm_err.max().item():.2e}; "
          f"poisoned padding moved the features by {leak:.3e} | {card}",
          flush=True)
    with torch.inference_mode():
        def fwd():
            return model.encode_image_naflex(patches, shapes, mask)

        k_call, k_dev = cuda_ms(fwd, iters=10), device_ms(fwd, iters=10)
    print(f"naflex: encode_image_naflex batch {NAFLEX_SERVE_BATCH}: "
          f"{k_call:.3f} ms per call, {k_dev:.3f} ms device busy | {card}",
          flush=True)


def naflex_train_phase(card: str) -> None:
    """(c, first part) bf16, batch 128, one fixed NaFlex batch repeated:
    step time, MFU, peak memory and one profiled step."""
    model = _naflex_model(torch.bfloat16)
    cfg = model.config
    optimizer = make_optimizer(model, OptimizerConfig(learning_rate=1e-3))
    step = make_contrastive_train_step("siglip")
    images, text = _naflex_batch(cfg, TRAIN_BATCH, torch.bfloat16, 2)
    torch.cuda.reset_peak_memory_stats()
    losses = [step(model, optimizer, images, text)["loss"]
              for _ in range(TRAIN_WARMUP)]
    float(model.logit_scale.detach())
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(NAFLEX_TRAIN_STEPS):
        losses.append(step(model, optimizer, images, text)["loss"])
    float(model.logit_scale.detach())
    dt = (time.perf_counter() - t0) / NAFLEX_TRAIN_STEPS
    counts = read_counts()
    want = step_counts(naflex=True)
    check(all(counts[k] == want[k] * NAFLEX_TRAIN_STEPS for k in want),
          f"NaFlex train launch counts over {NAFLEX_TRAIN_STEPS} steps: "
          f"{counts}")
    loss = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(loss).all()), f"non-finite loss: {loss}")
    peak = torch.cuda.max_memory_allocated()
    flops = train_step_flops(cfg, TRAIN_BATCH)
    print(f"naflex: train bf16 batch {TRAIN_BATCH}, {NAFLEX_TRAIN_STEPS} "
          f"timed steps after {TRAIN_WARMUP} warm-up: loss "
          f"{loss[0].item():.4f} -> {loss[-1].item():.4f}; step "
          f"{dt * 1e3:.3f} ms, {TRAIN_BATCH / dt:.1f} images/s, MFU "
          f"{mfu(flops, dt, 989.0):.4f} of 989 TFLOP/s "
          f"({flops / 1e12:.3f} TFLOP a step), torch.cuda.max_memory_allocated "
          f"{peak} bytes ({peak / 2**30:.2f} GiB) | {card}", flush=True)
    step_readout(model, optimizer, step, images, text, card)


# -- phase 11: bias ------------------------------------------------------------

def _bias_kernel_counts() -> tuple[int, int, int]:
    counts = read_counts()
    return (counts["flash_attention_bias"], counts["flash_attention_bias_bwd"],
            counts["flash_attention_dbias"])


def bias_grads_phase(card: str) -> None:
    """(a) f32, batch 8: ``dot_product_attention(..., bias=b, impl="auto")``
    forward and backward through rows 5, 7-bias and 8 (one launch each,
    nothing else), against the same call with the plain versions swapped
    in: every gradient within 1e-3 of its largest value; a (12, 256, 256)
    bias, then a (256, 256) one, whose gradient is summed over heads."""
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, cot = (torch.randn(8, 256, 12, 64, generator=g, device="cuda")
                    for _ in range(4))
    for shape in ((12, 256, 256), (256, 256)):
        bias = torch.randn(*shape, generator=g, device="cuda") * 0.5
        inputs = tuple(t.clone().requires_grad_() for t in (q, k, v, bias))

        def run():
            o = attention_mod.dot_product_attention(*inputs[:3],
                                                    bias=inputs[3])
            return o, torch.autograd.grad(o, inputs, cot)

        zero_counts()
        o, got = run()
        counts = read_counts()
        check(all(n == (1 if "bias" in name else 0)
                  for name, n in counts.items()),
              f"bias: f32 batch 8 {shape}: launch counts {counts}")
        with plain_versions():
            po, want = run()
        check(read_counts() == counts,
              f"bias: f32 batch 8 {shape}: the plain versions launched a "
              f"kernel")
        errs = [(compare(a, w)[0] / max(w.abs().max().item(), 1e-30), name)
                for a, w, name in zip((o, *got), (po, *want),
                                      ("o", "dq", "dk", "dv", "dbias"))]
        check(got[3].shape == shape and all(
            e <= TRAIN_GRAD_REL_ERR for e, _ in errs),
            f"bias: f32 batch 8 {shape}: max abs error / largest value of "
            f"o and the gradients {errs}")
        print(f"bias: f32 batch 8, bias {shape}: o, dq, dk, dv, dbias "
              f"through rows 5, 7-bias and 8 match the plain versions; "
              f"worst max abs error {max(errs)[0]:.3e} of the largest value "
              f"({max(errs)[1]}) | {card}", flush=True)


def bias_train_phase(card: str) -> dict[str, int]:
    """(b) bf16, batch 128: 12 biased calls, one per SigLIP-B/16 vision
    block, each with its own q, k, v and learnable (12, 256, 256) bias,
    forward and backward: 12 launches of each of rows 5, 7-bias and 8 and
    none else; then the time of the 12 calls against the same calls without
    a bias and against SDPA with the bias as a float attn_mask that requires
    grad; one profiled pass. Returns the counts of the counted pass."""
    g = torch.Generator(device="cuda").manual_seed(12)
    shape = (TRAIN_BATCH, 256, 12, 64)
    qkv = [tuple(torch.randn(*shape, generator=g, device="cuda")
                 .to(torch.bfloat16).requires_grad_() for _ in range(3))
           for _ in range(BIAS_CALLS)]
    biases = [(torch.randn(12, 256, 256, generator=g, device="cuda") * 0.5)
              .requires_grad_() for _ in range(BIAS_CALLS)]
    cot = torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    def biased():
        outs = [attention_mod.dot_product_attention(q, k, v, bias=b)
                for (q, k, v), b in zip(qkv, biases)]
        return outs, torch.autograd.grad(
            outs, [t for x in qkv for t in x] + biases, [cot] * BIAS_CALLS)

    def unbiased():
        outs = [attention_mod.dot_product_attention(q, k, v)
                for q, k, v in qkv]
        torch.autograd.grad(outs, [t for x in qkv for t in x],
                            [cot] * BIAS_CALLS)

    sdpa_in = [tuple(t.detach().transpose(1, 2).requires_grad_()
                     for t in x) for x in qkv]
    masks = [b.detach()[None].to(torch.bfloat16).requires_grad_()
             for b in biases]

    def sdpa():
        outs = [F.scaled_dot_product_attention(q, k, v, attn_mask=m)
                for (q, k, v), m in zip(sdpa_in, masks)]
        torch.autograd.grad(outs, [t for x in sdpa_in for t in x] + masks,
                            [cot.transpose(1, 2)] * BIAS_CALLS)

    biased()  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    outs, grads = biased()
    torch.cuda.synchronize()
    counts = read_counts()
    check(all(n == (BIAS_CALLS if "bias" in name else 0)
              for name, n in counts.items()),
          f"bias: bf16 batch {TRAIN_BATCH}: launch counts {counts}")
    check(all(bool(torch.isfinite(t).all()) for t in (*outs, *grads)),
          "bias: non-finite output or gradient")
    check(all(gb.shape == (12, 256, 256) and gb.dtype == torch.float32
              for gb in grads[-BIAS_CALLS:]), "bias: dbias shape or dtype")
    print(f"bias: bf16 batch {TRAIN_BATCH}, {BIAS_CALLS} biased calls "
          f"forward and backward: launches {_bias_kernel_counts()} of rows "
          f"5, 7-bias and 8 | {card}", flush=True)
    times = {"biased": (cuda_ms(biased, iters=5, warmup=1),
                        device_ms(biased, iters=5, warmup=1)),
             "unbiased": (cuda_ms(unbiased, iters=5, warmup=1),
                          device_ms(unbiased, iters=5, warmup=1))}
    try:
        times["sdpa"] = (cuda_ms(sdpa, iters=5, warmup=1),
                         device_ms(sdpa, iters=5, warmup=1))
    except RuntimeError as e:
        print(f"bias: SDPA refused a float attn_mask that requires grad: "
              f"{str(e)[:160]}", flush=True)
    for name, (call, dev) in times.items():
        print(f"bias: {BIAS_CALLS} {name} calls forward and backward, bf16 "
              f"batch {TRAIN_BATCH}: {call:.3f} ms per pass, {dev:.3f} ms "
              f"device busy | {card}", flush=True)
    profile_readout(biased, f"{BIAS_CALLS} biased calls forward and backward",
                    card)
    return counts


def bias_routing_phase(card: str) -> None:
    """(c) On the card, as JAX on the TPU: a 4-D bias, or a bias with a
    key-padding mask, goes to the einsum path and moves no kernel counter;
    "flash" with a key-padding mask and a bias raises JAX's ValueError."""
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(8, 256, 12, 64, generator=g, device="cuda")
               for _ in range(3))
    bias = torch.randn(12, 256, 256, generator=g, device="cuda")
    # the key-padding mask as the NaFlex tower builds it, (B, 1, 1, Sk):
    # the einsum path takes masks broadcastable to (B, N, Sq, Sk)
    mask = torch.rand(8, 1, 1, 256, generator=g, device="cuda") > 0.2
    zero_counts()
    for kw in (dict(bias=bias[None]), dict(bias=bias, mask=mask)):
        o = attention_mod.dot_product_attention(q, k, v, **kw)
        check(bool(torch.isfinite(o).all()), "bias: non-finite einsum path")
    check(not any(read_counts().values()),
          f"bias: a 4-D bias or a bias with a mask launched a kernel: "
          f"{read_counts()}")
    try:
        attention_mod.dot_product_attention(q, k, v, bias=bias, mask=mask,
                                            impl="flash")
        raised = "nothing"
    except ValueError as e:
        raised = str(e)
    check(raised == FLASH_MASKED_BIAS_ERROR,
          f"bias: flash with a mask and a bias raised {raised!r}")
    print(f"bias: a 4-D bias and a bias with a mask take the einsum path (0 "
          f"kernel launches); flash with a mask and a bias raises JAX's "
          f"ValueError | {card}", flush=True)


# -- phase 12: checkpoints ---------------------------------------------------

def checkpoint_round_trips(card: str, root: pathlib.Path
                           ) -> dict[str, pathlib.Path]:
    """12(a): each family's full-width model in bf16, seeded (ViT's head,
    zero at init, drawn from the generator), through ``save_pretrained``
    and back through ``from_pretrained`` onto the card: every parameter
    ``torch.equal``, the same keys, and ``config_from_hf(hf_config())`` the
    config (CLIP's unset eos_token_id written as 2, which means the same
    argmax pooling); SigLIP also in the siglip2 flavor. Returns the ViT and
    CLIP checkpoint directories."""
    dirs = {}
    for fam, flavor in (("vit", None), ("clip", None), ("siglip", None),
                        ("siglip", "siglip2")):
        cls, name = cli.MODELS[fam], CKPT_PRESETS[fam]
        cfg = configs.preset(name)
        g = torch.Generator(device="cuda").manual_seed(12)
        model = cls(cfg, device="cuda", dtype=torch.bfloat16, generator=g)
        if fam == "vit":
            with torch.no_grad():
                model.classifier.weight.normal_(0.0, 0.02, generator=g)
        want_cfg = (dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, eos_token_id=2)) if fam == "clip" else cfg)
        d = root / (flavor or fam)
        t0 = time.perf_counter()
        model.save_pretrained(d, **({"flavor": flavor} if flavor else {}))
        save_s = time.perf_counter() - t0
        nbytes = (d / "model.safetensors").stat().st_size
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = cls.from_pretrained(d, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want = dict(model.named_parameters())
        got = dict(loaded.named_parameters())
        check(set(got) == set(want), f"{name}: the loaded keys differ")
        differ = [k for k, p in want.items() if not torch.equal(got[k], p)]
        check(not differ, f"{name}: parameters changed in the round trip: "
                          f"{differ[:5]}")
        check(all(p.device.type == "cuda" for p in got.values()),
              f"{name}: from_pretrained did not load onto the card")
        weights, _ = resolve_checkpoint(d)
        check(cls.config_from_hf(model.hf_config(), weights) == want_cfg
              and loaded.config == want_cfg,
              f"{name}: config_from_hf(hf_config()) != the config")
        if flavor:
            check(loaded._hf_source_flavor == flavor,
                  f"{name}: loaded as {loaded._hf_source_flavor}")
        print(f"checkpoints: {name}{f' ({flavor} flavor)' if flavor else ''} "
              f"bf16: model.safetensors {nbytes} bytes "
              f"({nbytes / 2**20:.1f} MiB), {len(want)} parameters; "
              f"save_pretrained {save_s:.3f} s, from_pretrained onto the "
              f"card {load_s:.3f} s; every parameter equal, keys and config "
              f"equal | {card}", flush=True)
        del model, loaded, weights
        if flavor:
            shutil.rmtree(d)
        else:
            dirs[fam] = d
    return dirs


def checkpoint_serve_phase(card: str, fam: str, ckpt: pathlib.Path):
    """12(b) and (d): ``serve --ckpt CKPT --model FAM --dtype bf16
    --ln-impl fused`` built by the CLI's own parser and ``build_server``,
    then phase 4's traffic and gates with this tower's launches per batch;
    then the forward's time per bucket and the kernels of a bucket-32
    forward. Returns the counts and the served model."""
    label = f"{fam} serve"
    t0 = time.perf_counter()
    server, model, ready = cli.build_server(cli.build_parser().parse_args([
        "serve", "--ckpt", str(ckpt), "--model", fam, "--device", "cuda",
        "--dtype", "bf16", "--ln-impl", "fused", "--buckets", "1,8,32",
        "--port", "0",
        "--max-delay-ms", "10", "--queue-size", "256", "--timeout-s",
        "120"]))
    check(ready["device"].startswith("cuda") and ready["dtype"] == "bfloat16",
          f"{label}: ready line {ready}")
    print(f"{label}: serve --ckpt {ckpt.name} --model {fam} built and warmed "
          f"in {time.perf_counter() - t0:.1f} s: {json.dumps(ready)}",
          flush=True)
    method = cli.SERVED_METHOD[fam]
    out_dim = (model.config.num_classes if fam == "vit"
               else model.config.projection_dim)
    traffic = served_traffic(server, model, method, label, {
        "flash_attention": CKPT_FLASH_PER_BATCH,
        "layer_norm": CKPT_LN_PER_BATCH[fam]}, out_dim, card)
    traffic.pop("features")
    batch = traffic.pop("batch")
    ms = forward_readout(model, batch, card, f"{fam} ", method)
    if ms is not None:
        print(f"{label}: bucket-32 forward {ms:.3f} ms of kernel time "
              f"({32e3 / ms:.1f} images/s at that time); served "
              f"{traffic['images_per_s']:.1f} images/s overall | {card}",
              flush=True)
    return traffic, model, batch


def clip_text_phase(card: str, model, images: torch.Tensor) -> dict:
    """12(c): ``encode_text`` of the served CLIP-B/16 at (32, 77), every
    attention on row 3's causal kind (each flash call's ``is_causal``
    recorded), against the plain versions (cosine, norms), then
    ``CLIP.forward``'s logits for 32 images against those texts (cosine)."""
    cfg = model.config.text
    rng = np.random.default_rng(12)
    b, s = CLIP_TEXT_SHAPE[0], cfg.context_length
    check((b, s) == CLIP_TEXT_SHAPE, f"clip text: context length {s}")
    text = rng.integers(1, cfg.vocab_size - 1, (b, s))
    eot = rng.integers(5, s, b)
    text[np.arange(b), eot] = cfg.vocab_size - 1  # EOT, the largest id
    text[np.arange(s)[None, :] > eot[:, None]] = 0
    tokens = torch.from_numpy(text).to("cuda")
    causal = []
    real_fwd = fa._fwd

    def spy(q, k, v, is_causal, mask=None):
        causal.append(bool(is_causal))
        return real_fwd(q, k, v, is_causal, mask)

    zero_counts()
    with mock.patch.object(fa, "_fwd", spy), torch.inference_mode():
        got = model.encode_text(tokens).float().cpu().numpy()
    counts = read_counts()
    check(counts["flash_attention"] == CLIP_TEXT_FLASH
          and causal == [True] * CLIP_TEXT_FLASH
          and counts["layer_norm"] == CLIP_TEXT_LN
          and sum(counts.values()) == CLIP_TEXT_FLASH + CLIP_TEXT_LN,
          f"clip text: launches {counts}, causal flags {causal}")
    want = encode_all(model, tokens, plain=True, method="encode_text")
    cos, norm_err = served_gate(got, want, "clip encode_text")
    print(f"clip text: encode_text {CLIP_TEXT_SHAPE}: {CLIP_TEXT_FLASH} "
          f"causal flash and {CLIP_TEXT_LN} LayerNorm launches; min cosine "
          f"{cos.min():.6f}, norms within {norm_err.max():.2e} of the plain "
          f"versions", flush=True)
    with torch.inference_mode():
        logits = model(images[:b], tokens).float().cpu().numpy()
        with plain_versions():
            ref = model(images[:b], tokens).float().cpu().numpy()
        scale = model.logit_scale.exp().item()
    # the logits get the cosine gate only: a logit is exp(logit_scale) times
    # the cosine of an image and a text embedding, and between untrained
    # towers those cosines are near 0, so a row's norm moves by the
    # features' bf16 differences (gated above, with their norms) over |cos|
    norm, ref_norm = (np.linalg.norm(logits, axis=1),
                      np.linalg.norm(ref, axis=1))
    cos = (logits * ref).sum(1) / (norm * ref_norm)
    check(bool((cos >= SERVE_MIN_COS).all()),
          f"clip logits vs plain forward: min cosine {cos.min()}")
    print(f"clip text: CLIP.forward logits ({b} images x {b} texts) min "
          f"cosine {cos.min():.6f} against the plain versions; readings: "
          f"row norms within {np.abs(norm / ref_norm - 1).max():.2e}, max "
          f"abs error {np.abs(logits - ref).max():.3e} = "
          f"{np.abs(logits - ref).max() / scale:.2e} of exp(logit_scale) "
          f"{scale:.3f}, mean |cosine| between the towers "
          f"{np.abs(ref).mean() / scale:.3f}", flush=True)
    with torch.inference_mode():
        def fwd():
            return model.encode_text(tokens)

        k_dev = device_ms(fwd, iters=10)
        with plain_versions():
            p_dev = device_ms(fwd, iters=10)
    print(f"clip text: encode_text {CLIP_TEXT_SHAPE} {k_dev:.3f} ms of kernel "
          f"time, plain versions {p_dev:.3f} ms | {card}", flush=True)
    return dict(counts, batches=0)


def checkpoint_phase(card: str, root: pathlib.Path
                     ) -> tuple[dict[str, dict], dict[str, pathlib.Path]]:
    """Phase 12: the round trips (checkpoints under ``root``), the ViT and
    CLIP servers from their checkpoints, CLIP's text tower; the counts of
    each path and the checkpoint directories."""
    ckpts = checkpoint_round_trips(card, root)
    vit_counts, model, _ = checkpoint_serve_phase(card, "vit", ckpts["vit"])
    del model
    clip_counts, model, batch = checkpoint_serve_phase(card, "clip",
                                                       ckpts["clip"])
    text_counts = clip_text_phase(card, model, batch)
    return {"vit_serve": vit_counts, "clip_serve": clip_counts,
            "clip_text": text_counts}, ckpts


# -- phase 13: zero-shot classification and offline evaluation ---------------

def write_clip_vocab(d: pathlib.Path) -> None:
    """A synthetic CLIP vocabulary in the real layout: ``vocab.json`` with
    the byte alphabet (``bytes_to_unicode``), its ``</w>`` forms, a few
    merged tokens and the specials last (so EOT is the largest id), and
    ``merges.txt``."""
    alphabet = list(bytes_to_unicode().values())
    merges = [("t", "h"), ("th", "e</w>"), ("c", "a"), ("ca", "t</w>"),
              ("p", "h"), ("ph", "o"), ("o", "f</w>"), ("i", "n"),
              ("a", "n"), ("an", "d</w>"), ("e", "r</w>"), ("a", "</w>")]
    tokens = (alphabet + [ch + "</w>" for ch in alphabet]
              + ["".join(m) for m in merges]
              + ["<|startoftext|>", "<|endoftext|>"])
    (d / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(tokens)}), encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n",
        encoding="utf-8")


def prompt_table(tok: CLIPTokenizer, labels, templates=TEMPLATES) -> dict:
    """``{label: [[ids] for each template]}``: a /v1/classify or
    ``--zero-shot`` token table."""
    return {label: [tok.encode(t.format(label)) for t in templates]
            for label in labels}


@contextlib.contextmanager
def causal_flags():
    """Records the ``is_causal`` flag of every flash forward launched
    inside (from any thread)."""
    flags: list[bool] = []
    real = fa._fwd

    def spy(q, k, v, is_causal, mask=None):
        flags.append(bool(is_causal))
        return real(q, k, v, is_causal, mask)

    with mock.patch.object(fa, "_fwd", spy):
        yield flags


def expect_launches(what: str, counts: dict, flags: list[bool], fam: str,
                    batches: int, encodes: int, masked: bool = False
                    ) -> None:
    """``batches`` image forwards of ``fam``'s tower and ``encodes`` text
    tower runs launched these kernels and no other: CLIP's text attention
    causal, every other flash call not; ``masked``: the image tower on the
    masked kernels (NaFlex)."""
    img_flash, img_ln = IMAGE_LAUNCHES[fam]
    txt_flash, txt_ln = TEXT_LAUNCHES
    want = {"flash_attention": encodes * txt_flash
            + (0 if masked else batches * img_flash),
            "flash_attention_masked": batches * img_flash if masked else 0,
            "layer_norm": encodes * txt_ln + batches * img_ln}
    causal = encodes * txt_flash if fam == "clip" else 0
    ok = (all(counts[k] == n for k, n in want.items())
          and sum(counts.values()) == sum(want.values())
          and flags.count(True) == causal)
    check(ok, f"{what}: launches {counts}, causal flags {flags.count(True)} "
              f"of {len(flags)}; want {want}, {causal} causal "
              f"({batches} image batches, {encodes} text encodes)")
    print(f"{what}: {batches} image batches and {encodes} text encodes: "
          + ", ".join(f"{k} {n}" for k, n in want.items() if n)
          + f" launches ({causal} causal) as expected", flush=True)


def logits_bound(kind: str, model, plain: np.ndarray) -> float:
    """13(c)'s eps for this pass (see ``LOGITS_EPS``)."""
    largest = float(np.abs(plain).max())
    scale = (largest if kind == "top1"
             else float(np.exp(np.float32(model.logit_scale.item()))))
    ulp = (2.0 ** (math.floor(math.log2(largest)) - 7)
           if kind != "zero_shot" and largest > 0 else 0.0)
    return LOGITS_EPS * scale + ulp


def _top2_margin(logits: np.ndarray, axis: int) -> np.ndarray:
    if logits.shape[axis] < 2:
        return np.full(logits.shape[1 - axis], np.inf)
    top = -np.sort(-logits, axis=axis)
    top = top if axis == 1 else top.T
    return top[:, 0] - top[:, 1]


def zero_shot_serve_phase(card: str, fam: str, ckpt: pathlib.Path,
                          vocab: CLIPTokenizer) -> dict:
    """13(a): ``serve --ckpt CKPT --model FAM --dtype bf16 --ln-impl
    fused`` (buckets 1, 8, 32) answers /v1/classify for two label sets of
    10 labels x the 7 TEMPLATES: the first request of each set alone
    (``"cached": false``: the text tower runs), the rest from 16 client
    threads (``"cached": true``: only the image tower). Gates: the
    launches (the text tower once a label set), the class weights against
    the plain versions' (row-wise cosine), the image features (cosine,
    norms), and the logits within eps: from the served scores and from the
    kernels' features against the plain versions'."""
    label = f"{fam} classify serve"
    t0 = time.perf_counter()
    server, model, ready = cli.build_server(cli.build_parser().parse_args([
        "serve", "--ckpt", str(ckpt), "--model", fam, "--device", "cuda",
        "--dtype", "bf16", "--ln-impl", "fused", "--buckets", "1,8,32",
        "--port", "0", "--max-delay-ms", "10", "--queue-size", "256",
        "--timeout-s", "120"]))
    check(ready["zero_shot"], f"{label}: ready line {ready}")
    print(f"{label}: built and warmed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    zs = server.zero_shot
    zs.cache = EmbeddingCache()
    sets = ZS_REQUESTS[fam]
    tables = [prompt_table(vocab, names) for names in ZS_LABEL_SETS[:2]]
    size = model.config.vision.image_size
    rng = np.random.default_rng(13)
    images = rng.uniform(-1, 1, (sum(sets), size, size, 3)).astype(
        np.float32)
    answers = []  # (label set, seconds, answer) in image order
    try:
        zero_counts()
        with causal_flags() as flags:
            t_start = time.perf_counter()
            i = 0
            for si, (table, n) in enumerate(zip(tables, sets)):
                def ask(img, table=table):
                    return _post(server.port, {**_b64(img), "tokens": table},
                                 "/v1/classify")

                answers.append((si, *ask(images[i])))
                with ThreadPoolExecutor(16) as pool:
                    answers += [(si, *a)
                                for a in pool.map(ask, images[i + 1:i + n])]
                i += n
            wall = time.perf_counter() - t_start
        counts = read_counts()
        batches = server.engine.metrics.count("batches_total")
        stats = zs.cache.stats()
        weights = [zs.class_weights_blocking(t)[1] for t in tables]
    finally:
        server.stop()
    first = [sum(sets[:si]) for si in range(len(sets))]
    cached = [a["cached"] for _, _, a in answers]
    check(all(cached[j] == (j not in first) for j in range(len(cached))),
          f"{label}: cached flags {cached}")
    expect_launches(label, counts, flags, fam, batches, len(sets))
    # the class weights against the plain versions', row by row (unit rows)
    ctx = model.config.text.context_length
    rows_cos = []
    with plain_versions():
        for table, w in zip(tables, weights):
            names, rows, owner = token_table_rows(table, ctx)
            ref = weights_from_rows(model, rows, owner, len(names)).numpy()
            rows_cos.append((w * ref).sum(1) / np.linalg.norm(w, axis=1)
                            / np.linalg.norm(ref, axis=1))
    rows_cos = np.concatenate(rows_cos)
    check(bool((rows_cos >= SERVE_MIN_COS).all()),
          f"{label}: class weights vs plain: min cosine {rows_cos.min()}")
    # the logits: kernel features and weights against the plain versions'
    batch = torch.from_numpy(images).to("cuda", torch.bfloat16)
    feats = {"kernels": encode_all(model, batch),
             "plain": encode_all(model, batch, plain=True)}
    ref_w = []
    with plain_versions():
        for table in tables:
            names, rows, owner = token_table_rows(table, ctx)
            ref_w.append(weights_from_rows(model, rows, owner,
                                           len(names)).numpy())

    def logits(f: np.ndarray, w: np.ndarray) -> np.ndarray:
        f = f / np.linalg.norm(f, axis=-1, keepdims=True)
        out = zs._scale * f @ w.T
        return out if zs._bias is None else out + zs._bias

    feat_cos, feat_norm = served_gate(feats["kernels"], feats["plain"],
                                      f"{label}: image features")
    set_of = [si for si, _, _ in answers]
    got = np.stack([logits(feats["kernels"][j], weights[si])
                    for j, si in enumerate(set_of)])
    ref = np.stack([logits(feats["plain"][j], ref_w[si])
                    for j, si in enumerate(set_of)])
    # the logits are exp(logit_scale) times cosines between the towers,
    # near 0 for untrained ones, so a row's cosine magnifies the features'
    # bf16 differences (gated above): they are held to eps, a reading
    # printed beside the cosine
    eps = LOGITS_EPS * zs._scale
    err = np.abs(got - ref).max()
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1)
                                * np.linalg.norm(ref, axis=1))
    check(err <= eps, f"{label}: logits vs plain: max abs error {err} > "
                      f"eps {eps} (min cosine {cos.min()})")
    # the served scores carry their logits: CLIP's softmax up to a constant
    # (compared centered), SigLIP's sigmoid exactly
    names = [list(t) for t in tables]
    scores = np.stack([[a["scores"][k] for k in names[si]]
                       for si, _, a in answers])
    check(bool((scores > 0).all()), f"{label}: a score rounded to 0")
    if fam == "clip":
        served = np.log(scores)
        served -= served.mean(1, keepdims=True)
        want = ref - ref.mean(1, keepdims=True)
    else:
        served, want = np.log(scores / (1 - scores)), ref
    served_err = np.abs(served - want).max()
    check(served_err <= 2 * eps,
          f"{label}: served scores' logits vs plain: max abs error "
          f"{served_err} > {2 * eps}")
    lat = np.asarray([s for j, (_, s, _) in enumerate(answers)
                      if j not in first]) * 1e3
    print(f"{label}: class weights min cosine {rows_cos.min():.6f}; image "
          f"features min cosine {feat_cos.min():.6f}, norms within "
          f"{feat_norm.max():.2e}; logits max abs error {err:.3e} = "
          f"{err / zs._scale:.2e} of exp(logit_scale) {zs._scale:.3f} (eps "
          f"{eps:.4f}); readings: logits min cosine {cos.min():.6f}, mean "
          f"|cosine| between the towers "
          f"{np.abs(ref - (zs._bias or 0.0)).mean() / zs._scale:.4f}; served scores' logits within "
          f"{served_err:.3e} of the plain versions' (gate {2 * eps:.3f})",
          flush=True)
    print(f"{label}: {len(answers)} /v1/classify requests, {batches} "
          f"batches: {len(answers) / wall:.1f} images/s; cached-request "
          f"latency p50 {np.percentile(lat, 50):.2f} ms p99 "
          f"{np.percentile(lat, 99):.2f} ms (16 client threads); first "
          f"request of each set {[f'{answers[j][1] * 1e3:.1f}' for j in first]}"
          f" ms; cache {stats} | {card}", flush=True)
    del model, server
    return dict(counts, batches=batches)


def classify_phase(card: str, ckpts: dict[str, pathlib.Path],
                   vocab: CLIPTokenizer, root: pathlib.Path) -> dict:
    """13(b): ``classify`` through ``cli.classify_image`` on a decoded
    uint8 image (300 x 400, which CLIP center-crops): CLIP with
    ``--ensemble`` and the checkpoint's own vocabulary, SigLIP with a
    ``--tokens-file`` of one template; twice each (the text tower on the
    first call only), then under the plain versions with a fresh cache.
    Where Pillow exists, also the CLI on a PNG file."""
    rng = np.random.default_rng(131)
    image = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    tokens_file = root / "siglip_tokens.json"
    tokens_file.write_text(json.dumps(
        {k: v[0] for k, v in prompt_table(
            vocab, ZS_LABEL_SETS[2], ("a photo of a {}",)).items()}))
    argvs = {
        "clip": ["--labels", ",".join(ZS_LABEL_SETS[2]), "--ensemble"],
        "siglip": ["--tokens-file", str(tokens_file)]}
    counts = {}
    for fam, extra in argvs.items():
        label = f"{fam} classify"
        argv = ["classify", str(root / "image.png"), "--ckpt",
                str(ckpts[fam]), "--model", fam, *extra, "--bf16",
                "--ln-impl", "fused", "--device", "cuda"]
        args = cli.build_parser().parse_args(argv)
        zero_counts()
        with causal_flags() as flags:
            t0 = time.perf_counter()
            out = cli.classify_image(args, image)
            t1 = time.perf_counter()
            again = cli.classify_image(args, image)
            t2 = time.perf_counter()
        launched = read_counts()
        counts[fam] = dict(launched, batches=2)
        check(not out["cached"] and again["cached"],
              f"{label}: cached {out['cached']} then {again['cached']}")
        expect_launches(label, launched, flags, fam, 2, 1)
        with plain_versions():
            ref = cli.classify_image(args, image, cache=EmbeddingCache())
        got, want = out["logits"], ref["logits"]
        cos = float(got @ want / np.linalg.norm(got) / np.linalg.norm(want))
        err = float(np.abs(got - want).max())
        scale = float(np.exp(np.float32(cli.MODELS[fam].from_pretrained(
            ckpts[fam], device="cuda", dtype=torch.bfloat16
        ).logit_scale.item())))
        check(err <= LOGITS_EPS * scale,
              f"{label}: logits vs plain: max abs error {err} > eps "
              f"{LOGITS_EPS * scale} (cosine {cos})")
        best = np.argsort(-out["scores"])[:3]
        print(f"{label}: {len(out['labels'])} labels "
              f"({' '.join(extra[::2])}): top "
              + ", ".join(f"{out['labels'][i]} {out['scores'][i]:.4f}"
                          for i in best)
              + f"; logits max abs error {err:.3e} (eps "
              f"{LOGITS_EPS * scale:.4f}), cosine {cos:.6f} against the plain "
              f"versions; first call {t1 - t0:.3f} s (load, text "
              f"tower, image), cached call {t2 - t1:.3f} s | {card}",
              flush=True)
        if importlib.util.find_spec("PIL") is None:
            print(f"{label}: the classify CLI on a PNG file: not driven "
                  f"(no Pillow on this machine)", flush=True)
            continue
        from PIL import Image
        Image.fromarray(image).save(root / "image.png")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli.main(argv) == 0, f"{label}: the CLI failed")
        lines = buf.getvalue().strip().splitlines()
        check(len(lines) == len(out["labels"]), f"{label}: CLI said {lines}")
        print(f"{label}: the classify CLI on a PNG file: {lines[0].strip()}",
              flush=True)
    return {"classify_clip": counts["clip"],
            "classify_siglip": counts["siglip"]}


def write_eval_shards(root: pathlib.Path, vocab: CLIPTokenizer
                      ) -> dict[str, pathlib.Path]:
    """13(c) and (d)'s datasets, ``encoding="raw"`` (no Pillow needed):
    classification shards (two, labels 0-9, a classes.json of 13(c)'s
    labels) with a ``--zero-shot`` table of the 7 templates, image-text
    shards with 64-token rows for SigLIP, and NaFlex image-text shards of
    mixed aspect with ids of SigLIP2's vocabulary."""
    rng = np.random.default_rng(132)
    paths = {k: root / k for k in ("cls", "pairs", "naflex")}
    for p in paths.values():
        p.mkdir()
    half = EVAL_EXAMPLES // 2

    def image(h: int = EVAL_IMAGE, w: int = EVAL_IMAGE) -> np.ndarray:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

    pairs = [(image(), int(rng.integers(0, 10)))
             for _ in range(EVAL_EXAMPLES)]
    for i, part in enumerate((pairs[:half], pairs[half:])):
        write_classification_records(
            paths["cls"] / f"part-{i:05d}.tfrecord", part, encoding="raw")
    names = ZS_LABEL_SETS[3]
    (paths["cls"] / "classes.json").write_text(json.dumps(list(names)))
    paths["tokens"] = root / "zero_shot.json"
    paths["tokens"].write_text(json.dumps(prompt_table(vocab, names)))
    write_image_text_records(
        paths["pairs"] / "part-00000.tfrecord",
        [(image(), rng.integers(1, 32000, 64).tolist())
         for _ in range(EVAL_EXAMPLES)], encoding="raw")
    write_image_text_records(
        paths["naflex"] / "part-00000.tfrecord",
        [(image(*NAFLEX_EVAL_SIZES[i % len(NAFLEX_EVAL_SIZES)]),
          rng.integers(1, 256000, 64).tolist())
         for i in range(NAFLEX_EVAL_EXAMPLES)], encoding="raw")
    return paths


def evaluate_phase(card: str, what: str, argv: list[str], fam: str,
                   masked: bool = False) -> dict:
    """One ``evaluate`` (13(c), (d)) as the command runs it
    (``cli.Evaluation``), through the kernels and then under the plain
    versions: its JSON line, the launches, examples/s and the reader's
    share of the wall time; every logit within eps of the plain pass's,
    and an example's top-1 (each way for retrieval) changed only where
    the plain pass's top-1/top-2 margin is below 2 eps."""
    args = cli.build_parser().parse_args(
        ["evaluate", *argv, "--batch-size", str(EVAL_BATCH), "--bf16",
         "--ln-impl", "fused", "--device", "cuda"])
    zero_counts()
    with causal_flags() as flags:
        ev = cli.Evaluation(args)
        kernel = list(ev.logits())
    counts = read_counts()
    n = sum(len(t) for _, t in kernel)
    encodes = len(kernel) if ev.kind == "retrieval" else int(
        ev.kind == "zero_shot")
    expect_launches(f"evaluate {what}", counts, flags, fam, len(kernel),
                    encodes, masked)
    summary = ev.summary(kernel)
    reader_s, wall_s = ev.reader_s, ev.wall_s
    with plain_versions():
        plain = list(cli.Evaluation(args).logits())
    eps = logits_bound(ev.kind, ev.model,
                       np.concatenate([p.ravel() for p, _ in plain]))
    err = max(float(np.abs(k - p).max()) for (k, _), (p, _) in
              zip(kernel, plain))
    check(err <= eps, f"evaluate {what}: logits max abs error {err} > eps "
                      f"{eps}")
    readings = []
    for axis in ((1, 0) if ev.kind == "retrieval" else (1,)):
        hits, flips, near = [0, 0], 0, 0
        for (k, t), (p, _) in zip(kernel, plain):
            ak, ap = k.argmax(axis), p.argmax(axis)
            close = _top2_margin(p, axis) < 2 * eps
            check(not bool(((ak != ap) & ~close).any()),
                  f"evaluate {what}: a top-1 moved where the plain margin "
                  f"is >= 2 eps ({2 * eps})")
            hits[0] += int((ak == t).sum())
            hits[1] += int((ap == t).sum())
            flips += int((ak != ap).sum())
            near += int(close.sum())
        check(abs(hits[0] - hits[1]) <= near,
              f"evaluate {what}: hits {hits} differ by more than the "
              f"{near} examples under the margin")
        readings.append(f"{'rows' if axis == 1 else 'columns'}: hits "
                        f"{hits[0]} (plain {hits[1]}), {flips} top-1 moved, "
                        f"{near / n:.3f} of the examples under the margin")
    print(f"evaluate {what}: {json.dumps(summary)}; logits max abs error "
          f"{err:.3e}, eps {eps:.4f}; " + "; ".join(readings), flush=True)
    print(f"evaluate {what}: {n} examples in {wall_s:.3f} s, "
          f"{n / wall_s:.1f} examples/s, the reader (decode, resize, "
          f"normalize on the host) {reader_s:.3f} s = "
          f"{reader_s / wall_s:.1%} of the wall time | {card}", flush=True)
    return dict(counts, batches=len(kernel))


def zero_shot_phase(card: str, ckpts: dict[str, pathlib.Path],
                    root: pathlib.Path) -> dict[str, dict]:
    """Phase 13 over phase 12's checkpoints: (a) /v1/classify, (b)
    ``classify``, (c) ``evaluate`` of ViT, CLIP ``--zero-shot`` and
    SigLIP retrieval, (d) ``evaluate --naflex`` of a SigLIP2-B/16-256
    checkpoint written here; the launch counts of each path."""
    write_clip_vocab(ckpts["clip"])
    vocab = CLIPTokenizer.from_dir(ckpts["clip"])
    counts = {f"zero_shot_serve_{fam}": zero_shot_serve_phase(
        card, fam, ckpts[fam], vocab) for fam in ("clip", "siglip")}
    torch.cuda.empty_cache()
    counts.update(classify_phase(card, ckpts, vocab, root))
    data = write_eval_shards(root, vocab)
    for name, fam, argv in (
            ("vit top-1", "vit", ["--data", str(data["cls"])]),
            ("clip --zero-shot", "clip", ["--data", str(data["cls"]),
                                          "--zero-shot",
                                          str(data["tokens"])]),
            ("siglip retrieval", "siglip", ["--data", str(data["pairs"])])):
        counts[f"evaluate_{fam}"] = evaluate_phase(
            card, name, argv + ["--ckpt", str(ckpts[fam]), "--model", fam],
            fam)
    if importlib.util.find_spec("PIL") is None:
        print("evaluate: a WebDataset .tar shard: not driven (its members "
              "are PNG/JPEG, and this machine has no Pillow)", flush=True)
    else:
        rng = np.random.default_rng(133)
        (root / "tar").mkdir()
        write_wds_shard(root / "tar" / "shard-000.tar", [
            {"image": rng.integers(0, 256, (EVAL_IMAGE, EVAL_IMAGE, 3),
                                   dtype=np.uint8),
             "label": int(rng.integers(0, 1000))} for _ in range(40)])
        evaluate_phase(card, "vit top-1 (.tar)", [
            "--data", str(root / "tar"), "--ckpt", str(ckpts["vit"]),
            "--model", "vit"], "vit")
    # (d) SigLIP2-B/16-256 (NaFlex: the masked kernels in the image tower)
    cfg = configs.preset(NAFLEX_PRESET)
    model = SigLIP(cfg, device="cuda", dtype=torch.bfloat16,
                   generator=torch.Generator(device="cuda").manual_seed(13))
    model.save_pretrained(root / "siglip2", flavor="siglip2")
    del model
    counts["evaluate_naflex"] = evaluate_phase(
        card, "siglip2 --naflex retrieval",
        ["--data", str(data["naflex"]), "--ckpt", str(root / "siglip2"),
         "--model", "siglip", "--naflex"], "siglip", masked=True)
    return counts


# -- phase 14: training, rest ------------------------------------------------

def _rest_model(spec: str = "none", *, dropout: float = 0.0,
                saveable: bool = False, preset: str = "siglip-base-patch16-256"
                ) -> SigLIP:
    """A SigLIP preset in bf16 with fused LayerNorm from seed 0, under the
    ``--remat`` ``spec`` (dots+attn takes the saveable impl), with
    ``dropout`` set through the config."""
    rt: dict = {"ln_impl": "fused"}
    if spec != "none":
        rt.update(configs.parse_remat(spec))
    if saveable or spec.endswith("attn"):
        rt["attn_impl"] = "saveable"
    if dropout:
        rt["dropout"] = dropout
    cfg = configs.with_runtime(configs.preset(preset), **rt)
    return SigLIP(cfg, device="cuda", dtype=torch.bfloat16,
                  generator=torch.Generator(device="cuda").manual_seed(0))


def fwd_bwd(model, images, text) -> dict:
    """One forward and backward (no update) with its launches counted:
    the loss, the gradients, the counts, the step's wall time and its
    activation peak (``max_memory_allocated`` over what was allocated
    before it)."""
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    loss = contrastive_loss_fn(model, images, text, kind="siglip")
    loss.backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    return {"loss": loss.detach(), "counts": counts, "ms": ms,
            "peak": torch.cuda.max_memory_allocated() - before,
            "grads": {n: p.grad for n, p in model.named_parameters()}}


def equal_grads(got: dict, want: dict, noisy: dict, label: str) -> None:
    """Every gradient ``torch.equal`` to ``want``'s, except those two
    identical runs already disagree on (``noisy``: name -> their distance),
    which must lie within twice that distance."""
    for name, g in got.items():
        if name in noisy:
            d = (g.double() - want[name].double()).norm().item()
            check(d <= 2 * noisy[name], f"{label}: gradient of {name} "
                  f"{d:.3e} from no-remat, over twice the run-to-run "
                  f"{noisy[name]:.3e}")
        else:
            check(torch.equal(g, want[name]),
                  f"{label}: gradient of {name} differs from no-remat")


def timed_fwd_bwd(model, images, text) -> dict:
    """:func:`fwd_bwd` run ``REMAT_TIMED_STEPS`` times: the last run, with
    the median of the runs' wall times and the peak of the first."""
    runs = [fwd_bwd(model, images, text) for _ in range(REMAT_TIMED_STEPS)]
    r = runs[-1]
    r["ms"] = float(np.median([x["ms"] for x in runs]))
    r["peak"] = runs[0]["peak"]
    return r


def check_peaks(peaks: dict[str, int], chains, label: str) -> None:
    """The activation peaks fall strictly along each chain of specs."""
    for chain in chains:
        check(all(peaks[a] > peaks[b] for a, b in zip(chain, chain[1:])),
              f"{label}: activation peaks {peaks} do not fall along {chain}")


def remat_phase(card: str) -> dict[str, dict]:
    """14(a): SigLIP-B/16-256 at batch 128 under each remat policy. Each
    policy's model runs a warm step and three measured ones; no remat runs
    once more with the saveable impl, the reference of dots+attn. Two
    no-remat runs name any gradient that is not deterministic."""
    model = _rest_model()
    images, text = _batch(model.config, TRAIN_BATCH, torch.bfloat16, 14)
    first = fwd_bwd(model, images, text)
    warm = first["ms"]
    first = {n: g.clone() for n, g in first["grads"].items()}
    ref = {"flash": timed_fwd_bwd(model, images, text)}
    ref["flash"]["warm_ms"] = warm
    profile_readout(lambda: fwd_bwd(model, images, text),
                    "remat none: one forward + backward", card)
    noisy = {n: (g.double() - first[n].double()).norm().item()
             for n, g in ref["flash"]["grads"].items()
             if not torch.equal(g, first[n])}
    print(f"remat: two no-remat SigLIP-B/16-256 steps at batch "
          f"{TRAIN_BATCH}: "
          + (f"{len(noisy)} gradients differ (not deterministic): "
             f"{sorted(noisy)}" if noisy else "every gradient bit for bit")
          + f" | {card}", flush=True)
    del model, first
    model = _rest_model(saveable=True)
    fwd_bwd(model, images, text)
    ref["saveable"] = fwd_bwd(model, images, text)
    del model
    results = {}
    for spec, (ln_fwd, flash_fwd) in REMAT_LAUNCHES.items():
        if spec == "none":
            r = ref["flash"]
        else:
            model = _rest_model(spec)
            warm = fwd_bwd(model, images, text)["ms"]
            r = timed_fwd_bwd(model, images, text)
            r["warm_ms"] = warm
            profile_readout(lambda: fwd_bwd(model, images, text),
                            f"remat {spec}: one forward + backward", card)
            base = ref["saveable" if spec.endswith("attn") else "flash"]
            check(torch.equal(r["loss"], base["loss"]),
                  f"remat {spec}: loss {r['loss'].item()} != no-remat "
                  f"{base['loss'].item()}")
            equal_grads(r.pop("grads"), base["grads"], noisy,
                        f"remat {spec}")
            del model
        c = r["counts"]
        flash_bwd = 0 if spec.endswith("attn") else FLASH_PER_STEP
        check((c["layer_norm"], c["flash_attention"], c["layer_norm_bwd"],
               c["flash_attention_bwd"]) == (ln_fwd, flash_fwd, LN_PER_STEP,
                                             flash_bwd),
              f"remat {spec}: launches {c}; want LayerNorm {ln_fwd} / "
              f"{LN_PER_STEP}, flash {flash_fwd} / {flash_bwd}")
        results[spec] = r
        print(f"remat {spec}: loss {r['loss'].item():.6f} (equal to "
              f"no-remat), step (forward + backward) {r['ms']:.3f} ms, the "
              f"median of {REMAT_TIMED_STEPS} (the warm step "
              f"{r['warm_ms']:.3f}), "
              f"activation peak {r['peak']} bytes "
              f"({r['peak'] / 2**30:.2f} GiB); LayerNorm {ln_fwd} forward "
              f"/ {LN_PER_STEP} backward, flash {flash_fwd} / {flash_bwd} "
              f"| {card}", flush=True)
    peaks = {s: r["peak"] for s, r in results.items()}
    check_peaks(peaks, REMAT_MEMORY_CHAINS, "remat")
    print(f"remat: activation peaks fall along {REMAT_MEMORY_CHAINS}; "
          f"dots+ln+act / none = "
          f"{peaks['dots+ln+act'] / peaks['none']:.4f} | {card}", flush=True)
    counts = {f"remat_{s}": r["counts"] for s, r in results.items()}
    del results, ref
    wide_remat_steps(card)
    counts["naflex_dots"] = naflex_remat_step(card)
    counts["fp8_full"] = fp8_remat_step(card)
    return counts


def wide_remat_steps(card: str) -> None:
    """14(a): SigLIP-L/16-256 under ``REMAT_WIDE_RUNS``, each spec a warm
    step and three measured: whether a "dots" set beats full remat on wall
    time once the device time outgrows the host's."""
    for batch, specs in REMAT_WIDE_RUNS.items():
        out = {}
        for spec in specs:
            model = _rest_model(spec, preset=REMAT_WIDE_PRESET)
            images, text = _batch(model.config, batch, torch.bfloat16, 14)
            warm = fwd_bwd(model, images, text)
            r = timed_fwd_bwd(model, images, text)
            label = f"remat {spec} ({REMAT_WIDE_PRESET}, batch {batch})"
            check(bool(torch.isfinite(r["loss"])), f"{label}: loss not finite")
            if out:
                check(torch.equal(r["loss"], next(iter(out.values()))["loss"]),
                      f"{label}: the loss differs from {specs[0]}'s")
            out[spec] = {"loss": r["loss"], "ms": r["ms"], "peak": r["peak"]}
            print(f"{label}: step (forward + backward) {r['ms']:.3f} ms, the "
                  f"median of {REMAT_TIMED_STEPS} (the warm step "
                  f"{warm['ms']:.3f}), activation peak {r['peak']} bytes "
                  f"({r['peak'] / 2**30:.2f} GiB) | {card}", flush=True)
            del model, warm, r, images, text
        check_peaks({s: r["peak"] for s, r in out.items()}, (specs,),
                    f"remat ({REMAT_WIDE_PRESET}, batch {batch})")
        print(f"remat ({REMAT_WIDE_PRESET}, batch {batch}): dots / full wall "
              f"time = {out['dots']['ms'] / out['full']['ms']:.4f} | {card}",
              flush=True)


def naflex_remat_step(card: str) -> dict[str, int]:
    """14(a): one SigLIP2-B/16-256 NaFlex step under dots against no
    remat: the masked flash forwards are kept (13, not 25)."""
    runs = {}
    for spec in ("none", "dots"):
        model = _rest_model(spec, preset=NAFLEX_PRESET)
        images, text = _naflex_batch(model.config, TRAIN_BATCH,
                                     torch.bfloat16, 14)
        runs[spec] = fwd_bwd(model, images, text)
        del model
    r, base = runs["dots"], runs["none"]
    check(torch.equal(r["loss"], base["loss"]),
          "remat dots (NaFlex): the loss differs from no-remat")
    equal_grads(r["grads"], base["grads"], {}, "remat dots (NaFlex)")
    want = dict(step_counts(naflex=True), layer_norm=2 * LN_PER_STEP)
    check(all(r["counts"][k] == n for k, n in want.items()),
          f"remat dots (NaFlex): launches {r['counts']}, want {want}")
    print(f"remat dots (SigLIP2 NaFlex, batch {TRAIN_BATCH}): gradients "
          f"equal to no-remat; masked flash {NAFLEX_MASKED_PER_STEP} "
          f"forward (kept, not rerun) / {NAFLEX_MASKED_PER_STEP} backward; "
          f"activation peak {r['peak'] / 2**30:.2f} GiB against "
          f"{base['peak'] / 2**30:.2f} | {card}", flush=True)
    return r["counts"]


def fp8_remat_step(card: str) -> dict[str, int]:
    """14(a): one fp8_hybrid step under full remat against no remat from
    the same weights and histories: the recompute neither pushes the amax
    histories again nor reads the pushed values."""
    runs, hist = {}, {}
    for spec in ("none", "full"):
        model = _rest_model(spec)
        check(apply_precision_policy(model, "fp8_hybrid") == FP8_LINEARS,
              "fp8_hybrid did not rewrite every eligible Linear")
        images, text = _batch(model.config, TRAIN_BATCH, torch.bfloat16, 14)
        runs[spec] = fwd_bwd(model, images, text)
        hist[spec] = {n: b.clone() for n, b in model.named_buffers()
                      if n.endswith("_amax")}
        del model
    check(all(torch.equal(h, hist["none"][n]) for n, h in
              hist["full"].items()) and len(hist["full"]) == 2 * FP8_LINEARS,
          "fp8_hybrid under full remat: the amax histories differ from "
          "no-remat")
    c = runs["full"]["counts"]
    want = (FP8_LINEARS + FP8_BLOCK_LINEARS, 2 * FP8_LINEARS)
    check((c["fp8_matmul"], c["fp8_matmul_bwd"]) == want,
          f"fp8_hybrid under full remat: fp8 GEMMs {c}, want {want}")
    equal_grads(runs["full"]["grads"], runs["none"]["grads"], {},
                "fp8_hybrid under full remat")
    print(f"remat full (fp8_hybrid, batch {TRAIN_BATCH}): "
          f"{len(hist['full'])} amax histories equal to no-remat's; fp8 "
          f"GEMMs {want[0]} forward ({FP8_BLOCK_LINEARS} rerun) / {want[1]} "
          f"backward; gradients equal to no-remat bit for bit | {card}",
          flush=True)
    return c


def dropout_phase(card: str) -> dict[str, int]:
    """14(b): dropout 0.1 set through the config on SigLIP-B/16-256."""
    model = _rest_model(dropout=DROPOUT_RATE)
    plain = _rest_model()
    images, text = _batch(model.config, TRAIN_BATCH, torch.bfloat16, 15)
    model.eval()
    plain.eval()
    with torch.no_grad():
        same = all(torch.equal(a, b) for a, b in (
            (model.encode_image(images), plain.encode_image(images)),
            (model.encode_text(text), plain.encode_text(text))))
    check(same, "dropout: eval() differs from the rate-0 model")
    del plain
    model.train()
    drop = model.vision.encoder.blocks[0].dropout
    y = drop(torch.ones(TRAIN_BATCH, 256, 768, device="cuda",
                        dtype=torch.bfloat16))
    n, keep = y.numel(), 1.0 - DROPOUT_RATE
    kept = int((y != 0).sum().item())
    sigma = math.sqrt(n * keep * DROPOUT_RATE)
    check(abs(kept - n * keep) <= 6 * sigma and bool(
        (y[y != 0] == torch.tensor(1 / keep, dtype=y.dtype)).all()),
          f"dropout: one mask kept {kept} of {n} (want {n * keep:.0f} "
          f"within 6 sigma = {6 * sigma:.0f}), kept values 1/{keep}")
    del y
    opt = make_optimizer(model, OptimizerConfig(learning_rate=1e-3))
    step = make_contrastive_train_step("siglip")
    zero_counts()
    losses = [step(model, opt, images, text)["loss"].item()
              for _ in range(2)]
    counts = read_counts()
    check(all(math.isfinite(v) for v in losses),
          f"dropout: train losses {losses}")
    del model, opt
    runs = {}
    for spec in ("none", "full"):
        m = _rest_model(spec, dropout=DROPOUT_RATE)
        runs[spec] = fwd_bwd(m, images, text)
        del m
    check(torch.equal(runs["none"]["loss"], runs["full"]["loss"]),
          "dropout: the loss under full remat differs from no-remat")
    equal_grads(runs["full"]["grads"], runs["none"]["grads"], {},
                "dropout under full remat")
    print(f"dropout {DROPOUT_RATE} (config): eval() equal to the rate-0 "
          f"model; one mask kept {kept} of {n} ({kept / n:.5f}, "
          f"{(kept - n * keep) / sigma:+.2f} sigma); two train steps, "
          f"losses {[round(v, 5) for v in losses]}; full remat's gradients "
          f"equal to no-remat's from the same seed | {card}", flush=True)
    return counts


def rest_command(card: str, what: str, argv: list[str], steps: int,
                 want: tuple[int, int, int, int],
                 keep_optimizer: bool = False) -> dict:
    """One train command of phase 14 (:func:`run_train_command`) for
    ``steps`` steps. ``want``: a ``FAMILY_STEP`` entry; no other kernel may
    launch."""
    run = run_train_command(
        argv + ["--steps", str(steps), "--log-every", "1"], card,
        keep_optimizer)
    rc, counts, flags, peak, logged, summary = (
        run[k] for k in ("rc", "counts", "flags", "peak", "logged",
                         "summary"))
    check(rc == 0 and summary.get("status") == "trained"
          and summary.get("device", "").startswith("cuda"),
          f"{what}: python -m jimm_tpu_torch {' '.join(argv)}: rc {rc}, "
          f"{summary}")
    check([r["step"] for r in logged] == list(range(steps))
          and all(math.isfinite(r["loss"]) for r in logged),
          f"{what}: logged {logged}")
    flash, ln_fwd, ln_bwd, causal = want
    per_step = {"flash_attention": flash, "flash_attention_bwd": flash,
                "layer_norm": ln_fwd, "layer_norm_bwd": ln_bwd}
    check(all(counts[k] == per_step.get(k, 0) * steps for k in counts)
          and flags.count(True) == causal * steps,
          f"{what}: launches over {steps} steps {counts}, causal "
          f"{flags.count(True)}; want per step {per_step}, {causal} causal")
    times = [round(r["step_time_s"] * 1e3, 3) for r in logged]
    extra = ("; accuracy " + str([r["accuracy"] for r in logged])
             if "accuracy" in logged[0] else "")
    print(f"{what}: {steps} steps, launches {counts} ({flags.count(True)} "
          f"causal); step times {times} ms, MFU of the last "
          f"{summary['mfu_last_step']}; losses "
          f"{[round(r['loss'], 5) for r in logged]}{extra}; "
          f"torch.cuda.max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.2f} GiB) | {card}", flush=True)
    return run


def train_rest_commands(card: str, vit_ckpt: pathlib.Path
                        ) -> dict[str, dict]:
    """14(c)-(f): the train command's new paths."""
    common = ["--ln-impl", "fused"]
    bf16 = ["--bf16", *common]
    r = rest_command(card, "train --moment-dtype bf16", [
        "train", "--preset", "siglip-base-patch16-256", "--moment-dtype",
        "bf16", "--batch-size", str(TRAIN_BATCH), *common], CLI_STEPS,
        FAMILY_STEP["siglip"], keep_optimizer=True)
    state = r["optimizer"].opt.state
    mus = [s["exp_avg"] for s in state.values()]
    nbytes = sum(t.nbytes for s in state.values() for t in s.values()
                 if torch.is_tensor(t))
    f32 = sum(2 * 4 * p.numel() for p in r["optimizer"].params)
    check(len(mus) == len(r["optimizer"].params)
          and all(m.dtype == torch.bfloat16 for m in mus)
          and r["summary"]["moment_dtype"] == "bfloat16",
          "train --moment-dtype bf16: exp_avg not bf16 throughout")
    print(f"train --moment-dtype bf16 (f32 parameters): {len(mus)} exp_avg "
          f"all bf16; optimizer state {nbytes} bytes "
          f"({nbytes / 2**20:.1f} MiB) against {f32} ({f32 / 2**20:.1f} "
          f"MiB) with f32 moments | {card}", flush=True)
    counts = {"moment_bf16": r["counts"]}
    del r, state, mus
    r = rest_command(card, "train vit-base-patch16-224", [
        "train", "--preset", "vit-base-patch16-224", "--num-classes",
        str(VIT_CLASSES), "--batch-size", str(TRAIN_BATCH), *bf16],
        CLI_STEPS, FAMILY_STEP["vit"])
    check(r["summary"]["num_classes"] == VIT_CLASSES,
          f"train vit: {r['summary']}")
    counts["vit"] = r["counts"]
    r = rest_command(card, "train --from-pretrained (ViT-B/16)", [
        "train", "--preset", "vit-base-patch16-224", "--from-pretrained",
        str(vit_ckpt), "--num-classes", str(FINETUNE_CLASSES),
        "--batch-size", str(TRAIN_BATCH), *bf16], FINETUNE_STEPS,
        FAMILY_STEP["vit"])
    check(r["summary"]["fresh_head"] is True
          and r["summary"]["num_classes"] == FINETUNE_CLASSES,
          f"train --from-pretrained: {r['summary']}")
    counts["vit_finetune"] = r["counts"]
    r = rest_command(card, "train clip-vit-base-patch16", [
        "train", "--preset", "clip-vit-base-patch16", "--batch-size",
        str(TRAIN_BATCH), *bf16], CLI_STEPS, FAMILY_STEP["clip"])
    counts["clip"] = r["counts"]
    del r
    peaks = {}
    for key, remat in (("temporal", []), ("temporal_dots",
                                          ["--remat", "dots"])):
        r = rest_command(card, f"train {TEMPORAL_PRESET} "
                               f"{' '.join(remat) or '(no remat)'}", [
            "train", "--preset", TEMPORAL_PRESET, "--batch-size",
            str(TEMPORAL_BATCH), *bf16, *remat], TEMPORAL_STEPS,
            FAMILY_STEP[key])
        check(r["summary"]["num_frames"] == 8
              and r["summary"]["remat"] == (remat[-1] if remat else "none"),
              f"{key}: {r['summary']}")
        counts[key], peaks[key] = r["counts"], r["peak"]
        del r
    check(peaks["temporal_dots"] < peaks["temporal"],
          f"temporal: the dots peak {peaks['temporal_dots']} is not under "
          f"no remat's {peaks['temporal']}")
    print(f"temporal ViT-B/16 (8 x 196 tokens), batch {TEMPORAL_BATCH}: "
          f"peak {peaks['temporal'] / 2**30:.2f} GiB without remat, "
          f"{peaks['temporal_dots'] / 2**30:.2f} GiB under dots | {card}",
          flush=True)
    return counts


# -- phase 15: checkpoints and resilience -------------------------------------

def span_totals() -> dict[str, tuple[int, float]]:
    """Count and seconds so far of each checkpoint span."""
    snap = obs.get_registry("jimm_spans").snapshot()
    return {s: (snap.get(f"{s}_seconds_count", 0),
                snap.get(f"{s}_seconds_sum", 0.0)) for s in CKPT_SPANS}


def resilience_command(argv: list[str], card: str, what: str,
                       metrics: pathlib.Path, crash: str | None = None
                       ) -> dict:
    """One ``train`` or ``supervise`` command of phase 15, run in this
    process: the launch counters zeroed just before it and read just after,
    its standard output printed with a ``cli:`` prefix, its logged rows
    read back, its warnings kept, and the checkpoint spans' counts and
    seconds over the command. ``crash``: the injected failure's message,
    which the command must raise."""
    out = io.StringIO()
    torch.cuda.empty_cache()
    before = span_totals()
    raised = rc = None
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        zero_counts()
        with contextlib.redirect_stdout(out):
            try:
                rc = cli.main(argv + ["--metrics-file", str(metrics)])
            except RuntimeError as e:
                if crash is None or crash not in str(e):
                    raise
                raised = str(e)
        counts = read_counts()
    wall = time.perf_counter() - t0
    spans = {k: (n - before[k][0], s - before[k][1])
             for k, (n, s) in span_totals().items()}
    printed = out.getvalue().splitlines()
    for line in printed:
        print(f"cli: {line} | {card}", flush=True)
    check(raised is not None if crash else rc == 0,
          f"{what}: rc {rc}, raised {raised}")
    logged = [json.loads(line) for line in metrics.read_text().splitlines()]
    metrics.unlink()
    summary = (json.loads(printed[-1]) if printed
               and printed[-1].startswith("{") else None)
    return {"counts": counts, "logged": logged, "printed": printed,
            "spans": spans, "summary": summary, "wall": wall,
            "warnings": [str(w.message) for w in caught]}


def steps_launched(what: str, counts: dict[str, int], steps: int) -> None:
    """The command launched rows 1, 2, 3 and 7 for ``steps`` train steps
    of SigLIP-B/16-256, and nothing else."""
    want = step_counts()
    check(all(counts[k] == want[k] * steps for k in want),
          f"{what}: launches {counts}, want {steps} steps of {want}")


def same_as_control(what: str, logged: list[dict], control: dict,
                    steps) -> None:
    """Bit-equal losses and batch fingerprints to the control run's at
    ``steps`` (a step logged twice: the later row, the resumed one)."""
    rows = {r["step"]: r for r in logged}
    check(sorted(rows) == list(steps), f"{what}: steps {sorted(rows)}")
    bad = [s for s in steps
           if rows[s]["loss"] != control[s]["loss"]
           or rows[s]["batch_fingerprint"] != control[s]["batch_fingerprint"]]
    check(not bad, f"{what}: steps {bad} differ from the control run: "
                   f"{[(rows[s]['loss'], control[s]['loss']) for s in bad]}")


def _sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _per_call_ms(spans: dict, name: str) -> float | None:
    n, s = spans[name]
    return round(s / n * 1e3, 3) if n else None


def resilience_phase(card: str, root: pathlib.Path) -> dict[str, int]:
    """Phase 15: (a) the control run and the crash drill, (b) the
    preemption drill under ``supervise``, (c) the corruption drill, (d)
    the checkpoint's size and times. Returns the launches of (a)'s resumed
    run, the slice's path."""
    crash2 = "injected failure at step 2"
    metrics = root / "metrics.jsonl"

    def ckpt(name: str) -> list[str]:
        return ["--ckpt-dir", str(root / name)]

    # (a) the uninterrupted control run, checkpointing every step
    control_run = resilience_command(RESILIENCE_ARGV + ckpt("control"), card,
                                     "15(a) control", metrics)
    control = {r["step"]: r for r in control_run["logged"]}
    check(sorted(control) == list(range(RESILIENCE_STEPS)),
          f"15(a) control logged {sorted(control)}")
    steps_launched("15(a) control", control_run["counts"], RESILIENCE_STEPS)
    newest = root / "control" / str(RESILIENCE_STEPS - 1)
    files = {f.name: f.stat().st_size for f in newest.iterdir()}
    control_sha = _sha256(newest / "model.safetensors")
    shutil.rmtree(root / "control")
    run = resilience_command(RESILIENCE_ARGV + ckpt("crash")
                             + ["--inject-faults", "crash@2"], card,
                             "15(a) crash@2", metrics, crash=crash2)
    same_as_control("15(a) crash@2", run["logged"], control, range(3))
    resumed = resilience_command(RESILIENCE_ARGV + ckpt("crash")
                                 + ["--resume"], card, "15(a) --resume",
                                 metrics)
    same_as_control("15(a) --resume", resumed["logged"], control,
                    range(3, RESILIENCE_STEPS))
    check(resumed["summary"]["start_step"] == 3,
          f"15(a) resumed at {resumed['summary']['start_step']}")
    # no replay: the resumed run trains its 3 steps and no more
    steps_launched("15(a) --resume", resumed["counts"], 3)
    sha = _sha256(root / "crash" / str(RESILIENCE_STEPS - 1)
                  / "model.safetensors")
    check(sha == control_sha, f"15(a): the resumed run's newest "
                              f"model.safetensors {sha} != control's "
                              f"{control_sha}")
    shutil.rmtree(root / "crash")
    print(f"15(a) crash@2 then --resume: steps 3-5 equal the control run's "
          f"losses and batch fingerprints bit for bit; newest "
          f"model.safetensors sha256 {sha} equal; launches "
          f"{resumed['counts']} (3 steps) | {card}", flush=True)

    # (b) SIGTERM at step 2 under supervise: the grace save overlaps step 3
    run = run_b = resilience_command(
        ["supervise", "--max-restarts", "2", "--backoff-base-s", "0.01",
         "--seed", "0", "--"] + RESILIENCE_ARGV + ckpt("preempt")
        + ["--inject-faults", "preempt@2", "--grace-steps", "1"],
        card, "15(b) supervise preempt@2", metrics)
    steps = [r["step"] for r in run["logged"]]
    check(steps == [0, 1, 2, 3, 3, 4, 5],
          f"15(b) supervise logged steps {steps}")
    same_as_control("15(b) supervise", run["logged"], control,
                    range(RESILIENCE_STEPS))
    steps_launched("15(b) supervise", run["counts"], 7)
    line = [p for p in run["printed"] if p.startswith("resilience: ")]
    check(len(line) == 1, f"15(b): resilience lines {line}")
    resilience = json.loads(line[0].removeprefix("resilience: "))
    check(resilience["jimm_train_restarts_total"] >= 1
          and resilience["jimm_train_preemptions_total"] >= 1
          and resilience["jimm_train_goodput_lost_work_seconds_total"] > 0,
          f"15(b) resilience counters {resilience}")
    shutil.rmtree(root / "preempt")
    print(f"15(b) supervise, preempt@2 with one grace step: steps {steps}, "
          f"losses and fingerprints equal the control run's; resilience "
          f"{resilience}; wall {run['wall']:.1f} s | {card}", flush=True)

    # (c) step 2's metadata garbled, then a crash: resume quarantines it
    # and falls back to step 1
    run = resilience_command(RESILIENCE_ARGV + ckpt("corrupt")
                             + ["--inject-faults", "corrupt@2,crash@2"],
                             card, "15(c) corrupt@2,crash@2", metrics,
                             crash=crash2)
    fallback = resilience_command(RESILIENCE_ARGV + ckpt("corrupt")
                                  + ["--resume"], card,
                                  "15(c) --resume", metrics)
    quarantined = root / "corrupt" / ".quarantine" / "2"
    reason = (quarantined / ".jimm_quarantine_reason.txt").read_text() \
        if quarantined.is_dir() else ""
    check(reason.startswith("restore failed: JSONDecodeError")
          and not (root / "corrupt" / "2").exists()
          and any("quarantined" in w for w in fallback["warnings"]),
          f"15(c): quarantine {reason!r}, warnings {fallback['warnings']}")
    check(fallback["summary"]["start_step"] == 2,
          f"15(c) resumed at {fallback['summary']['start_step']}")
    same_as_control("15(c) --resume", fallback["logged"], control,
                    range(2, RESILIENCE_STEPS))
    steps_launched("15(c) --resume", fallback["counts"], 4)
    shutil.rmtree(root / "corrupt")
    print(f"15(c) corrupt@2,crash@2 then --resume: step 2 quarantined "
          f"({reason.strip()}), resumed from step 1, steps 2-5 equal the "
          f"control run's | {card}", flush=True)

    # (d) the numbers
    params = files["model.safetensors"]
    moments = files["opt.safetensors"]
    spans = control_run["spans"]
    # one restore each in (a)'s resume and (b)'s restart, both of which
    # succeed; (c)'s resume tries the garbled step 2 before step 1
    tries = {what: r["spans"]["checkpoint_restore"][0] for what, r in
             (("15(a)", resumed), ("15(b)", run_b), ("15(c)", fallback))}
    check(tries == {"15(a)": 1, "15(b)": 1, "15(c)": 2},
          f"15(d): restores tried {tries}")
    restores = {k: (resumed["spans"][k][0] + run_b["spans"][k][0],
                    resumed["spans"][k][1] + run_b["spans"][k][1])
                for k in CKPT_SPANS}
    # time to resume: the restore, then the generator replayed up to the
    # resumed step (3 batches in (a) and (b), 2 in (c))
    replay_ms = {what: r["spans"]["resume_fast_forward"][1] * 1e3
                 for what, r in (("15(a)", resumed), ("15(b)", run_b),
                                 ("15(c)", fallback))}
    per_batch = sum(replay_ms.values()) / 8
    # the replay makes the generator's draws and builds no image: beside
    # it, the same batches built in full
    cfg = configs.preset("siglip-base-patch16-256")
    full = contrastive_pairs(TRAIN_BATCH, image_size=cfg.vision.image_size,
                             vocab_size=cfg.text.vocab_size,
                             seq_len=cfg.text.context_length)
    t0 = time.perf_counter()
    for _ in range(3):
        next(full)
    built_ms = (time.perf_counter() - t0) / 3 * 1e3
    resume_ms = {what: round(r["spans"]["checkpoint_restore"][1] * 1e3
                             + replay_ms[what], 3)
                 for what, r in (("15(a)", resumed), ("15(b)", run_b))}
    goodput = control_run["summary"]["goodput"]
    step_ms = statistics.median(r["step_time_s"] * 1e3
                                for r in control_run["logged"][1:])
    per_step = goodput["checkpoint_s"] / RESILIENCE_STEPS * 1e3
    print(f"15(d) checkpoint of SigLIP-B/16-256 (bf16 parameters, bf16 "
          f"AdamW moments): {params + moments} bytes = model.safetensors "
          f"{params} + opt.safetensors {moments} ({files}); per save: host "
          f"copy {_per_call_ms(spans, 'checkpoint_host_copy')} ms, the "
          f"save call (host copy + waiting out the previous write) "
          f"{_per_call_ms(spans, 'checkpoint_save')} ms, background write "
          f"{_per_call_ms(spans, 'checkpoint_write')} ms; restore "
          f"{_per_call_ms(restores, 'checkpoint_restore')} ms (mean of "
          f"{restores['checkpoint_restore'][0]} successful restores: "
          f"15(a)'s {resumed['spans']['checkpoint_restore'][1] * 1e3:.3f}, "
          f"15(b)'s {run_b['spans']['checkpoint_restore'][1] * 1e3:.3f}); "
          f"15(c)'s fall-back, the garbled step 2 tried then step 1: "
          f"{fallback['spans']['checkpoint_restore'][1] * 1e3:.3f} ms in "
          f"all; generator replay (its draws, no image built) "
          f"{per_batch:.3f} ms a batch against {built_ms:.3f} ms a batch "
          f"built in full (ms {replay_ms} for 3, 3 and 2 batches; it grows "
          f"with the step resumed); time to resume (restore + replay) "
          f"{resume_ms} ms; "
          f"goodput checkpoint bucket "
          f"{per_step:.1f} ms a "
          f"step against a median step of {step_ms:.1f} ms (control run "
          f"goodput {goodput}) | {card}", flush=True)
    return resumed["counts"]


# -- phase 16: training from file datasets -----------------------------------

def png_bytes(image: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``image`` (H, W, 3) uint8, with zlib alone:
    the card's machine may have no Pillow."""
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (len(body).to_bytes(4, "big") + tag + body
                + (zlib.crc32(tag + body) & 0xFFFFFFFF).to_bytes(4, "big"))

    header = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
              + bytes([8, 2, 0, 0, 0]))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def write_data_shards(root: pathlib.Path) -> dict[str, pathlib.Path]:
    """Phase 16's datasets: ``DATA_EXAMPLES`` raw 288 x 320 image-text
    records in ``DATA_SHARDS`` TFRecord shards (64-token rows of
    SigLIP's vocabulary, varying length), NaFlex records of mixed aspect
    (SigLIP2's vocabulary), and ViT tar shards of PNG images with a
    classes.json."""
    rng = np.random.default_rng(16)
    paths = {k: root / k for k in ("pairs", "naflex", "tar")}
    for p in paths.values():
        p.mkdir()
    per = DATA_EXAMPLES // DATA_SHARDS
    for s in range(DATA_SHARDS):
        write_image_text_records(
            paths["pairs"] / f"part-{s:05d}.tfrecord",
            [(rng.integers(0, 256, (*DATA_HW, 3), dtype=np.uint8),
              rng.integers(1, DATA_VOCAB, int(rng.integers(8, 65))).tolist())
             for _ in range(per)], encoding="raw")
    write_image_text_records(
        paths["naflex"] / "part-00000.tfrecord",
        [(rng.integers(0, 256, (*NAFLEX_DATA_SIZES[i % 4], 3),
                       dtype=np.uint8),
          rng.integers(1, NAFLEX_VOCAB, 64).tolist())
         for i in range(NAFLEX_DATA_EXAMPLES)], encoding="raw")
    half = TAR_EXAMPLES // 2
    for s in range(2):
        write_wds_shard(paths["tar"] / f"part-{s:05d}.tar", [
            {"image": png_bytes(rng.integers(0, 256, (*TAR_HW, 3),
                                             dtype=np.uint8)),
             "label": int(rng.integers(0, TAR_CLASSES))}
            for _ in range(half)])
    (paths["tar"] / "classes.json").write_text(json.dumps(
        [f"class{i}" for i in range(TAR_CLASSES)]))
    return paths


def data_command(card: str, what: str, argv: list[str], root: pathlib.Path,
                 steps, crash: str | None = None) -> dict:
    """One train command of phase 16 (:func:`resilience_command`): its
    logged steps must be ``steps``, with finite losses, and it must launch
    rows 1, 2, 3 and 7 for exactly those steps (no replay). Adds the
    prefetch wait it saw."""
    wait = obs.get_registry("jimm_train").histogram("prefetch_wait_seconds")
    before = (wait.count, wait.sum)
    run = resilience_command(argv, card, what, root / "metrics.jsonl",
                             crash=crash)
    logged = run["logged"]
    check([r["step"] for r in logged] == list(steps)
          and all(math.isfinite(r["loss"]) for r in logged),
          f"{what}: logged {[(r['step'], r['loss']) for r in logged]}")
    steps_launched(what, run["counts"], len(steps))
    run["prefetch_wait"] = (wait.count - before[0], wait.sum - before[1])
    return run


def data_rates(run: dict) -> str:
    """A command's data_wait share of the wall time and its images/s over
    the wall time and over the step time alone."""
    goodput, logged = run["summary"]["goodput"], run["logged"]
    images = TRAIN_BATCH * len(logged)
    step_s = sum(r["step_time_s"] for r in logged)
    return (f"data_wait {goodput['data_wait_s']:.3f} s = "
            f"{goodput['data_wait_frac']:.1%} of the wall "
            f"{goodput['wall_s']:.3f} s; {images / goodput['wall_s']:.1f} "
            f"images/s by wall, {images / step_s:.1f} by step time")


def example_prints(batches: list) -> list[int]:
    """Per-example fingerprints: each row of images and tokens hashed."""
    out = []
    for images, tokens in batches:
        for image, row in zip(images, tokens):
            out.append(cli.batch_fingerprint((image, row)))
    return out


def data_phase(card: str, root: pathlib.Path, synthetic: dict
               ) -> dict[str, int]:
    """Phase 16: ``train --data`` at full width (SigLIP-B/16-256, bf16,
    batch 128) over raw TFRecord shards: (a) the records loader, (b) the
    indexed loader with worker processes, (c) a crash and ``--resume`` for
    each, (d) ViT-B/16 from tar shards and SigLIP2 ``--naflex`` from
    records, (e) the prefetcher against synchronous copies, (f) native
    preprocessing against numpy. ``synthetic``: phase 5's train command,
    whose rates (a) prints beside its own. Returns (a)'s launches, the
    slice's path."""
    t0 = time.perf_counter()
    paths = write_data_shards(root)
    print(f"16: wrote {DATA_EXAMPLES} raw {DATA_HW[0]}x{DATA_HW[1]} "
          f"image-text records in {DATA_SHARDS} shards, "
          f"{NAFLEX_DATA_EXAMPLES} NaFlex and {TAR_EXAMPLES} tar examples "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    pairs = str(paths["pairs"])
    records_argv = DATA_ARGV + ["--data", pairs, "--loader", "records"]
    grain_argv = DATA_ARGV + ["--data", pairs, "--loader", "grain",
                              "--data-workers", str(DATA_WORKERS)]

    # (a) the records loader; each step's batch is the one the reader
    # gives alone on the host
    control = {}
    run_a = data_command(card, "16(a) records", records_argv, root,
                         range(DATA_STEPS))
    control["records"] = {r["step"]: r for r in run_a["logged"]}
    host = records.image_text_batches(pairs, TRAIN_BATCH,
                                      image_size=DATA_IMAGE,
                                      seq_len=DATA_SEQ, shuffle_buffer=256)
    want = [cli.batch_fingerprint(next(host)) for _ in range(DATA_STEPS)]
    got = [control["records"][s]["batch_fingerprint"]
           for s in range(DATA_STEPS)]
    check(got == want, f"16(a): fingerprints {got} != the host reader's "
                       f"{want}")
    print(f"16(a) train --data --loader records --shuffle-buffer 256, "
          f"{DATA_STEPS} steps at batch {TRAIN_BATCH}: fingerprints equal "
          f"the host reader's; launches {run_a['counts']}; losses "
          f"{[round(r['loss'], 5) for r in run_a['logged']]}; "
          f"{data_rates(run_a)}; prefetch waits {run_a['prefetch_wait']}; "
          f"phase 5's synthetic command: {data_rates(synthetic)} | {card}",
          flush=True)

    # (b) the indexed loader with worker processes; an epoch of the same
    # loader covers every record once
    run_b = data_command(card, "16(b) grain", grain_argv, root,
                         range(DATA_STEPS))
    control["grain"] = {r["step"]: r for r in run_b["logged"]}
    t1 = time.perf_counter()
    epoch = list(grain_batches(make_grain_loader(
        pairs, TRAIN_BATCH, task="contrastive", image_size=DATA_IMAGE,
        seq_len=DATA_SEQ, num_epochs=1, worker_count=DATA_WORKERS)))
    epoch_s = time.perf_counter() - t1
    prints = example_prints(epoch)
    check(len(prints) == DATA_EXAMPLES == len(set(prints)),
          f"16(b): an epoch gave {len(prints)} examples, "
          f"{len(set(prints))} distinct, of {DATA_EXAMPLES} records")
    got = [control["grain"][s]["batch_fingerprint"]
           for s in range(DATA_STEPS)]
    want = [cli.batch_fingerprint(b) for b in epoch[:DATA_STEPS]]
    check(got == want, f"16(b): fingerprints {got} != the loader's epoch "
                       f"{want}")
    count, total = run_b["prefetch_wait"]
    print(f"16(b) train --data --loader grain --data-workers "
          f"{DATA_WORKERS}: fingerprints equal the loader's own epoch, which "
          f"covers each of the {DATA_EXAMPLES} records once ({epoch_s:.2f} s "
          f"for the epoch alone, {DATA_EXAMPLES / epoch_s:.1f} examples/s); "
          f"{data_rates(run_b)}; prefetch_wait_seconds {count} waits, "
          f"{total:.3f} s | {card}", flush=True)

    # (c) a crash after step DATA_CRASH's checkpoint, then --resume
    for loader, argv in (("records", records_argv), ("grain", grain_argv)):
        ckpt = ["--ckpt-dir", str(root / f"ckpt_{loader}"), "--save-every",
                "1"]
        crashed = data_command(
            card, f"16(c) {loader} crash@{DATA_CRASH}",
            argv + ckpt + ["--inject-faults", f"crash@{DATA_CRASH}"], root,
            range(DATA_CRASH + 1),
            crash=f"injected failure at step {DATA_CRASH}")
        same_as_control(f"16(c) {loader} crash", crashed["logged"],
                        control[loader], range(DATA_CRASH + 1))
        resumed = data_command(card, f"16(c) {loader} --resume",
                               argv + ckpt + ["--resume"], root,
                               range(DATA_CRASH + 1, DATA_STEPS))
        same_as_control(f"16(c) {loader} --resume", resumed["logged"],
                        control[loader], range(DATA_CRASH + 1, DATA_STEPS))
        restore = resumed["spans"]["checkpoint_restore"][1] * 1e3
        forward = resumed["spans"]["resume_fast_forward"][1] * 1e3
        shutil.rmtree(root / f"ckpt_{loader}")
        print(f"16(c) {loader}: crash@{DATA_CRASH} then --resume, steps "
              f"{DATA_CRASH + 1}-{DATA_STEPS - 1} equal the control's losses "
              f"and fingerprints bit for bit; time to resume {restore + forward:.3f} "
              f"ms = restore {restore:.3f} + fast-forward {forward:.3f} "
              f"({(DATA_CRASH + 1) * TRAIN_BATCH} examples skipped) | {card}",
              flush=True)

    # (d) ViT-B/16 from tar shards (its head from classes.json), SigLIP2
    # --naflex from records
    if native.codecs_available() or importlib.util.find_spec("PIL"):
        run = rest_command(card, "16(d) vit from tar", [
            "train", "--preset", "vit-base-patch16-224", "--bf16",
            "--ln-impl", "fused", "--batch-size", str(TAR_BATCH), "--data",
            str(paths["tar"])], TAR_STEPS, FAMILY_STEP["vit"])
        check(run["summary"]["num_classes"] == TAR_CLASSES,
              f"16(d): head of {run['summary']['num_classes']} classes, "
              f"classes.json has {TAR_CLASSES}")
    else:
        print("16(d) vit from tar: not driven (no PNG decoder: neither "
              "libpng in the native build nor Pillow)", flush=True)
    run = run_train_command(
        ["train", "--preset", NAFLEX_PRESET, "--naflex", "--bf16",
         "--ln-impl", "fused", "--batch-size", str(TRAIN_BATCH), "--steps",
         str(NAFLEX_DATA_STEPS), "--log-every", "1", "--data",
         str(paths["naflex"])], card)
    want = step_counts(naflex=True)
    check(run["rc"] == 0 and [r["step"] for r in run["logged"]]
          == list(range(NAFLEX_DATA_STEPS))
          and all(math.isfinite(r["loss"]) for r in run["logged"])
          and all(run["counts"][k] == want[k] * NAFLEX_DATA_STEPS
                  for k in want),
          f"16(d) naflex from records: {run['counts']}, {run['logged']}")
    print(f"16(d) train --naflex --data (SigLIP2-B/16-256, records of "
          f"{len(NAFLEX_DATA_SIZES)} aspects): {NAFLEX_DATA_STEPS} steps, "
          f"launches {run['counts']} (phase 6's per step); "
          f"{data_rates(run)} | {card}", flush=True)

    prefetch_phase(card)
    native_phase(card)
    return run_a["counts"]


def prefetch_phase(card: str) -> None:
    """(e) ``PrefetchIterator`` on the card (pinned staging, side-stream
    copies) against synchronous copies of the same host batches, bit for
    bit, with the consumer's stream held busy so that the producer runs
    ahead and reuses its staging buffers."""
    def batch(i: int):
        rng = np.random.default_rng(i)
        return ((rng.random((PREFETCH_ROWS, 96, 96, 3), np.float32),
                 rng.integers(0, 9, (PREFETCH_ROWS, 2), dtype=np.int32),
                 rng.random((PREFETCH_ROWS, 64)) < 0.5),
                rng.integers(0, 32000, (PREFETCH_ROWS, 64), dtype=np.int32))

    def synchronous(tree):
        if isinstance(tree, tuple):
            return tuple(synchronous(t) for t in tree)
        to = (torch.bfloat16 if tree.dtype.kind == "f" else torch.bool
              if tree.dtype.kind == "b" else torch.long)
        return torch.from_numpy(tree).to(device).to(to)

    device = torch.device("cuda")
    t0 = time.perf_counter()
    it = PrefetchIterator((batch(i) for i in range(PREFETCH_BATCHES)),
                          device=device, dtype=torch.bfloat16, prefetch=2)
    bad = n = 0
    for host, placed in it:
        torch.cuda._sleep(2_000_000)  # the step the batch waits behind
        want = synchronous(host)
        bad += not all(torch.equal(a, b) for a, b in
                       zip(tensor_leaves(placed), tensor_leaves(want)))
        n += 1
    torch.cuda.synchronize()
    check(n == PREFETCH_BATCHES and bad == 0,
          f"16(e): {bad} of {n} prefetched batches differ from their "
          f"synchronous copies")
    print(f"16(e) PrefetchIterator: {n} nested batches (f32 images to bf16, "
          f"int32 to int64, bool) equal their synchronous copies bit for "
          f"bit, {time.perf_counter() - t0:.2f} s | {card}", flush=True)


def tensor_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in tensor_leaves(item)]
    return [tree]


def native_phase(card: str) -> None:
    """(f) the native preprocessing at batch 128 against its numpy plain
    versions: resize 288 x 320 -> 256, normalize with SigLIP's constants
    (the trained path's), and the crop path."""
    rng = np.random.default_rng(161)
    images = rng.integers(0, 256, (TRAIN_BATCH, *DATA_HW, 3), dtype=np.uint8)
    times = {}
    for crop in (False, True):
        for name, fn in (("native", preprocess.preprocess_batch),
                         ("numpy", preprocess.preprocess_batch_plain)):
            t0 = time.perf_counter()
            out = fn(images, image_size=DATA_IMAGE, crop=crop)
            times[(crop, name)] = (time.perf_counter() - t0) * 1e3
            if name == "native":
                ours = out
        err = float(np.abs(ours - out).max())
        check(err <= 1e-6, f"16(f): native against numpy {err} > 1e-6 "
                           f"(crop {crop})")
        print(f"16(f) preprocess_batch of {TRAIN_BATCH} raw "
              f"{DATA_HW[0]}x{DATA_HW[1]} to {DATA_IMAGE}"
              f"{' (crop)' if crop else ''}"
              f": native {times[(crop, 'native')]:.1f} ms with "
              f"{native.threads()} threads, numpy "
              f"{times[(crop, 'numpy')]:.1f} ms, max abs difference "
              f"{err:.2e}; codecs built: {native.codecs_available()} "
              f"({native.build().name}) | {card}", flush=True)


# -- phase 17: profiling, TensorBoard, int8 checkpoints ----------------------

PROFILE_STEPS = 6
#: ring windows open at steps 2, 4, ..., 10 and each commits a step later
RING_STEPS = 12
RING_CAPTURES = 5
#: each launch counter of the train path -> the kernels a trace shows for
#: it (a flash backward counts once: its dq kernel)
TRACED_KERNELS = {
    "layer_norm": tuple(ln.FORWARD_KERNELS.values()),
    "layer_norm_bwd": tuple(ln.BACKWARD_KERNELS.values()),
    "flash_attention": ("flash_fwd_mma_kernel", "flash_fwd_f32_kernel"),
    "flash_attention_bwd": ("flash_bwd_dq_mma_kernel", "flash_bwd_dq_kernel"),
}
#: rows 1 and 3: the kernels a served forward launches
SERVED_KERNELS = ("layer_norm", "flash_attention")
DEEP_WINDOW_S = 5.0


def traced_launches(rows: list[dict], kernels: tuple[str, ...]) -> int:
    """Launches of ``kernels`` in an op table (``op_table`` rows)."""
    return sum(r["count"] for r in rows if r["category"] == "kernel"
               and any(_is_kernel(r["name"], k) for k in kernels))


def print_cli(argv: list[str], card: str, ok=(0,)) -> list[str]:
    """A read-only command of the CLI (``profile-analyze``, ``obs ...``) in
    this process, its output printed with a prefix naming it."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    check(rc in ok, f"python -m jimm_tpu_torch {' '.join(argv)}: rc {rc}")
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"{argv[0]}{' ' + argv[2] if argv[0] == 'obs' else ''}: "
              f"{line} | {card}", flush=True)
    return lines


def host_split(what: str, s: dict, card: str, unit: str) -> dict:
    """Print where a capture's wall time went (``capture_summary``, over
    its ``regions`` when it has them: per ``unit``); returns the numbers
    in ms per one."""
    per = s.get("regions") or 1
    ms = {k: s[k] / 1e3 / per for k in ("wall_us", "device_busy_us",
                                         "runtime_us", "cpu_op_us",
                                         "gap_us")}
    print(f"profile: {what}: wall {ms['wall_us']:.3f} ms, device busy "
          f"{ms['device_busy_us']:.3f} ms ({s['device_busy_share']:.1%}); "
          f"host: runtime (launch) calls {ms['runtime_us']:.3f} ms, other "
          f"operators {ms['cpu_op_us']:.3f} ms, gaps {ms['gap_us']:.3f} ms "
          f"(each per {unit}, over {per}); {s['kernels']} kernel launches "
          f"in the capture, operators recorded on "
          f"{s['cpu_op_threads'] or 'no thread'}, runtime calls on "
          f"{s['runtime_threads']} threads | {card}", flush=True)
    return ms


def one_shot_profile(card: str, root: pathlib.Path
                     ) -> tuple[dict, pathlib.Path]:
    """17(a): ``train --profile-dir D --tensorboard-dir T`` at batch 128, in
    this process, the launch counters read as the capture opens and
    closes. The capture must hold device events (taken again, up to three
    times, each empty one printed); the traced launches of rows 1, 2, 3
    and 7 must equal the counters' over the same steps; TensorBoard's
    losses must equal the JSONL's. Returns the profiled steps' counts and
    the capture's directory."""
    plain_trace = cli.trace
    for attempt in range(1, 4):
        d, tb = root / f"profile{attempt}", root / f"tb{attempt}"
        snaps: list[dict] = []

        @contextlib.contextmanager
        def counted(log_dir):
            snaps.append(read_counts())
            with plain_trace(log_dir):
                yield
            snaps.append(read_counts())

        argv = ["train", "--preset", "siglip-base-patch16-256", "--bf16",
                "--ln-impl", "fused", "--batch-size", str(TRAIN_BATCH),
                "--steps", str(PROFILE_STEPS), "--log-every", "1",
                "--profile-dir", str(d), "--tensorboard-dir", str(tb)]
        with mock.patch.object(cli, "trace", counted):
            run = run_train_command(argv, card)
        check(run["rc"] == 0 and run["summary"]["profiled_steps"] == [2, 4]
              and len(snaps) == 2,
              f"train --profile-dir: rc {run['rc']}, profiled steps "
              f"{run['summary'].get('profiled_steps')}, {len(snaps)} reads")
        events = load_trace_events(d)
        summary = capture_summary(events)
        if summary["device_events"]:
            break
        print(f"profile: 17(a) try {attempt}: {render_summary(summary)} | "
              f"{card}", flush=True)
    else:
        raise SmokeFailure("17(a): three one-shot captures held no device "
                           "events")
    steps = run["summary"]["profiled_steps"]
    n_steps = steps[1] - steps[0] + 1
    profiled = {k: snaps[1][k] - snaps[0][k] for k in snaps[0]}
    rows = [dataclasses.asdict(s) for s in op_stats(d)]
    traced = {k: traced_launches(rows, kernels)
              for k, kernels in TRACED_KERNELS.items()}
    check(all(traced[k] == profiled[k] > 0 for k in TRACED_KERNELS)
          and profiled == {k: step_counts().get(k, 0) * n_steps
                           for k in profiled},
          f"17(a): traced launches {traced} against the counters' "
          f"{profiled} over steps {steps}")
    print(f"profile: 17(a) steps {steps[0]}-{steps[1]} at batch "
          f"{TRAIN_BATCH}: traced launches of rows 1, 2, 3, 7 {traced} "
          f"equal the counters' | {card}", flush=True)
    print_cli(["profile-analyze", str(d), "--steps", str(n_steps),
               "--top", "12"], card)
    host_split(f"the bf16 SigLIP-B/16-256 train step at batch {TRAIN_BATCH}"
               f" (the train command's train_step ranges, steps "
               f"{steps[0]}-{steps[1]})",
               capture_summary(events, region="train_step"), card, "step")
    host_split(f"the train command's steps {steps[0]}-{steps[1]} whole "
               f"(the input wait and logging included)", summary, card,
               "capture")
    files = sorted(tb.glob("events.out.tfevents.*"))
    check(len(files) == 1, f"17(a): TensorBoard files {files}")
    events = read_event_file(files[0])
    tb_loss = {e["step"]: e["scalars"]["loss"] for e in events[1:]}
    want = {r["step"]: float(np.float32(r["loss"])) for r in run["logged"]}
    check(events[0]["file_version"] == "brain.Event:2" and tb_loss == want,
          f"17(a): TensorBoard losses {tb_loss} against the JSONL's {want}")
    print(f"profile: 17(a) TensorBoard {files[0].name}: {len(events)} "
          f"records, CRCs checked, every step's loss equal to the JSONL's "
          f"| {card}", flush=True)
    return profiled, d


def ring_profile(card: str, root: pathlib.Path, budget: int,
                 journal: pathlib.Path, off: dict) -> dict:
    """17(b): ``train --prof-ring R --prof-every 2 --prof-window 1`` with a
    byte budget the captures overflow: they must commit, evict, keep the
    ring in its budget and leave no ``.tmp``; ``obs prof ls/show/diff``
    read them. The median step with the ring on and off (``off``: phase
    5(c)'s command) and the ring's overhead are printed, not gated.
    Returns the run."""
    ring = root / "ring"
    reg = obs.get_registry("jimm_prof")
    keys = ("captures_total", "evicted_total", "overhead_seconds_total",
            "capture_failures_total", "quarantined_total")
    before = reg.snapshot()
    argv = ["train", "--preset", "siglip-base-patch16-256", "--bf16",
            "--ln-impl", "fused", "--batch-size", str(TRAIN_BATCH),
            "--steps", str(RING_STEPS), "--log-every", "1",
            "--prof-ring", str(ring), "--prof-every", "2", "--prof-window",
            "1", "--prof-ring-bytes", str(budget), "--journal", str(journal)]
    run = run_train_command(argv, card)
    after = reg.snapshot()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in keys}
    metas = list_captures(ring)
    kept = sum(m["bytes"] for m in metas)
    left = [p.name for p in ring.iterdir() if p.name.endswith(".tmp")]
    check(run["rc"] == 0 and delta["captures_total"] == RING_CAPTURES
          and delta["evicted_total"] > 0 and len(metas) >= 2
          and kept <= budget and not left
          and delta["capture_failures_total"] == 0
          and delta["quarantined_total"] == 0
          and all(m["device_events"] > 0 for m in metas),
          f"17(b): rc {run['rc']}, counters {delta}, kept "
          f"{[(m['name'], m['bytes'], m['device_events']) for m in metas]}"
          f" ({kept} of {budget} bytes), leftovers {left}")
    print_cli(["obs", "prof", "ls", str(ring)], card)
    print_cli(["obs", "prof", "show", metas[-1]["path"], "--top", "8"], card)
    print_cli(["obs", "prof", "diff", metas[-2]["path"], metas[-1]["path"],
               "--top", "5"], card, ok=(0, 1))
    on = statistics.median(r["step_time_s"] for r in run["logged"][1:])
    plain = statistics.median(r["step_time_s"] for r in off["logged"][1:])
    windows = [m["step"] for m in metas]
    for m in metas:
        print(f"profile: 17(b) {m['name']}: {m['device_events']} device "
              f"events, {m['bytes']} bytes; stop (with the sync) "
              f"{m['stop_s']:.3f} s, export {m['export_s']:.3f} s, reading "
              f"it {m['summary_s']:.3f} s | {card}", flush=True)
    print(f"profile: 17(b) ring: {delta['captures_total']} captures "
          f"committed, {delta['evicted_total']} evicted, {len(metas)} kept "
          f"(steps {windows}, {kept} of {budget} bytes), no .tmp left; "
          f"median step {on * 1e3:.3f} ms with the ring on against "
          f"{plain * 1e3:.3f} ms off (phase 5(c)); "
          f"jimm_prof_overhead_seconds_total "
          f"{delta['overhead_seconds_total']:.3f} s over "
          f"{RING_CAPTURES} captures (start, sync, stop, export); the "
          f"command's wall {run['summary']['goodput']['wall_s']} s | {card}",
          flush=True)
    return run


def served_profile(card: str, root: pathlib.Path) -> dict:
    """17(c): ``serve --prof-dir P`` at full width (SigLIP-B/16-256, bf16,
    fused LayerNorm): a deep capture through ``POST /admin/prof/trigger``
    with a cid, under traffic, committed by its timer, must carry the cid
    and hold the row 1 and row 3 kernels (taken again, up to three times,
    while it holds no device events); the ``jimm_hbm_*`` gauges must come
    from the allocator with ``model_pool`` the model's parameter and
    buffer bytes. Then the host's account of the bucket-32 forward, from a
    capture on this thread. Returns the launch counts of the traffic."""
    prof = root / "serve_prof"
    args = cli.build_parser().parse_args([
        "serve", "--preset", "siglip-base-patch16-256", "--dtype", "bf16",
        "--ln-impl", "fused", "--port", "0", "--buckets", "1,8,32",
        "--timeout-s", "120", "--prof-dir", str(prof)])
    server, model, ready = cli.build_server(args)
    try:
        size = model.config.vision.image_size
        images = np.random.default_rng(17).standard_normal(
            (32, size, size, 3)).astype(np.float32)
        bulk = {"images": [_b64(im) for im in images]}
        _post(server.port, bulk)
        zero_counts()
        for attempt in range(1, 4):
            cid = f"c-phase17-{attempt}"
            _, resp = _post(server.port, {"cid": cid, "reason": "phase 17",
                                          "window_s": DEEP_WINDOW_S},
                            "/admin/prof/trigger")
            check(resp.get("triggered") is True,
                  f"17(c): trigger answered {resp}")
            _post(server.port, bulk)
            deadline = time.monotonic() + DEEP_WINDOW_S + 60.0
            metas = []
            while not metas and time.monotonic() < deadline:
                time.sleep(0.2)
                metas = [m for m in list_captures(prof) if m["cid"] == cid]
            check(len(metas) == 1, f"17(c): capture of {cid}: {metas}")
            meta = metas[0]
            if meta["device_events"]:
                break
            print(f"profile: 17(c) try {attempt}: the deep capture of {cid}"
                  f" holds no device events ({meta}) | {card}", flush=True)
            time.sleep(10.5)  # the trigger's rate limit
        else:
            raise SmokeFailure("17(c): three deep captures held no device "
                               "events")
        counts = read_counts()
        rows = op_table(meta["path"])
        traced = {k: traced_launches(rows, TRACED_KERNELS[k])
                  for k in SERVED_KERNELS}
        check(meta["kind"] == "deep" and meta["reason"] == "phase 17"
              and all(traced[k] > 0 for k in SERVED_KERNELS),
              f"17(c): deep capture {meta}: traced {traced}")
        print(f"profile: 17(c) deep capture {meta['name']} on cid {cid}: "
              f"{meta['kernels']} kernels, rows 1 and 3 launched "
              f"{traced} times in its {meta['dur_s']} s, recorded by the "
              f"{meta['profiler_thread']} profiler thread; operators "
              f"recorded on {meta['cpu_op_threads'] or 'no thread'} "
              f"(kineto records operators only on the thread that started "
              f"it), runtime calls on {meta['runtime_threads']} threads "
              f"| {card}", flush=True)
        report = server.monitor.sample()
        pool = sum(t.numel() * t.element_size()
                   for t in [*model.parameters(), *model.buffers()])
        snap = obs.snapshot()
        check(report["devices"] and all(
            r["source"] == "allocator" and r["platform"] == "gpu"
            for r in report["devices"])
            and report["subsystems"]["model_pool"] == pool
            and snap["jimm_hbm_subsystem_model_pool_bytes"] == pool
            and snap["jimm_hbm_device0_bytes_in_use"] >= pool,
            f"17(c): memory rows {report}, model bytes {pool}")
        row = report["devices"][0]
        print(f"profile: 17(c) jimm_hbm_* from the allocator: in use "
              f"{row['bytes_in_use']} bytes, peak "
              f"{row['peak_bytes_in_use']}, limit {row['bytes_limit']}, "
              f"reserved {row['bytes_reserved']}, fragmentation "
              f"{row['fragmentation']}; model_pool {pool} bytes (the "
              f"served model's parameters and buffers) | {card}",
              flush=True)
        batch = torch.from_numpy(images).to("cuda", torch.bfloat16)
        with torch.inference_mode():
            model.encode_image(batch)
            torch.cuda.synchronize()
            with profiler_session(root / "serve_fwd"):
                for _ in range(3):
                    with annotate("forward"):
                        model.encode_image(batch)
                        torch.cuda.synchronize()
        host_split("the served bucket-32 forward (encode_image, bf16, "
                   "on this thread, synchronized)",
                   capture_summary(load_trace_events(root / "serve_fwd"),
                                   region="forward"), card, "call")
    finally:
        server.stop()
        reset_capture()
    return counts


def quantize_and_timeline(card: str, root: pathlib.Path,
                          ckpt: pathlib.Path, journal: pathlib.Path,
                          ring_run: dict) -> None:
    """17(d): ``save_quantized`` on phase 12's full-width SigLIP-B/16-256
    checkpoint: re-quantizing the dequantized file must give its bits
    back; then ``obs timeline`` over the phase's journal, the ring's
    captures and the ring run's goodput report must validate."""
    model = SigLIP.from_pretrained(ckpt, device="cuda", dtype=torch.bfloat16)
    out = root / "siglip_int8"
    t0 = time.perf_counter()
    save_quantized(model, out)
    save_s = time.perf_counter() - t0
    raw = load_file(out / "model.safetensors")
    t0 = time.perf_counter()
    again = quantize_state_dict(dequantize_state_dict(raw))
    check_s = time.perf_counter() - t0
    stamp = json.loads((out / "config.json").read_text())["jimm_quant"]
    check(set(again) == set(raw)
          and all(torch.equal(again[k], raw[k]) for k in raw)
          and stamp["format"] == "int8-v1",
          "17(d): re-quantizing the dequantized checkpoint changed bits")
    n_int8 = sum(t.dtype == torch.int8 for t in raw.values())
    size = (out / "model.safetensors").stat().st_size
    plain = (ckpt / "model.safetensors").stat().st_size
    print(f"profile: 17(d) save_quantized SigLIP-B/16-256: {n_int8} int8 "
          f"tensors, model.safetensors {size} bytes against the bf16 "
          f"checkpoint's {plain}; {save_s:.3f} s to save (host numpy), "
          f"{check_s:.3f} s to dequantize and re-quantize, every bit equal "
          f"| {card}", flush=True)
    del model
    goodput = root / "goodput.json"
    goodput.write_text(json.dumps(ring_run["summary"]["goodput"]))
    timeline = root / "timeline.json"
    print_cli(["obs", "timeline", str(journal), "--prof",
               str(root / "ring"), "--goodput", str(goodput), "-o",
               str(timeline)], card)
    trace = json.loads(timeline.read_text())
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "prof"]
    check(not validate_chrome_trace(trace)
          and len(spans) == len(list_captures(root / "ring")),
          f"17(d): timeline problems {validate_chrome_trace(trace)[:5]}, "
          f"{len(spans)} capture spans")


def profile_phase(card: str, root: pathlib.Path, off: dict,
                  ckpt: pathlib.Path) -> dict[str, dict]:
    """Phase 17; returns the launch counts of its paths: the one-shot
    capture's profiled steps and the served capture's traffic."""
    journal = root / "journal.jsonl"
    try:
        profiled, capture = one_shot_profile(card, root)
        # the three-step capture's bytes: about three one-step windows, so
        # that the ring's five overflow it
        budget = sum(p.stat().st_size for p in capture.rglob("*")
                     if p.is_file())
        ring_run = ring_profile(card, root, budget, journal, off)
        served = served_profile(card, root)
        quantize_and_timeline(card, root, ckpt, journal, ring_run)
    finally:
        reset_capture()
        obs.reset_journal()
    return {"profile": profiled, "profile_serve": served}


# -- phase 18: parallel ------------------------------------------------------

#: the global shape of phase 18(a)'s attention (SigLIP-B/16-256's vision
#: tower at batch 64: 128 tokens a rank over two ranks)
MESH_QSHAPE = (64, 256, 12, 64)
MESH_RANKS = 2
#: phase 5(c)'s steps: the learning-rate schedule decays over the run's
#: steps, so a run of fewer steps takes other updates from step 1 on
MESH_STEPS = CLI_STEPS
#: launches a rank makes per step: (flash fwd, flash bwd, LN fwd, LN bwd);
#: under sp each of the 24 blocks' attention is two ring hops, the MAP
#: probe one call over the gathered tokens; under tp each block's attention
#: one call on the rank's heads; under pp a stage runs its 6 blocks of each
#: tower on each of 4 microbatches, and the MAP probe once on the batch
MESH_STEP = {"dp": (25, 25, 48, 48), "sp": (49, 49, 48, 48),
             "tp": (25, 25, 48, 48), "pp": (49, 49, 96, 96)}
#: phase 18(a)'s bf16 gate: phase 3's cosine, and two bf16 steps of the
#: largest value where phase 3 allows one. Each hop's kernel rounds its o
#: (and dq, dk, dv) to bf16 before the merge, as JAX's ring does, so the
#: sharded call rounds once more than the unsharded one (on an H100: one
#: step of 2.0 where the largest value was 1.62)
MESH_BF16_REL_ERR = 2 * BF16_REL_ERR
#: step 0's gradient of each parameter (after the ranks' average) against
#: the single-process step's, by norm: the same batch split in two (other
#: GEMM shapes, ring instead of dense loss, gradients summed across ranks
#: in bf16) moves a norm by a few bf16 roundings (each at most 2**-8), a
#: ring loss whose gradient is N times too large or a gradient that was
#: not averaged by a factor of 2. The losses alone cannot show either:
#: Adam after global-norm clipping hardly sees a gradient's scale. The key
#: biases are held apart: under softmax every query's scores shift by one
#: constant, so their gradient is zero but for rounding (1e-8 of the
#: largest norm in f32 on the CPU), and a relative deviation means nothing;
#: both runs' key-bias norms must stay within the gate of the largest
#: norm. Under sp the seqpar ring rounds each hop's dq, dk and dv to bf16
#: before it sums the hops, and the hops' dq share the keys' common
#: component with opposite signs (a query's weights P (dP - delta) sum to
#: zero over both hops), so that rounding is amplified where
#: the component dominates: 4.29e-2 on block 10's q weight on an H100
#: (5.32e-3 at most under dp and fsdp)
MESH_GRAD_RTOL = {"dp": 5e-2, "sp": 0.15, "tp": 5e-2, "pp": 5e-2}
ZERO_GRAD = "attn.k.bias"


def bf16_step(x: float) -> float:
    """One bf16 step (unit in the last place) at ``x``: two ranks' losses
    may differ from the single-process command's by this much, at most (on
    the card they were equal to the last bit)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def within_a_bf16_step(got: list[float], want: list[float]) -> bool:
    return len(got) == len(want) and all(
        abs(a - w) <= bf16_step(w) for a, w in zip(got, want))


@contextlib.contextmanager
def first_grad_norms():
    """Record, at the first call of the trainer's ``finish_gradients``
    (after the ranks' gradients are averaged, before clipping), the norm of
    each parameter's whole gradient, by name, into the dict this yields.
    FSDP2 shards, model slices and other stages' blocks are gathered first
    (``sharding.gather_whole``): on a mesh every rank makes the call."""
    from jimm_tpu_torch.parallel.sharding import gather_whole
    from jimm_tpu_torch.train import trainer
    norms: dict[str, float] = {}
    real = trainer.finish_gradients

    def finish(model):
        real(model)
        if norms:
            return
        grads = {name: p.grad for name, p in model.named_parameters()
                 if p.grad is not None}
        for name, g in gather_whole(model, grads).items():
            norms[name] = g.float().norm().item()

    with mock.patch.object(trainer, "finish_gradients", finish):
        yield norms


@contextlib.contextmanager
def amax_record():
    """Record, at every call of the trainer's ``finish_gradients`` (a
    step's end, after the mesh's amax sync), a digest of all the fp8 amax
    histories of the model and the first blocks' histories themselves,
    into the list this yields (nothing for a model without fp8 modules)."""
    from jimm_tpu_torch.train import trainer
    steps: list[dict] = []
    real = trainer.finish_gradients

    def finish(model):
        real(model)
        hist = {n: b for n, b in model.named_buffers() if n.endswith("_amax")}
        if not hist:
            return
        flat = torch.cat([hist[n].reshape(-1) for n in sorted(hist)])
        steps.append({"digest": hashlib.sha1(
            flat.cpu().numpy().tobytes()).hexdigest(), "first": {
                n: t.tolist() for n, t in hist.items()
                if ".encoder.blocks.0." in n}})

    with mock.patch.object(trainer, "finish_gradients", finish):
        yield steps


def _rank_json(out: pathlib.Path, task: str, payload: dict) -> None:
    rank = torch.distributed.get_rank() if \
        torch.distributed.is_initialized() else int(os.environ["RANK"])
    (out / f"{task}-rank{rank}.json").write_text(json.dumps(payload))


def _mesh_case(name: str, run, want: tuple, plain: tuple) -> dict:
    """One sharded call's output and gradients (``run() -> (o, dq, dk,
    dv)``, this rank's chunks) against the unsharded kernels' and the plain
    versions' chunks (cosine >= ``BF16_MIN_COS``, max abs error <=
    ``MESH_BF16_REL_ERR`` of the largest value), and its time. The gates
    are recorded, not raised: a rank that stopped here would leave its
    peer waiting in the next collective."""
    got = run()
    ms = cuda_ms(run, 5, 1)
    out = {"ms": ms, "failed": []}
    for ref_name, ref in (("kernel", want), ("plain", plain)):
        e = [compare(a, w) for a, w in zip(got, ref)]
        out[f"vs_{ref_name}"] = e  # (err, cos, peak) of o, dq, dk, dv
        if not all(cos >= BF16_MIN_COS and err <= MESH_BF16_REL_ERR * peak
                   for err, cos, peak in e):
            out["failed"].append(f"vs the unsharded {ref_name}")
    return out


def attention_task(out: pathlib.Path) -> None:
    """Phase 18(a) on one rank: the seqpar ring (softmax, masked, sigmoid),
    Ulysses and the causal zigzag ring, each on this rank's chunk of the
    same global bf16 inputs, forward and backward."""
    from jimm_tpu_torch.parallel import comm
    from jimm_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from jimm_tpu_torch.parallel.ring_attention import (ring_attention,
                                                        zigzag_shard)
    from jimm_tpu_torch.parallel.seqpar import ring_attention_sp
    from jimm_tpu_torch.parallel.sharding import use_sharding
    from jimm_tpu_torch.parallel.ulysses import ulysses_attention
    dev = initialize_distributed()
    check(dev.type == "cuda", f"rank device {dev}")
    mesh = make_mesh({"seq": MESH_RANKS})
    grp = comm.axis_group("seq", mesh)
    b, s, n, d = MESH_QSHAPE
    g = torch.Generator(device="cuda").manual_seed(18)
    q, k, v, do = (torch.randn(b, s, n, d, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    # key lengths 96..256: the padding crosses the shard boundary, and
    # leaves some rows nothing to attend on rank 1's hop
    lengths = torch.randint(s * 3 // 8, s + 1, (b,), generator=g,
                            device="cuda")
    mask = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
    part = slice(grp.index * s // MESH_RANKS,
                 (grp.index + 1) * s // MESH_RANKS)

    def chunks(o, grads):
        return (o[:, part], *(x[:, part] for x in grads))

    def unsharded(fn, qq=q, kk=k, vv=v, dd=do):
        """The unsharded kernel call's output and gradients."""
        x = [t.detach().clone().requires_grad_() for t in (qq, kk, vv)]
        o = fn(*x)
        o.backward(dd)
        return o.detach(), [t.grad for t in x]

    def plain_softmax(m=None):
        cm = None if m is None else fa.canon_mask(m, b, s)
        o, lse = fa.flash_attention_plain(q, k, v, mask=cm)
        return chunks(o, fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      mask=cm))

    def plain_sigmoid():
        lb = fa.default_logit_bias(s)
        o = fa.sigmoid_attention_plain(q, k, v, logit_bias=lb)
        return chunks(o, fa.sigmoid_attention_bwd_plain(q, k, v, do,
                                                        logit_bias=lb))

    # the zigzag case's inputs and references, in the zigzag layout
    zq, zk, zv, zdo = (zigzag_shard(t, MESH_RANKS) for t in (q, k, v, do))
    o_c, gr_c = unsharded(lambda *x: fa.flash_attention(*x, is_causal=True))
    oc_p, lse_c = fa.flash_attention_plain(q, k, v, is_causal=True)
    gc_p = fa.flash_attention_bwd_plain(q, k, v, oc_p, lse_c, do,
                                        is_causal=True)

    def zig(o, grads):
        return chunks(zigzag_shard(o, MESH_RANKS),
                      [zigzag_shard(x, MESH_RANKS) for x in grads])

    refs = {
        "softmax": (chunks(*unsharded(fa.flash_attention)), plain_softmax()),
        "masked": (chunks(*unsharded(lambda *x: fa.flash_attention_masked(
            *x, mask))), plain_softmax(mask)),
        "sigmoid": (chunks(*unsharded(fa.sigmoid_attention)),
                    plain_sigmoid()),
        "ulysses": (chunks(*unsharded(fa.flash_attention)), plain_softmax()),
        "zigzag_causal": (zig(o_c, gr_c), zig(oc_p, gc_p)),
    }
    mine = [t[:, part].contiguous() for t in (q, k, v, do)]
    zmine = [t[:, part].contiguous() for t in (zq, zk, zv, zdo)]
    calls = {
        "softmax": lambda x: ring_attention_sp(*x, impl="flash"),
        "masked": lambda x: ring_attention_sp(*x, mask=mask[:, part],
                                              impl="flash"),
        "sigmoid": lambda x: ring_attention_sp(*x, kind="sigmoid",
                                               impl="flash"),
        "ulysses": lambda x: ulysses_attention(*x, impl="flash"),
        "zigzag_causal": lambda x: ring_attention(*x, is_causal=True,
                                                  zigzag=True, impl="flash"),
    }

    def sharded(name):
        qkv, dd = (zmine if name == "zigzag_causal" else mine)[:3], \
            (zmine if name == "zigzag_causal" else mine)[3]

        def run():
            x = [t.detach().clone().requires_grad_() for t in qkv]
            with use_sharding(mesh, "sp"):
                o = calls[name](x)
                o.backward(dd)
            return (o.detach(), *(t.grad for t in x))
        return run

    ring = obs.get_registry("jimm_ring").counter(
        "jimm_ring_bytes_permuted_total")
    # the launches of the sharded calls alone (the references ran above)
    zero_counts()
    before = ring.value
    for name in calls:
        sharded(name)()
    torch.cuda.synchronize()
    counts, ring_bytes = read_counts(), ring.value - before
    cases = {name: _mesh_case(name, sharded(name), *refs[name])
             for name in calls}
    _rank_json(out, "attention", {
        "cases": cases, "counts": counts, "ring_bytes": ring_bytes,
        "backend": torch.distributed.get_backend(),
        "peak": torch.cuda.max_memory_allocated()})
    failed = {n: c["failed"] for n, c in cases.items() if c["failed"]}
    check(not failed, f"mesh attention: {failed}")


def train_task(out: pathlib.Path, what: str, argv: list[str]) -> None:
    """Phases 18(b)/(c) and 19 on one rank: ``python -m jimm_tpu_torch
    <argv>`` (``train --mesh ...``) in this process, inside the launch's
    process group, its launches counted and step 0's gradient norms
    recorded."""
    ring = obs.get_registry("jimm_ring").counter(
        "jimm_ring_bytes_permuted_total")
    before = ring.value
    torch.cuda.reset_peak_memory_stats()
    with first_grad_norms() as norms, amax_record() as amax:
        zero_counts()
        fp8.amax_reductions = fp8_policy.amax_syncs = 0
        rc = cli.main(argv)
        counts = read_counts()
    _rank_json(out, what, {
        "rc": rc, "counts": counts, "ring_bytes": ring.value - before,
        "grad_norms": norms, "peak": torch.cuda.max_memory_allocated(),
        "amax": amax, "amax_reductions": fp8.amax_reductions,
        "amax_syncs": fp8_policy.amax_syncs})


def rank_main(argv: list[str]) -> int:
    """A rank of phases 18 and 19, started by ``torch.distributed.run``:
    ``--rank-task runs --out DIR --runs FILE``, the runs FILE lists (the
    attention case, train commands), one after another in one process
    group: a launch's start (imports, the kernels' load, the group, the
    first step's warm-up) is paid once."""
    from jimm_tpu_torch.parallel.mesh import initialize_distributed
    out, runs = pathlib.Path(argv[3]), json.loads(
        pathlib.Path(argv[5]).read_text())
    try:
        initialize_distributed()
        for run in runs:
            if run["task"] == "attention":
                attention_task(out)
            elif run["task"] == "collectives":
                collectives_task(out, run["what"])
            elif run["task"] == "supervise":
                supervise_task(out, run["what"], run["argv"])
            elif run["task"] == "preempt":
                preempt_task(out, run["what"], run["argv"])
            else:
                train_task(out, run["what"], run["argv"])
    except SmokeFailure as e:
        print(f"chip_smoke rank: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


def ranks_run(card: str, what: str, root: pathlib.Path, runs: list[dict],
              ranks: int = MESH_RANKS) -> dict[str, list[dict]]:
    """Phases 18 and 19: this script as ``ranks`` ranks on the one card
    (``python -m torch.distributed.run --standalone``) doing ``runs`` (each
    ``{"what", "task": "attention"|"train", "argv"}``) in turn, rank 0's
    lines printed with a ``mesh:`` prefix; any rank's failure fails the
    phase. Returns each run's records, by rank."""
    out = root / what
    out.mkdir()
    plan = root / f"{what}.runs.json"
    plan.write_text(json.dumps(runs))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(ranks), str(pathlib.Path(
               __file__).resolve()), "--rank-task", "runs", "--out", str(out),
           "--runs", str(plan)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        print(f"mesh: {what}: {line} | {card}", flush=True)
    if proc.returncode:
        # each rank's failure and record, then the end of the launcher's log
        fails = [ln for ln in proc.stderr.splitlines()
                 if "chip_smoke rank: FAIL" in ln or "Error:" in ln]
        print("\n".join(fails[:20]), file=sys.stderr, flush=True)
        for f in sorted(out.glob("*.json")):
            print(f"mesh: {what}: {f.name}: {f.read_text()[:6000]}",
                  flush=True)
    check(proc.returncode == 0,
          f"{what}: torch.distributed.run exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    records = {run["what"]: [json.loads(
        (out / f"{run['what']}-rank{r}.json").read_text())
        for r in range(ranks)] for run in runs}
    print(f"mesh: {what}: {ranks} ranks ran {list(records)} in "
          f"{time.perf_counter() - t0:.1f} s; peak memory per rank "
          + ", ".join(f"{w} {[r['peak'] for r in rs]}"
                      for w, rs in records.items()) + f" bytes | {card}",
          flush=True)
    return records


def train_argv(batch: int = TRAIN_BATCH) -> list[str]:
    """Phase 5(c)'s train command (at ``batch``), without its metrics
    file."""
    return ["train", "--preset", "siglip-base-patch16-256", "--bf16",
            "--ln-impl", "fused", "--steps", str(MESH_STEPS), "--batch-size",
            str(batch), "--log-every", "1"]


def mesh_run(what: str, root: pathlib.Path, extra: list[str],
             batch: int = TRAIN_BATCH, task: str = "train") -> dict:
    """Phase 5(c)'s train command (at ``batch``) with ``extra`` (a mesh),
    as a run of :func:`ranks_run`, its metrics in ``root /
    f"{what}.jsonl"``."""
    return {"what": what, "task": task, "argv": [
        *train_argv(batch), "--metrics-file", str(root / f"{what}.jsonl"),
        *extra]}


def _norms_within(what: str, ranks: list[dict], ref: dict[str, float],
                  gate: float) -> tuple[dict, list[str], float, float]:
    """Each rank's step-0 gradient norms (``first_grad_norms``) against the
    single process's ``ref``: every parameter's within ``gate`` relative,
    the key biases' (zero but for rounding) within ``gate`` of the largest
    norm. Returns the ranks' relative deviations, the key-bias names, the
    largest key-bias norm and the largest norm."""
    top = max(ref.values(), default=0.0)
    zero = [n for n in ref if n.endswith(ZERO_GRAD)]
    dev, key_bias = {}, 0.0
    for i, r in enumerate(ranks):
        got = r["grad_norms"]
        check(sorted(got) == sorted(ref) and top > 0,
              f"{what}: rank {i} has gradients of {len(got)} parameters, "
              f"the single process of {len(ref)}")
        dev[i] = {n: abs(got[n] - w) / w for n, w in ref.items()
                  if n not in zero}
        bad = {n: (got[n], ref[n]) for n, e in dev[i].items()
               if e > gate}
        check(not bad, f"{what}: rank {i}'s step-0 gradient norms off by "
              f"more than {gate} (mesh, single process): "
              f"{dict(list(bad.items())[:8])} ({len(bad)} of {len(ref)})")
        key_bias = max([key_bias, *(max(got[n], ref[n]) for n in zero)])
        check(key_bias <= gate * top,
              f"{what}: rank {i}'s key-bias gradient norm {key_bias} is not "
              f"near zero (largest norm {top})")
    return dev, zero, key_bias, top


def mesh_train(card: str, what: str, root: pathlib.Path, ranks: list[dict],
               single: dict, kind: str) -> dict:
    """Phases 18(b)/(c) and 19: the gates of a :func:`mesh_run` whose ranks
    left ``ranks``: every step's loss against the single-process command's
    (``single``) within one bf16 step, each rank's step-0 gradient norms
    against its within ``MESH_GRAD_RTOL[kind]``, each rank's launches
    those of ``MESH_STEP[kind]`` a step. Returns the run's logged steps."""
    gate, steps = MESH_GRAD_RTOL[kind], MESH_STEPS
    logged = [json.loads(line) for line in
              (root / f"{what}.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in logged]
    want = [r["loss"] for r in single["logged"][:steps]]
    check(within_a_bf16_step(losses, want),
          f"{what}: losses {losses} vs the single-process command's {want}")
    dev, zero, key_bias, top = _norms_within(what, ranks,
                                             single["grad_norms"], gate)
    worst = max(dev[0], key=dev[0].get)
    fwd, bwd, ln_f, ln_b = MESH_STEP[kind]
    for r in ranks:
        c = r["counts"]
        check(r["rc"] == 0 and c["flash_attention"] == fwd * steps
              and c["flash_attention_bwd"] == bwd * steps
              and c["layer_norm"] == ln_f * steps
              and c["layer_norm_bwd"] == ln_b * steps,
              f"{what}: rank launches {c} over {steps} steps")
    times = [r["step_time_s"] for r in logged[1:]]
    print(f"mesh: {what}: losses {losses} (single process {want}); median "
          f"step {statistics.median(times) * 1e3:.1f} ms over steps 1-"
          f"{steps - 1} ({len(ranks)} ranks sharing one card); step 0's "
          f"{len(dev[0])} gradient norms against the single process's: "
          f"largest relative deviation {dev[0][worst]:.3e} ({worst}), the "
          f"{len(zero)} key biases' at most {key_bias / top:.3e} of the "
          f"largest norm {top!r}, sum of "
          f"norms {sum(ranks[0]['grad_norms'].values())!r} vs "
          f"{sum(single['grad_norms'].values())!r}; "
          f"jimm_ring_bytes_permuted_total per rank "
          f"{[r['ring_bytes'] for r in ranks]} | {card}", flush=True)
    return logged


def parallel_runs(root: pathlib.Path) -> list[dict]:
    """Phase 18's two-rank runs (:func:`ranks_run`): (a) the
    sequence-parallel attention; (b) ``train --mesh data=2`` under ``dp``
    and ``fsdp`` (the latter saving a checkpoint at step 0); (c) ``--mesh
    seq=2 --rules sp``."""
    return [
        {"what": "attention", "task": "attention"},
        mesh_run("mesh_dp", root, ["--mesh", "data=2", "--rules", "dp"]),
        mesh_run("mesh_fsdp", root, ["--mesh", "data=2", "--rules", "fsdp",
                                     "--ckpt-dir", str(root / "ckpt"),
                                     "--save-every", "100"]),
        mesh_run("mesh_sp", root, ["--mesh", "seq=2", "--rules", "sp"],
                 QUANT_BATCH)]


def parallel_phase(card: str, root: pathlib.Path, single: dict,
                   runs: dict[str, list[dict]],
                   single_small: dict) -> dict[str, dict]:
    """Phase 18: the gates of :func:`parallel_runs`' ``runs``, then
    (d)+(e) (b)'s checkpoint resumed as ``--mesh data=1 --rules fsdp``, one
    rank over NCCL in this process. The sp run is at batch ``QUANT_BATCH``
    (its ring hops through gloo cost 5-8 s a batch-128 step), held to
    ``single_small``, the single process's run at that batch; dp and fsdp
    to ``single``, phase 5(c)'s. Returns rank 0's launches per path."""
    ckpt = root / "ckpt"
    ranks = runs["attention"]
    for name in ranks[0]["cases"]:
        print(f"mesh: attention {name} {MESH_QSHAPE} bf16, this rank's "
              f"chunk fwd+bwd: " + ", ".join(
                  f"rank {i} {r['cases'][name]}" for i, r in
                  enumerate(ranks)) + f" | {card}", flush=True)
    c = ranks[0]["counts"]
    check(all(c[k] > 0 for k in ("flash_attention", "flash_attention_bwd",
                                 "flash_attention_masked",
                                 "flash_attention_masked_bwd",
                                 "sigmoid_attention",
                                 "sigmoid_attention_bwd")),
          f"mesh attention launches {c}")
    print(f"mesh: attention: backend {ranks[0]['backend']}; launches {c}; "
          f"jimm_ring_bytes_permuted_total per rank "
          f"{[r['ring_bytes'] for r in ranks]} | {card}", flush=True)
    paths = {"mesh_attention": c}
    logged = {what: mesh_train(card, what, root, runs[what],
                               single_small if kind == "sp" else single, kind)
              for what, kind in (("mesh_dp", "dp"), ("mesh_fsdp", "dp"),
                                 ("mesh_sp", "sp"))}
    paths.update({what: runs[what][0]["counts"] for what in logged})
    check(all(r["ring_bytes"] > 0 for r in runs["mesh_sp"]),
          "sp moved no ring bytes")
    whole = logged["mesh_fsdp"]
    # (d) + (e): step 0's checkpoint of the two-rank fsdp run, resumed by
    # one rank over NCCL
    topo = obs.get_registry("jimm_train").counter(
        "checkpoint_topology_changes_total")
    before = topo.value
    run = run_train_command(
        ["train", "--preset", "siglip-base-patch16-256", "--bf16",
         "--ln-impl", "fused", "--steps", str(MESH_STEPS), "--batch-size",
         str(TRAIN_BATCH), "--log-every", "1", "--mesh", "data=1",
         "--rules", "fsdp", "--ckpt-dir", str(ckpt), "--save-every", "100",
         "--resume"], card)
    summary, logged = run["summary"], run["logged"]
    check(run["rc"] == 0 and summary.get("backend") == "nccl"
          and summary.get("start_step") == 1,
          f"the one-rank NCCL resume: {summary}")
    check(topo.value - before == 1,
          f"checkpoint_topology_changes_total moved {topo.value - before}")
    check(not torch.distributed.is_initialized(), "the group outlived train")
    got = [r["loss"] for r in logged]
    want = [r["loss"] for r in whole[1:]]
    check(within_a_bf16_step(got, want),
          f"resumed losses {got} vs the two-rank run's {want}")
    times = [r["step_time_s"] for r in logged[1:]]
    print(f"mesh: mesh_nccl: --mesh data=1 --rules fsdp over NCCL resumed "
          f"step 0's two-rank checkpoint: losses {got} (uninterrupted {want});"
          f" checkpoint_topology_changes_total +1; median step "
          f"{statistics.median(times) * 1e3:.1f} ms; peak "
          f"{run['peak']} bytes | {card}", flush=True)
    paths["mesh_nccl"] = run["counts"]
    check(run["counts"]["flash_attention"] == 25 * (MESH_STEPS - 1),
          f"mesh_nccl launches {run['counts']}")
    paths["mesh"] = {k: sum(p[k] for p in paths.values()) for k in c}
    return paths


# -- phase 19: the model and stage axes ------------------------------------

def model_stage_runs(root: pathlib.Path) -> list[dict]:
    """Phase 19's two-rank runs (:func:`ranks_run`): (a) ``--rules tp``,
    (b) ``--rules pp`` with V = 1 and 2 (the latter saving step 0)."""
    pp = ["--mesh", "data=1,stage=2", "--rules", "pp"]
    return [
        mesh_run("mesh_tp", root, ["--mesh", "data=1,model=2", "--rules",
                                   "tp"], QUANT_BATCH),
        mesh_run("mesh_pp", root, pp),
        mesh_run("mesh_pp_v2", root, [*pp, "--pipeline-virtual", "2",
                                      "--ckpt-dir", str(root / "ckpt_pp"),
                                      "--save-every", "100"])]


def model_stage_phase(card: str, root: pathlib.Path, single: dict,
                      runs: dict[str, list[dict]],
                      single_small: dict) -> dict[str, dict]:
    """Phase 19: (c) ``--rules fsdp_tp`` on four ranks, the gates of it and
    of :func:`model_stage_runs`' ``runs``, then (d) (b)'s V = 2 checkpoint
    resumed by one NCCL rank in this process. The tp runs are at batch
    ``QUANT_BATCH`` (their activation sums through gloo cost ~6 s a
    batch-128 step), held to ``single_small``, the single process's run at
    that batch; the pp runs to ``single``, phase 5(c)'s. Returns rank 0's
    launches per path."""
    ckpt = root / "ckpt_pp"
    runs = dict(runs)
    runs.update(ranks_run(card, "phase19c", root, [mesh_run(
        "mesh_fsdp_tp", root, ["--mesh", "data=2,model=2", "--rules",
                               "fsdp_tp"], QUANT_BATCH)], ranks=4))
    logged = {what: mesh_train(card, what, root, runs[what],
                               single_small if kind == "tp" else single, kind)
              for what, kind in (("mesh_tp", "tp"), ("mesh_pp", "pp"),
                                 ("mesh_pp_v2", "pp"), ("mesh_fsdp_tp", "tp"))}
    paths = {what: runs[what][0]["counts"] for what in logged}
    whole = logged["mesh_pp_v2"]
    saved = json.loads((ckpt / "0" / "checkpoint.json").read_text())
    check(saved["mesh"] == {"axes": {"data": 1, "stage": 2},
                            "n_devices": 2},
          f"the pp checkpoint's layout {saved['mesh']}")
    # (d): step 0's checkpoint of the two-stage V = 2 run, every block
    # under its own name, resumed by one rank over NCCL
    topo = obs.get_registry("jimm_train").counter(
        "checkpoint_topology_changes_total")
    before = topo.value
    run = run_train_command(
        ["train", "--preset", "siglip-base-patch16-256", "--bf16",
         "--ln-impl", "fused", "--steps", str(MESH_STEPS), "--batch-size",
         str(TRAIN_BATCH), "--log-every", "1", "--mesh", "data=1",
         "--ckpt-dir", str(ckpt), "--save-every", "100", "--resume"], card)
    summary, logged = run["summary"], run["logged"]
    check(run["rc"] == 0 and summary.get("backend") == "nccl"
          and summary.get("start_step") == 1,
          f"the one-rank NCCL resume of the pp checkpoint: {summary}")
    check(topo.value - before == 1,
          f"checkpoint_topology_changes_total moved {topo.value - before}")
    check(not torch.distributed.is_initialized(), "the group outlived train")
    got = [r["loss"] for r in logged]
    want = [r["loss"] for r in whole[1:]]
    check(within_a_bf16_step(got, want),
          f"resumed losses {got} vs the two-stage run's {want}")
    check(run["counts"]["flash_attention"] == 25 * (MESH_STEPS - 1)
          and run["counts"]["layer_norm_bwd"] == 48 * (MESH_STEPS - 1),
          f"mesh_pp_resume launches {run['counts']}")
    times = [r["step_time_s"] for r in logged[1:]]
    print(f"mesh: mesh_pp_resume: --mesh data=1 over NCCL resumed step 0's "
          f"two-stage V=2 checkpoint: losses {got} (uninterrupted {want}); "
          f"checkpoint_topology_changes_total +1; median step "
          f"{statistics.median(times) * 1e3:.1f} ms; peak {run['peak']} "
          f"bytes | {card}", flush=True)
    paths["mesh_pp_resume"] = run["counts"]
    return paths

# -- phase 20: fp8_hybrid and int8_qk on the mesh, the drills ----------------

#: phase 20's batch: its mesh runs are held to single-process runs of the
#: same command at this batch, made in the phase (under tp a batch-128
#: step spends ~6 s in gloo's activation sums on two ranks sharing an H100)
QUANT_BATCH = 32
#: the quantized runs' learning rate: every step starts from the same
#: weights. A free step of a quantized model flips roundings that another
#: layout makes differently, and these 5-step runs are chaotic (the loss
#: 5.75 -> 16.0 -> 11.875 at batch 32): on the card fp8 under dp left one
#: process's at step 4 (9.25 against 11.875), int8 under tp at step 3, in
#: bf16 and each step otherwise equal. The drills keep the default rate:
#: bf16 runs round alike, and a resume that restored the wrong weights
#: must show
QUANT_LR = ["--lr", "0"]
#: the fp8 GEMM's mesh reductions a rank makes per step: one gradient-amax
#: all-reduce a backward of each of the 151 Linears, and one sync of the
#: forward's amaxes at the step's end
AMAX_REDUCTIONS_PER_STEP = FP8_LINEARS
AMAX_SYNCS_PER_STEP = 1
#: the collectives' timing loop
COLLECTIVE_CALLS = 100


def quant_step(kind: str) -> dict[str, int]:
    """Launches a rank makes per step in phase 20's run ``kind``: the
    single process's under dp and tp (every Linear and attention runs once
    on each rank, on its rows or its slices); under pp a stage runs its 6
    blocks of each tower on 4 microbatches and the MAP probe once."""
    precision = "fp8_hybrid" if "fp8" in kind else "int8_qk"
    want = step_counts(precision)
    if kind.endswith("_pp"):
        want.update(flash_attention_int8=49, flash_attention_int8_bwd=49,
                    layer_norm=96, layer_norm_bwd=96)
    return want


def collectives_task(out: pathlib.Path, what: str) -> None:
    """Phase 20(e) on one rank: the time of the collectives the phase adds,
    each over ``COLLECTIVE_CALLS`` calls on this launch's gloo group: the
    preemption agreement (one int64 all-reduce on the host), the
    backward's gradient amax (one f32 on the card) and the step-end amax
    sync ((151, 2) f32 on the card)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    one = torch.zeros(1, device=dev)
    pairs = torch.zeros(FP8_LINEARS, 2, device=dev)
    flag = torch.zeros(1, dtype=torch.int64)
    world = torch.distributed.group.WORLD

    def timed(fn) -> float:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        for _ in range(COLLECTIVE_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / COLLECTIVE_CALLS * 1e3

    _rank_json(out, what, {
        "agree_ms": timed(lambda: comm.all_reduce_max_(flag, world)),
        "dy_amax_ms": timed(lambda: comm.all_reduce_max_(one, world)),
        "amax_sync_ms": timed(lambda: comm.all_reduce_max_(pairs, world)),
        "backend": torch.distributed.get_backend(), "peak": 0})


def _attempts(fn):
    """``fn()`` with every ``cli.cmd_train`` call it makes timed: the
    calls' walls and outcomes, and the checkpoint spans' counts and seconds
    over ``fn``."""
    calls = []
    real = cli.cmd_train

    def timed(ns):
        t0, outcome = time.perf_counter(), "failed"
        try:
            rc = real(ns)
            outcome = "done"
            return rc
        except PreemptedError:
            outcome = "preempted"
            raise
        finally:
            calls.append({"wall": time.perf_counter() - t0,
                          "outcome": outcome, "max_devices": ns.max_devices})

    before = span_totals()
    with mock.patch.object(cli, "cmd_train", timed):
        result = fn()
    spans = {k: (n - before[k][0], s - before[k][1])
             for k, (n, s) in span_totals().items()}
    return result, calls, spans


def supervise_task(out: pathlib.Path, what: str, argv: list[str]) -> None:
    """Phase 20(c) on one rank: ``supervise --elastic --shrink-plan 2,1``
    over this launch's ranks: its return code, each attempt's wall and
    outcome, the counters it moved and the restore's span."""
    keys = ("jimm_train_restarts_total", "jimm_train_topology_changes_total",
            "jimm_train_checkpoint_topology_changes_total",
            "jimm_train_goodput_advisor_decisions_total")
    before = obs.snapshot()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc, calls, spans = _attempts(lambda: cli.main(["supervise", *argv]))
    snap = obs.snapshot()
    _rank_json(out, what, {
        "rc": rc, "attempts": calls, "spans": spans,
        "printed": printed.getvalue().splitlines()[-6:],
        "counted": {k: snap.get(k, 0.0) - before.get(k, 0.0) for k in keys},
        "peak": torch.cuda.max_memory_allocated()})


def preempt_task(out: pathlib.Path, what: str, argv: list[str]) -> None:
    """Phase 20(d) on one rank: ``argv`` (a two-rank train command whose
    fault plan preempts rank 0 alone at step 2), then its ``--resume``:
    each attempt's outcome, the step a preemption saved, and its wall."""
    records = []
    for extra in ([], ["--resume"]):
        def attempt():
            try:
                return {"rc": cli.main(argv + extra), "step": None}
            except PreemptedError as e:
                return {"rc": None, "step": e.step}
        got, calls, spans = _attempts(attempt)
        records.append({**got, "wall": calls[0]["wall"], "spans": spans})
    _rank_json(out, what, {"attempts": records,
                           "peak": torch.cuda.max_memory_allocated()})


def quant_runs(root: pathlib.Path) -> list[dict]:
    """Phase 20's two-rank runs (:func:`ranks_run`), at batch
    ``QUANT_BATCH``: (a) fp8_hybrid under dp; (b) fp8_hybrid and int8_qk
    under tp, int8_qk under pp; (c) the elastic crash drill; (d) the rank-0
    preemption and its resume; (e) the collectives' times."""
    def q(what: str, *extra: str, task: str = "train") -> dict:
        return mesh_run(what, root, list(extra), QUANT_BATCH, task)

    tp, pp = ("--mesh", "data=1,model=2", "--rules", "tp"), (
        "--mesh", "data=1,stage=2", "--rules", "pp")
    elastic = q("q_elastic", "--ckpt-dir", str(root / "ckpt_elastic"),
                "--save-every", "2", "--inject-faults", "crash@2")
    elastic["task"] = "supervise"
    elastic["argv"] = ["--max-restarts", "2", "--backoff-base-s", "0.01",
                       "--seed", "0", "--elastic", "--shrink-plan", "2,1",
                       "--adapt", "--", *elastic["argv"]]
    return [
        q("q_fp8_dp", "--mesh", "data=2", "--rules", "dp", "--precision",
          "fp8_hybrid", *QUANT_LR),
        q("q_fp8_tp", *tp, "--precision", "fp8_hybrid", *QUANT_LR),
        q("q_int8_tp", *tp, "--precision", "int8_qk", *QUANT_LR),
        q("q_int8_pp", *pp, "--precision", "int8_qk", *QUANT_LR),
        elastic,
        q("q_preempt", "--mesh", "data=2", "--rules", "dp", "--ckpt-dir",
          str(root / "ckpt_preempt"), "--save-every", "100",
          "--preemption-save", "--grace-steps", "0", "--inject-faults",
          "preempt@2", task="preempt"),
        {"what": "collectives", "task": "collectives"}]


def _losses_within(what: str, logged: list[dict], want: list[float]
                   ) -> list[float]:
    got = [r["loss"] for r in logged]
    check(within_a_bf16_step(got, want),
          f"{what}: losses {got} vs the single-process command's {want}")
    return got


def small_batch_references(card: str) -> dict[str, dict]:
    """The single-process train command at batch ``QUANT_BATCH``, the
    reference of phase 18's sp run, phase 19's tp runs and phase 20: bf16 (with step 0's
    gradient norms), and int8_qk and fp8_hybrid (with its histories) at
    ``QUANT_LR``; each run's launches checked."""
    refs = {}
    for precision in ("bf16", "int8_qk", "fp8_hybrid"):
        argv = train_argv(QUANT_BATCH) + ["--precision", precision] + (
            [] if precision == "bf16" else QUANT_LR)
        with first_grad_norms() as norms, amax_record() as amax:
            run = run_train_command(argv, card)
        run.update(grad_norms=norms, amax=amax)
        want = step_counts(None if precision == "bf16" else precision)
        check(run["rc"] == 0 and all(run["counts"][k] == want[k] * MESH_STEPS
                                     for k in want),
              f"the single-process {precision} command at batch "
              f"{QUANT_BATCH}: rc {run['rc']}, launches {run['counts']}")
        refs[precision] = run
    return refs


def quant_phase(card: str, root: pathlib.Path, runs: dict[str, list[dict]],
                refs: dict[str, dict]) -> dict[str, dict]:
    """Phase 20: the gates of :func:`quant_runs`' ``runs`` against the
    single process's ``refs`` (:func:`small_batch_references`). Returns the
    launches per path (rank 0's on the mesh)."""
    steps = MESH_STEPS
    paths = {f"q_single_{k}": v["counts"] for k, v in refs.items()}
    ref_losses = {k: [r["loss"] for r in v["logged"]]
                  for k, v in refs.items()}
    # (a), (b): losses, launches, the fp8 histories and mesh reductions
    for what in ("q_fp8_dp", "q_fp8_tp", "q_int8_tp", "q_int8_pp"):
        ranks = runs[what]
        precision = "fp8_hybrid" if "fp8" in what else "int8_qk"
        logged = [json.loads(line) for line in
                  (root / f"{what}.jsonl").read_text().splitlines()]
        got = _losses_within(what, logged, ref_losses[precision])
        # the backward (the gradient amax over the mesh, the row-parallel
        # dx and dw) shows in step 0's gradients, before any update
        dev, _, key_bias, top = _norms_within(
            what, ranks, refs[precision]["grad_norms"], MESH_GRAD_RTOL["dp"])
        worst = max(dev[0], key=dev[0].get)
        want = quant_step(what)
        for i, r in enumerate(ranks):
            c = r["counts"]
            check(r["rc"] == 0 and all(c[k] == want[k] * steps
                                       for k in want),
                  f"{what}: rank {i}'s launches {c} over {steps} steps, "
                  f"want {want} a step")
        note = ""
        if precision == "fp8_hybrid":
            digests = [[s["digest"] for s in r["amax"]] for r in ranks]
            check(len(digests[0]) == steps and digests[0] == digests[1],
                  f"{what}: the ranks' amax histories differ: {digests}")
            for r in ranks:
                check(r["amax_reductions"] == AMAX_REDUCTIONS_PER_STEP
                      * steps and r["amax_syncs"] == AMAX_SYNCS_PER_STEP
                      * steps, f"{what}: {r['amax_reductions']} gradient-"
                      f"amax reductions and {r['amax_syncs']} syncs over "
                      f"{steps} steps")
            mine = [s["first"] for s in ranks[0]["amax"]]
            single = [s["first"] for s in refs["fp8_hybrid"]["amax"]]
            same = sorted(n for n in single[0] if mine[0].get(n)
                          == single[0][n])
            if what == "q_fp8_dp":
                check(len(same) == len(single[0]) > 0,
                      f"{what}: after step 0 the first blocks' histories "
                      f"{sorted(set(single[0]) - set(same))} differ from "
                      f"the single process's")
            equal_steps = sum(m == w for m, w in zip(mine, single))
            note = (f"; amax histories equal on both ranks at all {steps} "
                    f"steps; after step 0 {len(same)} of the first blocks' "
                    f"{len(single[0])} equal the single process's bit for "
                    f"bit, all of them after {equal_steps} of {steps} "
                    f"steps; {ranks[0]['amax_reductions'] // steps} "
                    f"gradient-amax all-reduces and "
                    f"{ranks[0]['amax_syncs'] // steps} amax sync a rank a "
                    f"step")
        times = [r["step_time_s"] for r in logged[1:]]
        print(f"mesh: {what}: losses {got} (single process "
              f"{ref_losses[precision]}); launches a rank a step {want}; "
              f"median step {statistics.median(times) * 1e3:.1f} ms over "
              f"steps 1-{steps - 1} at batch {QUANT_BATCH} (single process "
              f"{statistics.median(r['step_time_s'] for r in refs[precision]['logged'][1:]) * 1e3:.1f}"
              f"); step 0's {len(dev[0])} gradient norms against the single "
              f"process's: largest relative deviation {dev[0][worst]:.3e} "
              f"({worst}), the key biases' at most {key_bias / top:.3e} of "
              f"the largest norm; peak {[r['peak'] for r in ranks]} "
              f"bytes{note} | {card}",
              flush=True)
        paths[what] = ranks[0]["counts"]
    # (c) the elastic drill: the crash on both ranks, the replan to one
    ranks = runs["q_elastic"]
    for i, r in enumerate(ranks):
        outcomes = [(a["outcome"], a["max_devices"]) for a in r["attempts"]]
        check(r["rc"] == 0 and outcomes == [("failed", 2), ("done", 1)]
              and r["counted"]["jimm_train_restarts_total"] == 1
              and r["counted"]["jimm_train_topology_changes_total"] == 1,
              f"q_elastic: rank {i}: rc {r['rc']}, attempts {outcomes}, "
              f"counted {r['counted']}")
    check(ranks[0]["counted"]["jimm_train_checkpoint_topology_changes_total"]
          == 1 and ranks[0]["spans"]["checkpoint_restore"][0] == 1,
          f"q_elastic: rank 0 counted {ranks[0]['counted']}, restore spans "
          f"{ranks[0]['spans']['checkpoint_restore']}")
    logged = [json.loads(line) for line in
              (root / "q_elastic.jsonl").read_text().splitlines()]
    check([r["step"] for r in logged] == list(range(steps)),
          f"q_elastic logged steps {[r['step'] for r in logged]}")
    got = _losses_within("q_elastic", logged, ref_losses["bf16"])
    restore = ranks[0]["spans"]["checkpoint_restore"][1]
    print(f"mesh: q_elastic: supervise --elastic --shrink-plan 2,1 --adapt:"
          f" attempt walls rank 0 "
          f"{[round(a['wall'], 3) for a in ranks[0]['attempts']]} s, rank "
          f"1 (idle in the second) "
          f"{[round(a['wall'], 3) for a in ranks[1]['attempts']]} s; the "
          f"restore onto data=1 {restore * 1e3:.1f} ms; losses {got} "
          f"(single process {ref_losses['bf16']}); advisor decisions "
          f"{[r['counted']['jimm_train_goodput_advisor_decisions_total'] for r in ranks]}"
          f" | {card}", flush=True)
    # (d) the rank-0 preemption: both ranks save step 2 and resume
    ranks = runs["q_preempt"]
    for i, r in enumerate(ranks):
        a = r["attempts"]
        check(a[0]["step"] == 2 and a[0]["rc"] is None and a[1]["rc"] == 0,
              f"q_preempt: rank {i}'s attempts {a}")
    markers = sorted(int(p.name) for p in
                     (root / "ckpt_preempt" / ".jimm_markers").iterdir())
    check(markers == [0, 2], f"q_preempt: committed steps {markers}")
    logged = [json.loads(line) for line in
              (root / "q_preempt.jsonl").read_text().splitlines()]
    check([r["step"] for r in logged] == list(range(steps)),
          f"q_preempt logged steps {[r['step'] for r in logged]}")
    got = _losses_within("q_preempt", logged, ref_losses["bf16"])
    print(f"mesh: q_preempt: a SIGTERM to rank 0 at step 2 saved step 2 on "
          f"both ranks; attempt walls "
          f"{[[round(a['wall'], 3) for a in r['attempts']] for r in ranks]}"
          f" s; losses {got} (single process {ref_losses['bf16']}) | "
          f"{card}", flush=True)
    # (e) the collectives the phase adds
    c = runs["collectives"]
    print(f"mesh: collectives over {c[0]['backend']}, {COLLECTIVE_CALLS} "
          f"calls, ms a call by rank: preemption agreement "
          f"{[round(r['agree_ms'], 4) for r in c]}, gradient amax (1 f32) "
          f"{[round(r['dy_amax_ms'], 4) for r in c]}, amax sync "
          f"({FP8_LINEARS}x2 f32) {[round(r['amax_sync_ms'], 4) for r in c]}"
          f" | {card}", flush=True)
    return paths


# -- phase 21: serving replicas and health ------------------------------------

#: phase 21's served model: SigLIP-B/16-256 in bf16, the card listed twice
REPLICA_ARGV = ["serve", "--preset", "siglip-base-patch16-256", "--ln-impl",
                "fused", "--device", "cuda:0,cuda:0", "--replicas", "2",
                "--port", "0", "--buckets", "1,8,32", "--max-delay-ms", "10",
                "--timeout-s", "120"]
#: the least share of a run's batches each replica takes (the ratio of the
#: JAX package's ``test_dispatch_spreads_across_replicas``)
REPLICA_MIN_SHARE = 0.3
#: requests sent as the heal's replan begins
DRILL_BURST = 16


class FaultyForward:
    """A replica forward that raises on command: ``fail`` times, or for
    good with ``fail = -1`` (a Python exception: a real sticky CUDA error
    would poison the context the sibling replica shares)."""

    def __init__(self, inner):
        self.inner = inner
        self.fail = 0

    def __call__(self, batch):
        if self.fail:
            self.fail -= self.fail > 0
            raise RuntimeError("injected replica fault")
        return self.inner(batch)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _dispatched(server: ServingServer) -> list[int]:
    return [r["dispatched"] for r in server.engine.replica_stats()]


def _tail_traces(url: str) -> list[str]:
    """``obs tail --traces URL``'s lines from one poll."""
    def stop(_seconds):
        raise KeyboardInterrupt  # how a user ends the poll

    out = io.StringIO()
    # the module's own name for time, not the time module, which other
    # threads share
    with mock.patch("jimm_tpu_torch.obs.cli.time",
                    types.SimpleNamespace(sleep=stop)), \
            contextlib.redirect_stdout(out):
        check(cli.main(["obs", "tail", "--traces", url]) == 0,
              "obs tail --traces failed")
    return out.getvalue().splitlines()


def replicated_serving(card: str) -> tuple[dict, torch.nn.Module]:
    """21(a): ``serve --device cuda:0,cuda:0 --replicas 2 --self-heal
    --dtype bf16`` through ``cli.build_server``, phase 4's traffic sent by
    the stdlib client, in turns with a one-replica server over the same
    model: one, two, two, one. Every two-replica run is gated as phase 4
    (answers, 13 flash and 24 LayerNorm launches per batch summed over
    both replicas) and each replica takes at least REPLICA_MIN_SHARE of its
    batches; then /metrics, /debug/traces and ``obs tail --traces``."""
    t0 = time.perf_counter()
    server, model, ready = cli.build_server(cli.build_parser().parse_args(
        REPLICA_ARGV + ["--dtype", "bf16", "--self-heal"]))
    check(ready["topology"] == {"n_devices": 2, "replicas": 2,
                                "model_parallel": 1, "seq_parallel": 1,
                                "devices_used": 2, "devices_unused": 0},
          f"replicas: ready line {ready}")
    fwds = server.engine.forwards
    check(fwds[0].model is model and fwds[1].model is not model
          and fwds[0].stream != fwds[1].stream,
          "replicas: a model copy and a stream per replica")
    size = model.config.vision.image_size
    one = ServingServer(InferenceEngine(
        image_forward(model), item_shape=(size, size, 3),
        buckets=BucketTable((1, 8, 32)), max_delay_ms=10.0,
        policy=AdmissionPolicy(max_queue=256, default_timeout_s=120.0)),
        port=0, request_timeout_s=300.0)
    one.start()
    print(f"replicas: SigLIP-B/16-256 bf16 on 2 replicas of cuda:0 and on "
          f"one, built and warmed in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(ready)}", flush=True)
    per_batch = {"flash_attention": FLASH_PER_BATCH,
                 "layer_norm": LN_PER_BATCH}
    width = model.config.projection_dim
    runs: dict[str, list[dict]] = {"1": [], "2": []}
    counts = None
    try:
        for n, srv in (("1", one), ("2", server), ("2", server), ("1", one)):
            before = _dispatched(srv)
            traffic = served_traffic(
                srv, model, "encode_image", f"replicas: {n} replica(s)",
                per_batch, width, card,
                client=ServeClient(port=srv.port, timeout_s=300.0),
                keep=True)
            traffic.pop("features"), traffic.pop("batch")
            runs[n].append(traffic)
            if n == "2":
                shares = [(a - b) / traffic["batches"] for a, b in
                          zip(_dispatched(srv), before)]
                check(min(shares) >= REPLICA_MIN_SHARE,
                      f"replicas: batch shares {shares}")
                print(f"replicas: batch shares {shares} of "
                      f"{traffic['batches']} batches", flush=True)
                counts = counts or traffic
        client = ServeClient(port=server.port, timeout_s=300.0)
        text = client.metrics_text()
        series = obs.parse_prometheus_text(text)
        wanted = [f"jimm_serve_replica_{i}_dispatched_total" for i in (0, 1)]
        wanted += [f"jimm_serve_span_{p}_{q}_ms"
                   for p in ("queue", "pad", "device", "readback")
                   for q in ("p50", "p99")]
        check(all(k in series for k in wanted),
              f"replicas: /metrics lacks {set(wanted) - set(series)}")
        print("replicas: /metrics "
              + ", ".join(f"{k.removeprefix('jimm_serve_')} {series[k]}"
                          for k in wanted) + f" | {card}", flush=True)
        traces = client._request("GET", "/debug/traces")["traces"]
        check({r["replica"] for r in traces} == {0, 1},
              "replicas: /debug/traces names one replica")
        lines = _tail_traces(f"http://127.0.0.1:{server.port}")
        check(any(" replica=0 " in ln for ln in lines)
              and any(" replica=1 " in ln for ln in lines),
              f"replicas: obs tail --traces printed {lines[:2]}")
        health = client.healthz()
        check(health["status"] == "ok" and len(health["replicas"]) == 2,
              f"replicas: healthz {health}")
    finally:
        one.stop()
        server.stop()
    for n in ("1", "2"):
        print(f"replicas: {n} replica(s): images/s "
              + ", ".join(f"{r['images_per_s']:.1f}" for r in runs[n])
              + "; p50 " + ", ".join(f"{r['p50_ms']:.2f}" for r in runs[n])
              + " ms; p99 " + ", ".join(f"{r['p99_ms']:.2f}" for r in runs[n])
              + f" ms (turns 1, 2, 2, 1) | {card}", flush=True)
    return counts, model


def replica_drills(card: str, model) -> None:
    """21(b): the library path over phase 21(a)'s model, the card listed
    twice, replica 1's forward wrapped to fail on command. Two failures
    restart, then fence it (healthz degraded); ``POST /admin/revive``
    un-fences it; then a lasting fault: the heal probe fails, the factory
    rebuilds the replica set and the replan brings back two live lanes;
    the requests sent as the replan begins are answered (phase 4's gate
    against the plain versions). The journal chains the heal's events on
    one cid; prints the heal and replan seconds."""
    journal = obs.configure_journal(None)
    cuda0 = torch.device("cuda", 0)
    plan = plan_topology(2, devices=[cuda0, cuda0])
    forwards = build_replica_forwards(model, plan, method="encode_image")
    faulty = FaultyForward(forwards[1])
    size = model.config.vision.image_size
    engine = InferenceEngine(
        [forwards[0], faulty], item_shape=(size, size, 3),
        buckets=BucketTable((1, 8, 32)), max_delay_ms=10.0,
        policy=AdmissionPolicy(max_queue=256, default_timeout_s=120.0))
    server = ServingServer(engine, port=0, request_timeout_s=300.0)
    server.start()
    client = ServeClient(port=server.port, timeout_s=300.0)
    images = np.random.default_rng(21).uniform(
        -1, 1, (DRILL_BURST + 1, size, size, 3)).astype(np.float32)

    def embed_status(image) -> int:
        try:
            client.embed(image)
        except ServeClientError as e:
            return e.status
        return 200

    try:
        faulty.fail = 2
        statuses = sorted(embed_status(images[0]) for _ in range(4))
        health = client.healthz()
        check(statuses == [200, 200, 500, 500]
              and health["status"] == "degraded"
              and health["dead_replicas"] == [1]
              and health["replicas"][1]["restarts"] == 1,
              f"drills: statuses {statuses}, healthz {health}")
        revived = client._request("POST", "/admin/revive", {"replica": 1})
        check(revived["dead_replicas"] == []
              and client.healthz()["status"] == "ok",
              f"drills: revive {revived}")
        print("drills: 2 injected faults restarted then fenced replica 1 "
              "(healthz degraded); POST /admin/revive un-fenced it",
              flush=True)
        sent = []

        def rebuild():
            built = build_replica_forwards(model, plan,
                                           method="encode_image")
            sent.append(pool.submit(client.embed_many, images[1:]))
            return built

        engine.set_heal(rebuild)
        faulty.fail = -1
        with ThreadPoolExecutor(1) as pool:
            for _ in range(8):
                embed_status(images[0])
                if engine.metrics.count("replans_total"):
                    break
            end = time.monotonic() + 120
            while engine.metrics.count("replans_total") < 1:
                check(time.monotonic() < end, "drills: no replan in 120 s")
                time.sleep(0.05)
            answers = np.asarray(sent[0].result(timeout=300), np.float32)
        health = client.healthz()
        check(health["status"] == "ok" and health["replans"] == 1
              and engine.n_replicas == 2 and faulty not in engine.forwards,
              f"drills: after the heal, healthz {health}")
        before = _dispatched(server)
        with ThreadPoolExecutor(8) as burst:
            list(burst.map(client.embed, images))
        check(all(a > b for a, b in zip(_dispatched(server), before)),
              "drills: a replica idle after the replan")
        snap = engine.metrics.snapshot()
    finally:
        server.stop()
    ref = encode_all(model, torch.from_numpy(images[1:]).to(
        "cuda", next(model.parameters()).dtype), plain=True)
    cos, _ = served_gate(answers, ref, "drills: answers sent during the heal")
    events = journal.events()
    fenced = [e["cid"] for e in events if e["event"] == "replica_fenced"]
    incident = [e["event"] for e in obs.chain(events, fenced[-1])]
    check(len(fenced) == 2 and incident == [
        "replica_fault", "replica_fenced", "heal_probe", "heal_rebuilt",
        "replan_started", "replan_done"], f"drills: journal {incident}")
    durations = {e["event"]: e["dur_s"] for e in obs.chain(events, fenced[-1])
                 if "dur_s" in e}
    print(f"drills: lasting fault healed: {' -> '.join(incident)} on one "
          f"cid; {DRILL_BURST} requests sent as the replan began answered "
          f"(min cosine {cos.min():.6f}); heal (probe + rebuild) "
          f"{durations['heal_rebuilt']:.3f} s, replan (warm + drain + swap) "
          f"{durations['replan_done']:.3f} s; goodput_heal_seconds_total "
          f"{snap['goodput_heal_seconds_total']:.3f}, "
          f"goodput_replan_seconds_total "
          f"{snap['goodput_replan_seconds_total']:.3f} | {card}", flush=True)


def int8_replicas(card: str) -> dict:
    """21(c): ``serve --dtype int8 --replicas 2`` on the card listed twice,
    phase 4's traffic by the client: 78 int8-matmul, 13 flash and 24
    LayerNorm launches per batch summed over both replicas, each replica
    dispatching, the answers against the quantized model's plain versions
    and, cosine >= 0.999, against the f32 twin."""
    server, model, ready = cli.build_server(cli.build_parser().parse_args(
        REPLICA_ARGV + ["--dtype", "int8"]))
    check(ready["quantized_layers"] == INT8_QUANTIZED
          and ready["topology"]["replicas"] == 2,
          f"int8 replicas: ready line {ready}")
    traffic = served_traffic(
        server, model, "encode_image", "int8 replicas",
        {"int8_matmul": INT8_MATMUL_PER_BATCH,
         "flash_attention": FLASH_PER_BATCH, "layer_norm": LN_PER_BATCH},
        model.config.projection_dim, card,
        client=ServeClient(port=server.port, timeout_s=300.0), keep=True)
    dispatched = _dispatched(server)
    server.stop()
    check(min(dispatched) >= 1, f"int8 replicas: dispatched {dispatched}")
    features, batch = traffic.pop("features"), traffic.pop("batch")
    cfg = configs.with_runtime(configs.preset("siglip-base-patch16-256"),
                               ln_impl="fused")
    twin, _ = cli.serving_model(cfg, "f32", "cuda")
    full = encode_all(twin, batch)
    del twin
    cos = (features * full).sum(1) / (np.linalg.norm(features, axis=1)
                                      * np.linalg.norm(full, axis=1))
    check(bool((cos >= SERVE_MIN_COS).all()),
          f"int8 replicas: cosine against f32 {cos.min()}")
    print(f"int8 replicas: batches {dispatched} by replica; cosine against "
          f"the f32 twin min {cos.min():.6f} | {card}", flush=True)
    return traffic


def replicas_phase(card: str) -> dict[str, dict]:
    """Phase 21: (a) replicated serving, (b) the drills, (c) int8
    replicas; the record's ``replicas`` and ``replicas_int8`` paths."""
    counts, model = replicated_serving(card)
    replica_drills(card, model)
    del model
    return {"replicas": counts, "replicas_int8": int8_replicas(card)}


# -- phase 22: replicas wider than one device, tenant QoS and the pool -------

#: phase 22's served model: SigLIP-B/16-256 in bf16, the card listed four
#: times (one entry a device of the plan)
WIDE_ARGV = ["serve", "--preset", "siglip-base-patch16-256", "--ln-impl",
             "fused", "--dtype", "bf16", "--device",
             "cuda:0,cuda:0,cuda:0,cuda:0", "--port", "0", "--buckets",
             "1,8,32", "--max-delay-ms", "10", "--timeout-s", "120"]
#: each (replicas, model, seq) plan's launches a served batch, summed over
#: the replica's positions (PERF.md §6's kernel table): under ``model``
#: every position runs the 12 blocks and the MAP probe on 6 of 12 heads and
#: every LayerNorm; under ``seq`` each block's attention is two ring hops on
#: a position's 128 of 256 tokens, the probe once on the gathered tokens
WIDE_PLANS = {(1, 2, 1): {"flash_attention": 26, "layer_norm": 48},
              (1, 1, 2): {"flash_attention": 50, "layer_norm": 48},
              (1, 2, 2): {"flash_attention": 100, "layer_norm": 96}}
#: phase 22(b)'s policy: two classes, an unlimited interactive tenant and
#: a rate-limited batch one
QOS_POLICY = {"classes": {"interactive": {"weight": 8},
                          "batch": {"weight": 2}},
              "tenants": {"vip": {"class": "interactive"},
                          "bulk": {"class": "batch", "rate": 2, "burst": 4}},
              "default": {"class": "batch"},
              "slo": {"vip": {"availability": 0.99, "latency_ms": 5000}}}


def _cosines(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                  * np.linalg.norm(want, axis=1))


def wide_serving(card: str) -> dict[str, dict]:
    """22(a): ``serve --device cuda:0,cuda:0,cuda:0,cuda:0 --model-parallel
    k --seq-parallel s`` through ``cli.build_server`` at (1, 2, 1), (1, 1,
    2) and (1, 2, 2), phase 4's traffic by the stdlib client: phase 4's
    gates against the plain-version forward, WIDE_PLANS' launches a batch
    summed over the positions, every answer at cosine >= SERVE_MIN_COS
    against the single-device model's kernels on the same weights; a copy
    and a stream per position. Returns each plan's counts (``wide_RKS``)."""
    out: dict[str, dict] = {}
    single = None
    for (r, k, s), per_batch in WIDE_PLANS.items():
        t0 = time.perf_counter()
        server, model, ready = cli.build_server(cli.build_parser().parse_args(
            WIDE_ARGV + ["--replicas", str(r), "--model-parallel", str(k),
                         "--seq-parallel", str(s)]))
        label = f"wide {r}x{k}x{s}"
        try:
            fwd, = server.engine.forwards
            check(ready["topology"]["model_parallel"] == k
                  and ready["topology"]["seq_parallel"] == s
                  and len(fwd.models) == k * s
                  and len({id(st) for st in fwd.streams}) == k * s
                  and all(d == torch.device("cuda", 0) for d in fwd.devices),
                  f"{label}: ready line {ready}")
            print(f"{label}: SigLIP-B/16-256 bf16, {k * s} positions on "
                  f"cuda:0 (a copy, a stream and a thread each), built and "
                  f"warmed in {time.perf_counter() - t0:.1f} s", flush=True)
            traffic = served_traffic(
                server, model, "encode_image", label, per_batch,
                model.config.projection_dim, card,
                client=ServeClient(port=server.port, timeout_s=300.0),
                keep=True)
        finally:
            server.stop()
        features, batch = traffic.pop("features"), traffic.pop("batch")
        if single is None:
            single = encode_all(model, batch)
        cos = _cosines(features, single)
        check(bool((cos >= SERVE_MIN_COS).all()),
              f"{label}: cosine against one device {cos.min()}")
        print(f"{label}: against the single-device model's kernels min "
              f"cosine {cos.min():.6f} | {card}", flush=True)
        out[f"wide_{r}{k}{s}"] = traffic
        del server, model, fwd
    return out


def wide_heal_drill(card: str) -> None:
    """22(a), the drill: two (1, 2, 1)-wide replicas on the card listed four
    times; position 1 of replica 1 fails for good (a forward pre-hook that
    raises). The call raises at once (its peer's collective aborts), the
    watchdog restarts then fences the lane (healthz degraded), the probe
    fails, the heal factory rebuilds both replicas over the same plan and
    the replan serves on them: the requests sent meanwhile are answered
    (phase 4's gate), both lanes dispatch after, the journal chains the
    incident on one cid."""
    journal = obs.configure_journal(None)
    cfg = configs.with_runtime(configs.preset("siglip-base-patch16-256"),
                               ln_impl="fused")
    model, _ = cli.serving_model(cfg, "bf16", "cuda")
    cuda0 = torch.device("cuda", 0)
    plan = plan_topology(2, 2, 1, devices=[cuda0] * 4)
    forwards = build_replica_forwards(model, plan, method="encode_image",
                                      timeout_s=60.0)

    def fault(module, args):
        raise RuntimeError("injected position fault")

    size = cfg.vision.image_size
    engine = InferenceEngine(
        forwards, item_shape=(size, size, 3),
        buckets=BucketTable((1, 8, 32)), max_delay_ms=10.0,
        policy=AdmissionPolicy(max_queue=256, default_timeout_s=120.0))
    engine.set_heal(lambda: build_replica_forwards(
        model, plan, method="encode_image", timeout_s=60.0))
    images = np.random.default_rng(22).uniform(
        -1, 1, (DRILL_BURST + 1, size, size, 3)).astype(np.float32)
    server = ServingServer(engine, port=0, request_timeout_s=300.0)
    server.start()
    client = ServeClient(port=server.port, timeout_s=300.0)
    statuses = []
    try:
        # the fault from here on: the warm-up ran every bucket on both lanes
        forwards[1].models[1].vision.encoder.blocks[0] \
            .register_forward_pre_hook(fault)
        t0 = time.perf_counter()
        try:
            forwards[1](images[:1])
        except RuntimeError as e:
            raised_s = time.perf_counter() - t0
            check("injected position fault" in str(e),
                  f"drill: raised {e!r}")
        else:
            check(False, "drill: the failing position's call did not raise")
        end = time.monotonic() + 120
        while engine.metrics.count("replans_total") < 1:
            check(time.monotonic() < end, "drill: no replan in 120 s")
            try:
                client.embed(images[0])
                statuses.append(200)
            except ServeClientError as e:
                statuses.append(e.status)
        answers = np.asarray(client.embed_many(images[1:]), np.float32)
        health = client.healthz()
        check(health["status"] == "ok" and health["replans"] == 1
              and forwards[1] not in engine.forwards,
              f"drill: after the heal, healthz {health}")
        before = _dispatched(server)
        with ThreadPoolExecutor(8) as burst:
            list(burst.map(client.embed, images))
        check(all(a > b for a, b in zip(_dispatched(server), before)),
              "drill: a replica idle after the replan")
    finally:
        server.stop()
    ref = encode_all(model, torch.from_numpy(images[1:]).to(
        "cuda", torch.bfloat16), plain=True)
    cos, _ = served_gate(answers, ref, "drill: answers after the heal")
    events = journal.events()
    fenced = [e["cid"] for e in events if e["event"] == "replica_fenced"]
    check(len(fenced) == 1, f"drill: {len(fenced)} fences")
    incident = [e["event"] for e in obs.chain(events, fenced[0])]
    check(incident == ["replica_fault", "replica_fenced", "heal_probe",
                       "heal_rebuilt", "replan_started", "replan_done"],
          f"drill: journal {incident}")
    durations = {e["event"]: e["dur_s"] for e in obs.chain(events, fenced[0])
                 if "dur_s" in e}
    print(f"drill: position 1 of replica 1 failing raised in "
          f"{raised_s * 1e3:.1f} ms; statuses "
          f"{ {c: statuses.count(c) for c in sorted(set(statuses))} } "
          f"until the replan; "
          f"{' -> '.join(incident)} on one cid; heal (probe + rebuild of "
          f"both wide replicas) {durations['heal_rebuilt']:.3f} s, replan "
          f"(warm 3 buckets on 2 lanes, drain, swap) "
          f"{durations['replan_done']:.3f} s; {DRILL_BURST} answers after "
          f"it min cosine {cos.min():.6f} | {card}", flush=True)


def qos_pool(card: str, root: pathlib.Path) -> dict:
    """22(b): ``serve --qos-policy P --pool-model
    twin=siglip-base-patch16-256@int8`` (bf16 default, one card): the
    rate-limited tenant alone gets 429 with Retry-After; the twin answers
    through row 11 (INT8_MATMUL_PER_BATCH launches a batch, no batch on
    the default engine meanwhile) at cosine >= SERVE_MIN_COS against the
    f32 model of the same weights; /metrics carries the tenant, class and
    model series. Returns the twin's counts (``pool_twin``)."""
    policy = root / "qos.json"
    policy.write_text(json.dumps(QOS_POLICY))
    t0 = time.perf_counter()
    server, model, ready = cli.build_server(cli.build_parser().parse_args(
        ["serve", "--preset", "siglip-base-patch16-256", "--ln-impl",
         "fused", "--dtype", "bf16", "--device", "cuda:0", "--port", "0",
         "--buckets", "1,8,32", "--max-delay-ms", "10", "--timeout-s", "120",
         "--qos-policy", str(policy), "--pool-model",
         "twin=siglip-base-patch16-256@int8"]))
    try:
        check(ready["qos"]["tenants"] == ["bulk", "vip"]
              and ready["models"]["twin"]["dtype"] == "int8",
              f"qos: ready line {ready}")
        print(f"qos: bf16 default and int8 twin built and warmed in "
              f"{time.perf_counter() - t0:.1f} s: qos {ready['qos']}",
              flush=True)
        size = model.config.vision.image_size
        images = np.random.default_rng(23).uniform(
            -1, 1, (48, size, size, 3)).astype(np.float32)

        def send(tenant: str, image, model_name=None):
            c = ServeClient(port=server.port, tenant=tenant,
                            model=model_name, timeout_s=300.0)
            try:
                c.embed(image)
            except ServeClientError as e:
                return e.status, getattr(e, "retry_after_s", None)
            return 200, None

        with ThreadPoolExecutor(8) as pool:
            bulk = list(pool.map(lambda im: send("bulk", im), images[:12]))
            vip = list(pool.map(lambda im: send("vip", im), images[:12]))
        throttled = [r for s, r in bulk if s == 429]
        check(len(throttled) >= 4 and all(r is not None and r > 0
                                          for r in throttled)
              and all(s in (200, 429) for s, _ in bulk)
              and all(s == 200 for s, _ in vip),
              f"qos: bulk {bulk}, vip {vip}")
        print(f"qos: 12 requests each at once: bulk (rate 2/s, burst 4) "
              f"{sum(s == 200 for s, _ in bulk)} answered, {len(throttled)} "
              f"429 (Retry-After {min(throttled):.3f}-{max(throttled):.3f} "
              f"s); vip 12 answered", flush=True)
        twin_client = ServeClient(port=server.port, tenant="vip",
                                  model="twin", timeout_s=300.0)
        batches_before = server.metrics.count("batches_total")
        zero_counts()
        with ThreadPoolExecutor(8) as pool:
            singles = list(pool.map(twin_client.embed, images[:16]))
        bulk_out = twin_client.embed_many(images[16:])
        counts = read_counts()
        batches = int(server.metrics.count("batches_total") - batches_before)
        per_batch = {"int8_matmul": INT8_MATMUL_PER_BATCH,
                     "flash_attention": FLASH_PER_BATCH,
                     "layer_norm": LN_PER_BATCH}
        check(batches > 0 and all(counts[k] == n * batches
                                  for k, n in per_batch.items())
              and sum(n for k, n in counts.items()
                      if k not in per_batch) == 0,
              f"qos: the twin's launches over {batches} batches: {counts}")
        features = np.asarray(list(singles) + list(bulk_out), np.float32)
        text = ServeClient(port=server.port).metrics_text()
        series = obs.parse_prometheus_text(text)
        check(series.get("jimm_serve_tenant_bulk_throttled_total", 0)
              == len(throttled)
              and series.get("jimm_serve_tenant_vip_throttled_total") == 0
              # 16 singles and one bulk request
              and series.get("jimm_serve_model_twin_requests_total") == 17
              and "jimm_serve_class_interactive_dispatched_total" in series
              and "jimm_serve_class_batch_requests_total" in series,
              "qos: /metrics lacks the QoS series")
        health = ServeClient(port=server.port).healthz()
        check(sorted(health["models"]) == ["default", "twin"]
              and health["qos"]["tenants"]["bulk"]["throttled"]
              == len(throttled), f"qos: healthz {health.get('qos')}")
    finally:
        server.stop()
    del model
    cfg = configs.with_runtime(configs.preset("siglip-base-patch16-256"),
                               ln_impl="fused")
    full, _ = cli.serving_model(cfg, "f32", "cuda")
    want = encode_all(full, torch.from_numpy(images[:48]).to("cuda"))
    del full
    cos = _cosines(features, want)
    check(bool((cos >= SERVE_MIN_COS).all()),
          f"qos: the twin's cosine against f32 {cos.min()}")
    print(f"qos: the int8 twin by X-Jimm-Model: {batches} batches, "
          + ", ".join(f"{k} {counts[k]} = {n}/batch"
                      for k, n in per_batch.items())
          + f"; cosine against the f32 model min {cos.min():.6f}; /metrics "
          f"tenant_bulk_throttled_total "
          f"{series['jimm_serve_tenant_bulk_throttled_total']}, "
          f"model_twin_requests_total "
          f"{series['jimm_serve_model_twin_requests_total']} | {card}",
          flush=True)
    return dict(counts, batches=batches)


def wide_qos_phase(card: str) -> dict[str, dict]:
    """Phase 22: (a) wide replicas and their heal drill, (b) tenant QoS
    and the int8 pool twin; the record's ``wide_*`` and ``pool_twin``
    paths."""
    t0 = time.perf_counter()
    counts = wide_serving(card)
    wide_heal_drill(card)
    print(f"phase 22(a) {time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        counts["pool_twin"] = qos_pool(card, pathlib.Path(tmp))
    return counts


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
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        print(f"phase: {phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    try:
        built = _build.library_path().exists()
        _build.load()
        print(f"build: {_build.library_path().name} (nvcc, sm_90a) "
              f"{'found' if built else 'built'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        tensor_core_phase(card)
        timed = kernel_phase(card)
        done("kernels")
        serve_counts = serve_phase(card)
        done("serve")
        train_grads_phase(card)
        train_grads_phase(card, torch.bfloat16)
        _, ln_bwd_traced = train_phase(card)
        # step 0's gradient norms: phase 18's reference
        with first_grad_norms() as norms:
            train_run = cli_train_phase(card)
        train_run["grad_norms"] = norms
        train_counts = train_run["counts"]
        done("train")
        naflex_grads_phase(card)
        naflex_grads_phase(card, torch.bfloat16)
        naflex_forward_phase(card)
        naflex_train_phase(card)
        naflex_counts = cli_train_phase(card, naflex=True)["counts"]
        done("naflex")
        int8_serve_counts = serve_phase(card, "int8")
        done("int8 serve")
        int8_qk_grads_phase(card)
        int8_qk_grads_phase(card, torch.bfloat16)
        train_phase(card, precision="int8_qk")
        int8_qk_counts = cli_train_phase(card,
                                         precision="int8_qk")["counts"]
        done("int8_qk")
        fp8_grads_phase(card)
        train_phase(card, precision="fp8_hybrid")
        fp8_counts = cli_train_phase(card,
                                     precision="fp8_hybrid")["counts"]
        done("fp8_hybrid")
        sigmoid_grads_phase(card)
        sigmoid_grads_phase(card, torch.bfloat16)
        sigmoid_counts, _ = train_phase(card, attn_impl="sigmoid")
        done("sigmoid")
        bias_grads_phase(card)
        bias_counts = bias_train_phase(card)
        bias_routing_phase(card)
        done("bias")
        # phase 12's checkpoints stay until phase 17 quantizes one
        with tempfile.TemporaryDirectory() as ckpt_tmp:
            ckpt_counts, ckpts = checkpoint_phase(card,
                                                  pathlib.Path(ckpt_tmp))
            done("checkpoints")
            zero_shot_counts = zero_shot_phase(card, ckpts,
                                               pathlib.Path(ckpt_tmp))
            done("zero-shot")
            rest_counts = remat_phase(card)
            rest_counts["dropout"] = dropout_phase(card)
            rest_counts.update(train_rest_commands(card, ckpts["vit"]))
            done("training, rest")
            with tempfile.TemporaryDirectory() as tmp:
                resilience_counts = resilience_phase(card, pathlib.Path(tmp))
                done("resilience")
            with tempfile.TemporaryDirectory() as tmp:
                data_counts = data_phase(card, pathlib.Path(tmp), train_run)
                done("data")
            with tempfile.TemporaryDirectory() as tmp:
                profile_counts = profile_phase(card, pathlib.Path(tmp),
                                               train_run, ckpts["siglip"])
                done("profiling")
        with tempfile.TemporaryDirectory() as tmp:
            # phases 18 and 19's two-rank runs in one launch
            root = pathlib.Path(tmp)
            runs = ranks_run(card, "mesh", root, parallel_runs(root)
                             + model_stage_runs(root) + quant_runs(root))
            small = small_batch_references(card)
            mesh_counts = parallel_phase(card, root, train_run, runs,
                                         small["bf16"])
            done("parallel")
            axes_counts = model_stage_phase(card, root, train_run, runs,
                                            small["bf16"])
            done("model and stage axes")
            quant_counts = quant_phase(card, root, runs, small)
            done("quantized mesh and drills")
        replica_counts = replicas_phase(card)
        done("serving replicas")
        wide_counts = wide_qos_phase(card)
        done("wide replicas and QoS")
        check(all(math.isfinite(timed[k]["ms"]) for k in timed), "bad timing")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    # each kernel's launches come from the run of its main path: the train
    # command of SigLIP-B/16-256 for the unmasked kernels, of
    # SigLIP2-B/16-256 on NaFlex batches for the masked ones, of
    # SigLIP-B/16-256 under --precision int8_qk for the int8 flash kernels
    # and under --precision fp8_hybrid for the fp8 GEMM, the int8 server's
    # traffic for the int8 matmul, phase 10(b)'s timed steps of the
    # sigmoid-attention SigLIP for the sigmoid kernels, and phase 11(b)'s
    # 12 biased calls for the bias kernels; launches_by_path also holds
    # phase 17's profiled steps ("profile") and served capture's traffic
    # ("profile_serve"), phase 18's mesh runs and phase 19's runs under the
    # model and stage axes and phase 20's (rank 0's launches), and phase
    # 21's first two-replica run ("replicas") and int8 replicas' traffic
    # ("replicas_int8"), summed over both replicas, and phase 22's wide
    # replicas ("wide_121", "wide_112", "wide_122", summed over each
    # replica's positions) and the int8 pool twin's traffic ("pool_twin")
    paths = {"serve": serve_counts, "train": train_counts,
             "naflex": naflex_counts, "int8_serve": int8_serve_counts,
             "int8_qk": int8_qk_counts, "fp8_hybrid": fp8_counts,
             "sigmoid": sigmoid_counts, "bias": bias_counts,
             **ckpt_counts, **zero_shot_counts, **rest_counts,
             "resilience": resilience_counts, "data": data_counts,
             **profile_counts, **mesh_counts, **axes_counts, **quant_counts,
             **replica_counts, **wide_counts}
    steps = {"train": CLI_STEPS, "naflex": CLI_STEPS, "int8_qk": CLI_STEPS,
             "fp8_hybrid": CLI_STEPS, "sigmoid": TRAIN_STEPS}
    main_path = {"flash_attention_masked": "naflex",
                 "flash_attention_masked_bwd": "naflex",
                 "flash_attention_int8": "int8_qk",
                 "flash_attention_int8_bwd": "int8_qk",
                 "int8_matmul": "int8_serve", "fp8_matmul": "fp8_hybrid",
                 "fp8_matmul_bwd": "fp8_hybrid",
                 "sigmoid_attention": "sigmoid",
                 "sigmoid_attention_bwd": "sigmoid",
                 "flash_attention_bias": "bias",
                 "flash_attention_bias_bwd": "bias",
                 "flash_attention_dbias": "bias"}
    sources = {
        "layer_norm": ("jimm_tpu_torch/csrc/layer_norm.cu",
                       "jimm_tpu/ops/layer_norm.py:52"),
        "layer_norm_bwd": ("jimm_tpu_torch/csrc/layer_norm_bwd.cu",
                           "jimm_tpu/ops/layer_norm.py:76"),
        "flash_attention": ("jimm_tpu_torch/csrc/flash_attention.cu",
                            "jimm_tpu/ops/flash_attention.py:136"),
        "flash_attention_bwd": ("jimm_tpu_torch/csrc/flash_attention_bwd.cu",
                                "jimm_tpu/ops/flash_attention.py:241,293"),
        # the has_mask kind of the same TPU kernels
        "flash_attention_masked": ("jimm_tpu_torch/csrc/flash_attention.cu",
                                   "jimm_tpu/ops/flash_attention.py:136"),
        "flash_attention_masked_bwd": (
            "jimm_tpu_torch/csrc/flash_attention_bwd.cu",
            "jimm_tpu/ops/flash_attention.py:241,293"),
        "flash_attention_int8": ("jimm_tpu_torch/csrc/flash_attention_int8.cu",
                                 "jimm_tpu/ops/flash_attention_int8.py:143"),
        "flash_attention_int8_bwd": (
            "jimm_tpu_torch/csrc/flash_attention_int8_bwd.cu",
            "jimm_tpu/ops/flash_attention_int8.py:203,242"),
        "int8_matmul": ("jimm_tpu_torch/csrc/int8_matmul.cu",
                        "jimm_tpu/ops/int8_matmul.py:91"),
        # e4m3 x e4m3 forward, e5m2 x e4m3 dx and dw: one TPU kernel
        "fp8_matmul": ("jimm_tpu_torch/csrc/fp8_matmul.cu",
                       "jimm_tpu/ops/fp8_matmul.py:89"),
        "fp8_matmul_bwd": ("jimm_tpu_torch/csrc/fp8_matmul.cu",
                           "jimm_tpu/ops/fp8_matmul.py:89"),
        # the sigmoid kind of the flash kernels
        "sigmoid_attention": ("jimm_tpu_torch/csrc/flash_attention.cu",
                              "jimm_tpu/ops/flash_attention.py:136"),
        "sigmoid_attention_bwd": (
            "jimm_tpu_torch/csrc/flash_attention_bwd.cu",
            "jimm_tpu/ops/flash_attention.py:241,293"),
        # the has_bias kind of the flash kernels, and the dbias kernel
        "flash_attention_bias": ("jimm_tpu_torch/csrc/flash_attention.cu",
                                 "jimm_tpu/ops/flash_attention.py:136"),
        "flash_attention_bias_bwd": (
            "jimm_tpu_torch/csrc/flash_attention_bwd.cu",
            "jimm_tpu/ops/flash_attention.py:241,293"),
        "flash_attention_dbias": (
            "jimm_tpu_torch/csrc/flash_attention_dbias.cu",
            "jimm_tpu/ops/flash_attention.py:358")}
    record = []
    for kernel, (source, replaces) in sources.items():
        c = timed[kernel]
        path = main_path.get(kernel, "train")
        entry = {"name": kernel, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": paths[path][kernel],
                 "main_path": path,
                 "launches_by_path": {p: n[kernel] for p, n in paths.items()},
                 "served_batches": {p: paths[p]["batches"]
                                    for p in ("serve", "int8_serve")},
                 "train_steps": steps.get(path),
                 "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                 "call_ms": c["call_ms"], "plain_ms": c["plain_ms"],
                 "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                 "library_ms": c["library_ms"], "shape": c["shape"],
                 "dtype": c["dtype"]}
        if kernel == "layer_norm_bwd":
            # both bodies: the kernel each launches, its launches in a
            # traced step of the train path, its first phase-3 case
            entry["bodies"] = {kind: {
                "kernel": name, "traced_step_launches": ln_bwd_traced[kind],
                **{k: timed[f"{kernel}:{kind}"][k] for k in (
                    "shape", "dtype", "max_abs_err", "ms", "call_ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms")}}
                for kind, name in ln.BACKWARD_KERNELS.items()}
        record.append(entry)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase_alone(phase: str) -> int:
    """``python3 chip_smoke.py --phase 20|21|22``: the build, then that
    phase alone (20: its two-rank launch, the batch-32 single-process
    references and its gates; 21: serving replicas and health; 22: wide
    replicas, tenant QoS and the pool); for iterating on one path. Prints
    no record."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load()
    print(f"build done at {time.perf_counter() - t0:.1f} s", flush=True)
    try:
        if phase == "21":
            replicas_phase(card)
        elif phase == "22":
            wide_qos_phase(card)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                root = pathlib.Path(tmp)
                runs = ranks_run(card, "mesh", root, quant_runs(root))
                print(f"launch done at {time.perf_counter() - t0:.1f} s",
                      flush=True)
                quant_phase(card, root, runs, small_batch_references(card))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"phase {phase} done at {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-task"]:
        sys.exit(rank_main(sys.argv[1:]))
    if sys.argv[1:2] == ["--phase"] and sys.argv[2:] in (["20"], ["21"],
                                                         ["22"]):
        sys.exit(phase_alone(sys.argv[2]))
    sys.exit(main())
