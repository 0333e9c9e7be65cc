"""Drive the PyTorch port on one NVIDIA GPU: build its kernels, hold each
against its plain PyTorch version, serve GPT-2 124M in int8, fp32 and
bf16, train it at full width in fp32 and bf16 (``--amp``) and on two
ranks, train ResNet-18 at full width on one rank and data-parallel on
two ranks that share the card, through the explicit reducer and through
the reference's own command (fp32 and ``--amp``), stop, resume, restart
and serve those runs from their checkpoints, and train both models
through the sharded update (ZeRO-1, explicit FSDP) and ResNet-18 on four
ranks through the two-tier ``int8_hier`` wire, and profile the GPT-2
``--amp`` step and the reference's command on the card through
``--profile-dir`` and the live ``/metrics`` endpoint's ``POST /profile``,
and serve GPT-2 124M continuously over the paged (fp32 and int8) KV pool:
the bench rows, speculative decoding, prefix skips, two replicas behind
the router with one killed, and a ``serve`` process, and train BERT-base
(masked LM, bidirectional flash kernels at S 512, ``--remat``, its int8
gradient wire on two ranks, profiled) and ViT-B/16 at full width, and
train GPT-2 124M sequence-parallel on two ranks (ring and Ulysses
attention over the mesh's ``seq`` axis), and tensor-parallel on two and
four ranks (megatron blocks over the mesh's ``model`` axis, and TP x
FSDP on the int8 wire), and as a GPipe pipeline on two ranks (the mesh's
``pipe`` axis), and train the MoE GPT-2 (``gpt2_moe``) on one rank and
expert-parallel on two (the mesh's ``expert`` axis), and serve ResNet-18
and ViT-B/16 (the engine's image batch) and BERT-base (its token batch)
in fp32 and int8, and train BERT-base and ViT-B/16 tensor-parallel on
two ranks.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is swallowed):

1. print the card's name and power limit (nvidia-smi); TF32 off; cuDNN
   deterministic (CUDNN_DETERMINISTIC);
2. build every CUDA kernel from csrc/ with nvcc for sm_90a, one nvcc per
   source, all started together, and log ptxas's registers and spills of
   each flash kernel from the build's log; a spill of any flash kernel
   (all wgmma kernels: flash_attention_sm90.cu in bf16,
   flash_attention_sm90_tf32.cu in float32) at D 64 fails;
3. hold the int8 row quantizer against its plain version on the card,
   BITWISE (codes and scale bits), at the serving path's shapes and at
   edge shapes, timing both beside the memory bound;
4. serve through the port's own entry (``serving smoke --model gpt2_124m
   --serve-dtype int8`` at the CLI defaults: 3 prompts, 8 new tokens
   each), with the launch counts set to 0 just before and read just
   after: the quantizer must have launched once per int8 leaf, 50 times;
   then build the same int8 engine on the CPU (same seed, same weights,
   the plain quantizer): every served leaf's codes and scales must be
   BITWISE equal to the card's, and the prefill logits within ATOL;
5. serve the same model in fp32 on the card and on the CPU and compare
   the prefill logits within ATOL;
6. hold the flash-attention kernels (forward, dK/dV, dQ) against their
   plain versions at the training path's shape and at edge shapes, each
   in fp32 and bf16 (and in both what the wgmma kernels' TMA loads
   zero-fill: D 32 and 96, ragged tails, all-masked rows straddling a
   tile), within FLASH_REL, timing each beside its bound
   (float32 products at a third of the TF32 tensor-core rate: the float32
   kernels run them as three TF32 products; bf16 at the bf16 rate) and
   beside torch's scaled_dot_product_attention; the forward is logged as
   its ratio to that call's forward (``fwd_over_sdpa_fwd``), the backward
   pair (dK/dV + dQ) as one ratio to its backward, which computes both at
   once;
7. train through the port's own entry (``train.main``: GPT-2 124M at full
   width, seq 1024, flash attention, AdamW, 2 epochs of 8 steps on 64
   synthetic sequences, batch 8), with the launch counts set to 0 just
   before and read just after: the forward must have launched 240 times
   (12 blocks x (8 train + 2 eval batches) x 2 epochs), each backward
   kernel 192 times; the losses must be finite and epoch 2's train loss
   below epoch 1's;
8. one loss-and-backward on a fixed batch from the same initial weights
   on the card (the kernels) and on the CPU (the plain versions): the
   loss within LOSS_ATOL, each gradient within GRAD_REL of its leaf's
   max |g|;
9. hold the int8 wire's codec against its plain versions, BITWISE, at
   every shape the reducer gives it on ResNet-18's 11,181,642-element
   gradient over 2 ranks (K1 on one row per bucket, or on 2 rows and one
   row for int8_multihop, each row split over many blocks; K2, the
   dequant-sum, on 2 rows), K1 at long edge rows (a width not a multiple
   of 4, an all-zero row) and K2 at edge shapes (1, 3 and 8 rows, width 1,
   a width not a multiple of 4, zero scales; 9 rows, the generic
   variant), timing each beside its bound, its plain version and, for K2,
   the composite ``scales @ q.float()``, the card's time alone
   (``device_ms``) and the launch plan's variant (staged or generic);
10. run ``reduce_flat`` on 2 gloo ranks (spawned processes, both on the
    card) for each DP_RUNS wire on a seeded full-size gradient and
    residual, twice, on the card (the kernels) and on the CPU (the plain
    versions): sums and residuals must be BITWISE equal, the ranks' sums
    the same, the launch counts the wire's; then time the collectives
    alone;
11. train ResNet-18 at full width on one rank through ``train.main``
    (synthetic CIFAR-10 32x32, batch 128, SGD lr 0.1 momentum 0.9, 2
    epochs of 20 steps): the train loss must fall; then time the loader
    alone;
12. train the same model on 2 ranks sharing the card (gloo) through
    one ``torchrun`` of this script's ``--dp-worker`` mode, which calls
    ``train.main`` with the counts set to 0 just before and read just
    after, once per DP_RUNS wire in one process group (batch 128 a rank,
    2 epochs of 12 steps):
    each rank's K1 and K2 launches must be steps x the wire's count per
    step, both ranks must end with bitwise-equal parameters and BatchNorm
    statistics, and the loss must fall;
13. (A) the reference's own command: the same model on 2 ranks through
    one ``torchrun`` (both runs in one process group) with the default
    ``--wire-dtype fp32 --bucket-cap-mb 0``
    (the implicit path: global-batch BatchNorm, one fp32 all-reduce; no
    kernel of the port), batch 128 a rank, 2 epochs of 12 steps, then the
    same with ``--amp``: the loss must fall, and the ranks must end with
    bitwise-equal parameters and BatchNorm statistics;
14. (B) phase 7 again with ``--amp`` (bf16 compute, float32 parameters;
    K3-K5 in bf16): 240 / 192 / 192 launches, finite losses, epoch 2's
    train loss below epoch 1's; then phase 8 at bf16, within
    BF16_LOSS_ATOL and BF16_GRAD_REL;
15. (C) GPT-2 124M on 2 ranks sharing the card (implicit fp32 path,
    ``torchrun``), batch 4 a rank, one epoch of 4 steps: each rank's K3,
    K4 and K5 launches exact, parameters bitwise equal across ranks;
16. (D) ``serving smoke --serve-dtype bf16`` on the card, and the same
    engine on the CPU: prefill logits within BF16_ATOL;
18. (run before phase 17's lines) checkpoints through the port's entry
    points: (a) phase 14's command with ``--checkpoint-dir``, preempted
    by ``--chaos sigterm@step=4`` (one checkpoint at epoch 0 step 5, no
    CSV row), then ``--resume``: the two runs launch K3-K5 as phase 14
    did and end with parameters and AdamW moments bitwise phase 14's;
    (b) phase 12's int8 one-bucket run on 2 ranks under ``--max-restarts
    2 --chaos crash@step=15,torn_ckpt@save=1``: one restart, one torn
    checkpoint skipped, K1 and K2 launches exact over the steps executed
    (replays included), each rank's parameters, BatchNorm statistics and
    residual bitwise phase 12's; (c) ``serving smoke --ckpt-dir`` on run
    C's directory: prefill logits bitwise an engine built from run C's
    parameters in memory. Each run logs ``save_blocked_ms``,
    ``snapshot_ms``, the bytes written and the sha256 time;
19. (run before phase 17's lines) the sharded update and the two-tier
    wire through the port's entry: (a) ResNet-18 on 2 ranks sharing the
    card under ``--zero1`` at fp32, int8 and int8_multihop, (b) under
    ``--fsdp-explicit`` at fp32 and int8, then GPT-2 124M
    ``--fsdp-explicit --amp`` at phase 15's shape; (c) ResNet-18 on 4
    ranks, ``--slices 2 --wire-dtype int8_hier`` through the bucketed
    reducer (cap 25) and with ``--zero1`` (one torchrun a world, the runs
    in one process group, the counts set to 0 just before each run and
    read just after): each run's K1, K2 (and K3-K5)
    launches exact, the ranks' evaluated parameters and BatchNorm
    statistics bitwise equal, the optimizer state (FSDP: the parameters
    too) padded/N a leaf at rest, the loss falling in at least one run;
    then the hier codecs on 4 spawned ranks on a seeded full-size
    gradient, card (kernels) vs CPU (plain versions) bitwise; (d) K1 and
    K2 at every shape those runs give them, bitwise and timed as phase 9
    times them, summed a step beside phase 9's bucketed figures. Phases 7
    and 14 log their step lines' samples/s as MFU (``experiments/
    flops.py``: 3 x the forward's matmul FLOPs a sample against the
    card's bf16 dense peak; ``check_mfu`` must accept it);
20. (run before phase 17's lines) step profiling on the card through the
    port's entry points (``torch.profiler``, CUPTI's kernel lanes): (a)
    phase 14's command over one epoch of 12 steps with ``--profile-dir
    --profile-steps 5,8``, the launch counts set to 0 just before and
    read just after: the device split a step (window, compute, comm
    hidden, comm exposed, host gap), the device idle share, the ten
    device ops with the most time and each bf16 flash kernel's mean
    device time from the trace beside phase 6's ``timed_ms``; the window
    must hold each bf16 flash kernel 12 x 3 times, the split must sum to
    the window, the stream a ``device_profile`` event of steps 5-8, and
    the port's ``telemetry summary`` must read it; (b) phase 13's fp32
    command (2 gloo ranks sharing the card) with ``--profile-dir``: rank
    0's collective share and split, its gloo all-reduce spans beside
    phase 10's timed all-reduces; (c) a GPT-2 ``--amp`` run with
    ``--metrics-port``: ``/metrics``' step counter rises between two
    scrapes, ``/healthz`` answers 200, ``POST /profile?steps=2`` leaves a
    ``capture_*`` trace and a ``device_profile`` event. A CUDA window
    with no kernel event fails the phase;
21. (run before phase 17's lines) continuous serving through the port's
    entry points at GPT-2 124M full width (random weights from seed 0),
    on one schedule of 24 prompts of 1-128 tokens (buckets 64 and 128)
    at 16 requests/s, 32 new tokens each, 8 slots, pages of 16: (a)
    ``measure_serving`` (``bench``) and ``measure_serving_continuous``
    (``bench --continuous``), fp32 pages: every request completes, and the
    greedy streams are equal or part first where the dense arm's top-2
    logit gap is below ESCAPE_GAP (escapes counted and printed); (b)
    ``bench --continuous --kv-dtype int8`` through the CLI with the counts
    set to 0 just before and read just after: K1 launches once a page
    write of k and once of v (2 a decode step at (12 x 8 x 12, 64), 2 a
    prefill), its captured pages bitwise its plain version's on the same
    rows, each shape timed beside its bound, and ``kv_bytes_ratio`` >= 3;
    (c) ``--draft gpt2_124m`` (the draft random from seed 1): streams
    equal (a)'s continuous arm under the same escape rule, accept ratio
    printed; (c') the target as its own draft: the accept ratio at least
    ORACLE_MIN and the streams as (a)'s; (d) ``--shared-frac 0.5``:
    prefill skips > 0; (e) ``--replicas 2 --kill-replica``: the death
    finds requests in flight, the router resubmits them, every request
    completes, streams as (a)'s; (f) ``serving serve`` on an ephemeral
    port in its own process: ``/generate`` (the first prompt's stream as
    (a)'s, every answer 32 tokens; one sampled request asked twice gives
    one stream), ``/healthz``, then SIGTERM drains and exits 0; the key
    stream's bits on the card bitwise the CPU's; (g) the decode step with
    every slot live: fp32, int8 weights (dequantized every call) and int8
    pages, alternating, and its sampling and dequantization alone;
22. (run before phase 17's lines) BERT-base masked LM and ViT-B/16
    through the port's entry at full width (random weights, synthetic
    data): (a) BERT at S 512, batch 8, 8 steps, fp32 and ``--amp``: K3,
    K4 and K5 bidirectional, each exactly 12 a step (K3 also 12 an eval
    batch), finite losses, the step lines' samples/s and MFU; (b) one
    BERT loss-and-backward at batch 2, card against CPU from the same
    weights, the masks (jax.random's draws from the JAX step key) bitwise
    equal on both, the loss and gradients within phase 8's rule; (c) (a)'s
    fp32 command with ``--remat``: K3 twice a training step, the losses
    and the final parameters and AdamW moments bitwise (a)'s, the peak of
    allocated memory beside (a)'s; (d) ViT-B/16 ``--amp`` on synthetic
    ImageNet at 224, batch 64, 8 steps: samples/s and MFU; one fp32
    loss-and-backward at batch 2, card against CPU; (e) BERT's
    "grad-sync profiling run": 2 gloo ranks sharing the card with
    ``--wire-dtype int8`` and ``--profile-dir`` over steps 2-4: K1, K2
    and K3-K5 launches exact per rank, the ranks' states bitwise equal,
    the window's device split and collective share (2 ranks on one card:
    not a scaling number);
23. (run before phase 17's lines) sequence parallelism: (a) the ring
    (K6: K3 on each ring step's block, causal on the diagonal and full on
    past blocks, future blocks skipped; K4 and K5 against the global lse,
    the dK/dV accumulators rotating home) and Ulysses (two all-to-alls
    around the flash kernels on 6 heads of the whole sequence) on 2 gloo
    ranks sharing the card at B 8, S 1024 (512 a rank), 12 heads of 64,
    causal, fp32 and bf16: output, lse, dQ, dK and dV against the plain
    versions (``_ring_body``, ``_local_attention``) and against
    single-rank K3-K5 on the whole sequence, within FLASH_REL; a forward
    and backward of each timed beside single-rank flash and SDPA on the
    whole (B, S); (b) GPT-2 124M at full width and SP_DEPTH (3) of its
    12 blocks (the depth cut to pay for phases 25 and 26) through
    ``torchrun`` with
    ``--mesh data=1,seq=2``, ``--attention ring`` and ``ulysses``, fp32
    and ``--amp``, one epoch of 3 steps each, the counts set to 0 just
    before and read just after each run: every rank's K3-K5 launches on
    the schedule (the ring's rank r runs r + 1 blocks a layer, Ulysses
    one), the ranks' final parameters bitwise equal, step 1's loss within
    LOSS_ATOL (BF16_LOSS_ATOL under ``--amp``) of single-rank flash on the
    same rows from the same weights; (c) each run's ms a step and
    samples/s (2 ranks on one card: not a scaling number);
24. (run before phase 17's lines) tensor parallelism, GPT-2 124M at full
    width and TP_DEPTH (3) of its 12 blocks (cut as SP_DEPTH; the
    vocab padded to 50304, as the entry pads it at model=2),
    S 1024, batch 8 a batch coordinate, weights from one seed: (a) on 2
    gloo ranks sharing the card, ``--mesh data=1,model=2``'s model, one
    loss-and-backward (K3-K5 on each rank's 6 heads) against model=1 on
    one rank from the same global weights: the loss within LOSS_ATOL,
    the gathered gradients within GRAD_REL of each leaf's max |g|, the
    step's model-axis all-reduces 4 x 6 + 2, plus the cross-entropy's
    2, and their payload exact; (b) ``train.main`` through ``torchrun
    chip_smoke.py --tp-worker``, one epoch of 3 steps each:
    ``--mesh data=1,model=2`` fp32 and ``--amp`` (2 ranks),
    ``data=2,model=2`` fp32 and ``--fsdp-explicit --wire-dtype int8``
    (4 ranks), and on the 2 ranks the int8 run's yardstick,
    ``--mesh data=2 --fsdp-explicit --wire-dtype int8`` at model=1 on the
    same rows (TP_INT8_MODEL1; its launches, finite falling losses and
    gathered parameters equal on both ranks checked too), the counts set
    to 0 just before and read just after each
    run: every rank's K3-K5 launches 6 a forward and a backward, K1 and
    K2 exact from the TP-local layer plan, the replicated leaves bitwise
    equal on every rank and, without ``--fsdp-explicit``, the split
    leaves across the data axis, finite losses, and the run held to
    ``train.main`` at model=1 on one rank over the same rows from the same
    draw: every step's loss within LOSS_ATOL (BF16_LOSS_ATOL under
    ``--amp``; the int8 wire against the fp32 run within TP_WIRE_RTOL),
    the loss falling every step, and the final parameters, gathered over
    the model ranks, off the model=1 run's (the int8 wire's off
    TP_INT8_MODEL1's) by at most TP_PARAM_REL of that run's movement from
    the draw, leaf by leaf and over the whole model (an update that did
    nothing is off by all of it); (c) each
    run's ms a step and
    samples/s (ranks sharing one card: not a scaling number), each rank's
    parameter and moment bytes at rest and its peak allocated memory
    beside model=1's; K1 and K2 at the TP x FSDP run's shapes, bitwise
    their plain versions, timed as phase 9 times them;
25. (run before phase 17's lines) the mesh's last two axes at full width
    and PP_DEPTH (2) of 12 blocks, S 1024, batch 8 a batch coordinate,
    one epoch of 3 steps each, weights from one seed: (b) one
    loss-and-backward of gpt2_moe (the router loss included) at batch 1
    from one draw on the CPU and twice on the card (K3-K5 in all its
    blocks), fp32, TF32 off: the loss within LOSS_ATOL,
    the gradients within GRAD_REL of each leaf's max |g|, and whether the
    card's two runs are bitwise equal; then, in this process, GPT-2 at
    pipe=1 (``--attention xla``, the einsum the stages run) and gpt2_moe
    on one rank (``--attention flash``), fp32 and ``--amp``: launches
    exact (0 for GPT-2, 2 a forward and a backward for gpt2_moe),
    finite losses that fall every step, the aux losses; then one
    ``torchrun chip_smoke.py --pp-worker`` of 2 ranks for (a) ``--mesh
    data=1,pipe=2 --microbatches 4`` and (c) ``--model gpt2_moe --mesh
    data=1,expert=2``, fp32 and ``--amp``, the counts set to 0 just
    before and read just after each run: every rank's K3-K5 launches
    (none on the pipeline, 2 a forward and a backward on each expert
    rank), the replicated leaves bitwise equal on both ranks, each expert
    rank holding experts [4r, 4r+4), every step's loss within LOSS_ATOL
    (BF16_LOSS_ATOL under ``--amp``) of its one-rank run over the same
    rows from the same draw, the loss falling every step, and the final
    parameters off the one-rank run's by at most PIPE_PARAM_REL
    (EXPERT_PARAM_REL) of its movement from the draw, leaf by leaf and
    over the model (the pipe=1 run's stacked by
    ``convert.gpt2_to_pipe_params``), logged as bitwise or not; (d) each
    run's ms a step and samples/s (ranks sharing one card: not a scaling
    number), each rank's parameter and moment bytes at rest and its peak
    allocated memory beside the one-rank run's;
26. (run before phase 17's lines) the models that are not causal LMs, at
    full width, weights from one seed: (a) ``serving smoke`` for
    ``resnet18``, ``vit_b16`` (two 32x32 images) and ``bert_base`` (three
    prompts through the queue and its worker), fp32 and ``--serve-dtype
    int8``, in this process, the counts set to 0 just before and read just
    after: K1 launched once per int8 leaf and never in fp32, every int8
    leaf's codes and scales bitwise the CPU's plain quantizer's on the same
    weights, the logits within ATOL of a CPU engine's from the same
    weights (the served model's own template), ms a call of the image and
    token serves on the host clock; K1 bitwise its plain version at every
    int8 leaf shape, timed beside its bound; one ``serving bench --model
    bert_base`` row (p50/p99; no token rate); (b) one ``torchrun
    chip_smoke.py --tp-worker --bert`` of 2 ranks: first (c), one fp32
    loss-and-backward of ViT-B/16 (224x224, batch VIT_TP_BATCH, the
    einsum attention) at model=2 against model=1 on rank 0 (the loss
    within LOSS_ATOL, each gathered gradient within GRAD_REL of its
    leaf's max |g|, 4 model-axis all-reduces a block); then BERT-base
    (BERT_TP_DEPTH of its 12 blocks, full width, S 512, the vocab padded
    to 128 as the entry pads it) through ``train.main --mesh
    data=1,model=2 --attention flash``, fp32 and ``--amp``, one epoch of
    BERT_TP_STEPS steps, the counts set to 0 just before and read just
    after each run: K3-K5 exact on each rank's 6 heads, the replicated
    leaves bitwise equal on both ranks, every step's loss within
    LOSS_ATOL (BF16_LOSS_ATOL under ``--amp``) of ``train.main`` at
    model=1 over the same rows from the same draw, and the final
    parameters off that run's by at most TP_PARAM_REL of its movement
    from the draw; ms a step and samples/s (2 ranks sharing one card:
    not a scaling number);
27. (run before phase 17's lines) the rest of the training mesh, GPT-2
    124M and gpt2_moe at full width and TP_DEPTH (3) blocks, S 1024,
    batch MESH_BATCH a batch coordinate, one epoch of MESH_STEPS steps,
    weights from one seed, through ``train.main``: one ``torchrun
    chip_smoke.py --mesh-worker`` of 4 ranks and one of 2 (the process
    group kept between a torchrun's runs), the one-rank gpt2_moe runs in
    this process, the counts set to 0 just before and read just after
    each run, K3-K5 exact on every rank at its shape (`mesh_want`) and K1
    and K2 0: (a) ``--mesh fsdp=2`` against ``data=2`` and
    ``fsdp=2,model=2`` against ``data=2,model=2``, (b) ``--mesh
    data=2,model=2 --zero1`` against the run without it, (d) gpt2_moe at
    ``model=2`` against model=1 and at ``seq=2 --attention ring``
    against seq=1: every step's loss within LOSS_ATOL, the final global
    parameters (``checkpoint.global_params``) off the yardstick's by at
    most TP_PARAM_REL of its movement from the draw (without the q, k or
    v part of a qkv.bias whose gradient at the draw is zero up to
    rounding, ZERO_GRAD_REL: the key bias, whose reading is logged on its
    own), each rank's parameter and moment bytes
    at rest beside the yardstick's (the fsdp axis's and ZeRO-1's moments
    at most MESH_REST_SHARE of them), gpt2_moe's aux losses within
    LOSS_ATOL and its dropped assignments equal; (c) ``--mesh
    seq=2,model=2`` under ring and Ulysses, fp32 and ``--amp``: step 1's
    loss within LOSS_ATOL (BF16_LOSS_ATOL) of single-rank flash's on the
    same rows, K3-K5 on 6 heads of 512 rows (the ring) and 3 of 1024
    (Ulysses), each checked against its plain version at that shape in
    phase 6 (FLASH_CASES' ``sp tp`` rows); ms a step (ranks sharing one
    card: not a scaling number);
17. print the ``{"kernels": [...]}`` line (K1 and K2 over their launches
    on the phase 12, phase 19 and phase 22 (e) paths, K1 also over phase
    21's int8 pages (``paged_kv_*`` apart), K3-K5 over phase 7's and
    phase 22 (a)'s fp32 runs (BERT's share apart as ``bert_*``), with
    their bf16 fields over phase 14's and phase 22 (a)'s ``--amp``
    launches at the bf16 shapes, ``bf16_trace_ms_per_launch``, phase
    20's device time of a launch, and phase 23 (b)'s ring and Ulysses
    launches apart as ``ring_*``, ``ring_bf16_*``, ``ulysses_*`` and
    ``ulysses_bf16_*``, and phase 24 (b)'s over every rank as ``tp_*``
    and ``tp_bf16_*``; K1's and K2's ``tp_*`` over the TP x FSDP int8
    run's ranks; K3-K5's ``moe_*`` and ``moe_bf16_*`` over phase 25
    (b)'s one-rank runs and (c)'s ranks, at the training shape; K1's
    ``serve_*`` over phase 26 (a)'s int8 weights, K3-K5's ``bert_tp_*``
    and ``bert_tp_bf16_*`` over phase 26 (b)'s ranks at BERT's 6-head
    shape, K3-K5's ``mesh_*`` and ``mesh_bf16_*`` over every rank of
    phase 27's runs, each launch at its shape's row), then the last line
    ``{"ok": true, "device": {...}}``.

Details go to chiprun_out/chip_smoke.json. Without a CUDA device, or run
from a directory that lacks the port's package, it fails before printing
any result.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = "distributed_pytorch_training_tpu_torch"
MODEL = "gpt2_124m"
MAX_NEW_TOKENS = 8      # the serving CLI's default
VOCAB = 50257

# card vs CPU, prefill logits, fp32 and int8 alike: the int8 leaves are
# bitwise equal on both (checked first), so what is left is float32
# reassociation over 12 blocks of K = 768..3072 products (TF32 is off),
# measured at 3.7e-6 on an H100; a real fault (a wrong mask, layout,
# GELU, dequantization or scale broadcast) moves logits by > 1e-2.
ATOL = 1e-4

# NVIDIA's data sheet for the H100 SXM (80 GB HBM3): memory rate, float32
# rate outside the tensor cores, and the dense tensor-core rates of TF32
# and bf16, at the full 700 W.
H100_SXM = "H100 80GB HBM3"
BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# float32-accurate products on the tensor cores: three TF32 products each
# (3xTF32), the least time any float32 flash kernel could take
FLASH_FP32_OPS_PER_S = TF32_OPS_PER_S / 3

# flash kernels against their plain versions, as max|diff| / max|plain|
# per output. float32: both sum in float32 in different orders (tiles vs
# full rows), and the kernels form each product as three TF32 products
# (3xTF32), some 1e-6 of the output's scale at these sizes (one TF32
# product would be ~5e-4); a wrong mask, scale or index moves whole rows
# by O(1). bfloat16: both round
# their float32 results to bfloat16 (8 bits of mantissa), so an element
# may differ by one bfloat16 step, 2**-8 to 2**-7 of its magnitude; the
# bf16 forward, dK/dV and dQ also round P and dS to bf16 before their
# second product, ~2e-3 of the output's scale (tests/test_torch_bf16_mma.py).
FLASH_REL = {"float32": 1e-4, "bfloat16": 1e-2}

# (name, B, Sq, Sk, H, D, causal, kv_valid, dtype): the training path's
# shape first, then the edges
FLASH_CASES = [
    ("main fp32", 8, 1024, 1024, 12, 64, True, False, "float32"),
    ("main bf16", 8, 1024, 1024, 12, 64, True, False, "bfloat16"),
    ("non-causal", 8, 1024, 1024, 12, 64, False, False, "float32"),
    ("kv_valid, all-masked rows", 4, 512, 512, 12, 64, True, True,
     "float32"),
    ("Sq=Sk=1000", 8, 1000, 1000, 12, 64, True, False, "float32"),
    ("Sq=256 Sk=512", 8, 256, 512, 12, 64, True, False, "float32"),
    ("D=128", 8, 1024, 1024, 6, 128, True, False, "float32"),
    ("kv_valid, all-masked rows bf16", 4, 512, 512, 12, 64, True, True,
     "bfloat16"),
    ("Sq=Sk=1000 bf16", 8, 1000, 1000, 12, 64, True, False, "bfloat16"),
    ("Sq=256 Sk=512 bf16", 8, 256, 512, 12, 64, True, False, "bfloat16"),
    ("D=128 bf16", 8, 1024, 1024, 6, 128, True, False, "bfloat16"),
    # BERT-base's bidirectional attention on phase 22's path (also the
    # ring's past blocks on phase 23's)
    ("bert non-causal", 8, 512, 512, 12, 64, False, False, "float32"),
    ("bert non-causal bf16", 8, 512, 512, 12, 64, False, False,
     "bfloat16"),
    # phase 23's sequence-parallel GPT-2: the ring's diagonal block (half
    # of S 1024 a rank) and Ulysses' 6 heads of the whole sequence
    ("ring diagonal", 8, 512, 512, 12, 64, True, False, "float32"),
    ("ring diagonal bf16", 8, 512, 512, 12, 64, True, False, "bfloat16"),
    ("ulysses", 8, 1024, 1024, 6, 64, True, False, "float32"),
    ("ulysses bf16", 8, 1024, 1024, 6, 64, True, False, "bfloat16"),
    # phase 26's BERT at model=2: 6 of its 12 heads a rank, non-causal
    ("bert tp", 8, 512, 512, 6, 64, False, False, "float32"),
    ("bert tp bf16", 8, 512, 512, 6, 64, False, False, "bfloat16"),
    # phase 27's seq=2,model=2: the ring's diagonal block on a model
    # rank's 6 heads (its past block is "bert tp"'s shape), and Ulysses'
    # 3 heads (6 local heads over 2 seq ranks) of the whole sequence
    ("sp tp ring", 8, 512, 512, 6, 64, True, False, "float32"),
    ("sp tp ring bf16", 8, 512, 512, 6, 64, True, False, "bfloat16"),
    ("sp tp ulysses", 8, 1024, 1024, 3, 64, True, False, "float32"),
    ("sp tp ulysses bf16", 8, 1024, 1024, 3, 64, True, False, "bfloat16"),
    # what the bf16 forward's and dK/dV's TMA loads fill with zeros: D
    # below and past a 64-column box, ragged tails of Sq and Sk (not a
    # multiple of the 128-row tiles) on both sides, and all-masked rows
    # (keys 0-99 of batch row 1) whose 128-row q tile also holds live rows
    ("D=32 bf16", 4, 512, 512, 12, 32, True, False, "bfloat16"),
    ("D=96 bf16", 4, 512, 512, 8, 96, True, False, "bfloat16"),
    ("Sq=200 Sk=333 non-causal bf16", 8, 200, 333, 12, 64, False, False,
     "bfloat16"),
    ("kv_valid, all-masked rows straddling a tile bf16", 4, 200, 200, 12,
     64, True, True, "bfloat16"),
    # the same for the float32 kernels, whose loads are TMA's too
    # (32-column boxes; D 96 takes the D-128 tiles)
    ("D=32", 4, 512, 512, 12, 32, True, False, "float32"),
    ("D=96", 4, 512, 512, 8, 96, True, False, "float32"),
    ("Sq=200 Sk=333 non-causal", 8, 200, 333, 12, 64, False, False,
     "float32"),
    ("kv_valid, all-masked rows straddling a tile", 4, 200, 200, 12, 64,
     True, True, "float32"),
]
TRAIN_STEPS = 8            # 64 sequences / batch 8
EVAL_STEPS = 2             # 64 // 5 = 12 sequences, 2 padded batches of 8
EPOCHS = 2
DEPTH = 12

# card vs CPU, one loss-and-backward from the same weights (TF32 off): the
# two sides differ by float32 reassociation over 12 blocks (cuBLAS vs the
# CPU's GEMMs, tiled vs full-row softmax), a few 1e-6 of a leaf's largest
# gradient; a wrong mask, scale or index in a backward kernel moves whole
# rows by O(1) of it.
LOSS_ATOL = 1e-4
GRAD_REL = 1e-3
CPU_BATCH, CPU_SEQ = 2, 256

# ResNet-18 at the reference's 10 classes (the ImageNet stem): the length
# of its flat gradient, and the explicit reducer's configurations that the
# smoke drives on 2 ranks sharing the one card over gloo:
# (name, --wire-dtype, --bucket-cap-mb)
RESNET18_PARAMS = 11_181_642
DP_RANKS = 2
DP_RUNS = [("int8 one bucket", "int8", 0.0),
           ("int8 cap 25", "int8", 25.0),
           ("int8_multihop one bucket", "int8_multihop", 0.0)]
# synthetic CIFAR-10, batch 128 per rank: 2 epochs of 12 steps on 2 ranks;
# 2 epochs of 20 steps on 1 rank
DP_SYNTHETIC, ONE_RANK_SYNTHETIC, IMAGE_BATCH, IMAGE_EPOCHS = \
    3072, 2560, 128, 2
IMAGE_FLAGS = ["--model", "resnet18", "--dataset", "cifar10", "--synthetic",
               "--batch-size", str(IMAGE_BATCH), "--epochs",
               str(IMAGE_EPOCHS), "--optimizer", "sgd", "--lr", "0.1",
               "--momentum", "0.9", "--print-freq", "6"]
QUANTIZE, DEQUANT = "quantize_int8_rows", "dequant_sum_rows"
# cuDNN's default float32 convolution algorithms do not sum in a fixed
# order, and ResNet-18's first steps at lr 0.1 are chaotic: four runs of
# phase 12's int8 one-bucket configuration from the same seeds ended
# epoch 2 at train loss 0.4555, 0.4436, 0.4304 and 0.9645 on an H100, and
# one run in eight of the smoke ended above its first epoch's loss. With
# deterministic algorithms four runs gave bitwise-equal parameters (3.7637
# -> 0.9062), so each run of phases 11-13 repeats the last.
CUDNN_DETERMINISTIC = True
FLASH = ("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
         "flash_attention_bwd_dq")
# the wrappers whose TMA kernels (all six, bf16 and float32) count the
# inputs they had to copy first (an unaligned view, an odd D): no main
# path may make one
STAGED = FLASH

# bf16 (--amp) card vs CPU. Both sides round every product, LayerNorm and
# GELU output to bf16 (8 significand bits, 2**-8 of a value), but sum in
# other orders (cuBLAS and the flash kernels vs the CPU's GEMMs and the
# plain attention), so now and then a value rounds to the neighbouring
# bf16 number and the next layers carry that on. A prefill logit may then
# differ by a few bf16 steps of its size (one step of a logit of 8 is
# 0.03; measured 0.027 on an H100); the loss, a float32 mean over 510
# tokens, by a fraction of one step of its size (0.04 at 10.9; measured
# 1.6e-4); a gradient by a few bf16 steps of its leaf's largest (measured
# 1.7e-2 of it). A wrong mask, scale or index moves them by O(1) of those
# sizes. (That the model computes in bf16 at all is checked on the model:
# its dtype, and float32 parameters.)
BF16_ATOL = 0.1
BF16_LOSS_ATOL = 1e-2
BF16_GRAD_REL = 5e-2

# GPT-2 on 2 ranks sharing the card (phase 15): batch 4 a rank, one epoch
# of 4 steps over 32 synthetic sequences; 32 // 5 = 6 validation
# sequences, one padded global batch of 8
LM_DP_BATCH, LM_DP_SYNTHETIC, LM_DP_STEPS, LM_DP_EVAL = 4, 32, 4, 1
# the serving smoke's telemetry stream (its --output-dir)
SERVING_OUT = ["--output-dir", str(ROOT / "chiprun_out" / "serving")]
LM_FLAGS = ["--model", MODEL, "--attention", "flash", "--optimizer",
            "adamw", "--lr", "6e-4", "--synthetic"]


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def train_main(argv):
    """``train.main(argv)`` in this process; its preemption guard's
    SIGTERM handler is taken down again after it (this script's own
    SIGTERM must still stop it)."""
    from distributed_pytorch_training_tpu_torch import train
    from distributed_pytorch_training_tpu_torch.training.preemption import (
        PreemptionGuard,
    )

    try:
        return train.main(argv)
    finally:
        PreemptionGuard.uninstall()


def tensor_digest(t) -> str:
    """sha256 of a tensor's bytes (bitwise equality of two states is
    equality of every digest)."""
    import hashlib

    import torch

    t = torch.as_tensor(t).detach().cpu().contiguous().view(-1)
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()


def state_digests(state) -> dict:
    """{name: sha256} of the parameters, the buffers and every optimizer
    state tensor (AdamW's moments and count) of a TrainState."""
    out = {f"model/{k}": tensor_digest(v)
           for k, v in state.model.state_dict().items()}
    for idx, slots in state.optimizer.state_dict()["state"].items():
        out.update({f"opt/{idx}/{k}": tensor_digest(v)
                    for k, v in slots.items()})
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def timed_ms(torch, fn, flush, reps: int = 10) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, each started
    with a cold L2 (``flush`` is rewritten in between, outside the
    timed window), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def quantizer_inputs(torch, dev):
    """name -> (n, s) float32 input on the card: the main path's shapes
    first (with their launch counts), then the edge shapes."""
    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.serving import ServeConfig

    # the int8 leaves of the smoke's model, the shapes phase 4 quantizes
    # (max_position by build_serving_engine's rule at the CLI defaults)
    cfg = ServeConfig(buckets=(16, 32), max_new_tokens=MAX_NEW_TOKENS,
                      serve_dtype="int8")
    meta = get_model(MODEL, max_position=max(
        512, max(cfg.buckets) + cfg.max_new_tokens), device="meta")
    counts = {}
    for _, p in meta.named_parameters():
        if p.dim() >= 2 and p.numel() >= cfg.quantize_min_elements:
            shape = (p.numel() // p.shape[-1], p.shape[-1])
            counts[shape] = counts.get(shape, 0) + 1
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for shape, count in counts.items():
        x = torch.randn(shape, generator=g, device=dev) * 0.02
        cases.append((f"{shape[0]}x{shape[1]}", x, count))
    cases.append(("1x1000003", torch.randn((1, 1_000_003), generator=g,
                                           device=dev), 0))
    cases.append(("3x5", torch.randn((3, 5), generator=g, device=dev), 0))
    zero = torch.randn((4, 1000), generator=g, device=dev)
    zero[0] = 0.0
    zero[2] = 0.0
    cases.append(("4x1000 zero rows", zero, 0))
    # amax 127 makes the scale exactly 1.0, so k + 0.5 lands on a tie
    half = torch.arange(-127, 127, device=dev, dtype=torch.float32) + 0.5
    half = torch.cat([half, torch.tensor([127.0, -127.0], device=dev)])
    cases.append(("2x256 half codes", torch.stack([half, -half]), 0))
    return counts, cases


def check_quantizer(torch, dev):
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        quantize_int8_rows,
        quantize_int8_rows_ref,
    )

    counts, cases = quantizer_inputs(torch, dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for name, x, count in cases:
        q, s = quantize_int8_rows(x)
        qr, sr = quantize_int8_rows_ref(x)
        torch.cuda.synchronize()
        same = (torch.equal(q, qr)
                and torch.equal(s.view(torch.int32), sr.view(torch.int32)))
        err = max((q.int() - qr.int()).abs().max().item(),
                  (s - sr).abs().max().item())
        n, w = x.shape
        nbytes = 5 * n * w + 4 * n          # read 4 B, write 1 B, 4 B/row
        ops = 5 * n * w                     # abs, max, divide, round, clip
        bound_bytes_ms = nbytes / BYTES_PER_S * 1e3
        bound_ops_ms = ops / FP32_OPS_PER_S * 1e3
        row = {
            "shape": name, "main_path_launches": count, "bitwise": same,
            "max_abs_err": err,
            "ms": timed_ms(torch, lambda: quantize_int8_rows(x), flush),
            "plain_ms": timed_ms(torch, lambda: quantize_int8_rows_ref(x),
                                 flush),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
        }
        rows.append(row)
        log(f"quantize_int8_rows {name}: bitwise={same} "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); no single "
            "PyTorch call computes this function (library_ms null)")
        if not same:
            raise RuntimeError(f"quantize_int8_rows {name}: kernel differs "
                               f"from its plain version (max err {err})")
    return counts, rows


def logits_vs_cpu(report, cpu_engine) -> float:
    """Max |diff| of each smoke prompt's prefill last_logits on the card
    against ``cpu_engine`` serving the same prompt."""
    err = 0.0
    for prm, res in zip(report.prompts, report.results):
        ref = cpu_engine.serve_tokens([prm], max_new_tokens=1)[0]
        err = max(err, float(abs(res.last_logits - ref.last_logits).max()))
    return err


def reset_staged(fa) -> None:
    for name in STAGED:
        getattr(fa, name).staged_copies = 0


def staged_copies(fa) -> int:
    return sum(getattr(fa, name).staged_copies for name in STAGED)


def flash_module():
    """The port's ops/flash_attention.py (the ops package re-exports its
    function ``flash_attention`` under the module's name)."""
    return importlib.import_module(f"{PACKAGE}.ops.flash_attention")


def rel_err(torch, got, want) -> float:
    """max|got - want| / max|want|; a non-finite result fails."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise RuntimeError("a flash kernel wrote a non-finite value")
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def flash_bounds(torch, case, kv) -> dict:
    """{kernel: (bound ms, "bytes" or "operations")} of one launch: the
    larger of the bytes it must move (each input read once, each output
    written once) over the memory rate and the flops of this input's live
    (query, key) pairs (4, 8 and 6 x D each, the JAX module's cost counts)
    over the peak rate of the input type: bf16 on the tensor cores, float32
    as three TF32 products (FLASH_FP32_OPS_PER_S)."""
    _, b, sq, sk, h, d, causal, _, dtype = case
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        keep = keep.tril()
    if kv is None:
        pairs = b * int(keep.sum())
    else:
        pairs = int((keep[None] & (kv.cpu()[:, None, :] > 0)).sum())
    pairs *= h
    item = 4 if dtype == "float32" else 2
    rate = FLASH_FP32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S
    nq, nk = b * sq * h * d * item, b * sk * h * d * item
    rows = b * h * sq * 4                       # lse or delta, float32
    mask = 0 if kv is None else b * sk * 4
    work = {
        "flash_attention_fwd_lse": (2 * nq + 2 * nk + rows + mask, 4),
        "flash_attention_bwd_dkv": (2 * nq + 4 * nk + 2 * rows + mask, 8),
        "flash_attention_bwd_dq": (3 * nq + 2 * nk + 2 * rows + mask, 6),
    }
    out = {}
    for name, (nbytes, per_pair) in work.items():
        t_bytes = nbytes / BYTES_PER_S * 1e3
        t_ops = per_pair * d * pairs / rate * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def ptxas_resources(log_path: Path) -> list:
    """[{kernel, dtype, DP, regs, spill_bytes}] of every flash kernel
    instantiation in nvcc's build log (``-Xptxas -v``): registers a thread
    and spill stores (DP: the head dim padded to 16/32/64/128)."""
    import re

    rows = []
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(flash_(?:fwd|bwd_dkv|bwd_dq)(?:_bf16|_tf32)?"
                          r"(?:_sm90)?_kernel)I(f|13__nv_bfloat16)?Li(\d+)E",
                          line)
            rows.append(m and {
                "kernel": m[1], "DP": int(m[3]), "regs": None,
                "dtype": "bfloat16" if "bf16" in m[1] or m[2] == (
                    "13__nv_bfloat16") else "float32", "spill_bytes": 0})
        elif rows and rows[-1]:
            if m := re.search(r"(\d+) bytes spill stores", line):
                rows[-1]["spill_bytes"] = int(m[1])
            if m := re.search(r"Used (\d+) registers", line):
                rows[-1]["regs"] = int(m[1])
    rows = [r for r in rows if r]
    for r in rows:
        log(f"ptxas {r['kernel']} {r['dtype']} DP {r['DP']}: {r['regs']} "
            f"registers, {r['spill_bytes']} B spill stores")
    return rows


def check_flash(torch, dev, flush):
    """Each FLASH_CASES shape: the three kernels against their plain
    versions, then kernel, plain and library times beside the bounds."""
    import torch.nn.functional as F

    fa = flash_module()
    rows = []
    for case in FLASH_CASES:
        name, b, sq, sk, h, d, causal, masked, dtype_name = case
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device=dev).manual_seed(1)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)

        q, k, v, do = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d), \
            rnd(b, sq, h, d)
        kv = None
        keep = torch.ones((sq, sk), dtype=torch.bool, device=dev)
        if causal:
            keep = keep.tril()
        live = keep.any(-1).expand(b, sq)
        if masked:
            kv = (torch.rand((b, sk), generator=g, device=dev) > 0.3).float()
            kv[0] = 0.0                         # every key of row 0 masked
            kv[1, : sk // 2] = 0.0              # early rows of row 1 too
            live = (keep[None] & (kv[:, None, :] > 0)).any(-1)
        # a row with no live key emits a tile-dependent mean(V) under
        # causal: the loss gives it no weight, so neither does dO
        do = do * live[:, :, None, None].to(dtype)
        args = (causal, None, kv)
        out, lse = fa.flash_attention_fwd_lse(q, k, v, *args)
        out_r, lse_r = fa.flash_attention_fwd_lse_ref(q, k, v, *args)
        delta = fa._delta(out, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *args)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, *args)
        dk_r, dv_r = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                    *args)
        dq_r = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, *args)
        torch.cuda.synchronize()
        lse_rows = lse.reshape(b, h, sq).transpose(1, 2)[live]
        lse_rows_r = lse_r.reshape(b, h, sq).transpose(1, 2)[live]
        if not torch.isfinite(out).all():
            raise RuntimeError(f"flash {name}: non-finite output")
        errs = {
            "out": rel_err(torch, out[live], out_r[live]),
            "lse": rel_err(torch, lse_rows, lse_rows_r),
            "dq": rel_err(torch, dq, dq_r),
            "dk": rel_err(torch, dk, dk_r),
            "dv": rel_err(torch, dv, dv_r),
        }
        abs_err = {
            "flash_attention_fwd_lse": max(
                (out[live].float() - out_r[live].float()).abs().max().item(),
                (lse_rows - lse_rows_r).abs().max().item()),
            "flash_attention_bwd_dkv": max(
                (dk.float() - dk_r.float()).abs().max().item(),
                (dv.float() - dv_r.float()).abs().max().item()),
            "flash_attention_bwd_dq":
                (dq.float() - dq_r.float()).abs().max().item(),
        }
        tol = FLASH_REL[dtype_name]
        # lse is float32 on both sides whatever the inputs' type
        bad = {o: e for o, e in errs.items()
               if e > (FLASH_REL["float32"] if o == "lse" else tol)}
        ms = {
            "flash_attention_fwd_lse": timed_ms(
                torch, lambda: fa.flash_attention_fwd_lse(q, k, v, *args),
                flush),
            "flash_attention_bwd_dkv": timed_ms(
                torch, lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, *args), flush),
            "flash_attention_bwd_dq": timed_ms(
                torch, lambda: fa.flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, *args), flush),
        }
        plain_ms = {
            "flash_attention_fwd_lse": timed_ms(
                torch, lambda: fa.flash_attention_fwd_lse_ref(q, k, v, *args),
                flush),
            "flash_attention_bwd_dkv": timed_ms(
                torch, lambda: fa.flash_attention_bwd_dkv_ref(
                    q, k, v, do, lse, delta, *args), flush),
            "flash_attention_bwd_dq": timed_ms(
                torch, lambda: fa.flash_attention_bwd_dq_ref(
                    q, k, v, do, lse, delta, *args), flush),
        }
        library = {"sdpa_fwd_ms": None, "sdpa_bwd_ms": None}
        if kv is None:
            # the yardstick: one torch call for the same function, (B, H,
            # S, D) views; its causal mask is top-left aligned as ours
            lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            ldo = do.transpose(1, 2)

            def sdpa():
                return F.scaled_dot_product_attention(lq, lk, lv,
                                                      is_causal=causal)

            lout = sdpa()
            library["sdpa_fwd_ms"] = timed_ms(torch, sdpa, flush)
            library["sdpa_bwd_ms"] = timed_ms(
                torch, lambda: torch.autograd.grad(
                    lout, (lq, lk, lv), ldo, retain_graph=True), flush)
            del lout
        bounds = flash_bounds(torch, case, kv)
        # the unit SDPA's backward is compared with: both kernels together
        pair_ms = ms["flash_attention_bwd_dkv"] + ms["flash_attention_bwd_dq"]
        pair_ratio = (None if library["sdpa_bwd_ms"] is None
                      else pair_ms / library["sdpa_bwd_ms"])
        fwd_ratio = (None if library["sdpa_fwd_ms"] is None
                     else ms["flash_attention_fwd_lse"]
                     / library["sdpa_fwd_ms"])
        row = {"shape": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "D": d,
               "causal": causal, "kv_valid": masked, "dtype": dtype_name,
               "rel_err": errs, "tolerance": tol, "max_abs_err": abs_err,
               "ms": ms, "plain_ms": plain_ms, **library,
               "fwd_over_sdpa_fwd": fwd_ratio,
               "bwd_pair_ms": pair_ms, "bwd_pair_over_sdpa_bwd": pair_ratio,
               "bound_ms": {n: t for n, (t, _) in bounds.items()},
               "bound_by": {n: by for n, (_, by) in bounds.items()}}
        rows.append(row)
        log(f"flash {name}: rel err "
            + ", ".join(f"{o} {e:.2e}" for o, e in errs.items())
            + f" (tolerance {tol}); kernel ms "
            + ", ".join(f"{n.rsplit('_', 1)[-1]} {t:.4f}"
                        for n, t in ms.items())
            + "; plain ms "
            + ", ".join(f"{n.rsplit('_', 1)[-1]} {t:.4f}"
                        for n, t in plain_ms.items())
            + f"; sdpa fwd {library['sdpa_fwd_ms']} bwd "
              f"{library['sdpa_bwd_ms']} ms; fwd {fwd_ratio} x sdpa fwd; "
              f"dkv + dq {pair_ms:.4f} ms, {pair_ratio} x sdpa bwd; bound ms "
            + ", ".join(f"{n.rsplit('_', 1)[-1]} {t:.4f} ({by})"
                        for n, (t, by) in bounds.items()))
        if bad:
            raise RuntimeError(f"flash {name}: kernels differ from their "
                               f"plain versions: {bad} > {tol}")
        del q, k, v, do, out, out_r, dq, dk, dv, dq_r, dk_r, dv_r
        torch.cuda.empty_cache()
    return rows


def train_on_card(torch, fa, amp: bool = False):
    """Phase 7 (phase 14 with ``amp``): the port's training entry at full
    width, in-process. Returns ({kernel: launches}, [(train_loss,
    val_loss) per epoch], the step lines' samples/s, the final state's
    digests, which phase 18 holds its resumed run against)."""
    import contextlib
    import io

    out_dir = ROOT / "chiprun_out" / ("train_smoke_amp" if amp
                                      else "train_smoke")
    csv = out_dir / "metrics_rank0.csv"
    csv.unlink(missing_ok=True)                 # the CSV appends
    kernels = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    reset_staged(fa)
    stdout = io.StringIO()
    try:
        with contextlib.redirect_stdout(stdout):
            state = train_main(lm_train_flags(out_dir, amp))
    finally:
        print(stdout.getvalue(), end="", flush=True)
    launches = {fn.__name__: fn.launches for fn in kernels}
    if staged_copies(fa):
        raise RuntimeError(f"GPT-2 training staged {staged_copies(fa)} "
                           "copies of the flash inputs")
    log(f"GPT-2 training{' --amp' if amp else ''}: 0 staged copies of the "
        "flash inputs (TMA read the qkv views in place)")
    if amp and (state.model.dtype != torch.bfloat16 or any(
            p.dtype != torch.float32 for p in state.params)):
        raise RuntimeError("--amp did not build a bf16 model with float32 "
                           "parameters")
    digests = state_digests(state) if amp else None
    del state
    torch.cuda.synchronize()
    want = {"flash_attention_fwd_lse":
            DEPTH * (TRAIN_STEPS + EVAL_STEPS) * EPOCHS,
            "flash_attention_bwd_dkv": DEPTH * TRAIN_STEPS * EPOCHS,
            "flash_attention_bwd_dq": DEPTH * TRAIN_STEPS * EPOCHS}
    if launches != want:
        raise RuntimeError(f"training launched {launches}, expected {want}")
    lines = csv.read_text().splitlines()[1:]
    losses = [(float(ln.split(",")[1]), float(ln.split(",")[3]))
              for ln in lines]
    if len(losses) != EPOCHS or not all(
            math.isfinite(x) for pair in losses for x in pair):
        raise RuntimeError(f"training CSV rows {lines}: expected {EPOCHS} "
                           "finite (train, val) losses")
    if not losses[1][0] < losses[0][0]:
        raise RuntimeError(f"epoch 2's train loss {losses[1][0]} is not "
                           f"below epoch 1's {losses[0][0]}")
    rates = [float(ln.split("Throughput: ")[1].split()[0])
             for ln in stdout.getvalue().splitlines()
             if "Throughput: " in ln]
    return launches, losses, rates, digests


def lm_train_flags(out_dir: Path, amp: bool) -> list:
    """Phases 7 and 14's command line (phase 18 adds its checkpoint
    flags to the --amp one)."""
    return LM_FLAGS + ["--synthetic-size", "64", "--batch-size", "8",
                       "--epochs", str(EPOCHS), "--print-freq", "4",
                       "--output-dir", str(out_dir)] + (["--amp"] if amp
                                                        else [])


def grads_card_vs_cpu(torch, dev, dtype=None):
    """Phase 8 (phase 14 at ``dtype`` bf16): (loss |diff|, max over leaves
    of max|g diff| / max|g|, the leaf that gives it) for one
    loss-and-backward on a fixed batch."""
    import numpy as np

    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.ops import (
        make_flash_attention_fn,
    )
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        LanguageModelingTask,
    )

    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, VOCAB, (CPU_BATCH, CPU_SEQ)).astype(np.int32))
    dtype = dtype or torch.float32
    r = card_vs_cpu(
        torch, dev, lambda: get_model(
            MODEL, attention_fn=make_flash_attention_fn(True), dtype=dtype),
        LanguageModelingTask(compute_dtype=dtype),
        {"input_ids": ids, "weight": torch.ones(CPU_BATCH)})
    return (r["loss_abs_diff"], r["grad_rel"], r["grad_rel_leaf"],
            r["loss_card"], r["loss_cpu"])


def card_vs_cpu(torch, dev, make_model, task, batch, key=None) -> dict:
    """One loss-and-backward on ``batch`` from the same weights (seed 0),
    on the card (kernels) and on the CPU (plain versions): both losses,
    their |diff|, the worst leaf's max|g diff| / max|g| and that leaf."""
    results = []
    for device in (dev, torch.device("cpu")):
        model = make_model()
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(device)
        loss, _, _ = task.loss_and_metrics(
            model, {k: v.to(device) for k, v in batch.items()}, True,
            None, key)
        loss.backward()
        results.append((loss.item(), {
            n: p.grad.detach().cpu() for n, p in model.named_parameters()}))
        del model, loss
    (loss_c, g_c), (loss_h, g_h) = results
    worst, worst_leaf = 0.0, ""
    for name, ref in g_h.items():
        err = ((g_c[name] - ref).abs().max()
               / ref.abs().max().clamp(min=1e-30)).item()
        if not math.isfinite(err) or err > worst:
            worst, worst_leaf = err, name
    return {"loss_card": loss_c, "loss_cpu": loss_h,
            "loss_abs_diff": abs(loss_c - loss_h), "grad_rel": worst,
            "grad_rel_leaf": worst_leaf}


def sp_kernel_fields(name: str, flash_rows, sp: dict) -> dict:
    """The ring's and Ulysses' share of flash kernel ``name`` over phase 23
    (b)'s runs, both ranks (``ring_*``, ``ring_bf16_*``, ``ulysses_*``,
    ``ulysses_bf16_*``): launches, and time, plain time, bound and SDPA's
    time of each launch's shape summed over them. Rank r of the ring runs
    one diagonal block a pass (the ``ring diagonal`` shape) and r past
    blocks (the full 512 x 512 block, ``bert non-causal``'s shape)."""
    shape = {r["shape"]: r for r in flash_rows}
    out = {}
    for mode in ("ring", "ulysses"):
        for tag, suffix, prefix in (("fp32", "", f"{mode}_"),
                                    ("amp", " bf16", f"{mode}_bf16_")):
            shares = []
            for r, counts in enumerate(sp[f"{mode} {tag}"][
                    "launches_per_rank"]):
                n = counts[name]
                if mode == "ring":
                    diag = n // (r + 1)
                    shares += [(shape["ring diagonal" + suffix], diag),
                               (shape["bert non-causal" + suffix], n - diag)]
                else:
                    shares.append((shape["ulysses" + suffix], n))
            out[prefix + "launches"] = sum(n for _, n in shares)
            for key in ("ms", "plain_ms", "bound_ms"):
                out[prefix + key] = sum(row[key][name] * n
                                        for row, n in shares)
            out[prefix + "library_ms"] = sum(
                (row["sdpa_fwd_ms"] if name.endswith("fwd_lse")
                 else row["sdpa_bwd_ms"]) * n for row, n in shares)
    return out


def flash_kernel_rows(flash_rows, launches, bf16_launches,
                      bf16_trace_ms, bert_launches, bert_bf16_launches,
                      sp: dict) -> list:
    """The kernels line's rows of K3, K4 and K5 over their main paths:
    GPT-2's causal training (phase 7, ``launches``, at the main fp32
    shape) and BERT's bidirectional training (phase 22 (a),
    ``bert_launches``, at the BERT shape): times, plain times, bounds and
    SDPA's times of each launch's shape summed over its launches, BERT's
    share also apart (``bert_*``); errors over every float32 shape
    checked; the ``bf16_`` fields the same over the ``--amp`` runs
    (phases 14 and 22 (a)) at the bf16 shapes, with ``bf16_trace_ms``,
    the mean device ms a launch that phase 20's trace of the GPT-2
    ``--amp`` step read (no host launch time in it); the ring's and
    Ulysses' launches of phase 23 (b) apart (``sp_kernel_fields``)."""
    main, main_bf16 = flash_rows[0], flash_rows[1]
    if (main["dtype"], main_bf16["dtype"]) != ("float32", "bfloat16"):
        raise RuntimeError("FLASH_CASES must start with main fp32, bf16")
    bert = {r["dtype"]: r for r in flash_rows
            if r["shape"].startswith("bert")}
    replaces = {
        "flash_attention_fwd_lse": 199,   # _flash_fwd_lse (_fwd_kernel)
        "flash_attention_bwd_dkv": 360,   # _flash_bwd (_bwd_dkv_kernel)
        "flash_attention_bwd_dq": 360,    # _flash_bwd (_bwd_dq_kernel)
    }

    def library(row, name):
        # scaled_dot_product_attention's forward for K3; its backward (dq,
        # dk and dv together) for K4 and K5 alike: it computes both
        # kernels' function at once, so the unit compared with it is the
        # pair K4 + K5, not either row alone
        return row["sdpa_fwd_ms"] if name.endswith("fwd_lse") \
            else row["sdpa_bwd_ms"]

    def summed(name, shares, prefix=""):
        return {prefix + "launches": sum(n for _, n in shares),
                prefix + "ms": sum(r["ms"][name] * n for r, n in shares),
                prefix + "plain_ms": sum(r["plain_ms"][name] * n
                                         for r, n in shares),
                prefix + "bound_ms": sum(r["bound_ms"][name] * n
                                         for r, n in shares),
                prefix + "library_ms": sum(library(r, name) * n
                                           for r, n in shares)}

    rows = []
    for name, line in replaces.items():
        fp32 = [(main, launches[name]), (bert["float32"], bert_launches[name])]
        bf16 = [(main_bf16, bf16_launches[name]),
                (bert["bfloat16"], bert_bf16_launches[name])]
        rows.append({
            "name": name, "route": "cuda",
            # every kernel is a wgmma kernel fed by TMA: float32 ones
            # 3xTF32 in their own source
            "source": f"{PACKAGE}/csrc/flash_attention_sm90_tf32.cu",
            "bf16_source": f"{PACKAGE}/csrc/flash_attention_sm90.cu",
            "replaces": "distributed_pytorch_training_tpu/ops/"
                        f"flash_attention.py:{line}",
            **summed(name, fp32),
            "max_abs_err": max(r["max_abs_err"][name] for r in flash_rows
                               if r["dtype"] == "float32"),
            "bound_by": main["bound_by"][name],
            **summed(name, fp32[1:], "bert_"),
            **summed(name, bf16, "bf16_"),
            "bf16_max_abs_err": max(r["max_abs_err"][name] for r, _ in bf16),
            "bf16_bound_by": main_bf16["bound_by"][name],
            **summed(name, bf16[1:], "bert_bf16_"),
            "bf16_trace_ms_per_launch": bf16_trace_ms[name],
            **sp_kernel_fields(name, flash_rows, sp),
        })
    return rows


def wire_launches(torch, wire: str, cap: float, n: int = DP_RANKS,
                  params: int = RESNET18_PARAMS) -> dict:
    """{(kernel, (rows, width)): launches} of one reducer step on a flat
    gradient of ``params`` floats (ResNet-18's by default): per bucket of
    S elements, ``int8`` runs K1 on (1, S) and K2 on (n, S);
    ``int8_multihop`` K1 on (n, S/n) and (1, S/n) and K2 on (n, S/n), S
    padded to a multiple of n."""
    from distributed_pytorch_training_tpu_torch.parallel.grad_sync import (
        build_bucket_plan,
    )

    plan = build_bucket_plan([torch.empty(params, device="meta")], cap)
    counts: dict = {}
    for size in plan.bucket_sizes():
        if wire == "int8":
            keys = [(QUANTIZE, (1, size)), (DEQUANT, (n, size))]
        else:
            chunk = -(-size // n)
            keys = [(QUANTIZE, (n, chunk)), (QUANTIZE, (1, chunk)),
                    (DEQUANT, (n, chunk))]
        for key in keys:
            counts[key] = counts.get(key, 0) + 1
    return counts


def codec_rows(torch, dev, shape, seed: int):
    """(n, s) float32 rows of spread magnitudes on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n, _ = shape
    return torch.randn(shape, generator=g, device=dev) * (
        torch.rand((n, 1), generator=g, device=dev) * 10 + 0.01)


def bound_of(nbytes: float, ops: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the float32 operations over the float32 rate."""
    t_bytes = nbytes / BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_wire_codec(torch, dev, flush):
    """Phase 9: K1 and K2 at every shape the reducer gives them on 2 ranks
    (DP_RUNS, and BERT's one int8 bucket of phase 22 (e)), then K1 and K2
    at edge shapes: each BITWISE against its
    plain version, timed beside its bound, the plain version and, for K2,
    the composite ``scales @ q.float()`` (a cast and a GEMV; no single
    PyTorch call takes int8 codes). Returns ({(kernel, shape): row}, K1
    edge rows, K2 edge rows)."""
    from distributed_pytorch_training_tpu_torch.experiments import (
        flash_timers,
    )
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        dequant_plan,
        dequant_sum_rows,
        dequant_sum_rows_ref,
        quantize_int8_rows,
        quantize_int8_rows_ref,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    keys = sorted({key for _, wire, cap in DP_RUNS
                   for key in wire_launches(torch, wire, cap)}
                  | set(wire_launches(torch, "int8", 0.0,
                                      params=BERT_PARAMS)))
    main_rows, edges = {}, []

    def dequant_row(label, q, s):
        out = dequant_sum_rows(q, s)
        ref = dequant_sum_rows_ref(q, s)
        torch.cuda.synchronize()
        same = torch.equal(out.view(torch.int32), ref.view(torch.int32))
        n, w = q.shape
        bound, by = bound_of(n * w + 4 * n + 4 * w, 2 * n * w)
        row = {"kernel": DEQUANT, "shape": label, "bitwise": same,
               "max_abs_err": (out - ref).abs().max().item(),
               "variant": ("staged" if dequant_plan(n, w, sms).staged
                           else "generic"),
               "ms": timed_ms(torch, lambda: dequant_sum_rows(q, s), flush),
               # the card's time alone: flash_timers' guarded timer
               "device_ms": flash_timers._timed(
                   torch, lambda: dequant_sum_rows(q, s), flush, guard=True),
               "plain_ms": timed_ms(
                   torch, lambda: dequant_sum_rows_ref(q, s), flush),
               "composite_ms": timed_ms(torch, lambda: s @ q.float(), flush),
               "bound_ms": bound, "bound_by": by}
        log(f"{DEQUANT} {label}: bitwise={same} {row['variant']} kernel "
            f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, composite scales @ q.float() "
            f"{row['composite_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
        if not same:
            raise RuntimeError(f"{DEQUANT} {label}: kernel differs from its "
                               f"plain version (max err {row['max_abs_err']})")
        return row

    def quantize_row(label, x):
        q, s = quantize_int8_rows(x)
        qr, sr = quantize_int8_rows_ref(x)
        torch.cuda.synchronize()
        same = (torch.equal(q, qr)
                and torch.equal(s.view(torch.int32), sr.view(torch.int32)))
        n, w = x.shape
        bound, by = bound_of(5 * n * w + 4 * n, 5 * n * w)
        row = {"kernel": QUANTIZE, "shape": label, "bitwise": same,
               "max_abs_err": max((q.int() - qr.int()).abs().max().item(),
                                  (s - sr).abs().max().item()),
               "ms": timed_ms(torch, lambda: quantize_int8_rows(x), flush),
               "plain_ms": timed_ms(
                   torch, lambda: quantize_int8_rows_ref(x), flush),
               "bound_ms": bound, "bound_by": by}
        log(f"{QUANTIZE} {label}: bitwise={same} kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
        if not same:
            raise RuntimeError(f"{QUANTIZE} {label}: kernel differs from "
                               "its plain version")
        return row

    for seed, (kernel, shape) in enumerate(keys):
        label = f"{shape[0]}x{shape[1]}"
        x = codec_rows(torch, dev, shape, seed)
        if kernel == DEQUANT:
            main_rows[(kernel, shape)] = dequant_row(
                label, *quantize_int8_rows_ref(x))
        else:
            main_rows[(kernel, shape)] = quantize_row(f"{label} (wire)", x)
        del x

    # K1 on a long row split over many blocks: a width that leaves a scalar
    # tail, and an all-zero row (the scale floor)
    quantize_edges = [
        quantize_row("1x4000037", codec_rows(torch, dev, (1, 4_000_037), 9)),
        quantize_row("1x4000037 zero row",
                     torch.zeros((1, 4_000_037), device=dev))]
    for label, shape in [("1x4097", (1, 4097)), ("3x100003", (3, 100_003)),
                         ("8x65536", (8, 65_536)), ("2x1", (2, 1)),
                         ("2x4099", (2, 4099)), ("9x4099", (9, 4099))]:
        edges.append(dequant_row(label, *quantize_int8_rows_ref(
            codec_rows(torch, dev, shape, 7))))
    q, _ = quantize_int8_rows_ref(codec_rows(torch, dev, (2, 1000), 8))
    edges.append(dequant_row("2x1000 zero scales", q,
                             torch.zeros(2, device=dev)))
    return main_rows, quantize_edges, edges


def reducer_rank(rank: int, store: str, out_dir: str) -> None:
    """Phase 10, one of DP_RANKS processes (gloo, both on cuda:0): for each
    DP_RUNS configuration, two ``reduce_flat`` calls on a seeded
    11,181,642-float contribution and residual, on the card and on the
    CPU; writes the launches, whether the card's sums and residuals are
    bitwise the CPU's, the sums' digest and the card's wall time."""
    import hashlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        dequant_sum_rows,
        quantize_int8_rows,
    )
    from distributed_pytorch_training_tpu_torch.parallel.collectives import (
        all_gather,
        all_to_all,
        psum,
    )
    from distributed_pytorch_training_tpu_torch.parallel import (
        grad_sync as gs,
    )

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=DP_RANKS)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    g = torch.Generator().manual_seed(1000 + rank)
    flat = torch.randn(RESNET18_PARAMS, generator=g) * (1 + rank)
    report = {}
    for name, wire, cap in DP_RUNS:
        plan = gs.build_bucket_plan([flat], cap)
        ef0 = gs.ef_state_bucketed([flat], DP_RANKS, cap, wire)["ef"]
        ef0 = torch.randn(ef0.shape, generator=g) * 0.01
        results = {}
        for device in (dev, torch.device("cpu")):
            before = (quantize_int8_rows.launches, dequant_sum_rows.launches)
            x, ef, sums, efs = flat.to(device), ef0.to(device), [], []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                out, ef = gs.reduce_flat(x, plan, DP_RANKS, wire, ef)
                sums.append(out)
                efs.append(ef)
            torch.cuda.synchronize()
            results[device.type] = (
                [t.cpu() for t in sums], [t.cpu() for t in efs],
                (time.perf_counter() - t0) / 2,
                (quantize_int8_rows.launches - before[0],
                 dequant_sum_rows.launches - before[1]))
        (sc, ec, sec, (k1, k2)), (sh, eh, _, _) = results["cuda"], \
            results["cpu"]
        report[name] = {
            "buckets": plan.n_buckets,
            "launches": {QUANTIZE: k1, DEQUANT: k2},
            "bitwise": all(torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in zip(sc + ec, sh + eh)),
            "sum_sha256": hashlib.sha256(sc[-1].numpy().tobytes()
                                         ).hexdigest(),
            "card_ms_per_call": sec * 1e3,
        }
    def host_ms(fn, reps: int = 3) -> float:
        """Mean host-clock ms of ``fn()`` between synchronizations, after
        one warm-up call (both ranks call it together)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    # the collectives alone at the one-bucket sizes (gloo stages CUDA
    # tensors through host memory), then one int8 one-bucket call step by
    # step, as _compressed_psum runs it
    codes = torch.zeros(RESNET18_PARAMS, dtype=torch.int8, device=dev)
    floats = torch.zeros(RESNET18_PARAMS, device=dev)
    moments = torch.zeros((2, 512), device=dev)
    report["collectives_ms"] = {
        "all_gather int8": host_ms(lambda: all_gather(codes)),
        "all_to_all int8": host_ms(lambda: all_to_all(codes)),
        "all_reduce fp32": host_ms(lambda: psum(floats)),
        # one global-batch BatchNorm's moments (ResNet-18's widest), the
        # all-reduce the implicit path makes 20 times forward and 20
        # times backward in every step
        "all_reduce fp32 2x512": host_ms(lambda: psum(moments), reps=20)}
    carried = flat.to(dev)
    q, scale = gs._quantize_int8(carried)
    gathered, scales = all_gather(q), all_gather(scale.reshape(1))
    report["int8_call_steps_ms"] = {
        "quantize (K1)": host_ms(lambda: gs._quantize_int8(carried)),
        "all_gather codes": host_ms(lambda: all_gather(q)),
        "all_gather scale": host_ms(lambda: all_gather(scale.reshape(1))),
        "dequant-sum (K2)": host_ms(lambda: gs._dequant_sum_rows(
            gathered.reshape(DP_RANKS, -1), scales)),
        "residual": host_ms(lambda: gs._residual(carried, q, scale))}
    dist.destroy_process_group()
    (Path(out_dir) / f"reducer_rank{rank}.json").write_text(
        json.dumps(report, indent=1))


def reducer_card_vs_cpu(torch) -> dict:
    """Phase 10: DP_RANKS reducer processes on the one card; checks that
    every rank's card sums and residuals are bitwise its CPU's, that the
    ranks hold the same sums, and the launch counts."""
    import tempfile

    import torch.multiprocessing as mp

    out_dir = ROOT / "chiprun_out" / "reducer"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(reducer_rank, args=(f"{tmp}/store", str(out_dir)),
                           nprocs=DP_RANKS, start_method="spawn")
    ranks = [json.loads((out_dir / f"reducer_rank{r}.json").read_text())
             for r in range(DP_RANKS)]
    for name, wire, cap in DP_RUNS:
        per_call = {QUANTIZE: 0, DEQUANT: 0}
        for (kernel, _), count in wire_launches(torch, wire, cap).items():
            per_call[kernel] += count
        want = {k: 2 * v for k, v in per_call.items()}
        for r, rep in enumerate(ranks):
            got = rep[name]
            if got["launches"] != want or not got["bitwise"]:
                raise RuntimeError(
                    f"reducer {name} rank {r}: launches {got['launches']} "
                    f"(expected {want}), card bitwise the CPU's: "
                    f"{got['bitwise']}")
        if len({rep[name]["sum_sha256"] for rep in ranks}) != 1:
            raise RuntimeError(f"reducer {name}: the ranks' sums differ")
    return ranks[0]


def image_csv_losses(out_dir: Path) -> list:
    """(train_loss, val_loss, epoch_time) per epoch of a run's CSV; fails
    unless there are IMAGE_EPOCHS finite rows and the train loss fell."""
    lines = (out_dir / "metrics_rank0.csv").read_text().splitlines()[1:]
    rows = [(float(c[1]), float(c[3]), float(c[5]))
            for c in (ln.split(",") for ln in lines)]
    if len(rows) != IMAGE_EPOCHS or not all(
            math.isfinite(x) for row in rows for x in row):
        raise RuntimeError(f"{out_dir.name}: CSV rows {lines}, expected "
                           f"{IMAGE_EPOCHS} finite ones")
    if not rows[-1][0] < rows[0][0]:
        raise RuntimeError(f"{out_dir.name}: the train loss did not fall "
                           f"({rows})")
    return rows


def resnet_one_rank(torch) -> dict:
    """Phase 11: ResNet-18 at full width on one rank through
    ``train.main``: no Pallas kernel on this path, so no launch count."""
    from distributed_pytorch_training_tpu_torch.data.datasets import (
        get_dataset,
    )
    from distributed_pytorch_training_tpu_torch.data.loader import (
        ShardedLoader,
    )

    out_dir = ROOT / "chiprun_out" / "resnet_1rank"
    (out_dir / "metrics_rank0.csv").unlink(missing_ok=True)
    state = train_main(IMAGE_FLAGS + [
        "--synthetic-size", str(ONE_RANK_SYNTHETIC), "--output-dir",
        str(out_dir)])
    torch.cuda.synchronize()
    if state.param_count() != RESNET18_PARAMS:
        raise RuntimeError(f"ResNet-18 has {state.param_count()} params")
    rows = image_csv_losses(out_dir)
    # the loader alone: one epoch's host gathers and pinned copies
    loader = ShardedLoader(get_dataset(
        "cifar10", train=True, synthetic=True,
        synthetic_size=ONE_RANK_SYNTHETIC, seed=42), IMAGE_BATCH,
        shuffle=True, device=torch.device("cuda", 0))
    t0 = time.perf_counter()
    for batch in loader.epoch(0):
        pass
    torch.cuda.synchronize()
    return {"losses": rows, "steps": state.step,
            "samples_per_s_epoch2": ONE_RANK_SYNTHETIC / rows[-1][2],
            "loader_ms_per_batch": (time.perf_counter() - t0) / len(loader)
            * 1e3}


# dp_worker's arguments hold one run or several, separated by RUN_SEP;
# rank 0 prints RUN_MARK and the run's output directory before each
RUN_SEP, RUN_MARK = "--then", "chip_smoke: dp run "


def dp_worker(argv) -> int:
    """One torchrun rank of phases 12, 13, 15 and 19: ``train.main`` for
    each run of ``argv`` (an output directory and the entry's flags; runs
    separated by RUN_SEP, the process group kept between them) with the
    launch counts set to 0 just before and read just after; writes, into
    each run's directory, them, the step count, the run's wall seconds
    and a sha256 of each parameter and BatchNorm statistic (the ranks'
    states are bitwise equal iff every digest is), and of its
    error-feedback residual."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from distributed_pytorch_training_tpu_torch import train
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        dequant_sum_rows,
        quantize_int8_rows,
    )
    from distributed_pytorch_training_tpu_torch.training import Trainer

    fa = flash_module()
    kernels = {QUANTIZE: quantize_int8_rows, DEQUANT: dequant_sum_rows,
               **{name: getattr(fa, name) for name in FLASH}}
    runs = [[]]
    for arg in argv:
        if arg == RUN_SEP:
            runs.append([])
        else:
            runs[-1].append(arg)
    rank = int(os.environ["RANK"])
    torch.backends.cudnn.deterministic = CUDNN_DETERMINISTIC
    # the model-shaped state each rank evaluates with, digested after the
    # last evaluation (every rank evaluates at every epoch's end): under
    # explicit FSDP the parameters exist whole only inside the trainer's
    # gather
    evaluated = {}
    evaluate = Trainer.evaluate

    def digesting_evaluate(self, state, batches):
        out = evaluate(self, state, batches)
        with self.materialized(state):
            evaluated.update({k: tensor_digest(v) for k, v in
                              state.model.state_dict().items()})
        return out

    cleanup = train.cleanup_distributed
    Trainer.evaluate = digesting_evaluate
    train.cleanup_distributed = lambda: None    # one group for every run
    try:
        for out_dir, *train_argv in runs:
            if rank == 0:
                print(RUN_MARK + out_dir, flush=True)
            evaluated.clear()
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            state = train_main(train_argv + ["--output-dir", out_dir])
            seconds = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in kernels.items()}
            digests = evaluated or {k: tensor_digest(v) for k, v in
                                    state.model.state_dict().items()}
            # this rank's own error-feedback residuals (int8 wires; they
            # differ across ranks, so kept apart from the digests the
            # ranks must share)
            ef = state.grad_sync.get("ef")
            ef = ef if isinstance(ef, dict) else (
                {"ef": ef} if ef is not None else {})
            ef_digests = {k: tensor_digest(v) for k, v in ef.items()}
            # at rest: the parameters (FSDP: this rank's chunks) and every
            # optimizer tensor of a leaf or chunk
            at_rest = {"params": [p.numel() for p in state.params],
                       "param_bytes": sum(p.numel() * p.element_size()
                                          for p in state.params),
                       "opt": [t.numel() for slots in
                               state.optimizer.state.values()
                               for t in slots.values() if t.dim() >= 1]}
            (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(
                {"launches": launches, "steps": state.step,
                 "digests": digests, "ef_digests": ef_digests,
                 "at_rest": at_rest, "seconds": seconds}))
            del state
    finally:
        Trainer.evaluate = evaluate
        train.cleanup_distributed = cleanup
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def same_across_ranks(name: str, ranks: list) -> None:
    """Fail unless every rank's parameters and statistics have rank 0's
    digests."""
    for key, digest in ranks[0]["digests"].items():
        if any(r["digests"][key] != digest for r in ranks[1:]):
            raise RuntimeError(f"{name}: {key} differs across ranks")


def run_torchrun(args, timeout: float, nproc: int = DP_RANKS,
                 mode: str = "--dp-worker") -> str:
    """``torchrun --standalone --nproc-per-node nproc chip_smoke.py
    --dp-worker ...`` (or another worker ``mode``) in a session of its
    own, killed whole on a timeout; returns its output and fails unless it
    exited 0."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), str(Path(__file__).resolve()),
           mode, *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=ROOT,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"torchrun timed out after {timeout} s: {cmd}")
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun exited {proc.returncode}:\n{out}")
    return out


def dp_runs(torch, runs: list, nproc: int = DP_RANKS) -> dict:
    """One torchrun of the port's entry on ``nproc`` ranks sharing the
    card for every (name, flags, synthetic size, launches wanted, steps)
    of ``runs``, in one process group (phases 12, 13 and 19): every
    rank's launches of the kernels wanted exact, the ranks' evaluated
    parameters and statistics bitwise equal. Returns {name: the run's
    results}."""
    dirs, args = {}, []
    for name, flags, synthetic, _, _ in runs:
        out_dir = ROOT / "chiprun_out" / ("dp_" + name.replace(" ", "_"))
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "metrics_rank0.csv").unlink(missing_ok=True)
        dirs[name] = out_dir
        args += ([RUN_SEP] if args else []) + [
            str(out_dir), *flags, "--synthetic-size", str(synthetic)]
    t0 = time.perf_counter()
    out = run_torchrun(args, timeout=600 * len(runs), nproc=nproc)
    seconds = time.perf_counter() - t0
    # rank 0's lines of each run, from its mark to the next
    pieces = {}
    for line in out.splitlines():
        if line.startswith(RUN_MARK):
            current = pieces.setdefault(line[len(RUN_MARK):], [])
        elif pieces:
            current.append(line)
    results = {}
    for name, _, _, want, steps in runs:
        out_dir = dirs[name]
        text = "\n".join(pieces.get(str(out_dir), []))
        (out_dir / "stdout.txt").write_text(text)
        ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
                 for r in range(nproc)]
        for r, rep in enumerate(ranks):
            got = {k: rep["launches"][k] for k in want}
            if got != want or rep["steps"] != steps:
                raise RuntimeError(f"{name} rank {r}: {rep['steps']} "
                                   f"steps, launches {got} (expected "
                                   f"{steps}, {want})")
        same_across_ranks(name, ranks)
        rates = [float(ln.split("Throughput: ")[1].split()[0])
                 for ln in text.splitlines() if "Throughput: " in ln]
        results[name] = {
            "ranks": ranks, "out_dir": out_dir,
            "wall_seconds": ranks[0]["seconds"],
            "torchrun_seconds": seconds, "step_line_samples_per_s": rates,
            "launches_per_rank": want, "steps": steps, "stdout": text}
    return results


def resnet_two_ranks(torch) -> dict:
    """Phase 12: ResNet-18 at full width on DP_RANKS ranks sharing the
    card (gloo) through the port's entry, once per DP_RUNS configuration.
    Checks every rank's K1 and K2 launches against steps x the wire's
    per-step count, that the ranks end with bitwise-equal parameters and
    BatchNorm statistics, and that the loss fell."""
    steps = IMAGE_EPOCHS * -(-DP_SYNTHETIC // (IMAGE_BATCH * DP_RANKS))
    report, wants = {}, {}
    for name, wire, cap in DP_RUNS:
        wants[name] = {QUANTIZE: 0, DEQUANT: 0}
        for (kernel, _), count in wire_launches(torch, wire, cap).items():
            wants[name][kernel] += count * steps
    results = dp_runs(torch, [
        (name, IMAGE_FLAGS + ["--wire-dtype", wire, "--bucket-cap-mb",
                              str(cap)], DP_SYNTHETIC, wants[name], steps)
        for name, wire, cap in DP_RUNS])
    for name, wire, cap in DP_RUNS:
        res, want = results[name], wants[name]
        losses = image_csv_losses(res["out_dir"])
        rates = res["step_line_samples_per_s"]
        report[name] = {"wire": wire, "bucket_cap_mb": cap, "steps": steps,
                        "launches_per_rank": want, "losses": losses,
                        "step_line_samples_per_s": rates,
                        "wall_seconds": res["wall_seconds"]}
        log(f"phase 12 {name}: {steps} steps on {DP_RANKS} ranks, launches "
            f"per rank {want}; parameters and BatchNorm statistics bitwise "
            f"equal across ranks; (train, val, epoch s) per epoch {losses}; "
            f"step-line samples/s {rates} (2 ranks share one card over "
            "gloo: not a scaling number)")
    return report


def resnet_reference_command(torch) -> dict:
    """Phase 13 (A): ResNet-18 at full width on DP_RANKS ranks sharing the
    card through ``torchrun`` with the reference's default flags (the
    implicit path: global-batch BatchNorm, one fp32 all-reduce), in fp32
    and with ``--amp``. No kernel of the port runs on this path (K1 and K2
    must not launch); the ranks must end bitwise equal and the loss must
    fall."""
    steps = IMAGE_EPOCHS * -(-DP_SYNTHETIC // (IMAGE_BATCH * DP_RANKS))
    report = {}
    configs = (("implicit fp32", []), ("implicit amp", ["--amp"]))
    none = {k: 0 for k in (QUANTIZE, DEQUANT, *FLASH)}
    results = dp_runs(torch, [(name, IMAGE_FLAGS + extra, DP_SYNTHETIC,
                               none, steps) for name, extra in configs])
    for name, extra in configs:
        res = results[name]
        banner = (f"world_size={DP_RANKS}, amp={bool(extra)}, "
                  "backend=gloo")
        if banner not in res["stdout"] or "Gradient sync" in res["stdout"]:
            raise RuntimeError(f"{name}: expected the implicit path's "
                               f"banner ({banner}), got:\n{res['stdout']}")
        losses = image_csv_losses(res["out_dir"])
        rates = res["step_line_samples_per_s"]
        report[name] = {"steps": steps, "losses": losses,
                        "step_line_samples_per_s": rates,
                        "wall_seconds": res["wall_seconds"]}
        log(f"phase 13 {name}: {steps} steps on {DP_RANKS} ranks, no "
            "kernel launched; parameters and BatchNorm statistics bitwise "
            f"equal across ranks; (train, val, epoch s) per epoch {losses}; "
            f"step-line samples/s {rates} (2 ranks share one card over "
            "gloo: not a scaling number)")
    return report


def gpt2_two_ranks(torch) -> dict:
    """Phase 15 (C): GPT-2 124M at full width on DP_RANKS ranks sharing
    the card through ``torchrun`` (implicit fp32 path, flash attention):
    every rank's K3-K5 launches exact, the ranks bitwise equal."""
    out_dir = ROOT / "chiprun_out" / "dp_gpt2"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "metrics_rank0.csv").unlink(missing_ok=True)
    t0 = time.perf_counter()
    out = run_torchrun([str(out_dir), *LM_FLAGS, "--synthetic-size",
                        str(LM_DP_SYNTHETIC), "--batch-size",
                        str(LM_DP_BATCH), "--epochs", "1", "--print-freq",
                        "2"], timeout=600)
    seconds = time.perf_counter() - t0
    (out_dir / "stdout.txt").write_text(out)
    want = {FLASH[0]: DEPTH * (LM_DP_STEPS + LM_DP_EVAL),
            FLASH[1]: DEPTH * LM_DP_STEPS, FLASH[2]: DEPTH * LM_DP_STEPS}
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(DP_RANKS)]
    for r, rep in enumerate(ranks):
        got = {k: rep["launches"][k] for k in FLASH}
        if got != want or rep["steps"] != LM_DP_STEPS:
            raise RuntimeError(f"GPT-2 rank {r}: {rep['steps']} steps, "
                               f"launches {got} (expected {LM_DP_STEPS}, "
                               f"{want})")
    same_across_ranks("GPT-2 on 2 ranks", ranks)
    lines = (out_dir / "metrics_rank0.csv").read_text().splitlines()[1:]
    losses = [(float(c[1]), float(c[3])) for c in
              (ln.split(",") for ln in lines)]
    if len(losses) != 1 or not all(math.isfinite(x) for x in losses[0]):
        raise RuntimeError(f"GPT-2 on 2 ranks: CSV rows {lines}")
    rates = [float(ln.split("Throughput: ")[1].split()[0])
             for ln in out.splitlines() if "Throughput: " in ln]
    return {"launches_per_rank": want, "losses": losses,
            "step_line_samples_per_s": rates, "wall_seconds": seconds}


# phase 18: sigterm@step=4 fires at the fence before step 4, which still
# runs, so the preempted run stops with 5 steps done (epoch 0, step 5 of
# 8); crash@step=15 is epoch 1's step 3 of 12, after the epoch-0 save that
# torn_ckpt@save=1 tears, so the restart skips it and starts afresh
PREEMPT_AT, CRASH_AT = 4, 15


def save_instruments(out: str) -> dict:
    """The entry's ``Checkpointing:`` log line (rank 0's) as numbers."""
    import re

    m = re.search(r"Checkpointing: blocked ([\d.]+)ms total \(snapshot "
                  r"([\d.]+)ms\) across (\d+) save\(s\); wrote (\d+) "
                  r"bytes, sha256 ([\d.]+)ms", out)
    if m is None:
        raise RuntimeError("the run logged no Checkpointing line")
    return {"save_blocked_ms": float(m[1]), "snapshot_ms": float(m[2]),
            "saves": int(m[3]), "bytes": int(m[4]), "hash_ms": float(m[5])}


def gpt2_preempt_resume(torch, fa, want_launches, want_digests):
    """Phase 18 (a): phase 14's command with ``--checkpoint-dir``, run B
    preempted by ``--chaos sigterm@step=4``, then run C with
    ``--resume``. B must leave one checkpoint at epoch 0 step 5 and no CSV
    row; B and C together must launch K3-K5 as phase 14 did, and C must
    end with parameters and AdamW moments bitwise phase 14's. Returns run
    C's state, its checkpoint directory and the report."""
    import contextlib
    import io
    import shutil

    out_dir = ROOT / "chiprun_out" / "ckpt_gpt2"
    shutil.rmtree(out_dir, ignore_errors=True)
    ckpt_dir = out_dir / "ckpt"
    flags = lm_train_flags(out_dir, amp=True) + ["--checkpoint-dir",
                                                 str(ckpt_dir)]
    kernels = (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dkv,
               fa.flash_attention_bwd_dq)
    for fn in kernels:
        fn.launches = 0
    report, cut = {}, PREEMPT_AT + 1
    state = None
    for run, extra in (("B", ["--chaos", f"sigterm@step={PREEMPT_AT}"]),
                       ("C", ["--resume"])):
        del state
        stdout = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(stdout):
                state = train_main(flags + extra)
        finally:
            print(stdout.getvalue(), end="", flush=True)
        out = stdout.getvalue()
        report[run] = {"wall_seconds": time.perf_counter() - t0,
                       "steps": state.step, **save_instruments(out)}
        if run == "B":
            labels = sorted(int(p.name) for p in ckpt_dir.iterdir()
                            if p.name.isdigit())
            manifest = json.loads(
                (ckpt_dir / ".manifests" / f"{cut}.json").read_text())
            rows = (out_dir / "metrics_rank0.csv").read_text().splitlines()
            if (state.step != cut or labels != [cut]
                    or (manifest["epoch"], manifest["step_in_epoch"])
                    != (0, cut) or len(rows) != 1
                    or f"Preempted: checkpointed epoch 0 step {cut}/"
                       f"{TRAIN_STEPS}" not in out):
                raise RuntimeError(
                    f"run B: {state.step} steps, checkpoints {labels}, "
                    f"manifest (epoch {manifest['epoch']}, step_in_epoch "
                    f"{manifest['step_in_epoch']}), CSV {rows}; expected "
                    f"{cut} steps, one checkpoint at epoch 0 step {cut}, "
                    "the CSV header alone")
            report["B"]["manifest"] = {k: manifest[k] for k in (
                "label", "step", "epoch", "step_in_epoch", "tree_digest")}
        elif f"Resumed from epoch 0 step {cut}" not in out:
            raise RuntimeError("run C did not resume at epoch 0 step "
                               f"{cut}")
    launches = {fn.__name__: fn.launches for fn in kernels}
    if launches != want_launches:
        raise RuntimeError(f"runs B and C launched {launches}, phase 14 "
                           f"{want_launches}")
    got = state_digests(state)
    differ = sorted(k for k in want_digests if got.get(k) != want_digests[k])
    if state.step != EPOCHS * TRAIN_STEPS or got.keys() != \
            want_digests.keys() or differ:
        raise RuntimeError(f"run C ({state.step} steps) differs from phase "
                           f"14's uninterrupted run in {len(differ)} "
                           f"tensors, e.g. {differ[:5]}")
    rows = (out_dir / "metrics_rank0.csv").read_text().splitlines()[1:]
    if [r.split(",")[0] for r in rows] != ["1", "2"]:
        raise RuntimeError(f"runs B and C wrote CSV rows {rows}")
    report["launches"] = launches
    report["bitwise_tensors"] = len(got)
    return state, ckpt_dir, report


def resnet_chaos_two_ranks(torch) -> dict:
    """Phase 18 (b): phase 12's int8 one-bucket configuration under
    ``--max-restarts 2 --chaos crash@step=15,torn_ckpt@save=1``: one
    restart, one torn checkpoint skipped, each rank's K1 and K2 launches
    the steps executed (replays included) times the wire's count a step,
    and each rank's parameters, BatchNorm statistics and residual bitwise
    its phase 12 counterpart's."""
    import shutil

    wire, cap = "int8", 0.0
    out_dir = ROOT / "chiprun_out" / "dp_int8_chaos"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    spe = -(-DP_SYNTHETIC // (IMAGE_BATCH * DP_RANKS))
    executed = IMAGE_EPOCHS * spe + CRASH_AT
    t0 = time.perf_counter()
    out = run_torchrun([str(out_dir), *IMAGE_FLAGS, "--synthetic-size",
                        str(DP_SYNTHETIC), "--wire-dtype", wire,
                        "--bucket-cap-mb", str(cap), "--checkpoint-dir",
                        str(out_dir / "ckpt"), "--max-restarts", "2",
                        "--chaos", f"crash@step={CRASH_AT},torn_ckpt@save=1"],
                       timeout=900)
    seconds = time.perf_counter() - t0
    (out_dir / "stdout.txt").write_text(out)
    summary = (f"Supervisor: completed=True restarts=1 steps_replayed="
               f"{CRASH_AT} torn_checkpoints_skipped=1")
    if summary not in out or f"checkpoint {spe} is torn" not in out:
        raise RuntimeError(f"phase 18 (b): expected '{summary}' and the "
                           f"torn checkpoint {spe} skipped, got:\n{out}")
    want = {QUANTIZE: 0, DEQUANT: 0}
    for (kernel, _), count in wire_launches(torch, wire, cap).items():
        want[kernel] += count * executed
    clean_dir = ROOT / "chiprun_out" / "dp_int8_one_bucket"
    for r in range(DP_RANKS):
        rep = json.loads((out_dir / f"rank{r}.json").read_text())
        clean = json.loads((clean_dir / f"rank{r}.json").read_text())
        got = {k: rep["launches"][k] for k in want}
        if got != want or rep["steps"] != IMAGE_EPOCHS * spe:
            raise RuntimeError(f"phase 18 (b) rank {r}: {rep['steps']} "
                               f"steps, launches {got} (expected "
                               f"{IMAGE_EPOCHS * spe}, {want})")
        if not rep["ef_digests"] or rep["digests"] != clean["digests"] \
                or rep["ef_digests"] != clean["ef_digests"]:
            raise RuntimeError(f"phase 18 (b) rank {r}: the state differs "
                               "from phase 12's clean int8 one-bucket run")
    return {"executed_steps": executed, "launches_per_rank": want,
            "wall_seconds": seconds, **save_instruments(out)}


def serve_checkpoint(torch, dev, state, ckpt_dir: Path) -> dict:
    """Phase 18 (c): ``serving smoke --ckpt-dir`` on run C's directory;
    the served weights must be run C's, and every prompt's prefill logits
    bitwise those of an engine built from run C's in-memory parameters
    (same card, fp32)."""
    import numpy as np

    from distributed_pytorch_training_tpu_torch.serving import (
        InferenceEngine,
    )
    from distributed_pytorch_training_tpu_torch.serving.__main__ import run

    report = run(["smoke", "--model", MODEL, "--ckpt-dir", str(ckpt_dir),
                  "--model-overrides", "max_position=1024", *SERVING_OUT])
    engine, info = report.engine, report.engine.checkpoint_info
    label = EPOCHS * TRAIN_STEPS
    manifest = json.loads(
        (ckpt_dir / ".manifests" / f"{label}.json").read_text())
    if (info["label"], info["step"], info["verified"]) != (label, label,
                                                           True) \
            or info["tree_digest"] != manifest["tree_digest"]:
        raise RuntimeError(f"served checkpoint {info}, expected label "
                           f"{label} with digest {manifest['tree_digest']}")
    params = {n: p.detach() for n, p in state.model.named_parameters()}
    for name, p in params.items():
        if not torch.equal(engine._served[name], p):
            raise RuntimeError(f"served {name} is not run C's")
    mem = InferenceEngine(engine.model, engine.config, params, device=dev)
    for prm in report.prompts:
        a = engine.serve_tokens([prm], return_prompt_logits=True)[0]
        b = mem.serve_tokens([prm], return_prompt_logits=True)[0]
        if not (np.array_equal(a.prompt_logits, b.prompt_logits)
                and np.array_equal(a.tokens, b.tokens)):
            raise RuntimeError("prefill logits from the checkpoint differ "
                               "from run C's in-memory parameters")
    return {"label": label, "tree_digest": info["tree_digest"],
            "prompts": len(report.prompts)}


# phase 19: the sharded update. ResNet-18 on 2 ranks, batch 128 a rank,
# 2 epochs of 6 steps; on 4 ranks (2 slices x 2), 2 epochs of 3 steps
SHARDED_SYNTHETIC = 1536
ZERO1_RUNS = [("zero1 fp32", "fp32"), ("zero1 int8", "int8"),
              ("zero1 int8_multihop", "int8_multihop")]
FSDP_RUNS = [("fsdp fp32", "fp32"), ("fsdp int8", "int8")]
HIER_RANKS, HIER_SLICES, HIER_CAP = 4, 2, 25.0
HIER_RUNS = [("hier reducer", ["--bucket-cap-mb", str(HIER_CAP)]),
             ("hier zero1", ["--zero1"])]
# the flat codecs of the sharded update, timed beside the hier ones on the
# same 4 ranks: {name: K1 and K2 launches a call}
FLAT_CODECS = {"compressed_psum_scatter fp32": (0, 0),
               "compressed_psum_scatter int8": (1, 1),
               "all_gather": (0, 0),
               "quantized_delta_all_gather": (1, 0)}
GPT2_PARAMS = 124_439_808


def resnet18_named(torch):
    """ResNet-18's (name, parameter) pairs in flax order (shapes only)."""
    from distributed_pytorch_training_tpu_torch.convert import flax_ordered
    from distributed_pytorch_training_tpu_torch.models import get_model

    return [(name, torch.empty(p.shape, device="meta")) for name, p in
            flax_ordered(get_model("resnet18").named_parameters())]


def sharded_launches(torch, mode: str, wire: str, n: int,
                     slices: int = 1) -> dict:
    """{(kernel, (rows, width)): launches} of one ResNet-18 step of the
    sharded update (``zero1``, ``fsdp``) or of the int8_hier reducer
    (``reducer``, buckets of HIER_CAP MB), as the code forms them: per
    leaf (zero1) or layer group (fsdp) of P padded elements, the int8
    scatter runs K1 on (1, P) and K2 on (n, P/n); int8_multihop adds K1
    on (1, P/n) for the s8 gather; int8_hier scatters across the slices
    on the fast tier's partial, K1 on (1, P/n_inner) and K2 on (n_slices,
    P/n), and gathers with K1 on (1, P/n); its reducer runs the multihop
    codec on each bucket's partial, K1 on (n_slices, c) and (1, c), K2
    on (n_slices, c), c = S_padded / n."""
    from distributed_pytorch_training_tpu_torch.parallel.grad_sync import (
        build_bucket_plan, build_layer_plan, padded_bucket_bounds,
    )

    named = resnet18_named(torch)
    n_inner = n // slices
    counts: dict = {}

    def add(kernel, shape):
        counts[(kernel, shape)] = counts.get((kernel, shape), 0) + 1

    if mode == "reducer":
        plan = build_bucket_plan([p for _, p in named], HIER_CAP)
        bounds = padded_bucket_bounds(plan, n)
        for a, b in zip(bounds, bounds[1:]):
            c = (b - a) // n
            add(QUANTIZE, (slices, c))
            add(DEQUANT, (slices, c))
            add(QUANTIZE, (1, c))
        return counts
    if wire == "fp32":
        return counts
    for g in build_layer_plan(named, n, per_leaf=mode == "zero1").groups:
        padded = n * g.row_size
        if wire == "int8_hier":
            add(QUANTIZE, (1, padded // n_inner))
            add(DEQUANT, (slices, g.row_size))
        else:
            add(QUANTIZE, (1, padded))
            add(DEQUANT, (n, g.row_size))
        if wire in ("int8_multihop", "int8_hier"):
            add(QUANTIZE, (1, g.row_size))
    return counts


def per_kernel(counts: dict, steps: int = 1) -> dict:
    want = {QUANTIZE: 0, DEQUANT: 0}
    for (kernel, _), count in counts.items():
        want[kernel] += count * steps
    return want


def check_at_rest(torch, name: str, ranks: list, mode: str, n: int) -> int:
    """Each rank's optimizer tensors (and FSDP's parameters) hold padded/N
    of every ResNet-18 leaf; returns rank 0's parameter bytes at rest."""
    from distributed_pytorch_training_tpu_torch.parallel.sharding import (
        flat_padded_size,
    )

    chunks = sorted(flat_padded_size(p.numel(), n) // n
                    for _, p in resnet18_named(torch))
    for r, rep in enumerate(ranks):
        rest = rep["at_rest"]
        if sorted(rest["opt"]) != chunks or (
                mode == "fsdp" and sorted(rest["params"]) != chunks):
            raise RuntimeError(f"{name} rank {r}: at-rest sizes "
                               f"{rest} are not padded/{n} a leaf")
    return ranks[0]["at_rest"]["param_bytes"]


def sharded_two_ranks(torch) -> dict:
    """Phase 19 (a) and (b): ResNet-18 on 2 ranks sharing the card under
    ``--zero1`` (fp32, int8, int8_multihop) and ``--fsdp-explicit`` (fp32,
    int8), then GPT-2 124M ``--fsdp-explicit --amp`` at phase 15's shape.
    Launches exact, ranks bitwise equal, at-rest sizes 1/N; the loss falls
    in at least one ResNet run; GPT-2's losses finite."""
    steps = IMAGE_EPOCHS * -(-SHARDED_SYNTHETIC // (IMAGE_BATCH * DP_RANKS))
    report, fell, runs, counts = {}, [], [], {}
    configs = [(mode, name, wire, flag)
               for mode, named, flag in (
                   ("zero1", ZERO1_RUNS, "--zero1"),
                   ("fsdp", FSDP_RUNS, "--fsdp-explicit"))
               for name, wire in named]
    for mode, name, wire, flag in configs:
        counts[name] = sharded_launches(torch, mode, wire, DP_RANKS)
        runs.append((name, IMAGE_FLAGS + [flag, "--wire-dtype", wire],
                     SHARDED_SYNTHETIC, per_kernel(counts[name], steps),
                     steps))
    # (b) GPT-2 124M under --fsdp-explicit --amp, phase 15's shape
    want = {FLASH[0]: DEPTH * (LM_DP_STEPS + LM_DP_EVAL),
            FLASH[1]: DEPTH * LM_DP_STEPS, FLASH[2]: DEPTH * LM_DP_STEPS}
    runs.append(("gpt2 fsdp amp", LM_FLAGS + [
        "--batch-size", str(LM_DP_BATCH), "--epochs", "1",
        "--print-freq", "2", "--fsdp-explicit", "--amp"], LM_DP_SYNTHETIC,
        want, LM_DP_STEPS))
    results = dp_runs(torch, runs, DP_RANKS)
    for mode, name, wire, flag in configs:
        res = results[name]
        rows = [(float(c[1]), float(c[3]), float(c[5])) for c in (
            ln.split(",") for ln in (res["out_dir"] / "metrics_rank0.csv")
            .read_text().splitlines()[1:])]
        if len(rows) != IMAGE_EPOCHS or not all(
                math.isfinite(x) for row in rows for x in row):
            raise RuntimeError(f"{name}: CSV rows {rows}")
        fell.append(rows[-1][0] < rows[0][0])
        rest = check_at_rest(torch, name, res["ranks"], mode, DP_RANKS)
        report[name] = {
            "mode": mode, "wire": wire, "steps": steps,
            "launches_per_rank": res["launches_per_rank"],
            "per_step": {f"{k}{list(shape)}": c
                         for (k, shape), c in counts[name].items()},
            "losses": rows, "param_bytes_at_rest": rest,
            "step_line_samples_per_s": res["step_line_samples_per_s"],
            "wall_seconds": res["wall_seconds"]}
        log(f"phase 19 {name}: {steps} steps on {DP_RANKS} ranks, "
            f"launches per rank {res['launches_per_rank']}; evaluated "
            "parameters and BatchNorm statistics bitwise equal across "
            f"ranks; optimizer state padded/{DP_RANKS} a leaf"
            + (", parameters too" if mode == "fsdp" else "")
            + f" ({rest} parameter bytes at rest on rank 0); (train, "
            f"val, epoch s) per epoch {rows}; step-line samples/s "
            f"{res['step_line_samples_per_s']}")
    if not any(fell):
        raise RuntimeError("phase 19: the train loss fell in no run")
    res = results["gpt2 fsdp amp"]
    lines = (res["out_dir"] / "metrics_rank0.csv").read_text().splitlines()
    losses = [(float(c[1]), float(c[3])) for c in
              (ln.split(",") for ln in lines[1:])]
    if len(losses) != 1 or not all(math.isfinite(x) for x in losses[0]):
        raise RuntimeError(f"GPT-2 FSDP: CSV rows {lines}")
    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.parallel.sharding import (
        flat_padded_size,
    )

    rest = [rep["at_rest"]["param_bytes"] for rep in res["ranks"]]
    half = GPT2_PARAMS * 4 / DP_RANKS
    chunks = 4 * sum(flat_padded_size(p.numel(), DP_RANKS) // DP_RANKS
                     for p in get_model(MODEL, device="meta").parameters())
    if rest != [chunks] * DP_RANKS:
        raise RuntimeError(f"GPT-2 FSDP: parameter bytes at rest {rest}, "
                           f"expected {chunks} a rank")
    report["gpt2 fsdp amp"] = {
        "launches_per_rank": want, "losses": losses,
        "param_bytes_at_rest": rest,
        "step_line_samples_per_s": res["step_line_samples_per_s"],
        "wall_seconds": res["wall_seconds"]}
    log(f"phase 19 GPT-2 124M --fsdp-explicit --amp: launches per rank "
        f"{want}; evaluated parameters bitwise equal across ranks; "
        f"parameter bytes at rest per rank {rest} (124,439,808 x 4 / 2 = "
        f"{half:.0f}); (train, val) loss {losses}; step-line samples/s "
        f"{res['step_line_samples_per_s']}")
    return report


def hier_four_ranks(torch) -> dict:
    """Phase 19 (c): ResNet-18 on HIER_RANKS ranks sharing the card,
    ``--slices 2 --wire-dtype int8_hier`` through the bucketed reducer
    (cap 25) and with ``--zero1``: launches exact, ranks bitwise equal."""
    steps = IMAGE_EPOCHS * -(-SHARDED_SYNTHETIC // (IMAGE_BATCH
                                                    * HIER_RANKS))
    report, counts = {}, {}
    for name, extra in HIER_RUNS:
        mode = "zero1" if "--zero1" in extra else "reducer"
        counts[name] = sharded_launches(torch, mode, "int8_hier",
                                        HIER_RANKS, HIER_SLICES)
    results = dp_runs(torch, [
        (name, IMAGE_FLAGS + ["--slices", str(HIER_SLICES), "--wire-dtype",
                              "int8_hier", "--print-freq", "3", *extra],
         SHARDED_SYNTHETIC, per_kernel(counts[name], steps), steps)
        for name, extra in HIER_RUNS], HIER_RANKS)
    for name, extra in HIER_RUNS:
        mode = "zero1" if "--zero1" in extra else "reducer"
        res = results[name]
        if "Two-tier wire (int8_hier): 2 slices x 2 replicas/slice" \
                not in res["stdout"]:
            raise RuntimeError(f"{name}: no two-tier banner")
        if mode == "zero1":
            check_at_rest(torch, name, res["ranks"], mode, HIER_RANKS)
        report[name] = {
            "steps": steps, "launches_per_rank": res["launches_per_rank"],
            "per_step": {f"{k}{list(shape)}": c
                         for (k, shape), c in counts[name].items()},
            "step_line_samples_per_s": res["step_line_samples_per_s"],
            "wall_seconds": res["wall_seconds"]}
        log(f"phase 19 {name}: {steps} steps on {HIER_RANKS} ranks "
            f"({HIER_SLICES} slices), launches per rank "
            f"{res['launches_per_rank']}; evaluated parameters and "
            "BatchNorm statistics bitwise equal across ranks; step-line "
            f"samples/s {res['step_line_samples_per_s']}; "
            f"{res['wall_seconds']:.1f} s")
    return report


def hier_codec_rank(rank: int, store: str, out_dir: str) -> None:
    """Phase 19 (c), one of HIER_RANKS processes (gloo, all on cuda:0):
    the hier codecs on a seeded 11,181,642-float gradient, twice on the
    card and once on the CPU: ``reduce_flat(int8_hier)`` (cap 25),
    ``hier_psum_scatter``, ``hier_delta_all_gather`` and
    ``hier_shard_all_gather`` on it as one flat-padded vector, and the
    flat codecs of the sharded update over all 4 ranks (FLAT_CODECS);
    writes
    whether the card's results are bitwise the CPU's, the digests of
    the replicated ones, the launches and the card's ms a call (the
    second call)."""
    import hashlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        dequant_sum_rows,
        quantize_int8_rows,
    )
    from distributed_pytorch_training_tpu_torch.parallel import (
        grad_sync as gs,
    )
    from distributed_pytorch_training_tpu_torch.parallel.collectives import (
        all_gather,
    )
    from distributed_pytorch_training_tpu_torch.parallel.sharding import (
        flatten_pad,
    )

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=HIER_RANKS)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    spec = gs.build_hier_spec(HIER_RANKS, rank, HIER_SLICES)
    n, n_inner = HIER_RANKS, spec.n_inner
    g = torch.Generator().manual_seed(2000 + rank)
    flat = torch.randn(RESNET18_PARAMS, generator=g) * (1 + rank)
    plan = gs.build_bucket_plan([flat], HIER_CAP)
    ef = torch.randn(gs.ef_state_bucketed([flat], n, HIER_CAP, "int8_hier",
                                          n_slices=HIER_SLICES)["ef"].shape,
                     generator=g) * 0.01
    v = flatten_pad(flat, n)
    vres = torch.randn(v.numel() // n_inner, generator=g) * 0.01
    vres_full = torch.randn(v.numel(), generator=g) * 0.01
    old = torch.randn(v.numel(), generator=torch.Generator().manual_seed(7))
    old_shard = old.reshape(n, -1)[spec.owner]
    new_shard = old_shard + torch.randn(old_shard.shape, generator=g) * 1e-3
    ops = {
        "reduce_flat": lambda d: gs.reduce_flat(
            flat.to(d), plan, n, "int8_hier", ef.to(d), None, spec),
        "hier_psum_scatter": lambda d: gs.hier_psum_scatter(
            v.to(d), spec, vres.to(d)),
        "hier_delta_all_gather": lambda d: (gs.hier_delta_all_gather(
            new_shard.to(d), old_shard.to(d), old.to(d), spec),),
        "hier_shard_all_gather": lambda d: (gs.hier_shard_all_gather(
            new_shard.to(d), spec),),
        "compressed_psum_scatter fp32": lambda d: gs.compressed_psum_scatter(
            v.to(d), n, "fp32"),
        "compressed_psum_scatter int8": lambda d: gs.compressed_psum_scatter(
            v.to(d), n, "int8", vres_full.to(d)),
        "all_gather": lambda d: (all_gather(new_shard.to(d)),),
        "quantized_delta_all_gather": lambda d: (
            gs.quantized_delta_all_gather(new_shard.to(d), old_shard.to(d),
                                          old.to(d)),),
    }
    report = {"spawn_to_ready_s": time.perf_counter() - t_start}
    for name, op in ops.items():
        before = (quantize_int8_rows.launches, dequant_sum_rows.launches)
        card = op(dev)
        torch.cuda.synchronize()
        launches = (quantize_int8_rows.launches - before[0],
                    dequant_sum_rows.launches - before[1])
        t0 = time.perf_counter()
        op(dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu = op(torch.device("cpu"))
        report[name] = {
            "bitwise": all(torch.equal(a.cpu().view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in zip(card, cpu) if a is not None),
            "out_sha256": hashlib.sha256(
                card[0].cpu().numpy().tobytes()).hexdigest(),
            "launches": {QUANTIZE: launches[0], DEQUANT: launches[1]},
            "card_ms_per_call": ms}
    dist.destroy_process_group()
    (Path(out_dir) / f"hier_rank{rank}.json").write_text(
        json.dumps(report, indent=1))


def hier_codec_card_vs_cpu(torch) -> dict:
    """Phase 19 (c): HIER_RANKS codec processes on the one card; every
    rank's card results bitwise its CPU's, the replicated outputs the
    same on every rank, the launches the code's."""
    import tempfile

    import torch.multiprocessing as mp

    out_dir = ROOT / "chiprun_out" / "hier_codec"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(hier_codec_rank,
                           args=(f"{tmp}/store", str(out_dir)),
                           nprocs=HIER_RANKS, start_method="spawn")
    seconds = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"hier_rank{r}.json").read_text())
             for r in range(HIER_RANKS)]
    want = {"reduce_flat": per_kernel(sharded_launches(
                torch, "reducer", "int8_hier", HIER_RANKS, HIER_SLICES)),
            "hier_psum_scatter": {QUANTIZE: 1, DEQUANT: 1},
            "hier_delta_all_gather": {QUANTIZE: 1, DEQUANT: 0},
            "hier_shard_all_gather": {QUANTIZE: 1, DEQUANT: 0},
            **{name: {QUANTIZE: k1, DEQUANT: k2}
               for name, (k1, k2) in FLAT_CODECS.items()}}
    for r, rep in enumerate(ranks):
        for name, w in want.items():
            if rep[name]["launches"] != w or not rep[name]["bitwise"]:
                raise RuntimeError(
                    f"hier codec {name} rank {r}: launches "
                    f"{rep[name]['launches']} (expected {w}), card bitwise "
                    f"the CPU's: {rep[name]['bitwise']}")
    for name in ("reduce_flat", "hier_delta_all_gather",
                 "hier_shard_all_gather", "all_gather",
                 "quantized_delta_all_gather"):
        if len({rep[name]["out_sha256"] for rep in ranks}) != 1:
            raise RuntimeError(f"hier codec {name}: the ranks differ")
    return {"wall_seconds": seconds, "rank0": ranks[0],
            "spawn_to_ready_s": [rep["spawn_to_ready_s"] for rep in ranks]}


def time_sharded_codec(torch, dev, flush, shapes) -> dict:
    """Phase 19 (d): K1 and K2 at every (kernel, shape) of ``shapes``,
    bitwise against the plain versions, timed as phase 9 times them
    (kernel, plain, bound)."""
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        dequant_sum_rows,
        dequant_sum_rows_ref,
        quantize_int8_rows,
        quantize_int8_rows_ref,
    )

    rows = {}
    for seed, (kernel, shape) in enumerate(sorted(shapes)):
        x = codec_rows(torch, dev, shape, 100 + seed)
        n, w = shape
        if kernel == QUANTIZE:
            q, s = quantize_int8_rows(x)
            qr, sr = quantize_int8_rows_ref(x)
            same = torch.equal(q, qr) and torch.equal(
                s.view(torch.int32), sr.view(torch.int32))
            bound, by = bound_of(5 * n * w + 4 * n, 5 * n * w)
            fn, ref = (lambda: quantize_int8_rows(x),
                       lambda: quantize_int8_rows_ref(x))
        else:
            q, s = quantize_int8_rows_ref(x)
            out, want = dequant_sum_rows(q, s), dequant_sum_rows_ref(q, s)
            same = torch.equal(out.view(torch.int32), want.view(torch.int32))
            bound, by = bound_of(n * w + 4 * n + 4 * w, 2 * n * w)
            fn, ref = (lambda: dequant_sum_rows(q, s),
                       lambda: dequant_sum_rows_ref(q, s))
        if not same:
            raise RuntimeError(f"{kernel} {shape}: kernel differs from "
                               "its plain version")
        rows[(kernel, shape)] = {
            "kernel": kernel, "shape": f"{n}x{w}", "bitwise": True,
            "max_abs_err": 0.0, "ms": timed_ms(torch, fn, flush),
            "plain_ms": timed_ms(torch, ref, flush), "bound_ms": bound,
            "bound_by": by}
        if kernel == DEQUANT:
            # phase 9's composite beside K2: a cast and a GEMV
            rows[(kernel, shape)]["composite_ms"] = timed_ms(
                torch, lambda: s @ q.float(), flush)
    return rows


def codec_per_step(counts: dict, rows: dict) -> dict:
    """K1's and K2's ms a step (kernel, plain, bound) over ``counts``."""
    out = {}
    for kernel in (QUANTIZE, DEQUANT):
        share = [(rows[key], c) for key, c in counts.items()
                 if key[0] == kernel]
        out[kernel] = {k: sum(r[k] * c for r, c in share)
                       for k in ("ms", "plain_ms", "bound_ms")}
        out[kernel]["launches"] = sum(c for _, c in share)
    return out


def codec_kernel_rows(torch, codec, codec19, counts19, dp_steps,
                      steps19, quantize_checked, dequant_checked,
                      paged_kv, bert_counts) -> list:
    """The kernels line's rows of K1 and K2: their launches on the
    data-parallel paths (rank 0 of every phase 12 run, DP_RUNS, of every
    phase 19 run, ``counts19`` a step, and of phase 22 (e)'s BERT run,
    ``bert_counts`` in all, also apart as ``bert_*``) and, for K1, on
    phase 21's
    int8 KV pages (``paged_kv``, each shape's launches), with the times,
    plain times and bounds of each launch's shape (phase 9's ``codec``,
    phase 19's ``codec19``, phase 21's rows) summed over them, K1's
    paged-KV share also apart (``paged_kv_*``); errors over every shape
    checked."""
    out = []
    for kernel, line, source in ((QUANTIZE, 147, "quantize_int8_rows.cu"),
                                 (DEQUANT, 191, "dequant_sum_rows.cu")):
        shares = []
        for name, wire, cap in DP_RUNS:
            for (k, shape), count in wire_launches(torch, wire, cap).items():
                if k == kernel:
                    shares.append((codec[(k, shape)], count * dp_steps[name]))
        for name, c19 in counts19.items():
            shares += [(codec19[key], c * steps19[name])
                       for key, c in c19.items() if key[0] == kernel]
        bert = [(codec[key], c) for key, c in bert_counts.items()
                if key[0] == kernel]
        shares += bert
        checked = [r for r in (*codec.values(), *codec19.values())
                   if r["kernel"] == kernel]
        checked += dequant_checked if kernel == DEQUANT else quantize_checked
        paged = [(r, r["launches"]) for r in paged_kv
                 if r["kernel"] == kernel]
        shares += paged
        checked += [r for r, _ in paged]
        out.append({
            "name": kernel, "route": "cuda",
            "source": f"{PACKAGE}/csrc/{source}",
            "replaces": f"distributed_pytorch_training_tpu/ops/quantize.py:"
                        f"{line}",
            "launches": sum(n for _, n in shares),
            "bitwise": all(r["bitwise"] for r in checked),
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": sum(r["ms"] * n for r, n in shares),
            "plain_ms": sum(r["plain_ms"] * n for r, n in shares),
            "bound_ms": sum(r["bound_ms"] * n for r, n in shares),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r, _ in shares)
                         else "operations"),
            # no single PyTorch call quantizes or takes int8 codes; K2's
            # nearest composite, scales @ q.float(), a cast and a GEMV
            "library_ms": None,
            **({"composite_ms": sum(r["composite_ms"] * n
                                    for r, n in shares)}
               if kernel == DEQUANT else {}),
            **({"paged_kv_" + key: sum(r[key] * n if key != "launches"
                                       else n for r, n in paged)
                for key in ("launches", "ms", "plain_ms", "bound_ms")}
               if paged else {}),
            **{"bert_" + key: sum(r[key] * n if key != "launches" else n
                                  for r, n in bert)
               for key in ("launches", "ms", "plain_ms", "bound_ms")},
        })
    return out


# phase 20: step profiling through the port's entry (--profile-dir and
# --profile-steps). Steps 5, 6 and 7 of epoch 0 are traced; at 96
# synthetic sequences and batch 8 an epoch has 12 steps, so the window
# closes (at step 8's hook) before the epoch's evaluation runs
PROFILE_FIRST, PROFILE_LAST = 5, 8
PROFILED = PROFILE_LAST - PROFILE_FIRST
PROFILE_SYNTHETIC = 96
PROFILE_EVAL = -(-(PROFILE_SYNTHETIC // 5) // 8)   # 19 sequences, batch 8
# the bf16 flash kernels' names in the card's trace (nvcc's, without
# their template arguments)
FLASH_BF16_TRACE = {FLASH[0]: "flash_fwd_bf16_sm90_kernel",
                    FLASH[1]: "flash_bwd_dkv_bf16_sm90_kernel",
                    FLASH[2]: "flash_bwd_dq_bf16_sm90_kernel"}
# card ms of the four-way split must sum to the window within the
# readers' rounding (each rounds to 0.1 us)
SPLIT_ROUNDING_US = 0.3


def profile_window(torch, prof_dir: Path, steps: int) -> dict:
    """Read one profiled window of the card's trace: the device split a
    step (window, compute, comm hidden, comm exposed, host gap, in ms),
    the device idle share (host_gap / window), the collective share, the
    ten device ops with the most time, and each kernel's launches and
    mean device ms by name. Fails when the window holds no kernel event
    (CUPTI recorded nothing on the card: no split is read, no fallback)
    or when the split does not sum to the window."""
    from distributed_pytorch_training_tpu_torch.experiments import (
        trace_analysis as ta,
    )

    events = ta.load_trace(str(prof_dir))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise RuntimeError(f"the CUDA window under {prof_dir} holds no "
                           "kernel event: CUPTI recorded no device activity")
    by_name, full_names = {}, {}
    for e in kernels:
        base = ta.kernel_base_name(e["name"])
        full_names.setdefault(base, e["name"])
        k = by_name.setdefault(base, [0, 0.0])
        k[0] += 1
        k[1] += float(e["dur"])
    split = ta.device_time_split(str(prof_dir))
    parts = ("compute_us", "comm_hidden_us", "comm_exposed_us",
             "host_gap_us")
    if abs(sum(split[k] for k in parts) - split["window_us"]) \
            > SPLIT_ROUNDING_US:
        raise RuntimeError(f"the device split {split} does not sum to its "
                           "window")
    per_step = {k.replace("_us", "_ms"): split[k] / steps / 1e3
                for k in ("window_us",) + parts}
    return {
        "kernel_events": len(kernels), "steps": steps, "split": split,
        "per_step_ms": per_step,
        "idle_share": split["host_gap_us"] / split["window_us"],
        "collective_share": ta.collective_share(str(prof_dir)),
        "comm_overlap": ta.comm_overlap_split(str(prof_dir)),
        "top_ops": ta.top_device_ops(str(prof_dir), 10),
        "kernels": {name: {"launches": k, "mean_ms": us / k / 1e3,
                           "trace_name": full_names[name]}
                    for name, (k, us) in by_name.items()},
        # the host's spans, not the card's view of them
        # (gpu_user_annotation)
        "gloo_spans_ms": sorted(
            (float(e["dur"]) / 1e3 for e in events
             if e["name"].startswith("gloo:")
             and e.get("cat") == "user_annotation"), reverse=True),
    }


def log_window(card: str, tag: str, w: dict) -> None:
    s = w["per_step_ms"]
    log(f"{tag} [{card}]: {w['kernel_events']} kernel events over "
        f"{w['steps']} steps; device split ms a step: window "
        f"{s['window_ms']!r}, compute {s['compute_ms']!r}, comm hidden "
        f"{s['comm_hidden_ms']!r}, comm exposed {s['comm_exposed_ms']!r}, "
        f"host gap {s['host_gap_ms']!r}; device idle share (host_gap / "
        f"window) {w['idle_share']!r}; collective share "
        f"{w['collective_share']}")
    for op in w["top_ops"]:
        log(f"{tag} [{card}]: top device op {op['total_us'] / 1e3!r} ms in "
            f"{op['launches']} launches ({op['mean_us']!r} us each): "
            f"{op['name'][:120]}")


def stream_events(path: Path) -> list:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def telemetry_summary_exits_0(stream: Path) -> None:
    """The port's `telemetry summary` on a stream, in a process of its
    own: it must exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.telemetry", "summary",
         str(stream)], capture_output=True, text=True, cwd=ROOT, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"telemetry summary {stream} exited "
                           f"{proc.returncode}: {proc.stderr}")
    print(proc.stdout, end="", flush=True)


def profile_gpt2(torch, fa, card: str, flash_rows: list) -> dict:
    """Phase 20 (a): phase 14's command (GPT-2 124M ``--amp`` at full
    width) with ``--profile-dir --profile-steps 5,8`` over one epoch of 12
    steps, the launch counts set to 0 just before and read just after.
    The window must hold each bf16 flash kernel 12 layers x 3 steps
    times, the stream a ``device_profile`` event of steps 5-8, and the
    port's ``telemetry summary`` must read the stream."""
    import shutil

    out_dir = ROOT / "chiprun_out" / "prof_gpt2"
    shutil.rmtree(out_dir, ignore_errors=True)
    prof_dir = out_dir / "prof"
    kernels = [getattr(fa, name) for name in FLASH]
    for fn in kernels:
        fn.launches = 0
    train_main(LM_FLAGS + [
        "--synthetic-size", str(PROFILE_SYNTHETIC), "--batch-size", "8",
        "--epochs", "1", "--print-freq", "4", "--amp", "--output-dir",
        str(out_dir), "--profile-dir", str(prof_dir), "--profile-steps",
        f"{PROFILE_FIRST},{PROFILE_LAST}"])
    launches = {fn.__name__: fn.launches for fn in kernels}
    steps = PROFILE_SYNTHETIC // 8
    want = {FLASH[0]: DEPTH * (steps + PROFILE_EVAL),
            FLASH[1]: DEPTH * steps, FLASH[2]: DEPTH * steps}
    if launches != want:
        raise RuntimeError(f"phase 20 (a) launched {launches}, expected "
                           f"{want}")
    w = profile_window(torch, prof_dir, PROFILED)
    log_window(card, "phase 20 (a) GPT-2 124M --amp", w)
    main_bf16 = flash_rows[1]
    trace_ms = {}
    for name, traced in FLASH_BF16_TRACE.items():
        k = w["kernels"].get(traced, {"launches": 0, "mean_ms": None})
        if k["launches"] != DEPTH * PROFILED:
            raise RuntimeError(f"phase 20 (a): {traced} ran {k['launches']} "
                               f"times in the window, expected "
                               f"{DEPTH} x {PROFILED}")
        trace_ms[name] = k["mean_ms"]
        log(f"phase 20 (a) [{card}]: {traced}: {k['launches']} launches in "
            f"the window, device ms (trace) {k['mean_ms']!r} a launch; "
            f"phase 6's timed_ms {main_bf16['ms'][name]!r}; named "
            f"{k['trace_name']!r} in the trace")
    stream = out_dir / "telemetry_rank0.jsonl"
    profiles = [ev for ev in stream_events(stream)
                if ev["kind"] == "device_profile"]
    if [(ev["start_step"], ev["stop_step"]) for ev in profiles] != \
            [(PROFILE_FIRST, PROFILE_LAST)]:
        raise RuntimeError(f"phase 20 (a): device_profile events "
                           f"{profiles}, expected one of steps "
                           f"{PROFILE_FIRST}-{PROFILE_LAST}")
    telemetry_summary_exits_0(stream)
    for trace in prof_dir.glob("*.pt.trace.json"):
        w.setdefault("trace_bytes", trace.stat().st_size)
        trace.unlink()            # tens of MB; the split is kept
    return {**w, "launches": launches, "bf16_trace_ms": trace_ms,
            "device_profile": profiles[0]}


def profile_reference(torch, card: str, reducer: dict) -> dict:
    """Phase 20 (b): the reference's command (phase 13's fp32 run:
    ResNet-18, 2 gloo ranks sharing the card, the implicit path) with
    ``--profile-dir --profile-steps 5,8``; rank 0 alone profiles. Its
    collective share and device split, and the gloo all-reduce spans of
    the window beside phase 10's timed all-reduces of this run."""
    import shutil

    out_dir = ROOT / "chiprun_out" / "prof_reference"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    prof_dir = out_dir / "prof"
    out = run_torchrun([str(out_dir), *IMAGE_FLAGS, "--synthetic-size",
                        str(DP_SYNTHETIC), "--profile-dir", str(prof_dir),
                        "--profile-steps", f"{PROFILE_FIRST},{PROFILE_LAST}"],
                       timeout=600)
    (out_dir / "stdout.txt").write_text(out)
    steps = IMAGE_EPOCHS * -(-DP_SYNTHETIC // (IMAGE_BATCH * DP_RANKS))
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(DP_RANKS)]
    if any(r["steps"] != steps or any(r["launches"].values())
           for r in ranks):
        raise RuntimeError(f"phase 20 (b): ranks {ranks}")
    same_across_ranks("phase 20 (b)", ranks)
    w = profile_window(torch, prof_dir, PROFILED)
    log_window(card, "phase 20 (b) reference command, rank 0", w)
    spans = w["gloo_spans_ms"]
    timed = reducer["collectives_ms"]
    w["gradient_allreduce_ms"] = spans[:PROFILED]
    w["other_gloo_ms_a_step"] = sum(spans[PROFILED:]) / PROFILED
    w["gloo_spans_a_step"] = len(spans) / PROFILED
    log(f"phase 20 (b) [{card}]: {len(spans)} gloo spans in the window "
        f"({w['gloo_spans_a_step']!r} a step); the longest a step (the "
        f"gradient's all-reduce) {w['gradient_allreduce_ms']} ms beside "
        f"phase 10's timed all_reduce fp32 {timed['all_reduce fp32']!r} "
        f"ms; the rest {w['other_gloo_ms_a_step']!r} ms a step beside "
        f"phase 10's all_reduce fp32 2x512 {timed['all_reduce fp32 2x512']!r}"
        " ms a call; rank 1's kernels are not in rank 0's trace (2 ranks "
        "share one card over gloo: not a scaling number)")
    telemetry_summary_exits_0(out_dir / "telemetry_rank0.jsonl")
    for trace in prof_dir.glob("*.pt.trace.json"):
        w.setdefault("trace_bytes", trace.stat().st_size)
        trace.unlink()
    return w


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def live_endpoint(torch, card: str) -> dict:
    """Phase 20 (c): a short GPT-2 124M ``--amp`` run with
    ``--metrics-port``: mid-run (inside step 2, then step 9) GET /metrics
    and /healthz, whose step counter must rise; POST /profile?steps=2 at
    step 2, after which a capture_* directory and a device_profile event
    of reason "http" must exist."""
    import shutil
    import urllib.request

    from distributed_pytorch_training_tpu_torch.training import loop

    out_dir = ROOT / "chiprun_out" / "live_gpt2"
    shutil.rmtree(out_dir, ignore_errors=True)
    url = f"http://127.0.0.1:{free_port()}"
    seen = {"calls": 0}
    step = loop.Trainer.train_step

    def scraping_step(self, state, batch):
        n = seen["calls"]
        seen["calls"] = n + 1
        if n in (2, 9):
            with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
                seen[f"steps_total_{n}"] = float(next(
                    ln.split()[-1] for ln in r.read().decode().splitlines()
                    if ln.startswith("dpt_steps_total")))
            with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
                seen[f"healthz_{n}"] = r.status
        if n == 2:
            req = urllib.request.Request(url + "/profile?steps=2",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=10) as r:
                seen["post"] = r.status
        return step(self, state, batch)

    loop.Trainer.train_step = scraping_step
    try:
        train_main(LM_FLAGS + [
            "--synthetic-size", str(PROFILE_SYNTHETIC), "--batch-size", "8",
            "--epochs", "1", "--print-freq", "4", "--amp", "--metrics-port",
            url.rsplit(":", 1)[1], "--output-dir", str(out_dir)])
    finally:
        loop.Trainer.train_step = step
    if not (seen.get("healthz_2") == seen.get("healthz_9") == 200
            and seen.get("post") == 202
            and seen["steps_total_9"] > seen["steps_total_2"]):
        raise RuntimeError(f"phase 20 (c): the live endpoint gave {seen}")
    captures = sorted((out_dir / "profiles").glob("capture_*"))
    profiles = [ev for ev in stream_events(out_dir / "telemetry_rank0.jsonl")
                if ev["kind"] == "device_profile"]
    if len(captures) != 1 or [ev["reason"] for ev in profiles] != ["http"]:
        raise RuntimeError(f"phase 20 (c): captures {captures}, "
                           f"device_profile events {profiles}")
    w = profile_window(torch, captures[0], profiles[0]["steps"])
    log(f"phase 20 (c) [{card}]: /metrics dpt_steps_total "
        f"{seen['steps_total_2']!r} -> {seen['steps_total_9']!r}, /healthz "
        f"200; POST /profile?steps=2 -> 202, {captures[0].name} with "
        f"{w['kernel_events']} kernel events, device_profile steps "
        f"{profiles[0]['start_step']}-{profiles[0]['stop_step']}, window "
        f"{profiles[0]['window_ms']!r} ms")
    for trace in captures[0].glob("*.pt.trace.json"):
        trace.unlink()
    return {"scrapes": seen, "device_profile": profiles[0],
            "kernel_events": w["kernel_events"]}


# phase 21: continuous serving through the port's entry points at GPT-2
# 124M full width: the bench rows (iteration and token granular) on one
# schedule of SERVE21_REQUESTS prompts of 1-128 tokens in buckets 64 and
# 128, 32 new tokens each, 8 slots, pages of 16 positions
SERVE21_BUCKETS, SERVE21_NEW, SERVE21_ROWS, SERVE21_PAGE = (64, 128), 32, 8, 16
SERVE21_REQUESTS, SERVE21_RPS = 24, 16.0
SERVE21_FLAGS = ["--model", MODEL, "--buckets", "64,128", "--rows", "8",
                 "--max-new-tokens", str(SERVE21_NEW), "--page-size",
                 str(SERVE21_PAGE), "--requests", str(SERVE21_REQUESTS),
                 "--offered-load", str(SERVE21_RPS)]
# Two arms' greedy streams (dense vs paged decode, plain vs speculative,
# one replica vs two) compute the same float32 logits in other shapes and
# orders: measured card vs CPU prefill logits differ by 3.7e-6 (phase 5),
# so two arms may part only where the top two logits lie that close. A
# divergence where the dense arm's top-2 gap is below ESCAPE_GAP (~100x
# that noise) is an escape, counted and printed; a wrong page, mask or
# position parts streams at gaps of O(1).
ESCAPE_GAP = 1e-3
# (f)'s sampled request, asked twice: the same seed must give one stream
SERVE21_SAMPLED = {"temperature": 0.7, "top_p": 0.9, "seed": 1234}
# (c'): the oracle draft proposes SPEC21_K tokens a round. A request of
# SERVE21_NEW tokens emits its first at prefill, then rounds of K + 1, the
# last one clamped to the budget; the oracle would accept ORACLE_IDEAL of
# its proposals (24 of 28 here) if window verify and token-at-a-time draft
# agreed bitwise. A near tie between their float orders may reject one;
# ORACLE_MIN is the floor a broken acceptance (a random draft: 0) falls
# far below
SPEC21_K = 4
ORACLE_IDEAL = (((SERVE21_NEW - 1) // (SPEC21_K + 1)) * SPEC21_K
                + max((SERVE21_NEW - 1) % (SPEC21_K + 1) - 1, 0)) / (
    -(-(SERVE21_NEW - 1) // (SPEC21_K + 1)) * SPEC21_K)
ORACLE_MIN = 0.5
# int8 pages against the dense fp32 cache at this configuration: codes
# (1 B) and one float32 scale a 64-wide row, 64 / (64 + 4) of 4x
KV_RATIO_MIN = 3.0
DECODE_TIMED_STEPS, DECODE_ROUNDS = 16, 3


def top2_gap(torch, engine, tokens) -> float:
    """The top-2 logit gap of the token after ``tokens`` under
    ``engine``'s weights: one eval forward on the card."""
    import numpy as np

    from torch.func import functional_call

    with torch.inference_mode():
        ids = torch.tensor(np.asarray(tokens, np.int64),
                           device=engine.device)[None]
        logits = functional_call(engine.model, engine._params(), (ids,))
        top = torch.topk(logits[0, -1, :engine.model.vocab_size], 2).values
        return float(top[0] - top[1])


def stream_escapes(torch, engine, prompts, ref, got, what: str) -> list:
    """Hold ``got``'s token streams to ``ref``'s: equal, or parting first
    where ``engine``'s top-2 logit gap after the common prefix is below
    ESCAPE_GAP. Returns the escapes as (request, position, gap)."""
    import numpy as np

    escapes = []
    for i, (p, a, b) in enumerate(zip(prompts, ref, got)):
        a, b = np.asarray(a.tokens), np.asarray(b.tokens)
        if len(a) != len(b):
            raise RuntimeError(f"{what}: request {i} emitted {len(b)} "
                               f"tokens against {len(a)}")
        diff = np.nonzero(a != b)[0]
        if not diff.size:
            continue
        j = int(diff[0])
        gap = top2_gap(torch, engine, np.concatenate([p, a[:j]]))
        if not gap < ESCAPE_GAP:
            raise RuntimeError(
                f"{what}: request {i} (prompt {len(p)} tokens) parts at "
                f"token {j} ({a[j]} vs {b[j]}) where the top-2 logit gap "
                f"is {gap!r} (>= {ESCAPE_GAP})")
        escapes.append((i, j, gap))
    return escapes


def k1_paged_rows(torch, flush, captured: list, counts: dict) -> list:
    """K1 at each paged-KV shape the int8 run gave it: the captured rows
    (k and v of the first calls a shape) bitwise against the plain
    version, each shape timed beside its bound and plain version."""
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        quantize_int8_rows,
        quantize_int8_rows_ref,
    )

    rows = []
    for shape, count in sorted(counts.items()):
        mine = [c for c in captured if c[0] == shape]
        err, same = 0.0, True
        for _, x, q, s in mine:
            qr, sr = quantize_int8_rows_ref(x)
            same = same and torch.equal(q, qr) and torch.equal(
                s.view(torch.int32), sr.view(torch.int32))
            err = max(err, (q.int() - qr.int()).abs().max().item(),
                      (s - sr).abs().max().item())
        if not mine or not same:
            raise RuntimeError(f"paged KV K1 at {shape}: pages differ from "
                               f"the plain version's (max err {err}, "
                               f"{len(mine)} calls captured)")
        x = mine[0][1]
        n, w = shape
        bound, by = bound_of(5 * n * w + 4 * n, 5 * n * w)
        rows.append({
            "kernel": QUANTIZE, "shape": f"{n}x{w}", "launches": count,
            "bitwise": same, "max_abs_err": err, "checked_calls": len(mine),
            "ms": timed_ms(torch, lambda: quantize_int8_rows(x), flush),
            "plain_ms": timed_ms(torch,
                                 lambda: quantize_int8_rows_ref(x), flush),
            "bound_ms": bound, "bound_by": by})
    return rows


def decode_step_ms(torch, engine, prompts) -> float:
    """Mean card time of a decode step with every slot live: admit one
    prompt a slot into leased pages, then time DECODE_TIMED_STEPS steps
    between two synchronizations."""
    from distributed_pytorch_training_tpu_torch.serving.paged import (
        PagePool,
    )

    cfg = engine.config
    engine.reset_state()
    pool = PagePool(cfg.total_pages, cfg.page_size, cfg.pages_per_slot)
    for slot, p in enumerate(prompts[:cfg.rows]):
        lease = pool.alloc(p, len(p) + SERVE21_NEW)
        engine.set_page_row(slot, lease.pages)
        engine.admit(slot, p, SERVE21_NEW, 0.0, 1.0, slot)
    engine.decode_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_TIMED_STEPS):
        engine.decode_step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / DECODE_TIMED_STEPS


def serve_process(torch, prompt, sampled_prompt, want) -> dict:
    """Phase 21 (f): ``serving serve`` on an ephemeral port, in its own
    process: POST /generate the schedule's first prompt (greedy), then
    its second prompt sampled (SERVE21_SAMPLED) twice, GET /healthz, then
    SIGTERM, which must drain and exit 0. Every answer carries ``want``
    tokens; the two sampled answers are the same request's key stream
    and must be equal."""
    import queue
    import threading
    import urllib.request

    out_dir = ROOT / "chiprun_out" / "serve21"
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGE}.serving", "serve", "--port", "0",
         *SERVE21_FLAGS[:10], "--output-dir", str(out_dir)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    reader.start()
    seen = []
    try:
        t0 = time.perf_counter()
        port = None
        while port is None:
            left = 300.0 - (time.perf_counter() - t0)
            if left <= 0 or proc.poll() is not None:
                raise RuntimeError(f"phase 21 (f): no port; output {seen}")
            try:
                line = lines.get(timeout=min(left, 5.0))
            except queue.Empty:
                continue
            seen.append(line.rstrip())
            if "POST /generate on :" in line:
                port = int(line.split("POST /generate on :")[1].split()[0])
        ready_s = time.perf_counter() - t0
        url = f"http://127.0.0.1:{port}"

        def generate(tokens, **knobs):
            body = json.dumps({"tokens": [int(t) for t in tokens],
                               "max_new_tokens": want, **knobs}).encode()
            req = urllib.request.Request(
                url + "/generate", data=body, method="POST",
                headers={"Content-Type": "application/json"})
            t1 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as resp:
                answer = json.loads(resp.read())["tokens"]
            if len(answer) != want:
                raise RuntimeError(f"phase 21 (f): /generate {knobs} gave "
                                   f"{len(answer)} tokens, not {want}")
            return answer, (time.perf_counter() - t1) * 1e3

        answer, generate_ms = generate(prompt)
        sampled = [generate(sampled_prompt, **SERVE21_SAMPLED)[0]
                   for _ in range(2)]
        if sampled[0] != sampled[1]:
            raise RuntimeError(f"phase 21 (f): one sampled request asked "
                               f"twice gave two streams: {sampled}")
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        if health != {"draining": False, "served": 3}:
            raise RuntimeError(f"phase 21 (f): /healthz said {health}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
        while not lines.empty():
            seen.append(lines.get_nowait().rstrip())
        if rc != 0 or not any("replica drained (3 served)" in x
                              for x in seen):
            raise RuntimeError(f"phase 21 (f): rc {rc} after SIGTERM; "
                               f"output {seen}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return {"ready_s": ready_s, "generate_ms": generate_ms,
            "tokens": answer, "sampled_tokens": sampled[0], "log": seen}


def prng_card_vs_cpu(torch, dev) -> int:
    """The sampling key stream on the card against the CPU: fold_in and
    the raw bits of SERVE21_ROWS request keys at 32 positions, over a
    GPT-2 vocabulary's width. Integer arithmetic, so bitwise; returns
    the number of words compared."""
    from distributed_pytorch_training_tpu_torch.utils.prng import (
        fold_in,
        prng_key,
        random_bits,
    )

    def bits(device):
        keys = torch.stack([prng_key(s, device) for s in
                            range(SERVE21_ROWS)]).repeat_interleave(32, 0)
        pos = torch.arange(32, device=device).repeat(SERVE21_ROWS)
        folded = fold_in(keys, pos)
        return folded.cpu(), random_bits(folded, VOCAB).cpu()

    card, cpu = bits(dev), bits("cpu")
    for a, b, what in zip(card, cpu, ("fold_in", "bits")):
        if not torch.equal(a, b):
            n = int((a != b).sum())
            raise RuntimeError(f"phase 21 (f): {what} on the card differs "
                               f"from the CPU in {n} of {a.numel()} words")
    return sum(a.numel() for a in card)


def oracle_draft(torch, prompts) -> tuple:
    """Phase 21 (c'): speculative decoding whose draft is the target
    itself (the same weights), so the accept and window-commit branches
    run at full width. Serves ``prompts`` greedily through one replica;
    returns (results, accepted, proposed)."""
    from distributed_pytorch_training_tpu_torch.experiments.harness import (
        build_slot_engine,
    )
    from distributed_pytorch_training_tpu_torch.serving.router import (
        InProcessReplica,
    )
    from distributed_pytorch_training_tpu_torch.serving.speculative import (
        SpeculativeEngine,
    )

    base = build_slot_engine(MODEL, buckets=SERVE21_BUCKETS,
                             rows=SERVE21_ROWS, max_new_tokens=SERVE21_NEW,
                             page_size=SERVE21_PAGE)
    params = dict(base._params())
    engine = SpeculativeEngine(base.model, base.config, params, base.model,
                               params, spec_k=SPEC21_K, device=base.device)
    del base
    replica = InProcessReplica("oracle", engine)
    try:
        reqs = [replica.submit(p, max_new_tokens=SERVE21_NEW)
                for p in prompts]
        results = [r.result(timeout=600.0) for r in reqs]
    finally:
        replica.stop()
    sched = replica.scheduler
    return results, sched.spec_accepted, sched.spec_proposed


def serving_continuous(torch, dev, flush) -> dict:
    """Phase 21: continuous serving at GPT-2 124M full width through the
    port's entry points (see the module's docstring). Returns the rows,
    the escapes, K1's paged-KV rows ("(b) k1") and the decode-step
    times."""
    import numpy as np

    from distributed_pytorch_training_tpu_torch.experiments.harness import (
        build_serving_engine,
        build_slot_engine,
        load_schedule,
        measure_serving,
        measure_serving_continuous,
    )
    from distributed_pytorch_training_tpu_torch.models import layers
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        quantize_int8_rows,
    )
    from distributed_pytorch_training_tpu_torch.serving.__main__ import run

    common = dict(model_name=MODEL, n_requests=SERVE21_REQUESTS,
                  offered_rps=SERVE21_RPS, buckets=SERVE21_BUCKETS,
                  rows=SERVE21_ROWS, max_new_tokens=SERVE21_NEW)
    paged = dict(common, page_size=SERVE21_PAGE, return_results=True)
    slot21 = dict(buckets=SERVE21_BUCKETS, rows=SERVE21_ROWS,
                  max_new_tokens=SERVE21_NEW, page_size=SERVE21_PAGE)
    prompts, _ = load_schedule(np.random.RandomState(0), SERVE21_REQUESTS,
                               max(SERVE21_BUCKETS), VOCAB, SERVE21_NEW,
                               False)
    gap_engine = build_serving_engine(MODEL, buckets=SERVE21_BUCKETS,
                                      rows=SERVE21_ROWS,
                                      max_new_tokens=SERVE21_NEW)
    out = {}

    def completed(name, row):
        done = row.get("completed", row["n_requests"])
        if done != SERVE21_REQUESTS:
            raise RuntimeError(f"phase 21 {name}: {done} of "
                               f"{SERVE21_REQUESTS} requests completed")
        out[name] = row

    # (a) the iteration- and token-granular rows on one schedule
    dense_row, dense = measure_serving(return_results=True, **common)
    completed("(a) bench", dense_row)
    cont_row, cont = measure_serving_continuous(**paged)
    completed("(a) bench --continuous", cont_row)
    out["(a) escapes"] = stream_escapes(torch, gap_engine, prompts, dense,
                                        cont, "phase 21 (a)")
    for name in ("(a) bench", "(a) bench --continuous"):
        r = out[name]
        log(f"phase 21 {name}: p50 {r['p50_ms']} ms, p99 {r['p99_ms']} ms, "
            f"ttft p50 {r.get('ttft_p50_ms', 'n/a')} ms, "
            f"{r['tokens_per_sec']} tok/s at {r['achieved_rps']}/"
            f"{r['offered_rps']} req/s")
    log(f"phase 21 (a): greedy streams equal but {len(out['(a) escapes'])} "
        f"escapes (top-2 gap < {ESCAPE_GAP}): {out['(a) escapes']}")

    # (b) int8 pages through the CLI, K1 counted and its pages checked
    real, calls, captured = layers._quant_rows, {}, []

    def spy(x):
        q, s = real(x)
        shape = (x.numel() // x.shape[-1], x.shape[-1])
        calls[shape] = calls.get(shape, 0) + 1
        if calls[shape] <= 2:
            captured.append((shape, x.detach().float().reshape(shape)
                             .clone(), q.reshape(shape).clone(),
                             s.reshape(-1).clone()))
        return q, s

    layers._quant_rows = spy
    try:
        quantize_int8_rows.launches = 0
        int8_row = run(["bench", "--continuous", "--kv-dtype", "int8",
                        *SERVE21_FLAGS, *SERVING_OUT])
        launches = quantize_int8_rows.launches
    finally:
        layers._quant_rows = real
    completed("(b) bench --continuous --kv-dtype int8", int8_row)
    if launches == 0 or launches != sum(calls.values()):
        raise RuntimeError(f"phase 21 (b): K1 launched {launches} times for "
                           f"{sum(calls.values())} page writes")
    if not int8_row["kv_bytes_ratio"] >= KV_RATIO_MIN:
        raise RuntimeError(f"phase 21 (b): kv_bytes_ratio "
                           f"{int8_row['kv_bytes_ratio']} < {KV_RATIO_MIN}")
    m = gap_engine.model
    decode_shape = (m.depth * SERVE21_ROWS * m.num_heads,
                    m.hidden_dim // m.num_heads)
    if decode_shape not in calls:
        raise RuntimeError(f"phase 21 (b): no decode-step page write "
                           f"{decode_shape} among {calls}")
    k1_rows = k1_paged_rows(torch, flush, captured, calls)
    out["(b) k1"] = k1_rows
    for r in k1_rows:
        log(f"phase 21 (b) K1 paged KV {r['shape']}: {r['launches']} "
            f"launches, bitwise on {r['checked_calls']} captured calls; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    log(f"phase 21 (b): {launches} K1 launches (2 a decode step, 2 a "
        f"prefill); KV {int8_row['paged_kv_bytes']} B vs dense "
        f"{int8_row['dense_kv_bytes']} B ({int8_row['kv_bytes_ratio']}x); "
        f"p50 {int8_row['p50_ms']} ms, {int8_row['tokens_per_sec']} tok/s")

    # (c) speculative decoding with a GPT-2 124M draft from seed + 1
    spec_row, spec = measure_serving_continuous(draft_model=MODEL, **paged)
    completed("(c) bench --continuous --draft", spec_row)
    out["(c) escapes"] = stream_escapes(torch, gap_engine, prompts, cont,
                                        spec, "phase 21 (c)")
    log(f"phase 21 (c): accept_ratio {spec_row['accept_ratio']} "
        f"({spec_row['accepted_per_verify']} tok/verify, "
        f"{spec_row['spec_rounds']} rounds); streams equal (a)'s "
        f"continuous arm but {len(out['(c) escapes'])} escapes; p50 "
        f"{spec_row['p50_ms']} ms, {spec_row['tokens_per_sec']} tok/s")

    # (c') the oracle draft: the target's own weights propose, so the
    # accept and window-commit branches run at full width
    oracle, accepted, proposed = oracle_draft(torch, prompts)
    ratio = accepted / proposed if proposed else 0.0
    if not ratio >= ORACLE_MIN:
        raise RuntimeError(f"phase 21 (c'): the oracle draft accepted "
                           f"{accepted} of {proposed} proposals")
    out["(c') oracle"] = {"accepted": accepted, "proposed": proposed,
                          "accept_ratio": ratio, "ideal": ORACLE_IDEAL}
    esc = stream_escapes(torch, gap_engine, prompts, cont, oracle,
                         "phase 21 (c')")
    out["(c') escapes"] = esc
    log(f"phase 21 (c'): the oracle draft accepted {accepted} of "
        f"{proposed} proposals ({ratio:.4f}; {ORACLE_IDEAL:.4f} if verify "
        f"and draft agree bitwise); streams equal (a)'s continuous arm but "
        f"{len(esc)} escapes")

    # (d) a shared prompt: admissions with no prefill
    shared_row = run(["bench", "--continuous", "--shared-frac", "0.5",
                      *SERVE21_FLAGS, *SERVING_OUT])
    completed("(d) bench --continuous --shared-frac 0.5", shared_row)
    if not shared_row["prefill_skips"] > 0:
        raise RuntimeError("phase 21 (d): no admission skipped its prefill")
    log(f"phase 21 (d): {shared_row['prefill_skips']} prefill skips, "
        f"{shared_row['tail_resumes']} tail resumes; ttft warm "
        f"{shared_row.get('ttft_warm_p50_ms')} ms vs cold "
        f"{shared_row.get('ttft_cold_p50_ms')} ms")

    # (e) two replicas behind the router, one killed mid-load
    kill_row, killed = measure_serving_continuous(replicas=2,
                                                  kill_replica=True, **paged)
    completed("(e) bench --continuous --replicas 2 --kill-replica", kill_row)
    if not kill_row["replica_deaths"] > 0:
        # requests take ~0.5 s here and r0 takes every other one, so the
        # death (after the ninth submission) finds work in flight
        raise RuntimeError("phase 21 (e): the killed replica had no "
                           "request in flight; nothing was resubmitted")
    out["(e) escapes"] = stream_escapes(torch, gap_engine, prompts, cont,
                                        killed, "phase 21 (e)")
    log(f"phase 21 (e): {kill_row['completed']} completed, "
        f"{kill_row['replica_deaths']} resubmitted after the death, "
        f"per replica {kill_row['per_replica']}; streams equal (a)'s but "
        f"{len(out['(e) escapes'])} escapes")

    # (f) serve in its own process; the sampling key stream on the card
    served = serve_process(torch, prompts[0], prompts[1], SERVE21_NEW)
    out["(f) serve"] = {k: v for k, v in served.items() if k != "log"}
    esc = stream_escapes(torch, gap_engine, prompts[:1], cont[:1],
                         [type(cont[0])(tokens=np.asarray(served["tokens"]),
                                        last_logits=None)], "phase 21 (f)")
    words = prng_card_vs_cpu(torch, dev)
    off = int(np.sum(np.asarray(served["sampled_tokens"])
                     != np.asarray(cont[1].tokens)))
    out["(f) prng_words_bitwise"] = words
    log(f"phase 21 (f): serve ready in {served['ready_s']:.1f} s, "
        f"/generate {served['generate_ms']:.1f} ms for {SERVE21_NEW} "
        f"tokens (stream equals (a)'s but {len(esc)} escapes); the sampled "
        f"request {SERVE21_SAMPLED} twice gave one stream ("
        f"{off} of {SERVE21_NEW} tokens off the greedy one); /healthz, "
        f"SIGTERM drained, exit 0; fold_in and bits bitwise the CPU's on "
        f"{words} words")

    # (g) the decode step with int8 weights (dequantized every call)
    # against fp32 weights, and with int8 pages, every slot live; the
    # step is host-bound, so the three alternate, DECODE_ROUNDS times
    engines = {
        "fp32": build_slot_engine(MODEL, **slot21),
        "int8 weights": build_slot_engine(MODEL, serve_dtype="int8",
                                          **slot21),
        "int8 pages": build_slot_engine(MODEL, kv_dtype="int8", **slot21)}
    step = {name: [] for name in engines}
    for _ in range(DECODE_ROUNDS):
        for name, eng in engines.items():
            step[name].append(decode_step_ms(torch, eng, prompts))
    def alone(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_TIMED_STEPS):
            fn()
        torch.cuda.synchronize()
        return [(time.perf_counter() - t0) * 1e3 / DECODE_TIMED_STEPS]

    deq, eng = engines["int8 weights"], engines["fp32"]
    step["int8 weights' dequantization alone"] = alone(deq._params)
    # a step's token choice: the key stream and sample_tokens over every
    # slot (what the step runs), beside a bare argmax of the same logits
    c = eng._control
    logits = torch.randn((SERVE21_ROWS, eng.model.padded_vocab),
                         generator=torch.Generator(dev).manual_seed(0),
                         device=dev)
    with torch.inference_mode():
        step["sampling alone"] = alone(lambda: eng._sample(
            logits, c["keys"], c["positions"] + 1, c["temps"],
            c["top_ps"]))
        step["argmax alone"] = alone(lambda: torch.argmax(logits, dim=-1))
    del engines, deq, eng, c, logits
    torch.cuda.empty_cache()
    out["(g) decode_step_ms"] = step
    log("phase 21 (g): decode step, 8 live slots, ms a step in "
        f"{DECODE_ROUNDS} alternating rounds: "
        + "; ".join(f"{k} {[round(v, 3) for v in vs]}"
                    for k, vs in step.items()))
    return out


# phase 22: BERT-base masked LM and ViT-B/16 through the port's entry at
# full width (random weights from --seed, synthetic data): BERT at S 512,
# batch 8, one epoch of 8 steps (64 sequences) and 64 // 5 = 12
# validation sequences (2 padded batches); ViT-B/16 at 224x224, batch 64,
# one epoch of 8 steps (512 images) and 102 validation images (2 batches)
BERT, VIT = "bert_base", "vit_b16"
BERT_PARAMS, VIT_PARAMS = 109_514_298, 86_567_656
BERT_SEQ, BERT_SYNTHETIC, BERT_BATCH = 512, 64, 8
BERT_STEPS = BERT_SYNTHETIC // BERT_BATCH
BERT_EVAL = -(-(BERT_SYNTHETIC // 5) // BERT_BATCH)
BERT_FLAGS = ["--model", BERT, "--attention", "flash", "--optimizer",
              "adamw", "--lr", "1e-4", "--synthetic", "--epochs", "1"]
VIT_SYNTHETIC, VIT_BATCH = 512, 64
VIT_STEPS = VIT_SYNTHETIC // VIT_BATCH
VIT_FLAGS = ["--model", VIT, "--dataset", "imagenet", "--synthetic",
             "--synthetic-size", str(VIT_SYNTHETIC), "--batch-size",
             str(VIT_BATCH), "--epochs", "1", "--optimizer", "adamw",
             "--lr", "1e-4", "--print-freq", "4"]
# (e) 2 ranks sharing the card: batch 4 a rank, 48 sequences, 6 steps;
# 48 // 5 = 9 validation sequences, 2 padded global batches of 8; rank 0
# traces steps 2-4
BERT_DP_BATCH, BERT_DP_SYNTHETIC = 4, 48
BERT_DP_STEPS = BERT_DP_SYNTHETIC // (BERT_DP_BATCH * DP_RANKS)
BERT_DP_EVAL = -(-(BERT_DP_SYNTHETIC // 5) // (BERT_DP_BATCH * DP_RANKS))
BERT_PROFILE = (2, 5)


def step_line_rates(text: str) -> tuple:
    """(samples/s, the step line's MFU % or None) of every step line."""
    rates, mfus = [], []
    for ln in text.splitlines():
        if "Throughput: " in ln:
            rates.append(float(ln.split("Throughput: ")[1].split()[0]))
            mfus.append(float(ln.split("MFU: ")[1].rstrip("%"))
                        if "MFU: " in ln else None)
    return rates, mfus


def model_mfu(torch, name: str, inputs, rates: list, context: str,
              **kw) -> tuple:
    """(MFU % per step-line rate, forward FLOPs a sample): 3 x the
    analytic forward matmul and convolution FLOPs of one sample (meta
    tensors, plain attention) against the card's bf16 dense peak;
    ``check_mfu`` raises for an impossible one."""
    from distributed_pytorch_training_tpu_torch.experiments import flops
    from distributed_pytorch_training_tpu_torch.models import get_model

    fwd = flops.matmul_flops(get_model(name, device="meta", **kw), inputs)
    peak = flops.chip_peak_tflops(0)
    if peak is None:
        raise RuntimeError("no bf16 peak for this card")
    out = []
    for rate in rates:
        mfu = flops.mfu_pct(3.0 * fwd, rate, peak)
        warning = flops.check_mfu(mfu, context)
        out.append(mfu)
        if warning:
            log(f"{context}: {warning}")
    return out, fwd


def bert_train(torch, fa, tag: str, extra: list) -> dict:
    """Phase 22 (a) and (c): BERT-base MLM through the port's entry,
    ``BERT_FLAGS`` plus ``extra``, the K3-K5 counts set to 0 just before
    and read just after, the peak of allocated memory over the run
    above what was allocated before it. Returns the launches, the CSV's
    (train, val) losses (finite), the step lines' samples/s and MFU, the
    peak and the final state's digests."""
    import contextlib
    import io

    out_dir = ROOT / "chiprun_out" / f"bert_{tag}"
    (out_dir / "metrics_rank0.csv").unlink(missing_ok=True)
    kernels = [getattr(fa, name) for name in FLASH]
    for fn in kernels:
        fn.launches = 0
    reset_staged(fa)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stdout = io.StringIO()
    try:
        with contextlib.redirect_stdout(stdout):
            state = train_main(BERT_FLAGS + [
                "--synthetic-size", str(BERT_SYNTHETIC), "--batch-size",
                str(BERT_BATCH), "--print-freq", "4", "--output-dir",
                str(out_dir)] + extra)
    finally:
        print(stdout.getvalue(), end="", flush=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {fn.__name__: fn.launches for fn in kernels}
    if staged_copies(fa):
        raise RuntimeError(f"BERT {tag}: staged {staged_copies(fa)} copies "
                           "of the flash inputs")
    log(f"BERT {tag}: 0 staged copies of the flash inputs")
    if state.step != BERT_STEPS or state.model.max_position != BERT_SEQ:
        raise RuntimeError(f"BERT {tag}: {state.step} steps")
    digests = state_digests(state)
    del state
    lines = (out_dir / "metrics_rank0.csv").read_text().splitlines()[1:]
    losses = [(float(ln.split(",")[1]), float(ln.split(",")[3]))
              for ln in lines]
    if len(losses) != 1 or not all(math.isfinite(x) for x in losses[0]):
        raise RuntimeError(f"BERT {tag}: CSV rows {lines}")
    rates, line_mfus = step_line_rates(stdout.getvalue())
    return {"launches": launches, "losses": losses, "rates": rates,
            "step_line_mfu_pct": line_mfus, "peak_bytes": peak,
            "digests": digests}


def flash_want(steps: int, evals: int, remat: bool = False) -> dict:
    """K3-K5 launches of a run: 12 blocks, K3 once a forward (twice a
    training step under remat), K4 and K5 once a backward."""
    return {FLASH[0]: DEPTH * ((2 if remat else 1) * steps + evals),
            FLASH[1]: DEPTH * steps, FLASH[2]: DEPTH * steps}


def check_card_vs_cpu(what: str, r: dict) -> dict:
    """Phase 8's rule: the loss within LOSS_ATOL, every gradient within
    GRAD_REL of its leaf's largest."""
    if not (r["loss_abs_diff"] <= LOSS_ATOL and r["grad_rel"] <= GRAD_REL):
        raise RuntimeError(f"{what} card vs CPU: {r} (tolerances "
                           f"{LOSS_ATOL}, {GRAD_REL})")
    return r


def bert_card_vs_cpu(torch, dev, fa) -> dict:
    """Phase 22 (b): one BERT-base MLM loss-and-backward at full width,
    batch 2 x 512, card against CPU; the masks, drawn from the JAX step
    key on each device, bitwise equal; the card's backward runs K4 and
    K5 once a block."""
    import numpy as np

    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.ops import (
        make_flash_attention_fn,
    )
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        MaskedLMTask,
        StepKey,
    )
    from distributed_pytorch_training_tpu_torch.utils import prng

    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 30522, (2, BERT_SEQ)).astype(np.int32))
    task = MaskedLMTask()
    key = StepKey(prng.fold_in(prng.fold_in(prng.prng_key(0), 0), 0))
    sel_c, in_c = task.mask(ids.to(dev).long(), key)
    sel_h, in_h = task.mask(ids.long(), key)
    if not (torch.equal(sel_c.cpu(), sel_h) and torch.equal(in_c.cpu(),
                                                            in_h)):
        raise RuntimeError("phase 22 (b): the card's masks differ from the "
                           "CPU's")
    before = fa.flash_attention_bwd_dq.launches
    out = check_card_vs_cpu("phase 22 (b)", card_vs_cpu(
        torch, dev, lambda: get_model(
            BERT, attention_fn=make_flash_attention_fn(False)), task,
        {"input_ids": ids, "weight": torch.ones(2)}, key))
    if fa.flash_attention_bwd_dq.launches != before + DEPTH:
        raise RuntimeError("phase 22 (b): the card's backward did not run "
                           "the kernels")
    out["masked_positions"] = int(sel_h.sum())
    return out


def vit_card_vs_cpu(torch, dev) -> dict:
    """Phase 22 (d): one ViT-B/16 loss-and-backward at full width, batch
    2 of 224x224 images (fp32, no augmentation), card against CPU."""
    from distributed_pytorch_training_tpu_torch.data.datasets import (
        IMAGE_STATS,
    )
    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        ImageClassificationTask,
    )

    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randint(0, 256, (2, 224, 224, 3), generator=g,
                                    dtype=torch.uint8),
             "label": torch.tensor([3, 917]), "weight": torch.ones(2)}
    mean, std = IMAGE_STATS["imagenet"]
    return check_card_vs_cpu("phase 22 (d)", card_vs_cpu(
        torch, dev, lambda: get_model(VIT),
        ImageClassificationTask(mean, std, augment=False), batch))


def vit_train(torch) -> dict:
    """Phase 22 (d): ViT-B/16 ``--amp`` on synthetic ImageNet at 224
    through the port's entry: samples/s and MFU of the step lines."""
    import contextlib
    import io

    out_dir = ROOT / "chiprun_out" / "vit_amp"
    (out_dir / "metrics_rank0.csv").unlink(missing_ok=True)
    stdout = io.StringIO()
    try:
        with contextlib.redirect_stdout(stdout):
            state = train_main(VIT_FLAGS + ["--amp", "--output-dir",
                                            str(out_dir)])
    finally:
        print(stdout.getvalue(), end="", flush=True)
    if state.step != VIT_STEPS or state.model.dtype != torch.bfloat16 \
            or tuple(state.model.pos_embedding.shape) != (1, 197, 768):
        raise RuntimeError(f"ViT: {state.step} steps, dtype "
                           f"{state.model.dtype}")
    n = sum(p.numel() for p in state.params)
    del state
    if n != VIT_PARAMS:
        raise RuntimeError(f"ViT-B/16 has {n} parameters")
    lines = (out_dir / "metrics_rank0.csv").read_text().splitlines()[1:]
    losses = [(float(ln.split(",")[1]), float(ln.split(",")[3]))
              for ln in lines]
    if len(losses) != 1 or not all(math.isfinite(x) for x in losses[0]):
        raise RuntimeError(f"ViT: CSV rows {lines}")
    rates, line_mfus = step_line_rates(stdout.getvalue())
    mfus, fwd = model_mfu(torch, VIT, torch.zeros((1, 224, 224, 3),
                                                  device="meta"),
                          rates, "phase 22 (d)", dtype=torch.bfloat16)
    return {"losses": losses, "rates": rates, "mfu_pct": mfus,
            "step_line_mfu_pct": line_mfus, "fwd_flops_per_image": fwd}


def bert_grad_sync_profile(torch, card: str) -> dict:
    """Phase 22 (e), BERT's "grad-sync profiling run": BERT-base on 2
    ranks sharing the card (gloo) with ``--wire-dtype int8`` (one bucket
    of the 109,514,298-float gradient) and ``--profile-dir`` over steps
    2-4 (rank 0 traces): each rank's K1, K2 and K3-K5 launches exact, the
    ranks' evaluated states bitwise equal, and the window's device split
    and collective share (2 gloo ranks on one card: not a scaling
    number)."""
    import shutil

    out_dir = ROOT / "chiprun_out" / "prof_bert_int8"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    prof_dir = out_dir / "prof"
    t0 = time.perf_counter()
    out = run_torchrun([
        str(out_dir), *BERT_FLAGS, "--synthetic-size",
        str(BERT_DP_SYNTHETIC), "--batch-size", str(BERT_DP_BATCH),
        "--print-freq", "2", "--wire-dtype", "int8", "--profile-dir",
        str(prof_dir), "--profile-steps",
        ",".join(map(str, BERT_PROFILE))], timeout=900)
    seconds = time.perf_counter() - t0
    (out_dir / "stdout.txt").write_text(out)
    per_step = wire_launches(torch, "int8", 0.0, params=BERT_PARAMS)
    want = {**flash_want(BERT_DP_STEPS, BERT_DP_EVAL),
            QUANTIZE: BERT_DP_STEPS, DEQUANT: BERT_DP_STEPS}
    if sum(per_step.values()) != 2:
        raise RuntimeError(f"BERT's int8 wire plan {per_step}: expected "
                           "one bucket")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(DP_RANKS)]
    for r, rep in enumerate(ranks):
        if rep["launches"] != want or rep["steps"] != BERT_DP_STEPS:
            raise RuntimeError(f"phase 22 (e) rank {r}: {rep['steps']} "
                               f"steps, launches {rep['launches']} "
                               f"(expected {want})")
    same_across_ranks("phase 22 (e)", ranks)
    steps = BERT_PROFILE[1] - BERT_PROFILE[0]
    w = profile_window(torch, prof_dir, steps)
    log_window(card, "phase 22 (e) BERT-base int8 wire, rank 0 of 2 gloo "
               "ranks on one card", w)
    telemetry_summary_exits_0(out_dir / "telemetry_rank0.jsonl")
    for trace in prof_dir.glob("*.pt.trace.json"):
        w.setdefault("trace_bytes", trace.stat().st_size)
        trace.unlink()
    rates, _ = step_line_rates(out)
    return {**w, "launches_per_rank": want,
            "step_line_samples_per_s": rates, "wall_seconds": seconds}


def bert_and_vit(torch, dev, fa, card: str) -> dict:
    """Phase 22 (a)-(e); see the module docstring."""
    out = {}
    t0 = time.perf_counter()
    for tag, extra in (("fp32", []), ("amp", ["--amp"])):
        run = bert_train(torch, fa, tag, extra)
        want = flash_want(BERT_STEPS, BERT_EVAL)
        if run["launches"] != want:
            raise RuntimeError(f"phase 22 (a) {tag}: launched "
                               f"{run['launches']}, expected {want}")
        run["mfu_pct"], fwd = model_mfu(
            torch, BERT, torch.zeros((1, BERT_SEQ), dtype=torch.long,
                                     device="meta"), run["rates"],
            f"phase 22 (a) {tag}")
        out[f"(a) {tag}"] = run
        log(f"phase 22 (a) BERT-base {tag} [{card}]: launches "
            f"{run['launches']} (12 blocks x {BERT_STEPS} steps, + "
            f"{BERT_EVAL} eval batches for K3); (train, val) loss "
            f"{run['losses']}; step-line samples/s {run['rates']}, MFU % "
            f"{run['mfu_pct']} (step line {run['step_line_mfu_pct']}; 3 x "
            f"{fwd:.6g} FLOPs a sequence); peak allocated "
            f"{run['peak_bytes']} B above the run's start")
        torch.cuda.empty_cache()
    t_b = time.perf_counter()
    out["(b)"] = bert_card_vs_cpu(torch, dev, fa)
    log(f"phase 22 (b) BERT-base 2x{BERT_SEQ} card vs CPU: masks bitwise "
        f"({out['(b)']['masked_positions']} positions); {out['(b)']} "
        f"(tolerances {LOSS_ATOL}, {GRAD_REL}) in "
        f"{time.perf_counter() - t_b:.1f} s")
    torch.cuda.empty_cache()
    remat = bert_train(torch, fa, "remat", ["--remat"])
    want = flash_want(BERT_STEPS, BERT_EVAL, remat=True)
    if remat["launches"] != want:
        raise RuntimeError(f"phase 22 (c): --remat launched "
                           f"{remat['launches']}, expected {want}")
    plain = out["(a) fp32"]
    if remat["losses"] != plain["losses"] \
            or remat["digests"] != plain["digests"]:
        raise RuntimeError(f"phase 22 (c): --remat's losses "
                           f"{remat['losses']} or final state differ from "
                           f"(a)'s {plain['losses']}")
    out["(c) remat"] = remat
    log(f"phase 22 (c) --remat [{card}]: launches {remat['launches']}; "
        f"losses and the final parameters and AdamW moments bitwise (a)'s "
        f"fp32 run; step-line samples/s {remat['rates']} against "
        f"{plain['rates']}; peak allocated {remat['peak_bytes']} B against "
        f"{plain['peak_bytes']} B "
        f"({remat['peak_bytes'] / plain['peak_bytes']:.4f}x)")
    for run in (out["(a) fp32"], out["(a) amp"], remat):
        run.pop("digests")
    torch.cuda.empty_cache()
    out["(d) amp"] = vit_train(torch)
    d = out["(d) amp"]
    log(f"phase 22 (d) ViT-B/16 --amp [{card}]: (train, val) loss "
        f"{d['losses']}; step-line samples/s {d['rates']}, MFU % "
        f"{d['mfu_pct']} (3 x {d['fwd_flops_per_image']:.6g} FLOPs an "
        "image)")
    torch.cuda.empty_cache()
    out["(d) card vs cpu"] = vit_card_vs_cpu(torch, dev)
    log(f"phase 22 (d) ViT-B/16 2x224x224 fp32 card vs CPU: "
        f"{out['(d) card vs cpu']}")
    torch.cuda.empty_cache()
    out["(e)"] = bert_grad_sync_profile(torch, card)
    e = out["(e)"]
    log(f"phase 22 (e) [{card}]: launches per rank {e['launches_per_rank']};"
        f" states bitwise equal across ranks; window collective share "
        f"{e['collective_share']} (2 gloo ranks on one card, not a scaling "
        f"number); step-line samples/s {e['step_line_samples_per_s']}; "
        f"{e['wall_seconds']:.1f} s")
    out["seconds"] = time.perf_counter() - t0
    return out


# phase 23: sequence parallelism. (a) the ring (K6) and Ulysses on
# SP_RANKS gloo ranks sharing the card at GPT-2 124M's attention, S 1024
# split in two: B 8, S/N 512, 12 heads of 64
SP_RANKS = 2
SP_SHAPE = (8, 1024, 12, 64)
SP_REPS = 3
# (b) GPT-2 124M through the port's entry on SP_RANKS ranks, --mesh
# data=1,seq=2: one epoch of SP_STEPS steps of batch 8 over SP_SYNTHETIC
# sequences; SP_SYNTHETIC // 5 = 4 validation sequences, one padded batch
SP_SYNTHETIC, SP_BATCH, SP_STEPS, SP_EVAL = 24, 8, 3, 1
# (b)'s depth: 3 of GPT-2 124M's 12 blocks at full width (cut from 12 to
# 6 with phase 25 added, to 3 with phase 26, to keep the script near
# 1000 s; a block's launches and gloo trips are what the phase checks,
# and each block repeats them)
SP_DEPTH = 3
SP_RUNS = [("ring fp32", "ring", []), ("ring amp", "ring", ["--amp"]),
           ("ulysses fp32", "ulysses", []),
           ("ulysses amp", "ulysses", ["--amp"])]
SP_NOTE = ("2 ranks sharing one card over gloo: correctness and the cost "
           "of the rotation through host memory, not scaling")


def sp_want(mode: str, rank: int, steps: int = SP_STEPS,
            evals: int = SP_EVAL) -> dict:
    """K3-K5 launches of rank ``rank`` over a run: the ring's rank r runs
    the diagonal block and r past blocks (future blocks are skipped), a
    block K3 in every forward and K4 and K5 in every backward; Ulysses
    runs full-sequence attention on its heads, once a block."""
    blocks = rank + 1 if mode == "ring" else 1
    return {FLASH[0]: SP_DEPTH * blocks * (steps + evals),
            FLASH[1]: SP_DEPTH * blocks * steps,
            FLASH[2]: SP_DEPTH * blocks * steps}


def seq_attention_rank(rank: int, store: str, out_dir: str) -> None:
    """Phase 23 (a), one of SP_RANKS processes (gloo, both on cuda:0): the
    ring (``_RingFlash``, K3-K5 around the ring) and Ulysses (the flash
    kernels on 6 heads of the full sequence) on this rank's half of a
    seeded causal (B, S, H, D) problem, forward and backward, in float32
    and bfloat16, held against their plain versions (``_ring_body``,
    ``_local_attention``) and against single-rank K3-K5 on the whole
    sequence; then the wall time of a forward and backward of each
    (both ranks at once) beside single-rank flash and SDPA on the whole
    (B, S) (rank 0 alone). Writes the errors and times."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT))
    from distributed_pytorch_training_tpu_torch.parallel.collectives import (
        AxisGroup,
    )

    ra = importlib.import_module(f"{PACKAGE}.ops.ring_attention")
    ua = importlib.import_module(f"{PACKAGE}.ops.ulysses_attention")
    fa = flash_module()
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=SP_RANKS)
    axis = AxisGroup(None)
    b, s, h, d = SP_SHAPE
    w = s // SP_RANKS
    sl = slice(rank * w, (rank + 1) * w)
    scale = 1.0 / math.sqrt(d)
    report = {}

    def wall_ms(fn, ranks_together: bool) -> float:
        fn()
        torch.cuda.synchronize()
        if ranks_together:
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(SP_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / SP_REPS * 1e3

    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        g = torch.Generator().manual_seed(3)     # the same on both ranks
        q, k, v, do = (torch.randn((b, s, h, d), generator=g).to(dev, dtype)
                       for _ in range(4))
        # single-rank K3-K5 on the whole sequence, this rank's rows
        out_f, lse_f = fa.flash_attention_fwd_lse(q, k, v, True)
        dq_f, dk_f, dv_f = fa.flash_attention_bwd(q, k, v, out_f, lse_f, do,
                                                  True)
        whole = {"out": out_f[:, sl], "lse": lse_f[..., sl],
                 "dq": dq_f[:, sl], "dk": dk_f[:, sl], "dv": dv_f[:, sl]}
        do_l = do[:, sl].contiguous()

        def leaves():
            return [t[:, sl].detach().clone().requires_grad_()
                    for t in (q, k, v)]

        def grads(out, ins):
            return dict(zip(("dq", "dk", "dv"),
                            torch.autograd.grad(out, ins, do_l)))

        for mode in ("ring", "ulysses"):
            ins = leaves()
            if mode == "ring":
                got = {"out": ra.ring_attention_sharded(*ins, axis, True)}
                got.update(grads(got["out"], ins))
                got["lse"] = ra.ring_flash_fwd(
                    *([t.detach()] for t in ins), axis, True, scale)[1][0]
                pins = leaves()
                outs, lses = ra._ring_body(*([t] for t in pins), axis, True,
                                           scale)
                plain = {"out": outs[0], "lse": lses[0].detach()}
                plain.update(grads(outs[0], pins))
            else:
                got = {"out": ua.ulysses_attention_sharded(*ins, axis,
                                                           True)}
                got.update(grads(got["out"], ins))
                pins = leaves()
                out_p = ua.ulysses_attention_sharded(*pins, axis, True,
                                                     use_kernels=False)
                plain = {"out": out_p, **grads(out_p, pins)}
            torch.cuda.synchronize()
            errs = {}
            for ref_name, ref in (("plain", plain), ("whole", whole)):
                for key, want in ref.items():
                    if key not in got:
                        continue        # Ulysses has no global lse
                    tol = FLASH_REL["float32" if key == "lse"
                                    else dtype_name]
                    err = rel_err(torch, got[key], want)
                    errs[f"{key} vs {ref_name}"] = (err, tol)
            ins = leaves()
            fn = ((lambda: grads(ra.ring_attention_sharded(*ins, axis, True),
                                 ins)) if mode == "ring" else
                  (lambda: grads(ua.ulysses_attention_sharded(*ins, axis,
                                                              True), ins)))
            report[f"{mode} {dtype_name}"] = {
                "errors": errs, "fwd_bwd_ms": wall_ms(fn, True)}
            del got, plain, ins, pins
        # the same function on one rank: K3-K5 and SDPA on the whole (B, S)
        dist.barrier()
        if rank == 0:
            fq, fk, fv = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            lq, lk, lv = (t.detach().transpose(1, 2).requires_grad_()
                          for t in (q, k, v))
            ldo = do.transpose(1, 2)

            def flash_fb():
                out = fa.flash_attention(fq, fk, fv, True)
                return torch.autograd.grad(out, (fq, fk, fv), do)

            def sdpa_fb():
                out = F.scaled_dot_product_attention(lq, lk, lv,
                                                     is_causal=True)
                return torch.autograd.grad(out, (lq, lk, lv), ldo)

            report[f"single-rank {dtype_name}"] = {
                "flash_fwd_bwd_ms": wall_ms(flash_fb, False),
                "sdpa_fwd_bwd_ms": wall_ms(sdpa_fb, False)}
        dist.barrier()
        del q, k, v, do, out_f, dq_f, dk_f, dv_f, whole
        torch.cuda.empty_cache()
    Path(out_dir, f"sp_rank{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()


def seq_attention_on_card(torch, card: str) -> dict:
    """Phase 23 (a): SP_RANKS ``seq_attention_rank`` processes on the one
    card; fails when any error is past its tolerance."""
    import tempfile

    import torch.multiprocessing as mp

    out_dir = ROOT / "chiprun_out" / "seq_attention"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(seq_attention_rank,
                           args=(f"{tmp}/store", str(out_dir)),
                           nprocs=SP_RANKS, start_method="spawn")
    ranks = [json.loads((out_dir / f"sp_rank{r}.json").read_text())
             for r in range(SP_RANKS)]
    bad = {}
    for r, rep in enumerate(ranks):
        for run, row in rep.items():
            for name, (err, tol) in row.get("errors", {}).items():
                if not err <= tol:
                    bad[f"rank {r} {run} {name}"] = (err, tol)
    for run, row in ranks[0].items():
        if "errors" in row:
            log(f"phase 23 (a) {run} [{card}]: rank 0 rel err "
                + ", ".join(f"{k} {e:.2e} (tol {t})"
                            for k, (e, t) in row["errors"].items())
                + f"; forward + backward {row['fwd_bwd_ms']:.3f} ms a call, "
                  f"ranks 0 and 1 at once ({SP_NOTE})")
        else:
            log(f"phase 23 (a) {run} [{card}]: forward + backward on the "
                f"whole (B, S) = {SP_SHAPE[:2]}: flash "
                f"{row['flash_fwd_bwd_ms']:.3f} ms, SDPA "
                f"{row['sdpa_fwd_bwd_ms']:.3f} ms")
    if bad:
        raise RuntimeError(f"phase 23 (a): past tolerance: {bad}")
    return {"rank0": ranks[0], "rank1": ranks[1]}


def sp_worker(argv) -> int:
    """One torchrun rank of phase 23 (b): ``train.main`` for each SP_RUNS
    configuration in turn (``--mesh data=1,seq=2``; the process group
    kept between the runs), the launch counts set to 0 just before and
    read just after each; writes each run's launches, steps, step 1's
    exact loss, every step's wall ms (synchronized) and the digests of
    the final parameters."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from distributed_pytorch_training_tpu_torch import train
    from distributed_pytorch_training_tpu_torch.training import Trainer

    fa = flash_module()
    kernels = {name: getattr(fa, name) for name in FLASH}
    out_dir, base_argv = Path(argv[0]), argv[1:]
    rank = int(os.environ["RANK"])
    step = Trainer.train_step
    record = {}

    def timed_step(self, state, batch):
        t0 = time.perf_counter()
        m = step(self, state, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        record["ms"].append((time.perf_counter() - t0) * 1e3)
        if "loss" not in record:
            record["loss"] = float(m["loss_sum"]) / float(m["weight"])
        return m

    cleanup = train.cleanup_distributed
    Trainer.train_step = timed_step
    train.cleanup_distributed = lambda: None    # one group for every run
    report = {}
    try:
        for name, mode, extra in SP_RUNS:
            record.clear()
            record["ms"] = []
            for fn in kernels.values():
                fn.launches = 0
            reset_staged(fa)
            run_dir = out_dir / name.replace(" ", "_")
            state = train_main(base_argv + ["--attention", mode, "--mesh",
                                            "data=1,seq=2", *extra,
                                            "--output-dir", str(run_dir)])
            report[name] = {
                "launches": {k: fn.launches for k, fn in kernels.items()},
                "staged_copies": staged_copies(fa),
                "steps": state.step, "step1_loss": record["loss"],
                "step_ms": record["ms"],
                "digests": {k: tensor_digest(v) for k, v in
                            state.model.state_dict().items()}}
            del state
            torch.cuda.empty_cache()
    finally:
        Trainer.train_step = step
        train.cleanup_distributed = cleanup
    (out_dir / f"rank{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()
    return 0


def sp_reference_loss(torch, amp: bool) -> float:
    """Step 1's loss without sequence parallelism: the first batch of the
    runs' loader through the model the entry builds from the same seed,
    single-rank flash attention on the whole sequence."""
    from distributed_pytorch_training_tpu_torch.data.text import (
        TokenLoader,
        get_token_dataset,
    )
    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.ops import (
        make_flash_attention_fn,
    )
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        LanguageModelingTask,
    )
    from distributed_pytorch_training_tpu_torch.utils import parse_args

    seed = parse_args([]).seed
    dtype = torch.bfloat16 if amp else torch.float32
    dev = torch.device("cuda", 0)
    model = get_model(MODEL, dtype=dtype, depth=SP_DEPTH,
                      attention_fn=make_flash_attention_fn(causal=True))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(dev).train()
    ds = get_token_dataset("gpt2", 1024, train=True,
                           synthetic_size=SP_SYNTHETIC, seed=seed)
    batch = next(iter(TokenLoader(ds, SP_BATCH, shuffle=True, seed=seed,
                                  device=dev).epoch(0)))
    with torch.no_grad():
        _, m, _ = LanguageModelingTask(compute_dtype=dtype).loss_and_metrics(
            model, batch, True)
    return float(m["loss_sum"]) / float(m["weight"])


def sp_train(torch, fa, card: str) -> dict:
    """Phase 23 (b) and (c): GPT-2 124M through ``torchrun`` on SP_RANKS
    ranks sharing the card, each SP_RUNS configuration; every rank's
    launches on the schedule (``sp_want``), the ranks' final parameters
    bitwise equal, step 1's loss within LOSS_ATOL (BF16_LOSS_ATOL under
    ``--amp``) of ``sp_reference_loss``; ms a step and samples/s."""
    out_dir = ROOT / "chiprun_out" / "seq_parallel"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = run_torchrun([str(out_dir), "--model", MODEL, "--model-overrides",
                        f"depth={SP_DEPTH}", "--optimizer",
                        "adamw", "--lr", "6e-4", "--synthetic",
                        "--synthetic-size", str(SP_SYNTHETIC),
                        "--batch-size", str(SP_BATCH), "--epochs", "1",
                        "--print-freq", "1"], timeout=900, nproc=SP_RANKS,
                       mode="--sp-worker")
    (out_dir / "stdout.txt").write_text(out)
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(SP_RANKS)]
    refs = {amp: sp_reference_loss(torch, amp) for amp in (False, True)}
    torch.cuda.empty_cache()
    report = {"wall_seconds": time.perf_counter() - t0}
    for name, mode, extra in SP_RUNS:
        amp = "--amp" in extra
        runs = [rep[name] for rep in ranks]
        for r, run in enumerate(runs):
            if run["launches"] != sp_want(mode, r) or run["steps"] \
                    != SP_STEPS or run["staged_copies"]:
                raise RuntimeError(
                    f"phase 23 (b) {name} rank {r}: {run['steps']} steps, "
                    f"launches {run['launches']}, {run['staged_copies']} "
                    f"staged copies (expected {SP_STEPS}, "
                    f"{sp_want(mode, r)}, 0)")
        same_across_ranks(f"phase 23 (b) {name}", runs)
        log(f"phase 23 (b) {name}: 0 staged copies of the flash inputs on "
            "every rank")
        loss = runs[0]["step1_loss"]
        tol = BF16_LOSS_ATOL if amp else LOSS_ATOL
        diff = abs(loss - refs[amp])
        ms = runs[0]["step_ms"][1:]
        step_ms = sum(ms) / len(ms)
        report[name] = {"launches_per_rank": [r["launches"] for r in runs],
                        "step1_loss": loss, "reference_loss": refs[amp],
                        "loss_abs_diff": diff, "tolerance": tol,
                        "step_ms": runs[0]["step_ms"],
                        "ms_per_step": step_ms,
                        "samples_per_s": SP_BATCH * 1e3 / step_ms}
        log(f"phase 23 (b) {name} [{card}]: launches per rank "
            f"{report[name]['launches_per_rank']}; step 1 loss {loss!r} "
            f"against single-rank flash {refs[amp]!r} (|diff| {diff!r}, "
            f"tolerance {tol}); (c) {step_ms:.1f} ms a step after the "
            f"first, {report[name]['samples_per_s']:.2f} samples/s "
            f"({SP_NOTE})")
        if not diff <= tol:
            raise RuntimeError(f"phase 23 (b) {name}: step 1 loss {loss} "
                               f"differs from {refs[amp]} by {diff}")
    return report


# phase 24: tensor parallelism over the mesh's model axis. GPT-2 124M at
# full width, S 1024, batch TP_BATCH a batch coordinate, weights from one
# seed (the vocab padded to lcm(128, 2) = 128, as the entry pads it at
# model=2). (a) one loss-and-backward at model=2 on TP_RANKS ranks against
# model=1 on one rank from the same global weights; (b) train.main through
# torchrun, one epoch of TP_STEPS steps each run
TP_RANKS = 2
TP_PAD = 128
# 3 of GPT-2 124M's 12 blocks at full width (cut as SP_DEPTH): every
# block makes the same 4 model-axis all-reduces and launches; the
# vocab-parallel embedding and head are whole
TP_DEPTH = 3
TP_OVERRIDES = f"depth={TP_DEPTH}"
TP_PAD_OVERRIDES = f"pad_vocab_to_multiple_of={TP_PAD},depth={TP_DEPTH}"
TP_BATCH, TP_STEPS, TP_EVAL = 8, 3, 1
# synthetic sequences by the batch axes' size: TP_STEPS global batches,
# and // 5 of them give one padded validation batch
TP_SYNTHETIC = {1: TP_BATCH * TP_STEPS, 2: 2 * TP_BATCH * TP_STEPS}
TP_RUNS = {2: [("model=2 fp32", "data=1,model=2", []),
               ("model=2 amp", "data=1,model=2", ["--amp"])],
           4: [("data=2,model=2 fp32", "data=2,model=2", []),
               ("data=2,model=2 fsdp int8", "data=2,model=2",
                ["--fsdp-explicit", "--wire-dtype", "int8"])]}
# the int8 TP x FSDP run's own yardstick: the same wire (--fsdp-explicit
# --wire-dtype int8) at data=2,model=1 on the same rows (two batch
# coordinates of TP_BATCH from TP_SYNTHETIC[2] sequences, the vocab padded
# to TP_PAD as at model=2), run by the 2-rank worker after TP_RUNS[2]; its
# final parameters are what the TP run's are held to
TP_INT8_MODEL1 = ("data=2,model=1 fsdp int8", "data=2",
                  ["--fsdp-explicit", "--wire-dtype", "int8",
                   "--synthetic-size", str(TP_SYNTHETIC[2]),
                   "--model-overrides", TP_PAD_OVERRIDES])
TP_NOTE = ("ranks sharing one card over gloo: correctness, and the cost of "
           "the model axis's all-reduces through host memory, not scaling")
# the int8 wire's losses after step 1 against the fp32 model=1 run's,
# relative (a development run on the H100: 2.44e-2 at step 3)
TP_WIRE_RTOL = 5e-2
# the final parameters' distance from the model=1 run's, as a share of
# that run's movement from the draw: (the worst leaf's, the whole
# model's) bound. Development runs on an NVIDIA H100 80GB HBM3 at 700 W
# read fp32 (0.0042, 2.6e-5); --amp (0.7065, 0.0304) twice, bf16 compute
# noise through Adam's normalized step in the qkv biases; the int8 wire
# held to TP_INT8_MODEL1 (0.6572, 0.1065) twice, the worst in wte, whose
# tiny gradients the two runs' layer groups scale and round to 0 apart
# (held to the fp32 run it read 0.999, 0.66). An update that did nothing
# reads 1.
TP_PARAM_REL = {"fp32": (0.02, 1e-3), "amp": (0.9, 0.1),
                "int8": (0.8, 0.2)}


def tp_first_batch(torch, data: int):
    """The first global batch of the runs' loader at ``data`` batch
    coordinates (the rows every model rank of a coordinate reads), on the
    card."""
    from distributed_pytorch_training_tpu_torch.data.text import (
        TokenLoader,
        get_token_dataset,
    )
    from distributed_pytorch_training_tpu_torch.utils import parse_args

    seed = parse_args([]).seed
    ds = get_token_dataset("gpt2", 1024, train=True,
                           synthetic_size=TP_SYNTHETIC[data], seed=seed)
    return next(iter(TokenLoader(ds, TP_BATCH * data, shuffle=True,
                                 seed=seed, device=torch.device("cuda", 0)
                                 ).epoch(0)))


def tp_global_model(torch, dtype):
    """The global GPT-2 124M the entry draws at model=2 (vocab padded to
    TP_PAD), flash attention, on the CPU."""
    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.ops import (
        make_flash_attention_fn,
    )
    from distributed_pytorch_training_tpu_torch.utils import parse_args

    model = get_model(MODEL, dtype=dtype, pad_vocab_to_multiple_of=TP_PAD,
                      depth=TP_DEPTH,
                      attention_fn=make_flash_attention_fn(causal=True))
    model.reset_parameters(torch.Generator().manual_seed(parse_args([]).seed))
    return model


def tp_step_check(torch, dist, fa) -> dict:
    """Phase 24 (a), inside the 2-rank worker: one loss-and-backward of
    the TP-local model (6 heads a rank, K3-K5 on them) with the model
    axis's all-reduces counted and their bytes summed; the gradients
    gathered to rank 0, which runs the same step at model=1 on the global
    model and compares (the loss within LOSS_ATOL, each gathered gradient
    within GRAD_REL of its leaf's max |g|)."""
    from distributed_pytorch_training_tpu_torch.convert import (
        flax_ordered,
        load_tp_params,
        tp_global_params,
    )
    from distributed_pytorch_training_tpu_torch.parallel.grad_sync import (
        tp_psum_bytes_per_step,
    )
    from distributed_pytorch_training_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_pytorch_training_tpu_torch.parallel.sharding import (
        tp_split_dims,
    )
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        LanguageModelingTask,
    )

    dev = torch.device("cuda", 0)
    mesh = build_mesh(MeshSpec(data=1, model=TP_RANKS))
    tp = mesh.tp()
    full = tp_global_model(torch, torch.float32)
    named = flax_ordered(full.named_parameters())
    split = tp_split_dims([(n, tuple(p.shape)) for n, p in named],
                          full.partition_rules(), tp.size)
    local = full.clone(tp=tp, device="cpu")
    load_tp_params(local, dict(named), split)
    local.to(dev).train()
    batch = tp_first_batch(torch, 1)
    task = LanguageModelingTask()
    kernels = [getattr(fa, name) for name in FLASH]
    before = [k.launches for k in kernels]
    calls = []
    real = dist.all_reduce

    def counting(t, *args, **kwargs):
        if kwargs.get("group") is tp.group:
            calls.append(t.numel() * t.element_size())
        return real(t, *args, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    dist.all_reduce = counting
    try:
        loss, _, _ = task.loss_and_metrics(local, batch, True)
        names = [n for n, _ in flax_ordered(local.named_parameters())]
        params = dict(local.named_parameters())
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = real
    tp_peak = torch.cuda.max_memory_allocated(dev) - base
    launches = [k.launches - b for k, b in zip(kernels, before)]
    # every rank's gradients to rank 0: one list-form gather a leaf
    shards = [{} for _ in range(tp.size)]
    for name, g in zip(names, grads):
        parts = [torch.empty_like(g) for _ in range(tp.size)]
        dist.all_gather(parts, g.contiguous())
        for i, part in enumerate(parts):
            shards[i][name] = part
    del grads
    local.cpu()
    torch.cuda.empty_cache()
    out = {"loss_tp": float(loss), "launches": launches,
           "all_reduces": len(calls), "all_reduce_bytes": sum(calls),
           "tp_peak_allocated": tp_peak}
    if dist.get_rank() == 0:
        b, s = batch["input_ids"].shape
        act = b * s * full.hidden_dim
        out["want_all_reduces"] = 4 * TP_DEPTH + 2 + 2
        # payload: 4 x 12 + 2 activation sums, the CE's 2 (B, S - 1, 2)
        # float32 stats; tp_psum_bytes_per_step counts a ring's 2x of it
        out["want_payload_bytes"] = 4 * act * (4 * TP_DEPTH + 2) + \
            2 * 8 * b * (s - 1)
        out["tp_psum_bytes_per_step"] = tp_psum_bytes_per_step(
            full.hidden_dim, TP_DEPTH, b, s, tp.size, tp_vocab=True)
        whole = tp_global_params(shards, split)
        del shards
        full.to(dev).train()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ref_loss, _, _ = task.loss_and_metrics(full, batch, True)
        ref = dict(zip([n for n, _ in named], torch.autograd.grad(
            ref_loss, [p for _, p in named])))
        torch.cuda.synchronize()
        out["one_rank_peak_allocated"] = torch.cuda.max_memory_allocated(
            dev) - base
        worst, leaf = 0.0, None
        for name, g in ref.items():
            err = float((whole[name] - g).abs().max()
                        / g.abs().max().clamp(min=1e-30))
            if err > worst:
                worst, leaf = err, name
        out.update({"loss_one_rank": float(ref_loss),
                    "loss_abs_diff": abs(float(ref_loss) - float(loss)),
                    "grad_rel": worst, "grad_rel_leaf": leaf})
        del ref, whole
        full.cpu()
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def tp_worker(argv) -> int:
    """One torchrun rank of phase 24: on 2 ranks the (a) step check
    first; then ``train.main`` for each TP_RUNS configuration of this
    world (with ``--bert`` first in ``argv``, phase 26's: the ViT-B/16
    step check, then BERT_TP_RUNS) (the process group kept between the
    runs), the launch counts
    set to 0 and the peak of allocated memory reset just before, read
    just after; writes each run's launches, steps, every step's loss and
    wall ms (synchronized), the at-rest parameter and moment bytes, the
    peak, this rank's model and batch index, each parameter's split dim,
    the digests of the evaluated (materialized) TP-local state, and each
    parameter's squared distance from this rank's slice of the model=1
    run's final parameters (``tp_reference_runs``, under ``ref_dir``)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from distributed_pytorch_training_tpu_torch import train
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        dequant_sum_rows,
        quantize_int8_rows,
    )
    from distributed_pytorch_training_tpu_torch.parallel.sharding import (
        tp_slice,
    )
    from distributed_pytorch_training_tpu_torch.runtime import (
        setup_distributed,
    )
    from distributed_pytorch_training_tpu_torch.training import Trainer

    fa = flash_module()
    kernels = {QUANTIZE: quantize_int8_rows, DEQUANT: dequant_sum_rows,
               **{name: getattr(fa, name) for name in FLASH}}
    bert = argv[:1] == ["--bert"]
    argv = argv[1:] if bert else argv
    out_dir, ref_dir, base_argv = Path(argv[0]), Path(argv[1]), argv[2:]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = setup_distributed(torch.device("cuda")).device
    report = {}
    if bert:
        report["(c)"] = vit_tp_step_check(torch, dist, dev)
    elif world == TP_RANKS:
        report["(a)"] = tp_step_check(torch, dist, fa)
    step, evaluate = Trainer.train_step, Trainer.evaluate
    record = {}

    def timed_step(self, state, batch):
        t0 = time.perf_counter()
        m = step(self, state, batch)
        torch.cuda.synchronize()
        record["ms"].append((time.perf_counter() - t0) * 1e3)
        record["losses"].append(float(m["loss_sum"]) / float(m["weight"]))
        return m

    def digesting_evaluate(self, state, batches):
        out = evaluate(self, state, batches)
        with self.materialized(state):
            record["digests"] = {k: tensor_digest(v) for k, v in
                                 state.model.state_dict().items()}
            named = list(state.model.named_parameters())
            if state.tp is None:
                # TP_INT8_MODEL1: the whole model on every rank, saved
                split, index = {name: None for name, _ in named}, 0
                if rank == 0:
                    torch.save({name: p.detach().cpu() for name, p in named},
                               record["save"])
            else:
                split = dict(zip(state.tp.names, state.tp.split_dims))
                tp, index = state.tp.axis, state.tp.axis.index
                ref = torch.load(record["ref"], mmap=True, weights_only=True)
                record["sq_off"] = {
                    name: float(torch.sum(torch.square(
                        p.detach().double() - tp_slice(
                            ref[name], split[name], tp.size, tp.index
                        ).to(p.device, torch.float64))))
                    for name, p in named}
        record["split"] = split
        record["model_index"] = index
        record["batch_index"] = self.batch_index
        return out

    cleanup = train.cleanup_distributed
    Trainer.train_step, Trainer.evaluate = timed_step, digesting_evaluate
    train.cleanup_distributed = lambda: None    # one group for every run
    runs = (BERT_TP_RUNS if bert else TP_RUNS[world]
            + ([TP_INT8_MODEL1] if world == TP_RANKS else []))
    try:
        for name, mesh, extra in runs:
            record.clear()
            data = world // TP_RANKS
            kind = tp_kind(extra)
            record.update(ms=[], losses=[], sq_off={},
                          ref=tp_ref_path(ref_dir, data, kind),
                          save=tp_ref_path(ref_dir, 2, "int8"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            for fn in kernels.values():
                fn.launches = 0
            reset_staged(fa)
            run_dir = out_dir / name.replace(" ", "_").replace("=", "")
            state = train_main(base_argv + ["--mesh", mesh, *extra,
                                            "--output-dir", str(run_dir)])
            torch.cuda.synchronize()
            moments = [t for slots in state.optimizer.state.values()
                       for t in slots.values() if t.dim() >= 1]
            report[name] = {
                "launches": {k: fn.launches for k, fn in kernels.items()},
                "staged_copies": staged_copies(fa),
                "steps": state.step, "step_ms": record["ms"],
                "losses": record["losses"],
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in state.params),
                "moment_bytes": sum(t.numel() * t.element_size()
                                    for t in moments),
                "peak_allocated": torch.cuda.max_memory_allocated(dev),
                **{k: record[k] for k in ("digests", "split", "sq_off",
                                          "model_index", "batch_index")}}
            del state, moments
            torch.cuda.empty_cache()
    finally:
        Trainer.train_step, Trainer.evaluate = step, evaluate
        train.cleanup_distributed = cleanup
    (out_dir / f"rank{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()
    return 0


def tp_kind(extra: list) -> str:
    """"amp", "int8" or "fp32": what a phase 24 run's flags make it."""
    return "amp" if "--amp" in extra else "int8" if "int8" in extra \
        else "fp32"


def tp_ref_path(ref_dir, data: int, kind: str) -> Path:
    """Where the model=1 run's final parameters for ``data`` batch
    coordinates are kept: fp32 and ``--amp`` (`tp_reference_runs`), the
    int8 wire (TP_INT8_MODEL1). A run at model=2 is held to the model=1
    run of its kind."""
    return Path(ref_dir) / f"model1_data{data}_{kind}.pt"


def tp_reference_runs(torch, flags, ref_dir) -> dict:
    """Phase 24's model=1 runs: for each (batch coordinates, ``--amp``)
    of TP_RUNS, ``train.main`` on this one rank, no mesh, over the same
    global batches (TP_BATCH x data rows a step) from the same draw as
    the TP runs (the vocab padded to TP_PAD): {(data, amp): every step's
    loss, and each leaf's distance from the draw}; the final parameters
    go to `tp_ref_path`, for the TP ranks to hold their slices to."""
    import tempfile

    from distributed_pytorch_training_tpu_torch.training import Trainer

    init = {n: p.detach() for n, p in
            tp_global_model(torch, torch.float32).named_parameters()}
    step = Trainer.train_step
    losses = []

    def recording(self, state, batch):
        m = step(self, state, batch)
        losses.append(float(m["loss_sum"]) / float(m["weight"]))
        return m

    refs = {}
    Trainer.train_step = recording
    try:
        for world, runs in TP_RUNS.items():
            data = world // TP_RANKS
            for amp in sorted({"--amp" in extra for _, _, extra in runs}):
                losses.clear()
                with tempfile.TemporaryDirectory() as tmp:
                    state = train_main(flags + [
                        "--batch-size", str(TP_BATCH * data),
                        "--synthetic-size", str(TP_SYNTHETIC[data]),
                        "--model-overrides", TP_PAD_OVERRIDES,
                        "--output-dir", tmp] + (["--amp"] if amp else []))
                final = {n: p.detach().cpu() for n, p in
                         state.model.named_parameters()}
                del state
                torch.cuda.empty_cache()
                torch.save(final, tp_ref_path(
                    ref_dir, data, "amp" if amp else "fp32"))
                refs[(data, amp)] = {"losses": list(losses), "moved": {
                    n: float(torch.linalg.vector_norm(
                        final[n].double() - init[n].double()))
                    for n in final}}
    finally:
        Trainer.train_step = step
    return refs


def tp_update_check(name: str, runs: list, moved: dict) -> dict:
    """Each leaf's distance from the model=1 run's final parameters,
    over the ranks of batch coordinate 0 (a split leaf's slices summed
    over the model ranks, a replicated leaf once), as a share of that
    run's movement from the draw: {"worst", "leaf", "whole", "rel"
    (every leaf's)}."""
    sq = {}
    for r in runs:
        if r["batch_index"] != 0:
            continue
        for leaf, off in r["sq_off"].items():
            if r["split"][leaf] is not None or r["model_index"] == 0:
                sq[leaf] = sq.get(leaf, 0.0) + off
    if set(sq) != set(moved):
        raise RuntimeError(f"{name}: leaves {sorted(set(sq) ^ set(moved))}"
                           " are not in both the run and model=1's")
    rel = {leaf: math.sqrt(sq[leaf]) / moved[leaf] for leaf in sq}
    leaf = max(rel, key=rel.get)
    return {"worst": rel[leaf], "leaf": leaf, "whole": math.sqrt(
        sum(sq.values()) / sum(m * m for m in moved.values())), "rel": rel}


def tp_int8_launches(torch, n: int, tp: int = TP_RANKS) -> dict:
    """{(kernel, (rows, width)): launches} of one step of the (TP x) FSDP
    int8 wire on ``n`` data ranks, from the layer plan the Trainer builds
    (at ``tp`` > 1 the TP-local one: each model shard's slices, a block's
    replicated leaves in a group of their own): K1 on (1, P) and K2 on
    (n, P/n) per group of P padded elements."""
    from distributed_pytorch_training_tpu_torch.convert import flax_ordered
    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.parallel.grad_sync import (
        build_layer_plan,
    )
    from distributed_pytorch_training_tpu_torch.parallel.sharding import (
        tp_local_struct,
        tp_split_dims,
    )

    model = get_model(MODEL, device="meta", pad_vocab_to_multiple_of=TP_PAD,
                      depth=TP_DEPTH)
    template = [(n_, tuple(p.shape)) for n_, p in
                flax_ordered(model.named_parameters())]
    if tp > 1:
        split = tp_split_dims(template, model.partition_rules(), tp)
        local = tp_local_struct(template, split, tp)
        replicated = {name for name, d in split.items() if d is None}
    else:
        local, replicated = dict(template), None
    named = [(name, torch.empty(local[name], device="meta"))
             for name, _ in template]
    plan = build_layer_plan(named, n, replicated=replicated)
    counts: dict = {}
    for g in plan.groups:
        for key in ((QUANTIZE, (1, n * g.row_size)),
                    (DEQUANT, (n, g.row_size))):
            counts[key] = counts.get(key, 0) + 1
    return counts


def tp_ranks_agree(name: str, ranks: list) -> None:
    """Fail unless every replicated leaf has the same digest on every
    rank, and every split leaf the same digest on the ranks of one model
    index (across the data axis; under ``--fsdp-explicit`` the digests
    are of the parameters gathered from the data ranks' chunks, the same
    on every data rank by construction)."""
    for key, digest in ranks[0]["digests"].items():
        replicated = ranks[0]["split"].get(key) is None
        for r in ranks:
            peers = [o for o in ranks if replicated
                     or o["model_index"] == r["model_index"]]
            if any(o["digests"][key] != r["digests"][key] for o in peers):
                raise RuntimeError(
                    f"{name}: {key} differs across "
                    + ("ranks" if replicated else "the data axis"))


def tp_train(torch, card: str) -> dict:
    """Phase 24: (a) from the 2-rank worker, (b) and (c) from both
    workers' runs (see the module docstring)."""
    out_dir = ROOT / "chiprun_out" / "tensor_parallel"
    out_dir.mkdir(parents=True, exist_ok=True)
    import tempfile

    flags = ["--model", MODEL, "--model-overrides", TP_OVERRIDES,
             "--optimizer", "adamw", "--lr", "6e-4", "--synthetic",
             "--epochs", "1", "--print-freq", "1"]
    report, ranks = {}, {}
    with tempfile.TemporaryDirectory() as ref_dir:
        t0 = time.perf_counter()
        refs = tp_reference_runs(torch, flags, ref_dir)
        report["model1_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for world, data in ((2, 1), (4, 2)):
            sub = out_dir / f"world{world}"
            sub.mkdir(exist_ok=True)
            out = run_torchrun([str(sub), ref_dir, *flags, "--batch-size",
                                str(TP_BATCH), "--synthetic-size",
                                str(TP_SYNTHETIC[data])], timeout=600,
                               nproc=world, mode="--tp-worker")
            (sub / "stdout.txt").write_text(out)
            ranks[world] = [json.loads((sub / f"rank{r}.json").read_text())
                            for r in range(world)]
            if world == TP_RANKS:
                # TP_INT8_MODEL1's movement from the draw, leaf by leaf
                init = {n: p.detach().double() for n, p in tp_global_model(
                    torch, torch.float32).named_parameters()}
                final = torch.load(tp_ref_path(ref_dir, 2, "int8"),
                                   weights_only=True)
                int8_moved = {n: float(torch.linalg.vector_norm(
                    final[n].double() - init[n])) for n in final}
                del init, final
        report["torchrun_seconds"] = time.perf_counter() - t0
    a = ranks[2][0]["(a)"]
    for r, rep in enumerate(ranks[2]):
        got = rep["(a)"]
        if got["launches"] != [TP_DEPTH] * 3 or got["all_reduces"] \
                != a["want_all_reduces"] or got["all_reduce_bytes"] != \
                a["want_payload_bytes"] or got["loss_tp"] != a["loss_tp"]:
            raise RuntimeError(f"phase 24 (a) rank {r}: {got} (expected "
                               f"{TP_DEPTH} launches of each kernel, "
                               f"{a['want_all_reduces']} all-reduces of "
                               f"{a['want_payload_bytes']} B)")
    log(f"phase 24 (a) [{card}]: model=2 loss {a['loss_tp']!r} against "
        f"model=1 {a['loss_one_rank']!r} (|diff| {a['loss_abs_diff']!r}, "
        f"tolerance {LOSS_ATOL}); worst gathered gradient max|diff|/max|g| "
        f"{a['grad_rel']!r} in {a['grad_rel_leaf']} (tolerance {GRAD_REL});"
        f" K3-K5 {TP_DEPTH} launches each a rank on 6 heads; "
        f"{a['all_reduces']} model-axis all-reduces a step (4 x {TP_DEPTH} + "
        f"2 + the CE's 2), {a['all_reduce_bytes']} B of payload a rank "
        f"(tp_psum_bytes_per_step: {a['tp_psum_bytes_per_step']} B at a "
        "ring's 2x); peak allocated for the loss and backward "
        + ", ".join(f"rank {r} {rep['(a)']['tp_peak_allocated']} B"
                    for r, rep in enumerate(ranks[2]))
        + f" against model=1's {a['one_rank_peak_allocated']} B")
    if not (a["loss_abs_diff"] <= LOSS_ATOL and a["grad_rel"] <= GRAD_REL):
        raise RuntimeError(f"phase 24 (a): loss |diff| {a['loss_abs_diff']}"
                           f", gradient {a['grad_rel']} in "
                           f"{a['grad_rel_leaf']}")
    report["(a)"] = {"rank0": a, "tp_peak_allocated_per_rank": [
        rep["(a)"]["tp_peak_allocated"] for rep in ranks[2]]}
    int8_counts = tp_int8_launches(torch, 2)
    want_flash = {FLASH[0]: TP_DEPTH * (TP_STEPS + TP_EVAL),
                  FLASH[1]: TP_DEPTH * TP_STEPS,
                  FLASH[2]: TP_DEPTH * TP_STEPS}
    name = TP_INT8_MODEL1[0]
    runs_ = [rep[name] for rep in ranks[TP_RANKS]]
    want = {**want_flash, **{k: n * TP_STEPS for k, n in per_kernel(
        tp_int8_launches(torch, 2, tp=1)).items()}}
    for r, run in enumerate(runs_):
        if run["launches"] != want or run["steps"] != TP_STEPS \
                or run["staged_copies"] or not all(
                    math.isfinite(x) for x in run["losses"]):
            raise RuntimeError(f"phase 24 (b) {name} rank {r}: "
                               f"{run['steps']} steps, launches "
                               f"{run['launches']}, {run['staged_copies']} "
                               f"staged copies, losses {run['losses']} "
                               f"(expected {TP_STEPS}, {want}, 0, finite)")
    tp_ranks_agree(f"phase 24 (b) {name}", runs_)
    losses = runs_[0]["losses"]
    # a yardstick: its launches stay out of the kernels line's tp_* shares
    report[name] = {"yardstick_launches_a_rank": want, "losses": losses}
    log(f"phase 24 (b) {name} [{card}]: launches a rank {want}, 0 staged "
        f"copies, the gathered parameters bitwise equal on both ranks; "
        f"losses {losses!r}: the int8 TP x FSDP run's yardstick")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise RuntimeError(f"phase 24 (b) {name}: losses {losses} did not "
                           "fall every step")
    for world, runs in TP_RUNS.items():
        data = world // TP_RANKS
        for name, mesh, extra in runs:
            amp = "--amp" in extra
            ref = refs[(data, amp)]
            runs_ = [rep[name] for rep in ranks[world]]
            want = {**want_flash, **{k: 0 for k in (QUANTIZE, DEQUANT)}}
            if "int8" in extra:
                want.update({k: n * TP_STEPS for k, n in
                             per_kernel(int8_counts).items()})
            for r, run in enumerate(runs_):
                if run["launches"] != want or run["steps"] != TP_STEPS \
                        or run["staged_copies"]:
                    raise RuntimeError(
                        f"phase 24 (b) {name} rank {r}: {run['steps']} "
                        f"steps, launches {run['launches']}, "
                        f"{run['staged_copies']} staged copies (expected "
                        f"{TP_STEPS}, {want}, 0)")
                if not all(math.isfinite(x) for x in run["losses"]):
                    raise RuntimeError(f"phase 24 (b) {name} rank {r}: "
                                       f"losses {run['losses']}")
            fsdp = "--fsdp-explicit" in extra
            log(f"phase 24 (b) {name}: 0 staged copies of the flash inputs "
                "on every rank")
            tp_ranks_agree(f"phase 24 (b) {name}", runs_)
            losses = runs_[0]["losses"]
            kind = tp_kind(extra)
            # each step's loss against model=1's: step 1 precedes any
            # update, so the int8 wire's is held to LOSS_ATOL too
            tol = BF16_LOSS_ATOL if amp else LOSS_ATOL
            tols = [tol if i == 0 or kind != "int8"
                    else TP_WIRE_RTOL * abs(x)
                    for i, x in enumerate(ref["losses"])]
            diffs = [abs(x - y) for x, y in zip(losses, ref["losses"])]
            # the int8 wire against TP_INT8_MODEL1, the others against
            # their model=1 run
            update = tp_update_check(
                f"phase 24 (b) {name}", runs_,
                int8_moved if kind == "int8" else ref["moved"])
            ms = runs_[0]["step_ms"][1:]
            step_ms = sum(ms) / len(ms)
            rep = {"launches_per_rank": want, "losses": losses,
                   "reference_losses": ref["losses"],
                   "loss_abs_diffs": diffs, "tolerances": tols,
                   "update": update, "param_rel_bound": TP_PARAM_REL[kind],
                   "step_ms": runs_[0]["step_ms"], "ms_per_step": step_ms,
                   "samples_per_s": TP_BATCH * data * 1e3 / step_ms,
                   "param_bytes_per_rank": [r["param_bytes"] for r in runs_],
                   "moment_bytes_per_rank": [r["moment_bytes"]
                                             for r in runs_],
                   "peak_allocated_per_rank": [r["peak_allocated"]
                                               for r in runs_]}
            report[name] = rep
            log(f"phase 24 (b) {name} [{card}]: launches a rank {want}; "
                "replicated leaves bitwise equal on every rank, split leaves"
                + (" gathered from the data ranks' chunks" if fsdp else
                   " across the data axis")
                + f"; losses {losses!r} against model=1's "
                f"{ref['losses']!r} (|diff| {diffs!r}, tolerances {tols!r});"
                " final parameters off "
                + (f"{TP_INT8_MODEL1[0]}'s" if kind == "int8"
                   else "model=1's") + " by "
                f"{update['worst']!r} of its movement at worst "
                f"({update['leaf']}), {update['whole']!r} over the model "
                f"(bounds {TP_PARAM_REL[kind]}); "
                f"(c) {step_ms:.1f} ms a step after the first, "
                f"{rep['samples_per_s']:.2f} samples/s ({world} {TP_NOTE}); "
                f"at rest a rank: params {rep['param_bytes_per_rank']} B, "
                f"AdamW moments {rep['moment_bytes_per_rank']} B; peak "
                f"allocated {rep['peak_allocated_per_rank']} B")
            if not (all(d <= t for d, t in zip(diffs, tols))
                    and all(b < a for a, b in zip(losses, losses[1:]))):
                raise RuntimeError(f"phase 24 (b) {name}: losses {losses} "
                                   f"differ from model=1's {ref['losses']} "
                                   f"by {diffs} (tolerances {tols}), or "
                                   "did not fall every step")
            worst, whole = TP_PARAM_REL[kind]
            if not (update["worst"] <= worst and update["whole"] <= whole):
                raise RuntimeError(f"phase 24 (b) {name}: the parameters "
                                   f"are off model=1's by {update['worst']}"
                                   f" of its movement in {update['leaf']}, "
                                   f"{update['whole']} over the model "
                                   f"(bounds {TP_PARAM_REL[kind]})")
    # model=1 at rest: the global model's float32 parameters and moments
    n_params = sum(p.numel() for p in tp_global_model(
        torch, torch.float32).parameters())
    report["model1_param_bytes"] = 4 * n_params
    report["model1_moment_bytes"] = 8 * n_params
    report["int8_counts_per_step"] = {f"{k}@{s[0]}x{s[1]}": c for (k, s), c
                                      in int8_counts.items()}
    report["ranks"] = {w: [{k: v for k, v in rep.items()}
                           for rep in rs] for w, rs in ranks.items()}
    log(f"phase 24 (c) [{card}]: model=1 at rest {report['model1_param_bytes']}"
        f" B of parameters, {report['model1_moment_bytes']} B of AdamW "
        "moments (the global model, vocab padded to 128)")
    return report


def tp_kernel_fields(name: str, flash_rows, tp: dict, codec_rows=None,
                     counts=None) -> dict:
    """The tensor-parallel share of a kernel over phase 24 (b)'s runs,
    every rank: K3-K5 (``tp_*`` over the float32 runs, ``tp_bf16_*``
    over ``--amp``) at the 6-head shape (FLASH_CASES' ``ulysses`` rows:
    B 8, S 1024, 6 heads of 64, causal), with SDPA's time; K1 and K2
    (``tp_*``) over the TP x FSDP int8 run at its layer groups' shapes
    (``codec_rows``, ``counts`` a step)."""
    out = {}
    if codec_rows is not None:
        shares = []
        for run, rep in tp.items():
            if not (isinstance(rep, dict) and "launches_per_rank" in rep
                    and "int8" in run):
                continue
            n_ranks = len(rep["peak_allocated_per_rank"])
            shares += [(codec_rows[key], c * TP_STEPS * n_ranks)
                       for key, c in counts.items() if key[0] == name]
        out["tp_launches"] = sum(n for _, n in shares)
        for key in ("ms", "plain_ms", "bound_ms"):
            out["tp_" + key] = sum(r[key] * n for r, n in shares)
        return out
    shape = {r["shape"]: r for r in flash_rows}
    for tag, suffix, prefix in (("fp32", "", "tp_"),
                                ("amp", " bf16", "tp_bf16_")):
        row = shape["ulysses" + suffix]
        n = sum(rep["launches_per_rank"][name]
                * len(rep["peak_allocated_per_rank"])
                for run, rep in tp.items() if isinstance(rep, dict)
                and "launches_per_rank" in rep
                and run.endswith("amp") == (tag == "amp"))
        out[prefix + "launches"] = n
        for key in ("ms", "plain_ms", "bound_ms"):
            out[prefix + key] = row[key][name] * n
        out[prefix + "library_ms"] = (row["sdpa_fwd_ms"]
                                      if name.endswith("fwd_lse")
                                      else row["sdpa_bwd_ms"]) * n
    return out


# phase 25: the mesh's last two axes, GPT-2 124M and gpt2_moe at full
# width, S 1024, batch PP_BATCH a batch coordinate, one epoch of PP_STEPS
# steps (PP_SYNTHETIC sequences; // 5 of them give one padded validation
# batch), weights from one seed. (a) GPipe over data=1,pipe=2 with
# PP_MICROBATCHES microbatches, held to GPT-2 at pipe=1 (the einsum
# attention, as inside the stages); (b) gpt2_moe on one rank (K3-K5 in
# all PP_DEPTH blocks) and one loss-and-backward card vs CPU at batch 1;
# (c)
# expert parallelism over data=1,expert=2, held to (b)'s runs
PP_RANKS = 2
PP_BATCH, PP_STEPS, PP_EVAL = 8, 3, 1
PP_SYNTHETIC = PP_BATCH * PP_STEPS
PP_MICROBATCHES = 4
MOE = "gpt2_moe"
MOE_EXPERTS = 8
# 2 of GPT-2's and gpt2_moe's 12 blocks at full width (cut with phase 27
# added, as SP_DEPTH and TP_DEPTH were cut before: every block repeats a
# stage's rotations and a MoE layer's expert region). The whole script
# read 1058.3 and 1157.1 s in two calls at 6 blocks, and 1179.0 s at 4,
# where this phase took 78.7 s against 39.6-51.1 s at 2 (NVIDIA H100
# 80GB HBM3, 700 W): one block a stage, and gpt2_moe's one MoE layer
# (block 1)
PP_DEPTH = 2
PP_FLAGS = ["--optimizer", "adamw", "--lr", "6e-4", "--synthetic",
            "--epochs", "1", "--print-freq", "1", "--batch-size",
            str(PP_BATCH), "--synthetic-size", str(PP_SYNTHETIC),
            "--model-overrides", f"depth={PP_DEPTH}"]
PIPE_FLAGS = ["--model", MODEL, "--attention", "xla"]
MOE_FLAGS = ["--model", MOE, "--attention", "flash"]
# (name, flags, the one-rank run it is held to)
PP_RUNS = [("pipe=2 fp32", PIPE_FLAGS + ["--mesh", "data=1,pipe=2",
                                         "--microbatches",
                                         str(PP_MICROBATCHES)], "pipe=1 fp32"),
           ("pipe=2 amp", PIPE_FLAGS + ["--mesh", "data=1,pipe=2",
                                        "--microbatches",
                                        str(PP_MICROBATCHES), "--amp"],
            "pipe=1 amp"),
           ("expert=2 fp32", MOE_FLAGS + ["--mesh", "data=1,expert=2"],
            "moe fp32"),
           ("expert=2 amp", MOE_FLAGS + ["--mesh", "data=1,expert=2",
                                         "--amp"], "moe amp")]
PP_ONE_RANK = [("pipe=1 fp32", PIPE_FLAGS), ("pipe=1 amp",
                                             PIPE_FLAGS + ["--amp"]),
               ("moe fp32", MOE_FLAGS), ("moe amp", MOE_FLAGS + ["--amp"])]
PP_NOTE = ("2 ranks sharing one card over gloo: correctness, and the cost "
           "of the rotations and the expert region's sums through host "
           "memory, not scaling")
# the final parameters' distance from the one-rank run's, as a share of
# that run's movement from the draw: (the worst leaf's, the whole
# model's) bound, set as TP_PARAM_REL was (an update that did nothing
# reads 1). A development run on an NVIDIA H100 80GB HBM3 at 700 W read
# pipe=2 fp32 (0.0017, 2.8e-5) and --amp (0.592, 0.039): the stages'
# microbatches of 2 rows round and sum apart from the whole batch of 8,
# and Adam's normalized step carries bf16 noise in the qkv biases, as
# phase 24's TP runs do; expert=2 read (0.0, 0.0) in both, bitwise
# expert=1 (the bounds stay the pipeline's, and the log says whether
# the run was bitwise)
PIPE_PARAM_REL = {"fp32": (0.02, 1e-3), "amp": (0.9, 0.1)}
EXPERT_PARAM_REL = {"fp32": (0.02, 1e-3), "amp": (0.9, 0.1)}


def pp_kind(name: str) -> str:
    return "amp" if name.endswith("amp") else "fp32"


def pp_global_draw(torch, moe: bool):
    """The global model the entry draws (the pipelined GPT-2's stacks at
    2 stages, or gpt2_moe), float32, on the CPU, from the entry's seed."""
    from distributed_pytorch_training_tpu_torch.models import (
        GPT2PipeLMHead,
        get_model,
    )
    from distributed_pytorch_training_tpu_torch.utils import parse_args

    if moe:
        model = get_model(MOE, depth=PP_DEPTH)
    else:
        cfg = get_model(MODEL, device="meta", depth=PP_DEPTH)
        model = GPT2PipeLMHead(num_stages=PP_RANKS,
                               vocab_size=cfg.vocab_size,
                               hidden_dim=cfg.hidden_dim, depth=cfg.depth,
                               num_heads=cfg.num_heads,
                               max_position=cfg.max_position)
    model.reset_parameters(torch.Generator().manual_seed(parse_args([]).seed))
    return model


def pp_ref_path(ref_dir, name: str) -> Path:
    return Path(ref_dir) / (name.replace(" ", "_").replace("=", "") + ".pt")


def pp_recording(torch, record):
    """Trainer.train_step wrapped to record each step's loss, its wall ms
    (synchronized) and, for an MoE model, the mean of its aux losses."""
    from distributed_pytorch_training_tpu_torch.training import Trainer

    step = Trainer.train_step

    def recording(self, state, batch):
        t0 = time.perf_counter()
        m = step(self, state, batch)
        torch.cuda.synchronize()
        record["ms"].append((time.perf_counter() - t0) * 1e3)
        record["losses"].append(float(m["loss_sum"]) / float(m["weight"]))
        aux = getattr(state.model, "aux_losses", None)
        if aux:
            record["aux"].append(float(sum(a.detach() for a in aux))
                                 / len(aux))
        return m

    return step, recording


def pp_one_rank(torch, fa, ref_dir) -> dict:
    """Phase 25's one-rank runs in this process: GPT-2 at pipe=1 (fp32,
    ``--amp``; its final parameters stacked into the pipelined layout,
    ``convert.gpt2_to_pipe_params``) and gpt2_moe ((b): fp32, ``--amp``);
    each run's launches, losses, ms a step, aux losses, at-rest bytes,
    peak allocated and each leaf's movement from the draw; the final
    parameters go to `pp_ref_path` for the 2-rank runs."""
    import tempfile

    from distributed_pytorch_training_tpu_torch.convert import (
        gpt2_to_pipe_params,
    )
    from distributed_pytorch_training_tpu_torch.training import Trainer

    dev = torch.device("cuda", 0)
    kernels = {name: getattr(fa, name) for name in FLASH}
    out = {}
    for moe in (False, True):
        init = {n: p.detach() for n, p in
                pp_global_draw(torch, moe).named_parameters()}
        for name, flags in PP_ONE_RANK:
            if name.startswith("moe") != moe:
                continue
            record = {"ms": [], "losses": [], "aux": []}
            step, recording = pp_recording(torch, record)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            for fn in kernels.values():
                fn.launches = 0
            reset_staged(fa)
            Trainer.train_step = recording
            try:
                with tempfile.TemporaryDirectory() as tmp:
                    state = train_main(PP_FLAGS + flags
                                       + ["--output-dir", tmp])
            finally:
                Trainer.train_step = step
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in kernels.items()}
            moments = [t for slots in state.optimizer.state.values()
                       for t in slots.values() if t.dim() >= 1]
            final = {n: p.detach().cpu() for n, p in
                     state.model.named_parameters()}
            rep = {"launches": launches, "staged_copies": staged_copies(fa),
                   "steps": state.step, "losses": record["losses"],
                   "aux": record["aux"], "step_ms": record["ms"],
                   "param_bytes": sum(p.numel() * p.element_size()
                                      for p in state.params),
                   "moment_bytes": sum(t.numel() * t.element_size()
                                       for t in moments),
                   "peak_allocated": torch.cuda.max_memory_allocated(dev)}
            del state, moments
            torch.cuda.empty_cache()
            if not moe:
                final = gpt2_to_pipe_params(final, PP_RANKS)
            torch.save(final, pp_ref_path(ref_dir, name))
            rep["moved"] = {n: float(torch.linalg.vector_norm(
                final[n].double() - init[n].double())) for n in final}
            out[name] = rep
        del init
    return out


def moe_card_vs_cpu(torch, dev, fa) -> dict:
    """Phase 25 (b): one loss-and-backward of gpt2_moe (router loss
    included) from one draw (seed 0) on the CPU (the plain versions),
    then twice on the card (K3-K5), float32, TF32 off, at batch 1: both
    losses, the worst leaf's max|g diff| / max|g| against the CPU's, and
    whether the card's two runs gave bitwise-equal losses and
    gradients."""
    import numpy as np

    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.ops import (
        make_flash_attention_fn,
    )
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        MoeLanguageModelingTask,
    )

    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, VOCAB, (1, 1024)).astype(np.int32))
    task = MoeLanguageModelingTask()
    model = get_model(MOE, depth=PP_DEPTH,
                      attention_fn=make_flash_attention_fn(True))
    model.reset_parameters(torch.Generator().manual_seed(0))
    runs = []
    for device in (torch.device("cpu"), dev, dev):
        model.to(device)
        model.zero_grad(set_to_none=True)
        before = fa.flash_attention_bwd_dq.launches
        loss, _, _ = task.loss_and_metrics(
            model, {"input_ids": ids.to(device),
                    "weight": torch.ones(1, device=device)}, True)
        loss.backward()
        if device.type == "cuda" and \
                fa.flash_attention_bwd_dq.launches != before + PP_DEPTH:
            raise RuntimeError("the card's MoE backward did not run the "
                               "kernels")
        runs.append((loss.detach().cpu(), {
            n: p.grad.detach().cpu() for n, p in model.named_parameters()}))
        del loss
    del model
    torch.cuda.empty_cache()
    (loss_h, g_h), (loss_c, g_c), (loss_c2, g_c2) = runs
    worst, worst_leaf = 0.0, ""
    for name, ref in g_h.items():
        err = ((g_c[name] - ref).abs().max()
               / ref.abs().max().clamp(min=1e-30)).item()
        if not math.isfinite(err) or err > worst:
            worst, worst_leaf = err, name
    return {"loss_card": float(loss_c), "loss_cpu": float(loss_h),
            "loss_abs_diff": abs(float(loss_c) - float(loss_h)),
            "grad_rel": worst, "grad_rel_leaf": worst_leaf,
            "card_deterministic": torch.equal(loss_c, loss_c2) and all(
                torch.equal(g_c[n], g_c2[n]) for n in g_c)}


def pp_worker(argv) -> int:
    """One torchrun rank of phase 25 (a) and (c): ``train.main`` for each
    PP_RUNS configuration (the process group kept between the runs), the
    launch counts set to 0 and the peak of allocated memory reset just
    before, read just after; writes each run's launches, steps, losses,
    ms a step, aux losses, at-rest bytes, peak, this rank's index on the
    split axis, each parameter's split dim and local shape, the digests
    of the parameters, and each parameter's squared distance from this
    rank's slice of its one-rank run's final parameters (under
    ``ref_dir``)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from distributed_pytorch_training_tpu_torch import train
    from distributed_pytorch_training_tpu_torch.parallel.sharding import (
        tp_slice,
    )
    from distributed_pytorch_training_tpu_torch.runtime import (
        setup_distributed,
    )
    from distributed_pytorch_training_tpu_torch.training import Trainer

    fa = flash_module()
    kernels = {name: getattr(fa, name) for name in FLASH}
    out_dir, ref_dir = Path(argv[0]), Path(argv[1])
    rank = int(os.environ["RANK"])
    dev = setup_distributed(torch.device("cuda")).device
    report = {}
    cleanup = train.cleanup_distributed
    train.cleanup_distributed = lambda: None    # one group for every run
    try:
        for name, flags, ref_name in PP_RUNS:
            record = {"ms": [], "losses": [], "aux": []}
            step, recording = pp_recording(torch, record)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            for fn in kernels.values():
                fn.launches = 0
            reset_staged(fa)
            run_dir = out_dir / name.replace(" ", "_").replace("=", "")
            Trainer.train_step = recording
            try:
                state = train_main(PP_FLAGS + flags
                                   + ["--output-dir", str(run_dir)])
            finally:
                Trainer.train_step = step
            torch.cuda.synchronize()
            tp = state.tp
            split = dict(zip(tp.names, tp.split_dims))
            named = list(state.model.named_parameters())
            ref = torch.load(pp_ref_path(ref_dir, ref_name), mmap=True,
                             weights_only=True)
            sq_off = {n: float(torch.sum(torch.square(
                p.detach().double() - tp_slice(
                    ref[n], split[n], tp.axis.size, tp.axis.index
                ).to(p.device, torch.float64)))) for n, p in named}
            moments = [t for slots in state.optimizer.state.values()
                       for t in slots.values() if t.dim() >= 1]
            report[name] = {
                "launches": {k: fn.launches for k, fn in kernels.items()},
                "staged_copies": staged_copies(fa),
                "steps": state.step, "step_ms": record["ms"],
                "losses": record["losses"], "aux": record["aux"],
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in state.params),
                "moment_bytes": sum(t.numel() * t.element_size()
                                    for t in moments),
                "peak_allocated": torch.cuda.max_memory_allocated(dev),
                "axis": tp.axis_name, "index": tp.axis.index,
                "split": split,
                "shapes": {n: list(p.shape) for n, p in named},
                "digests": {n: tensor_digest(p) for n, p in named},
                "sq_off": sq_off}
            del state, moments, ref
            torch.cuda.empty_cache()
    finally:
        train.cleanup_distributed = cleanup
    (out_dir / f"rank{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()
    return 0


def pp_update_check(name: str, ranks: list, moved: dict) -> dict:
    """Each leaf's distance from the one-rank run's final parameters (a
    split leaf's slices summed over the ranks, a replicated leaf once),
    as a share of that run's movement from the draw: {"worst", "leaf",
    "whole", "bitwise" (every distance 0)}."""
    sq = {}
    for r in ranks:
        for leaf, off in r["sq_off"].items():
            if r["split"][leaf] is not None or r["index"] == 0:
                sq[leaf] = sq.get(leaf, 0.0) + off
    if set(sq) != set(moved):
        raise RuntimeError(f"{name}: leaves {sorted(set(sq) ^ set(moved))}"
                           " are not in both the run and the one-rank run's")
    rel = {leaf: math.sqrt(sq[leaf]) / moved[leaf] for leaf in sq}
    leaf = max(rel, key=rel.get)
    return {"worst": rel[leaf], "leaf": leaf, "whole": math.sqrt(
        sum(sq.values()) / sum(m * m for m in moved.values())),
        "bitwise": all(v == 0.0 for v in sq.values())}


def pp_want(moe: bool) -> dict:
    """K3-K5 launches of one rank over a run: gpt2_moe runs the kernels
    in all PP_DEPTH blocks (K3 in every forward, K4 and K5 in every
    backward); the pipeline's stages run the einsum, no kernel."""
    n = PP_DEPTH if moe else 0
    return {FLASH[0]: n * (PP_STEPS + PP_EVAL), FLASH[1]: n * PP_STEPS,
            FLASH[2]: n * PP_STEPS}


def pp_check_run(name: str, run: dict, moe: bool) -> None:
    if run["launches"] != pp_want(moe) or run["steps"] != PP_STEPS \
            or run["staged_copies"] or not all(
                math.isfinite(x) for x in run["losses"] + run["aux"]):
        raise RuntimeError(f"phase 25 {name}: {run['steps']} steps, "
                           f"launches {run['launches']}, "
                           f"{run['staged_copies']} staged copies, losses "
                           f"{run['losses']}, aux {run['aux']} (expected "
                           f"{PP_STEPS}, {pp_want(moe)}, 0, finite)")
    if not all(b < a for a, b in zip(run["losses"], run["losses"][1:])):
        raise RuntimeError(f"phase 25 {name}: losses {run['losses']} did "
                           "not fall every step")
    if moe and len(run["aux"]) != PP_STEPS:
        raise RuntimeError(f"phase 25 {name}: aux losses {run['aux']}")


def pp_train(torch, fa, card: str) -> dict:
    """Phase 25 (see the module docstring): (b)'s card vs CPU step, the
    one-rank runs in this process, then one torchrun of PP_RANKS ranks
    for (a) and (c)."""
    import tempfile

    dev = torch.device("cuda", 0)
    out_dir = ROOT / "chiprun_out" / "pipe_expert"
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {}
    t0 = time.perf_counter()
    b = moe_card_vs_cpu(torch, dev, fa)
    torch.cuda.empty_cache()
    report["(b) card vs cpu"] = b
    log(f"phase 25 (b) [{card}]: gpt2_moe 1x1024 loss (router loss "
        f"included) card {b['loss_card']!r} cpu {b['loss_cpu']!r} (|diff| "
        f"{b['loss_abs_diff']!r}, tolerance {LOSS_ATOL}); worst gradient "
        f"max|diff|/max|g| {b['grad_rel']!r} in {b['grad_rel_leaf']} "
        f"(tolerance {GRAD_REL}); two card runs bitwise equal: "
        f"{b['card_deterministic']}")
    if not (b["loss_abs_diff"] <= LOSS_ATOL and b["grad_rel"] <= GRAD_REL):
        raise RuntimeError(f"phase 25 (b) card vs CPU: loss |diff| "
                           f"{b['loss_abs_diff']}, gradient {b['grad_rel']}"
                           f" in {b['grad_rel_leaf']}")
    with tempfile.TemporaryDirectory() as ref_dir:
        one = pp_one_rank(torch, fa, ref_dir)
        report["one_rank_seconds"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        out = run_torchrun([str(out_dir), ref_dir], timeout=900,
                           nproc=PP_RANKS, mode="--pp-worker")
        (out_dir / "stdout.txt").write_text(out)
        ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
                 for r in range(PP_RANKS)]
        report["torchrun_seconds"] = time.perf_counter() - t1
    for name, rep in one.items():
        moe = name.startswith("moe")
        pp_check_run(name, rep, moe)
        ms = rep["step_ms"][1:]
        rep["ms_per_step"] = sum(ms) / len(ms)
        rep["samples_per_s"] = PP_BATCH * 1e3 / rep["ms_per_step"]
        log(f"phase 25 {'(b)' if moe else '(a) yardstick'} {name} [{card}]:"
            f" launches {rep['launches']}; losses {rep['losses']!r}"
            + (f"; aux losses {rep['aux']!r}" if moe else "")
            + f"; (d) {rep['ms_per_step']:.1f} ms a step after the first, "
            f"{rep['samples_per_s']:.2f} samples/s; at rest params "
            f"{rep['param_bytes']} B, AdamW moments {rep['moment_bytes']} B;"
            f" peak allocated {rep['peak_allocated']} B")
        report[name] = {k: v for k, v in rep.items() if k != "moved"}
    for name, flags, ref_name in PP_RUNS:
        moe = name.startswith("expert")
        runs = [r[name] for r in ranks]
        ref = one[ref_name]
        kind = pp_kind(name)
        for r, run in enumerate(runs):
            pp_check_run(f"{name} rank {r}", run, moe)
            if run["index"] != r:
                raise RuntimeError(f"phase 25 {name}: rank {r} sits at "
                                   f"{run['axis']} index {run['index']}")
            if moe:
                lo = r * MOE_EXPERTS // PP_RANKS
                for leaf, shape in run["shapes"].items():
                    if leaf.endswith(("moe.wi", "moe.wo")) and \
                            (shape[0] != MOE_EXPERTS // PP_RANKS
                             or run["split"][leaf] != 0):
                        raise RuntimeError(
                            f"phase 25 {name} rank {r}: {leaf} {shape}, "
                            f"not experts [{lo}, "
                            f"{lo + MOE_EXPERTS // PP_RANKS})")
        for leaf, digest in runs[0]["digests"].items():
            if runs[0]["split"][leaf] is None and any(
                    r["digests"][leaf] != digest for r in runs[1:]):
                raise RuntimeError(f"phase 25 {name}: replicated {leaf} "
                                   "differs across ranks")
        if any(r["losses"] != runs[0]["losses"] for r in runs):
            raise RuntimeError(f"phase 25 {name}: the ranks' losses differ")
        losses = runs[0]["losses"]
        tol = BF16_LOSS_ATOL if kind == "amp" else LOSS_ATOL
        diffs = [abs(x - y) for x, y in zip(losses, ref["losses"])]
        update = pp_update_check(f"phase 25 {name}", runs, ref["moved"])
        bound = (EXPERT_PARAM_REL if moe else PIPE_PARAM_REL)[kind]
        ms = runs[0]["step_ms"][1:]
        step_ms = sum(ms) / len(ms)
        rep = {"launches_per_rank": pp_want(moe), "losses": losses,
               "aux": runs[0]["aux"], "reference_losses": ref["losses"],
               "loss_abs_diffs": diffs, "tolerance": tol, "update": update,
               "param_rel_bound": bound, "step_ms": runs[0]["step_ms"],
               "ms_per_step": step_ms,
               "samples_per_s": PP_BATCH * 1e3 / step_ms,
               "param_bytes_per_rank": [r["param_bytes"] for r in runs],
               "moment_bytes_per_rank": [r["moment_bytes"] for r in runs],
               "peak_allocated_per_rank": [r["peak_allocated"]
                                           for r in runs]}
        report[name] = rep
        tag = "(c)" if moe else "(a)"
        log(f"phase 25 {tag} {name} [{card}]: launches a rank "
            f"{pp_want(moe)}; replicated leaves bitwise equal on both ranks"
            + (f", rank r holding experts [4r, 4r+4)" if moe else "")
            + f"; losses {losses!r} against {ref_name}'s "
            f"{ref['losses']!r} (|diff| {diffs!r}, tolerance {tol})"
            + (f"; aux {runs[0]['aux']!r} against {ref['aux']!r}"
               if moe else "")
            + f"; final parameters off {ref_name}'s by {update['worst']!r} "
            f"of its movement at worst ({update['leaf']}), "
            f"{update['whole']!r} over the model (bounds {bound}); bitwise "
            f"{ref_name}'s: {update['bitwise']}; (d) {step_ms:.1f} ms a "
            f"step after the first, {rep['samples_per_s']:.2f} samples/s "
            f"({PP_NOTE}); at rest a rank: params "
            f"{rep['param_bytes_per_rank']} B, AdamW moments "
            f"{rep['moment_bytes_per_rank']} B; peak allocated "
            f"{rep['peak_allocated_per_rank']} B (one rank: "
            f"{ref['param_bytes']}, {ref['moment_bytes']}, "
            f"{ref['peak_allocated']} B)")
        if not all(d <= tol for d in diffs):
            raise RuntimeError(f"phase 25 {name}: losses {losses} differ "
                               f"from {ref_name}'s {ref['losses']} by "
                               f"{diffs} (tolerance {tol})")
        worst, whole = bound
        if not (update["worst"] <= worst and update["whole"] <= whole):
            raise RuntimeError(f"phase 25 {name}: the parameters are off "
                               f"{ref_name}'s by {update['worst']} of its "
                               f"movement in {update['leaf']}, "
                               f"{update['whole']} over the model (bounds "
                               f"{bound})")
    report["ranks"] = ranks
    report["seconds"] = time.perf_counter() - t0
    return report


def moe_kernel_fields(name: str, flash_rows, pp: dict) -> dict:
    """gpt2_moe's share of flash kernel ``name`` over phase 25's runs:
    (b)'s one-rank runs and every rank of (c)'s (``moe_*`` over float32,
    ``moe_bf16_*`` over ``--amp``): launches, and the time, plain time,
    bound and SDPA's time at the training shape (FLASH_CASES' main rows:
    B 8, S 1024, 12 heads of 64, causal) summed over them."""
    shape = {r["shape"]: r for r in flash_rows}
    out = {}
    for tag, row_name, prefix in (("fp32", "main fp32", "moe_"),
                                  ("amp", "main bf16", "moe_bf16_")):
        row = shape[row_name]
        n = pp[f"moe {tag}"]["launches"][name] + PP_RANKS * \
            pp[f"expert=2 {tag}"]["launches_per_rank"][name]
        out[prefix + "launches"] = n
        for key in ("ms", "plain_ms", "bound_ms"):
            out[prefix + key] = row[key][name] * n
        out[prefix + "library_ms"] = (row["sdpa_fwd_ms"]
                                      if name.endswith("fwd_lse")
                                      else row["sdpa_bwd_ms"]) * n
    return out


# phase 26: the models that are not causal LMs. (a) serving ResNet-18,
# ViT-B/16 (the image batch: two 32x32 images, the ViT built for 32x32
# as the JAX engine builds it) and BERT-base (the token batch) at full
# width from --seed, fp32 and int8, through the serving CLI in this
# process; (b) BERT-base on the model axis through train.main, S 512,
# batch BERT_TP_BATCH, one epoch of BERT_TP_STEPS steps (BERT_TP_SYNTHETIC
# sequences, // 5 of them one padded validation batch), fp32 and --amp,
# held to model=1 over the same rows from the same draw; (c) one fp32
# loss-and-backward of ViT-B/16 at model=2 against model=1
SERVE26_MODELS = ("resnet18", "vit_b16", "bert_base")
SERVE26_REPS = 5
# 6 of BERT-base's 12 blocks at full width (as TP_DEPTH cuts GPT-2): every
# block makes the same 4 model-axis all-reduces and K3-K5 launches. At 12
# blocks (b) and (c) took 59.8-86.3 s against 6 blocks' 50.0-72.2 s, and
# the --amp run's final parameters read (1.185, 0.230) against model=1,
# past TP_PARAM_REL's (0.9, 0.1), in the deep blocks' qkv leaves (fp32:
# losses bitwise, (0.008, 0.0002)); NVIDIA H100 80GB HBM3 at 700 W
BERT_TP_DEPTH = 6
BERT_TP_BATCH, BERT_TP_STEPS, BERT_TP_EVAL = 8, 3, 1
BERT_TP_SYNTHETIC = BERT_TP_BATCH * BERT_TP_STEPS
BERT_TP_OVERRIDES = f"pad_vocab_to_multiple_of={TP_PAD},depth={BERT_TP_DEPTH}"
BERT_TP_FLAGS = ["--model", BERT, "--attention", "flash", "--optimizer",
                 "adamw", "--lr", "1e-4", "--synthetic", "--epochs", "1",
                 "--print-freq", "1", "--seq-len", str(BERT_SEQ),
                 "--batch-size", str(BERT_TP_BATCH), "--synthetic-size",
                 str(BERT_TP_SYNTHETIC)]
BERT_TP_RUNS = [("bert model=2 fp32", "data=1,model=2", []),
                ("bert model=2 amp", "data=1,model=2", ["--amp"])]
VIT_TP_BATCH = 8


def serve26_row(torch, report, cpu, images=None) -> dict:
    """Phase 26 (a)'s readings of one smoke ``report``: max |diff| of its
    logits against ``cpu`` (an engine of the same weights on the CPU) and
    ms a call of the same serve on the card (host clock: each call
    fetches its logits, so it ends synchronized)."""
    import numpy as np

    from distributed_pytorch_training_tpu_torch.serving.__main__ import (
        SMOKE_IMAGE_MEAN,
        SMOKE_IMAGE_STD,
    )

    engine = report.engine
    if engine.is_token:
        err = logits_vs_cpu(report, cpu)

        def call():
            engine.serve_tokens(report.prompts[:1])
    else:
        images = np.stack(report.prompts)
        ref = cpu.serve_images(images, SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD)
        err = float(np.abs(np.stack(report.results) - ref).max())

        def call():
            engine.serve_images(images, SMOKE_IMAGE_MEAN, SMOKE_IMAGE_STD)
    call()
    t0 = time.perf_counter()
    for _ in range(SERVE26_REPS):
        call()
    return {"max_abs_err": err,
            "ms_per_call": (time.perf_counter() - t0) * 1e3 / SERVE26_REPS}


def serve_models(torch, dev, flush, card: str) -> dict:
    """Phase 26 (a) (see the module docstring)."""
    import numpy as np

    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        quantize_int8_rows,
        quantize_int8_rows_ref,
    )
    from distributed_pytorch_training_tpu_torch.serving import (
        InferenceEngine,
        QuantizedLeaf,
    )
    from distributed_pytorch_training_tpu_torch.serving.__main__ import run
    from distributed_pytorch_training_tpu_torch.serving.engine import (
        stats_kwargs,
    )

    out, shapes = {}, {}
    for model in SERVE26_MODELS:
        cpu = {}
        for dtype in ("fp32", "int8"):
            quantize_int8_rows.launches = 0
            report = run(["smoke", "--model", model, "--serve-dtype", dtype,
                          *SERVING_OUT])
            launches = quantize_int8_rows.launches
            torch.cuda.synchronize()
            engine = report.engine
            leaves = {n: leaf for n, leaf in engine._served.items()
                      if isinstance(leaf, QuantizedLeaf)}
            if launches != len(leaves) or (dtype == "int8") != bool(leaves):
                raise RuntimeError(f"phase 26 (a) {model} {dtype}: K1 "
                                   f"launched {launches} times for "
                                   f"{len(leaves)} int8 leaves")
            if not cpu:
                # the served model's template holds the seed's weights on
                # the CPU (the engine copied them to the card)
                tmpl = engine.model
                params = {n: p.detach() for n, p in tmpl.named_parameters()}
                for d in ("fp32", "int8"):
                    cpu[d] = InferenceEngine(
                        tmpl, dataclasses.replace(engine.config,
                                                  serve_dtype=d), params,
                        device="cpu", **stats_kwargs(tmpl))
            for name, leaf in leaves.items():
                ref = cpu["int8"]._served[name]
                if not (torch.equal(leaf.q.cpu(), ref.q) and torch.equal(
                        leaf.scale.cpu().view(torch.int32),
                        ref.scale.view(torch.int32))):
                    raise RuntimeError(f"phase 26 (a) {model}: int8 leaf "
                                       f"{name} differs from the CPU's")
                shape = (leaf.q.numel() // leaf.q.shape[-1],
                         leaf.q.shape[-1])
                shapes[shape] = shapes.get(shape, 0) + 1
            row = serve26_row(torch, report, cpu[dtype])
            row.update(k1_launches=launches, int8_leaves=len(leaves),
                       results=len(report.results))
            if engine.is_token:
                bad = [r.tokens.size for r in report.results
                       if r.tokens.size or not np.isfinite(
                           r.last_logits).all()]
            else:
                bad = [r.shape for r in report.results
                       if r.shape != (engine.model.num_classes,)
                       or not np.isfinite(r).all()]
            if bad or not row["max_abs_err"] <= ATOL:
                raise RuntimeError(f"phase 26 (a) {model} {dtype}: {row}, "
                                   f"bad results {bad} (tolerance {ATOL})")
            out[f"{model} {dtype}"] = row
            log(f"phase 26 (a) {model} {dtype} [{card}]: "
                f"{len(report.results)} "
                + ("prompts" if engine.is_token else "images")
                + f", K1 launches {launches} for {len(leaves)} int8 leaves "
                f"(bitwise the CPU's); logits card vs CPU max |diff| "
                f"{row['max_abs_err']!r} (tolerance {ATOL}); "
                f"{row['ms_per_call']:.2f} ms a call (host clock)")
            del report, engine, leaves
        del cpu
        torch.cuda.empty_cache()
    # K1 at every int8 leaf shape the three served models quantize
    k1 = []
    g = torch.Generator(device=dev).manual_seed(0)
    for (n, w), count in sorted(shapes.items()):
        x = torch.randn((n, w), generator=g, device=dev) * 0.02
        q, sc = quantize_int8_rows(x)
        qr, sr = quantize_int8_rows_ref(x)
        if not (torch.equal(q, qr) and torch.equal(
                sc.view(torch.int32), sr.view(torch.int32))):
            raise RuntimeError(f"phase 26 (a): K1 at {n}x{w} differs from "
                               "its plain version")
        # as phase 3 bounds it: 5 B an element and 4 a row moved, 5
        # operations an element
        bytes_ms = (5 * n * w + 4 * n) / BYTES_PER_S * 1e3
        ops_ms = 5 * n * w / FP32_OPS_PER_S * 1e3
        k1.append({"shape": f"{n}x{w}", "main_path_launches": count,
                   "ms": timed_ms(torch, lambda: quantize_int8_rows(x),
                                  flush),
                   "plain_ms": timed_ms(
                       torch, lambda: quantize_int8_rows_ref(x), flush),
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations"})
    out["k1_per_shape"] = k1
    quantize_int8_rows.launches = 0
    bench = run(["bench", "--model", BERT, "--json", *SERVING_OUT])
    if quantize_int8_rows.launches or "tokens_per_sec" in bench or \
            bench["n_requests"] != 24:
        raise RuntimeError(f"phase 26 (a) bench: {bench}")
    out["bench bert_base"] = bench
    log(f"phase 26 (a) serving bench bert_base fp32 [{card}]: p50 "
        f"{bench['p50_ms']} ms, p99 {bench['p99_ms']} ms at "
        f"{bench['achieved_rps']}/{bench['offered_rps']} req/s "
        f"({bench['n_requests']} requests; no token rate: BERT generates "
        "none); K1 at the int8 leaves' shapes bitwise its plain version, "
        + ", ".join(f"{r['shape']} x{r['main_path_launches']} "
                    f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                    f"{r['bound_ms']:.4f})" for r in k1))
    return out


def vit_tp_step_check(torch, dist, dev) -> dict:
    """Phase 26 (c), inside the 2-rank worker: one fp32 loss-and-backward
    of ViT-B/16 (224x224 images of one seed, batch VIT_TP_BATCH, no
    augmentation) at model=2 with the model axis's all-reduces counted;
    the gradients gathered to rank 0, which runs the same step at
    model=1 on the global model and compares (the loss within LOSS_ATOL,
    each gathered gradient within GRAD_REL of its leaf's max |g|)."""
    from distributed_pytorch_training_tpu_torch.convert import (
        flax_ordered,
        load_tp_params,
        tp_global_params,
    )
    from distributed_pytorch_training_tpu_torch.data.datasets import (
        IMAGE_STATS,
    )
    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributed_pytorch_training_tpu_torch.parallel.sharding import (
        tp_split_dims,
    )
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        ImageClassificationTask,
    )
    from distributed_pytorch_training_tpu_torch.utils import parse_args

    mesh = build_mesh(MeshSpec(data=1, model=TP_RANKS))
    tp = mesh.tp()
    seed = parse_args([]).seed
    full = get_model(VIT, image_size=224)
    full.reset_parameters(torch.Generator().manual_seed(seed))
    named = flax_ordered(full.named_parameters())
    split = tp_split_dims([(n, tuple(p.shape)) for n, p in named],
                          full.partition_rules(), tp.size)
    local = full.clone(tp=tp, device="cpu")
    load_tp_params(local, dict(named), split)
    local.to(dev).train()
    g = torch.Generator().manual_seed(seed)
    batch = {"image": torch.randint(0, 256, (VIT_TP_BATCH, 224, 224, 3),
                                    generator=g, dtype=torch.uint8),
             "label": torch.randint(0, 1000, (VIT_TP_BATCH,), generator=g),
             "weight": torch.ones(VIT_TP_BATCH)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    task = ImageClassificationTask(*IMAGE_STATS["imagenet"], augment=False)
    calls = []
    real = dist.all_reduce

    def counting(t, *args, **kwargs):
        if kwargs.get("group") is tp.group:
            calls.append(t.numel() * t.element_size())
        return real(t, *args, **kwargs)

    dist.all_reduce = counting
    try:
        loss, _, _ = task.loss_and_metrics(local, batch, True)
        names = [n for n, _ in flax_ordered(local.named_parameters())]
        params = dict(local.named_parameters())
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = real
    shards = [{} for _ in range(tp.size)]
    for name, grad in zip(names, grads):
        parts = [torch.empty_like(grad) for _ in range(tp.size)]
        dist.all_gather(parts, grad.contiguous())
        for i, part in enumerate(parts):
            shards[i][name] = part
    del grads
    local.cpu()
    torch.cuda.empty_cache()
    out = {"loss_tp": float(loss.detach()), "all_reduces": len(calls),
           "all_reduce_bytes": sum(calls)}
    if dist.get_rank() == 0:
        whole = tp_global_params(shards, split)
        del shards
        full.to(dev).train()
        ref_loss, _, _ = task.loss_and_metrics(full, batch, True)
        ref = dict(zip([n for n, _ in named], torch.autograd.grad(
            ref_loss, [p for _, p in named])))
        worst, leaf = 0.0, None
        for name, grad in ref.items():
            err = float((whole[name] - grad).abs().max()
                        / grad.abs().max().clamp(min=1e-30))
            if err > worst:
                worst, leaf = err, name
        out.update({"loss_one_rank": float(ref_loss),
                    "loss_abs_diff": abs(float(ref_loss) - float(loss)),
                    "grad_rel": worst, "grad_rel_leaf": leaf,
                    "want_all_reduces": 4 * len(full.blocks)})
        del ref, whole
        full.cpu()
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def bert_tp_global(torch, dtype):
    """The global BERT the entry draws at model=2 (vocab padded to
    TP_PAD, BERT_TP_DEPTH blocks), on the CPU."""
    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.utils import parse_args

    model = get_model(BERT, dtype=dtype, pad_vocab_to_multiple_of=TP_PAD,
                      depth=BERT_TP_DEPTH)
    model.reset_parameters(torch.Generator().manual_seed(parse_args([]).seed))
    return model


def bert_tp_train(torch, card: str) -> dict:
    """Phase 26 (b) and (c): the model=1 runs in this process, then one
    2-rank torchrun (see the module docstring)."""
    import tempfile

    from distributed_pytorch_training_tpu_torch.training import Trainer

    out_dir = ROOT / "chiprun_out" / "bert_tp"
    out_dir.mkdir(parents=True, exist_ok=True)
    init = {n: p.detach().double() for n, p in
            bert_tp_global(torch, torch.float32).named_parameters()}
    step = Trainer.train_step
    losses = []

    def recording(self, state, batch):
        m = step(self, state, batch)
        losses.append(float(m["loss_sum"]) / float(m["weight"]))
        return m

    refs, report = {}, {}
    with tempfile.TemporaryDirectory() as ref_dir:
        t0 = time.perf_counter()
        Trainer.train_step = recording
        try:
            for amp in (False, True):
                losses.clear()
                with tempfile.TemporaryDirectory() as tmp:
                    state = train_main(BERT_TP_FLAGS + [
                        "--model-overrides", BERT_TP_OVERRIDES,
                        "--output-dir", tmp] + (["--amp"] if amp else []))
                final = {n: p.detach().cpu() for n, p in
                         state.model.named_parameters()}
                del state
                torch.cuda.empty_cache()
                kind = "amp" if amp else "fp32"
                torch.save(final, tp_ref_path(ref_dir, 1, kind))
                refs[kind] = {"losses": list(losses), "moved": {
                    n: float(torch.linalg.vector_norm(
                        final[n].double() - init[n])) for n in final}}
                del final
        finally:
            Trainer.train_step = step
        report["model1_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stdout = run_torchrun(["--bert", str(out_dir), ref_dir,
                               *BERT_TP_FLAGS, "--model-overrides",
                               f"depth={BERT_TP_DEPTH}"], timeout=600,
                              nproc=TP_RANKS, mode="--tp-worker")
        (out_dir / "stdout.txt").write_text(stdout)
        report["torchrun_seconds"] = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(TP_RANKS)]
    c = ranks[0]["(c)"]
    for r, rep in enumerate(ranks):
        got = rep["(c)"]
        if got["all_reduces"] != c["want_all_reduces"] \
                or got["loss_tp"] != c["loss_tp"]:
            raise RuntimeError(f"phase 26 (c) rank {r}: {got} (expected "
                               f"{c['want_all_reduces']} all-reduces and "
                               "rank 0's loss)")
    log(f"phase 26 (c) ViT-B/16 {VIT_TP_BATCH}x224x224 [{card}]: model=2 "
        f"loss {c['loss_tp']!r} against model=1 {c['loss_one_rank']!r} "
        f"(|diff| {c['loss_abs_diff']!r}, tolerance {LOSS_ATOL}); worst "
        f"gathered gradient max|diff|/max|g| {c['grad_rel']!r} in "
        f"{c['grad_rel_leaf']} (tolerance {GRAD_REL}); {c['all_reduces']} "
        f"model-axis all-reduces a step, {c['all_reduce_bytes']} B")
    if not (c["loss_abs_diff"] <= LOSS_ATOL and c["grad_rel"] <= GRAD_REL):
        raise RuntimeError(f"phase 26 (c): loss |diff| {c['loss_abs_diff']}"
                           f", gradient {c['grad_rel']} in "
                           f"{c['grad_rel_leaf']}")
    report["(c)"] = c
    want = {FLASH[0]: BERT_TP_DEPTH * (BERT_TP_STEPS + BERT_TP_EVAL),
            FLASH[1]: BERT_TP_DEPTH * BERT_TP_STEPS,
            FLASH[2]: BERT_TP_DEPTH * BERT_TP_STEPS, QUANTIZE: 0,
            DEQUANT: 0}
    for name, _, extra in BERT_TP_RUNS:
        kind = tp_kind(extra)
        ref = refs[kind]
        runs = [rep[name] for rep in ranks]
        for r, run in enumerate(runs):
            if run["launches"] != want or run["steps"] != BERT_TP_STEPS \
                    or run["staged_copies"] or not all(
                        math.isfinite(x) for x in run["losses"]):
                raise RuntimeError(
                    f"phase 26 (b) {name} rank {r}: {run['steps']} steps, "
                    f"launches {run['launches']}, {run['staged_copies']} "
                    f"staged copies, losses {run['losses']} (expected "
                    f"{BERT_TP_STEPS}, {want}, 0, finite)")
        tp_ranks_agree(f"phase 26 (b) {name}", runs)
        losses_ = runs[0]["losses"]
        tol = BF16_LOSS_ATOL if kind == "amp" else LOSS_ATOL
        diffs = [abs(x - y) for x, y in zip(losses_, ref["losses"])]
        update = tp_update_check(f"phase 26 (b) {name}", runs, ref["moved"])
        ms = runs[0]["step_ms"][1:]
        step_ms = sum(ms) / len(ms)
        rep = {"launches_per_rank": want, "losses": losses_,
               "reference_losses": ref["losses"], "loss_abs_diffs": diffs,
               "tolerance": tol, "update": update,
               "param_rel_bound": TP_PARAM_REL[kind],
               "step_ms": runs[0]["step_ms"], "ms_per_step": step_ms,
               "samples_per_s": BERT_TP_BATCH * 1e3 / step_ms,
               "param_bytes_per_rank": [r["param_bytes"] for r in runs],
               "peak_allocated_per_rank": [r["peak_allocated"]
                                           for r in runs]}
        report[name] = rep
        log(f"phase 26 (b) BERT-base ({BERT_TP_DEPTH} blocks) {name} "
            f"[{card}]: launches a rank {want}, 0 staged copies; replicated "
            f"leaves bitwise equal on both ranks; losses {losses_!r} "
            f"against model=1's {ref['losses']!r} (|diff| {diffs!r}, "
            f"tolerance {tol}); final parameters off model=1's by "
            f"{update['worst']!r} of its movement at worst "
            f"({update['leaf']}), {update['whole']!r} over the model "
            f"(bounds {TP_PARAM_REL[kind]}); {step_ms:.1f} ms a step after "
            f"the first, {rep['samples_per_s']:.2f} samples/s ({TP_RANKS} "
            f"{TP_NOTE}); params {rep['param_bytes_per_rank']} B, peak "
            f"allocated {rep['peak_allocated_per_rank']} B a rank")
        worst, whole = TP_PARAM_REL[kind]
        if not (all(d <= tol for d in diffs) and update["worst"] <= worst
                and update["whole"] <= whole):
            raise RuntimeError(f"phase 26 (b) {name}: loss |diff| {diffs} "
                               f"(tolerance {tol}), parameters off by "
                               f"{update['worst']} in {update['leaf']}, "
                               f"{update['whole']} over the model (bounds "
                               f"{TP_PARAM_REL[kind]})")
    return report


def serve_tp_kernel_fields(name: str, flash_rows, served: dict,
                           bert_tp: dict) -> dict:
    """Phase 26's share of a kernel: K1's ``serve_*`` over (a)'s int8
    weights at their shapes; K3-K5's ``bert_tp_*`` (fp32) and
    ``bert_tp_bf16_*`` (``--amp``) over (b)'s runs, both ranks, at BERT's
    6-head shape, with SDPA's time."""
    out = {}
    if name == QUANTIZE:
        rows = served["k1_per_shape"]
        out["serve_launches"] = sum(r["main_path_launches"] for r in rows)
        for key in ("ms", "plain_ms", "bound_ms"):
            out["serve_" + key] = sum(r[key] * r["main_path_launches"]
                                      for r in rows)
        return out
    if name not in FLASH:
        return out
    shape = {r["shape"]: r for r in flash_rows}
    for run, (suffix, prefix) in (("bert model=2 fp32", ("", "bert_tp_")),
                                  ("bert model=2 amp",
                                   (" bf16", "bert_tp_bf16_"))):
        row = shape["bert tp" + suffix]
        rep = bert_tp[run]
        n = rep["launches_per_rank"][name] * len(
            rep["peak_allocated_per_rank"])
        out[prefix + "launches"] = n
        for key in ("ms", "plain_ms", "bound_ms"):
            out[prefix + key] = row[key][name] * n
        out[prefix + "library_ms"] = (row["sdpa_fwd_ms"]
                                      if name.endswith("fwd_lse")
                                      else row["sdpa_bwd_ms"]) * n
    return out


# phase 27: the rest of the training mesh, GPT-2 124M and gpt2_moe at
# full width cut to TP_DEPTH blocks, S 1024, MESH_BATCH rows a batch
# coordinate, one epoch of MESH_STEPS steps and one padded evaluation
# batch, weights from one seed, through train.main. (a) the fsdp axis:
# fsdp=2 against data=2, fsdp=2,model=2 against data=2,model=2 (the same
# rows: fsdp is a batch axis); (b) --zero1 on data=2,model=2 against the
# run without it; (c) seq=2,model=2 under ring and Ulysses, fp32 and
# --amp, step 1's loss against single-rank flash; (d) gpt2_moe at
# model=2 against model=1 (the vocab padded to TP_PAD in both) and at
# seq=2 under ring against seq=1 (flash). The 4-rank runs share one
# torchrun, the 2-rank runs another; the one-rank runs are this
# process's
MESH_BATCH, MESH_STEPS, MESH_EVAL = 8, 2, 1
# synthetic sequences by the batch axes' size: MESH_STEPS global batches,
# and // 5 of them give one padded validation batch
MESH_SYNTHETIC = {1: MESH_BATCH * MESH_STEPS, 2: 2 * MESH_BATCH * MESH_STEPS}
MESH_FLAGS = ["--optimizer", "adamw", "--lr", "6e-4", "--synthetic",
              "--epochs", "1", "--print-freq", "1", "--batch-size",
              str(MESH_BATCH)]


def _mesh_flags(model: str, attention: str, mesh: str, pad: bool = False):
    overrides = TP_PAD_OVERRIDES if pad else TP_OVERRIDES
    return (["--model", model, "--model-overrides", overrides,
             "--attention", attention]
            + (["--mesh", mesh] if mesh else []))


# world -> [(name, flags, batch coordinates)]
MESH_RUNS = {
    4: [("fsdp=2,model=2 fp32", _mesh_flags(MODEL, "flash",
                                            "fsdp=2,model=2"), 2),
        ("data=2,model=2 fp32", _mesh_flags(MODEL, "flash",
                                            "data=2,model=2"), 2),
        ("data=2,model=2 zero1 fp32", _mesh_flags(
            MODEL, "flash", "data=2,model=2") + ["--zero1"], 2),
        ("seq=2,model=2 ring fp32", _mesh_flags(MODEL, "ring",
                                                "seq=2,model=2"), 1),
        ("seq=2,model=2 ring amp", _mesh_flags(
            MODEL, "ring", "seq=2,model=2") + ["--amp"], 1),
        ("seq=2,model=2 ulysses fp32", _mesh_flags(
            MODEL, "ulysses", "seq=2,model=2"), 1),
        ("seq=2,model=2 ulysses amp", _mesh_flags(
            MODEL, "ulysses", "seq=2,model=2") + ["--amp"], 1)],
    2: [("data=2 fp32", _mesh_flags(MODEL, "flash", "data=2"), 2),
        ("fsdp=2 fp32", _mesh_flags(MODEL, "flash", "fsdp=2"), 2),
        ("moe model=2 fp32", _mesh_flags(MOE, "flash", "model=2"), 1),
        ("moe seq=2 ring fp32", _mesh_flags(MOE, "ring", "seq=2"), 1)],
    1: [("moe model=1 fp32", _mesh_flags(MOE, "flash", "", pad=True), 1),
        ("moe seq=1 fp32", _mesh_flags(MOE, "flash", ""), 1)],
}
# a q, k or v part of an attention's qkv.bias whose gradient at the
# yardstick's draw is at most this share of its leaf's is zero up to
# rounding: the key bias, since softmax is invariant to a per-query
# shift. Adam's normalized update turns such a gradient's rounding into
# steps of up to lr that differ between any two runs that round apart (a
# development run of the ring against flash on an NVIDIA H100 80GB HBM3
# at 700 W read 0.0826 of its movement in blocks.1.attn.qkv.bias), so
# the parameters' bound leaves those parts out, and their readings are
# logged on their own
ZERO_GRAD_REL = 1e-3
QKV_PARTS = ("q", "k", "v")
# (run, its yardstick, whose draw pads the vocab); every pair's final
# parameters are held to TP_PARAM_REL["fp32"]
MESH_PAIRS = [("fsdp=2 fp32", "data=2 fp32", False),
              ("fsdp=2,model=2 fp32", "data=2,model=2 fp32", True),
              ("data=2,model=2 zero1 fp32", "data=2,model=2 fp32", True),
              ("moe model=2 fp32", "moe model=1 fp32", True),
              ("moe seq=2 ring fp32", "moe seq=1 fp32", False)]
MESH_NOTE = ("ranks sharing one card over gloo: correctness, and the cost "
             "through host memory, not scaling")
# the at-rest bytes of a sharded run against its yardstick's, a rank: the
# fsdp axis's parameters and moments (every kernel and embedding on 2
# ranks: half, but LayerNorms and biases whole), ZeRO-1's moments
MESH_REST_SHARE = 0.55


def mesh_case_launches(name: str, seq_index: int) -> dict:
    """{FLASH_CASES shape: {kernel: launches}} of phase 27 run ``name`` on
    a rank at ``seq_index``: a block's K3 in every forward, K4 and K5 in
    every backward, at the shape each run gives them (the ring's rank s
    runs the diagonal block and s past ones; Ulysses 3 heads of the
    whole sequence)."""
    fwd, bwd = TP_DEPTH * (MESH_STEPS + MESH_EVAL), TP_DEPTH * MESH_STEPS
    amp = " bf16" if name.endswith("amp") else ""

    def one(shape, blocks=1):
        return {shape: {FLASH[0]: fwd * blocks, FLASH[1]: bwd * blocks,
                        FLASH[2]: bwd * blocks}}

    if "ring" in name and "model=2" in name:
        out = one("sp tp ring" + amp)
        if seq_index:
            out.update(one("bert tp" + amp, seq_index))
        return out
    if "ulysses" in name:
        return one("sp tp ulysses" + amp)
    if "ring" in name:                      # gpt2_moe at seq=2: 12 heads
        out = one("ring diagonal" + amp)
        if seq_index:
            out.update(one("bert non-causal" + amp, seq_index))
        return out
    if "model=2" in name:                   # 6 of the 12 heads a rank
        return one("ulysses" + amp)
    return one("main fp32" if not amp else "main bf16")


def mesh_want(name: str, seq_index: int) -> dict:
    """K3-K5 launches a rank of phase 27 run ``name`` (K1 and K2: none)."""
    want = {QUANTIZE: 0, DEQUANT: 0, **{k: 0 for k in FLASH}}
    for counts in mesh_case_launches(name, seq_index).values():
        for k, n in counts.items():
            want[k] += n
    return want


def mesh_run(torch, kernels, fa, argv, save=None) -> dict:
    """One phase 27 run of ``train.main`` in this process, the launch
    counts set to 0 just before and read just after: every step's loss,
    wall ms (synchronized) and, for gpt2_moe, aux losses and dropped
    assignments (those sent to the overflow bin, over this rank's rows);
    the at-rest parameter and moment bytes; this rank's coordinates. The
    final global parameters (``checkpoint.global_params``, a collective)
    go to ``save`` from rank 0."""
    import torch.distributed as dist

    from distributed_pytorch_training_tpu_torch.models.moe import (
        expert_capacity,
    )
    from distributed_pytorch_training_tpu_torch.training import Trainer
    from distributed_pytorch_training_tpu_torch.training.checkpoint import (
        global_params,
    )

    record = {"ms": [], "losses": [], "aux": [], "dropped": []}
    step = Trainer.train_step

    def recording(self, state, batch):
        t0 = time.perf_counter()
        m = step(self, state, batch)
        torch.cuda.synchronize()
        record["ms"].append((time.perf_counter() - t0) * 1e3)
        record["losses"].append(float(m["loss_sum"]) / float(m["weight"]))
        record["coords"] = self.mesh.coords()
        model = state.model
        if getattr(model, "aux_losses", None):
            record["aux"].append([a.item() for a in model.aux_losses])
            dropped = 0
            for block in model.blocks:
                moe = getattr(block, "moe", None)
                if moe is None:
                    continue
                dest = moe.last_dispatch
                cap = expert_capacity(dest.shape[1] // moe.top_k, moe.top_k,
                                      moe.num_experts, moe.capacity_factor)
                dropped += int((dest == moe.num_experts * cap).sum())
            record["dropped"].append(dropped)
        return m

    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    reset_staged(fa)
    Trainer.train_step = recording
    t0 = time.perf_counter()
    try:
        state = train_main(argv)
    finally:
        Trainer.train_step = step
    torch.cuda.synchronize()
    run_seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    moments = [t for slots in state.optimizer.state.values()
               for t in slots.values() if t.dim() >= 1]
    rep = {"launches": launches, "staged_copies": staged_copies(fa),
           "steps": state.step, "losses": record["losses"],
           "step_ms": record["ms"], "aux": record["aux"],
           "dropped": record["dropped"], "coords": record["coords"],
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in state.params),
           "moment_bytes": sum(t.numel() * t.element_size()
                               for t in moments)}
    t0 = time.perf_counter()
    full = global_params(state)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if save is not None and rank == 0:
        torch.save({k: v.cpu() for k, v in full.items()}, save)
    del state, moments, full
    torch.cuda.empty_cache()
    rep.update(run_seconds=run_seconds,
               save_seconds=time.perf_counter() - t0)
    return rep


def mesh_worker(argv) -> int:
    """One torchrun rank of phase 27: `mesh_run` for each run of the JSON
    list ``argv[1]`` ([name, flags, output directory, save path or
    null]), the process group kept between them; writes this rank's
    reports to ``argv[0]``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from distributed_pytorch_training_tpu_torch import train
    from distributed_pytorch_training_tpu_torch.runtime import (
        setup_distributed,
    )

    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        dequant_sum_rows,
        quantize_int8_rows,
    )

    fa = flash_module()
    kernels = {QUANTIZE: quantize_int8_rows, DEQUANT: dequant_sum_rows,
               **{name: getattr(fa, name) for name in FLASH}}
    out_path, runs = Path(argv[0]), json.loads(Path(argv[1]).read_text())
    rank = int(os.environ["RANK"])
    setup_distributed(torch.device("cuda"))
    cleanup = train.cleanup_distributed
    train.cleanup_distributed = lambda: None    # one group for every run
    report = {}
    try:
        for name, flags, run_dir, save in runs:
            report[name] = mesh_run(torch, kernels, fa,
                                    flags + ["--output-dir", run_dir], save)
    finally:
        train.cleanup_distributed = cleanup
    (out_path.parent / f"{out_path.name}{rank}.json").write_text(
        json.dumps(report))
    dist.destroy_process_group()
    return 0


def mesh_first_loss(torch, amp: bool) -> float:
    """Single-rank flash's loss on the first global batch of phase 27's
    seq=2,model=2 runs (one batch coordinate), from the draw those runs
    make (the vocab padded to TP_PAD), no update: (c)'s yardstick."""
    from distributed_pytorch_training_tpu_torch.data.text import (
        TokenLoader,
        get_token_dataset,
    )
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        LanguageModelingTask,
    )
    from distributed_pytorch_training_tpu_torch.utils import parse_args

    dtype = torch.bfloat16 if amp else torch.float32
    model = tp_global_model(torch, dtype).cuda()
    seed = parse_args([]).seed
    ds = get_token_dataset("gpt2", 1024, train=True,
                           synthetic_size=MESH_SYNTHETIC[1], seed=seed)
    batch = next(iter(TokenLoader(ds, MESH_BATCH, shuffle=True, seed=seed,
                                  device=torch.device("cuda", 0)).epoch(0)))
    with torch.no_grad():
        _, m, _ = LanguageModelingTask(compute_dtype=dtype).loss_and_metrics(
            model, batch, True)
    loss = float(m["loss_sum"]) / float(m["weight"])
    del model
    torch.cuda.empty_cache()
    return loss


def mesh_draw(torch, model: str, pad: bool) -> dict:
    """The global draw phase 27's runs of ``model`` start from (the
    vocab padded to TP_PAD when ``pad``), on the CPU."""
    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.utils import parse_args

    kw = {"pad_vocab_to_multiple_of": TP_PAD} if pad else {}
    net = get_model(model, depth=TP_DEPTH, **kw)
    net.reset_parameters(torch.Generator().manual_seed(parse_args([]).seed))
    return {n: p.detach() for n, p in net.named_parameters()}


def mesh_zero_grad_parts(torch, model: str, pad: bool, init: dict) -> dict:
    """{qkv.bias leaf: the indices of its q, k, v parts whose gradient is
    zero up to rounding} of the draw ``init`` of ``model``, and each
    part's gradient norm as a share of its leaf's: one fp32
    loss-and-backward under flash attention on the card, on the first
    row of the one-rank runs' data (the yardstick's draw; which part is
    zero does not depend on the rows)."""
    from distributed_pytorch_training_tpu_torch.data.text import (
        TokenLoader,
        get_token_dataset,
    )
    from distributed_pytorch_training_tpu_torch.models import get_model
    from distributed_pytorch_training_tpu_torch.ops import (
        make_flash_attention_fn,
    )
    from distributed_pytorch_training_tpu_torch.training.tasks import (
        LanguageModelingTask,
        MoeLanguageModelingTask,
    )
    from distributed_pytorch_training_tpu_torch.utils import parse_args

    kw = {"pad_vocab_to_multiple_of": TP_PAD} if pad else {}
    net = get_model(model, depth=TP_DEPTH, **kw,
                    attention_fn=make_flash_attention_fn(causal=True))
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(init[name])
    net.cuda()
    seed = parse_args([]).seed
    ds = get_token_dataset("gpt2", 1024, train=True,
                           synthetic_size=MESH_SYNTHETIC[1], seed=seed)
    batch = next(iter(TokenLoader(ds, 1, shuffle=True, seed=seed,
                                  device=torch.device("cuda", 0)).epoch(0)))
    task = (MoeLanguageModelingTask() if model == MOE
            else LanguageModelingTask())
    loss, _, _ = task.loss_and_metrics(net, batch, True)
    loss.backward()
    out, shares = {}, {}
    for name, p in net.named_parameters():
        if not name.endswith("attn.qkv.bias"):
            continue
        g = p.grad.detach().float()
        share = [float(torch.linalg.vector_norm(g[i])
                       / torch.linalg.vector_norm(g))
                 for i in range(len(QKV_PARTS))]
        shares[name] = share
        out[name] = [i for i, x in enumerate(share) if x <= ZERO_GRAD_REL]
    del net
    torch.cuda.empty_cache()
    return {"parts": out, "grad_shares": shares}


def mesh_update_check(torch, run_path, ref_path, init, left_out) -> dict:
    """Each leaf's distance between two runs' final global parameters as
    a share of the yardstick's movement from the draw, without the
    ``left_out`` parts ({leaf: part indices along dim 0}): {"worst",
    "leaf", "whole"} (an update that did nothing reads 1), and each
    qkv.bias's q, k and v parts' readings ("qkv_parts"; the left-out
    ones under "left_out")."""
    got = torch.load(run_path, weights_only=True)
    ref = torch.load(ref_path, weights_only=True)
    if set(got) != set(ref) or set(ref) != set(init):
        raise RuntimeError(f"phase 27: {run_path.name} and {ref_path.name} "
                           "hold different leaves")

    def norm(t):
        return float(torch.linalg.vector_norm(t))

    off, moved, parts, dropped = {}, {}, {}, {}
    for n in ref:
        d, m = got[n] - ref[n], ref[n] - init[n]
        if n in left_out:
            parts[n] = [norm(d[i]) / norm(m[i])
                        for i in range(len(QKV_PARTS))]
            for i in left_out[n]:
                dropped[f"{n}[{QKV_PARTS[i]}]"] = parts[n][i]
            keep = [i for i in range(d.shape[0]) if i not in left_out[n]]
            d, m = d[keep], m[keep]
        off[n], moved[n] = norm(d), norm(m)
    rel = {n: off[n] / moved[n] for n in ref}
    leaf = max(rel, key=rel.get)
    return {"worst": rel[leaf], "leaf": leaf, "whole": math.sqrt(
        sum(o * o for o in off.values())
        / sum(m * m for m in moved.values())),
        "qkv_parts": parts, "left_out": dropped}


def mesh_train(torch, fa, card: str) -> dict:
    """Phase 27 (see the comment above MESH_BATCH)."""
    import tempfile

    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        dequant_sum_rows,
        quantize_int8_rows,
    )

    out_dir = ROOT / "chiprun_out" / "mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    kernels = {QUANTIZE: quantize_int8_rows, DEQUANT: dequant_sum_rows,
               **{name: getattr(fa, name) for name in FLASH}}
    saved = {n for pair in MESH_PAIRS for n in pair[:2]}
    report, runs = {}, {}
    with tempfile.TemporaryDirectory() as ref_dir:
        def plan(name, flags, coords):
            tag = name.replace(" ", "_").replace("=", "").replace(",", "_")
            return [name, MESH_FLAGS + flags + [
                "--synthetic-size", str(MESH_SYNTHETIC[coords])],
                str(out_dir / tag),
                str(Path(ref_dir) / f"{tag}.pt") if name in saved else None]

        t0 = time.perf_counter()
        report["(c) reference losses"] = {
            amp: mesh_first_loss(torch, amp) for amp in (False, True)}
        for name, flags, coords in MESH_RUNS[1]:
            run = plan(name, flags, coords)
            runs[name] = {"ranks": [mesh_run(
                torch, kernels, fa, run[1] + ["--output-dir", run[2]],
                run[3])], "save": run[3]}
        report["one_rank_seconds"] = time.perf_counter() - t0
        for world in (4, 2):
            t0 = time.perf_counter()
            plans = [plan(*r) for r in MESH_RUNS[world]]
            plan_path = out_dir / f"world{world}_runs.json"
            plan_path.write_text(json.dumps(plans))
            out = run_torchrun([str(out_dir / f"world{world}_rank"),
                                str(plan_path)], timeout=900, nproc=world,
                               mode="--mesh-worker")
            (out_dir / f"world{world}_stdout.txt").write_text(out)
            ranks = [json.loads((out_dir / f"world{world}_rank{r}.json")
                                .read_text()) for r in range(world)]
            for name, _, _, save in plans:
                runs[name] = {"ranks": [rep[name] for rep in ranks],
                              "save": save}
            report[f"torchrun_{world}_seconds"] = time.perf_counter() - t0
        # every run: its launches exact, no staged copy, finite losses
        for name, run in runs.items():
            for r, rep in enumerate(run["ranks"]):
                want = mesh_want(name, rep["coords"]["seq"])
                if rep["launches"] != want or rep["steps"] != MESH_STEPS \
                        or rep["staged_copies"] or not all(
                            math.isfinite(x) for x in rep["losses"]):
                    raise RuntimeError(
                        f"phase 27 {name} rank {r}: {rep['steps']} steps, "
                        f"launches {rep['launches']}, {rep['staged_copies']}"
                        f" staged copies, losses {rep['losses']} (expected "
                        f"{MESH_STEPS}, {want}, 0, finite)")
            rep0 = run["ranks"][0]
            ms = rep0["step_ms"][1:]
            report[name] = {
                "launches_per_rank": [rep["launches"] for rep in run["ranks"]],
                "losses": rep0["losses"], "aux": rep0["aux"],
                "dropped": rep0["dropped"], "step_ms": rep0["step_ms"],
                "run_seconds": rep0["run_seconds"],
                "save_seconds": rep0["save_seconds"],
                "ms_per_step": sum(ms) / len(ms),
                "param_bytes_per_rank": [rep["param_bytes"]
                                         for rep in run["ranks"]],
                "moment_bytes_per_rank": [rep["moment_bytes"]
                                          for rep in run["ranks"]]}
        # (a), (b), (d): a run against its yardstick
        t0 = time.perf_counter()
        draws, zero = {}, {}
        bound = TP_PARAM_REL["fp32"]
        for name, ref_name, pad in MESH_PAIRS:
            run, ref = report[name], report[ref_name]
            moe = name.startswith("moe")
            key = (moe, pad)
            if key not in draws:
                draws.clear()
                draws[key] = mesh_draw(torch, MOE if moe else MODEL, pad)
                zero = mesh_zero_grad_parts(torch, MOE if moe else MODEL,
                                            pad, draws[key])
            diffs = [abs(a - b) for a, b in zip(run["losses"],
                                                ref["losses"])]
            update = mesh_update_check(torch, Path(runs[name]["save"]),
                                       Path(runs[ref_name]["save"]),
                                       draws[key], zero["parts"])
            update["qkv_bias_grad_shares"] = zero["grad_shares"]
            run.update(yardstick=ref_name, loss_abs_diffs=diffs,
                       update=update, param_rel_bound=bound)
            rest = (max(run["param_bytes_per_rank"])
                    / max(ref["param_bytes_per_rank"]),
                    max(run["moment_bytes_per_rank"])
                    / max(ref["moment_bytes_per_rank"]))
            run["at_rest_share"] = rest
            tag = ("(d)" if moe else "(b)" if "zero1" in name else "(a)")
            aux_note = ""
            if moe:
                aux_diffs = [abs(a - b) for x, y in zip(run["aux"],
                                                        ref["aux"])
                             for a, b in zip(x, y)]
                run["aux_abs_diffs"] = aux_diffs
                aux_note = (f"; aux losses {run['aux']!r} against "
                            f"{ref['aux']!r} (|diff| {aux_diffs!r}, "
                            f"tolerance {LOSS_ATOL}); dropped "
                            f"assignments {run['dropped']} against "
                            f"{ref['dropped']}")
                if not (all(d <= LOSS_ATOL for d in aux_diffs)
                        and run["dropped"] == ref["dropped"]):
                    raise RuntimeError(f"phase 27 {tag} {name}: aux "
                                       f"{run['aux']} / dropped "
                                       f"{run['dropped']} against "
                                       f"{ref['aux']} / {ref['dropped']}")
            log(f"phase 27 {tag} {name} [{card}]: launches a rank "
                f"{run['launches_per_rank'][0]}; losses {run['losses']!r} "
                f"against {ref_name}'s {ref['losses']!r} (|diff| {diffs!r},"
                f" tolerance {LOSS_ATOL}); final parameters off it by "
                f"{update['worst']!r} of its movement at worst "
                f"({update['leaf']}), {update['whole']!r} over the model "
                f"(bounds {bound}), leaving out the qkv.bias parts whose "
                f"gradient at the draw is at most {ZERO_GRAD_REL} of their "
                f"leaf's, which read {update['left_out']!r}; at rest a "
                f"rank: params "
                f"{run['param_bytes_per_rank']} B against "
                f"{ref['param_bytes_per_rank']} B, AdamW moments "
                f"{run['moment_bytes_per_rank']} B against "
                f"{ref['moment_bytes_per_rank']} B{aux_note}; "
                f"{run['ms_per_step']:.1f} ms a step after the first "
                f"({MESH_NOTE})")
            worst, whole = bound
            if not (all(d <= LOSS_ATOL for d in diffs)
                    and update["worst"] <= worst
                    and update["whole"] <= whole):
                raise RuntimeError(f"phase 27 {tag} {name}: losses |diff| "
                                   f"{diffs}, parameters {update}")
            fsdp = "fsdp" in name
            if fsdp and not (rest[0] <= MESH_REST_SHARE
                             and rest[1] <= MESH_REST_SHARE):
                raise RuntimeError(f"phase 27 {tag} {name}: at rest "
                                   f"{rest} of {ref_name}'s")
            if "zero1" in name and not (rest[0] == 1.0
                                        and rest[1] <= MESH_REST_SHARE):
                raise RuntimeError(f"phase 27 {tag} {name}: at rest "
                                   f"{rest} of {ref_name}'s")
        draws.clear()
        report["checks_seconds"] = time.perf_counter() - t0
    # (c): step 1's loss against single-rank flash
    for name, _, _ in MESH_RUNS[4]:
        if not name.startswith("seq"):
            continue
        amp = name.endswith("amp")
        want = report["(c) reference losses"][amp]
        got = report[name]["losses"][0]
        tol = BF16_LOSS_ATOL if amp else LOSS_ATOL
        report[name].update(step1_reference=want, step1_abs_diff=abs(
            got - want), tolerance=tol)
        log(f"phase 27 (c) {name} [{card}]: K3-K5 launches a rank "
            f"{report[name]['launches_per_rank']}; step 1 loss {got!r} "
            f"against single-rank flash {want!r} (|diff| {abs(got - want)!r},"
            f" tolerance {tol}); {report[name]['ms_per_step']:.1f} ms a "
            f"step after the first ({MESH_NOTE})")
        if not abs(got - want) <= tol:
            raise RuntimeError(f"phase 27 (c) {name}: step 1 loss {got} "
                               f"against {want}")
    report["ranks"] = {name: run["ranks"] for name, run in runs.items()}
    return report


def mesh_kernel_fields(name: str, flash_rows, mesh: dict) -> dict:
    """Phase 27's share of flash kernel ``name``, every rank of every
    run: ``mesh_*`` over the float32 runs, ``mesh_bf16_*`` over
    ``--amp``, each launch at the FLASH_CASES shape it ran
    (`mesh_case_launches`), with SDPA's time."""
    shape = {r["shape"]: r for r in flash_rows}
    out = {}
    for prefix in ("mesh_", "mesh_bf16_"):
        for key in ("launches", "ms", "plain_ms", "bound_ms", "library_ms"):
            out[prefix + key] = 0
    for run, ranks in mesh["ranks"].items():
        prefix = "mesh_bf16_" if run.endswith("amp") else "mesh_"
        for rep in ranks:
            for case, counts in mesh_case_launches(
                    run, rep["coords"]["seq"]).items():
                n, row = counts[name], shape[case]
                out[prefix + "launches"] += n
                for key in ("ms", "plain_ms", "bound_ms"):
                    out[prefix + key] += row[key][name] * n
                out[prefix + "library_ms"] += n * (
                    row["sdpa_fwd_ms"] if name.endswith("fwd_lse")
                    else row["sdpa_bwd_ms"])
    return out


def lm_mfu(torch, rates: list, context: str):
    """The step line's samples/s as MFU for a 1024-token GPT-2 124M
    sequence (`model_mfu`). Returns (MFU % per rate, the forward FLOPs,
    the peak TFLOP/s)."""
    from distributed_pytorch_training_tpu_torch.experiments import flops

    mfus, fwd = model_mfu(torch, MODEL, torch.zeros(
        (1, 1024), dtype=torch.long, device="meta"), rates, context)
    return mfus, fwd, flops.chip_peak_tflops(0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on a GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / PACKAGE / "__init__.py").is_file():
        print(f"chip_smoke: {PACKAGE}/ not found beside {Path(__file__).name}"
              "; run it from the repository's root", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import distributed_pytorch_training_tpu_torch as port

    if Path(port.__file__).resolve().parent != ROOT / PACKAGE:
        raise RuntimeError(f"imported {port.__file__}, not this checkout's "
                           "package")
    from distributed_pytorch_training_tpu_torch.experiments.harness import (
        build_serving_engine,
    )
    from distributed_pytorch_training_tpu_torch.ops import build
    from distributed_pytorch_training_tpu_torch.ops.quantize import (
        quantize_int8_rows,
    )
    from distributed_pytorch_training_tpu_torch.serving import QuantizedLeaf
    from distributed_pytorch_training_tpu_torch.serving.__main__ import run

    t_start = time.perf_counter()
    # phase 1: the card
    card = nvidia_smi()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    if H100_SXM not in card:
        raise RuntimeError(f"the bounds use the H100 SXM's data sheet; this "
                           f"card is {card!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = CUDNN_DETERMINISTIC
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind} x "
        f"{count}")

    # phase 2: build every kernel, one nvcc per source, all at once
    fa = flash_module()
    t0 = time.perf_counter()
    libs = build.build_all([QUANTIZE, DEQUANT, *fa.LIBRARIES])
    log(f"built {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    flash_res = [r for name in fa.LIBRARIES
                 if libs[name].with_suffix(".log").exists()
                 for r in ptxas_resources(libs[name].with_suffix(".log"))]
    spilled = [r for r in flash_res
               if r["kernel"].endswith("_sm90_kernel") and r["DP"] == 64
               and r["spill_bytes"]]
    if spilled:
        raise RuntimeError(f"the wgmma kernels spill at D 64: {spilled}")

    # phase 3: the quantizer against its plain version
    t0 = time.perf_counter()
    counts, rows = check_quantizer(torch, dev)
    log(f"phase 3 done in {time.perf_counter() - t0:.1f} s")

    # phase 4: the main path, int8, through the serving CLI's smoke
    t0 = time.perf_counter()
    quantize_int8_rows.launches = 0
    report = run(["smoke", "--model", MODEL, "--serve-dtype", "int8",
                  *SERVING_OUT])
    launches = quantize_int8_rows.launches
    torch.cuda.synchronize()
    served = report.engine._served
    leaves = {name: leaf for name, leaf in served.items()
              if isinstance(leaf, QuantizedLeaf)}
    want = sum(counts.values())
    if launches != want or len(leaves) != want or want != 50:
        raise RuntimeError(f"int8 serving launched quantize_int8_rows "
                           f"{launches} times for {len(leaves)} int8 leaves "
                           f"(expected 50)")
    if len(report.results) != 3:
        raise RuntimeError(f"{len(report.results)} results for 3 prompts")
    for res in report.results:
        toks = res.tokens
        if toks.shape != (MAX_NEW_TOKENS,) or toks.min() < 0 \
                or toks.max() >= VOCAB:
            raise RuntimeError(f"bad tokens {toks.tolist()}")
        logits = torch.from_numpy(res.last_logits)
        if logits.shape != (VOCAB,) or not torch.isfinite(logits).all():
            raise RuntimeError("int8 last_logits are not finite (vocab,)")
    cpu_int8 = build_serving_engine(MODEL, max_new_tokens=MAX_NEW_TOKENS,
                                    serve_dtype="int8", device="cpu")
    for name, leaf in leaves.items():
        ref = cpu_int8._served[name]
        if not (torch.equal(leaf.q.cpu(), ref.q) and torch.equal(
                leaf.scale.cpu().view(torch.int32),
                ref.scale.view(torch.int32))):
            raise RuntimeError(f"int8 leaf {name}: the card's codes or "
                               "scales differ from the CPU's plain version")
    int8_err = logits_vs_cpu(report, cpu_int8)
    log(f"phase 4 done in {time.perf_counter() - t0:.1f} s: 3 prompts x "
        f"{MAX_NEW_TOKENS} tokens, quantize_int8_rows launches={launches}; "
        f"{len(leaves)} served leaves bitwise equal to the CPU's; int8 "
        f"prefill last_logits card vs CPU max |diff| {int8_err!r} "
        f"(tolerance {ATOL})")
    if not int8_err <= ATOL:
        raise RuntimeError(f"int8 logits differ from the CPU by {int8_err}")

    # phase 5: fp32 on the card against the same weights on the CPU
    t0 = time.perf_counter()
    gpu = run(["smoke", "--model", MODEL, "--serve-dtype", "fp32",
               *SERVING_OUT])
    fp32_err = logits_vs_cpu(gpu, build_serving_engine(
        MODEL, max_new_tokens=MAX_NEW_TOKENS, device="cpu"))
    log(f"phase 5 done in {time.perf_counter() - t0:.1f} s: fp32 prefill "
        f"last_logits card vs CPU max |diff| {fp32_err!r} (tolerance "
        f"{ATOL})")
    if not fp32_err <= ATOL:
        raise RuntimeError(f"fp32 logits differ from the CPU by {fp32_err}")

    # phase 6: the flash kernels against their plain versions
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flash_rows = check_flash(torch, dev, flush)
    del flush
    log(f"phase 6 done in {time.perf_counter() - t0:.1f} s")

    # phase 7: the training path through the port's own entry
    t0 = time.perf_counter()
    flash_launches, losses, lm_rates, _ = train_on_card(torch, fa)
    lm_mfus, lm_fwd_flops, peak_tflops = lm_mfu(torch, lm_rates, "phase 7")
    log(f"phase 7 done in {time.perf_counter() - t0:.1f} s: launches "
        f"{flash_launches}; (train, val) loss per epoch {losses}; "
        f"step-line samples/s {lm_rates}; MFU % {lm_mfus} (3 x "
        f"{lm_fwd_flops:.6g} FLOPs a sequence against {peak_tflops} "
        "TFLOP/s bf16 dense)")

    # phase 8: one loss-and-backward, card (kernels) against CPU (plain)
    t0 = time.perf_counter()
    before = fa.flash_attention_bwd_dq.launches
    loss_err, grad_err, grad_leaf, loss_card, loss_cpu = grads_card_vs_cpu(
        torch, dev)
    if fa.flash_attention_bwd_dq.launches != before + DEPTH:
        raise RuntimeError("the card's backward did not run the kernels")
    log(f"phase 8 done in {time.perf_counter() - t0:.1f} s: {CPU_BATCH}x"
        f"{CPU_SEQ} loss card {loss_card!r} cpu {loss_cpu!r} (|diff| "
        f"{loss_err!r}, tolerance {LOSS_ATOL}); worst gradient "
        f"max|diff|/max|g| {grad_err!r} in {grad_leaf} (tolerance "
        f"{GRAD_REL})")
    if not (loss_err <= LOSS_ATOL and grad_err <= GRAD_REL):
        raise RuntimeError(f"card vs CPU: loss |diff| {loss_err}, gradient "
                           f"{grad_err} in {grad_leaf}")

    # phase 9: K1 and K2 at the int8 wires' shapes, and K2's edges
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    codec, quantize_edges, dequant_edges = check_wire_codec(torch, dev,
                                                            flush)
    del flush
    torch.cuda.empty_cache()
    log(f"phase 9 done in {time.perf_counter() - t0:.1f} s")

    # phase 10: the reducer on 2 ranks, card (kernels) against CPU (plain)
    t0 = time.perf_counter()
    reducer = reducer_card_vs_cpu(torch)
    log(f"phase 10 done in {time.perf_counter() - t0:.1f} s: reduce_flat on "
        f"{DP_RANKS} gloo ranks at {RESNET18_PARAMS:,} floats, card sums "
        "and residuals bitwise equal to the CPU's for "
        + "; ".join(f"{name} ({reducer[name]['card_ms_per_call']:.1f} ms a "
                    "call on the card)" for name, _, _ in DP_RUNS)
        + f"; collectives alone, ms: {reducer['collectives_ms']}; an int8 "
        f"one-bucket call step by step, ms: {reducer['int8_call_steps_ms']}")

    # phase 11: ResNet-18 on one rank through the port's entry
    t0 = time.perf_counter()
    one_rank = resnet_one_rank(torch)
    log(f"phase 11 done in {time.perf_counter() - t0:.1f} s: "
        f"{one_rank['steps']} steps; (train, val, epoch s) per epoch "
        f"{one_rank['losses']}; epoch 2 "
        f"{one_rank['samples_per_s_epoch2']:.1f} samples/s; the loader "
        f"alone {one_rank['loader_ms_per_batch']:.2f} ms a batch")
    torch.cuda.empty_cache()

    # phase 12: ResNet-18 on 2 ranks through torchrun, the main path of
    # K1 and K2 (the counts are set to 0 and read inside each rank)
    t0 = time.perf_counter()
    two_ranks = resnet_two_ranks(torch)
    log(f"phase 12 done in {time.perf_counter() - t0:.1f} s")

    # phase 13 (A): the reference's own command on 2 ranks, fp32 and amp
    t0 = time.perf_counter()
    reference = resnet_reference_command(torch)
    log(f"phase 13 done in {time.perf_counter() - t0:.1f} s")

    # phase 14 (B): GPT-2 with --amp, the main path of K3-K5 in bf16
    t0 = time.perf_counter()
    bf16_launches, bf16_losses, bf16_rates, bf16_digests = train_on_card(
        torch, fa, amp=True)
    want = {FLASH[0]: DEPTH * (TRAIN_STEPS + EVAL_STEPS) * EPOCHS,
            FLASH[1]: DEPTH * TRAIN_STEPS * EPOCHS,
            FLASH[2]: DEPTH * TRAIN_STEPS * EPOCHS}
    if bf16_launches != want:
        raise RuntimeError(f"--amp training launched {bf16_launches}, "
                           f"expected {want}")
    bf16_mfus, _, _ = lm_mfu(torch, bf16_rates, "phase 14")
    log(f"phase 14 --amp training: launches {bf16_launches}; (train, val) "
        f"loss per epoch {bf16_losses}; step-line samples/s {bf16_rates}; "
        f"MFU % {bf16_mfus}")
    torch.cuda.empty_cache()
    before = fa.flash_attention_bwd_dq.launches
    b_loss_err, b_grad_err, b_grad_leaf, b_loss_card, b_loss_cpu = \
        grads_card_vs_cpu(torch, dev, torch.bfloat16)
    if fa.flash_attention_bwd_dq.launches != before + DEPTH:
        raise RuntimeError("the card's bf16 backward did not run the "
                           "kernels")
    log(f"phase 14 done in {time.perf_counter() - t0:.1f} s: bf16 "
        f"{CPU_BATCH}x{CPU_SEQ} loss card {b_loss_card!r} cpu "
        f"{b_loss_cpu!r} (|diff| {b_loss_err!r}, tolerance "
        f"{BF16_LOSS_ATOL}); worst gradient max|diff|/max|g| "
        f"{b_grad_err!r} in {b_grad_leaf} (tolerance {BF16_GRAD_REL})")
    if not (b_loss_err <= BF16_LOSS_ATOL and b_grad_err <= BF16_GRAD_REL):
        raise RuntimeError(f"bf16 card vs CPU: loss |diff| {b_loss_err}, "
                           f"gradient {b_grad_err} in {b_grad_leaf}")
    torch.cuda.empty_cache()

    # phase 15 (C): GPT-2 on 2 ranks sharing the card
    t0 = time.perf_counter()
    lm_two_ranks = gpt2_two_ranks(torch)
    log(f"phase 15 done in {time.perf_counter() - t0:.1f} s: launches per "
        f"rank {lm_two_ranks['launches_per_rank']}; parameters bitwise "
        f"equal across ranks; (train, val) loss {lm_two_ranks['losses']}; "
        f"step-line samples/s {lm_two_ranks['step_line_samples_per_s']}")

    # phase 16 (D): bf16 serving on the card against the CPU
    t0 = time.perf_counter()
    gpu16 = run(["smoke", "--model", MODEL, "--serve-dtype", "bf16",
                 *SERVING_OUT])
    if gpu16.engine.model.dtype != torch.bfloat16:
        raise RuntimeError("bf16 serving did not build a bf16 model")
    bf16_err = logits_vs_cpu(gpu16, build_serving_engine(
        MODEL, max_new_tokens=MAX_NEW_TOKENS, serve_dtype="bf16",
        device="cpu"))
    log(f"phase 16 done in {time.perf_counter() - t0:.1f} s: bf16 prefill "
        f"last_logits card vs CPU max |diff| {bf16_err!r} (tolerance "
        f"{BF16_ATOL})")
    if not bf16_err <= BF16_ATOL:
        raise RuntimeError(f"bf16 logits differ from the CPU by {bf16_err}")

    # phase 18: checkpoints, preemption, restarts and serving from a
    # checkpoint; the checkpoints (GPT-2's 1.5 GB each) are removed after
    t0 = time.perf_counter()
    try:
        state_c, ckpt_dir, preempt = gpt2_preempt_resume(
            torch, fa, bf16_launches, bf16_digests)
        log(f"phase 18 (a): run B stopped at epoch 0 step {PREEMPT_AT + 1} "
            f"and checkpointed ({preempt['B']}); run C resumed to "
            f"{preempt['C']['steps']} steps ({preempt['C']}); B + C launched "
            f"{preempt['launches']}; {preempt['bitwise_tensors']} parameter "
            "and AdamW tensors bitwise phase 14's")
        chaos = resnet_chaos_two_ranks(torch)
        log(f"phase 18 (b): {chaos}; each rank's parameters, BatchNorm "
            "statistics and residual bitwise phase 12's")
        served = serve_checkpoint(torch, dev, state_c, ckpt_dir)
        del state_c
        log(f"phase 18 (c): served checkpoint {served['label']} "
            f"({served['tree_digest']}); prefill logits of "
            f"{served['prompts']} prompts bitwise run C's in memory")
    finally:
        import shutil

        for d in ("ckpt_gpt2/ckpt", "dp_int8_chaos/ckpt"):
            shutil.rmtree(ROOT / "chiprun_out" / d, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 18 done in {time.perf_counter() - t0:.1f} s")

    # phase 19: the sharded update (ZeRO-1, explicit FSDP) and the
    # two-tier int8_hier wire, through the port's entry on ranks sharing
    # the card; then the hier codecs card vs CPU; then K1 and K2 timed at
    # the new shapes
    t0 = time.perf_counter()
    sharded = sharded_two_ranks(torch)
    torch.cuda.empty_cache()
    hier = hier_four_ranks(torch)
    hier_codec = hier_codec_card_vs_cpu(torch)
    log(f"phase 19 (c) hier codecs on {HIER_RANKS} ranks: card bitwise the "
        f"CPU's, replicated outputs equal across ranks; card ms a call "
        + ", ".join(f"{k} {v['card_ms_per_call']:.1f}"
                    for k, v in hier_codec["rank0"].items()
                    if isinstance(v, dict))
        + f"; spawn to ready {hier_codec['spawn_to_ready_s']} s")
    counts19 = {
        **{name: sharded_launches(torch, "zero1", wire, DP_RANKS)
           for name, wire in ZERO1_RUNS},
        **{name: sharded_launches(torch, "fsdp", wire, DP_RANKS)
           for name, wire in FSDP_RUNS},
        "hier reducer": sharded_launches(torch, "reducer", "int8_hier",
                                         HIER_RANKS, HIER_SLICES),
        "hier zero1": sharded_launches(torch, "zero1", "int8_hier",
                                       HIER_RANKS, HIER_SLICES)}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    codec19 = time_sharded_codec(torch, dev, flush, {
        key for c in counts19.values() for key in c})
    del flush
    torch.cuda.empty_cache()
    bucketed = {name: codec_per_step(wire_launches(torch, wire, cap), codec)
                for name, wire, cap in DP_RUNS}
    per_step19 = {name: codec_per_step(c, codec19)
                  for name, c in counts19.items() if c}
    for name, ps in per_step19.items():
        log(f"phase 19 (d) {name}: a step launches K1 "
            f"{ps[QUANTIZE]['launches']}x, {ps[QUANTIZE]['ms']:.4f} ms "
            f"(bound {ps[QUANTIZE]['bound_ms']:.4f}, plain "
            f"{ps[QUANTIZE]['plain_ms']:.4f}), K2 {ps[DEQUANT]['launches']}x,"
            f" {ps[DEQUANT]['ms']:.4f} ms (bound "
            f"{ps[DEQUANT]['bound_ms']:.4f}, plain "
            f"{ps[DEQUANT]['plain_ms']:.4f})")
    for name, ps in bucketed.items():
        log(f"phase 19 (d) beside phase 9's {name} (bucketed reducer): a "
            f"step K1 {ps[QUANTIZE]['launches']}x {ps[QUANTIZE]['ms']:.4f}"
            f" ms (bound {ps[QUANTIZE]['bound_ms']:.4f}), K2 "
            f"{ps[DEQUANT]['launches']}x {ps[DEQUANT]['ms']:.4f} ms (bound "
            f"{ps[DEQUANT]['bound_ms']:.4f})")
    log(f"phase 19 done in {time.perf_counter() - t0:.1f} s")

    # phase 20: step profiling on the card through the port's entry
    # points: the GPT-2 --amp window, the reference's command on 2 ranks,
    # and the live endpoint's /metrics and POST /profile
    t0 = time.perf_counter()
    profiled = profile_gpt2(torch, fa, card, flash_rows)
    torch.cuda.empty_cache()
    profiled_reference = profile_reference(torch, card, reducer)
    live = live_endpoint(torch, card)
    torch.cuda.empty_cache()
    log(f"phase 20 done in {time.perf_counter() - t0:.1f} s")

    # phase 21: continuous serving through the port's entry points at
    # GPT-2 124M, K1 on every int8 page write
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    continuous = serving_continuous(torch, dev, flush)
    del flush
    torch.cuda.empty_cache()
    log(f"phase 21 done in {time.perf_counter() - t0:.1f} s")

    # phase 22: BERT-base masked LM (K3-K5 bidirectional at S 512, and
    # K1 and K2 on its int8 wire) and ViT-B/16 through the port's entry
    t0 = time.perf_counter()
    models22 = bert_and_vit(torch, dev, fa, card)
    log(f"phase 22 done in {time.perf_counter() - t0:.1f} s")

    # phase 23: sequence parallelism, the ring (K6: K3-K5 around the ring)
    # and Ulysses, on 2 ranks sharing the card, then GPT-2 124M through
    # the port's entry with --mesh data=1,seq=2
    t0 = time.perf_counter()
    seq_parallel = {"(a)": seq_attention_on_card(torch, card)}
    torch.cuda.empty_cache()
    seq_parallel["(b)"] = sp_train(torch, fa, card)
    torch.cuda.empty_cache()
    log(f"phase 23 done in {time.perf_counter() - t0:.1f} s")

    # phase 24: tensor parallelism over the mesh's model axis, GPT-2 124M
    # on ranks sharing the card (K3-K5 on each rank's 6 heads; K1 and K2
    # on the TP x FSDP int8 wire), then K1 and K2 at its layer groups'
    # shapes, bitwise and timed
    t0 = time.perf_counter()
    tensor_parallel = tp_train(torch, card)
    torch.cuda.empty_cache()
    tp_counts = tp_int8_launches(torch, TP_RANKS)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    tp_codec = time_sharded_codec(torch, dev, flush, set(tp_counts))
    del flush
    torch.cuda.empty_cache()
    ps = codec_per_step(tp_counts, tp_codec)
    log(f"phase 24 (c) TP x FSDP int8 wire, a step a rank: K1 "
        f"{ps[QUANTIZE]['launches']}x {ps[QUANTIZE]['ms']:.4f} ms (bound "
        f"{ps[QUANTIZE]['bound_ms']:.4f}, plain "
        f"{ps[QUANTIZE]['plain_ms']:.4f}), K2 {ps[DEQUANT]['launches']}x "
        f"{ps[DEQUANT]['ms']:.4f} ms (bound {ps[DEQUANT]['bound_ms']:.4f}, "
        f"plain {ps[DEQUANT]['plain_ms']:.4f}), bitwise their plain "
        "versions at every shape")
    tensor_parallel["codec_per_step"] = ps
    log(f"phase 24 done in {time.perf_counter() - t0:.1f} s")

    # phase 25: GPipe over the mesh's pipe axis (GPT-2 124M, no kernel in
    # the stages) and gpt2_moe on one rank and over the expert axis (K3-K5
    # in all PP_DEPTH blocks), on ranks sharing the card
    t0 = time.perf_counter()
    pipe_expert = pp_train(torch, fa, card)
    torch.cuda.empty_cache()
    log(f"phase 25 done in {time.perf_counter() - t0:.1f} s")

    # phase 26: serving the models that are not causal LMs (the image and
    # token batches, fp32 and int8), then BERT-base and ViT-B/16 on the
    # model axis on ranks sharing the card
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    served26 = serve_models(torch, dev, flush, card)
    del flush
    torch.cuda.empty_cache()
    log(f"phase 26 (a) done in {time.perf_counter() - t0:.1f} s")
    bert_tp = bert_tp_train(torch, card)
    torch.cuda.empty_cache()
    log(f"phase 26 done in {time.perf_counter() - t0:.1f} s")

    # phase 27: the rest of the training mesh (the fsdp axis, ZeRO-1 x TP,
    # SP x TP, gpt2_moe on model and on seq) on ranks sharing the card
    t0 = time.perf_counter()
    mesh27 = mesh_train(torch, fa, card)
    torch.cuda.empty_cache()
    log(f"phase 27 done in {time.perf_counter() - t0:.1f} s")

    # phase 17: the kernels line; K1 and K2 summed over their launches on
    # the data-parallel paths (rank 0 of every phase 12, phase 19 and
    # phase 22 (e) run), the serving path's K1 launches (phase 4) kept in
    # chip_smoke.json
    bert_counts = {key: n * BERT_DP_STEPS for key, n in wire_launches(
        torch, "int8", 0.0, params=BERT_PARAMS).items()}
    codec_kernels = codec_kernel_rows(
        torch, codec, codec19, counts19,
        {name: two_ranks[name]["steps"] for name, _, _ in DP_RUNS},
        {name: (hier if name.startswith("hier") else sharded)[name]["steps"]
         for name in counts19},
        rows + quantize_edges, dequant_edges, continuous["(b) k1"],
        bert_counts)
    serving_k1 = {
        "launches": launches,
        "ms": sum(r["ms"] * r["main_path_launches"] for r in rows),
        "plain_ms": sum(r["plain_ms"] * r["main_path_launches"]
                        for r in rows),
        "bound_ms": sum(r["bound_ms"] * r["main_path_launches"]
                        for r in rows),
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "serving_quantize": serving_k1,
        "per_shape": rows,
        "fp32_card_vs_cpu_max_abs": fp32_err,
        "int8_card_vs_cpu_max_abs": int8_err,
        "tokens_int8": [r.tokens.tolist() for r in report.results],
        "flash_per_shape": flash_rows, "flash_launches": flash_launches,
        "flash_resources": flash_res,
        "train_val_loss_per_epoch": losses,
        "train_step_line_samples_per_s": lm_rates,
        "amp_flash_launches": bf16_launches,
        "amp_train_val_loss_per_epoch": bf16_losses,
        "amp_train_step_line_samples_per_s": bf16_rates,
        "amp_card_vs_cpu": {"loss_card": b_loss_card,
                            "loss_cpu": b_loss_cpu,
                            "loss_abs_diff": b_loss_err,
                            "grad_rel": b_grad_err,
                            "grad_rel_leaf": b_grad_leaf},
        "resnet_reference_command": reference,
        "gpt2_two_ranks": lm_two_ranks,
        "bf16_card_vs_cpu_max_abs": bf16_err,
        "checkpoints": {"gpt2_preempt_resume": preempt,
                        "resnet_two_ranks_chaos": chaos,
                        "served_checkpoint": served},
        "card_vs_cpu": {"loss_card": loss_card, "loss_cpu": loss_cpu,
                        "loss_abs_diff": loss_err, "grad_rel": grad_err,
                        "grad_rel_leaf": grad_leaf},
        "wire_codec_per_shape": list(codec.values()),
        "quantize_edges": quantize_edges, "dequant_edges": dequant_edges,
        "reducer_card_vs_cpu": reducer,
        "resnet_one_rank": one_rank, "resnet_two_ranks": two_ranks,
        "train_mfu_pct": lm_mfus, "amp_train_mfu_pct": bf16_mfus,
        "gpt2_fwd_flops_per_seq": lm_fwd_flops,
        "peak_tflops_bf16": peak_tflops,
        "sharded_update": sharded, "hier": hier, "hier_codec": hier_codec,
        "sharded_codec_per_shape": list(codec19.values()),
        "sharded_codec_per_step": per_step19,
        "bucketed_codec_per_step": bucketed,
        "profile_gpt2_amp": profiled,
        "profile_reference_command": profiled_reference,
        "live_endpoint": live,
        "serving_continuous": continuous,
        "bert_vit": models22,
        "seq_parallel": seq_parallel,
        "tensor_parallel": tensor_parallel,
        "tp_codec_per_shape": list(tp_codec.values()),
        "pipe_expert": pipe_expert,
        "serve_non_lm": served26, "bert_vit_tp": bert_tp,
        "mesh": mesh27,
        "seconds": time.perf_counter() - t_start,
    }, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [*codec_kernels,
               *flash_kernel_rows(flash_rows, flash_launches,
                                  bf16_launches, profiled["bf16_trace_ms"],
                                  models22["(a) fp32"]["launches"],
                                  models22["(a) amp"]["launches"],
                                  seq_parallel["(b)"])]
    for row in kernels:
        if row["name"] in (QUANTIZE, DEQUANT):
            row.update(tp_kernel_fields(row["name"], None, tensor_parallel,
                                        tp_codec, tp_counts))
        else:
            row.update(tp_kernel_fields(row["name"], flash_rows,
                                        tensor_parallel))
            row.update(moe_kernel_fields(row["name"], flash_rows,
                                         pipe_expert))
            row.update(mesh_kernel_fields(row["name"], flash_rows, mesh27))
        row.update(serve_tp_kernel_fields(row["name"], flash_rows, served26,
                                          bert_tp))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--sp-worker"]:
        sys.exit(sp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.exit(tp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--pp-worker"]:
        sys.exit(pp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2:]))
    sys.exit(main())
