#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits nonzero):

0. build every CUDA kernel in ``src/repro_torch/csrc`` with ``nvcc``;
1. hold the flash-decode kernels against their plain PyTorch version
   (``paged_attention_reference``) at qwen2-7b's attention shapes — ragged
   lengths, decode and chunked-prefill rows, fp32/bf16/int8 pages, a
   sliding window — check that one call issues the split and merge
   kernels and no other device operation, and time the whole call
   (``ms``), its kernels alone (``device_ms``, torch.profiler), the plain
   version, SDPA over the gathered K/V, and the HBM bound, there, at
   granite-3-2b's attention (H 32, K 8, D 64) and at qwen2-vl-2b's (H 12,
   K 2, D 128: group 6);
2. serve qwen2-7b at full width and depth in bf16 (random weights from a
   seed) through ``ServeEngine`` with the kernel, check that every request
   completes and that every attention layer of every step launched the
   kernel, and compare one mixed decode/prefill step's logits between the
   kernel and the plain gather path; then serve phase 2's requests three
   times over (24 requests: ``serve_slos``' TTFT windows page only after
   16 TTFTs) under an SLO monitor whose TTFT target every request on the
   card misses: admissions must be deferred (``serve/admission_deferred``)
   and never made with half the slots or more live once the SLO burns,
   every request must finish its 16 tokens and flash-decode must run in
   every layer of every step; with a target no TTFT reaches the engine
   must schedule exactly as without an SLO (the same steps and tokens);
3. hold the three FA-2 kernels (forward, dq, dk/dv) against their plain
   PyTorch versions in fp32 and bf16 on the JAX package's FA_CASES shapes,
   MLA's head widths (qk 96 / v 64 and 192 / 128), a width the wrappers
   zero-pad, opt-1.3b's attention shape and mixtral-8x7b's training
   attention (GQA 32/8, D 128, a window that cuts in) at 2048 tokens, and
   time kernel, plain version, SDPA (forward, and its backward for the
   dq + dk/dv pair) and the bound at opt-1.3b's shape (4 x 2048, an
   edge replica's 2 x 2048 of phase 19, a mesh rank's 2 x 2048 and 16
   heads of phase 22 and its 1 x 2048 of phase 24), at mixtral's
   1 x 8192 tokens with the 4096 window and at deepseek-v3-671b's
   training attention (1 x 2048 tokens, 128 heads at (192, 128)), the
   last two also held to their plain versions in bf16, and at three
   shapes held in fp32 and bf16 first: whisper-medium's encoder (8 x
   1500 frames, 16 heads x 64, non-causal), its cross-attention (8 x 448
   queries over 1500 keys, non-causal) and qwen2-vl-2b's training
   attention (2 x 4096 tokens, GQA 12/2 at D 128, causal); the bf16
   forward, dq and dk/dv must
   execute more than the fp32 CUDA cores' 67 TFLOP/s (they run on the
   tensor cores);
4. train opt-1.3b at full width and depth in bf16 (4 x 2048 tokens, random
   weights from a seed) through ``repro_torch.train.trainer.train`` with
   the kernels for 8 steps, check the losses, that every attention
   layer of every step launched each FA-2 kernel once and every leaf of
   every step each AdamW kernel once, compare one step's loss
   and gradient norm between the kernels and the plain chunked path (bf16
   and fp32 compute), and profile one step;
5. hold the int8 quantize/dequantize kernels against their plain
   versions (codes, scales and values equal) on the JAX package's quant8
   cases, ragged tails, an all-zero block, bf16 input and opt-1.3b's
   largest leaf, and time kernel, plain version, ``torch.mul`` and the
   bound there and at a 2 x 2 mesh rank's block of that leaf (a
   quarter), with dequantize's GB/s beside a ``fill_`` of the same
   output (the card's write rate, a yardstick); then time dequantize over
   all 17 opt-1.3b leaves, what one replica spends on it a round;
6. train opt-1.3b at full width through
   ``repro_torch.train.local_sgd.train_local_sgd``: 2 replicas x 2 inner
   steps of 2 x 2048 tokens, 2 rounds, int8-compressed pseudo-gradients
   with error feedback, sync priced over examples/diloco_edge.py's
   two-region topology; check the losses, the launches of every kernel
   and the wire bytes, and the compressed round-1 pseudo-gradient against
   the plain version (phase 24 (b)'s reference);
7. at opt-1.3b width and 2 layers, check that async with quorum =
   replicas and staleness 0 equals sync, and that a run checkpointed
   every round restores and resumes from exactly what it saved;
8. hold the SSD-scan kernels against their plain version in fp32 and
   bf16 on the JAX package's SSD_CASES, a ragged case, mamba2-130m's
   shape at 8 x 4096 and 8 x 4000 tokens and jamba's mixers (128 heads,
   p 64, state 16) at 4 x 2048, check that a call issues its three
   kernels and no other device operation, and time the whole call
   (``ms``), its three kernels alone (``device_ms``), the plain version
   and the bound at mamba2-130m's 8 x 4096 and at jamba's 4 x 2048;
9. serve mamba2-130m at full width and depth in bf16 (random weights from
   a seed): (a) ``serve.step.make_prefill`` over 8 x 4096 tokens through
   the kernels — finite logits, 24 calls a forward, tokens/s, peak
   memory, the scan kernels' share of device time, and the logits against the
   ``ssd_reference`` path in bf16 and fp32; (b) ``greedy_generate`` of 8
   prompts of 64 tokens + 32 new ones through the dense cache; (c) with
   fp32 weights, ``decode_step`` token by token against the kernel
   prefill's logits at every position of 2 x 300 tokens;
10. serve mixtral-8x7b at full width and 4 of its 32 layers in bf16
   (random weights from a seed; full depth is 93.4 GB of bf16, past the
   card's 80 GB): phase 2's engine and requests, with every request
   completing, flash-decode launched by each of the 4 layers every step
   and prefix hits; a profiled run's device time by kind (MoE dispatch,
   expert FFNs, flash-decode, other); phase 2's mixed step, kernel vs
   gather, gated in fp32 compute only (in bf16 a one-ulp difference can
   flip a token's top-2 experts in a later layer); a 1 x 8192-token
   ``forward_logits`` through the FA-2 forward (4 launches a forward,
   the 4096-token window cutting in), and layer 0's attention there
   against ``attention_fwd_plain`` at phase 3's bf16 bar;
11. train mixtral-8x7b at full width and 2 of its 32 layers in bf16
   (random weights from a seed; bf16 weights and gradients and fp32 AdamW
   moments of 3 layers would pass 80 GB with the activations) through
   ``repro_torch.train.trainer.train``: 4 steps of 1 x 8192 tokens, the
   first left out of the timing, through the FA-2 kernels with GQA 32/8,
   D 128 and the 4096 window cutting in (each kernel launched once a
   layer a step); ms a step, tokens/s, ``train_flops`` (top-2 of the
   experts) / step time against 989 TFLOP/s, peak memory; the loss must
   fall; a profiled step's device time by kind (FA-2 kernels, expert
   ``bmm``, dense GEMMs, MoE dispatch and combine, the rest) and idle
   share; then at fp32 compute the kernel path's gradients against the
   plain chunked path's, leaf by leaf, at phase 3's gradient bar (the
   bf16 step is not gated: a one-ulp change can flip a token's experts);
12. train mamba2-130m at full width and depth in bf16, 4 steps of 8 x 2048
   tokens (its ssm layers through the plain ``ssd_reference``, as in the
   JAX package): ms a step, tokens/s, peak memory;
13. jamba-v0.1-52b at full width and 8 of its 32 layers (one whole
   period: attention at layer 4, MoE at 1, 3, 5, 7, seven SSD mixers),
   bf16: a 4 x 2048-token prefill through the SSD kernels (7 calls a
   forward, state 16) and the FA-2 forward (one, no positional
   encoding), dense decode of 8 x (64 + 32) tokens over the attn + ssm +
   moe caches, and ``decode_step`` token by token against the kernel
   prefill at fp32 compute (the bf16 weights cast op by op) at phase 9's
   bar;
14. serve deepseek-v3-671b at full width and 5 of its 61 layers (the 3
   dense ones and 2 of 256 experts top-8 with a shared one; MLA with 128
   heads, q-LoRA 1536, latent 512), bf16: a 2 x 4096-token
   ``forward_logits`` through the FA-2 forward at (192, 128) (one launch
   a layer) with layer 0's attention held to ``attention_fwd_plain``;
   the serve launcher's dense path, ``greedy_generate`` of 8 x (64 + 32)
   tokens over the latent cache; ``decode_step`` (the absorbed form)
   token by token against the kernel prefill (the expanded form) at fp32
   compute on 4 of the layers, at phase 9's bar, held on the dense layers
   only should a top-8 near-tie route a token apart on the two paths;
15. train deepseek-v3-671b's 3 dense layers and its MTP block at full
   width in bf16 through ``repro_torch.train.trainer.train``: 4 steps of
   1 x 2048 tokens, each FA-2 kernel launched 4 times a step at
   (192, 128), the loss and the MTP loss falling, a profiled step by
   kind, and the fp32 gradients of the kernel path against the chunked
   path leaf by leaf at phase 3's gradient bar;
16. granite-3-2b at full width and depth (40 layers, GQA 32/8, D 64,
   vocab 49155): 8 train steps of 2 x 2048 tokens, then phase 2's engine
   and requests with flash-decode's tensor-core split kernel at width 64
   launched by every layer every step, no padded vocab id chosen, and
   the mixed step kernel vs gather in fp32;
17. whisper-medium at full width and depth (24 encoder + 24 decoder
   layers, 16 heads x 64, d 1024), bf16: (a) 8 train steps of 8 x (1500
   frames, 448 tokens) through ``repro_torch.train.trainer.train``, each
   FA-2 kernel launched 72 times a step (24 encoder layers non-causal,
   24 decoder self-attention layers causal, 24 cross-attention layers
   non-causal with S 448 over T 1500), the loss falling, peak memory, a
   profiled step by kind, and MFU by a FLOP count this phase states
   (``core/flops.py`` counts neither the encoder's frames nor the
   cross-attention); (b) ``forward_logits`` over the same shape through
   the FA-2 forward, with the encoder's layer 0 attention and the
   decoder's layer 0 cross-attention held to ``attention_fwd_plain`` at
   phase 3's bf16 bar; (c) the serve launcher's dense path:
   ``encoder_forward``, the warmed cross cache, ``greedy_generate`` of 8
   x (64 + 32) tokens; (d) at fp32 compute over 2 x 160 tokens,
   ``decode_step`` against the warmed cache equal to the kernel prefill,
   and the legacy ``enc=`` path equal to the warmed one, at phase 9's bar;
18. qwen2-vl-2b at full width and depth (28 layers, GQA 12/2 at D 128,
   M-RoPE), bf16: (a) 8 train steps of 2 x 4096 tokens (1024 vision
   embeddings + 3072 text tokens, the vision labels masked) through the
   trainer, each FA-2 kernel launched 28 times a step at group 6, then
   one step split into 2 microbatches, whose loss must equal the whole
   batch's at phase 4's bf16 bar; (b) ``forward_logits`` over 2 x 4096
   with the vision prefix and distinct M-RoPE streams ((t, h, w) on a 32
   x 32 grid, the text after it), with layer 0's rotated q and k held
   to the CPU's ``apply_mrope`` of the same tensors in fp32; (c) phase
   2's engine and requests, flash-decode at (12, 2, 128) launched by
   every layer every step, and the mixed step kernel vs gather in fp32;
19. the edge fleet's control loop: (a) opt-1.3b at full width and depth,
   bf16, 2 replicas x 2 x 2048 tokens, placed by ``search_placement`` over
   an 8-device two-region fleet (laptops and phones, a 5 MB/s WAN),
   async local SGD with per-region K, quorum 2, staleness bound 1, int8
   sync through the quant8 kernels (without error feedback, whose fp32
   buffers do not fit beside the buffered deltas) and a seeded fault plan
   that makes one
   replica a straggler, run with a health monitor and without: the
   monitor must detect exactly the plan's straggler from observed
   durations, the quorum must go ahead without it (excluded updates) and
   the virtual time must fall below the unmonitored run's; the FA-2 and
   quant8 launches must equal the inner steps' and the reports' counts;
   (b) at opt-1.3b width and 4 layers, a placement-driven sync run writes
   layer-sliced checkpoints every round with one neighbour copy; a
   bit-rotted shard is named by ``damaged_files`` and mended by
   ``heal_step`` from the neighbour's copy; ``restore_for_placement`` onto
   3 stages and ``reshard`` 3 -> 2 -> 3 give back every leaf of the
   card's state bit for bit, and so does the trainer's
   ``checkpoint_placement`` save, whose resume starts from it; (c) both
   launchers in-process with ``--slo`` and ``--health-out`` (training
   reduced, serving full-width qwen2-7b), their artifacts passing
   ``repro_torch.obs.validate``;
20. the carbon-aware fleet, through the torch twins of the examples:
   (a) ``examples/torch_quickstart.py``'s ``run`` trains opt-1.3b at full
   width and depth, bf16, 8 steps of 4 x 2048 tokens under the laptop's
   component energy model and the edge carbon ledger (24 x 8 launches of
   each FA-2 kernel), with the card's ``power.draw`` sampled over the
   steps: ms and J a step measured beside ``train_time_s`` and
   ``train_energy_wh`` of ``CLOUD_H100``, the paper's model of this card
   (nothing asserted on them); (b) ``examples/torch_diloco_edge.py``'s
   ``run`` at opt-1.3b full width: 2 replicas, K 2, 2 rounds of 2 x 2048,
   int8 hierarchical sync over the example's two-region 4 MB/s fleet (17
   leaves x 2 replicas x 2 rounds launches of each quant8 kernel), its
   modelled sync against the naive fp32 ring; (c)
   ``examples/torch_serve_batched.py``: ``run_engine`` on full-width
   qwen2-7b (the example's 6 requests, 4 slots, 8-token pages,
   flash-decode in every layer every step), its greedy ids held to
   ``greedy_generate``'s at fp32 compute, and ``run_dense`` on
   full-width mamba2-130m, ms a decode step against
   ``decode_hbm_bytes`` / 3.35 TB/s; (d) on the host,
   ``examples/torch_edge_carbon_sim.py``'s policies at its defaults for
   opt-125m and opt-1.3b, each run twice and equal field for field, and
   the offload table; (e) on the host, a 10^5-device
   ``synthetic_fleet`` searched by ``search_placement_fleet`` for
   opt-1.3b and its 200-round churn sim, sync against async (quorum
   0.9); at 10^4 devices the scalar and vectorized ``FleetSim`` engines
   bit for bit, and the batched sync lanes against the scalar model;
21. the DT-FM hybrid data + pipeline executor (``repro_torch.distributed``),
   its ranks gloo processes sharing the card (activations staged through
   host memory): (a) at opt-1.3b width and 3 layers in fp32 over the
   non-uniform boundaries [0, 2, 3], the pipelined loss and every
   gradient leaf gathered to rank 0 against the single-process
   ``forward_train`` at phase 4's fp32 bars, on a 1 x 2 mesh, then a
   2 x 2 mesh against the 1 x 2 run; (b) opt-1.3b at full width and
   depth, bf16, on 1 x 4 ranks, 4 steps of 4 x 2048 tokens in 4
   microbatches with the uniform split and 4 with the split
   ``ordered_placement`` gives three laptops and a phone, each step's
   loss within phase 4's bf16 bar of the single-process trainer, 384
   launches of each FA-2 kernel a run summed over the ranks, each rank's
   step split into busy, host staging, send/recv and all-reduce time
   and its peak memory, beside ``dtfm``'s model of the same fleet; (c)
   ``examples/torch_decentralized_pipeline.py``'s ``run`` on a 2 x 2 mesh
   (30 steps of its defaults' 8 x 128), its loss check and plan
   printout.
22. the production mesh (``repro_torch.distributed.{sharding,
   act_sharding,spmd}``): FSDP over ``data`` and Megatron tensor
   parallelism over ``model`` on a 2 x 2 mesh of gloo ranks sharing the
   card, every collective staged through host memory (transport
   ``host``), the FA-2 kernels on each rank's rows and heads: (a)
   in fp32, opt-1.3b width at 2 layers (4 x 2048 tokens) and qwen2-7b
   width at 2 (2 x 2048; GQA 28 over 4 with QKV bias), the loss and
   every gradient leaf gathered from the shards against the
   single-process ``forward_train`` at phase 4's fp32 bars; (b)
   full-width, full-depth opt-1.3b, bf16, through ``python -m
   repro_torch.launch.train --full --mesh 2,2``: 4 steps of 4 x 2048,
   each step's loss and pre-clip grad norm within phase 4's bf16 bars of
   the single-process step, 384 launches of each FA-2 kernel, each
   rank's ms a step, busy ms, collective ms by kind and peak memory.
23. the dry run (``repro_torch.launch.{dryrun,step_analysis}``), on the
   CPU by design as the JAX dry run is, in a child process (one thread,
   lowest priority) started before phase 19 that runs beside phases
   19-22, and says beside which: (a) phase 22 (b)'s step
   (full-width opt-1.3b, 4 x 2048, no microbatches, no remat) traced on
   a fake 2 x 2 process group, its collectives by kind (calls and bytes
   sent in) equal to what phase 22's ranks counted in the same run;
   (b) ``qwen2-7b x train_4k`` at full depth on the fake 16 x 16 group
   (8 microbatches, remat "full"), its record and seconds; (c) (a)'s
   argument and temp bytes beside phase 22's measured peak (reported,
   not gated).
24. local SGD on the production mesh (``repro_torch.distributed.spmd.
   local_sgd``: the single process's ``train_local_sgd`` under the 2 x 2
   mesh, every piece of state a DTensor, int8 on each rank's blocks):
   (a) at opt-1.3b width and 2 layers in fp32, phase 6's sync DiLoCo with
   no compression and with int8 against the single process (losses at
   phase 4's fp32 bar; the joined final parameters and momentum at
   ``grads_held``'s bar, plus ``INT8_FLIP`` steps of each block's scale
   with int8), each rank's int8 of its blocks of replica 0's round-1
   pseudo-gradient through the kernels equal to the plain versions,
   async (quorum = replicas, staleness 0) equal to sync bit for bit, and
   the round-1 checkpoint resumed on a 1 x 4 mesh and by one process
   alike; (b) phase 6's run at full width and depth, bf16, through the
   launcher's ``--mesh 2,2 --local-sgd`` rank call with int8 sync, a
   round-2 checkpoint and the trace, metrics, health and SLO records:
   losses within phase 4's bf16 bars of phase 6's, the same wire bytes,
   192 launches of each FA-2 kernel a rank (all bf16 tensor-core), 68
   of each quant8 kernel a rank and one of each AdamW kernel a rank's
   block of a leaf an inner step, every record valid, the checkpoint
   restored by one process equal to the joined final state bit for bit,
   each rank's ms a round by part and its peak memory.

25. hold the AdamW kernels (``kernels/adamw``: the clipping norm's sum of
   squares and the fused update) against the plain loop on every dtype
   grid point (fp32/bf16 parameters, gradients and moments) at ragged 1-D
   and 2-D lengths: the moments and parameters equal or one unit in the
   last place apart (the count of unequal elements is printed), the
   norm within fp32 round-off and the same bits twice; then, at each of
   two full-size leaves, one step of the kernels against the plain loop
   on clones of the same tensors (the same bars), and the update and the
   norm timed, kernel and plain version, against the bound
   (22 bytes a parameter with bf16 gradients, 24 with fp32 ones, at 3.35
   TB/s) at opt-1.3b's fc1 leaf (402,653,184 parameters, bf16 p and g)
   and at granite-3-2b's largest leaf (671,088,640, bf16 p, fp32 g, the
   sum of microbatches).  It runs after phase 5, with its timer; phases
   4, 6 and 24 (b) count the two kernels' launches (one each a leaf a
   step).

``--phases 3,11`` runs only those phases (after the build) and prints no
kernels line and no final line.  The last line is ``{"ok": true,
"device": {...}}``; the line before it the card's name and power limit
from ``nvidia-smi``; before that a ``{"kernels": [...]}`` line.  Needs
CUDA and the repository around it.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
H, K, D, BS, B = 28, 4, 128, 16, 8  # qwen2-7b attention; 8 engine slots
TOL = {"float32": 2e-5, "bfloat16": 1e-4, "int8": 1e-4}
LOGITS_TOL = 5e-2                  # the repo's int8/bf16 logits bar
# FA-2 shapes (B, S, H, K, D, causal, window[, T[, Dv]]; T None is S, Dv
# absent is D): the JAX package's FA_CASES (tests/test_kernels.py) and a
# non-causal T != S case; MLA's widths (deepseek-v3-671b-smoke's qk 96 /
# v 64, here GQA with a ragged S, and the full model's 192 / 128); a width
# the wrappers zero-pad to 96; then opt-1.3b's attention at 4 x 2048
# tokens and at an edge replica's 2 x 2048 (phase 19's main path)
FA_CASES = [(2, 256, 4, 2, 64, True, 0), (1, 384, 4, 4, 128, True, 0),
            (2, 256, 8, 2, 64, True, 128), (1, 200, 2, 1, 64, False, 0),
            (1, 130, 2, 2, 96, True, 0), (2, 100, 4, 2, 32, False, 0, 230),
            (2, 200, 4, 2, 96, True, 0, None, 64),
            (2, 512, 16, 16, 192, True, 0, None, 128),
            (1, 160, 4, 2, 80, True, 0), (1, 2048, 32, 8, 128, True, 1024)]
OPT_FA = (4, 2048, 32, 32, 64, True, 0)
# an edge replica's opt-1.3b attention (phase 19: 2 x 2048 tokens)
OPT_EDGE_FA = (2, 2048, 32, 32, 64, True, 0)
# mixtral-8x7b's training attention (phase 11: 1 x 8192 tokens, GQA 32/8,
# D 128, the 4096 window cutting in), where the kernels are timed and,
# in bf16, held to their plain versions (whose fp32 (S x T) scores take
# 8.6 GB a tensor); FA_CASES holds it at 2048 tokens in both dtypes
MIXTRAL_FA = (1, 8192, 32, 8, 128, True, 4096)
# kernel vs plain, as a share of the reference's largest magnitude (at
# least 1): both compute in fp32 from the same inputs and differ in
# summation order only (the bf16 kernels multiply P and dS on the tensor
# cores as hi + lo bf16 pairs, which keeps each product within 2**-18 of
# fp32); a bf16 output may round to the neighbouring
# value, 2**-7 of it
FA_TOL = {"float32": {"out": 1e-5, "lse": 1e-5, "grad": 1e-4},
          "bfloat16": {"out": 2.0 ** -7, "lse": 1e-5, "grad": 1e-4}}
# one opt-1.3b step, kernels vs the chunked path from the same weights and
# batch.  fp32 compute: the two differ in summation order only.  bf16
# compute: the chunked path rounds p and ds to bf16 before their products
# (as the JAX chunked twin does) where the kernels keep them to fp32 (hi +
# lo bf16 pairs), and both
# round each attention output to bf16, then 24 layers of bf16 residual
# stream; the loss (~11, fp32 from bf16 logits) may move by a third of one
# bf16 step there (0.0625), the grad norm by a few percent
STEP_TOL = {"float32": {"loss": 1e-4, "gnorm": 1e-3},
            "bfloat16": {"loss": 2e-2, "gnorm": 5e-2}}
# SSD shapes (b, s, h, g, p, n, chunk): the JAX package's SSD_CASES
# (tests/test_kernels.py), a ragged s with p = n = 128 (the largest
# shared-memory footprint), then mamba2-130m at 8 x 4096 and 8 x 4000
# tokens
SSD_CASES = [(2, 256, 4, 1, 64, 32, 64), (1, 128, 8, 2, 32, 128, 32),
             (2, 100, 4, 4, 64, 16, 32), (1, 512, 2, 1, 128, 64, 128),
             (1, 300, 4, 2, 128, 128, 128)]
MAMBA_SSD = [(8, 4096, 24, 1, 64, 128, 128), (8, 4000, 24, 1, 64, 128, 128)]
# jamba-v0.1-52b's mixers at phase 13's prefill (4 x 2048 tokens, 128
# heads x p 64, state 16: the kernels' n <= 32 tiles, half of them
# padding), held in both dtypes and timed
JAMBA_SSD = (4, 2048, 128, 1, 64, 16, 128)
# kernel vs plain, as a share of the plain version's largest magnitude (at
# least 1): both compute in fp32 from the same inputs with the same cumsum
# and differ in the order of the products' sums only; a bf16 output may
# round to the neighbouring value, 2**-7 of it
SSD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# mamba2-130m prefill, kernel vs ssd_reference on the same weights.  fp32
# compute: both scan in fp32 and differ in summation order (and the
# reference's cumsum is not rounded once), amplified through 24 layers of
# residual stream and the 50304-way head: 1e-3 of the largest |logit|.
# bf16 compute: each layer rounds y to bf16 on both paths, and a one-ulp
# flip there grows through 24 layers of bf16 residual stream; with random
# weights the top two of 50280 logits are often closer than that, so the
# two bf16 paths may pick different tokens at a few percent of positions
# (93 % agreement on an H100).  The gate holds each bf16 path to the fp32
# reference's token: the kernel path must pick it at least as often as
# the ssd_reference path does, less 1 % (a ~7 sigma margin at 32768
# positions)
PREFILL_TOL = {"float32": 1e-3, "argmax_slack": 0.01}
# phase 9's workloads: prefill (batch, tokens); decode (batch, prompt,
# new tokens); decode-vs-prefill agreement (batch, tokens: two full
# chunks of 128 and a ragged one)
MAMBA_PREFILL, MAMBA_DECODE, MAMBA_AGREE = (8, 4096), (8, 64, 32), (2, 300)
# phase 10: mixtral-8x7b's depth on one card (4 of 32 layers: cut from 16
# to 8 when one run on a slower host took 1,037.6 s of phases, and to 4
# when phase 24 came, to keep a slow host's run under the time limit),
# the prefill's tokens (past the 4096 window), and the KV groups of layer
# 0's attention held to the plain version (its fp32 (S x S) scores for 2
# of 8 groups take 2.1 GB)
MIXTRAL_LAYERS, MIXTRAL_PREFILL, MIXTRAL_GROUPS = 4, 8192, 2
# phase 11: mixtral-8x7b trained at full width on one card.  2 of 32
# layers: 3,164,688,384 params, whose bf16 weights and gradients take
# 12.7 GB and fp32 AdamW moments 25.3 GB, 38.0 GB of state, and about
# 10 GB of activations at 8192 tokens (the expert products (8, 2560,
# 14336) in bf16 are 0.59 GB each, several a layer, and fp32 logits 1 GB);
# 3 layers would come to about 67 GB, and the fp32 gradient gate holds an
# fp32 copy of the weights and two sets of fp32 gradients (38 GB at 2
# layers).  One row of 8192 tokens, so that the 4096 window cuts in; 4
# steps, the first left out of the timing
MIXTRAL_TRAIN_LAYERS, MIXTRAL_TRAIN, MIXTRAL_TRAIN_STEPS = 2, (1, 8192), 4
# phase 12: mamba2-130m trained at full width and depth, 8 x 2048 tokens,
# each layer rematerialized in the backward: without it the stack's saved
# activations (the ssd_reference's (b, h, chunks, Q, Q) decay and score
# tensors among them, about 2 GB a layer) ran out of the card's 80 GB
MAMBA_TRAIN, MAMBA_TRAIN_STEPS, MAMBA_TRAIN_REMAT = (8, 2048), 4, "full"
# phase 13: jamba-v0.1-52b at full width and 8 of its 32 layers, one whole
# period (attention at layer 4, MoE at 1, 3, 5, 7, seven SSD mixers):
# 13,267,598,848 params, 26.5 GB of bf16 (full depth is 51.46 B params,
# 103 GB).  Prefill (batch, tokens); dense decode (batch, prompt, new);
# decode-vs-prefill agreement at fp32 compute (batch, tokens: a full chunk
# of 128 and a ragged one)
JAMBA_LAYERS, JAMBA_PREFILL, JAMBA_DECODE, JAMBA_AGREE = \
    8, (4, 2048), (8, 64, 32), (2, 160)
# deepseek-v3-671b's training attention (phase 15: 1 x 2048 tokens, MLA's
# 128 heads at (qk, v) = (192, 128), causal), timed in phase 3 and held
# there to the plain versions in bf16
DEEPSEEK_FA = (1, 2048, 128, 128, 192, True, 0, None, 128)
# phase 14: deepseek-v3-671b served at full width and 5 of its 61 layers,
# the 3 dense ones and 2 MoE ones: 27,304,645,632 params, 54.6 GB of bf16
# (full depth is 671.7 B).  Prefill (batch, tokens); dense decode (batch,
# prompt, new); decode-vs-prefill agreement at fp32 compute (batch,
# tokens), on 4 of the layers: the fp32 casts of one MoE layer's expert
# stacks (3 x 15 GB, two alive at once) do not fit beside 5 layers.  The
# KV groups (heads, at H = K) of layer 0's attention held to the plain
# version: its fp32 (S x S) scores over 2 x 4096 tokens take 134 MB a
# head, several tensors of them
DEEPSEEK_LAYERS, DEEPSEEK_PREFILL, DEEPSEEK_DECODE, DEEPSEEK_AGREE = \
    5, (2, 4096), (8, 64, 32), (2, 160)
DEEPSEEK_AGREE_LAYERS, DEEPSEEK_HEADS = 4, 8
# phase 15: deepseek-v3-671b trained at full width on the dense prefix
# (num_layers = first_dense_layers = 3: 4,290,073,600 params with the MTP
# block; bf16 weights and gradients 17.2 GB, fp32 AdamW moments 34.3 GB).
# One MoE layer is 11.5 B params, about 138 GB of training state.  One
# row of 2048 tokens, 4 steps, the first left out of the timing
DEEPSEEK_TRAIN_LAYERS, DEEPSEEK_TRAIN, DEEPSEEK_TRAIN_STEPS = 3, (1, 2048), 4
# phase 16: granite-3-2b at full width and depth (40 layers, GQA 32/8,
# D 64): a train step (batch, tokens, steps; bf16 weights and gradients
# and fp32 moments about 30 GB, remat none), then phase 2's engine and
# requests.  GRANITE_DECODE is its attention (query heads, KV heads,
# width), where phase 1 also times flash-decode
GRANITE_TRAIN, GRANITE_TRAIN_STEPS = (2, 2048), 8
GRANITE_DECODE = (32, 8, 64)
# whisper-medium's attention (phase 17), timed in phase 3 and held there
# in fp32 and bf16: the encoder's self-attention over 8 x 1500 frames and
# the decoder's cross-attention, 448 queries over the 1500 frames, both
# non-causal with 16 heads x 64
WHISPER_FA = (8, 1500, 16, 16, 64, False, 0)
WHISPER_XFA = (8, 448, 16, 16, 64, False, 0, 1500)
# phase 17: whisper-medium at full width and depth (812,003,328 params:
# bf16 weights and gradients 3.2 GB, fp32 moments 6.5 GB).  A train step
# (batch, decoder tokens, steps; each row also carries 1500 frames);
# dense decode (batch, prompt, new: within the 448 learned positions);
# decode-vs-prefill agreement at fp32 compute (batch, tokens)
WHISPER_TRAIN, WHISPER_TRAIN_STEPS = (8, 448), 8
WHISPER_DECODE, WHISPER_AGREE = (8, 64, 32), (2, 160)
# qwen2-vl-2b's training attention (phase 18: 2 x 4096 tokens, GQA 12/2,
# D 128, causal), timed in phase 3 and held there in fp32 and bf16, and
# its decode attention (query heads, KV heads, width), where phase 1 also
# times flash-decode
QWEN2VL_FA = (2, 4096, 12, 2, 128, True, 0)
QWEN2VL_DECODE = (12, 2, 128)
# phase 18: qwen2-vl-2b at full width and depth (1,543,714,304 params):
# train (batch, tokens, steps: vlm_split(4096) = 1024 vision embeddings +
# 3072 text tokens), and the prefill's vision grid (32 x 32 patches)
QWEN2VL_TRAIN, QWEN2VL_TRAIN_STEPS, QWEN2VL_GRID = (2, 4096), 8, 32
# phase 2's SLO runs: its 8 requests served SLO_COPIES times over under
# serve_slos with a TTFT target every request on the card misses and one
# no request reaches
SLO_COPIES, SLO_BAD_TTFT_S, SLO_NEVER_TTFT_S = 3, 1e-6, 3600.0
# phase 19 (a): opt-1.3b at full width and depth, each replica's (batch,
# tokens), the inner steps K, the outer updates, the fault plan (seed 6
# makes replica 0 a 6.66x straggler and replica 1 healthy), the fleet's
# size and WAN rate (tests/test_elastic.py's fleet)
EDGE_TRAIN, EDGE_K, EDGE_UPDATES = (2, 2048), 2, 6
EDGE_PLAN = dict(seed=6, straggler_frac=0.5)
EDGE_FLEET, EDGE_WAN_BPS = 8, 5e6
# phase 19 (b): opt-1.3b width at 4 layers, the sync run's rounds, the
# 3- and 2-stage splits restored and resharded onto
ELASTIC_LAYERS, ELASTIC_ROUNDS = 4, 2
ELASTIC_SPLITS = ((0, 1, 2, 4), (0, 2, 4))
# the kernels a call launches, by a part of each name: flash-decode's
# split kernel, and its merge kernel when a call has more than one split;
# the SSD scan's three when s spans more than one chunk
DECODE_KERNELS = ("flash_decode_split", "flash_decode_merge")
FA_KERNEL_NAMES = ("fa_fwd_kernel<", "fa_fwd_tc_kernel<", "fa_bwd_dq_kernel<",
                   "fa_bwd_dq_tc_kernel<", "fa_bwd_dkdv_kernel<",
                   "fa_bwd_dkdv_tc_kernel<")
SSD_KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# --------------------------------------------------------------------------- #
# Timing
# --------------------------------------------------------------------------- #

class Timer:
    """Per-call CUDA-event timing with the L2 cache flushed between calls
    (the engine reads each layer's pages cold, after other layers'
    weights have streamed through); ``ms`` returns the median and leaves
    (min, max) in ``spread``."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device=device)

    def ms(self, fn, iters: int = 20) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        self.spread = (times[0], times[-1])
        return times[len(times) // 2]

    # the flush's own kernel (``zero_`` of int32), launched once a call
    FLUSH_KERNEL = "FillFunctor<int>"

    def device_ms(self, fn, kernels, iters: int = 20) -> float:
        """Device time a call of ``fn`` spends in its kernels, each named
        by a part of its name in ``kernels`` and launched once a call:
        torch.profiler over ``iters`` calls with the L2 cache flushed
        before each, so the kernels alone, without the host's dispatch
        or the gaps between launches.  The sum over those kernels of each
        one's mean time a launch, should the profiler drop some launches'
        records.  Fails if it saw no launch of one of ``kernels``, or
        more than one a call.  Leaves [(name, launches seen a call, ms a
        launch)] of those kernels in ``kernels``, and [(name, launches a
        call)] of every other device operation of the calls (the flush's
        excepted) in ``others``."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, schedule
        torch = self.torch
        # a warm-up step first: records of the launches made as a session
        # starts tracing can be lost, those of the flush's kernel too
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            self.flush.zero_()
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
            prof.step()
        seen = [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.count > 0
                and not ev.key.startswith("ProfilerStep")]
        mine = [ev for ev in seen if any(k in ev.key for k in kernels)]
        missing = [k for k in kernels if not any(k in ev.key for ev in mine)]
        if missing or any(ev.count > iters for ev in mine):
            fail(f"the profiler saw no launch of {missing}, or a kernel "
                 f"launched more than once a call: "
                 f"{[(ev.key, ev.count) for ev in seen]}")
        self.kernels = [(ev.key, ev.count / iters,
                         ev.device_time_total / 1e3 / ev.count)
                        for ev in mine]
        self.others = []
        for ev in seen:
            n = ev.count - (iters if self.FLUSH_KERNEL in ev.key else 0)
            if ev not in mine and n > 0:
                self.others.append((ev.key, n / iters))
        return sum(ms for _, _, ms in self.kernels)


# --------------------------------------------------------------------------- #
# Phase 1: kernel vs plain
# --------------------------------------------------------------------------- #

def make_pages(torch, lens, C, dtype, device, seed, shape=(H, K, D)):
    """Disjoint shuffled block tables over a pool holding each sequence's
    live pages; table entries past them point at the null page 0.
    ``shape`` is (query heads, KV heads, head width)."""
    from repro_torch.kernels.quant8.ops import quantize_kv
    H, K, D = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    need = [-(-(L + C - 1) // BS) for L in lens]
    nb = max(need)
    pool = sum(need) + 1
    perm = (torch.randperm(pool - 1, generator=g) + 1).tolist()
    bt = torch.zeros((len(lens), nb), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        bt[b, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    kf = torch.randn((pool, BS, K, D), generator=g)
    vf = torch.randn((pool, BS, K, D), generator=g)
    q = torch.randn((len(lens), C, H, D), generator=g)
    scales = {}
    if dtype == "int8":
        kp, scales["k_scale"] = quantize_kv(kf)
        vp, scales["v_scale"] = quantize_kv(vf)
    else:
        kp, vp = kf.to(getattr(torch, dtype)), vf.to(getattr(torch, dtype))
    q = q[:, 0] if C == 1 else q
    sl = torch.tensor(lens, dtype=torch.int32)
    return (q.to(device), kp.to(device), vp.to(device), bt.to(device),
            sl.to(device), {k: v.to(device) for k, v in scales.items()})


def live_bytes(lens, C, dtype, q, shape=(H, K, D)):
    """Bytes a call must move: every live K/V token (and int8 scale) read
    once, q read once, the fp32 output (q's shape) written once."""
    _, K, D = shape
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    per_tok = K * 2 * (D * item + (4 if dtype == "int8" else 0))
    toks = sum(L + C - 1 for L in lens if L + C - 1 > 0)
    return toks * per_tok + 2 * q.numel() * 4


def phase_kernel(torch, device, timer):
    from repro_torch.kernels.flash_attention.decode import (
        decode_splits, flash_decode_paged, paged_attention_reference)
    # two lengths on a split's edge and one past it, at the planned split
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    edge, _ = decode_splits(B, K, -(-2048 // BS), sms)
    ragged = [0, 1, BS, BS * edge, 2048, 17, BS * edge + 1, 1000]
    cases = [(dt, C, 0) for dt in ("float32", "bfloat16", "int8")
             for C in (1, 8)] + [("bfloat16", 8, 100), ("int8", 1, 300)]
    worst = 0.0
    for i, (dtype, C, window) in enumerate(cases):
        q, kp, vp, bt, sl, sc = make_pages(torch, ragged, C, dtype, device,
                                           seed=i)
        out = flash_decode_paged(q, kp, vp, bt, sl, window=window, **sc)
        ref = paged_attention_reference(q, kp, vp, bt, sl, window=window,
                                        **sc)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            fail(f"non-finite kernel output ({dtype}, C={C}, w={window})")
        zero_rows = out[0] if C == 1 else out[0, 0]
        if float(zero_rows.abs().max()) != 0.0:
            fail("seq_len == 0 slot did not give zeros")
        err = float((out - ref).abs().max())
        worst = max(worst, err)
        ok = err <= TOL[dtype]
        log(f"case {dtype:8s} C={C} window={window:3d} lens={ragged}: "
            f"max_abs_err {err:.3e} (bound {TOL[dtype]:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_decode_paged disagrees with its plain version "
                 f"({dtype}, C={C}, window={window}): {err}")

    timing = time_decode(torch, device, timer, (H, K, D), "qwen2-7b")
    timing["granite"] = time_decode(torch, device, timer, GRANITE_DECODE,
                                    "granite-3-2b")
    timing["qwen2_vl"] = time_decode(torch, device, timer, QWEN2VL_DECODE,
                                     "qwen2-vl-2b")
    worst = max(worst, timing["granite"].pop("max_abs_err"),
                timing["qwen2_vl"].pop("max_abs_err"),
                timing.pop("max_abs_err"))

    # an engine-shaped chunked-prefill call: 8 slots, C=8, ~128 tokens
    elens = [16, 48, 32, 64, 80, 96, 112, 128]
    q, kp, vp, bt, sl, _ = make_pages(torch, elens, 8, "bfloat16", device,
                                      seed=98)
    call = lambda: flash_decode_paged(q, kp, vp, bt, sl)  # noqa: E731
    eng_ms = timer.ms(call)
    _, splits = decode_splits(B, K, bt.shape[1], sms)
    eng_device_ms = timer.device_ms(call, DECODE_KERNELS[:1 + (splits > 1)])
    log(f"timing engine-shaped chunk (C=8, lens {elens}): kernel_ms "
        f"{eng_ms:.4f} device_ms {eng_device_ms:.4f}")
    log(f"kernels held against their plain version: "
        f"[flash_decode_paged] worst max_abs_err {worst:.3e}")
    return worst, timing


def time_decode(torch, device, timer, shape, label):
    """At B = 8 sequences x 2048 tokens of bf16 pages and ``shape`` (query
    heads, KV heads, head width): the kernel held against its plain
    version, then the whole call (``ms``), its kernels alone
    (``device_ms``), the plain version, SDPA over the gathered K/V and the
    bound.  Fails if a call issues any other device operation."""
    from repro_torch.kernels.flash_attention.decode import (
        decode_splits, flash_decode_paged, paged_attention_reference)
    Hs, Ks, Ds = shape
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    lens = [2048] * B
    q, kp, vp, bt, sl, _ = make_pages(torch, lens, 1, "bfloat16", device,
                                      seed=99, shape=shape)
    call = lambda: flash_decode_paged(q, kp, vp, bt, sl)  # noqa: E731
    err = float((call() - paged_attention_reference(q, kp, vp, bt, sl))
                .abs().max())
    if not err <= TOL["bfloat16"]:
        fail(f"flash_decode_paged disagrees with its plain version at "
             f"{label}'s shape {shape}: {err}")
    ms = timer.ms(call)
    log(f"kernel_ms at {label}'s shape spread over 20 calls: min "
        f"{timer.spread[0]:.4f} max {timer.spread[1]:.4f}")
    pps, splits = decode_splits(B, Ks, bt.shape[1], sms)
    device_ms = timer.device_ms(call, DECODE_KERNELS[:1 + (splits > 1)])
    log(f"one call at {label}'s shape ({splits} splits of {pps} pages, "
        f"{sms} SMs): its kernels (launches seen a call, ms a launch) "
        + "; ".join(f"{k} x{n:g} {t:.4f}" for k, n, t in timer.kernels)
        + f"; other device operations {timer.others}")
    if timer.others:
        fail(f"a flash_decode_paged call issued more than its two kernels: "
             f"{timer.others}")
    plain_ms = timer.ms(lambda: paged_attention_reference(q, kp, vp, bt, sl))
    kd = kp[bt.long()].reshape(B, -1, Ks, Ds).transpose(1, 2)
    vd = vp[bt.long()].reshape(B, -1, Ks, Ds).transpose(1, 2)
    kd = kd.repeat_interleave(Hs // Ks, dim=1).contiguous()
    vd = vd.repeat_interleave(Hs // Ks, dim=1).contiguous()
    qd = q.to(torch.bfloat16)[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = timer.ms(lambda: sdpa(qd, kd, vd))
    nbytes = live_bytes(lens, 1, "bfloat16", q, shape)
    flops = 2 * 2 * Ds * Hs * sum(lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    timing = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "max_abs_err": err}
    log(f"timing {label} (H {Hs}, K {Ks}, D {Ds}) B={B} x 2048 tokens bf16 "
        f"decode: max_abs_err {err:.3e} (bound {TOL['bfloat16']:.0e}); "
        f"kernel_ms {ms:.4f} (the whole call) device_ms {device_ms:.4f} "
        f"(its kernels alone, profiler) plain_ms {plain_ms:.4f} "
        f"library_ms(SDPA on gathered K/V) {library_ms:.4f} bound_ms "
        f"{timing['bound_ms']:.4f} ({nbytes/1e6:.2f} MB, bound by "
        f"{timing['bound_by']}); {nbytes / device_ms / 1e6:.0f} GB/s over "
        f"the kernels' time")
    del q, kp, vp, kd, vd, qd
    torch.cuda.empty_cache()
    return timing


# --------------------------------------------------------------------------- #
# Phase 2: full-width engine
# --------------------------------------------------------------------------- #

def engine_requests(cfg, np, seed=0):
    from repro_torch.serve.engine import Request
    rs = np.random.RandomState(seed)
    system = list(map(int, rs.randint(0, cfg.vocab_size, 32)))
    lens = [16, 48, 32, 64, 80, 96, 112, 128]
    reqs = []
    for i, L in enumerate(lens):
        if i % 2:        # half share the 32-token system prompt
            prompt = system + list(map(int, rs.randint(0, cfg.vocab_size,
                                                       L - 32)))
        else:
            prompt = list(map(int, rs.randint(0, cfg.vocab_size, L)))
        reqs.append(Request(uid=f"r{i}", prompt=prompt, max_new=16))
    return system, reqs


def primed_engine(params, cfg, device, np, slo=None):
    """Phase 2's engine (8 slots, block 16, 512 blocks, chunk 8, bf16
    pages through flash-decode) after its warm-up, with phase 2's system
    prompt served once: a server that has served it before holds it in
    its prefix cache, so the shared requests hit.  ``slo`` (an
    ``SLOMonitor``) is attached after the priming, so it sees only the
    measured requests.  Returns (engine, phase 2's requests)."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    ecfg = EngineConfig(max_slots=B, block_size=BS, num_blocks=512,
                        max_blocks_per_seq=16, attn_impl="kernel",
                        cache_dtype="bfloat16", prefill_chunk=8)
    eng = ServeEngine(params, cfg, ecfg, torch_device=device)
    eng.warmup()
    system, reqs = engine_requests(cfg, np)
    eng.run([Request(uid="prime", prompt=system, max_new=1)])
    eng.reset_stats()
    eng.slo = slo
    return eng, reqs


def serve_checked(eng, reqs, cfg, label):
    """``reqs`` through ``eng``, with flash-decode's counts set to 0 just
    before: fails unless every request completed with 16 tokens, every
    layer launched flash-decode every step and the prefix cache hit.
    Returns (outputs, stats, launches, launches by instantiation)."""
    from repro_torch.kernels.flash_attention.decode import flash_decode_paged
    flash_decode_paged.launches = 0
    before = flash_decode_paged.kernels.copy()
    out = eng.run(reqs)
    launches = flash_decode_paged.launches
    ran = dict(flash_decode_paged.kernels - before)
    s = eng.stats()
    if set(out) != {r.uid for r in reqs} or any(
            len(out[r.uid].tokens) != 16 or out[r.uid].failed for r in reqs):
        fail(f"{label}: not every request completed with 16 tokens")
    if launches != cfg.num_layers * eng.steps or launches == 0:
        fail(f"{label}: flash-decode launches {launches} != "
             f"{cfg.num_layers} x {eng.steps} steps")
    if s["prefix_hit_tokens"] <= 0:
        fail(f"{label}: no prefix hits on the shared system prompt")
    return out, s, launches, ran


def mixed_step_diff(torch, np, M, params, cfg, device):
    """One mixed step (decode slots, prefill chunks, an idle slot) from
    identical pages through the kernel and the plain gather path, in the
    serving dtype (bf16) and in fp32 compute (pages stay bf16; each op
    casts its bf16 weights to fp32, so no fp32 copy of the model is
    held).  Returns {compute dtype: max |logits(kernel) -
    logits(gather)|} over the vocabulary's live ids and the largest
    |logit| there."""
    import dataclasses

    from repro_torch.models.params import tree_map
    from repro_torch.serve.paged_cache import PagedKVCache
    fed = [40, 23, 0, 64, 17, 33, 50, 9]
    kv = PagedKVCache(num_blocks=64, block_size=BS, max_slots=B,
                      max_blocks_per_seq=8, prefix_sharing=False)
    cache = M.init_paged_cache(cfg, 64, BS, torch.bfloat16, device)
    rs = np.random.RandomState(1)
    toks = [list(map(int, rs.randint(0, cfg.vocab_size, n + 8)))
            for n in fed]
    for b, n in enumerate(fed):
        if n:
            kv.open_slot(b)

    def step(feeds, impl, pools, p=params, c=cfg):
        C = max(feeds)
        tokens = np.zeros((B, C), np.int32)
        for b, n in enumerate(feeds):
            if n:
                assert kv.ensure_capacity(b, n)
                t0 = kv.table(b).num_tokens
                tokens[b, :n] = toks[b][t0:t0 + n]
        bt = torch.from_numpy(kv.device_tables()).to(device)
        sl = torch.from_numpy(kv.seq_lens()).to(device)
        nf = torch.tensor(feeds, dtype=torch.int32, device=device)
        with torch.no_grad():
            logits, _ = M.decode_step_paged(
                p, c, pools, torch.from_numpy(tokens).to(device), bt, sl,
                attn_impl=impl, num_feed=nf)
        return logits[:, :c.vocab_size].float()

    done = [0] * B
    while any(d < n for d, n in zip(done, fed)):
        feeds = [min(8, n - d) for d, n in zip(done, fed)]
        step(feeds, "kernel", cache)
        for b, n in enumerate(feeds):
            for _ in range(n):
                kv.commit_token(b)
            done[b] += n
    feeds = [1 if n % 2 else (8 if n else 0) for n in fed]
    live = torch.tensor(feeds, device=device) > 0

    def twin():
        return tree_map(lambda t: t.clone(), cache)

    diffs = {}
    lk = step(feeds, "kernel", twin())
    if lk.shape != (B, cfg.vocab_size) or \
            not bool(torch.isfinite(lk[live]).all()):
        fail(f"mixed-step logits malformed: {tuple(lk.shape)}")
    lg = step(feeds, "gather", twin())
    diffs["bfloat16"] = float((lk[live] - lg[live]).abs().max())
    peak = float(lk[live].abs().max())
    del lk, lg
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    lk = step(feeds, "kernel", twin(), params, cfg32)
    lg = step(feeds, "gather", twin(), params, cfg32)
    diffs["float32"] = float((lk[live] - lg[live]).abs().max())
    torch.cuda.synchronize()
    return diffs, peak, feeds


def profile_run(torch, eng, reqs, step_ms):
    """Device time by kernel over a profiled engine run of the same
    requests (torch.profiler, the device's activity only: the host's op
    events of a 40-layer engine run made the profiled run ten times the
    unprofiled one; the timed run is not profiled).  The device's idle
    share compares device time per step with the unprofiled run's wall
    time per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(reqs)
    rows = [(ev.device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0]
    dev_ms = sum(r[0] for r in rows) / 1e3 / max(eng.steps, 1)
    log(f"profiled run: {eng.steps} steps, device busy {dev_ms:.3f} ms a "
        f"step vs {step_ms:.3f} ms a step unprofiled: busy "
        f"{100 * dev_ms / step_ms:.1f}%, idle {100 - 100 * dev_ms / step_ms:.1f}%")
    for dev_us, key, count in sorted(rows, reverse=True)[:8]:
        log(f"  device {dev_us / 1e3 / max(eng.steps, 1):8.3f} ms/step "
            f"x{count:6d}  {key[:90]}")


def phase_engine(torch, np, device):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params

    cfg = get_config("qwen2-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in _leaves(params))
    log(f"qwen2-7b full width: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.param_count():,} params, {nbytes/1e9:.2f} GB bf16, "
        f"init {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    eng, reqs = primed_engine(params, cfg, device, np)
    log(f"warmup + prefix priming {time.perf_counter() - t0:.1f} s")
    _, s, launches, _ = serve_checked(eng, reqs, cfg, "qwen2-7b")
    log(f"engine run: {int(s['tokens_generated'])} tokens, "
        f"{int(s['steps'])} steps, {eng.wall_s:.3f} s, "
        f"{s['tokens_per_s']:.1f} tokens/s, peak KV "
        f"{s['peak_cache_bytes']/1e6:.2f} MB of {s['pool_bytes']/1e6:.1f} MB "
        f"pool, prefix hit tokens {int(s['prefix_hit_tokens'])}, "
        f"TTFT p50 {s.get('ttft_p50_s', float('nan'))*1e3:.1f} ms; "
        f"flash_decode_paged launches {launches} = {cfg.num_layers} x "
        f"{eng.steps} steps")

    # the same requests again through a fresh engine, under the profiler
    step_ms = eng.wall_s / eng.steps * 1e3
    del eng
    eng, reqs = primed_engine(params, cfg, device, np)
    profile_run(torch, eng, reqs, step_ms)
    del eng

    diffs, peak, feeds = mixed_step_diff(torch, np, M, params, cfg, device)
    # bf16 logits are rounded to 8 significant bits: one unit in the last
    # place at the largest |logit|, times the residual stream's 28 layers
    # of re-rounding, is the floor for two bf16 paths that differ only in
    # fp32 summation order inside attention
    ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
    log(f"mixed step (feeds {feeds}) kernel vs gather logits max_abs_diff: "
        f"bf16 compute {diffs['bfloat16']:.3e} (largest |logit| {peak:.2f}, "
        f"bf16 ulp there {ulp:.3e}, bound 4 ulp = {4 * ulp:.3e}); "
        f"fp32 compute over the same bf16 pages {diffs['float32']:.3e} "
        f"(bound {LOGITS_TOL:.0e})")
    if not diffs["float32"] <= LOGITS_TOL:
        fail(f"kernel and gather logits differ by {diffs['float32']} "
             "in fp32 compute")
    if not diffs["bfloat16"] <= 4 * ulp:
        fail(f"kernel and gather bf16 logits differ by {diffs['bfloat16']}")
    return launches, slo_engine_check(params, cfg, device, np)


def slo_run(params, cfg, device, np, target):
    """Phase 2's requests SLO_COPIES times over through a primed engine,
    under ``serve_slos(ttft_p99_s=target)`` (no SLO with ``target``
    None), flash-decode's count set to 0 just before.  Returns (outputs,
    stats, steps, launches, admissions deferred, [(live slots, TTFT SLO
    burning) at each admission], the monitor)."""
    import dataclasses

    from repro_torch.kernels.flash_attention.decode import flash_decode_paged
    from repro_torch.obs import MetricsRegistry, SLOMonitor, serve_slos
    slo = None if target is None else SLOMonitor(
        serve_slos(ttft_p99_s=target), registry=MetricsRegistry())
    eng, reqs = primed_engine(params, cfg, device, np, slo=slo)
    reqs = [dataclasses.replace(r, uid=f"{r.uid}c{c}")
            for c in range(SLO_COPIES) for r in reqs]
    admitted = []
    open_slot = eng.kv.open_slot

    def spy(slot, prompt=None):
        admitted.append((sum(s is not None for s in eng._slots),
                         slo is not None and slo.burning("serve_ttft")))
        return open_slot(slot, prompt)
    eng.kv.open_slot = spy
    flash_decode_paged.launches = 0
    out = eng.run(reqs)
    launches = flash_decode_paged.launches
    if set(out) != {r.uid for r in reqs} or any(
            len(out[r.uid].tokens) != 16 or out[r.uid].failed for r in reqs):
        fail(f"SLO run (target {target}): not every request completed "
             "with 16 tokens")
    deferred = int(eng.metrics.counter("serve/admission_deferred").value)
    return out, eng.stats(), eng.steps, launches, deferred, admitted, slo


def slo_engine_check(params, cfg, device, np):
    """The SLO-gated engine: a TTFT target every request misses must defer
    admissions past half the slots once it burns; one no request reaches
    must schedule exactly as no SLO.  Returns the burning run's
    flash-decode launches."""
    out, s, steps, launches, deferred, admitted, slo = slo_run(
        params, cfg, device, np, SLO_BAD_TTFT_S)
    half = B // 2
    late = [live for live, burning in admitted if burning]
    log(f"SLO-gated engine, TTFT target {SLO_BAD_TTFT_S:g} s: {len(out)} "
        f"requests, {steps} steps, {deferred} admissions deferred, "
        f"{len(late)} admissions after the burn began with at most "
        f"{max(late, default=0)} slots live (bound < {half}); TTFT p50 "
        f"{s['ttft_p50_s'] * 1e3:.1f} ms, p99 {s['ttft_p99_s'] * 1e3:.1f} "
        f"ms, {s['tokens_per_s']:.1f} tokens/s; {slo.summary_line()}; "
        f"flash_decode_paged launches {launches} = {cfg.num_layers} x "
        f"{steps} steps")
    if deferred == 0 or not slo.burning("serve_ttft") or not late:
        fail("the TTFT SLO never burned or no admission was deferred")
    if max(late) >= half:
        fail(f"an admission after the burn began found {max(late)} slots "
             f"live (the gate holds below {half})")
    if launches != cfg.num_layers * steps:
        fail(f"SLO run: flash-decode launches {launches} != "
             f"{cfg.num_layers} x {steps} steps")
    never = slo_run(params, cfg, device, np, SLO_NEVER_TTFT_S)
    plain = slo_run(params, cfg, device, np, None)
    same = {u: c.tokens for u, c in never[0].items()} == \
        {u: c.tokens for u, c in plain[0].items()}
    log(f"TTFT target {SLO_NEVER_TTFT_S:g} s (never reached): "
        f"{never[2]} steps, {never[4]} deferred, TTFT p50 "
        f"{never[1]['ttft_p50_s'] * 1e3:.1f} ms; without an SLO: "
        f"{plain[2]} steps, TTFT p50 {plain[1]['ttft_p50_s'] * 1e3:.1f} "
        f"ms; the same tokens {same}; {never[6].summary_line()}")
    if never[4] or never[2] != plain[2] or not same:
        fail("an SLO that never burns changed the schedule or the tokens")
    return launches


# --------------------------------------------------------------------------- #
# Phase 3: FA-2 kernels vs plain
# --------------------------------------------------------------------------- #

def fa_widths(case):
    """(T, Dv) of an FA case: T defaults to S, Dv to D."""
    S, D = case[1], case[4]
    T = case[7] if len(case) > 7 and case[7] is not None else S
    return T, (case[8] if len(case) > 8 else D)


def fa_tensors(torch, case, dtype, device, seed):
    """q (B,H,S,D), k (B,K,T,D), v (B,K,T,Dv), do (B,H,S,Dv): views of
    (B,S,H,·) tensors, the training layout the kernels read through
    strides."""
    Bc, S, Hc, Kc, Dc = case[:5]
    T, Dv = fa_widths(case)
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(dtype) \
            .transpose(1, 2)
    return (randn(Bc, S, Hc, Dc), randn(Bc, T, Kc, Dc), randn(Bc, T, Kc, Dv),
            randn(Bc, S, Hc, Dv))


def fa_executed(kern, D, Dv):
    """FLOP a bf16 kernel executes per FLOP of the function: the forward
    multiplies P as two bf16 halves (q.k once, p.v twice), dq dS (q.k and
    do.v once, ds.k twice), dk/dv P and dS (every product twice but q.k
    and do.v); 1.5, 4/3 and 1.5 at D = Dv."""
    return {"fwd": (2 * D + 4 * Dv) / (2 * D + 2 * Dv),
            "dq": (6 * D + 2 * Dv) / (4 * D + 2 * Dv),
            "dkdv": 1.5}[kern]


def fa_work(case, q, k, v, do):
    """(FLOPs, bytes) of one call of each kernel on these inputs: every
    visible (query, key) pair costs 2*D for q.k and ds.k (and ds.q), 2*Dv
    for do.v and p.v (and p.do), and each input is read and each output
    written once."""
    from repro_torch.kernels.flash_attention.ref import visible
    Bc, S, Hc, Kc, Dc, causal, window = case[:7]
    T, Dv = fa_widths(case)
    pairs = int(visible(S, T, causal=causal, window=window,
                        device=q.device).sum()) * Bc * Hc
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa
    rows = Bc * Hc * S * 4                           # one fp32 row value
    qkv = nb(q, k, v)
    f32 = lambda *ts: sum(t.numel() * 4 for t in ts)  # noqa: E731
    return {
        "fwd": (2 * (Dc + Dv) * pairs, qkv + nb(do) + rows),  # out: do's
        "dq": (2 * (2 * Dc + Dv) * pairs, qkv + nb(do) + 2 * rows
               + f32(q)),
        "dkdv": (4 * (Dc + Dv) * pairs, qkv + nb(do) + 2 * rows
                 + f32(k, v)),
    }


def phase_fa(torch, device, timer):
    from repro_torch.kernels.flash_attention import kernel as FK
    worst = {"fwd": 0.0, "dq": 0.0, "dkdv": 0.0}
    for i, case in enumerate(FA_CASES + [OPT_FA, OPT_EDGE_FA, WHISPER_FA,
                                         WHISPER_XFA, QWEN2VL_FA,
                                         OPT_PIPE_FA, OPT_TP_FA,
                                         OPT_LS_FA]):
        causal, window = case[5], case[6]
        kw = dict(causal=causal, window=window)
        for dt in ("float32", "bfloat16"):
            q, k, v, do = fa_tensors(torch, case, getattr(torch, dt),
                                     device, seed=10 + i)
            out, lse = FK.flash_attention_fwd(q, k, v, **kw)
            ref_out, ref_lse = FK.attention_fwd_plain(q, k, v, **kw)
            delta = (do.float() * ref_out.float()).sum(-1)
            dq = FK.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, **kw)
            dk, dv = FK.flash_attention_bwd_dkdv(q, k, v, do, ref_lse, delta,
                                                 **kw)
            torch.cuda.synchronize()
            ref_dq = FK.attention_bwd_dq_plain(q, k, v, do, ref_lse, delta,
                                               **kw)
            ref_dk, ref_dv = FK.attention_bwd_dkdv_plain(
                q, k, v, do, ref_lse, delta, **kw)
            tol = FA_TOL[dt]
            checks = [("fwd", "out", out, ref_out, tol["out"]),
                      ("fwd", "lse", lse, ref_lse, tol["lse"]),
                      ("dq", "dq", dq, ref_dq, tol["grad"]),
                      ("dkdv", "dk", dk, ref_dk, tol["grad"]),
                      ("dkdv", "dv", dv, ref_dv, tol["grad"])]
            msg = []
            for kern, name, a, b, t in checks:
                a, b = a.float(), b.float()
                if not bool(torch.isfinite(a).all()):
                    fail(f"non-finite {name} from the {kern} kernel {case}")
                err = float((a - b).abs().max())
                bound = t * max(1.0, float(b.abs().max()))
                worst[kern] = max(worst[kern], err)
                msg.append(f"{name} {err:.2e}/{bound:.1e}")
                if err > bound:
                    fail(f"{kern} kernel disagrees with its plain version "
                         f"on {name} ({case}, {dt}): {err} > {bound}")
            log(f"FA case {case} {dt:8s}: max_abs_err/bound "
                + ", ".join(msg))
            del q, k, v, do, out, lse, ref_out, ref_lse, delta, dq, dk, dv
            del ref_dq, ref_dk, ref_dv
            torch.cuda.empty_cache()

    timing = time_fa(torch, device, timer, OPT_FA, "opt-1.3b", worst)
    timing["opt_edge"] = time_fa(torch, device, timer, OPT_EDGE_FA,
                                 "opt-1.3b edge replica", worst)
    timing["opt_pipe"] = time_fa(torch, device, timer, OPT_PIPE_FA,
                                 "opt-1.3b DT-FM pipeline microbatch", worst)
    timing["opt_tp"] = time_fa(torch, device, timer, OPT_TP_FA,
                               "opt-1.3b (data, model) mesh rank", worst)
    timing["opt_ls"] = time_fa(torch, device, timer, OPT_LS_FA,
                               "opt-1.3b mesh local-SGD rank", worst,
                               floor=False)
    timing["mixtral"] = time_fa(torch, device, timer, MIXTRAL_FA,
                                "mixtral-8x7b train", worst, hold=True)
    timing["deepseek"] = time_fa(torch, device, timer, DEEPSEEK_FA,
                                 "deepseek-v3-671b train", worst, hold=True)
    timing["whisper"] = time_fa(torch, device, timer, WHISPER_FA,
                                "whisper-medium encoder", worst)
    timing["whisper_cross"] = time_fa(torch, device, timer, WHISPER_XFA,
                                      "whisper-medium cross-attention", worst)
    timing["qwen2_vl"] = time_fa(torch, device, timer, QWEN2VL_FA,
                                 "qwen2-vl-2b train", worst)
    margins = {k: e / b for k, (e, b) in timing["deepseek"]["held"].items()}
    log("bf16 kernels vs plain at deepseek-v3-671b's training attention "
        f"{DEEPSEEK_FA}: error / bound " + ", ".join(
            f"{k} {v:.3f}" for k, v in margins.items())
        + " (mixtral's: " + ", ".join(
            f"{k} {e / b:.3f}" for k, (e, b) in
            timing["mixtral"]["held"].items()) + ")")
    log("FA-2 kernels held against their plain versions: worst "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst, timing


def time_fa(torch, device, timer, case, label, worst, hold=False,
            floor=True):
    """Kernel, plain version, SDPA and bound of each FA-2 kernel at
    ``case`` in bf16, as the train step calls them; with ``hold`` the
    kernels are also held to their plain versions there (``worst`` is
    updated, and each output's (error, bound) left in the result's
    ``held``).  Every timed launch must be a tensor-core instantiation
    by the name the wrapper records, and with ``floor`` execute more
    than the CUDA cores' fp32 rate (a shape too small to fill the card
    is latency-bound below it).  Returns {kernel: timing}."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import visible
    S, Hc, Kc = case[1:4]
    T = fa_widths(case)[0]
    kw = dict(causal=case[5], window=case[6])
    q, k, v, do = fa_tensors(torch, case, torch.bfloat16, device, seed=99)
    out, lse = FK.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    held = {}
    if hold:
        tol = FA_TOL["bfloat16"]
        ref_out, ref_lse = FK.attention_fwd_plain(q, k, v, **kw)
        checks = [("fwd", "out", out, ref_out, tol["out"]),
                  ("fwd", "lse", lse, ref_lse, tol["lse"])]
        del ref_out
        ref_dq = FK.attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
        checks.append(("dq", "dq", FK.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, **kw), ref_dq, tol["grad"]))
        del ref_dq
        torch.cuda.empty_cache()
        ref_dk, ref_dv = FK.attention_bwd_dkdv_plain(q, k, v, do, lse,
                                                     delta, **kw)
        dk, dv = FK.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        checks += [("dkdv", "dk", dk, ref_dk, tol["grad"]),
                   ("dkdv", "dv", dv, ref_dv, tol["grad"])]
        msg = []
        for kern, name, a, b, t in checks:
            err = float((a.float() - b.float()).abs().max())
            bound = t * max(1.0, float(b.float().abs().max()))
            worst[kern] = max(worst[kern], err)
            held[name] = (err, bound)
            msg.append(f"{name} {err:.2e}/{bound:.1e}")
            if not err <= bound:
                fail(f"{kern} kernel disagrees with its plain version on "
                     f"{name} at {label}'s shape {case}: {err} > {bound}")
        log(f"FA case {case} bfloat16 ({label}): max_abs_err/bound "
            + ", ".join(msg))
        del checks, dk, dv, ref_dk, ref_dv
        torch.cuda.empty_cache()
    # SDPA: the window as a boolean mask, over K/V repeated to every
    # query head outside the timed call
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = (dict(attn_mask=visible(S, T, device=device, **kw)) if case[6]
           else dict(is_causal=True) if case[5] else {})
    kx, vx = (t.repeat_interleave(Hc // Kc, dim=1) for t in (k, v))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, kx, vx))
    sdpa_out = sdpa(qg, kg, vg, **lib)
    calls = {
        "fwd": (lambda: FK.flash_attention_fwd(q, k, v, **kw),
                lambda: FK.attention_fwd_plain(q, k, v, **kw),
                lambda: sdpa(q, kx, vx, **lib)),
        "dq": (lambda: FK.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                 **kw),
               lambda: FK.attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                                 **kw),
               lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do,
                                           retain_graph=True)),
        "dkdv": (lambda: FK.flash_attention_bwd_dkdv(q, k, v, do, lse,
                                                     delta, **kw),
                 lambda: FK.attention_bwd_dkdv_plain(q, k, v, do, lse,
                                                     delta, **kw),
                 None),
    }
    work = fa_work(case, q, k, v, do)
    timing = {}
    wrappers = {"fwd": FK.flash_attention_fwd,
                "dq": FK.flash_attention_bwd_dq,
                "dkdv": FK.flash_attention_bwd_dkdv}
    for kern, (kfn, pfn, lfn) in calls.items():
        before = dict(wrappers[kern].kernels)
        ms = timer.ms(kfn)
        spread = timer.spread
        ran = {k for k, n in wrappers[kern].kernels.items()
               if n != before.get(k, 0)}
        if not ran or any("_tc_kernel<" not in k for k in ran):
            fail(f"the bf16 {kern} kernel at {label}'s shape ran {ran}, not "
                 "only tensor-core instantiations")
        plain_ms = timer.ms(pfn, iters=5 if hold else 20)
        library_ms = timer.ms(lfn) if lfn else timing["dq"]["library_ms"]
        flops, nbytes = work[kern]
        executed = fa_executed(kern, case[4], fa_widths(case)[1])
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        timing[kern] = {"ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms,
                        "bound_ms": max(t_ops, t_bytes),
                        "bound_by": "operations" if t_ops >= t_bytes
                        else "bytes"}
        log(f"timing {kern} at {label} shape {case} bf16: kernel_ms "
            f"{ms:.4f} (min {spread[0]:.4f} max {spread[1]:.4f}) plain_ms "
            f"{plain_ms:.4f} library_ms {library_ms:.4f} "
            f"({'SDPA backward, dq+dk+dv together' if kern != 'fwd' else 'SDPA forward'}"
            f"{', window as a mask' if case[6] else ''}"
            f"{', K/V repeated to H heads' if Kc != Hc else ''}) "
            f"bound_ms {timing[kern]['bound_ms']:.4f} ({flops:.3e} FLOP, "
            f"{nbytes/1e6:.1f} MB; bound by {timing[kern]['bound_by']}); "
            f"{flops / ms / 1e9:.1f} TFLOP/s counted, "
            f"{executed * flops / ms / 1e9:.1f} TFLOP/s executed")
        if floor and executed * flops / ms * 1e3 <= FP32_FLOP_PER_S:
            fail(f"the bf16 {kern} kernel executed no more than the fp32 "
                 f"CUDA cores' {FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s: it is "
                 "not running on the tensor cores")
    bwd_ms = timing["dq"]["ms"] + timing["dkdv"]["ms"]
    log(f"backward at {label} shape: dq + dk/dv {bwd_ms:.4f} ms vs SDPA's "
        f"whole backward {timing['dq']['library_ms']:.4f} ms "
        f"({bwd_ms / timing['dq']['library_ms']:.2f}x)")
    del q, k, v, do, out, lse, delta, kx, vx, qg, kg, vg, sdpa_out
    torch.cuda.empty_cache()
    timing["held"] = held
    return timing


# --------------------------------------------------------------------------- #
# Phase 4: full-width training
# --------------------------------------------------------------------------- #

def step_loss_gnorm(torch, M, adamw, params, cfg, batch, impl):
    """One forward/backward from ``params``: (loss, global grad norm), and
    checks that the kernels ran once a layer exactly when asked for."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models.params import tree_leaves
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    before = FK.flash_attention_fwd.launches, FK.flash_attention_bwd_dq.launches
    loss, _ = M.forward_train(params, cfg, batch, attn_impl=impl)
    grads = torch.autograd.grad(loss, leaves)
    ran = (FK.flash_attention_fwd.launches - before[0],
           FK.flash_attention_bwd_dq.launches - before[1])
    want = cfg.num_layers if impl == "kernel" else 0
    if ran != (want, want):
        fail(f"{impl} step ran the FA-2 kernels {ran} times, not {want}")
    out = (float(loss.detach()), float(adamw.global_norm(list(grads))))
    del grads, loss
    torch.cuda.empty_cache()
    return out


def profile_step(torch, step_fn, params, opt_state, batch, step_ms):
    """Device time by kernel over one profiled train step (the timed steps
    are not profiled); busy share against the unprofiled step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
    rows = [(ev.device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0]
    dev_ms = sum(r[0] for r in rows) / 1e3
    log(f"profiled step: device busy {dev_ms:.3f} ms vs {step_ms:.3f} ms a "
        f"step unprofiled: busy {100 * dev_ms / step_ms:.1f}%, idle "
        f"{100 - 100 * dev_ms / step_ms:.1f}%")
    groups = {}
    for dev_us, key, _ in rows:
        kind = ("FA-2 kernels" if any(w in key for w in FA_KERNEL_NAMES) else
                "GEMMs" if any(w in key for w in ("nvjet", "gemm", "cutlass",
                                                  "sm90_xmma")) else
                "reductions" if "reduce" in key else
                "elementwise and copies")
        groups[kind] = groups.get(kind, 0.0) + dev_us / 1e3
    log("  by kind: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / dev_ms:.1f}%)"
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    for dev_us, key, count in sorted(rows, reverse=True)[:12]:
        log(f"  device {dev_us / 1e3:9.3f} ms x{count:5d}  {key[:90]}")


def phase_train(torch, np, device):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels.adamw import kernel as AK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import TrainerConfig, train

    cfg = get_config("opt-1.3b")
    Bt, St, steps = 4, 2048, 8
    log(f"opt-1.3b full width: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads} heads x {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"padded vocab {cfg.padded_vocab_size}, {cfg.param_count():,} "
        f"params, {cfg.param_dtype} params, fp32 AdamW moments, "
        f"{Bt} x {St} tokens a step")
    kernels = (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
               FK.flash_attention_bwd_dkdv)
    optimizer = (AK.square_sums, AK.adamw_update)
    torch.cuda.reset_peak_memory_stats()
    for f in kernels + optimizer:
        f.launches = 0
    res = train(cfg, TrainerConfig(steps=steps, batch=Bt, seq_len=St,
                                   attn_impl="kernel", seed=0),
                device=device)
    launches = {f.__name__: f.launches for f in kernels + optimizer}
    peak = torch.cuda.max_memory_allocated()
    step_s = 1.0 / res.steady_steps_per_s
    tflops = F.train_flops(cfg, Bt, St, remat=False) / step_s / 1e12
    log(f"train: losses {[round(x, 4) for x in res.losses]}; first step "
        f"{res.compile_time_s:.3f} s; then {res.steady_steps_per_s:.3f} "
        f"steps/s, {1e3 * step_s:.1f} ms a step, "
        f"{res.steady_steps_per_s * Bt * St:.0f} tokens/s; "
        f"peak memory {peak / 1e9:.2f} GB; train_flops/step time "
        f"{tflops:.1f} TFLOP/s = {100 * tflops * 1e12 / BF16_FLOP_PER_S:.1f}"
        f"% of {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s")
    n = cfg.num_layers * steps
    n_opt = len(opt_leaf_sizes()) * steps
    log(f"launches {launches}, expected FA-2 {cfg.num_layers} x {steps} = "
        f"{n} each, AdamW norm and update {len(opt_leaf_sizes())} leaves x "
        f"{steps} = {n_opt} each")
    if len(res.losses) != steps or not all(np.isfinite(res.losses)):
        fail(f"non-finite or missing losses: {res.losses}")
    if any(launches[f.__name__] != n for f in kernels) or any(
            launches[f.__name__] != n_opt for f in optimizer):
        fail(f"launches {launches} are not {n} (FA-2) and {n_opt} (AdamW) "
             "each")
    del res
    torch.cuda.empty_cache()

    # one step, kernels vs chunked, from the same weights and first batch
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             next(make_batch_fn(cfg, Bt, St, seed=0)).items()}
    params = init_params(cfg, device=device, seed=0)
    diffs = {}
    for dt in ("bfloat16", "float32"):
        c = cfg if dt == "bfloat16" else dataclasses.replace(
            cfg, param_dtype="float32", compute_dtype="float32")
        p = params if dt == "bfloat16" else tree_map(lambda t: t.float(),
                                                     params)
        got = {impl: step_loss_gnorm(torch, M, adamw, p, c, batch, impl)
               for impl in ("kernel", "chunked")}
        dl = abs(got["kernel"][0] - got["chunked"][0])
        dg = abs(got["kernel"][1] - got["chunked"][1]) / got["chunked"][1]
        diffs[dt] = (dl, dg)
        log(f"one step, {dt} compute: loss kernel {got['kernel'][0]:.6f} "
            f"chunked {got['chunked'][0]:.6f} (|diff| {dl:.3e}, bound "
            f"{STEP_TOL[dt]['loss']:.0e}); grad norm kernel "
            f"{got['kernel'][1]:.6f} chunked {got['chunked'][1]:.6f} "
            f"(relative diff {dg:.3e}, bound {STEP_TOL[dt]['gnorm']:.0e})")
        del p
        torch.cuda.empty_cache()
    for dt, (dl, dg) in diffs.items():
        if not (dl <= STEP_TOL[dt]["loss"] and dg <= STEP_TOL[dt]["gnorm"]):
            fail(f"kernel and chunked steps differ in {dt}: loss {dl}, "
                 f"grad norm {dg}")

    # one profiled step through the kernels
    opt_cfg = adamw.OptConfig(warmup_steps=10, decay_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg, attn_impl="kernel")
    opt_state = adamw.init_opt_state(params, opt_cfg)
    step_fn(params, opt_state, batch)            # warm
    profile_step(torch, step_fn, params, opt_state, batch, 1e3 * step_s)
    return launches


# --------------------------------------------------------------------------- #
# Phase 5: quant8 kernels vs plain
# --------------------------------------------------------------------------- #

# (N, block): the JAX package's cases (tests/test_kernels.py), a row count
# its 256-row TPU tile does not divide, ragged tails, and opt-1.3b's
# largest leaf (s1_mlp/wi, 24 x 2048 x 8192)
QUANT_CASES = [(65536, 256), (512 * 512, 512), (1 << 16, 128),
               (304 * 256, 256), (100 * 777, 256), (3 * 5 * 7, 256),
               (1000, 128)]
QUANT_SHAPES = [(100, 777), (3, 5, 7)]
LARGEST_LEAF = 24 * 2048 * 8192


def quant_plain(torch, x, block):
    """The plain version of quantize_blocks on the same device: the
    padded tail, then ``quantize_reference``."""
    from repro_torch.kernels.quant8.ref import quantize_reference
    n = x.shape[0]
    pad = -(-n // block) * block - n
    return quantize_reference(torch.nn.functional.pad(x, (0, pad)), block)


def quant_check(torch, x, block, dtype):
    """Kernel vs plain on x: codes, scales and dequantized values must be
    equal; returns the largest difference seen (0 when they are)."""
    from repro_torch.kernels.quant8.kernel import (dequantize_blocks,
                                                   quantize_blocks)
    from repro_torch.kernels.quant8.ref import dequantize_reference
    q, s = quantize_blocks(x, block=block)
    out = dequantize_blocks(q, s, block=block, dtype=dtype)
    torch.cuda.synchronize()
    rq, rs = quant_plain(torch, x, block)
    ro = dequantize_reference(rq, rs, block, dtype)
    err = max(float((q.int() - rq.int()).abs().max()),
              float((s - rs).abs().max()),
              float((out.float() - ro.float()).abs().max()))
    if not (torch.equal(q, rq) and torch.equal(s, rs)
            and torch.equal(out, ro)):
        fail(f"quant8 kernels differ from their plain versions (N="
             f"{x.shape[0]}, block {block}, {x.dtype}): {err}")
    return err


def opt_leaf_sizes():
    """Element counts of opt-1.3b's parameter leaves, as the local-SGD
    round compresses them."""
    import math
    from repro_torch.bridge import flatten
    from repro_torch.configs import get_config
    from repro_torch.models.params import model_spec
    return [math.prod(s.shape)
            for _, s in flatten(model_spec(get_config("opt-1.3b")))]


def dequantize_leaves(torch, device, timer):
    """Dequantize (block 256, fp32 out) summed over opt-1.3b's leaves:
    the median of each leaf's calls with the L2 flushed, as one replica's
    pseudo-gradient pass meets them.  Returns (ms, bytes moved)."""
    from repro_torch.kernels.quant8.kernel import dequantize_blocks
    g = torch.Generator(device=device).manual_seed(6)
    total_ms, total_bytes = 0.0, 0
    for n in opt_leaf_sizes():
        rows = -(-n // 256)
        q = torch.randint(-127, 128, (rows * 256,), dtype=torch.int8,
                          device=device, generator=g)
        s = torch.rand(rows, device=device, generator=g)
        total_ms += timer.ms(lambda: dequantize_blocks(q, s))
        total_bytes += rows * 256 * 5 + rows * 4
    return total_ms, total_bytes


def time_quant8(torch, device, timer, g, n, label, worst):
    """Hold the quant8 kernels at ``n`` fp32 elements (block 256) and time
    kernel, plain version, library call and bound; returns (worst
    difference so far, {"quantize", "dequantize"} timing)."""
    from repro_torch.kernels.quant8.kernel import (dequantize_blocks,
                                                   quantize_blocks)
    from repro_torch.kernels.quant8.ref import dequantize_reference
    block = 256
    rows = n // block
    x = torch.randn(n, generator=g, device=device) * 1e-3
    worst = max(worst, quant_check(torch, x, block, torch.float32))
    q, s = quantize_blocks(x)
    timing = {}
    ms = timer.ms(lambda: quantize_blocks(x))
    spread = timer.spread
    plain_ms = timer.ms(lambda: quant_plain(torch, x, block))
    nbytes = n * 4 + rows * block + rows * 4
    timing["quantize"] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": None,
                          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                          "bound_by": "bytes"}
    log(f"timing quantize at {label} (N={n}, block {block}, fp32): "
        f"kernel_ms {ms:.4f} (min {spread[0]:.4f} max {spread[1]:.4f}) "
        f"plain_ms {plain_ms:.4f} library_ms none (no single PyTorch call "
        f"computes it) bound_ms {timing['quantize']['bound_ms']:.4f} "
        f"({nbytes / 1e9:.3f} GB, bound by bytes); "
        f"{nbytes / ms / 1e6:.0f} GB/s achieved")
    ms = timer.ms(lambda: dequantize_blocks(q, s))
    spread = timer.spread
    plain_ms = timer.ms(lambda: dequantize_reference(q, s))
    library_ms = timer.ms(lambda: torch.mul(q.view(rows, block), s[:, None]))
    nbytes = rows * block + rows * 4 + rows * block * 4
    timing["dequantize"] = {"ms": ms, "plain_ms": plain_ms,
                            "library_ms": library_ms,
                            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                            "bound_by": "bytes"}
    out = torch.empty(n, device=device)
    fill_ms = timer.ms(lambda: out.fill_(1.0))
    del out
    log(f"dequantize at {label}: {nbytes / ms / 1e6:.0f} GB/s "
        f"(kernel), {nbytes / library_ms / 1e6:.0f} GB/s (torch.mul); "
        f"yardstick, not the bound: fill_ of the same {n * 4 / 1e9:.3f} GB "
        f"fp32 output {fill_ms:.4f} ms, {n * 4 / fill_ms / 1e6:.0f} GB/s "
        f"written")
    log(f"timing dequantize at {label}: kernel_ms {ms:.4f} (min "
        f"{spread[0]:.4f} max {spread[1]:.4f}) plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} (torch.mul(q.view(rows, block), "
        f"s[:, None])) bound_ms {timing['dequantize']['bound_ms']:.4f} "
        f"({nbytes / 1e9:.3f} GB, bound by bytes)")
    del q, s, x
    return worst, timing


def phase_quant8(torch, device, timer):
    from repro_torch.kernels.quant8 import ops
    from repro_torch.kernels.quant8.ref import dequantize_reference
    g = torch.Generator(device=device).manual_seed(5)
    worst = 0.0
    for n, block in QUANT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(n, generator=g, device=device) * 3).to(dtype)
            x[:min(n, block)] = 0                   # an all-zero block
            worst = max(worst, quant_check(torch, x, block, dtype))
        log(f"quant8 N={n} block {block} fp32 and bf16: codes, scales and "
            f"values equal to the plain version")
    for shape in QUANT_SHAPES:
        x = torch.randn(shape, generator=g, device=device) * 2
        q, s, sh = ops.quantize(x)
        rq, rs = quant_plain(torch, x.reshape(-1), 256)
        out = ops.dequantize(q, s, sh)
        ref = dequantize_reference(rq, rs)[:x.numel()].reshape(shape)
        if not (torch.equal(q, rq) and torch.equal(s, rs)
                and torch.equal(out, ref)):
            fail(f"quantize/dequantize of {shape} differ from the plain "
                 "version")
        log(f"quant8 any-shape {shape}: equal to the plain version")

    # opt-1.3b's largest leaf, fp32 as the pseudo-gradient path gives it,
    # and a 2 x 2 mesh rank's block of it (phase 24 (b))
    worst, timing = time_quant8(torch, device, timer, g, LARGEST_LEAF,
                                "the largest leaf", worst)
    worst, timing["rank_block"] = time_quant8(
        torch, device, timer, g, LARGEST_LEAF // 4,
        "a 2 x 2 mesh rank's block of the largest leaf", worst)
    leaves_ms, leaves_bytes = dequantize_leaves(torch, device, timer)
    log(f"dequantize over opt-1.3b's {len(opt_leaf_sizes())} leaves (what one "
        f"replica spends a round): {leaves_ms:.4f} ms, "
        f"{leaves_bytes / 1e9:.3f} GB, {leaves_bytes / leaves_ms / 1e6:.0f} "
        f"GB/s; bound {leaves_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    log(f"quant8 kernels held against their plain versions: worst "
        f"difference {worst:.3e}")
    return worst, timing


# --------------------------------------------------------------------------- #
# Phase 25: the AdamW kernels
# --------------------------------------------------------------------------- #

ADAMW_SHAPES = [(1_000_003,), (333, 77), (2, 3, 129)]
# (label, parameters, gradient dtype): opt-1.3b's fc1 leaf as local SGD's
# inner steps update it, granite-3-2b's largest leaf after the fp32 sum of
# its microbatches
ADAMW_LEAVES = [("opt-1.3b fc1", 24 * 2048 * 8192, "bfloat16"),
                ("granite-3-2b wg", 40 * 2048 * 8192, "float32")]


def ulps(torch, a, b):
    """The largest distance between a and b in units in the last place
    of their dtype (fp32 or bf16)."""
    ints = torch.int32 if a.dtype == torch.float32 else torch.int16
    sign = -(1 << (8 * ints.itemsize - 1))

    def ordered(t):
        i = t.contiguous().view(ints).long()
        return torch.where(i < 0, sign - i, i)
    return int((ordered(a) - ordered(b)).abs().max())


def adamw_hyper(torch, device, step=2, clip=0.37):
    t = torch.tensor(step, device=device)
    return dict(lr=torch.tensor(3e-3, device=device),
                clip=torch.tensor(clip, device=device),
                bc1=1.0 - torch.pow(0.9, t.float()),
                bc2=1.0 - torch.pow(0.95, t.float()), b1=0.9, b2=0.95,
                eps=1e-8, weight_decay=0.1)


def adamw_check(torch, device):
    """The update kernel against the plain loop over the dtype grid, 3
    steps a leaf, and the norm kernel against the plain sum; returns
    (worst ulps, unequal elements, elements compared, worst relative
    norm difference)."""
    from repro_torch.kernels.adamw import kernel as AK
    from repro_torch.kernels.adamw import ref as AR
    g = torch.Generator(device=device).manual_seed(25)
    dts = (torch.float32, torch.bfloat16)
    worst, unequal, seen = 0, 0, 0
    for pd in dts:
        for gd in dts:
            for md in dts:
                for shape in ADAMW_SHAPES:
                    p = torch.randn(shape, generator=g, device=device).to(pd)
                    mu = torch.zeros(shape, device=device, dtype=md)
                    nu = torch.zeros(shape, device=device, dtype=md)
                    want = [t.clone() for t in (p, mu, nu)]
                    for step in (1, 2, 3):
                        grad = torch.randn(shape, generator=g,
                                           device=device).to(gd)
                        hyper = adamw_hyper(torch, device, step)
                        decay = len(shape) >= 2
                        AK.adamw_update(p, grad, mu, nu, decay=decay,
                                        **hyper)
                        AR.adamw_update_reference(
                            want[0], grad, want[1], want[2], decay=decay,
                            **hyper)
                    for got, ref in zip((p, mu, nu), want):
                        worst = max(worst, ulps(torch, got, ref))
                        unequal += int((got != ref).sum())
                        seen += got.numel()
    if worst > 1:
        fail(f"the AdamW update kernel is {worst} units in the last place "
             "from the plain loop (at most 1 allowed)")
    xs = [torch.randn(n, generator=g, device=device).to(dt)
          for n in (7, 4099, 1_000_003) for dt in dts]
    got, again = AK.square_sums(xs), AK.square_sums(xs)
    want = torch.stack([AR.square_sum_reference(x) for x in xs])
    rel = float(((got - want).abs() / want).max())
    if not torch.equal(got, again) or rel > 1e-5:
        fail(f"the AdamW norm kernel: relative difference {rel:.3e} from "
             f"the plain sum, or two calls differ")
    return worst, unequal, seen, rel


def time_adamw(torch, device, timer, label, n, g_dtype):
    """Update and norm at one leaf: kernel, plain version and bound."""
    from repro_torch.kernels.adamw import kernel as AK
    from repro_torch.kernels.adamw import ref as AR
    gd = getattr(torch, g_dtype)
    gen = torch.Generator(device=device).manual_seed(26)
    p = torch.randn(n, generator=gen, device=device).bfloat16()
    grad = (torch.randn(n, generator=gen, device=device) * 1e-3).to(gd)
    mu = torch.randn(n, generator=gen, device=device) * 1e-4
    nu = torch.rand(n, generator=gen, device=device) * 1e-8
    hyper = adamw_hyper(torch, device)

    # first held to the plain loop at this size, on clones of the same
    # tensors: the 64-bit offsets, the grid-stride trips of a leaf this
    # long and the norm's fixed NORM_BLOCKS partials
    want = [t.clone() for t in (p, mu, nu)]
    AK.adamw_update(p, grad, mu, nu, decay=True, **hyper)
    AR.adamw_update_reference(want[0], grad, want[1], want[2], decay=True,
                              **hyper)
    chunk = 1 << 26            # ulps() makes int64 copies of what it reads
    worst = max(ulps(torch, a[i:i + chunk], b[i:i + chunk])
                for a, b in zip((p, mu, nu), want)
                for i in range(0, n, chunk))
    unequal = sum(int((a != b).sum()) for a, b in zip((p, mu, nu), want))
    del want
    norm, norm_want = AK.square_sums([grad])[0], AR.square_sum_reference(grad)
    norm_rel = float((norm - norm_want).abs() / norm_want)
    log(f"AdamW at {label}, one step against the plain loop: worst {worst} "
        f"units in the last place, {unequal} of {3 * n} elements unequal; "
        f"norm kernel within {norm_rel:.3e} of the plain sum")
    if worst > 1:
        fail(f"the AdamW update kernel at {label} is {worst} units in the "
             "last place from the plain loop (at most 1 allowed)")
    if not norm_rel <= 1e-5:
        fail(f"the AdamW norm kernel at {label}: relative difference "
             f"{norm_rel:.3e} from the plain sum (at most 1e-5)")

    def update():
        AK.adamw_update(p, grad, mu, nu, decay=True, **hyper)
    ms = timer.ms(update)
    spread = timer.spread
    dev_ms = timer.device_ms(update, ["adamw_update_kernel"])
    plain_ms = timer.ms(lambda: AR.adamw_update_reference(
        p, grad, mu, nu, decay=True, **hyper), iters=5)
    nbytes = n * (2 * 2 + gd.itemsize + 2 * 4 * 2)
    norm_ms = timer.ms(lambda: AK.square_sums([grad]))
    norm_plain_ms = timer.ms(lambda: AR.square_sum_reference(grad), iters=5)
    norm_bytes = n * gd.itemsize
    out = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "max_ulps": worst, "unequal": unequal,
           "norm": {"ms": norm_ms, "plain_ms": norm_plain_ms,
                    "bound_ms": norm_bytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes"}}
    log(f"timing AdamW update at {label} ({n} parameters, bf16 p, "
        f"{g_dtype} g, fp32 moments): kernel_ms {ms:.4f} (min "
        f"{spread[0]:.4f} max {spread[1]:.4f}; device_ms {dev_ms:.4f}) "
        f"plain_ms {plain_ms:.4f} library_ms none (torch._fused_adamw_ "
        f"keeps the moments in the parameter's dtype and does not clip) "
        f"bound_ms {out['bound_ms']:.4f} ({nbytes / 1e9:.3f} GB, "
        f"{nbytes // n} B a parameter, bound by bytes); "
        f"{nbytes / ms / 1e6:.0f} GB/s achieved")
    log(f"timing AdamW norm at {label}: kernel_ms {norm_ms:.4f} plain_ms "
        f"{norm_plain_ms:.4f} bound_ms {out['norm']['bound_ms']:.4f} "
        f"({norm_bytes / 1e9:.3f} GB read); "
        f"{norm_bytes / norm_ms / 1e6:.0f} GB/s achieved")
    return out


def phase_adamw(torch, device, timer):
    worst, unequal, seen, rel = adamw_check(torch, device)
    log(f"AdamW update kernel vs the plain loop over {len(ADAMW_SHAPES)} "
        f"leaves x 8 dtype triples x 3 steps: worst {worst} units in the "
        f"last place, {unequal} of {seen} elements unequal; norm kernel "
        f"within {rel:.3e} of the plain sum, the same bits twice")
    timing = {}
    for label, n, g_dtype in ADAMW_LEAVES:
        timing[label] = time_adamw(torch, device, timer, label, n, g_dtype)
        torch.cuda.empty_cache()
    return worst, unequal, timing


# --------------------------------------------------------------------------- #
# Phase 6: local SGD at full width
# --------------------------------------------------------------------------- #

def edge_topology():
    """examples/diloco_edge.py's fleet: two edge laptops in two regions
    over a 4 MB/s wide-area link."""
    from repro_torch.core.energy.devices import LAPTOP_M2PRO
    from repro_torch.core.net import NetParams, Topology
    return Topology.from_specs([LAPTOP_M2PRO] * 2,
                               regions=["europe", "north_america"],
                               params=NetParams(wan_bw_Bps=4e6))


def replica0_deltas(torch, cfg, tc, ls, opt_cfg, device, mesh=None):
    """Replica 0's round-1 pseudo-gradient, recomputed from the same seed
    (``ls.inner_steps`` steps from ``init_params(tc.seed)`` on its
    stream), leaf by leaf in fp32 on the device; with ``mesh`` (the
    caller has it ambient) every tensor placed as on its ranks."""
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.distributed import sharding
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import _to_device
    glob = init_params(cfg, device=device, seed=tc.seed)
    if mesh is not None:
        glob = sharding.shard_params(glob, cfg, mesh)
    work = tree_map(lambda t: t.clone(), glob)
    step = make_train_step(cfg, opt_cfg, attn_impl="kernel")
    opt = adamw.init_opt_state(work, opt_cfg)
    data = make_batch_fn(cfg, tc.batch, tc.seq_len, tc.seed)
    for _ in range(ls.inner_steps):
        work, opt, _ = step(work, opt, _to_device(next(data), device))
    del opt
    with torch.no_grad():
        for gl, wl in zip(tree_leaves(glob), tree_leaves(work)):
            yield gl.float() - wl.float()


def int8_plain(torch, x, block=256):
    """The plain versions' int8 round trip of ``x`` (any shape): the
    values as sent, and the scales of its blocks."""
    from repro_torch.kernels.quant8.ref import dequantize_reference
    rq, rs = quant_plain(torch, x.reshape(-1), block)
    return (dequantize_reference(rq, rs)[:x.numel()].reshape(x.shape), rs)


def compress_check(torch, cfg, tc, ls, opt_cfg, device):
    """Replica 0's round-1 pseudo-gradient through compress_leaf (the
    kernels) and through the plain versions on the card: sent values and
    new errors must be equal leaf for leaf."""
    from repro_torch.optim.compress import compress_leaf
    worst, n = 0.0, 0
    for d in replica0_deltas(torch, cfg, tc, ls, opt_cfg, device):
        sent, err = compress_leaf(d, None, ls.compress)
        ref, _ = int8_plain(torch, d)
        worst = max(worst, float((sent - ref).abs().max()),
                    float((err - (d - ref)).abs().max()))
        if not (torch.equal(sent, ref) and torch.equal(err, d - ref)):
            fail("compress_grads through the kernels differs from the "
                 "plain version on the real pseudo-gradient")
        n += 1
    log(f"round-1 pseudo-gradient of replica 0 ({n} leaves): int8 sent "
        f"values and new errors through the kernels equal the plain "
        f"version (worst difference {worst:.3e})")
    return worst


# phase 6's DiLoCo run, and phase 24 (b)'s on the 2 x 2 mesh: R replicas x
# K inner steps of batch x seq tokens, rounds, int8 sync with error
# feedback
LOCAL_SGD = dict(R=2, K=2, rounds=2, batch=2, seq=2048)


def local_sgd_configs(seq=None, **ls_kw):
    """Phase 6's (TrainerConfig, LocalSGDConfig, OptConfig), at ``seq``
    tokens a row when given."""
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import CompressConfig
    from repro_torch.train.local_sgd import LocalSGDConfig
    from repro_torch.train.trainer import TrainerConfig
    c = LOCAL_SGD
    tc = TrainerConfig(steps=c["K"] * c["rounds"], batch=c["batch"],
                       seq_len=seq or c["seq"], attn_impl="kernel",
                       log_every=c["K"], seed=0)
    ls = LocalSGDConfig(replicas=c["R"], inner_steps=c["K"], outer_lr=0.7,
                        outer_momentum=0.9,
                        compress=CompressConfig(method="int8"), **ls_kw)
    opt_cfg = adamw.OptConfig(learning_rate=3e-3, warmup_steps=5,
                              decay_steps=tc.steps)
    return tc, ls, opt_cfg


def phase_local_sgd(torch, np, device):
    from repro_torch.configs import get_config
    from repro_torch.kernels.adamw import kernel as AK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.quant8.kernel import (dequantize_blocks,
                                                   quantize_blocks)
    from repro_torch.train.local_sgd import train_local_sgd

    cfg = get_config("opt-1.3b")
    c = LOCAL_SGD
    R, K, rounds, Bt, St = c["R"], c["K"], c["rounds"], c["batch"], c["seq"]
    tc, ls, opt_cfg = local_sgd_configs()
    sizes = opt_leaf_sizes()
    wire = sum(n + 4 * (n // 256 + 1) for n in sizes)
    log(f"local SGD, opt-1.3b full width: {len(sizes)} leaves, "
        f"{sum(sizes):,} params; R={R} replicas x K={K} inner steps of "
        f"{Bt} x {St} tokens, {rounds} rounds; int8 sync with error "
        f"feedback, Nesterov outer step (lr 0.7, momentum 0.9), "
        f"hierarchical allreduce over two regions at 4 MB/s WAN")
    kernels = (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
               FK.flash_attention_bwd_dkdv, quantize_blocks,
               dequantize_blocks)
    optimizer = (AK.square_sums, AK.adamw_update)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels + optimizer:
        f.launches = 0
    t0 = time.perf_counter()
    res = train_local_sgd(cfg, tc, ls, opt_cfg, topology=edge_topology(),
                          sync_algorithm="hierarchical", device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in kernels + optimizer}
    peak = torch.cuda.max_memory_allocated()
    per_round = {k: 1e3 * v / rounds for k, v in res.phase_s.items()}
    round_ms = 1e3 * R * K / res.steps_per_s
    log(f"local SGD: replica-0 losses {[round(x, 4) for x in res.losses]}; "
        f"round losses {[round(x, 4) for x in res.round_losses]}")
    log(f"local SGD: {round_ms:.1f} ms a round on the host clock "
        f"({wall:.1f} s for the whole call, set-up included); device time "
        f"a round: inner steps {per_round.get('inner', 0):.1f} ms, "
        f"pseudo-gradient + int8 compression "
        f"{per_round.get('pseudograd', 0):.1f} ms, outer update "
        f"{per_round.get('outer', 0):.1f} ms; "
        f"{res.steps_per_s * Bt * St:.0f} tokens/s over the rounds; "
        f"modelled "
        f"hierarchical sync {res.comm_time_s_per_round:.3f} s a round "
        f"({res.sync_wire_bytes_per_round:,} wire bytes per replica, "
        f"{res.sync_wan_bytes_per_round / 1e9:.3f} GB over the WAN); "
        f"peak memory {peak / 1e9:.2f} GB")
    n_q = len(sizes) * R * rounds
    n_fa = cfg.num_layers * R * K * rounds
    n_opt = len(sizes) * R * K * rounds
    log(f"launches {launches}; expected quant8 {len(sizes)} x {R} x "
        f"{rounds} = {n_q} each, FA-2 {cfg.num_layers} x {R} x {K} x "
        f"{rounds} = {n_fa} each, AdamW norm and update {len(sizes)} x "
        f"{R} x {K} x {rounds} = {n_opt} each")
    if len(res.losses) != K * rounds or not all(
            np.isfinite(res.losses + res.round_losses)):
        fail(f"non-finite or missing losses: {res.losses} "
             f"{res.round_losses}")
    if any(launches[f.__name__] != n_q for f in kernels[3:]) or any(
            launches[f.__name__] != n_fa for f in kernels[:3]) or any(
            launches[f.__name__] != n_opt for f in optimizer):
        fail(f"launches {launches} are not {n_q} (quant8), {n_fa} "
             f"(FA-2) and {n_opt} (AdamW) each")
    if res.sync_wire_bytes_per_round != wire:
        fail(f"sync wire bytes {res.sync_wire_bytes_per_round} != {wire}")
    ref = dict(losses=res.losses, round_losses=res.round_losses,
               wire=res.sync_wire_bytes_per_round, round_ms=round_ms,
               phase_ms=per_round, peak_gb=peak / 1e9)
    del res
    torch.cuda.empty_cache()
    worst = compress_check(torch, cfg, tc, ls, opt_cfg, device)
    torch.cuda.empty_cache()
    return launches, worst, ref


# --------------------------------------------------------------------------- #
# Phase 7: async = sync, and checkpoint resume, at reduced depth
# --------------------------------------------------------------------------- #

def phase_local_sgd_reduced(torch, np, device):
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim.compress import CompressConfig
    from repro_torch.train.local_sgd import LocalSGDConfig, train_local_sgd
    from repro_torch.train.trainer import TrainerConfig, _to_device

    full = get_config("opt-1.3b")
    cfg = dataclasses.replace(full, name=full.name + "-L2", num_layers=2)
    tc = TrainerConfig(steps=4, batch=2, seq_len=2048, attn_impl="kernel",
                       log_every=0, seed=1)
    ls = LocalSGDConfig(replicas=2, inner_steps=2,
                        compress=CompressConfig(method="int8"))
    sync = train_local_sgd(cfg, tc, ls, device=device)
    asyn = train_local_sgd(cfg, tc, dataclasses.replace(ls, async_mode=True),
                           device=device)
    same_state = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(sync.outer_state), tree_leaves(asyn.outer_state)))
    log(f"opt-1.3b width at 2 layers: sync round losses "
        f"{sync.round_losses}, async (Q=R, S=0) {asyn.round_losses}; "
        f"losses identical {asyn.losses == sync.losses}, final outer "
        f"state identical {same_state}")
    if not (asyn.losses == sync.losses
            and asyn.round_losses == sync.round_losses and same_state):
        fail("async with Q=R, S=0 differs from sync on the card")
    del asyn

    with tempfile.TemporaryDirectory() as d:
        first = train_local_sgd(cfg, tc, dataclasses.replace(
            ls, checkpoint_dir=d, checkpoint_every_rounds=1), device=device)
        saved = first.outer_state
        got = ckpt.restore(d, saved)
        exact = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(got), tree_leaves(saved)))
        m_abs = max(float(x.abs().max()) for x in tree_leaves(
            saved["outer_m"]))
        resumed = train_local_sgd(
            cfg, dataclasses.replace(tc, steps=2),
            dataclasses.replace(ls, checkpoint_dir=d,
                                checkpoint_every_rounds=1, resume=True),
            device=device)
        # the resumed run's first step starts from the restored params
        batch = _to_device(next(make_batch_fn(cfg, tc.batch, tc.seq_len,
                                              tc.seed)), device)
        with torch.no_grad():
            loss0, _ = M.forward_train(saved["params"], cfg, batch,
                                       attn_impl="kernel")
        loss0 = float(loss0)
        latest = ckpt.latest_complete_step(d)
    log(f"checkpoint resume: restored params and outer momentum equal to "
        f"the saved ones bit for bit {exact} (largest |momentum| "
        f"{m_abs:.3e}); resumed from round {resumed.resumed_from_round}, "
        f"newest complete step {latest}; resumed first loss "
        f"{resumed.losses[0]:.6f} vs the saved params' loss {loss0:.6f}")
    if not (exact and m_abs > 0 and resumed.resumed_from_round == 2
            and latest == 3):
        fail("checkpoint round trip or resume failed")
    if abs(resumed.losses[0] - loss0) > 1e-6 * abs(loss0):
        fail(f"the resumed run did not start from the saved params: "
             f"{resumed.losses[0]} vs {loss0}")


# --------------------------------------------------------------------------- #
# Phase 8: SSD-scan kernel vs plain
# --------------------------------------------------------------------------- #

def ssd_tensors(torch, case, dtype, device, seed):
    """x (b,h,s,p), dt (b,h,s), A, B/C (b,g,s,n): transposed views of the
    model-layout tensors, as ops.ssd hands them to the kernel; the JAX
    package's distributions (dt = softplus(normal), A = -exp(normal))."""
    b, s, h, g, p, n, _ = case
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = randn(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, s, h))
    A = -torch.exp(randn(h))
    B, C = randn(b, s, g, n).to(dtype), randn(b, s, g, n).to(dtype)
    return (x.transpose(1, 2), dt.transpose(1, 2), A, B.transpose(1, 2),
            C.transpose(1, 2))


def ssd_work(case, args, y):
    """(FLOPs, bytes) of one scan: core.flops' per-head-chunk count
    2(Q^2 n + Q^2 p + 2 Q p n) over the chunks this s needs, and every
    input read and the output written once."""
    b, s, h, g, p, n, Q = case
    flops = 2 * (Q * Q * n + Q * Q * p + 2 * Q * p * n) * b * h * -(-s // Q)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, y))
    return flops, nbytes


def phase_ssd(torch, device, timer):
    from repro_torch.kernels.ssd_scan.kernel import ssd_bhcq, ssd_bhcq_plain
    worst = 0.0
    for i, case in enumerate(SSD_CASES + MAMBA_SSD + [JAMBA_SSD]):
        dts = ("bfloat16",) if case == MAMBA_SSD[0] else \
            ("float32", "bfloat16")
        for dt in dts:
            args = ssd_tensors(torch, case, getattr(torch, dt), device,
                               seed=20 + i)
            y = ssd_bhcq(*args, chunk=case[-1])
            torch.cuda.synchronize()
            ref = ssd_bhcq_plain(*args, chunk=case[-1])
            if not bool(torch.isfinite(y).all()):
                fail(f"non-finite SSD kernel output {case} {dt}")
            err = float((y.float() - ref.float()).abs().max())
            bound = SSD_TOL[dt] * max(1.0, float(ref.float().abs().max()))
            worst = max(worst, err)
            log(f"SSD case {case} {dt:8s}: max_abs_err {err:.3e} (bound "
                f"{bound:.3e}) {'ok' if err <= bound else 'FAIL'}")
            if err > bound:
                fail(f"ssd_bhcq disagrees with its plain version ({case}, "
                     f"{dt}): {err} > {bound}")
            del args, y, ref
    torch.cuda.empty_cache()

    timing = time_ssd(torch, device, timer, MAMBA_SSD[0], "mamba2-130m")
    timing["jamba"] = time_ssd(torch, device, timer, JAMBA_SSD,
                               "jamba-v0.1-52b")
    log(f"SSD kernel held against its plain version: worst max_abs_err "
        f"{worst:.3e}")
    return worst, timing


def time_ssd(torch, device, timer, case, label):
    """The SSD call (``ms``), its three kernels alone (``device_ms``), its
    plain version and its bound at ``case`` in bf16, as the model calls
    it; fails if a call issues any other device operation."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_bhcq, ssd_bhcq_plain
    args = ssd_tensors(torch, case, torch.bfloat16, device, seed=99)
    y = ssd_bhcq(*args, chunk=case[-1])
    call = lambda: ssd_bhcq(*args, chunk=case[-1])  # noqa: E731
    ms = timer.ms(call)
    spread = timer.spread
    device_ms = timer.device_ms(call, SSD_KERNELS)
    log("the SSD call's kernels (launches seen a call, ms a launch): "
        + "; ".join(f"{k} x{n:g} {t:.4f}" for k, n, t in timer.kernels)
        + f"; other device operations {timer.others}")
    if timer.others:
        fail(f"an ssd_bhcq call issued more than its three kernels: "
             f"{timer.others}")
    plain_ms = timer.ms(lambda: ssd_bhcq_plain(*args, chunk=case[-1]))
    flops, nbytes = ssd_work(case, args, y)
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    timing = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
              "library_ms": None, "bound_ms": max(t_ops, t_bytes),
              "bound_by": "operations" if t_ops > t_bytes else "bytes"}
    log(f"timing SSD scan at {label}'s shape {case} bf16: kernel_ms "
        f"{ms:.4f} (min {spread[0]:.4f} max {spread[1]:.4f}; the whole "
        f"call) device_ms {device_ms:.4f} (its kernels alone, profiler) "
        f"plain_ms "
        f"{plain_ms:.4f} library_ms none (no single PyTorch call computes "
        f"the scan) bound_ms {timing['bound_ms']:.4f} ({flops:.4e} FLOP = "
        f"{t_ops:.4f} ms at {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s, "
        f"{nbytes:,} B = {t_bytes:.4f} ms; bound by {timing['bound_by']}; "
        f"{flops / FP32_FLOP_PER_S * 1e3:.3f} ms at the "
        f"{FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s of fp32 CUDA cores); "
        f"{flops / device_ms / 1e9:.2f} TFLOP/s over the kernels' time")
    del args, y
    torch.cuda.empty_cache()
    return timing


# --------------------------------------------------------------------------- #
# Phase 9: serving mamba2-130m at full width
# --------------------------------------------------------------------------- #

def profile_fn(torch, fn, wall_ms, steps, kernel_key, unit="step"):
    """Device time of one profiled call of ``fn`` (``steps`` model steps):
    busy share against the unprofiled wall time a step, and the share of
    the kernel whose name contains ``kernel_key``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(ev.device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.device_time_total > 0]
    dev_ms = sum(r[0] for r in rows) / 1e3 / steps
    kern_ms = sum(r[0] for r in rows if kernel_key in r[1]) / 1e3 / steps
    log(f"  profiled: device busy {dev_ms:.3f} ms a {unit} vs {wall_ms:.3f} "
        f"ms a {unit} unprofiled: busy {100 * dev_ms / wall_ms:.1f}%, idle "
        f"{100 - 100 * dev_ms / wall_ms:.1f}%; {kernel_key} "
        f"{kern_ms:.3f} ms ({100 * kern_ms / max(dev_ms, 1e-9):.1f}% of "
        f"device time)")
    groups = {}
    for dev_us, key, _ in rows:
        kind = (kernel_key if kernel_key in key else
                "GEMMs" if any(w in key for w in ("nvjet", "gemm", "cutlass",
                                                  "sm90_xmma")) else
                "reductions" if "reduce" in key else
                "elementwise and copies")
        groups[kind] = groups.get(kind, 0.0) + dev_us / 1e3 / steps
    log("    by kind: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / max(dev_ms, 1e-9):.1f}%)"
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    for dev_us, key, count in sorted(rows, reverse=True)[:8]:
        log(f"    device {dev_us / 1e3 / steps:8.3f} ms/{unit} x{count:6d}  "
            f"{key[:90]}")


def wall_ms(torch, fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    times.sort()
    return times[len(times) // 2], times


def phase_mamba(torch, np, device):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.kernels.ssd_scan.kernel import ssd_bhcq
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serve.step import greedy_generate, make_prefill

    cfg = get_config("mamba2-130m")
    Bp, Sp = MAMBA_PREFILL
    params = init_params(cfg, device=device, seed=0)
    log(f"mamba2-130m full width: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"d_inner {cfg.ssm.d_inner(cfg.d_model)}, "
        f"{cfg.ssm.num_heads(cfg.d_model)} SSD heads x {cfg.ssm.head_dim}, "
        f"state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk_size}, padded "
        f"vocab {cfg.padded_vocab_size}, {cfg.param_count():,} params, "
        f"{cfg.param_dtype}")
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, (Bp, Sp))
                              ).to(device)
    batch = {"tokens": tokens}

    # (a) prefill / scoring through the kernel
    prefill = make_prefill(cfg)
    prefill(params, batch)                                 # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_bhcq.launches = 0
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    launches = ssd_bhcq.launches
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (Bp, Sp, cfg.padded_vocab_size) or not bool(
            torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        fail(f"prefill logits malformed: {tuple(logits.shape)}")
    if launches != cfg.num_layers:
        fail(f"a prefill forward launched the SSD kernel {launches} times, "
             f"not {cfg.num_layers}")
    ms, times = wall_ms(torch, lambda: prefill(params, batch), 5)
    tflops = F.fwd_flops(cfg, Bp, Sp) / (ms / 1e3) / 1e12
    log(f"prefill {Bp} x {Sp} tokens, bf16, through the kernel: "
        f"{launches} SSD launches; {ms:.2f} ms a forward (median of 5: "
        f"{', '.join(f'{x:.2f}' for x in times)}), "
        f"{Bp * Sp / (ms / 1e3):,.0f} tokens/s; fwd_flops "
        f"{F.fwd_flops(cfg, Bp, Sp):.4e} / time = {tflops:.1f} TFLOP/s = "
        f"{100 * tflops * 1e12 / BF16_FLOP_PER_S:.2f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    profile_fn(torch, lambda: prefill(params, batch), ms, 1, "ssd_",
               unit="forward")

    live = slice(0, cfg.vocab_size)
    with torch.inference_mode():
        ref = M.forward_logits(params, cfg, batch, use_kernel=False)
    diff16 = float((logits[..., live].float()
                    - ref[..., live].float()).abs().max())
    peak16 = float(ref[..., live].float().abs().max())
    top = {"kernel": logits[..., live].argmax(-1),
           "reference": ref[..., live].argmax(-1)}
    del logits, ref
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    k32 = make_prefill(cfg32)(p32, batch)
    with torch.inference_mode():
        r32 = M.forward_logits(p32, cfg32, batch, use_kernel=False)
    diff32 = float((k32[..., live] - r32[..., live]).abs().max())
    peak32 = float(r32[..., live].abs().max())
    top32 = r32[..., live].argmax(-1)
    del k32, r32
    torch.cuda.empty_cache()
    agree = {k: float((v == top32).float().mean()) for k, v in top.items()}
    both = float((top["kernel"] == top["reference"]).float().mean())
    log(f"prefill kernel vs ssd_reference on the same weights: fp32 "
        f"max_abs_diff {diff32:.3e} (largest |logit| {peak32:.3f}, bound "
        f"{PREFILL_TOL['float32']:.0e} of it = "
        f"{PREFILL_TOL['float32'] * peak32:.3e}); bf16 max_abs_diff "
        f"{diff16:.3e} (largest |logit| {peak16:.3f}); bf16 argmax: kernel "
        f"path = reference path at {100 * both:.3f}% of {Bp * Sp} "
        f"positions; = the fp32 reference's token at "
        f"{100 * agree['kernel']:.3f}% (kernel path) and "
        f"{100 * agree['reference']:.3f}% (reference path; bound: kernel "
        f">= reference - {100 * PREFILL_TOL['argmax_slack']:.0f}%)")
    if diff32 > PREFILL_TOL["float32"] * peak32:
        fail(f"fp32 kernel and reference prefill differ by {diff32}")
    if agree["kernel"] < agree["reference"] - PREFILL_TOL["argmax_slack"]:
        fail(f"bf16 kernel path picks the fp32 token at {agree['kernel']}, "
             f"the reference path at {agree['reference']}")

    # (b) dense decode: 8 prompts of 64 tokens + 32 new ones
    Bd, Sd, new = MAMBA_DECODE
    prompt = torch.from_numpy(rs.randint(0, cfg.vocab_size, (Bd, Sd))
                              ).to(device)
    greedy_generate(params, cfg, prompt, 2, cache_len=Sd + new)   # warm
    out = None

    def gen():
        nonlocal out
        out = greedy_generate(params, cfg, prompt, new)
    gen_ms, _ = wall_ms(torch, gen, 1)
    steps = Sd + new - 1
    if tuple(out.shape) != (Bd, Sd + new) or int(out.max()) >= \
            cfg.vocab_size or not torch.equal(out[:, :Sd], prompt):
        fail(f"greedy_generate output malformed: {tuple(out.shape)}, "
             f"max id {int(out.max())}")
    log(f"greedy_generate {Bd} x ({Sd} prompt + {new} new) tokens, bf16, "
        f"dense cache: {gen_ms:.1f} ms, {steps} decode steps, "
        f"{gen_ms / steps:.3f} ms a step, {Bd * new / (gen_ms / 1e3):.1f} "
        f"new tokens/s ({Bd * (Sd + new - 1) / (gen_ms / 1e3):.1f} tokens "
        f"through the step a second); every id < {cfg.vocab_size}")
    # the profile reads a shorter run of the same steps (16 prompt tokens
    # and 8 new), as phase 14's does: the profiler's bookkeeping grows
    # with the operations, and 95 steps of ~1,000 launches each kept the
    # phase over 100 s
    short = prompt[:, :16]
    profile_fn(torch, lambda: greedy_generate(params, cfg, short, 8),
               gen_ms / steps, 16 + 8 - 1, "ssd_")

    # (c) decode_step token by token == the kernel prefill, fp32 weights
    Bc, Sc = MAMBA_AGREE
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (Bc, Sc))
                            ).to(device)
    with torch.inference_mode():
        full = M.forward_logits(p32, cfg32, {"tokens": toks})
        cache = M.init_cache(cfg32, Bc, Sc, dtype=torch.float32,
                             device=device)
        outs = []
        for i in range(Sc):
            lg, cache = M.decode_step(p32, cfg32, cache, toks[:, i:i + 1], i)
            outs.append(lg)
        dec = torch.stack(outs, dim=1)
    full, dec = full[..., live], dec[..., live]
    scale = max(1.0, float(full.abs().max()))
    excess = float(((dec - full).abs() - 2e-3 * full.abs()).max())
    log(f"decode_step x {Sc} vs the kernel prefill ({Bc} x {Sc} tokens, "
        f"fp32, chunks of {cfg.ssm.chunk_size}: two full and a ragged "
        f"one): max_abs_diff {float((dec - full).abs().max()):.3e}; "
        f"largest |diff| - 2e-3 |logit| = {excess:.3e} (bound atol 2e-4 x "
        f"largest |logit| {scale:.3f} = {2e-4 * scale:.3e})")
    if excess > 2e-4 * scale:
        fail("dense decode and the kernel prefill disagree")
    del p32, params
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# Phase 10: serving mixtral-8x7b at full width, 4 layers
# --------------------------------------------------------------------------- #

# the MoE layer's functions whose device time the profiled run reads, by
# the range each is wrapped in while it runs: the dispatch and combine
# (sort, scatters, gathers; they call the expert FFNs, whose time is
# taken out) and the expert FFNs (three bmm and SiLU times the gate)
MOE_RANGES = {"_dispatch_combine": "moe_dispatch_combine",
              "_expert_ffn": "moe_expert_ffn"}


def profile_moe_run(torch, eng, reqs, step_ms):
    """Device time a step by kind over a profiled engine run of ``reqs``:
    MoE dispatch (its functions' ranges less the expert FFNs'), the
    expert FFNs, flash-decode (its kernels by name) and everything else;
    the busy share against the unprofiled run's wall time a step.  The
    ranges are ``record_function`` wrappers put around the MoE module's
    functions for this run only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import moe
    orig = {name: getattr(moe, name) for name in MOE_RANGES}

    def ranged(fn, label):
        def call(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return call
    try:
        for name, label in MOE_RANGES.items():
            setattr(moe, name, ranged(orig[name], label))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run(reqs)
    finally:
        for name, fn in orig.items():
            setattr(moe, name, fn)
    steps = max(eng.steps, 1)
    avg = prof.key_averages()
    labels = set(MOE_RANGES.values())
    kernels = [ev for ev in avg if ev.device_type == DeviceType.CUDA
               and ev.device_time_total > 0 and ev.key not in labels]
    ranges = {ev.key: ev.device_time_total for ev in avg
              if ev.device_type == DeviceType.CPU and ev.key in labels}
    busy = sum(ev.device_time_total for ev in kernels) / 1e3 / steps
    kinds = {
        "flash-decode": sum(ev.device_time_total for ev in kernels
                            if any(k in ev.key for k in DECODE_KERNELS)),
        "expert FFNs (3 bmm, SiLU x gate)": ranges.get("moe_expert_ffn", 0),
        "MoE dispatch and combine (sort, scatters, gathers)":
            ranges.get("moe_dispatch_combine", 0)
            - ranges.get("moe_expert_ffn", 0),
    }
    kinds = {k: v / 1e3 / steps for k, v in kinds.items()}
    kinds["other (attention projections, router, norms, head)"] = \
        busy - sum(kinds.values())
    log(f"profiled run: {eng.steps} steps, device busy {busy:.3f} ms a "
        f"step vs {step_ms:.3f} ms a step unprofiled: busy "
        f"{100 * busy / step_ms:.1f}%, idle {100 - 100 * busy / step_ms:.1f}%")
    log("  by kind (ms a step): " + ", ".join(
        f"{k} {v:.3f} ({100 * v / max(busy, 1e-9):.1f}%)"
        for k, v in kinds.items()))
    for ev in sorted(kernels, key=lambda e: -e.device_time_total)[:8]:
        log(f"  device {ev.device_time_total / 1e3 / steps:8.3f} ms/step "
            f"x{ev.count:6d}  {ev.key[:90]}")


def layer0_attention_check(torch, M, params, cfg, tokens):
    """Layer 0's attention at the prefill's own q/k/v (rotary applied, the
    window cutting in): the FA-2 forward over every head against
    ``attention_fwd_plain`` over the first ``MIXTRAL_GROUPS`` KV groups,
    at phase 3's bf16 bars.  Returns (out error, its bound, lse error,
    its bound)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models.layers import _project_qkv, norm, positional
    from repro_torch.models.params import tree_map
    p0 = tree_map(lambda a: a[0], params["decoder"]["g0"]["s0_attn"])
    S = tokens.shape[1]
    with torch.inference_mode():
        x = M.embed_tokens(params, cfg, tokens)
        q, k, v = _project_qkv(p0, norm(p0["norm"], x, cfg), cfg)
        pos = torch.arange(S, device=x.device)[None]
        q, k = positional(q, pos, cfg), positional(k, pos, cfg)
        # (B, S, H, D) -> (B, H, S, D) views, the layout the model passes
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        kw = dict(causal=True, window=cfg.sliding_window)
        out, lse = FK.flash_attention_fwd(q, k, v, **kw)
        g = MIXTRAL_GROUPS
        hq = g * cfg.num_heads // cfg.num_kv_heads
        ref, ref_lse = FK.attention_fwd_plain(q[:, :hq], k[:, :g], v[:, :g],
                                              **kw)
        torch.cuda.synchronize()
    tol = FA_TOL["bfloat16"]
    err = float((out[:, :hq].float() - ref.float()).abs().max())
    bound = tol["out"] * max(1.0, float(ref.float().abs().max()))
    lse_err = float((lse[:, :hq] - ref_lse).abs().max())
    lse_bound = tol["lse"] * max(1.0, float(ref_lse.abs().max()))
    if not bool(torch.isfinite(out).all()):
        fail("non-finite FA-2 output at layer 0 of the mixtral prefill")
    return err, bound, lse_err, lse_bound


def phase_mixtral(torch, np, device):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params

    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, num_layers=MIXTRAL_LAYERS)
    m = cfg.moe
    t0 = t_phase = time.perf_counter()
    params = init_params(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"mixtral-8x7b full width, {cfg.num_layers} of {full.num_layers} "
        f"layers (full depth: {full.param_count():,} params, "
        f"{2 * full.param_count() / 1e9:.1f} GB of bf16, past the card's "
        f"80 GB): d {cfg.d_model}, {cfg.num_heads} heads x "
        f"{cfg.resolved_head_dim} (GQA kv {cfg.num_kv_heads}), "
        f"{m.num_experts} experts top-{m.experts_per_token} x d_ff "
        f"{m.d_ff_expert}, window {cfg.sliding_window}, vocab "
        f"{cfg.vocab_size}; {cfg.param_count():,} params "
        f"({cfg.active_param_count():,} active a token), {nbytes/1e9:.2f} "
        f"GB bf16, init {time.perf_counter() - t0:.2f} s")

    # (a) the engine on phase 2's requests
    t0 = time.perf_counter()
    eng, reqs = primed_engine(params, cfg, device, np)
    log(f"warmup + prefix priming {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _, s, launches, _ = serve_checked(eng, reqs, cfg, "mixtral")
    peak = torch.cuda.max_memory_allocated()
    step_ms = eng.wall_s / eng.steps * 1e3
    log(f"engine run: {int(s['tokens_generated'])} tokens, "
        f"{int(s['steps'])} steps, {eng.wall_s:.3f} s, {step_ms:.3f} ms a "
        f"step, {s['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{s.get('ttft_p50_s', float('nan')) * 1e3:.1f} ms, prefix hit "
        f"tokens {int(s['prefix_hit_tokens'])}, peak memory "
        f"{peak / 1e9:.2f} GB")
    del eng
    parts = {"init and engine run": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    eng, reqs = primed_engine(params, cfg, device, np)
    profile_moe_run(torch, eng, reqs, step_ms)
    del eng
    torch.cuda.empty_cache()
    parts["profiled run"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (b) one mixed step, kernel vs gather
    diffs, peak_logit, feeds = mixed_step_diff(torch, np, M, params, cfg,
                                               device)
    log(f"mixed step (feeds {feeds}) kernel vs gather logits max_abs_diff: "
        f"fp32 compute over the same bf16 pages {diffs['float32']:.3e} "
        f"(bound {LOGITS_TOL:.0e}); bf16 compute {diffs['bfloat16']:.3e} "
        f"(largest |logit| {peak_logit:.2f}; not gated: a one-ulp change "
        f"of a bf16 attention output can flip a token's top-2 experts in "
        f"a later layer)")
    if not diffs["float32"] <= LOGITS_TOL:
        fail(f"mixtral: kernel and gather logits differ by "
             f"{diffs['float32']} in fp32 compute")

    parts["mixed step"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (c) prefill of 1 x 8192 tokens through the FA-2 forward
    S = MIXTRAL_PREFILL
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, S))).to(device)

    def prefill():
        with torch.inference_mode():
            return M.forward_logits(params, cfg, {"tokens": tokens},
                                    attn_impl="kernel")
    prefill()                                           # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FK.flash_attention_fwd.launches = 0
    logits = prefill()
    torch.cuda.synchronize()
    fa_launches = FK.flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (1, S, cfg.padded_vocab_size) or not bool(
            torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        fail(f"mixtral prefill logits malformed: {tuple(logits.shape)}")
    if fa_launches != cfg.num_layers:
        fail(f"a mixtral prefill forward launched the FA-2 forward "
             f"{fa_launches} times, not {cfg.num_layers}")
    del logits
    ms, times = wall_ms(torch, prefill, 5)
    flops = F.fwd_flops(cfg, 1, S)
    tflops = flops / (ms / 1e3) / 1e12
    log(f"prefill 1 x {S} tokens, bf16, FA-2 forward x {fa_launches}: "
        f"{ms:.2f} ms a forward (median of 5; min {times[0]:.2f}; "
        f"{', '.join(f'{x:.2f}' for x in times)}), "
        f"{S / (ms / 1e3):,.0f} tokens/s (max {S / (times[0] / 1e3):,.0f}); "
        f"fwd_flops {flops:.4e} / time = {tflops:.1f} TFLOP/s = "
        f"{100 * tflops * 1e12 / BF16_FLOP_PER_S:.2f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    parts["prefill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    err, bound, lse_err, lse_bound = layer0_attention_check(
        torch, M, params, cfg, tokens)
    parts["layer 0 check"] = time.perf_counter() - t0
    log(f"layer 0 attention at the prefill's q/k/v (B 1, S {S}, H "
        f"{cfg.num_heads}, K {cfg.num_kv_heads}, D "
        f"{cfg.resolved_head_dim}, window {cfg.sliding_window}; KV groups "
        f"0-{MIXTRAL_GROUPS - 1} against attention_fwd_plain): out "
        f"max_abs_err {err:.3e} (bound {bound:.3e}), lse {lse_err:.3e} "
        f"(bound {lse_bound:.3e})")
    if err > bound or lse_err > lse_bound:
        fail(f"mixtral layer 0: FA-2 forward disagrees with its plain "
             f"version: out {err} > {bound} or lse {lse_err} > {lse_bound}")
    log(f"mixtral launches: flash_decode_paged {launches} in the engine "
        f"run, flash_attention_fwd {fa_launches} a prefill forward")
    log("phase 10 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    del params
    torch.cuda.empty_cache()
    return launches, fa_launches



# --------------------------------------------------------------------------- #
# Phase 11: training mixtral-8x7b at full width, 2 layers
# --------------------------------------------------------------------------- #

# the operators whose own device time (their kernels, not their
# children's) a profiled train step reads by kind: the expert products
# are the model's only bmm (forward and backward); the dense projections,
# router and head run as mm/addmm; the MoE dispatch and combine are the
# gathers, scatters, sorts and counts (the embedding lookup and the
# cross-entropy gather are among them, a small share)
TRAIN_OP_KINDS = {
    "expert bmm": ("aten::bmm",),
    "dense GEMMs (projections, router, head)": ("aten::mm", "aten::addmm"),
    "MoE dispatch and combine (gathers, scatters, sorts)": (
        "aten::index", "aten::index_put_", "aten::_index_put_impl_",
        "aten::index_add_", "aten::index_select", "aten::gather",
        "aten::scatter_add_", "aten::scatter", "aten::sort",
        "aten::argsort", "aten::cumsum", "aten::one_hot",
        "aten::embedding_dense_backward"),
}


def profile_train_step(torch, fn, step_ms):
    """Device time by kind over one profiled call of ``fn`` (a train
    step): the FA-2 kernels by name, the kinds of ``TRAIN_OP_KINDS`` by
    the operators that launched them, and the rest (elementwise passes,
    copies, reductions, AdamW); busy and idle shares against the
    unprofiled step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    kernels = [ev for ev in avg if ev.device_type == DeviceType.CUDA
               and ev.device_time_total > 0]
    busy = sum(ev.device_time_total for ev in kernels) / 1e3
    kinds = {"FA-2 kernels": sum(
        ev.device_time_total for ev in kernels
        if any(n in ev.key for n in FA_KERNEL_NAMES)) / 1e3}
    for kind, ops in TRAIN_OP_KINDS.items():
        kinds[kind] = sum(ev.self_device_time_total for ev in avg
                          if ev.device_type == DeviceType.CPU
                          and ev.key in ops) / 1e3
    kinds["elementwise, copies, reductions and the rest"] = \
        busy - sum(kinds.values())
    log(f"  profiled step: device busy {busy:.3f} ms vs {step_ms:.3f} ms a "
        f"step unprofiled: busy {100 * busy / step_ms:.1f}%, idle "
        f"{100 - 100 * busy / step_ms:.1f}%")
    log("  by kind: " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / max(busy, 1e-9):.1f}%)"
        for k, v in kinds.items()))
    for ev in sorted(kernels, key=lambda e: -e.device_time_total)[:10]:
        log(f"  device {ev.device_time_total / 1e3:9.3f} ms x{ev.count:5d}  "
            f"{ev.key[:90]}")
    return busy, kinds


def grads_of(torch, M, params, cfg, batch, impl):
    """(loss, [gradient of each leaf]) of one forward/backward."""
    from repro_torch.models.params import tree_leaves
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = M.forward_train(params, cfg, batch, attn_impl=impl)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), list(grads)


def fp32_gradient_gate(torch, p32, cfg32, batch, per_step, label):
    """At fp32 compute, the kernel path's gradients against the plain
    chunked path's, leaf by leaf, at phase 3's gradient bar (1e-4 x
    max(1, the largest |grad|)); fails if one is outside it or the kernel
    path did not launch each FA-2 kernel ``per_step`` times."""
    from repro_torch.bridge import flatten
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import model as M
    kernels = (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
               FK.flash_attention_bwd_dkdv)
    before = [f.launches for f in kernels]
    lk, gk = grads_of(torch, M, p32, cfg32, batch, "kernel")
    ran = [f.launches - b for f, b in zip(kernels, before)]
    lc, gc = grads_of(torch, M, p32, cfg32, batch, "chunked")
    if ran != [per_step] * 3:
        fail(f"{label} fp32 gate: the kernel path launched the FA-2 "
             f"kernels {ran} times, not {per_step} each")
    keys = [k for k, _ in flatten(p32)]
    tol = FA_TOL["float32"]["grad"]
    errs = {}
    for key, a, b in zip(keys, gk, gc):
        err = float((a - b).abs().max())
        bound = tol * max(1.0, float(b.abs().max()))
        errs[key] = err
        if not err <= bound:
            fail(f"{label} fp32 gate: the kernel path's gradient of {key} "
                 f"differs from the chunked path's by {err} > {bound}")
    tokens = " x ".join(str(n) for n in batch["tokens"].shape)
    log(f"fp32 gradients, kernel vs chunked attention ({len(keys)} leaves, "
        f"{tokens} tokens): loss {lk:.6f} vs {lc:.6f}; max_abs_err by leaf "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (bound {tol:.0e} x max(1, largest |grad|) per leaf); every "
        f"leaf inside its bound")


def phase_mixtral_train(torch, np, device):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import TrainerConfig, train

    full = get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, num_layers=MIXTRAL_TRAIN_LAYERS)
    Bt, St = MIXTRAL_TRAIN
    steps = MIXTRAL_TRAIN_STEPS
    m = cfg.moe
    log(f"mixtral-8x7b training at full width, {cfg.num_layers} of "
        f"{full.num_layers} layers: d {cfg.d_model}, {cfg.num_heads} heads x "
        f"{cfg.resolved_head_dim} (GQA kv {cfg.num_kv_heads}), "
        f"{m.num_experts} experts top-{m.experts_per_token} x d_ff "
        f"{m.d_ff_expert}, window {cfg.sliding_window}, vocab "
        f"{cfg.vocab_size}; {cfg.param_count():,} params "
        f"({cfg.active_param_count():,} active a token), bf16 weights, fp32 "
        f"AdamW moments, {Bt} x {St} tokens a step, remat none")
    parts = {}
    t0 = time.perf_counter()
    kernels = (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
               FK.flash_attention_bwd_dkdv)
    # AdamW's first steps move every weight by about the learning rate
    # (their size is the sign of the gradient), so each d-wide product
    # moves with lr x d: 3e-4 at d 4096 overshot (the loss went 10.60 ->
    # 16.89 after the first step on the card).  2e-5 at d 4096 moves the
    # products as 3e-4 does at d 256, where the smoke config's loss falls
    opt_cfg = adamw.OptConfig(learning_rate=2e-5, warmup_steps=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels:
        f.launches = 0
    res = train(cfg, TrainerConfig(steps=steps, batch=Bt, seq_len=St,
                                   attn_impl="kernel", log_every=1, seed=0),
                opt_cfg, device=device)
    launches = {f.__name__: f.launches for f in kernels}
    peak = torch.cuda.max_memory_allocated()
    step_s = 1.0 / res.steady_steps_per_s
    flops = F.train_flops(cfg, Bt, St, remat=False)
    tflops = flops / step_s / 1e12
    log(f"mixtral train: losses {[round(x, 4) for x in res.losses]}; first "
        f"step {res.compile_time_s:.3f} s; then {1e3 * step_s:.1f} ms a step, "
        f"{Bt * St / step_s:.0f} tokens/s; train_flops {flops:.4e} (top-"
        f"{m.experts_per_token} of the experts) / step time = {tflops:.1f} "
        f"TFLOP/s = {100 * tflops * 1e12 / BF16_FLOP_PER_S:.1f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    n = cfg.num_layers * steps
    log(f"mixtral train FA-2 launches {launches}, expected {cfg.num_layers} "
        f"a step x {steps} steps = {n} each")
    if len(res.losses) != steps or not all(np.isfinite(res.losses)):
        fail(f"mixtral train: non-finite or missing losses {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        fail(f"mixtral train: the loss did not fall over {steps} steps: "
             f"{res.losses}")
    if any(v != n for v in launches.values()):
        fail(f"mixtral train: FA-2 kernel launches {launches} != {n} each")
    del res
    torch.cuda.empty_cache()
    parts["trainer"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # one profiled step by kind (the timed steps are not profiled)
    params = init_params(cfg, device=device, seed=0)
    opt_state = adamw.init_opt_state(params, opt_cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             next(make_batch_fn(cfg, Bt, St, seed=0)).items()}
    step_fn = make_train_step(cfg, opt_cfg, attn_impl="kernel")
    step_fn(params, opt_state, batch)                       # warm
    busy, kinds = profile_train_step(
        torch, lambda: step_fn(params, opt_state, batch), 1e3 * step_s)
    parts["profiled step"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # the gate: at fp32 compute (an fp32 copy of the weights), the kernel
    # path's gradients against the plain chunked path's at phase 3's bars
    p32 = tree_map(lambda t: t.detach().float(), params)
    del params, opt_state, step_fn
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    fp32_gradient_gate(torch, p32, cfg32, batch, cfg.num_layers, "mixtral")
    del p32, batch
    torch.cuda.empty_cache()
    parts["fp32 gate"] = time.perf_counter() - t0
    log("phase 11 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return launches


# --------------------------------------------------------------------------- #
# Phase 12: training mamba2-130m at full width and depth
# --------------------------------------------------------------------------- #

def phase_mamba_train(torch, np, device):
    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.train.trainer import TrainerConfig, train

    cfg = get_config("mamba2-130m")
    Bt, St = MAMBA_TRAIN
    steps = MAMBA_TRAIN_STEPS
    log(f"mamba2-130m training at full width and depth: {cfg.num_layers} "
        f"layers, d {cfg.d_model}, {cfg.param_count():,} params, bf16, fp32 "
        f"AdamW moments, {Bt} x {St} tokens a step, remat "
        f"{MAMBA_TRAIN_REMAT}; the ssm layers train through the plain "
        f"ssd_reference (the JAX package has no SSD backward kernel)")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = train(cfg, TrainerConfig(steps=steps, batch=Bt, seq_len=St,
                                   remat=MAMBA_TRAIN_REMAT, log_every=1,
                                   seed=0), device=device)
    peak = torch.cuda.max_memory_allocated()
    step_s = 1.0 / res.steady_steps_per_s
    # the model's work (3 x forward), not the recompute
    tflops = F.train_flops(cfg, Bt, St, remat=False) / step_s / 1e12
    log(f"mamba2 train: losses {[round(x, 4) for x in res.losses]}; first "
        f"step {res.compile_time_s:.3f} s; then {1e3 * step_s:.1f} ms a step, "
        f"{Bt * St / step_s:.0f} tokens/s; train_flops (no recompute) / step "
        f"time {tflops:.1f} TFLOP/s = "
        f"{100 * tflops * 1e12 / BF16_FLOP_PER_S:.2f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    if len(res.losses) != steps or not all(np.isfinite(res.losses)):
        fail(f"mamba2 train: non-finite or missing losses {res.losses}")
    del res
    torch.cuda.empty_cache()
    log(f"phase 12 wall time (s): {time.perf_counter() - t0:.1f}")


# --------------------------------------------------------------------------- #
# Phase 13: the jamba hybrid at full width, 8 layers
# --------------------------------------------------------------------------- #

def moe_routes(torch, calls, B, S):
    """The (B, S, k) expert ids of ``dispatch_plan`` calls: one per-row
    call (a prefill) or S flat calls of B tokens (decode steps), each
    token's ids sorted."""
    if len(calls) == 1:
        ids = calls[0]
    else:
        ids = torch.stack([c.reshape(B, -1) for c in calls], dim=1)
    return ids.reshape(B, S, -1).sort(dim=-1).values


def decode_vs_prefill(torch, M, params, cfg, toks):
    """``decode_step`` token by token against the kernel prefill: (largest
    |diff|, largest |diff| - 2e-3 |logit|, largest |logit|, whether the
    MoE layers routed every token alike on both paths)."""
    from repro_torch.models import moe
    Bc, Sc = toks.shape
    live = slice(0, cfg.vocab_size)
    calls = []
    plan = moe.dispatch_plan

    def spy(top_i, C, E):
        calls.append(top_i.clone())
        return plan(top_i, C, E)
    moe.dispatch_plan = spy
    try:
        with torch.inference_mode():
            full = M.forward_logits(params, cfg, {"tokens": toks},
                                    attn_impl="kernel")[..., live]
            pre = list(calls)
            calls.clear()
            cache = M.init_cache(cfg, Bc, Sc, dtype=torch.float32,
                                 device=toks.device)
            outs = []
            for i in range(Sc):
                lg, cache = M.decode_step(params, cfg, cache,
                                          toks[:, i:i + 1], i)
                outs.append(lg[..., live])
            dec = torch.stack(outs, dim=1)
    finally:
        moe.dispatch_plan = plan
    n_moe = len(pre)
    same = all(torch.equal(
        moe_routes(torch, pre[j:j + 1], Bc, Sc),
        moe_routes(torch, calls[j::n_moe], Bc, Sc)) for j in range(n_moe))
    diff, excess, scale = excess_over(torch, dec, full)
    del cache, dec, full
    torch.cuda.empty_cache()
    return diff, excess, scale, same


def phase_jamba(torch, np, device):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssd_scan.kernel import ssd_bhcq
    from repro_torch.models import model as M
    from repro_torch.models.params import decoder_groups, init_params
    from repro_torch.serve.step import greedy_generate

    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, num_layers=JAMBA_LAYERS)
    ssm, m = cfg.ssm, cfg.moe
    n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.num_layers))
    n_attn = cfg.num_layers - n_ssm
    parts = {}
    t0 = time.perf_counter()
    params = init_params(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"jamba-v0.1-52b full width, {cfg.num_layers} of {full.num_layers} "
        f"layers (full depth: {full.param_count():,} params, "
        f"{2 * full.param_count() / 1e9:.1f} GB of bf16): d {cfg.d_model}; "
        f"{n_ssm} SSD mixers ({ssm.num_heads(cfg.d_model)} heads x p "
        f"{ssm.head_dim}, state {ssm.d_state}, chunk {ssm.chunk_size}), "
        f"{n_attn} attention ({cfg.num_heads} heads, GQA kv "
        f"{cfg.num_kv_heads}, D {cfg.resolved_head_dim}, no positional "
        f"encoding), MoE {m.num_experts} experts top-{m.experts_per_token} "
        f"x d_ff {m.d_ff_expert} every other layer; groups "
        f"{[(g.sublayers, g.depth) for g in decoder_groups(cfg)]}; "
        f"{cfg.param_count():,} params ({cfg.active_param_count():,} active "
        f"a token), {nbytes / 1e9:.2f} GB bf16, init "
        f"{time.perf_counter() - t0:.2f} s")
    parts["init"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (a) prefill through the SSD and FA-2 forward kernels
    Bp, Sp = JAMBA_PREFILL
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, (Bp, Sp))
                              ).to(device)

    def prefill():
        with torch.inference_mode():
            return M.forward_logits(params, cfg, {"tokens": tokens},
                                    attn_impl="kernel")
    prefill()                                            # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_bhcq.launches = FK.flash_attention_fwd.launches = 0
    logits = prefill()
    torch.cuda.synchronize()
    launches = {"ssd_scan": ssd_bhcq.launches,
                "flash_attention_fwd": FK.flash_attention_fwd.launches}
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (Bp, Sp, cfg.padded_vocab_size) or not bool(
            torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        fail(f"jamba prefill logits malformed: {tuple(logits.shape)}")
    if launches != {"ssd_scan": n_ssm, "flash_attention_fwd": n_attn}:
        fail(f"a jamba prefill forward launched {launches}, not {n_ssm} SSD "
             f"scans and {n_attn} FA-2 forwards")
    del logits
    ms, times = wall_ms(torch, prefill, 5)
    flops = F.fwd_flops(cfg, Bp, Sp)
    tflops = flops / (ms / 1e3) / 1e12
    log(f"jamba prefill {Bp} x {Sp} tokens, bf16: {launches}; {ms:.2f} ms a "
        f"forward (median of 5; {', '.join(f'{x:.2f}' for x in times)}), "
        f"{Bp * Sp / (ms / 1e3):,.0f} tokens/s; fwd_flops {flops:.4e} / time "
        f"= {tflops:.1f} TFLOP/s = {100 * tflops * 1e12 / BF16_FLOP_PER_S:.2f}"
        f"% of {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    profile_fn(torch, prefill, ms, 1, "ssd_", unit="forward")
    parts["prefill"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (b) dense decode over the attn + ssm + moe caches
    Bd, Sd, new = JAMBA_DECODE
    prompt = torch.from_numpy(rs.randint(0, cfg.vocab_size, (Bd, Sd))
                              ).to(device)
    greedy_generate(params, cfg, prompt, 2, cache_len=Sd + new)   # warm
    out = None

    def gen():
        nonlocal out
        out = greedy_generate(params, cfg, prompt, new)
    gen_ms, _ = wall_ms(torch, gen, 1)
    steps = Sd + new - 1
    if tuple(out.shape) != (Bd, Sd + new) or int(out.max()) >= \
            cfg.vocab_size or not torch.equal(out[:, :Sd], prompt):
        fail(f"jamba greedy_generate output malformed: {tuple(out.shape)}")
    log(f"jamba greedy_generate {Bd} x ({Sd} prompt + {new} new) tokens, "
        f"bf16, dense cache: {gen_ms:.1f} ms, {steps} decode steps, "
        f"{gen_ms / steps:.3f} ms a step, {Bd * new / (gen_ms / 1e3):.1f} new "
        f"tokens/s; every id < {cfg.vocab_size}")
    parts["dense decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (c) decode_step token by token == the kernel prefill, fp32 compute
    # over the bf16 weights cast op by op (an fp32 copy, 53 GB, does not
    # fit beside them); the capacity holds every assignment, as the
    # decode's flat dispatch does, so that neither side drops a token
    Bc, Sc = JAMBA_AGREE
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                moe=dataclasses.replace(
                                    m, capacity_factor=float(m.num_experts)))
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (Bc, Sc))
                            ).to(device)
    diff, excess, scale, same = decode_vs_prefill(torch, M, params, cfg32,
                                                  toks)
    log(f"jamba decode_step x {Sc} vs the kernel prefill ({Bc} x {Sc} "
        f"tokens, fp32 compute, chunks of {ssm.chunk_size}: one full and a "
        f"ragged one): max_abs_diff {diff:.3e}; largest |diff| - 2e-3 "
        f"|logit| = {excess:.3e} (bound atol 2e-4 x largest |logit| "
        f"{scale:.3f} = {2e-4 * scale:.3e}); the MoE layers routed every "
        f"token alike on both paths: {same}")
    if not excess <= 2e-4 * scale:
        fail("jamba dense decode and the kernel prefill disagree")
    parts["decode = prefill"] = time.perf_counter() - t0
    log("phase 13 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    del params
    torch.cuda.empty_cache()
    return launches

# --------------------------------------------------------------------------- #
# Phase 14: serving deepseek-v3-671b at full width, 5 layers
# --------------------------------------------------------------------------- #

def mla_layer0_check(torch, M, params, cfg, tokens):
    """Layer 0's MLA attention at the prefill's own q, k and v (taken from
    ``mla_forward`` as it hands them to ``run_attention``): the FA-2
    forward over every head against ``attention_fwd_plain`` over the
    first ``DEEPSEEK_HEADS`` heads, at phase 3's bf16 bars.  Returns (out
    error, its bound, lse error, its bound)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import mla as MLA
    from repro_torch.models.params import tree_map
    p0 = tree_map(lambda a: a[0], params["decoder"]["g0"]["s0_mla"])
    Bt, S = tokens.shape
    seen = {}
    real = MLA.run_attention

    def capture(q, k, v, **kw):
        seen.update(q=q, k=k, v=v)
        return real(q, k, v, **kw)
    MLA.run_attention = capture
    try:
        with torch.inference_mode():
            x = M.embed_tokens(params, cfg, tokens)
            pos = torch.arange(S, device=x.device)[None].expand(Bt, S)
            MLA.mla_forward(p0, x, cfg, positions=pos, impl="kernel")
    finally:
        MLA.run_attention = real
    # (B, S, H, D) -> (B, H, S, D) views, the layout the model passes
    q, k, v = (seen[n].transpose(1, 2) for n in "qkv")
    with torch.inference_mode():
        out, lse = FK.flash_attention_fwd(q, k, v, causal=True)
        h = DEEPSEEK_HEADS
        ref, ref_lse = FK.attention_fwd_plain(q[:, :h], k[:, :h], v[:, :h],
                                              causal=True)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail("non-finite FA-2 output at layer 0 of the deepseek prefill")
    tol = FA_TOL["bfloat16"]
    err = float((out[:, :h].float() - ref.float()).abs().max())
    bound = tol["out"] * max(1.0, float(ref.float().abs().max()))
    lse_err = float((lse[:, :h] - ref_lse).abs().max())
    lse_bound = tol["lse"] * max(1.0, float(ref_lse.abs().max()))
    return err, bound, lse_err, lse_bound


def unstack_first(tree):
    """Keep only the first layer of a stacked group, leaf by leaf and in
    place, so that each stack is freed as its layer is copied out."""
    for key in list(tree):
        if isinstance(tree[key], dict):
            unstack_first(tree[key])
        else:
            tree[key] = tree[key][0].clone()


def phase_deepseek(torch, np, device):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import model as M
    from repro_torch.models.params import decoder_groups, init_params
    from repro_torch.serve.step import greedy_generate

    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_LAYERS)
    mla, m = cfg.mla, cfg.moe
    parts = {}
    t0 = time.perf_counter()
    params = init_params(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"deepseek-v3-671b full width, {cfg.num_layers} of {full.num_layers} "
        f"layers ({cfg.first_dense_layers} dense, "
        f"{cfg.num_layers - cfg.first_dense_layers} MoE; full depth: "
        f"{full.param_count():,} params, {2 * full.param_count() / 1e12:.2f} "
        f"TB of bf16): d {cfg.d_model}, MLA {cfg.num_heads} heads, q-LoRA "
        f"{mla.q_lora_rank}, latent {mla.kv_lora_rank}, (qk, v) = "
        f"({mla.qk_head_dim}, {mla.v_head_dim}); dense d_ff {cfg.d_ff}; "
        f"{m.num_experts} experts top-{m.experts_per_token} x d_ff "
        f"{m.d_ff_expert} + {m.num_shared_experts} shared; vocab "
        f"{cfg.vocab_size}; groups "
        f"{[(g.sublayers, g.depth) for g in decoder_groups(cfg)]}; "
        f"{cfg.param_count():,} params ({cfg.active_param_count():,} active "
        f"a token, the MTP block's included), {nbytes / 1e9:.2f} GB bf16, "
        f"init {time.perf_counter() - t0:.2f} s")
    parts["init"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (a) prefill through the FA-2 forward at (192, 128)
    Bp, Sp = DEEPSEEK_PREFILL
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, (Bp, Sp))
                              ).to(device)

    def prefill():
        with torch.inference_mode():
            return M.forward_logits(params, cfg, {"tokens": tokens},
                                    attn_impl="kernel")
    prefill()                                            # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FK.flash_attention_fwd.launches = 0
    before = FK.flash_attention_fwd.kernels.copy()
    logits = prefill()
    torch.cuda.synchronize()
    fa_launches = FK.flash_attention_fwd.launches
    ran = dict(FK.flash_attention_fwd.kernels - before)
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (Bp, Sp, cfg.padded_vocab_size) or not bool(
            torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        fail(f"deepseek prefill logits malformed: {tuple(logits.shape)}")
    if fa_launches != cfg.num_layers or ran != {
            "fa_fwd_tc_kernel<192, 128>": cfg.num_layers}:
        fail(f"a deepseek prefill forward launched the FA-2 forward "
             f"{fa_launches} times ({ran}), not {cfg.num_layers} at "
             f"(192, 128)")
    del logits
    ms, times = wall_ms(torch, prefill, 5)
    flops = F.fwd_flops(cfg, Bp, Sp)
    tflops = flops / (ms / 1e3) / 1e12
    log(f"deepseek prefill {Bp} x {Sp} tokens, bf16, FA-2 forward x "
        f"{fa_launches} ({ran}): {ms:.2f} ms a forward (median of 5; "
        f"{', '.join(f'{x:.2f}' for x in times)}), "
        f"{Bp * Sp / (ms / 1e3):,.0f} tokens/s; fwd_flops {flops:.4e} / time "
        f"= {tflops:.1f} TFLOP/s = {100 * tflops * 1e12 / BF16_FLOP_PER_S:.2f}"
        f"% of {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    profile_fn(torch, prefill, ms, 1, "fa_fwd_tc", unit="forward")
    parts["prefill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    err, bound, lse_err, lse_bound = mla_layer0_check(torch, M, params, cfg,
                                                      tokens)
    log(f"layer 0 MLA attention at the prefill's q/k/v (B {Bp}, S {Sp}, H "
        f"{cfg.num_heads}, (D, Dv) ({mla.qk_head_dim}, {mla.v_head_dim}); "
        f"heads 0-{DEEPSEEK_HEADS - 1} against attention_fwd_plain): out "
        f"max_abs_err {err:.3e} (bound {bound:.3e}), lse {lse_err:.3e} "
        f"(bound {lse_bound:.3e})")
    if err > bound or lse_err > lse_bound:
        fail(f"deepseek layer 0: FA-2 forward disagrees with its plain "
             f"version: out {err} > {bound} or lse {lse_err} > {lse_bound}")
    parts["layer 0 check"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (b) the serve launcher's path for MLA: dense greedy decoding over
    # the latent cache
    Bd, Sd, new = DEEPSEEK_DECODE
    prompt = torch.from_numpy(rs.randint(0, cfg.vocab_size, (Bd, Sd))
                              ).to(device)
    greedy_generate(params, cfg, prompt, 2, cache_len=Sd + new)   # warm
    out = None

    def gen():
        nonlocal out
        out = greedy_generate(params, cfg, prompt, new)
    gen_ms, _ = wall_ms(torch, gen, 1)
    steps = Sd + new - 1
    if tuple(out.shape) != (Bd, Sd + new) or int(out.max()) >= \
            cfg.vocab_size or not torch.equal(out[:, :Sd], prompt):
        fail(f"deepseek greedy_generate output malformed: "
             f"{tuple(out.shape)}")
    per_tok = F.kv_cache_bytes(cfg, 1, 1)
    log(f"deepseek greedy_generate {Bd} x ({Sd} prompt + {new} new) tokens, "
        f"bf16, latent cache: {gen_ms:.1f} ms, {steps} decode steps, "
        f"{gen_ms / steps:.3f} ms a step, {Bd * new / (gen_ms / 1e3):.1f} new "
        f"tokens/s; cache {per_tok:.0f} bytes a token over {cfg.num_layers} "
        f"layers ({per_tok / cfg.num_layers:.0f} a layer: latent "
        f"{mla.kv_lora_rank} + rope key {mla.qk_rope_head_dim} in bf16; "
        f"K/V of {cfg.num_heads} heads at ({mla.qk_head_dim}, "
        f"{mla.v_head_dim}) would take "
        f"{2 * cfg.num_heads * (mla.qk_head_dim + mla.v_head_dim):.0f}); "
        f"every id < {cfg.vocab_size}")
    # the profile reads a shorter run of the same steps (16 prompt tokens
    # and 8 new): the profiler's bookkeeping grows with the operations
    short = prompt[:, :16]
    profile_fn(torch, lambda: greedy_generate(params, cfg, short, 8),
               gen_ms / steps, 16 + 8 - 1, "index")
    parts["dense decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (c) decode_step token by token == the kernel prefill at fp32
    # compute over the bf16 weights cast op by op, on the 3 dense layers
    # and the first MoE layer (the second's stacks are freed), at a
    # capacity that holds every assignment (k / E of the tokens x E / k),
    # as the decode's flat dispatch does
    unstack_first(params["decoder"]["g1"])
    torch.cuda.empty_cache()
    Bc, Sc = DEEPSEEK_AGREE
    cfg32 = dataclasses.replace(
        cfg, num_layers=DEEPSEEK_AGREE_LAYERS, compute_dtype="float32",
        moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.experts_per_token))
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (Bc, Sc))
                            ).to(device)
    diff, excess, scale, same = decode_vs_prefill(torch, M, params, cfg32,
                                                  toks)
    held_on = (f"{cfg32.num_layers} layers ({cfg32.first_dense_layers} "
               f"dense, 1 MoE)")
    log(f"deepseek decode_step x {Sc} (absorbed latent form) vs the kernel "
        f"prefill (expanded form) on {held_on}, {Bc} x {Sc} tokens, fp32 "
        f"compute: max_abs_diff {diff:.3e}; largest |diff| - 2e-3 |logit| = "
        f"{excess:.3e} (bound atol 2e-4 x largest |logit| {scale:.3f} = "
        f"{2e-4 * scale:.3e}); the MoE layer routed every token alike on "
        f"both paths: {same}")
    if not excess <= 2e-4 * scale:
        if same:
            fail("deepseek dense decode and the kernel prefill disagree")
        # a near-tie among 256 experts flipped between the two forms:
        # hold the check on the dense layers, where nothing routes
        cfg3 = dataclasses.replace(cfg32, num_layers=cfg.first_dense_layers)
        dense = dict(params, decoder={"g0": params["decoder"]["g0"]})
        diff, excess, scale, _ = decode_vs_prefill(torch, M, dense, cfg3,
                                                   toks)
        held_on = f"the {cfg3.num_layers} dense layers"
        log(f"  a top-{m.experts_per_token} near-tie flipped: held on "
            f"{held_on} instead: max_abs_diff {diff:.3e}; largest |diff| - "
            f"2e-3 |logit| = {excess:.3e} (bound {2e-4 * scale:.3e})")
        if not excess <= 2e-4 * scale:
            fail("deepseek dense decode and the kernel prefill disagree on "
                 "the dense layers")
    parts["decode = prefill"] = time.perf_counter() - t0
    log("phase 14 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    del params
    torch.cuda.empty_cache()
    return fa_launches


# --------------------------------------------------------------------------- #
# Phase 15: training deepseek-v3-671b's dense prefix and MTP block
# --------------------------------------------------------------------------- #

def phase_deepseek_train(torch, np, device, fa_timing):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import model as M
    from repro_torch.models.params import decoder_groups, init_params, \
        tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import TrainerConfig, train

    full = get_config("deepseek-v3-671b")
    # the JAX layer_groups builds a prefix group first_dense_layers deep
    # whatever num_layers is, so the two are cut together
    cfg = dataclasses.replace(full, num_layers=DEEPSEEK_TRAIN_LAYERS,
                              first_dense_layers=DEEPSEEK_TRAIN_LAYERS)
    Bt, St = DEEPSEEK_TRAIN
    steps = DEEPSEEK_TRAIN_STEPS
    per_step = cfg.num_layers + cfg.mtp_depth
    log(f"deepseek-v3-671b training at full width: the {cfg.num_layers} "
        f"dense layers of {full.num_layers} and the MTP block (groups "
        f"{[(g.sublayers, g.depth) for g in decoder_groups(cfg)]}, MTP "
        f"depth {cfg.mtp_depth}: mla + mlp at d_ff {cfg.d_ff}); "
        f"{cfg.param_count():,} params, bf16 weights, fp32 AdamW moments, "
        f"{Bt} x {St} tokens a step, remat none, lr 2e-5")
    parts = {}
    t0 = time.perf_counter()
    kernels = (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
               FK.flash_attention_bwd_dkdv)
    # lr as phase 11 (AdamW's first steps move each d-wide product by
    # about lr x d)
    opt_cfg = adamw.OptConfig(learning_rate=2e-5, warmup_steps=1)
    mtp = []
    forward_train = M.forward_train

    def spy(*args, **kwargs):
        loss, mets = forward_train(*args, **kwargs)
        mtp.append(mets["mtp_loss"].detach())
        return loss, mets
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels:
        f.launches = 0
    before = [f.kernels.copy() for f in kernels]
    M.forward_train = spy
    try:
        res = train(cfg, TrainerConfig(steps=steps, batch=Bt, seq_len=St,
                                       attn_impl="kernel", log_every=1,
                                       seed=0), opt_cfg, device=device)
    finally:
        M.forward_train = forward_train
    launches = {f.__name__: f.launches for f in kernels}
    ran = {f.__name__: dict(f.kernels - b) for f, b in zip(kernels, before)}
    peak = torch.cuda.max_memory_allocated()
    mtp = [float(x) for x in mtp]
    step_s = 1.0 / res.steady_steps_per_s
    flops = F.train_flops(cfg, Bt, St, remat=False)
    tflops = flops / step_s / 1e12
    log(f"deepseek train: losses {[round(x, 4) for x in res.losses]} (mtp_loss "
        f"{[round(x, 4) for x in mtp]}); first step "
        f"{res.compile_time_s:.3f} s; then {1e3 * step_s:.1f} ms a step, "
        f"{Bt * St / step_s:.0f} tokens/s; train_flops {flops:.4e} (the "
        f"trunk's attention and 6 x N x tokens with N counting the MTP "
        f"block's parameters, as the JAX count does; not the MTP block's "
        f"attention and head) / step time = {tflops:.1f} TFLOP/s = "
        f"{100 * tflops * 1e12 / BF16_FLOP_PER_S:.1f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    n = per_step * steps
    log(f"deepseek train FA-2 launches {launches} ({ran}), expected "
        f"{per_step} a step ({cfg.num_layers} layers + the MTP block) x "
        f"{steps} steps = {n} each")
    if len(res.losses) != steps or not all(np.isfinite(res.losses + mtp)):
        fail(f"deepseek train: non-finite or missing losses {res.losses} "
             f"(mtp {mtp})")
    if not (res.losses[-1] < res.losses[0] and mtp[-1] < mtp[0]):
        fail(f"deepseek train: the loss or the MTP loss did not fall over "
             f"{steps} steps: {res.losses}, {mtp}")
    if any(v != n for v in launches.values()) or any(
            len(r) != 1 or not next(iter(r)).endswith("<192, 128>")
            for r in ran.values()):
        fail(f"deepseek train: FA-2 kernel launches {launches} ({ran}) != "
             f"{n} each at (192, 128)")
    del res
    torch.cuda.empty_cache()
    parts["trainer"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # one profiled step by kind (the timed steps are not profiled)
    params = init_params(cfg, device=device, seed=0)
    opt_state = adamw.init_opt_state(params, opt_cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             next(make_batch_fn(cfg, Bt, St, seed=0)).items()}
    step_fn = make_train_step(cfg, opt_cfg, attn_impl="kernel")
    step_fn(params, opt_state, batch)                       # warm
    profile_train_step(torch, lambda: step_fn(params, opt_state, batch),
                       1e3 * step_s)
    parts["profiled step"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # the gate: at fp32 compute (an fp32 copy of the weights), the kernel
    # path's gradients against the plain chunked path's at phase 3's bars
    p32 = tree_map(lambda t: t.detach().float(), params)
    del params, opt_state, step_fn
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    fp32_gradient_gate(torch, p32, cfg32, batch, per_step, "deepseek")
    if fa_timing is not None:
        held = fa_timing["deepseek"]["held"]
        log("phase 3's bf16 margins at this attention shape "
            f"{DEEPSEEK_FA} (error / bound): " + ", ".join(
                f"{k} {e:.2e} / {b:.1e} = {e / b:.3f}"
                for k, (e, b) in held.items()))
    del p32, batch
    torch.cuda.empty_cache()
    parts["fp32 gate"] = time.perf_counter() - t0
    log("phase 15 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return launches


# --------------------------------------------------------------------------- #
# Phase 16: granite-3-2b at full width and depth
# --------------------------------------------------------------------------- #

def phase_granite(torch, np, device):
    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainerConfig, train

    cfg = get_config("granite-3-2b")
    Bt, St = GRANITE_TRAIN
    steps = GRANITE_TRAIN_STEPS
    log(f"granite-3-2b full width and depth: {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.resolved_head_dim} (GQA "
        f"kv {cfg.num_kv_heads}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
        f"(padded {cfg.padded_vocab_size}), tied head; "
        f"{cfg.param_count():,} params")
    parts = {}
    t0 = time.perf_counter()

    # (a) training, bf16 weights, fp32 moments, lr as phase 11's (at d
    # 2048 the default 3e-4 moves each product by lr x d, and the loss
    # wanders)
    kernels = (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
               FK.flash_attention_bwd_dkdv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels:
        f.launches = 0
    res = train(cfg, TrainerConfig(steps=steps, batch=Bt, seq_len=St,
                                   attn_impl="kernel", log_every=1, seed=0),
                adamw.OptConfig(learning_rate=2e-5, warmup_steps=1),
                device=device)
    train_launches = {f.__name__: f.launches for f in kernels}
    peak = torch.cuda.max_memory_allocated()
    step_s = 1.0 / res.steady_steps_per_s
    flops = F.train_flops(cfg, Bt, St, remat=False)
    tflops = flops / step_s / 1e12
    log(f"granite train: losses {[round(x, 4) for x in res.losses]}; first "
        f"step {res.compile_time_s:.3f} s; then {1e3 * step_s:.1f} ms a step, "
        f"{Bt * St / step_s:.0f} tokens/s; train_flops {flops:.4e} / step "
        f"time = {tflops:.1f} TFLOP/s = "
        f"{100 * tflops * 1e12 / BF16_FLOP_PER_S:.1f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    n = cfg.num_layers * steps
    log(f"granite train FA-2 launches {train_launches}, expected "
        f"{cfg.num_layers} x {steps} = {n} each")
    if len(res.losses) != steps or not all(np.isfinite(res.losses)):
        fail(f"granite train: non-finite or missing losses {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        fail(f"granite train: the loss did not fall over {steps} steps: "
             f"{res.losses}")
    if any(v != n for v in train_launches.values()):
        fail(f"granite train: FA-2 kernel launches {train_launches} != {n}")
    del res
    torch.cuda.empty_cache()
    parts["trainer"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (b) phase 2's engine and requests through flash-decode at D 64
    t0 = time.perf_counter()
    params = init_params(cfg, device=device, seed=0)
    eng, reqs = primed_engine(params, cfg, device, np)
    out, s, launches, ran = serve_checked(eng, reqs, cfg, "granite")
    step_ms = eng.wall_s / eng.steps * 1e3
    log(f"granite engine run: {int(s['tokens_generated'])} tokens, "
        f"{int(s['steps'])} steps, {eng.wall_s:.3f} s, {step_ms:.3f} ms a "
        f"step, {s['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{s.get('ttft_p50_s', float('nan')) * 1e3:.1f} ms, prefix hit "
        f"tokens {int(s['prefix_hit_tokens'])}; flash_decode_paged launches "
        f"{launches} = {cfg.num_layers} x {eng.steps} steps, by "
        f"instantiation {ran}")
    if any(t >= cfg.vocab_size for r in reqs for t in out[r.uid].tokens):
        fail(f"granite: a padded vocab id (>= {cfg.vocab_size}) was chosen")
    if not ran or any(not (k.startswith("flash_decode_split_tc_kernel<")
                           and k.endswith(", 64>")) for k in ran):
        fail(f"granite: flash-decode ran {ran}, not the tensor-core split "
             f"kernel at width 64")
    del eng
    parts["engine run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the profile reads the first 4 requests: the profiler's bookkeeping
    # grows with the operations
    eng, reqs = primed_engine(params, cfg, device, np)
    profile_run(torch, eng, reqs[:4], step_ms)
    del eng
    parts["profiled run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    diffs, peak_logit, feeds = mixed_step_diff(torch, np, M, params, cfg,
                                               device)
    log(f"granite mixed step (feeds {feeds}) kernel vs gather logits "
        f"max_abs_diff: fp32 compute over the same bf16 pages "
        f"{diffs['float32']:.3e} (bound {LOGITS_TOL:.0e}); bf16 compute "
        f"{diffs['bfloat16']:.3e} (largest |logit| {peak_logit:.2f})")
    if not diffs["float32"] <= LOGITS_TOL:
        fail(f"granite: kernel and gather logits differ by "
             f"{diffs['float32']} in fp32 compute")
    parts["mixed step"] = time.perf_counter() - t0
    log("phase 16 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    del params
    torch.cuda.empty_cache()
    return train_launches, launches


# --------------------------------------------------------------------------- #
# Phase 17: whisper-medium at full width and depth
# --------------------------------------------------------------------------- #

def whisper_flops(cfg, B, frames, tokens):
    """(forward FLOPs, the attention's share) of whisper over B rows of
    ``frames`` encoder frames and ``tokens`` decoder tokens: 2 x params x
    the positions each multiplies (the encoder's and the cross-attention's
    K/V projections x frames, every other parameter x tokens, the tied
    head's included), plus 2 x S x T x H x (D + Dv) a row for each
    attention layer (the encoder's non-causal S = T = frames, the decoder's
    causal S = T = tokens halved, the cross-attention's S = tokens over T =
    frames)."""
    from repro_torch.bridge import flatten
    from repro_torch.models.params import model_spec
    by_frames = by_tokens = 0
    for key, spec in flatten(model_spec(cfg)):
        cross_kv = "['s1_xattn']" in key and key.endswith(
            ("['wk']", "['wv']", "['bk']", "['bv']"))
        if key.startswith("['encoder']") or cross_kv:
            by_frames += spec.size()
        else:
            by_tokens += spec.size()
    hd = cfg.resolved_head_dim
    per_pair = 2 * cfg.num_heads * 2 * hd
    attn = B * per_pair * (cfg.encoder_layers * frames * frames
                           + cfg.num_layers * tokens * tokens / 2
                           + cfg.num_layers * tokens * frames)
    fwd = 2 * B * (by_frames * frames + by_tokens * tokens) + attn
    return fwd, attn


def capture_attention(torch, TL, fn, keep):
    """Run ``fn`` with ``layers.run_attention`` spied on: returns [(q, k,
    v, causal)] of the calls whose index is in ``keep``."""
    seen, real = [], TL.run_attention

    def spy(q, k, v, **kw):
        if len(seen) in keep:
            seen.append((q, k, v, kw.get("causal")))
        else:
            seen.append(None)
        return real(q, k, v, **kw)
    TL.run_attention = spy
    try:
        fn()
    finally:
        TL.run_attention = real
    return [c for c in seen if c is not None], len(seen)


def attention_held(torch, q, k, v, causal):
    """The FA-2 forward against ``attention_fwd_plain`` on (B, S, H, D)
    views, at phase 3's bf16 bars: (out error, bound, lse error, bound)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    with torch.inference_mode():
        out, lse = FK.flash_attention_fwd(q, k, v, causal=causal)
        ref, ref_lse = FK.attention_fwd_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail("non-finite FA-2 output in a whisper layer 0 check")
    tol = FA_TOL["bfloat16"]
    err = float((out.float() - ref.float()).abs().max())
    bound = tol["out"] * max(1.0, float(ref.float().abs().max()))
    lse_err = float((lse - ref_lse).abs().max())
    lse_bound = tol["lse"] * max(1.0, float(ref_lse.abs().max()))
    return err, bound, lse_err, lse_bound


def excess_over(torch, got, want):
    """(largest |diff|, largest |diff| - 2e-3 |want|, max(1, largest
    |want|)): phase 9's decode-vs-prefill measure."""
    d = (got - want).abs()
    return (float(d.max()), float((d - 2e-3 * want.abs()).max()),
            max(1.0, float(want.abs().max())))


def phase_whisper(torch, np, device):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import layers as TL
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw
    from repro_torch.serve.step import greedy_generate
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import TrainerConfig, train

    cfg = get_config("whisper-medium")
    Bt, St = WHISPER_TRAIN
    Se = cfg.encoder_seq_len
    steps = WHISPER_TRAIN_STEPS
    per_step = cfg.encoder_layers + 2 * cfg.num_layers
    log(f"whisper-medium full width and depth: {cfg.encoder_layers} encoder "
        f"+ {cfg.num_layers} decoder layers, d {cfg.d_model}, "
        f"{cfg.num_heads} heads x {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size} (padded {cfg.padded_vocab_size}), "
        f"{Se} encoder frames, {cfg.max_target_positions} learned decoder "
        f"positions; {cfg.param_count():,} params")
    parts = {}
    t0 = time.perf_counter()

    # (a) training: bf16 weights, fp32 moments, lr as phase 11's
    kernels = (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
               FK.flash_attention_bwd_dkdv)
    opt_cfg = adamw.OptConfig(learning_rate=2e-5, warmup_steps=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels:
        f.launches = 0
    before = [f.kernels.copy() for f in kernels]
    res = train(cfg, TrainerConfig(steps=steps, batch=Bt, seq_len=St,
                                   attn_impl="kernel", log_every=1, seed=0),
                opt_cfg, device=device)
    launches = {f.__name__: f.launches for f in kernels}
    ran = {f.__name__: dict(f.kernels - b) for f, b in zip(kernels, before)}
    peak = torch.cuda.max_memory_allocated()
    step_s = 1.0 / res.steady_steps_per_s
    fwd, attn = whisper_flops(cfg, Bt, Se, St)
    tflops = 3 * fwd / step_s / 1e12
    log(f"whisper train: losses {[round(x, 4) for x in res.losses]}; first "
        f"step {res.compile_time_s:.3f} s; then {1e3 * step_s:.1f} ms a step, "
        f"{Bt * St / step_s:.0f} decoder tokens/s ({Bt * Se / step_s:.0f} "
        f"encoder frames/s); this phase's FLOP count 3 x {fwd:.4e} (the "
        f"attention {attn:.4e} of it) / step time = {tflops:.1f} TFLOP/s = "
        f"{100 * tflops * 1e12 / BF16_FLOP_PER_S:.1f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s (core/flops.py's train_flops, "
        f"{F.train_flops(cfg, Bt, St, remat=False):.4e}, multiplies every "
        f"parameter by the decoder tokens alone and counts neither the "
        f"encoder's frames nor the cross-attention); peak memory "
        f"{peak / 1e9:.2f} GB")
    n = per_step * steps
    log(f"whisper train FA-2 launches {launches} ({ran}), expected "
        f"{per_step} a step ({cfg.encoder_layers} encoder, {cfg.num_layers} "
        f"decoder and {cfg.num_layers} cross-attention layers) x {steps} "
        f"steps = {n} each")
    if len(res.losses) != steps or not all(np.isfinite(res.losses)):
        fail(f"whisper train: non-finite or missing losses {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        fail(f"whisper train: the loss did not fall over {steps} steps: "
             f"{res.losses}")
    if any(v != n for v in launches.values()) or any(
            len(r) != 1 or not next(iter(r)).endswith("<64, 64>")
            for r in ran.values()):
        fail(f"whisper train: FA-2 kernel launches {launches} ({ran}) != "
             f"{n} each at (64, 64)")
    del res
    torch.cuda.empty_cache()
    parts["trainer"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # one profiled step by kind (the timed steps are not profiled)
    params = init_params(cfg, device=device, seed=0)
    opt_state = adamw.init_opt_state(params, opt_cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             next(make_batch_fn(cfg, Bt, St, seed=0)).items()}
    step_fn = make_train_step(cfg, opt_cfg, attn_impl="kernel")
    step_fn(params, opt_state, batch)                       # warm
    profile_train_step(torch, lambda: step_fn(params, opt_state, batch),
                       1e3 * step_s)
    # the step without the data pipeline, and the pipeline alone (the
    # audio stub draws B x 1500 x d normals in numpy for every batch)
    fixed_ms, _ = wall_ms(torch, lambda: step_fn(params, opt_state, batch),
                          3)
    data = make_batch_fn(cfg, Bt, St, seed=1)
    t1 = time.perf_counter()
    next(data)
    data_ms = 1e3 * (time.perf_counter() - t1)
    log(f"whisper: a step on one fixed batch {fixed_ms:.1f} ms (median of "
        f"3) against the trainer's {1e3 * step_s:.1f} ms; make_batch_fn's "
        f"next batch {data_ms:.1f} ms on the host")
    del opt_state, step_fn, data
    params = init_params(cfg, device=device, seed=0)
    torch.cuda.empty_cache()
    parts["profiled step"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (b) prefill over the same shape through the FA-2 forward
    prefill_batch = {"tokens": batch["tokens"], "frames": batch["frames"]}

    def prefill():
        with torch.inference_mode():
            return M.forward_logits(params, cfg, prefill_batch,
                                    attn_impl="kernel")
    prefill()                                                # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FK.flash_attention_fwd.launches = 0
    logits = prefill()
    torch.cuda.synchronize()
    fa_launches = FK.flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (Bt, St, cfg.padded_vocab_size) or not bool(
            torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        fail(f"whisper prefill logits malformed: {tuple(logits.shape)}")
    if fa_launches != per_step:
        fail(f"a whisper prefill launched the FA-2 forward {fa_launches} "
             f"times, not {per_step}")
    del logits
    ms, times = wall_ms(torch, prefill, 5)
    tflops = fwd / (ms / 1e3) / 1e12
    log(f"whisper prefill {Bt} x ({Se} frames, {St} tokens), bf16, FA-2 "
        f"forward x {fa_launches}: {ms:.2f} ms a forward (median of 5; "
        f"{', '.join(f'{x:.2f}' for x in times)}), "
        f"{Bt * St / (ms / 1e3):,.0f} decoder tokens/s; {fwd:.4e} FLOP / "
        f"time = {tflops:.1f} TFLOP/s = "
        f"{100 * tflops * 1e12 / BF16_FLOP_PER_S:.2f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    profile_fn(torch, prefill, ms, 1, "fa_fwd_tc", unit="forward")
    # the encoder's layer 0 attention is the first call, the decoder's
    # layer 0 cross-attention comes after the encoder and the decoder's
    # layer 0 self-attention
    xcall = cfg.encoder_layers + 1
    calls, total = capture_attention(torch, TL, prefill, {0, xcall})
    if total != per_step or [c[3] for c in calls] != [False, False] or \
            calls[1][1].shape[1] != Se or calls[1][0].shape[1] != St:
        fail(f"whisper prefill: the attention calls were not as expected "
             f"({total} calls)")
    for (q, k, v, causal), label in zip(calls, ("encoder layer 0",
                                                "cross-attention layer 0")):
        err, bound, lse_err, lse_bound = attention_held(torch, q, k, v,
                                                        causal)
        log(f"whisper {label} attention at the prefill's q/k/v (q "
            f"{tuple(q.shape)}, k/v {tuple(k.shape)}, non-causal) against "
            f"attention_fwd_plain: out max_abs_err {err:.3e} (bound "
            f"{bound:.3e}), lse {lse_err:.3e} (bound {lse_bound:.3e})")
        if err > bound or lse_err > lse_bound:
            fail(f"whisper {label}: FA-2 forward disagrees with its plain "
                 f"version: out {err} > {bound} or lse {lse_err} > "
                 f"{lse_bound}")
    del calls, q, k, v
    torch.cuda.empty_cache()
    parts["prefill"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (c) the serve launcher's dense path: the encoder over seeded frames,
    # the warmed cross cache, greedy decoding
    Bd, Sd, new = WHISPER_DECODE
    rs = np.random.RandomState(0)
    prompt = torch.from_numpy(rs.randint(0, cfg.vocab_size, (Bd, Sd))
                              ).to(device)
    gen = torch.Generator(device=device).manual_seed(2)
    frames = torch.randn((Bd, Se, cfg.d_model), generator=gen, device=device)
    enc = None

    def encode():
        nonlocal enc
        with torch.inference_mode():
            enc = M.encoder_forward(params, cfg, frames, {})
    encode()                                                 # warm
    enc_ms, _ = wall_ms(torch, encode, 3)
    greedy_generate(params, cfg, prompt, 2, cache_len=Sd + new, enc=enc)
    out = None

    def generate():
        nonlocal out
        out = greedy_generate(params, cfg, prompt, new, enc=enc)
    gen_ms, _ = wall_ms(torch, generate, 1)
    dsteps = Sd + new - 1
    if tuple(out.shape) != (Bd, Sd + new) or int(out.max()) >= \
            cfg.vocab_size or not torch.equal(out[:, :Sd], prompt):
        fail(f"whisper greedy_generate output malformed: {tuple(out.shape)}")
    log(f"whisper serve: encoder_forward over {Bd} x {Se} frames {enc_ms:.2f} "
        f"ms (median of 3); greedy_generate {Bd} x ({Sd} prompt + {new} new) "
        f"tokens against the warmed cross cache: {gen_ms:.1f} ms, {dsteps} "
        f"decode steps, {gen_ms / dsteps:.3f} ms a step, "
        f"{Bd * new / (gen_ms / 1e3):.1f} new tokens/s; every id < "
        f"{cfg.vocab_size}")
    del enc, frames
    parts["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (d) at fp32 compute (the bf16 weights cast op by op): decode_step
    # against the warmed cache = the kernel prefill, and the legacy path
    # that re-projects the encoder output every step = the warmed one
    Bc, Sc = WHISPER_AGREE
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (Bc, Sc))
                            ).to(device)
    frames = torch.randn((Bc, Se, cfg.d_model), generator=gen,
                         device=device)
    live = slice(0, cfg.vocab_size)
    with torch.inference_mode():
        full = M.forward_logits(params, cfg32, {"tokens": toks,
                                                "frames": frames},
                                attn_impl="kernel")[..., live]
        enc = M.encoder_forward(params, cfg32, frames,
                                {"attn_impl": "kernel"})
        warmed = M.warm_cross_cache(params, cfg32, M.init_cache(
            cfg32, Bc, Sc, torch.float32, device), enc)
        legacy = M.init_cache(cfg32, Bc, Sc, torch.float32, device)
        outs = {"warmed": [], "legacy": []}
        for i in range(Sc):
            lg, warmed = M.decode_step(params, cfg32, warmed,
                                       toks[:, i:i + 1], i)
            outs["warmed"].append(lg[..., live])
            lg, legacy = M.decode_step(params, cfg32, legacy,
                                       toks[:, i:i + 1], i, enc=enc)
            outs["legacy"].append(lg[..., live])
        dec = {k: torch.stack(v, dim=1) for k, v in outs.items()}
    checks = {"warmed decode vs the kernel prefill":
              excess_over(torch, dec["warmed"], full),
              "legacy decode vs the warmed decode":
              excess_over(torch, dec["legacy"], dec["warmed"])}
    for label, (diff, excess, scale) in checks.items():
        log(f"whisper {label}, {Bc} x {Sc} tokens, fp32 compute: "
            f"max_abs_diff {diff:.3e}; largest |diff| - 2e-3 |logit| = "
            f"{excess:.3e} (bound atol 2e-4 x largest |logit| {scale:.3f} = "
            f"{2e-4 * scale:.3e})")
        if not excess <= 2e-4 * scale:
            fail(f"whisper {label} disagree")
    del full, dec, outs, warmed, legacy, enc, params
    torch.cuda.empty_cache()
    parts["decode = prefill"] = time.perf_counter() - t0
    log("phase 17 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return launches, fa_launches


# --------------------------------------------------------------------------- #
# Phase 18: qwen2-vl-2b at full width and depth
# --------------------------------------------------------------------------- #

def mrope_grid_positions(np, B, grid, St):
    """(3, B, grid * grid + St) position ids with distinct streams: the
    vision tokens at (t, h, w) = (0, row, column) on a grid x grid patch
    grid, the text after the largest of them with t = h = w."""
    Sv = grid * grid
    idx = np.arange(Sv)
    vis = np.stack([np.zeros(Sv), idx // grid, idx % grid])
    text = np.broadcast_to(grid + np.arange(St), (3, St))
    pos = np.concatenate([vis, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, B, Sv + St)))


def phase_qwen2_vl(torch, np, device):
    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.specs import vlm_split
    from repro_torch.models import layers as TL
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import TrainerConfig, train

    cfg = get_config("qwen2-vl-2b")
    Bt, St = QWEN2VL_TRAIN
    Sv, Stext = vlm_split(St)
    steps = QWEN2VL_TRAIN_STEPS
    hd = cfg.resolved_head_dim
    log(f"qwen2-vl-2b full width and depth: {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.num_heads} heads x {hd} over "
        f"{cfg.num_kv_heads} KV heads (group "
        f"{cfg.num_heads // cfg.num_kv_heads}), M-RoPE sections "
        f"{cfg.mrope_sections}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
        f"(padded {cfg.padded_vocab_size}), tied head; "
        f"{cfg.param_count():,} params; {Bt} x {St} tokens a step "
        f"({Sv} vision embeddings + {Stext} text tokens a row)")
    parts = {}
    t0 = time.perf_counter()

    # (a) training, bf16 weights, fp32 moments, lr as phase 11's
    kernels = (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
               FK.flash_attention_bwd_dkdv)
    opt_cfg = adamw.OptConfig(learning_rate=2e-5, warmup_steps=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels:
        f.launches = 0
    before = [f.kernels.copy() for f in kernels]
    res = train(cfg, TrainerConfig(steps=steps, batch=Bt, seq_len=St,
                                   attn_impl="kernel", log_every=1, seed=0),
                opt_cfg, device=device)
    launches = {f.__name__: f.launches for f in kernels}
    ran = {f.__name__: dict(f.kernels - b) for f, b in zip(kernels, before)}
    peak = torch.cuda.max_memory_allocated()
    step_s = 1.0 / res.steady_steps_per_s
    flops = F.train_flops(cfg, Bt, St, remat=False)
    tflops = flops / step_s / 1e12
    log(f"qwen2-vl train: losses {[round(x, 4) for x in res.losses]}; first "
        f"step {res.compile_time_s:.3f} s; then {1e3 * step_s:.1f} ms a step, "
        f"{Bt * St / step_s:.0f} tokens/s; train_flops {flops:.4e} / step "
        f"time = {tflops:.1f} TFLOP/s = "
        f"{100 * tflops * 1e12 / BF16_FLOP_PER_S:.1f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    n = cfg.num_layers * steps
    log(f"qwen2-vl train FA-2 launches {launches} ({ran}), expected "
        f"{cfg.num_layers} x {steps} = {n} each")
    if len(res.losses) != steps or not all(np.isfinite(res.losses)):
        fail(f"qwen2-vl train: non-finite or missing losses {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        fail(f"qwen2-vl train: the loss did not fall over {steps} steps: "
             f"{res.losses}")
    if any(v != n for v in launches.values()) or any(
            len(r) != 1 or not next(iter(r)).endswith(f"<{hd}, {hd}>")
            for r in ran.values()):
        fail(f"qwen2-vl train: FA-2 kernel launches {launches} ({ran}) != "
             f"{n} each at ({hd}, {hd})")
    del res
    torch.cuda.empty_cache()
    parts["trainer"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # one step split into 2 microbatches: M-RoPE positions (3, B, S) split
    # on their batch axis; its mean loss against the whole batch's
    params = init_params(cfg, device=device, seed=0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             next(make_batch_fn(cfg, Bt, St, seed=0)).items()}
    with torch.inference_mode():
        whole, _ = M.forward_train(params, cfg, batch, attn_impl="kernel")
    opt_state = adamw.init_opt_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, attn_impl="kernel",
                              microbatches=2)
    for f in kernels:
        f.launches = 0
    _, _, mx = step_fn(params, opt_state, batch)
    mb_loss, whole = float(mx["loss"]), float(whole)
    mb_launches = {f.__name__: f.launches for f in kernels}
    log(f"qwen2-vl one step in 2 microbatches of {Bt // 2} x {St}: loss "
        f"{mb_loss:.6f}, the whole batch's forward {whole:.6f} (|diff| "
        f"{abs(mb_loss - whole):.3e}, bound {STEP_TOL['bfloat16']['loss']:.0e}"
        f"); FA-2 launches {mb_launches}")
    if not abs(mb_loss - whole) <= STEP_TOL["bfloat16"]["loss"] or any(
            v != 2 * cfg.num_layers for v in mb_launches.values()):
        fail(f"qwen2-vl microbatched step: loss {mb_loss} vs {whole}, "
             f"launches {mb_launches}")
    del opt_state, step_fn, batch, mx
    params = init_params(cfg, device=device, seed=0)
    torch.cuda.empty_cache()
    parts["microbatched step"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (b) prefill with the vision prefix and distinct M-RoPE streams
    grid = QWEN2VL_GRID
    assert grid * grid == Sv
    rs = np.random.RandomState(0)
    pos = torch.from_numpy(mrope_grid_positions(np, Bt, grid, Stext)
                           ).to(device)
    pre = {"tokens": torch.from_numpy(rs.randint(
               0, cfg.vocab_size, (Bt, Stext))).to(device),
           "vision_embeds": torch.from_numpy(
               (rs.standard_normal((Bt, Sv, cfg.d_model)) * 0.02
                ).astype(np.float32)).to(device),
           "positions": pos}

    def prefill():
        with torch.inference_mode():
            return M.forward_logits(params, cfg, pre, attn_impl="kernel")
    prefill()                                                # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FK.flash_attention_fwd.launches = 0
    logits = prefill()
    torch.cuda.synchronize()
    fa_launches = FK.flash_attention_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (Bt, St, cfg.padded_vocab_size) or not bool(
            torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        fail(f"qwen2-vl prefill logits malformed: {tuple(logits.shape)}")
    if fa_launches != cfg.num_layers:
        fail(f"a qwen2-vl prefill launched the FA-2 forward {fa_launches} "
             f"times, not {cfg.num_layers}")
    del logits
    ms, times = wall_ms(torch, prefill, 5)
    flops = F.fwd_flops(cfg, Bt, St)
    tflops = flops / (ms / 1e3) / 1e12
    log(f"qwen2-vl prefill {Bt} x {St} tokens ({Sv} vision + {Stext} text), "
        f"bf16, FA-2 forward x {fa_launches}: {ms:.2f} ms a forward (median "
        f"of 5; {', '.join(f'{x:.2f}' for x in times)}), "
        f"{Bt * St / (ms / 1e3):,.0f} tokens/s; fwd_flops {flops:.4e} / time "
        f"= {tflops:.1f} TFLOP/s = {100 * tflops * 1e12 / BF16_FLOP_PER_S:.2f}"
        f"% of {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 1e9:.2f} GB")
    # layer 0's rotated q and k, as the model made them, against the CPU's
    # apply_mrope of the same tensors at fp32
    seen, real = [], TL.positional

    def spy(x, positions, c):
        y = real(x, positions, c)
        if len(seen) < 2:
            seen.append((x, positions, y))
        return y
    TL.positional = spy
    try:
        prefill()
    finally:
        TL.positional = real
    theta, sections = cfg.rope_theta, cfg.mrope_sections
    for (x, p, y), name in zip(seen, "qk"):
        if not torch.equal(p, pos) or torch.equal(p[0], p[1]):
            fail("qwen2-vl prefill: layer 0 did not rotate by the distinct "
                 "M-RoPE streams it was given")
        with torch.inference_mode():
            card = TL.apply_mrope(x.float(), p, theta, sections)
        if not torch.equal(card.to(y.dtype), y):
            fail(f"qwen2-vl layer 0 {name}: the model's rotation is not "
                 "apply_mrope's")
        cpu = TL.apply_mrope(x.float().cpu(), p.cpu(), theta, sections)
        err = float((card.cpu() - cpu).abs().max())
        bound = 1e-6 * float(cpu.abs().max())
        log(f"qwen2-vl layer 0 rotated {name} {tuple(x.shape)} (sections "
            f"{sections}, positions up to {int(p.max())}, vision (t, h, w) "
            f"on a {grid} x {grid} grid): card vs CPU apply_mrope in fp32 "
            f"max_abs_err {err:.3e} (bound 1e-6 x largest |{name}| = "
            f"{bound:.3e})")
        if not err <= bound:
            fail(f"qwen2-vl layer 0 {name}: M-RoPE on the card differs from "
                 f"the CPU's by {err} > {bound}")
    del seen, pre, pos
    torch.cuda.empty_cache()
    parts["prefill"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (c) phase 2's engine and requests through flash-decode at group 6
    eng, reqs = primed_engine(params, cfg, device, np)
    out, s, dec_launches, dec_ran = serve_checked(eng, reqs, cfg, "qwen2-vl")
    step_ms = eng.wall_s / eng.steps * 1e3
    log(f"qwen2-vl engine run: {int(s['tokens_generated'])} tokens, "
        f"{int(s['steps'])} steps, {eng.wall_s:.3f} s, {step_ms:.3f} ms a "
        f"step, {s['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{s.get('ttft_p50_s', float('nan')) * 1e3:.1f} ms, prefix hit "
        f"tokens {int(s['prefix_hit_tokens'])}; flash_decode_paged launches "
        f"{dec_launches} = {cfg.num_layers} x {eng.steps} steps, by "
        f"instantiation {dec_ran}")
    if any(t >= cfg.vocab_size for r in reqs for t in out[r.uid].tokens):
        fail(f"qwen2-vl: a padded vocab id (>= {cfg.vocab_size}) was chosen")
    if not dec_ran or any(not k.endswith(f", {hd}>") for k in dec_ran):
        fail(f"qwen2-vl: flash-decode ran {dec_ran}, not at width {hd}")
    del eng
    diffs, peak_logit, feeds = mixed_step_diff(torch, np, M, params, cfg,
                                               device)
    log(f"qwen2-vl mixed step (feeds {feeds}) kernel vs gather logits "
        f"max_abs_diff: fp32 compute over the same bf16 pages "
        f"{diffs['float32']:.3e} (bound {LOGITS_TOL:.0e}); bf16 compute "
        f"{diffs['bfloat16']:.3e} (largest |logit| {peak_logit:.2f})")
    if not diffs["float32"] <= LOGITS_TOL:
        fail(f"qwen2-vl: kernel and gather logits differ by "
             f"{diffs['float32']} in fp32 compute")
    parts["engine and mixed step"] = time.perf_counter() - t0
    log("phase 18 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    del params
    torch.cuda.empty_cache()
    return launches, fa_launches, dec_launches


# --------------------------------------------------------------------------- #
# Phase 19: the edge fleet's control loop
# --------------------------------------------------------------------------- #

def edge_placement(cfg, batch, seq_len):
    """tests/test_elastic.py's fleet in the port's own records: laptops and
    phones alternating in pairs, regions alternating one by one over a
    5 MB/s WAN; ``search_placement`` carves it into 2 pipelines.  Returns
    (placement, topology)."""
    from collections import namedtuple

    from repro_torch.core.energy.devices import LAPTOP_M2PRO, SMARTPHONE_SD888
    from repro_torch.core.net import NetParams, Topology
    from repro_torch.core.placement import search_placement
    Edge = namedtuple("Edge", "device_id region spec")
    fleet = [Edge(i, ("europe", "north_america")[i % 2],
                  (LAPTOP_M2PRO, SMARTPHONE_SD888)[(i // 2) % 2])
             for i in range(EDGE_FLEET)]
    topo = Topology.from_fleet(fleet, params=NetParams(
        wan_bw_Bps=EDGE_WAN_BPS))
    spec = search_placement(cfg, [d.spec for d in fleet], topology=topo,
                            nodes=[str(d.device_id) for d in fleet],
                            data_parallel=2, batch=2 * batch,
                            seq_len=seq_len, microbatches=2,
                            collective="hierarchical")
    return spec, topo


def edge_run(torch, cfg, placement, device, health):
    """Async local SGD over the placement (per-region K, quorum 2,
    staleness 1, int8 sync) under the fault plan, the FA-2 and quant8
    counts set to 0 just before and read just after, each report counted
    on a tracer.  Returns (result, launches, reports, wall s, peak
    bytes)."""
    from repro_torch.core.faultinject import FaultPlan
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.quant8.kernel import (dequantize_blocks,
                                                   quantize_blocks)
    from repro_torch.obs import Tracer, set_tracer
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import CompressConfig
    from repro_torch.train.local_sgd import LocalSGDConfig, train_local_sgd
    from repro_torch.train.trainer import TrainerConfig
    Bt, St = EDGE_TRAIN
    tc = TrainerConfig(steps=EDGE_K * EDGE_UPDATES, batch=Bt, seq_len=St,
                       attn_impl="kernel", log_every=0, seed=0)
    # int8 without error feedback: with it, two fp32 error buffers (5.3
    # GB each) beside the two fp32 deltas the quorum buffers took an
    # NVIDIA H100 80GB HBM3 to 76.92 GB, and the second run out of memory
    ls = LocalSGDConfig(replicas=2, inner_steps=EDGE_K, async_mode=True,
                        quorum=2, staleness_bound=1,
                        compress=CompressConfig(method="int8",
                                                error_feedback=False))
    opt_cfg = adamw.OptConfig(learning_rate=3e-3, warmup_steps=5,
                              decay_steps=tc.steps)
    kernels = (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
               FK.flash_attention_bwd_dkdv, quantize_blocks,
               dequantize_blocks)
    tracer = Tracer(enabled=True, process="phase19")
    old = set_tracer(tracer)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels:
        f.launches = 0
    t0 = time.perf_counter()
    try:
        res = train_local_sgd(cfg, tc, ls, opt_cfg, placement=placement,
                              fault_plan=FaultPlan(**EDGE_PLAN),
                              health=health, device=device)
        torch.cuda.synchronize()
    finally:
        set_tracer(old)
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in kernels}
    reports = sum(e.get("name") == "async_round" for e in tracer.events)
    return (res, launches, reports, wall,
            torch.cuda.max_memory_allocated())


def phase_edge_fleet(torch, np, device):
    """(a) the control loop at full width, (b) the elastic checkpoint at 4
    layers, (c) both launchers with --slo and --health-out."""
    t0 = time.perf_counter()
    fleet = edge_fleet_full(torch, np, device)
    parts = {"(a) full-width fleet": time.perf_counter() - t0}
    t1 = time.perf_counter()
    elastic_checkpoint(torch, np, device)
    parts["(b) elastic checkpoint"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    launchers_with_health(torch, device)
    parts["(c) launchers"] = time.perf_counter() - t1
    log("phase 19 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return fleet


def edge_fleet_full(torch, np, device):
    from repro_torch.configs import get_config
    from repro_torch.core.faultinject import FaultPlan
    from repro_torch.obs import HealthMonitor, MetricsRegistry
    from repro_torch.obs.health import StragglerDetector
    from repro_torch.train.local_sgd import (LocalSGDConfig,
                                             per_replica_inner_steps)

    cfg = get_config("opt-1.3b")
    Bt, St = EDGE_TRAIN
    placement, _ = edge_placement(cfg, Bt, St)
    log(f"edge fleet: {EDGE_FLEET} devices over two regions, WAN "
        f"{EDGE_WAN_BPS / 1e6:g} MB/s; {placement.describe()}")
    log(f"placement: boundaries {placement.boundaries}, regions by "
        f"replica {[placement.replica_regions(r) for r in range(2)]}, "
        f"region groups {placement.region_groups()}, search_stats "
        f"{placement.search_stats}")
    ks = per_replica_inner_steps(LocalSGDConfig(replicas=2,
                                                inner_steps=EDGE_K),
                                 placement)
    plan = FaultPlan(**EDGE_PLAN)
    truth = {str(r) for r in range(2) if plan.is_straggler(r)}
    log(f"per-region K {ks}; fault plan {EDGE_PLAN}: stragglers "
        f"{sorted(truth)} (slowdowns "
        f"{[round(plan.slowdown(r), 3) for r in range(2)]})")
    # two replicas are the whole fleet a detector compares against: it
    # may judge with two entities (its default waits for three)
    health = HealthMonitor(registry=MetricsRegistry(),
                           straggler=StragglerDetector(min_entities=2))
    res, launches, reports, wall, peak = edge_run(torch, cfg, placement,
                                                  device, health)
    n_fa = cfg.num_layers * res.inner_steps_total
    n_q = len(opt_leaf_sizes()) * reports
    tokens = res.inner_steps_total * Bt * St
    per_update = {k: 1e3 * v / res.outer_updates
                  for k, v in res.phase_s.items()}
    log(f"with the monitor: {res.outer_updates} outer updates, "
        f"{res.inner_steps_total} inner steps in {reports} reports, "
        f"{res.health_excluded_updates} updates excluded a detected "
        f"straggler, {res.dropped_stale} deltas dropped stale, "
        f"{res.late_merged} merged late; detected stragglers "
        f"{sorted(health.stragglers())} vs the plan's {sorted(truth)}; "
        f"{health.summary_line()}")
    log(f"with the monitor: round losses "
        f"{[round(x, 4) for x in res.round_losses]}; {wall:.1f} s, "
        f"{tokens / wall:.0f} tokens/s on the card; device ms an update: "
        f"inner {per_update.get('inner', 0):.1f}, pseudo-gradient + int8 "
        f"{per_update.get('pseudograd', 0):.1f}, outer "
        f"{per_update.get('outer', 0):.1f}; modelled sync "
        f"{res.comm_time_s_per_round:.3f} s an update, "
        f"{res.sync_wan_bytes_per_round / 1e9:.3f} GB over the WAN; peak "
        f"memory {peak / 1e9:.2f} GB")
    log(f"launches {launches}; expected FA-2 {cfg.num_layers} x "
        f"{res.inner_steps_total} inner steps = {n_fa} each, quant8 "
        f"{len(opt_leaf_sizes())} leaves x {reports} reports = {n_q} each")
    if not all(np.isfinite(res.losses + res.round_losses)) \
            or not res.round_losses:
        fail(f"non-finite or missing losses: {res.round_losses}")
    if any(launches[k] != n_fa for k in list(launches)[:3]) or any(
            launches[k] != n_q for k in list(launches)[3:]):
        fail(f"launches {launches} are not {n_fa} (FA-2) and {n_q} "
             "(quant8) each")
    if health.stragglers() != truth or not truth:
        fail(f"detected stragglers {sorted(health.stragglers())} are not "
             f"the plan's {sorted(truth)}")
    if res.health_excluded_updates == 0:
        fail("no outer update went ahead without the detected straggler")
    vt = res.virtual_time_s
    del res
    gc.collect()
    torch.cuda.empty_cache()
    log(f"between the runs: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "allocated")
    plain, p_launches, p_reports, p_wall, _ = edge_run(
        torch, cfg, placement, device, None)
    log(f"without the monitor: {plain.outer_updates} outer updates, "
        f"{plain.inner_steps_total} inner steps in {p_reports} reports, "
        f"{plain.dropped_stale} dropped stale, {p_wall:.1f} s; virtual "
        f"time {plain.virtual_time_s:.3f} s vs {vt:.3f} s with the "
        f"monitor ({plain.virtual_time_s / vt:.2f}x); launches "
        f"{p_launches}")
    if not all(np.isfinite(plain.round_losses)):
        fail(f"non-finite losses without the monitor: {plain.round_losses}")
    if not vt < plain.virtual_time_s:
        fail(f"the monitored virtual time {vt} is not below the "
             f"unmonitored {plain.virtual_time_s}")
    if any(p_launches[k] != cfg.num_layers * plain.inner_steps_total
           for k in list(p_launches)[:3]) or any(
               p_launches[k] != len(opt_leaf_sizes()) * p_reports
               for k in list(p_launches)[3:]):
        fail(f"launches without the monitor {p_launches} are off")
    del plain
    torch.cuda.empty_cache()
    return launches


def _bits(torch, t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def same_bits(torch, got, want):
    """Every leaf of ``got`` equal to ``want``'s bit for bit (bf16 as
    int16 views), on the same device."""
    from repro_torch.models.params import tree_leaves
    a, b = tree_leaves(got), tree_leaves(want)
    return len(a) == len(b) and all(
        x.device == y.device and x.dtype == y.dtype
        and torch.equal(_bits(torch, x), _bits(torch, y))
        for x, y in zip(a, b))


def elastic_checkpoint(torch, np, device):
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import CheckpointSpec, ckpt, elastic
    from repro_torch.configs import get_config
    from repro_torch.core.faultinject import corrupt_file
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.local_sgd import LocalSGDConfig, train_local_sgd
    from repro_torch.train.trainer import TrainerConfig, _to_device, train

    full = get_config("opt-1.3b")
    L = ELASTIC_LAYERS
    cfg = dataclasses.replace(full, name=f"{full.name}-L{L}", num_layers=L)
    Bt, St = EDGE_TRAIN
    placement, topo = edge_placement(cfg, Bt, St)
    spec = CheckpointSpec.from_placement(placement, replication=1)
    three, two = (CheckpointSpec(L, b) for b in ELASTIC_SPLITS)
    log(f"elastic checkpoint at {L} layers: placement boundaries "
        f"{placement.boundaries} ({placement.num_stages} stages), "
        f"holders {spec.holders}")
    tc = TrainerConfig(steps=ELASTIC_ROUNDS, batch=Bt, seq_len=St,
                       attn_impl="kernel", log_every=0, seed=2)
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        t0 = time.perf_counter()
        res = train_local_sgd(cfg, tc, LocalSGDConfig(
            replicas=2, inner_steps=1, checkpoint_dir=str(d / "run"),
            checkpoint_every_rounds=1, checkpoint_replication=1),
            placement=placement, device=device)
        state = res.outer_state
        step = ckpt.latest_complete_step(d / "run")
        m = ckpt._read_manifest(ckpt._step_dir(d / "run", step))
        nbytes = sum(f.stat().st_size
                     for f in ckpt._step_dir(d / "run", step).iterdir())
        log(f"sync local SGD over the placement: {res.rounds} rounds, "
            f"round losses {[round(x, 4) for x in res.round_losses]}, "
            f"{time.perf_counter() - t0:.1f} s; step {step}: layout "
            f"{m['layout']}, boundaries {m['boundaries']}, replication "
            f"{m['replication']}, {nbytes / 1e9:.3f} GB on disk")
        if step != ELASTIC_ROUNDS or m["layout"] != "layer_sliced" \
                or m["boundaries"] != placement.boundaries:
            fail("the placement-driven run did not write its layer-sliced "
                 "checkpoints")
        # the neighbour holding shard s's copy (writer s + 1) on its own disk
        s = 1 % spec.num_shards
        holder = (s + 1) % spec.num_shards
        ckpt.save_sharded(d / "neighbour", step, state, spec, holder)
        a, b = spec.slices()[s]
        victim = max((p for p in ckpt._step_dir(d / "run", step).iterdir()
                      if f".L{a:05d}-{b:05d}" in p.name),
                     key=lambda p: (p.stat().st_size, p.name)).name
        corrupt_file(ckpt._step_dir(d / "run", step) / victim, seed=step)
        damaged = ckpt.damaged_files(d / "run", step)
        node = placement.pipelines[0][holder].node
        rep = ckpt.heal_step(d / "run", step,
                             sources=[(node, d / "neighbour")])
        cost = elastic.heal_cost(topo, [
            (h["source"], placement.pipelines[0][s].node, h["bytes"])
            for h in rep.healed])
        log(f"bit rot in {victim}: damaged_files {damaged}; heal_step "
            f"fetched {rep.bytes_fetched} bytes from {rep.per_source_bytes}"
            f" (priced {cost.time_s:.3f} s, {cost.wan_bytes:.0f} WAN "
            f"bytes)")
        # (the CRC-checked restore below reads the mended file)
        if damaged != [(victim, "corrupt")] or not rep.ok or \
                [h["file"] for h in rep.healed] != [victim]:
            fail("damaged_files / heal_step did not name and mend the "
                 "rotten shard")
        t0 = time.perf_counter()
        got = ckpt.restore_for_placement(d / "run", three, state, step)
        part = ckpt.restore_for_placement(d / "run", three, state, step,
                                          stage=2)
        wq = part["params"]["decoder"]["g0"]["s0_attn"]["wq"]
        crop = torch.equal(_bits(torch, wq), _bits(
            torch, state["params"]["decoder"]["g0"]["s0_attn"]["wq"][2:4]))
        exact = same_bits(torch, got, state)
        # the restored state as the 3-stage checkpoint, resharded onto 2
        # stages and back: the files must come back byte for byte
        ckpt.save_for_placement(d / "s3", step, got, three)
        ckpt.reshard(d / "s3", two, state, out_directory=d / "s2")
        ckpt.reshard(d / "s2", three, state, out_directory=d / "s3b")
        files = [{p.name: p.read_bytes() for p in
                  ckpt._step_dir(d / x, step).iterdir()}
                 for x in ("s3", "s3b")]
        log(f"restore_for_placement onto {three.boundaries}: every leaf "
            f"the card's state bit for bit {exact}, stage 2 cropped "
            f"{crop}; reshard {three.boundaries} -> {two.boundaries} -> "
            f"{three.boundaries}: files equal {files[0] == files[1]} "
            f"({len(files[0])} files); {time.perf_counter() - t0:.1f} s")
        if not (exact and crop and files[0] == files[1]):
            fail("the elastic restore or the 3 -> 2 -> 3 reshard lost bits")
        del res, state, got, part, files
        torch.cuda.empty_cache()

        # the trainer's checkpoint_placement: save, restore, resume
        t0 = time.perf_counter()
        params = init_params(cfg, device=device, seed=3)
        kw = dict(batch=Bt, seq_len=St, attn_impl="kernel", log_every=0,
                  seed=3, checkpoint_dir=str(d / "trainer"),
                  checkpoint_placement=placement, checkpoint_replication=1)
        train(cfg, TrainerConfig(steps=2, checkpoint_every=2, **kw),
              params=params, device=device)
        like = {"params": tree_map(torch.empty_like, params)}
        like["opt"] = adamw.init_opt_state(like["params"], adamw.OptConfig())
        saved = ckpt.restore_for_placement(d / "trainer", three, like)
        ok = (same_bits(torch, saved["params"], params)
              and int(saved["opt"]["step"]) == 2)
        resumed = train(cfg, TrainerConfig(steps=1, checkpoint_every=0,
                                           resume=True, **kw),
                        params=init_params(cfg, device=device, seed=4),
                        device=device)
        batch = _to_device(next(make_batch_fn(cfg, Bt, St, 3)), device)
        with torch.no_grad():
            loss0 = float(M.forward_train(saved["params"], cfg, batch,
                                          attn_impl="kernel")[0])
        log(f"trainer checkpoint_placement: step 2 restored onto "
            f"{three.boundaries} bit for bit {ok}, opt step "
            f"{int(saved['opt']['step'])}; resumed from step "
            f"{resumed.resumed_from_step}, first loss "
            f"{resumed.losses[0]:.6f} vs the saved params' {loss0:.6f}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not ok or resumed.resumed_from_step != 2 or \
                abs(resumed.losses[0] - loss0) > 1e-6 * abs(loss0):
            fail("the trainer's layer-sliced checkpoint did not restore or "
                 "resume exactly")
    torch.cuda.empty_cache()


def launchers_with_health(torch, device):
    """Both launchers in-process with --slo and --health-out; every
    artifact they write must pass ``repro_torch.obs.validate``."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.obs import get_tracer, set_tracer
    from repro_torch.obs.validate import validate
    old = get_tracer()
    with tempfile.TemporaryDirectory() as d:
        runs = {
            "train": (train_launcher, [
                "--torch-device", str(device), "--arch", "opt-1.3b", "--local-sgd", "--async",
                "--replicas", "4", "--inner-steps", "2", "--steps", "12",
                "--batch", "2", "--seq", "128", "--quorum", "4",
                "--staleness-bound", "2", "--straggler-frac", "0.3",
                "--fault-seed", "3", "--slo", "tokens_per_s=1e12",
                "--health-out", f"{d}/train_health.jsonl",
                "--trace-out", f"{d}/train_trace.json",
                "--metrics-out", f"{d}/train_metrics.jsonl"]),
            "serve": (serve_launcher, [
                "--torch-device", str(device), "--arch", "qwen2-7b", "--full", "--batch", "24",
                "--max-new", "16", "--slo", f"ttft={SLO_BAD_TTFT_S},itl=10",
                "--health-out", f"{d}/serve_health.jsonl",
                "--trace-out", f"{d}/serve_trace.json",
                "--metrics-out", f"{d}/serve_metrics.jsonl"])}
        for name, (mod, argv) in runs.items():
            out = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    mod.main(argv)
            finally:
                set_tracer(old)
            lines = [l for l in out.getvalue().splitlines()
                     if "slo:" in l or "health:" in l or "final loss" in l
                     or "engine:" in l]
            log(f"{name} launcher ({time.perf_counter() - t0:.1f} s): "
                + " | ".join(lines))
            for kind in ("health.jsonl", "trace.json", "metrics.jsonl"):
                path = f"{d}/{name}_{kind}"
                try:
                    counts = validate(path)
                except (OSError, ValueError) as e:
                    fail(f"the {name} launcher's {kind} fails "
                         f"repro_torch.obs.validate: {e}")
                log(f"  {name}_{kind} valid: " + " ".join(
                    f"{k}={v}" for k, v in sorted(counts.items())))
            torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# Phase 20: the carbon-aware fleet (the torch twins of the examples)
# --------------------------------------------------------------------------- #

# (a) quickstart: phase 4's opt-1.3b shape, batch x seq x steps
FLEET_TRAIN = (4, 2048, 8)
# (b) DiLoCo: replicas, K, rounds, batch x seq a replica
FLEET_DILOCO = (2, 2, 2, 2, 2048)
# (c) the serve example's request set
FLEET_SERVE = dict(requests=6, prompt_len=16, max_new=24)
# (d) the carbon sim's steps, the example's default
FLEET_SIM_STEPS = 300
# (e) fleet scale: the search's fleet and its churn sim's rounds; the
# engines' parity fleet and its rounds (the JAX benchmark's 20 cut to 10:
# the scalar engine draws one generator per device and fault a round)
FLEET_N, FLEET_ROUNDS = 100_000, 200
FLEET_PARITY_N, FLEET_PARITY_ROUNDS = 10_000, 10
POWER_SAMPLE_S = 0.05


def load_example(name):
    """``examples/<name>.py`` as a module (examples/ is not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class PowerSampler:
    """The card's ``power.draw`` from ``nvidia-smi``, queried every
    ``POWER_SAMPLE_S`` in a background thread while the with-block runs;
    ``mean_w(t0, t1)`` averages the samples taken in [t0, t1] of
    ``time.perf_counter``.  A query that fails or reads no number leaves
    no sample."""

    def __init__(self):
        import threading
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self):
        while not self._stop.is_set():
            t = time.perf_counter()
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=power.draw",
                     "--format=csv,noheader,nounits", "-i", "0"],
                    capture_output=True, text=True, timeout=5).stdout
                self.samples.append(((t + time.perf_counter()) / 2,
                                     float(out.strip().splitlines()[0])))
            except (OSError, ValueError, IndexError,
                    subprocess.SubprocessError):
                pass
            self._stop.wait(POWER_SAMPLE_S)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def mean_w(self, t0, t1):
        w = [p for t, p in self.samples if t0 <= t <= t1]
        return (sum(w) / len(w) if w else float("nan")), len(w)


def counted(kernels):
    """Set every kernel's count to 0 and return a reader of the counts."""
    for f in kernels:
        f.launches = 0
    return lambda: {f.__name__: f.launches for f in kernels}


def fleet_quickstart(torch, np, device):
    """(a) examples/torch_quickstart.py's ``run`` on full-width opt-1.3b
    at phase 4's shape, with the card's power sampled over the steps;
    against the paper's CLOUD_H100 model of the same FLOPs."""
    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.core.energy.devices import (CLOUD_H100, train_energy_wh,
                                                 train_time_s)
    from repro_torch.kernels.flash_attention import kernel as FK
    tq = load_example("torch_quickstart")
    cfg = get_config("opt-1.3b")
    Bt, St, steps = FLEET_TRAIN
    torch.cuda.empty_cache()
    read = counted((FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
                    FK.flash_attention_bwd_dkdv))
    with PowerSampler() as power:
        res, ledger, _ = tq.run(cfg, steps=steps, batch=Bt, seq=St,
                                  device=device)
        t_end = time.perf_counter()
    launches = read()
    step_s = 1.0 / res.steady_steps_per_s
    watts, n_w = power.mean_w(t_end - (steps - 1) * step_s, t_end)
    flops = F.train_flops(cfg, Bt, St, remat=False)
    model_s = train_time_s(CLOUD_H100, flops)
    model_wh = train_energy_wh(CLOUD_H100, flops)
    log(f"(a) quickstart twin, opt-1.3b {Bt} x {St}, {steps} steps: losses "
        f"{[round(x, 4) for x in res.losses]}; measured "
        f"{1e3 * step_s:.1f} ms a step after the first, "
        f"{flops / step_s / 1e12:.1f} TFLOP/s by train_flops "
        f"({100 * flops / step_s / BF16_FLOP_PER_S:.2f}% of "
        f"{BF16_FLOP_PER_S / 1e12:.0f})")
    log(f"(a) the card's power.draw over the last {steps - 1} steps: "
        f"{watts:.1f} W mean of {n_w} samples -> {watts * step_s:.1f} J a "
        f"step measured; CLOUD_H100 model of the same {flops:.4e} FLOPs: "
        f"train_time_s {model_s:.4f} s ({model_s / step_s:.2f}x the "
        f"measured step), train_energy_wh {model_wh:.5f} Wh = "
        f"{model_wh * 3600:.1f} J ({CLOUD_H100.power_active_w:.0f} W x "
        f"{CLOUD_H100.effective_flops / 1e12:.2f} TFLOP/s effective; "
        f"{model_wh * 3600 / (watts * step_s):.2f}x the measured J)")
    log(f"(a) the example's laptop component model: {res.energy_wh:.4f} Wh "
        f"over {steps} steps, ledger {ledger.operational_kg * 1000:.4f} "
        f"gCO2e at EDGE_PUE")
    n = cfg.num_layers * steps
    if len(res.losses) != steps or not all(np.isfinite(res.losses)):
        fail(f"(a) non-finite or missing losses: {res.losses}")
    if any(v != n for v in launches.values()):
        fail(f"(a) FA-2 launches {launches} != {cfg.num_layers} x {steps}")
    return launches, {"step_ms": 1e3 * step_s, "watts": watts,
                      "j_step": watts * step_s, "model_s": model_s,
                      "model_j": model_wh * 3600}


def fleet_diloco(torch, np, device):
    """(b) examples/torch_diloco_edge.py's ``run`` on full-width opt-1.3b:
    int8 hierarchical sync over the example's two-region 4 MB/s fleet."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.quant8.kernel import (dequantize_blocks,
                                                   quantize_blocks)
    td = load_example("torch_diloco_edge")
    cfg = get_config("opt-1.3b")
    R, K, rounds, Bt, St = FLEET_DILOCO
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    read = counted((FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
                    FK.flash_attention_bwd_dkdv, quantize_blocks,
                    dequantize_blocks))
    t0 = time.perf_counter()
    res, naive = td.run(cfg, replicas=R, rounds=rounds, inner=K, batch=Bt,
                        seq=St, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    round_ms = 1e3 * R * K / res.steps_per_s
    sizes = opt_leaf_sizes()
    wire = sum(n + 4 * (n // 256 + 1) for n in sizes)
    n_q, n_fa = len(sizes) * R * rounds, cfg.num_layers * R * K * rounds
    log(f"(b) DiLoCo twin, opt-1.3b, {R} replicas x K {K} x {rounds} rounds "
        f"of {Bt} x {St}: round losses "
        f"{[round(x, 4) for x in res.round_losses]}; {round_ms:.1f} ms a "
        f"round ({wall:.1f} s the call), device ms a round "
        f"{ {k: round(1e3 * v / rounds, 1) for k, v in res.phase_s.items()} }"
        f"; modelled int8 hierarchical sync {res.comm_time_s_per_round:.3f} "
        f"s a round, {res.comm_time_s_per_step:.3f} s a step amortized, "
        f"against the naive every-step fp32 ring's {naive.time_s:.3f} s "
        f"({naive.time_s / res.comm_time_s_per_step:.0f}x); peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{launches} (expected FA-2 {n_fa}, quant8 {n_q} each)")
    if not all(np.isfinite(res.losses + res.round_losses)) \
            or len(res.round_losses) != rounds:
        fail(f"(b) non-finite or missing losses: {res.round_losses}")
    if any(launches[k] != n_fa for k in list(launches)[:3]) or any(
            launches[k] != n_q for k in list(launches)[3:]):
        fail(f"(b) launches {launches} are not {n_fa} (FA-2) and {n_q} "
             "(quant8) each")
    if res.sync_wire_bytes_per_round != wire:
        fail(f"(b) wire bytes {res.sync_wire_bytes_per_round} != {wire}")
    return launches, {"round_ms": round_ms}


def fleet_serve(torch, np, device):
    """(c) examples/torch_serve_batched.py: ``run_engine`` on full-width
    qwen2-7b (flash-decode in every layer every step; greedy ids held to
    ``greedy_generate``'s at fp32 compute), ``run_dense`` on full-width
    mamba2-130m; ms a decode step against the HBM bound."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import flops as F
    from repro_torch.kernels.flash_attention.decode import flash_decode_paged
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serve.step import greedy_generate
    ts = load_example("torch_serve_batched")
    kw = FLEET_SERVE
    cfg = get_config("qwen2-7b")
    params = init_params(cfg, device=device, seed=0)
    ts.run_engine(cfg, params, **kw)                    # warm
    read = counted((flash_decode_paged,))
    reqs, out, eng = ts.run_engine(cfg, params, **kw)
    launches = read()
    steps = eng.steps
    step_ms = 1e3 * eng.wall_s / steps
    slots = min(kw["requests"], 4)
    cache = kw["prompt_len"] + kw["max_new"]
    bound_ms = 1e3 * F.decode_hbm_bytes(cfg, slots, cache) / HBM_BYTES_PER_S
    s = eng.stats()
    if set(out) != {r.uid for r in reqs} or any(
            len(out[r.uid].tokens) != kw["max_new"] or out[r.uid].failed
            for r in reqs):
        fail("(c) not every request completed")
    if launches["flash_decode_paged"] != cfg.num_layers * steps:
        fail(f"(c) flash-decode launches {launches} != {cfg.num_layers} x "
             f"{steps} steps")

    def dense_ids(p, c):
        ids = {}
        for r in reqs:
            g = greedy_generate(p, c, torch.tensor([r.prompt],
                                                   device=device),
                                max_new=kw["max_new"])
            ids[r.uid] = g[0, len(r.prompt):].tolist()
        return ids

    same16 = sum(out[r.uid].tokens == t
                 for r, t in zip(reqs, dense_ids(params, cfg).values()))
    # the gate, at fp32 compute over the same weights (bf16 pages and
    # dense cache alike): a bf16 logit's rounding can swap a near tie
    c32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    read32 = counted((flash_decode_paged,))
    _, out32, eng32 = ts.run_engine(c32, p32, **kw)
    n32 = read32()["flash_decode_paged"]
    want = dense_ids(p32, c32)
    same32 = [out32[r.uid].tokens == want[r.uid] for r in reqs]
    log(f"(c) serve twin, qwen2-7b engine: {int(s['tokens_generated'])} "
        f"tokens, {steps} steps, {eng.wall_s:.3f} s, {step_ms:.2f} ms a step "
        f"(decode_hbm_bytes at {slots} x {cache} / 3.35 TB/s = "
        f"{bound_ms:.3f} ms, {step_ms / bound_ms:.1f}x), "
        f"{s['tokens_per_s']:.1f} tokens/s; monitor {s['energy_j']:.2f} J "
        f"({s['j_per_token']:.3f} J/token) on the laptop-m2pro profile; "
        f"flash-decode launches {launches['flash_decode_paged']} = "
        f"{cfg.num_layers} x {steps}; bf16 ids equal to greedy_generate's "
        f"for {same16} of {len(reqs)} requests (not gated); fp32 compute: "
        f"{sum(same32)} of {len(reqs)} equal, {n32} launches")
    if not all(same32) or n32 != c32.num_layers * eng32.steps:
        fail(f"(c) fp32 engine ids differ from greedy_generate's "
             f"({same32}) or launches {n32} != {c32.num_layers} x "
             f"{eng32.steps}")
    del p32, eng32, eng
    torch.cuda.empty_cache()

    mcfg = get_config("mamba2-130m")
    mp = init_params(mcfg, device=device, seed=0)
    ts.run_dense(mcfg, mp, **kw)                         # warm
    prompt, gen, wall, mon = ts.run_dense(mcfg, mp, **kw)
    total = kw["prompt_len"] + kw["max_new"]
    m_ms = 1e3 * wall / total
    m_bound = 1e3 * F.decode_hbm_bytes(mcfg, kw["requests"], total) \
        / HBM_BYTES_PER_S
    bd = mon.breakdown_j()
    log(f"(c) serve twin, mamba2-130m dense: {wall:.3f} s for {total} "
        f"steps of {kw['requests']} rows, {m_ms:.3f} ms a step "
        f"(decode_hbm_bytes / 3.35 TB/s = {m_bound:.4f} ms, "
        f"{m_ms / m_bound:.0f}x); monitor {mon.total_j:.3f} J [compute "
        f"{bd['compute']:.4f} | memory {bd['memory']:.4f} | static "
        f"{bd['static']:.4f}]")
    if tuple(gen.shape) != (kw["requests"], total) or not bool(
            (gen >= 0).all() and (gen < mcfg.vocab_size).all()):
        fail(f"(c) mamba2-130m ids of shape {tuple(gen.shape)} out of range")
    return launches, {"step_ms": step_ms, "bound_ms": bound_ms,
                      "mamba_ms": m_ms, "mamba_bound_ms": m_bound}


def fleet_carbon_sim():
    """(d) examples/torch_edge_carbon_sim.py at its defaults, for opt-125m
    and opt-1.3b, each policy run twice and held equal field for field;
    the offload table."""
    import dataclasses

    from repro_torch.configs.opt import opt_config
    tc = load_example("torch_edge_carbon_sim")
    out = {}
    for name in ("opt-125m", "opt-1.3b"):
        t0 = time.perf_counter()
        runs = [tc.compare_policies(opt_config(name), tc.example_fleet(),
                                    FLEET_SIM_STEPS) for _ in range(2)]
        dt = (time.perf_counter() - t0) / 2
        (blind, aware), again = runs
        if [dataclasses.asdict(r) for r in (blind, aware)] \
                != [dataclasses.asdict(r) for r in again]:
            fail(f"(d) {name}: a second run of the same SimConfig differs")
        if blind.steps_done != FLEET_SIM_STEPS \
                or aware.steps_done != FLEET_SIM_STEPS:
            fail(f"(d) {name}: steps done {blind.steps_done}, "
                 f"{aware.steps_done}")
        log(f"(d) carbon sim, {name}, {FLEET_SIM_STEPS} steps: blind "
            f"{blind.wall_time_s / 3600:.2f} h, {blind.carbon_kg * 1e3:.2f} "
            f"gCO2e; aware {aware.wall_time_s / 3600:.2f} h, "
            f"{aware.carbon_kg * 1e3:.2f} gCO2e; both policies in {dt:.2f} "
            f"s on the host; the second runs equal field for field")
        out[name] = dt
    tc.offload_table()
    return out


def fleet_scale():
    """(e) on the host: a 10^5-device fleet searched for opt-1.3b and its
    200-round churn sim, sync against async (quorum 0.9); at 10^4 devices
    the scalar and vectorized engines' trajectories, and the batched
    sync lanes against the scalar model."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.faultinject import FaultPlan
    from repro_torch.core.net import (NetParams, batched_sync_cost,
                                      synthetic_fleet, sync_cost)
    from repro_torch.core.placement import search_placement_fleet
    from repro_torch.core.sched.fleet_sim import FleetSim, FleetSimConfig
    cfg = get_config("opt-1.3b")
    # benchmarks/bench_fleet_scale.py's fault plan
    plan = FaultPlan(seed=7, straggler_frac=0.1,
                     straggler_slowdown=(4.0, 8.0), crash_prob=0.005,
                     rejoin_delay=(2, 5), link_flap_prob=0.05,
                     link_jitter_s=(0.5, 2.0))
    n, dp = FLEET_N, FLEET_N // 8
    fleet = synthetic_fleet(n, region_mix="shuffled", seed=0,
                            params=NetParams(wan_bw_Bps=5e6))
    t0 = time.perf_counter()
    best = search_placement_fleet(fleet, cfg, data_parallel=dp,
                                  batch=2 * dp, seq_len=2048,
                                  microbatches=4)
    search_s = time.perf_counter() - t0
    rr = best.search_stats["round_robin_step_time_s"]
    sim = dict(rounds=FLEET_ROUNDS, seed=2, leave_prob=0.01, join_prob=0.2,
               fault_plan=plan)
    t0 = time.perf_counter()
    sync = FleetSim(fleet, FleetSimConfig(mode="sync", **sim)).run()
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    asyn = FleetSim(fleet, FleetSimConfig(mode="async", quorum=0.9,
                                          **sim)).run()
    async_s = time.perf_counter() - t0
    log(f"(e) {n:,} devices: search_placement_fleet for opt-1.3b "
        f"{search_s:.3f} s ({best.strategy}, step {best.step_time_s:.2f} s "
        f"modelled against round-robin's {rr:.2f} s, ratio "
        f"{best.step_time_s / rr:.4f}); {FLEET_ROUNDS}-round churn sim sync "
        f"{sync_s:.2f} s, async q=0.9 {async_s:.2f} s on the host; modelled "
        f"wall sync/async {sync.wall_time_s / asyn.wall_time_s:.3f}x "
        f"(BENCH_fleet_scale.json's 10.06 s for search + sync sim at "
        f"opt-125m and 69.4x are a JAX-package run on a CPU, not the "
        f"port's)")
    if not best.step_time_s <= rr or not asyn.wall_time_s < sync.wall_time_s:
        fail("(e) the search lost to round-robin, or async to sync")

    f4 = synthetic_fleet(FLEET_PARITY_N, region_mix="shuffled", seed=0)
    sim4 = FleetSim(f4, FleetSimConfig(rounds=FLEET_PARITY_ROUNDS, seed=2,
                                       leave_prob=0.01, join_prob=0.2,
                                       fault_plan=plan))
    t0 = time.perf_counter()
    rv = sim4.run("vectorized")
    vec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rs = sim4.run("scalar")
    scalar_s = time.perf_counter() - t0
    mism = int(not rv.trajectory_equal(rs)) \
        + int(rv.region_busy_s != rs.region_busy_s) \
        + int(rv.wall_time_s != rs.wall_time_s)
    # every stage slot's DP group of the 10^4 fleet's placement, priced
    # at once and one by one through the scalar model
    b4 = search_placement_fleet(f4, cfg, data_parallel=FLEET_PARITY_N // 8,
                                batch=FLEET_PARITY_N // 4, seq_len=2048,
                                microbatches=4)
    S = b4.grid.shape[1]
    dev = b4.grid.T.ravel()
    grp = np.repeat(np.arange(S), b4.grid.shape[0])
    topo = f4.to_topology()
    lanes = 0
    t0 = time.perf_counter()
    for algo in ("ring", "hierarchical"):
        b = batched_sync_cost(f4, dev, grp, cfg.param_count() // S,
                              algorithm=algo, dtype_bytes=2)
        for g in range(S):
            rows = dev[grp == g]
            s = sync_cost(topo, [str(f4.node_names[r]) for r in rows],
                          cfg.param_count() // S, algorithm=algo,
                          dtype_bytes=2)
            i = b.group(g)
            mism += int(not (b.time_s[i] == s.time_s
                             and b.wire_bytes[i] == s.wire_bytes
                             and b.wan_bytes[i] == s.wan_bytes))
            sel = b.member_group == g
            for d, busy, byts in zip(b.member_device[sel], b.busy_s[sel],
                                     b.bytes_dev[sel]):
                name = str(f4.node_names[int(d)])
                mism += int(not (busy == s.per_device_busy_s[name]
                                 and byts == s.per_device_bytes[name]))
                lanes += 1
    lanes_s = time.perf_counter() - t0
    log(f"(e) {FLEET_PARITY_N:,} devices, {FLEET_PARITY_ROUNDS} rounds "
        f"(the JAX benchmark's 20 cut to {FLEET_PARITY_ROUNDS}): "
        f"vectorized engine "
        f"{vec_s:.3f} s, scalar {scalar_s:.2f} s ({scalar_s / vec_s:.1f}x); "
        f"batched sync lanes of {S} DP groups x 2 algorithms against the "
        f"scalar model, {lanes:,} member lanes, {lanes_s:.2f} s; "
        f"{mism} mismatches")
    if mism:
        fail(f"(e) {mism} mismatches between the batched and scalar paths")
    return {"search_s": search_s, "sync_s": sync_s, "async_s": async_s,
            "vec_s": vec_s, "scalar_s": scalar_s}


def phase_fleet(torch, np, device):
    """Phase 20: (a)-(c) the example twins on the card, (d)-(e) the
    scheduler and the fleet-scale control plane on the host.  Returns
    the launches of each kernel on the phase's path."""
    parts, launches = {}, {}
    for label, fn, args in (
            ("(a) quickstart", fleet_quickstart, (torch, np, device)),
            ("(b) diloco", fleet_diloco, (torch, np, device)),
            ("(c) serve", fleet_serve, (torch, np, device)),
            ("(d) carbon sim", fleet_carbon_sim, ()),
            ("(e) fleet scale", fleet_scale, ())):
        t0 = time.perf_counter()
        got = fn(*args)
        parts[label] = time.perf_counter() - t0
        if isinstance(got, tuple):
            for k, v in got[0].items():
                launches.setdefault(k, {})[label] = v
        torch.cuda.empty_cache()
    log("phase 20 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return launches



# --------------------------------------------------------------------------- #
# Phase 21: the DT-FM hybrid data + pipeline executor
# --------------------------------------------------------------------------- #

# (a) the fp32 gate: opt-1.3b width at 3 layers (4 until a slow host's
# whole run took 1,175 s of the 1,200), B x S tokens in MB microbatches
# over the non-uniform boundaries, on a 1 x 2 and a 2 x 2 (data, stage)
# mesh (2 rows a data rank, 1 a microbatch)
PIPE_GATE = dict(layers=3, batch=4, seq=2048, microbatches=2,
                 boundaries=[0, 2, 3], meshes=((1, 2), (2, 2)))
# (b) opt-1.3b at full width and depth, bf16, on 1 x 4 gloo ranks sharing
# the card: batch x seq tokens in microbatches, steps a run, uniform and
# then the heterogeneous fleet's split (three laptops and a phone, as in
# examples/decentralized_pipeline.py:108-116)
PIPE_TRAIN = dict(batch=4, seq=2048, microbatches=4, steps=4, stages=4)
# (c) examples/torch_decentralized_pipeline.py's run at its 14M geometry
# and defaults on a 2 x 2 mesh, 30 of its 200 steps (60 until a slow
# host's whole run took 1,175 s of the 1,200; its loss falls from about
# 8.9 to 4.5 in the first 20)
PIPE_EXAMPLE = dict(data=2, stages=2, steps=30, batch=8, seq=128,
                    microbatches=4)
# the pipeline's attention, one microbatch of (b): held and timed in
# phase 3 (the kernels line's shape for rows 2-4)
OPT_PIPE_FA = (1, 2048, 32, 32, 64, True, 0)


def pipe_gate(torch, np, device):
    """(a) The pipelined fp32 loss and every gradient leaf, gathered to
    rank 0, against the single-process ``forward_train`` with autograd on
    the card from the same weights (``init_params(seed=0)``) and batch, at
    phase 4's fp32 bars; then the 2 x 2 mesh against the 1 x 2 run."""
    import dataclasses
    import functools

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.distributed import pipeline as P
    from repro_torch.distributed import runtime
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw
    g = PIPE_GATE
    cfg = dataclasses.replace(get_config("opt-1.3b"), num_layers=g["layers"],
                              param_dtype="float32", compute_dtype="float32")
    nb = next(make_batch_fn(cfg, g["batch"], g["seq"], seed=0))
    ref_loss, ref = single_process_grads(torch, cfg, nb, device)
    ref_norm = float(adamw.global_norm(ref))
    runs = {}
    for data, stages in g["meshes"]:
        t0 = time.perf_counter()
        res = runtime.spawn([functools.partial(
            P.evaluate, cfg=cfg, batch=nb, num_microbatches=g["microbatches"],
            boundaries=g["boundaries"], seed=0, grads=True)],
            data=data, stages=stages, transport="gloo", device=device)
        out = res.values[0][0]
        runs[(data, stages)] = (out["loss"], tree_leaves(out["grads"]))
        n = g["layers"] * g["microbatches"] * data
        log(f"(a) {data} x {stages} mesh, boundaries {g['boundaries']}, "
            f"{g['batch']} x {g['seq']} tokens in {g['microbatches']} "
            f"microbatches a data rank: {time.perf_counter() - t0:.1f} s "
            f"the spawn; FA-2 launches {res.launches[0]} (expected {n} each)")
        if any(v != n for v in res.launches[0].values()):
            fail(f"(a) FA-2 launches {res.launches[0]} != {n} each")
        if len({v["loss"] for v in res.values[0]}) != 1:
            fail(f"(a) ranks report different losses: {res.values[0]}")
    one, two = (runs[m] for m in g["meshes"])
    grads_held(torch, "pipeline 1 x 2 vs single process", *one, ref_loss,
               ref)
    grads_held(torch, "pipeline 2 x 2 vs 1 x 2", *two, *one)
    log(f"(a) single-process grad norm {ref_norm:.6f}")


def single_process_steps(torch, cfg, opt_cfg, device, steps, batch, seq):
    """The single-process steps the pipeline must reproduce: the trainer's
    weights (``init_params(seed=0)``), batches (``make_batch_fn`` with
    seed 0) and step (``make_train_step``), one synchronised step at a
    time.  Returns (losses, pre-clip grad norms, host ms a step)."""
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    params = init_params(cfg, device=device, seed=0)
    opt = adamw.init_opt_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, attn_impl="kernel")
    data = make_batch_fn(cfg, batch, seq, seed=0)
    losses, norms, ms = [], [], []
    for _ in range(steps):
        b = {k: torch.from_numpy(v).to(device) for k, v in next(data).items()}
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, opt, mets = step_fn(params, opt, b)
        losses.append(float(mets["loss"]))
        norms.append(float(mets["grad_norm"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    del params, opt
    torch.cuda.empty_cache()
    return losses, norms, ms


def pipe_train(torch, np, device):
    """(b) Full-width opt-1.3b, bf16, on 1 x 4 gloo ranks: 4 steps uniform
    and 4 with the heterogeneous fleet's split, each step's loss and
    pre-clip grad norm within phase 4's bf16 bars of the single-process
    step on the same weights and batches, 384 launches of each FA-2
    kernel a run; the step's time split on every rank beside the DT-FM
    model of the same fleet."""
    import functools

    from repro_torch.configs import get_config
    from repro_torch.core.energy.devices import LAPTOP_M2PRO, SMARTPHONE_SD888
    from repro_torch.core.placement import ordered_placement
    from repro_torch.core.planner import dtfm
    from repro_torch.distributed import pipeline as P
    from repro_torch.distributed import runtime
    from repro_torch.optim import adamw
    t = PIPE_TRAIN
    cfg = get_config("opt-1.3b")
    S, MB, steps = t["stages"], t["microbatches"], t["steps"]
    opt_cfg = adamw.OptConfig(learning_rate=3e-4, warmup_steps=10,
                              decay_steps=steps)
    fleet = [LAPTOP_M2PRO] * (S - 1) + [SMARTPHONE_SD888]
    spec = ordered_placement(cfg, fleet)
    if spec.num_stages != S:
        fail(f"(b) the placement found {spec.num_stages} stages, not {S}")
    ref_losses, ref_norms, ref_ms = single_process_steps(
        torch, cfg, opt_cfg, device, steps, t["batch"], t["seq"])
    ref_step_ms = float(np.median(ref_ms[1:]))
    moves = [abs(b - a) for a, b in zip(ref_losses, ref_losses[1:])]
    tol = STEP_TOL["bfloat16"]
    log(f"(b) single-process steps, {steps} of {t['batch']} x {t['seq']}: "
        f"losses {ref_losses}, grad norms {ref_norms}, "
        f"{ref_step_ms:.1f} ms a step after the first (median); the loss "
        f"moves by {[f'{m:.4f}' for m in moves]} from step to step (the "
        f"loss bar {tol['loss']:.0e})")
    kw = dict(cfg=cfg, opt_cfg=opt_cfg, steps=steps, batch=t["batch"],
              seq_len=t["seq"], num_microbatches=MB, seed=0)
    t0 = time.perf_counter()
    res = runtime.spawn([functools.partial(P.train, **kw),
                         functools.partial(P.train, boundaries=spec.boundaries,
                                           **kw)],
                        stages=S, transport="gloo", device=device)
    log(f"(b) the spawn of {S} ranks and both runs: "
        f"{time.perf_counter() - t0:.1f} s")
    n = cfg.num_layers * MB * steps
    plans = {"uniform": dtfm.plan(cfg, [LAPTOP_M2PRO] * S, batch=t["batch"],
                                  seq_len=t["seq"], microbatches=MB),
             "non-uniform": dtfm.plan_placement(
                 cfg, spec, batch=t["batch"], seq_len=t["seq"],
                 microbatches=MB)}
    bubble = (S - 1) / (MB + S - 1)
    timing = {}
    for label, runs, launches, kernels in zip(
            ("uniform", "non-uniform"), res.values, res.launches,
            res.kernels):
        losses, norms = runs[0].losses, runs[0].grad_norms
        diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
        gdiffs = [abs(a - b) / b for a, b in zip(norms, ref_norms)]
        bounds = [r.layers for r in runs]
        log(f"(b) {label} split, layers {bounds} "
            f"({[b - a for a, b in bounds]} a stage): losses {losses}, "
            f"|diff| to the single process {[f'{d:.2e}' for d in diffs]} "
            f"(bound {tol['loss']:.0e}); grad norms {norms}, relative diff "
            f"{[f'{d:.2e}' for d in gdiffs]} (bound {tol['gnorm']:.0e}); "
            f"FA-2 launches {launches} (expected {n} each)")
        log(f"(b) {label}: FA-2 launches by instantiation {kernels}")
        if any(v != n for v in launches.values()):
            fail(f"(b) {label}: FA-2 launches {launches} != {n} each")
        if len(losses) != steps or not all(np.isfinite(losses)) or any(
                d > tol["loss"] for d in diffs):
            fail(f"(b) {label}: losses {losses} against the single "
                 f"process's {ref_losses}")
        if len(norms) != steps or not all(np.isfinite(norms)) or any(
                d > tol["gnorm"] for d in gdiffs):
            fail(f"(b) {label}: grad norms {norms} against the single "
                 f"process's {ref_norms}")
        if any(r.losses != losses or r.grad_norms != norms for r in runs):
            fail(f"(b) {label}: ranks report different losses or norms")
        after = slice(1, None)          # the steps after the first

        def med(xs):
            return float(np.median(xs[after]))
        per_rank = []
        for r, run in enumerate(runs):
            wall, ev = med(run.wall_ms), med(run.event_ms)
            copy, wait, ar = med(run.copy_ms), med(run.wait_ms), \
                med(run.allreduce_ms)
            n_copy = med(run.copies)
            per_rank.append(dict(wall_ms=wall, event_ms=ev, copy_ms=copy,
                                 copies=n_copy, wait_ms=wait,
                                 allreduce_ms=ar,
                                 busy_ms=wall - copy - wait - ar,
                                 peak_gb=run.peak_bytes / 1e9))
            log(f"(b) {label} rank {r} (layers {run.layers}): step wall "
                f"{wall:.1f} ms (CUDA events {ev:.1f}), busy "
                f"{wall - copy - wait - ar:.1f}, host staging {copy:.1f} ms "
                f"over {n_copy:.0f} copies ({copy / max(n_copy, 1):.2f} ms "
                f"a copy), blocked in send/recv {wait:.1f}, all-reduce "
                f"{ar:.1f}; peak {run.peak_bytes / 1e9:.2f} GB; wall by "
                f"step {[round(x, 1) for x in run.wall_ms]}")
        plan = plans[label]
        timing[label] = dict(step_ms=per_rank[0]["wall_ms"], ranks=per_rank,
                             model_s=plan.step_time_s,
                             model_bubble=plan.bubble_fraction)
        log(f"(b) {label}: {per_rank[0]['wall_ms']:.1f} ms a pipelined "
            f"step on rank 0 (median of steps 2-{steps}); schedule bubble "
            f"(S-1)/(MB+S-1) = {bubble:.4f}; dtfm model of the same fleet "
            f"{plan.step_time_s:.4f} s a step, bubble "
            f"{plan.bubble_fraction:.4f}; the single-process step "
            f"{ref_step_ms:.1f} ms.  {S} processes "
            "time-share one card without overlap: not a fleet's step")
    log(f"(b) boundaries: uniform {P.resolve_boundaries(cfg, S)}, the "
        f"heterogeneous fleet's {spec.boundaries} "
        f"({spec.layer_counts} layers a stage)")
    return {k: sum(l[k] for l in res.launches) for k in res.launches[0]}, \
        timing


def pipe_example(torch, np, device):
    """(c) examples/torch_decentralized_pipeline.py's ``run`` on a 2 x 2
    mesh: its loss check passes and it printed the plan the host computes
    for the same fleet."""
    import contextlib
    import io
    ex = load_example("torch_decentralized_pipeline")
    cfg = ex.model_config(14)
    e = PIPE_EXAMPLE
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = ex.run(cfg, device=device, **e)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    _, lines = ex.plan_report(cfg, data=e["data"], stages=e["stages"],
                              batch=e["batch"], seq=e["seq"],
                              microbatches=e["microbatches"])
    log(f"(c) example twin, {e}: {wall:.1f} s; its printout:\n"
        + text.rstrip())
    ex.check_learned(res.losses)
    if "\n".join(lines) not in text:
        fail("(c) the example's plan printout differs from the host's")
    if res.nonuniform_loss is None or not np.isfinite(res.nonuniform_loss):
        fail(f"(c) the non-uniform split did not run: {res.spec.boundaries}")
    n = cfg.num_layers * e["microbatches"] * e["data"] * e["steps"]
    if any(v != n for v in res.launches[0].values()):
        fail(f"(c) FA-2 launches {res.launches[0]} != {n} each")
    log(f"(c) FA-2 launches: training {res.launches[0]}, the non-uniform "
        f"forward {res.launches[1]}")
    return res.launches


def phase_pipeline(torch, np, device):
    """Phase 21: (a) the fp32 gate, (b) full-width opt-1.3b over four
    stage ranks, (c) the example twin.  Returns (b)'s launches summed
    over its two runs, and its timing."""
    parts = {}
    t0 = time.perf_counter()
    pipe_gate(torch, np, device)
    parts["(a) fp32 gate"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, timing = pipe_train(torch, np, device)
    parts["(b) full width"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pipe_example(torch, np, device)
    parts["(c) example"] = time.perf_counter() - t0
    log("phase 21 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return launches, timing

# --------------------------------------------------------------------------- #
# Phase 22: the production mesh (FSDP over data, tensor parallelism over
# model) on gloo ranks sharing the card
# --------------------------------------------------------------------------- #

# (a) the fp32 gate on a 2 x 2 (data, model) mesh: opt-1.3b width at 2 of
# 24 layers (4 until a slow host's whole run took 1,175 s of the 1,200),
# 4 x 2048 tokens; qwen2-7b width at 2 layers, 2 x 2048 (GQA 28 over 4
# with QKV bias: K/V head-parallel), one spawn
MESH_GATE = dict(mesh=(2, 2), opt_layers=2, opt_batch=4, qwen_layers=2,
                 qwen_batch=2, seq=2048)
# (b) full-width, full-depth opt-1.3b, bf16, through launch/train.py
# --mesh 2,2: steps of batch x seq
MESH_TRAIN = dict(mesh="2,2", steps=4, batch=4, seq=2048)
# one rank's attention on (b)'s path: its 2 rows and 16 of the 32 heads;
# held and timed in phase 3 (the kernels line's shape for rows 2-4)
OPT_TP_FA = (2, 2048, 16, 16, 64, True, 0)
# one rank's attention on phase 24 (b)'s path (the kernels line's shape
# for rows 2-4): its 1 row of phase 6's 2 x 2048 and 16 of the 32 heads
OPT_LS_FA = (1, 2048, 16, 16, 64, True, 0)


def grads_held(torch, label, got_loss, got, want_loss, want):
    """A loss and gradient leaves against the reference's at phase 4's
    fp32 bars: the loss and global norm within ``STEP_TOL["float32"]``,
    every leaf within ``FA_TOL``'s gradient bar of its largest value."""
    from repro_torch.optim import adamw
    tol = STEP_TOL["float32"]
    dl = abs(got_loss - want_loss)
    errs = [(float((a - b).abs().max()),
             FA_TOL["float32"]["grad"] * max(1.0, float(b.abs().max())))
            for a, b in zip(got, want)]
    dg = abs(float(adamw.global_norm(got)) - float(adamw.global_norm(
        want))) / float(adamw.global_norm(want))
    worst = max(e / b for e, b in errs)
    log(f"(a) {label}: loss {got_loss:.6f} vs {want_loss:.6f} (|diff| "
        f"{dl:.3e}, bound {tol['loss']:.0e}); grad norm relative diff "
        f"{dg:.3e} (bound {tol['gnorm']:.0e}); {len(errs)} leaves, "
        f"worst max_abs_err / bound {worst:.3f}")
    if not (dl <= tol["loss"] and dg <= tol["gnorm"] and worst <= 1.0):
        fail(f"(a) {label}: the fp32 loss or gradients disagree")


def single_process_grads(torch, cfg, nb, device):
    """(loss, gradient leaves on the CPU) of ``forward_train`` with
    autograd on the card, from ``init_params(seed=0)``."""
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params, tree_leaves
    params = init_params(cfg, device=device, seed=0)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = M.forward_train(params, cfg, {
        k: torch.from_numpy(v).to(device) for k, v in nb.items()})
    ref = [t.cpu() for t in torch.autograd.grad(loss, leaves)]
    out = float(loss.detach())
    del params, leaves, loss
    torch.cuda.empty_cache()
    return out, ref


def mesh_gate(torch, np, device):
    """(a) On a 2 x 2 (data, model) mesh of gloo ranks, the fp32 loss and
    every gradient leaf, gathered from the DTensor shards, against the
    single-process ``forward_train`` with autograd on the card from the
    same weights (``init_params(seed=0)``) and batch: opt-1.3b width at 2
    layers, and qwen2-7b width (GQA, QKV bias) at 2.  Returns the FA-2
    launches by call."""
    import dataclasses
    import functools

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.distributed import runtime, spmd
    from repro_torch.models.params import tree_leaves
    g = MESH_GATE
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    cases = [("opt-1.3b", g["opt_layers"], g["opt_batch"]),
             ("qwen2-7b", g["qwen_layers"], g["qwen_batch"])]
    cfgs, batches = [], []
    for arch, layers, batch in cases:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers, **fp32)
        cfgs.append(cfg)
        batches.append(next(make_batch_fn(cfg, batch, g["seq"], seed=0)))
    t0 = time.perf_counter()
    res = runtime.spawn(
        [functools.partial(spmd.evaluate, cfg=cfg, batch=nb, seed=0,
                           grads=True) for cfg, nb in zip(cfgs, batches)],
        shape=g["mesh"], names=("data", "model"), transport="host",
        device=device)
    log(f"(a) {g['mesh']} (data, model) mesh, host transport: "
        f"{time.perf_counter() - t0:.1f} s the spawn and both cases")
    ranks = g["mesh"][0] * g["mesh"][1]
    for (arch, layers, batch), cfg, nb, values, launches in zip(
            cases, cfgs, batches, res.values, res.launches):
        n = layers * ranks
        log(f"(a) {arch} width, {layers} layers, {batch} x {g['seq']} "
            f"tokens: FA-2 launches {launches} (expected {n} each: a layer "
            "a rank)")
        if any(v != n for v in launches.values()):
            fail(f"(a) {arch}: FA-2 launches {launches} != {n} each")
        if len({v["loss"] for v in values}) != 1:
            fail(f"(a) {arch}: ranks report different losses")
        t0 = time.perf_counter()
        got = tree_leaves(spmd.join_shards(values, cfg, g["mesh"],
                                           ("data", "model")))
        log(f"(a) {arch}: the ranks' gradient blocks joined on the host in "
            f"{time.perf_counter() - t0:.1f} s")
        ref_loss, ref = single_process_grads(torch, cfg, nb, device)
        grads_held(torch, f"{arch} width on the mesh vs single process",
                   values[0]["loss"], got, ref_loss, ref)
    return res.launches


def mesh_train(torch, np, device):
    """(b) Full-width, full-depth opt-1.3b, bf16, through ``python -m
    repro_torch.launch.train --full --arch opt-1.3b --mesh 2,2``: each
    step's loss and pre-clip grad norm within phase 4's bf16 bars of the
    single-process step on the same weights and batches, 384 launches of
    each FA-2 kernel, all the bf16 tensor-core instantiations, and each
    rank's step split by collective.  Returns (launches, per-rank
    timing)."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.optim import adamw
    t = MESH_TRAIN
    cfg = get_config("opt-1.3b")
    steps = t["steps"]
    opt_cfg = adamw.OptConfig(learning_rate=3e-4, warmup_steps=10,
                              decay_steps=steps)    # the launcher's
    ref_losses, ref_norms, ref_ms = single_process_steps(
        torch, cfg, opt_cfg, device, steps, t["batch"], t["seq"])
    ref_step_ms = float(np.median(ref_ms[1:]))
    tol = STEP_TOL["bfloat16"]
    argv = ["--arch", "opt-1.3b", "--full", "--mesh", t["mesh"],
            "--steps", str(steps), "--batch", str(t["batch"]),
            "--seq", str(t["seq"]), "--torch-device", device.type]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = launcher.main(argv)
    log(f"(b) python -m repro_torch.launch.train {' '.join(argv)}: "
        f"{time.perf_counter() - t0:.1f} s; its printout:\n"
        + buf.getvalue().rstrip())
    runs, launches, kernels = res.values[0], res.launches[0], res.kernels[0]
    ranks = len(runs)
    n = cfg.num_layers * steps * ranks
    losses, norms = runs[0].losses, runs[0].grad_norms
    diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
    gdiffs = [abs(a - b) / b for a, b in zip(norms, ref_norms)]
    log(f"(b) losses {losses}, single process {ref_losses}, |diff| "
        f"{[f'{d:.2e}' for d in diffs]} (bound {tol['loss']:.0e}); grad "
        f"norms {norms}, single process {ref_norms}, relative diff "
        f"{[f'{d:.2e}' for d in gdiffs]} (bound {tol['gnorm']:.0e}); "
        f"FA-2 launches {launches} (expected {n} each); by instantiation "
        f"{kernels}")
    if any(v != n for v in launches.values()):
        fail(f"(b) FA-2 launches {launches} != {n} each")
    if sum(kernels.values()) != 3 * n or any(
            "_tc_kernel<" not in k for k in kernels):
        fail(f"(b) not every launch was a bf16 tensor-core kernel: {kernels}")
    if len(losses) != steps or not all(np.isfinite(losses)) or any(
            d > tol["loss"] for d in diffs):
        fail(f"(b) losses {losses} against the single process's "
             f"{ref_losses}")
    if len(norms) != steps or not all(np.isfinite(norms)) or any(
            d > tol["gnorm"] for d in gdiffs):
        fail(f"(b) grad norms {norms} against the single process's "
             f"{ref_norms}")
    if any(r.losses != losses or r.grad_norms != norms for r in runs):
        fail("(b) ranks report different losses or norms")

    def med(xs):
        return float(np.median(xs[1:]))          # steps 2..
    per_rank = []
    for r, run in enumerate(runs):
        kinds = sorted({k for d in run.collective_ms for k in d})
        coll = {k: med([d.get(k, 0.0) for d in run.collective_ms])
                for k in kinds}
        calls = {k: med([d.get(k, 0) for d in run.collective_calls])
                 for k in kinds if k != "host_copy"}
        mb = {k: med([d.get(k, 0) for d in run.collective_bytes]) / 1e6
              for k in kinds if k != "host_copy"}
        per_rank.append(dict(step_ms=med(run.wall_ms),
                             busy_ms=med(run.busy_ms), collective_ms=coll,
                             peak_gb=run.peak_bytes / 1e9,
                             calls=run.collective_calls[1:],
                             bytes=run.collective_bytes[1:]))
        log(f"(b) rank {r} {tuple(run.coordinate)}: step "
            f"{med(run.wall_ms):.1f} ms (median of steps 2-{steps}), busy "
            f"{med(run.busy_ms):.1f} ms; collectives ms "
            + ", ".join(f"{k} {v:.1f}" for k, v in coll.items())
            + "; calls " + ", ".join(f"{k} {v:.0f}" for k, v in calls.items())
            + "; MB in " + ", ".join(f"{k} {v:.1f}" for k, v in mb.items())
            + f"; peak {run.peak_bytes / 1e9:.2f} GB; wall by step "
            f"{[round(x, 1) for x in run.wall_ms]}")
    log(f"(b) {per_rank[0]['step_ms']:.1f} ms a 2 x 2 step on rank 0 against "
        f"{ref_step_ms:.1f} ms for the single-process step.  Four processes "
        "time-share one card, their collectives staged through host "
        "memory: not four cards' step")
    return launches, per_rank


def phase_mesh(torch, np, device):
    """Phase 22: (a) the fp32 gate, (b) full-width opt-1.3b through the
    launcher's --mesh 2,2.  Returns (b)'s launches and timing."""
    parts = {}
    t0 = time.perf_counter()
    mesh_gate(torch, np, device)
    parts["(a) fp32 gate"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, timing = mesh_train(torch, np, device)
    parts["(b) full width"] = time.perf_counter() - t0
    log("phase 22 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return launches, timing


# --------------------------------------------------------------------------- #
# Phase 23: the dry run, on the CPU of the card's machine
# --------------------------------------------------------------------------- #

# (a) phase 22 (b)'s step on a fake group of phase 22's mesh
DRY_COUNT = dict(arch="opt-1.3b", mesh=(2, 2), batch=MESH_TRAIN["batch"],
                 seq=MESH_TRAIN["seq"])
# (b) one production case at full depth on the fake 16 x 16 group
DRY_CASE = ("qwen2-7b", "train_4k")
# the traces run in a child process whose address space is bounded: a
# trace that ran away would fail the child, not the machine
DRY_AS_BYTES = 32 << 30


def dry_trace(count, case):
    """In the child: (a)'s trace of ``count`` on a fake group of its mesh
    (its collectives and memory, and seconds), and (b)'s record of
    ``case`` at full depth on the fake 16 x 16 group with its seconds and
    the rule tables' parameter bytes a device."""
    import os
    import resource
    resource.setrlimit(resource.RLIMIT_AS, (DRY_AS_BYTES, DRY_AS_BYTES))
    # one core, yielded to the timed phases' processes when they want it
    os.nice(19)
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import InputShape
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import step_analysis as SA
    from repro_torch.launch.mesh import fake_mesh
    t0 = time.perf_counter()
    with fake_mesh(count["mesh"], ("data", "model")) as mesh:
        t = DR.trace_case(get_config(count["arch"]),
                          InputShape("phase 22", count["seq"],
                                     count["batch"], "train"),
                          mesh, remat="none", microbatches=1)
    out = {"coll": SA.collective_totals(t["counter"]),
           "memory": t["memory"], "count_s": time.perf_counter() - t0}
    arch, shape = case
    t0 = time.perf_counter()
    out["rec"] = DR.lower_case(arch, shape)
    out["case_s"] = time.perf_counter() - t0
    cfg = get_config(arch)
    out["want_param_bytes"] = SH.sharding_report(
        cfg, SH.AbstractMesh((16, 16), ("data", "model")),
        SH._param_rules(cfg, None))["param_bytes_per_device"]
    out["ended"] = time.time()
    return out


def dry_count(traced, mesh_timing):
    """(a) Phase 22 (b)'s step traced on a fake 2 x 2 group (chunked
    attention, which runs inside ``local_map`` as the kernels do and
    moves no bytes): its collectives, calls and bytes sent in by kind,
    against every step after the first of each of phase 22's ranks
    (both counted by ``runtime.CollectiveCount``)."""
    d = DRY_COUNT
    coll = traced["coll"]
    want = {"calls": coll["counts"], "bytes": coll["sent_bytes_by_op"]}
    log(f"(a) {d['arch']} {d['batch']} x {d['seq']} traced on a fake "
        f"{d['mesh']} group in {traced['count_s']:.1f} s: calls "
        f"{want['calls']}, bytes sent in {want['bytes']}, result bytes "
        f"{coll['bytes_by_op']}")
    if mesh_timing is None:
        fail("(a) compares with phase 22's ranks: run phase 22 in the same "
             "call")
    for r, rank in enumerate(mesh_timing):
        for step, (calls, sent) in enumerate(zip(rank["calls"],
                                                 rank["bytes"]), 2):
            got = {"calls": calls, "bytes": sent}
            if got != want:
                fail(f"(a) rank {r} step {step} of phase 22 moved {got}, "
                     f"the trace {want}")
    log(f"(a) equal to each of phase 22's {len(mesh_timing)} ranks' steps "
        f"2-{MESH_TRAIN['steps']}")


def dry_case(traced):
    """(b) ``DRY_CASE`` at full depth on the fake 16 x 16 group: its
    record, with the parameter bytes a device against the rule tables'
    report."""
    arch, shape = DRY_CASE
    rec = traced["rec"]
    log(f"(b) {arch} x {shape} on the fake 16 x 16 group in "
        f"{traced['case_s']:.1f} s (lower {rec['lower_s']} s, trace "
        f"{rec['compile_s']} s): " + json.dumps(rec))
    if rec["param_bytes_per_device"] != traced["want_param_bytes"]:
        fail(f"(b) {rec['param_bytes_per_device']} parameter bytes a device, "
             f"the rule tables {traced['want_param_bytes']}")
    if not (rec["hlo_flops_per_device"] > 0
            and rec["collectives"]["total_bytes"] > 0):
        fail("(b) the record counts no FLOPs or no collective bytes")


def start_dry_run():
    """Start phase 23's traces in one child process on the host's CPU
    (``dry_trace``, at the lowest priority, one thread): they need no
    card and nothing of phases 19-22, so they run while those phases do.
    Returns (pool, future, start time on the wall clock)."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(dry_trace, DRY_COUNT, DRY_CASE), time.time()


def phase_dryrun(torch, np, started, mesh_timing, spans):
    """Phase 23: (a) the fake 2 x 2 count against phase 22's ranks, (b)
    one production case, (c) (a)'s memory beside phase 22's peak, from
    the traces :func:`start_dry_run` started; and which phases (``spans``:
    phase -> wall-clock start and end) ran beside the child."""
    pool, future, t_start = started
    parts = {}
    t0 = time.perf_counter()
    try:
        traced = future.result()
    finally:
        pool.shutdown()
    parts["waiting for the child"] = time.perf_counter() - t0
    t_end = traced["ended"]
    beside = {n: min(b, t_end) - max(a, t_start)
              for n, (a, b) in sorted(spans.items())
              if a < t_end and b > t_start}
    log(f"(a)-(b) the child's traces took {traced['count_s']:.1f} + "
        f"{traced['case_s']:.1f} s, ending {t_end - t_start:.1f} s after the "
        "child started; it ran beside phases (s of each): " + ", ".join(
            f"{n} {v:.1f}" for n, v in beside.items()))
    dry_count(traced, mesh_timing)
    dry_case(traced)
    mem = traced["memory"]
    peaks = [r["peak_gb"] for r in mesh_timing]
    log(f"(c) the trace of (a): {mem['argument_bytes'] / 1e9:.2f} GB of "
        f"arguments and a {mem['temp_bytes'] / 1e9:.2f} GB temp peak a "
        f"rank ({(mem['argument_bytes'] + mem['temp_bytes']) / 1e9:.2f} GB "
        f"together); phase 22 measured peaks of {peaks} GB on its ranks "
        "(torch.cuda.max_memory_allocated: the kernels' attention, not the "
        "trace's chunked one; reported, not gated)")
    log("phase 23 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return traced["rec"]


# --------------------------------------------------------------------------- #
# Phase 24: local SGD on the mesh, its checkpoints and records
# --------------------------------------------------------------------------- #

# (a) the fp32 gate: opt-1.3b width at 2 layers on 2 x 2, phase 6's run
# (R, K, rounds, batch) at an eighth of its sequence (the fp32 vocab's
# gathers and scatters a step scale with it; a quarter until a slow
# host's whole run took 1,175 s of the 1,200); the resume spawn's mesh
MESH_LS_GATE = dict(mesh=(2, 2), layers=2, seq=256, resume_mesh=(1, 4))
# (b) phase 6's run at full width and depth, bf16, through the launcher's
# --mesh rank call
MESH_LS_TRAIN = dict(mesh="2,2")
# an int8 code that flips where the summation order differs moves the mean
# pseudo-gradient by up to one step of its block's scale a round; the
# outer step carries it into the parameters (outer_lr (1 + mu + mu**2))
# and the momentum (1 + mu), both under 1 + mu + mu**2 = 2.71; two rounds
INT8_FLIP = 2 * (1 + 0.9 + 0.81)


def mesh_compress_check(mesh, *, cfg, tc, ls, opt_cfg, device=None):
    """On a rank: replica 0's round-1 pseudo-gradient on the mesh, each
    leaf compressed through ``compress_leaf`` (int8 through the kernels
    on the rank's block) and through the plain versions of that block;
    sent values and errors must be equal.  Returns {"leaves", "worst",
    "equal"}."""
    import torch
    from repro_torch.distributed.act_sharding import use_mesh
    from repro_torch.optim.compress import blocks_whole, compress_leaf
    out = {"leaves": 0, "worst": 0.0, "equal": True}
    with use_mesh(mesh):
        for d in replica0_deltas(torch, cfg, tc, ls, opt_cfg, device, mesh):
            if not blocks_whole(tuple(d.shape), d.placements,
                                tuple(mesh.shape), ls.compress.block):
                fail(f"a leaf of {tuple(d.shape)} does not keep its int8 "
                     "blocks whole on a rank")
            sent, err = compress_leaf(d, None, ls.compress)
            x = d.to_local()
            ref, _ = int8_plain(torch, x, ls.compress.block)
            a, e = sent.to_local(), err.to_local()
            out["worst"] = max(out["worst"], float((a - ref).abs().max()),
                               float((e - (x - ref)).abs().max()))
            out["equal"] &= bool(torch.equal(a, ref)
                                 and torch.equal(e, x - ref))
            out["leaves"] += 1
    return out


def block_scales(torch, cfg, tc, ls, opt_cfg, device):
    """Each element's int8 step in the single process: the scale of its
    256-block of replica 0's round-1 pseudo-gradient, leaf by leaf (CPU)."""
    out = []
    for d in replica0_deltas(torch, cfg, tc, ls, opt_cfg, device):
        _, rs = int8_plain(torch, d, ls.compress.block)
        out.append(rs.repeat_interleave(ls.compress.block)[:d.numel()]
                   .reshape(d.shape).cpu())
    torch.cuda.empty_cache()
    return out


def state_held(torch, label, got, want, scales=None):
    """A joined outer state against the single process's (on the card),
    leaf by leaf on the card: within ``grads_held``'s bar (1e-4 of the
    leaf's largest magnitude, at least 1), plus ``INT8_FLIP`` steps of
    each element's block scale with int8.  Returns the worst error /
    bar."""
    from repro_torch.bridge import flatten
    worst, beyond, n = 0.0, 0, 0
    for i, ((key, a), (_, b)) in enumerate(zip(flatten(got), flatten(want))):
        b = b.float()
        diff = (a.to(b.device).float() - b).abs()
        bar = FA_TOL["float32"]["grad"] * max(1.0, float(b.abs().max()))
        beyond += int((diff > bar).sum())
        n += diff.numel()
        if scales is not None:
            bar = bar + INT8_FLIP * scales[i].to(b.device)
        ratio = diff / bar
        worst = max(worst, float(ratio.max()))
        if float(ratio.max()) > 1.0:
            fail(f"(a) {label}: {key} differs by {float(diff.max()):.3e}, "
                 "past its bar")
    log(f"(a) {label}: worst error / bar {worst:.3f}; {beyond} of {n:,} "
        "elements past the fp32 bar")
    return worst


def mesh_ls_gate(torch, np, device):
    """(a) At opt-1.3b width and 2 layers, fp32, on 2 x 2 ranks: phase 6's
    sync DiLoCo with no compression and with int8 against the single
    process, each rank's int8 of its blocks through the kernels against
    the plain versions, async (Q = R, S = 0) against sync bit for bit,
    and the round-1 checkpoint resumed on 1 x 4 and by one process."""
    import concurrent.futures
    import dataclasses
    import functools
    import shutil
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.distributed import runtime, spmd
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.local_sgd import train_local_sgd
    from repro_torch.train.trainer import _to_device
    g = MESH_LS_GATE
    names = ("data", "model")
    cfg = dataclasses.replace(get_config("opt-1.3b"),
                              num_layers=g["layers"],
                              param_dtype="float32", compute_dtype="float32")
    tc, int8, opt_cfg = local_sgd_configs(seq=g["seq"])
    plain = dataclasses.replace(int8, compress=None)
    tol = STEP_TOL["float32"]["loss"]
    with tempfile.TemporaryDirectory() as d:
        calls = {
            "none": dataclasses.replace(plain, checkpoint_dir=f"{d}/ck",
                                        checkpoint_every_rounds=1),
            "int8": int8,
            "async": dataclasses.replace(plain, async_mode=True)}
        calls = {k: functools.partial(spmd.local_sgd, cfg=cfg, tc=tc, ls=v,
                                      opt_cfg=opt_cfg)
                 for k, v in calls.items()}
        calls["compress"] = functools.partial(
            mesh_compress_check, cfg=cfg, tc=tc, ls=int8, opt_cfg=opt_cfg)
        t0 = time.perf_counter()
        res = runtime.spawn(list(calls.values()), shape=g["mesh"],
                            names=names, transport="host", device=device)
        out = dict(zip(calls, res.values))
        q8 = dict(zip(calls, res.quant8))
        log(f"(a) {g['mesh']} spawn of {list(calls)}: "
            f"{time.perf_counter() - t0:.1f} s; int8 launches by rank "
            f"{ {k: v[0] for k, v in q8.items()} }")
        # the round-1 checkpoint resumed on another mesh: its ranks start
        # while this process runs the single-process references
        shutil.copytree(f"{d}/ck/step_00000001", f"{d}/r1/step_00000001")
        resume = dataclasses.replace(plain, checkpoint_dir=f"{d}/r1",
                                     resume=True)
        one_round = dataclasses.replace(tc, steps=tc.steps // 2)
        pool = concurrent.futures.ThreadPoolExecutor(1)
        t0 = time.perf_counter()
        other_future = pool.submit(
            runtime.spawn,
            [functools.partial(spmd.local_sgd, cfg=cfg, tc=one_round,
                               ls=resume, opt_cfg=opt_cfg)],
            shape=g["resume_mesh"], names=names, transport="host",
            device=device)
        for key in ("none", "int8"):
            ls = calls[key].keywords["ls"]
            want = train_local_sgd(cfg, tc, dataclasses.replace(
                ls, checkpoint_dir=None, checkpoint_every_rounds=0),
                opt_cfg, device=device)
            runs = out[key]
            got = runs[0].result
            for r in runs[1:]:
                if (r.result.losses, r.result.round_losses) != (
                        got.losses, got.round_losses):
                    fail(f"(a) {key}: ranks report different losses")
            dl = max(abs(a - b) for a, b in zip(
                got.losses + got.round_losses,
                want.losses + want.round_losses))
            log(f"(a) sync {key}: mesh losses {got.losses}, round losses "
                f"{got.round_losses}; single process {want.losses}, "
                f"{want.round_losses}; |diff| {dl:.3e} (bound {tol:.0e})")
            if dl > tol or len(got.losses) != len(want.losses):
                fail(f"(a) sync {key}: losses disagree with one process")
            scales = None if key == "none" else block_scales(
                torch, cfg, tc, ls, opt_cfg, device)
            state_held(torch, f"sync {key} final params and momentum",
                       spmd.join_state(runs, cfg, g["mesh"], names),
                       want.outer_state, scales=None if scales is None
                       else scales + scales)
            del want
            torch.cuda.empty_cache()
        chk = out["compress"]
        if not all(c["equal"] for c in chk) or any(
                v != {"quantize_blocks": chk[0]["leaves"],
                      "dequantize_blocks": chk[0]["leaves"]}
                for v in q8["compress"]):
            fail(f"(a) a rank's int8 through the kernels differs from the "
                 f"plain version, or missed them: {chk} {q8['compress']}")
        log(f"(a) replica 0's round-1 pseudo-gradient, each rank's blocks of "
            f"its {chk[0]['leaves']} leaves: int8 through the kernels equal "
            "to the plain versions (worst difference "
            f"{max(c['worst'] for c in chk):.3e})")
        same = all(
            a.result.losses == s.result.losses
            and a.result.round_losses == s.result.round_losses
            and all(torch.equal(x, y) for k in ("params", "outer_m")
                    for x, y in zip(tree_leaves(a.state[k]),
                                    tree_leaves(s.state[k])))
            for a, s in zip(out["async"], out["none"]))
        log(f"(a) async (Q = R, S = 0) equals the mesh's sync run bit for "
            f"bit on every rank: {same}")
        if not same:
            fail("(a) async with Q = R, S = 0 differs from sync on the mesh")

        # ... and by one process
        single = train_local_sgd(cfg, one_round, resume, opt_cfg,
                                 device=device)
        try:
            other = other_future.result().values[0]
        finally:
            pool.shutdown()
        log(f"(a) {g['resume_mesh']} resume spawn: "
            f"{time.perf_counter() - t0:.1f} s from its start, beside the "
            "single-process references")
        saved = ckpt.restore(f"{d}/r1", single.outer_state, step=1)
        batch = _to_device(next(make_batch_fn(cfg, tc.batch, tc.seq_len,
                                              tc.seed)), device)
        with torch.no_grad():
            loss0 = float(M.forward_train(saved["params"], cfg, batch,
                                          attn_impl="kernel")[0])
        del saved
        got = other[0].result
        dl = max(abs(a - b) for a, b in zip(
            got.losses + got.round_losses,
            single.losses + single.round_losses))
        log(f"(a) round 2 resumed from the 2 x 2 round-1 checkpoint: "
            f"{g['resume_mesh']} mesh losses {got.losses}, one process "
            f"{single.losses} (|diff| {dl:.3e}); from round "
            f"{got.resumed_from_round} / {single.resumed_from_round}; the "
            f"first loss against the saved parameters' {loss0:.6f}; the "
            f"uninterrupted run's round 2 {out['none'][0].result.losses[2:]}"
            " (it kept its inner AdamW moments and data streams, which the "
            "checkpoint does not hold)")
        if not (dl <= tol and got.resumed_from_round == 1
                and single.resumed_from_round == 1
                and abs(single.losses[0] - loss0) <= tol
                and abs(got.losses[0] - loss0) <= tol):
            fail("(a) the resumed runs disagree or did not start from the "
                 "round-1 checkpoint")
        state_held(torch, "resumed final state, 1 x 4 against one process",
                   spmd.join_state(other, cfg, g["resume_mesh"], names),
                   single.outer_state)
    return q8


def mesh_ls_train(torch, np, device, ref):
    """(b) Phase 6's DiLoCo run at full width and depth, bf16, on 2 x 2
    ranks through the launcher's ``--mesh --local-sgd`` rank call, with
    int8 sync through a ``LocalSGDConfig`` built here, a checkpoint at
    round 2 and the trace, metrics, health and SLO records; against phase
    6's single-process run (``ref``).  Returns (launches summed over the
    ranks by wrapper, per-rank timing)."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path as P

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.distributed import spmd
    from repro_torch.launch import train as launcher
    from repro_torch.obs.validate import validate
    cfg = get_config("opt-1.3b")
    c = LOCAL_SGD
    rounds, names = c["rounds"], ("data", "model")
    shape = tuple(int(x) for x in MESH_LS_TRAIN["mesh"].split(","))
    ranks = shape[0] * shape[1]
    tol = STEP_TOL["bfloat16"]
    with tempfile.TemporaryDirectory() as d:
        tc, ls, opt_cfg = local_sgd_configs(
            checkpoint_dir=f"{d}/ck", checkpoint_every_rounds=rounds)
        recs = [f"{d}/trace.json", f"{d}/metrics.jsonl",
                f"{d}/health.jsonl"]
        argv = ["--arch", "opt-1.3b", "--full", "--mesh",
                MESH_LS_TRAIN["mesh"], "--local-sgd",
                "--replicas", str(c["R"]), "--inner-steps", str(c["K"]),
                "--steps", str(tc.steps), "--batch", str(c["batch"]),
                "--seq", str(c["seq"]), "--checkpoint-dir", f"{d}/ck",
                "--checkpoint-every", str(rounds), "--trace-out", recs[0],
                "--metrics-out", recs[1], "--health-out", recs[2],
                "--slo", "tokens_per_s=1", "--torch-device", device.type]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = launcher.train_on_mesh(launcher.parse_args(argv), ls=ls,
                                         opt_cfg=opt_cfg)
        wall = time.perf_counter() - t0
        log(f"(b) launcher.train_on_mesh({' '.join(argv)}, int8 sync with "
            f"error feedback, phase 6's AdamW): {wall:.1f} s; its "
            "printout:\n" + buf.getvalue().rstrip())
        runs = res.values[0]
        got = runs[0].result
        launches, kernels, q8 = res.launches[0], res.kernels[0], res.quant8[0]
        opt = res.adamw[0]
        n_fa = cfg.num_layers * c["R"] * c["K"] * rounds
        n_q = len(opt_leaf_sizes()) * c["R"] * rounds
        n_opt = len(opt_leaf_sizes()) * c["R"] * c["K"] * rounds
        diffs = [abs(a - b) for a, b in zip(got.losses + got.round_losses,
                                            ref["losses"]
                                            + ref["round_losses"])]
        log(f"(b) losses {got.losses}, round losses {got.round_losses}; "
            f"phase 6's {ref['losses']}, {ref['round_losses']}; |diff| "
            f"max {max(diffs):.3e} (bound {tol['loss']:.0e}); wire bytes a "
            f"round {got.sync_wire_bytes_per_round:,} (phase 6 "
            f"{ref['wire']:,}); FA-2 launches {launches} (predicted "
            f"{n_fa} a rank, {n_fa * ranks} in all), by instantiation "
            f"{kernels}; int8 launches by rank {q8} (predicted {n_q} each); "
            f"AdamW launches by rank {opt} (predicted {n_opt} each, one a "
            "rank's block of a leaf an inner step)")
        if len(got.losses) != len(ref["losses"]) or not all(
                np.isfinite(got.losses)) or max(diffs) > tol["loss"]:
            fail("(b) losses disagree with phase 6's single process")
        if got.sync_wire_bytes_per_round != ref["wire"]:
            fail("(b) wire bytes differ from phase 6's")
        if any(v != n_fa * ranks for v in launches.values()):
            fail(f"(b) FA-2 launches {launches} != {n_fa * ranks} each")
        if sum(kernels.values()) != 3 * n_fa * ranks or any(
                "_tc_kernel<" not in k for k in kernels):
            fail(f"(b) not every launch was a bf16 tensor-core kernel: "
                 f"{kernels}")
        if any(v != {"quantize_blocks": n_q, "dequantize_blocks": n_q}
               for v in q8):
            fail(f"(b) int8 launches by rank {q8}, predicted {n_q} each")
        if any(v != {"square_sums": n_opt, "adamw_update": n_opt}
               for v in opt):
            fail(f"(b) AdamW launches by rank {opt}, predicted {n_opt} each")
        if any((r.result.losses, r.result.round_losses)
               != (got.losses, got.round_losses) for r in runs):
            fail("(b) ranks report different losses")
        for p in recs:
            log(f"(b) {P(p).name}: {validate(p)}")
        t0 = time.perf_counter()
        joined = spmd.join_state(runs, cfg, shape, names)
        t_join = time.perf_counter() - t0
        step_dir = P(d) / "ck" / f"step_{rounds:08d}"
        nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
        t0 = time.perf_counter()
        back = ckpt.restore(f"{d}/ck", joined, step=rounds)
        t_restore = time.perf_counter() - t0
        from repro_torch.models.params import tree_leaves
        exact = all(torch.equal(a, b) for a, b in
                    zip(tree_leaves(back), tree_leaves(joined)))
        log(f"(b) checkpoint at round {rounds}: {nbytes / 1e9:.3f} GB in "
            f"{len(list(step_dir.iterdir()))} files; restored by one "
            f"process in {t_restore:.1f} s, equal to the ranks' joined "
            f"final state ({t_join:.1f} s to join) bit for bit: {exact}")
        if not exact:
            fail("(b) the checkpoint differs from the joined final state")
        del joined, back
    per_rank = []
    for r, run in enumerate(runs):
        n = max(run.result.outer_updates, 1)
        phase = {k: 1e3 * v / n for k, v in run.result.phase_s.items()}
        coll = {k: v / n for k, v in sorted(run.collective_ms.items())}
        per_rank.append(dict(round_ms=1e3 * run.wall_s / n, phase_ms=phase,
                             collective_ms=coll,
                             peak_gb=run.peak_bytes / 1e9))
        log(f"(b) rank {r} {tuple(run.coordinate)}: "
            f"{1e3 * run.wall_s / n:.1f} ms a round (host clock, the whole "
            "loop over its rounds); device ms a round: "
            + ", ".join(f"{k} {v:.1f}" for k, v in phase.items())
            + "; collectives ms a round: "
            + ", ".join(f"{k} {v:.1f}" for k, v in coll.items())
            + "; calls in the run " + ", ".join(
                f"{k} {v}" for k, v in sorted(run.collective_calls.items()))
            + f"; peak {run.peak_bytes / 1e9:.2f} GB")
    log(f"(b) rank 0 {per_rank[0]['round_ms']:.1f} ms a round against phase "
        f"6's {ref['round_ms']:.1f} ms for one process (four processes "
        "time-share one card, their collectives staged through host "
        "memory)")
    return launches, per_rank, q8, opt


def phase_mesh_local_sgd(torch, np, device, ref):
    """Phase 24: (a) the fp32 gate at 2 layers, (b) phase 6's run at full
    width on the 2 x 2 mesh through the launcher's rank call."""
    if ref is None:
        fail("phase 24 (b) compares with phase 6's run: run phase 6 in the "
             "same call")
    parts = {}
    t0 = time.perf_counter()
    mesh_ls_gate(torch, np, device)
    parts["(a) fp32 gate"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = mesh_ls_train(torch, np, device, ref)
    parts["(b) full width"] = time.perf_counter() - t0
    log("phase 24 wall time by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase numbers to run (phase 0, "
                         "the build, always runs); all by default.  A "
                         "partial run prints no kernels line and no final "
                         "JSON line")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({smi[0]})")
    wanted = (set(range(1, 26)) if args.phases is None
              else {int(x) for x in args.phases.split(",")})

    t0 = time.perf_counter()
    for name, out in build_all().items():
        info = [l.strip() for l in out.splitlines()
                if "registers" in l or "spill" in l]
        log(f"built {name}.cu: {' | '.join(info) or out.strip()}")
    log(f"build {time.perf_counter() - t0:.1f} s")

    got = {}
    walls = {}
    spans = {}

    def run(n, fn, *a):
        if n in wanted:
            t, t_wall = time.perf_counter(), time.time()
            got[n] = fn(*a)
            walls[n] = time.perf_counter() - t
            spans[n] = (t_wall, time.time())
            torch.cuda.empty_cache()

    timer = Timer(torch, device)
    run(1, phase_kernel, torch, device, timer)
    run(2, phase_engine, torch, np, device)
    run(3, phase_fa, torch, device, timer)
    run(5, phase_quant8, torch, device, timer)
    run(25, phase_adamw, torch, device, timer)
    del timer
    torch.cuda.empty_cache()
    run(4, phase_train, torch, np, device)
    run(6, phase_local_sgd, torch, np, device)
    run(7, phase_local_sgd_reduced, torch, np, device)
    timer = Timer(torch, device)
    run(8, phase_ssd, torch, device, timer)
    del timer
    run(9, phase_mamba, torch, np, device)
    run(10, phase_mixtral, torch, np, device)
    run(11, phase_mixtral_train, torch, np, device)
    run(12, phase_mamba_train, torch, np, device)
    run(13, phase_jamba, torch, np, device)
    run(14, phase_deepseek, torch, np, device)
    run(15, phase_deepseek_train, torch, np, device,
        got[3][1] if 3 in got else None)
    run(16, phase_granite, torch, np, device)
    run(17, phase_whisper, torch, np, device)
    run(18, phase_qwen2_vl, torch, np, device)
    dry = start_dry_run() if 23 in wanted else None
    run(19, phase_edge_fleet, torch, np, device)
    run(20, phase_fleet, torch, np, device)
    run(21, phase_pipeline, torch, np, device)
    run(22, phase_mesh, torch, np, device)
    run(23, phase_dryrun, torch, np, dry, got[22][1] if 22 in got else None,
        spans)
    run(24, phase_mesh_local_sgd, torch, np, device,
        got[6][2] if 6 in got else None)
    log("wall time by phase (s): " + ", ".join(
        f"{n} {walls[n]:.1f}" for n in sorted(walls)))
    log(f"phases took {sum(walls.values()):.1f} s in all")
    if wanted != set(range(1, 26)):
        log(f"partial run: phases {sorted(wanted)} passed")
        return 0

    # the kernels line: launches on this slice's path where a kernel lies
    # on it (phase 24 (b)'s full-width DiLoCo on the 2 x 2 mesh: the FA-2
    # kernels, timed at one rank's shape, and the quant8 kernels on each
    # rank's blocks), else on the newest path that runs it (phase 20's
    # example twins: flash-decode in the qwen2-7b serve twin; the SSD
    # scan: phase 13's jamba prefill); each row also keeps the earlier
    # paths' launches
    worst, timing = got[1]
    fa_worst, fa_timing = got[3]
    q_worst, q_timing = got[5]
    ls_launches, c_worst, _ = got[6]
    ssd_worst, ssd_timing = got[8]
    mixtral_train = got[11]
    deepseek_train = got[15]
    granite_train, granite_engine = got[16]
    whisper_train, whisper_prefill = got[17]
    qwen2_vl_train, qwen2_vl_prefill, qwen2_vl_engine = got[18]
    engine_launches, slo_launches = got[2]
    edge = got[19]
    fleet = got[20]
    pipe_launches, _ = got[21]
    mesh_launches, _ = got[22]
    mesh_ls_launches, _, mesh_ls_q8, mesh_ls_opt = got[24]
    mesh_ls_path = "opt-1.3b DiLoCo on the 2 x 2 mesh (phase 24 (b))"
    fleet_path = {"(a) quickstart": "opt-1.3b quickstart twin (phase 20)",
                  "(b) diloco": "opt-1.3b DiLoCo twin (phase 20)",
                  "(c) serve": "qwen2-7b serve twin (phase 20)"}

    def on_fleet(name):
        """(launches on phase 20's path, launches by its parts)."""
        parts = fleet.get(name, {})
        return (sum(parts.values()),
                {fleet_path[k]: v for k, v in parts.items()})
    fa = "src/repro/kernels/flash_attention/kernel.py"
    qwen2 = {k: v for k, v in timing.items()
             if k not in ("granite", "qwen2_vl")}
    decode_n, decode_by = on_fleet("flash_decode_paged")
    rows = [{"name": "flash_decode_paged", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_decode.cu",
             "replaces": "src/repro/kernels/flash_attention/decode.py:132",
             "launches": decode_n, "max_abs_err": worst, **qwen2,
             "shape": "qwen2-7b decode, B 8 x 2048 tokens, "
                      + str((H, K, D)),
             "at_qwen2_vl_2b": {"shape": str(QWEN2VL_DECODE),
                                **timing["qwen2_vl"]},
             "at_granite_3_2b": {"shape": str(GRANITE_DECODE),
                                 **timing["granite"]},
             "launches_by_path": {**decode_by,
                                  "qwen2-7b SLO-gated engine (phase 2)":
                                  slo_launches,
                                  "qwen2-vl-2b engine (phase 18)":
                                  qwen2_vl_engine,
                                  "granite-3-2b engine (phase 16)":
                                  granite_engine,
                                  "qwen2-7b engine (phase 2)":
                                  engine_launches,
                                  "mixtral-8x7b engine (phase 10)":
                                      got[10][0]}}]
    for name, kern, src, line in (
            ("flash_attention_fwd", "fwd", "flash_attn_fwd.cu", 86),
            ("flash_attention_bwd_dq", "dq", "flash_attn_bwd.cu", 191),
            ("flash_attention_bwd_dkdv", "dkdv", "flash_attn_bwd.cu", 234)):
        _, fleet_by = on_fleet(name)
        by_path = {mesh_ls_path: mesh_ls_launches[name],
                   "opt-1.3b (data, model) mesh, 2 x 2 (phase 22)":
                   mesh_launches[name],
                   "opt-1.3b DT-FM pipeline, 1 x 4 (phase 21)":
                   pipe_launches[name],
                   **fleet_by,
                   "opt-1.3b edge fleet, async local SGD (phase 19)":
                   edge[name],
                   "whisper-medium train, 8 steps (phase 17)":
                   whisper_train[name],
                   "qwen2-vl-2b train, 8 steps (phase 18)":
                   qwen2_vl_train[name],
                   "deepseek-v3-671b train, 4 steps (phase 15)":
                   deepseek_train[name],
                   "granite-3-2b train, 8 steps (phase 16)":
                   granite_train[name],
                   "mixtral-8x7b train, 4 steps (phase 11)":
                   mixtral_train[name],
                   "opt-1.3b train, 8 steps (phase 4)": got[4][name]}
        if kern == "fwd":
            by_path["whisper-medium prefill (phase 17)"] = whisper_prefill
            by_path["qwen2-vl-2b prefill (phase 18)"] = qwen2_vl_prefill
            by_path["deepseek-v3-671b prefill (phase 14)"] = got[14]
            by_path["mixtral-8x7b prefill (phase 10)"] = got[10][1]
            by_path["jamba prefill (phase 13)"] = \
                got[13]["flash_attention_fwd"]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}",
                     "replaces": f"{fa}:{line}",
                     "launches": mesh_ls_launches[name],
                     "max_abs_err": fa_worst[kern],
                     **fa_timing["opt_ls"][kern],
                     "shape": "opt-1.3b DiLoCo on the 2 x 2 mesh, one "
                              "rank's row and heads " + str(OPT_LS_FA),
                     "at_opt_1.3b_mesh_step": {
                         "shape": str(OPT_TP_FA),
                         **fa_timing["opt_tp"][kern]},
                     "at_opt_1.3b_pipeline_microbatch": {
                         "shape": str(OPT_PIPE_FA),
                         **fa_timing["opt_pipe"][kern]},
                     "at_opt_1.3b_edge_replica": {
                         "shape": str(OPT_EDGE_FA),
                         **fa_timing["opt_edge"][kern]},
                     "at_whisper_medium_encoder": {
                         "shape": str(WHISPER_FA),
                         **fa_timing["whisper"][kern]},
                     "at_whisper_cross_attention": {
                         "shape": str(WHISPER_XFA),
                         **fa_timing["whisper_cross"][kern]},
                     "at_qwen2_vl_2b": {"shape": str(QWEN2VL_FA),
                                        **fa_timing["qwen2_vl"][kern]},
                     "at_deepseek_v3_671b": {"shape": str(DEEPSEEK_FA),
                                             **fa_timing["deepseek"][kern]},
                     "at_mixtral_8x7b": {"shape": str(MIXTRAL_FA),
                                         **fa_timing["mixtral"][kern]},
                     "at_opt_1.3b": {"shape": str(OPT_FA),
                                     **fa_timing[kern]},
                     "launches_by_path": by_path})
    for name, kern, line in (("quantize_blocks", "quantize", 21),
                             ("dequantize_blocks", "dequantize", 30)):
        fleet_n, fleet_by = on_fleet(name)
        mesh_q8 = sum(r[name] for r in mesh_ls_q8)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/quant8.cu",
                     "replaces": f"src/repro/kernels/quant8/kernel.py:{line}",
                     "launches": mesh_q8,
                     "max_abs_err": max(q_worst, c_worst),
                     **q_timing["rank_block"][kern],
                     "shape": "a 2 x 2 mesh rank's block of opt-1.3b's "
                              "largest leaf, fp32, block 256 ("
                              f"{LARGEST_LEAF // 4} elements)",
                     "at_opt_1.3b_largest_leaf": {
                         "shape": f"{LARGEST_LEAF} fp32", **q_timing[kern]},
                     "launches_by_path": {
                         mesh_ls_path: mesh_q8,
                         "... of it by rank": [r[name] for r in mesh_ls_q8],
                         **fleet_by,
                         "opt-1.3b edge fleet, async local SGD (phase 19)":
                         edge[name],
                         "opt-1.3b local SGD (phase 6)": ls_launches[name]}})
    adamw_worst, adamw_unequal, adamw_timing = got[25]
    opt_leaf, granite_leaf = (adamw_timing[label] for label, _, _ in
                              ADAMW_LEAVES)
    rows.append({"name": "adamw_update", "route": "cuda",
                 "source": "src/repro_torch/csrc/adamw.cu",
                 "replaces": None,
                 "launches": ls_launches["adamw_update"],
                 **opt_leaf,
                 "max_ulps": max(adamw_worst, opt_leaf["max_ulps"]),
                 "unequal": adamw_unequal + opt_leaf["unequal"],
                 "shape": f"opt-1.3b's fc1 leaf, {ADAMW_LEAVES[0][1]} "
                          "parameters, bf16 p and g, fp32 moments",
                 "at_granite_3_2b_largest_leaf": {
                     "shape": f"{ADAMW_LEAVES[1][1]} parameters, bf16 p, "
                              "fp32 g, fp32 moments", **granite_leaf},
                 "launches_by_path": {
                     mesh_ls_path:
                     sum(r["adamw_update"] for r in mesh_ls_opt),
                     "... of it by rank, update and norm": mesh_ls_opt,
                     "opt-1.3b local SGD (phase 6)":
                     ls_launches["adamw_update"],
                     "... its norm kernel": ls_launches["square_sums"],
                     "opt-1.3b train, 8 steps (phase 4)":
                     got[4]["adamw_update"],
                     "... its norm kernel (phase 4)":
                     got[4]["square_sums"]}})
    mamba = {k: v for k, v in ssd_timing.items() if k != "jamba"}
    rows.append({"name": "ssd_scan", "route": "cuda",
                 "source": "src/repro_torch/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan/kernel.py:31",
                 "launches": got[13]["ssd_scan"],
                 "max_abs_err": ssd_worst, **ssd_timing["jamba"],
                 "shape": "jamba-v0.1-52b prefill " + str(JAMBA_SSD),
                 "at_mamba2_130m": {"shape": str(MAMBA_SSD[0]), **mamba},
                 "launches_by_path": {"jamba prefill (phase 13)":
                                      got[13]["ssd_scan"],
                                      "mamba2-130m prefill (phase 9)":
                                      got[9]}})
    print(json.dumps({"kernels": rows}))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
