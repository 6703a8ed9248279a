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
   version, SDPA over the gathered K/V, and the HBM bound;
2. serve qwen2-7b at full width and depth in bf16 (random weights from a
   seed) through ``ServeEngine`` with the kernel, check that every request
   completes and that every attention layer of every step launched the
   kernel, and compare one mixed decode/prefill step's logits between the
   kernel and the plain gather path;
3. hold the three FA-2 kernels (forward, dq, dk/dv) against their plain
   PyTorch versions in fp32 and bf16 on the JAX package's FA_CASES shapes,
   MLA's head widths (qk 96 / v 64 and 192 / 128), a width the wrappers
   zero-pad, and opt-1.3b's attention shape, and time kernel, plain
   version, SDPA (forward, and its backward for the dq + dk/dv pair) and
   the bound at opt-1.3b's shape; the bf16 forward, dq and dk/dv must
   execute more than the fp32 CUDA cores' 67 TFLOP/s (they run on the
   tensor cores);
4. train opt-1.3b at full width and depth in bf16 (4 x 2048 tokens, random
   weights from a seed) through ``repro_torch.train.trainer.train`` with
   the kernels for 8 steps, check the losses and that every attention
   layer of every step launched each kernel once, compare one step's loss
   and gradient norm between the kernels and the plain chunked path (bf16
   and fp32 compute), and profile one step;
5. hold the int8 quantize/dequantize kernels against their plain
   versions (codes, scales and values equal) on the JAX package's quant8
   cases, ragged tails, an all-zero block, bf16 input and opt-1.3b's
   largest leaf, and time kernel, plain version, ``torch.mul`` and the
   bound there;
6. train opt-1.3b at full width through
   ``repro_torch.train.local_sgd.train_local_sgd``: 2 replicas x 4 inner
   steps of 2 x 2048 tokens, 2 rounds, int8-compressed pseudo-gradients
   with error feedback, sync priced over examples/diloco_edge.py's
   two-region topology; check the losses, the launches of every kernel
   and the wire bytes, and the compressed round-1 pseudo-gradient against
   the plain version;
7. at opt-1.3b width and 2 layers, check that async with quorum =
   replicas and staleness 0 equals sync, and that a run checkpointed
   every round restores and resumes from exactly what it saved;
8. hold the SSD-scan kernels against their plain version in fp32 and
   bf16 on the JAX package's SSD_CASES, a ragged case and mamba2-130m's
   shape at 8 x 4096 and 8 x 4000 tokens, check that a call issues its
   three kernels and no other device operation, and time the whole call
   (``ms``), its three kernels alone (``device_ms``), the plain version
   and the bound at 8 x 4096;
9. serve mamba2-130m at full width and depth in bf16 (random weights from
   a seed): (a) ``serve.step.make_prefill`` over 8 x 4096 tokens through
   the kernels — finite logits, 24 calls a forward, tokens/s, peak
   memory, the scan kernels' share of device time, and the logits against the
   ``ssd_reference`` path in bf16 and fp32; (b) ``greedy_generate`` of 8
   prompts of 64 tokens + 32 new ones through the dense cache; (c) with
   fp32 weights, ``decode_step`` token by token against the kernel
   prefill's logits at every position of 2 x 300 tokens.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit from ``nvidia-smi``; before that a
``{"kernels": [...]}`` line.  Needs CUDA and the repository around it.
"""

from __future__ import annotations

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
# tokens
FA_CASES = [(2, 256, 4, 2, 64, True, 0), (1, 384, 4, 4, 128, True, 0),
            (2, 256, 8, 2, 64, True, 128), (1, 200, 2, 1, 64, False, 0),
            (1, 130, 2, 2, 96, True, 0), (2, 100, 4, 2, 32, False, 0, 230),
            (2, 200, 4, 2, 96, True, 0, None, 64),
            (2, 512, 16, 16, 192, True, 0, None, 128),
            (1, 160, 4, 2, 80, True, 0)]
OPT_FA = (4, 2048, 32, 32, 64, True, 0)
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
# the kernels a call launches, by a part of each name: flash-decode's
# split kernel, and its merge kernel when a call has more than one split;
# the SSD scan's three when s spans more than one chunk
DECODE_KERNELS = ("flash_decode_split", "flash_decode_merge")
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

def make_pages(torch, lens, C, dtype, device, seed):
    """Disjoint shuffled block tables over a pool holding each sequence's
    live pages; table entries past them point at the null page 0."""
    from repro_torch.kernels.quant8.ops import quantize_kv
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


def live_bytes(lens, C, dtype, q):
    """Bytes a call must move: every live K/V token (and int8 scale) read
    once, q read once, the fp32 output (q's shape) written once."""
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

    # timing at B=8 sequences x 2048 tokens, bf16 decode
    lens = [2048] * B
    q, kp, vp, bt, sl, _ = make_pages(torch, lens, 1, "bfloat16", device,
                                      seed=99)
    call = lambda: flash_decode_paged(q, kp, vp, bt, sl)  # noqa: E731
    ms = timer.ms(call)
    log(f"kernel_ms spread over 20 calls: min {timer.spread[0]:.4f} "
        f"max {timer.spread[1]:.4f}")
    pps, splits = decode_splits(B, K, bt.shape[1], sms)
    device_ms = timer.device_ms(call, DECODE_KERNELS[:1 + (splits > 1)])
    log(f"one call ({splits} splits of {pps} pages, {sms} SMs): its "
        f"kernels (launches seen a call, ms a launch) "
        + "; ".join(f"{k} x{n:g} {t:.4f}" for k, n, t in timer.kernels)
        + f"; other device operations {timer.others}")
    if timer.others:
        fail(f"a flash_decode_paged call issued more than its two kernels: "
             f"{timer.others}")
    plain_ms = timer.ms(lambda: paged_attention_reference(q, kp, vp, bt, sl))
    kd = kp[bt.long()].reshape(B, -1, K, D).transpose(1, 2)
    vd = vp[bt.long()].reshape(B, -1, K, D).transpose(1, 2)
    kd = kd.repeat_interleave(H // K, dim=1).contiguous()
    vd = vd.repeat_interleave(H // K, dim=1).contiguous()
    qd = q.to(torch.bfloat16)[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = timer.ms(lambda: sdpa(qd, kd, vd))
    nbytes = live_bytes(lens, 1, "bfloat16", q)
    flops = 2 * 2 * D * H * sum(lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    timing = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"timing B={B} x 2048 tokens bf16 decode: kernel_ms {ms:.4f} "
        f"(the whole call) device_ms {device_ms:.4f} (its kernels alone, "
        f"profiler) plain_ms {plain_ms:.4f} library_ms(SDPA on gathered "
        f"K/V) {library_ms:.4f} bound_ms {timing['bound_ms']:.4f} "
        f"({nbytes/1e6:.2f} MB, bound by {timing['bound_by']}); "
        f"{nbytes / device_ms / 1e6:.0f} GB/s over the kernels' time")

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


def mixed_step_diff(torch, np, M, params, cfg, device):
    """One mixed step (decode slots, prefill chunks, an idle slot) from
    identical pages through the kernel and the plain gather path, in the
    serving dtype (bf16) and with the weights upcast to fp32 (pages stay
    bf16).  Returns {compute dtype: max |logits(kernel) - logits(gather)|}
    and the largest |logit|."""
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
        return logits.float()

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
    if lk.shape != (B, cfg.padded_vocab_size) or \
            not bool(torch.isfinite(lk[live]).all()):
        fail(f"mixed-step logits malformed: {tuple(lk.shape)}")
    lg = step(feeds, "gather", twin())
    diffs["bfloat16"] = float((lk[live] - lg[live]).abs().max())
    peak = float(lk[live].abs().max())
    del lk, lg
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    lk = step(feeds, "kernel", twin(), p32, cfg32)
    lg = step(feeds, "gather", twin(), p32, cfg32)
    diffs["float32"] = float((lk[live] - lg[live]).abs().max())
    del p32
    torch.cuda.synchronize()
    return diffs, peak, feeds


def profile_run(torch, eng, reqs, step_ms):
    """Device time by kernel over a profiled engine run of the same
    requests (torch.profiler; the timed run is not profiled).  The
    device's idle share compares device time per step with the unprofiled
    run's wall time per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    from repro_torch.kernels.flash_attention.decode import flash_decode_paged
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import (EngineConfig, Request,
                                          ServeEngine)

    cfg = get_config("qwen2-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in _leaves(params))
    log(f"qwen2-7b full width: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.param_count():,} params, {nbytes/1e9:.2f} GB bf16, "
        f"init {time.perf_counter() - t0:.2f} s")
    ecfg = EngineConfig(max_slots=B, block_size=BS, num_blocks=512,
                        max_blocks_per_seq=16, attn_impl="kernel",
                        cache_dtype="bfloat16", prefill_chunk=8)
    eng = ServeEngine(params, cfg, ecfg, torch_device=device)
    t0 = time.perf_counter()
    eng.warmup()
    system, reqs = engine_requests(cfg, np)
    # a server that has served the system prompt before holds it in its
    # prefix cache; prime it so the shared requests hit
    eng.run([Request(uid="prime", prompt=system, max_new=1)])
    eng.reset_stats()
    log(f"warmup + prefix priming {time.perf_counter() - t0:.1f} s")

    flash_decode_paged.launches = 0
    out = eng.run(reqs)
    launches = flash_decode_paged.launches
    s = eng.stats()
    n_attn = cfg.num_layers
    log(f"engine run: {int(s['tokens_generated'])} tokens, "
        f"{int(s['steps'])} steps, {eng.wall_s:.3f} s, "
        f"{s['tokens_per_s']:.1f} tokens/s, peak KV "
        f"{s['peak_cache_bytes']/1e6:.2f} MB of {s['pool_bytes']/1e6:.1f} MB "
        f"pool, prefix hit tokens {int(s['prefix_hit_tokens'])}, "
        f"TTFT p50 {s.get('ttft_p50_s', float('nan'))*1e3:.1f} ms")
    log(f"flash_decode_paged launches {launches} = {n_attn} x "
        f"{eng.steps} steps? {launches == n_attn * eng.steps}")
    if set(out) != {r.uid for r in reqs} or any(
            len(out[r.uid].tokens) != 16 or out[r.uid].failed for r in reqs):
        fail("not every request completed with 16 tokens")
    if launches != n_attn * eng.steps or launches == 0:
        fail(f"kernel launches {launches} != {n_attn} x {eng.steps} steps")
    if s["prefix_hit_tokens"] <= 0:
        fail("no prefix hits on the shared system prompt")

    # the same requests again through a fresh engine, under the profiler
    step_ms = eng.wall_s / eng.steps * 1e3
    del eng
    eng = ServeEngine(params, cfg, ecfg, torch_device=device)
    eng.warmup()
    eng.run([Request(uid="prime", prompt=system, max_new=1)])
    eng.reset_stats()
    profile_run(torch, eng, engine_requests(cfg, np)[1], step_ms)
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


# FLOP a kernel executes per FLOP of the function, in bf16 at D = Dv: the
# forward multiplies P as two bf16 halves (3 products where 2 are
# counted), dq dS (4 where 3 are counted), dk/dv P and dS (6 where 4 are)
FA_EXECUTED = {"fwd": 1.5, "dq": 4 / 3, "dkdv": 1.5}


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
    for i, case in enumerate(FA_CASES + [OPT_FA]):
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

    # timing at opt-1.3b's shape, bf16, as the train step calls them
    q, k, v, do = fa_tensors(torch, OPT_FA, torch.bfloat16, device, seed=99)
    out, lse = FK.flash_attention_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = sdpa(qg, kg, vg, is_causal=True)
    calls = {
        "fwd": (lambda: FK.flash_attention_fwd(q, k, v),
                lambda: FK.attention_fwd_plain(q, k, v),
                lambda: sdpa(q, k, v, is_causal=True)),
        "dq": (lambda: FK.flash_attention_bwd_dq(q, k, v, do, lse, delta),
               lambda: FK.attention_bwd_dq_plain(q, k, v, do, lse, delta),
               lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do,
                                           retain_graph=True)),
        "dkdv": (lambda: FK.flash_attention_bwd_dkdv(q, k, v, do, lse,
                                                     delta),
                 lambda: FK.attention_bwd_dkdv_plain(q, k, v, do, lse,
                                                     delta),
                 None),
    }
    work = fa_work(OPT_FA, q, k, v, do)
    timing = {}
    for kern, (kfn, pfn, lfn) in calls.items():
        ms = timer.ms(kfn)
        spread = timer.spread
        plain_ms = timer.ms(pfn)
        library_ms = timer.ms(lfn) if lfn else timing["dq"]["library_ms"]
        flops, nbytes = work[kern]
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        timing[kern] = {"ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms,
                        "bound_ms": max(t_ops, t_bytes),
                        "bound_by": "operations" if t_ops >= t_bytes
                        else "bytes"}
        log(f"timing {kern} at opt-1.3b shape {OPT_FA} bf16: kernel_ms "
            f"{ms:.4f} (min {spread[0]:.4f} max {spread[1]:.4f}) plain_ms "
            f"{plain_ms:.4f} library_ms {library_ms:.4f} "
            f"({'SDPA backward, dq+dk+dv together' if kern != 'fwd' else 'SDPA forward'}) "
            f"bound_ms {timing[kern]['bound_ms']:.4f} ({flops:.3e} FLOP, "
            f"{nbytes/1e6:.1f} MB; bound by {timing[kern]['bound_by']}); "
            f"{flops / ms / 1e9:.1f} TFLOP/s counted, "
            f"{FA_EXECUTED[kern] * flops / ms / 1e9:.1f} TFLOP/s executed")
        if FA_EXECUTED[kern] * flops / ms * 1e3 <= FP32_FLOP_PER_S:
            fail(f"the bf16 {kern} kernel executed no more than the fp32 "
                 f"CUDA cores' {FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s: it is "
                 "not running on the tensor cores")
    bwd_ms = timing["dq"]["ms"] + timing["dkdv"]["ms"]
    log(f"backward at opt-1.3b shape: dq + dk/dv {bwd_ms:.4f} ms vs SDPA's "
        f"whole backward {timing['dq']['library_ms']:.4f} ms "
        f"({bwd_ms / timing['dq']['library_ms']:.2f}x)")
    log("FA-2 kernels held against their plain versions: worst "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst, timing


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
        kind = ("FA-2 kernels" if any(w in key for w in (
                    "fa_fwd_kernel<", "fa_fwd_tc_kernel<",
                    "fa_bwd_dq_kernel<", "fa_bwd_dq_tc_kernel<",
                    "fa_bwd_dkdv_kernel<", "fa_bwd_dkdv_tc_kernel<")) else
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
    torch.cuda.reset_peak_memory_stats()
    for f in kernels:
        f.launches = 0
    res = train(cfg, TrainerConfig(steps=steps, batch=Bt, seq_len=St,
                                   attn_impl="kernel", seed=0),
                device=device)
    launches = {f.__name__: f.launches for f in kernels}
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
    log(f"FA-2 launches {launches}, expected {cfg.num_layers} x {steps} = "
        f"{n} each")
    if len(res.losses) != steps or not all(np.isfinite(res.losses)):
        fail(f"non-finite or missing losses: {res.losses}")
    if any(v != n for v in launches.values()):
        fail(f"FA-2 kernel launches {launches} != {n} each")
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


def phase_quant8(torch, device, timer):
    from repro_torch.kernels.quant8 import ops
    from repro_torch.kernels.quant8.kernel import (dequantize_blocks,
                                                   quantize_blocks)
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

    # opt-1.3b's largest leaf, fp32 as the pseudo-gradient path gives it
    n, block = LARGEST_LEAF, 256
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
    log(f"timing quantize at the largest leaf (N={n}, block {block}, fp32): "
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
    log(f"timing dequantize at the largest leaf: kernel_ms {ms:.4f} (min "
        f"{spread[0]:.4f} max {spread[1]:.4f}) plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} (torch.mul(q.view(rows, block), "
        f"s[:, None])) bound_ms {timing['dequantize']['bound_ms']:.4f} "
        f"({nbytes / 1e9:.3f} GB, bound by bytes); "
        f"{nbytes / ms / 1e6:.0f} GB/s achieved")
    log(f"quant8 kernels held against their plain versions: worst "
        f"difference {worst:.3e}")
    return worst, timing


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


def compress_check(torch, cfg, tc, ls, opt_cfg, device):
    """Replica 0's round-1 pseudo-gradient, recomputed from the same seed,
    through compress_leaf (the kernels) and through the plain versions on
    the card: sent values and new errors must be equal leaf for leaf."""
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels.quant8.ref import dequantize_reference
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import compress_leaf
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import _to_device
    glob = init_params(cfg, device=device, seed=tc.seed)
    work = tree_map(lambda t: t.clone(), glob)
    step = make_train_step(cfg, opt_cfg, attn_impl="kernel")
    opt = adamw.init_opt_state(work, opt_cfg)
    data = make_batch_fn(cfg, tc.batch, tc.seq_len, tc.seed)
    for _ in range(ls.inner_steps):
        work, opt, _ = step(work, opt, _to_device(next(data), device))
    del opt
    worst, n = 0.0, 0
    with torch.no_grad():
        for gl, wl in zip(tree_leaves(glob), tree_leaves(work)):
            d = gl.float() - wl.float()
            sent, err = compress_leaf(d, None, ls.compress)
            rq, rs = quant_plain(torch, d.reshape(-1), 256)
            ref = dequantize_reference(rq, rs)[:d.numel()].reshape(d.shape)
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


def phase_local_sgd(torch, np, device):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.quant8.kernel import (dequantize_blocks,
                                                   quantize_blocks)
    from repro_torch.bridge import flatten
    from repro_torch.models.params import model_spec
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import CompressConfig
    from repro_torch.train.local_sgd import LocalSGDConfig, train_local_sgd
    from repro_torch.train.trainer import TrainerConfig

    cfg = get_config("opt-1.3b")
    R, K, rounds, Bt, St = 2, 4, 2, 2, 2048
    tc = TrainerConfig(steps=K * rounds, batch=Bt, seq_len=St,
                       attn_impl="kernel", log_every=K, seed=0)
    ls = LocalSGDConfig(replicas=R, inner_steps=K, outer_lr=0.7,
                        outer_momentum=0.9,
                        compress=CompressConfig(method="int8"))
    opt_cfg = adamw.OptConfig(learning_rate=3e-3, warmup_steps=5,
                              decay_steps=tc.steps)
    sizes = [int(np.prod(s.shape)) for _, s in flatten(model_spec(cfg))]
    wire = sum(n + 4 * (n // 256 + 1) for n in sizes)
    log(f"local SGD, opt-1.3b full width: {len(sizes)} leaves, "
        f"{sum(sizes):,} params; R={R} replicas x K={K} inner steps of "
        f"{Bt} x {St} tokens, {rounds} rounds; int8 sync with error "
        f"feedback, Nesterov outer step (lr 0.7, momentum 0.9), "
        f"hierarchical allreduce over two regions at 4 MB/s WAN")
    kernels = (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
               FK.flash_attention_bwd_dkdv, quantize_blocks,
               dequantize_blocks)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels:
        f.launches = 0
    t0 = time.perf_counter()
    res = train_local_sgd(cfg, tc, ls, opt_cfg, topology=edge_topology(),
                          sync_algorithm="hierarchical", device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in kernels}
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
    log(f"launches {launches}; expected quant8 {len(sizes)} x {R} x "
        f"{rounds} = {n_q} each, FA-2 {cfg.num_layers} x {R} x {K} x "
        f"{rounds} = {n_fa} each")
    if len(res.losses) != K * rounds or not all(
            np.isfinite(res.losses + res.round_losses)):
        fail(f"non-finite or missing losses: {res.losses} "
             f"{res.round_losses}")
    if any(launches[f.__name__] != n_q for f in kernels[3:]) or any(
            launches[f.__name__] != n_fa for f in kernels[:3]):
        fail(f"launches {launches} are not {n_q} (quant8) and {n_fa} "
             "(FA-2) each")
    if res.sync_wire_bytes_per_round != wire:
        fail(f"sync wire bytes {res.sync_wire_bytes_per_round} != {wire}")
    del res
    torch.cuda.empty_cache()
    worst = compress_check(torch, cfg, tc, ls, opt_cfg, device)
    torch.cuda.empty_cache()
    return launches, worst


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
    for i, case in enumerate(SSD_CASES + MAMBA_SSD):
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

    # timing at mamba2-130m's prefill shape, bf16, as the model calls it
    case = MAMBA_SSD[0]
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
    log(f"timing SSD scan at mamba2-130m's shape {case} bf16: kernel_ms "
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
    log(f"SSD kernel held against its plain version: worst max_abs_err "
        f"{worst:.3e}")
    return worst, timing


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
    profile_fn(torch, gen, gen_ms / steps, steps, "ssd_")

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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
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
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    for name, out in build_all().items():
        info = [l.strip() for l in out.splitlines()
                if "registers" in l or "spill" in l]
        log(f"built {name}.cu: {' | '.join(info) or out.strip()}")
    log(f"build {time.perf_counter() - t0:.1f} s")

    timer = Timer(torch, device)
    worst, timing = phase_kernel(torch, device, timer)
    torch.cuda.empty_cache()
    launches = phase_engine(torch, np, device)
    torch.cuda.empty_cache()
    fa_worst, fa_timing = phase_fa(torch, device, timer)
    q_worst, q_timing = phase_quant8(torch, device, timer)
    del timer
    torch.cuda.empty_cache()
    fa_launches = phase_train(torch, np, device)
    torch.cuda.empty_cache()
    ls_launches, c_worst = phase_local_sgd(torch, np, device)
    phase_local_sgd_reduced(torch, np, device)
    torch.cuda.empty_cache()
    timer = Timer(torch, device)
    ssd_worst, ssd_timing = phase_ssd(torch, device, timer)
    del timer
    ssd_launches = phase_mamba(torch, np, device)

    fa = "src/repro/kernels/flash_attention/kernel.py"
    rows = [{"name": "flash_decode_paged", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_decode.cu",
             "replaces": "src/repro/kernels/flash_attention/decode.py:132",
             "launches": launches, "max_abs_err": worst, **timing}]
    for name, kern, src, line in (
            ("flash_attention_fwd", "fwd", "flash_attn_fwd.cu", 86),
            ("flash_attention_bwd_dq", "dq", "flash_attn_bwd.cu", 191),
            ("flash_attention_bwd_dkdv", "dkdv", "flash_attn_bwd.cu", 234)):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}",
                     "replaces": f"{fa}:{line}",
                     "launches": fa_launches[name],
                     "max_abs_err": fa_worst[kern], **fa_timing[kern]})
    for name, kern, line in (("quantize_blocks", "quantize", 21),
                             ("dequantize_blocks", "dequantize", 30)):
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/quant8.cu",
                     "replaces": f"src/repro/kernels/quant8/kernel.py:{line}",
                     "launches": ls_launches[name],
                     "max_abs_err": max(q_worst, c_worst),
                     **q_timing[kern]})
    rows.append({"name": "ssd_scan", "route": "cuda",
                 "source": "src/repro_torch/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan/kernel.py:31",
                 "launches": ssd_launches, "max_abs_err": ssd_worst,
                 **ssd_timing})
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
