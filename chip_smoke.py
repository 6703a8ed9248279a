#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits nonzero):

0. build every CUDA kernel in ``src/repro_torch/csrc`` with ``nvcc``;
1. hold the flash-decode kernel against its plain PyTorch version
   (``paged_attention_reference``) at qwen2-7b's attention shapes — ragged
   lengths, decode and chunked-prefill rows, fp32/bf16/int8 pages, a
   sliding window — and time kernel, plain version, SDPA over the gathered
   K/V, and the HBM bound;
2. serve qwen2-7b at full width and depth in bf16 (random weights from a
   seed) through ``ServeEngine`` with the kernel, check that every request
   completes and that every attention layer of every step launched the
   kernel, and compare one mixed decode/prefill step's logits between the
   kernel and the plain gather path.

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
H, K, D, BS, B = 28, 4, 128, 16, 8  # qwen2-7b attention; 8 engine slots
TOL = {"float32": 2e-5, "bfloat16": 1e-4, "int8": 1e-4}
LOGITS_TOL = 5e-2                  # the repo's int8/bf16 logits bar


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


def live_bytes(lens, C, dtype, q, m_bytes):
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    per_tok = K * 2 * (D * item + (4 if dtype == "int8" else 0))
    toks = sum(L + C - 1 for L in lens if L + C - 1 > 0)
    return toks * per_tok + q.numel() * 4 + m_bytes


def phase_kernel(torch, device, timer):
    from repro_torch.kernels.flash_attention.decode import (
        DEFAULT_PAGES_PER_SPLIT, flash_decode_paged,
        paged_attention_reference)
    ragged = [0, 1, BS, BS * DEFAULT_PAGES_PER_SPLIT, 2048, 17,
              BS * DEFAULT_PAGES_PER_SPLIT + 1, 1000]
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
    ms = timer.ms(lambda: flash_decode_paged(q, kp, vp, bt, sl))
    log(f"kernel_ms spread over 20 calls: min {timer.spread[0]:.4f} "
        f"max {timer.spread[1]:.4f}")
    plain_ms = timer.ms(lambda: paged_attention_reference(q, kp, vp, bt, sl))
    kd = kp[bt.long()].reshape(B, -1, K, D).transpose(1, 2)
    vd = vp[bt.long()].reshape(B, -1, K, D).transpose(1, 2)
    kd = kd.repeat_interleave(H // K, dim=1).contiguous()
    vd = vd.repeat_interleave(H // K, dim=1).contiguous()
    qd = q.to(torch.bfloat16)[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = timer.ms(lambda: sdpa(qd, kd, vd))
    nb = bt.shape[1]
    splits = -(-nb // min(DEFAULT_PAGES_PER_SPLIT, nb))
    part_bytes = B * K * splits * (H // K) * (2 + D) * 4
    nbytes = live_bytes(lens, 1, "bfloat16", q, part_bytes)
    flops = 2 * 2 * D * H * sum(lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"timing B={B} x 2048 tokens bf16 decode: kernel_ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms(SDPA on gathered K/V) "
        f"{library_ms:.4f} bound_ms {timing['bound_ms']:.4f} "
        f"({nbytes/1e6:.1f} MB, bound by {timing['bound_by']})")

    # an engine-shaped chunked-prefill call: 8 slots, C=8, ~128 tokens
    elens = [16, 48, 32, 64, 80, 96, 112, 128]
    q, kp, vp, bt, sl, _ = make_pages(torch, elens, 8, "bfloat16", device,
                                      seed=98)
    eng_ms = timer.ms(lambda: flash_decode_paged(q, kp, vp, bt, sl))
    log(f"timing engine-shaped chunk (C=8, lens {elens}): kernel_ms "
        f"{eng_ms:.4f}")
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
    del timer
    torch.cuda.empty_cache()
    launches = phase_engine(torch, np, device)

    print(json.dumps({"kernels": [{
        "name": "flash_decode_paged", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_attention/decode.py:132",
        "launches": launches, "max_abs_err": worst, **timing}]}))
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
