"""The port on the card: the CUDA flash-decode, FA-2, quant8 and SSD-scan
kernels against their plain PyTorch versions, the engine through the
kernel against the engine through the plain gather path, a train step
through the FA-2 kernels against one through the chunked path, local SGD
with int8-compressed sync through the kernels, Mamba2's kernel
prefill against its oracle path and its dense decode, the MoE layer
on the card against the CPU, two mixtral-smoke train steps on the
card against the same steps on the CPU, full-width mixtral's routes and
gradients under remat, deepseek-smoke's train steps and dense decode,
whisper-smoke's and qwen2-vl-smoke's train steps on the card against
the CPU, and the edge fleet's control loop: the engine's SLO admission
gate, a layer-sliced checkpoint of card tensors restored onto another
stage split, and async local SGD whose health monitor excludes the same
straggler on the card as on the CPU, the DT-FM pipeline on two gloo
ranks sharing the card against the single-process loss and gradients,
the production mesh (FSDP + tensor parallelism) on four, and the AdamW
norm and update kernels against the plain loop.
Every test here skips without CUDA.

The file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.adamw import kernel as AK  # noqa: E402
from repro_torch.kernels.adamw import ref as AR  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    flash_decode_paged, paged_attention_reference)
from repro_torch.kernels.quant8 import kernel as QK  # noqa: E402
from repro_torch.kernels.quant8 import ref as QR  # noqa: E402
from repro_torch.kernels.quant8.ops import quantize_kv  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402
from repro_torch.models.params import init_params, tree_leaves  # noqa: E402
from repro_torch.serve.engine import (EngineConfig, Request,  # noqa: E402
                                      ServeEngine)

# H, K, D, bs, lens, window, C, int8 — the JAX package's DECODE_CASES,
# then chunked-prefill rows, int8 pages, qwen2-7b's group g=7, and slots
# with seq_len = 0
CASES = [
    (4, 2, 64, 8, (17, 40), 0, 1, False),
    (4, 4, 32, 4, (1, 26), 0, 1, False),
    (8, 2, 64, 16, (33, 64), 20, 1, False),
    (2, 1, 16, 4, (5, 12), 5, 1, False),
    (4, 2, 32, 4, (3, 9, 14), 0, 4, False),
    (4, 2, 32, 4, (7, 20), 6, 4, True),
    (7, 1, 32, 4, (5, 18), 0, 1, True),
    (14, 2, 32, 8, (11, 30), 0, 4, False),
    (4, 2, 32, 4, (0, 13), 0, 1, False),
    (4, 2, 32, 4, (0, 9), 0, 4, True),
]
IDS = ["gqa", "mha-fresh", "gqa-window", "window<block", "chunk4",
       "chunk4-int8-window", "g7-int8", "g7-chunk4", "empty-slot",
       "empty-slot-chunk4-int8"]


# B, S, H, K, D, causal, window[, T[, Dv]] — the JAX package's FA_CASES
# (tests/test_kernels.py): GQA g=2 and 4, a 128 window, non-causal S=200,
# S=130 with head_dim 96; then non-causal with T != S and head_dim 32.
# T None or absent is S, Dv absent is D
FA_CASES = [
    (2, 256, 4, 2, 64, True, 0),
    (1, 384, 4, 4, 128, True, 0),
    (2, 256, 8, 2, 64, True, 128),
    (1, 200, 2, 1, 64, False, 0),
    (1, 130, 2, 2, 96, True, 0),
    (2, 100, 4, 2, 32, False, 0, 230),
]
FA_IDS = ["gqa2", "mha-d128", "gqa4-window", "noncausal-200", "d96-s130",
          "cross-t230-d32"]
# on the card also opt-1.3b's attention at 4 x 2048 tokens (the train
# step's shape), a GQA case at head_dim 128 with S not a multiple of 64
# (dk/dv's 32-row query tiles, a ragged last tile), MLA's widths (qk 96,
# v 64 as in deepseek-v3-671b-smoke, here with GQA and a ragged S; qk 192,
# v 128 at full width), and widths the kernels take zero-padded (80 -> 96;
# 48/40 -> 64/64, non-causal with T != S), and mixtral-8x7b's training
# attention (H 32, K 8, D 128) at 1 x 1024 tokens with a window of 384
# that cuts in, as its 4096 window does at 8192 tokens; whisper-medium's
# cross-attention (16 heads x 64, non-causal, S != T) at 130 decoder rows
# over its 1500 encoder frames (a ragged last key tile), and Qwen2-VL's
# GQA group 6 (12 query heads over 2 KV heads, D 128) at a ragged S
CARD_FA_CASES = FA_CASES + [(4, 2048, 32, 32, 64, True, 0),
                            (2, 333, 8, 2, 128, True, 0),
                            (2, 200, 4, 2, 96, True, 0, None, 64),
                            (1, 300, 2, 2, 192, True, 0, None, 128),
                            (1, 160, 4, 2, 80, True, 0),
                            (1, 100, 2, 1, 48, False, 0, 150, 40),
                            (1, 1024, 32, 8, 128, True, 384),
                            (2, 130, 16, 16, 64, False, 0, 1500),
                            (1, 333, 12, 2, 128, True, 0)]
CARD_FA_IDS = FA_IDS + ["opt-1.3b", "gqa4-d128-s333", "mla-smoke-96-64",
                        "mla-192-128", "padded-80", "padded-48-40-cross",
                        "mixtral-gqa4-d128-window",
                        "whisper-cross-s130-t1500-d64",
                        "qwen2-vl-gqa6-d128-s333"]


# (N, block): the JAX package's quant8 cases (tests/test_kernels.py), then
# row counts its 256-row TPU tile does not divide (304 rows) and ragged
# tails (N not a multiple of block)
QUANT_CASES = [(65536, 256), (512 * 512, 512), (1 << 16, 128),
               (304 * 256, 256), (100 * 777, 256), (3 * 5 * 7, 256),
               (1000, 128)]
QUANT_IDS = ["n64k-b256", "n256k-b512", "n64k-b128", "rows304",
             "ragged-100x777", "ragged-105", "ragged-1000-b128"]
SHAPES = [(100, 777), (3, 5, 7), (65536,)]


def quant_input(n, seed=4):
    """numpy fp32 (n,) with the JAX cases' spread (normal x 3)."""
    return np.random.RandomState(seed).randn(n).astype(np.float32) * 3


# b, s, h, g, p, n, chunk — the JAX package's SSD_CASES
# (tests/test_kernels.py), a ragged s with g=2 and p=n=128 (the largest
# shared-memory footprint, which shrinks the row tile), and mamba2-130m's
# head shape at a short length
SSD_CASES = [(2, 256, 4, 1, 64, 32, 64), (1, 128, 8, 2, 32, 128, 32),
             (2, 100, 4, 4, 64, 16, 32), (1, 512, 2, 1, 128, 64, 128),
             (1, 300, 4, 2, 128, 128, 128), (2, 390, 24, 1, 64, 128, 128)]
SSD_IDS = ["g1-c64", "g2-n128", "g4-ragged100", "p128-c128",
           "ragged300-p128-n128", "mamba2-130m-s390"]
# on the card also mamba2-130m's prefill at 8 x 4000 tokens (chip_smoke's
# ragged MAMBA_SSD shape: 31 full chunks and one of 32 rows), and
# jamba-v0.1-52b's mixer (128 heads, p 64, state 16, chunk 128) at
# 2 x 700 tokens (five full chunks and one of 60 rows)
CARD_SSD_CASES = SSD_CASES + [(8, 4000, 24, 1, 64, 128, 128),
                              (2, 700, 128, 1, 64, 16, 128)]
CARD_SSD_IDS = SSD_IDS + ["mamba2-130m-8x4000", "jamba-p64-n16-s700"]


def ssd_inputs(b, s, h, g, p, n, seed=0):
    """numpy fp32 x, dt = softplus(normal), A = -exp(normal), B, C."""
    rs = np.random.RandomState(seed)
    return (rs.randn(b, s, h, p).astype(np.float32),
            np.logaddexp(rs.randn(b, s, h), 0).astype(np.float32),
            -np.exp(rs.randn(h)).astype(np.float32),
            rs.randn(b, s, g, n).astype(np.float32),
            rs.randn(b, s, g, n).astype(np.float32))


def fa_widths(case):
    """(T, Dv) of an FA case: T defaults to S, Dv to D."""
    S, D = case[1], case[4]
    T = case[7] if len(case) > 7 and case[7] is not None else S
    return T, (case[8] if len(case) > 8 else D)


def fa_inputs(case, seed=0):
    """numpy fp32 q (B,S,H,D), k (B,T,K,D), v (B,T,K,Dv) and an output
    cotangent (B,S,H,Dv)."""
    B, S, H, K, D = case[:5]
    T, Dv = fa_widths(case)
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, H, D).astype(np.float32),
            rs.randn(B, T, K, D).astype(np.float32),
            rs.randn(B, T, K, Dv).astype(np.float32),
            rs.randn(B, S, H, Dv).astype(np.float32))


def inputs(H, K, D, bs, lens, C, quant, seed=0):
    """numpy q, pages, shuffled disjoint block tables, lengths, scales."""
    rs = np.random.RandomState(seed)
    B = len(lens)
    nb = -(-(max(lens) + C - 1) // bs)
    P = B * nb + 1
    q = rs.randn(B, C, H, D).astype(np.float32)
    if C == 1:
        q = q[:, 0]
    kf = rs.randn(P, bs, K, D).astype(np.float32)
    vf = rs.randn(P, bs, K, D).astype(np.float32)
    bt = (1 + rs.permutation(B * nb)).astype(np.int32).reshape(B, nb)
    sl = np.asarray(lens, np.int32)
    scales = {}
    if quant:
        kq, ks = quantize_kv(torch.from_numpy(kf))
        vq, vs = quantize_kv(torch.from_numpy(vf))
        kf, vf = kq.numpy(), vq.numpy()
        scales = dict(k_scale=ks.numpy(), v_scale=vs.numpy())
    return q, kf, vf, bt, sl, scales


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cuda_kernel_matches_plain_version(case, cuda):
    H, K, D, bs, lens, window, C, quant = case
    q, kp, vp, bt, sl, sc = inputs(H, K, D, bs, lens, C, quant)
    dev = [torch.from_numpy(x).to(cuda) for x in (q, kp, vp, bt, sl)]
    dsc = {k: torch.from_numpy(v).to(cuda) for k, v in sc.items()}
    before = flash_decode_paged.launches
    out = flash_decode_paged(*dev, window=window, pages_per_split=3, **dsc)
    torch.cuda.synchronize()
    assert flash_decode_paged.launches == before + 1
    ref = paged_attention_reference(*dev, window=window, **dsc)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


# many more pages than splits: the planner's split count (from the
# shapes alone) leaves each split dozens of pages, several stages of the
# kernel's cp.async ring; H, K, D, bs, lens, window, C, int8 as in CASES
LONG_CASES = [(28, 4, 128, 16, (2048, 1999, 17, 0, 1500, 700, 33, 2047),
               0, 1, False),
              (8, 4, 64, 8, (3000, 2900, 1, 2999, 100, 2500, 1234, 5),
               0, 8, True),
              (28, 4, 128, 16, (2048, 1024, 512, 2000, 64, 1800, 900, 3),
               300, 8, False)]
LONG_IDS = ["qwen2-decode-bf16", "chunk8-int8-bs8", "chunk8-window300"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LONG_CASES, ids=LONG_IDS)
def test_cuda_kernel_many_pages_a_split(case, cuda):
    from repro_torch.kernels.flash_attention.decode import decode_splits
    H, K, D, bs, lens, window, C, quant = case
    q, kp, vp, bt, sl, sc = inputs(H, K, D, bs, lens, C, quant)
    dev = [torch.from_numpy(x).to(cuda) for x in (q, kp, vp, bt, sl)]
    dev[2] = dev[2].to(torch.bfloat16) if not quant else dev[2]
    dev[1] = dev[1].to(torch.bfloat16) if not quant else dev[1]
    dsc = {k: torch.from_numpy(v).to(cuda) for k, v in sc.items()}
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pps, splits = decode_splits(len(lens), K, bt.shape[1], sms)
    assert bt.shape[1] >= 8 * splits and pps >= 8
    out = flash_decode_paged(*dev, window=window, **dsc)
    ref = paged_attention_reference(*dev, window=window, **dsc)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


def _decode_call(lens, C):
    """A flash_decode_paged call at the engine's shape (B 8, H 28, K 4,
    D 128, bf16 pages, block 16) over sequences of ``lens`` tokens."""
    q, kp, vp, bt, sl, _ = inputs(28, 4, 128, 16, tuple(lens), C, False)
    dev = torch.device("cuda")
    q = torch.from_numpy(q).to(dev)
    kp, vp = (torch.from_numpy(x).to(dev, torch.bfloat16) for x in (kp, vp))
    bt, sl = torch.from_numpy(bt).to(dev), torch.from_numpy(sl).to(dev)
    return lambda: flash_decode_paged(q, kp, vp, bt, sl)


def _width_inputs(D, Dv):
    """q (2, 3, 8, D) fp32, bf16 pages with K 2 heads of widths D and Dv,
    block 16, over sequences of 70 and 5 tokens, on the card."""
    rs = np.random.RandomState(7)
    B, C, H, K, bs, nb = 2, 3, 8, 2, 16, 6
    dev = torch.device("cuda")
    q = torch.from_numpy(rs.randn(B, C, H, D).astype(np.float32)).to(dev)
    kp = torch.from_numpy(rs.randn(B * nb + 1, bs, K, D).astype(
        np.float32)).to(dev, torch.bfloat16)
    vp = torch.from_numpy(rs.randn(B * nb + 1, bs, K, Dv).astype(
        np.float32)).to(dev, torch.bfloat16)
    bt = torch.from_numpy((1 + rs.permutation(B * nb)).astype(
        np.int32).reshape(B, nb)).to(dev)
    sl = torch.tensor([70, 5], dtype=torch.int32, device=dev)
    return q, kp, vp, bt, sl


def _profile_one_call(builder, args):
    """{"ops": [(name, launches)] of every device operation the profiler
    sees in one call of ``builder(*args)``'s call, "kernels": the
    flash-decode split kernel's launches by instantiation over the
    session's two calls}, after a first call that builds, loads and warms
    its kernels; the second call is the session's warm-up step, since the
    profiler can lose the records of the launches made as a session
    starts tracing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    call = globals()[builder](*args)
    call()
    torch.cuda.synchronize()
    before = flash_decode_paged.kernels.copy()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            call()
            torch.cuda.synchronize()
            prof.step()
    return {"ops": [(e.key, e.count) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.key.startswith("ProfilerStep")],
            "kernels": dict(flash_decode_paged.kernels - before)}


def profiled_kernels(builder, *args):
    """``_profile_one_call(builder, args)`` in a fresh interpreter: in one
    process with other profiled checks, a one-call session without a
    warm-up step has seen no kernel, so each runs in a process of its
    own."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    here = Path(__file__).resolve().parent
    path = [str(here.parent / "src"), str(here),
            os.environ.get("PYTHONPATH", "")]
    code = ("import json, test_torch_cuda as T; print(json.dumps("
            f"T._profile_one_call({builder!r}, {list(args)!r})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                             p for p in path if p)))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("lens,C", [((2048,) * 8, 1), ((5,) * 8, 8),
                                    ((2048,) * 8, 8)],
                         ids=["decode-2048", "one-split", "chunk8-2048"])
def test_cuda_decode_call_is_at_most_two_kernels(lens, C, cuda):
    """One flash_decode_paged call at the engine's shape (B 8, H 28, K 4,
    D 128, bf16 pages) runs the split kernel (the instantiation the
    library reports, once a call) and, with more than one split, the
    merge kernel, and no other device operation: the profiler, which can
    lose a launch's record but not add one, sees at most those two
    kernels over the call and nothing else."""
    seen = profiled_kernels("_decode_call", list(lens), C)
    ops, ran = seen["ops"], seen["kernels"]
    assert len(ran) == 1 and sum(ran.values()) == 2, ran
    assert next(iter(ran)).startswith("flash_decode_split"), ran
    assert sum(c for _, c in ops) <= 2, ops
    assert all("flash_decode" in k for k, _ in ops), ops


@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv,kernel", [
    (128, 128, "flash_decode_split_tc_kernel<1, 128>"),
    (64, 32, "flash_decode_split_tc_kernel<1, 64>"),
    (192, 128, "flash_decode_split_kernel<__nv_bfloat16, 2>")])
def test_cuda_bf16_pages_run_the_kernel_of_their_width(D, Dv, kernel, cuda):
    """bf16 pages with heads up to 128 wide run on the tensor-core split
    kernel (widths zero-padded to 32, 64 or 128), wider heads on the
    CUDA-core one; both meet the fp32 bar (the instantiation the library
    reports it launched, named as the profiler names it)."""
    q, kp, vp, bt, sl = _width_inputs(D, Dv)
    before = flash_decode_paged.kernels.copy()
    out = flash_decode_paged(q, kp, vp, bt, sl)
    assert flash_decode_paged.kernels - before == {kernel: 1}
    ref = paged_attention_reference(q, kp, vp, bt, sl)
    assert out.shape == (2, 3, 8, Dv)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_engine_kernel_matches_gather(cuda):
    cfg = dataclasses.replace(get_config("qwen2-7b-smoke"), num_heads=7,
                              num_kv_heads=1, param_dtype="float32",
                              compute_dtype="float32")
    params = init_params(cfg, device=cuda, seed=0)
    prompts = [list(map(int, np.random.RandomState(i).randint(
        0, cfg.vocab_size, 3 + 5 * i))) for i in range(5)]

    def run(impl):
        eng = ServeEngine(params, cfg, EngineConfig(
            max_slots=3, block_size=4, num_blocks=40, max_blocks_per_seq=10,
            attn_impl=impl, cache_dtype="float32"), torch_device=cuda)
        before = flash_decode_paged.launches
        out = eng.run([Request(uid=f"r{i}", prompt=p, max_new=6)
                       for i, p in enumerate(prompts)])
        launched = flash_decode_paged.launches - before
        return {u: c.tokens for u, c in out.items()}, launched, eng.steps

    kern, launched, steps = run("kernel")
    gath, none, _ = run("gather")
    assert kern == gath
    assert launched == cfg.num_layers * steps and none == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_FA_CASES, ids=CARD_FA_IDS)
def test_cuda_fa2_kernels_match_plain_versions(case, dtype, cuda):
    causal, window = case[5], case[6]
    q, k, v, do = (torch.from_numpy(x).to(cuda, dtype).transpose(1, 2)
                   for x in fa_inputs(case, seed=5))
    kw = dict(causal=causal, window=window)
    fns = (FK.flash_attention_fwd, FK.flash_attention_bwd_dq,
           FK.flash_attention_bwd_dkdv)
    counts = [(f.launches, f.padded) for f in fns]
    D, Dv = case[4], fa_widths(case)[1]
    padded = FK.padded_dims(D, Dv) != (D, Dv)
    out, lse = FK.flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = FK.attention_fwd_plain(q, k, v, **kw)
    delta = (do.float() * ref_out.float()).sum(-1)
    dq = FK.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, **kw)
    dk, dv = FK.flash_attention_bwd_dkdv(q, k, v, do, ref_lse, delta, **kw)
    torch.cuda.synchronize()
    assert [(f.launches, f.padded) for f in fns] == \
        [(n + 1, m + padded) for n, m in counts]
    assert out.shape == ref_out.shape and dq.shape == q.shape
    assert dk.shape == k.shape and dv.shape == v.shape
    ref_dq = FK.attention_bwd_dq_plain(q, k, v, do, ref_lse, delta, **kw)
    ref_dk, ref_dv = FK.attention_bwd_dkdv_plain(q, k, v, do, ref_lse,
                                                 delta, **kw)
    # fp32 products on both sides from the same inputs (bf16 kernels
    # multiply P and dS as hi + lo bf16 pairs, within 2**-18 of fp32); a
    # bf16 output differs by at most one rounding step (2**-7 of the value)
    out_tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=out_tol,
                               atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    for mine, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        torch.testing.assert_close(mine, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, "fa_bwd_dq_tc_kernel<64, 64>"),
    (torch.float32, "fa_bwd_dq_kernel<float, 64, 64>")])
def test_cuda_dq_runs_the_kernel_of_its_dtype(dtype, kernel, cuda):
    """At opt-1.3b's attention shape, bf16 dq runs on the tensor-core
    kernel and fp32 dq on the CUDA-core one (the instantiation the
    library reports it launched, named as the profiler names it)."""
    q, k, v, do = (torch.from_numpy(x).to(cuda, dtype).transpose(1, 2)
                   for x in fa_inputs((4, 2048, 32, 32, 64, True, 0),
                                      seed=6))
    out, lse = FK.flash_attention_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    before = (FK.flash_attention_bwd_dq.launches,
              FK.flash_attention_bwd_dq.kernels.copy())
    FK.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert FK.flash_attention_bwd_dq.launches == before[0] + 1
    assert FK.flash_attention_bwd_dq.kernels - before[1] == {kernel: 1}


@pytest.mark.cuda
def test_cuda_fa2_bf16_rows_must_start_on_16_bytes(cuda):
    from repro_torch.models import model as M
    B, S, H, D = 2, 128, 4, 64
    n = B * S * H * D
    flat = torch.randn(n + 8, device=cuda).to(torch.bfloat16)
    good = flat[:n].view(B, S, H, D).transpose(1, 2)
    off = flat[1:n + 1].view(B, S, H, D).transpose(1, 2)   # one element on
    lse = torch.zeros((B, H, S), device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        FK.flash_attention_fwd(off, good, good)
    with pytest.raises(ValueError, match="16 bytes"):
        FK.flash_attention_bwd_dkdv(good, off, good, good, lse, lse)
    with pytest.raises(ValueError, match="16 bytes"):
        FK.flash_attention_bwd_dkdv(good, good, good, off, lse, lse)
    # the main path's q, k, v (B, S, H, D) projections seen through
    # transpose(1, 2), and the cotangent autograd hands the backward
    cfg = get_config("opt-125m-smoke")
    assert cfg.compute_dtype == "bfloat16"
    params = init_params(cfg, device=cuda, seed=0)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 129))).to(cuda)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    fns = (FK.flash_attention_fwd, FK.flash_attention_bwd_dkdv)
    before = [f.launches for f in fns]
    loss, _ = M.forward_train(params, cfg, {"tokens": toks[:, :-1],
                                            "labels": toks[:, 1:]},
                              attn_impl="kernel")
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == \
        [cfg.num_layers] * 2
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


@pytest.mark.cuda
def test_cuda_train_step_kernel_matches_chunked(cuda):
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("opt-125m-smoke"),
                              param_dtype="float32", compute_dtype="float32")
    params = init_params(cfg, device=cuda, seed=0)
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 200))).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    out = {}
    for impl in ("kernel", "chunked"):
        before = FK.flash_attention_fwd.launches
        loss, _ = M.forward_train(params, cfg, batch, attn_impl=impl)
        grads = torch.autograd.grad(loss, leaves)
        out[impl] = (float(loss.detach()), grads,
                     FK.flash_attention_fwd.launches - before)
    assert out["kernel"][2] == cfg.num_layers and out["chunked"][2] == 0
    assert abs(out["kernel"][0] - out["chunked"][0]) < 1e-4
    for a, b in zip(out["kernel"][1], out["chunked"][1]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,block", QUANT_CASES, ids=QUANT_IDS)
def test_cuda_quant8_kernels_equal_plain_versions(n, block, dtype, cuda):
    x = torch.from_numpy(quant_input(n)).to(cuda, dtype)
    x[: min(n, block)] = 0                  # an all-zero block
    before = (QK.quantize_blocks.launches, QK.dequantize_blocks.launches)
    q, s = QK.quantize_blocks(x, block=block)
    out = QK.dequantize_blocks(q, s, block=block, dtype=dtype)
    torch.cuda.synchronize()
    assert (QK.quantize_blocks.launches,
            QK.dequantize_blocks.launches) == (before[0] + 1, before[1] + 1)
    rows = -(-n // block)
    xp = torch.nn.functional.pad(x, (0, rows * block - n))
    rq, rs = QR.quantize_reference(xp, block)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    assert float(s[0]) == 1.0
    assert torch.equal(out, QR.dequantize_reference(rq, rs, block, dtype))


# row counts for the dequantize kernel: one row, a few, one past a power
# of two, one that ends part way through a block's trip (4,096 fp32 or
# 8,192 bf16 codes) at every block, and one that gives each block of the
# one-wave grid several trips
DEQUANT_ROWS = [1, 3, 257, 4173, 40001]


def _dequant_inputs(rows, block, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randint(-127, 128, (rows * block,), dtype=torch.int8,
                      device=device, generator=g)
    s = torch.rand(rows, device=device, generator=g) * 1e-2 + 1e-7
    return q, s


def _dequant_equals_plain(q, s, block, dtype):
    before = QK.dequantize_blocks.launches
    out = QK.dequantize_blocks(q, s, block=block, dtype=dtype)
    torch.cuda.synchronize()
    assert QK.dequantize_blocks.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.equal(out, QR.dequantize_reference(q, s, block, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [128, 256, 512])
@pytest.mark.parametrize("rows", DEQUANT_ROWS)
def test_cuda_dequantize_equals_plain_version(rows, block, dtype, cuda):
    q, s = _dequant_inputs(rows, block, cuda, seed=rows + block)
    _dequant_equals_plain(q, s, block, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dequantize_past_two_gib_of_output(dtype, cuda):
    """More than 2**31 bytes of output: every offset past the 32-bit
    range must be computed in 64 bits."""
    rows = (2 ** 31 // (256 * dtype.itemsize)) + 3
    q, s = _dequant_inputs(rows, 256, cuda, seed=7)
    assert q.numel() * dtype.itemsize > 2 ** 31
    _dequant_equals_plain(q, s, 256, dtype)


@pytest.mark.cuda
def test_cuda_quant8_refuses_what_the_kernel_does_not_take(cuda):
    with pytest.raises(ValueError, match="block"):
        QK.quantize_blocks(torch.zeros(384, device=cuda), block=384)
    with pytest.raises(ValueError, match="dtype"):
        QK.quantize_blocks(torch.zeros(256, device=cuda,
                                       dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        QK.quantize_blocks(torch.zeros(512, device=cuda)[::2])


@pytest.mark.cuda
def test_cuda_local_sgd_int8_runs_the_kernels_and_async_equals_sync(cuda):
    from repro_torch.optim.compress import CompressConfig
    from repro_torch.train.local_sgd import LocalSGDConfig, train_local_sgd
    from repro_torch.train.trainer import TrainerConfig
    cfg = dataclasses.replace(get_config("opt-125m-smoke"),
                              param_dtype="float32", compute_dtype="float32")
    tc = TrainerConfig(steps=4, batch=2, seq_len=64, log_every=0)
    ls = LocalSGDConfig(replicas=2, inner_steps=2,
                        compress=CompressConfig(method="int8"))
    before = QK.quantize_blocks.launches
    sync = train_local_sgd(cfg, tc, ls, device=cuda)
    leaves = len(tree_leaves(init_params(cfg, device="cpu", seed=0)))
    assert QK.quantize_blocks.launches - before == leaves * 2 * 2
    asyn = train_local_sgd(cfg, tc, dataclasses.replace(ls, async_mode=True),
                           device=cuda)
    assert all(np.isfinite(sync.losses))
    assert asyn.losses == sync.losses
    assert asyn.round_losses == sync.round_losses


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CARD_SSD_CASES, ids=CARD_SSD_IDS)
def test_cuda_ssd_kernel_matches_plain_version(case, dtype, cuda):
    b, s, h, g, p, n, chunk = case
    x, dt, A, B, C = (torch.from_numpy(a).to(cuda)
                      for a in ssd_inputs(b, s, h, g, p, n))
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    args = (x.transpose(1, 2), dt.transpose(1, 2), A, B.transpose(1, 2),
            C.transpose(1, 2))
    before = SK.ssd_bhcq.launches
    y = SK.ssd_bhcq(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert SK.ssd_bhcq.launches == before + 1
    ref = SK.ssd_bhcq_plain(*args, chunk=chunk)
    # fp32 on both sides from the same inputs, the same cumsum bit for
    # bit; a bf16 output may round to the neighbouring value (2**-7)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((y.float() - ref.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_cuda_ssd_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C = (torch.from_numpy(a).to(cuda)
                      for a in ssd_inputs(1, 16, 2, 1, 12, 8))
    with pytest.raises(ValueError, match="multiples of 8"):
        SK.ssd_bhcq(x.transpose(1, 2), dt.transpose(1, 2), A,
                    B.transpose(1, 2), C.transpose(1, 2), chunk=8)
    x, dt, A, B, C = (torch.from_numpy(a).to(cuda)
                      for a in ssd_inputs(1, 16, 2, 1, 8, 8))
    with pytest.raises(ValueError, match="float32"):
        SK.ssd_bhcq(x.transpose(1, 2), dt.transpose(1, 2).double(), A,
                    B.transpose(1, 2), C.transpose(1, 2), chunk=8)
    with pytest.raises(RuntimeError, match="no backward"):
        SK.ssd_bhcq(x.transpose(1, 2).requires_grad_(True),
                    dt.transpose(1, 2), A, B.transpose(1, 2),
                    C.transpose(1, 2), chunk=8)


@pytest.mark.cuda
def test_cuda_mamba2_prefill_kernel_matches_oracle_and_decode(cuda):
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("mamba2-130m-smoke"),
                              param_dtype="float32", compute_dtype="float32")
    params = init_params(cfg, device=cuda, seed=0)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 45))).to(cuda)
    with torch.no_grad():
        before = SK.ssd_bhcq.launches
        kern = M.forward_logits(params, cfg, {"tokens": toks})
        assert SK.ssd_bhcq.launches - before == cfg.num_layers
        ref = M.forward_logits(params, cfg, {"tokens": toks},
                               use_kernel=False)
        cache = M.init_cache(cfg, 2, 45, dtype=torch.float32, device=cuda)
        outs = []
        for i in range(45):
            lg, cache = M.decode_step(params, cfg, cache, toks[:, i:i + 1], i)
            outs.append(lg)
    torch.testing.assert_close(kern, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(torch.stack(outs, 1), kern, rtol=2e-3,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(2, 32), (20, 1)], ids=["per-row", "flat"])
def test_cuda_moe_forward_matches_cpu_with_drops(B, S, cuda):
    """``moe_forward`` on the card against the same call on the CPU, fp32,
    with expert 0 preferred by every token so that it overflows its
    capacity: the same assignments kept, outputs within 1e-5 of the
    largest |y|."""
    from repro_torch.models import moe
    from repro_torch.models.params import tree_map
    cfg = dataclasses.replace(get_config("mixtral-8x7b-smoke"),
                              param_dtype="float32", compute_dtype="float32")
    params = init_params(cfg, device="cpu", seed=0)
    p = tree_map(lambda a: a[0].clone(), params["decoder"]["g0"]["s1_moe"])
    x = torch.from_numpy(np.random.RandomState(3).randn(
        B, S, cfg.d_model).astype(np.float32))
    x[..., 0] += 10.0                      # read by expert 0's router only
    p["router"][0] = 0.0
    p["router"][0, 0] = 1.0
    pc = tree_map(lambda a: a.to(cuda), p)
    keeps, ys = [], []
    for dev, pp in (("cpu", p), (cuda, pc)):
        xd = x.to(dev)
        with torch.no_grad():
            y, _ = moe.moe_forward(pp, xd, cfg)
            h = moe.norm(pp["norm"], xd, cfg)
            _, _, top_i = moe.router_probs(pp, h, cfg)
        top_i = top_i.reshape(1, B, -1) if S == 1 else top_i
        C = moe.capacity(B if S == 1 else S, cfg)
        keeps.append(moe.dispatch_plan(top_i, C, cfg.moe.num_experts)[1]
                     .cpu())
        ys.append((y - xd).cpu())
    k = cfg.moe.experts_per_token
    assert torch.equal(keeps[0], keeps[1])
    assert int(keeps[0].sum()) < B * S * k            # some were dropped
    torch.testing.assert_close(ys[1], ys[0], rtol=0,
                               atol=1e-5 * float(ys[0].abs().max()))


@pytest.mark.cuda
def test_cuda_mixtral_smoke_train_steps_equal_the_cpu(cuda):
    """Two train steps of mixtral-8x7b-smoke (fp32, the FA-2 kernels with
    GQA and a window of 6 at 48 tokens, the MoE dispatch with drops) on
    the card against the same steps on the CPU: losses, grad norms and
    the parameters after them."""
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(get_config("mixtral-8x7b-smoke"),
                              param_dtype="float32", compute_dtype="float32",
                              sliding_window=6)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    ocfg = adamw.OptConfig(learning_rate=1e-3, warmup_steps=1,
                           decay_steps=4, eps=1e-3)
    rs = np.random.RandomState(0)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 49)))
    out = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda a: a.to(dev),
                          init_params(cfg, device="cpu", seed=0))
        state = adamw.init_opt_state(params, ocfg)
        step = make_train_step(cfg, ocfg, attn_impl="kernel")
        batch = {"tokens": toks[:, :-1].to(dev),
                 "labels": toks[:, 1:].to(dev)}
        before = FK.flash_attention_bwd_dkdv.launches
        mets = []
        for _ in range(2):
            params, state, m = step(params, state, batch)
            mets.append((float(m["loss"]), float(m["grad_norm"])))
        launched = FK.flash_attention_bwd_dkdv.launches - before
        out[str(dev)] = (mets, [p.detach().cpu() for p in
                                tree_leaves(params)], launched)
    (cm, cp, cl), (gm, gp, gl) = out["cpu"], out[str(cuda)]
    assert cl == 0 and gl == 2 * cfg.num_layers
    for (cl_, cg), (gl_, gg) in zip(cm, gm):
        assert gl_ == pytest.approx(cl_, rel=1e-5)
        assert gg == pytest.approx(cg, rel=1e-4)
    for a, b in zip(gp, cp):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_cuda_mixtral_remat_recomputes_the_forward_routes(cuda, monkeypatch):
    """mixtral-8x7b at full width and 2 layers in bf16 (1 x 2048 tokens):
    with remat "full" the backward's recompute of each layer routes every
    token to the experts the forward chose (a spy on ``dispatch_plan``),
    and the gradients equal remat "none"'s within one bf16 rounding of
    each leaf's largest gradient."""
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import model as M
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=2)
    params = init_params(cfg, device=cuda, seed=0)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in
             next(make_batch_fn(cfg, 1, 2048, seed=0)).items()}
    routes = []
    plan = moe.dispatch_plan

    def spy(top_i, C, E):
        routes.append(top_i.clone())
        return plan(top_i, C, E)
    monkeypatch.setattr(moe, "dispatch_plan", spy)
    grads = {}
    for remat in ("none", "full"):
        routes.clear()
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = M.forward_train(params, cfg, batch, remat=remat,
                                  attn_impl="kernel")
        forward = list(routes)
        grads[remat] = torch.autograd.grad(loss, leaves)
        recompute = routes[len(forward):]
        assert len(forward) == cfg.num_layers
        if remat == "none":
            assert not recompute
            continue
        assert len(recompute) == cfg.num_layers
        # non-reentrant checkpoints recompute the last layer first
        for fwd, again in zip(forward, reversed(recompute)):
            assert torch.equal(fwd, again)
    for a, b in zip(grads["full"], grads["none"]):
        assert bool(torch.isfinite(a).all())
        bound = 2.0 ** -7 * float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= bound


def _deepseek_smoke_fp32():
    return dataclasses.replace(get_config("deepseek-v3-671b-smoke"),
                               param_dtype="float32", compute_dtype="float32")


@pytest.mark.cuda
def test_cuda_deepseek_smoke_train_steps_equal_the_cpu(cuda):
    """Two train steps of deepseek-v3-671b-smoke (fp32: MLA through the
    FA-2 kernels at (96, 64) in the trunk and the MTP block, the dense
    prefix, 4 experts top-2 with a shared one) on the card against the
    same steps on the CPU: losses with the MTP loss, grad norms and the
    parameters after them."""
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cfg = _deepseek_smoke_fp32()
    ocfg = adamw.OptConfig(learning_rate=1e-3, warmup_steps=1,
                           decay_steps=4, eps=1e-3)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 49)))
    out = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda a: a.to(dev),
                          init_params(cfg, device="cpu", seed=0))
        state = adamw.init_opt_state(params, ocfg)
        step = make_train_step(cfg, ocfg, attn_impl="kernel")
        batch = {"tokens": toks[:, :-1].to(dev),
                 "labels": toks[:, 1:].to(dev)}
        before = FK.flash_attention_bwd_dkdv.kernels.copy()
        mets = []
        for _ in range(2):
            params, state, m = step(params, state, batch)
            mets.append((float(m["loss"]), float(m["mtp_loss"]),
                         float(m["grad_norm"])))
        launched = FK.flash_attention_bwd_dkdv.kernels - before
        out[str(dev)] = (mets, [p.detach().cpu() for p in
                                tree_leaves(params)], launched)
    (cm, cp, cl), (gm, gp, gl) = out["cpu"], out[str(cuda)]
    # the trunk's layers and the MTP block, each step
    assert not cl and gl == {"fa_bwd_dkdv_kernel<float, 96, 64>":
                             2 * (cfg.num_layers + cfg.mtp_depth)}
    for (cl_, cmtp, cg), (gl_, gmtp, gg) in zip(cm, gm):
        assert gl_ == pytest.approx(cl_, rel=1e-5)
        assert gmtp == pytest.approx(cmtp, rel=1e-5)
        assert gg == pytest.approx(cg, rel=1e-4)
    for a, b in zip(gp, cp):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_cuda_deepseek_smoke_dense_decode_equals_the_cpu(cuda):
    """greedy_generate of deepseek-v3-671b-smoke over the absorbed latent
    cache (fp32) on the card: the CPU's ids, and the last step's logits
    within 1e-4 of the CPU's."""
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    from repro_torch.serve.step import greedy_generate
    cfg = _deepseek_smoke_fp32()
    prompt = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (3, 9)))
    got = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda a: a.to(dev),
                          init_params(cfg, device="cpu", seed=0))
        ids = greedy_generate(params, cfg, prompt.to(dev), 7)
        cache = M.init_cache(cfg, 3, 16, torch.float32, dev)
        with torch.no_grad():
            for i in range(ids.shape[1]):
                logits, cache = M.decode_step(params, cfg, cache,
                                              ids[:, i:i + 1], i)
        got[str(dev)] = (ids.cpu(), logits.cpu())
    (ci, cl), (gi, gl) = got["cpu"], got[str(cuda)]
    assert torch.equal(gi, ci)
    torch.testing.assert_close(gl, cl, rtol=1e-4, atol=1e-4)


def _train_steps_on_the_cpu_and_the_card(cfg, batch, cuda):
    """Two train steps of ``cfg`` (fp32, the FA-2 kernels) from the same
    weights and batch on the CPU and on the card: per device, [(loss,
    grad norm)] a step, the parameters after them, and the dk/dv kernel's
    launches by instantiation."""
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    ocfg = adamw.OptConfig(learning_rate=1e-3, warmup_steps=1,
                           decay_steps=4, eps=1e-3)
    out = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda a: a.to(dev),
                          init_params(cfg, device="cpu", seed=0))
        state = adamw.init_opt_state(params, ocfg)
        step = make_train_step(cfg, ocfg, attn_impl="kernel")
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        before = FK.flash_attention_bwd_dkdv.kernels.copy()
        mets = []
        for _ in range(2):
            params, state, m = step(params, state, b)
            mets.append((float(m["loss"]), float(m["grad_norm"])))
        out[str(dev)] = (mets, [p.detach().cpu() for p in
                                tree_leaves(params)],
                         FK.flash_attention_bwd_dkdv.kernels - before)
    return out["cpu"], out[str(cuda)]


def _assert_steps_equal(cpu, card):
    for (cl, cg), (gl, gg) in zip(cpu[0], card[0]):
        assert gl == pytest.approx(cl, rel=1e-5)
        assert gg == pytest.approx(cg, rel=1e-4)
    for a, b in zip(card[1], cpu[1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_cuda_whisper_smoke_train_steps_equal_the_cpu(cuda):
    """Two train steps of whisper-medium-smoke (fp32: the encoder
    non-causal over 64 frames, the decoder's causal self-attention and
    its non-causal cross-attention with S = 40 queries over T = 64 keys,
    all through the FA-2 kernels) on the card against the CPU."""
    from repro_torch.data.pipeline import make_batch_fn
    cfg = dataclasses.replace(get_config("whisper-medium-smoke"),
                              param_dtype="float32", compute_dtype="float32")
    batch = next(make_batch_fn(cfg, 2, 40, seed=0))
    cpu, card = _train_steps_on_the_cpu_and_the_card(cfg, batch, cuda)
    # encoder, self- and cross-attention layers, each step
    assert not cpu[2] and card[2] == {"fa_bwd_dkdv_kernel<float, 64, 64>":
                                      2 * (cfg.encoder_layers
                                           + 2 * cfg.num_layers)}
    _assert_steps_equal(cpu, card)


@pytest.mark.cuda
def test_cuda_qwen2_vl_smoke_train_steps_equal_the_cpu(cuda):
    """Two train steps of qwen2-vl-2b-smoke (fp32, M-RoPE with distinct
    t/h/w streams over a 4 x 4 vision grid and the text after it, the
    vision prefix's labels masked) on the card against the CPU."""
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.launch.specs import vlm_split
    cfg = dataclasses.replace(get_config("qwen2-vl-2b-smoke"),
                              param_dtype="float32", compute_dtype="float32")
    B, S = 2, 64
    batch = next(make_batch_fn(cfg, B, S, seed=0))
    Sv, St = vlm_split(S)
    grid = 4
    assert grid * grid == Sv
    idx = np.arange(Sv)
    vis = np.stack([np.zeros(Sv), idx // grid, idx % grid])
    text = np.broadcast_to(grid + np.arange(St), (3, St))
    pos = np.concatenate([vis, text], axis=1).astype(np.int32)
    batch["positions"] = np.ascontiguousarray(
        np.broadcast_to(pos[:, None], (3, B, S)))
    cpu, card = _train_steps_on_the_cpu_and_the_card(cfg, batch, cuda)
    hd = cfg.resolved_head_dim
    assert not cpu[2] and card[2] == {
        f"fa_bwd_dkdv_kernel<float, {hd}, {hd}>": 2 * cfg.num_layers}
    _assert_steps_equal(cpu, card)


@pytest.mark.cuda
def test_cuda_engine_slo_gate_defers_past_half_the_slots(cuda):
    """While the TTFT SLO burns (a target every request misses, windows of
    4 and 16), admission stops past half the slots on the card as on the
    CPU: the same deferrals, steps and greedy ids, flash-decode in every
    layer of every step."""
    from repro_torch.models.params import tree_map
    from repro_torch.obs import MetricsRegistry, SLOMonitor, SLOSpec
    cfg = dataclasses.replace(get_config("qwen2-7b-smoke"), num_kv_heads=2,
                              param_dtype="float32", compute_dtype="float32")
    prompts = [list(map(int, np.random.RandomState(i).randint(
        0, cfg.vocab_size, 3 + 2 * i))) for i in range(12)]
    weights = init_params(cfg, device="cpu", seed=0)

    def run(dev):
        slo = SLOMonitor([SLOSpec("serve_ttft", "latency", 1e-9,
                                  objective=0.9, fast_window=4,
                                  slow_window=16)],
                         registry=MetricsRegistry())
        eng = ServeEngine(tree_map(lambda t: t.to(dev), weights), cfg,
                          EngineConfig(max_slots=4, block_size=4,
                                       num_blocks=64, max_blocks_per_seq=12,
                                       cache_dtype="float32"),
                          torch_device=dev, slo=slo)
        live = []
        open_slot = eng.kv.open_slot

        def spy(slot, prompt=None):
            live.append((sum(s is not None for s in eng._slots),
                         slo.burning("serve_ttft")))
            return open_slot(slot, prompt)
        eng.kv.open_slot = spy
        before = flash_decode_paged.launches
        out = eng.run([Request(uid=f"r{i}", prompt=p, max_new=4)
                       for i, p in enumerate(prompts)])
        return ({u: c.tokens for u, c in out.items()}, eng.steps,
                eng.metrics.counter("serve/admission_deferred").value,
                live, flash_decode_paged.launches - before)

    card, cpu = run(cuda), run(torch.device("cpu"))
    assert card[:3] == cpu[:3] and card[2] > 0
    assert all(n < 2 for n, burning in card[3] if burning)
    assert any(burning for _, burning in card[3])
    assert card[4] == cfg.num_layers * card[1] and cpu[4] == 0


@pytest.mark.cuda
def test_cuda_layer_sliced_checkpoint_round_trips_onto_the_card(cuda,
                                                                tmp_path):
    """save_for_placement of card tensors (bf16 and fp32) and
    restore_for_placement onto another stage split: every leaf comes back
    on the prototype's device, bit for bit; a stage restore crops."""
    from repro_torch.checkpoint import CheckpointSpec, ckpt
    from repro_torch.models.params import tree_map
    cfg = dataclasses.replace(get_config("opt-125m-smoke"), num_layers=4)
    params = init_params(cfg, device=cuda, seed=3)
    state = {"params": params,
             "outer_m": tree_map(lambda p: torch.randn(
                 p.shape, device=cuda, dtype=torch.float32), params)}
    ckpt.save_for_placement(tmp_path, 1, state,
                            CheckpointSpec(4, (0, 1, 3, 4)), replication=1)
    got = ckpt.restore_for_placement(tmp_path, [0, 2, 4], state)

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(bits(a), bits(b))
    part = ckpt.restore_for_placement(tmp_path, [0, 2, 4], state, stage=1)
    wq = part["params"]["decoder"]["g0"]["s0_attn"]["wq"]
    assert wq.device.type == "cuda" and wq.shape[0] == 2
    assert torch.equal(bits(wq), bits(params["decoder"]["g0"]["s0_attn"]
                                      ["wq"][2:4]))


@pytest.mark.cuda
def test_cuda_async_local_sgd_with_health_excludes_as_on_the_cpu(cuda):
    """Async local SGD with a health monitor at reduced depth: 2 replicas,
    one a straggler of the plan, quorum 2, staleness 1 and int8 sync
    through the kernels; the card and the CPU detect the same straggler,
    exclude the same updates and end at the same virtual time, from the
    same weights (drawn on the CPU), within the int8 local-SGD loss bar
    of ``tests/test_torch_local_sgd.py`` (a pseudo-gradient element on a
    rounding tie may take the other int8 code)."""
    from repro_torch.core.faultinject import FaultPlan
    from repro_torch.models.params import tree_map
    from repro_torch.obs import HealthMonitor, MetricsRegistry
    from repro_torch.obs.health import StragglerDetector
    from repro_torch.optim.compress import CompressConfig
    from repro_torch.train.local_sgd import LocalSGDConfig, train_local_sgd
    from repro_torch.train.trainer import TrainerConfig
    cfg = dataclasses.replace(get_config("opt-125m-smoke"),
                              param_dtype="float32", compute_dtype="float32")
    tc = TrainerConfig(steps=12, batch=2, seq_len=64, log_every=0)
    ls = LocalSGDConfig(replicas=2, inner_steps=2, async_mode=True,
                        quorum=2, staleness_bound=1,
                        compress=CompressConfig(method="int8"))

    def run(dev):
        hm = HealthMonitor(registry=MetricsRegistry(),
                           straggler=StragglerDetector(min_entities=2))
        res = train_local_sgd(cfg, tc, ls, fault_plan=FaultPlan(
            seed=6, straggler_frac=0.5), health=hm, device=dev,
            params=tree_map(lambda t: t.to(dev),
                            init_params(cfg, device="cpu", seed=0)))
        return res, hm

    (card, chm), (cpu, phm) = run(cuda), run(torch.device("cpu"))
    assert chm.stragglers() == phm.stragglers() == {"0"}
    assert card.health_excluded_updates == cpu.health_excluded_updates > 0
    assert card.virtual_time_s == cpu.virtual_time_s
    assert card.dropped_stale == cpu.dropped_stale
    assert [(a.kind, a.entity, a.ts_s) for a in chm.alerts] == \
        [(a.kind, a.entity, a.ts_s) for a in phm.alerts]
    np.testing.assert_allclose(card.round_losses, cpu.round_losses,
                               rtol=1e-3)


# the train parity bars of tests/test_torch_train.py (fp32, sums in other
# orders), restated: this file imports nothing of JAX's test side
PIPE_LOSS_RTOL = 1e-5
PIPE_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_cuda_pipeline_on_two_gloo_ranks_equals_forward_train(cuda):
    """tests/test_pipeline.py's tiny OPT, fp32, over 2 stages of gloo ranks
    on the one card (activations staged through host memory), 2
    microbatches: the loss and every gradient leaf, gathered to rank 0,
    equal the single-process ``forward_train`` on the card from the same
    weights (``init_params(seed=0)`` on the card), and the FA-2 kernels
    ran once a layer a microbatch, summed over the ranks."""
    import functools

    from repro_torch.distributed import pipeline as P
    from repro_torch.distributed import runtime
    from repro_torch.kernels.build import build_all
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    build_all()                 # the ranks only load the kernels
    cfg = dataclasses.replace(
        get_config("opt-125m"), name="opt-pipe-test", num_layers=4,
        d_model=128, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
        vocab_size=512, param_dtype="float32", compute_dtype="float32")
    rs = np.random.RandomState(1)
    toks = rs.randint(0, cfg.vocab_size, (4, 65)).astype(np.int32)
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    nb["labels"][0, :5] = -1
    mb = 2
    res = runtime.spawn([functools.partial(
        P.evaluate, cfg=cfg, batch=nb, num_microbatches=mb, seed=0,
        grads=True)], stages=2, transport="gloo", device=cuda)
    params = init_params(cfg, device=cuda, seed=0)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = M.forward_train(params, cfg, {k: torch.from_numpy(v).to(cuda)
                                            for k, v in nb.items()})
    ref = torch.autograd.grad(loss, leaves)
    got = res.values[0][0]
    assert res.values[0][1]["loss"] == got["loss"]
    np.testing.assert_allclose(got["loss"], float(loss.detach()),
                               rtol=PIPE_LOSS_RTOL)
    for g, r in zip(tree_leaves(got["grads"]), ref):
        np.testing.assert_allclose(g.numpy(), r.cpu().numpy(),
                                   **PIPE_GRAD_TOL)
    n = cfg.num_layers * mb
    assert res.launches[0] == {"flash_attention_fwd": n,
                               "flash_attention_bwd_dq": n,
                               "flash_attention_bwd_dkdv": n}


@pytest.mark.cuda
@pytest.mark.parametrize("arch,heads,mesh", [("opt-125m", (4, 4), (2, 2)),
                                             ("qwen2-7b", (4, 2), (1, 4))])
def test_cuda_mesh_on_four_gloo_ranks_equals_forward_train(cuda, arch,
                                                           heads, mesh):
    """A tiny OPT (2 x 2) and a GQA qwen2 whose K/V expand to every head
    (1 x 4), fp32, on a (data, model) mesh of gloo ranks sharing the card,
    their collectives staged through host memory: the loss and every
    gradient leaf, gathered from the DTensor shards, equal the
    single-process ``forward_train`` on the card from the same weights,
    and the FA-2 kernels ran once a layer a rank, on each rank's heads."""
    import functools

    from repro_torch.distributed import runtime, spmd
    from repro_torch.kernels.build import build_all
    from repro_torch.models import model as M
    build_all()                 # the ranks only load the kernels
    cfg = dataclasses.replace(
        get_config(arch), name=f"{arch}-mesh-test", num_layers=2,
        d_model=128, num_heads=heads[0], num_kv_heads=heads[1], head_dim=32,
        d_ff=256, vocab_size=512, param_dtype="float32",
        compute_dtype="float32")
    rs = np.random.RandomState(1)
    toks = rs.randint(0, cfg.vocab_size, (4, 65)).astype(np.int32)
    nb = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    nb["labels"][0, :5] = -1
    res = runtime.spawn([functools.partial(
        spmd.evaluate, cfg=cfg, batch=nb, seed=0, grads=True)],
        shape=mesh, names=("data", "model"), transport="host",
        device=cuda)
    params = init_params(cfg, device=cuda, seed=0)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = M.forward_train(params, cfg, {k: torch.from_numpy(v).to(cuda)
                                            for k, v in nb.items()})
    ref = torch.autograd.grad(loss, leaves)
    got = res.values[0][0]
    assert {v["loss"] for v in res.values[0]} == {got["loss"]}
    np.testing.assert_allclose(got["loss"], float(loss.detach()),
                               rtol=PIPE_LOSS_RTOL)
    full = spmd.join_shards(res.values[0], cfg, mesh, ("data", "model"))
    for g, r in zip(tree_leaves(full), ref):
        np.testing.assert_allclose(g.numpy(), r.cpu().numpy(),
                                   **PIPE_GRAD_TOL)
    n = cfg.num_layers * 4
    assert res.launches[0] == {"flash_attention_fwd": n,
                               "flash_attention_bwd_dq": n,
                               "flash_attention_bwd_dkdv": n}


@pytest.mark.cuda
def test_cuda_device_phases_time_the_card_without_waiting(cuda, monkeypatch):
    """A device phase on the card is two CUDA events on the current
    stream: ``resolve`` reads a pair only once the card has passed it and
    never waits, the device time covers the queued work (not its
    enqueue), and a phase begun after a resolve at a wait is placed on
    the host's clock no earlier than its launch."""
    import time

    from repro_torch.obs.trace import Tracer
    waits = []
    real = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: waits.append(1) or real(self))
    tr = Tracer(enabled=True)
    x = torch.randn(4096, 4096, device=cuda)
    torch.cuda.synchronize()
    tr.resolve()                        # the card has caught up: anchor
    t = time.perf_counter()
    with tr.span("step"):
        with tr.device_phase("mm", device=cuda):
            for _ in range(50):
                x = torch.tanh(x @ x)
    host_s = time.perf_counter() - t
    tr.resolve()
    torch.cuda.synchronize()
    tr.resolve()
    (dev,) = [e for e in tr.events if "span" in e]
    host = {e["id"]: e for e in tr.events if "id" in e}[dev["span"]]
    assert dev["dur"] / 1e6 > host_s
    assert dev["ts"] >= host["ts"] - 50.0
    assert not waits


# AdamW: (param, gradient, moment) dtypes, and leaves of 1 and more dims
# whose lengths are no multiple of a 4-element group or a 16-byte load
ADAMW_DTYPES = [(p, g, m) for p in (torch.float32, torch.bfloat16)
                for g in (torch.float32, torch.bfloat16)
                for m in (torch.float32, torch.bfloat16)]
ADAMW_DTYPE_IDS = ["-".join(str(t).split(".")[1].replace("float", "f")
                            for t in c) for c in ADAMW_DTYPES]
ADAMW_SHAPES = [(1_000_003,), (333, 77), (5,), (2, 3, 129), (4096, 8)]


def ulps(a, b):
    """The largest distance between a and b in units in the last place
    of their (common) dtype, fp32 or bf16."""
    assert a.dtype == b.dtype
    ints = torch.int32 if a.dtype == torch.float32 else torch.int16
    sign = -(1 << (8 * ints.itemsize - 1))

    def ordered(t):
        i = t.contiguous().view(ints).long()
        return torch.where(i < 0, sign - i, i)
    return int((ordered(a) - ordered(b)).abs().max())


def adamw_hyper(step, clip, device):
    t = torch.tensor(step, device=device)
    return dict(lr=torch.tensor(3e-3, device=device),
                clip=torch.tensor(clip, device=device),
                bc1=1.0 - torch.pow(0.9, t.float()),
                bc2=1.0 - torch.pow(0.95, t.float()), b1=0.9, b2=0.95,
                eps=1e-8, weight_decay=0.1)


def adamw_leaf(shape, dtypes, device, seed):
    pd, _, md = dtypes
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device).to(pd),
            (torch.randn(shape, generator=g, device=device) * 1e-2).to(md),
            (torch.rand(shape, generator=g, device=device) * 1e-4).to(md))


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [1.0, 0.37], ids=["no-clip", "clipped"])
@pytest.mark.parametrize("dtypes", ADAMW_DTYPES, ids=ADAMW_DTYPE_IDS)
def test_cuda_adamw_update_equals_plain_loop(dtypes, clip, cuda):
    """Three steps of each leaf: the moments within fp32 round-off (one
    unit in the last place of their dtype) and the parameters equal or
    one unit apart."""
    before = AK.adamw_update.launches
    for i, shape in enumerate(ADAMW_SHAPES):
        p, mu, nu = adamw_leaf(shape, dtypes, cuda, seed=i)
        want = [t.clone() for t in (p, mu, nu)]
        for step in (1, 2, 3):
            g = torch.randn(shape, device=cuda).to(dtypes[1])
            hyper = adamw_hyper(step, clip, cuda)
            decay = len(shape) >= 2
            AK.adamw_update(p, g, mu, nu, decay=decay, **hyper)
            AR.adamw_update_reference(*want[:1], g, *want[1:], decay=decay,
                                      **hyper)
        for got, ref in zip((p, mu, nu), want):
            assert ulps(got, ref) <= 1, (shape, got.dtype)
    assert AK.adamw_update.launches - before == 3 * len(ADAMW_SHAPES)


@pytest.mark.cuda
def test_cuda_adamw_update_past_two_gib(cuda):
    """An fp32 leaf of more than 2**31 bytes: every offset past the
    32-bit range is computed in 64 bits."""
    n = (1 << 29) + 7
    dtypes = (torch.float32,) * 3
    p, mu, nu = adamw_leaf((n,), dtypes, cuda, seed=3)
    g = torch.randn(n, device=cuda)
    want = [t.clone() for t in (p, mu, nu)]
    hyper = adamw_hyper(2, 0.5, cuda)
    AK.adamw_update(p, g, mu, nu, decay=False, **hyper)
    chunk = 1 << 26
    for a in range(0, n, chunk):
        AR.adamw_update_reference(*(t[a:a + chunk] for t in want[:1]),
                                  g[a:a + chunk],
                                  *(t[a:a + chunk] for t in want[1:]),
                                  decay=False, **hyper)
    for got, ref in zip((p, mu, nu), want):
        assert ulps(got, ref) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_norm_kernel_equals_plain_sum_and_repeats(dtype, cuda):
    """Σ x² of each leaf within fp32 round-off of ``x.float().square()
    .sum()``, and the same bits on a second call (no atomics)."""
    xs = [torch.randn(n, device=cuda).to(dtype) * 3
          for n in (1, 7, 9, 4099, 1_000_003, (1 << 27) + 5)]
    before = AK.square_sums.launches
    got = AK.square_sums(xs)
    again = AK.square_sums(xs)
    want = torch.stack([AR.square_sum_reference(x) for x in xs])
    assert AK.square_sums.launches - before == 2 * len(xs)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def _card_tree(device, dtype=torch.bfloat16):
    g = torch.Generator(device=device).manual_seed(0)
    return {k: torch.randn(s, generator=g, device=device).to(dtype)
            for k, s in (("w", (64, 48)), ("b", (33,)), ("stack", (3, 5, 7)),
                         ("emb", (1000, 64)))}


def _plain_adamw(params, grads, state, cfg):
    """``apply_updates`` with every leaf through the plain loop."""
    from repro_torch.optim import adamw
    real = AK.adamw_update, AK.square_sums
    AK.adamw_update = AR.adamw_update_reference
    AK.square_sums = lambda xs: torch.stack(
        [AR.square_sum_reference(x) for x in xs])
    try:
        return adamw.apply_updates(params, grads, state, cfg)
    finally:
        AK.adamw_update, AK.square_sums = real


@pytest.mark.cuda
def test_cuda_adamw_apply_updates_one_launch_a_leaf_without_a_sync(cuda):
    """Each step launches the norm kernel and the update kernel once a
    leaf, never waits for the card (sync debug mode "error"), and gives
    the plain loop's leaves; the tracer's fused share reads 1.0."""
    from repro_torch.obs import trace
    from repro_torch.optim import adamw
    cfg = adamw.OptConfig(learning_rate=1e-2, warmup_steps=1,
                          clip_norm=1e6)            # clip reads exactly 1
    params, want = _card_tree(cuda), _card_tree(cuda)
    state, want_state = (adamw.init_opt_state(t, cfg) for t in (params, want))
    launches, shares = [0, 0], []
    for i in range(3):
        grads = {k: torch.randn_like(v) for k, v in params.items()}
        torch.cuda.synchronize()
        tr = trace.Tracer(enabled=True)
        old = trace.set_tracer(tr)
        before = AK.square_sums.launches, AK.adamw_update.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            adamw.apply_updates(params, grads, state, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            trace.set_tracer(old)
        launches[0] += AK.square_sums.launches - before[0]
        launches[1] += AK.adamw_update.launches - before[1]
        shares += [e["args"]["value"] for e in tr.events
                   if e["name"] == "adamw/fused_share"]
        _plain_adamw(want, grads, want_state, cfg)
    assert launches == [3 * len(params)] * 2
    assert shares == [1.0] * 3
    for k in params:
        assert ulps(params[k], want[k]) <= 1
        assert ulps(state["mu"][k], want_state["mu"][k]) <= 1
        assert ulps(state["nu"][k], want_state["nu"][k]) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", ["strided", "fp16"])
def test_cuda_adamw_leaf_the_kernel_cannot_read_is_refused(leaf, cuda):
    """A card leaf the kernels cannot read (a transposed view, fp16) makes
    ``apply_updates`` raise: it never gives way to the plain loop on the
    card."""
    from repro_torch.optim import adamw
    cfg = adamw.OptConfig(learning_rate=1e-2, warmup_steps=1, clip_norm=0.0)
    params = _card_tree(cuda)
    params["w"] = (params["w"].t() if leaf == "strided"
                   else params["w"].half())
    state = adamw.init_opt_state(params, cfg)
    grads = {k: torch.randn_like(v) for k, v in params.items()}  # v's strides
    assert grads["w"].stride() == params["w"].stride()
    plain = AR.adamw_update_reference

    def refused(*a, **kw):
        raise AssertionError("the plain loop ran on the card")
    AR.adamw_update_reference = refused
    try:
        with pytest.raises(ValueError, match="contiguous"):
            adamw.apply_updates(params, grads, state, cfg)
        with pytest.raises(ValueError, match="contiguous"):
            adamw.global_norm(list(grads.values()))
    finally:
        AR.adamw_update_reference = plain


@pytest.mark.cuda
def test_cuda_adamw_refuses_what_the_kernel_does_not_take(cuda):
    hyper = adamw_hyper(1, 1.0, cuda)
    x = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        AK.adamw_update(x[::2], x[:32], x[:32], x[:32], decay=False, **hyper)
    with pytest.raises(ValueError, match="contiguous"):
        AK.square_sums([x.half()])
