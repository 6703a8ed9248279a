"""The port on the card: the CUDA flash-decode, FA-2, quant8 and SSD-scan
kernels against their plain PyTorch versions, the engine through the
kernel against the engine through the plain gather path, a train step
through the FA-2 kernels against one through the chunked path, local SGD
with int8-compressed sync through the kernels, and Mamba2's kernel
prefill against its oracle path and its dense decode.  Every test here
skips without CUDA.

The file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
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
# 48/40 -> 64/64, non-causal with T != S)
CARD_FA_CASES = FA_CASES + [(4, 2048, 32, 32, 64, True, 0),
                            (2, 333, 8, 2, 128, True, 0),
                            (2, 200, 4, 2, 96, True, 0, None, 64),
                            (1, 300, 2, 2, 192, True, 0, None, 128),
                            (1, 160, 4, 2, 80, True, 0),
                            (1, 100, 2, 1, 48, False, 0, 150, 40)]
CARD_FA_IDS = FA_IDS + ["opt-1.3b", "gqa4-d128-s333", "mla-smoke-96-64",
                        "mla-192-128", "padded-80", "padded-48-40-cross"]


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
# ragged MAMBA_SSD shape: 31 full chunks and one of 32 rows)
CARD_SSD_CASES = SSD_CASES + [(8, 4000, 24, 1, 64, 128, 128)]
CARD_SSD_IDS = SSD_IDS + ["mamba2-130m-8x4000"]


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


def _width_call(D, Dv):
    args = _width_inputs(D, Dv)
    return lambda: flash_decode_paged(*args)


def _profile_one_call(builder, args):
    """[(name, launches)] of every device operation the profiler sees in
    one call of ``builder(*args)``'s call, after a first call that builds,
    loads and warms its kernels, and a second in the session's warm-up
    step: the profiler can lose the records of the launches made as a
    session starts tracing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    call = globals()[builder](*args)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            call()
            torch.cuda.synchronize()
            prof.step()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


def profiled_kernels(builder, *args):
    """``_profile_one_call(builder, args)`` in a fresh interpreter.  In one
    process with these checks, `test_cuda_dq_runs_the_kernel_of_its_dtype`
    (a one-call session without a warm-up step) has seen no kernel, so
    each of them runs in a process of its own."""
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
    return [tuple(op) for op in json.loads(out.stdout.splitlines()[-1])]


@pytest.mark.cuda
@pytest.mark.parametrize("lens,C", [((2048,) * 8, 1), ((5,) * 8, 8),
                                    ((2048,) * 8, 8)],
                         ids=["decode-2048", "one-split", "chunk8-2048"])
def test_cuda_decode_call_is_at_most_two_kernels(lens, C, cuda):
    """One flash_decode_paged call at the engine's shape (B 8, H 28, K 4,
    D 128, bf16 pages) runs the split kernel and, with more than one
    split, the merge kernel, and no other device operation (profiler
    count over the call)."""
    ops = profiled_kernels("_decode_call", list(lens), C)
    names = [k for k, _ in ops]
    assert sum(c for _, c in ops) <= 2, ops
    assert any("flash_decode_split" in k for k in names), ops
    assert all("flash_decode" in k for k in names), ops


@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv,kernel", [
    (128, 128, "flash_decode_split_tc_kernel<1, 128>"),
    (64, 32, "flash_decode_split_tc_kernel<1, 64>"),
    (192, 128, "flash_decode_split_kernel<__nv_bfloat16, 2>")])
def test_cuda_bf16_pages_run_the_kernel_of_their_width(D, Dv, kernel, cuda):
    """bf16 pages with heads up to 128 wide run on the tensor-core split
    kernel (widths zero-padded to 32, 64 or 128), wider heads on the
    CUDA-core one; both meet the fp32 bar (kernel names as the profiler
    sees them)."""
    q, kp, vp, bt, sl = _width_inputs(D, Dv)
    out = flash_decode_paged(q, kp, vp, bt, sl)
    ref = paged_attention_reference(q, kp, vp, bt, sl)
    assert out.shape == (2, 3, 8, Dv)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)
    names = [k for k, _ in profiled_kernels("_width_call", D, Dv)
             if "flash_decode_split" in k]
    assert len(names) == 1 and kernel in names[0], names


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
    kernel and fp32 dq on the CUDA-core one (kernel names as the profiler
    sees them)."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, do = (torch.from_numpy(x).to(cuda, dtype).transpose(1, 2)
                   for x in fa_inputs((4, 2048, 32, 32, 64, True, 0),
                                      seed=6))
    out, lse = FK.flash_attention_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    before = FK.flash_attention_bwd_dq.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        FK.flash_attention_bwd_dq(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "fa_bwd_dq" in e.key]
    assert FK.flash_attention_bwd_dq.launches == before + 1
    assert len(names) == 1 and kernel in names[0], names


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
