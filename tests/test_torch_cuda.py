"""The port on the card: the CUDA flash-decode kernel against its plain
PyTorch version, and the engine through the kernel against the engine
through the plain gather path.  Every test here skips without CUDA.

The file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention.decode import (  # noqa: E402
    flash_decode_paged, paged_attention_reference)
from repro_torch.kernels.quant8.ops import quantize_kv  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
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
