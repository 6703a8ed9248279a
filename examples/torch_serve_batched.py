"""Batched serving on the PyTorch port: continuous batching over a paged KV
cache.

    PYTHONPATH=src python examples/torch_serve_batched.py \\
        [--arch mixtral-8x7b] [--torch-device cpu]

The torch twin of ``examples/serve_batched.py``, with its flags, defaults
and printout.  Loads a reduced variant of any assigned architecture
(``--arch`` accepts all ten ids) and serves a mixed-length request set.
Architectures whose decoder caches are token-paged (attn/mlp/moe
decoders: llama3, qwen*, granite, mixtral, opt) run through the port's
continuous-batching engine, whose decode attention is the flash-decode
CUDA kernel on the card; SSM / MLA / encoder-decoder architectures
(mamba2, jamba, deepseek-v3, whisper) fall back to the dense
``greedy_generate`` path.  Both report per-token energy/carbon from the
component model.  The random prompts (and whisper's frames) the JAX
example draws with ``jax.random`` are drawn with numpy from the same
integer seeds.  ``--torch-device cpu`` runs the kernels' plain versions
on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import flops as F
from repro_torch.core.energy.devices import LAPTOP_M2PRO
from repro_torch.core.energy.monitor import ComponentModel, EnergyMonitor
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models import params as P


def prompt_tokens(seed: int, shape, vocab_size: int) -> np.ndarray:
    """Token ids uniform in [0, vocab) from ``np.random.default_rng(seed)``
    (the example's ``jax.random.randint(PRNGKey(seed), ...)`` draws)."""
    return np.random.default_rng(seed).integers(0, vocab_size, shape)


def run_engine(cfg, params, *, requests: int = 6, prompt_len: int = 16,
               max_new: int = 24, temperature: float = 0.0, top_k: int = 0):
    """Serve the example's request set (request i has 3 + 5i mod
    (prompt_len - 2) prompt tokens drawn from seed 10 + i) through the
    paged engine (4 slots, 8-token pages, the laptop's energy profile) on
    the params' device.  Prints the example's report; returns (requests,
    completions, engine)."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serve.paged_cache import blocks_for
    from repro_torch.serve.sampling import SamplingParams

    sp = SamplingParams(temperature=temperature, top_k=top_k)
    reqs = []
    for i in range(requests):
        L = 3 + (5 * i) % max(prompt_len - 2, 1)
        toks = prompt_tokens(10 + i, (L,), cfg.vocab_size)
        reqs.append(Request(uid=f"req{i}", prompt=list(map(int, toks)),
                            max_new=max_new, sampling=sp))
    block = 8
    per_seq = blocks_for(prompt_len + max_new, block) + 1
    slots = min(requests, 4)
    ecfg = EngineConfig(max_slots=slots, block_size=block,
                        num_blocks=per_seq * slots + 2,
                        max_blocks_per_seq=per_seq)
    dev = P.tree_leaves(params)[0].device
    engine = ServeEngine(params, cfg, ecfg, device=LAPTOP_M2PRO,
                         torch_device=dev)
    out = engine.run(reqs)
    s = engine.stats()

    print(f"served {len(out)} requests / "
          f"{int(s['tokens_generated'])} tokens in {engine.wall_s:.2f}s "
          f"({s['tokens_per_s']:.1f} tok/s, {int(s['steps'])} engine steps, "
          f"{slots} slots)")
    print(f"paged KV: peak {s['peak_cache_bytes']/1e3:.1f} kB of "
          f"{s['pool_bytes']/1e3:.1f} kB pool; peak fragmentation "
          f"{s['frag_tokens_peak']:.0f} tokens, peak utilization "
          f"{100*s['utilization_peak']:.0f}%")
    print(f"energy ({LAPTOP_M2PRO.name}): {s['energy_j']:.2f} J "
          f"({s['j_per_token']:.3f} J/token, {s['carbon_g']:.4f} gCO2e)")
    first = out[reqs[0].uid]
    print(f"sample ({first.uid}): {first.tokens[:8]}")
    return reqs, out, engine


def run_dense(cfg, params, *, requests: int = 6, prompt_len: int = 16,
              max_new: int = 24):
    """Dense greedy decoding of ``requests`` prompts of ``prompt_len``
    tokens (seed 1) plus ``max_new`` new ones on the params' device; an
    encoder-decoder decodes against the encoder's output of random frames
    (seed 2).  Each token's decode FLOPs and HBM bytes are priced on the
    laptop's component model.  Prints the example's report; returns
    (prompt ids, generated ids, wall seconds, monitor)."""
    from repro_torch.serve.step import greedy_generate

    dev = P.tree_leaves(params)[0].device
    batch = requests
    prompt = prompt_tokens(1, (batch, prompt_len), cfg.vocab_size)
    enc = None
    if cfg.is_encoder_decoder:
        frames = np.random.default_rng(2).standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32)
        with torch.inference_mode():
            enc = M.encoder_forward(params, cfg,
                                    torch.from_numpy(frames).to(dev), {})

    t0 = time.time()
    out = greedy_generate(params, cfg, torch.from_numpy(prompt).to(dev),
                          max_new=max_new, enc=enc)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    total = prompt_len + max_new
    monitor = EnergyMonitor(ComponentModel.for_device(LAPTOP_M2PRO))
    for i in range(max_new):
        monitor.record_step(
            flops=F.decode_flops(cfg, batch, prompt_len + i),
            hbm_bytes=F.decode_hbm_bytes(cfg, batch, prompt_len + i),
            duration_s=wall / total)

    print(f"generated {batch}x{max_new} tokens in {wall:.2f}s "
          f"({batch*max_new/wall:.1f} tok/s)")
    print(f"sample token ids: {list(map(int, out[0, -8:]))}")
    bd = monitor.breakdown_j()
    print(f"decode energy model ({LAPTOP_M2PRO.name}): "
          f"{monitor.total_j:.2f} J  "
          f"[compute {bd['compute']:.2f} | memory {bd['memory']:.2f} | "
          f"static {bd['static']:.2f}]")
    return prompt, out, wall, monitor


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.torch_device)

    cfg = get_config(args.arch + "-smoke")      # reduced variant
    print(f"arch: {args.arch} (reduced: {cfg.num_layers}L "
          f"d={cfg.d_model}, {cfg.param_count()/1e6:.1f}M params)")
    params = P.init_params(cfg, device=dev, seed=0)

    kw = dict(requests=args.requests, prompt_len=args.prompt_len,
              max_new=args.max_new)
    if M.paged_decode_supported(cfg):
        run_engine(cfg, params, temperature=args.temperature,
                   top_k=args.top_k, **kw)
    else:
        print(f"({args.arch} caches are not token-paged; dense greedy path)")
        run_dense(cfg, params, **kw)


if __name__ == "__main__":
    main()
