"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the continuous-batching paged-KV engine (``repro_torch.serve.engine``)
over a mixed-length request set (reduced variant by default, ``--full``
for the published widths) on the card, and prints tokens/s plus the
per-token energy/carbon estimate.  Architectures whose caches the engine
cannot page (Mamba2's recurrent state, MLA's latent cache, whisper's
encoder K/V), or ``--legacy``, fall back to the dense
``serve.step.greedy_generate`` path; for an encoder-decoder it first runs
the encoder over seeded random frames (the audio frontend stub).  A
warmup runs before the
timing window so the kernel build and first-launch costs stay out of
tokens/s.  ``--torch-device cpu`` runs the plain PyTorch versions on the
CPU.

``--slo ttft=0.5,itl=0.2`` monitors the serve SLOs with burn rates (the
engine defers admissions past half its slots while the TTFT SLO burns)
and prints their verdicts; ``--health-out health.jsonl`` writes the SLO
verdicts and the alert record, which ``python -m repro_torch.obs.validate``
checks.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=8,
                    help="number of requests in the mixed-length set")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="max prompt length (requests vary 4..prompt-len)")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="accepted as the JAX launcher does; serving sets "
                         "no mesh, so it changes nothing")
    ap.add_argument("--device", default="cloud-h100",
                    help="energy/carbon profile from core.energy.devices "
                         "(smartphone-sd888 | laptop-m2pro | cloud-a5000 | "
                         "cloud-h100 | tpu-v5e)")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--attn-impl", default="kernel",
                    choices=["kernel", "gather"],
                    help="paged decode attention: the CUDA flash-decode "
                         "kernel or the plain dense-gather version")
    ap.add_argument("--kv-dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8"],
                    help="paged KV pool dtype; int8 stores quantized pages "
                         "with per-vector fp32 scales")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens fed per engine step, shared across "
                         "prefilling slots (1 = token-by-token)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable the prefix-cache index (every request "
                         "recomputes its full prompt)")
    ap.add_argument("--legacy", action="store_true",
                    help="force the dense greedy_generate path")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace/Perfetto JSON timeline")
    ap.add_argument("--metrics-out", default=None,
                    help="write the engine metrics registry as JSONL")
    ap.add_argument("--slo", default=None, metavar="K=V[,K=V...]",
                    help="monitor serve SLOs (the engine defers "
                         "admissions while the TTFT SLO burns); keys: "
                         "ttft=<p99 s>, itl=<inter-token p99 s>, "
                         "gco2e=<budget>, horizon=<s> (e.g. "
                         "--slo ttft=0.5,gco2e=2)")
    ap.add_argument("--health-out", default=None,
                    help="write the SLO verdicts + alert record as JSONL")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.energy.devices import get_device
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.models import params as P
    from repro_torch.obs import (HealthMonitor, SLOMonitor, Tracer,
                                 get_tracer, serve_slos, set_tracer)

    dev = resolve_device(args.torch_device)
    energy = get_device(args.device)
    cfg = get_config(args.arch if args.full else args.arch + "-smoke")
    print(f"[serve] {cfg.name}: {cfg.param_count()/1e6:.1f}M params on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev} "
          f"(energy profile: {energy.name})")
    params = P.init_params(cfg, device=dev, seed=0)
    if args.trace_out or args.metrics_out:
        set_tracer(Tracer(enabled=True, process=f"serve:{cfg.name}"))
    slo = health = None
    if args.slo is not None or args.health_out is not None:
        health = HealthMonitor()
        kv = dict(p.split("=", 1) for p in (args.slo or "").split(",") if p)
        slo = SLOMonitor(serve_slos(
            ttft_p99_s=float(kv.get("ttft", 0.5)),
            inter_token_p99_s=float(kv.get("itl", 0.2)),
            gco2e_budget=float(kv.get("gco2e", 0)),
            horizon_s=float(kv.get("horizon", 3600.0))),
            registry=health.registry)
    if args.legacy or not M.paged_decode_supported(cfg):
        _run_legacy(args, cfg, params, energy, dev)
        if slo is not None:
            print(f"[serve] {slo.summary_line()}")
    else:
        _run_engine(args, cfg, params, energy, dev, slo=slo, health=health)
    if args.health_out and health is not None:
        health.dump_jsonl(args.health_out, slo=slo,
                          meta={"arch": cfg.name, "requests": args.batch,
                                "torch_device": str(dev)})
        print(f"[serve] health record: {args.health_out}")
    if args.trace_out:
        get_tracer().save_chrome_trace(args.trace_out)
        print(f"[serve] trace: {args.trace_out} "
              f"({len(get_tracer().events)} events)")


def _run_engine(args, cfg, params, energy, dev, slo=None,
                health=None) -> None:
    import numpy as np

    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serve.paged_cache import blocks_for

    block = 16
    slots = min(args.batch, 8)
    per_seq = blocks_for(args.prompt_len + args.max_new, block) + 1
    ecfg = EngineConfig(max_slots=slots, block_size=block,
                        num_blocks=per_seq * slots + 2,
                        max_blocks_per_seq=per_seq,
                        attn_impl=args.attn_impl,
                        cache_dtype=args.kv_dtype,
                        prefill_chunk=args.prefill_chunk,
                        prefix_sharing=not args.no_prefix_sharing)
    engine = ServeEngine(params, cfg, ecfg, device=energy, torch_device=dev,
                         slo=slo)
    engine.warmup()
    engine.reset_stats()

    lens = [4 + (7 * i) % max(args.prompt_len - 3, 1)
            for i in range(args.batch)]
    reqs = [Request(uid=f"r{i}", max_new=args.max_new,
                    prompt=list(map(int, np.random.RandomState(100 + i)
                                    .randint(0, cfg.vocab_size, L))))
            for i, L in enumerate(lens)]
    engine.run(reqs)
    s = engine.stats()
    print(f"[serve] engine: {int(s['tokens_generated'])} tokens in "
          f"{engine.wall_s:.2f}s ({s['tokens_per_s']:.1f} tok/s, "
          f"{int(s['steps'])} steps, {ecfg.max_slots} slots, "
          f"attn={ecfg.attn_impl})")
    if "ttft_p50_s" in s:
        print(f"[serve] TTFT p50 {s['ttft_p50_s']*1e3:.1f} ms / "
              f"p99 {s['ttft_p99_s']*1e3:.1f} ms")
    print(f"[serve] paged KV: peak {s['peak_cache_bytes']/1e6:.2f} MB of "
          f"{s['pool_bytes']/1e6:.2f} MB pool "
          f"(peak frag {s['frag_tokens_peak']:.0f} tokens, "
          f"peak util {100*s['utilization_peak']:.0f}%)")
    print(f"[serve] fast path: prefix hit rate "
          f"{100*s['prefix_hit_rate']:.0f}% "
          f"({int(s['prefix_hit_tokens'])} tokens), "
          f"{int(s['cow_forks_total'])} CoW forks "
          f"(chunk={ecfg.prefill_chunk}, kv={ecfg.cache_dtype})")
    print(f"[serve] energy ({energy.name}): {s['energy_j']:.2f} J "
          f"({s['j_per_token']:.3f} J/token, {s['carbon_g']:.4f} gCO2e)")
    if args.metrics_out:
        engine.metrics.dump_jsonl(
            args.metrics_out,
            meta={"arch": cfg.name, "requests": args.batch,
                  "max_new": args.max_new, "attn_impl": args.attn_impl,
                  "torch_device": str(dev)})
        print(f"[serve] metrics: {args.metrics_out}")
    if slo is not None:
        # carbon spend paces against the budget over the serving window
        slo.observe("serve_gco2e", s["carbon_g"], t=0.0)
        slo.observe("serve_gco2e", 0.0, t=max(engine.wall_s, 1e-9))
        deferred = int(engine.metrics.counter(
            "serve/admission_deferred").value)
        print(f"[serve] {slo.summary_line()} | admissions deferred "
              f"under burn: {deferred}")
    if health is not None:
        print(f"[serve] health: {health.summary_line()}")


def _run_legacy(args, cfg, params, energy, dev) -> None:
    """Dense greedy decoding of ``--batch`` prompts of ``--prompt-len``
    tokens plus ``--max-new`` new ones, with the analytic decode FLOPs
    priced on the energy profile's peak (``CLOUD_H100`` by default).  An
    encoder-decoder decodes against the encoder's output of random frames
    drawn from a seeded generator on the model's device."""
    import time

    import numpy as np
    import torch

    from repro_torch.core import flops as F
    from repro_torch.models import model as M
    from repro_torch.obs import MetricsRegistry, get_tracer
    from repro_torch.serve.step import greedy_generate

    prompt = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)
    enc = None
    if cfg.is_encoder_decoder:
        gen = torch.Generator(device=dev).manual_seed(2)
        frames = torch.randn((args.batch, cfg.encoder_seq_len, cfg.d_model),
                             generator=gen, device=dev)
        with torch.inference_mode():
            enc = M.encoder_forward(params, cfg, frames, {})
    # warmup at the same shapes: kernel builds and first launches stay
    # outside the timing window
    greedy_generate(params, cfg, prompt, max_new=2,
                    cache_len=args.prompt_len + args.max_new, enc=enc)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with get_tracer().span("greedy_generate", "serve", batch=args.batch,
                           max_new=args.max_new):
        out = greedy_generate(params, cfg, prompt, max_new=args.max_new,
                              enc=enc)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    n_new = args.batch * args.max_new
    dec_flops = sum(F.decode_flops(cfg, args.batch, args.prompt_len + i)
                    for i in range(args.max_new))
    print(f"[serve] legacy dense: {n_new} tokens in {wall:.2f}s "
          f"({n_new / wall:.1f} tok/s); analytic decode "
          f"{dec_flops / 1e9:.2f} GFLOP ({energy.name} roofline: "
          f"{dec_flops / energy.peak_flops * 1e3:.3f} ms compute-bound)")
    print(f"[serve] sample: {out[0, -10:].tolist()}")
    if args.metrics_out:
        reg = MetricsRegistry()
        reg.counter("serve/tokens").inc(n_new)
        reg.histogram("serve/tokens_per_s", lo=1e-3, hi=1e6) \
            .observe(n_new / wall)
        reg.dump_jsonl(args.metrics_out,
                       meta={"arch": cfg.name, "path": "legacy",
                             "torch_device": str(dev)})
        print(f"[serve] metrics: {args.metrics_out}")


if __name__ == "__main__":
    main()
