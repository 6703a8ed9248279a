"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the single-host trainer (``repro_torch.train.trainer``) on the card:
the reduced variant of ``--arch`` by default, ``--full`` for the published
widths.  Attention goes through the FA-2 CUDA kernels unless
``--attn-impl`` picks the plain ``chunked`` or ``naive`` path;
``--torch-device cpu`` runs the kernels' plain versions on the CPU.  It
prints the final loss, steps/s, tokens/s and the modelled energy and
carbon of the run on ``--device``'s energy profile.

Telemetry: ``--trace-out trace.json`` writes a Chrome-trace / Perfetto
timeline of the step phases (data / fwd_bwd_opt / metrics drain);
``--metrics-out metrics.jsonl`` writes the metrics registry (per-phase
step-time histograms, loss and grad-norm distributions).

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --torch-device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \\
        --full --batch 4 --seq 2048 --steps 8
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-125m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots", "dots_no_batch"])
    ap.add_argument("--full", action="store_true",
                    help="train the full config (needs the card)")
    ap.add_argument("--device", default="cloud-h100",
                    help="energy/carbon profile from core.energy.devices "
                         "(smartphone-sd888 | laptop-m2pro | cloud-a5000 | "
                         "cloud-h100 | tpu-v5e)")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--attn-impl", default="kernel",
                    choices=["kernel", "chunked", "naive"],
                    help="attention: the FA-2 CUDA kernels, or the plain "
                         "chunked online softmax / naive oracle")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace/Perfetto JSON timeline")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry as JSONL")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.carbon.accounting import CarbonLedger
    from repro_torch.core.energy.devices import get_device
    from repro_torch.core.energy.monitor import ComponentModel, EnergyMonitor
    from repro_torch.device import resolve_device
    from repro_torch.obs import MetricsRegistry, Tracer, get_tracer, set_tracer
    from repro_torch.train.trainer import TrainerConfig, train

    dev = resolve_device(args.torch_device)
    cfg = get_config(args.arch if args.full else args.arch + "-smoke")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params on "
          f"{where}, attn={args.attn_impl}")

    registry = None
    if args.trace_out or args.metrics_out:
        registry = MetricsRegistry()
        set_tracer(Tracer(enabled=True, registry=registry,
                          process=f"train:{cfg.name}"))
    monitor = EnergyMonitor(ComponentModel.for_device(
        get_device(args.device)))
    tc = TrainerConfig(steps=args.steps, batch=args.batch, seq_len=args.seq,
                       microbatches=args.microbatches, remat=args.remat,
                       attn_impl=args.attn_impl)
    res = train(cfg, tc, monitor=monitor, metrics=registry, device=dev)

    led = CarbonLedger()
    led.add_operational_wh("train", res.energy_wh)
    print(f"[train] final loss {res.final_loss:.4f}  "
          f"{res.steps_per_s:.2f} steps/s "
          f"({res.steady_steps_per_s * args.batch * args.seq:.0f} "
          f"tokens/s after the first step)  "
          f"{res.energy_wh:.3f} Wh modelled  "
          f"{led.operational_kg*1000:.3f} gCO2e")
    if args.trace_out:
        get_tracer().save_chrome_trace(args.trace_out)
        print(f"[train] trace: {args.trace_out} "
              f"({len(get_tracer().events)} events)")
    if args.metrics_out:
        registry.dump_jsonl(args.metrics_out,
                            meta={"arch": cfg.name, "steps": args.steps,
                                  "attn_impl": args.attn_impl,
                                  "torch_device": str(dev)})
        print(f"[train] metrics: {args.metrics_out} "
              f"({len(registry.names())} metrics)")


if __name__ == "__main__":
    main()
