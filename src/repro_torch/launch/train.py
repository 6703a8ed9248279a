"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the single-host trainer (``repro_torch.train.trainer``) on the card:
the reduced variant of ``--arch`` by default, ``--full`` for the published
widths.  Attention goes through the FA-2 CUDA kernels unless
``--attn-impl`` picks the plain ``chunked`` or ``naive`` path;
``--torch-device cpu`` runs the kernels' plain versions on the CPU.  It
prints the final loss, steps/s, tokens/s and the modelled energy and
carbon of the run on ``--device``'s energy profile.

``--local-sgd`` switches to the DiLoCo local-update loop
(``repro_torch.train.local_sgd``, ``--replicas`` x ``--inner-steps``);
``--async`` upgrades it to bounded-staleness async outer updates
(``--quorum`` / ``--staleness-bound``), and ``--straggler-frac`` /
``--crash-prob`` / ``--link-flap-prob`` inject a deterministic,
seed-replayable fault plan (``--fault-seed``).  ``--checkpoint-dir`` with
``--checkpoint-every`` (steps, or rounds under ``--local-sgd``) saves
checkpoints in the JAX package's format; ``--resume`` restores the newest
complete one first.  The DT-FM pipeline runs through
``repro_torch.distributed`` (see ``examples/torch_decentralized_pipeline.py``).

Mesh: ``--mesh d,m`` runs the same trainer, or the same local-SGD loop,
on a ``(data, model)`` mesh of d x m ranks, as the JAX launcher runs
them under an ambient mesh (``repro_torch.distributed.runtime.spawn``,
one process a device, their collectives through host memory they share;
on the card all of them share it): FSDP over ``data`` and Megatron
tensor parallelism over ``model`` (``distributed.sharding``), every
piece of state a DTensor (``distributed.spmd.train`` / ``local_sgd``).
Every flag works with it: ``--local-sgd``, ``--async`` and the fault
plan, ``--checkpoint-dir`` / ``--resume`` (one leaf-modulo shard a rank,
in the single-device format, so a run resumes on another mesh shape or
with none), and the records: each rank keeps its own, the launcher
writes rank 0's metrics, health and SLO records (the ranks agree on
every loss and on the modelled clock) and one trace holding every
rank's spans, each rank its own process (``train:<cfg>:rank<r>``).  It
prints each rank's ms a step (or a round, by phase), its collectives by
kind and its peak memory, then the same final lines as one process.
``--host-devices N`` is the CPU rank count and must equal d x m; alone
it changes nothing.

Health: ``--health-out health.jsonl`` attaches the streaming detectors
(stragglers / link degradation / loss spikes — the async quorum then
excludes *detected* stragglers) and writes their alert record;
``--slo tokens_per_s=500,gco2e=5`` adds burn-rate-monitored SLOs, with a
one-line verdict summary at the end of the run.  Check the record with
``python -m repro_torch.obs.validate health.jsonl`` and read it with
``python -m repro_torch.obs.analyze alerts health.jsonl``.

Telemetry: ``--trace-out trace.json`` writes a Chrome-trace / Perfetto
timeline: the host spans (``step``, ``data``, ``metrics_drain``,
``checkpoint``; local SGD's ``round``, ``replica``, ``inner_step``,
``pseudograd``, ``outer_sync``) and, on a ``device`` track, the device
time of the phases (``step`` / ``inner_step``, ``fwd_bwd``,
``accumulate``, ``compress``, ``adamw``, ``outer_sync``), each event
carrying its span's ``id`` and ``parent``;
``--metrics-out metrics.jsonl`` writes the metrics registry (per-phase
histograms, ``train/step_s`` in device seconds, loss and grad-norm
distributions).

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --torch-device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \\
        --full --batch 4 --seq 2048 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \\
        --full --batch 4 --seq 2048 --steps 4 --mesh 2,2
    PYTHONPATH=src python -m repro_torch.launch.train --torch-device cpu \\
        --mesh 2,2 --host-devices 4 --steps 3 --batch 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --torch-device cpu \\
        --mesh 2,2 --host-devices 4 --local-sgd --replicas 2 \\
        --inner-steps 2 --steps 4 --batch 4 --seq 32 --checkpoint-dir d \\
        --checkpoint-every 1 --trace-out t.json
    PYTHONPATH=src python -m repro_torch.launch.train --torch-device cpu \\
        --local-sgd --replicas 2 --inner-steps 2 --steps 8 --batch 2 \\
        --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --torch-device cpu \\
        --local-sgd --async --replicas 4 --inner-steps 2 --steps 12 \\
        --batch 2 --seq 16 --straggler-frac 0.3 --fault-seed 3 \\
        --health-out health.jsonl --slo tokens_per_s=500
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Any


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags (those of ``repro.launch.train``)."""
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
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="steps (rounds with --local-sgd) between saves")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest complete checkpoint in "
                         "--checkpoint-dir before training")
    ap.add_argument("--local-sgd", action="store_true",
                    help="run the DiLoCo local-update loop instead of "
                         "the plain trainer")
    ap.add_argument("--replicas", type=int, default=2,
                    help="local-SGD replica count")
    ap.add_argument("--inner-steps", type=int, default=8,
                    help="local-SGD inner steps per sync round (K)")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="bounded-staleness async outer updates instead "
                         "of the barrier sync round (implies --local-sgd)")
    ap.add_argument("--quorum", type=int, default=0,
                    help="async: replicas required before an outer "
                         "update fires (0 = all replicas)")
    ap.add_argument("--staleness-bound", type=int, default=0,
                    help="async: drop + resync replicas more than S "
                         "outer versions stale (0 = lockstep)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed the deterministic fault-injection plan")
    ap.add_argument("--straggler-frac", type=float, default=0.0,
                    help="fraction of replicas slowed 4-8x by the plan")
    ap.add_argument("--crash-prob", type=float, default=0.0,
                    help="per-round crash probability per replica")
    ap.add_argument("--link-flap-prob", type=float, default=0.0,
                    help="per-round link flap probability per replica")
    ap.add_argument("--slo", default=None, metavar="K=V[,K=V...]",
                    help="monitor train SLOs and print end-of-run "
                         "verdicts; keys: tokens_per_s=<floor>, "
                         "staleness=<bound>, gco2e=<budget>, "
                         "horizon=<s> (e.g. --slo tokens_per_s=500,"
                         "gco2e=5)")
    ap.add_argument("--health-out", default=None,
                    help="attach the streaming health detectors "
                         "(straggler / link / loss-spike) and write "
                         "their alert record + SLO verdicts as JSONL")
    ap.add_argument("--mesh", default=None, metavar="D[,M]",
                    help="train on a (data, model) mesh of D x M ranks "
                         "(FSDP over data, tensor parallelism over model)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="CPU rank count of --mesh (must equal D x M)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the launcher; returns the spawn's result under ``--mesh``
    (:class:`~repro_torch.distributed.runtime.SpawnResult`, one
    ``spmd.MeshRun`` or ``spmd.MeshLocalSGD`` a rank), else None."""
    args = parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
    if args.mesh:
        return train_on_mesh(args)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device

    dev = resolve_device(args.torch_device)
    cfg = get_config(args.arch if args.full else args.arch + "-smoke")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params on "
          f"{where}, attn={args.attn_impl}")
    rec = Records.start(args, cfg, f"train:{cfg.name}")
    res = _run(args, cfg, rec, dev)
    report(args, cfg, res, rec, [rec.tracer], dev)


@dataclass
class Records:
    """A run's monitors, as the flags ask for them: the metrics registry
    and an enabled tracer (installed as the process's tracer) for
    ``--trace-out`` / ``--metrics-out``, the energy monitor of
    ``--device``, the health monitor and the SLO monitor for
    ``--health-out`` / ``--slo``.  Picklable: a mesh rank sends its own
    back to the launcher."""
    registry: Any = None
    tracer: Any = None
    monitor: Any = None
    health: Any = None
    slo: Any = None

    @classmethod
    def start(cls, args: argparse.Namespace, cfg, process: str
              ) -> "Records":
        from repro_torch.core.energy.devices import get_device
        from repro_torch.core.energy.monitor import (ComponentModel,
                                                     EnergyMonitor)
        from repro_torch.obs import (HealthMonitor, MetricsRegistry,
                                     SLOMonitor, Tracer, set_tracer,
                                     train_slos)
        rec = cls()
        if args.trace_out or args.metrics_out:
            rec.registry = MetricsRegistry()
            rec.tracer = Tracer(enabled=True, registry=rec.registry,
                                process=process)
            set_tracer(rec.tracer)
        rec.monitor = EnergyMonitor(ComponentModel.for_device(
            get_device(args.device)))
        if args.health_out is not None or args.slo is not None:
            rec.health = HealthMonitor(registry=rec.registry)
            if args.slo is not None:
                kv = dict(p.split("=", 1) for p in args.slo.split(",") if p)
                rec.slo = SLOMonitor(train_slos(
                    tokens_per_s_floor=float(kv.get("tokens_per_s", 0)),
                    staleness_bound=float(kv.get("staleness", 0)),
                    gco2e_budget=float(kv.get("gco2e", 0)),
                    horizon_s=float(kv.get("horizon", 3600.0))),
                    registry=rec.health.registry)
        return rec


def _local(args: argparse.Namespace) -> bool:
    return args.local_sgd or args.async_mode


def _run(args: argparse.Namespace, cfg, rec: Records, dev, *, mesh=None,
         ls=None, opt_cfg=None):
    """The trainer or the local-SGD loop as the flags ask, with ``rec``'s
    monitors: in this process, or under ``mesh`` as its rank-side call
    (``spmd.train`` / ``spmd.local_sgd``).  ``ls`` replaces the flags'
    ``LocalSGDConfig`` and ``opt_cfg`` the default AdamW settings."""
    from repro_torch.distributed import spmd
    from repro_torch.train.trainer import TrainerConfig, train
    local = _local(args)
    tc = TrainerConfig(steps=args.steps, batch=args.batch, seq_len=args.seq,
                       microbatches=args.microbatches, remat=args.remat,
                       attn_impl=args.attn_impl,
                       checkpoint_dir=None if local else args.checkpoint_dir,
                       checkpoint_every=0 if local else args.checkpoint_every,
                       resume=args.resume and not local)
    if not local:
        kw = dict(monitor=rec.monitor, metrics=rec.registry,
                  health=rec.health)
        if mesh is not None:
            return spmd.train(mesh, cfg, tc, opt_cfg, device=dev, **kw)
        return train(cfg, tc, opt_cfg, device=dev, **kw)
    from repro_torch.core.faultinject import FaultPlan
    from repro_torch.train.local_sgd import LocalSGDConfig, train_local_sgd
    fault_plan = None
    if args.straggler_frac or args.crash_prob or args.link_flap_prob:
        fault_plan = FaultPlan(seed=args.fault_seed,
                               straggler_frac=args.straggler_frac,
                               crash_prob=args.crash_prob,
                               link_flap_prob=args.link_flap_prob)
    if ls is None:
        ls = LocalSGDConfig(replicas=args.replicas,
                            inner_steps=args.inner_steps,
                            checkpoint_dir=args.checkpoint_dir,
                            checkpoint_every_rounds=args.checkpoint_every,
                            resume=args.resume, async_mode=args.async_mode,
                            quorum=args.quorum or None,
                            staleness_bound=args.staleness_bound)
    kw = dict(monitor=None if ls.async_mode else rec.monitor,
              metrics=rec.registry, fault_plan=fault_plan,
              health=rec.health)
    if mesh is not None:
        return spmd.local_sgd(mesh, cfg, tc, ls, opt_cfg, device=dev, **kw)
    return train_local_sgd(cfg, tc, ls, opt_cfg, device=dev, **kw)


def run_rank(mesh, *, args: argparse.Namespace, cfg, ls=None, opt_cfg=None,
             device=None):
    """A ``--mesh`` rank: its own records (its tracer the process
    ``train:<cfg>:rank<r>``) and :func:`_run` under the mesh.  Returns the
    rank's ``spmd.MeshRun`` or ``spmd.MeshLocalSGD`` with the records
    attached (``.records``)."""
    rec = Records.start(args, cfg, f"train:{cfg.name}:rank{mesh.get_rank()}")
    out = _run(args, cfg, rec, device, mesh=mesh, ls=ls, opt_cfg=opt_cfg)
    out.records = rec
    return out


def report(args: argparse.Namespace, cfg, res, rec: Records, tracers,
           dev) -> None:
    """The final lines and the records of a run: ``res`` (a
    ``TrainerResult`` or ``LocalSGDResult``) and ``rec`` are the single
    process's, or rank 0's of a mesh (every rank holds the same losses
    and modelled clock); ``tracers`` every rank's, written as one trace,
    each rank its own process."""
    from repro_torch.core.carbon.accounting import CarbonLedger
    from repro_torch.obs.trace import save_chrome_traces
    local = _local(args)
    health, slo, registry = rec.health, rec.slo, rec.registry
    if local:
        tokens_s = res.steps_per_s * args.batch * args.seq
    else:
        tokens_s = res.steady_steps_per_s * args.batch * args.seq
    led = CarbonLedger()
    led.add_operational_wh("train", res.energy_wh)
    print(f"[train] final loss {res.final_loss:.4f}  "
          f"{res.steps_per_s:.2f} steps/s "
          f"({tokens_s:.0f} tokens/s"
          f"{'' if local else ' after the first step'})  "
          f"{res.energy_wh:.3f} Wh modelled  "
          f"{led.operational_kg*1000:.3f} gCO2e")
    if getattr(res, "mode", "") == "async":
        print(f"[train] async: {res.outer_updates} outer updates, "
              f"{res.dropped_stale} dropped stale, {res.resyncs} resyncs, "
              f"{res.crashes} crashes, "
              f"{res.virtual_tokens_per_s:.0f} virtual tok/s")
        if res.fault_counts:
            faults = " ".join(f"{k}={v}"
                              for k, v in sorted(res.fault_counts.items()))
            print(f"[train] faults: {faults}")
    if slo is not None:
        tok_s = getattr(res, "virtual_tokens_per_s", 0.0) \
            or res.steps_per_s * args.batch * args.seq
        slo.observe("train_tokens_per_s", tok_s)
        elapsed = getattr(res, "virtual_time_s", 0.0) \
            or args.steps / max(res.steps_per_s, 1e-9)
        slo.observe("train_gco2e", led.operational_kg * 1000, t=0.0)
        slo.observe("train_gco2e", 0.0, t=elapsed)
    if health is not None:
        print(f"[train] health: {health.summary_line()}")
    if slo is not None:
        print(f"[train] {slo.summary_line()}")
    if args.health_out:
        health.dump_jsonl(args.health_out, slo=slo,
                          meta={"arch": cfg.name, "steps": args.steps,
                                "local_sgd": local,
                                "torch_device": str(dev)})
        print(f"[train] health record: {args.health_out}")
    if args.trace_out:
        save_chrome_traces(args.trace_out, tracers)
        print(f"[train] trace: {args.trace_out} "
              f"({sum(len(t.events) for t in tracers)} events)")
    if args.metrics_out:
        registry.dump_jsonl(args.metrics_out,
                            meta={"arch": cfg.name, "steps": args.steps,
                                  "local_sgd": local,
                                  "attn_impl": args.attn_impl,
                                  "torch_device": str(dev)})
        print(f"[train] metrics: {args.metrics_out} "
              f"({len(registry.names())} metrics)")


def mesh_dims(args: argparse.Namespace):
    """``--mesh``'s (shape, axis names), checked against
    ``--host-devices``."""
    dims = tuple(int(x) for x in args.mesh.split(","))
    if not 1 <= len(dims) <= 2 or min(dims) < 1:
        raise ValueError(f"--mesh takes D or D,M, got {args.mesh!r}")
    world = 1
    for n in dims:
        world *= n
    if args.host_devices and args.host_devices != world:
        raise ValueError(f"--host-devices {args.host_devices} differs from "
                         f"the {world} ranks of --mesh {args.mesh}")
    return dims, ("data", "model")[:len(dims)]


def train_on_mesh(args: argparse.Namespace, *, ls=None, opt_cfg=None):
    """``--mesh``: :func:`run_rank` on every rank of a (data, model) mesh
    (``runtime.spawn``, the ``host`` transport), then each rank's
    summary, rank 0's final lines and records, and every rank's trace.
    ``ls`` and ``opt_cfg`` as :func:`_run` takes them.  Returns the
    :class:`~repro_torch.distributed.runtime.SpawnResult`."""
    import functools

    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.distributed import runtime, spmd
    from repro_torch.kernels.build import build_all

    dims, names = mesh_dims(args)
    dev = resolve_device(args.torch_device)
    cfg = get_config(args.arch if args.full else args.arch + "-smoke")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params on a "
          f"{' x '.join(map(str, dims))} {names} mesh of ranks on {where}, "
          f"attn={args.attn_impl}")
    if dev.type == "cuda":
        build_all()                    # the ranks only load the kernels
    call = functools.partial(run_rank, args=args, cfg=cfg, ls=ls,
                             opt_cfg=opt_cfg)
    res = runtime.spawn([call], shape=dims, names=names, transport="host",
                        device=dev)
    runs = res.values[0]
    for r, run in enumerate(runs):
        print(f"[train] rank {r} {tuple(run.coordinate)}: "
              f"{spmd.summary(run)}")
    print(f"[train] FA-2 launches {res.launches[0]}, int8 launches by rank "
          f"{res.quant8[0]}, AdamW launches by rank {res.adamw[0]}")
    report(args, cfg, runs[0].result, runs[0].records,
           [run.records.tracer for run in runs if run.records.tracer],
           dev)
    return res


if __name__ == "__main__":
    main()
