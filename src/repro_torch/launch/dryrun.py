"""The dry run: trace every (arch x shape) case of the production mesh on
a fake process group of 256 or 512 ranks, and record what one rank does
(port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The JAX package lowers and compiles each case for 512 placeholder
devices and reads the per-device HLO.  Here the mesh is
``launch.mesh.fake_production_mesh`` (16 x 16 ``(data, model)``, or
2 x 16 x 16 with ``pod``), seen from rank 0, and the step runs eagerly
on ``meta`` shards: every parameter, moment, batch and cache leaf is a
``DTensor.from_local`` of a ``meta`` tensor of its local shard's shape
and its ``abstract_params`` / ``abstract_cache`` dtype, placed by
``distributed.sharding``, so nothing is materialised and nothing is
computed.  (``FakeTensorMode`` gives the same counts, 2.5 times slower:
every op pays its Python dispatch.)  ``launch.step_analysis.StepCounter``
counts rank 0's local ops, collectives and storages as it runs.  It runs
on the CPU by design, as the JAX dry run does (the fake group's mesh is
a CPU mesh).

The cases are the JAX package's: the train step with ``microbatches``
(8) and ``remat`` ("full") and AdamW with ``moment_dtype`` moments;
prefill as ``forward_logits`` with ``attn_impl="chunked"``; decode as
``serve.step.make_serve_step`` over the cache of ``launch.specs.
cache_len``, batch-sharded, or sequence-sharded over ``data`` too at
``long_500k``'s batch of 1.  Attention is the chunked path everywhere
(the kernels read data a meta tensor does not have, and refuse it).

The record has every field of the JAX record.  ``lower_s`` is the time
to build the sharded ``meta`` state, ``compile_s`` the time to trace
the step.  ``flops_per_device`` equals ``hlo_flops_per_device`` and the byte
fields are an upper bound (see ``step_analysis``).  The port adds
``param_bytes_per_device``, ``opt_bytes_per_device`` and FLOPs by op.
Records go to ``experiments/dryrun_torch/``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.configs.registry import (INPUT_SHAPES, InputShape,
                                          get_config, input_shape,
                                          list_archs, shape_applicable)
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.act_sharding import use_mesh
from repro_torch.launch import specs as SP
from repro_torch.launch import step_analysis as SA
from repro_torch.launch.mesh import fake_production_mesh
from repro_torch.models import model as M
from repro_torch.models import params as PM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.serve.step import make_prefill, make_serve_step
from repro_torch.train.step import make_train_step

RESULT_DIR = (Path(__file__).resolve().parents[3] / "experiments"
              / "dryrun_torch")
RULES = {"default": SH.DEFAULT_RULES, "tp_only": SH.TP_ONLY_RULES}
PyTree = Any


def _local_shape(shape, place, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for i, p in enumerate(place):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def meta_dtensor(meta: torch.Tensor, spec, mesh):
    """A DTensor of ``meta``'s shape and dtype placed by the placement
    tuple ``spec``, over a ``meta`` local shard.  The rule tables shard a
    dim only where the mesh extent divides it, so every rank's shard has
    one shape."""
    from torch.distributed.tensor import DTensor
    place = SH.placements(spec, mesh)
    shard = torch.empty(_local_shape(meta.shape, place, mesh),
                        dtype=meta.dtype, device="meta")
    return DTensor.from_local(shard, mesh, place, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def meta_tree(metas: PyTree, specs: PyTree, mesh) -> PyTree:
    if isinstance(metas, dict):
        return {k: meta_tree(metas[k], specs[k], mesh) for k in metas}
    return meta_dtensor(metas, specs, mesh)


def local_bytes(tree: PyTree) -> int:
    return sum(SA.local(t).numel() * SA.local(t).element_size()
               for t in PM.tree_leaves(tree))


def case_config(arch: str, moe_layout: str = "",
                cfg: Optional[ModelConfig] = None) -> ModelConfig:
    cfg = cfg or get_config(arch)
    if moe_layout and cfg.moe.enabled:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, layout=moe_layout))
    return cfg


def build_state(cfg: ModelConfig, shape, mesh, *, rules_name: str,
                moment_dtype: str) -> Dict[str, Any]:
    """The step's sharded ``meta`` arguments for ``shape``'s kind on a
    (fake) mesh: ``params``, and ``opt`` and ``batch`` (train), ``batch``
    (prefill), or ``cache``, ``tokens`` and ``index`` (decode)."""
    rules = RULES[rules_name]
    params = meta_tree(PM.abstract_params(cfg),
                       SH.param_shardings(cfg, mesh, rules), mesh)
    state: Dict[str, Any] = {"params": params}
    if shape.kind == "decode":
        T = SP.cache_len(cfg, shape)
        B = shape.global_batch
        cache = M.abstract_cache(cfg, B, T)
        state["cache"] = meta_tree(
            cache, SH.cache_shardings(cfg, mesh, cache, B), mesh)
        tokens = SP.decode_specs(cfg, shape)["tokens"]
        state["tokens"] = meta_dtensor(
            tokens, SH.batch_spec(mesh, B) + (None,), mesh)
        state["index"] = T - 1
        return state
    batch = SP.input_specs(cfg, shape)
    if shape.kind == "prefill":
        batch.pop("labels", None)
    specs = SH.batch_shardings(mesh, batch)
    state["batch"] = {k: meta_dtensor(v, specs[k], mesh)
                      for k, v in batch.items()}
    if shape.kind == "train":
        state["opt"] = adamw.init_opt_state(
            params, adamw.OptConfig(moment_dtype=moment_dtype))
    return state


def run_step(cfg: ModelConfig, kind: str, state: Dict[str, Any], *,
             remat: str, microbatches: int, moment_dtype: str):
    """The case's step on ``state``; returns (arguments, outputs)."""
    p = state["params"]
    if kind == "train":
        step = make_train_step(
            cfg, adamw.OptConfig(moment_dtype=moment_dtype), remat=remat,
            attn_impl="chunked", microbatches=microbatches)
        args = (p, state["opt"], state["batch"])
        return args, step(*args)
    if kind == "prefill":
        args = (p, state["batch"])
        return args, make_prefill(cfg, attn_impl="chunked",
                                  use_kernel=False)(*args)
    args = (p, state["cache"], state["tokens"])
    return args, make_serve_step(cfg)(p, state["cache"], state["tokens"],
                                      state["index"])


def trace_case(cfg: ModelConfig, shape: InputShape, mesh, *,
               remat: str = "full", moment_dtype: str = "float32",
               rules_name: str = "default", microbatches: int = 8,
               where=None) -> Dict[str, Any]:
    """Build the case's sharded ``meta`` state on ``mesh`` (a fake mesh)
    and trace its step under a ``StepCounter``: {"counter", "memory",
    "param_bytes", "opt_bytes", "lower_s", "compile_s"}."""
    with use_mesh(mesh):
        t0 = time.perf_counter()
        state = build_state(cfg, shape, mesh, rules_name=rules_name,
                            moment_dtype=moment_dtype)
        t_lower = time.perf_counter() - t0
        counter = SA.StepCounter(where)
        counter.track(state)
        t0 = time.perf_counter()
        with counter:
            args, outs = run_step(cfg, shape.kind, state, remat=remat,
                                  microbatches=microbatches,
                                  moment_dtype=moment_dtype)
        t_compile = time.perf_counter() - t0
        return {"counter": counter, "memory": SA.memory(counter, args, outs),
                "param_bytes": local_bytes(state["params"]),
                "opt_bytes": local_bytes(state.get("opt", {})),
                "lower_s": t_lower, "compile_s": t_compile}


def lower_case(arch: str, shape_name: str, *, multi_pod: bool = False,
               remat: str = "full", moment_dtype: str = "float32",
               rules_name: str = "default", microbatches: int = 8,
               moe_layout: str = "", cfg: Optional[ModelConfig] = None,
               mesh=None, where=None) -> Dict[str, Any]:
    """One case's record.  ``cfg`` replaces the registry's config of
    ``arch`` (a reduced depth) and ``mesh`` (a fake mesh the caller
    holds) the production mesh; ``where`` is ``StepCounter``'s, and the
    counter is returned under ``"counter"`` when it is given."""
    cfg = case_config(arch, moe_layout, cfg)
    shape = input_shape(shape_name)
    with contextlib.ExitStack() as stack:
        if mesh is None:
            mesh = stack.enter_context(fake_production_mesh(multi_pod=multi_pod))
        t = trace_case(cfg, shape, mesh, remat=remat,
                       moment_dtype=moment_dtype, rules_name=rules_name,
                       microbatches=microbatches, where=where)
        dims = tuple(mesh.shape)
    counter = t["counter"]
    ct = SA.compute_totals(counter)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, dims)),
        "chips": int(torch.Size(dims).numel()),
        "kind": shape.kind,
        "remat": remat, "moment_dtype": moment_dtype, "rules": rules_name,
        "microbatches": microbatches if shape.kind == "train" else None,
        "lower_s": round(t["lower_s"], 1),
        "compile_s": round(t["compile_s"], 1),
        "flops_per_device": ct["flops"],
        "bytes_accessed_per_device": ct["bytes_accessed"],
        "hlo_flops_per_device": ct["flops"],
        "hlo_bytes_per_device": ct["bytes_accessed"],
        "flops_by_op": ct["flops_by_op"],
        "memory": t["memory"],
        "param_bytes_per_device": t["param_bytes"],
        "opt_bytes_per_device": t["opt_bytes"],
        "collectives": SA.collective_totals(counter),
        "params_total": PM.count_params(cfg),
        "params_active": PM.count_params(cfg, active_only=True),
    }
    if where is not None:
        rec["counter"] = counter
    return rec


def record_name(arch: str, shape_name: str, tag: str = "", **kw) -> str:
    suffix = "multipod" if kw.get("multi_pod") else "pod"
    extra = f"_{tag}" if tag else ""
    if not tag and (kw.get("remat", "full") != "full"
                    or kw.get("moment_dtype", "float32") != "float32"
                    or kw.get("rules_name", "default") != "default"):
        extra = (f"_{kw.get('remat', 'full')}"
                 f"_{kw.get('moment_dtype', 'float32')}"
                 f"_{kw.get('rules_name', 'default')}")
    return f"{arch}_{shape_name}_{suffix}{extra}.json"


def run_and_save(arch: str, shape_name: str, tag: str = "",
                 out_dir: Optional[Path] = None, **kw) -> Dict[str, Any]:
    """Trace one case and write its record (under ``perf/`` beside the
    records with a ``tag``)."""
    rec = lower_case(arch, shape_name, **kw)
    out_dir = out_dir or (RESULT_DIR if not tag
                          else RESULT_DIR.parent / "perf_torch")
    out_dir.mkdir(parents=True, exist_ok=True)
    rec["tag"] = tag
    out = out_dir / record_name(arch, shape_name, tag, **kw)
    out.write_text(json.dumps(rec, indent=1))
    print(f"[dryrun] {arch} x {shape_name} ({rec['mesh']}): "
          f"trace {rec['compile_s']}s, "
          f"flops/dev {rec['hlo_flops_per_device']:.3e}, "
          f"mem temp {rec['memory']['temp_bytes']/2**30:.2f} GiB, "
          f"coll {rec['collectives']['total_bytes']/2**30:.3f} GiB "
          f"-> {out.name}", flush=True)
    return rec


def table(out_dir: Path = RESULT_DIR) -> List[str]:
    """A markdown table of the records in ``out_dir``, a row an arch x
    shape, each cell the meshes' values in order of size (``16x16 /
    2x16x16``): the parameter and temp GB a device, the collective GB a
    device by kind, the FLOPs a device and the seconds a case (lower +
    trace)."""
    kinds = ("all-gather", "all-reduce", "reduce-scatter")
    lines = ["| arch | shape | param GB | temp GB | "
             + " | ".join(f"{k} GB" for k in kinds)
             + " | FLOPs/dev | s |",
             "|---" * (6 + len(kinds)) + "|"]
    rows: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
    for p in sorted(out_dir.glob("*.json")):
        r = json.loads(p.read_text())
        rows.setdefault((r["arch"], r["shape"]), []).append(r)
    for (arch, shape), recs in sorted(rows.items()):
        recs.sort(key=lambda r: r["chips"])

        def cell(fn, fmt):
            return " / ".join(format(fn(r), fmt) for r in recs)
        coll = [cell(lambda r, k=k: r["collectives"]["bytes_by_op"].get(
            k, 0) / 1e9, ".3f") for k in kinds]
        lines.append(
            f"| {arch} | {shape} | "
            f"{cell(lambda r: r['param_bytes_per_device'] / 1e9, '.3f')} | "
            f"{cell(lambda r: r['memory']['temp_bytes'] / 1e9, '.2f')} | "
            + " | ".join(coll)
            + f" | {cell(lambda r: r['hlo_flops_per_device'], '.3e')} | "
            f"{cell(lambda r: r['lower_s'] + r['compile_s'], '.1f')} |")
    return lines


def cases() -> Iterator[Tuple[str, str]]:
    """Every (arch, shape) of the matrix: ``shape_applicable``'s."""
    for arch in list_archs(assigned_only=True):
        for shape_name in INPUT_SHAPES:
            if shape_applicable(arch, shape_name):
                yield arch, shape_name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape)")
    ap.add_argument("--skip-existing", action="store_true",
                    help="with --all: skip cases whose record exists")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--rules", default="default", choices=list(RULES))
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--tag", default="",
                    help="save under experiments/perf_torch/")
    ap.add_argument("--moe-layout", default="",
                    choices=["", "auto", "ep_full", "unconstrained"])
    ap.add_argument("--table", action="store_true",
                    help="print a markdown table of the saved records")
    args = ap.parse_args(argv)
    if args.table:
        print("\n".join(table()))
        return

    kw = dict(multi_pod=args.multi_pod, remat=args.remat,
              moment_dtype=args.moment_dtype, rules_name=args.rules,
              microbatches=args.microbatches, tag=args.tag,
              moe_layout=args.moe_layout)
    if args.all:
        for arch, shape_name in cases():
            if args.skip_existing and (
                    RESULT_DIR / record_name(arch, shape_name, **kw)).exists():
                continue
            run_and_save(arch, shape_name, **kw)
        return
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    if not shape_applicable(args.arch, args.shape):
        print(f"[dryrun] SKIP {args.arch} x {args.shape} (long_500k needs "
              "sub-quadratic attention)")
        return
    run_and_save(args.arch, args.shape, **kw)


if __name__ == "__main__":
    main()
