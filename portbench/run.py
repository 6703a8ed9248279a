"""Run one benchmark cell of the PyTorch port once, on the card:

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the kernel libraries, the seed's weights on the card, a
warm-up of the cell's shapes, the check steps) is timed from the process's
start to the window's; the window then runs the cell's traffic for about
``--seconds``.  ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled stretch of the window.
Once the window has closed, the plain reference follows the check steps
from the same seed, and ``correct`` says whether the program's steps
agree with it within each number's limit.  The last line of standard
output is the result, a JSON object; the numbers compared, each beside
its limit, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def _gpu_id(torch) -> str:
    uuid = getattr(torch.cuda.get_device_properties(0), "uuid", None)
    return f"GPU-{uuid}" if uuid is not None else "0"


def main(argv=None, *, device=None, cell=None, conf=None) -> int:
    """One run.  ``device``, ``cell`` and ``conf`` are for the CPU tests:
    they skip the look for a card and name the cell's files' contents."""
    from portbench.lib import check as C
    from portbench.lib import harness as H
    from portbench.lib import registry as REG
    args = H.parse_args(argv)
    H.cache_env()
    bench = REG.benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None and cell is None:
        raise SystemExit(f"portbench: no cell {args.workload!r} in "
                         "BENCHMARK.json")
    cell = cell or REG.workload(args.workload)
    conf = conf or REG.config(cell["config"])
    import torch
    if device is None:
        H.require_cards(entry["chips"])
        device = torch.device("cuda", 0)
    kind = REG.traffic(cell["traffic"])
    listed = REG.cell_metrics(bench, entry["name"] if entry else
                              cell["name"])
    wanted = listed["per_layer" if args.trace else "end_to_end"]
    readers = {m["name"]: REG.metric(m["name"]) for m in wanted}
    power = None
    if device.type == "cuda":
        from portbench.lib.power import PowerStream
        power = PowerStream(_gpu_id(torch))
    ctx = H.Ctx(cell=cell, conf=conf, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), device=device,
                min_window=kind.MIN_TRACED if args.trace else 1)
    try:
        run = kind.run(ctx)
        run.setup_s = run.window.t0 - T_START
        if power is not None:
            run.power_w, run.power_samples = power.mean_w(run.window.t0,
                                                          run.window.t1)
            if run.power_w is None:
                raise SystemExit("portbench: nvidia-smi gave no power "
                                 "reading inside the window")
    finally:
        if power is not None:
            power.close()
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    found = H.forbidden_loaded()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = kind.reference(ctx)
    ok, checks = C.judge(C.readings(run.prog, ref), cell["limits"])
    checks["nonfinite_losses"] = {"value": run.failed, "limit": 0}
    ok = ok and run.failed == 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": entry["chips"] if entry else 1,
           "memory_peak_bytes": run.window.peak_bytes or 0}
    result = {"correct": ok, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        from portbench.lib.profile import breakdown
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run.trace)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
