"""Readings that the limits of ``correct`` are set from (not part of a
benchmark run):

    python portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 1,2,3] [--half 1,2,3] [--out file.jsonl]

For each of ``--seeds``: the program's check steps (the cell's own timed
path, with a one-step window) and their numbers against the plain
reference.  For each of ``--control``: the reference computed with every
matmul's inputs in float8 e4m3, put in the program's place.  For each of
``--half``: the reference put in the program's place with half of each
step's rows left out, the mean taken over the rest.  One JSON line a
reading, on standard output and in ``--out``.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def _seeds(s):
    return [int(x) for x in s.split(",") if x] if s else []


def _detail(prog, ref):
    """Each leaf's program and reference norms, by its path."""
    return {f"{k}_leaves": {"/".join(p): [prog[k][p], ref[k][p]]
                            for p in ref[k]} for k in ("grad1", "dparam")}


def main(argv=None, *, device=None, cell=None, conf=None):
    import argparse

    import torch

    from portbench.lib import check as C
    from portbench.lib import harness as H
    from portbench.lib import registry as REG
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--half", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    H.cache_env()
    cell = cell or REG.workload(a.workload)
    conf = conf or REG.config(cell["config"])
    if device is None:
        H.require_cards(1)
        device = torch.device("cuda", 0)
    kind = REG.traffic(cell["traffic"])
    out = open(a.out, "a") if a.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def ctx(seed):
        return H.Ctx(cell=cell, conf=conf, seed=seed, seconds=0.0,
                     trace=False, device=device)

    def free():
        if device.type == "cuda":
            torch.cuda.empty_cache()

    tp = cell["traffic_params"]
    refs = {}

    def reference(seed):
        if seed not in refs:
            refs[seed] = kind.reference(ctx(seed))
            free()
        return refs[seed]

    for seed in _seeds(a.seeds):
        t = time.perf_counter()
        run = kind.run(ctx(seed))
        prog = run.prog
        del run
        free()
        t1 = time.perf_counter()
        ref = reference(seed)
        emit({"kind": "program", "seed": seed,
              **C.readings(prog, ref), "losses": prog["losses"],
              "ref_losses": ref["losses"], **_detail(prog, ref),
              "program_s": t1 - t, "reference_s": time.perf_counter() - t1})
    for name, flag in (("control", "control"), ("half", "half")):
        for seed in _seeds(getattr(a, flag)):
            ref = reference(seed)
            t = time.perf_counter()
            if name == "control":
                other = kind.reference(ctx(seed), quant=True)
            else:
                other = kind.reference(ctx(seed),
                                       rows=range(tp["batch"] // 2))
            free()
            emit({"kind": name, "seed": seed, **C.readings(other, ref),
                  "losses": other["losses"], "ref_losses": ref["losses"],
                  **_detail(other, ref), "seconds": time.perf_counter() - t})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
