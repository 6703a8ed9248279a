"""Attribute one rank's collective bytes to the code that issued them
(port of ``repro.launch.coll_attr``).

    PYTHONPATH=src python -m repro_torch.launch.coll_attr --arch X \\
        --shape Y [--multi-pod] [--microbatches N] [--top K]

Traces the case as ``launch.dryrun`` does and buckets every collective's
result bytes by kind and by where it was issued.  The JAX package reads
the ``op_name`` metadata of each HLO line; the port's model is written
as functions, not ``nn.Module``s, so a module tracker has nothing to
see: the source is the chain of the port's functions on the stack,
outermost first.  A collective issued in the backward is named by the
autograd node that ran it and the forward stack that made that node
(recorded by ``torch.autograd``'s anomaly mode while it traces).
Train and prefill cases only, as in the JAX package.
"""

from __future__ import annotations

import argparse
import re
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List

import torch

from repro_torch.configs.registry import INPUT_SHAPES, input_shape

_PACKAGE = str(Path(__file__).resolve().parents[1])
_SKIP = (str(Path(__file__).resolve().parent),)       # the dry run itself
_FRAME_RE = re.compile(r'File "([^"]+)", line \d+, in (\S+)')


def _path(frames: Iterable) -> str:
    """``a/b/c`` of the port's functions among (file, function) pairs,
    outermost first."""
    names = [fn for file, fn in frames
             if file.startswith(_PACKAGE) and not file.startswith(_SKIP)]
    return "/".join(names)


def issuer() -> str:
    """Where the collective being counted was issued: the port's
    functions on the stack, and in the backward the autograd node and
    the forward stack that made it."""
    frames = []
    f = sys._getframe(1)
    while f is not None:
        frames.append((f.f_code.co_filename, f.f_code.co_name))
        f = f.f_back
    here = _path(reversed(frames))
    node = torch._C._current_autograd_node()
    if node is None:
        return here
    forward = node.metadata.get("traceback_") or []
    made = _FRAME_RE.findall("".join(forward))
    return f"backward {node.name()} of {_path(made) or '?'}"


def attribute(by_source: Dict[tuple, int], top: int = 25) -> List[str]:
    """The report's lines: bytes by kind, then the ``top`` sources."""
    ops: Dict[str, float] = defaultdict(float)
    for (kind, _), b in by_source.items():
        ops[kind] += b
    lines = ["== by op =="]
    for k, v in sorted(ops.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {v / 2**30:10.4f} GiB  {k}")
    lines.append("== top sources ==")
    for (kind, where), v in sorted(by_source.items(),
                                   key=lambda kv: -kv[1])[:top]:
        if len(where) > 110:
            where = "..." + where[-107:]
        lines.append(f"  {v / 2**30:10.4f} GiB  {kind} :: {where}")
    return lines


def run(arch: str, shape_name: str, *, top: int = 25, **kw) -> List[str]:
    """Trace the case (``dryrun.lower_case``'s arguments) and return the
    report's lines."""
    from repro_torch.launch import dryrun
    if input_shape(shape_name).kind == "decode":
        raise SystemExit("decode attribution not wired; use train/prefill")
    with torch.autograd.set_detect_anomaly(True, check_nan=False):
        rec = dryrun.lower_case(arch, shape_name, where=issuer, **kw)
    return attribute(rec["counter"].by_source, top)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    for line in run(args.arch, args.shape, top=args.top,
                    multi_pod=args.multi_pod, remat=args.remat,
                    moment_dtype=args.moment_dtype,
                    microbatches=args.microbatches):
        print(line)


if __name__ == "__main__":
    main()
