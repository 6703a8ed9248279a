"""Finds every piece of the benchmark by its name, as a file of its own:

* a configuration  ``configs/<config>.json``;
* a cell           ``workloads/<cell>.json``;
* a traffic kind   ``traffic/<kind>.py`` (a ``run(ctx)`` function);
* a metric         ``metrics/<metric>.py`` (a ``read(run)`` function);
* a kernel's work  ``work/<kernel>.py``.

``BENCHMARK.json`` at the repository root lists the cells and metrics; a
cell reports the metrics that name it (or that name no cells and move an
end-to-end metric it reports).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no file {path}")
    with open(path) as f:
        return json.load(f)


def _module(kind: str, name: str) -> ModuleType:
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> Dict[str, Any]:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> Dict[str, Any]:
    return _json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> Dict[str, Any]:
    return _json(BENCH / "configs" / f"{name}.json")


def traffic(kind: str) -> ModuleType:
    return _module("traffic", kind)


def metric(name: str) -> ModuleType:
    return _module("metrics", name)


def work(kernel: str) -> ModuleType:
    return _module("work", kernel)


def cell_metrics(bench: Dict[str, Any], cell: str) -> Dict[str, List[Dict]]:
    """The cell's end-to-end metrics (``trace 0``) and per-layer metrics
    (``trace 1``), as ``BENCHMARK.json`` lists them."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per}
