"""The program's own spans in a ``--trace 1`` run: the port's tracer
(``repro_torch.obs.trace``) switched on for the run, and what the metric
readers take from it.

The harness loads every metric a run reports before the run starts
(``run.py``), and a ``--trace 0`` run loads no per-layer metric.  So each
metric that reads the program's spans calls :func:`install` when it is
loaded: a traced run traces the program, a run that measures the
end-to-end metrics leaves the program's tracer off.  It installs only in
a process started as ``portbench/run.py`` (the CPU tests load every
metric module in processes they share), and only where the program's
tracer has device phases.

The program's loops read their device phases where they already wait for
the card, the last time at their end, so a reader finds them all once
the timed call has returned.  A phase counts where its host span began
inside the window; each number is a median over the window's steps or
rounds, which keeps the few steps of the profiled stretches out of it.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

from portbench.lib.registry import BENCH

_INSTALLED: Any = None      # the tracer install() switched on


def install() -> None:
    global _INSTALLED
    main = getattr(sys.modules.get("__main__"), "__file__", None)
    if _INSTALLED is not None or main is None \
            or Path(main).resolve() != BENCH / "run.py":
        return
    from repro_torch.obs import trace as T
    if not hasattr(T.Tracer, "device_phase"):
        return
    _INSTALLED = T.Tracer(enabled=True, process="portbench")
    T.set_tracer(_INSTALLED)


def tracer(run) -> Any:
    """The program's tracer for ``run``: ``run.spans`` where the run
    carries one, else the one :func:`install` switched on; None where it
    has no device phases."""
    tr = getattr(run, "spans", None) or _INSTALLED
    if tr is None or not hasattr(tr, "device_phase"):
        return None
    tr.resolve()
    return tr


def median_ms(run, phase: str, groups: Sequence[str], *,
              device: bool = True) -> Optional[float]:
    """Milliseconds of the ``phase`` spans (their device time, or with
    ``device=False`` their host time) summed within each span named in
    ``groups`` that caused them, the nearest such one; the median over
    those groups.  Only phases whose host span began inside
    ``run.window`` count.  None when there is nothing to read."""
    tr = tracer(run)
    if tr is None or run.window.t0 is None or run.window.t1 is None:
        return None
    lo, hi = tr.at_us(run.window.t0), tr.at_us(run.window.t1)
    host: Dict[int, Tuple[str, float, Optional[int], float]] = {}
    on_device: Dict[int, float] = {}
    for e in tr.events:
        if e["ph"] != "X":
            continue
        if "span" in e:
            on_device[e["span"]] = e["dur"]
        elif "id" in e:
            host[e["id"]] = (e["name"], e["ts"], e["parent"], e["dur"])
    sums: Dict[int, float] = {}
    for i, (name, ts, parent, dur) in host.items():
        if name != phase or not lo <= ts <= hi:
            continue
        if device:
            if i not in on_device:
                continue
            dur = on_device[i]
        g = parent
        while g is not None and host[g][0] not in groups:
            g = host[g][2]
        if g is not None:
            sums[g] = sums.get(g, 0.0) + dur
    if not sums:
        return None
    return statistics.median(sums.values()) / 1e3


def span_at(tr, base_time_ns: int, t_us: float) -> Optional[str]:
    """The innermost host span of the program open at ``t_us`` on the
    clock of a profiler trace whose ``baseTimeNanoseconds`` is
    ``base_time_ns``; None where none is open."""
    best, width = None, float("inf")
    for e in tr.events:
        if e["ph"] != "X" or "id" not in e:
            continue
        a = tr.to_clock(e["ts"], base_time_ns)
        if a <= t_us <= a + e["dur"] and e["dur"] < width:
            best, width = e["name"], e["dur"]
    return best


def gap_name(trace, tr, base_time_ns: int, t_us: float) -> str:
    """What ``trace.host_at`` names the gap at ``t_us``, behind the
    innermost program span open there for a device-only stretch:
    ``<span> / before <op>``."""
    name = trace.host_at(t_us)
    span = span_at(tr, base_time_ns, t_us) if trace.main_tid is None \
        else None
    return name if span is None else f"{span} / {name}"


def named_breakdown(trace, tr, base_time_ns: Optional[int]
                    ) -> Dict[str, list]:
    """``lib.profile.breakdown`` with each idle gap named by
    :func:`gap_name` at its middle; as it is without a tracer or a base
    time."""
    from portbench.lib.profile import breakdown
    out = breakdown(trace)
    if tr is None or base_time_ns is None:
        return out
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])
    out["idle_gaps"] = [[gap_name(trace, tr, base_time_ns, (a + b) / 2),
                         (b - a) / 1e6]
                        for a, b in gaps[:len(out["idle_gaps"])]]
    return out
