"""Offline trace analytics: `python -m repro_torch.obs.analyze` (the
port's copy of ``repro.obs.analyze``).

The online half (health.py / slo.py) reacts while the fleet runs; this
is the postmortem half — it reads the Chrome-trace / JSONL artifacts
every launcher writes and answers the questions an operator asks after
the fact:

* ``rollup``   — where did the time go, grouped by span name (or cat,
  track, or any ``args`` key such as the region) — count / total /
  mean / p95 / max per group.
* ``top``      — the k slowest individual spans, with attribution.
* ``critical`` — per-round critical-path breakdown: for each ``round``
  (or other parent) span, how its child phases stack up against the
  parent wall time and how much is uncovered gap.
* ``diff``     — two runs side by side, per span name: count and total
  deltas, sorted by |Δtotal| — the "what regressed" view.
* ``alerts``   — alert / SLO / fault instants in timeline order (reads
  the ``--health-out`` artifact or any trace with instants).

Everything operates on the normalized event list from
:func:`load_events`, which accepts both artifact shapes (Chrome JSON
object with ``traceEvents`` and JSONL with ``record`` wrappers) so one
CLI serves every artifact the repo produces.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple


# --------------------------------------------------------------------------
# loading / normalization

def load_events(path: str) -> List[Dict[str, Any]]:
    """Read a trace artifact → list of Chrome-trace-shaped event dicts.

    Accepts a Chrome JSON object (``{"traceEvents": [...]}``), a bare
    JSON array of events, or JSONL where each line is either a raw event
    or a ``{"record": ...}`` wrapper (metric/meta/alert/... records are
    skipped — they carry no timeline position)."""
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "{":
            try:
                doc = json.load(f)
            except json.JSONDecodeError:
                f.seek(0)
                return _load_jsonl(f)
            if isinstance(doc, dict) and "traceEvents" in doc:
                return list(doc["traceEvents"])
            if isinstance(doc, dict):
                f.seek(0)
                return _load_jsonl(f)
            raise ValueError(f"unrecognized trace shape in {path}")
        if head == "[":
            return list(json.load(f))
        return _load_jsonl(f)


def _load_jsonl(f) -> List[Dict[str, Any]]:
    out = []
    for line in f:
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        if "ph" in rec and "ts" in rec:
            out.append(rec)
        elif rec.get("record") == "alert":
            # health artifact line → synthesize an instant so alert
            # timelines are analyzable alongside traces
            out.append({"name": f"alert.{rec['kind']}", "ph": "i",
                        "cat": "alert",
                        "ts": float(rec.get("ts_s", 0.0)) * 1e6,
                        "args": {k: v for k, v in rec.items()
                                 if k not in ("record", "kind")}})
    return out


def complete_spans(events: Iterable[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    """X-phase (complete) events with a finite duration, μs units."""
    out = []
    for e in events:
        if e.get("ph") == "X" and "dur" in e:
            d = e["dur"]
            if isinstance(d, (int, float)) and math.isfinite(d):
                out.append(e)
    return out


def instants(events: Iterable[Dict[str, Any]],
             cats: Optional[Tuple[str, ...]] = None
             ) -> List[Dict[str, Any]]:
    out = [e for e in events if e.get("ph") in ("i", "I")]
    if cats is not None:
        out = [e for e in out if e.get("cat") in cats]
    return sorted(out, key=lambda e: e.get("ts", 0))


def _group_key(e: Dict[str, Any], by: str) -> str:
    if by == "name":
        return str(e.get("name", "?"))
    if by == "cat":
        return str(e.get("cat", "?"))
    if by == "track":
        # the tracer encodes the track as the thread name via metadata;
        # in the raw events it is the tid — good enough to group by
        return str(e.get("tid", e.get("pid", "?")))
    if by.startswith("arg:"):
        return str(e.get("args", {}).get(by[4:], "?"))
    raise ValueError(f"unknown group key: {by!r} "
                     "(use name|cat|track|arg:<key>)")


# --------------------------------------------------------------------------
# analyses (all return printable row lists so the CLI and tests share them)

def rollup(events: List[Dict[str, Any]], by: str = "name"
           ) -> List[Dict[str, Any]]:
    groups: Dict[str, List[float]] = defaultdict(list)
    for e in complete_spans(events):
        groups[_group_key(e, by)].append(e["dur"] / 1e6)
    rows = []
    for key, durs in groups.items():
        durs.sort()
        n = len(durs)
        total = sum(durs)
        rows.append({
            "group": key, "count": n, "total_s": total,
            "mean_s": total / n,
            "p95_s": durs[min(n - 1, int(0.95 * n))],
            "max_s": durs[-1],
        })
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def top_spans(events: List[Dict[str, Any]], k: int = 10
              ) -> List[Dict[str, Any]]:
    spans = complete_spans(events)
    spans.sort(key=lambda e: -e["dur"])
    rows = []
    for e in spans[:k]:
        rows.append({
            "name": e.get("name", "?"), "dur_s": e["dur"] / 1e6,
            "ts_s": e.get("ts", 0) / 1e6, "cat": e.get("cat", ""),
            "args": {k_: v for k_, v in e.get("args", {}).items()
                     if isinstance(v, (int, float, str))},
        })
    return rows


def _ancestors(e: Dict[str, Any], up: Dict[tuple, Optional[int]]
               ) -> Optional[set]:
    """Ids of the spans that caused ``e`` (its host span's too, for a
    phase on the device track), each with its process: None for an event
    without span ids."""
    a, pid = e.get("args") or {}, e.get("pid")
    if "span" in a:
        i = a["span"]
    elif "id" in a:
        i = a.get("parent")
    else:
        return None
    out = set()
    while i is not None and (pid, i) not in out:
        out.add((pid, i))
        i = up.get((pid, i))
    return out


def critical_path(events: List[Dict[str, Any]], parent: str = "round"
                  ) -> List[Dict[str, Any]]:
    """For each span named ``parent``, break its wall time into child
    phases plus the uncovered gap.  A child is a span that the parent
    caused, by the span ids the port's tracer records (a device-track
    phase counts as ``<name>@device``, and covers only the part of it
    inside the parent's wall), or, for events without ids, a span fully
    inside its [ts, ts+dur) on any track.  With concurrent children the per-phase sums can exceed
    wall time — that is signal (parallelism), not error."""
    spans = complete_spans(events)
    up = {(e.get("pid"), e["args"]["id"]): e["args"].get("parent")
          for e in spans if "id" in (e.get("args") or {})}
    causes = [_ancestors(e, up) for e in spans]
    parents = [e for e in spans if e.get("name") == parent
               and "span" not in (e.get("args") or {})]
    parents.sort(key=lambda e: e.get("ts", 0))
    rows = []
    for i, p in enumerate(parents):
        t0, t1 = p["ts"], p["ts"] + p["dur"]
        pid = (p.get("args") or {}).get("id")
        pid = None if pid is None else (p.get("pid"), pid)
        phases: Dict[str, float] = defaultdict(float)
        covered: List[Tuple[float, float]] = []
        for e, cause in zip(spans, causes):
            device = "span" in (e.get("args") or {})
            if e is p or (e.get("name") == parent and not device):
                continue
            if pid is not None and cause is not None:
                if pid not in cause:
                    continue
                a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
                name = e.get("name", "?") + ("@device" if device else "")
                phases[name] += e["dur"] / 1e6
                if b > a:
                    covered.append((a, b))
            elif e["ts"] >= t0 and e["ts"] + e["dur"] <= t1:
                phases[e.get("name", "?")] += e["dur"] / 1e6
                covered.append((e["ts"], e["ts"] + e["dur"]))
        # merged coverage → uncovered gap on the parent's wall
        covered.sort()
        gap = p["dur"]
        last = t0
        for a, b in covered:
            a = max(a, last)
            if b > a:
                gap -= (b - a)
                last = b
        rows.append({
            "round": i, "wall_s": p["dur"] / 1e6,
            "ts_s": t0 / 1e6,
            "phases": dict(sorted(phases.items(),
                                  key=lambda kv: -kv[1])),
            "uncovered_s": max(0.0, gap / 1e6),
        })
    return rows


def diff_runs(events_a: List[Dict[str, Any]],
              events_b: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    ra = {r["group"]: r for r in rollup(events_a)}
    rb = {r["group"]: r for r in rollup(events_b)}
    rows = []
    for name in sorted(set(ra) | set(rb)):
        a, b = ra.get(name), rb.get(name)
        ta = a["total_s"] if a else 0.0
        tb = b["total_s"] if b else 0.0
        rows.append({
            "name": name,
            "count_a": a["count"] if a else 0,
            "count_b": b["count"] if b else 0,
            "total_a_s": ta, "total_b_s": tb,
            "delta_s": tb - ta,
            "ratio": (tb / ta) if ta > 0 else math.inf,
        })
    rows.sort(key=lambda r: -abs(r["delta_s"]))
    return rows


# --------------------------------------------------------------------------
# CLI

def _fmt_s(v) -> str:
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return str(v)          # args values can be strings/bools
    return f"{v:.6f}" if v < 1.0 else f"{v:.3f}"


def _print_table(rows: List[Dict[str, Any]], cols: List[str],
                 out=None) -> None:
    out = out if out is not None else sys.stdout
    if not rows:
        print("(no spans)", file=out)
        return
    widths = {c: max(len(c), *(len(_cell(r, c)) for r in rows))
              for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols), file=out)
    for r in rows:
        print("  ".join(_cell(r, c).ljust(widths[c]) for c in cols),
              file=out)


def _cell(r: Dict[str, Any], c: str) -> str:
    v = r.get(c, "")
    if isinstance(v, float):
        return _fmt_s(v) if math.isfinite(v) else "inf"
    if isinstance(v, dict):
        return " ".join(f"{k}={_fmt_s(x)}" for k, x in v.items())
    return str(v)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.analyze",
        description="offline analytics over repro_torch trace artifacts")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("rollup", help="time by group")
    p.add_argument("trace")
    p.add_argument("--by", default="name",
                   help="name|cat|track|arg:<key> (e.g. arg:region)")

    p = sub.add_parser("top", help="k slowest spans")
    p.add_argument("trace")
    p.add_argument("-k", type=int, default=10)

    p = sub.add_parser("critical", help="per-round critical path")
    p.add_argument("trace")
    p.add_argument("--parent", default="round")

    p = sub.add_parser("diff", help="compare two runs by span name")
    p.add_argument("trace_a")
    p.add_argument("trace_b")

    p = sub.add_parser("alerts", help="alert/slo/fault instants")
    p.add_argument("trace")

    args = ap.parse_args(argv)

    if args.cmd == "rollup":
        rows = rollup(load_events(args.trace), by=args.by)
        _print_table(rows, ["group", "count", "total_s", "mean_s",
                            "p95_s", "max_s"])
    elif args.cmd == "top":
        rows = top_spans(load_events(args.trace), k=args.k)
        _print_table(rows, ["name", "dur_s", "ts_s", "cat", "args"])
    elif args.cmd == "critical":
        rows = critical_path(load_events(args.trace),
                             parent=args.parent)
        _print_table(rows, ["round", "wall_s", "uncovered_s", "phases"])
    elif args.cmd == "diff":
        rows = diff_runs(load_events(args.trace_a),
                         load_events(args.trace_b))
        _print_table(rows, ["name", "count_a", "count_b", "total_a_s",
                            "total_b_s", "delta_s", "ratio"])
    elif args.cmd == "alerts":
        evs = instants(load_events(args.trace),
                       cats=("alert", "slo", "fault"))
        rows = [{"ts_s": e.get("ts", 0) / 1e6,
                 "name": e.get("name", "?"), "cat": e.get("cat", ""),
                 "args": {k: v for k, v in e.get("args", {}).items()
                          if isinstance(v, (int, float, str))}}
                for e in evs]
        _print_table(rows, ["ts_s", "name", "cat", "args"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
