"""The traced stretches of a ``--trace 1`` run: fixed numbers of steps
inside the window, each under its own ``torch.profiler`` session.  The
card is synchronised at both ends of a stretch, so every device
operation of its steps, and no other, runs inside it.

Recording the host costs the host time the card then idles through: a
granite-3-2b step read 36-55 % idle with Python stacks and 29-46 % with
operators alone, against about 3 % untraced (PR 30).  So the stretch
that times the card records device activity only, and its length is the
host clock between the two synchronisations; a second stretch records
operators and Python stacks, and is read for nothing but which function
launched which kernel.  Each session's chrome trace is read as soon as
it stops.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

MARK = "portbench_stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    t0: float                                   # us, host clock of the trace
    t1: float
    device: List[Tuple[str, float, float]]      # (name, start, end) in us
    launches: Dict[int, Tuple[int, float]]      # correlation -> (tid, ts)
    kernel_corr: List[Optional[int]]            # per device op
    python: List[Tuple[str, int, float, float]]  # (name, tid, start, end)
    host_ops: List[Tuple[str, int, float, float]]
    main_tid: Optional[int]
    steps: int = 0              # train steps (inner steps) in the stretch
    rounds: int = 0             # local-SGD rounds in the stretch

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        iv = sorted((max(a, self.t0), min(b, self.t1))
                    for _, a, b in self.device if b > self.t0 and a < self.t1)
        merged: List[List[float]] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    @property
    def span_s(self) -> float:
        """Device clock from the stretch's first device operation's start
        to its last one's end."""
        iv = self.busy_intervals()
        return (iv[-1][1] - iv[0][0]) / 1e6 if iv else 0.0

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Total device seconds and count of the operations whose name
        matches ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        hit = [(b - a) for n, a, b in self.device if rx.search(n)]
        return sum(hit) / 1e6, len(hit)

    def gaps(self) -> List[Tuple[float, float]]:
        out, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_at(self, t: float) -> str:
        """The innermost Python function or operator running on the main
        thread at ``t``; for a device-only trace, the device operation
        that ends the gap."""
        if self.main_tid is None:
            nxt = min(((a, n) for n, a, _ in self.device if a >= t),
                      default=(0.0, "the stretch's end"))
            return f"before {nxt[1]}"
        best, width = "host idle", float("inf")
        for name, tid, a, b in self.python + self.host_ops:
            if tid == self.main_tid and a <= t <= b and b - a < width:
                best, width = name, b - a
        return best


class Stretch:
    """Profiles window steps [start, stop): the profiler starts one step
    before ``start`` (its first records can be lost) and stops at
    ``stop``.  ``at(i)`` is called before window step ``i`` runs."""

    def __init__(self, start: int, stop: int, *, with_stack: bool = False,
                 device: torch.device = torch.device("cuda")):
        self.start, self.stop = start, stop
        self.with_stack, self.device = with_stack, device
        self.prof = None
        self._mark = None
        self.trace: Optional[Trace] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def device_only(self) -> bool:
        return self.device.type == "cuda" and not self.with_stack

    def at(self, i: int) -> None:
        if i == self.start - 1:
            from torch.profiler import ProfilerActivity, profile
            acts = [] if self.device_only else [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts, with_stack=self.with_stack)
            self.prof.start()
        elif i == self.start:
            self._sync()
            self._t0 = time.perf_counter()
            if not self.device_only:
                self._mark = torch.profiler.record_function(MARK)
                self._mark.__enter__()
        elif i == self.stop:
            self._sync()
            window_us = (time.perf_counter() - self._t0) * 1e6
            if not self.device_only:
                self._mark.__exit__(None, None, None)
            self.prof.stop()
            self.trace = self._read(window_us if self.device_only else None)

    def _read(self, window_us: Optional[float]) -> Trace:
        """The chrome trace, read as soon as the session stops (a session
        read after another one started came back with no device
        operations)."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.prof = None
        return parse(events, window_us)

    def read(self) -> Trace:
        if self.trace is None:
            raise RuntimeError("the traced stretch did not run to its end")
        return self.trace


def parse(events: List[dict], window_us: Optional[float] = None) -> Trace:
    """The stretch's events.  Its bounds are the ``MARK`` range, or, for
    a session that recorded the device only, the first device operation
    and ``window_us`` (the host clock between the synchronisations)
    after it; the time before the first operation then counts at the
    end."""
    if window_us is None:
        mark = [e for e in events if e.get("name") == MARK
                and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        if not mark:
            raise RuntimeError(f"the trace holds no {MARK} range")
        m = mark[0]
        t0, t1 = float(m["ts"]), float(m["ts"]) + float(m["dur"])
        main_tid = m["tid"]
    else:
        starts = [float(e["ts"]) for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS]
        if not starts:
            raise RuntimeError("the trace holds no device operation")
        t0 = min(starts)
        t1 = t0 + window_us
        main_tid = None
    device, corr = [], []
    launches: Dict[int, Tuple[int, float]] = {}
    python, host_ops = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((e["name"], ts, ts + dur))
            corr.append((e.get("args") or {}).get("correlation"))
        elif cat == "cuda_runtime":
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches[c] = (e["tid"], ts)
        elif cat == "python_function":
            if ts + dur >= t0 and ts <= t1:
                python.append((e["name"], e["tid"], ts, ts + dur))
        elif cat == "cpu_op":
            if ts + dur >= t0 and ts <= t1:
                host_ops.append((e["name"], e["tid"], ts, ts + dur))
    keep = [i for i, (_, a, b) in enumerate(device) if b > t0 and a < t1]
    return Trace(t0=t0, t1=t1, device=[device[i] for i in keep],
                 kernel_corr=[corr[i] for i in keep], launches=launches,
                 python=python, host_ops=host_ops, main_tid=main_tid)


def seconds_under(trace: Trace, function: str) -> Tuple[float, int]:
    """Device seconds of the operations launched while a Python function
    whose trace name matches ``function`` (a regular expression) ran on
    the launching thread, and how many calls of it the stretch saw."""
    rx = re.compile(function)
    spans: Dict[int, List[Tuple[float, float]]] = {}
    calls = 0
    for name, tid, a, b in trace.python:
        if rx.search(name):
            spans.setdefault(tid, []).append((a, b))
            calls += 1
    if not calls:
        return 0.0, 0
    total = 0.0
    for (name, a, b), c in zip(trace.device, trace.kernel_corr):
        if c is None or c not in trace.launches:
            continue
        tid, ts = trace.launches[c]
        if any(x <= ts <= y for x, y in spans.get(tid, ())):
            total += b - a
    return total / 1e6, calls


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    by: Dict[str, float] = {}
    for n, a, b in trace.device:
        by[n] = by.get(n, 0.0) + (min(b, trace.t1) - max(a, trace.t0)) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[trace.host_at((a + b) / 2), (b - a) / 1e6]
                          for a, b in gaps]}
