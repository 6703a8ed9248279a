"""Span tracing with Chrome-trace / Perfetto and JSONL export (a copy of
``repro.obs.trace``: the port keeps its own host modules).

The fleet telemetry substrate (§5 generalized: time × bytes × joules ×
gCO2e need ONE timeline to be comparable).  Design constraints, in order:

* **near-zero overhead when disabled** — the default global tracer is
  off; ``tracer.span(...)`` then returns a shared no-op context manager
  after a single attribute check, so hot loops keep their step time;
* **thread-safe** — events append under the GIL; span nesting lives in a
  ``threading.local`` stack so concurrent threads trace independently;
* **monotonic timestamps** — ``time.perf_counter_ns`` relative to the
  tracer's epoch; wall clock never appears in a timeline;
* **two export formats** — Chrome trace-event JSON (open in
  https://ui.perfetto.dev or ``chrome://tracing``) and a line-per-event
  JSONL log for ad-hoc grep/pandas analysis.

Three span shapes cover every producer in the repo:

* ``with tracer.span("fwd_bwd_opt", "train"):`` — stack-nested complete
  events (trainer / local-SGD step phases).  ``metric="train/step_s"``
  additionally feeds the span's duration into the attached
  :class:`~repro_torch.obs.metrics.MetricsRegistry` histogram on exit.
* ``h = tracer.begin("decode", track="req:42"); ... tracer.end(h)`` —
  detached spans that outlive the current frame (per-request lifecycle
  states in ``serve.engine`` that stretch across many engine steps).
* ``tracer.complete("restore", ts_s=t, dur_s=rc.time_s, ...)`` —
  explicit-timestamp events for simulated clocks (the orchestrator's
  discrete-event time).

Plus ``instant`` (point events: churn, preemption), ``counter``
(Perfetto counter tracks: KV utilization per step) and ``annotate``
(attach key/values — energy J, carbon g — to the innermost open span,
which is how ``EnergyMonitor``/``CarbonLedger`` land on the timeline).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared no-op span: the entire disabled-tracer fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def end(self, **attrs):
        return None


NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("_tr", "name", "cat", "tid", "metric", "args", "t0_us",
                 "dur_us", "_open")

    def __init__(self, tr: "Tracer", name: str, cat: str, tid: int,
                 metric: Optional[str], args: Dict[str, Any]):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.tid = tid
        self.metric = metric
        self.args = args
        self.t0_us = tr._now_us()
        self.dur_us = 0.0
        self._open = True

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    # -- nested (with-statement) use ------------------------------------
    def __enter__(self) -> "Span":
        self._tr._stack().append(self)
        return self

    def __exit__(self, *exc):
        st = self._tr._stack()
        if st and st[-1] is self:
            st.pop()
        self._finish()
        return False

    # -- detached (begin/end) use ---------------------------------------
    def end(self, **attrs) -> None:
        if attrs:
            self.args.update(attrs)
        self._finish()

    def _finish(self) -> None:
        if not self._open:
            return
        self._open = False
        self.dur_us = self._tr._now_us() - self.t0_us
        self._tr._record("X", self.name, self.cat, self.t0_us,
                         self.dur_us, self.tid, self.args)
        if self._tr.registry is not None and self.metric:
            self._tr.registry.histogram(self.metric).observe(
                self.dur_us / 1e6)


class Tracer:
    """Collects trace events; one instance per run (or the global one)."""

    def __init__(self, enabled: bool = True, *, registry=None,
                 process: str = "repro_torch"):
        self.enabled = enabled
        self.registry = registry      # optional MetricsRegistry: spans
                                      # with metric= feed duration hists
        self.process = process
        self._t0_ns = time.perf_counter_ns()
        self._events: List[Dict[str, Any]] = []
        self._tracks: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def __getstate__(self) -> Dict[str, Any]:
        # picklable (a rank of a spawned mesh sends its events back): the
        # lock and the open-span stacks are the process's own
        state = dict(self.__dict__)
        del state["_lock"], state["_local"]
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self._local = threading.local()

    # ------------------------------------------------------------- internals
    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def now_s(self) -> float:
        """Seconds on the tracer's clock (for TTFT-style host math that
        must share the timeline's timebase)."""
        return (time.perf_counter_ns() - self._t0_ns) / 1e9

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self, track: Optional[str]) -> int:
        if track is None:
            t = threading.current_thread()
            track = t.name if t.name else f"thread-{t.ident}"
        tid = self._tracks.get(track)
        if tid is None:
            with self._lock:
                tid = self._tracks.setdefault(track,
                                              len(self._tracks) + 1)
        return tid

    def _record(self, ph: str, name: str, cat: str, ts_us: float,
                dur_us: float, tid: int, args: Dict[str, Any]) -> None:
        # list.append is atomic under the GIL; no lock on the hot path
        self._events.append({"name": name, "cat": cat, "ph": ph,
                             "ts": ts_us, "dur": dur_us, "tid": tid,
                             "args": args})

    # ------------------------------------------------------------------- API
    def span(self, name: str, cat: str = "", *, track: Optional[str] = None,
             metric: Optional[str] = None, **attrs):
        """Nested complete event (context manager)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, self._tid(track), metric, attrs)

    def begin(self, name: str, cat: str = "", *,
              track: Optional[str] = None, metric: Optional[str] = None,
              **attrs):
        """Detached span: caller keeps the handle, ends it later with
        ``tracer.end(h)`` / ``h.end()`` — possibly from another frame
        or engine step (request lifecycle states)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, self._tid(track), metric, attrs)

    def end(self, handle, **attrs) -> None:
        handle.end(**attrs)

    def instant(self, name: str, cat: str = "", *,
                track: Optional[str] = None, ts_s: Optional[float] = None,
                **attrs) -> None:
        if not self.enabled:
            return
        ts = self._now_us() if ts_s is None else ts_s * 1e6
        self._record("i", name, cat, ts, 0.0, self._tid(track), attrs)

    def complete(self, name: str, *, ts_s: float, dur_s: float,
                 cat: str = "", track: Optional[str] = None,
                 **attrs) -> None:
        """Explicit-timestamp complete event — for simulated clocks (the
        orchestrator's discrete-event time, in seconds from run start)."""
        if not self.enabled:
            return
        self._record("X", name, cat, ts_s * 1e6, dur_s * 1e6,
                     self._tid(track), attrs)

    def counter(self, name: str, value: float, *,
                track: Optional[str] = None,
                ts_s: Optional[float] = None) -> None:
        """Perfetto counter track sample (e.g. KV utilization per step)."""
        if not self.enabled:
            return
        ts = self._now_us() if ts_s is None else ts_s * 1e6
        self._record("C", name, "", ts, 0.0,
                     self._tid(track or "counters"), {"value": value})

    def annotate(self, **attrs) -> None:
        """Attach attributes to the innermost open span on this thread —
        how EnergyMonitor (J) and CarbonLedger (gCO2e) land on whatever
        phase span encloses them.  No-op outside any span."""
        if not self.enabled:
            return
        st = self._stack()
        if st:
            st[-1].args.update(attrs)

    # ---------------------------------------------------------------- export
    @property
    def events(self) -> List[Dict[str, Any]]:
        return self._events

    def clear(self) -> None:
        self._events = []

    def to_chrome(self, pid: int = 1) -> Dict[str, Any]:
        """Chrome trace-event JSON object format (Perfetto-loadable), the
        tracer's events under process ``pid``."""
        out: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": self.process}},
        ]
        for track, tid in sorted(self._tracks.items(), key=lambda kv: kv[1]):
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": track}})
        for e in self._events:
            ev: Dict[str, Any] = {"name": e["name"], "cat": e["cat"] or "-",
                                  "ph": e["ph"], "ts": e["ts"],
                                  "pid": pid, "tid": e["tid"]}
            if e["ph"] == "X":
                ev["dur"] = e["dur"]
            elif e["ph"] == "i":
                ev["s"] = "t"
            if e["args"]:
                ev["args"] = e["args"]
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def save_chrome_trace(self, path: str) -> None:
        save_chrome_traces(path, [self])

    def save_jsonl(self, path: str) -> None:
        """One JSON object per line: ``{name, cat, ph, ts_us, dur_us,
        track, args}`` — the grep/pandas-friendly event log."""
        names = {tid: track for track, tid in self._tracks.items()}
        with open(path, "w") as f:
            for e in self._events:
                f.write(json.dumps({
                    "name": e["name"], "cat": e["cat"], "ph": e["ph"],
                    "ts_us": e["ts"], "dur_us": e["dur"],
                    "track": names.get(e["tid"], str(e["tid"])),
                    "args": e["args"]}) + "\n")


def save_chrome_traces(path: str, tracers: List["Tracer"]) -> None:
    """One Chrome trace of several tracers, each its own process (pid 1,
    2, ...): the ranks of a mesh run, each named by its tracer's
    ``process``."""
    events: List[Dict[str, Any]] = []
    for pid, tr in enumerate(tracers, 1):
        events += tr.to_chrome(pid)["traceEvents"]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


# ------------------------------------------------------------ global tracer
_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process-global tracer; returns the old
    one (restore it in tests)."""
    global _GLOBAL
    old = _GLOBAL
    _GLOBAL = tracer
    return old
