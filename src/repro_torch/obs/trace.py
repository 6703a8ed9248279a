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
  tracer's epoch.  The wall clock is read once, beside it at the epoch
  (``base_time_ns``), and exported as the trace's
  ``baseTimeNanoseconds``, the field ``torch.profiler``'s Chrome traces
  carry: ``to_clock`` puts a span on such a trace's clock, so a gap on
  the card's timeline can be named by the host span open across it;
* **span ids** — every span has an ``id`` and the ``parent`` id of the
  innermost span open on its thread when it began, so phases stack
  under their step or round by cause, not only by time;
* **two export formats** — Chrome trace-event JSON (open in
  https://ui.perfetto.dev or ``chrome://tracing``) and a line-per-event
  JSONL log for ad-hoc grep/pandas analysis.

Four span shapes cover every producer in the repo:

* ``with tracer.span("data", "train"):`` — stack-nested complete events
  (the loops' host phases).  ``metric="train/data_s"`` additionally
  feeds the span's duration into the attached
  :class:`~repro_torch.obs.metrics.MetricsRegistry` histogram on exit.
* ``with tracer.device_phase("adamw", "train", device=dev):`` — a host
  span plus the phase's time on the device's own clock (a pair of CUDA
  events on the card, the host clock elsewhere), read when the loop
  calls ``tracer.resolve()`` where it already waits for the card: a
  complete event on the ``device`` track carrying the host span's id,
  and ``metric=`` fed with device seconds.  One :class:`PhaseClock`
  implementation times every device phase of the program.
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

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, \
    Tuple

import torch


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


class PhaseClock:
    """Adds up phase times on the device's own clock: a pair of CUDA
    events recorded on the current stream around each phase on the card,
    two host clock reads elsewhere.

    A pair is read by ``fold``, which never waits.  Called where the host
    has just waited for the card (a loss fetch), it adds every finished
    pair to its phase's running total and hands it to the pair's
    callback; so the clock holds only the pairs since the last wait, and
    a long run keeps its memory flat.  Read events are reused."""

    def __init__(self, device: Any = None):
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._pending: Deque[Tuple[str, Any, Any, Optional[Callable]]] = \
            deque()
        self._totals: Dict[str, float] = {}
        self._spare: List[Any] = []

    def mark(self) -> Any:
        """Now on this clock: a CUDA event recorded on the current stream,
        or ``time.perf_counter()``."""
        if not self.cuda:
            return time.perf_counter()
        ev = self._spare.pop() if self._spare else \
            torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stop(self, name: str, start: Any,
             done: Optional[Callable[[float, Any], None]] = None) -> None:
        """End the phase begun at ``start`` (a ``mark``); ``done(seconds,
        start)`` is called when ``fold`` reads it."""
        self._pending.append((name, start, self.mark(), done))

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = self.mark()
        yield
        self.stop(name, start)

    def fold(self) -> None:
        """Read every pair whose end has passed on the device, oldest
        first (one stream finishes them in order); never waits."""
        while self._pending:
            name, a, b, done = self._pending[0]
            if self.cuda:
                if not b.query():
                    break
                s = a.elapsed_time(b) / 1e3
            else:
                s = b - a
            self._pending.popleft()
            self._totals[name] = self._totals.get(name, 0.0) + s
            if done is not None:
                done(s, a)
            if self.cuda:
                self._spare += (a, b)

    def totals(self) -> Dict[str, float]:
        """Seconds by phase name, after waiting for the last pair."""
        if self.cuda and self._pending:
            self._pending[-1][2].synchronize()
        self.fold()
        return dict(self._totals)


class Span:
    __slots__ = ("_tr", "name", "cat", "tid", "metric", "args", "t0_us",
                 "dur_us", "_open", "id", "parent")

    def __init__(self, tr: "Tracer", name: str, cat: str, tid: int,
                 metric: Optional[str], args: Dict[str, Any]):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.tid = tid
        self.metric = metric
        self.args = args
        st = tr._stack()
        self.id = next(tr._ids)
        self.parent = st[-1].id if st else None
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
                         self.dur_us, self.tid, self.args,
                         {"id": self.id, "parent": self.parent})
        if self._tr.registry is not None and self.metric:
            self._tr.registry.histogram(self.metric).observe(
                self.dur_us / 1e6)


class DevicePhase(Span):
    """A host span whose phase is timed on the device's clock as well
    (:meth:`Tracer.device_phase`); ``metric`` takes the device seconds."""
    __slots__ = ("_clock", "_start", "_anchor", "_device_metric")

    def __init__(self, tr: "Tracer", name: str, cat: str, tid: int,
                 metric: Optional[str], args: Dict[str, Any],
                 clock: PhaseClock):
        super().__init__(tr, name, cat, tid, None, args)
        self._clock, self._device_metric = clock, metric
        self._anchor = tr._anchor
        self._start = clock.mark()

    def _finish(self) -> None:
        if self._open:
            self._clock.stop(self.name, self._start, self._resolved)
        super()._finish()

    def _resolved(self, seconds: float, start: Any) -> None:
        tr = self._tr
        if not self._clock.cuda:
            ts = tr.at_us(start)
        elif self._anchor is None:
            ts = self.t0_us             # no meeting point yet: the launch
        else:
            ev, at_us = self._anchor
            ts = at_us + ev.elapsed_time(start) * 1e3
        tr._record("X", self.name, self.cat, ts, seconds * 1e6,
                   tr._tid("device"), self.args, {"span": self.id})
        if tr.registry is not None and self._device_metric:
            tr.registry.histogram(self._device_metric).observe(seconds)


class Tracer:
    """Collects trace events; one instance per run (or the global one)."""

    def __init__(self, enabled: bool = True, *, registry=None,
                 process: str = "repro_torch"):
        self.enabled = enabled
        self.registry = registry      # optional MetricsRegistry: spans
                                      # with metric= feed duration hists
        self.process = process
        self._t0_ns = time.perf_counter_ns()
        self.base_time_ns = time.time_ns()   # Unix time at the epoch
        self._ids = itertools.count(1)
        self._clocks: Dict[str, PhaseClock] = {}
        # (CUDA event, its host ts): recorded where the card had caught
        # up with the host, it puts device phases on the host's clock
        self._anchor: Optional[Tuple[Any, float]] = None
        self._events: List[Dict[str, Any]] = []
        self._tracks: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def __getstate__(self) -> Dict[str, Any]:
        # picklable (a rank of a spawned mesh sends its events back): the
        # lock, the open-span stacks and the CUDA events are the
        # process's own (the loops resolve their phases before they end)
        state = dict(self.__dict__)
        del state["_lock"], state["_local"]
        state.update(_ids=next(self._ids), _clocks={}, _anchor=None)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._ids = itertools.count(state["_ids"])
        self._lock = threading.Lock()
        self._local = threading.local()

    # ------------------------------------------------------------- internals
    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def now_s(self) -> float:
        """Seconds on the tracer's clock (for TTFT-style host math that
        must share the timeline's timebase)."""
        return (time.perf_counter_ns() - self._t0_ns) / 1e9

    def at_us(self, perf_s: float) -> float:
        """The timestamp (us) of a ``time.perf_counter()`` reading."""
        return (perf_s * 1e9 - self._t0_ns) / 1e3

    def to_clock(self, ts_us: float, base_time_ns: int) -> float:
        """``ts_us`` on the clock of a trace whose ``ts`` 0 is Unix time
        ``base_time_ns`` (a ``torch.profiler`` Chrome trace's
        ``baseTimeNanoseconds``), in us."""
        return ts_us + (self.base_time_ns - base_time_ns) / 1e3

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
                dur_us: float, tid: int, args: Dict[str, Any],
                ids: Optional[Dict[str, Optional[int]]] = None) -> None:
        # list.append is atomic under the GIL; no lock on the hot path
        ev = {"name": name, "cat": cat, "ph": ph, "ts": ts_us,
              "dur": dur_us, "tid": tid, "args": args}
        if ids:
            ev.update(ids)
        self._events.append(ev)

    def _clock(self, device: Any) -> PhaseClock:
        kind = "cuda" if device is not None and \
            torch.device(device).type == "cuda" else "cpu"
        clock = self._clocks.get(kind)
        if clock is None:
            clock = self._clocks[kind] = PhaseClock(kind)
        return clock

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

    def device_phase(self, name: str, cat: str = "", *, device: Any = None,
                     metric: Optional[str] = None, **attrs):
        """Nested span whose phase is also timed on ``device``'s clock:
        a pair of CUDA events on the current stream when ``device`` is a
        card, the host clock otherwise.  The pair is read by
        :meth:`resolve` into a complete event on the ``device`` track,
        carrying this span's id (``span``), and ``metric`` gets its device
        seconds.  Disabled, it is ``span``'s no-op: no event is made."""
        if not self.enabled:
            return NULL_SPAN
        return DevicePhase(self, name, cat, self._tid(None), metric, attrs,
                           self._clock(device))

    def resolve(self) -> None:
        """Read every device phase whose end has passed on the device;
        never waits.  The loops call it where they already wait for the
        card (the metrics drain, the loss fetch, their end).  When none is
        left pending, the card has caught up with the host: an event
        recorded now marks where the two clocks meet, and the phases begun
        after it are placed on the host's clock through it."""
        for clock in self._clocks.values():
            clock.fold()
            if clock.cuda and not clock._pending:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self._anchor = (ev, self._now_us())

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
        tracer's events under process ``pid``; span ids in each event's
        ``args`` (``id``, ``parent``; ``span`` on the device track)."""
        out: List[Dict[str, Any]] = [
            {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
             "args": {"name": self.process,
                      "baseTimeNanoseconds": self.base_time_ns}},
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
            args = dict(e["args"], **_ids(e))
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": self.base_time_ns}

    def save_chrome_trace(self, path: str) -> None:
        save_chrome_traces(path, [self])

    def save_jsonl(self, path: str) -> None:
        """A ``{"record": "meta", process, base_time_ns}`` line, then one
        JSON object per event: ``{name, cat, ph, ts_us, dur_us, track,
        args}`` and a span's ``id``, ``parent`` or ``span`` — the
        grep/pandas-friendly event log."""
        names = {tid: track for track, tid in self._tracks.items()}
        with open(path, "w") as f:
            f.write(json.dumps({"record": "meta", "process": self.process,
                                "base_time_ns": self.base_time_ns}) + "\n")
            for e in self._events:
                f.write(json.dumps({
                    "name": e["name"], "cat": e["cat"], "ph": e["ph"],
                    "ts_us": e["ts"], "dur_us": e["dur"],
                    "track": names.get(e["tid"], str(e["tid"])),
                    "args": e["args"], **_ids(e)}) + "\n")


def _ids(e: Dict[str, Any]) -> Dict[str, int]:
    return {k: e[k] for k in ("id", "parent", "span")
            if e.get(k) is not None}


def save_chrome_traces(path: str, tracers: List["Tracer"]) -> None:
    """One Chrome trace of several tracers, each its own process (pid 1,
    2, ...): the ranks of a mesh run, each named by its tracer's
    ``process``, whose metadata holds its own ``baseTimeNanoseconds``
    (the file's too when there is one tracer)."""
    events: List[Dict[str, Any]] = []
    for pid, tr in enumerate(tracers, 1):
        events += tr.to_chrome(pid)["traceEvents"]
    doc: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    if len(tracers) == 1:
        doc["baseTimeNanoseconds"] = tracers[0].base_time_ns
    with open(path, "w") as f:
        json.dump(doc, f)


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
