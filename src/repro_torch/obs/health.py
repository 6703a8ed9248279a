"""Streaming fleet-health detectors: telemetry in, decisions out (the
port's copy of ``repro.obs.health``, which holds no tensors).

A seeded :class:`~repro_torch.core.faultinject.FaultPlan` is the hidden
ground truth that drives a simulated fleet; the detectors here recover the
fleet's health state from **observed telemetry alone** (the span
durations and loss scalars the loops already emit), so the trainer, the
async quorum and the engine react to what they can measure, never to the
plan.

Three streaming detectors, each O(1) per observation (bounded deques and
cached robust statistics refreshed every few samples):

* :class:`StragglerDetector` — per-entity step/round durations, flagged
  against the **fleet** median via a windowed median/MAD z-score (a
  straggling phone is slow *relative to its peers*, persistently).
  Also supports *overdue* checks: an entity whose round has already run
  longer than the straggler threshold can be flagged before it ever
  reports — which is how the async trainer stops waiting on a straggler
  it has never heard back from.
* :class:`LinkDegradeDetector` — per-entity sync/restore durations,
  flagged against the **entity's own** trailing median/MAD (a link flap
  is a spike on one link, not a level shift across the fleet).
* :class:`LossSpikeDetector` — the training-loss stream, robust z-score
  spikes plus a two-window divergence test (recent median sustainedly
  above the trailing median).

Every detection lands on the :mod:`repro_torch.obs` timeline as an
``alert.<kind>`` instant (cat ``alert``, args always carrying ``entity``
and ``detector`` — the schema ``repro_torch.obs.validate`` enforces) plus
a ``health/<detector>`` counter, and accumulates in
:attr:`HealthMonitor.alerts` for end-of-run summaries and the
``--health-out`` artifact.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

ALERT_KINDS = ("straggler", "straggler_cleared", "link_degraded",
               "loss_spike", "divergence")


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return math.nan
    m = n // 2
    return s[m] if n % 2 else 0.5 * (s[m - 1] + s[m])


def _mad(xs: List[float], med: float) -> float:
    return _median([abs(x - med) for x in xs])


@dataclass
class Alert:
    """One detection: what fired, on whom, how bad, and when."""
    kind: str                 # one of ALERT_KINDS
    detector: str             # "straggler" | "link" | "loss"
    entity: str
    value: float              # the offending observation / level
    threshold: float          # what it was compared against
    ts_s: float               # timeline seconds (virtual or real)
    severity: float = 0.0     # robust z-score (or ratio) at detection
    detail: Dict[str, Any] = field(default_factory=dict)

    def to_record(self) -> Dict[str, Any]:
        return {"record": "alert", "kind": self.kind,
                "detector": self.detector, "entity": self.entity,
                "value": self.value, "threshold": self.threshold,
                "ts_s": self.ts_s, "severity": self.severity,
                **({"detail": self.detail} if self.detail else {})}


class _RobustStats:
    """Cached windowed median/MAD over a bounded deque; refreshed every
    ``refresh_every`` appends so the per-observation cost stays O(1)
    amortized (the sort is W log W but runs 1/refresh_every of the
    time)."""

    __slots__ = ("window", "refresh_every", "_buf", "_since", "med", "mad")

    def __init__(self, window: int = 64, refresh_every: int = 4):
        self.window = window
        self.refresh_every = refresh_every
        self._buf: Deque[float] = deque(maxlen=window)
        self._since = 0
        self.med = math.nan
        self.mad = math.nan

    def push(self, v: float) -> None:
        self._buf.append(v)
        self._since += 1
        if self._since >= self.refresh_every or math.isnan(self.med):
            self.refresh()

    def refresh(self) -> None:
        xs = list(self._buf)
        self.med = _median(xs)
        self.mad = _mad(xs, self.med)
        self._since = 0

    def __len__(self) -> int:
        return len(self._buf)

    def scale(self, rel_floor: float, abs_floor: float) -> float:
        """Robust sigma with a floor: 1.4826*MAD, but never below
        ``rel_floor * median`` (deterministic virtual clocks make MAD
        collapse to 0) nor ``abs_floor``."""
        base = 1.4826 * self.mad if not math.isnan(self.mad) else 0.0
        med = self.med if not math.isnan(self.med) else 0.0
        return max(base, rel_floor * abs(med), abs_floor)

    def z(self, v: float, rel_floor: float = 0.05,
          abs_floor: float = 1e-9) -> float:
        if math.isnan(self.med):
            return 0.0
        return (v - self.med) / self.scale(rel_floor, abs_floor)


class StragglerDetector:
    """Cross-entity robust z-score over observed per-entity durations.

    An entity is flagged when its own windowed median sits
    ``z_flag`` robust sigmas above the fleet median AND at least
    ``ratio_flag`` times the fleet median (the ratio guard keeps tiny
    absolute jitter from flagging when the fleet MAD collapses); it
    clears with hysteresis at ``z_clear``.  Needs ``min_obs``
    observations for the entity and ``min_entities`` peers before any
    verdict — you cannot call one device slow without a fleet to
    compare it to."""

    name = "straggler"

    def __init__(self, *, window: int = 32, z_flag: float = 4.0,
                 z_clear: float = 2.0, ratio_flag: float = 1.75,
                 min_obs: int = 1, min_entities: int = 3,
                 rel_floor: float = 0.05):
        self.z_flag = z_flag
        self.z_clear = z_clear
        self.ratio_flag = ratio_flag
        self.min_obs = min_obs
        self.min_entities = min_entities
        self.rel_floor = rel_floor
        self.fleet = _RobustStats(window=window * 4)
        self.per_entity: Dict[str, _RobustStats] = {}
        self._window = window
        self.flagged: Set[str] = set()
        self.obs_count: Dict[str, int] = {}

    def _entity(self, entity: str) -> _RobustStats:
        st = self.per_entity.get(entity)
        if st is None:
            st = self.per_entity[entity] = _RobustStats(self._window)
        return st

    def _verdict(self, entity: str, level: float
                 ) -> Tuple[bool, float, float]:
        """(should_flag, z, threshold_level) for an entity running at
        ``level`` seconds, vs the current fleet statistics."""
        if len(self.per_entity) < self.min_entities \
                or math.isnan(self.fleet.med) or self.fleet.med <= 0:
            return False, 0.0, math.inf
        z = self.fleet.z(level, self.rel_floor)
        thresh = max(
            self.fleet.med + self.z_flag * self.fleet.scale(self.rel_floor,
                                                            1e-9),
            self.ratio_flag * self.fleet.med)
        return (z >= self.z_flag and level >= thresh), z, thresh

    def observe(self, entity: str, duration_s: float) -> Optional[Alert]:
        """Record one completed step/round duration; returns an Alert on
        a flag/clear transition, else None."""
        st = self._entity(entity)
        st.push(duration_s)
        self.obs_count[entity] = self.obs_count.get(entity, 0) + 1
        self.fleet.push(duration_s)
        if self.obs_count[entity] < self.min_obs:
            return None
        level = st.med
        flag, z, thresh = self._verdict(entity, level)
        if flag and entity not in self.flagged:
            self.flagged.add(entity)
            return Alert("straggler", self.name, entity, level, thresh,
                         0.0, severity=z)
        if entity in self.flagged and not math.isnan(self.fleet.med):
            z_now = self.fleet.z(level, self.rel_floor)
            if z_now < self.z_clear \
                    and level < self.ratio_flag * self.fleet.med:
                self.flagged.discard(entity)
                return Alert("straggler_cleared", self.name, entity,
                             level, thresh, 0.0, severity=z_now)
        return None

    def check_overdue(self, entity: str, elapsed_s: float
                      ) -> Optional[Alert]:
        """Flag an entity whose round has ALREADY run ``elapsed_s``
        without completing: since the true duration can only be larger,
        exceeding the straggler threshold now is conclusive.  Nothing is
        recorded into the windows (the round is not done)."""
        if entity in self.flagged:
            return None
        flag, z, thresh = self._verdict(entity, elapsed_s)
        if flag:
            self.flagged.add(entity)
            return Alert("straggler", self.name, entity, elapsed_s,
                         thresh, 0.0, severity=z,
                         detail={"overdue": True})
        return None


class LinkDegradeDetector:
    """Per-entity spike detection over sync/restore durations: a flap is
    an observation ``z_spike`` robust sigmas above the **entity's own**
    trailing median (with an absolute floor so sub-floor wobble never
    alerts).  Entities with ``degrade_after`` spikes inside their window
    are reported as *degraded* — the persistent verdict the scheduler
    can act on."""

    name = "link"

    def __init__(self, *, window: int = 32, z_spike: float = 6.0,
                 min_obs: int = 3, abs_floor_s: float = 0.05,
                 degrade_after: int = 2):
        self.z_spike = z_spike
        self.min_obs = min_obs
        self.abs_floor_s = abs_floor_s
        self.degrade_after = degrade_after
        self._window = window
        self.per_entity: Dict[str, _RobustStats] = {}
        self.obs_count: Dict[str, int] = {}
        self.spikes: Dict[str, Deque[int]] = {}   # obs indices of spikes

    def observe(self, entity: str, duration_s: float) -> Optional[Alert]:
        st = self.per_entity.get(entity)
        if st is None:
            st = self.per_entity[entity] = _RobustStats(self._window)
        n = self.obs_count.get(entity, 0)
        alert = None
        if n >= self.min_obs and not math.isnan(st.med):
            scale = st.scale(0.05, self.abs_floor_s)
            z = (duration_s - st.med) / scale
            if z >= self.z_spike and duration_s >= st.med \
                    + self.abs_floor_s:
                sp = self.spikes.setdefault(
                    entity, deque(maxlen=self._window))
                sp.append(n)
                alert = Alert("link_degraded", self.name, entity,
                              duration_s, st.med + self.z_spike * scale,
                              0.0, severity=z,
                              detail={"baseline_s": st.med,
                                      "spikes": len(sp)})
        self.obs_count[entity] = n + 1
        # spikes stay OUT of the baseline window: a flapping link must
        # not teach the detector that flapping is normal
        if alert is None:
            st.push(duration_s)
        return alert

    def degraded(self) -> Set[str]:
        return {e for e, sp in self.spikes.items()
                if len(sp) >= self.degrade_after}


class LossSpikeDetector:
    """Robust z-score spikes + two-window divergence over the scalar
    loss stream (fed from the device-accumulated histogram drain — which
    is why ``Histogram.observe`` must reject NaN/inf: a NaN-poisoned
    snapshot would blind this detector exactly when it matters)."""

    name = "loss"

    def __init__(self, *, window: int = 32, z_spike: float = 6.0,
                 min_obs: int = 8, div_ratio: float = 1.2,
                 div_patience: int = 4, rel_floor: float = 0.02):
        self.z_spike = z_spike
        self.min_obs = min_obs
        self.div_ratio = div_ratio
        self.div_patience = div_patience
        self.rel_floor = rel_floor
        self.stats = _RobustStats(window)
        self.recent: Deque[float] = deque(maxlen=max(4, window // 4))
        self.count = 0
        self._div_run = 0
        self.diverged = False

    def observe(self, value: float, entity: str = "train"
                ) -> Optional[Alert]:
        self.count += 1
        alert = None
        if not math.isfinite(value):
            # a non-finite loss IS the divergence signal, immediately
            self.diverged = True
            return Alert("divergence", self.name, entity,
                         float("inf"), self.stats.med, 0.0,
                         severity=math.inf,
                         detail={"non_finite": True})
        if self.count > self.min_obs and not math.isnan(self.stats.med):
            z = self.stats.z(value, self.rel_floor)
            if z >= self.z_spike:
                alert = Alert(
                    "loss_spike", self.name, entity, value,
                    self.stats.med
                    + self.z_spike * self.stats.scale(self.rel_floor,
                                                      1e-9),
                    0.0, severity=z, detail={"median": self.stats.med})
        self.recent.append(value)
        # divergence: the short recent window sustainedly above the long
        # trailing median by div_ratio
        if alert is None and self.count > self.min_obs \
                and len(self.recent) == self.recent.maxlen \
                and not math.isnan(self.stats.med) and self.stats.med > 0:
            if _median(list(self.recent)) > self.div_ratio * self.stats.med:
                self._div_run += 1
            else:
                self._div_run = 0
            if self._div_run >= self.div_patience and not self.diverged:
                self.diverged = True
                alert = Alert("divergence", self.name, entity,
                              _median(list(self.recent)),
                              self.div_ratio * self.stats.med, 0.0,
                              severity=self._div_run)
        self.stats.push(value)
        return alert


class HealthMonitor:
    """The fleet's health state, derived from telemetry alone.

    Producers feed observations (step durations per entity, sync/link
    durations per entity, loss scalars); the monitor runs the streaming
    detectors, emits every transition onto the obs timeline
    (``alert.<kind>`` instants, cat ``alert``) and into the metrics
    registry (``health/<detector>`` counters), and exposes the verdicts
    consumers act on:

    * :meth:`stragglers` — entities currently flagged slow,
    * :meth:`degraded_links` — entities with repeated link spikes,
    * :attr:`diverged` — the loss stream has left the rails,
    * :attr:`alerts` — every Alert, for summaries and ``--health-out``.

    The closed loop: the async local-SGD quorum excludes
    :meth:`stragglers`, and the serve engine tightens admission when an
    SLO burns — all without reading the fault plan."""

    def __init__(self, *, registry=None, tracer=None,
                 straggler: Optional[StragglerDetector] = None,
                 link: Optional[LinkDegradeDetector] = None,
                 loss: Optional[LossSpikeDetector] = None):
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.obs.trace import get_tracer
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.straggler = straggler if straggler is not None \
            else StragglerDetector()
        self.link = link if link is not None else LinkDegradeDetector()
        self.loss = loss if loss is not None else LossSpikeDetector()
        self.alerts: List[Alert] = []
        self.counts: Dict[str, int] = {}

    # ------------------------------------------------------------- emission
    def _emit(self, alert: Optional[Alert],
              ts_s: Optional[float]) -> Optional[Alert]:
        if alert is None:
            return None
        alert.ts_s = ts_s if ts_s is not None else self.tracer.now_s()
        self.alerts.append(alert)
        self.counts[alert.kind] = self.counts.get(alert.kind, 0) + 1
        self.tracer.instant(
            f"alert.{alert.kind}", "alert", track="health", ts_s=ts_s,
            entity=alert.entity, detector=alert.detector,
            value=round(alert.value, 6),
            threshold=(round(alert.threshold, 6)
                       if math.isfinite(alert.threshold) else -1.0),
            severity=(round(alert.severity, 3)
                      if math.isfinite(alert.severity) else -1.0),
            **alert.detail)
        self.registry.counter(f"health/{alert.detector}").inc(1)
        self.registry.counter("health/alerts").inc(1)
        return alert

    # ---------------------------------------------------------- observations
    def observe_step(self, entity, duration_s: float, *,
                     ts_s: Optional[float] = None) -> Optional[Alert]:
        """One completed step/round of ``entity`` took ``duration_s``."""
        return self._emit(self.straggler.observe(str(entity),
                                                 float(duration_s)), ts_s)

    def check_overdue(self, entity, elapsed_s: float, *,
                      ts_s: Optional[float] = None) -> Optional[Alert]:
        """``entity``'s round has been running ``elapsed_s`` and has not
        reported — flag it now if that alone crosses the threshold."""
        return self._emit(self.straggler.check_overdue(str(entity),
                                                       float(elapsed_s)),
                          ts_s)

    def observe_link(self, entity, duration_s: float, *,
                     ts_s: Optional[float] = None) -> Optional[Alert]:
        """One sync/restore/transfer involving ``entity``'s link."""
        return self._emit(self.link.observe(str(entity),
                                            float(duration_s)), ts_s)

    def observe_loss(self, value: float, *, entity: str = "train",
                     ts_s: Optional[float] = None) -> Optional[Alert]:
        return self._emit(self.loss.observe(float(value), entity), ts_s)

    # --------------------------------------------------------------- verdicts
    def stragglers(self) -> Set[str]:
        return set(self.straggler.flagged)

    def is_straggler(self, entity) -> bool:
        return str(entity) in self.straggler.flagged

    def degraded_links(self) -> Set[str]:
        return self.link.degraded()

    @property
    def diverged(self) -> bool:
        return self.loss.diverged

    def alerts_by_kind(self) -> Dict[str, int]:
        return dict(sorted(self.counts.items()))

    # --------------------------------------------------------------- reporting
    def summary(self) -> Dict[str, Any]:
        return {
            "alerts_total": len(self.alerts),
            "alerts_by_kind": self.alerts_by_kind(),
            "stragglers": sorted(self.stragglers()),
            "degraded_links": sorted(self.degraded_links()),
            "diverged": self.diverged,
        }

    def summary_line(self) -> str:
        by_kind = " ".join(f"{k}={v}"
                           for k, v in self.alerts_by_kind().items()) \
            or "none"
        return (f"alerts: {by_kind} | stragglers: "
                f"{','.join(sorted(self.stragglers())) or '-'} | "
                f"degraded links: "
                f"{','.join(sorted(self.degraded_links())) or '-'} | "
                f"diverged: {self.diverged}")

    def dump_jsonl(self, path: str, *, slo=None,
                   meta: Optional[Dict[str, Any]] = None) -> None:
        """The ``--health-out`` artifact: one ``{"record": "alert", ...}``
        line per alert (plus optional meta and, when an
        :class:`repro_torch.obs.slo.SLOMonitor` is passed, one
        ``{"record": "slo", ...}`` verdict line per SLO)."""
        import json
        with open(path, "w") as f:
            if meta is not None:
                f.write(json.dumps({"record": "meta", **meta}) + "\n")
            f.write(json.dumps({"record": "health_summary",
                                **self.summary()}) + "\n")
            for a in self.alerts:
                rec = a.to_record()
                for k, v in list(rec.items()):
                    if isinstance(v, float) and not math.isfinite(v):
                        rec[k] = str(v)
                f.write(json.dumps(rec) + "\n")
            if slo is not None:
                for v in slo.verdicts():
                    f.write(json.dumps({"record": "slo", **v}) + "\n")
