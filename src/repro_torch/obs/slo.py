"""Declarative SLOs with multi-window burn-rate evaluation (the port's
copy of ``repro.obs.slo``, which holds no tensors).

An :class:`SLOSpec` states an objective the fleet owes its users —
"serve TTFT p99 ≤ 250 ms", "training sustains ≥ 50k tokens/s",
"≤ 2 kgCO2e for this run" — and an :class:`SLOMonitor` evaluates a set
of them online against the same observation streams the metrics
registry already sees.

Evaluation follows the SRE multi-window burn-rate recipe rather than a
naive threshold: for event SLOs (latency, staleness) the *burn rate* is
``bad_fraction / error_budget`` over a window — burn 1.0 means the
error budget is being consumed exactly as provisioned, burn 10 means
ten times too fast — and a breach fires only when **both** a fast and a
slow window burn above the threshold (the fast window gives detection
latency, the slow window keeps one unlucky request from paging).
Budget SLOs (gCO2e, joules) instead compare spend rate against a
horizon: ``(spent / budget) / (elapsed / horizon)``.

Transitions emit schema-validated ``slo.breach`` / ``slo.recovered``
instants (cat ``slo``) so breaches sit on the same timeline as the
spans that caused them, and consumers poll :meth:`SLOMonitor.burning`
to *act* — the serve engine tightens admission while the TTFT SLO
burns, which is the observability loop closing into the runtime.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

SLO_KINDS = ("latency", "throughput", "budget")


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.

    kind="latency":    observations are durations (s); an observation is
        *bad* when it exceeds ``target``; ``objective`` is the promised
        good fraction (0.99 → p99 ≤ target).  Staleness budgets are the
        same shape with staleness as the "latency".
    kind="throughput": observations are rates; *bad* when below
        ``target`` (a floor, e.g. train tokens/s).
    kind="budget":     observations are monotone cumulative spend
        (e.g. gCO2e); burn compares spend pace vs ``target`` over
        ``horizon_s``.
    """
    name: str
    kind: str
    target: float
    objective: float = 0.99          # good fraction (event SLOs)
    fast_window: int = 32            # observations (event SLOs)
    slow_window: int = 256
    burn_threshold: float = 2.0      # breach when both windows ≥ this
    horizon_s: float = 0.0           # budget SLOs: provisioned horizon
    description: str = ""

    def __post_init__(self):
        if self.kind not in SLO_KINDS:
            raise ValueError(f"unknown SLO kind: {self.kind!r}")
        if self.kind == "budget" and self.horizon_s <= 0:
            raise ValueError("budget SLO needs horizon_s > 0")
        if not (0.0 < self.objective < 1.0):
            raise ValueError("objective must be in (0, 1)")


class _WindowBurn:
    """Bad-fraction burn over a bounded observation window."""

    __slots__ = ("buf", "bad")

    def __init__(self, size: int):
        self.buf: Deque[bool] = deque(maxlen=size)
        self.bad = 0

    def push(self, is_bad: bool) -> None:
        if len(self.buf) == self.buf.maxlen and self.buf[0]:
            self.bad -= 1
        self.buf.append(is_bad)
        if is_bad:
            self.bad += 1

    def burn(self, error_budget: float) -> float:
        if not self.buf:
            return 0.0
        return (self.bad / len(self.buf)) / error_budget


class _SLOState:
    __slots__ = ("spec", "fast", "slow", "breached", "worst_burn",
                 "observations", "bad_total", "spent", "t0", "last_t")

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.fast = _WindowBurn(spec.fast_window)
        self.slow = _WindowBurn(spec.slow_window)
        self.breached = False
        self.worst_burn = 0.0
        self.observations = 0
        self.bad_total = 0
        self.spent = 0.0          # budget SLOs: cumulative spend
        self.t0: Optional[float] = None
        self.last_t: Optional[float] = None

    def burn(self) -> float:
        spec = self.spec
        if spec.kind == "budget":
            if self.t0 is None or self.last_t is None \
                    or self.last_t <= self.t0 or spec.target <= 0:
                return 0.0
            elapsed = self.last_t - self.t0
            pace = (self.spent / spec.target) / (elapsed / spec.horizon_s)
            return pace
        budget = 1.0 - spec.objective
        # breach requires BOTH windows hot; report the min as the
        # effective (multi-window) burn
        return min(self.fast.burn(budget), self.slow.burn(budget))


class SLOMonitor:
    """Evaluates a set of :class:`SLOSpec` against observation streams.

    ``observe(name, value, t=...)`` feeds one observation into the SLO's
    windows; breach/recovery transitions are emitted as ``slo.breach`` /
    ``slo.recovered`` instants (cat ``slo``, args ``slo``/``burn``/
    ``target``) and counted in ``slo/breaches``.  ``burning(name)`` is
    the runtime's control signal."""

    def __init__(self, specs, *, registry=None, tracer=None):
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.obs.trace import get_tracer
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.states: Dict[str, _SLOState] = {}
        for spec in specs:
            if spec.name in self.states:
                raise ValueError(f"duplicate SLO name: {spec.name!r}")
            self.states[spec.name] = _SLOState(spec)
        self.events: List[Dict[str, Any]] = []

    def spec(self, name: str) -> SLOSpec:
        return self.states[name].spec

    # ---------------------------------------------------------------- feed
    def observe(self, name: str, value: float, *,
                t: Optional[float] = None) -> Optional[str]:
        """Feed one observation; returns "breach"/"recovered" on a
        transition, else None.  Unknown names are ignored (producers
        emit unconditionally; the spec set decides what is monitored)."""
        st = self.states.get(name)
        if st is None:
            return None
        spec = st.spec
        if not math.isfinite(value):
            return None
        st.observations += 1
        if spec.kind == "budget":
            st.spent += value
            now = t if t is not None else self.tracer.now_s()
            if st.t0 is None:
                st.t0 = now
            st.last_t = now
        else:
            bad = (value > spec.target) if spec.kind == "latency" \
                else (value < spec.target)
            if bad:
                st.bad_total += 1
            st.fast.push(bad)
            st.slow.push(bad)
        return self._transition(st, t)

    def _transition(self, st: _SLOState,
                    t: Optional[float]) -> Optional[str]:
        burn = st.burn()
        st.worst_burn = max(st.worst_burn, burn)
        spec = st.spec
        hot = burn >= spec.burn_threshold
        if spec.kind != "budget" and len(st.slow.buf) < spec.fast_window:
            hot = False     # not enough signal to page on yet
        if hot and not st.breached:
            st.breached = True
            self._emit("slo.breach", spec, burn, t)
            return "breach"
        if st.breached and not hot \
                and burn < 0.5 * spec.burn_threshold:   # hysteresis
            st.breached = False
            self._emit("slo.recovered", spec, burn, t)
            return "recovered"
        return None

    def _emit(self, name: str, spec: SLOSpec, burn: float,
              t: Optional[float]) -> None:
        self.tracer.instant(name, "slo", track="health", ts_s=t,
                            slo=spec.name, kind=spec.kind,
                            burn=round(burn, 4), target=spec.target,
                            objective=spec.objective)
        self.registry.counter(
            "slo/breaches" if name == "slo.breach"
            else "slo/recoveries").inc(1)
        self.events.append({
            "event": name, "slo": spec.name, "burn": round(burn, 4),
            "ts_s": t if t is not None else self.tracer.now_s()})

    # ------------------------------------------------------------- verdicts
    def burning(self, name: str) -> bool:
        st = self.states.get(name)
        return bool(st is not None and st.breached)

    def burn_rate(self, name: str) -> float:
        st = self.states.get(name)
        return st.burn() if st is not None else 0.0

    def worst(self) -> Tuple[str, float]:
        """(slo_name, worst_burn) across all SLOs; ("-", 0.0) if none."""
        if not self.states:
            return "-", 0.0
        name = max(self.states, key=lambda n: self.states[n].worst_burn)
        return name, self.states[name].worst_burn

    def verdicts(self) -> List[Dict[str, Any]]:
        out = []
        for name, st in sorted(self.states.items()):
            out.append({
                "slo": name, "kind": st.spec.kind,
                "target": st.spec.target,
                "objective": st.spec.objective,
                "observations": st.observations,
                "bad_total": st.bad_total,
                "spent": round(st.spent, 6),
                "burn": round(st.burn(), 4),
                "worst_burn": round(st.worst_burn, 4),
                "breached_now": st.breached,
                "ok": st.worst_burn < st.spec.burn_threshold,
            })
        return out

    def summary_line(self) -> str:
        name, worst = self.worst()
        parts = []
        for v in self.verdicts():
            parts.append(f"{v['slo']}:{'OK' if v['ok'] else 'BREACH'}")
        return (f"slo: {' '.join(parts) or '-'} | worst burn: "
                f"{name}={worst:.2f}")


# --------------------------------------------------------------------------
# Stock SLO sets for the two launchers.  Targets are knobs, not truth —
# the launchers override them from the CLI.

def serve_slos(*, ttft_p99_s: float = 0.5, inter_token_p99_s: float = 0.2,
               gco2e_budget: float = 0.0, horizon_s: float = 3600.0
               ) -> List[SLOSpec]:
    specs = [
        SLOSpec("serve_ttft", "latency", ttft_p99_s, objective=0.99,
                fast_window=16, slow_window=128,
                description="time-to-first-token p99"),
        SLOSpec("serve_inter_token", "latency", inter_token_p99_s,
                objective=0.99, fast_window=32, slow_window=256,
                description="inter-token latency p99"),
    ]
    if gco2e_budget > 0:
        specs.append(SLOSpec("serve_gco2e", "budget", gco2e_budget,
                             horizon_s=horizon_s,
                             description="serve carbon budget"))
    return specs


def train_slos(*, tokens_per_s_floor: float = 0.0,
               staleness_bound: float = 0.0,
               gco2e_budget: float = 0.0, horizon_s: float = 3600.0
               ) -> List[SLOSpec]:
    specs = []
    if tokens_per_s_floor > 0:
        specs.append(SLOSpec(
            "train_tokens_per_s", "throughput", tokens_per_s_floor,
            objective=0.9, fast_window=8, slow_window=32,
            description="training throughput floor"))
    if staleness_bound > 0:
        specs.append(SLOSpec(
            "train_staleness", "latency", staleness_bound,
            objective=0.9, fast_window=8, slow_window=32,
            description="outer-update staleness budget"))
    if gco2e_budget > 0:
        specs.append(SLOSpec("train_gco2e", "budget", gco2e_budget,
                             horizon_s=horizon_s,
                             description="train carbon budget"))
    return specs
