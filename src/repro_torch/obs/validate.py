"""Schema validation for the telemetry artifacts (the port's copy of
``repro.obs.validate``: the same schema, so either package's artifacts
pass either validator).

Usage::

    python -m repro_torch.obs.validate trace.json metrics.jsonl [...]

``.json`` files are validated as Chrome trace-event JSON (the format
https://ui.perfetto.dev loads): a ``traceEvents`` list whose entries
carry ``ph``/``ts``/``pid``/``tid``, with ``dur`` on complete (``X``)
events.  ``.jsonl`` files are validated as either a metrics dump (lines
of ``{"record": "metric", "name", "type", ...}`` with histogram
summaries carrying count/sum and percentiles when non-empty), a raw
trace event log (lines of ``{name, ph, ts_us, dur_us, track, args}``),
or a health artifact (``--health-out``: alert / slo-verdict /
health_summary records).  Fault (``fault.<kind>``), alert
(``alert.<kind>``) and SLO (``slo.breach``/``slo.recovered``) instants
are schema-checked wherever they appear.  Exits non-zero, naming the
offending line/event, on any violation.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict

_PHASES = {"X", "i", "C", "M", "b", "e", "n"}

# alert.<kind> instants HealthMonitor may emit (cat "alert")
_ALERT_KINDS = ("straggler", "straggler_cleared", "link_degraded",
                "loss_spike", "divergence")
# slo.* instants SLOMonitor may emit (cat "slo")
_SLO_NAMES = ("slo.breach", "slo.recovered")


def _check_alert_event(path: str, where: str, rec: Dict[str, Any]) -> bool:
    """Alert-event schema: every ``cat == "alert"`` record must be named
    ``alert.<kind>`` with a known kind and carry ``entity`` +
    ``detector`` in its args (what :class:`repro_torch.obs.health.
    HealthMonitor` emits)."""
    if rec.get("cat") != "alert":
        return False
    name = rec.get("name", "")
    if not (isinstance(name, str) and name.startswith("alert.")
            and name[len("alert."):] in _ALERT_KINDS):
        raise ValueError(f"{path}: {where} alert event has bad name "
                         f"{name!r} (want 'alert.<kind>', kind in "
                         f"{_ALERT_KINDS})")
    args = rec.get("args")
    if not isinstance(args, dict) or "entity" not in args \
            or "detector" not in args:
        raise ValueError(f"{path}: {where} alert event {name!r} args "
                         "missing 'entity'/'detector'")
    return True


def _check_slo_event(path: str, where: str, rec: Dict[str, Any]) -> bool:
    """SLO-event schema: every ``cat == "slo"`` record must be a
    ``slo.breach``/``slo.recovered`` instant carrying the ``slo`` name
    and numeric ``burn`` in its args (what :class:`repro_torch.obs.slo.
    SLOMonitor` emits)."""
    if rec.get("cat") != "slo":
        return False
    name = rec.get("name", "")
    if name not in _SLO_NAMES:
        raise ValueError(f"{path}: {where} slo event has bad name "
                         f"{name!r} (want one of {_SLO_NAMES})")
    args = rec.get("args")
    if not isinstance(args, dict) or "slo" not in args:
        raise ValueError(f"{path}: {where} slo event {name!r} args "
                         "missing 'slo'")
    if not isinstance(args.get("burn"), (int, float)):
        raise ValueError(f"{path}: {where} slo event {name!r} args "
                         "missing numeric 'burn'")
    return True


def _check_fault_event(path: str, where: str, rec: Dict[str, Any]) -> bool:
    """Fault-event schema: every ``cat == "fault"`` record must be named
    ``fault.<kind>`` and carry the affected ``entity`` in its args (what
    :class:`repro_torch.core.faultinject.FaultInjector` emits)."""
    if rec.get("cat") != "fault":
        return False
    name = rec.get("name", "")
    if not (isinstance(name, str) and name.startswith("fault.")
            and len(name) > len("fault.")):
        raise ValueError(f"{path}: {where} fault event has bad name "
                         f"{name!r} (want 'fault.<kind>')")
    args = rec.get("args")
    if not isinstance(args, dict) or "entity" not in args:
        raise ValueError(f"{path}: {where} fault event {name!r} args "
                         "missing 'entity'")
    return True


def validate_chrome_trace(path: str) -> Dict[str, int]:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise ValueError(f"{path}: not object-format chrome trace "
                         "(missing traceEvents)")
    events = data["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError(f"{path}: traceEvents empty or not a list")
    counts: Dict[str, int] = {}
    for i, e in enumerate(events):
        for key in ("ph", "pid", "tid", "name"):
            if key not in e:
                raise ValueError(f"{path}: event {i} missing {key!r}: {e}")
        ph = e["ph"]
        if ph not in _PHASES:
            raise ValueError(f"{path}: event {i} unknown ph {ph!r}")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"{path}: event {i} bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{path}: event {i} (X) bad dur {dur!r}")
        if _check_fault_event(path, f"event {i}", e):
            counts["fault"] = counts.get("fault", 0) + 1
        if _check_alert_event(path, f"event {i}", e):
            counts["alert"] = counts.get("alert", 0) + 1
        if _check_slo_event(path, f"event {i}", e):
            counts["slo"] = counts.get("slo", 0) + 1
        counts[ph] = counts.get(ph, 0) + 1
    if counts.get("X", 0) == 0:
        raise ValueError(f"{path}: no complete (X) span events")
    return counts


def validate_metrics_jsonl(path: str) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty metrics/event log")
    for i, ln in enumerate(lines):
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: line {i + 1} not JSON: {e}")
        if not isinstance(rec, dict):
            raise ValueError(f"{path}: line {i + 1} not an object")
        if rec.get("record") == "meta":
            counts["meta"] = counts.get("meta", 0) + 1
        elif rec.get("record") == "metric":
            for key in ("name", "type"):
                if key not in rec:
                    raise ValueError(f"{path}: line {i + 1} missing "
                                     f"{key!r}: {rec}")
            if rec["type"] == "histogram":
                if "count" not in rec or "sum" not in rec:
                    raise ValueError(f"{path}: line {i + 1} histogram "
                                     "missing count/sum")
                if rec["count"] > 0:
                    for p in ("p50", "p95", "p99"):
                        if p not in rec:
                            raise ValueError(f"{path}: line {i + 1} "
                                             f"non-empty histogram "
                                             f"missing {p}")
            elif rec["type"] in ("counter", "gauge"):
                if "value" not in rec:
                    raise ValueError(f"{path}: line {i + 1} "
                                     f"{rec['type']} missing value")
            else:
                raise ValueError(f"{path}: line {i + 1} unknown metric "
                                 f"type {rec['type']!r}")
            counts["metric"] = counts.get("metric", 0) + 1
        elif rec.get("record") == "alert":
            # --health-out artifact: one line per HealthMonitor alert
            for key in ("kind", "detector", "entity", "value", "ts_s"):
                if key not in rec:
                    raise ValueError(f"{path}: line {i + 1} alert "
                                     f"record missing {key!r}")
            if rec["kind"] not in _ALERT_KINDS:
                raise ValueError(f"{path}: line {i + 1} alert record "
                                 f"unknown kind {rec['kind']!r}")
            counts["alert"] = counts.get("alert", 0) + 1
        elif rec.get("record") == "slo":
            # --health-out artifact: one SLO verdict line per spec
            for key in ("slo", "kind", "target", "worst_burn", "ok"):
                if key not in rec:
                    raise ValueError(f"{path}: line {i + 1} slo "
                                     f"record missing {key!r}")
            counts["slo"] = counts.get("slo", 0) + 1
        elif rec.get("record") == "health_summary":
            for key in ("alerts_total", "alerts_by_kind", "stragglers"):
                if key not in rec:
                    raise ValueError(f"{path}: line {i + 1} "
                                     f"health_summary missing {key!r}")
            counts["health_summary"] = counts.get("health_summary", 0) + 1
        elif "ph" in rec and "ts_us" in rec:      # raw trace event log
            if _check_fault_event(path, f"line {i + 1}", rec):
                counts["fault"] = counts.get("fault", 0) + 1
            if _check_alert_event(path, f"line {i + 1}", rec):
                counts["alert"] = counts.get("alert", 0) + 1
            if _check_slo_event(path, f"line {i + 1}", rec):
                counts["slo"] = counts.get("slo", 0) + 1
            counts["event"] = counts.get("event", 0) + 1
        else:
            raise ValueError(f"{path}: line {i + 1} unrecognized record: "
                             f"{rec}")
    return counts


_BENCH_META_KEYS = ("commit", "timestamp_utc", "jax_version", "backend")


def validate_bench_json(path: str) -> Dict[str, int]:
    """Schema check for ``BENCH_*.json`` artifacts (what
    ``benchmarks.common.write_bench_json`` emits): a provenance ``meta``
    stamp (commit, UTC timestamp, jax version, backend) plus — when the
    benchmark embeds its acceptance gates — a non-empty ``claims`` list
    whose entries carry text/value/lo/hi and all hold (``ok``)."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: bench artifact is not a JSON object")
    meta = data.get("meta")
    if not isinstance(meta, dict):
        raise ValueError(f"{path}: missing provenance 'meta' object")
    for key in _BENCH_META_KEYS:
        if not meta.get(key):
            raise ValueError(f"{path}: meta missing/empty {key!r}")
    counts = {"meta": 1}
    if "claims" in data:
        claims = data["claims"]
        if not isinstance(claims, list) or not claims:
            raise ValueError(f"{path}: 'claims' empty or not a list")
        for i, c in enumerate(claims):
            for key in ("text", "value", "lo", "hi", "ok"):
                if key not in c:
                    raise ValueError(f"{path}: claim {i} missing {key!r}")
            if not (c["lo"] <= c["value"] <= c["hi"]) or not c["ok"]:
                raise ValueError(f"{path}: claim {i} FAILED: "
                                 f"{c['text']!r} derived {c['value']:.4g} "
                                 f"(accept [{c['lo']:.4g}, {c['hi']:.4g}])")
        counts["claim"] = len(claims)
    return counts


def validate(path: str) -> Dict[str, int]:
    if path.endswith(".jsonl"):
        return validate_metrics_jsonl(path)
    with open(path) as f:
        head = json.load(f)
    if isinstance(head, dict) and "traceEvents" not in head \
            and "meta" in head:
        return validate_bench_json(path)
    return validate_chrome_trace(path)


def main(argv=None) -> int:
    paths = (argv if argv is not None else sys.argv[1:])
    if not paths:
        print("usage: python -m repro_torch.obs.validate FILE [FILE ...]")
        return 2
    rc = 0
    for p in paths:
        try:
            counts = validate(p)
        except (OSError, ValueError) as e:
            print(f"[obs.validate] FAIL {e}")
            rc = 1
            continue
        detail = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
        print(f"[obs.validate] OK {p}: {detail}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
