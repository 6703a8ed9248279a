"""Metrics registry: counters, gauges and fixed-bucket histograms, and the
device accumulator that batches device scalars into one host copy per
drain (a copy of ``repro.obs.metrics``, with a torch accumulator).

Histograms use fixed log-spaced buckets (one ``bisect`` per observe, no
per-sample storage) and report p50/p95/p99 by linear interpolation
inside the owning bucket — accurate to one bucket width.
"""

from __future__ import annotations

import json
import math
import threading
from bisect import bisect_right
from typing import Any, Dict, List, Optional, Tuple

import torch


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def set_max(self, v: float) -> None:
        """High-water update — keeps peaks (KV utilization, fragmentation)
        correct after the instantaneous stat has gone back to zero."""
        if v > self.value:
            self.value = v

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed log-spaced buckets over ``[lo, hi)`` plus underflow and
    overflow buckets; exact count/sum/min/max."""

    __slots__ = ("lo", "hi", "edges", "counts", "count", "sum",
                 "min", "max", "rejected")

    def __init__(self, lo: float = 1e-7, hi: float = 1e4,
                 nbuckets: int = 120):
        if not (lo > 0 and hi > lo and nbuckets >= 1):
            raise ValueError(f"bad histogram layout lo={lo} hi={hi} "
                             f"nbuckets={nbuckets}")
        self.lo, self.hi = lo, hi
        ratio = (hi / lo) ** (1.0 / nbuckets)
        self.edges = [lo * ratio ** i for i in range(nbuckets + 1)]
        self.edges[-1] = hi
        # counts[0] = underflow (< lo), counts[-1] = overflow (>= hi)
        self.counts = [0] * (nbuckets + 2)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.rejected = 0

    def observe(self, v: float) -> None:
        if not math.isfinite(v):
            # a single NaN would poison sum/mean forever and an inf
            # would wreck the percentile clamp — and downstream the
            # loss-spike detector needs to see spikes, not a NaN-blinded
            # snapshot.  Count the rejection so it is still observable.
            self.rejected += 1
            return
        self.counts[bisect_right(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def _bucket_bounds(self, i: int) -> Tuple[float, float]:
        if i == 0:                       # underflow
            return min(self.min, self.edges[0]), self.edges[0]
        if i == len(self.counts) - 1:    # overflow
            return self.edges[-1], max(self.max, self.edges[-1])
        return self.edges[i - 1], self.edges[i]

    def percentile(self, q: float) -> float:
        """q in [0, 100]; linear interpolation within the owning bucket,
        clamped to the observed [min, max]."""
        if self.count == 0:
            return math.nan
        target = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                lo, hi = self._bucket_bounds(i)
                frac = (target - cum) / c
                return min(max(lo + frac * (hi - lo), self.min), self.max)
            cum += c
        return self.max

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"type": "histogram", "count": self.count,
                               "sum": self.sum}
        if self.rejected:
            out["rejected"] = self.rejected
        if self.count:
            out.update(mean=self.sum / self.count, min=self.min,
                       max=self.max, p50=self.percentile(50),
                       p95=self.percentile(95), p99=self.percentile(99))
        return out


class MetricsRegistry:
    """Name → metric; get-or-create, thread-safe, one snapshot schema."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def __getstate__(self) -> Dict[str, Any]:
        # picklable (a rank of a spawned mesh sends its registry back):
        # the lock is the process's own
        return {"_metrics": self._metrics}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self._metrics = state["_metrics"]
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls(*args, **kw))
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, lo: float = 1e-7, hi: float = 1e4,
                  nbuckets: int = 120) -> Histogram:
        return self._get(name, Histogram, lo, hi, nbuckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def dump_jsonl(self, path: str,
                   meta: Optional[Dict[str, Any]] = None) -> None:
        """One JSON object per line: an optional leading
        ``{"record": "meta", ...}`` line, then one
        ``{"record": "metric", "name": ..., **snapshot}`` per metric."""
        with open(path, "w") as f:
            if meta is not None:
                f.write(json.dumps({"record": "meta", **meta}) + "\n")
            for name, snap in self.snapshot().items():
                f.write(json.dumps({"record": "metric", "name": name,
                                    **snap}) + "\n")


class DeviceAccumulator:
    """Batches device-scalar observations; ONE host copy per drain.

    ``observe``/``inc`` only append the (still device-resident, possibly
    not yet computed) scalar to a pending list, so the hot loop never
    waits for the card.  ``drain()`` stacks the window on the device,
    copies it to the host in a single ``.tolist()`` and routes the floats
    into the registry — call it at log-window boundaries and at loop exit,
    where the trainer already syncs."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._pending: List[Tuple[str, str, Any]] = []

    def observe(self, hist_name: str, device_scalar) -> None:
        self._pending.append(("hist", hist_name, device_scalar))

    def inc(self, counter_name: str, device_scalar) -> None:
        self._pending.append(("ctr", counter_name, device_scalar))

    def __len__(self) -> int:
        return len(self._pending)

    def drain(self) -> List[float]:
        """Fetch + route every pending value; returns them in order."""
        if not self._pending:
            return []
        vals = fetch_scalars([p[2] for p in self._pending])
        for (kind, name, _), v in zip(self._pending, vals):
            if kind == "hist":
                self.registry.histogram(name).observe(v)
            else:
                self.registry.counter(name).inc(v)
        self._pending.clear()
        return vals


def fetch_scalars(values: List[Any]) -> List[float]:
    """Host floats of 0-d tensors (and plain numbers), with one device to
    host copy for all the tensors of a device."""
    out: List[Optional[float]] = [None] * len(values)
    by_device: Dict[Any, List[int]] = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(i)
        else:
            out[i] = float(v)
    for idx in by_device.values():
        host = torch.stack([values[i].detach().reshape(()).double()
                            for i in idx]).tolist()
        for i, f in zip(idx, host):
            out[i] = f
    return out
