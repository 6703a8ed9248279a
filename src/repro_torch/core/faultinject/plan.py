"""Deterministic fault injection for the edge fleet (a copy of
``repro.core.faultinject.plan``).

The common case on "sparingly used connected edge AI devices" is
failure: stragglers on slow radio links, devices vanishing mid-round,
flaky WAN hops, partially written or bit-rotted checkpoint shards.  A
:class:`FaultPlan` is a *seeded description* of those faults that every
consumer — the local-SGD trainer, the orchestration simulator, the
serving engine, the checkpoint heal path — draws from **statelessly**:
each draw is keyed by ``(seed, kind, entity, t)``, so the same plan
replays bit-identically no matter how many consumers share it, in what
order they ask, or whether one of them is switched off between runs.
(A shared mutable RNG would make adding one fault perturb every draw
after it; keyed streams are what make fault experiments reproducible.)

Fault kinds:

* **stragglers** — a fixed fraction of entities run every step
  ``straggler_slowdown`` times slower (persistent per entity: a phone on
  a congested uplink stays slow);
* **crash / rejoin** — an entity vanishes for ``rejoin_delay`` rounds
  and comes back (its local state is gone; consumers re-sync it);
* **link flaps** — a sync/step sees ``link_jitter_s`` extra seconds of
  wide-area latency (radio fade, WAN reroute);
* **shard corruption** — a checkpoint shard copy written at step ``t``
  by holder ``entity`` is bit-rotted (consumers must detect it by
  checksum and re-fetch from another holder).

Every injected fault lands on the :mod:`repro_torch.obs` timeline through a
:class:`FaultInjector` as a ``fault.<kind>`` instant on the ``faults``
track (cat ``fault``, args always carrying ``entity``) plus a
``faults/<kind>`` counter (the schema ``repro.obs.validate`` checks).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faultinject.keyed import keyed_streams

FAULT_KINDS = ("straggle", "crash", "rejoin", "link_flap", "corrupt",
               "drop_stale", "resync", "deadline", "requeue_limit",
               "heal")


def _key_int(x) -> int:
    if isinstance(x, (bool, int, np.integer)):
        return int(x) & 0xFFFFFFFF
    return zlib.crc32(str(x).encode())


def _key_col(xs) -> np.ndarray:
    """Vector of ``_key_int`` words for a batch of entities/steps."""
    arr = np.asarray(xs)
    if arr.dtype.kind in "iub":
        return (arr.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    if arr.ndim == 0:
        return np.uint32(_key_int(xs))
    # keep original element types: np.asarray would stringify the ints
    # of a mixed [5, "node:a"] batch and break scalar parity
    items = xs if not isinstance(xs, np.ndarray) else arr.tolist()
    return np.array([_key_int(x) for x in items], dtype=np.uint32)


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, replayable fault schedule.  All draws are stateless."""
    seed: int = 0
    # stragglers: `straggler_frac` of entities are `straggler_slowdown`
    # (uniform in [lo, hi]) times slower, persistently
    straggler_frac: float = 0.0
    straggler_slowdown: Tuple[float, float] = (4.0, 8.0)
    # crash/rejoin churn: per entity per round/step
    crash_prob: float = 0.0
    rejoin_delay: Tuple[int, int] = (1, 3)        # rounds/steps offline
    # link flaps: per entity per sync/step, adding jitter seconds
    link_flap_prob: float = 0.0
    link_jitter_s: Tuple[float, float] = (0.5, 2.0)
    # checkpoint-shard corruption: per (step, shard, holder) write
    corrupt_prob: float = 0.0

    # ------------------------------------------------------------- draws
    def _rng(self, kind: str, *keys) -> np.random.Generator:
        ints = [int(self.seed) & 0xFFFFFFFF, zlib.crc32(kind.encode())]
        ints.extend(_key_int(k) for k in keys)
        return np.random.default_rng(ints)

    def slowdown(self, entity) -> float:
        """Persistent compute slowdown factor for ``entity`` (>= 1)."""
        r = self._rng("straggle", entity)
        if r.random() >= self.straggler_frac:
            return 1.0
        lo, hi = self.straggler_slowdown
        return float(lo + (hi - lo) * r.random())

    def is_straggler(self, entity) -> bool:
        return self.slowdown(entity) > 1.0

    def crashes(self, entity, t: int) -> bool:
        """Does ``entity`` crash at round/step ``t``?"""
        if self.crash_prob <= 0.0:
            return False
        return bool(self._rng("crash", entity, t).random()
                    < self.crash_prob)

    def rejoin_after(self, entity, t: int) -> int:
        """Rounds/steps ``entity`` stays offline after crashing at ``t``."""
        lo, hi = self.rejoin_delay
        return int(self._rng("rejoin", entity, t).integers(lo, hi + 1))

    def flaps(self, entity, t: int) -> bool:
        """Does ``entity``'s link flap on sync/step ``t``?"""
        if self.link_flap_prob <= 0.0:
            return False
        return bool(self._rng("flap", entity, t).random()
                    < self.link_flap_prob)

    def jitter_s(self, entity, t: int) -> float:
        """Extra link seconds on sync/step ``t`` (0 unless flapped)."""
        if not self.flaps(entity, t):
            return 0.0
        lo, hi = self.link_jitter_s
        return float(lo + (hi - lo)
                     * self._rng("jitter", entity, t).random())

    def corrupts(self, step: int, shard: int, holder="") -> bool:
        """Is holder ``holder``'s copy of ``shard`` written at ``step``
        bit-rotted?"""
        if self.corrupt_prob <= 0.0:
            return False
        return bool(self._rng("corrupt", step, shard, holder).random()
                    < self.corrupt_prob)

    # -------------------------------------------------- batched draws
    # One vectorized keyed-stream call per fault kind over a whole fleet,
    # bit-identical lane-for-lane to the scalar draws above (gated in the
    # JAX package's fleet-scale tests).
    # This is what lets the 10^4-10^6-device churn sweeps draw a step's
    # masks in milliseconds instead of constructing one Generator per
    # entity per step.
    def _streams(self, kind: str, *cols):
        base = [np.uint32(int(self.seed) & 0xFFFFFFFF),
                np.uint32(zlib.crc32(kind.encode()))]
        return keyed_streams(base + [_key_col(c) for c in cols])

    def slowdown_batch(self, entities: Sequence) -> np.ndarray:
        """Vector of :meth:`slowdown` over ``entities``."""
        s = self._streams("straggle", entities)
        gate = s.random()
        lo, hi = self.straggler_slowdown
        val = lo + (hi - lo) * s.random()
        return np.where(gate >= self.straggler_frac, 1.0, val)

    def crashes_batch(self, entities: Sequence, t: int) -> np.ndarray:
        """Boolean mask of :meth:`crashes` over ``entities`` at ``t``."""
        n = len(entities)
        if self.crash_prob <= 0.0:
            return np.zeros(n, dtype=bool)
        return self._streams("crash", entities, t).random() \
            < self.crash_prob

    def rejoin_after_batch(self, entities: Sequence, t: int) -> np.ndarray:
        """Vector of :meth:`rejoin_after` over ``entities`` at ``t``."""
        lo, hi = self.rejoin_delay
        return self._streams("rejoin", entities, t).integers(lo, hi + 1)

    def flaps_batch(self, entities: Sequence, t: int) -> np.ndarray:
        n = len(entities)
        if self.link_flap_prob <= 0.0:
            return np.zeros(n, dtype=bool)
        return self._streams("flap", entities, t).random() \
            < self.link_flap_prob

    def jitter_batch(self, entities: Sequence, t: int) -> np.ndarray:
        """Vector of :meth:`jitter_s` over ``entities`` at ``t``."""
        flapped = self.flaps_batch(entities, t)
        out = np.zeros(len(entities))
        if not flapped.any():
            return out
        # the jitter stream only exists for flapped lanes (the scalar
        # path opens it after the flap check) — don't pay for the rest
        idx = np.flatnonzero(flapped)
        sub = entities[idx] if isinstance(entities, np.ndarray) \
            else [entities[int(i)] for i in idx]
        lo, hi = self.link_jitter_s
        out[idx] = lo + (hi - lo) * self._streams("jitter", sub, t).random()
        return out

    def corrupts_batch(self, step: int, shards: Sequence,
                       holders: Sequence) -> np.ndarray:
        """Boolean mask of :meth:`corrupts` over (shard, holder) pairs
        written at ``step``."""
        n = len(np.atleast_1d(np.asarray(shards)))
        n = max(n, len(np.atleast_1d(np.asarray(holders, dtype=object))))
        if self.corrupt_prob <= 0.0:
            return np.zeros(n, dtype=bool)
        return self._streams("corrupt", step, shards, holders).random() \
            < self.corrupt_prob

    @property
    def active(self) -> bool:
        return (self.straggler_frac > 0 or self.crash_prob > 0
                or self.link_flap_prob > 0 or self.corrupt_prob > 0)


class FaultInjector:
    """Binds a :class:`FaultPlan` to the telemetry layer: every injected
    fault becomes a ``fault.<kind>`` trace instant (cat ``fault``, track
    ``faults``, args carrying ``entity``) plus a ``faults/<kind>``
    counter, and the injector keeps host-side totals for results."""

    def __init__(self, plan: Optional[FaultPlan], *, registry=None):
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.obs.trace import get_tracer
        self.plan = plan if plan is not None else FaultPlan()
        self.tracer = get_tracer()
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.counts: dict = {}

    def emit(self, kind: str, entity, *, ts_s: Optional[float] = None,
             **attrs) -> None:
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(expected one of {FAULT_KINDS})")
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.tracer.instant(f"fault.{kind}", "fault", track="faults",
                            ts_s=ts_s, entity=str(entity), **attrs)
        self.registry.counter(f"faults/{kind}").inc(1)

    # convenience pass-throughs (draw + emit happen at the call site so
    # consumers control the timestamp/attrs; these just shorten access)
    def __getattr__(self, name):
        return getattr(self.plan, name)


def corrupt_file(path, *, seed: int = 0, flips: int = 8) -> int:
    """Deterministically bit-rot ``path``: XOR ``flips`` bytes at seeded
    offsets past the first 128 bytes (so an ``.npy`` header still parses
    and the rot is only catchable by checksum, like real silent disk
    corruption).  Returns the number of bytes flipped."""
    p = Path(path)
    data = bytearray(p.read_bytes())
    if not data:
        return 0
    start = min(128, max(0, len(data) - 1))
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                 zlib.crc32(p.name.encode())])
    n = min(flips, len(data) - start) or 1
    offs = rng.integers(start, len(data), size=n)
    for o in offs:
        data[int(o)] ^= 0xFF
    p.write_bytes(bytes(data))
    return n
