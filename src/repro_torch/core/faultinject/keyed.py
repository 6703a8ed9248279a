"""Vectorized keyed RNG streams, bit-exact with ``np.random.default_rng``.

A copy of ``repro.core.faultinject.keyed``.  The fault plan's contract is *stateless keyed draws*: every
consumer opens ``np.random.default_rng([seed, crc32(kind), entity, t])``
and draws, so replays are bit-identical regardless of who asks in what
order.  That contract caps fleet size: one ``default_rng`` construction
costs ~20 µs (SeedSequence entropy pool + PCG64 seeding), so a 10⁵-device
churn step spends seconds *constructing generators*, not simulating.

This module re-implements the exact entropy pipeline as array code over
``uint32``/``uint64`` lanes — one lane per (entity, t) key — so a whole
fleet's draws are one vectorized call with **bit-identical** outputs:

* ``SeedSequence`` entropy-pool mixing (pool size 4; the hashmix /
  mix(x,y) = ``x*MIX_MULT_L - y*MIX_MULT_R`` lattice, ``XSHIFT`` 16),
* ``generate_state(4, uint64)`` (INIT_B/MULT_B cycle over the pool,
  little-endian uint32 pairs),
* PCG64 seeding (128-bit LCG: ``inc = (seq << 1) | 1``; advance, add
  initstate, advance) and the XSL-RR output function,
* ``Generator.random()`` (53-bit mantissa of ``next64``) and
  ``Generator.integers`` for 32-bit ranges (buffered Lemire rejection on
  ``next32`` halves, low half first — what small ``integers(lo, hi)``
  draws actually consume).

Parity with per-entity ``default_rng`` is asserted property-style in the
JAX package's fleet-scale tests.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# SeedSequence hash constants (numpy.random.bit_generator).
_XSHIFT = np.uint32(16)
_INIT_A = np.uint32(0x43B0D7E5)
_MULT_A = np.uint32(0x931E8875)
_INIT_B = np.uint32(0x8B51F9DD)
_MULT_B = np.uint32(0x58F38DED)
_MIX_MULT_L = np.uint32(0xCA01F9DD)
_MIX_MULT_R = np.uint32(0x4973F715)
_POOL_SIZE = 4

# PCG64 128-bit LCG multiplier, split into 64-bit halves.
_PCG_MULT_HI = np.uint64(0x2360ED051FC65DA4)
_PCG_MULT_LO = np.uint64(0x4385DF649FCCF645)

_U64_32 = np.uint64(32)
_U64_MASK32 = np.uint64(0xFFFFFFFF)


def _hashmix(value: np.ndarray, const: np.ndarray) -> tuple:
    """SeedSequence hashmix: returns (hashed value, advanced const)."""
    value = value ^ const
    const = const * _MULT_A
    value = value * const
    value ^= value >> _XSHIFT
    return value, const


def _mix(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    res = (x * _MIX_MULT_L) - (y * _MIX_MULT_R)
    res ^= res >> _XSHIFT
    return res


def entropy_pool(columns: Sequence[np.ndarray]) -> list:
    """The SeedSequence 4-word entropy pool, one lane per column row.

    ``columns[i]`` is entropy word ``i`` of every lane (what the scalar
    path passes as ``default_rng([w0, w1, ...])``).  Words beyond the
    pool size feed the extra-entropy mixing loop, exactly as
    ``SeedSequence.mix_entropy`` does.
    """
    cols = [np.asarray(c, dtype=np.uint32) for c in columns]
    n = cols[0].shape
    const = np.broadcast_to(_INIT_A, n).copy()
    pool = []
    for i in range(_POOL_SIZE):
        src = cols[i] if i < len(cols) else np.zeros(n, np.uint32)
        v, const = _hashmix(src, const)
        pool.append(v)
    for i_src in range(_POOL_SIZE):
        for i_dst in range(_POOL_SIZE):
            if i_src != i_dst:
                v, const = _hashmix(pool[i_src], const)
                pool[i_dst] = _mix(pool[i_dst], v)
    for i_src in range(_POOL_SIZE, len(cols)):
        for i_dst in range(_POOL_SIZE):
            v, const = _hashmix(cols[i_src], const)
            pool[i_dst] = _mix(pool[i_dst], v)
    return pool


def _generate_state64(pool: Sequence[np.ndarray]) -> list:
    """``SeedSequence.generate_state(4, uint64)`` over lanes: 8 uint32
    words drawn by cycling the pool under INIT_B/MULT_B, paired
    little-endian (even word = low half)."""
    const = np.broadcast_to(_INIT_B, pool[0].shape).copy()
    words = []
    for i in range(2 * _POOL_SIZE):
        v = pool[i % _POOL_SIZE] ^ const
        const = const * _MULT_B
        v = v * const
        v ^= v >> _XSHIFT
        words.append(v)
    return [words[2 * i].astype(np.uint64)
            | (words[2 * i + 1].astype(np.uint64) << _U64_32)
            for i in range(_POOL_SIZE)]


def _mul128(ah, al, bh, bl):
    """(ah:al) * (bh:bl) mod 2^128 via 32-bit limbs of the low product."""
    a0 = al & _U64_MASK32
    a1 = al >> _U64_32
    b0 = bl & _U64_MASK32
    b1 = bl >> _U64_32
    t = a0 * b0
    w1_lo = (a1 * b0 + (t >> _U64_32))
    w2 = w1_lo >> _U64_32
    t2 = a0 * b1 + (w1_lo & _U64_MASK32)
    hi = a1 * b1 + w2 + (t2 >> _U64_32)   # high 64 bits of al*bl
    lo = al * bl                           # wrapping low 64 bits
    hi = hi + ah * bl + al * bh            # cross terms wrap mod 2^64
    return hi, lo


def _add128(ah, al, bh, bl):
    lo = al + bl
    hi = ah + bh + (lo < al).astype(np.uint64)
    return hi, lo


class KeyedStreams:
    """One PCG64 lane per key row; every draw advances all lanes.

    Construct with :func:`keyed_streams`.  Draw order per lane matches a
    scalar ``np.random.Generator`` exactly: interleave ``random()``,
    ``next64()`` and ``integers()`` freely and each lane replays the
    scalar sequence bit-for-bit (including the next32 half-word buffer
    the bounded-integer path consumes).
    """

    def __init__(self, state64: Sequence[np.ndarray]):
        init_hi, init_lo, seq_hi, seq_lo = state64
        one = np.uint64(1)
        self._inc_hi = (seq_hi << one) | (seq_lo >> np.uint64(63))
        self._inc_lo = (seq_lo << one) | one
        # pcg_setseq seeding starts from state 0, so the first advance
        # collapses to 0 * mult + inc = inc — skip the 128-bit multiply
        self._state_hi = self._inc_hi.copy()
        self._state_lo = self._inc_lo.copy()
        self._state_hi, self._state_lo = _add128(
            self._state_hi, self._state_lo, init_hi, init_lo)
        self._advance()
        # next32 buffering (pcg64_next32): low half first, high cached
        self._buf = np.zeros_like(init_hi, dtype=np.uint32)
        self._has_buf = np.zeros(init_hi.shape, dtype=bool)

    @property
    def lanes(self) -> int:
        return int(self._state_hi.shape[0])

    def _advance(self) -> None:
        hi, lo = _mul128(self._state_hi, self._state_lo,
                         np.broadcast_to(_PCG_MULT_HI, self._state_hi.shape),
                         np.broadcast_to(_PCG_MULT_LO, self._state_hi.shape))
        self._state_hi, self._state_lo = _add128(hi, lo,
                                                 self._inc_hi, self._inc_lo)

    def next64(self) -> np.ndarray:
        """PCG64 XSL-RR output, all lanes (invalidates the 32-bit buffer
        the way a scalar generator's next64 does NOT — only use one of
        next64/next32 per logical draw, as the scalar consumers do)."""
        self._advance()
        rot = self._state_hi >> np.uint64(58)
        x = self._state_hi ^ self._state_lo
        return (x >> rot) | (x << ((-rot) & np.uint64(63)))

    def next32(self, mask=None) -> np.ndarray:
        """Buffered 32-bit halves (low first), advancing only ``mask``
        lanes when given — what bounded ``integers`` rejection consumes."""
        if mask is None:
            mask = np.ones(self._state_hi.shape, dtype=bool)
        out = np.zeros(self._state_hi.shape, dtype=np.uint32)
        take_buf = mask & self._has_buf
        out[take_buf] = self._buf[take_buf]
        self._has_buf[take_buf] = False
        fresh = mask & ~take_buf
        if fresh.any():
            # advance only the lanes that need a new 64-bit word
            idx = np.flatnonzero(fresh)
            sh, sl = self._state_hi[idx], self._state_lo[idx]
            h, lo = _mul128(sh, sl,
                            np.broadcast_to(_PCG_MULT_HI, sh.shape),
                            np.broadcast_to(_PCG_MULT_LO, sh.shape))
            h, lo = _add128(h, lo, self._inc_hi[idx], self._inc_lo[idx])
            self._state_hi[idx], self._state_lo[idx] = h, lo
            rot = h >> np.uint64(58)
            x = h ^ lo
            word = (x >> rot) | (x << ((-rot) & np.uint64(63)))
            out[idx] = (word & _U64_MASK32).astype(np.uint32)
            self._buf[idx] = (word >> _U64_32).astype(np.uint32)
            self._has_buf[idx] = True
        return out

    def random(self) -> np.ndarray:
        """``Generator.random()``: 53-bit mantissa of next64."""
        return (self.next64() >> np.uint64(11)) * (1.0 / 9007199254740992.0)

    def integers(self, low: int, high: int) -> np.ndarray:
        """``Generator.integers(low, high)`` for ranges within 32 bits:
        buffered Lemire rejection on next32 halves, per lane."""
        rng = int(high) - int(low) - 1
        if rng < 0:
            raise ValueError(f"empty range [{low}, {high})")
        out = np.full(self._state_hi.shape, int(low), dtype=np.int64)
        if rng == 0:
            return out
        if rng > 0xFFFFFFFF:
            raise NotImplementedError("only 32-bit ranges are vectorized")
        rng_excl = np.uint64(rng + 1)
        threshold = np.uint64((0x100000000 - (rng + 1)) % (rng + 1))
        m = self.next32().astype(np.uint64) * rng_excl
        retry = (m & _U64_MASK32) < threshold
        while retry.any():
            m2 = self.next32(mask=retry).astype(np.uint64) * rng_excl
            m = np.where(retry, m2, m)
            retry = retry & ((m & _U64_MASK32) < threshold)
        return out + (m >> _U64_32).astype(np.int64)


def keyed_streams(columns: Sequence) -> KeyedStreams:
    """Open one generator lane per key row.

    ``columns`` are the entropy words of every lane — lane ``i`` is
    bit-identical to ``np.random.default_rng([c[i] for c in columns])``.
    Scalars broadcast against array columns.
    """
    cols = [np.atleast_1d(np.asarray(c)) for c in columns]
    n = max(c.shape[0] for c in cols)
    cols = [np.broadcast_to(c.astype(np.uint32), (n,)) for c in cols]
    return KeyedStreams(_generate_state64(entropy_pool(cols)))
