"""Paged KV-cache bookkeeping: refcounted block allocator, per-sequence
block tables, and a prefix -> block-chain cache index (vLLM-style).
Host-side numpy; a copy of ``repro.serve.paged_cache``.

The dense ``model.init_cache`` layout sizes every sequence's cache to the
worst-case length, so a batch of mixed-length requests pays
``batch x max_len`` KV bytes even though most of that is never written.
The serving engine instead carves each layer's KV storage into fixed-size
**blocks** (``block_size`` tokens each, vLLM-style paging) and maps logical
token positions to physical blocks through a per-sequence **block table**:

* device side — per-attention-layer pools ``k_pages``/``v_pages`` of shape
  ``(num_blocks, block_size, kv_heads, head_dim)`` (see
  ``model.init_paged_cache``); block ids are shared across layers, so one
  table drives every layer's gather,
* host side — this module: a refcounting :class:`BlockAllocator` plus
  :class:`BlockTable` slot state (alloc on admission, append on decode,
  free on eviction) with fragmentation / high-water statistics.

Block id 0 is reserved as the **null block**: padded batch slots and
unused block-table entries point at it, so the device-side scatter/gather
is always in-bounds and inactive slots can never corrupt live pages.

Prefix sharing
--------------

Shared system prompts are the common case at scale, so full blocks are
published into a **prefix index** keyed by ``(parent_block, token
tuple)`` — a radix chain rooted at the null block.  Admission walks the
index over the new prompt and maps every matched block read-only into
the sequence's table (refcount + 1, KV recompute skipped).  Because the
KV content of position ``p`` depends on the *entire* prefix before it
(every layer past the first attends to all prior positions), an index
entry is only valid reached through its parent chain from the root —
which the walk guarantees by construction.

Freeing decrements refcounts; a block only re-enters the free list at
refcount zero, and cached (registered) blocks are parked *cold* at the
far end of the LIFO so they are recycled last and stay matchable as long
as possible.  Recycling a cached block invalidates its index entry and
cascades to registered descendants (their chain root is gone; a stale
entry under a rewritten parent would serve wrong KV).  Writes never
touch a full block; appending into a *partially* shared tail block
copy-on-write forks it when other holders exist (``pending_copies``
records the device page copy the engine must perform before its next
step), or simply un-registers it when this sequence is the sole holder.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

NULL_BLOCK = 0


def blocks_for(num_tokens: int, block_size: int) -> int:
    """Physical blocks needed to hold ``num_tokens`` cache positions."""
    return -(-num_tokens // block_size)


class BlockAllocator:
    """Refcounting LIFO free-list over block ids ``1..num_blocks-1``
    (0 = null block).

    ``alloc`` hands out blocks at refcount 1; sharing a block across
    sequences is ``incref``; release is ``decref``, and a block re-enters
    the free list **only at refcount zero** — the invariant the serve
    tests' state machine drives.  ``free`` (the pre-sharing API) is a
    decref over a list and errors on blocks that are not live.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO: recently-freed blocks are re-used first (warm pages)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._refcount: Dict[int, int] = {}
        self.peak_blocks_in_use = 0

    @property
    def num_usable(self) -> int:
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_usable - self.num_free

    def refcount(self, block: int) -> int:
        return self._refcount.get(block, 0)

    def can_alloc(self, n: int) -> bool:
        return self.num_free >= n

    def _touch_peak(self) -> None:
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)

    def alloc(self, n: int = 1) -> List[int]:
        """Pop ``n`` blocks at refcount 1; raises MemoryError when the pool
        is exhausted (callers check :meth:`can_alloc` / admission first)."""
        if not self.can_alloc(n):
            raise MemoryError(
                f"paged KV pool OOM: want {n} blocks, {self.num_free} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refcount[b] = 1
        self._touch_peak()
        return out

    def incref(self, block: int) -> int:
        """Add a holder.  A refcount-0 block (cached, parked in the free
        list) is pulled back out; live blocks just gain a reference."""
        if not (0 < block < self.num_blocks):
            raise ValueError(f"incref of invalid block {block}")
        rc = self._refcount.get(block, 0)
        if rc == 0:
            self._free.remove(block)
        self._refcount[block] = rc + 1
        self._touch_peak()
        return rc + 1

    def decref(self, block: int, *, cold: bool = False) -> int:
        """Drop a holder; the block re-enters the free list only when the
        count hits zero.  ``cold`` parks it at the far end of the LIFO
        (recycled last — used for blocks the prefix index still maps)."""
        if block == NULL_BLOCK:
            raise ValueError("cannot free the null block")
        rc = self._refcount.get(block, 0)
        if rc <= 0 or not (0 < block < self.num_blocks):
            raise ValueError(f"double/invalid free of block {block}")
        rc -= 1
        if rc == 0:
            del self._refcount[block]
            if cold:
                self._free.insert(0, block)
            else:
                self._free.append(block)
        else:
            self._refcount[block] = rc
        return rc

    def free(self, blocks: List[int]) -> None:
        """Release one reference on each block (pre-sharing API)."""
        for b in blocks:
            self.decref(b)


@dataclass
class BlockTable:
    """One sequence's logical->physical block mapping + its length."""

    blocks: List[int] = field(default_factory=list)
    num_tokens: int = 0                  # cache positions written so far
    tokens: List[int] = field(default_factory=list)   # ids at positions
    num_cached: int = 0                  # positions admitted from the index

    def allocated_tokens(self, block_size: int) -> int:
        return len(self.blocks) * block_size


@dataclass
class _CacheNode:
    """Index bookkeeping for one registered (cached) physical block."""

    key: Tuple[int, Tuple[int, ...]]     # (parent block, token tuple)
    parent: int
    partial: bool                        # fewer than block_size tokens
    children: Set[int] = field(default_factory=set)


class PagedKVCache:
    """Host-side paging state for ``max_slots`` concurrent sequences.

    Owns the allocator, one :class:`BlockTable` per slot, and the prefix
    index, and renders them into the dense ``(max_slots,
    max_blocks_per_seq)`` int32 table + ``(max_slots,)`` length vector
    the device kernels consume.  The device pools themselves live in the
    model pytree (``model.init_paged_cache``) — this class never touches
    device memory, but it *schedules* device work: copy-on-write forks
    append ``(src, dst)`` page copies to :attr:`pending_copies`, which
    the engine drains before its next step.
    """

    def __init__(self, *, num_blocks: int, block_size: int,
                 max_slots: int, max_blocks_per_seq: int,
                 prefix_sharing: bool = True):
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.block_size = block_size
        self.max_slots = max_slots
        self.max_blocks_per_seq = max_blocks_per_seq
        self.prefix_sharing = prefix_sharing
        self._tables: List[Optional[BlockTable]] = [None] * max_slots
        # prefix index: (parent block, token tuple) -> physical block
        self.prefix_index: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._node: Dict[int, _CacheNode] = {}
        self.pending_copies: List[Tuple[int, int]] = []   # (src, dst) pages
        # cumulative counters (engine mirrors them into its registry)
        self.prefix_hit_tokens = 0
        self.cow_forks = 0

    # ------------------------------------------------------------- slots
    def free_slots(self) -> List[int]:
        return [i for i, t in enumerate(self._tables) if t is None]

    def table(self, slot: int) -> BlockTable:
        t = self._tables[slot]
        assert t is not None, f"slot {slot} not allocated"
        return t

    # ----------------------------------------------------------- prefix index
    def _match(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Walk the index over ``prompt`` from the root; returns the
        matched block chain and the number of tokens it covers.  Capped at
        ``len(prompt) - 1``: the last prompt token is always recomputed so
        the step that feeds it produces the logits sampling needs."""
        blocks: List[int] = []
        pos, parent = 0, NULL_BLOCK
        limit = len(prompt) - 1
        while pos < limit:
            take = min(self.block_size, limit - pos)
            hit, hit_len = None, 0
            for j in range(take, 0, -1):    # longest match at this node
                cand = self.prefix_index.get(
                    (parent, tuple(prompt[pos:pos + j])))
                if cand is not None:
                    hit, hit_len = cand, j
                    break
            if hit is None:
                break
            blocks.append(hit)
            pos += hit_len
            if hit_len < self.block_size or self._node[hit].partial:
                break                       # partial block ends the chain
            parent = hit
        return blocks, pos

    def _maybe_register(self, t: BlockTable, block_idx: int,
                        num_tokens: int) -> None:
        """Publish ``t.blocks[block_idx]`` (holding ``num_tokens`` token
        positions) into the prefix index, if its parent chain is itself
        registered — the walk invariant that makes entries safe to serve."""
        b = t.blocks[block_idx]
        if b in self._node:
            return                          # already published (or matched)
        parent = t.blocks[block_idx - 1] if block_idx else NULL_BLOCK
        if parent != NULL_BLOCK and parent not in self._node:
            return                          # broken chain: stay private
        toks = t.tokens[block_idx * self.block_size:
                        block_idx * self.block_size + num_tokens]
        if len(toks) < num_tokens or any(x < 0 for x in toks):
            return                          # unknown token ids: stay private
        key = (parent, tuple(toks))
        if key in self.prefix_index:
            return                          # duplicate content elsewhere
        self.prefix_index[key] = b
        self._node[b] = _CacheNode(key=key, parent=parent,
                                   partial=num_tokens < self.block_size)
        if parent != NULL_BLOCK:
            self._node[parent].children.add(b)

    def _invalidate(self, block: int) -> None:
        """Drop a block's index entry and cascade to registered
        descendants: their chain runs through this block, so once it is
        recycled (or its content diverges) a match through them would
        serve KV computed under a prefix that no longer exists."""
        node = self._node.pop(block, None)
        if node is None:
            return
        if self.prefix_index.get(node.key) == block:
            del self.prefix_index[node.key]
        pnode = self._node.get(node.parent)
        if pnode is not None:
            pnode.children.discard(block)
        for child in list(node.children):
            self._invalidate(child)

    def _alloc(self, n: int) -> List[int]:
        """Allocator pop + cache invalidation: recycled cold blocks lose
        their index entries (and their descendants') before reuse."""
        out = self.allocator.alloc(n)
        for b in out:
            self._invalidate(b)
        return out

    # -------------------------------------------------------------- admission
    def can_admit(self, prompt: Union[int, Sequence[int]]) -> bool:
        """Admission check: enough free blocks for the prompt plus one
        lookahead position (so the first decode step cannot OOM the moment
        a request is admitted).  Given the token list (rather than a bare
        length) the check credits prefix-index hits — matched blocks are
        mapped, not allocated, so sharing admits more concurrent sessions
        from the same pool."""
        if isinstance(prompt, (int, np.integer)):
            need = blocks_for(int(prompt) + 1, self.block_size)
            return (need <= self.max_blocks_per_seq
                    and self.allocator.can_alloc(need))
        total = blocks_for(len(prompt) + 1, self.block_size)
        if total > self.max_blocks_per_seq:
            return False
        matched, _ = self._match(prompt) if self.prefix_sharing else ([], 0)
        # matched blocks need no allocation, but cold ones (refcount 0)
        # leave the free list when the table pins them
        cold = sum(1 for b in matched if self.allocator.refcount(b) == 0)
        return self.allocator.num_free >= (total - len(matched)) + cold

    def open_slot(self, slot: int,
                  prompt: Optional[Sequence[int]] = None) -> int:
        """Open a slot; with a prompt (and sharing on) the longest cached
        prefix is mapped into the table read-only.  Returns the number of
        prompt positions admitted from the cache (0 without a match)."""
        assert self._tables[slot] is None, f"slot {slot} busy"
        t = BlockTable()
        self._tables[slot] = t
        if not self.prefix_sharing or not prompt:
            return 0
        blocks, ntok = self._match(prompt)
        for b in blocks:
            self.allocator.incref(b)
        t.blocks = list(blocks)
        t.num_tokens = ntok
        t.tokens = list(prompt[:ntok])
        t.num_cached = ntok
        self.prefix_hit_tokens += ntok
        return ntok

    # ------------------------------------------------------------------ write
    def ensure_capacity(self, slot: int, n: int = 1) -> bool:
        """Make sure the next ``n`` token positions for ``slot`` have
        writable physical blocks; returns False on pool OOM (caller
        preempts a sequence).  When the first write lands inside a block
        other sequences also hold, the block is copy-on-write forked: a
        fresh block replaces it in this table and the page copy is queued
        on :attr:`pending_copies`.  A sole-holder cached tail is instead
        un-registered — its content is about to diverge in place."""
        t = self.table(slot)
        total = blocks_for(t.num_tokens + n, self.block_size)
        if total > self.max_blocks_per_seq:
            return False                     # sequence hit its table limit
        grow = total - len(t.blocks)
        off = t.num_tokens % self.block_size
        fork = 0
        if off != 0:
            tail = t.blocks[t.num_tokens // self.block_size]
            if self.allocator.refcount(tail) > 1:
                fork = 1
        if not self.allocator.can_alloc(grow + fork):
            return False
        if off != 0:
            bi = t.num_tokens // self.block_size
            tail = t.blocks[bi]
            if fork:
                [fresh] = self._alloc(1)
                self.pending_copies.append((tail, fresh))
                self.allocator.decref(tail, cold=tail in self._node)
                t.blocks[bi] = fresh
                self.cow_forks += 1
            elif tail in self._node:
                # sole holder writing into a cached partial block: its
                # content diverges, so the index entry must go
                self._invalidate(tail)
        if grow > 0:
            t.blocks.extend(self._alloc(grow))
        return True

    def commit_token(self, slot: int, token: int = -1) -> None:
        """Account one cache position written at ``num_tokens`` (call after
        the device step that performed the write).  ``token`` is the id
        written there; blocks whose ids are unknown (< 0) are never
        published into the prefix index."""
        t = self.table(slot)
        assert t.num_tokens < t.allocated_tokens(self.block_size), \
            "commit_token without ensure_capacity"
        t.tokens.append(int(token))
        t.num_tokens += 1
        if self.prefix_sharing and t.num_tokens % self.block_size == 0:
            self._maybe_register(t, t.num_tokens // self.block_size - 1,
                                 self.block_size)

    def close_slot(self, slot: int) -> None:
        """Release the slot.  With sharing on, the partial tail is first
        published (exact-tuple entry) so an identical re-prefill — the
        recompute-preemption path — can reclaim it, then every block drops
        one reference; registered blocks park cold in the free list."""
        t = self.table(slot)
        if self.prefix_sharing and t.num_tokens > 0:
            tail_len = t.num_tokens % self.block_size
            if tail_len:
                self._maybe_register(t, t.num_tokens // self.block_size,
                                     tail_len)
        for b in t.blocks:
            self.allocator.decref(b, cold=b in self._node)
        self._tables[slot] = None

    # ------------------------------------------------------------ device view
    def take_pending_copies(self) -> List[Tuple[int, int]]:
        out, self.pending_copies = self.pending_copies, []
        return out

    def device_tables(self) -> np.ndarray:
        """(max_slots, max_blocks_per_seq) int32; unused entries -> null."""
        out = np.full((self.max_slots, self.max_blocks_per_seq), NULL_BLOCK,
                      np.int32)
        for i, t in enumerate(self._tables):
            if t is not None and t.blocks:
                out[i, :len(t.blocks)] = t.blocks
        return out

    def seq_lens(self) -> np.ndarray:
        """(max_slots,) int32 — cache positions already written per slot."""
        return np.asarray(
            [0 if t is None else t.num_tokens for t in self._tables],
            np.int32)

    # ------------------------------------------------------------ statistics
    def stats(self) -> Dict[str, float]:
        a = self.allocator
        live = [t for t in self._tables if t is not None]
        alloc_tok = sum(t.allocated_tokens(self.block_size) for t in live)
        used_tok = sum(t.num_tokens for t in live)
        held = sum(len(t.blocks) for t in live)
        return {
            "blocks_total": float(a.num_usable),
            "blocks_in_use": float(a.blocks_in_use),
            "blocks_peak": float(a.peak_blocks_in_use),
            "utilization": a.blocks_in_use / max(a.num_usable, 1),
            # internal fragmentation: allocated-but-unwritten tail slots
            "frag_tokens": float(alloc_tok - used_tok),
            "frag_frac": (alloc_tok - used_tok) / max(alloc_tok, 1),
            # sharing: table references minus unique live blocks = whole
            # blocks the pool did NOT have to hold twice right now
            "shared_saved_blocks": float(held - a.blocks_in_use),
            "cached_blocks": float(len(self._node)),
            "prefix_hit_tokens": float(self.prefix_hit_tokens),
            "cow_forks": float(self.cow_forks),
        }
