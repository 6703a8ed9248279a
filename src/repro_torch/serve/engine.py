"""Continuous-batching serving engine over the paged KV cache (port of
``repro.serve.engine``).

Iteration-level (Orca-style) scheduling: every engine step runs ONE
``decode_step_paged`` over a fixed number of batch slots; each slot feeds
either a **chunk** of its remaining prompt (prefill, teacher-forced, up to
``prefill_chunk`` tokens shared between prefilling slots per step) or its
last sampled token (decode).  Prefill and decode therefore interleave
freely inside a step — a long admission costs decoding slots one chunked
step, not one step per prompt token — new requests are admitted the
moment a slot and enough KV blocks are free, finished sequences are
evicted (their blocks return to the pool) at the step boundary, and a
step has one of exactly two shapes (the C=1 decode-only step and the
C=chunk mixed step).  Every attention layer of every step launches the
flash-decode kernel (``attn_impl="kernel"``); ``"gather"`` runs the plain
dense-gather version instead, for comparison.

Memory is managed by ``serve.paged_cache``: admission matches the
longest cached prefix (shared system prompts map read-only into the new
sequence's block table, skipping their recompute entirely) and requires
free blocks only for the unshared remainder plus one lookahead; decode
allocates incrementally, copy-on-write forks queued by the cache are
executed as in-place device page copies before the next step, and on pool
exhaustion the youngest sequence is preempted (its blocks are freed —
refcounts only, shared blocks survive — and it re-queues with its
generated tokens folded into the prompt — vLLM's recompute preemption;
its registered blocks typically make the re-prefill a cache hit).

Every step is priced through the component energy model
(``core.energy.monitor``) exactly as the trainers do, and the run summary
converts energy to operational CO2e via ``core.carbon.accounting``.

Robustness: requests whose queue wait exceeds ``ttft_deadline_s`` fail
gracefully (an empty, ``failed`` completion — counted and traced as a
``fault.deadline`` instant) instead of waiting forever under pressure;
recompute preemption is bounded by ``max_requeues``, past which the
request finishes with whatever it generated (``fault.requeue_limit``).
A seeded :class:`~repro_torch.core.faultinject.FaultPlan` can additionally
force deterministic slot preemptions (``crashes(uid, step)`` — a serving
worker blip), which is how the requeue bound and deadline behavior are
exercised reproducibly.

SLO brownout: with ``slo=`` (a :class:`repro_torch.obs.SLOMonitor`) the
engine feeds it every TTFT and inter-token observation, and while the
``serve_ttft`` SLO burns, admission stops filling slots past half
occupancy (``serve/admission_deferred`` counts each deferral) until the
burn recovers.

The pools are updated in place (``index_put_`` / page copies), which is
what buffer donation bought the JAX engine.  The engine runs on the card
unless ``torch_device="cpu"`` is asked for; it never falls back quietly.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import flops as F
from repro_torch.core.carbon.accounting import CarbonLedger
from repro_torch.core.energy.devices import CLOUD_H100, DeviceSpec
from repro_torch.core.energy.monitor import ComponentModel, EnergyMonitor
from repro_torch.core.faultinject import FaultInjector, FaultPlan
from repro_torch.device import DeviceLike, generator_for, resolve_device
from repro_torch.models import model as M
from repro_torch.models import params as MP
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer
from repro_torch.serve.paged_cache import PagedKVCache, blocks_for
from repro_torch.serve.sampling import SamplingParams, sample_tokens

PyTree = Any


@dataclass
class _ReqTelemetry:
    """Host-side lifecycle clock for one request: survives preemption and
    requeue (TTFT is measured submit→first *ever* sampled token; the
    end-to-end tokens/s denominator is submit→finish; inter-token gaps
    span preemptions too, which is exactly when they blow up)."""
    submit_s: float
    first_token_s: float = -1.0
    last_token_s: float = -1.0
    phase: Any = None                 # open lifecycle span handle
    phase_name: str = ""


@dataclass(frozen=True)
class Request:
    uid: str
    prompt: List[int]
    max_new: int
    sampling: SamplingParams = SamplingParams()
    eos_id: int = -1                  # < 0: never stops early


@dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    block_size: int = 16
    num_blocks: int = 128             # pool size (block 0 is the null page)
    max_blocks_per_seq: int = 32
    attn_impl: str = "kernel"         # kernel (flash-decode) | gather
    cache_dtype: str = "bfloat16"     # bfloat16 | float32 | int8 (quantized
                                      # pages + per-vector fp32 scales)
    prefill_chunk: int = 8            # prompt tokens fed per step (shared
                                      # across prefilling slots; 1 =
                                      # token-by-token teacher forcing)
    prefix_sharing: bool = True       # cache + reuse prompt-prefix blocks
    seed: int = 0
    ttft_deadline_s: float = 0.0      # fail queued requests whose wait
                                      # exceeds this (0 = no deadline)
    max_requeues: int = 32            # recompute-preemption bound per
                                      # request; past it the request
                                      # finishes with what it has


@dataclass
class Completion:
    uid: str
    prompt: List[int]
    tokens: List[int] = field(default_factory=list)
    preemptions: int = 0
    failed: bool = False              # deadline / requeue-limit casualty
    fail_reason: str = ""             # "deadline" | "requeue_limit"


@dataclass
class _Slot:
    req: Request
    fed: int = 0                      # tokens fed (prompt + sampled;
                                      # prefix-cache hits count as fed)
    generated: List[int] = field(default_factory=list)
    preemptions: int = 0

    @property
    def next_token(self) -> int:
        if self.fed < len(self.req.prompt):
            return self.req.prompt[self.fed]
        return self.generated[self.fed - len(self.req.prompt)]

    def next_tokens(self, n: int) -> List[int]:
        pl = len(self.req.prompt)
        return [self.req.prompt[j] if j < pl else self.generated[j - pl]
                for j in range(self.fed, self.fed + n)]


class ServeEngine:
    """Continuous-batching engine for one model replica."""

    def __init__(self, params: PyTree, cfg: ModelConfig, ecfg: EngineConfig,
                 *, device: DeviceSpec = CLOUD_H100,
                 torch_device: DeviceLike = None,
                 intensity_kg_per_kwh: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 slo=None):
        """``device`` is the energy profile; ``torch_device`` is where the
        model runs (the card unless "cpu" is asked for); ``slo`` an
        optional :class:`repro_torch.obs.SLOMonitor` that gates
        admission."""
        if not M.paged_decode_supported(cfg):
            raise NotImplementedError(
                f"{cfg.name}: paged serving needs attn/mlp/moe-only decoders "
                "(SSM/MLA/encoder-decoder caches are not token-paged)")
        if ecfg.attn_impl not in ("kernel", "gather"):
            raise ValueError(f"attn_impl {ecfg.attn_impl!r}: expected "
                             "'kernel' or 'gather'")
        self.torch_device = resolve_device(torch_device)
        leaf = MP.tree_leaves(params)[0]
        if leaf.device.type != self.torch_device.type:
            raise ValueError(f"params live on {leaf.device}, the engine "
                             f"runs on {self.torch_device}")
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = device
        dtype = getattr(torch, ecfg.cache_dtype)
        self.pages = M.init_paged_cache(cfg, ecfg.num_blocks,
                                        ecfg.block_size, dtype,
                                        self.torch_device)
        self.kv = PagedKVCache(num_blocks=ecfg.num_blocks,
                               block_size=ecfg.block_size,
                               max_slots=ecfg.max_slots,
                               max_blocks_per_seq=ecfg.max_blocks_per_seq,
                               prefix_sharing=ecfg.prefix_sharing)
        self._slots: List[Optional[_Slot]] = [None] * ecfg.max_slots
        self._waiting: Deque[Request] = deque()
        self._preempt_counts: Dict[str, int] = {}
        self._orig_prompts: Dict[str, List[int]] = {}
        self._gen = generator_for(self.torch_device, ecfg.seed)
        self.completions: Dict[str, Completion] = {}
        self.monitor = EnergyMonitor(ComponentModel.for_device(device))
        self.ledger = CarbonLedger() if intensity_kg_per_kwh is None else \
            CarbonLedger(intensity_kg_per_kwh=intensity_kg_per_kwh)
        self.steps = 0
        self.tokens_generated = 0
        self._frag_tokens_peak = 0.0
        self._util_peak = 0.0
        # telemetry: lifecycle spans ride the process-global tracer;
        # histograms (TTFT, per-request tokens/s, per-step KV stats) live
        # in a per-engine registry so runs don't bleed into each other
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._tracer = get_tracer()
        self._rt: Dict[str, _ReqTelemetry] = {}
        # fault events (deadline expiries, requeue-limit hits, injected
        # preemptions) always flow through an injector so they land on
        # the obs timeline with the validated fault schema
        self.injector = FaultInjector(fault_plan, registry=self.metrics)
        # the engine feeds the SLO monitor every TTFT / inter-token
        # observation, and while "serve_ttft" burns, admission tightens to
        # half the slots (brownout: protect in-flight latency, shed queue
        # pressure through the TTFT-deadline machinery) until it recovers
        self.slo = slo

        self._depths = [g.depth for g in MP.decoder_groups(cfg)]
        # per-block KV bytes across all layers (for peak-memory stats)
        leaves = MP.tree_leaves(self.pages)
        self.pool_bytes = int(sum(l.numel() * l.element_size()
                                  for l in leaves))
        self.bytes_per_block = self.pool_bytes / ecfg.num_blocks
        # what a bf16 pool of the same geometry would weigh per block —
        # the int8 savings feeding the kv-bytes-saved gauge
        n_attn = sum(g.depth * sum(1 for k in g.sublayers if k == "attn")
                     for g in MP.decoder_groups(cfg))
        fp_bpb = (n_attn * 2 * ecfg.block_size * cfg.num_kv_heads
                  * cfg.resolved_head_dim * 2)
        self._quant_saved_per_block = max(0.0, fp_bpb - self.bytes_per_block)

    # ----------------------------------------------------------- telemetry
    def _phase_begin(self, uid: str, name: str, **attrs) -> None:
        rt = self._rt[uid]
        rt.phase = self._tracer.begin(name, "serve.request",
                                      track=f"req:{uid}", uid=uid, **attrs)
        rt.phase_name = name

    def _phase_end(self, uid: str, state: str, **attrs) -> None:
        rt = self._rt.get(uid)
        if rt is not None and rt.phase is not None:
            rt.phase.end(state=state, **attrs)
            rt.phase = None

    # ------------------------------------------------------------- scheduling
    def submit(self, req: Request) -> None:
        if req.max_new < 1:
            # max_new >= 1 also guarantees admission is satisfiable: the
            # submit bound below then covers can_admit's +1 lookahead block
            raise ValueError(f"request {req.uid}: max_new must be >= 1")
        need = blocks_for(len(req.prompt) + req.max_new, self.ecfg.block_size)
        limit = min(self.ecfg.max_blocks_per_seq, self.kv.allocator.num_usable)
        if need > limit:
            raise ValueError(
                f"request {req.uid}: {need} blocks needed, engine limit "
                f"{limit} — raise num_blocks/max_blocks_per_seq")
        self._orig_prompts[req.uid] = list(req.prompt)
        self._rt[req.uid] = _ReqTelemetry(submit_s=self._tracer.now_s())
        self._phase_begin(req.uid, "queued",
                          prompt_len=len(req.prompt), max_new=req.max_new)
        self._waiting.append(req)

    def _admit(self) -> None:
        free = self.kv.free_slots()
        live = self.ecfg.max_slots - len(free)
        while free and self._waiting \
                and self.kv.can_admit(list(self._waiting[0].prompt)):
            if self.slo is not None and live >= 1 \
                    and live >= max(1, self.ecfg.max_slots // 2) \
                    and self.slo.burning("serve_ttft"):
                # TTFT SLO burning: stop filling slots past half occupancy
                # so in-flight prefills finish sooner; the queue drains
                # through the deadline machinery instead of piling more
                # concurrent work onto a latency breach
                self.metrics.counter("serve/admission_deferred").inc(1)
                break
            live += 1
            req = self._waiting.popleft()
            slot = free.pop(0)
            # longest cached prefix maps in read-only; those positions are
            # already "fed" — their KV recompute is skipped entirely
            cached = self.kv.open_slot(slot, req.prompt)
            s = _Slot(req)
            s.fed = cached
            self._slots[slot] = s
            self.metrics.counter("serve/prompt_tokens").inc(len(req.prompt))
            if cached:
                self.metrics.counter("serve/prefix_hit_tokens").inc(cached)
            self._phase_end(req.uid, "admitted")
            self._phase_begin(req.uid, "prefill", slot=slot,
                              cached_tokens=cached)

    def _fail_request(self, uid: str, prompt: List[int],
                      generated: List[int], reason: str, **attrs) -> None:
        """Gracefully fail a request: it completes with whatever it
        generated (nothing, for a queue-deadline expiry), marked
        ``failed``, counted, and traced as a ``fault.<reason>`` instant
        — instead of waiting or recomputing forever under pressure."""
        orig = self._orig_prompts[uid]
        full = list(prompt) + list(generated)
        self.completions[uid] = Completion(
            uid=uid, prompt=orig, tokens=full[len(orig):],
            preemptions=self._preempt_counts.get(uid, 0),
            failed=True, fail_reason=reason)
        self._phase_end(uid, f"failed_{reason}")
        self.injector.emit(reason, uid, **attrs)
        self.metrics.counter(f"serve/failed_{reason}").inc(1)

    def _preempt_slot(self, slot: int, *, injected: bool = False) -> None:
        """Free one slot, folding its generated tokens into a re-queued
        prompt (recompute preemption).  Past ``max_requeues`` the
        request fails gracefully with its partial output instead of
        recomputing forever."""
        s = self._slots[slot]
        self.kv.close_slot(slot)
        self._slots[slot] = None
        count = self._preempt_counts.get(s.req.uid, 0) + 1
        self._preempt_counts[s.req.uid] = count
        self.metrics.counter("serve/preemptions").inc(1)
        if count > self.ecfg.max_requeues:
            self._fail_request(s.req.uid, s.req.prompt, s.generated,
                               "requeue_limit", requeues=count - 1,
                               bound=self.ecfg.max_requeues)
            return
        merged = Request(uid=s.req.uid,
                         prompt=list(s.req.prompt) + list(s.generated),
                         max_new=s.req.max_new - len(s.generated),
                         sampling=s.req.sampling, eos_id=s.req.eos_id)
        self._waiting.appendleft(merged)
        # lifecycle: whatever phase was running ends preempted; the
        # request re-queues (its TTFT clock keeps running from submit)
        self._phase_end(merged.uid, "preempted",
                        generated=len(s.generated))
        self._phase_begin(merged.uid, "queued", requeued=True)
        self._tracer.instant("preempt", "serve", uid=merged.uid,
                             injected=injected)

    def _preempt_youngest(self) -> bool:
        """Recompute-preempt the least-progressed slot.  Returns False
        when nothing is left to preempt."""
        live = [i for i, s in enumerate(self._slots) if s is not None]
        if not live:
            return False
        self._preempt_slot(min(live, key=lambda i: self._slots[i].fed))
        return True

    def _expire_deadlines(self) -> None:
        """Fail queued requests whose wait blew the TTFT deadline (a
        request that already produced its first token is never
        expired — the deadline is on *time to first token* only)."""
        if self.ecfg.ttft_deadline_s <= 0 or not self._waiting:
            return
        now = self._tracer.now_s()
        keep: Deque[Request] = deque()
        for req in self._waiting:
            rt = self._rt.get(req.uid)
            waited = now - rt.submit_s if rt is not None else 0.0
            if rt is not None and rt.first_token_s < 0 \
                    and waited > self.ecfg.ttft_deadline_s:
                self._fail_request(req.uid, req.prompt, [], "deadline",
                                   waited_s=round(waited, 4),
                                   deadline_s=self.ecfg.ttft_deadline_s)
            else:
                keep.append(req)
        self._waiting = keep

    def _inject_preemptions(self) -> None:
        """Deterministic worker blips from the fault plan: a slot whose
        request the plan crashes at this step loses its KV state and
        recompute-preempts (bounded by ``max_requeues`` like any other
        preemption)."""
        plan = self.injector.plan
        if not plan.active or plan.crash_prob <= 0:
            return
        for i in range(self.ecfg.max_slots):
            s = self._slots[i]
            if s is not None and plan.crashes(s.req.uid, self.steps):
                self.injector.emit("crash", s.req.uid, step=self.steps,
                                   slot=i)
                self._preempt_slot(i, injected=True)

    def _plan_feeds(self) -> Dict[int, int]:
        """Per-slot token counts for this step: decode slots always feed
        one token; prefilling slots split the ``prefill_chunk`` budget
        (each gets at least one token, so nothing starves when many
        prefill at once).  Reserves KV capacity — including copy-on-write
        headroom — preempting the least-progressed sequence on pool
        exhaustion."""
        budget = max(1, self.ecfg.prefill_chunk)
        feeds: Dict[int, int] = {}
        for i in range(self.ecfg.max_slots):
            s = self._slots[i]
            if s is None:
                continue
            remaining = len(s.req.prompt) - s.fed
            if remaining <= 0:
                feeds[i] = 1                              # decoding
            else:
                take = min(remaining, max(1, budget))
                feeds[i] = take
                budget -= take
        for i in list(feeds):
            while self._slots[i] is not None \
                    and not self.kv.ensure_capacity(i, feeds[i]):
                if not self._preempt_youngest():
                    raise MemoryError("paged pool exhausted with no "
                                      "preemptable sequence")
        return {i: c for i, c in feeds.items()
                if self._slots[i] is not None}

    # ------------------------------------------------------------------ step
    def step(self) -> int:
        """Run one engine iteration; returns tokens committed this step."""
        with self._tracer.span("engine_step", "serve", track="engine",
                               metric="serve/step_s") as sp:
            return self._step_inner(sp)

    def _step_inner(self, sp) -> int:
        self._expire_deadlines()
        self._inject_preemptions()
        self._admit()
        if not any(s is not None for s in self._slots):
            return 0
        feeds = self._plan_feeds()
        if not feeds:
            return 0
        sp.set(active=len(feeds))

        t0 = time.perf_counter()
        # drain queued copy-on-write forks as device page copies BEFORE
        # the step touches the pool (the forked sequence writes into its
        # private copy this very step)
        copies = self.kv.take_pending_copies()
        if copies:
            self.metrics.counter("serve/cow_forks").inc(len(copies))
            for src, dst in copies:
                self._copy_page(src, dst)
        n = self.ecfg.max_slots
        C = self.ecfg.prefill_chunk if max(feeds.values()) > 1 else 1
        tokens = np.zeros((n, C), np.int32)
        nfeed = np.zeros((n,), np.int32)
        temp = np.zeros((n,), np.float32)
        topk = np.zeros((n,), np.int32)
        fed_tokens: Dict[int, List[int]] = {}
        for i, cnt in feeds.items():
            s = self._slots[i]
            fed_tokens[i] = s.next_tokens(cnt)
            tokens[i, :cnt] = fed_tokens[i]
            nfeed[i] = cnt
            temp[i] = s.req.sampling.temperature
            topk[i] = s.req.sampling.top_k
        dev = self.torch_device
        bt = torch.from_numpy(self.kv.device_tables()).to(dev)
        sl = torch.from_numpy(self.kv.seq_lens()).to(dev)
        with torch.no_grad():
            logits, _ = M.decode_step_paged(
                self.params, self.cfg, self.pages,
                torch.from_numpy(tokens).to(dev), bt, sl,
                attn_impl=self.ecfg.attn_impl,
                num_feed=None if C == 1 else torch.from_numpy(nfeed).to(dev))
            sampled = sample_tokens(logits.float(), self._gen,
                                    torch.from_numpy(temp).to(dev),
                                    torch.from_numpy(topk).to(dev)).cpu()
        sampled = sampled.numpy()

        committed = 0
        flops = hbm = 0.0
        now = self._tracer.now_s()
        for i, cnt in feeds.items():
            s = self._slots[i]
            for tok in fed_tokens[i]:
                self.kv.commit_token(i, tok)
            cache_len = self.kv.table(i).num_tokens
            for c in range(cnt):
                flops += F.decode_flops(self.cfg, 1,
                                        cache_len - cnt + 1 + c)
            hbm += F.kv_cache_bytes(self.cfg, 1, cache_len)
            s.fed += cnt
            if s.fed == len(s.req.prompt):
                # first sampled token for this (possibly merged) prompt:
                # prefill is over, the decode phase starts now
                self._phase_end(s.req.uid, "prefilled")
                self._phase_begin(s.req.uid, "decode", slot=i)
                rt = self._rt.get(s.req.uid)
                if rt is not None and rt.first_token_s < 0:
                    rt.first_token_s = self._tracer.now_s()
                    # TTFT survives preemption/requeue: the clock starts
                    # at submit and only the FIRST ever token stops it
                    self.metrics.histogram("serve/ttft_s").observe(
                        rt.first_token_s - rt.submit_s)
                    if self.slo is not None:
                        self.slo.observe("serve_ttft",
                                         rt.first_token_s - rt.submit_s)
            if s.fed >= len(s.req.prompt):          # this logit row counts
                tok = int(sampled[i])
                s.generated.append(tok)
                self.tokens_generated += 1
                committed += 1
                rt = self._rt.get(s.req.uid)
                if rt is not None:
                    # inter-token gap, surviving preemption: the p99 here
                    # is what chunked prefill is buying down
                    if rt.last_token_s >= 0:
                        gap = max(now - rt.last_token_s, 1e-7)
                        self.metrics.histogram(
                            "serve/inter_token_s",
                            lo=1e-7, hi=3600.0).observe(gap)
                        if self.slo is not None:
                            self.slo.observe("serve_inter_token", gap)
                    rt.last_token_s = now
                done = (len(s.generated) >= s.req.max_new
                        or (s.req.eos_id >= 0 and tok == s.req.eos_id))
                if done:
                    self._finish(i)
        # weights stream once per step, caches once per active sequence
        hbm += self.cfg.active_param_count() * 2
        self.monitor.record_step(flops=flops, hbm_bytes=hbm,
                                 duration_s=time.perf_counter() - t0)
        # fragmentation is only meaningful while sequences are live, so
        # sample it per step (stats() runs after everything is evicted);
        # the registry keeps the high-water marks so post-run peak stats
        # never read zero just because every slot was evicted
        st = self.kv.stats()
        self._frag_tokens_peak = max(self._frag_tokens_peak,
                                     st["frag_tokens"])
        self._util_peak = max(self._util_peak, st["utilization"])
        # bytes the fast path is NOT spending: prefix-shared blocks that
        # multiple sequences map (held minus physically allocated) plus
        # the int8-vs-bf16 delta on every block actually in use
        saved = (st.get("shared_saved_blocks", 0.0) * self.bytes_per_block
                 + self._quant_saved_per_block
                 * self.kv.allocator.blocks_in_use)
        self.metrics.gauge("serve/kv_bytes_saved").set_max(saved)
        self.metrics.gauge("serve/kv_utilization_peak").set_max(
            st["utilization"])
        self.metrics.gauge("serve/kv_frag_tokens_peak").set_max(
            st["frag_tokens"])
        self.metrics.histogram("serve/kv_utilization",
                               lo=1e-4, hi=2.0).observe(st["utilization"])
        self.metrics.counter("serve/tokens").inc(committed)
        self._tracer.counter("kv.utilization", st["utilization"])
        self._tracer.counter("kv.frag_tokens", st["frag_tokens"])
        self.steps += 1
        return committed

    def _finish(self, slot: int) -> None:
        s = self._slots[slot]
        # after recompute preemption the slot's prompt carries previously
        # generated tokens; the completion reports the ORIGINAL prompt and
        # everything generated beyond it
        orig = self._orig_prompts[s.req.uid]
        full = list(s.req.prompt) + list(s.generated)
        n_gen = len(full) - len(orig)
        self.completions[s.req.uid] = Completion(
            uid=s.req.uid, prompt=orig, tokens=full[len(orig):],
            preemptions=self._preempt_counts.get(s.req.uid, 0))
        self._phase_end(s.req.uid, "finished", tokens=n_gen)
        rt = self._rt.get(s.req.uid)
        if rt is not None:
            # end-to-end rate: completion tokens over submit→finish wall,
            # so preemption + recompute show up as a lower rate, not a
            # reset clock
            dt = self._tracer.now_s() - rt.submit_s
            if dt > 0 and n_gen > 0:
                self.metrics.histogram("serve/tokens_per_s",
                                       lo=1e-3, hi=1e6).observe(n_gen / dt)
        self.metrics.counter("serve/requests_finished").inc(1)
        self.kv.close_slot(slot)
        self._slots[slot] = None

    @property
    def busy(self) -> bool:
        return bool(self._waiting) or any(s is not None for s in self._slots)

    def warmup(self) -> None:
        """Run both step shapes (the C=1 decode step and the
        C=prefill_chunk mixed step) and the sampler once on a throwaway
        request end to end — building the kernel and warming the CUDA
        caching allocator — then discard its artifacts.  Call
        ``reset_stats()`` afterwards so that set-up time and energy stay
        out of the measured window."""
        plen = max(2, self.ecfg.prefill_chunk + 1)   # forces the chunk fn
        tok = self.cfg.vocab_size - 1
        self.submit(Request(uid="_warmup", prompt=[tok] * plen, max_new=2))
        while self.busy:
            self.step()
        self.completions.pop("_warmup", None)
        self._rt.pop("_warmup", None)
        self._orig_prompts.pop("_warmup", None)

    def reset_stats(self) -> None:
        """Start a fresh measurement window (call after a warmup run so
        set-up time/energy stays out of the reported numbers).  Clears
        completions, counters, the energy monitor, and the allocator /
        fragmentation peaks — but not live sequences or the cache."""
        self.completions.clear()
        self.monitor.reset()
        self.steps = 0
        self.tokens_generated = 0
        self.wall_s = 0.0
        self._frag_tokens_peak = 0.0
        self._util_peak = 0.0
        self.metrics = MetricsRegistry()    # fresh histogram window
        self.injector.registry = self.metrics
        self._rt = {uid: rt for uid, rt in self._rt.items()
                    if rt.phase is not None}    # keep live lifecycles
        self.kv.allocator.peak_blocks_in_use = self.kv.allocator.blocks_in_use

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write fork: page ``src`` -> ``dst`` in every pool, in
        place (stacked groups index pages on axis 1)."""
        for gi, d in enumerate(self._depths):
            for leaf in MP.tree_leaves(self.pages[f"g{gi}"]):
                if d > 1:
                    leaf[:, dst] = leaf[:, src]
                else:
                    leaf[dst] = leaf[src]

    # ------------------------------------------------------------------- run
    def run(self, requests: Optional[List[Request]] = None,
            max_steps: int = 100_000) -> Dict[str, Completion]:
        for r in requests or []:
            self.submit(r)
        t0 = time.perf_counter()
        steps = 0
        while self.busy and steps < max_steps:
            self.step()
            steps += 1
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)
        self.wall_s = time.perf_counter() - t0
        return self.completions

    # ------------------------------------------------------------------ stats
    def stats(self) -> Dict[str, float]:
        wall = getattr(self, "wall_s", 0.0)
        out = {
            "steps": float(self.steps),
            "tokens_generated": float(self.tokens_generated),
            "tokens_per_s": self.tokens_generated / wall if wall else 0.0,
            "energy_j": self.monitor.total_j,
            "j_per_token": (self.monitor.total_j
                            / max(self.tokens_generated, 1)),
            "pool_bytes": float(self.pool_bytes),
            "peak_cache_bytes": (self.kv.allocator.peak_blocks_in_use
                                 * self.bytes_per_block),
            # per-step peaks from the metrics registry: the instantaneous
            # kv.stats() go to zero once every sequence is evicted at the
            # end of a run, the high-water gauges don't
            "frag_tokens_peak": self.metrics.gauge(
                "serve/kv_frag_tokens_peak").value,
            "utilization_peak": self.metrics.gauge(
                "serve/kv_utilization_peak").value,
            **self.kv.stats(),
        }
        out["deadline_failures"] = float(
            self.metrics.counter("serve/failed_deadline").value)
        out["requeue_limit_failures"] = float(
            self.metrics.counter("serve/failed_requeue_limit").value)
        out["requests_failed"] = (out["deadline_failures"]
                                  + out["requeue_limit_failures"])
        # prefix-cache effectiveness over the measurement window
        hit = self.metrics.counter("serve/prefix_hit_tokens").value
        seen = self.metrics.counter("serve/prompt_tokens").value
        out["prefix_hit_tokens"] = float(hit)
        out["prefix_hit_rate"] = hit / max(seen, 1)
        out["cow_forks_total"] = float(
            self.metrics.counter("serve/cow_forks").value)
        out["kv_bytes_saved"] = self.metrics.gauge(
            "serve/kv_bytes_saved").value
        ttft = self.metrics.histogram("serve/ttft_s")
        if ttft.count:
            out["ttft_p50_s"] = ttft.percentile(50)
            out["ttft_p99_s"] = ttft.percentile(99)
        itk = self.metrics.histogram("serve/inter_token_s",
                                     lo=1e-7, hi=3600.0)
        if itk.count:
            out["inter_token_p50_s"] = itk.percentile(50)
            out["inter_token_p99_s"] = itk.percentile(99)
        rate = self.metrics.histogram("serve/tokens_per_s",
                                      lo=1e-3, hi=1e6)
        if rate.count:
            out["req_tokens_per_s_p50"] = rate.percentile(50)
        kwh = self.monitor.total_wh / 1000.0
        self.ledger.entries.clear()
        self.ledger.add_operational_kwh("serve", kwh)
        out["carbon_g"] = self.ledger.operational_kg * 1000.0
        return out
