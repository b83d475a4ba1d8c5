"""Slot-based continuous-batching serving engine (port of
``repro.serving.engine``).

A fixed decode batch of ``max_slots`` sequences advances one token per
step; finished sequences retire and their slots refill from the queue.
By default every full-attention KV leaf lives in one shared physical page
pool (:class:`repro_torch.fabric.PagedKVCache`): pages are allocated at
admission and decode growth and reclaimed at retirement;
``paged_pool=False`` keeps the dense per-slot reservation instead.
Admission prefills each request and installs the wave through one write
burst (``prefill_burst=False``, a fabric that does not bank, or extents off
the write network's geometry splice per leaf instead).  Each decode step
runs through a :class:`repro_torch.fabric.BurstScheduler`: one read burst
banks the KV port-major (and, under ``serve_fsdp``, streams the weights),
attention runs in port-major space, one write burst restores line-major.
A fabric that cannot bank the leaves — the ``fused`` fabric, or one off
the port-per-KV-head geometry — decodes through the per-layer paged path
instead (:func:`repro_torch.models.lm._decode_step_paged_fallback`).
A sliding-window layer (gemma3's
``L``) keeps a per-slot ring of its last ``W`` positions on the device
instead: admission copies the request's ring into its slot's row, the step
writes and attends it line-major at each slot's own position, and a
retired slot's row is simply overwritten by the next admission.  The
recurrent and SSM blocks (recurrentgemma's ``R``, mamba2's ``M``) keep
their conv windows and float32 states per slot the same way.  A family
with no full-attention leaf (recurrentgemma-2b, mamba2-780m) has nothing
to pool: it serves from the dense per-slot layout, its decode step takes
the per-layer path (no burst, no kernel), and preemption is off, as in
the reference.  The engine serves text prompts; a VLM's patch prefix is
the one-shot path's (:func:`repro_torch.models.api.greedy_generate`).

Under the fused-gather contract (``fused_gather``, on by default) the step
plans its live frames on the host (:func:`repro_torch.models.common.
page_live_plan`) and the bursts are sparse-extent: on the card each K/V
pool leaf is one gather kernel launch in and one scatter kernel launch
out.  ``fused_gather=False`` banks the whole pool through the dense burst
kernel and gathers after it.

**Oversubscription** (``preempt``): requests carry priority classes and
optional SLO deadlines.  When a higher-priority request would wait on a
full pool the engine preempts live slots — lowest effective priority
first, then most pages, then the oldest admission — and parks them: the
swap arm stages the slot's frames to the host over ``swap/<slot>/*``
sparse-extent read streams (the gather kernel on the card) and restores
them at re-admission through the write burst's scatter (the scatter
kernel), parity-checked end to end; the recompute arm (``preempt=
"recompute"``, a full swap space, or nothing decoded yet) drops the pages
and re-prefills ``prompt + generated[:-1]``.  Parked requests re-admit
ahead of the queue within their class.  ``max_queue`` bounds the submit
queue (overflow sheds), ``aging`` raises a waiting request's effective
priority one class per ``aging`` steps, and a request whose deadline is
provably unmeetable is shed at submit or while it waits.  A
:class:`repro_torch.runtime.FaultInjector` plugs into the same path:
injected pool exhaustion backs admission off a step, a corrupted swap
transfer is caught by the parity word and retried, and a mid-step failure
rolls the engine back to its pre-step snapshot and replays the step.
Because the port's caches change in place (the decode writes, the write
burst's scatter, admission's install), the snapshot clones every cache
leaf while an injector is attached, and the rollback copies them back.

**Speculative decode** (``spec_decode_k``): each step the model's Medusa
draft heads (or ``draft_fn``) propose a branch per slot and
:meth:`ServingEngine.verify_step` accepts its longest prefix that matches
the committed argmax; commits only ever come from row 0 of the step's
logits, so the token stream is the one ``spec_decode_k=0`` serves.

**The sharded pool** (``pool_shards > 1``, ``collective``): the pool's
page axis splits into ``pool_shards`` contiguous shard blocks, the
allocator stripes pages round-robin over them, and each step plans, on the
host, one :func:`repro_torch.fabric.shard_plan` per distinct leaf rep
count; every K/V pool stream then lowers as per-shard fused gathers and
scatters (kernels 1 and 2 once per shard on the card) bridged by one
exchange, ``all_to_all`` or its ``ring`` of rotations
(:mod:`repro_torch.fabric.sharded`).  It needs the fused-gather contract.
Every shard lives on the engine's device in this slice.

The step runs eagerly, so ``fabric_stats`` counts every executed step (the
reference accumulates its counters once per traced jit bucket instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.fabric import (BurstScheduler, Fabric, PagedKVCache,
                                SchedulerStats, SwapRecord, make_pool_mesh,
                                shard_plan)
from repro_torch.fabric.sharded import check_owned_rows
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.models import moe

# the seed of the draft heads an engine draws when its params have none
_DRAFT_SEED = 0x5BEC


def _lead_prod(flat) -> int:
    """Product of a flattened pool leaf's leading (layer-stack) axes."""
    return math.prod(flat.shape[:-3])


@dataclasses.dataclass(eq=False)           # identity equality: the prompt
class Request:                             # array makes field-eq ambiguous
    rid: int
    prompt: np.ndarray                     # [prompt_len] int32
    max_new_tokens: int
    priority: int = 0                      # higher preempts strictly lower
    deadline: Optional[int] = None         # SLO: retire by this engine step
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    arrival_step: int = -1                 # engine step at submit(): the
    #                                        clock for queue wait and aging
    shed_reason: Optional[str] = None      # set when load-shed, never served
    _seq: int = dataclasses.field(default=0, repr=False)   # submit order


@dataclasses.dataclass
class _Swapped:
    """A preempted request parked in the host swap space: ``record`` is
    its staged KV image (swap arm) or None (recompute arm: re-admission
    re-prefills ``prompt + generated[:-1]``)."""

    req: Request
    record: Optional[SwapRecord]
    pos: int                               # next write position at eviction
    token: int                             # the pending decode token


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: lm.LM, max_slots: int,
                 t_max: int, page_size: int = 0,
                 paged_pool: Optional[bool] = None, pool_pages: int = 0,
                 prefill_burst: Optional[bool] = None,
                 fused_gather: Optional[bool] = None, pool_shards: int = 0,
                 collective: Optional[str] = None,
                 preempt: Optional[str] = None,
                 swap_space_pages: Optional[int] = None,
                 check_pool: bool = False, fault_injector=None,
                 spec_decode_k: int = 0, draft_fn=None, aging: int = 0,
                 max_queue: int = 0, recorder=None):
        if cfg.family == "audio":
            raise ValueError("engine covers decoder-only families")
        self.cfg = cfg
        # speculative decode: the model's draft heads (drawn here from a
        # fixed seed when params carry none) or ``draft_fn(req,
        # committed) -> [k tokens]`` propose; commits read row 0 only
        self.spec_k = int(spec_decode_k)
        self.draft_fn = draft_fn
        self._model_draft = self.spec_k > 0 and draft_fn is None
        if self._model_draft and getattr(params, "draft", None) is None:
            dev = params.embed["table"].device
            gen = torch.Generator(device=dev)
            gen.manual_seed(_DRAFT_SEED)
            params = lm.with_draft(params, cm.draft_head_params(
                gen, dataclasses.replace(cfg, spec_heads=self.spec_k),
                cfg.param_dtype, dev))
        if self._model_draft and params.draft["w"].shape[0] < self.spec_k:
            raise ValueError(
                f"spec_decode_k={self.spec_k} wants at least that many "
                f"draft heads; params carry {params.draft['w'].shape[0]}")
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self._draft_queue: Dict[int, List[int]] = {}
        self.params = params
        self.device = params.embed["table"].device
        self.max_slots = max_slots
        self.t_max = t_max
        # the sharded pool: 0 inherits the config's pool_shards; the
        # fabric config validates the count and the collective
        fab_cfg = cfg.resolved_fabric
        shards = pool_shards or fab_cfg.pool_shards
        if shards > 1 or collective is not None:
            fab_cfg = dataclasses.replace(
                fab_cfg, pool_shards=shards,
                collective=collective or fab_cfg.collective).validate()
        self.pool_shards = shards = fab_cfg.pool_shards
        mesh = make_pool_mesh(shards, self.device) if shards > 1 else None
        self.fabric = Fabric(fab_cfg, mesh=mesh)
        # cache depth rounds up so every leaf's line count divides N
        n = self.fabric.n_ports
        self.t_alloc = -(-t_max // n) * n
        ps = page_size or min(fab_cfg.page_size, self.t_alloc)
        self.page_size = ps
        # shared physical page pool (the default) or the dense per-slot
        # reservation; a family without full-attention leaves (recurrent,
        # SSM, or ring-only) has nothing to pool
        entries = lm.paged_entries(cfg)
        self.paged = (fab_cfg.paged_pool if paged_pool is None
                      else paged_pool) and bool(entries)
        if self.paged:
            pages_per_slot = -(-self.t_alloc // ps)
            pool_pages = pool_pages or max_slots * pages_per_slot
            # the pool rides the step's burst as one line stream: its frame
            # count rounds up to a multiple of N; sharded, its pages also
            # split into `shards` equal contiguous blocks
            while (pool_pages * ps) % n or pool_pages % shards:
                pool_pages += 1
        else:
            pool_pages = 0
        self.prefill_burst = prefill_burst
        # the fused gather needs the pool and a fabric that banks KV
        self.fused = ((fab_cfg.fused_gather_on if fused_gather is None
                       else fused_gather) and self.paged
                      and self.fabric.banks_kv)
        if shards > 1 and not self.fused:
            raise ValueError(
                f"pool_shards={shards} needs the fused-gather pool contract "
                f"(paged pool + a fabric that banks KV) — the sharded "
                f"lowering is the sparse burst's collective form")
        # live-plan lengths quantize to whole page-of-lines buckets; sharded,
        # the bucket also splits every rep's lines into `shards` blocks of
        # whole N-groups (lcm, so 1 shard is unchanged)
        self.live_bucket = n * math.lcm(ps, shards)
        self.kv = PagedKVCache(
            api.init_cache(cfg, max_slots, self.t_alloc,
                           pool_pages=pool_pages, page_size=ps,
                           device=self.device),
            max_slots, self.t_alloc, ps, pool_pages=pool_pages,
            paged_entries=entries if self.paged else (), fabric=self.fabric,
            fused_gather=self.fused, pool_shards=shards)
        # distinct leading rep counts over the paged leaves: the sharded
        # step carries one fetch/place plan per rep count
        self._shard_reps = sorted({
            max(1, _lead_prod(lm._flat_frames(self.kv.caches[kind][i]["k"])))
            for kind, i in entries}) if (self.paged and shards > 1) else []
        self.pos = np.zeros((max_slots,), np.int32)      # next write position
        self.active: List[Optional[Request]] = [None] * max_slots
        self.tokens = np.zeros((max_slots, 1), np.int32)
        self.queue: List[Request] = []
        self.last_logits: Optional[torch.Tensor] = None
        # pool mode: pages reserved per live slot for its full reach, so
        # decode growth can never exhaust the pool mid-flight
        self._page_reserve: dict = {}
        # preemption: "swap" parks victims in the host swap space, "recompute"
        # drops their pages and re-prefills on re-admission, "off" is the
        # head-of-line gate.  Needs the page pool.
        pre = fab_cfg.preempt if preempt is None else preempt
        if pre not in ("swap", "recompute", "off"):
            raise ValueError(f"preempt must be 'swap', 'recompute' or "
                             f"'off', got {pre!r}")
        self.preempt = pre if self.paged else "off"
        self.swap_space_pages = (fab_cfg.swap_space_pages
                                 if swap_space_pages is None
                                 else swap_space_pages)
        self.check_pool = check_pool
        self.fault_injector = fault_injector
        self.kv.fault_injector = fault_injector
        self._swapped: Dict[int, _Swapped] = {}      # rid → parked request
        self._admitted_at: dict = {}                 # slot → admission step
        self._swap_pages_used = 0
        self._submit_seq = 0
        self._step_count = 0
        # anti-starvation aging: every `aging` steps a candidate waits past
        # its arrival its effective priority rises one class (0 = off)
        if aging < 0:
            raise ValueError(f"aging must be >= 0 steps/class, got {aging}")
        self.aging = aging
        # bounded submit queue: submit() sheds once this many requests are
        # queued (0 = unbounded)
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_queue = max_queue
        # lifecycle observer (duck-typed): record_admit, record_first_token,
        # record_retire, record_shed — None = no observation
        self.recorder = recorder
        self.fabric_stats = SchedulerStats()

    def _decode(self, tokens, caches, pos, page_table, live_plan,
                shard_plans=None):
        """One decode step.  The MoE dispatch accounting (its bursts and
        ``tokens_dropped``) goes to ``fabric_stats`` for the decode step
        only; admission's prefill runs outside the sink, as the
        reference's does."""
        sched = BurstScheduler(self.fabric, stats=self.fabric_stats)
        with moe.dispatch_stats(self.fabric_stats):
            return api.decode_fn(self.params, tokens, caches, pos, self.cfg,
                                 sched=sched, page_table=page_table,
                                 page_size=self.page_size,
                                 t_depth=self.t_alloc, live_plan=live_plan,
                                 shard_plans=shard_plans,
                                 draft=self._model_draft)

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> str:
        """Enqueue a request; returns ``"queued"`` or ``"shed"``.

        Never-servable requests raise (a prompt the cache cannot hold, or a
        reach larger than the whole pool); a deadlined one counts
        ``slo_missed_shed`` before the raise.  Two gates shed instead of
        queueing (``req.shed_reason`` set, counted, ``done`` marked):
        the bounded queue is full (``shed_queue_full``), or the deadline
        is provably unmeetable (``shed_deadline``)."""
        if len(req.prompt) + 1 > self.t_max:
            self._count_shed(req, None)        # counted even though raised
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"cannot decode within t_max={self.t_max}")
        if self.kv.paged:
            reach = min(len(req.prompt) + req.max_new_tokens, self.t_max)
            need = self.kv.table.pages_for(reach)
            if need > self.kv.pool.n_pages:
                self._count_shed(req, None)
                raise ValueError(
                    f"request {req.rid}: reach of {reach} tokens reserves "
                    f"{need} pages but the pool holds {self.kv.pool.n_pages}"
                    f" — it would block the queue forever")
        req.arrival_step = self._step_count
        if self.max_queue and len(self.queue) >= self.max_queue:
            self._shed(req, "queue_full")
            return "shed"
        if req.deadline is not None and self._provably_unmeetable(req):
            self._shed(req, "deadline")
            return "shed"
        req._seq = self._submit_seq
        self._submit_seq += 1
        self.queue.append(req)
        return "queued"

    # -- SLO-aware load shedding ---------------------------------------------
    def _earliest_retire(self, req: Request, admit_step: int) -> int:
        """The earliest step ``req`` can retire if (re-)admitted at
        ``admit_step``: one committed token per step, plus the prefill's
        first token for a fresh request, capped by the cache depth."""
        g = len(req.generated)
        # a fresh install appends the prefill argmax AND decodes in the
        # same step (+2); a swap-in resumes with its pending token (+1)
        first_step_tokens = 2 if g == 0 else 1
        by_tokens = req.max_new_tokens - g - first_step_tokens
        by_depth = self.t_max - len(req.prompt) - g - first_step_tokens
        return admit_step + max(0, min(by_tokens, by_depth))

    def _provably_unmeetable(self, req: Request) -> bool:
        """True when ``req.deadline`` cannot be met under any schedule:
        even admitted now, or — with preemption and aging off, when no slot
        or pages are free — one step past the earliest live retirement."""
        admit = self._step_count
        if self.preempt == "off" and self.aging == 0:
            live = [s for s in range(self.max_slots)
                    if self.active[s] is not None]
            blocked = len(live) == self.max_slots
            if self.kv.paged and not blocked:
                reach = min(len(req.prompt) + req.max_new_tokens, self.t_max)
                blocked = (self._pool_headroom()
                           < self.kv.table.pages_for(reach))
            if blocked and live:
                admit = 1 + min(
                    self._earliest_retire(self.active[s], self._step_count)
                    for s in live)
        return self._earliest_retire(req, admit) > req.deadline

    def _count_shed(self, req: Request, reason: Optional[str]) -> None:
        stats = self.fabric_stats
        stats.requests_shed += 1
        if reason == "queue_full":
            stats.shed_queue_full += 1
        elif reason == "deadline":
            stats.shed_deadline += 1
        if req.deadline is not None:
            stats.slo_missed_shed += 1

    def _shed(self, req: Request, reason: str) -> None:
        """Reject ``req`` with a counted reason; it is marked done without
        output so callers that wait for it finish."""
        self._count_shed(req, reason)
        req.shed_reason = reason
        req.done = True
        if self.recorder is not None:
            self.recorder.record_shed(req, self._step_count, reason)

    def _shed_unmeetable_queued(self) -> None:
        """Shed every queued or parked request whose deadline became
        provably unmeetable while it waited; a parked one releases its
        swap space."""
        for req in [r for r in self.queue if r.deadline is not None]:
            if self._earliest_retire(req, self._step_count) > req.deadline:
                self.queue.remove(req)
                self._shed(req, "deadline")
        for rid, sw in list(self._swapped.items()):
            req = sw.req
            if req.deadline is None:
                continue
            if self._earliest_retire(req, self._step_count) > req.deadline:
                del self._swapped[rid]
                if sw.record is not None:
                    self._swap_pages_used -= sw.record.mapped
                self._shed(req, "deadline")

    def _eff_priority(self, req: Request) -> int:
        """The raw class plus one for every ``aging`` steps waited since
        arrival (admission rank and preemption eligibility both use it)."""
        if not self.aging or req.arrival_step < 0:
            return req.priority
        return req.priority + (self._step_count - req.arrival_step) // self.aging

    def _rank(self, req: Request):
        """Admission order: effective priority first, earliest deadline
        next, submit order last."""
        dl = float("inf") if req.deadline is None else req.deadline
        return (-self._eff_priority(req), dl, req._seq)

    def _candidates(self) -> list:
        """Admissible work, best first: parked requests and the queue, in
        :meth:`_rank` order (a parked request's submit stamp predates the
        queue's within its class)."""
        cands = list(self._swapped.values()) + list(self.queue)
        return sorted(cands, key=lambda c: self._rank(
            c.req if isinstance(c, _Swapped) else c))

    def _admit(self) -> None:
        """Fill slots from the swap space and the queue in priority order:
        prefill each fresh prompt, then install the wave through ONE
        write-burst flush (or the per-leaf splice); swap-ins restore at
        once (one ``swap/*`` flush per slot).  Pool mode gates on free
        pages and, when the best candidate outranks live work, preempts
        victims instead of waiting (:meth:`_make_room`); dense mode gates
        on free slots.  An injected pool exhaustion backs the whole wave
        off for the step."""
        self._shed_unmeetable_queued()
        if (self.kv.paged and self.fault_injector is not None
                and self.fault_injector.pool_exhausted(self._step_count)):
            return
        wave: list = []
        protected: set = set()         # slots filled this wave — no victims
        while True:
            cands = self._candidates()
            if not cands:
                break
            cand = cands[0]
            req = cand.req if isinstance(cand, _Swapped) else cand
            free = [s for s in range(self.max_slots)
                    if self.active[s] is None]
            if self.kv.paged:
                # reserve the request's full reach so decode growth can
                # never exhaust the pool mid-flight — admission is the only
                # gate
                reach = min(len(req.prompt) + req.max_new_tokens, self.t_max)
                need = self.kv.table.pages_for(reach)
                if not free or self._pool_headroom() < need:
                    if not self._make_room(req, need, protected,
                                           have_slot=bool(free)):
                        break        # wait for pages to be reclaimed
                    free = [s for s in range(self.max_slots)
                            if self.active[s] is None]
                self._page_reserve[free[0]] = need
            elif not free:
                break
            slot = free[0]
            protected.add(slot)
            self._install(cand, slot, wave)
        if wave:
            self.kv.admit_wave(wave, stats=self.fabric_stats,
                               burst=self.prefill_burst)

    def _prefill(self, tokens) -> tuple:
        prompt = torch.as_tensor(np.array(tokens, np.int32),
                                 device=self.device)[None, :]
        return api.prefill_fn(self.params, {"tokens": prompt}, self.cfg,
                              self.t_alloc)

    def _install(self, cand, slot: int, wave: list) -> None:
        """Land one candidate in ``slot``: a fresh request prefills into the
        wave; a parked one restores over the bursts (swap arm) or
        re-prefills everything decoded so far (recompute arm) — both resume
        with the cache holding ``prompt + generated[:-1]`` and the last
        token pending decode."""
        req0 = cand.req if isinstance(cand, _Swapped) else cand
        if self.aging and self._eff_priority(req0) > req0.priority:
            self.fabric_stats.aging_promotions += 1
        if isinstance(cand, _Swapped):
            req = cand.req
            del self._swapped[req.rid]
            self.active[slot] = req
            self.pos[slot] = cand.pos
            self.tokens[slot, 0] = cand.token
            if cand.record is not None:
                self.kv.swap_in(slot, cand.record, stats=self.fabric_stats)
                self._swap_pages_used -= cand.record.mapped
            else:
                full = np.concatenate([np.asarray(req.prompt, np.int32),
                                       np.asarray(req.generated[:-1],
                                                  np.int32)])
                _, req_cache = self._prefill(full)
                wave.append((slot, req_cache, len(full)))
        else:
            req = cand
            self.queue.remove(req)
            logits, req_cache = self._prefill(req.prompt)
            wave.append((slot, req_cache, len(req.prompt)))
            self.active[slot] = req
            self.pos[slot] = len(req.prompt)
            first = int(torch.argmax(logits[0, -1]))
            req.generated.append(first)
            self.tokens[slot, 0] = first
            if self.recorder is not None:
                self.recorder.record_first_token(req, self._step_count)
        if self.recorder is not None:
            self.recorder.record_admit(req, self._step_count)
        self._admitted_at[slot] = self._step_count
        # a draft branch belongs to one tenure of a slot
        self._draft_queue.pop(slot, None)

    # -- preemption ----------------------------------------------------------
    def _make_room(self, req: Request, need: int, protected: set,
                   have_slot: bool) -> bool:
        """Evict strictly-lower-priority live slots (effective priorities)
        until ``req`` has a slot and ``need`` pages of headroom.  Victim
        order: lowest priority, then most mapped pages, then the oldest
        admission.  All or nothing: if every eligible victim would not make
        room, none is evicted."""
        if self.preempt == "off":
            return False
        victims = [s for s in range(self.max_slots)
                   if self.active[s] is not None and s not in protected
                   and (self._eff_priority(self.active[s])
                        < self._eff_priority(req))]
        victims.sort(key=lambda s: (self._eff_priority(self.active[s]),
                                    -self.kv.pool.mapped(s),
                                    self._admitted_at.get(s, 0)))
        headroom = self._pool_headroom()
        chosen = []
        for s in victims:
            if have_slot and headroom >= need:
                break
            # freeing s returns its mapped pages AND retires its reserve
            headroom += max(self.kv.pool.mapped(s),
                            self._page_reserve.get(s, 0))
            have_slot = True
            chosen.append(s)
        if not (have_slot and headroom >= need):
            return False
        for s in chosen:
            self._preempt_slot(s)
        return True

    def _preempt_slot(self, slot: int) -> None:
        """Evict one live slot: the swap arm stages its frames to the host
        swap space over the ``swap/*`` read streams; the recompute arm —
        by config, when the swap space is full, or when nothing has been
        decoded yet — drops its pages."""
        req = self.active[slot]
        use_swap = self.preempt == "swap" and len(req.generated) > 1
        if use_swap and self.swap_space_pages:
            if (self._swap_pages_used + self.kv.pool.mapped(slot)
                    > self.swap_space_pages):
                use_swap = False
        if use_swap:
            record = self.kv.swap_out(slot, stats=self.fabric_stats)
            self._swap_pages_used += record.mapped
        else:
            record = None
            self.kv.free(slot)
        self._swapped[req.rid] = _Swapped(
            req=req, record=record, pos=int(self.pos[slot]),
            token=int(self.tokens[slot, 0]))
        self.active[slot] = None
        self._page_reserve.pop(slot, None)
        self._admitted_at.pop(slot, None)
        self.fabric_stats.preemptions += 1

    def _pool_headroom(self) -> int:
        """Free pages not spoken for by live slots' unexpanded reaches."""
        return self.kv.pool.free_pages - sum(
            max(0, need - self.kv.pool.mapped(s))
            for s, need in self._page_reserve.items())

    # -- one engine step -----------------------------------------------------
    def step(self) -> int:
        """Admit + one batched decode step; returns #active sequences.

        With a fault injector attached the engine snapshots its state
        before the step (cloning every cache leaf); an injected mid-step
        failure rolls back to the snapshot and replays the step
        (``fabric_stats.faults_recovered``).  With ``check_pool`` the
        pool's conservation invariant runs after every step."""
        step_no = self._step_count
        snap = self._snapshot() if self.fault_injector is not None else None
        try:
            n_live = self._step_inner(step_no)
        except RuntimeError:
            if snap is None:
                raise
            self._restore(snap)
            self.fabric_stats.faults_recovered += 1
            n_live = self._step_inner(step_no)
        self._step_count = step_no + 1
        if self.check_pool and self.paged:
            self.kv.pool.check()
        return n_live

    def _step_inner(self, step_no: int) -> int:
        self._admit()
        if self.fault_injector is not None:
            self.fault_injector.check(step_no)     # mid-step failure seam
        live = [s for s in range(self.max_slots) if self.active[s] is not None]
        if not live:
            return 0
        dev = self.device
        tokens = torch.from_numpy(self.tokens.copy()).to(dev)
        pos = self.pos.copy()                 # checked on the host
        page_table = self.kv.page_table_device(dev) if self.paged else None
        live_plan = shard_plans = None
        if self.fused:
            plan = cm.page_live_plan(
                self.kv.pool.table, self.page_size, self.t_alloc,
                self.fabric.n_ports, bucket=self.live_bucket)
            live_plan = tuple(torch.from_numpy(a).to(dev) for a in plan)
            if self.pool_shards > 1:
                shard_plans = self.shard_plans(plan[0])
        logits, new_caches = self._decode(tokens, self.kv.caches, pos,
                                          page_table, live_plan, shard_plans)
        self.kv.update(new_caches)
        self.last_logits = logits[:, 0]
        # commits only ever read row 0 — the real unembedding — so the
        # token stream does not depend on spec_decode_k
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu().numpy()
        drafts = None
        if self._model_draft:
            drafts = torch.argmax(logits[:, 1:1 + self.spec_k], dim=-1).to(
                torch.int32).cpu().numpy()
        for s in live:
            req = self.active[s]
            self.pos[s] += 1
            self.kv.extend(s, int(self.pos[s]))
            req.generated.append(int(nxt[s]))
            self.tokens[s, 0] = int(nxt[s])
            if self.spec_k:
                self.verify_step(s, req, int(nxt[s]),
                                 None if drafts is None else drafts[s])
            if (len(req.generated) >= req.max_new_tokens
                    or self.pos[s] + 1 >= self.t_max):
                req.done = True
                if req.deadline is not None and step_no > req.deadline:
                    self.fabric_stats.slo_missed_served += 1
                if self.recorder is not None:
                    self.recorder.record_retire(req, step_no)
                self.active[s] = None
                self.kv.free(s)
                self._page_reserve.pop(s, None)
                self._admitted_at.pop(s, None)
                self._draft_queue.pop(s, None)
        return len([s for s in range(self.max_slots)
                    if self.active[s] is not None])

    def shard_plans(self, live_idx) -> Dict[int, tuple]:
        """The step's host-side split of the live frames ``live_idx`` by
        owning shard: one :func:`repro_torch.fabric.shard_plan` per distinct
        leaf rep count (the bucket capacity rounds to whole pages), as
        device operands ``{reps: (fetch, place)}``.  Each plan's local hops
        are checked here, on the host, to name only their own shard's
        rows."""
        frames = self.kv.pool.n_pages * self.page_size
        out = {}
        for reps in self._shard_reps:
            plan = shard_plan(live_idx, frames, self.pool_shards,
                              self.fabric.n_ports, reps=reps,
                              cap_bucket=self.page_size)
            check_owned_rows(plan, reps, frames)
            out[reps] = plan.operands(self.device)
        return out

    # -- speculative decoding -------------------------------------------------
    def verify_step(self, slot: int, req: Request, committed: int,
                    drafts) -> None:
        """Verify one level of the slot's draft branch against the committed
        token (longest-matching-prefix acceptance, one token per step): a
        match pops the branch head (``spec_accepted``), a mismatch discards
        the rest of the branch (``spec_rejected``; the committed argmax is
        itself the correction), and a drained branch takes ``k`` fresh
        proposals from the draft heads or ``draft_fn``."""
        q = self._draft_queue.get(slot)
        if q:
            if q[0] == committed:
                self.spec_accepted += 1
                q.pop(0)
            else:
                self.spec_rejected += len(q)
                q.clear()
        if not self._draft_queue.get(slot):
            if self.draft_fn is not None:
                prop = self.draft_fn(req, committed)
            else:
                prop = [] if drafts is None else [int(x) for x in drafts]
            prop = list(prop)[:self.spec_k]
            if prop:
                self._draft_queue[slot] = prop
                self.spec_proposed += len(prop)

    @property
    def spec_acceptance(self) -> float:
        """Fraction of proposed draft tokens the target verified."""
        return self.spec_accepted / max(1, self.spec_proposed)

    @property
    def step_count(self) -> int:
        """Engine steps taken so far — the clock of every deadline and
        aging computation."""
        return self._step_count

    @property
    def drained(self) -> bool:
        """No live, queued or parked work left."""
        return (not self.queue and not self._swapped
                and all(r is None for r in self.active))

    @property
    def slo_misses(self) -> int:
        """Deadline misses on every exit path: late retirements plus
        deadlined requests shed."""
        return (self.fabric_stats.slo_missed_served
                + self.fabric_stats.slo_missed_shed)

    def pending_census(self) -> str:
        """Per-class depths of live, queued and parked work, pool headroom
        and swap-space occupancy — the stall story ``run_to_completion``
        raises with."""
        def by_class(reqs):
            depth: Dict[int, int] = {}
            for r in reqs:
                depth[r.priority] = depth.get(r.priority, 0) + 1
            return ("{" + ", ".join(f"class{p}: {n}" for p, n in
                                    sorted(depth.items())) + "}"
                    if depth else "{}")
        live = [r for r in self.active if r is not None]
        parked = [w.req for w in self._swapped.values()]
        pool = (f"pool headroom {self._pool_headroom()} of "
                f"{self.kv.pool.n_pages} pages "
                f"({self.kv.pool.free_pages} free)" if self.kv.paged
                else "pool off (dense reservation)")
        cap = self.swap_space_pages or "unbounded"
        return (f"live {by_class(live)}, queued {by_class(self.queue)}, "
                f"swapped {by_class(parked)}; {pool}; "
                f"swap space {self._swap_pages_used} pages used (cap {cap})")

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        """Step until every submitted request retires; raises with the
        :meth:`pending_census` when ``max_steps`` runs out first."""
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue and not self._swapped:
                return
        pending = (sum(r is not None for r in self.active) + len(self.queue)
                   + len(self._swapped))
        raise RuntimeError(
            f"run_to_completion: {max_steps} steps exhausted with {pending} "
            f"requests still pending — {self.pending_census()} — the "
            f"workload does not fit, or admission is starved")

    # -- fault recovery ------------------------------------------------------
    def _cache_leaves(self):
        """``(kind, i, name, leaf)`` for every leaf of the cache tree."""
        for kind in ("unit", "tail"):
            for i, entry in enumerate(self.kv.caches[kind]):
                for name, leaf in entry.items():
                    yield kind, i, name, leaf

    def _snapshot(self) -> dict:
        """The engine's full pre-step state.  The caches change in place
        (the decode writes, the write burst's scatter, admission's
        install), so every leaf is cloned: the snapshot keeps each leaf
        tensor and a copy of its bytes.  Host state is copied; request
        objects are shared with the caller, so only their mutable tail
        (``generated`` length, ``done``) is recorded."""
        reqs = [(r, len(r.generated), r.done) for r in
                (list(self.queue) + [w.req for w in self._swapped.values()]
                 + [r for r in self.active if r is not None])]
        pool = self.kv.pool
        return dict(
            caches=[(kind, i, name, leaf, leaf.clone())
                    for kind, i, name, leaf in self._cache_leaves()],
            pos=self.pos.copy(), tokens=self.tokens.copy(),
            active=list(self.active), queue=list(self.queue),
            swapped=dict(self._swapped),
            reserve=dict(self._page_reserve),
            admitted=dict(self._admitted_at),
            swap_used=self._swap_pages_used,
            submit_seq=self._submit_seq,
            last_logits=self.last_logits,
            table_used=self.kv.table.used.copy(),
            dirty=self.kv._dirty.copy(),
            kv_counters=(self.kv.tokens_moved, self.kv.tokens_moved_dense,
                         self.kv.prefill_bursts, self.kv.prefill_splices),
            pool=None if pool is None else (
                pool.table.copy(),
                [list(s) for s in pool._free_by_shard], pool._rr,
                pool.pages_allocated, pool.pages_reclaimed,
                pool.pages_swapped_out, pool.pages_swapped_in),
            stats=dataclasses.replace(self.fabric_stats),
            spec=(self.spec_proposed, self.spec_accepted, self.spec_rejected,
                  {s: list(q) for s, q in self._draft_queue.items()}),
            reqs=reqs)

    def _restore(self, snap: dict) -> None:
        """Roll back to the pre-step snapshot: the cache tree is rebuilt
        from the snapshot's leaf tensors and each gets its saved bytes
        back in place (so the leaves keep their addresses); host state and
        ``fabric_stats`` are restored field in place."""
        caches = {"unit": [{} for _ in self.kv.caches["unit"]],
                  "tail": [{} for _ in self.kv.caches["tail"]]}
        for kind, i, name, leaf, saved in snap["caches"]:
            leaf.copy_(saved)
            caches[kind][i][name] = leaf
        self.kv.update(caches)
        self.pos[:] = snap["pos"]
        self.tokens[:] = snap["tokens"]
        self.active = snap["active"]
        self.queue = snap["queue"]
        self._swapped = snap["swapped"]
        self._page_reserve = snap["reserve"]
        self._admitted_at = snap["admitted"]
        self._swap_pages_used = snap["swap_used"]
        self._submit_seq = snap["submit_seq"]
        self.last_logits = snap["last_logits"]
        self.kv.table.used[:] = snap["table_used"]
        self.kv._dirty[:] = snap["dirty"]
        (self.kv.tokens_moved, self.kv.tokens_moved_dense,
         self.kv.prefill_bursts, self.kv.prefill_splices) = snap["kv_counters"]
        if snap["pool"] is not None:
            pool = self.kv.pool
            (table, free, rr, alloc, reclaimed, s_out, s_in) = snap["pool"]
            pool.table[:] = table
            pool._free_by_shard = [list(s) for s in free]
            pool._rr = rr
            pool.pages_allocated = alloc
            pool.pages_reclaimed = reclaimed
            pool.pages_swapped_out = s_out
            pool.pages_swapped_in = s_in
        for f in dataclasses.fields(SchedulerStats):
            setattr(self.fabric_stats, f.name, getattr(snap["stats"], f.name))
        (self.spec_proposed, self.spec_accepted, self.spec_rejected,
         queues) = snap["spec"]
        self._draft_queue = {s: list(q) for s, q in queues.items()}
        for r, n_gen, done in snap["reqs"]:
            del r.generated[n_gen:]
            r.done = done
