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
retired slot's row is simply overwritten by the next admission.

Under the fused-gather contract (``fused_gather``, on by default) the step
plans its live frames on the host (:func:`repro_torch.models.common.
page_live_plan`) and the bursts are sparse-extent: on the card each K/V
pool leaf is one gather kernel launch in and one scatter kernel launch
out.  ``fused_gather=False`` banks the whole pool through the dense burst
kernel and gathers after it.

The step runs eagerly, so ``fabric_stats`` counts every executed step (the
reference accumulates its counters once per traced jit bucket instead).
Preemption, swap, aging, load shedding, speculative decode and fault
injection (ROADMAP §1 items 3-4) and the sharded pool (item 8) are ported
in later slices; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.fabric import (BurstScheduler, Fabric, PagedKVCache,
                                SchedulerStats)
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.models import lm

_LATER = "is ported in a later slice (ROADMAP §1 item {})"


@dataclasses.dataclass(eq=False)           # identity equality: the prompt
class Request:                             # array makes field-eq ambiguous
    rid: int
    prompt: np.ndarray                     # [prompt_len] int32
    max_new_tokens: int
    priority: int = 0                      # higher preempts strictly lower
    deadline: Optional[int] = None         # SLO: retire by this engine step
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    _seq: int = dataclasses.field(default=0, repr=False)   # submit order


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: lm.LM, max_slots: int,
                 t_max: int, page_size: int = 0,
                 paged_pool: Optional[bool] = None, pool_pages: int = 0,
                 prefill_burst: Optional[bool] = None,
                 fused_gather: Optional[bool] = None, pool_shards: int = 0,
                 preempt: Optional[str] = None, check_pool: bool = False,
                 fault_injector=None, spec_decode_k: int = 0,
                 aging: int = 0, max_queue: int = 0):
        if cfg.family == "audio":
            raise ValueError("engine covers decoder-only families")
        fab_cfg = cfg.resolved_fabric
        for what, asked, item in (
                ("the sharded pool",
                 (pool_shards or fab_cfg.pool_shards) > 1, 8),
                ("fault injection", fault_injector is not None, 4),
                ("speculative decode", spec_decode_k > 0, 4),
                ("anti-starvation aging", aging > 0, 4),
                ("the bounded submit queue", max_queue > 0, 4)):
            if asked:
                raise NotImplementedError(f"{what} {_LATER.format(item)}")
        self.cfg = cfg
        self.params = params
        self.device = params.embed["table"].device
        self.max_slots = max_slots
        self.t_max = t_max
        self.fabric = Fabric(fab_cfg)
        # cache depth rounds up so every leaf's line count divides N
        n = self.fabric.n_ports
        self.t_alloc = -(-t_max // n) * n
        ps = page_size or min(fab_cfg.page_size, self.t_alloc)
        self.page_size = ps
        entries = lm.paged_entries(cfg)
        if not entries:
            raise NotImplementedError(
                f"families without full-attention leaves "
                f"{_LATER.format(7)}")
        # shared physical page pool (the default) or the dense per-slot
        # reservation
        self.paged = (fab_cfg.paged_pool if paged_pool is None
                      else paged_pool)
        if self.paged:
            pages_per_slot = -(-self.t_alloc // ps)
            pool_pages = pool_pages or max_slots * pages_per_slot
            # the pool rides the step's burst as one line stream: its frame
            # count rounds up to a multiple of N
            while (pool_pages * ps) % n:
                pool_pages += 1
        else:
            pool_pages = 0
        self.prefill_burst = prefill_burst
        # the fused gather needs the pool and a fabric that banks KV
        self.fused = ((fab_cfg.fused_gather_on if fused_gather is None
                       else fused_gather) and self.paged
                      and self.fabric.banks_kv)
        self.live_bucket = n * ps
        self.kv = PagedKVCache(
            api.init_cache(cfg, max_slots, self.t_alloc,
                           pool_pages=pool_pages, page_size=ps,
                           device=self.device),
            max_slots, self.t_alloc, ps, pool_pages=pool_pages,
            paged_entries=entries if self.paged else (), fabric=self.fabric,
            fused_gather=self.fused)
        self.pos = np.zeros((max_slots,), np.int32)      # next write position
        self.active: List[Optional[Request]] = [None] * max_slots
        self.tokens = np.zeros((max_slots, 1), np.int32)
        self.queue: List[Request] = []
        self.last_logits: Optional[torch.Tensor] = None
        self._page_reserve: dict = {}
        pre = fab_cfg.preempt if preempt is None else preempt
        if pre not in ("swap", "recompute", "off"):
            raise ValueError(f"preempt must be 'swap', 'recompute' or "
                             f"'off', got {pre!r}")
        self.preempt = pre if self.paged else "off"
        self.check_pool = check_pool
        self._submit_seq = 0
        self._step_count = 0
        self.fabric_stats = SchedulerStats()

    def _decode(self, tokens, caches, pos, page_table, live_plan):
        sched = BurstScheduler(self.fabric, stats=self.fabric_stats)
        return api.decode_fn(self.params, tokens, caches, pos, self.cfg,
                             sched=sched, page_table=page_table,
                             page_size=self.page_size, t_depth=self.t_alloc,
                             live_plan=live_plan)

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> str:
        """Enqueue a request; returns ``"queued"``.  Never-servable requests
        raise (a prompt the cache cannot hold, or a reach larger than the
        whole pool)."""
        if req.deadline is not None:
            raise NotImplementedError(
                f"SLO deadlines and shedding {_LATER.format(4)}")
        if len(req.prompt) + 1 > self.t_max:
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} tokens "
                f"cannot decode within t_max={self.t_max}")
        reach = min(len(req.prompt) + req.max_new_tokens, self.t_max)
        need = self.kv.table.pages_for(reach)
        if self.paged and need > self.kv.pool.n_pages:
            raise ValueError(
                f"request {req.rid}: reach of {reach} tokens reserves "
                f"{need} pages but the pool holds {self.kv.pool.n_pages}"
                f" — it would block the queue forever")
        req._seq = self._submit_seq
        self._submit_seq += 1
        self.queue.append(req)
        return "queued"

    def _rank(self, req: Request):
        """Admission order: priority class first, submit order next."""
        return (-req.priority, req._seq)

    def _admit(self) -> None:
        """Fill slots from the queue in priority order: prefill each prompt,
        then install the wave's KV through ONE write-burst flush (or the
        per-leaf splice).  Pool mode gates on free pages (head-of-line
        within the priority order); dense mode on free slots."""
        wave: list = []
        protected: set = set()
        while self.queue:
            req = sorted(self.queue, key=self._rank)[0]
            free = [s for s in range(self.max_slots)
                    if self.active[s] is None]
            if self.paged:
                # reserve the request's full reach so decode growth can
                # never exhaust the pool mid-flight — admission is the only
                # gate
                reach = min(len(req.prompt) + req.max_new_tokens, self.t_max)
                need = self.kv.table.pages_for(reach)
                if not free or self._pool_headroom() < need:
                    if not self._make_room(req, need, protected):
                        break        # wait for pages to be reclaimed
                self._page_reserve[free[0]] = need
            elif not free:
                break
            slot = free[0]
            protected.add(slot)
            self._install(req, slot, wave)
        if wave:
            self.kv.admit_wave(wave, stats=self.fabric_stats,
                               burst=self.prefill_burst)

    def _install(self, req: Request, slot: int, wave: list) -> None:
        """Prefill a fresh request into the wave and seat it in ``slot``."""
        self.queue.remove(req)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)[None, :]
        logits, req_cache = api.prefill_fn(
            self.params, {"tokens": prompt}, self.cfg, self.t_alloc)
        wave.append((slot, req_cache, len(req.prompt)))
        self.active[slot] = req
        self.pos[slot] = len(req.prompt)
        first = int(torch.argmax(logits[0, -1]))
        req.generated.append(first)
        self.tokens[slot, 0] = first

    def _make_room(self, req: Request, need: int, protected: set) -> bool:
        """Preemption: only strictly-lower-priority live slots may be
        evicted; with none eligible the request waits (as in the
        reference).  Evicting one is a later slice."""
        if self.preempt == "off":
            return False
        victims = [s for s in range(self.max_slots)
                   if self.active[s] is not None and s not in protected
                   and self.active[s].priority < req.priority]
        if victims:
            raise NotImplementedError(
                f"preemption (swap/recompute) {_LATER.format(4)}")
        return False

    def _pool_headroom(self) -> int:
        """Free pages not spoken for by live slots' unexpanded reaches."""
        return self.kv.pool.free_pages - sum(
            max(0, need - self.kv.pool.mapped(s))
            for s, need in self._page_reserve.items())

    # -- one engine step -----------------------------------------------------
    def step(self) -> int:
        """Admit + one batched decode step; returns #active sequences."""
        n_live = self._step_inner()
        self._step_count += 1
        if self.check_pool and self.paged:
            self.kv.pool.check()
        return n_live

    def _step_inner(self) -> int:
        self._admit()
        live = [s for s in range(self.max_slots) if self.active[s] is not None]
        if not live:
            return 0
        dev = self.device
        tokens = torch.from_numpy(self.tokens.copy()).to(dev)
        pos = self.pos.copy()                 # checked on the host
        page_table = self.kv.page_table_device(dev) if self.paged else None
        live_plan = None
        if self.fused:
            live_plan = tuple(
                torch.from_numpy(a).to(dev) for a in cm.page_live_plan(
                    self.kv.pool.table, self.page_size, self.t_alloc,
                    self.fabric.n_ports, bucket=self.live_bucket))
        logits, new_caches = self._decode(tokens, self.kv.caches, pos,
                                          page_table, live_plan)
        self.kv.update(new_caches)
        self.last_logits = logits[:, 0]
        # greedy over the padded vocab, as the reference
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu().numpy()
        for s in live:
            req = self.active[s]
            self.pos[s] += 1
            self.kv.extend(s, int(self.pos[s]))
            req.generated.append(int(nxt[s]))
            self.tokens[s, 0] = int(nxt[s])
            if (len(req.generated) >= req.max_new_tokens
                    or self.pos[s] + 1 >= self.t_max):
                req.done = True
                self.active[s] = None
                self.kv.free(s)
                self._page_reserve.pop(s, None)
        return len([s for s in range(self.max_slots)
                    if self.active[s] is not None])

    @property
    def step_count(self) -> int:
        return self._step_count

    @property
    def drained(self) -> bool:
        return not self.queue and all(r is None for r in self.active)

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        """Step until every submitted request retires; raises when
        ``max_steps`` runs out first."""
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                return
        pending = sum(r is not None for r in self.active) + len(self.queue)
        room = (f"pool headroom {self._pool_headroom()} of "
                f"{self.kv.pool.n_pages} pages" if self.paged
                else "dense layout")
        raise RuntimeError(
            f"run_to_completion: {max_steps} steps exhausted with {pending} "
            f"requests still pending ({room})")
