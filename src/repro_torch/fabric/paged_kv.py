"""Paged KV-cache storage for the serving engine (port of
``repro.fabric.paged_kv``: the shared physical page pool, its burst and
splice admission, and the dense per-slot layout).

In pool mode every full-attention leaf is one ``[reps, n_pages,
page_size, Hkv, D]`` physical region; a per-slot logical→physical table
(:class:`PagePool`, ``int32 [n_slots, pages_per_slot]``, ``-1`` =
unmapped) indirects each slot's time axis into it.  Pages come from a free
list at admission and decode growth and return to it at retirement.

Admission rides the fabric: :meth:`PagedKVCache.admit_wave` installs a
wave of prompts through one write-burst flush.  Under the fused-gather
contract each paged leaf takes the whole wave as one scatter-indexed write
stream that lands every prompt frame at its physical row, in place
(:meth:`PagedKVCache._pool_install_fused`); otherwise dense ``prefill/*``
write streams go through the network and their output is copied into the
mapped pages (:meth:`PagedKVCache._pool_install`).  A slot whose extents
miss the write network's geometry — every slot with ``burst=False`` or on
a fabric that does not bank — is spliced per leaf instead
(``prefill_splices``).  The leaves the pool does not back (a
sliding-window layer's ring) stay per slot and are copied into the slot's
row at admission (:meth:`PagedKVCache._splice_unpaged`).

In dense mode (``pool_pages == 0``) every leaf keeps a per-slot ``[..,
max_slots, t_max, ..]`` reservation and admission splices the request into
its row (:meth:`PagedKVCache._dense_splice`).

Under oversubscription the engine evicts a slot to the host swap space
(:meth:`PagedKVCache.swap_out`): its mapped frames leave over the read
burst's page-table gather as ``swap/<slot>/<leaf>`` sparse-extent streams
and are copied to host memory; :meth:`PagedKVCache.swap_in` lands them at
new physical rows through the write burst's scatter.  Both directions are
checked end to end by an XOR parity word and retried once on a mismatch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fabric.fabric import pm_to_banked
from repro_torch.fabric.scheduler import (FRAME_SENTINEL as _SENTINEL,
                                          BurstScheduler, SchedulerStats)

@dataclasses.dataclass
class PageTable:
    """Per-slot logical page accounting: ``used[s]`` pages hold valid tokens."""

    page_size: int
    pages_per_slot: int
    n_slots: int

    def __post_init__(self):
        self.used = np.zeros((self.n_slots,), np.int32)

    def pages_for(self, n_tokens: int) -> int:
        return min(-(-n_tokens // self.page_size), self.pages_per_slot)

    def map(self, slot: int, n_tokens: int) -> int:
        self.used[slot] = self.pages_for(n_tokens)
        return int(self.used[slot])

    def extend(self, slot: int, pos: int) -> None:
        """Decode grew the sequence to ``pos`` — map pages lazily."""
        self.used[slot] = max(self.used[slot], self.pages_for(pos + 1))

    def free(self, slot: int) -> None:
        self.used[slot] = 0

    @property
    def occupancy(self) -> float:
        """Logical pages in use over the dense reservation."""
        total = self.n_slots * self.pages_per_slot
        return float(self.used.sum()) / total if total else 0.0


class PagePool:
    """Shared physical page frames + the per-slot logical→physical table.

    ``table[s, p]`` is the physical page backing slot ``s``'s logical page
    ``p`` (``-1`` = unmapped).  Allocation pops a free stack; retirement and
    swap-out push a slot's pages back.  ``pages_allocated`` /
    ``pages_reclaimed`` / ``pages_swapped_out`` / ``pages_swapped_in`` are
    lifetime counters; ``pages_in_use`` describes the pool right now.

    With ``n_shards > 1`` the page ids split into ``n_shards`` contiguous
    blocks, each with its own free stack, and allocation round-robins the
    blocks (the cursor ``_rr``) so a growing sequence's pages stripe
    across them: block ``s`` is the pages shard ``s`` owns under the
    pool-sharded lowering (:mod:`repro_torch.fabric.sharded`), so a decode
    step's live frames spread over the shards.  ``n_shards=1`` is one
    stack, low ids first."""

    def __init__(self, page_size: int, n_pages: int, pages_per_slot: int,
                 n_slots: int, n_shards: int = 1):
        if page_size < 1 or n_pages < 1:
            raise ValueError(f"bad pool geometry page_size={page_size} "
                             f"n_pages={n_pages}")
        if n_shards < 1 or n_pages % n_shards:
            raise ValueError(
                f"pool of {n_pages} pages cannot split into {n_shards} "
                f"equal shard blocks")
        self.page_size = page_size
        self.n_pages = n_pages
        self.pages_per_slot = pages_per_slot
        self.n_slots = n_slots
        self.n_shards = n_shards
        self.table = np.full((n_slots, pages_per_slot), -1, np.int32)
        sz = n_pages // n_shards
        self._free_by_shard: List[List[int]] = [
            list(range((s + 1) * sz - 1, s * sz - 1, -1))
            for s in range(n_shards)]
        self._rr = 0
        self.pages_allocated = 0
        self.pages_reclaimed = 0
        self.pages_swapped_out = 0
        self.pages_swapped_in = 0

    def shard_of(self, page: int) -> int:
        """The shard block owning physical page ``page``."""
        return page // (self.n_pages // self.n_shards)

    @property
    def free_pages(self) -> int:
        return sum(len(s) for s in self._free_by_shard)

    @property
    def free_pages_by_shard(self) -> Tuple[int, ...]:
        """Free pages per shard block."""
        return tuple(len(s) for s in self._free_by_shard)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - self.free_pages

    @property
    def occupancy(self) -> float:
        return self.pages_in_use / self.n_pages

    def mapped(self, slot: int) -> int:
        return int((self.table[slot] >= 0).sum())

    def ensure(self, slot: int, n_logical: int) -> List[Tuple[int, int]]:
        """Map logical pages ``[0, n_logical)`` of ``slot``; returns the
        newly mapped ``(logical, physical)`` pairs.  Raises on exhaustion."""
        n_logical = min(n_logical, self.pages_per_slot)
        new = []
        for p in range(n_logical):
            if self.table[slot, p] < 0:
                phys = self._alloc_one()
                if phys < 0:
                    raise RuntimeError(
                        f"page pool exhausted: slot {slot} needs logical page "
                        f"{p} but all {self.n_pages} physical pages are "
                        f"mapped — size the pool for the live footprint or "
                        f"admit fewer sequences")
                self.table[slot, p] = phys
                self.pages_allocated += 1
                new.append((p, phys))
        return new

    def _alloc_one(self) -> int:
        """Pop one page, round-robin over the shard blocks (skipping empty
        ones); -1 when the whole pool is exhausted."""
        for _ in range(self.n_shards):
            stack = self._free_by_shard[self._rr]
            self._rr = (self._rr + 1) % self.n_shards
            if stack:
                return stack.pop()
        return -1

    def release(self, slot: int) -> int:
        """Return every page mapped by ``slot`` to its shard's free stack
        (reversed table order, so the earliest-allocated page tops its
        stack again)."""
        phys = self.table[slot][self.table[slot] >= 0]
        sz = self.n_pages // self.n_shards
        for p in phys[::-1]:
            self._free_by_shard[int(p) // sz].append(int(p))
        self.table[slot] = -1
        self.pages_reclaimed += len(phys)
        return len(phys)

    def swap_out(self, slot: int) -> int:
        """Victim eviction: return the slot's pages to the free stacks after
        its frames were staged to the host swap space (through
        :meth:`release`, so the conservation counters stay balanced)."""
        n = self.release(slot)
        self.pages_swapped_out += n
        return n

    def swap_in(self, slot: int, n_pages: int) -> List[Tuple[int, int]]:
        """Re-map an evicted slot's ``n_pages`` logical pages wherever the
        allocator finds them (the restore scatters to the new rows)."""
        new = self.ensure(slot, n_pages)
        self.pages_swapped_in += len(new)
        return new

    def check(self) -> None:
        """Free-list conservation: every physical page is exactly once in
        the free stacks or the table, the lifetime counters balance, and
        each shard block's stack holds only its own pages, its mapped and
        free pages making up exactly its id range."""
        mapped = self.table[self.table >= 0].tolist()
        if len(mapped) != len(set(mapped)):
            raise ValueError(f"double-mapped physical pages: {sorted(mapped)}")
        free = [p for stack in self._free_by_shard for p in stack]
        if sorted(mapped + free) != list(range(self.n_pages)):
            raise ValueError(
                f"page leak: mapped={sorted(mapped)} free={sorted(free)}"
                f" != range({self.n_pages})")
        sz = self.n_pages // self.n_shards
        for s, stack in enumerate(self._free_by_shard):
            foreign = [p for p in stack if p // sz != s]
            if foreign:
                raise ValueError(
                    f"shard {s} free stack holds foreign pages {foreign}")
            block_mapped = [p for p in mapped if p // sz == s]
            if sorted(block_mapped + stack) != list(range(s * sz,
                                                          (s + 1) * sz)):
                raise ValueError(
                    f"shard {s} conservation broken: mapped="
                    f"{sorted(block_mapped)} free={sorted(stack)}")
        if self.pages_allocated - self.pages_reclaimed != len(mapped):
            raise ValueError(
                f"counter drift: allocated={self.pages_allocated} "
                f"reclaimed={self.pages_reclaimed} in_use={len(mapped)}")


@dataclasses.dataclass
class SwapRecord:
    """Host swap-space image of an evicted slot.

    ``frames`` holds each paged leaf's mapped frames as line-major CPU
    tensors (``[reps * span, Hkv, D]``, the exact bytes the read burst
    staged out); ``unpaged`` holds the slot's slices of the leaves the pool
    does not back (ring windows, recurrent and SSM state), keyed as the
    reference keys them
    (``"['unit'][0]['k']"``).  ``mapped`` is the physical page count to
    re-map on swap-in; ``used_pages`` / ``dirty`` restore the logical page
    table and the dense-splice counterfactual."""

    mapped: int
    used_pages: int
    dirty: int
    frames: Dict[Tuple[str, int, str], torch.Tensor]
    unpaged: Dict[str, torch.Tensor]


class PagedKVCache:
    """The batched decode-cache tree with paged admission and (optionally)
    shared-pool physical storage.

    ``caches`` is what ``api.init_cache(...)`` built: ``{"unit": [{"k",
    "v"}...], "tail": [...]}``.  With ``pool_pages > 0`` the
    ``paged_entries`` are pool leaves ``[reps, n_pages, page_size, Hkv,
    D]``; every other leaf (all of them in dense mode) is per slot, ``[reps,
    max_slots, ...]`` (``[max_slots, ...]`` in the tail): a K/V or ring
    leaf ``[..., T, Hkv, D]``, a conv window ``[..., K-1, C]``, an RG-LRU
    ``h`` ``[..., W]``, an SSM ``state`` ``[..., H, P, N]``.  The wrapper
    keeps that structure; admission writes into it in place.
    ``pool_shards`` splits the pool's pages into that many shard blocks
    (:class:`PagePool` ``n_shards``)."""

    def __init__(self, caches, max_slots: int, t_max: int, page_size: int,
                 pool_pages: int = 0, paged_entries=(), fabric=None,
                 fused_gather: bool = False, pool_shards: int = 1):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.fused_gather = fused_gather
        self.caches = caches
        self.max_slots = max_slots
        self.t_max = t_max
        self.table = PageTable(page_size=page_size,
                               pages_per_slot=-(-t_max // page_size),
                               n_slots=max_slots)
        self.pool = (PagePool(page_size, pool_pages,
                              self.table.pages_per_slot, max_slots,
                              n_shards=pool_shards)
                     if pool_pages else None)
        self.paged_entries = tuple(paged_entries)
        self.fabric = fabric
        self.tokens_moved = 0
        self.tokens_moved_dense = 0
        self.prefill_bursts = 0
        self.prefill_splices = 0
        self._dirty = np.full((max_slots,), -1, np.int64)
        # serving-path fault seam: when set, swap transfers consult it for
        # injected in-flight corruption (caught by the parity word)
        self.fault_injector = None

    # -- geometry / accounting -------------------------------------------------
    @property
    def paged(self) -> bool:
        """True when KV storage is the shared physical page pool."""
        return self.pool is not None

    @property
    def occupancy(self) -> float:
        """Fraction of physical frames in use (pool) / logical pages used
        against the dense reservation (dense mode)."""
        return self.pool.occupancy if self.pool else self.table.occupancy

    @property
    def dense_reserved_pages(self) -> int:
        """Pages the dense layout reserves regardless of occupancy."""
        return self.max_slots * self.table.pages_per_slot

    def page_table_device(self, device) -> torch.Tensor:
        """The logical→physical table as a device operand
        (``int32 [max_slots, pages_per_slot]``)."""
        if self.pool is None:
            raise ValueError("dense mode has no physical page table")
        return torch.from_numpy(self.pool.table.copy()).to(device)

    def _count_refill(self, slot: int, span: int) -> None:
        """Admission accounting: timesteps installed, against what a dense
        per-slot splice would copy (``t_max`` on a slot's first fill, the
        prompt or the prior occupant's dirty extent on reuse)."""
        self.tokens_moved += span
        prior = int(self._dirty[slot])
        self.tokens_moved_dense += self.t_max if prior < 0 else max(span, prior)
        self._dirty[slot] = span

    # -- admission -------------------------------------------------------------
    def refill(self, slot: int, req_cache, n_tokens: int) -> None:
        """Install a single request by splice; see :meth:`admit_wave`."""
        self.admit_wave([(slot, req_cache, n_tokens)], burst=False)

    def admit_wave(self, entries: Sequence[Tuple[int, object, int]],
                   stats: Optional[SchedulerStats] = None,
                   burst: Optional[bool] = None) -> None:
        """Install a wave of admitted prompts, ``[(slot, req_cache,
        n_tokens), ...]``.  Pool mode: one write-burst flush for the wave;
        slots off the network geometry, and every slot with
        ``burst=False`` or on a fabric that does not bank, splice per leaf.
        Dense mode always splices."""
        plans = []
        for slot, req_cache, n_tokens in entries:
            inst_pages = self.table.pages_for(n_tokens)
            span = min(inst_pages * self.table.page_size, self.t_max)
            self._count_refill(slot, span)
            self.table.map(slot, n_tokens)
            if self.pool is not None:
                self.pool.ensure(slot, self.table.pages_for(n_tokens + 1))
            plans.append((slot, req_cache, span))
        if self.pool is None:
            for slot, req_cache, span in plans:
                self._dense_splice(slot, req_cache, span)
            return
        self._pool_install(plans, stats=stats, burst=burst)
        for slot, req_cache, _ in plans:
            self._splice_unpaged(slot, req_cache)

    # -- decode-time bookkeeping ----------------------------------------------
    def update(self, new_caches) -> None:
        """Adopt the cache tree returned by the decode step."""
        self.caches = new_caches

    def extend(self, slot: int, pos: int) -> None:
        self.table.extend(slot, pos)
        self._dirty[slot] = max(int(self._dirty[slot]), pos)
        if self.pool is not None:
            self.pool.ensure(slot, self.table.pages_for(pos + 1))

    def free(self, slot: int) -> None:
        """Retire the slot: in pool mode its physical pages return to the
        free list."""
        self.table.free(slot)
        if self.pool is not None:
            self.pool.release(slot)

    # -- swap (graceful degradation under oversubscription) --------------------
    def swap_out(self, slot: int,
                 stats: Optional[SchedulerStats] = None) -> SwapRecord:
        """Evict ``slot`` to the host swap space: stage every mapped frame
        out over the read burst's page-table gather — one
        ``swap/<slot>/<leaf>`` sparse-extent stream per paged leaf, one
        flush for the slot (on the card one gather-kernel launch per
        stream) — copy them to host memory, then free the physical pages.
        The transfer is parity-checked end to end and retried once on a
        mismatch.  Off the network geometry (:meth:`_fused_eligible` false)
        the frames are staged by a plain gather instead, as the
        reference's."""
        if self.pool is None:
            raise ValueError("swap requires the shared page pool")
        record = SwapRecord(mapped=self.pool.mapped(slot),
                            used_pages=int(self.table.used[slot]),
                            dirty=int(self._dirty[slot]),
                            frames={}, unpaged=self._extract_unpaged(slot))
        if record.mapped:
            pf = self._phys_frames(slot, record.mapped * self.table.page_size)
            if self._fused_eligible():
                record.frames = self._swap_gather(slot, pf, stats)
            else:
                record.frames = {
                    (kind, i, name): _take_rows(
                        self._pool_lines(kind, i, name),
                        self._rep_idx(kind, i, pf)).cpu()
                    for kind, i in self.paged_entries
                    for name in ("k", "v")}
        self.table.free(slot)
        self.pool.swap_out(slot)
        return record

    def swap_in(self, slot: int, record: SwapRecord,
                stats: Optional[SchedulerStats] = None) -> None:
        """Re-admit an evicted slot: re-map physical pages from the free
        stacks and restore the host image — the write burst's scatter lands
        every frame at its new physical row, in place (one flush per slot;
        on the card one scatter-kernel launch per stream).  Off the network
        geometry the frames are copied into the mapped pages directly."""
        if self.pool is None:
            raise ValueError("swap requires the shared page pool")
        self.pool.swap_in(slot, record.mapped)
        self.table.used[slot] = record.used_pages
        self._dirty[slot] = record.dirty
        if record.mapped:
            span = record.mapped * self.table.page_size
            pf = self._phys_frames(slot, span)
            if self._fused_eligible():
                self._swap_scatter(slot, pf, record.frames, stats)
            else:
                for (kind, i, name), lines in record.frames.items():
                    pool_leaf = self.caches[kind][i][name]
                    lead = tuple(pool_leaf.shape[:-4])
                    frames = lines.to(pool_leaf.device).reshape(
                        lead + (span,) + tuple(pool_leaf.shape[-2:]))
                    _install_pool_leaf(pool_leaf, frames,
                                       self.pool.table[slot], span,
                                       self.table.page_size)
        self._restore_unpaged(slot, record.unpaged)

    def _phys_frames(self, slot: int, span: int) -> np.ndarray:
        """Physical frame rows backing the slot's first ``span`` timesteps
        (the page-table indirection, on the host)."""
        ps = self.table.page_size
        row = self.pool.table[slot]
        t = np.arange(span)
        return (row[t // ps].astype(np.int64) * ps + t % ps).astype(np.int32)

    def _rep_idx(self, kind: str, i: int, pf: np.ndarray) -> np.ndarray:
        """Physical frame rows ``pf`` tiled over a leaf's leading layer axis
        — the rows of one slot's frames in the leaf's flattened lines."""
        pool_leaf = self.caches[kind][i]["k"]
        frames_n = pool_leaf.shape[-4] * pool_leaf.shape[-3]
        reps = int(np.prod(pool_leaf.shape[:-4])) if pool_leaf.ndim > 4 else 1
        return (np.arange(reps, dtype=np.int64)[:, None] * frames_n
                + pf[None, :]).reshape(-1).astype(np.int32)

    def _pool_lines(self, kind: str, i: int, name: str) -> torch.Tensor:
        """A pool leaf's flattened line stream ``[lead*F, Hkv, D]``, a view
        of the leaf (a scatter into it lands in the pool)."""
        return _flat_frames_lines(self.caches[kind][i][name])

    def _swap_gather(self, slot: int, pf: np.ndarray, stats) -> Dict:
        """Swap-out data path: every paged leaf's mapped frames as one
        gather-indexed read stream (sentinel-padded to a multiple of N), in
        ``paged_entries`` x (k, v) order; the frames land in host memory.
        The sender's parity word is taken over a plain gather of the same
        rows on their device, the receiver's over the host copies."""
        n = self.fabric.n_ports
        streams = {(kind, i, name): (self._rep_idx(kind, i, pf),
                                     self._pool_lines(kind, i, name))
                   for kind, i in self.paged_entries for name in ("k", "v")}
        expect = 0
        for idx, src in streams.values():
            expect ^= _parity_word(_take_rows(src, idx))

        def transfer():
            sched = BurstScheduler(self.fabric, stats=stats)
            for (kind, i, name), (idx, src) in streams.items():
                pad = (-idx.shape[0]) % n
                gidx = (np.concatenate(
                    [idx, np.full((pad,), _SENTINEL, np.int32)])
                    if pad else idx)
                sched.enqueue_read(f"swap/{slot}/{kind}{i}/{name}", src,
                                   gather=torch.from_numpy(gidx).to(
                                       src.device))
            out = sched.flush()
            got = {}
            for (kind, i, name), (idx, _) in streams.items():
                lines = _banked_to_lines(out[f"swap/{slot}/{kind}{i}/{name}"])
                got[(kind, i, name)] = lines[: idx.shape[0]].contiguous().cpu()
            return got, got

        got = self._checked_transfer(transfer, expect, stats)
        if stats is not None:
            stats.swap_bursts += 1
            stats.swap_out_words += sum(v.numel() for v in got.values())
        return got

    def _swap_scatter(self, slot: int, pf: np.ndarray, frames: Dict,
                      stats) -> None:
        """Swap-in data path: every paged leaf's saved frames as one
        scatter-indexed write stream, in ``sorted(frames)`` order, landing
        in place at the new physical rows.  The sender's parity word is
        taken over the host frames, the receiver's over the rows read back
        from the pool on its device."""
        n = self.fabric.n_ports
        expect = 0
        for lines in frames.values():
            expect ^= _parity_word(lines)

        def transfer():
            sched = BurstScheduler(self.fabric, stats=stats)
            targets = {}
            for (kind, i, name), lines in sorted(frames.items()):
                idx = self._rep_idx(kind, i, pf)
                into = self._pool_lines(kind, i, name)
                ln = lines.to(into.device)
                pad = (-idx.shape[0]) % n
                sidx = idx
                if pad:
                    ln = torch.cat([ln, ln.new_zeros(
                        (pad,) + tuple(ln.shape[1:]))], dim=0)
                    sidx = np.concatenate(
                        [idx, np.full((pad,), _SENTINEL, np.int32)])
                tag = f"swap/{slot}/{kind}{i}/{name}"
                sched.enqueue_write(tag, _lines_to_banked(ln, n),
                                    scatter=torch.from_numpy(sidx).to(
                                        into.device),
                                    into=into)
                targets[tag] = (into, idx)
            # the scatter lands in place: the pool leaves are updated
            sched.flush()
            received = {tag: _take_rows(into, idx)
                        for tag, (into, idx) in targets.items()}
            return None, received

        self._checked_transfer(transfer, expect, stats)
        if stats is not None:
            stats.swap_bursts += 1
            stats.swap_in_words += sum(v.numel() for v in frames.values())

    def _checked_transfer(self, transfer, expect: int, stats):
        """Run a swap transfer under the end-to-end parity word: the XOR of
        every byte the receiver holds must match the sender's.  The bursts
        are exact, so only injected corruption trips it; a mismatch
        discards the received copy and retries once (the injector's
        ordinal does not advance on the retry)."""
        inj = self.fault_injector
        for attempt in (0, 1):
            payload, received = transfer()
            if inj is not None and inj.corrupt_swap_burst(attempt):
                key = sorted(received)[0]
                bad = received[key].clone()
                bad.reshape(-1).view(torch.uint8)[0] ^= 0xFF
                received[key] = bad
            parity = 0
            for v in received.values():
                parity ^= _parity_word(v)
            if parity == expect:
                return payload
            if stats is not None:
                stats.bursts_retried += 1
        raise RuntimeError(
            "swap transfer failed the parity check twice — giving up")

    def _unpaged_leaves(self):
        """``(key, leaf, slot axis)`` of every leaf the pool does not back,
        keyed as the reference's ``keystr`` of its tree path.  The slot
        axis is the leaf's known one (1 under ``unit``, 0 in ``tail``; see
        :meth:`_splice_rows`)."""
        paged = set(self.paged_entries)
        for kind in ("unit", "tail"):
            axis = 1 if kind == "unit" else 0
            for i, entry in enumerate(self.caches[kind]):
                for name, leaf in entry.items():
                    if (kind, i) in paged and name in ("k", "v"):
                        continue
                    yield f"['{kind}'][{i}]['{name}']", leaf, axis

    def _extract_unpaged(self, slot: int) -> Dict[str, torch.Tensor]:
        """CPU copies of the slot's slices of the leaves the pool does not
        back (ring windows, recurrent and SSM state) — the control-traffic
        half of the swap image."""
        return {key: leaf.narrow(axis, slot, 1).to("cpu", copy=True)
                for key, leaf, axis in self._unpaged_leaves()}

    def _restore_unpaged(self, slot: int,
                         saved: Dict[str, torch.Tensor]) -> None:
        """Copy the saved slices back into the slot's rows, in place."""
        for key, leaf, axis in self._unpaged_leaves():
            if key in saved:
                leaf.narrow(axis, slot, 1).copy_(saved[key])

    # -- install paths ---------------------------------------------------------
    def _splice_unpaged(self, slot: int, req_cache) -> None:
        """Copy a request's non-paged leaves (its ring windows and
        recurrent or SSM state, batch 1) into row ``slot`` of the engine's
        per-slot leaves, in place."""
        self._splice_rows(slot, req_cache, skip=set(self.paged_entries))

    def _dense_splice(self, slot: int, req_cache, span: int) -> None:
        """Dense-mode install: copy the request's leaves into row ``slot``
        of the per-slot leaves, in place; a K/V leaf with the full
        ``t_max`` time axis takes only the first ``span`` timesteps (the
        row's rest is masked until decode writes it), as the reference's
        does."""
        self._splice_rows(slot, req_cache, span=span)

    def _splice_rows(self, slot: int, req_cache, skip=(),
                     span: Optional[int] = None) -> None:
        """Copy ``req_cache``'s leaves (batch 1) into row ``slot`` of every
        entry not in ``skip``, in place.  The slot axis is the leaf's known
        one — 1 under the ``unit`` stack, 0 in the ``tail`` — not guessed
        from the shape (the reference takes axis 1 only when ``ndim >= 4
        and shape[1] == max_slots``, which misplaces a tail leaf whose time
        axis equals ``max_slots`` and every unit-stacked RG-LRU ``h``
        ``[reps, B, W]``, which has three dims).  With ``span``, K/V leaves
        whose time axis is ``t_max`` copy their first ``span`` timesteps
        only."""
        for kind in ("unit", "tail"):
            axis = 1 if kind == "unit" else 0
            for i, entry in enumerate(self.caches[kind]):
                if (kind, i) in skip:
                    continue
                for name, leaf in entry.items():
                    dst = leaf.narrow(axis, slot, 1)
                    src = req_cache[kind][i][name]
                    if (span is not None and name in ("k", "v")
                            and leaf.shape[axis + 1] == self.t_max):
                        dst = dst.narrow(axis + 1, 0, span)
                        src = src.narrow(axis + 1, 0, span)
                    dst.copy_(src)

    def _req_frames(self, req_cache, kind: str, i: int, name: str,
                    span: int) -> torch.Tensor:
        """A request's first ``span`` timesteps of one paged leaf, as
        line-major frames ``[lead..., span, Hkv, D]``."""
        leaf = req_cache[kind][i][name]        # [lead..., 1, t_alloc, Hkv, D]
        return leaf[..., 0, :span, :, :]

    def _burst_eligible(self, req_cache, span: int) -> bool:
        """Whether a slot's page extents fit the write network: a bankable
        fabric on the port-per-KV-head geometry, and every paged leaf's line
        count a multiple of N."""
        if self.fabric is None or not self.fabric.banks_kv:
            return False
        n = self.fabric.n_ports
        for kind, i in self.paged_entries:
            leaf = req_cache[kind][i]["k"]
            lead = int(np.prod(leaf.shape[:-4])) if leaf.ndim > 4 else 1
            if leaf.shape[-2] != n or (lead * span) % n:
                return False
        return True

    def _fused_eligible(self) -> bool:
        """Whether the fused-gather install can carry this pool's admission
        (a bankable fabric on the port-per-KV-head geometry)."""
        if self.fabric is None or not self.fabric.banks_kv:
            return False
        n = self.fabric.n_ports
        return all(self.caches[kind][i]["k"].shape[-2] == n
                   for kind, i in self.paged_entries)

    def _pool_install_fused(self, plans, stats=None) -> None:
        """Fused-contract install: each paged leaf takes the whole wave as
        ONE sparse-extent write stream — the write network reassembles every
        admitted prompt's frames and the scatter lands each at its physical
        page row, in place in the pool leaf.  One flush per wave."""
        n = self.fabric.n_ports
        ps = self.table.page_size
        staged: Dict[Tuple[str, int, str], Tuple[list, list]] = {}
        for slot, req_cache, span in plans:
            if span == 0:
                continue
            row = self.pool.table[slot]
            t = np.arange(span)
            pf = (row[t // ps].astype(np.int64) * ps + t % ps).astype(np.int32)
            for kind, i in self.paged_entries:
                pool_leaf = self.caches[kind][i]["k"]
                frames_n = pool_leaf.shape[-4] * pool_leaf.shape[-3]
                reps = int(np.prod(pool_leaf.shape[:-4])) \
                    if pool_leaf.ndim > 4 else 1
                idx = (np.arange(reps, dtype=np.int64)[:, None] * frames_n
                       + pf[None, :]).reshape(-1).astype(np.int32)
                for name in ("k", "v"):
                    fr = self._req_frames(req_cache, kind, i, name, span)
                    lines = fr.reshape(-1, n, fr.shape[-1])
                    lns, idxs = staged.setdefault((kind, i, name), ([], []))
                    lns.append(lines)
                    idxs.append(idx)
        if staged:
            sched = BurstScheduler(self.fabric, stats=stats)
            for (kind, i, name), (lns, idxs) in staged.items():
                lines = lns[0] if len(lns) == 1 else torch.cat(lns, dim=0)
                idx = np.concatenate(idxs)
                pad = (-lines.shape[0]) % n
                if pad:
                    lines = torch.cat([lines, lines.new_zeros(
                        (pad,) + tuple(lines.shape[1:]))], dim=0)
                    idx = np.concatenate(
                        [idx, np.full((pad,), _SENTINEL, np.int32)])
                pool_leaf = self.caches[kind][i][name]
                sched.enqueue_write(
                    f"prefill/{kind}{i}/{name}",
                    _lines_to_banked(lines, n),
                    scatter=torch.from_numpy(idx).to(pool_leaf.device),
                    into=_flat_frames_lines(pool_leaf))
            # the scatter lands in place: the pool leaves are already updated
            sched.flush()
            self.prefill_bursts += 1
            if stats is not None:
                stats.prefill_bursts += 1

    def _pool_install(self, plans, stats=None, burst=None) -> None:
        """Install a wave into the shared pool: the fused contract's sparse
        write (:meth:`_pool_install_fused`), or the burst-eligible slots'
        extents through one dense write-network flush, copied into the
        mapped pages, and the other slots' frames spliced per leaf (the
        same bytes, without the network)."""
        if self.fused_gather and burst is not False and self._fused_eligible():
            self._pool_install_fused(plans, stats=stats)
            return
        # burst=False forces the splice; True/None burst wherever the slot's
        # extents fit the network geometry
        use_burst = {slot: burst is not False
                     and self._burst_eligible(rc, span)
                     for slot, rc, span in plans}
        staged = []
        sched = None
        for slot, req_cache, span in plans:
            if not use_burst[slot] or span == 0:
                continue
            if sched is None:
                sched = BurstScheduler(self.fabric, stats=stats)
            n = self.fabric.n_ports
            for kind, i in self.paged_entries:
                for name in ("k", "v"):
                    frames = self._req_frames(req_cache, kind, i, name, span)
                    lines = frames.reshape(-1, n, frames.shape[-1])
                    tag = f"prefill/{slot}/{kind}{i}/{name}"
                    sched.enqueue_write(tag, _lines_to_banked(lines, n))
                    staged.append((tag, frames.shape))
        moved = {}
        if sched is not None:
            out = sched.flush()
            moved = {tag: out[tag].reshape(shape) for tag, shape in staged}
            self.prefill_bursts += 1
            if stats is not None:
                stats.prefill_bursts += 1
        for slot, req_cache, span in plans:
            if span == 0:
                continue
            if not use_burst[slot]:
                self.prefill_splices += 1
            for kind, i in self.paged_entries:
                for name in ("k", "v"):
                    tag = f"prefill/{slot}/{kind}{i}/{name}"
                    frames = (moved[tag] if tag in moved else
                              self._req_frames(req_cache, kind, i, name,
                                               span))
                    _install_pool_leaf(self.caches[kind][i][name], frames,
                                       self.pool.table[slot], span,
                                       self.table.page_size)


def _lines_to_banked(lines: torch.Tensor, n: int) -> torch.Tensor:
    """Line-major frames ``[L, N, D]`` → the banked ``[G, N, N, D]`` buffer
    whose write-network image is exactly ``lines``."""
    return pm_to_banked(lines.transpose(0, 1), n)


def _banked_to_lines(banked: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_lines_to_banked`: the banked ``[G, N, N, D]``
    image a gather read returns, back as line-major frames ``[G*N, N, D]``
    in request order (sentinel pad rows at the tail)."""
    g, n, _, d = banked.shape
    pm = banked.transpose(0, 1).reshape(n, g * n, d)
    return pm.transpose(0, 1)


def _take_rows(lines: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """Rows ``idx`` (host ints, all in range) of ``lines``."""
    return lines.index_select(0, torch.from_numpy(idx).to(
        lines.device).long())


def _parity_word(t: torch.Tensor) -> int:
    """XOR of every byte of ``t`` — the end-to-end checksum on swap
    transfers (the reference's ``_parity_word``).  The bytes are folded as
    the widest machine words that divide their count and the word's bytes
    are folded last, which gives the same value; a CPU tensor folds in
    numpy, a CUDA tensor on its device (one integer comes back)."""
    b = t.contiguous().reshape(-1).view(torch.uint8)
    if b.numel() == 0:
        return 0
    width = next(w for w in (8, 4, 2, 1) if b.numel() % w == 0)
    words = b.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                    1: torch.uint8}[width])
    if words.device.type == "cpu":
        word = int(np.bitwise_xor.reduce(words.numpy(), axis=None))
    else:
        while words.numel() > 1:
            if words.numel() % 2:
                words = torch.cat([words, words.new_zeros(1)])
            half = words.numel() // 2
            words = torch.bitwise_xor(words[:half], words[half:])
        word = int(words.item())
    word &= (1 << (8 * width)) - 1
    out = 0
    for k in range(width):
        out ^= (word >> (8 * k)) & 0xFF
    return out


def _flat_frames_lines(pool_leaf: torch.Tensor) -> torch.Tensor:
    """Pool leaf ``[lead..., n_pages, page_size, Hkv, D]`` → its flattened
    line stream ``[lead*F, Hkv, D]``, a view of the leaf (the sparse
    scatter's target; the same line order the decode step addresses)."""
    return pool_leaf.reshape((-1,) + tuple(pool_leaf.shape[-2:]))


def _install_pool_leaf(pool_leaf: torch.Tensor, frames: torch.Tensor,
                       table_row: np.ndarray, span: int,
                       page_size: int) -> None:
    """Copy a prompt's ``span`` line-major frames into the physical pages
    ``table_row`` maps, in place (full pages, then the partial tail page)."""
    page_axis = pool_leaf.ndim - 4
    n_full, tail = divmod(span, page_size)
    n_pages_used = n_full + (1 if tail else 0)
    phys = [int(table_row[p]) for p in range(n_pages_used)]
    lead = tuple(frames.shape[:-3])
    if n_full:
        data = frames[..., : n_full * page_size, :, :].reshape(
            lead + (n_full, page_size) + tuple(frames.shape[-2:]))
        pool_leaf.index_copy_(page_axis, torch.tensor(
            phys[:n_full], device=pool_leaf.device), data)
    if tail:
        pool_leaf.select(page_axis, phys[-1]).narrow(
            page_axis, 0, tail).copy_(frames[..., n_full * page_size:, :, :])
