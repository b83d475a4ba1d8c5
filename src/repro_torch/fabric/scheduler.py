"""Burst scheduler: many logical streams, one network invocation per step
(port of ``repro.fabric.scheduler``).

Consumers queue read/write streams on a shared :class:`Fabric`; each
:meth:`BurstScheduler.issue` merges the queued streams into one burst per
direction and dtype, runs the network once per burst, and hands each
consumer its slice back at :meth:`BurstScheduler.commit`.

* **Packing** (``pack="packed"``): a stream of ``k*N`` lines of ``W``
  words is the same traffic as ``N`` lines of ``k*W`` words, so streams of
  one dtype concatenate along the word axis into one ``[N, N, W_total]``
  burst.  ``pack="pad"`` keeps the reference's pad-to-widest layout:
  streams concatenate along the line axis after zero-padding narrower
  words to the widest (``words_padded`` counts the fill).
* **Machine-word folding** (``word_fold``): adjacent narrow words fold into
  one wider machine word before the network runs (bf16 pairs ride 32-bit
  lanes).  The policy mirrors the reference's default exactly: there is no
  8-byte machine word (the reference has one only under ``jax_enable_x64``,
  which is off), so a bf16 frame folds 2-wide, never 4-wide, and
  ``words_folded`` and the kernels' word width match the reference's.
  Words are viewed as signed integers of the same width; the bits are
  what matter.  The pad layout folds its padded word axis, and at a fold
  of 1 keeps the payload dtype, as the reference's does.
* **Sparse-extent streams**: ``enqueue_read(..., gather=idx)`` banks only
  the frames ``idx`` names (sentinels read zero frames);
  ``enqueue_write(..., scatter=idx, into=pool)`` lands frames at their
  pool rows, in place (sentinels drop).  On the kernelized fabric each
  sparse stream is one fused gather or scatter kernel launch.
* **Sharded streams**: ``shard=(fetch, place, k_tot)`` (a
  :func:`repro_torch.fabric.sharded.shard_plan`'s operands) is the
  sparse extent over the pool-sharded stream ``[R, F, N, *rest]``: each
  such stream is its own two-hop collective burst (one fused gather or
  scatter per shard, then one exchange; :mod:`repro_torch.fabric.sharded`).

``issue()``/``commit()`` stay synchronous on the current stream: the
network runs at ``issue()``, and the one-deep ordering errors of the
reference hold.  :class:`SchedulerStats` counts per executed burst.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import PortSpec
from repro_torch.fabric.fabric import Fabric, _put_drop, _take_fill

@dataclasses.dataclass
class SchedulerStats:
    """Traffic accounting for a :class:`BurstScheduler` (the reference's
    fields, so two runs compare field for field).

    ``flushes`` counts issue/commit cycles, ``network_calls`` network
    invocations (one per direction and dtype present, one per fused sparse
    launch), ``words_moved``/``words_folded`` word-axis elements carried
    and folded into wider machine words, ``kernel_bursts`` bursts that
    lowered through a fused kernel, ``words_live``/``gather_fused_bursts``
    the sparse-extent traffic, ``prefill_bursts`` admission waves
    installed through one write burst, and ``words_padded`` the zero fill
    of the ``pack="pad"`` layout.  The engine adds its preemption, swap,
    fault-recovery and admission-control counters (``preemptions`` ...
    ``aging_promotions``).  ``tokens_dropped`` counts the token→expert
    assignments the MoE dispatch dropped at capacity (their scatter
    indices became sentinels), per executed dispatch
    (:func:`repro_torch.models.moe.dispatch_stats`);
    ``collective_calls`` counts the sharded pool's exchanges (one per
    sharded stream) and ``words_cross_shard`` the words they carry between
    shards (whole padded buckets, off the diagonal)."""
    streams_served: int = 0
    flushes: int = 0
    network_calls: int = 0
    words_moved: int = 0
    words_padded: int = 0
    words_folded: int = 0
    words_live: int = 0
    words_cross_shard: int = 0
    kernel_bursts: int = 0
    gather_fused_bursts: int = 0
    prefill_bursts: int = 0
    collective_calls: int = 0
    preemptions: int = 0
    swap_bursts: int = 0
    swap_out_words: int = 0
    swap_in_words: int = 0
    bursts_retried: int = 0
    faults_recovered: int = 0
    requests_shed: int = 0
    shed_queue_full: int = 0
    shed_deadline: int = 0
    slo_missed_served: int = 0
    slo_missed_shed: int = 0
    aging_promotions: int = 0
    tokens_dropped: int = 0

    @property
    def calls_saved(self) -> int:
        """Network calls the multiplexing saved: streams served minus
        network calls made."""
        return self.streams_served - self.network_calls


@dataclasses.dataclass
class _Queued:
    spec: PortSpec
    payload: torch.Tensor         # lines [L, N, *rest] or banked [G, N, N, *rest]
    rest_shape: Tuple[int, ...]
    width: int                    # prod(rest) — payload elements per word
    groups: int                   # line groups (L // N, resp. G)
    gather: Optional[torch.Tensor] = None
    scatter: Optional[torch.Tensor] = None
    into: Optional[torch.Tensor] = None
    # pool-sharded sparse extent: ``(fetch, place, k_tot)`` (reads: payload
    # is the pool stream [R, F, N, *rest]; writes: payload is banked and
    # ``into`` is that stream)
    shard: Optional[Tuple] = None

    @property
    def sparse(self) -> bool:
        return (self.gather is not None or self.scatter is not None
                or self.shard is not None)


class BurstScheduler:
    """Batch queued read/write streams through one network call per burst.

    ``pack`` defaults to the fabric's :attr:`FabricConfig.pack` and
    ``word_fold`` to its :attr:`FabricConfig.word_fold`; pass an external
    :class:`SchedulerStats` to accumulate accounting across instances."""

    def __init__(self, fabric: Fabric, pack: Optional[str] = None,
                 word_fold=None, stats: Optional[SchedulerStats] = None):
        self.fabric = fabric
        self.pack = pack or fabric.config.pack
        if self.pack not in ("packed", "pad"):
            raise ValueError(f"unknown burst packing {self.pack!r}")
        self.word_fold = (fabric.config.word_fold if word_fold is None
                          else word_fold)
        if self.word_fold not in ("auto", 1, 2, 4):
            raise ValueError(f"word_fold must be 'auto', 1, 2 or 4, "
                             f"got {self.word_fold!r}")
        self.stats = stats if stats is not None else SchedulerStats()
        self._reads: List[_Queued] = []
        self._writes: List[_Queued] = []
        self._inflight: Optional[Dict[str, torch.Tensor]] = None

    # -- enqueue ---------------------------------------------------------------
    def _check_name(self, name: str) -> None:
        if any(q.spec.name == name for q in self._reads + self._writes):
            raise ValueError(
                f"stream {name!r} already queued for this burst; give each "
                f"logical port a distinct name (e.g. 'kv_read'/'kv_write')")

    def _extent(self, queue: List[_Queued], dtype: torch.dtype) -> int:
        """Word-axis offset of the next stream within its dtype group."""
        return sum(q.spec.words for q in queue if q.payload.dtype == dtype)

    def enqueue_read(self, name: str, lines: torch.Tensor,
                     gather: Optional[torch.Tensor] = None,
                     shard: Optional[Tuple] = None) -> PortSpec:
        """Queue a line stream ``[L, N, *rest]`` (L a multiple of N) for the
        read network.  With ``gather [K]`` (K a multiple of N; sentinels
        read zero frames) the stream is sparse-extent and its result is the
        banked ``[K//N, N, N, *rest]`` of the addressed frames.

        ``shard = (fetch, place, k_tot)`` is the pool-sharded form of
        ``gather``: ``lines`` is the rep-major pool stream ``[R, F, N,
        *rest]`` and the stream lowers as per-shard fused gathers bridged by
        one collective, to the same banked ``[k_tot//N, N, N, *rest]``."""
        n = self.fabric.n_ports
        self._check_name(name)
        if shard is not None:
            if gather is not None:
                raise ValueError(f"stream {name!r}: shard= and gather= are "
                                 f"mutually exclusive lowerings")
            if lines.ndim < 3 or lines.shape[2] != n:
                raise ValueError(
                    f"stream {name!r}: sharded read wants the rep-major pool "
                    f"stream [R, F, N, ...] for N={n}, "
                    f"got {tuple(lines.shape)}")
            fetch, _, k_tot = shard
            s = fetch.shape[0]
            if k_tot % (s * n):
                raise ValueError(
                    f"stream {name!r}: k_tot={k_tot} must split into {s} "
                    f"shard blocks of whole N={n} groups")
            rest = tuple(lines.shape[3:])
            width = _prod(rest)
            groups = k_tot // n
            spec = PortSpec(
                name=name, direction="read", words=groups * width,
                offset=self._extent(self._reads, lines.dtype),
                gathered=True,
                pool_words=lines.shape[0] * lines.shape[1] * width // n)
            self._reads.append(_Queued(spec, lines, rest, width, groups,
                                       shard=shard))
            return spec
        if lines.ndim < 2 or lines.shape[1] != n or lines.shape[0] % n:
            raise ValueError(f"stream {name!r}: want [k*N, N, ...] lines for "
                             f"N={n}, got {tuple(lines.shape)}")
        rest = tuple(lines.shape[2:])
        width = _prod(rest)
        if gather is not None:
            if gather.ndim != 1 or gather.shape[0] % n:
                raise ValueError(f"stream {name!r}: gather indices must be "
                                 f"[k*N] for N={n}, got {tuple(gather.shape)}")
            groups = gather.shape[0] // n
        else:
            groups = lines.shape[0] // n
        spec = PortSpec(
            name=name, direction="read", words=groups * width,
            offset=self._extent(self._reads, lines.dtype),
            gathered=gather is not None,
            pool_words=(lines.shape[0] // n) * width if gather is not None
            else 0)
        self._reads.append(_Queued(spec, lines, rest, width, groups,
                                   gather=gather))
        return spec

    def enqueue_write(self, name: str, banked: torch.Tensor,
                      scatter: Optional[torch.Tensor] = None,
                      into: Optional[torch.Tensor] = None,
                      shard: Optional[Tuple] = None) -> PortSpec:
        """Queue a banked buffer ``[G, N, N, *rest]`` for the write network.
        With ``scatter``/``into`` the stream is sparse-extent: each line
        lands at its indexed row of ``into [L, N, *rest]``, in place, and
        the committed result is ``into``.

        ``shard = (fetch, place, k_tot)`` is the pool-sharded form of
        ``scatter``: ``into`` is the rep-major pool stream ``[R, F, N,
        *rest]``, and each banked frame reaches its owning shard through one
        collective before the local fused scatter lands it, in place."""
        n = self.fabric.n_ports
        if banked.ndim < 3 or banked.shape[1] != n or banked.shape[2] != n:
            raise ValueError(f"stream {name!r}: want [G, N, N, ...] banked for "
                             f"N={n}, got {tuple(banked.shape)}")
        self._check_name(name)
        if shard is not None:
            if scatter is not None:
                raise ValueError(f"stream {name!r}: shard= and scatter= are "
                                 f"mutually exclusive lowerings")
            if into is None:
                raise ValueError(f"stream {name!r}: sharded write needs the "
                                 f"pool stream to land in (into=)")
            if into.ndim != banked.ndim or into.shape[2] != n \
                    or tuple(into.shape[3:]) != tuple(banked.shape[3:]):
                raise ValueError(
                    f"stream {name!r}: sharded scatter target "
                    f"{tuple(into.shape)} does not match banked frames "
                    f"{tuple(banked.shape)} (want rep-major [R, F, N, ...])")
            if not into.is_contiguous():
                raise ValueError(
                    f"stream {name!r}: the scatter lands in place, so the "
                    f"pool stream (into=) must be contiguous")
            _, _, k_tot = shard
            if k_tot != banked.shape[0] * n:
                raise ValueError(
                    f"stream {name!r}: plan k_tot={k_tot} != banked line "
                    f"count {banked.shape[0] * n}")
            rest = tuple(banked.shape[3:])
            width = _prod(rest)
            spec = PortSpec(
                name=name, direction="write", words=banked.shape[0] * width,
                offset=self._extent(self._writes, banked.dtype),
                gathered=True,
                pool_words=into.shape[0] * into.shape[1] * width // n)
            self._writes.append(_Queued(spec, banked, rest, width,
                                        banked.shape[0], into=into,
                                        shard=shard))
            return spec
        if (scatter is None) != (into is None):
            raise ValueError(
                f"stream {name!r}: sparse writes need both scatter indices "
                f"and the pool stream to land in (into=)")
        rest = tuple(banked.shape[3:])
        width = _prod(rest)
        if scatter is not None:
            if scatter.ndim != 1 or scatter.shape[0] != banked.shape[0] * n:
                raise ValueError(
                    f"stream {name!r}: scatter indices {tuple(scatter.shape)} "
                    f"must match the banked line count {banked.shape[0] * n}")
            if tuple(into.shape[1:]) != tuple(banked.shape[2:]) \
                    or into.ndim != banked.ndim - 1:
                raise ValueError(
                    f"stream {name!r}: scatter target {tuple(into.shape)} "
                    f"does not match banked lines {tuple(banked.shape)}")
            if not into.is_contiguous():
                raise ValueError(
                    f"stream {name!r}: the scatter lands in place, so the "
                    f"pool stream (into=) must be contiguous")
        spec = PortSpec(
            name=name, direction="write", words=banked.shape[0] * width,
            offset=self._extent(self._writes, banked.dtype),
            gathered=scatter is not None,
            pool_words=(into.shape[0] // n) * width if scatter is not None
            else 0)
        self._writes.append(_Queued(spec, banked, rest, width,
                                    banked.shape[0], scatter=scatter,
                                    into=into))
        return spec

    # -- the issue/commit pipeline ---------------------------------------------
    def issue(self) -> None:
        """Run the queued traffic through the networks (one read and one
        write invocation per dtype present) and clear the queues.  A second
        :meth:`issue` before :meth:`commit` is an ordering error."""
        if self._inflight is not None:
            raise RuntimeError(
                "issue() with a burst already in flight; commit() the "
                "previous burst first (the pipeline is one deep)")
        out: Dict[str, torch.Tensor] = {}
        out.update(self._run_direction(self._reads, read=True))
        out.update(self._run_direction(self._writes, read=False))
        self._reads, self._writes = [], []
        self._inflight = out
        self.stats.flushes += 1

    def commit(self) -> Dict[str, torch.Tensor]:
        """Adopt the in-flight burst's results, keyed by stream name."""
        if self._inflight is None:
            raise RuntimeError("commit() without a matching issue()")
        out, self._inflight = self._inflight, None
        return out

    def flush(self) -> Dict[str, torch.Tensor]:
        """Synchronous form: ``issue()`` immediately followed by ``commit()``."""
        self.issue()
        return self.commit()

    # -- burst construction ----------------------------------------------------
    def _run_direction(self, queue: List[_Queued],
                       read: bool) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        n = self.fabric.n_ports
        by_dtype: Dict[torch.dtype, List[_Queued]] = {}
        for q in queue:
            by_dtype.setdefault(q.payload.dtype, []).append(q)
        for dtype, streams in by_dtype.items():
            self.stats.streams_served += len(streams)
            sparse = [q for q in streams if q.sparse]
            for q in sparse:
                self.stats.words_live += q.groups * n * n * q.width
            sharded = [q for q in streams if q.shard is not None]
            if sharded:
                # pool-sharded lowering: each stream is its own two-hop
                # collective burst; the other streams of the dtype go on
                for q in sharded:
                    out[q.spec.name] = self._run_sparse_sharded(q, read)
                streams = [q for q in streams if q.shard is None]
                sparse = [q for q in streams if q.sparse]
                if not streams:
                    continue
            if sparse and self.fabric.burst_kernelized_for(dtype):
                # fused lowering: each sparse stream is one gather/scatter
                # kernel launch; dense streams still share one packed burst
                for q in sparse:
                    out[q.spec.name] = self._run_sparse_kernel(q, read)
                streams = [q for q in streams if not q.sparse]
                if not streams:
                    continue
            elif sparse:
                # unrolled lowering: gathers become takes feeding the shared
                # burst; scatters land after the network returns
                self.stats.gather_fused_bursts += 1
                streams = [self._materialize_gather(q) for q in streams]
            self.stats.network_calls += 1
            res = (self._run_packed(streams, read) if self.pack == "packed"
                   else self._run_padded(streams, read))
            for q in streams:
                if q.scatter is not None:
                    _put_drop(q.into, q.scatter, res[q.spec.name])
                    res[q.spec.name] = q.into
            out.update(res)
        return out

    def _materialize_gather(self, q: _Queued) -> _Queued:
        """Unrolled form of a sparse read: the frame gather lowers as a take
        whose result joins the shared burst like any dense stream."""
        if q.gather is None:
            return q
        return dataclasses.replace(q, payload=_take_fill(q.payload, q.gather),
                                   gather=None)

    def _sparse_fold(self, q: _Queued) -> int:
        """Fold factor for one sparse stream on the kernel path: within-line
        only (the indices address whole frames)."""
        return self._fold_factor(q.payload.dtype, lambda f: q.width % f == 0)

    def _run_sparse_kernel(self, q: _Queued, read: bool) -> torch.Tensor:
        """One sparse-extent stream through the fused gather/scatter kernel:
        the pool stream (and, for writes, the scatter target) is viewed as
        machine words sharing its storage, and only the live frames move."""
        n = self.fabric.n_ports
        fold = self._sparse_fold(q)
        elems = q.groups * n * n * q.width
        self.stats.network_calls += 1
        self.stats.kernel_bursts += 1
        self.stats.gather_fused_bursts += 1
        self.stats.words_moved += elems
        self.stats.words_folded += elems - elems // fold
        dt = q.payload.dtype

        def view(x, lead_ndim):
            flat = x.reshape(tuple(x.shape[:lead_ndim]) + (q.width,))
            return _word_view(flat.contiguous(), dt, fold)

        if read:
            banked = self.fabric.read_burst(view(q.payload, 2),
                                            indices=q.gather)
            return _unword_view(banked, dt).reshape(
                (q.groups, n, n) + q.rest_shape)
        # `into` is contiguous (checked at enqueue), so its word view shares
        # the pool's storage and the scatter lands in the pool itself
        self.fabric.write_burst(view(q.payload, 3), indices=q.scatter,
                                into=view(q.into, 2))
        return q.into

    def _run_sparse_sharded(self, q: _Queued, read: bool) -> torch.Tensor:
        """One pool-sharded sparse stream through the two-hop collective
        (:meth:`Fabric.read_burst_sharded` / :meth:`Fabric.
        write_burst_sharded`): every shard runs the fused gather or scatter
        on the frames it owns and one collective bridges them.  The word
        fold applies as on the single-device kernel path (within-line), so
        the collective moves ``1/fold`` the lanes too."""
        n = self.fabric.n_ports
        fetch, place, k_tot = q.shard
        s, _, cap = fetch.shape
        fold = self._sparse_fold(q)
        elems = q.groups * n * n * q.width
        self.stats.network_calls += 1
        self.stats.collective_calls += 1
        self.stats.gather_fused_bursts += 1
        if self.fabric.burst_kernelized_for(q.payload.dtype):
            self.stats.kernel_bursts += 1
        self.stats.words_moved += elems
        self.stats.words_folded += elems - elems // fold
        # the exchange moves whole padded buckets; the diagonal stays local
        self.stats.words_cross_shard += s * (s - 1) * cap * n * q.width
        dt = q.payload.dtype

        def view(x):
            # a view sharing x's storage: the write lands in the pool itself
            return _word_view(x.reshape(tuple(x.shape[:3]) + (q.width,)),
                              dt, fold)

        if read:
            banked = self.fabric.read_burst_sharded(view(q.payload), fetch,
                                                    place, k_tot)
            return _unword_view(banked, dt).reshape(
                (q.groups, n, n) + q.rest_shape)
        self.fabric.write_burst_sharded(view(q.payload.contiguous()), fetch,
                                        place, view(q.into))
        return q.into

    def _fold_factor(self, dtype: torch.dtype, supports) -> int:
        """The largest ``f ≤ word_fold`` for which an ``f``-words-wide
        machine word exists and ``supports(f)`` holds; 1 = no folding
        (bool and complex payloads never fold)."""
        cap = 4 if self.word_fold == "auto" else int(self.word_fold)
        if cap == 1 or dtype == torch.bool or dtype.is_complex:
            return 1
        size = dtype.itemsize
        for f in (4, 2):
            if (f <= cap and machine_word_dtype(size * f) is not None
                    and supports(f)):
                return f
        return 1

    def _group_fold(self, streams: List[_Queued]) -> int:
        """Fold factor for one packed dtype group: ``f`` must divide every
        stream's per-group word count or its group count."""
        return self._fold_factor(
            streams[0].payload.dtype,
            lambda f: all(q.width % f == 0 or q.groups % f == 0
                          for q in streams))

    def _run_packed(self, streams: List[_Queued],
                    read: bool) -> Dict[str, torch.Tensor]:
        """Word-axis packing: fold each stream's group axis into the word
        axis, concatenate along words, run the network once on the
        ``[N, N, W_total]`` tile, and slice each stream's extent back."""
        n = self.fabric.n_ports
        fold = self._group_fold(streams)
        tiles = []
        for q in streams:
            tiles.append(_pack_tile(q, n, fold))
            elems = q.groups * n * n * q.width
            self.stats.words_moved += elems
            self.stats.words_folded += elems - elems // fold
        burst = tiles[0] if len(tiles) == 1 else torch.cat(tiles, dim=-1)
        burst = burst.contiguous()
        moved = (self.fabric.read_burst(burst) if read
                 else self.fabric.write_burst(burst))
        if self.fabric.burst_kernelized_for(burst.dtype):
            self.stats.kernel_bursts += 1
        out: Dict[str, torch.Tensor] = {}
        # extents over the streams actually packed (kernelized sparse
        # streams peel off into their own launches)
        off = 0
        for q in streams:
            piece = moved[:, :, off // fold: (off + q.spec.words) // fold]
            off += q.spec.words
            out[q.spec.name] = _unpack_tile(piece, q, n, read, fold)
        return out


    def _padded_fold(self, streams: List[_Queued], w_max: int) -> int:
        """Fold factor for one pad-layout dtype group: every stream is
        padded to ``w_max`` words, so the factor has to divide ``w_max``."""
        return self._fold_factor(streams[0].payload.dtype,
                                 lambda f: w_max % f == 0)

    def _run_padded(self, streams: List[_Queued],
                    read: bool) -> Dict[str, torch.Tensor]:
        """Pad-to-widest layout (``pack="pad"``): each stream's words are
        zero-padded to the widest stream's and the streams concatenate
        along the line axis, so the network moves the padding the packed
        layout avoids.  Under ``word_fold`` the padded word axis folds into
        wider machine words first; at a fold of 1 the payload keeps its
        dtype.  The counters are the reference's (``kernel_bursts`` is not
        counted: the reference runs its unrolled network here)."""
        n = self.fabric.n_ports
        out: Dict[str, torch.Tensor] = {}
        w_max = max(q.width for q in streams)
        fold = self._padded_fold(streams, w_max)
        dt = streams[0].payload.dtype
        flat = []
        for q in streams:
            lead = tuple(q.payload.shape[:2 if read else 3])
            x = q.payload.reshape(lead + (q.width,))
            lines = q.payload.shape[0] * (1 if read else n)
            self.stats.words_moved += lines * n * q.width
            self.stats.words_padded += lines * n * (w_max - q.width)
            if q.width < w_max:
                x = torch.nn.functional.pad(x, (0, w_max - q.width))
            if fold > 1:
                elems = lines * n * w_max          # lane view incl. padding
                self.stats.words_folded += elems - elems // fold
                x = _word_view(x.contiguous(), dt, fold)
            flat.append(x)
        burst = flat[0] if len(flat) == 1 else torch.cat(flat, dim=0)
        moved = self._padded_network(burst, read)
        # split back: stream i covers groups [off, off + L_i/N) (read) or
        # lines [off, off + G_i*N) (write)
        off = 0
        for q in streams:
            count = (q.payload.shape[0] // n if read
                     else q.payload.shape[0] * n)
            piece = moved[off:off + count]
            off += count
            if fold > 1:
                piece = _unword_view(piece.contiguous(), dt)
            piece = piece[..., :q.width]
            out[q.spec.name] = piece.reshape(tuple(piece.shape[:-1])
                                             + q.rest_shape)
        return out

    def _padded_network(self, burst: torch.Tensor,
                        read: bool) -> torch.Tensor:
        """The pad layout's network call: lines ``[G*N, N, w]`` → banked
        ``[G, N, N, w]`` (read), or back (write).  On the kernelized fabric
        the line groups fold into the word axis, as the packed layout's
        do, and the padded burst is one ``[N, N, G*w]`` tile through the
        dense burst kernel; otherwise the fabric's network runs on the
        line stream, as the reference's does."""
        n = self.fabric.n_ports
        if not self.fabric.burst_kernelized_for(burst.dtype):
            return (self.fabric.read(burst) if read
                    else self.fabric.write(burst))
        g = burst.shape[0] // n if read else burst.shape[0]
        w = burst.shape[-1]
        tile = burst.reshape(g, n, n, w).permute(1, 2, 0, 3).reshape(
            n, n, g * w)
        moved = (self.fabric.read_burst(tile) if read
                 else self.fabric.write_burst(tile))
        banked = moved.reshape(n, n, g, w).permute(2, 0, 1, 3)
        return banked if read else banked.reshape(g * n, n, w)


# Sparse-extent sentinel: any index >= the backing stream's line count reads
# as a zero frame and drops on scatter.  Producers and consumers share this
# one value so it stays >= every pool's lines.
FRAME_SENTINEL = 2 ** 30


# Machine words, as signed same-width integers (torch's unsigned 16/32-bit
# types lack most operators; the bits are what move).  No 8-byte word: the
# reference moves one only under jax_enable_x64, which is off by default.
_WORD_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def machine_word_dtype(itemsize: int) -> Optional[torch.dtype]:
    """The machine word of ``itemsize`` bytes, or None if the fabric does
    not move one."""
    return _WORD_VIEW.get(itemsize)


def _word_view(x: torch.Tensor, dtype: torch.dtype,
               fold: int) -> torch.Tensor:
    """``x`` (payload ``dtype``, last axis contiguous) as machine words:
    same-width integers at ``fold == 1`` (identity for integer, bool and
    complex payloads, and for widths without a machine word), else
    ``fold`` adjacent words per wider machine word — a view sharing
    ``x``'s storage either way."""
    size = x.element_size()
    if fold == 1:
        if not dtype.is_floating_point:
            return x
        wide = machine_word_dtype(size)
        return x if wide is None else x.view(wide)
    return x.view(machine_word_dtype(size * fold))


def _unword_view(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Undo :func:`_word_view`: the machine words back as ``dtype``."""
    if x.dtype == dtype:
        return x
    if x.element_size() != dtype.itemsize:
        x = x.contiguous()
    return x.view(dtype)


def _pack_tile(q: _Queued, n: int, fold: int) -> torch.Tensor:
    """One stream → its ``[N, N, words/fold]`` extent of the packed burst:
    the line groups fold into the word axis behind a machine-word view —
    adjacent words of a line group (when ``fold`` divides the width), or
    corresponding words of adjacent groups (when it divides the group
    count)."""
    g, w = q.groups, q.width
    dt = q.payload.dtype
    flat = q.payload.reshape(g, n, n, w)
    if fold == 1 or w % fold == 0:
        words = _word_view(flat.contiguous(), dt, fold)
        return words.permute(1, 2, 0, 3).reshape(n, n, -1)
    grouped = flat.permute(1, 2, 3, 0).contiguous()      # [N, N, w, g]
    return _word_view(grouped, dt, fold).reshape(n, n, -1)


def _unpack_tile(piece: torch.Tensor, q: _Queued, n: int, read: bool,
                 fold: int) -> torch.Tensor:
    """Inverse of :func:`_pack_tile`: the stream's slice of the moved burst
    back to banked ``[G, N, N, *rest]`` (reads) or lines
    ``[G*N, N, *rest]`` (writes)."""
    g, w = q.groups, q.width
    dt = q.payload.dtype
    lead = (g, n, n) if read else (g * n, n)
    if fold == 1 or w % fold == 0:
        out = piece.reshape(n, n, g, w // fold).permute(2, 0, 1, 3)
        return _unword_view(out.contiguous(), dt).reshape(lead + q.rest_shape)
    out = _unword_view(piece.reshape(n, n, w, g // fold).contiguous(), dt)
    return out.permute(3, 0, 1, 2).reshape(lead + q.rest_shape)


def _prod(shape: Tuple[int, ...]) -> int:
    p = 1
    for s in shape:
        p *= s
    return p
