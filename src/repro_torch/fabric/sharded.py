"""The sharded physical page pool, in one process (port of
``repro.fabric.sharded``).

The pool's page axis splits over a ``pool`` mesh axis of ``S`` shards, and
a sparse-extent burst (``Fabric.read_burst(indices=)`` / ``write_burst(
indices=, into=)``) lowers as a **two-hop collective**:

1. *local hop*: each shard runs the fused page-table gather (or scatter)
   on the frames it owns, through :meth:`Fabric.read_burst` /
   :meth:`Fabric.write_burst`: kernel 1 (kernel 2) on the card, once per
   shard per stream;
2. *exchange hop*: one all-to-all (:func:`repro_torch.parallel.
   xla_all_to_all`) or its ring of ``S-1`` rotations (``ring_all_to_all``,
   :attr:`FabricConfig.collective`) delivers every frame to the shard that
   requested it (or, writing, owns it), and the requesting shard places
   what it received at its output rows.

Both hops are permutations of whole machine words, so the result is bit
for bit the single-device sparse burst.  Ownership is contiguous-block by
physical page: shard ``s`` owns pages ``[s*P/S, (s+1)*P/S)`` of every
layer rep (:func:`pool_partition_spec`); the allocator
(:class:`repro_torch.fabric.PagePool` with ``n_shards``) stripes pages
round-robin over the blocks, so a step's traffic spreads over the shards.
:func:`shard_plan` is the host side, the reference's exactly.

The reference runs the hops inside ``shard_map``, where each shard sees
its own block ``[R, F/S, N, W]`` of a pool stream ``[R, F, N, W]`` as a
local line stream.  Here every shard lives on one device
(:mod:`repro_torch.launch.mesh`), and that block is not contiguous: it is
strided over the rep axis ``R``, and the kernels take contiguous operands
only.  So the local hop addresses the leaf's whole contiguous ``[R*F, N,
W]`` line stream, with each local row ``rep*F/S + j`` of the plan mapped
to its stream row ``rep*F + s*F/S + j`` (:func:`_stream_rows`): every row
a shard's hop names lies in that shard's block (checked on the host,
:func:`check_owned_rows`), sentinels stay sentinels, and the write
direction lands in the leaf's own storage.  The CPU takes the same rows
through the plain versions.  The per-shard operands are the shards' blocks
of the plan (:func:`repro_torch.launch.mesh.shard_blocks`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.fabric.fabric import _take_fill
from repro_torch.fabric.scheduler import FRAME_SENTINEL as _SENTINEL
from repro_torch.launch.mesh import (POOL_AXIS, Mesh, compat_mesh,
                                     shard_blocks)
from repro_torch.parallel.collectives import ring_all_to_all, xla_all_to_all


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Host-side plan of one step's cross-shard traffic (one per distinct
    leaf rep count; both burst directions reuse it).

    ``fetch [S(owner), S(requestor), cap]``: for each owning shard, the
    *local* line-stream rows it sends each requestor (sentinel = padding:
    reads gather zero frames, writes drop).  ``place [S(requestor),
    S(owner), cap]``: for each requesting shard, the *local* output row of
    each received line (sentinels drop).  ``cap`` is the padded bucket
    size, a multiple of N.  ``cross_frames``/``local_frames`` count the
    live requests that cross shards and that stay local."""

    fetch: np.ndarray
    place: np.ndarray
    k_tot: int
    cap: int
    cross_frames: int
    local_frames: int

    @property
    def n_shards(self) -> int:
        return self.fetch.shape[0]

    def operands(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The plan's device operands ``(fetch, place)`` (int32)."""
        return (torch.from_numpy(self.fetch).to(device),
                torch.from_numpy(self.place).to(device))


def shard_plan(live_idx, frames: int, n_shards: int, n_ports: int,
               reps: int = 1, cap_bucket: int = 0) -> ShardPlan:
    """Split a sparse burst's frame-index list by owning shard (host side).

    ``live_idx [K]`` are per-pool physical frame indices (entries ``>=
    frames`` are sentinels requesting nothing), ``frames`` the per-rep pool
    frame count, ``reps`` the leaf's leading layer-stack factor (the
    request list is rep-major, as :func:`repro_torch.models.common.
    pool_rep_indices` tiles it).  Output row ``j`` of the ``k_tot =
    reps*K`` line stream belongs to requesting shard ``j // (k_tot/S)``.
    ``cap_bucket`` rounds the bucket capacity up beyond the mandatory
    multiple of N."""
    idx = np.asarray(live_idx, np.int64)
    s = int(n_shards)
    if s < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if frames % s:
        raise ValueError(f"pool frame count {frames} must divide into "
                         f"{s} equal shard blocks")
    k_tot = int(reps) * idx.shape[0]
    if k_tot % (s * n_ports):
        raise ValueError(
            f"sharded burst needs {reps}*{idx.shape[0]} request lines to "
            f"split into {s} shard blocks of whole N={n_ports} groups — "
            f"bucket the live plan to a multiple of S*N")
    f_loc = frames // s
    k_loc = k_tot // s
    tiled = np.tile(idx, int(reps))                      # rep-major [k_tot]
    out_rows = np.nonzero(tiled < frames)[0]             # sentinels skip
    f = tiled[out_rows]
    rep = out_rows // idx.shape[0]
    owner = f // f_loc
    row_loc = rep * f_loc + f % f_loc                    # local line row
    req = out_rows // k_loc
    place_loc = out_rows % k_loc                         # local output row
    # stable-sort by (req, owner) to slot each request into its bucket
    key = req * s + owner
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    _, start, counts = np.unique(key_s, return_index=True,
                                 return_counts=True)
    slot = np.arange(key_s.shape[0]) - np.repeat(start, counts)
    cap = max(int(counts.max()) if counts.size else 0, 1)
    cap = -(-cap // n_ports) * n_ports
    if cap_bucket:
        cap = -(-cap // cap_bucket) * cap_bucket
    fetch = np.full((s, s, cap), _SENTINEL, np.int32)
    place = np.full((s, s, cap), _SENTINEL, np.int32)
    ro, rq = owner[order], req[order]
    fetch[ro, rq, slot] = row_loc[order]
    place[rq, ro, slot] = place_loc[order]
    cross = int((owner != req).sum())
    return ShardPlan(fetch=fetch, place=place, k_tot=k_tot, cap=cap,
                     cross_frames=cross,
                     local_frames=int(out_rows.shape[0]) - cross)


def pool_partition_spec(leaf_ndim: int) -> Tuple:
    """The partition of a pool-backed KV leaf ``[lead..., n_pages,
    page_size, Hkv, D]``, one entry per axis: the page axis, always fourth
    from the end, splits over :data:`POOL_AXIS`; every other axis is
    whole (``None``), as the reference's ``PartitionSpec``."""
    if leaf_ndim < 4:
        raise ValueError(f"pool leaf needs [*, pages, page, H, D], "
                         f"rank {leaf_ndim} is too small")
    spec = [None] * leaf_ndim
    spec[leaf_ndim - 4] = POOL_AXIS
    return tuple(spec)


def make_pool_mesh(n_shards: int, device=None) -> Mesh:
    """A 1-D ``("pool",)`` mesh of ``n_shards`` shards, every one on
    ``device`` (default: the CUDA device; pass ``"cpu"`` for the CPU)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve_device(device)
    return compat_mesh([dev] * n_shards, (n_shards,), (POOL_AXIS,))


def _exchange(blocks: List[torch.Tensor],
              collective: str) -> List[torch.Tensor]:
    """One inter-shard hop: block ``j`` of each shard's ``[S, ...]`` to
    shard ``j``."""
    if collective == "ring":
        return ring_all_to_all(blocks)
    return xla_all_to_all(blocks)


def _stream_rows(fetch: torch.Tensor, reps: int,
                 frames: int) -> torch.Tensor:
    """The plan's local rows as rows of the whole ``[R*F, N, W]`` stream:
    ``[S(owner), S*cap]`` int32, row ``o`` the indices owner ``o``'s local
    hop takes.  Local row ``rep*F/S + j`` of owner ``o`` is stream row
    ``rep*F + o*F/S + j``, inside owner ``o``'s block; rows past the local
    block (the plan's sentinels) stay :data:`FRAME_SENTINEL`.  On the CPU
    the rows are checked to lie in their owner's block
    (:func:`check_owned_rows`); the engine checks its plans there before
    they reach the card."""
    s = fetch.shape[0]
    f_loc = frames // s
    local = fetch.reshape(s, -1)
    valid = local < reps * f_loc
    local = torch.where(valid, local, 0)
    owner = torch.arange(s, dtype=torch.int32, device=fetch.device)[:, None]
    rows = (local // f_loc) * frames + owner * f_loc + local % f_loc
    rows = torch.where(valid, rows, _SENTINEL).to(torch.int32)
    if rows.device.type == "cpu":
        _assert_owned(rows, frames)
    return rows


def _assert_owned(rows: torch.Tensor, frames: int) -> None:
    """Every live row of shard ``o``'s hop (``rows[o]``) lies in ``o``'s
    block ``[o*F/S, (o+1)*F/S)`` of its rep: a hop never reads or writes
    another shard's pages."""
    s = rows.shape[0]
    owner = torch.arange(s, dtype=rows.dtype, device=rows.device)[:, None]
    stray = (rows % frames) // (frames // s) != owner
    stray &= rows != _SENTINEL
    if bool(stray.any()):
        o, j = (int(x) for x in stray.nonzero()[0])
        raise AssertionError(
            f"shard {o}'s hop names stream row {int(rows[o, j])}, outside "
            f"its block of {frames // s} frames per rep")


def check_owned_rows(plan: ShardPlan, reps: int, frames: int) -> None:
    """Check on the host that every row the local hops of ``plan`` name
    lies in its shard's block of a ``[reps, frames]`` pool stream."""
    _stream_rows(torch.from_numpy(plan.fetch), reps, frames)


def _check_stream(stream: torch.Tensor, n: int, what: str) -> None:
    if stream.ndim != 4 or stream.shape[2] != n:
        raise ValueError(f"{what} wants the rep-major pool stream "
                         f"[R, F, N, W] for N={n}, got {tuple(stream.shape)}")
    if not stream.is_contiguous():
        raise ValueError(f"{what}: the pool stream must be contiguous (its "
                         f"shards' hops address its [R*F, N, W] lines)")


def sharded_read_burst(fabric, stream: torch.Tensor, fetch: torch.Tensor,
                       place: torch.Tensor, k_tot: int) -> torch.Tensor:
    """Sparse read burst over the sharded pool: ``stream [R, F, N, W]``
    (page-major frames, the pool axis split over the shards) → banked
    ``[k_tot//N, N, N, W]`` in request order, bit for bit the single-device
    ``Fabric.read_burst(lines, indices=)`` on the flattened ``[R*F, N,
    W]`` stream with rep-tiled indices.

    Each owning shard fuse-gathers the rows ``fetch`` names from its block
    (kernel 1 on the card), un-banks them to exchange order ``[S, cap, N,
    W]``; one collective delivers them; each requesting shard places the
    received lines at its output rows."""
    n = fabric.n_ports
    _check_stream(stream, n, "sharded read")
    s, _, cap = fetch.shape
    k_loc = k_tot // s
    reps, frames, _, w = stream.shape
    lines = stream.reshape(reps * frames, n, w)
    rows = _stream_rows(fetch, reps, frames)
    spec = (POOL_AXIS,)
    send = [fabric.read_burst(lines, indices=rows_o[0]).transpose(1, 2)
            .reshape(s, cap, n, w)
            for rows_o in shard_blocks(rows, spec, fabric.mesh)]
    recv = _exchange(send, fabric.config.collective)   # [S(owner), cap, ...]
    # each requestor's k_loc output rows, plus one row its sentinel
    # placements drop into
    out = torch.zeros((k_tot + 1, n, w), dtype=stream.dtype,
                      device=stream.device)
    for r, pl in enumerate(shard_blocks(place, spec, fabric.mesh)):
        pl = pl.reshape(s * cap)
        dst = torch.where(pl < k_loc, pl + r * k_loc, k_tot)
        out.index_copy_(0, dst.long(), recv[r].reshape(s * cap, n, w))
    return out[:k_tot].reshape(k_tot // n, n, n, w).transpose(
        1, 2).contiguous()


def sharded_write_burst(fabric, banked: torch.Tensor, fetch: torch.Tensor,
                        place: torch.Tensor,
                        into: torch.Tensor) -> torch.Tensor:
    """Write direction of :func:`sharded_read_burst`: banked live frames
    ``[k_tot//N, N, N, W]`` land at their pool rows of ``into [R, F, N,
    W]``, **in place** (the leaf's own storage; rows no index names keep
    their bytes).  The same buckets run in reverse: each requestor sends
    its lines to their owning shard through one collective, and the owner
    runs the fused scatter (kernel 2 on the card) into its block.
    Returns ``into``."""
    n = fabric.n_ports
    _check_stream(into, n, "sharded write")
    s, _, cap = fetch.shape
    k_tot = banked.shape[0] * n
    reps, frames, _, w = into.shape
    lines = banked.transpose(1, 2).reshape(k_tot, n, w)
    spec = (POOL_AXIS,)
    send = [_take_fill(lines_r, pl.reshape(s * cap)).reshape(s, cap, n, w)
            for lines_r, pl in zip(shard_blocks(lines, spec, fabric.mesh),
                                   shard_blocks(place, spec, fabric.mesh))]
    recv = _exchange(send, fabric.config.collective)   # [S(req), cap, ...]
    rows = _stream_rows(fetch, reps, frames)
    pool_lines = into.view(reps * frames, n, w)
    for recv_o, rows_o in zip(recv, shard_blocks(rows, spec, fabric.mesh)):
        bank = recv_o.reshape(s * cap // n, n, n, w).transpose(
            1, 2).contiguous()
        fabric.write_burst(bank, indices=rows_o[0], into=pool_lines)
    return into
