"""Medusa collective schedule: all-to-all as S-1 ring rotations (port of
``repro.parallel.collectives``).

The reference runs its collectives inside ``shard_map``, one call per
rank.  Here a collective is one function over the list of every rank's
tensor (``blocks[d]`` is rank ``d``'s), and it returns the list of what
each rank holds after it; the rank count ``S`` is the list's length, so
``axis_size`` has no counterpart.  With every rank on one device each hop
is a copy on that device.

``ring_all_to_all`` keeps the paper's diagonal schedule (§III-A): step
``s = 1..S-1`` is one rotation that moves the blocks ``(d → d+s)`` of
every rank at once, and each rank keeps its own block.  ``xla_all_to_all``
keeps the reference's name for the monolithic exchange ("xla": XLA's one
``all_to_all`` op there): every rank gathers its blocks from every other
in one transpose.  Both move the same blocks, bit for bit.

``compressed_psum`` (the int8 all-reduce) and ``dp_grad_mean`` (the
data-parallel gradient mean) reduce over the ranks: they return the one
tensor (or list) that every rank holds afterwards, in the reference's
arithmetic, bit for bit.

Each collective reports itself to the cost census of :mod:`repro_torch.
launch.hlo_analysis` (:func:`repro_torch.kernels.launch.
report_collective`) as the reference's HLO ops would show: one
``collective-permute`` a rotation, one ``all-to-all``, one ``all-reduce``
a sum or maximum over ranks, over every rank's operands and results.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.kernels import launch as kl


def _ppermute(xs: Sequence[torch.Tensor], shift: int) -> List[torch.Tensor]:
    """One ring rotation: rank ``i``'s tensor arrives at rank
    ``(i + shift) % S``."""
    n = len(xs)
    return [xs[(i - shift) % n] for i in range(n)]


def ring_all_to_all(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-to-all of every rank's ``[S, ...]`` send buffer (block ``j``
    destined to rank ``j``) in ``S-1`` rotation steps: afterwards rank
    ``r`` holds ``out[r][o] = blocks[o][r]``.  Equivalent to
    :func:`xla_all_to_all`."""
    n = len(blocks)
    out = [torch.empty_like(b) for b in blocks]
    for d in range(n):                      # my own block stays put
        out[d][d].copy_(blocks[d][d])
    for s in range(1, n):
        # step s: every rank sends the block destined for rank (d+s) % S,
        # which stores it at (dst - s) % S, the sender's rank
        sent = [blocks[d][(d + s) % n] for d in range(n)]
        kl.report_collective("collective-permute", sent, sent)
        for dst, recv in enumerate(_ppermute(sent, s)):
            out[dst][(dst - s) % n].copy_(recv)
    return out


def xla_all_to_all(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The "crossbar": the monolithic all-to-all on the same layout, one
    block transpose ``out[r][o] = blocks[o][r]``."""
    n = len(blocks)
    out = [torch.stack([blocks[o][r] for o in range(n)]) for r in range(n)]
    kl.report_collective("all-to-all", blocks, out)
    return out


def ring_all_gather(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-gather as ``S-1`` neighbour rotations: afterwards every rank
    holds every rank's tensor, concatenated in rank order along axis 0."""
    n = len(blocks)
    held = [[b] for b in blocks]
    cur = list(blocks)
    for _ in range(n - 1):
        kl.report_collective("collective-permute", cur, cur)
        cur = _ppermute(cur, 1)
        for r in range(n):
            held[r].append(cur[r])
    # held[r][s] is the tensor of rank (r - s) % S; restore rank order
    return [torch.cat([held[r][(r - j) % n] for j in range(n)])
            for r in range(n)]


def _psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum over ranks, accumulated from zero in rank order, as XLA
    reduces the rank axis (one rank's tensor is its own sum, its -0.0
    kept)."""
    if len(xs) == 1:
        total = xs[0]
    else:
        total = torch.zeros_like(xs[0])
        for x in xs:
            total = total + x
    kl.report_collective("all-reduce", xs, [total] * len(xs))
    return total


def compressed_psum(gs: Sequence[torch.Tensor]) -> torch.Tensor:
    """int8-compressed gradient all-reduce of every rank's ``gs[r]``: each
    rank quantises with the shared scale (the largest over ranks of
    ``max(max|g|, 1e-12) / 127``; round half to even, clipped to ±127),
    the int8 values sum as int32, and the sum comes back times the scale
    (float32)."""
    scales = [torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
              for g in gs]
    scale = torch.stack(scales).amax()
    kl.report_collective("all-reduce", scales, [scale] * len(gs))
    qs = [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
          for g in gs]
    total = _psum([q.to(torch.int32) for q in qs])
    return total.to(torch.float32) * scale


def dp_grad_mean(grads_per_rank: Sequence[Sequence[torch.Tensor]],
                 compression: str = "none") -> List[torch.Tensor]:
    """Data-parallel gradient mean: ``grads_per_rank[r]`` is rank ``r``'s
    list of gradient leaves (aligned across ranks); returns the leaves'
    mean over the ranks.  ``"none"`` is the exact mean (the sum over ranks
    over their count), ``"int8"`` :func:`compressed_psum` over the
    count."""
    if compression not in ("none", "int8"):
        raise ValueError(f"unknown compression {compression!r}")
    n = len(grads_per_rank)
    reduce = compressed_psum if compression == "int8" else _psum
    return [reduce(leaf) / n for leaf in zip(*grads_per_rank)]
