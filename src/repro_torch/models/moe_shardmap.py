"""Medusa-schedule MoE layer: explicit expert-parallel dispatch over a ring
(port of ``repro.models.moe_shardmap``).

The interconnect's **even static partition + rotation schedule** applied
to expert parallelism over ``n`` ranks:

1. every rank routes ITS OWN tokens (top-k, a rank-local capacity — the
   paper's obs. 1: bandwidth statically, evenly partitioned per port);
2. per-destination fixed-size blocks ``[n, e_loc * cap, d]`` go out on one
   all-to-all (``ring``: ``n - 1`` rotations, the §III-A diagonal
   schedule; ``xla``: the monolithic block transpose);
3. each rank runs its local experts over the arrived blocks;
4. the results return on the reverse exchange and combine locally.

The reference runs one call per rank inside ``shard_map``.  Here one call
takes every rank's tokens and parameters as lists (``x_blocks[r]``,
``p_locs[r]``) and runs each step for every rank in turn, on the run's one
device; the exchanges are :mod:`repro_torch.parallel.collectives`' over
the ranks' send buffers.  The payload moves through ``Fabric.route``
(``index_select``) as in the reference, not through the engine MoE's
burst kernels.  Every movement is differentiable: the gradients flow back
through both exchanges.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from repro_torch.fabric.fabric import Fabric
from repro_torch.models.moe import _assign
from repro_torch.parallel.collectives import ring_all_to_all, xla_all_to_all

_EXCHANGES = {"ring": ring_all_to_all, "xla": xla_all_to_all}


def _local_experts(cfg, n: int) -> int:
    e_total = cfg.moe.n_experts_padded
    if n < 1 or e_total % n:
        raise ValueError(f"{e_total} experts do not split evenly over {n} "
                         f"ranks: the rank count must divide the experts")
    return e_total // n


def moe_apply_shardmap(p_locs: Sequence[dict],
                       x_blocks: Sequence[torch.Tensor], cfg,
                       collective: str = "ring") -> List[torch.Tensor]:
    """The expert-parallel MoE FFN over ``n = len(x_blocks)`` ranks.

    ``x_blocks[r] [B_loc, S, d]`` are rank ``r``'s tokens (every rank the
    same shape); ``p_locs[r]`` its parameters, the router whole and the
    expert leaves only its ``e_loc = E_pad / n`` experts (see
    :func:`shard_expert_params`).  Returns each rank's ``[B_loc, S, d]``
    output.  The capacity is each rank's own, ``max(int(t * k *
    capacity_factor / n_experts), 1)`` over its ``t = B_loc * S`` tokens,
    while the slots span the padded expert count."""
    if collective not in _EXCHANGES:
        raise ValueError(f"unknown collective {collective!r}")
    exchange = _EXCHANGES[collective]
    m = cfg.moe
    n = len(x_blocks)
    if len(p_locs) != n:
        raise ValueError(f"{len(p_locs)} ranks' parameters for {n} ranks' "
                         f"tokens")
    e_loc = _local_experts(cfg, n)
    e_total = m.n_experts_padded
    shapes = {tuple(x.shape) for x in x_blocks}
    if len(shapes) != 1:
        raise ValueError(f"every rank's block must have one shape, got "
                         f"{sorted(shapes)}")
    fabric = Fabric.for_model(cfg)
    b, s, d = x_blocks[0].shape
    t = b * s
    k_tot = t * m.top_k

    # 1. local routing (the router is replicated) and the send buffers:
    # slot j of expert e holds the j-th of the rank's assignments to e
    routed, sends = [], []
    for p, x in zip(p_locs, x_blocks):
        xt = x.reshape(t, d)
        top_p, _, keep, slot, cap = _assign(p, xt, cfg)
        # a dropped assignment's slot is e_total * cap: masked, so the
        # scatter drops it as the reference's mode="drop"
        inv = torch.full((e_total * cap,), k_tot, dtype=torch.long,
                         device=x.device)
        live = torch.nonzero(keep).reshape(-1)
        inv[slot[live]] = live
        src_tok = torch.clamp(inv // m.top_k, 0, t - 1)
        send = torch.where((inv < k_tot)[:, None],
                           fabric.route(xt, src_tok), 0)
        routed.append((top_p, keep, slot, cap))
        sends.append(send.reshape(n, e_loc * cap, d))

    # 2. exchange: block r of every rank's buffer goes to rank r
    recv = exchange(sends)                          # [n, e_loc * cap, d] each

    # 3. local experts over the arrived tokens, and 4. the way back
    backs = []
    for p, buf, (_, _, _, cap) in zip(p_locs, recv, routed):
        buf = buf.reshape(n, e_loc, cap, d).transpose(0, 1).reshape(
            e_loc, n * cap, d)
        h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
        y = torch.bmm(h, p["w_out"])                # [e_loc, n * cap, d]
        backs.append(y.reshape(e_loc, n, cap, d).transpose(0, 1).reshape(
            n, e_loc * cap, d))
    returned = exchange(backs)

    # local combine: gather per assignment, weight, reduce over top-k
    outs = []
    for x, y_ret, (top_p, keep, slot, cap) in zip(x_blocks, returned,
                                                  routed):
        y_full = y_ret.reshape(e_total * cap, d)
        gathered = torch.where(
            keep[:, None],
            fabric.route(y_full, torch.clamp(slot, 0, e_total * cap - 1)), 0)
        w = top_p.reshape(-1)[:, None].to(x.dtype)
        out = (gathered * w).reshape(t, m.top_k, d).sum(dim=1)
        outs.append(out.reshape(b, s, d).to(x.dtype))
    return outs


def shard_expert_params(p, rank: int, n: int, cfg) -> dict:
    """Rank ``rank``'s parameters of ``n``: the router whole and views of
    its ``E_pad / n`` consecutive experts of each expert leaf."""
    e_loc = _local_experts(cfg, n)
    sl = slice(rank * e_loc, (rank + 1) * e_loc)
    return {"router": p["router"], "w_gate": p["w_gate"][sl],
            "w_up": p["w_up"][sl], "w_out": p["w_out"][sl]}
