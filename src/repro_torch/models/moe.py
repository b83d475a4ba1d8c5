"""Mixture-of-Experts FFN with capacity-based dispatch (port of
``repro.models.moe``).

The router partitions token bandwidth evenly across experts with a static
capacity; tokens past an expert's capacity are dropped (their residual
passes through).  Dispatch is sort-based: an assignment's rank within its
expert comes from a stable sort over the assignments.

Payload movement rides the fabric's burst contract, as in the reference:
dispatch is one scatter-indexed sparse write burst into the ``[E*C, d]``
expert slots (dropped assignments carry ``FRAME_SENTINEL`` rows, which
drop), and combine is one gather-indexed sparse read burst per
assignment (sentinels read zero frames).  On the kernelized medusa fabric
these are one launch each of the scatter kernel (kernel 2) and the gather
kernel (kernel 1) per MoE layer.  ``payload="route"`` keeps the bare
``Fabric.route`` gathers as the bit-parity reference.

Differences from the reference, each deliberate:

* top-k is the first ``k`` of a stable descending sort, so ties go to the
  lowest expert index as ``jax.lax.top_k``'s do (``torch.topk`` orders
  ties otherwise on the CPU and leaves them unspecified on CUDA);
* the capacity-drop count of the ambient :func:`dispatch_stats` sink stays
  on the device and is folded into ``SchedulerStats.tokens_dropped`` once,
  when the sink closes (the engine wraps one decode step), instead of
  syncing the device once per layer; a ``stats`` passed explicitly
  receives its count at once;
* the reference's ``shard`` annotations (expert parallelism over a mesh)
  are no-ops on one card and are left out;
* the burst payload is differentiable.  The reference moves the payload
  as machine words (a bitcast), which cuts its tangent: under
  ``payload="burst"`` its expert weights get a zero gradient.  Here the
  dispatch scatter and the combine gather are autograd Functions whose
  backward is the other burst at the same slot indices
  (:class:`_SlotScatter`, :class:`_SlotGather`): the gradients are those
  of ``payload="route"``, which the forward equals bit for bit.  The
  backward bursts report to no :class:`SchedulerStats`.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn.functional as F

from repro_torch.fabric.fabric import Fabric
from repro_torch.fabric.scheduler import (BurstScheduler, FRAME_SENTINEL,
                                          SchedulerStats)
from repro_torch.kernels import launch as kl
from repro_torch.models import common as cm

#: the ambient stats sink of :func:`dispatch_stats`, and its drop counts
#: not yet folded (device tensors)
_DISPATCH_STATS: Optional[SchedulerStats] = None
_PENDING: List[torch.Tensor] = []


@contextlib.contextmanager
def dispatch_stats(stats: Optional[SchedulerStats]):
    """Route the traffic accounting of every ``moe_apply`` run inside the
    block to ``stats``: the burst counters as each dispatch and combine
    executes, and ``tokens_dropped`` once, when the block exits (one
    device sync for all the block's layers)."""
    global _DISPATCH_STATS, _PENDING
    prev = _DISPATCH_STATS, _PENDING
    _DISPATCH_STATS, _PENDING = stats, []
    try:
        yield
    finally:
        pending = _PENDING
        _DISPATCH_STATS, _PENDING = prev
        if stats is not None and pending:
            stats.tokens_dropped += int(torch.stack(pending).sum())


def moe_param_shapes(cfg, dtype) -> dict:
    """``{name: (shape, dtype)}`` of one MoE FFN's parameters: the router
    ``[d, E]`` in float32 whatever ``dtype`` (as the reference's), the
    experts stacked ``[E_pad, d, f]`` (``w_gate``, ``w_up``) and ``[E_pad,
    f, d]`` (``w_out``) in ``dtype``."""
    m = cfg.moe
    e, d, f = m.n_experts_padded, cfg.d_model, m.expert_d_ff
    return {"router": ((d, m.n_experts), torch.float32),
            "w_gate": ((e, d, f), dtype), "w_up": ((e, d, f), dtype),
            "w_out": ((e, f, d), dtype)}


def moe_params(cfg, dtype, generator: torch.Generator, device) -> dict:
    """Random MoE parameters (:func:`moe_param_shapes`) from
    ``generator``: truncated normals over ``1/sqrt(d_in)``, as
    :func:`repro_torch.models.lm.init_params` draws a projection."""
    return {name: cm.trunc_normal(generator, shape, device,
                                  shape[-2] ** -0.5).to(dt)
            for name, (shape, dt) in moe_param_shapes(cfg, dtype).items()}


def _count_dropped(stats: Optional[SchedulerStats],
                   keep: torch.Tensor) -> None:
    """Accumulate the capacity-drop count into ``stats.tokens_dropped``:
    deferred on the device for the ambient sink, at once otherwise."""
    if stats is None:
        return
    drops = keep.numel() - keep.sum()
    if stats is _DISPATCH_STATS:
        _PENDING.append(drops)
    else:
        stats.tokens_dropped += int(drops)


def _scatter_slots(fabric: Fabric, xa: torch.Tensor, keep: torch.Tensor,
                   slot: torch.Tensor, ec: int,
                   stats: Optional[SchedulerStats]) -> torch.Tensor:
    """One sparse-extent write burst: the assignment rows ``xa [K, d]``,
    viewed as frames ``[K, N, d/N]``, land at their slots of a zeroed
    ``[E*C, d]`` pool.  Dropped assignments and the pad rows carry
    ``FRAME_SENTINEL``, which the write network drops; slots no assignment
    reaches keep their zeros.  Slots are ``expert * C + rank >= 0``: no
    negative index reaches the burst."""
    n = fabric.n_ports
    d = xa.shape[1]
    sidx = torch.where(keep, slot, FRAME_SENTINEL).to(torch.int32)
    pad = -xa.shape[0] % n
    if pad:
        xa = torch.cat([xa, xa.new_zeros((pad, d))])
        sidx = torch.cat([sidx, sidx.new_full((pad,), FRAME_SENTINEL)])
    banked = xa.reshape(-1, n, n, d // n).transpose(1, 2)
    ec_pad = ec + (-ec % n)
    into = xa.new_zeros((ec_pad, n, d // n))
    sched = BurstScheduler(fabric, stats=stats)
    sched.enqueue_write("moe/dispatch", banked, scatter=sidx, into=into)
    pool = sched.flush()["moe/dispatch"]                     # [EC_pad, N, d/N]
    return pool.reshape(ec_pad, d)[:ec]


def _gather_slots(fabric: Fabric, y: torch.Tensor, keep: torch.Tensor,
                  slot: torch.Tensor,
                  stats: Optional[SchedulerStats]) -> torch.Tensor:
    """One sparse-extent read burst: the pool ``y [E*C, d]`` is the backing
    line stream and each assignment gathers its slot's frame (dropped
    assignments and pad rows gather the sentinel → zero frames, matching
    the masked route).  The adjoint of :func:`_scatter_slots` at the same
    indices, and it of this: live slots are unique."""
    n = fabric.n_ports
    ec, d = y.shape
    k_tot = slot.shape[0]
    src = y
    if ec % n:
        src = torch.cat([src, y.new_zeros((-ec % n, d))])
    lines = src.reshape(-1, n, d // n)
    gidx = torch.where(keep, slot, FRAME_SENTINEL).to(torch.int32)
    pad = -k_tot % n
    if pad:
        gidx = torch.cat([gidx, gidx.new_full((pad,), FRAME_SENTINEL)])
    sched = BurstScheduler(fabric, stats=stats)
    sched.enqueue_read("moe/combine", lines, gather=gidx)
    banked = sched.flush()["moe/combine"]                   # [K/N, N, N, d/N]
    return banked.transpose(1, 2).reshape(-1, d)[:k_tot]


class _SlotScatter(torch.autograd.Function):
    """:func:`_scatter_slots` under autograd; the backward gathers the
    gradient pool's frames at the same slots (the read burst)."""

    @staticmethod
    def forward(ctx, xa, keep, slot, ec, fabric, stats):
        ctx.save_for_backward(keep, slot)
        ctx.fabric = fabric
        return _scatter_slots(fabric, xa, keep, slot, ec, stats)

    @staticmethod
    def backward(ctx, grad):
        keep, slot = ctx.saved_tensors
        with kl.backward_launches():
            g = _gather_slots(ctx.fabric, grad.contiguous(), keep, slot, None)
        return g, None, None, None, None, None


class _SlotGather(torch.autograd.Function):
    """:func:`_gather_slots` under autograd; the backward scatters the
    gradient frames into a zeroed pool at the same slots (the write
    burst)."""

    @staticmethod
    def forward(ctx, y, keep, slot, fabric, stats):
        ctx.save_for_backward(keep, slot)
        ctx.fabric, ctx.ec = fabric, y.shape[0]
        return _gather_slots(fabric, y, keep, slot, stats)

    @staticmethod
    def backward(ctx, grad):
        keep, slot = ctx.saved_tensors
        with kl.backward_launches():
            g = _scatter_slots(ctx.fabric, grad.contiguous(), keep, slot,
                               ctx.ec, None)
        return g, None, None, None, None


def _burst_dispatch(fabric: Fabric, xt: torch.Tensor, tok: torch.Tensor,
                    keep: torch.Tensor, slot: torch.Tensor, ec: int,
                    stats: Optional[SchedulerStats]) -> torch.Tensor:
    """Dispatch as one sparse-extent write burst: the per-assignment token
    buffer ``xt[tok] [T*k, d]`` scatters into the ``[E*C, d]`` slot pool
    (:func:`_scatter_slots`; through :class:`_SlotScatter` when it needs a
    gradient)."""
    xa = xt.index_select(0, tok)                             # [T*k, d]
    if xa.requires_grad and torch.is_grad_enabled():
        return _SlotScatter.apply(xa, keep, slot, ec, fabric, stats)
    return _scatter_slots(fabric, xa, keep, slot, ec, stats)


def _burst_combine(fabric: Fabric, y: torch.Tensor, keep: torch.Tensor,
                   slot: torch.Tensor,
                   stats: Optional[SchedulerStats]) -> torch.Tensor:
    """Combine as one sparse-extent read burst per assignment
    (:func:`_gather_slots`; through :class:`_SlotGather` when it needs a
    gradient)."""
    if y.requires_grad and torch.is_grad_enabled():
        return _SlotGather.apply(y, keep, slot, fabric, stats)
    return _gather_slots(fabric, y, keep, slot, stats)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the ``k`` largest along the last axis, in
    descending order, ties to the lowest index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _assign(p, xt: torch.Tensor, cfg):
    """The router's decision for tokens ``xt [T, d]``: ``(top_p [T, k]``
    renormalised, ``top_e [T, k]``, ``keep [T*k]``, ``slot [T*k]``,
    ``cap)``.  A dropped assignment's slot is ``E_pad * C`` (out of
    range)."""
    m = cfg.moe
    t = xt.shape[0]
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)      # [T, E]
    top_p, top_e = _top_k(probs, m.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    a = top_e.reshape(-1)                                         # [T*k]
    # rank within expert via stable sort (even static partition → capacity)
    order = torch.argsort(a, stable=True)
    a_sorted = a[order]
    first = torch.searchsorted(a_sorted, a_sorted, right=False)
    rank = torch.empty_like(a)
    rank[order] = torch.arange(a.shape[0], device=a.device) - first
    cap = int(t * m.top_k * m.capacity_factor / m.n_experts) or 1
    keep = rank < cap
    slot = torch.where(keep, a * cap + rank, m.n_experts_padded * cap)
    return top_p, top_e, keep, slot, cap


def moe_apply(p, x: torch.Tensor, cfg,
              stats: Optional[SchedulerStats] = None,
              payload: Optional[str] = None) -> torch.Tensor:
    """``x [B, S, d]`` → the MoE FFN's output, top-k routing with capacity
    ``C = int(B*S*k*capacity_factor/E) or 1`` over every row given (dead
    slots included, as the reference).

    With ``moe.pad_to`` the expert axis carries dead experts the router
    never selects (its logits cover the real experts only).  ``payload``:
    ``"burst"`` (the default when the fabric banks and ``d_model`` splits
    across its ports) moves dispatch and combine as sparse-extent
    :class:`BurstScheduler` streams; ``"route"`` through ``Fabric.route``
    gathers.  The two are bit-identical.  ``stats`` (or the ambient
    :func:`dispatch_stats` sink) receives the burst accounting and
    ``tokens_dropped``."""
    m = cfg.moe
    fabric = Fabric.for_model(cfg)
    e_pad = m.n_experts_padded
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    if stats is None:
        stats = _DISPATCH_STATS
    if payload is None:
        payload = ("burst" if fabric.banks_kv and d % fabric.n_ports == 0
                   else "route")

    top_p, _, keep, slot, cap = _assign(p, xt, cfg)
    _count_dropped(stats, keep)
    k_tot = t * m.top_k
    if payload == "burst":
        tok = torch.arange(k_tot, device=x.device) // m.top_k
        buf = _burst_dispatch(fabric, xt, tok, keep, slot, e_pad * cap,
                              stats)
    else:
        # the route reference: the payload moves through gathers only; the
        # scatter touches indices (a dropped slot lands past the end)
        inv = torch.full((e_pad * cap + 1,), k_tot, dtype=torch.long,
                         device=x.device)
        inv.scatter_(0, slot, torch.arange(k_tot, device=x.device))
        inv = inv[:-1]
        src_tok = torch.clamp(inv // m.top_k, 0, t - 1)
        buf = torch.where((inv < k_tot)[:, None], fabric.route(xt, src_tok),
                          0)
    buf = buf.reshape(e_pad, cap, d)

    # the expert FFN (swiglu): three batched products over the experts
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    y = torch.bmm(h, p["w_out"]).reshape(e_pad * cap, d)

    # combine: gather per assignment, weight, and reduce over the (static,
    # consecutive) top-k axis
    if payload == "burst":
        gathered = _burst_combine(fabric, y, keep, slot, stats)
    else:
        gathered = torch.where(
            keep[:, None],
            fabric.route(y, torch.clamp(slot, 0, e_pad * cap - 1)), 0)
    w = top_p.reshape(-1)[:, None].to(x.dtype)
    out = (gathered * w).reshape(t, m.top_k, d).sum(dim=1)
    return out.reshape(b, s, d)


def aux_load_balance_loss(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss: ``E * sum(frac * imp)``,
    ``frac`` the share of all ``T*k`` top-k assignments each expert
    receives and ``imp`` its mean router probability."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(t, -1).float() @ p["router"], dim=-1)
    top_e = _top_k(probs, m.top_k)[1]                             # [T, k]
    frac = F.one_hot(top_e, m.n_experts).float().mean(dim=(0, 1))
    imp = probs.mean(dim=0)
    return m.n_experts * torch.sum(frac * imp)
