"""AdamW with mixed precision, global-norm clipping and LR scheduling (port
of ``repro.optim.optimizer``), written out as the reference is — no
``torch.optim``.

The state holds float32 first and second moments and, optionally, a
float32 master copy of the (bf16) parameters.  Its leaves are lists in the
order of :func:`repro_torch.convert.param_list`: the reference's sorted-key
leaf order, a stacked ``unit`` leaf's repetitions side by side, so the
global-norm sum adds the leaves in the reference's order.  The update is
the reference's float32 arithmetic, operation for operation (``b1 **
step`` on a float32 step, the cosine floor at 10 % of the peak), as
``torch._foreach_*`` passes over groups of leaves: parameters, moments
and master change in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.convert import param_list, reference_leaves


@dataclasses.dataclass
class OptState:
    """The optimizer state: the int32 ``step`` and float32 ``m``, ``v`` and
    ``master`` (or None), each aligned with ``param_list(params)``.
    ``layout`` records the parameters' reference leaves (``(path,
    tensors, stacked)`` without the tensors), so a checkpoint can key the
    moments by the reference's key strings."""
    step: torch.Tensor
    m: List[torch.Tensor]
    v: List[torch.Tensor]
    master: Optional[List[torch.Tensor]]
    layout: Tuple = ()


def init_opt_state(params, tcfg: TrainConfig, master: bool = True) -> OptState:
    ps = param_list(params)
    dev = ps[0].device
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for p in ps]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=zeros, v=[torch.zeros_like(z) for z in zeros],
        master=([p.detach().float().clone() for p in ps] if master
                else None),
        layout=tuple((path, len(ts), stacked)
                     for path, ts, stacked in reference_leaves(params)))


def lr_schedule(step: torch.Tensor, tcfg: TrainConfig) -> torch.Tensor:
    """Linear warmup → cosine decay to 10 % of the peak (float32)."""
    step = step.float()
    warm = tcfg.lr * step / max(tcfg.warmup_steps, 1)
    frac = torch.clamp((step - tcfg.warmup_steps)
                       / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = tcfg.lr * (0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac)))
    return torch.where(step < tcfg.warmup_steps, warm, cos)


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 l2 norm over every leaf, summed in the leaves' order."""
    total = 0
    for leaf in leaves:
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """Every leaf in float32, scaled by ``min(1, max_norm / norm)``;
    returns ``(grads, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return torch._foreach_mul([g.float() for g in grads], scale), norm


#: elements per group of leaves the update runs its ``torch._foreach_*``
#: passes over (each pass holds one float32 temporary of the group)
_CHUNK = 1 << 28


def _chunks(n_leaves: int, sizes: Sequence[int]):
    """Index ranges of consecutive leaves, each up to :data:`_CHUNK`
    elements (a larger leaf alone)."""
    start, total = 0, 0
    for i in range(n_leaves):
        if total and total + sizes[i] > _CHUNK:
            yield range(start, i)
            start, total = i, 0
        total += sizes[i]
    if start < n_leaves:
        yield range(start, n_leaves)


@torch.no_grad()
def adamw_update(grads: Sequence[torch.Tensor], state: OptState, params,
                 tcfg: TrainConfig):
    """One AdamW step on ``grads`` (aligned with ``param_list(params)``):
    updates the parameters, ``state.m``, ``state.v``, ``state.master`` and
    ``state.step`` in place.  Returns ``(params, state, metrics)`` with
    ``metrics = {"grad_norm", "lr"}`` (float32 scalars).

    The element-wise passes are ``torch._foreach_*`` ops over groups of
    leaves (one launch covers many leaves), each the reference's
    operation in the reference's order; the learning rate and the bias
    corrections, float32 scalars computed as the reference does, cross to
    the host once a step."""
    ps = param_list(params)
    grads32, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(step, tcfg)
    b1, b2 = tcfg.beta1, tcfg.beta2
    one = torch.ones((), dtype=torch.float32, device=step.device)
    bc1 = 1.0 - torch.pow(one * b1, step.float())
    bc2 = 1.0 - torch.pow(one * b2, step.float())
    lr_f, bc1_f, bc2_f = (float(x) for x in torch.stack([lr, bc1, bc2]).cpu())
    for idx in _chunks(len(ps), [p.numel() for p in ps]):
        g = [grads32[i] for i in idx]
        m = [state.m[i] for i in idx]
        v = [state.v[i] for i in idx]
        torch._foreach_mul_(m, b1)                   # b1 m + (1 - b1) g
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        gg = torch._foreach_mul(g, 1 - b2)           # b2 v + (1 - b2) g g
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, gg)
        del gg
        p32 = ([state.master[i] for i in idx] if state.master is not None
               else [ps[i].float() for i in idx])
        den = torch._foreach_div(v, bc2_f)           # sqrt(v / bc2) + 1e-8
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, 1e-8)
        u = torch._foreach_div(m, bc1_f)             # (m / bc1) / den
        torch._foreach_div_(u, den)
        del den
        torch._foreach_add_(u, torch._foreach_mul(p32, tcfg.weight_decay))
        torch._foreach_mul_(u, lr_f)                 # p32 - lr * (u + wd p32)
        new = torch._foreach_sub(p32, u)
        del u
        if state.master is not None:
            torch._foreach_copy_(p32, new)
        torch._foreach_copy_([ps[i] for i in idx], new)
    state.step.copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
