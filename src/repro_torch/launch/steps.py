"""The train step on one device (port of the training part of
``repro.launch.steps``: ``build_train_step`` and ``_auto_grad_accum``).

The reference's step is a pjit function over a mesh whose parameter,
optimizer-state and batch shardings this module also builds; on one card
there is nothing to shard, and the mesh builders, the serving steps and
the parameter specs belong to the multi-device path (ROADMAP §1 item 8b).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.convert import param_list
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.models import api
from repro_torch.optim import adamw_update


@dataclasses.dataclass
class BuiltStep:
    fn: Callable                  # (state, batch) -> (state, metrics)
    input_specs: dict             # the batch's TensorSpecs
    grad_accum: int               # microbatches per step


def _auto_grad_accum(cfg: ModelConfig, shape: ShapeConfig, dp: int = 1,
                     tp: int = 1, budget_bytes: float = 4e9) -> int:
    """Microbatch count so the activation residuals fit the budget (the
    reference's estimate: the layer carries ``B_loc x S x d_model`` bf16
    per layer plus float32 logits and their gradient over the local vocab
    shard; ``dp`` and ``tp`` are the data and model axis sizes, 1 on one
    card)."""
    b_loc = max(shape.global_batch // dp, 1)
    tokens = b_loc * shape.seq_len
    resid = tokens * cfg.d_model * 2 * cfg.n_layers
    vshard = -(-cfg.vocab_size // tp)
    logits = tokens * vshard * 4 * 2          # logits + grad copy
    need = resid + logits
    accum = 1
    while need / accum > budget_bytes and accum < shape.global_batch // dp:
        accum *= 2
    return accum


def _on_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, shape: ShapeConfig,
                     tcfg: Optional[TrainConfig] = None) -> BuiltStep:
    """The full training step: the (accumulated) loss, its gradients and
    one AdamW update, ``fn(state, batch) -> (state, metrics)`` with
    ``state = {"params", "opt"}`` (an ``OptState``) and ``metrics =
    {"loss", "grad_norm", "lr"}`` (float32 scalars on the device).

    The step sets ``requires_grad`` on the parameters (the serving paths
    never do) and takes the gradients with ``torch.autograd.grad``; the
    parameters and the optimizer state then change in place.  With
    ``grad_accum > 1`` (0 picks it by :func:`_auto_grad_accum`) the batch
    splits into that many microbatches along its first axis, their
    gradients summed in float32 and divided by the count, the loss their
    mean.  ``tcfg.zero1`` shards the optimizer state over a data axis that
    is of size 1 here, so it changes nothing, as on the reference's 1x1
    mesh."""
    tcfg = tcfg or TrainConfig()
    accum = tcfg.grad_accum or _auto_grad_accum(cfg, shape)

    def loss_and_grads(params, ps, mbatch):
        loss = api.loss_fn(params, mbatch, cfg)
        return loss.detach(), torch.autograd.grad(loss, ps)

    def train_step(state, batch):
        params = state["params"]
        ps = param_list(params)
        for p in ps:
            p.requires_grad_(True)
        batch = _on_device(batch, ps[0].device)
        if accum == 1:
            loss, grads = loss_and_grads(params, ps, batch)
            grads = [g.float() for g in grads]
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in ps]
            losses = []
            for i in range(accum):
                loss_i, g_i = loss_and_grads(
                    params, ps, {k: v[i] for k, v in micro.items()})
                grads = [a + b.float() for a, b in zip(grads, g_i)]
                losses.append(loss_i)
            grads = [g / accum for g in grads]
            loss = torch.stack(losses).mean()
        params, opt, metrics = adamw_update(grads, state["opt"], params,
                                            tcfg)
        return {"params": params, "opt": opt}, {"loss": loss, **metrics}

    return BuiltStep(train_step,
                     make_batch_specs(cfg, shape.global_batch, shape.seq_len,
                                      kind="train"),
                     accum)
