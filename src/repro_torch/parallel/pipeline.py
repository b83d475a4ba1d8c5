"""Pipeline parallelism: a GPipe-style microbatch pipeline (port of
``repro.parallel.pipeline``).

The reference keeps its stages on a ``pipe`` mesh axis and moves the
activations stage to stage with ``lax.ppermute`` inside ``shard_map``.
Here the P stages are a list, run in turn on the run's one device, and
the shift is a list rotation that does not wrap.  The schedule is the
reference's: ``M + P - 1`` ticks for M microbatches over P stages (bubble
fraction ``(P-1)/(M+P-1)``); microbatch ``m`` occupies stage ``s`` at tick
``m + s``.  Autograd through the ticks gives the reversed pipeline for
the backward pass.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def pipeline_forward(stage_fn: Callable, stage_params: Sequence,
                     microbatches: torch.Tensor) -> torch.Tensor:
    """Run ``microbatches [M, mb, ...]`` through ``P = len(stage_params)``
    pipelined stages; ``stage_fn(stage_params[s], x) -> y`` is stage
    ``s``'s compute.  Returns the last stage's ``[M, mb, ...]`` outputs.

    At each tick stage 0 takes microbatch ``t`` while ``t < M`` (after
    that it runs on what it holds), every stage computes, the last stage
    emits, and each stage's output moves to the next; stage 0 receives
    zeros, as a ``ppermute`` gives a rank that no pair targets."""
    p = len(stage_params)
    m = microbatches.shape[0]
    held = [torch.zeros_like(microbatches[0]) for _ in range(p)]
    emits = []
    for t in range(m + p - 1):
        if t < m:
            held[0] = microbatches[t]
        held = [stage_fn(w, h) for w, h in zip(stage_params, held)]
        emits.append(held[-1])
        held = [torch.zeros_like(held[0])] + held[:-1]
    # microbatch m finishes at tick m + p - 1 on the last stage
    return torch.stack(emits[p - 1:])


def pipeline_loss(stage_fn: Callable, loss_fn: Callable, stage_params,
                  microbatches: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """Mean of ``loss_fn(out, target)`` over the microbatches;
    differentiable → the pipelined backward."""
    outs = pipeline_forward(stage_fn, stage_params, microbatches)
    return torch.stack([loss_fn(o, t) for o, t in zip(outs, targets)]).mean()


def bubble_fraction(num_microbatches: int, num_stages: int) -> float:
    """Pipeline bubble overhead of the schedule."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
