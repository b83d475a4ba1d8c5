"""Whether what the timed path served is correct, against the plain reference.

Once the window has closed (and the engine is gone), a sample drawn from
the seed of the requests the window finished, the one with the most served
tokens always among them, goes through the reference
(:mod:`bench.reference.decoder`) once: its prompt followed by its served
tokens.  Two numbers, each against the cell file's limit:

- ``served_gap``: the widest gap by which a served token's logit lies
  below the reference's best logit at its position, over every served
  token of the sample, the prefill's first token included.  The engine
  decodes greedily, so a sound program serves the reference's best token
  or one within rounding of it.
- ``logit_err``: the largest difference between a logits row the engine
  itself produced in the window (``engine.last_logits`` of a decode step
  drawn from the seed for each request) and the reference's row at the same
  position, over the sampled requests.  It covers the admission prefill's
  K/V as the write burst installed it, the decode's gather, relabel and
  scatter, decode attention and the head.

The control (``quant="fp8"``) puts the reference in float8 e4m3 in the
program's place: the token it puts first at each position and its rows at
the probes give the same two numbers (``bench/control.py``).
"""

from __future__ import annotations

import gc
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.reference.decoder import forward_logits


def finished(record, t0: float, t1: float) -> list:
    return [r for r in record.requests
            if r.done is not None and t0 <= r.done <= t1]


def sample(record, check: dict, seed: int) -> list:
    """The requests to compare: the finished one with the most served
    tokens, then others in an order drawn from the seed until the sample
    holds ``check["requests"]`` requests."""
    t0 = record.window_start
    done = finished(record, t0, t0 + record.window_s)
    if not done:
        return []
    done.sort(key=lambda r: r.spec.index)
    longest = max(done, key=lambda r: (len(r.served), -r.spec.index))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) % (1 << 64), 2])
    picked = [rest[i] for i in rng.permutation(len(rest)).tolist()]
    return [longest] + picked[:max(0, check["requests"] - 1)]


def reference_rows(cfg: dict, weights: dict, reqs: list, device,
                   quant: Optional[str] = None) -> List[torch.Tensor]:
    """Per request, the reference's logits at the positions that chose its
    served tokens: rows ``[n_served, V]``, row ``j`` scoring token ``j``."""
    seqs, first = [], []
    for r in reqs:
        served = r.served
        toks = np.concatenate([r.spec.prompt,
                               np.asarray(served[:-1], np.int32)])
        seqs.append(torch.as_tensor(toks, device=device))
        first.append(r.prompt_len - 1)
    return forward_logits(cfg, weights.__getitem__, seqs, first, quant=quant)


def served_gap(rows: List[torch.Tensor], tokens: List[List[int]]) -> float:
    """Widest gap of a chosen token's reference logit below the best."""
    worst = 0.0
    for row, toks in zip(rows, tokens):
        t = torch.as_tensor(toks, device=row.device, dtype=torch.long)
        best = row.max(dim=-1).values
        got = row.gather(1, t[:, None])[:, 0]
        worst = max(worst, float((best - got).max()))
    return worst


def logit_err(rows: List[torch.Tensor], reqs: list,
              probes: Optional[List[Optional[torch.Tensor]]] = None) -> float:
    """Largest difference between a probe row and the reference's row at
    its position (``probes`` defaults to the engine's own)."""
    worst = 0.0
    for i, (row, r) in enumerate(zip(rows, reqs)):
        probe = r.probe if probes is None else probes[i]
        if probe is None or r.probe_at is None:
            continue
        ref = row[r.probe_at]
        got = probe[:ref.shape[0]].to(ref.device, torch.float32)
        worst = max(worst, float((got - ref).abs().max()))
    return worst


def judge(cell, record, weights: dict, seed: int, device) -> Dict[str, dict]:
    """``{name: {"value", "limit"}}`` of the cell's compared numbers; a
    window that finished nothing gives none, and is not correct."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    reqs = sample(record, cell.check, seed)
    if not reqs:
        return {}
    rows = reference_rows(cell.config, weights, reqs, device)
    numbers = {"served_gap": served_gap(rows, [r.served for r in reqs]),
               "logit_err": logit_err(rows, reqs)}
    limits = cell.check["limits"]
    return {name: {"value": v, "limit": limits[name]}
            for name, v in numbers.items()}


def control(cell, record, weights: dict, seed: int, device) -> dict:
    """The program's numbers and the fp8 control's on the same sample."""
    reqs = sample(record, cell.check, seed)
    rows = reference_rows(cell.config, weights, reqs, device)
    low = reference_rows(cell.config, weights, reqs, device, quant="fp8")
    picks = [row.argmax(dim=-1).tolist() for row in low]
    probes = [row[r.probe_at] if r.probe_at is not None else None
              for row, r in zip(low, reqs)]
    return {
        "requests": len(reqs),
        "tokens": sum(len(r.served) for r in reqs),
        "program": {"served_gap": served_gap(rows, [r.served for r in reqs]),
                    "logit_err": logit_err(rows, reqs)},
        "control": {"served_gap": served_gap(rows, picks),
                    "logit_err": logit_err(rows, reqs, probes)},
    }
