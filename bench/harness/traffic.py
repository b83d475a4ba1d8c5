"""The general traffic generator: a traffic file's parameters → requests.

A traffic file (``bench/traffic/<name>.json``) gives a closed loop of
``clients``, the engine's sizes, and two lognormal length laws (``median``,
``sigma``, clipped to ``[min, max]``) for prompts and outputs.  Every seed
serves the same (prompt, output) pairs in the same order, so runs differ
in their token ids (and weights), not in the amount or the arrangement of
the work:

- the ``sizes`` pairs are the laws' quantiles at ``(k + 1/2) / sizes``,
  paired by a fixed shuffle (``pairing_seed``);
- sorted by prompt length, they are dealt round-robin into rounds of
  ``clients`` pairs, so each round spans the prompt law (the first round is
  the wave the clients send at set-up);
- the stream sends the rounds in their order, over and over, and draws
  each prompt's token ids from the seed, uniformly over the vocabulary.

The order is not drawn from the seed: in a closed loop it decides which
prefills share an engine step, and so the latency tails, far more than
two runs of one order differ.

A prompt longer than ``round_above`` is rounded down to a multiple of
``round_to`` (the program's long prefill attends in 1024-key chunks and
takes no other length).  An output is cut so the sequence fits in
``t_max``: prompt + output + 1 <= t_max.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Iterator, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Spec:
    index: int          # position in the run's request stream
    prompt: np.ndarray  # int32 token ids
    max_new_tokens: int


def _quantiles(law: dict, n: int) -> List[int]:
    nd = NormalDist()
    out = []
    for k in range(n):
        z = nd.inv_cdf((k + 0.5) / n)
        x = law["median"] * math.exp(law["sigma"] * z)
        out.append(int(min(max(round(x), law["min"]), law["max"])))
    return out


def sizes(traffic: dict) -> List[Tuple[int, int]]:
    """The (prompt, output) pairs every seed serves, in their fixed
    pairing order."""
    n = traffic["sizes"]
    prompts = _quantiles(traffic["prompt"], n)
    above, step = traffic.get("round_above", 0), traffic.get("round_to", 1)
    prompts = [p - p % step if above and p > above else p for p in prompts]
    outputs = _quantiles(traffic["output"], n)
    order = np.random.default_rng(traffic.get("pairing_seed", 0)) \
        .permutation(n)
    t_max = traffic["engine"]["t_max"]
    return [(p, min(outputs[o], t_max - p - 1))
            for p, o in zip(prompts, order.tolist())]


def rounds(traffic: dict) -> List[List[Tuple[int, int]]]:
    """The pairs dealt into rounds of ``clients``, each spanning the
    prompt law."""
    pairs = sorted(sizes(traffic))
    n = traffic["clients"]
    if len(pairs) % n:
        raise ValueError(f"sizes={len(pairs)} is not a whole number of "
                         f"rounds of {n} clients")
    count = len(pairs) // n
    return [pairs[r::count] for r in range(count)]


def _seed(seed: int) -> int:
    return int(seed) % (1 << 64)


def stream(traffic: dict, vocab: int, seed: int) -> Iterator[Spec]:
    """The run's requests in send order, without end."""
    dealt = rounds(traffic)
    i = 0
    while True:
        for pairs in dealt:
            for p, o in pairs:
                ids = np.random.default_rng([_seed(seed), 1, i]).integers(
                    0, vocab, size=p, dtype=np.int32)
                yield Spec(i, ids, o)
                i += 1
