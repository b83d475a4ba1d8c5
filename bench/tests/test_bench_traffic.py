"""The traffic generator: the same work for every seed, in another order."""

import itertools
import json

import numpy as np
import pytest

from bench.harness import traffic
from bench.tests.conftest import BENCH, TINY_MIX

MIXES = ("long_chat", "repo_complete")


def _mix(name):
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _take(mix, seed, n, vocab=1000):
    return list(itertools.islice(traffic.stream(mix, vocab, seed), n))


@pytest.mark.parametrize("name", MIXES)
def test_sizes_obey_the_laws_and_the_program(name):
    mix = _mix(name)
    pairs = traffic.sizes(mix)
    assert len(pairs) == mix["sizes"]
    t_max = mix["engine"]["t_max"]
    for p, o in pairs:
        assert mix["prompt"]["min"] <= p <= mix["prompt"]["max"]
        assert p <= mix["round_above"] or p % mix["round_to"] == 0
        assert 3 <= o <= mix["output"]["max"]
        assert p + o + 1 <= t_max


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_sends_the_same_rounds_in_the_same_order(name):
    mix = _mix(name)
    n = mix["sizes"]
    a = _take(mix, 2 ** 31 + 11, 2 * n)
    b = _take(mix, 7, 2 * n)
    sizes = [(len(r.prompt), r.max_new_tokens) for r in a]
    assert sizes == [(len(r.prompt), r.max_new_tokens) for r in b]
    assert sizes[:n] == sizes[n:]
    rounds = traffic.rounds(mix)
    for k, pairs in enumerate(rounds):
        lo, hi = k * mix["clients"], (k + 1) * mix["clients"]
        assert sorted(sizes[lo:hi]) == sorted(pairs)
    # each round spans the prompt law: it holds prompts on both sides of
    # the median of all the sizes
    median = sorted(p for p, _ in traffic.sizes(mix))[n // 2]
    for pairs in rounds:
        assert min(pairs)[0] <= median <= max(pairs)[0]


def test_a_seed_gives_the_same_requests():
    a, b = _take(TINY_MIX, 2 ** 40 + 3, 12), _take(TINY_MIX, 2 ** 40 + 3, 12)
    assert all(np.array_equal(x.prompt, y.prompt)
               and x.max_new_tokens == y.max_new_tokens for x, y in zip(a, b))
    c = _take(TINY_MIX, 2 ** 40 + 4, 12)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    assert all(x.prompt.dtype == np.int32 and x.prompt.max() < 1000 for x in a)


def test_sizes_must_fill_whole_rounds():
    with pytest.raises(ValueError):
        traffic.rounds(dict(TINY_MIX, sizes=6))
