"""Interval arithmetic over a device trace, frozen here.

The union is that of ``repro_torch.launch.profile.device_census`` as it
stood when the benchmark was defined: device operations sorted by start,
each adding what it covers past the furthest end seen so far.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the ``(start, end)`` spans."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(spans: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no span covers, in order."""
    out, cur = [], lo
    for a, b in sorted(spans):
        if b <= cur:
            continue
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
