"""Reading the device trace of the traced slice of a ``--trace 1`` run.

The slice is the first ``trace_seconds`` of the window (the traffic
file's), under ``torch.profiler`` with CUDA activity only: recording the
host's operations as well would slow the host enough to change how much
of the slice the device sits idle.  So the harness marks each profiled
step on the device timeline itself: a ``torch.cuda._sleep`` launch of one
cycle (the ``spin_kernel`` in the trace) is the first thing each step
enqueues.  From the device's operations:

- the slice's length, from the first marker to the end of the last
  operation, and the device's busy time in it (the union of every
  operation's interval, :func:`bench.yardstick.intervals.union_length`;
  markers left out);
- device time and launches by operation name;
- the longest idle stretches, each labelled by what the host was doing:
  ``client`` when a step's marker ends it (the host was between steps, in
  the harness's bookkeeping), else the kind of the step it fell in
  (``admit_step`` or ``decode_step``).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Sequence, Tuple

from bench.yardstick.intervals import gaps, union_length

MARKER = "spin_kernel"


@dataclasses.dataclass
class TraceData:
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[int, float]]     # name → (launches, seconds)
    idle: List[Tuple[str, float]]         # longest idle stretches, labelled
    steps: int                            # profiled steps

    def kernel_time(self, fragment: str) -> Tuple[int, float]:
        """Launches and device seconds of the operations whose name holds
        ``fragment``."""
        n, s = 0, 0.0
        for name, (c, t) in self.ops.items():
            if fragment in name:
                n, s = n + c, s + t
        return n, s

    def top_ops(self, k: int = 10) -> List[List]:
        return [[short(name), t] for name, (_, t) in
                sorted(self.ops.items(), key=lambda x: -x[1][1])[:k]]


def short(name: str, width: int = 160) -> str:
    """A kernel's name cut to ``width`` characters (templated names run
    to a thousand)."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def device_events(prof) -> List[Tuple[str, float, float]]:
    """``(name, start_us, end_us)`` of every device operation of a
    finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def reduce(events: Sequence[Tuple[str, float, float]],
           admitted: Sequence[bool], top: int = 10) -> TraceData:
    """The slice's numbers from its device ``events`` (microseconds);
    ``admitted[k]`` says whether the slice's ``k``-th step admitted a
    request."""
    marked = sorted((a, b) for name, a, b in events if MARKER in name)
    marks = [a for a, _ in marked]
    work = [(name, a, b) for name, a, b in events if MARKER not in name]
    if not marks:
        raise RuntimeError("the trace holds no step marker")
    lo = marks[0]
    hi = max([b for _, _, b in work] + [lo])
    spans = [(max(a, lo), b) for _, a, b in work if b > lo]
    ops: Dict[str, Tuple[int, float]] = {}
    for name, a, b in work:
        if b > lo:
            c, t = ops.get(name, (0, 0.0))
            ops[name] = (c + 1, t + (b - a) / 1e6)
    # markers bound the idle stretches but are not work
    idle = sorted(gaps(spans + marked, lo, hi),
                  key=lambda g: g[0] - g[1])[:top]
    labelled = []
    for g0, g1 in idle:
        if g1 in marks:
            kind = "client"
        else:
            k = bisect.bisect_right(marks, g0) - 1
            kind = ("admit_step" if 0 <= k < len(admitted) and admitted[k]
                    else "decode_step")
        labelled.append((kind, (g1 - g0) / 1e6))
    return TraceData(window_s=(hi - lo) / 1e6,
                     busy_s=union_length(spans) / 1e6, ops=ops,
                     idle=labelled, steps=len(marks))
