"""One run of one cell: set-up, the window, the metrics, the check, the
result line."""

from __future__ import annotations

import sys
import time
from typing import List, Tuple

import torch

from bench.harness import check, loop, spec
from bench.harness import trace as trace_mod
from bench.yardstick.model_cost import widths
from bench.yardstick.peaks import peaks_for

# whole top-level module names the run may not have loaded: JAX and the
# JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_kind(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def quarters(record) -> list:
    """Steps taken in each quarter of the window (how steady it ran)."""
    t0, n = record.window_start, [0, 0, 0, 0]
    for s in record.steps:
        n[min(3, int(4 * (s.end - t0) / record.window_s))] += 1
    return n


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Tuple[dict, List[str]]:
    """The result object and the check's lines (name, number, limit)."""
    record, weights, prof = loop.drive(cell, seed, seconds, trace, device,
                                       t_start)
    record.widths = widths(cell.config)
    kind = device_kind(device)
    record.peaks = peaks_for(kind)
    t = time.perf_counter()
    if prof is not None:
        admitted = [s.admitted > 0 for s in record.steps if s.profiled]
        record.trace = trace_mod.reduce(trace_mod.device_events(prof),
                                        admitted)
        del prof
        print(f"trace: {record.trace.steps} steps profiled, read in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = spec.read_metrics(cell, entries, record)
    t = time.perf_counter()
    numbers = check.judge(cell, record, weights, seed, device)
    del weights
    print(f"window: {len(record.steps)} steps, {record.tokens} tokens in "
          f"{record.window_s:.3f} s (steps a quarter: {quarters(record)}); "
          f"work peak {record.work_peak_bytes} B after step "
          f"{record.peak_steps}; check: {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    correct = bool(numbers) and record.failed == 0 and all(
        n["value"] <= n["limit"] for n in numbers.values())
    result = {
        "correct": correct,
        "attempted": record.attempted,
        "failed": record.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if torch.device(device).type == "cuda"
                   else torch.device(device).type,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": record.memory_peak_bytes},
    }
    if record.trace is not None:
        result["device"]["busy_s"] = record.trace.busy_s
        result["device"]["window_s"] = record.trace.window_s
        result["breakdown"] = {
            "device_ops": record.trace.top_ops(10),
            "idle_gaps": [[label, s] for label, s in record.trace.idle]}
    result["check"] = numbers
    lines = [f"{name} {n['value']!r} limit {n['limit']!r}"
             for name, n in numbers.items()]
    if not numbers:
        lines.append("no finished request in the window to compare")
    return result, lines
