"""Per-op cost breakdown of a step, and where the card's time goes (port
of ``repro.launch.profile``).

``breakdown(costs)`` returns the byte/flop/collective contribution of
every op line of :func:`repro_torch.launch.hlo_analysis.analyze_step`'s
census (the same model), sorted by HBM traffic.  ``device_census`` times
a step on the card with ``torch.profiler``: the device's busy share of the
window and the device time by kernel, which no count of bytes can give.

CLI:  PYTHONPATH=src python -m repro_torch.launch.profile --arch <id>
          --shape <s> [--multi-pod] [--set key=value ...] [--top 15]
          [--device meta|cuda] [--batch B] [--seq S]

The default ``meta`` works from shapes alone, as the reference lowers
without running.  ``--device cuda`` runs the step on the card (random
weights from seed 0, zero inputs) and adds :func:`device_census`'s times;
without a card it raises.  ``--batch`` and ``--seq`` cut the shape's
scale (a full-width ``decode_32k`` cache alone outgrows one card).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.launch.hlo_analysis import HloCosts
from repro_torch.launch.mesh import HBM_BW, LINK_BW


@dataclasses.dataclass
class OpCost:
    op: str
    line: str
    bytes: float = 0
    flops: float = 0
    collective_bytes: float = 0


def breakdown(costs: HloCosts):
    """→ (list[OpCost] sorted by bytes desc, totals dict); the totals
    equal ``costs``' own."""
    ops = sorted((OpCost(op, line, b, f, c)
                  for line, (op, b, f, c, _) in costs.lines.items()),
                 key=lambda c: -c.bytes)
    totals = {
        "bytes": sum(c.bytes for c in ops),
        "flops": sum(c.flops for c in ops),
        "collective_bytes": sum(c.collective_bytes for c in ops),
    }
    return ops, totals


def print_breakdown(costs, totals, top: int = 15,
                    hbm_bw: float = HBM_BW, link_bw: float = LINK_BW):
    print(f"memory {totals['bytes']:.3e} B = {totals['bytes']/hbm_bw:.4f}s | "
          f"flops {totals['flops']:.3e} | "
          f"collective {totals['collective_bytes']:.3e} B = "
          f"{totals['collective_bytes']/link_bw:.4f}s")
    for c in costs[:top]:
        share = c.bytes / totals["bytes"] * 100 if totals["bytes"] else 0
        print(f"{c.bytes:10.3e} ({share:4.1f}%) {c.op:18s} {c.line[:78]}")


_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx")


def device_census(step, warm: int = 4, steps: int = 8) -> dict:
    """``torch.profiler`` over ``steps`` calls of ``step()`` on the card
    (after ``warm`` unprofiled ones): the host's wall time of the window,
    the device's busy time in it (the union of the kernels' intervals) and
    its share, kernels, launch calls and aten ops per step, and the device
    time by kernel (``by_kernel``: ``(name, launches, us)`` over the
    window, longest first); ``table`` is the profiler's own table.  Raises
    without a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_census needs a CUDA card: "
                           "torch.cuda.is_available() is false")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = list(prof.events())
    dev_ev = [e for e in events if e.device_type == DeviceType.CUDA]
    cpu_ev = [e for e in events if e.device_type == DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_ev)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                       # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kernel: dict = {}
    for e in dev_ev:
        c, t = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (c + 1, t + e.time_range.elapsed_us())
    return {
        "steps": steps,
        "wall_ms": wall_us / 1e3,
        "step_ms": wall_us / steps / 1e3,
        "busy_ms": busy / 1e3,
        "busy_share": busy / wall_us,
        "kernels_per_step": len(dev_ev) / steps,
        "launch_calls_per_step": sum(e.name in _LAUNCH_CALLS
                                     for e in cpu_ev) / steps,
        "aten_ops_per_step": sum(e.name.startswith("aten::")
                                 for e in cpu_ev) / steps,
        "by_kernel": sorted(((name, c, t) for name, (c, t)
                             in by_kernel.items()), key=lambda x: -x[2]),
        "table": prof.key_averages().table(sort_by="self_cpu_time_total",
                                           row_limit=60),
    }


def _overrides(pairs) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        out[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.isdigit() else v)
    return out


def main(argv=None):
    import argparse
    import subprocess

    from repro_torch.configs import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import cell_config, step_inputs
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", nargs="*", default=[],
                    help="config overrides key=value (e.g. kv_layout=fused)")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"])
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length in place of the shape's")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card: "
                           "torch.cuda.is_available() is false")
    cfg = cell_config(args.arch, args.shape)
    overrides = _overrides(args.set)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[args.shape]
    shape = dataclasses.replace(
        shape, global_batch=args.batch or shape.global_batch,
        seq_len=args.seq or shape.seq_len)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device="meta")
    built = build_step(cfg, shape, mesh)
    if args.device == "meta":               # the dry run's kernels-off arm
        was = ops.kernels_enabled()
        ops.use_kernels(False)
        try:
            _, costs = analyze_step(built.fn, *step_inputs(built, cfg, shape,
                                                           "meta"))
        finally:
            ops.use_kernels(was)
    else:
        step_args = step_inputs(built, cfg, shape, "cuda")
        _, costs = analyze_step(built.fn, *step_args)
    print(f"{args.arch} {shape.name} ({shape.global_batch} x "
          f"{shape.seq_len}) on {args.device}: {sum(costs.op_counts.values())}"
          f" ops, {costs.stand_ins} stand-ins, peak live "
          f"{costs.peak_bytes:.3e} B")
    ranked, totals = breakdown(costs)
    print_breakdown(ranked, totals, top=args.top)
    if args.device == "cuda":
        census = device_census(lambda: built.fn(*step_args), warm=2, steps=4)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"device: {census['step_ms']:.3f} ms a step under the "
              f"profiler, busy {census['busy_ms']:.3f} of "
              f"{census['wall_ms']:.3f} ms ({100 * census['busy_share']:.2f} "
              f"%), {census['kernels_per_step']:.1f} kernels and "
              f"{census['aten_ops_per_step']:.1f} aten ops a step; {card}")
        for name, calls, us in census["by_kernel"][:args.top]:
            print(f"{us / census['steps'] / 1e3:9.4f} ms/step "
                  f"{calls / census['steps']:7.1f} launches/step  "
                  f"{name[:100]}")
    return costs


if __name__ == "__main__":
    main()
