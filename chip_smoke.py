#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any fault exits non-zero):

1. device — print ``nvidia-smi``'s name and power limit; no CUDA, no run;
2. build  — compile the port's CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel);
3. kernels — hold each kernel bit for bit against its plain PyTorch version
   on the card, at the serving path's shapes (stablelm-1.6b: N=32 ports,
   W=32 32-bit words, 24 layers of a 2048-frame pool) and at edge cases
   (sentinels, 16-bit words, N=4); then time kernel, plain version and one
   PyTorch library call (the yardstick the port never calls), CUDA events,
   median of 30 runs;
4. serve — full-width stablelm-1.6b (random bf16 weights from a seed)
   through the port's ServingEngine: 4 requests, prompt 448, gen 64, on the
   fused-gather path and on the gather-after-burst path; the kernel launch
   counts must match the steps, and the two token streams must be equal.
   A smoke config in float32 must agree between the card and the CPU;
5. report — one ``{"kernels": [...]}`` line, the card line again, and the
   ``{"ok": true, ...}`` line last.

``--profile`` adds a ``torch.profiler`` census of the fused path's decode
steps (after the launch counts are read): the device's busy share of the
profiled window and the device time by kernel, printed and written in full
to ``chiprun_out/profile_serve.txt``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
REPS = 30
PROFILE_WARM, PROFILE_STEPS = 4, 8     # --profile: warm-up, profiled steps

# kernel name → (source, reference Pallas kernel it replaces)
KERNELS = {
    "gather_burst_network_tiles": (
        "src/repro_torch/kernels/csrc/gather_burst.cu",
        "src/repro/kernels/medusa_transpose.py:264"),
    "scatter_burst_network_tiles": (
        "src/repro_torch/kernels/csrc/scatter_burst.cu",
        "src/repro/kernels/medusa_transpose.py:330"),
    "burst_network_tiles": (
        "src/repro_torch/kernels/csrc/burst_network.cu",
        "src/repro/kernels/medusa_transpose.py:182"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = REPS) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bit_equal(torch, got, want, what: str) -> int:
    """Fail unless ``got`` and ``want`` hold the same words; returns the
    largest absolute difference of the words (0)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} vs "
          f"{want.dtype} {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    check(err == 0 and torch.equal(got, want),
          f"{what}: kernel disagrees with its plain version (max abs {err})")
    return err


def kernels_phase(torch, dev):
    """Kernel-vs-plain comparisons and timings; returns the rows of the
    kernels line (launch counts filled in by the serve phase)."""
    from repro_torch.models import common as cm
    from repro_torch.kernels import medusa_transpose as mt

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def words(shape, dtype=torch.int32):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(dtype)

    # the serving path's shapes: stablelm-1.6b, 4 slots of 8 pages each on a
    # 32-page pool of 64-timestep pages, 24 layers stacked on the line axis
    n, w, reps, ps, pages = 32, 32, 24, 64, 32
    frames = pages * ps
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(0))
    table = table.reshape(4, 8).numpy().astype("int32")
    live_idx, _, _ = cm.page_live_plan(table, ps, 512, n, bucket=n * ps)
    idx = cm.pool_rep_indices(torch.from_numpy(live_idx).to(dev), reps,
                              frames)
    lines = words((reps * frames, n, w))
    k = idx.shape[0]
    rows = {}

    # -- gather ----------------------------------------------------------------
    got = mt.gather_burst_network_tiles(lines, idx, n)
    err = bit_equal(torch, got, mt.gather_burst_plain(lines, idx, n),
                    "gather (serving shape)")
    valid = int(((idx >= 0) & (idx < lines.shape[0])).sum())
    nbytes = valid * n * w * 4 + k * 4 + k * n * w * 4
    lib_valid = (idx >= 0) & (idx < lines.shape[0])
    lib_idx = torch.where(lib_valid, idx, 0).long()

    def gather_library():
        t = lines.index_select(0, lib_idx) * lib_valid.view(-1, 1, 1)
        return t.view(k // n, n, n, w).transpose(1, 2).contiguous()

    bit_equal(torch, gather_library(), got, "gather library yardstick")
    rows["gather_burst_network_tiles"] = dict(
        max_abs_err=err, bytes=nbytes,
        ms=time_ms(torch, lambda: mt.gather_burst_network_tiles(lines, idx,
                                                                n)),
        plain_ms=time_ms(torch, lambda: mt.gather_burst_plain(lines, idx, n)),
        library_ms=time_ms(torch, gather_library),
        shape=f"lines {list(lines.shape)} int32, idx [{k}]")

    # -- scatter ---------------------------------------------------------------
    g = k // n
    banked = words((g, n, n, w))
    into0 = words((reps * frames, n, w))
    into_k, into_p = into0.clone(), into0.clone()
    mt.scatter_burst_network_tiles(banked, idx, into_k, n)
    mt.scatter_burst_plain(banked, idx, into_p, n)
    err = bit_equal(torch, into_k, into_p, "scatter (serving shape)")
    live = idx[(idx >= 0) & (idx < into0.shape[0])]
    check(live.unique().numel() == live.numel(), "scatter rows not unique")
    nbytes = g * n * n * w * 4 + k * 4 + live.numel() * n * w * 4
    lib_keep = ((idx >= 0) & (idx < into0.shape[0])).nonzero().view(-1)

    def scatter_library():
        src = banked.transpose(1, 2).reshape(k, n, w)
        into_k.index_copy_(0, idx[lib_keep].long(), src[lib_keep])

    rows["scatter_burst_network_tiles"] = dict(
        max_abs_err=err, bytes=nbytes,
        ms=time_ms(torch, lambda: mt.scatter_burst_network_tiles(
            banked, idx, into_k, n)),
        plain_ms=time_ms(torch, lambda: mt.scatter_burst_plain(
            banked, idx, into_p, n)),
        library_ms=time_ms(torch, scatter_library),
        shape=f"banked {list(banked.shape)} int32, into "
              f"{list(into0.shape)}")
    del into0, into_k, into_p, banked

    # -- dense burst (the gather-after-burst path: both K/V pool streams
    #    packed on the word axis) ----------------------------------------------
    tile = words((n, n, 2 * (reps * frames // n) * w))
    got = mt.burst_network_tiles(tile, n)
    err = bit_equal(torch, got, mt.burst_network_plain(tile, n),
                    "burst (serving shape)")
    check(torch.equal(mt.burst_network_tiles(got, n), tile),
          "burst is not an involution")
    rows["burst_network_tiles"] = dict(
        max_abs_err=err, bytes=2 * tile.numel() * 4,
        ms=time_ms(torch, lambda: mt.burst_network_tiles(tile, n)),
        plain_ms=time_ms(torch, lambda: mt.burst_network_plain(tile, n)),
        library_ms=time_ms(torch, lambda: tile.transpose(0, 1).contiguous()),
        shape=f"tile {list(tile.shape)} int32")
    del tile, got, lines

    # -- edge cases: sentinels, 16-bit and 8-bit words, N=4, odd widths -------
    for n_e, dtype, w_e in ((4, torch.int16, 3), (32, torch.int16, 64),
                            (4, torch.uint8, 5), (8, torch.int32, 1)):
        l_e = 6 * n_e
        lines_e = words((l_e, n_e, w_e), dtype)
        perm = torch.randperm(l_e, generator=gen, device=dev)
        sent = torch.tensor([l_e, 2 ** 30], device=dev)
        idx_e = torch.cat([perm[: 2 * n_e], sent.repeat(n_e)])
        idx_e = idx_e[torch.randperm(idx_e.numel(), generator=gen,
                                     device=dev)].to(torch.int32)
        what = f"N={n_e} {dtype} W={w_e}"
        bit_equal(torch, mt.gather_burst_network_tiles(lines_e, idx_e, n_e),
                  mt.gather_burst_plain(lines_e, idx_e, n_e),
                  f"gather edge {what}")
        banked_e = words((idx_e.numel() // n_e, n_e, n_e, w_e), dtype)
        a, b = lines_e.clone(), lines_e.clone()
        mt.scatter_burst_network_tiles(banked_e, idx_e, a, n_e)
        mt.scatter_burst_plain(banked_e, idx_e, b, n_e)
        bit_equal(torch, a, b, f"scatter edge {what}")
        untouched = torch.ones(l_e, dtype=torch.bool, device=dev)
        untouched[perm[: 2 * n_e]] = False
        check(torch.equal(a[untouched], lines_e[untouched]),
              f"scatter edge {what}: untouched rows moved")
        tile_e = words((n_e, n_e, w_e), dtype)
        bit_equal(torch, mt.burst_network_tiles(tile_e, n_e),
                  mt.burst_network_plain(tile_e, n_e), f"burst edge {what}")
    torch.cuda.synchronize()
    for name, r in rows.items():
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        print(f"kernel {name}: {r['shape']}: {r['ms']:.4f} ms (bound "
              f"{r['bound_ms']:.4f} ms for {r['bytes']} bytes, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms)",
              flush=True)
    return rows


def serve(torch, cfg, params, prompts, fused: bool, gen_len: int):
    """Serve ``prompts`` through the port's engine; returns the token
    streams, per-step wall times (synchronised) and the engine."""
    from repro_torch.serving import Request, ServingEngine

    t_max = prompts.shape[1] + gen_len
    eng = ServingEngine(cfg, params, max_slots=len(prompts), t_max=t_max,
                        fused_gather=fused, check_pool=True)
    reqs = [Request(i, prompts[i], max_new_tokens=gen_len)
            for i in range(len(prompts))]
    for r in reqs:
        eng.submit(r)
    steps = []
    while not eng.drained:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        check(eng.step_count < 10 * t_max, "engine did not drain")
    return [r.generated for r in reqs], steps, eng


def profile_serve(torch, cfg, params, prompts) -> None:
    """``torch.profiler`` over ``PROFILE_STEPS`` decode steps of the fused
    path (after ``PROFILE_WARM`` engine steps): device busy share of the
    window (union of kernel intervals over the host's wall time), launches
    and aten ops per step, and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request, ServingEngine

    gen_len = PROFILE_WARM + PROFILE_STEPS + 2
    eng = ServingEngine(cfg, params, max_slots=len(prompts),
                        t_max=prompts.shape[1] + gen_len, fused_gather=True)
    for i in range(len(prompts)):
        eng.submit(Request(i, prompts[i], max_new_tokens=gen_len))
    for _ in range(PROFILE_WARM):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            eng.step()
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
    aten = sum(e.name.startswith("aten::") for e in cpu_ev)
    launches = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                              "cudaLaunchKernelExC", "cuLaunchKernelEx")
                   for e in cpu_ev)
    step_ms = wall_us / PROFILE_STEPS / 1e3
    print(f"profile: {PROFILE_STEPS} fused decode steps, {step_ms:.3f} ms "
          f"per step under the profiler; device busy {busy / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms = {100 * busy / wall_us:.2f} %; "
          f"{len(dev_ev) / PROFILE_STEPS:.1f} device kernels, "
          f"{launches / PROFILE_STEPS:.1f} launch calls and "
          f"{aten / PROFILE_STEPS:.1f} aten ops per step", flush=True)
    check(bool(dev_ev), "the profiler recorded no device kernels")
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    lines = [f"{t / PROFILE_STEPS / 1e3:9.4f} ms/step {c / PROFILE_STEPS:7.1f}"
             f" launches/step  {name}" for name, (c, t) in ranked]
    for line in lines[:12]:
        print(f"profile kernel: {line[:160]}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_serve.txt").write_text(
        "\n".join(lines) + "\n\n" + prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=60) + "\n")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def serve_phase(torch, dev, rows, with_profile: bool):
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.models import api

    cfg = get_config("stablelm-1.6b")
    prompts = SyntheticLM(cfg, batch=4, seq=448, seed=0).batch_at(0)["tokens"]
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"serve: stablelm-1.6b full width ({cfg.param_count()} params, "
          f"bf16) initialised in {time.perf_counter() - t0:.1f}s", flush=True)

    runs = {}
    for fused in (True, False):
        mt.reset_launch_counts()
        toks, steps, eng = serve(torch, cfg, params, prompts, fused, 64)
        counts = mt.launch_counts()
        fs, kv = eng.fabric_stats, eng.kv
        leaf = kv.caches["unit"][0]["k"]
        check(tuple(leaf.shape) == (24, 32, 64, 32, 64)
              and leaf.dtype == torch.bfloat16,
              f"pool leaf {leaf.dtype} {tuple(leaf.shape)}")
        waves = kv.prefill_bursts
        decode_steps = (fs.flushes - waves) // 2
        check(decode_steps == 63 and waves == 1,
              f"expected 63 decode steps in 1 wave, got {decode_steps} "
              f"in {waves}")
        if fused:
            want = {"gather_burst_network_tiles": 2 * decode_steps,
                    "scatter_burst_network_tiles": 2 * decode_steps
                    + 2 * waves,
                    "burst_network_tiles": 0}
        else:
            want = {"gather_burst_network_tiles": 0,
                    "scatter_burst_network_tiles": 0,
                    "burst_network_tiles": 2 * decode_steps + waves}
        check(counts == want, f"fused={fused}: launches {counts} != {want}")
        for name, c in counts.items():
            if c:
                rows[name]["launches"] = c
        flat = [t for s in toks for t in s]
        check(all(len(s) == 64 for s in toks), "short token streams")
        check(all(0 <= t < cfg.vocab_size for t in flat),
              "token outside the vocab")
        logits = eng.last_logits
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        dec = steps[1:]
        tok_s = sum(len(s) for s in toks) / sum(steps)
        print(f"serve fused_gather={fused}: {len(toks)} requests x 64 tokens "
              f"in {sum(steps):.3f}s ({tok_s:.1f} tok/s incl. prefill); "
              f"median decode step {statistics.median(dec) * 1e3:.3f} ms "
              f"over {len(dec)} steps; admission step "
              f"{steps[0] * 1e3:.1f} ms; launches {counts}", flush=True)
        runs[fused] = toks
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    check(runs[True] == runs[False],
          "fused and gather-after-burst paths served different tokens")
    if with_profile:
        profile_serve(torch, cfg, params, prompts)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # card vs CPU on a small input: the smoke config in float32, the same
    # parameters on both devices, one engine step then the whole run
    small = dataclasses.replace(get_smoke("stablelm-1.6b"), dtype="float32")
    p_cpu = api.init_params(small, seed=1, device="cpu")
    p_gpu = api.init_params(small, seed=1, device="cpu").to(dev)
    sp = SyntheticLM(small, batch=3, seq=10, seed=1).batch_at(0)["tokens"]
    from repro_torch.serving import Request, ServingEngine
    engs = {}
    for name, p in (("cpu", p_cpu), ("gpu", p_gpu)):
        e = ServingEngine(small, p, max_slots=3, t_max=18)
        for i in range(3):
            e.submit(Request(i, sp[i], max_new_tokens=6))
        e.step()
        engs[name] = e
    a = engs["gpu"].last_logits.cpu()
    b = engs["cpu"].last_logits
    check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
          f"card vs CPU logits differ by {float((a - b).abs().max())}")
    for e in engs.values():
        e.run_to_completion()
    check([r for r in engs["gpu"].active] == [None] * 3, "smoke not drained")
    print(f"smoke float32 card vs CPU: first-step logits max abs diff "
          f"{float((a - b).abs().max()):.2e} (tolerance 1e-4)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the fused path's decode steps")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA "
             "card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}: run "
             f"it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    card = card_line()
    print(card, flush=True)
    # float32 products in full precision on the card (the reference's
    # numerics); the float32 smoke comparison below depends on it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {len(build.SOURCES)} kernels in "
          f"{time.perf_counter() - t0:.1f}s ({build.BUILD_DIR})", flush=True)

    rows = kernels_phase(torch, dev)
    serve_phase(torch, dev, rows, args.profile)

    line = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        check(r.get("launches", 0) > 0, f"{name} never launched on the path")
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": "bytes", "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
