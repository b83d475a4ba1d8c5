"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape) cell and both production meshes
(single-pod (16, 16), multi-pod (2, 16, 16)), build the step (train /
prefill / decode, :func:`repro_torch.launch.steps.build_step`) on
``device="meta"`` (shapes alone, nothing allocated) and run it once under
the cost census (:func:`repro_torch.launch.hlo_analysis.analyze_step`)
with the kernels off, as the reference's dry run sets
``REPRO_NO_KERNELS=1``; then record:

* the arguments' bytes per mesh position (each leaf divided by the sizes
  of the mesh axes its spec names) and the peak of the step's live
  storage bytes as the port runs it;
* the census's FLOPs, HBM bytes and collective bytes, with the op counts
  and the stand-ins answered on meta;
* the three roofline terms and the dominant one, at the H100's rates;
* MODEL_FLOPS = 6·N·D (train) and the useful-compute ratio.

The reference compiles one device's program of the 256 or 512 it needs.
Here every mesh position is the one device and every rank runs in turn,
so the costs are the whole step's: the roofline is taken with
``chips=1`` and ``useful_compute_ratio = model_flops / flops``; ``chips``
names the mesh's positions.  ``run_s`` (the census's run) takes the place
of ``lower_s`` and ``compile_s``; XLA's own cost analysis has no
counterpart.

Results are cached as JSON per cell under ``results/dryrun_torch``
(``--out``), so the sweep resumes; a failure is recorded with its
traceback (a failure here is a fault of the port).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--force] [--list] [--out DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, TrainConfig, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.convert import reference_leaves
from repro_torch.kernels import ops
from repro_torch.launch.hlo_analysis import (analyze_step, model_flops,
                                             roofline_terms)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import BuiltStep, _tree_leaves, build_step
from repro_torch.models import api
from repro_torch.optim import init_opt_state
from repro_torch.parallel.sharding import axis_sizes

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def cell_config(arch: str, shape_name: str) -> ModelConfig:
    """Per-cell config adjustments (the reference's): long_500k always
    runs sequence-parallel so the KV/state shards."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.sharding_profile == "tp_heads":
        cfg = dataclasses.replace(cfg, sharding_profile="sp_seq")
    return cfg


def step_inputs(built: BuiltStep, cfg: ModelConfig, shape: ShapeConfig,
                device, seed: int = 0) -> tuple:
    """The arguments of ``built.fn`` on ``device``: the parameters (random
    from ``seed``; shapes alone on meta), the AdamW state of a train step,
    the caches of a decode step, and every input of ``built.input_specs``
    as zeros."""
    inputs = {name: torch.zeros(spec.shape, dtype=spec.dtype, device=device)
              for name, spec in built.input_specs.items()}
    params = api.init_params(cfg, seed=seed, device=device)
    if shape.kind == "train":
        opt = init_opt_state(params, TrainConfig(), master=False)
        return {"params": params, "opt": opt}, inputs
    if shape.kind == "prefill":
        return params, inputs
    caches = api.init_cache(cfg, shape.global_batch, shape.seq_len,
                            device=device)
    return params, caches, inputs["token"], inputs["pos"]


def _per_position(nbytes: int, spec, sizes: dict) -> int:
    """``nbytes`` of a leaf over the sizes of the mesh axes ``spec``
    names (rounded up)."""
    names = [a for e in (spec or ()) if e is not None
             for a in ((e,) if isinstance(e, str) else e)]
    return -(-nbytes // math.prod(sizes[a] for a in names))


def argument_bytes(built: BuiltStep, args: tuple, shape: ShapeConfig,
                   mesh) -> int:
    """The step's argument bytes at one mesh position, from the specs."""
    sizes = axis_sizes(mesh)
    params = args[0]["params"] if shape.kind == "train" else args[0]
    total = 0
    for path, ts, _ in reference_leaves(params):
        numel = sum(t.numel() for t in ts)
        total += _per_position(numel * ts[0].element_size(),
                               built.param_specs[path], sizes)
        if shape.kind == "train":             # AdamW's float32 moments
            total += sum(_per_position(numel * 4, specs[path], sizes)
                         for specs in (built.opt_specs.m, built.opt_specs.v))
    if shape.kind == "train":
        total += args[0]["opt"].step.element_size()
    if shape.kind == "decode":
        for path, leaf in _tree_leaves(args[1]):
            total += _per_position(leaf.numel() * leaf.element_size(),
                                   built.cache_specs[path], sizes)
    for name, spec in built.input_specs.items():
        total += _per_position(math.prod(spec.shape) * spec.dtype.itemsize,
                               built.batch_specs.get(name, ()), sizes)
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: dict | None = None) -> dict:
    """One cell's record: the step on meta under the census, the kernels
    off for the run (the switch restored after)."""
    cfg = cell_config(arch, shape_name)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    was = ops.kernels_enabled()
    ops.use_kernels(False)
    try:
        t0 = time.time()
        built = build_step(cfg, shape, mesh)
        args = step_inputs(built, cfg, shape, "meta")
        _, costs = analyze_step(built.fn, *args)
        run_s = time.time() - t0
    finally:
        ops.use_kernels(was)
    mf = model_flops(cfg, shape)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": mesh.size,
        "status": "ok",
        "sharding_profile": cfg.sharding_profile,
        "memory": {
            "argument_bytes": argument_bytes(built, args, shape, mesh),
            "peak_bytes": costs.peak_bytes,
        },
        "parsed": costs.as_dict(),
        "roofline": roofline_terms(costs, chips=1),
        "model_flops": mf,
        "useful_compute_ratio": mf / costs.flops if costs.flops else None,
        "run_s": round(run_s, 2),
        "stand_ins": costs.stand_ins,
    }


def cell_path(out: str, arch: str, shape_name: str, multi_pod: bool) -> str:
    mesh = "multi" if multi_pod else "single"
    return os.path.join(out, f"{arch}__{shape_name}__{mesh}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory of the per-cell JSON records")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    todo, done, skipped = [], 0, 0
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if shape_name == "long_500k" and not cfg.subquadratic:
                skipped += 1
                continue
            for mp in meshes:
                path = cell_path(args.out, arch, shape_name, mp)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            done += 1
                            continue
                todo.append((arch, shape_name, mp))

    print(f"dry-run: {len(todo)} to run, {done} cached, "
          f"{skipped} long_500k skips (full-attention archs)")
    if args.list:
        for t in todo:
            print("  ", t)
        return

    for i, (arch, shape_name, mp) in enumerate(todo):
        tag = f"{arch} x {shape_name} x {'2x16x16' if mp else '16x16'}"
        print(f"[{i+1}/{len(todo)}] {tag} ...", flush=True)
        try:
            res = run_cell(arch, shape_name, mp)
            r = res["roofline"]
            print(f"    ok: compute={r['compute_s']:.3e}s "
                  f"memory={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s "
                  f"dominant={r['dominant']} "
                  f"peak={res['memory']['peak_bytes']:.3e}B "
                  f"args/position={res['memory']['argument_bytes']:.3e}B "
                  f"stand-ins {res['stand_ins']} (run {res['run_s']}s)",
                  flush=True)
        except Exception as e:  # record failures — they are faults
            res = {"arch": arch, "shape": shape_name,
                   "mesh": "2x16x16" if mp else "16x16",
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()}
            print(f"    ERROR: {e!r}", flush=True)
        with open(cell_path(args.out, arch, shape_name, mp), "w") as f:
            json.dump(res, f, indent=1, default=str)


if __name__ == "__main__":
    main()
