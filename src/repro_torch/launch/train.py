"""Training CLI: ``python -m repro_torch.launch.train --arch <id> [...]``.

The reference's flags, plus ``--device`` (``cuda`` by default; ``cpu``
runs the kernels' plain versions on the CPU) and ``--layers`` (the depth
cut to that many layers, the widths kept).  Builds the train step over
the mesh, wraps the fault-tolerant runner (checkpoint/restart and
straggler detection) around it, and streams the deterministic synthetic
pipeline.  ``--smoke`` takes the reduced config on a 1x1 mesh (and ignores
``--multi-pod``); otherwise the mesh is the reference's production mesh,
(data=16, model=16) or with ``--multi-pod`` (pod=2, data=16, model=16),
laid over the one device: the batch splits into the rank blocks its
spec gives (batch 8 over ``pod``: 2 blocks of 4), each block's gradient
taken in turn and averaged.  ``--fail-at`` injects node failures at those
steps: the runner restores the latest checkpoint and goes on.
Prints ``step N loss ...`` every ``--log-every`` steps and ``done at step
N; restarts=R, stragglers flagged=F`` at the end.  ``main`` returns the
final state, the runner and ``(step, host clock, loss)`` after each step
(with ``--log-every 1`` the clock is read after the step's loss, so after
the device has finished the step).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import TrainConfig, get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models import api
from repro_torch.optim import init_opt_state
from repro_torch.runtime import (FaultInjector, StragglerDetector,
                                 TrainingRunner)


def make_mesh_for(args, device):
    if args.smoke:
        return make_mesh((1, 1), ("data", "model"), device)
    return make_production_mesh(multi_pod=args.multi_pod, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers, its "
                         "widths kept (0 = the config's depth)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject node failures at these steps (FT demo)")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 products in full precision, as the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_mesh_for(args, device)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tcfg = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps, grad_accum=args.grad_accum,
                       zero1=not args.smoke, checkpoint_dir=args.ckpt_dir,
                       checkpoint_every=args.ckpt_every)
    built = build_train_step(cfg, shape, tcfg, mesh=mesh)

    params = api.init_params(cfg, seed=tcfg.seed, device=device)
    state = {"params": params,
             "opt": init_opt_state(params, tcfg, master=False)}
    start = 0
    ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every, keep=3)
    if args.resume and (last := latest_step(args.ckpt_dir)) is not None:
        state, extra = restore_checkpoint(args.ckpt_dir, last, state)
        start = extra.get("data_step", last)
        print(f"resumed from step {start}")

    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq, seed=tcfg.seed)
    t0 = time.time()
    history = []

    def on_metrics(step, metrics):
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({(time.time() - t0) / max(step - start, 1):.2f}s/step)",
                  flush=True)
        history.append((step, time.perf_counter(), metrics["loss"]))

    runner = TrainingRunner(
        built.fn, data, ckpt, straggler=StragglerDetector(),
        fault_injector=FaultInjector(tuple(args.fail_at)) if args.fail_at
        else None)
    state, end = runner.run(state, start, args.steps, on_metrics=on_metrics)
    print(f"done at step {end}; restarts={runner.restarts}, "
          f"stragglers flagged={runner.straggler.flagged}")
    return state, runner, history


if __name__ == "__main__":
    main()
