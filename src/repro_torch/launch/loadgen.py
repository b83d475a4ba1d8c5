"""Production-shaped load generator: ``python -m repro_torch.launch.loadgen``
(port of ``repro.launch.loadgen``).

Replays a seeded traffic trace (:mod:`repro_torch.serving.traffic` —
Poisson or bursty-diurnal arrivals, heavy-tailed lognormal
prompt/generation lengths, a weighted priority-class mix, an SLO-deadline
mix) against the continuous-batching engine, and reports per-class TTFT /
TPOT / queue-wait percentiles, goodput and the shed/SLO census alongside
the fabric's ``SchedulerStats``.  Runs on the CUDA device (``--device
cpu`` runs the plain kernel versions on the CPU) with random weights drawn
from seed 0; the trace draws from ``--seed``.

``--replicas N`` serves the same trace through an in-process N-replica
fleet behind a least-loaded router.  ``--soak`` runs the trace twice —
fault-free, then under a seeded
:class:`~repro_torch.runtime.fault_tolerance.FaultInjector` (mid-step
failures, pool exhaustion, corrupted swap bursts) — and asserts the two
runs converge token-exact with zero page leaks (``PagePool.check`` at
drain); a soak failure exits non-zero.  Every run appends a record to
``--bench-out`` (an append-only trajectory, by default
``chiprun_out/loadgen_serving.json``; ``--no-bench`` skips), with the
``torch`` and CUDA versions and, on a card, its name and power limit;
``--trace-out``/``--trace-in`` round-trip the trace itself for bit-exact
replay, in the same JSON form as the reference's.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.registry import SMOKE_ONLY
from repro_torch.models import api
from repro_torch.runtime import FaultInjector
from repro_torch.serving import (ReplicaRouter, ServingEngine, TrafficConfig,
                                 drive, fault_soak, generate_trace,
                                 load_trace, save_trace, trace_t_max)

BENCH_OUT = os.path.join("chiprun_out", "loadgen_serving.json")


def _git_sha() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))),
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return "unknown"


def _card(device: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60)
        smi = out.stdout.strip() if out.returncode == 0 \
            else f"nvidia-smi failed: {out.stderr.strip()}"
    except OSError as e:
        smi = f"nvidia-smi failed: {e}"
    return {"name": torch.cuda.get_device_name(index),
            "name_power_limit": smi}


def _append_run(path: str, run: dict) -> None:
    """Append-only trajectory: keep every prior run record, never overwrite
    an unreadable file."""
    history = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                old = json.load(f)
        except (OSError, json.JSONDecodeError):
            old = None
        if isinstance(old, dict) and isinstance(old.get("runs"), list):
            history = old["runs"]
        elif old is not None:
            aside = path + ".corrupt"
            os.replace(path, aside)
            print(f"# warning: {path} was not a recognized trajectory; "
                  f"moved to {aside}")
    history.append(run)
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"runs": history}, f, indent=2, sort_keys=True)


def _census(stats: dict) -> dict:
    """The SchedulerStats fields the serving trajectory tracks."""
    keys = ("preemptions", "swap_bursts", "bursts_retried",
            "faults_recovered", "requests_shed", "shed_queue_full",
            "shed_deadline", "slo_missed_served", "slo_missed_shed",
            "aging_promotions", "prefill_bursts", "network_calls",
            "words_moved", "words_live")
    return {k: stats.get(k, 0) for k in keys}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-15b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    # traffic shape
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "diurnal"])
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per engine step")
    ap.add_argument("--prompt-mean", type=float, default=10.0)
    ap.add_argument("--prompt-max", type=int, default=24)
    ap.add_argument("--gen-mean", type=float, default=8.0)
    ap.add_argument("--gen-max", type=int, default=16)
    ap.add_argument("--classes", type=int, default=3,
                    help="priority classes (weighted toward class 0)")
    ap.add_argument("--deadline-frac", type=float, default=0.0,
                    help="fraction of requests carrying an SLO deadline")
    ap.add_argument("--deadline-slack", type=float, default=3.0,
                    help="deadline = arrival + slack * (gen_len + 2); "
                         "< 1.0 is provably unmeetable (born shed)")
    ap.add_argument("--trace-in", default=None,
                    help="replay a saved trace instead of generating one")
    ap.add_argument("--trace-out", default=None,
                    help="save the generated trace for bit-exact replay")
    # engine shape
    ap.add_argument("--max-slots", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="0 = the dense reservation's worth; size it below "
                         "demand to exercise oversubscription")
    ap.add_argument("--preempt", default=None,
                    choices=[None, "swap", "recompute", "off"])
    ap.add_argument("--swap-space-pages", type=int, default=None)
    ap.add_argument("--aging", type=int, default=0,
                    help="anti-starvation aging quantum: queued wait boosts "
                         "effective priority one class per this many steps "
                         "(0 = strict priority order)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded submit queue: overflow sheds with "
                         "backpressure (0 = unbounded)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through an in-process N-replica fleet "
                         "behind a least-loaded router")
    ap.add_argument("--check-pool", action="store_true", default=True)
    ap.add_argument("--max-steps", type=int, default=10_000)
    # fault soak
    ap.add_argument("--soak", action="store_true",
                    help="run the trace fault-free AND fault-injected, "
                         "asserting token-exact convergence + zero page "
                         "leaks at drain")
    ap.add_argument("--soak-p-fail", type=float, default=0.02)
    ap.add_argument("--soak-p-exhaust", type=float, default=0.05)
    ap.add_argument("--soak-corrupt", type=int, default=1)
    # trajectory
    ap.add_argument("--bench-out", default=BENCH_OUT,
                    help="the append-only trajectory file of run records")
    ap.add_argument("--no-bench", action="store_true")
    args = ap.parse_args(argv)
    if args.arch in SMOKE_ONLY and not args.smoke:
        ap.error(f"--arch {args.arch} is served at --smoke only: its full "
                 f"config fits no single card")
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 products in full precision, as the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrafficConfig(
        seed=args.seed, n_requests=args.requests, arrival=args.arrival,
        rate=args.rate, prompt_mean=args.prompt_mean,
        prompt_max=args.prompt_max, gen_mean=args.gen_mean,
        gen_max=args.gen_max, classes=args.classes,
        deadline_frac=args.deadline_frac,
        deadline_slack=args.deadline_slack, vocab=cfg.vocab_size)
    if args.trace_in:
        trace = load_trace(args.trace_in)
    else:
        trace = generate_trace(tcfg)
    if args.trace_out:
        save_trace(args.trace_out, trace)
    t_max = trace_t_max(trace)
    params = api.init_params(cfg, seed=0, device=device)

    def make_engine(fault_injector=None):
        def one(inj):
            return ServingEngine(
                cfg, params, max_slots=args.max_slots, t_max=t_max,
                page_size=args.page_size, pool_pages=args.pool_pages,
                preempt=args.preempt,
                swap_space_pages=args.swap_space_pages,
                check_pool=args.check_pool, fault_injector=inj,
                aging=args.aging, max_queue=args.max_queue)
        if args.replicas > 1:
            # one injector instance drives the whole fleet — fault ordinals
            # interleave deterministically because step() is lockstep
            return ReplicaRouter([one(fault_injector)
                                  for _ in range(args.replicas)])
        return one(fault_injector)

    n_dead = sum(t.deadline is not None for t in trace)
    print(f"arch={cfg.name} device={device} trace: {len(trace)} requests "
          f"over {max(t.arrival_step for t in trace) + 1} arrival steps "
          f"({args.arrival}, rate {args.rate}), {args.classes} classes, "
          f"{n_dead} deadlined; t_max={t_max}, "
          f"{args.replicas} replica(s), aging={args.aging}, "
          f"max_queue={args.max_queue or 'unbounded'}")

    t0 = time.time()
    if args.soak:
        horizon = args.max_steps
        inj = FaultInjector.seeded(args.seed, min(horizon, 4096),
                                   p_fail=args.soak_p_fail,
                                   p_exhaust=args.soak_p_exhaust,
                                   n_corrupt=args.soak_corrupt)
        ref_rec, rec, target = fault_soak(make_engine, trace, inj,
                                          max_steps=args.max_steps)
        mode = "soak"
        print("fault soak: token-exact vs fault-free run, zero page "
              "leaks at drain (pool.check clean)")
    else:
        target = make_engine()
        rec = drive(target, trace, max_steps=args.max_steps)
        mode = "drive"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0

    stats = (target.stats() if isinstance(target, ReplicaRouter)
             else {f.name: getattr(target.fabric_stats, f.name)
                   for f in dataclasses.fields(target.fabric_stats)})
    report = rec.report()
    agg = report["aggregate"]
    print(rec.format_table())
    print(f"served {agg['served']}/{agg['n']} requests "
          f"({agg['tokens']} tokens) in {dt:.2f}s; "
          f"{agg['shed']} shed ({stats['shed_queue_full']} queue-full, "
          f"{stats['shed_deadline']} unmeetable-deadline); "
          f"SLO misses {stats['slo_missed_served']} served late + "
          f"{stats['slo_missed_shed']} shed; "
          f"{stats['aging_promotions']} aging promotions")
    print(f"degradation census: {stats['preemptions']} preemptions, "
          f"{stats['swap_bursts']} swap bursts, "
          f"{stats['bursts_retried']} bursts retried, "
          f"{stats['faults_recovered']} faults recovered")
    starved = rec.starved()
    if starved:
        print(f"STARVED (neither retired nor shed): rids {starved}")
        sys.exit(1)

    if not args.no_bench and args.bench_out:
        run_record = {
            "git_sha": _git_sha(),
            "date": datetime.datetime.now(
                datetime.timezone.utc).isoformat(),
            "hostname": socket.gethostname(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": str(device),
            "mode": mode,
            "workload": {
                "arch": cfg.name, "traffic": dataclasses.asdict(tcfg),
                "t_max": t_max, "max_slots": args.max_slots,
                "page_size": args.page_size, "pool_pages": args.pool_pages,
                "preempt": args.preempt, "aging": args.aging,
                "max_queue": args.max_queue, "replicas": args.replicas,
                "wall_s": dt},
            "cells": dict(report, census=_census(stats)),
        }
        if device.type == "cuda":
            run_record["card"] = _card(device)
        _append_run(args.bench_out, run_record)
        print(f"# appended run to {args.bench_out}")


if __name__ == "__main__":
    main()
