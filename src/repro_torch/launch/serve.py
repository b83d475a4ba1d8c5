"""Serving CLI: ``python -m repro_torch.launch.serve --arch <id>
[--engine]``.

Runs on the CUDA device (``--device cpu`` runs the plain kernel versions
on the CPU) with random weights drawn from ``--seed`` and synthetic
prompts.  ``--fabric-impl`` picks the KV fabric (``medusa``, the default;
the ``crossbar`` baseline, which routes every movement through an index
tensor and launches no Medusa kernel; the ``oracle`` permute; or
``fused``, which attends over the line-major cache and banks no KV) in
either mode.  Two modes, as the reference's:

* one-shot (default): ``api.greedy_generate`` over the batch through the
  per-layer decode path, which reads every layer's K/V through the fabric's
  layout engine (one transpose kernel launch per layer for its K and V);
* ``--engine``: the continuous-batching
  :class:`repro_torch.serving.ServingEngine`, whose decode step is
  burst-scheduled — with the fused gather (default) each K/V pool leaf is
  one gather kernel launch and one scatter kernel launch per step;
  ``--no-fused-gather`` banks the whole pool through the dense burst
  kernel instead.  ``--no-paged-pool`` keeps the dense per-slot KV
  reservation, ``--pack`` picks the burst layout, ``--word-fold`` the
  machine-word folding cap, and ``--serve-fsdp`` streams the weights
  through the step's read burst.  A fabric that cannot bank the KV leaves
  (``fused``, or an explicit geometry off one port per KV head) decodes
  through the per-layer paged path.  ``--pool-shards S`` splits the page
  pool into ``S`` shard blocks (pages striped round-robin over them): each
  K/V pool stream then lowers as one gather (scatter) kernel launch per
  shard bridged by one exchange, ``--collective all_to_all`` or its
  ``ring`` of ``S-1`` rotations.  Every shard lives on the one device of
  the run.

Under oversubscription the engine degrades as the reference's does:
``--priority-classes`` spreads the requests over priority classes (request
``i`` gets ``i % P``), ``--preempt {swap,recompute,off}`` picks the victim
policy (swap the victim's pages to the host over the ``swap/*`` streams —
the gather and scatter kernels on the card — or drop them and re-prefill),
``--swap-space-pages`` caps the host swap space, ``--check-pool`` runs the
pool's conservation invariant every step, ``--aging`` turns on
anti-starvation aging, ``--max-queue`` bounds the submit queue, and
``--spec-decode-k`` turns on Medusa-heads speculative decode (the same
token stream, with the acceptance census).

MoE models (``--arch granite-moe-3b-a800m``, ``--arch kimi-k2-1t-a32b``
at ``--smoke`` only) dispatch and combine each MoE layer's tokens over the
sparse bursts: one scatter and one gather kernel launch per layer per
step and per prefill on the card.  A VLM (``--arch internvl2-1b``) puts
its ``n_patches`` stub patch embeddings before the ``--prompt-len`` text
tokens in one-shot mode (``t_max`` counts them); its engine serves the
text alone, as the reference's.  The recurrent and SSM families
(``--arch recurrentgemma-2b``, ``--arch mamba2-780m``) have no
full-attention leaf, so their engine runs without a page pool (the dense
per-slot layout, preemption off) and launches no burst.  The
encoder-decoder (``--arch whisper-medium``) serves one-shot: its encoder
reads the data stub's ``frames`` and each decoder layer's cross K/V go
through the layout engine at prefill; its engine is refused, as the
reference's (decoder-only families).

Prints throughput, the fabric census, the preemption, admission,
MoE-dispatch and speculative-decode censuses (engine) and the kernel
launch counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.registry import SMOKE_ONLY
from repro_torch.data import SyntheticLM
from repro_torch.kernels import medusa_transpose as mt
from repro_torch.models import api, lm
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the architecture")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the requests")
    ap.add_argument("--batch", type=int, default=4,
                    help="requests, and engine slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--engine", action="store_true",
                    help="serve through the paged continuous-batching engine "
                         "(default: one-shot batch generate)")
    ap.add_argument("--kv-layout", "--fabric-impl", dest="kv_layout",
                    default=None,
                    choices=["medusa", "crossbar", "oracle", "fused"],
                    help="the KV fabric's network (default: the config's, "
                         "medusa)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page size in timesteps (0 = fabric default)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="physical pages in the shared pool (0 = "
                         "max_slots * pages_per_slot)")
    ap.add_argument("--paged-pool", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="back the engine's full-attention KV with one "
                         "shared physical page pool (default on); "
                         "--no-paged-pool keeps the dense per-slot "
                         "reservation")
    ap.add_argument("--fused-gather", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="fuse the pool's logical->physical gather into the "
                         "bursts (default on); --no-fused-gather banks the "
                         "whole pool and gathers after the burst")
    ap.add_argument("--pool-shards", type=int, default=0,
                    help="shard the physical page pool over this many "
                         "blocks of a `pool` mesh axis: fused sparse bursts "
                         "lower as per-shard gathers bridged by one "
                         "collective, pages stripe round-robin across "
                         "shards (0 = the config's, 1: off); every shard "
                         "lives on the one device of the run")
    ap.add_argument("--collective", default=None,
                    choices=["all_to_all", "ring"],
                    help="exchange-hop collective of the sharded pool: the "
                         "monolithic all-to-all or the ring of S-1 "
                         "rotations (value-identical)")
    ap.add_argument("--pack", default=None, choices=["packed", "pad"],
                    help="burst layout of the scheduled decode step "
                         "(default: the config's, packed)")
    ap.add_argument("--word-fold", default=None,
                    choices=["auto", "1", "2", "4"],
                    help="machine-word lane folding cap of the bursts")
    ap.add_argument("--serve-fsdp", action="store_true",
                    help="stream the weights through the decode step's "
                         "read burst (weight_stream ports)")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="spread the requests over this many priority "
                         "classes (request i gets priority i %% P); higher "
                         "classes preempt lower ones on a full pool")
    ap.add_argument("--preempt", default=None,
                    choices=["swap", "recompute", "off"],
                    help="victim policy when a higher-priority request "
                         "would wait: swap the victim's pages to the host "
                         "over the swap/* streams, drop them and re-prefill, "
                         "or off = the head-of-line gate (default: the "
                         "config's, swap)")
    ap.add_argument("--swap-space-pages", type=int, default=None,
                    help="host swap-space cap in pages; evictions beyond it "
                         "fall back to recompute (default: the config's, "
                         "0 = unbounded)")
    ap.add_argument("--check-pool", action="store_true",
                    help="run the pool's free-list conservation invariant "
                         "after every engine step")
    ap.add_argument("--aging", type=int, default=0,
                    help="anti-starvation aging: every this-many steps a "
                         "request waits raise its effective priority one "
                         "class (0 = strict priority order)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded submit queue: submits beyond this depth "
                         "are shed (0 = unbounded)")
    ap.add_argument("--spec-decode-k", type=int, default=0,
                    help="Medusa-heads speculative decode: k draft heads "
                         "propose a branch per slot each step and the "
                         "engine accepts its longest prefix matching the "
                         "committed argmax (the token stream of k=0)")
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
    if args.kv_layout:
        cfg = dataclasses.replace(cfg, kv_layout=args.kv_layout)
        if cfg.fabric is not None:   # explicit fabric: keep the switch single
            cfg = dataclasses.replace(
                cfg, fabric=dataclasses.replace(cfg.fabric,
                                                impl=args.kv_layout))
    fab_over = {}
    if args.page_size:
        fab_over["page_size"] = args.page_size
    if args.pack:
        fab_over["pack"] = args.pack
    if args.word_fold:
        fab_over["word_fold"] = ("auto" if args.word_fold == "auto"
                                 else int(args.word_fold))
    if args.paged_pool is not None:
        fab_over["paged_pool"] = args.paged_pool
    if fab_over:
        cfg = dataclasses.replace(cfg, fabric=dataclasses.replace(
            cfg.resolved_fabric, **fab_over))
    if args.serve_fsdp:
        cfg = dataclasses.replace(cfg, serve_fsdp=True)
    if args.spec_decode_k:
        # the draft heads are model parameters: init_params draws them
        cfg = dataclasses.replace(cfg, spec_heads=args.spec_decode_k)
    fab = cfg.resolved_fabric
    n_patches = cfg.n_patches or 0
    data = SyntheticLM(cfg, batch=args.batch, seq=args.prompt_len + n_patches,
                       seed=args.seed)
    batch = data.batch_at(0)
    prompts = batch["tokens"]
    params = api.init_params(cfg, seed=args.seed, device=device)
    t_max = args.prompt_len + args.gen_len + n_patches
    print(f"arch={cfg.name} device={device} fabric=[impl={fab.impl} "
          f"N={fab.n_ports} W_acc={fab.lane_width} page={fab.page_size} "
          f"pack={fab.pack} fold={fab.word_fold}] batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen_len}")
    if not args.engine:
        prompt = torch.as_tensor(prompts, device=device)
        mt.reset_launch_counts()
        t0 = time.perf_counter()
        extra = {k: batch[k] for k in ("patch_embeds", "frames")
                 if k in batch}
        out = api.greedy_generate(params, prompt, cfg, steps=args.gen_len,
                                  t_max=t_max, extra=extra)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        print(f"generated {tuple(out.shape)} in {dt:.3f}s "
              f"({args.batch * args.gen_len / dt:.1f} tok/s, prefill "
              f"included)")
        print(f"kernel launches: {mt.launch_counts()}")
        print("sample:", out[0][:16].tolist())
        return
    eng = ServingEngine(cfg, params, max_slots=args.batch, t_max=t_max,
                        pool_pages=args.pool_pages,
                        fused_gather=args.fused_gather,
                        pool_shards=args.pool_shards,
                        collective=args.collective,
                        preempt=args.preempt,
                        swap_space_pages=args.swap_space_pages,
                        check_pool=args.check_pool,
                        spec_decode_k=args.spec_decode_k,
                        aging=args.aging, max_queue=args.max_queue)
    reqs = [Request(i, prompts[i], max_new_tokens=args.gen_len,
                    priority=i % max(args.priority_classes, 1))
            for i in range(args.batch)]
    for r in reqs:
        eng.submit(r)
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run_to_completion()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    kv, pool, fs = eng.kv, eng.kv.pool, eng.fabric_stats
    tokens = sum(len(r.generated) for r in reqs)
    print(f"served {args.batch} requests, {tokens} tokens in {dt:.3f}s "
          f"({tokens / dt:.1f} tok/s, prefill included) over "
          f"{eng.step_count} engine steps; admission moved "
          f"{kv.tokens_moved} of {kv.tokens_moved_dense} dense-splice "
          f"timesteps")
    if pool is None:
        print(f"dense per-slot KV: {args.batch} slots x {eng.t_alloc} "
              f"timesteps; {kv.prefill_splices} prefill splices")
    else:
        print(f"page pool: {pool.n_pages} physical pages x "
              f"{pool.page_size} timesteps (dense reservation "
              f"{kv.dense_reserved_pages} pages); {pool.pages_allocated} "
              f"allocated, {pool.pages_reclaimed} reclaimed, "
              f"{pool.pages_in_use} in use at exit; {kv.prefill_bursts} "
              f"prefill write bursts, {kv.prefill_splices} prefill splices")
        print(f"preemption[{eng.preempt}]: {fs.preemptions} preemptions; "
              f"swap {pool.pages_swapped_out} pages out / "
              f"{pool.pages_swapped_in} back ({fs.swap_out_words} words "
              f"out, {fs.swap_in_words} in over {fs.swap_bursts} swap "
              f"bursts); {fs.bursts_retried} bursts retried, "
              f"{fs.faults_recovered} faults recovered")
        print(f"admission: {fs.requests_shed} shed ({fs.shed_queue_full} "
              f"queue-full, {fs.shed_deadline} unmeetable-deadline); SLO "
              f"misses {fs.slo_missed_served} served late + "
              f"{fs.slo_missed_shed} shed; {fs.aging_promotions} aging "
              f"promotions")
    print(f"fabric over the run: {fs.network_calls} network calls for "
          f"{fs.streams_served} streams over {fs.flushes} bursts "
          f"({fs.words_moved} words moved, {fs.words_padded} padded, "
          f"{fs.words_folded} folded into machine words, "
          f"{fs.kernel_bursts} fused-kernel bursts, {fs.prefill_bursts} "
          f"prefill bursts)")
    if fs.gather_fused_bursts:
        print(f"fused gather: {fs.words_live} live-frame words through "
              f"{fs.gather_fused_bursts} sparse-extent bursts")
        if fs.collective_calls:
            local = fs.words_moved - fs.words_cross_shard
            print(f"sharded pool: {eng.pool_shards} shards x "
                  f"{eng.fabric.config.collective} — "
                  f"{fs.words_cross_shard} words crossed shards vs "
                  f"{max(local, 0)} local, through "
                  f"{fs.collective_calls} collective exchanges "
                  f"(pages striped "
                  f"{pool.free_pages_by_shard} free/shard)")
    elif not lm.paged_entries(cfg):
        print("fused gather: off — no full-attention leaf to pool or bank; "
              "the step decodes through the per-layer path")
    elif not eng.fabric.banks_kv:
        print("fused gather: off — the fabric banks no KV; the step decodes "
              "through the per-layer path")
    else:
        print("fused gather: off — the step banks the whole pool (gathering "
              "after the burst) or the dense per-slot caches")
    if cfg.moe is not None:
        print(f"moe dispatch: {fs.tokens_dropped} token assignments "
              f"dropped at capacity over the whole run (sentinel rows in the "
              f"dispatch scatter; residual passed through)")
    if eng.spec_k:
        print(f"speculative decode[k={eng.spec_k}]: {eng.spec_accepted}/"
              f"{eng.spec_proposed} draft tokens accepted "
              f"({eng.spec_acceptance:.1%}), {eng.spec_rejected} rejected")
    print(f"kernel launches: {mt.launch_counts()}")
    print("sample:", reqs[0].generated[:16])


if __name__ == "__main__":
    main()
