#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any fault exits non-zero):

1. device — print ``nvidia-smi``'s name and power limit; no CUDA, no run;
2. build  — compile the port's CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel), and print the registers
   and spills ``-Xptxas -v`` reports for the matmul's, the dense burst's,
   the gather's, the scatter's and the layout engine's kernels;
3. kernels — hold each kernel bit for bit against its plain PyTorch version
   on the card, at each serving path's shapes (the stablelm-1.6b engine's
   bursts: N=32 ports, W=32 32-bit words, 24 layers of a 2048-frame pool;
   the gemma3-4b engine's: N=4, W=128, 5 layers of a 6400-frame pool; the
   gemma3-4b one-shot's layout engine: K/V leaves [4, 1600, 4, 256] and
   [4, 1024, 4, 256] bf16; the starcoder2-15b engine's bursts: N=4, W=64,
   40 layers of a 6400-frame pool, its dense and padded tile [4, 4,
   8192000]; the gemma3-12b engine's: N=8, W=128, 8 layers of a 6400-frame
   pool; the layout engine at starcoder2-15b's [4, 1600, 4, 128] K/V pair
   and gemma3-12b's ring pair [4, 1024, 8, 256], a layer's K and V in one
   launch) and at edge cases (sentinels, sentinel-only groups, N from 1
   to 32, 8/16/64-bit words, rows off 16-byte multiples, ragged R and C,
   W=1, NaN payloads and -0.0, views off 16-byte alignment, the dense
   burst applied twice; the layout engine's leaves of a dtype in one
   launch, 70 leaves in two, the one-head and one-row identities with no
   launch, its autograd Function), the gather, the scatter and the layout
   engine launched twice for the same bits, every multi-leaf launch
   against its single-leaf launches, the gather's sentinel frames read as
   zeros; then time kernel, plain version and one PyTorch library call
   (the yardstick the port never calls), CUDA events, median of 30 runs
   (bursts with a warm L2, the layout engine's lists out of a flushed
   one, after a flush that rewrites a 128 MB buffer and after one that
   only reads it, beside the same leaves' single-leaf launches, a
   contiguous ``copy_`` of the same bytes and a 64-byte ``zero_()``, the
   floor of this timing), and the host time per wrapper call of the
   layout engine (a list, one leaf and single-leaf calls, the device held
   by a spin; the wrapper's parts apart) and of the gather and the
   scatter (100 calls at each engine's shape);
4. interconnect — kernels 5-7 through their ``ops`` entry points
   (``interconnect_read``, ``rotate_groups``, ``matmul``) at the served
   models' full widths: the read network and the barrel rotator on
   stablelm-1.6b's K pool leaf as lines [49152, 32, 64] bf16, the read
   network on gemma3-4b's [32000, 4, 256]; gemma3-4b's MLP up-projection
   [6144, 2560] @ [2560, 10240] (prefill of 4 x 1536 tokens) and [4, 2560]
   @ [2560, 10240] (decode) in bf16, a float32 [1024, 1024]^2 and ragged
   shapes.  Launch counts reset just before and read just after; then each
   result held against its plain version (bit for bit; the matmul within
   the tolerance of :func:`matmul_err`, each timed product through the
   route it must take, and launched again for the same bits), the edge
   cases (every matmul route at :func:`matmul_edges`' shapes), and the
   timings beside one PyTorch library call each;
5. stablelm — full-width stablelm-1.6b (random bf16 weights from a seed)
   through the port's ServingEngine: 4 requests, prompt 448, gen 64, on the
   fused-gather path and on the gather-after-burst path; the kernel launch
   counts must match the steps, and the two token streams must be equal;
   then on the crossbar fabric (every movement a gather through an index
   tensor, no Medusa kernel): the same tokens;
6. gemma3 — full-width gemma3-4b (34 layers, 5:1 sliding-window:global,
   random bf16 weights from a seed), prompt 1536 (past the 1024 window),
   gen 64, batch 4: (a) the one-shot ``greedy_generate`` through the
   per-layer decode path, 34 layout-engine launches per decode step (a
   layer's K and V in one), run
   again with the kernels off and on the crossbar fabric — tokens and
   every step's logits must be bit-identical; (b) the engine on both decode
   paths, equal tokens, no layout-engine launch;
7. starcoder2 — full-width starcoder2-15b (40 layers, 4 KV heads = N
   ports, ~31 GB of random bf16 weights from a seed), 4 requests of 1536
   tokens through the engine on every path of the dense family: (a) the
   fused gather, 64 tokens; 16 tokens each on (b) the pad layout with the
   gather after the burst, (c) the dense per-slot layout, (d) the per-leaf
   splice admission, (e) the fused fabric and (f) a medusa fabric off the
   port-per-KV-head geometry (kernel 4 once per layer); equal tokens on
   the common prefix, each path's launch counts, median step and peak
   memory;
8. gemma3-12b — full width (48 layers, 8 KV heads, ~24 GB), 4 requests of
   1536 tokens, 32 generated: the fused-gather engine (kernels 1-2 at
   N=8) and the one-shot generate (kernel 4, 48 launches a step) serve
   equal tokens;
9. serve_fsdp — the full-width stablelm-1.6b engine with the weights
   streamed through each step's read burst (one kernel-3 launch a step):
   tokens equal to the same engine's without it, the weight words per step
   checked; then kernel 3 at that weight tile;
10. preempt — oversubscribed serving at full width: (a) stablelm-1.6b, 8
   requests (prompt 448, gen 64, priority i % 3, one arriving every 6
   steps) on 4 slots and a 20-page pool under the swap arm and the
   recompute arm, and unconstrained (the default 32-page pool, preemption
   off); (b) gemma3-4b, 6 requests (prompt 1536, gen 32, every 4 steps) on
   a 60-page pool, swap arm and unconstrained; (c) (a)'s swap arm with a
   mid-step failure, an exhausted pool and a corrupted swap transfer; (d)
   (a)'s unconstrained trace with speculative decode (3 draft heads).  The
   swap, fault and speculative runs must serve the unconstrained tokens,
   every swap-in must put the record's frames (and ring rows) back bit for
   bit, the launches of kernels 1-2 must be exactly the decode steps',
   admission waves' and swap transfers'; prints each arm's steps, peak
   memory, swap transfers (wall time each, its parity share) and bytes,
   and each parked request's time to resume (steps and wall time from its
   preemption to its re-admission); then kernels 1-2 at each swap
   stream's shape, held and timed;
11. moe — full-width granite-moe-3b-a800m (32 layers, 40 experts top-8,
   ~6.6 GB of random bf16 weights from a seed), 4 requests of 448 tokens,
   32 generated, through the engine: every MoE layer dispatches over the
   scatter kernel and combines over the gather kernel in each decode step
   and prefill (launches exact); the same tokens with the kernels off,
   with ``payload="route"`` and on the crossbar fabric; the one-shot
   generate of request 0 equal to a one-slot engine's; kernels 1-2 held
   bit for bit at one decode step's (a capacity of 1, so sentinel rows)
   and one prefill's dispatch and combine operands, and timed, with the
   wrappers' host time per call (paths ``granite-moe-3b-a800m moe
   decode`` / ``prefill``);
12. families — the last decoder-only families at full width (random bf16
   weights from seed 0): internvl2-1b one-shot, 2 rows of 256 patch
   embeddings from the data stub + 192 tokens, 32 steps, kernel 4 exactly
   24 launches a step, tokens and logits bit-identical with the kernels
   off and on the crossbar, and its engine (4 x (448 + 64), kernels 1-2
   at 256-byte frames, the same tokens kernels off and on the crossbar);
   recurrentgemma-2b one-shot past its 2048 window (2 x 3072 + 32, no
   kernel: its one-head ring leaves are views, kernels on and off
   bit-identical) and its engine without a pool (no kernel); mamba2-780m
   one-shot (2 x 1000 + 32) and engine (no kernel); each engine's
   agreement with its one-shot; kernels 1, 2 and 4 held and timed at
   those shapes (paths ``internvl2-1b engine``, ``internvl2-1b
   one-shot``); the three float32 smokes card vs CPU
   (tokens and counters exact, logits and every cache leaf within 1e-4);
13. train — training on the card: full-width stablelm-1.6b through
   ``repro_torch.launch.train.main`` (8 steps of 8 x 64 tokens, remat on,
   no checkpoint written; finite losses, median step, tokens/s, peak
   memory); the CLI's fault path (12 steps, a checkpoint every 4, a
   failure at step 6, the depth cut to 2 layers) restarting once, and one
   state's save and in-place restore timed; full-width
   granite-moe-3b-a800m's loss and gradients at 2 x 64 (every expert
   weight's gradient non-zero; kernels 1-2 exactly once per MoE layer in
   the forward, once more where remat recomputes the block and once as
   the adjoint in the backward), kernels 1-2 held and timed at the
   backward's recorded operands (path ``granite-moe-3b-a800m train
   backward``), then 2 train steps with the same launches; the six
   trained families' float32 smokes, loss and every gradient card vs CPU
   within 1e-4;
14. whisper — full-width whisper-medium (24 + 24 layers, random bf16
   weights from seed 0): the one-shot of 2 rows of the data stub's 1500
   frames and 64 tokens, 32 decode steps, kernel 4 exactly one launch at
   prefill (the 48 cross K/V leaves) and 24 a step, tokens and every
   step's logits bit-identical with the kernels off and on the crossbar;
   its loss and gradients at 2 x 64 with the kernels on (one forward and
   one backward launch) and off, within 1e-2; 3 train steps; kernel 4
   held and timed at the 48-leaf cross K/V list, the self cache's pair
   and the 48 gradients recorded in the backward (paths ``whisper-medium
   prefill``, ``decode``, ``train``, ``train backward``);
15. loadgen — the traffic harness at full width: a seeded trace (16
   requests, diurnal arrivals with bursts, lognormal prompts of 16-448 and
   generations of 4-64 tokens, three priority classes, a quarter with SLO
   deadlines) replayed through stablelm-1.6b by ``repro_torch.launch.
   loadgen`` on an oversubscribed engine (4 slots, pages of 64, a 20-page
   pool, swap preemption, aging 8, a queue of 12), with kernels 1-2's
   launches exactly what the engine's counters imply; the steady step,
   tok/s, per-class TTFT, queue wait and TPOT, goodput and the shed, SLO
   and preemption census; the trace loaded back from the CLI's
   ``--trace-out`` under a seeded fault soak (token-exact, zero page leaks,
   its fault-free report equal to the CLI's record); a fleet of two
   replicas behind the router (every request served or shed); kernels 1-2
   held and timed at one decode step's operands (path ``loadgen:
   stablelm-1.6b``); then the paper's burst simulator on the card, one
   line in the constant N cycles, its pop bit-equal to the CPU's;
16. sharded — the sharded page pool at full width: stablelm-1.6b on 4
   slots, 6 requests of 448 tokens (8-32 generated, two admitted as
   others retire), served in turns by six engines: one shard; 2 shards
   (``all_to_all``), 4 (``all_to_all``) and 4 (``ring``), each pool's
   pages striped over its shard blocks, every shard on the one card; and
   for 2 and 4 shards the single-device lowering on the same striped
   allocator.  After every step the pool words, page tables, per-shard
   free lists and cursors equal the twin's, the written frames and live
   logits the one-shard run's; at the end equal tokens, every counter the
   twin's but the exchanges and the words across shards (the reference's
   formulas from the steps' plans), kernels 1-2 exactly S launches per
   sharded stream per direction; the median step of each, the host time
   of the step's ``shard_plan``, the exchange hop's device time with both
   collectives beside the whole sharded bursts; kernels 1-2 bit-equal at
   every shard's operands of one step and timed at shard 0's (path
   ``sharded: stablelm-1.6b S=2``); the serve CLI with ``--pool-shards``
   1, 2 and 4 (``--collective ring``): equal tokens, its report line,
   launches exact;
17. parallel — ROADMAP item 8b, every rank on the one card: (a) the ring
   MoE (``moe_apply_shardmap``) on granite-moe-3b-a800m's MoE layer at
   full width (random weights from seed 0) over 1, 2, 4 and 8 ranks on x
   [8, 448, 1536]: the ``ring`` and ``xla`` exchanges bit-equal in bf16
   and fp32; each rank count's layer time (host clock) and its exchanges'
   device time beside ``moe_apply`` (kernels 1-2) on the same tokens; the
   fp32 output and the four weight leaves' gradients at 8 ranks within
   1e-4 of the same call on the CPU; at ample capacity (x [8, 1] and [8,
   32] tokens, no slot dropped) within 2e-4 of ``moe_apply``; (b)
   stablelm-1.6b's data-parallel training at full width, 8 x 64: the train
   CLI with ``--multi-pod`` (2 rank blocks over pod), ``build_train_step``
   over (data=2, model=1) bit-equal to one rank at 2 microbatches and,
   against one rank at 1, the first step's loss, grad norm and gradient
   within bounds that a faulty mean (a block dropped, the sum undivided)
   exceeds, the steps' times; 16 rank blocks on the (16, 16) mesh at
   batch 16 no higher in peak memory than (data=2); the
   int8 ``dp_grad_mean`` of the two blocks' gradients within 5 % of the
   exact mean and bit-equal to the CPU on three leaves; (c) the pipeline,
   4 stages of ``tanh(x @ w)`` at d 2048, 8 microbatches of 128 rows,
   forward and gradients within 1e-5 of the sequential stages, both timed;
18. tooling — ROADMAP item 10b: (a) the dry run
   (``repro_torch.launch.dryrun.run_cell``) of stablelm-1.6b's
   ``prefill_32k`` and ``decode_32k`` over the (16, 16) mesh on meta, a
   line each (the roofline terms, the model's and the census's FLOPs,
   the stand-ins, the run's time); (b) the cost census
   (``launch.hlo_analysis.analyze_step``) of the train phase's
   stablelm-1.6b step (8 x 64) on the card: its FLOPs against the
   model's, the step's MFU, and with the kernels off the census equal to
   the same step's on meta (FLOPs exactly; bytes, or each op line apart
   named); (c) the census of one fused decode step of the stablelm-1.6b
   engine: kernels 1-2 as ops, as many as their launches, each launch's
   bytes the kernels line's row; (d) ``launch.profile.breakdown``'s top
   10 op lines of (b); (e) the profile CLI on the card at a cut
   ``decode_32k``;
19. card vs CPU — the stablelm, gemma3 and granite-moe smoke configs in
   float32 agree between the card and the CPU within 1e-4 (engine step;
   gemma3 one-shot), granite-moe's tokens and every ``SchedulerStats``
   field exactly; the stablelm smoke through the reference's churn trace
   (swap, recompute, swap with faults): tokens, ``SchedulerStats`` and the
   pool state equal, cache bytes within 1e-4;
20. report — one ``{"kernels": [...]}`` line with an entry per kernel and
   path (its launches in that path's runs, its times and its bound, by
   bytes or by operations from ``kernels.launch.kernel_cost``, at that
   path's shapes; a matmul's entry also
   names its route; the swap streams' entries are the paths ``swap:
   <arch>``, the traffic harness's ``loadgen: stablelm-1.6b``, the
   sharded pool's ``sharded: stablelm-1.6b S=2``), the card
   line again, and the ``{"ok": true, ...}`` line last.

``--profile`` adds ``torch.profiler`` censuses
(``repro_torch.launch.profile.device_census``, after the launch counts
are read) of the stablelm engine's fused decode steps, of gemma3-4b's
one-shot decode steps with the layout-engine kernel on and off in turns,
and of stablelm-1.6b's and whisper-medium's train steps:
the device's busy share of each profiled window and the device time by
kernel, printed and written in full to ``chiprun_out/profile_*.txt``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPS = 30
SPIN_CYCLES = 1_000_000            # ~0.5 ms at the H100's clock
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
    "medusa_transpose_tiles": (
        "src/repro_torch/kernels/csrc/medusa_transpose.cu",
        "src/repro/kernels/medusa_transpose.py:72"),
    "read_network_tiles": (
        "src/repro_torch/kernels/csrc/read_network.cu",
        "src/repro/kernels/medusa_transpose.py:111"),
    "barrel_rotate_groups": (
        "src/repro_torch/kernels/csrc/barrel_rotate.cu",
        "src/repro/kernels/rotator.py:23"),
    "stream_matmul": (
        "src/repro_torch/kernels/csrc/stream_matmul.cu",
        "src/repro/kernels/stream_matmul.py:41"),
}
# the engine runs: slots (= requests), stablelm-1.6b's prompt; gemma3-4b's
# serving runs: batch, prompt (past the 1024 window), generated
ENGINE_SLOTS, STABLELM_PROMPT = 4, 448
GEMMA_BATCH, GEMMA_PROMPT, GEMMA_GEN = 4, 1536, 64
# the rest of the dense family: starcoder2-15b's prompt and generated tokens
# on its main path and on its other paths; gemma3-12b's generated tokens
# (its prompt is GEMMA_PROMPT); the stablelm-1.6b serve_fsdp engine's
STARCODER_PROMPT, STARCODER_GEN, STARCODER_SHORT = 1536, 64, 16
GEMMA12_GEN, FSDP_GEN = 32, 16
# the kernels line's path of the layout engine (the engines' paths are
# "<arch> engine", kernels 5-7's "interconnect: <operand>")
ONE_SHOT = "gemma3-4b one-shot"
INTERCONNECT = "interconnect"
# the dense family's paths of kernel 4: starcoder2-15b's engine on a medusa
# fabric off the port-per-KV-head geometry (the per-layer paged decode), and
# gemma3-12b's one-shot generate
SC_FALLBACK = "starcoder2-15b paged fallback"
ONE_SHOT_12B = "gemma3-12b one-shot"
FSDP = "stablelm-1.6b serve_fsdp"
ZERO_LAUNCHES = {name: 0 for name in KERNELS}
# the preempt phase: stablelm-1.6b's requests, one arriving every this many
# engine steps, on a pool of this many pages (two full reaches of 8 pages
# leave no room for a third; the default pool is 32); gemma3-4b's requests,
# generated tokens, arrival interval and pool (reaches of 25 pages, the
# default pool 100); the speculative-decode run's draft heads
PREEMPT_REQUESTS, PREEMPT_EVERY, PREEMPT_POOL = 8, 6, 20
GEMMA_SWAP_REQUESTS, GEMMA_SWAP_GEN, GEMMA_SWAP_EVERY = 6, 32, 4
GEMMA_SWAP_POOL, SPEC_K = 60, 3
# the moe phase: granite-moe-3b-a800m's prompt and generated tokens (4
# requests, one per slot), and the kernels line's paths of kernels 1-2 at
# its MoE dispatch and combine shapes
MOE_ARCH, MOE_PROMPT, MOE_GEN = "granite-moe-3b-a800m", 448, 32
MOE_DECODE = "granite-moe-3b-a800m moe decode"
MOE_PREFILL = "granite-moe-3b-a800m moe prefill"
# the loadgen phase: a seeded trace (the TrafficConfig below, at
# stablelm-1.6b's vocab) replayed through stablelm-1.6b by the loadgen CLI
# on an oversubscribed engine (a 20-page pool against a dense reservation
# of 36), then under a seeded fault soak at the reference soak test's
# rates, then through a fleet of two replicas of 2 slots and 10 pages
LOADGEN_ARCH = "stablelm-1.6b"
LOADGEN = f"loadgen: {LOADGEN_ARCH}"
LOADGEN_TRACE = dict(seed=0, n_requests=16, arrival="diurnal", rate=0.5,
                     diurnal_period=32, prompt_mean=256, prompt_sigma=0.6,
                     prompt_min=16, prompt_max=448, gen_mean=32,
                     gen_sigma=0.7, gen_min=4, gen_max=64, classes=3,
                     deadline_frac=0.25, deadline_slack=3.0)
LOADGEN_ENGINE = dict(max_slots=4, page_size=64, pool_pages=20,
                      preempt="swap", aging=8, max_queue=12)
LOADGEN_SOAK = dict(p_fail=0.05, p_exhaust=0.1, n_corrupt=1)
LOADGEN_REPLICAS, LOADGEN_REPLICA = 2, dict(max_slots=2, pool_pages=10)
# the float32 churn of the card-vs-CPU phase (the reference's churn trace,
# tests/test_preemption.py): arrival step, prompt, generated, priority
CHURN_SPEC = ((0, 7, 8, 0), (0, 8, 8, 0), (2, 9, 6, 2), (3, 7, 6, 1),
              (4, 6, 6, 2))
# host seconds in the swap path's parity words, by where the bytes lie
PARITY = {"host_s": 0.0, "device_s": 0.0}
# the families phase: the one-shot batch and decode steps of each family;
# internvl2-1b's text prompt behind its 256 patches (one-shot) and its
# engine's text prompt and generated tokens; recurrentgemma-2b's prompt
# (past the 2048 window, and a multiple of the 1024-key chunk the prefill
# attends long prompts in); mamba2-780m's (off the 256 SSD chunk); the
# generated tokens of their engines
FAMILY_BATCH, FAMILY_STEPS = 2, 32
VLM_ARCH, VLM_TEXT, VLM_ENGINE_PROMPT, VLM_ENGINE_GEN = (
    "internvl2-1b", 192, 448, 64)
RG_ARCH, RG_PROMPT = "recurrentgemma-2b", 3072
SSM_ARCH, SSM_PROMPT = "mamba2-780m", 1000
FAMILY_GEN = 32
VLM_ONE_SHOT = f"{VLM_ARCH} one-shot"
# the train phase: stablelm-1.6b's full-width steps, batch and sequence;
# the fault path's steps, failure step, checkpoint interval and cut depth;
# granite-moe-3b-a800m's train steps and batch (sequence TRAIN_SEQ), and
# the kernels line's path of its backward bursts; the float32 smokes held
# card against CPU
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "stablelm-1.6b", 8, 8, 64
FAULT_STEPS, FAULT_AT, FAULT_EVERY, FAULT_LAYERS = 12, 6, 4, 2
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH = 2, 2
MOE_TRAIN = f"{MOE_ARCH} train backward"
# the whisper phase: whisper-medium's one-shot batch, prompt and generated
# tokens, its train steps (batch WHISPER_BATCH, sequence TRAIN_SEQ), and
# the kernels line's paths of kernel 4
WHISPER_ARCH, WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN = (
    "whisper-medium", 2, 64, 32)
WHISPER_TRAIN_STEPS = 3
WHISPER_PREFILL, WHISPER_DECODE = (f"{WHISPER_ARCH} prefill",
                                   f"{WHISPER_ARCH} decode")
WHISPER_TRAIN, WHISPER_BACKWARD = (f"{WHISPER_ARCH} train",
                                   f"{WHISPER_ARCH} train backward")
TRAIN_SMOKES = ("stablelm-1.6b", MOE_ARCH, VLM_ARCH, RG_ARCH, SSM_ARCH,
                WHISPER_ARCH)
# the sharded phase: stablelm-1.6b's requests (one per generated length,
# every prompt STABLELM_PROMPT tokens, submitted at once on ENGINE_SLOTS
# slots); the shard counts and collectives served beside one shard; the
# decode whose operands are recorded on the runs timed; the run whose
# shard-0 operands make the kernels line's rows (path SHARDED); the serve
# CLI's shard counts and collectives, and its generated tokens
SHARDED_ARCH = "stablelm-1.6b"
SHARDED_GENS = (32, 12, 20, 32, 8, 16)
SHARDED_RUNS = ((2, "all_to_all"), (4, "all_to_all"), (4, "ring"))
SHARDED_TIMED, SHARDED_ARM = ((2, "all_to_all"), (4, "ring")), 4
SHARDED_ROWS = "S=2 all_to_all"
SHARDED = f"sharded: {SHARDED_ARCH} S=2"
SHARDED_CLI = ((1, "all_to_all"), (2, "all_to_all"), (4, "ring"))
SHARDED_CLI_GEN = 16
# the parallel phase: the ring MoE's rank counts, its tokens at the config's
# capacity (rows, tokens a row; bf16 timed, fp32 held against the CPU at
# PAR_CPU_RANKS ranks within PAR_TOL), its shapes at ample capacity (held
# against moe_apply within PAR_AMPLE_TOL, tests/test_moe_shardmap.py's
# bound); the data-parallel train steps and rate of stablelm-1.6b (batch
# TRAIN_BATCH x TRAIN_SEQ); the bound of the int8 gradient mean
# (tests/test_multidevice.py's); the pipeline's stages, microbatches and
# rows (at stablelm-1.6b's d_model), held within PAR_PIPE_TOL
PAR_RANKS = (1, 2, 4, 8)
PAR_MOE_X = (8, 448)
PAR_CPU_RANKS = 8
PAR_TOL = 1e-4
PAR_AMPLE_X = ((8, 1), (8, 32))
PAR_AMPLE_TOL = 2e-4
PAR_TRAIN_STEPS, PAR_LR, PAR_CLIP = 4, 3e-3, 1.0
# the (data=2) step against one rank at 1 microbatch, first step: loss
# (absolute), grad norm (relative) and gradient (the worst leaf's max |diff|
# over its largest entry), each a few times the sound runs' largest reading
# and below what a faulty mean reads (PERF.md §6, PR 29); the peak memory
# at 16 rank blocks may pass the data=2 step's by PAR_PEAK_SLACK GiB
PAR_DP_LOSS_TOL, PAR_DP_NORM_TOL, PAR_DP_GRAD_TOL = 4e-6, 4e-4, 5e-2
PAR_PEAK_SLACK = 0.5
PAR_INT8_TOL = 0.05
PAR_PIPE = (4, 8, 128)
PAR_PIPE_TOL = 1e-5
PAR_LEAVES = ("router", "w_gate", "w_out", "w_up")
# the tooling phase: the dry run's cells (stablelm-1.6b, single mesh, on
# meta) and the train steps timed for the MFU (the first one not counted)
TOOLING_CELLS = ("prefill_32k", "decode_32k")
TOOLING_STEPS = 5


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


def time_ms(torch, fn, reps: int = REPS, flush=None,
            read_flush: bool = False, spin: int = SPIN_CYCLES) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events),
    after two warm-up calls.  Before each run the device spins for
    ``spin`` cycles, about half a millisecond by default
    (``torch.cuda._sleep``), so the host has enqueued the start event,
    ``fn``'s launches and the end event before the device reaches them:
    the span is device time, not the host's launch overhead (a caller
    whose ``fn`` takes longer than that to enqueue spins longer).
    With ``flush`` (a buffer larger than the 50 MB L2) the buffer is
    rewritten first, so ``fn`` finds its operands in device memory as a
    cold caller would, and the L2 full of dirty lines; with ``read_flush``
    the buffer is only read (summed), which leaves the L2 full of clean
    lines instead."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            if read_flush:
                flush.sum()
            else:
                flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(torch, fn) -> float:
    """Host milliseconds of one call of ``fn()``, from a synchronized
    device to a synchronized device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def host_us(torch, fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn()`` over ``calls`` calls, with no
    synchronize inside the loop (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


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


def words_equal(torch, got, want, what: str) -> int:
    """:func:`bit_equal` on same-width signed integer views, so NaN
    payloads and -0.0 compare by their bits."""
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    check(got.dtype == want.dtype, f"{what}: {got.dtype} vs {want.dtype}")
    w = view[got.element_size()]
    return bit_equal(torch, got.view(w), want.view(w), what)


def set_bound(r: dict) -> None:
    """The least time the card could take for the row's work: the larger
    of its bytes (each input read once, each output written once, from
    ``kernels.launch.kernel_cost``) over the HBM rate and its operations
    over the peak rate for their type (the H100's data sheet,
    ``launch.mesh``); ``bound_by`` names which."""
    from repro_torch.launch.mesh import HBM_BW

    by_bytes = r["bytes"] / HBM_BW * 1e3
    by_ops = r["flops"] / r["peak"] * 1e3 if r.get("flops") else 0.0
    r["bound_ms"] = max(by_bytes, by_ops)
    r["bound_by"] = "operations" if by_ops > by_bytes else "bytes"


def print_row(name: str, path: str, r: dict) -> None:
    work = f"{r['bytes']} bytes" + (f", {r['flops']} flop"
                                    if r.get("flops") else "")
    via = f" via {r['matmul_route']}" if "matmul_route" in r else ""
    print(f"kernel {name} ({path}){via}: {r['shape']}: {r['ms']:.4f} ms (bound "
          f"{r['bound_ms']:.4g} ms by {r['bound_by']} for {work}, plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms)",
          flush=True)


def transpose_rows(torch, dev, gen, words):
    """Kernel 4, the KV layout engine, through its multi-leaf entry: held
    bit for bit at the edge cases (every word width, R and C not multiples
    of 4, W=1, NaN payloads and -0.0, 16-byte rows at a ragged R, a view
    off 16-byte alignment), each alone and all of a dtype in one launch
    (leaves of other shapes and row words in one table), a list past the
    table's cap (two launches), the one-head and one-row identities (a
    view, no launch) and the autograd Function (one launch forward, one on
    the gradients, an unused output's input without a gradient); then
    gemma3-4b's K/V pairs held and timed (:func:`leaves_row`) and the
    wrapper's host time taken apart (:func:`wrapper_parts`).  Returns the
    rows of the ``ONE_SHOT`` path: the ring layer's pair (``L``, 29 of the
    34 launches a step) and the full-attention layer's (``A``)."""
    from repro_torch.kernels import launch as kl
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.kernels import ops

    def launches(fn):
        kl.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, kl.launch_counts()["medusa_transpose_tiles"]

    # edge cases: every word width, R and C not multiples of 4 (the kernel,
    # and through ops.transpose_rc), W=1, NaN payloads and -0.0, 16-byte
    # rows at a ragged R, a view off 16-byte alignment; each dtype's leaves
    # again in one launch beside their single-leaf launches
    by_dtype = {}
    for dtype, shape in ((torch.uint8, (3, 7, 5, 1)), (torch.int16, (7, 13, 3)),
                         (torch.int32, (2, 9, 6, 2)), (torch.int64, (5, 3, 1)),
                         (torch.float32, (2, 100, 36, 3)),
                         (torch.bfloat16, (3, 11, 2, 16)),
                         (torch.int32, (2, 100, 36, 4)),
                         (torch.int32, (9, 7, 4)),
                         (torch.bfloat16, (4, 37, 4, 256))):
        if dtype.is_floating_point:
            w = {2: torch.int16, 4: torch.int32}[dtype.itemsize]
            x = words(shape, w).view(dtype)
            special = {torch.float32: [0x7FC12345, -0x7FFFFF, -2 ** 31],
                       torch.bfloat16: [0x7FC1, -0x5B, -0x8000]}[dtype]
            x.view(w).view(-1)[:3] = torch.tensor(special, dtype=w)
        elif dtype == torch.int64:            # two random 32-bit halves
            x = words(tuple(shape) + (2,)).view(torch.int64)[..., 0]
        else:
            x = words(shape, dtype if dtype != torch.uint8 else torch.int16
                      ).to(dtype)
        what = f"transpose edge {dtype} {list(shape)}"
        got, n = launches(lambda: mt.medusa_transpose_tiles(x))
        check(n == 1, f"{what}: {n} launches")
        words_equal(torch, got, mt.medusa_transpose_plain(x), what)
        words_equal(torch, mt.medusa_transpose_tiles(x), got,
                    what + " launched again")
        words_equal(torch, ops.transpose_rc(x), got,
                    what + " (ops.transpose_rc)")
        by_dtype.setdefault(dtype, []).append((x, got))
    base = words((1 + 4 * 8 * 16,), torch.int16).view(torch.bfloat16)
    x = base[1:].view(4, 8, 16)               # 2-byte aligned, not 16
    got, n = launches(lambda: mt.medusa_transpose_tiles(x))
    words_equal(torch, got, mt.medusa_transpose_plain(x),
                "transpose edge unaligned view")
    by_dtype[torch.bfloat16].append((x, got))
    for dtype, pairs in by_dtype.items():
        many, n = launches(lambda: mt.medusa_transpose_many(
            [x for x, _ in pairs]))
        check(n == 1, f"transpose edges {dtype}: {n} launches for "
              f"{len(pairs)} leaves")
        for (x, one), got in zip(pairs, many):
            words_equal(torch, got, one, f"transpose edges {dtype} "
                        f"{list(x.shape)}: one launch vs single-leaf")
    # past the table's cap: 70 leaves of other shapes, two launches
    xs = [words((2, 3 + i % 5, 2 + i % 3, 8), torch.int16).view(
        torch.bfloat16) for i in range(70)]
    many, n = launches(lambda: mt.medusa_transpose_many(xs))
    check(n == -(-70 // mt.MAX_LEAVES), f"70 leaves: {n} launches")
    for i, (x, got) in enumerate(zip(xs, many)):
        words_equal(torch, got, mt.medusa_transpose_plain(x),
                    f"transpose 70 leaves, leaf {i}")
    # the identities: recurrentgemma-2b's one-head ring leaf and a one-row
    # leaf come back as views, no launch; beside a leaf that moves, one
    ring = words((FAMILY_BATCH, 2048, 1, 256), torch.int16).view(
        torch.bfloat16)
    row = words((3, 1, 5, 8), torch.int16).view(torch.bfloat16)
    moved = words((3, 5, 4, 8), torch.int16).view(torch.bfloat16)
    (a, b), n = launches(lambda: mt.medusa_transpose_many([ring, row]))
    check(n == 0, f"the identity leaves launched {n} times")
    for x, got, what in ((ring, a, "one-head"), (row, b, "one-row")):
        check(got.data_ptr() == x.data_ptr() and got.is_contiguous(),
              f"the {what} leaf is not a contiguous view of its input")
        words_equal(torch, got, mt.medusa_transpose_plain(x),
                    f"transpose {what} identity")
    (a, c), n = launches(lambda: ops.transpose_many([ring, moved]))
    check(n == 1 and a.data_ptr() == ring.data_ptr(),
          f"an identity leaf beside a moving one: {n} launches")
    words_equal(torch, c, mt.medusa_transpose_plain(moved),
                "transpose beside an identity")
    print(f"transpose edges: every row word of 1-16 bytes, each dtype's "
          f"leaves in one launch, 70 leaves in {-(-70 // mt.MAX_LEAVES)} "
          f"launches, an unaligned view, the one-head {list(ring.shape)} and "
          f"one-row leaves as views with no launch: bit-equal", flush=True)
    # the autograd Function: two float32 leaves, the second output unused
    k0, v0, w0 = (words((2, 9, 4, 6)).float() for _ in range(3))
    k, v = k0.clone().requires_grad_(), v0.clone().requires_grad_()
    kl.reset_launch_counts()
    yk, yv = ops.transpose_many([k, v])
    gk, gv = torch.autograd.grad((yk * w0.transpose(1, 2)).sum(), [k, v],
                                 allow_unused=True)
    torch.cuda.synchronize()
    kp = k0.clone().requires_grad_()
    (gp,) = torch.autograd.grad(
        (kp.transpose(1, 2) * w0.transpose(1, 2)).sum(), [kp])
    check(gv is None and torch.equal(gk, gp) and torch.equal(
        yk, mt.medusa_transpose_plain(k0)),
          "the autograd Function's gradient is not the plain swap's")
    check(kl.launch_counts()["medusa_transpose_tiles"] == 2
          and kl.backward_launch_counts()["medusa_transpose_tiles"] == 1,
          f"the autograd Function launched {kl.launch_counts()}, backward "
          f"{kl.backward_launch_counts()}")
    del xs, many, ring, row, moved, by_dtype

    # a K/V leaf is read once per layer per step, after 8 GB of weights and
    # the other layers' leaves went by: time the layer's pair out of a cold
    # L2, after a flush that leaves the L2 dirty (rewritten) and after one
    # that leaves it clean (only read)
    out = {}
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for what, t in (("A", GEMMA_PROMPT + GEMMA_GEN), ("L", 1024)):
        pair = [words((GEMMA_BATCH, t, 4, 256), torch.int16).view(
            torch.bfloat16) for _ in range(2)]
        for x, y in zip(pair, ops.kv_line_to_port(pair)):
            words_equal(torch, y, mt.medusa_transpose_plain(x),
                        f"kv_line_to_port ({what} pair)")
        out[what] = leaves_row(torch, pair, flush,
                               f"gemma3-4b {what} layer's K and V")
        if what == "L":
            wrapper_parts(torch, pair)
        del pair
    # what this timing reads for a kernel that moves almost nothing
    tiny = torch.zeros(16, device=dev)
    print(f"timing floor: a 64-byte zero_() reads "
          f"{time_ms(torch, tiny.zero_, flush=flush):.4f} ms after a write "
          f"flush", flush=True)
    del flush
    return out


def enqueue_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn()`` with the device held by a
    spin for the whole loop, so every call only enqueues: the host's own
    cost, whatever the device's."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES * calls // 5)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def wrapper_parts(torch, xs) -> None:
    """The host microseconds of each part of kernel 4's wrapper on the
    leaves ``xs``, beside the parts it no longer calls (the shared
    ``kl.check_cuda``, ``kl.row_word``, ``kl.stream`` and ``torch.empty``
    with keywords), the device held (:func:`enqueue_us`)."""
    import array

    from repro_torch.kernels import launch as kl
    from repro_torch.kernels import medusa_transpose as mt

    x, dev = xs[0], xs[0].device
    outs = [v.new_empty(v.shape) for v in xs]
    desc = [v for y, o in zip(xs, outs) for v in (
        y.data_ptr(), o.data_ptr(), y.shape[0], y.shape[1], y.shape[2],
        y.shape[3] * y.element_size() // 16)]
    fn = kl.bind("medusa_transpose", "medusa_transpose_many",
                 mt._TRANSPOSE_ARGS)
    packed = array.array("q", desc)
    stream = kl.raw_stream(dev)
    parts = {
        "check_leaves": lambda: mt.check_leaves(xs, "parts"),
        "shapes read": lambda: [tuple(v.shape) for v in xs],
        "x.new_empty": lambda: [v.new_empty(v.shape) for v in xs],
        "data_ptr": lambda: [(v.data_ptr(), o.data_ptr())
                             for v, o in zip(xs, outs)],
        "descriptors": lambda: array.array("q", desc),
        "bind + count": lambda: (kl.bind("medusa_transpose",
                                         "medusa_transpose_many",
                                         mt._TRANSPOSE_ARGS),
                                 kl.count("medusa_transpose_tiles")),
        "raw_stream": lambda: kl.raw_stream(dev),
        "ctypes call (the launch)": lambda: fn(
            packed.buffer_info()[0], len(xs), 16, stream),
        "the whole wrapper": lambda: mt.medusa_transpose_many(xs),
        "the whole wrapper, one leaf": lambda: mt.medusa_transpose_many(
            xs[:1]),
        "no longer called: torch.empty with keywords": lambda: [
            torch.empty(v.shape, dtype=v.dtype, device=v.device)
            for v in xs],
        "kl.check_cuda": lambda: kl.check_cuda("parts", x=x, out=outs[0]),
        "kl.row_word": lambda: kl.row_word(x, outs[0]),
        "kl.stream (torch.cuda.current_stream)": lambda: kl.stream(x),
    }
    got = {name: enqueue_us(torch, part) for name, part in parts.items()}
    torch.cuda.synchronize()
    print(f"transpose wrapper host us per call, {len(xs)} leaves "
          f"{list(x.shape)}, the device held: " + "; ".join(
              f"{name} {us:.2f}" for name, us in got.items()), flush=True)


def leaves_row(torch, xs, flush, what: str) -> dict:
    """Kernel 4 on the list of bf16 leaves ``xs`` in one launch (a layer's
    K and V, whisper's cross K/V of every layer, or gradients recorded in
    a backward): held bit for bit against the per-leaf plain version and
    against single-leaf launches, then timed out of a flushed L2 (a write
    flush; the launch, the single-leaf launches, the library and a copy_
    again after a read-only flush) beside the single-leaf launches of the
    same leaves, the per-leaf plain version, the per-leaf library call
    (``transpose(1, 2).contiguous()``), one contiguous ``copy_`` of the
    same bytes and the first leaf alone; and the host time per call of the
    list, of the first leaf alone and of the single-leaf calls, the device
    held (:func:`enqueue_us`), with the first leaf's also as earlier runs
    took it (:func:`host_us`, the device running behind).  The device spins
    half a millisecond more for every 8 leaves before each timed run, so a
    list's host enqueue (up to ~30 µs a leaf) stays out of the span."""
    from repro_torch.kernels import launch as kl
    from repro_torch.kernels import medusa_transpose as mt

    xs = list(xs)
    kl.reset_launch_counts()
    got = mt.medusa_transpose_many(xs)
    torch.cuda.synchronize()
    n = kl.launch_counts()["medusa_transpose_tiles"]
    check(n == -(-len(xs) // mt.MAX_LEAVES),
          f"transpose ({what}): {n} launches for {len(xs)} leaves")
    err = 0
    for i, (x, y) in enumerate(zip(xs, got)):
        err = max(err, words_equal(torch, y, mt.medusa_transpose_plain(x),
                                   f"transpose ({what}) leaf {i}"))
        words_equal(torch, mt.medusa_transpose_tiles(x), y,
                    f"transpose ({what}) leaf {i}, single-leaf launch")
    words_equal(torch, mt.medusa_transpose_many(xs)[-1], got[-1],
                f"transpose ({what}) launched again")
    del got
    nbytes = sum(x.numel() * x.element_size() for x in xs)
    src = torch.empty(nbytes, dtype=torch.uint8, device=xs[0].device)
    dst = torch.empty_like(src)

    def many():
        mt.medusa_transpose_many(xs)

    def single():
        for x in xs:
            mt.medusa_transpose_tiles(x)

    def plain():
        for x in xs:
            mt.medusa_transpose_plain(x)

    def library():
        for x in xs:
            x.transpose(1, 2).contiguous()

    def one():
        mt.medusa_transpose_tiles(xs[0])

    def copy():
        dst.copy_(src)

    shape = list(xs[0].shape)
    same = all(list(x.shape) == shape for x in xs)
    spin = SPIN_CYCLES * (1 + len(xs) // 8)

    def timed(fn, read_flush=False):
        return time_ms(torch, fn, flush=flush, read_flush=read_flush,
                       spin=spin)
    row = dict(
        max_abs_err=err, leaves=len(xs),
        bytes=kl.kernel_cost("medusa_transpose_tiles", leaves=xs)[0],
        ms=timed(many), single_ms=timed(single), plain_ms=timed(plain),
        library_ms=timed(library), copy_ms=timed(copy),
        one_leaf_ms=timed(one), ms_read_flush=timed(many, True),
        single_ms_read_flush=timed(single, True),
        library_ms_read_flush=timed(library, True),
        copy_ms_read_flush=timed(copy, True),
        host_us_per_call=enqueue_us(torch, many),
        host_us_one_leaf=enqueue_us(torch, one),
        host_us_single=enqueue_us(torch, single),
        host_us_one_leaf_behind=host_us(torch, one),
        shape=(f"{len(xs)} x {shape} bf16 ({what})" if same else
               f"{len(xs)} leaves bf16 ({what})"))
    set_bound(row)
    print(f"transpose ({what}): {len(xs)} leaves, {nbytes} bytes each way "
          f"(bound {row['bound_ms']:.4f} ms): one launch {row['ms']:.4f} ms, "
          f"single-leaf launches {row['single_ms']:.4f}, library "
          f"{row['library_ms']:.4f}, a contiguous copy_ of the same bytes "
          f"{row['copy_ms']:.4f}, the first leaf alone "
          f"{row['one_leaf_ms']:.4f} after a write flush; "
          f"{row['ms_read_flush']:.4f}, {row['single_ms_read_flush']:.4f}, "
          f"{row['library_ms_read_flush']:.4f} and "
          f"{row['copy_ms_read_flush']:.4f} after a read-only flush; host us "
          f"per call {row['host_us_per_call']:.2f} (the first leaf alone "
          f"{row['host_us_one_leaf']:.2f}, single-leaf calls "
          f"{row['host_us_single']:.2f}; the first leaf with the device "
          f"running behind {row['host_us_one_leaf_behind']:.2f})",
          flush=True)
    return row


def scatter_edges(torch, gen, words, dev) -> None:
    """Kernel 2 at its edges, each launched twice for the same bits: N in
    {1, 4, 8, 32}; rows of 4, 5 and 6 bytes and of 16-byte multiples;
    ``banked`` and ``into`` views off 16-byte alignment; groups of live
    frames, of live frames mixed with sentinels (L, 2^30 and -1) and of
    sentinels only.  Rows no index names keep their bytes."""
    from repro_torch.kernels import medusa_transpose as mt

    for n, dtype, w, off_b, off_i in (
            (1, torch.int32, 4, 0, 0), (1, torch.int16, 3, 0, 0),
            (4, torch.int32, 128, 0, 0), (4, torch.int16, 3, 0, 0),
            (4, torch.uint8, 5, 0, 0), (8, torch.int32, 1, 0, 0),
            (32, torch.int32, 32, 0, 0), (32, torch.int16, 64, 0, 0),
            (32, torch.int32, 32, 1, 0), (32, torch.int32, 32, 0, 2),
            (4, torch.int16, 8, 1, 3)):
        l = 6 * n
        perm = torch.randperm(l, generator=gen, device=dev)
        mixed = torch.tensor([l, 2 ** 30, -1], device=dev).repeat(n)[:n]
        mixed[::2] = perm[2 * n:2 * n + (n + 1) // 2]
        idx = torch.cat([perm[:n], mixed, torch.full((n,), l, device=dev),
                         perm[n:2 * n]]).to(torch.int32)
        g = idx.numel() // n

        def view(shape, off):
            size = off + math.prod(shape)
            flat = words((size,), torch.int16 if dtype == torch.uint8
                         else dtype).to(dtype)
            return flat[off:].view(shape)

        banked = view((g, n, n, w), off_b)
        into0 = view((l, n, w), off_i)
        want = into0.clone()
        mt.scatter_burst_plain(banked, idx, want, n)
        what = (f"scatter edge N={n} {dtype} W={w} (views {off_b}, {off_i} "
                f"words off)")

        def target():
            t = view((l, n, w), off_i)
            t.copy_(into0)
            return t

        got = target()
        mt.scatter_burst_network_tiles(banked, idx, got, n)
        bit_equal(torch, got, want, what)
        again = target()
        mt.scatter_burst_network_tiles(banked, idx, again, n)
        bit_equal(torch, again, got, what + " launched again")
        live = idx[(idx >= 0) & (idx < l)].long()
        untouched = torch.ones(l, dtype=torch.bool, device=dev)
        untouched[live] = False
        check(bool(untouched.any()) and torch.equal(got[untouched],
                                                    into0[untouched]),
              f"{what}: untouched rows moved")


def gather_edges(torch, gen, words, dev) -> None:
    """Kernel 1 at its edges, each launched twice for the same bits: N in
    {1, 4, 8, 32}; rows of 4, 5 and 6 bytes and of 16-byte multiples;
    ``lines`` as views 1-3 words off 16-byte alignment; groups of live
    frames, of live frames mixed with sentinels (L, 2^30 and -1) and of
    sentinels only.  Sentinel frames read as zeros."""
    from repro_torch.kernels import medusa_transpose as mt

    for n, dtype, w, off in (
            (1, torch.int32, 4, 0), (1, torch.int16, 3, 0),
            (4, torch.int32, 128, 0), (4, torch.int16, 3, 0),
            (4, torch.uint8, 5, 0), (8, torch.int32, 1, 0),
            (32, torch.int32, 32, 0), (32, torch.int16, 64, 0),
            (32, torch.int32, 32, 1), (8, torch.int32, 8, 2),
            (4, torch.int16, 8, 3)):
        l = 6 * n
        perm = torch.randperm(l, generator=gen, device=dev)
        sentinels = torch.tensor([l, 2 ** 30, -1], device=dev).repeat(n)
        mixed = sentinels[:n].clone()
        mixed[::2] = perm[2 * n:2 * n + (n + 1) // 2]
        idx = torch.cat([perm[:n], mixed, sentinels[1:n + 1],
                         perm[n:2 * n]]).to(torch.int32)
        flat = words((off + l * n * w,), torch.int16 if dtype == torch.uint8
                     else dtype).to(dtype)
        lines = flat[off:].view(l, n, w)
        what = f"gather edge N={n} {dtype} W={w} (lines {off} words off)"
        got = mt.gather_burst_network_tiles(lines, idx, n)
        bit_equal(torch, got, mt.gather_burst_plain(lines, idx, n), what)
        bit_equal(torch, mt.gather_burst_network_tiles(lines, idx, n), got,
                  what + " launched again")
        frames = got.transpose(1, 2).reshape(idx.numel(), n, w)
        sentinel = (idx < 0) | (idx >= l)
        check(bool(sentinel.any()) and not bool(frames[sentinel].any()),
              f"{what}: a sentinel frame is not zeros")


def sparse_rows(torch, words, lines, idx, n: int, label: str) -> dict:
    """Kernels 1-2 at one stream's shape: the gather of ``idx``'s frames
    from ``lines`` (``[L, N, W]`` int32 words), and the scatter of as many
    random frames to the same rows of a pool shaped like ``lines``.  Each
    is held bit for bit against its plain version and a second launch, and
    timed (warm L2) beside its plain version and one library call; returns
    the rows of the kernels line."""
    from repro_torch.kernels import launch as kl
    from repro_torch.kernels import medusa_transpose as mt

    w = lines.shape[2]
    k = idx.shape[0]
    rows = {}

    # -- gather: a second launch gives the same bits --------------------------
    got = mt.gather_burst_network_tiles(lines, idx, n)
    err = bit_equal(torch, got, mt.gather_burst_plain(lines, idx, n),
                    f"gather ({label} shape)")
    bit_equal(torch, mt.gather_burst_network_tiles(lines, idx, n), got,
              f"gather ({label}) launched again")
    nbytes = kl.kernel_cost("gather_burst_network_tiles", lines=lines,
                            idx=idx, out=got)[0]
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
        # few calls: the device, not the host, would set the pace of more
        host_us_per_call=host_us(torch, lambda: mt.gather_burst_network_tiles(
            lines, idx, n), calls=100),
        shape=f"lines {list(lines.shape)} int32, idx [{k}]")
    print(f"gather ({label}): wrapper "
          f"{rows['gather_burst_network_tiles']['host_us_per_call']:.2f} host "
          f"us per call", flush=True)

    # -- scatter: a second launch into a fresh copy and one applied again in
    #    place give the same bits ---------------------------------------------
    g = k // n
    banked = words((g, n, n, w))
    into0 = words(tuple(lines.shape))
    into_k, into_p = into0.clone(), into0.clone()
    mt.scatter_burst_network_tiles(banked, idx, into_k, n)
    mt.scatter_burst_plain(banked, idx, into_p, n)
    err = bit_equal(torch, into_k, into_p, f"scatter ({label} shape)")
    again = into0.clone()
    mt.scatter_burst_network_tiles(banked, idx, again, n)
    bit_equal(torch, again, into_k, f"scatter ({label}) launched again")
    mt.scatter_burst_network_tiles(banked, idx, again, n)
    bit_equal(torch, again, into_k, f"scatter ({label}) applied twice")
    live = idx[(idx >= 0) & (idx < into0.shape[0])]
    check(live.unique().numel() == live.numel(), "scatter rows not unique")
    # a sentinel frame is neither read from ``banked`` nor written
    nbytes = kl.kernel_cost("scatter_burst_network_tiles", banked=banked,
                            idx=idx, into=into_k)[0]
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
        host_us_per_call=host_us(torch, lambda: mt.scatter_burst_network_tiles(
            banked, idx, into_k, n), calls=100),
        shape=f"banked {list(banked.shape)} int32, into "
              f"{list(into0.shape)}")
    print(f"scatter ({label}): wrapper "
          f"{rows['scatter_burst_network_tiles']['host_us_per_call']:.2f} "
          f"host us per call", flush=True)
    del into0, into_k, into_p, banked, again
    return rows


def burst_rows(torch, gen, words, arch: str, prompt: int, gen_len: int):
    """Kernels 1-3 at one engine path's geometry: ``arch``'s fabric (N
    ports, a bf16 head vector folded into 32-bit words), its full-attention
    layers stacked on the line axis of a pool of ``ENGINE_SLOTS`` slots x
    ``prompt + gen_len`` frames in the engine's pages, every page mapped
    (the live plan of a decode step past the prompt).  Each kernel is held
    bit for bit against its plain version and timed beside it and one
    library call; returns the rows of the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch as kl
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.models import common as cm

    cfg = get_config(arch)
    n, ps = cfg.resolved_fabric.n_ports, cfg.resolved_fabric.page_size
    w = cfg.resolved_head_dim // 2           # bf16 pairs in int32 words
    reps = cfg.layer_types().count("A")
    t_alloc = -(-(prompt + gen_len) // n) * n
    per_slot = -(-t_alloc // ps)
    pages = ENGINE_SLOTS * per_slot
    frames = pages * ps
    check(frames % n == 0, f"{arch}: pool frames {frames} not a multiple "
          f"of N={n}")
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(0))
    table = table.reshape(ENGINE_SLOTS, per_slot).numpy().astype("int32")
    live_idx, _, _ = cm.page_live_plan(table, ps, t_alloc, n, bucket=n * ps)
    dev = gen.device
    idx = cm.pool_rep_indices(torch.from_numpy(live_idx).to(dev), reps,
                              frames)
    lines = words((reps * frames, n, w))
    rows = sparse_rows(torch, words, lines, idx, n, f"{arch} engine")
    del lines

    # -- dense burst (the gather-after-burst path: both K/V pool streams
    #    packed on the word axis) ----------------------------------------------
    tile = words((n, n, 2 * (reps * frames // n) * w))
    got = mt.burst_network_tiles(tile, n)
    err = bit_equal(torch, got, mt.burst_network_plain(tile, n),
                    f"burst ({arch} engine shape)")
    check(torch.equal(mt.burst_network_tiles(got, n), tile),
          "burst is not an involution")
    rows["burst_network_tiles"] = dict(
        max_abs_err=err, bytes=kl.kernel_cost("burst_network_tiles",
                                              tile=tile)[0],
        ms=time_ms(torch, lambda: mt.burst_network_tiles(tile, n)),
        plain_ms=time_ms(torch, lambda: mt.burst_network_plain(tile, n)),
        library_ms=time_ms(torch, lambda: tile.transpose(0, 1).contiguous()),
        shape=f"tile {list(tile.shape)} int32")
    del tile, got
    return rows


def pair_row(torch, words, shape, flush, what: str, n: int = 2) -> dict:
    """Kernel 4 at ``n`` served K/V leaves of ``shape`` (bf16) in one
    launch (:func:`leaves_row`)."""
    return leaves_row(torch, [words(shape, torch.int16).view(torch.bfloat16)
                              for _ in range(n)], flush, what)


def kernels_phase(torch, dev):
    """Kernel-vs-plain comparisons and timings; returns the rows of the
    kernels line by path (launch counts filled in by the serve phases)."""
    from repro_torch.kernels import medusa_transpose as mt

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def words(shape, dtype=torch.int32):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(dtype)

    # kernels 1-3 at each engine path's geometry
    rows = {f"{arch} engine": burst_rows(torch, gen, words, arch, prompt, g)
            for arch, prompt, g in (("stablelm-1.6b", STABLELM_PROMPT, 64),
                                    ("gemma3-4b", GEMMA_PROMPT, GEMMA_GEN))}

    # -- edge cases of kernel 3: 16-bit and 8-bit words, N=4, odd widths
    #    (kernels 1 and 2's: gather_edges, scatter_edges) ---------------------
    for n_e, dtype, w_e in ((4, torch.int16, 3), (32, torch.int16, 64),
                            (4, torch.uint8, 5), (8, torch.int32, 1)):
        what = f"N={n_e} {dtype} W={w_e}"
        tile_e = words((n_e, n_e, w_e), dtype)
        got_e = mt.burst_network_tiles(tile_e, n_e)
        bit_equal(torch, got_e, mt.burst_network_plain(tile_e, n_e),
                  f"burst edge {what}")
        bit_equal(torch, mt.burst_network_tiles(got_e, n_e), tile_e,
                  f"burst edge {what} applied twice")
    gather_edges(torch, gen, words, dev)
    scatter_edges(torch, gen, words, dev)
    # kernel 3 at an odd word count and off 16-byte alignment (the row copy
    # then moves narrower words)
    for what, tile_e in (
            ("odd W", words((32, 32, 4099))),
            ("unaligned view", words((1 + 4 * 4 * 24,))[1:].view(4, 4, 24))):
        got_e = mt.burst_network_tiles(tile_e, tile_e.shape[0])
        bit_equal(torch, got_e, mt.burst_network_plain(tile_e,
                                                       tile_e.shape[0]),
                  f"burst edge {what}")
        bit_equal(torch, mt.burst_network_tiles(got_e, tile_e.shape[0]),
                  tile_e, f"burst edge {what} applied twice")

    # -- the KV layout engine: the kernels line carries the ring layer's
    #    K/V pair (29 of the 34 launches per step), the full-attention
    #    layer's is printed ------------------------------------------------
    leaves = transpose_rows(torch, dev, gen, words)
    rows[ONE_SHOT] = {"medusa_transpose_tiles": leaves["L"]}

    # -- the rest of the dense family: kernels 1-3 at starcoder2-15b's
    #    served pool (N=4, head_dim 128; its dense tile is the one the pad
    #    layout and the gather-after-burst path move), kernels 1-2 at
    #    gemma3-12b's (N=8, head_dim 256: its engine runs the fused gather
    #    only); kernel 4 at starcoder2-15b's paged-fallback K/V pair (the
    #    off-geometry fabric's N=64 rounds the depth to 1600) and at
    #    gemma3-12b's ring layer's pair (40 of its 48 launches a step) -----
    rows["starcoder2-15b engine"] = burst_rows(
        torch, gen, words, "starcoder2-15b", STARCODER_PROMPT, STARCODER_GEN)
    g12 = burst_rows(torch, gen, words, "gemma3-12b", GEMMA_PROMPT,
                     GEMMA12_GEN)
    del g12["burst_network_tiles"]
    rows["gemma3-12b engine"] = g12
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    t_fallback = -(-(STARCODER_PROMPT + STARCODER_SHORT) // 64) * 64
    rows[SC_FALLBACK] = {"medusa_transpose_tiles": pair_row(
        torch, words, (ENGINE_SLOTS, t_fallback, 4, 128), flush,
        "starcoder2-15b layer's K and V")}
    rows[ONE_SHOT_12B] = {"medusa_transpose_tiles": pair_row(
        torch, words, (GEMMA_BATCH, 1024, 8, 256), flush,
        "gemma3-12b ring layer's K and V")}
    del flush
    torch.cuda.synchronize()
    for path, name, r in ([(p, k, r) for p, by in rows.items()
                           for k, r in by.items()]
                          + [(ONE_SHOT, "medusa_transpose_tiles",
                              leaves["A"])]):
        set_bound(r)
        print_row(name, path, r)
    return rows


def matmul_err(torch, got, x, w, what: str):
    """Hold kernel 7's ``got`` against its plain version (the float32
    product, cast to the operands' dtype).  float32: within rtol 1e-5 and
    atol 1e-4 * sqrt(K/128).  bf16: within one bf16 ulp of the plain
    version's cast, or, where a sum lands near zero and the two fp32 sums
    (tensor-core order vs the plain product's) differ by more than that
    ulp, within one ulp plus the same atol of the plain version's fp32
    product.  Returns the largest absolute difference from the plain
    version, the count of outputs more than one ulp from its cast and the
    largest excess over one ulp of the fp32 product (bf16 only)."""
    from repro_torch.kernels import stream_matmul as sm

    want = sm.stream_matmul_plain(x, w)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
          f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0, 0, 0.0
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    atol = 1e-4 * math.sqrt(max(x.shape[1], 1) / 128)
    diff = (got.float() - want.float()).abs()
    if x.dtype == torch.float32:
        worst = float((diff - 1e-5 * want.abs()).max())
        check(worst <= atol, f"{what}: {worst} beyond rtol 1e-5 + atol "
              f"{atol}")
        return float(diff.max()), 0, 0.0
    mag = want.abs()
    ulp = (mag.view(torch.int16) + 1).view(torch.bfloat16).float() \
        - mag.float()
    near = diff <= ulp
    excess = (got.float() - torch.matmul(x.float(), w.float())).abs() - ulp
    ok = near | (excess <= atol)
    check(bool(ok.all()), f"{what}: {int((~ok).sum())} outputs beyond one "
          f"bf16 ulp + atol {atol} of the plain version")
    return float(diff.max()), int((~near).sum()), float(excess.max())


def matmul_edges(torch, normal) -> None:
    """Kernel 7's routes at their edges: M in {1, 4, 16, 17, 64, 65, 129,
    257, 300} (both sides of the small-M threshold and of the 64-row
    warpgroup and 128-row block tiles; one, two and three 128-row tiles,
    so that the second block of the wgmma route's last pair of M tiles
    lies wholly past M at 17-65 and at 257 and 300), N != K, K
    below one stage, K past the small-M kernel's x chunk, K = 0, M and N
    ragged past the block tile, N and K off multiples of 8 and views off
    16-byte alignment.  Each product within :func:`matmul_err` of the plain
    version and bit-identical across two launches; every route taken."""
    from repro_torch.kernels import stream_matmul as sm

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(m, k, n, dt) for m in (1, 4, 16, 17, 64, 65, 129, 257, 300)
             for k, n, dt in ((40, 264, bf16), (520, 72, bf16),
                              (24, 67, f32), (1040, 136, f32))]
    # the small-M kernel refills x's rows past 1024 K rows of a block
    cases += [(4, 2600, 264, bf16), (16, 4104, 72, bf16)]
    cases += [(33, 16, 24, bf16), (130, 72, 264, bf16), (70, 33, 65, f32),
              (129, 200, 67, bf16), (64, 36, 128, bf16), (5, 0, 7, bf16),
              (5, 0, 8, bf16), (20, 0, 16, bf16), (4, 0, 12, f32)]
    operands = [(normal((m, k), dt), normal((k, n), dt))
                for m, k, n, dt in cases]
    # views 2 bytes off 16-byte alignment, x's and then w's
    base = normal((1 + 64 * 72,))
    operands += [(base[1:].view(64, 72), normal((72, 128))),
                 (normal((4, 64)), base[1:1 + 64 * 64].view(64, 64))]
    seen: dict = {}
    for x, w in operands:
        m, k = x.shape
        n = w.shape[1]
        r = sm.route(m, n, k, x.dtype, x.data_ptr(), w.data_ptr())
        what = (f"matmul edge [{m}, {k}] @ [{k}, {n}] "
                f"{str(x.dtype).replace('torch.', '')} ({r})")
        got = sm.stream_matmul(x, w)
        again = sm.stream_matmul(x, w)
        words_equal(torch, again, got, what + " launched twice")
        matmul_err(torch, got, x, w, what)
        seen[r] = seen.get(r, 0) + 1
    check(set(seen) == set(sm.ROUTES),
          f"matmul edges took routes {seen}, not all of {set(sm.ROUTES)}")
    print(f"matmul edges: {len(operands)} products by route {seen}, each "
          f"within matmul_err of the plain version and bit-identical across "
          f"two launches", flush=True)


def interconnect_phase(torch, dev):
    """Kernels 5-7, the slice's main path: the three ``ops`` entry points
    at the full widths of the served models, launch counts reset just
    before and read just after; then each result held against its plain
    version, the edge cases, and the timings (kernel, plain version, one
    library call).  Returns the rows of the kernels line by path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch as kl
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.kernels import ops
    from repro_torch.kernels import rotator as rot
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16, PEAK_FLOPS_FP32

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def words(shape, dtype=torch.int16):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(dtype)

    def normal(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # stablelm-1.6b's K pool leaf (layers, pages, page slots, KV heads =
    # N ports, head_dim) viewed as its line stream; gemma3-4b's pool lines
    slm, gem = get_config("stablelm-1.6b"), get_config("gemma3-4b")
    n_s, n_g = slm.resolved_fabric.n_ports, gem.resolved_fabric.n_ports
    k_pool = words((slm.n_layers, 32, 64, n_s, slm.resolved_head_dim)
                   ).view(torch.bfloat16)
    lines_s = k_pool.view(-1, n_s, slm.resolved_head_dim)
    lines_g = words((32000, n_g, gem.resolved_head_dim)).view(torch.bfloat16)
    amounts = torch.randint(-4 * n_s, 4 * n_s, (lines_s.shape[0],),
                            generator=gen, device=dev, dtype=torch.int32)
    d, f = gem.d_model, gem.d_ff
    w_up = normal((d, f))
    matmuls = {
        f"gemma3-4b MLP up-projection, prefill ({GEMMA_BATCH} x "
        f"{GEMMA_PROMPT} tokens)": (normal((GEMMA_BATCH * GEMMA_PROMPT, d)),
                                    w_up),
        f"gemma3-4b MLP up-projection, decode ({GEMMA_BATCH} tokens)": (
            normal((GEMMA_BATCH, d)), w_up),
        "float32 square": (normal((1024, 1024), torch.float32),
                           normal((1024, 1024), torch.float32)),
        "ragged bf16": (normal((129, 200)), normal((200, 67))),
        "ragged float32": (normal((129, 200), torch.float32),
                           normal((200, 67), torch.float32)),
    }
    # the kernel each must go through (stream_matmul.route)
    want_route = dict(zip(matmuls, ("wgmma", "small_m", "fma", "mma_sync",
                                    "fma")))
    k5_paths = {f"{INTERCONNECT}: stablelm-1.6b K pool": (lines_s, n_s),
                f"{INTERCONNECT}: gemma3-4b K pool": (lines_g, n_g)}
    k6_path = f"{INTERCONNECT}: stablelm-1.6b K pool"

    # -- the main path: counts reset just before, read just after ----------
    outs, launches = {}, {}

    def drive(key, fn):
        before = mt.launch_counts()
        outs[key] = fn()
        after = mt.launch_counts()
        launches[key] = sum(after[k] - before[k] for k in after)

    torch.cuda.synchronize()
    mt.reset_launch_counts()
    for path, (lines, n) in k5_paths.items():
        drive(("k5", path), lambda: ops.interconnect_read(lines, n))
    drive(("k6", k6_path), lambda: ops.rotate_groups(lines_s, amounts))
    for label, (x, w) in matmuls.items():
        drive(("k7", label), lambda: ops.matmul(x, w))
    torch.cuda.synchronize()
    counts = mt.launch_counts()
    want = {**ZERO_LAUNCHES, "read_network_tiles": len(k5_paths),
            "barrel_rotate_groups": 1, "stream_matmul": len(matmuls)}
    check(counts == want, f"interconnect: launches {counts} != {want}")
    print(f"interconnect: {counts['read_network_tiles']} read-network, "
          f"{counts['barrel_rotate_groups']} barrel-rotator and "
          f"{counts['stream_matmul']} matmul launches through ops", flush=True)

    rows = {}
    # -- kernel 5: bit-equal, timed beside the plain version and the library
    for path, (lines, n) in k5_paths.items():
        got = outs[("k5", path)]
        err = words_equal(torch, got, mt.read_network_plain(lines, n),
                          f"read network ({path})")
        g, _, w = lines.shape[0] // n, n, lines.shape[2]

        def library(lines=lines, n=n, g=g, w=w):
            return lines.view(g, n, n, w).transpose(1, 2).contiguous()

        words_equal(torch, library(), got, "read network library yardstick")
        rows[path] = {"read_network_tiles": dict(
            launches=launches[("k5", path)], max_abs_err=err,
            bytes=kl.kernel_cost("read_network_tiles", lines=lines)[0],
            ms=time_ms(torch, lambda: mt.read_network_tiles(lines, n)),
            plain_ms=time_ms(torch, lambda: mt.read_network_plain(lines, n)),
            library_ms=time_ms(torch, library),
            shape=f"lines {list(lines.shape)} bf16, N={n}")}

    # -- kernel 6 ----------------------------------------------------------
    got = outs[("k6", k6_path)]
    err = words_equal(torch, got, rot.barrel_rotate_plain(lines_s, amounts),
                      "barrel rotate (stablelm-1.6b lines)")
    g, n, w = lines_s.shape
    cols = torch.arange(n, device=dev)

    def rotate_library():
        idx = (cols + amounts[:, None].long()) % n
        return torch.gather(lines_s, 1, idx[:, :, None].expand(g, n, w))

    words_equal(torch, rotate_library(), got, "rotate library yardstick")
    rows[k6_path]["barrel_rotate_groups"] = dict(
        launches=launches[("k6", k6_path)], max_abs_err=err,
        bytes=kl.kernel_cost("barrel_rotate_groups", x=lines_s,
                             amounts=amounts)[0],
        ms=time_ms(torch, lambda: rot.barrel_rotate_groups(lines_s, amounts)),
        plain_ms=time_ms(torch, lambda: rot.barrel_rotate_plain(lines_s,
                                                                amounts)),
        library_ms=time_ms(torch, rotate_library),
        shape=f"x {list(lines_s.shape)} bf16, amounts [{g}] int32 in "
              f"[{-4 * n}, {4 * n})")
    del got, outs[("k6", k6_path)]
    for path in k5_paths:
        del outs[("k5", path)]

    # -- kernel 7: the decode product streams its weight once per step, so
    #    it is timed out of a flushed L2; the others with a warm one --------
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for label, (x, w) in matmuls.items():
        got = outs.pop(("k7", label))
        err, n_far, excess = matmul_err(torch, got, x, w,
                                        f"matmul ({label})")
        m, k = x.shape
        n = w.shape[1]
        r = sm.route(m, n, k, x.dtype, x.data_ptr(), w.data_ptr())
        check(r == want_route[label],
              f"matmul ({label}) took the {r} route, not {want_route[label]}")
        words_equal(torch, sm.stream_matmul(x, w), got,
                    f"matmul ({label}) launched again")
        cold = flush if "decode" in label else None
        nbytes, flops = kl.kernel_cost("stream_matmul", x=x, w=w, out=got)
        rows[f"{INTERCONNECT}: {label}"] = {"stream_matmul": dict(
            launches=launches[("k7", label)], max_abs_err=err,
            matmul_route=r, bytes=nbytes, flops=flops,
            peak=PEAK_FLOPS_FP32 if x.dtype == torch.float32
            else PEAK_FLOPS_BF16,
            ms=time_ms(torch, lambda: sm.stream_matmul(x, w), flush=cold),
            plain_ms=time_ms(torch, lambda: sm.stream_matmul_plain(x, w),
                             flush=cold),
            library_ms=time_ms(torch, lambda: torch.matmul(x, w),
                               flush=cold),
            shape=f"[{m}, {k}] @ [{k}, {n}] "
                  f"{str(x.dtype).replace('torch.', '')}")}
        if cold is not None:
            # the ranking under the write flush above, again after a flush
            # that only reads (clean lines in the L2 when the product starts)
            row = rows[f"{INTERCONNECT}: {label}"]["stream_matmul"]
            row["ms_read_flush"] = time_ms(
                torch, lambda: sm.stream_matmul(x, w), flush=cold,
                read_flush=True)
            row["library_ms_read_flush"] = time_ms(
                torch, lambda: torch.matmul(x, w), flush=cold,
                read_flush=True)
            print(f"matmul ({label}): kernel {row['ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms after a write flush; kernel "
                  f"{row['ms_read_flush']:.4f} ms, library "
                  f"{row['library_ms_read_flush']:.4f} ms after a read-only "
                  f"flush", flush=True)
        if x.dtype == torch.bfloat16:
            print(f"matmul ({label}): max abs {err} from the plain version; "
                  f"{n_far} of {got.numel()} outputs more than one bf16 ulp "
                  f"from its cast; largest excess over one ulp of its fp32 "
                  f"product {excess:.3g} (atol "
                  f"{1e-4 * math.sqrt(k / 128):.3g})", flush=True)
    del flush, matmuls, w_up, k_pool, lines_g

    # -- edge cases --------------------------------------------------------
    for dtype, shape, n in ((torch.uint8, (12, 4, 5), 4),
                            (torch.bfloat16, (16, 8, 3), 8),
                            (torch.int32, (6, 2, 1), 2),
                            (torch.int64, (5, 1, 7), 1),
                            (torch.float32, (64, 32, 3), 32),
                            (torch.bfloat16, (8, 4, 256), 4)):
        if dtype == torch.int64:              # two random 32-bit halves
            x = words(tuple(shape) + (2,), torch.int32).view(torch.int64)[
                ..., 0]
        elif dtype == torch.uint8:
            x = words(shape).to(torch.uint8)
        elif dtype.is_floating_point:         # NaN payloads and -0.0
            iw = {2: torch.int16, 4: torch.int32}[dtype.itemsize]
            x = words(shape, iw)
            x.view(-1)[:3] = torch.tensor(
                {2: [0x7FC1, -0x5B, -0x8000],
                 4: [0x7FC12345, -0x7FFFFF, -2 ** 31]}[dtype.itemsize],
                dtype=iw)
            x = x.view(dtype)
        else:
            x = words(shape, dtype)
        what = f"read network edge {dtype} {list(shape)} N={n}"
        words_equal(torch, ops.interconnect_read(x, n),
                    mt.read_network_plain(x, n), what)
        amt = torch.tensor([0, n, -1, n - 1, n + 1, -3 * n - 1, 4 * n,
                            7, -9, 2 * n, 5, -n][:shape[0]], device=dev)
        amt = amt.repeat(-(-shape[0] // amt.numel()))[:shape[0]]
        got = ops.rotate_groups(x, amt)              # int64 amounts
        words_equal(torch, got, rot.barrel_rotate_plain(x, amt),
                    what.replace("read network", "rotate"))
        words_equal(torch, got, torch.stack(
            [torch.roll(x[i], -int(a), 0) for i, a in enumerate(amt)]),
            what.replace("read network", "rotate vs roll"))
    base = words((1 + 8 * 4 * 16,)).view(torch.bfloat16)
    x = base[1:].view(8, 4, 16)               # 2-byte aligned, not 16
    words_equal(torch, mt.read_network_tiles(x, 4),
                mt.read_network_plain(x, 4), "read network unaligned view")
    a8 = torch.arange(-4, 4, device=dev, dtype=torch.int32)
    words_equal(torch, rot.barrel_rotate_groups(x, a8),
                rot.barrel_rotate_plain(x, a8), "rotate unaligned view")
    for bad in (lambda: mt.read_network_tiles(
                    torch.zeros((12, 6, 2), device=dev), 6),
                lambda: rot.barrel_rotate_groups(x, a8[:7]),
                lambda: sm.stream_matmul(normal((4, 8)),
                                         normal((8, 4), torch.float32))):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        fail("a kernel wrapper accepted operands its kernel cannot take")
    matmul_edges(torch, normal)
    torch.cuda.synchronize()
    for path, by in rows.items():
        for name, r in by.items():
            set_bound(r)
            print_row(name, path, r)
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def serve(torch, cfg, params, prompts, gen_len: int, **engine_kw):
    """Serve ``prompts`` through the port's engine (``engine_kw`` passed
    on); returns the token streams, per-step wall times (synchronised) and
    the engine."""
    from repro_torch.serving import Request, ServingEngine

    t_max = prompts.shape[1] + gen_len
    eng = ServingEngine(cfg, params, max_slots=len(prompts), t_max=t_max,
                        check_pool=True, **engine_kw)
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


def census(torch, label: str, step, out_name: str) -> None:
    """``repro_torch.launch.profile.device_census`` over ``PROFILE_STEPS``
    calls of ``step()`` (after ``PROFILE_WARM`` unprofiled ones): the
    device's busy share of the window (union of kernel intervals over the
    host's wall time), kernels, launch calls and aten ops per step, and
    device time by kernel, printed; the full tables go to
    ``chiprun_out/profile_<out_name>.txt``."""
    from repro_torch.launch.profile import device_census

    c = device_census(step, PROFILE_WARM, PROFILE_STEPS)
    print(f"profile {label}: {c['steps']} steps, {c['step_ms']:.3f} ms per "
          f"step under the profiler; device busy {c['busy_ms']:.3f} ms of "
          f"{c['wall_ms']:.3f} ms = {100 * c['busy_share']:.2f} %; "
          f"{c['kernels_per_step']:.1f} device kernels, "
          f"{c['launch_calls_per_step']:.1f} launch calls and "
          f"{c['aten_ops_per_step']:.1f} aten ops per step", flush=True)
    check(c["kernels_per_step"] > 0, "the profiler recorded no device kernels")
    lines = [f"{t / c['steps'] / 1e3:9.4f} ms/step {n / c['steps']:7.1f}"
             f" launches/step  {name}" for name, n, t in c["by_kernel"]]
    for line in lines[:12]:
        print(f"profile {label} kernel: {line[:150]}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{out_name}.txt").write_text(
        "\n".join(lines) + "\n\n" + c["table"] + "\n")


def profile_serve(torch, cfg, params, prompts) -> None:
    """The census of the stablelm engine's fused decode steps."""
    from repro_torch.serving import Request, ServingEngine

    gen_len = PROFILE_WARM + PROFILE_STEPS + 2
    eng = ServingEngine(cfg, params, max_slots=len(prompts),
                        t_max=prompts.shape[1] + gen_len, fused_gather=True)
    for i in range(len(prompts)):
        eng.submit(Request(i, prompts[i], max_new_tokens=gen_len))
    census(torch, "stablelm-1.6b fused engine", eng.step, "serve")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def profile_one_shot(torch, api, ops, cfg, params, prompt) -> None:
    """The census of gemma3-4b's one-shot decode steps (``api.decode_fn``
    without a scheduler), with the layout-engine kernel on and off in turns
    (on, off, on, off) from one prefill, positions advancing."""
    s = prompt.shape[1]
    logits, caches = api.prefill_fn(params, {"tokens": prompt}, cfg,
                                    s + GEMMA_GEN)
    state = {"tok": torch.argmax(logits[:, -1], dim=-1)[:, None].to(
        prompt.dtype), "pos": s}

    def step():
        lg, _ = api.decode_fn(params, state["tok"], caches, state["pos"], cfg)
        state["tok"] = torch.argmax(lg[:, -1], dim=-1)[:, None].to(
            prompt.dtype)
        state["pos"] += 1
    for turn, on in enumerate((True, False, True, False)):
        ops.use_kernels(on)
        try:
            census(torch, f"gemma3-4b one-shot kernels={'on' if on else 'off'}",
                   step, f"one_shot_{turn}_{'on' if on else 'off'}")
        finally:
            ops.use_kernels(True)
    del caches
    gc.collect()
    torch.cuda.empty_cache()


def engine_paths(torch, cfg, params, prompts, rows, leaf_shape, label):
    """Serve ``prompts`` (64 tokens each) on the fused-gather and the
    gather-after-burst path, counts reset just before each and read just
    after; the pool leaf's shape, the launch counts (no layout-engine
    launch), finite logits and equal token streams are checked.  The
    counts add to the path's ``rows``."""
    from repro_torch.kernels import medusa_transpose as mt

    runs = {}
    for fused in (True, False):
        mt.reset_launch_counts()
        toks, steps, eng = serve(torch, cfg, params, prompts, 64,
                                 fused_gather=fused)
        counts = mt.launch_counts()
        fs, kv = eng.fabric_stats, eng.kv
        kind, i = eng.kv.paged_entries[0]
        leaf = kv.caches[kind][i]["k"]
        check(tuple(leaf.shape) == leaf_shape
              and leaf.dtype == torch.bfloat16,
              f"{label}: pool leaf {leaf.dtype} {tuple(leaf.shape)}")
        waves = kv.prefill_bursts
        decode_steps = (fs.flushes - waves) // 2
        check(decode_steps == 63 and waves == 1,
              f"{label}: expected 63 decode steps in 1 wave, got "
              f"{decode_steps} in {waves}")
        if fused:
            want = {**ZERO_LAUNCHES,
                    "gather_burst_network_tiles": 2 * decode_steps,
                    "scatter_burst_network_tiles": 2 * decode_steps
                    + 2 * waves}
        else:
            want = {**ZERO_LAUNCHES,
                    "burst_network_tiles": 2 * decode_steps + waves}
        check(counts == want,
              f"{label} fused={fused}: launches {counts} != {want}")
        for name, r in rows[f"{label} engine"].items():
            r["launches"] = r.get("launches", 0) + counts[name]
        flat = [t for s in toks for t in s]
        check(all(len(s) == 64 for s in toks), f"{label}: short streams")
        check(all(0 <= t < cfg.vocab_size for t in flat),
              f"{label}: token outside the vocab")
        check(bool(torch.isfinite(eng.last_logits).all()),
              f"{label}: non-finite logits")
        dec = steps[1:]
        tok_s = sum(len(s) for s in toks) / sum(steps)
        print(f"{label} engine fused_gather={fused}: {len(toks)} requests x "
              f"64 tokens in {sum(steps):.3f}s ({tok_s:.1f} tok/s incl. "
              f"prefill); median decode step "
              f"{statistics.median(dec) * 1e3:.3f} ms over {len(dec)} steps; "
              f"admission step {steps[0] * 1e3:.1f} ms; launches {counts}",
              flush=True)
        runs[fused] = toks, statistics.median(dec)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    check(runs[True][0] == runs[False][0],
          f"{label}: fused and gather-after-burst paths served different "
          f"tokens")
    return runs[True]


def crossbar_engine(torch, cfg, params, prompts, medusa, label):
    """Serve ``prompts`` on the fused path of the crossbar fabric (every
    burst a gather through an index tensor, no Medusa kernel): the tokens
    must equal the medusa engine's (``medusa``: its tokens and median
    step)."""
    from repro_torch.kernels import medusa_transpose as mt

    xcfg = dataclasses.replace(cfg, kv_layout="crossbar")
    mt.reset_launch_counts()
    toks, steps, eng = serve(torch, xcfg, params, prompts, 64,
                             fused_gather=True)
    counts = mt.launch_counts()
    check(counts == ZERO_LAUNCHES,
          f"{label} crossbar engine launched Medusa kernels: {counts}")
    check(eng.fabric.impl == "crossbar", f"{label}: not the crossbar fabric")
    check(toks == medusa[0], f"{label}: the crossbar engine served other "
          f"tokens than the medusa engine")
    print(f"{label} engine crossbar fabric: tokens equal to medusa's; median "
          f"decode step {statistics.median(steps[1:]) * 1e3:.3f} ms "
          f"(medusa fused {medusa[1] * 1e3:.3f} ms)", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def stablelm_phase(torch, dev, rows, with_profile: bool):
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import api

    cfg = get_config("stablelm-1.6b")
    prompts = SyntheticLM(cfg, batch=ENGINE_SLOTS, seq=STABLELM_PROMPT,
                          seed=0).batch_at(0)["tokens"]
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"serve: stablelm-1.6b full width ({cfg.param_count()} params, "
          f"bf16) initialised in {time.perf_counter() - t0:.1f}s", flush=True)
    medusa = engine_paths(torch, cfg, params, prompts, rows,
                          (24, 32, 64, 32, 64), "stablelm-1.6b")
    crossbar_engine(torch, cfg, params, prompts, medusa, "stablelm-1.6b")
    if with_profile:
        profile_serve(torch, cfg, params, prompts)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def generate(torch, api, params, prompt, cfg, steps: int, t_max: int,
             extra=None):
    """``api.greedy_generate`` (with the batch entries ``extra``) with
    every step's logits kept and the synchronised interval between
    consecutive steps' logits timed."""
    logits, stamps = [], []

    def on_step(i, lg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        logits.append(lg.clone())
    toks = api.greedy_generate(params, prompt, cfg, steps=steps, t_max=t_max,
                               extra=extra, on_step=on_step)
    torch.cuda.synchronize()
    return toks, logits, [b - a for a, b in zip(stamps, stamps[1:])]


def same_steps(torch, logits, other, label: str) -> None:
    """Fail unless two runs' step logits are bit-identical."""
    for i, (a, c) in enumerate(zip(logits, other)):
        check(torch.equal(a.view(torch.int32), c.view(torch.int32)),
              f"{label}: step {i} logits differ "
              f"(max abs {float((a - c).abs().max())})")


def gemma_phase(torch, dev, rows, with_profile: bool):
    """gemma3-4b at full width: the one-shot generate through the per-layer
    decode path (kernel 4), kernels on and off, then the engine."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.kernels import ops
    from repro_torch.models import api

    cfg = get_config("gemma3-4b")
    b, s, g = GEMMA_BATCH, GEMMA_PROMPT, GEMMA_GEN
    prompts = SyntheticLM(cfg, batch=b, seq=s, seed=0).batch_at(0)["tokens"]
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"serve: gemma3-4b full width ({cfg.param_count()} params, bf16) "
          f"initialised in {time.perf_counter() - t0:.1f}s", flush=True)
    prompt = torch.as_tensor(prompts, device=dev)

    # (a) one-shot: per-layer decode, one layout-engine launch per layer
    #     for its K and V
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    toks, logits, steps = generate(torch, api, params, prompt, cfg, g, s + g)
    wall = time.perf_counter() - t0
    counts = mt.launch_counts()
    per_step = cfg.n_layers
    want = {**ZERO_LAUNCHES, "medusa_transpose_tiles": per_step * g}
    check(counts == want, f"gemma3 one-shot: launches {counts} != {want}")
    rows[ONE_SHOT]["medusa_transpose_tiles"]["launches"] = counts[
        "medusa_transpose_tiles"]
    check(tuple(toks.shape) == (b, g), f"one-shot tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "one-shot token outside the vocab")
    check(all(bool(torch.isfinite(lg).all()) for lg in logits),
          "one-shot: non-finite logits")
    print(f"gemma3-4b one-shot: batch {b} x prompt {s} + {g} tokens in "
          f"{wall:.3f}s ({b * g / wall:.1f} tok/s incl. prefill); median "
          f"decode step {statistics.median(steps) * 1e3:.3f} ms over "
          f"{len(steps)} steps; {per_step} layout-engine launches per step "
          f"({counts['medusa_transpose_tiles']} in all)", flush=True)

    # the same run with the kernels off: pure movement, so bit-identical
    ops.use_kernels(False)
    try:
        mt.reset_launch_counts()
        toks_off, logits_off, steps_off = generate(torch, api, params, prompt,
                                                   cfg, g, s + g)
        check(mt.launch_counts()["medusa_transpose_tiles"] == 0,
              "kernels off still launched the layout engine")
    finally:
        ops.use_kernels(True)
    check(torch.equal(toks, toks_off),
          "one-shot tokens differ with the kernels on and off")
    same_steps(torch, logits, logits_off, "gemma3 one-shot, kernels on and "
               "off")
    print(f"gemma3-4b one-shot kernels off: tokens and all {g} steps' logits "
          f"bit-identical; median decode step "
          f"{statistics.median(steps_off) * 1e3:.3f} ms", flush=True)

    # the crossbar fabric: every layer's K/V read is a gather through an
    # index tensor, no Medusa kernel; pure movement into the same
    # contiguous port-major layout, so bit-identical again
    xcfg = dataclasses.replace(cfg, kv_layout="crossbar")
    mt.reset_launch_counts()
    toks_x, logits_x, steps_x = generate(torch, api, params, prompt, xcfg, g,
                                         s + g)
    check(mt.launch_counts() == ZERO_LAUNCHES,
          f"the crossbar one-shot launched Medusa kernels: "
          f"{mt.launch_counts()}")
    check(torch.equal(toks, toks_x),
          "one-shot tokens differ between the medusa and crossbar fabrics")
    same_steps(torch, logits, logits_x, "gemma3 one-shot, the medusa and "
               "crossbar fabrics")
    print(f"gemma3-4b one-shot crossbar fabric: tokens and all {g} steps' "
          f"logits bit-identical to medusa's; median decode step "
          f"{statistics.median(steps_x) * 1e3:.3f} ms (medusa "
          f"{statistics.median(steps) * 1e3:.3f} ms)", flush=True)
    del logits, logits_off, logits_x
    gc.collect()
    torch.cuda.empty_cache()
    if with_profile:
        profile_one_shot(torch, api, ops, cfg, params, prompt)

    # (b) the engine: paged A layers through the bursts, per-slot L rings
    reps = cfg.n_layers // len(cfg.block_pattern)
    engine_paths(torch, cfg, params, prompts, rows,
                 (reps, b * -(-(s + g) // 64), 64, cfg.n_kv_heads,
                  cfg.resolved_head_dim), "gemma3-4b")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def engine_run(torch, cfg, params, prompts, gen_len: int, label: str,
               want: dict, **engine_kw):
    """Serve ``prompts`` (``gen_len`` tokens each, one admission wave)
    through the engine with ``engine_kw``: launch counts reset just before
    and read just after (they must be ``want``), the peak memory reset
    before; checks every request decoded ``gen_len`` tokens inside the
    vocab and the last logits are finite.  Prints the median decode step,
    each kernel's launches per decode step and the peak memory.  Returns
    the token streams, the median decode step (s), the launch counts and
    the engine's fabric counters."""
    from repro_torch.kernels import medusa_transpose as mt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    toks, steps, eng = serve(torch, cfg, params, prompts, gen_len,
                             **engine_kw)
    counts = mt.launch_counts()
    decode_steps = eng.step_count
    check(decode_steps == gen_len - 1,
          f"{label}: {decode_steps} decode steps, not {gen_len - 1}")
    check(counts == {**ZERO_LAUNCHES, **want},
          f"{label}: launches {counts} != {want}")
    check(all(len(t) == gen_len for t in toks), f"{label}: short streams")
    check(all(0 <= t < cfg.vocab_size for s in toks for t in s),
          f"{label}: token outside the vocab")
    check(bool(torch.isfinite(eng.last_logits).all()),
          f"{label}: non-finite logits")
    med = statistics.median(steps[1:])
    per_step = {k: v / decode_steps for k, v in counts.items() if v}
    tok_s = sum(len(t) for t in toks) / sum(steps)
    print(f"{label}: median decode step {med * 1e3:.3f} ms over "
          f"{decode_steps - 1} steps; {tok_s:.1f} tok/s incl. prefill; "
          f"admission step {steps[0] * 1e3:.1f} "
          f"ms; launches per decode step {per_step}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    stats = eng.fabric_stats
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return toks, med, counts, stats


def load_model(torch, dev, arch: str):
    """``arch`` at full width, random bf16 weights from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"serve: {arch} full width ({cfg.param_count()} params, bf16) "
          f"initialised in {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated",
          flush=True)
    return cfg, params


def free_model(torch, label: str) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label}: freed; {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          f"GiB still allocated", flush=True)


def starcoder2_phase(torch, dev, rows) -> None:
    """starcoder2-15b at full width (40 layers, d_model 6144, 48 heads, 4
    KV heads = N ports, head_dim 128, d_ff 24576, vocab 49152, gelu, ln,
    tied) through the engine on every path of the dense family, the same
    four prompts of 1536 tokens: (a) the fused gather (kernels 1-2), 64
    tokens; then 16 tokens each on (b) the pad layout with the gather
    after the burst (kernel 3 on the padded tile), (c) the dense per-slot
    layout (kernel 3), (d) the per-leaf splice admission, (e) the fused
    fabric (the per-layer paged decode attending line-major, no kernel)
    and (f) a medusa fabric off the port-per-KV-head geometry (the
    per-layer paged decode, kernel 4 per leaf per layer).  Tokens must be
    equal across the paths on their common prefix."""
    from repro_torch.configs.base import FabricConfig
    from repro_torch.data import SyntheticLM

    cfg, params = load_model(torch, dev, "starcoder2-15b")
    prompts = SyntheticLM(cfg, batch=ENGINE_SLOTS, seq=STARCODER_PROMPT,
                          seed=0).batch_at(0)["tokens"]
    fab = cfg.resolved_fabric
    pad = dataclasses.replace(
        cfg, fabric=dataclasses.replace(fab, pack="pad"))
    off_geometry = dataclasses.replace(cfg, fabric=FabricConfig(
        n_ports=cfg.n_kv_heads * cfg.resolved_head_dim // 8, lane_width=8))
    long, short = STARCODER_GEN - 1, STARCODER_SHORT - 1
    sparse = {"gather_burst_network_tiles": 2 * short,
              "scatter_burst_network_tiles": 2 * short}
    paths = (
        ("a", "fused gather", cfg, STARCODER_GEN, {},
         {"gather_burst_network_tiles": 2 * long,
          "scatter_burst_network_tiles": 2 * long + 2}),
        ("b", "pad layout, gather after the burst", pad, STARCODER_SHORT,
         dict(fused_gather=False), {"burst_network_tiles": 2 * short + 1}),
        ("c", "dense per-slot layout", cfg, STARCODER_SHORT,
         dict(paged_pool=False), {"burst_network_tiles": 2 * short}),
        ("d", "per-leaf splice admission", cfg, STARCODER_SHORT,
         dict(prefill_burst=False), sparse),
        ("e", "fused fabric", dataclasses.replace(cfg, kv_layout="fused"),
         STARCODER_SHORT, {}, {}),
        ("f", "medusa fabric off the geometry (N=64, W_acc=8)",
         off_geometry, STARCODER_SHORT, {},
         {"medusa_transpose_tiles": cfg.n_layers * short}))
    main = None
    for key, what, pcfg, gen_len, kw, want in paths:
        label = f"starcoder2-15b engine ({key}) {what}"
        toks, _, counts, stats = engine_run(torch, pcfg, params, prompts,
                                            gen_len, label, want, **kw)
        for path in ("starcoder2-15b engine", SC_FALLBACK):
            for name, r in rows[path].items():
                r["launches"] = r.get("launches", 0) + counts[name]
        if key == "b":
            print(f"{label}: {stats.words_moved} words moved, "
                  f"{stats.words_padded} padded (K and V are equally wide)",
                  flush=True)
        if main is None:
            main = toks
        else:
            check(all(t == m[:gen_len] for t, m in zip(toks, main)),
                  f"{label}: tokens differ from path (a)'s on their common "
                  f"prefix")
    print(f"starcoder2-15b: tokens equal across paths (a)-(f) on their "
          f"first {STARCODER_SHORT}", flush=True)
    del params
    free_model(torch, "starcoder2-15b")


def gemma3_12b_phase(torch, dev, rows) -> None:
    """gemma3-12b at full width (48 layers ``LLLLLA``, d_model 3840, 8 KV
    heads = N ports, head_dim 256, d_ff 15360, vocab 262144, window 1024):
    4 requests of 1536 tokens through the engine with the fused gather
    (kernels 1-2 at N=8), then the one-shot ``greedy_generate`` of the same
    prompts with the kernels on (kernel 4, 48 launches a step).  The two
    must serve the same tokens."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.models import api

    cfg, params = load_model(torch, dev, "gemma3-12b")
    b, s, g = GEMMA_BATCH, GEMMA_PROMPT, GEMMA12_GEN
    prompts = SyntheticLM(cfg, batch=b, seq=s, seed=0).batch_at(0)["tokens"]
    toks_e, med_e, counts, _ = engine_run(
        torch, cfg, params, prompts, g, "gemma3-12b engine (fused gather)",
        {"gather_burst_network_tiles": 2 * (g - 1),
         "scatter_burst_network_tiles": 2 * (g - 1) + 2})
    for name, r in rows["gemma3-12b engine"].items():
        r["launches"] = r.get("launches", 0) + counts[name]

    # the one-shot: the prefill's token is fed in, the g - 1 decode steps'
    # tokens come back (the engine's first token is the prefill's)
    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    prompt = torch.as_tensor(prompts, device=dev)
    toks, logits, steps = generate(torch, api, params, prompt, cfg, g - 1,
                                   s + g)
    counts = mt.launch_counts()
    per_step = cfg.n_layers
    want = {**ZERO_LAUNCHES, "medusa_transpose_tiles": per_step * (g - 1)}
    check(counts == want, f"gemma3-12b one-shot: launches {counts} != "
          f"{want}")
    rows[ONE_SHOT_12B]["medusa_transpose_tiles"]["launches"] = counts[
        "medusa_transpose_tiles"]
    check(all(bool(torch.isfinite(lg).all()) for lg in logits),
          "gemma3-12b one-shot: non-finite logits")
    print(f"gemma3-12b one-shot (kernels on): median decode step "
          f"{statistics.median(steps) * 1e3:.3f} ms over {len(steps)} "
          f"steps; {per_step} layout-engine launches per step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    got = toks.tolist()
    check(all(o == e[1:] for o, e in zip(got, toks_e)),
          "gemma3-12b: the engine and the one-shot served other tokens")
    print(f"gemma3-12b: engine and one-shot tokens equal ({b} x {g - 1} "
          f"decoded); engine median step {med_e * 1e3:.3f} ms", flush=True)
    del params, logits
    free_model(torch, "gemma3-12b")


def fsdp_phase(torch, dev, rows) -> None:
    """stablelm-1.6b at full width through the fused-gather engine with
    ``serve_fsdp``: every weight leaf whose size divides N² rides the
    decode step's read burst (one kernel-3 launch a step for the packed
    weight tile) and the step computes with what comes back.  Tokens must
    equal the same engine's without the stream; the weight words per step
    must be the streamed leaves' sizes.  Then kernel 3 at that weight tile,
    bit for bit against its plain version and timed."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import launch as kl
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.models import lm

    cfg, params = load_model(torch, dev, "stablelm-1.6b")
    prompts = SyntheticLM(cfg, batch=ENGINE_SLOTS, seq=STABLELM_PROMPT,
                          seed=0).batch_at(0)["tokens"]
    g = FSDP_GEN
    n = cfg.resolved_fabric.n_ports
    sparse = {"gather_burst_network_tiles": 2 * (g - 1),
              "scatter_burst_network_tiles": 2 * (g - 1) + 2}
    base, _, _, base_stats = engine_run(
        torch, cfg, params, prompts, g, "stablelm-1.6b engine (fused gather)",
        sparse)
    fcfg = dataclasses.replace(cfg, serve_fsdp=True)
    toks, med, counts, stats = engine_run(
        torch, fcfg, params, prompts, g,
        "stablelm-1.6b engine (fused gather, serve_fsdp)",
        {**sparse, "burst_network_tiles": g - 1})
    check(toks == base, "serve_fsdp served other tokens than the same "
          "engine without the weight stream")
    # the streamed leaves, in the reference's tree order, from a model on
    # the meta device (shapes only)
    sizes = [sum(pdict[name].numel() for pdict, name in slots)
             for slots in lm._weight_slots(lm.LM(cfg, torch.device("meta")))]
    streamed = [x for x in sizes if x % (n * n) == 0]
    per_step = (stats.words_moved - base_stats.words_moved) // (g - 1)
    check(per_step == sum(streamed),
          f"serve_fsdp: {per_step} weight words a step, not the streamed "
          f"leaves' {sum(streamed)}")
    rows[FSDP] = {"burst_network_tiles": {"launches": counts[
        "burst_network_tiles"]}}
    print(f"stablelm-1.6b serve_fsdp: tokens equal to the engine without "
          f"it; {len(streamed)} of {len(sizes)} weight leaves streamed, "
          f"{per_step} bf16 words ({per_step * 2 / 1e9:.3f} GB) and "
          f"{counts['burst_network_tiles'] / (g - 1):.0f} kernel-3 launch "
          f"per decode step", flush=True)
    del params
    free_model(torch, "stablelm-1.6b serve_fsdp")

    # kernel 3 at the weight tile: bf16 pairs folded into 32-bit words
    check(all((x // (n * n)) % 2 == 0 for x in streamed),
          "a streamed leaf's width is odd: the tile would not fold")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    info = torch.iinfo(torch.int32)
    tile = torch.randint(info.min, info.max,
                         (n, n, sum(streamed) // (n * n) // 2),
                         generator=gen, device=dev, dtype=torch.int32)
    got = mt.burst_network_tiles(tile, n)
    err = bit_equal(torch, got, mt.burst_network_plain(tile, n),
                    "burst (serve_fsdp weight tile)")
    check(torch.equal(mt.burst_network_tiles(got, n), tile),
          "burst (serve_fsdp weight tile) is not an involution")
    del got
    r = rows[FSDP]["burst_network_tiles"]
    r.update(max_abs_err=err, bytes=kl.kernel_cost("burst_network_tiles",
                                                   tile=tile)[0],
             ms=time_ms(torch, lambda: mt.burst_network_tiles(tile, n)),
             plain_ms=time_ms(torch, lambda: mt.burst_network_plain(tile,
                                                                     n)),
             library_ms=time_ms(torch,
                                lambda: tile.transpose(0, 1).contiguous()),
             shape=f"tile {list(tile.shape)} int32")
    set_bound(r)
    print_row("burst_network_tiles", FSDP, r)
    del tile
    gc.collect()
    torch.cuda.empty_cache()


class SwapProbe:
    """Wraps one engine's ``kv.swap_out`` and ``kv.swap_in``: the host clock
    around each call, ending in a synchronize, and the part of it spent in
    the parity words (:data:`PARITY`); the attempts (a corrupted transfer
    is sent twice) and bytes of each transfer; and, after each swap-in, the
    movement check — the slot's frames gathered back at their new physical
    rows, and its ring rows on their slot axis, bit-equal to its
    ``SwapRecord``."""

    def __init__(self, torch, eng):
        kv = eng.kv
        swap_out, swap_in = kv.swap_out, kv.swap_in
        self.out_s, self.in_s, self.out_parity, self.in_parity = [], [], [], []
        self.out_attempts = self.in_attempts = 0
        self.bytes_out = self.bytes_in = self.rings_checked = 0

        def clocked(fn, *args, **kwargs):
            torch.cuda.synchronize()
            p0 = PARITY["host_s"], PARITY["device_s"]
            r0 = eng.fabric_stats.bursts_retried
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            parity = (PARITY["host_s"] - p0[0], PARITY["device_s"] - p0[1])
            return out, wall, parity, 1 + eng.fabric_stats.bursts_retried - r0

        def timed_out(slot, stats=None):
            rec, wall, parity, attempts = clocked(swap_out, slot, stats=stats)
            self.out_s.append(wall)
            self.out_parity.append(parity)
            self.out_attempts += attempts if rec.mapped else 0
            self.bytes_out += sum(v.numel() * v.element_size() for v in
                                  list(rec.frames.values())
                                  + list(rec.unpaged.values()))
            return rec

        def timed_in(slot, rec, stats=None):
            _, wall, parity, attempts = clocked(swap_in, slot, rec,
                                                stats=stats)
            self.in_s.append(wall)
            self.in_parity.append(parity)
            self.in_attempts += attempts if rec.mapped else 0
            self.bytes_in += sum(v.numel() * v.element_size() for v in
                                 list(rec.frames.values())
                                 + list(rec.unpaged.values()))
            span = rec.mapped * kv.table.page_size
            for (kind, i, name), frames in rec.frames.items():
                rows = torch.from_numpy(kv._rep_idx(
                    kind, i, kv._phys_frames(slot, span))).long()
                lines = kv._pool_lines(kind, i, name)
                got = lines.index_select(0, rows.to(lines.device)).cpu()
                check(got.dtype == frames.dtype and torch.equal(
                    got.view(torch.int16), frames.view(torch.int16)),
                      f"swap-in of slot {slot}: {kind}{i}/{name} frames at "
                      f"their new rows differ from the swap record")
            for key, leaf, axis in kv._unpaged_leaves():
                got = leaf.narrow(axis, slot, 1).cpu()
                check(torch.equal(got.view(torch.int16),
                                  rec.unpaged[key].view(torch.int16)),
                      f"swap-in of slot {slot}: ring rows {key} differ from "
                      f"the swap record")
                self.rings_checked += 1

        kv.swap_out, kv.swap_in = timed_out, timed_in

    def line(self) -> str:
        def ms(xs):
            return (f"{statistics.median(xs) * 1e3:.3f} ms median "
                    f"({min(xs) * 1e3:.3f}-{max(xs) * 1e3:.3f})" if xs
                    else "none")

        def share(parity, walls):
            if not walls:
                return "none"
            host = sum(p[0] for p in parity) / sum(walls)
            dev = sum(p[1] for p in parity) / sum(walls)
            return f"{host:.1%} host parity, {dev:.1%} device parity"
        return (f"{len(self.out_s)} swap-outs ({self.bytes_out} bytes; "
                f"{ms(self.out_s)} each; {share(self.out_parity, self.out_s)}"
                f"), {len(self.in_s)} swap-ins ({self.bytes_in} bytes; "
                f"{ms(self.in_s)} each; {share(self.in_parity, self.in_s)})")


def time_parity() -> None:
    """Put a host clock around the swap path's parity word (the module
    function both transfer directions call), adding to :data:`PARITY` by
    the device the bytes lie on; the device fold ends in a read-back."""
    from repro_torch.fabric import paged_kv

    inner = paged_kv._parity_word

    def timed(t):
        t0 = time.perf_counter()
        out = inner(t)
        PARITY["host_s" if t.device.type == "cpu" else "device_s"] += (
            time.perf_counter() - t0)
        return out
    paged_kv._parity_word = timed


def serve_arrivals(torch, cfg, params, prompts, gen_len: int, every: int,
                   label: str, margins: bool = False, **engine_kw) -> dict:
    """Serve ``prompts`` through an engine of ``ENGINE_SLOTS`` slots with
    ``engine_kw``: request ``i`` has priority ``i % 3`` and arrives at
    engine step ``every * i``.  Launch counts are reset just before, the
    peak memory too; the pool is checked after every step and must be
    empty at the end, every request must decode ``gen_len`` tokens inside
    the vocab.  ``margins`` keeps the top-1/top-2 margin of every decoded
    token.  Returns the tokens, step times, engine, swap probe, launch
    counts, decode steps, the steps that preempted, the steps that started
    with queued work, and more."""
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.serving import Request, ServingEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, max_slots=ENGINE_SLOTS,
                        t_max=prompts.shape[1] + gen_len, check_pool=True,
                        **engine_kw)
    probe = EngineProbe(torch, eng)
    reqs = [Request(i, prompts[i], max_new_tokens=gen_len, priority=i % 3)
            for i in range(len(prompts))]
    margin = {}
    if margins:
        decode = eng._decode

        def recording(*args):
            logits, caches = decode(*args)
            top2 = logits[:, 0].float().topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).tolist()
            for s, r in enumerate(eng.active):
                if r is not None:
                    margin[(r.rid, len(r.generated))] = gap[s]
            return logits, caches
        eng._decode = recording
    pend = list(range(len(reqs)))
    preempting, queued_at, swaps = [], [], {}
    mt.reset_launch_counts()
    while pend or not eng.drained:
        while pend and pend[0] * every <= eng.step_count:
            eng.submit(reqs[pend.pop(0)])
        if eng.queue:
            queued_at.append(eng.step_count)
        st = eng.fabric_stats
        before = st.preemptions, st.swap_bursts
        eng.step()
        if st.preemptions > before[0]:
            preempting.append(eng.step_count - 1)
        if st.swap_bursts > before[1]:
            swaps[eng.step_count - 1] = st.swap_bursts - before[1]
        check(eng.step_count < 100 * gen_len, f"{label}: did not drain")
    counts = mt.launch_counts()
    check(all(len(r.generated) == gen_len for r in reqs),
          f"{label}: short streams")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"{label}: token outside the vocab")
    check(bool(torch.isfinite(eng.last_logits).all()),
          f"{label}: non-finite logits")
    check(eng.kv.pool.pages_in_use == 0 and not eng._swapped
          and eng._swap_pages_used == 0,
          f"{label}: pages or swap space left at the end")
    steps, steady = probe.steps, probe.steady
    out = dict(toks=[r.generated for r in reqs], steps=steps, eng=eng,
               probe=probe.swap, counts=counts, decodes=probe.decodes,
               preempting=preempting, queued_at=queued_at, margin=margin,
               swaps=swaps,
               steady=statistics.median(steady) if steady else float("nan"),
               peak=torch.cuda.max_memory_allocated())
    fs, pool = eng.fabric_stats, eng.kv.pool
    print(f"{label}: {len(reqs)} requests x {gen_len} tokens in "
          f"{eng.step_count} steps ({sum(steps):.3f}s); median step "
          f"{statistics.median(steps) * 1e3:.3f} ms, median steady decode "
          f"step (no admission, no swap) {out['steady'] * 1e3:.3f} ms over "
          f"{len(steady)}; peak memory {out['peak'] / 2 ** 30:.2f} GiB; "
          f"{fs.preemptions} preemptions, {pool.pages_swapped_out} pages "
          f"swapped out, {pool.pages_swapped_in} in, {fs.swap_bursts} swap "
          f"bursts ({fs.swap_out_words} words out, {fs.swap_in_words} in), "
          f"{fs.bursts_retried} retried, {fs.faults_recovered} faults "
          f"recovered; launches {counts}", flush=True)
    print(f"{label}: {probe.swap.line()}; {resume_line(probe.resumed)}",
          flush=True)
    return out


def burst_launches(runs) -> dict:
    """Kernels 1-2's launches that engines' counters imply, summed over
    ``runs`` of ``(engine, swap probe, decode calls)``: per decode one
    gather and one scatter per K/V pool stream, one scatter per stream per
    admission wave, and one gather (scatter) per stream per swap-out
    (swap-in) attempt."""
    gather, scatter = 0, 0
    for eng, probe, decodes in runs:
        e = 2 * len(eng.kv.paged_entries)
        gather += e * (decodes + probe.out_attempts)
        scatter += e * (decodes + eng.kv.prefill_bursts + probe.in_attempts)
    return {**ZERO_LAUNCHES, "gather_burst_network_tiles": gather,
            "scatter_burst_network_tiles": scatter}


def check_counts(counts: dict, runs, label: str) -> None:
    """Kernels 1-2's launches over ``runs`` are exactly what their
    engines' counters imply (:func:`burst_launches`)."""
    want = burst_launches(runs)
    check(counts == want, f"{label}: launches {counts} != {want}")


def check_launches(run: dict, label: str) -> None:
    """:func:`check_counts` of one :func:`serve_arrivals` run."""
    check_counts(run["counts"], [(run["eng"], run["probe"], run["decodes"])],
                 label)


def swap_stream(torch, words, cfg, pool_pages: int, reach: int, gen):
    """Kernels 1-2's operands at one swap stream of ``cfg``'s engine: the
    pool leaf of ``pool_pages`` pages as int32 line words, and the index
    stream of a swap-out of a slot holding ``reach`` tokens (its pages
    drawn from ``gen``), tiled over the layers and sentinel-padded to a
    multiple of N, as ``PagedKVCache._swap_gather`` builds it."""
    from repro_torch.fabric import FRAME_SENTINEL

    n, ps = cfg.resolved_fabric.n_ports, cfg.resolved_fabric.page_size
    reps = cfg.layer_types().count("A")
    span = -(-reach // ps) * ps
    frames = pool_pages * ps
    pages = torch.randperm(pool_pages, generator=gen)[: span // ps]
    t = torch.arange(span)
    pf = pages[t // ps] * ps + t % ps
    idx = (torch.arange(reps)[:, None] * frames + pf[None, :]).reshape(-1)
    pad = (-idx.numel()) % n
    idx = torch.cat([idx, torch.full((pad,), FRAME_SENTINEL)])
    lines = words((reps * frames, n, cfg.resolved_head_dim // 2))
    return lines, idx.to(torch.int32).to(lines.device), n


def preempt_phase(torch, dev, rows) -> None:
    """Oversubscribed serving at full width: (a) stablelm-1.6b, 8 requests
    (prompt 448, gen 64, priority i % 3, arriving every 6 steps) on 4 slots
    and a 20-page pool, under the swap arm, the recompute arm and an
    unconstrained run (the default 32-page pool, preemption off); (c) the
    swap arm again with a mid-step failure at its first preempting step,
    an exhausted pool at a step with queued work and a corrupted swap
    transfer; (d) the unconstrained run with speculative decode (k = 3);
    (b) gemma3-4b, 6 requests (prompt 1536, gen 32, every 4 steps) on a
    60-page pool under the swap arm and unconstrained.  Swap, faults and
    speculative decode must serve the unconstrained tokens; every swap-in
    restores the record's bits; kernels 1-2 at each swap stream's shape."""
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime import FaultInjector

    time_parity()
    gen = torch.Generator()
    gen.manual_seed(3)
    wgen = torch.Generator(device=dev)
    wgen.manual_seed(3)

    def words(shape):
        info = torch.iinfo(torch.int32)
        return torch.randint(info.min, info.max, shape, generator=wgen,
                             device=dev, dtype=torch.int64).to(torch.int32)

    # -- (a), (c), (d): stablelm-1.6b --------------------------------------
    cfg, params = load_model(torch, dev, "stablelm-1.6b")
    prompts = SyntheticLM(cfg, batch=PREEMPT_REQUESTS, seq=STABLELM_PROMPT,
                          seed=0).batch_at(0)["tokens"]
    slm = "preempt (a) stablelm-1.6b"
    free = serve_arrivals(torch, cfg, params, prompts, 64, PREEMPT_EVERY,
                          f"{slm} unconstrained", margins=True,
                          preempt="off")
    kv = free["eng"].kv
    check(kv.pool.n_pages == ENGINE_SLOTS * kv.table.pages_per_slot
          and not free["preempting"],
          "the unconstrained run preempted or is not on the default pool")
    del kv
    check_launches(free, f"{slm} unconstrained")
    swap = serve_arrivals(torch, cfg, params, prompts, 64, PREEMPT_EVERY,
                          f"{slm} swap", pool_pages=PREEMPT_POOL,
                          preempt="swap")
    st, pool = swap["eng"].fabric_stats, swap["eng"].kv.pool
    check(st.preemptions > 0 and st.swap_bursts > 0,
          f"{slm} swap: nothing was swapped")
    check(pool.pages_swapped_in == pool.pages_swapped_out > 0,
          f"{slm} swap: {pool.pages_swapped_out} pages out, "
          f"{pool.pages_swapped_in} in")
    check(swap["toks"] == free["toks"],
          f"{slm}: the swap arm served other tokens than the unconstrained "
          f"run")
    check_launches(swap, f"{slm} swap")
    e = 2 * len(swap["eng"].kv.paged_entries)
    swap_launch = {"gather_burst_network_tiles": e * swap["probe"].out_attempts,
                   "scatter_burst_network_tiles":
                       e * swap["probe"].in_attempts}
    rec = serve_arrivals(torch, cfg, params, prompts, 64, PREEMPT_EVERY,
                         f"{slm} recompute", pool_pages=PREEMPT_POOL,
                         preempt="recompute")
    check(rec["eng"].fabric_stats.preemptions > 0
          and rec["eng"].fabric_stats.swap_bursts == 0,
          f"{slm} recompute: no preemption, or a swap")
    check_launches(rec, f"{slm} recompute")
    matched, first = 0, None
    for rid, (a, b) in enumerate(zip(rec["toks"], free["toks"])):
        same = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    len(b))
        matched += same
        if same < len(b) and first is None:
            first = (rid, same, free["margin"].get((rid, same)))
    print(f"{slm} recompute: {matched} of {sum(map(len, free['toks']))} "
          f"tokens equal to the unconstrained run's" + (
              "" if first is None else
              f"; first divergence: request {first[0]} token {first[1]}, "
              f"unconstrained top-1/top-2 margin {first[2]}"), flush=True)

    # (c) faults on the swap arm: a mid-step failure at the first step that
    # preempts, an exhausted pool at the next step with queued work, and the
    # first swap transfer the rollback does not undo corrupted (the failed
    # attempt's transfers take the injector's first ordinals)
    fail = swap["preempting"][0]
    exhaust = next((s for s in swap["queued_at"] if s > fail),
                   next(s for s in swap["queued_at"] if s != fail))
    corrupt = swap["swaps"].get(fail, 0)
    inj = FaultInjector(fail_at=(fail,), exhaust_pool_at=(exhaust,),
                        corrupt_swap=(corrupt,))
    faulted = serve_arrivals(torch, cfg, params, prompts, 64, PREEMPT_EVERY,
                             f"preempt (c) stablelm-1.6b swap, faults at "
                             f"steps {fail} (mid-step) and {exhaust} "
                             f"(pool), swap transfer {corrupt} (corrupt)",
                             pool_pages=PREEMPT_POOL, preempt="swap",
                             fault_injector=inj)
    fst = faulted["eng"].fabric_stats
    check(faulted["toks"] == swap["toks"],
          "preempt (c): the faulted run served other tokens")
    check(fst.faults_recovered == 1 and fst.bursts_retried == 1
          and inj.fired == {fail} and inj.exhaust_fired == {exhaust}
          and inj.corrupted == 1,
          f"preempt (c): {fst.faults_recovered} faults recovered, "
          f"{fst.bursts_retried} bursts retried")
    print(f"preempt (c): tokens equal to the swap arm's; median steady step "
          f"with the injector's snapshot clone {faulted['steady'] * 1e3:.3f} "
          f"ms against {swap['steady'] * 1e3:.3f} ms without it", flush=True)
    # the snapshot alone, on the same engine's caches, and the copies a
    # swap transfer makes over PCIe, alone, at one slot's bytes
    eng = faulted["eng"]
    nbytes = sum(leaf.numel() * leaf.element_size()
                 for *_, leaf in eng._cache_leaves())
    snap = [wall_ms(torch, eng._snapshot) for _ in range(10)]
    per_slot = swap["probe"].bytes_out // max(1, len(swap["probe"].out_s))
    block = torch.empty(per_slot // 2, dtype=torch.int16, device=dev)
    host = block.cpu()
    d2h = [wall_ms(torch, block.cpu) for _ in range(5)]
    h2d = [wall_ms(torch, lambda: host.to(dev)) for _ in range(5)]
    print(f"preempt (c): the snapshot (host state and a clone of "
          f"{nbytes} bytes of cache leaves) {statistics.median(snap):.3f} ms "
          f"median of 10; a {per_slot}-byte device-to-host copy (pageable) "
          f"{statistics.median(d2h):.3f} ms and host-to-device "
          f"{statistics.median(h2d):.3f} ms, median of 5", flush=True)
    del eng, block, host

    # (d) speculative decode on the unconstrained trace
    spec = serve_arrivals(torch, cfg, params, prompts, 64, PREEMPT_EVERY,
                          f"preempt (d) stablelm-1.6b spec_decode_k="
                          f"{SPEC_K}", preempt="off", spec_decode_k=SPEC_K)
    check(spec["toks"] == free["toks"],
          "preempt (d): speculative decode served other tokens")
    check_launches(spec, "preempt (d)")
    se = spec["eng"]
    check(se.spec_proposed > 0, "preempt (d): no draft proposed")
    print(f"preempt (d): tokens equal to the unconstrained run's; "
          f"{se.spec_proposed} proposed, {se.spec_accepted} accepted, "
          f"{se.spec_rejected} rejected (acceptance "
          f"{se.spec_acceptance:.2%}, random draft heads)", flush=True)
    del params, free, swap, rec, faulted, spec, se
    free_model(torch, "preempt stablelm-1.6b")
    lines, idx, n = swap_stream(torch, words, cfg, PREEMPT_POOL,
                                STABLELM_PROMPT + 64, gen)
    rows["swap: stablelm-1.6b"] = sparse_rows(torch, words, lines, idx, n,
                                              "swap: stablelm-1.6b")
    del lines, idx
    for name, r in rows["swap: stablelm-1.6b"].items():
        r["launches"] = swap_launch[name]

    # -- (b): gemma3-4b, the ring leaves -----------------------------------
    cfg, params = load_model(torch, dev, "gemma3-4b")
    prompts = SyntheticLM(cfg, batch=GEMMA_SWAP_REQUESTS, seq=GEMMA_PROMPT,
                          seed=0).batch_at(0)["tokens"]
    g3 = "preempt (b) gemma3-4b"
    free = serve_arrivals(torch, cfg, params, prompts, GEMMA_SWAP_GEN,
                          GEMMA_SWAP_EVERY, f"{g3} unconstrained",
                          preempt="off")
    check_launches(free, f"{g3} unconstrained")
    swap = serve_arrivals(torch, cfg, params, prompts, GEMMA_SWAP_GEN,
                          GEMMA_SWAP_EVERY, f"{g3} swap",
                          pool_pages=GEMMA_SWAP_POOL, preempt="swap")
    check(swap["eng"].fabric_stats.swap_bursts > 0
          and swap["probe"].rings_checked > 0,
          f"{g3}: no swap, or no ring rows restored")
    check(swap["toks"] == free["toks"],
          f"{g3}: the swap arm served other tokens than the unconstrained run")
    check_launches(swap, f"{g3} swap")
    e = 2 * len(swap["eng"].kv.paged_entries)
    swap_launch = {"gather_burst_network_tiles": e * swap["probe"].out_attempts,
                   "scatter_burst_network_tiles":
                       e * swap["probe"].in_attempts}
    print(f"{g3}: swap tokens equal to the unconstrained run's; "
          f"{swap['probe'].rings_checked} ring-row slices restored bit for "
          f"bit", flush=True)
    del params, free, swap
    free_model(torch, "preempt gemma3-4b")
    lines, idx, n = swap_stream(torch, words, cfg, GEMMA_SWAP_POOL,
                                GEMMA_PROMPT + GEMMA_SWAP_GEN, gen)
    rows["swap: gemma3-4b"] = sparse_rows(torch, words, lines, idx, n,
                                          "swap: gemma3-4b")
    del lines, idx
    for name, r in rows["swap: gemma3-4b"].items():
        r["launches"] = swap_launch[name]
    torch.cuda.synchronize()
    for path in ("swap: stablelm-1.6b", "swap: gemma3-4b"):
        for name, r in rows[path].items():
            set_bound(r)
            print_row(name, path, r)
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def burst_operands(seen: dict, backward: bool = False):
    """While open, record into ``seen`` (cloned) the operands of the first
    gather and the first scatter that reach kernels 1-2 through
    ``kernels.ops``, as the scheduler passes them (bf16 pairs folded into
    int32 words); with ``backward``, of the first made inside an autograd
    backward (the adjoint bursts)."""
    from repro_torch.kernels import launch as kl
    from repro_torch.kernels import ops

    gather, scatter = ops.burst_gather_read, ops.burst_scatter_write

    def wanted(name):
        return name not in seen and (not backward or kl._IN_BACKWARD[0])

    def gather_spy(lines, idx, n):
        if wanted("gather"):
            seen["gather"] = (lines.clone(), idx.clone(), n)
        return gather(lines, idx, n)

    def scatter_spy(banked, idx, into, n):
        if wanted("scatter"):
            seen["scatter"] = (banked.clone(), idx.clone(), into.clone(), n)
        return scatter(banked, idx, into, n)
    ops.burst_gather_read, ops.burst_scatter_write = gather_spy, scatter_spy
    try:
        yield seen
    finally:
        ops.burst_gather_read, ops.burst_scatter_write = gather, scatter


def moe_operands(torch, moe, ffn, cfg, x) -> dict:
    """The operands one ``moe.moe_apply(ffn, x, cfg)`` hands the gather
    (combine) and scatter (dispatch) kernels."""
    with burst_operands({}) as seen:
        moe.moe_apply(ffn, x, cfg)
    check(set(seen) == {"gather", "scatter"},
          f"moe_apply did not reach both kernels: {sorted(seen)}")
    return seen


def burst_step_rows(torch, words, operands, label: str, drops: bool,
                    rows_what: str = "assignment rows",
                    slots_what: str = "expert slots") -> dict:
    """Kernels 1-2 at one step's recorded operands (:func:`burst_operands`):
    the scatter (an MoE dispatch with its real payload, or a decode's KV
    write-back) and the gather (a combine of the real expert outputs, or a
    decode's KV read) held bit for bit against the plain versions, the
    gather's sentinel frames read as zeros; every index a row in ``[0, L)``
    or ``FRAME_SENTINEL``, unique, and the scatter's indices the gather's;
    then :func:`sparse_rows` at the same operands (held, launched again,
    timed).  ``drops``: there must be sentinel rows."""
    from repro_torch.fabric import FRAME_SENTINEL
    from repro_torch.kernels import medusa_transpose as mt

    lines, idx, n = operands["gather"]
    banked, sidx, into0, _ = operands["scatter"]
    rows_l = lines.shape[0]
    check(torch.equal(idx, sidx) and into0.shape == lines.shape,
          f"{label}: the scatter and the gather index other rows")
    live = idx[idx != FRAME_SENTINEL]
    check(bool((idx >= 0).all()) and bool((live < rows_l).all())
          and live.unique().numel() == live.numel(),
          f"{label}: an index outside the rows, or a row twice")
    sentinels = int((idx == FRAME_SENTINEL).sum())
    check(sentinels > 0 or not drops, f"{label}: no sentinel row")
    got = mt.scatter_burst_network_tiles(banked, sidx, into0.clone(), n)
    bit_equal(torch, got, mt.scatter_burst_plain(banked, sidx, into0.clone(),
                                                 n), f"scatter ({label})")
    got = mt.gather_burst_network_tiles(lines, idx, n)
    bit_equal(torch, got, mt.gather_burst_plain(lines, idx, n),
              f"gather ({label})")
    frames = got.transpose(1, 2).reshape(idx.numel(), n, -1)
    check(not bool(frames[idx == FRAME_SENTINEL].any()),
          f"{label}: a sentinel frame is not zeros")
    print(f"{label}: {idx.numel()} {rows_what} ({sentinels} sentinels) "
          f"over {rows_l} {slots_what} of [N={n}, {lines.shape[2]}] int32 "
          f"words; scatter and gather bit-equal to their plain versions",
          flush=True)
    return sparse_rows(torch, words, lines, idx, n, label)


def moe_phase(torch, dev, rows) -> None:
    """granite-moe-3b-a800m at full width and depth (32 layers, d_model
    1536, 40 experts top-8, 8 KV heads = N ports, ~6.6 GB of random bf16
    weights from a seed): 4 requests of 448 tokens, 32 generated, through
    the engine on the medusa fabric with the fused gather.  Each MoE layer
    dispatches over the scatter kernel and combines over the gather kernel
    in every decode step and every prefill, beside the KV bursts; the
    launches must be exactly that.  The same tokens with the kernels off,
    with ``payload="route"`` (no MoE burst) and on the crossbar fabric.
    The one-shot ``greedy_generate`` of request 0 must serve the tokens of
    a one-slot engine: capacity counts every row a step feeds, so only a
    batch of the same rows (one prompt, one slot) routes the same (the
    4-slot engine prefills each prompt alone, a batched one-shot all four
    at once).  Then kernels 1-2 at one decode step's and one prefill's
    dispatch and combine operands."""
    import functools

    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.kernels import ops
    from repro_torch.models import api, moe

    cfg, params = load_model(torch, dev, MOE_ARCH)
    n_moe = cfg.n_layers
    b, s, g = ENGINE_SLOTS, MOE_PROMPT, MOE_GEN
    steps = g - 1
    prompts = SyntheticLM(cfg, batch=b, seq=s, seed=0).batch_at(0)["tokens"]

    def launches(slots, moe_on=True):
        """Kernels 1-2 of an engine run: the K/V streams' gather and
        scatter per decode step and scatter per admission wave, and one
        dispatch scatter and combine gather per MoE layer per decode step
        and per prefill."""
        per = n_moe * (steps + slots) if moe_on else 0
        return {"gather_burst_network_tiles": 2 * steps + per,
                "scatter_burst_network_tiles": 2 * steps + 2 + per}

    label = f"{MOE_ARCH} engine (fused gather)"
    toks, med, counts, stats = engine_run(torch, cfg, params, prompts, g,
                                          label, launches(b))
    check(stats.tokens_dropped > 0, f"{label}: no assignment dropped at the "
          f"decode's capacity of 1")
    print(f"{label}: {stats.tokens_dropped} token assignments dropped at "
          f"capacity over the decode steps; median step {med * 1e3:.3f} ms; "
          f"{card_line()}", flush=True)
    for path, per in ((MOE_DECODE, n_moe * steps), (MOE_PREFILL, n_moe * b)):
        rows[path] = {name: {"launches": per} for name in (
            "gather_burst_network_tiles", "scatter_burst_network_tiles")}

    others = []
    ops.use_kernels(False)
    try:
        others.append(("kernels off", engine_run(
            torch, cfg, params, prompts, g, f"{MOE_ARCH} engine (kernels off)",
            {})))
    finally:
        ops.use_kernels(True)
    apply = moe.moe_apply
    moe.moe_apply = functools.partial(apply, payload="route")
    try:
        others.append(("payload route", engine_run(
            torch, cfg, params, prompts, g,
            f"{MOE_ARCH} engine (payload route)", launches(b, False))))
    finally:
        moe.moe_apply = apply
    others.append(("crossbar fabric", engine_run(
        torch, dataclasses.replace(cfg, kv_layout="crossbar"), params,
        prompts, g, f"{MOE_ARCH} engine (crossbar fabric)", {})))
    for what, (other, _, _, ostats) in others:
        check(other == toks, f"{MOE_ARCH}: the {what} engine served other "
              f"tokens than the fused-gather engine")
        check(ostats.tokens_dropped == stats.tokens_dropped,
              f"{MOE_ARCH}: the {what} engine dropped "
              f"{ostats.tokens_dropped}, not {stats.tokens_dropped}")

    # the one-shot against a one-slot engine, request 0
    one, _, _, _ = engine_run(torch, cfg, params, prompts[:1], g,
                              f"{MOE_ARCH} engine (one slot)", launches(1))
    mt.reset_launch_counts()
    prompt = torch.as_tensor(prompts[:1], device=dev)
    shot, logits, times = generate(torch, api, params, prompt, cfg, steps,
                                   s + g)
    counts = mt.launch_counts()
    want = {**ZERO_LAUNCHES, "medusa_transpose_tiles": n_moe * steps,
            "gather_burst_network_tiles": n_moe * (steps + 1),
            "scatter_burst_network_tiles": n_moe * (steps + 1)}
    check(counts == want, f"{MOE_ARCH} one-shot: launches {counts} != {want}")
    check(all(bool(torch.isfinite(lg).all()) for lg in logits),
          f"{MOE_ARCH} one-shot: non-finite logits")
    check(shot.tolist()[0] == one[0][1:], f"{MOE_ARCH}: the one-shot served "
          f"other tokens than the one-slot engine")
    print(f"{MOE_ARCH}: tokens equal across the fused-gather engine, kernels "
          f"off, payload route and the crossbar fabric ({b} x {g}); the "
          f"one-shot equal to the one-slot engine ({steps} decoded, median "
          f"step {statistics.median(times) * 1e3:.3f} ms)", flush=True)
    del logits

    # kernels 1-2 at one decode step's and one prefill's MoE operands
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def words(shape):
        info = torch.iinfo(torch.int32)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)
    ffn = params.unit[0][0].ffn
    for path, shape, drops in ((MOE_DECODE, (b, 1, cfg.d_model), True),
                               (MOE_PREFILL, (1, s, cfg.d_model), False)):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        got = burst_step_rows(torch, words,
                              moe_operands(torch, moe, ffn, cfg, x), path,
                              drops)
        for name, r in got.items():
            rows[path][name].update(r)
            set_bound(rows[path][name])
            print_row(name, path, rows[path][name])
    del params, ffn
    free_model(torch, MOE_ARCH)


def one_shot(torch, cfg, params, prompt, steps: int, t_max: int, label: str,
             want: dict, extra=None):
    """``api.greedy_generate`` of ``prompt`` (``steps`` decode steps, the
    batch entries ``extra``): launch counts reset just before and read just
    after (they must be ``want``), the peak memory reset before; checks the
    tokens lie in the vocab and every step's logits are finite.  Prints the
    median decode step, tok/s and the peak memory.  Returns the tokens,
    every step's logits and the launch counts."""
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.models import api

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    toks, logits, times = generate(torch, api, params, prompt, cfg, steps,
                                   t_max, extra=extra)
    wall = time.perf_counter() - t0
    counts = mt.launch_counts()
    check(counts == {**ZERO_LAUNCHES, **want},
          f"{label}: launches {counts} != {want}")
    check(tuple(toks.shape) == (prompt.shape[0], steps),
          f"{label}: tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{label}: token outside the vocab")
    check(all(bool(torch.isfinite(lg).all()) for lg in logits),
          f"{label}: non-finite logits")
    per_step = {k: v / steps for k, v in counts.items() if v}
    print(f"{label}: batch {prompt.shape[0]} x {steps} decode steps in "
          f"{wall:.3f}s ({prompt.shape[0] * steps / wall:.1f} tok/s incl. "
          f"prefill); median decode step "
          f"{statistics.median(times) * 1e3:.3f} ms; launches per decode step "
          f"{per_step or 'none'}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    return toks, logits, counts


def agreement(engine_toks, shot) -> str:
    """How many of the one-shot's decoded tokens the engine served at the
    same place (the engine's first token is the prefill's)."""
    shot = shot.tolist()
    same = sum(a == b for row, e in zip(shot, engine_toks)
               for a, b in zip(row, e[1:]))
    total = sum(min(len(row), len(e) - 1) for row, e in zip(shot,
                                                           engine_toks))
    return f"{same} of {total}"


def families_phase(torch, dev, rows) -> None:
    """The last decoder-only families at full width, random bf16 weights
    from seed 0, only the depth of the runs cut.  (a) internvl2-1b (24
    layers, 2 KV heads = N ports of 64 lanes): the one-shot of 2 rows of
    256 patch embeddings from the data stub and 192 text tokens, 32 decode
    steps, kernel 4 exactly 24 launches a step on its [2, 480, 2, 64]
    leaves, the tokens and every step's logits bit-identical with the
    kernels off and on the crossbar fabric; the engine, 4 requests of 448
    text tokens + 64 on pages of 64 with the fused gather, kernels 1-2 at 2
    launches a step and 2 a wave, the tokens equal with the kernels off and
    on the crossbar.  (b) recurrentgemma-2b (26 layers ``RRL``, window
    2048): the one-shot of 2 rows of 3072 tokens (past the window: the
    prefill takes the ring roll and decode wraps), 32 steps, no kernel-4
    launch (its [2, 2048, 1, 256] ring leaves have one KV head, so their
    port-major form is a view), the same tokens and logits with the
    kernels off; the engine, 4 requests of 3072 + 32
    on 4 slots, no pool and no kernel (its ring layers attend per row).
    (c) mamba2-780m (48 ``M`` layers): the one-shot of 2 rows of 1000
    tokens (off the 256 chunk), 32 steps, and the engine, 4 requests of
    1000 + 32: no kernel runs.  Each engine's agreement with its one-shot
    is printed.  (d) :func:`families_card_vs_cpu`.  (e) Kernels 1, 2 and
    4 at the new shapes, held bit for bit and timed (paths
    ``internvl2-1b engine``, ``internvl2-1b one-shot``)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    b, g = FAMILY_BATCH, FAMILY_STEPS

    # -- (a) internvl2-1b --------------------------------------------------
    cfg, params = load_model(torch, dev, VLM_ARCH)
    p = cfg.n_patches
    batch = SyntheticLM(cfg, batch=b, seq=VLM_TEXT + p, seed=0).batch_at(0)
    check(batch["tokens"].shape == (b, VLM_TEXT)
          and batch["patch_embeds"].shape == (b, p, cfg.d_model),
          f"{VLM_ARCH}: the data stub gave {batch['tokens'].shape} tokens "
          f"and {batch['patch_embeds'].shape} patches")
    prompt = torch.as_tensor(batch["tokens"], device=dev)
    extra = {"patch_embeds": torch.as_tensor(batch["patch_embeds"],
                                             device=dev)}
    t_vlm = p + VLM_TEXT + g
    per_step = cfg.n_layers
    label = f"{VLM_ARCH} one-shot ({p} patches + {VLM_TEXT} tokens)"
    toks, logits, counts = one_shot(
        torch, cfg, params, prompt, g, t_vlm, label,
        {"medusa_transpose_tiles": per_step * g}, extra)
    rows[VLM_ONE_SHOT] = {"medusa_transpose_tiles": {
        "launches": counts["medusa_transpose_tiles"]}}
    ops.use_kernels(False)
    try:
        toks_off, logits_off, _ = one_shot(
            torch, cfg, params, prompt, g, t_vlm, f"{label}, kernels off", {},
            extra)
    finally:
        ops.use_kernels(True)
    toks_x, logits_x, _ = one_shot(
        torch, dataclasses.replace(cfg, kv_layout="crossbar"), params, prompt,
        g, t_vlm, f"{label}, crossbar fabric", {}, extra)
    for what, (t_o, l_o) in (("kernels off", (toks_off, logits_off)),
                             ("crossbar fabric", (toks_x, logits_x))):
        check(torch.equal(toks, t_o), f"{VLM_ARCH} one-shot: the {what} run "
              f"served other tokens")
        same_steps(torch, logits, l_o, f"{VLM_ARCH} one-shot, {what}")
    print(f"{VLM_ARCH} one-shot: tokens and all {g} steps' logits "
          f"bit-identical with the kernels on, off and on the crossbar "
          f"fabric; {per_step} layout-engine launches a step", flush=True)
    del logits, logits_off, logits_x, extra

    prompts = SyntheticLM(cfg, batch=ENGINE_SLOTS, seq=VLM_ENGINE_PROMPT + p,
                          seed=0).batch_at(0)["tokens"]
    ge = VLM_ENGINE_GEN
    want = {"gather_burst_network_tiles": 2 * (ge - 1),
            "scatter_burst_network_tiles": 2 * (ge - 1) + 2}
    toks_e, _, counts, _ = engine_run(
        torch, cfg, params, prompts, ge, f"{VLM_ARCH} engine (fused gather)",
        want)
    rows[f"{VLM_ARCH} engine"] = {name: {"launches": counts[name]}
                                  for name in want}
    ops.use_kernels(False)
    try:
        off, _, _, _ = engine_run(torch, cfg, params, prompts, ge,
                                  f"{VLM_ARCH} engine (kernels off)", {})
    finally:
        ops.use_kernels(True)
    cross, _, _, _ = engine_run(
        torch, dataclasses.replace(cfg, kv_layout="crossbar"), params,
        prompts, ge, f"{VLM_ARCH} engine (crossbar fabric)", {})
    check(off == toks_e and cross == toks_e, f"{VLM_ARCH}: the engine served "
          f"other tokens with the kernels off or on the crossbar fabric")
    print(f"{VLM_ARCH} engine: tokens equal with the kernels on, off and on "
          f"the crossbar fabric ({ENGINE_SLOTS} x {ge})", flush=True)
    del params
    free_model(torch, VLM_ARCH)

    # -- (b) recurrentgemma-2b and (c) mamba2-780m ------------------------
    for arch, s in ((RG_ARCH, RG_PROMPT), (SSM_ARCH, SSM_PROMPT)):
        cfg, params = load_model(torch, dev, arch)
        prompts = SyntheticLM(cfg, batch=ENGINE_SLOTS, seq=s,
                              seed=0).batch_at(0)["tokens"]
        prompt = torch.as_tensor(prompts[:b], device=dev)
        # recurrentgemma-2b's ring layers have one KV head: their port-major
        # K/V are views of the ring, so kernel 4 launches nowhere here
        rings = cfg.layer_types().count("L")
        check(not rings or cfg.n_kv_heads == 1,
              f"{arch}: {cfg.n_kv_heads} KV heads, not the one-head ring")
        label = f"{arch} one-shot (prompt {s})"
        toks, logits, counts = one_shot(torch, cfg, params, prompt, g, s + g,
                                        label, {})
        if rings:
            ops.use_kernels(False)
            try:
                toks_off, logits_off, _ = one_shot(
                    torch, cfg, params, prompt, g, s + g,
                    f"{label}, kernels off", {})
            finally:
                ops.use_kernels(True)
            check(torch.equal(toks, toks_off), f"{arch} one-shot: other "
                  f"tokens with the kernels off")
            same_steps(torch, logits, logits_off,
                       f"{arch} one-shot, kernels off")
            print(f"{arch} one-shot: tokens and all {g} steps' logits "
                  f"bit-identical with the kernels on and off; no "
                  f"layout-engine launch ({rings} ring layers of one KV "
                  f"head: their port-major K/V are views)", flush=True)
            del logits_off
        else:
            print(f"{arch} one-shot: no kernel runs on this path (no "
                  f"attention leaf); launches {counts}", flush=True)
        del logits
        toks_e, _, counts, stats = engine_run(
            torch, cfg, params, prompts, FAMILY_GEN,
            f"{arch} engine (no page pool)", {})
        check(stats.flushes == 0, f"{arch} engine: {stats.flushes} bursts "
              f"ran without a full-attention leaf")
        print(f"{arch} engine: no kernel runs (no pool, the per-layer "
              f"decode); launches {counts}; tokens agree with the one-shot "
              f"on {agreement(toks_e[:b], toks)} decoded positions",
              flush=True)
        del params
        free_model(torch, arch)

    # -- (e) kernels 1, 2 and 4 at the new shapes -------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)

    def words(shape, dtype=torch.int32):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(dtype)
    vlm = burst_rows(torch, gen, words, VLM_ARCH, VLM_ENGINE_PROMPT,
                     VLM_ENGINE_GEN)
    del vlm["burst_network_tiles"]              # not on this path
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    new = {f"{VLM_ARCH} engine": vlm,
           VLM_ONE_SHOT: {"medusa_transpose_tiles": pair_row(
               torch, words, (b, t_vlm, 2, 64), flush,
               f"{VLM_ARCH} layer's K and V")}}
    del flush
    for path, by_kernel in new.items():
        for name, r in by_kernel.items():
            rows[path][name].update(r)
            set_bound(rows[path][name])
            print_row(name, path, rows[path][name])

    families_card_vs_cpu(torch, dev)
    print(f"families phase: {time.perf_counter() - t_phase:.1f}s wall; "
          f"{card_line()}", flush=True)


def families_card_vs_cpu(torch, dev) -> None:
    """The three families' smoke configs in float32, the same parameters on
    the card and on the CPU: the one-shot (internvl2 with its patch
    prefix) — tokens exact, every step's logits and every cache leaf of
    the prefill within 1e-4; the engine (3 requests on 3 slots) — tokens
    and every ``SchedulerStats`` field exact, the last step's logits and
    every cache leaf (conv, h, state, ring, pool) within 1e-4."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import SyntheticLM
    from repro_torch.models import api
    from repro_torch.serving import Request, ServingEngine

    for arch in (VLM_ARCH, RG_ARCH, SSM_ARCH):
        small = dataclasses.replace(get_smoke(arch), dtype="float32")
        p = small.n_patches
        data = SyntheticLM(small, batch=3, seq=12 + p, seed=1).batch_at(0)
        out = {}
        for name, device in (("cpu", "cpu"), ("gpu", dev)):
            params = api.init_params(small, seed=1, device="cpu").to(device)
            prompt = torch.as_tensor(data["tokens"], device=device)
            extra = ({"patch_embeds": torch.as_tensor(data["patch_embeds"],
                                                      device=device)}
                     if p else {})
            _, caches = api.prefill_fn(params, {"tokens": prompt, **extra},
                                       small, 24 + p)
            seen = []
            toks = api.greedy_generate(
                params, prompt, small, steps=6, t_max=24 + p, extra=extra,
                on_step=lambda i, lg: seen.append(lg.cpu()))
            eng = ServingEngine(small, params, max_slots=3, t_max=20)
            reqs = [Request(i, data["tokens"][i], max_new_tokens=6)
                    for i in range(3)]
            for r in reqs:
                eng.submit(r)
            eng.run_to_completion(max_steps=64)
            out[name] = dict(
                toks=toks.tolist(), logits=seen,
                prefill=[leaf.cpu() for kind in ("unit", "tail")
                         for entry in caches[kind] for leaf in entry.values()],
                served=[r.generated for r in reqs],
                stats=dataclasses.asdict(eng.fabric_stats),
                last=eng.last_logits.cpu(),
                leaves=[leaf.cpu() for *_, leaf in eng._cache_leaves()])
        a, c = out["gpu"], out["cpu"]
        check(a["toks"] == c["toks"], f"{arch} smoke one-shot: card and CPU "
              f"tokens differ")
        check(a["served"] == c["served"], f"{arch} smoke engine: card and "
              f"CPU tokens differ")
        check(a["stats"] == c["stats"], f"{arch} smoke engine: card and CPU "
              f"SchedulerStats differ: {a['stats']} vs {c['stats']}")
        errs = {}
        for what in ("logits", "prefill", "leaves"):
            check(len(a[what]) == len(c[what]) > 0, f"{arch}: no {what}")
            errs[what] = max(float((x - y).abs().max())
                             for x, y in zip(a[what], c[what]))
        errs["last"] = float((a["last"] - c["last"]).abs().max())
        check(max(errs.values()) <= 1e-4, f"{arch} smoke: card vs CPU "
              f"differ beyond 1e-4: {errs}")
        print(f"smoke {arch} float32 card vs CPU: one-shot and engine tokens "
              f"and all SchedulerStats fields equal; max abs diff "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + " (tolerance 1e-4)", flush=True)


def track_resumes(eng) -> list:
    """Wrap ``eng``'s preemption and installation: for each parked request
    that is admitted again, the returned list gains ``(steps, seconds,
    swapped)`` — the steps and host seconds from the end of its preemption
    to the end of its re-admission, and whether it came back by swap-in
    (else by recompute)."""
    parked, resumed = {}, []
    preempt, install = eng._preempt_slot, eng._install

    def parking(slot):
        rid = eng.active[slot].rid
        preempt(slot)
        parked[rid] = (eng.step_count, time.perf_counter())

    def installing(cand, slot, wave):
        install(cand, slot, wave)
        # a parked request (a replayed step installs it again)
        when = (parked.pop(cand.req.rid, None) if hasattr(cand, "record")
                else None)
        if when is not None:
            resumed.append((eng.step_count - when[0],
                            time.perf_counter() - when[1],
                            cand.record is not None))
    eng._preempt_slot, eng._install = parking, installing
    return resumed


def resume_line(resumed: list) -> str:
    """The time to resume of :func:`track_resumes`' requests."""
    if not resumed:
        return "no request parked"
    steps = [r[0] for r in resumed]
    ms = [r[1] * 1e3 for r in resumed]
    swapped = sum(r[2] for r in resumed)
    return (f"{len(resumed)} parked requests resumed ({swapped} by "
            f"swap-in); time to resume median "
            f"{statistics.median(steps)} steps ({min(steps)}-{max(steps)}), "
            f"{statistics.median(ms):.3f} ms ({min(ms):.3f}-{max(ms):.3f})")


class EngineProbe:
    """Instruments one engine: its decode calls and the live slots at each
    (at decode number ``arm``, the operands of kernels 1-2 go into
    ``operands``, :func:`burst_operands`); each step's wall time, ending in
    a synchronize, and whether it was steady (it decoded, with no
    admission, no preemption and no swap); its swap transfers
    (:class:`SwapProbe`); and each parked request's time to resume — the
    steps and wall time from the end of its preemption to the end of its
    re-admission."""

    def __init__(self, torch, eng, arm=None, operands=None):
        self.eng = eng
        self.swap = SwapProbe(torch, eng)
        self.decodes, self.live, self.steps, self.steady = 0, [], [], []
        self.resumed = track_resumes(eng)
        decode, step = eng._decode, eng.step

        def counted(*args):
            self.decodes += 1
            self.live.append(sum(r is not None for r in eng.active))
            if self.decodes != arm:
                return decode(*args)
            with burst_operands(operands):
                return decode(*args)

        def timed():
            def marks():
                st = eng.fabric_stats
                return (st.preemptions, st.swap_bursts,
                        eng.kv.prefill_bursts)
            before, decodes = marks(), self.decodes
            t0 = time.perf_counter()
            n = step()
            torch.cuda.synchronize()
            self.steps.append(time.perf_counter() - t0)
            if self.decodes > decodes and marks() == before:
                self.steady.append(self.steps[-1])
            return n

        eng._decode, eng.step = counted, timed

    def run(self):
        """``(engine, swap probe, decode calls)`` for :func:`burst_launches`."""
        return self.eng, self.swap, self.decodes


def loadgen_phase(torch, dev, rows) -> None:
    """The traffic harness at full width: stablelm-1.6b (24 layers, 32 KV
    heads = N ports, random bf16 weights from seed 0) serving the seeded
    trace :data:`LOADGEN_TRACE` (diurnal arrivals with bursts, heavy-tailed
    lengths, three priority classes, a quarter with SLO deadlines) on the
    oversubscribed engine :data:`LOADGEN_ENGINE`.  (1) ``loadgen.main``, the
    CLI a user calls, replays it from ``--trace-in`` and writes
    ``--trace-out`` and its run record under ``chiprun_out/``: kernels 1-2
    launch exactly what the engine's counters imply, and the phase prints
    the steady step, tok/s, the per-class TTFT, queue wait and TPOT, the
    goodput, the shed and SLO census, preemptions, swap bursts and each
    parked request's time to resume.  (2) ``fault_soak`` of the trace loaded
    back from ``--trace-out`` under ``FaultInjector.seeded(0, ...)`` at the
    reference soak test's rates: token-exact against its fault-free run,
    zero page leaks, and the fault-free run's report and tokens equal to
    (1)'s.  (3) A fleet of two replicas (2 slots, a 10-page pool each)
    behind ``ReplicaRouter``: every request served or shed, none starved,
    the fleet census the sum of the replicas', launches exact.  Then
    kernels 1-2 at one decode step's operands (the step of the fault-free
    soak run with the most live slots), held bit for bit and timed; their
    launches are the three runs'."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.launch import loadgen
    from repro_torch.runtime import FaultInjector
    from repro_torch.serving import ServingEngine, traffic

    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace_in, trace_out, bench = (out_dir / f"loadgen_{name}.json" for name
                                  in ("trace_in", "trace", "serving"))
    bench.unlink(missing_ok=True)
    cfg = get_config(LOADGEN_ARCH)
    trace = traffic.generate_trace(traffic.TrafficConfig(
        **LOADGEN_TRACE, vocab=cfg.vocab_size))
    traffic.save_trace(str(trace_in), trace)
    t, e = LOADGEN_TRACE, LOADGEN_ENGINE
    argv = ["--arch", LOADGEN_ARCH, "--trace-in", str(trace_in),
            "--trace-out", str(trace_out), "--bench-out", str(bench),
            "--seed", str(t["seed"]), "--requests", str(t["n_requests"]),
            "--arrival", t["arrival"], "--rate", str(t["rate"]),
            "--prompt-mean", str(t["prompt_mean"]),
            "--prompt-max", str(t["prompt_max"]),
            "--gen-mean", str(t["gen_mean"]), "--gen-max", str(t["gen_max"]),
            "--classes", str(t["classes"]),
            "--deadline-frac", str(t["deadline_frac"]),
            "--deadline-slack", str(t["deadline_slack"]),
            "--max-slots", str(e["max_slots"]),
            "--page-size", str(e["page_size"]),
            "--pool-pages", str(e["pool_pages"]), "--preempt", e["preempt"],
            "--aging", str(e["aging"]), "--max-queue", str(e["max_queue"])]
    label = f"{LOADGEN} (1) CLI"
    print(f"{label}: python -m repro_torch.launch.loadgen "
          f"{' '.join(argv)}", flush=True)

    # -- (1) the CLI ---------------------------------------------------------
    probes = []

    def instrumented(*args, **kwargs):
        eng = ServingEngine(*args, **kwargs)
        probes.append(EngineProbe(torch, eng))
        return eng
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    loadgen.ServingEngine = instrumented
    try:
        loadgen.main(argv)
    finally:
        loadgen.ServingEngine = ServingEngine
    counts = [mt.launch_counts()]
    peak = torch.cuda.max_memory_allocated()
    check(len(probes) == 1, f"{label}: {len(probes)} engines built")
    p1 = probes[0]
    eng1 = p1.eng
    check_counts(counts[0], [p1.run()], label)
    check(trace_out.read_bytes() == trace_in.read_bytes(),
          f"{label}: --trace-out is not the trace it replayed")
    record = json.loads(bench.read_text())["runs"][-1]
    check("jax" not in record and record["torch"] == torch.__version__
          and record["card"]["name"] == torch.cuda.get_device_name(0),
          f"{label}: the run record does not name torch and the card")
    cells = {k: v for k, v in record["cells"].items() if k != "census"}
    census, wall = record["cells"]["census"], record["workload"]["wall_s"]
    check(eng1.drained and eng1.kv.pool.pages_in_use == 0
          and eng1._swap_pages_used == 0, f"{label}: not drained clean")
    toks1 = {rid: r.generated for rid, r in eng1.recorder.requests.items()}
    check(all(0 <= x < cfg.vocab_size for g in toks1.values() for x in g)
          and bool(torch.isfinite(eng1.last_logits).all()),
          f"{label}: a token outside the vocab, or non-finite logits")
    agg = cells["aggregate"]
    check(agg["served"] + agg["shed"] == agg["n"] == len(trace),
          f"{label}: {agg} does not account for every request")
    card = card_line()
    print(f"{label}: {eng1.step_count} engine steps, {p1.decodes} decode "
          f"steps, wall {wall:.3f} s; median steady step "
          f"{statistics.median(p1.steady) * 1e3:.3f} ms over "
          f"{len(p1.steady)} (median step "
          f"{statistics.median(p1.steps) * 1e3:.3f} ms); {agg['tokens']} "
          f"tokens, {agg['tokens'] / wall:.1f} tok/s; "
          f"peak memory {peak / 2 ** 30:.2f} GiB; launches {counts[0]}; "
          f"{card}", flush=True)
    for name, c in cells.items():
        print(f"{label} {name}: n {c['n']}, served {c['served']}, shed "
              f"{c['shed']}, goodput {c['goodput']}; TTFT p50/p90/p99 "
              f"{c['ttft_p50']}/{c['ttft_p90']}/{c['ttft_p99']} steps, queue "
              f"wait {c['wait_p50']}/{c['wait_p90']}/{c['wait_p99']}, TPOT "
              f"{c['tpot_p50']}/{c['tpot_p90']}/{c['tpot_p99']}; SLO missed "
              f"{c['slo_missed_served']} served late, {c['slo_missed_shed']} "
              f"shed; {card}", flush=True)
    print(f"{label} census: {census}", flush=True)
    print(f"{label}: {resume_line(p1.resumed)}; {p1.swap.line()}; {card}",
          flush=True)

    # -- (2) the fault soak of the trace loaded back -------------------------
    loaded = traffic.load_trace(str(trace_out))
    check([x.to_json() for x in loaded] == [x.to_json() for x in trace],
          f"{LOADGEN}: the trace loaded back differs")
    params, t_max = eng1.params, record["workload"]["t_max"]
    arm = p1.live.index(max(p1.live)) + 1
    operands, soak_probes = {}, []

    def make_engine(fault_injector=None):
        eng = ServingEngine(cfg, params, t_max=t_max, check_pool=True,
                            fault_injector=fault_injector, **LOADGEN_ENGINE)
        soak_probes.append(EngineProbe(
            torch, eng, arm=None if fault_injector else arm,
            operands=operands))
        return eng
    inj = FaultInjector.seeded(0, 4096, **LOADGEN_SOAK)
    label = f"{LOADGEN} (2) fault soak"
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        ref_rec, soak_rec, soak_eng = traffic.fault_soak(make_engine, loaded,
                                                         inj)
    except AssertionError as err:
        fail(f"{label}: {err}")
    counts.append(mt.launch_counts())
    soak_wall = time.perf_counter() - t0
    check(json.loads(json.dumps(ref_rec.report())) == cells,
          f"{label}: the fault-free run's report differs from the CLI's "
          f"record")
    check({rid: r.generated for rid, r in ref_rec.requests.items()} == toks1,
          f"{label}: the fault-free run served other tokens than the CLI")
    fs = soak_eng.fabric_stats
    check(fs.faults_recovered + fs.bursts_retried + len(inj.exhaust_fired)
          > 0 and soak_rec.starved() == [],
          f"{label}: no fault hit, or a request starved")
    print(f"{label}: token-exact against the fault-free run, zero page leaks "
          f"at drain; the fault-free report equal to the CLI's record; "
          f"{len(inj.fired)} mid-step failures, {len(inj.exhaust_fired)} "
          f"exhausted pools, {inj.corrupted} corrupted swaps "
          f"({fs.faults_recovered} faults recovered, {fs.bursts_retried} "
          f"bursts retried); soak served "
          f"{soak_rec.report()['aggregate']['served']}, shed "
          f"{soak_rec.report()['aggregate']['shed']}; both runs "
          f"{soak_wall:.3f} s, steady step with the snapshot clone "
          f"{statistics.median(soak_probes[1].steady) * 1e3:.3f} ms; "
          f"launches {counts[1]}; {card}", flush=True)

    # -- (3) two replicas behind the router ----------------------------------
    label = f"{LOADGEN} (3) router"
    fleet = []

    def replica():
        eng = ServingEngine(cfg, params, t_max=t_max, check_pool=True,
                            **dict(LOADGEN_ENGINE, **LOADGEN_REPLICA))
        fleet.append(EngineProbe(torch, eng))
        return eng
    router = traffic.ReplicaRouter([replica()
                                    for _ in range(LOADGEN_REPLICAS)])
    mt.reset_launch_counts()
    t0 = time.perf_counter()
    rrec = traffic.drive(router, loaded)
    torch.cuda.synchronize()
    counts.append(mt.launch_counts())
    check_counts(counts[2], [p.run() for p in fleet], label)
    stats = router.stats()
    check(all(v == sum(getattr(e.fabric_stats, k) for e in router.engines)
              for k, v in stats.items()),
          f"{label}: the fleet census is not the sum of the replicas'")
    check(rrec.starved() == [] and len(rrec.requests) == len(trace)
          and all(r.done for r in rrec.requests.values()),
          f"{label}: a request neither served nor shed")
    for eng in router.engines:
        check(eng.drained and eng.kv.pool.pages_in_use == 0,
              f"{label}: a replica did not drain clean")
    ragg = rrec.report()["aggregate"]
    both = [rid for rid, r in rrec.requests.items()
            if r.shed_reason is None and toks1[rid]]
    same = sum(rrec.requests[rid].generated == toks1[rid] for rid in both)
    print(f"{label}: {ragg['served']} served, {ragg['shed']} shed over "
          f"{router.step_count} steps in {time.perf_counter() - t0:.3f} s "
          f"(per replica {[p.decodes for p in fleet]} decode steps, "
          f"{[e.fabric_stats.preemptions for e in router.engines]} "
          f"preemptions); goodput {ragg['goodput']}; of the {len(both)} "
          f"requests served here and in the CLI run, {same} with equal "
          f"streams (2 rows a step against 4); launches {counts[2]}",
          flush=True)
    print(rrec.format_table(), flush=True)

    # -- kernels 1-2 at one decode step's operands ---------------------------
    check(set(operands) == {"gather", "scatter"},
          f"{LOADGEN}: decode {arm} of the fault-free soak reached "
          f"{sorted(operands)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    def words(shape):
        info = torch.iinfo(torch.int32)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)
    rows[LOADGEN] = burst_step_rows(torch, words, operands, LOADGEN, False,
                                    rows_what="live-frame rows",
                                    slots_what="pool lines")
    for name, r in rows[LOADGEN].items():
        r["launches"] = sum(c[name] for c in counts)
        set_bound(r)
        print_row(name, LOADGEN, r)
    del params, eng1, probes, soak_probes, fleet, router, operands
    del soak_eng, ref_rec, soak_rec, rrec
    free_model(torch, LOADGEN)
    print(f"{LOADGEN}: phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def sharded_phase(torch, dev, rows) -> None:
    """The sharded page pool at full width: stablelm-1.6b (24 layers, 32 KV
    heads = N ports, random bf16 weights from seed 0) on the engine with 4
    slots, the :data:`SHARDED_GENS` requests of :data:`STABLELM_PROMPT`
    seeded tokens submitted at once (two wait and are admitted as the
    short ones retire).  Six engines step in turns: one shard, and each of
    :data:`SHARDED_RUNS` (2 and 4 shards, ``all_to_all`` and ``ring``)
    beside the single-device lowering on the same striped allocator (a
    1-shard engine with ``PagePool(n_shards=S)``).  Launch counts reset
    just before the loop and read just after.  After every step: each
    sharded engine's pool bytes (as integer words), page table, per-shard
    free lists and round-robin cursor equal its single-device twin's, its
    written frames (every slot's positions below its next write, through
    its page table) and its live slots' logits equal the one-shard run's;
    ``pool.check()`` runs inside every step.  At the end: equal tokens;
    every ``SchedulerStats`` field equal to the twin's but the two the
    sharded pool adds, ``collective_calls`` (4 a step: K and V read and
    written) and ``words_cross_shard`` (the reference's ``S*(S-1)*cap*N*w``
    fed by the plans of the steps); kernels 1 and 2 exactly ``S`` launches
    per sharded stream per direction, one per stream for the admission
    waves.  Prints each engine's median step, the host time of the step's
    ``shard_plan`` (the check of its hop rows included, and apart), and the
    exchange hop's device time (both collectives,
    at one step's operands, beside the whole sharded read and write bursts
    and the single-device fused gather of the same frames).  Kernels 1-2
    are held bit for bit against their plain versions at every shard's
    operands of that step, and timed at shard 0's (path
    :data:`SHARDED`).  Then the serve CLI at :data:`SHARDED_CLI`, full
    width: the same tokens, its report line, launches exact."""
    from repro_torch.data import SyntheticLM
    from repro_torch.fabric import PagePool, shard_plan
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving import engine as engine_mod

    t_phase = time.perf_counter()
    cfg, params = load_model(torch, dev, SHARDED_ARCH)
    n, d = cfg.resolved_fabric.n_ports, cfg.resolved_head_dim
    prompts = SyntheticLM(cfg, batch=len(SHARDED_GENS), seq=STABLELM_PROMPT,
                          seed=0).batch_at(0)["tokens"]
    t_max = STABLELM_PROMPT + max(SHARDED_GENS)
    card = card_line()
    runs = {}
    recorded = {}

    def add(label, shards=1, collective=None, striped=0, arm=0):
        eng = ServingEngine(cfg, params, max_slots=ENGINE_SLOTS, t_max=t_max,
                            pool_shards=shards, collective=collective,
                            check_pool=True)
        if striped:
            p = eng.kv.pool
            eng.kv.pool = PagePool(p.page_size, p.n_pages, p.pages_per_slot,
                                   eng.max_slots, n_shards=striped)
        run = dict(eng=eng, shards=shards, collective=collective,
                   reqs=[Request(i, prompts[i], max_new_tokens=g)
                         for i, g in enumerate(SHARDED_GENS)],
                   steps=[], steady=[], decodes=0, plan_s=[], check_s=[],
                   lives=[], counts=dict(ZERO_LAUNCHES))
        decode = eng._decode

        def counted(*args):
            run["decodes"] += 1
            if run["decodes"] != arm:
                return decode(*args)
            with sharded_operands(recorded.setdefault(label, {})):
                return decode(*args)
        eng._decode = counted
        if shards > 1:
            plans = eng.shard_plans

            def timed_plans(live_idx):
                checked.clear()
                t0 = time.perf_counter()
                out = plans(live_idx)
                run["plan_s"].append(time.perf_counter() - t0)
                run["check_s"].append(sum(checked))
                run["lives"].append(live_idx.copy())
                return out
            eng.shard_plans = timed_plans
        for r in run["reqs"]:
            eng.submit(r)
        runs[label] = run
        return run

    # the host check of each plan's hop rows, timed inside the plan's time
    checked = []
    check_rows = engine_mod.check_owned_rows

    def timed_check(*args):
        t0 = time.perf_counter()
        check_rows(*args)
        checked.append(time.perf_counter() - t0)
    engine_mod.check_owned_rows = timed_check

    base = add("S=1")
    twins = {}
    for shards, collective in SHARDED_RUNS:
        label = f"S={shards} {collective}"
        add(label, shards, collective,
            arm=SHARDED_ARM if (shards, collective) in SHARDED_TIMED else 0)
        if shards not in twins:
            twins[shards] = f"S=1 lowering, {shards}-striped"
            add(twins[shards], striped=shards)
        a, b = runs[label]["eng"], runs[twins[shards]]["eng"]
        check(a.live_bucket == b.live_bucket
              and a.kv.pool.n_pages == b.kv.pool.n_pages,
              f"sharded {label}: its twin's geometry differs")
    e = 2 * len(base["eng"].kv.paged_entries)       # K and V per paged leaf

    def pool_words(eng):
        return [leaf.view(torch.int16) for _, _, _, leaf in
                eng._cache_leaves()]

    def written(eng):
        """Every slot's frames below its next write position, through its
        page table: ``[R, frames, N, D]`` words per pool leaf."""
        ps = eng.page_size
        frames = []
        for s in range(eng.max_slots):
            if eng.active[s] is None:
                continue
            t = torch.arange(int(eng.pos[s]))
            pages = torch.from_numpy(eng.kv.pool.table[s].astype("int64"))
            frames.append(pages[t // ps] * ps + t % ps)
        idx = torch.cat(frames).to(dev)
        return [w.reshape(w.shape[0], -1, *w.shape[-2:]).index_select(1, idx)
                for w in pool_words(eng)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    order = list(runs.values())
    for step in range(10 * t_max):
        if all(r["eng"].drained for r in order):
            break
        for run in order:
            eng = run["eng"]
            before, dec = mt.launch_counts(), run["decodes"]
            waves = eng.kv.prefill_bursts
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            run["steps"].append(dt)
            if run["decodes"] > dec and eng.kv.prefill_bursts == waves:
                run["steady"].append(dt)
            for k, v in mt.launch_counts().items():
                run["counts"][k] += v - before[k]
        ref = base["eng"]
        check(len({r["eng"].drained for r in order}) == 1
              and len({tuple(r["eng"].pos) for r in order}) == 1,
              f"sharded: the engines left lockstep at step {step}")
        live = [s for s in range(ENGINE_SLOTS) if ref.active[s] is not None]
        ref_written = written(ref) if live else None
        for label, run in runs.items():
            eng = run["eng"]
            if run is base:
                continue
            if live:
                check(torch.equal(eng.last_logits[live],
                                  ref.last_logits[live]),
                      f"sharded {label}: logits differ from S=1 at step "
                      f"{step}")
                check(all(torch.equal(a, b) for a, b in
                          zip(written(eng), ref_written)),
                      f"sharded {label}: written frames differ from S=1 at "
                      f"step {step}")
            if run["shards"] == 1:
                continue
            twin = runs[twins[run["shards"]]]["eng"]
            a, b = eng.kv.pool, twin.kv.pool
            check((a.table == b.table).all() and a._rr == b._rr
                  and a._free_by_shard == b._free_by_shard,
                  f"sharded {label}: page table, free lists or cursor "
                  f"differ from its single-device twin at step {step}")
            check(all(torch.equal(x, y) for x, y in
                      zip(pool_words(eng), pool_words(twin))),
                  f"sharded {label}: pool bytes differ from its "
                  f"single-device twin at step {step}")
    engine_mod.check_owned_rows = check_rows
    total = mt.launch_counts()
    check(all(r["eng"].drained for r in order), "sharded: not drained")
    check({k: sum(r["counts"][k] for r in order) for k in total} == total,
          "sharded: the runs' launches do not add up")
    peak = torch.cuda.max_memory_allocated()

    want_tokens = [r.generated for r in base["reqs"]]
    check([len(g) for g in want_tokens] == list(SHARDED_GENS)
          and all(0 <= x < cfg.vocab_size for g in want_tokens for x in g),
          "sharded S=1: short streams or a token outside the vocab")
    for label, run in runs.items():
        eng, shards = run["eng"], run["shards"]
        check([r.generated for r in run["reqs"]] == want_tokens,
              f"sharded {label}: tokens differ from S=1")
        per = shards * e * run["decodes"]
        want = {**ZERO_LAUNCHES, "gather_burst_network_tiles": per,
                "scatter_burst_network_tiles":
                    per + e * eng.kv.prefill_bursts}
        check(run["counts"] == want,
              f"sharded {label}: launches {run['counts']} != {want}")
        if shards == 1:
            continue
        st, tw = eng.fabric_stats, runs[twins[shards]]["eng"].fabric_stats
        for f in dataclasses.fields(st):
            if f.name not in ("collective_calls", "words_cross_shard"):
                check(getattr(st, f.name) == getattr(tw, f.name),
                      f"sharded {label}: {f.name} {getattr(st, f.name)} != "
                      f"the twin's {getattr(tw, f.name)}")
        frames = eng.kv.pool.n_pages * eng.page_size
        cross = sum(2 * e * shards * (shards - 1) * n * d * shard_plan(
            live, frames, shards, n, reps=reps,
            cap_bucket=eng.page_size).cap
            for live in run["lives"] for reps in eng._shard_reps)
        check(st.collective_calls == e * 2 * run["decodes"] > 0
              and len(run["lives"]) == run["decodes"]
              and st.words_cross_shard == cross > 0,
              f"sharded {label}: {st.collective_calls} exchanges, "
              f"{st.words_cross_shard} words across shards; want "
              f"{e * 2 * run['decodes']} and {cross}")
    med1 = statistics.median(base["steady"])
    for label, run in runs.items():
        eng = run["eng"]
        med = statistics.median(run["steady"])
        extra = ""
        if run["shards"] > 1:
            plan_ms = statistics.median(run["plan_s"]) * 1e3
            check_ms = statistics.median(run["check_s"]) * 1e3
            st = eng.fabric_stats
            extra = (f"; shard_plan {plan_ms:.3f} host ms a step "
                     f"({plan_ms / (med * 1e3):.1%} of the step), the "
                     f"check of its hop rows {check_ms:.3f} of it; "
                     f"{st.collective_calls} exchanges, "
                     f"{st.words_cross_shard} words across shards of "
                     f"{st.words_moved} moved; free pages by shard at the "
                     f"end {eng.kv.pool.free_pages_by_shard}")
        print(f"sharded {label}: median steady step {med * 1e3:.3f} ms over "
              f"{len(run['steady'])} ({med / med1:.3f}x S=1), "
              f"{run['decodes']} decode steps; launches "
              f"{run['counts']}{extra}; {card}",
              flush=True)
    print(f"sharded: the {len(runs)} engines stepped in turns over "
          f"{len(base['steps'])} steps: equal tokens, live logits and "
          f"written frames every step; each sharded engine's pool words, "
          f"page table, free lists and cursor equal its single-device "
          f"twin's; peak memory {peak / 2 ** 30:.2f} GiB", flush=True)

    sharded_hops(torch, dev, rows, runs, recorded, e, card)
    del recorded, runs, order, base, twins, run, eng, ref, twin
    sharded_cli(torch, e)
    del params
    free_model(torch, "sharded")
    print(f"sharded: phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def sharded_hops(torch, dev, rows, runs, recorded, e: int, card: str):
    """The sharded phase's recorded decode (:func:`sharded_operands`):
    kernels 1-2 bit-equal to their plain versions at every shard's
    operands; the exchange hop timed with both collectives (they must give
    the same bits), beside the whole sharded read and write bursts and the
    single-device fused gather of the same frames (which must equal the
    sharded read); the kernels line's rows at shard 0's operands of run
    :data:`SHARDED_ROWS`."""
    from repro_torch.fabric import sharded as sh
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.kernels import ops
    from repro_torch.models import common as cm

    gen = torch.Generator(device=dev)
    gen.manual_seed(12)

    def words(shape):
        info = torch.iinfo(torch.int32)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)
    for label, seen in recorded.items():
        shards = runs[label]["shards"]
        check(len(seen["gathers"]) == len(seen["scatters"]) == shards * e
              and len(seen["reads"]) == e,
              f"sharded {label}: decode {SHARDED_ARM} recorded "
              f"{len(seen['gathers'])} gathers, {len(seen['scatters'])} "
              f"scatters")
        for i, (lines, idx, nn) in enumerate(seen["gathers"]):
            bit_equal(torch, mt.gather_burst_network_tiles(lines, idx, nn),
                      mt.gather_burst_plain(lines, idx, nn),
                      f"gather ({label}, hop {i})")
        for i, (banked, idx, into, nn) in enumerate(seen["scatters"]):
            bit_equal(torch, mt.scatter_burst_network_tiles(
                banked, idx, into.clone(), nn), mt.scatter_burst_plain(
                banked, idx, into.clone(), nn), f"scatter ({label}, hop {i})")
        stream, fetch, place, k_tot = seen["reads"][0]
        fab = runs[label]["eng"].fabric
        s, _, cap = fetch.shape
        reps, frames, n, w = stream.shape
        lines = stream.reshape(reps * frames, n, w)
        rows_ = sh._stream_rows(fetch, reps, frames)
        send = [fab.read_burst(lines, indices=rows_[o]).transpose(1, 2)
                .reshape(s, cap, n, w) for o in range(s)]
        a2a, ring = sh._exchange(send, "all_to_all"), sh._exchange(send,
                                                                   "ring")
        check(all(torch.equal(x, y) for x, y in zip(a2a, ring)),
              f"sharded {label}: the ring and the all-to-all differ")
        banked = fab.read_burst_sharded(stream, fetch, place, k_tot)
        live_rows = int((fetch < reps * frames // s).sum())
        live = runs[label]["lives"][SHARDED_ARM - 1]
        tiled = cm.pool_rep_indices(torch.from_numpy(live).to(dev), reps,
                                    frames)
        single = ops.burst_gather_read(lines, tiled, n)
        check(torch.equal(single, banked),
              f"sharded {label}: the sharded read differs from the "
              f"single-device fused gather of its frames")
        into = stream.clone()
        times = dict(
            a2a=time_ms(torch, lambda: sh._exchange(send, "all_to_all")),
            ring=time_ms(torch, lambda: sh._exchange(send, "ring")),
            read=time_ms(torch, lambda: fab.read_burst_sharded(
                stream, fetch, place, k_tot)),
            write=time_ms(torch, lambda: fab.write_burst_sharded(
                banked, fetch, place, into)),
            single=time_ms(torch, lambda: ops.burst_gather_read(
                lines, tiled, n)))
        moved = s * s * cap * n * w * 4
        print(f"sharded {label}: exchange hop at decode {SHARDED_ARM}'s "
              f"operands (stream {list(stream.shape)} int32, {s} shards x "
              f"buckets of {cap} lines, {live_rows} live of {s * s * cap}; "
              f"{moved} bytes a hop): all_to_all {times['a2a']:.4f} ms, "
              f"ring {times['ring']:.4f} ms (bit-equal); the whole sharded "
              f"read burst {times['read']:.4f} ms and write burst "
              f"{times['write']:.4f} ms, against the single-device fused "
              f"gather of the same frames {times['single']:.4f} ms; {card}",
              flush=True)
        if label != SHARDED_ROWS:
            continue
        lines0, idx0, n0 = seen["gathers"][0]
        banked0, sidx0, into0, _ = seen["scatters"][0]
        rows[SHARDED] = burst_step_rows(
            torch, words, {"gather": (lines0, idx0, n0),
                           "scatter": (banked0, sidx0, into0, n0)},
            SHARDED, False, rows_what="shard-0 hop rows",
            slots_what="pool lines")
        for name, r in rows[SHARDED].items():
            r["launches"] = runs[label]["counts"][name]
            set_bound(r)
            print_row(name, SHARDED, r)


def sharded_cli(torch, e: int) -> None:
    """The serve CLI a user calls, at full width, at each of
    :data:`SHARDED_CLI`: its report line, kernels 1-2's launches exactly
    ``S`` per sharded stream per direction (one scatter per stream per
    admission wave), and the same tokens at every shard count."""
    import io

    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving import ServingEngine

    served = {}

    class Recording(ServingEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            served["eng"], served["reqs"] = self, []

        def submit(self, req):
            served["reqs"].append(req)
            return super().submit(req)
    cli_tokens = {}
    serve_cli.ServingEngine = Recording
    try:
        for shards, collective in SHARDED_CLI:
            argv = ["--arch", SHARDED_ARCH, "--batch", str(ENGINE_SLOTS),
                    "--prompt-len", str(STABLELM_PROMPT), "--gen-len",
                    str(SHARDED_CLI_GEN), "--engine", "--check-pool",
                    "--pool-shards", str(shards), "--collective", collective]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                serve_cli.main(argv)
            text = out.getvalue()
            eng = served["eng"]
            counts = mt.launch_counts()
            per = shards * e * eng.step_count
            want = {**ZERO_LAUNCHES, "gather_burst_network_tiles": per,
                    "scatter_burst_network_tiles":
                        per + e * eng.kv.prefill_bursts}
            line = [x for x in text.splitlines()
                    if x.startswith("sharded pool:")]
            label = f"sharded serve --pool-shards {shards} --collective " \
                    f"{collective}"
            check(counts == want, f"{label}: launches {counts} != {want}")
            check(len(line) == (shards > 1) and eng.step_count
                  == SHARDED_CLI_GEN - 1, f"{label}: report {line}, "
                  f"{eng.step_count} steps")
            cli_tokens[shards] = [r.generated for r in served["reqs"]]
            served.clear()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            served_line = [x for x in text.splitlines()
                           if x.startswith("served")]
            print(f"{label}: {served_line[0] if served_line else ''}; "
                  f"{line[0] if line else 'no sharded pool'}; launches "
                  f"{counts}", flush=True)
    finally:
        serve_cli.ServingEngine = ServingEngine
    check(len({str(t) for t in cli_tokens.values()}) == 1,
          "sharded serve: the CLI's tokens differ across shard counts")


@contextlib.contextmanager
def sharded_operands(seen: dict):
    """While open, record into ``seen`` (cloned) every operand set that
    reaches kernels 1-2 through ``kernels.ops`` (``gathers``,
    ``scatters``: one per shard per sharded stream) and every sharded read
    burst's operands (``reads``: ``(stream, fetch, place, k_tot)``)."""
    from repro_torch.fabric import sharded as sh
    from repro_torch.kernels import ops

    gather, scatter = ops.burst_gather_read, ops.burst_scatter_write
    read = sh.sharded_read_burst
    for key in ("gathers", "scatters", "reads"):
        seen.setdefault(key, [])

    def gather_spy(lines, idx, n):
        seen["gathers"].append((lines.clone(), idx.clone(), n))
        return gather(lines, idx, n)

    def scatter_spy(banked, idx, into, n):
        seen["scatters"].append((banked.clone(), idx.clone(), into.clone(),
                                 n))
        return scatter(banked, idx, into, n)

    def read_spy(fabric, stream, fetch, place, k_tot):
        seen["reads"].append((stream.clone(), fetch.clone(), place.clone(),
                              k_tot))
        return read(fabric, stream, fetch, place, k_tot)
    ops.burst_gather_read, ops.burst_scatter_write = gather_spy, scatter_spy
    sh.sharded_read_burst = read_spy
    try:
        yield seen
    finally:
        ops.burst_gather_read, ops.burst_scatter_write = gather, scatter
        sh.sharded_read_burst = read


def read_sim_phase(torch, dev) -> None:
    """The paper's burst simulator on the card: the constant N-cycle
    latency of one line (the reference's ``tests/test_burst.py::
    test_single_line_constant_latency``), its pop equal bit for bit to the
    same scenario on the CPU."""
    import numpy as np

    from repro_torch.core import MedusaReadSim

    n = 8
    line = np.random.RandomState(0).randn(n)
    pops = []
    for where in (dev, torch.device("cpu")):
        sim = MedusaReadSim(n, depth=4, device=where)
        sim.push_line(3, line)
        sim.run(n)
        check(sim.completion_latency(3, 0) == n,
              f"MedusaReadSim on {where}: latency "
              f"{sim.completion_latency(3, 0)}, not {n} cycles")
        pops.append(sim.pop_line(3, 0).cpu().reshape(-1))
    check(torch.equal(pops[0].view(torch.int32), pops[1].view(torch.int32))
          and torch.equal(pops[1], torch.from_numpy(line).float()),
          "MedusaReadSim: the card's pop differs from the CPU's or the line")
    print(f"MedusaReadSim N={n} on {torch.cuda.get_device_name(0)}: one line "
          f"completes in the constant {n} cycles, its pop bit-equal to the "
          f"CPU's", flush=True)


def churn_card_vs_cpu(torch, dev) -> None:
    """The float32 stablelm smoke through the reference's churn trace
    (:data:`CHURN_SPEC`, a 7-page pool, 2 slots, page 4) on the card and on
    the CPU: the swap arm, the recompute arm, and the swap arm with a
    mid-step failure at its first preempting step and a corrupted swap
    transfer.  Tokens, every ``SchedulerStats`` field and the pool's state
    must be equal; the pool and ring bytes (computed K/V) within 1e-4.  The
    faulted arm corrupts the first swap transfer the rollback does not
    undo, so it is retried."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.runtime import FaultInjector
    from repro_torch.serving import Request, ServingEngine

    small = dataclasses.replace(get_smoke("stablelm-1.6b"), dtype="float32")
    params = {"cpu": api.init_params(small, seed=1, device="cpu")}
    params["gpu"] = api.init_params(small, seed=1, device="cpu").to(dev)
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, small.vocab_size, (pl,), generator=gen,
                             dtype=torch.int32).numpy()
               for _, pl, _, _ in CHURN_SPEC]

    def run(p, preempt, inj):
        """One churn; returns its tokens, stats, pool state and leaves, the
        first step that preempted and the swap transfers made in it."""
        eng = ServingEngine(small, p, max_slots=2, t_max=24, page_size=4,
                            pool_pages=7, preempt=preempt, check_pool=True,
                            fault_injector=inj)
        reqs = [Request(i, prompts[i], max_new_tokens=mn, priority=pri)
                for i, (_, _, mn, pri) in enumerate(CHURN_SPEC)]
        pend, first, swaps = list(range(len(reqs))), None, 0
        while pend or not eng.drained:
            while pend and CHURN_SPEC[pend[0]][0] <= eng.step_count:
                eng.submit(reqs[pend.pop(0)])
            st = eng.fabric_stats
            before = st.preemptions, st.swap_bursts
            eng.step()
            if first is None and st.preemptions > before[0]:
                first, swaps = eng.step_count - 1, st.swap_bursts - before[1]
            check(eng.step_count < 300, "churn did not drain")
        pool = eng.kv.pool
        return dict(
            toks=[r.generated for r in reqs],
            stats=dataclasses.asdict(eng.fabric_stats),
            pool=(pool.table.tolist(), [list(s) for s in pool._free_by_shard],
                  pool.pages_allocated, pool.pages_reclaimed,
                  pool.pages_swapped_out, pool.pages_swapped_in),
            leaves=[leaf.cpu() for *_, leaf in eng._cache_leaves()],
            first=first, swaps=swaps)

    base = run(params["cpu"], "swap", None)
    check(base["first"] is not None, "the churn never preempted")
    for arm, preempt, faults in (
            ("swap", "swap", None), ("recompute", "recompute", None),
            ("swap + faults", "swap",
             dict(fail_at=(base["first"],),
                  corrupt_swap=(base["swaps"],)))):
        out = {dev_name: run(p, preempt, None if faults is None else
                             FaultInjector(**faults))
               for dev_name, p in params.items()}
        a, c = out["gpu"], out["cpu"]
        check(a["toks"] == c["toks"], f"churn {arm}: card and CPU tokens "
              f"differ")
        check(a["stats"] == c["stats"], f"churn {arm}: card and CPU "
              f"SchedulerStats differ: {a['stats']} vs {c['stats']}")
        check(a["pool"] == c["pool"], f"churn {arm}: card and CPU pool state "
              f"differs")
        err = max(float((x - y).abs().max()) for x, y in
                  zip(a["leaves"], c["leaves"]))
        same = sum(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(a["leaves"], c["leaves"]))
        check(err <= 1e-4, f"churn {arm}: pool bytes differ by {err}")
        if faults is not None:
            check(a["stats"]["faults_recovered"] == 1
                  and a["stats"]["bursts_retried"] == 1,
                  f"churn {arm}: the faults were not recovered")
        st = a["stats"]
        print(f"smoke stablelm-1.6b float32 churn ({arm}) card vs CPU: "
              f"tokens, all SchedulerStats fields and the pool state equal "
              f"({st['preemptions']} preemptions, {st['swap_bursts']} swap "
              f"bursts, {st['bursts_retried']} retried, "
              f"{st['faults_recovered']} faults recovered); cache leaves max "
              f"abs diff {err:.2e} (tolerance 1e-4), {same} of "
              f"{len(a['leaves'])} leaves bit-equal", flush=True)


@contextlib.contextmanager
def transpose_operands(seen: dict):
    """While open, record into ``seen["backward"]`` (cloned) the leaves of
    the first layout-engine call made inside an autograd backward (the
    gradients on their way back through kernel 4)."""
    from repro_torch.kernels import launch as kl
    from repro_torch.kernels import medusa_transpose as mt

    orig = mt.medusa_transpose_many

    def spy(xs):
        xs = list(xs)
        if kl._IN_BACKWARD[0] and "backward" not in seen:
            seen["backward"] = [x.clone() for x in xs]
        return orig(xs)
    mt.medusa_transpose_many = spy
    try:
        yield seen
    finally:
        mt.medusa_transpose_many = orig


def run_train_cli(torch, args):
    """``repro_torch.launch.train.main(args)``, its standard output echoed;
    returns ``(state, runner, history, output)``."""
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, runner, history = train.main(args)
    torch.cuda.synchronize()
    out = buf.getvalue()
    print(out, end="", flush=True)
    return state, runner, history, out


def loss_and_grads(torch, params, batch, cfg):
    """``api.loss_fn`` and the gradient of every parameter (in
    ``param_list`` order), the parameters set to require grad."""
    from repro_torch.convert import param_list
    from repro_torch.models import api

    ps = param_list(params)
    for p in ps:
        p.requires_grad_(True)
    loss = api.loss_fn(params, batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, ps)


def on_card(torch, batch, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def run_steps(torch, cfg, params, data, steps: int, label: str):
    """``steps`` steps of ``build_train_step`` (batch and sequence of
    ``data``, the AdamW state fresh), launch counts reset before; checks
    every loss is finite; returns the launch counts, the backward launch
    counts, the median step and the losses."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import init_opt_state

    tcfg = TrainConfig(lr=1e-4, warmup_steps=1, total_steps=steps,
                       grad_accum=1)
    step = build_train_step(cfg, ShapeConfig(label, data.seq, data.batch,
                                             "train"), tcfg).fn
    state = {"params": params,
             "opt": init_opt_state(params, tcfg, master=False)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    counts, back = mt.launch_counts(), mt.backward_launch_counts()
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss {losses}")
    print(f"{label}: {steps} steps of {data.batch} x {data.seq}, losses "
          f"{[round(x, 4) for x in losses]}, median step "
          f"{statistics.median(times) * 1e3:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launches {dict((k, v) for k, v in counts.items() if v) or 'none'}"
          f" of which in the backward "
          f"{dict((k, v) for k, v in back.items() if v) or 'none'}",
          flush=True)
    del state
    return counts, back, statistics.median(times), losses


def profile_train(torch, cfg, params, data, label: str,
                  out_name: str) -> None:
    """The census (:func:`census`) of ``build_train_step``'s steps on
    ``data``'s batches (the AdamW state fresh)."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import init_opt_state

    tcfg = TrainConfig(lr=1e-4, warmup_steps=1, total_steps=100,
                       grad_accum=1)
    step = build_train_step(cfg, ShapeConfig(label, data.seq, data.batch,
                                             "train"), tcfg).fn
    state = {"params": params,
             "opt": init_opt_state(params, tcfg, master=False)}
    batches = [data.batch_at(i) for i in range(2)]
    calls = [0]

    def one():
        step(state, batches[calls[0] % 2])
        calls[0] += 1
    census(torch, label, one, out_name)
    del state


def train_phase(torch, dev, rows, with_profile: bool = False) -> None:
    """Training on the card.  (a) stablelm-1.6b at full width and depth
    (24 layers, d_model 2048, vocab 100352; random bf16 weights from the
    CLI's seed) through ``repro_torch.launch.train.main``: 8 steps of 8 x
    64 tokens, remat on, no checkpoint written; every loss finite, the
    median step, tokens/s and the peak memory; no movement kernel runs on
    a dense model's step.  (b) The fault path through the same CLI at the
    same widths, the depth cut to 2 layers (a full-depth state is ~17 GB
    of npz): 12 steps, a checkpoint every 4, a failure injected at step 6;
    it must restart once and finish at step 12, the replayed step 5 giving
    its first loss; then the state's save and in-place restore, timed.
    (c) granite-moe-3b-a800m at full width and depth: one loss and its
    gradients at 2 x 64 — every expert weight's gradient non-zero, the
    bursts launched exactly once per MoE layer in the forward, again in
    the rematerialised forward and once (the adjoint) in the backward —
    kernels 1-2 held bit for bit and timed at the backward's recorded
    operands (path ``granite-moe-3b-a800m train backward``); then 2 train
    steps with the same launches per step.  (d) The six float32 smokes'
    loss and every gradient, card against CPU."""
    import shutil

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.convert import param_list, reference_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import medusa_transpose as mt

    t_phase = time.perf_counter()
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = get_config(TRAIN_ARCH)
    common = ["--arch", TRAIN_ARCH, "--device", "cuda", "--batch",
              str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir",
              str(ckpt_dir), "--log-every", "1"]

    # -- (a) stablelm-1.6b at full width --------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mt.reset_launch_counts()
    state, runner, history, out = run_train_cli(
        torch, common + ["--steps", str(TRAIN_STEPS), "--ckpt-every",
                         str(10 ** 6)])
    counts = mt.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(loss) for _, _, loss in history]
    check(f"done at step {TRAIN_STEPS}; restarts=0" in out
          and len(losses) == TRAIN_STEPS
          and all(math.isfinite(x) for x in losses),
          f"train {TRAIN_ARCH}: {out[-300:]}")
    check(counts == ZERO_LAUNCHES, f"train {TRAIN_ARCH}: launches {counts}")
    check(not ckpt_dir.exists(), f"train {TRAIN_ARCH} wrote a checkpoint")
    if with_profile:
        profile_train(torch, cfg, state["params"],
                      SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ),
                      f"{TRAIN_ARCH} train step", "train_stablelm")
    times = [b[1] - a[1] for a, b in zip(history, history[1:])]
    med = statistics.median(times)
    print(f"train {TRAIN_ARCH} full width ({cfg.param_count()} params, "
          f"bf16, remat {cfg.remat}): {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, losses {[round(x, 4) for x in losses]}; median "
          f"step (steps 2-{TRAIN_STEPS}) {med * 1e3:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s; peak memory "
          f"{peak:.2f} GiB; {card_line()}", flush=True)
    del state, runner, history
    free_model(torch, f"train {TRAIN_ARCH}")

    # -- (b) the fault path, depth cut to FAULT_LAYERS ----------------------
    t0 = time.perf_counter()
    state, runner, history, out = run_train_cli(
        torch, common + ["--layers", str(FAULT_LAYERS), "--steps",
                         str(FAULT_STEPS), "--ckpt-every", str(FAULT_EVERY),
                         "--fail-at", str(FAULT_AT)])
    wall = time.perf_counter() - t0
    check(f"done at step {FAULT_STEPS}" in out and "restarts=1" in out,
          f"train fault path: {out[-300:]}")
    seq = [h[0] for h in history]
    last = FAULT_AT // FAULT_EVERY * FAULT_EVERY
    check(seq == list(range(1, FAULT_AT + 1))
          + list(range(last + 1, FAULT_STEPS + 1)),
          f"train fault path: steps {seq}")
    first, again = float(history[last][2]), float(history[FAULT_AT][2])
    check(abs(first - again) <= 1e-6 * abs(first),
          f"train fault path: step {last + 1} replayed to loss {again}, "
          f"not {first}")
    ps = param_list(state["params"])
    kept = ps[0].detach().clone()
    t0 = time.perf_counter()
    path = save_checkpoint(str(ckpt_dir), 10 ** 6, state,
                           {"data_step": FAULT_STEPS})
    save_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in Path(path).iterdir())
    with torch.no_grad():
        ps[0].zero_()
    t0 = time.perf_counter()
    restore_checkpoint(str(ckpt_dir), 10 ** 6, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(torch.equal(ps[0], kept), "train fault path: the restore did not "
          "put the saved parameters back")
    print(f"train fault path ({TRAIN_ARCH}, depth cut to {FAULT_LAYERS} "
          f"layers): {FAULT_STEPS} steps, checkpoint every {FAULT_EVERY}, "
          f"failure at step {FAULT_AT}: restarts=1, done at step "
          f"{FAULT_STEPS}, step {last + 1} replayed to the same loss, "
          f"{wall:.1f}s wall; one state ({size / 2 ** 30:.2f} GiB of npz) "
          f"saved in {save_s:.2f}s and restored in place in "
          f"{restore_s:.2f}s", flush=True)
    del state, runner, history, ps, kept
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_model(torch, "train fault path")

    # -- (c) granite-moe-3b-a800m at full width --------------------------
    cfg, params = load_model(torch, dev, MOE_ARCH)
    n = cfg.n_layers
    data = SyntheticLM(cfg, batch=MOE_TRAIN_BATCH, seq=TRAIN_SEQ, seed=0)
    seen = {}
    mt.reset_launch_counts()
    with burst_operands(seen, backward=True):
        loss, grads = loss_and_grads(torch, params,
                                     on_card(torch, data.batch_at(0), dev),
                                     cfg)
    torch.cuda.synchronize()
    counts, back = mt.launch_counts(), mt.backward_launch_counts()
    bursts = ("gather_burst_network_tiles", "scatter_burst_network_tiles")
    # per kernel and MoE layer: the forward, the rematerialised forward,
    # the adjoint in the backward
    per = 3 if cfg.remat != "none" else 2
    check(counts == {**ZERO_LAUNCHES, **dict.fromkeys(bursts, per * n)}
          and back == {**ZERO_LAUNCHES, **dict.fromkeys(bursts, n)},
          f"train {MOE_ARCH}: launches {counts}, backward {back}; want "
          f"{per} and 1 per kernel per MoE layer")
    check(math.isfinite(float(loss)), f"train {MOE_ARCH}: loss {loss}")
    k = 0
    zero = []
    for path, ts, _ in reference_leaves(params):
        for g in grads[k:k + len(ts)]:
            if path[-1] in ("w_gate", "w_up", "w_out") and not bool(
                    g.ne(0).any()):
                zero.append(path)
        k += len(ts)
    check(not zero, f"train {MOE_ARCH}: zero expert gradients at {zero}")
    print(f"train {MOE_ARCH} full width: loss {float(loss):.4f}; every "
          f"expert weight's gradient non-zero; kernels 1-2 {per * n} "
          f"launches each per step ({n} in the forward, "
          f"{(per - 2) * n} where remat (={cfg.remat}) recomputes the "
          f"blocks, {n} the adjoints in the backward)", flush=True)
    del grads
    counts, back, _, _ = run_steps(torch, cfg, params, data, MOE_TRAIN_STEPS,
                                   f"train {MOE_ARCH} steps")
    s = MOE_TRAIN_STEPS
    check(counts == {**ZERO_LAUNCHES, **dict.fromkeys(bursts, per * n * s)}
          and back == {**ZERO_LAUNCHES, **dict.fromkeys(bursts, n * s)},
          f"train {MOE_ARCH} steps: launches {counts}, backward {back}")
    del params
    free_model(torch, MOE_ARCH)

    # kernels 1-2 at the backward's recorded operands; the kernels line
    # counts the train steps' backward launches
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)

    def words(shape, dtype=torch.int32):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(dtype)
    rows[MOE_TRAIN] = burst_step_rows(torch, words, seen, MOE_TRAIN, False,
                                      rows_what="assignment gradient rows",
                                      slots_what="expert-slot gradients")
    del seen
    for name, r in rows[MOE_TRAIN].items():
        r["launches"] = back[name]
        set_bound(r)
        print_row(name, MOE_TRAIN, r)

    train_card_vs_cpu(torch, dev)
    print(f"train phase: {time.perf_counter() - t_phase:.1f}s wall; "
          f"{card_line()}", flush=True)


def train_card_vs_cpu(torch, dev) -> None:
    """The six trained families' smoke configs in float32, the same
    parameters and batch on the card and on the CPU: the loss and every
    gradient within 1e-4."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import SyntheticLM
    from repro_torch.models import api

    for arch in TRAIN_SMOKES:
        small = dataclasses.replace(get_smoke(arch), dtype="float32")
        batch = SyntheticLM(small, batch=2, seq=16, seed=1).batch_at(0)
        out = {}
        for name, device in (("cpu", "cpu"), ("gpu", dev)):
            params = api.init_params(small, seed=1, device="cpu").to(device)
            loss, grads = loss_and_grads(torch, params,
                                         on_card(torch, batch, device), small)
            out[name] = (float(loss), [g.cpu() for g in grads])
        (la, ga), (lc, gc) = out["gpu"], out["cpu"]
        errs = [float((a - c).abs().max()) for a, c in zip(ga, gc)]
        check(abs(la - lc) <= 1e-4 and all(
            torch.allclose(a, c, atol=1e-4, rtol=1e-4)
            for a, c in zip(ga, gc)),
            f"{arch} smoke: card vs CPU loss {la} vs {lc}, gradients differ "
            f"by up to {max(errs)}")
        print(f"smoke {arch} float32 train card vs CPU: loss {la:.6f} vs "
              f"{lc:.6f}, all {len(ga)} gradients within 1e-4 (max abs diff "
              f"{max(errs):.2e})", flush=True)


def whisper_phase(torch, dev, rows, with_profile: bool = False) -> None:
    """whisper-medium at full width and depth (24 encoder + 24 decoder
    layers, d_model 1024, 16 KV heads = N ports of 64 lanes; random bf16
    weights from seed 0).  (a) The one-shot: 2 rows of the data stub's
    1500 frames and 64 tokens, 32 decode steps; kernel 4 exactly one
    launch at prefill (every decoder layer's cross K and V made port-major
    together, 48 leaves) and 24 a decode step (each layer's self-attention
    cache, K and V in one launch); the tokens and every step's logits
    bit-identical with the kernels off and on the crossbar fabric.  (b)
    Training at 2 x 64: one loss and its gradients with the kernels on
    (one forward and one backward kernel-4 launch, 48 leaves each) and
    off, within 1e-2 of each other (bf16); then 3 train steps, one forward
    and one backward launch each.  (c) Kernel 4 held and timed at the
    48-leaf cross K/V list (prefill and training: the same leaves), the
    self cache's pair and the 48 gradients recorded in the backward (paths
    ``whisper-medium prefill``, ``decode``, ``train``, ``train
    backward``)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import medusa_transpose as mt
    from repro_torch.kernels import ops
    from repro_torch.models import api

    t_phase = time.perf_counter()
    cfg, params = load_model(torch, dev, WHISPER_ARCH)
    b, s, g = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN
    per = cfg.n_layers                  # launches a decode step
    kernel4 = "medusa_transpose_tiles"
    batch = SyntheticLM(cfg, batch=b, seq=s, seed=0).batch_at(0)
    check(batch["frames"].shape == (b, cfg.encoder_seq, cfg.d_model),
          f"{WHISPER_ARCH}: the data stub gave frames "
          f"{batch['frames'].shape}")
    prompt = torch.as_tensor(batch["tokens"], device=dev)
    extra = {"frames": torch.as_tensor(batch["frames"], device=dev)}

    # -- (a) serving --------------------------------------------------------
    mt.reset_launch_counts()
    with torch.no_grad():
        api.prefill_fn(params, {"tokens": prompt, **extra}, cfg, s + g)
    torch.cuda.synchronize()
    check(mt.launch_counts() == {**ZERO_LAUNCHES, kernel4: 1},
          f"{WHISPER_ARCH} prefill: launches {mt.launch_counts()}")
    label = f"{WHISPER_ARCH} one-shot ({cfg.encoder_seq} frames + {s} tokens)"
    toks, logits, counts = one_shot(torch, cfg, params, prompt, g, s + g,
                                    label, {kernel4: 1 + per * g}, extra)
    rows[WHISPER_PREFILL] = {kernel4: {"launches": 1}}
    rows[WHISPER_DECODE] = {kernel4: {"launches": counts[kernel4] - 1}}
    ops.use_kernels(False)
    try:
        toks_off, logits_off, _ = one_shot(
            torch, cfg, params, prompt, g, s + g, f"{label}, kernels off", {},
            extra)
    finally:
        ops.use_kernels(True)
    toks_x, logits_x, _ = one_shot(
        torch, dataclasses.replace(cfg, kv_layout="crossbar"), params, prompt,
        g, s + g, f"{label}, crossbar fabric", {}, extra)
    for what, (t_o, l_o) in (("kernels off", (toks_off, logits_off)),
                             ("crossbar fabric", (toks_x, logits_x))):
        check(torch.equal(toks, t_o), f"{WHISPER_ARCH} one-shot: the {what} "
              f"run served other tokens")
        same_steps(torch, logits, l_o, f"{WHISPER_ARCH} one-shot, {what}")
    print(f"{WHISPER_ARCH} one-shot: tokens and all {g} steps' logits "
          f"bit-identical with the kernels on, off and on the crossbar "
          f"fabric; layout-engine launches 1 at prefill and {per} a "
          f"decode step", flush=True)
    del logits, logits_off, logits_x

    # -- (b) training -------------------------------------------------------
    data = SyntheticLM(cfg, batch=b, seq=TRAIN_SEQ, seed=1)
    tb = on_card(torch, data.batch_at(0), dev)
    seen = {}
    mt.reset_launch_counts()
    with transpose_operands(seen):
        loss_on, g_on = loss_and_grads(torch, params, tb, cfg)
    torch.cuda.synchronize()
    counts, back = mt.launch_counts(), mt.backward_launch_counts()
    check(counts == {**ZERO_LAUNCHES, kernel4: 2}
          and back == {**ZERO_LAUNCHES, kernel4: 1},
          f"{WHISPER_ARCH} loss and gradients: launches {counts}, backward "
          f"{back}; want 1 forward and 1 backward")
    check(len(seen["backward"]) == 2 * cfg.n_layers,
          f"{WHISPER_ARCH}: the backward launch moved "
          f"{len(seen['backward'])} gradients, not {2 * cfg.n_layers}")
    ops.use_kernels(False)
    try:
        loss_off, g_off = loss_and_grads(torch, params, tb, cfg)
    finally:
        ops.use_kernels(True)
    rel = [float((a.float() - c.float()).norm()
                 / c.float().norm().clamp(min=1e-30))
           for a, c in zip(g_on, g_off)]
    check(abs(float(loss_on) - float(loss_off)) <= 1e-2 * abs(float(loss_off))
          and max(rel) <= 1e-2 and math.isfinite(float(loss_on)),
          f"{WHISPER_ARCH}: kernels on vs off loss {float(loss_on)} vs "
          f"{float(loss_off)}, gradients differ by up to {max(rel)} "
          f"(relative)")
    check(all(bool(torch.isfinite(x).all()) for x in g_on),
          f"{WHISPER_ARCH}: a non-finite gradient")
    print(f"{WHISPER_ARCH} loss and gradients at {b} x {TRAIN_SEQ}: loss "
          f"{float(loss_on):.4f} with the kernels on, {float(loss_off):.4f} "
          f"off; every gradient within {max(rel):.2e} of the kernels-off one "
          f"(relative, tolerance 1e-2); layout-engine launches 1 forward, "
          f"1 backward ({2 * cfg.n_layers} leaves each)", flush=True)
    del g_on, g_off
    counts, back, _, _ = run_steps(torch, cfg, params, data,
                                   WHISPER_TRAIN_STEPS,
                                   f"train {WHISPER_ARCH}")
    st = WHISPER_TRAIN_STEPS
    check(counts == {**ZERO_LAUNCHES, kernel4: 2 * st}
          and back == {**ZERO_LAUNCHES, kernel4: st},
          f"train {WHISPER_ARCH}: launches {counts}, backward {back}")
    rows[WHISPER_TRAIN] = {kernel4: {"launches": st}}
    rows[WHISPER_BACKWARD] = {kernel4: {"launches": back[kernel4]}}
    if with_profile:
        profile_train(torch, cfg, params, data, f"{WHISPER_ARCH} train step",
                      "train_whisper")
    del params
    free_model(torch, WHISPER_ARCH)

    # -- (c) kernel 4 at whisper's shapes -------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)

    def words(shape, dtype=torch.int32):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             device=dev, dtype=torch.int64).to(dtype)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cross = pair_row(torch, words, (b, cfg.encoder_seq, hkv, hd), flush,
                     f"{WHISPER_ARCH} cross K/V of every layer",
                     n=2 * cfg.n_layers)
    new = {WHISPER_PREFILL: cross,
           WHISPER_DECODE: pair_row(torch, words, (b, s + g, hkv, hd), flush,
                                    f"{WHISPER_ARCH} self cache's K and V"),
           WHISPER_TRAIN: dict(cross),      # the same leaves in training
           WHISPER_BACKWARD: leaves_row(torch, seen["backward"], flush,
                                        f"{WHISPER_ARCH} cross K/V "
                                        f"gradients")}
    del flush, seen
    for path, r in new.items():
        rows[path][kernel4].update(r)
        set_bound(rows[path][kernel4])
        print_row(kernel4, path, rows[path][kernel4])
    print(f"whisper phase: {time.perf_counter() - t_phase:.1f}s wall; "
          f"{card_line()}", flush=True)


def ring_moe(p, x, n: int, collective: str, cfg):
    """The ring MoE over ``n`` ranks: ``x``'s rows split into ``n`` rank
    blocks, each rank's views of the experts; the outputs concatenated."""
    import torch

    from repro_torch.models.moe_shardmap import (moe_apply_shardmap,
                                                 shard_expert_params)

    return torch.cat(moe_apply_shardmap(
        [shard_expert_params(p, r, n, cfg) for r in range(n)],
        list(x.chunk(n)), cfg, collective))


def ring_moe_grads(torch, p, x, cot, n: int, cfg):
    """The ring MoE's output and the gradients of ``sum(out * cot)`` by
    the four weight leaves (fresh leaves that require grad)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    out = ring_moe(leaves, x, n, "ring", cfg)
    grads = torch.autograd.grad((out * cot).sum(),
                                [leaves[k] for k in PAR_LEAVES])
    return out.detach(), grads


def par_ring_moe(torch, dev) -> None:
    """(a) of :func:`parallel_phase`."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.parallel import collectives

    cfg = get_config(MOE_ARCH)
    m, d = cfg.moe, cfg.d_model
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    p16 = moe.moe_params(cfg, torch.bfloat16, gen, dev)
    p32 = {k: v.float() for k, v in p16.items()}
    rows, toks = PAR_MOE_X
    x32 = torch.randn(rows, toks, d, generator=gen, device=dev)
    x16 = x32.to(torch.bfloat16)

    # ring and xla exchange the same bits, at every rank count, both dtypes
    for label, p, x in (("bf16", p16, x16), ("fp32", p32, x32)):
        for n in PAR_RANKS:
            ring = ring_moe(p, x, n, "ring", cfg)
            xla = ring_moe(p, x, n, "xla", cfg)
            check(torch.equal(ring, xla) and bool(torch.isfinite(ring).all()),
                  f"ring MoE {label} n={n}: ring and xla differ "
                  f"(max abs {float((ring.float() - xla.float()).abs().max())})")
    print(f"parallel: ring MoE {MOE_ARCH} layer (d_model {d}, "
          f"{m.n_experts} experts top-{m.top_k}, expert d_ff "
          f"{m.expert_d_ff}, capacity factor {m.capacity_factor}) on x "
          f"[{rows}, {toks}, {d}]: ring == xla bit for bit at n = "
          f"{list(PAR_RANKS)}, bf16 and fp32", flush=True)

    # the layer's time at each n and collective, the exchanges' device time
    t = rows * toks
    for n in PAR_RANKS:
        cap = max(int(t // n * m.top_k * m.capacity_factor / m.n_experts), 1)
        e_loc = m.n_experts_padded // n
        sends = [torch.randn(n, e_loc * cap, d, generator=gen, device=dev)
                 .to(torch.bfloat16) for _ in range(n)]
        parts = []
        for coll, fn in (("ring", collectives.ring_all_to_all),
                         ("xla", collectives.xla_all_to_all)):
            layer = statistics.median(
                wall_ms(torch, lambda: ring_moe(p16, x16, n, coll, cfg))
                for _ in range(5))
            hop = time_ms(torch, lambda: fn(sends), reps=10,
                          spin=4 * SPIN_CYCLES)
            parts.append(f"{coll} {layer:.3f} ms (each of its two "
                         f"exchanges {hop:.4f} ms on the device)")
        print(f"parallel: ring MoE bf16 n={n} (cap {cap} a rank, send "
              f"blocks [{n}, {e_loc * cap}, {d}] a rank): "
              + "; ".join(parts), flush=True)
        del sends
    single = statistics.median(wall_ms(torch, lambda: moe.moe_apply(
        p16, x16, cfg)) for _ in range(5))
    print(f"parallel: moe_apply (kernels 1-2, one device) on the same "
          f"tokens: {single:.3f} ms", flush=True)

    # fp32 at the config's capacity: the card against the CPU
    n = PAR_CPU_RANKS
    cot = torch.randn(x32.shape, generator=gen, device=dev)
    out, grads = ring_moe_grads(torch, p32, x32, cot, n, cfg)
    t0 = time.perf_counter()
    cpu = {k: v.cpu() for k, v in p32.items()}
    out_h, grads_h = ring_moe_grads(torch, cpu, x32.cpu(), cot.cpu(), n, cfg)
    cpu_s = time.perf_counter() - t0
    diff = sum(int((moe._assign(cpu, xb.reshape(-1, d), cfg)[3]
                    != moe._assign(p32, xb.reshape(-1, d).to(dev),
                                   cfg)[3].cpu()).sum())
               for xb in x32.cpu().chunk(n))
    err = float((out.cpu() - out_h).abs().max())
    rel = {k: float((g.cpu() - h).abs().max() / h.abs().max())
           for k, g, h in zip(PAR_LEAVES, grads, grads_h)}
    print(f"parallel: ring MoE fp32 n={n}, card vs CPU ({cpu_s:.1f} s on "
          f"the CPU): {diff} slots routed apart, output max abs {err:.3g} "
          f"(tolerance {PAR_TOL}), gradients max abs / largest entry "
          f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} } (tolerance "
          f"{PAR_TOL})", flush=True)
    check(err <= PAR_TOL and all(v <= PAR_TOL for v in rel.values())
          and all(float(h.abs().max()) > 0 for h in grads_h),
          f"ring MoE card vs CPU: output {err}, gradients {rel}")
    del grads, grads_h, out, out_h, cpu

    # ample capacity: no slot drops, so the ring equals moe_apply
    ample = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    worst = 0.0
    for rows_a, toks_a in PAR_AMPLE_X:
        x = torch.randn(rows_a, toks_a, d, generator=gen, device=dev)
        want = moe.moe_apply(p32, x, ample)
        for n in PAR_RANKS:
            check(all(bool(moe._assign(p32, xb.reshape(-1, d), ample)[2]
                           .all()) for xb in x.chunk(n)),
                  f"ring MoE ample n={n}: a slot dropped")
            for coll in ("ring", "xla"):
                got = ring_moe(p32, x, n, coll, ample)
                worst = max(worst, float((got - want).abs().max()))
    print(f"parallel: ring MoE fp32 at ample capacity (factor "
          f"{ample.moe.capacity_factor}) on x {list(PAR_AMPLE_X)} x "
          f"[{d}], n = {list(PAR_RANKS)}, both exchanges, against "
          f"moe_apply: max abs {worst:.3g} (tolerance {PAR_AMPLE_TOL})",
          flush=True)
    check(worst <= PAR_AMPLE_TOL, f"ring MoE ample vs moe_apply: {worst}")


def dp_run(torch, dev, cfg, data, mesh, accum: int, keep_m: bool = False,
           steps: int = PAR_TRAIN_STEPS):
    """``steps`` steps of ``build_train_step`` over ``mesh`` at ``accum``
    microbatches a rank block, from seed 0.  Returns the step (``built``),
    the first step's loss and grad norm (``first``), its peak device
    memory in GiB with the parameters and the optimizer state already
    there (``peak``), the parameters after it (``after``, copies), with
    ``keep_m`` the first moment after it (``m``, copies: Adam's first step
    leaves ``(1 - beta1)`` times the clipped gradient there, else None),
    and the host time of each step (``times``)."""
    from types import SimpleNamespace

    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.convert import param_list
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import init_opt_state

    tcfg = TrainConfig(lr=PAR_LR, warmup_steps=1,
                       total_steps=PAR_TRAIN_STEPS, grad_accum=accum)
    assert tcfg.grad_clip == PAR_CLIP
    built = build_train_step(cfg, ShapeConfig("dp", data.seq, data.batch,
                                              "train"), tcfg, mesh=mesh)
    params = api.init_params(cfg, seed=0, device=dev)
    state = {"params": params,
             "opt": init_opt_state(params, tcfg, master=False)}
    run = SimpleNamespace(built=built, times=[], m=None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = built.fn(state, data.batch_at(i))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        run.times.append(time.perf_counter() - t0)
        check(math.isfinite(loss), f"dp step: loss {loss}")
        if i == 0:
            run.peak = torch.cuda.max_memory_allocated() / 2 ** 30
            run.first = (loss, gnorm)
            run.after = [p.detach().clone() for p in param_list(params)]
            if keep_m:
                run.m = [m.clone() for m in state["opt"].m]
    del state, params
    return run


def leaf_gap(xs, ys, sx: float = 1.0, sy: float = 1.0) -> float:
    """The worst leaf's ``max |sx x - sy y| / max |sy y|``."""
    return max(float((x * sx - y * sy).abs().max() / (y * sy).abs().max())
               for x, y in zip(xs, ys))


def par_dp_train(torch, dev) -> None:
    """(b) of :func:`parallel_phase`."""
    import shutil

    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.convert import reference_leaves
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api
    from repro_torch.optim.optimizer import global_norm
    from repro_torch.parallel import dp_grad_mean

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("cli", TRAIN_SEQ, TRAIN_BATCH, "train")
    built = build_train_step(
        cfg, shape, TrainConfig(grad_accum=1),
        mesh=make_production_mesh(multi_pod=True, device=dev))
    check(built.batch_blocks == 2 and built.batch_specs["tokens"] == ("pod",),
          f"--multi-pod: {built.batch_blocks} blocks, {built.batch_specs}")

    # the train CLI on the (2, 16, 16) mesh: 2 rank blocks over pod
    ckpt_dir = ROOT / "build" / "par_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    state, _, history, out = run_train_cli(
        torch, ["--arch", TRAIN_ARCH, "--device", "cuda", "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--ckpt-dir",
                str(ckpt_dir), "--log-every", "1", "--steps",
                str(PAR_TRAIN_STEPS), "--ckpt-every", str(10 ** 6),
                "--multi-pod"])
    losses = [float(loss) for _, _, loss in history]
    check(f"done at step {PAR_TRAIN_STEPS}; restarts=0" in out
          and all(math.isfinite(x) for x in losses)
          and len(losses) == PAR_TRAIN_STEPS and not ckpt_dir.exists(),
          f"train --multi-pod: {out[-300:]}")
    times = [b[1] - a[1] for a, b in zip(history, history[1:])]
    print(f"parallel: train CLI --multi-pod {TRAIN_ARCH} full width, mesh "
          f"(pod=2, data=16, model=16) over the card, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} in 2 rank blocks over pod: losses "
          f"{[round(x, 4) for x in losses]}, median step (steps "
          f"2-{PAR_TRAIN_STEPS}) {statistics.median(times) * 1e3:.1f} ms",
          flush=True)
    del state
    free_model(torch, "parallel: train CLI")

    # build_train_step over (data=2, model=1) against one rank: the same
    # microbatches (one rank at 2) bit for bit; the whole batch (one rank at
    # 1) by the first step's loss, grad norm and gradient (the first moment),
    # each within a bound set from readings and below what a faulty mean
    # reads (checked once the blocks' gradients are at hand, below)
    data = SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0)
    dp = dp_run(torch, dev, cfg, data,
                make_mesh((2, 1), ("data", "model"), dev), 1, keep_m=True)
    check(dp.built.batch_blocks == 2,
          f"data=2: {dp.built.batch_blocks} blocks")
    dp_first, dp_after, dp_times, dp_peak = (dp.first, dp.after, dp.times,
                                             dp.peak)
    free_model(torch, "parallel: data-parallel step")
    one = make_mesh((1, 1), ("data", "model"), dev)
    two = dp_run(torch, dev, cfg, data, one, 2)
    first2 = two.first
    same = first2 == dp_first and all(torch.equal(a, b)
                                      for a, b in zip(two.after, dp_after))
    del two
    free_model(torch, "parallel: one rank at 2 microbatches")
    whole = dp_run(torch, dev, cfg, data, one, 1, keep_m=True)
    first1, after1, one_times = whole.first, whole.after, whole.times
    dgrad = leaf_gap(dp.m, whole.m)
    del dp, whole
    # Adam's first step moves an element by lr g / (|g| + eps) + lr wd p
    # (the same p in both runs), about lr whatever g is: two gradients move
    # it apart by at most 2 lr, and the two bf16 stores by half an ulp each
    # (an ulp <= |p| / 2**7) more.  So this bound holds for any update,
    # a wrong one too: it does not separate a correct mean from a faulty one
    pdiff, outside, moved, total = 0.0, 0, 0, 0
    for a, b in zip(after1, dp_after):
        gap = (a.float() - b.float()).abs()
        mag = torch.maximum(a.float().abs(), b.float().abs())
        pdiff = max(pdiff, float(gap.max()))
        outside += int((gap > 2 * PAR_LR * (1 + 1e-6) + mag / 2 ** 7).sum())
        moved += int((a != b).sum())
        total += a.numel()
        del gap, mag
    dloss = abs(first1[0] - dp_first[0])
    dnorm = abs(first1[1] - dp_first[1]) / first1[1]
    print(f"parallel: build_train_step {TRAIN_ARCH} full width over (data=2, "
          f"model=1), 2 rank blocks of {TRAIN_BATCH // 2}: first step loss "
          f"{dp_first[0]:.6f}, grad_norm {dp_first[1]:.6f}; one rank at 2 "
          f"microbatches {first2[0]:.6f}, {first2[1]:.6f} (parameters after "
          f"the step {'bit-equal' if same else 'DIFFERENT'}); one rank at 1 "
          f"{first1[0]:.6f}, {first1[1]:.6f}: loss |diff| {dloss:.3g} "
          f"(tolerance {PAR_DP_LOSS_TOL}), grad_norm relative {dnorm:.3g} "
          f"(tolerance {PAR_DP_NORM_TOL}), first-step gradient (first "
          f"moment) worst leaf max |diff| / largest entry {dgrad:.3g} "
          f"(tolerance {PAR_DP_GRAD_TOL}); parameters max |diff| "
          f"{pdiff:.3g}, {moved} of {total} elements apart, {outside} of "
          f"them by more than 2 lr + one bf16 ulp (Adam's first-step bound, "
          f"met by any update, not a check of the mean); median step (steps "
          f"2-{PAR_TRAIN_STEPS}) data=2 "
          f"{statistics.median(dp_times[1:]) * 1e3:.1f} ms, one rank "
          f"{statistics.median(one_times[1:]) * 1e3:.1f} ms; data=2 peak "
          f"memory (first step) {dp_peak:.2f} GiB", flush=True)
    check(same, "data-parallel step differs from one rank at 2 microbatches")
    check(dloss <= PAR_DP_LOSS_TOL and dnorm <= PAR_DP_NORM_TOL
          and dgrad <= PAR_DP_GRAD_TOL and outside == 0,
          f"data-parallel step vs one rank: loss {dloss}, norm {dnorm}, "
          f"gradient {dgrad}, parameters {pdiff}")
    del after1, dp_after
    free_model(torch, "parallel: one rank")

    # 16 rank blocks of one row on the (16, 16) mesh: the step holds one
    # block's gradient beside the running sum, so its peak does not grow
    # with the block count (16 float32 gradient sets would not fit)
    wide = dp_run(torch, dev, cfg, SyntheticLM(cfg, batch=16, seq=TRAIN_SEQ,
                                               seed=0),
                  make_production_mesh(device=dev), 1, steps=1)
    blocks16 = wide.built.batch_blocks
    print(f"parallel: build_train_step {TRAIN_ARCH} full width over (data=16, "
          f"model=16), batch 16 x {TRAIN_SEQ} in {blocks16} rank blocks of "
          f"1: loss {wide.first[0]:.6f}, grad_norm {wide.first[1]:.6f}, step "
          f"{wide.times[0] * 1e3:.1f} ms, peak memory {wide.peak:.2f} GiB "
          f"(data=2 at batch {TRAIN_BATCH}: {dp_peak:.2f} GiB, allowance "
          f"{PAR_PEAK_SLACK} GiB)", flush=True)
    check(blocks16 == 16 and wide.peak <= dp_peak + PAR_PEAK_SLACK,
          f"16 blocks: {blocks16}, peak {wide.peak} GiB")
    del wide
    free_model(torch, "parallel: 16 rank blocks")

    # the two blocks' gradients: what a faulty mean reads against the
    # exact one (the loss mean with block 1 dropped; the gradient mean with
    # block 1 dropped, clipped as the first moment is, or left undivided,
    # whose grad norm reads 1 apart), and the int8 mean against the exact
    params = api.init_params(cfg, seed=0, device=dev)
    batch = on_card(torch, data.batch_at(0), dev)
    half = TRAIN_BATCH // 2
    blocks, block_losses = [], []
    for r in range(2):
        loss, g = loss_and_grads(torch, params, {
            k: v[r * half:(r + 1) * half] for k, v in batch.items()}, cfg)
        block_losses.append(float(loss))
        blocks.append([x.float() for x in g])
        del g
    exact = dp_grad_mean(blocks)
    n0, nm = float(global_norm(blocks[0])), float(global_norm(exact))
    bad_loss = abs(block_losses[0] - block_losses[1]) / 2
    bad_norm = min(abs(n0 - nm) / nm, 1.0)
    bad_grad = leaf_gap(blocks[0], exact, min(1.0, PAR_CLIP / n0),
                        min(1.0, PAR_CLIP / nm))
    print(f"parallel: the (data=2) step's bounds against a faulty mean: "
          f"loss {dloss:.3g} <= {PAR_DP_LOSS_TOL} < {bad_loss:.3g} (block "
          f"losses {block_losses[0]:.6f}, {block_losses[1]:.6f}); grad_norm "
          f"{dnorm:.3g} <= {PAR_DP_NORM_TOL} < {bad_norm:.3g} (block 0 "
          f"{n0:.6f}, mean {nm:.6f}; undivided 1); gradient {dgrad:.3g} <= "
          f"{PAR_DP_GRAD_TOL} < {bad_grad:.3g}", flush=True)
    check(PAR_DP_LOSS_TOL < bad_loss and PAR_DP_NORM_TOL < bad_norm
          and PAR_DP_GRAD_TOL < bad_grad,
          f"a bound does not separate a faulty mean: loss {bad_loss}, norm "
          f"{bad_norm}, gradient {bad_grad}")
    int8 = dp_grad_mean(blocks, "int8")
    none_ms = statistics.median(wall_ms(torch, lambda: dp_grad_mean(blocks))
                                for _ in range(3))
    int8_ms = statistics.median(wall_ms(torch, lambda: dp_grad_mean(
        blocks, "int8")) for _ in range(3))
    rel = [float((a - b).abs().max() / b.abs().max())
           for a, b in zip(int8, exact)]
    paths = [path for path, ts, _ in reference_leaves(params) for _ in ts]
    worst = max(range(len(rel)), key=rel.__getitem__)
    picks = (0, len(rel) // 2, len(rel) - 1)
    cpu_same = all(torch.equal(
        dp_grad_mean([[blocks[0][i].cpu()], [blocks[1][i].cpu()]],
                     "int8")[0].view(torch.int32),
        int8[i].cpu().view(torch.int32)) for i in picks)
    print(f"parallel: dp_grad_mean over the 2 blocks' gradients "
          f"({len(rel)} leaves, {sum(g.numel() for g in exact)} float32): "
          f"int8 against none, max abs / largest entry over leaves "
          f"{max(rel):.4g} at {paths[worst]} (tolerance {PAR_INT8_TOL}); "
          f"int8 on the CPU bit-equal at {[paths[i] for i in picks]}: "
          f"{cpu_same}; none {none_ms:.2f} ms, int8 {int8_ms:.2f} ms",
          flush=True)
    check(max(rel) < PAR_INT8_TOL and cpu_same,
          f"dp_grad_mean int8: relative {max(rel)}, CPU equal {cpu_same}")
    del params, blocks, exact, int8, batch
    free_model(torch, "parallel: gradient means")


def par_pipeline(torch, dev) -> None:
    """(c) of :func:`parallel_phase`."""
    from repro_torch.configs import get_config
    from repro_torch.parallel import (bubble_fraction, pipeline_forward,
                                      pipeline_loss)

    d = get_config(TRAIN_ARCH).d_model
    stages, micro, rows = PAR_PIPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ws = [(torch.randn(d, d, generator=gen, device=dev) * d ** -0.5)
          .requires_grad_(True) for _ in range(stages)]
    xs = torch.randn(micro, rows, d, generator=gen, device=dev)
    tg = torch.randn(micro, rows, d, generator=gen, device=dev)

    def stage(w, x):
        return torch.tanh(x @ w)

    def mse(o, t):
        return torch.mean((o - t) ** 2)

    def sequential(weights):
        h = xs
        for w in weights:
            h = stage(w, h)
        return h

    seq = sequential(ws)
    fwd = float((pipeline_forward(stage, ws, xs) - seq).abs().max().detach())
    g_pipe = torch.autograd.grad(pipeline_loss(stage, mse, ws, xs, tg), ws)
    g_seq = torch.autograd.grad(
        torch.stack([mse(o, t) for o, t in zip(seq, tg)]).mean(), ws)
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(g_pipe, g_seq))
    absd = max(float((a - b).abs().max()) for a, b in zip(g_pipe, g_seq))
    frozen = [w.detach() for w in ws]
    with torch.no_grad():
        piped_ms = time_ms(torch, lambda: pipeline_forward(stage, frozen, xs),
                           reps=10, spin=4 * SPIN_CYCLES)
        seq_ms = time_ms(torch, lambda: sequential(frozen), reps=10,
                         spin=4 * SPIN_CYCLES)
    print(f"parallel: pipeline {stages} stages of tanh(x @ w) at d {d}, "
          f"{micro} microbatches of {rows} rows, fp32 (bubble fraction "
          f"{bubble_fraction(micro, stages):.4f}): forward max abs {fwd:.3g}, "
          f"gradients max abs {absd:.3g}, max abs / largest entry {rel:.3g} "
          f"against the sequential stages (tolerance {PAR_PIPE_TOL}); "
          f"forward pipelined {piped_ms:.4f} ms, sequential {seq_ms:.4f} ms "
          f"on the device", flush=True)
    check(fwd <= PAR_PIPE_TOL and rel <= PAR_PIPE_TOL,
          f"pipeline: forward {fwd}, gradients {rel}")


def parallel_phase(torch, dev) -> None:
    """ROADMAP item 8b on the card, every rank on the one card.  (a) The
    ring MoE on granite-moe-3b-a800m's MoE layer at full width (random
    weights from seed 0) over 1, 2, 4 and 8 ranks: ``ring`` and ``xla``
    bit-equal in bf16 and fp32 on x [8, 448, 1536]; each rank count's
    layer time (host clock) and its exchanges' device time beside
    ``moe_apply``; fp32 output and the four weight leaves' gradients at 8
    ranks against the same call on the CPU; at ample capacity (no slot
    drops; x [8, 1] and [8, 32] tokens) against ``moe_apply``.  (b)
    stablelm-1.6b's data-parallel training at full width, 8 x 64: the
    train CLI with ``--multi-pod`` (2 rank blocks over pod);
    ``build_train_step`` over (data=2, model=1) against one rank at 2
    microbatches (bit for bit) and at 1 (loss, grad norm and first-step
    gradient within bounds below what a faulty mean reads), the steps'
    times; 16 rank blocks on (16, 16) at batch 16, their peak memory; ``dp_grad_mean`` int8 against none over the two
    blocks' gradients, and bit-equal to the CPU on three leaves.  (c) The
    pipeline: 4 stages of ``tanh(x @ w)`` at d 2048, 8 microbatches of 128
    rows, forward and gradients against the sequential stages, timed."""
    t_phase = time.perf_counter()
    par_ring_moe(torch, dev)
    free_model(torch, "parallel: ring MoE")
    par_dp_train(torch, dev)
    par_pipeline(torch, dev)
    free_model(torch, "parallel: pipeline")
    print(f"parallel: phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def tooling_cells(torch) -> None:
    """(a) The dry run on meta: stablelm-1.6b's ``prefill_32k`` and
    ``decode_32k`` cells over the (16, 16) mesh, one line each."""
    from repro_torch.launch import dryrun

    for shape in TOOLING_CELLS:
        rec = dryrun.run_cell(TRAIN_ARCH, shape, False)
        r = rec["roofline"]
        check(rec["status"] == "ok" and rec["parsed"]["flops"] > 0,
              f"dry run {TRAIN_ARCH} {shape}: {rec}")
        print(f"tooling dry run {TRAIN_ARCH} {shape} {rec['mesh']} on meta: "
              f"compute {r['compute_s']:.4e} s, memory {r['memory_s']:.4e} s, "
              f"collective {r['collective_s']:.4e} s, dominant "
              f"{r['dominant']}; model_flops {rec['model_flops']:.4e}, "
              f"census flops {rec['parsed']['flops']:.4e} (useful "
              f"{rec['useful_compute_ratio']:.4f}), bytes "
              f"{rec['parsed']['bytes']:.4e}, peak "
              f"{rec['memory']['peak_bytes']:.4e} B; stand-ins "
              f"{rec['stand_ins']}; run {rec['run_s']} s", flush=True)


def tooling_train(torch, dev, card: str):
    """(b) The census of the train phase's stablelm-1.6b step (8 x 64) on
    the card: its FLOPs against the model's, the step's MFU, and with the
    kernels off the census equal to the same step's on meta (FLOPs
    exactly; bytes, or each op line that differs named).  Returns the
    census (kernels on)."""
    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import analyze_step, model_flops
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api
    from repro_torch.optim import init_opt_state

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = TrainConfig(lr=1e-4, warmup_steps=1, total_steps=100,
                       grad_accum=1)
    built = build_train_step(cfg, shape, tcfg)
    params = api.init_params(cfg, seed=0, device=dev)
    state = {"params": params,
             "opt": init_opt_state(params, tcfg, master=False)}
    data = SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    times = []
    for i in range(TOOLING_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = built.fn(state, data.batch_at(i))
        float(metrics["loss"])
        times.append(time.perf_counter() - t0)
    med = statistics.median(times[1:])
    _, on = analyze_step(built.fn, state, data.batch_at(0))
    ops.use_kernels(False)
    try:
        _, off = analyze_step(built.fn, state, data.batch_at(0))
        _, meta = analyze_step(built.fn, *dryrun.step_inputs(
            built, cfg, shape, "meta"))
    finally:
        ops.use_kernels(True)
    del state, params
    free_model(torch, "tooling train")
    mf = model_flops(cfg, shape)
    check(on.flops == off.flops == meta.flops,
          f"tooling train: census flops on the card {on.flops} (kernels "
          f"off {off.flops}) != on meta {meta.flops}")
    apart = sorted((line for line in set(off.lines) | set(meta.lines)
                    if off.lines.get(line, [0, 0])[1]
                    != meta.lines.get(line, [0, 0])[1]))
    print(f"tooling train {TRAIN_ARCH} {TRAIN_BATCH} x {TRAIN_SEQ} on the "
          f"card: census flops {on.flops} = {on.flops / mf:.4f} x "
          f"model_flops {mf:.6e}; bytes {on.bytes}, peak live "
          f"{on.peak_bytes} B, {sum(on.op_counts.values())} ops; median "
          f"step (steps 2-{TOOLING_STEPS}) {med * 1e3:.1f} ms, MFU "
          f"{mf / (med * PEAK_FLOPS_BF16):.5f} of {PEAK_FLOPS_BF16:.4g} "
          f"flop/s ({card})", flush=True)
    print(f"tooling train kernels off, card vs meta: flops {off.flops} == "
          f"{meta.flops}; bytes {off.bytes} vs {meta.bytes} "
          f"({'equal' if off.bytes == meta.bytes else 'differ'}); "
          f"stand-ins on meta {meta.stand_ins}; op lines apart: "
          f"{len(apart)}", flush=True)
    for line in apart[:20]:
        print(f"tooling train line apart: {line[:120]}: card "
              f"{off.lines.get(line, [0, 0])[1]} B, meta "
              f"{meta.lines.get(line, [0, 0])[1]} B", flush=True)
    return on


def tooling_engine(torch, dev, rows) -> None:
    """(c) The census of one fused decode step of the stablelm-1.6b engine
    (4 x (448 + 64), every page mapped) with the kernels on: kernels 1-2
    appear as ops, as many as the launch counts of the step, and each
    launch's bytes are those of the path's row of the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import launch as kl
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.models import api
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("stablelm-1.6b")
    params = api.init_params(cfg, seed=0, device=dev)
    prompts = SyntheticLM(cfg, batch=ENGINE_SLOTS, seq=STABLELM_PROMPT,
                          seed=0).batch_at(0)["tokens"]
    eng = ServingEngine(cfg, params, max_slots=ENGINE_SLOTS,
                        t_max=STABLELM_PROMPT + 64, fused_gather=True)
    for i in range(ENGINE_SLOTS):
        eng.submit(Request(i, prompts[i], max_new_tokens=64))
    for _ in range(3):                       # admission, then every page
        eng.step()
    torch.cuda.synchronize()
    kl.reset_launch_counts()
    _, costs = analyze_step(eng.step)
    torch.cuda.synchronize()
    counts = kl.launch_counts()
    del eng, params
    free_model(torch, "tooling engine")
    by_row = rows["stablelm-1.6b engine"]
    for name in ("gather_burst_network_tiles", "scatter_burst_network_tiles"):
        calls = costs.op_counts.get(name, 0)
        lines = [rec for rec in costs.lines.values() if rec[0] == name]
        per = {rec[1] // rec[4] for rec in lines}
        check(calls == counts[name] == 2,
              f"tooling engine: {name} {calls} ops in the census, "
              f"{counts[name]} launches")
        check(per == {by_row[name]["bytes"]},
              f"tooling engine: {name} {per} bytes a launch, the kernels "
              f"line's row {by_row[name]['bytes']}")
        print(f"tooling engine stablelm-1.6b decode step: {name} {calls} "
              f"ops = {counts[name]} launches, {per.pop()} bytes each = the "
              f"kernels line's row", flush=True)
    print(f"tooling engine step: flops {costs.flops}, bytes {costs.bytes}, "
          f"{sum(costs.op_counts.values())} ops; launches "
          f"{dict((k, v) for k, v in counts.items() if v)}", flush=True)


def tooling_phase(torch, dev, rows, card: str) -> None:
    """ROADMAP item 10b on the card: (a) :func:`tooling_cells`, (b)
    :func:`tooling_train`, (c) :func:`tooling_engine`, (d)
    ``profile.breakdown``'s top 10 op lines of (b)'s step, (e) the profile
    CLI on the card at a cut decode shape."""
    from repro_torch.launch import profile

    t_phase = time.perf_counter()
    tooling_cells(torch)
    train = tooling_train(torch, dev, card)
    tooling_engine(torch, dev, rows)
    ranked, totals = profile.breakdown(train)
    check(totals == {"bytes": train.bytes, "flops": train.flops,
                     "collective_bytes": train.collective_bytes},
          f"breakdown totals {totals} are not the census's")
    for c in ranked[:10]:
        print(f"tooling breakdown {TRAIN_ARCH} train: {c.bytes:.4e} B "
              f"({100 * c.bytes / totals['bytes']:.2f} %), {c.flops:.4e} "
              f"flop, {train.lines[c.line][4]} calls: {c.line[:100]}",
              flush=True)
    profile.main(["--arch", TRAIN_ARCH, "--shape", "decode_32k", "--batch",
                  str(ENGINE_SLOTS), "--seq", "2048", "--device", "cuda",
                  "--top", "5"])
    free_model(torch, "tooling profile CLI")
    print(f"tooling: phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def card_vs_cpu(torch, dev):
    """The smoke configs in float32, the same parameters on both devices:
    first-step logits within 1e-4 (engine step; gemma3 also one-shot);
    then the oversubscribed churn (:func:`churn_card_vs_cpu`)."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import SyntheticLM
    from repro_torch.models import api
    from repro_torch.serving import Request, ServingEngine

    for arch in ("stablelm-1.6b", "gemma3-4b", MOE_ARCH):
        small = dataclasses.replace(get_smoke(arch), dtype="float32")
        p_cpu = api.init_params(small, seed=1, device="cpu")
        p_gpu = api.init_params(small, seed=1, device="cpu").to(dev)
        sp = SyntheticLM(small, batch=3, seq=10, seed=1).batch_at(0)["tokens"]
        firsts, engs, reqs = {}, {}, {}
        for name, p in (("cpu", p_cpu), ("gpu", p_gpu)):
            e = ServingEngine(small, p, max_slots=3, t_max=18)
            reqs[name] = [Request(i, sp[i], max_new_tokens=6)
                          for i in range(3)]
            for r in reqs[name]:
                e.submit(r)
            e.step()
            engs[name] = e
            if arch == "gemma3-4b":
                seen = []
                api.greedy_generate(
                    p, torch.as_tensor(sp, device=p.embed["table"].device),
                    small, steps=3, t_max=15,
                    on_step=lambda i, lg: seen.append(lg.cpu()))
                firsts[name] = seen[0]
        pairs = [("engine", engs["gpu"].last_logits.cpu(),
                  engs["cpu"].last_logits)]
        if firsts:
            pairs.append(("one-shot", firsts["gpu"], firsts["cpu"]))
        for what, a, c in pairs:
            err = float((a - c).abs().max())
            check(torch.allclose(a, c, atol=1e-4, rtol=1e-4),
                  f"{arch} {what}: card vs CPU logits differ by {err}")
            print(f"smoke {arch} float32 {what} card vs CPU: first-step "
                  f"logits max abs diff {err:.2e} (tolerance 1e-4)",
                  flush=True)
        for e in engs.values():
            e.run_to_completion()
        check(all(r is None for r in engs["gpu"].active),
              f"{arch} smoke not drained")
        if arch == MOE_ARCH:
            # MoE: routing decides the movement, so tokens and every
            # counter (tokens_dropped included) must be exact
            a, c = (dataclasses.asdict(engs[k].fabric_stats)
                    for k in ("gpu", "cpu"))
            check([r.generated for r in reqs["gpu"]]
                  == [r.generated for r in reqs["cpu"]],
                  f"{arch}: card and CPU tokens differ")
            check(a == c, f"{arch}: card and CPU SchedulerStats differ: "
                  f"{a} vs {c}")
            print(f"smoke {arch} float32 engine card vs CPU: tokens and all "
                  f"SchedulerStats fields equal ({a['tokens_dropped']} "
                  f"assignments dropped)", flush=True)
    churn_card_vs_cpu(torch, dev)


def ptxas_report(build, names=("stream_matmul", "burst_network",
                                "gather_burst", "scatter_burst",
                                "medusa_transpose")) -> None:
    """Each kernel's registers and spills, from the ``-Xptxas -v`` log that
    the build leaves beside the library of each source in ``names``."""
    import re

    for name in names:
        kernel = None
        for line in Path(str(build._lib_path(name)) + ".log").read_text() \
                .splitlines():
            entry = re.search(r"Compiling entry function '_Z\w*?\d+"
                              r"((?:matmul|burst|gather|scatter|transpose)"
                              r"\w*?kernel)(\w*)'", line)
            if entry:
                kernel = entry.group(1) + (
                    f" [{entry.group(2)}]" if entry.group(2) else "")
                spills = "spills not reported"
            elif "spill" in line and kernel:
                spills = line.strip()
            elif "registers" in line and kernel:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"ptxas {name}: {kernel[:70]}: {regs} registers; "
                      f"{spills}", flush=True)
                kernel = None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the stablelm engine's and the "
                         "gemma3 one-shot decode steps")
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
    ptxas_report(build)

    rows = kernels_phase(torch, dev)
    rows.update(interconnect_phase(torch, dev))
    stablelm_phase(torch, dev, rows, args.profile)
    gemma_phase(torch, dev, rows, args.profile)
    starcoder2_phase(torch, dev, rows)
    gemma3_12b_phase(torch, dev, rows)
    fsdp_phase(torch, dev, rows)
    preempt_phase(torch, dev, rows)
    moe_phase(torch, dev, rows)
    families_phase(torch, dev, rows)
    train_phase(torch, dev, rows, args.profile)
    whisper_phase(torch, dev, rows, args.profile)
    loadgen_phase(torch, dev, rows)
    read_sim_phase(torch, dev)
    sharded_phase(torch, dev, rows)
    parallel_phase(torch, dev)
    tooling_phase(torch, dev, rows, card)
    card_vs_cpu(torch, dev)

    # one entry per kernel and path: its launches on that path's runs, its
    # times and bound at that path's shapes
    line = []
    for path, by_kernel in rows.items():
        for name, r in by_kernel.items():
            source, replaces = KERNELS[name]
            check(r.get("launches", 0) > 0,
                  f"{name} never launched on the {path} path")
            line.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": r["launches"],
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"],
                         "library_ms": r["library_ms"],
                         "path": path, "shape": r["shape"],
                         **{key: r[key] for key in (
                             "matmul_route", "leaves", "ms_read_flush",
                             "library_ms_read_flush", "host_us_per_call",
                             "copy_ms", "copy_ms_read_flush", "single_ms",
                             "single_ms_read_flush", "one_leaf_ms",
                             "host_us_one_leaf", "host_us_single",
                             "host_us_one_leaf_behind")
                             if key in r}})
    check({e["name"] for e in line} == set(KERNELS),
          "the kernels line misses a kernel")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
