"""The port's cost census (``repro_torch.launch.hlo_analysis``) against the
reference's HLO parse (``repro.launch.hlo_analysis``).

``model_flops`` and ``roofline_terms`` are the reference's arithmetic,
exact.  The census reads the aten ops a step dispatches where the
reference parses compiled HLO: a Python loop of products counts what the
reference's trip-count-corrected scan counts, and the smoke steps' FLOPs
(prefill, decode, loss with gradients; kernels off on both sides, as the
reference's dry run lowers) equal the reference's ``analyze_hlo`` of the
same jitted functions, up to one residual named in ROADMAP §3 and pinned
here: under its default burst payload the reference's MoE backward drops
the expert FFN's six backward products a MoE layer (its gradient is cut
there, ROADMAP §3), which the route payload keeps.  The byte model is
held on hand-built cases, the kernels' cost function at PERF.md §6's
shapes, and every smoke step runs on ``meta`` with the census answering
meta's value reads, its FLOPs and bytes those of the same step on the CPU
wherever no stand-in answered a ``nonzero``.
"""

import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import hlo_analysis as jha  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, ShapeConfig,  # noqa: E402
                                 get_config, get_smoke)
from repro_torch.convert import param_list, params_from_jax  # noqa: E402
from repro_torch.kernels import launch as kl  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis as ha  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402

SMOKE_SHAPES = {"train": ShapeConfig("t", 16, 4, "train"),
                "prefill": ShapeConfig("p", 16, 2, "prefill"),
                "decode": ShapeConfig("d", 32, 2, "decode")}


@pytest.fixture(autouse=True)
def _one_thread_kernels_and_stats():
    """One thread; both kernel switches and both packages' ambient MoE
    stats sinks as they were, after every test."""
    torch.set_num_threads(1)
    was, twas = jops.kernels_enabled(), tops.kernels_enabled()
    jstats, tstats = jmoe._DISPATCH_STATS, moe._DISPATCH_STATS
    try:
        yield
    finally:
        jops.use_kernels(was)
        tops.use_kernels(twas)
        jmoe._DISPATCH_STATS, moe._DISPATCH_STATS = jstats, tstats


# ---------------------------------------------------------------------------
# the reference's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_matches_reference(arch, shape):
    assert ha.model_flops(get_config(arch), SHAPES[shape]) == \
        jha.model_flops(jget_config(arch), JSHAPES[shape])


def test_roofline_terms_match_reference():
    """The same costs at the reference's constants give the reference's
    terms, and each term can dominate; the defaults are the H100's."""
    consts = dict(peak_flops=jmesh.PEAK_FLOPS_BF16, hbm_bw=jmesh.HBM_BW,
                  link_bw=jmesh.ICI_BW)
    for flops, nbytes, coll, dominant in (
            (197e12, 819e9 * 2, 50e9 / 2, "memory"),
            (197e12 * 3, 819e9, 50e9, "compute"),
            (1e9, 1e9, 50e9 * 4, "collective"),
            (0, 0, 0, "compute")):
        got = ha.roofline_terms(ha.HloCosts(flops=flops, bytes=nbytes,
                                            collective_bytes=coll), 1,
                                **consts)
        want = jha.roofline_terms(jha.HloCosts(flops=flops, bytes=nbytes,
                                               collective_bytes=coll), 1,
                                  **consts)
        assert got == want and got["dominant"] == dominant
    h100 = ha.roofline_terms(ha.HloCosts(flops=989.4e12, bytes=3.35e12 * 2,
                                         collective_bytes=450e9 / 2), 1)
    assert (h100["compute_s"], h100["memory_s"], h100["collective_s"]) == \
        (1.0, 2.0, 0.5)
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.LINK_BW) == \
        (989.4e12, 3.35e12, 450e9)


# ---------------------------------------------------------------------------
# loops: dispatched once per trip
# ---------------------------------------------------------------------------

def _ref_scan_flops(n: int, trips) -> float:
    """The reference's ``analyze_hlo`` of nested scans of an ``[n, n]``
    product (``trips`` outermost first)."""
    w = jnp.ones((n, n))

    def nest(x, depth=0):
        if depth == len(trips):
            return x @ w
        y, _ = jax.lax.scan(lambda c, _: (nest(c, depth + 1), None), x,
                            None, length=trips[depth])
        return y

    txt = jax.jit(nest).lower(jnp.ones((n, n))).compile().as_text()
    return jha.analyze_hlo(txt).flops


@pytest.mark.parametrize("n,trips", [(128, (8,)), (64, (5, 3))])
def test_loops_count_as_the_references_scans(n, trips):
    w = torch.ones(n, n)

    def nest(x, depth=0):
        if depth == len(trips):
            return x @ w
        for _ in range(trips[depth]):
            x = nest(x, depth + 1)
        return x

    _, costs = ha.analyze_step(nest, torch.ones(n, n))
    want = 2 * n ** 3 * int(np.prod(trips))
    assert costs.flops == want == _ref_scan_flops(n, trips)
    assert costs.op_counts == {"aten.mm.default": int(np.prod(trips))}


# ---------------------------------------------------------------------------
# the byte model
# ---------------------------------------------------------------------------

def _charged(fn, *args) -> int:
    return ha.analyze_step(fn, *args)[1].bytes


def test_byte_model_hand_cases():
    x = torch.zeros(8, 128)                       # 4096 bytes
    idx = torch.tensor([1, 3], dtype=torch.long)
    upd = torch.ones(2, 128)                      # 1024 bytes
    assert _charged(lambda t: t.view(-1).t().transpose(0, 0), x) == 0
    assert _charged(lambda t: t.index_select(0, idx), x) == 2 * 1024
    assert _charged(lambda t: t.index_copy_(0, idx, upd), x) == 2 * 1024
    assert _charged(lambda t: t[2:4].copy_(upd), x) == 2 * 1024
    assert _charged(lambda t: t + 1.0, x) == 4096 + 4096
    assert _charged(lambda t: t * t, x) == 3 * 4096
    assert _charged(lambda t: t.add_(1.0), x) == 2 * 4096
    # a broadcast operand counts once; an allocation and a fill
    row = torch.ones(128)
    assert _charged(lambda t: t + row.expand(8, 128), x) == 2 * 4096 + 512
    assert _charged(lambda t: torch.zeros_like(t), x) == 0
    assert _charged(lambda t: t.zero_(), x) == 4096
    # a copy to the host moves no HBM byte; .item() neither
    assert _charged(lambda t: t.to("meta"), x) == 0
    assert _charged(lambda t: t[0, 0].item(), x) == 0


def test_a_collective_charges_max_operand_result():
    """The port's collectives report the reference's HLO ops over every
    rank, their payload max(operand, result) bytes: an all-to-all of four
    ranks' [4, 8] float32 send buffers, a ring of S-1 rotations, an
    all-reduce (its result every rank's), the int8 mean's scale maximum."""
    blocks = [torch.full((4, 8), float(r)) for r in range(4)]
    _, costs = ha.analyze_step(collectives.xla_all_to_all, blocks)
    assert dict(costs.collective_census) == {"all-to-all": [1, 4 * 128]}
    assert costs.collective_bytes == 512 and costs.op_counts["all-to-all"] == 1
    _, costs = ha.analyze_step(collectives.ring_all_to_all, blocks)
    assert dict(costs.collective_census) == {
        "collective-permute": [3, 3 * 4 * 32]}
    grads = [[torch.ones(6)], [torch.ones(6)]]
    _, costs = ha.analyze_step(collectives.dp_grad_mean, grads, "int8")
    assert dict(costs.collective_census) == {
        "all-reduce": [2, 2 * 4 + 2 * 6 * 4]}
    _, costs = ha.analyze_step(collectives.ring_all_gather, blocks[:2])
    assert dict(costs.collective_census) == {"collective-permute": [1, 256]}


def test_peak_counts_arguments_and_live_storages_once():
    x = torch.zeros(256)                          # 1 KiB, live throughout

    def step(t):
        a = t + 1                                 # 1 KiB
        b = a.view(16, 16)                        # the same storage
        c = b * 2                                 # +1 KiB: 3 live
        del a, b
        return c.sum()                            # a freed: 2 KiB + 4 B

    _, costs = ha.analyze_step(step, x)
    assert costs.peak_bytes == 3 * 1024


# ---------------------------------------------------------------------------
# the kernels' cost function at PERF.md §6's shapes
# ---------------------------------------------------------------------------

def _engine_idx(arch: str, prompt: int, gen: int, slots: int = 4):
    """The live plan of a decode step past the prompt, every page mapped,
    tiled over the full-attention layers (``chip_smoke.py``'s
    ``burst_rows``)."""
    cfg = get_config(arch)
    n, ps = cfg.resolved_fabric.n_ports, cfg.resolved_fabric.page_size
    reps = cfg.layer_types().count("A")
    t_alloc = -(-(prompt + gen) // n) * n
    per_slot = -(-t_alloc // ps)
    frames = slots * per_slot * ps
    table = np.arange(slots * per_slot, dtype=np.int32).reshape(slots, -1)
    live, _, _ = cm.page_live_plan(table, ps, t_alloc, n, bucket=n * ps)
    idx = cm.pool_rep_indices(torch.from_numpy(live), reps, frames)
    return idx, reps * frames, n, cfg.resolved_head_dim // 2


def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch,prompt,gen,want", [
    ("stablelm-1.6b", 448, 64, 402_849_792),
    ("gemma3-4b", 1536, 64, 131_200_000)])
def test_kernel_cost_sparse_bursts_at_perf_shapes(arch, prompt, gen, want):
    idx, lines, n, w = _engine_idx(arch, prompt, gen)
    k = idx.shape[0]
    got = kl.kernel_cost("gather_burst_network_tiles",
                         lines=_meta(lines, n, w), idx=idx,
                         out=_meta(k // n, n, n, w))
    assert got == (want, 0)
    got = kl.kernel_cost("scatter_burst_network_tiles",
                         banked=_meta(k // n, n, n, w), idx=idx,
                         into=_meta(lines, n, w))
    assert got == (want, 0)


def test_kernel_cost_counts_only_live_frames():
    """The traffic harness's decode step (PERF.md §6): 30,720 live frames
    and 18,432 sentinels; a gather writes every output frame, zeros at a
    sentinel; a scatter neither reads nor writes a sentinel frame."""
    idx = torch.cat([torch.arange(30720, dtype=torch.int32),
                     torch.full((18432,), 2 ** 30, dtype=torch.int32)])
    lines = _meta(30720, 32, 32)
    assert kl.kernel_cost("gather_burst_network_tiles", lines=lines,
                          idx=idx, out=_meta(1536, 32, 32, 32)) == \
        (327_352_320, 0)
    assert kl.kernel_cost("scatter_burst_network_tiles",
                          banked=_meta(1536, 32, 32, 32), idx=idx,
                          into=lines) == (251_854_848, 0)


def test_kernel_cost_dense_kernels_at_perf_shapes():
    bf16 = torch.bfloat16
    assert kl.kernel_cost("medusa_transpose_tiles", leaves=[
        _meta(4, 1024, 4, 256, dtype=bf16)] * 2) == (33_554_432, 0)
    assert kl.kernel_cost("medusa_transpose_tiles", leaves=[
        _meta(4, 1600, 4, 256, dtype=bf16)] * 2) == (52_428_800, 0)
    assert kl.kernel_cost("medusa_transpose_tiles", leaves=[
        _meta(2, 1500, 16, 64, dtype=bf16)] * 48) == (589_824_000, 0)
    assert kl.kernel_cost("burst_network_tiles",
                          tile=_meta(32, 32, 98304)) == (805_306_368, 0)
    lines = _meta(49152, 32, 64, dtype=bf16)
    assert kl.kernel_cost("read_network_tiles", lines=lines) == \
        (402_653_184, 0)
    assert kl.kernel_cost("barrel_rotate_groups", x=lines,
                          amounts=_meta(49152)) == (402_849_792, 0)
    x, w = _meta(6144, 2560, dtype=bf16), _meta(2560, 10240, dtype=bf16)
    nbytes, flops = kl.kernel_cost("stream_matmul", x=x, w=w,
                                   out=_meta(6144, 10240, dtype=bf16))
    assert flops == 322_122_547_200
    assert nbytes == (6144 * 2560 + 2560 * 10240 + 6144 * 10240) * 2
    assert kl.kernel_cost("stream_matmul", x=_meta(4, 2560, dtype=bf16),
                          w=w, out=_meta(4, 10240, dtype=bf16))[0] == \
        52_531_200


def test_a_kernel_report_reaches_the_census():
    """A wrapper's report (its launch through ctypes) is an op of the
    kernel's name, priced by ``kernel_cost``; nothing is heard outside a
    census."""
    lines = torch.zeros(64, 4, 8, dtype=torch.int32)
    idx = torch.tensor([0, 5, 2 ** 30, 7], dtype=torch.int32)
    out = torch.zeros(1, 4, 4, 8, dtype=torch.int32)

    def step():
        kl.report("gather_burst_network_tiles", lines=lines, idx=idx, out=out)
        kl.report("gather_burst_network_tiles", lines=lines, idx=idx, out=out)

    kl.report("gather_burst_network_tiles", lines=lines, idx=idx, out=out)
    _, costs = ha.analyze_step(step)
    assert costs.op_counts == {"gather_burst_network_tiles": 2}
    assert costs.bytes == 2 * (3 * 128 + 16 + 512) and costs.flops == 0


# ---------------------------------------------------------------------------
# the smoke steps against the reference's analyze_hlo
# ---------------------------------------------------------------------------

def _moe_backward_residual(cfg) -> int:
    """The six backward products of the expert FFN a MoE layer (the
    gradients of w_gate, w_up, w_out and of their inputs), each ``2·E·C·
    d_model·d_ff``, at the smoke's 2 x 16 tokens."""
    m = cfg.moe
    cap = int(2 * 16 * m.top_k * m.capacity_factor / m.n_experts) or 1
    return cfg.n_layers * 6 * 2 * m.n_experts * cap * cfg.d_model * m.expert_d_ff


def _ref_flops(fn, *args) -> float:
    return jha.analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


@pytest.mark.parametrize("kind", ["prefill", "decode", "loss_grad"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-moe-3b-a800m"])
def test_census_flops_match_reference_on_smoke_steps(arch, kind):
    jops.use_kernels(False)
    tops.use_kernels(False)
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    tokens = np.arange(32, dtype=np.int32).reshape(2, 16) % 50
    if kind == "prefill":
        want = _ref_flops(lambda p, b: japi.prefill_fn(p, b, jcfg, 32),
                          jparams, {"tokens": jnp.asarray(tokens)})
        _, costs = ha.analyze_step(api.prefill_fn, tparams,
                                   {"tokens": torch.from_numpy(tokens)}, cfg,
                                   32)
    elif kind == "decode":
        want = _ref_flops(
            lambda p, t, c, pos: japi.decode_fn(p, t, c, pos, jcfg),
            jparams, jnp.full((2, 1), 3, jnp.int32),
            japi.init_cache(jcfg, 2, 32), jnp.int32(16))
        _, costs = ha.analyze_step(
            api.decode_fn, tparams, torch.full((2, 1), 3, dtype=torch.int32),
            api.init_cache(cfg, 2, 32, device="cpu"), 16, cfg)
    else:
        batch = {"tokens": tokens, "targets": tokens}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def ref_grads(payload):
            with mock.patch.object(jlm, "moe_apply", functools.partial(
                    jmoe.moe_apply, payload=payload)):
                return _ref_flops(lambda p, b: jax.value_and_grad(
                    japi.loss_fn)(p, b, jcfg), jparams, jbatch)
        ps = param_list(tparams)
        for p in ps:
            p.requires_grad_(True)

        def loss_grads(params, b):
            return torch.autograd.grad(api.loss_fn(params, b, cfg), ps)
        _, costs = ha.analyze_step(
            loss_grads, tparams, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        want = ref_grads("burst")
        if cfg.moe is not None:
            assert costs.flops == ref_grads("route")
            assert costs.flops - want == _moe_backward_residual(cfg) > 0
            return
    assert costs.flops == want > 0


# ---------------------------------------------------------------------------
# meta against the CPU: every smoke config's three steps
# ---------------------------------------------------------------------------

def _smoke_step_costs(arch: str, kind: str, device: str):
    cfg = get_smoke(arch)
    shape = SMOKE_SHAPES[kind]
    built = build_step(cfg, shape, mesh.make_mesh((1, 1), ("data", "model"),
                                                  device="meta"))
    args = dryrun.step_inputs(built, cfg, shape, device)
    tops.use_kernels(False)
    return ha.analyze_step(built.fn, *args)[1]


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_meta_step_matches_cpu(arch, kind):
    """The step runs on meta (status ok); where no stand-in answered a
    ``nonzero`` its FLOPs and bytes equal a CPU run's, and where one did
    (the MoE dispatch's kept rows) the upper bound charges no fewer
    bytes."""
    on_meta = _smoke_step_costs(arch, kind, "meta")
    on_cpu = _smoke_step_costs(arch, kind, "cpu")
    assert on_meta.flops > 0 and on_cpu.stand_ins == 0
    assert on_meta.flops == on_cpu.flops
    if "aten.nonzero.default" in on_meta.op_counts:
        assert get_smoke(arch).moe is not None
        assert on_meta.bytes >= on_cpu.bytes
    else:
        assert on_meta.bytes == on_cpu.bytes
