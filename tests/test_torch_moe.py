"""The MoE family against the reference: the granite-moe-3b-a800m and
kimi-k2-1t-a32b configs, the burst dispatch (scatter, kernel 2's path) and
combine (gather, kernel 1's path), ``moe_apply``, the load-balance loss,
the decode paths, ``serve_fsdp``, the engine and the serve CLI.

The full configs are checked as dataclasses and through their parameter
counts only; nothing is allocated at full width.  Everything else runs the
smoke configs or a 16-wide toy, in float32, with the reference's
parameters carried across and inputs drawn from a numpy seed.  Movement is
exact: the dispatch pool and the combine's frames bit for bit, the router's
decisions (``top_e``, ``keep``, ``slot``), ``tokens_dropped`` and the burst
counters.  Compute is held within 1e-5 (one MoE layer), 1e-6 (the
auxiliary loss) or 1e-4 (logits and caches after a decode step).

Counters: the reference scans the ``unit`` layers, so its MoE bursts count
once per trace of the scan body while its ``tokens_dropped`` debug
callback fires once per layer; the port counts every executed dispatch.
So after a decode step the port's MoE burst counters are ``reps`` times the
reference's and ``tokens_dropped`` is equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.configs.base import FabricConfig as JFabricConfig  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.fabric import BurstScheduler as JScheduler  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric import SchedulerStats as JStats  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import (FabricConfig, ModelConfig,  # noqa: E402
                                 MoEConfig, get_config, get_smoke)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fabric import (FRAME_SENTINEL, BurstScheduler,  # noqa: E402
                                Fabric, SchedulerStats)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import moe  # noqa: E402

from tests import torch_serving_pairs as sp  # noqa: E402

ARCHS = ("granite-moe-3b-a800m", "kimi-k2-1t-a32b")
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread_and_globals():
    """One thread; both kernel switches on, and back as they were; both
    packages' dispatch sinks empty before and after."""
    torch.set_num_threads(1)
    was, twas = jops.kernels_enabled(), tops.kernels_enabled()
    jops.use_kernels(True)
    tops.use_kernels(True)
    try:
        yield
    finally:
        jops.use_kernels(was)
        tops.use_kernels(twas)
        assert jmoe._DISPATCH_STATS is None
        assert moe._DISPATCH_STATS is None and moe._PENDING == []


def _toy(cf=0.75, pad_to=0, pack="packed", fold="auto"):
    """The reference suite's toy MoE layer (``tests/test_moe_fabric.py``):
    d 16 over N=2 ports, 4 experts top-2, on both packages."""
    base = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=0, vocab_size=64)
    moe_kw = dict(n_experts=4, top_k=2, expert_d_ff=32, capacity_factor=cf,
                  pad_to=pad_to)
    fab = dict(n_ports=2, lane_width=8, pack=pack, word_fold=fold)
    return (JModelConfig(**base, moe=JMoEConfig(**moe_kw),
                         fabric=JFabricConfig(**fab)),
            ModelConfig(**base, moe=MoEConfig(**moe_kw),
                        fabric=FabricConfig(**fab)))


def _toy_params(jcfg, seed=0):
    p = jmoe.moe_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.itemsize])


def _stats(s) -> dict:
    return dataclasses.asdict(s)


# ----------------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_match_field_for_field(arch, size):
    get, jget = ((get_config, jget_config) if size == "full"
                 else (get_smoke, jget_smoke))
    tcfg, jcfg = get(arch), jget(arch)
    for f in dataclasses.fields(tcfg):
        if f.name in ("ssm", "rglru", "fabric"):
            continue
        if f.name == "moe":
            assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(
                jcfg.moe)
            assert tcfg.moe.n_experts_padded == jcfg.moe.n_experts_padded
            continue
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert dataclasses.asdict(tcfg.resolved_fabric) == dataclasses.asdict(
        jcfg.resolved_fabric)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


def test_moe_params_shapes_and_dtypes():
    """The router is float32 in a bf16 model; the experts are stacked over
    the padded expert axis — as the reference's ``moe_params``."""
    jcfg, tcfg = _toy(pad_to=6)
    want = jax.eval_shape(lambda: jmoe.moe_params(jax.random.PRNGKey(0),
                                                  jcfg, jnp.bfloat16))
    got = moe.moe_params(tcfg, torch.bfloat16, torch.Generator(), "cpu")
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[1] == want[name].dtype.name, name


# ----------------------------------------------------------------------------
# dispatch (the scatter burst) and combine (the gather burst)
# ----------------------------------------------------------------------------

def _assignments(t, k, e, cap, seed):
    """Random top-k assignments of ``t`` tokens, ranked within their
    expert in order (the stable sort), ``keep`` at rank < ``cap``."""
    rng = np.random.default_rng(seed)
    a = np.stack([rng.permutation(e)[:k] for _ in range(t)]).reshape(-1)
    rank = np.zeros_like(a)
    seen = {}
    for i, x in enumerate(a):
        rank[i] = seen.get(int(x), 0)
        seen[int(x)] = rank[i] + 1
    keep = rank < cap
    slot = np.where(keep, a * cap + rank, e * cap)
    tok = np.arange(t * k) // k
    return tok, keep, slot


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("fold", [1, 2, "auto"])
@pytest.mark.parametrize("pack", ["packed", "pad"])
def test_dispatch_and_combine_bit_equal_to_reference(pack, fold, kernels):
    """``_burst_dispatch`` and ``_burst_combine`` on the same ``(xt, tok,
    keep, slot)``: the expert slot pool and the gathered frames bit for
    bit, and every ``SchedulerStats`` field, across the pack x fold matrix
    with both packages' kernels on and off (the reference's Pallas kernels
    in interpret mode, the port's plain versions).  15 tokens x top-2 = 30
    assignments (a multiple of N) plus one more token pads the stream to a
    sentinel row; capacity 5 drops some."""
    jcfg, tcfg = _toy(pack=pack, fold=fold)
    jops.use_kernels(kernels)
    tops.use_kernels(kernels)
    t, k, e, cap, d = 15, 2, 4, 5, 16
    tok, keep, slot = _assignments(t, k, e, cap, seed=1)
    assert (~keep).any() and (slot >= 0).all()
    xt = _x((t, d))
    y = _x((e * cap, d), seed=4)
    jfab, tfab = JFabric(jcfg.resolved_fabric), Fabric(tcfg.resolved_fabric)
    jst, tst = JStats(), SchedulerStats()
    jbuf = jmoe._burst_dispatch(jfab, jnp.asarray(xt), jnp.asarray(tok),
                                jnp.asarray(keep), jnp.asarray(slot),
                                e * cap, jst)
    tbuf = moe._burst_dispatch(tfab, torch.from_numpy(xt),
                               torch.from_numpy(tok), torch.from_numpy(keep),
                               torch.from_numpy(slot), e * cap, tst)
    np.testing.assert_array_equal(_bits(tbuf), _bits(jbuf))
    jg = jmoe._burst_combine(jfab, jnp.asarray(y), jnp.asarray(keep),
                             jnp.asarray(slot), jst)
    tg = moe._burst_combine(tfab, torch.from_numpy(y),
                            torch.from_numpy(keep), torch.from_numpy(slot),
                            tst)
    np.testing.assert_array_equal(_bits(tg), _bits(jg))
    assert _stats(tst) == _stats(jst)
    assert tst.streams_served == 2 and tst.words_live > 0
    # the dispatch is exactly the kept assignments' rows at their slots
    want = np.zeros((e * cap, d), np.float32)
    want[slot[keep]] = xt[tok[keep]]
    np.testing.assert_array_equal(_bits(tbuf), _bits(want))
    np.testing.assert_array_equal(
        _bits(tg), _bits(np.where(keep[:, None],
                                  y[np.minimum(slot, e * cap - 1)], 0)))


# ----------------------------------------------------------------------------
# moe_apply
# ----------------------------------------------------------------------------

def _reference_run(monkeypatch, p, x, jcfg, **kw):
    """The reference's ``moe_apply`` with its router decisions captured:
    ``top_e`` from ``jax.lax.top_k``, ``keep`` and ``slot`` from the
    dispatch's arguments (a route payload recomputes them through one
    burst call that is discarded)."""
    seen = {}
    top_k, dispatch = jax.lax.top_k, jmoe._burst_dispatch

    def top_k_spy(probs, k):
        out = top_k(probs, k)
        seen.setdefault("top_e", np.asarray(out[1]))
        return out

    def dispatch_spy(fabric, xt, tok, keep, slot, ec, stats):
        seen["keep"], seen["slot"] = np.asarray(keep), np.asarray(slot)
        return dispatch(fabric, xt, tok, keep, slot, ec, stats)
    monkeypatch.setattr(jax.lax, "top_k", top_k_spy)
    monkeypatch.setattr(jmoe, "_burst_dispatch", dispatch_spy)
    stats = JStats()
    out = jmoe.moe_apply(p, jnp.asarray(x), jcfg, stats=stats, **kw)
    monkeypatch.undo()
    return np.asarray(out), stats, seen


@pytest.mark.parametrize("case", ["drops", "ample", "pad_to", "ties"])
def test_moe_apply_matches_reference(case, monkeypatch):
    """``moe_apply`` against the reference's on the same parameters and
    input: the router's ``top_e``, ``keep`` and ``slot`` exactly, the output
    within 1e-5, every ``SchedulerStats`` field (burst counters and
    ``tokens_dropped``) equal; in the port ``payload="burst"`` is bit-equal
    to ``"route"``.  Cases: a capacity that drops; an ample one; the expert
    axis padded with dead experts; a zero router (every probability equal:
    ``top_e`` must be the reference's lowest-index-first order)."""
    cf = {"drops": 0.75, "ample": 4.0, "pad_to": 0.75, "ties": 0.75}[case]
    jcfg, tcfg = _toy(cf=cf, pad_to=6 if case == "pad_to" else 0)
    p, tp = _toy_params(jcfg)
    if case == "ties":
        p = dict(p, router=jnp.zeros_like(p["router"]))
        tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x((2, 16, 16))
    jout, jst, seen = _reference_run(monkeypatch, p, x, jcfg)
    tst = SchedulerStats()
    tout = moe.moe_apply(tp, torch.from_numpy(x), tcfg, stats=tst)
    _, top_e, keep, slot, cap = moe._assign(
        tp, torch.from_numpy(x).reshape(-1, 16), tcfg)
    np.testing.assert_array_equal(top_e.numpy(), seen["top_e"])
    np.testing.assert_array_equal(keep.numpy(), seen["keep"])
    np.testing.assert_array_equal(slot.numpy(), seen["slot"])
    np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5, rtol=1e-5)
    assert _stats(tst) == _stats(jst)
    assert (tst.tokens_dropped > 0) == (case != "ample")
    assert tst.tokens_dropped == int((~keep).sum())
    if case == "ties":
        assert (top_e.numpy() == [0, 1]).all()
    route = moe.moe_apply(tp, torch.from_numpy(x), tcfg, payload="route")
    np.testing.assert_array_equal(_bits(route), _bits(tout))


def test_default_payload_follows_the_fabric():
    """The burst payload on a banking fabric with ``d % N == 0``; the route
    on the ``fused`` fabric (no burst counted) — as the reference's."""
    jcfg, tcfg = _toy()
    p, tp = _toy_params(jcfg)
    x = _x((2, 16, 16))
    for fused in (False, True):
        tc, jc = tcfg, jcfg
        if fused:
            tc = dataclasses.replace(tcfg, fabric=dataclasses.replace(
                tcfg.fabric, impl="fused"))
            jc = dataclasses.replace(jcfg, fabric=dataclasses.replace(
                jcfg.fabric, impl="fused"))
        jst, tst = JStats(), SchedulerStats()
        jout = jmoe.moe_apply(p, jnp.asarray(x), jc, stats=jst)
        tout = moe.moe_apply(tp, torch.from_numpy(x), tc, stats=tst)
        assert _stats(tst) == _stats(jst)
        assert tst.streams_served == (0 if fused else 2)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cf,pad_to", [(0.75, 0), (0.1, 6), (4.0, 0)])
def test_no_negative_index_reaches_a_burst(cf, pad_to, monkeypatch):
    """Every index either burst receives is a slot in ``[0, E_pad*C)`` or
    ``FRAME_SENTINEL``: dropped assignments and the pad rows carry the
    sentinel, never a negative index (ROADMAP §3)."""
    _, tcfg = _toy(cf=cf, pad_to=pad_to)
    jcfg, _ = _toy(cf=cf, pad_to=pad_to)
    _, tp = _toy_params(jcfg)
    seen = []
    write, read = BurstScheduler.enqueue_write, BurstScheduler.enqueue_read

    def write_spy(self, name, banked, scatter=None, into=None):
        seen.append((scatter, into.shape[0]))
        return write(self, name, banked, scatter=scatter, into=into)

    def read_spy(self, name, lines, gather=None):
        seen.append((gather, lines.shape[0]))
        return read(self, name, lines, gather=gather)
    monkeypatch.setattr(BurstScheduler, "enqueue_write", write_spy)
    monkeypatch.setattr(BurstScheduler, "enqueue_read", read_spy)
    moe.moe_apply(tp, torch.from_numpy(_x((3, 5, 16))), tcfg)
    assert len(seen) == 2
    for idx, rows in seen:
        live = idx[idx != FRAME_SENTINEL]
        assert idx.dtype == torch.int32 and (idx >= 0).all()
        assert (live < rows).all()
        assert live.unique().numel() == live.numel()
    # dropped assignments are sentinels (15 x 2 = 30 rows need no pad)
    assert bool((seen[0][0] == FRAME_SENTINEL).any()) == (cf < 1)


def test_aux_load_balance_loss_matches_reference():
    """Within 1e-6 of the reference's: on random tokens, and on the
    reference suite's crafted batch (every argmax expert 0, second choices
    split), where only the all-top-k form gives 4 * (.5, .25, .25, 0)."""
    jcfg, tcfg = _toy()
    p, tp = _toy_params(jcfg)
    x = _x((2, 16, 16))
    cases = [(p, tp, x)]
    router = np.zeros((16, 4), np.float32)
    router[:4, :4] = np.eye(4)
    rows = [10 * np.eye(16)[0] + 9 * np.eye(16)[1 + i % 2] for i in range(8)]
    crafted = np.stack(rows)[None].astype(np.float32)
    cases.append(({"router": jnp.asarray(router)},
                  {"router": torch.from_numpy(router)}, crafted))
    for jp, tp_, xx in cases:
        want = float(jmoe.aux_load_balance_loss(jp, jnp.asarray(xx), jcfg))
        got = float(moe.aux_load_balance_loss(tp_, torch.from_numpy(xx),
                                              tcfg))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_dispatch_stats_defers_the_drop_count():
    """Inside the sink the drop count stays a device value until the block
    exits, then lands once; nested sinks restore the outer one; an
    explicit ``stats`` gets its count at once."""
    jcfg, tcfg = _toy()
    _, tp = _toy_params(jcfg)
    x = torch.from_numpy(_x((2, 16, 16)))
    outer, inner, explicit = (SchedulerStats() for _ in range(3))
    with moe.dispatch_stats(outer):
        moe.moe_apply(tp, x, tcfg)
        assert outer.tokens_dropped == 0 and len(moe._PENDING) == 1
        with moe.dispatch_stats(inner):
            moe.moe_apply(tp, x, tcfg)
        drops = inner.tokens_dropped
        assert drops > 0 and moe._DISPATCH_STATS is outer
        moe.moe_apply(tp, x, tcfg, stats=explicit)
        assert explicit.tokens_dropped == drops
    assert outer.tokens_dropped == drops
    assert outer.streams_served == inner.streams_served == 2


# ----------------------------------------------------------------------------
# the decode paths
# ----------------------------------------------------------------------------

def _pair(arch, **over):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32", **over)
    tcfg = dataclasses.replace(get_smoke(arch), dtype="float32", **over)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _decode_both(arch, path, **over):
    """One decode step of ``arch``'s smoke on ``path`` on both packages,
    inside each package's dispatch sink: ``scheduled`` (the fused-gather
    step over a churned page table), ``paged`` (the per-layer paged decode
    on a fabric off the port-per-KV-head geometry), ``layers`` (the
    per-layer decode over dense caches from a prefill).  Returns the
    logits, the K/V leaves, the step's scheduler stats and the MoE sink's
    stats of each side, the written-frame mask and ``reps``."""
    if path == "paged":
        base = get_smoke(arch)
        fab = dict(n_ports=base.n_kv_heads * base.resolved_head_dim // 8,
                   lane_width=8)
        jcfg, tcfg, jparams, tparams = _pair(arch)
        jcfg = dataclasses.replace(jcfg, fabric=JFabricConfig(**fab))
        tcfg = dataclasses.replace(tcfg, fabric=FabricConfig(**fab))
    else:
        jcfg, tcfg, jparams, tparams = _pair(arch, **over)
    reps = tcfg.n_layers
    rng = np.random.default_rng(4)
    hd, n = tcfg.resolved_head_dim, tcfg.resolved_fabric.n_ports
    out = {}
    if path == "layers":
        toks = rng.integers(0, tcfg.vocab_size, (2, 9), dtype=np.int32)
        _, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks[:, :8])},
                                jcfg, 12)
        _, tc = api.prefill_fn(tparams, {"tokens": torch.from_numpy(
            toks[:, :8])}, tcfg, 12)
        for side, (fn, params, cfg, caches, tok, stats, sink, sched) in {
                "jax": (japi.decode_fn, jparams, jcfg, jc,
                        jnp.asarray(toks[:, 8:]), JStats(), jmoe, None),
                "torch": (api.decode_fn, tparams, tcfg, tc,
                          torch.from_numpy(toks[:, 8:]), SchedulerStats(),
                          moe, None)}.items():
            with sink.dispatch_stats(stats):
                logits, caches = fn(params, tok, caches, 8, cfg)
            out[side] = (logits, caches["unit"][0], None, stats)
        return out, None, reps
    ps, n_pages, t_depth = 4, 8, 16
    table = np.full((2, 4), -1, np.int32)
    table[0, :2] = [3, 5]
    table[1, :3] = [0, 6, 2]
    pos = np.array([6, 10], np.int32)
    pools = {name: rng.standard_normal(
        (reps, n_pages, ps, tcfg.n_kv_heads, hd)).astype(np.float32)
        for name in ("k", "v")}
    token = rng.integers(0, tcfg.vocab_size, (2, 1), dtype=np.int32)
    live = (cm.page_live_plan(table, ps, t_depth, n, bucket=n * ps)
            if path == "scheduled" else None)
    jstats, jsink = JStats(), JStats()
    with jmoe.dispatch_stats(jsink):
        jl, jc = japi.decode_fn(
            jparams, jnp.asarray(token),
            {"unit": [{k: jnp.asarray(v) for k, v in pools.items()}],
             "tail": []}, jnp.asarray(pos), jcfg,
            sched=JScheduler(JFabric(jcfg.resolved_fabric), stats=jstats),
            page_table=jnp.asarray(table), page_size=ps, t_depth=t_depth,
            live_plan=None if live is None else tuple(
                jnp.asarray(a) for a in live))
    jax.effects_barrier()
    tstats, tsink = SchedulerStats(), SchedulerStats()
    with moe.dispatch_stats(tsink):
        tl, tc = api.decode_fn(
            tparams, torch.from_numpy(token),
            {"unit": [{k: torch.from_numpy(v.copy())
                       for k, v in pools.items()}], "tail": []},
            torch.from_numpy(pos), tcfg,
            sched=BurstScheduler(Fabric(tcfg.resolved_fabric), stats=tstats),
            page_table=torch.from_numpy(table), page_size=ps,
            t_depth=t_depth, live_plan=None if live is None else tuple(
                torch.from_numpy(a) for a in live))
    out["jax"] = (jl, jc["unit"][0], jstats, jsink)
    out["torch"] = (tl, tc["unit"][0], tstats, tsink)
    mask = np.ones(pools["k"].shape[:3], bool)
    for r in range(reps):
        for s in (0, 1):
            mask[r, table[s, pos[s] // ps], pos[s] % ps] = False
    out["pools"] = pools
    return out, mask, reps


@pytest.mark.parametrize("path", ["scheduled", "paged", "layers"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, path):
    """granite and kimi smoke, one decode step on each decode path (both
    packages' kernels on: the reference's Pallas kernels in interpret mode,
    the port's plain versions): logits within 1e-4; the pool frames the
    step did not write bit-equal (and untouched), the new K/V within 1e-4;
    the KV bursts' counters field for field; the MoE sink's
    ``tokens_dropped`` equal and non-zero (capacity 1 at two tokens), its
    burst counters ``reps`` times the reference's (one count per layer
    against one per traced scan body)."""
    out, mask, reps = _decode_both(arch, path)
    jl, jc, jstats, jsink = out["jax"]
    tl, tc, tstats, tsink = out["torch"]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        got, want = tc[name].numpy(), np.asarray(jc[name])
        if mask is None:
            np.testing.assert_allclose(got, want, **TOL)
            continue
        np.testing.assert_array_equal(_bits(got)[mask], _bits(want)[mask])
        np.testing.assert_array_equal(_bits(got)[mask],
                                      _bits(out["pools"][name])[mask])
        np.testing.assert_allclose(got[~mask], want[~mask], **TOL)
    if jstats is not None:
        assert _stats(tstats) == _stats(jstats)
    assert tsink.tokens_dropped == jsink.tokens_dropped > 0
    js, ts = _stats(jsink), _stats(tsink)
    del js["tokens_dropped"], ts["tokens_dropped"]
    assert ts == {k: reps * v for k, v in js.items()}
    assert tsink.streams_served == 2 * reps


def test_serve_fsdp_step_matches_reference():
    """granite smoke's fused-gather step with ``serve_fsdp``: the float32
    router rides the weight stream beside the experts (one stream per
    reference leaf); logits within 1e-4, every ``SchedulerStats`` field of
    the step's bursts equal, the MoE sink as in the plain step."""
    out, mask, reps = _decode_both("granite-moe-3b-a800m", "scheduled",
                                   serve_fsdp=True)
    jl, jc, jstats, jsink = out["jax"]
    tl, tc, tstats, tsink = out["torch"]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert _stats(tstats) == _stats(jstats)
    assert tstats.streams_served > 4            # weights + K/V in and out
    assert tsink.tokens_dropped == jsink.tokens_dropped
    for name in ("k", "v"):
        np.testing.assert_array_equal(_bits(tc[name].numpy())[mask],
                                      _bits(np.asarray(jc[name]))[mask])


def test_bf16_model_carries_the_float32_router():
    """``params_from_jax`` on the bf16 granite smoke: the router stays
    float32 (its dtype check passes), the experts are bf16 bit for bit."""
    jcfg, tcfg = jget_smoke(ARCHS[0]), get_smoke(ARCHS[0])
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    ffn = tparams.unit[0][1].ffn
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_gate"].dtype == torch.bfloat16
    src = jparams["unit"][0]["ffn"]
    np.testing.assert_array_equal(
        ffn["w_out"].view(torch.int16).numpy(),
        np.asarray(src["w_out"])[1].view(np.int16))
    np.testing.assert_array_equal(ffn["router"].numpy(),
                                  np.asarray(src["router"])[1])


# ----------------------------------------------------------------------------
# the engine and the CLI
# ----------------------------------------------------------------------------

def test_engine_matches_reference_in_lockstep(monkeypatch):
    """granite smoke through both engines step for step (the first three
    requests of the reference's churn trace on the default pool: two
    slots, so the third waits for a retirement): the same
    states after every step, equal token streams (the reference never on a
    near-tie) and equal ``tokens_dropped`` — counted over the decode steps
    only, as admission's prefill runs outside the sink on both sides."""
    jops.use_kernels(False)
    jeng, teng, jreqs, treqs, _, margins = sp.lockstep(
        sp.pair(ARCHS[0]), sp.SPEC[:3], monkeypatch)
    jax.effects_barrier()
    assert min(margins) > 1e-3, margins
    for jr, tr in zip(jreqs, treqs):
        assert tr.generated == jr.generated, tr.rid
    assert (teng.fabric_stats.tokens_dropped
            == jeng.fabric_stats.tokens_dropped > 0)


def test_serve_cli_moe(capsys):
    """The CLI on granite smoke (engine, printing the MoE dispatch census)
    and kimi smoke (one-shot); kimi's full config is refused."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCHS[0], "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "10", "--gen-len", "3", "--engine"])
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out
    assert "moe dispatch: " in out and "dropped at capacity" in out
    serve.main(["--arch", ARCHS[1], "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "10", "--gen-len", "3"])
    assert "generated (2, 3)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCHS[1], "--device", "cpu"])
