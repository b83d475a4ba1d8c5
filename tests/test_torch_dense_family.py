"""The rest of the dense family against the reference: the starcoder2-15b
and gemma3-12b configs, the per-layer paged decode (the ``fused`` fabric
and a fabric off the port-per-KV-head geometry), the pad-to-widest burst
layout, ``serve_fsdp`` weight streaming, the dense per-slot KV layout and
the per-leaf splice admission.

Each port path is held against the same reference path (never against
bit-identity between two paths, which the reference itself fails), on the
smoke configs in float32 with the reference's parameters carried across by
``params_from_jax`` and inputs drawn from a numpy seed.  Movement is exact:
burst outputs, pool bytes the step did not write, page tables and every
``SchedulerStats`` field compare bit for bit.  Compute is held within
``atol = rtol = 1e-4`` (logits, the new token's K/V, dense caches).  Token
streams are compared exactly after checking the reference never sits on a
near-tie (top-1/top-2 margin above 1e-3).
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
from repro.fabric import BurstScheduler as JScheduler  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric import SchedulerStats as JStats  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import FabricConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fabric import (FRAME_SENTINEL, BurstScheduler,  # noqa: E402
                                Fabric, SchedulerStats)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT_LENS = (5, 11, 3, 9)
GEN_LENS = (4, 3, 5, 2)


@pytest.fixture(autouse=True)
def _one_thread_and_kernels():
    torch.set_num_threads(1)
    was, twas = jops.kernels_enabled(), tops.kernels_enabled()
    jops.use_kernels(True)
    tops.use_kernels(True)
    yield
    jops.use_kernels(was)
    tops.use_kernels(twas)


def _pair(arch, **over):
    """The reference's smoke config (float32) and parameters, and the
    port's with the same parameters."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32", **over)
    tcfg = dataclasses.replace(get_smoke(arch), dtype="float32", **over)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def starcoder():
    return _pair("starcoder2-15b")


def _margin(logits) -> float:
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.itemsize])


# ----------------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["starcoder2-15b", "gemma3-12b"])
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_match_field_for_field(arch, size):
    get, jget = ((get_config, jget_config) if size == "full"
                 else (get_smoke, jget_smoke))
    tcfg, jcfg = get(arch), jget(arch)
    for f in dataclasses.fields(tcfg):
        if f.name in ("moe", "ssm", "rglru", "fabric"):
            continue
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert dataclasses.asdict(tcfg.resolved_fabric) == dataclasses.asdict(
        jcfg.resolved_fabric)
    assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", ["starcoder2-15b", "gemma3-12b"])
def test_params_carried_across_prefill_and_decode(arch):
    """``params_from_jax`` carries each new arch's parameters (starcoder2's
    ``gelu`` MLP without a gate and ``ln`` with bias; gemma3-12b's
    ``geglu``, ``rms`` and ring layers): prefill logits and two per-layer
    decode steps' logits within 1e-4 of the reference's, at a prompt
    longer than gemma3's window of 8."""
    jcfg, tcfg, jparams, tparams = _pair(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks[:, :10])},
                             jcfg, 16)
    tl, tc = api.prefill_fn(tparams, {"tokens": torch.from_numpy(
        toks[:, :10])}, tcfg, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for p in (10, 11):
        jl, jc = japi.decode_fn(jparams, jnp.asarray(toks[:, p:p + 1]), jc,
                                p, jcfg)
        tl, tc = api.decode_fn(tparams, torch.from_numpy(toks[:, p:p + 1]),
                               tc, p, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


# ----------------------------------------------------------------------------
# the per-layer paged decode
# ----------------------------------------------------------------------------

def _fabric_over(cfg, why):
    """The reference's own two constructions of a fabric that cannot bank
    the KV leaves (``tests/test_serving_engine.py``): one port per 8 head
    elements (off the port-per-KV-head geometry), or the ``fused`` impl."""
    if why == "fused":
        return dict(kv_layout="fused")
    return dict(fabric=FabricConfig(
        n_ports=cfg.n_kv_heads * cfg.resolved_head_dim // 8, lane_width=8))


@pytest.mark.parametrize("why", ["geometry", "fused"])
def test_paged_fallback_matches_reference(why):
    """A scheduled decode step whose fabric cannot bank the leaves takes
    the per-layer paged decode on both sides (the scheduler never flushes):
    each pool gathers to its dense line-major view, the per-layer path runs
    (kernel 4's plain version against the Pallas kernel in interpret mode
    off the geometry, line-major attention on the fused fabric), and the
    updated frames scatter back.  A churned table: slot 2 retired, pages
    out of order."""
    base = get_smoke("starcoder2-15b")
    over = _fabric_over(base, why)
    if "fabric" in over:
        jover = dict(fabric=JFabricConfig(**dataclasses.asdict(
            over["fabric"])))
    else:
        jover = over
    jcfg, _, jparams, _ = _pair("starcoder2-15b", **jover)
    tcfg = dataclasses.replace(get_smoke("starcoder2-15b"), dtype="float32",
                               **over)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(3)
    ps, n_pages, t_depth, hd = 4, 8, 16, tcfg.resolved_head_dim
    table = np.full((3, 4), -1, np.int32)
    table[0, :2] = [3, 5]
    table[1, :3] = [0, 6, 2]
    pos = np.array([6, 10, 0], np.int32)
    pools = {name: rng.standard_normal(
        (2, n_pages, ps, tcfg.n_kv_heads, hd)).astype(np.float32)
        for name in ("k", "v")}
    token = rng.integers(0, tcfg.vocab_size, (3, 1), dtype=np.int32)

    jstats = JStats()
    jl, jc = japi.decode_fn(
        jparams, jnp.asarray(token),
        {"unit": [{k: jnp.asarray(v) for k, v in pools.items()}],
         "tail": []},
        jnp.asarray(pos), jcfg,
        sched=JScheduler(JFabric(jcfg.resolved_fabric), stats=jstats),
        page_table=jnp.asarray(table), page_size=ps, t_depth=t_depth)
    tstats = SchedulerStats()
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    tl, tc = api.decode_fn(
        tparams, torch.from_numpy(token), {"unit": [tpools], "tail": []},
        torch.from_numpy(pos), tcfg,
        sched=BurstScheduler(Fabric(tcfg.resolved_fabric), stats=tstats),
        page_table=torch.from_numpy(table), page_size=ps, t_depth=t_depth)

    assert jstats.flushes == tstats.flushes == 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the frames this step writes: each live slot's new token, every layer
    mask = np.ones(pools["k"].shape[:3], bool)
    for r in range(2):
        for s in (0, 1, 2):
            page = table[s, pos[s] // ps]
            if page >= 0:
                mask[r, page, pos[s] % ps] = False
    for name in ("k", "v"):
        got, want = tc["unit"][0][name], np.asarray(jc["unit"][0][name])
        assert got.data_ptr() == tpools[name].data_ptr()   # in place
        np.testing.assert_array_equal(_bits(got)[mask], _bits(want)[mask])
        np.testing.assert_array_equal(_bits(got)[mask],
                                      _bits(pools[name])[mask])
        np.testing.assert_allclose(got.numpy()[~mask], want[~mask], **TOL)


# ----------------------------------------------------------------------------
# the pad-to-widest burst layout
# ----------------------------------------------------------------------------

N = 4


def _pad_streams(rng):
    """Reads and writes of several widths (so the narrower ones pad), two
    dtypes, and sparse gather/scatter streams with sentinels."""
    def pair(shape, dtype):
        a = rng.standard_normal(shape).astype(np.float32)
        j = jnp.asarray(a)
        t = torch.from_numpy(a.copy())
        if dtype == "bfloat16":
            return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
        return j, t

    out = []
    for name, shape, dt in (("r/a", (2 * N, N, 8), "bfloat16"),
                            ("r/b", (N, N, 2, 3), "bfloat16"),
                            ("r/c", (3 * N, N, 4), "float32"),
                            ("r/d", (N, N, 5), "float32")):
        j, t = pair(shape, dt)
        out.append(("read", name, (j,), {}, (t,), {}))
    j, t = pair((5 * N, N, 6), "bfloat16")
    idx = np.array([7, FRAME_SENTINEL, 0, 19, 3, 5, 20, 11], np.int32)
    out.append(("read", "r/gather", (j,), dict(gather=jnp.asarray(idx)),
                (t,), dict(gather=torch.from_numpy(idx))))
    for name, shape, dt in (("w/a", (1, N, N, 8), "bfloat16"),
                            ("w/b", (2, N, N, 2), "bfloat16"),
                            ("w/c", (1, N, N, 7), "float32")):
        j, t = pair(shape, dt)
        out.append(("write", name, (j,), {}, (t,), {}))
    jb, tb = pair((2, N, N, 6), "bfloat16")
    ji, ti = pair((4 * N, N, 6), "bfloat16")
    idx = np.array([2, 9, FRAME_SENTINEL, 14, 0, 5, 7, 16], np.int32)
    out.append(("write", "w/scatter", (jb,),
                dict(scatter=jnp.asarray(idx), into=ji), (tb,),
                dict(scatter=torch.from_numpy(idx), into=ti.clone())))
    return out


@pytest.mark.parametrize("impl,kernels,fold", [
    ("oracle", False, "auto"), ("oracle", False, 1),
    ("medusa", False, 2), ("medusa", True, "auto"), ("medusa", True, 1),
    ("medusa", True, 2)])
def test_pad_layout_matches_reference(impl, kernels, fold):
    """``pack="pad"``: the same enqueue sequence through both schedulers;
    every output bit-equal and every ``SchedulerStats`` field equal,
    ``words_padded`` included.  On the kernelized medusa fabric the padded
    burst is one dense burst tile (kernel 3's plain version here)."""
    jops.use_kernels(kernels)
    tops.use_kernels(kernels)
    streams = _pad_streams(np.random.default_rng(11))
    jsched = JScheduler(JFabric.make(N, impl, lane_width=8, pack="pad"),
                        word_fold=fold)
    tsched = BurstScheduler(
        Fabric(FabricConfig(n_ports=N, impl=impl, lane_width=8,
                            pack="pad")), word_fold=fold)
    assert jsched.pack == tsched.pack == "pad"
    for method, name, jargs, jkw, targs, tkw in streams:
        js = getattr(jsched, f"enqueue_{method}")(name, *jargs, **jkw)
        ts = getattr(tsched, f"enqueue_{method}")(name, *targs, **tkw)
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    jout, tout = jsched.flush(), tsched.flush()
    assert sorted(jout) == sorted(tout)
    for name in jout:
        assert tuple(jout[name].shape) == tuple(tout[name].shape), name
        np.testing.assert_array_equal(_bits(tout[name].float()),
                                      _bits(jnp.asarray(jout[name],
                                                        jnp.float32)),
                                      err_msg=name)
        assert tout[name].dtype == getattr(torch, str(jout[name].dtype))
    assert dataclasses.asdict(tsched.stats) == dataclasses.asdict(
        jsched.stats)
    assert tsched.stats.words_padded > 0


# ----------------------------------------------------------------------------
# serve_fsdp weight streaming
# ----------------------------------------------------------------------------

def test_serve_fsdp_step_matches_reference():
    """One fused-gather scheduled decode step of the stablelm smoke with
    ``serve_fsdp``: the weights ride the read burst (one stream per
    reference leaf, the ``unit`` leaves stacked over their repetitions)
    and the step computes with what comes back.  Logits within 1e-4, the
    pools' unwritten frames bit-equal, the new K/V within 1e-4, and every
    ``SchedulerStats`` field equal — so the port streams the same groups
    of bytes under the same names."""
    jcfg, tcfg, jparams, tparams = _pair("stablelm-1.6b", serve_fsdp=True)
    rng = np.random.default_rng(4)
    ps, n_pages, t_depth, hd = 4, 8, 16, tcfg.resolved_head_dim
    n = tcfg.resolved_fabric.n_ports
    table = np.full((2, 4), -1, np.int32)
    table[0, :2] = [3, 5]
    table[1, :3] = [0, 6, 2]
    pos = np.array([6, 10], np.int32)
    pools = {name: rng.standard_normal(
        (2, n_pages, ps, tcfg.n_kv_heads, hd)).astype(np.float32)
        for name in ("k", "v")}
    token = rng.integers(0, tcfg.vocab_size, (2, 1), dtype=np.int32)
    live = cm.page_live_plan(table, ps, t_depth, n, bucket=n * ps)

    def run(side):
        if side == "jax":
            stats = JStats()
            logits, caches = japi.decode_fn(
                jparams, jnp.asarray(token),
                {"unit": [{k: jnp.asarray(v) for k, v in pools.items()}],
                 "tail": []}, jnp.asarray(pos), jcfg,
                sched=JScheduler(JFabric(jcfg.resolved_fabric), stats=stats),
                page_table=jnp.asarray(table), page_size=ps, t_depth=t_depth,
                live_plan=tuple(jnp.asarray(a) for a in live))
            return np.asarray(logits), {k: np.asarray(v) for k, v in
                                        caches["unit"][0].items()}, stats
        stats = SchedulerStats()
        logits, caches = api.decode_fn(
            tparams, torch.from_numpy(token),
            {"unit": [{k: torch.from_numpy(v.copy())
                       for k, v in pools.items()}], "tail": []},
            torch.from_numpy(pos), tcfg,
            sched=BurstScheduler(Fabric(tcfg.resolved_fabric), stats=stats),
            page_table=torch.from_numpy(table), page_size=ps,
            t_depth=t_depth, live_plan=tuple(torch.from_numpy(a)
                                             for a in live))
        return logits.numpy(), {k: v.numpy() for k, v in
                                caches["unit"][0].items()}, stats

    jl, jc, jstats = run("jax")
    tl, tc, tstats = run("torch")
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    leaves = len(jax.tree_util.tree_leaves(jparams))
    assert tstats.streams_served == leaves + 2 + 2   # weights + K/V in, out
    np.testing.assert_allclose(tl, jl, **TOL)
    mask = np.ones(pools["k"].shape[:3], bool)
    for r in range(2):
        for s in (0, 1):
            mask[r, table[s, pos[s] // ps], pos[s] % ps] = False
    for name in ("k", "v"):
        np.testing.assert_array_equal(_bits(tc[name])[mask],
                                      _bits(jc[name])[mask])
        np.testing.assert_allclose(tc[name][~mask], jc[name][~mask], **TOL)
    # the step computes with the weights that came back through the burst:
    # the same step without the stream gives the same logits
    plain = dataclasses.replace(tcfg, serve_fsdp=False)
    pl, _ = api.decode_fn(
        tparams, torch.from_numpy(token),
        {"unit": [{k: torch.from_numpy(v.copy()) for k, v in pools.items()}],
         "tail": []}, torch.from_numpy(pos), plain,
        sched=BurstScheduler(Fabric(plain.resolved_fabric)),
        page_table=torch.from_numpy(table), page_size=ps, t_depth=t_depth,
        live_plan=tuple(torch.from_numpy(a) for a in live))
    np.testing.assert_array_equal(_bits(pl), _bits(tl))


def test_weight_stream_round_trip_is_what_the_step_uses(monkeypatch):
    """The rebuilt weights are the burst's output, not the resident
    tensors: corrupt the weight burst and the step's logits change."""
    from repro_torch.models import lm
    _, tcfg, _, tparams = _pair("stablelm-1.6b", serve_fsdp=True)
    real = lm._rebuild_weight_stream

    def corrupted(params, moved, streamed):
        moved = {k: (v * 0 if k.startswith("weight_stream/") else v)
                 for k, v in moved.items()}
        return real(params, moved, streamed)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 6), dtype=np.int32))
    _, caches = api.prefill_fn(tparams, {"tokens": toks[:, :5]}, tcfg, 8)

    def step():
        logits, _ = api.decode_fn(
            tparams, toks[:, 5:], {k: [dict(e) for e in caches[k]]
                                   for k in caches}, 5, tcfg,
            sched=BurstScheduler(Fabric(tcfg.resolved_fabric)))
        return logits
    good = step()
    monkeypatch.setattr(lm, "_rebuild_weight_stream", corrupted)
    assert not torch.equal(step(), good)


# ----------------------------------------------------------------------------
# the engine in lockstep with the reference's
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["fused_gather", "dense", "splice",
                                  "fused_fabric"])
def test_engine_matches_reference_in_lockstep(starcoder, path, monkeypatch):
    """starcoder2 smoke, two slots over four requests (slots retire and
    refill) on both engines, step for step: the fused-gather default, the
    dense per-slot layout (``paged_pool=False``), the per-leaf splice
    admission (``prefill_burst=False``) and the ``fused`` fabric (paged,
    decoded through the per-layer paged path, admitted by splice).  Page
    tables equal after every step (dense caches within 1e-4 instead),
    token streams equal, prefill bursts and splices equal."""
    jcfg, tcfg, jparams, tparams = starcoder
    jops.use_kernels(False)
    kw = dict(max_slots=2, t_max=20, page_size=4, check_pool=True)
    if path == "dense":
        kw["paged_pool"] = False
    elif path == "splice":
        kw["prefill_burst"] = False
    elif path == "fused_fabric":
        jcfg = dataclasses.replace(jcfg, kv_layout="fused")
        tcfg = dataclasses.replace(tcfg, kv_layout="fused")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,), dtype=np.int32)
               for n in PROMPT_LENS]
    jeng = JEngine(jcfg, jparams, **kw)
    teng = ServingEngine(tcfg, tparams, **kw)
    assert teng.paged == jeng.paged == (path != "dense")
    assert teng.fused == jeng.fused == (path in ("fused_gather", "splice"))
    jreqs = [JRequest(i, p, max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GEN_LENS))]
    treqs = [Request(i, p, max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GEN_LENS))]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    margins = []
    prefill = japi.prefill_fn

    def prefill_recording(*args, **kwargs):
        logits, caches = prefill(*args, **kwargs)
        margins.append(_margin(logits[:, -1]))
        return logits, caches
    monkeypatch.setattr(japi, "prefill_fn", prefill_recording)
    freed = []
    free = jeng.kv.free
    jeng.kv.free = lambda slot: (freed.append(slot), free(slot))[1]
    steps = 0
    while not jeng.drained:
        freed.clear()
        assert jeng.step() == teng.step()
        np.testing.assert_array_equal(teng.pos, jeng.pos)
        if jeng.paged:
            np.testing.assert_array_equal(teng.kv.pool.table,
                                          jeng.kv.pool.table)
        else:
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    teng.kv.caches["unit"][0][name].numpy(),
                    np.asarray(jeng.kv.caches["unit"][0][name]), **TOL)
        rows = sorted(set(freed) | {s for s in range(2)
                                    if jeng.active[s] is not None})
        if rows:
            margins.append(_margin(np.asarray(jeng.last_logits)[rows]))
        steps += 1
        assert steps < 64
    assert len(margins) > len(prompts) and min(margins) > 1e-3, margins
    assert teng.drained
    for jr, tr in zip(jreqs, treqs):
        assert jr.done and tr.done
        assert tr.generated == jr.generated, tr.rid
    assert teng.kv.prefill_bursts == jeng.kv.prefill_bursts
    assert teng.kv.prefill_splices == jeng.kv.prefill_splices
    assert (teng.fabric_stats.prefill_bursts
            == jeng.fabric_stats.prefill_bursts)
    want_splices = {"fused_gather": 0, "dense": 0, "splice": len(prompts),
                    "fused_fabric": len(prompts)}[path]
    assert teng.kv.prefill_splices == want_splices


def test_dense_splice_uses_the_known_slot_axis():
    """Dense layout, gemma3-4b smoke at ``max_slots == W``: a ``tail`` ring
    leaf is ``[8, 8, Hkv, D]``, where the reference's shape guess would
    take axis 1.  The port splices row ``slot`` of axis 0 (tail) and axis 1
    (unit); the full-depth ``A`` leaf takes the first ``span`` timesteps
    only.  Held against a hand-built expectation, not the reference."""
    tcfg = dataclasses.replace(get_smoke("gemma3-4b"), dtype="float32")
    tparams = api.init_params(tcfg, seed=2, device="cpu")
    eng = ServingEngine(tcfg, tparams, max_slots=8, t_max=16, page_size=4,
                        paged_pool=False)
    tail_leaf = eng.kv.caches["tail"][0]["k"]
    assert tail_leaf.shape[0] == tail_leaf.shape[1] == 8
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (1, 11), dtype=np.int32))
    _, req = api.prefill_fn(tparams, {"tokens": prompt}, tcfg, eng.t_alloc)
    slot, span = 5, 12                      # 11 tokens on pages of 4
    eng.kv.admit_wave([(slot, req, 11)])
    seen = set()
    for kind, axis in (("unit", 1), ("tail", 0)):
        for i, entry in enumerate(eng.kv.caches[kind]):
            for name, leaf in entry.items():
                mine = req[kind][i][name]
                want = torch.zeros_like(leaf)
                t = mine.shape[axis + 1]
                bound = span if t == eng.t_alloc else t
                want.narrow(axis, slot, 1).narrow(axis + 1, 0, bound).copy_(
                    mine.narrow(axis + 1, 0, bound))
                assert bool(mine.abs().sum() > 0)
                assert torch.equal(leaf, want), (kind, i, name)
                seen.add((kind, t == eng.t_alloc))
    assert seen == {("unit", True), ("unit", False), ("tail", False)}


# ----------------------------------------------------------------------------
# the CLI on the new archs and paths
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch,extra,want", [
    ("starcoder2-15b", [], "generated (2, 3)"),
    ("gemma3-12b", [], "generated (2, 3)"),
    ("starcoder2-15b", ["--engine"], "served 2 requests, 6 tokens"),
    ("gemma3-12b", ["--engine"], "served 2 requests, 6 tokens"),
    ("starcoder2-15b", ["--engine", "--no-paged-pool"], "dense per-slot KV"),
    ("starcoder2-15b", ["--engine", "--no-fused-gather", "--pack", "pad",
                        "--word-fold", "1"], "pack=pad fold=1"),
    ("starcoder2-15b", ["--engine", "--serve-fsdp"], "served 2 requests"),
    ("gemma3-12b", ["--engine", "--fabric-impl", "fused"],
     "the fabric banks no KV"),
    ("gemma3-12b", ["--fabric-impl", "fused"], "impl=fused")])
def test_serve_cli_dense_family(capsys, arch, extra, want):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "10", "--gen-len", "3"] + extra)
    assert want in capsys.readouterr().out
