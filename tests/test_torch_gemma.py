"""The port's gemma3 slice against the reference: sliding-window ring
caches, the per-layer decode path (through the KV layout engine), the
rolled prefill install, ``greedy_generate``, the burst-scheduled step with
ring layers beside the paged ``A`` layers, and the engine.

gemma3-4b smoke in float32 (8 layers: ``LLLLLA`` once plus a tail of
``LL``, window 8) with the reference's parameters carried across by
``params_from_jax``.  Prompts of 11 and 13 tokens are longer than the
window, so the prefill rolls the ring and decode wraps it.

Tolerances: logits and new K/V within ``atol = rtol = 1e-4`` (the same
float32 formulas, summed in another order by the two frameworks).
Movement is exact: the slot each new token lands in, and every cache frame
the step did not write, are bit-equal.  Token streams are compared exactly
after checking that the run never sits on a near-tie (top-1/top-2 margin
above 1e-3), so float32 rounding cannot flip an argmax.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.fabric import BurstScheduler as JScheduler  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric import SchedulerStats as JStats  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fabric import BurstScheduler, Fabric  # noqa: E402
from repro_torch.fabric import SchedulerStats  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "gemma3-4b"
WINDOW = 8


@pytest.fixture(autouse=True)
def _one_thread_and_kernels():
    torch.set_num_threads(1)
    was, twas = jops.kernels_enabled(), tops.kernels_enabled()
    jops.use_kernels(True)
    tops.use_kernels(True)
    yield
    jops.use_kernels(was)
    tops.use_kernels(twas)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke(ARCH), dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _margin(logits) -> float:
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _leaves(tree):
    """``(kind, i, name, type)`` of every cache leaf of the smoke config."""
    for i, t in enumerate("LLLLLA"):
        for name in ("k", "v"):
            yield "unit", i, name, t
    for i in range(2):
        for name in ("k", "v"):
            yield "tail", i, name, "L"


def _to_torch(tree):
    return {kind: [{k: torch.from_numpy(np.array(v)) for k, v in e.items()}
                   for e in tree[kind]] for kind in ("unit", "tail")}


def test_configs_match_and_params_round_trip(models):
    for jc, tc in ((jget_config(ARCH), get_config(ARCH)),
                   (jget_smoke(ARCH), get_smoke(ARCH))):
        for f in dataclasses.fields(tc):
            if f.name not in ("moe", "ssm", "rglru", "fabric"):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.param_count() == jc.param_count()
        assert dataclasses.asdict(tc.resolved_fabric) == dataclasses.asdict(
            jc.resolved_fabric)
    # the mixed unit (reps 1) and tail (2 layers) carry across bit for bit
    jcfg, tcfg, jparams, tparams = models
    assert len(tparams.unit) == 6 and len(tparams.tail) == 2
    for i in range(6):
        for part in ("norm1", "attn", "norm2", "ffn"):
            for name, want in jparams["unit"][i][part].items():
                got = getattr(tparams.unit[i][0], part)[name]
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(want)[0])
    for i in range(2):
        for part in ("norm1", "attn", "norm2", "ffn"):
            for name, want in jparams["tail"][i][part].items():
                got = getattr(tparams.tail[i], part)[name]
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s", [11, 13, 16, 20])
def test_ring_install_layout(s):
    """The rolled window install puts position ``p`` at slot ``p % W``,
    exactly as the reference's ``jnp.roll`` does (positions as payload)."""
    kv = np.broadcast_to(np.arange(s, dtype=np.int32)[None, :, None, None],
                         (2, s, 1, 3)).copy()
    want = np.asarray(jnp.roll(jnp.asarray(kv)[:, s - WINDOW:], s % WINDOW,
                               axis=1))
    got = lm._ring_window(torch.from_numpy(kv), WINDOW).numpy()
    np.testing.assert_array_equal(got, want)
    slots = got[0, :, 0, 0]
    np.testing.assert_array_equal(slots % WINDOW, np.arange(WINDOW))
    assert slots.min() == s - WINDOW and slots.max() == s - 1


@pytest.mark.parametrize("s", [11, 13])
def test_prefill_logits_and_ring_caches(models, s):
    jcfg, tcfg, jparams, tparams = models
    toks = np.random.default_rng(s).integers(0, jcfg.vocab_size, (2, s),
                                             dtype=np.int32)
    jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 16)
    tl, tc = api.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)},
                            tcfg, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for kind, i, name, t in _leaves(tc):
        got = tc[kind][i][name].numpy()
        want = np.asarray(jc[kind][i][name])
        assert got.shape == want.shape
        assert got.shape[-3] == (WINDOW if t == "L" else 16)
        np.testing.assert_allclose(got, want, **TOL)


def _decode_pair(models, s, mode, seed):
    """Prefill (the reference's caches as the common start), then one
    per-layer decode step on both sides.  Returns the caches before and
    after on both sides, the logits and the positions."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (2, s), dtype=np.int32)
    _, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 16)
    before = jax.tree.map(np.asarray, jc)
    tok = rng.integers(0, jcfg.vocab_size, (2, 1), dtype=np.int32)
    pos = np.int32(s) if mode == "scalar" else np.array([s, s - 2], np.int32)
    jl, jc2 = japi.decode_fn(jparams, jnp.asarray(tok), jc, jnp.asarray(pos),
                             jcfg)
    tl, tc2 = api.decode_fn(tparams, torch.from_numpy(tok),
                            _to_torch(before), torch.from_numpy(np.array(pos)),
                            tcfg)
    return before, jax.tree.map(np.asarray, jc2), tc2, jl, tl, pos


@pytest.mark.parametrize("mode", ["scalar", "rows"])
@pytest.mark.parametrize("s", [11, 13])
def test_per_layer_decode_step(models, mode, s):
    """One per-layer decode step (no scheduler): at a scalar position the
    ring layers go through ``cached_attention`` and the layout engine, at
    ``[B]`` positions through the per-row ring attention."""
    before, jafter, tafter, jl, tl, pos = _decode_pair(models, s, mode, s)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    rows_pos = np.broadcast_to(pos, (2,))
    for kind, i, name, t in _leaves(before):
        old = before[kind][i][name]
        got = tafter[kind][i][name].numpy()
        want = jafter[kind][i][name]
        depth = old.shape[-3]
        # the frame each row's new token lands in: the ring slot pos % W
        # for a window layer, pos itself for the full-attention layer
        written = np.zeros(old.shape[:-2], bool)
        for b, p in enumerate(rows_pos):
            written[..., b, p % depth if t == "L" else p] = True
        for side in (got, want):
            moved = (side != old).any(axis=(-2, -1))
            np.testing.assert_array_equal(moved, written)
            np.testing.assert_array_equal(side[~written].view(np.uint32),
                                          old[~written].view(np.uint32))
        np.testing.assert_allclose(got[written], want[written], **TOL)


def test_greedy_generate_matches_reference(models):
    jcfg, tcfg, jparams, tparams = models
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 11),
                                               dtype=np.int32)
    want = np.asarray(japi.greedy_generate(jparams, jnp.asarray(prompt),
                                           jcfg, steps=4, t_max=16))
    margins = []
    got = api.greedy_generate(tparams, torch.from_numpy(prompt), tcfg,
                              steps=4, t_max=16,
                              on_step=lambda i, lg: margins.append(
                                  _margin(lg[:, -1].numpy())))
    assert len(margins) == 4 and min(margins) > 1e-3, margins
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("form", ["live", "phys"])
def test_scheduled_decode_step_with_ring_layers(models, form):
    """One burst-scheduled step on the paged pool: the ``A`` layer's pool
    through the bursts, the ``L`` layers' per-slot rings beside it.  Logits,
    every ``SchedulerStats`` field, the pool frames and the rings."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(3)
    ps, n_pages, t_depth, hd, hkv = 4, 8, 16, 16, 2
    table = np.full((3, 4), -1, np.int32)
    table[0, :3] = [3, 5, 1]
    table[1, :4] = [0, 6, 2, 7]
    pos = np.array([9, 13, 0], np.int32)
    caches = {"unit": [], "tail": []}
    for kind, i, name, t in _leaves(None):
        if name == "v":
            continue
        shape = ((n_pages, ps, hkv, hd) if t == "A"
                 else (3, WINDOW, hkv, hd))
        lead = (1,) if kind == "unit" else ()
        caches[kind].append({nm: rng.standard_normal(lead + shape)
                             .astype(np.float32) for nm in ("k", "v")})
    token = rng.integers(0, jcfg.vocab_size, (3, 1), dtype=np.int32)
    n = tcfg.resolved_fabric.n_ports
    live = cm.page_live_plan(table, ps, t_depth, n, bucket=n * ps)
    jstats = JStats()
    jl, jc = japi.decode_fn(
        jparams, jnp.asarray(token), jax.tree.map(jnp.asarray, caches),
        jnp.asarray(pos), jcfg,
        sched=JScheduler(JFabric(jcfg.resolved_fabric), stats=jstats),
        page_table=jnp.asarray(table), page_size=ps, t_depth=t_depth,
        live_plan=tuple(jnp.asarray(a) for a in jcm.page_live_plan(
            table, ps, t_depth, n, bucket=n * ps))
        if form == "live" else None)
    tstats = SchedulerStats()
    tl, tc = api.decode_fn(
        tparams, torch.from_numpy(token), _to_torch(caches),
        torch.from_numpy(pos), tcfg,
        sched=BurstScheduler(Fabric(tcfg.resolved_fabric), stats=tstats),
        page_table=torch.from_numpy(table), page_size=ps, t_depth=t_depth,
        live_plan=tuple(torch.from_numpy(a) for a in live)
        if form == "live" else None)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tstats.gather_fused_bursts == (4 if form == "live" else 0)
    for kind, i, name, t in _leaves(caches):
        old = caches[kind][i][name]
        got = tc[kind][i][name].numpy()
        want = np.asarray(jc[kind][i][name])
        written = np.zeros(old.shape[:-2], bool)
        for b, p in enumerate(pos):
            if t == "L":
                written[..., b, p % WINDOW] = True
            elif table[b, p // ps] >= 0:
                written[..., table[b, p // ps], p % ps] = True
        for side in (got, want):
            np.testing.assert_array_equal(side[~written].view(np.uint32),
                                          old[~written].view(np.uint32))
        np.testing.assert_allclose(got[written], want[written], **TOL)


PROMPT_LENS = (11, 13, 5)
GEN_LENS = (4, 3, 5)


@pytest.mark.parametrize("fused", [True, False])
def test_engine_matches_reference_and_greedy(models, fused, monkeypatch):
    """Two slots over three requests (slots retire and refill, rings are
    spliced at admission): equal token streams and page tables each step
    against the reference's engine (its kernels off, as its own engine
    test runs it), and against the port's own ``greedy_generate`` run one
    request at a time."""
    jcfg, tcfg, jparams, tparams = models
    jops.use_kernels(False)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,), dtype=np.int32)
               for n in PROMPT_LENS]
    kw = dict(max_slots=2, t_max=20, page_size=4, fused_gather=fused,
              check_pool=True)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = ServingEngine(tcfg, tparams, **kw)
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
        np.testing.assert_array_equal(teng.kv.pool.table, jeng.kv.pool.table)
        np.testing.assert_array_equal(teng.pos, jeng.pos)
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
    teng.kv.pool.check()
    # the one-shot path serves each request the same tokens: the prefill's
    # own token, then the decode steps' (the ring layers there go through
    # the layout engine instead of the per-row ring attention)
    tops.use_kernels(True)
    for p, g, tr in zip(prompts, GEN_LENS, treqs):
        prompt = torch.from_numpy(p)[None]
        logits, _ = api.prefill_fn(tparams, {"tokens": prompt}, tcfg, 20)
        first = int(torch.argmax(logits[0, -1]))
        rest = api.greedy_generate(tparams, prompt, tcfg, steps=g - 1,
                                   t_max=20)
        assert [first] + rest[0].tolist() == tr.generated, tr.rid


def test_ring_splice_uses_the_known_slot_axis(models):
    """At ``max_slots == W`` a tail ring leaf is ``[8, 8, Hkv, D]``; the
    reference's shape guess would take axis 1 there.  The port splices row
    ``slot`` of axis 0 (tail) and axis 1 (unit), which the hand-built
    expectation checks: that row is the request's ring, every other row
    untouched."""
    _, tcfg, _, tparams = models
    eng = ServingEngine(tcfg, tparams, max_slots=WINDOW, t_max=16,
                        page_size=4)
    tail_leaf = eng.kv.caches["tail"][0]["k"]
    assert tail_leaf.shape[0] == tail_leaf.shape[1] == WINDOW
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (1, 11), dtype=np.int32))
    _, req = api.prefill_fn(tparams, {"tokens": prompt}, tcfg, eng.t_alloc)
    slot = 5
    eng.kv.admit_wave([(slot, req, 11)])
    for kind, i, name, t in _leaves(req):
        if t != "L":
            continue
        leaf = eng.kv.caches[kind][i][name]
        mine = req[kind][i][name]
        assert bool(mine.abs().sum() > 0)
        if kind == "unit":
            assert torch.equal(leaf[:, slot], mine[:, 0])
            others = torch.cat([leaf[:, :slot], leaf[:, slot + 1:]], dim=1)
        else:
            assert torch.equal(leaf[slot], mine[0])
            others = torch.cat([leaf[:slot], leaf[slot + 1:]], dim=0)
        assert not bool(others.any())


@pytest.mark.parametrize("mode", ["scalar", "rows"])
def test_positions_past_the_cache_are_refused(models, mode):
    """A position at or past ``t_max`` raises at the entry point (the
    reference would clamp it onto the last frame); so does a prompt plus
    decode steps that does not fit."""
    _, tcfg, _, tparams = models
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 11), dtype=np.int32))
    _, caches = api.prefill_fn(tparams, {"tokens": toks}, tcfg, 12)
    tok = toks[:, -1:]
    bad = 12 if mode == "scalar" else np.array([11, 12], np.int32)
    with pytest.raises(ValueError, match="outside the KV cache depth 12"):
        api.decode_fn(tparams, tok, caches, bad, tcfg)
    neg = -1 if mode == "scalar" else torch.tensor([3, -1])
    with pytest.raises(ValueError, match="outside the KV cache depth"):
        api.decode_fn(tparams, tok, caches, neg, tcfg)
    with pytest.raises(ValueError, match="does not fit in t_max=12"):
        api.greedy_generate(tparams, toks, tcfg, steps=2, t_max=12)


def test_serve_cli_both_modes(capsys, monkeypatch):
    from repro_torch.launch import serve
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "10", "--gen-len", "3"]
    serve.main(args)
    assert "generated (2, 3)" in capsys.readouterr().out
    serve.main(args + ["--engine"])
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(args[:3])
