"""The last decoder-only families against the reference: internvl2-1b (a
dense backbone behind a patch-embedding prefix), recurrentgemma-2b (RG-LRU
``R`` blocks beside ring ``L`` layers) and mamba2-780m (Mamba-2 ``M``
blocks, no attention).

The full configs are checked as dataclasses and through their parameter
counts only; nothing is allocated at full width.  Everything else runs the
smoke configs in float32, with the reference's parameters carried across by
``params_from_jax`` and inputs drawn from a numpy seed.  Compute — both
scans, logits and every state leaf — is held within ``atol = rtol =
1e-4``: the port's RG-LRU scan is a Hillis-Steele scan, not JAX's
associative-scan tree, so it rounds differently.  Movement and counters
are exact, and token streams are equal.

The engines: internvl2 and mamba2 are stepped in lockstep with the
reference's engine.  recurrentgemma is not: the reference splices its
unit-stacked ``h`` into the wrong slot (its slot axis is guessed from the
shape; ROADMAP §3), so the port's engine is held to the reference's
per-request ``prefill_fn`` state and ``greedy_generate`` tokens instead.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.runtime.fault_tolerance import \
    FaultInjector as JFaultInjector  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.runtime import FaultInjector  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from tests import torch_serving_pairs as sp  # noqa: E402

ARCHS = ("internvl2-1b", "recurrentgemma-2b", "mamba2-780m")
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread_and_kernels():
    """One thread; both kernel switches on, and back as they were."""
    torch.set_num_threads(1)
    was, twas = jops.kernels_enabled(), tops.kernels_enabled()
    jops.use_kernels(True)
    tops.use_kernels(True)
    try:
        yield
    finally:
        jops.use_kernels(was)
        tops.use_kernels(twas)


def _x(shape, seed=3, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(
        got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
        np.asarray(want), err_msg=what, **TOL)


def _cache_close(tcache, jcache):
    """Every leaf of two cache trees within tolerance, leaf by leaf."""
    for kind in ("unit", "tail"):
        assert len(tcache[kind]) == len(jcache[kind] or [])
        for i, entry in enumerate(tcache[kind]):
            assert set(entry) == set(jcache[kind][i])
            for name, leaf in entry.items():
                want = np.asarray(jcache[kind][i][name])
                assert tuple(leaf.shape) == want.shape, (kind, i, name)
                assert leaf.dtype == getattr(torch, str(want.dtype)), name
                _close(leaf, want, f"{kind}{i}/{name}")


# the reference's greedy_generate, compiled whole (its eager form traces
# every op of the decode loop anew on each call)
_greedy = jax.jit(japi.greedy_generate, static_argnums=(2, 3, 4))


# ----------------------------------------------------------------------------
# configs and parameters
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_match_field_for_field(arch, size):
    get, jget = ((get_config, jget_config) if size == "full"
                 else (get_smoke, jget_smoke))
    tcfg, jcfg = get(arch), jget(arch)
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name in ("ssm", "rglru", "moe") and want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
            continue
        if f.name == "fabric":
            continue
        assert got == want, f.name
    assert dataclasses.asdict(tcfg.resolved_fabric) == dataclasses.asdict(
        jcfg.resolved_fabric)
    assert tcfg.layer_types() == jcfg.layer_types()
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_params_carry_their_float32_leaves(arch):
    """The bf16 smoke through ``params_from_jax``: every leaf's dtype is
    the reference's (the RG-LRU gates and ``lam``, Mamba's ``a_log``,
    ``dt_bias`` and ``d_skip`` float32), bf16 leaves bit for bit; the
    port's own ``init_params`` builds the same table with the reference's
    fixed leaves; a leaf of another dtype is refused."""
    jcfg, tcfg = jget_smoke(arch), get_smoke(arch)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tcfg, device="cpu")
    own = api.init_params(tcfg, seed=1, device="cpu")
    part = {"internvl2-1b": "attn", "recurrentgemma-2b": "rec",
            "mamba2-780m": "mixer"}[arch]
    src = np_params["unit"][0][part]
    block = tparams.unit[0][0]
    assert lm._block_parts(block) == sorted(np_params["unit"][0])
    for name, p in getattr(block, part).items():
        want = src[name][0]
        assert p.dtype == getattr(torch, str(want.dtype)), name
        assert getattr(own.unit[0][0], part)[name].dtype == p.dtype, name
        view = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}[
            want.itemsize]
        np.testing.assert_array_equal(p.view(view[0]).numpy(),
                                      want.view(view[1]))
    if arch == "mamba2-780m":
        mixer = own.unit[0][0].mixer
        np.testing.assert_allclose(mixer["a_log"].numpy(),
                                   np.asarray(src["a_log"][0]), rtol=1e-6)
        assert bool((mixer["d_skip"] == 1).all())
        assert not bool(mixer["dt_bias"].any())
    if arch == "recurrentgemma-2b":
        np.testing.assert_allclose(own.unit[0][0].rec["lam"].numpy(),
                                   np.asarray(src["lam"][0]), rtol=1e-6)
    if part != "attn":
        bad = jax.tree.map(lambda a: a, np_params)
        bad["unit"][0][part] = dict(src)
        name = "lam" if part == "rec" else "a_log"
        bad["unit"][0][part][name] = src[name].astype(jnp.bfloat16)
        with pytest.raises(ValueError, match=f"parameter {name}"):
            params_from_jax(bad, tcfg, device="cpu")


# ----------------------------------------------------------------------------
# the mixers
# ----------------------------------------------------------------------------

def _mixer(arch, seed=2):
    """One mixer's parameters of ``arch``'s float32 smoke on both sides,
    with the reference's init (``lam`` and the biases made nonzero so
    every term shows)."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    make = (jrglru.rglru_params if arch == "recurrentgemma-2b"
            else jmamba.mamba_params)
    p = make(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    p = {k: np.array(v) for k, v in p.items()}
    for k in ("b_a", "b_i", "conv_b", "dt_bias", "gate_norm"):
        if k in p:
            p[k] = (p[k] + 0.1 * rng.standard_normal(p[k].shape)).astype(
                np.float32)
    return jcfg, tcfg, p, {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mixer_matches_reference(arch, mode):
    """``rglru_apply`` / ``mamba_apply`` against the reference's, and the
    prefill against both packages' step-by-step oracles, within 1e-4.
    Prefill runs 13 positions (off mamba's chunk of 8); decode takes one
    step from a random conv window and state, and returns the new ones."""
    jcfg, tcfg, jp, tp = _mixer(arch)
    rec = arch == "recurrentgemma-2b"
    japply = jrglru.rglru_apply if rec else jmamba.mamba_apply
    tapply = rglru.rglru_apply if rec else mamba2.mamba_apply
    if mode == "prefill":
        x = _x((2, 13, tcfg.d_model))
        jout, jc = japply(jp, jnp.asarray(x), jcfg, None)
        tout, tc = tapply(tp, torch.from_numpy(x), tcfg, None)
        assert jc is None and tc is None
        _close(tout, jout)
        jref = (jrglru.rglru_sequential_ref if rec
                else jmamba.mamba_sequential_ref)(jp, jnp.asarray(x), jcfg)
        tref = (rglru.rglru_sequential_ref if rec
                else mamba2.mamba_sequential_ref)(tp, torch.from_numpy(x),
                                                  tcfg)
        _close(tref, jref)
        _close(tout, tref)
        return
    x = _x((3, 1, tcfg.d_model))
    cache = lm._state_shapes("R" if rec else "M", tcfg, 3, torch.float32)
    cache = {name: _x(shape, seed=7 + len(name), scale=0.5)
             for name, (shape, _) in cache.items()}
    jout, jc = japply(jp, jnp.asarray(x), jcfg,
                      {k: jnp.asarray(v) for k, v in cache.items()})
    tout, tc = tapply(tp, torch.from_numpy(x), tcfg,
                      {k: torch.from_numpy(v) for k, v in cache.items()})
    _close(tout, jout)
    assert set(tc) == set(jc)
    for name in tc:
        assert tc[name].dtype == torch.float32
        _close(tc[name], jc[name], name)


@pytest.mark.parametrize("seq", [5, 8, 13, 24])
def test_ssd_chunked_matches_reference(seq):
    """``_ssd_chunked`` at lengths below, at and off the chunk multiple
    (chunk 8: a 13-long sequence pads to 16 and slices back), against
    the reference's, within 1e-4."""
    b, h, p, n = 2, 3, 4, 5
    xh, bm, cm_ = (_x((b, seq, h, p), 1), _x((b, seq, n), 2),
                   _x((b, seq, n), 3))
    dt = np.log1p(np.exp(_x((b, seq, h), 4)))
    da = np.exp(-dt * np.linspace(1.0, 4.0, h)).astype(np.float32)
    dt = dt.astype(np.float32)
    want = jmamba._ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, da, bm,
                                                          cm_)), 8)
    got = mamba2._ssd_chunked(*(torch.from_numpy(a) for a in (xh, dt, da, bm,
                                                              cm_)), 8)
    assert tuple(got.shape) == (b, seq, h, p)
    _close(got, want)


@pytest.mark.parametrize("seq", [1, 2, 7, 16, 33])
def test_linear_scan_is_the_recurrence(seq):
    """The Hillis-Steele scan against the plain loop it replaces."""
    a = np.random.default_rng(seq).uniform(0.5, 1.0, (2, seq, 6)).astype(
        np.float32)
    b = _x((2, seq, 6), seq)
    h, want = np.zeros((2, 6), np.float32), []
    for t in range(seq):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------------------------------------
# the model: prefill, decode, greedy generate
# ----------------------------------------------------------------------------

def _inputs(tcfg, batch=2, seq=11, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tcfg.vocab_size, (batch, seq), dtype=np.int32)
    extra = {}
    if tcfg.n_patches:
        extra["patch_embeds"] = rng.standard_normal(
            (batch, tcfg.n_patches, tcfg.d_model)).astype(np.float32)
    return toks, extra


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pos", ["scalar", "per_row"])
def test_prefill_and_decode_match_reference(arch, pos):
    """``prefill_fn`` (with the patch prefix for internvl2; recurrentgemma's
    14 positions past its ring of 8) and one per-layer ``decode_fn`` step,
    at a scalar position and at per-row positions (the engine's ring
    path): logits and every cache leaf within 1e-4, leaf dtypes the
    reference's (``h`` and ``state`` float32)."""
    jcfg, tcfg, jparams, tparams = sp.pair(arch)
    toks, extra = _inputs(tcfg, seq=14)
    t_max = 24 + tcfg.n_patches
    jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks), **{
        k: jnp.asarray(v) for k, v in extra.items()}}, jcfg, t_max)
    tl, tc = api.prefill_fn(tparams, {"tokens": torch.from_numpy(toks),
                                      **extra}, tcfg, t_max)
    _close(tl, jl)
    _cache_close(tc, jc)
    p = 14 + tcfg.n_patches
    p = p if pos == "scalar" else np.array([p, p], np.int32)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    jl, jc = japi.decode_fn(jparams, jnp.asarray(nxt), jc, jnp.asarray(p),
                            jcfg)
    tl, tc2 = api.decode_fn(tparams, torch.from_numpy(nxt), tc, p, tcfg)
    _close(tl, jl)
    _cache_close(tc2, jc)
    # the decode wrote its states into the prefill's leaves, in place
    assert all(tc2[k][i][n] is tc[k][i][n] for k in ("unit", "tail")
               for i in range(len(tc[k])) for n in tc[k][i])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    """Six greedy tokens per row equal to the reference's (internvl2 with
    its patch prefix, positions counted past it), after checking the
    reference's first step is no near-tie; a ``t_max`` that cannot hold
    the patches too is refused."""
    jcfg, tcfg, jparams, tparams = sp.pair(arch)
    toks, extra = _inputs(tcfg, seq=9, seed=4)
    t_max = 16 + tcfg.n_patches
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    jl, _ = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks), **jextra},
                            jcfg, t_max)
    assert sp.margin(np.asarray(jl)[:, -1]) > 1e-3
    want = _greedy(jparams, jnp.asarray(toks), jcfg, 6, t_max, jextra)
    got = api.greedy_generate(tparams, torch.from_numpy(toks), tcfg, 6,
                              t_max, extra=extra)
    assert got.tolist() == np.asarray(want).tolist()
    if tcfg.n_patches:
        with pytest.raises(ValueError, match="does not fit"):
            api.greedy_generate(tparams, torch.from_numpy(toks), tcfg, 6,
                                9 + 6, extra=extra)


def test_vlm_batch_bit_equal_to_reference():
    """The VLM modality stub: ``n_patches`` float32 patch embeddings drawn
    after the token draws, ``seq - n_patches`` text tokens, bit for bit."""
    for step in (0, 3):
        want = JSyntheticLM(jget_smoke("internvl2-1b"), batch=3, seq=10,
                            seed=5).batch_at(step)
        got = SyntheticLM(get_smoke("internvl2-1b"), batch=3, seq=10,
                          seed=5).batch_at(step)
        assert set(got) == set(want) == {"tokens", "targets",
                                         "patch_embeds"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k].view(np.uint32)
                                          if k == "patch_embeds" else got[k],
                                          want[k].view(np.uint32)
                                          if k == "patch_embeds" else want[k])
        assert got["tokens"].shape == (3, 6)
    audio = dataclasses.replace(get_smoke("stablelm-1.6b"), family="audio")
    got = SyntheticLM(audio, batch=1, seq=4).batch_at(0)
    want = JSyntheticLM(dataclasses.replace(jget_smoke("stablelm-1.6b"),
                                            family="audio"),
                        batch=1, seq=4).batch_at(0)
    assert got["frames"].shape == (1, audio.encoder_seq, audio.d_model)
    np.testing.assert_array_equal(got["frames"].view(np.uint32),
                                  want["frames"].view(np.uint32))


# ----------------------------------------------------------------------------
# the engines
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internvl2-1b", "mamba2-780m"])
def test_engine_matches_reference_in_lockstep(arch, monkeypatch):
    """The reference's churn trace through both engines step for step
    (two slots, pages of 4): page tables, positions, queues and every
    counter equal after each step, equal token streams (the reference
    never on a near-tie).  internvl2 serves from the fused-gather pool
    (the port's kernels 1-2 on, i.e. their plain versions on the CPU);
    mamba2 has no full-attention leaf, so both build without a pool,
    preemption off, and no burst runs.  (Parameter key 2: key 0's
    internvl2 run and key 1's mamba2 run sit on near-ties.)"""
    jops.use_kernels(False)
    jeng, teng, jreqs, treqs, _, margins = sp.lockstep(
        sp.pair(arch, key=2), sp.SPEC, monkeypatch)
    assert min(margins) > 1e-3, margins
    for jr, tr in zip(jreqs, treqs):
        assert tr.generated == jr.generated, tr.rid
    assert teng.paged == jeng.paged == (arch == "internvl2-1b")
    assert teng.preempt == jeng.preempt
    if arch == "mamba2-780m":
        assert teng.preempt == "off" and teng.kv.pool is None
        assert teng.fabric_stats.flushes == 0
    else:
        assert teng.fabric_stats.gather_fused_bursts > 0
        assert teng.kv.pool.pages_allocated == jeng.kv.pool.pages_allocated


@pytest.mark.parametrize("what", ["aging", "queue", "deadlines", "faults",
                                  "spec"])
def test_engine_options_on_mamba_match_reference(what, monkeypatch):
    """Each engine option the reference takes on a family without a pool
    constructs and behaves the same in the port: aging, the bounded queue
    (sheds), SLO deadlines (sheds or misses), the fault injector (a
    mid-step failure rolled back and replayed; a pool exhaustion is a
    no-op without a pool) and speculative decode (the same committed
    tokens; the two packages draw other draft heads, so only the token
    streams compare).  Lockstep states equal after every step."""
    jops.use_kernels(False)
    spec = sp.SPEC
    kw, injectors = {}, (None, None)
    if what == "aging":
        kw = dict(aging=2)
    elif what == "queue":
        kw = dict(max_queue=1)
    elif what == "deadlines":
        spec = [s + (d,) for s, d in zip(sp.SPEC, (9, 12, 6, 40, 15))]
    elif what == "faults":
        injectors = (JFaultInjector(fail_at=(2, 5), exhaust_pool_at=(1,)),
                     FaultInjector(fail_at=(2, 5), exhaust_pool_at=(1,)))
    else:
        kw = dict(spec_decode_k=2)
    if what == "spec":
        models = sp.pair("mamba2-780m")
        _, plain = sp.port_run(models, spec)
        eng, toks = sp.port_run(models, spec, **kw)
        assert toks == plain and eng.spec_proposed > 0
        jeng = JEngine(models[0], models[2], **sp.CHURN, **kw)
        jreqs, _ = sp.requests(spec, models[0].vocab_size)
        for step in range(64):
            for i, s in enumerate(spec):
                if s[0] == step:
                    jeng.submit(jreqs[i])
            if jeng.step() == 0 and jeng.drained and step >= spec[-1][0]:
                break
        assert [r.generated for r in jreqs] == toks
        assert jeng.spec_proposed > 0
        return
    jeng, teng, jreqs, treqs, submitted, _ = sp.lockstep(
        sp.pair("mamba2-780m"), spec, monkeypatch, injectors=injectors, **kw)
    for jr, tr in zip(jreqs, treqs):
        assert tr.generated == jr.generated, tr.rid
    st = teng.fabric_stats
    if what == "queue":
        assert st.shed_queue_full > 0
    if what == "deadlines":
        assert teng.slo_misses == jeng.slo_misses > 0
    if what == "faults":
        assert st.faults_recovered == 2


@functools.lru_cache(maxsize=None)
def _rg(reps):
    """recurrentgemma smoke (5 layers, ``reps = 1``) or its 8-layer variant
    (``reps = 2``, an ``RR`` tail), float32, on both packages."""
    over = {} if reps == 1 else dict(n_layers=8)
    jcfg = dataclasses.replace(jget_smoke("recurrentgemma-2b"),
                               dtype="float32", **over)
    tcfg = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                               dtype="float32", **over)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, tcfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


RG_PROMPTS, RG_GEN, RG_TMAX = (11, 6, 9), (5, 4, 6), 32


def _slot_rows(eng, slot):
    """The slot's row of every per-slot leaf (its known axis), batch 1."""
    return {kind: [{name: leaf.narrow(1 if kind == "unit" else 0, slot, 1)
                    for name, leaf in entry.items()}
                   for entry in eng.kv.caches[kind]]
            for kind in ("unit", "tail")}


@pytest.mark.parametrize("reps", [1, 2])
def test_recurrentgemma_engine_matches_reference_per_request(reps):
    """Three requests on three slots of the port's engine (no pool,
    preemption off): after admission each slot's ``conv``/``h`` and ring
    rows equal the reference's ``prefill_fn`` of that request alone
    within 1e-4; each served stream is the prefill's argmax and then the
    reference's ``greedy_generate`` of that request, token for token."""
    jcfg, tcfg, jparams, tparams = _rg(reps)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab_size, (n,), dtype=np.int32)
               for n in RG_PROMPTS]
    eng = ServingEngine(tcfg, tparams, max_slots=3, t_max=RG_TMAX)
    assert not eng.paged and eng.preempt == "off"
    reqs = [Request(i, p, max_new_tokens=g)
            for i, (p, g) in enumerate(zip(prompts, RG_GEN))]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    prefill = jax.jit(japi.prefill_fn, static_argnums=(2, 3))
    for slot, (p, r) in enumerate(zip(prompts, reqs)):
        assert eng.active[slot] is r
        jl, jc = prefill(jparams, {"tokens": jnp.asarray(p[None])}, jcfg,
                         eng.t_alloc)
        assert sp.margin(np.asarray(jl)[:, -1]) > 1e-3
        _cache_close(_slot_rows(eng, slot), jc)
        assert r.generated == [int(np.argmax(np.asarray(jl)[0, -1]))]
    eng.run_to_completion(max_steps=32)
    for p, r, g in zip(prompts, reqs, RG_GEN):
        want = _greedy(jparams, jnp.asarray(p[None]), jcfg, g - 1, RG_TMAX)
        assert r.generated[1:] == np.asarray(want)[0].tolist(), r.rid


def test_recurrent_state_splices_into_its_own_slot():
    """The guard for the slot axis.  recurrentgemma at ``reps = 2``: the
    unit-stacked ``h`` is ``[2, B, W]`` (three dims), which the
    reference's shape guess splices on axis 0.  Three requests admitted
    to three slots: every per-slot leaf equals a hand-built expectation
    holding each request's own batch-1 prefill state in its slot's row on
    the known axis (1 under ``unit``, 0 in ``tail``), bit for bit."""
    _, tcfg, _, tparams = _rg(2)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, tcfg.vocab_size, (n,), dtype=np.int32)
               for n in RG_PROMPTS]
    eng = ServingEngine(tcfg, tparams, max_slots=3, t_max=RG_TMAX)
    unit_h = eng.kv.caches["unit"][0]["h"]
    assert tuple(unit_h.shape) == (2, 3, tcfg.rglru.lru_width)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=3))
    eng._admit()
    own = [api.prefill_fn(tparams, {"tokens": torch.from_numpy(p[None])},
                          tcfg, eng.t_alloc)[1] for p in prompts]
    names = set()
    for kind, axis in (("unit", 1), ("tail", 0)):
        for i, entry in enumerate(eng.kv.caches[kind]):
            for name, leaf in entry.items():
                want = torch.zeros_like(leaf)
                for slot, req_cache in enumerate(own):
                    src = req_cache[kind][i][name]
                    assert src.shape[axis] == 1 and bool(src.abs().sum())
                    want.narrow(axis, slot, 1).copy_(src)
                assert torch.equal(leaf, want), (kind, i, name)
                names.add(name)
    assert names == {"conv", "h", "k", "v"}
    # the slots hold three different states
    assert not torch.equal(unit_h[:, 0], unit_h[:, 1])
    assert not torch.equal(unit_h[:, 1], unit_h[:, 2])


# ----------------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch,extra,want", [
    ("internvl2-1b", [], "generated (2, 3)"),
    ("internvl2-1b", ["--engine"], "fused gather: "),
    ("recurrentgemma-2b", [], "generated (2, 3)"),
    ("recurrentgemma-2b", ["--engine"], "dense per-slot KV"),
    ("recurrentgemma-2b", ["--fabric-impl", "crossbar"], "impl=crossbar"),
    ("mamba2-780m", [], "generated (2, 3)"),
    ("mamba2-780m", ["--engine", "--aging", "2", "--max-queue", "4",
                     "--spec-decode-k", "2"], "no full-attention leaf")])
def test_serve_cli_families(capsys, arch, extra, want):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "10", "--gen-len", "3"] + extra)
    out = capsys.readouterr().out
    assert want in out
    if "--engine" in extra:
        assert "served 2 requests, 6 tokens" in out
