"""The port engine's fault recovery and speculative decode against the
reference's.

Faults (``FaultInjector``), on the reference's churn trace (starcoder2
smoke, float32, a 7-page pool, 2 slots, the swap arm):

* a mid-step failure at the first step that both swaps a victim out and
  admits a new request into the pages it freed: the rollback must restore
  the caches (the port's change in place, so its snapshot clones them);
  tokens equal the unfaulted run's and the reference's, one fault
  recovered, the states equal the reference's at every step;
* a corrupted swap transfer: caught by the parity word, retried once,
  tokens unchanged;
* injected pool exhaustion: the wave backs off a step, as the reference's;
* ``FaultInjector.seeded`` draws the reference's schedules, and a run with
  all three classes combined equals the reference's step for step.

Speculative decode:

* ``decode_step(draft=True)``: row 0 bit-equal to ``draft=False`` on every
  decode path (per-layer, per-layer paged, scheduled with the fused gather
  and with the gather after the burst), and the draft rows equal the
  reference's within 1e-4 with its draft heads carried across;
* engine runs with the model's draft heads (the reference's draws), an
  oracle and an adversarial ``draft_fn``: the token streams equal the
  ``k=0`` run's, and ``spec_proposed``/``spec_accepted``/``spec_rejected``
  equal the reference's (after checking that the reference's draft argmax
  never sits on a near-tie).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.runtime.fault_tolerance import FaultInjector as JInjector  # noqa
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fabric import BurstScheduler  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.runtime import FaultInjector  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from tests.torch_serving_pairs import (POOL, SPEC, bits, lockstep,  # noqa
                                       margin, pair, port_run, requests)

TOL = dict(atol=1e-4, rtol=1e-4)
SWAP = dict(pool_pages=POOL, preempt="swap")


@pytest.fixture(autouse=True)
def _one_thread_and_kernels():
    torch.set_num_threads(1)
    was, twas = jops.kernels_enabled(), tops.kernels_enabled()
    jops.use_kernels(False)
    tops.use_kernels(True)
    yield
    jops.use_kernels(was)
    tops.use_kernels(twas)


@pytest.fixture(scope="module")
def starcoder():
    return pair("starcoder2-15b", key="churn")


@pytest.fixture(scope="module")
def unfaulted(starcoder):
    """The port's unfaulted swap run: its tokens, and the first step that
    swaps a victim out and admits a new request into the freed pages."""
    _, tcfg, _, tparams = starcoder
    eng = ServingEngine(tcfg, tparams, check_pool=True, max_slots=2,
                        t_max=24, page_size=4, **SWAP)
    _, reqs = requests(SPEC, tcfg.vocab_size)
    pend = sorted(range(len(SPEC)), key=lambda i: SPEC[i][0])
    hazard = None
    for step in range(300):
        while pend and SPEC[pend[0]][0] <= step:
            eng.submit(reqs[pend.pop(0)])
        before = eng.kv.pool.table.copy()
        held = {r.rid: set(before[s][before[s] >= 0].tolist())
                for s, r in enumerate(eng.active) if r is not None}
        swaps, waves = eng.fabric_stats.swap_bursts, eng.kv.prefill_bursts
        n = eng.step()
        if (hazard is None and eng.fabric_stats.swap_bursts > swaps
                and eng.kv.prefill_bursts > waves):
            victims = [rid for rid in eng._swapped if rid in held]
            fresh = [s for s, r in enumerate(eng.active)
                     if r is not None and r.rid not in held]
            taken = {int(p) for s in fresh for p in eng.kv.pool.table[s]
                     if p >= 0}
            if any(held[v] & taken for v in victims):
                hazard = step
        if n == 0 and eng.drained and not pend:
            break
    assert hazard is not None
    return hazard, [r.generated for r in reqs]


# ----------------------------------------------------------------------------
# faults
# ----------------------------------------------------------------------------

def test_midstep_fault_where_a_swap_frees_pages_for_an_admission(
        starcoder, unfaulted, monkeypatch):
    """The step's admission swaps the victim out and installs a new prompt
    into its freed pages before the failure seam fires; the rollback must
    bring the victim's frames back in those pages.  A snapshot that kept
    the caches by reference would replay the swap-out over the new prompt's
    K/V, and the victim would serve other tokens."""
    step, want = unfaulted
    jinj, tinj = JInjector(fail_at=(step,)), FaultInjector(fail_at=(step,))
    jeng, teng, jreqs, treqs, _, margins = lockstep(
        starcoder, SPEC, monkeypatch, injectors=(jinj, tinj), **SWAP)
    assert min(margins) > 1e-3
    assert tinj.fired == jinj.fired == {step}
    assert teng.fabric_stats.faults_recovered == 1
    assert teng.fabric_stats.preemptions > 0
    got = [r.generated for r in treqs]
    assert got == want
    assert got == [r.generated for r in jreqs]


def test_corrupted_swap_transfer_is_retried(starcoder, unfaulted):
    inj = FaultInjector(corrupt_swap=(0,))
    eng, got = port_run(starcoder, SPEC, injector=inj, **SWAP)
    assert inj.corrupted == 1
    assert eng.fabric_stats.bursts_retried == 1
    assert eng.fabric_stats.swap_bursts > 0
    assert got == unfaulted[1]


def test_swap_transfer_gives_up_after_two_corruptions(starcoder):
    """Both attempts corrupted: the transfer raises (a step failure)."""
    _, tcfg, _, tparams = starcoder
    eng = ServingEngine(tcfg, tparams, max_slots=2, t_max=24, page_size=4,
                        **SWAP)
    eng.submit(Request(0, np.arange(1, 9, dtype=np.int32), 8))
    eng.step()
    eng.step()

    class Always:
        def corrupt_swap_burst(self, attempt):
            return True
    eng.kv.fault_injector = Always()
    with pytest.raises(RuntimeError, match="parity check twice"):
        eng.kv.swap_out(0, stats=eng.fabric_stats)
    assert eng.fabric_stats.bursts_retried == 2


def test_injected_pool_exhaustion_backs_off(starcoder, unfaulted,
                                            monkeypatch):
    at = (1, 2, 5)
    jinj, tinj = JInjector(exhaust_pool_at=at), FaultInjector(
        exhaust_pool_at=at)
    jeng, teng, jreqs, treqs, _, margins = lockstep(
        starcoder, SPEC, monkeypatch, injectors=(jinj, tinj), **SWAP)
    assert min(margins) > 1e-3
    assert tinj.exhaust_fired == jinj.exhaust_fired == set(at)
    got = [r.generated for r in treqs]
    assert got == [r.generated for r in jreqs] == unfaulted[1]


@pytest.mark.parametrize("seed", [0, 1, 7, 2024])
def test_seeded_schedule_is_the_reference_s(seed):
    for kw in (dict(), dict(p_fail=0.2, p_exhaust=0.3, n_corrupt=3)):
        j, t = JInjector.seeded(seed, 64, **kw), FaultInjector.seeded(
            seed, 64, **kw)
        assert (t.fail_at, t.exhaust_pool_at, t.corrupt_swap_at) == \
            (j.fail_at, j.exhaust_pool_at, j.corrupt_swap_at)
    assert t.fail_at and t.exhaust_pool_at


def test_combined_faults_match_reference(starcoder, unfaulted, monkeypatch):
    kw = dict(fail_at=(2, 6), corrupt_swap=(1,), exhaust_pool_at=(4,))
    jinj, tinj = JInjector(**kw), FaultInjector(**kw)
    jeng, teng, jreqs, treqs, _, margins = lockstep(
        starcoder, SPEC, monkeypatch, injectors=(jinj, tinj), **SWAP)
    assert min(margins) > 1e-3
    st = teng.fabric_stats
    assert st.faults_recovered == 2 and st.bursts_retried >= 1
    got = [r.generated for r in treqs]
    assert got == [r.generated for r in jreqs] == unfaulted[1]


# ----------------------------------------------------------------------------
# speculative decode: the model level
# ----------------------------------------------------------------------------

def _clone(caches):
    return {kind: [{n: t.clone() for n, t in e.items()} for e in caches[kind]]
            for kind in ("unit", "tail")}


@pytest.mark.parametrize("path", ["layers", "paged", "live", "phys"])
def test_draft_row0_is_the_dense_logits(path):
    """``draft=True`` appends k draft rows and leaves row 0 bit-identical to
    the ``draft=False`` step, on every decode path."""
    _, tcfg, _, _ = pair("starcoder2-15b", spec_heads=2)
    params = api.init_params(tcfg, seed=3, device="cpu")
    assert tuple(params.draft["w"].shape) == (2, tcfg.d_model, tcfg.d_model)
    eng = ServingEngine(tcfg, params, max_slots=2, t_max=16, page_size=4,
                        fused_gather=path == "live")
    for rid, n in enumerate((5, 9)):
        eng.submit(Request(rid, np.arange(1, n + 1, dtype=np.int32), 4))
    eng._admit()
    tok = torch.from_numpy(eng.tokens.copy())
    table = eng.kv.page_table_device("cpu")
    plan = tuple(torch.from_numpy(a) for a in cm.page_live_plan(
        eng.kv.pool.table, 4, eng.t_alloc, eng.fabric.n_ports,
        bucket=eng.live_bucket))
    if path == "layers":
        toks = torch.arange(1, 8, dtype=torch.int32).reshape(1, 7)
        _, caches = api.prefill_fn(params, {"tokens": toks}, tcfg, 16)
        tok, pos = toks[:, -1:], 7
        kw = {}
    else:
        caches, pos = eng.kv.caches, eng.pos.copy()
        kw = dict(page_table=table, page_size=4, t_depth=eng.t_alloc)
        if path in ("live", "phys"):
            kw["live_plan"] = plan if path == "live" else None
    out = {}
    for draft in (False, True):
        if path in ("live", "phys"):
            kw["sched"] = BurstScheduler(eng.fabric)
        out[draft], _ = api.decode_fn(params, tok, _clone(caches), pos,
                                      tcfg, draft=draft, **kw)
    assert out[True].shape == (tok.shape[0], 3, out[False].shape[-1])
    assert np.array_equal(bits(out[True][:, :1]), bits(out[False]))


def test_draft_rows_match_reference():
    jcfg, tcfg, _, _ = pair("starcoder2-15b", spec_heads=2)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(11))
    assert "draft" in jparams
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    bare = {k: v for k, v in jax.tree.map(np.asarray, jparams).items()
            if k != "draft"}
    with pytest.raises(ValueError, match="2 draft heads"):
        params_from_jax(bare, tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 9),
                                             dtype=np.int32)
    _, jc = japi.prefill_fn(jparams, {"tokens": jax.numpy.asarray(toks)},
                            jcfg, 16)
    _, tc = api.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)},
                           tcfg, 16)
    tok = toks[:, -1:]
    want, _ = japi.decode_fn(jparams, jax.numpy.asarray(tok), jc, 9, jcfg,
                             draft=True)
    got, _ = api.decode_fn(tparams, torch.from_numpy(tok), tc, 9, tcfg,
                           draft=True)
    assert tuple(got.shape) == tuple(want.shape) == (2, 3, got.shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------------------
# speculative decode: the engine
# ----------------------------------------------------------------------------

# churny admission (the reference's tests/test_spec_decode.py): (arrival
# step, rid, prompt length, max_new_tokens), more requests than slots
ARRIVALS = [(0, 0, 5, 4), (0, 1, 7, 3), (2, 2, 3, 5), (4, 3, 6, 4)]


def _drive(eng, req_t):
    pending = sorted(ARRIVALS)
    reqs, i = {}, 0
    for t in range(300):
        while i < len(pending) and pending[i][0] <= t:
            _, rid, plen, gen = pending[i]
            reqs[rid] = req_t(rid, list(range(1, plen + 1)),
                              max_new_tokens=gen)
            eng.submit(reqs[rid])
            i += 1
        if eng.step() == 0 and i == len(pending) and eng.drained:
            return {rid: list(r.generated) for rid, r in reqs.items()}
    raise AssertionError("churny workload did not complete")


@pytest.fixture(scope="module")
def spec_models():
    """starcoder2 smoke (key 0, as the reference's spec test), and the
    reference's k=0 token streams."""
    jcfg, tcfg, jparams, tparams = pair("starcoder2-15b")
    jops.use_kernels(False)
    ref = _drive(JEngine(jcfg, jparams, max_slots=2, t_max=16), JRequest)
    return jcfg, tcfg, jparams, tparams, ref


@pytest.mark.parametrize("draft", ["heads", "oracle", "half_right"])
def test_spec_engine_matches_reference(spec_models, draft):
    jcfg, tcfg, jparams, tparams, ref = spec_models
    vocab = jcfg.vocab_size
    assert _drive(ServingEngine(tcfg, tparams, max_slots=2, t_max=16),
                  Request) == ref
    fns = {"heads": None,
           "oracle": lambda req, c: ref[req.rid][len(req.generated):
                                                 len(req.generated) + 2],
           "half_right": lambda req, c: [
               t for t0 in ref[req.rid][len(req.generated):
                                        len(req.generated) + 1]
               for t in (t0, (t0 + 1) % vocab)]}
    kw = dict(max_slots=2, t_max=16, spec_decode_k=2, draft_fn=fns[draft])
    jeng = JEngine(jcfg, jparams, **kw)
    margins = []
    if draft == "heads":
        # the reference draws its heads (no "draft" in its params); the
        # port is handed the same draws
        heads = jcm.draft_head_params(
            jax.random.PRNGKey(0x5BEC),
            dataclasses.replace(jcfg, spec_heads=2), jcfg.param_dtype)
        np_params = jax.tree.map(np.asarray, {**jparams, "draft": heads})
        tparams = params_from_jax(np_params, tcfg, device="cpu")
        dec = jeng._decode

        def recording(*args):
            logits, caches = dec(*args)
            live = [s for s, r in enumerate(jeng.active) if r is not None]
            margins.append(margin(np.asarray(logits)[live, 1:]))
            return logits, caches
        jeng._decode = recording
    teng = ServingEngine(tcfg, tparams, **kw)
    want = _drive(jeng, JRequest)
    got = _drive(teng, Request)
    assert got == want == ref
    counts = (teng.spec_proposed, teng.spec_accepted, teng.spec_rejected)
    assert counts == (jeng.spec_proposed, jeng.spec_accepted,
                      jeng.spec_rejected)
    assert teng.spec_proposed > 0
    if draft == "heads":
        assert min(margins) > 1e-3, margins
        assert teng.spec_accepted + teng.spec_rejected <= teng.spec_proposed
    elif draft == "oracle":
        assert teng.spec_accepted > 0 and teng.spec_rejected == 0
    else:
        assert teng.spec_accepted > 0 and teng.spec_rejected > 0


def test_engine_draws_its_own_draft_heads():
    """Without draft heads in its parameters the engine draws k of them
    from a fixed seed (the caller's parameters stay as they were); fewer
    heads than ``spec_decode_k`` is refused."""
    _, tcfg, _, tparams = pair("starcoder2-15b")
    eng = ServingEngine(tcfg, tparams, max_slots=2, t_max=16,
                        spec_decode_k=3)
    assert tparams.draft is None
    assert tuple(eng.params.draft["w"].shape) == (3, tcfg.d_model,
                                                  tcfg.d_model)
    assert eng.params.embed is tparams.embed
    again = ServingEngine(tcfg, tparams, max_slots=2, t_max=16,
                          spec_decode_k=3)
    assert torch.equal(again.params.draft["w"], eng.params.draft["w"])
    with pytest.raises(ValueError, match="draft heads"):
        ServingEngine(tcfg, eng.params, max_slots=2, t_max=16,
                      spec_decode_k=4)
