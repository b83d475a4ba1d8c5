"""Shared helpers of the serving-engine parity suites
(``test_torch_preemption.py``, ``test_torch_admission.py``,
``test_torch_spec_faults.py``): the float32 smoke configs of both packages
with the reference's parameters carried across, the reference's churn
trace, and a loop that steps a reference engine and a port engine in
lockstep and compares their states after every step.

Token streams are compared exactly only after checking that the reference
never sits on a near-tie: :func:`record_margins` collects its top-1/top-2
logit margins (every prefill's, and every step's over the slots that
decoded), which the tests require to exceed 1e-3."""

import dataclasses
import functools

import numpy as np
import torch

import jax

from repro.configs import get_smoke as jget_smoke
from repro.models import api as japi
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.serving import Request, ServingEngine

KEY = jax.random.PRNGKey(7)
# the reference's churn trace (tests/test_preemption.py): (arrival step,
# prompt length, max_new_tokens, priority) — two long low-priority
# requests saturate a 7-page pool, then higher classes arrive
SPEC = [(0, 7, 8, 0), (0, 8, 8, 0), (2, 9, 6, 2), (3, 7, 6, 1), (4, 6, 6, 2)]
POOL = 7
CHURN = dict(max_slots=2, t_max=24, page_size=4)


@functools.lru_cache(maxsize=None)
def params(arch: str, key=0):
    """The reference's parameters of ``arch``'s float32 smoke (drawn once
    per process; ``key="churn"`` is the reference churn test's key) and the
    port's copy of them."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    jparams = japi.init_params(
        jcfg, KEY if key == "churn" else jax.random.PRNGKey(key))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")


def pair(arch: str, key=0, **over):
    """``(jcfg, tcfg, jparams, tparams)``: both packages' float32 smoke
    configs of ``arch`` (with the config fields ``over``) and parameters."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32", **over)
    tcfg = dataclasses.replace(get_smoke(arch), dtype="float32", **over)
    return (jcfg, tcfg) + params(arch, key)


def prompt(rid: int, length: int, vocab: int) -> np.ndarray:
    """The reference churn test's prompts."""
    return np.asarray(jax.random.randint(jax.random.fold_in(KEY, 1000 + rid),
                                         (length,), 0, vocab), np.int32)


def margin(logits) -> float:
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def bits(a) -> np.ndarray:
    """Same-width unsigned view of a numpy array or CPU tensor."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.itemsize])


def record_margins(jeng, monkeypatch) -> list:
    """The reference engine's top-1/top-2 margins, appended as it runs:
    each prefill's (a first token) and each step's over the slots that
    decoded in it."""
    margins, decoded = [], []
    prefill = japi.prefill_fn

    def prefill_recording(*args, **kwargs):
        logits, caches = prefill(*args, **kwargs)
        margins.append(margin(logits[:, -1]))
        return logits, caches
    monkeypatch.setattr(japi, "prefill_fn", prefill_recording)
    admit, step = jeng._admit, jeng._step_inner

    def admit_recording():
        decoded.clear()
        admit()
        decoded.extend(s for s in range(jeng.max_slots)
                       if jeng.active[s] is not None)

    def step_recording(step_no):
        n = step(step_no)
        if decoded:
            margins.append(margin(np.asarray(jeng.last_logits)[decoded]))
        return n
    jeng._admit, jeng._step_inner = admit_recording, step_recording
    return margins


def state(eng) -> dict:
    """The engine state both packages must agree on after a step."""
    st = eng.fabric_stats
    pool = eng.kv.pool
    return dict(
        table=None if pool is None else pool.table.tolist(),
        active=[None if r is None else r.rid for r in eng.active],
        queue=[r.rid for r in eng.queue],
        parked={rid: None if w.record is None else w.record.mapped
                for rid, w in eng._swapped.items()},
        pos=eng.pos.tolist(),
        swap_used=eng._swap_pages_used,
        pool=None if pool is None else (
            pool.pages_allocated, pool.pages_reclaimed,
            pool.pages_swapped_out, pool.pages_swapped_in),
        counters={f: getattr(st, f) for f in (
            "preemptions", "swap_bursts", "swap_out_words", "swap_in_words",
            "bursts_retried", "faults_recovered", "requests_shed",
            "shed_queue_full", "shed_deadline", "slo_missed_served",
            "slo_missed_shed", "aging_promotions", "prefill_bursts")},
        slo_misses=eng.slo_misses,
        census=eng.pending_census(),
        spec=(eng.spec_proposed, eng.spec_accepted, eng.spec_rejected))


def requests(spec, vocab: int):
    """Both packages' requests of ``spec`` entries ``(arrival, prompt_len,
    max_new_tokens, priority[, deadline])``."""
    out = []
    for i, (_, pl, mn, pri, *dl) in enumerate(spec):
        p = prompt(i, pl, vocab)
        kw = dict(max_new_tokens=mn, priority=pri,
                  deadline=dl[0] if dl else None)
        out.append((JRequest(i, p, **kw), Request(i, p, **kw)))
    return [j for j, _ in out], [t for _, t in out]


def lockstep(models, spec, monkeypatch, injectors=(None, None),
             recorders=(None, None), max_steps=300, on_step=None, **kw):
    """Drive ``spec`` through a reference and a port engine (``CHURN``
    geometry, ``check_pool``, engine options ``kw``; ``injectors`` and
    ``recorders``: one fault injector and one lifecycle recorder per
    engine) step by step.  Every ``submit`` must return the same, and after
    every step :func:`state` must be equal; ``on_step(step, jeng, teng)``
    may check more.  Returns both engines, both request lists, the submit
    results and the reference's margins."""
    jcfg, tcfg, jparams, tparams = models
    kw = dict(CHURN, check_pool=True, **kw)
    jeng = JEngine(jcfg, jparams, fault_injector=injectors[0],
                   recorder=recorders[0], **kw)
    teng = ServingEngine(tcfg, tparams, fault_injector=injectors[1],
                         recorder=recorders[1], **kw)
    jreqs, treqs = requests(spec, jcfg.vocab_size)
    margins = record_margins(jeng, monkeypatch)
    pend = sorted(range(len(spec)), key=lambda i: spec[i][0])
    submitted = []
    for step in range(max_steps):
        while pend and spec[pend[0]][0] <= step:
            i = pend.pop(0)
            got = teng.submit(treqs[i])
            assert jeng.submit(jreqs[i]) == got, i
            assert treqs[i].shed_reason == jreqs[i].shed_reason
            assert treqs[i].arrival_step == jreqs[i].arrival_step
            submitted.append((i, got))
        n = teng.step()
        assert jeng.step() == n, step
        assert state(teng) == state(jeng), step
        if on_step is not None:
            on_step(step, jeng, teng)
        if n == 0 and jeng.drained and not pend:
            break
    assert jeng.drained and teng.drained
    for jr, tr in zip(jreqs, treqs):
        assert jr.done and tr.done and tr.shed_reason == jr.shed_reason
    monkeypatch.undo()
    return jeng, teng, jreqs, treqs, submitted, margins


def port_run(models, spec, injector=None, **kw):
    """The port engine alone over ``spec`` (``CHURN`` geometry, engine
    options ``kw``); returns the engine and its requests' token streams."""
    _, tcfg, _, tparams = models
    eng = ServingEngine(tcfg, tparams, fault_injector=injector,
                        **dict(CHURN, check_pool=True, **kw))
    _, reqs = requests(spec, tcfg.vocab_size)
    pend = sorted(range(len(spec)), key=lambda i: spec[i][0])
    for step in range(300):
        while pend and spec[pend[0]][0] <= step:
            eng.submit(reqs[pend.pop(0)])
        if eng.step() == 0 and eng.drained and not pend:
            break
    assert eng.drained
    return eng, [r.generated for r in reqs]
