"""The port's oversubscribed engine against the reference's: the page
pool's allocator and swap accounting, the swap data path, and preemption
under churn.

* ``PagePool`` — a scripted sequence of ``ensure``/``release``/
  ``swap_out``/``swap_in`` with 1, 2 and 4 shard blocks: after every call
  the table, the free stacks (contents and order), the round-robin cursor
  and the four counters equal the reference's, and ``check()`` passes.
* Swap round trip — admit, decode, ``swap_out`` a slot, ``swap_in`` it to
  other physical pages, on the stablelm smoke (fused, with the kernels on
  and off: kernels 1-2 through their plain versions here; and a fabric
  that cannot bank, the host stage) and the gemma3-4b smoke (ring leaves
  beside the pool).  Movement is compared bit for bit: the port's caches
  are first given the reference's bytes, then the ``SwapRecord``s, the
  pool and ring leaves after the swap-in, and every ``SchedulerStats``
  field of the two transfers must be equal.
* The ring leaves' slot axis under swap at ``max_slots == W`` (where the
  reference's shape guess takes the wrong axis), against a hand-built
  expectation.
* Oversubscribed churn (the reference's ``tests/test_preemption.py``
  trace: starcoder2 smoke, a 7-page pool, 2 slots) under ``preempt`` swap,
  recompute and off (and swap on the engine that gathers after the burst),
  stepped in lockstep with the reference: after every
  step the page tables, the slots, the queue, the parked set and the
  preemption and swap counters are equal; at the end the token streams are
  equal, every page is back and the swap space is empty, and the port's
  tokens are those of its own unconstrained run.
* The swap-space cap (swap falls back to recompute) and a high-priority
  arrival's landing bound, against the reference.

Both packages run float32 smoke configs with the reference's parameters
carried across; the reference with its kernels off, the port on its plain
versions, unless a test says otherwise.  Token streams are compared
exactly after checking that the reference never sits on a near-tie
(top-1/top-2 margin above 1e-3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fabric import PagePool as JPool  # noqa: E402
from repro.fabric import SchedulerStats as JStats  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.fabric import PagePool, SchedulerStats  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from tests.torch_serving_pairs import (POOL, SPEC, bits, lockstep,  # noqa
                                       pair, port_run, prompt, requests)

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


# ----------------------------------------------------------------------------
# PagePool
# ----------------------------------------------------------------------------

def _pool_state(pool):
    return (pool.table.tolist(), [list(s) for s in pool._free_by_shard],
            pool._rr, pool.pages_allocated, pool.pages_reclaimed,
            pool.pages_swapped_out, pool.pages_swapped_in)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_pool_allocation_and_swap_match_reference(shards):
    kw = dict(page_size=4, n_pages=16, pages_per_slot=6, n_slots=4,
              n_shards=shards)
    jp, tp = JPool(**kw), PagePool(**kw)
    script = [("ensure", 0, 3), ("ensure", 1, 5), ("ensure", 2, 2),
              ("swap_out", 1), ("ensure", 3, 4), ("ensure", 0, 5),
              ("release", 2), ("swap_in", 1, 5), ("swap_out", 0),
              ("ensure", 2, 6), ("release", 3), ("swap_in", 0, 3),
              ("release", 1), ("ensure", 1, 1), ("swap_out", 2),
              ("release", 0), ("release", 1)]
    for call in script:
        got = getattr(tp, call[0])(*call[1:])
        want = getattr(jp, call[0])(*call[1:])
        assert got == want, call
        assert _pool_state(tp) == _pool_state(jp), call
        assert tp.free_pages_by_shard == jp.free_pages_by_shard
        assert [tp.shard_of(p) for p in range(16)] == \
            [jp.shard_of(p) for p in range(16)]
        tp.check()
    assert tp.pages_in_use == 0 and tp.pages_swapped_out > 0
    if shards > 1:                 # a foreign page in a shard's stack
        tp._free_by_shard[0].append(tp._free_by_shard[1].pop())
        with pytest.raises(ValueError, match="foreign"):
            tp.check()
        tp._free_by_shard[1].append(tp._free_by_shard[0].pop())
        tp.check()
    # exhaustion raises on both, at the same page
    tp.ensure(0, 6)
    jp.ensure(0, 6)
    tp.ensure(1, 6)
    jp.ensure(1, 6)
    with pytest.raises(RuntimeError, match="exhausted"):
        tp.swap_in(2, 6)
    with pytest.raises(RuntimeError, match="exhausted"):
        jp.swap_in(2, 6)
    assert _pool_state(tp) == _pool_state(jp)


# ----------------------------------------------------------------------------
# the swap data path, movement bit for bit
# ----------------------------------------------------------------------------

def _sync_caches(teng, jeng):
    """Give the port's cache leaves the reference's bytes, so the swap
    transfers compare by movement alone."""
    for kind in ("unit", "tail"):
        for i, entry in enumerate(teng.kv.caches[kind]):
            for name, leaf in entry.items():
                src = np.array(jeng.kv.caches[kind][i][name])
                leaf.copy_(torch.from_numpy(src))


def _assert_caches_equal(teng, jeng):
    for kind in ("unit", "tail"):
        for i, entry in enumerate(teng.kv.caches[kind]):
            for name, leaf in entry.items():
                np.testing.assert_array_equal(
                    bits(leaf), bits(np.array(jeng.kv.caches[kind][i][name])),
                    err_msg=f"{kind}{i}/{name}")


def _assert_records_equal(trec, jrec):
    assert (trec.mapped, trec.used_pages, trec.dirty) == \
        (jrec.mapped, jrec.used_pages, jrec.dirty)
    assert sorted(trec.frames) == sorted(jrec.frames)
    for key, want in jrec.frames.items():
        np.testing.assert_array_equal(bits(trec.frames[key]), bits(want),
                                      err_msg=str(key))
    assert sorted(trec.unpaged) == sorted(jrec.unpaged)
    for key, want in jrec.unpaged.items():
        np.testing.assert_array_equal(bits(trec.unpaged[key]), bits(want),
                                      err_msg=key)


@pytest.mark.parametrize("arch,path", [
    ("stablelm-1.6b", "kernels"),      # sparse bursts through kernels 1-2
    ("stablelm-1.6b", "unrolled"),     # the same bursts, kernels off
    ("stablelm-1.6b", "host"),         # a fabric that cannot bank
    ("gemma3-4b", "unrolled")])        # ring leaves beside the pool
def test_swap_round_trip_movement_bit_exact(arch, path):
    over = dict(kv_layout="fused") if path == "host" else {}
    jcfg, tcfg, jparams, tparams = pair(arch, **over)
    kw = dict(max_slots=3, t_max=20, page_size=4)
    jeng, teng = JEngine(jcfg, jparams, **kw), ServingEngine(tcfg, tparams,
                                                             **kw)
    assert teng.kv._fused_eligible() == jeng.kv._fused_eligible() == \
        (path != "host")
    rng = np.random.default_rng(3)
    for rid, n in enumerate((11, 11)):
        p = rng.integers(0, jcfg.vocab_size, (n,), dtype=np.int32)
        jeng.submit(JRequest(rid, p, max_new_tokens=6))
        teng.submit(Request(rid, p, max_new_tokens=6))
    jeng.step()                      # admission, and one decode step
    teng.step()
    np.testing.assert_array_equal(teng.kv.pool.table, jeng.kv.pool.table)
    _sync_caches(teng, jeng)
    on = path == "kernels"
    jops.use_kernels(on)
    tops.use_kernels(on)
    jst, tst = JStats(), SchedulerStats()
    jrec = jeng.kv.swap_out(0, stats=jst)
    trec = teng.kv.swap_out(0, stats=tst)
    _assert_records_equal(trec, jrec)
    assert trec.mapped == 4 and all(
        v.device.type == "cpu" for v in trec.frames.values())
    # another slot takes the freed pages first, so the swap-in lands at
    # other physical rows; the freed slot's rows are overwritten meanwhile
    for pool in (jeng.kv.pool, teng.kv.pool):
        pool.ensure(2, 2)
    np.testing.assert_array_equal(teng.kv.pool.table, jeng.kv.pool.table)
    jeng.kv.swap_in(0, jrec, stats=jst)
    teng.kv.swap_in(0, trec, stats=tst)
    np.testing.assert_array_equal(teng.kv.pool.table, jeng.kv.pool.table)
    assert set(teng.kv.pool.table[0][:4]).isdisjoint(
        set(jeng.kv.pool.table[2][:2]))
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert (tst.swap_bursts, tst.bursts_retried) == (
        (2, 0) if path != "host" else (0, 0))
    if path != "host":
        assert tst.swap_out_words == tst.swap_in_words > 0
    _assert_caches_equal(teng, jeng)
    np.testing.assert_array_equal(teng.kv.table.used, jeng.kv.table.used)
    np.testing.assert_array_equal(teng.kv._dirty, jeng.kv._dirty)
    teng.kv.pool.check()


def test_swap_restores_ring_rows_on_the_known_slot_axis():
    """gemma3-4b smoke at ``max_slots == W == 8``: a tail ring leaf is
    ``[8, 8, Hkv, D]``, where the reference's shape guess would take the
    ring axis for the slot axis.  The port's swap record holds row ``slot``
    of axis 0 (tail) and axis 1 (unit), and the swap-in puts exactly those
    rows back: the leaves equal their pre-swap bytes, every other row
    untouched, against a hand-built expectation."""
    _, tcfg, _, tparams = pair("gemma3-4b")
    eng = ServingEngine(tcfg, tparams, max_slots=8, t_max=16, page_size=4)
    tail = eng.kv.caches["tail"][0]["k"]
    assert tail.shape[0] == tail.shape[1] == 8
    gen = torch.Generator().manual_seed(4)
    for kind, i, name, leaf in eng._cache_leaves():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (1, 11), dtype=np.int32))
    _, req = api.prefill_fn(tparams, {"tokens": prompt}, tcfg, eng.t_alloc)
    slot = 5
    eng.kv.admit_wave([(slot, req, 11)])
    before = {(kind, i, name): leaf.clone()
              for kind, i, name, leaf in eng._cache_leaves()}
    rec = eng.kv.swap_out(slot)
    for kind in ("unit", "tail"):
        axis = 1 if kind == "unit" else 0
        for i, entry in enumerate(eng.kv.caches[kind]):
            if (kind, i) in eng.kv.paged_entries:
                continue
            for name, leaf in entry.items():
                saved = rec.unpaged[f"['{kind}'][{i}]['{name}']"]
                want = req[kind][i][name]         # batch 1 on the slot axis
                assert torch.equal(saved, want), (kind, i, name)
                if kind == "tail":                # what the guess would hold
                    assert not torch.equal(saved, leaf.narrow(1, slot, 1))
                leaf.narrow(axis, slot, 1).zero_()    # the row is reused
    eng.kv.pool.ensure(0, 3)                  # the freed pages go elsewhere
    eng.kv.swap_in(slot, rec)
    for kind, i, name, leaf in eng._cache_leaves():
        if (kind, i) in eng.kv.paged_entries:
            continue
        assert torch.equal(leaf, before[(kind, i, name)]), (kind, i, name)
    # the pool frames came back at the slot's new physical rows
    for kind, i in eng.kv.paged_entries:
        for name in ("k", "v"):
            flat = eng.kv.caches[kind][i][name].reshape(
                -1, *eng.kv.caches[kind][i][name].shape[-2:])
            idx = torch.from_numpy(eng.kv._rep_idx(
                kind, i, eng.kv._phys_frames(slot, rec.mapped * 4))).long()
            assert torch.equal(flat[idx], rec.frames[(kind, i, name)])


# ----------------------------------------------------------------------------
# oversubscribed churn, in lockstep with the reference
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("mode,fused", [
    ("swap", True), ("recompute", True), ("off", True),
    ("swap", False)])                  # the gather after the burst
def test_oversubscribed_churn_matches_reference_in_lockstep(
        starcoder, mode, fused, monkeypatch):
    jeng, teng, jreqs, treqs, _, margins = lockstep(
        starcoder, SPEC, monkeypatch, pool_pages=POOL, preempt=mode,
        fused_gather=fused)
    assert min(margins) > 1e-3, margins
    for jr, tr in zip(jreqs, treqs):
        assert tr.generated == jr.generated, tr.rid
    st = teng.fabric_stats
    if mode == "off":
        assert st.preemptions == 0
    else:
        assert st.preemptions > 0
    if mode == "swap":
        assert st.swap_bursts > 0 and st.swap_out_words > 0
        assert teng.kv.pool.pages_swapped_in == \
            teng.kv.pool.pages_swapped_out > 0
    else:
        assert st.swap_bursts == st.swap_out_words == 0
    assert teng.kv.pool.pages_in_use == 0
    assert teng._swap_pages_used == 0 and not teng._swapped
    teng.kv.pool.check()
    # the port's preempted run serves its own unconstrained run's tokens
    _, want = port_run(starcoder, SPEC, max_slots=len(SPEC), preempt="off")
    assert [r.generated for r in treqs] == want


def test_swap_space_cap_falls_back_to_recompute(starcoder, monkeypatch):
    jeng, teng, jreqs, treqs, _, margins = lockstep(
        starcoder, SPEC, monkeypatch, pool_pages=POOL, preempt="swap",
        swap_space_pages=3)
    assert min(margins) > 1e-3
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.fabric_stats.preemptions > 0
    assert teng.kv.pool.pages_swapped_out <= 3


def test_priority_inversion_bound(starcoder):
    """A high-priority arrival lands within two steps although low-priority
    work holds every page, as in the reference, and at the same step."""
    jcfg, tcfg, jparams, tparams = starcoder
    kw = dict(max_slots=2, t_max=24, page_size=4, pool_pages=8,
              preempt="swap", check_pool=True)
    engines = (JEngine(jcfg, jparams, **kw), ServingEngine(tcfg, tparams,
                                                           **kw))
    landed = []
    for eng, req_t in zip(engines, (JRequest, Request)):
        for i in range(3):
            eng.submit(req_t(i, prompt(i, 8, jcfg.vocab_size),
                             max_new_tokens=8, priority=0))
        for _ in range(3):
            eng.step()
        hi = req_t(99, prompt(99, 6, jcfg.vocab_size), max_new_tokens=4,
                   priority=5)
        eng.submit(hi)
        for k in range(2):
            eng.step()
            if hi in eng.active:
                break
        assert hi in eng.active
        landed.append((k, eng.fabric_stats.preemptions,
                       eng.kv.pool.table.tolist()))
        eng.run_to_completion(max_steps=200)
        assert hi.done
    assert landed[0] == landed[1]


# ----------------------------------------------------------------------------
# a pool too small to progress: a defect both engines share, pinned
# ----------------------------------------------------------------------------

# draws of the reference's unseeded preemption sweep
# (tests/test_preemption.py::test_property_preemption_churn_parity) that
# exhaust a 4-page pool of 4-step pages, the sweep's ceil(16 / 4): each
# spec, the step that raises and the slot that needs a page it cannot get
EXHAUSTING_DRAWS = {
    "late-arrivals": ([(0, 7, 1, 0), (4, 7, 1, 0), (4, 7, 1, 0)], 4, 0),
    "two-at-once": ([(0, 3, 3, 0), (0, 7, 1, 0)], 0, 1)}
EXHAUSTING = dict(max_slots=2, t_max=24, page_size=4, pool_pages=4,
                  check_pool=True)


def _drive_until_raise(eng, reqs, spec, max_steps=40):
    """Drive ``spec`` as the reference's sweep drives it (arrivals due at a
    step are submitted before it); return the step that raised and the
    error, or ``(None, None)`` if the run ended."""
    pend = sorted(range(len(spec)), key=lambda i: spec[i][0])
    for step in range(max_steps):
        while pend and spec[pend[0]][0] <= step:
            eng.submit(reqs[pend.pop(0)])
        try:
            n = eng.step()
        except RuntimeError as err:
            return step, str(err)
        if n == 0 and not eng.queue and not eng._swapped and not pend:
            break
    return None, None


@pytest.mark.parametrize("draw", sorted(EXHAUSTING_DRAWS))
@pytest.mark.parametrize("mode", ["off", "swap", "recompute"])
def test_exhausting_pool_raises_in_both_engines(starcoder, mode, draw):
    """Pins a defect of the reference engine that the port reproduces, and
    fixes neither.  The sweep's docstring says a pool of ``ceil(16 /
    page_size)`` pages always progresses, even with preemption off; these
    draws of it disprove that (ROADMAP §3).  Both engines raise the same
    "page pool exhausted" error at the same step under every ``preempt``
    mode, so preemption does not rescue it either."""
    spec, want_step, slot = EXHAUSTING_DRAWS[draw]
    jcfg, tcfg, jparams, tparams = starcoder
    kw = dict(EXHAUSTING, preempt=mode)
    jreqs, treqs = requests(spec, jcfg.vocab_size)
    raised = [_drive_until_raise(JEngine(jcfg, jparams, **kw), jreqs, spec),
              _drive_until_raise(ServingEngine(tcfg, tparams, **kw), treqs,
                                 spec)]
    for step, msg in raised:
        assert step == want_step, raised
        assert msg.startswith(f"page pool exhausted: slot {slot} needs "
                              f"logical page 2"), raised
    assert raised[0] == raised[1]
