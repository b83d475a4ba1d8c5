"""The port engine's admission control against the reference's: the
bounded submit queue, SLO load shedding (at submit and while waiting),
anti-starvation aging, the never-servable refusals, ``run_to_completion``'s
census, the lifecycle recorder, and the serve CLI's new flags.

A scripted trace on the starcoder2 smoke (float32, the reference's
parameters carried across, a 7-page pool, 2 slots) with deadlines is
stepped through both engines in lockstep: every ``submit`` returns the same
(``"queued"`` or ``"shed"``, the same ``shed_reason``), and after every
step the page tables, slots, queue, parked set, the shedding, SLO, aging
and preemption counters, ``slo_misses`` and ``pending_census()`` are
equal; so are the recorders' ``(event, rid, step)`` sequences and the
served token streams (after the reference's near-tie check)."""

import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from tests.torch_serving_pairs import lockstep, pair, prompt  # noqa: E402

# (arrival step, prompt length, max_new_tokens, priority, deadline): two
# long low-priority requests fill the slots; a deadline no schedule can
# meet; a burst that overflows the bounded queue; deadlines that become
# unmeetable while their requests wait; higher classes that preempt
TRACE = [(0, 7, 8, 0, None), (0, 8, 8, 0, None),
         (1, 6, 6, 1, 3),
         (1, 5, 4, 0, 14), (1, 6, 5, 0, None), (2, 5, 4, 1, 9),
         (2, 4, 3, 0, None), (2, 6, 4, 0, None),
         (3, 6, 6, 2, 20), (4, 6, 3, 0, 12), (6, 7, 5, 2, None),
         (7, 5, 6, 1, 11)]


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


class Recorder:
    """A lifecycle observer: every call as ``(event, rid, step[, reason])``."""

    def __init__(self):
        self.events = []

    def record_admit(self, req, step):
        self.events.append(("admit", req.rid, step))

    def record_first_token(self, req, step):
        self.events.append(("first_token", req.rid, step))

    def record_retire(self, req, step):
        self.events.append(("retire", req.rid, step))

    def record_shed(self, req, step, reason):
        self.events.append(("shed", req.rid, step, reason))


@pytest.mark.parametrize("kw", [
    dict(preempt="swap", aging=3, max_queue=3),     # every gate on
    dict(preempt="off", aging=0, max_queue=0)],     # the tight SLO floor
    ids=["swap-aging-bounded", "off-strict"])
def test_admission_control_matches_reference(starcoder, kw, monkeypatch):
    recs = (Recorder(), Recorder())
    jeng, teng, jreqs, treqs, submitted, margins = lockstep(
        starcoder, TRACE, monkeypatch, recorders=recs, pool_pages=7, **kw)
    assert min(margins) > 1e-3, margins
    assert recs[1].events == recs[0].events
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    st = teng.fabric_stats
    assert st.requests_shed == st.shed_queue_full + st.shed_deadline > 0
    assert st.shed_deadline > 0 and teng.slo_misses > 0
    shed = [i for i, how in submitted if how == "shed"]
    assert shed and all(treqs[i].shed_reason for i in shed)
    assert {e[0] for e in recs[1].events} == {
        "admit", "first_token", "retire", "shed"}
    if kw["max_queue"]:
        assert st.shed_queue_full > 0
        assert st.aging_promotions > 0 and st.preemptions > 0
    else:
        assert st.shed_queue_full == st.aging_promotions == 0
        assert st.preemptions == 0


def test_never_servable_requests_raise_and_are_counted(starcoder):
    """``submit`` raises for a prompt the cache cannot decode and for a
    reach beyond the whole pool, counting the shed (and the SLO miss of a
    deadlined request) first, as the reference does."""
    jcfg, tcfg, jparams, tparams = starcoder
    kw = dict(max_slots=2, t_max=16, page_size=4, pool_pages=2)
    counts = []
    for eng, req_t in ((JEngine(jcfg, jparams, **kw), JRequest),
                       (ServingEngine(tcfg, tparams, **kw), Request)):
        assert eng.submit(req_t(0, prompt(0, 5, jcfg.vocab_size),
                                max_new_tokens=2)) == "queued"
        with pytest.raises(ValueError, match="cannot decode"):
            eng.submit(req_t(1, prompt(1, 16, jcfg.vocab_size),
                             max_new_tokens=1, deadline=4))
        with pytest.raises(ValueError, match="block the queue forever"):
            eng.submit(req_t(2, prompt(2, 9, jcfg.vocab_size),
                             max_new_tokens=6))
        st = eng.fabric_stats
        counts.append((st.requests_shed, st.slo_missed_shed, eng.slo_misses,
                       len(eng.queue), eng.pending_census()))
    assert counts[1] == counts[0] == (2, 1, 1, 1, counts[0][4])


def test_run_to_completion_raises_with_the_census(starcoder):
    jcfg, tcfg, jparams, tparams = starcoder
    kw = dict(max_slots=1, t_max=24, page_size=4)
    msgs = []
    for eng, req_t in ((JEngine(jcfg, jparams, **kw), JRequest),
                       (ServingEngine(tcfg, tparams, **kw), Request)):
        for i in range(2):
            eng.submit(req_t(i, prompt(i, 5, jcfg.vocab_size),
                             max_new_tokens=6, priority=i))
        with pytest.raises(RuntimeError, match="steps exhausted") as err:
            eng.run_to_completion(max_steps=2)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]
    assert "live {class1: 1}, queued {class0: 1}, swapped {}" in msgs[1]
    eng.run_to_completion(max_steps=64)           # and then it can finish
    assert eng.drained


def test_engine_options_are_checked():
    _, tcfg, _, tparams = pair("starcoder2-15b", key="churn")
    for kw, what in ((dict(preempt="evict"), "preempt"),
                     (dict(aging=-1), "aging"),
                     (dict(max_queue=-2), "max_queue")):
        with pytest.raises(ValueError, match=what):
            ServingEngine(tcfg, tparams, max_slots=2, t_max=16, **kw)


def test_serve_cli_oversubscribed(capsys):
    """The serve CLI with the preemption, admission and speculative-decode
    flags: it serves every request and prints the three censuses."""
    from repro_torch.launch import serve
    serve.main(["--arch", "starcoder2-15b", "--smoke", "--device", "cpu",
                "--engine", "--priority-classes", "3", "--batch", "4",
                "--prompt-len", "8", "--gen-len", "6", "--page-size", "4",
                "--pool-pages", "6", "--preempt", "swap", "--aging", "4",
                "--max-queue", "8", "--spec-decode-k", "2", "--check-pool"])
    out = capsys.readouterr().out
    assert "served 4 requests, 24 tokens" in out
    assert "0 in use at exit" in out
    assert "preemption[swap]: " in out
    assert "admission: 0 shed (0 queue-full, 0 unmeetable-deadline)" in out
    assert "speculative decode[k=2]: " in out
