"""The port's traffic harness, loadgen CLI and pool reporting API against
the reference's.

* Traces — ``generate_trace`` of the same ``TrafficConfig`` (Poisson;
  diurnal with bursts; explicit class weights with deadlines; the card's
  trace) is equal in both packages field by field, prompts bit for bit,
  and ``save_trace`` writes the same JSON file, which each package loads
  from the other; the draw helpers and the ``validate`` errors match.
* ``drive`` — one seeded trace (starcoder2 smoke, float32, the reference's
  parameters carried across) through an oversubscribed engine of each
  package (swap preemption, aging, a bounded queue, deadlines): after
  every step the engine states, the pool's occupancy figures and the dense
  reservation are equal; at the end the per-request tokens and shed
  reasons, the recorders' stamps, ``report()``, ``format_table()`` and
  ``starved()`` are equal; a run out of ``max_steps`` raises the same
  census error.
* ``ReplicaRouter`` — each rid lands on the same replica index; the fleet
  census is equal on the counters both count the same way and is the sum
  of the replicas'.
* ``fault_soak`` — the same seeded injector schedule converges in both
  packages with zero page leaks, with equal fault-free and soak reports.
* The loadgen CLI — in-process on the CPU: a drive with ``--trace-out``
  whose record (``torch``, no ``jax``) lands under ``chiprun_out/`` of the
  working directory and never in ``BENCH_serving.json``, and the
  ``--soak --replicas 2`` shape; without ``--device`` it needs a card.
* The pool's reporting API — ``occupancy`` of the table, the pool and the
  cache, ``dense_reserved_pages``, ``refill`` (the one-request splice, its
  bytes and accounting) and ``SchedulerStats.calls_saved``.

The reference runs with its kernels off, the port on its plain versions;
both packages' switches are set in a context and restored after it.  Token
streams are compared exactly after checking that the reference never sits
on a near-tie (top-1/top-2 margin above 1e-3).
"""

import contextlib
import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FabricConfig as JFabricConfig  # noqa: E402
from repro.fabric import BurstScheduler as JScheduler  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime.fault_tolerance import FaultInjector as JInjector  # noqa
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import traffic as jtraffic  # noqa: E402
from repro_torch.configs.base import FabricConfig  # noqa: E402
from repro_torch.fabric import (BurstScheduler, Fabric,  # noqa: E402
                                PagedKVCache)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import loadgen  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime import FaultInjector  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import traffic  # noqa: E402
from tests.torch_serving_pairs import pair, record_margins, state  # noqa

ROOT = Path(__file__).resolve().parents[1]

# traces: Poisson; diurnal with bursts; explicit class weights with
# deadlines (some born unmeetable); the trace the card's loadgen phase
# replays through stablelm-1.6b
TRACES = {
    "poisson": dict(seed=3, n_requests=40, deadline_frac=0.5),
    "diurnal-bursts": dict(seed=1, n_requests=100, rate=0.5,
                           arrival="diurnal", burst_prob=0.2,
                           burst_mult=6.0),
    "weights-deadlines": dict(seed=5, n_requests=60, classes=4,
                              class_weights=[0.1, 0.2, 0.3, 0.4],
                              deadline_frac=0.3, deadline_slack=0.8,
                              prompt_min=2, prompt_max=12, gen_max=9),
    "card": dict(seed=0, n_requests=16, arrival="diurnal", rate=0.5,
                 diurnal_period=32, prompt_mean=256, prompt_sigma=0.6,
                 prompt_min=16, prompt_max=448, gen_mean=32, gen_sigma=0.7,
                 gen_min=4, gen_max=64, classes=3, deadline_frac=0.25,
                 deadline_slack=3.0, vocab=100352),
}
# the engine trace: starcoder2 smoke lengths, three classes, deadlines at
# a slack of 1.5 (some become unmeetable while they wait)
ENGINE_TRACE = dict(seed=2, n_requests=10, rate=0.8, prompt_mean=5.0,
                    prompt_max=8, gen_mean=4.0, gen_max=6, classes=3,
                    deadline_frac=0.3, deadline_slack=1.5)
# an oversubscribed engine: a 6-page pool under 2 slots' dense reservation
# of 8, swap preemption, aging, a bounded queue
ENGINE = dict(max_slots=2, page_size=4, pool_pages=6, preempt="swap",
              aging=4, max_queue=4, check_pool=True)
# the fleet: two one-slot replicas on 4-page pools
REPLICA = dict(max_slots=1, page_size=4, pool_pages=4, preempt="swap",
               aging=4, check_pool=True)
# the reference soak test's injector
SOAK = dict(seed=7, horizon=100, p_fail=0.05, p_exhaust=0.1, n_corrupt=1)
# the counters the port and the reference count the same way (the rest
# accumulate per executed step in the port, per traced bucket there)
COMPARABLE = ("preemptions", "swap_bursts", "swap_out_words",
              "swap_in_words", "bursts_retried", "faults_recovered",
              "requests_shed", "shed_queue_full", "shed_deadline",
              "slo_missed_served", "slo_missed_shed", "aging_promotions",
              "prefill_bursts")


@contextlib.contextmanager
def switches():
    """The reference's kernels off, the port's on (their plain versions on
    the CPU), one torch thread; both switches restored after."""
    was, twas = jops.kernels_enabled(), tops.kernels_enabled()
    threads = torch.get_num_threads()
    jops.use_kernels(False)
    tops.use_kernels(True)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        jops.use_kernels(was)
        tops.use_kernels(twas)
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _switches():
    with switches():
        yield


@pytest.fixture(scope="module")
def starcoder():
    return pair("starcoder2-15b")


def _traces(**over):
    """The same config through both packages' generators."""
    return (jtraffic.generate_trace(jtraffic.TrafficConfig(**over)),
            traffic.generate_trace(traffic.TrafficConfig(**over)))


def _assert_traces_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert (x.rid, x.arrival_step, x.max_new_tokens, x.priority,
                x.deadline) == (y.rid, y.arrival_step, y.max_new_tokens,
                                y.priority, y.deadline)
        assert x.prompt.dtype == y.prompt.dtype == np.int32
        np.testing.assert_array_equal(x.prompt, y.prompt)
        assert x.to_json() == y.to_json()


# ---------------------------------------------------------------------------
# traces (no model)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_equal_bit_for_bit(name):
    jt, tt = _traces(**TRACES[name])
    _assert_traces_equal(jt, tt)
    assert traffic.trace_t_max(tt) == jtraffic.trace_t_max(jt)
    if name == "card":
        # the card phase's cache depth sits one past a page of 64
        assert traffic.trace_t_max(tt) == 513
    if "deadline_frac" in TRACES[name]:
        assert any(t.deadline is not None for t in tt)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_traces_load_across_packages(tmp_path, name):
    jt, tt = _traces(**TRACES[name])
    jpath, tpath = tmp_path / "ref.json", tmp_path / "port.json"
    jtraffic.save_trace(str(jpath), jt)
    traffic.save_trace(str(tpath), tt)
    assert jpath.read_bytes() == tpath.read_bytes()
    _assert_traces_equal(jt, traffic.load_trace(str(jpath)))
    _assert_traces_equal(jtraffic.load_trace(str(tpath)), tt)


def test_draw_helpers_match():
    for args in ((10.0, 0.6, 2, 48), (256.0, 0.6, 16, 448), (0.5, 1.2, 1, 9)):
        jr, tr = np.random.default_rng(4), np.random.default_rng(4)
        got = [traffic._clipped_lognormal(tr, *args) for _ in range(200)]
        assert got == [jtraffic._clipped_lognormal(jr, *args)
                       for _ in range(200)]
    for kw in (TRACES["card"], TRACES["diurnal-bursts"], {}):
        jc = jtraffic.TrafficConfig(**kw)
        tc = traffic.TrafficConfig(**kw)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        for step in range(70):
            for burst_left in (0, 2):
                assert (traffic._arrival_rate(tc, step, burst_left)
                        == jtraffic._arrival_rate(jc, step, burst_left))


@pytest.mark.parametrize("bad", [
    dict(arrival="uniform"), dict(classes=0),
    dict(classes=3, class_weights=[1.0]), dict(deadline_frac=1.5),
    dict(deadline_frac=-0.1)])
def test_validate_errors_match(bad):
    with pytest.raises(ValueError) as want:
        jtraffic.TrafficConfig(**bad).validate()
    with pytest.raises(ValueError) as got:
        traffic.TrafficConfig(**bad).validate()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=str(want.value)[:20]):
        traffic.generate_trace(traffic.TrafficConfig(**bad))


# ---------------------------------------------------------------------------
# drive through both engines
# ---------------------------------------------------------------------------

def _observed(eng, seen: list):
    """Wrap ``eng.step``: after every step append its live count, the
    engine's :func:`state` and the pool's reporting figures."""
    step = eng.step

    def observed():
        n = step()
        kv = eng.kv
        seen.append((n, state(eng), kv.occupancy, kv.table.occupancy,
                     kv.pool.occupancy, kv.pool.pages_in_use,
                     kv.dense_reserved_pages))
        assert 0.0 <= kv.occupancy <= 1.0
        for s, req in enumerate(eng.active):
            if req is not None:        # every written position is mapped
                assert (kv.pool.mapped(s)
                        >= kv.table.pages_for(int(eng.pos[s])))
        return n
    eng.step = observed


def _engine_pair(models, **kw):
    jcfg, tcfg, jparams, tparams = models
    return (lambda **extra: JEngine(jcfg, jparams, **kw, **extra),
            lambda **extra: ServingEngine(tcfg, tparams, **kw, **extra))


@pytest.fixture(scope="module")
def driven(starcoder):
    """The engine trace driven through an oversubscribed engine of each
    package, every step observed."""
    jcfg = starcoder[0]
    jt, tt = _traces(**ENGINE_TRACE, vocab=jcfg.vocab_size)
    t_max = traffic.trace_t_max(tt)
    make_j, make_t = _engine_pair(starcoder, t_max=t_max, **ENGINE)
    out = {"trace": tt, "seen": ([], [])}
    with switches(), pytest.MonkeyPatch.context() as mp:
        jeng, teng = make_j(), make_t()
        out["margins"] = record_margins(jeng, mp)
        _observed(jeng, out["seen"][0])
        _observed(teng, out["seen"][1])
        out["jrec"] = jtraffic.drive(jeng, jt, max_steps=500)
        out["trec"] = traffic.drive(teng, tt, max_steps=500)
    out["jeng"], out["teng"] = jeng, teng
    return out


def test_drive_tokens_and_shed_reasons(driven):
    jrec, trec, teng = driven["jrec"], driven["trec"], driven["teng"]
    assert min(driven["margins"]) > 1e-3
    assert set(trec.requests) == set(jrec.requests) == {
        t.rid for t in driven["trace"]}
    for rid, req in trec.requests.items():
        ref = jrec.requests[rid]
        assert req.shed_reason == ref.shed_reason, rid
        assert req.generated == ref.generated, rid
    # the trace exercised every gate: preemption over swap, both shedding
    # reasons, aging
    fs = teng.fabric_stats
    assert fs.preemptions and fs.swap_bursts and fs.aging_promotions
    assert fs.shed_queue_full and fs.shed_deadline
    assert {r.shed_reason for r in trec.requests.values()} == {
        None, "queue_full", "deadline"}


def test_drive_report_table_and_starved(driven):
    jrec, trec = driven["jrec"], driven["trec"]
    assert trec._rec == jrec._rec
    rep = trec.report()
    assert rep == jrec.report()
    assert list(rep) == list(jrec.report())
    assert rep["aggregate"]["shed"] > 0 and rep["aggregate"]["served"] > 0
    assert trec.format_table() == jrec.format_table()
    assert trec.starved() == jrec.starved() == []


def test_drive_state_and_pool_reporting_each_step(driven):
    jseen, tseen = driven["seen"]
    assert len(tseen) == len(jseen) == driven["teng"].step_count
    for i, (a, b) in enumerate(zip(tseen, jseen)):
        assert a == b, i
    # the pool held under the dense reservation and drained clean
    peak = max(s[5] for s in tseen)
    teng = driven["teng"]
    assert 0 < peak <= teng.kv.pool.n_pages < teng.kv.dense_reserved_pages
    assert teng.fabric_stats.prefill_bursts >= 1
    pool = teng.kv.pool
    assert pool.pages_in_use == 0
    assert pool.pages_allocated == pool.pages_reclaimed > 0
    assert teng.kv.occupancy == teng.kv.table.occupancy == 0.0


def test_drive_raises_the_census_when_steps_run_out(starcoder):
    jt, tt = _traces(**ENGINE_TRACE, vocab=starcoder[0].vocab_size)
    make_j, make_t = _engine_pair(starcoder, t_max=traffic.trace_t_max(tt),
                                  **ENGINE)
    with pytest.raises(RuntimeError, match="steps exhausted") as want:
        jtraffic.drive(make_j(), jt, max_steps=4)
    with pytest.raises(RuntimeError, match="steps exhausted") as got:
        traffic.drive(make_t(), tt, max_steps=4)
    assert str(got.value) == str(want.value)
    assert "pool headroom" in str(got.value)


# ---------------------------------------------------------------------------
# the replica router and the fault soak
# ---------------------------------------------------------------------------

def _routes(router) -> list:
    """Wrap ``router.route`` to log ``(rid, replica index)``."""
    log, route = [], router.route

    def logged(req):
        eng = route(req)
        log.append((req.rid, router.engines.index(eng)))
        return eng
    router.route = logged
    return log


@pytest.fixture(scope="module")
def routed(starcoder):
    jt, tt = _traces(**ENGINE_TRACE, vocab=starcoder[0].vocab_size)
    make_j, make_t = _engine_pair(starcoder, t_max=traffic.trace_t_max(tt),
                                  **REPLICA)
    with switches(), pytest.MonkeyPatch.context() as mp:
        jr = jtraffic.ReplicaRouter([make_j(), make_j()])
        tr = traffic.ReplicaRouter([make_t(), make_t()])
        margins = [record_margins(eng, mp) for eng in jr.engines]
        jlog, tlog = _routes(jr), _routes(tr)
        jrec = jtraffic.drive(jr, jt, max_steps=500)
        trec = traffic.drive(tr, tt, max_steps=500)
    return dict(jr=jr, tr=tr, jlog=jlog, tlog=tlog, jrec=jrec, trec=trec,
                margins=[m for ms in margins for m in ms])


def test_router_assigns_each_rid_to_the_same_replica(routed):
    assert routed["tlog"] == routed["jlog"]
    assert {i for _, i in routed["tlog"]} == {0, 1}   # both replicas served
    assert routed["trec"].report() == routed["jrec"].report()
    assert routed["trec"].starved() == []
    assert min(routed["margins"]) > 1e-3
    for rid, req in routed["trec"].requests.items():
        ref = routed["jrec"].requests[rid]
        assert (req.generated, req.shed_reason) == (ref.generated,
                                                    ref.shed_reason), rid


def test_router_fleet_stats(routed):
    jr, tr = routed["jr"], routed["tr"]
    tstats, jstats = tr.stats(), jr.stats()
    assert set(tstats) == set(jstats)
    assert {k: tstats[k] for k in COMPARABLE} == {
        k: jstats[k] for k in COMPARABLE}
    for k, v in tstats.items():
        assert v == sum(getattr(e.fabric_stats, k) for e in tr.engines), k
    for te, je in zip(tr.engines, jr.engines):
        assert state(te) == state(je)
    assert tr.drained and tr.pending_census() == jr.pending_census()
    assert tr.step_count == jr.step_count


@pytest.fixture(scope="module")
def soaked(starcoder):
    jt, tt = _traces(**ENGINE_TRACE, vocab=starcoder[0].vocab_size)
    make_j, make_t = _engine_pair(starcoder, t_max=traffic.trace_t_max(tt),
                                  **dict(ENGINE, max_queue=0))
    out = {}
    with switches():
        out["jinj"] = JInjector.seeded(**SOAK)
        out["tinj"] = FaultInjector.seeded(**SOAK)
        out["j"] = jtraffic.fault_soak(
            lambda fault_injector=None: make_j(fault_injector=fault_injector),
            jt, out["jinj"], max_steps=500)
        out["t"] = traffic.fault_soak(
            lambda fault_injector=None: make_t(fault_injector=fault_injector),
            tt, out["tinj"], max_steps=500)
    return out


def test_fault_soak_converges_with_the_reference(soaked):
    (jref, jsoak, jeng), (tref, tsoak, teng) = soaked["j"], soaked["t"]
    tinj, jinj = soaked["tinj"], soaked["jinj"]
    assert (tinj.fail_at, tinj.exhaust_pool_at) == (jinj.fail_at,
                                                   jinj.exhaust_pool_at)
    assert tref.report() == jref.report()
    assert tsoak.report() == jsoak.report()
    assert tsoak._rec == jsoak._rec
    assert tsoak.starved() == []
    # the soak hit faults, and each package recovered the same ones
    fs = teng.fabric_stats
    assert fs.faults_recovered + fs.bursts_retried + len(
        tinj.exhaust_fired) > 0
    assert (tinj.fired, tinj.exhaust_fired, tinj.corrupted) == (
        jinj.fired, jinj.exhaust_fired, jinj.corrupted)
    assert state(teng) == state(jeng)
    for rid, req in tsoak.requests.items():
        ref = jsoak.requests[rid]
        assert (req.generated, req.shed_reason) == (ref.generated,
                                                    ref.shed_reason), rid


def test_fault_soak_accepts_the_same_shed_in_both_runs(starcoder):
    """A deliberate difference: a request without a deadline shed at a
    full bounded queue in both runs is the same outcome, so the port's soak
    converges; the reference's raises for any such request shed at all."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, starcoder[0].vocab_size, 5, dtype=np.int32)
               for _ in range(3)]
    jt = [jtraffic.TraceRecord(i, 0, p, 3) for i, p in enumerate(prompts)]
    tt = [traffic.TraceRecord(i, 0, p, 3) for i, p in enumerate(prompts)]
    make_j, make_t = _engine_pair(starcoder, t_max=traffic.trace_t_max(tt),
                                  max_slots=1, page_size=4, max_queue=1,
                                  check_pool=True)
    ref, soak, _ = traffic.fault_soak(
        lambda fault_injector=None: make_t(fault_injector=fault_injector),
        tt, FaultInjector(), max_steps=50)
    assert [ref.requests[i].shed_reason for i in range(3)] == [
        None, "queue_full", "queue_full"]
    assert soak.report() == ref.report()
    with pytest.raises(AssertionError, match="shed in one run only"):
        jtraffic.fault_soak(
            lambda fault_injector=None: make_j(fault_injector=fault_injector),
            jt, JInjector(), max_steps=50)


# ---------------------------------------------------------------------------
# the loadgen CLI
# ---------------------------------------------------------------------------

def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_loadgen_cli_drive_writes_its_own_record(tmp_path, monkeypatch,
                                                 capsys):
    bench = ROOT / "BENCH_serving.json"
    before = _digest(bench)
    monkeypatch.chdir(tmp_path)
    trace = tmp_path / "trace.json"
    loadgen.main(["--smoke", "--device", "cpu", "--requests", "8",
                  "--rate", "0.8", "--aging", "6", "--max-queue", "6",
                  "--deadline-frac", "0.3", "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "aggregate" in out and "degradation census" in out
    assert "STARVED" not in out
    with open(tmp_path / "chiprun_out" / "loadgen_serving.json") as f:
        runs = json.load(f)["runs"]
    assert len(runs) == 1 and runs[0]["mode"] == "drive"
    run = runs[0]
    assert run["torch"] == torch.__version__ and "jax" not in run
    assert run["device"] == "cpu" and "card" not in run
    assert "aggregate" in run["cells"] and "census" in run["cells"]
    # the saved trace is the reference's for the same flags
    cfg = loadgen.get_smoke("starcoder2-15b")
    want = jtraffic.generate_trace(jtraffic.TrafficConfig(
        seed=0, n_requests=8, rate=0.8, prompt_mean=10.0, prompt_max=24,
        gen_mean=8.0, gen_max=16, classes=3, deadline_frac=0.3,
        deadline_slack=3.0, vocab=cfg.vocab_size))
    _assert_traces_equal(want, jtraffic.load_trace(str(trace)))
    assert _digest(bench) == before


def test_loadgen_cli_soak_replicas(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    loadgen.main(["--smoke", "--device", "cpu", "--requests", "8",
                  "--rate", "0.8", "--replicas", "2", "--pool-pages", "10",
                  "--preempt", "swap", "--soak", "--soak-p-fail", "0.05",
                  "--soak-p-exhaust", "0.1", "--no-bench"])
    out = capsys.readouterr().out
    assert "fault soak: token-exact" in out and "STARVED" not in out
    assert not (tmp_path / "chiprun_out").exists()


def test_loadgen_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.main(["--smoke", "--requests", "2", "--no-bench"])


# ---------------------------------------------------------------------------
# the pool's reporting API
# ---------------------------------------------------------------------------

def test_refill_splice_bytes_and_accounting():
    """The one-request splice on the dense layout: the reference's
    ``tests/test_paged_pool.py`` accounting sequence, with random request
    caches so the spliced bytes compare too."""
    jcfg, tcfg = pair("starcoder2-15b")[:2]
    rng = np.random.default_rng(3)
    jkv = JPagedKVCache(japi.init_cache(jcfg, 2, 32), max_slots=2, t_max=32,
                        page_size=8)
    tkv = PagedKVCache(api.init_cache(tcfg, 2, 32, device="cpu"),
                       max_slots=2, t_max=32, page_size=8)

    def req():
        leaves = {n: rng.standard_normal((2, 1, 32, 2, 16)).astype(
            np.float32) for n in ("k", "v")}
        return ({"unit": [{n: jnp.asarray(a) for n, a in leaves.items()}],
                 "tail": []},
                {"unit": [{n: torch.from_numpy(a.copy())
                           for n, a in leaves.items()}], "tail": []})

    def same():
        assert (tkv.tokens_moved, tkv.tokens_moved_dense) == (
            jkv.tokens_moved, jkv.tokens_moved_dense)
        assert tkv.table.used.tolist() == jkv.table.used.tolist()
        assert tkv.table.occupancy == jkv.table.occupancy == tkv.occupancy
        assert tkv.dense_reserved_pages == jkv.dense_reserved_pages == 8
        for n in ("k", "v"):
            np.testing.assert_array_equal(
                tkv.caches["unit"][0][n].numpy().view(np.uint32),
                np.asarray(jkv.caches["unit"][0][n]).view(np.uint32))

    for op, slot, n_tok in (("refill", 0, 9), ("extend", 0, 20),
                            ("free", 0, 0), ("refill", 0, 5),
                            ("refill", 1, 5), ("free", 1, 0),
                            ("refill", 1, 30)):
        if op == "refill":
            jreq, treq = req()
            jkv.refill(slot, jreq, n_tokens=n_tok)
            tkv.refill(slot, treq, n_tokens=n_tok)
        elif op == "extend":
            jkv.extend(slot, n_tok)
            tkv.extend(slot, n_tok)
        else:
            jkv.free(slot)
            tkv.free(slot)
        same()
    assert tkv.tokens_moved_dense == 32 + 20 + 32 + 32
    assert tkv.prefill_splices == 0 and tkv.prefill_bursts == 0


def test_calls_saved_matches_reference():
    """Five dense streams of two dtypes in one burst: two network calls for
    five streams in both packages (both with the kernels off, so the
    ``kernel_bursts`` counts agree too)."""
    tops.use_kernels(False)
    rng = np.random.default_rng(9)
    n = 4
    jsched = JScheduler(JFabric(JFabricConfig(n_ports=n, lane_width=8)))
    tsched = BurstScheduler(Fabric(FabricConfig(n_ports=n, lane_width=8)))
    for i, (shape, dtype) in enumerate(
            [((2 * n, n, 3), np.float32), ((n, n, 5), np.float32),
             ((n, n, 2), np.float32), ((2 * n, n, 4), np.int32),
             ((n, n, 6), np.int32)]):
        a = (rng.standard_normal(shape) * 100).astype(dtype)
        jsched.enqueue_read(f"s{i}", jnp.asarray(a))
        tsched.enqueue_read(f"s{i}", torch.from_numpy(a.copy()))
    jsched.issue()
    tsched.issue()
    jsched.commit()
    tsched.commit()
    assert dataclasses.asdict(tsched.stats) == dataclasses.asdict(
        jsched.stats)
    assert tsched.stats.calls_saved == jsched.stats.calls_saved == 3


def test_serve_cli_reports_the_dense_reservation(monkeypatch, capsys):
    from repro_torch.launch import serve

    built = []

    def engine(*args, **kwargs):
        built.append(ServingEngine(*args, **kwargs))
        return built[-1]
    monkeypatch.setattr(serve, "ServingEngine", engine)
    serve.main(["--arch", "starcoder2-15b", "--smoke", "--device", "cpu",
                "--engine", "--batch", "2", "--prompt-len", "6",
                "--gen-len", "3", "--page-size", "4", "--pool-pages", "4"])
    kv = built[0].kv
    assert kv.dense_reserved_pages == 2 * kv.table.pages_per_slot > 4
    assert (f"page pool: 4 physical pages x 4 timesteps (dense reservation "
            f"{kv.dense_reserved_pages} pages)") in capsys.readouterr().out
