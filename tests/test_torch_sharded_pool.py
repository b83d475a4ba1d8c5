"""The port's sharded page pool against the JAX package, in one process.

The reference shards its pool over a ``pool`` axis of forced host devices
in subprocesses (``tests/test_sharded_pool.py``); the port keeps every
shard on one device and runs the two hops per shard in turn, so these
tests need no subprocess, no process group and no socket:

* ``shard_plan`` is the reference's, array for array, sentinels and
  duplicates included, and refuses with its messages;
* the three collectives agree with each other and with a hand-built block
  transpose, bit for bit on bfloat16 NaN payloads;
* the sharded read and write bursts (through the scheduler, at every
  shard count, collective, kernel switch and word fold) move exactly the
  bits of the reference's single-device ``Fabric.read_burst(indices=)`` /
  ``write_burst(indices=, into=)`` on the same pool (the reference moves
  the payload's integer words, as XLA:CPU quiets bfloat16 NaN payloads);
  the write lands in the pool stream's own storage; every operand that
  reaches a kernel wrapper is contiguous and every row a shard's hop names
  lies in that shard's block; the scheduler's counters are the
  reference's formulas fed by the reference's plan;
* the engine at 2 and 4 shards, with both collectives, serves the
  reference churn trace with the tokens of the reference's unsharded
  engine, and step for step with the pool bytes, page tables, per-shard
  free lists and round-robin cursor of the port's single-device lowering
  on the same striped allocator; its pool rounding and ``live_bucket`` are
  the reference engine's; the serve CLI reports the exchanges and serves
  the ``--pool-shards 1`` tokens.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.serving.engine as jengine_mod  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric import shard_plan as jshard_plan  # noqa: E402
from repro.fabric.scheduler import BurstScheduler as JScheduler  # noqa: E402
from repro.fabric.sharded import \
    pool_partition_spec as jpool_partition_spec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs.base import FabricConfig  # noqa: E402
from repro_torch.fabric import (FRAME_SENTINEL, BurstScheduler,  # noqa: E402
                                Fabric, PagePool, make_pool_mesh,
                                pool_partition_spec, shard_plan)
from repro_torch.kernels import medusa_transpose as mt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import compat_mesh  # noqa: E402
from repro_torch.parallel import (ring_all_gather,  # noqa: E402
                                  ring_all_to_all, xla_all_to_all)
from repro_torch.serving import ServingEngine  # noqa: E402

from tests import torch_serving_pairs as tsp  # noqa: E402

# the burst geometry: N ports of W payload lanes, R layer reps of an
# F-frame pool, K live-frame requests a step
N, W, F, R, K = 4, 8, 32, 3, 16
WORD = {1: np.uint8, 2: np.int16, 4: np.int32}


@pytest.fixture(autouse=True)
def _kernel_switches():
    torch.set_num_threads(1)
    jwas, twas = jops.kernels_enabled(), tops.kernels_enabled()
    jops.use_kernels(False)
    yield
    jops.use_kernels(jwas)
    tops.use_kernels(twas)


def _words(t: torch.Tensor) -> np.ndarray:
    """Same-width integer view of a CPU tensor."""
    a = t.contiguous()
    return a.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[a.element_size()]).numpy()


# ---------------------------------------------------------------------------
# the host plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", (1, 2, 4, 8))
@pytest.mark.parametrize("reps", (1, 3))
@pytest.mark.parametrize("cap_bucket", (0, 6))
def test_shard_plan_is_the_reference(shards, reps, cap_bucket):
    """Churny index lists (shuffled, a duplicate frame, sentinel padding):
    every array and count of the plan is the reference's."""
    rng = np.random.RandomState(11 * shards + reps + cap_bucket)
    frames, n = 64, 4
    k = 48
    while (reps * k) % (shards * n):
        k += 1
    idx = rng.randint(0, frames, size=k).astype(np.int64)
    idx[rng.permutation(k)[:7]] = FRAME_SENTINEL
    idx[1] = idx[0]
    got = shard_plan(idx, frames, shards, n, reps=reps, cap_bucket=cap_bucket)
    want = jshard_plan(idx, frames, shards, n, reps=reps,
                       cap_bucket=cap_bucket)
    for f in ("fetch", "place"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert (got.k_tot, got.cap, got.cross_frames, got.local_frames,
            got.n_shards) == (want.k_tot, want.cap, want.cross_frames,
                              want.local_frames, want.n_shards)
    fetch, place = got.operands("cpu")
    assert fetch.dtype == place.dtype == torch.int32
    np.testing.assert_array_equal(fetch.numpy(), want.fetch)


@pytest.mark.parametrize("args", [
    (np.arange(10), 16, 2, 4),          # 10 lines into 2 blocks of N=4
    (np.arange(16), 15, 2, 4),          # 15 frames into 2 shards
    (np.arange(16), 16, 0, 4)])         # no shard
def test_shard_plan_refuses_as_the_reference(args):
    with pytest.raises(ValueError) as want:
        jshard_plan(*args)
    with pytest.raises(ValueError) as got:
        shard_plan(*args)
    assert str(got.value) == str(want.value)


def test_partition_spec_and_mesh():
    for ndim in (4, 5, 6):
        assert pool_partition_spec(ndim) == tuple(jpool_partition_spec(ndim))
    for spec in (pool_partition_spec, jpool_partition_spec):
        with pytest.raises(ValueError, match="rank 3 is too small"):
            spec(3)
    mesh = make_pool_mesh(4, "cpu")
    assert mesh.size == 4 and mesh.axis == "pool"
    assert mesh.devices == (torch.device("cpu"),) * 4
    with pytest.raises(NotImplementedError, match="item 8c"):
        compat_mesh(["cpu", "meta"], (2,), ("pool",))


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", (1, 2, 3, 4, 5))
def test_collectives_are_one_block_transpose(shards):
    """``ring_all_to_all`` (S-1 rotations) == ``xla_all_to_all`` == the
    block transpose ``out[r][o] = send[o][r]``, on bfloat16 words full of
    NaN payloads and -0.0; ``ring_all_gather`` == every rank's tensor in
    rank order."""
    rng = np.random.RandomState(shards)
    raw = rng.randint(-2 ** 15, 2 ** 15, size=(shards, shards, 3, 5),
                      dtype=np.int64).astype(np.int16)
    raw[..., 0] = 0x7F81                # a NaN with a payload
    raw[..., 1] = 0xFF81 - 0x10000      # its negative twin
    raw[..., 2] = -0x8000               # -0.0
    send = [torch.from_numpy(raw[d].copy()).view(torch.bfloat16)
            for d in range(shards)]
    want = [raw[:, r] for r in range(shards)]
    for fn in (ring_all_to_all, xla_all_to_all):
        out = fn(send)
        assert len(out) == shards
        for r in range(shards):
            assert out[r].dtype == torch.bfloat16
            np.testing.assert_array_equal(_words(out[r]), want[r])
    gathered = ring_all_gather([s[0] for s in send])
    for r in range(shards):
        np.testing.assert_array_equal(_words(gathered[r]),
                                      raw[:, 0].reshape(-1, 5))


def test_ring_takes_s_minus_1_rotations(monkeypatch):
    from repro_torch.parallel import collectives
    steps = []
    rotate = collectives._ppermute
    monkeypatch.setattr(collectives, "_ppermute",
                        lambda xs, shift: (steps.append(shift),
                                           rotate(xs, shift))[1])
    ring_all_to_all([torch.zeros(4, 2) for _ in range(4)])
    assert steps == [1, 2, 3]


# ---------------------------------------------------------------------------
# the sharded bursts against the reference's single-device bursts
# ---------------------------------------------------------------------------

def _pool(dtype: torch.dtype, seed: int) -> torch.Tensor:
    """A ``[R, F, N, W]`` pool stream of random words (bfloat16 words hold
    NaN payloads too)."""
    size = torch.tensor([], dtype=dtype).element_size()
    info = np.iinfo(WORD[size])
    raw = np.random.RandomState(seed).randint(
        info.min, int(info.max) + 1, size=(R, F, N, W),
        dtype=np.int64).astype(WORD[size])
    return torch.from_numpy(raw).view(dtype)


def _live(unique: bool, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if unique:                                  # a write never maps twice
        idx = rng.permutation(F)[:K].astype(np.int64)
    else:
        idx = rng.randint(0, F, size=K).astype(np.int64)
        idx[3] = idx[2]                         # a duplicate frame read
    idx[rng.permutation(K)[:3]] = FRAME_SENTINEL
    return idx.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(dtype_name: str):
    """The reference's single-device sparse read and write on the pool's
    words: ``(pool words, read idx, banked read, write idx, update words,
    pool after the write)``."""
    dtype = getattr(torch, dtype_name)
    pool = _words(_pool(dtype, 1))
    upd_t = _pool(dtype, 2)[:, :K].reshape(R * K // N, N, N, W)
    upd = _words(upd_t)
    jfab = JFabric.make(N, "medusa")
    lines = jnp.asarray(pool.reshape(R * F, N, W))
    ridx, widx = _live(False, 3), _live(True, 4)
    read = jfab.read_burst(lines, indices=jcm.pool_rep_indices(
        jnp.asarray(ridx), R, F))
    wrote = jfab.write_burst(jnp.asarray(upd), indices=jcm.pool_rep_indices(
        jnp.asarray(widx), R, F), into=lines)
    return (pool, ridx, np.asarray(read), widx, upd_t, upd,
            np.asarray(wrote).reshape(R, F, N, W))


def _fabric(shards: int, collective: str) -> Fabric:
    cfg = FabricConfig(n_ports=N, lane_width=W, pool_shards=shards,
                       collective=collective).validate()
    return Fabric(cfg, mesh=make_pool_mesh(shards, "cpu"))


def _run_bursts(shards, collective, fold, dtype):
    """One sharded read and one sharded write through a scheduler; returns
    the read's banked words, the pool stream after the write (its storage
    checked unchanged), the scheduler's stats and the reference's data."""
    pool_w, ridx, ref_read, widx, upd_t, _, ref_wrote = _reference(
        str(dtype).split(".")[-1])
    stream = torch.from_numpy(pool_w.copy()).view(dtype)
    sched = BurstScheduler(_fabric(shards, collective), word_fold=fold)
    rplan = shard_plan(ridx, F, shards, N, reps=R)
    sched.enqueue_read("kv/read", stream,
                       shard=rplan.operands("cpu") + (rplan.k_tot,))
    read = sched.flush()["kv/read"]
    wplan = shard_plan(widx, F, shards, N, reps=R)
    into = stream.clone()
    ptr = into.data_ptr()
    sched.enqueue_write("kv/write", upd_t, into=into,
                        shard=wplan.operands("cpu") + (wplan.k_tot,))
    out = sched.flush()["kv/write"]
    assert out is into and into.data_ptr() == ptr
    assert read.dtype == dtype and read.shape == (R * K // N, N, N, W)
    return _words(read), _words(into), sched.stats, ref_read, ref_wrote


@pytest.mark.parametrize("shards", (1, 2, 4))
@pytest.mark.parametrize("collective", ("all_to_all", "ring"))
@pytest.mark.parametrize("kernels", (True, False))
@pytest.mark.parametrize("fold,dtype", [
    (1, torch.bfloat16), (2, torch.bfloat16), (4, torch.uint8)])
def test_sharded_bursts_match_single_device(shards, collective, kernels,
                                            fold, dtype):
    tops.use_kernels(kernels)
    read, wrote, stats, ref_read, ref_wrote = _run_bursts(
        shards, collective, fold, dtype)
    np.testing.assert_array_equal(read, ref_read)
    np.testing.assert_array_equal(wrote, ref_wrote)
    assert stats.kernel_bursts == (2 if kernels else 0)


@pytest.mark.parametrize("shards", (2, 4))
@pytest.mark.parametrize("fold,dtype", [
    (1, torch.bfloat16), (4, torch.bfloat16), (4, torch.uint8)])
def test_sharded_counters_are_the_reference_formulas(shards, fold, dtype):
    """Per sharded stream: one network call, one collective, one fused
    burst, one kernel burst, ``G*N*N*w`` words moved, the reference's
    fold, and ``S*(S-1)*cap*N*w`` words across shards with ``cap`` from the
    reference's plan."""
    tops.use_kernels(True)
    _, _, st, _, _ = _run_bursts(shards, "ring", fold, dtype)
    _, ridx, _, widx, _, _, _ = _reference(str(dtype).split(".")[-1])
    jdt = jnp.dtype(str(dtype).split(".")[-1])
    f = JScheduler(JFabric.make(N, "medusa"), word_fold=fold)._fold_factor(
        jdt, lambda x: W % x == 0)
    elems = R * K * N * W
    cross = sum(shards * (shards - 1) * jshard_plan(i, F, shards, N,
                                                    reps=R).cap * N * W
                for i in (ridx, widx))
    assert (st.streams_served, st.flushes, st.network_calls,
            st.collective_calls, st.gather_fused_bursts,
            st.kernel_bursts) == (2, 2, 2, 2, 2, 2)
    assert st.words_moved == st.words_live == 2 * elems
    assert st.words_folded == 2 * (elems - elems // f)
    assert st.words_cross_shard == cross > 0


def test_every_kernel_operand_is_contiguous_and_owned(monkeypatch):
    """At R = 3 layer reps each shard's block of the stream is strided;
    the local hops address the whole stream instead: every tensor reaching
    kernels 1-2 is contiguous, each shard's hop names only rows of its own
    block (or sentinels), and there is one launch per shard per stream."""
    tops.use_kernels(True)
    shards = 4
    calls = []
    gather, scatter = mt.gather_burst_network_tiles, \
        mt.scatter_burst_network_tiles

    def gather_spy(lines, idx, n):
        calls.append(("gather", idx.clone(), lines.shape[0],
                      lines.is_contiguous() and idx.is_contiguous()))
        return gather(lines, idx, n)

    def scatter_spy(banked, idx, into, n):
        calls.append(("scatter", idx.clone(), into.shape[0],
                      all(t.is_contiguous() for t in (banked, idx, into))))
        return scatter(banked, idx, into, n)
    monkeypatch.setattr(mt, "gather_burst_network_tiles", gather_spy)
    monkeypatch.setattr(mt, "scatter_burst_network_tiles", scatter_spy)
    _run_bursts(shards, "all_to_all", 2, torch.bfloat16)
    assert [c[0] for c in calls] == ["gather"] * shards + \
        ["scatter"] * shards
    f_loc = F // shards
    for i, (_, idx, lines, contiguous) in enumerate(calls):
        assert contiguous and lines == R * F
        rows = idx[idx != FRAME_SENTINEL].long()
        assert rows.numel() > 0
        assert bool((rows % F // f_loc == i % shards).all())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

POOL_PAGES = 8         # divides into 2 and 4 shard blocks


def _submit_due(step, spec, reqs, engines):
    for i, (arrival, *_) in enumerate(spec):
        if arrival == step:
            for eng, rs in zip(engines, reqs):
                eng.submit(rs[i])


@pytest.fixture(scope="module")
def reference_run():
    """The reference's unsharded engine over the churn trace, with its
    top-1/top-2 margins (tokens compare exactly only far from a tie)."""
    mp = pytest.MonkeyPatch()
    was = jops.kernels_enabled()
    jops.use_kernels(False)
    try:
        models = tsp.pair("stablelm-1.6b", key="churn")
        jeng = JEngine(models[0], models[2], pool_pages=POOL_PAGES,
                       check_pool=True, **tsp.CHURN)
        margins = tsp.record_margins(jeng, mp)
        jreqs, _ = tsp.requests(tsp.SPEC, models[0].vocab_size)
        for step in range(200):
            _submit_due(step, tsp.SPEC, [jreqs], [jeng])
            if jeng.step() == 0 and jeng.drained and step > tsp.SPEC[-1][0]:
                break
        assert jeng.drained
        return models, [r.generated for r in jreqs], margins
    finally:
        mp.undo()
        jops.use_kernels(was)


def _leaf_words(eng):
    return [_words(leaf) for _, _, _, leaf in eng._cache_leaves()]


FAULTS = dict(fail_at=(3, 9), exhaust_pool_at=(5,), corrupt_swap=(0,))


@pytest.mark.parametrize("shards,collective,extra", [
    (2, "all_to_all", {}),
    (2, "ring", {}),
    (4, "all_to_all", {}),
    (4, "ring", {}),
    (2, "ring", dict(faults=True)),
    (4, "all_to_all", dict(prefill_burst=False))],
    ids=["2-a2a", "2-ring", "4-a2a", "4-ring", "2-ring-faults",
         "4-a2a-splice"])
def test_sharded_engine_serves_the_reference_tokens(reference_run, shards,
                                                    collective, extra):
    """The churn trace (priorities, preemption by swap; with mid-step
    faults and a corrupted swap, or splice admission) on the sharded
    engine and on the single-device lowering over the same striped
    allocator (the port's 1-shard engine with ``PagePool(n_shards=S)``),
    in lockstep: after every step the pool bytes of every leaf, the page
    table, the per-shard free lists and the round-robin cursor are equal;
    at the end every token equals the reference's unsharded engine's, every
    counter the two lowerings share is equal, and the exchanges and the
    words across shards are the reference's formulas fed by the
    reference's plans of the steps."""
    from repro_torch.runtime import FaultInjector
    models, ref_tokens, margins = reference_run
    assert min(margins) > 1e-3, margins
    _, tcfg, _, tparams = models
    extra = dict(extra)
    faults = extra.pop("faults", False)
    kw = dict(tsp.CHURN, pool_pages=POOL_PAGES, check_pool=True, **extra)
    sharded = ServingEngine(
        tcfg, tparams, pool_shards=shards, collective=collective,
        fault_injector=FaultInjector(**FAULTS) if faults else None, **kw)
    single = ServingEngine(
        tcfg, tparams,
        fault_injector=FaultInjector(**FAULTS) if faults else None, **kw)
    pool = single.kv.pool
    single.kv.pool = PagePool(pool.page_size, pool.n_pages,
                              pool.pages_per_slot, single.max_slots,
                              n_shards=shards)
    assert sharded.kv.pool.n_shards == shards and sharded.fabric.pool_sharded
    assert sharded.live_bucket == single.live_bucket
    assert not single.fabric.pool_sharded
    live_sets = []
    plans = sharded.shard_plans
    sharded.shard_plans = lambda live_idx: (
        live_sets.append(np.array(live_idx)), plans(live_idx))[1]
    reqs = [tsp.requests(tsp.SPEC, tcfg.vocab_size)[1] for _ in range(2)]
    for step in range(200):
        _submit_due(step, tsp.SPEC, reqs, [sharded, single])
        n = sharded.step()
        assert single.step() == n, step
        a, b = sharded.kv.pool, single.kv.pool
        np.testing.assert_array_equal(a.table, b.table)
        assert a._free_by_shard == b._free_by_shard and a._rr == b._rr
        for x, y in zip(_leaf_words(sharded), _leaf_words(single)):
            np.testing.assert_array_equal(x, y)
        if n == 0 and sharded.drained and step > tsp.SPEC[-1][0]:
            break
    assert sharded.drained and single.drained
    assert [r.generated for r in reqs[0]] == ref_tokens
    assert [r.generated for r in reqs[1]] == ref_tokens
    st, st1 = sharded.fabric_stats, single.fabric_stats
    if faults:
        assert st.faults_recovered == 2 and st.bursts_retried == 1
    assert st.preemptions > 0 and st.swap_bursts > 0
    for f in dataclasses.fields(st):
        if f.name not in ("collective_calls", "words_cross_shard"):
            assert getattr(st, f.name) == getattr(st1, f.name), f.name
    # K and V of each paged leaf, read and written, once per decode step
    entries = sharded.kv.paged_entries
    d = tcfg.resolved_head_dim
    frames = sharded.kv.pool.n_pages * sharded.page_size
    assert st.collective_calls == 4 * len(entries) * len(live_sets) > 0
    assert st.words_cross_shard == sum(
        4 * shards * (shards - 1) * N * d * jshard_plan(
            live, frames, shards, N, reps=reps,
            cap_bucket=sharded.page_size).cap
        for live in live_sets for reps in sharded._shard_reps) > 0


@pytest.mark.parametrize("geometry", [
    dict(max_slots=2, t_max=24, page_size=4, shards=2),
    dict(max_slots=3, t_max=20, page_size=4, shards=4),
    dict(max_slots=3, t_max=21, page_size=6, shards=4),
    dict(max_slots=2, t_max=16, page_size=3, shards=2, pool_pages=5)])
def test_engine_sizing_is_the_reference(monkeypatch, geometry):
    """Pool rounding, ``live_bucket``, the rep counts planned and the shard
    blocks equal the reference engine's (its mesh builder stubbed: it
    would ask for forced host devices)."""
    monkeypatch.setattr(jengine_mod, "make_pool_mesh", lambda s: None)
    g = dict(geometry)
    shards = g.pop("shards")
    jcfg, tcfg, jparams, tparams = tsp.pair("stablelm-1.6b")
    jeng = JEngine(jcfg, jparams, pool_shards=shards, **g)
    teng = ServingEngine(tcfg, tparams, pool_shards=shards, **g)
    assert (teng.kv.pool.n_pages, teng.live_bucket, teng._shard_reps,
            teng.kv.pool.n_shards, teng.pool_shards) == (
        jeng.kv.pool.n_pages, jeng.live_bucket, jeng._shard_reps,
        jeng.kv.pool.n_shards, jeng.pool_shards)
    assert teng.fabric.config == dataclasses.replace(
        teng.fabric.config, **dataclasses.asdict(jeng.fabric.config))


def test_engine_refuses_a_sharded_pool_without_the_fused_contract(
        monkeypatch):
    monkeypatch.setattr(jengine_mod, "make_pool_mesh", lambda s: None)
    jcfg, tcfg, jparams, tparams = tsp.pair("stablelm-1.6b")
    for kw in (dict(fused_gather=False), dict(paged_pool=False)):
        with pytest.raises(ValueError) as want:
            JEngine(jcfg, jparams, max_slots=2, t_max=16, pool_shards=2,
                    **kw)
        with pytest.raises(ValueError) as got:
            ServingEngine(tcfg, tparams, max_slots=2, t_max=16,
                          pool_shards=2, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="collective"):
        ServingEngine(tcfg, tparams, max_slots=2, t_max=16, pool_shards=2,
                      collective="butterfly")


def test_serve_cli_pool_shards(monkeypatch, capsys):
    """``serve --engine --pool-shards 2 --collective ring`` on the CPU: the
    reference's report line, and the tokens of ``--pool-shards 1``."""
    served = []

    class Recording(ServingEngine):
        def submit(self, req):
            served.append(req)
            return super().submit(req)
    monkeypatch.setattr(serve, "ServingEngine", Recording)
    base = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
            "--batch", "3", "--prompt-len", "9", "--gen-len", "5",
            "--engine", "--check-pool"]
    tokens = {}
    for shards in ("1", "2"):
        served.clear()
        serve.main(base + ["--pool-shards", shards, "--collective", "ring"])
        tokens[shards] = [r.generated for r in served]
        out = capsys.readouterr().out
        line = [s for s in out.splitlines() if s.startswith("sharded pool")]
        if shards == "1":
            assert line == []
            continue
        assert len(line) == 1
        assert line[0].startswith("sharded pool: 2 shards x ring — ")
        assert "collective exchanges (pages striped (2, 2) free/shard)" \
            in line[0]
    assert tokens["2"] == tokens["1"] and all(
        len(g) == 5 for g in tokens["1"])


def test_hop_rows_outside_their_shard_block_are_refused(monkeypatch):
    """Every live row of shard ``o``'s hop must lie in ``o``'s block of its
    rep: a row of another block raises, on the host, before any hop runs;
    the engine checks each step's plans there."""
    from repro_torch.fabric import sharded
    plan = shard_plan(_live(False, 3), F, 4, N, reps=R)
    sharded.check_owned_rows(plan, R, F)
    rows = sharded._stream_rows(torch.from_numpy(plan.fetch), R, F)
    bad = rows.clone()
    o, j = 2, int((bad[2] != FRAME_SENTINEL).nonzero()[0])
    bad[o, j] = (bad[o, j] + F // 4) % (R * F)     # the next shard's block
    with pytest.raises(AssertionError, match="shard 2's hop names"):
        sharded._assert_owned(bad, F)
    checked = []
    monkeypatch.setattr(sharded, "check_owned_rows",
                        lambda *a: checked.append(a[1:]))
    import repro_torch.serving.engine as tengine_mod
    monkeypatch.setattr(tengine_mod, "check_owned_rows",
                        lambda *a: checked.append(a[1:]))
    _, tcfg, _, tparams = tsp.pair("stablelm-1.6b")
    eng = ServingEngine(tcfg, tparams, pool_shards=2, **tsp.CHURN)
    frames = eng.kv.pool.n_pages * eng.page_size
    live = np.full(eng.live_bucket, FRAME_SENTINEL, np.int32)
    live[:3] = (0, 5, frames - 1)
    assert set(eng.shard_plans(live)) == set(eng._shard_reps)
    assert checked == [(reps, frames) for reps in eng._shard_reps]


def test_shard_blocks_are_the_partition():
    """The per-shard views of ``shard_blocks`` are the blocks the partition
    spec gives each shard; a tensor off the mesh's device or an axis that
    does not split evenly is refused."""
    from repro_torch.launch.mesh import shard_blocks
    mesh = make_pool_mesh(4, "cpu")
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    blocks = shard_blocks(x, (None, "pool", None), mesh)
    assert len(blocks) == 4
    for s, b in enumerate(blocks):
        assert b.data_ptr() == x[:, 2 * s].data_ptr()
        assert torch.equal(b, x[:, 2 * s:2 * s + 2])
    with pytest.raises(ValueError, match="4 equal shard blocks"):
        shard_blocks(x, ("pool",), mesh)
    with pytest.raises(ValueError, match="not on the pool mesh's device"):
        shard_blocks(x.to("meta"), (None, "pool"), mesh)
