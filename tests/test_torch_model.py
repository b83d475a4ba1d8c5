"""The port's stablelm model against the reference, on the smoke config in
float32 with the reference's parameters carried across by
``params_from_jax``.

Tolerances: logits and new K/V within ``atol = rtol = 1e-4`` — both sides
run the same float32 formulas, but the two frameworks order their sums
differently (the reference itself drifts by ~1e-6 across jax versions, see
ROADMAP §3).  Movement is exact: pool bytes the decode step did not write
this step are bit-equal.  Each port path is compared with the same
reference path: the fused (``live``) form with the fused form, the
gather-after-burst (``phys``) form with that form.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.fabric import BurstScheduler as JScheduler  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric import SchedulerStats as JStats  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fabric import BurstScheduler, Fabric  # noqa: E402
from repro_torch.fabric import SchedulerStats  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread_and_kernels():
    torch.set_num_threads(1)
    was = jops.kernels_enabled()
    jops.use_kernels(True)
    yield
    jops.use_kernels(was)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget_smoke("stablelm-1.6b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke("stablelm-1.6b"), dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_configs_and_fabric_match(models):
    jcfg, tcfg, _, _ = models
    for f in dataclasses.fields(tcfg):
        if f.name in ("moe", "ssm", "rglru", "fabric"):
            continue
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert dataclasses.asdict(tcfg.resolved_fabric) == dataclasses.asdict(
        jcfg.resolved_fabric)
    assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("bad", [dict(impl="banyan"), dict(pack="dense"),
                                 dict(word_fold=3), dict(fused_gather="x"),
                                 dict(n_ports=0), dict(page_size=0)])
def test_fabric_validation_rejects_what_the_reference_rejects(bad):
    from repro.configs.base import FabricConfig as JFabricConfig
    from repro_torch.configs.base import FabricConfig
    with pytest.raises(ValueError):
        JFabricConfig(**bad).validate()
    with pytest.raises(ValueError):
        FabricConfig(**bad).validate()


def test_synthetic_data_is_the_reference_stream():
    from repro.data import SyntheticLM as JSyntheticLM
    from repro_torch.data import SyntheticLM
    want = JSyntheticLM(jget_smoke("stablelm-1.6b"), batch=3, seq=7,
                        seed=4).batch_at(2)
    got = SyntheticLM(get_smoke("stablelm-1.6b"), batch=3, seq=7,
                      seed=4).batch_at(2)
    for name in ("tokens", "targets"):
        np.testing.assert_array_equal(got[name], want[name])


def test_params_carried_across_bit_for_bit(models):
    jcfg, tcfg, jparams, tparams = models
    unit = jparams["unit"][0]
    for r in range(2):
        blk = tparams.unit[0][r]
        np.testing.assert_array_equal(blk.attn["wq"].numpy(),
                                      np.asarray(unit["attn"]["wq"][r]))
        np.testing.assert_array_equal(blk.ffn["w_gate"].numpy(),
                                      np.asarray(unit["ffn"]["w_gate"][r]))
    np.testing.assert_array_equal(tparams.embed["table"].numpy(),
                                  np.asarray(jparams["embed"]["table"]))


def test_bf16_leaves_cross_as_bit_patterns():
    jcfg = jget_smoke("stablelm-1.6b")                    # bfloat16
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              get_smoke("stablelm-1.6b"), device="cpu")
    want = np.asarray(jparams["unit"][0]["attn"]["wk"][1]).view(np.uint16)
    got = tparams.unit[0][1].attn["wk"].view(torch.int16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16), want)


def test_prefill_logits_and_caches(models):
    jcfg, tcfg, jparams, tparams = models
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 9),
                                             dtype=np.int32)
    jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 12)
    tl, tc = api.prefill_fn(tparams, {"tokens": torch.from_numpy(toks)},
                            tcfg, 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["unit"][0][name].numpy(),
                                   np.asarray(jc["unit"][0][name]), **TOL)


def _paged_setup(cfg, rng):
    """A churned pool: 3 slots, page size 4, 8 physical pages (2 layers
    stacked), slot 0 on 2 pages, slot 1 on 3, slot 2 retired (unmapped)."""
    ps, n_pages, t_depth = 4, 8, 16
    hd = cfg.resolved_head_dim
    table = np.full((3, 4), -1, np.int32)
    table[0, :2] = [3, 5]
    table[1, :3] = [0, 6, 2]
    pos = np.array([6, 10, 0], np.int32)
    pools = {name: rng.standard_normal((2, n_pages, ps, cfg.n_kv_heads, hd))
             .astype(np.float32) for name in ("k", "v")}
    token = rng.integers(0, cfg.vocab_size, (3, 1), dtype=np.int32)
    # the frames this step writes: each live slot's new token, every layer
    written = [(r, table[s, pos[s] // ps], pos[s] % ps)
               for r in range(2) for s in (0, 1)]
    return ps, t_depth, table, pos, pools, token, written


@pytest.mark.parametrize("form", ["live", "phys"])
def test_scheduled_decode_step(models, form):
    """One burst-scheduled decode step on the paged pool, fused (``live``)
    or gather-after-burst (``phys``), against the reference's same form."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(3)
    ps, t_depth, table, pos, pools, token, written = _paged_setup(tcfg, rng)
    n = tcfg.resolved_fabric.n_ports
    live = cm.page_live_plan(table, ps, t_depth, n, bucket=n * ps)
    jlive = jcm.page_live_plan(table, ps, t_depth, n, bucket=n * ps)
    for a, b in zip(live, jlive):
        np.testing.assert_array_equal(a, b)

    jstats = JStats()
    jl, jc = japi.decode_fn(
        jparams, jnp.asarray(token),
        {"unit": [{k: jnp.asarray(v) for k, v in pools.items()}],
         "tail": []},
        jnp.asarray(pos), jcfg,
        sched=JScheduler(JFabric(jcfg.resolved_fabric), stats=jstats),
        page_table=jnp.asarray(table), page_size=ps, t_depth=t_depth,
        live_plan=tuple(jnp.asarray(a) for a in jlive)
        if form == "live" else None)
    tstats = SchedulerStats()
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    tl, tcaches = api.decode_fn(
        tparams, torch.from_numpy(token), {"unit": [tpools], "tail": []},
        torch.from_numpy(pos), tcfg,
        sched=BurstScheduler(Fabric(tcfg.resolved_fabric), stats=tstats),
        page_table=torch.from_numpy(table), page_size=ps, t_depth=t_depth,
        live_plan=tuple(torch.from_numpy(a) for a in live)
        if form == "live" else None)

    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tstats.gather_fused_bursts == (4 if form == "live" else 0)
    mask = np.ones(pools["k"].shape[:3], bool)
    for r, page, t in written:
        mask[r, page, t] = False
    for name in ("k", "v"):
        got = tcaches["unit"][0][name].numpy()
        want = np.asarray(jc["unit"][0][name])
        # movement: every frame not written this step is the pool's own
        np.testing.assert_array_equal(got[mask].view(np.uint32),
                                      pools[name][mask].view(np.uint32))
        np.testing.assert_array_equal(want[mask].view(np.uint32),
                                      pools[name][mask].view(np.uint32))
        # compute: the new token's K/V
        np.testing.assert_allclose(got[~mask], want[~mask], **TOL)
    if form == "live":                       # the sparse write lands in place
        assert tcaches["unit"][0]["k"].data_ptr() == tpools["k"].data_ptr()
