"""Training on the port against the reference: the optimizer, the loss and
every gradient leaf, the train step, checkpoints (across the two
packages), the fault-tolerant runner, int8 compression, the MoE burst
adjoints and the train CLI.

Everything runs the smoke configs in float32 with the reference's
parameters carried across by ``params_from_jax`` and the batches of the
data stub; gradients come back through ``to_reference_tree``, under the
reference's keys.  The optimizer is held within 1e-6, the loss within
1e-5, each gradient leaf within 1e-4 of its norm, a train step's
parameters and optimizer state within 1e-5; checkpoints, the data, the
runner's replay and int8 compression are exact.

granite-moe is held to the reference's ``payload="route"``: the
reference's default burst payload moves machine words, which cuts the
tangent, so its expert weights get a zero gradient (pinned below); the
port's bursts are autograd Functions whose backward is the other burst.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.lm as jlm  # noqa: E402
from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.mesh import compat_mesh  # noqa: E402
from repro.launch.steps import build_train_step as jbuild  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.runtime import compression as jcomp  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import (SHAPES, ShapeConfig, TrainConfig,  # noqa
                                 cells, get_shape, get_smoke)
from repro_torch.convert import (param_list, params_from_jax,  # noqa: E402
                                 reference_leaves, to_reference_tree)
from repro_torch.data import (SyntheticLM, batch_lines,  # noqa: E402
                              make_batch_specs)
from repro_torch.kernels import launch as kl  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import _auto_grad_accum  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.runtime import (ErrorFeedback, FaultInjector,  # noqa: E402
                                 StragglerDetector, TrainingRunner,
                                 compress_grads, int8_dequantize,
                                 int8_quantize)
from repro_torch.runtime.compression import decompress_grads  # noqa: E402

ARCHS = ("stablelm-1.6b", "gemma3-4b", "granite-moe-3b-a800m",
         "internvl2-1b", "recurrentgemma-2b", "mamba2-780m")
EXPERT_LEAVES = ("w_gate", "w_up", "w_out")
# the reference's optimizer, compiled (eagerly it dispatches every op of
# every leaf anew)
_jadamw = jax.jit(joptim.adamw_update, static_argnums=3)
_jclip = jax.jit(joptim.clip_by_global_norm, static_argnums=1)


@pytest.fixture(autouse=True)
def _one_thread_kernels_and_stats():
    """One thread; both kernel switches on and both packages' ambient MoE
    stats sinks as they were, after every test."""
    torch.set_num_threads(1)
    was, twas = jops.kernels_enabled(), tops.kernels_enabled()
    jstats, tstats = jmoe._DISPATCH_STATS, moe._DISPATCH_STATS
    jops.use_kernels(True)
    tops.use_kernels(True)
    try:
        yield
    finally:
        jops.use_kernels(was)
        tops.use_kernels(twas)
        jmoe._DISPATCH_STATS, moe._DISPATCH_STATS = jstats, tstats


@functools.lru_cache(maxsize=None)
def _pair_params(arch: str):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32")
    return jcfg, japi.init_params(jcfg, jax.random.PRNGKey(0))


def pair(arch: str, **over):
    """``(jcfg, tcfg, jparams, tparams)``: both float32 smoke configs (with
    the config fields ``over``), the reference's parameters and a fresh
    port copy of them."""
    jcfg, jparams = _pair_params(arch)
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(get_smoke(arch), dtype="float32", **over)
    return jcfg, tcfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def leaves_of(tree) -> dict:
    """``{keystr: numpy}`` of a reference-structured tree."""
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def from_tree(params, tree) -> list:
    """Tensors aligned with ``param_list(params)`` from a reference tree
    (a stacked ``unit`` leaf split over its repetitions)."""
    flat = leaves_of(tree)
    out = []
    for path, ts, stacked in reference_leaves(params):
        arr = flat[jax.tree_util.keystr(_jax_path(path))]
        parts = list(arr) if stacked else [arr]
        out += [torch.tensor(np.array(a)) for a in parts]
    return out


def _jax_path(path):
    return tuple(jax.tree_util.SequenceKey(k) if isinstance(k, int)
                 else jax.tree_util.DictKey(k) for k in path)


def grads_close(got: dict, want: dict, what: str) -> None:
    """Every gradient leaf within 1e-4 of its norm."""
    assert set(got) == set(want), what
    for key, w in want.items():
        err = np.linalg.norm(got[key] - w)
        assert err <= 1e-4 * np.linalg.norm(w) + 1e-9, (what, key, err)


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def port_loss_and_grads(tparams, tcfg, batch):
    ps = param_list(tparams)
    for p in ps:
        p.requires_grad_(True)
    loss = api.loss_fn(tparams, tbatch(batch), tcfg)
    grads = torch.autograd.grad(loss, ps)
    return float(loss.detach()), leaves_of(to_reference_tree(tparams,
                                                             grads))


# ----------------------------------------------------------------------------
# configs and data
# ----------------------------------------------------------------------------

def test_shapes_train_config_and_cells_match_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import cells as jcells
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrain())
    assert get_shape("train_4k") == ShapeConfig("train_4k", 4096, 256,
                                                 "train")
    assert cells() == jcells()


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internvl2-1b",
                                  "whisper-medium"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_batch_specs_and_lines_match_reference(arch, kind):
    from repro.data.pipeline import batch_lines as jlines
    from repro.data.pipeline import make_batch_specs as jspecs
    jcfg, tcfg = jget_smoke(arch), get_smoke(arch)
    got, want = make_batch_specs(tcfg, 3, 20, kind), jspecs(jcfg, 3, 20,
                                                            kind)
    assert set(got) == set(want)
    for k, spec in want.items():
        assert got[k].shape == tuple(spec.shape)
        assert str(got[k].dtype).split(".")[-1] == str(spec.dtype)
    toks = np.arange(3 * 7, dtype=np.int32).reshape(3, 7)
    np.testing.assert_array_equal(batch_lines(toks, 4), jlines(toks, 4))


# ----------------------------------------------------------------------------
# the optimizer
# ----------------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    tcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=40)
    jt = JTrain(lr=3e-3, warmup_steps=5, total_steps=40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 100):
        got = float(optim.lr_schedule(torch.tensor(step, dtype=torch.int32),
                                      tcfg))
        want = float(joptim.lr_schedule(jnp.int32(step), jt))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def _random_grads(jparams, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                        .astype(np.float32), jparams)


def test_global_norm_and_clip_match_reference():
    _, _, jparams, tparams = pair("recurrentgemma-2b")
    jg = _random_grads(jparams, 1, 0.3)
    tg = from_tree(tparams, jg)
    got = float(optim.global_norm(tg))
    want = float(jax.jit(joptim.global_norm)(jg))
    assert got == pytest.approx(want, rel=1e-6)
    for max_norm in (0.5, 1e3):
        clipped, norm = optim.clip_by_global_norm(tg, max_norm)
        jclipped, jnorm = _jclip(jg, max_norm)
        assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
        for key, w in leaves_of(jclipped).items():
            np.testing.assert_allclose(
                leaves_of(to_reference_tree(tparams, clipped))[key], w,
                rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("master", [False, True])
def test_adamw_update_matches_reference(master):
    """Three AdamW steps on the same gradients: parameters, moments,
    master copy and step within 1e-6."""
    _, _, jparams, tparams = pair("granite-moe-3b-a800m")
    tcfg = TrainConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                       grad_clip=0.5)
    jt = JTrain(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    jstate = joptim.init_opt_state(jparams, jt, master=master)
    tstate = optim.init_opt_state(tparams, tcfg, master=master)
    jp = jparams
    for i in range(3):
        jg = _random_grads(jparams, 10 + i)
        jp, jstate, jm = _jadamw(jg, jstate, jp, jt)
        _, tstate, tm = optim.adamw_update(from_tree(tparams, jg), tstate,
                                           tparams, tcfg)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    pairs = [(to_reference_tree(tparams), jp),
             (to_reference_tree(tparams, tstate.m), jstate.m),
             (to_reference_tree(tparams, tstate.v), jstate.v)]
    if master:
        pairs.append((to_reference_tree(tparams, tstate.master),
                      jstate.master))
    else:
        assert tstate.master is None and jstate.master is None
    for got, want in pairs:
        got = leaves_of(got)
        for key, w in leaves_of(want).items():
            np.testing.assert_allclose(got[key], w, rtol=1e-6, atol=1e-7,
                                       err_msg=key)


# ----------------------------------------------------------------------------
# the loss and its gradients
# ----------------------------------------------------------------------------

def test_softmax_xent_matches_reference():
    from repro.models.common import softmax_xent as jxent
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 128)).astype(np.float32) * 3
    targets = rng.integers(0, 100, (2, 5)).astype(np.int32)
    got = float(cm.softmax_xent(torch.tensor(logits), torch.tensor(targets),
                                100))
    want = float(jxent(jnp.asarray(logits), jnp.asarray(targets), 100))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch, monkeypatch):
    """``loss_fn`` and every leaf's gradient against
    ``jax.value_and_grad(repro.models.api.loss_fn)``; granite-moe against
    the reference's ``payload="route"`` (its burst payload cuts the
    tangent)."""
    jcfg, tcfg, jparams, tparams = pair(arch)
    if jcfg.moe is not None:
        monkeypatch.setattr(jlm, "moe_apply", functools.partial(
            jmoe.moe_apply, payload="route"))
    batch = JSyntheticLM(jcfg, batch=2, seq=16, seed=0).batch_at(0)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, jcfg)))(jparams, jbatch(batch))
    loss, grads = port_loss_and_grads(tparams, tcfg, batch)
    assert loss == pytest.approx(float(jloss), abs=1e-5)
    grads_close(grads, leaves_of(jgrads), arch)
    if jcfg.moe is not None:
        for key, g in grads.items():
            if key.endswith(tuple(f"['{n}']" for n in EXPERT_LEAVES)):
                assert np.linalg.norm(g) > 0, key


def test_moe_remat_adds_no_stats_and_launches_the_adjoints():
    """Under remat a granite step's forward reports each dispatch once;
    the recompute and the backward bursts add nothing to the ambient
    stats, the loss and gradients are remat-free's, and every backward
    launch is counted (plain versions on the CPU count no launch)."""
    from repro_torch.fabric.scheduler import SchedulerStats
    _, tcfg, _, tparams = pair("granite-moe-3b-a800m")
    batch = JSyntheticLM(jget_smoke("granite-moe-3b-a800m"), batch=2,
                         seq=16, seed=0).batch_at(0)
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        stats = SchedulerStats()
        with moe.dispatch_stats(stats):
            out[remat] = port_loss_and_grads(tparams, cfg, batch)
        out[remat] += (dataclasses.asdict(stats),)
    assert out["none"][0] == out["full"][0]
    grads_close(out["full"][1], out["none"][1], "remat")
    assert out["none"][2] == out["full"][2]
    assert out["full"][2]["network_calls"] == 2 * tcfg.n_layers


def test_reference_burst_payload_cuts_the_expert_gradient():
    """Pin of the reference's quirk: under its default burst payload the
    expert weights' gradients are exactly zero (the payload moves as
    machine words).  When the reference is fixed, this test says so."""
    jcfg, _, jparams, _ = pair("granite-moe-3b-a800m")
    batch = JSyntheticLM(jcfg, batch=2, seq=16, seed=0).batch_at(0)
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, jcfg)))(jparams, jbatch(batch))
    grads = leaves_of(jgrads)
    for key, g in grads.items():
        if key.endswith(tuple(f"['{n}']" for n in EXPERT_LEAVES)):
            assert not np.any(g), key
    assert np.linalg.norm(grads["['unit'][0]['ffn']['router']"]) > 0


def test_rglru_scan_runs_backward():
    """The Hillis-Steele scan is out of place: its gradient is the
    sequential recurrence's."""
    torch.manual_seed(0)
    a = torch.rand(2, 13, 5, requires_grad=True)
    b = torch.randn(2, 13, 5, requires_grad=True)
    w = torch.randn(2, 13, 5)
    ga = torch.autograd.grad((rglru.linear_scan(a, b) * w).sum(), (a, b))
    h, hs = torch.zeros(2, 5), []
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    gb = torch.autograd.grad((torch.stack(hs, 1) * w).sum(), (a, b))
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """Three steps of ``build_train_step`` against the reference's on a
    1x1 mesh: parameters and optimizer state within 1e-5.  At the peak
    rate 1e-3: Adam's first steps move an element by about ``lr *
    g / |g|``, so float rounding of a near-zero gradient element moves it
    by up to ``lr`` in either package (one element of ``wq`` by 2e-5 at
    ``lr = 1e-2``)."""
    jcfg, tcfg, jparams, tparams = pair("stablelm-1.6b")
    shape = ShapeConfig("t", 16, 4, "train")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20, grad_accum=accum,
              zero1=False)
    mesh = compat_mesh(jax.devices()[:1], (1, 1), ("data", "model"))
    built = jbuild(jcfg, JShape("t", 16, 4, "train"), mesh, JTrain(**kw))
    jstep = jax.jit(built.fn, in_shardings=built.in_shardings,
                    out_shardings=built.out_shardings)
    jstate = {"params": jparams,
              "opt": joptim.init_opt_state(jparams, JTrain(**kw),
                                           master=False)}
    tb = build_train_step(tcfg, shape, TrainConfig(**kw))
    assert tb.grad_accum == accum
    tstate = {"params": tparams,
              "opt": optim.init_opt_state(tparams, TrainConfig(**kw),
                                          master=False)}
    data = JSyntheticLM(jcfg, batch=4, seq=16, seed=0)
    with mesh:
        for i in range(3):
            jstate, jm = jstep(jstate, jbatch(data.batch_at(i)))
            tstate, tm = tb.fn(tstate, data.batch_at(i))
            assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                      abs=1e-5)
    opt = tstate["opt"]
    for got, want in ((to_reference_tree(tparams), jstate["params"]),
                      (to_reference_tree(tparams, opt.m), jstate["opt"].m),
                      (to_reference_tree(tparams, opt.v), jstate["opt"].v)):
        got = leaves_of(got)
        for key, w in leaves_of(want).items():
            np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=1e-5,
                                       err_msg=key)
    assert int(opt.step) == int(jstate["opt"].step) == 3


def test_auto_grad_accum_matches_reference():
    from repro.launch.steps import _auto_grad_accum as jauto
    mesh = compat_mesh(jax.devices()[:1], (1, 1), ("data", "model"))
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config
    for arch in ("stablelm-1.6b", "gemma3-12b", "granite-moe-3b-a800m"):
        for name in ("train_4k", "prefill_32k"):
            assert _auto_grad_accum(get_config(arch), SHAPES[name]) == \
                jauto(jget_config(arch), SHAPES[name], mesh), (arch, name)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "granite-moe-3b-a800m",
                                  "mamba2-780m", "recurrentgemma-2b"])
def test_train_step_reduces_loss(arch):
    """Twenty steps (grad accumulation 2) lower the loss, as the
    reference's step does on its mesh."""
    cfg = get_smoke(arch)
    tcfg = TrainConfig(lr=1e-2, warmup_steps=2, total_steps=100,
                       grad_accum=2, zero1=False)
    step = build_train_step(cfg, ShapeConfig("t", 16, 4, "train"), tcfg).fn
    params = api.init_params(cfg, seed=0, device="cpu")
    state = {"params": params,
             "opt": optim.init_opt_state(params, tcfg, master=False)}
    data = SyntheticLM(cfg, batch=4, seq=16, seed=0)
    losses = []
    for i in range(20):
        state, metrics = step(state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


# ----------------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------------

def _counting_state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v)},
            "step": torch.tensor(int(v), dtype=torch.int32)}


def test_checkpoint_roundtrip_gc_and_refusals(tmp_path):
    d = str(tmp_path / "rt")
    s = _counting_state(3.0)
    save_checkpoint(d, 7, s, {"data_step": 7})
    assert latest_step(d) == 7
    restored, extra = restore_checkpoint(d, 7, _counting_state(0.0))
    torch.testing.assert_close(restored["params"]["w"], s["params"]["w"])
    assert int(restored["step"]) == 3 and extra["data_step"] == 7
    bad = {"params": {"w": torch.zeros(2, 2)},
           "step": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, 7, bad)
    with pytest.raises(KeyError):
        restore_checkpoint(d, 7, {"other": torch.zeros(1)})
    g = str(tmp_path / "gc")
    mgr = CheckpointManager(g, every=1, keep=2)
    for i in range(5):
        mgr.maybe_save(i, _counting_state(float(i)))
    assert sorted(int(p.split("_")[1]) for p in os.listdir(g)) == [3, 4]


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-medium"])
def test_checkpoint_restores_across_packages(arch, tmp_path):
    """A train state written by the port restores in the reference, and
    the reference's in the port, exactly (bf16 model: the leaves cross as
    float32)."""
    jcfg = jget_smoke(arch)
    tcfg = get_smoke(arch)
    jt, tt = JTrain(), TrainConfig()
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(3))
    jstate = {"params": jparams,
              "opt": joptim.init_opt_state(jparams, jt, master=True)}
    jg = _random_grads(jparams, 5)
    _, jopt, _ = _jadamw(jg, jstate["opt"], jparams, jt)
    jstate = {"params": jparams, "opt": jopt}
    jsave(str(tmp_path / "ref"), 1, jstate, {"data_step": 1})
    tparams = api.init_params(tcfg, seed=1, device="cpu")
    tstate = {"params": tparams,
              "opt": optim.init_opt_state(tparams, tt, master=True)}
    tstate, extra = restore_checkpoint(str(tmp_path / "ref"), 1, tstate)
    assert extra == {"data_step": 1}
    want = leaves_of(jstate)
    assert len(want) == len(leaves_of({"params": to_reference_tree(
        tparams)})) * 4 + 1
    # the port's state back through its own writer → the reference
    save_checkpoint(str(tmp_path / "port"), 2, tstate, {"data_step": 2})
    back, extra = jrestore(str(tmp_path / "port"), 2,
                           jax.tree.map(jnp.zeros_like, jstate))
    assert extra == {"data_step": 2}
    for key, w in want.items():
        got = np.asarray(leaves_of(back)[key])
        assert got.dtype == w.dtype, key
        np.testing.assert_array_equal(got.astype(np.float32),
                                      w.astype(np.float32), err_msg=key)
    opt = tstate["opt"]
    assert int(opt.step) == 1
    np.testing.assert_array_equal(
        leaves_of(to_reference_tree(tparams, opt.master))[
            "['embed']['table']"],
        np.asarray(jopt.master["embed"]["table"]))


# ----------------------------------------------------------------------------
# the runner, the straggler detector, compression
# ----------------------------------------------------------------------------

def _make_runner(directory, fail_at=()):
    """Counting 'training': ``w += batch mean`` each step."""
    class Data:
        def batch_at(self, step):
            return {"x": np.full((2,), float(step))}

    def step_fn(state, batch):
        state["params"]["w"] += float(batch["x"].mean())
        state["step"] += 1
        return state, {"loss": float(batch["x"].mean())}

    return TrainingRunner(step_fn, Data(),
                          CheckpointManager(str(directory), every=2, keep=5),
                          fault_injector=FaultInjector(fail_at))


def test_runner_restart_is_exact(tmp_path):
    """A state changed in place: after a failure and a restore it equals
    the uninterrupted run's."""
    clean, end = _make_runner(tmp_path / "a").run(_counting_state(), 0, 10)
    runner = _make_runner(tmp_path / "b", fail_at=(5,))
    faulty, end_f = runner.run(_counting_state(), 0, 10)
    assert runner.restarts == 1 and end == end_f == 10
    torch.testing.assert_close(faulty["params"]["w"], clean["params"]["w"],
                               rtol=0, atol=0)
    assert int(faulty["step"]) == int(clean["step"]) == 10


def test_straggler_detector():
    det = StragglerDetector(threshold=2.0)
    for _ in range(5):
        assert not det.observe(0.1)
    assert det.observe(0.5)
    assert det.flagged == 1
    assert not det.observe(0.1)


def test_int8_compression_exact_against_reference():
    rng = np.random.default_rng(6)
    g = (rng.standard_normal(257) * 3).astype(np.float32)
    q, scale = int8_quantize(torch.tensor(g))
    jq, jscale = jcomp.int8_quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(int8_dequantize(q, scale).numpy(),
                                  np.asarray(jcomp.int8_dequantize(jq,
                                                                   jscale)))
    ef = ErrorFeedback.init([torch.zeros(64), torch.zeros(3, 5)])
    jef = jcomp.ErrorFeedback.init({"a": jnp.zeros(64),
                                    "b": jnp.zeros((3, 5))})
    for i in range(6):
        ga = (rng.standard_normal(64) * 0.01).astype(np.float32)
        gb = (rng.standard_normal((3, 5)) * 2).astype(np.float32)
        pairs, ef = compress_grads([torch.tensor(ga), torch.tensor(gb)], ef)
        jpairs, jef = jcomp.compress_grads({"a": jnp.asarray(ga),
                                            "b": jnp.asarray(gb)}, jef)
        sent = decompress_grads(pairs)
        jsent = jcomp.decompress_grads(jpairs)
        for got, name in zip(sent, ("a", "b")):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jsent[name]))
        for got, name in zip(ef.buf, ("a", "b")):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jef.buf[name]))


# ----------------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------------

def test_train_cli_restarts_once_and_refuses_no_device(tmp_path, capsys):
    args = ["--arch", "stablelm-1.6b", "--smoke", "--steps", "12",
            "--batch", "4", "--seq", "32", "--ckpt-every", "4",
            "--fail-at", "6", "--ckpt-dir", str(tmp_path / "ck"),
            "--log-every", "4"]
    state, runner, history = train_cli.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "done at step 12" in out and "restarts=1" in out
    assert "step     4 loss" in out and runner.restarts == 1
    assert [h[0] for h in history] == list(range(1, 7)) + list(range(5, 13))
    assert latest_step(str(tmp_path / "ck")) == 12
    # --smoke trains on the 1x1 mesh whatever --multi-pod says: the same
    # losses as without it
    _, runner_mp, history_mp = train_cli.main(
        args + ["--device", "cpu", "--multi-pod",
                "--ckpt-dir", str(tmp_path / "ck_mp")])
    out_mp = capsys.readouterr().out
    assert "done at step 12" in out_mp and runner_mp.restarts == 1
    assert [(s, float(loss)) for s, _, loss in history_mp] == \
        [(s, float(loss)) for s, _, loss in history]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(args)


def test_backward_launch_counts_reset_with_the_totals():
    kl.reset_launch_counts()
    with kl.backward_launches():
        kl.count("medusa_transpose_tiles")
    kl.count("medusa_transpose_tiles")
    assert kl.launch_counts()["medusa_transpose_tiles"] == 2
    assert kl.backward_launch_counts()["medusa_transpose_tiles"] == 1
    kl.reset_launch_counts()
    assert not any(kl.backward_launch_counts().values())
