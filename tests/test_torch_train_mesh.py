"""The train step over a mesh in one process against the reference: the
batch split into the rank blocks its spec gives, each block's gradient
taken in turn and averaged by ``dp_grad_mean``, held to the reference's
jitted ``build_train_step`` on its 1x1 mesh; the step's specs, blocks and
microbatch count on the production mesh at full width (from shapes
alone).  No test spawns a process or opens a process group.
"""

import dataclasses
import functools
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

import repro.models.lm as jlm  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import compat_mesh as jcompat_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import (SHAPES, ShapeConfig,  # noqa: E402
                                 TrainConfig, get_config, get_smoke)
from repro_torch.convert import (keystr, params_from_jax,  # noqa: E402
                                 to_reference_tree)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch import optim  # noqa: E402

TRAIN_ARCHS = ("stablelm-1.6b", "granite-moe-3b-a800m", "mamba2-780m",
               "recurrentgemma-2b")


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


def stand_in(shape, axes):
    """What the reference's spec builders read of a mesh."""
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, object))


def ref_specs(tree) -> dict:
    """``{keystr: spec tuple}`` of a reference ``PartitionSpec`` pytree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in leaves}


def port_specs(specs: dict) -> dict:
    return {keystr(path): spec for path, spec in specs.items()}


# (mesh shape, axes, microbatches per rank block): every mesh cuts the
# batch of 4 into the same 4 microbatches of one row
TRAIN_MESHES = {"1x1": ((1, 1), ("data", "model"), 4),
                "data2": ((2, 1), ("data", "model"), 2),
                "pod2data2": ((2, 2, 1), ("pod", "data", "model"), 1)}
# at the peak rate 1e-4: Adam's first steps move an element by about
# lr * g / |g|, so float rounding of a near-zero gradient element moves it
# by a share of lr in either package (one element of recurrentgemma-2b's
# w_out by 1.3e-5 at lr 1e-3)
TRAIN_KW = dict(lr=1e-4, warmup_steps=2, total_steps=20, zero1=True)


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str):
    """The reference's jitted train step on its 1x1 mesh, 3 steps of 4 x
    16 at 4 microbatches, float32 (granite's payload ``"route"``): the
    parameters, the losses and grad norms, and the final state."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, jparams)
    tc = JTrain(grad_accum=4, **TRAIN_KW)
    mesh = jcompat_mesh(jax.devices()[:1], (1, 1), ("data", "model"))
    built = jsteps.build_train_step(jcfg, JShape("t", 16, 4, "train"), mesh,
                                    tc)
    step = jax.jit(built.fn, in_shardings=built.in_shardings,
                   out_shardings=built.out_shardings)
    state = {"params": jparams,
             "opt": joptim.init_opt_state(jparams, tc, master=False)}
    data = JSyntheticLM(jcfg, batch=4, seq=16, seed=0)
    metrics = []
    with mock.patch.object(jlm, "moe_apply", functools.partial(
            jmoe.moe_apply, payload="route")), mesh:
        for i in range(3):
            state, m = step(state, {k: jnp.asarray(v) for k, v in
                                    data.batch_at(i).items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return params0, metrics, jax.tree.map(np.asarray, state)


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mesh_name", list(TRAIN_MESHES))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_over_a_mesh_matches_reference(arch, mesh_name):
    """Three steps over (1, 1), (data=2) and (pod=2, data=2) against the
    reference's jitted step on its 1x1 mesh: the rank blocks times their
    microbatches make the reference's 4 microbatches, so the losses, the
    grad norms, the parameters and both moments agree within 1e-5 (ZeRO-1
    on, which moves nothing)."""
    shape, axes, accum = TRAIN_MESHES[mesh_name]
    params0, metrics, jstate = _reference_run(arch)
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    tparams = params_from_jax(params0, cfg, device="cpu")
    tc = TrainConfig(grad_accum=accum, **TRAIN_KW)
    mesh = make_mesh(shape, axes, device="cpu")
    built = steps.build_train_step(cfg, ShapeConfig("t", 16, 4, "train"),
                                   tc, mesh=mesh)
    assert built.batch_blocks * built.grad_accum == 4
    state = {"params": tparams,
             "opt": optim.init_opt_state(tparams, tc, master=False)}
    data = JSyntheticLM(jget_smoke(arch), batch=4, seq=16, seed=0)
    for i, (jloss, jnorm) in enumerate(metrics):
        state, m = built.fn(state, data.batch_at(i))
        assert float(m["loss"]) == pytest.approx(jloss, abs=1e-5), i
        assert float(m["grad_norm"]) == pytest.approx(jnorm, rel=1e-5), i
    opt = state["opt"]
    for got, want in ((to_reference_tree(tparams), jstate["params"]),
                      (to_reference_tree(tparams, opt.m), jstate["opt"].m),
                      (to_reference_tree(tparams, opt.v), jstate["opt"].v)):
        got = _leaves(got)
        for key, w in _leaves(want).items():
            np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=1e-5,
                                       err_msg=key)


def test_train_step_specs_blocks_and_accum_on_the_production_mesh():
    """stablelm-1.6b at full width, batch 8 x 64 on (2, 16, 16): the batch
    keeps the ``pod`` prefix (2 blocks of 4), the microbatch count is the
    reference's ``_auto_grad_accum`` over the mesh, and the step's
    parameter and ZeRO-1 optimizer specs are the reference's builders'."""
    cfg, jcfg = get_config("stablelm-1.6b"), jget_config("stablelm-1.6b")
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    jmesh = stand_in(mesh.devices.shape, mesh.axis_names)
    shape = ShapeConfig("cli", 64, 8, "train")
    built = steps.build_train_step(cfg, shape, TrainConfig(grad_accum=0),
                                   mesh=mesh)
    assert built.batch_blocks == 2
    assert built.batch_specs == {"tokens": ("pod",), "targets": ("pod",)}
    assert built.grad_accum == jsteps._auto_grad_accum(
        jcfg, JShape("cli", 64, 8, "train"), jmesh)
    for name in ("train_4k", "prefill_32k"):
        want = jsteps._auto_grad_accum(jcfg, SHAPES[name], jmesh)
        assert steps.build_train_step(
            cfg, SHAPES[name], TrainConfig(grad_accum=0),
            mesh=mesh).grad_accum == want, name
    jshapes = jsteps._eval_params(jcfg)
    jsh = jsteps.make_sharder(jcfg, jmesh)
    jp = jsteps.param_specs(jshapes, jcfg, jsh)
    assert port_specs(built.param_specs) == ref_specs(jp)
    jz = ref_specs(jsteps.zero1_specs(jp, jshapes, jsh))
    for tree in (built.opt_specs.m, built.opt_specs.v):
        assert port_specs(tree) == jz
    assert built.opt_specs.step == () and built.opt_specs.master is None
    one = steps.build_train_step(cfg, shape, TrainConfig(zero1=False),
                                 mesh=mesh)
    assert one.opt_specs.m == one.param_specs and one.opt_specs.master is None


def test_train_step_refuses_a_mesh_on_another_device():
    cfg = get_smoke("stablelm-1.6b")
    built = steps.build_train_step(
        cfg, ShapeConfig("t", 16, 4, "train"), TrainConfig(grad_accum=1),
        mesh=make_mesh((2, 1), ("data", "model"), device="cpu"))
    params = api.init_params(cfg, seed=0, device="meta")
    with pytest.raises(ValueError, match="the mesh lies on cpu"):
        built.fn({"params": params, "opt": None},
                 {"tokens": np.zeros((4, 16), np.int32)})
    # a batch no data axis divides stays one block
    assert steps.build_train_step(
        cfg, ShapeConfig("t", 16, 3, "train"),
        mesh=make_mesh((2, 1), ("data", "model"),
                       device="cpu")).batch_blocks == 1


def test_sixteen_blocks_on_the_production_mesh_are_dp_grad_mean():
    """Batch 16 on the (16, 16) mesh splits into 16 blocks of one row; the
    step's running sum is ``dp_grad_mean(..., "none")`` of the 16 blocks'
    gradients bit for bit, so the parameters, both moments, the loss and
    the grad norm equal AdamW on that mean."""
    from repro_torch.convert import param_list
    from repro_torch.parallel import dp_grad_mean

    cfg = dataclasses.replace(get_smoke("stablelm-1.6b"), dtype="float32")
    tc = TrainConfig(grad_accum=1, **TRAIN_KW)
    built = steps.build_train_step(
        cfg, ShapeConfig("t", 8, 16, "train"), tc,
        mesh=make_production_mesh(device="cpu"))
    assert built.batch_blocks == 16
    assert built.batch_specs == {"tokens": ("data",), "targets": ("data",)}
    batch = {k: torch.as_tensor(v) for k, v in
             JSyntheticLM(jget_smoke("stablelm-1.6b"), batch=16, seq=8,
                          seed=0).batch_at(0).items()}
    params = api.init_params(cfg, seed=0, device="cpu")
    state, m = built.fn({"params": params,
                         "opt": optim.init_opt_state(params, tc,
                                                     master=False)}, batch)

    ref = api.init_params(cfg, seed=0, device="cpu")
    ps = param_list(ref)
    for p in ps:
        p.requires_grad_(True)
    losses, blocks = [], []
    for r in range(16):
        loss = api.loss_fn(ref, {k: v[r:r + 1] for k, v in batch.items()},
                           cfg)
        losses.append(loss.detach())
        blocks.append(list(torch.autograd.grad(loss, ps)))
    ref, ropt, rm = optim.adamw_update(
        dp_grad_mean(blocks, "none"),
        optim.init_opt_state(ref, tc, master=False), ref, tc)
    assert torch.equal(m["loss"], torch.stack(losses).mean())
    assert torch.equal(m["grad_norm"], rm["grad_norm"])
    opt = state["opt"]
    for got, want in ((param_list(state["params"]), param_list(ref)),
                      (opt.m, ropt.m), (opt.v, ropt.v)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
