"""The port's parallelism in one process against the reference: the
logical-axis sharder, the spec builders (every registry arch at full
width on the production meshes, from shapes alone), the int8 all-reduce
and the data-parallel gradient mean (bit for bit against the reference's
per-rank bodies run under ``jax.vmap``), the microbatch pipeline, the
meshes and the serving steps (the train step over a mesh:
``test_torch_train_mesh.py``).

The reference's meshes need as many devices as positions; its spec
builders read only ``mesh.axis_names`` and ``mesh.devices.shape``, so
they run here on a stand-in of that shape.  No test spawns a process or
opens a process group.
"""

import dataclasses
import functools
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data.pipeline import make_batch_specs as jbatch_specs  # noqa
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import compat_mesh as jcompat_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.parallel import collectives as jcoll  # noqa: E402
from repro.parallel import pipeline as jpipe  # noqa: E402
from repro.parallel.sharding import Sharder as JSharder  # noqa: E402
from repro.parallel.sharding import rules_for as jrules_for  # noqa: E402
from repro_torch.configs import (ShapeConfig, get_config,  # noqa: E402
                                 get_smoke)
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.convert import (keystr, params_from_jax,  # noqa: E402
                                 reference_leaves)
from repro_torch.data import make_batch_specs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import (compat_mesh, make_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import api  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.parallel import (Sharder, bubble_fraction,  # noqa: E402
                                  compressed_psum, current_sharder,
                                  dp_grad_mean, no_sharding,
                                  pipeline_forward, pipeline_loss,
                                  rules_for, shard, use_sharder)

PROFILES = ("tp_heads", "sp_seq", "moe_cap", "ep_2d")
MESHES = {(1, 1): ("data", "model"), (4, 2): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


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


# ---------------------------------------------------------------------------
# the sharder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(MESHES), ids=str)
def test_sharder_matches_reference(shape):
    """``spec`` over every triple of logical names (the rules', the step
    builders' extra ones, an unknown one and None) and ``safe_spec`` over
    every pair at dims that divide some, all or none of the axes, for
    every profile: the reference's specs."""
    axes = MESHES[shape]
    mesh = make_mesh(shape, axes, device="cpu")
    assert mesh.axis_names == axes and mesh.devices.shape == shape
    for profile in PROFILES:
        rules = dict(rules_for(profile), **steps.EXTRA_RULES)
        jrules = dict(jrules_for(profile), **jsteps.EXTRA_RULES)
        assert rules == jrules
        got, want = Sharder(mesh, rules), JSharder(stand_in(shape, axes),
                                                   jrules)
        names = sorted(rules) + ["nope", None]
        for logical in itertools.product(names, repeat=3):
            assert got.spec(*logical) == tuple(want.spec(*logical)), logical
        dims = (1, 2, 3, 4, 8, 16, 32, 48, 512)
        for logical in itertools.product(names, repeat=2):
            for dim in itertools.product(dims, repeat=2):
                assert got.safe_spec(dim, logical) == tuple(
                    want.safe_spec(dim, logical)), (dim, logical)
        assert got.named_sharding("batch") == (mesh, got.spec("batch"))


def test_sharder_edge_rules():
    s = Sharder(make_mesh((1, 1), ("data", "model"), device="cpu"),
                rules_for("tp_heads"))
    assert s.spec("batch", "seq", "d_model") == ("data",)
    assert s.spec("batch", None, "heads") == ("data", None, "model")
    assert s.spec("heads", "d_ff") == ("model",)       # an axis once
    assert s.safe_spec((1, 8), ("batch", None)) == ()
    assert s.safe_spec((256, 8), ("batch", "heads")) == ()   # size-1 axes
    big = Sharder(make_production_mesh(multi_pod=True, device="cpu"),
                  rules_for("tp_heads"))
    assert big.safe_spec((256, 8), ("batch", None)) == (("pod", "data"),)
    assert big.safe_spec((2, 8), ("batch", None)) == ("pod",)
    with pytest.raises(ValueError, match="unknown sharding profile"):
        rules_for("nope")


def test_shard_and_the_thread_local_sharder():
    x = torch.zeros(2, 3)
    s = Sharder(make_mesh((2, 1), ("data", "model"), device="cpu"),
                rules_for("tp_heads"))
    j = JSharder(stand_in((2, 1), ("data", "model")), jrules_for("tp_heads"))
    assert shard(x, "batch") is x and current_sharder() is None
    with use_sharder(s):
        assert current_sharder() is s
        assert shard(x, "batch", "d_model") is x
        with pytest.raises(ValueError) as got:
            shard(x, "batch")
        with pytest.raises(ValueError) as want:
            j.shard(jnp.zeros((2, 3)), "batch")
        assert str(got.value) == str(want.value)
        with no_sharding():
            assert current_sharder() is None
            assert shard(x, "batch") is x
        assert current_sharder() is s
    assert current_sharder() is None


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------

def test_meshes_lie_over_one_device():
    for multi_pod, shape, axes in ((False, (16, 16), ("data", "model")),
                                   (True, (2, 16, 16),
                                    ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert mesh.axis_names == axes and mesh.devices.shape == shape
        assert mesh.size == int(np.prod(shape))
        assert set(mesh.devices) == {torch.device("cpu")}
    mesh = make_mesh((4,), ("pool",), device="cpu")
    assert mesh.axis == "pool" and mesh.size == 4
    assert mesh.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="not 1-D"):
        make_mesh((2, 2), ("data", "model"), device="cpu").axis
    with pytest.raises(ValueError, match="does not match"):
        compat_mesh(["cpu"] * 4, (2, 2), ("data",))
    with pytest.raises(ValueError, match="does not hold"):
        compat_mesh(["cpu"] * 3, (2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="item 8c"):
        compat_mesh(["cpu", "meta"], (1, 2), ("data", "model"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_production_mesh()


# ---------------------------------------------------------------------------
# the spec builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_and_zero1_specs_at_full_width(arch):
    """``make_sharder``, ``param_specs`` and ``zero1_specs`` leaf by leaf
    at the config's full width on (16, 16) and (2, 16, 16), from shapes
    alone on both sides (kimi-k2's ~1 T parameters included)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jshapes, shapes = jsteps._eval_params(jcfg), steps._eval_params(cfg)
    assert {t.device.type for _, ts, _ in reference_leaves(shapes)
            for t in ts} == {"meta"}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        jsh = jsteps.make_sharder(jcfg, stand_in(mesh.devices.shape,
                                                 mesh.axis_names))
        sh = steps.make_sharder(cfg, mesh)
        assert sh.rules == jsh.rules
        jp = jsteps.param_specs(jshapes, jcfg, jsh)
        pspecs = steps.param_specs(shapes, cfg, sh)
        assert port_specs(pspecs) == ref_specs(jp)
        assert port_specs(steps.zero1_specs(pspecs, shapes, sh)) == \
            ref_specs(jsteps.zero1_specs(jp, jshapes, jsh))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_and_batch_specs_at_smoke_width(arch):
    """``cache_specs`` of the decode caches and ``batch_specs_sharding`` of
    every step kind's inputs, at smoke width, on (2, 2, 2) and the
    production meshes."""
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    jcaches = jax.eval_shape(functools.partial(japi.init_cache, jcfg, 4, 32))
    caches = api.init_cache(cfg, 4, 32, device="meta")
    for shape, axes in (((2, 2, 2), ("pod", "data", "model")),
                        ((16, 16), ("data", "model")),
                        ((2, 16, 16), ("pod", "data", "model"))):
        sh = steps.make_sharder(cfg, make_mesh(shape, axes, device="cpu"))
        jsh = jsteps.make_sharder(jcfg, stand_in(shape, axes))
        assert port_specs(steps.cache_specs(caches, cfg, sh)) == \
            ref_specs(jsteps.cache_specs(jcaches, jcfg, jsh))
        for kind in ("train", "prefill", "decode"):
            got = steps.batch_specs_sharding(
                make_batch_specs(cfg, 4, 24, kind), sh)
            want = jsteps.batch_specs_sharding(jbatch_specs(jcfg, 4, 24,
                                                            kind), jsh)
            assert got == {k: tuple(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _words(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("n", (1, 2, 3, 4, 8))
def test_compressed_psum_and_dp_grad_mean_bit_equal(n):
    """Against the reference's per-rank bodies under ``jax.vmap`` over a
    named axis: the int8 all-reduce and both means, word for word (signed
    zeros, a leaf of zeros, leaves of different scales)."""
    rng = np.random.default_rng(n)
    leaves = [(rng.standard_normal((n, 33, 5)) * 3).astype(np.float32),
              (rng.standard_normal((n, 129)) * 1e-4).astype(np.float32),
              np.zeros((n, 7), np.float32)]
    leaves[0][0, 0, :3] = [-0.0, 0.0, 1e-30]
    leaves[2][:, 1] = -0.0
    got = compressed_psum([torch.tensor(g) for g in leaves[0]])
    want = jax.vmap(lambda g: jcoll.compressed_psum(g, "r"),
                    axis_name="r")(jnp.asarray(leaves[0]))
    for r in range(n):
        np.testing.assert_array_equal(_words(got), _words(want[r]))
    ranks = [[torch.tensor(leaf[r]) for leaf in leaves] for r in range(n)]
    for compression in ("none", "int8"):
        got = dp_grad_mean(ranks, compression)
        want = jax.vmap(lambda *gs: jcoll.dp_grad_mean(
            list(gs), "r", compression), axis_name="r")(
                *[jnp.asarray(leaf) for leaf in leaves])
        assert len(got) == len(leaves)
        for g, w in zip(got, want):
            for r in range(n):
                np.testing.assert_array_equal(_words(g), _words(w[r]))
    with pytest.raises(ValueError, match="unknown compression"):
        dp_grad_mean(ranks, "fp8")


def test_int8_mean_within_five_percent():
    """The reference's data-parallel check: 8 ranks' gradients of a
    least-squares loss, the int8 mean within 5 % of the exact one."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((8, 4, 16)).astype(np.float32))
    w = torch.ones(16, requires_grad=True)
    grads = [[torch.autograd.grad(torch.sum((xb @ w) ** 2), w)[0]]
             for xb in x]
    exact = dp_grad_mean(grads)[0]
    rel = (dp_grad_mean(grads, "int8")[0] - exact).abs().max() / \
        exact.abs().max()
    assert rel < 0.05


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages,micro", [(4, 6), (1, 3), (3, 1), (2, 5)])
def test_pipeline_matches_sequential(stages, micro):
    """Forward and gradients of the pipelined stages equal the sequential
    composition's (the reference's own check, ``tests/test_pipeline.py``),
    and the bubble fraction is the reference's."""
    gen = torch.Generator().manual_seed(stages * 10 + micro)
    ws = [(torch.randn(8, 8, generator=gen) * 0.3).requires_grad_(True)
          for _ in range(stages)]
    xs = torch.randn(micro, 2, 8, generator=gen)
    tg = torch.randn(micro, 2, 8, generator=gen)

    def stage(w, x):
        return torch.tanh(x @ w)

    def mse(o, t):
        return torch.mean((o - t) ** 2)

    seq = xs
    for w in ws:
        seq = stage(w, seq)
    torch.testing.assert_close(pipeline_forward(stage, ws, xs), seq,
                               rtol=0, atol=1e-5)
    g_piped = torch.autograd.grad(pipeline_loss(stage, mse, ws, xs, tg), ws)
    g_seq = torch.autograd.grad(
        torch.stack([mse(o, t) for o, t in zip(seq, tg)]).mean(), ws)
    for a, b in zip(g_piped, g_seq):
        assert a.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert bubble_fraction(micro, stages) == \
        jpipe.bubble_fraction(micro, stages)
    assert bubble_fraction(6, 4) == 3 / 9


# ---------------------------------------------------------------------------
# the serving steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,fsdp", [("gemma3-12b", False),
                                       ("stablelm-1.6b", True)])
def test_prefill_and_decode_steps_match_reference(arch, fsdp):
    """``build_prefill_step`` and ``build_decode_step`` (burst-scheduled
    under ``serve_fsdp``) against the reference's jitted steps on its 1x1
    mesh: logits and every cache leaf within 1e-4; the specs the
    reference's builders give."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype="float32",
                               serve_fsdp=fsdp)
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32",
                              serve_fsdp=fsdp)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    jmesh = jcompat_mesh(jax.devices()[:1], (1, 1), ("data", "model"))
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    pshape, dshape = ("p", 16, 2, "prefill"), ("d", 32, 2, "decode")
    tokens = np.arange(32, dtype=np.int32).reshape(2, 16) % 50
    jpre = jsteps.build_prefill_step(jcfg, JShape(*pshape), jmesh)
    pre = steps.build_step(cfg, ShapeConfig(*pshape), mesh)
    jdec = jsteps.build_decode_step(jcfg, JShape(*dshape), jmesh)
    dec = steps.build_step(cfg, ShapeConfig(*dshape), mesh)
    with jmesh:
        jlogits, jcaches = jax.jit(jpre.fn)(jparams,
                                            {"tokens": jnp.asarray(tokens)})
        jl2, jc2 = jax.jit(jdec.fn)(jparams, japi.init_cache(jcfg, 2, 32),
                                    jnp.full((2, 1), 3, jnp.int32),
                                    jnp.int32(16))
    logits, caches = pre.fn(tparams, {"tokens": tokens})
    l2, c2 = dec.fn(tparams, api.init_cache(cfg, 2, 32, device="cpu"),
                    np.full((2, 1), 3, np.int32), 16)
    for got, want in ((logits, jlogits), (l2, jl2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    for got, want in ((caches, jcaches), (c2, jc2)):
        got = dict(steps._tree_leaves(got))
        for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
            key = tuple(getattr(k, "key", getattr(k, "idx", None))
                        for k in path)
            np.testing.assert_allclose(got[key].float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=1e-4, atol=1e-4)
    big = make_production_mesh(device="cpu")
    jbig = stand_in(big.devices.shape, big.axis_names)
    jsh = jsteps.make_sharder(jcfg, jbig)
    jshapes = jsteps._eval_params(jcfg)
    jp = jsteps.param_specs(jshapes, jcfg, jsh)
    if fsdp:
        jp = jsteps.zero1_specs(jp, jshapes, jsh)
    jc = jsteps.cache_specs(jax.eval_shape(functools.partial(
        japi.init_cache, jcfg, 2, 32)), jcfg, jsh)
    built = steps.build_decode_step(cfg, ShapeConfig(*dshape), big)
    assert port_specs(built.param_specs) == ref_specs(jp)
    assert port_specs(built.cache_specs) == ref_specs(jc)
    assert built.batch_specs == {"token": ()}


def test_resolve_fabric_refuses_as_the_reference():
    from repro.configs.base import FabricConfig as JFabric
    from repro_torch.configs.base import FabricConfig
    cfg, jcfg = get_smoke("stablelm-1.6b"), jget_smoke("stablelm-1.6b")
    n, w = cfg.n_kv_heads, cfg.resolved_head_dim
    for kw, shape in (({"n_ports": n, "lane_width": w + 1}, ("d", 64, 2,
                                                             "decode")),
                      ({"n_ports": n, "lane_width": w, "page_size": 64},
                       ("d", 32, 2, "decode"))):
        with pytest.raises(ValueError) as want:
            jsteps.build_decode_step(
                dataclasses.replace(jcfg, fabric=JFabric(**kw)),
                JShape(*shape), None)
        with pytest.raises(ValueError) as got:
            steps.build_decode_step(
                dataclasses.replace(cfg, fabric=FabricConfig(**kw)),
                ShapeConfig(*shape), None)
        assert str(got.value) == str(want.value)
    fab = steps.resolve_fabric(cfg, ShapeConfig("p", 16, 2, "prefill"))
    assert fab == cfg.resolved_fabric
