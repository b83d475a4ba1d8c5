"""The ring MoE (expert parallelism over an all-to-all) in one process
against the reference: ``moe_apply_shardmap`` over n ranks, both
exchanges, against the reference's per-rank body run under ``jax.vmap``
over a named axis (its ``ring_all_to_all`` rotations included), outputs
and the gradients of every weight leaf; at ample capacity against the
port's single-device ``moe_apply``; the refusals.  No test spawns a
process or opens a process group.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import moe_shardmap as jsm  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.moe_shardmap import (moe_apply_shardmap,  # noqa
                                             shard_expert_params)
from repro_torch.parallel import collectives  # noqa: E402

LEAVES = ("router", "w_gate", "w_out", "w_up")


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


def configs(capacity_factor: float, n_experts: int = 16, pad_to: int = 0):
    """The reference's test layer (d 32, top-2, expert d_ff 64) in float32,
    in both packages."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=0, vocab_size=64, dtype="float32")
    mk = dict(n_experts=n_experts, top_k=2, expert_d_ff=64,
              capacity_factor=capacity_factor, pad_to=pad_to)
    return (JModelConfig(**kw, moe=JMoEConfig(**mk)),
            ModelConfig(**kw, moe=MoEConfig(**mk)))


@functools.lru_cache(maxsize=None)
def reference(n: int, capacity_factor: float):
    """The reference's per-rank body over ``n`` ranks under ``jax.vmap``:
    the parameters, tokens ``[n, 2, 4, 32]``, a cotangent, the outputs and
    the gradients of ``sum(out * cotangent)`` by every weight leaf."""
    jcfg, _ = configs(capacity_factor)
    p = jmoe.moe_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 2, 4, 32)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def body(p_full, xb):
        rank = jax.lax.axis_index("model")
        return jsm.moe_apply_shardmap(
            jsm.shard_expert_params(p_full, rank, n, jcfg), xb, jcfg,
            "model")

    def f(p_full):
        out = jax.vmap(body, in_axes=(None, 0), axis_name="model")(
            p_full, jnp.asarray(x))
        return jnp.sum(out * cot), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(p)
    return ({k: np.asarray(v) for k, v in p.items()}, x, cot,
            np.asarray(out), {k: np.asarray(v) for k, v in grads.items()})


def port(params: dict, x: np.ndarray, cfg, collective: str):
    """The port's ring MoE over ``len(x)`` ranks: the outputs stacked and
    the full weight leaves (each rank's views of them)."""
    n = len(x)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out = moe_apply_shardmap([shard_expert_params(tp, r, n, cfg)
                              for r in range(n)],
                             [torch.tensor(xb) for xb in x], cfg, collective)
    return torch.stack(out), tp


@pytest.mark.parametrize("capacity_factor", (1.25, 16.0))
@pytest.mark.parametrize("n", (1, 2, 4, 8))
def test_ring_moe_matches_vmapped_reference(n, capacity_factor):
    """Outputs within 1e-5 and every weight leaf's gradient within 1e-5 of
    its largest entry, at the reference's capacity of 1.25 (slots drop)
    and at an ample one; ``ring`` and ``xla`` exchanges bit-equal."""
    _, cfg = configs(capacity_factor)
    params, x, cot, want, jgrads = reference(n, capacity_factor)
    outs = {}
    for collective in ("ring", "xla"):
        out, tp = port(params, x, cfg, collective)
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                                   atol=1e-5)
        grads = torch.autograd.grad((out * torch.tensor(cot)).sum(),
                                    [tp[k] for k in LEAVES])
        for name, g in zip(LEAVES, grads):
            w = jgrads[name]
            assert np.abs(w).max() > 0, name
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)
        outs[collective] = out.detach()
    assert torch.equal(outs["ring"], outs["xla"])


def test_capacity_drops_slots_as_the_reference():
    """At capacity 1.25 the rank-local capacity drops assignments: the
    outputs differ from the ample capacity's, as the reference's do."""
    params, x, _, want, _ = reference(2, 1.25)
    ample = reference(2, 16.0)[3]
    assert np.abs(want - ample).max() > 1e-3
    out, _ = port(params, x, configs(1.25)[1], "ring")
    assert np.abs(out.detach().numpy() - ample).max() > 1e-3


@pytest.mark.parametrize("n", (1, 2, 4, 8))
def test_ample_capacity_equals_moe_apply(n):
    """The reference's own check (``tests/test_moe_shardmap.py``): with
    no slot dropped the ring MoE over n ranks equals the single-device
    ``moe_apply`` over all the tokens within 2e-4, through a padded
    expert count too."""
    for pad_to in (0, 24):
        _, cfg = configs(16.0, pad_to=pad_to)
        gen = torch.Generator().manual_seed(n)
        p = moe.moe_params(cfg, torch.float32, gen, "cpu")
        x = torch.randn(n * 2, 4, 32, generator=gen)
        want = moe.moe_apply(p, x, cfg)
        for collective in ("ring", "xla"):
            out = moe_apply_shardmap(
                [shard_expert_params(p, r, n, cfg) for r in range(n)],
                list(x.chunk(n)), cfg, collective)
            torch.testing.assert_close(torch.cat(out), want, rtol=0,
                                       atol=2e-4)


def test_exchanges_and_views(monkeypatch):
    """The ring takes n - 1 rotations each way; the expert shards are
    views of the full leaves; a trained step lowers the loss through both
    exchanges (the reference's ``test_shardmap_moe_trains``, shortened)."""
    _, cfg = configs(8.0, n_experts=8)
    gen = torch.Generator().manual_seed(0)
    p = {k: v.requires_grad_(True) for k, v in
         moe.moe_params(cfg, torch.float32, gen, "cpu").items()}
    loc = shard_expert_params(p, 3, 4, cfg)
    assert loc["router"] is p["router"]
    assert loc["w_up"].data_ptr() == p["w_up"][6].data_ptr()
    assert loc["w_gate"].shape == (2, 32, 64)
    x = torch.randn(8, 4, 32, generator=gen)
    target = torch.tanh(x @ torch.randn(32, 32, generator=gen))
    calls = []
    real = collectives._ppermute

    def counting(xs, shift):
        calls.append(shift)
        return real(xs, shift)

    monkeypatch.setattr(collectives, "_ppermute", counting)
    losses = []
    for _ in range(15):
        out = torch.cat(moe_apply_shardmap(
            [shard_expert_params(p, r, 4, cfg) for r in range(4)],
            list(x.chunk(4)), cfg, "ring"))
        loss = torch.mean((out - target) ** 2)
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for w, g in zip(p.values(), grads):
                w -= 0.3 * g
        losses.append(float(loss.detach()))
    assert calls[:6] == [1, 2, 3, 1, 2, 3]
    assert losses[-1] < 0.9 * losses[0], losses


def test_refusals():
    _, cfg = configs(1.25)
    p = moe.moe_params(cfg, torch.float32, torch.Generator().manual_seed(0),
                       "cpu")
    x = torch.zeros(3, 2, 4, 32)
    with pytest.raises(ValueError, match="do not split evenly over 3"):
        moe_apply_shardmap([p] * 3, list(x), cfg)
    with pytest.raises(ValueError, match="do not split evenly over 3"):
        shard_expert_params(p, 0, 3, cfg)
    locs = [shard_expert_params(p, r, 2, cfg) for r in range(2)]
    with pytest.raises(ValueError, match="unknown collective"):
        moe_apply_shardmap(locs, list(x[:2]), cfg, "mesh")
    with pytest.raises(ValueError, match="one shape"):
        moe_apply_shardmap(locs, [x[0], x[1, :1]], cfg)
    with pytest.raises(ValueError, match="2 ranks' parameters for 4"):
        moe_apply_shardmap(locs, list(torch.zeros(4, 2, 4, 32)), cfg)
    _, bf = configs(1.25)
    bf = dataclasses.replace(bf, dtype="bfloat16")
    pb = {k: v.to(torch.bfloat16) if k != "router" else v
          for k, v in p.items()}
    out = moe_apply_shardmap([shard_expert_params(pb, r, 2, bf)
                              for r in range(2)],
                             list(x[:2].to(torch.bfloat16)), bf)
    assert out[0].dtype == torch.bfloat16
