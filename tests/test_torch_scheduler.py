"""The port's BurstScheduler against the reference's, stream for stream.

One enqueue sequence — sparse gather and scatter streams (with sentinels)
beside a packed dense group, across two dtypes — runs through both
schedulers in the packed layout.  Movement is exact, so every output is
bit-equal and every ``SchedulerStats`` field is equal; both sides run with
the kernels on (the reference's Pallas kernels in interpret mode, the
port's plain versions on the CPU) and with them off, across word folds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FabricConfig as JFabricConfig  # noqa: E402
from repro.fabric import BurstScheduler as JScheduler  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs.base import FabricConfig  # noqa: E402
from repro_torch.fabric import (FRAME_SENTINEL, BurstScheduler,  # noqa: E402
                                Fabric, SchedulerStats)
from repro_torch.kernels import ops as tops  # noqa: E402

N = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def kernels_switch():
    """Set both packages' kernel switch for one test and restore it."""
    was = (jops.kernels_enabled(), tops.kernels_enabled())

    def set_(on):
        jops.use_kernels(on)
        tops.use_kernels(on)
    yield set_
    jops.use_kernels(was[0])
    tops.use_kernels(was[1])


def _bf16_pair(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def _f32_pair(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _bits_j(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _bits_t(x):
    if x.element_size() == 2:
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return x.contiguous().view(torch.int32).numpy().view(np.uint32)


def _streams(rng):
    """The enqueue sequence, as (method, name, jax args, torch args)."""
    pool_lines = 6 * N
    gather = np.array([5, 17, FRAME_SENTINEL, 2, 9, pool_lines, 11, 0],
                      np.int32)
    scatter = np.array([3, FRAME_SENTINEL, 20, 7, 1, 14, pool_lines, 22],
                       np.int32)
    live = scatter[scatter < pool_lines]
    assert len(np.unique(live)) == len(live)
    out = []
    jp, tp = _bf16_pair(rng, (pool_lines, N, 2, 4))            # bf16 pool
    out.append(("read", "kv/k", (jp,), dict(gather=jnp.asarray(gather)),
                (tp,), dict(gather=torch.from_numpy(gather))))
    jd, td = _bf16_pair(rng, (2 * N, N, 6))                   # dense bf16
    out.append(("read", "dense/bf16", (jd,), {}, (td,), {}))
    for name, shape in (("dense/a", (2 * N, N, 3)), ("dense/b", (N, N, 5))):
        ja, ta = _f32_pair(rng, shape)                        # dense f32
        out.append(("read", name, (ja,), {}, (ta,), {}))
    jb, tb = _bf16_pair(rng, (2, N, N, 2, 4))                 # sparse write
    ji, ti = _bf16_pair(rng, (pool_lines, N, 2, 4))
    out.append(("write", "kv/k_w", (jb,),
                dict(scatter=jnp.asarray(scatter), into=ji),
                (tb,), dict(scatter=torch.from_numpy(scatter),
                            into=ti.clone())))
    jc, tc = _f32_pair(rng, (1, N, N, 7))                     # dense write
    out.append(("write", "dense/c", (jc,), {}, (tc,), {}))
    return out


@pytest.mark.parametrize("kernels,fold", [
    (True, "auto"), (True, 1), (True, 2), (False, "auto"), (False, 1)])
def test_scheduler_bit_equal_with_equal_counters(kernels_switch, kernels,
                                                 fold):
    kernels_switch(kernels)
    rng = np.random.default_rng(7)
    streams = _streams(rng)
    jsched = JScheduler(JFabric(JFabricConfig(n_ports=N, lane_width=8)),
                        pack="packed", word_fold=fold)
    tsched = BurstScheduler(Fabric(FabricConfig(n_ports=N, lane_width=8)),
                            pack="packed", word_fold=fold)
    for method, name, jargs, jkw, targs, tkw in streams:
        js = getattr(jsched, f"enqueue_{method}")(name, *jargs, **jkw)
        ts = getattr(tsched, f"enqueue_{method}")(name, *targs, **tkw)
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    jsched.issue()
    tsched.issue()
    jout, tout = jsched.commit(), tsched.commit()
    assert sorted(jout) == sorted(tout)
    for name in jout:
        assert tuple(jout[name].shape) == tuple(tout[name].shape), name
        np.testing.assert_array_equal(_bits_t(tout[name]),
                                      _bits_j(jout[name]), err_msg=name)
    assert dataclasses.asdict(tsched.stats) == dataclasses.asdict(
        jsched.stats)
    if kernels:
        assert tsched.stats.kernel_bursts > 0
        assert tsched.stats.gather_fused_bursts == 2


def test_sparse_write_lands_in_place():
    """The sparse write scatters into the pool stream itself (the port saves
    the reference's pool-sized functional copy)."""
    fab = Fabric(FabricConfig(n_ports=N, lane_width=2))
    pool = torch.zeros((2 * N, N, 2))
    banked = torch.ones((1, N, N, 2))
    idx = torch.tensor([6, FRAME_SENTINEL, 1, 3], dtype=torch.int32)
    sched = BurstScheduler(fab)
    sched.enqueue_write("w", banked, scatter=idx, into=pool)
    out = sched.flush()["w"]
    assert out is pool
    assert pool[[6, 1, 3]].eq(1).all() and pool[[0, 2, 4, 5, 7]].eq(0).all()
    with pytest.raises(ValueError, match="contiguous"):
        sched.enqueue_write("x", banked, scatter=idx,
                            into=torch.zeros((N, 2 * N, 2)).transpose(0, 1))


def test_pad_layout_is_refused_until_its_slice():
    """The pad layout is ported (its parity with the reference is held in
    ``test_torch_dense_family.py``): it takes the fabric's ``pack`` and
    pads a narrower stream to the widest; an unknown layout still raises."""
    fab = Fabric(FabricConfig(n_ports=N, lane_width=2, pack="pad"))
    sched = BurstScheduler(fab)
    assert sched.pack == "pad"
    sched.enqueue_read("a", torch.ones((N, N, 2)))
    sched.enqueue_read("b", torch.ones((N, N, 3)))
    out = sched.flush()
    assert out["a"].shape == (1, N, N, 2) and out["b"].shape == (1, N, N, 3)
    assert sched.stats.words_padded == N * N
    with pytest.raises(ValueError):
        BurstScheduler(fab, pack="dense")


def test_pipeline_ordering_errors():
    sched = BurstScheduler(Fabric(FabricConfig(n_ports=N, lane_width=2)),
                           stats=SchedulerStats())
    with pytest.raises(RuntimeError):
        sched.commit()
    sched.enqueue_read("a", torch.zeros((N, N, 2)))
    with pytest.raises(ValueError):
        sched.enqueue_read("a", torch.zeros((N, N, 2)))
    sched.issue()
    with pytest.raises(RuntimeError):
        sched.issue()
    assert sched.commit()["a"].shape == (1, N, N, 2)
