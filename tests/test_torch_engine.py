"""The port's ServingEngine against the reference's, step for step.

stablelm smoke in float32 with the reference's parameters, two slots and
five requests of varied prompt lengths (so slots retire and refill), on
both engines in lockstep: the page tables agree after every step, the
committed token streams are equal, and admission installs the same number
of prefill bursts.  Tokens are compared exactly, so the test first checks
that the reference run never sits on a near-tie (its smallest top-1/top-2
logit margin exceeds 1e-3): float32 rounding differences between the two
frameworks cannot flip an argmax that far apart.

The reference runs with its kernels off here (its unrolled networks move
the same bits as its Pallas kernels, and recompile faster per bucket);
the port runs with its kernels on, i.e. the plain versions on the CPU.
The kernels-on reference path is held against the port in
``test_torch_model.py`` and ``test_torch_scheduler.py``.

The port counts ``fabric_stats`` once per executed step; the reference's
jitted step counts once per traced bucket, so engine-level counters are
compared only where both count the same thing (prefill bursts) — the
scheduler-level counters are compared field for field in
``test_torch_scheduler.py``.

Also here: the port's runtime imports no JAX and nothing of ``repro``.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROMPT_LENS = (5, 11, 3, 11, 5)
GEN_LENS = (4, 3, 6, 2, 5)


@pytest.fixture(autouse=True)
def _one_thread_and_kernels():
    torch.set_num_threads(1)
    was = jops.kernels_enabled()
    jops.use_kernels(False)
    yield
    jops.use_kernels(was)


def _margin(logits) -> float:
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.mark.parametrize("fused", [
    True,                   # fused decode, sparse-scatter admission
    False])                 # gather-after-burst, dense-burst admission
def test_engine_matches_reference_in_lockstep(fused, monkeypatch):
    jcfg = dataclasses.replace(jget_smoke("stablelm-1.6b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke("stablelm-1.6b"), dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,), dtype=np.int32)
               for n in PROMPT_LENS]
    kw = dict(max_slots=2, t_max=20, page_size=4, fused_gather=fused,
              check_pool=True)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = ServingEngine(tcfg, tparams, **kw)
    jreqs = [JRequest(i, p, max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GEN_LENS))]
    treqs = [Request(i, p, max_new_tokens=g)
             for i, (p, g) in enumerate(zip(prompts, GEN_LENS))]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)

    # the reference's first tokens come from its prefill: their margins too
    margins = []
    prefill = japi.prefill_fn

    def prefill_recording(*args, **kwargs):
        logits, caches = prefill(*args, **kwargs)
        margins.append(_margin(logits[:, -1]))
        return logits, caches
    monkeypatch.setattr(japi, "prefill_fn", prefill_recording)
    # the slots that decoded in a step: live after it, or retired in it
    freed = []
    free = jeng.kv.free
    jeng.kv.free = lambda slot: (freed.append(slot), free(slot))[1]
    steps = 0
    while not jeng.drained:
        freed.clear()
        assert jeng.step() == teng.step()
        np.testing.assert_array_equal(teng.kv.pool.table, jeng.kv.pool.table)
        np.testing.assert_array_equal(teng.pos, jeng.pos)
        rows = sorted(set(freed) | {s for s in range(2)
                                    if jeng.active[s] is not None})
        if rows:
            margins.append(_margin(np.asarray(jeng.last_logits)[rows]))
        steps += 1
        assert steps < 64
    assert len(margins) > len(prompts) and min(margins) > 1e-3, margins
    assert teng.drained
    for jr, tr in zip(jreqs, treqs):
        assert jr.done and tr.done
        assert tr.generated == jr.generated, tr.rid
    assert teng.kv.prefill_bursts == jeng.kv.prefill_bursts > 1
    assert jeng.kv.prefill_splices == 0
    assert (teng.fabric_stats.prefill_bursts
            == jeng.fabric_stats.prefill_bursts)
    assert teng.kv.pool.pages_allocated == jeng.kv.pool.pages_allocated
    teng.kv.pool.check()


def test_engine_refuses_paths_of_later_slices():
    """The refusal that remains: the engine for the encoder-decoder family
    (whisper; the reference's engine refuses it too), whose parameters the
    port now builds.  What items 4, 6, 7.1-7.3 and 8a brought —
    speculative decode (and ``spec_heads``), aging, the bounded queue,
    fault injection, SLO deadlines, the MoE family, the families without a
    full-attention leaf (a ring-only stack, the SSM family), which build
    without a pool and with preemption off, as the reference's, and the
    sharded pool (``pool_shards=2``, its pages striped over two shard
    blocks of one device) — now constructs and runs on the CPU."""
    tcfg = dataclasses.replace(get_smoke("stablelm-1.6b"), dtype="float32")
    from repro_torch.models import api
    from repro_torch.runtime import FaultInjector
    params = api.init_params(tcfg, seed=0, device="cpu")
    sharded = ServingEngine(tcfg, params, max_slots=2, t_max=16,
                            pool_shards=2)
    assert sharded.pool_shards == sharded.kv.pool.n_shards == 2
    assert sharded.fabric.pool_sharded
    assert sharded.fabric.mesh.devices == (torch.device("cpu"),) * 2
    ring_only = dataclasses.replace(tcfg, block_pattern=("L",),
                                    sliding_window=8)
    mamba = dataclasses.replace(get_smoke("mamba2-780m"), dtype="float32")
    for cfg in (ring_only, mamba):
        eng = ServingEngine(cfg, api.init_params(cfg, device="cpu"),
                            max_slots=2, t_max=16)
        assert not eng.paged and eng.preempt == "off"
        assert eng.kv.pool is None
    assert api.init_params(dataclasses.replace(tcfg, family="ssm"),
                           device="cpu").unit[0][0].attn is not None
    from repro_torch.models.whisper import Whisper
    assert isinstance(api.init_params(dataclasses.replace(tcfg,
                                                          family="audio"),
                                      device="cpu"), Whisper)
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine(dataclasses.replace(tcfg, family="audio"), params,
                      max_slots=2, t_max=16)
    granite = get_smoke("granite-moe-3b-a800m")
    assert ServingEngine(granite, api.init_params(granite, device="cpu"),
                         max_slots=2, t_max=16).kv.paged
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, (n,), dtype=np.int32)
               for n in (3, 6, 4)]
    served = {}
    for what, kw in (("plain", {}), ("spec", dict(spec_decode_k=2)),
                     ("aging", dict(aging=3)), ("queue", dict(max_queue=4)),
                     ("faults", dict(fault_injector=FaultInjector(
                         fail_at=(1,), exhaust_pool_at=(2,)))),
                     ("deadlines", {})):
        eng = ServingEngine(tcfg, params, max_slots=2, t_max=16, **kw)
        reqs = [Request(i, p, 4, deadline=12 if what == "deadlines" else None)
                for i, p in enumerate(prompts)]
        assert [eng.submit(r) for r in reqs] == ["queued"] * 3
        eng.run_to_completion(max_steps=64)
        served[what] = [r.generated for r in reqs]
        assert all(len(g) == 4 for g in served[what]), what
    assert all(v == served["plain"] for v in served.values()), served
    assert eng.slo_misses == 0
    heads = dataclasses.replace(tcfg, spec_heads=2)
    hparams = api.init_params(heads, seed=0, device="cpu")
    assert tuple(hparams.draft["w"].shape) == (2, tcfg.d_model, tcfg.d_model)
    eng = ServingEngine(heads, hparams, max_slots=2, t_max=16,
                        spec_decode_k=2)
    assert eng.params is hparams
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, 4))
    eng.run_to_completion(max_steps=64)
    assert eng.spec_proposed > 0


def test_entry_points_need_a_device_or_an_explicit_cpu(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.models import api
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(get_smoke("stablelm-1.6b"))
    assert resolve_device("cpu").type == "cpu"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
    probe = ("import sys, repro_torch.launch.serve, "
             "repro_torch.launch.loadgen, repro_torch.launch.train, "
             "repro_torch.serving.traffic, "
             "repro_torch.core, repro_torch.fabric.sharded, "
             "repro_torch.parallel, repro_torch.launch.mesh; "
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(bool(bad))")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
