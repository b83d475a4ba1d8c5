"""whisper-medium, the encoder-decoder family, against the reference: the
config and its parameter count, the audio data stub, the encoder, the
training forward, prefill (every cache leaf), the decode step, greedy
tokens (kernels on, off and on the crossbar fabric), kernel 4's autograd
Function, the loss and its gradients, the serve CLI's one-shot and the
engine's refusal.

The smoke config runs in float32 with the reference's parameters carried
across by ``params_from_jax``; frames and tokens come from numpy seeds or
the data stub.  Values are held within 1e-5, gradient leaves within 1e-4
of their norm, tokens and the data exactly.  The reference cannot take a
gradient through its layout kernel (its Pallas call has no reverse-mode
rule), so the gradients are held to the reference with its kernels off,
which it states is value-identical; the port keeps its kernels on.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import (param_list, params_from_jax,  # noqa: E402
                                 to_reference_tree)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import launch as kl  # noqa: E402
from repro_torch.kernels import medusa_transpose as mt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import whisper  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ARCH = "whisper-medium"
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread_and_kernels():
    """One thread; both kernel switches on, and back as they were."""
    torch.set_num_threads(1)
    was, twas = jops.kernels_enabled(), tops.kernels_enabled()
    jops.use_kernels(True)
    tops.use_kernels(True)
    try:
        yield
    finally:
        jops.use_kernels(was)
        tops.use_kernels(twas)


@functools.lru_cache(maxsize=None)
def _ref_params():
    jcfg = dataclasses.replace(jget_smoke(ARCH), dtype="float32")
    return jcfg, japi.init_params(jcfg, jax.random.PRNGKey(0))


def pair(**over):
    """``(jcfg, tcfg, jparams, tparams)`` of the float32 smoke."""
    jcfg, jparams = _ref_params()
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(get_smoke(ARCH), dtype="float32", **over)
    return jcfg, tcfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _inputs(cfg, b=2, s=6, seed=3):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return frames, tokens


def _close(got, want, what=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got), np.asarray(want), err_msg=what, **TOL)


def leaves_of(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ----------------------------------------------------------------------------
# the config and the data stub
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_and_param_count_match_reference(size):
    tcfg, jcfg = ((get_config(ARCH), jget_config(ARCH)) if size == "full"
                  else (get_smoke(ARCH), jget_smoke(ARCH)))
    for f in dataclasses.fields(tcfg):
        if f.name != "fabric":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    if size == "smoke":
        params = api.init_params(tcfg, device="cpu")
        assert isinstance(params, whisper.Whisper)
        assert sum(p.numel() for p in params.parameters()) == sum(
            np.size(x) for x in jax.tree.leaves(
                japi.init_params(jcfg, jax.random.PRNGKey(0))))


def test_audio_batch_bit_equal_to_reference():
    """The audio stub: ``encoder_seq`` float32 frames drawn after the
    tokens, bit for bit."""
    for step in (0, 2):
        want = JSyntheticLM(jget_smoke(ARCH), batch=3, seq=7,
                            seed=4).batch_at(step)
        got = SyntheticLM(get_smoke(ARCH), batch=3, seq=7,
                          seed=4).batch_at(step)
        assert set(got) == set(want) == {"tokens", "targets", "frames"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k].view(np.uint32)
                                          if k == "frames" else got[k],
                                          want[k].view(np.uint32)
                                          if k == "frames" else want[k])
        assert got["frames"].shape == (3, 8, 48)


# ----------------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------------

def test_encode_forward_prefill_and_decode_match_reference():
    jcfg, tcfg, jparams, tparams = pair()
    frames, tokens = _inputs(jcfg)
    jf, jt = jnp.asarray(frames), jnp.asarray(tokens)
    tf, tt = torch.tensor(frames), torch.tensor(tokens)
    with torch.no_grad():
        _close(whisper.encode(tparams, tf, tcfg),
               jwhisper.encode(jparams, jf, jcfg), "encode")
        _close(whisper.forward(tparams, tt, tf, tcfg),
               jwhisper.forward(jparams, jt, jf, jcfg), "forward")
        t_max = 10
        logits, cache = api.prefill_fn(tparams, {"tokens": tt,
                                                 "frames": frames},
                                       tcfg, t_max)
        jlogits, jcache = japi.prefill_fn(jparams, {"tokens": jt,
                                                    "frames": jf},
                                          jcfg, t_max)
        _close(logits, jlogits, "prefill logits")
        assert set(cache) == set(jcache)
        for name, leaf in cache.items():
            assert tuple(leaf.shape) == jcache[name].shape, name
            _close(leaf, jcache[name], name)
        tok = np.argmax(np.asarray(jlogits)[:, -1], -1)[:, None].astype(
            np.int32)
        for pos in (6, 7):
            logits, cache = api.decode_fn(tparams, torch.tensor(tok), cache,
                                          pos, tcfg)
            jlogits, jcache = japi.decode_fn(jparams, jnp.asarray(tok),
                                             jcache, jnp.int32(pos), jcfg)
            _close(logits, jlogits, f"decode logits at {pos}")
            for name, leaf in cache.items():
                _close(leaf, jcache[name], f"{name} after decode at {pos}")
            tok = np.argmax(np.asarray(jlogits)[:, -1], -1)[:, None].astype(
                np.int32)
        with pytest.raises(ValueError, match="outside the KV cache"):
            api.decode_fn(tparams, torch.tensor(tok), cache, t_max, tcfg)


_greedy = jax.jit(japi.greedy_generate, static_argnums=(2, 3, 4))


def test_greedy_tokens_equal_kernels_on_off_and_crossbar():
    """Greedy tokens equal the reference's with the port's kernels on, off
    and on the crossbar fabric; kernel 4 runs once at prefill (every
    decoder layer's cross K and V in one call) and once per layer per step
    (the self cache's K and V) — no launch on the CPU, where the plain
    versions run, so the counts are held through the multi-leaf wrapper's
    calls."""
    jcfg, tcfg, jparams, tparams = pair()
    frames, tokens = _inputs(jcfg, b=2, s=5, seed=8)
    want = np.asarray(_greedy(jparams, jnp.asarray(tokens), jcfg, 6, 12,
                              {"frames": jnp.asarray(frames)}))
    calls = []
    orig = mt.medusa_transpose_many

    def counting(xs):
        calls.append([tuple(x.shape) for x in xs])
        return orig(xs)

    for what in ("on", "off", "crossbar"):
        cfg = (dataclasses.replace(tcfg, kv_layout="crossbar")
               if what == "crossbar" else tcfg)
        tops.use_kernels(what != "off")
        calls.clear()
        mt.medusa_transpose_many = counting
        try:
            with torch.no_grad():
                got = api.greedy_generate(
                    tparams, torch.tensor(tokens), cfg, steps=6, t_max=12,
                    extra={"frames": frames})
        finally:
            mt.medusa_transpose_many = orig
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
        n = tcfg.n_layers
        assert len(calls) == (1 + n * 6 if what == "on" else 0), what
        if what == "on":
            assert calls[0] == [(2, 8, 4, 12)] * (2 * n)
            assert all(len(c) == 2 for c in calls[1:])


def test_transpose_autograd_function_gradient_is_the_plain_swap():
    """``ops.transpose_rc`` of a tensor that requires grad: the forward and
    the gradient equal the plain swap's; its backward runs the layout
    engine again (counted as a backward launch on the card; here the
    wrapper runs its plain version)."""
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.standard_normal((2, 9, 4, 3)).astype(np.float32))
    w = torch.tensor(rng.standard_normal((2, 4, 9, 3)).astype(np.float32))
    x = x0.clone().requires_grad_(True)
    y = tops.transpose_rc(x)
    assert y.grad_fn is not None and "TransposeRC" in type(y.grad_fn).__name__
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    xp = x0.clone().requires_grad_(True)
    yp = xp.transpose(1, 2)
    (gp,) = torch.autograd.grad((yp * w).sum(), xp)
    torch.testing.assert_close(y, yp, rtol=0, atol=0)
    torch.testing.assert_close(gx, gp, rtol=0, atol=0)
    with torch.no_grad():
        assert tops.transpose_rc(x).grad_fn is None
    kl.reset_launch_counts()
    assert kl.backward_launch_counts()["medusa_transpose_tiles"] == 0


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_reference_kernels_off(remat):
    """``loss_fn`` and every gradient leaf against the reference's with its
    kernels off (its layout kernel has no reverse-mode rule); the port's
    kernels stay on, through kernel 4's autograd Function."""
    jcfg, tcfg, jparams, tparams = pair(remat=remat)
    batch = JSyntheticLM(jcfg, batch=2, seq=6, seed=2).batch_at(0)
    jops.use_kernels(False)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, jcfg)))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    ps = param_list(tparams)
    for p in ps:
        p.requires_grad_(True)
    loss = api.loss_fn(tparams, {k: torch.as_tensor(v)
                                 for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(loss, ps)
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=1e-5)
    got = leaves_of(to_reference_tree(tparams, grads))
    want = leaves_of(jgrads)
    assert set(got) == set(want)
    for key, w in want.items():
        err = np.linalg.norm(got[key] - w)
        assert err <= 1e-4 * np.linalg.norm(w) + 1e-9, (key, err)
    assert np.linalg.norm(got["['decoder']['xattn']['wk']"]) > 0
    assert np.linalg.norm(got["['encoder']['attn']['wq']"]) > 0


# ----------------------------------------------------------------------------
# the CLI and the engine
# ----------------------------------------------------------------------------

def test_serve_cli_one_shot(capsys):
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "5", "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "arch=whisper-smoke" in out and "generated (2, 3)" in out


def test_engine_refuses_the_encoder_decoder():
    cfg = get_smoke(ARCH)
    params = api.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine(cfg, params, max_slots=2, t_max=16)
    with pytest.raises(ValueError, match="decoder-only"):
        api.init_cache(cfg, 2, 16, pool_pages=4, page_size=4, device="cpu")
