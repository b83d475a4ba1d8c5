"""The port's KV-cache layout engine (kernel 4, ``medusa_transpose_tiles``)
against the reference's Pallas kernel run in interpret mode, and the
reference's ``ops.transpose_rc`` padding wrapper and
``Fabric.kv_port_major``.  The port's kernel takes any R and C, so the
padded shapes go to it as they are.

Pure movement, so everything is bit-equal.  Payloads are random machine
words drawn with numpy, with NaNs carrying payload bits and ``-0.0``
planted; both sides are compared through same-width unsigned views.  On
the CPU the port's wrapper takes its plain version; ``chip_smoke.py`` holds
the CUDA kernel against that plain version on the card.

One reference quirk (ROADMAP §3): in interpret mode on XLA:CPU the Pallas
kernel's exchange-stage selects quiet every bfloat16 NaN to ``sign |
0x7FC0``, dropping its payload (at tile 1 there is no stage and no select);
float32 NaNs and every other word keep their bits, and the
reference's oracle (``swapaxes``) keeps all of them.  The port keeps every
bit, so it equals the oracle exactly and the Pallas kernel exactly up to
that canonicalisation, which the test states word for word.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.configs.base import FabricConfig as JFabricConfig  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.kernels import medusa_transpose as jmt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import FabricConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fabric import Fabric  # noqa: E402
from repro_torch.kernels import launch as kl  # noqa: E402
from repro_torch.kernels import medusa_transpose as tmt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import whisper  # noqa: E402

# dtype name → (unsigned word, signed torch view, jax dtype, torch dtype,
# planted special words: NaNs with payload bits and -0.0)
DTYPES = {
    "float32": (np.uint32, np.int32, jnp.float32, torch.float32,
                (0x7FC12345, 0xFF800001, 0x80000000)),
    "bfloat16": (np.uint16, np.int16, jnp.bfloat16, torch.bfloat16,
                 (0x7FC1, 0xFFA5, 0x8000)),
    "int32": (np.uint32, np.int32, jnp.int32, torch.int32, ()),
    "uint8": (np.uint8, np.uint8, jnp.uint8, torch.uint8, ()),
}

# the reference's sweep (tests/test_kernels.py) with its tiles, then the
# shapes its wrapper test pads (tile 0 = the reference wrapper's choice)
SHAPES = [(8, 8, 4, 8), (16, 32, 8, 8), (32, 32, 128, 16), (64, 8, 2, 8),
          (128, 128, 16, 32), (7, 13, 5, 0), (100, 36, 3, 0), (1, 9, 2, 0),
          (129, 64, 1, 0)]


@pytest.fixture(autouse=True)
def _one_thread_and_kernels():
    torch.set_num_threads(1)
    was, twas = jops.kernels_enabled(), tops.kernels_enabled()
    jops.use_kernels(True)
    tops.use_kernels(True)
    yield
    jops.use_kernels(was)
    tops.use_kernels(twas)


def _payload(rng, shape, name, table=DTYPES):
    """Random words of ``name``'s width (an entry of ``table``) with its
    special words planted; returns ``(jax array, torch tensor)`` holding
    the same bits."""
    word, signed, jdt, tdt, special = table[name]
    bits = rng.integers(0, np.iinfo(word).max, size=shape, dtype=np.uint64,
                        endpoint=True).astype(word)
    flat = bits.reshape(-1)
    for j, s in enumerate(special):
        flat[(j * 7) % flat.size] = s
    jx = jax.lax.bitcast_convert_type(jnp.asarray(bits), jdt) \
        if jdt != jnp.dtype(word) else jnp.asarray(bits)
    tx = torch.from_numpy(bits.view(signed).copy()).view(tdt)
    return jx, tx


def _bits_j(x, name, table=DTYPES):
    word = table[name][0]
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.dtype(word)))


def _pallas_canon(bits, name, tile):
    """The reference kernel's interpret-mode image of ``bits`` at ``tile``:
    bfloat16 NaNs quieted to ``sign | 0x7FC0`` when there is an exchange
    stage, every other word unchanged."""
    if name != "bfloat16" or tile == 1:
        return bits
    nan = ((bits & 0x7F80) == 0x7F80) & ((bits & 0x007F) != 0)
    return np.where(nan, (bits & 0x8000) | 0x7FC0, bits).astype(bits.dtype)


def _bits_t(x, name, table=DTYPES):
    word, signed = table[name][:2]
    return x.view(torch.from_numpy(np.zeros(1, signed)).dtype).numpy().view(
        word)


@pytest.mark.parametrize("r,c,w,tile", SHAPES)
def test_transpose_matches_pallas(r, c, w, tile):
    # the wrapper's tile (tile 0): min(pow2_floor(R), pow2_floor(C), 64)
    eff = tile or min(1 << (r.bit_length() - 1), 1 << (c.bit_length() - 1),
                      64)
    for k, name in enumerate(DTYPES):
        rng = np.random.default_rng(r * 131 + c * 7 + w + k)
        jx, tx = _payload(rng, (r, c, w), name)
        oracle = _bits_j(jref.transpose_ref(jx), name)
        got_rc = tops.transpose_rc(tx)
        assert got_rc.is_contiguous() and got_rc.dtype == tx.dtype
        np.testing.assert_array_equal(_bits_t(got_rc, name), oracle)
        np.testing.assert_array_equal(
            _bits_t(tmt.medusa_transpose_plain(tx), name), oracle)
        # the reference's padding wrapper over its Pallas kernel
        np.testing.assert_array_equal(
            _bits_j(jops.transpose_rc(jx, tile=tile), name),
            _pallas_canon(oracle, name, eff))
        if tile:              # the reference kernel, at the sweep's tile
            np.testing.assert_array_equal(
                _bits_j(jmt.medusa_transpose_tiles(jx, tile=tile), name),
                _pallas_canon(oracle, name, eff))
        np.testing.assert_array_equal(
            _bits_t(tmt.medusa_transpose_tiles(tx), name), oracle)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_kv_port_major_matches_reference(name):
    """``[B, T, Hkv, D] → [B, Hkv, T, D]`` at the gemma3 smoke geometry
    (T odd, so the wrapper pads), on every impl and kernel setting: the
    port's batch-in-one-launch form equals the reference's vmap."""
    rng = np.random.default_rng(12)
    jx, tx = _payload(rng, (3, 11, 2, 16), name)
    want = _bits_j(jnp.swapaxes(jx, 1, 2), name)
    np.testing.assert_array_equal(
        _bits_j(JFabric(JFabricConfig(impl="medusa", n_ports=2,
                                      lane_width=16)).kv_port_major(jx),
                name), _pallas_canon(want, name, 2))
    for impl in ("medusa", "oracle"):
        for kernels in (True, False):
            tops.use_kernels(kernels)
            fab = Fabric(FabricConfig(impl=impl, n_ports=2, lane_width=16))
            got = fab.kv_port_major(tx)
            assert got.is_contiguous() and tuple(got.shape) == (3, 2, 11, 16)
            np.testing.assert_array_equal(_bits_t(got, name), want)


def test_transpose_wrapper_contract():
    x = torch.arange(2 * 7 * 5 * 3, dtype=torch.int32).reshape(2, 7, 5, 3)
    # the batch form is the per-row transpose, at R and C of any size
    got = tmt.medusa_transpose_tiles(x)
    assert got.is_contiguous() and tuple(got.shape) == (2, 5, 7, 3)
    for b in range(2):
        assert torch.equal(got[b], tmt.medusa_transpose_tiles(x[b]))
        assert torch.equal(got[b], x[b].transpose(0, 1))
    with pytest.raises(ValueError):                 # not [R,C,W] / [B,R,C,W]
        tmt.medusa_transpose_tiles(x[None])
    with pytest.raises(ValueError):
        tmt.medusa_transpose_tiles(x[0, 0])
    # a CPU tensor takes the plain version and counts no launch
    tmt.reset_launch_counts()
    tops.kv_line_to_port(x)
    assert tmt.launch_counts()["medusa_transpose_tiles"] == 0


# ----------------------------------------------------------------------------
# several leaves a launch (medusa_transpose_many), the identity leaf, the
# multi-output autograd Function and the two callers that bank together
# ----------------------------------------------------------------------------

# the multi-leaf cases' dtypes: the sweep's float32, bfloat16 and int32, and
# int8
MANY_DTYPES = {**{k: DTYPES[k] for k in ("float32", "bfloat16", "int32")},
               "int8": (np.uint8, np.int8, jnp.int8, torch.int8, ())}
# leaves of different shapes in one list: R and C not powers of two, 3-D
# and 4-D, C == 1 and R == 1
MANY_SHAPES = [(6, 10, 3), (2, 12, 20, 4), (2, 9, 1, 8), (1, 5, 16)]


def _tile_dividing(r, c):
    """The largest power of two dividing both R and C."""
    t = 1
    while r % (2 * t) == 0 and c % (2 * t) == 0:
        t *= 2
    return t


def _per_row(fn, jx):
    """The reference's ``[R, C, W]`` kernel over a leaf, vmapped over the
    batch of a ``[B, R, C, W]`` one (as its fabric's ``kv_port_major``
    does)."""
    return fn(jx) if jx.ndim == 3 else jax.vmap(fn)(jx)


@pytest.mark.parametrize("name", list(MANY_DTYPES))
def test_transpose_many_matches_pallas_leaf_by_leaf(name):
    """``medusa_transpose_many`` on the CPU (its plain version) over leaves
    of four shapes in one list, each bit-equal to numpy's swap and to the
    per-leaf calls, and held against the reference's padding wrapper
    ``ops.transpose_rc`` and its Pallas kernel at a tile dividing R and C,
    both in interpret mode and vmapped over a batch, up to the bfloat16
    NaN canonicalisation XLA:CPU applies there (module docstring)."""
    rng = np.random.default_rng(40 + len(name))
    pairs = [_payload(rng, shape, name, MANY_DTYPES)
             for shape in MANY_SHAPES]
    got = tmt.medusa_transpose_many([tx for _, tx in pairs])
    assert len(got) == len(pairs)
    for (jx, tx), y in zip(pairs, got):
        r, c = tx.shape[-3], tx.shape[-2]
        assert y.is_contiguous() and y.dtype == tx.dtype
        assert tuple(y.shape) == tuple(tx.shape[:-3]) + (c, r, tx.shape[-1])
        bits = _bits_t(y, name, MANY_DTYPES)
        oracle = np.swapaxes(_bits_t(tx, name, MANY_DTYPES), -3, -2)
        np.testing.assert_array_equal(bits, oracle)
        np.testing.assert_array_equal(
            bits, _bits_t(tmt.medusa_transpose_tiles(tx), name, MANY_DTYPES))
        canon = _pallas_canon(oracle, name, 2)
        np.testing.assert_array_equal(_pallas_canon(
            _bits_j(_per_row(jops.transpose_rc, jx), name, MANY_DTYPES),
            name, 2), canon)
        tile = _tile_dividing(r, c)
        np.testing.assert_array_equal(_pallas_canon(
            _bits_j(_per_row(lambda a: jmt.medusa_transpose_tiles(
                a, tile=tile), jx), name, MANY_DTYPES), name, 2), canon)
    # the ops entry with the kernels on and off: the same words
    for kernels in (True, False):
        tops.use_kernels(kernels)
        for (_, tx), y in zip(pairs, tops.transpose_many(
                [tx for _, tx in pairs])):
            np.testing.assert_array_equal(_bits_t(y, name, MANY_DTYPES),
                                          _bits_t(tmt.medusa_transpose_plain(
                                              tx), name, MANY_DTYPES))


def test_identity_leaf_is_a_contiguous_view_with_no_launch():
    """A leaf with ``C == 1`` (a one-head K/V leaf) or ``R == 1`` swaps to
    itself: every entry returns a contiguous view with the plain swap's
    values, the same ``data_ptr`` as its input, and launches nothing; the
    view aliases the input (a write to one shows in the other)."""
    rng = np.random.default_rng(41)
    one_head = _payload(rng, (2, 9, 1, 16), "bfloat16")[1]
    one_row = _payload(rng, (3, 1, 5, 4), "float32")[1]
    fab = Fabric(FabricConfig(impl="medusa", n_ports=1, lane_width=16))
    kl.reset_launch_counts()
    for x in (one_head, one_row):
        for y in (tmt.medusa_transpose_many([x])[0],
                  tmt.medusa_transpose_tiles(x), tops.transpose_rc(x),
                  tops.transpose_many([x])[0], tops.kv_line_to_port(x),
                  tops.kv_line_to_port([x, x])[1]):
            assert y.is_contiguous() and y.data_ptr() == x.data_ptr()
            np.testing.assert_array_equal(
                y.view(torch.int16).numpy(),
                tmt.medusa_transpose_plain(x).view(torch.int16).numpy())
    y = fab.kv_port_major(one_head)
    assert y.data_ptr() == one_head.data_ptr()
    assert tuple(y.shape) == (2, 1, 9, 16)
    y.view(torch.int16)[0, 0, 3, 5] = 0x1234      # aliasing: one buffer
    assert int(one_head.view(torch.int16)[0, 3, 0, 5]) == 0x1234
    assert kl.launch_counts()["medusa_transpose_tiles"] == 0
    # under grad the identity is a plain view, outside the autograd
    # Function, and its gradient is the plain swap's
    x = torch.tensor(rng.standard_normal((2, 7, 1, 3)).astype(np.float32),
                     requires_grad=True)
    y = tops.transpose_many([x])[0]
    assert "TransposeRC" not in type(y.grad_fn).__name__
    w = torch.tensor(rng.standard_normal((2, 1, 7, 3)).astype(np.float32))
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    torch.testing.assert_close(gx, w.transpose(1, 2), rtol=0, atol=0)


def test_transpose_many_refusals():
    """An empty list, mixed dtypes, leaves on two devices, a leaf of
    another rank and a non-contiguous leaf are refused, on the CPU as on
    the card; the ops entry refuses them the same way."""
    a = torch.zeros((2, 3, 4, 5), dtype=torch.float32)
    for fn in (tmt.medusa_transpose_many, tops.transpose_many):
        with pytest.raises(ValueError, match="no leaves"):
            fn([])
        with pytest.raises(TypeError, match="leaf 1 is torch.bfloat16"):
            fn([a, a.to(torch.bfloat16)])
        with pytest.raises(ValueError, match="leaf 1 on meta"):
            fn([a, a.to("meta")])
        with pytest.raises(ValueError, match="is not"):
            fn([a, a[0, 0]])
        with pytest.raises(ValueError, match="leaf 1 must be contiguous"):
            fn([a, a.transpose(1, 2)])
    with pytest.raises(ValueError, match="leaf 0 must be contiguous"):
        tops.transpose_many([a.transpose(1, 2).requires_grad_()])


def test_transpose_many_autograd_gradient_with_an_unused_output():
    """Leaves that require grad go through the multi-output autograd
    Function (one forward, one backward on all the gradients); an output
    left unused gives its input no gradient, and a leaf that needs none
    gets a non-differentiable output: both exactly as the plain swap."""
    rng = np.random.default_rng(42)
    shapes = [(2, 9, 4, 3), (2, 5, 3, 3), (6, 4, 2)]
    x0 = [torch.tensor(rng.standard_normal(s).astype(np.float32))
          for s in shapes]
    w = [torch.tensor(rng.standard_normal(s).astype(np.float32)).transpose(
        -3, -2) for s in shapes]
    frozen = torch.tensor(rng.standard_normal((2, 3, 5, 3)).astype(
        np.float32))

    def run(swap):
        xs = [x.clone().requires_grad_() for x in x0]
        ys = swap(xs + [frozen])
        loss = (ys[0] * w[0]).sum() + (ys[2] * w[2]).sum()   # ys[1] unused
        return ys, torch.autograd.grad(loss, xs, allow_unused=True)

    ys, got = run(tops.transpose_many)
    yp, want = run(lambda xs: [x.transpose(-3, -2) for x in xs])
    assert all("TransposeRC" in type(y.grad_fn).__name__ for y in ys[:3])
    assert not ys[3].requires_grad
    for y, p in zip(ys, yp):
        torch.testing.assert_close(y, p, rtol=0, atol=0)
    assert got[1] is None and want[1] is None
    for g, p in ((got[0], want[0]), (got[2], want[2])):
        torch.testing.assert_close(g, p, rtol=0, atol=0)


def _spy_many(calls):
    """A stand-in for ``medusa_transpose_many`` that records each call's
    leaf shapes."""
    orig = tmt.medusa_transpose_many

    def spy(xs):
        xs = list(xs)
        calls.append([tuple(x.shape) for x in xs])
        return orig(xs)
    return orig, spy


def test_cached_attention_banks_k_and_v_in_one_call():
    """``cached_attention`` at the gemma3 smoke (float32): K and V banked in
    one call of the multi-leaf entry, the banked words equal bit for bit
    to the reference's layout engine's and to the per-leaf calls, the
    attention bit-equal to the per-leaf path's and within 1e-6 of the
    reference's ``cached_attention`` (an einsum and a softmax, so a
    stated tolerance), at no window and at a window."""
    jcfg = dataclasses.replace(jget_smoke("gemma3-4b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke("gemma3-4b"), dtype="float32")
    rng = np.random.default_rng(43)
    b, t, h, hkv, d = 3, 11, tcfg.n_heads, tcfg.n_kv_heads, \
        tcfg.resolved_head_dim
    q, ck, cv = (rng.standard_normal(s).astype(np.float32) for s in (
        (b, 1, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    pos = np.int32(7)
    kv_pos = np.arange(t, dtype=np.int32)
    valid = kv_pos <= pos
    tq, tk, tv = (torch.from_numpy(a) for a in (q, ck, cv))
    fab = cm._model_fabric(tcfg)
    banked = fab.kv_port_major([tk, tv])
    for x, y in zip((ck, cv), banked):
        np.testing.assert_array_equal(
            y.numpy(), np.asarray(jcm._kv_port_major(jnp.asarray(x), jcfg)))
        np.testing.assert_array_equal(
            y.numpy(), fab.kv_port_major(torch.from_numpy(x)).numpy())
    for window in (0, 4):
        calls = []
        orig, spy = _spy_many(calls)
        tmt.medusa_transpose_many = spy
        try:
            got = cm.cached_attention(
                tq, tk, tv, torch.tensor(pos), torch.from_numpy(kv_pos),
                torch.from_numpy(valid), window, tcfg)
        finally:
            tmt.medusa_transpose_many = orig
        assert calls == [[(b, t, hkv, d)] * 2]
        per_leaf = cm._decode_attention(
            tq, fab.kv_port_major(tk), fab.kv_port_major(tv),
            torch.tensor(pos), torch.from_numpy(kv_pos),
            torch.from_numpy(valid), window)
        torch.testing.assert_close(got, per_leaf, rtol=0, atol=0)
        want = jcm.cached_attention(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(pos), jnp.asarray(kv_pos), jnp.asarray(valid),
            window, jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_enc_cross_kv_banks_every_layer_in_one_call():
    """whisper's ``_enc_cross_kv`` at the whisper smoke (float32): every
    decoder layer's K and V banked in one call of the multi-leaf entry;
    the banked words equal bit for bit to the per-leaf calls on the same
    products and to the reference's layout engine on them; the whole
    within 1e-5 of the reference's ``_enc_cross_kv`` (its products are
    matmuls, so a stated tolerance)."""
    jcfg = dataclasses.replace(jget_smoke("whisper-medium"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke("whisper-medium"), dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(44)
    b, s_enc, hd = 2, tcfg.encoder_seq, tcfg.resolved_head_dim
    enc = rng.standard_normal((b, s_enc, tcfg.d_model)).astype(np.float32)
    layers = tparams.decoder.unbind()
    calls = []
    orig, spy = _spy_many(calls)
    tmt.medusa_transpose_many = spy
    try:
        with torch.no_grad():
            got = whisper._enc_cross_kv(layers, torch.from_numpy(enc), tcfg)
    finally:
        tmt.medusa_transpose_many = orig
    n = tcfg.n_layers
    assert len(got) == n
    assert calls == [[(b, s_enc, tcfg.n_kv_heads, hd)] * (2 * n)]
    jk, jv = jwhisper._enc_cross_kv(jparams, jnp.asarray(enc), jcfg)
    fab = cm._model_fabric(tcfg)
    with torch.no_grad():
        for i, (bp, (k, v)) in enumerate(zip(layers, got)):
            for w, y, jy in (("wk", k, jk[i]), ("wv", v, jv[i])):
                line = (torch.from_numpy(enc) @ bp["xattn"][w]).reshape(
                    b, s_enc, tcfg.n_kv_heads, hd)
                np.testing.assert_array_equal(
                    y.numpy(), fab.kv_port_major(line).numpy())
                np.testing.assert_array_equal(
                    y.numpy(), np.asarray(jcm._kv_port_major(
                        jnp.asarray(line.numpy()), jcfg)))
                np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                           rtol=1e-5, atol=1e-5)
