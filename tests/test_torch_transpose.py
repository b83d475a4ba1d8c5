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

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FabricConfig as JFabricConfig  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.kernels import medusa_transpose as jmt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.configs.base import FabricConfig  # noqa: E402
from repro_torch.fabric import Fabric  # noqa: E402
from repro_torch.kernels import medusa_transpose as tmt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

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


def _payload(rng, shape, name):
    """Random words of ``name``'s width with its special words planted;
    returns ``(jax array, torch tensor)`` holding the same bits."""
    word, signed, jdt, tdt, special = DTYPES[name]
    bits = rng.integers(0, np.iinfo(word).max, size=shape, dtype=np.uint64,
                        endpoint=True).astype(word)
    flat = bits.reshape(-1)
    for j, s in enumerate(special):
        flat[(j * 7) % flat.size] = s
    jx = jax.lax.bitcast_convert_type(jnp.asarray(bits), jdt) \
        if jdt != jnp.dtype(word) else jnp.asarray(bits)
    tx = torch.from_numpy(bits.view(signed).copy()).view(tdt)
    return jx, tx


def _bits_j(x, name):
    word = DTYPES[name][0]
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.dtype(word)))


def _pallas_canon(bits, name, tile):
    """The reference kernel's interpret-mode image of ``bits`` at ``tile``:
    bfloat16 NaNs quieted to ``sign | 0x7FC0`` when there is an exchange
    stage, every other word unchanged."""
    if name != "bfloat16" or tile == 1:
        return bits
    nan = ((bits & 0x7F80) == 0x7F80) & ((bits & 0x007F) != 0)
    return np.where(nan, (bits & 0x8000) | 0x7FC0, bits).astype(bits.dtype)


def _bits_t(x, name):
    word, signed = DTYPES[name][:2]
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
