"""The port's interconnect slice against the reference: kernels 5-7
(``read_network_tiles``, ``barrel_rotate_groups``, ``stream_matmul``)
through their plain versions and the ``ops`` entry points, the rotation
unit (``core/rotation.py``), the rest of ``core/transpose.py``, the crossbar
baseline (``core/baseline.py``) and the crossbar ``Fabric``, and one smoke
model served one-shot on the crossbar fabric.

Inputs are drawn with numpy from a seed and handed to both packages.
Movement is bit-equal, compared through same-width unsigned views so NaN
payloads and ``-0.0`` compare by their bits.  One reference quirk (ROADMAP
§3): on XLA:CPU the reference quiets bfloat16 NaNs to ``sign | 0x7FC0`` in
its Pallas kernels' selects (interpret mode) and in plain ops as well
(``jnp.roll``, ``jnp.where``, ``jnp.take``); float32 NaNs keep their bits.
The port keeps every bit: it is held exactly to numpy's movement of the
same words, and to the reference up to exactly that canonicalisation of
bfloat16 NaNs.  Matmuls: float32 within rtol 1e-5 (atol 1e-4), bf16
within 2e-2 (the bf16 output's rounding), as ``tests/test_kernels.py``
holds the reference.  The model's logits within 1e-4 and its tokens equal.
On the CPU every wrapper takes its plain version; ``chip_smoke.py`` holds
each CUDA kernel against that plain version on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.configs.base import FabricConfig as JFabricConfig  # noqa: E402
from repro.core import baseline as jb  # noqa: E402
from repro.core import rotation as jrot  # noqa: E402
from repro.core import transpose as jt  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.medusa_transpose import read_network_tiles  # noqa: E402
from repro.kernels.rotator import barrel_rotate_groups  # noqa: E402
from repro.kernels.stream_matmul import stream_matmul  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import FabricConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import baseline as tb  # noqa: E402
from repro_torch.core import rotation as trot  # noqa: E402
from repro_torch.core import transpose as tt  # noqa: E402
from repro_torch.fabric import Fabric  # noqa: E402
from repro_torch.kernels import medusa_transpose as tmt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import rotator as trt  # noqa: E402
from repro_torch.kernels import stream_matmul as tsm  # noqa: E402
from repro_torch.models import api  # noqa: E402

# dtype name → (unsigned word, signed torch view, jax dtype, torch dtype,
# planted special words: NaNs with payload bits and -0.0)
DTYPES = {
    "float32": (np.uint32, np.int32, jnp.float32, torch.float32,
                (0x7FC12345, 0xFF800001, 0x80000000)),
    "bfloat16": (np.uint16, np.int16, jnp.bfloat16, torch.bfloat16,
                 (0x7FC1, 0xFFA5, 0x8000)),
    "int32": (np.uint32, np.int32, jnp.int32, torch.int32, ()),
}


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
    return np.asarray(jax.lax.bitcast_convert_type(
        x, jnp.dtype(DTYPES[name][0])))


def _bits_t(x, name):
    word, signed = DTYPES[name][:2]
    return x.contiguous().view(torch.from_numpy(np.zeros(1, signed)).dtype
                               ).numpy().view(word)


def _pallas_canon(bits, name):
    """The reference kernels' interpret-mode image of ``bits``: bfloat16
    NaNs quieted to ``sign | 0x7FC0``, every other word unchanged."""
    if name != "bfloat16":
        return bits
    nan = ((bits & 0x7F80) == 0x7F80) & ((bits & 0x007F) != 0)
    return np.where(nan, (bits & 0x8000) | 0x7FC0, bits).astype(bits.dtype)


def _same(got, want, name):
    """The port's ``got`` (a tensor) holds the reference's ``want`` (a jax
    array), word for word, up to the reference's bfloat16 NaN
    canonicalisation."""
    np.testing.assert_array_equal(_pallas_canon(_bits_t(got, name), name),
                                  _pallas_canon(_bits_j(want, name), name))


def _normal(rng, shape, jdt, tdt):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


# ----------------------------------------------------------------------------
# kernel 5: the read network on group tiles
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n,g,w", [(8, 4, 4), (16, 2, 8), (32, 1, 16)])
def test_read_network_matches_reference(n, g, w):
    for k, name in enumerate(DTYPES):
        rng = np.random.default_rng(n * 100 + g * 10 + w + k)
        jx, tx = _payload(rng, (g * n, n, w), name)
        oracle = _bits_j(jt.read_network_oracle(jx, n), name)
        plain = tmt.read_network_plain(tx, n)
        assert plain.is_contiguous() and plain.dtype == tx.dtype
        np.testing.assert_array_equal(_bits_t(plain, name), oracle)
        np.testing.assert_array_equal(
            _bits_t(tmt.read_network_tiles(tx, n), name), oracle)
        for on in (True, False):
            tops.use_kernels(on)
            got = tops.interconnect_read(tx, n)
            assert got.is_contiguous()
            np.testing.assert_array_equal(_bits_t(got, name), oracle)
        np.testing.assert_array_equal(
            _bits_j(read_network_tiles(jx, n), name),
            _pallas_canon(oracle, name))


def test_read_network_refuses_what_the_reference_refuses():
    lines = torch.zeros((12, 6, 2))
    with pytest.raises(ValueError):                # N not a power of two
        tmt.read_network_tiles(lines, 6)
    with pytest.raises(ValueError):                # n_words != N
        tmt.read_network_tiles(torch.zeros((8, 4, 2)), 8)
    with pytest.raises(ValueError):                # L % N
        tmt.read_network_tiles(torch.zeros((6, 4, 2)), 4)
    # N = 1 is a power of two: the identity
    x = torch.arange(6.0).reshape(3, 1, 2)
    assert torch.equal(tmt.read_network_tiles(x, 1), x.view(3, 1, 1, 2))


# ----------------------------------------------------------------------------
# kernel 6: the barrel rotator
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n,w", [(1, 3), (2, 5), (8, 4), (64, 8)])
def test_rotate_groups_matches_reference(n, w):
    for k, name in enumerate(("float32", "bfloat16")):
        rng = np.random.default_rng(n * 10 + w + k)
        jx, tx = _payload(rng, (9, n, w), name)
        # 0 and N, negative, at and past N, and seeded amounts in [-4N, 4N)
        amts = np.array([0, n, -1, n - 1, n + 1, -3 * n - 1, 4 * n]
                        + list(rng.integers(-4 * n, 4 * n, 2)), np.int32)
        # ground truth: numpy's roll of each group's words
        bits = _bits_t(tx, name)
        want = np.stack([np.roll(bits[i], -(int(a) % n), axis=0)
                         for i, a in enumerate(amts)])
        ta = torch.from_numpy(amts)
        np.testing.assert_array_equal(
            _bits_t(trt.barrel_rotate_plain(tx, ta), name), want)
        np.testing.assert_array_equal(
            _bits_t(trt.barrel_rotate_groups(tx, ta.long()), name), want)
        for on in (True, False):
            tops.use_kernels(on)
            np.testing.assert_array_equal(
                _bits_t(tops.rotate_groups(tx, ta), name), want)
        # the reference's vmapped oracle and its Pallas kernel, up to the
        # bf16 NaN canonicalisation of XLA:CPU's selects
        canon = _pallas_canon(want, name)
        oracle = _bits_j(jax.vmap(jref.rotate_ref)(jx, jnp.asarray(amts)),
                         name)
        pallas = _bits_j(barrel_rotate_groups(jx, jnp.asarray(amts)), name)
        for ref_bits in (oracle, pallas):
            assert (np.array_equal(ref_bits, want)
                    or np.array_equal(ref_bits, canon))


def test_rotate_groups_refusals():
    x = torch.zeros((3, 4, 2))
    with pytest.raises(ValueError):                # len(amounts) != G
        trt.barrel_rotate_groups(x, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.use_kernels(False)
        tops.rotate_groups(x, torch.zeros(4, dtype=torch.int32))
    tops.use_kernels(True)
    with pytest.raises(ValueError):                # N not a power of two
        trt.barrel_rotate_groups(torch.zeros((3, 6, 2)),
                                 torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):                 # float amounts
        trt.barrel_rotate_groups(x, torch.zeros(3))


# ----------------------------------------------------------------------------
# kernel 7: the streaming matmul
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,name,tol", [
    (128, 128, 128, "float32", 1e-5),
    (256, 384, 128, "float32", 1e-5),
    (128, 256, 256, "bfloat16", 2e-2)])
def test_matmul_matches_reference(m, k, n, name, tol):
    jdt, tdt = DTYPES[name][2], DTYPES[name][3]
    rng = np.random.default_rng(m + k + n)
    jx, tx = _normal(rng, (m, k), jdt, tdt)
    jw, tw = _normal(rng, (k, n), jdt, tdt)
    want = np.asarray(jref.matmul_ref(jx, jw), np.float32)
    pallas = np.asarray(stream_matmul(jx, jw, bm=128, bn=128, bk=128),
                        np.float32)
    np.testing.assert_allclose(pallas, want, rtol=tol, atol=tol * 10)
    for got in (tsm.stream_matmul_plain(tx, tw), tsm.stream_matmul(tx, tw),
                tops.matmul(tx, tw)):
        assert got.dtype == tdt and tuple(got.shape) == (m, n)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol * 10)
        np.testing.assert_allclose(got.float().numpy(), pallas, rtol=tol,
                                   atol=tol * 10)


@pytest.mark.parametrize("name,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_ragged_matmul_matches_reference_ops(name, tol):
    """A shape off the reference's 128-tiles: its ``ops.matmul`` takes the
    oracle there; the port's takes its one kernel (here its plain
    version) for every shape."""
    jdt, tdt = DTYPES[name][2], DTYPES[name][3]
    rng = np.random.default_rng(5)
    jx, tx = _normal(rng, (129, 200), jdt, tdt)
    jw, tw = _normal(rng, (200, 67), jdt, tdt)
    want = np.asarray(jops.matmul(jx, jw), np.float32)
    for on in (True, False):
        tops.use_kernels(on)
        got = tops.matmul(tx, tw)
        assert got.dtype == tdt and tuple(got.shape) == (129, 67)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol * 10)


def test_matmul_refuses_mixed_and_unsupported_pairs():
    x = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        tsm.stream_matmul(x, torch.zeros((3, 2), dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        tops.matmul(x.half(), torch.zeros((3, 2), dtype=torch.half))
    with pytest.raises(ValueError):
        tsm.stream_matmul(x, torch.zeros((4, 2)))
    assert torch.equal(tsm.stream_matmul(torch.zeros((2, 0)),
                                         torch.zeros((0, 5))),
                       torch.zeros((2, 5)))


def test_cpu_tensors_count_no_launch():
    tmt.reset_launch_counts()
    x = torch.zeros((8, 4, 2))
    tops.interconnect_read(x, 4)
    tops.rotate_groups(x, torch.zeros(8, dtype=torch.int32))
    tops.matmul(torch.zeros((2, 3)), torch.zeros((3, 2)))
    counts = tmt.launch_counts()
    assert counts["read_network_tiles"] == 0
    assert counts["barrel_rotate_groups"] == 0
    assert counts["stream_matmul"] == 0


# ----------------------------------------------------------------------------
# core/rotation.py
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4, 8])
def test_barrel_rotate_matches_reference(n):
    rng = np.random.default_rng(n)
    jx, tx = _payload(rng, (3, n, 5), "float32")
    for axis in (1, -2):
        for a in (0, 1, n - 1, n, -1, 3 * n + 2, -5):
            want = _bits_j(jrot.barrel_rotate(jx, jnp.int32(a), axis=axis),
                           "float32")
            np.testing.assert_array_equal(
                _bits_t(trot.barrel_rotate(tx, a, axis=axis), "float32"),
                want)
            np.testing.assert_array_equal(
                _bits_t(trot.barrel_rotate(tx, torch.tensor(a), axis=axis),
                        "float32"), want)


@pytest.mark.parametrize("direction", [-1, 1])
def test_index_twist_matches_reference(direction):
    rng = np.random.default_rng(3)
    for name in ("float32", "bfloat16"):
        jx, tx = _payload(rng, (8, 8, 3), name)
        bits = _bits_t(tx, name)
        for axis, roll_axis in ((0, 1), (1, 0)):
            got = trot.index_twist(tx, axis=axis, roll_axis=roll_axis,
                                   direction=direction)
            # slice b along axis, rolled by direction * b along roll_axis
            want = np.stack([np.roll(np.take(bits, b, axis=axis),
                                     direction * b, axis=0)
                             for b in range(8)], axis=axis)
            np.testing.assert_array_equal(_bits_t(got, name), want)
            _same(got, jrot.index_twist(jx, axis=axis, roll_axis=roll_axis,
                                        direction=direction), name)
        # the two directions undo each other
        back = trot.index_twist(trot.index_twist(tx, direction=direction),
                                direction=-direction)
        np.testing.assert_array_equal(_bits_t(back, name), bits)


def test_mux_cost_models_are_the_reference_integers():
    for w_line in (128, 512, 1024):
        for n in (2, 4, 8, 16, 32, 64):
            assert trot.baseline_mux_count(w_line, n) \
                == jrot.baseline_mux_count(w_line, n)
            assert trot.medusa_mux_count(w_line, n) \
                == jrot.medusa_mux_count(w_line, n)
            assert trot.mux_reduction(w_line, n) \
                == jrot.mux_reduction(w_line, n)
            assert trot.rotation_depth(n) == jrot.rotation_depth(n)
    with pytest.raises(ValueError):
        trot.rotation_depth(6)


# ----------------------------------------------------------------------------
# core/transpose.py: the cycle-accurate pipeline and the rectangular swap
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 8])
def test_cycle_accurate_pipeline_and_trace(n):
    rng = np.random.default_rng(n)
    jx, tx = _payload(rng, (n, n, 3), "float32")
    jout, jtrace = jt.medusa_transpose_cycle_accurate(jx, return_trace=True)
    tout, ttrace = tt.medusa_transpose_cycle_accurate(tx, return_trace=True)
    np.testing.assert_array_equal(_bits_t(tout, "float32"),
                                  _bits_j(jout, "float32"))
    np.testing.assert_array_equal(_bits_t(tout, "float32"),
                                  _bits_t(tx.transpose(0, 1), "float32"))
    assert len(ttrace) == len(jtrace) == n
    for (td, tr, to), (jd, jr, jo) in zip(ttrace, jtrace):
        for a, b in ((td, jd), (tr, jr), (to, jo)):
            np.testing.assert_array_equal(_bits_t(a, "float32"),
                                          _bits_j(b, "float32"))
    np.testing.assert_array_equal(
        _bits_t(tt.medusa_transpose_cycle_accurate(tx), "float32"),
        _bits_t(tout, "float32"))
    assert tt.transposition_latency_cycles(n) \
        == jt.transposition_latency_cycles(n) == n


@pytest.mark.parametrize("shape,tile", [((7, 13), 0), ((3, 100, 36), 0),
                                        ((2, 12, 20), 4), ((1, 9), 0)])
def test_swap_minor_on_rectangular_shapes(shape, tile):
    rng = np.random.default_rng(len(shape) + shape[-1])
    jx, tx = _payload(rng, shape, "int32")
    want = _bits_j(jt.medusa_swap_minor(jx, tile=tile), "int32")
    got = tt.medusa_swap_minor(tx, tile=tile)
    assert got.is_contiguous()
    np.testing.assert_array_equal(_bits_t(got, "int32"), want)
    np.testing.assert_array_equal(want, np.swapaxes(_bits_t(tx, "int32"),
                                                    -1, -2))


def test_port_views_match_reference():
    rng = np.random.default_rng(9)
    jx, tx = _payload(rng, (16, 4, 3), "float32")
    jbank, tbank = jt.read_network_oracle(jx, 4), tt.read_network_oracle(tx, 4)
    for p in range(4):
        np.testing.assert_array_equal(
            _bits_t(tt.port_stream(tbank, p), "float32"),
            _bits_j(jt.port_stream(jbank, p), "float32"))
    np.testing.assert_array_equal(
        _bits_t(tt.port_major_view(tbank), "float32"),
        _bits_j(jt.port_major_view(jbank), "float32"))


# ----------------------------------------------------------------------------
# core/baseline.py
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n,g", [(2, 3), (4, 2), (8, 1)])
def test_crossbar_networks_match_reference(n, g):
    rng = np.random.default_rng(n + g)
    for name in ("float32", "bfloat16"):
        jx, tx = _payload(rng, (g * n, n, 5), name)
        banked = tb.read_network_crossbar(tx, n)
        assert banked.is_contiguous()
        np.testing.assert_array_equal(
            _bits_t(banked, name), _bits_t(tt.read_network_oracle(tx, n),
                                           name))
        _same(banked, jb.read_network_crossbar(jx, n), name)
        lines = tb.write_network_crossbar(banked, n)
        np.testing.assert_array_equal(_bits_t(lines, name), _bits_t(tx, name))
        _same(lines, jb.write_network_crossbar(jb.read_network_crossbar(
            jx, n), n), name)
    with pytest.raises(ValueError):
        tb.read_network_crossbar(torch.zeros((3, n, 2)), n + 1)


def test_width_converter_and_bram_costs_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 6)).astype(np.float32)
    for sel in range(8):
        np.testing.assert_array_equal(
            tb.width_convert_onehot(torch.from_numpy(x), sel).numpy(),
            np.asarray(jb.width_convert_onehot(jnp.asarray(x), sel)))
    for depth, w_line in ((32, 512), (16, 1024), (64, 36), (8, 100)):
        assert tb.fifo_bram_cost(depth, w_line) \
            == jb.fifo_bram_cost(depth, w_line)
    for n, w_acc, burst in ((32, 16, 32), (64, 16, 32), (8, 64, 16),
                            (16, 32, 128)):
        assert tb.medusa_bank_bram_cost(n, w_acc, burst) \
            == jb.medusa_bank_bram_cost(n, w_acc, burst)


# ----------------------------------------------------------------------------
# the crossbar Fabric
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_crossbar_fabric_matches_reference(name):
    n = 4
    jfab = JFabric(JFabricConfig(impl="crossbar", n_ports=n, lane_width=6))
    tfab = Fabric(FabricConfig(impl="crossbar", n_ports=n, lane_width=6))
    assert tfab.latency_cycles == jfab.latency_cycles == n
    rng = np.random.default_rng(21)
    jl, tl = _payload(rng, (3 * n, n, 6), name)
    jbank, tbank = jfab.read(jl), tfab.read(tl)
    _same(tbank, jbank, name)
    _same(tfab.write(tbank), jfab.write(jbank), name)
    # the dense burst and the sparse-extent bursts take the network path
    _same(tfab.read_burst(tl[:n]), jfab.read_burst(jl[:n]), name)
    _same(tfab.write_burst(tbank[0]), jfab.write_burst(jbank[0]), name)
    idx = np.array([5, 3 * n, 0, 11, 2, 3 * n + 7, 9, 1], np.int32)
    _same(tfab.read_burst(tl, indices=torch.from_numpy(idx)),
          jfab.read_burst(jl, indices=jnp.asarray(idx)), name)
    jb2, tb2 = _payload(rng, (2, n, n, 6), name)
    jinto, tinto = _payload(rng, (3 * n, n, 6), name)
    want = jfab.write_burst(jb2, indices=jnp.asarray(idx), into=jinto)
    got = tfab.write_burst(tb2, indices=torch.from_numpy(idx), into=tinto)
    assert got is tinto
    _same(got, want, name)
    # the layout engines: rectangular swap and the KV port-major gather
    jr, tr = _payload(rng, (5, 6, 7), name)
    got = tfab.swap_minor(tr)
    np.testing.assert_array_equal(
        _bits_t(got, name), np.swapaxes(_bits_t(tr, name), -1, -2))
    _same(got, jfab.swap_minor(jr), name)
    jc, tc = _payload(rng, (2, 7, 3, 6), name)
    got = tfab.kv_port_major(tc)
    assert got.is_contiguous() and tuple(got.shape) == (2, 3, 7, 6)
    np.testing.assert_array_equal(
        _bits_t(got, name), np.swapaxes(_bits_t(tc, name), 1, 2))
    _same(got, jfab.kv_port_major(jc), name)
    # data-dependent routing through an index of any shape
    ridx = np.array([[2, 0], [4, 4], [1, 3]], np.int32)
    for axis in (0, 1, -1):
        _same(tfab.route(tr, torch.from_numpy(ridx).long(), axis=axis),
              jfab.route(jr, jnp.asarray(ridx), axis=axis), name)


@pytest.mark.parametrize("impl", ["medusa", "oracle"])
def test_swap_minor_on_every_impl(impl):
    rng = np.random.default_rng(31)
    jx, tx = _payload(rng, (3, 6, 10), "bfloat16")
    cfg = dict(impl=impl, n_ports=2, lane_width=4)
    got = Fabric(FabricConfig(**cfg)).swap_minor(tx)
    assert got.is_contiguous()
    np.testing.assert_array_equal(
        _bits_t(got, "bfloat16"), np.swapaxes(_bits_t(tx, "bfloat16"), -1, -2))
    _same(got, JFabric(JFabricConfig(**cfg)).swap_minor(jx), "bfloat16")


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("impl", ["medusa", "crossbar", "oracle"])
def test_interconnect_shim_matches_reference(impl, n):
    """The deprecated ``Interconnect`` warns as the reference's does and
    delegates to ``Fabric.make(n_ports, impl)``: read, write, swap_minor
    and the latency, bit for bit against the reference's shim."""
    from repro.core import Interconnect as JInterconnect
    from repro_torch.core import Interconnect

    rng = np.random.default_rng(n)
    jl, tl = _payload(rng, (2 * n, n, 3), "float32")
    jx, tx = _payload(rng, (2, n, 2 * n), "float32")
    with pytest.warns(DeprecationWarning, match="Fabric.make"):
        ic = Interconnect(n_ports=n, impl=impl)
    with pytest.warns(DeprecationWarning):
        jic = JInterconnect(n_ports=n, impl=impl)
    banked = ic.read(tl)
    _same(banked, jic.read(jl), "float32")
    _same(ic.write(banked), jic.write(jic.read(jl)), "float32")
    _same(ic.write(banked), jl, "float32")
    _same(ic.swap_minor(tx), jic.swap_minor(jx), "float32")
    assert ic.latency_cycles == jic.latency_cycles


def test_fused_fabric_is_refused():
    """The ``fused`` fabric banks no KV: its consumers attend over the
    line-major cache, so it has no layout engine, and asking it for one
    raises (the reference never calls it there)."""
    fab = Fabric(FabricConfig(impl="fused", n_ports=4, lane_width=2))
    assert not fab.banks_kv and not fab.burst_kernelized
    with pytest.raises(ValueError, match="banks no KV"):
        fab.kv_port_major(torch.zeros((1, 3, 4, 2)))


# ----------------------------------------------------------------------------
# the slice as a whole: one-shot serving on the crossbar fabric
# ----------------------------------------------------------------------------

def test_greedy_generate_on_the_crossbar_fabric_matches_reference():
    """stablelm smoke in float32 with ``kv_layout="crossbar"``: every K/V
    read of the per-layer decode goes through the crossbar gather.  Tokens
    equal the reference's, and each decode step's logits are within 1e-4
    of the reference's step on the same tokens."""
    jcfg = dataclasses.replace(jget_smoke("stablelm-1.6b"), dtype="float32",
                               kv_layout="crossbar")
    tcfg = dataclasses.replace(get_smoke("stablelm-1.6b"), dtype="float32",
                               kv_layout="crossbar")
    assert Fabric.for_model(tcfg).impl == "crossbar"
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 9),
                                               dtype=np.int32)
    steps, t_max = 3, 16
    want = np.asarray(japi.greedy_generate(jparams, jnp.asarray(prompt),
                                           jcfg, steps=steps, t_max=t_max))
    seen = []
    got = api.greedy_generate(tparams, torch.from_numpy(prompt), tcfg,
                              steps=steps, t_max=t_max,
                              on_step=lambda i, lg: seen.append(lg.numpy()))
    np.testing.assert_array_equal(got.numpy(), want)
    jl, jc = japi.prefill_fn(jparams, {"tokens": jnp.asarray(prompt)}, jcfg,
                             t_max)
    tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(steps):
        jl, jc = japi.decode_fn(jparams, tok, jc, prompt.shape[1] + i, jcfg)
        np.testing.assert_allclose(seen[i], np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        tok = jnp.asarray(want[:, i:i + 1])


def test_serve_cli_fabric_impl(capsys):
    from repro_torch.launch import serve
    args = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen-len", "2",
            "--fabric-impl", "crossbar"]
    serve.main(args)
    out = capsys.readouterr().out
    assert "impl=crossbar" in out and "generated (2, 2)" in out
    serve.main(args + ["--engine"])
    out = capsys.readouterr().out
    assert "impl=crossbar" in out and "served 2 requests, 4 tokens" in out
    serve.main(args[:-1] + ["fused"])
    out = capsys.readouterr().out
    assert "impl=fused" in out and "generated (2, 2)" in out
