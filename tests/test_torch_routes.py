"""The routes of the port's redesigned kernels on the CPU: which kernel
``stream_matmul.route`` picks for each dtype, shape and alignment, the plain
version against the reference's oracle at each route's boundary, the dense
burst (``burst_network_tiles``) and the read- and write-side bursts
(``gather_burst_network_tiles``, ``scatter_burst_network_tiles``) viewed as
row copies of the widest word dividing each row and both buffers'
alignment, and the plain versions of both sparse bursts and of the layout
engine (``medusa_transpose_tiles``) against the reference's Pallas kernels
in interpret mode on both sides of the 16-byte row word.

Inputs are drawn with numpy from a seed and handed to both packages.
Matmuls: float32 within rtol 1e-5 (atol 1e-4), bf16 within one bf16 ulp of
the reference's cast (the two fp32 sums may round to neighbouring bf16
values); N differs from K everywhere, so a product with w transposed cannot
pass.  The bursts and the layout engine are word movement, so they are
bit-equal (bf16 NaN payloads up to the reference's quieting, ROADMAP §3).  On a CPU tensor
every route computes the plain version, so the routes' kernels are
exercised only on the card: ``chip_smoke.py`` holds each of them against
the plain version there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import medusa_transpose as jmt  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import launch as kl  # noqa: E402
from repro_torch.kernels import medusa_transpose as tmt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import stream_matmul as tsm  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
S = tsm.SMALL_M


@pytest.fixture(autouse=True)
def _one_thread_and_kernels():
    torch.set_num_threads(1)
    was = tops.kernels_enabled()
    tops.use_kernels(True)
    yield
    tops.use_kernels(was)


# ----------------------------------------------------------------------------
# kernel 7: the route table
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k,dtype,x_ptr,w_ptr,want", [
    (4, 10240, 2560, BF16, 0, 0, "small_m"),          # decode
    (6144, 10240, 2560, BF16, 0, 0, "wgmma"),         # prefill
    (S, 10240, 2560, BF16, 0, 0, "small_m"),          # at the threshold
    (S + 1, 10240, 2560, BF16, 0, 0, "wgmma"),        # just above it
    (1, 8, 8, BF16, 16, 32, "small_m"),
    (129, 67, 200, BF16, 0, 0, "mma_sync"),           # N % 8
    (129, 64, 200 + 4, BF16, 0, 0, "mma_sync"),       # K % 8
    (4, 64, 196, BF16, 0, 0, "mma_sync"),             # K % 8 at small M
    (64, 64, 64, BF16, 2, 0, "mma_sync"),             # x 2-byte aligned
    (64, 64, 64, BF16, 0, 8, "mma_sync"),             # w 8-byte aligned
    (5, 7, 0, BF16, 0, 0, "mma_sync"),                # K == 0
    (1024, 1024, 1024, F32, 0, 0, "fma"),
    (4, 10240, 2560, F32, 0, 0, "fma"),
    (129, 67, 200, F32, 4, 4, "fma"),
])
def test_matmul_route_table(m, n, k, dtype, x_ptr, w_ptr, want):
    assert tsm.route(m, n, k, dtype, x_ptr, w_ptr) == want
    assert want in tsm.ROUTES


def test_matmul_routes_are_distinct_c_numbers():
    assert sorted(tsm.ROUTES.values()) == list(range(len(tsm.ROUTES)))
    assert 1 <= tsm.SMALL_M <= 16       # the small-M kernel keeps <= 16 rows


def test_matmul_route_of_an_unaligned_view():
    """A view 2 bytes off its buffer's start cannot feed TMA or 16-byte
    loads: the ``mma_sync`` route, whatever the shape."""
    base = torch.zeros(1 + 64 * 64, dtype=BF16)
    x = base[1:].view(64, 64)
    w = torch.zeros((64, 128), dtype=BF16)
    assert x.data_ptr() % 16 == 2
    assert tsm.route(64, 128, 64, BF16, x.data_ptr(), w.data_ptr()) \
        == "mma_sync"
    assert tsm.route(64, 128, 64, BF16, w.data_ptr(), w.data_ptr()) \
        == "wgmma"


# ----------------------------------------------------------------------------
# kernel 7: the plain version at each route's boundary
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,dtype,want_route", [
    (4, 24, 40, BF16, "small_m"),
    (S, 24, 40, BF16, "small_m"),
    (S + 1, 24, 40, BF16, "wgmma"),
    (130, 72, 264, BF16, "wgmma"),
    (33, 20, 24, BF16, "mma_sync"),              # K % 8
    (9, 16, 12, BF16, "mma_sync"),               # N % 8
    (70, 33, 65, F32, "fma"),
    (4, 24, 40, F32, "fma"),
])
def test_matmul_plain_matches_reference_at_route_boundaries(m, k, n, dtype,
                                                            want_route):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    want = np.asarray(jref.matmul_ref(jnp.asarray(x).astype(jdt),
                                      jnp.asarray(w).astype(jdt)),
                      np.float32)
    tx, tw = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    # fresh CPU tensors are 16-byte aligned: the route follows the shape
    assert tsm.route(m, n, k, dtype, tx.data_ptr(), tw.data_ptr()) \
        == want_route
    got = tsm.stream_matmul_plain(tx, tw)
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    if dtype == F32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
        return
    # one ulp of the reference's bf16 value: the next bf16 above its
    # magnitude, less the magnitude
    mag = torch.from_numpy(np.abs(want)).to(BF16)
    ulp = ((mag.view(torch.int16) + 1).view(BF16).float() - mag.float())
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= ulp.numpy()).all(), float((diff - ulp.numpy()).max())


# ----------------------------------------------------------------------------
# kernel 3: the dense burst as a row copy
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,w,offset,want", [
    (torch.int32, 4, 0, 16),        # 16-byte rows
    (torch.int32, 98304, 0, 16),    # stablelm-1.6b's packed burst row
    (torch.int32, 6, 0, 8),         # 24-byte rows
    (torch.int32, 5, 0, 4),         # 20-byte rows
    (torch.int16, 3, 0, 2),
    (torch.uint8, 5, 0, 1),
    (torch.int32, 4, 1, 4),         # a view 4 bytes off the buffer's start
    (torch.int16, 8, 1, 2),         # 2 bytes off
])
def test_row_word_on_burst_tiles(dtype, w, offset, want):
    n = 4
    base = torch.zeros(offset + n * n * w, dtype=dtype)
    tile = base[offset:].view(n, n, w)
    out = torch.empty_like(tile)
    assert kl.row_word(tile, out) == want
    assert (w * tile.element_size()) % want == 0


def _words(rng, shape, dt):
    return rng.integers(0, np.iinfo(dt).max, size=shape, dtype=np.uint64,
                        endpoint=True).astype(dt)


@pytest.mark.parametrize("n,dt,w", [(4, np.uint32, 5), (8, np.uint32, 6),
                                    (4, np.uint16, 7), (2, np.uint8, 9),
                                    (32, np.uint32, 3)])
def test_burst_network_matches_pallas_off_16_byte_rows(n, dt, w):
    """Rows of 20, 24, 14, 9 and 12 bytes: the row copy moves them in 4, 8,
    2, 1 and 4-byte words; the result is the Pallas kernel's, bit for bit,
    and applying it twice gives the input."""
    assert (w * np.dtype(dt).itemsize) % 16
    rng = np.random.default_rng(n * 31 + w)
    tile = _words(rng, (n, n, w), dt)
    signed = {np.uint8: np.uint8, np.uint16: np.int16,
              np.uint32: np.int32}[dt]
    tt = torch.from_numpy(tile.view(signed).copy())
    want = np.asarray(jmt.burst_network_tiles(jnp.asarray(tile), n))
    got = tmt.burst_network_tiles(tt, n)
    np.testing.assert_array_equal(got.numpy().view(dt), want)
    back = tmt.burst_network_tiles(got, n)
    np.testing.assert_array_equal(back.numpy().view(dt), tile)


# ----------------------------------------------------------------------------
# kernels 1, 2 and 4: the sparse bursts and the layout engine as row copies
# ----------------------------------------------------------------------------

def _signed(a):
    return a.view({np.uint8: np.uint8, np.uint16: np.int16,
                   np.uint32: np.int32}[a.dtype.type])


@pytest.mark.parametrize("dtype,w,off,want", [
    (torch.int32, 32, 0, 16),        # stablelm-1.6b's 128-byte rows
    (torch.int32, 128, 0, 16),       # gemma3-4b's 512-byte rows
    (torch.int32, 32, 1, 4),         # lines 4 bytes off
    (torch.int32, 32, 2, 8),         # 8 bytes off
    (torch.int32, 32, 3, 4),         # 12 bytes off
    (torch.int16, 64, 1, 2),         # 2 bytes off
    (torch.int16, 3, 0, 2),          # 6-byte rows
    (torch.uint8, 5, 0, 1),          # 5-byte rows
    (torch.int32, 1, 0, 4),          # 4-byte rows
])
def test_row_word_on_gather_operands(dtype, w, off, want):
    """The gather's row word divides the row's bytes and the alignment of
    ``lines`` and of the fresh ``out``: frame offsets are whole rows, so
    every word the kernel moves stays aligned."""
    n, lines, k = 4, 8, 8
    base = torch.zeros(off + lines * n * w, dtype=dtype)
    src = base[off:].view(lines, n, w)
    out = torch.empty((k // n, n, n, w), dtype=dtype)
    assert out.data_ptr() % 16 == 0
    assert kl.row_word(src, out) == want
    assert (w * src.element_size()) % want == 0


def _gather_check(lines, idx, n, dt, tl):
    """The Pallas gather on ``lines`` against the plain version and the CPU
    wrapper on ``tl`` (the same words), bit for bit; sentinel frames are
    zeros."""
    want = np.asarray(jmt.gather_burst_network_tiles(
        jnp.asarray(lines), jnp.asarray(idx), n))
    ti = torch.from_numpy(idx)
    for got in (tmt.gather_burst_plain(tl, ti, n),
                tmt.gather_burst_network_tiles(tl, ti, n)):
        assert got.is_contiguous() and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy().view(dt), want)
    sentinel = (idx < 0) | (idx >= lines.shape[0])
    assert sentinel.any()
    frames = want.transpose(0, 2, 1, 3).reshape((len(idx),) + lines.shape[1:])
    assert not frames[sentinel].any()
    np.testing.assert_array_equal(frames[~sentinel], lines[idx[~sentinel]])


# (N, word, W): rows of 16-byte multiples (the 16-byte row word) and rows
# that are not (narrower words), at N = 1, 4, 8 and 32
GATHER_CASES = [(1, np.uint32, 4), (1, np.uint16, 3), (4, np.uint32, 4),
                (4, np.uint32, 128), (4, np.uint16, 3), (4, np.uint8, 5),
                (8, np.uint32, 1), (8, np.uint16, 8), (32, np.uint32, 32),
                (32, np.uint16, 5), (32, np.uint8, 16)]


@pytest.mark.parametrize("n,dt,w", GATHER_CASES)
def test_gather_plain_matches_pallas_at_row_word_boundaries(n, dt, w):
    """Groups of live frames, of live frames mixed with sentinels (L and
    2^30) and of sentinels only: the plain version and the wrapper on the
    CPU equal the Pallas kernel bit for bit, with zero frames at the
    sentinels."""
    rng = np.random.default_rng(n * 103 + w * 5 + np.dtype(dt).itemsize)
    n_lines = 6 * n
    perm = rng.permutation(n_lines)
    ar = np.arange(n)
    mixed = np.where(ar % 2 == 0, perm[2 * n:3 * n],
                     np.where(ar % 4 == 1, n_lines, 2 ** 30))
    sentinels = np.where(ar % 2 == 0, 2 ** 30, n_lines)
    idx = np.concatenate([perm[:n], mixed, sentinels,
                          perm[n:2 * n]]).astype(np.int32)
    lines = _words(rng, (n_lines, n, w), dt)
    tl = torch.from_numpy(_signed(lines)).clone()
    row = w * np.dtype(dt).itemsize
    out = torch.empty((len(idx) // n, n, n, w), dtype=tl.dtype)
    assert kl.row_word(tl, out) == max(b for b in (1, 2, 4, 8, 16)
                                       if row % b == 0)
    _gather_check(lines, idx, n, dt, tl)


@pytest.mark.parametrize("off,want", [(1, 4), (2, 8), (3, 4)])
def test_gather_plain_on_views_off_alignment(off, want):
    """``lines`` as a view 1-3 words off 16-byte alignment (the row copy
    then moves 4- or 8-byte words): the Pallas kernel's frames, and the
    same as from an aligned copy."""
    n, w, n_lines = 4, 8, 20
    rng = np.random.default_rng(17 + off)
    idx = np.concatenate([rng.permutation(n_lines)[:2 * n],
                          np.full(n, n_lines),
                          np.full(n, 2 ** 30)]).astype(np.int32)
    lines = _words(rng, (n_lines, n, w), np.uint32)
    base = torch.zeros(off + lines.size, dtype=torch.int32)
    tl = base[off:].view(lines.shape)
    tl.copy_(torch.from_numpy(_signed(lines)))
    assert tl.data_ptr() % 16 == 4 * off
    out = torch.empty((len(idx) // n, n, n, w), dtype=torch.int32)
    assert kl.row_word(tl, out) == want
    _gather_check(lines, idx, n, np.uint32, tl)
    np.testing.assert_array_equal(
        tmt.gather_burst_network_tiles(tl, torch.from_numpy(idx), n).numpy(),
        tmt.gather_burst_plain(tl.clone(), torch.from_numpy(idx), n).numpy())


@pytest.mark.parametrize("dtype,w,off_b,off_i,want", [
    (torch.int32, 32, 0, 0, 16),     # stablelm-1.6b's 128-byte rows
    (torch.int32, 128, 0, 0, 16),    # gemma3-4b's 512-byte rows
    (torch.int16, 64, 1, 0, 2),      # banked 2 bytes off
    (torch.int32, 32, 1, 0, 4),      # banked 4 bytes off
    (torch.int32, 128, 0, 2, 8),     # into 8 bytes off
    (torch.int32, 32, 2, 1, 4),      # 8 and 4 bytes off: the narrower
    (torch.int16, 256, 4, 4, 8),     # both 8 bytes off, 512-byte rows
    (torch.int16, 3, 0, 0, 2),       # 6-byte rows
])
def test_row_word_on_scatter_operands(dtype, w, off_b, off_i, want):
    """The scatter's row word divides the row's bytes and the alignment of
    both ``banked`` and ``into``: frame offsets are whole rows, so every
    word the kernel moves stays aligned."""
    n, g, lines = 4, 2, 8
    bb = torch.zeros(off_b + g * n * n * w, dtype=dtype)
    ib = torch.zeros(off_i + lines * n * w, dtype=dtype)
    banked = bb[off_b:].view(g, n, n, w)
    into = ib[off_i:].view(lines, n, w)
    assert kl.row_word(banked, into) == want
    assert kl.row_word(into, banked) == want
    assert (w * banked.element_size()) % want == 0


# (N, word, W): rows of 16-byte multiples (the 16-byte row word) and
# rows that are not (narrower words), at N = 1, 4 and 32
SCATTER_CASES = [(1, np.uint32, 4), (1, np.uint16, 3), (4, np.uint32, 4),
                 (4, np.uint32, 128), (4, np.uint16, 3), (4, np.uint8, 5),
                 (32, np.uint32, 32), (32, np.uint16, 5), (32, np.uint8, 16)]


@pytest.mark.parametrize("n,dt,w", SCATTER_CASES)
def test_scatter_plain_matches_pallas_at_row_word_boundaries(n, dt, w):
    """Groups of live frames, of live frames mixed with sentinels (L and
    2^30) and of sentinels only: the plain version and the wrapper on the
    CPU equal the Pallas kernel bit for bit, and rows no index names keep
    their bytes."""
    rng = np.random.default_rng(n * 101 + w * 7 + np.dtype(dt).itemsize)
    lines = 6 * n
    perm = rng.permutation(lines)
    mixed = np.where(np.arange(n) % 2 == 0, perm[2 * n:3 * n],
                     np.where(np.arange(n) % 4 == 1, lines, 2 ** 30))
    idx = np.concatenate([perm[:n], mixed, np.full(n, lines),
                          perm[n:2 * n]]).astype(np.int32)
    g = len(idx) // n
    banked = _words(rng, (g, n, n, w), dt)
    into = _words(rng, (lines, n, w), dt)
    want = np.asarray(jmt.scatter_burst_network_tiles(
        jnp.asarray(banked), jnp.asarray(idx), jnp.asarray(into), n))
    tb, ti = torch.from_numpy(_signed(banked)), torch.from_numpy(idx)
    plain = tmt.scatter_burst_plain(tb, ti, torch.from_numpy(
        _signed(into).copy()), n)
    np.testing.assert_array_equal(plain.numpy().view(dt), want)
    target = torch.from_numpy(_signed(into).copy())
    got = tmt.scatter_burst_network_tiles(tb, ti, target, n)
    assert got is target
    np.testing.assert_array_equal(got.numpy().view(dt), want)
    live = idx[(idx >= 0) & (idx < lines)]
    untouched = np.setdiff1d(np.arange(lines), live)
    assert len(untouched) > 0
    np.testing.assert_array_equal(want[untouched], into[untouched])


def test_scatter_plain_on_views_off_alignment():
    """``banked`` and ``into`` as views 4 and 8 bytes off 16-byte
    alignment (the row copy then moves 4-byte words): the same frames as
    from aligned copies, and the Pallas kernel's."""
    n, w, lines = 4, 8, 20
    rng = np.random.default_rng(5)
    idx = np.concatenate([rng.permutation(lines)[:2 * n],
                          np.full(n, lines)]).astype(np.int32)
    banked = _words(rng, (3, n, n, w), np.uint32)
    into = _words(rng, (lines, n, w), np.uint32)
    want = np.asarray(jmt.scatter_burst_network_tiles(
        jnp.asarray(banked), jnp.asarray(idx), jnp.asarray(into), n))
    bb = torch.zeros(1 + banked.size, dtype=torch.int32)
    ib = torch.zeros(2 + into.size, dtype=torch.int32)
    tb, ti = bb[1:].view(banked.shape), ib[2:].view(into.shape)
    tb.copy_(torch.from_numpy(_signed(banked)))
    ti.copy_(torch.from_numpy(_signed(into)))
    assert tb.data_ptr() % 16 == 4 and ti.data_ptr() % 16 == 8
    assert kl.row_word(tb, ti) == 4
    got = tmt.scatter_burst_network_tiles(tb, torch.from_numpy(idx), ti, n)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def _bf16_canon(bits):
    """The reference kernel's interpret-mode image of bfloat16 words: NaNs
    quieted to ``sign | 0x7FC0`` by its exchange stages (ROADMAP §3)."""
    nan = ((bits & 0x7F80) == 0x7F80) & ((bits & 0x007F) != 0)
    return np.where(nan, (bits & 0x8000) | 0x7FC0, bits).astype(bits.dtype)


# (R, C, W, word, batch): rows of 16-byte multiples and not, W = 1, the
# gemma3-4b head row (256 bf16, 512 bytes), one and several batch rows
TRANSPOSE_CASES = [(8, 8, 8, np.uint16, 1), (16, 8, 256, np.uint16, 2),
                   (8, 16, 3, np.uint16, 1), (8, 8, 1, np.uint8, 3),
                   (16, 16, 4, np.uint32, 2), (8, 24, 5, np.uint32, 1)]


@pytest.mark.parametrize("r,c,w,dt,b", TRANSPOSE_CASES)
def test_transpose_plain_matches_pallas_at_row_word_boundaries(r, c, w, dt,
                                                               b):
    """``[B, R, C, W] -> [B, C, R, W]`` in one call against the Pallas
    kernel on every batch row; bf16 payloads carry NaNs with payload bits
    and -0.0, equal to the reference up to its NaN quieting and to numpy's
    ``swapaxes`` exactly."""
    rng = np.random.default_rng(r * 31 + c * 7 + w + b)
    x = _words(rng, (b, r, c, w), dt)
    bf16 = dt == np.uint16
    if bf16:
        x.reshape(-1)[:3] = (0x7FC1, 0xFFA5, 0x8000)
    oracle = np.swapaxes(x, 1, 2)
    jdt = jnp.bfloat16 if bf16 else jnp.dtype(dt)

    def ref(row):
        arr = jnp.asarray(row)
        if bf16:
            arr = arr.view(jnp.bfloat16)
        out = np.asarray(jmt.medusa_transpose_tiles(arr, tile=8))
        return out.view(dt) if bf16 else out

    want = np.stack([ref(x[i]) for i in range(b)])
    assert jnp.dtype(jdt).itemsize == np.dtype(dt).itemsize
    np.testing.assert_array_equal(want, _bf16_canon(oracle) if bf16
                                  else oracle)
    tx = torch.from_numpy(_signed(x))
    if bf16:
        tx = tx.view(BF16)
    for got in (tmt.medusa_transpose_plain(tx),
                tmt.medusa_transpose_tiles(tx)):
        assert got.is_contiguous() and tuple(got.shape) == (b, c, r, w)
        if bf16:
            got = got.view(torch.int16)
        np.testing.assert_array_equal(got.numpy().view(dt), oracle)
