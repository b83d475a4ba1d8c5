"""The port's burst kernels (their plain PyTorch versions on the CPU)
against the reference's Pallas kernels run in interpret mode.

The kernels are pure word movement, so everything is bit-equal.  Inputs
are machine words drawn with numpy from a fixed seed; the port takes them
as the signed same-width views it moves, and both sides compare through
numpy's unsigned views.  On a CUDA tensor the same wrappers launch the
CUDA kernels; ``chip_smoke.py`` holds those against these plain versions
on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import medusa_transpose as jmt  # noqa: E402
from repro_torch.fabric import FRAME_SENTINEL  # noqa: E402
from repro_torch.kernels import medusa_transpose as tmt  # noqa: E402

_SIGNED = {np.uint8: np.uint8, np.uint16: np.int16, np.uint32: np.int32}

# (N, word dtype): every N of the sweep, every word width, each N
# at least once with the 32-bit word the serving path moves
CASES = [(2, np.uint8), (4, np.uint16), (4, np.uint32), (8, np.uint8),
         (32, np.uint32), (32, np.uint16)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _words(rng, shape, dt):
    return rng.integers(0, np.iinfo(dt).max, size=shape, dtype=np.uint64,
                        endpoint=True).astype(dt)


def _to_torch(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(_SIGNED[a.dtype.type]))


def _from_torch(t, dt):
    return t.numpy().view(dt)


def _index_list(rng, n_lines, k, n_sentinel):
    """``k`` indices: unique live rows of ``[0, n_lines)`` (as many as the
    pool has, when ``k`` exceeds it) and sentinels — both ``n_lines``
    itself and the shared FRAME_SENTINEL."""
    live = min(k - n_sentinel, n_lines)
    idx = np.concatenate([
        rng.permutation(n_lines)[:live],
        np.where(np.arange(k - live) % 2 == 0, n_lines, FRAME_SENTINEL)])
    return rng.permutation(idx).astype(np.int32)


@pytest.mark.parametrize("n,dt", CASES)
@pytest.mark.parametrize("k_vs_l", ["k<l", "k>l"])
def test_gather_burst_matches_pallas(n, dt, k_vs_l):
    rng = np.random.default_rng(n * 7 + np.dtype(dt).itemsize)
    w = 3
    n_lines = 5 * n if k_vs_l == "k<l" else 2 * n
    k = 3 * n
    lines = _words(rng, (n_lines, n, w), dt)
    idx = _index_list(rng, n_lines, k, n_sentinel=max(1, n // 2))
    want = np.asarray(jmt.gather_burst_network_tiles(
        jnp.asarray(lines), jnp.asarray(idx), n))
    got = tmt.gather_burst_network_tiles(_to_torch(lines),
                                         torch.from_numpy(idx), n)
    assert got.shape == (k // n, n, n, w)
    np.testing.assert_array_equal(_from_torch(got, dt), want)


@pytest.mark.parametrize("n,dt", CASES)
@pytest.mark.parametrize("k_vs_l", ["k<l", "k>l"])
def test_scatter_burst_matches_pallas(n, dt, k_vs_l):
    rng = np.random.default_rng(n * 11 + np.dtype(dt).itemsize)
    w = 3
    n_lines = 5 * n if k_vs_l == "k<l" else 2 * n
    g = 3
    banked = _words(rng, (g, n, n, w), dt)
    into = _words(rng, (n_lines, n, w), dt)
    idx = _index_list(rng, n_lines, g * n, n_sentinel=max(1, n // 2))
    live = idx[idx < n_lines]
    assert len(np.unique(live)) == len(live)       # the kernel's contract
    want = np.asarray(jmt.scatter_burst_network_tiles(
        jnp.asarray(banked), jnp.asarray(idx), jnp.asarray(into), n))
    into_t = _to_torch(into.copy())
    got = tmt.scatter_burst_network_tiles(_to_torch(banked),
                                          torch.from_numpy(idx), into_t, n)
    assert got is into_t                           # landed in place
    np.testing.assert_array_equal(_from_torch(got, dt), want)
    # rows no index names keep their bytes (with K < L some always exist)
    untouched = np.setdiff1d(np.arange(n_lines), live)
    assert len(untouched) > 0 or k_vs_l == "k>l"
    np.testing.assert_array_equal(_from_torch(got, dt)[untouched],
                                  into[untouched])


@pytest.mark.parametrize("n,dt", CASES)
def test_burst_network_matches_pallas(n, dt):
    rng = np.random.default_rng(n * 13 + np.dtype(dt).itemsize)
    tile = _words(rng, (n, n, 5), dt)
    want = np.asarray(jmt.burst_network_tiles(jnp.asarray(tile), n))
    got = tmt.burst_network_tiles(_to_torch(tile), n)
    np.testing.assert_array_equal(_from_torch(got, dt), want)
    # an involution: the same kernel is the read and the write network
    back = tmt.burst_network_tiles(got, n)
    np.testing.assert_array_equal(_from_torch(back, dt), tile)


def test_wrappers_reject_what_the_kernels_cannot_take():
    lines = torch.zeros((8, 4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):                 # indices must be int32
        tmt.gather_burst_network_tiles(lines, torch.zeros(4,
                                                          dtype=torch.int64),
                                       4)
    with pytest.raises(ValueError):                # K not a multiple of N
        tmt.gather_burst_network_tiles(lines, torch.zeros(3,
                                                          dtype=torch.int32),
                                       4)
    with pytest.raises(ValueError):                # not an [N, N, W] tile
        tmt.burst_network_tiles(torch.zeros((4, 2, 3)), 4)
    with pytest.raises(ValueError):                # target width mismatch
        tmt.scatter_burst_network_tiles(
            torch.zeros((1, 4, 4, 2), dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32),
            torch.zeros((8, 4, 3), dtype=torch.int32), 4)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    tmt.reset_launch_counts()
    tile = torch.arange(4 * 4 * 3, dtype=torch.int32).reshape(4, 4, 3)
    tmt.burst_network_tiles(tile, 4)
    tmt.gather_burst_network_tiles(tile.reshape(4, 4, 3),
                                   torch.arange(4, dtype=torch.int32), 4)
    assert tmt.launch_counts() == {"gather_burst_network_tiles": 0,
                                   "scatter_burst_network_tiles": 0,
                                   "burst_network_tiles": 0,
                                   "medusa_transpose_tiles": 0,
                                   "read_network_tiles": 0,
                                   "barrel_rotate_groups": 0,
                                   "stream_matmul": 0}
