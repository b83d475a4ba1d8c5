// KV-cache layout engine: line-major -> port-major, several leaves a launch.
//
// Replaces: src/repro/kernels/medusa_transpose.py, medusa_transpose_tiles
// (pallas_call body _transpose_kernel, the log2(T)-stage exchange network
// _exchange_network over T x T tiles; the reference vmaps it over batch).
//
//   out[b, c, r, :] = in[b, r, c, :]   for each leaf [B, R, C, W]
//
// On the decode path this is [B, T, Hkv, D] -> [B, Hkv, T, D]: a layer's K
// and V leaves in one launch, and whisper's cross K/V of every decoder
// layer in one launch.  The TPU kernel runs log2(T) select stages over VMEM
// tiles; on the card the result is an address permutation, so no exchange
// stage is copied.
//
// Bound: bytes.  Every byte is read once and written once; no arithmetic.
// Design: a row copy.  W is innermost on both sides, so the permutation
// moves whole payload rows of W words (the wrapper views a row as the
// widest word, up to 16 bytes, dividing every leaf's row bytes and every
// pointer).  A group of G lanes moves one row, G the power of two that
// covers a row's words, at most 32: 32 lanes for a 512-byte row, 8 for a
// 128-byte row (a warp then moves four rows).  (b, c, r) is computed once
// per row, in 32 bits when the leaf's rows fit, never per word.
// Consecutive groups take consecutive output rows, so a block's stores are
// one contiguous run and each group's load is one whole input row; a lane
// issues the loads of kUnroll rows before it stores any.  No shared memory
// and no TMA: nothing is reused, and TMA did not pay for 2-4 KB strided
// boxes (PERF.md §6).
//
// Several leaves a launch: the wrapper passes up to kMaxLeaves leaves
// (pointers, shape, row words) and the C entry point lays them out as a
// table passed by value, a __grid_constant__ parameter read in place.  Each
// leaf owns a run of whole blocks starting at its first block (the prefix
// of the leaves' rows, in blocks); a block finds its leaf by a binary
// search of those prefixes.
#include <climits>

#include "burst_common.cuh"

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kUnroll = 4;            // rows a group moves, loads in flight
constexpr int kDescLongs = 6;         // in, out, B, R, C, row words

struct Leaf {
  const void* in;
  void* out;
  unsigned long long rows;            // B * C * R output rows
  unsigned int first_block;           // the leaf's first block of the grid
  unsigned int r, c, rw;              // the swapped axes; words a row
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int n;
  unsigned int log2_group;            // lanes a row: 1 << log2_group
};

template <typename T, typename I>
__global__ void __launch_bounds__(medusa::kThreads)
    transpose_rows_kernel(const __grid_constant__ Table tab) {
  int lo = 0, hi = tab.n - 1;         // the last leaf starting at or before
  while (lo < hi) {                   // this block
    const int mid = (lo + hi + 1) >> 1;
    if (tab.leaf[mid].first_block <= blockIdx.x) lo = mid;
    else hi = mid - 1;
  }
  const Leaf& leaf = tab.leaf[lo];
  const unsigned int lg = tab.log2_group;
  const unsigned int lane = threadIdx.x & ((1u << lg) - 1);
  const unsigned int groups = medusa::kThreads >> lg;
  const I rows = static_cast<I>(leaf.rows);
  const I r = leaf.r, c = leaf.c;
  const unsigned int rw = leaf.rw;
  const T* __restrict__ in = static_cast<const T*>(leaf.in);
  T* __restrict__ out = static_cast<T*>(leaf.out);

  // output row o = (b * C + ci) * R + ri reads input row (b * R + ri) * C + ci
  I o = static_cast<I>(blockIdx.x - leaf.first_block) * (groups * kUnroll) +
        (threadIdx.x >> lg);
  size_t src[kUnroll], dst[kUnroll];
  bool live[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u, o += groups) {
    live[u] = o < rows;
    const I t = o / r;
    const I ri = o - t * r;
    const I b = t / c;
    const I ci = t - b * c;
    src[u] = static_cast<size_t>((b * r + ri) * c + ci) * rw;
    dst[u] = static_cast<size_t>(o) * rw;
  }
  for (unsigned int w = lane; w < rw; w += 1u << lg) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (live[u]) v[u] = in[src[u] + w];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (live[u]) out[dst[u] + w] = v[u];
  }
}

template <typename T>
void launch(const Table& tab, unsigned int grid, bool narrow,
            cudaStream_t s) {
  if (narrow)
    transpose_rows_kernel<T, uint32_t><<<grid, medusa::kThreads, 0, s>>>(tab);
  else
    transpose_rows_kernel<T, unsigned long long>
        <<<grid, medusa::kThreads, 0, s>>>(tab);
}

}  // namespace

// desc: n_leaves x (in pointer, out pointer, B, R, C, row words), each leaf
// contiguous [B, R, C, W] -> [B, C, R, W] with W = row words of word_bytes.
// Leaves with no rows or empty rows are skipped.
extern "C" int medusa_transpose_many(const long long* desc, int n_leaves,
                                     int word_bytes, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  long long max_rw = 1;
  for (int i = 0; i < n_leaves; ++i)
    if (desc[i * kDescLongs + 5] > max_rw) max_rw = desc[i * kDescLongs + 5];
  Table tab{};
  while ((1LL << tab.log2_group) < max_rw && tab.log2_group < 5)
    ++tab.log2_group;
  const long long per_block =
      static_cast<long long>(medusa::kThreads >> tab.log2_group) * kUnroll;
  long long blocks = 0;
  bool narrow = true;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* d = desc + i * kDescLongs;
    const long long rows = d[2] * d[3] * d[4];
    if (rows <= 0 || d[5] <= 0) continue;
    if (d[3] > UINT_MAX || d[4] > UINT_MAX || d[5] > UINT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long nb = (rows + per_block - 1) / per_block;
    if (nb * per_block >= (1LL << 32)) narrow = false;
    Leaf& leaf = tab.leaf[tab.n++];
    leaf.in = reinterpret_cast<const void*>(d[0]);
    leaf.out = reinterpret_cast<void*>(d[1]);
    leaf.rows = static_cast<unsigned long long>(rows);
    leaf.first_block = static_cast<unsigned int>(blocks);
    leaf.r = static_cast<unsigned int>(d[3]);
    leaf.c = static_cast<unsigned int>(d[4]);
    leaf.rw = static_cast<unsigned int>(d[5]);
    blocks += nb;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tab.n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned int grid = static_cast<unsigned int>(blocks);
    MEDUSA_DISPATCH_ROW_WORD(word_bytes, launch<word_t>(tab, grid, narrow, s));
  }
  return static_cast<int>(cudaGetLastError());
}
