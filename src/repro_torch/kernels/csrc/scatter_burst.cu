// Fused write network + page-table scatter, in place.
//
// Replaces: src/repro/kernels/medusa_transpose.py, scatter_burst_network_tiles
// (pallas_call body _scatter_burst_kernel).
//
//   into[idx[g*N + r], y, w] = banked[g, y, r, w]   if 0 <= idx < L
//   (sentinel entries drop; rows no index names keep their bytes)
//
// banked [G, N, N, W] and into [L, N, W] are machine words; idx is int32
// [G*N].  The TPU kernel clamps a sentinel onto row L-1 and rewrites that
// row with its own contents, which is safe only because its grid runs in
// order.  Blocks here run concurrently, so the store is masked instead: a
// sentinel entry issues no store at all.  Live indices must be unique (the
// page pool never maps one physical frame twice); with duplicates the
// winning frame would be unspecified.
//
// Bound: bytes.  The scatter reads G*N*N*W banked words and the indices
// once and writes only the live frames; rows the indices never name are not
// touched, so the pool-sized `into` costs nothing beyond the live frames.
//
// Design: a frame copy.  A frame (one (g, r)) is N rows of W words, strided
// by N*W in banked and one contiguous block at idx[g*N + r] in into (4 KB
// at stablelm-1.6b, 2 KB at gemma3-4b).  The wrapper views each row as the
// widest word (up to 16 bytes) dividing its bytes and both buffers'
// alignment.  Warps walk the frames, one at a time: a warp reads its
// frame's index once, and a sentinel frame loads and stores nothing.  Lane
// l moves words l, l + 32, ... of the frame, kBatch loads before their
// stores; its place (row, word) steps by 32 words without a division, so a
// frame costs one division and a warp two more.  Offsets inside a frame
// are 32-bit, only the frame bases 64-bit.  A warp instruction stores 512
// contiguous bytes and reads whole rows (at stablelm-1.6b, four 128-byte
// rows).  The launch gives every frame its warp, which measured faster at
// stablelm-1.6b's shape than a grid of only the resident blocks walking
// the frames, and than the same grid without the frame loop.  A TMA route
// (one tensor-map load of a frame into shared memory, one bulk store) was
// 10-19 % slower at both served shapes and was not kept.
#include "burst_common.cuh"

namespace {

constexpr int kBatch = 8;                      // loads in flight a lane
constexpr int kWarps = medusa::kThreads / 32;

// a frame's N rows of rw words, row y at src + y * frame_words, to dst;
// (row, wi) is the lane's first word, (drow, dwi) the step of 32 words
template <typename T>
__device__ __forceinline__ void copy_frame(const T* __restrict__ src,
                                           T* __restrict__ dst,
                                           unsigned int frame_words,
                                           unsigned int rw, unsigned int row,
                                           unsigned int wi, unsigned int drow,
                                           unsigned int dwi,
                                           unsigned int lane) {
  for (unsigned int o = lane; o < frame_words; o += 32 * kBatch) {
    T v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (o + 32 * i < frame_words) v[i] = src[row * frame_words + wi];
      wi += dwi;
      row += drow;
      if (wi >= rw) {
        wi -= rw;
        ++row;
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (o + 32 * i < frame_words) dst[o + 32 * i] = v[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(medusa::kThreads)
scatter_burst_kernel(const T* __restrict__ banked,
                     const int32_t* __restrict__ idx, T* __restrict__ into,
                     long long n_lines, unsigned int n, unsigned int frames,
                     unsigned int rw) {
  const unsigned int lane = threadIdx.x & 31;
  const unsigned int frame_words = n * rw;     // also banked's row stride
  const unsigned int drow = 32u / rw, dwi = 32u - drow * rw;
  const unsigned int row0 = lane / rw, wi0 = lane - row0 * rw;
  for (unsigned int f = blockIdx.x * kWarps + threadIdx.x / 32; f < frames;
       f += gridDim.x * kWarps) {
    const unsigned int g = f / n, r = f - g * n;
    const T* src =
        banked + (static_cast<unsigned long long>(g) * n * n + r) * rw;
    const long long line = idx[f];
    if (line < 0 || line >= n_lines) continue;
    copy_frame(src, into + static_cast<unsigned long long>(line) * frame_words,
               frame_words, rw, row0, wi0, drow, dwi, lane);
  }
}

}  // namespace

// w: the row's length in words of word_bytes (1, 2, 4, 8 or 16)
extern "C" int medusa_scatter_burst(const void* banked, const void* idx,
                                    void* into, long long n_lines, int n,
                                    long long groups, long long w,
                                    int word_bytes, void* stream) {
  const long long frames = groups * n;
  if (frames <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  // 32-bit frame numbers (up to one grid past the last) and offsets inside
  // a frame's N x N rows
  if (2 * frames + kWarps >= (1LL << 32) ||
      static_cast<long long>(n) * n * w + 32 * kBatch >= (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks =
      static_cast<unsigned int>((frames + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MEDUSA_DISPATCH_ROW_WORD(word_bytes,
      scatter_burst_kernel<word_t><<<blocks, medusa::kThreads, 0, s>>>(
          static_cast<const word_t*>(banked),
          static_cast<const int32_t*>(idx), static_cast<word_t*>(into),
          n_lines, static_cast<unsigned int>(n),
          static_cast<unsigned int>(frames), static_cast<unsigned int>(w)));
  return static_cast<int>(cudaGetLastError());
}
