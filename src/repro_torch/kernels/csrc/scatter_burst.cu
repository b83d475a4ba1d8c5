// Fused write network + page-table scatter, in place.
//
// Replaces: src/repro/kernels/medusa_transpose.py, scatter_burst_network_tiles
// (pallas_call body _scatter_burst_kernel).
//
//   into[idx[g*N + r], y, w] = banked[g, y, r, w]   if 0 <= idx < L
//   (sentinel entries drop; rows no index names keep their bytes)
//
// banked [G, N, N, W] and into [L, N, W] are machine words; idx is int32
// [G*N].  Sentinels are every index outside [0, L), negative ones
// included.  The reference takes only idx >= L as a sentinel and wraps a
// negative index as Python indexing does; no caller emits one
// (page_live_plan refuses a table that would, and FRAME_SENTINEL is
// 2**30).  The TPU kernel clamps a sentinel onto row L-1 and rewrites that
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
// Design: a frame copy (medusa::copy_frame).  A frame (one (g, r)) is N
// rows of W words, strided by N*W in banked and one contiguous block at
// idx[g*N + r] in into (4 KB at stablelm-1.6b, 2 KB at gemma3-4b).  The
// wrapper views each row as the widest word (up to 16 bytes) dividing its
// bytes and both buffers' alignment.  A warp reads its frame's index once,
// and a sentinel frame loads and stores nothing.  A frame costs one
// division (its group) and a warp two more (its lanes' places).  A warp
// instruction stores 512 contiguous bytes and reads whole rows (at
// stablelm-1.6b, four 128-byte rows).  The launch gives every frame its
// warp, which measured faster at stablelm-1.6b's shape than a grid of only
// the resident blocks walking the frames, and than the same grid without
// the frame loop.  A TMA route (one tensor-map load of a frame into shared
// memory, one bulk store) was 10-19 % slower at both served shapes and was
// not kept.
#include "burst_common.cuh"

namespace {

using medusa::kWarps;

template <typename T>
__global__ void __launch_bounds__(medusa::kThreads)
scatter_burst_kernel(const T* __restrict__ banked,
                     const int32_t* __restrict__ idx, T* __restrict__ into,
                     long long n_lines, unsigned int n, unsigned int frames,
                     unsigned int rw) {
  const unsigned int lane = threadIdx.x & 31;
  const unsigned int frame_words = n * rw;     // also banked's row stride
  const medusa::LanePlace at(lane, rw);
  for (unsigned int f = blockIdx.x * kWarps + threadIdx.x / 32; f < frames;
       f += gridDim.x * kWarps) {
    const unsigned int g = f / n, r = f - g * n;
    const long long line = idx[f];
    if (line < 0 || line >= n_lines) continue;
    medusa::copy_frame<false>(
        banked + (static_cast<unsigned long long>(g) * n * n + r) * rw,
        into + static_cast<unsigned long long>(line) * frame_words,
        frame_words, rw, at, lane);
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
  if (!medusa::frame_copy_fits(frames, n, w))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MEDUSA_DISPATCH_ROW_WORD(word_bytes,
      scatter_burst_kernel<word_t><<<medusa::frame_blocks(frames),
                                     medusa::kThreads, 0, s>>>(
          static_cast<const word_t*>(banked),
          static_cast<const int32_t*>(idx), static_cast<word_t*>(into),
          n_lines, static_cast<unsigned int>(n),
          static_cast<unsigned int>(frames), static_cast<unsigned int>(w)));
  return static_cast<int>(cudaGetLastError());
}
