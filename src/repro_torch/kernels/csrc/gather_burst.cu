// Fused page-table gather + read network.
//
// Replaces: src/repro/kernels/medusa_transpose.py, gather_burst_network_tiles
// (pallas_call body _gather_burst_kernel).
//
//   out[g, y, p, w] = lines[idx[g*N + p], y, w]   if 0 <= idx < L
//                   = 0                            otherwise (sentinel)
//
// lines [L, N, W] and out [K/N, N, N, W] are machine words; idx is int32
// [K].  Sentinels are every index outside [0, L), negative ones included.
// The reference takes only idx >= L as a sentinel and wraps a negative
// index as Python indexing does; no caller emits one (page_live_plan
// refuses a table that would, and FRAME_SENTINEL is 2**30).  The TPU
// kernel scalar-prefetches idx and walks a sequential (group, word-tile,
// line) grid, assembling one [N, N, tw] tile in VMEM and running the
// log2(N)-stage exchange network on it.  On the card the network is only
// an address permutation, so none is run.
//
// Bound: bytes.  The gather reads the live frames (N*W words each) and the
// K indices once and writes K frames; a sentinel frame costs only its
// zeros.
//
// Design: a frame copy (medusa::copy_frame), the mirror of the scatter's.
// A frame (one (g, p)) is one contiguous block at idx[g*N + p] in lines
// (4 KB at stablelm-1.6b, 2 KB at gemma3-4b) and N rows strided by N*W in
// out.  The wrapper views each row as the widest word (up to 16 bytes)
// dividing its bytes and both buffers' alignment.  A warp reads its
// frame's index once; a sentinel frame loads nothing and stores zeros.  A
// frame costs one division (its group) and a warp two more (its lanes'
// places).  A warp instruction reads 512 contiguous bytes and writes whole
// rows (at stablelm-1.6b, four 128-byte rows).  The launch gives every
// frame its warp, as the scatter's does.
#include "burst_common.cuh"

namespace {

using medusa::kWarps;

template <typename T>
__global__ void __launch_bounds__(medusa::kThreads)
gather_burst_kernel(const T* __restrict__ lines,
                    const int32_t* __restrict__ idx, T* __restrict__ out,
                    long long n_lines, unsigned int n, unsigned int frames,
                    unsigned int rw) {
  const unsigned int lane = threadIdx.x & 31;
  const unsigned int frame_words = n * rw;     // also out's row stride
  const medusa::LanePlace at(lane, rw);
  for (unsigned int f = blockIdx.x * kWarps + threadIdx.x / 32; f < frames;
       f += gridDim.x * kWarps) {
    const unsigned int g = f / n, p = f - g * n;
    const long long line = idx[f];
    medusa::copy_frame<true>(
        line >= 0 && line < n_lines
            ? lines + static_cast<unsigned long long>(line) * frame_words
            : nullptr,
        out + (static_cast<unsigned long long>(g) * n * n + p) * rw,
        frame_words, rw, at, lane);
  }
}

}  // namespace

// k: the frame count; w: the row's length in words of word_bytes (1, 2, 4,
// 8 or 16)
extern "C" int medusa_gather_burst(const void* lines, const void* idx,
                                   void* out, long long n_lines, int n,
                                   long long k, long long w, int word_bytes,
                                   void* stream) {
  if (k <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  if (!medusa::frame_copy_fits(k, n, w))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MEDUSA_DISPATCH_ROW_WORD(word_bytes,
      gather_burst_kernel<word_t><<<medusa::frame_blocks(k),
                                    medusa::kThreads, 0, s>>>(
          static_cast<const word_t*>(lines),
          static_cast<const int32_t*>(idx), static_cast<word_t*>(out),
          n_lines, static_cast<unsigned int>(n),
          static_cast<unsigned int>(k), static_cast<unsigned int>(w)));
  return static_cast<int>(cudaGetLastError());
}
