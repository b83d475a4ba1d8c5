// Fused page-table gather + read network.
//
// Replaces: src/repro/kernels/medusa_transpose.py, gather_burst_network_tiles
// (pallas_call body _gather_burst_kernel).
//
//   out[g, y, p, w] = lines[idx[g*N + p], y, w]   if 0 <= idx < L
//                   = 0                            otherwise (sentinel)
//
// lines [L, N, W] and out [K/N, N, N, W] are machine words; idx is int32
// [K].  The TPU kernel scalar-prefetches idx and walks a sequential
// (group, word-tile, line) grid, assembling one [N, N, tw] tile in VMEM and
// running the log2(N)-stage exchange network on it.  On the card the
// transpose is only an address permutation, so no network is run: each
// thread owns one output word and reads its source word directly.
//
// Bound: bytes.  The gather moves K frames of N*W words (read once from the
// live pool rows, written once banked) plus K indices; there is no
// arithmetic.  Design: a grid-stride loop with one thread per output word in
// output order, so a warp writes 32 consecutive words and reads a run of
// consecutive words of one frame row (W words contiguous per (frame, y)).
// Sentinel frames read nothing and write zeros.  Both sides stay coalesced
// for W >= 32 words; staging N frames through shared memory to widen the
// read runs is later work.
#include "burst_common.cuh"

namespace {

template <typename T>
__global__ void gather_burst_kernel(const T* __restrict__ lines,
                                    const int32_t* __restrict__ idx,
                                    T* __restrict__ out, long long n_lines,
                                    int n, long long k, long long w) {
  const long long total = k * n * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long o = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       o < total; o += stride) {
    const long long wi = o % w;
    long long t = o / w;
    const long long p = t % n;
    t /= n;
    const long long y = t % n;
    const long long g = t / n;
    const long long frame = idx[g * n + p];
    T v = T(0);
    if (frame >= 0 && frame < n_lines) {
      v = lines[(frame * n + y) * w + wi];
    }
    out[o] = v;
  }
}

}  // namespace

extern "C" int medusa_gather_burst(const void* lines, const void* idx,
                                   void* out, long long n_lines, int n,
                                   long long k, long long w, int word_bytes,
                                   void* stream) {
  const long long total = k * n * w;
  if (total > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    MEDUSA_DISPATCH_WORD(word_bytes,
        gather_burst_kernel<word_t><<<medusa::grid_for(total),
                                      medusa::kThreads, 0, s>>>(
            static_cast<const word_t*>(lines),
            static_cast<const int32_t*>(idx), static_cast<word_t*>(out),
            n_lines, n, k, w));
  }
  return static_cast<int>(cudaGetLastError());
}
