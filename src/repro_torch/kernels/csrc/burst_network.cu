// Dense packed burst through the transposition unit.
//
// Replaces: src/repro/kernels/medusa_transpose.py, burst_network_tiles
// (pallas_call body _burst_kernel, stage masks _stage_masks).
//
//   out[y, p, w] = in[p, y, w]      for a [N, N, W] tile of machine words
//
// The square exchange is an involution, so one kernel is both the read
// network (lines -> banked) and the write network (banked -> lines).  The
// TPU kernel runs log2(N) select stages over word-tiled VMEM blocks; on the
// card the result is an address permutation, so each thread moves one word
// straight to its place.
//
// Bound: bytes.  N*N*W words are read once and written once; no
// arithmetic.  Design: a grid-stride loop with one thread per output word
// in output order; a warp writes 32 consecutive words and reads a run of the
// same length from one (p, y) lane, so both sides are coalesced whenever W
// (the packed burst's word count, large on every caller) is >= 32.
#include "burst_common.cuh"

namespace {

template <typename T>
__global__ void burst_network_kernel(const T* __restrict__ in,
                                     T* __restrict__ out, int n,
                                     long long w) {
  const long long total = static_cast<long long>(n) * n * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long o = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       o < total; o += stride) {
    const long long wi = o % w;
    const long long t = o / w;
    const long long p = t % n;
    const long long y = t / n;
    out[o] = in[(p * n + y) * w + wi];
  }
}

}  // namespace

extern "C" int medusa_burst_network(const void* in, void* out, int n,
                                    long long w, int word_bytes,
                                    void* stream) {
  const long long total = static_cast<long long>(n) * n * w;
  if (total > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    MEDUSA_DISPATCH_WORD(word_bytes,
        burst_network_kernel<word_t><<<medusa::grid_for(total),
                                       medusa::kThreads, 0, s>>>(
            static_cast<const word_t*>(in), static_cast<word_t*>(out), n, w));
  }
  return static_cast<int>(cudaGetLastError());
}
