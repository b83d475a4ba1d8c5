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
// Design: a grid-stride loop with one thread per moved word in destination
// order (frame, y, w), so a warp stores a run of consecutive words of one
// pool row and reads the matching run of one banked lane (W words
// contiguous per (g, y, r)).
#include "burst_common.cuh"

namespace {

template <typename T>
__global__ void scatter_burst_kernel(const T* __restrict__ banked,
                                     const int32_t* __restrict__ idx,
                                     T* __restrict__ into, long long n_lines,
                                     int n, long long groups, long long w) {
  const long long total = groups * n * n * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < total; j += stride) {
    const long long wi = j % w;
    long long t = j / w;
    const long long y = t % n;
    t /= n;
    const long long r = t % n;
    const long long g = t / n;
    const long long frame = idx[g * n + r];
    if (frame >= 0 && frame < n_lines) {
      into[(frame * n + y) * w + wi] = banked[((g * n + y) * n + r) * w + wi];
    }
  }
}

}  // namespace

extern "C" int medusa_scatter_burst(const void* banked, const void* idx,
                                    void* into, long long n_lines, int n,
                                    long long groups, long long w,
                                    int word_bytes, void* stream) {
  const long long total = groups * n * n * w;
  if (total > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    MEDUSA_DISPATCH_WORD(word_bytes,
        scatter_burst_kernel<word_t><<<medusa::grid_for(total),
                                       medusa::kThreads, 0, s>>>(
            static_cast<const word_t*>(banked),
            static_cast<const int32_t*>(idx), static_cast<word_t*>(into),
            n_lines, n, groups, w));
  }
  return static_cast<int>(cudaGetLastError());
}
