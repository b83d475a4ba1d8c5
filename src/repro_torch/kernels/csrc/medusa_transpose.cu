// KV-cache layout engine: line-major -> port-major.
//
// Replaces: src/repro/kernels/medusa_transpose.py, medusa_transpose_tiles
// (pallas_call body _transpose_kernel, the log2(T)-stage exchange network
// _exchange_network over T x T tiles; the reference vmaps it over batch).
//
//   out[b, c, r, w] = in[b, r, c, w]   for [B, R, C, W] machine words
//
// On the per-layer decode path this is [B, T, Hkv, D] -> [B, Hkv, T, D]
// for every K/V leaf of every layer, batch axis inside one launch.  The TPU
// kernel runs log2(T) select stages over VMEM tiles; on the card the result
// is an address permutation, so each thread moves one word straight to its
// place and no exchange stage is copied.
//
// Bound: bytes.  Every word is read once and written once; no arithmetic.
// Design: a grid-stride loop with one thread per output word in output
// order, so a warp's stores are one contiguous run and its loads are runs
// of W words from one (b, r, c) row.  The wrapper views each row as the
// widest word (up to 16 bytes) that divides the row's bytes and both
// pointers' alignment, so a 256-element bf16 row moves as 32 16-byte words.
// Index arithmetic is 32-bit whenever the word count fits (64-bit div/mod
// per word is the suspect in the dense burst kernel's slowness).
#include "burst_common.cuh"

namespace {

template <typename T, typename I>
__global__ void transpose_kernel(const T* __restrict__ in,
                                 T* __restrict__ out, I r, I c, I w,
                                 I total) {
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I o = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
       o < total; o += stride) {
    const I wi = o % w;
    I t = o / w;                 // (b * C + ci) * R + ri
    const I ri = t % r;
    t /= r;                      // b * C + ci
    const I ci = t % c;
    const I b = t / c;
    out[o] = in[((b * r + ri) * c + ci) * w + wi];
  }
}

template <typename T>
void launch(const void* in, void* out, long long b, long long r, long long c,
            long long w, cudaStream_t s) {
  const long long total = b * r * c * w;
  const unsigned int grid = medusa::grid_for(total);
  // 32-bit indices when every intermediate index fits below 2^32
  if (medusa::fits_u32(total, grid)) {
    transpose_kernel<T, uint32_t><<<grid, medusa::kThreads, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out),
        static_cast<uint32_t>(r), static_cast<uint32_t>(c),
        static_cast<uint32_t>(w), static_cast<uint32_t>(total));
  } else {
    transpose_kernel<T, unsigned long long><<<grid, medusa::kThreads, 0, s>>>(
        static_cast<const T*>(in), static_cast<T*>(out),
        static_cast<unsigned long long>(r),
        static_cast<unsigned long long>(c),
        static_cast<unsigned long long>(w),
        static_cast<unsigned long long>(total));
  }
}

}  // namespace

extern "C" int medusa_transpose(const void* in, void* out, long long b,
                                long long r, long long c, long long w,
                                int word_bytes, void* stream) {
  if (b * r * c * w > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    MEDUSA_DISPATCH_ROW_WORD(word_bytes,
                             launch<word_t>(in, out, b, r, c, w, s));
  }
  return static_cast<int>(cudaGetLastError());
}
