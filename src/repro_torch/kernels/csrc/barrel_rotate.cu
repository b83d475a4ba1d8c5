// Barrel rotation unit on groups (the paper's rotation unit, §III-B).
//
// Replaces: src/repro/kernels/rotator.py, barrel_rotate_groups (pallas_call
// with the inner `kernel`: log2(N) stages, stage l a static roll by 2^l
// selected by bit l of the group's scalar-prefetched amount).
//
//   out[g, i, w] = x[g, (i + amounts[g]) mod N, w]    for x [G, N, W]
//
// A left rotation of each group's N port-words.  On the card the log2(N)
// select stages compose to one address permutation, so each thread reads
// its source word directly; the group's amount is one int32 on the device,
// read by every thread of the group (it stays in L1).  The reference takes
// the amount with JAX's floor modulo (-1 mod 8 == 7); C++'s % truncates
// toward zero, so the kernel masks with N - 1 instead, which is the floor
// modulo for a power-of-two N in two's complement.
//
// Bound: bytes.  Every word is read once and written once, plus G amounts;
// no arithmetic.  Design: a grid-stride loop with one thread per output
// word in output order, each W-row moved as the widest word (up to 16
// bytes) dividing its bytes, so a warp stores a contiguous run and loads
// whole rows; the N axis is a shift and a mask.  32-bit indices whenever
// the word count fits.
#include "burst_common.cuh"

namespace {

template <typename T, typename I>
__global__ void barrel_rotate_kernel(const T* __restrict__ x,
                                     const int32_t* __restrict__ amounts,
                                     T* __restrict__ out, int log_n, I w,
                                     I total) {
  const I mask = (static_cast<I>(1) << log_n) - 1;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I o = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
       o < total; o += stride) {
    const I wi = o % w;
    const I t = o / w;           // g * N + i
    const I i = t & mask;
    const I g = t >> log_n;
    const I a = static_cast<I>(static_cast<uint32_t>(amounts[g])) & mask;
    out[o] = x[((g << log_n) + ((i + a) & mask)) * w + wi];
  }
}

template <typename T>
void launch(const void* x, const void* amounts, void* out, long long groups,
            int log_n, long long w, cudaStream_t s) {
  const long long total = (groups << log_n) * w;
  const unsigned int grid = medusa::grid_for(total);
  if (medusa::fits_u32(total, grid)) {
    barrel_rotate_kernel<T, uint32_t><<<grid, medusa::kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const int32_t*>(amounts),
        static_cast<T*>(out), log_n, static_cast<uint32_t>(w),
        static_cast<uint32_t>(total));
  } else {
    barrel_rotate_kernel<T, unsigned long long>
        <<<grid, medusa::kThreads, 0, s>>>(
            static_cast<const T*>(x), static_cast<const int32_t*>(amounts),
            static_cast<T*>(out), log_n, static_cast<unsigned long long>(w),
            static_cast<unsigned long long>(total));
  }
}

}  // namespace

extern "C" int medusa_barrel_rotate(const void* x, const void* amounts,
                                    void* out, long long groups, int log_n,
                                    long long w, int word_bytes,
                                    void* stream) {
  if (groups * w > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    MEDUSA_DISPATCH_ROW_WORD(
        word_bytes, launch<word_t>(x, amounts, out, groups, log_n, w, s));
  }
  return static_cast<int>(cudaGetLastError());
}
