// Read network on group tiles (the interconnect's re-banking).
//
// Replaces: src/repro/kernels/medusa_transpose.py, read_network_tiles
// (pallas_call body _rebank_kernel, the log2(N)-stage exchange network
// _exchange_network_nd over one [N, N, W] group tile per grid step).
//
//   banked[g, y, p, w] = lines[g*N + p, y, w]    for lines [L, N, W]
//
// This is the gather burst (gather_burst.cu) with the identity index: a
// single launch has no page table to read, so no index operand and no
// sentinel test.  On the card the exchange network is only an address
// permutation, so each thread moves one word straight to its place.
//
// Bound: bytes.  Every word is read once and written once; no arithmetic.
// Design: a grid-stride loop with one thread per output word in output
// order.  The wrapper views each W-row as the widest word (up to 16 bytes)
// dividing its bytes and both pointers' alignment, as the layout engine
// does, so a warp stores 512 contiguous bytes and loads whole rows of one
// line.  N is a power of two, so the two N axes of the index are a shift
// and a mask; only the row word count W needs a division.  Index
// arithmetic is 32-bit whenever the word count fits.
#include "burst_common.cuh"

namespace {

template <typename T, typename I>
__global__ void read_network_kernel(const T* __restrict__ lines,
                                    T* __restrict__ out, int log_n, I w,
                                    I total) {
  const I mask = (static_cast<I>(1) << log_n) - 1;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I o = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
       o < total; o += stride) {
    const I wi = o % w;
    const I t = o / w;           // (g * N + y) * N + p
    const I p = t & mask;
    const I gy = t >> log_n;     // g * N + y
    const I y = gy & mask;
    const I g = gy >> log_n;
    out[o] = lines[((((g << log_n) + p) << log_n) + y) * w + wi];
  }
}

template <typename T>
void launch(const void* lines, void* out, long long groups, int log_n,
            long long w, cudaStream_t s) {
  const long long total = (groups << (2 * log_n)) * w;
  const unsigned int grid = medusa::grid_for(total);
  if (medusa::fits_u32(total, grid)) {
    read_network_kernel<T, uint32_t><<<grid, medusa::kThreads, 0, s>>>(
        static_cast<const T*>(lines), static_cast<T*>(out), log_n,
        static_cast<uint32_t>(w), static_cast<uint32_t>(total));
  } else {
    read_network_kernel<T, unsigned long long>
        <<<grid, medusa::kThreads, 0, s>>>(
            static_cast<const T*>(lines), static_cast<T*>(out), log_n,
            static_cast<unsigned long long>(w),
            static_cast<unsigned long long>(total));
  }
}

}  // namespace

extern "C" int medusa_read_network(const void* lines, void* out,
                                   long long groups, int log_n, long long w,
                                   int word_bytes, void* stream) {
  if (groups * w > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    MEDUSA_DISPATCH_ROW_WORD(word_bytes,
                             launch<word_t>(lines, out, groups, log_n, w, s));
  }
  return static_cast<int>(cudaGetLastError());
}
