// Dense packed burst through the transposition unit.
//
// Replaces: src/repro/kernels/medusa_transpose.py, burst_network_tiles
// (pallas_call body _burst_kernel, stage masks _stage_masks).
//
//   out[y, p, :] = in[p, y, :]      for a [N, N, W] tile of machine words
//
// The square exchange is an involution, so one kernel is both the read
// network (lines -> banked) and the write network (banked -> lines).  The
// TPU kernel runs log2(N) select stages over word-tiled VMEM blocks; on the
// card the result is an address permutation: N^2 copies of a contiguous row
// of W words (393 KB at stablelm-1.6b's packed burst).
//
// Bound: bytes.  N*N*W words are read once and written once; no
// arithmetic.  Design: a row copy.  The wrapper views each row as the widest
// word (up to 16 bytes) dividing its bytes and both buffers' alignment.
// blockIdx.y walks output rows (one division per row, not per word: out row
// y * N + p reads in row p * N + y) and blockIdx.x chunks of the row; each
// thread issues its four loads before its four stores, and the offsets
// inside a row are 32-bit.
#include "burst_common.cuh"

namespace {

constexpr int kWordsPerThread = 4;
constexpr unsigned int kChunk = medusa::kThreads * kWordsPerThread;
constexpr unsigned int kMaxRowBlocks = 65535;     // gridDim.y's limit

template <typename T>
__global__ void __launch_bounds__(medusa::kThreads)
burst_network_kernel(const T* __restrict__ in, T* __restrict__ out,
                     unsigned int n, unsigned int rw) {
  const unsigned int first = blockIdx.x * kChunk + threadIdx.x;
  for (unsigned int row = blockIdx.y; row < n * n; row += gridDim.y) {
    const unsigned int y = row / n, p = row - y * n;
    const T* src = in + static_cast<unsigned long long>(p * n + y) * rw;
    T* dst = out + static_cast<unsigned long long>(row) * rw;
    T v[kWordsPerThread];
#pragma unroll
    for (int i = 0; i < kWordsPerThread; ++i) {
      const unsigned int o = first + i * medusa::kThreads;
      if (o < rw) v[i] = src[o];
    }
#pragma unroll
    for (int i = 0; i < kWordsPerThread; ++i) {
      const unsigned int o = first + i * medusa::kThreads;
      if (o < rw) dst[o] = v[i];
    }
  }
}

}  // namespace

// w: the row's length in words of word_bytes (1, 2, 4, 8 or 16)
extern "C" int medusa_burst_network(const void* in, void* out, int n,
                                    long long w, int word_bytes,
                                    void* stream) {
  if (n > 0 && w > 0) {
    const long long rows = static_cast<long long>(n) * n;
    // 32-bit row indices and in-row offsets (past one chunk)
    if (rows >= (1LL << 32) || w + kChunk >= (1LL << 32))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(
        static_cast<unsigned int>((w + kChunk - 1) / kChunk),
        static_cast<unsigned int>(rows < kMaxRowBlocks ? rows
                                                       : kMaxRowBlocks));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    MEDUSA_DISPATCH_ROW_WORD(word_bytes,
        burst_network_kernel<word_t><<<grid, medusa::kThreads, 0, s>>>(
            static_cast<const word_t*>(in), static_cast<word_t*>(out),
            static_cast<unsigned int>(n), static_cast<unsigned int>(w)));
  }
  return static_cast<int>(cudaGetLastError());
}
