// Shared launch helpers for the burst kernels (plain C interface, loaded
// with ctypes).  Every kernel moves machine words: one template instance
// per word width (1, 2, 4, 8 bytes) serves every payload dtype, because the
// networks never look inside a word.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace medusa {

constexpr int kThreads = 256;

// Grid for a grid-stride loop over `total` words: enough blocks to fill
// the card several times over, capped so the launch stays legal.
inline unsigned int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32LL;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

// Whether a grid-stride loop over `total` words can keep every index it
// forms (up to total + one grid's worth of threads) in 32 bits.
inline bool fits_u32(long long total, unsigned int grid) {
  return total + static_cast<long long>(grid) * kThreads < (1LL << 32);
}

}  // namespace medusa

// Instantiate `launch<word_t>(...)` for the word width `word_bytes`;
// unknown widths report cudaErrorInvalidValue (the wrapper checks first).
#define MEDUSA_DISPATCH_WORD(word_bytes, ...)                         \
  switch (word_bytes) {                                               \
    case 1: { using word_t = uint8_t;  __VA_ARGS__; break; }          \
    case 2: { using word_t = uint16_t; __VA_ARGS__; break; }          \
    case 4: { using word_t = uint32_t; __VA_ARGS__; break; }          \
    case 8: { using word_t = uint64_t; __VA_ARGS__; break; }          \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }

// The same over row words, which may be 16 bytes wide (uint4): a wrapper
// views each payload row as the widest word dividing its bytes.
#define MEDUSA_DISPATCH_ROW_WORD(word_bytes, ...)                     \
  switch (word_bytes) {                                               \
    case 1:  { using word_t = uint8_t;  __VA_ARGS__; break; }         \
    case 2:  { using word_t = uint16_t; __VA_ARGS__; break; }         \
    case 4:  { using word_t = uint32_t; __VA_ARGS__; break; }         \
    case 8:  { using word_t = uint64_t; __VA_ARGS__; break; }         \
    case 16: { using word_t = uint4;    __VA_ARGS__; break; }         \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }
