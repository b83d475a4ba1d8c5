// Shared launch helpers for the burst kernels (plain C interface, loaded
// with ctypes).  Every kernel moves machine words: one template instance
// per word width serves every payload dtype, because the networks never
// look inside a word.  A wrapper views each payload row as the widest word
// (1, 2, 4, 8 or 16 bytes) dividing its bytes and both buffers' alignment.
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

// -- the frame copy of the sparse bursts (scatter_burst.cu, gather_burst.cu)
//
// A frame is n rows of rw words.  One side holds it as one contiguous block
// (word o at o), the other as rows strided by frame_words = n * rw (word
// (row, wi) at row * frame_words + wi).  A warp copies a frame: lane l
// moves words l, l + 32, ..., kFrameBatch loads before their stores, and
// its place (row, wi) steps by 32 words with an add and a compare, so the
// copy costs no division.  Offsets inside a group's N x N rows are 32-bit,
// only the frame bases 64-bit; frame_copy_fits checks the entry's shape.

constexpr int kWarps = kThreads / 32;
constexpr int kFrameBatch = 8;               // loads in flight a lane

// Whether a launch of frame_blocks(frames) blocks keeps its frame numbers
// (up to one grid past the last) and a group's offsets in 32 bits.
inline bool frame_copy_fits(long long frames, long long n, long long rw) {
  return 2 * frames + kWarps < (1LL << 32) &&
         n * n * rw + 32 * kFrameBatch < (1LL << 32);
}

// A warp for every frame.
inline unsigned int frame_blocks(long long frames) {
  return static_cast<unsigned int>((frames + kWarps - 1) / kWarps);
}

// A lane's first place in a frame of rows of rw words, and its step of 32
// words: two divisions a warp.
struct LanePlace {
  unsigned int row, wi, drow, dwi;
  __device__ __forceinline__ LanePlace(unsigned int lane, unsigned int rw)
      : row(lane / rw), wi(lane - (lane / rw) * rw), drow(32u / rw),
        dwi(32u - (32u / rw) * rw) {}
};

// Copy one frame, the strided side at dst (kStridedDst, the gather) or at
// src (the scatter).  src == nullptr stores a zero frame and loads nothing.
template <bool kStridedDst, typename T>
__device__ __forceinline__ void copy_frame(const T* __restrict__ src,
                                           T* __restrict__ dst,
                                           unsigned int frame_words,
                                           unsigned int rw, LanePlace at,
                                           unsigned int lane) {
  for (unsigned int o = lane; o < frame_words; o += 32 * kFrameBatch) {
    unsigned int strided[kFrameBatch];
#pragma unroll
    for (int i = 0; i < kFrameBatch; ++i) {
      strided[i] = at.row * frame_words + at.wi;
      at.wi += at.dwi;
      at.row += at.drow;
      if (at.wi >= rw) {
        at.wi -= rw;
        ++at.row;
      }
    }
    T v[kFrameBatch];
#pragma unroll
    for (int i = 0; i < kFrameBatch; ++i)
      if (o + 32 * i < frame_words)
        v[i] = src == nullptr ? T{}
                              : src[kStridedDst ? o + 32 * i : strided[i]];
#pragma unroll
    for (int i = 0; i < kFrameBatch; ++i)
      if (o + 32 * i < frame_words)
        dst[kStridedDst ? strided[i] : o + 32 * i] = v[i];
  }
}

}  // namespace medusa

// Instantiate `launch<word_t>(...)` for the row word `word_bytes` (16
// bytes is uint4); unknown widths report cudaErrorInvalidValue (the wrapper
// checks first).
#define MEDUSA_DISPATCH_ROW_WORD(word_bytes, ...)                     \
  switch (word_bytes) {                                               \
    case 1:  { using word_t = uint8_t;  __VA_ARGS__; break; }         \
    case 2:  { using word_t = uint16_t; __VA_ARGS__; break; }         \
    case 4:  { using word_t = uint32_t; __VA_ARGS__; break; }         \
    case 8:  { using word_t = uint64_t; __VA_ARGS__; break; }         \
    case 16: { using word_t = uint4;    __VA_ARGS__; break; }         \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }
