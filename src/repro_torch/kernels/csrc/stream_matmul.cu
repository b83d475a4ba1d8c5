// Streaming matmul with an fp32 accumulator (the paper's layer processor,
// §III-E).
//
// Replaces: src/repro/kernels/stream_matmul.py, stream_matmul (pallas_call
// body _matmul_kernel: a (M/bm, N/bn, K/bk) grid whose sequential K axis
// carries an fp32 VMEM accumulator, double-buffered by the Pallas pipeline).
//
//   out[m, n] = cast_to_x_dtype( sum_k float(x[m, k]) * float(w[k, n]) )
//
// for x [M, K] and w [K, N] row-major, both bf16 or both fp32.  The TPU's
// sequential K grid becomes a K loop inside each block (blocks run in no
// order and carry nothing between them); the double buffer becomes a ring
// of shared-memory stages, the next ones loading while the current one is
// consumed.  Any M, N and K: every load is bounds-checked and zero-filled,
// so ragged edges need no padding pass and no fallback.
//
// bf16: tensor cores through mma.sync.m16n8k16 (bf16 x bf16 -> fp32).  A
// 256-thread block computes a 128 x 128 tile, 8 warps of 64 x 32, in K steps
// of 32 through a ring of 4 stages in dynamic shared memory (74 KB; rows
// padded to 80 and 272 bytes, so ldmatrix reads are free of bank
// conflicts), filled by cp.async with zero-fill when K and N are multiples
// of 8 and both operands 16-byte aligned, else by bounds-checked element
// loads.  Bound: operations at the prefill shape (322 GFLOP against 210
// MB), bytes at the decode shape (M = 4, where most of each 128-row tile is
// padding: expected, and left to the kernel redesign with TMA and wgmma).
//
// fp32: plain fp32 FMA in K order on the CUDA cores, no TF32, so the
// product keeps the reference's exact-fp32 numerics.  A 256-thread block
// computes a 64 x 64 tile (enough blocks to fill the card at 1024^3), 4 x 4
// outputs per thread, in K steps of 16, with the next step's operands
// prefetched into registers while the current one is consumed.  Bound:
// operations (66.9 TFLOP/s without tensor cores).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// fp32: SIMT FMA
// ---------------------------------------------------------------------------

constexpr int kF32Tile = 64, kF32Step = 16;

__global__ void __launch_bounds__(256)
matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int m, int n, int k) {
  // x's tile is stored transposed ([k][m]) so a thread reads its 4 rows as
  // one float4; the +4 pad keeps float4 alignment.
  __shared__ __align__(16) float as[2][kF32Step][kF32Tile + 4];
  __shared__ __align__(16) float bs[2][kF32Step][kF32Tile + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kF32Tile, n0 = blockIdx.x * kF32Tile;
  const int a_row = tid / 4, a_col = (tid % 4) * 4;     // 64 x 16 of x
  const int b_row = tid / 16, b_col = (tid % 16) * 4;   // 16 x 64 of w
  const int steps = (k + kF32Step - 1) / kF32Step;
  float a_reg[4], b_reg[4];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto load = [&](int k0) {
    const int gm = m0 + a_row;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + a_col + i;
      a_reg[i] = (gm < m && gk < k)
          ? x[static_cast<long long>(gm) * k + gk] : 0.f;
    }
    const int gk = k0 + b_row;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gn = n0 + b_col + i;
      b_reg[i] = (gk < k && gn < n)
          ? w[static_cast<long long>(gk) * n + gn] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) as[buf][a_col + i][a_row] = a_reg[i];
    *reinterpret_cast<float4*>(&bs[buf][b_row][b_col]) =
        make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
  };

  if (steps > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load((s + 1) * kF32Step);
#pragma unroll
    for (int kk = 0; kk < kF32Step; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (s + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < n) out[static_cast<long long>(gm) * n + gn] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

constexpr int kTileM = 128, kTileN = 128, kStepK = 32, kStages = 4;
constexpr int kRowA = kStepK + 8;     // 80-byte rows
constexpr int kRowB = kTileN + 8;     // 272-byte rows
constexpr int kStageA = kTileM * kRowA, kStageB = kStepK * kRowB;
constexpr int kSmemBytes = kStages * (kStageA + kStageB) * 2;   // 75,776

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (the
// source address is then never read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kStages - 2 copy groups are still in flight
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint16_t to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// bf16 payloads are moved as their 16-bit words; only the mma and the
// epilogue's rounding look inside them.
template <bool kAsync>
__global__ void __launch_bounds__(256)
matmul_bf16_kernel(const uint16_t* __restrict__ x,
                   const uint16_t* __restrict__ w, uint16_t* __restrict__ out,
                   int m, int n, int k) {
  // a ring of kStages stages, each x [128 x 32] then w [32 x 128]
  extern __shared__ __align__(128) uint16_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;        // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int steps = (k + kStepK - 1) / kStepK;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto tile_a = [&](int slot) { return smem + slot * (kStageA + kStageB); };
  auto tile_b = [&](int slot) { return tile_a(slot) + kStageA; };

  // one stage: 512 chunks of 8 of x's tile, then 512 of w's
  auto load = [&](int slot, int k0) {
    uint16_t* as = tile_a(slot);
    uint16_t* bs = tile_b(slot);
#pragma unroll
    for (int c = tid; c < 512; c += 256) {
      const int r = c >> 2, cc = (c & 3) * 8;
      const int gm = m0 + r, gk = k0 + cc;
      uint16_t* dst = as + r * kRowA + cc;
      if constexpr (kAsync) {
        const bool ok = gm < m && gk < k;    // K % 8 == 0: whole chunk
        cp_async16(dst, ok ? x + static_cast<long long>(gm) * k + gk : x,
                   ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < m && gk + e < k)
              ? x[static_cast<long long>(gm) * k + gk + e] : uint16_t(0);
      }
    }
#pragma unroll
    for (int c = tid; c < 512; c += 256) {
      const int r = c >> 4, cc = (c & 15) * 8;
      const int gk = k0 + r, gn = n0 + cc;
      uint16_t* dst = bs + r * kRowB + cc;
      if constexpr (kAsync) {
        const bool ok = gk < k && gn < n;    // N % 8 == 0: whole chunk
        cp_async16(dst, ok ? w + static_cast<long long>(gk) * n + gn : w,
                   ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < k && gn + e < n)
              ? w[static_cast<long long>(gk) * n + gn + e] : uint16_t(0);
      }
    }
  };

  // prologue: the first kStages - 1 stages in flight, one group each
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s * kStepK);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_ring();          // stage s has landed (this thread's part)
    __syncthreads();               // ... every thread's; and the slot the
                                   // next load overwrites was last read in
                                   // step s - 1, before this barrier
    if (s + kStages - 1 < steps)
      load((s + kStages - 1) % kStages, (s + kStages - 1) * kStepK);
    cp_async_commit();
    const uint16_t* as = tile_a(s % kStages);
    const uint16_t* bs = tile_b(s % kStages);
#pragma unroll
    for (int ks = 0; ks < kStepK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], as + (wm * 64 + mi * 16 + (lane & 15)) * kRowA
                                + ks + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, bs + (ks + (lane & 15)) * kRowB + wn * 32
                                 + nj * 16 + (lane >> 4) * 8);
        bf[2 * nj][0] = t[0];
        bf[2 * nj][1] = t[1];
        bf[2 * nj + 1][0] = t[2];
        bf[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }

  // accumulator fragment: rows lane/4 and lane/4 + 8, columns 2*(lane%4)+{0,1}
  const bool pairs = (n & 1) == 0;      // then a column pair is 4-byte aligned
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int gn = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = m0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * h;
        if (gm >= m || gn >= n) continue;
        const uint16_t lo = to_bf16_bits(acc[mi][ni][2 * h]);
        const uint16_t hi = to_bf16_bits(acc[mi][ni][2 * h + 1]);
        uint16_t* dst = out + static_cast<long long>(gm) * n + gn;
        if (pairs && gn + 1 < n) {
          *reinterpret_cast<uint32_t*>(dst) =
              static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
        } else {
          dst[0] = lo;
          if (gn + 1 < n) dst[1] = hi;
        }
      }
    }
  }
}

}  // namespace

// dtype: 0 = fp32 x fp32 -> fp32, 1 = bf16 x bf16 -> bf16
extern "C" int medusa_stream_matmul(const void* x, const void* w, void* out,
                                    int m, int n, int k, int dtype,
                                    void* stream) {
  if (m > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
      const dim3 grid((n + kF32Tile - 1) / kF32Tile,
                      (m + kF32Tile - 1) / kF32Tile);
      matmul_f32_kernel<<<grid, 256, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), m, n, k);
    } else if (dtype == 1) {
      const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
      const bool async = k % 8 == 0 && n % 8 == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(w) % 16 == 0;
      const auto* xb = static_cast<const uint16_t*>(x);
      const auto* wb = static_cast<const uint16_t*>(w);
      auto* ob = static_cast<uint16_t*>(out);
      // above 48 KB of shared memory only once the attribute is raised
      if (async) {
        cudaFuncSetAttribute(matmul_bf16_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
        matmul_bf16_kernel<true><<<grid, 256, kSmemBytes, s>>>(xb, wb, ob, m,
                                                               n, k);
      } else {
        cudaFuncSetAttribute(matmul_bf16_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
        matmul_bf16_kernel<false><<<grid, 256, kSmemBytes, s>>>(xb, wb, ob,
                                                                m, n, k);
      }
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
