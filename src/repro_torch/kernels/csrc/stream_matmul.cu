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
// consumed.  Any M, N and K; ragged edges need no padding pass.
//
// Four kernels, one per route.  The host (kernels/stream_matmul.py,
// route()) picks the route from the dtype, the shape and the operands'
// alignment alone and passes it here as an int; no launch falls back to
// another route.
//
//   route     | when                                 | bound (served shape)
//   ----------+--------------------------------------+---------------------
//   0 fma     | float32                              | operations
//   1 mma_sync| bf16, K == 0, K % 8, N % 8, or a     | launch (ragged)
//             | base not 16-byte aligned (what TMA   |
//             | cannot describe)                     |
//   2 small_m | bf16, else, M <= 16 (SMALL_M)        | bytes of w (decode)
//   3 wgmma   | bf16, else, M > 16                   | operations (prefill)
//
// fma: exact fp32 FMA on the CUDA cores, no TF32 (the reference's numerics
// are exact fp32 and wgmma takes no fp32 input).  A 256-thread block owns a
// 128 x 128 tile, 8 x 8 outputs per thread fed by four 16-byte shared-memory
// reads per K row (64 FMAs per 4 loads), in K steps of 32 double-buffered
// through cp.async; the two blocks of a cluster split K and the second adds
// its sums into the first's through distributed shared memory, in that
// order (at 1024^3: 64 tiles, 128 blocks for 132 SMs).  Every load is
// bounds-checked and zero-filled, x's as 4-byte copies landing transposed
// ([k][m]) so a thread reads its 8 rows as two float4; w's as 16-byte copies
// where N % 4 == 0 and w is 16-byte aligned, else as 4-byte copies into a
// 128 x 64 tile of 8 x 4 outputs.
//
// mma_sync: mma.sync.m16n8k16 fed by ldmatrix from a 4-stage cp.async ring,
// 128 x 128 tiles of 8 warps (64 x 32 each), element loads where K, N or a
// base rules out 16-byte copies.  Kept for the shapes TMA cannot describe.
//
// small_m: at M = 4 the product is a stream of w's 52.5 MB; 128-row tiles
// would be 97 % padding and the SIMT product spends ~46 instructions on
// each 16 bytes of w.  So x's rows, zero-padded to 16, are the A operand of
// mma.sync.m16n8k16 and w streams through tensor cores: each 256-thread
// block owns 256 columns and half of K (clusters of two blocks split K),
// all its threads copy 32-row stages of w (a warp one contiguous 512-byte
// run) through a 5-stage cp.async ring marked L2 evict_first (w is read
// once, so its lines, not the L2's other dirty lines, are the ones to go),
// and each warp multiplies 16 of a stage's rows by 64 columns with one
// ldmatrix of x and four ldmatrix.trans of w.  The two K halves of a block
// add in shared memory, then the cluster's blocks in rank order through
// distributed shared memory: no float atomics, no second launch, so two
// launches on the same inputs give the same bits.
//
// wgmma: the Hopper GEMM.  A persistent grid (one block per SM, in
// clusters of two) walks units of two neighbouring 128 x 256 output tiles
// of one N tile, M fastest.  Each block has three warpgroups: one
// producer, whose single elected thread keeps TMA loads (cp.async.bulk.
// tensor, 128-byte swizzle) of x's 128 x 64 and w's 64 x 256 tiles in flight
// through a 4-stage ring (48 KB a stage) guarded by full and empty mbarriers,
// and gives its registers away (setmaxnreg 40); and two consumers (setmaxnreg
// 232), each running wgmma.mma_async m64n256k16 on its 64 rows with 128 fp32
// accumulators per thread, one wgmma group kept in flight.  Bound: each
// stage feeds 4.2 MFLOP from 48 KB, so at the bf16 peak the L2 would have to
// serve 11 TB/s to the SMs.  So the two blocks of a cluster take the
// unit's two M tiles: each loads its own x tile and half of w's, multicast
// to both, so each SM pulls 32 KB a stage; a block's slot is free once the
// consumer warps of both blocks released it (remote mbarrier arrives), and
// a producer leaves only after its last slots were released.  TMA fills
// rows and columns past M, N and K with zeros, so ragged edges need no
// padding; a block whose M tile lies wholly past M (the second of the last
// unit when M spans an odd number of tiles, or one tile) loads no x tile
// and still sends its half of w, and its masked stores write nothing.  The
// epilogue rounds with __float2bfloat16_rn, as the plain version's cast
// does.
//
// Traps, named where the code meets them:
//   * w is [K, N] with N contiguous, so wgmma's B operand is MN-major: its
//     tiles are 64-column (128-byte) swizzle atoms, the descriptor's leading
//     byte offset steps between atoms along N and its stride byte offset
//     between 8-row groups along K, and the transpose-B immediate is 1.
//   * cuTensorMapEncodeTiled lives in libcuda, which the build does not
//     link: it is fetched once through the runtime's
//     cudaGetDriverEntryPoint.  The tensor maps are encoded on the host for
//     each call and passed as __grid_constant__ parameters.
//   * wgmma and setmaxnreg exist only on sm_90a, the build's target.
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// fp32: SIMT FMA
// ---------------------------------------------------------------------------

constexpr int kF32TileM = 128, kF32TileRows = 8;   // 16 threads of 8 rows
constexpr int kF32Step = 32, kF32Stages = 2;       // K rows a stage
constexpr int kF32RowA = kF32TileM + 4;            // x's tile, [k][m]

template <int kTC>
__host__ __device__ constexpr int f32_smem_bytes() {
  return kF32Stages * kF32Step * (kF32RowA + 16 * kTC + 4) * 4;
}

// 4 or 16 bytes global -> shared, asynchronously; zero-filled when !valid
template <int kBytes>
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

// A 256-thread block owns a 128 x 16 kTC tile, 8 x kTC outputs a thread,
// over half of K: the two blocks of a cluster (along the grid's z) split K,
// and the second adds its sums into the first's through distributed shared
// memory.  kVecB: w's rows move as 16-byte words (N % 4 == 0 and w 16-byte
// aligned), else as 4-byte elements.
template <int kTC, bool kVecB>
__global__ void __launch_bounds__(256)
matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int m, int n, int k) {
  constexpr int kTileN = 16 * kTC;
  constexpr int kRowB = kTileN + 4;          // w's tile, [k][n]
  constexpr int kThreads = 256;
  static_assert(f32_smem_bytes<kTC>() >= kF32TileRows * kTC * kThreads * 4,
                "the ring holds a block's sums");
  extern __shared__ __align__(16) float f32_smem[];
  float* const as = f32_smem;                                  // [s][k][m]
  float* const bs = f32_smem + kF32Stages * kF32Step * kF32RowA;  // [s][k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kF32TileM, n0 = blockIdx.x * kTileN;
  // this block's half of K (a multiple of kF32Step)
  const int share = (k + 2 * kF32Step - 1) / (2 * kF32Step) * kF32Step;
  const int kbeg = static_cast<int>(blockIdx.z) * share;
  const int kend = min(k, kbeg + share);
  const int steps = kend > kbeg ? (kend - kbeg + kF32Step - 1) / kF32Step : 0;
  float acc[kF32TileRows][kTC];
#pragma unroll
  for (int i = 0; i < kF32TileRows; ++i)
#pragma unroll
    for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;

  // x's 128 x 32: this thread's column a_c of the tile, rows a_r + 8 i
  // (row-contiguous reads across the warp)
  constexpr int kAPer = kF32TileM * kF32Step / kThreads;
  constexpr int kARows = kThreads / kF32Step;
  const int a_c = tid % kF32Step, a_r = tid / kF32Step;
  const float* const xa = x + static_cast<long long>(m0 + a_r) * k + a_c;
  uint32_t a_rows = 0;
#pragma unroll
  for (int i = 0; i < kAPer; ++i)
    if (m0 + a_r + kARows * i < m) a_rows |= 1u << i;
  // w's 32 x kTileN: this thread's columns b_c.., rows b_r + i * kBRows
  constexpr int kBVec = kVecB ? 4 : 1;
  constexpr int kBCols = kTileN / kBVec, kBRows = kThreads / kBCols;
  constexpr int kBPer = kF32Step / kBRows;
  const int b_c = (tid % kBCols) * kBVec, b_r = tid / kBCols;
  const float* const wb = w + static_cast<long long>(b_r) * n + n0 + b_c;
  const bool b_col = n0 + b_c < n;     // kVecB: N % 4 == 0, all 4 or none

  auto load = [&](int slot, int k0) {
    float* const a_s = as + slot * kF32Step * kF32RowA;
    float* const b_s = bs + slot * kF32Step * kRowB;
    const bool a_k = k0 + a_c < kend;
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const bool ok = a_k && ((a_rows >> i) & 1u);
      cp_async_f32<4>(a_s + a_c * kF32RowA + a_r + kARows * i,
                      ok ? xa + static_cast<long long>(kARows * i) * k + k0
                         : x, ok);
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int r = b_r + kBRows * i;
      const bool ok = b_col && k0 + r < kend;
      cp_async_f32<4 * kBVec>(
          b_s + r * kRowB + b_c,
          ok ? wb + static_cast<long long>(k0 + kBRows * i) * n : w, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < steps) load(s, kbeg + s * kF32Step);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int s = 0; s < steps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kF32Stages - 2)
                 : "memory");
    __syncthreads();     // stage s landed for every thread; the slot loaded
                         // next was last read in step s - 1
    if (s + kF32Stages - 1 < steps)
      load((s + kF32Stages - 1) % kF32Stages,
           kbeg + (s + kF32Stages - 1) * kF32Step);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* const a_s = as + (s % kF32Stages) * kF32Step * kF32RowA;
    const float* const b_s = bs + (s % kF32Stages) * kF32Step * kRowB;
#pragma unroll
    for (int kk = 0; kk < kF32Step; ++kk) {
      float a[kF32TileRows], b[kTC];
#pragma unroll
      for (int q = 0; q < kF32TileRows / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            a_s + kk * kF32RowA + ty * kF32TileRows + 4 * q);
        a[4 * q] = v.x, a[4 * q + 1] = v.y, a[4 * q + 2] = v.z,
        a[4 * q + 3] = v.w;
      }
      // 4 columns at tx * 4 in each 64-column part: 16-byte reads that
      // are contiguous across the warp
#pragma unroll
      for (int q = 0; q < kTC / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            b_s + kk * kRowB + tx * 4 + 64 * q);
        b[4 * q] = v.x, b[4 * q + 1] = v.y, b[4 * q + 2] = v.z,
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kF32TileRows; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // the second block's sums into the first's, in that order
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                           // the ring is drained
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const bool second = cluster.block_rank() == 1;
  if (second) {
#pragma unroll
    for (int i = 0; i < kF32TileRows; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j)
        f32_smem[(i * kTC + j) * kThreads + tid] = acc[i][j];
  }
  cluster.sync();
  if (!second) {
    const float* peer = cluster.map_shared_rank(f32_smem, 1);
#pragma unroll
    for (int i = 0; i < kF32TileRows; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j)
        acc[i][j] += peer[(i * kTC + j) * kThreads + tid];
  }
  cluster.sync();                            // the peer's sums were read
  if (second) return;

#pragma unroll
  for (int i = 0; i < kF32TileRows; ++i) {
    const int gm = m0 + ty * kF32TileRows + i;
    if (gm >= m) continue;
#pragma unroll
    for (int q = 0; q < kTC / 4; ++q) {
      const int gn = n0 + tx * 4 + 64 * q;
      float* dst = out + static_cast<long long>(gm) * n + gn;
      if ((n & 3) == 0 && gn + 3 < n) {     // out is 16-byte aligned
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                        acc[i][4 * q + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < n) dst[j] = acc[i][4 * q + j];
      }
    }
  }
}

template <int kTC, bool kVecB>
int launch_f32(const float* x, const float* w, float* out, int m, int n,
               int k, cudaStream_t s) {
  auto* kernel = matmul_f32_kernel<kTC, kVecB>;
  constexpr int bytes = f32_smem_bytes<kTC>();
  // above 48 KB of shared memory only once the attribute is raised
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + 16 * kTC - 1) / (16 * kTC),
                     (m + kF32TileM - 1) / kF32TileM, 2);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, x, w, out, m, n,
                                             k));
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

// ---------------------------------------------------------------------------
// bf16, M <= 16: a stream of w
// ---------------------------------------------------------------------------

constexpr int kSmallCols = 256, kSmallRows = 32, kSmallThreads = 256;
constexpr int kSmallStages = 5;                  // the ring of w's stages
constexpr int kSmallSplit = 2;                   // blocks of a cluster
constexpr int kSmallPitch = kSmallCols + 8;      // w's stage rows, 528 bytes
constexpr int kSmallChunk = 1024;                // K rows of x in shared
constexpr int kSmallXPitch = kSmallChunk + 8;    // memory at a time

// x's 16 rows (zeros past M), a ring of w's 32-row stages (at the end the
// K halves' sums), and the inbox for the sums of the cluster's other blocks
constexpr int kSmallSmem = 2 * 16 * kSmallXPitch +
                           2 * kSmallStages * kSmallRows * kSmallPitch +
                           4 * (kSmallSplit - 1) * 16 * kSmallCols;

// 16 bytes global -> shared, asynchronously, zero-filled when !valid, the
// line marked first to leave the L2 (w is read once)
__device__ __forceinline__ void cp_async16_once(void* dst, const void* src,
                                                bool valid, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0), "l"(policy)
      : "memory");
}

// The blocks of a cluster (along the grid's y) split K and add their sums
// through distributed shared memory.  Clusters of two blocks of 134 KB: all
// of them resident at once at N = 10240 (larger clusters, or two blocks to
// an SM, left some waiting for a second round).
__global__ void __cluster_dims__(1, kSmallSplit, 1)
    __launch_bounds__(kSmallThreads)
matmul_small_m_kernel(const uint16_t* __restrict__ x,
                      const uint16_t* __restrict__ w,
                      uint16_t* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(128) uint16_t sm_smem[];
  uint16_t* const xs = sm_smem;                          // [16][XPitch]
  uint16_t* const ring = sm_smem + 16 * kSmallXPitch;    // [5][32][Pitch]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = warp & 3, kh = warp >> 2;   // 64 columns, 16 of 32 rows
  const int n0 = blockIdx.x * kSmallCols;
  // this block's K rows, from a 32-row boundary
  const int kc = (k + kSmallSplit * kSmallRows - 1) /
                 (kSmallSplit * kSmallRows) * kSmallRows;
  const int kb0 = static_cast<int>(blockIdx.y) * kc;
  const int kb1 = min(k, kb0 + kc);
  const int stages = kb1 > kb0 ? (kb1 - kb0 + kSmallRows - 1) / kSmallRows
                               : 0;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  uint64_t once;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(once));
  // one stage: 32 rows x 256 columns of w, 4 16-byte copies a thread, a
  // warp's 32 copies one contiguous 512-byte run; zeros past kb1 and N
  auto load = [&](int slot, int st) {
    uint16_t* const dst = ring + slot * kSmallRows * kSmallPitch;
#pragma unroll
    for (int i = 0; i < kSmallRows * kSmallCols / 8 / kSmallThreads; ++i) {
      const int c = tid + kSmallThreads * i;
      const int r = c / (kSmallCols / 8), cc = (c % (kSmallCols / 8)) * 8;
      const int gk = kb0 + st * kSmallRows + r, gn = n0 + cc;
      const bool ok = gk < kb1 && gn < n;
      cp_async16_once(dst + r * kSmallPitch + cc,
                      ok ? w + static_cast<long long>(gk) * n + gn : w, ok,
                      once);
    }
  };

  // x's chunk of kSmallChunk rows from c0: rows past M and columns past kb1
  // read as zeros; every load issued before the first store
  auto fill = [&](int c0) {
    constexpr int kFill = 16 * kSmallChunk / 8 / kSmallThreads;
    uint4 v[kFill];
#pragma unroll
    for (int i = 0; i < kFill; ++i) {
      const int e = tid + kSmallThreads * i;
      const int mm = e / (kSmallChunk / 8), kk = (e % (kSmallChunk / 8)) * 8;
      v[i] = mm < m && c0 + kk < kb1
          ? *reinterpret_cast<const uint4*>(
                x + static_cast<long long>(mm) * k + c0 + kk)
          : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kFill; ++i) {
      const int e = tid + kSmallThreads * i;
      const int mm = e / (kSmallChunk / 8), kk = (e % (kSmallChunk / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + mm * kSmallXPitch + kk) = v[i];
    }
  };

#pragma unroll
  for (int s = 0; s < kSmallStages - 1; ++s) {
    if (s < stages) load(s, s);
    cp_async_commit();
  }
  fill(kb0);                  // while the first stages are in flight
  for (int st = 0; st < stages; ++st) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kSmallStages - 2)
                 : "memory");
    __syncthreads();      // stage st landed; the slot loaded next and x's
                          // chunk were last read in step st - 1
    const int kr = st * kSmallRows;              // row of the block's range
    if (kr > 0 && kr % kSmallChunk == 0) {
      fill(kb0 + kr);
      __syncthreads();
    }
    if (st + kSmallStages - 1 < stages)
      load((st + kSmallStages - 1) % kSmallStages, st + kSmallStages - 1);
    cp_async_commit();
    // this warp: x's 16 x 16 at the stage's rows 16 kh.., times w's 16 x 64
    const uint16_t* const ws =
        ring + (st % kSmallStages) * kSmallRows * kSmallPitch;
    const int xk = (kr % kSmallChunk) + 16 * kh;
    uint32_t af[4];
    ldmatrix_x4(af, xs + (lane & 15) * kSmallXPitch + xk + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t t[4];
      ldmatrix_x4_trans(t, ws + (16 * kh + (lane & 15)) * kSmallPitch +
                               ng * 64 + nj * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * nj], af, t[0], t[1]);
      mma_bf16(acc[2 * nj + 1], af, t[2], t[3]);
    }
  }

  // the two K halves' sums, in order, then the cluster's blocks in rank
  // order; the fragment's rows lane/4 and lane/4 + 8, columns 2 (lane % 4)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                               // the ring is drained
  float* const red = reinterpret_cast<float*>(ring);      // [2][16][256]
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(kh * 16 + lane / 4 + 8 * (e >> 1)) * kSmallCols + ng * 64 +
          ni * 8 + 2 * (lane % 4) + (e & 1)] = acc[ni][e];
  __syncthreads();
  // rank r > 0 stores its sums into slot r - 1 of rank 0's inbox
  // ([kSmallSplit - 1][16][256] fp32), which nothing else touches
  float* const inbox =
      reinterpret_cast<float*>(ring + kSmallStages * kSmallRows * kSmallPitch);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const unsigned int rank = cluster.block_rank();
  float* const slot = rank > 0 ? cluster.map_shared_rank(inbox, 0) +
                                     (rank - 1) * 16 * kSmallCols
                               : nullptr;
  float sums[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i < m) {
      sums[i] = red[i * kSmallCols + tid] + red[(16 + i) * kSmallCols + tid];
      if (rank > 0) slot[i * kSmallCols + tid] = sums[i];
    }
  }
  cluster.sync();                  // the inbox is full (release / acquire)
  if (rank == 0) {
    const int gn = n0 + tid;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i >= m) break;
      float s = sums[i];
#pragma unroll
      for (int r = 0; r < kSmallSplit - 1; ++r)
        s += inbox[(r * 16 + i) * kSmallCols + tid];
      if (gn < n)
        out[static_cast<long long>(i) * n + gn] = to_bf16_bits(s);
    }
  }
}

void launch_small_m(const uint16_t* x, const uint16_t* w, uint16_t* out,
                    int m, int n, int k, cudaStream_t s) {
  cudaFuncSetAttribute(matmul_small_m_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmallSmem);
  const dim3 grid((n + kSmallCols - 1) / kSmallCols, kSmallSplit);
  matmul_small_m_kernel<<<grid, kSmallThreads, kSmallSmem, s>>>(x, w, out, m,
                                                                n, k);
}

// ---------------------------------------------------------------------------
// Hopper plumbing for the wgmma route: mbarriers, TMA, tensor maps
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// a 2-D tile of `map` at (c0 innermost, c1) into shared memory, completing
// on `bar`; coordinates past the tensor read as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, through the runtime (the build links
// no -lcuda); null if the installed libcuda does not have it
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// a row-major bf16 [outer, inner] matrix, read in boxes of [box_outer,
// box_inner] with the 128-byte swizzle and zeros past its edges
bool encode_bf16(EncodeTiled encode, CUtensorMap* map, const void* base,
                 int inner, int outer, int box_inner, int box_outer) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// bf16, M > 16: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kGemmM = 128, kGemmN = 256, kGemmK = 64, kGemmStages = 4;
constexpr int kGemmTileA = kGemmM * kGemmK * 2;          // 16 KB
constexpr int kGemmAtomB = kGemmK * 64 * 2;              // 8 KB: 64 columns
constexpr int kGemmTileB = kGemmK * kGemmN * 2;          // 32 KB
constexpr int kGemmStage = kGemmTileA + kGemmTileB;      // 48 KB
constexpr int kGemmThreads = 384;                        // 3 warpgroups
// the ring, its barriers, and slack to align the ring to 1024 bytes (the
// 128-byte swizzle's period)
constexpr int kGemmSmem = kGemmStages * kGemmStage + 2 * kGemmStages * 8 +
                          1024;

// the same tile of `map` into the same shared-memory offset of every block
// of the cluster in `mask`, completing on the barrier at `bar`'s offset in
// each
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "h"(mask)
      : "memory");
}

// arrive on the barrier at `bar`'s offset in block `cta` of the cluster (a
// plain arrive: with a cluster-scope release on it the consumer warps
// stalled at every stage)
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 remote;\n"
      " mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(bar), "r"(cta) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset, stride byte offset, all in 16-byte units
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d[64 x 256] += a[64 x 16] (K-major) * b[16 x 256] (MN-major: transpose-B
// immediate 1), fp32 accumulators, per warpgroup
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// the two blocks of a cluster take neighbouring M tiles of one N tile; each
// loads its x tile and half of w's, multicast to both
constexpr int kGemmCtas = 2;

__global__ void __launch_bounds__(kGemmThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    uint16_t* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(1024) uint8_t gemm_smem[];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023) & ~1023u;
  const uint32_t bars = ring + kGemmStages * kGemmStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kGemmStages + s); };
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  // work units: an N tile and two neighbouring M tiles, M fastest
  const int m_units = (m + kGemmCtas * kGemmM - 1) / (kGemmCtas * kGemmM);
  const int units = m_units * ((n + kGemmN - 1) / kGemmN);
  const int first = blockIdx.x / kGemmCtas;
  const int stride = gridDim.x / kGemmCtas;
  const int k_blocks = (k + kGemmK - 1) / kGemmK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(full(s), 1);                // the producer's arrive + bytes
      mbar_init(empty(s), 8 * kGemmCtas);   // every consumer warp reading
    }                                       // what this block's loads write
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  // one branch per role for the block's whole life: setmaxnreg needs the
  // roles never to meet again
  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      auto next = [&] {
        if (++stage == kGemmStages) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int u = first; u < units; u += stride) {
        const int m0 = ((u % m_units) * kGemmCtas + rank) * kGemmM;
        const int n0 = (u / m_units) * kGemmN;
        const bool rows = m0 < m;     // else no x tile: its rows write nothing
        for (int kb = 0; kb < k_blocks; ++kb, next()) {
          mbar_wait(empty(stage), phase ^ 1);     // the slot was consumed
          const uint32_t a = ring + stage * kGemmStage;
          const uint32_t b = a + kGemmTileA;
          mbar_expect_tx(full(stage), rows ? kGemmStage : kGemmTileB);
          if (rows) tma_load(a, &map_x, full(stage), kb * kGemmK, m0);
          // w's 64 x 256 tile as four 64-column swizzle atoms (a 128-byte
          // swizzle spans at most 128 bytes of the innermost axis), this
          // block's two of them multicast to both blocks
#pragma unroll
          for (int c = 0; c < kGemmN / 64; ++c)
            if (c / 2 == static_cast<int>(rank))
              tma_load_multicast(b + c * kGemmAtomB, &map_w, full(stage),
                                 n0 + 64 * c, kb * kGemmK, 0x3);
        }
      }
      // leave only once both blocks released every slot
      for (int i = 0; i < kGemmStages; ++i, next())
        mbar_wait(empty(stage), phase ^ 1);
    }
  } else {
    // two consumer warpgroups, rows 64 * c .. 64 * c + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    auto release = [&](int s) {
      if (lane == 0) {
        mbar_arrive(empty(s));
        mbar_arrive_peer(empty(s), rank ^ 1);
      }
    };
    float acc[128];
    for (int u = first; u < units; u += stride) {
      const int m0 = ((u % m_units) * kGemmCtas + rank) * kGemmM;
      const int n0 = (u / m_units) * kGemmN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(full(stage), phase);
        const uint32_t a = ring + stage * kGemmStage + c * 64 * 128;
        const uint32_t b = ring + stage * kGemmStage + kGemmTileA;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kGemmK / 16; ++kk) {
          // A, K-major: 128-byte rows, 8-row groups 1024 bytes apart; a
          // K step of 16 is 32 bytes along the (swizzled) row.  B,
          // MN-major: leading byte offset = one 64-column atom (8 KB),
          // stride byte offset = 8 K rows (1024 bytes); a K step of 16 is
          // 16 rows of 128 bytes.
          wgmma_m64n256k16(acc, gmma_desc(a + 32 * kk, 16, 1024),
                           gmma_desc(b + 2048 * kk, kGemmAtomB, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();            // the previous K block's group is done
        if (kb > 0) release(prev);
        prev = stage;
        if (++stage == kGemmStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (k_blocks > 0) release(prev);

      // accumulator layout of m64nNk16: d[4j + 2h + e] is row
      // 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
      const int gm0 = m0 + c * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int gn = n0 + 8 * j + 2 * (lane % 4);   // even; N % 8 == 0
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = gm0 + 8 * h;
          if (gm < m && gn < n)
            *reinterpret_cast<uint32_t*>(
                out + static_cast<long long>(gm) * n + gn) =
                static_cast<uint32_t>(to_bf16_bits(acc[4 * j + 2 * h])) |
                (static_cast<uint32_t>(to_bf16_bits(acc[4 * j + 2 * h + 1]))
                 << 16);
        }
      }
    }
  }
}

int launch_wgmma(const void* x, const void* w, void* out, int m, int n, int k,
                 cudaStream_t s) {
  const EncodeTiled encode = encode_tiled();
  CUtensorMap map_x, map_w;
  if (encode == nullptr ||
      !encode_bf16(encode, &map_x, x, k, m, kGemmK, kGemmM) ||
      !encode_bf16(encode, &map_w, w, n, k, 64, kGemmK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int ctas = kGemmCtas;
  auto* kernel = matmul_wgmma_kernel;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kGemmSmem);
  const long long units =
      static_cast<long long>((m + kGemmM * ctas - 1) / (kGemmM * ctas)) *
      ((n + kGemmN - 1) / kGemmN);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = kGemmSmem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a persistent grid: one block per SM, in as many pairs as can be
  // resident at once (asked once per process)
  static int clusters = 0;
  if (clusters < 1) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    clusters = sms / ctas;
    cfg.gridDim = dim3(ctas);
    int c = 0;
    if (cudaOccupancyMaxActiveClusters(&c, kernel, &cfg) == cudaSuccess &&
        c > 0 && c < clusters)
      clusters = c;
  }
  cfg.gridDim = dim3(static_cast<unsigned int>(
      ctas * (units < clusters ? units : clusters)));
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, map_x, map_w,
                         static_cast<uint16_t*>(out), m, n, k));
}

}  // namespace

// route: 0 = fma (float32), 1 = mma_sync, 2 = small_m, 3 = wgmma (bf16);
// kernels/stream_matmul.py route() picks it.  A route whose preconditions
// the operands miss reports cudaErrorInvalidValue and launches nothing.
extern "C" int medusa_stream_matmul(const void* x, const void* w, void* out,
                                    int m, int n, int k, int route,
                                    void* stream) {
  if (m > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const bool tma = k > 0 && k % 8 == 0 && n % 8 == 0 && aligned;
    const auto* xb = static_cast<const uint16_t*>(x);
    const auto* wb = static_cast<const uint16_t*>(w);
    auto* ob = static_cast<uint16_t*>(out);
    if (route == 0) {
      const auto* xf = static_cast<const float*>(x);
      const auto* wf = static_cast<const float*>(w);
      auto* of = static_cast<float*>(out);
      const int err =
          n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0
              ? launch_f32<8, true>(xf, wf, of, m, n, k, s)
              : launch_f32<4, false>(xf, wf, of, m, n, k, s);
      if (err != 0) return err;
    } else if (route == 1) {
      const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
      const bool async = k % 8 == 0 && n % 8 == 0 && aligned;
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
    } else if (route == 2 && tma && m <= 16) {
      launch_small_m(xb, wb, ob, m, n, k, s);
    } else if (route == 3 && tma) {
      const int err = launch_wgmma(x, w, out, m, n, k, s);
      if (err != 0) return err;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
