// Int8 matrix product with per-row and per-column scales, for Hopper
// (sm_90a): on the s8 tensor cores (int8_matmul_s8_sm90) where K and N
// are multiples of 16, on the CUDA cores' dp4a (int8_matmul_s8) for any
// shape. The rule between them is kernels/int8_matmul.py:choose_route.
//
// Replaces the Pallas kernel repro/kernels/int8_matmul.py (int8_matmul,
// _kernel): out (M, N) = (float(acc) * x_scale[m]) * w_scale[n] with
// acc = sum_k x_q[m, k] * w_q[k, n] accumulated exactly in int32.
//
// Bound: operations, 2*M*K*N at the 1,979 TOP/s of dense int8 tensor
// cores, where the shape is large (4096 x 4096 x 12288: 0.208 ms, against
// 0.06 ms to write the float32 output); at the kernel bench's 256 x 512 x
// 256 both bounds are microseconds and the launch dominates.
//
// dp4a (int8_matmul_s8): a block of 256 threads owns a 64 x 64 output
// tile and walks K in chunks of 64. Each chunk of x and w is staged in
// shared memory as 32-bit words of four int8 along K (x rows as they lie;
// w columns packed from four rows), zero-filled past M, N and K, so any
// shape works, (1, 64, 1) included. A thread holds a 4 x 4 block of int32
// sums and adds one __dp4a (four products) a word: exact, so the result
// equals the plain version bit for bit. The epilogue rounds once per
// multiply (__int2float_rn, __fmul_rn), in the reference's order.
//
// Tensor cores (int8_matmul_s8_sm90): a block of two warpgroups owns a
// 256 x 128 output tile, 128 rows each, as two 64-row halves of int32
// accumulators in registers (128 a thread; with no producer warp the
// block has eight warps, so a thread may hold 255 registers). Thread 0
// issues TMA loads (2-D maps, 128-byte boxes along K, 128-byte swizzle,
// zeros past M, N and K) of an x tile and a w tile a 128-deep step of K
// into a four-stage ring with full mbarriers; a stage is loaded again once
// the barrier at the end of its step has passed. wgmma m64n128k32
// .s32.s8.s8 sums exactly in int32. For 8-bit types wgmma takes both
// operands K-major only, with no transpose bit: x (M, K) is K-major, w
// (K, N) is N-major. So the block transposes each w tile in shared memory
// into a K-major, 128-byte-swizzled copy (4 x 4 byte blocks, __byte_perm;
// a lane mapping with conflict-free reads and two-way writes), a step
// ahead: while the tensor cores multiply step t, the threads transpose
// step t + 1 into the other of two copies, then a proxy fence and the
// barrier. The epilogue rounds as the dp4a kernel's. TMA needs 16-byte
// global strides, hence K % 16 == 0 and N % 16 == 0; any M.
// scripts/int8_tc_ablation.py times the kernel with parts taken out: at
// 4096 x 4096 x 12288 the loads alone bound it near 0.38 ms (the L2's
// rate), the products hide under them, and the transpose sits on the
// path from a step's load to the next and adds about 0.27 ms.
// Later work: a cheaper transpose first (a warp-specialized build, with
// a producer warpgroup of 128 threads transposing under setmaxnreg while
// the consumers multiplied, was slower: the transpose alone bounded it),
// then TMA multicast across a cluster to cut L2 reads, and a persistent
// grid with the epilogue under the next tile's loads.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;                 // output rows and columns a block
constexpr int kChunk = 64;                // K a stage (bytes)
constexpr int kWords = kChunk / 4;        // packed words a row of a stage
constexpr int kStride = kWords + 1;       // odd stride: conflict-free column reads
constexpr int kThreads = 256;             // 16 x 16, each a 4 x 4 output block

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (int)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
               ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24));
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   float* __restrict__ out, int m, int k, int n) {
  __shared__ int sx[kTile * kStride];  // [row][word]
  __shared__ int sw[kTile * kStride];  // [column][word]
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  int acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    __syncthreads();
    for (int i = tid; i < kTile * kWords; i += kThreads) {
      // x: word t of row r holds x[m0 + r, k0 + 4t .. 4t + 3]
      const int r = i / kWords, t = i % kWords;
      const int row = m0 + r, kk = k0 + 4 * t;
      int8_t e[4] = {0, 0, 0, 0};
      if (row < m)
        for (int u = 0; u < 4; ++u)
          if (kk + u < k) e[u] = x[(long long)row * k + kk + u];
      sx[r * kStride + t] = pack4(e[0], e[1], e[2], e[3]);
    }
    for (int i = tid; i < kTile * kWords; i += kThreads) {
      // w: word t of column c holds w[k0 + 4t .. 4t + 3, n0 + c]
      const int c = i % kTile, t = i / kTile;
      const int col = n0 + c, kk = k0 + 4 * t;
      int8_t e[4] = {0, 0, 0, 0};
      if (col < n)
        for (int u = 0; u < 4; ++u)
          if (kk + u < k) e[u] = w[(long long)(kk + u) * n + col];
      sw[c * kStride + t] = pack4(e[0], e[1], e[2], e[3]);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kWords; ++t) {
      int a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sx[(ty * 4 + i) * kStride + t];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = sw[(tx + 16 * j) * kStride + t];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], bw[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
    const float sxr = xs[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n)
        out[(long long)row * n + col] =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), sxr), ws[col]);
    }
  }
}


// ---------------------------------------------------------------------------
// the s8 tensor cores (int8_matmul_s8_sm90)
// ---------------------------------------------------------------------------

constexpr int kTcBM = 256;               // output rows a block: two warpgroups of 128
constexpr int kTcBN = 128;               // output columns a block
constexpr int kTcBK = 128;               // K bytes a step (one 128-byte swizzle row)
constexpr uint32_t kXBytes = kTcBM * kTcBK;  // one x tile
constexpr uint32_t kWBytes = kTcBK * kTcBN;  // one w tile, or its K-major copy
constexpr int kTcStages = 4;             // ring of x and w tiles
constexpr int kTcThreads = 256;          // two warpgroups; thread 0 also issues the loads

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed; a phase not done
// after 4 s (a load that never lands) traps, so the launch fails instead
// of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

// one box of a 2-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// byte offset of (row, byte col) in a tile of 128-byte rows under the
// 128-byte swizzle (the 16-byte chunk index XOR row % 8), as TMA lays it
__device__ __forceinline__ uint32_t sw128_offset(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

// keep the compiler from moving reads or writes of the accumulators
// across the asynchronous products
__device__ __forceinline__ void fence_acc(int (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_R8(i)                                                                          \
  "+r"(d[i + 0]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),         \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 128, int32) += a (64 x 32) . b (32 x 128), s8, both from shared
// memory, K-major
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40), WG_R8(48), WG_R8(56)
      : "l"(a), "l"(b), "r"(1));
}

// w tile (128 K rows x 128 N bytes, as TMA lands it) -> w^T (128 N rows x
// 128 K bytes), both under the 128-byte swizzle; `tid` is 0..255. A lane
// moves a 4 x 4 byte block per pass: the 16 lanes of a half-warp take 16
// neighbouring 4-column groups and the two halves two 4-row groups, so the
// reads cover 32 banks; the four output words are stored in an order
// rotated by the lane, so the writes reach 16 banks
__device__ __forceinline__ void transpose_w(const uint8_t* raw, uint8_t* wt, int tid) {
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int g = p * 8 + warp;
    const int nb = 16 * (g % 2) + lane % 16;  // columns 4nb .. 4nb + 3 (N)
    const int kb = 2 * (g / 2) + lane / 16;   // rows 4kb .. 4kb + 3 (K)
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(raw + sw128_offset(4 * kb + i, 4 * nb));
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
    // o[j] holds column 4nb + j, rows 4kb .. 4kb + 3
    const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = (s + (nb >> 1)) & 3;
      const uint32_t v = j == 0 ? o[0] : (j == 1 ? o[1] : (j == 2 ? o[2] : o[3]));
      *reinterpret_cast<uint32_t*>(wt + sw128_offset(4 * nb + j, 4 * kb)) = v;
    }
  }
}

// make this thread's plain shared-memory writes visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int tc_smem_bytes() {
  // the ring (x and w a stage), two K-major w copies, the barriers, 1024
  // bytes to align the base for the 128-byte swizzle
  return kTcStages * (kXBytes + kWBytes) + 2 * kWBytes + 8 * kTcStages + 1024;
}

// d[h] (rows 64h .. 64h + 63 of the warpgroup's 128) += x . w over one
// 128-byte step of K: four products of 32 bytes each
__device__ __forceinline__ void step_products(int (&d0)[64], int (&d1)[64], uint32_t s_x,
                                              uint32_t s_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = sw128_desc(s_b + kk * 32, 16, 1024);
    wgmma_s8(d0, sw128_desc(s_x + kk * 32, 16, 1024), b);
    wgmma_s8(d1, sw128_desc(s_x + 64 * 128 + kk * 32, 16, 1024), b);
  }
}

// out rows row0 and row0 + 8 of one 64-row half, 128 columns from col
__device__ __forceinline__ void store_half(const int (&acc)[64], const float* __restrict__ xs,
                                           const float* __restrict__ ws,
                                           float* __restrict__ out, int row0, int col, int m,
                                           int n) {
  const float s0 = row0 < m ? xs[row0] : 0.f, s1 = row0 + 8 < m ? xs[row0 + 8] : 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = col + 8 * i;
    if (c >= n) continue;  // n is a multiple of 16, so c + 1 < n too
    const float w0 = ws[c], w1 = ws[c + 1];
    if (row0 < m)
      *reinterpret_cast<float2*>(out + (long long)row0 * n + c) =
          make_float2(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i]), s0), w0),
                      __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 1]), s0), w1));
    if (row0 + 8 < m)
      *reinterpret_cast<float2*>(out + (long long)(row0 + 8) * n + c) =
          make_float2(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2]), s1), w0),
                      __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 3]), s1), w1));
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
int8_tc_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ xs, const float* __restrict__ ws,
               float* __restrict__ out, int m, int k, int n) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw_base);  // the same address, generic
  // stage st: x at st * (kXBytes + kWBytes), w after it; then the two
  // K-major copies of w, then the full barriers
  constexpr uint32_t kStage = kXBytes + kWBytes;
  const uint32_t s_wt = base + kTcStages * kStage;
  const uint32_t bar_full = s_wt + 2 * kWBytes;
  const int m0 = blockIdx.x * kTcBM, n0 = blockIdx.y * kTcBN;
  const int n_steps = (k + kTcBK - 1) / kTcBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;

  // thread 0 issues the loads of step t into stage t % kTcStages: the
  // first stages here, each later one once every thread has finished
  // with the step that held its stage (the barrier at the end of a step)
  auto load = [&](int t) {
    const int st = t % kTcStages;
    const uint32_t dst = base + st * kStage;
    fence_proxy_async();  // after the plain reads of the stage's last use
    mbar_expect_tx(bar_full + 8 * st, kStage);
    tma_load_2d(dst, &tm_x, bar_full + 8 * st, t * kTcBK, m0);
    tma_load_2d(dst + kXBytes, &tm_w, bar_full + 8 * st, n0, t * kTcBK);
  };
  if (tid == 0) {
    for (int st = 0; st < kTcStages; ++st) mbar_init(bar_full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(n_steps, kTcStages); ++t) load(t);
  }
  __syncthreads();

  // warpgroup wg owns output rows m0 + 128 wg .. + 127 as two halves of 64
  int acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;

  mbar_wait(bar_full, 0);
  transpose_w(gbase + kXBytes, gbase + (s_wt - base), tid);
  fence_proxy_async();
  __syncthreads();
  for (int t = 0; t < n_steps; ++t) {
    const int st = t % kTcStages;
    fence_acc(acc0);
    fence_acc(acc1);
    wgmma_fence();
    step_products(acc0, acc1, base + st * kStage + wg * 128 * 128,
                  s_wt + (t % 2) * kWBytes);
    wgmma_commit();
    if (t + 1 < n_steps) {  // transpose the next step's w while the products run
      const int nst = (t + 1) % kTcStages;
      mbar_wait(bar_full + 8 * nst, ((t + 1) / kTcStages) & 1);
      transpose_w(gbase + nst * kStage + kXBytes,
                  gbase + (s_wt - base) + ((t + 1) % 2) * kWBytes, tid);
      fence_proxy_async();
    }
    wgmma_wait_all();
    fence_acc(acc0);
    fence_acc(acc1);
    __syncthreads();  // stage st is free, the next K-major copy is complete
    if (tid == 0 && t + kTcStages < n_steps) load(t + kTcStages);
    __syncwarp();
  }

  // acc[4i + e] is (row0, column 8i + col + e), acc[4i + 2 + e] row0 + 8
  const int row0 = m0 + 128 * wg + 16 * (warp % 4) + lane / 4;
  const int col = n0 + 2 * (lane % 4);
  store_half(acc0, xs, ws, out, row0, col, m, n);
  store_half(acc1, xs, ws, out, row0 + 64, col, m, n);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a (rows, cols) row-major byte matrix as a 2-D map (cols, rows), boxes of
// 128 bytes x box_rows under the 128-byte swizzle; bytes past either edge
// read as 0
bool encode_bytes(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rows, int cols,
                  int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {kTcBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x: (m, k) int8, w: (k, n) int8, xs: (m,) float32, ws: (n,) float32,
// out: (m, n) float32, all contiguous. Requires m <= 65535 * 64.
// Returns cudaGetLastError().
extern "C" int int8_matmul_s8(const void* x, const void* w, const void* xs, const void* ws,
                              void* out, int m, int k, int n, void* stream) {
  if (m > 0 && n > 0) {
    const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
    int8_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int8_t*)w, (const float*)xs, (const float*)ws, (float*)out, m,
        k, n);
  }
  return (int)cudaGetLastError();
}

// The tensor-core route: x: (m, k) int8, w: (k, n) int8, xs: (m,) float32,
// ws: (n,) float32, out: (m, n) float32, all contiguous, x and w 16-byte
// aligned. Requires k >= 16, k % 16 == 0, n % 16 == 0 and n <= 65535 *
// 128. Returns cudaGetLastError() (or cudaErrorInvalidValue for arguments
// it refuses or a tensor map that cuTensorMapEncodeTiled refuses).
extern "C" int int8_matmul_s8_sm90(const void* x, const void* w, const void* xs, const void* ws,
                                   void* out, int m, int k, int n, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (k < 16 || k % 16 || n % 16 || (n + kTcBN - 1) / kTcBN > 65535)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tx, tw;
  if (!encode_bytes(fn, &tx, x, m, k, kTcBM) || !encode_bytes(fn, &tw, w, k, n, kTcBK))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = tc_smem_bytes();
  cudaError_t err =
      cudaFuncSetAttribute(int8_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + kTcBM - 1) / kTcBM, (n + kTcBN - 1) / kTcBN);
  int8_tc_kernel<<<grid, kTcThreads, bytes, (cudaStream_t)stream>>>(
      tx, tw, (const float*)xs, (const float*)ws, (float*)out, m, k, n);
  return (int)cudaGetLastError();
}
