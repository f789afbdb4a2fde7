// Flash attention (online softmax, GQA, optional causal mask) for Hopper
// (sm_90a): float32, and bf16 of other head dims, on the CUDA cores
// (flash_attention_f32, flash_attention_bf16); bf16 with D 64, 128 or 192
// on the tensor cores (flash_attention_bf16_sm90, below).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel): for q (B, Sq, Hq, D) and k, v
// (B, Skv, Hkv, D), query head h reads kv head h / (Hq / Hkv) in place;
// q is scaled by sm_scale = 1/sqrt(D) in float32, every product and the
// softmax are float32 (a running max m and sum l per row, rescaled by
// alpha = exp(m_prev - m_new)), causal masking sets s = -1e30 where the
// key's absolute position is past the query's, and the output is
// acc / max(l, 1e-30) in the input type (float32 or bf16).
//
// Bound: operations. Causal attention at the LM's prefill shape does
// 4*B*Hq*Sq*Skv*D/2 flops on 2*B*(Sq*Hq + Skv*Hkv)*D elements moved: far
// above the card's operations-per-byte line.
//
// Design: a block of 256 threads owns 64 query rows of one (batch, head)
// and walks 64-key tiles of its kv head. Q (scaled), K and V tiles are
// staged in shared memory as float32, the head dim zero-padded to DP (a
// multiple of 64, at most 256), so any D <= 256 and any ragged Sq, Skv
// work: keys past Skv get p = 0, rows past Sq are not stored. A thread
// holds a 4 x 4 block of the 64 x 64 score tile and 4 rows x DP/16
// columns of the output accumulator in registers; the score tile's row
// max and sum reduce across the 16 lanes that share its rows with
// shuffles; p goes through shared memory (over the K tile, which is no
// longer needed) for the second product. With a causal mask, key tiles
// wholly past the query tile's last row are skipped: in the Pallas
// kernel their p is exp(-1e30 - m) = 0 and alpha is 1, so skipping them
// is exact and halves the work. Query tiles are issued longest first.
// Products and exponentials are plain float32 FMAs and expf (no fast
// math); float32 stays off the tensor cores: TF32 would break its 2e-5
// contract.
//
// bf16 with D 64, 128 or 192 on the tensor cores: flash_attention_bf16_sm90
// (the rule is kernels/flash_attention.py:choose_route) replaces the same
// Pallas kernel and computes the same function, except that s = q . k is
// taken exactly from the bf16 inputs and scaled after the product (one
// float32 ulp from the Pallas order), and that sm_scale carries log2(e)
// so the exponentials are exp2f (no fast math).
// Bound: operations, 4*B*Hq*Sq*Skv*D/2 at 989 TFLOP/s of bf16 wgmma.
// Design: a block owns 128 query rows of one (batch, head): two consumer
// warpgroups of 64 rows and a producer. The producer's lane 0 issues TMA
// loads (4-D maps (D, H, S, B) encoded per call, boxes of 64 x rows under
// the 128-byte swizzle; a head of D is D/64 boxes) of Q once and of K and
// V tiles into a two-stage ring, with full and empty mbarriers. Each
// consumer computes s = Q K^T with wgmma m64nBKk16 (both operands from
// shared memory, K-major), the online softmax in registers (row max and
// sum over the four lanes of an accumulator row, shuffles), then acc +=
// P V with wgmma m64nDk16, P from registers and V from shared memory,
// N-major (the transpose bit). P is split into two bf16 halves, hi =
// bf16(p) and lo = bf16(p - hi), and multiplied by the same V tile
// twice: chip_smoke.py holds every bf16 output against the plain version
// on float32 inputs at rtol 2^-7, atol 1e-5, and one bf16 p (what SDPA
// and FA3 feed the second product) misses that for outputs near zero,
// where hi + lo keeps ~16 bits. It costs 1.5x the second product's
// tensor-core work. Keys past Skv (zeros from TMA) get s = -1e30; with a
// causal mask only tiles that reach past a warpgroup's first row are
// masked and tiles past its last row are skipped; rows past Sq are not
// stored; query tiles go longest first (the grid's slowest axis).
// Layout (TcLayout): at D 64 and 128 the producer is one warp, 288
// threads, so a block of nine warps puts three on one of the SM's four
// register files, which caps a thread at 168 registers; 64-key tiles take
// 159 at D 128 (128 at D 64), no spills. At D 192 (deepseek-v2-lite's MLA
// prefill: q/k heads of 128 + 64, v zero-padded to 192) the output
// accumulator alone is 96 floats a thread, beside s[32], p_hi[16] and
// p_lo[16]: some 190 registers by the D 128 count, past the cap. So there
// the producer is a whole warpgroup (384 threads; warps 8-11, warp 8's
// lane 0 loads) that lowers its registers to 24 with setmaxnreg.dec while
// the consumers raise theirs to 240 with setmaxnreg.inc, the two roles
// one branch's two arms: 128 * 24 + 256 * 240 = 64512 of the SM's
// 65536 registers, one producer and two consumer warps (504 registers a
// lane) on each register file. Shared memory at D 192: Q 128 x 192 x 2 B
// = 48 KB and two stages of K + V, 2 x 64 x 192 x 2 B = 48 KB each, 145
// KB in all (one block an SM; 128-key tiles would need 240 KB). Its bound
// at deepseek's prefill (2, 4096, 16, 192) causal is 0.2085 ms: s = q k
// is 2 * 192 flops a (row, key) and p_hi v + p_lo v 2 * 2 * 192, counted
// as the function's 4 * 192 (the split's extra third is the design's).
// Tile: BK = 64 keys (FLASH_TC_BK); FLASH_TC_STAGES and FLASH_TC_WG_FROM_D
// (the least D with a producer warpgroup) are build switches for
// scripts/flash_tile_sweep.py, which builds and times the variants (PERF.md
// §6): D 128 on the producer-warpgroup layout is 13% slower with 64-key
// tiles and no faster with 128 (where it still spills), and a third stage
// gains about 1% at D 192, so the defaults stay.
// With a non-null lse pointer (the training forward, whose gradient is
// csrc/flash_attention_bwd_sm90.cu) the epilogue also writes each row's
// log-sum-exp m + log2(l), float32 in log2 units; with null (inference)
// nothing more is written. The TMA, mbarrier and wgmma helpers are in
// sm90.cuh, shared with that backward.
// Later work: ping-pong between the two consumer warpgroups, a persistent
// grid, and the GQA heads of one kv head packed in a block.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 4 keys / DP/16 columns
constexpr int kPS = kBK + 4;   // row stride of the p tile (floats)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int DP>
constexpr int smem_bytes() {
  // Q and K tiles with a row stride of DP + 4 floats (conflict-free
  // float4 reads of 8 rows at once), the V tile with stride DP
  return (kBQ * (DP + 4) + kBK * (DP + 4) + kBK * DP) * 4;
}

// 16 lanes that share a row of the score tile (half a warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DP, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int sq, int skv, int hq, int hkv, int d, int causal,
             float sm_scale) {
  constexpr int QS = DP + 4;
  constexpr int NC = DP / 64;  // float4 column chunks of the output a thread owns
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sP = sK;  // the p tile reuses the K tile's space

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long q_row = (long long)hq * d;   // stride between positions
  const long long kv_row = (long long)hkv * d;
  const T* qb = q + (long long)b * sq * q_row + (long long)h * d;
  const T* kb = k + (long long)b * skv * kv_row + (long long)hk * d;
  const T* vb = v + (long long)b * skv * kv_row + (long long)hk * d;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (q0 + r < sq && c < d) x = to_f32(qb[(q0 + r) * q_row + c]) * sm_scale;
    sQ[r * QS + c] = x;
  }

  float acc[4][4 * NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  // with the causal mask, keys at or past q0 + kBQ are masked for every row
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's p and V are consumed
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < skv && c < d) {
        const long long off = (k0 + r) * kv_row + c;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      sK[r * QS + c] = kx;
      sV[r * DP + c] = vx;
    }
    __syncthreads();

    // s = (q * sm_scale) . k for rows ty*4 + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty * 4 + i) * QS + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * QS + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax: mask, new max, p (into s), rescale
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (causal && kpos > qpos) s[i][j] = kNegInf;
        if (kpos < skv) mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float alpha = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = kpos < skv ? expf(s[i][j] - mx) : 0.f;
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * kPS + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc += p . v for rows ty*4 + i, columns cc*64 + tx*4 + (0..3)
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sP[(ty * 4 + i) * kPS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&sV[(j + jj) * DP + cc * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
            acc[i][cc * 4 + 0] = fmaf(p, vv.x, acc[i][cc * 4 + 0]);
            acc[i][cc * 4 + 1] = fmaf(p, vv.y, acc[i][cc * 4 + 1]);
            acc[i][cc * 4 + 2] = fmaf(p, vv.z, acc[i][cc * 4 + 2]);
            acc[i][cc * 4 + 3] = fmaf(p, vv.w, acc[i][cc * 4 + 3]);
          }
        }
      }
    }
  }

  T* ob = o + (long long)b * sq * q_row + (long long)h * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = cc * 64 + tx * 4 + e;
        if (c < d) ob[r * q_row + c] = from_f32<T>(acc[i][cc * 4 + e] / denom);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv,
           int hq, int hkv, int d, int causal, float sm_scale, cudaStream_t stream) {
  // two blocks an SM where the registers allow it (DP <= 128)
  constexpr int kMinBlocks = DP <= 128 ? 2 : 1;
  auto kernel = flash_kernel<T, DP, kMinBlocks>;
  constexpr int bytes = smem_bytes<DP>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, bytes, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, sq,
                                            skv, hq, hkv, d, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv,
             int hq, int hkv, int d, int causal, float sm_scale, void* stream) {
  if (b <= 0 || sq <= 0) return (int)cudaGetLastError();
  if (skv <= 0 || d <= 0 || d > 256 || hkv <= 0 || hq % hkv != 0 || hq > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 64) return launch<T, 64>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, sm_scale, s);
  if (d <= 128) return launch<T, 128>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, sm_scale, s);
  if (d <= 192) return launch<T, 192>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, sm_scale, s);
  return launch<T, 256>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, sm_scale, s);
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores (flash_attention_bf16_sm90)
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 128;             // query rows a block: two consumer warpgroups of 64
#ifndef FLASH_TC_STAGES
#define FLASH_TC_STAGES 2
#endif
constexpr int kTcStages = FLASH_TC_STAGES;  // ring of K and V tiles
#ifndef FLASH_TC_BK
#define FLASH_TC_BK 64
#endif
constexpr int kTcBK = FLASH_TC_BK;     // keys a tile (see the note at the top)
#ifndef FLASH_TC_WG_FROM_D
#define FLASH_TC_WG_FROM_D 192
#endif
constexpr float kLog2e = 1.4426950408889634f;

// The block's layout by head dim (the note at the top): warps 0-7 consume
// (wgmma), warp 8 loads (TMA), alone below FLASH_TC_WG_FROM_D; from it
// warps 8-11 are a producer warpgroup and setmaxnreg moves registers
// from the producer to the consumers
template <int D>
struct TcLayout {
  static constexpr bool kWarpgroupProducer = D >= FLASH_TC_WG_FROM_D;
  static constexpr int kThreads = kWarpgroupProducer ? 384 : 288;
};
constexpr int kTcProducerRegs = 24, kTcConsumerRegs = 240;

template <int D, int BK>
constexpr int tc_smem_bytes() {
  // Q, then per stage K and V, each D/64 boxes of rows x 128 bytes; the
  // barriers; 1024 bytes to align the base for the 128-byte swizzle
  return (kTcBQ + 2 * kTcStages * BK) * D * 2 + 8 * (1 + 2 * kTcStages) + 1024;
}

template <int D, int BK>
__global__ void __launch_bounds__(TcLayout<D>::kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int sq, int skv, int hq, int hkv, int causal,
                int lse_stride, float scale_log2) {
  using L = TcLayout<D>;
  constexpr int DB = D / 64;                      // 64-wide boxes of the head dim
  constexpr uint32_t kQBox = kTcBQ * 128;         // bytes of one Q box
  constexpr uint32_t kKVBox = BK * 128;           // bytes of one K or V box
  constexpr uint32_t kQBytes = DB * kQBox, kKVBytes = DB * kKVBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_kv = base + kQBytes;           // stage st: K at st * 2 * kKVBytes, V after
  const uint32_t bar_q = s_kv + kTcStages * 2 * kKVBytes;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * kTcStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBQ;  // longest causal rows first
  const int hk = h / (hq / hkv);
  const int kv_end = causal ? min(skv, q0 + kTcBQ) : skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the two roles are the two arms of one branch that never meet again, so
  // ptxas knows each arm's register count after its setmaxnreg
  if (warp >= 8) {  // producer: one lane issues every load
    if constexpr (L::kWarpgroupProducer) setmaxnreg_dec<kTcProducerRegs>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(bar_q, kQBytes);
      for (int db = 0; db < DB; ++db) tma_load(s_q + db * kQBox, &tm_q, bar_q, db * 64, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kTcStages;
        if (t >= kTcStages) mbar_wait(bar_empty + 8 * st, (t / kTcStages - 1) & 1);
        const uint32_t k_dst = s_kv + st * 2 * kKVBytes, v_dst = k_dst + kKVBytes;
        mbar_expect_tx(bar_full + 8 * st, 2 * kKVBytes);
        for (int db = 0; db < DB; ++db) {
          tma_load(k_dst + db * kKVBox, &tm_k, bar_full + 8 * st, db * 64, hk, t * BK, b);
          tma_load(v_dst + db * kKVBox, &tm_v, bar_full + 8 * st, db * 64, hk, t * BK, b);
        }
      }
    }
  } else {
    if constexpr (L::kWarpgroupProducer) setmaxnreg_inc<kTcConsumerRegs>();
    // consumer warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread
    // holds rows row0 and row0 + 8 of every accumulator
    const int wg = warp / 4;
    const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
    const int col = 2 * (lane % 4);  // first of this thread's two columns in each 8
    const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // m in log2 units

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kTcStages, k0 = t * BK;
      const uint32_t s_k = s_kv + st * 2 * kKVBytes, s_v = s_k + kKVBytes;
      mbar_wait(bar_full + 8 * st, (t / kTcStages) & 1);
      if (causal && k0 > wg_last) {  // every key of the tile is masked for these rows
        mbar_arrive(bar_empty + 8 * st);
        continue;
      }

      // s = q . k^T: D/16 steps of 16 along the head dim
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 bf16 along the 128-byte row
        Wgmma<BK>::ss(s, sw128_desc(s_q + (kk / 4) * kQBox + wg * 64 * 128 + off, 16, 1024),
                      sw128_desc(s_k + (kk / 4) * kKVBox + off, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale (log2 units), mask, online softmax. s[4i + e] is (row0, key
      // k0 + 8i + col + e), s[4i + 2 + e] is (row0 + 8, same key)
      const bool mask = k0 + BK > skv || (causal && k0 + BK - 1 > wg_first);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s[4 * i + e] * scale_log2, x1 = s[4 * i + 2 + e] * scale_log2;
          if (mask) {
            const int key = k0 + 8 * i + col + e;
            if (key >= skv || (causal && key > row0)) x0 = kNegInf;
            if (key >= skv || (causal && key > row0 + 8)) x1 = kNegInf;
          }
          s[4 * i + e] = x0;
          s[4 * i + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * i + e] = exp2f(s[4 * i + e] - mx0);
          s[4 * i + 2 + e] = exp2f(s[4 * i + 2 + e] - mx1);
          rs0 += s[4 * i + e];
          rs1 += s[4 * i + 2 + e];
        }
      l0 = l0 * alpha0 + quad_sum(rs0);
      l1 = l1 * alpha1 + quad_sum(rs1);
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i + 0] *= alpha0;
        acc[4 * i + 1] *= alpha0;
        acc[4 * i + 2] *= alpha1;
        acc[4 * i + 3] *= alpha1;
      }

      // p as two bf16 halves, hi = bf16(p) and lo = bf16(p - hi), in the
      // A-operand layout: for keys 16j..16j+15, registers 4j..4j+3 hold
      // (row0, 2 keys), (row0 + 8, 2 keys), then the same 8 keys on
      uint32_t p_hi[BK / 4], p_lo[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        const float a = s[2 * i], c = s[2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[i] = bf16x2_bits(hi);
        p_lo[i] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
      }

      // acc += p_hi . v + p_lo . v: BK/16 steps of 16 keys; V is (keys x D),
      // D contiguous, so N-major (transposed), its D boxes BK * 128 bytes apart
      fence_regs(p_hi);
      fence_regs(p_lo);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint64_t dv = sw128_desc(s_v + j * 16 * 128, kKVBox, 1024);
        Wgmma<D>::rs(acc, p_hi[4 * j], p_hi[4 * j + 1], p_hi[4 * j + 2], p_hi[4 * j + 3], dv);
        Wgmma<D>::rs(acc, p_lo[4 * j], p_lo[4 * j + 1], p_lo[4 * j + 2], p_lo[4 * j + 3], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(bar_empty + 8 * st);
    }

    // acc[4i + e] is (row0, column 8i + col + e), acc[4i + 2 + e] row0 + 8
    const long long row_stride = (long long)hq * D;
    __nv_bfloat16* ob = o + (long long)b * sq * row_stride + (long long)h * D;
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      if (row0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * row_stride + 8 * i + col) =
            __floats2bfloat162_rn(acc[4 * i] / den0, acc[4 * i + 1] / den0);
      if (row0 + 8 < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * row_stride + 8 * i + col) =
            __floats2bfloat162_rn(acc[4 * i + 2] / den1, acc[4 * i + 3] / den1);
    }
    // the log-sum-exp of each row in log2 units, for the backward (the
    // four lanes of a row hold the same m and l; one writes)
    if (lse != nullptr && lane % 4 == 0) {
      float* lb = lse + ((long long)b * hq + h) * lse_stride;
      if (row0 < sq) lb[row0] = m0 + log2f(l0);
      if (row0 + 8 < sq) lb[row0 + 8] = m1 + log2f(l1);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, void* lse, int b, int sq,
              int skv, int hq, int hkv, int causal, int lse_stride, float sm_scale,
              cudaStream_t stream) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(fn, &tq, q, b, sq, hq, D, kTcBQ) ||
      !encode_bshd(fn, &tk, k, b, skv, hkv, D, kTcBK) ||
      !encode_bshd(fn, &tv, v, b, skv, hkv, D, kTcBK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_tc_kernel<D, kTcBK>;
  constexpr int bytes = tc_smem_bytes<D, kTcBK>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, b, (sq + kTcBQ - 1) / kTcBQ);
  kernel<<<grid, TcLayout<D>::kThreads, bytes, stream>>>(tq, tk, tv, (__nv_bfloat16*)o,
                                                         (float*)lse, sq, skv, hq, hkv, causal,
                                                         lse_stride, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (b, sq, hq, d), k and v: (b, skv, hkv, d), o: (b, sq, hq, d), all
// contiguous, of one type (float32 or bf16). Requires d <= 256,
// hq % hkv == 0, skv >= 1. Returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it refuses).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int b,
                                   int sq, int skv, int hq, int hkv, int d, int causal,
                                   float sm_scale, void* stream) {
  return dispatch<float>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, sm_scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int b,
                                    int sq, int skv, int hq, int hkv, int d, int causal,
                                    float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, sm_scale, stream);
}

// The tensor-core route: q: (b, sq, hq, d), k and v: (b, skv, hkv, d), o:
// (b, sq, hq, d), contiguous bf16 with 16-byte aligned data, d 64, 128 or
// 192, hq % hkv == 0, skv >= 1. lse: null, or float32 (b, hq, lse_stride)
// with lse_stride >= sq, where each row's log-sum-exp of s * sm_scale in
// log2 units (m + log2(l)) is written for the backward
// (flash_attention_bwd_sm90.cu); rows past sq are not written. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses
// or a tensor map that cuTensorMapEncodeTiled refuses).
extern "C" int flash_attention_bf16_sm90(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int b, int sq, int skv, int hq, int hkv,
                                         int d, int causal, int lse_stride, float sm_scale,
                                         void* stream) {
  if (b <= 0 || sq <= 0) return (int)cudaGetLastError();
  if (skv <= 0 || (d != 64 && d != 128 && d != 192) || hkv <= 0 || hq % hkv != 0 || b > 65535 ||
      (sq + kTcBQ - 1) / kTcBQ > 65535 || (lse != nullptr && lse_stride < sq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch_tc<64>(q, k, v, o, lse, b, sq, skv, hq, hkv, causal, lse_stride, sm_scale, s);
  if (d == 128)
    return launch_tc<128>(q, k, v, o, lse, b, sq, skv, hq, hkv, causal, lse_stride, sm_scale, s);
  return launch_tc<192>(q, k, v, o, lse, b, sq, skv, hq, hkv, causal, lse_stride, sm_scale, s);
}
