// The gradient of GQA attention, with an optional causal mask, in bf16 on
// Hopper's tensor cores (sm_90a): FlashAttention-2/3's backward on wgmma
// and TMA, with no atomics, in three entries (flash_attention_bwd_{prep,
// dkdv,dq}_bf16_sm90) for D 64, 80 and 128, and three more at D 192
// (flash_attention_bwd_{prep,dkdv,dq}_bf16_d192_sm90: deepseek-v2-lite's
// MLA, q/k heads of 128 + 64 and v zero-padded to 192).
//
// Replaces no TPU kernel: the reference has no backward kernel (XLA
// differentiates repro/kernels/ref.py:attention on the CPU). It is the
// tensor-core route of flash_attention's gradient (the rule is
// kernels/flash_attention.py:choose_bwd_route); float32 and bf16 of other
// head dims keep the CUDA-core entries of csrc/flash_attention_bwd.cu.
//
// For q, o, dO (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D) contiguous bf16,
// Hq % Hkv == 0 (query head hh reads kv head hh / (Hq / Hkv)), with s =
// q . k (products of bf16 are exact, float32 sums), lse each query row's
// log-sum-exp of s * sm_scale in log2 units over its unmasked keys, written
// by the forward (flash_attention_bf16_sm90's lse output, float32 (B, Hq,
// stride), with the same causal flag):
//   P = exp2(s * sm_scale * log2(e) - lse),  Delta = rowsum(dO * O),
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),
//   dK = sm_scale * dS^T q,  dQ = sm_scale * dS K.
// With the causal mask (top-left, as the forward's: key > query index is
// masked), P = dS = 0 at the masked entries. P and dS enter their products
// as one bf16 each (as FA3's do); every sum is float32; dq, dk, dv are
// rounded once to bf16. Each output element is one thread's accumulator
// after a loop in a fixed order, with no atomics, so two calls give the
// same bits.
//
// Entries (one launch each, in this order):
// - prep: Delta alone, float32 (B, H, stride), 0 past Sq: 8 lanes a
//   (b, s, h) row, 16-byte loads of O and dO. Bound: bytes (O and dO read
//   once).
// - dkdv: a block (one warpgroup) owns kBwdRows keys of one (b, kv head), K
//   and V loaded once by TMA, and walks the kBwdTile-query tiles of Q and dO
//   of each of its kv head's Hq / Hkv query heads in turn (head by head, a
//   head's tiles in order), with their lse and Delta rows (bulk copies), all
//   through one ring of kBwdStages, so dK and dV hold every query head's
//   share before one store (no atomics, no float32 scratch of Hq heads):
//   S^T = K Q^T and dP^T = V dO^T (wgmma, both operands from shared
//   memory, K-major), P^T and dS^T in registers, then dV += P^T dO and dK
//   += dS^T Q with P^T and dS^T from registers and dO and Q from shared
//   memory, N-major (the transpose bit, as the forward feeds V). dK is
//   scaled once at the end. Causal: the query tiles that end before the
//   block's first key are skipped (each head's walk starts at the tile that
//   holds that key); the tile on the diagonal masks key > query.
// - dq: a block owns kBwdRows query rows of one query head, Q and dO loaded
//   once, and walks kBwdTile-key tiles of K and V of its kv head: S, dP, dS
//   as in dkdv, then dQ += dS K, scaled once at the end. Causal: the key
//   tiles past the block's last row are skipped; the diagonal tile masks.
// The mask is a template parameter (kCausal): the non-causal kernels carry
// none of its index arithmetic in their loops, where at D 64 a tile's four
// products take only ~500 cycles (a runtime flag and a modulo a tile cost
// the UNet's level 0 1.9x in dkdv).
// Grids: without the mask every block does the same work, and the grid is
// (tiles, heads, B), a head's blocks adjacent, so they run together and
// read its Q and dO (dkdv) or K and V (dq) tiles from L2 (with the heads
// fastest, ViT-L/16's dkdv took 0.603 ms against 0.366). Causal blocks do
// uneven work, so the longest go first, as in the forward: the grid is
// (heads, B, tiles), the tile index slowest; dkdv's block z owns the keys
// from 64 z (the first keys see the most queries), dq's the query rows
// from 64 (gridDim.z - 1 - z) (the last rows see the most keys).
// Queries past Sq (dkdv) and keys past Skv (dq) get P = dS = 0 by an
// explicit mask (lse past Sq is not written); rows past Sq or Skv are not
// stored. D 80 (ViT-H/14) is read in place: the TMA maps have the true D,
// a head is two 64-column boxes whose columns past 80 arrive as zeros, the
// products over D take 5 k16 steps, the products into dK, dV and dQ run
// at n80, and 80 columns are stored; there is no padding copy.
//
// Products: dkdv runs 4 (S^T, dP^T, dV, dK) and dq 3 (S, dP, dQ), each 2
// B H Sq Skv D flops: 7 where the gradient needs 5, the price of
// determinism without atomics (dQ summed across key blocks would need
// them). Bound: operations at the gradient's 5 products on the bf16
// tensor cores (989 TFLOP/s) at every shape phase 15 runs but the UNet's
// cross-attention and small tiles, where the bytes of q, k, v, o, dO in and
// dq, dk, dv out bound it.
//
// Layout: a block is one warpgroup of 128 threads; thread 0 issues every
// copy (the first kBwdStages tiles up front, then each stage again after
// the block's __syncthreads at the end of the tile that read it), so the
// next tile's loads overlap this tile's products. At D 128 a dkdv thread
// holds dK and dV (128 floats) beside S^T and dP^T (64): 223 registers,
// which a block of 9 to 12 warps caps at 168 (three warps on one of the
// SM's four register files). The FA3 layout, two consumer warpgroups that
// raise their registers to 240 with setmaxnreg while a producer lowers
// its own, spilled at D 80 and 128 and had its wgmma serialized: this
// nvcc allocates the whole kernel within the launch's 168. So a block has 4 warps and an SM runs min_blocks of them:
// 2 at D 80 and 128 (up to 255 registers a thread), 3 at D 64 (168).
// Shared memory at D 128 (and 80): K and V 2 x 64 x 256 B, two stages of
// Q and dO 2 x 2 x 64 x 256 B, 97 KB a block (dq: Q and dO, stages of K
// and V, the same).
//
// D 192: dK and dV would take 192 floats a thread beside S^T and dP^T (64),
// past the 255 registers a thread can hold. So dkdv runs a block of two
// warpgroups on one ring of Q / dO tiles (bwd_dkdv_wg2_tc_kernel), each
// owning one accumulator of 96 floats and two of the tile's four products:
// warpgroup 0 S^T = K Q^T, P^T (which it also writes to shared memory as
// float32, 16 KB), dV += P^T dO; warpgroup 1 dP^T = V dO^T, then, after a
// named barrier, dS^T = P^T * (dP^T - Delta) from that P^T, dK += dS^T Q.
// No product is run twice and the arithmetic is the one-warpgroup kernel's.
// dq keeps its one-warpgroup layout (dQ 96 floats beside S and dP). Shared
// memory: K, V 2 x 64 x 384 B, two stages of Q and dO 2 x 2 x 64 x 384 B,
// 146 KB (dkdv 162 KB with P^T), so one block an SM (255 registers a
// thread). v's 64 zero columns are read and multiplied like the others.
// Later work: the softmax of one tile under the next tile's products, a
// persistent grid, 128-row blocks at D 64; at D 192, v at its true 128
// columns in dP and dV, two warpgroups in dq.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kBwdRows = 64;       // keys a dkdv block, query rows a dq block
constexpr int kBwdTile = 64;       // queries a dkdv tile, keys a dq tile
constexpr int kBwdStages = 2;      // ring of tiles
constexpr int kBwdThreads = 128;   // one warpgroup
constexpr int kDeltaThreads = 256; // prep: 8 lanes a row, 32 rows a block
constexpr float kLog2e = 1.4426950408889634f;

// 64-column boxes of a head of D in shared memory (D 80 takes two)
template <int D>
__host__ __device__ constexpr int boxes() { return (D + 63) / 64; }

// blocks an SM: 3 at D 64 (a thread's registers capped at 168, enough for
// dK, dV, S^T and dP^T at D 64), 2 at D 80 and 128 (capped at 255: at D 128
// they take 192 floats), which the shared memory also allows; 1 at D 192,
// whose tiles leave room for one block
template <int D>
__host__ __device__ constexpr int min_blocks() { return D <= 64 ? 3 : D <= 128 ? 2 : 1; }

template <int D>
constexpr int bwd_smem() {
  // the block's rows of two tensors (dkdv: K, V; dq: Q, dO), per stage a
  // tile of two tensors (dkdv: Q, dO; dq: K, V), per stage lse and Delta of
  // the tile (dkdv), the barriers, 1024 bytes to align the base for the
  // 128-byte swizzle
  return 2 * boxes<D>() * kBwdRows * 128 + kBwdStages * 2 * boxes<D>() * kBwdTile * 128 +
         kBwdStages * 2 * kBwdTile * 4 + 8 * (1 + kBwdStages) + 1024;
}

// dkdv_wg2: the same and P^T of a tile, 32 floats a thread of warpgroup 0
template <int D>
constexpr int bwd_wg2_smem() {
  return bwd_smem<D>() + kBwdRows * kBwdTile * 4;
}

// named barrier 1 over both warpgroups of a dkdv_wg2 block: warpgroup 0
// arrives once its P^T is in shared memory, warpgroup 1 waits for it
static_assert(2 * kBwdThreads == 256, "the named barrier counts two warpgroups");
__device__ __forceinline__ void p_ready_arrive() {
  asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void p_ready_wait() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ float dot_bf16x8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 xf = __bfloat1622float2(x[j]), yf = __bfloat1622float2(y[j]);
    acc = fmaf(xf.x, yf.x, acc);
    acc = fmaf(xf.y, yf.y, acc);
  }
  return acc;
}

// delta[r] for r = (b * h + hh) * stride + s: rowsum(dO * O) of row (b, s,
// hh), 0 for s in [sq, stride); n = b * h * stride
__global__ void __launch_bounds__(kDeltaThreads)
bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 float* __restrict__ delta, int sq, int h, int d, int stride, long long n) {
  const long long r = (long long)blockIdx.x * (kDeltaThreads / 8) + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  float acc = 0.f;
  if (r < n) {
    const long long bh = r / stride;
    const int s = (int)(r - bh * stride);
    if (s < sq) {
      const long long b = bh / h, hh = bh - b * h;
      const long long off = ((b * sq + s) * h + hh) * d;
      const uint4* o4 = reinterpret_cast<const uint4*>(o + off);
      const uint4* d4 = reinterpret_cast<const uint4*>(dout + off);
      for (int c = part; c < d / 8; c += 8) acc = dot_bf16x8(d4[c], o4[c], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (part == 0 && r < n) delta[r] = acc;
}

// pairs of an accumulator as bf16x2: the A-operand layout of the next
// product (as the forward's p)
__device__ __forceinline__ void to_bf16_operand(const float (&x)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = bf16x2_bits(__floats2bfloat162_rn(x[2 * i], x[2 * i + 1]));
}

// dK and dV of kBwdRows keys: a loop over every query tile of each of the
// kv head's query heads
template <int D, bool kCausal>
__global__ void __launch_bounds__(kBwdThreads, min_blocks<D>())
bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq, int skv,
                   int hq, int hkv, int stride, float sm_scale, float scale_log2) {
  constexpr uint32_t kBox = kBwdRows * 128;          // bytes of a 64-row box
  constexpr uint32_t kBytes = boxes<D>() * kBox;     // of a 64-row tile of one tensor
  constexpr uint32_t kRowBytes = kBwdTile * 4;       // of a tile's lse (or Delta)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base, s_v = s_k + kBytes;
  const uint32_t s_ring = s_v + kBytes;                      // stage st: Q, then dO
  const uint32_t s_rows = s_ring + kBwdStages * 2 * kBytes;  // stage st: lse, then Delta
  const uint32_t bar_kv = s_rows + kBwdStages * 2 * kRowBytes, bar_full = bar_kv + 8;
  const float* rows = reinterpret_cast<const float*>(smem_raw + (s_rows - raw));

  const int hk = kCausal ? blockIdx.x : blockIdx.y, b = kCausal ? blockIdx.y : blockIdx.z;
  const int k0 = (kCausal ? blockIdx.z : blockIdx.x) * kBwdRows;
  const int n_tiles = (sq + kBwdTile - 1) / kBwdTile;
  const int rep = hq / hkv;
  // causal: the first query tile that reaches key k0 (none past sq)
  const int t_first = kCausal ? min(k0 / kBwdTile, n_tiles) : 0;
  const int per_head = n_tiles - t_first, n_items = rep * per_head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // thread 0 fills stage it % kBwdStages with item it: query tile t_first +
  // it % per_head of query head hk * rep + it / per_head
  auto load_tile = [&](int it) {
    const int st = it % kBwdStages, j = it / per_head;
    const int hh = hk * rep + j, q0 = (t_first + it - j * per_head) * kBwdTile;
    const long long row_off = ((long long)b * hq + hh) * stride;  // of lse and Delta
    const uint32_t q_dst = s_ring + st * 2 * kBytes, r_dst = s_rows + st * 2 * kRowBytes;
    const uint32_t full = bar_full + 8 * st;
    mbar_expect_tx(full, 2 * kBytes + 2 * kRowBytes);
    for (int db = 0; db < boxes<D>(); ++db) {
      tma_load(q_dst + db * kBox, &tm_q, full, db * 64, hh, q0, b);
      tma_load(q_dst + kBytes + db * kBox, &tm_do, full, db * 64, hh, q0, b);
    }
    bulk_load(r_dst, lse + row_off + q0, kRowBytes, full);
    bulk_load(r_dst + kRowBytes, delta + row_off + q0, kRowBytes, full);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kBwdStages; ++st) mbar_init(bar_full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * kBytes);
    for (int db = 0; db < boxes<D>(); ++db) {
      tma_load(s_k + db * kBox, &tm_k, bar_kv, db * 64, hk, k0, b);
      tma_load(s_v + db * kBox, &tm_v, bar_kv, db * 64, hk, k0, b);
    }
    for (int it = 0; it < kBwdStages && it < n_items; ++it) load_tile(it);
  }
  __syncthreads();

  // this thread holds keys key0 and key0 + 8 of every accumulator
  const int key0 = k0 + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);  // first of this thread's two columns in each 8
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(bar_kv, 0);
  int t = t_first;  // item it's query tile
  for (int it = 0; it < n_items; ++it) {
    const int st = it % kBwdStages, q0 = t * kBwdTile;
    t = t + 1 == n_tiles ? t_first : t + 1;  // the next query head's walk starts again
    const uint32_t s_q = s_ring + st * 2 * kBytes, s_do = s_q + kBytes;
    const float* lse_t = rows + st * 2 * kBwdTile;
    const float* delta_t = lse_t + kBwdTile;
    mbar_wait(bar_full + 8 * st, (it / kBwdStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: D/16 steps of 16 along the head dim
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      Wgmma<64>::ss(s, sw128_desc(s_k + off, 16, 1024), sw128_desc(s_q + off, 16, 1024));
      Wgmma<64>::ss(dp, sw128_desc(s_v + off, 16, 1024), sw128_desc(s_do + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in place: s[4i + e] is (key0, query q0 + 8i + col + e),
    // s[4i + 2 + e] (key0 + 8, the same query); 0 for queries past sq and,
    // on the diagonal tile, for key > query
    const bool mask = q0 + kBwdTile > sq;
    const bool diag = kCausal && q0 < k0 + kBwdRows;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * i + col);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + 8 * i + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float li = e ? l2.y : l2.x, di = e ? d2.y : d2.x;
        const int qi = q0 + 8 * i + col + e;
        bool out0 = mask && qi >= sq, out1 = out0;
        if constexpr (kCausal) {
          out0 = out0 || (diag && key0 > qi);
          out1 = out1 || (diag && key0 + 8 > qi);
        }
        const float p0 = out0 ? 0.f : exp2f(s[4 * i + e] * scale_log2 - li);
        const float p1 = out1 ? 0.f : exp2f(s[4 * i + 2 + e] * scale_log2 - li);
        dp[4 * i + e] = out0 ? 0.f : p0 * (dp[4 * i + e] - di);
        dp[4 * i + 2 + e] = out1 ? 0.f : p1 * (dp[4 * i + 2 + e] - di);
        s[4 * i + e] = p0;
        s[4 * i + 2 + e] = p1;
      }
    }
    uint32_t pa[16], dsa[16];
    to_bf16_operand(s, pa);
    to_bf16_operand(dp, dsa);

    // dV += P^T dO and dK += dS^T Q: 4 steps of 16 queries; dO and Q are
    // (queries x D), D contiguous, so N-major (transposed), their D boxes
    // kBox bytes apart
    fence_regs(pa);
    fence_regs(dsa);
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBwdTile / 16; ++j) {
      Wgmma<D>::rs(dva, pa[4 * j], pa[4 * j + 1], pa[4 * j + 2], pa[4 * j + 3],
                   sw128_desc(s_do + j * 16 * 128, kBox, 1024));
      Wgmma<D>::rs(dka, dsa[4 * j], dsa[4 * j + 1], dsa[4 * j + 2], dsa[4 * j + 3],
                   sw128_desc(s_q + j * 16 * 128, kBox, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    __syncthreads();  // every thread is done with the stage: refill it
    if (threadIdx.x == 0 && it + kBwdStages < n_items) load_tile(it + kBwdStages);
  }

  // dka[4i + e] is (key0, column 8i + col + e), dka[4i + 2 + e] key0 + 8
  const long long row_stride = (long long)hkv * D;
  const long long off = (long long)b * skv * row_stride + (long long)hk * D;
  __nv_bfloat16* dkb = dk + off;
  __nv_bfloat16* dvb = dv + off;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (key0 < skv) {
      const long long at = key0 * row_stride + 8 * i + col;
      *reinterpret_cast<__nv_bfloat162*>(dkb + at) =
          __floats2bfloat162_rn(dka[4 * i] * sm_scale, dka[4 * i + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + at) = __floats2bfloat162_rn(dva[4 * i], dva[4 * i + 1]);
    }
    if (key0 + 8 < skv) {
      const long long at = (key0 + 8) * row_stride + 8 * i + col;
      *reinterpret_cast<__nv_bfloat162*>(dkb + at) =
          __floats2bfloat162_rn(dka[4 * i + 2] * sm_scale, dka[4 * i + 3] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + at) =
          __floats2bfloat162_rn(dva[4 * i + 2], dva[4 * i + 3]);
    }
  }
}

// dK and dV of kBwdRows keys where a thread cannot hold both (D 192): two
// warpgroups, warpgroup 0 dV and warpgroup 1 dK, on one ring of the kv
// head's query tiles walked as bwd_dkdv_tc_kernel walks them
template <int D, bool kCausal>
__global__ void __launch_bounds__(2 * kBwdThreads, 1)
bwd_dkdv_wg2_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq,
                       int skv, int hq, int hkv, int stride, float sm_scale, float scale_log2) {
  constexpr uint32_t kBox = kBwdRows * 128;          // bytes of a 64-row box
  constexpr uint32_t kBytes = boxes<D>() * kBox;     // of a 64-row tile of one tensor
  constexpr uint32_t kRowBytes = kBwdTile * 4;       // of a tile's lse (or Delta)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t s_k = base, s_v = s_k + kBytes;
  const uint32_t s_ring = s_v + kBytes;                      // stage st: Q, then dO
  const uint32_t s_rows = s_ring + kBwdStages * 2 * kBytes;  // stage st: lse, then Delta
  const uint32_t s_p = s_rows + kBwdStages * 2 * kRowBytes;  // P^T: [i][thread] floats
  const uint32_t bar_kv = s_p + kBwdRows * kBwdTile * 4, bar_full = bar_kv + 8;
  const float* rows = reinterpret_cast<const float*>(smem_raw + (s_rows - raw));
  float* pt = reinterpret_cast<float*>(smem_raw + (s_p - raw));

  const int hk = kCausal ? blockIdx.x : blockIdx.y, b = kCausal ? blockIdx.y : blockIdx.z;
  const int k0 = (kCausal ? blockIdx.z : blockIdx.x) * kBwdRows;
  const int n_tiles = (sq + kBwdTile - 1) / kBwdTile;
  const int rep = hq / hkv;
  const int t_first = kCausal ? min(k0 / kBwdTile, n_tiles) : 0;
  const int per_head = n_tiles - t_first, n_items = rep * per_head;
  const int wg = threadIdx.x / kBwdThreads, tid = threadIdx.x % kBwdThreads;
  const int warp = tid / 32, lane = tid % 32;

  // thread 0 fills stage it % kBwdStages with item it, as in bwd_dkdv_tc_kernel
  auto load_tile = [&](int it) {
    const int st = it % kBwdStages, j = it / per_head;
    const int hh = hk * rep + j, q0 = (t_first + it - j * per_head) * kBwdTile;
    const long long row_off = ((long long)b * hq + hh) * stride;
    const uint32_t q_dst = s_ring + st * 2 * kBytes, r_dst = s_rows + st * 2 * kRowBytes;
    const uint32_t full = bar_full + 8 * st;
    mbar_expect_tx(full, 2 * kBytes + 2 * kRowBytes);
    for (int db = 0; db < boxes<D>(); ++db) {
      tma_load(q_dst + db * kBox, &tm_q, full, db * 64, hh, q0, b);
      tma_load(q_dst + kBytes + db * kBox, &tm_do, full, db * 64, hh, q0, b);
    }
    bulk_load(r_dst, lse + row_off + q0, kRowBytes, full);
    bulk_load(r_dst + kRowBytes, delta + row_off + q0, kRowBytes, full);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kBwdStages; ++st) mbar_init(bar_full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * kBytes);
    for (int db = 0; db < boxes<D>(); ++db) {
      tma_load(s_k + db * kBox, &tm_k, bar_kv, db * 64, hk, k0, b);
      tma_load(s_v + db * kBox, &tm_v, bar_kv, db * 64, hk, k0, b);
    }
    for (int it = 0; it < kBwdStages && it < n_items; ++it) load_tile(it);
  }
  __syncthreads();

  // this thread holds keys key0 and key0 + 8 of every accumulator
  const int key0 = k0 + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  // warpgroup 0: S^T (then P^T) and dV; warpgroup 1: dP^T (then dS^T) and dK
  const uint32_t a_rows = wg ? s_v : s_k;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_kv, 0);
  int t = t_first;  // item it's query tile
  for (int it = 0; it < n_items; ++it) {
    const int st = it % kBwdStages, q0 = t * kBwdTile;
    t = t + 1 == n_tiles ? t_first : t + 1;
    const uint32_t s_q = s_ring + st * 2 * kBytes, s_do = s_q + kBytes;
    const float* lse_t = rows + st * 2 * kBwdTile;
    const float* delta_t = lse_t + kBwdTile;
    mbar_wait(bar_full + 8 * st, (it / kBwdStages) & 1);

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1)
    const uint32_t b_rows = wg ? s_do : s_q;
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    fence_regs(x);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      Wgmma<64>::ss(x, sw128_desc(a_rows + off, 16, 1024), sw128_desc(b_rows + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);

    // x[4i + e] is (key0, query q0 + 8i + col + e), x[4i + 2 + e] (key0 + 8,
    // the same query)
    if (wg == 0) {
      // P^T in place, 0 for queries past sq and, on the diagonal tile, for
      // key > query; then into shared memory for warpgroup 1
      const bool mask = q0 + kBwdTile > sq;
      const bool diag = kCausal && q0 < k0 + kBwdRows;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * i + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float li = e ? l2.y : l2.x;
          const int qi = q0 + 8 * i + col + e;
          bool out0 = mask && qi >= sq, out1 = out0;
          if constexpr (kCausal) {
            out0 = out0 || (diag && key0 > qi);
            out1 = out1 || (diag && key0 + 8 > qi);
          }
          x[4 * i + e] = out0 ? 0.f : exp2f(x[4 * i + e] * scale_log2 - li);
          x[4 * i + 2 + e] = out1 ? 0.f : exp2f(x[4 * i + 2 + e] * scale_log2 - li);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) pt[i * kBwdThreads + tid] = x[i];
      p_ready_arrive();
    } else {
      // dS^T = P^T * (dP^T - Delta) in place (0 wherever P^T is)
      p_ready_wait();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + 8 * i + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float di = e ? d2.y : d2.x;
          x[4 * i + e] = pt[(4 * i + e) * kBwdThreads + tid] * (x[4 * i + e] - di);
          x[4 * i + 2 + e] = pt[(4 * i + 2 + e) * kBwdThreads + tid] * (x[4 * i + 2 + e] - di);
        }
      }
    }
    uint32_t xa[16];
    to_bf16_operand(x, xa);

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1): 4 steps of 16 queries,
    // dO and Q N-major, their D boxes kBox bytes apart
    const uint32_t n_rows = wg ? s_q : s_do;
    fence_regs(xa);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBwdTile / 16; ++j)
      Wgmma<D>::rs(acc, xa[4 * j], xa[4 * j + 1], xa[4 * j + 2], xa[4 * j + 3],
                   sw128_desc(n_rows + j * 16 * 128, kBox, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // every thread is done with the stage and with P^T: refill
    if (threadIdx.x == 0 && it + kBwdStages < n_items) load_tile(it + kBwdStages);
  }

  // acc[4i + e] is (key0, column 8i + col + e), acc[4i + 2 + e] key0 + 8;
  // dK scaled once (dV by 1, exactly)
  const float scale = wg ? sm_scale : 1.f;
  const long long row_stride = (long long)hkv * D;
  __nv_bfloat16* outb = (wg ? dk : dv) + (long long)b * skv * row_stride + (long long)hk * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (key0 < skv)
      *reinterpret_cast<__nv_bfloat162*>(outb + key0 * row_stride + 8 * i + col) =
          __floats2bfloat162_rn(acc[4 * i] * scale, acc[4 * i + 1] * scale);
    if (key0 + 8 < skv)
      *reinterpret_cast<__nv_bfloat162*>(outb + (key0 + 8) * row_stride + 8 * i + col) =
          __floats2bfloat162_rn(acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
  }
}

// dQ of kBwdRows query rows: a loop over every key tile of its kv head
template <int D, bool kCausal>
__global__ void __launch_bounds__(kBwdThreads, min_blocks<D>())
bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int sq, int skv, int hq, int hkv, int stride,
                 float sm_scale, float scale_log2) {
  constexpr uint32_t kBox = kBwdRows * 128, kBytes = boxes<D>() * kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_do = s_q + kBytes;
  const uint32_t s_ring = s_do + kBytes;                      // stage st: K, then V
  const uint32_t bar_q = s_ring + kBwdStages * 2 * kBytes, bar_full = bar_q + 8;

  const int hh = kCausal ? blockIdx.x : blockIdx.y, b = kCausal ? blockIdx.y : blockIdx.z;
  const int q0 = (kCausal ? gridDim.z - 1 - blockIdx.z : blockIdx.x) * kBwdRows;
  const int hk = hh / (hq / hkv);
  // causal: keys past the block's last row are masked for every row
  const int kv_end = kCausal ? min(skv, q0 + kBwdRows) : skv;
  const int n_tiles = (kv_end + kBwdTile - 1) / kBwdTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // thread 0 fills stage t % kBwdStages with key tile t
  auto load_tile = [&](int t) {
    const int st = t % kBwdStages;
    const uint32_t k_dst = s_ring + st * 2 * kBytes, full = bar_full + 8 * st;
    mbar_expect_tx(full, 2 * kBytes);
    for (int db = 0; db < boxes<D>(); ++db) {
      tma_load(k_dst + db * kBox, &tm_k, full, db * 64, hk, t * kBwdTile, b);
      tma_load(k_dst + kBytes + db * kBox, &tm_v, full, db * 64, hk, t * kBwdTile, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kBwdStages; ++st) mbar_init(bar_full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, 2 * kBytes);
    for (int db = 0; db < boxes<D>(); ++db) {
      tma_load(s_q + db * kBox, &tm_q, bar_q, db * 64, hh, q0, b);
      tma_load(s_do + db * kBox, &tm_do, bar_q, db * 64, hh, q0, b);
    }
    for (int t = 0; t < kBwdStages && t < n_tiles; ++t) load_tile(t);
  }
  __syncthreads();

  // this thread holds rows row0 and row0 + 8 of every accumulator
  const int row0 = q0 + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  const long long row_off = ((long long)b * hq + hh) * stride;
  const float lse0 = row0 < sq ? lse[row_off + row0] : 0.f;
  const float lse1 = row0 + 8 < sq ? lse[row_off + row0 + 8] : 0.f;
  const float dl0 = row0 < sq ? delta[row_off + row0] : 0.f;
  const float dl1 = row0 + 8 < sq ? delta[row_off + row0 + 8] : 0.f;
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kBwdStages, kt0 = t * kBwdTile;
    const uint32_t s_k = s_ring + st * 2 * kBytes, s_v = s_k + kBytes;
    mbar_wait(bar_full + 8 * st, (t / kBwdStages) & 1);

    // S = Q K^T and dP = dO V^T
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      Wgmma<64>::ss(s, sw128_desc(s_q + off, 16, 1024), sw128_desc(s_k + off, 16, 1024));
      Wgmma<64>::ss(dp, sw128_desc(s_do + off, 16, 1024), sw128_desc(s_v + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS in place of dP: s[4i + e] is (row0, key kt0 + 8i + col + e),
    // s[4i + 2 + e] (row0 + 8, the same key); 0 for keys past skv and, on
    // the diagonal tile, for key > row
    const bool mask = kt0 + kBwdTile > skv;
    const bool diag = kCausal && kt0 + kBwdTile - 1 > q0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt0 + 8 * i + col + e;
        bool out0 = mask && key >= skv, out1 = out0;
        if constexpr (kCausal) {
          out0 = out0 || (diag && key > row0);
          out1 = out1 || (diag && key > row0 + 8);
        }
        const float p0 = exp2f(s[4 * i + e] * scale_log2 - lse0);
        const float p1 = exp2f(s[4 * i + 2 + e] * scale_log2 - lse1);
        dp[4 * i + e] = out0 ? 0.f : p0 * (dp[4 * i + e] - dl0);
        dp[4 * i + 2 + e] = out1 ? 0.f : p1 * (dp[4 * i + 2 + e] - dl1);
      }
    uint32_t dsa[16];
    to_bf16_operand(dp, dsa);

    // dQ += dS K: 4 steps of 16 keys; K is (keys x D), N-major
    fence_regs(dsa);
    fence_regs(dqa);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBwdTile / 16; ++j)
      Wgmma<D>::rs(dqa, dsa[4 * j], dsa[4 * j + 1], dsa[4 * j + 2], dsa[4 * j + 3],
                   sw128_desc(s_k + j * 16 * 128, kBox, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dqa);
    __syncthreads();  // every thread is done with the stage: refill it
    if (threadIdx.x == 0 && t + kBwdStages < n_tiles) load_tile(t + kBwdStages);
  }

  const long long row_stride = (long long)hq * D;
  __nv_bfloat16* dqb = dq + (long long)b * sq * row_stride + (long long)hh * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (row0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row0 * row_stride + 8 * i + col) =
          __floats2bfloat162_rn(dqa[4 * i] * sm_scale, dqa[4 * i + 1] * sm_scale);
    if (row0 + 8 < sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (row0 + 8) * row_stride + 8 * i + col) =
          __floats2bfloat162_rn(dqa[4 * i + 2] * sm_scale, dqa[4 * i + 3] * sm_scale);
  }
}

// the entries' common checks (d192: the D 192 entries, which take D 192
// alone; the others D 64, 80 or 128): 0 to launch, else an error code
int check_args(int b, int sq, int skv, int hq, int hkv, int d, int stride, bool d192) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 ||
      (d192 ? d != 192 : (d != 64 && d != 80 && d != 128)) || b > 65535 || hq > 65535 ||
      (sq + kBwdRows - 1) / kBwdRows > 65535 || (skv + kBwdRows - 1) / kBwdRows > 65535 ||
      stride < sq || stride % kBwdTile != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the four TMA maps, of the true D: q and dO of hq heads with boxes of
// q_rows rows, k and v of hkv heads with boxes of kv_rows
template <int D>
bool encode_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                 const void* dout, int b, int sq, int skv, int hq, int hkv, int q_rows,
                 int kv_rows) {
  EncodeTiled fn = encode_tiled();
  return fn != nullptr && encode_bshd(fn, &m[0], q, b, sq, hq, D, q_rows) &&
         encode_bshd(fn, &m[1], k, b, skv, hkv, D, kv_rows) &&
         encode_bshd(fn, &m[2], v, b, skv, hkv, D, kv_rows) &&
         encode_bshd(fn, &m[3], dout, b, sq, hq, D, q_rows);
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, int b, int sq, int skv, int hq, int hkv,
                int causal, int stride, float sm_scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!encode_maps<D>(m, q, k, v, dout, b, sq, skv, hq, hkv, kBwdTile, kBwdRows))
    return (int)cudaErrorInvalidValue;
  auto kernel = causal ? bwd_dkdv_tc_kernel<D, true> : bwd_dkdv_tc_kernel<D, false>;
  constexpr int bytes = bwd_smem<D>();
  if (int err = set_smem(kernel, bytes)) return err;
  const int tiles = (skv + kBwdRows - 1) / kBwdRows;
  const dim3 grid = causal ? dim3(hkv, b, tiles) : dim3(tiles, hkv, b);
  kernel<<<grid, kBwdThreads, bytes, stream>>>(
      m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, sq, skv, hq, hkv, stride, sm_scale, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

// dkdv at D 192: two warpgroups a block, the grid as launch_dkdv's
template <int D>
int launch_dkdv_wg2(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int b, int sq, int skv,
                    int hq, int hkv, int causal, int stride, float sm_scale,
                    cudaStream_t stream) {
  CUtensorMap m[4];
  if (!encode_maps<D>(m, q, k, v, dout, b, sq, skv, hq, hkv, kBwdTile, kBwdRows))
    return (int)cudaErrorInvalidValue;
  auto kernel = causal ? bwd_dkdv_wg2_tc_kernel<D, true> : bwd_dkdv_wg2_tc_kernel<D, false>;
  constexpr int bytes = bwd_wg2_smem<D>();
  if (int err = set_smem(kernel, bytes)) return err;
  const int tiles = (skv + kBwdRows - 1) / kBwdRows;
  const dim3 grid = causal ? dim3(hkv, b, tiles) : dim3(tiles, hkv, b);
  kernel<<<grid, 2 * kBwdThreads, bytes, stream>>>(
      m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, sq, skv, hq, hkv, stride, sm_scale, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dqo, int b, int sq, int skv, int hq, int hkv, int causal,
              int stride, float sm_scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!encode_maps<D>(m, q, k, v, dout, b, sq, skv, hq, hkv, kBwdRows, kBwdTile))
    return (int)cudaErrorInvalidValue;
  auto kernel = causal ? bwd_dq_tc_kernel<D, true> : bwd_dq_tc_kernel<D, false>;
  constexpr int bytes = bwd_smem<D>();
  if (int err = set_smem(kernel, bytes)) return err;
  const int tiles = (sq + kBwdRows - 1) / kBwdRows;
  const dim3 grid = causal ? dim3(hq, b, tiles) : dim3(tiles, hq, b);
  kernel<<<grid, kBwdThreads, bytes, stream>>>(
      m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta, (__nv_bfloat16*)dqo, sq,
      skv, hq, hkv, stride, sm_scale, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

int launch_prep(const void* o, const void* dout, void* delta, int b, int sq, int h, int d,
                int stride, void* stream) {
  const long long n = (long long)b * h * stride;
  const long long blocks = (n + kDeltaThreads / 8 - 1) / (kDeltaThreads / 8);
  bwd_delta_kernel<<<(unsigned)blocks, kDeltaThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)delta, sq, h, d, stride, n);
  return (int)cudaGetLastError();
}

}  // namespace

// o, dout: (b, sq, h, d) contiguous bf16, 16-byte aligned (h the query
// heads); delta: float32 (b, h, stride), stride >= sq a multiple of 64,
// written for every row (0 past sq). d 64, 80 or 128 (the _d192_ entry: d
// 192). Returns cudaGetLastError() (or cudaErrorInvalidValue for arguments
// it refuses).
extern "C" int flash_attention_bwd_prep_bf16_sm90(const void* o, const void* dout, void* delta,
                                                  int b, int sq, int h, int d, int stride,
                                                  void* stream) {
  if (int err = check_args(b, sq, 1, h, h, d, stride, false)) return err;
  return launch_prep(o, dout, delta, b, sq, h, d, stride, stream);
}

extern "C" int flash_attention_bwd_prep_bf16_d192_sm90(const void* o, const void* dout,
                                                       void* delta, int b, int sq, int h, int d,
                                                       int stride, void* stream) {
  if (int err = check_args(b, sq, 1, h, h, d, stride, true)) return err;
  return launch_prep(o, dout, delta, b, sq, h, d, stride, stream);
}

// q, dout: (b, sq, hq, d); k, v: (b, skv, hkv, d), hq % hkv == 0,
// contiguous bf16, 16-byte aligned; lse: the forward's (with the same
// causal flag), delta: prep's, float32 (b, hq, stride); dk, dv like k, v;
// dq like q. d 64, 80 or 128 (the _d192_ entries: d 192, dkdv on two
// warpgroups a block), sm_scale = 1/sqrt(d), causal 0 or 1 (top-left:
// key > query index masked). Each returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it refuses or a tensor map that
// cuTensorMapEncodeTiled refuses).
extern "C" int flash_attention_bwd_dkdv_bf16_sm90(const void* q, const void* k, const void* v,
                                                  const void* dout, const void* lse,
                                                  const void* delta, void* dk, void* dv, int b,
                                                  int sq, int skv, int hq, int hkv, int d,
                                                  int causal, int stride, float sm_scale,
                                                  void* stream) {
  if (int err = check_args(b, sq, skv, hq, hkv, d, stride, false)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int c = causal != 0;
  if (d == 64)
    return launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, hq, hkv, c, stride,
                           sm_scale, s);
  if (d == 80)
    return launch_dkdv<80>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, hq, hkv, c, stride,
                           sm_scale, s);
  return launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, hq, hkv, c, stride,
                          sm_scale, s);
}

extern "C" int flash_attention_bwd_dq_bf16_sm90(const void* q, const void* k, const void* v,
                                                const void* dout, const void* lse,
                                                const void* delta, void* dqo, int b, int sq,
                                                int skv, int hq, int hkv, int d, int causal,
                                                int stride, float sm_scale, void* stream) {
  if (int err = check_args(b, sq, skv, hq, hkv, d, stride, false)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int c = causal != 0;
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dqo, b, sq, skv, hq, hkv, c, stride,
                         sm_scale, s);
  if (d == 80)
    return launch_dq<80>(q, k, v, dout, lse, delta, dqo, b, sq, skv, hq, hkv, c, stride,
                         sm_scale, s);
  return launch_dq<128>(q, k, v, dout, lse, delta, dqo, b, sq, skv, hq, hkv, c, stride,
                        sm_scale, s);
}

extern "C" int flash_attention_bwd_dkdv_bf16_d192_sm90(const void* q, const void* k,
                                                       const void* v, const void* dout,
                                                       const void* lse, const void* delta,
                                                       void* dk, void* dv, int b, int sq,
                                                       int skv, int hq, int hkv, int d,
                                                       int causal, int stride, float sm_scale,
                                                       void* stream) {
  if (int err = check_args(b, sq, skv, hq, hkv, d, stride, true)) return err;
  return launch_dkdv_wg2<192>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, hq, hkv,
                              causal != 0, stride, sm_scale, (cudaStream_t)stream);
}

extern "C" int flash_attention_bwd_dq_bf16_d192_sm90(const void* q, const void* k, const void* v,
                                                     const void* dout, const void* lse,
                                                     const void* delta, void* dqo, int b, int sq,
                                                     int skv, int hq, int hkv, int d, int causal,
                                                     int stride, float sm_scale, void* stream) {
  if (int err = check_args(b, sq, skv, hq, hkv, d, stride, true)) return err;
  return launch_dq<192>(q, k, v, dout, lse, delta, dqo, b, sq, skv, hq, hkv, causal != 0, stride,
                        sm_scale, (cudaStream_t)stream);
}
