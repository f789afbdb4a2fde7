// The gradient of GQA attention, with an optional causal mask, for Hopper
// (sm_90a), on the CUDA cores: FlashAttention-2's backward in three entries, float32
// and bf16 (flash_attention_bwd_{prep,dkdv,dq}_{f32,bf16}).
//
// Replaces no TPU kernel: the reference has no backward kernel (XLA
// differentiates repro/kernels/ref.py:attention on the CPU). It is the
// gradient of flash_attention (csrc/flash_attention.cu), the port's
// counterpart of repro/kernels/flash_attention.py, for the training
// steps: without it a step on the card would differentiate the plain
// version and keep its float32 weights, (B, H, Sq, Skv) a layer.
//
// For q, o, dO (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D) contiguous, Hq %
// Hkv == 0 (query head hh reads kv head hh / (Hq / Hkv)), D <= 128, with
// s = (q * sm_scale) . k, P = exp(s - lse) and Delta = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),
//   dK = dS^T (q * sm_scale),  dQ = sm_scale * dS K.
// With the causal mask (top-left, as the forward's: key > query index is
// masked) P = 0 at the masked entries, and lse is taken over the unmasked
// keys. Every sum is float32 (the inputs upcast on load); dq, dk, dv are
// rounded once to the inputs' type. Each output element is written by one
// thread after a loop in a fixed order, with no atomics, so two calls give
// the same bits. The wrapper (kernels/flash_attention.py) raises for D >
// 128 (D 192, MLA's heads, is the MoE/MLA training slice's).
//
// Entries (one launch each, in this order):
// - prep: a block of kThreads owns kBQ query rows of one (batch, query
//   head). It recomputes each row's log-sum-exp from q and k (the online
//   max and sum of the forward's CUDA-core kernel, masked as it is) and
//   Delta from dO and O, into two float32 (B, Hq, Sq) buffers. Recomputing
//   lse leaves the forward kernels as they are: they save nothing for the
//   backward.
// - dkdv: a block owns kBK keys of one (batch, kv head) and walks every
//   query tile of each of the kv head's Hq / Hkv query heads, head by head:
//   s^T and dP^T as 64 x 64 tiles (a thread 4 keys x 4 queries), P and dS
//   through shared memory, then dV += P^T dO and dK += dS^T q; every query
//   head's share is summed before one store.
// - dq: a block owns kBQ query rows of one query head and walks every key
//   tile of its kv head: s, dP, dS, then dQ += dS K, scaled once at the end.
// Causal: dkdv starts each head's walk at the query tile that holds the
// block's first key, dq and prep stop at the key tile that holds the
// block's last row, and dq and prep run the last query rows (the longest)
// first, as the forward does.
// The head dim is zero-padded to DP (64 or 128) in shared memory, so D 80
// (ViT-H/14) is read as its 80 columns, and the dot products run over D
// rounded up to 4. Keys past Skv get P = 0, query rows past Sq get P = 0
// in dkdv and are not stored by dq or prep.
//
// Bound: operations. The three entries run 8 products of 2*B*H*Sq*Skv*D
// flops (prep: s; dkdv: s, dP, dV, dK; dq: s, dP, dQ) where the gradient
// needs 5, on ~9*B*H*S*D elements moved, far above the card's
// operations-per-byte line; float32 FMAs on the CUDA cores at 67 TFLOP/s
// (TF32 would break the float32 contract). bf16 with D 64, 80 or 128 takes
// the tensor-core route instead (csrc/flash_attention_bwd_sm90.cu: 7
// products on wgmma, the log-sum-exp read from the forward); this file
// keeps float32 and the other bf16 head dims.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows a tile
constexpr int kBK = 64;        // keys a tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows of a tile, tx 4 columns
constexpr int kPS = kBK + 4;   // row stride of the P and dS tiles (floats)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 lanes that share a row of a score tile (half a warp)
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

// rows [row0, row0 + 64) of one head of a (B, S, H, D) tensor (src points
// at its (b, 0, h, 0)) into shared memory as float32 times scale, with a
// row stride of DP + 4 floats (conflict-free float4 reads of 8 rows at
// once); rows past n and columns past d are 0
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int row0, int n, int d,
                                          float scale) {
  constexpr int LS = DP + 4;
  for (int i = threadIdx.x; i < 64 * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (row0 + r < n && c < d) x = to_f32(src[(long long)(row0 + r) * row_stride + c]) * scale;
    dst[r * LS + c] = x;
  }
}

// s[i][j] = sum_c a[ty*4 + i][c] * b[tx + 16*j][c] over c < dc (a multiple
// of 4; the columns past d are 0), fmaf in column order
template <int DP>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a, const float* b,
                                         int dc, int ty, int tx) {
  constexpr int LS = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < dc; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(&a[(ty * 4 + i) * LS + c]);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * LS + c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][cc*4 + e] += sum_j p[ty*4 + i][j] * m[j][cc*64 + tx*4 + e] over
// the 64 rows of the tile m (row stride DP + 4), p with row stride kPS
template <int DP>
__device__ __forceinline__ void tile_acc(float (&acc)[4][DP / 16], const float* p,
                                         const float* m, int ty, int tx) {
  constexpr int LS = DP + 4, NC = DP / 64;
#pragma unroll 2
  for (int j = 0; j < 64; j += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(&p[(ty * 4 + i) * kPS + j]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float4 mv = *reinterpret_cast<const float4*>(&m[(j + jj) * LS + cc * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pp = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
          acc[i][cc * 4 + 0] = fmaf(pp, mv.x, acc[i][cc * 4 + 0]);
          acc[i][cc * 4 + 1] = fmaf(pp, mv.y, acc[i][cc * 4 + 1]);
          acc[i][cc * 4 + 2] = fmaf(pp, mv.z, acc[i][cc * 4 + 2]);
          acc[i][cc * 4 + 3] = fmaf(pp, mv.w, acc[i][cc * 4 + 3]);
        }
      }
    }
  }
}

// rows row0 + ty*4 + i (< n), columns cc*64 + tx*4 + e (< d) of acc times
// scale into one head of a (B, S, H, D) tensor
template <typename T, int DP>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const float (&acc)[4][DP / 16],
                                           long long row_stride, int row0, int n, int d,
                                           float scale, int ty, int tx) {
  constexpr int NC = DP / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= n) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = cc * 64 + tx * 4 + e;
        if (c < d) dst[(long long)r * row_stride + c] = from_f32<T>(acc[i][cc * 4 + e] * scale);
      }
  }
}

template <int DP>
constexpr int prep_smem() { return 2 * 64 * (DP + 4) * 4; }
template <int DP>
constexpr int dkdv_smem() { return (4 * 64 * (DP + 4) + 2 * kBK * kPS + 2 * kBQ) * 4; }
template <int DP>
constexpr int dq_smem() { return (4 * 64 * (DP + 4) + kBQ * kPS + 2 * kBQ) * 4; }

// lse (B, H, Sq) = m + log(l) of s over every key, delta (B, H, Sq) =
// rowsum(dO * O)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                const T* __restrict__ dout, float* __restrict__ lse,
                float* __restrict__ delta, int sq, int skv, int hq, int hkv, int d, int causal,
                float sm_scale) {
  constexpr int LS = DP + 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * LS;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal rows first
  const int hh = blockIdx.y, b = blockIdx.z, hk = hh / (hq / hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int dc = (d + 3) & ~3;
  const long long row = (long long)hq * d, kv_row = (long long)hkv * d;
  const long long qoff = (long long)b * sq * row + (long long)hh * d;
  const long long koff = (long long)b * skv * kv_row + (long long)hk * d;
  const long long soff = ((long long)b * hq + hh) * sq;
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;

  // Delta first: 4 threads a row, each a strided quarter of its columns
  {
    const int r = tid >> 2, part = tid & 3;
    float acc = 0.f;
    if (q0 + r < sq)
      for (int c = part; c < d; c += 4) {
        const long long off = qoff + (long long)(q0 + r) * row + c;
        acc = fmaf(to_f32(dout[off]), to_f32(o[off]), acc);
      }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && q0 + r < sq) delta[soff + q0 + r] = acc;
  }

  load_tile<T, DP>(sQ, q + qoff, row, q0, sq, d, sm_scale);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous K tile is consumed
    load_tile<T, DP>(sK, k + koff, kv_row, k0, skv, d, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot<DP>(s, sQ, sK, dc, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool in[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        in[j] = kpos < skv && !(causal && kpos > qpos);
      }
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (in[j]) mx = fmaxf(mx, s[i][j]);
      mx = row_max(mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (in[j]) rs += expf(s[i][j] - mx);
      l[i] = l[i] * expf(m[i] - mx) + row_sum(rs);
      m[i] = mx;
    }
  }
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      if (r < sq) lse[soff + r] = m[i] + logf(l[i]);
    }
}

// dK and dV of kBK keys: a loop over every query tile
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                int sq, int skv, int hq, int hkv, int d, int causal, float sm_scale) {
  constexpr int LS = DP + 4, NA = DP / 16;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kBK * LS;
  float* sQ = sV + kBK * LS;   // q * sm_scale
  float* sO = sQ + kBQ * LS;   // dO
  float* sP = sO + kBQ * LS;   // P^T: key-major, kBK x kPS
  float* sS = sP + kBK * kPS;  // dS^T
  float* sL = sS + kBK * kPS;  // lse of the query tile
  float* sD = sL + kBQ;        // Delta of the query tile
  const int k0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int dc = (d + 3) & ~3;
  const int rep = hq / hkv;
  const long long row = (long long)hq * d, kv_row = (long long)hkv * d;
  const long long koff = (long long)b * skv * kv_row + (long long)hk * d;
  // causal: the first query tile that reaches key k0
  const int q_first = causal ? k0 / kBQ * kBQ : 0;

  load_tile<T, DP>(sK, k + koff, kv_row, k0, skv, d, 1.f);
  load_tile<T, DP>(sV, v + koff, kv_row, k0, skv, d, 1.f);
  float dka[4][NA], dva[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c) dka[i][c] = dva[i][c] = 0.f;

  // every query tile of each of the kv head's query heads, head by head
  for (int j = 0; j < rep; ++j) {
    const int hh = hk * rep + j;
    const long long qoff = (long long)b * sq * row + (long long)hh * d;
    const long long soff = ((long long)b * hq + hh) * sq;
    for (int q0 = q_first; q0 < sq; q0 += kBQ) {
      __syncthreads();  // the previous query tile, P and dS are consumed
      load_tile<T, DP>(sQ, q + qoff, row, q0, sq, d, sm_scale);
      load_tile<T, DP>(sO, dout + qoff, row, q0, sq, d, 1.f);
      if (tid < kBQ) {
        const bool in = q0 + tid < sq;
        sL[tid] = in ? lse[soff + q0 + tid] : 0.f;
        sD[tid] = in ? delta[soff + q0 + tid] : 0.f;
      }
      __syncthreads();
      // s^T and dP^T: keys ty*4 + i, queries tx + 16*jj
      float s[4][4], dp[4][4];
      tile_dot<DP>(s, sK, sQ, dc, ty, tx);
      tile_dot<DP>(dp, sV, sO, dc, ty, tx);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qi = tx + 16 * jj;
        const bool in = q0 + qi < sq;
        const float lq = sL[qi], dl = sD[qi];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool on = in && !(causal && k0 + ty * 4 + i > q0 + qi);
          const float p = on ? expf(s[i][jj] - lq) : 0.f;
          sP[(ty * 4 + i) * kPS + qi] = p;
          sS[(ty * 4 + i) * kPS + qi] = p * (dp[i][jj] - dl);
        }
      }
      __syncthreads();
      tile_acc<DP>(dva, sP, sO, ty, tx);  // dV += P^T dO
      tile_acc<DP>(dka, sS, sQ, ty, tx);  // dK += dS^T (q * sm_scale)
    }
  }
  store_tile<T, DP>(dk + koff, dka, kv_row, k0, skv, d, 1.f, ty, tx);
  store_tile<T, DP>(dv + koff, dva, kv_row, k0, skv, d, 1.f, ty, tx);
}

// dQ of kBQ query rows: a loop over every key tile
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int sq, int skv, int hq,
              int hkv, int d, int causal, float sm_scale) {
  constexpr int LS = DP + 4, NA = DP / 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // q * sm_scale
  float* sO = sQ + kBQ * LS;                    // dO
  float* sK = sO + kBQ * LS;
  float* sV = sK + kBK * LS;
  float* sS = sV + kBK * LS;                    // dS: query-major, kBQ x kPS
  float* sL = sS + kBQ * kPS;
  float* sD = sL + kBQ;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal rows first
  const int hh = blockIdx.y, b = blockIdx.z, hk = hh / (hq / hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int dc = (d + 3) & ~3;
  const long long row = (long long)hq * d, kv_row = (long long)hkv * d;
  const long long qoff = (long long)b * sq * row + (long long)hh * d;
  const long long koff = (long long)b * skv * kv_row + (long long)hk * d;
  const long long soff = ((long long)b * hq + hh) * sq;
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;

  load_tile<T, DP>(sQ, q + qoff, row, q0, sq, d, sm_scale);
  load_tile<T, DP>(sO, dout + qoff, row, q0, sq, d, 1.f);
  if (tid < kBQ) {
    const bool in = q0 + tid < sq;
    sL[tid] = in ? lse[soff + q0 + tid] : 0.f;
    sD[tid] = in ? delta[soff + q0 + tid] : 0.f;
  }
  float dqa[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c) dqa[i][c] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous K, V and dS are consumed
    load_tile<T, DP>(sK, k + koff, kv_row, k0, skv, d, 1.f);
    load_tile<T, DP>(sV, v + koff, kv_row, k0, skv, d, 1.f);
    __syncthreads();
    // s and dP: queries ty*4 + i, keys tx + 16*j
    float s[4][4], dp[4][4];
    tile_dot<DP>(s, sQ, sK, dc, ty, tx);
    tile_dot<DP>(dp, sO, sV, dc, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lq = sL[ty * 4 + i], dl = sD[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool on = kpos < skv && !(causal && kpos > q0 + ty * 4 + i);
        const float p = on ? expf(s[i][j] - lq) : 0.f;
        sS[(ty * 4 + i) * kPS + tx + 16 * j] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    tile_acc<DP>(dqa, sS, sK, ty, tx);  // dQ += dS K
  }
  store_tile<T, DP>(dq + qoff, dqa, row, q0, sq, d, sm_scale, ty, tx);
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the entries' common checks: 0 to launch, else an error code
int check_args(int b, int sq, int skv, int hq, int hkv, int d) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || d <= 0 ||
      d > 128 || b > 65535 || hq > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T, int DP>
int launch_prep(const void* q, const void* k, const void* o, const void* dout, void* lse,
                void* delta, int b, int sq, int skv, int hq, int hkv, int d, int causal,
                float sm_scale, cudaStream_t stream) {
  auto kernel = bwd_prep_kernel<T, DP>;
  constexpr int bytes = prep_smem<DP>();
  if (int err = set_smem(kernel, bytes)) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, bytes, stream>>>((const T*)q, (const T*)k, (const T*)o,
                                            (const T*)dout, (float*)lse, (float*)delta, sq, skv,
                                            hq, hkv, d, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, int b, int sq, int skv, int hq, int hkv,
                int d, int causal, float sm_scale, cudaStream_t stream) {
  auto kernel = bwd_dkdv_kernel<T, DP>;
  constexpr int bytes = dkdv_smem<DP>();
  if (int err = set_smem(kernel, bytes)) return err;
  const dim3 grid((skv + kBK - 1) / kBK, hkv, b);
  kernel<<<grid, kThreads, bytes, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                            (const T*)dout, (const float*)lse,
                                            (const float*)delta, (T*)dk, (T*)dv, sq, skv, hq,
                                            hkv, d, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int b, int sq, int skv, int hq, int hkv, int d,
              int causal, float sm_scale, cudaStream_t stream) {
  auto kernel = bwd_dq_kernel<T, DP>;
  constexpr int bytes = dq_smem<DP>();
  if (int err = set_smem(kernel, bytes)) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, bytes, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                            (const T*)dout, (const float*)lse,
                                            (const float*)delta, (T*)dq, sq, skv, hq, hkv, d,
                                            causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int run_prep(const void* q, const void* k, const void* o, const void* dout, void* lse, void* delta,
             int b, int sq, int skv, int hq, int hkv, int d, int causal, float sm_scale,
             void* stream) {
  if (int err = check_args(b, sq, skv, hq, hkv, d)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int c = causal != 0;
  if (d <= 64)
    return launch_prep<T, 64>(q, k, o, dout, lse, delta, b, sq, skv, hq, hkv, d, c, sm_scale, s);
  return launch_prep<T, 128>(q, k, o, dout, lse, delta, b, sq, skv, hq, hkv, d, c, sm_scale, s);
}

template <typename T>
int run_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dk, void* dv, int b, int sq, int skv, int hq, int hkv,
             int d, int causal, float sm_scale, void* stream) {
  if (int err = check_args(b, sq, skv, hq, hkv, d)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int c = causal != 0;
  if (d <= 64)
    return launch_dkdv<T, 64>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, hq, hkv, d, c,
                              sm_scale, s);
  return launch_dkdv<T, 128>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, hq, hkv, d, c,
                             sm_scale, s);
}

template <typename T>
int run_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dqo, int b, int sq, int skv, int hq, int hkv, int d,
           int causal, float sm_scale, void* stream) {
  if (int err = check_args(b, sq, skv, hq, hkv, d)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int c = causal != 0;
  if (d <= 64)
    return launch_dq<T, 64>(q, k, v, dout, lse, delta, dqo, b, sq, skv, hq, hkv, d, c, sm_scale,
                            s);
  return launch_dq<T, 128>(q, k, v, dout, lse, delta, dqo, b, sq, skv, hq, hkv, d, c, sm_scale,
                           s);
}

}  // namespace

// q, o, dout: (b, sq, hq, d); k, v: (b, skv, hkv, d), hq % hkv == 0,
// contiguous, of one type; lse, delta: (b, hq, sq) float32 written by prep,
// read by dkdv and dq; dq, dk, dv: like q, k, v. d <= 128, sm_scale =
// 1/sqrt(d), causal 0 or 1 (top-left: key > query index masked). Each
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments it
// refuses).
extern "C" int flash_attention_bwd_prep_f32(const void* q, const void* k, const void* o,
                                            const void* dout, void* lse, void* delta, int b,
                                            int sq, int skv, int hq, int hkv, int d, int causal,
                                            float sm_scale, void* stream) {
  return run_prep<float>(q, k, o, dout, lse, delta, b, sq, skv, hq, hkv, d, causal, sm_scale,
                         stream);
}

extern "C" int flash_attention_bwd_prep_bf16(const void* q, const void* k, const void* o,
                                             const void* dout, void* lse, void* delta, int b,
                                             int sq, int skv, int hq, int hkv, int d, int causal,
                                             float sm_scale, void* stream) {
  return run_prep<__nv_bfloat16>(q, k, o, dout, lse, delta, b, sq, skv, hq, hkv, d, causal,
                                 sm_scale, stream);
}

extern "C" int flash_attention_bwd_dkdv_f32(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dk, void* dv, int b, int sq, int skv, int hq,
                                            int hkv, int d, int causal, float sm_scale,
                                            void* stream) {
  return run_dkdv<float>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, hq, hkv, d, causal,
                         sm_scale, stream);
}

extern "C" int flash_attention_bwd_dkdv_bf16(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dk, void* dv, int b,
                                             int sq, int skv, int hq, int hkv, int d, int causal,
                                             float sm_scale, void* stream) {
  return run_dkdv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, b, sq, skv, hq, hkv, d,
                                 causal, sm_scale, stream);
}

extern "C" int flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dqo, int b, int sq, int skv, int hq, int hkv,
                                          int d, int causal, float sm_scale, void* stream) {
  return run_dq<float>(q, k, v, dout, lse, delta, dqo, b, sq, skv, hq, hkv, d, causal, sm_scale,
                       stream);
}

extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dqo, int b, int sq, int skv, int hq, int hkv,
                                           int d, int causal, float sm_scale, void* stream) {
  return run_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dqo, b, sq, skv, hq, hkv, d, causal,
                               sm_scale, stream);
}
