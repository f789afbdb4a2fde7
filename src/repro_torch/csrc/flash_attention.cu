// Flash attention (online softmax, GQA, optional causal mask) for Hopper
// (sm_90a), on the CUDA cores.
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
// math); tensor cores (wgmma) are later work: TF32 would break the
// float32 contract.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
